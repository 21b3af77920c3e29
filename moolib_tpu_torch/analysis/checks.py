"""mtlint checks for the port: the JAX package's contracts as AST rules
over ``moolib_tpu_torch/``, rewritten for torch idioms.

The registry holds five checks: ``host-sync``, ``raw-rng``, ``bare-timer``,
``blocking-under-lock`` and ``metric-docs``.  The JAX package's other two
are JAX idioms with no torch meaning and are not ported:
``donation-safety`` guards ``jax.jit(donate_argnums=...)`` buffers, and the
port writes its buffers in place instead of donating them;
``recompile-risk`` guards jit retraces on Python-varying arguments, and the
port's eager torch compiles nothing per call (its CUDA kernels are built
once per source, keyed by content).

The scopes are the modules where each contract holds, so a check never
nags code the contract was never meant to govern.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator, List, Optional, Sequence

from .core import Check, Context, Finding, ModuleSource, register

PKG = "moolib_tpu_torch/"

#: the hot-path modules: the one-crossing and zero-crossing actor planes,
#: the decode loop, the kernels' wrappers, and the device-resident replay
#: plane (``replay/host.py`` stays out on purpose: it is the host numpy
#: reference store).
HOT_PATHS = tuple(PKG + p for p in (
    "rollout.py",
    "engine/",
    "ops/",
    "envs/jax_envs.py",
    "replay/device.py",
    "replay/distributed.py",
    "replay/ingest.py",
))

#: the threaded planes where lock ordering is load-bearing.
LOCKED_PATHS = tuple(PKG + p for p in (
    "group.py",
    "serving.py",
    "accumulator.py",
    "rpc/core.py",
    "engine/",
    "rollout.py",
    "checkpoint.py",
))

#: env/rollout code bound by the counter-based seeding contract.
RNG_PATHS = (PKG + "envs/", PKG + "rollout.py")

#: the metric tables: the JAX package's contract (read-only for the port)
#: and the port's own table of the metrics only the port registers.
METRIC_DOCS = ("docs/TELEMETRY.md", PKG + "TELEMETRY.md")


def _in(path: str, prefixes: Sequence[str]) -> bool:
    return any(path.startswith(p) for p in prefixes)


def _call_name(mod: ModuleSource, call: ast.Call) -> str:
    return mod.qualname(call.func)


def _kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    return next((kw.value for kw in call.keywords if kw.arg == name), None)


# ---------------------------------------------------------------------------
# host-sync: no host round trip per frame or per decode step
# ---------------------------------------------------------------------------


@register
class HostSyncCheck(Check):
    name = "host-sync"
    description = (
        ".item() / .cpu() / .tolist() / .numpy() / a stream or event "
        "synchronize / np.asarray / scalar coercion of a call result / "
        "torch.tensor(..., device=...) inside the hot-path modules — each is "
        "a host round trip or an H2D copy the zero-crossing actor plane and "
        "the decode loop must not take per frame"
    )
    scope = staticmethod(lambda path: _in(path, HOT_PATHS))

    _FUNCS = {
        "torch.cuda.synchronize": "torch.cuda.synchronize waits for the whole device",
        "numpy.asarray": "np.asarray of a tensor is a blocking D2H copy",
        "numpy.array": "np.array of a tensor is a blocking D2H copy",
    }
    _METHODS = {
        "item": ".item() synchronously fetches a device scalar",
        "cpu": ".cpu() is a blocking D2H copy",
        "tolist": ".tolist() is a blocking D2H copy",
        "numpy": ".numpy() hands a host view (a sync after any D2H feeding it)",
        "synchronize": ".synchronize() blocks the host on an event or stream",
    }
    #: inner calls whose scalar coercion is host arithmetic, not a device
    #: sync: builtins over python ints and environment/config parsing.
    _HOST_SCALAR_CALLS = {
        "min", "max", "len", "round", "abs", "divmod",
        "os.environ.get", "os.getenv",
    }

    def run(self, mod: ModuleSource, ctx: Context) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            qual = _call_name(mod, node)
            if qual in self._FUNCS:
                yield self.finding(mod, node, self._FUNCS[qual])
                continue
            if qual == "torch.tensor":
                dev = _kwarg(node, "device")
                if dev is not None and not (isinstance(dev, ast.Constant) and dev.value == "cpu"):
                    yield self.finding(
                        mod, node,
                        "torch.tensor(..., device=...) builds the value on the "
                        "host and copies it to the device on every call",
                    )
                continue
            if isinstance(node.func, ast.Attribute) and node.func.attr in self._METHODS:
                yield self.finding(mod, node, self._METHODS[node.func.attr])
                continue
            # float(f(x)) / int(x.sum()): coercing the *result of a call* to
            # a python scalar synchronizes on the whole computation.
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Call)
                and _call_name(mod, node.args[0]) not in self._HOST_SCALAR_CALLS
                and not _call_name(mod, node.args[0]).startswith("math.")
            ):
                yield self.finding(
                    mod,
                    node,
                    f"{node.func.id}() of a call result synchronously coerces "
                    "a device scalar to host",
                )


# ---------------------------------------------------------------------------
# raw-rng: the counter-based seeding contract
# ---------------------------------------------------------------------------

_TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
}
_TENSOR_DRAWS = {
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
    "geometric_", "cauchy_", "log_normal_",
}


@register
class RawRngCheck(Check):
    name = "raw-rng"
    description = (
        "a torch draw without generator=, the global torch seed, global "
        "np.random state or an unseeded np.random.default_rng() in env or "
        "rollout code — draws must come from a seeded Generator handed in, "
        "or from keys derived by fold_in, so replays stay bit-identical"
    )
    scope = staticmethod(lambda path: _in(path, RNG_PATHS))

    def run(self, mod: ModuleSource, ctx: Context) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            qual = _call_name(mod, node)
            method = node.func.attr if isinstance(node.func, ast.Attribute) else ""
            if qual in _TORCH_DRAWS or (method in _TENSOR_DRAWS and not qual.startswith("torch.")):
                if _kwarg(node, "generator") is None:
                    yield self.finding(
                        mod, node,
                        f"{qual or method}() without generator= draws from "
                        "torch's global stream — pass the seeded Generator",
                    )
            elif qual in ("torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                          "torch.cuda.manual_seed_all", "torch.cuda.seed"):
                yield self.finding(
                    mod, node,
                    f"{qual}() reseeds torch's global stream in env/rollout "
                    "code — seed a Generator of your own instead",
                )
            elif qual == "numpy.random.default_rng":
                if not node.args and not node.keywords:
                    yield self.finding(
                        mod,
                        node,
                        "unseeded np.random.default_rng() — host envs must "
                        "derive their stream from the seed handed in",
                    )
            elif qual.startswith("numpy.random."):
                yield self.finding(
                    mod,
                    node,
                    f"global-state {qual.replace('numpy', 'np')} — draw from "
                    "a per-env seeded Generator instead",
                )


# ---------------------------------------------------------------------------
# bare-timer: every timing block must reach the exporters
# ---------------------------------------------------------------------------


@register
class BareTimerCheck(Check):
    name = "bare-timer"
    description = (
        "hand-rolled time.perf_counter{,_ns} timing outside telemetry/ and "
        "utils/profiling.py — invisible to every exporter; use telemetry "
        "spans / Histogram.time() / StepTimer (aliases such as `from time "
        "import perf_counter as x` resolve too)"
    )
    scope = staticmethod(
        lambda path: path.startswith(PKG)
        and not path.startswith(PKG + "telemetry/")
        and path != PKG + "utils/profiling.py"
    )

    def run(self, mod: ModuleSource, ctx: Context) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            qual = _call_name(mod, node)
            if qual in ("time.perf_counter", "time.perf_counter_ns"):
                yield self.finding(
                    mod,
                    node,
                    f"bare {qual}() — time through telemetry spans / "
                    "Histogram.time() / StepTimer so the block is visible "
                    "to the exporters",
                )


# ---------------------------------------------------------------------------
# blocking-under-lock: the threaded RPC/group/serving planes
# ---------------------------------------------------------------------------

_LOCKISH = re.compile(r"(^|[._])(lock|cond|mutex|mu)\b", re.IGNORECASE)


@register
class BlockingUnderLockCheck(Check):
    name = "blocking-under-lock"
    description = (
        "an RPC send, future .result()/.wait(), sleep, or device sync while "
        "holding a Lock/Condition — the handler or transport thread that "
        "would unblock it may need the same lock (the ABBA half of what "
        "testing.lockgraph catches at runtime)"
    )
    scope = staticmethod(lambda path: _in(path, LOCKED_PATHS))

    _BLOCKING_FUNCS = {
        "time.sleep": "time.sleep holds the lock for the whole nap",
        "torch.cuda.synchronize": "torch.cuda.synchronize waits for the whole device",
    }
    _BLOCKING_METHODS = {
        "result": "Future.result() can wait a full timeout",
        "wait": "waiting on a different primitive while holding this lock",
        "wait_for": "waiting on a different primitive while holding this lock",
        "call": "a synchronous RPC call round-trips the network",
        "sync_call": "a synchronous RPC call round-trips the network",
        "send_frame": "a transport send can block on a full socket",
        "synchronize": "an event or stream synchronize stalls on the device",
        "item": ".item() stalls on the device",
    }

    def run(self, mod: ModuleSource, ctx: Context) -> Iterator[Finding]:
        yield from self._walk_stmts(mod, mod.tree.body, [])

    def _walk_stmts(
        self, mod: ModuleSource, stmts: Sequence[ast.stmt], held: List[str]
    ) -> Iterator[Finding]:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def executes later, outside this lock scope
                yield from self._walk_stmts(mod, st.body, [])
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                acquired = [
                    ast.unparse(item.context_expr)
                    for item in st.items
                    if _LOCKISH.search(ast.unparse(item.context_expr))
                ]
                if held:
                    for item in st.items:
                        yield from self._scan_expr(mod, item.context_expr, held)
                yield from self._walk_stmts(mod, st.body, held + acquired)
                continue
            # any other statement: scan its own expressions (excluding
            # nested statement bodies, which recurse below — each call is
            # visited exactly once)
            if held:
                yield from self._scan_stmt(mod, st, held)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(st, attr, None)
                if sub:
                    yield from self._walk_stmts(mod, sub, held)
            for handler in getattr(st, "handlers", ()):
                yield from self._walk_stmts(mod, handler.body, held)

    def _scan_stmt(
        self, mod: ModuleSource, st: ast.stmt, held: List[str]
    ) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(st):
            if not isinstance(child, (ast.stmt, ast.excepthandler)):
                yield from self._scan_expr(mod, child, held)

    def _scan_expr(
        self, mod: ModuleSource, top: ast.AST, held: List[str]
    ) -> Iterator[Finding]:
        stack: List[ast.AST] = [top]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.stmt, ast.Lambda)):
                continue  # lambda bodies execute later; stmts recurse above
            if isinstance(node, ast.Call):
                f = self._classify(mod, node, held)
                if f is not None:
                    yield f
            stack.extend(ast.iter_child_nodes(node))

    def _classify(
        self, mod: ModuleSource, node: ast.Call, held: List[str]
    ) -> Optional[Finding]:
        qual = _call_name(mod, node)
        lockset = ", ".join(held)
        if qual in self._BLOCKING_FUNCS:
            return self.finding(
                mod,
                node,
                f"{self._BLOCKING_FUNCS[qual]} (holding {lockset})",
            )
        if not isinstance(node.func, ast.Attribute):
            return None
        meth = node.func.attr
        if meth not in self._BLOCKING_METHODS:
            return None
        recv = ast.unparse(node.func.value)
        if meth in ("wait", "wait_for") and recv in held:
            return None  # Condition.wait on the held condition RELEASES it
        if meth == "call" and recv in ("super()",):
            return None
        if (
            meth == "result"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == 0
        ):
            return None  # .result(0) cannot block: raises if not yet done
        return self.finding(
            mod,
            node,
            f".{meth}() — {self._BLOCKING_METHODS[meth]} (holding {lockset})",
        )


# ---------------------------------------------------------------------------
# metric-docs: the TELEMETRY.md tables are the metric contract
# ---------------------------------------------------------------------------


@register
class MetricDocsCheck(Check):
    name = "metric-docs"
    description = (
        "every registry.counter/gauge/histogram name registered in code "
        "must appear (backticked) in a table row of docs/TELEMETRY.md (the "
        "JAX package's contract) or moolib_tpu_torch/TELEMETRY.md (the "
        "metrics only the port registers)"
    )

    def _doc_tables(self, ctx: Context) -> Optional[str]:
        cached = getattr(ctx, "_metric_doc_tables", None)
        if cached is not None:
            return cached or None
        rows = []
        for rel in METRIC_DOCS:
            try:
                with open(os.path.join(ctx.root, rel), "r", encoding="utf-8") as f:
                    text = f.read()
            except OSError:
                continue
            rows += [line for line in text.splitlines() if line.lstrip().startswith("|")]
        tables = "\n".join(rows)
        ctx._metric_doc_tables = tables  # "" (no docs): the check is dormant
        return tables or None

    def run(self, mod: ModuleSource, ctx: Context) -> Iterator[Finding]:
        tables = self._doc_tables(ctx)
        if tables is None:
            return
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("counter", "gauge", "histogram")
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue
            name = node.args[0].value
            if f"`{name}`" not in tables:
                yield self.finding(
                    mod,
                    node,
                    f"metric `{name}` ({node.func.attr}) is not documented "
                    "in a docs/TELEMETRY.md or moolib_tpu_torch/TELEMETRY.md "
                    "table row",
                )
