"""The port's contract lint (``python -m moolib_tpu_torch.analysis``): every
check fires on a minimal fixture of each torch pattern it owns, pragmas and
the baseline behave as in the JAX package's lint, and the port's tree is
clean.  This module mirrors ``tests/test_analysis.py``; its last tests are
the port's CI gate (the JAX package's ``scripts/ci.sh`` lints only
``moolib_tpu/``).

The fixtures go through :func:`moolib_tpu_torch.analysis.lint_source`, which
lints a source string as if it lived at the given repo-relative path, so
scoped checks (host-sync only in hot-path modules, raw-rng only in env and
rollout code, ...) are pointed at their territory without a tree on disk.
CLI-level behaviour (baseline gating, exit codes) uses a tmpdir tree via
``--root``.
"""

import json
import subprocess
import sys

import pytest

from moolib_tpu_torch.analysis import all_checks, lint_source, load_baseline
from moolib_tpu_torch.analysis.cli import main as mtlint_main
from moolib_tpu_torch.analysis.core import default_baseline_path

HOT = "moolib_tpu_torch/engine/hot.py"
LOCKED = "moolib_tpu_torch/group.py"
RNG = "moolib_tpu_torch/envs/fixture_env.py"


def findings(src, path, check=None):
    active, _suppressed = lint_source(src, path=path)
    if check:
        active = [f for f in active if f.check == check]
    return active


# --------------------------------------------------------------------------
# host-sync: each torch pattern
# --------------------------------------------------------------------------

@pytest.mark.parametrize("expr", [
    "x.item()",
    "x.cpu()",
    "x.tolist()",
    "x.numpy()",
    "torch.cuda.synchronize()",
    "event.synchronize()",
    "torch.cuda.current_stream().synchronize()",
    "float(x.sum())",
    "bool(torch.any(x))",
    "np.asarray(x)",
    "np.array(x)",
    "torch.tensor(0.5, device=x.device)",
    "torch.tensor([1, 2], device='cuda')",
])
def test_host_sync_torch_patterns(expr):
    src = f"import numpy as np\nimport torch\ndef f(x, event):\n    return {expr}\n"
    (f,) = findings(src, HOT, "host-sync")
    assert f.line == 4
    # out of scope: the same code elsewhere is silent
    assert not findings(src, "moolib_tpu_torch/broker.py", "host-sync")


def test_host_sync_scope_covers_the_anakin_plane():
    src = "def f(x):\n    return x.item()\n"
    for path in ("moolib_tpu_torch/rollout.py", "moolib_tpu_torch/envs/jax_envs.py",
                 "moolib_tpu_torch/ops/vtrace.py", "moolib_tpu_torch/replay/device.py",
                 "moolib_tpu_torch/replay/distributed.py", "moolib_tpu_torch/replay/ingest.py"):
        assert findings(src, path, "host-sync"), path
    # the host reference store and the host envs are out of scope
    for path in ("moolib_tpu_torch/replay/host.py", "moolib_tpu_torch/envs/catch.py"):
        assert not findings(src, path, "host-sync"), path


def test_host_sync_aliased_numpy():
    src = "import numpy as banana\ndef f(x):\n    return banana.asarray(x)\n"
    assert len(findings(src, HOT, "host-sync")) == 1


def test_host_sync_clean_variants():
    # host scalar math is not a sync, a CPU tensor is not an H2D, and
    # building on the device from a device tensor needs no host value
    for src in ("def f(a, b):\n    return int(min(a, b))\n",
                "import torch\ndef f():\n    return torch.tensor([1, 2], device='cpu')\n",
                "import torch\ndef f(x):\n    return torch.zeros_like(x) + 0.5\n"):
        assert not findings(src, HOT, "host-sync"), src


# --------------------------------------------------------------------------
# raw-rng: each torch pattern
# --------------------------------------------------------------------------

@pytest.mark.parametrize("expr", [
    "torch.rand(3)",
    "torch.randint(0, 5, (3,))",
    "torch.randn_like(x)",
    "torch.multinomial(x, 1)",
    "x.uniform_()",
    "x.bernoulli_(0.5)",
    "torch.manual_seed(0)",
    "np.random.rand(3)",
    "np.random.default_rng()",
])
def test_raw_rng_torch_patterns(expr):
    src = f"import numpy as np\nimport torch\ndef reset(x, g):\n    return {expr}\n"
    assert len(findings(src, RNG, "raw-rng")) == 1
    assert len(findings(src, "moolib_tpu_torch/rollout.py", "raw-rng")) == 1
    assert not findings(src, "moolib_tpu_torch/models/impala.py", "raw-rng")


def test_raw_rng_seeded_draws_are_clean():
    src = (
        "import numpy as np\nimport torch\n"
        "def reset(x, g, seed, key, e):\n"
        "    a = torch.rand(3, generator=g)\n"
        "    x.uniform_(generator=g)\n"
        "    r = np.random.default_rng(seed)\n"
        "    return _threefry.fold_in(key, e)\n"
    )
    assert not findings(src, RNG, "raw-rng")


# --------------------------------------------------------------------------
# the other checks
# --------------------------------------------------------------------------

def test_unported_checks_are_absent():
    """donation-safety and recompile-risk are JAX idioms (donated jit
    buffers, jit retraces) with no torch meaning; the registry says so."""
    names = set(all_checks())
    assert names == {"host-sync", "raw-rng", "bare-timer", "blocking-under-lock", "metric-docs"}
    from moolib_tpu_torch.analysis import checks

    assert "donation-safety" in checks.__doc__ and "recompile-risk" in checks.__doc__


def test_bare_timer_aliased():
    src = "from time import perf_counter as pc\ndef f():\n    return pc()\n"
    assert len(findings(src, "moolib_tpu_torch/group.py", "bare-timer")) == 1
    # the telemetry plane itself is allowed to own the timers
    assert not findings(src, "moolib_tpu_torch/telemetry/metrics.py", "bare-timer")
    assert not findings(src, "moolib_tpu_torch/utils/profiling.py", "bare-timer")
    # and the JAX package's tree is not the port's lint's business
    assert not findings(src, "moolib_tpu/group.py", "bare-timer")


def test_blocking_under_lock():
    src = (
        "import threading\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def f(self, fut):\n"
        "        with self._lock:\n"
        "            return fut.result()\n"
    )
    (f,) = findings(src, LOCKED, "blocking-under-lock")
    assert f.line == 7
    # .result(0) cannot block; outside the with it is fine anyway
    clean = src.replace("fut.result()", "fut.result(0)")
    assert not findings(clean, LOCKED, "blocking-under-lock")


@pytest.mark.parametrize("expr", [
    "torch.cuda.synchronize()", "event.synchronize()", "x.item()", "time.sleep(1)",
])
def test_blocking_under_lock_torch_patterns(expr):
    src = (
        "import threading, time, torch\n"
        "_lock = threading.Lock()\n"
        "def f(x, event):\n"
        "    with _lock:\n"
        f"        return {expr}\n"
    )
    (f,) = findings(src, "moolib_tpu_torch/checkpoint.py", "blocking-under-lock")
    assert f.line == 5
    assert not findings(src, "moolib_tpu_torch/models/impala.py", "blocking-under-lock")


def test_blocking_under_lock_condition_wait_exempt():
    src = (
        "import threading\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._cond = threading.Condition()\n"
        "    def f(self):\n"
        "        with self._cond:\n"
        "            self._cond.wait()\n"
    )
    # waiting on the lock you hold releases it — not a blocking hold
    assert not findings(src, LOCKED, "blocking-under-lock")


def _metric_tree(tmp_path, docs):
    for rel, text in docs.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    pkg = tmp_path / "moolib_tpu_torch"
    pkg.mkdir(exist_ok=True)
    (pkg / "thing.py").write_text(
        "def f(reg):\n"
        "    reg.counter('documented_total', 'ok')\n"
        "    reg.counter('port_only_total', 'the port table')\n"
    )
    return [str(pkg), "--root", str(tmp_path), "--no-baseline", "--check", "metric-docs"]


ROW = "| Metric | Type |\n|---|---|\n| `{}` | counter |\n"


def test_metric_docs_reads_both_tables(tmp_path):
    args = _metric_tree(tmp_path, {"docs/TELEMETRY.md": ROW.format("documented_total")})
    assert mtlint_main(args) == 1  # port_only_total is in no table
    (tmp_path / "moolib_tpu_torch" / "TELEMETRY.md").write_text(ROW.format("port_only_total"))
    assert mtlint_main(args) == 0


def test_metric_docs_prose_mention_is_not_a_row(tmp_path):
    args = _metric_tree(tmp_path, {
        "docs/TELEMETRY.md": ROW.format("documented_total"),
        "moolib_tpu_torch/TELEMETRY.md": "`port_only_total` is mentioned, not tabled\n",
    })
    assert mtlint_main(args) == 1


# --------------------------------------------------------------------------
# pragmas
# --------------------------------------------------------------------------

def test_pragma_suppresses_same_line():
    src = "def f(x):\n    return x.item()  # mtlint: allow-host-sync(the one D2H)\n"
    active, suppressed = lint_source(src, path=HOT)
    assert not [f for f in active if f.check == "host-sync"]
    assert len(suppressed) == 1


def test_pragma_standalone_covers_next_line():
    src = "def f(x):\n    # mtlint: allow-host-sync(documented)\n    return x.item()\n"
    active, suppressed = lint_source(src, path=HOT)
    assert not [f for f in active if f.check == "host-sync"]
    assert len(suppressed) == 1


def test_pragma_requires_reason():
    src = "def f(x):\n    return x.item()  # mtlint: allow-host-sync()\n"
    active, _ = lint_source(src, path=HOT)
    assert [f for f in active if f.check == "pragma"]


def test_pragma_wrong_check_does_not_suppress():
    src = "def f(x):\n    return x.item()  # mtlint: allow-bare-timer(nope)\n"
    active, _ = lint_source(src, path=HOT)
    assert [f for f in active if f.check == "host-sync"]


# --------------------------------------------------------------------------
# baseline + CLI exit codes
# --------------------------------------------------------------------------

def _tree(tmp_path, body):
    pkg = tmp_path / "moolib_tpu_torch" / "engine"
    pkg.mkdir(parents=True)
    (pkg / "hot.py").write_text(body)
    return tmp_path


DIRTY = "def f(x):\n    return x.cpu()\n"


def test_cli_clean_tree_exits_zero(tmp_path):
    root = _tree(tmp_path, "def f(x):\n    return x\n")
    assert mtlint_main([str(root / "moolib_tpu_torch"), "--root", str(root), "--no-baseline"]) == 0


def test_cli_violation_exits_one(tmp_path):
    root = _tree(tmp_path, DIRTY)
    assert mtlint_main([str(root / "moolib_tpu_torch"), "--root", str(root), "--no-baseline"]) == 1


def test_baseline_roundtrip(tmp_path):
    root = _tree(tmp_path, DIRTY)
    bl = root / "baseline.json"
    args = [str(root / "moolib_tpu_torch"), "--root", str(root), "--baseline", str(bl)]
    assert mtlint_main(args + ["--write-baseline"]) == 0
    data = json.loads(bl.read_text())
    assert data["entries"] and data["entries"][0]["check"] == "host-sync"
    # baselined finding no longer fails the gate
    assert mtlint_main(args) == 0
    # ...but a NEW violation still does (count-aware: 2 found vs 1 baselined)
    (root / "moolib_tpu_torch" / "engine" / "hot.py").write_text(
        DIRTY + "def g(y):\n    return y.cpu()\n"
    )
    assert mtlint_main(args) == 1


def test_baseline_stale_detection(tmp_path):
    root = _tree(tmp_path, DIRTY)
    bl = root / "baseline.json"
    args = [str(root / "moolib_tpu_torch"), "--root", str(root), "--baseline", str(bl)]
    assert mtlint_main(args + ["--write-baseline"]) == 0
    # fix the violation: --prune-baseline reports the now-stale entry...
    (root / "moolib_tpu_torch" / "engine" / "hot.py").write_text("def f(x):\n    return x\n")
    assert mtlint_main(args + ["--prune-baseline"]) == 1
    # ...and re-writing shrinks the baseline to empty
    assert mtlint_main(args + ["--write-baseline"]) == 0
    assert json.loads(bl.read_text())["entries"] == []


# --------------------------------------------------------------------------
# the port's tree: the CI gate
# --------------------------------------------------------------------------

def test_port_is_lint_clean():
    """The gate: the committed port tree with its committed baseline has
    zero new findings, and no baseline entry is stale."""
    assert mtlint_main([]) == 0
    assert mtlint_main(["--prune-baseline"]) == 0


def test_anakin_plane_has_no_baseline_entries_and_two_reasoned_syncs():
    """The zero-crossing plane is held to the contract outright: neither
    the envs nor AnakinRollout is grandfathered, and its only pragmas are
    the backpressure wait and the stats() snapshot."""
    from moolib_tpu_torch.analysis import lint_paths
    from moolib_tpu_torch.analysis.cli import _default_root

    anakin = ("AnakinRollout", "_build_anakin_fns")
    for check, path, symbol, _text in load_baseline(default_baseline_path()):
        assert not path.startswith("moolib_tpu_torch/envs/"), (check, path, symbol)
        assert not symbol.startswith(anakin), (check, path, symbol)
    root = _default_root()
    active, suppressed, broken = lint_paths(
        [f"{root}/moolib_tpu_torch/rollout.py", f"{root}/moolib_tpu_torch/envs"], root=root)
    assert not broken
    assert not [f for f in active if f.symbol.startswith(anakin) or "/envs/" in f.path]
    syncs = {f.symbol for f in suppressed if f.symbol.startswith(anakin)}
    assert syncs == {"AnakinRollout.unroll", "AnakinRollout.stats"}
    assert not [f for f in suppressed if "/envs/" in f.path]


def test_cli_module_entrypoint():
    out = subprocess.run(
        [sys.executable, "-m", "moolib_tpu_torch.analysis", "--list"],
        capture_output=True, text=True, check=True,
    )
    assert "host-sync" in out.stdout and "donation-safety" not in out.stdout
