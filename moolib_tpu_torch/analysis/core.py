"""mtlint core for the port: findings, pragma suppression, baseline, runner.

The port's own copy of the JAX package's ``analysis/core.py`` (stdlib
only, so the lint parses modules without importing torch).  The contracts
the port's hot paths run on (the zero-crossing actor plane, the
counter-based seeding contract, no host sync per frame or per decode step,
lock ordering across the threaded planes) are AST checks here, run by the
tier-1 tests instead of by review.

Three suppression layers, in order of preference:

1. **Fix it.**  Most findings are real.
2. **Inline pragma** — ``# mtlint: allow-<check>(reason)`` on the offending
   line (or alone on the line above).  The reason is mandatory: a pragma
   documents *why* the contract does not apply at this site, and an empty
   reason is itself reported as a ``pragma`` finding.
3. **The committed baseline** (``analysis/baseline.json``) — grandfathered
   findings from before a check existed.  The gate is *zero new
   violations*: anything not in the baseline fails the run.  Baseline
   entries are keyed on (check, path, enclosing symbol, stripped source
   text) so ordinary line drift does not invalidate them; entries that no
   longer match anything are reported as stale by ``--prune-baseline``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Check",
    "Finding",
    "ModuleSource",
    "all_checks",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "register",
    "write_baseline",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at one source location."""

    check: str
    path: str  # repo-root-relative, forward slashes
    line: int
    col: int
    message: str
    symbol: str = ""  # enclosing Class.function, "" at module level
    text: str = ""  # stripped source line (baseline key, survives line drift)

    def key(self) -> Tuple[str, str, str, str]:
        """Baseline identity: stable across pure line-number drift."""
        return (self.check, self.path, self.symbol, self.text)

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}:{self.col}: {self.check}: {self.message}{sym}"


class ModuleSource:
    """A parsed module plus the lookup tables every check needs: the import
    alias map (so ``from time import perf_counter as pc`` still resolves to
    ``time.perf_counter``), the enclosing-symbol map, and the pragma table."""

    def __init__(self, path: str, text: str):
        self.path = path.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.aliases = self._collect_aliases(self.tree)
        self._symbols = self._collect_symbols(self.tree)
        self.pragmas, self.malformed_pragmas = self._collect_pragmas(self.lines)

    # -- imports ---------------------------------------------------------
    @staticmethod
    def _collect_aliases(tree: ast.AST) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        out[a.asname] = a.name
                    else:
                        head = a.name.split(".")[0]
                        out[head] = head
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    def qualname(self, node: ast.AST) -> str:
        """Canonical dotted name of a Name/Attribute chain, aliases resolved
        (``np.asarray`` -> ``numpy.asarray``); "" when not a plain chain."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return ""
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))

    # -- enclosing symbols ----------------------------------------------
    @staticmethod
    def _collect_symbols(tree: ast.AST) -> List[Tuple[int, int, str]]:
        spans: List[Tuple[int, int, str]] = []

        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                ):
                    name = f"{prefix}.{child.name}" if prefix else child.name
                    end = getattr(child, "end_lineno", child.lineno) or child.lineno
                    spans.append((child.lineno, end, name))
                    visit(child, name)
                else:
                    visit(child, prefix)

        visit(tree, "")
        return spans

    def symbol_at(self, line: int) -> str:
        best = ""
        for lo, hi, name in self._symbols:
            if lo <= line <= hi:
                best = name  # spans are visited outer-first; keep innermost
        return best

    # -- pragmas ---------------------------------------------------------
    _PRAGMA_RE = re.compile(r"#\s*mtlint:\s*allow-([a-z][a-z0-9-]*)\(([^)]*)\)")

    @classmethod
    def _collect_pragmas(
        cls, lines: Sequence[str]
    ) -> Tuple[Dict[Tuple[int, str], str], List[Tuple[int, str]]]:
        """{(line, check): reason} — a pragma covers its own line; a pragma
        on a line that holds nothing else also covers the next line (for
        statements too long to share a line with their excuse)."""
        table: Dict[Tuple[int, str], str] = {}
        malformed: List[Tuple[int, str]] = []
        for i, raw in enumerate(lines, start=1):
            for m in cls._PRAGMA_RE.finditer(raw):
                check, reason = m.group(1), m.group(2).strip()
                if not reason:
                    malformed.append((i, check))
                    continue
                table[(i, check)] = reason
                if raw.strip().startswith("#"):
                    table[(i + 1, check)] = reason
        return table, malformed

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


class Check:
    """One registered contract check.  Subclasses set ``name`` /
    ``description`` / ``scope`` and implement :meth:`run` yielding findings;
    the runner applies pragma + baseline suppression afterwards."""

    name: str = ""
    description: str = ""
    #: predicate over the repo-relative path; default = every python file
    #: under moolib_tpu_torch/ (checks narrow this to their contract's
    #: modules).
    scope: Callable[[str], bool] = staticmethod(
        lambda path: path.startswith("moolib_tpu_torch/")
    )

    def run(self, mod: ModuleSource, ctx: "Context") -> Iterator[Finding]:
        raise NotImplementedError

    # convenience for subclasses
    def finding(
        self, mod: ModuleSource, node: ast.AST, message: str
    ) -> Finding:
        line = getattr(node, "lineno", 0)
        return Finding(
            check=self.name,
            path=mod.path,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            symbol=mod.symbol_at(line),
            text=mod.line_text(line),
        )


@dataclasses.dataclass
class Context:
    """Run-wide state shared by checks (repo root for checks that read
    sibling files, e.g. metric-docs reading the TELEMETRY.md tables)."""

    root: str


_REGISTRY: Dict[str, Check] = {}


def register(check_cls) -> type:
    inst = check_cls()
    if not inst.name:
        raise ValueError(f"{check_cls.__name__} has no name")
    _REGISTRY[inst.name] = inst
    return check_cls


def all_checks() -> Dict[str, Check]:
    from . import checks as _checks  # noqa: F401  (registration side effect)

    return dict(_REGISTRY)


# -- baseline ------------------------------------------------------------


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def load_baseline(path: Optional[str]) -> Dict[Tuple[str, str, str, str], int]:
    if not path or not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out: Dict[Tuple[str, str, str, str], int] = {}
    for e in data.get("entries", []):
        key = (e["check"], e["path"], e.get("symbol", ""), e.get("text", ""))
        out[key] = out.get(key, 0) + int(e.get("count", 1))
    return out


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    counts: Dict[Tuple[str, str, str, str], int] = {}
    for f in findings:
        counts[f.key()] = counts.get(f.key(), 0) + 1
    entries = [
        {"check": c, "path": p, "symbol": s, "text": t, "count": n}
        for (c, p, s, t), n in sorted(counts.items())
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2, sort_keys=True)
        f.write("\n")


# -- runner --------------------------------------------------------------


def _iter_py_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def _run_checks_on_module(
    mod: ModuleSource, checks: Iterable[Check], ctx: Context
) -> Tuple[List[Finding], List[Finding]]:
    """Returns (active findings, pragma-suppressed findings)."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for check in checks:
        if not check.scope(mod.path):
            continue
        for f in check.run(mod, ctx):
            if (f.line, f.check) in mod.pragmas:
                suppressed.append(f)
            else:
                active.append(f)
    for line, check_name in mod.malformed_pragmas:
        active.append(
            Finding(
                check="pragma",
                path=mod.path,
                line=line,
                col=0,
                message=(
                    f"allow-{check_name} pragma without a reason — write "
                    f"`# mtlint: allow-{check_name}(why the contract does "
                    "not apply here)`"
                ),
                symbol=mod.symbol_at(line),
                text=mod.line_text(line),
            )
        )
    return active, suppressed


def lint_source(
    text: str,
    path: str = "moolib_tpu_torch/snippet.py",
    checks: Optional[Sequence[str]] = None,
    root: str = ".",
) -> Tuple[List[Finding], List[Finding]]:
    """Lint a source string as if it lived at ``path`` (test/fixture entry
    point).  Returns ``(active, pragma_suppressed)`` findings."""
    registry = all_checks()
    selected = [registry[c] for c in checks] if checks else list(registry.values())
    mod = ModuleSource(path, text)
    active, suppressed = _run_checks_on_module(mod, selected, Context(root=root))
    active.sort(key=lambda f: (f.path, f.line, f.check))
    return active, suppressed


def lint_paths(
    paths: Sequence[str],
    root: str,
    checks: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Lint files/dirs.  Returns (active findings, pragma-suppressed
    findings, unparseable files).  ``root`` anchors the repo-relative paths
    findings and baselines are keyed on."""
    registry = all_checks()
    if checks:
        unknown = [c for c in checks if c not in registry]
        if unknown:
            raise KeyError(f"unknown check(s): {', '.join(unknown)}")
        selected = [registry[c] for c in checks]
    else:
        selected = list(registry.values())
    ctx = Context(root=root)
    active: List[Finding] = []
    suppressed: List[Finding] = []
    broken: List[str] = []
    for file in _iter_py_files(paths):
        rel = os.path.relpath(os.path.abspath(file), os.path.abspath(root))
        rel = rel.replace(os.sep, "/")
        try:
            with open(file, "r", encoding="utf-8") as f:
                text = f.read()
            mod = ModuleSource(rel, text)
        except (SyntaxError, UnicodeDecodeError, OSError):
            broken.append(rel)
            continue
        got, supp = _run_checks_on_module(mod, selected, ctx)
        active.extend(got)
        suppressed.extend(supp)
    active.sort(key=lambda f: (f.path, f.line, f.check))
    suppressed.sort(key=lambda f: (f.path, f.line, f.check))
    return active, suppressed, broken
