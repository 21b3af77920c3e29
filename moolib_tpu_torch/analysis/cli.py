"""mtlint CLI (``python -m moolib_tpu_torch.analysis [paths...]``).

Exit 0: no findings beyond the committed baseline.  Exit 1: new findings
(printed one per line, ``path:line:col: check: message``).  Exit 2: usage
errors (unknown check name, unparseable baseline).

    python -m moolib_tpu_torch.analysis                    # lint moolib_tpu_torch/
    python -m moolib_tpu_torch.analysis --check bare-timer # one check only
    python -m moolib_tpu_torch.analysis --list             # the check catalog
    python -m moolib_tpu_torch.analysis --write-baseline   # re-grandfather
    python -m moolib_tpu_torch.analysis --prune-baseline   # report stale entries
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

from .core import (
    all_checks,
    default_baseline_path,
    lint_paths,
    load_baseline,
    write_baseline,
)


def _default_root() -> str:
    """The directory containing the ``moolib_tpu_torch`` package = the repo root
    baselines are keyed against, wherever the lint is invoked from."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m moolib_tpu_torch.analysis", description=__doc__
    )
    p.add_argument("paths", nargs="*", help="files/dirs (default: moolib_tpu_torch/)")
    p.add_argument(
        "--check",
        action="append",
        default=None,
        metavar="NAME",
        help="run only these checks (repeat or comma-separate)",
    )
    p.add_argument(
        "--root", default=None, help="repo root for relative paths (default: auto)"
    )
    p.add_argument(
        "--baseline",
        default=None,
        metavar="FILE",
        help=f"baseline file (default: {os.path.basename(default_baseline_path())})",
    )
    p.add_argument(
        "--no-baseline", action="store_true", help="ignore the baseline entirely"
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="write every current finding into the baseline and exit 0",
    )
    p.add_argument(
        "--prune-baseline",
        action="store_true",
        help="report baseline entries that no longer match any finding",
    )
    p.add_argument("--list", action="store_true", help="list checks and exit")
    p.add_argument(
        "-q", "--quiet", action="store_true", help="suppress the summary line"
    )
    args = p.parse_args(argv)

    registry = all_checks()
    if args.list:
        width = max(len(n) for n in registry)
        for name in sorted(registry):
            print(f"{name:<{width}}  {registry[name].description}")
        return 0

    checks: Optional[List[str]] = None
    if args.check:
        checks = [c for chunk in args.check for c in chunk.split(",") if c]
        unknown = [c for c in checks if c not in registry]
        if unknown:
            print(f"unknown check(s): {', '.join(unknown)}", file=sys.stderr)
            print(f"available: {', '.join(sorted(registry))}", file=sys.stderr)
            return 2

    root = os.path.abspath(args.root or _default_root())
    paths = list(args.paths) or [os.path.join(root, "moolib_tpu_torch")]
    active, suppressed, broken = lint_paths(paths, root=root, checks=checks)

    baseline_path = args.baseline or default_baseline_path()
    if args.write_baseline:
        write_baseline(baseline_path, active)
        print(
            f"wrote {len(active)} finding(s) to {os.path.relpath(baseline_path, root)}"
        )
        return 0

    baseline = {} if args.no_baseline else load_baseline(baseline_path)
    matched: dict = {}
    new = []
    for f in active:
        k = f.key()
        if baseline.get(k, 0) > matched.get(k, 0):
            matched[k] = matched.get(k, 0) + 1
        else:
            new.append(f)

    for f in new:
        print(f.format())
    for path in broken:
        print(f"{path}:0:0: parse-error: file could not be parsed", file=sys.stderr)

    rc = 1 if (new or broken) else 0
    if args.prune_baseline:
        stale = [k for k in baseline if k not in matched]
        for check, path, symbol, text in sorted(stale):
            where = f" [{symbol}]" if symbol else ""
            print(f"stale baseline entry: {path}: {check}: {text!r}{where}")
        rc = 1 if (rc or stale) else 0
    if not args.quiet:
        n_base = sum(matched.values())
        print(
            f"mtlint: {len(new)} new finding(s), {n_base} baselined, "
            f"{len(suppressed)} pragma-suppressed "
            f"({len(registry) if checks is None else len(checks)} check(s))",
            file=sys.stderr,
        )
    return rc


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
