"""mtlint for the port — the contract lint (``python -m moolib_tpu_torch.analysis``).

The port's own copy of the JAX package's ``analysis/`` (the port imports
nothing of ``moolib_tpu``), rooted at ``moolib_tpu_torch/`` with its checks
rewritten for torch idioms.  Stdlib-only on purpose: the lint *parses*
modules whose runtime dependencies (torch, numpy) it never imports.  See
:mod:`.core` for the finding/pragma/baseline machinery and :mod:`.checks`
for the check catalog.
"""

from .core import (  # noqa: F401
    Check,
    Finding,
    all_checks,
    lint_paths,
    lint_source,
    load_baseline,
    register,
    write_baseline,
)
from .cli import main  # noqa: F401

__all__ = [
    "Check",
    "Finding",
    "all_checks",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "main",
    "register",
    "write_baseline",
]
