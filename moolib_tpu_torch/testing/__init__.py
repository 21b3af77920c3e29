"""Deterministic fault-injection utilities (docs/RESILIENCE.md).

Everything here is test/chaos infrastructure: importing it must never
change production behavior.  The one production touchpoint is
:func:`moolib_tpu_torch.testing.faults.install_from_env`, which entry points call
and which is a strict no-op unless the ``MOOLIB_FAULTS`` environment
variable opts the process in.
"""

from .faults import FaultPlan, FrameFaults, install_from_env  # noqa: F401

__all__ = ["FaultPlan", "FrameFaults", "install_from_env"]
