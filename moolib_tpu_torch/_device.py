"""Device selection for the port's entry points.

Entry points run on the card: ``resolve(None)`` is ``cuda``.  A caller that
wants the CPU says so (``device="cpu"``, as the tests do); nothing here ever
drops to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class NoCudaError(RuntimeError):
    """Raised when an entry point defaults to CUDA and no card is present."""


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises :class:`NoCudaError` when CUDA is asked for (explicitly
    or by default) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaError(
            "moolib_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
