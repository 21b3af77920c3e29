"""Serving helpers: the batch bucketing policy.

Only :func:`bucket` and :func:`bucket_shapes` of the JAX package's
``serving`` module in this slice; the resilient serving tier (admission
control, replicas, the client) comes with a later one.
"""

from __future__ import annotations

from typing import List


def bucket(n: int, cap: int) -> int:
    """Next power-of-two >= n, capped: THE batch bucketing policy — the
    startup warmup enumerates exactly these shapes, so a policy change here
    cannot silently desync the two sites."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def bucket_shapes(cap: int) -> List[int]:
    """Every batch shape :func:`bucket` can produce for ``cap``."""
    shapes, b = [cap], 1
    while b < cap:
        shapes.append(b)
        b *= 2
    return shapes
