"""Batch-size finder: measure the throughput-optimal batch for a callable.

The port of the JAX package's ``utils/batchsize.py``: walk powers of two,
time ``fn`` (its first call at each size is a warm-up and is not timed:
kernel builds, cuBLAS heuristics and the caching allocator settle there),
stop when the marginal per-sample speedup drops below ``threshold`` or
the card runs out of memory, and return the best batch size.  Timing waits
for the card (``torch.cuda.synchronize``) whenever an input or output
lives there.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from . import log_info
from .nest import tree_leaves


def _cuda_device(*trees):
    for tree in trees:
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                return leaf.device
    return None


def _wait(device) -> None:
    if device is not None:
        torch.cuda.synchronize(device)


def find_batch_size(
    make_batch: Callable[[int], tuple],
    fn: Callable,
    start: int = 8,
    max_batch: int = 4096,
    threshold: float = 1.05,
    iters: int = 5,
) -> int:
    """Return the batch size with the best samples/sec.

    Args:
      make_batch: ``make_batch(n) -> args tuple`` building inputs of batch n.
      fn: callable taking ``*make_batch(n)``.
      threshold: keep doubling while throughput improves by at least this
        factor; stop on regression, plateau, or ``torch.cuda.OutOfMemoryError``
        (after which the allocator's cache is emptied).
    """
    best_bs, best_rate = None, 0.0
    bs = start
    while bs <= max_batch:
        args = out = None
        try:
            args = make_batch(bs)
            out = fn(*args)  # warm-up, not timed
            device = _cuda_device(args, out)
            _wait(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            _wait(device)
            dt = (time.perf_counter() - t0) / iters
        except torch.cuda.OutOfMemoryError as e:
            del args, out
            torch.cuda.empty_cache()
            log_info("batch size %d ran out of memory (%s); stopping search",
                     bs, type(e).__name__)
            break
        rate = bs / dt
        log_info("batch %d: %.1f samples/s (%.2f ms)", bs, rate, dt * 1e3)
        if best_bs is not None and rate < best_rate * threshold:
            break
        if rate > best_rate:
            best_bs, best_rate = bs, rate
        bs *= 2
    return best_bs if best_bs is not None else start
