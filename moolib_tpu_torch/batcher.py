"""Batcher: assemble pytrees into device-resident batches.

Counterpart of the reference's C++ ``Batcher`` (``src/moolib.cc:595-889,
1411-1488``; ctor args size/device/dim at ``:1888``): accumulate pytree items
by ``stack`` (one slot per call along a new axis ``dim``) or ``cat``
(concatenate along existing axis ``dim``, with arbitrary-length items split
across batch boundaries — the carry-over path, reference ``:767-811``).  When
a batch fills, ``get()`` returns it; ``empty()``/``size()`` poll; awaiting
the batcher yields filled batches in asyncio code.

The PyTorch port of the JAX package's ``batcher``: instead of copying
slot-by-slot into device storage, items accumulate as host numpy and each
leaf of a completed batch is stacked once into pinned host memory and sent
to the card with one ``.to(device, non_blocking=True)`` (one contiguous
host-to-device copy per leaf; the JAX package's single ``jax.device_put``).

Two assembly paths (docs/DESIGN.md "Actor data plane"):

- **host** (numpy items): leaves accumulate as host numpy — CUDA-tensor
  leaves are coerced down (a D2H crossing, counted in
  ``batcher_d2h_bytes_total``) — and the completed batch crosses up in one
  copy per leaf when a device is set (``batcher_h2d_bytes_total``).  This
  is the legacy rollout data plane: every batch pays a down-and-up round
  trip.
- **device** (CUDA-tensor items): leaves stay on the card; stack/cat/split
  run as ``torch.stack``/``torch.cat`` and the "completed batch" is
  device-resident already — zero host-boundary bytes.  A batch on another
  card than ``device`` is moved there (``batcher_d2d_bytes_total``).

``device=None`` (or ``"cpu"``) keeps batches on the host as numpy, as in
the JAX package; ``device="cuda"`` without a card raises
:class:`~moolib_tpu_torch._device.NoCudaError`.

The path is latched from the first item's leaf type unless forced with the
``host=`` constructor argument.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from . import telemetry
from ._device import resolve
from .utils import nest

# Batch-assembly metrics (docs/TELEMETRY.md): how full batches run and how
# long completed batches sit ready before the consumer drains them (a
# persistent ready-wait means the learner, not assembly, is the bottleneck).
_REG = telemetry.get_registry()
_M_BATCHES = _REG.counter("batcher_batches_total", "completed batches")
_M_ITEMS = _REG.counter("batcher_items_total", "rows batched (batch-axis length)")
_M_READY_DEPTH = _REG.gauge("batcher_ready_depth", "completed batches awaiting get()")
_M_READY_WAIT = _REG.histogram(
    "batcher_ready_wait_seconds", "batch completion to get()/await"
)
# Host-boundary traffic of batch assembly (docs/TELEMETRY.md): the host path
# pays D2H per coerced CUDA leaf and H2D per completed batch's upload; the
# device path pays neither.
_M_D2H_BYTES = _REG.counter(
    "batcher_d2h_bytes_total", "device leaves coerced to host during assembly"
)
_M_H2D_BYTES = _REG.counter(
    "batcher_h2d_bytes_total", "completed host batches uploaded to the card"
)
# Sebulba (arXiv:2104.06272): when the device path's target lives on a
# DIFFERENT card than the incoming leaves (actor card -> learner card), the
# batcher IS the inter-device queue and its copy is the trajectory handoff —
# counted here, never in the host-boundary counters (the bytes ride NVLink,
# not PCIe).
_M_D2D_BYTES = _REG.counter(
    "batcher_d2d_bytes_total",
    "device batches moved to another card (inter-device handoff)",
)
# Flow control at the Sebulba seam (ROADMAP item 2): with ``max_outstanding``
# set, producers block once this many completed batches sit unconsumed —
# actor lead over the learner is bounded instead of growing without limit.
# Per-instance label so the autoscaler can tell the learn queue from others.
_M_QUEUE_DEPTH = _REG.gauge(
    "batcher_queue_depth",
    "completed batches held in the (optionally bounded) ready queue",
    ("batcher",),
)
_M_PUT_BLOCKED = _REG.histogram(
    "batcher_put_blocked_seconds",
    "producer time spent blocked on a full bounded ready queue",
    ("batcher",),
)


def _pinned_like(shape, dtype: np.dtype):
    """A pinned host tensor and its numpy view, or None for a dtype torch
    has no tensor for (object leaves stay numpy)."""
    try:
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:
        return None
    buf = torch.empty(shape, dtype=tdtype, pin_memory=True)
    return buf, buf.numpy()


def _join_shape(join, xs, dim) -> tuple:
    shape = list(np.shape(xs[0]))
    if join is np.stack:
        shape.insert(dim % (len(shape) + 1), len(xs))
    else:
        shape[dim] = sum(np.shape(x)[dim] for x in xs)
    return tuple(shape)


def _host_join_leaves(join, xs, dim, pin: bool):
    """``np.stack`` or ``np.concatenate`` of host leaves (the host path never
    bounces through torch's device ops).  With ``pin`` the result is written
    straight into a pinned tensor, ready for a non-blocking copy to the
    card.  Leaves ``np.stack`` cannot join become an object array, like
    ``nest._stack_leaves``."""
    try:
        if pin:
            out = _pinned_like(_join_shape(join, xs, dim), np.result_type(*xs))
            if out is not None:
                join(xs, axis=dim, out=out[1])
                return out[0]
        return join(xs, axis=dim)
    except (TypeError, ValueError):
        if join is not np.stack:
            raise
        out = np.empty(len(xs), dtype=object)
        for i, x in enumerate(xs):
            out[i] = x
        return out


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return getattr(x, "nbytes", 0)


def _resolve_device(device):
    """None (batches stay host numpy) for None, "" or "cpu"; else the
    torch.device of "cuda", "cuda:0" or a ``torch.device``, with the card's
    index filled in."""
    if device is None or str(device) in ("cpu", ""):
        return None
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Batcher:
    """See module docstring. API: stack(item), cat(item), empty(), size(),
    get(), plus awaitable batches."""

    def __init__(self, size: int, device: Optional[str] = None, dim: int = 0,
                 host: Optional[bool] = None,
                 max_outstanding: Optional[int] = None, name: str = "batcher"):
        if size < 1:
            raise ValueError("batch size must be >= 1")
        if max_outstanding is not None and max_outstanding < 1:
            raise ValueError("max_outstanding must be >= 1 (or None = unbounded)")
        self._size = size
        self._dim = dim
        self._device = _resolve_device(device)
        # None = latch from the first item: CUDA-tensor leaves keep the
        # device-side path (torch stack/cat, no crossings), anything else
        # accumulates as host numpy.  True/False forces a path.
        self._host = host
        # Bounded ready queue: with max_outstanding set, the producer's
        # stack()/cat() BLOCKS once this many completed batches await get()
        # — backpressure instead of unbounded actor lead.  None keeps the
        # legacy unbounded behavior (and can never deadlock single-threaded
        # fill-then-drain code).
        self._max_outstanding = max_outstanding
        self._name = name
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._slots: List[Any] = []
        self._cat_count = 0
        self._ready: collections.deque = collections.deque()
        self._waiters: collections.deque = collections.deque()

    def _latch_path(self, item) -> None:
        if self._host is None:
            leaf = next(nest.flatten(item), None)
            self._host = not (isinstance(leaf, torch.Tensor) and leaf.is_cuda)

    def _to_host(self, item):
        """Host-path coercion: tensor leaves become numpy, CUDA ones come
        down (counted D2H)."""

        def _coerce(x):
            if isinstance(x, torch.Tensor):
                out = x.detach().cpu().numpy()
                if x.is_cuda:
                    _M_D2H_BYTES.inc(out.nbytes)
                return out
            return x

        return nest.map(_coerce, item)

    def _assemble(self, items):
        """Stack slot items into a batch on the latched path."""
        if self._host:
            pin = self._device is not None
            return nest.map_many(
                lambda *xs: _host_join_leaves(np.stack, xs, self._dim, pin), *items
            )
        return nest.stack(items, dim=self._dim)

    def _assemble_cat(self, items):
        if self._host:
            pin = self._device is not None
            return nest.map_many(
                lambda *xs: _host_join_leaves(np.concatenate, xs, self._dim, pin),
                *items,
            )
        return nest.cat(items, dim=self._dim)

    # ---------------------------------------------------------------- fill
    def stack(self, item) -> None:
        """Add one item; a batch completes after ``size`` calls (new axis)."""
        with self._lock:
            self._latch_path(item)
            if self._host:
                item = self._to_host(item)
            self._slots.append(item)
            if len(self._slots) >= self._size:
                items, self._slots = self._slots[: self._size], self._slots[self._size :]
                self._finish(self._assemble(items))

    def cat(self, item) -> None:
        """Add an item whose leaves already have the batch axis; completes
        when ``size`` rows accumulate, splitting oversized items (carry-over)."""
        with self._lock:
            self._latch_path(item)
            if self._host:
                item = self._to_host(item)
            length = self._item_length(item)
            offset = 0
            while offset < length:
                room = self._size - self._cat_count
                take = min(room, length - offset)
                part = (
                    item
                    if take == length and offset == 0
                    else nest.map(lambda x: self._slice(x, offset, take), item)
                )
                self._slots.append(part)
                self._cat_count += take
                offset += take
                if self._cat_count >= self._size:
                    items, self._slots = self._slots, []
                    self._cat_count = 0
                    self._finish(
                        items[0] if len(items) == 1 else self._assemble_cat(items)
                    )

    def _item_length(self, item) -> int:
        leaves = list(nest.flatten(item))
        if not leaves:
            raise ValueError("empty item")
        return int(np.shape(leaves[0])[self._dim])

    def _slice(self, x, offset: int, take: int):
        idx = [slice(None)] * np.ndim(x)
        idx[self._dim] = slice(offset, offset + take)
        return x[tuple(idx)]

    def _upload(self, x):
        """One leaf of a completed host batch to the card: numeric numpy
        (an item that filled a cat batch alone) is first copied into pinned
        memory; the copy to the card does not block the host."""
        if isinstance(x, np.ndarray) and x.dtype != object:
            pinned = _pinned_like(x.shape, x.dtype)
            if pinned is None:
                return x
            pinned[1][...] = x
            x = pinned[0]
        if isinstance(x, torch.Tensor):
            return x.to(self._device, non_blocking=True)
        return x

    def _finish(self, batch) -> None:
        # Backpressure BEFORE the device_put: a blocked producer must not keep
        # uploading batches to device memory.  wait() releases the lock, so
        # consumers drain (get()/await notify via _pop_ready_locked).  A
        # waiter present means immediate handoff — no queue growth, no block.
        if self._max_outstanding is not None:
            t0 = None
            while len(self._ready) >= self._max_outstanding and not self._waiters:
                if t0 is None:
                    t0 = time.monotonic()
                self._not_full.wait()
            if t0 is not None:
                _M_PUT_BLOCKED.observe(time.monotonic() - t0, batcher=self._name)
        # One pinned host stack and one copy per leaf: a single host->card
        # hop each.
        if self._device is not None:
            if self._host:
                _M_H2D_BYTES.inc(
                    sum(_nbytes(x) for x in nest.flatten(batch)
                        if getattr(x, "dtype", None) != object)
                )
                batch = nest.map(self._upload, batch)
            else:
                # Device path: a same-card batch stays put; a cross-card copy
                # is the Sebulba actor->learner handoff.
                moved = sum(
                    _nbytes(x)
                    for x in nest.flatten(batch)
                    if isinstance(x, torch.Tensor) and x.device != self._device
                )
                if moved:
                    _M_D2D_BYTES.inc(moved)
                    batch = nest.map(
                        lambda x: x.to(self._device, non_blocking=True)
                        if isinstance(x, torch.Tensor) else x,
                        batch,
                    )
        _M_BATCHES.inc()
        _M_ITEMS.inc(self._size)
        if self._waiters:
            loop, af = self._waiters.popleft()
            _M_READY_WAIT.observe(0.0)  # a consumer was already waiting
            loop.call_soon_threadsafe(_set_result, af, batch)
        else:
            self._ready.append((batch, time.monotonic()))
            _M_READY_DEPTH.inc()
            _M_QUEUE_DEPTH.set(len(self._ready), batcher=self._name)

    # --------------------------------------------------------------- drain
    def empty(self) -> bool:
        with self._lock:
            return not self._ready

    def size(self) -> int:
        """Items currently buffered toward the next batch (reference ``size``)."""
        with self._lock:
            return self._cat_count if self._cat_count else len(self._slots)

    def get(self):
        with self._lock:
            if not self._ready:
                raise RuntimeError("Batcher.get() called with no complete batch")
            return self._pop_ready_locked()

    def _pop_ready_locked(self):
        batch, done_at = self._ready.popleft()
        _M_READY_DEPTH.dec()
        _M_QUEUE_DEPTH.set(len(self._ready), batcher=self._name)
        _M_READY_WAIT.observe(time.monotonic() - done_at)
        self._not_full.notify()
        return batch

    def __await__(self):
        import asyncio

        loop = asyncio.get_event_loop()
        af = loop.create_future()
        with self._lock:
            if self._ready:
                af.set_result(self._pop_ready_locked())
            else:
                self._waiters.append((loop, af))
        return af.__await__()

    __iter__ = __await__


def _set_result(af, value):
    if not af.cancelled():
        af.set_result(value)
