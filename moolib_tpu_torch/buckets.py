"""Flat-bucket gradient data plane: layout, reusable host buffers, flat EF-q8.

The gradient reduce path (docs/DESIGN.md "Gradient data plane") flattens a
gradient pytree once per (treedef, shapes, dtype) into fixed-size contiguous
**buckets** — slices of one flat host buffer — and ships each bucket through
the Group's tree/ring machinery as an independent in-flight op.  This module
owns the three pure building blocks:

- :class:`BucketLayout`: the deterministic flat layout (leaf offsets + bucket
  boundaries) for a list of leaf shapes and one dtype.  Derived only from
  shapes/dtype/bucket size, so every process with the same model computes the
  same layout — the layout is wire protocol (each bucket is its own allreduce
  op; peers must agree on bucket count and boundaries).
- a **flat buffer pool** (:func:`lease`/:func:`release`): preallocated,
  reusable host staging buffers.  Reuse is refcount-guarded: a buffer whose
  memory is still referenced outside the pool (e.g. pinned by an in-flight
  zero-copy send, or visible to the user through result views) is never
  handed out again — it is simply dropped and freed by the GC when the last
  reference dies.  Reuse is an optimization, never a correctness assumption.
- :func:`ef_quantize_flat`: error-feedback int8 quantization applied ONCE,
  vectorized on the flat buffer with a single flat residual — per-bucket
  absmax scales, grid values written back in place so the wire codec's
  per-hop q8 encode reproduces the exact same ints at the first hop (the
  quantization happens exactly once, at the source, where the residual
  lives).

Bucket size defaults to 4 MiB and is configured process-wide with
``MOOLIB_BUCKET_BYTES`` or :func:`set_bucket_bytes`; like the ring threshold
it must be set identically on every peer (bucket boundaries are part of the
op protocol).

The port's card seam lives here.  Leaves may be torch tensors: a CPU tensor
is read through the numpy array that shares its memory, and a CUDA tensor
is staged to the host without a synchronous copy — :meth:`BucketLayout.fill`
issues one ``copy_(..., non_blocking=True)`` per leaf into the flat buffer's
slice and records ONE CUDA event per fill, which the consumer waits on
before the wire reads the buffer; :func:`lease` backs such a buffer with
pinned host memory; :class:`GradientStream` starts each delivered chunk's
copies into pinned staging and hands out host views only after the chunk's
event.  No path catches a failed pinned allocation or copy and retries it
as a synchronous ``.cpu()``: the error propagates.  The host arithmetic
(the combine, EF-q8) stays numpy, exactly the JAX package's, so mixed
cohorts are bit-identical by construction.
"""

from __future__ import annotations

import os
import sys
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import telemetry, utils

_REG = telemetry.get_registry()
_M_D2H_BYTES = _REG.counter(
    "buckets_d2h_bytes_total",
    "Bytes of CUDA leaves staged into pinned host buffers (non-blocking copies)",
)
_M_D2H_EVENTS = _REG.counter(
    "buckets_d2h_events_total",
    "CUDA events recorded for D2H staging: one per fill, one per stream chunk",
)
_M_PINNED_LEASES = _REG.counter(
    "buckets_pinned_allocations_total",
    "Pinned host buffers allocated for staging (pool misses)",
)

_DEFAULT_BUCKET_BYTES = 4 << 20

_bucket_bytes = int(os.environ.get("MOOLIB_BUCKET_BYTES", _DEFAULT_BUCKET_BYTES))


def bucket_bytes() -> int:
    """Current flat-bucket size in bytes (default 4 MiB,
    ``MOOLIB_BUCKET_BYTES``).  Must match on every peer of a cohort."""
    return _bucket_bytes


def set_bucket_bytes(n: int) -> None:
    """Set the flat-bucket size (process-wide).  Pacing/pipelining only at
    equal settings — but the value IS wire protocol across a cohort: every
    peer must use the same size, like ``MOOLIB_RING_THRESHOLD``."""
    global _bucket_bytes
    if int(n) < 1:
        raise ValueError("bucket size must be >= 1 byte")
    _bucket_bytes = int(n)


def np_dtype(dt) -> np.dtype:
    """The numpy dtype of a leaf's ``dtype``: torch dtypes map through
    torch's own numpy bridge, which raises ``TypeError`` for the ones numpy
    lacks (``torch.bfloat16``: reduce such leaves in float32, and compress
    the wire with ``wire="bfloat16"``)."""
    if isinstance(dt, torch.dtype):
        return torch.empty(0, dtype=dt).numpy().dtype
    return np.dtype(dt)


def on_card(x) -> bool:
    """Is ``x`` a tensor on an accelerator (staged by :meth:`BucketLayout.fill`)?"""
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def host_view(x):
    """A leaf as the host arithmetic reads it, without copying: a CPU tensor
    as the numpy array sharing its memory, a CUDA tensor unchanged (only
    its shape and dtype are read; :meth:`BucketLayout.fill` stages it),
    anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x if on_card(x) else x.detach().numpy()
    return np.asarray(x)


def _pinned_empty(total: int, dtype: torch.dtype) -> torch.Tensor:
    """Page-locked host memory, so D2H copies into it run asynchronously."""
    return torch.empty(int(total), dtype=dtype, pin_memory=True)


def _record_event(device) -> "torch.cuda.Event":
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    _M_D2H_EVENTS.inc()
    return event


def stage(leaves: Sequence, staging: Optional[dict] = None):
    """Start the D2H copy of every CUDA leaf into its own pinned host tensor
    (``copy_(..., non_blocking=True)``, legal while the kernels producing
    the leaf are still queued: the copy is ordered after them on the
    stream).  Returns ``(staged, event)``: the leaves with each CUDA one
    replaced by its (still filling) host tensor, and the one event recorded
    after the copies — wait on it before reading — or None when no leaf was
    on the card.

    With ``staging`` (a dict the caller keeps, dtype -> flat pinned
    buffer), the host tensors are slices of those buffers, grown when the
    leaves outgrow them and reused by the next call with the same dict: a
    caller that stages the same tree again allocates no page-locked memory.
    The caller must not reuse the dict before it is done with ``staged``."""
    if staging is not None:
        need: Dict = {}
        for leaf in leaves:
            if on_card(leaf):
                need[leaf.dtype] = need.get(leaf.dtype, 0) + leaf.numel()
        for dt, n in need.items():
            if dt not in staging or staging[dt].numel() < n:
                staging[dt] = _pinned_empty(n, dt)
        offsets = dict.fromkeys(need, 0)
    staged, device, nbytes = [], None, 0
    for leaf in leaves:
        if on_card(leaf):
            n = leaf.numel()
            if staging is None:
                host = _pinned_empty(n, leaf.dtype)
            else:
                o = offsets[leaf.dtype]
                host = staging[leaf.dtype][o:o + n]
                offsets[leaf.dtype] = o + n
            host.copy_(leaf.detach().reshape(-1), non_blocking=True)
            staged.append(host.view(leaf.shape))
            device = leaf.device
            nbytes += leaf.numel() * leaf.element_size()
        else:
            staged.append(leaf)
    if device is None:
        return staged, None
    _M_D2H_BYTES.inc(nbytes)
    return staged, _record_event(device)


class BucketLayout:
    """Deterministic flat layout of a list of array leaves in one dtype.

    ``offsets[i]`` is leaf i's element offset into the flat buffer (leaves
    are packed back to back in tree-flatten order); ``bounds[k]`` is bucket
    k's ``(start, stop)`` element range.  Buckets are fixed-size element
    ranges of the flat buffer — a leaf may span bucket boundaries; that is
    what makes the layout a function of (shapes, dtype, bucket_bytes) alone.
    """

    __slots__ = (
        "shapes", "sizes", "offsets", "total", "dtype", "bucket_elems",
        "n_buckets", "bounds",
    )

    def __init__(self, shapes: Sequence[Tuple[int, ...]], dtype,
                 bucket_bytes_: Optional[int] = None):
        self.dtype = np.dtype(dtype)
        self.shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        self.sizes = tuple(
            int(np.prod(s, dtype=np.int64)) if s else 1 for s in self.shapes
        )
        offs, off = [], 0
        for n in self.sizes:
            offs.append(off)
            off += n
        self.offsets = tuple(offs)
        self.total = off
        bb = bucket_bytes() if bucket_bytes_ is None else int(bucket_bytes_)
        self.bucket_elems = max(1, bb // self.dtype.itemsize)
        if self.total == 0:
            self.n_buckets = 1
            self.bounds = ((0, 0),)
        else:
            self.n_buckets = -(-self.total // self.bucket_elems)
            self.bounds = tuple(
                (k * self.bucket_elems, min((k + 1) * self.bucket_elems, self.total))
                for k in range(self.n_buckets)
            )

    def signature(self) -> tuple:
        """Process-independent identity of this layout (the golden-layout
        test asserts two processes at the same model produce equal ones)."""
        return (self.dtype.str, self.bucket_elems, self.total, self.shapes)

    @classmethod
    def from_shardings(cls, treedef, shapes: Sequence[Tuple[int, ...]],
                       shardings: Sequence, dtype=np.float32,
                       bucket_bytes_: Optional[int] = None
                       ) -> "ShardedBucketLayout":
        """Layout for a tree of (possibly) device-sharded leaves: bucket
        boundaries are pinned to per-leaf shard boundaries, so a device
        shard's flat range never straddles a bucket — staging the addressable
        shard and slicing a per-host reduce range both stay zero-copy views.

        ``shardings`` is the flat list of per-leaf sharding objects (``None``
        for plain tensors and host arrays), aligned with ``shapes``;
        ``treedef`` is recorded for error messages only (the layout math is a
        function of shapes/dtype/shard counts alone, so every host at the
        same model and mesh computes the same layout — the cohort-wide wire
        contract).  Entries are what :func:`sharding_signature` takes.
        """
        sig = tuple(
            sharding_signature(s, sh) for s, sh in zip(shapes, shardings)
        )
        cuts: List[int] = []
        off = 0
        for shape, entry in zip(shapes, sig):
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if entry is not None:
                counts = entry[1]
                nshards = int(np.prod(counts, dtype=np.int64)) if counts else 1
                if nshards > 1 and n % nshards == 0:
                    step = n // nshards
                    cuts.extend(off + j * step for j in range(1, nshards))
            off += n
        return ShardedBucketLayout(
            shapes, dtype, cuts, sig, treedef=treedef,
            bucket_bytes_=bucket_bytes_,
        )

    def fill(self, flat: np.ndarray, leaves: Sequence):
        """Copy ``leaves`` into ``flat`` in layout order — exactly one pass,
        dtype conversion fused into the copy (no per-leaf staging array).

        CUDA leaves are copied with ``copy_(..., non_blocking=True)`` into
        their slice of ``flat`` (pinned when it came from
        ``lease(..., pinned=True)``) and the fill records one CUDA event
        after the last of them.  Returns that event — the caller waits on it
        before anything reads ``flat`` — or None when every leaf was on the
        host (then the copy is already done)."""
        dst = device = None
        nbytes = 0
        for off, n, leaf in zip(self.offsets, self.sizes, leaves):
            if on_card(leaf):
                if dst is None:
                    dst = torch.from_numpy(flat)
                dst[off:off + n].copy_(leaf.detach().reshape(-1), non_blocking=True)
                device = leaf.device
                nbytes += n * leaf.element_size()
            else:
                np.copyto(flat[off:off + n], host_view(leaf).reshape(-1),
                          casting="unsafe")
        if device is None:
            return None
        _M_D2H_BYTES.inc(nbytes)
        return _record_event(device)

    def unflatten(self, flat: np.ndarray) -> List[np.ndarray]:
        """Leaf views (no copy) into ``flat`` in layout order."""
        return [
            flat[off:off + n].reshape(s)
            for off, n, s in zip(self.offsets, self.sizes, self.shapes)
        ]


class ShardedBucketLayout(BucketLayout):
    """A :class:`BucketLayout` whose bucket boundaries are additionally
    pinned to device-shard boundaries (``BucketLayout.from_shardings``).

    The uniform ``bucket_elems`` grid stays intact — extra cut points are
    inserted where a leaf's shard boundary falls inside a bucket, splitting
    that bucket in two.  The per-host reduce ranges (``shard_ranges``) are
    derived from the uniform grid only, so a host that has never seen a
    sharded gradient tree (e.g. it only ever skipped) computes the identical
    ranges — the ranges are the wire protocol, the pinned bounds are a local
    zero-copy/quantization alignment property.
    """

    __slots__ = ("shard_cuts", "shard_sig")

    def __init__(self, shapes, dtype, shard_cuts: Sequence[int],
                 shard_sig: tuple, treedef=None,
                 bucket_bytes_: Optional[int] = None):
        super().__init__(shapes, dtype, bucket_bytes_)
        cuts = sorted({int(c) for c in shard_cuts if 0 < int(c) < self.total})
        self.shard_cuts = tuple(cuts)
        self.shard_sig = shard_sig
        if cuts:
            edges = sorted(
                {0, self.total, *cuts,
                 *(k * self.bucket_elems for k in range(1, self.n_buckets))}
            )
            self.bounds = tuple(zip(edges[:-1], edges[1:]))
            self.n_buckets = len(self.bounds)

    def signature(self) -> tuple:
        return super().signature() + (self.shard_cuts, self.shard_sig)


def sharding_signature(shape: Tuple[int, ...], sharding) -> Optional[tuple]:
    """Process-independent identity of one leaf's sharding, or None for
    plain tensors, host arrays and replicated leaves: ``(spec_str,
    per_dim_shard_counts)``, as the JAX package derives it.  ``sharding`` is
    a ``parallel.NamedSharding``, a ``DTensor`` (its placements name the
    sharded dims) or None.  Derived from axis sizes and the spec alone (no
    rank or device ids), so equal meshes and specs give equal signatures
    cohort-wide: the key the Accumulator's sharded layout cache is guarded
    by."""
    if sharding is None:
        return None
    from .parallel.mesh import NamedSharding, sharding_of

    if not isinstance(sharding, NamedSharding):
        named = sharding_of(sharding)
        if named is None:
            raise TypeError(f"sharding_signature: {type(sharding).__name__} is "
                            "neither a NamedSharding nor a DTensor")
        sharding = named
    ss = sharding.shard_shape(tuple(int(d) for d in shape))
    # Counted in the spec's (flax's) order: a conv kernel the port holds in
    # torch's layout reads as the JAX package's leaf.
    counts = sharding.spec_order(tuple(int(d // s) if s else 1 for d, s in zip(shape, ss)))
    if all(c <= 1 for c in counts):
        return None  # fully replicated: indistinguishable from host data
    return (str(sharding.spec), counts)


def shard_ranges(total: int, n: int, align: int = 1
                 ) -> List[Tuple[int, int]]:
    """Partition ``[0, total)`` into ``n`` contiguous near-equal ranges with
    boundaries aligned to multiples of ``align`` (the bucket grid) — the
    per-host ownership map of the sharded hierarchical allreduce.  Pure
    function of ``(total, n, align)``: every cohort member computes the same
    ranges from protocol-level values alone.  Ranges may be empty when
    ``total < n`` after alignment; small payloads fall back to element
    granularity so every host still owns ~1/n of the work."""
    total, n, align = int(total), int(n), max(1, int(align))
    if n < 1:
        raise ValueError("shard_ranges: need n >= 1")
    if align * n > total:
        align = 1  # small payload: alignment would starve trailing hosts
    cuts = [0]
    for i in range(1, n):
        ideal = (i * total) // n
        c = ((ideal + align // 2) // align) * align
        cuts.append(min(total, max(cuts[-1], c)))
    cuts.append(total)
    return list(zip(cuts[:-1], cuts[1:]))


# --------------------------------------------------------------------- pool
# Freelist of flat staging/result buffers keyed by (elements, dtype).  A
# popped buffer is handed out only when the freelist held the LAST reference
# (refcount probe): a buffer still pinned by an in-flight zero-copy send, or
# still visible through result views, fails the probe and is dropped instead
# of recycled — the GC frees it once the external references die.
_POOL_CAP = 16
_pool_lock = threading.Lock()
_pool: Dict[Tuple[int, str, bool], List[np.ndarray]] = {}
# Pinned buffers are numpy views of page-locked torch tensors (their
# ``base`` is the tensor); this map (id -> weakref) tells release() they are
# the pool's own.  ndarrays are unhashable, hence ids, not a WeakSet.
_pinned: Dict[int, "weakref.ref"] = {}


def _is_pinned_lease(arr: np.ndarray) -> bool:
    ref = _pinned.get(id(arr))
    return ref is not None and ref() is arr


def _forget_pinned(ref, key: int) -> None:
    # A weakref callback runs wherever the buffer dies, possibly under
    # _pool_lock: no lock here (single dict operations are atomic).
    if _pinned.get(key) is ref:
        _pinned.pop(key, None)


def lease(total: int, dtype, pinned: bool = False) -> np.ndarray:
    """A flat 1-d buffer of ``total`` elements of ``dtype`` — recycled from
    the pool when an exclusively-held one is available, else fresh.
    ``pinned=True`` backs it with page-locked host memory (for staging CUDA
    leaves: the D2H copies into it are asynchronous); pinned and pageable
    buffers recycle separately.

    Buffers are released back EAGERLY (at round completion) and may still be
    aliased at that point — by a pinned zero-copy send, or by result views
    the user holds; such entries stay in the freelist untouched until their
    external references die (the refcount probe skips them), so reuse is
    opportunistic and never aliases live memory."""
    key = (int(total), np.dtype(dtype).str, bool(pinned))
    with _pool_lock:
        free = _pool.get(key)
        if free:
            for i in range(len(free) - 1, -1, -1):
                arr = free[i]
                # refs: freelist slot + `arr` local + getrefcount's argument
                # == 3 when the pool holds the only reference.
                if sys.getrefcount(arr) == 3:
                    del free[i]
                    return arr
    if not pinned:
        return np.empty(int(total), np.dtype(dtype))
    arr = _pinned_empty(total, torch.from_numpy(np.empty(0, dtype)).dtype).numpy()
    _M_PINNED_LEASES.inc()
    with _pool_lock:
        _pinned[id(arr)] = weakref.ref(arr, lambda r, k=id(arr): _forget_pinned(r, k))
    return arr


def release(arr: Optional[np.ndarray]) -> None:
    """Offer a buffer back to the pool (bounded; excess is dropped).  Views
    are ignored (only base buffers recycle); double releases of one object
    are inert (the extra freelist slot inflates its refcount past the
    exclusivity probe, so it is never handed out twice)."""
    if arr is None or not isinstance(arr, np.ndarray):
        return
    with _pool_lock:
        pinned = _is_pinned_lease(arr)
        if arr.base is not None and not pinned:
            return
        key = (arr.size, arr.dtype.str, pinned)
        free = _pool.setdefault(key, [])
        if len(free) < _POOL_CAP and not any(a is arr for a in free):
            free.append(arr)


# ------------------------------------------------------------- streaming
class Coverage:
    """Merged-interval set over element positions — the streaming stager's
    ledger of which flat ranges are staged.  ``add`` merges; ``covers`` asks
    whether one range is fully inside the covered set.  Pure bookkeeping
    (no locking — callers serialize)."""

    __slots__ = ("_iv",)

    def __init__(self):
        self._iv: List[Tuple[int, int]] = []

    def add(self, start: int, stop: int) -> None:
        if stop <= start:
            return
        iv = self._iv
        out: List[Tuple[int, int]] = []
        s, e = int(start), int(stop)
        for a, b in iv:
            if b < s or a > e:
                out.append((a, b))
            else:
                s, e = min(s, a), max(e, b)
        out.append((s, e))
        out.sort()
        self._iv = out

    def covers(self, start: int, stop: int) -> bool:
        if stop <= start:
            return True
        for a, b in self._iv:
            if a <= start and stop <= b:
                return True
        return False


class GradientStream:
    """Incrementally delivered gradient pytree — the producer/consumer
    handoff of the streaming gradient pipeline (docs/DESIGN.md §6e).

    The producer (``parallel.make_train_step(overlap_grads=True)``, whose
    backward hooks deliver contiguous runs of leaves as they complete, or
    any caller that knows leaf readiness order) constructs the stream with
    the FULL tree structure
    up front — ``treedef`` (opaque here; the Accumulator unflattens with
    it), per-leaf ``shapes``/``dtypes``, and optionally the flat list of
    per-leaf device ``shardings`` (required for streaming onto the sharded
    reduce plane, whose layout is signature-guarded) — then calls
    :meth:`deliver` once per contiguous leaf group, in expected readiness
    order (backward produces LATE layers first, so the tail of the flatten
    order usually arrives before the head).  ``deliver`` starts a
    non-blocking copy of every CUDA leaf of the group into pinned host
    staging and records one CUDA event for the group before handing it to
    the consumer, so D2H transfer for the whole group overlaps the
    consumer's bucket fills; :meth:`next_chunk` waits on that event and
    hands out host views.

    The consumer (``Accumulator.reduce_gradients``) blocks on
    :meth:`next_chunk` and stages/launches wire buckets as ranges complete.
    ``on_bucket`` (settable attribute) is the per-bucket ready callback
    surfaced to the caller: invoked as ``on_bucket(start, stop)`` (element
    range of the staged flat buffer) each time a bucket finishes staging —
    exceptions are swallowed (telemetry-grade hook, never round-fatal).

    Thread-safe: deliver/fail from any thread; one consumer.
    """

    __slots__ = (
        "treedef", "shapes", "dtypes", "shardings", "on_bucket",
        "_cond", "_chunks", "_delivered", "_err", "n_leaves",
    )

    def __init__(self, treedef, shapes: Sequence[Tuple[int, ...]],
                 dtypes: Sequence, shardings: Optional[Sequence] = None,
                 on_bucket=None):
        self.treedef = treedef
        self.shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        self.dtypes = tuple(np_dtype(d) for d in dtypes)
        if len(self.shapes) != len(self.dtypes):
            raise ValueError("GradientStream: shapes/dtypes length mismatch")
        if shardings is not None and len(shardings) != len(self.shapes):
            raise ValueError("GradientStream: shardings length mismatch")
        self.shardings = list(shardings) if shardings is not None else None
        self.on_bucket = on_bucket
        self.n_leaves = len(self.shapes)
        self._cond = threading.Condition()
        # queued, not yet consumed: (lo, leaves, None or (D2H event, the
        # indices of the leaves staged from the card))
        self._chunks: List[Tuple[int, list, Optional[tuple]]] = []
        self._delivered = [False] * self.n_leaves
        self._err: Optional[BaseException] = None

    def deliver(self, lo: int, leaves: Sequence) -> None:
        """Hand the consumer leaves ``lo .. lo+len(leaves)`` (flatten-order
        indices).  Each leaf index must be delivered exactly once.  Every
        CUDA leaf starts its copy into pinned host staging (:func:`stage`),
        and the group's one event is kept with the chunk."""
        leaves = list(leaves)
        lo = int(lo)
        if lo < 0 or lo + len(leaves) > self.n_leaves:
            raise ValueError(
                f"GradientStream.deliver: leaves [{lo}, {lo + len(leaves)}) "
                f"outside [0, {self.n_leaves})"
            )
        staged, event = stage(leaves)
        if event is not None:  # hand out the staged leaves as numpy views
            event = (event, [i for i, (a, b) in enumerate(zip(leaves, staged))
                             if a is not b])
        with self._cond:
            for i in range(lo, lo + len(leaves)):
                if self._delivered[i]:
                    raise ValueError(
                        f"GradientStream.deliver: leaf {i} delivered twice"
                    )
                self._delivered[i] = True
            self._chunks.append((lo, staged, event))
            self._cond.notify_all()

    def fail(self, err: BaseException) -> None:
        """Producer died (e.g. the backward jit raised): wake the consumer
        with the error instead of wedging it on next_chunk."""
        with self._cond:
            self._err = err
            self._cond.notify_all()

    @property
    def complete(self) -> bool:
        with self._cond:
            return all(self._delivered)

    def next_chunk(self, timeout: Optional[float] = None):
        """Blocking: the next delivered ``(lo, leaves)`` group, or ``None``
        once every leaf was consumed.  A group that held CUDA leaves comes
        back after its D2H event, with those leaves as host numpy views of
        their pinned staging.  Raises the producer's failure, or
        ``TimeoutError`` when nothing arrives in ``timeout`` seconds."""
        with self._cond:
            while True:
                if self._err is not None:
                    raise self._err
                if self._chunks:
                    lo, leaves, event = self._chunks.pop(0)
                    break
                if all(self._delivered):
                    return None
                if not self._cond.wait(timeout):
                    raise TimeoutError(
                        "GradientStream: producer delivered no leaves within "
                        f"{timeout}s ({sum(self._delivered)}/{self.n_leaves} "
                        "delivered)"
                    )
        if event is None:
            return lo, leaves
        event, staged = event
        event.synchronize()  # outside the lock: producers keep delivering
        for i in staged:
            leaves[i] = leaves[i].numpy()
        return lo, leaves


# ------------------------------------------------------------------- EF-q8
def ef_quantize_flat(flat: np.ndarray, residual: Optional[np.ndarray],
                     bounds: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Error-feedback int8 quantization, once, on the flat buffer.

    For each bucket ``(s, e)``: fold the carried residual in, quantize with
    one absmax scale per bucket, write the dequantized GRID values back into
    ``flat`` in place, and store the new rounding error in ``residual``.
    Handing the grid values (exact multiples of the bucket scale) to the
    wire codec means the first per-hop q8 encode reproduces the identical
    int8 payload — quantization noise enters exactly once, at the source,
    where the EF residual lives (the EF-SGD contract; hops re-round partial
    sums without residuals, same as the legacy per-leaf tree path).

    A non-finite bucket (loss-scale overflow) contributes zero this round
    and resets its residual slice, so one bad step can't poison error
    feedback forever.  Returns the (possibly freshly allocated) residual.
    """
    if residual is None or residual.shape != flat.shape:
        residual = np.zeros_like(flat)
    for s, e in bounds:
        if e <= s:
            continue
        f = flat[s:e]
        r = residual[s:e]
        np.add(f, r, out=f)
        amax = float(np.max(np.abs(f)))
        if amax == 0.0 or not np.isfinite(amax):
            if amax != 0.0:
                utils.log_error("buckets: non-finite gradient bucket; q8 zeroed")
            f[:] = 0.0
            r[:] = 0.0
            continue
        scale = amax / 127.0
        q = np.clip(np.rint(f / scale), -127, 127)
        np.multiply(q, np.float32(scale), out=q)
        np.subtract(f, q, out=r)
        f[:] = q
    return residual
