"""Elastic peer groups and binary-tree allreduce over RPC.

Counterpart of the reference's ``GroupService``/``AllReduceService``/``Group``
(``src/group.{h,cc}``): clients ping the broker, receive membership epochs
(``sync_id``), and run allreduce over a binary tree laid out by member index —
leaf→root reduction, then the result is shared back down the same tree.
Out-of-order contributions (a peer that learned the new epoch before us) are
parked and consumed when the local operation starts (reference retry queue,
``src/group.h:662-679``).  A membership change cancels every in-flight
reduction with a "group changed" error — elasticity comes from the epoch key,
not from any attempt to patch a running reduction.

The port keeps the JAX package's wire protocol and its host arithmetic:
every combine is numpy, exactly as there, so a cohort that mixes JAX and
port peers reduces bit-identically by construction.  Torch leaves are read
where numpy cannot serve: shapes and dtypes straight off the tensor, CUDA
leaves staged to the host through pinned buffers with one event per fill
(``buckets``), and the bf16 wire codec through ``torch.bfloat16`` (the GPU
machine has no ``ml_dtypes``), whose round-to-nearest-even equals ml_dtypes'
bit for bit.  The flat-bucket and ring paths return host (numpy) arrays, as
the JAX Group does; copying a result back to the card is the caller's job.
"""

from __future__ import annotations

import copy
import os
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import buckets, telemetry, utils
from .telemetry.recovery import observe_phase
from .utils import nest
from .rpc import Future, Rpc, RpcError
from .rpc.core import adopt_current_frame

_REG = telemetry.get_registry()
_M_FAILOVERS = _REG.counter(
    "group_broker_failovers_total",
    "Broker failover scans this peer started (ping silence or standby reply)",
)
_M_STALE_PUSHES = _REG.counter(
    "group_stale_pushes_total",
    "Epoch pushes rejected by the peer-side generation fence (zombie ex-primary)",
)

def _extremum(np_fn, torch_fn, py_fn):
    """Leaf-wise min/max.  A torch leaf on either side keeps the result in
    torch on that leaf's device (the other operand is read as a tensor
    there), as ``+`` and ``*`` already do; numpy and python leaves take the
    JAX package's numpy/builtin path unchanged."""

    def f(a, b):
        t = a if isinstance(a, torch.Tensor) else b if isinstance(b, torch.Tensor) else None
        if t is not None:
            return torch_fn(torch.as_tensor(a, device=t.device),
                            torch.as_tensor(b, device=t.device))
        return np_fn(a, b) if _is_arr(a) else py_fn(a, b)

    return f


_OPS: Dict[str, Callable] = {
    "sum": lambda a, b: a + b,
    "product": lambda a, b: a * b,
    "min": _extremum(np.minimum, torch.minimum, min),
    "max": _extremum(np.maximum, torch.maximum, max),
}


def _is_arr(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64))


def _ring_threshold() -> int:
    """Payload size (bytes) above which ``all_reduce`` auto-selects the
    chunked ring path.  Read per call so tests can force it; MUST be set
    identically on every peer (path choice is part of the op's protocol)."""
    return int(os.environ.get("MOOLIB_RING_THRESHOLD", 1 << 20))


def _bucket_threshold() -> int:
    """Payload size (bytes) above which a tree ``all_reduce`` auto-selects
    the flat-bucket path (zero-copy serialization + in-place combine, one
    sub-op per bucket).  Like the ring threshold it is wire protocol: set it
    identically on every peer."""
    return int(os.environ.get("MOOLIB_BUCKET_THRESHOLD", 1 << 20))


def _own(value):
    """Deep-copy any array leaf that does not own writable memory.

    Inline RPC handlers (``__group_reduce``/``__group_ring``/``__group_share``)
    receive arrays as ZERO-COPY views over the transport's receive buffer,
    valid only for the duration of the call — anything parked, queued, or
    otherwise retained past the handler return must take ownership first.
    Copying non-owning leaves (rather than tracking provenance) also covers
    values the caller handed us as views; the copy is exactly the one the
    old copying deserializer used to make, so retention paths cost the same
    as before while the consume-immediately paths become zero-copy."""

    def f(x):
        if isinstance(x, np.ndarray):
            if not x.flags.owndata or not x.flags.writeable:
                return np.array(x)
            return x
        if x is None or isinstance(
            x, (bool, int, float, complex, str, bytes, np.generic)
        ):
            return x
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                return x  # on the card: never a view of a receive buffer
            # bf16 leaves decode into a fresh bytearray they own; a view of
            # another tensor's storage does not own it.
            owns = (not x._is_view()
                    and x.untyped_storage().nbytes() == x.numel() * x.element_size())
            return x if owns else x.clone()
        # Opaque leaf (custom-op payloads): nest.map can't see inside it, but
        # it may embed borrowed receive-buffer views — deepcopy owns them.
        return copy.deepcopy(x)

    return nest.map(f, value)


def _ring_codec(wire):
    """(encode, decode, acc_cast) for per-hop ring wire compression.

    ``encode`` maps an accumulation-dtype chunk to its wire form before every
    hop; ``decode`` maps a wire object back to the accumulation dtype;
    ``acc_cast`` lifts a local contribution into the accumulation dtype.
    With a wire dtype set, partial sums accumulate in float32 and are
    re-rounded once per hop — the same contract as the tree's ``finalize``
    (see ``accumulator._wire_finalize``).  ``wire="q8"`` is symmetric int8
    with one scale per chunk (the per-tensor scheme of the accumulator's
    q8 path, applied at chunk granularity).

    ``wire="bfloat16"`` encodes through ``torch.bfloat16`` (round to
    nearest even, the bits ml_dtypes gives) and travels under the
    serializer's ``"bfloat16"`` tag; ``decode`` takes either a received
    ``torch.bfloat16`` tensor or a numpy bfloat16 array (a JAX peer's
    native codec, where ml_dtypes is loaded) and widens it exactly.
    """
    if wire is None:
        ident = lambda a: a  # noqa: E731
        return ident, ident, ident
    if wire == "q8":

        def enc(a):
            a = np.asarray(a, np.float32)
            amax = float(np.max(np.abs(a))) if a.size else 0.0
            if amax == 0.0:
                return {"q8": np.zeros(a.shape, np.int8), "s": 0.0}
            scale = amax / 127.0
            return {"q8": np.round(a / scale).astype(np.int8), "s": scale}

        def dec(obj):
            return obj["q8"].astype(np.float32) * obj["s"]

        return enc, dec, lambda a: np.asarray(a, np.float32)
    if wire == "bfloat16":
        return _bf16_encode, _bf16_decode, lambda a: np.asarray(a, np.float32)
    wd = np.dtype(wire)
    return (
        lambda a: np.asarray(a).astype(wd),
        lambda a: np.asarray(a).astype(np.float32),
        lambda a: np.asarray(a, np.float32),
    )


def _bf16_encode(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.bfloat16)
    a = np.ascontiguousarray(a, np.float32)
    if not a.flags.writeable:  # a borrowed view: torch.from_numpy wants ownership
        a = a.copy()
    return torch.from_numpy(a).to(torch.bfloat16)


def _bf16_decode(b) -> np.ndarray:
    if isinstance(b, torch.Tensor):
        return b.float().numpy()
    return np.asarray(b).astype(np.float32)


def _ring_nbytes(value) -> int:
    """Payload bytes if ring-eligible (all-array pytree, one dtype numpy
    has), else -1."""
    leaves = list(nest.flatten(value))
    if not leaves or not all(_is_arr(l) for l in leaves):
        return -1
    try:
        dtypes = {buckets.np_dtype(l.dtype) for l in leaves}
    except TypeError:  # a torch dtype numpy lacks (bfloat16): tree only
        return -1
    if len(dtypes) != 1:
        return -1
    itemsize = dtypes.pop().itemsize
    return sum(_numel(l) for l in leaves) * itemsize


def _host_leaves(value):
    """(leaves, set of numpy dtypes) of a ring/bucketed payload: CPU tensors
    as numpy views, CUDA tensors as they are (only shape and dtype read)."""
    try:
        leaves = [buckets.host_view(l) for l in nest.flatten(value)]
        dtypes = {buckets.np_dtype(l.dtype) for l in leaves}
    except TypeError as e:
        raise RpcError(f"allreduce leaf has no numpy dtype: {e}") from e
    return leaves, dtypes


def _flat_host(leaves, dtype) -> np.ndarray:
    """The payload as one flat host array.  CUDA leaves are staged into a
    pinned buffer (one non-blocking copy each, one event, waited here)."""
    if any(buckets.on_card(l) for l in leaves):
        layout = buckets.BucketLayout([tuple(l.shape) for l in leaves], dtype)
        flat = buckets.lease(layout.total, dtype, pinned=True)
        layout.fill(flat, leaves).synchronize()
        return flat
    return np.concatenate([l.ravel() for l in leaves]) if len(leaves) > 1 \
        else leaves[0].ravel()


def _host_tree(value):
    """The legacy tree's local value with torch leaves on the host: CPU
    tensors as numpy views (bfloat16 ones, which numpy lacks, stay torch),
    CUDA tensors staged into pinned host memory with one event for the
    whole tree.  Anything else passes unchanged, as in the JAX package."""
    leaves = list(nest.flatten(value))
    if not any(isinstance(l, torch.Tensor) for l in leaves):
        return value
    staged, event = buckets.stage(leaves)
    if event is not None:
        event.synchronize()
    return nest.pack_as(value, [
        l.detach().numpy() if isinstance(l, torch.Tensor) and l.dtype != torch.bfloat16
        else l for l in staged])


def _payload_nbytes(value) -> int:
    """Rough array/bytes payload size of a share result — cheap gate for
    the memfd-multicast star (small results must stay on tree forwarding:
    below the memfd threshold the star degrades to O(n) root unicasts)."""
    total = 0
    for leaf in nest.flatten(value):
        if isinstance(leaf, np.ndarray):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, (bytes, bytearray, memoryview)):
            total += len(leaf)
    return total


def _memfd_min() -> int:
    from .rpc.core import _MEMFD_MIN

    return _MEMFD_MIN


def _resolve_op(op) -> Callable:
    """Builtin string ops reduce leaf-wise over pytrees; a user callable is
    applied to the *whole* contributed values (so lexicographic tuple compares
    and struct-valued reductions like the Accumulator's work — reference
    ``ReduceVariant`` custom py::object ops, ``src/group.h:230-262``)."""
    if isinstance(op, str):
        leaf_op = _OPS[op]
        return lambda a, b: nest.map_many(leaf_op, a, b)
    return op


class AllReduce(Future):
    """A future result of an AllReduce operation (same API as reference)."""


class _Completer:
    """One lazily-started daemon thread running bucketed-round completions.

    Completion must leave the transport IO thread (inline handlers run
    there; user done-callbacks are arbitrary code) but must not queue
    behind the Rpc executor's handler dispatch either — a round's
    completion gates the caller's next round, and executor queueing under
    load costs milliseconds per op on that critical path.
    """

    def __init__(self):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def __call__(self, fn, *args) -> None:
        if self._thread is None:
            with self._lock:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="moolib-group-complete",
                        daemon=True)
                    self._thread.start()
        self._q.put((fn, args))

    def _run(self) -> None:
        while True:
            fn, args = self._q.get()
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 - callback bugs must not kill the thread
                utils.log_error(
                    "allreduce completion callback failed:\n%s",
                    traceback.format_exc())


class _Op:
    __slots__ = (
        "key", "value", "op", "finalize", "future", "contribs", "sent_up",
        "started_at", "eager", "folded", "consume",
    )

    def __init__(self, key, value, op, finalize, future, eager=False, consume=None):
        self.key = key
        self.value = value
        self.op = op
        self.finalize = finalize
        self.future = future
        self.contribs: List[Any] = []
        self.sent_up = False
        self.started_at = time.monotonic()
        # Eager ops (commutative + associative, e.g. the flat-bucket sum)
        # fold each child contribution the moment it arrives — while the
        # borrowed receive buffer is still valid — instead of parking it in
        # ``contribs``.  That is what turns materialize-then-copy into one
        # in-place ``np.add(acc, view, out=acc)`` pass.
        self.eager = eager
        self.folded = 0
        # Optional share-path hook: consume(result) takes the (borrowed)
        # shared-down result and returns an OWNED value (the bucketed path
        # copies straight into its preallocated result buffer).  None means
        # the generic _own() deep copy.
        self.consume = consume


class _RingOp:
    """State of one chunked ring allreduce (reduce-scatter + all-gather).

    Bandwidth-optimal counterpart of the reference's benchmark-only chunked
    ring (``test/test_multinode_allreduce.cc:16-150``), made a first-class
    epoch-keyed Group op: each of the N members sends ``2*(N-1)/N`` of the
    payload instead of the tree's full payload per hop (and the tree root's
    ``2x`` full payloads), so serialization cost is spread evenly across the
    cohort and chunks pipeline across ring steps.

    Protocol (rank r, ring next = (r+1) % n, chunks split near-equally):
      - reduce-scatter step s in [0, n-2]: send chunk ``(r - s) % n``
        (local contribution at s=0, accumulated partial after), receive
        chunk ``(r - 1 - s) % n`` and fold in the local contribution.
        After the last step, rank r owns the fully reduced chunk
        ``(r + 1) % n`` plus the fully combined ``meta``.
      - all-gather step s in [0, n-2]: send the completed chunk
        ``(r + 1 - s) % n``; receive ``(r - s) % n`` and forward its wire
        bytes unchanged (every rank decodes identical bytes, so wire
        compression stays bit-consistent cohort-wide).

    ``local[c] is None`` marks a zero (skip) contribution: markers forward
    without materializing zero payloads, so an all-skip round costs ~nothing
    on the wire (sum only).  Out-of-order frames park in ``pending`` keyed by
    (phase, step); steps are processed strictly in order per phase.
    """

    __slots__ = (
        "key", "future", "started_at", "members", "rank", "n", "local",
        "chunk_sizes", "dtype", "template", "leaf_shapes", "has_value",
        "enc", "dec", "acc_cast", "leaf_op", "op_name", "meta", "has_meta", "meta_op",
        "meta_total", "rs_next", "ag_next", "pending", "final", "done_chunks",
        "pumping", "repump", "sent_initial",
    )

    def __init__(self, key, value, op_name, future, members, rank, wire,
                 meta, meta_op, template, chunk_align=None):
        self.key = key
        self.future = future
        self.started_at = time.monotonic()
        self.members = members
        self.rank = rank
        self.n = len(members)
        self.enc, self.dec, self.acc_cast = _ring_codec(wire)
        self.leaf_op = _OPS[op_name]
        self.op_name = op_name
        self.meta = meta
        self.has_meta = meta is not None
        self.meta_op = meta_op
        self.meta_total = None
        self.rs_next = 0
        self.ag_next = 0
        self.pending: Dict[Tuple[str, int], Tuple] = {}
        self.final: List[Any] = [None] * self.n
        self.done_chunks = 0
        self.pumping = False
        self.repump = False
        self.sent_initial = False

        self.has_value = value is not None
        shape_src = value if value is not None else template
        if shape_src is None:
            raise RpcError("ring allreduce with value=None requires template=")
        leaves, dtypes = _host_leaves(shape_src)
        if not leaves:
            raise RpcError("ring allreduce needs at least one array leaf")
        if len(dtypes) != 1:
            raise RpcError(f"ring allreduce needs one uniform dtype, got {dtypes}")
        self.dtype = dtypes.pop()
        self.template = shape_src
        self.leaf_shapes = [tuple(l.shape) for l in leaves]
        total = sum(_numel(l) for l in leaves)
        if chunk_align and int(chunk_align) > 0 and total > 0:
            # Bucket-aligned chunking: boundaries fall on multiples of
            # ``chunk_align`` elements (the accumulator passes its flat
            # bucket size), so ring chunks coincide with bucket slices of
            # the flat payload — contiguous zero-copy views end to end.
            # Same value required on every peer (boundaries are protocol).
            # Clamp to the even split's granularity for small payloads
            # (total < n aligned units): full-size alignment would leave
            # peers with empty chunks and pile the work on the rest.  The
            # clamp is a pure function of (total, n, align) so every peer
            # still computes identical boundaries.
            align = min(int(chunk_align), -(-total // self.n))
            units = -(-total // align)
            bu, rem_u = divmod(units, self.n)
            sizes, off = [], 0
            for c in range(self.n):
                u = bu + (1 if c < rem_u else 0)
                sz = min(u * align, total - off)
                sizes.append(sz)
                off += sz
            self.chunk_sizes = sizes
        else:
            base, rem = divmod(total, self.n)
            self.chunk_sizes = [base + (1 if c < rem else 0) for c in range(self.n)]
        if value is not None:
            flat = _flat_host(leaves, self.dtype)
            self.local = []
            off = 0
            for sz in self.chunk_sizes:
                self.local.append(self.acc_cast(flat[off:off + sz]))
                off += sz
        else:
            self.local = [None] * self.n

    # -- pure state transitions (call under the group lock) -----------------
    def drain(self):
        """Process every ready pending frame; return deferred actions
        (sends / completion) for the caller to perform outside the lock."""
        actions: List[Tuple] = []
        if not self.sent_initial:
            self.sent_initial = True
            c = self.rank
            data = None if self.local[c] is None else self.enc(self.local[c])
            actions.append(("send", "rs", 0, c, data, self.meta))
        progressed = True
        while progressed:
            progressed = False
            if self.rs_next <= self.n - 2 and ("rs", self.rs_next) in self.pending:
                actions.extend(self._rs_step(*self.pending.pop(("rs", self.rs_next))))
                progressed = True
            if self.ag_next <= self.n - 2 and ("ag", self.ag_next) in self.pending:
                actions.extend(self._ag_step(*self.pending.pop(("ag", self.ag_next))))
                progressed = True
        if self.done_chunks == self.n:
            actions.append(("done",))
        return actions

    def _combine(self, incoming, c):
        mine = self.local[c]
        if incoming is None:
            return mine
        if mine is None:
            return incoming
        if (
            self.op_name == "sum"
            and isinstance(incoming, np.ndarray)
            and incoming.flags.writeable
            and incoming.dtype == np.asarray(mine).dtype
        ):
            # The decoded chunk is ours alone — accumulate in place instead
            # of allocating a fresh array every hop.
            np.add(incoming, mine, out=incoming)
            return incoming
        return self.leaf_op(incoming, mine)

    def _rs_step(self, chunk_idx, data, meta_in):
        s = self.rs_next
        self.rs_next += 1
        c = (self.rank - 1 - s) % self.n
        if chunk_idx != c:
            raise RpcError(
                f"ring protocol error: got chunk {chunk_idx} at rs step {s}, "
                f"expected {c} (peers disagree on membership?)")
        incoming = None if data is None else self.dec(data)
        if incoming is not None and incoming.size != self.chunk_sizes[c]:
            raise RpcError(
                f"ring chunk size mismatch ({incoming.size} != "
                f"{self.chunk_sizes[c]}): peers contributed different shapes")
        combined = self._combine(incoming, c)
        meta_acc = meta_in
        if self.has_meta:
            meta_acc = self.meta_op(meta_in, self.meta)
        if s == self.n - 2:
            # Chunk c is fully reduced; this rank owns it. Round-trip the
            # wire encoding so every rank decodes identical bytes.
            encoded = None if combined is None else self.enc(combined)
            self.final[c] = None if encoded is None else self.dec(encoded)
            self.meta_total = meta_acc
            self.done_chunks += 1
            return [("send", "ag", 0, c, encoded, meta_acc)]
        encoded = None if combined is None else self.enc(combined)
        return [("send", "rs", s + 1, c, encoded, meta_acc)]

    def _ag_step(self, chunk_idx, data, meta_total):
        s = self.ag_next
        self.ag_next += 1
        c = (self.rank - s) % self.n
        if chunk_idx != c:
            raise RpcError(
                f"ring protocol error: got chunk {chunk_idx} at ag step {s}, "
                f"expected {c}")
        self.final[c] = None if data is None else self.dec(data)
        if self.meta_total is None:
            self.meta_total = meta_total
        self.done_chunks += 1
        if s < self.n - 2:
            return [("send", "ag", s + 1, c, data, meta_total)]
        return []

    def assemble(self):
        """Reassemble the reduced pytree from final chunks (outside lock)."""
        if all(f is None for f in self.final):
            value = None
        else:
            parts = []
            for c, f in enumerate(self.final):
                if f is None:
                    parts.append(np.zeros(self.chunk_sizes[c], self.dtype))
                else:
                    parts.append(np.asarray(f).astype(self.dtype, copy=False))
            flat = np.concatenate(parts) if len(parts) > 1 else parts[0]
            leaves, off = [], 0
            for shape in self.leaf_shapes:
                size = int(np.prod(shape, dtype=np.int64)) if shape else 1
                leaves.append(flat[off:off + size].reshape(shape))
                off += size
            value = nest.pack_as(self.template, leaves)
        if self.has_meta:
            return value, self.meta_total
        return value


class _BucketedReduce:
    """Parent state of one flat-bucket tree allreduce.

    The payload is flattened once into fixed-size contiguous buckets
    (``buckets.BucketLayout``); each bucket rides the binary tree as its own
    EAGER sub-op, so buckets pipeline independently through the engine
    (serialization of bucket k overlaps the wire/combine of bucket k-1) and
    every hop folds contributions **in place** off the borrowed receive
    buffer (``np.add(acc, view, out=acc)``) instead of materialize-then-copy.
    Buffers come from the refcount-guarded pool in ``buckets``:

    - ``stage_flat``: the local contribution, staged once (multi-leaf
      payloads, or single-leaf ones handed over with ``owned=True``); folds
      accumulate directly into it.
    - ``acc_flat``: lazily leased when the local contribution is a borrowed
      user array (or a skip) — the first fold fuses the legacy materialize
      copy with the first add.
    - ``result_flat``: lazily leased on the share-down path; the consume
      hook copies each bucket result straight off the receive buffer into
      its slice (one pass, no intermediate array).

    Wire compression reuses the ring's per-chunk codec (``_ring_codec``):
    contributions and partial sums travel encoded per hop, accumulate in
    f32, and the root's final encode is what every peer decodes —
    bit-consistent cohort-wide, same contract as the tree's old finalize.
    """

    __slots__ = (
        "template", "layout", "acc_dtype", "wire", "enc", "dec", "meta_op",
        "has_meta", "owned", "defer", "flat_view", "stage_flat", "stage_owned",
        "acc_flat", "result_flat", "results", "meta_total", "pending", "done",
        "future", "key", "started_at", "cleanup", "_lock",
    )

    def __init__(self, value, meta, meta_op, wire, template, owned, defer):
        self.wire = wire
        self.meta_op = meta_op
        self.has_meta = meta is not None
        self.enc, self.dec, _ = _ring_codec(wire)
        shape_src = value if value is not None else template
        if shape_src is None:
            raise RpcError("bucketed allreduce with value=None requires template=")
        leaves, dtypes = _host_leaves(shape_src)
        if not leaves:
            raise RpcError("bucketed allreduce needs at least one array leaf")
        if len(dtypes) != 1:
            raise RpcError(f"bucketed allreduce needs one uniform dtype, got {dtypes}")
        dtype = dtypes.pop()
        self.template = shape_src
        self.layout = buckets.BucketLayout([tuple(l.shape) for l in leaves], dtype)
        self.acc_dtype = np.dtype(np.float32) if wire is not None else dtype
        self.owned = owned
        self.defer = defer  # run fn(*args) off the transport IO thread
        self.stage_flat = None
        self.stage_owned = False  # True: recycle stage_flat at completion
        self.acc_flat = None
        self.result_flat = None
        self.flat_view = None
        if value is not None:
            if len(leaves) == 1 and isinstance(leaves[0], np.ndarray) and (
                leaves[0].flags.c_contiguous
            ) and (owned or leaves[0].dtype == self.acc_dtype):
                # Zero-copy staging: the contribution IS the caller's array.
                # owned=True additionally lets folds accumulate into it.
                lf = leaves[0]
                self.flat_view = lf if lf.ndim == 1 else lf.reshape(-1)
                if owned and lf.dtype == self.acc_dtype:
                    self.stage_flat = self.flat_view
                    self.stage_owned = True
            else:
                # CUDA leaves stage into pinned memory; the wire reads the
                # buffer only after the fill's event.
                self.stage_flat = buckets.lease(
                    self.layout.total, self.acc_dtype,
                    pinned=any(buckets.on_card(l) for l in leaves))
                event = self.layout.fill(self.stage_flat, leaves)
                if event is not None:
                    event.synchronize()
                self.flat_view = self.stage_flat
                self.stage_owned = True
        n = self.layout.n_buckets
        self.results: List[Any] = [None] * n
        self.meta_total = None
        self.pending = n
        self.done = False
        self.future: Optional[AllReduce] = None
        # Registered in Group._ops under the PARENT key as a mismatch
        # sentinel (a legacy tree frame arriving there means the cohort
        # disagrees on the path) — key/started_at let the timeout sweep
        # treat it like any other op.
        self.key = None
        self.started_at = time.monotonic()
        # Set by the group: deregisters the sentinel when the round ends
        # from within (the timeout sweep / epoch change remove it
        # themselves).  Not a future done-callback on purpose — those mark
        # the future as having user callbacks, which would force every
        # completion through the completer-thread hop.
        self.cleanup: Optional[Callable] = None
        self._lock = threading.Lock()

    def attach(self, future: AllReduce) -> None:
        self.future = future

    def _complete(self, fn, *args) -> None:
        """Run a completion step: deferred to the completer thread when the
        round future has user done-callbacks (arbitrary code must not run
        on the transport IO thread), inline otherwise — completing a
        callback-less future is just an event-set, and a thread hop costs
        a full scheduler quantum on small boxes.  A callback registered in
        the instant between the check and the set still runs safely: a
        done future runs it on the adder's own thread."""
        if self.future is not None and self.future._callbacks:
            self.defer(fn, *args)
        else:
            fn(*args)

    # -- per-bucket hooks (run under the GROUP lock via _Op machinery) ------
    def _acc_slice(self, k):
        s, e = self.layout.bounds[k]
        if self.stage_flat is not None:
            return self.stage_flat[s:e]
        if self.acc_flat is None:
            self.acc_flat = buckets.lease(self.layout.total, self.acc_dtype)
        return self.acc_flat[s:e]

    def _result_slice(self, k):
        s, e = self.layout.bounds[k]
        if self.result_flat is None:
            self.result_flat = buckets.lease(self.layout.total, self.acc_dtype)
        return self.result_flat[s:e]

    def _decode_into(self, dst, b):
        """dst[:] = decode(b) in ONE pass (no intermediate array for the
        common uncompressed and q8 cases)."""
        if self.wire is None:
            np.copyto(dst, b)
        elif self.wire == "q8":
            np.multiply(b["q8"], np.float32(b["s"]), out=dst)
        else:
            np.copyto(dst, self.dec(b), casting="unsafe")

    def _add_into(self, dst, b):
        """dst += decode(b) in place."""
        if self.wire is None:
            np.add(dst, b, out=dst)
        elif self.wire == "q8":
            np.add(dst, b["q8"] * np.float32(b["s"]), out=dst)
        else:
            np.add(dst, self.dec(b), out=dst)

    def _fold(self, k, total, c):
        m = c.get("m")
        if m is not None:
            total["m"] = m if total.get("m") is None else self.meta_op(total["m"], m)
        b = c.get("b")
        if b is None:
            return total
        tb = total.get("b")
        acc = self._acc_slice(k)
        if tb is None:
            # Local skip: own the first incoming straight into the bucket.
            self._decode_into(acc, b)
            total["b"] = acc
        elif tb is acc or np.may_share_memory(tb, acc):
            self._add_into(tb, b)
        else:
            # First fold over a borrowed local view: fuse the copy the
            # legacy receive path used to make with the first add.
            if tb.dtype != self.acc_dtype:
                tb = np.asarray(tb, self.acc_dtype)
            if self.wire is None:
                np.add(tb, b, out=acc)
            elif self.wire == "q8":
                np.add(tb, b["q8"] * np.float32(b["s"]), out=acc)
            else:
                np.add(tb, self.dec(b), out=acc)
            total["b"] = acc
        return total

    def _fin(self, p):
        """Per-hop wire encode of a bucket payload (identity without wire)."""
        b = p.get("b")
        if b is None or self.wire is None:
            return p
        if isinstance(b, dict):
            return p  # already encoded (defensive; folds keep acc form)
        out = dict(p)
        out["b"] = self.enc(b)
        return out

    def _consume(self, k, val):
        """Share-path hook: copy the borrowed result straight into the
        preallocated result slice (one pass off the receive buffer).

        Returns ``(owned, forward)``: the owned decoded value this peer
        keeps, and the payload to forward down the tree.  Uncompressed they
        are the same object (slice views — the forward serializes
        zero-copy); under wire compression the forward keeps the ENCODED
        bytes (owned copy) so every peer in the subtree decodes identical
        bytes — the tree-wide bit-consistency contract."""
        b = val.get("b")
        m = val.get("m")
        if b is None:
            out = {"b": None, "m": m}
            return out, out
        if (
            self.owned
            and self.wire is None
            and self.layout.n_buckets == 1
            and self.result_flat is None
            and isinstance(b, np.ndarray)
            and b.size == self.layout.total
        ):
            # Zero-copy terminus: adopt the memfd mapping the share arrived
            # in — the result stays in the shared pages (read-only) instead
            # of being copied out.  Single-bucket only: multi-bucket results
            # must land contiguously in one flat.  Gated on owned=True: a
            # read-only result view is part of that engine-style contract,
            # while plain all_reduce callers keep writable results.
            adopted = adopt_current_frame()
            if adopted is not None:
                base = adopted.__array_interface__["data"][0]
                off = b.__array_interface__["data"][0] - base
                if 0 <= off and off + b.nbytes <= adopted.nbytes:
                    view = adopted[off:off + b.nbytes].view(self.acc_dtype)
                    self.result_flat = view
                    out = {"b": view, "m": m}
                    return out, out
        dst = self._result_slice(k)
        self._decode_into(dst, b)
        out = {"b": dst, "m": m}
        if self.wire is None:
            return out, out
        return out, {"b": _own(b), "m": m}

    # -- assembly ----------------------------------------------------------
    def _settled(self, b) -> bool:
        """Is this bucket result already sitting in one of our flats?"""
        if not isinstance(b, np.ndarray):
            return False
        for f in (self.stage_flat, self.acc_flat, self.result_flat):
            if f is not None and np.may_share_memory(b, f):
                return True
        return False

    def _child_done(self, k, fut):
        err = fut.exception()
        with self._lock:
            if self.done:
                return
            if err is None:
                r = fut.result(0)
                b = r.get("b")
                if b is not None and not self._settled(b):
                    # Root result under wire compression arrives encoded
                    # (the finalized form every peer decodes) — decode into
                    # the result buffer for bit-consistency with the cohort.
                    dst = self._result_slice(k)
                    self._decode_into(dst, b)
                    b = dst
                self.results[k] = (True, b)
                if k == 0:
                    self.meta_total = r.get("m")
                self.pending -= 1
                if self.pending > 0:
                    return
            self.done = True
        if err is not None:
            self._recycle()
            self._complete(self.future.set_exception, err)
            return

        def _finish():
            try:
                result = self._assemble()
            except Exception as e:  # noqa: BLE001 - surface assembly bugs
                self._recycle()
                self.future.set_exception(e)
                return
            # Recycle BEFORE completing: the caller's next round starts the
            # moment the future resolves, and its leases should find this
            # round's flats already back in the pool (the result views keep
            # their buffer alive; aliased freelist entries are skipped).
            self._recycle()
            self.future.set_result(result)

        # Assembly + user done-callbacks run on the completer thread, never
        # on the transport IO thread the inline handlers execute on (inline
        # only for callback-less futures, where completion is an event-set).
        self._complete(_finish)

    def _fail(self, err) -> None:
        """Error the whole bucketed round (protocol mismatch detection);
        idempotent against racing child completions."""
        with self._lock:
            if self.done:
                return
            self.done = True
        self._recycle()
        self._complete(self.future.set_exception, err)

    def _recycle(self):
        """Offer the round's flats back to the pool.  Eager by design:
        entries still aliased (pinned sends, the result views just handed to
        the caller) sit in the freelist untouched until their references die
        — lease()'s refcount probe never hands out aliased memory.  Runs on
        every from-within terminal path, so it also deregisters the group's
        mismatch sentinel."""
        if self.cleanup is not None:
            self.cleanup()
            self.cleanup = None  # the closure references us: break the cycle
        if self.stage_owned:
            buckets.release(self.stage_flat)
        buckets.release(self.acc_flat)
        buckets.release(self.result_flat)
        # Drop our own references immediately: anything still keeping this
        # object alive (a stray closure, a parked error path) would
        # otherwise pin every flat at refcount > pool-only and defeat
        # lease()'s reuse probe for the rest of the process.
        self.stage_flat = self.acc_flat = self.result_flat = None
        self.flat_view = None
        self.results = []

    def _assemble(self):
        vals = [b for (_, b) in self.results]
        if all(b is None for b in vals):
            return (None, self.meta_total) if self.has_meta else None
        flat = self.result_flat
        if flat is None:
            flat = self.acc_flat if self.acc_flat is not None else self.stage_flat
        for k, b in enumerate(vals):
            s, e = self.layout.bounds[k]
            dst = flat[s:e]
            if b is None:
                dst[:] = 0
            elif not np.may_share_memory(b, dst):
                np.copyto(dst, b)
        leaves = self.layout.unflatten(flat)
        if self.acc_dtype != self.layout.dtype:
            leaves = [l.astype(self.layout.dtype, copy=False) for l in leaves]
        value = nest.pack_as(self.template, leaves)
        return (value, self.meta_total) if self.has_meta else value


class Group:
    """A group of Rpc peers allowing coordinated AllReduce (reference API:
    update/set_broker_name/set_timeout/set_sort_order/members/sync_id/name/
    active/all_reduce)."""

    def __init__(self, rpc: Rpc, name: str):
        self._rpc = rpc
        self._name = name
        self._broker_name = "broker"
        self._timeout = 60.0
        self._sort_order = 0
        self._role = "member"
        self._lock = threading.RLock()
        self._sync_id: Optional[int] = None
        self._members: List[str] = []
        self._last_ping = 0.0
        self._ping_interval = 1.0
        self._ping_inflight = False
        # Ping cycle counter: bumped whenever an in-flight ping is abandoned
        # (overdue, or the failover scan retargeted the broker) so the late
        # reply from a dead/demoted broker can't clobber newer state.
        self._ping_seq = 0
        self._ping_fail_since: Optional[float] = None
        self._left = False
        self._stale_since: Optional[float] = None
        # --- broker high availability (multi-address control plane) ------
        # Addresses of every broker (primary + hot standbys).  Empty keeps
        # the legacy single-name mode: ping whatever set_broker_name said.
        self._broker_addrs: List[str] = []
        self._broker_resolved = False  # _broker_name learned from an address
        self._broker_gen = 0  # highest generation fence seen (0 = unfenced)
        self._broker_fail_after = 5.0  # ping silence before a failover scan
        self._failover: Optional[dict] = None  # in-flight scan state
        self._ops: Dict[Tuple, Any] = {}  # key -> _Op | _RingOp
        self._parked: Dict[Tuple, List[Any]] = {}
        self._ring_parked: Dict[Tuple, List[Tuple]] = {}
        self._park_t: Dict[Tuple, float] = {}  # park time, swept in update()
        self._seq: Dict[Tuple, int] = {}  # (sync_id, op name) -> next seq
        self._recv_seq: Dict[Tuple, int] = {}
        self._on_change_callbacks: List[Callable] = []
        self._member_hosts: Dict[str, Optional[str]] = {}
        # Machine identity sent with every broker ping (tests override it to
        # simulate cross-host cohorts on one box).
        from .rpc.core import _boot_id

        self._host_key = _boot_id()
        # Per-group completer: one group's slow user done-callback must not
        # gate another group's (another Accumulator's) round completion.
        self._completer = _Completer()
        self._register_handlers()

    # ------------------------------------------------------------------ setup
    def _register_handlers(self):
        # Several Groups can share one Rpc; handlers are defined once and
        # dispatch on the group name (first argument).
        registry = getattr(self._rpc, "_moolib_groups", None)
        if registry is None:
            registry = {}
            self._rpc._moolib_groups = registry
            rpc = self._rpc

            def dispatch(method):
                def handler(group_name, *args):
                    g = registry.get(group_name)
                    if g is None:
                        return None
                    return method(g, *args)

                return handler

            rpc.define("__group_update", dispatch(Group._on_update))
            # The allreduce data-plane handlers run INLINE on the receiving
            # IO thread with zero-copy borrowed payload views (Rpc.define):
            # eager bucket ops fold contributions in place straight off the
            # receive buffer; anything retained (parked frames, non-eager
            # contribs, shared results) is copied via _own()/consume hooks.
            rpc.define("__group_reduce", dispatch(Group._on_reduce), inline=True)
            rpc.define("__group_share", dispatch(Group._on_share), inline=True)
            rpc.define("__group_ring", dispatch(Group._on_ring), inline=True)
        if self._name in registry:
            raise RpcError(f"group {self._name!r} already exists on this Rpc")
        registry[self._name] = self

    # ------------------------------------------------------------------- api
    def set_broker_name(self, name: str) -> None:
        self._broker_name = name

    def set_brokers(self, addresses: List[str]) -> None:
        """Give this group the full broker control plane: the ADDRESSES of
        the primary and every hot standby (docs/RESILIENCE.md "Broker
        failover").  The Rpc dials and keeps a connection to each; the
        greeting resolves each address to the broker's rpc NAME (calls
        route by name).  Pings go to the current primary; when they go
        silent past ``set_broker_fail_after`` — or the broker answers as a
        demoted standby — the group scans ``__broker_status`` across the
        list and re-targets the highest-generation broker, recorded as a
        ``recovery_seconds{phase="broker_failover"}`` span."""
        self._broker_addrs = [a for a in addresses if a]
        self._broker_resolved = False
        for a in self._broker_addrs:
            self._rpc.connect(a)

    def set_broker_fail_after(self, seconds: float) -> None:
        """Ping silence (seconds) on the current broker before the failover
        scan starts.  Also bounds how long one unanswered ping is trusted."""
        self._broker_fail_after = float(seconds)

    def set_timeout(self, seconds: float) -> None:
        self._timeout = float(seconds)

    def set_sort_order(self, order: int) -> None:
        self._sort_order = int(order)

    def set_role(self, role: str) -> None:
        """Join the broker cohort as a NON-CONTRIBUTING member (any role
        string other than ``"member"``, e.g. ``"replica"``): the broker
        tracks this peer's liveness and advertises it via ``__broker_list``
        (serving-plane discovery), but it never enters the membership epoch
        — its joins, leaves, and deaths cannot bump ``sync_id`` or cancel
        the contributing cohort's in-flight reductions.  Observers receive
        no epoch pushes; ``active()`` stays False and ``all_reduce`` is not
        available to them.  Set before the first ``update()``."""
        self._role = str(role)

    def role(self) -> str:
        return self._role

    def members(self) -> List[str]:
        with self._lock:
            return list(self._members)

    def member_hosts(self) -> Dict[str, Optional[str]]:
        """Machine identity (boot id) per member, from the broker's epoch
        push — every member sees the same mapping for a given ``sync_id``.
        ``None`` for members whose ping predates the host field."""
        with self._lock:
            return dict(self._member_hosts)

    def ring_auto(self, nbytes: int) -> bool:
        """The environment-aware tree-vs-ring choice for a payload of
        ``nbytes`` (payload size alone is not enough).
        Ring when ALL of:

        - payload >= ``MOOLIB_RING_THRESHOLD`` (1 MiB default): below it the
          tree's single hop beats the ring's 2(n-1) message latency;
        - cohort size >= 3: at n=2 both algorithms move exactly one payload
          per peer and the tree is simpler;
        - the cohort spans more than one machine: same-host frames ride
          memfd zero-copy where wire bytes are nearly free, and the tree
          wins wall-clock (measured on one host); the ring's even per-peer
          load only pays on real NIC/DCN links.

        Deterministic cohort-wide: every input (threshold env, member list,
        host map) comes from the same broker epoch push, so peers at the
        same ``sync_id`` always agree — the path choice is wire protocol.
        """
        if nbytes < _ring_threshold():
            return False
        with self._lock:
            members = list(self._members)
            hosts = dict(self._member_hosts)
        if len(members) < 3:
            return False
        # "noboot-" keys are _boot_id's per-process random fallback (boot id
        # unreadable): they would make a same-host cohort look multi-machine.
        # Treat them as unknown — same policy as members with no host at all:
        # missing info must not silently disable the DCN optimization, and
        # must not manufacture a multi-host signal either.
        known = [
            None if h is None or h.startswith("noboot-") else h
            for h in (hosts.get(m) for m in members)
        ]
        if known and all(h is not None for h in known) and len(set(known)) == 1:
            return False
        return True

    def sync_id(self):
        return self._sync_id

    def name(self) -> str:
        return self._name

    def active(self) -> bool:
        with self._lock:
            return self._sync_id is not None and self._rpc.get_name() in self._members

    def add_change_callback(self, cb: Callable) -> None:
        """Extension over the reference: observe membership epoch changes."""
        self._on_change_callbacks.append(cb)

    def left(self) -> bool:
        return self._left

    def leave(self, timeout: float = 5.0) -> bool:
        """Graceful decommission: announce departure to the broker instead of
        going silent and burning the cohort's ping-eviction timeout.  The
        broker bumps the membership epoch immediately, so the remaining
        members re-form in sub-second time.  After this the group stops
        pinging and stays inactive; returns True once the broker acked the
        leave (False on timeout/error — the cohort then falls back to the
        ordinary eviction path, which is still correct, just slow)."""
        with self._lock:
            if self._left:
                return True
            self._left = True
            # Our own in-flight ops can never complete: we stop receiving
            # epoch pushes, so nothing would ever cancel them (the remaining
            # members' copies die with the leave's epoch bump).  Membership
            # state clears so active() turns False; change callbacks do NOT
            # fire — leaving is this peer's own decision, not a cohort event
            # it must re-elect over.
            ops, self._ops = list(self._ops.values()), {}
            self._parked.clear()
            self._ring_parked.clear()
            self._park_t.clear()
            self._seq.clear()
            self._recv_seq.clear()
            self._members = []
            self._member_hosts = {}
        for op in ops:
            op.future.set_exception(RpcError("left group"))
        done = threading.Event()
        acked = []

        def _reply(result, error):
            if error is None and isinstance(result, dict) and result.get("left"):
                acked.append(True)
            done.set()

        self._rpc.async_callback(
            self._broker_name, "__broker_leave", _reply,
            self._name, self._rpc.get_name(),
        )
        done.wait(timeout)
        return bool(acked)

    def update(self) -> None:
        """Pump: ping the broker, request resync when stale, sweep op timeouts.

        Mirrors the reference's ping-driven ``GroupService::update``
        (``src/group.h:394-490``); call it regularly from the train loop.
        """
        now = time.monotonic()
        if self._broker_addrs and not self._left:
            self._broker_maintenance(now)
        if (now - self._last_ping >= self._ping_interval and not self._ping_inflight
                and not self._left):
            self._last_ping = now
            self._ping_inflight = True
            seq = self._ping_seq
            self._rpc.async_callback(
                self._broker_name,
                "__broker_ping",
                lambda result, error: self._on_ping_reply(result, error, seq),
                self._name,
                self._rpc.get_name(),
                self._sort_order,
                self._sync_id,
                self._host_key,
                self._role,
                self._broker_gen,
            )
        with self._lock:
            expired = [
                op for op in self._ops.values() if now - op.started_at > self._timeout
            ]
            for op in expired:
                del self._ops[op.key]
            # Parked frames whose op never materialized (epoch never adopted,
            # or the local op consumed them — all_reduce pops the frame lists
            # but not the timestamps) age out on the same clock as ops.
            stale = [
                k for k, t in self._park_t.items()
                if now - t > self._timeout
                or (k not in self._parked and k not in self._ring_parked)
            ]
            for k in stale:
                del self._park_t[k]
                self._parked.pop(k, None)
                self._ring_parked.pop(k, None)
        # Futures complete outside the group lock: done-callbacks (e.g. the
        # Accumulator's) take their own locks, and completing inline would
        # invert the lock order against all_reduce callers.
        for op in expired:
            op.future.set_exception(RpcError(f"allreduce {op.key} timed out"))

    # -------------------------------------------------------- broker failover
    def _broker_maintenance(self, now: float) -> None:
        """Multi-broker upkeep (``set_brokers`` mode): resolve the broker's
        rpc name from the address list, abandon overdue pings, start and
        pump the failover scan.  Called from ``update()``."""
        sends: List[str] = []
        fo_ref: Optional[dict] = None
        with self._lock:
            if not self._broker_resolved and self._failover is None:
                for a in self._broker_addrs:
                    name = self._rpc.peer_name_at(a)
                    if name is not None:
                        # First address to greet is the presumed primary; a
                        # standby reply to the first ping corrects a wrong
                        # first guess via the failover scan.
                        self._broker_name = name
                        self._broker_resolved = True
                        break
            # An unanswered ping blocks the ping loop (and the rpc-level
            # timeout can be much longer than the failover budget): past the
            # failure window stop trusting it — the late reply, if it ever
            # lands, is ignored by the seq guard.
            if (self._ping_inflight
                    and now - self._last_ping
                    > max(self._ping_interval, self._broker_fail_after)):
                self._ping_inflight = False
                self._ping_seq += 1
                if self._ping_fail_since is None:
                    self._ping_fail_since = self._last_ping
            if (self._failover is None and self._ping_fail_since is not None
                    and now - self._ping_fail_since > self._broker_fail_after):
                self._start_failover_locked(now, "ping silence")
            fo = self._failover
            if fo is not None and fo.get("target") is None:
                fo_ref = fo
                for a in self._broker_addrs:
                    name = self._rpc.peer_name_at(a)
                    if name is None:
                        continue  # never greeted (down or still dialing)
                    if now - fo["asked"].get(name, -1e9) < 1.0:
                        continue
                    fo["asked"][name] = now
                    sends.append(name)
                replies = fo["replies"]
                if replies and (len(replies) >= len(fo["asked"])
                                or now - fo["t0"] >= 0.5):
                    # Highest generation wins; primaries beat standbys at the
                    # same generation (a fresh low-generation primary must
                    # lose to the fenced standby that outlived it); the name
                    # breaks exact ties deterministically.
                    gen, _primary, target = max(replies.values())
                    fo["target"] = target
                    self._broker_name = target
                    self._broker_resolved = True
                    self._broker_gen = max(self._broker_gen, gen)
                    self._ping_seq += 1
                    self._ping_inflight = False
                    self._last_ping = 0.0  # ping the new broker immediately
                    self._ping_fail_since = None
                    utils.log_info(
                        "group %s: failing over to broker %r (generation %d)",
                        self._name, target, gen,
                    )
        for name in sends:
            self._rpc.async_callback(
                name, "__broker_status",
                lambda result, error, name=name, fo=fo_ref:
                    self._on_status_reply(name, fo, result, error),
            )

    def _start_failover_locked(self, now: float, why: str) -> None:
        self._failover = {"t0": now, "asked": {}, "replies": {}, "target": None}
        _M_FAILOVERS.inc()
        utils.log_info(
            "group %s: broker %r unresponsive (%s) — scanning %d broker address(es)",
            self._name, self._broker_name, why, len(self._broker_addrs),
        )

    def _on_status_reply(self, name: str, fo: dict, result, error) -> None:
        if error is not None or not isinstance(result, dict):
            return
        with self._lock:
            if self._failover is not fo or fo.get("target") is not None:
                return  # a newer scan owns the state, or this one concluded
            fo["replies"][name] = (
                int(result.get("generation", 0)),
                bool(result.get("primary", False)),
                name,
            )

    def _on_ping_reply(self, result, error, seq: Optional[int] = None):
        now = time.monotonic()
        with self._lock:
            if seq is not None and seq != self._ping_seq:
                return  # abandoned cycle (overdue ping, or broker retargeted)
            self._ping_inflight = False
            if error is not None:
                if self._ping_fail_since is None:
                    self._ping_fail_since = now
                utils.log_verbose("group %s: broker ping failed: %s", self._name, error)
                return
            self._ping_fail_since = None
            if isinstance(result, dict):
                gen = result.get("generation")
                if gen is not None and int(gen) > self._broker_gen:
                    self._broker_gen = int(gen)
                if result.get("standby"):
                    # The broker we ping was demoted (or never promoted): it
                    # cannot serve epochs.  Don't wait for ping silence.
                    if self._broker_addrs and self._failover is None:
                        self._start_failover_locked(now, "standby reply")
                    return
            fo = self._failover
            if fo is not None and fo.get("target") == self._broker_name:
                # First successful ping against the newly-picked primary:
                # the control plane is back for this peer.
                self._failover = None
                dt = now - fo["t0"]
                observe_phase("broker_failover", dt)
                telemetry.flight_event("group.broker_failover",
                                       group=self._name,
                                       broker=self._broker_name,
                                       generation=self._broker_gen,
                                       seconds=round(dt, 4))
                utils.log_info(
                    "group %s: broker failover complete: %r gen=%d in %.2fs",
                    self._name, self._broker_name, self._broker_gen, dt,
                )
            elif fo is not None and fo.get("target") is None:
                # The broker answered as a primary mid-scan: it recovered
                # (or was a false alarm) — stand down the scan.
                self._failover = None
            remote_sync = result["sync_id"]
            if self._role != "member":
                # Observers are outside the epoch: the broker's sync_id is the
                # contributing cohort's, not ours — never resync over it.
                return
            stale = remote_sync != self._sync_id
            if not stale:
                self._stale_since = None
                return
            # The broker pushes updates on change; if we stay stale for more
            # than a couple of pings we likely missed the push — ask again.
            if self._stale_since is None:
                self._stale_since = now
                return
            want_resync = now - self._stale_since > 2 * self._ping_interval
        if want_resync:
            self._stale_since = None
            self._rpc.async_callback(
                self._broker_name,
                "__broker_resync",
                lambda r, e: None,
                self._name,
                self._rpc.get_name(),
            )

    # ------------------------------------------------------------ membership
    def _on_update(self, sync_id: int, members: List[str], hosts=None,
                   generation=None):
        with self._lock:
            if generation is not None:
                generation = int(generation)
                if generation < self._broker_gen:
                    # Generation fence: a zombie ex-primary (wedged process,
                    # healed partition) pushing epochs it has no right to
                    # mint.  Its sync_ids may even be higher than the real
                    # primary's — the fence, not the epoch number, is what
                    # rejects it (the real primary outruns those sync_ids on
                    # our next ping via the broker's sync_id repair).
                    _M_STALE_PUSHES.inc()
                    utils.log_verbose(
                        "group %s: rejecting push from fenced broker "
                        "(generation %d < %d)",
                        self._name, generation, self._broker_gen,
                    )
                    return None
                if generation > self._broker_gen:
                    self._broker_gen = generation
            if self._sync_id is not None and sync_id <= self._sync_id:
                return None  # stale push
            self._sync_id = sync_id
            self._members = list(members)
            self._member_hosts = dict(hosts) if hosts else {}
            self._stale_since = None
            # Cancel everything in flight: the tree changed under it
            # (reference cancels with "group change", src/group.h:453-460).
            # Frames parked FOR this very epoch survive — a fast peer's
            # first op raced ahead of our broker push (see _on_reduce);
            # everything else died with its epoch.
            ops, self._ops = list(self._ops.values()), {}
            self._parked = {k: v for k, v in self._parked.items()
                            if k[0] == sync_id}
            self._ring_parked = {k: v for k, v in self._ring_parked.items()
                                 if k[0] == sync_id}
            self._park_t = {k: t for k, t in self._park_t.items()
                            if k in self._parked or k in self._ring_parked}
            self._seq.clear()
            self._recv_seq.clear()
        telemetry.flight_event("group.epoch", group=self._name,
                               sync_id=sync_id, members=len(members),
                               cancelled_ops=len(ops))
        for op in ops:
            op.future.set_exception(RpcError("group changed"))
        for cb in self._on_change_callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001
                utils.log_error("group change callback failed")
        utils.log_verbose(
            "group %s: sync_id=%s members=%s", self._name, sync_id, members
        )
        return None

    # -------------------------------------------------------------- topology
    def _tree(self) -> Tuple[int, Optional[int], List[int]]:
        """(my_index, parent_index, child_indices) in the current epoch."""
        me = self._rpc.get_name()
        idx = self._members.index(me)
        parent = None if idx == 0 else (idx - 1) // 2
        n = len(self._members)
        children = [c for c in (2 * idx + 1, 2 * idx + 2) if c < n]
        return idx, parent, children

    # -------------------------------------------------------------- allreduce
    def all_reduce(self, name: str, value, op="sum", finalize=None, *,
                   meta=None, meta_op=None, wire=None, chunked=None,
                   template=None, bucketed=None, chunk_align=None,
                   owned: bool = False) -> AllReduce:
        """Start an allreduce of ``value`` under ``name``; all active members
        must call with the same name (and call order per name).

        ``finalize``, if given, is applied to a tree node's reduced partial
        before it travels on the wire (and to the root's final result).  This
        lets an op accumulate in a wide dtype at each hop and re-round only
        once per hop — the Accumulator's wire-compression contract.

        Large uniform-dtype array payloads with a builtin string ``op``
        automatically take the bandwidth-optimal **chunked ring** path
        (reduce-scatter + all-gather, see ``_RingOp``) when ``ring_auto``
        says so (payload >= ``MOOLIB_RING_THRESHOLD``, cohort >= 3, spans
        more than one machine); ``chunked=True/False`` forces the choice.
        The path choice is part of the op's wire protocol, so it must be
        deterministic cohort-wide: same threshold env, same payload shapes,
        same kwargs on every peer (``ring_auto``'s other inputs come from
        the broker's epoch push and agree by construction).  Ring-only
        extras:

        - ``meta``/``meta_op``: a small side value combined exactly once per
          member along the ring (e.g. batch counts); the future then resolves
          to ``(value, meta)``.
        - ``wire``: per-hop chunk compression — a numpy dtype name (e.g.
          ``"bfloat16"``: accumulate f32, re-round per hop) or ``"q8"``
          (symmetric int8, one scale per chunk).
        - ``value=None`` (sum only) contributes zero at near-zero wire cost;
          ``template`` must then supply the pytree of array shapes.
        - ``chunk_align``: align ring chunk boundaries to multiples of this
          many ELEMENTS (the Accumulator passes its flat-bucket size so ring
          chunks land on bucket boundaries).  Wire protocol: same on every
          peer.

        Large uniform-dtype ``op="sum"`` payloads that stay on the tree take
        the **flat-bucket** path (``bucketed=True/False`` forces, ``None``
        auto-selects above ``MOOLIB_BUCKET_THRESHOLD``): the payload is
        flattened into fixed-size buckets (``buckets.bucket_bytes()``), each
        bucket rides the tree as its own pipelined sub-op, contributions are
        folded IN PLACE off the borrowed receive buffer, and the wire sees
        memoryviews over the flat buffer end to end (docs/DESIGN.md
        "Gradient data plane").  ``meta``/``wire``/``template`` compose with
        ``bucketed=True`` exactly as with the ring.  ``owned=True`` declares
        that the value's buffers belong to the op until the future resolves
        (the op may fold partial sums into them in place) and that the
        caller accepts READ-ONLY result views (the zero-copy share terminus
        may leave the result in adopted shared pages); without it the
        caller's arrays are only read and results are always writable.  Like the ring/tree choice, the
        bucket path choice and bucket size are wire protocol — identical
        settings on every peer.
        """
        future = AllReduce()
        if (meta is not None or wire is not None or template is not None) and (
            chunked is not True and bucketed is not True
        ):
            # These kwargs must not silently change meaning with cohort or
            # payload size: they require an explicit path choice.
            raise RpcError("meta=/wire=/template= require chunked=True or bucketed=True")
        with self._lock:
            # The auto decision MUST be read under the same lock acquisition
            # that assigns the op's sync_id key (RLock — ring_auto re-enters):
            # an epoch push landing between decide and register would attach
            # an old-epoch path choice to a new-epoch op key, and peers at
            # one key must always agree on the path.
            use_ring = chunked
            if use_ring is None:
                use_ring = (
                    meta is None and wire is None and template is None
                    and finalize is None and isinstance(op, str) and value is not None
                    and bucketed is not True
                    and self.ring_auto(_ring_nbytes(value))
                )
            if use_ring:
                if not isinstance(op, str):
                    raise RpcError("chunked allreduce needs a builtin string op")
                if finalize is not None:
                    raise RpcError("chunked allreduce: use wire= instead of finalize=")
                if value is None and op != "sum":
                    raise RpcError("value=None (skip) only composes with op='sum'")
                if meta is not None and meta_op is None:
                    raise RpcError("meta= requires meta_op=")
            use_buckets = False
            if not use_ring:
                use_buckets = bucketed
                if use_buckets is None:
                    # Auto rule, deterministic cohort-wide: same threshold
                    # env, same payload shapes, same member count.
                    nb = _ring_nbytes(value) if value is not None else -1
                    use_buckets = (
                        meta is None and wire is None and template is None
                        and finalize is None and op == "sum"
                        and nb >= _bucket_threshold()
                        and len(self._members) >= 2
                    )
                if use_buckets:
                    if op != "sum":
                        raise RpcError("bucketed allreduce only composes with op='sum'")
                    if finalize is not None:
                        raise RpcError("bucketed allreduce: use wire= instead of finalize=")
                    if value is None and template is None:
                        raise RpcError("bucketed allreduce with value=None requires template=")
                    if meta is not None and meta_op is None:
                        raise RpcError("meta= requires meta_op=")
            reduce_fn = None if (use_ring or use_buckets) else _resolve_op(op)
            if self._sync_id is None or self._rpc.get_name() not in self._members:
                future.set_exception(RpcError("group not active"))
                return future
            seq_key = (self._sync_id, name)
            seq = self._seq.get(seq_key, 0)
            self._seq[seq_key] = seq + 1
            key = (self._sync_id, name, seq)
            if len(self._members) == 1:
                future.set_result((value, meta) if meta is not None else value)
                return future
            if use_buckets:
                try:
                    finished = self._bucketed_start_locked(
                        name, seq, value, future, meta, meta_op, wire, template,
                        owned)
                except RpcError as e:
                    future.set_exception(e)
                    return future
            elif use_ring:
                try:
                    opstate = _RingOp(
                        key, value, op, future, list(self._members),
                        self._members.index(self._rpc.get_name()), wire,
                        meta, meta_op, template, chunk_align)
                except RpcError as e:
                    future.set_exception(e)
                    return future
                self._ops[key] = opstate
                for frame in self._ring_parked.pop(key, []):
                    opstate.pending[(frame[0], frame[1])] = frame[2:]
                if self._parked.pop(key, None) is not None:
                    del self._ops[key]
                    future.set_exception(RpcError(
                        "peers disagree on allreduce path: tree contribution "
                        f"received for chunked op {key}"))
                    return future
                if (self._sync_id, f"{name}\x1f{seq}:0", 0) in self._parked:
                    del self._ops[key]
                    future.set_exception(RpcError(
                        "peers disagree on allreduce path: bucketed "
                        f"contribution received for chunked op {key}"))
                    return future
            else:
                opstate = _Op(key, _host_tree(value), reduce_fn, finalize, future)
                self._ops[key] = opstate
                parked = self._parked.pop(key, [])
                opstate.contribs.extend(parked)
                if self._ring_parked.pop(key, None) is not None:
                    del self._ops[key]
                    future.set_exception(RpcError(
                        "peers disagree on allreduce path: ring frame "
                        f"received for tree op {key}"))
                    return future
                # Bucketed sub-ops address child keys (name\x1f<seq>:<k>,
                # child seq always 0) — a parked bucket-0 frame means a peer
                # took the bucketed path for this very round.
                if (self._sync_id, f"{name}\x1f{seq}:0", 0) in self._parked:
                    del self._ops[key]
                    future.set_exception(RpcError(
                        "peers disagree on allreduce path: bucketed "
                        f"contribution received for tree op {key}"))
                    return future
                action = self._check_op_locked(opstate)
        if use_buckets:
            for op_, action_ in finished:
                self._finish_op(op_, action_)
        elif use_ring:
            self._ring_pump(opstate)
        else:
            self._finish_op(opstate, action)
        return future

    def _bucketed_start_locked(self, name, pseq, value, future, meta, meta_op,
                               wire, template, owned):
        """Create the per-bucket eager sub-ops of one flat-bucket tree
        allreduce (caller holds the group lock; see ``_BucketedReduce``).
        Returns ``(op, action)`` pairs to finish outside the lock."""
        pkey = (self._sync_id, name, pseq)
        if (
            self._parked.pop(pkey, None) is not None
            or self._ring_parked.pop(pkey, None) is not None
        ):
            raise RpcError(
                "peers disagree on allreduce path: legacy frame "
                f"received for bucketed op {pkey}")
        parent = _BucketedReduce(
            value, meta, meta_op, wire, template, owned, self._defer)
        parent.key = pkey
        layout = parent.layout
        finished = []
        created = []
        try:
            for k in range(layout.n_buckets):
                opstate, key = self._bucketed_child_locked(
                    parent, name, pseq, k, meta, wire)
                created.append(key)
                finished.append((opstate, self._check_op_locked(opstate)))
        except Exception as e:
            # Unwind every child op already registered: an orphaned child
            # would fire parent._child_done from the timeout sweep with
            # parent.future never attached.
            for key in created:
                self._ops.pop(key, None)
            parent._recycle()
            if isinstance(e, RpcError):
                raise
            raise RpcError(f"bucketed allreduce setup failed: {e!r}")
        parent.attach(future)
        # Mismatch sentinel: a legacy peer addresses this round at the
        # PARENT key, where no bucketed sub-op lives — register the parent
        # there so _on_reduce/_on_share error the round loudly (the ring
        # contract) instead of parking the frame until the timeout sweep.
        self._ops[pkey] = parent

        def _done(pkey=pkey, parent=parent):
            with self._lock:
                if self._ops.get(pkey) is parent:
                    del self._ops[pkey]

        parent.cleanup = _done
        return finished

    def _bucketed_child_locked(self, parent, name, pseq, k, meta, wire):
        """Create and register bucket ``k``'s eager sub-op of a bucketed
        round (caller holds the group lock).  Shared by the barrier path
        (``_bucketed_start_locked`` creates every bucket at once) and the
        streaming path (``bucketed_stream`` launches buckets one at a time,
        as the caller stages them).  A parked contribution of the wrong
        length (peers with mismatched ``MOOLIB_BUCKET_BYTES``) raises here —
        callers turn that into a loud whole-round error."""
        cname = f"{name}\x1f{pseq}:{k}"
        cseq_key = (self._sync_id, cname)
        cseq = self._seq.get(cseq_key, 0)
        self._seq[cseq_key] = cseq + 1
        key = (self._sync_id, cname, cseq)
        s, e = parent.layout.bounds[k]
        val = {
            "b": parent.flat_view[s:e] if parent.flat_view is not None else None,
            "m": dict(meta) if (k == 0 and meta is not None) else None,
        }
        cf = AllReduce()
        opstate = _Op(
            key, val,
            (lambda a, b, k=k: parent._fold(k, a, b)),
            parent._fin if wire is not None else None,
            cf, eager=True,
            consume=(lambda v, k=k: parent._consume(k, v)),
        )
        self._ops[key] = opstate
        try:
            for c in self._parked.pop(key, []):
                opstate.value = opstate.op(opstate.value, c)
                opstate.folded += 1
            if self._ring_parked.pop(key, None) is not None:
                raise RpcError(
                    "peers disagree on allreduce path: ring frame "
                    f"received for bucketed op {key}")
        except Exception:
            self._ops.pop(key, None)
            raise
        cf.add_done_callback(lambda f, k=k: parent._child_done(k, f))
        return opstate, key

    def bucketed_stream(self, name: str, flat, *, meta=None, meta_op=None,
                        wire=None) -> "BucketedStream":
        """Start a flat-bucket tree allreduce whose per-bucket sub-ops
        launch INCREMENTALLY (streaming gradient pipeline, DESIGN.md §6e).

        ``flat`` is the caller's contiguous staging buffer, handed over
        ``owned=True`` (folds accumulate into it in place; results may be
        read-only views) — its CONTENTS need not be ready yet: bucket ``k``'s
        slice must be fully staged only by the time the caller invokes
        ``handle.launch(k)``.  The wire protocol is IDENTICAL to the barrier
        path (same parent seq, same child op names, same payloads) — only
        the launch times differ, so streaming and barrier peers interoperate
        within one round: a faster peer's frames for a not-yet-launched
        bucket simply park until the launch folds them.

        Returns a :class:`BucketedStream` handle; ``handle.future`` resolves
        exactly like the equivalent ``all_reduce(..., bucketed=True)``
        future once every bucket's sub-op completes.  A membership-epoch
        change mid-stream errors the round loudly: the epoch push cancels
        the launched ops (``RpcError("group changed")``) and any later
        ``launch`` raises instead of silently desyncing the cohort.
        """
        future = AllReduce()
        handle = BucketedStream(self, name, future)
        flat = buckets.host_view(flat)
        if not isinstance(flat, np.ndarray) or flat.ndim != 1 or not flat.flags.c_contiguous:
            future.set_exception(RpcError(
                "bucketed_stream needs a contiguous 1-d host flat buffer"))
            handle._dead = True
            return handle
        with self._lock:
            if self._sync_id is None or self._rpc.get_name() not in self._members:
                future.set_exception(RpcError("group not active"))
                handle._dead = True
                return handle
            seq_key = (self._sync_id, name)
            pseq = self._seq.get(seq_key, 0)
            self._seq[seq_key] = pseq + 1
            handle._pseq = pseq
            handle._sync_id = self._sync_id
            if len(self._members) == 1:
                # Degenerate cohort: the result is the caller's own staged
                # flat.  Completion waits for handle.finish() — the buffer
                # is still being filled while buckets "launch".
                handle._degenerate = (flat, meta)
                layout = buckets.BucketLayout([np.asarray(flat).shape],
                                              np.asarray(flat).dtype)
                handle.bounds = layout.bounds
                return handle
            pkey = (self._sync_id, name, pseq)
            if (
                self._parked.pop(pkey, None) is not None
                or self._ring_parked.pop(pkey, None) is not None
            ):
                future.set_exception(RpcError(
                    "peers disagree on allreduce path: legacy frame "
                    f"received for bucketed op {pkey}"))
                handle._dead = True
                return handle
            parent = _BucketedReduce(
                flat, meta, meta_op, wire, None, True, self._defer)
            parent.key = pkey
            parent.attach(future)
            handle._parent = parent
            handle._meta = meta
            handle._wire = wire
            handle.bounds = parent.layout.bounds
            # Mismatch sentinel at the parent key, exactly as the barrier
            # path registers it (legacy frames error loudly, the timeout
            # sweep covers a round whose peers never show up).
            self._ops[pkey] = parent

            def _done(pkey=pkey, parent=parent):
                with self._lock:
                    if self._ops.get(pkey) is parent:
                        del self._ops[pkey]

            parent.cleanup = _done
        return handle

    def _stream_launch(self, handle: "BucketedStream", k: int):
        """Launch bucket ``k`` of a streaming round (its slice of the flat
        buffer is now staged).  Returns the child future, or None on the
        degenerate single-member path.  Raises RpcError when the membership
        epoch changed mid-stream — buckets partially in flight cannot be
        re-keyed to the new epoch, so the round fails loudly."""
        if handle._dead:
            raise RpcError(
                f"streaming allreduce {handle.name}: round already failed")
        if handle._degenerate is not None:
            return None
        parent = handle._parent
        with self._lock:
            if self._sync_id != handle._sync_id or parent.done:
                err = RpcError(
                    f"streaming allreduce {handle.name}: group changed with "
                    f"buckets in flight (epoch {handle._sync_id} -> "
                    f"{self._sync_id})")
                handle._dead = True
            else:
                try:
                    opstate, _key = self._bucketed_child_locked(
                        parent, handle.name, handle._pseq, k, handle._meta,
                        handle._wire)
                    action = self._check_op_locked(opstate)
                    err = None
                except Exception as e:  # noqa: BLE001 — loud whole-round error
                    err = e if isinstance(e, RpcError) else RpcError(
                        f"streaming allreduce launch failed: {e!r}")
                    handle._dead = True
        if err is not None:
            parent._fail(err)
            raise err
        self._finish_op(opstate, action)
        return opstate.future

    def _stream_finish(self, handle: "BucketedStream") -> None:
        """Caller finished staging + launching every bucket.  Only the
        degenerate single-member path has work left: resolve the future with
        the (now fully staged) local flat, mirroring all_reduce's
        single-member short-circuit."""
        if handle._degenerate is not None and not handle._dead:
            flat, meta = handle._degenerate
            handle.future.set_result((flat, meta) if meta is not None else flat)

    def _stream_abort(self, handle: "BucketedStream", err) -> None:
        """Error the streaming round from the caller's side (staging failed
        mid-stream).  Launched sub-ops keep draining into the dead parent;
        peers waiting on unlaunched buckets time out loudly — same failure
        surface as a peer crashing mid-round."""
        handle._dead = True
        if handle._parent is not None:
            handle._parent._fail(err)
        else:
            handle.future.set_exception(err)

    def _defer(self, fn, *args):
        """Run ``fn(*args)`` on the completion thread.  Bucketed rounds
        complete from inline handlers on the transport IO thread; user
        done-callbacks (arbitrary code, arbitrary locks) must never run
        there (same contract as plain handler dispatch).  A dedicated
        thread rather than the Rpc executor: completions gate the caller's
        next round, and the executor queues them behind handler dispatch
        (~3 ms under load vs ~0.1 ms here)."""
        self._completer(fn, *args)

    def _on_reduce(self, key, value):
        key = tuple(key) if isinstance(key, list) else key
        with self._lock:
            if self._sync_id is None or key[0] > self._sync_id:
                # An epoch this peer hasn't learned yet: the sender's broker
                # push beat ours and its first op raced ahead.  Dropping
                # would wedge that op (and the sender's election) until the
                # timeout sweep — the re_elect stall — so park; _on_update
                # keeps frames addressed to the epoch it installs.
                self._parked.setdefault(key, []).append(_own(value))
                self._park_t.setdefault(key, time.monotonic())
                return None
            if key[0] < self._sync_id:
                return None  # contribution from a dead epoch
            op = self._ops.get(key)
            if op is None:
                # Parked past the handler return: must own the bytes (the
                # handler runs inline with borrowed receive-buffer views).
                self._parked.setdefault(key, []).append(_own(value))
                self._park_t.setdefault(key, time.monotonic())
                return None
            if isinstance(op, (_RingOp, _BucketedReduce)):
                del self._ops[key]
                mismatch = op
            else:
                mismatch = None
                fold_err = None
                if op.eager:
                    # Fold NOW, while the borrowed view is valid: for the
                    # flat-bucket sum this is one in-place add straight off
                    # the receive buffer — no materialize, no copy.  A fold
                    # failure errors the op instead of wedging it.
                    try:
                        op.value = op.op(op.value, value)
                        op.folded += 1
                    except Exception as e:  # noqa: BLE001
                        del self._ops[key]
                        fold_err = e
                else:
                    op.contribs.append(_own(value))
                action = None if fold_err is not None else self._check_op_locked(op)
        if mismatch is not None:
            err = RpcError(
                "peers disagree on allreduce path: legacy tree contribution "
                f"received for {'bucketed' if isinstance(mismatch, _BucketedReduce) else 'chunked'} "
                f"op {key}")
            if isinstance(mismatch, _BucketedReduce):
                mismatch._fail(err)
            else:
                mismatch.future.set_exception(err)
            return None
        if fold_err is not None:
            op.future.set_exception(fold_err)
            return None
        self._finish_op(op, action)
        return None

    def _check_op_locked(self, op: _Op):
        """Reduce ready contributions; returns an action the caller performs
        *outside* the group lock (sends and future completion run caller
        callbacks / take caller locks — lock-order safety), or None."""
        idx, parent, children = self._tree()
        if op.eager:
            # Contributions were folded on arrival (_on_reduce); the op is
            # ready once every tree child has been folded in.
            if op.sent_up or op.folded < len(children):
                return None
            total = op.value
        else:
            if op.sent_up or len(op.contribs) < len(children):
                return None
            total = op.value
            for c in op.contribs[: len(children)]:
                total = op.op(total, c)
        if op.finalize is not None:
            total = op.finalize(total)
        op.sent_up = True
        if parent is None:
            # Root: reduction complete — share down the tree.
            del self._ops[op.key]
            return ("root", total, idx, self._members)
        return ("up", self._members[parent], total)

    def _finish_op(self, op: _Op, action) -> None:
        """Perform the deferred part of _check_op_locked outside the lock.
        ``members`` is the epoch snapshot taken under the lock: a concurrent
        membership change must not be observed half-way (receivers drop
        messages whose epoch key is stale, so sends to old members are safe).
        """
        if action is None:
            return
        if action[0] == "root":
            _, total, idx, members = action
            self._share_down(op.key, total, idx, members)
            op.future.set_result(total)
            return
        _, parent_name, total = action

        def _sent(result, error, op=op):
            if error is not None:
                with self._lock:
                    self._ops.pop(op.key, None)
                op.future.set_exception(RpcError(f"allreduce send failed: {error}"))

        self._rpc.async_callback(
            parent_name, "__group_reduce", _sent, self._name, op.key, total
        )

    def _on_share(self, key, result, direct: bool = False):
        key = tuple(key) if isinstance(key, list) else key
        with self._lock:
            if self._sync_id is None or key[0] != self._sync_id:
                return None
            op = self._ops.pop(key, None)
            if op is None:
                return None
            if isinstance(op, (_RingOp, _BucketedReduce)):
                mismatch = op
            else:
                mismatch = None
                # The shared result is retained (future value) and forwarded
                # down the tree: take ownership of its borrowed buffers.
                # The bucketed path's consume hook copies straight into the
                # preallocated result buffer (one pass off the receive
                # buffer) and keeps the encoded form for the forward;
                # everything else deep-copies.
                err = None
                try:
                    if op.consume is not None:
                        result, forward = op.consume(result)
                    else:
                        result = forward = _own(result)
                except Exception as e:  # noqa: BLE001 - must not wedge the op
                    err = e
                idx, _, _ = self._tree()
                members = self._members
        if mismatch is not None:
            share_err = RpcError(
                "peers disagree on allreduce path: tree share "
                f"received for {'bucketed' if isinstance(mismatch, _BucketedReduce) else 'chunked'} "
                f"op {key}")
            if isinstance(mismatch, _BucketedReduce):
                mismatch._fail(share_err)
            else:
                mismatch.future.set_exception(share_err)
            return None
        if err is not None:
            op.future.set_exception(err)
            return None
        if not direct:
            # direct=True marks a root-star share: the root already reached
            # every member; receivers must not re-forward down the tree.
            self._share_down(key, forward, idx, members)
        op.future.set_result(result)
        return None

    def _share_down(self, key, result, idx: int, members: List[str]):
        if idx == 0 and len(members) > 2 and _payload_nbytes(result) >= _memfd_min():
            others = [m for m in members if m != self._rpc.get_name()]
            if self._rpc.multicast_ready(others):
                # Root-star share over same-host memfd multicast: the result
                # serializes and is written ONCE for the whole cohort (one
                # memfd, one fd per peer) instead of being re-written at
                # every tree hop.  direct=True tells receivers not to
                # forward.  Root-local decision — no cohort agreement
                # needed: forwarding is purely receiver-side behavior.
                self._rpc.async_broadcast(
                    others, "__group_share", self._name, key, result, True
                )
                return
        n = len(members)
        for c in (2 * idx + 1, 2 * idx + 2):
            if c < n:
                self._rpc.async_callback(
                    members[c], "__group_share", lambda r, e: None, self._name, key, result
                )

    # ------------------------------------------------------------ ring path
    def _on_ring(self, key, phase, step, chunk_idx, data, meta):
        key = tuple(key) if isinstance(key, list) else key
        # Ring frames are retained in ``pending`` until their step comes up
        # (and ag-phase data is stored + forwarded): own the borrowed
        # payload views up front — the copy the old deserializer made.
        data = _own(data)
        with self._lock:
            if self._sync_id is None or key[0] > self._sync_id:
                # Not-yet-learned epoch: park, same rule as _on_reduce.
                self._ring_parked.setdefault(key, []).append(
                    (phase, step, chunk_idx, data, meta))
                self._park_t.setdefault(key, time.monotonic())
                return None
            if key[0] < self._sync_id:
                return None  # frame from a dead epoch
            op = self._ops.get(key)
            if op is None:
                self._ring_parked.setdefault(key, []).append(
                    (phase, step, chunk_idx, data, meta))
                self._park_t.setdefault(key, time.monotonic())
                return None
            if not isinstance(op, _RingOp):
                del self._ops[key]
                mismatch = op
            else:
                mismatch = None
                op.pending[(phase, step)] = (chunk_idx, data, meta)
        if mismatch is not None:
            # Complete outside the lock: done-callbacks (the Accumulator's)
            # take their own locks — inline completion would invert the lock
            # order against all_reduce callers (same rule as the timeout sweep).
            ring_err = RpcError(
                "peers disagree on allreduce path: ring frame "
                f"received for {'bucketed' if isinstance(mismatch, _BucketedReduce) else 'tree'} "
                f"op {key}")
            if isinstance(mismatch, _BucketedReduce):
                mismatch._fail(ring_err)
            else:
                mismatch.future.set_exception(ring_err)
            return None
        self._ring_pump(op)
        return None

    def _ring_pump(self, op: _RingOp) -> None:
        """Drive a ring op: drain ready steps under the lock, perform the
        resulting sends / completion outside it.  A ``pumping`` flag keeps one
        driver at a time per op (concurrent frame arrivals set ``repump``)."""
        with self._lock:
            if op.pumping:
                op.repump = True
                return
            op.pumping = True
        while True:
            with self._lock:
                op.repump = False
                if op.key not in self._ops and op.done_chunks < op.n:
                    op.pumping = False
                    return  # cancelled (epoch change / timeout / error)
                try:
                    actions = op.drain()
                except RpcError as e:
                    self._ops.pop(op.key, None)
                    op.pumping = False
                    err = e
                    break
                if any(a[0] == "done" for a in actions):
                    self._ops.pop(op.key, None)
                if not actions and not op.repump:
                    op.pumping = False
                    return
            err = None
            done = False
            for a in actions:
                if a[0] == "done":
                    done = True
                else:
                    _, phase, step, chunk_idx, data, meta = a
                    self._ring_send(op, phase, step, chunk_idx, data, meta)
            if done:
                try:
                    op.future.set_result(op.assemble())
                except Exception as e:  # noqa: BLE001 - surface assembly bugs
                    op.future.set_exception(e)
                with self._lock:
                    op.pumping = False
                return
        op.future.set_exception(err)

    def _ring_send(self, op: _RingOp, phase, step, chunk_idx, data, meta):
        nxt = op.members[(op.rank + 1) % op.n]

        def _sent(result, error, op=op):
            if error is not None:
                with self._lock:
                    self._ops.pop(op.key, None)
                op.future.set_exception(
                    RpcError(f"ring allreduce send failed: {error}"))

        self._rpc.async_callback(
            nxt, "__group_ring", _sent, self._name, op.key, phase, step,
            chunk_idx, data, meta)


class BucketedStream:
    """Caller handle of one streaming bucketed allreduce
    (:meth:`Group.bucketed_stream`): ``bounds`` is the per-bucket element
    ranges of the flat buffer (the launch units), ``launch(k)`` fires bucket
    ``k``'s sub-op once its slice is staged, ``finish()`` is called after
    the last launch, ``abort(err)`` errors the round from the caller's
    side.  ``future`` resolves like the barrier path's."""

    __slots__ = (
        "_group", "name", "future", "bounds", "_parent", "_pseq", "_sync_id",
        "_meta", "_wire", "_degenerate", "_dead",
    )

    def __init__(self, group, name, future):
        self._group = group
        self.name = name
        self.future = future
        self.bounds = ()
        self._parent = None
        self._pseq = None
        self._sync_id = None
        self._meta = None
        self._wire = None
        self._degenerate = None
        self._dead = False

    def launch(self, k: int):
        return self._group._stream_launch(self, k)

    def finish(self) -> None:
        self._group._stream_finish(self)

    def abort(self, err) -> None:
        self._group._stream_abort(self, err)
