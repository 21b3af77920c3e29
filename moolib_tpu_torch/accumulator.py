"""Accumulator: the asynchronous data-parallel gradient/state sync machine.

Counterpart of the reference's ``Accumulator`` (``src/accumulator.{h,cc}``,
bindings ``src/moolib.cc:1645-1872``): elastic data parallelism where peers
join/leave freely.  On every membership epoch the cohort elects a leader by
allreducing ``max(model_version, name)`` (``src/accumulator.cc:581-625``);
non-leaders request the model (+ user state: optimizer etc.) from the leader;
gradients are averaged cohort-wide with *virtual batch sizes* — a reduction
only "fires" once the summed batch size reaches ``virtual_batch_size``, so
the effective batch is stable no matter how many peers are alive
(``src/accumulator.cc:880-1078``; semantics ``examples/README.md:89-115``).

The user-facing wants/has protocol is identical to the reference::

    accumulator.update()                  # pump, every iteration
    if accumulator.wants_state():         # leader: someone needs user state
        accumulator.set_state({...})
    if accumulator.has_new_state():       # non-leader: got model + user state
        ... = accumulator.state()
    if accumulator.has_gradients():       # reduction finished
        grads = accumulator.gradients()   # averaged tree of tensors
        params = optimizer_step(params, grads)
        accumulator.set_parameters(params)
        accumulator.zero_gradients()
    elif accumulator.wants_gradients():
        accumulator.reduce_gradients(batch_size, grads)   # or skip_gradients()

As in the JAX package, gradients are *passed* to ``reduce_gradients`` (a
tree of tensors, e.g. ``{name: p.grad}``) and fetched with ``gradients()``,
and the model is an explicit tree handed back with ``set_parameters`` after
the optimizer step.  Reduction rides the Group's RPC allreduce (tree, flat
buckets or the chunked ring), or ``torch.distributed`` when the cohort is
the whole process group (``set_ici_backend``).

The port is byte-compatible with the JAX package's peers, so one cohort may
mix both:

- Trees flatten with ``utils.nest.tree_flatten`` (dict keys sorted, as
  ``jax.tree_util`` does): the flat layouts, q8 scale lists and ICI arrays
  mean the same leaf on every peer.
- The host arithmetic (the count protocol, the f32 folds, EF-q8, the wire
  finalize) is the JAX package's numpy, line for line; bf16 rounding goes
  through ``torch.bfloat16``, whose round-to-nearest-even equals ml_dtypes'.
- The model-sync blob pickles ``checkpoint.canonical_tree`` of **numpy**
  leaves, so a port leader and a JAX leader send the same bytes (and the
  same sha) for the same values.  Received numpy leaves become tensors on
  this peer's device (the device of its parameters).  bf16 leaves pickle as
  ml_dtypes arrays where ``ml_dtypes`` is importable and as CPU tensors
  otherwise; a JAX peer can read the latter only through torch.

The card seams: CUDA gradient leaves never reach numpy synchronously.  The
count path and the flat-bucket staging copy them non-blocking into pinned
leases of ``buckets``' pool with ONE CUDA event per call, waited on before
the host reads (``buckets_d2h_events_total``); ``gradients()`` returns
tensors on the device the parameters live on, each leaf one non-blocking
H2D copy out of a pinned result buffer.  No path catches a failed pinned
allocation, copy or collective and retries through ``.cpu()``.

The distributed-checkpoint plane (``enable_distributed_checkpoint``,
``checkpoint_tick``) speaks the JAX package's ``__accum_ckpt_begin`` /
``__accum_ckpt_report`` handlers, so a mixed cohort commits one checkpoint;
its captures snapshot the live tensors before ``begin_capture`` returns
(``checkpoint.snapshot``), since the next apply writes them in place.

The sharded hierarchical rounds (``set_sharded_allreduce``) and the
streaming consumer (``reduce_gradients`` of a ``buckets.GradientStream``)
are the JAX package's, op for op: same op names, ranges, owner rule and
meta, so sharded and streaming peers of either package share one round.
A gradient tree of ``DTensor`` leaves (a mesh host's in-mesh-reduced
gradients) is gathered in full onto this rank first, through
``parallel.collectives.gather_full``, which every rank of the mesh enters
in the same order (JAX: ``np.asarray`` of a sharded array).
"""

from __future__ import annotations

import collections
import hashlib
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import buckets, checkpoint, telemetry, utils
from .utils import nest
from .group import Group
from .rpc import Rpc, RpcError

# Reduction-machine metrics (docs/TELEMETRY.md).  Counters are process
# totals across every Accumulator instance; per-instance gauges carry the
# (accumulator, peer) labels so multi-peer single-process tests don't alias.
_REG = telemetry.get_registry()
_M_REDUCES = _REG.counter(
    "accum_reduces_total", "completed gradient reductions", ("plane",)
)
_M_REDUCE_BYTES = _REG.counter(
    "accum_reduce_bytes_total",
    "gradient bytes contributed (post-compression, at send time)",
    ("plane",),
)
_M_REDUCE_LATENCY = _REG.histogram(
    "accum_reduce_seconds", "gradient reduction round trip", ("plane",)
)
_M_ROUND_ERRORS = _REG.counter(
    "accum_round_errors_total", "reduction rounds that errored (churn, timeouts)"
)
_M_ELECTIONS = _REG.counter("accum_elections_total", "leader elections completed")
_M_IS_LEADER = _REG.gauge(
    "accum_is_leader", "1 while this peer leads its cohort", ("accumulator", "peer")
)
_M_VBATCH_FILL = _REG.gauge(
    "accum_virtual_batch_fill",
    "global batch count toward the virtual batch target (fraction)",
    ("accumulator", "peer"),
)
_M_RECOVERY_ACTIVE = _REG.gauge(
    "accum_recovery_active",
    "1 while this peer is mid-recovery for the current epoch (joining, "
    "re-electing, or model-syncing) — the autoscaler's scale-hold signal",
    ("accumulator", "peer"),
)
_M_GRADIENTS = _REG.counter(
    "accum_gradients_total", "gradient contributions in applied results"
)
_M_SKIPPED = _REG.counter(
    "accum_skipped_total", "skip contributions in applied results"
)
_M_STALE = _REG.counter(
    "accum_stale_results_total", "results consumed across an epoch boundary"
)
_M_DEAD_RESULTS = _REG.counter(
    "accum_dead_results_dropped_total",
    "results dropped unapplied because their epoch died before the caller took them",
)
# Chunked model sync (warm-rejoin plane, docs/RESILIENCE.md "Recovery
# budget"): bytes/chunks per direction, resumes, and zero-byte warm rejoins.
_M_SYNC_BYTES = _REG.counter(
    "accum_model_sync_bytes_total", "model-sync chunk bytes", ("direction",)
)
_M_SYNC_CHUNKS = _REG.counter(
    "accum_model_sync_chunks_total", "model-sync chunks", ("direction",)
)
_M_SYNC_RESUMES = _REG.counter(
    "accum_model_sync_resumes_total",
    "chunked model transfers resumed from a partial buffer (not from chunk 0)",
)
_M_WARM_REJOINS = _REG.counter(
    "accum_warm_rejoins_total",
    "restarts whose checkpoint-restored version matched the leader: synced "
    "with zero model-sync bytes",
)
# Distributed checkpoint coordination (docs/RESILIENCE.md "Distributed
# checkpoints"): checkpoint epochs the leader abandoned short of commit, and
# model-sync chunks a joiner satisfied from a locally-restored shard slice
# instead of the wire.
_M_CKPT_ABORTS = _REG.counter(
    "checkpoint_aborts_total",
    "checkpoint epochs abandoned before commit (missed boundary, membership "
    "change, member failure, or report deadline)",
)
_M_SLICE_PREFILL = _REG.counter(
    "accum_sync_slice_chunks_total",
    "model-sync chunks prefilled from a locally-restored checkpoint slice "
    "(bytes the resumable stream did NOT have to send)",
)
# Flat-bucket gradient data plane (docs/DESIGN.md "Gradient data plane"):
# per-round bucket counts/bytes, staging (tree-flatten -> flat buffer) time,
# and how long device-to-host transfer ran overlapped with staging.
_M_BUCKET_ROUNDS = _REG.counter(
    "accum_bucket_rounds_total", "gradient rounds shipped via flat buckets",
    ("plane",),
)
_M_BUCKETS = _REG.counter(
    "accum_buckets_total", "flat buckets shipped (one sub-op each)", ("plane",)
)
_M_BUCKET_BYTES = _REG.counter(
    "accum_bucket_bytes_total",
    "flat-bucket payload bytes contributed (post-compression, at send time)",
    ("plane",),
)
_M_BUCKET_FILL = _REG.histogram(
    "accum_bucket_fill_seconds",
    "gradient tree -> flat bucket staging (copy-in, dtype convert, EF-q8)",
)
_M_D2H_OVERLAP = _REG.histogram(
    "accum_d2h_overlap_seconds",
    "device-to-host transfer time overlapped with bucket staging (async "
    "copy_to_host issued for every leaf before the first bucket fills)",
)
_M_LAUNCH_LEAD = _REG.histogram(
    "accum_bucket_launch_lead_seconds",
    "how early each streamed bucket's wire op launched before the final "
    "bucket's launch (the barrier point a non-streaming round would have "
    "fired at): 0 for the last bucket, > 0 for every earlier one while the "
    "streaming gradient pipeline is hiding comm under the backward tail",
)
# Sharded hierarchical reduce: per-kind inter-host bytes (the
# reduce-scatter contribution vs the owned-shard redistribution), the
# fraction of the payload this host owns, and the wall time of the
# share-down (also observed by parallel.redistribute).
_M_INTERHOST = _REG.counter(
    "accum_interhost_bytes_total",
    "bytes shipped on the inter-host (RPC) plane for gradient rounds: "
    "kind='grad' is the reduce contribution at send time (post-compression; "
    "sharded rounds ship (N-1)/N of the flat payload vs the full tree's "
    "1/1), kind='gather' is the owned-shard result redistribution",
    ("kind",),
)
_M_SHARD_FRACTION = _REG.gauge(
    "accum_shard_fraction",
    "fraction of the flat gradient payload this host owns (reduces locally) "
    "in sharded rounds — ~1/N of the cohort",
    ("accumulator", "peer"),
)
_M_PSUM = _REG.histogram(
    "accum_psum_seconds",
    "host wall time in the in-mesh share-down / resharding of reduced "
    "tensors (parallel.redistribute and the sharded-round share-down)",
)
_M_H2D_BYTES = _REG.counter(
    "accum_result_h2d_bytes_total",
    "cohort-mean gradient bytes copied back to the card (pinned, non-blocking)",
)

_MODEL_PUSH_INTERVAL = 600.0  # reference: regular model broadcast every 600 s
_BUFFERS_PUSH_INTERVAL = 12.0  # reference: buffers broadcast every 12 s
_MODEL_REQUEST_RETRY = 2.0
# Chunk size for the streamed model sync; must only affect pacing, never
# semantics (the transfer is resumable at any chunk boundary).
_MODEL_CHUNK_BYTES = int(os.environ.get("MOOLIB_MODEL_CHUNK_BYTES", 1 << 20))


def _tree_add(a, b):
    return nest.tree_map(lambda x, y: x + y, a, b)


class GradientShardingError(RuntimeError):
    """The gradient tree's sharding changed between ``reduce_gradients``
    calls while the sharded reduce plane was active.

    The sharded layout (bucket cuts, per-host ranges) is cohort wire
    protocol, keyed on the sharding signature at first staging — a silent
    re-layout (or a silent fall-back to full-tree payloads) would desync the
    op shapes across hosts mid-epoch.  Fix the step to produce a stable
    sharding, or consume pending results and restart the plane."""


class _ShardedRound:
    """Book-keeping for one sharded hierarchical round: a scatter phase
    (one bucketed sub-op per owned range; the owner contributes None and
    folds its local slice into the wire partial) and a gather phase (the
    owner redistributes its true sum; everyone else contributes None).
    Completion is counted on the gather ops — gather g can only resolve
    after scatter g did (the owner's contribution depends on it), so all
    scatter work is transitively covered."""

    __slots__ = (
        "rank", "ranges", "layout", "treedef", "flat", "stats", "meta_group",
        "wire", "item", "round", "gather", "results", "meta", "err",
        "remaining",
    )

    def __init__(self, rank, ranges, layout, treedef, flat, stats,
                 meta_group, wire, item, remaining):
        self.rank = rank
        self.ranges = ranges
        self.layout = layout
        self.treedef = treedef
        self.flat = flat
        self.stats = stats
        self.meta_group = meta_group
        self.wire = wire
        self.item = item
        self.round = None
        self.gather = {}
        self.results = {}
        self.meta = None
        self.err = None
        self.remaining = remaining


def _has_dtensor(leaves) -> bool:
    """Any ``DTensor`` leaf?  (None can exist before torch's tensor package
    is imported, so that import is never paid here.)"""
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(l, mod.DTensor) for l in leaves)


def _host_array(leaf) -> np.ndarray:
    """A staged chunk leaf as numpy (a CPU tensor numpy cannot view, bf16,
    widens to f32 first)."""
    if isinstance(leaf, torch.Tensor) and isinstance(_leaf_dtype(leaf), torch.dtype):
        leaf = leaf.float()
    return buckets.host_view(leaf)


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64))


def _world_size() -> int:
    """Processes in the default ``torch.distributed`` group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _f32_any(x):
    """float32 of a host leaf or of a tensor on any device (kept there)."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return x.float()
    return _np_f32(x)


def _np_f32(x) -> np.ndarray:
    """A host leaf as float32 numpy (the JAX package's ``np.asarray(x,
    np.float32)``): CPU tensors of any dtype, bf16 included, and numpy.
    CUDA leaves are staged first (``Accumulator._host_f32``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x if x.dtype == torch.float32 else x.float()).numpy()
    return np.asarray(x, np.float32)


def _wire_name(dtype) -> Optional[str]:
    """A wire dtype's name: ``torch.bfloat16`` and ``jnp.bfloat16`` alike
    are ``"bfloat16"``; ``"int8"``/``np.int8`` is ``"int8"``."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    if isinstance(dtype, str):
        return {"bf16": "bfloat16"}.get(dtype, dtype)
    return np.dtype(dtype).name


_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1, "q8": 1}


def _to_wire(x, wire: str):
    """Round a float32 host leaf to the wire dtype: bf16 through
    ``torch.bfloat16`` (ml_dtypes' rounding, bit for bit), else numpy."""
    if wire == "bfloat16":
        if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
            return x
        a = np.ascontiguousarray(_np_f32(x))
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(torch.bfloat16)
    wd = np.dtype(wire)
    return x if getattr(x, "dtype", None) == wd else np.asarray(x).astype(wd)


def _cast(x, dt):
    """``x`` (f32, host numpy or a tensor) in the dtype ``dt`` recorded by
    :func:`_leaf_dtype`: a numpy dtype, or a torch dtype numpy lacks."""
    if isinstance(x, torch.Tensor):
        return x.to(dt if isinstance(dt, torch.dtype) else torch.from_numpy(
            np.empty(0, dt)).dtype)
    if isinstance(dt, torch.dtype):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dt)
    return np.asarray(x).astype(dt, copy=False)


def _leaf_bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def _tree_device(tree) -> Optional[torch.device]:
    """The device of the first tensor leaf, or None for a tree of host
    arrays (results then stay numpy)."""
    for leaf in nest.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def _blob_tree(tree):
    """``(tree, staged)``: the model-sync blob's tree with torch leaves as
    numpy (CUDA ones staged through pinned memory with one event; ``staged``
    says whether there were any), so the pickled bytes equal a JAX peer's
    for the same values (``checkpoint.host_leaf``: bf16 leaves become
    ml_dtypes arrays where that package imports, else stay CPU tensors)."""
    leaves, treedef = nest.tree_flatten(tree)
    staged, event = buckets.stage(
        [l.detach() if isinstance(l, torch.Tensor) else l for l in leaves])
    if event is not None:
        event.synchronize()
    return treedef.unflatten([checkpoint.host_leaf(l) for l in staged]), event is not None


def _adopt_tree(tree, device: Optional[torch.device]):
    """A received blob's tree on this peer: numpy leaves (and CPU tensors)
    become tensors on ``device``; with no device (a peer holding host
    arrays) the tree stays as it arrived."""
    if device is None:
        return tree
    return nest.tree_map(lambda x: checkpoint.leaf_to_device(x, device), tree)


def _to_device(tree, device: Optional[torch.device]):
    """The cohort result as the caller takes it: numpy leaves stay numpy
    when the parameters are host arrays; on a CPU device they become
    tensors (copied when read-only, e.g. views of receive buffers); on a
    card each leaf is one non-blocking H2D copy out of a pinned buffer
    (torch's caching host allocator keeps the buffer until the copy ran)."""
    if device is None:
        return tree
    nbytes = 0

    def leaf(x):
        nonlocal nbytes
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(x if x.flags.writeable else x.copy())
        else:
            t = x
        if t.device == device or (device.type == "cpu" and t.device.type == "cpu"):
            return t
        if t.device.type != "cpu":
            return t.to(device)
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        nbytes += pinned.numel() * pinned.element_size()
        return pinned.to(device, non_blocking=True)

    out = nest.tree_map(leaf, tree)
    if nbytes:
        _M_H2D_BYTES.inc(nbytes)
    return out


class _Round:
    """One in-flight reduction round.

    ``kind`` is one of:
      - ``"full"``  — single-phase: gradients + counts in one allreduce
        (used when no virtual batch size is set: one round, fires directly).
      - ``"count"`` — two-phase, phase 1: counts only (3 ints on the wire);
        ``local`` holds this peer's f32 gradient contribution, folded into
        the pending fire accumulator when the count result is applied.
      - ``"grad"``  — two-phase, phase 2: the one gradient allreduce per
        virtual batch; ``stats`` is the fire-time global-count snapshot
        (identical on every peer — derived from identical count results).
    """

    __slots__ = (
        "future", "done", "result", "error", "kind", "local", "stats", "plane", "t0",
        "ici_seq", "warming",
    )

    def __init__(self, future, kind="full", local=None, stats=None, plane="rpc"):
        self.future = future
        self.done = False
        self.result = None
        self.error = None
        self.kind = kind
        self.local = local
        self.stats = stats
        self.plane = plane  # "rpc" (the Group's allreduce) | "ici" (the collective)
        self.t0 = time.monotonic()
        self.ici_seq = None  # per-epoch ICI round index (lockstep across peers)
        # True while the round is inside the first-use warm barrier:
        # the no-progress heartbeat skips it (the barrier has its own bound).
        self.warming = False


class _IciWorker:
    """Single daemon-thread FIFO executor for ICI collectives.

    Not ``concurrent.futures``: that registers an atexit hook that JOINS its
    (non-daemon) workers, which deadlocks interpreter exit when a wedged
    collective never returns — the exact scenario the abort/timeout paths
    abandon a thread for.  A daemon thread is simply left behind."""

    def __init__(self, name: str):
        import queue

        self._q = queue.SimpleQueue()
        self._t = threading.Thread(target=self._run, name=name, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — tasks report via their round
                utils.log_error("ici worker: task raised unexpectedly")

    def submit(self, fn, *args) -> None:
        self._q.put((fn, args))

    def shutdown(self, wait: bool = False) -> None:
        self._q.put(None)


def _tree_nbytes(tree) -> int:
    total = 0
    for leaf in nest.tree_leaves(tree):
        n = getattr(leaf, "nbytes", None)  # numpy and torch: no transfer
        total += int(n) if n is not None else np.asarray(leaf).nbytes
    return total


def _leaf_dtype(g):
    """Leaf dtype without reading values (a CUDA leaf stays on the card): a
    numpy dtype, or the torch dtype itself where numpy has none
    (``torch.bfloat16``)."""
    dt = getattr(g, "dtype", None)
    if dt is None:
        return np.asarray(g).dtype
    try:
        return buckets.np_dtype(dt)
    except TypeError:
        return dt


class Accumulator:
    """See module docstring. API mirrors the reference's pybind surface."""

    def __init__(
        self,
        name: str,
        parameters,
        buffers=None,
        group: Optional[Group] = None,
        rpc: Optional[Rpc] = None,
    ):
        self._name = name
        self._params = parameters
        self._buffers = buffers
        self._lock = threading.RLock()

        self._standalone = group is None
        if group is None:
            self._rpc = rpc if rpc is not None else Rpc()
            self._group = Group(self._rpc, name)
        else:
            self._group = group
            self._rpc = group._rpc
        self._group.add_change_callback(self._on_group_change)
        # Every cohort peer is scrapable by the cohort aggregator
        # (__telemetry_snapshot / __telemetry_trace / __telemetry_profile);
        # idempotent when the Rpc is shared.
        telemetry.install_rpc_handlers(self._rpc)

        # model / election state
        self._model_version = 0
        self._version_callbacks: list = []
        self._last_notified_version: Optional[int] = None
        self._leader: Optional[str] = None
        self._is_leader = False
        self._election_future = None
        # Election repair (docs/RESILIENCE.md recovery budget): an election
        # allreduce that errors (timeout under load) used to leave this
        # peer leaderless FOREVER on a stable epoch — the membership never
        # changes again, so no new election ever fires.  A leaderless peer
        # now retries after this deadline: it queries members for the
        # already-agreed result (an allreduce completes only with every
        # member's contribution, so any completed result already includes
        # our vote) and re-issues the election for the all-failed case.
        self._election_retry_at: Optional[float] = None
        self._election_retry_interval = 5.0
        self._epoch_synced = False  # got (or am serving) the model this epoch
        self._staged_model = None  # incoming model update awaiting commit
        self._buffers_version = -1  # last applied buffers-push version
        self._last_model_request = 0.0
        self._last_model_push = 0.0
        self._last_buffers_push = 0.0

        # state (user blob) machinery.  Requesters queue as
        # (peer, have_version, resume_version, resume_chunks) tuples: the
        # advertised version enables the warm-rejoin fast path and the
        # resume fields let a transfer continue from the last acked chunk.
        self._state_requesters: List[Tuple[str, int, int, int]] = []
        self._received_state = None
        self._has_new_state = False

        # Chunked model sync (docs/RESILIENCE.md "Recovery budget").
        # Leader side: pickled-blob chunk cache keyed by model version, and
        # the set of peers with a send chain in flight (re-requests while a
        # transfer runs must not start a second chain).  Requester side: the
        # partial chunk buffer — keyed by (version, sha), NOT by epoch, so a
        # transfer interrupted by leader death resumes from the last acked
        # chunk under the new epoch's leader when the bytes still match.
        self._model_chunk_bytes = _MODEL_CHUNK_BYTES
        self._sync_cache: Optional[Tuple[int, str, List[bytes]]] = None
        self._active_transfers: Dict[str, Tuple[Any, int]] = {}
        self._in_transfer: Optional[Dict[str, Any]] = None
        self._model_sync_bytes_rx = 0
        self._model_sync_bytes_tx = 0
        self._warm_rejoin = False
        # Count of results consumed across an epoch boundary: each one
        # mutates params WITHOUT bumping the version (see zero_gradients),
        # so while nonzero our version number no longer names our bytes.  A
        # stale peer never advertises its version for the current-model
        # fast path (it needs the leader's full sync to reconverge) — and a
        # stale peer that WINS the election bumps its version by this count
        # first: its params are exactly that many cohort results ahead, so
        # the bump restores the version-names-bytes invariant instead of
        # letting two different byte strings share one version number.
        self._stale_applies = 0

        # Distributed checkpoint plane (docs/RESILIENCE.md "Distributed
        # checkpoints"): the leader broadcasts a FUTURE target step; every
        # member captures when its applied-step count reaches exactly that
        # target, reports its shard digest back, and the leader
        # two-phase-commits the cohort manifest once the full quorum
        # agrees.  File I/O runs on the checkpointer's worker or outside
        # _lock — never under it.
        self._ckptr = None  # DistributedCheckpointer
        self._ckpt_interval = 0.0
        self._ckpt_lead = 2  # steps of advance notice in the begin broadcast
        self._ckpt_timeout = 60.0  # leader: report-collection deadline
        self._ckpt_last_begin = 0.0
        self._ckpt_seq = 0
        self._ckpt_aux_fn = None  # leader-evaluated, broadcast with begin
        self._ckpt_pending: Optional[Dict[str, Any]] = None  # member side
        self._ckpt_open: Optional[Dict[str, Any]] = None  # leader side
        # Warm-rejoin slice serving: (version, sha16, start, bytes, total)
        # of a locally-held byte range of the leader's sync blob (e.g. this
        # host's re-cut shard slice of a restored checkpoint).
        self._sync_slice: Optional[Tuple[int, str, int, bytes, int]] = None

        # Recovery phase accounting (telemetry.recovery): milestone stamps
        # along the rejoin chain; _rec_phases keeps the FIRST occurrence of
        # each phase (the process-restart chain the soak decomposes), the
        # shared recovery_seconds histogram gets every occurrence.
        self._rec_t_init = time.monotonic()
        self._rec_t_active: Optional[float] = None
        self._rec_t_epoch: Optional[float] = None
        self._rec_t_elect: Optional[float] = None
        self._rec_t_synced: Optional[float] = None
        self._rec_t_first_reduce: Optional[float] = None
        self._rec_phases: Dict[str, float] = {}
        # Last recovery_active value exported to the gauge (set on change
        # only); None forces the first update() to export.
        self._recovery_active_gauge: Optional[bool] = None
        self._decommissioned = False

        # gradient machinery
        self._virtual_batch_size: Optional[int] = None
        self._parallel_gradients = 1
        self._wire_dtype = None  # wire name, e.g. "bfloat16": halves allreduce bytes
        self._wire_q8 = False  # int8 + error feedback (4x compression)
        self._q_residual = None  # EF residual carried between rounds
        self._ring_q8_logged = False  # one-shot notice for the q8-x-ring mode
        # Chunked ring allreduce for the big gradient payload (None = auto by
        # model size vs MOOLIB_RING_THRESHOLD). The choice must be identical
        # cohort-wide: it is derived from config + the synced model only.
        self._chunked_allreduce: Optional[bool] = None
        self._ring_size_cache: Optional[int] = None
        # Flat-bucket data plane (docs/DESIGN.md "Gradient data plane"):
        # layout cache per (treedef, shapes, dtype) — flattening happens
        # once per model shape, every round reuses the layout and the
        # refcount-guarded buffer pool in moolib_tpu.buckets.
        self._flat_layouts: Dict = {}
        self._bucketed = True  # False = legacy per-leaf dict payloads
        # Sharded hierarchical reduce: off by default (wire protocol — every
        # cohort peer must agree).  Layouts are cached per (treedef, shapes,
        # dtype, bucket size) and guarded by the gradient tree's sharding
        # signature: a mid-run sharding change raises
        # a GradientShardingError, never a silent re-layout.
        self._sharded = False
        self._sharded_layouts: Dict = {}
        self._last_launch_leads: List[float] = []
        # Debug checksums (reference src/accumulator.cc:324-370): verify the
        # applied gradient result is bit-identical cohort-wide per round.
        self._debug_checksums = False
        self._checksum_divergences = 0
        self._checksum_failures = 0  # verify rounds that errored/timed out
        # In-flight reduction rounds, oldest first.  With
        # set_parallel_gradients(n) up to n rounds overlap; results are
        # applied strictly in issue order — the Group sequences same-name ops
        # per epoch, so the order is identical on every peer (reference
        # pipelining guarantee, src/moolib.cc:1830-1842).
        self._inflight: collections.deque = collections.deque()
        self._accum_grads = None
        self._accum_stats = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
        # Two-phase virtual batching (reference src/accumulator.cc:1005-1078):
        # local f32 gradient sum + global counts pending the next fire.
        self._fire_accum = None
        self._fire_stats = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
        # Collective backend ("ICI", the JAX package's name): one
        # torch.distributed all_reduce instead of the RPC tree, when the
        # cohort is the static process group.  _ici_fns records the flat
        # sizes already warmed (the first collective of a size barriers).
        self._use_ici = False
        self._ici_fns: Dict = {}
        self._ici_executor = None  # lazily-created single-thread FIFO
        # A collective whose cohort member died mid-round can HANG in the
        # runtime (a gloo/NCCL rendezvous has no membership notion). The
        # update() pump times such rounds out so the train loop recovers on
        # the RPC plane (the elastic RPC world vs the collective's static
        # process group).
        self._ici_timeout = 60.0
        # Wedged-ALIVE-peer escalation: the timeout above is membership-gated, so a peer whose collective thread is
        # wedged while its RPC plane keeps pinging the broker would stall
        # every round forever.  Each peer whose oldest in-flight ICI round
        # makes no progress past _ici_progress_bound (with membership
        # intact) proposes an abort to the whole cohort over the RPC plane;
        # only a UNANIMOUS proposal set aborts the round (symmetric — every
        # peer reaches the same unanimity), after which the ICI plane is
        # suspended for the current membership epoch and rounds ride the
        # RPC tree (the wedged peer's RPC plane still works).
        self._ici_progress_bound = 20.0
        # Adaptive floor under the bound: a healthy collective on slow links
        # can legitimately take a while, and ALL peers of a healthy-but-slow
        # round would propose together — so the effective bound stretches to
        # several times the last successful round's duration, and the clock
        # only starts once the collective actually begins executing (the
        # first-use warm barrier is restamped out in
        # _ici_allreduce, which has its own 120 s barrier bound).
        self._ici_last_round_s = 0.0
        self._ici_round_seq = 0  # per-epoch; lockstep across peers
        self._ici_abort_proposals: Dict[Tuple[int, int], set] = {}
        self._ici_abort_sent: set = set()
        self._ici_aborts = 0
        self._ici_suspended_epoch = None
        # Observability (plane choice must be visible):
        # completed reduction rounds per data plane, bytes contributed per
        # plane (post-compression payloads at send time), last plane used.
        self._ici_reduces = 0
        # Per-instance observability of the port (debug_info): round times
        # by kind (issue to apply, last 256), elections won or learned, the
        # CUDA staging calls (each records exactly one D2H event), and the
        # sha of the last model-sync blob served or committed.
        self._round_ms = {k: collections.deque(maxlen=256) for k in ("count", "grad", "full")}
        self._elections = 0
        self._d2h_calls = 0
        self._last_sync_sha: Optional[str] = None
        self._last_sync_ms: Optional[float] = None  # election to commit
        self._rpc_reduces = 0
        self._reduce_bytes = {"ici": 0, "rpc": 0}
        self._last_plane: Optional[str] = None
        self._grad_dtypes = None
        # Where gradients() hands results back: the device of the last
        # contributed tensors (else of the parameters); the device copy of
        # the current result is made once, on first request.
        self._grad_device: Optional[torch.device] = None
        self._result_on_device = None
        self._has_gradients = False
        self._result_grads = None
        self._result_stats: Dict[str, int] = {}
        self._result_epoch = None  # group sync_id the current result is from

        self._register_service()

    # ----------------------------------------------------------------- setup
    def _register_service(self):
        registry = getattr(self._rpc, "_moolib_accums", None)
        if registry is None:
            registry = {}
            self._rpc._moolib_accums = registry
            rpc = self._rpc

            def dispatch(method_name):
                def handler(accum_name, *args):
                    a = registry.get(accum_name)
                    if a is None:
                        raise RpcError(f"no accumulator {accum_name!r} on this peer")
                    return getattr(a, method_name)(*args)

                return handler

            rpc.define("__accum_request_model", dispatch("_on_request_model"))
            rpc.define("__accum_model_chunk", dispatch("_on_model_chunk"))
            rpc.define("__accum_model_update", dispatch("_on_model_update"))
            rpc.define("__accum_leader_query", dispatch("_on_leader_query"))
            rpc.define("__accum_buffers_update", dispatch("_on_buffers_update"))
            rpc.define("__accum_ici_abort", dispatch("_on_ici_abort"))
            rpc.define("__accum_ckpt_begin", dispatch("_on_ckpt_begin"))
            rpc.define("__accum_ckpt_report", dispatch("_on_ckpt_report"))
        if self._name in registry:
            raise RpcError(f"accumulator {self._name!r} already exists on this Rpc")
        registry[self._name] = self

    def connect(self, address) -> None:
        """Connect to the broker coordinating this cohort.  A list (or
        comma-separated string) of addresses enables broker failover: the
        group dials every broker and re-targets its pings to the
        highest-generation survivor when the primary dies
        (``Group.set_brokers``, docs/RESILIENCE.md "Broker failover")."""
        if isinstance(address, str) and "," in address:
            address = [a.strip() for a in address.split(",") if a.strip()]
        if isinstance(address, (list, tuple)):
            if len(address) == 1:
                self._rpc.connect(address[0])
            else:
                self._group.set_brokers(list(address))
            return
        self._rpc.connect(address)

    def listen(self, address: str = "127.0.0.1:0") -> None:
        """Standalone-mode passthrough: listen on the internal Rpc so other
        peers can reach this one (required before connect in multi-peer use)."""
        self._rpc.listen(address)

    def set_name(self, name: str) -> None:
        """Standalone-mode passthrough: set this peer's Rpc name."""
        self._rpc.set_name(name)

    # ------------------------------------------------------------- accessors
    def connected(self) -> bool:
        with self._lock:
            return self._group.active() and self._leader is not None and self._epoch_synced

    def recovery_active(self) -> bool:
        """True while this peer is mid-recovery for the CURRENT epoch:
        joining, leaderless, or model-unsynced.  Unlike ``recovery_info()``
        (which keeps the FIRST restart's phase breakdown forever), this
        re-arms on every membership epoch — it is the scale-hold signal the
        autoscaler reads so a resize never races a rejoin in progress."""
        return not self.connected()

    def is_leader(self) -> bool:
        return self._is_leader

    @property
    def rpc(self) -> Rpc:
        """The underlying Rpc (serving-plane publishers ride the learner's
        existing peer identity and connections)."""
        return self._rpc

    def get_leader(self) -> Optional[str]:
        return self._leader

    def model_version(self) -> int:
        return self._model_version

    def set_model_version(self, n: int) -> None:
        """Set after restoring a checkpoint so leader election prefers the
        restored peer (reference ``src/moolib.cc:1808-1821``)."""
        self._model_version = int(n)
        self._notify_version()

    def add_model_version_callback(self, cb) -> None:
        """Serving-plane hook: ``cb(version)`` fires whenever the model
        version advances (gradient applies, staged-model commits, checkpoint
        restores) — from the ``update()`` pump, OUTSIDE the accumulator
        lock, so the callback may call back into this accumulator.  The lm
        example uses it to drive ``serving.ModelPublisher.publish`` at a
        step cadence: the learner announces fresh weights and serving
        replicas hot-swap with zero downtime (``moolib_tpu.serving``)."""
        self._version_callbacks.append(cb)

    def _notify_version(self) -> None:
        if not self._version_callbacks:
            return
        v = self._model_version
        if v == self._last_notified_version:
            return
        self._last_notified_version = v
        for cb in self._version_callbacks:
            try:
                cb(v)
            except Exception:  # noqa: BLE001 — a serving-side hiccup must
                utils.log_error("model version callback failed")  # not stop training

    def set_virtual_batch_size(self, n: int) -> None:
        self._virtual_batch_size = int(n)

    def set_parallel_gradients(self, n: int) -> None:
        """Allow ``n`` gradient reductions in flight at once.

        With n > 1 the train loop can keep computing (gradients up to n model
        versions old) while earlier reductions are still on the wire; results
        are applied in the same order on all peers (reference
        ``src/moolib.cc:1830-1842``, ``src/accumulator.cc:251-256``)."""
        if n < 1:
            raise ValueError("parallel_gradients must be >= 1")
        self._parallel_gradients = int(n)

    def set_wire_dtype(self, dtype) -> None:
        """Compress gradients on the wire (beyond-reference extension — the
        tree allreduce rides DCN/TCP where bytes are the bottleneck).

        - ``torch.bfloat16`` (or ``"bfloat16"``): cast leaves; each hop
          accumulates in f32 and re-rounds, so traffic halves at negligible
          quality cost.
        - ``"int8"`` (or ``np.int8``): 4x compression via per-leaf absmax
          quantization with **error feedback** — the local quantization
          residual is carried into the next contribution, making the
          compression unbiased over time (the standard EF-SGD trick).
        """
        self._wire_dtype = _wire_name(dtype)
        self._wire_q8 = self._wire_dtype == "int8"
        self._q_residual = None

    def set_ici_timeout(self, seconds: float) -> None:
        """Age at which an in-flight collective round is errored — but only
        once the cohort membership no longer matches the process set (the
        broker evicted a peer): the recovery path when a member dies
        mid-collective and the runtime rendezvous hangs.  A slow round in a
        healthy full cohort is never unilaterally timed out."""
        self._ici_timeout = float(seconds)

    def set_ici_progress_bound(self, seconds: float) -> None:
        """Age at which a no-progress ICI round (membership INTACT) makes
        this peer propose a cohort-wide abort over the RPC plane.  The abort
        only happens when every member proposes it (unanimity — symmetric
        by construction), covering the wedged-but-alive-peer case the
        membership-gated ``set_ici_timeout`` deliberately does not: a peer
        that keeps pinging the broker while its collective thread is stuck
        (runtime wedge, GC pause).  After an abort the ICI plane is
        suspended for the current membership epoch; rounds ride the RPC
        tree until the cohort changes.

        Healthy-but-slow rounds are protected twice over: the first-use
        warm barrier is exempt from the clock entirely (it has its own
        120 s bound), and the effective bound stretches to 4x the last
        successful round's duration so a configured floor tuned for fast
        rounds cannot abort a legitimately slow collective."""
        self._ici_progress_bound = float(seconds)

    def set_debug_checksums(self, enabled: bool = True) -> None:
        """CRC32-verify every applied gradient result across the cohort
        (reference debug checksums, ``src/accumulator.cc:324-370``).
        Enable on every peer or on none; divergences are logged and counted
        in ``debug_info()``.

        Cost: beyond the tiny verify allreduce, every gradient round
        synchronously copies the full result to host and CRCs it while
        holding the accumulator lock — for large models this stalls
        concurrent update()/reduce_gradients() callers noticeably.  A
        debugging tool, not a production setting.
        """
        self._debug_checksums = bool(enabled)

    def set_chunked_allreduce(self, enabled: Optional[bool]) -> None:
        """Route the big gradient allreduce over the Group's chunked ring
        (reduce-scatter + all-gather) instead of the binary tree.

        ``None`` (default) defers to ``Group.ring_auto``: ring once the f32
        gradient payload exceeds ``MOOLIB_RING_THRESHOLD`` bytes (1 MiB
        default) AND the cohort has >= 3 members spanning more than one
        machine — same-host cohorts ride memfd zero-copy where the tree
        wins wall-clock.  The ring spreads
        wire bytes evenly across the cohort (``2(n-1)/n`` payloads per peer vs
        the tree root's 2) and pipelines chunks, which is what large models
        need on DCN.  Must be configured identically on every peer.

        ``int8`` wire compression composes with the ring without losing the
        error-feedback contract: quantization happens once at the
        contributor (where the residual lives), partial sums accumulate in
        f32, and hops transport bf16 — each hop re-rounds the partial sum
        (small zero-mean rounding, no residual), unlike per-hop int8
        re-quantization, which would silently drop EF.  Net wire cost vs
        the tree's q8: 2x compression instead of 4x, with the EF contract
        intact and strictly less hop noise than the tree path's per-hop int8
        re-quantization.
        """
        self._chunked_allreduce = enabled

    def _use_ring_locked(self) -> bool:
        if self._chunked_allreduce is not None:
            return self._chunked_allreduce
        if self._ring_size_cache is None:
            leaves = nest.tree_leaves(self._params)
            self._ring_size_cache = sum(_numel(l) for l in leaves) * 4
        # Environment-aware auto rule (payload, cohort size, same-host vs
        # DCN) lives in ONE place — Group.ring_auto — and is deterministic
        # cohort-wide (inputs come from the broker's epoch push).
        return self._group.ring_auto(self._ring_size_cache)

    def _ring_wire_locked(self):
        if self._wire_q8:
            # Per-hop int8 re-quantization of partial sums would drop the
            # error-feedback residual (EF state is per-contributor); instead
            # contributions are EF-quantized at the source
            # (_ring_q8_contrib) and hops transport bf16, accumulating f32.
            if not self._ring_q8_logged:
                self._ring_q8_logged = True
                utils.log_info(
                    "accumulator %s: int8 wire + chunked ring -> "
                    "contributor-side EF quantization with bf16 hop "
                    "transport (2x wire compression; EF preserved)",
                    self._name,
                )
            return "bfloat16"
        return self._wire_dtype

    def _ring_q8_contrib(self, gradients):
        """q8 x ring: run error-feedback quantization where the residual
        lives (this contributor), then hand the ring the dequantized f32
        grid values — the EF contract survives the path switch, with only
        bf16 hop re-rounding on the partial sums (no residual needed for
        that; see set_chunked_allreduce docstring.  The tree path
        quantizes in _fire/_start instead)."""
        if gradients is None or not self._wire_q8:
            return gradients
        q, self._q_residual = _quantize_q8(gradients, self._q_residual)
        return _dequantize_q8(q)

    def _ring_template_locked(self):
        """Shape/dtype template for a skip (None) ring contribution: the
        gradient tree matches the parameter tree by construction.  Broadcast
        views cost no memory — the ring only reads shapes off a template."""
        return nest.tree_map(
            lambda p: np.broadcast_to(np.float32(0.0), tuple(p.shape)), self._params
        )

    def set_bucketed_allreduce(self, enabled: bool = True) -> None:
        """Route RPC-plane gradient rounds through the flat-bucket data
        plane (default ON): the gradient tree is flattened once per
        (treedef, shapes, dtype) into fixed-size buckets backed by reusable
        host buffers, each bucket rides the tree/ring as its own pipelined
        op, and EF-q8 runs once, vectorized on the flat buffer.  Must be set
        identically on every peer (the payload layout is wire protocol);
        ``False`` restores the legacy per-leaf dict payloads.  Bucket size:
        ``moolib_tpu.buckets.set_bucket_bytes`` / ``MOOLIB_BUCKET_BYTES``."""
        self._bucketed = bool(enabled)

    def set_sharded_allreduce(self, enabled: bool = True) -> None:
        """Shard the RPC-plane gradient reduce across the cohort: each of
        the N hosts owns a disjoint ~1/N range of the flat payload.  A round
        is a reduce-scatter — every host ships only the N-1 ranges it does
        NOT own, the owner contributes nothing and folds its local slice
        into the wire partial — followed by an all-gather of the owned true
        sums.  Contributed gradient bytes per host drop from 1x to (N-1)/N
        x the flat payload; ``accum_interhost_bytes_total{kind}`` is the
        measured artifact.

        Must be set identically on every peer (op names and range boundaries
        are wire protocol).  Composes with wire compression and virtual
        batching; the collective plane supersedes it when eligible; the
        chunked-ring setting is ignored (the scatter already is the ring's
        reduce-scatter half, minus the hop latency).  Requires the bucketed
        data plane."""
        self._sharded = bool(enabled)

    @staticmethod
    def _leaf_spec(leaf):
        """(shape, dtype) of a gradient leaf WITHOUT forcing a device
        transfer (tensors carry both; the dtype as :func:`_leaf_dtype`)."""
        s = getattr(leaf, "shape", None)
        if s is None or getattr(leaf, "dtype", None) is None:
            a = np.asarray(leaf)
            return a.shape, a.dtype
        return tuple(s), _leaf_dtype(leaf)

    def _flat_layout(self, treedef, shapes, dtype):
        key = (treedef, tuple(shapes), np.dtype(dtype).str, buckets.bucket_bytes())
        layout = self._flat_layouts.get(key)
        if layout is None:
            layout = buckets.BucketLayout(shapes, dtype)
            self._flat_layouts[key] = layout
        return layout

    def _sharded_flat_layout(self, treedef, shapes, dtype, shardings):
        """Shard-pinned layout for the sharded reduce plane, cached per
        (treedef, shapes, dtype, bucket size) and GUARDED by the gradient
        tree's sharding signature: a later call whose leaves carry a
        different sharding raises :class:`GradientShardingError` — the
        layout is cohort wire protocol, so a silent re-layout (or a silent
        fall-back to full-tree payloads) would desync op shapes across hosts
        mid-epoch.  ``shardings`` is the flat per-leaf list (``None``
        entries for plain and replicated leaves): the shardings of a
        ``DTensor`` tree, or the stream's declared shardings."""
        key = (treedef, tuple(shapes), np.dtype(dtype).str, buckets.bucket_bytes())
        sig = tuple(
            buckets.sharding_signature(s, sh)
            for s, sh in zip(shapes, shardings)
        )
        layout = self._sharded_layouts.get(key)
        if layout is not None:
            if layout.shard_sig != sig:
                raise GradientShardingError(
                    f"accumulator {self._name}: gradient sharding changed "
                    f"mid-run — first staged with signature "
                    f"{layout.shard_sig!r}, now {sig!r}.  The sharded-reduce "
                    "layout is cohort wire protocol; produce a stable "
                    "sharding from the train step (or disable "
                    "set_sharded_allreduce before changing it)"
                )
            return layout
        layout = buckets.BucketLayout.from_shardings(
            treedef, shapes, list(shardings), dtype,
        )
        self._sharded_layouts[key] = layout
        return layout

    def _flat_stage_dtype(self, treedef, specs, ring: bool,
                          keep_existing: bool = False):
        """Staging dtype for the flat-bucket path, or None when the tree is
        not flat-eligible (mixed leaf dtypes without wire compression).
        Compressed wire — and the ring, matching its legacy contract —
        accumulates in f32: the true leaf dtypes are recorded in
        ``_grad_dtypes`` for the restore (skip rounds keep an existing
        record, set by the round whose gradients they stand in for)."""
        if ring or self._wire_dtype is not None:
            if not (keep_existing and self._grad_dtypes is not None):
                self._grad_dtypes = treedef.unflatten([d for _, d in specs])
            return np.float32
        dtypes = {d for _, d in specs}
        if len(dtypes) != 1:
            return None
        dtype = dtypes.pop()
        # A dtype numpy lacks (bf16 without wire compression) keeps the
        # legacy per-leaf payload, as mixed dtypes do.
        return None if isinstance(dtype, torch.dtype) else dtype

    def _host_f32(self, gradients):
        """The gradient tree as host float32 numpy: the count path's local
        contribution and the payloads of the legacy paths.  Host leaves are
        copied (a tensor may be overwritten in place by the next backward;
        the JAX package's arrays could not be).  CUDA leaves are copied
        non-blocking into ONE pinned lease from ``buckets``' pool, with ONE
        event for the call, waited on here."""
        leaves, treedef = nest.tree_flatten(gradients)
        if not any(buckets.on_card(l) for l in leaves):
            return treedef.unflatten([np.array(_np_f32(l)) for l in leaves])
        layout = buckets.BucketLayout([tuple(l.shape) for l in leaves], np.float32)
        flat = buckets.lease(layout.total, np.float32, pinned=True)
        layout.fill(flat, [l if buckets.on_card(l) else _np_f32(l) for l in leaves]).synchronize()
        self._d2h_calls += 1
        out = treedef.unflatten(layout.unflatten(flat))
        buckets.release(flat)  # eager offer: the views keep it out of reuse
        return out

    def _stage_flat(self, gradients, ring: bool, sharded: bool = False,
                    shardings=None):
        """Flatten a gradient pytree into a pooled flat host buffer.

        Returns ``(flat, layout, treedef)`` or None when the tree is not
        flat-eligible (see ``_flat_stage_dtype`` — those rounds keep the
        legacy per-leaf payload, bit-identical to before).
        CUDA leaves copy non-blocking into a pinned lease (dtype conversion
        fused into that copy, on the card) and the fill records ONE event,
        waited on before EF-q8 or the wire reads the buffer
        (``BucketLayout.fill``); host leaves copy in exactly once.  EF-q8
        runs here, once, on the flat buffer with one flat residual (see
        buckets.ef_quantize_flat).  With ``sharded`` the layout is the
        shard-pinned one of ``shardings`` (per leaf; None: unsharded)."""
        leaves, treedef = nest.tree_flatten(gradients)
        if not leaves:
            return None
        specs = [self._leaf_spec(l) for l in leaves]
        stage_dtype = self._flat_stage_dtype(treedef, specs, ring)
        if stage_dtype is None:
            return None
        t0 = time.monotonic()
        d2h = any(buckets.on_card(l) for l in leaves)
        # A CPU tensor numpy cannot view (bf16) widens first; fill() reads
        # the rest as numpy views.
        leaves = [l.float() if isinstance(l, torch.Tensor) and not buckets.on_card(l)
                  and isinstance(_leaf_dtype(l), torch.dtype) else l for l in leaves]
        t_fill = time.monotonic()
        if sharded:
            layout = self._sharded_flat_layout(
                treedef, [s for s, _ in specs], stage_dtype,
                shardings if shardings is not None else [None] * len(leaves),
            )
        else:
            layout = self._flat_layout(treedef, [s for s, _ in specs], stage_dtype)
        flat = buckets.lease(layout.total, stage_dtype, pinned=d2h)
        event = layout.fill(flat, leaves)
        if event is not None:
            event.synchronize()
            self._d2h_calls += 1
        if self._wire_q8:
            residual = self._q_residual if isinstance(self._q_residual, np.ndarray) else None
            self._q_residual = buckets.ef_quantize_flat(flat, residual, layout.bounds)
        now = time.monotonic()
        # fill = staging (copy-in, the event wait, q8); d2h_overlap = the
        # same window when CUDA leaves were staged.
        _M_BUCKET_FILL.observe(now - t_fill)
        if d2h:
            _M_D2H_OVERLAP.observe(now - t0)
        return flat, layout, treedef

    def _stage_flat_skip(self, ring: bool):
        """Skip-round layout from the parameter tree (gradient trees match
        the param tree by construction — the same assumption the ring
        template relies on).  Returns ``(None, layout, treedef)`` or None
        when params are not flat-eligible."""
        leaves, treedef = nest.tree_flatten(self._params)
        if not leaves:
            return None
        specs = [self._leaf_spec(l) for l in leaves]
        stage_dtype = self._flat_stage_dtype(treedef, specs, ring, keep_existing=True)
        if stage_dtype is None:
            return None
        return None, self._flat_layout(treedef, [s for s, _ in specs], stage_dtype), treedef

    def _start_flat_round(self, kind: str, stats: Dict[str, int], staged,
                          use_ring: bool, fire_stats=None) -> None:
        """Issue one flat-bucket gradient round on the RPC plane (tree
        buckets or bucket-aligned ring chunks).  ``staged`` is the
        ``(flat, layout, treedef)`` from ``_stage_flat``/``_stage_flat_skip``."""
        flat, layout, treedef = staged
        with self._lock:
            if kind == "full":
                # Direct contributions obey the wants_gradients contract;
                # fire ("grad") rounds are issued by the drain itself and
                # bypass the guards exactly like the legacy fire path.
                if not self.connected():
                    utils.log_verbose(
                        "accumulator %s: dropping gradient contribution (not connected)",
                        self._name,
                    )
                    buckets.release(flat)
                    return
                if len(self._inflight) >= self._parallel_gradients:
                    buckets.release(flat)
                    raise RpcError(
                        f"{len(self._inflight)} gradient reductions already in flight "
                        f"(parallel_gradients={self._parallel_gradients})"
                    )
                if self._has_gradients:
                    buckets.release(flat)
                    raise RpcError("unconsumed gradients; call zero_gradients() first")
            template = None
            if flat is None:
                template = np.broadcast_to(
                    np.zeros((), layout.dtype), (layout.total,)
                )
            if use_ring:
                wire = self._ring_wire_locked()
                fut = self._group.all_reduce(
                    f"__accum_grad:{self._name}", flat, op="sum",
                    meta=dict(stats), meta_op=_count_reduce_op,
                    wire=wire, chunked=True, chunk_align=layout.bucket_elems,
                    template=template, owned=True,
                )
            else:
                wire, _ = self._wire_locked(layout)
                fut = self._group.all_reduce(
                    f"__accum_grad:{self._name}", flat, op="sum",
                    meta=dict(stats), meta_op=_count_reduce_op,
                    wire=wire, bucketed=True, template=template, owned=True,
                )
            round_ = _Round(fut, kind=kind, stats=fire_stats)
            if flat is not None:
                item = _ITEMSIZE[wire] if wire else layout.dtype.itemsize
                nb = layout.total * item
                self._reduce_bytes["rpc"] += nb
                _M_REDUCE_BYTES.inc(nb, plane="rpc")
                _M_BUCKET_BYTES.inc(nb, plane="rpc")
                _M_INTERHOST.inc(nb, kind="grad")
            _M_BUCKET_ROUNDS.inc(plane="rpc")
            _M_BUCKETS.inc(layout.n_buckets, plane="rpc")
            self._inflight.append(round_)
            # The ring holds chunk views of the staged flat; recycle it when
            # the round resolves (tree rounds recycle inside the group's
            # bucket machinery, which took ownership via owned=True).
            fut.add_done_callback(
                lambda f, r=round_, td=treedef, lo=layout,
                fl=(flat if use_ring else None):
                    self._on_flat_round_done(r, f, td, lo, fl)
            )

    def _on_flat_round_done(self, round_, fut, treedef, layout, release_flat=None):
        """Adapter: a flat round resolves to ``(flat_or_None, meta)``;
        unflatten (views, no copy) and normalize into the payload-dict shape
        the drain logic consumes."""
        err = fut.exception()
        buckets.release(release_flat)
        norm = None
        if err is None:
            value, meta = fut.result(0)
            grads = None
            if value is not None:
                flat = np.asarray(value)
                grads = treedef.unflatten(layout.unflatten(flat))
            norm = {"grads": grads, "wire": None}
            norm.update(meta)
        with self._lock:
            round_.done = True
            round_.error = err
            round_.result = norm
            if err is None:
                _M_REDUCE_LATENCY.observe(
                    time.monotonic() - round_.t0, plane=round_.plane
                )
            self._drain_rounds_locked()

    # ---------------------------------------------------- streaming reduce
    def _materialize_stream(self, stream):
        """Collect every chunk of a GradientStream and rebuild the full
        gradient tree — the fall-back whenever a stream arrives on a path
        that needs the whole tree at once (the collective plane, virtual
        batching, chunked ring, legacy payloads): bit-identical to a barrier
        contribution, just without the launch lead."""
        leaves = [None] * stream.n_leaves
        timeout = getattr(self._group, "_timeout", 60.0)
        while True:
            chunk = stream.next_chunk(timeout)
            if chunk is None:
                break
            lo, ls = chunk
            leaves[lo:lo + len(ls)] = ls
        return stream.treedef.unflatten(leaves)

    def _streaming_layout(self, stream):
        """(layout, stage_dtype, treedef) for a streaming round, or None
        when the stream cannot take the streaming path (mixed dtypes without
        wire compression; sharded plane without sharding info on a cold
        layout cache) — the caller then materializes and runs the barrier
        path, which is bit-identical."""
        treedef = stream.treedef
        specs = list(zip(stream.shapes, stream.dtypes))
        if not specs:
            return None
        stage_dtype = self._flat_stage_dtype(treedef, specs, ring=False)
        if stage_dtype is None:
            return None
        shapes = [s for s, _ in specs]
        if self._sharded:
            if stream.shardings is not None:
                layout = self._sharded_flat_layout(
                    treedef, shapes, stage_dtype, stream.shardings
                )
            else:
                key = (treedef, tuple(shapes), np.dtype(stage_dtype).str,
                       buckets.bucket_bytes())
                layout = self._sharded_layouts.get(key)
                if layout is None:
                    # No sharding info and no prior round to key the wire
                    # layout off: establish it via one barrier round first.
                    return None
        else:
            layout = self._flat_layout(treedef, shapes, stage_dtype)
        return layout, stage_dtype, treedef

    def _wire_locked(self, layout):
        """(wire name or None, bytes per element on the wire)."""
        if self._wire_q8:
            wire = "q8"
        else:
            wire = self._wire_dtype
        item = _ITEMSIZE[wire] if wire else layout.dtype.itemsize
        return wire, item

    def _plan_streaming_round_locked(self, stats, flat, layout, treedef):
        """Issue the wire scaffolding of one streaming round under the lock
        and return the launch plan: ``units`` (element range -> launch
        closure, in flat order), ``finish`` (after the last launch) and
        ``abort`` (error the round loudly from the staging side).  Returns
        None when the contribution is dropped (not connected — elastic
        semantics, same as the barrier paths)."""
        if not self.connected():
            utils.log_verbose(
                "accumulator %s: dropping gradient contribution (not connected)",
                self._name,
            )
            return None
        if len(self._inflight) >= self._parallel_gradients:
            raise RpcError(
                f"{len(self._inflight)} gradient reductions already in flight "
                f"(parallel_gradients={self._parallel_gradients})"
            )
        if self._has_gradients:
            raise RpcError("unconsumed gradients; call zero_gradients() first")
        wire, item = self._wire_locked(layout)
        members = list(self._group.members())
        me = self._rpc.get_name()
        n = len(members)
        units = []
        if self._sharded and n > 1 and me in members:
            # Sharded round, streamed: every non-owned range is its own
            # bucketed STREAM (its sub-ops launch bucket by bucket as the
            # range stages); the owner's scatter op is deferred until its
            # own range is staged (the scatter callback folds the local
            # slice — issuing early could let the op resolve against a
            # half-staged slice).  Gathers are issued up front exactly like
            # the barrier path: they contribute nothing.
            rank = members.index(me)
            ranges = buckets.shard_ranges(layout.total, n, layout.bucket_elems)
            nonempty = [g for g, (gs, ge) in enumerate(ranges) if ge > gs]
            sr = _ShardedRound(
                rank, ranges, layout, treedef, flat, dict(stats),
                meta_group=nonempty[0], wire=wire, item=item,
                remaining=len(nonempty),
            )
            round_ = _Round(None, kind="full")
            sr.round = round_
            own = ranges[rank]
            _M_SHARD_FRACTION.set(
                (own[1] - own[0]) / layout.total if layout.total else 0.0,
                accumulator=self._name, peer=me,
            )
            _M_BUCKET_ROUNDS.inc(plane="rpc")
            self._inflight.append(round_)
            sync0 = self._group.sync_id()
            handles = []
            for g in nonempty:
                gs, ge = ranges[g]
                if g == rank:
                    def _launch_owner(sr=sr, gs=gs, ge=ge, sync0=sync0):
                        with self._lock:
                            if self._group.sync_id() != sync0:
                                raise RpcError(
                                    f"streaming sharded round {self._name}: "
                                    "group changed with buckets in flight"
                                )
                            template = np.broadcast_to(
                                np.zeros((), sr.layout.dtype), (ge - gs,)
                            )
                            fut = self._group.all_reduce(
                                f"__accum_sg{sr.rank}:{self._name}", None,
                                op="sum", wire=sr.wire, bucketed=True,
                                template=template, owned=True,
                            )
                            fut.add_done_callback(
                                lambda f, sr=sr: self._on_shard_scatter_done(sr, f)
                            )
                        return fut

                    units.append({"s": gs, "e": ge, "fire": _launch_owner})
                    continue
                handle = self._group.bucketed_stream(
                    f"__accum_sg{g}:{self._name}", flat[gs:ge], wire=wire,
                )
                handles.append(handle)
                nb = (ge - gs) * item
                self._reduce_bytes["rpc"] += nb
                _M_REDUCE_BYTES.inc(nb, plane="rpc")
                _M_BUCKET_BYTES.inc(nb, plane="rpc")
                _M_INTERHOST.inc(nb, kind="grad")
                _M_BUCKETS.inc(len(handle.bounds), plane="rpc")
                for k, (bs, be) in enumerate(handle.bounds):
                    units.append({
                        "s": gs + bs, "e": gs + be,
                        "fire": (lambda h=handle, k=k: h.launch(k)),
                    })
            for g in nonempty:
                if g == rank:
                    continue
                gs, ge = ranges[g]
                template = np.broadcast_to(np.zeros((), layout.dtype), (ge - gs,))
                kw = dict(op="sum", wire=wire, bucketed=True,
                          template=template, owned=True)
                if g == sr.meta_group:
                    kw.update(meta=dict(stats), meta_op=_count_reduce_op)
                gfut = self._group.all_reduce(
                    f"__accum_pg{g}:{self._name}", None, **kw
                )
                sr.gather[g] = gfut
                gfut.add_done_callback(
                    lambda f, sr=sr, g=g: self._on_shard_gather_done(sr, g, f)
                )

            def _abort(err, sr=sr, handles=handles):
                for h in handles:
                    h.abort(err)
                with self._lock:
                    sr.err = sr.err or err
                    round_ = sr.round
                    if not round_.done:
                        buckets.release(sr.flat)
                        sr.flat = None
                        round_.done = True
                        round_.error = err
                        self._drain_rounds_locked()

            return {"units": units, "finish": (lambda: None), "abort": _abort}
        # Plain tree round, streamed: ONE bucketed stream over the whole
        # flat payload — identical wire protocol to the barrier tree path
        # (same parent seq, same per-bucket sub-op names), only launch times
        # differ, so streaming and barrier peers interoperate in one round.
        handle = self._group.bucketed_stream(
            f"__accum_grad:{self._name}", flat,
            meta=dict(stats), meta_op=_count_reduce_op, wire=wire,
        )
        round_ = _Round(handle.future, kind="full")
        nb = layout.total * item
        self._reduce_bytes["rpc"] += nb
        _M_REDUCE_BYTES.inc(nb, plane="rpc")
        _M_BUCKET_BYTES.inc(nb, plane="rpc")
        _M_INTERHOST.inc(nb, kind="grad")
        _M_BUCKET_ROUNDS.inc(plane="rpc")
        _M_BUCKETS.inc(len(handle.bounds), plane="rpc")
        self._inflight.append(round_)
        handle.future.add_done_callback(
            lambda f, r=round_, td=treedef, lo=layout:
                self._on_flat_round_done(r, f, td, lo, None)
        )
        for k, (bs, be) in enumerate(handle.bounds):
            units.append({
                "s": bs, "e": be,
                "fire": (lambda h=handle, k=k: h.launch(k)),
            })
        return {"units": units, "finish": handle.finish, "abort": handle.abort}

    def _reduce_gradients_streaming(self, stats, stream) -> bool:
        """Stage a GradientStream bucket by bucket and launch each bucket's
        wire op the moment its slice is staged: the inter-host reduce
        overlaps the backward tail instead of waiting for the full-tree
        barrier.  Bit-exactness contract: fills, EF-q8 (per bucket,
        independent absmax + residual slices) and fold order are identical
        to the barrier path, so streaming == barrier to the bit.  The
        stream's chunks arrive as host arrays (the producer's ``deliver``
        copied CUDA leaves into pinned memory behind one event per chunk,
        which ``next_chunk`` waits on).  Returns False when the stream must
        fall back (caller materializes and takes the barrier path)."""
        picked = self._streaming_layout(stream)
        if picked is None:
            return False
        layout, stage_dtype, treedef = picked
        flat = buckets.lease(layout.total, stage_dtype)
        try:
            with self._lock:
                plan = self._plan_streaming_round_locked(
                    stats, flat, layout, treedef)
        except Exception:
            buckets.release(flat)
            raise
        if plan is None:
            buckets.release(flat)
            return True  # dropped (not connected) — elastic semantics
        units = plan["units"]
        timeout = getattr(self._group, "_timeout", 60.0)
        filled = buckets.Coverage()       # staged element ranges
        fin = buckets.Coverage()          # staged AND quantized: launchable
        finalized = [False] * layout.n_buckets
        launch_order = []                 # unit indices in launch order
        t0 = time.monotonic()
        fill_s = 0.0
        tl = telemetry.timeline

        def _launch(i):
            u = units[i]
            mark = tl.comm_mark()
            cf = u["fire"]()
            u["t"] = time.monotonic()
            launch_order.append(i)
            if cf is not None and mark is not None:
                # Retroactive per-bucket comm span: launch -> sub-op
                # completion, for the timeline's overlap attribution.
                cf.add_done_callback(
                    lambda f, m=mark: tl.comm_interval("accum.stream_bucket", m)
                )

        try:
            while True:
                chunk = stream.next_chunk(timeout)
                if chunk is None:
                    break
                lo, leaves = chunk
                tf = time.monotonic()
                for i, leaf in enumerate(leaves, start=lo):
                    off, sz = layout.offsets[i], layout.sizes[i]
                    np.copyto(flat[off:off + sz], _host_array(leaf).reshape(-1),
                              casting="unsafe")
                    filled.add(off, off + sz)
                # Finalize every layout bucket the chunk completed: EF-q8
                # runs per bucket (independent absmax + residual slice, so
                # quantizing in readiness order is bit-identical to the
                # barrier's one-pass quantization), then any wire unit whose
                # range is fully finalized launches.
                for k, (bs, be) in enumerate(layout.bounds):
                    if finalized[k] or not filled.covers(bs, be):
                        continue
                    if self._wire_q8:
                        residual = (
                            self._q_residual
                            if isinstance(self._q_residual, np.ndarray)
                            else None
                        )
                        self._q_residual = buckets.ef_quantize_flat(
                            flat, residual, [(bs, be)]
                        )
                    finalized[k] = True
                    fin.add(bs, be)
                    if stream.on_bucket is not None:
                        try:
                            stream.on_bucket(bs, be)
                        except Exception:  # noqa: BLE001 — telemetry hook
                            pass
                    for i, u in enumerate(units):
                        if "t" not in u and fin.covers(u["s"], u["e"]):
                            _launch(i)
                fill_s += time.monotonic() - tf
            for i, u in enumerate(units):
                if "t" not in u:
                    # Zero-length units (empty ranges) or anything the
                    # coverage maths left behind launches at the barrier
                    # point — lead 0, never a wedge.
                    _launch(i)
        except BaseException as e:
            plan["abort"](
                e if isinstance(e, (RpcError, GradientShardingError))
                else RpcError(f"streaming gradient round failed: {e!r}")
            )
            raise
        t_final = max((units[i]["t"] for i in launch_order), default=t0)
        leads = [max(0.0, t_final - u["t"]) for u in units]
        for lead in leads:
            _M_LAUNCH_LEAD.observe(lead)
        self._last_launch_leads = leads
        plan["finish"]()
        _M_BUCKET_FILL.observe(fill_s)
        _M_D2H_OVERLAP.observe(time.monotonic() - t0)
        return True

    # ------------------------------------------------------- sharded rounds
    def _start_sharded_round(self, kind: str, stats: Dict[str, int], staged,
                             fire_stats=None) -> None:
        """Issue one sharded hierarchical round.

        The flat payload is partitioned into N near-equal ranges on the
        bucket grid (``buckets.shard_ranges`` — pure function of protocol
        values, identical on every host).  Phase 1, reduce-scatter: one
        bucketed sub-op per range; the range's OWNER contributes ``None``
        (near-zero wire cost, a template gives the shape) while every other
        host contributes its zero-copy slice view — so each host ships
        (N-1)/N of the payload instead of all of it.  When the owner's op
        resolves it folds its own local slice into the wire partial,
        producing the true cohort sum of the range.  Phase 2, all-gather:
        the owner redistributes the true sum on a second op (everyone else
        contributes ``None``).  Round counts ride as allreduce meta on the
        first non-empty gather op."""
        flat, layout, treedef = staged
        with self._lock:
            if kind == "full":
                if not self.connected():
                    utils.log_verbose(
                        "accumulator %s: dropping gradient contribution (not connected)",
                        self._name,
                    )
                    buckets.release(flat)
                    return
                if len(self._inflight) >= self._parallel_gradients:
                    buckets.release(flat)
                    raise RpcError(
                        f"{len(self._inflight)} gradient reductions already in flight "
                        f"(parallel_gradients={self._parallel_gradients})"
                    )
                if self._has_gradients:
                    buckets.release(flat)
                    raise RpcError("unconsumed gradients; call zero_gradients() first")
            members = list(self._group.members())
            me = self._rpc.get_name()
            n = len(members)
            if n <= 1 or me not in members:
                # Degenerate cohort: nothing to shard.  The flat tree round
                # costs identical bytes here (zero — single member
                # short-circuits) and keeps the op protocol trivial.
                self._start_flat_round(kind, stats, staged, False,
                                       fire_stats=fire_stats)
                return
            rank = members.index(me)
            ranges = buckets.shard_ranges(layout.total, n, layout.bucket_elems)
            nonempty = [g for g, (gs, ge) in enumerate(ranges) if ge > gs]
            wire, item = self._wire_locked(layout)
            sr = _ShardedRound(
                rank, ranges, layout, treedef, flat, dict(stats),
                meta_group=nonempty[0], wire=wire, item=item,
                remaining=len(nonempty),
            )
            round_ = _Round(
                None, kind=("full" if kind == "full" else "grad"),
                stats=fire_stats,
            )
            sr.round = round_
            own = ranges[rank]
            _M_SHARD_FRACTION.set(
                (own[1] - own[0]) / layout.total if layout.total else 0.0,
                accumulator=self._name, peer=me,
            )
            _M_BUCKET_ROUNDS.inc(plane="rpc")
            self._inflight.append(round_)
            # Phase 1 — reduce-scatter contributions.
            for g in nonempty:
                gs, ge = ranges[g]
                owner = g == rank
                value = None if (owner or flat is None) else flat[gs:ge]
                template = (
                    np.broadcast_to(np.zeros((), layout.dtype), (ge - gs,))
                    if value is None else None
                )
                fut = self._group.all_reduce(
                    f"__accum_sg{g}:{self._name}", value, op="sum",
                    wire=wire, bucketed=True, template=template, owned=True,
                )
                if value is not None:
                    nb = (ge - gs) * item
                    self._reduce_bytes["rpc"] += nb
                    _M_REDUCE_BYTES.inc(nb, plane="rpc")
                    _M_BUCKET_BYTES.inc(nb, plane="rpc")
                    _M_INTERHOST.inc(nb, kind="grad")
                    _M_BUCKETS.inc(-(-(ge - gs) // layout.bucket_elems), plane="rpc")
                if owner:
                    fut.add_done_callback(
                        lambda f, sr=sr: self._on_shard_scatter_done(sr, f)
                    )
            # Phase 2 — gather ops for the ranges we do NOT own (contribute
            # nothing; receive the owner's true sum).  Our own range's
            # gather is issued by the scatter callback once the wire partial
            # lands.
            for g in nonempty:
                if g == rank:
                    continue
                gs, ge = ranges[g]
                template = np.broadcast_to(np.zeros((), layout.dtype), (ge - gs,))
                kw = dict(op="sum", wire=wire, bucketed=True,
                          template=template, owned=True)
                if g == sr.meta_group:
                    kw.update(meta=dict(stats), meta_op=_count_reduce_op)
                gfut = self._group.all_reduce(
                    f"__accum_pg{g}:{self._name}", None, **kw
                )
                sr.gather[g] = gfut
                gfut.add_done_callback(
                    lambda f, sr=sr, g=g: self._on_shard_gather_done(sr, g, f)
                )

    def _on_shard_scatter_done(self, sr, fut):
        """Own scatter op resolved: fold the local slice into the wire
        partial — the owner now holds the TRUE cohort sum of its range —
        and issue the gather op that redistributes it."""
        err = fut.exception()
        value = None if err is not None else fut.result(0)
        with self._lock:
            sr.err = sr.err or err
            gs, ge = sr.ranges[sr.rank]
            local = sr.flat[gs:ge] if sr.flat is not None else None
            true = None
            if err is None:
                if value is not None and local is not None:
                    # np.add allocates a fresh writable buffer: adopted
                    # result views may be read-only shared pages.
                    true = np.add(np.asarray(value), local)
                elif local is not None:
                    # owned=True hands the buffer to the op (in-place folds);
                    # never hand it a live view of the staging flat.
                    true = local.copy()
                elif value is not None:
                    true = np.array(np.asarray(value))
            template = None
            if true is None:
                template = np.broadcast_to(
                    np.zeros((), sr.layout.dtype), (ge - gs,)
                )
            kw = dict(op="sum", wire=sr.wire, bucketed=True,
                      template=template, owned=True)
            if sr.meta_group == sr.rank:
                kw.update(meta=dict(sr.stats), meta_op=_count_reduce_op)
            gfut = self._group.all_reduce(
                f"__accum_pg{sr.rank}:{self._name}", true, **kw
            )
            if true is not None:
                _M_INTERHOST.inc((ge - gs) * sr.item, kind="gather")
            sr.gather[sr.rank] = gfut
            gfut.add_done_callback(
                lambda f, sr=sr, g=sr.rank: self._on_shard_gather_done(sr, g, f)
            )

    def _on_shard_gather_done(self, sr, g, fut):
        err = fut.exception()
        res = meta = None
        if err is None:
            r = fut.result(0)
            if g == sr.meta_group:
                res, meta = r
            else:
                res = r
        with self._lock:
            sr.err = sr.err or err
            if meta is not None:
                sr.meta = meta
            sr.results[g] = res
            sr.remaining -= 1
            if sr.remaining == 0:
                self._finish_sharded_locked(sr)

    def _finish_sharded_locked(self, sr):
        """All gather ops resolved: assemble the full result flat from the
        per-range true sums (the share-down: host copies only, timed into
        ``accum_psum_seconds``) and hand the round to the shared drain
        logic."""
        if sr.round.done:
            # Streaming abort already errored the round; late gather
            # callbacks just drain into it.
            return
        buckets.release(sr.flat)
        round_ = sr.round
        norm = None
        if sr.err is None:
            flat = None
            with _M_PSUM.time():
                if any(r is not None for r in sr.results.values()):
                    flat = buckets.lease(sr.layout.total, sr.layout.dtype)
                    for g, (gs, ge) in enumerate(sr.ranges):
                        if ge <= gs:
                            continue
                        r = sr.results.get(g)
                        if r is None:
                            flat[gs:ge] = 0
                        else:
                            np.copyto(flat[gs:ge], np.asarray(r), casting="unsafe")
            grads = None
            if flat is not None:
                grads = sr.treedef.unflatten(sr.layout.unflatten(flat))
                # Eager pool offer (buckets.lease contract): the unflatten
                # views keep the buffer alive; the refcount probe skips it
                # until the consumer drops the result tree.
                buckets.release(flat)
            norm = {"grads": grads, "wire": None}
            norm.update(
                sr.meta
                or {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
            )
        round_.done = True
        round_.error = sr.err
        round_.result = norm
        if sr.err is None:
            _M_REDUCE_LATENCY.observe(
                time.monotonic() - round_.t0, plane=round_.plane
            )
        self._drain_rounds_locked()

    def set_ici_backend(self, enabled: bool = True) -> None:
        """Reduce gradients with ``torch.distributed.all_reduce`` (the
        collective data plane: NCCL for CUDA tensors, gloo for CPU ones)
        instead of the RPC tree, when the cohort spans exactly the default
        process group (``get_world_size()``; a process without one is a
        world of 1) — collectives for the gradient data plane, RPC for
        elasticity/election/model sync.  The group is the caller's:
        ``init_process_group`` with the rendezvous address (the examples'
        ``--coordinator tcp://host:port``).

        The collective is synchronous across processes: every member's train
        loop calls ``reduce_gradients``/``skip_gradients`` in lockstep (which
        the wants/has protocol already guarantees).  If the cohort shrinks
        or grows (epoch change), reduction transparently falls back to the
        elastic RPC tree until the cohort matches the process set again.
        One process contributes once (one device per process).
        """
        self._use_ici = bool(enabled)

    def _ici_membership_intact(self) -> bool:
        """The cohort still spans the full process group (the broker has
        evicted nobody)."""
        if not self._use_ici:
            return False
        if not self._group.active():
            return False
        return len(self._group.members()) == _world_size()

    def _ici_eligible(self) -> bool:
        if not self._ici_membership_intact():
            return False
        if self._group.sync_id() == self._ici_suspended_epoch:
            # A cohort-agreed abort suspended the ICI plane for this epoch
            # (wedged-alive peer): every peer reached the same unanimity, so
            # every peer is suspended for the same epoch — plane choice
            # stays part of the round protocol.
            return False
        return True

    def _ici_eligible_locked_hint(self) -> bool:
        """Membership-intact check for the update() sweep (caller holds the
        lock).  Reading the world size never blocks: the process group was
        initialized by the caller before any round."""
        return self._ici_membership_intact()

    def cohort_size(self) -> int:
        """Number of members in the current cohort epoch (0 before the
        broker's first push).  Beyond-reference convenience: examples log
        it without reaching into the internal Group."""
        return len(self._group.members())

    def parameters(self):
        """Current synced parameter tree (a model synced from the leader
        arrives as tensors on this peer's device)."""
        return self._params

    def set_parameters(self, parameters) -> None:
        """Hand the post-optimizer-step parameters back to the accumulator."""
        with self._lock:
            self._params = parameters

    def buffers(self):
        return self._buffers

    def set_buffers(self, buffers) -> None:
        with self._lock:
            self._buffers = buffers

    # state (user blob) ----------------------------------------------------
    def wants_state(self) -> bool:
        with self._lock:
            return self._is_leader and bool(self._state_requesters)

    def set_state(self, state) -> None:
        """Leader: provide user state; the model + state stream to every
        requesting peer as version-keyed chunks (see ``_on_model_chunk``).

        Unlike the old monolithic push, the stream is a windowed, ack-paced
        chunk pipeline (``_send_model_chunks``): a huge model never
        serializes into one giant frame, in-flight gradient rounds
        interleave with sync traffic instead of stalling behind it, and a
        transfer that dies with its leader resumes from the last acked
        chunk under the new epoch (the requester re-advertises its partial
        buffer).

        In the port the caller's thread only snapshots the tree to host
        memory (tensors change in place after this call, where the JAX
        package's arrays could not); pickling, hashing and chunking a blob
        of gigabytes run on a worker thread, so the train loop keeps
        pumping (its broker pings, a hosted broker) meanwhile."""
        with self._lock:
            requesters, self._state_requesters = self._state_requesters, []
            if not requesters:
                return
            params, buffers, version = self._params, self._buffers, self._model_version
            cached = self._sync_cache
            if cached is not None and cached[0] != version:
                cached = None
            epoch = self._group.sync_id()
            # Registered before the (slow) encode: re-requests meanwhile
            # answer "queued" instead of starting a second chain.
            for peer, *_ in requesters:
                self._active_transfers[peer] = (epoch, version)
        snapshot = None if cached is not None else self._host_blob_tree(params, buffers, state)
        threading.Thread(
            target=self._serve_requesters,
            args=(requesters, epoch, version, snapshot, cached),
            name=f"model-sync-{self._name}", daemon=True,
        ).start()

    def _serve_requesters(self, requesters, epoch, version, snapshot, cached) -> None:
        try:
            if snapshot is None:
                chunks, sha = cached[2], cached[1]
            else:
                chunks, sha = self._encode_blob(version, snapshot)
        except Exception:  # noqa: BLE001 — worker thread: report, free the peers
            utils.log_error("accumulator %s: model sync blob failed to encode", self._name)
            with self._lock:
                for peer, *_ in requesters:
                    if self._active_transfers.get(peer) == (epoch, version):
                        del self._active_transfers[peer]
            return
        for peer, _have, resume_version, resume_chunks in requesters:
            start = 0
            if resume_version == version and 0 < resume_chunks <= len(chunks):
                start = resume_chunks
                _M_SYNC_RESUMES.inc()
                utils.log_info(
                    "accumulator %s: resuming model sync to %s from chunk "
                    "%d/%d (version %s)",
                    self._name, peer, start, len(chunks), version,
                )
            self._send_model_chunks(peer, epoch, version, sha, chunks, start)

    def set_model_chunk_bytes(self, n: int) -> None:
        """Chunk size for the streamed model sync (default 1 MiB, env
        ``MOOLIB_MODEL_CHUNK_BYTES``).  Pacing only — never semantics: the
        transfer resumes at any chunk boundary.  Tests shrink it to land
        kills mid-transfer deterministically."""
        if n < 1:
            raise ValueError("model chunk size must be >= 1 byte")
        self._model_chunk_bytes = int(n)

    def _sync_chunks(self, version, params, buffers, state):
        """(chunks, sha16) of the pickled host-side (params, buffers, state)
        blob for ``version``; cached per version so N simultaneous joiners
        serialize once.

        The sha identifies the blob bytes, not just the version: resume
        across a leader change is only valid when the NEW leader's blob at
        the same version is byte-identical (deterministic pickling of the
        identically-replicated model/opt state — true in lockstep cohorts).
        When it is not, the receiver detects the sha mismatch, resets its
        buffer, and the transfer restarts cleanly from chunk 0."""
        with self._lock:
            cached = self._sync_cache
            if cached is not None and cached[0] == version:
                return cached[2], cached[1]
        return self._encode_blob(version, self._host_blob_tree(params, buffers, state))

    def _host_blob_tree(self, params, buffers, state):
        """The blob's tree with numpy leaves (CUDA leaves staged with one
        event)."""
        tree, staged = _blob_tree((params, buffers, state))
        if staged:
            with self._lock:
                self._d2h_calls += 1
        return tree

    def _encode_blob(self, version, tree):
        # Canonical dict ordering of numpy leaves: a port leader and a JAX
        # leader must yield the same bytes for the same values, or
        # cross-leader resume in a mixed cohort can never match.
        host = checkpoint.canonical_tree(tree)
        blob = pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL)
        sha = hashlib.sha256(blob).hexdigest()[:16]
        n = self._model_chunk_bytes
        chunks = [blob[i : i + n] for i in range(0, len(blob), n)] or [b""]
        with self._lock:
            self._sync_cache = (version, sha, chunks)
            self._last_sync_sha = sha
        return chunks, sha

    # Chunks in flight per transfer: enough pipelining that one slow chunk
    # (a dropped frame riding the transport's resend timer) stalls only its
    # own slot, small enough that a dead requester wastes one window.
    _SYNC_WINDOW = 8

    def _send_model_chunks(self, peer, epoch, version, sha, chunks, start):
        """Drive one windowed chunk stream to ``peer``.  Up to
        ``_SYNC_WINDOW`` chunks ride the wire at once (pipelined — a lossy
        link costs per-chunk retransmit latency once per window, not once
        per chunk); each ack carries the receiver's contiguous-chunk count,
        which is the single source of truth for progress: a duplicated,
        re-ordered, or regressed ack can only cause re-sends, never skips.
        An ack of -1 (stale transfer) or an epoch change stops the stream
        (the requester's next re-request resumes it)."""
        total = len(chunks)
        if start >= total:
            # The requester buffered the whole blob but could not commit it
            # (the final chunk carried a dead epoch's stamp): re-send the
            # last chunk under the current epoch so it can commit.
            start = total - 1
        st = {"next": start, "acked": start, "stopped": False}

        def _stop():
            with self._lock:
                st["stopped"] = True
                self._active_transfers.pop(peer, None)
                if not self._active_transfers:
                    # Last stream ended: drop the pinned blob copy (a full
                    # host-side model) instead of holding it until the next
                    # version's set_state, which may never come.
                    self._sync_cache = None

        def pump():
            to_send = []
            with self._lock:
                while (
                    not st["stopped"]
                    and st["next"] < total
                    and st["next"] < st["acked"] + self._SYNC_WINDOW
                ):
                    to_send.append(st["next"])
                    st["next"] += 1
            for seq in to_send:
                send_one(seq)

        def send_one(seq):
            payload = chunks[seq]

            def _acked(result, error, seq=seq):
                if error is not None or result is None:
                    utils.log_verbose(
                        "accumulator %s: model sync to %s stopped at chunk "
                        "%d/%d (%s); its re-request will resume",
                        self._name, peer, seq, total, error,
                    )
                    _stop()
                    return
                k = int(result)
                if k < 0 or self._group.sync_id() != epoch:
                    _stop()
                    return
                if k >= total:
                    _stop()
                    utils.log_info(
                        "accumulator %s: model sync to %s complete "
                        "(version %s, %d chunks, %d B)",
                        self._name, peer, version, total,
                        sum(len(c) for c in chunks),
                    )
                    return
                with self._lock:
                    if k > st["acked"]:
                        st["acked"] = k
                        # A receiver that prefilled chunks from a local
                        # checkpoint slice (a JAX peer's preload_sync_slice)
                        # acks past bytes we never sent: fast-forward so
                        # only the missing ranges go on the wire.
                        if k > st["next"]:
                            st["next"] = k
                    elif k < st["acked"]:
                        # The receiver reset its buffer (sha changed under a
                        # leader change) — rewind and restream from its
                        # contiguous count.  A merely re-ordered ack rewinds
                        # at most one window of duplicate sends, which the
                        # receiver dedupes.
                        st["acked"] = k
                        st["next"] = min(st["next"], max(k, 0))
                pump()

            with self._lock:
                self._model_sync_bytes_tx += len(payload)
            _M_SYNC_CHUNKS.inc(direction="tx")
            _M_SYNC_BYTES.inc(len(payload), direction="tx")
            self._rpc.async_callback(
                peer, "__accum_model_chunk", _acked,
                self._name, epoch, version, sha, seq, total, payload,
            )

        pump()

    def _on_model_chunk(self, epoch, version, sha, seq, total, payload):
        """One model-sync chunk.  Returns the contiguous-chunk count as the
        ack (the sender's next-seq), or -1 to abort a stale transfer.

        The buffer is keyed by (version, sha) and deliberately SURVIVES
        membership epochs: that is what makes a transfer interrupted by
        leader death resumable — the new leader at the same version
        continues from our acked count instead of restarting.  Only the
        final commit is epoch-stamped."""
        with self._lock:
            if self._epoch_synced and version <= self._model_version:
                return -1  # already current; stop the sender's chain
            t = self._in_transfer
            if t is not None and (t["version"], t["sha"]) != (version, sha):
                if version < t["version"]:
                    # A dead leader's stale chain must not clobber progress
                    # on a newer transfer.
                    return -1
                t = None  # newer version or sha mismatch: restart the buffer
            if t is None or t["total"] != total:
                t = self._in_transfer = {
                    "version": version, "sha": sha, "total": total, "chunks": {},
                }
                self._prefill_from_slice_locked(t, seq, total, len(payload))
            if seq not in t["chunks"]:
                t["chunks"][seq] = bytes(payload)
                self._model_sync_bytes_rx += len(payload)
                _M_SYNC_CHUNKS.inc(direction="rx")
                _M_SYNC_BYTES.inc(len(payload), direction="rx")
            k = 0
            while k in t["chunks"]:
                k += 1
            if k < total:
                return k
            if t.get("decoding"):
                return total  # a duplicate final chunk while decoding
            t["decoding"] = True
            parts = [t["chunks"][i] for i in range(total)]
        # Join, hash and unpickle outside the lock: for a blob of gigabytes
        # that takes seconds, and update() on the train loop needs the lock.
        try:
            blob = b"".join(parts)
            del parts
            got_sha = hashlib.sha256(blob).hexdigest()[:16]
            if got_sha != sha:
                # Chunks from two leaders with different chunk sizes can
                # share (version, sha, total) yet different boundaries;
                # the end-to-end digest is the authoritative check.
                raise ValueError(f"blob sha {got_sha} != advertised {sha}")
            params, buffers, state = pickle.loads(blob)
        except Exception as e:  # noqa: BLE001 — cross-leader byte drift
            # The determinism assumption behind cross-leader resume
            # failed (see _sync_chunks): drop the buffer; the next
            # re-request restarts from chunk 0.
            utils.log_error(
                "accumulator %s: model sync blob failed to decode (%r); "
                "restarting transfer", self._name, e,
            )
            with self._lock:
                if self._in_transfer is t:
                    self._in_transfer = None
            return 0
        with self._lock:
            t["decoding"] = False
            if self._in_transfer is not t:
                return -1  # superseded while decoding
            # Staged like a monolithic push; commit (in update(), on the
            # user thread) checks the epoch stamp.  The buffer is kept until
            # the commit actually lands so a stale-epoch final chunk costs a
            # one-chunk resend, not a full retransfer.
            self._staged_model = (epoch, version, params, buffers, state)
            self._last_sync_sha = sha
            return total

    def has_new_state(self) -> bool:
        return self._has_new_state

    def state(self):
        with self._lock:
            self._has_new_state = False
            return self._received_state

    # ---------------------------------------------- distributed checkpoints
    def enable_distributed_checkpoint(self, checkpointer, interval: float = 30.0,
                                      lead_steps: int = 2,
                                      timeout: float = 60.0,
                                      aux_fn=None) -> None:
        """Attach a :class:`~moolib_tpu_torch.checkpoint.DistributedCheckpointer`
        and let the cohort snapshot itself (docs/RESILIENCE.md "Distributed
        checkpoints").

        The LEADER opens a checkpoint epoch every ``interval`` seconds by
        broadcasting a target step ``lead_steps`` applies in the future;
        every member (leader included) captures its shard asynchronously
        when its applied-step count reaches exactly that target — lockstep
        apply order makes the capture version-consistent cohort-wide — and
        the leader two-phase-commits the cohort manifest once all shard
        reports agree on the blob digest.  Drive it by calling
        :meth:`checkpoint_tick` every train-loop iteration.

        Version consistency is PROVED, not assumed: every member's blob
        must hash identically, so the user ``state_fn`` may only return
        cohort-replicated values (the lockstep opt state).  Host-local
        values (a wall-clock step count, env-frame totals) go through
        ``aux_fn`` instead: the LEADER evaluates it once when it opens the
        epoch, broadcasts the dict, and every member folds the identical
        copy into its blob.

        When the checkpointer restored a blob this process start
        (``last_restored``), it is auto-registered as a warm-rejoin sync
        slice: a full transfer at that exact version is served from local
        bytes instead of the wire (:meth:`preload_sync_slice`)."""
        with self._lock:
            self._ckptr = checkpointer
            self._ckpt_interval = float(interval)
            self._ckpt_lead = max(1, int(lead_steps))
            self._ckpt_timeout = float(timeout)
            self._ckpt_aux_fn = aux_fn
        last = getattr(checkpointer, "last_restored", None)
        if last is not None:
            step, sha16, blob = last
            self.preload_sync_slice(step, sha16, 0, blob, len(blob))

    def preload_sync_slice(self, version: int, sha16: str, start: int,
                           data: bytes, total_bytes: int) -> None:
        """Register a locally-held byte range ``[start, start+len(data))``
        of the leader's sync blob for ``(version, sha16)`` — e.g. this
        host's re-cut shard slice from a distributed checkpoint
        (``DistributedCheckpointer.restore_slice``).  When a model transfer
        at that exact version+digest starts, every chunk fully covered by
        the slice is prefilled into the receive buffer and the resumable
        stream serves only the missing bytes
        (``accum_sync_slice_chunks_total``)."""
        with self._lock:
            self._sync_slice = (
                int(version), str(sha16), int(start), bytes(data),
                int(total_bytes),
            )

    def checkpoint_capture_due(self, steps_done: Optional[int] = None) -> bool:
        """Will the next :meth:`checkpoint_tick` at ``steps_done`` (default:
        the model version) capture a shard?  A caller whose state takes work
        to assemble (a mesh host gathering its sharded optimizer state)
        asks first and prepares it."""
        with self._lock:
            p = self._ckpt_pending
            if self._ckptr is None or p is None:
                return False
            if steps_done is None:
                steps_done = self._model_version
            return (p["epoch"] == self._group.sync_id() and int(steps_done) == p["target"]
                    and self._rpc.get_name() in p["members"])

    def checkpoint_tick(self, steps_done: Optional[int] = None,
                        state_fn=None) -> None:
        """Drive the distributed checkpoint protocol; call once per train
        loop iteration.  ``state_fn`` returns the user state to snapshot
        and is evaluated only when a capture is actually due.  The step
        boundary defaults to the accumulator's model version — the one
        counter that is lockstep across the cohort even for warm
        rejoiners — but tests may pass ``steps_done`` explicitly.  No-op
        until :meth:`enable_distributed_checkpoint`."""
        if self._ckptr is None:
            return
        now = time.monotonic()
        begin = capture = missed = finish = abort = None
        me = self._rpc.get_name()
        with self._lock:
            if steps_done is None:
                steps_done = self._model_version
            leader = self._leader
            # Leader: open a checkpoint epoch on the interval.
            if (
                self._is_leader
                and self._ckpt_interval > 0
                and self._ckpt_open is None
                and self._ckpt_pending is None
                and self._epoch_synced
                and self._group.active()
                and now - self._ckpt_last_begin > self._ckpt_interval
            ):
                self._ckpt_last_begin = now
                self._ckpt_seq += 1
                members = sorted(self._group.members())
                rec = {
                    "id": self._ckpt_seq,
                    "epoch": self._group.sync_id(),
                    "target": int(steps_done) + self._ckpt_lead,
                    "members": members,
                    "aux": None,  # filled below, outside the lock
                }
                self._ckpt_open = dict(
                    rec, reports={}, deadline=now + self._ckpt_timeout,
                    failed=None,
                )
                self._ckpt_pending = rec
                begin = (rec, [m for m in members if m != me])
            # Member (leader included): capture at EXACTLY the target step —
            # past it, our params no longer name the agreed version, so the
            # honest move is to fail the epoch fast, not snapshot drift.
            p = self._ckpt_pending
            if p is not None:
                if p["epoch"] != self._group.sync_id():
                    self._ckpt_pending = None  # torn by membership change
                elif int(steps_done) >= p["target"]:
                    self._ckpt_pending = None
                    if int(steps_done) == p["target"] and me in p["members"]:
                        capture = dict(
                            p,
                            rank=p["members"].index(me),
                            world=len(p["members"]),
                            params=self._params,
                            buffers=self._buffers,
                        )
                    else:
                        missed = dict(p, steps=int(steps_done))
            # Leader: commit on full quorum; abort on failure/deadline/churn.
            o = self._ckpt_open
            if o is not None:
                if o["epoch"] != self._group.sync_id():
                    self._ckpt_open = None
                    abort = ("membership epoch changed mid-checkpoint", o)
                elif o["failed"]:
                    self._ckpt_open = None
                    abort = (o["failed"], o)
                elif len(o["reports"]) == len(o["members"]):
                    self._ckpt_open = None
                    finish = o
                elif now > o["deadline"]:
                    self._ckpt_open = None
                    abort = (
                        f"report deadline expired with "
                        f"{len(o['reports'])}/{len(o['members'])} shards", o,
                    )
        # Everything below runs OUTSIDE the lock: RPC sends and commit file
        # I/O must not nest under state the RPC handlers need.
        if begin is not None:
            rec, targets = begin
            # Host-local companion state (step counters, env totals): the
            # leader's copy is the one true value — members fold the
            # broadcast dict into their blobs so the digests can agree.
            if self._ckpt_aux_fn is not None:
                try:
                    rec["aux"] = self._ckpt_aux_fn()
                except Exception as e:  # noqa: BLE001 — aux is best-effort
                    utils.log_error(
                        "accumulator %s: checkpoint aux_fn failed: %r",
                        self._name, e,
                    )
            for m in targets:
                self._rpc.async_callback(
                    m, "__accum_ckpt_begin",
                    self._make_ckpt_begin_ack(m, rec["id"]),
                    self._name, rec["epoch"], rec["id"], rec["target"],
                    rec["members"], rec["aux"],
                )
        if missed is not None:
            self._ckpt_send_report(
                leader, missed["epoch"], missed["id"], -1,
                {"error": f"missed step boundary {missed['target']} "
                          f"(at {missed['steps']})"},
            )
        if capture is not None:
            self._ckpt_capture(capture, state_fn, leader)
        if abort is not None:
            reason, o = abort
            _M_CKPT_ABORTS.inc()
            utils.log_error(
                "accumulator %s: checkpoint %s at step %s aborted: %s",
                self._name, o["id"], o["target"], reason,
            )
            telemetry.flight_event(
                "checkpoint.aborted", accumulator=self._name,
                step=o["target"], reason=str(reason),
            )
        if finish is not None:
            try:
                self._ckptr.commit_cohort(
                    finish["target"], list(finish["reports"].values())
                )
            except Exception as e:  # noqa: BLE001 — a failed commit = abort
                _M_CKPT_ABORTS.inc()
                utils.log_error(
                    "accumulator %s: checkpoint commit for step %s failed: "
                    "%r", self._name, finish["target"], e,
                )
                telemetry.flight_event(
                    "checkpoint.aborted", accumulator=self._name,
                    step=finish["target"], reason=repr(e),
                )

    def _make_ckpt_begin_ack(self, member, ckpt_id):
        def _ack(result, error):
            if error is None and result is True:
                return
            # A member that cannot participate (no checkpoint dir, stale
            # epoch, dead) fails the epoch fast instead of letting the
            # leader wait out the report deadline.
            with self._lock:
                o = self._ckpt_open
                if o is not None and o["id"] == ckpt_id and not o["failed"]:
                    o["failed"] = (
                        f"member {member} refused checkpoint begin: "
                        f"{error if error is not None else result}"
                    )
        return _ack

    def _ckpt_capture(self, rec, state_fn, leader) -> None:
        # Called outside the lock, on the train thread: begin_capture
        # snapshots the live tensors (params, state_fn's optimizer state)
        # before it returns, so the next in-place apply cannot reach the
        # capture; that handoff is the measured stall.
        state = state_fn() if callable(state_fn) else state_fn
        aux = rec.get("aux")
        if isinstance(state, dict) and isinstance(aux, dict):
            # Leader-broadcast fields are cohort-identical by construction;
            # folding them in keeps the blob digest agreeable while still
            # carrying host-local bookkeeping (step counts etc.).
            state = dict(state, **aux)

        def _done(report, rec=rec):
            # Checkpointer worker thread; no accumulator lock held.  A
            # failed capture arrives as {"error": ...} and aborts the epoch.
            payload = (
                report if report is not None
                else {"error": "shard capture failed"}
            )
            self._ckpt_send_report(
                leader, rec["epoch"], rec["id"], rec["rank"], payload
            )

        ok = self._ckptr.begin_capture(
            step=rec["target"], rank=rec["rank"], world=rec["world"],
            epoch=rec["epoch"],
            state=(rec["params"], rec["buffers"], state),
            on_done=_done,
        )
        if not ok:
            self._ckpt_send_report(
                leader, rec["epoch"], rec["id"], rec["rank"],
                {"error": "capture declined: both staging slots busy"},
            )

    def _ckpt_send_report(self, leader, epoch, ckpt_id, rank, report) -> None:
        if leader is None:
            return
        if leader == self._rpc.get_name():
            self._on_ckpt_report(epoch, ckpt_id, rank, report)
            return
        self._rpc.async_callback(
            leader, "__accum_ckpt_report", lambda r, e: None,
            self._name, epoch, ckpt_id, rank, report,
        )

    def _on_ckpt_begin(self, epoch, ckpt_id, target, members, aux=None):
        """Member handler for the leader's checkpoint-epoch broadcast.
        Returns True when armed; a string reason otherwise (the leader's
        ack callback turns a refusal into a fast abort)."""
        with self._lock:
            if epoch != self._group.sync_id():
                return "stale membership epoch"
            if self._ckptr is None:
                return "no distributed checkpointer configured"
            self._ckpt_pending = {
                "id": ckpt_id, "epoch": epoch, "target": int(target),
                "members": list(members), "aux": aux,
            }
        return True

    def _on_ckpt_report(self, epoch, ckpt_id, rank, report):
        """Leader handler: one member's shard report (or failure)."""
        with self._lock:
            o = self._ckpt_open
            if o is None or o["id"] != ckpt_id or o["epoch"] != epoch:
                return False
            if not isinstance(report, dict) or report.get("error"):
                if not o["failed"]:
                    o["failed"] = (
                        report.get("error", "malformed shard report")
                        if isinstance(report, dict)
                        else "malformed shard report"
                    )
            else:
                o["reports"][int(rank)] = report
        return True

    def _prefill_from_slice_locked(self, t, seq, total, chunk_bytes) -> None:
        """Warm-rejoin slice serving, receiver side: when a fresh transfer
        buffer matches a preloaded local slice (version + sha), copy every
        chunk the slice fully covers into the buffer.  The contiguous-ack
        protocol then jumps past them and the sender's fast-forward skips
        their bytes entirely.  The chunk size is inferred from a non-final
        chunk's payload (all chunks but the last are equal-sized)."""
        sl = self._sync_slice
        if sl is None or chunk_bytes <= 0:
            return
        version, sha, start, data, total_bytes = sl
        if (t["version"], t["sha"]) != (version, sha):
            return
        if total > 1 and seq >= total - 1:
            return  # the final chunk may be short: chunk size unknowable
        if (chunk_bytes * (total - 1) >= total_bytes
                or chunk_bytes * total < total_bytes):
            return  # sender's chunk grid doesn't match the slice's blob
        stop = start + len(data)
        n = 0
        for i in range(total):
            a = i * chunk_bytes
            b = total_bytes if i == total - 1 else a + chunk_bytes
            if a >= start and b <= stop and i not in t["chunks"]:
                t["chunks"][i] = data[a - start:b - start]
                n += 1
        if n:
            _M_SLICE_PREFILL.inc(n)
            utils.log_info(
                "accumulator %s: prefilled %d/%d sync chunks from the local "
                "checkpoint slice (version %s)", self._name, n, total, version,
            )

    # gradients ------------------------------------------------------------
    def wants_gradients(self) -> bool:
        with self._lock:
            return (
                self.connected()
                and len(self._inflight) < self._parallel_gradients
                and not self._has_gradients
            )

    def has_gradients(self) -> bool:
        """A cohort result is ready to apply.  A result whose epoch has died
        is dropped here, before the caller can apply it: the new epoch's
        model (committed by a follower, or served by this peer as leader)
        does not hold it, so applying it would leave this peer with bytes no
        other peer holds under the same version.  Its contribution is lost,
        as a round cancelled by the epoch change is."""
        with self._lock:
            if self._has_gradients and self._result_epoch != self._group.sync_id():
                self._has_gradients = False
                self._result_grads = None
                self._result_on_device = None
                _M_DEAD_RESULTS.inc()
                utils.log_verbose(
                    "accumulator %s: dropped a result from a dead epoch", self._name
                )
                self._drain_rounds_locked()
            return self._has_gradients

    def reduce_gradients(self, batch_size: int, gradients=None) -> None:
        """Contribute local gradients (a pytree) with their batch size and
        start/continue the asynchronous cohort reduction.

        With a virtual batch size set, only the *count* (3 ints) goes on the
        wire per contribution; gradients accumulate locally in f32 and ship in
        ONE allreduce once the global count meets ``virtual_batch_size``
        (reference two-phase protocol, ``src/accumulator.cc:1005-1078``).

        ``gradients`` is a tree of tensors (CPU or CUDA) or numpy arrays.
        A tree of ``DTensor`` leaves is gathered in full onto this rank
        first (``parallel.collectives.gather_full``: every rank of their
        mesh enters the same gather), and the sharded plane keys its
        layout on their shardings.

        ``gradients`` may also be a :class:`buckets.GradientStream` (the
        streaming gradient pipeline, produced by
        ``parallel.make_train_step(overlap_grads=True)``): buckets stage and
        launch onto the wire as the producer delivers leaf groups,
        overlapping the inter-host reduce with the backward tail.
        Streaming is bit-exact with the equivalent barrier contribution and
        interoperates with barrier peers in the same round; paths that need
        the whole tree at once (the collective plane, virtual batching,
        chunked ring) materialize the stream, as in the JAX package.
        """
        if gradients is None:
            raise ValueError(
                "pass the gradient tree explicitly, "
                "reduce_gradients(batch_size, gradients)"
            )
        # Root of this round's distributed trace: everything launched while
        # the span is open — staging, and the round's first wave of tree-op
        # RPCs sent synchronously from _start_round — shares its trace_id,
        # so a merged cohort timeline shows one causal tree per round.
        with telemetry.root_span("accum.reduce_gradients",
                                 accumulator=self._name,
                                 batch_size=int(batch_size)):
            self._reduce_gradients_traced(batch_size, gradients)

    def _reduce_gradients_traced(self, batch_size: int, gradients) -> None:
        self._rec_note_first_reduce()
        stats = {"num_gradients": 1, "num_skipped": 0, "batch_size": int(batch_size)}
        if isinstance(gradients, buckets.GradientStream):
            # Streaming gradient pipeline: stage and launch wire buckets as
            # the producer delivers leaf groups.  Paths that need the whole
            # tree at once (the collective plane, virtual batching, the
            # chunked ring, legacy payloads) materialize the stream and fall
            # through — bit-identical, just barrier-timed.
            stream = gradients
            if (
                self._bucketed
                and not self._ici_eligible()
                and self._virtual_batch_size is None
                and not self._use_ring_locked()
                and self._reduce_gradients_streaming(stats, stream)
            ):
                return
            gradients = self._materialize_stream(stream)
        shardings = None
        leaves = nest.tree_leaves(gradients)
        if _has_dtensor(leaves):
            from .parallel import collectives, mesh as mesh_mod

            shardings = [mesh_mod.sharding_of(l) for l in leaves]
            gradients = collectives.gather_full(gradients, dst=0)
            if gradients is None:
                raise RuntimeError(
                    f"accumulator {self._name}: DTensor gradients gather onto "
                    "mesh rank 0, the host's Accumulator peer; this rank is another")
        dev = _tree_device(gradients)
        if dev is not None:
            self._grad_device = dev
        if self._ici_eligible():
            # Collective data plane: one all_reduce over the process group; wire
            # compression and the two-phase count protocol are DCN
            # optimizations and don't apply here.
            self._ici_round(stats, gradients)
            return
        if self._virtual_batch_size is not None:
            # Remember the true dtypes so gradients() can restore them (local
            # accumulation is in f32).  The local contribution is a host f32
            # copy: CUDA leaves through one pinned lease and one event.
            self._grad_dtypes = nest.tree_map(_leaf_dtype, gradients)
            self._start_round("count", stats, self._host_f32(gradients))
            return
        use_ring = self._use_ring_locked()
        if self._bucketed and self._sharded:
            # Sharded hierarchical reduce: stage into a shard-pinned layout
            # (signature-guarded — a mid-run sharding change raises
            # GradientShardingError, never a silent fall-back to full-tree
            # payloads) and run reduce-scatter + all-gather.  The
            # chunked-ring setting is ignored: the scatter already is the
            # ring's reduce-scatter half.
            staged = self._stage_flat(gradients, ring=False, sharded=True,
                                      shardings=shardings)
            if staged is not None:
                self._start_sharded_round("full", stats, staged)
                return
        if self._bucketed:
            # Flat-bucket data plane (docs/DESIGN.md "Gradient data plane"):
            # one staging pass into a pooled flat buffer (D2H issued async
            # per leaf, dtype convert fused into the copy, EF-q8 once on the
            # flat buffer), then per-bucket pipelined tree ops or
            # bucket-aligned ring chunks.
            staged = self._stage_flat(gradients, ring=use_ring)
            if staged is not None:
                self._start_flat_round("full", stats, staged, use_ring)
                return
            # Mixed leaf dtypes without wire compression: legacy payload.
        if use_ring:
            # Ring path: contribute f32 (EF-quantized at the source when the
            # wire is int8); bf16/f32 hop transport lives in the ring codec.
            self._grad_dtypes = nest.tree_map(_leaf_dtype, gradients)
            gradients = self._ring_q8_contrib(self._host_f32(gradients))
            self._start_round("ring_full", stats, gradients)
            return
        if self._wire_dtype is not None:
            self._grad_dtypes = nest.tree_map(_leaf_dtype, gradients)
        if self._wire_q8:
            gradients, self._q_residual = _quantize_q8(
                self._host_f32(gradients), self._q_residual)
        elif self._wire_dtype is not None:
            # Skip the cast copy when a leaf is already in the wire dtype.
            wire = self._wire_dtype
            gradients = nest.tree_map(
                lambda g: g if _wire_name(getattr(g, "dtype", None)) == wire
                else _to_wire(g, wire),
                self._host_f32(gradients),
            )
        # Without compression the tree goes as it is: the Group stages CUDA
        # leaves itself (one pinned copy each, one event for the tree).
        self._start_round("full", stats, gradients)

    def skip_gradients(self) -> None:
        """Participate in this reduction round without contributing data."""
        self._rec_note_first_reduce()
        stats = {"num_gradients": 0, "num_skipped": 1, "batch_size": 0}
        if self._ici_eligible():
            # The collective program must be identical on every process:
            # a skip contributes zeros shaped like the parameters (gradient
            # trees match the param tree by construction).
            zeros = nest.tree_map(
                lambda p: torch.zeros_like(p) if isinstance(p, torch.Tensor)
                else np.zeros_like(np.asarray(p)), self._params
            )
            self._ici_round(stats, zeros)
            return
        if self._virtual_batch_size is not None:
            self._start_round("count", stats, None)
            return
        use_ring = self._use_ring_locked()
        if self._bucketed and self._sharded:
            # Skip rounds must issue the same op set as contributing peers
            # (the per-range ops are the round protocol): a plain layout from
            # the param tree yields identical ranges — shard_ranges depends
            # only on (total, N, bucket grid), never on the pinned cuts.
            staged = self._stage_flat_skip(False)
            if staged is not None:
                self._start_sharded_round("full", stats, staged)
                return
        if self._bucketed:
            staged = self._stage_flat_skip(use_ring)
            if staged is not None:
                self._start_flat_round("full", stats, staged, use_ring)
                return
        if use_ring:
            kind = "ring_full"
            if self._grad_dtypes is None:
                # Ring results come back f32; restore to the param dtypes
                # (gradient trees match the param tree by construction).
                self._grad_dtypes = nest.tree_map(_leaf_dtype, self._params)
        else:
            kind = "full"
        self._start_round(kind, stats, None)

    def _start_round(self, kind: str, stats: Dict[str, int], gradients):
        with self._lock:
            if not self.connected():
                # The epoch can change between the caller's wants_gradients()
                # check and this call (peer joined/left). Elastic semantics:
                # the contribution is dropped, wants_gradients() comes back
                # once the new cohort settles (reference cancel path).
                utils.log_verbose(
                    "accumulator %s: dropping gradient contribution (not connected)",
                    self._name,
                )
                return
            if len(self._inflight) >= self._parallel_gradients:
                raise RpcError(
                    f"{len(self._inflight)} gradient reductions already in flight "
                    f"(parallel_gradients={self._parallel_gradients})"
                )
            if self._has_gradients:
                raise RpcError("unconsumed gradients; call zero_gradients() first")
            if kind == "count":
                fut = self._group.all_reduce(
                    f"__accum_count:{self._name}", dict(stats), op=_count_reduce_op
                )
                round_ = _Round(fut, kind="count", local=gradients)
            elif kind == "ring_full":
                fut = self._group.all_reduce(
                    f"__accum_grad:{self._name}",
                    gradients,
                    op="sum",
                    meta=dict(stats),
                    meta_op=_count_reduce_op,
                    wire=self._ring_wire_locked(),
                    chunked=True,
                    template=None if gradients is not None else self._ring_template_locked(),
                )
                round_ = _Round(fut, kind="full")
                if gradients is not None:
                    nb = _tree_nbytes(gradients)
                    self._reduce_bytes["rpc"] += nb
                    _M_REDUCE_BYTES.inc(nb, plane="rpc")
                    _M_INTERHOST.inc(nb, kind="grad")
                self._inflight.append(round_)
                fut.add_done_callback(lambda f, r=round_: self._on_ring_round_done(r, f))
                return
            else:
                payload = {
                    "grads": gradients,
                    "num_gradients": stats["num_gradients"],
                    "num_skipped": stats["num_skipped"],
                    "batch_size": stats["batch_size"],
                    "wire": self._wire_dtype,
                }
                fut = self._group.all_reduce(
                    f"__accum_grad:{self._name}",
                    payload,
                    op=_grad_reduce_op,
                    finalize=_wire_finalize(payload["wire"]),
                )
                round_ = _Round(fut, kind="full")
                if gradients is not None:
                    nb = _tree_nbytes(gradients)
                    self._reduce_bytes["rpc"] += nb
                    _M_REDUCE_BYTES.inc(nb, plane="rpc")
                    _M_INTERHOST.inc(nb, kind="grad")
            self._inflight.append(round_)
            fut.add_done_callback(lambda f, r=round_: self._on_round_done(r, f))

    def _ici_round(self, stats: Dict[str, int], gradients) -> None:
        """One reduction round over the collective data plane: all_reduce
        gradients and counts across the process group, then feed the
        result through the same application logic as an RPC round.

        The collective runs on a dedicated FIFO thread so the caller's train
        loop keeps pumping (broker pings must not stall while peers
        rendezvous — a blocked loop would get the peer evicted and wedge the
        cohort).  One thread per accumulator keeps rounds in issue order,
        which is identical on every peer (wants/has lockstep)."""
        with self._lock:
            if not self.connected():
                utils.log_verbose(
                    "accumulator %s: dropping gradient contribution (not connected)",
                    self._name,
                )
                return
            if self._has_gradients:
                raise RpcError("unconsumed gradients; call zero_gradients() first")
            if len(self._inflight) >= self._parallel_gradients:
                raise RpcError(
                    f"{len(self._inflight)} gradient reductions already in flight "
                    f"(parallel_gradients={self._parallel_gradients})"
                )
            self._grad_dtypes = nest.tree_map(_leaf_dtype, gradients)
            if self._ici_executor is None:
                self._ici_executor = _IciWorker(f"ici-{self._name}")
            # Captured under the lock: a cohort abort on the RPC handler
            # thread can null the attribute concurrently.  Submitting to an
            # abandoned worker is harmless — its late completion is ignored
            # via the round's done flag.
            executor = self._ici_executor
            round_ = _Round(None, kind="full", plane="ici")
            # Lockstep round index: issue order is identical on every peer
            # (wants/has protocol), so (epoch, seq) names the same logical
            # round cohort-wide — the abort-agreement key.
            round_.ici_seq = self._ici_round_seq
            self._ici_round_seq += 1
            self._inflight.append(round_)
        leaves, treedef = nest.tree_flatten(gradients)
        # The epoch tag rides inside the collective: a process group has no
        # notion of membership epochs, so a contribution stranded from a
        # cancelled epoch could pair with a fresh one.  Every process
        # contributes its sync_id (mod 8191: the f32 SUM of tags stays exact
        # for up to ~2^11 processes); if the reduced mean doesn't equal the
        # local epoch, every participant sees the same mismatch and errors
        # the round — wants_gradients() returns and the train loop
        # re-contributes in the settled epoch.
        epoch_tag = int(self._group.sync_id() or 0) % 8191
        counts = [stats["num_gradients"], stats["num_skipped"], stats["batch_size"],
                  epoch_tag]
        # One flat f32 tensor, counts at the tail, on the leaves' device
        # (NCCL reduces CUDA tensors, gloo CPU ones).
        dev = _tree_device(gradients) or torch.device("cpu")
        parts = [
            (l.detach() if isinstance(l, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(l))).to(dev, torch.float32).reshape(-1)
            for l in leaves
        ]
        parts.append(torch.tensor(counts, dtype=torch.float32, device=dev))
        flat = torch.cat(parts)
        shapes = [tuple(l.shape) for l in leaves]
        with self._lock:
            # Counted at submit time, like the RPC plane — a round that later
            # fails the epoch check still crossed the wire.
            nb = flat.numel() * 4
            self._reduce_bytes["ici"] += nb
            _M_REDUCE_BYTES.inc(nb, plane="ici")
        executor.submit(self._ici_execute, round_, flat, shapes, treedef, epoch_tag)

    def _ici_execute(self, round_: _Round, flat, shapes, treedef, epoch_tag: int) -> None:
        with self._lock:
            # The timeout clock starts when the collective actually starts:
            # a pipelined round queued behind another on the single-thread
            # executor must not have its queue wait counted against it.
            round_.t0 = time.monotonic()
        try:
            # Marks the collective for any open timeline capture window
            # (telemetry.timeline): host wall time in communication,
            # classified as exposed unless compute overlaps it.
            with telemetry.timeline.comm_span("accum.ici_allreduce"):
                summed = self._ici_allreduce(flat, round_)
            with self._lock:
                # Feeds the adaptive progress bound: healthy rounds this
                # slow must not be proposed for abort.
                self._ici_last_round_s = time.monotonic() - round_.t0
            counts_tot = summed[-4:].tolist()
            epoch_mean = float(counts_tot[3]) / _world_size()
            if abs(epoch_mean - epoch_tag) > 1e-3:
                raise RpcError(
                    f"ici reduction spanned mixed membership epochs "
                    f"(mean tag {epoch_mean} != local {epoch_tag}); retrying"
                )
            grads, off = [], 0
            for shape in shapes:
                n = int(np.prod(shape, dtype=np.int64))
                grads.append(summed[off:off + n].view(shape))
                off += n
            result = {
                "grads": treedef.unflatten(grads),
                "num_gradients": int(round(float(counts_tot[0]))),
                "num_skipped": int(round(float(counts_tot[1]))),
                "batch_size": int(round(float(counts_tot[2]))),
                "wire": None,
            }
            with self._lock:
                if round_.done:
                    return  # timed out by the pump while we were stuck
                self._ici_reduces += 1
                _M_REDUCES.inc(plane="ici")
                _M_REDUCE_LATENCY.observe(time.monotonic() - round_.t0, plane="ici")
                round_.done = True
                round_.result = result
                self._drain_rounds_locked()
        except Exception as e:  # noqa: BLE001 — surfaced via the round error
            with self._lock:
                if round_.done:
                    return  # already timed out; this is its stuck thread dying
                round_.done = True
                round_.error = e
                self._drain_rounds_locked()

    def _oldest_ici_locked(self):
        """Oldest not-done in-flight ICI round, or None.  ONE definition:
        the abort agreement keys off this on every peer, so the sweep and
        the proposal handler must never diverge on what 'oldest' means."""
        return next(
            (r for r in self._inflight
             if r.plane == "ici" and not r.done and r.ici_seq is not None),
            None,
        )

    def _abandon_ici_executor_locked(self) -> None:
        """Forget the (possibly wedged) collective worker; a fresh daemon
        thread is created on the next ICI round.  Late completions of
        abandoned work are ignored via each round's ``done`` flag."""
        if self._ici_executor is not None:
            self._ici_executor.shutdown(wait=False)
            self._ici_executor = None

    def _ici_progress_bound_now(self) -> float:
        """Effective no-progress bound: the configured floor, stretched to
        4x the last successful round so healthy-but-slow collectives (big
        payloads, slow DCN) don't get aborted by a bound tuned for fast
        rounds."""
        return max(self._ici_progress_bound, 4.0 * self._ici_last_round_s + 5.0)

    def _on_ici_abort(self, from_peer: str, epoch, seq) -> None:
        """RPC-plane abort proposal from a cohort member: its ICI round
        (epoch, seq) has made no progress past its progress bound with
        membership intact.  Recorded; unanimity aborts (see
        set_ici_progress_bound)."""
        with self._lock:
            if epoch != self._group.sync_id():
                return None  # stale epoch: those rounds were cancelled anyway
            self._ici_abort_proposals.setdefault((epoch, int(seq)), set()).add(from_peer)
            self._maybe_abort_ici_locked()
        return None

    def _maybe_abort_ici_locked(self) -> None:
        """Abort ALL in-flight ICI rounds once every cohort member has
        proposed aborting the oldest one.  Symmetric: peers issue rounds in
        lockstep and each sees the same full proposal set, so all peers
        abort the same rounds and suspend the same epoch."""
        epoch = self._group.sync_id()
        oldest = self._oldest_ici_locked()
        if oldest is None:
            # Nothing in flight this epoch: stale proposal records only.
            self._ici_abort_proposals = {
                k: v for k, v in self._ici_abort_proposals.items() if k[0] == epoch
            }
            return
        props = self._ici_abort_proposals.get((epoch, oldest.ici_seq), set())
        if not props >= set(self._group.members()):
            return
        self._ici_aborts += 1
        self._ici_suspended_epoch = epoch
        for r in list(self._inflight):
            if r.plane == "ici" and not r.done:
                r.done = True
                r.error = RpcError(
                    f"ici round {r.ici_seq} aborted by cohort agreement: no "
                    f"collective progress in {self._ici_progress_bound:.0f}s "
                    "with membership intact (wedged peer suspected); ici "
                    "plane suspended for this epoch, falling back to the "
                    "RPC plane"
                )
                utils.log_error("accumulator %s: %s", self._name, r.error)
                self._ici_abort_proposals.pop((epoch, r.ici_seq), None)
        self._abandon_ici_executor_locked()
        self._drain_rounds_locked()

    def _ici_allreduce(self, flat: torch.Tensor, round_=None) -> torch.Tensor:
        """Sum ``flat`` across the process group (``dist.all_reduce`` on this
        worker thread; the identity in a world of 1).

        The first collective of a shape runs an RPC-tree barrier first:
        NCCL builds its communicator lazily on first use, and per-process
        start-up skew must not eat the rendezvous window.  ``round_``'s
        progress clock is restamped after that warm-up so the no-progress
        abort never counts it (the barrier has its own 120 s bound)."""
        world = _world_size()
        key = (flat.numel(), flat.device.type)
        if key not in self._ici_fns:
            if round_ is not None:
                with self._lock:
                    round_.warming = True
            if world > 1:
                # An allreduce completes only when EVERY member contributes,
                # so barrier outcomes are symmetric: all peers pass together
                # or fail together (epoch cancel) — which is why the warm
                # cache is only written after success.
                self._group.all_reduce(f"__accum_ici_warm:{self._name}", 1).result(120)
            self._ici_fns[key] = True
            if round_ is not None:
                with self._lock:
                    round_.warming = False
                    round_.t0 = time.monotonic()
        if world > 1:
            import torch.distributed as dist

            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return flat

    def _fire_grad_round_locked(self):
        """Two-phase, phase 2: the global count met the virtual batch size —
        ship the locally-accumulated gradient sum in ONE allreduce.  Every
        peer reaches this decision at the same count-round index (the count
        results are identical cohort-wide), so the op sequence matches."""
        grads = self._fire_accum
        use_ring = self._use_ring_locked()
        if self._bucketed:
            # Flat-bucket fire: the locally-accumulated f32 sum stages into
            # the flat buffer (EF-q8 once, on the flat) and ships as
            # per-bucket pipelined ops; counts settled in phase 1 ride as
            # zeros (protocol uniformity, like the legacy paths below).
            # With the sharded plane on, the one fire allreduce per virtual
            # batch is itself sharded (reduce-scatter + all-gather).
            sharded = self._sharded
            ring = False if sharded else use_ring
            staged = (
                self._stage_flat(grads, ring=ring, sharded=sharded)
                if grads is not None
                else self._stage_flat_skip(ring)
            )
            if staged is not None:
                zero = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
                fire_stats = dict(self._fire_stats)
                self._fire_accum = None
                self._fire_stats = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
                if sharded:
                    self._start_sharded_round("grad", zero, staged, fire_stats=fire_stats)
                else:
                    self._start_flat_round("grad", zero, staged, use_ring,
                                           fire_stats=fire_stats)
                return
        if use_ring:
            # Phase 2 over the chunked ring: the accumulated f32 sum ships
            # directly (EF-quantized at the source when the wire is int8);
            # counts were settled in phase 1 so the meta rides as zeros
            # (every peer sends the same — protocol uniformity).
            grads = self._ring_q8_contrib(grads)
            zero = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
            fut = self._group.all_reduce(
                f"__accum_grad:{self._name}",
                grads,
                op="sum",
                meta=dict(zero),
                meta_op=_count_reduce_op,
                wire=self._ring_wire_locked(),
                chunked=True,
                template=None if grads is not None else self._ring_template_locked(),
            )
            round_ = _Round(fut, kind="grad", stats=dict(self._fire_stats))
            if grads is not None:
                nb = _tree_nbytes(grads)
                self._reduce_bytes["rpc"] += nb
                _M_REDUCE_BYTES.inc(nb, plane="rpc")
                _M_INTERHOST.inc(nb, kind="grad")
            self._fire_accum = None
            self._fire_stats = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
            self._inflight.append(round_)
            fut.add_done_callback(lambda f, r=round_: self._on_ring_round_done(r, f))
            return
        wire_name = self._wire_dtype
        if grads is not None:
            if self._wire_q8:
                grads, self._q_residual = _quantize_q8(grads, self._q_residual)
            elif self._wire_dtype is not None:
                grads = nest.tree_map(lambda g: _to_wire(g, wire_name), grads)
        payload = {
            "grads": grads,
            "num_gradients": 0,
            "num_skipped": 0,
            "batch_size": 0,
            "wire": wire_name,
        }
        fut = self._group.all_reduce(
            f"__accum_grad:{self._name}",
            payload,
            op=_grad_reduce_op,
            finalize=_wire_finalize(wire_name),
        )
        round_ = _Round(fut, kind="grad", stats=dict(self._fire_stats))
        if grads is not None:
            nb = _tree_nbytes(grads)
            self._reduce_bytes["rpc"] += nb
            _M_REDUCE_BYTES.inc(nb, plane="rpc")
            _M_INTERHOST.inc(nb, kind="grad")
        self._fire_accum = None
        self._fire_stats = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
        self._inflight.append(round_)
        fut.add_done_callback(lambda f, r=round_: self._on_round_done(r, f))

    def _on_round_done(self, round_, fut):
        with self._lock:
            round_.done = True
            round_.error = fut.exception()
            if round_.error is None:
                round_.result = fut.result(0)
                if round_.kind != "count":
                    _M_REDUCE_LATENCY.observe(
                        time.monotonic() - round_.t0, plane=round_.plane
                    )
            self._drain_rounds_locked()

    def _on_ring_round_done(self, round_, fut):
        """Adapter: a ring round resolves to ``(grads_f32, meta)``; normalize
        into the tree payload-dict shape so the drain logic stays single."""
        err = fut.exception()
        norm = None
        if err is None:
            value, meta = fut.result(0)
            norm = {"grads": value, "wire": None}
            norm.update(meta)
        with self._lock:
            round_.done = True
            round_.error = err
            round_.result = norm
            if err is None:
                _M_REDUCE_LATENCY.observe(
                    time.monotonic() - round_.t0, plane=round_.plane
                )
            self._drain_rounds_locked()

    def _drain_rounds_locked(self):
        """Apply completed rounds in issue order (pipelining keeps the order
        identical on every peer: the Group sequences same-name ops)."""
        while self._inflight and self._inflight[0].done:
            if self._inflight[0].error is not None:
                # Group changed or timeout: local contribution is lost; the
                # user will see wants_gradients() and produce a fresh one
                # (same observable behavior as the reference's cancel path).
                # Errored rounds free their pipeline slot even while a result
                # is pending consumption.
                round_ = self._inflight.popleft()
                _M_ROUND_ERRORS.inc()
                utils.log_verbose(
                    "accumulator %s: reduction failed: %s", self._name, round_.error
                )
                continue
            if self._has_gradients:
                break  # result pending consumption; apply after zero_gradients
            round_ = self._inflight.popleft()
            result = round_.result
            self._round_ms[round_.kind].append((time.monotonic() - round_.t0) * 1e3)
            if round_.kind != "count":
                # Gradient-carrying rounds record which data plane they rode
                # (count rounds are 3-int control traffic, not reductions).
                if round_.plane == "rpc":
                    self._rpc_reduces += 1
                    _M_REDUCES.inc(plane="rpc")
                self._last_plane = round_.plane
            if round_.kind == "count":
                # Phase 1 applied in issue order: fold this peer's local f32
                # contribution and the cohort-wide counts; fire the single
                # gradient allreduce once the virtual batch is met.
                if round_.local is not None:
                    if self._fire_accum is None:
                        self._fire_accum = round_.local
                    else:
                        self._fire_accum = _tree_add(self._fire_accum, round_.local)
                for k in ("num_gradients", "num_skipped", "batch_size"):
                    self._fire_stats[k] += result[k]
                target = self._virtual_batch_size or 1
                _M_VBATCH_FILL.set(
                    self._fire_stats["batch_size"] / target,
                    accumulator=self._name,
                    peer=self._rpc.get_name(),
                )
                if (
                    self._fire_stats["batch_size"] >= target
                    and self._fire_stats["num_gradients"] > 0
                ):
                    self._fire_grad_round_locked()
                continue
            if round_.kind == "grad":
                # Phase 2 result: the cohort gradient sum for one virtual batch.
                rg = _grads_to_f32(result)
                n = round_.stats["num_gradients"]
                if rg is not None:
                    if self._grad_dtypes is not None:
                        self._result_grads = nest.tree_map(
                            lambda x, dt: _cast(x / n, dt), rg, self._grad_dtypes
                        )
                    else:
                        self._result_grads = nest.tree_map(lambda x: x / n, rg)
                    self._result_stats = dict(round_.stats)
                    self._result_epoch = self._group.sync_id()
                    self._has_gradients = True
                    self._rec_note_first_result_locked()
                    _M_GRADIENTS.inc(round_.stats["num_gradients"])
                    _M_SKIPPED.inc(round_.stats["num_skipped"])
                    self._maybe_checksum_locked()
                continue
            # kind == "full": single-phase — accumulate across rounds until
            # the (trivial) target is met, in f32 when compression is on
            # (_grads_to_f32 also dequantizes q8 payloads).
            rg = _grads_to_f32(result) if result.get("wire") else result["grads"]
            if self._accum_grads is None and rg is not None:
                self._accum_grads = rg
            elif rg is not None:
                self._accum_grads = _tree_add(self._accum_grads, rg)
            for k in ("num_gradients", "num_skipped", "batch_size"):
                self._accum_stats[k] += result[k]
            target = self._virtual_batch_size or 1
            if self._accum_stats["batch_size"] >= target and self._accum_stats["num_gradients"] > 0:
                n = self._accum_stats["num_gradients"]
                if self._grad_dtypes is not None:
                    # Restore each leaf's original dtype (averaging in f32);
                    # set whenever leaves were converted on the way in (wire
                    # compression or the ICI f32 staging).
                    self._result_grads = nest.tree_map(
                        lambda x, dt: _cast(_f32_any(x) / n, dt),
                        self._accum_grads,
                        self._grad_dtypes,
                    )
                else:
                    self._result_grads = nest.tree_map(
                        lambda x: x / n, self._accum_grads
                    )
                self._result_stats = dict(self._accum_stats)
                self._result_epoch = self._group.sync_id()
                _M_GRADIENTS.inc(self._accum_stats["num_gradients"])
                _M_SKIPPED.inc(self._accum_stats["num_skipped"])
                self._accum_grads = None
                self._accum_stats = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
                self._has_gradients = True
                self._rec_note_first_result_locked()
                self._maybe_checksum_locked()

    def _maybe_checksum_locked(self) -> None:
        """Debug checksums (reference ``src/accumulator.cc:324-370``): CRC32
        the applied gradient result and allreduce (min, max) of the checksum
        across the cohort — every peer must have produced bit-identical
        bytes (the tree shares one result; the ring's all-gather forwards
        encoded bytes unchanged), so min != max means divergence, logged and
        counted.  Must be enabled on every peer or on none (the verify round
        is part of the op sequence)."""
        if not self._debug_checksums or self._result_grads is None:
            return
        import zlib

        crc = 0
        for leaf in nest.tree_leaves(self._result_grads):
            crc = zlib.crc32(_leaf_bytes(leaf), crc)
        version = self._model_version

        def minmax(a, b):
            return {"min": min(a["min"], b["min"]), "max": max(a["max"], b["max"])}

        # The round identity (cohort-synced model version at apply time) is
        # part of the op NAME: a peer that enabled checksums mid-epoch can
        # never pair its first verify with another peer's later round (that
        # would report false divergence forever).  During an enable
        # transition the op instead times out and counts as a failure below.
        fut = self._group.all_reduce(
            f"__accum_crc:{self._name}:{version}", {"min": crc, "max": crc}, op=minmax
        )

        def _done(f, crc=crc, version=version):
            try:
                r = f.result(0)
            except Exception as e:  # noqa: BLE001
                # Epoch churn cancels verify rounds benignly; anything else
                # (timeouts, path disagreement) must be visible — an operator
                # reading divergences == 0 needs to know verification RAN.
                with self._lock:
                    self._checksum_failures += 1
                log = utils.log_verbose if "group changed" in str(e) else utils.log_error
                log(
                    "accumulator %s: gradient checksum round (version %s) failed: %s",
                    self._name, version, e,
                )
                return
            if r["min"] != r["max"]:
                with self._lock:
                    self._checksum_divergences += 1
                utils.log_error(
                    "accumulator %s: GRADIENT DIVERGENCE at model version %s: "
                    "crc32 min=%08x max=%08x (local %08x)",
                    self._name, version, r["min"], r["max"], crc,
                )
            else:
                utils.log_verbose(
                    "accumulator %s: gradient crc32 %08x verified cohort-wide",
                    self._name, crc,
                )

        fut.add_done_callback(_done)

    # -------------------------------------------------- recovery accounting
    def _rec_mark_synced_locked(self) -> None:
        """This epoch's model sync just completed (transfer commit, warm
        rejoin, or becoming leader): close the model_sync phase."""
        now = time.monotonic()
        dt = now - self._rec_t_elect if self._rec_t_elect is not None else 0.0
        self._rec_phases.setdefault("model_sync", dt)
        telemetry.observe_phase("model_sync", dt)
        if self._rec_t_synced is None:
            self._rec_t_synced = now

    def _rec_note_first_reduce(self) -> None:
        """First gradient contribution call of this process: everything
        between sync and here is the train loop getting ready — dominated
        by the first build of its grad step (kernels, autotuning)."""
        with self._lock:
            if self._rec_t_first_reduce is not None:
                return
            now = time.monotonic()
            self._rec_t_first_reduce = now
            if self._rec_t_synced is not None:
                dt = now - self._rec_t_synced
                self._rec_phases.setdefault("first_compile", dt)
                telemetry.observe_phase("first_compile", dt)

    def _rec_note_first_result_locked(self) -> None:
        """First applied cohort gradient result: the peer is productive —
        the restart recovery chain is complete."""
        if "first_contribution" in self._rec_phases or self._rec_t_first_reduce is None:
            return
        dt = time.monotonic() - self._rec_t_first_reduce
        self._rec_phases["first_contribution"] = dt
        telemetry.observe_phase("first_contribution", dt)

    def recovery_info(self) -> Dict[str, Any]:
        """Where this peer's (re)start time went, phase by phase (docs/
        RESILIENCE.md "Recovery budget").  ``complete`` turns True at the
        first applied gradient result; soak harnesses persist this dict per
        restarted peer so every run shows a per-phase breakdown."""
        chain = (
            "reconnect", "re_elect", "model_sync",
            "first_compile", "first_contribution",
        )
        with self._lock:
            phases = {k: round(v, 3) for k, v in self._rec_phases.items()}
            complete = all(p in phases for p in chain)
            return {
                "phases_s": phases,
                "complete": complete,
                "total_s": round(sum(phases[p] for p in chain), 3) if complete else None,
                "model_sync_bytes_rx": self._model_sync_bytes_rx,
                "model_sync_bytes_tx": self._model_sync_bytes_tx,
                "warm_rejoin": self._warm_rejoin,
            }

    def gradients(self):
        """The cohort-averaged gradient tree (valid while has_gradients()),
        with the caller's dtypes restored: tensors on the device the
        gradients came from (each leaf one non-blocking H2D copy out of a
        pinned buffer), or host arrays for a peer that holds numpy."""
        with self._lock:
            if not self._has_gradients:
                raise RpcError("no gradients available")
            if self._result_on_device is None:
                device = self._grad_device or _tree_device(self._params)
                self._result_on_device = _to_device(self._result_grads, device)
            return self._result_on_device

    def get_gradient_stats(self) -> Dict[str, int]:
        return dict(self._result_stats)

    def debug_info(self) -> Dict[str, Any]:
        """Observability: which data plane reductions rode and at what cost —
        completed round counts per plane (collective vs RPC tree), bytes
        contributed per plane (post-compression, at send time), the last
        plane used, current eligibility, and the wire dtype.  Accumulator-
        level analogue of the reference's ``Rpc::debugInfo`` transport dump
        (``src/rpc.cc:1599-1623``)."""
        eligible = self._ici_eligible()
        with self._lock:
            wire = "q8" if self._wire_q8 else self._wire_dtype
            return {
                "ici_reduces": self._ici_reduces,
                "ici_aborts": self._ici_aborts,
                "ici_suspended": self._group.sync_id() == self._ici_suspended_epoch
                and self._ici_suspended_epoch is not None,
                "rpc_reduces": self._rpc_reduces,
                "checksum_divergences": self._checksum_divergences,
                "checksum_failures": self._checksum_failures,
                "last_plane": self._last_plane,
                "ici_eligible": eligible,
                "wire_dtype": wire,
                "reduce_bytes": dict(self._reduce_bytes),
                "model_sync_bytes": {
                    "rx": self._model_sync_bytes_rx,
                    "tx": self._model_sync_bytes_tx,
                },
                "warm_rejoin": self._warm_rejoin,
                "model_sync_sha": self._last_sync_sha,
                "model_sync_ms": self._last_sync_ms,
                "elections": self._elections,
                "d2h_staged_calls": self._d2h_calls,
                "round_ms": {k: float(np.median(v)) if v else None
                             for k, v in self._round_ms.items()},
                "rounds": {k: len(v) for k, v in self._round_ms.items()},
                # Flat-bucket data plane: enabled flag + the bucket size the
                # layouts were built with (wire protocol — must match
                # cohort-wide, docs/DESIGN.md "Gradient data plane").
                "bucketed": self._bucketed,
                "bucket_bytes": buckets.bucket_bytes(),
                # Sharded hierarchical reduce: enabled flag + cached
                # shard-pinned layouts (sharding-signature guarded; see
                # GradientShardingError).
                "sharded": self._sharded,
                "sharded_layouts": len(self._sharded_layouts),
                "last_launch_leads": list(self._last_launch_leads),
                # q8 over the chunked ring rides as contributor-side EF
                # quantization + bf16 hop transport (set_chunked_allreduce).
                "ring_q8_mode": (
                    "contributor_ef_bf16_hops"
                    if self._wire_q8 and self._use_ring_locked()
                    else None
                ),
            }

    def zero_gradients(self) -> None:
        with self._lock:
            self._has_gradients = False
            self._result_grads = None
            self._result_on_device = None
            # Only bump the model version for a result produced under the
            # CURRENT epoch. A result consumed across an epoch boundary was
            # possibly seen by this peer alone (other peers' share of the
            # round was cancelled); bumping would advance our version past
            # the freshly-elected leader's and orphan us from the cohort —
            # instead the version stays put and the leader's model sync
            # reconverges us (full-reset semantics, reference
            # src/accumulator.cc:555-626).
            if self._result_epoch == self._group.sync_id():
                self._model_version += 1
            else:
                _M_STALE.inc()
                # Params changed without a version bump: this peer must not
                # claim to be "current" at its version — the next epoch's
                # model sync (full transfer, never the warm fast path)
                # reconverges it.  The leader-side chunk cache is keyed by
                # version, so it no longer names these params either.
                self._stale_applies += 1
                self._sync_cache = None
                utils.log_verbose(
                    "accumulator %s: consumed a result from a dead epoch; "
                    "model version not advanced",
                    self._name,
                )
            # Pipelined rounds that completed while the result was pending
            # consumption can now be applied.
            self._drain_rounds_locked()

    # ------------------------------------------------------------------ pump
    def update(self) -> None:
        """Internal book-keeping; call every iteration of the train loop."""
        if self._standalone:
            self._group.update()
        now = time.monotonic()
        leader_queries = []
        with self._lock:
            leader = self._leader
            is_leader = self._is_leader
            synced = self._epoch_synced
            rec_active = not (
                self._group.active() and leader is not None and synced
            )
            if rec_active != self._recovery_active_gauge:
                self._recovery_active_gauge = rec_active
                _M_RECOVERY_ACTIVE.set(
                    1.0 if rec_active else 0.0,
                    accumulator=self._name,
                    peer=self._rpc.get_name(),
                )
            # Election repair: leaderless past the deadline on an active
            # epoch — learn the result from a member / re-issue the vote.
            if (
                leader is None
                and self._election_retry_at is not None
                and now > self._election_retry_at
                and self._group.active()
            ):
                leader_queries = self._retry_election_locked(now)
            # Time out ICI rounds stranded by a cohort member dying
            # mid-collective (the runtime rendezvous can hang forever).
            # Gated on the membership no longer matching the process set: a
            # round is only declared dead once the broker actually evicted a
            # peer — a healthy-but-slow collective (the first-use warm
            # barrier) never gets unilaterally timed out, which would let one
            # peer discard a result its peers applied.  When the gate fires,
            # the dead process can no longer complete anyone's collective, so
            # erroring is symmetric; and the epoch change that accompanied the
            # eviction re-elects and re-syncs the model, which reconverges any
            # peer that raced the boundary.  The executor thread may be stuck
            # inside the collective: abandon it (a fresh one is created on
            # the next ICI round).
            stuck = [
                r for r in self._inflight
                if r.plane == "ici" and not r.done and now - r.t0 > self._ici_timeout
            ]
            if stuck and not self._ici_eligible_locked_hint():
                for round_ in stuck:
                    round_.done = True
                    round_.error = RpcError(
                        f"ici reduction timed out after {self._ici_timeout:.0f}s "
                        "with the cohort no longer matching the process set "
                        "(member died mid-collective); falling back to the RPC plane"
                    )
                    utils.log_error("accumulator %s: %s", self._name, round_.error)
                self._abandon_ici_executor_locked()
            # Wedged-ALIVE-peer escalation (membership INTACT but the oldest
            # ICI round makes no progress): propose a cohort-wide abort over
            # the RPC plane, once per (epoch, seq).  Unanimity aborts — see
            # _maybe_abort_ici_locked / set_ici_progress_bound.
            abort_send = None
            oldest_ici = self._oldest_ici_locked()
            if (
                oldest_ici is not None
                and not oldest_ici.warming
                and now - oldest_ici.t0 > self._ici_progress_bound_now()
                and self._ici_eligible_locked_hint()
            ):
                key = (self._group.sync_id(), oldest_ici.ici_seq)
                if key not in self._ici_abort_sent:
                    self._ici_abort_sent.add(key)
                    me = self._rpc.get_name()
                    self._ici_abort_proposals.setdefault(key, set()).add(me)
                    abort_send = (key, [m for m in self._group.members() if m != me])
                    self._maybe_abort_ici_locked()
            self._drain_rounds_locked()
            # Commit a staged model update (deferred so the user thread owns
            # the model, reference commitModelUpdate src/accumulator.cc:810-836).
            if self._staged_model is not None:
                epoch, version, params, buffers, state = self._staged_model
                self._staged_model = None
                if epoch == self._group.sync_id():
                    # Host leaves of the blob become tensors on this peer's
                    # device (that of the parameters it held).
                    device = _tree_device(self._params)
                    self._params = _adopt_tree(params, device)
                    state = _adopt_tree(state, device)
                    if buffers is not None:
                        self._buffers = _adopt_tree(buffers, device)
                        self._buffers_version = version
                    self._model_version = version
                    if state is not None:
                        self._received_state = state
                        self._has_new_state = True
                    if not self._epoch_synced:
                        self._rec_mark_synced_locked()
                    self._epoch_synced = True
                    self._stale_applies = 0  # leader's model adopted
                    if self._rec_t_elect is not None:
                        self._last_sync_ms = (time.monotonic() - self._rec_t_elect) * 1e3
                    # The chunk buffer served its purpose; free it.
                    self._in_transfer = None
                    synced = True
                # else: staged under an epoch that died before commit — the
                # chunk buffer (if any) stays for the resume re-request.
        if abort_send is not None:
            # Outside the lock: async sends must not nest under state the
            # RPC handlers need.
            (epoch, seq), targets = abort_send
            for m in targets:
                self._rpc.async_callback(
                    m, "__accum_ici_abort", lambda r, e: None,
                    self._name, self._rpc.get_name(), epoch, seq,
                )
        for m, fn, cb, *qargs in leader_queries:
            self._rpc.async_callback(m, fn, cb, *qargs)
        # Non-leader that hasn't synced this epoch: (re-)request the model,
        # advertising what we already hold — the checkpoint-restored version
        # (warm rejoin skips the transfer entirely) and any partial chunk
        # buffer (the new leader resumes from the last acked chunk).
        if leader is not None and not is_leader and not synced:
            if now - self._last_model_request > _MODEL_REQUEST_RETRY:
                self._last_model_request = now
                with self._lock:
                    # The current-model fast path is ONLY for a freshly
                    # (re)started peer advertising its checkpoint-restored
                    # version — before its first sync in this process.  An
                    # ESTABLISHED peer always takes the full transfer on an
                    # epoch change: its params have been mutated by applied
                    # rounds, and the full re-sync is the universal
                    # divergence heal the elastic protocol is built on
                    # (full-reset semantics).  Stale-epoch consumes
                    # (_stale_applies) disqualify the fast path too.
                    fresh_process = self._rec_t_synced is None
                    have_version = (
                        self._model_version
                        if fresh_process and not self._stale_applies
                        else -1
                    )
                    resume_version, resume_chunks = -1, 0
                    t = self._in_transfer
                    if t is not None:
                        resume_version = t["version"]
                        while resume_chunks in t["chunks"]:
                            resume_chunks += 1
                self._rpc.async_callback(
                    leader,
                    "__accum_request_model",
                    self._on_request_model_reply,
                    self._name,
                    self._rpc.get_name(),
                    have_version,
                    resume_version,
                    resume_chunks,
                )
        # Leader: periodic model/buffer pushes keep long-lived cohorts fresh.
        if is_leader and self._group.active():
            if now - self._last_model_push > _MODEL_PUSH_INTERVAL:
                self._last_model_push = now
                self._broadcast_model()
            elif self._buffers is not None and now - self._last_buffers_push > _BUFFERS_PUSH_INTERVAL:
                self._last_buffers_push = now
                self._broadcast_buffers()
        self._notify_version()

    # ------------------------------------------------------------- elections
    def _on_group_change(self):
        """Membership epoch changed: reset transient state, elect a leader
        (allreduce of max(model_version, name), reference :581-625)."""
        with self._lock:
            now = time.monotonic()
            self._rec_t_epoch = now
            if self._rec_t_active is None and self._group.active():
                # First membership epoch that includes this peer: the
                # reconnect phase (broker dial + first push) is over.
                self._rec_t_active = now
                dt = now - self._rec_t_init
                self._rec_phases.setdefault("reconnect", dt)
                telemetry.observe_phase("reconnect", dt)
            self._leader = None
            self._is_leader = False
            self._election_retry_at = None  # fresh epoch, fresh election
            self._epoch_synced = False
            self._staged_model = None
            # Outbound chunk chains die with the epoch (their acks see the
            # stale epoch and stop); unsynced peers re-request and resume.
            self._active_transfers.clear()
            self._sync_cache = None
            self._buffers_version = -1
            # Old-epoch rounds are dead; their futures error via the Group's
            # cancel, but the records must go now so new rounds can start.
            self._inflight.clear()
            # ICI round sequencing and abort agreement are per-epoch.
            self._ici_round_seq = 0
            self._ici_abort_proposals.clear()
            self._ici_abort_sent.clear()
            self._accum_grads = None
            self._accum_stats = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
            self._fire_accum = None
            self._fire_stats = {"num_gradients": 0, "num_skipped": 0, "batch_size": 0}
            # Open checkpoint epochs are epoch-stamped; checkpoint_tick
            # notices the mismatch and aborts with accounting.  Nothing to
            # clear here — clearing now would skip the abort counter.
            if not self._group.active():
                return
            epoch = self._group.sync_id()
            fut = self._group.all_reduce(
                f"__accum_elect:{self._name}",
                (self._model_version, self._rpc.get_name()),
                op=lambda a, b: max(a, b),  # lexicographic (version, name)
            )
            fut.add_done_callback(
                lambda f, e=epoch: self._on_election_done(f, e)
            )

    def _on_election_done(self, fut, epoch=None):
        exc = fut.exception()
        if exc is not None:
            utils.log_verbose("accumulator %s: election failed: %s", self._name, exc)
            with self._lock:
                if (
                    self._leader is None
                    and self._group.active()
                    and (epoch is None or epoch == self._group.sync_id())
                ):
                    # Schedule the repair path (see __init__ / update()):
                    # without it a timed-out election on a STABLE epoch
                    # leaves this peer leaderless forever.  Epoch-guarded: a
                    # dead epoch's election cancelled by a membership change
                    # must not arm retries against the NEW epoch's election
                    # (a spurious extra __accum_elect op would desync the
                    # per-name op sequence across peers).
                    self._election_retry_at = (
                        time.monotonic() + self._election_retry_interval
                    )
            return
        version, leader = fut.result(0)
        with self._lock:
            if epoch is not None and epoch != self._group.sync_id():
                return  # stale epoch's result (cancellation raced)
            if self._leader is not None:
                return  # repair path already adopted this epoch's result
            self._adopt_leader_locked(leader, version)
        utils.log_info(
            "accumulator %s: leader=%s (version %s)%s",
            self._name,
            leader,
            version,
            " [me]" if self._is_leader else "",
        )

    def _adopt_leader_locked(self, leader: str, version) -> None:
        """Install this epoch's election result (from our own allreduce or
        learned from a member that completed it)."""
        now = time.monotonic()
        self._leader = leader
        self._is_leader = leader == self._rpc.get_name()
        self._election_retry_at = None
        _M_ELECTIONS.inc()
        self._elections += 1
        telemetry.flight_event("accum.election", accumulator=self._name,
                               leader=leader, is_leader=self._is_leader)
        _M_IS_LEADER.set(
            1.0 if self._is_leader else 0.0,
            accumulator=self._name,
            peer=self._rpc.get_name(),
        )
        if self._rec_t_epoch is not None:
            dt = now - self._rec_t_epoch
            self._rec_phases.setdefault("re_elect", dt)
            telemetry.observe_phase("re_elect", dt)
        self._rec_t_elect = now
        if self._is_leader:
            if not self._epoch_synced:
                self._rec_mark_synced_locked()
            self._epoch_synced = True
            self._in_transfer = None  # leading means our model IS the model
            if self._stale_applies:
                # Our params are exactly this many cohort results ahead of
                # our version number (stale-epoch consumes).  Bump so the
                # version names these bytes again — otherwise a clean peer
                # still AT the old version would warm-skip the sync and the
                # cohort would hold two byte strings under one version.
                self._model_version += self._stale_applies
                utils.log_info(
                    "accumulator %s: new leader absorbing %d stale-epoch "
                    "result(s) into version %d",
                    self._name, self._stale_applies, self._model_version,
                )
                self._stale_applies = 0
            self._last_model_push = now
        self._last_model_request = 0.0

    def _on_leader_query(self, epoch):
        """A leaderless member asks for this epoch's election result.  Any
        completed result is safe to share: the allreduce only completes
        once EVERY member (including the asker) contributed its
        ``(version, name)`` vote."""
        with self._lock:
            if epoch != self._group.sync_id() or self._leader is None:
                return None
            return (self._leader, self._model_version)

    def _retry_election_locked(self, now: float):
        """Leaderless past the retry deadline (update() pump): learn the
        result from members that have it, and re-issue the election for
        the case where the op died on everyone (then all leaderless peers
        re-issue together, so the retry allreduce can complete)."""
        self._election_retry_at = now + self._election_retry_interval
        epoch = self._group.sync_id()
        members = [m for m in self._group.members() if m != self._rpc.get_name()]
        fut = self._group.all_reduce(
            f"__accum_elect:{self._name}",
            (self._model_version, self._rpc.get_name()),
            op=lambda a, b: max(a, b),
        )
        fut.add_done_callback(lambda f, e=epoch: self._on_election_done(f, e))

        def _learned(result, error, epoch=epoch):
            if error is not None or result is None:
                return
            leader, version = result
            with self._lock:
                if epoch != self._group.sync_id() or self._leader is not None:
                    return
                self._adopt_leader_locked(leader, version)
            utils.log_info(
                "accumulator %s: leader=%s (version %s) [learned from a "
                "member after a failed election]",
                self._name, leader, version,
            )

        return [
            (m, "__accum_leader_query", _learned, self._name, epoch)
            for m in members
        ]

    # --------------------------------------------------------- model service
    def _on_request_model(self, requester: str, have_version: int = -1,
                          resume_version: int = -1, resume_chunks: int = 0):
        """A peer asks for the model, advertising the version it already
        holds (``have_version``, e.g. from a warm-loaded checkpoint) and any
        partial transfer buffer (``resume_version``/``resume_chunks``).

        Warm rejoin: when the advertised version already matches the
        leader's, the reply is ``("current", epoch, version)`` — the peer is
        synced with ZERO model bytes on the wire and no wait for the user's
        ``set_state`` call.  Otherwise the requester queues for
        wants_state()/set_state() exactly like the reference."""
        with self._lock:
            if not self._is_leader:
                raise RpcError(f"{self._rpc.get_name()} is not the leader")
            version = self._model_version
            if version > 0 and have_version == version and not self._stale_applies:
                # A restored peer at EXACTLY our version: nothing to
                # transfer.  Strict equality — a requester somehow AHEAD of
                # the leader must take the full transfer below (adopting
                # the leader's model, full-reset semantics); confirming it
                # "current" at a version it doesn't hold would leave it
                # permanently unsynced (its reply handler checks equality).
                # A STALE leader (params mutated without a version bump)
                # must not confirm anyone either — its version number no
                # longer names its bytes; the full transfer heals.
                utils.log_info(
                    "accumulator %s: warm rejoin of %s at version %s "
                    "(zero model-sync bytes)", self._name, requester, version,
                )
                return ("current", self._group.sync_id(), version)
            active = self._active_transfers.get(requester)
            if active == (self._group.sync_id(), version):
                # A chunk chain to this peer is already running under the
                # current epoch; a periodic re-request must not fork a
                # second one.
                return ("queued",)
            if not any(r[0] == requester for r in self._state_requesters):
                self._state_requesters.append(
                    (requester, int(have_version), int(resume_version),
                     int(resume_chunks))
                )
        return ("queued",)

    def _on_request_model_reply(self, result, error) -> None:
        """Requester side of the warm-rejoin fast path: a ``current`` reply
        synchronizes the epoch without any model transfer."""
        if error is not None or not isinstance(result, (list, tuple)) or not result:
            return
        if result[0] != "current":
            return
        _, epoch, version = result
        with self._lock:
            if epoch != self._group.sync_id() or self._epoch_synced:
                return
            if version != self._model_version:
                return  # raced a version change; the retry re-advertises
            self._epoch_synced = True
            self._in_transfer = None
            self._warm_rejoin = True
            _M_WARM_REJOINS.inc()
            self._rec_mark_synced_locked()

    def _on_model_update(self, epoch, version: int, params, buffers, state):
        with self._lock:
            # Pushes are epoch-stamped by the sender: a delayed push from a
            # previous epoch's leader must never land in the new epoch.
            if epoch != self._group.sync_id():
                return False
            # Reject stale periodic pushes only once synced. An UNSYNCED peer
            # adopts the elected leader's model even if its own version is
            # higher: a round applied in the epoch-change window can orphan a
            # local version the cohort never shared, and refusing the leader
            # would wedge this peer out of the epoch forever.
            if self._epoch_synced and version < self._model_version:
                return False
            self._staged_model = (epoch, version, params, buffers, state)
        return True

    def _on_buffers_update(self, epoch, version: int, buffers):
        with self._lock:
            # Stamped like model pushes: a delayed periodic push from a
            # previous epoch's leader (or a stale in-flight push during
            # leader change) must not overwrite newer buffers. The guard
            # compares against the last *applied* buffers version, not our
            # model version — the follower's own counter can transiently run
            # ahead of the leader's (it consumed a result first), and that
            # must not reject fresh same-epoch pushes.
            if epoch != self._group.sync_id() or version < self._buffers_version:
                return False
            if buffers is not None:
                self._buffers = buffers
                self._buffers_version = version
        return True

    def _broadcast_model(self):
        with self._lock:
            members = [m for m in self._group.members() if m != self._rpc.get_name()]
            params, buffers, version = self._params, self._buffers, self._model_version
            epoch = self._group.sync_id()
        for peer in members:
            self._rpc.async_callback(
                peer,
                "__accum_model_update",
                lambda r, e: None,
                self._name,
                epoch,
                version,
                params,
                buffers,
                None,
            )

    def _broadcast_buffers(self):
        with self._lock:
            members = [m for m in self._group.members() if m != self._rpc.get_name()]
            buffers, version = self._buffers, self._model_version
            epoch = self._group.sync_id()
        for peer in members:
            self._rpc.async_callback(
                peer,
                "__accum_buffers_update",
                lambda r, e: None,
                self._name,
                epoch,
                version,
                buffers,
            )

    def decommissioned(self) -> bool:
        return self._decommissioned

    def decommission(self, timeout: float = 30.0) -> bool:
        """Graceful scale-down (autoscaler shrink path).  Two steps:

        1. **Drain**: pump until every in-flight reduction round this peer
           joined has settled, so contributions other peers already merged
           aren't abandoned mid-round.  A partial LOCAL virtual-batch sum
           (``_fire_accum``) that never fired is dropped — it was never on
           the wire, and the two-phase count protocol keeps the cohort's
           effective batch size at the configured target regardless.
        2. **Leave**: explicit ``__broker_leave`` so the cohort's epoch bumps
           immediately instead of waiting out the ping-eviction timeout.

        Returns True if the broker acked the leave; False means the drain or
        the leave timed out and the cohort will fall back to ordinary
        ping eviction (correct, just slow)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.update()
            with self._lock:
                if not self._inflight:
                    break
            time.sleep(0.01)
        with self._lock:
            drained = not self._inflight
            self._decommissioned = True
        left = self._group.leave(timeout=max(1.0, deadline - time.monotonic()))
        return left and drained

    def close(self) -> None:
        if self._ici_executor is not None:
            self._ici_executor.shutdown(wait=False)
        if self._standalone:
            self._rpc.close()


def _is_q8(g) -> bool:
    return isinstance(g, dict) and g.get("fmt") == "q8"


def _quantize_q8(gradients, residual):
    """Per-leaf absmax int8 quantization with error feedback: the local
    rounding error joins the *next* contribution, so compression noise
    averages out instead of biasing the descent direction (EF-SGD)."""
    leaves, treedef = nest.tree_flatten(gradients)
    res_leaves = (
        nest.tree_leaves(residual) if residual is not None else [None] * len(leaves)
    )
    qs, scales, new_res = [], [], []
    for g, r in zip(leaves, res_leaves):
        f = _np_f32(g)
        if r is not None and r.shape == f.shape:
            f = f + r
        scale = float(np.max(np.abs(f))) / 127.0 if f.size else 0.0
        if scale == 0.0 or not np.isfinite(scale):
            # Zero leaf — or a NaN/Inf gradient (loss-scale overflow etc.):
            # contribute zero this round and RESET the residual, so one bad
            # step can't poison error feedback forever.
            if scale != 0.0:
                utils.log_error("accumulator: non-finite gradient leaf; q8 zeroed")
            q = np.zeros(f.shape, np.int8)
            err = np.zeros(f.shape, np.float32)
        else:
            q = np.clip(np.rint(f / scale), -127, 127).astype(np.int8)
            err = f - q.astype(np.float32) * scale
        qs.append(q)
        scales.append(np.float32(scale))
        new_res.append(err)
    return (
        {
            "fmt": "q8",
            "q": treedef.unflatten(qs),
            "s": treedef.unflatten(scales),
        },
        treedef.unflatten(new_res),
    )


def _dequantize_q8(g):
    return nest.tree_map(
        lambda q, s: np.asarray(q).astype(np.float32) * np.float32(s), g["q"], g["s"]
    )


def _q8_add(a, b):
    """Combine two q8 payloads at a tree hop: dequantize, add in f32,
    re-quantize against the combined absmax (no error feedback at hops —
    EF state is per-contributor)."""
    return _quantize_q8(_tree_add(_dequantize_q8(a), _dequantize_q8(b)), None)[0]


def _count_reduce_op(a, b):
    """Two-phase phase-1 op: sum the three count fields (3 ints on the wire
    per contribution — the reference's cheap count allreduce,
    ``src/accumulator.cc:1035-1078``)."""
    return {k: a[k] + b[k] for k in ("num_gradients", "num_skipped", "batch_size")}


def _grads_to_f32(p):
    """The gradient tree of a payload/partial, as float32 (None for skips)."""
    g = p.get("grads")
    if g is None:
        return None
    if _is_q8(g):
        return _dequantize_q8(g)
    return nest.tree_map(_np_f32, g)


def _wire_finalize(wire):
    """Group ``finalize`` hook: re-round a node's f32 partial sum to the wire
    dtype once per hop.  Together with ``_grad_reduce_op`` accumulating in
    f32, this gives log2(n) roundings instead of n-1 lossy adds, so small
    contributions are never absorbed by a large running sum (the documented
    wire-compression contract).  Returns None (no hook) when uncompressed."""
    if wire is None:
        return None

    def finalize(p):
        if not (isinstance(p, dict) and p.get("fmt") == "f32"):
            return p  # leaf pass-through: already in wire format
        p = dict(p)
        p.pop("fmt")
        g = p.get("grads")
        if g is not None:
            if wire == "int8":
                p["grads"] = _quantize_q8(g, None)[0]
            else:
                p["grads"] = nest.tree_map(lambda x: _to_wire(x, wire), g)
        return p

    return finalize


def _grad_reduce_op(a, b):
    """Reduce two gradient-round payloads: counts add, grad pytrees add
    (None = a skip contribution).

    Wire compression: leaves arrive in the wire dtype (e.g. bf16/int8); the
    partial sum is kept in float32 (marked ``fmt: "f32"``) while the node
    reduces, and ``_wire_finalize`` re-rounds it to the wire dtype before it
    travels on.  A bf16 leaf may be a ``torch.bfloat16`` tensor (the port's
    codec) or an ml_dtypes array (a JAX peer's), so the gate is "wire set"
    rather than any dtype-kind test.
    """
    if isinstance(a, dict) and "num_gradients" in a:
        wire = a.get("wire") or b.get("wire")
        out = {
            "num_gradients": a["num_gradients"] + b["num_gradients"],
            "num_skipped": a["num_skipped"] + b["num_skipped"],
            "batch_size": a["batch_size"] + b["batch_size"],
            "wire": wire,
        }
        if wire is not None:
            # Accumulate in f32; finalize re-rounds once per hop. Mixed wire
            # configs in one elastic cohort also land here (never cast an
            # unscaled sum to int8 — q8 re-quantization carries its scale).
            fa, fb = _grads_to_f32(a), _grads_to_f32(b)
            grads = fa if fb is None else (fb if fa is None else _tree_add(fa, fb))
            out["grads"] = grads
            out["fmt"] = "f32"
        else:
            ga, gb = a.get("grads"), b.get("grads")
            out["grads"] = ga if gb is None else (gb if ga is None else _tree_add(ga, gb))
        return out
    return a + b
