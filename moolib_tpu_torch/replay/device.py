"""Device-resident prioritized replay: ring storage and sum-tree as tensors.

The port of the JAX package's ``replay/device.py``.  The host store
(:mod:`moolib_tpu_torch.replay.host`) keeps items as python lists and walks
a numpy sum-tree under a lock; here the whole store lives on the shard's
device (CUDA unless the caller passes ``device="cpu"``):

- :class:`DeviceSumTree` — the sum-tree is one ``[2*capacity]`` tensor
  (same layout as the numpy reference: root at 1, leaves at
  ``[capacity, 2*capacity)``).  ``set`` writes leaf values and rebuilds the
  internal levels in place, one pairwise sum per level — the same f32
  additions the reference's touched-path walk performs, so the tree is
  bit-exact against ``host.SumTree`` at equal dtype.  ``sample`` descends
  all targets in lockstep with a fixed trip count.
- :class:`DeviceReplayShard` — one ``[capacity, ...]`` ring tensor per
  pytree leaf, allocated on the first ``add``.  Every mutation writes in
  place: the tree, the ring leaves and the running max priority keep their
  storage (``data_ptr()``) for the shard's life.

What JAX gives the reference and torch does not, and what stands in:

- *No ``mode="drop"`` scatter.*  The reference pads insert and update
  lanes and sends the padding to an out-of-bounds slot that XLA drops; on
  CUDA an out-of-bounds index is a device-side assert.  The lane count is a
  host int, so the ring insert writes only its ``n`` rows, as at most two
  contiguous slices of the ring (it wraps once), and the update writes only
  its ``n`` leaves.  Indices from the host are range-checked before they
  reach the card.
- *Duplicate indices.*  A scatter with duplicate indices resolves in
  unspecified order, in torch as in JAX.  Each update lane takes the value
  of the LAST lane that holds the same slot, so duplicates write one value
  and the write-back is last-wins, as the reference's ``dup_later`` mask
  and the numpy ``tree[pos] = value`` make it.
- *No donation.*  The reference donates the tree and the ring into each
  jit; here they are written in place (slice copies, ``index_put_``,
  ``torch.add(..., out=)`` level by level).
- *Seeding.*  torch's Philox cannot reproduce threefry.  The contract is
  kept rather than the stream: a draw's uniforms depend only on (seed,
  draw count), through a device ``torch.Generator`` reseeded per draw and
  never the global RNG.  :func:`_draw` maps (uniforms, tree, size,
  overrides) to (indices, weights), which is where parity with the JAX
  package is held given the same uniforms.
- *``epsneg``.*  ``torch.finfo`` has none; for a binary float it is
  ``eps / 2`` (2**-24 in f32), and the target guard stays dtype-aware.
- *Divisions by a Python number* run on CUDA as a multiply by its
  reciprocal, which is not the IEEE quotient; the draw divides by device
  scalars so the card and the CPU compute the same quotients.

The priority transform ``p -> max(p, 1e-6)**alpha``
(:meth:`DeviceReplayShard.priority_transform`) is shared by insert and
update; tests feed the same function's outputs to the numpy reference,
which makes the bit-exactness comparison exact rather than
tolerance-based.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve
from ..utils import nest
from ._metrics import (
    REPLAY_FRAMES,
    REPLAY_OCCUPANCY,
    REPLAY_PRIORITY_ROUNDS,
    REPLAY_SAMPLE_SECONDS,
)

_INSTANCE_SEQ = itertools.count()


def _pow2(n: int) -> int:
    cap = 1
    while cap < n:
        cap *= 2
    return cap


def _epsneg(dtype: torch.dtype) -> float:
    """numpy's ``finfo(dtype).epsneg``: the gap below 1.0, ``eps / 2`` for a
    binary float."""
    return torch.finfo(dtype).eps / 2


def _rebuild(tree: torch.Tensor, cap: int) -> None:
    """Recompute the internal levels of ``tree`` [2*cap] from its leaf level
    [cap, 2*cap), in place, bottom up: one pairwise sum per level (index 0
    stays zero, the root lands at index 1)."""
    lo = cap
    while lo > 1:
        torch.add(tree[lo : 2 * lo : 2], tree[lo + 1 : 2 * lo : 2], out=tree[lo // 2 : lo])
        lo //= 2


def _descend(tree: torch.Tensor, targets: torch.Tensor, capacity: int) -> torch.Tensor:
    """Lockstep sum-tree descent: the leaf index whose prefix-sum interval
    contains each target, ``capacity.bit_length() - 1`` levels for all."""
    t = targets.to(tree.dtype)
    idx = torch.ones(t.shape, dtype=torch.int64, device=tree.device)
    for _ in range(capacity.bit_length() - 1):
        left = tree[2 * idx]
        go_right = t > left
        t = torch.where(go_right, t - left, t)
        idx = 2 * idx + go_right
    return idx - capacity


def _last_wins(idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """For each lane, the value of the last lane holding the same index, so
    that a scatter of the result is deterministic and last-wins."""
    lanes = torch.arange(idx.shape[0], device=idx.device)
    same = idx[None, :] == idx[:, None]
    last = torch.where(same, lanes[None, :], -1).amax(dim=1)
    return values[last]


def _as_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        # A borrowed ingest view is read-only; torch wants its own copy.
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=device, dtype=dtype, non_blocking=True)


def _indices(idx, device: torch.device, capacity: int) -> torch.Tensor:
    """Slot indices as a 1-D int64 tensor on ``device``; int32 (a JAX peer's)
    and int64 both pass.  Host input is range-checked here: on the card an
    out-of-range slot would be a device-side assert."""
    if not (isinstance(idx, torch.Tensor) and idx.device.type == "cuda"):
        host = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
        host = np.atleast_1d(host).astype(np.int64)
        if host.size and (host.min() < 0 or host.max() >= capacity):
            raise IndexError(
                f"replay slot out of range [0, {capacity}): {host.min()}..{host.max()}"
            )
        idx = torch.from_numpy(host)
    return idx.reshape(-1).to(device=device, dtype=torch.int64, non_blocking=True)


def _draw(
    u: torch.Tensor,
    tree: torch.Tensor,
    treecap: int,
    size: int,
    size_override: int,
    total_override: float,
    beta: float,
):
    """The stratified proportional draw given its uniforms ``u`` [batch]:
    (int64 slot indices, importance weights).

    Indices clip against the LOCAL occupancy ``size`` (never-written slots
    have zero priority).  ``size_override``/``total_override`` are the
    cohort-wide N and priority total of the two-level draw: they only
    rescale the weights; 0 keeps the shard-local correction."""
    dt, dev = tree.dtype, tree.device
    total = tree[1]
    seg = total / torch.full((), u.shape[0], dtype=dt, device=dev)
    targets = (torch.arange(u.shape[0], dtype=dt, device=dev) + u) * seg
    # Largest representable value strictly below total in the tree's own
    # dtype (1 - 1e-9 rounds to exactly 1.0 in f32).
    targets = torch.minimum(targets, total * (1 - _epsneg(dt)))
    idx = _descend(tree, targets, treecap).clamp_(0, max(size - 1, 0))
    eff_total = (torch.full((), total_override, dtype=dt, device=dev)
                 if total_override > 0 else total)
    eff_n = size_override if size_override > 0 else size
    probs = tree[treecap + idx] / eff_total.clamp(min=1e-12)
    w = (probs.clamp(min=1e-12) * float(eff_n)) ** (-beta)
    return idx, w / w.max()


class DeviceSumTree:
    """Sum-tree as a device tensor with set/get/sample.

    ``set`` is last-wins on duplicate indices.  Entry point: CUDA unless
    ``device`` names another."""

    def __init__(self, capacity: int, dtype=torch.float32, name: str = "replay_tree",
                 device=None):
        self.capacity = _pow2(capacity)
        self.dtype = dtype
        self.device = resolve(device)
        self.name = f"{name}[{next(_INSTANCE_SEQ)}]"
        self.tree = torch.zeros(2 * self.capacity, dtype=dtype, device=self.device)

    def set(self, idx, value) -> None:
        idx = _indices(idx, self.device, self.capacity)
        value = _as_tensor(value, self.device, self.dtype).reshape(-1)
        self.tree.index_put_((idx + self.capacity,), _last_wins(idx, value))
        _rebuild(self.tree, self.capacity)

    def total(self) -> torch.Tensor:
        """Root of the tree as a 0-d device tensor (no host read)."""
        return self.tree[1]

    def get(self, idx) -> torch.Tensor:
        return self.tree[_indices(idx, self.device, self.capacity) + self.capacity]

    def sample(self, targets) -> torch.Tensor:
        """Leaf indices for prefix-sum targets (device tensor in, device
        tensor out; the descent never touches the host)."""
        return _descend(self.tree, _as_tensor(targets, self.device), self.capacity)


def _draw_seed(seed: int, draws: int) -> int:
    """The generator seed of draw number ``draws``: a function of (seed,
    draw count) only."""
    return int(np.random.SeedSequence([seed, draws]).generate_state(1, np.uint64)[0])


class _PinnedStaging:
    """Pinned host rows for a CUDA shard's ring insert.  Host leaves are
    stacked with ``np.stack`` — the single host copy of borrowed read-only
    ingest views — straight into pinned memory, so the ring copy that
    follows is truly asynchronous.  Two sets alternate, and a set is reused
    only after the event recorded behind its last copies has completed."""

    def __init__(self, width: int, leaves: Sequence[Sequence[Any]]):
        def buffer(xs):
            row = np.asarray(xs[0])
            dtype = torch.from_numpy(np.empty(0, row.dtype)).dtype
            return torch.empty((width,) + row.shape, dtype=dtype, pin_memory=True)

        self._sets = [[buffer(xs) for xs in leaves] for _ in range(2)]
        self._events: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0

    def stack(self, leaves: Sequence[Sequence[Any]]) -> List[torch.Tensor]:
        k = self._turn
        if self._events[k] is not None:
            self._events[k].synchronize()
        n = len(leaves[0])
        rows = []
        for buf, xs in zip(self._sets[k], leaves):
            np.stack(xs, out=buf[:n].numpy())
            rows.append(buf[:n])
        return rows

    def copied(self) -> None:
        """Mark the set :meth:`stack` last filled as in flight: its copies
        to the card are enqueued."""
        self._events[self._turn] = torch.cuda.Event()
        self._events[self._turn].record()
        self._turn ^= 1


class DeviceReplayShard:
    """One host's shard of the distributed device-resident replay store.

    API-compatible with :class:`moolib_tpu_torch.replay.host.ReplayBuffer`
    (``add`` / ``sample`` / ``update_priorities`` / ``size``), except that
    ``sample`` returns *device* tensors (int64 indices) and
    ``update_priorities`` accepts them — the learner's TD errors never
    visit the host.

    The insert and update widths latch on their first call: shorter
    batches pass, a wider one raises ``ValueError`` (callers, and
    :meth:`ReplayShardService.drain`, split to :attr:`insert_width`).

    Thread-safe: a reentrant per-shard mutex serializes add, sample, update
    and the realized reads — :class:`~moolib_tpu_torch.replay.ingest.ReplayShardService`
    calls in from the Rpc worker pool *and* the transport IO thread
    (inline priority write-back).  All of it runs on the current stream of
    the calling thread, the default stream unless a caller sets another.
    """

    def __init__(
        self,
        capacity: int,
        alpha: float = 0.6,
        beta: float = 0.4,
        seed: int = 0,
        name: str = "replay_shard",
        dtype=torch.float32,
        device=None,
    ):
        self.device = resolve(device)
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self._treecap = _pow2(self.capacity)
        self.dtype = dtype
        self._tag = f"{name}[{next(_INSTANCE_SEQ)}]"
        self.tree = torch.zeros(2 * self._treecap, dtype=dtype, device=self.device)
        self._ring: Optional[List[torch.Tensor]] = None  # one [capacity, ...] per leaf
        self._struct = None  # the item pytree, for nest.pack_as
        self._stage = None  # pinned host staging of the ring insert (CUDA only)
        self._next = 0  # host-side ring cursor (bookkeeping ints, no sync)
        self._size = 0
        self._maxp = torch.ones((), dtype=dtype, device=self.device)  # max RAW priority
        self._seed = int(seed)
        self._draws = 0  # the seeding contract's draw counter
        self._gen = torch.Generator(device=self.device)
        self._ins_width: Optional[int] = None
        self._upd_width: Optional[int] = None
        self._lock = threading.RLock()

    def priority_transform(self, p) -> torch.Tensor:
        """The one alpha-pow ``max(p, 1e-6)**alpha`` used for every leaf
        value that enters the tree (insert and update), on the shard's
        device in its dtype."""
        return _as_tensor(p, self.device, self.dtype).clamp(min=1e-6).pow(self.alpha)

    def __len__(self) -> int:
        return self._size

    def size(self) -> int:
        return self._size

    @property
    def insert_width(self) -> Optional[int]:
        """The latched insert width (None until the first ``add``) — ingest
        callers split larger stripes to this before inserting."""
        return self._ins_width

    # -- insert ------------------------------------------------------------

    def _latch(self, attr: str, n: int, what: str) -> None:
        width = getattr(self, attr)
        if width is None:
            setattr(self, attr, n)
        elif n > width:
            raise ValueError(
                f"{what} width grew {width} -> {n}: the shard's {what} is "
                "fixed-width (pad or split the batch)"
            )

    def add(self, items: Sequence[Any], priorities=None):
        """Insert a batch of item pytrees (at most the latched width); returns
        their slot indices (host ints — ring bookkeeping, not a device
        readback)."""
        with self._lock:
            n = len(items)
            self._latch("_ins_width", n, "insert")
            flat = [list(nest.flatten(it)) for it in items]
            leaves = [[row[j] for row in flat] for j in range(len(flat[0]))]
            staged = self.device.type == "cuda" and not isinstance(leaves[0][0], torch.Tensor)
            if staged:
                if self._stage is None:
                    self._stage = _PinnedStaging(self._ins_width, leaves)
                rows = self._stage.stack(leaves)
            else:
                rows = [torch.stack(xs) if isinstance(xs[0], torch.Tensor)
                        else torch.from_numpy(np.stack(xs)) for xs in leaves]
            if self._ring is None:
                self._struct = items[0]
                self._ring = [torch.zeros((self.capacity,) + tuple(r.shape[1:]), dtype=r.dtype,
                                          device=self.device) for r in rows]
            if priorities is None:
                praw = self._maxp.expand(n)
            else:
                praw = _as_tensor(priorities, self.device, self.dtype).reshape(-1)
                if praw.shape[0] != n:
                    raise ValueError(f"{praw.shape[0]} priorities for {n} items")
            p_alpha = self.priority_transform(praw)
            # Only the last `capacity` lanes survive a batch wider than the
            # ring; they land as at most two contiguous slices.
            keep = min(n, self.capacity)
            off = n - keep
            start = (self._next + off) % self.capacity
            first = min(keep, self.capacity - start)
            leaf_level = self.tree[self._treecap : self._treecap + self.capacity]
            for dst, src in ((leaf_level, p_alpha), *zip(self._ring, rows)):
                dst[start : start + first].copy_(src[off : off + first], non_blocking=True)
                if keep > first:
                    dst[: keep - first].copy_(src[off + first : n], non_blocking=True)
            if staged:
                self._stage.copied()
            _rebuild(self.tree, self._treecap)
            if priorities is not None:
                torch.maximum(self._maxp, praw.max(), out=self._maxp)
            idxs = [(self._next + i) % self.capacity for i in range(n)]
            self._next = (self._next + n) % self.capacity
            self._size = min(self._size + n, self.capacity)
        REPLAY_FRAMES.inc(n, role="insert")
        REPLAY_OCCUPANCY.set(self._size, shard=self._tag)
        return idxs

    # -- sample ------------------------------------------------------------

    def sample(self, batch_size: int, size_override: int = 0, total_override: float = 0.0):
        """(device batch pytree, device int64 indices, device weights).

        ``size_override``/``total_override`` are the cohort-wide N and
        priority total for the distributed two-level draw (they only
        rescale the importance weights — indices always stay within the
        local ring); 0 keeps the shard-local correction.
        """
        with self._lock:
            if self._size == 0 or self._ring is None:
                raise ValueError("replay shard is empty")
            self._gen.manual_seed(_draw_seed(self._seed, self._draws))
            self._draws += 1
            with REPLAY_SAMPLE_SECONDS.time():
                u = torch.rand(batch_size, generator=self._gen, dtype=self.dtype,
                               device=self.device)
                idx, w = _draw(u, self.tree, self._treecap, self._size,
                               int(size_override), float(total_override), self.beta)
                batch = nest.pack_as(self._struct,
                                     [leaf.index_select(0, idx) for leaf in self._ring])
        REPLAY_FRAMES.inc(batch_size, role="sample")
        return batch, idx, w

    # -- priority write-back ------------------------------------------------

    def update_priorities(self, indices, priorities) -> None:
        """Write back new priorities (device or host arrays — device TD
        errors are consumed without realizing them on host).  Duplicate
        indices resolve last-wins, matching the numpy reference."""
        with self._lock:
            idx = _indices(indices, self.device, self.capacity)
            n = int(idx.shape[0])
            self._latch("_upd_width", n, "priority-update")
            praw = _as_tensor(priorities, self.device, self.dtype).reshape(-1)
            p_alpha = self.priority_transform(praw)
            self.tree.index_put_((idx + self._treecap,), _last_wins(idx, p_alpha))
            _rebuild(self.tree, self._treecap)
            torch.maximum(self._maxp, praw.max(), out=self._maxp)
        REPLAY_PRIORITY_ROUNDS.inc()

    # -- cohort seams --------------------------------------------------------

    def total(self) -> torch.Tensor:
        """Priority-sum root as a 0-d device tensor (no host read)."""
        with self._lock:
            return self.tree[1].clone()

    def total_host(self) -> float:
        """Realized priority total — the intentional host seam the
        across-shard proportional allocation reads once per draw round
        (amortized over a whole sampled batch, not per frame)."""
        with self._lock:
            return float(self.tree[1])

    def leaf_priorities(self) -> torch.Tensor:
        """A copy of the ``[capacity]`` transformed-priority leaf level (tests
        compare it against the numpy reference)."""
        with self._lock:
            return self.tree[self._treecap : self._treecap + self.capacity].clone()

    def ring_bytes(self) -> int:
        """Bytes the ring holds on the device (0 before the first add)."""
        return sum(t.numel() * t.element_size() for t in self._ring or ())
