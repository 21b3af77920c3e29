"""Distributed two-level prioritized sampling over a replay shard cohort
(the port of the JAX package's ``replay/distributed.py``).

Level one runs on host, once per draw: every shard reports (size, priority
total) — local shards via the in-process seam, remote shards via their
``<name>.stats`` RPC — and the draw picks a shard proportionally to its
priority total with a seeded generator.  Level two runs on device inside
the chosen shard: the stratified sum-tree draw, corrected to the *cohort*
distribution by passing the cohort-wide N and priority total into the
sample jit (``P_global(i) = p_i / total_global``), so importance weights
are consistent with the two-level proportional scheme no matter which
shard served the batch.

Level one draws from a seeded ``np.random.default_rng``, so the shard
picks are bit-identical to the JAX package's for the same seed and
totals.  Priority write-back routes by the sample's owning shard: device
tensors go straight back into a local shard's in-place update; a remote
write-back sends numpy on the wire, fire-and-forget (the learner never
blocks on it).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ._metrics import REPLAY_FRAMES
from .host import _numpy


class SampleRef(NamedTuple):
    """Routing handle for a sampled batch: which shard owns the slots."""

    shard: int
    indices: Any


class _LocalShard:
    def __init__(self, shard):
        self._shard = shard

    def stats(self):
        return {"size": len(self._shard), "total": self._shard.total_host()}

    def sample(self, batch_size, size_override, total_override):
        return self._shard.sample(
            batch_size,
            size_override=size_override,
            total_override=total_override,
        )

    def update(self, indices, priorities):
        self._shard.update_priorities(indices, priorities)


class _RemoteShard:
    def __init__(self, rpc, peer, name):
        self._rpc = rpc
        self._peer = peer
        self._name = name

    def stats(self):
        return self._rpc.sync(self._peer, f"{self._name}.stats")

    def sample(self, batch_size, size_override, total_override):
        out = self._rpc.sync(
            self._peer,
            f"{self._name}.dsample",
            batch_size,
            size_override,
            total_override,
        )
        return out["batch"], out["indices"], out["weights"]

    def update(self, indices, priorities):
        # The wire realizes the learner's device TD errors — the one
        # intentional crossing of the remote write-back path.
        indices = _numpy(indices)
        priorities = _numpy(priorities)
        self._rpc.async_(
            self._peer, f"{self._name}.update", indices, priorities
        )


class DistributedReplay:
    """Learner-side view over a cohort of replay shards.

    ``shards`` are in-process :class:`DeviceReplayShard` instances;
    ``remote_peers`` name peers serving a
    :class:`~moolib_tpu_torch.replay.ingest.ReplayShardService` (or the JAX
    package's) under the same ``name``.  API matches the single-shard store: ``sample`` returns
    ``(batch, SampleRef, weights)`` and ``update_priorities`` takes the
    ref back.
    """

    def __init__(
        self,
        shards: Sequence[Any] = (),
        rpc=None,
        remote_peers: Sequence[str] = (),
        name: str = "replay",
        seed: int = 0,
    ):
        self._shards: List[Any] = [_LocalShard(s) for s in shards]
        self._shards += [_RemoteShard(rpc, p, name) for p in remote_peers]
        if not self._shards:
            raise ValueError("DistributedReplay needs at least one shard")
        self._rng = np.random.default_rng(seed)

    def stats(self) -> List[dict]:
        """One (size, total) row per shard — the level-one refresh, one
        host round per draw (amortized over the whole batch)."""
        return [s.stats() for s in self._shards]

    def size(self) -> int:
        return sum(int(st["size"]) for st in self.stats())

    def sample(self, batch_size: int) -> Tuple[Any, SampleRef, Any]:
        stats = self.stats()
        totals = [float(st["total"]) for st in stats]
        global_n = sum(int(st["size"]) for st in stats)
        if global_n == 0:
            raise ValueError("replay cohort is empty")
        global_total = sum(totals)
        if global_total <= 0:
            probs = [1.0 / len(totals)] * len(totals)
        else:
            probs = [t / global_total for t in totals]
        pick = self._rng.choice(len(self._shards), p=probs)
        batch, idx, w = self._shards[pick].sample(
            batch_size, global_n, global_total
        )
        REPLAY_FRAMES.inc(batch_size, role="cohort_sample")
        return batch, SampleRef(int(pick), idx), w

    def update_priorities(self, ref: SampleRef, priorities) -> None:
        self._shards[ref.shard].update(ref.indices, priorities)
