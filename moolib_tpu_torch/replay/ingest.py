"""Zero-copy trajectory ingest: memfd-multicast publish, shard adoption.

The port of the JAX package's ``replay/ingest.py``.  Actors publish
trajectory batches through the Rpc's multicast seam
(:meth:`Rpc.async_broadcast`): the payload serializes once and — when every
target shard is a same-host fd-passing peer — is written into a single
memfd mapped by all of them, so trajectory bytes leave the publishing
process exactly once per host, not once per consumer.  The write-once
invariant is measured right here: ``replay_bytes_total{direction=
"ingest_out"}`` increments once per publish with the payload size,
independent of the consumer count.

On the receiving side each shard's ``<name>.ingest`` handler runs inline:
its arguments are zero-copy read-only views over the delivered frame.  The
handler takes its round-robin stripe of the items, adopts the memfd
mapping (:func:`rpc.core.adopt_current_frame`) so the pages outlive the
handler, and queues the stripe; :meth:`ReplayShardService.drain` later
inserts it into the device ring: one ``np.stack`` of the borrowed views
(the single host copy) and one host->device copy per leaf.  Frames that arrived over a
copying transport (TCP, small frames) are copied once in the handler
instead, since their receive buffer is recycled on return.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence

from ..rpc import Rpc
from ..rpc import core as rpc_core
from ..utils import nest
from ._metrics import REPLAY_BYTES, REPLAY_FRAMES
from .host import _own_copy, payload_bytes


class ReplayPublisher:
    """Actor-side handle multicasting trajectory batches to a shard set."""

    def __init__(self, rpc: Rpc, shard_peers: Sequence[str], name: str = "replay"):
        self._rpc = rpc
        self._peers = list(shard_peers)
        self._name = name

    def multicast_ready(self) -> bool:
        """True when a publish will take the write-once memfd path (every
        shard reachable over a live same-host fd-passing connection)."""
        return self._rpc.multicast_ready(self._peers)

    def publish(self, items: Sequence[Any], priorities=None):
        """Broadcast one trajectory batch to every shard; returns the
        broadcast future (resolves once every shard has ingested)."""
        REPLAY_BYTES.inc(
            payload_bytes(items) + payload_bytes(priorities),
            direction="ingest_out",
        )
        REPLAY_FRAMES.inc(len(items), role="publish")
        return self._rpc.async_broadcast(
            self._peers, f"{self._name}.ingest", items, priorities
        )


class ReplayShardService:
    """Serve one :class:`DeviceReplayShard` to the cohort.

    Endpoints: ``<name>.ingest`` (inline, zero-copy), ``<name>.stats``
    (size + priority total for the across-shard draw), ``<name>.dsample``
    (cohort-corrected sample), ``<name>.update`` (priority write-back),
    ``<name>.size``.

    Handlers run on two kinds of thread — ``stats``/``dsample``/``size``
    on the Rpc worker pool (each drains pending stripes first), the inline
    ``ingest``/``update`` on the transport IO thread — and may overlap
    freely: the service lock only guards the pending-stripe queue, while
    the :class:`~moolib_tpu_torch.replay.device.DeviceReplayShard`
    serializes its own in-place add/sample/update under its per-shard
    mutex.  Nothing here waits on the card except ``total_host()``, the
    one intended host read, in ``stats``.
    """

    def __init__(
        self,
        rpc: Rpc,
        name: str,
        shard,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self._rpc = rpc
        self._name = name
        self._shard = shard
        self._shard_index = int(shard_index)
        self._num_shards = int(num_shards)
        self._pending: List = []
        self._lock = threading.Lock()
        rpc.define(f"{name}.ingest", self._on_ingest, inline=True)
        rpc.define(f"{name}.stats", self._on_stats)
        rpc.define(f"{name}.dsample", self._on_sample)
        rpc.define(f"{name}.update", self._on_update, inline=True)
        rpc.define(f"{name}.size", self._on_size)

    # -- ingest (inline: runs on the transport IO thread) --------------------

    def _on_ingest(self, items, priorities=None):
        stripe = list(items[self._shard_index :: self._num_shards])
        prios = (
            None
            if priorities is None
            else priorities[self._shard_index :: self._num_shards]
        )
        # Adopt the memfd mapping: the borrowed views point into its pages,
        # which now stay alive until drain() has stacked them.
        owner = rpc_core.adopt_current_frame()
        if owner is None:
            # Copying transport — the receive buffer dies on return.
            stripe = [_own_copy(it) for it in stripe]
            prios = None if prios is None else list(prios)
        REPLAY_BYTES.inc(payload_bytes(stripe), direction="ingest_in")
        REPLAY_FRAMES.inc(len(stripe), role="ingest")
        with self._lock:
            self._pending.append((stripe, prios, owner))
        return len(stripe)

    def drain(self) -> int:
        """Insert queued stripes into the device ring — this is where the
        single host->device copy per trajectory happens.  Safe from any
        thread (the shard's own mutex serializes the in-place inserts
        against concurrent sample/update).  Returns the number of items
        inserted.

        The ring insert is fixed-shape: the shard latches its insert width
        on the first ``add`` and pads shorter batches, so stripes wider
        than the latched width (publishers with varying batch sizes, a
        first partial publish) are SPLIT into latched-width chunks here
        rather than surfacing a width error inside an RPC handler."""
        with self._lock:
            pending, self._pending = self._pending, []
        inserted = 0
        for stripe, prios, _owner in pending:
            if not stripe:
                continue
            width = getattr(self._shard, "insert_width", None)
            if width is None:
                width = len(stripe)  # first insert latches the shard width
            for off in range(0, len(stripe), width):
                chunk = stripe[off : off + width]
                self._shard.add(
                    chunk,
                    None if prios is None else prios[off : off + width],
                )
                inserted += len(chunk)
        # _owner mappings drop here: the shard stacked their pages.
        return inserted

    # -- cohort sampling seams ----------------------------------------------

    def _on_stats(self):
        self.drain()
        return {
            "size": len(self._shard),
            "total": self._shard.total_host(),
        }

    def _on_sample(self, batch_size, size_override=0, total_override=0.0):
        self.drain()
        batch, idx, w = self._shard.sample(
            batch_size, size_override=size_override, total_override=total_override
        )
        return {"batch": batch, "indices": idx, "weights": w}

    def _on_update(self, indices, priorities):
        self._shard.update_priorities(indices, priorities)
        return True

    def _on_size(self):
        self.drain()
        return len(self._shard)
