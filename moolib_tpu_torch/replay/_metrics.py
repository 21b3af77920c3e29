"""Replay data-plane metrics — one definition point for every series the
host and device stores share, so the registry sees a single consistent
registration regardless of which layer imports first."""

from __future__ import annotations

from ..telemetry import metrics

_REG = metrics.get_registry()

#: payload bytes crossing a replay seam, by direction:
#: ``add_in``/``sample_out`` (legacy host RPC store), ``ingest_out`` (one
#: increment per publish — NOT per consumer: the write-once invariant the
#: memfd multicast buys is measurable right here), ``ingest_in`` (per-shard
#: stripe adopted from the borrowed view).
REPLAY_BYTES = _REG.counter(
    "replay_bytes_total",
    "payload bytes crossing a replay seam (publish counted once per host, "
    "not per consumer)",
    ("direction",),
)

REPLAY_FRAMES = _REG.counter(
    "replay_frames_total",
    "trajectory items through the replay plane, by role "
    "(publish/ingest/insert/sample)",
    ("role",),
)

REPLAY_SAMPLE_SECONDS = _REG.histogram(
    "replay_sample_seconds",
    "wall time of one prioritized sample draw (dispatch-inclusive; the "
    "device path returns un-realized device arrays)",
)

REPLAY_PRIORITY_ROUNDS = _REG.counter(
    "replay_priority_update_rounds_total",
    "priority write-back rounds applied to a replay store",
)

REPLAY_OCCUPANCY = _REG.gauge(
    "replay_shard_occupancy",
    "items currently held by the local replay shard",
    ("shard",),
)
