"""Prioritized experience replay: host reference store + device-resident
distributed store (the port of the JAX package's ``replay``).

- :mod:`~moolib_tpu_torch.replay.host` — the numpy/RPC store
  (``SumTree``/``ReplayBuffer``/``ReplayServer``/``ReplayClient``), kept
  as the compat shim and the bit-exactness reference.
- :mod:`~moolib_tpu_torch.replay.device` — the sum-tree and ring storage
  as tensors on the shard's device, written in place
  (``DeviceSumTree``/``DeviceReplayShard``).
- :mod:`~moolib_tpu_torch.replay.ingest` — memfd-multicast trajectory
  publish and zero-copy shard adoption
  (``ReplayPublisher``/``ReplayShardService``).
- :mod:`~moolib_tpu_torch.replay.distributed` — the two-level cohort draw
  (``DistributedReplay``/``SampleRef``).

Host names import eagerly; the device-side names load lazily, as in the
JAX package.
"""

from .host import ReplayBuffer, ReplayClient, ReplayServer, SumTree, payload_bytes

_LAZY = {
    "DeviceSumTree": ("device", "DeviceSumTree"),
    "DeviceReplayShard": ("device", "DeviceReplayShard"),
    "ReplayPublisher": ("ingest", "ReplayPublisher"),
    "ReplayShardService": ("ingest", "ReplayShardService"),
    "DistributedReplay": ("distributed", "DistributedReplay"),
    "SampleRef": ("distributed", "SampleRef"),
}

__all__ = [
    "ReplayBuffer",
    "ReplayClient",
    "ReplayServer",
    "SumTree",
    "payload_bytes",
    *_LAZY,
]


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{entry[0]}", __name__)
    value = getattr(mod, entry[1])
    globals()[name] = value
    return value
