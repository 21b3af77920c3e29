"""moolib_tpu_torch — the PyTorch / CUDA port of moolib_tpu.

A second package beside the JAX one, with the same module paths and names
so each piece can be found next to its counterpart.  It imports ``torch``
and never ``jax`` or anything from ``moolib_tpu``.  What it has so far:

- the RPC plane: serialization, the native codec and transport, ``Rpc``;
- the cohort wire plane: ``Broker`` (with its replicated hot standbys and
  ``python -m moolib_tpu_torch.broker``), ``Group`` (tree, flat-bucket and
  chunked-ring allreduce, bf16/q8 wire compression, byte-compatible with
  the JAX package's peers), ``buckets`` (flat layouts, the buffer pool,
  pinned D2H staging of CUDA leaves, EF-q8) and the cohort stats path
  (``examples.common.GlobalStatsAccumulator``, ``telemetry.CohortCounters``);
- the TransformerLM (``models.transformer``) with the hand-written
  flash-attention kernels (``ops.flash_attention``: forward, dq and dk/dv
  passes for Hopper), ``ops.xent``, LM training (``examples.lm``) and the
  dynamic-batching LM server (``examples.lm_serve``);
- the IMPALA/A2C learner and its data plane: the numpy envs (``envs``),
  ``envpool.EnvPool`` with its shared-memory doorbells (``native``),
  ``batcher.Batcher``, ``models.impala.ImpalaNet``,
  ``models.actor_critic.ActorCriticNet``, ``ops.vtrace`` and
  ``ops.returns``, the optax-form optimizers (``examples.common``), the
  losses of ``examples.vtrace.experiment`` and ``examples.a2c``, and
  ``bench``, the learner-step benchmark;
- the serving tier: ``serving`` (admission control, replicas registered
  with the broker, the failover client, weight publishing) and ``engine``
  (continuous batching over a paged KV pool, ``EngineService``), both
  byte-compatible with the JAX package's peers;
- elastic data-parallel training: ``Accumulator`` (leader election, the
  two-phase virtual batch, tree/bucketed/ring rounds with bf16/int8 wires,
  chunked model sync, the ``torch.distributed`` collective plane;
  byte-compatible with the JAX package's cohorts), ``rollout``
  (``DeviceRollout``: [T+1, B] rollout buffers on the card;
  ``AnakinRollout``: the batched envs of ``envs.jax_envs`` stepped on the
  card inside the act step, zero host-boundary bytes per frame), and the loops
  that drive them: ``examples.vtrace.experiment.train``,
  ``examples.a2c.train`` and ``examples.lm``'s elastic path, with
  ``examples.launch`` and ``examples.plot``;
- fleet and durability: ``checkpoint`` (``Checkpointer``,
  ``DistributedCheckpointer``: manifest-checked, two-phase committed,
  byte-compatible with the JAX package's checkpoints), the Accumulator's
  distributed-checkpoint plane, ``autoscaler`` (``Autoscaler``,
  ``AutoscalePolicy``, ``SubprocessFleet``), on-demand ``torch.profiler``
  windows and the step timeline (``telemetry.profiling``,
  ``telemetry.timeline``), and ``utils.compile_cache`` (a kernel build
  directory shared between peers);
- telemetry (metrics, tracing, exporters, the flight recorder, recovery
  phases, the device monitor ``telemetry.devmon``, the cohort aggregator's
  scrape endpoints), ``watchdog``,
  ``testing`` (lock-order graph, fault plans) and ``utils`` (with the
  sorted-key ``nest.tree_flatten`` the Accumulator's wire needs).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

# Lock-order race detection must swap the threading.Lock/RLock factories
# BEFORE any submodule (telemetry included) creates a module-level lock.
# Strict no-op unless MOOLIB_LOCKGRAPH=1; stdlib-only import.
from .testing import lockgraph as _lockgraph

_lockgraph.install_from_env()

from . import telemetry  # noqa: E402,F401  (stdlib-only; rpc/core depends on it)
from . import utils  # noqa: E402,F401
from .utils import create_uid, set_log_level, set_logging, set_max_threads  # noqa: E402,F401
from .rpc import Future, Queue, Rpc, RpcDeferredReturn, RpcError  # noqa: E402,F401

__version__ = "0.1.0"

__all__ = [
    "Accumulator",
    "AllReduce",
    "AutoscalePolicy",
    "Autoscaler",
    "Broker",
    "buckets",
    "DistributedCheckpointer",
    "engine",
    "Future",
    "GradientShardingError",
    "Group",
    "MissingShardError",
    "parallel",
    "Queue",
    "rollout",
    "Rpc",
    "RpcDeferredReturn",
    "RpcError",
    "serving",
    "SubprocessFleet",
    "create_uid",
    "set_log_level",
    "set_logging",
    "set_max_threads",
    "telemetry",
    "utils",
]


_LAZY = {
    "Accumulator": "accumulator",
    "Autoscaler": "autoscaler",
    "AutoscalePolicy": "autoscaler",
    "SubprocessFleet": "autoscaler",
    "Broker": "broker",
    "DistributedCheckpointer": "checkpoint",
    "MissingShardError": "checkpoint",
    "Group": "group",
    "AllReduce": "group",
    "GradientShardingError": "accumulator",
}


def __getattr__(name):  # lazy imports keep `import moolib_tpu_torch` light
    import importlib

    if name in ("buckets", "engine", "parallel", "rollout", "serving"):
        value = importlib.import_module(f".{name}", __name__)
        globals()[name] = value
        return value
    mod_name = _LAZY.get(name)
    if mod_name is None:
        raise AttributeError(f"module 'moolib_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{mod_name}", __name__), name)
    globals()[name] = value
    return value
