"""moolib_tpu_torch — the PyTorch / CUDA port of moolib_tpu.

A second package beside the JAX one, with the same module paths and names
so each piece can be found next to its counterpart.  It imports ``torch``
and never ``jax`` or anything from ``moolib_tpu``.  What it has so far:

- the RPC plane: serialization, the native codec and transport, ``Rpc``;
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
- telemetry (metrics, tracing, exporters, recovery phases), ``watchdog``
  and ``utils``.

The cohort plane (Broker, Group, Accumulator) and the training loops that
need it come next (ROADMAP Queue 1).  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

from . import telemetry  # noqa: F401  (stdlib-only; rpc/core depends on it)
from . import utils  # noqa: F401
from .utils import create_uid, set_log_level, set_logging, set_max_threads  # noqa: F401
from .rpc import Future, Queue, Rpc, RpcDeferredReturn, RpcError  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "Future",
    "Queue",
    "Rpc",
    "RpcDeferredReturn",
    "RpcError",
    "create_uid",
    "set_log_level",
    "set_logging",
    "set_max_threads",
    "telemetry",
    "utils",
]
