"""moolib_tpu_torch — the PyTorch / CUDA port of moolib_tpu.

A second package beside the JAX one, with the same module paths and names
so each piece can be found next to its counterpart.  It imports ``torch``
and never ``jax`` or anything from ``moolib_tpu``.  This slice carries the
RPC plane (serialization, native codec and transport, ``Rpc``), the
TransformerLM with its hand-written flash-attention prefill kernel, and the
dynamic-batching LM server (``examples.lm_serve``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
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
