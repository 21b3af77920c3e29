"""Continuous-batching serving engine over a paged KV cache: the port of the
JAX package's ``engine`` package.

Slot-scheduled decode against device-resident KV block pools, slotting in
UNDER the ``serving.ServeService`` contract so ``lm_serve --engine`` is a
drop-in arm next to the batch-synchronous baseline.  See ``engine.py`` for
the slot/block lifecycle and ``ops/paged_attention.py`` for the attention.
"""

from .engine import ContinuousBatchingEngine, NoFreeSlot  # noqa: F401
from .kv_pool import BlockPool, PoolExhausted  # noqa: F401
from .service import EngineService  # noqa: F401

__all__ = [
    "BlockPool",
    "ContinuousBatchingEngine",
    "EngineService",
    "NoFreeSlot",
    "PoolExhausted",
]
