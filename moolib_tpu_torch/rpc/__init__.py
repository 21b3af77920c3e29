"""RPC subsystem: serialization, transports, the Rpc engine."""

from . import serialization  # noqa: F401
from .core import (  # noqa: F401
    FrameTooLargeError,
    Future,
    Queue,
    Rpc,
    RpcDeferredReturn,
    RpcError,
    parse_address,
)
