"""Foundation utilities for moolib_tpu_torch.

Copies of the JAX package's ``utils`` helpers the slice needs: uid
generation, leveled logging with a Python-logging bridge, the
worker-thread cap, the agents' stats counters (``utils.stats``), the
shared kernel build cache (``utils.compile_cache``) and the batch-size
finder (``utils.batchsize``).
"""

from __future__ import annotations

import logging as _pylogging
import secrets
import time
from typing import Optional

from . import nest  # noqa: F401
from .stats import RunningMeanStd, StatMean, StatSum  # noqa: F401
from .compile_cache import compile_cache_dir, init_compile_cache  # noqa: F401

# ---------------------------------------------------------------------------
# uid / naming  (reference: randomName(), src/util.h — 16 hex chars)
# ---------------------------------------------------------------------------


def create_uid() -> str:
    """Return a random 16-hex-char uid, like the reference's ``create_uid``."""
    return secrets.token_hex(8)


# ---------------------------------------------------------------------------
# logging  (reference: moolib::log levels none/error/info/verbose/debug,
#           optional routing into Python logging via set_logging)
# ---------------------------------------------------------------------------

LOG_NONE = 0
LOG_ERROR = 1
LOG_INFO = 2
LOG_VERBOSE = 3
LOG_DEBUG = 4

_LEVELS = {
    "none": LOG_NONE,
    "error": LOG_ERROR,
    "info": LOG_INFO,
    "verbose": LOG_VERBOSE,
    "debug": LOG_DEBUG,
}

_log_level = LOG_ERROR
_py_logger: Optional[_pylogging.Logger] = None


def set_log_level(level) -> None:
    """Set the global log level ("none"|"error"|"info"|"verbose"|"debug")."""
    global _log_level
    if isinstance(level, str):
        level = _LEVELS[level.lower()]
    _log_level = int(level)


def set_logging(logger=None) -> None:
    """Route moolib_tpu_torch logs into a Python ``logging``-style logger
    (the ``logging`` module itself or a logger object)."""
    global _py_logger
    if logger is None:
        _py_logger = None
    elif hasattr(logger, "info"):
        _py_logger = logger
    else:  # the logging module itself
        _py_logger = _pylogging.getLogger("moolib_tpu_torch")


def _emit(level: int, msg: str, *args) -> None:
    if level > _log_level:
        return
    if args:
        msg = msg % args
    if _py_logger is not None:
        if level <= LOG_ERROR:
            _py_logger.error(msg)
        elif level == LOG_INFO:
            _py_logger.info(msg)
        else:
            _py_logger.debug(msg)
    else:
        ts = time.strftime("%H:%M:%S")
        print(f"[{ts}] moolib_tpu_torch: {msg}", flush=True)


def log_error(msg: str, *args) -> None:
    _emit(LOG_ERROR, msg, *args)


def log_info(msg: str, *args) -> None:
    _emit(LOG_INFO, msg, *args)


def log_verbose(msg: str, *args) -> None:
    _emit(LOG_VERBOSE, msg, *args)


def log_debug(msg: str, *args) -> None:
    _emit(LOG_DEBUG, msg, *args)


# ---------------------------------------------------------------------------
# scheduler sizing  (reference: set_max_threads → async scheduler cap)
# ---------------------------------------------------------------------------

_max_threads: Optional[int] = None


def set_max_threads(n: int) -> None:
    """Cap worker threads used by Rpc executors (reference: set_max_threads)."""
    global _max_threads
    _max_threads = int(n)


def get_max_threads() -> Optional[int]:
    return _max_threads
