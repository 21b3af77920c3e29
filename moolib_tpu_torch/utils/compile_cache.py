"""Shared kernel build cache (docs/RESILIENCE.md "Recovery budget").

A restarted peer's recovery time has two compile-shaped costs in the JAX
package: XLA recompiling its train step, which a persistent compilation
cache removes.  The port compiles nothing per signature; its one compile
cost on a restart is ``nvcc`` rebuilding the hand-written kernels
(``ops/_build``, seconds per source).  This module points the kernel
build directory at one shared, persistent directory, so a restarted or
autoscaled peer loads the libraries its fleet already built
(``ops._build.build_info[name]["seconds"] == 0.0``):

- ``MOOLIB_COMPILE_CACHE=<dir>`` — use ``<dir>`` as the build directory
  (every peer of a fleet may point at one directory: ``_build.build``
  installs each library under a per-process tmp name and renames it into
  place atomically, so concurrent first builds do not interleave).
- ``--compile_cache_dir`` on the example CLIs — same knob; an explicit
  argument wins over the environment.

The JAX package's ``MOOLIB_COMPILE_CACHE_MIN_COMPILE_SECS`` and
``MOOLIB_COMPILE_CACHE_MIN_ENTRY_BYTES`` filter which XLA programs are
worth persisting; every kernel library here is worth it, so the two knobs
have no counterpart and change nothing.

``init_compile_cache()`` is idempotent and import-light: with no directory
configured it returns ``None`` and imports nothing (the EnvPool worker
main calls it).
"""

from __future__ import annotations

import os
from typing import Optional

_ENV_DIR = "MOOLIB_COMPILE_CACHE"

_initialized_dir: Optional[str] = None


def init_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernel build directory at ``cache_dir`` (or
    ``$MOOLIB_COMPILE_CACHE`` when not given).  Returns the directory in
    use, or ``None`` when no cache is configured.

    Call before the first kernel load of the process — entry points do it
    first thing.  Idempotent: the first configured directory wins (the
    build directory and the loaded libraries are process-global); a later
    call with a different directory logs and keeps the first, and a call
    after a kernel was already loaded from the default directory logs and
    wires nothing.
    """
    global _initialized_dir
    cache_dir = cache_dir or os.environ.get(_ENV_DIR) or None
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(cache_dir)
    from . import log_error, log_info

    if _initialized_dir is not None:
        if _initialized_dir != cache_dir:
            log_error(
                "compile cache already initialized at %s; ignoring %s "
                "(the kernel build directory is process-global)",
                _initialized_dir, cache_dir,
            )
        return _initialized_dir
    from ..ops import _build

    if _build._libs and os.path.abspath(_build.BUILD_DIR) != cache_dir:
        log_error(
            "compile cache: kernels %s already loaded from %s; ignoring %s "
            "(set the cache before the first kernel load)",
            sorted(_build._libs), _build.BUILD_DIR, cache_dir,
        )
        return None
    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_DIR = cache_dir
    _initialized_dir = cache_dir
    log_info(
        "compile cache: %s — restarts load the kernel libraries already "
        "built there", cache_dir,
    )
    return cache_dir


def compile_cache_dir() -> Optional[str]:
    """The directory ``init_compile_cache`` wired, or None."""
    return _initialized_dir
