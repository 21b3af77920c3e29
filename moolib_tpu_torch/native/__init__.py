"""Native (C++) runtime components, built on first use.

The sources are the repo-root ``native/`` files the JAX package builds too;
the port compiles its own copies with g++ into ``~/.cache/moolib_tpu_torch``
(or ``$MOOLIB_TPU_TORCH_CACHE``), keyed by source hash:

- ``_moolib_codec``: CPython-extension message codec (tag-based encoding,
  out-of-band zero-copy arrays, pickle fallback).  The port's dlopen'd copy
  fills the codec's accelerator-array slot with ``torch.Tensor``.
- ``libmoolib_net`` (``native/transport.cc``, bound in :mod:`.transport`).
- ``libmoolib_shmq`` (``native/shmq.cc``): futex semaphores + SPSC rings in
  shared memory (ctypes), EnvPool's doorbells.

All are accelerators of the host plane: without a compiler the pure-python
paths are used and everything still works.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from typing import Optional

from .. import utils

_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native")


def _cache_dir() -> str:
    d = os.environ.get("MOOLIB_TPU_TORCH_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "moolib_tpu_torch"
    )
    os.makedirs(d, exist_ok=True)
    return d


def _source_hash(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _build(src: str, out: str, extra_flags=()) -> bool:
    cmd = ["g++", "-O2", "-g", "-std=c++17", "-shared", "-fPIC", src, "-o", out, *extra_flags]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        utils.log_error("native build failed to run: %s", e)
        return False
    if proc.returncode != 0:
        utils.log_error("native build failed:\n%s", proc.stderr[-4000:])
        return False
    return True


def _load_codec():
    src = os.path.join(_SRC_DIR, "codec.cc")
    if not os.path.exists(src):
        return None
    out = os.path.join(_cache_dir(), f"_moolib_codec_{_source_hash(src)}.so")
    if not os.path.exists(out):
        import numpy as np

        py_inc = sysconfig.get_paths()["include"]
        # Per-process tmp name: concurrent first-use builds must not
        # interleave writes; os.replace makes the install atomic.
        tmp = f"{out}.{os.getpid()}.tmp"
        if not _build(src, tmp, (f"-I{py_inc}", f"-I{np.get_include()}")):
            return None
        os.replace(tmp, out)
    spec = importlib.util.spec_from_file_location("_moolib_codec", out)
    try:
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except Exception as e:  # noqa: BLE001
        utils.log_error("native codec load failed: %s", e)
        return None
    return mod


_codec = None
_codec_tried = False


def get_codec():
    """The native codec module, or None (fallback to python serialization)."""
    global _codec, _codec_tried
    if not _codec_tried:
        _codec_tried = True
        if os.environ.get("MOOLIB_TPU_NO_NATIVE") == "1":
            return None
        _codec = _load_codec()
        if _codec is not None:
            _register_torch(_codec)
    return _codec


class NeedsPortableCodec(TypeError):
    """A leaf the native codec cannot carry (a bf16 tensor: numpy has no
    bfloat16 without ml_dtypes); the serializer re-encodes the message with
    the portable pickle codec, which carries it as raw 2-byte payloads."""


def _register_torch(codec_mod) -> None:
    import numpy as np
    import torch

    def to_numpy(t):
        if t.dtype == torch.bfloat16:
            raise NeedsPortableCodec("bfloat16 tensor leaf")
        # Host staging: a CUDA tensor is copied to host memory.
        return t.detach().cpu().numpy()

    def from_numpy(x):
        if x.dtype.name == "bfloat16":  # only reachable with ml_dtypes loaded
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        # The view over the transient receive buffer must not escape.
        return x if x.flags.owndata else x.copy()

    codec_mod.register_jax(torch.Tensor, to_numpy, from_numpy)


def _load_shmq():
    src = os.path.join(_SRC_DIR, "shmq.cc")
    if not os.path.exists(src):
        return None
    out = os.path.join(_cache_dir(), f"libmoolib_shmq_{_source_hash(src)}.so")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        if not _build(src, tmp):
            return None
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(out)
    except OSError as e:
        utils.log_error("native shmq load failed: %s", e)
        return None
    lib.moolib_sem_size.restype = ctypes.c_size_t
    lib.moolib_sem_init.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.moolib_sem_post.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.moolib_sem_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.moolib_sem_wait.restype = ctypes.c_int
    lib.moolib_sem_value.argtypes = [ctypes.c_void_p]
    lib.moolib_sem_value.restype = ctypes.c_int32
    lib.moolib_ring_size.argtypes = [ctypes.c_uint32]
    lib.moolib_ring_size.restype = ctypes.c_size_t
    lib.moolib_ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.moolib_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64]
    lib.moolib_ring_push.restype = ctypes.c_int
    lib.moolib_ring_pop.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.moolib_ring_pop.restype = ctypes.c_int
    return lib


_shmq = None
_shmq_tried = False


def get_shmq():
    """The native shm/futex library, or None (fallback to multiprocessing)."""
    global _shmq, _shmq_tried
    if not _shmq_tried:
        _shmq_tried = True
        if os.environ.get("MOOLIB_TPU_NO_NATIVE") == "1":
            return None
        _shmq = _load_shmq()
    return _shmq


def _remaining_ms(deadline: Optional[float]) -> int:
    """Milliseconds left before ``deadline`` (monotonic), -1 for none."""
    import time as _time

    return -1 if deadline is None else max(0, int((deadline - _time.monotonic()) * 1000))


def _deadline(timeout: Optional[float]) -> Optional[float]:
    import time as _time

    return None if timeout is None else _time.monotonic() + timeout


class NativeSemaphore:
    """Counting semaphore placed in caller-provided shared memory."""

    def __init__(self, lib, addr: int, initialize: bool = True, initial: int = 0):
        self._lib = lib
        self._addr = addr
        if initialize:
            lib.moolib_sem_init(addr, initial)

    @staticmethod
    def size(lib) -> int:
        return lib.moolib_sem_size()

    def release(self, n: int = 1) -> None:
        self._lib.moolib_sem_post(self._addr, n)

    def acquire(self, timeout: Optional[float] = None) -> bool:
        # The C call returns -2 on EINTR so control comes back to python and
        # pending signal handlers (KeyboardInterrupt) run between retries.
        deadline = _deadline(timeout)
        while True:
            rc = self._lib.moolib_sem_wait(self._addr, _remaining_ms(deadline))
            if rc == 0:
                return True
            if rc == -1:
                return False


class NativeRing:
    """SPSC int32 ring queue in caller-provided shared memory."""

    def __init__(self, lib, addr: int, capacity: int, initialize: bool = True):
        self._lib = lib
        self._addr = addr
        if initialize:
            lib.moolib_ring_init(addr, capacity)

    @staticmethod
    def size(lib, capacity: int) -> int:
        return lib.moolib_ring_size(capacity)

    def push(self, value: int, timeout: Optional[float] = None) -> bool:
        deadline = _deadline(timeout)
        while True:
            rc = self._lib.moolib_ring_push(self._addr, value, _remaining_ms(deadline))
            if rc == 0:
                return True
            if rc == -1:
                return False

    def pop(self, timeout: Optional[float] = None) -> Optional[int]:
        out = ctypes.c_int32()
        deadline = _deadline(timeout)
        while True:
            rc = self._lib.moolib_ring_pop(self._addr, ctypes.byref(out), _remaining_ms(deadline))
            if rc == 0:
                return out.value
            if rc == -1:
                return None
