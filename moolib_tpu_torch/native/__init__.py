"""Native (C++) runtime components, built on first use.

The sources are the repo-root ``native/`` files the JAX package builds too;
the port compiles its own copies with g++ into ``~/.cache/moolib_tpu_torch``
(or ``$MOOLIB_TPU_TORCH_CACHE``), keyed by source hash:

- ``_moolib_codec``: CPython-extension message codec (tag-based encoding,
  out-of-band zero-copy arrays, pickle fallback).  The port's dlopen'd copy
  fills the codec's accelerator-array slot with ``torch.Tensor``.
- ``libmoolib_net`` (``native/transport.cc``, bound in :mod:`.transport`).

Both are accelerators of the host plane: without a compiler the pure-python
paths are used and everything still works.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig

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
