"""Build the port's CUDA kernels on first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which the kernel's wrapper loads with
ctypes and calls with ``data_ptr()``s and the current stream.  The library
lands in ``moolib_tpu_torch/_build/``, keyed by :func:`source_digest`: the
source, every header under ``csrc/`` and the compiler flags, so an edited
source or header rebuilds and an unchanged tree is reused.
No ninja and no PyTorch headers are involved (a source that includes
PyTorch's headers takes minutes to compile; these take seconds).

Nothing here runs at import time: building needs ``nvcc``, which only the
machine with the card has.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when cached), "log": nvcc's stderr}
build_info: Dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            path = os.path.join(root, "bin", "nvcc")
            if os.path.exists(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)"
        )
    return path


def source_digest(name: str, csrc: str = _CSRC) -> str:
    """Key of the library ``name``: a hash of everything that builds it —
    ``<name>.cu``, every header under ``csrc`` (``*.cuh``, ``*.h``: any of
    them may be included) and every flag passed to nvcc."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(csrc) if f.endswith((".cuh", ".h")))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(csrc, fname), "rb") as f:
            data = f.read()
        digest.update(f"{fname}\0{len(data)}\0".encode())
        digest.update(data)
    digest.update("\0".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library with its
    :func:`source_digest` exists; returns the library's path."""
    src = os.path.join(_CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}_{source_digest(name)}.so")
    if os.path.exists(out):
        build_info[name] = {"seconds": 0.0, "log": "", "path": out}
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Per-process tmp name: concurrent first-use builds must not interleave
    # writes; os.replace makes the install atomic.
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    cmd = [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {src}:\n{proc.stderr[-8000:]}")
    os.replace(tmp, out)
    build_info[name] = {
        "seconds": time.perf_counter() - t0,
        "log": proc.stderr,
        "path": out,
    }
    return out


def kernel_names(csrc: str = _CSRC) -> List[str]:
    """Every kernel source under ``csrc`` (``*.cu``; headers are not kernels)."""
    return sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))


def build_all() -> Dict[str, str]:
    """Build every kernel source at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    names = kernel_names()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use in this process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
