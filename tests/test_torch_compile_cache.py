"""The shared kernel build cache (``utils.compile_cache``), the port's
counterpart of the JAX package's persistent XLA cache
(``tests/test_compile_cache.py``): a restarted process loads the kernel
libraries an earlier one built instead of running nvcc again.

There is no nvcc on this machine, so the children build with a stand-in
``$CUDA_HOME/bin/nvcc`` that writes its output file, sleeps a little and
logs the call: what is held is the cache's behaviour — who compiles, where
the library lands, what ``build_info`` reports — not the compiler.
"""

import os
import stat
import subprocess
import sys

import pytest

from moolib_tpu_torch.ops import _build
from moolib_tpu_torch.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
sleep 0.2
echo "fake library" > "$out"
echo "$out" >> "$NVCC_LOG"
"""

_CHILD = r"""
import json, sys
sys.path.insert(0, %(root)r)
from moolib_tpu_torch.utils import init_compile_cache
d = init_compile_cache()
assert d, "MOOLIB_COMPILE_CACHE not picked up"
from moolib_tpu_torch.ops import _build
paths = _build.build_all()
print("RESULT=" + json.dumps({"dir": _build.BUILD_DIR, "paths": paths,
      "seconds": {k: v["seconds"] for k, v in _build.build_info.items()}}), flush=True)
"""


@pytest.fixture
def fake_cuda(tmp_path):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return str(home), str(tmp_path / "nvcc.log")


def _incarnation(cache_dir, fake_cuda, extra_env=None):
    import json

    home, log = fake_cuda
    env = dict(os.environ, MOOLIB_COMPILE_CACHE=cache_dir, CUDA_HOME=home, NVCC_LOG=log,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **(extra_env or {}))
    return subprocess.Popen([sys.executable, "-c", _CHILD % {"root": ROOT}],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env), json


def _result(proc_json):
    proc, json = proc_json
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    line = [l for l in out.splitlines() if l.startswith("RESULT=")][0]
    return json.loads(line[len("RESULT="):])


def _nvcc_calls(fake_cuda):
    try:
        with open(fake_cuda[1]) as f:
            return f.read().split()
    except FileNotFoundError:
        return []


def test_second_restart_loads_from_cache(tmp_path, fake_cuda):
    """Restart shape: incarnation 1 compiles every kernel into the shared
    directory (seconds > 0); incarnation 2 finds each library there and
    runs no compiler (seconds 0.0)."""
    cache = str(tmp_path / "kernels")
    first = _result(_incarnation(cache, fake_cuda))
    names = _build.kernel_names()
    assert first["dir"] == cache and sorted(first["seconds"]) == names
    assert all(s > 0 for s in first["seconds"].values())
    assert all(os.path.dirname(p) == cache for p in first["paths"].values())
    assert len(_nvcc_calls(fake_cuda)) == len(names)
    second = _result(_incarnation(cache, fake_cuda))
    assert second["seconds"] == {n: 0.0 for n in names}
    assert second["paths"] == first["paths"]
    assert len(_nvcc_calls(fake_cuda)) == len(names)  # nothing compiled again


def test_concurrent_first_builds_share_the_directory(tmp_path, fake_cuda):
    """Two peers starting at once against one empty directory: both come up,
    each library is installed once under its key, and no tmp husk stays."""
    cache = str(tmp_path / "shared")
    a, b = _incarnation(cache, fake_cuda), _incarnation(cache, fake_cuda)
    ra, rb = _result(a), _result(b)
    assert ra["paths"] == rb["paths"]
    assert sorted(os.listdir(cache)) == sorted(os.path.basename(p) for p in ra["paths"].values())


def test_min_knobs_of_the_jax_cache_change_nothing(tmp_path, fake_cuda):
    cache = str(tmp_path / "knobs")
    res = _result(_incarnation(cache, fake_cuda, {
        "MOOLIB_COMPILE_CACHE_MIN_COMPILE_SECS": "1000",
        "MOOLIB_COMPILE_CACHE_MIN_ENTRY_BYTES": "1000000000"}))
    assert all(s > 0 for s in res["seconds"].values())
    assert len(os.listdir(cache)) == len(_build.kernel_names())


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.delenv("MOOLIB_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(compile_cache, "_initialized_dir", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_libs", {})
    return monkeypatch


def test_init_compile_cache_noop_and_idempotent(tmp_path, fresh):
    default = _build.BUILD_DIR
    assert compile_cache.init_compile_cache() is None
    assert compile_cache.compile_cache_dir() is None and _build.BUILD_DIR == default
    d = str(tmp_path / "c")
    assert compile_cache.init_compile_cache(d) == os.path.abspath(d)
    assert os.path.isdir(d) and _build.BUILD_DIR == os.path.abspath(d)
    # First configured directory wins (the build directory is process-global).
    assert compile_cache.init_compile_cache(str(tmp_path / "other")) == os.path.abspath(d)
    assert compile_cache.compile_cache_dir() == os.path.abspath(d)
    assert _build.BUILD_DIR == os.path.abspath(d)


def test_env_var_configures(tmp_path, fresh):
    d = str(tmp_path / "from_env")
    fresh.setenv("MOOLIB_COMPILE_CACHE", d)
    assert compile_cache.init_compile_cache() == os.path.abspath(d)
    assert compile_cache.init_compile_cache(str(tmp_path / "explicit")) == os.path.abspath(d)


def test_explicit_argument_wins_over_the_environment(tmp_path, fresh):
    fresh.setenv("MOOLIB_COMPILE_CACHE", str(tmp_path / "env"))
    d = str(tmp_path / "arg")
    assert compile_cache.init_compile_cache(d) == os.path.abspath(d)


def test_after_a_kernel_load_the_first_directory_stays(tmp_path, fresh):
    """A library already loaded from the default directory pins it: a later
    init warns, keeps that directory and wires nothing."""
    default = _build.BUILD_DIR
    fresh.setattr(_build, "_libs", {"flash_fwd": object()})
    assert compile_cache.init_compile_cache(str(tmp_path / "late")) is None
    assert _build.BUILD_DIR == default and compile_cache.compile_cache_dir() is None
    assert not os.path.exists(tmp_path / "late")
