"""The port's env plane against the JAX package's: the numpy env copies,
the Batcher and the EnvPool.

The Batcher cases mirror ``tests/test_batcher.py`` and compare each
completed batch with the JAX package's Batcher fed the same items.  The
EnvPool cases mirror ``tests/test_envpool.py`` with real worker processes,
each pool closed in ``finally`` and every wait bounded; the same seeded
actions through both packages' pools give the same observations.  The env
copies replay the JAX package's trajectories exactly from the same seed.
"""

import asyncio
import functools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from moolib_tpu import Batcher as JBatcher
from moolib_tpu import envs as jenvs
from moolib_tpu_torch import envs as tenvs
from moolib_tpu_torch import telemetry
from moolib_tpu_torch.batcher import Batcher
from moolib_tpu_torch.envpool import EnvPool, RestartPolicy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ envs


class _Space:
    n = 6


class FakeALE:
    """gymnasium-API env of 210x160 RGB frames whose brightness encodes the
    emulator step (as in ``tests/test_atari_env.py``)."""

    action_space = _Space()

    def reset(self, seed=None):
        self.t = 0
        return self._frame(), {}

    def _frame(self):
        return np.full((210, 160, 3), min(10 * self.t, 255), np.uint8)

    def step(self, action):
        self.t += 1
        return self._frame(), 1.0, self.t >= 25, False, {}


ENVS = {
    "catch": lambda pkg: pkg.CatchEnv(seed=3),
    "pixel_catch": lambda pkg: pkg.CatchEnv(seed=4, frame_shape=(42, 42)),
    "flat_catch": lambda pkg: pkg.FlatCatchEnv(seed=5),
    "frame_stack": lambda pkg: pkg.FrameStack(pkg.CatchEnv(seed=6), num_stack=4),
    "cartpole": lambda pkg: pkg.CartPoleEnv(seed=7, max_episode_steps=50),
    "synthetic": lambda pkg: pkg.SyntheticAtariEnv(seed=8, episode_length=30),
    "atari_preprocessing": lambda pkg: pkg.AtariPreprocessing(
        FakeALE(), sticky_action_prob=0.25, noop_max=3, seed=9),
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_copies_replay_the_jax_trajectories(name):
    jenv, tenv = ENVS[name](jenvs), ENVS[name](tenvs)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    actions = np.random.default_rng(0).integers(0, 2, 60)
    for a in actions:
        j, t = jenv.step(int(a)), tenv.step(int(a))
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1:3] == j[1:3]
        if t[2]:
            np.testing.assert_array_equal(tenv.reset(), jenv.reset())


# --------------------------------------------------------------- Batcher


def _both(size, **kw):
    return Batcher(size, **kw), JBatcher(size, **kw)


def _drain(b):
    out = []
    while not b.empty():
        out.append(b.get())
    return out


def _assert_same_batches(port, jax_batcher):
    got, want = _drain(port), _drain(jax_batcher)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for gl, wl in zip(_leaves(g), _leaves(w)):
            assert isinstance(gl, np.ndarray)  # device=None: batches stay host numpy
            np.testing.assert_array_equal(gl, np.asarray(wl))


def _leaves(x):
    return [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]


def test_stack_matches_jax():
    port, ref = _both(4, dim=0)
    for i in range(4):
        item = {"x": np.full((2, 3), float(i)), "s": np.float32(i)}
        port.stack(item)
        ref.stack(item)
    _assert_same_batches(port, ref)


def test_stack_dim1_matches_jax():
    port, ref = _both(3, dim=1)
    for i in range(3):
        port.stack(np.full((2, 4), float(i)))
        ref.stack(np.full((2, 4), float(i)))
    _assert_same_batches(port, ref)


def test_cat_exact_and_overflow_carry_match_jax():
    port, ref = _both(4, dim=0)
    for b in (port, ref):
        b.cat(np.arange(10).reshape(10, 1).astype(np.float32))
    assert port.size() == ref.size() == 2
    for b in (port, ref):
        b.cat(np.arange(2).reshape(2, 1).astype(np.float32) + 50)
    _assert_same_batches(port, ref)
    assert port.size() == 0


def test_cat_randomized_matches_jax():
    rng = np.random.default_rng(7)
    port, ref = _both(8, dim=0)
    for _ in range(30):
        item = {"x": rng.normal(size=(int(rng.integers(1, 13)), 5)).astype(np.float32)}
        port.cat(item)
        ref.cat(item)
    _assert_same_batches(port, ref)


def test_tensor_items_take_the_host_path():
    b = Batcher(2)
    b.stack({"a": torch.ones(3), "b": np.zeros(2)})
    b.stack({"a": torch.zeros(3), "b": np.ones(2)})
    out = b.get()
    assert isinstance(out["a"], np.ndarray) and out["a"].shape == (2, 3)
    np.testing.assert_array_equal(out["a"][0], 1.0)


def test_get_without_batch_raises():
    with pytest.raises(RuntimeError):
        Batcher(2).get()


def test_await_batches():
    b = Batcher(2)

    async def main():
        b.stack(np.ones(1))
        b.stack(np.zeros(1))
        return await b

    assert np.asarray(asyncio.run(main())).shape == (2, 1)


def test_max_outstanding_blocks_producer():
    b = Batcher(1, dim=0, max_outstanding=2, name="torch_bounded")
    produced = []

    def producer():
        for i in range(5):
            b.stack(np.full((3,), float(i)))
            produced.append(i)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    deadline = time.time() + 5.0
    while len(produced) < 2 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)  # give the producer a chance to (wrongly) run ahead
    assert produced == [0, 1], produced
    snap = telemetry.get_registry().snapshot()
    depth = [s["value"] for s in snap["batcher_queue_depth"]["series"]
             if s["labels"].get("batcher") == "torch_bounded"]
    assert depth == [2.0]
    for expect in range(5):
        waited = time.time() + 5.0
        while b.empty() and time.time() < waited:
            time.sleep(0.005)
        np.testing.assert_array_equal(b.get(), np.full((1, 3), float(expect)))
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert produced == [0, 1, 2, 3, 4]


def test_max_outstanding_waiter_direct_handoff():
    b = Batcher(1, max_outstanding=1)

    async def consume():
        return await b

    async def main():
        task = asyncio.ensure_future(consume())
        await asyncio.sleep(0.05)
        b.stack(np.ones(2))  # straight to the waiter, the queue stays empty
        first = await task
        assert b.empty()
        b.stack(np.zeros(2))
        return first, await b

    first, second = asyncio.run(main())
    np.testing.assert_array_equal(first, np.ones((1, 2)))
    np.testing.assert_array_equal(second, np.zeros((1, 2)))


def test_max_outstanding_validation():
    with pytest.raises(ValueError):
        Batcher(2, max_outstanding=0)
    with pytest.raises(ValueError):
        Batcher(0)


def test_batcher_device_without_a_card():
    """device=None and "cpu" keep batches on the host, as in the JAX
    package; "cuda" without a card raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA behaviour cannot show")
    from moolib_tpu_torch._device import NoCudaError

    for device in (None, "", "cpu", torch.device("cpu")):
        b = Batcher(1, device=device)
        b.stack(np.ones(2))
        assert isinstance(b.get(), np.ndarray)
    with pytest.raises(NoCudaError):
        Batcher(1, device="cuda")


# --------------------------------------------------------------- EnvPool


class FakeEnv:
    """Deterministic env: obs counts steps; done every 5th step."""

    def reset(self):
        self.counter = 0.0
        return {"obs": np.array([self.counter], dtype=np.float32)}

    def step(self, action):
        self.counter += 1.0 + float(action)
        return ({"obs": np.array([self.counter], dtype=np.float32)}, float(action),
                self.counter >= 5.0, {})


class ExplodingEnv(FakeEnv):
    def step(self, action):
        self._n = getattr(self, "_n", 0) + 1
        if self._n > 2:
            raise ValueError("env exploded mid-training")
        return super().step(action)


class SlowEnv:
    def reset(self):
        return np.zeros(2, np.float32)

    def step(self, action):
        time.sleep(0.3)
        return np.full(2, 7.0, np.float32), 1.0, False, {}


def _start_methods(pool):
    return {type(p).__name__ for p in pool._procs}


@pytest.fixture
def pools():
    made = []
    yield lambda *a, **kw: made.append(EnvPool(*a, **kw)) or made[-1]
    for pool in made:
        pool.close()


def test_envpool_basic(pools):
    pool = pools(FakeEnv, num_processes=2, batch_size=4, num_batches=1)
    assert _start_methods(pool) == {"ForkProcess"}  # no CUDA context in this process
    out = pool.step(0, np.zeros(4, np.int64)).result()
    assert set(out) == {"obs", "reward", "done"}
    np.testing.assert_array_equal(out["obs"][:, 0], 1.0)
    for _ in range(3):
        out = pool.step(0, torch.zeros(4, dtype=torch.int64)).result()  # a CPU tensor
    np.testing.assert_array_equal(out["obs"][:, 0], 4.0)
    out = pool.step(0, np.zeros(4, np.int64)).result()
    assert out["done"].all()  # hit 5 -> auto-reset, obs is fresh
    np.testing.assert_array_equal(out["obs"][:, 0], 0.0)


def test_envpool_double_buffer_and_inflight_guard(pools):
    pool = pools(FakeEnv, num_processes=2, batch_size=4, num_batches=2)
    f0 = pool.step(0, np.zeros(4, np.int64))
    f1 = pool.step(1, np.ones(4, np.int64))
    with pytest.raises(RuntimeError, match="in flight"):
        pool.step(0, np.zeros(4, np.int64))
    out0, out1 = f0.result(), f1.result()
    np.testing.assert_array_equal(out0["obs"][:, 0], 1.0)
    np.testing.assert_array_equal(out1["obs"][:, 0], 2.0)
    np.testing.assert_array_equal(out1["reward"], 1.0)


def test_envpool_cartpole_shapes(pools):
    pool = pools(tenvs.CartPoleEnv, num_processes=2, batch_size=8, num_batches=1)
    rng = np.random.default_rng(0)
    for _ in range(20):
        out = pool.step(0, rng.integers(0, 2, size=8)).result()
    assert out["state"].shape == (8, 4) and out["state"].dtype == np.float32
    np.testing.assert_array_equal(out["reward"], 1.0)
    assert pool.obs_spec["state"] == ((4,), np.dtype(np.float32))


def _make_bad():
    raise RuntimeError("nope")


def test_bad_env_raises():
    with pytest.raises(RuntimeError, match="failed in worker 0"):
        EnvPool(_make_bad, num_processes=1, batch_size=1, num_batches=1)


def test_env_exception_surfaces_fast(pools):
    pool = pools(ExplodingEnv, num_processes=1, batch_size=2, num_batches=1)
    acts = np.zeros(2, np.int64)
    pool.step(0, acts).result()
    pool.step(0, acts).result()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="env exploded mid-training"):
        pool.step(0, acts).result()
    assert time.monotonic() - t0 < 30


def test_worker_killed_mid_step_respawns(pools):
    restarts = telemetry.get_registry().counter_values().get("envpool_worker_restarts", 0.0)
    pool = pools(SlowEnv, num_processes=2, batch_size=4, num_batches=1)
    fut = pool.step(0, np.zeros(4, np.int64))
    time.sleep(0.1)
    pool._procs[1].kill()
    out = fut.result()  # the same future completes on the respawned worker
    np.testing.assert_array_equal(out["state"][:, 0], 7.0)
    out = pool.step(0, np.zeros(4, np.int64)).result()
    np.testing.assert_array_equal(out["reward"], 1.0)
    got = telemetry.get_registry().counter_values()["envpool_worker_restarts"]
    assert got == restarts + 1


def test_worker_death_fails_fast_without_restarts(pools):
    pool = pools(SlowEnv, num_processes=1, batch_size=1, num_batches=1,
                 restart_policy=RestartPolicy(enabled=False))
    fut = pool.step(0, np.zeros(1, np.int64))
    pool._procs[0].kill()
    with pytest.raises(RuntimeError, match="died"):
        fut.result()


def test_forkserver_start_method_works(monkeypatch, pools):
    monkeypatch.setenv("MOOLIB_TPU_ENVPOOL_START", "forkserver")
    pool = pools(functools.partial(tenvs.CatchEnv, seed=1), num_processes=2, batch_size=4)
    assert _start_methods(pool) == {"ForkServerProcess"}
    assert pool.step(0, np.zeros(4, np.int64)).result()["state"].shape == (4, 10, 5, 1)


def test_forkserver_rejects_unpicklable_create_env(monkeypatch):
    monkeypatch.setenv("MOOLIB_TPU_ENVPOOL_START", "forkserver")
    with pytest.raises(RuntimeError, match="picklable create_env"):
        EnvPool(lambda: FakeEnv(), num_processes=1, batch_size=1, num_batches=1)


def test_auto_selects_forkserver_once_cuda_is_initialized(monkeypatch):
    """After a CUDA context exists the pool must not plain-fork; the probe
    never initializes CUDA itself."""
    from moolib_tpu_torch import envpool

    monkeypatch.delenv("MOOLIB_TPU_ENVPOOL_START", raising=False)
    assert not envpool._cuda_initialized()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert envpool._cuda_initialized()
    with pytest.raises(RuntimeError, match="after CUDA initialization uses the forkserver"):
        EnvPool(lambda: FakeEnv(), num_processes=1, batch_size=1, num_batches=1)


_GLOO_GUARD = r"""
import os, socket, sys
import torch.distributed as dist
from moolib_tpu_torch import envpool
from moolib_tpu_torch.envpool import EnvPool
os.environ.pop("MOOLIB_TPU_ENVPOOL_START", None)
assert not envpool._cuda_initialized()
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port, rank=0, world_size=1)
try:
    assert envpool._cuda_initialized()
    try:
        EnvPool(lambda: None, num_processes=1, batch_size=1, num_batches=1)
    except RuntimeError as e:
        assert "forkserver" in str(e), e
        print("refused plain fork")
finally:
    dist.destroy_process_group()
"""


def test_pool_refuses_plain_fork_once_a_process_group_exists():
    """A one-rank gloo process group starts threads without any CUDA
    context; after it the pool must not plain-fork (the forkserver path
    then insists on a picklable create_env).  In a subprocess: the group is
    process-wide."""
    proc = subprocess.run(
        [sys.executable, "-c", _GLOO_GUARD], env=dict(os.environ, PYTHONPATH=ROOT),
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "refused plain fork" in proc.stdout


PARITY = """
import functools, sys
import numpy as np
from moolib_tpu import EnvPool as JPool
from moolib_tpu import envs as jenvs
from moolib_tpu_torch import envs as tenvs
from moolib_tpu_torch.envpool import EnvPool as TPool

for name, n_act, kw in (("CatchEnv", 3, {}), ("CartPoleEnv", 2, {"max_episode_steps": 30})):
    pools = [Pool(functools.partial(getattr(pkg, name), seed=11, **kw), num_processes=2,
                  batch_size=4, num_batches=2)
             for Pool, pkg in ((JPool, jenvs), (TPool, tenvs))]
    try:
        assert {type(p).__name__ for p in pools[1]._procs} == {"ForkProcess"}
        assert pools[0].obs_spec == pools[1].obs_spec
        rng = np.random.default_rng(0)
        for step in range(40):
            b = step % 2
            act = rng.integers(0, n_act, size=4)
            want, got = (p.step(b, act).result() for p in pools)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
    finally:
        for p in pools:
            p.close()
print("ENVPOOL-PARITY-OK")
"""


def test_envpool_matches_the_jax_envpool_in_a_fresh_process():
    """Both pools fork from a process with no jax backend and no CUDA
    context; the same seeded actions give the same observations, rewards
    and dones, through double-buffered batches and auto-resets."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", PARITY], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ENVPOOL-PARITY-OK" in proc.stdout
