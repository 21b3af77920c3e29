"""EnvPool: multi-process batched environment stepping over shared memory.

Counterpart of the reference's fork-server EnvPool/EnvRunner/EnvStepper
(``src/env.{h,cc}``, ``src/shm.h``, bindings ``src/moolib.cc:1587-1644``):
``num_processes`` forked worker processes each own a contiguous slice of every
batch of ``batch_size`` environments; actions are scattered through POSIX
shared memory, workers step their envs (auto-resetting on done) and write
observations/reward/done into per-batch shm slots; ``step(batch_index,
action)`` returns an ``EnvStepperFuture`` whose ``result()`` blocks on
completion semaphores and returns **zero-copy numpy views** of the shm
buffers.  ``num_batches`` > 1 gives double buffering: act on batch 0 while
batch 1 is stepping (reference ``src/moolib.cc:1587-1630`` docstring).

The PyTorch port of the JAX package's ``envpool``.  Design differences from
the reference (not a translation):
- worker start method enforces the reference's fork-safety contract
  (``src/env.cc:149-169``): plain ``fork`` while no CUDA context exists in
  this process (fast, closures allowed), an automatic switch to
  ``forkserver`` afterwards (the server is fork+exec'd, so it is safe with
  the CUDA driver's threads; ``create_env`` must then be picklable).
  Constructing the pool before the first CUDA call remains the preferred
  order.
- the doorbell is a per-worker task queue + per-batch completion semaphore
  (futex-backed) instead of spin-waiting on atomic action words.
- results are host numpy views meant to be fed to ``Batcher``, which lands
  them on the card in one copy per leaf.
- ``step()`` accepts a CUDA tensor of actions: its copy to a pinned host
  buffer is issued non-blocking and one CUDA event is waited on before the
  actions are written to shared memory.
- worker death is a supervised event, not a run-killer: a slot that dies is
  respawned and re-attached to the existing shm segments/doorbells, its
  in-flight step tasks are re-issued (pending ``EnvStepperFuture``s complete
  through a shm progress ledger), and only a slot exceeding its
  :class:`RestartPolicy` respawn budget surfaces a hard error
  (docs/RESILIENCE.md; ``envpool_worker_restarts`` /
  ``envpool_worker_quarantined`` telemetry counters).

The JAX package's ``_maybe_init_worker_compile_cache`` (a persistent XLA
compile cache for jax-using envs in workers) has no counterpart: the port's
workers compile nothing.

Env protocol: ``create_env()`` returns an object with ``reset() -> obs`` and
``step(action) -> (obs, reward, done, info[, truncated])`` (both gym 4-tuple
and gymnasium 5-tuple are accepted); ``obs`` is an ndarray or a flat dict of
ndarrays with fixed shapes/dtypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import multiprocessing as mp
import os
import pickle
import time
import traceback
from collections import deque
from multiprocessing import shared_memory
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from . import telemetry, utils

# Pool metrics (docs/TELEMETRY.md), parent-process side only: workers report
# through shm, and their own counters would land in a registry nobody scrapes.
_REG = telemetry.get_registry()
_M_ENV_STEPS = _REG.counter(
    "envpool_steps_total", "environment steps completed (parent-observed)"
)
_M_ENV_BATCHES = _REG.counter("envpool_batches_total", "batch steps completed")
_M_STEP_WAIT = _REG.histogram(
    "envpool_step_wait_seconds", "result() wait for a batch step to complete"
)
_M_WORKERS = _REG.gauge("envpool_workers", "worker processes of live pools")
_M_RESTARTS = _REG.counter(
    "envpool_worker_restarts", "worker processes respawned after an unexpected death"
)
_M_QUARANTINED = _REG.counter(
    "envpool_worker_quarantined", "worker slots hard-failed after repeated deaths"
)


@dataclasses.dataclass
class RestartPolicy:
    """Supervision policy for EnvPool worker processes (docs/RESILIENCE.md).

    A worker that dies without reporting an env exception is respawned and
    re-attached to the pool's existing shm segments and doorbells; in-flight
    step tasks it never completed are re-issued so pending futures still
    complete.  A slot that dies more than ``max_restarts`` times within
    ``window`` seconds is quarantined: the death surfaces as a hard
    ``RuntimeError`` (crash loops must not spin silently).  ``enabled=False``
    (or ``max_restarts=0``) restores the fail-fast behavior: any worker
    death raises immediately.
    """

    max_restarts: int = 3
    window: float = 60.0
    enabled: bool = True


def _cuda_initialized() -> bool:
    """True once this process holds a CUDA context or a torch.distributed
    process group — the points after which a plain fork() is unsafe (the
    driver and the group's backends are multithreaded, and a forked child
    can use neither).  Asks without initializing either."""
    if torch.cuda.is_initialized():
        return True
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


_FIELD_RESERVED = ("reward", "done")
_SHUTDOWN = -1


class _MpQueue:
    """Fallback doorbell: multiprocessing SimpleQueue of batch indices."""

    def __init__(self, ctx):
        self._q = ctx.SimpleQueue()

    def put(self, v: int) -> None:
        self._q.put(v)

    def get(self) -> int:
        return self._q.get()

    def drain(self) -> None:
        """Discard queued tasks.  Only safe while the consumer is dead and
        the caller is the sole producer (worker-respawn recovery)."""
        while not self._q.empty():
            self._q.get()


class _MpSem:
    def __init__(self, ctx):
        self._s = ctx.Semaphore(0)

    def release(self) -> None:
        self._s.release()

    def acquire(self, timeout=None) -> bool:
        return self._s.acquire(True, timeout)


class _RingQueue:
    def __init__(self, ring):
        self._ring = ring

    def put(self, v: int) -> None:
        self._ring.push(int(v))

    def get(self) -> int:
        out = self._ring.pop()
        return _SHUTDOWN if out is None else out

    def drain(self) -> None:
        """Discard queued tasks (worker-respawn recovery; see _MpQueue)."""
        while self._ring.pop(timeout=0) is not None:
            pass


def _doorbell_layout(lib, cap, num_processes, num_batches):
    """Single owner of the doorbell shm layout math — the parent's size
    computation and both sides' view placement must agree byte-for-byte."""
    from . import native

    ring_sz = (native.NativeRing.size(lib, cap) + 63) & ~63
    sem_sz = (native.NativeSemaphore.size(lib) + 63) & ~63
    total = ring_sz * num_processes + sem_sz * num_batches
    return ring_sz, sem_sz, total


def _native_doorbell_views(lib, buf, cap, num_processes, num_batches, initialize):
    """Construct ring/semaphore handles over a doorbell shm region."""
    from . import native

    ring_sz, sem_sz, _ = _doorbell_layout(lib, cap, num_processes, num_batches)
    base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    queues = [
        _RingQueue(
            native.NativeRing(lib, base + i * ring_sz, cap, initialize=initialize)
        )
        for i in range(num_processes)
    ]
    off = ring_sz * num_processes
    sems = [
        native.NativeSemaphore(lib, base + off + i * sem_sz, initialize=initialize)
        for i in range(num_batches)
    ]
    return queues, sems


def _make_doorbells(ctx, num_processes: int, num_batches: int):
    """Native futex rings/semaphores in one NAMED shm segment (counterpart of
    the reference's shm semaphores + queues, src/shm.h), falling back to
    multiprocessing primitives when g++ is unavailable.

    Returns ``(queues, sems, region, descriptor)``: workers reconstruct their
    handles from ``descriptor`` by attaching the named segment, so the pool
    works under both the ``fork`` and ``forkserver`` start methods (the
    anonymous-mmap design it replaces required address-space inheritance and
    thus fork)."""
    from . import native

    lib = native.get_shmq()
    if lib is None:
        queues = [_MpQueue(ctx) for _ in range(num_processes)]
        sems = [_MpSem(ctx) for _ in range(num_batches)]
        # mp primitives pickle through Process args under either start method;
        # per-worker descriptors are built at spawn so each worker receives
        # only its own queue's fds, not all N workers'.
        return queues, sems, None, ("mp", queues, sems)
    # Power-of-two capacity: the ring indexes with u32 cursors mod capacity,
    # which only stays consistent across the 2^32 wrap for powers of two.
    cap = 16
    while cap < 4 * num_batches:
        cap *= 2
    _, _, total = _doorbell_layout(lib, cap, num_processes, num_batches)
    region = shared_memory.SharedMemory(create=True, size=total)
    try:
        queues, sems = _native_doorbell_views(
            lib, region.buf, cap, num_processes, num_batches, initialize=True
        )
    except Exception:
        # Not yet owned by a pool: unlink here or the named segment leaks.
        try:
            region.unlink()
        except Exception:
            pass
        raise
    return queues, sems, region, ("native", region.name, cap, num_processes, num_batches)


def _worker_doorbell_desc(desc, worker_index):
    """Slice the pool-wide descriptor down to one worker's share (mp fallback:
    just that worker's queue, so its peers' pipe fds never travel)."""
    if desc[0] == "mp":
        _, queues, sems = desc
        return ("mp", queues[worker_index], sems)
    return desc


def _attach_doorbells(desc, worker_index):
    """Worker-side counterpart of :func:`_make_doorbells`: resolve the
    descriptor into (task_queue, done_sems[, segment])."""
    if desc[0] == "mp":
        _, queue, sems = desc
        return queue, sems, None
    from . import native

    _, shm_name, cap, num_processes, num_batches = desc
    seg = shared_memory.SharedMemory(name=shm_name)
    queues, sems = _native_doorbell_views(
        native.get_shmq(), seg.buf, cap, num_processes, num_batches, initialize=False
    )
    return queues[worker_index], sems, seg


def _normalize_obs(obs) -> Dict[str, np.ndarray]:
    if isinstance(obs, dict):
        return {k: np.asarray(v) for k, v in obs.items()}
    return {"state": np.asarray(obs)}


def _step_env(env, action):
    """Step with auto-reset; tolerate gym (4-tuple) and gymnasium (5-tuple)."""
    out = env.step(action)
    if len(out) == 5:
        obs, reward, terminated, truncated, _info = out
        done = bool(terminated) or bool(truncated)
    else:
        obs, reward, done, _info = out
        done = bool(done)
    if done:
        obs = env.reset()
        if isinstance(obs, tuple):  # gymnasium reset -> (obs, info)
            obs = obs[0]
    return obs, float(reward), done


def _reset_env(env):
    obs = env.reset()
    if isinstance(obs, tuple):
        obs = obs[0]
    return obs


class EnvRunner:
    """Worker-process loop: owns envs [lo, hi) of every batch (reference
    ``EnvRunner::run`` ``src/env.h:407-453``)."""

    def __init__(self, create_env, worker_index, lo, hi, num_batches, conn,
                 task_queue, done_sems, discover: bool = False):
        self.create_env = create_env
        self.worker_index = worker_index
        self.lo = lo
        self.hi = hi
        self.num_batches = num_batches
        self.conn = conn
        self.task_queue = task_queue
        self.done_sems = done_sems
        self.discover = discover
        self.envs: Dict[Tuple[int, int], Any] = {}
        self._running = False

    def start(self) -> None:
        self._running = True
        self.run()

    def running(self) -> bool:
        return self._running

    def run(self) -> None:
        if self.discover:
            # Spec discovery happens in THIS worker's first real env: the shm
            # batch layout derives from its reset observation (reference
            # allocateBatch-from-first-obs, ``src/env.h:214-246``) and the
            # env is kept for stepping — no throwaway probe process.
            try:
                env = self.create_env()
                obs = _normalize_obs(_reset_env(env))
                spec = {k: (v.shape, v.dtype.str) for k, v in obs.items()}
                self.conn.send(("ok", spec))
                if self.lo < self.hi and self.num_batches > 0:
                    self.envs[(0, self.lo)] = env  # freshly reset; first
                    # step() on this slot steps it like the lazy path would
            except Exception as e:  # noqa: BLE001 — parent raises it
                try:
                    self.conn.send(("error", repr(e)))
                except Exception:
                    pass
                return
        # Wait for the parent to send the shm layout (created after spec
        # discovery), then serve step requests until shutdown.
        try:
            layout = self.conn.recv()
        except EOFError:
            return
        obs_shm = {}
        views: Dict[int, Dict[str, np.ndarray]] = {}
        act_views: Dict[int, np.ndarray] = {}
        segs = []
        for b in range(self.num_batches):
            views[b] = {}
            for key, (shm_name, shape, dtype) in layout["obs"][b].items():
                seg = shared_memory.SharedMemory(name=shm_name)
                segs.append(seg)
                views[b][key] = np.ndarray(shape, dtype=dtype, buffer=seg.buf)
            shm_name, shape, dtype = layout["act"][b]
            seg = shared_memory.SharedMemory(name=shm_name)
            segs.append(seg)
            act_views[b] = np.ndarray(shape, dtype=dtype, buffer=seg.buf)
        # Completion ledger [num_batches, num_processes]: cell (b, w) counts
        # the batch-b steps THIS worker finished.  Written after the slice
        # lands, so the parent can always tell a completed slice from one a
        # killed worker left half-written — the recovery ground truth (the
        # per-batch semaphore is only a wake-up hint).
        progress = None
        if "progress" in layout:
            shm_name, shape, dtype = layout["progress"]
            seg = shared_memory.SharedMemory(name=shm_name)
            segs.append(seg)
            progress = np.ndarray(shape, dtype=dtype, buffer=seg.buf)
        try:
            while True:
                b = self._get_task()
                if b is None or b == _SHUTDOWN:
                    break
                try:
                    self._step_batch(b, views[b], act_views[b])
                except Exception:
                    # Report the env traceback to the parent (result() polls
                    # the pipe) before dying — a user env bug surfaces in
                    # seconds with its real traceback, not as an opaque
                    # 120 s step timeout.
                    try:
                        self.conn.send(
                            ("step_error", self.worker_index, traceback.format_exc())
                        )
                    except Exception:
                        pass
                    raise
                if progress is not None:
                    progress[b, self.worker_index] += 1
                self.done_sems[b].release()
        finally:
            for seg in segs:
                seg.close()

    def _get_task(self):
        """Blocking task fetch with an idle suicide timer: an orphaned worker
        (parent gone without close()) exits instead of lingering forever
        (reference EnvRunner 1800 s idle suicide, src/env.h:446-450)."""
        get = getattr(self.task_queue, "get_timeout", None)
        if get is None and hasattr(self.task_queue, "_ring"):
            out = self.task_queue._ring.pop(timeout=1800.0)
            return _SHUTDOWN if out is None else out
        return self.task_queue.get()

    def _step_batch(self, b: int, view: Dict[str, np.ndarray], actions: np.ndarray):
        for i in range(self.lo, self.hi):
            env = self.envs.get((b, i))
            if env is None:
                env = self.create_env()
                self.envs[(b, i)] = env
                obs = _normalize_obs(_reset_env(env))
                reward, done = 0.0, False
                # Apply the incoming action to the fresh env.
                obs_, reward, done = _step_env(env, actions[i])
                obs = _normalize_obs(obs_)
            else:
                obs_, reward, done = _step_env(env, actions[i])
                obs = _normalize_obs(obs_)
            for k, v in obs.items():
                view[k][i] = v
            view["reward"][i] = reward
            view["done"][i] = done


def _worker_main(create_env, worker_index, lo, hi, num_batches, conn, doorbells,
                 discover=False):
    # A worker whose env runs the port's kernels loads them from the
    # fleet's shared build directory (no-op unless MOOLIB_COMPILE_CACHE).
    utils.init_compile_cache()
    task_queue, done_sems, seg = _attach_doorbells(doorbells, worker_index)
    runner = EnvRunner(
        create_env, worker_index, lo, hi, num_batches, conn, task_queue,
        done_sems, discover=discover,
    )
    try:
        runner.start()
    finally:
        if seg is not None:
            seg.close()


class EnvStepperFuture:
    """Future for one in-flight batch step (reference ``EnvStepperFuture``)."""

    def __init__(self, stepper: "EnvStepper", batch_index: int):
        self._stepper = stepper
        self._batch_index = batch_index
        self._done = False

    def result(self) -> Dict[str, np.ndarray]:
        """Wait for every worker, then return zero-copy shm views.

        Completion is judged from the shm progress ledger (each worker's
        per-batch step count reaching the pool's issued count) rather than
        by counting semaphore permits: the semaphore is just a wake-up
        hint, so a worker killed mid-step and respawned by the supervisor
        (``RestartPolicy``) completes this same future once its re-issued
        slice lands — no permit bookkeeping can go stale.  On timeout or a
        hard worker failure the in-flight slot is cleared and the
        semaphore drained before the error propagates, so the next
        ``step()`` on this batch (and teardown) cannot wedge on the
        leftovers of a failed one.
        """
        if self._done:
            return self._stepper._views[self._batch_index]
        s = self._stepper
        pool = s._pool
        b = self._batch_index
        t0 = time.monotonic()
        deadline = t0 + s._timeout
        sem = s._done_sems[b]
        try:
            while not pool._batch_complete(b):
                if sem.acquire(timeout=0.25):
                    continue
                # Slow path: surface env exceptions promptly with their real
                # traceback, and respawn/quarantine dead workers per the
                # restart policy (a respawn re-issues this batch's task, so
                # the loop then completes via the progress ledger).
                pool._check_workers()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"EnvPool step batch {b} timed out "
                        f"({s._timeout}s); an env worker may be wedged"
                    )
        except BaseException:
            pool._abort_batch(b)
            raise
        while sem.acquire(timeout=0):  # drop leftover wake-up hints
            pass
        _M_STEP_WAIT.observe(time.monotonic() - t0)
        _M_ENV_BATCHES.inc()
        _M_ENV_STEPS.inc(pool._batch_size)
        self._done = True
        s._inflight[b] = None
        return s._views[b]


class EnvStepper:
    """Scatters actions and wakes workers (reference ``EnvStepper::step``
    ``src/env.cc:273-349``)."""

    def __init__(self, pool: "EnvPool"):
        self._pool = pool
        self._num_workers = pool._num_processes
        self._timeout = 120.0
        self._views = pool._obs_views
        self._act_views = pool._act_views
        self._done_sems = pool._done_sems
        self._task_queues = pool._task_queues
        self._inflight: List[Optional[EnvStepperFuture]] = [None] * pool._num_batches
        # Per-batch pinned staging buffers for CUDA-tensor actions.
        self._pinned: List[Optional[torch.Tensor]] = [None] * pool._num_batches

    def _host_actions(self, batch_index: int, action) -> np.ndarray:
        """Device/async action seam (the JAX package's ``copy_to_host_async``):
        a CUDA tensor is copied non-blocking into a pinned buffer and one
        event is waited on, so only this copy is waited for, not all the
        work queued on the stream after it."""
        if not isinstance(action, torch.Tensor):
            return np.asarray(action)
        action = action.detach()
        if action.device.type != "cuda":
            return action.numpy()
        buf = self._pinned[batch_index]
        if buf is None or buf.shape != action.shape or buf.dtype != action.dtype:
            buf = torch.empty(action.shape, dtype=action.dtype, pin_memory=True)
            self._pinned[batch_index] = buf
        buf.copy_(action, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(action.device))
        done.synchronize()
        return buf.numpy()

    def step(self, batch_index: int, action) -> EnvStepperFuture:
        if self._inflight[batch_index] is not None:
            raise RuntimeError(
                f"batch {batch_index} already has a step in flight; call result() first"
            )
        act = self._host_actions(batch_index, action)
        av = self._act_views[batch_index]
        if act.shape != av.shape:
            act = act.reshape(av.shape)
        av[...] = act
        fut = EnvStepperFuture(self, batch_index)
        self._inflight[batch_index] = fut
        # Bump the issued-step count BEFORE ringing any doorbell: a worker's
        # progress cell must never be observed ahead of the target.
        self._pool._targets[batch_index] += 1
        for q in self._task_queues:
            q.put(batch_index)
        return fut


class EnvPool:
    """User-facing pool (reference ctor args: create_env, num_processes,
    batch_size, num_batches — ``src/moolib.cc:1614-1615``), plus
    ``restart_policy`` governing worker-death supervision
    (:class:`RestartPolicy`; pass ``RestartPolicy(enabled=False)`` for the
    fail-fast behavior)."""

    def __init__(
        self,
        create_env: Callable[[], Any],
        num_processes: int,
        batch_size: int,
        num_batches: int = 1,
        action_dtype=np.int64,
        action_shape: Tuple[int, ...] = (),
        restart_policy: Optional[RestartPolicy] = None,
    ):
        if num_processes < 1 or batch_size < 1 or num_batches < 1:
            raise ValueError("num_processes, batch_size, num_batches must be >= 1")
        num_processes = min(num_processes, batch_size)
        self._num_processes = num_processes
        self._batch_size = batch_size
        self._num_batches = num_batches
        self._restart_policy = (
            restart_policy if restart_policy is not None else RestartPolicy()
        )
        # Per-slot respawn timestamps for the quarantine window.
        self._restart_times: List[deque] = [deque() for _ in range(num_processes)]
        self._quarantined: set = set()  # slots past the policy: always raise
        # Issued batch-step counts; compared against the shm progress ledger.
        self._targets = [0] * num_batches
        # Set teardown state first: a ctor failure after shm allocation must
        # reach close() (named segments outlive the process if never
        # unlinked, unlike the anonymous mappings they replaced).
        self._closed = False
        self._segments = []
        self._doorbell_region = None
        self._task_queues: List = []
        self._procs: List = []
        self._worker_conns: List = []
        try:
            self._build(
                create_env, num_processes, batch_size, num_batches,
                action_dtype, action_shape,
            )
        except Exception:
            self.close()  # unlink any shm already allocated
            raise

    def _build(
        self, create_env, num_processes, batch_size, num_batches,
        action_dtype, action_shape,
    ):
        # Start-method contract (reference fork guard src/env.cc:149-169): a
        # plain fork() after CUDA has started its threads is a deadlock
        # lottery, so fork is only chosen while no CUDA context and no
        # process group (whose backends start threads too) exists.
        # Afterwards workers come from a forkserver — the server process is
        # launched via fork+exec (thread-safe) and its children are clean —
        # at the cost of create_env needing to be picklable.
        start = os.environ.get("MOOLIB_TPU_ENVPOOL_START")
        if start is None:
            start = "fork" if not _cuda_initialized() else "forkserver"
        if start == "forkserver":
            try:
                pickle.dumps(create_env)
            except Exception as e:
                raise RuntimeError(
                    "EnvPool after CUDA initialization uses the forkserver start "
                    "method (so does one built after a torch.distributed process "
                    f"group starts), which requires a picklable create_env ({e!r}). "
                    "Either construct the EnvPool before the first CUDA call "
                    "(preferred; the reference forks early for the same "
                    "reason), or pass a module-level function / functools."
                    "partial instead of a closure."
                ) from e
        ctx = mp.get_context(start)

        # The shm resource tracker must exist BEFORE the first worker forks,
        # so every worker inherits the parent's tracker.  A worker that has
        # to spawn its own (possible in the mp-doorbell fallback, where no
        # shm exists pre-fork) takes that private tracker down with it when
        # SIGKILLed — and the dying tracker unlinks every segment the worker
        # had attached, yanking live obs/act buffers out from under the
        # whole pool (observed as FileNotFoundError on respawn re-attach).
        try:
            from multiprocessing import resource_tracker

            resource_tracker.ensure_running()
        except Exception:  # noqa: BLE001 — platform without the tracker
            pass

        # 1. Spawn worker 0 first: it discovers the observation spec from its
        # own first env (which it keeps and steps) — the shm layout derives
        # from a real first observation, reference ``src/env.h:214-246``.
        self._task_queues, self._done_sems, self._doorbell_region, doorbell_desc = (
            _make_doorbells(ctx, num_processes, num_batches)
        )
        per = batch_size // num_processes
        extra = batch_size % num_processes
        bounds = []
        lo = 0
        for w in range(num_processes):
            hi = lo + per + (1 if w < extra else 0)
            bounds.append((lo, hi))
            lo = hi

        # Saved so a dead worker can be respawned later with identical
        # arguments and re-attached to the same shm/doorbell descriptors.
        self._ctx = ctx
        self._create_env = create_env
        self._bounds = bounds
        self._doorbell_desc = doorbell_desc
        self._layout = None

        p0, p0conn = self._spawn(0, discover=True)
        self._procs = [p0]
        self._worker_conns = [p0conn]
        if not p0conn.poll(60):
            raise RuntimeError("EnvPool: env spec discovery timed out")
        status, spec = p0conn.recv()
        if status != "ok":
            raise RuntimeError(f"EnvPool: create_env failed in worker 0: {spec}")
        for key in _FIELD_RESERVED:
            if key in spec:
                raise ValueError(f"observation key {key!r} is reserved")

        # 2. Allocate shared memory: per batch, [batch_size, *obs_shape] per
        # key + reward/done + actions.
        self._segments: List[shared_memory.SharedMemory] = []
        self._obs_views: List[Dict[str, np.ndarray]] = []
        self._act_views: List[np.ndarray] = []
        layout_obs, layout_act = [], []
        full_spec = dict(spec)
        full_spec["reward"] = ((), "<f4")
        full_spec["done"] = ((), "|b1")
        for b in range(num_batches):
            views, meta = {}, {}
            for key, (shape, dtype) in full_spec.items():
                arr_shape = (batch_size, *shape)
                nbytes = int(np.prod(arr_shape, dtype=np.int64)) * np.dtype(dtype).itemsize
                seg = shared_memory.SharedMemory(create=True, size=max(nbytes, 1))
                self._segments.append(seg)
                views[key] = np.ndarray(arr_shape, dtype=dtype, buffer=seg.buf)
                views[key].fill(0)
                meta[key] = (seg.name, arr_shape, dtype)
            self._obs_views.append(views)
            layout_obs.append(meta)
            act_shape = (batch_size, *action_shape)
            seg = shared_memory.SharedMemory(
                create=True, size=int(np.prod(act_shape, dtype=np.int64) or 1) * np.dtype(action_dtype).itemsize
            )
            self._segments.append(seg)
            av = np.ndarray(act_shape, dtype=action_dtype, buffer=seg.buf)
            av.fill(0)
            self._act_views.append(av)
            layout_act.append((seg.name, act_shape, np.dtype(action_dtype).str))

        # Completion ledger (see EnvRunner.run): one int64 cell per
        # (batch, worker), zero-initialized alongside the data segments.
        prog_shape = (num_batches, num_processes)
        seg = shared_memory.SharedMemory(
            create=True, size=int(np.prod(prog_shape, dtype=np.int64)) * 8
        )
        self._segments.append(seg)
        self._progress = np.ndarray(prog_shape, dtype=np.int64, buffer=seg.buf)
        self._progress.fill(0)
        layout_progress = (seg.name, prog_shape, "<i8")

        # 3. Ship the layout to worker 0 and spawn the rest with it.
        layout = {"obs": layout_obs, "act": layout_act, "progress": layout_progress}
        self._layout = layout
        p0conn.send(layout)
        for w in range(1, num_processes):
            p, pconn = self._spawn(w)
            pconn.send(layout)
            self._procs.append(p)
            self._worker_conns.append(pconn)
        self._stepper = EnvStepper(self)
        _M_WORKERS.inc(num_processes)

    def _spawn(self, w: int, discover: bool = False):
        """Start (or restart) worker ``w`` attached to the pool's doorbell
        descriptor; the caller sends ``self._layout`` over the returned pipe
        (except for the discovery worker, which gets it after spec probe)."""
        pconn, cconn = self._ctx.Pipe()
        p = self._ctx.Process(
            target=_worker_main,
            args=(
                self._create_env,
                w,
                self._bounds[w][0],
                self._bounds[w][1],
                self._num_batches,
                cconn,
                _worker_doorbell_desc(self._doorbell_desc, w),
                discover,
            ),
            daemon=True,
        )
        p.start()
        return p, pconn

    def _batch_complete(self, b: int) -> bool:
        """True once every worker's progress cell reached the issued count."""
        return bool((self._progress[b] >= self._targets[b]).all())

    def _abort_batch(self, b: int) -> None:
        """Failure-path cleanup: clear the in-flight future and drain the
        completion semaphore so a failed step can't wedge the next
        ``step()`` on this batch or teardown (stale permits / a stuck
        'already in flight' slot)."""
        st = getattr(self, "_stepper", None)
        if st is None:
            return
        st._inflight[b] = None
        try:
            while st._done_sems[b].acquire(timeout=0):
                pass
        except Exception:  # noqa: BLE001 — best-effort drain during teardown
            pass

    def _check_workers(self) -> None:
        """Service worker health: raise env exceptions with their real
        traceback, and supervise unexplained deaths — respawn + re-attach
        per ``RestartPolicy``, quarantining slots that keep dying."""
        for i in range(self._num_processes):
            p, conn = self._procs[i], self._worker_conns[i]
            try:
                while conn.poll():
                    msg = conn.recv()
                    if isinstance(msg, tuple) and msg and msg[0] == "step_error":
                        raise RuntimeError(
                            f"EnvPool worker {msg[1]} env exception:\n{msg[2]}"
                        )
            except (EOFError, OSError):
                pass
            if not p.is_alive():
                self._supervise_dead_worker(i)

    def _supervise_dead_worker(self, i: int) -> None:
        """Worker ``i`` died without an env traceback (SIGKILL, OOM, hard
        crash): respawn it onto the existing shm segments/doorbells and
        re-issue any in-flight batch steps it never completed, unless the
        restart policy says the slot is beyond saving.  The death-detected →
        respawned-and-reissued interval lands in the shared
        ``recovery_seconds{phase="worker_respawn"}`` histogram so worker and
        peer recovery read off one metric family (docs/RESILIENCE.md)."""
        t_detect = time.monotonic()
        p = self._procs[i]
        exitcode = p.exitcode
        policy = self._restart_policy
        if not policy.enabled or policy.max_restarts <= 0:
            raise RuntimeError(f"EnvPool worker {i} died (exit code {exitcode})")
        now = time.monotonic()
        window = self._restart_times[i]
        while window and now - window[0] > policy.window:
            window.popleft()
        if i in self._quarantined or len(window) >= policy.max_restarts:
            if i not in self._quarantined:
                self._quarantined.add(i)
                _M_QUARANTINED.inc()
            raise RuntimeError(
                f"EnvPool worker {i} quarantined: died {len(window) + 1} times "
                f"within {policy.window:.0f}s (last exit code {exitcode}); "
                "the env or host is unhealthy beyond respawn"
            )
        window.append(now)
        utils.log_error(
            "envpool: worker %d died (exit code %s); respawning (%d/%d in %.0fs window)",
            i, exitcode, len(window), policy.max_restarts, policy.window,
        )
        try:
            p.join(timeout=0)  # reap the zombie
        except Exception:  # noqa: BLE001
            pass
        try:
            self._worker_conns[i].close()
        except Exception:  # noqa: BLE001
            pass
        # Tasks the dead worker never popped are still queued; the respawn
        # below recomputes what to run from the progress ledger, so drain
        # them or re-issued batches would be stepped twice.
        try:
            self._task_queues[i].drain()
        except Exception:  # noqa: BLE001
            pass
        proc, conn = self._spawn(i)
        conn.send(self._layout)
        self._procs[i] = proc
        self._worker_conns[i] = conn
        _M_RESTARTS.inc()
        # Re-issue in-flight steps this worker hadn't finished: envs in its
        # slice are recreated lazily on the respawn's first step of each
        # batch, the slice is rewritten whole, and the pending
        # EnvStepperFuture completes through the progress ledger.
        st = getattr(self, "_stepper", None)
        if st is not None:
            for b in range(self._num_batches):
                if st._inflight[b] is not None and self._progress[b, i] < self._targets[b]:
                    self._task_queues[i].put(b)
        telemetry.observe_phase("worker_respawn", time.monotonic() - t_detect)

    def step(self, batch_index: int, action) -> EnvStepperFuture:
        if not 0 <= batch_index < self._num_batches:
            raise ValueError(f"batch_index {batch_index} out of range")
        return self._stepper.step(batch_index, action)

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def obs_spec(self) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
        """Per-env observation spec ``{key: (shape, dtype)}`` discovered from
        worker 0's first reset (reward/done included).  Callers sizing
        device-side rollout buffers read the env's native dtype here —
        uint8 frames must cross the host boundary as uint8."""
        return {
            k: (v.shape[1:], v.dtype) for k, v in self._obs_views[0].items()
        }

    @property
    def num_batches(self) -> int:
        return self._num_batches

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if getattr(self, "_stepper", None) is not None:
            # The gauge only counted fully-built pools (_build's last line).
            _M_WORKERS.dec(self._num_processes)
        for q in self._task_queues:
            try:
                q.put(_SHUTDOWN)
            except Exception:
                pass
        # Close the pipes first: a worker still blocked in its layout recv
        # (ctor failed between spec discovery and layout send) wakes with
        # EOFError and exits instead of eating the 5 s join timeout.
        for conn in self._worker_conns:
            try:
                conn.close()
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for seg in self._segments:
            try:
                seg.close()
                seg.unlink()
            except Exception:
                pass
        if self._doorbell_region is not None:
            try:
                self._doorbell_region.unlink()
            except Exception:
                pass

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
