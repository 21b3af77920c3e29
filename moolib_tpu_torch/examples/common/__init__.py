"""Shared example plumbing: the port of the JAX package's
``examples/common`` flag parsing, the cohort stats accumulator
(:class:`GlobalStatsAccumulator`, which allreduces stat deltas over the
port's ``Group`` with a callable op), the TSV logger, and the optax
optimizers the JAX examples write inline (``optax.rmsprop``,
``optax.adam``, ``optax.clip_by_global_norm``, ``optax.chain``) in optax
0.2.6's own arithmetic, and the per-actor-batch state of the training loops
(:class:`EnvBatchState`)."""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ...batcher import Batcher
from ...utils.config import Config
from ...utils.stats import RunningMeanStd, StatMean, StatSum  # noqa: F401


def finalize_flags(parser, argv=None):
    """Parse example-agent flags the hydra-ish way (reference agents use
    hydra; ``examples/vtrace/experiment.py:214-224``): argparse ``--flags``
    provide defaults and ``--help``; an optional ``--cfg config.yaml``
    overlays a file; trailing positional ``key=value`` overrides win.
    Returns a :class:`moolib_tpu_torch.utils.config.Config` (attribute
    access, interpolation, ``to_yaml``)."""
    import argparse as _argparse

    if not any(a.dest == "cfg" for a in parser._actions):  # idempotent
        parser.add_argument("--cfg", default=None, help="YAML config file overlay")
        parser.add_argument(
            "overrides", nargs="*", metavar="key=value", help="config overrides"
        )
    ns = parser.parse_args(argv)
    data = vars(ns)
    cfg_path = data.pop("cfg")
    kv_overrides = data.pop("overrides")
    # Priority: parser defaults < config file < explicit --flags < key=value.
    # argparse can't distinguish explicit values after one parse, so parse a
    # second time with every default suppressed to learn which flags the
    # user actually typed.
    saved = [(a, a.default) for a in parser._actions]
    try:
        for a, _ in saved:
            if a.dest != "help":
                a.default = _argparse.SUPPRESS
        explicit = vars(parser.parse_known_args(argv)[0])
    finally:
        for a, default in saved:
            a.default = default
    explicit.pop("cfg", None)
    explicit.pop("overrides", None)
    cfg = Config.load(cfg_path, defaults=data)
    for k, v in explicit.items():
        cfg[k] = v
    for ov in kv_overrides:
        cfg.apply_override(ov)
    return cfg


# ---------------------------------------------------------------- optimizers
#
class GlobalStatsAccumulator:
    """Allreduce stat *deltas* cohort-wide (reference
    ``examples/common/__init__.py:65-121``): each peer tracks the snapshot it
    last reduced, reduces the difference, and re-queues the delta if the
    reduction fails (e.g. on a membership change)."""

    def __init__(self, group, stats: Dict):
        self._group = group
        self._stats = stats
        self._last = {k: v.snapshot() for k, v in stats.items()}
        self._pending_delta: Optional[dict] = None
        self._inflight = None
        # Serializes reduce()/local_reset()/reset() (train thread) against
        # on_done (RPC callback thread): both sides mutate the delta
        # baseline, and an unserialized local_reset concurrent with a
        # result application would broadcast a negative-delta storm.
        self._mutex = threading.Lock()

    def reduce(self, stats: Dict) -> None:
        with self._mutex:
            if self._inflight is not None:
                return
            delta = {k: v.delta(self._last[k]) for k, v in stats.items()}
            if self._pending_delta is not None:
                for k, d in self._pending_delta.items():
                    delta[k] = _delta_add(delta[k], d)
            self._last = {k: v.snapshot() for k, v in stats.items()}
            self._pending_delta = None
            self._inflight = object()  # block re-entry before the callback binds

        def on_done(f, delta=delta):
            with self._mutex:
                try:
                    exc = f.exception()
                    if exc is not None:
                        # Failed (churn): re-queue our delta so nothing is lost.
                        self._pending_delta = (
                            delta
                            if self._pending_delta is None
                            else {k: _delta_add(self._pending_delta[k], d)
                                  for k, d in delta.items()}
                        )
                        return
                    total = f.result(0)
                    for k, v in self._stats.items():
                        # Apply everyone else's contribution (total minus
                        # ours) to the value AND the delta baseline: remote
                        # contributions we merely learned about are not OUR
                        # progress, and leaving them out of the baseline
                        # re-broadcasts them as our next delta — a
                        # (n-1)x-per-round amplification that inflated
                        # steps_done ~1000x in a soak (which then hit the
                        # agents' total_steps budget years early).
                        rem = _delta_sub(total[k], delta[k])
                        v.apply_delta(rem)
                        self._last[k].apply_delta(rem)
                finally:
                    # ALWAYS cleared, or one malformed cohort result would
                    # wedge reduce() (it early-returns while this is set).
                    self._inflight = None

        fut = self._group.all_reduce("__global_stats", delta, op=_delta_reduce_op)
        fut.add_done_callback(on_done)

    def reset(self) -> None:
        with self._mutex:
            for k, v in self._stats.items():
                v.reset()
            self._last = {k: v.snapshot() for k, v in self._stats.items()}

    def local_reset(self, *keys: str) -> None:
        """Reset chosen stats for local windowing without desyncing the delta
        protocol (re-snapshots them so the next reduce sends a zero delta)."""
        with self._mutex:
            for k in keys:
                self._stats[k].reset()
                self._last[k] = self._stats[k].snapshot()


def _delta_add(a, b):
    if isinstance(a, tuple):
        return tuple(x + y for x, y in zip(a, b))
    if isinstance(a, dict):
        # Union of keys: telemetry CohortCounters deltas are {series: incr}
        # maps whose keys appear over time (a new label set binds) and can
        # differ across peers; a missing series means "started at zero".
        return {k: a.get(k, 0.0) + b.get(k, 0.0) for k in set(a) | set(b)}
    return a + b


def _delta_sub(a, b):
    if isinstance(a, tuple):
        return tuple(x - y for x, y in zip(a, b))
    if isinstance(a, dict):
        return {k: a.get(k, 0.0) - b.get(k, 0.0) for k in set(a) | set(b)}
    return a - b


def _delta_reduce_op(a, b):
    return {k: _delta_add(a[k], b[k]) for k in a}


class EnvBatchState:
    """Per-actor-batch bookkeeping (reference
    ``examples/common/__init__.py:154-207``): previous action, carried LSTM
    state, time batcher assembling [T+1, B, ...] unrolls with the last step
    carried into the next unroll, and episode return/step accounting."""

    def __init__(self, batch_size: int, unroll_length: int, model):
        self.batch_size = batch_size
        self.unroll_length = unroll_length
        self.prev_action = torch.zeros((batch_size,), dtype=torch.int64, device=model.device)
        # Host mirror of prev_action for the host-batcher path: the realized
        # action of the previous step, so the unroll row never forces an
        # extra device round trip.
        self.prev_action_host = np.zeros((batch_size,), np.int64)
        self.core_state = model.initial_state(batch_size)
        self.initial_core_state = self.core_state
        self.time_batcher = Batcher(unroll_length + 1, device=None, dim=0)
        self.future = None
        # Device-rollout mode (moolib_tpu_torch.rollout.DeviceRollout):
        # assigned by the experiment when --device_rollout is on; owns the
        # [T+1, B] buffer on the card, carried core state, and the previous
        # action — the host fields above then serve only the stats below.
        self.rollout = None
        self.episode_return = np.zeros(batch_size, np.float64)
        self.episode_step = np.zeros(batch_size, np.int64)
        self.running_reward = np.zeros(batch_size, np.float64)
        self.step_count = 0

    def update(self, obs: Dict[str, np.ndarray], stats: Optional[Dict] = None) -> None:
        """Account rewards/episodes for a fresh observation batch."""
        reward = np.asarray(obs["reward"], np.float64)
        done = np.asarray(obs["done"], bool)
        self.episode_return += reward
        self.episode_step += 1
        self.step_count += self.batch_size
        if stats is not None:
            for i in np.nonzero(done)[0]:
                stats["mean_episode_return"] += float(self.episode_return[i])
                stats["mean_episode_step"] += float(self.episode_step[i])
                stats["episodes_done"] += 1
            stats["steps_done"] += self.batch_size
        self.episode_return[done] = 0.0
        self.episode_step[done] = 0


MESH_FLAGS_ENV = "MOOLIB_MESH_FLAGS"


def mesh_flags_from_env():
    """The flags of a mesh rank its host's rank 0 spawned (None when this
    process was not spawned so)."""
    import json

    spec = os.environ.get(MESH_FLAGS_ENV)
    return None if spec is None else Config(json.loads(spec))


def spawn_mesh_ranks(module: str, flags, world: int):
    """Start ranks 1..world-1 of this host (the caller is rank 0): each runs
    ``python -m module`` on the same flags (JSON in ``MOOLIB_MESH_FLAGS``)
    with the ``torchrun`` variables set.  Returns (coordinator address,
    child processes)."""
    import json
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    procs = []
    for r in range(1, world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), PYTHONPATH=root + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""), **{MESH_FLAGS_ENV: json.dumps(flags.to_dict())})
        procs.append(subprocess.Popen([sys.executable, "-m", module], env=env))
    return f"127.0.0.1:{port}", procs


def run_mesh_host(train, module: str, flags, on_stats, world: int):
    """Rank 0 of a self-spawned mesh host: spawn the other ranks, run
    ``train(flags, on_stats, (coordinator, world, 0))``, then join them
    (killed if rank 0 failed).  The process group ``train`` joined is torn
    down before returning, so the calling process can host another mesh."""
    import torch.distributed as dist

    coordinator, children = spawn_mesh_ranks(module, flags, world)
    try:
        out = train(flags, on_stats, (coordinator, world, 0))
    except BaseException:
        for c in children:
            c.kill()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for c in children:
        if c.wait(timeout=600) != 0:
            raise RuntimeError(f"{module}: a mesh rank exited with {c.returncode}")
    return out


class pumping:
    """Keep ``update()``-pumped objects (a Group's broker pings, a hosted
    Broker's evictions) running from a helper thread while the train loop
    blocks in a long mesh collective: a host whose pings stop for the
    broker's timeout is evicted, and its epoch's rounds die with it."""

    def __init__(self, pumps, interval: float = 0.25):
        self._pumps = [p for p in pumps if p is not None]
        self._interval = interval
        self._stop = threading.Event()
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            for p in self._pumps:
                p.update()

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, name="mesh-pump", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


class MeshControl:
    """Rank 0 of a mesh host tells its other ranks what comes next: one
    broadcast of ``(command, argument)`` over the ``dp`` group (or over the
    mesh axes ``axes``), on the backend's own device (gloo reduces host
    memory, NCCL the card's)."""

    def __init__(self, mesh, device, axes=("dp",)):
        import torch.distributed as dist

        from ...parallel.collectives import axes_group

        self._dist = dist
        self.group = axes_group(mesh, tuple(axes))[0]
        self.rank = dist.get_rank(self.group)
        self._root = dist.get_global_rank(self.group, 0)
        self._device = device if dist.get_backend(self.group) == "nccl" else torch.device("cpu")

    def send(self, cmd: int, arg: int = 0) -> None:
        t = torch.tensor([cmd, arg], dtype=torch.int64, device=self._device)
        self._dist.broadcast(t, self._root, group=self.group)

    def receive(self):
        t = torch.empty(2, dtype=torch.int64, device=self._device)
        self._dist.broadcast(t, self._root, group=self.group)
        return int(t[0]), int(t[1])

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self._dist.get_world_size(self.group)
        self._dist.all_gather_object(out, obj, group=self.group)
        return out


def copy_into(dst, src) -> None:
    """Copy a received tree (``Accumulator.state()``/``parameters()``) into
    live tensors of the same structure, in place: the optimizer and the
    model keep their tensors (and their devices); ``None`` and scalar leaves
    are skipped."""
    from ...utils import nest

    dl, dd = nest.tree_flatten(dst)
    sl, sd = nest.tree_flatten(src)
    if dd != sd:
        raise ValueError(f"copy_into: structures differ: {dd} vs {sd}")
    with torch.no_grad():
        for d, s in zip(dl, sl):
            if isinstance(d, torch.Tensor):
                d.copy_(torch.as_tensor(s))


def finish_together(group, pumped, seconds: float = 60.0) -> bool:
    """End a training run together with the rest of the cohort: one
    allreduce every member enters once it has applied its last step,
    pumped (``update()`` of each object in ``pumped``) until it completes
    or ``seconds`` pass.  Returns whether every member arrived; a member
    that died errors the round and ends the wait early."""
    fut = group.all_reduce("__train_done", 1)
    deadline = time.time() + seconds
    while not fut.done() and time.time() < deadline:
        for obj in pumped:
            obj.update()
        time.sleep(0.002)
    return fut.done() and fut.exception() is None


class TsvLogger:
    """Incremental TSV logging (reference ``examples/common/record.py``):
    writes a header once, appends rows, creates a ``latest`` symlink and a
    run ``metadata.json`` (argv, env, start time — reference ``:32-84``)."""

    def __init__(self, path: str, symlink: bool = True, metadata: Optional[dict] = None):
        self.path = path
        self._fields = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if symlink:
            link = os.path.join(os.path.dirname(path) or ".", "latest.tsv")
            try:
                if os.path.islink(link):
                    os.unlink(link)
                os.symlink(os.path.basename(path), link)
            except OSError:
                pass
        import json
        import sys

        meta = {
            "argv": sys.argv,
            "start_time": time.time(),
            "log": os.path.basename(path),
        }
        if metadata:
            meta.update(metadata)
        try:
            with open(os.path.join(os.path.dirname(path) or ".", "metadata.json"), "w") as f:
                json.dump(meta, f, indent=2, default=str)
        except OSError:
            pass

    def log(self, **fields) -> None:
        if self._fields is None:
            self._fields = list(fields)
            with open(self.path, "a") as f:
                f.write("\t".join(["time"] + self._fields) + "\n")
        row = [f"{time.time():.3f}"] + [str(fields.get(k, "")) for k in self._fields]
        with open(self.path, "a") as f:
            f.write("\t".join(row) + "\n")


# optax's gradient transformations over lists of tensors, with
# torch._foreach_* (a handful of launches an update, no host sync).  Each has
# ``init(params) -> state`` and ``update(updates, state) -> updates``, which
# may rewrite ``updates`` (the gradients, on entry) in place;
# :class:`OptaxOptimizer` chains them over a module's parameters.  torch.optim.RMSprop may not stand
# in for rmsprop: it adds eps outside the square root.


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the 2-norm of every element of every tensor
    (a 0-d tensor on their device)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class clip_by_global_norm:  # noqa: N801 - optax's name
    """optax ``clip_by_global_norm``: where the global norm g is at least
    ``max_norm``, every update becomes ``(u / g) * max_norm``; below it,
    updates pass unchanged.  Decided on the device.  ``update``'s ``norm``
    stands in for the norm of ``updates`` where they are a rank's blocks of
    a whole gradient (tensor parallelism)."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params):
        return None

    def update(self, updates: List[torch.Tensor], state,
               norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        g_norm = global_norm(updates) if norm is None else norm
        clip = g_norm >= self.max_norm
        one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
        torch._foreach_div_(updates, torch.where(clip, g_norm, one))
        torch._foreach_mul_(updates, torch.where(clip, self.max_norm, one))
        return updates


class rmsprop:  # noqa: N801 - optax's name
    """optax 0.2.6 ``rmsprop(learning_rate, decay, eps)``: ``nu = decay * nu
    + (1 - decay) * g**2`` from ``initial_scale`` 0, then ``-lr * g *
    rsqrt(nu + eps)``: eps inside the square root (``eps_in_sqrt=True``)."""

    def __init__(self, learning_rate: float, decay: float = 0.9, eps: float = 1e-8):
        self.lr, self.decay, self.eps = learning_rate, decay, eps

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, updates: List[torch.Tensor], nu) -> List[torch.Tensor]:
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, updates, updates, value=1 - self.decay)
        scaling = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scaling)
        torch._foreach_mul_(updates, scaling)
        torch._foreach_mul_(updates, -self.lr)
        return updates


class adam:  # noqa: N801 - optax's name
    """optax ``adam(learning_rate, b1, b2, eps)`` (``eps_root`` 0):
    bias-corrected moments, ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.  The
    step count is a host integer, so the bias corrections are scalars."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, updates: List[torch.Tensor], state) -> List[torch.Tensor]:
        mu, nu = state["mu"], state["nu"]
        state["count"] += 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, updates, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, updates, updates, value=1 - self.b2)
        out = torch._foreach_div(mu, 1 - self.b1 ** state["count"])
        denom = torch._foreach_div(nu, 1 - self.b2 ** state["count"])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(out, denom)
        torch._foreach_mul_(out, -self.lr)
        return out


class OptaxOptimizer:
    """``optax.chain(*transforms)`` over a module's parameters, in place:
    ``step()`` turns every parameter's ``.grad`` into its update through the
    chain and adds it to the parameter (``optax.apply_updates``)."""

    def __init__(self, params: Iterable[torch.Tensor], *transforms):
        self.params = list(params)
        self.transforms = transforms
        self.state = [t.init(self.params) for t in transforms]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, global_norm: Optional[torch.Tensor] = None) -> None:
        """``global_norm``: the norm ``clip_by_global_norm`` takes instead of
        the gradients' own (they are a rank's blocks of the whole)."""
        updates = [p.grad for p in self.params]
        if any(u is None for u in updates):
            raise RuntimeError("OptaxOptimizer.step: a parameter has no gradient")
        for transform, state in zip(self.transforms, self.state):
            if global_norm is not None and isinstance(transform, clip_by_global_norm):
                updates = transform.update(updates, state, global_norm)
            else:
                updates = transform.update(updates, state)
        torch._foreach_add_(self.params, updates)
