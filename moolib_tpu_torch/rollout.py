"""Device-resident actor rollout buffers: the port of the JAX package's
``rollout.py`` (``PendingAction``, ``DeviceRollout`` and the ``count_*``
host-boundary counters).

The host actor path moves every observation across the host/card boundary
three times in float32 (upload for the act step, download into the host
time-batcher, upload again with the learner batch).  This module keeps the
rollout on the card instead:

- one preallocated ``[T+1, B, ...]`` buffer of tensors lives on the card
  and the act step writes row ``t`` of it in place, after a T=1 forward
  under ``torch.no_grad()``;
- the observation crosses **once, in its own dtype** (uint8 frames stay
  uint8; the model normalizes on the card): each leaf is copied into a
  pinned staging buffer and from there with one non-blocking copy;
- the action is sampled by Gumbel-max from the rollout's own
  ``torch.Generator`` on the card (the port's ImpalaNet samples so; torch
  cannot reproduce ``jax.random``, so draws differ from the JAX package's
  while the logits agree);
- the action comes back through :class:`PendingAction`: a non-blocking copy
  into pinned memory and one CUDA event, waited on in :meth:`realize`, as
  late as the caller can;
- a completed unroll is handed over as a dict of tensors on the card (the
  Batcher's device path assembles learner batches from it without another
  crossing), and the next unroll gets a **fresh** buffer from torch's
  caching allocator whose row 0 is a copy of the completed one's row T.
  The JAX package seeds the next buffer with a non-donated carry for the
  same reason: the handed-over unroll is never written again, while the
  Batcher may still hold it.

Telemetry: ``actor_h2d_bytes_total`` / ``actor_d2h_bytes_total`` /
``actor_frames_total`` make the one-crossing contract a measured artifact;
``actor_act_dispatch_seconds`` vs ``actor_act_realize_seconds`` split the
act time into its dispatch and fetch halves.

:class:`AnakinRollout` goes one step further: when the env itself is a
batched tensor env on the card (``envs.jax_envs``), its step runs inside
the act step, auto-reset included, so observation, action and reward never
exist on the host and a rollout moves **zero host-boundary bytes per
frame** (``actor_h2d/d2h_bytes_total`` stay untouched).  Episode stats
accumulate on the card and leave only through :meth:`AnakinRollout.stats`,
counted on ``actor_stats_d2h_bytes_total``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import telemetry

_REG = telemetry.get_registry()
# Host-boundary accounting: every byte the actor path moves between host and
# device, by direction.  The host path increments these too (count_h2d /
# count_d2h at its conversion sites), so both modes read on one family.
_M_H2D = _REG.counter(
    "actor_h2d_bytes_total", "actor-path bytes uploaded host -> device"
)
_M_D2H = _REG.counter(
    "actor_d2h_bytes_total", "actor-path bytes fetched device -> host"
)
_M_FRAMES = _REG.counter(
    "actor_frames_total", "env frames through the actor path (for bytes/frame)"
)
_M_DISPATCH = _REG.histogram(
    "actor_act_dispatch_seconds", "act step dispatch (enqueue, not compute)"
)
_M_REALIZE = _REG.histogram(
    "actor_act_realize_seconds", "pending action realize (D2H completion wait)"
)
_M_DEPTH = _REG.gauge(
    "actor_act_dispatch_depth", "act steps dispatched but not yet realized"
)
_M_UNROLLS = _REG.counter("actor_unrolls_total", "completed [T+1, B] unrolls")
_M_STATS_D2H = _REG.counter(
    "actor_stats_d2h_bytes_total",
    "device-side episode aggregates fetched by AnakinRollout.stats() (the "
    "zero-crossing plane's only D2H)",
)


def count_h2d(nbytes: int) -> None:
    """Record an actor-path host->device crossing (host path call sites)."""
    _M_H2D.inc(nbytes)


def count_d2h(nbytes: int) -> None:
    """Record an actor-path device->host crossing (host path call sites)."""
    _M_D2H.inc(nbytes)


def count_frames(n: int) -> None:
    _M_FRAMES.inc(n)


class PendingAction:
    """A dispatched-but-not-realized action batch.

    A CUDA action is copied non-blocking into pinned memory at construction
    and one event is recorded after the copy; :meth:`realize` waits on that
    event only (ideally already passed — the copy overlapped the host work
    since dispatch) and returns host numpy.  A CPU action is already host
    memory.  Realizing explicitly keeps the fetch wait visible to the
    ``act_fetch`` timer/watchdog section instead of inside the env seam.
    """

    __slots__ = ("_dev", "_pinned", "_event", "_host")

    def __init__(self, action_dev: torch.Tensor):
        self._dev = action_dev
        self._host: Optional[np.ndarray] = None
        self._event = None
        if action_dev.device.type == "cpu":
            self._pinned = action_dev
        else:
            self._pinned = torch.empty(action_dev.shape, dtype=action_dev.dtype,
                                       pin_memory=True)
            self._pinned.copy_(action_dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(action_dev.device))
        _M_DEPTH.inc()

    def realize(self) -> np.ndarray:
        if self._host is None:
            t0 = time.monotonic()
            # host_span marks this D2H wait as host-blocked for any open
            # timeline capture window (telemetry.timeline).
            with telemetry.span("rollout.act_fetch"), \
                    telemetry.timeline.host_span("rollout.act_fetch"):
                if self._event is not None:
                    self._event.synchronize()
                self._host = self._pinned.numpy()
            _M_REALIZE.observe(time.monotonic() - t0)
            _M_D2H.inc(self._host.nbytes)
            _M_DEPTH.dec()
        return self._host

    def __array__(self, dtype=None, copy=None):
        out = self.realize()
        return out if dtype is None else out.astype(dtype, copy=False)

    @property
    def device_array(self) -> torch.Tensor:
        return self._dev


class DeviceRollout:
    """Per-actor-batch rollout state on the card.

    Drop-in replacement for the host-batcher bookkeeping in
    ``examples.common.EnvBatchState``: owns the ``[T+1, B, ...]`` buffer,
    the carried LSTM core, the previous action on the card, the sampling
    generator and the unroll boundary logic (carry the last step into the
    next buffer, track the initial core state entering each unroll).

    Usage per act step::

        pending = roll.step(obs)                     # obs: EnvPool views
        ...                                          # overlap host work here
        env.step(batch, pending.realize())
        unroll = roll.take_unroll()                  # tensors or None
        if unroll is not None:
            learn_batcher.cat(unroll)                # assembled on the card
            core_batcher.cat(roll.completed_initial_core)
    """

    def __init__(self, model, batch_size: int, unroll_length: int,
                 obs_shape: Tuple[int, ...], obs_dtype, num_actions: int,
                 seed: int = 0):
        self.model = model
        self.device = model.device
        self.batch_size = batch_size
        self.unroll_length = unroll_length
        self.num_actions = int(num_actions)
        self._obs_shape = tuple(obs_shape)
        self._obs_dtype = np.dtype(obs_dtype)
        if self._obs_dtype == np.float64:
            # Stage f64 env vectors as f32 on the host (the cast the host
            # path makes) instead of uploading twice the bytes.
            self._obs_dtype = np.dtype(np.float32)
        B = batch_size
        pin = self.device.type == "cuda"
        self._staging = {
            "state": torch.empty((B, *self._obs_shape), pin_memory=pin,
                                 dtype=torch.from_numpy(np.empty(0, self._obs_dtype)).dtype),
            "reward": torch.empty((B,), dtype=torch.float32, pin_memory=pin),
            "done": torch.empty((B,), dtype=torch.bool, pin_memory=pin),
        }
        self._upload_event = None
        self._buf = self._new_buffer()
        self._t = 0
        self.core_state = model.initial_state(B)
        self.prev_action = torch.zeros((B,), dtype=torch.int64, device=self.device)
        # Initial LSTM state entering the unroll currently being filled.
        self._initial_core = self.core_state
        self._completed: Optional[Dict[str, torch.Tensor]] = None
        self.completed_initial_core = None
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def _new_buffer(self) -> Dict[str, torch.Tensor]:
        T1, B, dev = self.unroll_length + 1, self.batch_size, self.device
        return {
            "state": torch.empty((T1, B, *self._obs_shape), device=dev,
                                 dtype=self._staging["state"].dtype),
            "reward": torch.empty((T1, B), dtype=torch.float32, device=dev),
            "done": torch.empty((T1, B), dtype=torch.bool, device=dev),
            "prev_action": torch.empty((T1, B), dtype=torch.int64, device=dev),
            "action": torch.empty((T1, B), dtype=torch.int64, device=dev),
            "policy_logits": torch.empty((T1, B, self.num_actions),
                                         dtype=torch.float32, device=dev),
        }

    @torch.no_grad()
    def step(self, obs: Dict[str, np.ndarray]) -> PendingAction:
        """Upload one env observation batch (one crossing, its own dtype),
        run the T=1 act forward, write row ``t`` of the buffer in place and
        return the :class:`PendingAction` (its D2H already issued)."""
        t0 = time.monotonic()
        state = np.asarray(obs["state"])
        if state.dtype != self._obs_dtype:
            state = state.astype(self._obs_dtype)
        reward = np.asarray(obs["reward"], np.float32)
        done = np.asarray(obs["done"], bool)
        if self._upload_event is not None:
            # The previous step's copies out of the staging buffers must have
            # run before the host overwrites them.
            self._upload_event.synchronize()
        t, buf = self._t, self._buf
        for key, host in (("state", state), ("reward", reward), ("done", done)):
            stage = self._staging[key]
            stage.numpy()[...] = host
            buf[key][t].copy_(stage, non_blocking=True)
        if self.device.type == "cuda":
            self._upload_event = torch.cuda.Event()
            self._upload_event.record(torch.cuda.current_stream(self.device))
        _M_H2D.inc(state.nbytes + reward.nbytes + done.nbytes)
        _M_FRAMES.inc(self.batch_size)
        inputs = {
            "state": buf["state"][t:t + 1],
            "reward": buf["reward"][t:t + 1],
            "done": buf["done"][t:t + 1],
            "prev_action": self.prev_action[None],
        }
        core_before = self.core_state
        out, self.core_state = self.model(inputs, self.core_state,
                                          sample_generator=self._generator)
        action = out["action"][0]
        buf["prev_action"][t].copy_(self.prev_action)
        buf["action"][t].copy_(action)
        buf["policy_logits"][t].copy_(out["policy_logits"][0])
        self.prev_action = action
        if t == self.unroll_length:
            # Row T written: the unroll is complete.  Hand it over and start
            # a fresh buffer whose row 0 is a copy of this row T.
            self._completed = buf
            self.completed_initial_core = self._initial_core
            self._initial_core = core_before
            self._buf = self._new_buffer()
            for key, v in buf.items():
                self._buf[key][0].copy_(v[t])
            self._t = 1
            _M_UNROLLS.inc()
        else:
            self._t += 1
        _M_DISPATCH.observe(time.monotonic() - t0)
        return PendingAction(action)

    def take_unroll(self) -> Optional[Dict[str, torch.Tensor]]:
        """The completed ``[T+1, B, ...]`` unroll on the card, or None.
        Reading clears it; ``completed_initial_core`` stays valid until the
        next unroll completes."""
        out, self._completed = self._completed, None
        return out


# --------------------------------------------------------------------------
# Anakin: the env inside the act step (zero host-boundary bytes per frame)
# --------------------------------------------------------------------------

# Backpressure for AnakinRollout's whole-unroll mode: unroll() only
# enqueues, so a host loop with nothing else to wait on would race
# arbitrarily far ahead of the card.  At most this many unrolls are enqueued
# but unfinished (2: one computing, one queued); the caller waits on the
# oldest one's event before passing it.
_MAX_INFLIGHT = 2


def _build_anakin_fns(env, unroll_length: int):
    """The rollout's functions over one env configuration (the JAX
    package's ``_build_anakin_jits``).  Eager torch compiles nothing, so
    these are plain functions of the model and the carry; each body step
    issues its kernels one by one (a CUDA graph of the unroll is the
    counterpart of ``lax.scan``'s one dispatch)."""
    T = unroll_length

    def _body(model, carry, generator):
        """One fused timestep: act on the carried observation (f32, as the
        host path stages it), sample by Gumbel-max from the rollout's
        generator, then step the batched env on its device, auto-reset
        included, and fold the episode stats on the device."""
        obs = carry["obs"]
        inputs = {
            "state": obs.to(torch.float32)[None],
            "reward": carry["reward"][None],
            "done": carry["done"][None],
            "prev_action": carry["prev_action"][None],
        }
        out, new_core = model(inputs, carry["core"], sample_generator=generator)
        action = out["action"][0]
        row = {
            "state": obs,
            "reward": carry["reward"],
            "done": carry["done"],
            "prev_action": carry["prev_action"],
            "action": action,
            "policy_logits": out["policy_logits"][0],
        }
        env_state, ts = env.step(carry["env"], action)
        # Episode accounting on the device: aggregates leave only through
        # the explicit stats() snapshot, never per frame.
        st, d = carry["stats"], ts["done"]
        ep_return = st["ep_return"] + ts["reward"]
        ep_len = st["ep_len"] + 1
        stats = {
            "ep_return": torch.where(d, 0.0, ep_return),
            "ep_len": torch.where(d, 0, ep_len),
            "return_sum": st["return_sum"] + torch.where(d, ep_return, 0.0).sum(),
            "len_sum": st["len_sum"] + torch.where(d, ep_len, 0).sum(),
            "episodes": st["episodes"] + d.sum(),
        }
        new_carry = {
            "env": env_state,
            "obs": ts["state"],
            "reward": ts["reward"],
            "done": ts["done"],
            "prev_action": action,
            "core": new_core,
            "stats": stats,
        }
        return new_carry, row

    def _step(model, buf, t, carry, generator):
        carry, row = _body(model, carry, generator)
        for k, v in row.items():
            buf[k][t].copy_(v)
        return carry

    def _scan(model, carry, length, generator):
        rows = []
        for _ in range(length):
            carry, row = _body(model, carry, generator)
            rows.append(row)
        return carry, rows

    def _finish(model, carry, rows_head, generator):
        """Shared tail of both unroll entry points: the last body step, so
        the core state entering row T (row 0 of the next unroll) is
        ``completed_initial_core`` for the learner."""
        core_into_last = carry["core"]
        carry, last = _body(model, carry, generator)
        rows = rows_head + [last]
        buf = {k: torch.stack([r[k] for r in rows]) for k in last}
        return buf, last, carry, core_into_last

    def _unroll_first(model, carry, generator):
        # Bootstrap: rows 0..T-1 from the loop, row T from the tail step.
        carry, rows = _scan(model, carry, T, generator)
        return _finish(model, carry, rows, generator)

    def _unroll_next(model, last_row, carry, generator):
        # Steady state: row 0 is the carried last row of the previous
        # unroll, rows 1..T-1 from the loop, row T from the tail step.
        carry, rows = _scan(model, carry, T - 1, generator)
        return _finish(model, carry, [last_row] + rows, generator)

    return _step, _unroll_first, _unroll_next


def _unroll_fields(env) -> Dict[str, tuple]:
    """Each leaf of an Anakin unroll: its per-env ``(shape, dtype)``."""
    obs_shape, obs_dtype = env.obs_spec
    obs_dtype = torch.from_numpy(np.empty(0, np.dtype(obs_dtype))).dtype
    return {
        "state": ((*obs_shape,), obs_dtype),
        "reward": ((), torch.float32),
        "done": ((), torch.bool),
        "prev_action": ((), torch.int64),
        "action": ((), torch.int64),
        "policy_logits": ((env.num_actions,), torch.float32),
    }


def anakin_column_specs(env, model, unroll_length: int) -> tuple:
    """One env column of an :class:`AnakinRollout` unroll and of its
    initial core state: ``((unroll specs, unroll treedef), (core specs,
    core treedef))``, each spec ``(shape, dtype)`` in ``nest.tree_flatten``
    order, an unroll leaf's shape ``(T+1, ...)`` without its env axis.
    What the learner ranks of a Sebulba split name to receive their
    columns (``parallel.collectives.UnrollHandoff``)."""
    from .utils import nest

    fields = {k: ((unroll_length + 1, *shape), dtype)
              for k, (shape, dtype) in _unroll_fields(env).items()}
    keys, u_def = nest.tree_flatten({k: k for k in fields})
    core, c_def = nest.tree_flatten(model.initial_state(1))
    return (([fields[k] for k in keys], u_def),
            ([(tuple(x.shape[1:]), x.dtype) for x in core], c_def))


class AnakinRollout:
    """Fully on-device rollout: the batched env and the model on one
    device, zero crossings per frame.

    Two modes over the same body (``tests/test_torch_jax_envs.py`` holds
    them bitwise equal):

    - **per-step** (:meth:`step`): the fused env+act step writes row ``t``
      of the ``[T+1, B]`` buffer in place; ``DeviceRollout``'s bookkeeping
      (row ``T`` becomes row 0 of a fresh buffer), with the env inside;
    - **whole unroll** (:meth:`unroll`): ``T+1`` body steps to bootstrap,
      then ``T`` (row 0 carried over from row ``T``), stacked into a
      fresh ``[T+1, B]`` dict.  The host enqueues the steps without ever
      waiting on the card.

    Neither mode touches ``actor_h2d/d2h_bytes_total``.  Episode stats
    accumulate on the device and leave only through :meth:`stats`
    (``actor_stats_d2h_bytes_total``).  ``env_key`` is the raw key ``[2]``
    of the env batch (env ``i`` seeded with ``fold_in(env_key, i)``);
    ``act_seed`` seeds the rollout's sampling generator on the model's
    device.  One instance is one mode: mixing :meth:`step` and
    :meth:`unroll` raises.

    ``mesh=`` (the Sebulba actor mesh, ``parallel.split_mesh``): each rank
    of its ``dp`` axis runs its block of the ``batch_size`` envs, ``[r·b,
    (r+1)·b)`` with ``b = batch_size / dp``, seeded with those global
    indices, so the union over the ranks is the unsharded batch;
    ``batch_size`` stays the global count (``local_batch_size`` is the
    rank's), ``frames_done`` counts the mesh's frames, as in JAX, and
    :meth:`stats` gathers every rank's (each rank calls it at the same
    point).  Rank r samples its actions from ``act_seed + r``: torch's
    generator cannot split one stream over ranks as ``jax.random`` does.
    """

    def __init__(self, model, env, batch_size: int, unroll_length: int, *,
                 env_key: torch.Tensor, act_seed: int, mesh=None):
        from .envs import jax_envs

        self.model = model
        self.device = model.device
        self.batch_size = batch_size
        self.unroll_length = unroll_length
        self.env = env
        self.frames_done = 0
        self._mesh = mesh
        dp, rank = 1, 0
        if mesh is not None:
            from .parallel.mesh import axis_sizes

            dp = axis_sizes(mesh).get("dp", 1)
            if batch_size % dp:
                raise ValueError(f"actor-mesh dp={dp} must divide batch_size={batch_size}")
            rank = mesh.get_local_rank("dp") if "dp" in axis_sizes(mesh) else 0
        self.local_batch_size = batch_size // dp
        self._inflight: list = []
        self._step_fn, self._unroll_first_fn, self._unroll_next_fn = \
            _build_anakin_fns(env, unroll_length)
        self._generator = torch.Generator(device=self.device).manual_seed(int(act_seed) + rank)

        B, dev = self.local_batch_size, self.device
        env_state = jax_envs.batch_init(env, env_key.to(dev), B, start=rank * B)
        self._carry = {
            "env": env_state,
            "obs": jax_envs.batch_observe(env, env_state),
            # First reset: reward 0, done False (EnvPool's first-obs
            # convention, so backends line up from step 0).
            "reward": torch.zeros((B,), dtype=torch.float32, device=dev),
            "done": torch.zeros((B,), dtype=torch.bool, device=dev),
            "prev_action": torch.zeros((B,), dtype=torch.int64, device=dev),
            "core": model.initial_state(B),
            "stats": {
                "ep_return": torch.zeros((B,), dtype=torch.float32, device=dev),
                "ep_len": torch.zeros((B,), dtype=torch.int64, device=dev),
                "return_sum": torch.zeros((), dtype=torch.float32, device=dev),
                "len_sum": torch.zeros((), dtype=torch.int64, device=dev),
                "episodes": torch.zeros((), dtype=torch.int64, device=dev),
            },
        }
        self._shapes = _unroll_fields(env)
        self._buf = self._new_buffer()
        # Pinned landing zone of stats(): [ep_return, ep_len, return_sum,
        # len_sum, episodes] packed as float64 (exact for these counts).
        self._stats_host = torch.empty((2 * B + 3,), dtype=torch.float64,
                                       pin_memory=dev.type == "cuda")
        self._t = 0
        self._mode: Optional[str] = None
        self._last_row: Optional[Dict[str, torch.Tensor]] = None
        self._initial_core = self._carry["core"]
        self._completed: Optional[Dict[str, torch.Tensor]] = None
        self.completed_initial_core = None

    def _new_buffer(self) -> Dict[str, torch.Tensor]:
        T1, B = self.unroll_length + 1, self.local_batch_size
        return {k: torch.empty((T1, B, *shape), dtype=dtype, device=self.device)
                for k, (shape, dtype) in self._shapes.items()}

    def _claim_mode(self, mode: str) -> None:
        if self._mode is None:
            self._mode = mode
        elif self._mode != mode:
            raise RuntimeError(
                f"AnakinRollout is in {self._mode!r} mode; one instance is "
                "one mode (per-step and whole-unroll bookkeeping share the "
                "env state)"
            )

    @torch.no_grad()
    def step(self) -> None:
        """One fused env+act step into the buffer.  Nothing to upload and
        no action to fetch: the env that consumes the action is on the same
        device, in the same stream."""
        self._claim_mode("step")
        t0 = time.monotonic()
        core_before = self._carry["core"]
        self._carry = self._step_fn(self.model, self._buf, self._t, self._carry,
                                    self._generator)
        _M_FRAMES.inc(self.local_batch_size)
        self.frames_done += self.batch_size
        if self._t == self.unroll_length:
            # Row T written: hand the unroll over and start a fresh buffer
            # whose row 0 is a copy of this row T.
            self._completed = self._buf
            self.completed_initial_core = self._initial_core
            self._initial_core = core_before
            self._buf = self._new_buffer()
            for k, v in self._completed.items():
                self._buf[k][0].copy_(v[self.unroll_length])
            self._t = 1
            _M_UNROLLS.inc()
        else:
            self._t += 1
        _M_DISPATCH.observe(time.monotonic() - t0)

    def take_unroll(self) -> Optional[Dict[str, torch.Tensor]]:
        """Per-step mode hand-over: the completed unroll, or None."""
        out, self._completed = self._completed, None
        return out

    @torch.no_grad()
    def unroll(self) -> Dict[str, torch.Tensor]:
        """One completed ``[T+1, B]`` unroll on the device.  Sets
        ``completed_initial_core`` to the core state entering its row 0, as
        the per-step mode does."""
        self._claim_mode("unroll")
        t0 = time.monotonic()
        if self._last_row is None:
            buf, self._last_row, self._carry, next_initial = self._unroll_first_fn(
                self.model, self._carry, self._generator)
            steps = self.unroll_length + 1
        else:
            buf, self._last_row, self._carry, next_initial = self._unroll_next_fn(
                self.model, self._last_row, self._carry, self._generator)
            steps = self.unroll_length
        self.completed_initial_core = self._initial_core
        self._initial_core = next_initial
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._inflight.append(event)
            while len(self._inflight) > _MAX_INFLIGHT:
                # mtlint: allow-host-sync(backpressure: wait for the oldest enqueued unroll so the host stays within _MAX_INFLIGHT unrolls of the card)
                self._inflight.pop(0).synchronize()
        _M_FRAMES.inc(self.local_batch_size * steps)
        self.frames_done += self.batch_size * steps
        _M_UNROLLS.inc()
        _M_DISPATCH.observe(time.monotonic() - t0)
        return buf

    @torch.no_grad()
    def stats(self) -> Dict[str, Any]:
        """Snapshot the device-side episode aggregates (cumulative): the
        plane's only D2H, one pinned copy counted on its own counter so the
        per-frame boundary reads a measured zero.  With ``mesh=``, every
        rank's snapshot, gathered over the actor mesh: the sums are the
        mesh's and the per-env arrays cover all ``batch_size`` envs in
        global order."""
        st, B = self._carry["stats"], self.local_batch_size
        packed = torch.cat([st["ep_return"].double(), st["ep_len"].double(),
                            torch.stack([st["return_sum"].double(), st["len_sum"].double(),
                                         st["episodes"].double()])])
        self._stats_host.copy_(packed, non_blocking=True)
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(self.device))
            # mtlint: allow-host-sync(the documented sole D2H of the Anakin plane, counted on actor_stats_d2h_bytes_total)
            copied.synchronize()
        _M_STATS_D2H.inc(self._stats_host.nbytes)
        host = self._stats_host.numpy()[None]  # mtlint: allow-host-sync(a view of the pinned snapshot the copy above already landed)
        if self._mesh is not None:
            import torch.distributed as dist

            from .parallel.collectives import all_gather_axis

            # gloo gathers the host snapshot; NCCL the card's, then one copy.
            on_host = dist.get_backend(self._mesh.get_group("dp")) == "gloo"
            rows = all_gather_axis(self._stats_host if on_host else packed, "dp", self._mesh)
            host = rows.reshape(-1, 2 * B + 3).cpu().numpy()  # mtlint: allow-host-sync(the gathered snapshot, the mesh form of the one D2H above)
        sums = host[:, 2 * B:].sum(axis=0)  # mtlint: allow-host-sync(numpy: the snapshot is on the host)
        return {
            "episodes": int(sums[2]),
            "return_sum": float(sums[0]),
            "len_sum": int(sums[1]),
            "ep_return": host[:, :B].reshape(-1).astype(np.float32),
            "ep_len": host[:, B:2 * B].reshape(-1).astype(np.int64),
        }
