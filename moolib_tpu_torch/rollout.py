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
act time into its dispatch and fetch halves.  ``AnakinRollout`` (envs on
the card) comes with slice 10.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

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
