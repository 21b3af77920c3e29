"""On-device environments (the Podracer "Anakin" env family): the
torch-batched twins of the JAX package's ``envs/jax_envs.py``.

The JAX package writes these envs as pure ``jnp`` functions of one env's
state and batches them with ``vmap``; :class:`~moolib_tpu_torch.rollout.AnakinRollout`
fuses their step into the act step, so observation, action and reward never
exist on the host.  Here the state is a dict of ``[B]`` tensors on the
card (or the CPU), and every method acts on the whole batch with tensor ops:
no Python branch on a tensor, no ``.item()``, no host sync.  The names and
the ``--env_backend jax`` flag keep the JAX package's (its CLI contract).

Protocol (:class:`JaxEnv`):

- ``init(keys) -> state``: the state of ``B`` envs from their keys
  ``[B, 2]``.  The state holds each env's key and episode counter, so the
  family is **counter-based**: episode ``e`` of the env seeded with ``key``
  derives its content from ``fold_in(key, e)``, however the episodes are
  reached (per-step loop, whole unroll, or the host env of
  :func:`host_catch`).
- ``observe(state) -> obs``: ``[B, rows·cols]`` uint8 frames.
- ``step(state, action) -> (state, timestep)``: one step with **auto-reset
  on the device**: at the end of an episode the timestep carries the
  terminal reward, ``done=True`` and the *reset* observation of the next
  episode, EnvPool's worker-loop semantics.  The next episode's fields are
  computed for every env and selected with ``torch.where``.
- ``obs_spec -> (shape, dtype)`` (numpy dtype, as the host envs give it)
  and ``num_actions``.

The timestep is ``{"state", "reward", "done"}``, the keys of an EnvPool
observation batch.  Keys are raw ``[..., 2]`` words in int64, and
``fold_in``/``split``/``randint`` are :mod:`._threefry`'s torch versions of
``jax.random``'s, bit for bit, so a port env and a JAX env seeded with the
same key produce the same trajectories.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from . import _threefry

State = Dict[str, torch.Tensor]
TimeStep = Dict[str, torch.Tensor]  # {"state": obs, "reward": f32, "done": bool}


@runtime_checkable
class JaxEnv(Protocol):
    """Structural protocol for batched on-device envs (see module docstring)."""

    num_actions: int

    @property
    def obs_spec(self) -> Tuple[Tuple[int, ...], Any]:
        ...

    def init(self, keys) -> State:
        ...

    def observe(self, state) -> torch.Tensor:
        ...

    def step(self, state, action) -> Tuple[State, TimeStep]:
        ...


def _episode_key(key, episode):
    """The shared seeding contract: everything procedural about episode
    ``e`` of an env seeded with ``key`` derives from this fold."""
    return _threefry.fold_in(key, episode)


class JaxCatch:
    """Catch with the board flattened to a 1-D uint8 vector, batched on the
    device: a ball falls from the top of a rows×columns board, the paddle on
    the bottom row moves left/stay/right, +1 for a catch, −1 for a miss.
    Catch's only entropy is the drop column of each episode."""

    num_actions = 3

    def __init__(self, rows: int = 10, columns: int = 5):
        self.rows = rows
        self.columns = columns

    @property
    def obs_spec(self) -> Tuple[Tuple[int, ...], Any]:
        return ((self.rows * self.columns,), np.uint8)

    def _episode_fields(self, key, episode) -> State:
        col = _threefry.randint(_episode_key(key, episode), 0, self.columns)
        return {
            "ball_row": torch.zeros_like(col),
            "ball_col": col,
            "paddle": torch.full_like(col, self.columns // 2),
        }

    def init(self, keys) -> State:
        episode = torch.zeros(keys.shape[:-1], dtype=torch.int64, device=keys.device)
        return {"key": keys, "episode": episode, **self._episode_fields(keys, episode)}

    def _board(self, state) -> torch.Tensor:
        return torch.zeros((state["ball_row"].shape[0], self.rows * self.columns),
                           dtype=torch.uint8, device=state["ball_row"].device)

    def _paint(self, board, state) -> torch.Tensor:
        # Ball pixel then paddle pixel, the host env's write order (the same
        # even where they overlap on the bottom row: both 255).
        ball = (state["ball_row"] * self.columns + state["ball_col"])[:, None]
        board.scatter_(1, ball, 255)
        paddle = ((self.rows - 1) * self.columns + state["paddle"])[:, None]
        return board.scatter_(1, paddle, 255)

    def observe(self, state) -> torch.Tensor:
        return self._paint(self._board(state), state)

    def _reward(self, done, ball_col, paddle) -> torch.Tensor:
        hit = torch.where(ball_col == paddle, 1.0, -1.0)
        return torch.where(done, hit, 0.0).to(torch.float32)

    def _advance(self, state, moved: State, done) -> Tuple[State, torch.Tensor]:
        """Auto-reset on the device: the post-done state is the next
        episode's (its fields drawn for every env, selected by ``done``)."""
        next_episode = state["episode"] + done.to(torch.int64)
        fresh = self._episode_fields(state["key"], next_episode)
        new_state = {"key": state["key"], "episode": next_episode,
                     **{k: torch.where(done, fresh[k], moved[k]) for k in fresh}}
        return new_state, self.observe(new_state)

    def step(self, state, action) -> Tuple[State, TimeStep]:
        action = action.to(torch.int64)
        paddle = torch.clamp(state["paddle"] + (action - 1), 0, self.columns - 1)
        ball_row = state["ball_row"] + 1
        done = ball_row == self.rows - 1
        reward = self._reward(done, state["ball_col"], paddle)
        moved = {"ball_row": ball_row, "ball_col": state["ball_col"], "paddle": paddle}
        new_state, obs = self._advance(state, moved, done)
        return new_state, {"state": obs, "reward": reward, "done": done}


class JaxProcCatch(JaxCatch):
    """Procedurally generated Catch: every episode draws, from the same
    counter-based contract, a drop column, a horizontal ball drift in
    ``[-max_drift, max_drift]`` applied every step (the ball bounces off
    the walls), and a distractor pixel column with no reward signal."""

    def __init__(self, rows: int = 10, columns: int = 5, max_drift: int = 1,
                 distractor: bool = True):
        super().__init__(rows, columns)
        self.max_drift = max_drift
        self.distractor = distractor

    def _episode_fields(self, key, episode) -> State:
        # split(ek, 3) -> (column, drift, distractor) keys; one threefry pass
        # draws the two words of all three randints.
        keys = _threefry.split(_episode_key(key, episode), 3)
        bits = _threefry.random_bits(_threefry.split(keys, 2))  # [B, 3, 2]
        col = _threefry.randint_from_bits(bits[:, 0], 0, self.columns)
        return {
            "ball_row": torch.zeros_like(col),
            "ball_col": col,
            "paddle": torch.full_like(col, self.columns // 2),
            "drift": _threefry.randint_from_bits(bits[:, 1], -self.max_drift,
                                                 self.max_drift + 1),
            "distractor_col": _threefry.randint_from_bits(bits[:, 2], 0, self.columns),
        }

    def observe(self, state) -> torch.Tensor:
        board = self._board(state)
        if self.distractor:
            # Dimmer static column on the top row: structure, no reward.
            board.scatter_(1, state["distractor_col"][:, None], 128)
        return self._paint(board, state)

    def step(self, state, action) -> Tuple[State, TimeStep]:
        action = action.to(torch.int64)
        paddle = torch.clamp(state["paddle"] + (action - 1), 0, self.columns - 1)
        ball_row = state["ball_row"] + 1
        # Drift with wall bounce: reflect the out-of-range column back in.
        raw = state["ball_col"] + state["drift"]
        bounced = torch.where(raw < 0, -raw,
                              torch.where(raw >= self.columns, 2 * (self.columns - 1) - raw, raw))
        ball_col = torch.clamp(bounced, 0, self.columns - 1)
        done = ball_row == self.rows - 1
        reward = self._reward(done, ball_col, paddle)
        moved = {"ball_row": ball_row, "ball_col": ball_col, "paddle": paddle,
                 "drift": state["drift"], "distractor_col": state["distractor_col"]}
        new_state, obs = self._advance(state, moved, done)
        return new_state, {"state": obs, "reward": reward, "done": done}


# --------------------------------------------------------------------------
# Batch helpers (the JAX package's vmap entry points)
# --------------------------------------------------------------------------


def batch_init(env: JaxEnv, key, batch_size: int, start: int = 0) -> State:
    """State of ``batch_size`` envs: env ``i`` is seeded with
    ``fold_in(key, start + i)``, the per-env half of the seeding contract.
    ``start`` is the global index of the first env: a rank holding envs
    ``[start, start + batch_size)`` of a batch sharded over ranks seeds them
    as the whole batch does.  ``key`` is one raw key ``[2]``; the state
    lives on its device."""
    idx = torch.arange(start, start + batch_size, device=key.device)
    return env.init(_threefry.fold_in(key, idx))


def batch_observe(env: JaxEnv, state) -> torch.Tensor:
    return env.observe(state)


def batch_step(env: JaxEnv, state, action) -> Tuple[State, TimeStep]:
    return env.step(state, action)


# --------------------------------------------------------------------------
# Host-side shim: the other half of the bit-exactness proof
# --------------------------------------------------------------------------


def host_catch(key, rows: int = 10, columns: int = 5):
    """A host :class:`~moolib_tpu_torch.envs.catch.FlatCatchEnv` whose ball
    column of each episode follows the same derivation as :class:`JaxCatch`
    seeded with ``key`` (raw ``[2]``, a CPU tensor): the host half of the
    seeding contract, drawn with :mod:`._threefry` on the host."""
    from .catch import FlatCatchEnv

    key = torch.as_tensor(key, dtype=torch.int64)

    class _SharedSeedCatch(FlatCatchEnv):
        def __init__(self):
            super().__init__(rows=rows, columns=columns)
            self._episode = 0

        def _sample_column(self) -> int:
            col = _threefry.randint(_episode_key(key, self._episode), 0, self.columns)
            self._episode += 1
            return int(col)

    return _SharedSeedCatch()


def make_jax_env(name: str, **kwargs) -> JaxEnv:
    """Factory behind ``--env_backend jax``: the experiment's ``--env``
    names onto the on-device family (``catch_flat``: the host env's
    geometry; ``catch_proc``: the procedural variant, same spec)."""
    if name in ("catch_flat", "jax_catch", "catch"):
        return JaxCatch(**kwargs)
    if name in ("catch_proc", "proc_catch", "jax_proc"):
        return JaxProcCatch(**kwargs)
    raise ValueError(
        f"no jax env for --env {name!r} (catch_flat | catch_proc; the other "
        "env names are host/EnvPool-backed — drop --env_backend jax)"
    )


__all__ = [
    "JaxEnv",
    "JaxCatch",
    "JaxProcCatch",
    "TimeStep",
    "batch_init",
    "batch_observe",
    "batch_step",
    "host_catch",
    "make_jax_env",
]
