"""Catch: a minimal learnable pixel environment (deepmind bsuite-style task).

A ball falls from the top of a rows×cols board; the agent moves a paddle on
the bottom row (actions: left/stay/right) and gets +1 for catching, -1 for
missing.  Serves as the "Atari" stand-in for IMPALA integration tests: pixel
observations, episodic reward, and solvable quickly from pixels — the role
ALE/Pong plays for the reference (``examples/vtrace/config.yaml:23-65``),
without the ALE dependency.
"""

from __future__ import annotations

import numpy as np


class CatchEnv:
    num_actions = 3

    def __init__(self, rows: int = 10, columns: int = 5, seed=None, frame_shape=None):
        self.rows = rows
        self.columns = columns
        self._rng = np.random.default_rng(seed)
        self._ball = [0, 0]
        self._paddle = 0
        # Optional upscaled frame (e.g. (84, 84)) to exercise conv encoders.
        self._frame_shape = frame_shape

    @property
    def observation_shape(self):
        if self._frame_shape is not None:
            return (*self._frame_shape, 1)
        return (self.rows, self.columns, 1)

    @property
    def obs_spec(self):
        """``(shape, dtype)`` — the construction surface shared with the
        pure-JAX env family (the JAX package's ``envs.jax_envs.JaxEnv``), so
        benches and the experiment size either backend through one
        factory."""
        return self.observation_shape, np.dtype(np.uint8)

    def _sample_column(self) -> int:
        """Per-episode drop column — THE env's only entropy.  Overridable so
        a shared-seed harness (the JAX package's ``jax_envs.host_catch``)
        can pin the stream to the on-device derivation for bit-exactness
        proofs."""
        return int(self._rng.integers(self.columns))

    def _obs(self):
        board = np.zeros((self.rows, self.columns, 1), dtype=np.uint8)
        board[self._ball[0], self._ball[1], 0] = 255
        board[self.rows - 1, self._paddle, 0] = 255
        if self._frame_shape is not None:
            h, w = self._frame_shape
            ry, rx = h // self.rows, w // self.columns
            big = np.zeros((h, w, 1), dtype=np.uint8)
            up = np.kron(board[..., 0], np.ones((ry, rx), dtype=np.uint8))
            big[: up.shape[0], : up.shape[1], 0] = up
            return big
        return board

    def reset(self):
        self._ball = [0, self._sample_column()]
        self._paddle = self.columns // 2
        return self._obs()

    def step(self, action):
        action = int(np.asarray(action).reshape(()))
        self._paddle = int(np.clip(self._paddle + (action - 1), 0, self.columns - 1))
        self._ball[0] += 1
        done = self._ball[0] == self.rows - 1
        reward = 0.0
        if done:
            reward = 1.0 if self._ball[1] == self._paddle else -1.0
        return self._obs(), reward, done, {}


class FlatCatchEnv(CatchEnv):
    """Catch with the board flattened to a 1-D uint8 vector.

    Routes through the MLP (``ActorCriticNet``) instead of the conv encoder:
    the per-frame model compute drops to microseconds, which makes this the
    actor-data-plane benchmark env — at this scale whole-agent SPS measures
    dispatch/copy overhead per frame, not conv FLOPs, the same regime a TPU
    learner leaves the actor loop in (``benchmarks/agent_bench.py --scale
    small``).  Observations stay uint8 so the single-crossing upload
    contract is exercised end to end.
    """

    @property
    def observation_shape(self):
        h, w, c = super().observation_shape
        return (h * w * c,)

    @property
    def obs_spec(self):
        return self.observation_shape, np.dtype(np.uint8)

    def _obs(self):
        return super()._obs().reshape(-1)


class FrameStack:
    """Stack the last ``num_stack`` single-channel frames on the channel axis
    (the reference trains on (84, 84, 4) stacked Atari frames,
    ``examples/atari/environment.py``; AtariPreprocessing stacks internally —
    this is the generic wrapper for envs that emit one frame per step)."""

    def __init__(self, env, num_stack: int = 4):
        self.env = env
        self.num_stack = num_stack
        self._frames = None
        self.num_actions = env.num_actions

    @property
    def observation_shape(self):
        h, w, c = self.env.observation_shape
        return (h, w, c * self.num_stack)

    @property
    def obs_spec(self):
        _, dtype = self.env.obs_spec
        return self.observation_shape, dtype

    def _obs(self):
        return np.concatenate(self._frames, axis=-1)

    def reset(self):
        first = self.env.reset()
        self._frames = [first] * self.num_stack
        return self._obs()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self._frames = self._frames[1:] + [obs]
        return self._obs(), reward, done, info
