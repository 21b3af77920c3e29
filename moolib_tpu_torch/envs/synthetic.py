"""Synthetic Atari-shaped environment for throughput benchmarking.

Produces frame-stacked uint8 observations with the reference IMPALA input
shape ([84, 84, 4] grayscale frame stack, ``examples/atari/environment.py``)
at near-zero CPU cost, so EnvPool/actor-loop benchmarks measure the framework
rather than an emulator.
"""

from __future__ import annotations

import numpy as np


class SyntheticAtariEnv:
    num_actions = 6

    def __init__(self, height: int = 84, width: int = 84, frames: int = 4, seed=None,
                 episode_length: int = 1000):
        self.observation_shape = (height, width, frames)
        # Shared construction surface (the JAX package's envs.jax_envs.JaxEnv): (shape, dtype).
        self.obs_spec = (self.observation_shape, np.dtype(np.uint8))
        self._rng = np.random.default_rng(seed)
        self._episode_length = episode_length
        self._t = 0
        # A small bank of pre-generated frames; stepping just rotates them.
        self._bank = self._rng.integers(
            0, 256, size=(8, height, width, frames), dtype=np.uint8
        )

    def reset(self):
        self._t = 0
        return self._bank[0]

    def step(self, action):
        self._t += 1
        obs = self._bank[self._t % len(self._bank)]
        reward = float(self._rng.random() < 0.05)
        done = self._t >= self._episode_length
        return obs, reward, done, {}
