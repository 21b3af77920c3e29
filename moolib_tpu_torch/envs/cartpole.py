"""CartPole with the classic Barto-Sutton-Anderson dynamics (gym API).

Same task the reference's A2C example trains on (``examples/a2c.py``,
CartPole-v1: 2 actions, 4-dim state, reward 1 per step, 500-step limit).
"""

from __future__ import annotations

import numpy as np


class CartPoleEnv:
    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    TOTAL_MASS = MASSPOLE + MASSCART
    LENGTH = 0.5  # half the pole's length
    POLEMASS_LENGTH = MASSPOLE * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_THRESHOLD = 12 * 2 * np.pi / 360
    X_THRESHOLD = 2.4

    num_actions = 2
    observation_shape = (4,)

    @property
    def obs_spec(self):
        """``(shape, dtype)`` — the shared construction surface (see
        the JAX package's ``envs.jax_envs.JaxEnv``)."""
        return self.observation_shape, np.dtype(np.float32)

    def __init__(self, seed: int | None = None, max_episode_steps: int = 500):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4, dtype=np.float32)
        self._steps = 0
        self._max_episode_steps = max_episode_steps

    def reset(self):
        self._state = self._rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self._steps = 0
        return self._state.copy()

    def step(self, action):
        action = int(np.asarray(action).reshape(()))
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.POLEMASS_LENGTH * theta_dot**2 * sintheta) / self.TOTAL_MASS
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * costheta**2 / self.TOTAL_MASS)
        )
        xacc = temp - self.POLEMASS_LENGTH * thetaacc * costheta / self.TOTAL_MASS
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot], dtype=np.float32)
        self._steps += 1
        terminated = bool(
            x < -self.X_THRESHOLD
            or x > self.X_THRESHOLD
            or theta < -self.THETA_THRESHOLD
            or theta > self.THETA_THRESHOLD
        )
        truncated = self._steps >= self._max_episode_steps
        return self._state.copy(), 1.0, terminated or truncated, {}
