"""Atari environment factory with reference-parity preprocessing.

Mirrors the reference's ALE setup (``examples/atari/environment.py:19-40``
and ``examples/atari/atari_preprocessing.py``): grayscale, frame-skip with
max-pooling over the last two raw frames, 84x84 area resize, sticky
actions, and a 4-frame stack — producing the (84, 84, 4) uint8 observations
the IMPALA agent trains on.

The preprocessing is implemented here against the plain gymnasium API (so
it is unit-testable without ROMs); only :func:`create_env` needs ``ale_py``,
and raises a clear error when it is absent (this image ships gymnasium but
no ALE).  :class:`GymEnv` adapts any gymnasium env to the framework's
``reset() -> obs`` / ``step(a) -> (obs, reward, done, info)`` protocol used
by :class:`moolib_tpu_torch.envpool.EnvPool`.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class GymEnv:
    """Adapter: gymnasium's (obs, info) / 5-tuple API -> the framework's
    old-gym protocol (``reset() -> obs``, ``step(a) -> (obs, r, done, info)``,
    ``done = terminated or truncated``)."""

    def __init__(self, env_or_id, seed=None, **make_kwargs):
        import gymnasium

        if isinstance(env_or_id, str):
            env_or_id = gymnasium.make(env_or_id, **make_kwargs)
        self.env = env_or_id
        self._seed = seed
        space = getattr(self.env, "action_space", None)
        # Strict isinstance: MultiBinary etc. also duck-type ``.n``.
        if not isinstance(space, gymnasium.spaces.Discrete):
            raise ValueError(
                f"{self.env} has action space {space!r}; the framework agents "
                "act by integer index, so only Discrete action spaces are "
                "supported"
            )
        self.num_actions = int(space.n)

    @property
    def obs_spec(self):
        """Shared construction surface (the JAX package's
        ``envs.jax_envs.JaxEnv``): gymnasium
        envs declare shape/dtype on their observation space."""
        space = self.env.observation_space
        return tuple(space.shape), np.dtype(space.dtype)

    def reset(self):
        obs, _ = self.env.reset(seed=self._seed)
        self._seed = None  # reseed only on the first reset
        return np.asarray(obs)

    def step(self, action):
        action = np.asarray(action).reshape(()).item()
        obs, reward, terminated, truncated, info = self.env.step(action)
        return np.asarray(obs), float(reward), bool(terminated or truncated), info

    def close(self):
        if hasattr(self.env, "close"):
            self.env.close()


class AtariPreprocessing:
    """Standard Atari preprocessing (Machado et al. 2018), as the reference
    applies it: wraps a *raw* gymnasium-API env emitting RGB frames and
    exposes the framework protocol with (screen_size, screen_size, num_stack)
    uint8 observations.

    - ``frame_skip`` emulator steps per agent step, rewards summed; the
      emitted frame is the pixelwise max of the last two raw frames
      (flicker removal).
    - luminance grayscale + ``screen_size``² area resize.
    - sticky actions: at every *emulator* frame, with probability
      ``sticky_action_prob`` the previously-executed action repeats
      (Machado et al. §5; apply EITHER here or in ALE itself, not both —
      the reference uses the v5 env's built-in 0.25).
    - ``terminal_on_life_loss``: losing a life ends the *agent* episode, but
      the next ``reset()`` continues the same game with a no-op step; only
      real game-over restarts the emulator (standard episodic-life wrapper).
    - ``num_stack`` processed frames stacked on the channel axis.
    """

    def __init__(
        self,
        env,
        frame_skip: int = 4,
        screen_size: int = 84,
        sticky_action_prob: float = 0.0,
        num_stack: int = 4,
        terminal_on_life_loss: bool = False,
        noop_max: int = 0,
        seed=None,
    ):
        if frame_skip < 1:
            raise ValueError("frame_skip must be >= 1")
        self.env = env
        self.frame_skip = frame_skip
        self.screen_size = screen_size
        self.sticky_action_prob = sticky_action_prob
        self.num_stack = num_stack
        self.terminal_on_life_loss = terminal_on_life_loss
        self.noop_max = noop_max
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._stack = deque(maxlen=num_stack)
        self._prev_action = 0
        self._lives = None
        self._needs_full_reset = True
        self.num_actions = int(env.action_space.n)

    @property
    def observation_shape(self):
        return (self.screen_size, self.screen_size, self.num_stack)

    @property
    def obs_spec(self):
        return self.observation_shape, np.dtype(np.uint8)

    def _to_gray(self, frame):
        frame = np.asarray(frame)
        if frame.ndim == 3 and frame.shape[-1] == 3:
            try:
                import cv2

                return cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
            except ImportError:
                # ITU-R 601 luminance, ROUNDED (truncation would map (v,v,v)
                # to v-1 where the float sum lands just under v); cv2's
                # fixed-point rounding can still differ by 1 LSB on general
                # RGB, so prefer cv2 when present.
                frame = np.round(
                    frame @ np.array([0.299, 0.587, 0.114])
                ).astype(np.uint8)
        return frame

    def _process(self, frame, prev_frame=None):
        # Grayscale each raw frame FIRST, then max-pool: pixelwise
        # luminance(max(rgb)) != max(luminance), and the reference pools
        # already-grayscale screen buffers.
        frame = self._to_gray(frame)
        if prev_frame is not None:
            frame = np.maximum(frame, self._to_gray(prev_frame))
        if frame.shape[:2] != (self.screen_size, self.screen_size):
            import cv2

            frame = cv2.resize(
                frame,
                (self.screen_size, self.screen_size),
                interpolation=cv2.INTER_AREA,
            )
        return np.asarray(frame, dtype=np.uint8)

    def _obs(self):
        return np.stack(self._stack, axis=-1)

    def reset(self):
        if self._needs_full_reset:
            obs, _ = self.env.reset(seed=self._seed)
            self._seed = None
            # Random no-op starts (1..noop_max emulator no-ops on a full
            # game reset), the reference's evaluation convention for
            # de-determinizing start states.
            if self.noop_max:
                for _ in range(int(self._rng.integers(1, self.noop_max + 1))):
                    obs, _, terminated, truncated, _ = self.env.step(0)
                    if terminated or truncated:
                        obs, _ = self.env.reset()
        else:
            # Life lost but the game is still on: continue it with a no-op
            # so the agent sees post-first-life states (episodic-life).
            obs, _, terminated, truncated, _ = self.env.step(0)
            if terminated or truncated:
                obs, _ = self.env.reset()
        self._needs_full_reset = False
        self._prev_action = 0
        self._lives = self._get_lives()
        first = self._process(np.asarray(obs))
        self._stack.clear()
        for _ in range(self.num_stack):
            self._stack.append(first)
        return self._obs()

    def _get_lives(self):
        ale = getattr(getattr(self.env, "unwrapped", self.env), "ale", None)
        return ale.lives() if ale is not None else None

    def step(self, action):
        action = int(np.asarray(action).reshape(()))
        total_reward = 0.0
        done = False
        info = {}
        frame = prev_frame = None
        for t in range(self.frame_skip):
            # Sticky coin is drawn per emulator frame: the executed action
            # can flip mid-skip (Machado et al. §5).
            exec_action = action
            if self.sticky_action_prob and self._rng.random() < self.sticky_action_prob:
                exec_action = self._prev_action
            self._prev_action = exec_action
            obs, reward, terminated, truncated, info = self.env.step(exec_action)
            total_reward += float(reward)
            # Keep the last two raw frames for flicker max-pooling.
            if t >= self.frame_skip - 2:
                prev_frame, frame = frame, np.asarray(obs)
            done = bool(terminated or truncated)
            if done:
                self._needs_full_reset = True
            elif self.terminal_on_life_loss:
                lives = self._get_lives()
                if lives is not None and self._lives is not None and lives < self._lives:
                    done = True  # agent episode ends; game continues on reset
                self._lives = lives
            if done:
                frame, prev_frame = np.asarray(obs), prev_frame
                break
        self._stack.append(self._process(frame, prev_frame))
        return self._obs(), total_reward, done, info

    def close(self):
        if hasattr(self.env, "close"):
            self.env.close()


def create_env(
    game: str = "Pong",
    *,
    frame_skip: int = 4,
    screen_size: int = 84,
    num_stack: int = 4,
    sticky_actions: bool = True,
    full_action_space: bool = True,
    noop_max: int = 30,
    seed=None,
):
    """ALE factory matching the reference (``examples/atari/environment.py``):
    ``ALE/<game>-v5`` with emulator-level frameskip/sticky disabled so the
    wrapper (testable, explicit) owns them.  Defaults follow the reference's
    evaluation convention: the full 18-action space and random no-op starts
    (``noop_max=30``).  Needs ``ale_py`` + ROMs."""
    try:
        import gymnasium

        raw = gymnasium.make(
            f"ALE/{game}-v5",
            frameskip=1,
            repeat_action_probability=0.0,
            full_action_space=full_action_space,
        )
    except Exception as e:
        # Only blame a missing ale_py when it actually is missing; anything
        # else (e.g. a typo'd game name with ale_py installed) keeps its own
        # message — gymnasium's NameNotFound includes a did-you-mean.
        import importlib.util

        if importlib.util.find_spec("ale_py") is not None:
            raise
        raise ImportError(
            f"creating ALE/{game}-v5 failed ({e!r}). Real Atari needs the "
            "ale_py package and its ROMs (pip install ale-py gymnasium[atari]); "
            "this environment ships neither — use the built-in 'catch'/"
            "'pixel_catch' pixel envs or envs.SyntheticAtariEnv instead."
        ) from e
    return AtariPreprocessing(
        raw,
        frame_skip=frame_skip,
        screen_size=screen_size,
        sticky_action_prob=0.25 if sticky_actions else 0.0,
        num_stack=num_stack,
        noop_max=noop_max,
        seed=seed,
    )
