"""Self-contained environments with the gym step/reset protocol.

numpy-only copies of the JAX package's ``envs``: CartPole (classic
control, the A2C example's task), Catch (a minimal *learnable* pixel game
standing in for Atari in IMPALA tests), a synthetic Atari-shaped env for
throughput benchmarking, and ``atari.py``: the reference's full Atari
preprocessing stack over any gymnasium-API env, a :class:`GymEnv` adapter
and an ALE factory (``create_env``, which needs ale_py).

``jax_envs`` holds the on-device ("Anakin") env family, torch-batched on
the card with the JAX package's seeding contract (``_threefry``), behind
``make_jax_env`` and ``--env_backend jax``.
"""

from .atari import AtariPreprocessing, GymEnv, create_env  # noqa: F401
from .cartpole import CartPoleEnv  # noqa: F401
from .catch import CatchEnv, FlatCatchEnv, FrameStack  # noqa: F401
from .jax_envs import (  # noqa: F401
    JaxCatch,
    JaxEnv,
    JaxProcCatch,
    make_jax_env,
)
from .synthetic import SyntheticAtariEnv  # noqa: F401
