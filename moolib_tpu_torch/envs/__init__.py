"""Self-contained environments with the gym step/reset protocol.

numpy-only copies of the JAX package's ``envs``: CartPole (classic
control, the A2C example's task), Catch (a minimal *learnable* pixel game
standing in for Atari in IMPALA tests), a synthetic Atari-shaped env for
throughput benchmarking, and ``atari.py``: the reference's full Atari
preprocessing stack over any gymnasium-API env, a :class:`GymEnv` adapter
and an ALE factory (``create_env``, which needs ale_py).

Not yet ported (slice 3's actor data plane): ``jax_envs``, the JAX
package's device-side Anakin envs; the port's counterpart will be
torch-batched envs on the card.
"""

from .atari import AtariPreprocessing, GymEnv, create_env  # noqa: F401
from .cartpole import CartPoleEnv  # noqa: F401
from .catch import CatchEnv, FlatCatchEnv, FrameStack  # noqa: F401
from .synthetic import SyntheticAtariEnv  # noqa: F401
