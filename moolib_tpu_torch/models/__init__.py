"""Models of the port: the TransformerLM, the IMPALA ResNet, the
recurrent actor-critic and the R2D2 recurrent Q-network, and their flax
weight converters."""

from .qnet import RecurrentQNet  # noqa: F401
