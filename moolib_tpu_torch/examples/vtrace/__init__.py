"""IMPALA (V-trace) agent: the port of the JAX package's ``examples/vtrace``."""
