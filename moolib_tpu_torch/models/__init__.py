"""Models of the port: the TransformerLM, the IMPALA ResNet and the
recurrent actor-critic, and their flax weight converters."""
