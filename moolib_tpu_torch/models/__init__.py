"""Models of the port: the TransformerLM and its flax weight converter."""
