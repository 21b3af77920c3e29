"""Attention ops: the flash-attention kernel and the decode attention math."""
