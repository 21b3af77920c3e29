"""Parallel attention math (the ring itself comes with a later slice)."""
