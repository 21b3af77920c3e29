"""Example entry points of the port."""
