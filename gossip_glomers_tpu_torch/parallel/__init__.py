"""Topology builders (the port's own copies of the reference's)."""
