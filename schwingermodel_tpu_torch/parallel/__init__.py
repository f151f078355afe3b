"""Lattice domain decomposition over a mesh of shards."""
