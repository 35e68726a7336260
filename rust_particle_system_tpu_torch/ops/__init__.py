"""Simulation ops: the grid build here, the kernels' wrappers in ``cuda/``."""
