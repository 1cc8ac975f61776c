"""Pair traversals, grid and neighbour search, SPH kernels."""
