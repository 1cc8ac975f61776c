"""Spatial slab sharding over ``torch.distributed`` (parallel/sharding.py)
and its communicator and rank launcher (parallel/comm.py)."""

from sph_taichi_torch.parallel.sharding import ShardedSolver
