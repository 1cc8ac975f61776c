"""Spatial slab sharding over ``torch.distributed`` (parallel/sharding.py)
and its communicator and rank launcher (parallel/comm.py)."""
