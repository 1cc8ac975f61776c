"""Pair traversals, grid and neighbour search, SPH kernels.

The names the JAX package's ``ops`` exports; the CUDA kernels' modules
(``cuda_pairs``, ``cuda_dfsph``, ``cuda_iisph``, ``cuda_pcisph``) build
their libraries at the first launch, not here.
"""

from sph_taichi_torch.ops.kernels import cubic_kernel, cubic_kernel_derivative
from sph_taichi_torch.ops.grid import (
    pos_to_cell, flatten_cell, compute_cell_ids, cell_offsets, sort_by_cell)
from sph_taichi_torch.ops.neighbors import NeighborList, build_neighbor_list
