"""Uniform background grid: cell ids, stable sort, cell-range offsets.

Counterpart of ``sph_taichi_tpu/ops/grid.py``: cell id -> stable sort by
cell id -> one index gather per field -> cell start offsets.  Cell-id math
is the reference's: truncation of pos * (1/grid_size) and flattening
ix*ny*nz + iy*nz + iz (particle_system.py:288-294).  Padding particles go
to an overflow cell (id = num_cells) so they sort to the tail.
"""

import numpy as np
import torch

from sph_taichi_torch.state import MATERIAL_PAD


def inv_grid_size(grid_size):
    """The host-computed f32 reciprocal every cell assignment multiplies
    by (the CUDA kernels receive the same value)."""
    return np.float32(1.0) / np.float32(grid_size)


def pos_to_cell(x, grid_size, x_origin=0):
    """Integer cell coords of each row by truncation toward zero (reference
    :288-289), the x coordinate less ``x_origin`` (a slab's first x-layer,
    SimParams.x_origin; 0 on one device).

    A multiply by the host-computed f32 reciprocal, never a division: an
    IEEE f32 multiply rounds the same on every device, so a particle on a
    lattice plane lands in the same cell on the CPU and on the card.  The
    origin is an integer subtracted after the cast: positions are never
    shifted.  Padding rows parked at 1e9 fall outside int32, where torch's
    cast gives no defined value (the card's saturates): every caller masks
    them or finds them outside the grid, and the sharded owner lookup
    (parallel/sharding.py ``owner_of``) clips first.
    """
    cell = (x * float(inv_grid_size(grid_size))).to(torch.int32)
    if x_origin:
        cell = torch.cat([cell[..., :1] - x_origin, cell[..., 1:]], dim=-1)
    return cell


def flatten_cell(cell, grid_num):
    """ix*ny*nz + iy*nz + iz (reference :292-294)."""
    ny, nz = grid_num[1], grid_num[2]
    return cell[..., 0] * (ny * nz) + cell[..., 1] * nz + cell[..., 2]


def compute_cell_ids(x, material, grid_size, grid_num, x_origin=0):
    """Flat cell id per particle; padding -> overflow cell (= num_cells).

    Real particle coords are clipped into the grid so out-of-domain strays
    get a valid edge cell.
    """
    num_cells = grid_num[0] * grid_num[1] * grid_num[2]
    cell = pos_to_cell(x, grid_size, x_origin)
    cell = torch.stack([cell[:, k].clamp(0, grid_num[k] - 1)
                        for k in range(3)], dim=1)
    flat = flatten_cell(cell, grid_num)
    return torch.where(material == MATERIAL_PAD,
                       torch.full_like(flat, num_cells), flat)


def sort_by_cell(particles, cell_ids, extra_transient=()):
    """Stable sort of every particle field by flat cell id.

    Transient fields (recomputed before any read in every step, see
    models/base.py bin_and_sort) are not permuted: they come back zeroed.
    Returns (sorted_particles, sorted_cell_ids).
    """
    sorted_ids, perm = torch.sort(cell_ids, stable=True)
    transient = {"dfsph_factor", "density_adv", *extra_transient}
    out = {}
    for name, a in particles._asdict().items():
        if a is None:
            continue
        out[name] = torch.zeros_like(a) if name in transient else a[perm]
    return particles._replace(**out), sorted_ids


def cell_offsets(sorted_cell_ids, num_cells):
    """i32[num_cells + 2]: start[c] .. start[c+1] is the sorted index range
    of cell c (one extra entry for the overflow cell of padding particles).
    """
    # searchsorted, not bincount: CUDA bincount reads the max to the host
    cells = torch.arange(num_cells + 2, dtype=sorted_cell_ids.dtype,
                         device=sorted_cell_ids.device)
    return torch.searchsorted(sorted_cell_ids, cells, out_int32=True)


def max_cell_occupancy(starts):
    """Diagnostic: most particles in any real cell."""
    return torch.max(starts[1:-1] - starts[:-2])
