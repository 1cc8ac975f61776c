"""Fixed-capacity neighbour lists from the sorted cell structure.

Counterpart of ``sph_taichi_tpu/ops/neighbors.py``: the plain engine's
(N, K) neighbour index matrix, built once per step and reused by every
pair sum.  The 27 cell offsets are walked in ``itertools.product`` order
(dz innermost) and, within a cell, in sorted order; survivors of the
reference's filters (j != i and |x_i - x_j|^2 < h^2, particle_system.py:384)
are compacted into the next free slots.  The CUDA kernels walk candidates
in exactly this order.

- ``cnt`` is the exact number of within-radius neighbours (even beyond K).
- Cells fuller than cell_cap or particles with more than K neighbours are
  truncated; ``diag`` reports both overflows (the JAX package's gather
  engine truncates full cells silently).
"""

import itertools
from typing import NamedTuple, Optional

import torch

from sph_taichi_torch.ops.grid import max_cell_occupancy, pos_to_cell


class NeighborList(NamedTuple):
    idx: torch.Tensor      # i64[N, K] sorted-order neighbour indices (0-filled tail)
    cnt: torch.Tensor      # i32[N] true within-radius neighbour count (may exceed K)
    max_cnt: torch.Tensor  # i32[] max neighbours seen for any particle
    cell_overflow: torch.Tensor  # i32[] 1 when a cell holds more than cell_cap
    extra_diag: Optional[dict] = None  # the slot engine's (ops/slots.py)

    def mask(self):
        """bool[N, K]: which idx entries are valid."""
        k = self.idx.shape[1]
        slots = torch.arange(k, device=self.idx.device)[None, :]
        return slots < torch.clamp_max(self.cnt, k)[:, None]

    @property
    def diag(self):
        """neighbor_overflow != 0 means pair contributions were dropped:
        the physics is wrong; raise params.neighbor_cap."""
        k = self.idx.shape[1]
        return {"max_neighbors": self.max_cnt,
                "neighbor_overflow": (self.max_cnt > k).to(torch.int32),
                "cell_overflow": self.cell_overflow,
                **(self.extra_diag or {})}


def build_neighbor_list(x, cell_starts, grid_num, grid_size, support_radius,
                        neighbor_cap, cell_cap, dim=3, x_origin=0):
    """Build (N, K) neighbour lists over cell-sorted positions.

    Args:
      x: f32[N, dim] positions in sorted (by cell id) order.
      cell_starts: i32[num_cells + 2] from ops.grid.cell_offsets.
      grid_num: (nx, ny, nz).
      neighbor_cap: K.
      cell_cap: M, max particles fetched per cell.
      x_origin: the grid's first x-layer (SimParams.x_origin).
    """
    n = x.shape[0]
    dev = x.device
    k_cap = neighbor_cap
    h2 = support_radius * support_radius
    strides = (grid_num[1] * grid_num[2], grid_num[2], 1)[:dim]
    starts = cell_starts.to(torch.int64)

    # unclipped, as the reference's neighbour walk computes it
    center = pos_to_cell(x, grid_size, x_origin).to(torch.int64)
    rows = torch.arange(n, device=dev)
    slot_iota = torch.arange(cell_cap, device=dev)[None, :]

    # one spare column takes every dropped write
    nbr_idx = torch.zeros((n, k_cap + 1), dtype=torch.int64, device=dev)
    cnt = torch.zeros((n,), dtype=torch.int64, device=dev)

    for off in itertools.product(*([(-1, 0, 1)] * dim)):
        in_grid = torch.ones(n, dtype=torch.bool, device=dev)
        flat = torch.zeros(n, dtype=torch.int64, device=dev)
        for c in range(dim):
            cc = center[:, c] + off[c]
            in_grid = in_grid & (cc >= 0) & (cc < grid_num[c])
            flat = flat + cc.clamp(0, grid_num[c] - 1) * strides[c]
        start = starts[flat]
        end = torch.where(in_grid, starts[flat + 1], start)
        cand = start[:, None] + slot_iota                    # (N, M)
        in_cell = cand < end[:, None]
        cand_c = torch.clamp_max(cand, n - 1)
        d = x[:, None, :] - x[cand_c]                        # (N, M, dim)
        d2 = d[..., 0] * d[..., 0]
        for c in range(1, dim):                              # kernel's order
            d2 = d2 + d[..., c] * d[..., c]
        ok = in_cell & (d2 < h2) & (cand_c != rows[:, None])
        slot = cnt[:, None] + torch.cumsum(ok.to(torch.int64), dim=1) - 1
        write_slot = torch.where(ok & (slot < k_cap), slot,
                                 torch.full_like(slot, k_cap))
        nbr_idx.scatter_(1, write_slot, cand_c)
        cnt = cnt + ok.sum(dim=1)

    cnt = cnt.to(torch.int32)
    return NeighborList(idx=nbr_idx[:, :k_cap], cnt=cnt, max_cnt=cnt.max(),
                        cell_overflow=(max_cell_occupancy(starts)
                                       > cell_cap).to(torch.int32))


def gather_neighbors(arr, nl):
    """arr[N, ...] -> arr[N, K, ...] gathered along the neighbour axis (the
    tail past a row's count holds row 0's values; ``nl.mask()`` marks the
    valid entries)."""
    return arr[nl.idx]
