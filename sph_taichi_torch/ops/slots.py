"""The slot-dense candidate map and the plain slot engine.

Counterpart of the gather map of the retired ``SlotEngine.prepare``
(sph_taichi_tpu/ops/retired/pallas_slots.py:118-130), the engine behind
``--backend pallas_slots``.  The particle of rank r in cell c (its r-th in
sorted order) sits in layer r // 8, slot r % 8 of that cell.  A cell holds
at most 8 * ``params.slot_layers`` particles: ranks beyond are not in the
map, their pairs drop, and ``slot_overflow`` is set (a fatal flag,
utils/profiling.py), as in the JAX engine.

Layout: ``SlotMap.idx`` is i32[layers, nx, ny, nz * 8], the sorted index of
each slot's particle, -1 in an empty slot (the JAX map holds n there).  A
layer is one block, and in it the slots of one (ix, iy) column's z-cells
follow each other, so the walk reads a z-run of three cells as 24
consecutive ints.  The map holds indices, not positions: a kernel gathers
each candidate's fields by index anyway, and at dragon_bath's grid
(125 x 75 x 50 cells, 4 layers) the map is 60 MB of indices against
240 MB of float4 positions.

Two parts of the JAX prepare are not ported:
- the ring padding by one cell in x, y and z.  It made every TPU window a
  static slice; the CUDA walk (csrc/pair_common.cuh ``SlotWalk``) clips the
  centre's columns and z-cells to the grid exactly as the cell-run walk
  does, since a centre's unclipped cell may lie outside the grid, so a ring
  would remove no test;
- the tables ``ctr_tab``, ``col_tab``, ``zinfo``, ``mxt_tab`` and the
  ``group_overflow`` flag.  They schedule Mosaic row groups of centres and
  their column slabs in VMEM; a GPU thread per centre walks its own
  columns and has no such groups.

``slot_neighbor_list`` gives the plain slot engine's neighbour lists: the
map's entries of the 27 cells, in the walk's order, within h, in the list
format of ops/neighbors.py.  When no cell overflows they equal
``build_neighbor_list``'s lists; when one does, they drop exactly the pairs
that the slot kernels drop.
"""

import itertools
from typing import NamedTuple

import torch

from sph_taichi_torch.ops.grid import pos_to_cell
from sph_taichi_torch.ops.neighbors import NeighborList
from sph_taichi_torch.ops.pairs import GatherEngine

SLOT = 8    # slots per cell per layer


class SlotMap(NamedTuple):
    idx: torch.Tensor     # i32[layers, nx, ny, nz * SLOT], -1 = empty
    starts: torch.Tensor  # i32[num_cells + 2] the cell offsets it came from
    diag: dict

    @property
    def layers(self):
        return self.idx.shape[0]


def build_slot_map(cell_starts, params):
    """The slot map of the sorted particles whose cell offsets are
    ``cell_starts`` (ops.grid.cell_offsets), no host sync, with the
    diagnostics ``max_cell_occupancy_engine``, ``max_layers_used`` (the
    layers the fullest cell needs, at least 1, at most slot_layers) and
    ``slot_overflow`` (a cell holds more than 8 * slot_layers)."""
    nx, ny, nz = params.grid_num
    c = nx * ny * nz
    layers = params.slot_layers
    starts = cell_starts[:c].reshape(nx, ny, nz, 1)
    cnt = cell_starts[1:c + 1].reshape(nx, ny, nz, 1) - starts
    rank = torch.arange(layers * SLOT, dtype=torch.int32,
                        device=cell_starts.device).reshape(layers, 1, 1, 1,
                                                           SLOT)
    idx = torch.where(rank < cnt, starts + rank, -1)
    occ = torch.max(cnt)
    diag = {"max_cell_occupancy_engine": occ,
            "max_layers_used": torch.clamp((occ + SLOT - 1) // SLOT, 1,
                                           layers),
            "slot_overflow": occ > layers * SLOT}
    return SlotMap(idx=idx.reshape(layers, nx, ny, nz * SLOT),
                   starts=cell_starts, diag=diag)


def slot_neighbor_list(smap, x, params):
    """(N, K) neighbour lists over the slot map ``smap`` of the sorted
    positions ``x``: the 27 cells in ``itertools.product`` order (dz
    innermost), each cell's slots layer-major, survivors of j != i and
    |x_i - x_j|^2 < h^2 compacted in that order (ops/neighbors.py's
    format; ``cell_overflow`` is the slot overflow)."""
    n = x.shape[0]
    dev = x.device
    grid_num = params.grid_num
    k_cap = params.neighbor_cap
    h2 = params.support_radius * params.support_radius
    strides = (grid_num[1] * grid_num[2], grid_num[2], 1)
    # (cells, layers * SLOT): a cell's slots in rank order
    per_cell = smap.idx.reshape(smap.layers, params.num_cells, SLOT) \
        .permute(1, 0, 2).reshape(params.num_cells, -1)

    center = pos_to_cell(x, params.grid_size,
                         params.x_origin).to(torch.int64)
    rows = torch.arange(n, device=dev)
    nbr_idx = torch.zeros((n, k_cap + 1), dtype=torch.int64, device=dev)
    cnt = torch.zeros((n,), dtype=torch.int64, device=dev)
    for off in itertools.product((-1, 0, 1), repeat=3):
        in_grid = torch.ones(n, dtype=torch.bool, device=dev)
        flat = torch.zeros(n, dtype=torch.int64, device=dev)
        for c in range(3):
            cc = center[:, c] + off[c]
            in_grid = in_grid & (cc >= 0) & (cc < grid_num[c])
            flat = flat + cc.clamp(0, grid_num[c] - 1) * strides[c]
        cand = per_cell[flat].to(torch.int64)                 # (N, L*8)
        in_cell = (cand >= 0) & in_grid[:, None]
        cand_c = cand.clamp(0, n - 1)
        d = x[:, None, :] - x[cand_c]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        ok = in_cell & (d2 < h2) & (cand_c != rows[:, None])
        slot = cnt[:, None] + torch.cumsum(ok.to(torch.int64), dim=1) - 1
        write_slot = torch.where(ok & (slot < k_cap), slot,
                                 torch.full_like(slot, k_cap))
        nbr_idx.scatter_(1, write_slot, cand_c)
        cnt = cnt + ok.sum(dim=1)

    cnt = cnt.to(torch.int32)
    return NeighborList(
        idx=nbr_idx[:, :k_cap], cnt=cnt, max_cnt=cnt.max(),
        cell_overflow=smap.diag["slot_overflow"].to(torch.int32),
        extra_diag=smap.diag)


class SlotGatherEngine(GatherEngine):
    """The plain slot engine: ``GatherEngine``'s traversal over the slot
    map's neighbour lists.  The CPU path of ``--backend pallas_slots`` and
    the plain version the slot kernels are held against."""

    def prepare(self, x, cell_starts):
        return slot_neighbor_list(build_slot_map(cell_starts, self.params),
                                  x, self.params)
