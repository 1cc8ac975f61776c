"""Spatial slab decomposition over ``torch.distributed``.

Counterpart of ``sph_taichi_tpu/parallel/sharding.py``: one process per
rank, each with its own device (parallel/comm.py), rank d owning the grid's
x-layers [d * nxd, (d + 1) * nxd).  Every step:

1. **Migration**: particles that left the slab ride a fixed-capacity block
   one hop around the ring to the neighbour (a particle moves |v| dt, far
   less than a cell, per step); arrivals that wrap around the ring are
   dropped (the domain is not periodic).
2. **Halo exchange**: after a local sort each rank sends its first and last
   owned x-layer (one layer is the support radius) to its neighbours as
   *ghost* rows, fixed-capacity blocks again.
3. **Local traversal**: the solvers' pair sums run over the slab's extended
   grid (nxd + 2 layers) with the engines and kernels of one device.  The
   slab's cell lookups take its grid's origin (SimParams.x_origin = rank *
   nxd - 1): a centre's cell is its global cell less the origin in x, on
   the CPU (ops/grid.py pos_to_cell) and in the kernels (cell_x).  Ghosts
   are candidates; their own sums are discarded, and before a pair sum
   reads a recomputed field at neighbours the ghost copies are refreshed
   from their owners (the ghost sync, models/base.py ``sync_fields``).
4. **Global physics**: the implicit solvers' errors and the rigid bodies'
   centre-of-mass and moment sums cross the ranks (psum, or pmax for
   PCISPH's error) over the owned rows only, so every rank runs the same
   iterations.

Between steps the ghost rows stay in the state tagged ``is_dynamic = -1``;
during a step they are not dynamic (``is_dynamic = 0``), so no mask of
dynamic rows counts them.  Capacities are fixed: per-rank rows, migration
block, halo block; a migration or a halo layer that does not fit sets
``migration_overflow`` or ``halo_overflow`` (fatal flags,
utils/profiling.py).

The JAX package's sharded gather engine looks up every centre's cells at
its global index in the slab's local offsets (its ``build_neighbor_list``
takes no origin), which puts a slab's centres ``rank * nxd - 1`` layers
away from their cells on every rank; this module holds itself against the
single-device step instead (tests/test_torch_sharding.py).
"""

import dataclasses

import numpy as np
import torch

from sph_taichi_torch.state import (
    MATERIAL_FLUID, MATERIAL_PAD, Particles, SimParams, SimState)
from sph_taichi_torch.ops.grid import (
    cell_offsets, inv_grid_size, max_cell_occupancy, pos_to_cell)
from sph_taichi_torch.models import base as mbase
from sph_taichi_torch.models.base import StepCtx

AXIS = "shard"

# the packed row: (field, columns, integer) in the JAX package's column
# order; the optional fields follow when the particles carry them
_BASE_LAYOUT = (("object_id", 1, True), ("x", 3, False), ("x0", 3, False),
                ("v", 3, False), ("acc", 3, False), ("m_V", 1, False),
                ("m", 1, False), ("density", 1, False),
                ("pressure", 1, False), ("material", 1, True),
                ("is_dynamic", 1, True), ("color", 3, True))
_OPTIONAL = ("dfsph_factor", "density_adv", "kappa_v", "kappa_p")
COL_X, COL_MATERIAL, COL_DYNAMIC = 1, 17, 18


def layout(p: Particles):
    """The packed columns of ``p``: [(field, columns, integer)]."""
    return list(_BASE_LAYOUT) + [(f, 1, False) for f in _OPTIONAL
                                 if getattr(p, f) is not None]


def _pack(p: Particles, lay):
    """Particles -> one (n, F) f32 matrix (the integer fields are exactly
    representable)."""
    cols = [getattr(p, f).reshape(p.n, w).to(torch.float32)
            for f, w, _ in lay]
    return torch.cat(cols, dim=1)


def _unpack(mat, lay):
    """The inverse of ``_pack``: contiguous fields, as the kernels take
    them."""
    out, c = {}, 0
    for f, w, is_int in lay:
        a = mat[:, c:c + w]
        if is_int:
            a = torch.round(a).to(torch.int32)
        out[f] = (a[:, 0] if w == 1 else a).contiguous()
        c += w
    return Particles(**out)


def pad_rows(n, f, device):
    """Padding rows: material -1, x and x0 parked at 1e9, the rest 0."""
    t = torch.zeros((n, f), dtype=torch.float32, device=device)
    t[:, 1:7] = 1e9
    t[:, COL_MATERIAL] = float(MATERIAL_PAD)
    return t


def _sort_mat(key, mat):
    """(key, rows of mat) in the stable order of key: one sort, one row
    gather."""
    key, perm = torch.sort(key, stable=True)
    return key, mat[perm]


def owner_of(x0, params, nxd, world):
    """The rank that owns each x coordinate (numpy or torch): its global
    x-layer over nxd, clipped to the ranks.  The coordinate is clipped to
    [0, 1e6] before the cast: padding rows sit at 1e9."""
    inv = inv_grid_size(params.grid_size)
    if torch.is_tensor(x0):
        ix = (torch.clamp(x0, 0.0, 1e6) * float(inv)).to(torch.int32)
        return torch.clamp(ix // nxd, 0, world - 1)
    ix = (np.clip(x0, 0.0, 1e6) * inv).astype(np.int32)
    return np.clip(ix // nxd, 0, world - 1)


class ShardedSolver:
    """One rank's part of a spatially sharded solver, with the step
    contract of a single-device solver (``initialize``, ``step``).

    A rank's state holds n_ext rows: up to ``loc_cap`` owned particles
    (default: an even share of params.n_pad), 2 * ``halo_cap`` ghost slots
    and 2 * ``mig_cap`` migration slots, rounded up to 256.  ``device``:
    None means the CUDA device (state.resolve_device); ``engine``: None for
    ``make_engine``'s, or a callable (an engine class) taking the slab's
    params.
    """

    def __init__(self, params: SimParams, comm, mig_cap=2048, halo_cap=8192,
                 loc_cap=None, device=None, engine=None):
        from sph_taichi_torch import build_solver

        self.comm = comm
        self.n_dev = d = comm.world
        self.rank = comm.rank
        nx, ny, nz = params.grid_num
        self.nxd = -(-nx // d)
        self.layer_cells = ny * nz
        self.mig_cap = int(mig_cap)
        self.halo_cap = int(halo_cap)
        self.ghost_slots = 2 * self.halo_cap
        self.loc_cap = int(loc_cap or -(-params.n_pad // d))
        n_loc = self.loc_cap + self.ghost_slots + 2 * self.mig_cap
        self.n_ext = -(-n_loc // 256) * 256
        self.params = params
        self.local_params = dataclasses.replace(
            params, grid_num_override=(self.nxd + 2, ny, nz),
            axis_name=AXIS, n_pad=self.n_ext,
            x_origin=self.rank * self.nxd - 1)
        eng = None if engine is None else engine(self.local_params)
        self.solver = build_solver(self.local_params, device=device,
                                   engine=eng)
        self.device = self.solver.device
        self.num_cells_ext = (self.nxd + 2) * self.layer_cells

    # ------------------------------------------------------------------
    def _template(self, particles):
        lay = layout(particles)
        self.layout = lay
        self.f_cols = sum(w for _, w, _ in lay)

    def _scatter_rows(self, particles):
        """This rank's rows of the raw particle set, packed on the host:
        the particles whose x-layer it owns, in their order (JAX
        ``_scatter``), then padding rows up to n_ext."""
        self._template(particles)
        mat = _pack(particles, self.layout).cpu().numpy()
        x0 = mat[:, COL_X]
        owner = owner_of(x0, self.params, self.nxd, self.n_dev)
        owner[mat[:, COL_MATERIAL] == MATERIAL_PAD] = -1
        rows = mat[owner == self.rank]
        if rows.shape[0] > self.loc_cap:
            raise ValueError(f"rank {self.rank} owns {rows.shape[0]} "
                             f"particles > loc_cap {self.loc_cap}")
        seg = pad_rows(self.n_ext, self.f_cols, "cpu").numpy()
        seg[:rows.shape[0]] = rows
        return torch.from_numpy(seg).to(self.device)

    def initialize(self, particles: Particles) -> SimState:
        """Distributed initialize: this rank's slab of the raw particle set
        (host side), then relocalize (the first ghost set), rest centres of
        mass summed across ranks, and the static and moving boundary
        volumes over the slab with the ghost volumes synced (models/base.py
        ``SPHBase.initialize``).  Nothing at full scene scale runs on one
        device."""
        mat = self._scatter_rows(particles)
        lp = self.local_params
        mat, starts, cnt = self._relocalize(mat)
        p, ghost = self._unpack_step(mat)
        ctx = self._step_ctx(p, ghost, starts)
        engine = self.solver.engine
        rest_cm = mbase.compute_rigid_rest_cm(p, lp, self.comm)
        p = mbase.compute_static_boundary_volume(p, ctx, engine, lp)
        if lp.dynamic_rigid_ids:
            p = mbase.compute_moving_boundary_volume(p, ctx, engine, lp)
        p = p._replace(is_dynamic=torch.where(ghost, -1, p.is_dynamic))
        self.init_metrics = self._pmax({
            "owned_particles_max": cnt["n_mine"],
            "halo_overflow": self._halo_overflow(cnt),
            "max_cell_occupancy": max_cell_occupancy(starts)})
        dev = self.device
        return SimState(
            p=p, rigid_rest_cm=rest_cm,
            dt=torch.full((), lp.dt0, dtype=torch.float32, device=dev),
            t=torch.zeros((), dtype=torch.float32, device=dev),
            step_count=torch.zeros((), dtype=torch.int32, device=dev))

    def initialize_replicated(self, particles: Particles) -> SimState:
        """The single-device initialize (sorted, volumes over the whole
        scene, on this rank's device), then this rank's slab of it: for
        checks against ``initialize``.  It runs the whole scene on every
        rank."""
        from sph_taichi_torch import build_solver

        state = build_solver(self.params, device=self.device).initialize(
            particles)
        mat = self._scatter_rows(state.p)
        return state._replace(p=_unpack(mat, self.layout))

    # ------------------------------------------------------------------
    def _ext_cell_ids(self, x, material):
        """Flat cell id on the slab's extended grid; a row outside it, or
        padding, -> the overflow cell."""
        ny, nz = self.params.grid_num[1], self.params.grid_num[2]
        cell = pos_to_cell(x, self.params.grid_size,
                           self.local_params.x_origin)
        gix = cell[:, 0]
        giy = torch.clamp(cell[:, 1], 0, ny - 1)
        giz = torch.clamp(cell[:, 2], 0, nz - 1)
        inside = (gix >= 0) & (gix < self.nxd + 2)
        flat = gix * (ny * nz) + giy * nz + giz
        return torch.where(inside & (material != MATERIAL_PAD), flat,
                           self.num_cells_ext)

    def _owner(self, mat):
        return owner_of(mat[:, COL_X], self.params, self.nxd, self.n_dev)

    def _material(self, mat):
        return torch.round(mat[:, COL_MATERIAL]).to(torch.int32)

    def _ids(self, mat):
        return self._ext_cell_ids(mat[:, COL_X:COL_X + 3],
                                  self._material(mat))

    def _window(self, n, start, cap):
        """Rows start .. start + cap, the start clamped so they fit (as
        ``lax.dynamic_slice`` clamps)."""
        start = torch.clamp(torch.as_tensor(start, device=self.device), 0,
                            n - cap)
        return start + torch.arange(cap, device=self.device)

    def _exchange(self, mat, start, cap, row_ok, direction):
        """``cap`` rows from ``start``, padding where not ``row_ok``, one
        hop in ``direction`` (+1: to the right neighbour)."""
        n, f = mat.shape
        rows = self._window(n, start, cap)
        block = torch.where(row_ok[rows][:, None], mat[rows],
                            pad_rows(cap, f, self.device))
        return self.comm.hop(block, direction)

    # ------------------------------------------------------------------
    def _relocalize(self, mat):
        """Drop the ghost and padding rows, classify and sort, migrate,
        sort, exchange the halo layers, sort: the slab's rows in its
        traversal order and its cell offsets (JAX ``_relocalize``)."""
        n, f = mat.shape
        lc = self.layer_cells
        ext = self.num_cells_ext
        rank = self.rank
        pad = pad_rows(n, f, self.device)

        # 1. last step's ghosts (is_dynamic -1) and padding rows re-parked
        drop = (mat[:, COL_DYNAMIC] < -0.5) | (self._material(mat)
                                               == MATERIAL_PAD)
        mat = torch.where(drop[:, None], pad, mat)

        # 2. classify and sort: mine by cell | leaving left | right | pad
        owner = self._owner(mat)
        is_pad = self._material(mat) == MATERIAL_PAD
        key_l, key_r = ext + 1, ext + 2
        key = torch.where(is_pad, ext + 3,
                          torch.where(owner < rank, key_l,
                                      torch.where(owner > rank, key_r,
                                                  self._ids(mat))))
        key, mat = _sort_mat(key, mat)
        n_mine = torch.sum(key < key_l)
        n_left = torch.sum(key == key_l)
        n_right = torch.sum(key == key_r)

        # 3. migration hops
        from_right = self._exchange(mat, n_mine, self.mig_cap, key == key_l,
                                    -1)
        from_left = self._exchange(mat, n_mine + n_left, self.mig_cap,
                                   key == key_r, +1)
        mat = torch.where(((key == key_l) | (key == key_r))[:, None], pad,
                          mat)
        mat = torch.cat([mat[:n - 2 * self.mig_cap], from_right, from_left])
        # arrivals that wrapped around the ring are dropped
        keep = ((self._owner(mat) == rank)
                | (self._material(mat) == MATERIAL_PAD))
        mat = torch.where(keep[:, None], mat, pad)
        n_owned = torch.sum(self._material(mat) != MATERIAL_PAD)

        # 4. sort the owned rows, send the boundary layers
        ids, mat = _sort_mat(self._ids(mat), mat)
        starts = cell_offsets(ids, ext)
        first_lo, first_hi = starts[lc], starts[2 * lc]
        last_lo = starts[self.nxd * lc]
        last_hi = starts[(self.nxd + 1) * lc]
        iota = torch.arange(n, device=self.device)
        in_first = (iota >= first_lo) & (iota < first_hi)
        in_last = (iota >= last_lo) & (iota < last_hi)
        ghosts = torch.cat([
            self._exchange(mat, last_lo, self.halo_cap, in_last, +1),
            self._exchange(mat, first_lo, self.halo_cap, in_first, -1)])
        gid = self._ids(ghosts)
        g_ok = (gid < ext) & ((gid < lc) | (gid >= (self.nxd + 1) * lc))
        ghosts = torch.where(g_ok[:, None], ghosts,
                             pad_rows(self.ghost_slots, f, self.device))
        ghosts[:, COL_DYNAMIC] = torch.where(g_ok, -1.0, 0.0)
        mat = torch.cat([mat[:n - self.ghost_slots], ghosts])

        # 5. the slab's traversal order
        ids, mat = _sort_mat(self._ids(mat), mat)
        starts = cell_offsets(ids, ext)
        cnt = {"n_mine": n_mine, "n_left": n_left, "n_right": n_right,
               "n_owned": n_owned, "first_lo": first_lo, "first_hi": first_hi,
               "last_lo": last_lo, "last_hi": last_hi}
        return mat, starts, cnt

    def _halo_overflow(self, cnt):
        return (torch.maximum(cnt["first_hi"] - cnt["first_lo"],
                              cnt["last_hi"] - cnt["last_lo"])
                > self.halo_cap)

    def _migration_overflow(self, cnt):
        """A migration block that does not hold the rows leaving, or more
        staying rows than the arrivals' slots leave room for, or more owned
        rows after the migration than the ghost slots leave room for: each
        loses particles."""
        n = self.n_ext
        return ((torch.maximum(cnt["n_left"], cnt["n_right"])
                 > self.mig_cap)
                | (cnt["n_mine"] > n - 2 * self.mig_cap)
                | (cnt["n_owned"] > n - self.ghost_slots))

    # ------------------------------------------------------------------
    def _make_ghost_sync(self, starts):
        """The ghost sync: refresh the ghost rows of per-row f32 tensors
        from their owners.

        Row correspondence: the step's halo exchange and this refresh both
        take the owner's boundary layer from its (stable-sorted) layer
        offset, so row t of the incoming block is ghost row dst + t on the
        receiver: the same rows, in the same cell order, truncated at the
        same halo_cap."""
        lc = self.layer_cells
        cap = self.halo_cap
        g_l = starts[lc]
        rg_start = starts[(self.nxd + 1) * lc]
        g_r = starts[(self.nxd + 2) * lc] - rg_start
        first_lo = starts[lc]
        last_lo = starts[self.nxd * lc]
        keep_l = (torch.arange(cap, device=self.device) < g_l)[:, None]
        keep_r = (torch.arange(cap, device=self.device) < g_r)[:, None]

        def hop(mat, src_lo, direction):
            return self.comm.hop(mat[self._window(mat.shape[0], src_lo,
                                                  cap)], direction)

        def merge(mat, blk, dst_lo, keep):
            rows = self._window(mat.shape[0], dst_lo, cap)
            mat = mat.clone()
            mat[rows] = torch.where(keep, blk, mat[rows])
            return mat

        def sync(tensors):
            if self.n_dev == 1:
                return tensors      # one rank has no ghost rows
            n = tensors[0].shape[0]
            cols = [t.reshape(n, -1) for t in tensors]
            for t in cols:
                if t.dtype != torch.float32:
                    raise TypeError(f"ghost sync of {t.dtype}, expected "
                                    f"float32")
            mat = torch.cat(cols, dim=1)
            # the left neighbour's last layer -> my left ghosts (rows from 0)
            mat = merge(mat, hop(mat, last_lo, +1), 0, keep_l)
            # the right neighbour's first layer -> my right ghosts
            mat = merge(mat, hop(mat, first_lo, -1), rg_start, keep_r)
            out, c = [], 0
            for t, col in zip(tensors, cols):
                w = col.shape[1]
                out.append(mat[:, c:c + w].reshape(t.shape).contiguous())
                c += w
            return out

        return sync

    def _unpack_step(self, mat):
        """The slab's Particles for a step, ghost rows not dynamic, and the
        ghost mask."""
        p = _unpack(mat, self.layout)
        ghost = p.is_dynamic < 0
        return p._replace(is_dynamic=torch.where(ghost, 0, p.is_dynamic)), \
            ghost

    def _step_ctx(self, p, ghost, starts):
        return StepCtx(
            engine_ctx=self.solver.engine.prepare(p.x, starts),
            ghost_sync=self._make_ghost_sync(starts), comm=self.comm,
            owned=(p.material != MATERIAL_PAD) & ~ghost)

    def _pmax(self, metrics):
        """The scalar metrics maxed across ranks in one reduction."""
        names = list(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k]).to(
            device=self.device, dtype=torch.float64).reshape(())
            for k in names])
        vals = self.comm.pmax(vals)
        return {k: vals[i].to(torch.as_tensor(metrics[k]).dtype)
                for i, k in enumerate(names)}

    # ------------------------------------------------------------------
    def step(self, state: SimState):
        """One step of this rank's slab; returns (new_state, metrics), the
        metrics the same on every rank (JAX ``_sharded_step``)."""
        lp = self.local_params
        engine = self.solver.engine
        self._template(state.p)
        mat, starts, cnt = self._relocalize(_pack(state.p, self.layout))
        p, ghost = self._unpack_step(mat)
        ctx = self._step_ctx(p, ghost, starts)
        if lp.n_solid > 0 and lp.dynamic_rigid_ids:
            p = mbase.compute_moving_boundary_volume(p, ctx, engine, lp)
        self.solver._boundary_fused = False
        p, sub_metrics = self.solver.substep(p, ctx, state.dt)
        p, rigid_info = mbase.solve_rigid_body(p, state.rigid_rest_cm, lp,
                                               self.comm)
        if not self.solver._boundary_fused:
            p = mbase.enforce_boundary(p, lp, MATERIAL_FLUID)
        p = p._replace(is_dynamic=torch.where(ghost, -1, p.is_dynamic))
        new_state = state._replace(
            p=p, t=state.t + state.dt, step_count=state.step_count + 1)

        metrics = dict(sub_metrics)
        metrics["rigid"] = rigid_info
        speed = torch.linalg.vector_norm(p.v, dim=-1)
        local = {"max_cell_occupancy": max_cell_occupancy(starts),
                 "max_velocity": torch.max(torch.where(
                     p.is_fluid() & ~ghost, speed, 0.0)),
                 "owned_particles_max": cnt["n_mine"],
                 "migration_overflow": self._migration_overflow(cnt).to(
                     torch.int32),
                 "halo_overflow": self._halo_overflow(cnt).to(torch.int32)}
        for k, v in engine.diag(ctx.engine_ctx).items():
            local[k] = v
        metrics.update(self._pmax(local))
        return new_state, metrics

    def owned_rows(self, state):
        """This rank's owned particles (not ghost, not padding) on its
        device."""
        keep = (state.p.material != MATERIAL_PAD) & (state.p.is_dynamic >= 0)
        return Particles(**{f: a[keep] for f, a in state.p._asdict().items()
                            if a is not None})

    def gather_particles(self, state, fields=None) -> Particles:
        """Every rank's owned particles, rank after rank, on the host
        (CPU tensors), on every rank: a collective.  ``fields``: the
        fields to gather (default all; the others None)."""
        mine = {f: a.cpu().numpy()
                for f, a in self.owned_rows(state)._asdict().items()
                if a is not None and (fields is None or f in fields)}
        parts = self.comm.gather_host(mine)
        return Particles(**{f: torch.from_numpy(np.concatenate(
            [q[f] for q in parts])) if f in parts[0] else None
            for f in Particles._fields})
