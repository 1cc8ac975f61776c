"""Shared SPH solver machinery (counterpart of sph_taichi_tpu/models/base.py).

- Re-binning: cell ids, stable sort, cell offsets, the engine's prepare.
- Akinci boundary volumes (sph_base.py:91-113, with the hardcoded 3.0).
- Domain-box collision (sph_base.py:118-179).
- Shape-matching rigid-body solve per dynamic object (sph_base.py:182-260),
  unrolled over the static object list in the reference's order.
- Step orchestration (sph_base.py:263-271).

Pair sums go through the engine of ``ops.pairs.make_engine``: the CUDA
kernels on the card, the plain GatherEngine on the CPU.  The reference's
atomic scatters onto rigid neighbours are gathers from the rigid side, so
every step is deterministic.  A step makes no host sync: metrics stay on
the device.

A step of a slab of a sharded run (parallel/sharding.py) hands the solvers
a ``StepCtx`` instead of the engine's bare context: it carries the ghost
sync that refreshes the ghost rows' copies of a field that a pair sum
wrote before a later one reads it at neighbours (``sync_fields``), the
communicator of the global reductions, and the rows the slab owns.  On one
device the bare context passes through the same calls unchanged.
"""

from typing import Any, Callable, NamedTuple, Optional

import torch

from sph_taichi_torch.state import (
    MATERIAL_FLUID, MATERIAL_PAD, MATERIAL_SOLID, Particles, SimParams,
    SimState, resolve_device)
from sph_taichi_torch.ops import cuda_dfsph, cuda_pairs
from sph_taichi_torch.ops.kernels import cubic_kernel
from sph_taichi_torch.ops.grid import (
    compute_cell_ids, sort_by_cell, cell_offsets, max_cell_occupancy)
from sph_taichi_torch.ops.linalg import polar_rotation
from sph_taichi_torch.ops.pairs import div_exact, make_engine, sqrt32


# ---------------------------------------------------------------------------
# step context: the engine's context, and a slab's ghost sync and reductions
# ---------------------------------------------------------------------------

class StepCtx(NamedTuple):
    """What a slab's step needs besides the engine's context: ``ghost_sync``
    maps a list of per-row f32 tensors to the same tensors with the ghost
    rows' values taken from their owners; ``comm`` reduces across ranks
    (parallel/comm.py); ``owned`` (bool[n]) marks the real rows the slab
    owns.  Single-device steps pass the bare engine context."""
    engine_ctx: Any
    ghost_sync: Optional[Callable] = None
    comm: Any = None
    owned: Optional[torch.Tensor] = None


def ectx(ctx):
    """The engine's context of ``ctx``, a ``StepCtx`` or a bare one."""
    return ctx.engine_ctx if isinstance(ctx, StepCtx) else ctx


def with_engine_ctx(ctx, engine_ctx):
    """``ctx`` with the engine context ``engine_ctx`` (the step's pair list
    that a density kernel returns): a ``StepCtx`` stays one."""
    if isinstance(ctx, StepCtx):
        return ctx._replace(engine_ctx=engine_ctx)
    return engine_ctx


def sharded(ctx):
    return isinstance(ctx, StepCtx) and ctx.ghost_sync is not None


def sync_tensors(ctx, *tensors):
    """The tensors (per-row f32, (n,) or (n, k)) with their ghost rows
    refreshed from the rows' owners; as they are on one device."""
    if not sharded(ctx):
        return tensors if len(tensors) > 1 else tensors[0]
    out = ctx.ghost_sync(list(tensors))
    return tuple(out) if len(out) > 1 else out[0]


def sync_fields(ctx, p: Particles, names):
    """``p`` with the ghost copies of the fields ``names`` refreshed (after
    the rows' owners recomputed them, before a pair sum reads them at
    neighbours); ``p`` itself on one device."""
    if not sharded(ctx):
        return p
    out = sync_tensors(ctx, *[getattr(p, n) for n in names])
    if len(names) == 1:
        out = (out,)
    return p._replace(**dict(zip(names, out)))


def owned_sum(ctx, t, n_real):
    """The sum of the per-row ``t`` over the real rows: on one device the
    first ``n_real`` rows (padding sorts to the tail); on a slab the rows
    it owns (owned and ghost rows interleave by cell), summed across
    ranks, so every rank holds the same value."""
    if not sharded(ctx):
        return torch.sum(t[:n_real])
    return ctx.comm.psum(torch.sum(torch.where(ctx.owned, t, 0.0)))


def owned_max(ctx, t):
    """The largest of the per-row ``t`` (>= 0 off the rows that count):
    over every row on one device, over the owned rows maxed across ranks
    on a slab."""
    if not sharded(ctx):
        return torch.amax(t)
    return ctx.comm.pmax(torch.amax(torch.where(ctx.owned, t, 0.0)))


def _psum(comm, t):
    return t if comm is None else comm.psum(t)


# ---------------------------------------------------------------------------
# neighbour-structure rebuild (reference initialize_particle_system, :372-375)
# ---------------------------------------------------------------------------

def object_tables(params, device):
    """Per-object constant tables of SimParams as device tensors, or None
    when the scene has none (built once per solver, not per step)."""
    if not params.obj_material:
        return None
    return {
        "material": torch.tensor(params.obj_material, dtype=torch.int32,
                                 device=device),
        "density": torch.tensor(params.obj_density0, dtype=torch.float32,
                                device=device),
        "is_dynamic": torch.tensor(params.obj_is_dynamic, dtype=torch.int32,
                                   device=device),
        # m tabled VERBATIM from creation values (recomputing
        # m_V0*density0 lands 1 ulp off creation's cast chain)
        "m": torch.tensor(params.obj_m0, dtype=torch.float32, device=device),
    }


def bin_and_sort(p: Particles, params: SimParams, engine, tables=None):
    """Re-bin particles into the grid, sort, and prepare the pair engine.

    Fields that are recomputed before any read in every step are not
    permuted (models/base.py of the JAX package has the per-method
    analysis): acc, color, pressure (except IISPH), x0 without dynamic
    rigids, and with per-object ``tables`` material / is_dynamic / m /
    density, which are restored from the tables after the sort.
    """
    transient = ["acc", "color"]
    if params.simulation_method != 2:
        transient.append("pressure")
    if not params.dynamic_rigid_ids:
        transient.append("x0")
    if tables is not None:
        transient += ["material", "is_dynamic", "m", "density"]
    cell_ids = compute_cell_ids(p.x, p.material, params.grid_size,
                                params.grid_num, params.x_origin)
    p, sorted_ids = sort_by_cell(p, cell_ids, extra_transient=transient)
    if tables is not None:
        oid = p.object_id
        pad_row = oid < 0
        safe = torch.clamp(oid, 0, len(params.obj_material) - 1).long()
        p = p._replace(
            material=torch.where(pad_row, MATERIAL_PAD,
                                 tables["material"][safe]),
            is_dynamic=torch.where(pad_row, 0, tables["is_dynamic"][safe]),
            density=torch.where(pad_row, 0.0, tables["density"][safe]),
            m=torch.where(pad_row, 0.0, tables["m"][safe]))
    starts = cell_offsets(sorted_ids, params.num_cells)
    ctx = engine.prepare(p.x, starts)
    diag = {"max_cell_occupancy": max_cell_occupancy(starts),
            # a silent sort corruption would poison every pair sum
            "sort_invariant_violated":
                torch.any(sorted_ids[1:] < sorted_ids[:-1])
                | (starts[-1] != p.n)}
    diag.update(engine.diag(ctx))
    return p, ctx, diag


# ---------------------------------------------------------------------------
# Akinci boundary volumes (sph_base.py:91-113)
# ---------------------------------------------------------------------------

# Up to this many solids the plain engines (GatherEngine, SlotGatherEngine)
# take the dense all-pairs W-sum instead of the traversal, as the JAX
# package does at the same cap (a TPU threshold: there the dense sum was the
# faster), so the CPU goldens and comparisons with it hold.  The CUDA
# engines take kernel c at every solid count: on an NVIDIA H100 80GB HBM3
# at 700 W the dense path took ~35 ms of a dragon_bath_dynamic_dfsph step
# at the contact for its 18,506 solids, kernel c 0.026 ms for the same
# volumes (chip_smoke.py).
DENSE_SOLID_CAP = 32768


def _boundary_volume_dense(p: Particles, params: SimParams, target_mask):
    """m_V = 3 / sum over all solids j of W(|x_i - x_j|), for solid i.

    Exact for few solids: pairs beyond h contribute W = 0 and the diagonal
    contributes W(0), the reference's explicit self term (sph_base.py:101).
    Direct subtraction in row chunks, not torch.cdist, whose matmul
    expansion rounds differently.
    """
    h = params.support_radius
    S = params.n_solid
    # the solids' indices in order, without a host sync (S is static)
    sidx = torch.sort((p.material != MATERIAL_SOLID).to(torch.int32),
                      stable=True).indices[:S]
    xs = p.x[sidx]                                    # (S, 3)
    delta = torch.cat([
        torch.sum(cubic_kernel(sqrt32(
            sum((xr[:, None, c] - xs[None, :, c]) ** 2 for c in range(3))),
            h, params.dim), dim=1)
        for xr in torch.split(xs, 512)])
    mv_full = torch.zeros_like(p.m_V)
    mv_full[sidx] = div_exact(3.0, delta)
    return p._replace(m_V=torch.where(target_mask, mv_full, p.m_V))


def _boundary_volume_engine(p: Particles, ctx, engine, params: SimParams,
                            target_mask):
    """Traversal m_V: kernel 2.1 c on the CUDA engines (every scene with
    solids), its plain version on the plain engines (scenes with more than
    DENSE_SOLID_CAP solids)."""
    volume = (cuda_pairs.boundary_volume if engine.fused
              else cuda_pairs.boundary_volume_plain)
    return p._replace(m_V=volume(ctx, p, target_mask, params))


def _boundary_volume(p, ctx, engine, params, target_mask):
    """A slab takes the traversal at every solid count (the dense sum sees
    only its own solids), then refreshes its ghosts' volumes."""
    if params.n_solid == 0:
        return p        # no solid row to update
    if engine.fused or sharded(ctx) or params.n_solid > DENSE_SOLID_CAP:
        p = _boundary_volume_engine(p, ectx(ctx), engine, params,
                                    target_mask)
        return sync_fields(ctx, p, ["m_V"])
    return _boundary_volume_dense(p, params, target_mask)


def compute_static_boundary_volume(p, ctx, engine, params):
    return _boundary_volume(p, ctx, engine, params, p.is_static_rigid())


def compute_moving_boundary_volume(p, ctx, engine, params):
    return _boundary_volume(p, ctx, engine, params, p.is_dynamic_rigid())


# ---------------------------------------------------------------------------
# domain-box collision (sph_base.py:118-179)
# ---------------------------------------------------------------------------

def enforce_boundary(p: Particles, params: SimParams, particle_type):
    """Clamp dynamic particles of ``particle_type`` into the padded box
    and reflect their velocity (c_f = 0.5)."""
    active = (p.material == particle_type) & (p.is_dynamic != 0)
    x, v = cuda_pairs.box_clamp(p.x, p.v, active, params)
    return p._replace(x=x, v=v)


# ---------------------------------------------------------------------------
# shape-matching rigid solve (sph_base.py:182-260)
# ---------------------------------------------------------------------------

# A rigid body may span slabs: with a communicator ``comm`` its sums run
# over this rank's dynamic rigid rows (a slab's ghost rows are not
# dynamic during its step) and then across ranks.

def _weighted_mean(w, x, comm):
    """sum w x / sum w over the rows (and across ranks, in one reduction)."""
    num, den = torch.sum(w[:, None] * x, dim=0), torch.sum(w)
    if comm is not None:
        sums = comm.psum(torch.cat([num, den[None]]))
        num, den = sums[:-1], sums[-1]
    return num / den


def compute_com(p: Particles, object_id, comm=None):
    """Mass-weighted COM over this object's dynamic rigid particles.
    Mass = m_V0 * density, the stored p.m (not the Akinci m_V),
    sph_base.py:188."""
    mask = p.is_dynamic_rigid() & (p.object_id == object_id)
    return _weighted_mean(torch.where(mask, p.m, 0.0), p.x, comm)


def solve_constraints(p: Particles, rest_cm, object_id, comm=None):
    """One shape-matching projection for one object (sph_base.py:200-222)."""
    mask = p.is_dynamic_rigid() & (p.object_id == object_id)
    w = torch.where(mask, p.m, 0.0)
    cm = _weighted_mean(w, p.x, comm)
    q = p.x0 - rest_cm[None, :]
    pv = p.x - cm[None, :]
    # A = sum m * p (x) q  (outer_product(p, q), sph_base.py:210)
    a = _psum(comm, torch.einsum("n,ni,nj->ij", w, pv, q))
    r = polar_rotation(a)
    goal = cm[None, :] + q @ r.T
    return p._replace(x=torch.where(mask[:, None], goal, p.x)), r, cm


def compute_rigid_rest_cm(p: Particles, params: SimParams, comm=None):
    """rigid_rest_cm per object id (sph_base.py:87-89); zeros for objects
    without dynamic rigid particles."""
    cms = []
    for obj in range(max(params.num_objects, 1)):
        if obj in params.dynamic_rigid_ids:
            cms.append(compute_com(p, obj, comm))
        else:
            cms.append(torch.zeros(params.dim, dtype=p.x.dtype,
                                   device=p.x.device))
    return torch.stack(cms, dim=0)


def solve_rigid_body(p: Particles, rest_cm, params: SimParams, comm=None):
    """Shape-match + solid box clamp per dynamic object, in the reference's
    order (sph_base.py:247-260)."""
    rots, cms = [], []
    for obj in params.dynamic_rigid_ids:
        p, r, cm = solve_constraints(p, rest_cm[obj], obj, comm)
        p = enforce_boundary(p, params, MATERIAL_SOLID)
        rots.append(r)
        cms.append(cm)
    if rots:
        rigid_info = {"R": torch.stack(rots), "cm": torch.stack(cms)}
    else:
        rigid_info = {"R": torch.zeros((0, 3, 3), dtype=p.x.dtype,
                                       device=p.x.device),
                      "cm": torch.zeros((0, params.dim), dtype=p.x.dtype,
                                        device=p.x.device)}
    return p, rigid_info


# ---------------------------------------------------------------------------
# the implicit solvers' Jacobi loop
# ---------------------------------------------------------------------------

# The Jacobi loops of the implicit solvers (DFSPH, IISPH) read their exit
# test to the host once every this many iterations.  A read makes the host
# wait for the card, but the host is only about one iteration ahead of it,
# so a read costs little; an
# iteration queued past convergence costs its host time (two launches that
# return at once and ~20 small torch ops) while the card has almost
# nothing to do.  On an H100 at dragon_bath_dfsph, where a solve takes 1-7
# iterations, k = 1 and 2 ran fastest and 4 and 8 slower (chip_smoke's
# sweep, PERF.md); 2 halves the reads of long solves and wastes at most one
# iteration per solve.
JACOBI_CHECK_EVERY = 2


def jacobi_while(cond, body, carry, every=JACOBI_CHECK_EVERY):
    """``lax.while_loop(cond, body, carry)`` with one host read of the
    test per ``every`` iterations.

    ``cond(carry)`` is a 0-d bool tensor; ``body(carry, active)`` returns
    the next carry (a tuple of tensors) and may use ``active`` to skip
    work.  Each iteration commits ``torch.where(active, new, old)``, so
    an iteration after the exit changes nothing.  Returns (carry, number
    of host reads)."""
    reads = 0
    active = cond(carry)
    while True:
        for _ in range(every):
            new = body(carry, active)
            carry = tuple(torch.where(active, a, b)
                          for a, b in zip(new, carry))
            active = cond(carry)
        reads += 1
        if not bool(active):
            return carry, reads


# ---------------------------------------------------------------------------
# solver base class
# ---------------------------------------------------------------------------

class SPHBase:
    """Owns the static params, the device, the pair engine and the object
    tables.  Subclasses implement ``substep(p, ctx, dt) -> (p, metrics)``.

    device: None means the CUDA device (state.resolve_device).  engine:
    defaults to ``make_engine`` for the device; passing a GatherEngine on
    a CUDA device runs the plain path there, to compare with the kernels.
    """

    def __init__(self, params: SimParams, device=None, engine=None):
        self.params = params
        self.device = resolve_device(device)
        self.density_0 = params.density0
        self.viscosity = params.viscosity
        self.engine = engine or make_engine(params, self.device)
        self.tables = object_tables(params, self.device)

    # -- public API ---------------------------------------------------------
    def initialize(self, particles: Particles) -> SimState:
        """Reference SPHBase.initialize (sph_base.py:80-85)."""
        params = self.params
        p, ctx, _ = bin_and_sort(particles, params, self.engine, self.tables)
        rest_cm = compute_rigid_rest_cm(p, params)
        p = compute_static_boundary_volume(p, ctx, self.engine, params)
        p = compute_moving_boundary_volume(p, ctx, self.engine, params)
        dev = p.x.device
        return SimState(
            p=p, rigid_rest_cm=rest_cm,
            dt=torch.full((), params.dt0, dtype=torch.float32, device=dev),
            t=torch.zeros((), dtype=torch.float32, device=dev),
            step_count=torch.zeros((), dtype=torch.int32, device=dev))

    def step(self, state: SimState):
        """One full step (reference SPHBase.step, sph_base.py:263-271);
        returns (new_state, metrics) with metrics on the device."""
        params = self.params
        if params.axis_name:
            raise ValueError(
                "a slab's solver steps through parallel.ShardedSolver, "
                "whose step carries its ghost sync and reductions")
        p, ctx, diag = bin_and_sort(state.p, params, self.engine, self.tables)
        if params.n_solid > 0 and params.dynamic_rigid_ids:
            p = compute_moving_boundary_volume(p, ctx, self.engine, params)
        self._boundary_fused = False
        p, sub_metrics = self.substep(p, ctx, state.dt)
        p, rigid_info = solve_rigid_body(p, state.rigid_rest_cm, params)
        # a solver may run the fluid box clamp in its last kernel; the
        # clamp commutes with the rigid solve (disjoint rows)
        if not self._boundary_fused:
            p = enforce_boundary(p, params, MATERIAL_FLUID)
        new_state = state._replace(
            p=p, t=state.t + state.dt, step_count=state.step_count + 1)
        metrics = dict(diag)
        metrics.update(sub_metrics)
        metrics["rigid"] = rigid_info
        speed = torch.linalg.vector_norm(p.v, dim=-1)
        metrics["max_velocity"] = torch.max(
            torch.where(p.is_fluid(), speed, 0.0))
        return new_state, metrics

    def substep(self, p, ctx, dt):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# pair sums shared by the solvers
# ---------------------------------------------------------------------------

def compute_densities(p: Particles, ctx, engine, params: SimParams):
    """rho_i = rho0 * (m_V_i*W(0) + sum_j m_V_j*W(r_ij)) for fluid centres;
    fluid and solid neighbours both contribute (WCSPH.py:19-43).  Solid and
    padding densities keep their stored values.  The solvers' steps take
    ``compute_densities_and_pairs``."""
    step, ctx = ctx, ectx(ctx)
    if engine.fused:
        den_pairs = cuda_pairs.density_sum(ctx, p, params)
    else:
        den_pairs = cuda_pairs.density_sum_plain(ctx, p.x, p.material,
                                                 p.m_V, params)
    return sync_fields(step, _with_density(p, den_pairs, params),
                       ["density"])


def compute_densities_and_pairs(p: Particles, ctx, engine, params: SimParams,
                                buffers=None):
    """``compute_densities`` for a step whose later pair kernels walk the
    same pairs at the same positions (WCSPH's forces, IISPH's four kernels,
    PCISPH's non-pressure kernel and loop): returns (p, the context those
    kernels read).  On the CUDA engine one kernel sums the densities and
    writes the step's pair list into ``buffers``
    (``cuda_pairs.density_sum_list``): a ``PairList`` over the cell
    offsets or the slot map, which those kernels read over either walk; on
    CPU tensors the context is the slot map or the plain engine's
    neighbour lists, and on the plain engine ``ctx``.  Given a
    ``StepCtx`` it refreshes the ghost densities and returns a ``StepCtx``
    over that context: the slab's step list holds its ghost rows as
    candidates, which the syncs keep current."""
    step, ctx = ctx, ectx(ctx)
    if engine.fused:
        den_pairs, ctx = cuda_pairs.density_sum_list(ctx, p, params, buffers)
    else:
        den_pairs = cuda_pairs.density_sum_plain(ctx, p.x, p.material,
                                                 p.m_V, params)
    p = sync_fields(step, _with_density(p, den_pairs, params), ["density"])
    return p, with_engine_ctx(step, ctx)


def _with_density(p, den_pairs, params):
    w0 = cubic_kernel(torch.zeros((), dtype=p.x.dtype, device=p.x.device),
                      params.support_radius, params.dim)
    density = (p.m_V * w0 + den_pairs) * params.density0
    return p._replace(density=torch.where(p.is_fluid(), density, p.density))


def compute_non_pressure_forces(p: Particles, ctx, engine, params: SimParams,
                                predict_dt=None):
    """Gravity for every dynamic particle; surface tension and viscosity
    pair sums for fluid centres (WCSPH.py:88-141 == DFSPH.py:50-102);
    static rigid and padding accelerations 0.  The reference's boundary
    viscosity is 0.0, so its reaction scatter is exactly zero and omitted.

    Two forms, as in the JAX package: without ``predict_dt`` (PCISPH) it
    sets p.acc; with it (DFSPH) it also applies the fluid velocity kick
    v += dt * acc (DFSPH.py:392-397), in the kernel's epilogue on the CUDA
    engine.  Padding rows keep their velocity and get acceleration 0.  On
    the CUDA engine ``ctx`` is the step's pair list (DFSPH's from
    ``density_factor_and_pairs``, PCISPH's from
    ``compute_densities_and_pairs``), over the cell runs or the slot map."""
    ctx = ectx(ctx)
    if predict_dt is None:
        accel = (cuda_dfsph.nonpressure_accel if engine.fused
                 else cuda_dfsph.nonpressure_accel_plain)
        return p._replace(acc=accel(ctx, p, params))
    kick = (cuda_dfsph.nonpressure_kick if engine.fused
            else cuda_dfsph.nonpressure_kick_plain)
    acc, v = kick(ctx, p, predict_dt, params)
    return p._replace(acc=acc, v=v)
