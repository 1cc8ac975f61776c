"""The DFSPH step's four pair traversals: CUDA kernels and their plain versions.

Ports the specializations of the Pallas TPU kernel ``BlockEngine._kernel``
(sph_taichi_tpu/ops/pallas_blocks.py) that the DFSPH path runs, as
hand-written CUDA C++ in ``csrc/dfsph.cu``:

- ``density_factor_list`` (and ``density_factor``): density and the alpha
  factor in one walk (models/dfsph.py density_and_factor); its kernel also
  writes every fluid centre's accepted neighbours, in the walk's order, to
  the step's pair list (ops/pair_list.py ``PairList``), which the
  non-pressure kernel reads over the cell runs, and over the slot walk
  every fluid and dynamic-rigid centre's, which the Jacobi kernels and the
  non-pressure kernel read;
- ``divergence``: the velocity divergence sum, with the epilogue of
  ``_density_change`` (mode "change") or ``_density_adv`` (mode "adv"),
  and the per-centre column of the average density error;
- ``solver_dv``: one Jacobi velocity update (``_solver_dv``), v + dt * dv
  on fluid centres and, with the reaction, acc + reaction on dynamic
  rigids;
- ``nonpressure_kick``: surface tension and viscosity, the acceleration
  select and the fluid velocity kick (models/base.py
  compute_non_pressure_forces with ``predict_dt``);
- ``nonpressure_accel``: the same kernel without the kick
  (``nonpressure_kick<false>``), the acceleration alone, as PCISPH calls
  compute_non_pressure_forces.

The same kernels port the retired ``SlotEngine._kernel``
(sph_taichi_tpu/ops/retired/pallas_slots.py): given a ``SlotMap``
(ops/slots.py, the context of ``CudaSlotEngine``) instead of cell offsets,
a wrapper launches the kernel's slot-walk instantiation and counts it
under ``"<name>[slots]"``.

Beside each kernel is its plain version (``*_plain``): the GatherEngine
traversal with the same term (over the slot lists for a ``SlotMap``),
then the unfused epilogue in torch.  A wrapper runs the plain version only
when its tensors lie on the CPU; on a CUDA tensor it launches the kernel
or raises.  Each launch adds one to ``LAUNCHES[name]``.

``divergence`` and ``solver_dv`` take an optional ``active`` flag, a 0-d
bool tensor on the device: when it is false the kernel returns at once and
its outputs are undefined (the Jacobi loop discards them).  The plain
versions ignore it.

Padding rows get what the JAX package's ``restore_tail`` gives them
(outputs that carry a field through keep its value, the others are 0):
every kernel writes them itself, so each wrapper launches one kernel and
nothing else.

``divergence`` and ``solver_dv`` walk the cell runs in two phases
(csrc/pair_common.cuh ``compact_cell_runs``): accepted pairs are
compacted into a list in shared memory before the pair body, in the
one-phase walk's order (a list that may fill is flushed).  Over the slot
walk they read the step's pair list (below).

The step's pair list: the positions do not move from the density-and-factor
kernel to the non-pressure kernel, and both walk the fluid centres.  Over
the cell runs ``density_factor_list`` writes the list while it sums, and
``nonpressure_kick`` runs only its pair body over it; on the PCISPH step
``nonpressure_accel`` reads the fluid rows of the step's list, which the
density kernel writes (ops/cuda_pairs.py ``density_sum_list``), as the
loop does.  A warp holding a centre with more
than ``PAIR_LIST_ENTRIES`` accepted pairs walks the cells in one phase
inside the kernel.  On the card the non-pressure wrappers take only a
``PairList``, not bare cell offsets (nor a bare ``SlotMap``, below); on CPU
tensors they take any context their plain versions read.

Over the slot walk the list goes to the Jacobi kernels too: the solves
move v, not x, so every Jacobi launch of the step accepts the pairs of the
density-and-factor kernel, which writes the list of the Jacobi kernels'
centres (fluid, and dynamic rigid for the reaction) in its one-phase slot
walk (``density_factor_list`` given a ``SlotMap`` returns a ``PairList``
over it).  ``divergence`` and ``solver_dv`` given that context run only
their pair body over the list (csrc/pair_common.cuh
``for_each_jacobi_pair``); a warp holding a centre over the list walks
the slot map in one phase.  On the card they refuse a bare ``SlotMap``
(ops/pair_list.py ``jacobi_walk``); on CPU tensors they take any context
their plain versions read.  ``nonpressure_kick`` reads the fluid rows of
that list over the slot walk too, and on the PCISPH step
``nonpressure_accel`` the fluid rows of the list that the density kernel
writes over the map (``density_sum_list`` given a ``SlotMap``): both run
only their pair body over it (csrc/pair_common.cuh
``for_each_step_pair``), and on the card take only a ``PairList``,
over the cell offsets or the map (ops/pair_list.py ``list_walk``), their
launcher refusing a launch without the list.
"""

import ctypes

import torch

from sph_taichi_torch.ops import pair_list
from sph_taichi_torch.ops.cuda_pairs import (
    WALK, _PTR, _active_ptr, _check, _plain_ctx, _raise_on, _stream, _walk,
    min_neighbors, pair_consts, M_EPS, PairConsts)
from sph_taichi_torch.ops.kernels import (
    cubic_kernel, cubic_kernel_derivative_scalar)
from sph_taichi_torch.ops.pairs import GatherEngine, div_exact
from sph_taichi_torch.ops.slots import SlotMap
from sph_taichi_torch.state import MATERIAL_FLUID, MATERIAL_SOLID

LAUNCHES = {name + walk: 0 for walk in ("", "[slots]") for name in (
    "dfsph_density_factor", "dfsph_divergence_change",
    "dfsph_divergence_adv", "dfsph_solver_dv", "nonpressure_kick",
    "nonpressure_accel")}
MODES = ("change", "adv")
# mirrors of csrc/pair_common.cuh kListEntries and kCompactUnroll: the
# accepted pairs a thread's list holds in the two-phase walk, and the
# candidates a lane tests between two checks of the lists
LIST_ENTRIES = 40
COMPACT_UNROLL = 8


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def density_factor_plain(nl, p, params):
    """(density, factor): rho0 (m_V_i W(0) + sum_j m_V_j W) and
    alpha = -1 / (|sum grad|^2 + sum_fluid |grad|^2) on fluid centres
    (DFSPH.py:37-47, 115-155); other rows keep their density, factor 0."""
    h = params.support_radius

    def term(fi, fj, d2, rn, dots):
        zero = torch.zeros_like(d2)
        real = fj["material"] >= 0
        w = cubic_kernel(rn, h, params.dim)
        gradw_s = cubic_kernel_derivative_scalar(rn, h, params.dim,
                                                 inv_r=dots["_inv"])
        gcoef = -fj["m_V"] * gradw_s
        sq = torch.where(fj["material"] == MATERIAL_FLUID,
                         gcoef * gcoef * d2, zero)
        return {"den": torch.where(real, fj["m_V"] * w, zero),
                "grad": torch.where(real, -gcoef, zero), "sq": sq}

    out = GatherEngine(params).traverse(
        nl, p.x, {"material": p.material, "m_V": p.m_V}, term,
        {"den": "scalar", "grad": "radial", "sq": "scalar"})
    fluid = p.is_fluid()
    w0 = cubic_kernel(torch.zeros((), dtype=p.x.dtype, device=p.x.device),
                      h, params.dim)
    den = p.m_V * w0 + out["den"]
    density = torch.where(fluid, den * params.density0, p.density)
    gx, gy, gz = out["grad"]
    s = out["sq"] + gx * gx + gy * gy + gz * gz
    factor = torch.where(s > 1e-6, div_exact(-1.0, s), 0.0)
    return density, torch.where(fluid, factor, 0.0)


def density_factor_list_plain(nl, p, params, centres="fluid"):
    """Plain version of ``density_factor_list``: (density, factor, idx,
    cnt), the ``density_factor_plain`` outputs and the step's pair list of
    ``centres`` (``pair_list.step_pairs_plain``: "fluid" over the cell
    runs, "jacobi", the fluid and dynamic-rigid centres, over the slot
    walk) from the plain engine's neighbour lists ``nl`` of ``p``."""
    return (*density_factor_plain(nl, p, params),
            *pair_list.step_pairs_plain(nl, p, centres))


def divergence_plain(nl, p, v, density, dt, mode, params, active=None):
    """(adv, errt).  The pair sum is sum_j m_V_j gradW . (v_ij . r_ij)
    over real j.  mode "change" (DFSPH.py:158-194): max(div, 0), 0 below
    the neighbour cutoff, errt = rho0 adv.  mode "adv" (DFSPH.py:197-218):
    max(density / rho0 + dt div, 1), errt = rho0 adv - rho0.  Both 0 off
    fluid centres."""
    h = params.support_radius
    change = mode == "change"

    def term(fi, fj, d2, rn, dots):
        zero = torch.zeros_like(d2)
        real = fj["material"] >= 0
        gradw_s = cubic_kernel_derivative_scalar(rn, h, params.dim,
                                                 inv_r=dots["_inv"])
        out = {"div": torch.where(real, fj["m_V"] * gradw_s * dots["v"],
                                  zero)}
        if change:
            out["cnt"] = real.to(d2.dtype)
        return out

    specs = {"div": "scalar"}
    if change:
        specs["cnt"] = "scalar"
    out = GatherEngine(params).traverse(
        nl, p.x, {"material": p.material, "m_V": p.m_V, "v0": v[:, 0],
                  "v1": v[:, 1], "v2": v[:, 2]}, term, specs,
        pair_dots=("v",))
    fluid = p.is_fluid()
    rho0 = params.density0
    if change:
        adv = torch.clamp_min(out["div"], 0.0)
        adv = torch.where(out["cnt"] < min_neighbors(params.dim), 0.0, adv)
        adv = torch.where(fluid, adv, 0.0)
        return adv, torch.where(fluid, rho0 * adv, 0.0)
    adv = div_exact(density, rho0) + dt * out["div"]
    adv = torch.where(fluid, torch.clamp_min(adv, 1.0), 0.0)
    return adv, torch.where(fluid, rho0 * adv - rho0, 0.0)


def solver_dv_plain(nl, p, kappa, v, acc, dt, react, params, active=None):
    """(v, acc): one Jacobi velocity update (DFSPH.py:289-311, 364-389).
    dv_i = sum_fluid_j (k_i + k_j) m_V_j gradW + sum_solid_j k_i m_V_j gradW
    (each gated on |k| > m_eps); v + dt dv on fluid centres.  With
    ``react`` the same radial output carries, on dynamic-rigid centres,
    the gathered reaction sum_fluid_k k_k rho_k gradW m_V_c / rho_c, added
    to acc there; acc is None otherwise."""
    h = params.support_radius

    def term(fi, fj, d2, rn, dots):
        zero = torch.zeros_like(d2)
        gradw_s = cubic_kernel_derivative_scalar(rn, h, params.dim,
                                                 inv_r=dots["_inv"])
        fluid_j = fj["material"] == MATERIAL_FLUID
        solid_j = fj["material"] == MATERIAL_SOLID
        k_i, k_j = fi["kappa"], fj["kappa"]
        k_sum = k_i + k_j
        coef_fluid = torch.where(fluid_j & (torch.abs(k_sum) > M_EPS),
                                 k_sum * fj["m_V"] * gradw_s, zero)
        coef_solid = torch.where(solid_j & (torch.abs(k_i) > M_EPS),
                                 k_i * fj["m_V"] * gradw_s, zero)
        dv_coef = coef_fluid + coef_solid
        if react:
            reaction = torch.where(
                fluid_j & (torch.abs(k_j) > M_EPS),
                (k_j * fj["density"]) * gradw_s, zero) \
                * (fi["m_V"] / torch.clamp_min(fi["density"], 1e-30))
            dv_coef = torch.where(fi["material"] == MATERIAL_FLUID, dv_coef,
                                  reaction)
        return {"dv": dv_coef}

    fields = {"material": p.material, "m_V": p.m_V, "kappa": kappa}
    if react:
        fields["density"] = p.density
    out = GatherEngine(params).traverse(nl, p.x, fields, term,
                                        {"dv": "radial"})
    raw = torch.stack(out["dv"], dim=1)
    v = torch.where(p.is_fluid()[:, None], v + dt * raw, v)
    if react:
        acc = torch.where(p.is_dynamic_rigid()[:, None], acc + raw, acc)
    return v, (acc if react else None)


def nonpressure_accel_plain(nl, p, params):
    """Gravity for every dynamic particle plus surface tension and
    viscosity for fluid centres (DFSPH.py:50-102); static rigid and
    padding rows 0.  The boundary viscosity is 0.0, so solids add
    nothing."""
    h = params.support_radius
    dim = params.dim
    diameter = params.particle_diameter

    def term(fi, fj, d2, rn, dots):
        zero = torch.zeros_like(d2)
        fluid_j = fj["material"] == MATERIAL_FLUID
        w = cubic_kernel(rn, h, dim)
        wd = cubic_kernel(torch.full((), diameter, dtype=rn.dtype,
                                     device=rn.device), h, dim)
        w_st = torch.where(d2 > diameter * diameter, w, wd)
        st_coef = torch.where(
            fluid_j, -div_exact(params.surface_tension, fi["m"]) * fj["m"]
            * w_st, zero)
        gradw_s = cubic_kernel_derivative_scalar(rn, h, dim,
                                                 inv_r=dots["_inv"])
        visc_coef = torch.where(
            fluid_j,
            2.0 * (dim + 2.0) * params.viscosity
            * (fj["m"] / fj["density"]) * dots["v"] / (d2 + 0.01 * h * h)
            * gradw_s, zero)
        return {"a": st_coef + visc_coef}

    out = GatherEngine(params).traverse(
        nl, p.x, {"material": p.material, "m": p.m, "density": p.density,
                  "v0": p.v[:, 0], "v1": p.v[:, 1], "v2": p.v[:, 2]},
        term, {"a": "radial"}, pair_dots=("v",))
    a_pair = torch.stack(out["a"], dim=1)
    zero = torch.zeros_like(a_pair)
    acc = torch.where(p.is_fluid()[:, None], a_pair, zero)
    acc = torch.stack([g + acc[:, k] for k, g in enumerate(params.gravity)],
                      dim=1)
    acc = torch.where(p.is_static_rigid()[:, None], zero, acc)
    return torch.where((p.material < 0)[:, None], zero, acc)


def predict_velocity(p, acc, dt):
    """Fluid-only v += dt * acc (DFSPH.py:392-397)."""
    kick = (p.is_fluid() & (p.is_dynamic != 0))[:, None]
    return torch.where(kick, p.v + dt * acc, p.v)


def nonpressure_kick_plain(nl, p, dt, params):
    """Plain version of ``nonpressure_kick``: (acc, v)."""
    acc = nonpressure_accel_plain(nl, p, params)
    return acc, predict_velocity(p, acc, dt)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    from sph_taichi_torch.ops import _build
    lib = _build.load("dfsph")
    if not getattr(lib, "_typed", False):
        i32 = ctypes.c_int
        lib.dfsph_density_factor_list_launch.argtypes = (
            [_PTR] * 5 + WALK + [_PTR] * 4 + [i32, PairConsts, _PTR])
        lib.dfsph_divergence_launch.argtypes = (
            [_PTR] * 5 + WALK + [_PTR] * 6 + [i32] * 2 + [PairConsts, _PTR])
        lib.dfsph_solver_dv_launch.argtypes = (
            [_PTR] * 8 + WALK + [_PTR] * 6 + [i32] * 2 + [PairConsts, _PTR])
        for fn in (lib.dfsph_jacobi_occupancy, lib.dfsph_occupancy):
            fn.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
        lib.nonpressure_kick_launch.argtypes = (
            [_PTR] * 6 + WALK + [_PTR] * 5 + [i32, PairConsts, _PTR])
        lib.nonpressure_accel_launch.argtypes = (
            [_PTR] * 6 + WALK + [_PTR] * 3 + [i32, PairConsts, _PTR])
        for fn in (lib.dfsph_density_factor_list_launch,
                   lib.dfsph_divergence_launch, lib.dfsph_solver_dv_launch,
                   lib.dfsph_jacobi_occupancy, lib.dfsph_occupancy,
                   lib.nonpressure_kick_launch,
                   lib.nonpressure_accel_launch,
                   lib.dfsph_pair_list_entries):
            fn.restype = i32
        pair_list.check_entries(lib.dfsph_pair_list_entries(), "DFSPH")
        lib._typed = True
    return lib


def density_factor_list(ctx, p, params, buffers=None):
    """The density and factor of the DFSPH step, with the context of the
    kernels that read its pairs: (density, factor, ctx').  Given the cell
    offsets of the sorted particles ``p``, or their ``SlotMap``, one launch
    of ``dfsph_density_factor_list`` (``dfsph_density_factor_slot`` over
    the slot walk) computes both and writes every fluid centre's accepted
    pairs (over the slot walk also every dynamic-rigid centre's:
    ``density_factor_list_plain`` with centres "jacobi") to a ``PairList``
    over that walk in ``buffers`` (a dict, filled with the list's tensors
    at the first call and reused after; None: new tensors).  On CPU
    tensors the plain version over the context's neighbour lists, and,
    given cell offsets, those lists, which the plain versions read
    (``density_factor_list_plain`` gives them in the list's layout); given
    a ``SlotMap``, the map."""
    if p.x.device.type == "cpu":
        nl = _plain_ctx(ctx, p, params)
        return (*density_factor_plain(nl, p, params),
                ctx if isinstance(ctx, SlotMap) else nl)
    dev, n, ptr, walk, suffix = _walk(ctx, p, params)
    idx, cnt = pair_list.list_buffers(buffers, n, dev)
    density = torch.empty_like(p.m_V)
    factor = torch.empty_like(p.m_V)
    rc = _lib().dfsph_density_factor_list_launch(
        ptr["x"], ptr["material"],
        _check("is_dynamic", p.is_dynamic, torch.int32, (n,), dev),
        ptr["m_V"], _check("density", p.density, torch.float32, (n,), dev),
        *walk, idx.data_ptr(), cnt.data_ptr(), density.data_ptr(),
        factor.data_ptr(), n, pair_consts(params), _stream(dev))
    name = "dfsph_density_factor" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return density, factor, pair_list.PairList(ctx, idx, cnt)


def density_factor(ctx, p, params):
    """Kernel wrapper for ``density_factor_plain``: (density, factor), the
    first two outputs of ``density_factor_list`` (its list goes to new
    tensors).  ``ctx``: the cell offsets of the sorted particles ``p``
    (ops.grid.cell_offsets), or their ``SlotMap`` for the slot walk."""
    return density_factor_list(ctx, p, params)[:2]


def divergence(ctx, p, v, density, dt, mode, params, active=None):
    """Kernel wrapper for ``divergence_plain``: (adv, errt).  ``ctx``: the
    cell offsets of the sorted particles ``p`` or a ``PairList`` over them
    (the two-phase kernel), or the ``PairList`` over their ``SlotMap`` that
    ``density_factor_list`` gives (the list kernel); on CPU tensors also a
    bare ``SlotMap`` or neighbour lists.  ``density`` and ``dt`` (a 0-d f32
    tensor on the device) are read in mode "adv" only."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}, expected one of {MODES}")
    if p.x.device.type == "cpu":
        return divergence_plain(_plain_ctx(ctx, p, params), p, v,
                                density, dt, mode, params)
    dev, n, ptr, walk, suffix, lst = pair_list.jacobi_walk(ctx, p, params)
    f32 = torch.float32
    is_adv = mode == "adv"
    adv = torch.empty_like(p.m_V)
    errt = torch.empty_like(p.m_V)
    rc = _lib().dfsph_divergence_launch(
        ptr["x"], _check("v", v, f32, (n, 3), dev), ptr["material"],
        ptr["m_V"],
        _check("density", density, f32, (n,), dev) if is_adv else None,
        *walk, *lst, _check("dt", dt, f32, (), dev) if is_adv else None,
        _active_ptr(active, dev), adv.data_ptr(), errt.data_ptr(),
        int(is_adv), n, pair_consts(params), _stream(dev))
    name = f"dfsph_divergence_{mode}" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return adv, errt


def solver_dv(ctx, p, kappa, v, acc, dt, react, params, active=None):
    """Kernel wrapper for ``solver_dv_plain``: (v, acc or None).  ``ctx``
    as for ``divergence``."""
    if p.x.device.type == "cpu":
        return solver_dv_plain(_plain_ctx(ctx, p, params), p, kappa, v,
                               acc, dt, react, params)
    dev, n, ptr, walk, suffix, lst = pair_list.jacobi_walk(ctx, p, params)
    f32 = torch.float32
    v_out = torch.empty_like(v)
    acc_out = torch.empty_like(acc) if react else None
    rc = _lib().dfsph_solver_dv_launch(
        ptr["x"], ptr["material"],
        _check("is_dynamic", p.is_dynamic, torch.int32, (n,), dev),
        ptr["m_V"], _check("kappa", kappa, f32, (n,), dev),
        _check("density", p.density, f32, (n,), dev) if react else None,
        _check("v", v, f32, (n, 3), dev),
        _check("acc", acc, f32, (n, 3), dev) if react else None, *walk,
        *lst, _check("dt", dt, f32, (), dev), _active_ptr(active, dev),
        v_out.data_ptr(), acc_out.data_ptr() if react else None, int(react),
        n, pair_consts(params), _stream(dev))
    name = "dfsph_solver_dv" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return v_out, acc_out


def jacobi_occupancy(kernel, variant, slots=False):
    """(registers per thread, shared memory bytes per block, resident
    blocks of 128 threads per SM) of a Jacobi kernel on the current CUDA
    device: ``kernel`` "divergence" (``variant``: ADV) or "solver_dv"
    (``variant``: REACT), over the slot walk with ``slots``."""
    which = int(bool(variant)) | (2 if kernel == "solver_dv" else 0) \
        | (4 if slots else 0)
    out = [ctypes.c_int() for _ in range(3)]
    rc = _lib().dfsph_jacobi_occupancy(
        which, *[ctypes.byref(o) for o in out])
    _raise_on(rc, f"dfsph_jacobi_occupancy({kernel})")
    return tuple(o.value for o in out)


def occupancy(kernel, slots=False):
    """(registers per thread, static shared memory bytes per block,
    resident blocks of 128 threads per SM) of ``kernel`` on the current
    CUDA device: "density_factor_list" (over the cell runs),
    "density_factor" (over the slot walk, with the list),
    "nonpressure_kick" or "nonpressure_accel" (over the cell runs, or the
    slot walk with ``slots``)."""
    which = {("density_factor_list", False): 0,
             ("density_factor", True): 1,
             ("nonpressure_kick", False): 2, ("nonpressure_accel", False): 3,
             ("nonpressure_kick", True): 4,
             ("nonpressure_accel", True): 5}[kernel, bool(slots)]
    out = [ctypes.c_int() for _ in range(3)]
    rc = _lib().dfsph_occupancy(which, *[ctypes.byref(o) for o in out])
    _raise_on(rc, f"dfsph_occupancy({kernel})")
    return tuple(o.value for o in out)


def _nonpressure_args(ctx, p, params):
    """The context check and the input pointers of the non-pressure kernel:
    (device, n, launch-count suffix, its arguments up to the list)."""
    dev, n, ptr, walk, suffix, lst = pair_list.list_walk(
        ctx, p, params, "nonpressure_kick",
        source="density_factor_list (DFSPH) or density_sum_list (PCISPH)")
    f32 = torch.float32
    return dev, n, suffix, [
        ptr["x"], _check("v", p.v, f32, (n, 3), dev), ptr["material"],
        _check("is_dynamic", p.is_dynamic, torch.int32, (n,), dev),
        _check("m", p.m, f32, (n,), dev),
        _check("density", p.density, f32, (n,), dev), *walk, *lst]


def nonpressure_kick(ctx, p, dt, params):
    """Kernel wrapper for ``nonpressure_kick_plain``: (acc, v).  ``ctx``:
    the step's context from ``density_factor_list`` for the sorted
    particles ``p``, a ``PairList`` over their cell offsets or their
    ``SlotMap`` (the slot walk); on CPU tensors also their neighbour lists,
    cell offsets or a bare ``SlotMap``.  ``dt`` is a 0-d f32 tensor on the
    particles' device."""
    if p.x.device.type == "cpu":
        return nonpressure_kick_plain(_plain_ctx(ctx, p, params), p, dt,
                                      params)
    dev, n, suffix, args = _nonpressure_args(ctx, p, params)
    acc = torch.empty_like(p.x)
    v_out = torch.empty_like(p.v)
    rc = _lib().nonpressure_kick_launch(
        *args, _check("dt", dt, torch.float32, (), dev), acc.data_ptr(),
        v_out.data_ptr(), n, pair_consts(params), _stream(dev))
    name = "nonpressure_kick" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return acc, v_out


def nonpressure_accel(ctx, p, params):
    """Kernel wrapper for ``nonpressure_accel_plain``: acc, from the kernel
    of ``nonpressure_kick`` without its kick (v is not written).  ``ctx``:
    the PCISPH step's context from ``cuda_pairs.density_sum_list``, a
    ``PairList`` over the cell offsets or the ``SlotMap`` (the slot walk);
    on CPU tensors also neighbour lists, cell offsets or a bare
    ``SlotMap``."""
    if p.x.device.type == "cpu":
        return nonpressure_accel_plain(_plain_ctx(ctx, p, params), p,
                                       params)
    dev, n, suffix, args = _nonpressure_args(ctx, p, params)
    acc = torch.empty_like(p.x)
    rc = _lib().nonpressure_accel_launch(
        *args, acc.data_ptr(), n, pair_consts(params), _stream(dev))
    name = "nonpressure_accel" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return acc
