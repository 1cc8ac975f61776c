"""The IISPH step's four pair traversals: CUDA kernels and their plain versions.

Ports the specializations of the Pallas TPU kernel ``BlockEngine._kernel``
(sph_taichi_tpu/ops/pallas_blocks.py) that the IISPH path
(sph_taichi_tpu/models/iisph.py) runs, as hand-written CUDA C++ in
``csrc/iisph.cu``:

- ``nonpressure_kick``: gravity plus the fluid viscosity sum on every real
  centre, and the fluid kick v* = v + dt * acc (``compute_non_pressure``
  with its epilogue);
- ``predict_advection``: the four sums of ``predict_advection`` in one
  walk, with a_ii, the source term and the warm start 0.5 p;
- ``pressure_accel``: the symmetric pressure acceleration with the solid
  mirror (``_pressure_accel``), or with ``advect_dt`` its advect epilogue
  v' = v* + dt a_p, x' = x + dt v' on fluid rows;
- ``apply_A``: sum_j m_V_j dW (a_i - a_j) . r_ij (``_apply_A``) with the
  relaxed-Jacobi update and the per-centre error column.

The same kernels port the retired ``SlotEngine._kernel``
(sph_taichi_tpu/ops/retired/pallas_slots.py): given a ``SlotMap``
(ops/slots.py, the context of ``CudaSlotEngine``) instead of cell offsets,
a wrapper launches the kernel's slot-walk instantiation and counts it
under ``"<name>[slots]"``.

Beside each kernel is its plain version (``*_plain``): the GatherEngine
traversal with the same term (over the slot lists for a ``SlotMap``),
then the same epilogue in torch, in the JAX package's operation order.  A
wrapper runs the plain version only when its tensors lie on the CPU; on a
CUDA tensor it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``.

``pressure_accel`` (without ``advect_dt``) and ``apply_A`` run inside the
Jacobi loop and take an optional ``active`` flag, a 0-d bool tensor on the
device: when it is false the kernel returns at once and its outputs are
undefined (the loop discards them).  The plain versions ignore it.

The positions stay the sort's from the density kernel to the advect (f1's
kick moves v, not x), so all four kernels read the step's pair list of
every real centre, solids included (ops/pair_list.py ``PairList``), which
the step's density kernel writes as it sums (ops/cuda_pairs.py
``density_sum_list``, models/base.py ``compute_densities_and_pairs``),
over the cell offsets or over the ``SlotMap``; given it, they run only the
pair body over it (csrc/pair_common.cuh ``for_each_step_pair``; a warp
holding a centre over the list walks the cells or the map in one phase).
On the card these wrappers take only that context, not bare cell offsets
or a bare ``SlotMap`` (ops/pair_list.py ``list_walk``), and their
launchers refuse a launch without the list; on CPU tensors the step's
context is the plain engine's neighbour lists, or the slot map, whose
lists the plain versions read.

Padding rows: every kernel writes them, over both walks, as the JAX
package's ``restore_tail`` gives them (outputs that carry a field through
keep its value, the others are 0), so each wrapper call launches exactly
one kernel.
"""

import ctypes

import torch

from sph_taichi_torch.ops import pair_list
from sph_taichi_torch.ops.cuda_pairs import (
    WALK, _PTR, _active_ptr, _check, _raise_on, _stream, pair_consts,
    PairConsts)
from sph_taichi_torch.ops.kernels import cubic_kernel_derivative_scalar
from sph_taichi_torch.ops.pairs import GatherEngine, div_exact
from sph_taichi_torch.state import MATERIAL_FLUID, MATERIAL_SOLID

LAUNCHES = {name + walk: 0 for walk in ("", "[slots]") for name in (
    "iisph_nonpressure_kick", "iisph_predict_advection",
    "iisph_pressure_accel", "iisph_pressure_accel_advect", "iisph_apply_A")}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def nonpressure_kick_plain(nl, p, dt, params):
    """(acc, v*): acc = g + sum over fluid j of the viscosity term on every
    real centre, 0 on padding (IISPH.py:236-249); v* = v + dt * acc on
    fluid rows (IISPH.py:73-75)."""
    h = params.support_radius
    dvisc = 2.0 * (params.dim + 2.0) * params.viscosity

    def term(fi, fj, d2, rn, dots):
        gradw_s = cubic_kernel_derivative_scalar(rn, h, params.dim,
                                                 inv_r=dots["_inv"])
        coef = (dvisc * (fj["m"] / fj["density"]) * dots["v"]
                / (d2 + 0.01 * h * h) * gradw_s)
        return {"a": torch.where(fj["material"] == MATERIAL_FLUID, coef,
                                 torch.zeros_like(coef))}

    out = GatherEngine(params).traverse(
        nl, p.x, {"material": p.material, "m": p.m, "density": p.density,
                  "v0": p.v[:, 0], "v1": p.v[:, 1], "v2": p.v[:, 2]},
        term, {"a": "radial"}, pair_dots=("v",))
    acc = torch.stack([g + out["a"][k] for k, g in enumerate(params.gravity)],
                      dim=1)
    acc = torch.where((p.material < 0)[:, None], 0.0, acc)
    v = torch.where(p.is_fluid()[:, None], p.v + dt * acc, p.v)
    return acc, v


def predict_advection_plain(nl, p, dt, params):
    """(a_ii, source, last_p) from v* in ``p.v`` (IISPH.py:20-100):
    a_ii = dt^2 rho0^2 (-S.G - (m_V_i / rho_i^2) Q), with G, S, Q the sums
    over real j of m_V_j dW, m_V_j dW / rho_j^2 and m_V_j |dW|^2;
    source = rho0 - rho_i - dt div rho0; last_p = 0.5 p.  0 on padding."""
    h = params.support_radius

    def term(fi, fj, d2, rn, dots):
        gradw_s = cubic_kernel_derivative_scalar(rn, h, params.dim,
                                                 inv_r=dots["_inv"])
        mg = torch.where(fj["material"] >= 0, fj["m_V"] * gradw_s,
                         torch.zeros_like(gradw_s))
        return {"g": mg, "s": mg / (fj["density"] * fj["density"]),
                "q": mg * gradw_s * d2, "div": mg * dots["v"]}

    out = GatherEngine(params).traverse(
        nl, p.x, {"material": p.material, "m_V": p.m_V,
                  "density": p.density, "v0": p.v[:, 0], "v1": p.v[:, 1],
                  "v2": p.v[:, 2]}, term,
        {"g": "radial", "s": "radial", "q": "scalar", "div": "scalar"},
        pair_dots=("v",))
    rho0 = params.density0
    gx, gy, gz = out["g"]
    sx, sy, sz = out["s"]
    dot_sg = sx * gx + sy * gy + sz * gz
    rho2 = p.density * p.density
    a_ii = (dt * dt) * (rho0 * rho0) * (-dot_sg - (p.m_V / rho2) * out["q"])
    source = rho0 - p.density - dt * out["div"] * rho0
    last_p = 0.5 * p.pressure
    real = p.material >= 0
    return tuple(torch.where(real, a, 0.0) for a in (a_ii, source, last_p))


def pressure_accel_plain(nl, p, pressure, params, advect_dt=None,
                         active=None):
    """Plain version of ``pressure_accel``: the (N, 3) symmetric pressure
    acceleration over fluid and solid j, -rho0 m_V_j (p_i / rho_i^2 +
    p_j / rho_j^2) dW r_ij, with the solid mirror p_j / rho_j^2 :=
    p_i / rho0^2 (IISPH.py:114-144), on every real centre and 0 on
    padding; or with ``advect_dt`` the advected (v, x)."""
    h = params.support_radius
    rho0 = params.density0

    def term(fi, fj, d2, rn, dots):
        fluid_j = fj["material"] == MATERIAL_FLUID
        solid_j = fj["material"] == MATERIAL_SOLID
        gradw_s = cubic_kernel_derivative_scalar(rn, h, params.dim,
                                                 inv_r=dots["_inv"])
        dpi = fi["pr"] / (fi["density"] * fi["density"])
        dpj = torch.where(fluid_j,
                          fj["pr"] / (fj["density"] * fj["density"]),
                          div_exact(fi["pr"], rho0 * rho0))
        coef = -rho0 * fj["m_V"] * (dpi + dpj) * gradw_s
        return {"ap": torch.where(fluid_j | solid_j, coef,
                                  torch.zeros_like(coef))}

    out = GatherEngine(params).traverse(
        nl, p.x, {"material": p.material, "m_V": p.m_V,
                  "density": p.density, "pr": pressure}, term,
        {"ap": "radial"})
    accel = torch.where((p.material < 0)[:, None], 0.0,
                        torch.stack(out["ap"], dim=1))
    if advect_dt is None:
        return accel
    return advect(p, accel, advect_dt)


def advect(p, accel, dt):
    """(v, x): fluid only, v += dt * a_p (v holds v*), x += dt * v
    (IISPH.py:251-257)."""
    fluid = p.is_fluid()[:, None]
    v = torch.where(fluid, p.v + dt * accel, p.v)
    return v, torch.where(fluid, p.x + dt * v, p.x)


def apply_A_sum_plain(nl, p, accel, params):
    """sum over real j of m_V_j dW (a_i - a_j) . r_ij (IISPH.py:146-163,
    without the factor dt^2 rho0)."""
    h = params.support_radius

    def term(fi, fj, d2, rn, dots):
        gradw_s = cubic_kernel_derivative_scalar(rn, h, params.dim,
                                                 inv_r=dots["_inv"])
        return {"ap": torch.where(fj["material"] >= 0,
                                  fj["m_V"] * gradw_s * dots["a"],
                                  torch.zeros_like(gradw_s))}

    return GatherEngine(params).traverse(
        nl, p.x, {"material": p.material, "m_V": p.m_V,
                  "a0": accel[:, 0], "a1": accel[:, 1], "a2": accel[:, 2]},
        term, {"ap": "scalar"}, pair_dots=("a",))["ap"]


def apply_A_plain(nl, p, accel, a_ii, source, last_p, dt, omega, params,
                  active=None):
    """Plain version of ``apply_A``: (new_p, err) of one relaxed-Jacobi
    iteration (IISPH.py:146-179).  Ap = (sum dt^2) rho0; new_p =
    max(last_p + omega (source - Ap) / a_ii, 0) where |a_ii| > 1e-6, else
    0, and 0 off real rows; err = |Ap - source| / rho0 on real rows where
    new_p != 0."""
    rho0 = params.density0
    ap = apply_A_sum_plain(nl, p, accel, params) * (dt * dt) * rho0
    new_p = torch.where(
        torch.abs(a_ii) > 1e-6,
        torch.clamp_min(last_p + omega * (source - ap) / a_ii, 0.0), 0.0)
    real = p.material >= 0
    new_p = torch.where(real, new_p, 0.0)
    err = torch.where(real & (new_p != 0.0),
                      div_exact(torch.abs(ap - source), rho0), 0.0)
    return new_p, err


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    from sph_taichi_torch.ops import _build
    lib = _build.load("iisph")
    if not getattr(lib, "_typed", False):
        i32 = ctypes.c_int
        lib.iisph_nonpressure_kick_launch.argtypes = (
            [_PTR] * 5 + WALK + [_PTR] * 5 + [i32, PairConsts, _PTR])
        lib.iisph_predict_advection_launch.argtypes = (
            [_PTR] * 6 + WALK + [_PTR] * 6 + [i32, PairConsts, _PTR])
        lib.iisph_pressure_accel_launch.argtypes = (
            [_PTR] * 5 + WALK + [_PTR] * 7 + [i32, i32, PairConsts, _PTR])
        lib.iisph_apply_A_launch.argtypes = (
            [_PTR] * 7 + WALK + [_PTR] * 4 + [ctypes.c_float] + [_PTR] * 2
            + [i32, PairConsts, _PTR])
        lib.iisph_occupancy.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
        for fn in (lib.iisph_nonpressure_kick_launch,
                   lib.iisph_predict_advection_launch,
                   lib.iisph_pressure_accel_launch,
                   lib.iisph_apply_A_launch, lib.iisph_occupancy,
                   lib.iisph_pair_list_entries):
            fn.restype = i32
        pair_list.check_entries(lib.iisph_pair_list_entries(), "IISPH")
        lib._typed = True
    return lib


def occupancy(kernel, slots=False):
    """(registers per thread, static shared memory bytes per block,
    resident blocks of 128 threads per SM) of ``kernel``
    ("iisph_pressure_accel", "iisph_pressure_accel_advect",
    "iisph_apply_A", "iisph_nonpressure_kick" or "iisph_predict_advection";
    over the cell runs, or the slot walk with ``slots``) on the current
    CUDA device."""
    which = {"iisph_pressure_accel": 0, "iisph_pressure_accel_advect": 1,
             "iisph_apply_A": 2, "iisph_nonpressure_kick": 3,
             "iisph_predict_advection": 4}[kernel] + (5 if slots else 0)
    out = [ctypes.c_int() for _ in range(3)]
    rc = _lib().iisph_occupancy(which, *[ctypes.byref(o) for o in out])
    _raise_on(rc, f"iisph_occupancy({kernel})")
    return tuple(o.value for o in out)


def nonpressure_kick(ctx, p, dt, params):
    """Kernel wrapper for ``nonpressure_kick_plain``: (acc, v*).  ``ctx``:
    the step's context from ``density_sum_list`` for the sorted particles
    ``p``, a ``PairList`` over their cell offsets or their ``SlotMap`` (the
    slot walk); on CPU tensors also neighbour lists or a bare ``SlotMap``.
    ``dt`` is a 0-d f32 tensor on the device."""
    if p.x.device.type == "cpu":
        return nonpressure_kick_plain(
            pair_list.plain_loop_ctx(ctx, p, params, "IISPH"), p, dt,
            params)
    dev, n, ptr, walk, suffix, lst = pair_list.list_walk(
        ctx, p, params, "iisph_nonpressure_kick")
    f32 = torch.float32
    acc = torch.empty_like(p.x)
    v_out = torch.empty_like(p.v)
    rc = _lib().iisph_nonpressure_kick_launch(
        ptr["x"], _check("v", p.v, f32, (n, 3), dev), ptr["material"],
        _check("m", p.m, f32, (n,), dev),
        _check("density", p.density, f32, (n,), dev), *walk, *lst,
        _check("dt", dt, f32, (), dev), acc.data_ptr(), v_out.data_ptr(), n,
        pair_consts(params), _stream(dev))
    name = "iisph_nonpressure_kick" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return acc, v_out


def predict_advection(ctx, p, dt, params):
    """Kernel wrapper for ``predict_advection_plain``: (a_ii, source,
    last_p).  ``ctx`` as for ``nonpressure_kick``."""
    if p.x.device.type == "cpu":
        return predict_advection_plain(
            pair_list.plain_loop_ctx(ctx, p, params, "IISPH"), p, dt,
            params)
    dev, n, ptr, walk, suffix, lst = pair_list.list_walk(
        ctx, p, params, "iisph_predict_advection")
    f32 = torch.float32
    outs = tuple(torch.empty_like(p.m_V) for _ in range(3))
    rc = _lib().iisph_predict_advection_launch(
        ptr["x"], _check("v", p.v, f32, (n, 3), dev), ptr["material"],
        ptr["m_V"], _check("density", p.density, f32, (n,), dev),
        _check("pressure", p.pressure, f32, (n,), dev), *walk, *lst,
        _check("dt", dt, f32, (), dev), *(o.data_ptr() for o in outs), n,
        pair_consts(params), _stream(dev))
    name = "iisph_predict_advection" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return outs


def pressure_accel(ctx, p, pressure, params, advect_dt=None, active=None):
    """Kernel wrapper for ``pressure_accel_plain``: the (N, 3) acceleration
    (``iisph_pressure_accel<false>``, in the Jacobi loop), or with
    ``advect_dt`` the advected (v, x) (``<true>``, after it).  ``ctx``:
    the step's context from ``density_sum_list`` for the sorted particles
    ``p``, a ``PairList`` over their cell offsets or their ``SlotMap`` (the
    slot walk); on CPU tensors also neighbour lists or a bare
    ``SlotMap``."""
    if p.x.device.type == "cpu":
        return pressure_accel_plain(
            pair_list.plain_loop_ctx(ctx, p, params, "IISPH"), p, pressure,
            params, advect_dt)
    dev, n, ptr, walk, suffix, lst = pair_list.list_walk(
        ctx, p, params, "iisph_pressure_accel")
    f32 = torch.float32
    adv = advect_dt is not None
    if adv and active is not None:
        raise ValueError("the advect variant runs after the loop: no "
                         "active flag")
    out0 = torch.empty_like(p.x)
    out1 = torch.empty_like(p.x) if adv else None
    rc = _lib().iisph_pressure_accel_launch(
        ptr["x"], ptr["material"], ptr["m_V"],
        _check("density", p.density, f32, (n,), dev),
        _check("pressure", pressure, f32, (n,), dev), *walk, *lst,
        _check("v", p.v, f32, (n, 3), dev) if adv else None,
        _check("dt", advect_dt, f32, (), dev) if adv else None,
        _active_ptr(active, dev), out0.data_ptr(),
        out1.data_ptr() if adv else None, int(adv), n, pair_consts(params),
        _stream(dev))
    name = ("iisph_pressure_accel_advect" if adv
            else "iisph_pressure_accel") + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return (out0, out1) if adv else out0


def apply_A(ctx, p, accel, a_ii, source, last_p, dt, omega, params,
            active=None):
    """Kernel wrapper for ``apply_A_plain``: (new_p, err).  ``ctx`` as for
    ``nonpressure_kick``."""
    if p.x.device.type == "cpu":
        return apply_A_plain(
            pair_list.plain_loop_ctx(ctx, p, params, "IISPH"), p, accel,
            a_ii, source, last_p, dt, omega, params)
    dev, n, ptr, walk, suffix, lst = pair_list.list_walk(
        ctx, p, params, "iisph_apply_A")
    f32 = torch.float32
    new_p = torch.empty_like(p.m_V)
    err = torch.empty_like(p.m_V)
    rc = _lib().iisph_apply_A_launch(
        ptr["x"], ptr["material"], ptr["m_V"],
        _check("accel", accel, f32, (n, 3), dev),
        _check("a_ii", a_ii, f32, (n,), dev),
        _check("source", source, f32, (n,), dev),
        _check("last_p", last_p, f32, (n,), dev), *walk, *lst,
        _check("dt", dt, f32, (), dev), _active_ptr(active, dev),
        float(omega), new_p.data_ptr(), err.data_ptr(), n,
        pair_consts(params), _stream(dev))
    name = "iisph_apply_A" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return new_p, err
