"""The PCISPH loop's two pair traversals: CUDA kernels and their plain versions.

Ports the specializations of the Pallas TPU kernel ``BlockEngine._kernel``
(sph_taichi_tpu/ops/pallas_blocks.py) that the PCISPH path
(sph_taichi_tpu/models/pcisph.py) runs, as hand-written CUDA C++ in
``csrc/pcisph.cu``:

- ``d_rho_correct``: the continuity density derivative at the predicted
  state, sum_j m_V_j dW (v*_i - v*_j) . r_ij over real j (``_d_rho``),
  with its correction epilogue: rho_err = max(rho + dt rho0 div - rho0, 0)
  and p' = max(p + s_f rho_err, 0) on fluid rows.  Returns (p', rho_err);
- ``pressure_accel_predict``: the symmetric pressure acceleration with the
  solid mirror (``_pressure_accel``, IISPH's term) and the predict
  epilogue v*' = v + dt (acc + a_p), x*' = x + dt v*' on fluid rows, from
  the step-start (x, v, acc).  Returns (v*', x*').

Both run at the predicted positions ``xp`` over the pairs of the
step-start positions ``p.x`` (the fixed-neighbour-list PCISPH): a pair
counts if |x_i - x_j| < h at the step start, and its term is evaluated at
x*, where a pair that has moved beyond h contributes 0.  The plain engine's
neighbour lists, built once per step from ``p.x``, give exactly that pair
set.

The same kernels port the retired ``SlotEngine._kernel``
(sph_taichi_tpu/ops/retired/pallas_slots.py): given the step's list over
the ``SlotMap`` of the step-start particles (ops/slots.py, the context of
``CudaSlotEngine``) instead of over their cell offsets, a wrapper launches
the kernel's slot-walk instantiation and counts it under
``"<name>[slots]"``; the loop keeps the step-start map for every
iteration, as it keeps the step-start offsets.

Beside each kernel is its plain version (``*_plain``): the GatherEngine
traversal with the same term (over the slot lists for a ``SlotMap``),
then the same epilogue in torch, in the JAX package's operation order.  A
wrapper runs the plain version only when its tensors lie on the CPU; on a
CUDA tensor it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``.  Both run inside the loop and take an optional
``active`` flag, a 0-d bool tensor on the device: when it is false the
kernel returns at once and its outputs are undefined (the loop discards
them).  The plain versions ignore it.

Over both walks the loop reads the fluid rows of the step's pair list
(ops/pair_list.py ``PairList``), which the step's density kernel writes as
it sums at the step-start positions (ops/cuda_pairs.py
``density_sum_list``, models/base.py ``compute_densities_and_pairs``):
given it, g1 and g2 run only the pair body over it (csrc/pair_common.cuh
``for_each_step_pair``); a warp holding a centre over the list walks
the cells or the slot map in one phase.  On the card the wrappers take
only the list, not bare cell offsets or a bare ``SlotMap``
(ops/pair_list.py ``list_walk``), and the launchers refuse a launch
without it; on CPU tensors the loop's context is the plain engine's
neighbour lists, a ``SlotMap`` or a ``PairList`` over one, whose lists the
plain versions read.

The kernels write the padding rows themselves, as the JAX package's
``restore_tail`` gives them (p' and rho_err 0, v*' and x*' from v and x),
so each wrapper call launches exactly one kernel.
"""

import ctypes

import torch

from sph_taichi_torch.ops import cuda_iisph, pair_list
from sph_taichi_torch.ops.cuda_pairs import (
    WALK, _PTR, _active_ptr, _check, _raise_on, _stream, pair_consts,
    PairConsts)
from sph_taichi_torch.ops.kernels import cubic_kernel_derivative_scalar
from sph_taichi_torch.ops.pairs import GatherEngine

LAUNCHES = {name + walk: 0 for walk in ("", "[slots]") for name in (
    "pcisph_d_rho_correct", "pcisph_pressure_accel_predict")}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def d_rho_correct_plain(nl, p, xp, vp, pressure, dt, s_f, params,
                        active=None):
    """Plain version of ``d_rho_correct``: (p', rho_err), both 0 off fluid
    rows.  The sum over real j of m_V_j dW (v*_i - v*_j) . r_ij at the
    predicted positions ``xp`` and velocities ``vp`` over the pairs of the
    neighbour lists ``nl`` (pcisph.py:68-91), then the loop's correction
    (pcisph.py:234-242).  ``dt`` and ``s_f`` are 0-d f32 tensors."""
    h = params.support_radius
    rho0 = params.density0

    def term(fi, fj, d2, rn, dots):
        gradw_s = cubic_kernel_derivative_scalar(rn, h, params.dim,
                                                 inv_r=dots["_inv"])
        return {"div": torch.where(fj["material"] >= 0,
                                   fj["m_V"] * gradw_s * dots["v"],
                                   torch.zeros_like(gradw_s))}

    div = GatherEngine(params).traverse(
        nl, xp, {"material": p.material, "m_V": p.m_V, "v0": vp[:, 0],
                 "v1": vp[:, 1], "v2": vp[:, 2]}, term, {"div": "scalar"},
        pair_dots=("v",))["div"]
    fluid = p.is_fluid()
    d_rho = torch.where(fluid, div * rho0, 0.0)
    rho_err = torch.where(
        fluid, torch.clamp_min(p.density + dt * d_rho - rho0, 0.0), 0.0)
    pr = torch.where(fluid, torch.clamp_min(pressure + s_f * rho_err, 0.0),
                     0.0)
    return pr, rho_err


def pressure_accel_predict_plain(nl, p, xp, pressure, dt, params,
                                 active=None):
    """Plain version of ``pressure_accel_predict``: (v*', x*').  The
    acceleration is IISPH's term (``cuda_iisph.pressure_accel_plain``) at
    the predicted positions; on fluid rows v*' = v + dt (acc + a_p) and
    x*' = x + dt v*' from the step-start p.v, p.acc and p.x
    (pcisph.py:158-168, 210); other rows keep v and x."""
    accel = cuda_iisph.pressure_accel_plain(nl, p._replace(x=xp), pressure,
                                            params)
    fluid = p.is_fluid()[:, None]
    v = torch.where(fluid, p.v + dt * (p.acc + accel), p.v)
    return v, torch.where(fluid, p.x + dt * v, p.x)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    from sph_taichi_torch.ops import _build
    lib = _build.load("pcisph")
    if not getattr(lib, "_typed", False):
        i32 = ctypes.c_int
        lib.pcisph_d_rho_correct_launch.argtypes = (
            [_PTR] * 7 + WALK + [_PTR] * 7 + [i32, PairConsts, _PTR])
        lib.pcisph_pressure_accel_predict_launch.argtypes = (
            [_PTR] * 8 + WALK + [_PTR] * 6 + [i32, PairConsts, _PTR])
        lib.pcisph_occupancy.argtypes = (
            [i32] + [ctypes.POINTER(i32)] * 3)
        for fn in (lib.pcisph_d_rho_correct_launch,
                   lib.pcisph_pressure_accel_predict_launch,
                   lib.pcisph_occupancy, lib.pcisph_pair_list_entries):
            fn.restype = i32
        pair_list.check_entries(lib.pcisph_pair_list_entries(), "PCISPH")
        lib._typed = True
    return lib


def occupancy(kernel, slots=False):
    """(registers per thread, static shared memory bytes per block,
    resident blocks of 128 threads per SM) of ``kernel``
    ("pcisph_d_rho_correct" or "pcisph_pressure_accel_predict"; over the
    cell runs, or the slot walk with ``slots``) on the current CUDA
    device."""
    which = {"pcisph_d_rho_correct": 0,
             "pcisph_pressure_accel_predict": 1}[kernel] + (2 if slots else 0)
    out = [ctypes.c_int() for _ in range(3)]
    rc = _lib().pcisph_occupancy(which, *[ctypes.byref(o) for o in out])
    _raise_on(rc, f"pcisph_occupancy({kernel})")
    return tuple(o.value for o in out)


def d_rho_correct(ctx, p, xp, vp, pressure, dt, s_f, params, active=None):
    """Kernel wrapper for ``d_rho_correct_plain``: (p', rho_err).
    ``ctx``: the step's context from ``density_sum_list`` for the sorted
    step-start particles ``p``, a ``PairList`` over their cell offsets or
    their ``SlotMap`` (the slot walk); on CPU tensors also neighbour lists
    or a bare ``SlotMap``."""
    if p.x.device.type == "cpu":
        return d_rho_correct_plain(
            pair_list.plain_loop_ctx(ctx, p, params, "PCISPH"), p, xp, vp,
            pressure, dt, s_f, params)
    dev, n, ptr, walk, suffix, lst = pair_list.list_walk(ctx, p, params,
                                                         "PCISPH")
    f32 = torch.float32
    pr_out = torch.empty_like(p.m_V)
    err = torch.empty_like(p.m_V)
    rc = _lib().pcisph_d_rho_correct_launch(
        ptr["x"], _check("xp", xp, f32, (n, 3), dev),
        _check("vp", vp, f32, (n, 3), dev), ptr["material"], ptr["m_V"],
        _check("density", p.density, f32, (n,), dev),
        _check("pressure", pressure, f32, (n,), dev), *walk, *lst,
        _check("dt", dt, f32, (), dev), _check("s_f", s_f, f32, (), dev),
        _active_ptr(active, dev), pr_out.data_ptr(), err.data_ptr(), n,
        pair_consts(params), _stream(dev))
    name = "pcisph_d_rho_correct" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return pr_out, err


def pressure_accel_predict(ctx, p, xp, pressure, dt, params, active=None):
    """Kernel wrapper for ``pressure_accel_predict_plain``: (v*', x*').
    ``ctx`` as for ``d_rho_correct``."""
    if p.x.device.type == "cpu":
        return pressure_accel_predict_plain(
            pair_list.plain_loop_ctx(ctx, p, params, "PCISPH"), p, xp,
            pressure, dt, params)
    dev, n, ptr, walk, suffix, lst = pair_list.list_walk(ctx, p, params,
                                                         "PCISPH")
    f32 = torch.float32
    v_out = torch.empty_like(p.v)
    x_out = torch.empty_like(p.x)
    rc = _lib().pcisph_pressure_accel_predict_launch(
        ptr["x"], _check("xp", xp, f32, (n, 3), dev), ptr["material"],
        ptr["m_V"], _check("density", p.density, f32, (n,), dev),
        _check("pressure", pressure, f32, (n,), dev),
        _check("v", p.v, f32, (n, 3), dev),
        _check("acc", p.acc, f32, (n, 3), dev), *walk, *lst,
        _check("dt", dt, f32, (), dev), _active_ptr(active, dev),
        v_out.data_ptr(), x_out.data_ptr(), n, pair_consts(params),
        _stream(dev))
    name = "pcisph_pressure_accel_predict" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return v_out, x_out
