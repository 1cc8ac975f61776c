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
(sph_taichi_tpu/ops/retired/pallas_slots.py): given a ``SlotMap`` of the
step-start particles (ops/slots.py, the context of ``CudaSlotEngine``)
instead of their cell offsets, a wrapper launches the kernel's slot-walk
instantiation and counts it under ``"<name>[slots]"``; the loop keeps the
step-start map for every iteration, as it keeps the step-start offsets.

Beside each kernel is its plain version (``*_plain``): the GatherEngine
traversal with the same term (over the slot lists for a ``SlotMap``),
then the same epilogue in torch, in the JAX package's operation order.  A
wrapper runs the plain version only when its tensors lie on the CPU; on a
CUDA tensor it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``.  Both run inside the loop and take an optional
``active`` flag, a 0-d bool tensor on the device: when it is false the
kernel returns at once and its outputs are undefined (the loop discards
them).  The plain versions ignore it.

Over the cell runs the loop reads the step-start pair list: ``step_pairs``
(``csrc/pcisph.cu`` ``pcisph_step_pairs``) runs the candidate phase of the
two-phase walk once per step and writes each fluid centre's accepted
neighbours, in the walk's order, to a fixed-stride list in device memory
(``PairList``, the loop's context); given it, g1 and g2 run only the pair
body over it.  A warp holding a centre with more than
``PAIR_LIST_ENTRIES`` accepted pairs walks the cells in one phase inside
the kernel (the same pairs, in the same order).  Over the cell runs the
wrappers take only the list, not bare cell offsets.  ``step_pairs_plain``
is the list from the plain engine's neighbour lists; on CPU tensors the
loop's context is those lists themselves, which the plain versions read.
The slot walk keeps its one-phase kernels and no list.

The kernels write the padding rows themselves, as the JAX package's
``restore_tail`` gives them (p' and rho_err 0, v*' and x*' from v and x),
so each wrapper call launches exactly one kernel.
"""

import ctypes
from typing import NamedTuple

import torch

from sph_taichi_torch.ops import cuda_iisph
from sph_taichi_torch.ops.cuda_pairs import (
    WALK, _PTR, _active_ptr, _check, _plain_ctx, _raise_on, _stream, _walk,
    pair_consts, PairConsts)
from sph_taichi_torch.ops.kernels import cubic_kernel_derivative_scalar
from sph_taichi_torch.ops.neighbors import NeighborList
from sph_taichi_torch.ops.pairs import GatherEngine
from sph_taichi_torch.ops.slots import SlotMap

LAUNCHES = {name + walk: 0 for walk in ("", "[slots]") for name in (
    "pcisph_d_rho_correct", "pcisph_pressure_accel_predict")}
LAUNCHES["pcisph_step_pairs"] = 0
# mirror of csrc/pair_common.cuh kPairListEntries (checked when the library
# loads): the accepted pairs the step-start list holds per centre
PAIR_LIST_ENTRIES = 64


class PairList(NamedTuple):
    """The PCISPH loop's context over the cell runs: the step-start cell
    offsets and pair list.  Entry k of row i's list at ``idx[k, i]``
    (i32[PAIR_LIST_ENTRIES, n_pad]), valid for k < min(cnt[i],
    PAIR_LIST_ENTRIES); ``cnt`` (i32[n_pad]) is each fluid centre's number
    of accepted step-start pairs, also beyond the list, and 0 on other
    rows."""
    starts: torch.Tensor
    idx: torch.Tensor
    cnt: torch.Tensor


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


def step_pairs_plain(nl, p, params):
    """Plain version of ``step_pairs``: (idx, cnt) of ``PairList`` from the
    plain engine's neighbour lists ``nl`` of the step-start particles
    ``p``, which hold each centre's neighbours in the kernels' walk order.
    Entries past a row's listed pairs are -1.  Raises if ``nl`` holds fewer
    columns than a row's listed pairs."""
    k_list = PAIR_LIST_ENTRIES
    cnt = torch.where(p.is_fluid(), nl.cnt, 0).to(torch.int32)
    listed = torch.clamp_max(cnt, k_list)
    cols = min(k_list, nl.idx.shape[1])
    if int(listed.max()) > cols:
        raise ValueError(f"the neighbour lists hold {cols} columns, a "
                         f"centre lists {int(listed.max())} pairs")
    idx = torch.full((k_list, p.n), -1, dtype=torch.int32,
                     device=p.x.device)
    idx[:cols] = nl.idx[:, :cols].T.to(torch.int32)
    k = torch.arange(k_list, device=p.x.device)[:, None]
    return torch.where(k < listed[None, :], idx, -1), cnt


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
        lib.pcisph_step_pairs_launch.argtypes = (
            [_PTR] * 5 + [i32, PairConsts, _PTR])
        lib.pcisph_occupancy.argtypes = (
            [i32] + [ctypes.POINTER(i32)] * 3)
        for fn in (lib.pcisph_d_rho_correct_launch,
                   lib.pcisph_pressure_accel_predict_launch,
                   lib.pcisph_step_pairs_launch, lib.pcisph_occupancy,
                   lib.pcisph_pair_list_entries):
            fn.restype = i32
        entries = lib.pcisph_pair_list_entries()
        if entries != PAIR_LIST_ENTRIES:
            raise RuntimeError(f"csrc/pair_common.cuh kPairListEntries is "
                               f"{entries}, PAIR_LIST_ENTRIES "
                               f"{PAIR_LIST_ENTRIES}")
        lib._typed = True
    return lib


def step_pairs(ctx, p, params, buffers=None):
    """The loop's context for the sorted step-start particles ``p``: given
    their cell offsets, a ``PairList`` built by one launch of
    ``pcisph_step_pairs`` into ``buffers`` (a dict, filled with the list's
    tensors at the first call and reused after; None: new tensors); given
    a ``SlotMap``, the map itself (the slot walk reads no list).  On CPU
    tensors, given cell offsets, the plain engine's neighbour lists of
    ``p``: the step-start pairs that the plain versions read
    (``step_pairs_plain`` gives them in the list's layout)."""
    if isinstance(ctx, SlotMap):
        return ctx
    if p.x.device.type == "cpu":
        return _plain_ctx(ctx, p, params)
    dev, n, ptr, _, _ = _walk(ctx, p, params)
    buffers = {} if buffers is None else buffers
    if "idx" not in buffers:
        buffers["idx"] = torch.empty((PAIR_LIST_ENTRIES, n),
                                     dtype=torch.int32, device=dev)
        buffers["cnt"] = torch.empty(n, dtype=torch.int32, device=dev)
    pairs = PairList(ctx, buffers["idx"], buffers["cnt"])
    rc = _lib().pcisph_step_pairs_launch(
        ptr["x"], ptr["material"], ptr["starts"],
        _check("pair list", pairs.idx, torch.int32, (PAIR_LIST_ENTRIES, n),
               dev),
        _check("pair counts", pairs.cnt, torch.int32, (n,), dev), n,
        pair_consts(params), _stream(dev))
    _raise_on(rc, "pcisph_step_pairs")
    LAUNCHES["pcisph_step_pairs"] += 1
    return pairs


def _refuse(ctx, kind):
    raise TypeError(f"PCISPH's loop kernels take the step's context from "
                    f"step_pairs ({kind} or a SlotMap), not "
                    f"{type(ctx).__name__}")


def _loop_walk(ctx, p, params):
    """``_walk`` of a loop kernel's context, and the launcher's list
    arguments: the list of a ``PairList``, none for a ``SlotMap``; raises
    for any other context."""
    if isinstance(ctx, SlotMap):
        return (*_walk(ctx, p, params), (None, None))
    if not isinstance(ctx, PairList):
        _refuse(ctx, "a PairList")
    dev, n, ptr, walk, suffix = _walk(ctx.starts, p, params)
    lst = (_check("pair list", ctx.idx, torch.int32, (PAIR_LIST_ENTRIES, n),
                  dev),
           _check("pair counts", ctx.cnt, torch.int32, (n,), dev))
    return dev, n, ptr, walk, suffix, lst


def _plain_loop_ctx(ctx, p, params):
    """The plain versions' neighbour lists of a loop context on CPU
    tensors: the lists ``step_pairs`` gave, or a ``SlotMap``'s slot lists;
    raises for any other context."""
    if isinstance(ctx, NeighborList):
        return ctx
    if not isinstance(ctx, SlotMap):
        _refuse(ctx, "neighbour lists on CPU tensors")
    return _plain_ctx(ctx, p, params)


def occupancy(kernel, slots=False):
    """(registers per thread, static shared memory bytes per block,
    resident blocks of 128 threads per SM) of ``kernel``
    ("pcisph_d_rho_correct", "pcisph_pressure_accel_predict" (over the
    slot walk with ``slots``) or "pcisph_step_pairs") on the current CUDA
    device."""
    which = {"pcisph_d_rho_correct": 0, "pcisph_pressure_accel_predict": 1,
             "pcisph_step_pairs": 4}[kernel] + (2 if slots else 0)
    out = [ctypes.c_int() for _ in range(3)]
    rc = _lib().pcisph_occupancy(which, *[ctypes.byref(o) for o in out])
    _raise_on(rc, f"pcisph_occupancy({kernel})")
    return tuple(o.value for o in out)


def d_rho_correct(ctx, p, xp, vp, pressure, dt, s_f, params, active=None):
    """Kernel wrapper for ``d_rho_correct_plain``: (p', rho_err).
    ``ctx``: the step's context from ``step_pairs`` for the sorted
    step-start particles ``p`` (a ``PairList``; on CPU tensors, neighbour
    lists), or their ``SlotMap`` for the slot walk."""
    if p.x.device.type == "cpu":
        return d_rho_correct_plain(_plain_loop_ctx(ctx, p, params), p, xp,
                                   vp, pressure, dt, s_f, params)
    dev, n, ptr, walk, suffix, lst = _loop_walk(ctx, p, params)
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
            _plain_loop_ctx(ctx, p, params), p, xp, pressure, dt, params)
    dev, n, ptr, walk, suffix, lst = _loop_walk(ctx, p, params)
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
