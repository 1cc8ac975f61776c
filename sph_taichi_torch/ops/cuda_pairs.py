"""The WCSPH step's two pair traversals and the boundary volumes: CUDA
kernels and their plain versions, and the two CUDA engines.

Ports three specializations of the Pallas TPU kernel
``BlockEngine._kernel`` (sph_taichi_tpu/ops/pallas_blocks.py) as
hand-written CUDA C++ in ``csrc/pairs.cu``:

- ``density_sum``: den[i] = sum_j m_V[j] W(r_ij) over neighbours with
  material >= 0 (the term of models/base.py compute_densities; one phase,
  on no solver step: the reference that chip_smoke.py and the control
  tools time);
- ``density_sum_list``: the same sum on the WCSPH, IISPH and PCISPH steps,
  whose kernel also writes every real centre's accepted neighbours, in the
  walk's order, to the step's pair list (ops/pair_list.py ``PairList``):
  the positions do not move from the sort to the advect, so the step's
  later pair kernels accept the density kernel's pairs.  Over the slot
  walk its kernel keeps the one-phase walk and writes the list as it
  walks, and the force kernel, IISPH's four kernels, PCISPH's loop
  kernels and the non-pressure kernel read it;
- ``wcsph_forces``: the fused WCSPH force term (surface tension,
  viscosity, pressure, and with ``rr0`` the two-way reaction on dynamic
  rigid centres), then acceleration select, symplectic Euler and the fluid
  box clamp.  Returns new (x, v, acc); the kernel writes into new buffers
  because neighbours read the old x and v in the same launch.  Over both
  walks it reads the pair list that ``density_sum_list`` wrote (a warp
  holding a centre over the list walks the cells or the slot map in one
  phase), and on the card takes only that context, not bare cell offsets
  or a bare ``SlotMap`` (ops/pair_list.py ``list_walk``);
- ``boundary_volume``: the Akinci volume 3 / (W(0) + sum of W over solid
  neighbours) of the target rows (models/base.py _boundary_volume_engine:
  every scene with solids on the CUDA engines): over the cell runs a
  warp per target row walking its candidates together and adding the
  solid terms in the walk's order, over the slot map a thread per target
  row (there the faster of the two).

The same three kernels port the retired ``SlotEngine._kernel``
(sph_taichi_tpu/ops/retired/pallas_slots.py): given a ``SlotMap``
(ops/slots.py, the context of ``CudaSlotEngine``) instead of cell offsets,
a wrapper launches the kernel's slot-walk instantiation and counts it
under ``"<name>[slots]"``.

Beside each kernel is its plain version (``*_plain``): the GatherEngine
traversal with the same term over the plain engine's lists (the slot
lists for a ``SlotMap``), then the unfused advect and box clamp.  A
wrapper runs the plain version only when its tensors lie on the CPU; on a
CUDA tensor it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[name]``.

Padding rows (the tail past n_fluid + n_solid, sorted to the overflow
cell): ``density_sum_list`` (over both walks) and ``wcsph_forces`` write
them in the kernel (the density and the list's count 0; x and v carried
through, acc 0), so each of their wrapper calls launches exactly one
kernel; ``density_sum`` leaves them 0 and ``boundary_volume`` does not
write them.
"""

import ctypes
import functools

import numpy as np
import torch

from sph_taichi_torch.ops.grid import inv_grid_size
from sph_taichi_torch.ops.kernels import (
    norm_const, cubic_kernel, cubic_kernel_derivative_scalar)
from sph_taichi_torch.ops.neighbors import NeighborList
from sph_taichi_torch.ops.pairs import GatherEngine, div_exact, sqrt32
from sph_taichi_torch.ops.slots import (
    SlotMap, build_slot_map, slot_neighbor_list)
from sph_taichi_torch.state import (
    MATERIAL_FLUID, MATERIAL_PAD, MATERIAL_SOLID)

LAUNCHES = {"density_sum": 0, "density_sum_list": 0, "wcsph_forces": 0,
            "boundary_volume": 0, "density_sum[slots]": 0,
            "density_sum_list[slots]": 0, "wcsph_forces[slots]": 0,
            "boundary_volume[slots]": 0}

M_EPS = 1e-5    # DFSPH stiffness gate (DFSPH.py:17)


def min_neighbors(dim):
    """DFSPH particle-deficiency cutoff (DFSPH.py:171-176)."""
    return 20 if dim == 3 else 7


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def density_sum_plain(nl, x, material, m_V, params):
    """sum_j m_V[j] W(r_ij) over neighbours j with material >= 0."""
    h = params.support_radius

    def term(fi, fj, d2, rn, dots):
        w = cubic_kernel(rn, h, params.dim)
        return {"den": torch.where(fj["material"] >= 0, fj["m_V"] * w,
                                   torch.zeros_like(w))}

    return GatherEngine(params).traverse(
        nl, x, {"material": material, "m_V": m_V}, term,
        {"den": "scalar"})["den"]


def density_sum_list_plain(nl, p, params):
    """Plain version of ``density_sum_list``: (den, idx, cnt), the
    ``density_sum_plain`` sums and the step's pair list of every real
    centre (``pair_list.step_pairs_plain``) from the plain engine's
    neighbour lists ``nl`` of ``p``."""
    from sph_taichi_torch.ops import pair_list   # it imports this module

    den = density_sum_plain(nl, p.x, p.material, p.m_V, params)
    return (den, *pair_list.step_pairs_plain(nl, p, "real"))


def wcsph_accel_plain(nl, p, dpi, p_r02, m_nc, rr0, params):
    """Accelerations of the fused WCSPH force term (WCSPH.py:46-141, the
    reaction WCSPH.py:67-68 in gather form when ``rr0`` is given)."""
    h = params.support_radius
    dim = params.dim
    rho0 = params.density0
    st = params.surface_tension
    visc = params.viscosity
    diameter = params.particle_diameter
    want_react = rr0 is not None

    def term(fi, fj, d2, rn, dots):
        zero = torch.zeros_like(d2)
        gradw_s = cubic_kernel_derivative_scalar(rn, h, dim,
                                                 inv_r=dots["_inv"])
        fluid_j = fj["material"] == MATERIAL_FLUID
        solid_j = fj["material"] == MATERIAL_SOLID
        r2 = d2
        # surface tension (WCSPH.py:92-102)
        w = cubic_kernel(rn, h, dim)
        wd = cubic_kernel(torch.full((), diameter, dtype=rn.dtype,
                                     device=rn.device), h, dim)
        w_st = torch.where(r2 > diameter * diameter, w, wd)
        st_coef = torch.where(
            fluid_j, -div_exact(st, fi["m"]) * fj["m"] * w_st, zero)
        # viscosity (WCSPH.py:105-116), unclamped neighbour density
        d = 2.0 * (dim + 2.0)
        visc_coef = torch.where(
            fluid_j,
            d * visc * fj["m_nc"] * dots["v"] / (r2 + 0.01 * h * h)
            * gradw_s, zero)
        # pressure (WCSPH.py:47-66), with the boundary mirror p_j := p_i
        dpj = torch.where(fluid_j, fj["dpi"], fi["p_r02"])
        press_coef = torch.where(
            fluid_j | solid_j,
            -rho0 * fj["m_V"] * (fi["dpi"] + dpj) * gradw_s, zero)
        a_coef = st_coef + visc_coef + press_coef
        if want_react:
            dpi_k = fj["dpi"] + fj["p_r02"]
            react = torch.where(
                fluid_j, -(rho0 * fi["m_V"] * dpi_k) * fi["rr0"] * gradw_s,
                zero)
            a_coef = torch.where(fi["material"] == MATERIAL_FLUID,
                                 a_coef, react)
        return {"a": a_coef}

    fields = {"material": p.material, "m": p.m, "m_V": p.m_V,
              "dpi": dpi, "p_r02": p_r02, "m_nc": m_nc,
              "v0": p.v[:, 0], "v1": p.v[:, 1], "v2": p.v[:, 2]}
    if want_react:
        fields["rr0"] = rr0
    out = GatherEngine(params).traverse(
        nl, p.x, fields, term, {"a": "radial"}, pair_dots=("v",))
    a_pair = torch.stack(out["a"], dim=1)

    zero = torch.zeros_like(a_pair)
    acc = torch.where(p.is_fluid()[:, None], a_pair, zero)
    acc = torch.stack([g + acc[:, k] for k, g in enumerate(params.gravity)],
                      dim=1)
    if want_react:
        # on a dynamic-rigid centre the radial sum IS the reaction
        react = torch.stack([g + a_pair[:, k]
                             for k, g in enumerate(params.gravity)], dim=1)
        acc = torch.where(p.is_dynamic_rigid()[:, None], react, acc)
    acc = torch.where(p.is_static_rigid()[:, None], zero, acc)
    return torch.where((p.material == MATERIAL_PAD)[:, None], zero, acc)


def boundary_volume_plain(nl, p, target_mask, params):
    """m_V with each target row set to 3 / (W(0) + sum over solid
    neighbours j of W(r_ij)) (sph_base.py:91-113, the reference's 3.0
    included); the other rows keep their value."""
    h = params.support_radius

    def term(fi, fj, d2, rn, dots):
        w = cubic_kernel(rn, h, params.dim)
        return {"delta": torch.where(fj["material"] == MATERIAL_SOLID, w,
                                     torch.zeros_like(w))}

    out = GatherEngine(params).traverse(nl, p.x, {"material": p.material},
                                        term, {"delta": "scalar"})
    delta = cubic_kernel(torch.zeros((), dtype=p.x.dtype, device=p.x.device),
                         h, params.dim) + out["delta"]
    return torch.where(target_mask, div_exact(3.0, delta), p.m_V)


def symplectic_euler(x, v, acc, dyn, dt):
    """WCSPH.py:143-149 for the rows where ``dyn``."""
    dyn = dyn[:, None]
    v = torch.where(dyn, v + dt * acc, v)
    return torch.where(dyn, x + dt * v, x), v


def box_limits(params):
    """(lo, hi per axis) of the padded box, rounded as f32: hi is
    f32(size) - f32(pad) in f32 arithmetic."""
    pad = np.float32(params.padding)
    return float(pad), [float(np.float32(s) - pad)
                        for s in params.domain_size]


def box_clamp(x, v, active, params):
    """Clamp ``active`` rows into the padded box and reflect their velocity
    with restitution c_f (sph_base.py:118-179): strict ``>`` at the high
    side, ``<=`` at the low side, the low side winning."""
    lo, hi = box_limits(params)
    over = torch.stack([x[:, k] > hi[k] for k in range(3)], dim=1)
    under = x <= lo
    n = over.to(x.dtype) - under.to(x.dtype)
    x_new = torch.stack([torch.where(over[:, k], hi[k], x[:, k])
                         for k in range(3)], dim=1)
    x_new = torch.where(under, lo, x_new)
    nlen = sqrt32(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                  + n[:, 2] * n[:, 2])[:, None]
    nhat = n / torch.clamp_min(nlen, 1e-30)
    vdotn = (v[:, 0] * nhat[:, 0] + v[:, 1] * nhat[:, 1]
             + v[:, 2] * nhat[:, 2])[:, None]
    v_reflected = v - (1.0 + params.collision_factor) * vdotn * nhat
    v_new = torch.where(nlen > 1e-6, v_reflected, v)
    active = active[:, None]
    return torch.where(active, x_new, x), torch.where(active, v_new, v)


def wcsph_forces_plain(nl, p, dpi, p_r02, m_nc, rr0, dt, params):
    """Plain version of ``wcsph_forces``: accelerations, symplectic Euler,
    fluid box clamp.  Returns (x, v, acc)."""
    acc = wcsph_accel_plain(nl, p, dpi, p_r02, m_nc, rr0, params)
    x, v = symplectic_euler(p.x, p.v, acc, p.is_dynamic != 0, dt)
    x, v = box_clamp(x, v, p.is_fluid() & (p.is_dynamic != 0), params)
    return x, v, acc


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

class PairConsts(ctypes.Structure):
    """Mirror of ``struct PairConsts`` in csrc/pair_common.cuh (field for
    field), shared by the WCSPH, DFSPH and IISPH kernels."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_real", "nx", "ny", "nz", "x_origin")] + [
        (n, ctypes.c_float) for n in (
            "inv_cell", "h2", "inv_h", "kw", "kw2", "kg", "nkg",
            "diam2", "wd", "st", "dvisc", "eps_h2", "neg_rho0", "rho0",
            "g0", "g1", "g2", "lo", "hi0", "hi1", "hi2", "cf1",
            "w0", "min_nbr", "m_eps", "rho0sq")]


@functools.lru_cache(maxsize=16)
def pair_consts(params):
    """The kernels' constants, rounded to f32 on the host exactly as the
    plain version rounds its Python-float operands (computed once per
    params: a Jacobi loop launches two kernels per iteration)."""
    h = float(params.support_radius)
    k = norm_const(params.dim, h)
    diameter = params.particle_diameter
    wd = float(cubic_kernel(torch.tensor(diameter, dtype=torch.float32),
                            h, params.dim))
    lo, hi = box_limits(params)
    gn = params.grid_num
    return PairConsts(
        # a slab of a sharded run holds fewer rows than the global count
        n_real=min(params.n_fluid + params.n_solid, params.n_pad),
        nx=gn[0], ny=gn[1], nz=gn[2],
        x_origin=params.x_origin,
        inv_cell=float(inv_grid_size(params.grid_size)), h2=h * h,
        inv_h=1.0 / h, kw=k, kw2=k * 2.0, kg=6.0 * k, nkg=-(6.0 * k),
        diam2=diameter * diameter, wd=wd, st=params.surface_tension,
        dvisc=2.0 * (params.dim + 2.0) * params.viscosity,
        eps_h2=0.01 * h * h, neg_rho0=-params.density0,
        rho0=params.density0,
        g0=params.gravity[0], g1=params.gravity[1], g2=params.gravity[2],
        lo=lo, hi0=hi[0], hi1=hi[1], hi2=hi[2],
        cf1=1.0 + params.collision_factor,
        w0=float(cubic_kernel(torch.zeros((), dtype=torch.float32), h,
                              params.dim)),
        min_nbr=float(min_neighbors(params.dim)), m_eps=M_EPS,
        rho0sq=params.density0 * params.density0)


_PTR = ctypes.c_void_p
# ctypes types of a launcher's walk arguments: cell offsets, slot map (null
# for the cell-run walk), layers
WALK = [_PTR, _PTR, ctypes.c_int]


def _lib():
    from sph_taichi_torch.ops import _build
    lib = _build.load("pairs")
    if not getattr(lib, "_typed", False):
        i32 = ctypes.c_int
        lib.density_sum_launch.argtypes = (
            [_PTR] * 3 + WALK + [_PTR, PairConsts, _PTR])
        lib.density_sum_list_launch.argtypes = (
            [_PTR] * 3 + WALK + [_PTR] * 3 + [i32, PairConsts, _PTR])
        lib.wcsph_forces_launch.argtypes = (
            [_PTR] * 10 + WALK + [_PTR] * 6 + [i32, i32, PairConsts, _PTR])
        lib.boundary_volume_launch.argtypes = (
            [_PTR] * 2 + WALK + [_PTR, i32, _PTR, PairConsts, _PTR])
        lib.pairs_occupancy.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
        for fn in (lib.density_sum_launch, lib.density_sum_list_launch,
                   lib.wcsph_forces_launch, lib.boundary_volume_launch,
                   lib.pairs_occupancy, lib.pairs_list_entries):
            fn.restype = i32
        from sph_taichi_torch.ops import pair_list
        pair_list.check_entries(lib.pairs_list_entries(), "WCSPH")
        lib._typed = True
    return lib


def _check(name, t, dtype, shape, device):
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def _check_common(starts, p, params):
    if p.x.device.type != "cuda":
        raise ValueError(f"CUDA kernel given tensors on {p.x.device}")
    dev = p.x.device
    n = params.n_pad
    f32, i32 = torch.float32, torch.int32
    return dev, n, {
        "x": _check("x", p.x, f32, (n, 3), dev),
        "material": _check("material", p.material, i32, (n,), dev),
        "m_V": _check("m_V", p.m_V, f32, (n,), dev),
        "starts": _check("starts", starts, i32, (params.num_cells + 2,),
                         dev)}


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _plain_ctx(ctx, p, params):
    """The plain engine's neighbour lists, for a wrapper given CPU
    tensors: the lists themselves, over the slot map for a ``SlotMap``,
    else over the cell offsets (a ``PairList``'s walk's)."""
    from sph_taichi_torch.ops import pair_list   # it imports this module
    if isinstance(ctx, NeighborList):
        return ctx
    if isinstance(ctx, pair_list.PairList):
        ctx = ctx.walk
    if isinstance(ctx, SlotMap):
        return slot_neighbor_list(ctx, p.x, params)
    return GatherEngine(params).prepare(p.x, ctx)


def _walk(ctx, p, params):
    """The checks of ``_check_common`` over the walk a kernel launches for
    the context ``ctx``: the slot walk for a ``SlotMap``, the cell-run
    walk for cell offsets.  Returns (device, n, pointers, the launcher's
    walk arguments (cell offsets, slot map or None, layers), launch-count
    suffix)."""
    if isinstance(ctx, SlotMap):
        nx, ny, nz = params.grid_num
        slot_map = _check("slot map", ctx.idx, torch.int32,
                          (params.slot_layers, nx, ny, nz * 8), p.x.device)
        starts, layers, suffix = ctx.starts, params.slot_layers, "[slots]"
    else:
        starts, slot_map, layers, suffix = ctx, None, 0, ""
    dev, n, ptr = _check_common(starts, p, params)
    return dev, n, ptr, (ptr["starts"], slot_map, layers), suffix


def _active_ptr(active, dev):
    """Pointer to a Jacobi loop's 0-d bool device flag, or None."""
    if active is None:
        return None
    return _check("active", active, torch.bool, (), dev)


def density_sum(ctx, p, params):
    """Kernel wrapper for ``density_sum_plain``.  ``ctx``: the cell
    offsets of the sorted particles ``p`` (ops.grid.cell_offsets), or
    their ``SlotMap`` for the slot walk."""
    if p.x.device.type == "cpu":
        return density_sum_plain(_plain_ctx(ctx, p, params), p.x,
                                 p.material, p.m_V, params)
    dev, n, ptr, walk, suffix = _walk(ctx, p, params)
    out = torch.zeros(n, dtype=torch.float32, device=dev)
    rc = _lib().density_sum_launch(
        ptr["x"], ptr["material"], ptr["m_V"], *walk, out.data_ptr(),
        pair_consts(params), _stream(dev))
    _raise_on(rc, "density_sum" + suffix)
    LAUNCHES["density_sum" + suffix] += 1
    return out


def density_sum_list(ctx, p, params, buffers=None):
    """``density_sum`` with the context the step's later pair kernels read
    (WCSPH's forces, IISPH's four kernels, PCISPH's loop and non-pressure
    kernel): (den, ctx').  Given the cell offsets of the sorted particles
    ``p``, or their ``SlotMap``, one launch of ``density_sum_list``
    (``density_sum_slot`` over the slot walk, counted as
    ``density_sum_list[slots]``) sums the densities and writes every real
    centre's accepted pairs to a ``PairList`` over that walk in
    ``buffers`` (a dict, filled with the list's tensors at the first call
    and reused after; None: new tensors).  On CPU tensors the plain sums
    over the context's neighbour lists, and, given cell offsets, those
    lists, which the plain versions read (``density_sum_list_plain`` gives
    them in the list's layout); given a ``SlotMap``, the map."""
    from sph_taichi_torch.ops import pair_list   # it imports this module

    if p.x.device.type == "cpu":
        nl = _plain_ctx(ctx, p, params)
        return (density_sum_plain(nl, p.x, p.material, p.m_V, params),
                ctx if isinstance(ctx, SlotMap) else nl)
    dev, n, ptr, walk, suffix = _walk(ctx, p, params)
    idx, cnt = pair_list.list_buffers(buffers, n, dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    rc = _lib().density_sum_list_launch(
        ptr["x"], ptr["material"], ptr["m_V"], *walk, idx.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), n, pair_consts(params), _stream(dev))
    name = "density_sum_list" + suffix
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out, pair_list.PairList(ctx, idx, cnt)


def wcsph_forces(ctx, p, dpi, p_r02, m_nc, rr0, dt, params):
    """Kernel wrapper for ``wcsph_forces_plain``: returns new (x, v, acc).
    ``ctx``: the step's context from ``density_sum_list`` for the sorted
    particles ``p``, a ``PairList`` over their cell offsets or their
    ``SlotMap`` (the slot walk); on CPU tensors also their neighbour lists,
    cell offsets or a bare ``SlotMap``.  ``rr0`` (rho0 / density) selects
    the two-way reaction variant; ``dt`` is a 0-d f32 tensor on the
    particles' device (read by the kernel, so the step makes no host
    sync)."""
    from sph_taichi_torch.ops import pair_list   # it imports this module

    if p.x.device.type == "cpu":
        return wcsph_forces_plain(_plain_ctx(ctx, p, params), p, dpi,
                                  p_r02, m_nc, rr0, dt, params)
    dev, n, ptr, walk, suffix, lst = pair_list.list_walk(ctx, p, params,
                                                         "wcsph_forces")
    f32, i32 = torch.float32, torch.int32
    react = rr0 is not None
    args = [ptr["x"], _check("v", p.v, f32, (n, 3), dev),
            ptr["material"],
            _check("is_dynamic", p.is_dynamic, i32, (n,), dev),
            _check("m", p.m, f32, (n,), dev), ptr["m_V"],
            _check("dpi", dpi, f32, (n,), dev),
            _check("p_r02", p_r02, f32, (n,), dev),
            _check("m_nc", m_nc, f32, (n,), dev),
            _check("rr0", rr0, f32, (n,), dev) if react else None,
            *walk, *lst, _check("dt", dt, f32, (), dev)]
    x_out = torch.empty_like(p.x)
    v_out = torch.empty_like(p.v)
    acc = torch.empty_like(p.x)
    rc = _lib().wcsph_forces_launch(
        *args, x_out.data_ptr(), v_out.data_ptr(), acc.data_ptr(),
        int(react), n, pair_consts(params), _stream(dev))
    _raise_on(rc, "wcsph_forces" + suffix)
    LAUNCHES["wcsph_forces" + suffix] += 1
    return x_out, v_out, acc


def occupancy(kernel, slots=False):
    """(registers per thread, static shared memory bytes per block,
    resident blocks of 128 threads per SM) of ``kernel`` on the current
    CUDA device: "density_sum_list", "density_sum", "wcsph_forces",
    "wcsph_forces_react" or "boundary_volume" (over the cell runs, or the
    slot walk with ``slots``)."""
    which = {"density_sum_list": (0, 6), "density_sum": (1, 7),
             "wcsph_forces": (2, 4), "wcsph_forces_react": (3, 5),
             "boundary_volume": (8, 9)}[kernel][int(slots)]
    out = [ctypes.c_int() for _ in range(3)]
    rc = _lib().pairs_occupancy(which, *[ctypes.byref(o) for o in out])
    _raise_on(rc, f"pairs_occupancy({kernel})")
    return tuple(o.value for o in out)


def target_rows(target_mask, cap):
    """i32[cap]: the rows where ``target_mask`` holds, ascending, then -1.
    ``cap`` (static) bounds their number, so no host sync."""
    n = target_mask.shape[0]
    pos = torch.cumsum(target_mask.to(torch.int64), 0) - 1
    rows = torch.full((cap + 1,), -1, dtype=torch.int32,
                      device=target_mask.device)
    rows.scatter_(0, torch.where(target_mask, pos, cap),
                  torch.arange(n, dtype=torch.int32,
                               device=target_mask.device))
    return rows[:cap]


def boundary_volume(ctx, p, target_mask, params):
    """Kernel wrapper for ``boundary_volume_plain``: a new m_V whose
    target rows hold their Akinci volumes.  ``ctx`` as for
    ``density_sum``; ``target_mask`` (bool[n]) selects solid rows, so the
    launch covers one target per solid (params.n_solid, static) over the
    compacted target rows."""
    if p.x.device.type == "cpu":
        return boundary_volume_plain(_plain_ctx(ctx, p, params), p,
                                     target_mask, params)
    dev, n, ptr, walk, suffix = _walk(ctx, p, params)
    _check("target_mask", target_mask, torch.bool, (n,), dev)
    m_V = p.m_V.clone()
    if params.n_solid == 0:
        return m_V
    targets = target_rows(target_mask, params.n_solid)
    rc = _lib().boundary_volume_launch(
        ptr["x"], ptr["material"], *walk, targets.data_ptr(),
        params.n_solid, m_V.data_ptr(),
        pair_consts(params), _stream(dev))
    _raise_on(rc, "boundary_volume" + suffix)
    LAUNCHES["boundary_volume" + suffix] += 1
    return m_V


class CudaEngine:
    """Cell-range engine: its per-step context is the cell offsets, and
    its traversals are the kernels above (no caps, so no diagnostics)."""

    fused = True   # forces run advect and the fluid box clamp in-kernel

    def __init__(self, params):
        self.params = params

    def prepare(self, x, cell_starts):
        return cell_starts

    def diag(self, starts):
        return {}


class CudaSlotEngine(CudaEngine):
    """Slot engine (``--backend pallas_slots``): its per-step context is
    the slot map (ops/slots.py), and the kernels above take their slot
    walk.  Its diagnostics are the map's: ``max_cell_occupancy_engine``,
    ``max_layers_used`` and the fatal ``slot_overflow``."""

    def prepare(self, x, cell_starts):
        return build_slot_map(cell_starts, self.params)

    def diag(self, smap):
        return dict(smap.diag)
