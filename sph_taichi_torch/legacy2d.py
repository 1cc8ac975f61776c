"""Legacy 2D engine: WCSPH / PCISPH / DFSPH with adaptive CFL timestep
and mid-simulation particle emission, in plain PyTorch.

Counterpart of ``sph_taichi_tpu/legacy2d.py`` (the reference's
legacy/engine/sph_solver.py): the same public names, state fields,
physics and step order.  The JAX engine computes its dense O(N^2) pair
terms in plain ``jnp`` under ``jit``, outside any Pallas kernel, so this
module is plain torch ops on the solver's device (the card unless the
caller names another: ``state.resolve_device``).

Layout, not result, differs:
- ``add_cube`` only appends, so the live rows are always the prefix
  [0, n) of the capacity and no pair term involves a padding row.  The
  state keeps the capacity (padding rows at x = 1e9, material -1) with n
  on the host, and the pair work runs over the prefix: ~2,000 live rows
  at capacity 2^14 are 4M pairs, not 268M.  The padding rows get what the
  JAX step writes there: d_v, pressure_acc and PCISPH's pressure 0,
  DFSPH's alpha -1/max(0, 1e-6) and its v_new = v.
- PCISPH's loop and DFSPH's two solves run in ``models/base.py``
  ``jacobi_while``: the exit test is read to the host every
  ``PCISPH_CHECK_EVERY`` / ``JACOBI_CHECK_EVERY`` iterations, and an
  iteration after the exit commits nothing, so the iteration count (in
  the carry) equals the JAX one.
- A pair sum over j is a multiply and a sum over j, never a batched
  matmul, whose precision would follow the global TF32 setting.

Rounding is chosen per operation so that the CPU and the card give the
same f32 values up to the order of the sums over j:
- A / constant: XLA rewrites it as A * (1/c) with 1/c rounded to f32, and
  so does this module (``_recip``); torch's tensor / scalar divides on the
  CPU and multiplies by a reciprocal on CUDA.
- constant / A: XLA divides; torch's scalar / tensor multiplies by a
  reciprocal on both devices, so this module divides by a full tensor
  (``pairs.div_exact``).
- sqrt: XLA's is correctly rounded, torch's on the CPU is an ulp off for
  ~0.7% of inputs: ``pairs.sqrt32``.
- x ** 7 (the Tait EOS, the acoustic dt bound) is taken in f64 and
  rounded once; XLA's f32 pow agrees with that on all but ~0.07% of
  inputs, torch's f32 pow on the CPU differs on ~1%.
- Constants are folded in Python double and rounded once to f32, as the
  JAX module folds them (k = 10/(7 pi h^2), -2 alpha dx c0, b, 0.01 dx^2).
XLA's CPU code also contracts a + b*c into FMAs and sums in its own
order, so the parity tests compare with the JAX package at stated
tolerances (``convert.state2d_step_tolerances``).

``_step`` computes in the float dtype of the state it is given: the
solver's own state is f32; an f64 copy of it
(``convert.state2d_from_numpy(..., dtype=torch.float64)``) gives the
reference that the f32 steps of the CPU and the card are measured from.
"""

from functools import reduce
from typing import NamedTuple

import numpy as np
import torch

from sph_taichi_torch.models.base import JACOBI_CHECK_EVERY, jacobi_while
from sph_taichi_torch.ops.pairs import div_exact, sqrt32
from sph_taichi_torch.state import resolve_device

METHOD_WCSPH = 0
METHOD_PCISPH = 1
METHOD_DFSPH = 2
METHODS = {"WCSPH": METHOD_WCSPH, "PCISPH": METHOD_PCISPH,
           "DFSPH": METHOD_DFSPH}

MATERIAL_FLUID = 1
MATERIAL_BOUND = 0
MATERIAL_NONE = -1

# PCISPH's loop runs at least 3 iterations, so its exit test is read to
# the host every 3 (as models/pcisph.py reads its own).
PCISPH_CHECK_EVERY = 3

_ARRAY_FIELDS = ("x", "v", "v_new", "pressure", "pressure_acc", "density",
                 "d_v", "alpha", "material", "color")


class State2D(NamedTuple):
    x: torch.Tensor             # f32[N,2]
    v: torch.Tensor             # f32[N,2]
    v_new: torch.Tensor         # f32[N,2] prediction buffer (PCISPH/DFSPH)
    pressure: torch.Tensor      # f32[N]
    pressure_acc: torch.Tensor  # f32[N,2]
    density: torch.Tensor       # f32[N]
    d_v: torch.Tensor           # f32[N,2] non-pressure accel
    alpha: torch.Tensor         # f32[N] DFSPH alpha
    material: torch.Tensor      # i32[N] 1 fluid / 0 bound / -1 empty slot
    color: torch.Tensor         # i32[N]
    n: int                      # live particle count, on the host
    dt: torch.Tensor            # f32[]


def _recip(c):
    """1/c rounded to f32: XLA folds A / c into A * (1/c)."""
    return float(np.float32(1.0) / np.float32(c))


def _pow(x, e):
    """x ** e in f64, rounded once to x's dtype."""
    return (x.double() ** e).to(x.dtype)


def _sqrt(a):
    """Correctly rounded sqrt: ``sqrt32`` for f32, torch's own for f64."""
    return sqrt32(a) if a.dtype == torch.float32 else torch.sqrt(a)


def _dot(u, r):
    """(u_i - u_j) . r_ij over the pairs of the live rows."""
    return ((u[:, 0, None] - u[None, :, 0]) * r[0]
            + (u[:, 1, None] - u[None, :, 1]) * r[1])


def _radial_sum(coef, r):
    """sum_j coef_ij r_ij (the JAX module's einsum "ij,ijk->ik")."""
    return torch.stack(((coef * r[0]).sum(1), (coef * r[1]).sum(1)), dim=1)


# ---------------------------------------------------------------------------
# legacy 2D cubic spline (2h support) — legacy:235-259
# ---------------------------------------------------------------------------

def cubic_kernel_2d(r, h):
    k = 10.0 / (7.0 * np.pi * h * h)
    q = r * _recip(h)
    w1 = k * (1 - 1.5 * q * q + 0.75 * q * q * q)
    a = 2 - q
    w2 = k * 0.25 * (a * a * a)
    return torch.where(q <= 1.0, w1, torch.where(q < 2.0, w2, 0.0))


def cubic_kernel_derivative_2d(r, h):
    """Scalar dW/dr (legacy multiplies by r/|r| itself)."""
    k = 10.0 / (7.0 * np.pi * h * h)
    q = r * _recip(h)
    d1 = (k / h) * (-3 * q + 2.25 * q * q)
    a = 2 - q
    d2 = -0.75 * (k / h) * (a * a)
    return torch.where(q < 1.0, d1, torch.where(q < 2.0, d2, 0.0))


class SPHSolver2D:
    """Reference-compatible constructor (legacy/engine/sph_solver.py:21-49).

    `res` is the GUI resolution; world = res / screen_to_world_ratio.
    bound = [top, bottom, left, right] in world units.  ``device``: None
    means the CUDA device (raises without one); ``"cpu"`` runs on the CPU.
    """

    def __init__(self, res, screen_to_world_ratio, bound, alpha=0.5, dx=0.2,
                 max_num_particles=2 ** 14, padding=None, max_time=5.0,
                 max_steps=50000, dynamic_allocate=False,
                 adaptive_time_step=True, method=0, device=None):
        self.device = resolve_device(device)
        self.method = method
        self.adaptive_time_step = adaptive_time_step
        self.dim = len(res)
        assert self.dim == 2
        self.res = res
        self.screen_to_world_ratio = screen_to_world_ratio
        self.padding = 2 * dx                 # legacy:41
        self.max_time = max_time
        self.max_steps = max_steps
        self.max_num_particles = int(max_num_particles)

        self.g = -9.80                        # legacy:46
        self.alpha = alpha
        self.rho_0 = 1000.0
        self.CFL_v = 0.25
        self.CFL_a = 0.05
        self.df_fac = 1.3
        self.dx = dx
        self.dh = dx * self.df_fac            # smoothing length
        self.m = self.dx ** self.dim * self.rho_0
        self.gamma = 7.0
        self.c_0 = 200.0

        self.top_bound, self.bottom_bound = bound[0], bound[1]
        self.left_bound, self.right_bound = bound[2], bound[3]

        # PCISPH scaling factor from an ideal lattice (legacy:377-396):
        # static, except the dt^2 factor, applied per step.
        self.s_f_base = self._pci_scaling_base()

        n = self.max_num_particles
        dev = self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def const(a, dtype=torch.float32):
            return torch.tensor(a, dtype=dtype, device=dev)

        self.state = State2D(
            x=torch.full((n, 2), 1e9, dtype=torch.float32, device=dev),
            v=zeros(n, 2), v_new=zeros(n, 2), pressure=zeros(n),
            pressure_acc=zeros(n, 2), density=zeros(n), d_v=zeros(n, 2),
            alpha=zeros(n),
            material=torch.full((n,), MATERIAL_NONE, dtype=torch.int32,
                                device=dev),
            color=torch.zeros(n, dtype=torch.int32, device=dev),
            n=0,
            dt=const(0.1 * self.dh / self.c_0))
        # the step's device constants, made once: a host-to-device copy
        # in the step would make the host wait for the card
        self._g = const([0.0, self.g])
        self._inf = const(np.inf)
        self._zero_f32 = const([0.0])   # the padding rows' 0 in a max
        self._zero_i32 = const(0, torch.int32)
        # the walls in the JAX module's order (left, right, top, bottom),
        # one per axis at a time: left and top, then right and bottom.
        # ``sign`` is the wall's normal along its axis: pos is outside when
        # sign (pos - lim) < 0, and the push-out adds sign |pos - lim|.
        pad = self.padding
        self._walls = (
            (const([[self.left_bound + 0.5 * pad, self.top_bound - pad]]),
             const([[1.0, -1.0]])),
            (const([[self.right_bound - 0.5 * pad,
                     self.bottom_bound + pad]]),
             const([[-1.0, 1.0]])))
        self._pair_base = None   # (material, n, real pairs off the diagonal)
        self.it = 0     # last step's solver iterations (diagnostic)
        self.reads = 0  # last step's host reads: the loops' and step()'s
        self.loop_reads = 0

    # ------------------------------------------------------------------
    def _pci_scaling_base(self):
        """grad sums over the ideal 2h-support lattice (legacy:377-396);
        s_f = 1 / max(2 (dt m / rho0)^2 * (|sum grad|^2 + sum |grad|^2), eps)
        — the dt-independent part is precomputed here."""
        rng = int(self.dh * 2.0 / self.dx)
        half = rng // 2
        grad_sum = np.zeros(2)
        grad_dot = 0.0
        for xx in range(-half, half):
            for yy in range(-half, half):
                r = np.array([-xx * self.dx, -yy * self.dx])
                rm = np.linalg.norm(r)
                if 1e-5 < rm < 2.0 * self.dh:
                    k = 10.0 / (7.0 * np.pi * self.dh ** 2)
                    q = rm / self.dh
                    if q < 1.0:
                        d = (k / self.dh) * (-3 * q + 2.25 * q * q)
                    else:
                        d = -0.75 * (k / self.dh) * (2 - q) ** 2
                    g = d * r / rm
                    grad_sum += g
                    grad_dot += g @ g
        return float(grad_sum @ grad_sum + grad_dot)

    # ------------------------------------------------------------------
    # pair helpers (dense over the live rows)
    # ------------------------------------------------------------------
    def _pairs(self, x, real_pairs):
        r = (x[:, 0, None] - x[None, :, 0], x[:, 1, None] - x[None, :, 1])
        rm = _sqrt(r[0] * r[0] + r[1] * r[1])
        # legacy search: within 2h (2.0 * dh * 1.00 support, legacy:230)
        mask = real_pairs & (rm < 2.0 * self.dh)
        return r, torch.clamp_min(rm, 1e-5), mask

    def _real_pairs(self, material, n):
        """real_i & real_j & (i != j) over the live rows [0, n) of the
        state's ``material``; kept while that tensor is the same
        (``add_cube`` makes a new one)."""
        cached = self._pair_base
        if cached is None or cached[0] is not material or cached[1] != n:
            real = material[:n] >= 0
            eye = torch.eye(n, dtype=torch.bool, device=material.device)
            cached = (material, n, real[None, :] & real[:, None] & ~eye)
            self._pair_base = cached
        return cached[2]

    def _visc_press_forces(self, s, r, rm, mask, dw, use_pressure=True):
        """Monaghan artificial viscosity (gated on approach, legacy:282-296)
        + symmetric pressure force (legacy:273-280); fluid centers only."""
        v_xy = _dot(s.v, r)
        rho_i = s.density[:, None]
        rho_j = s.density[None, :]
        vmu = div_exact(-2.0 * self.alpha * self.dx * self.c_0, rho_i + rho_j)
        coef = torch.where(mask & (v_xy < 0),
                           -self.m * vmu * v_xy
                           / (rm * rm + 0.01 * self.dx ** 2) * dw / rm, 0.0)
        if use_pressure:
            pi = s.pressure[:, None] / (rho_i * rho_i)
            pj = s.pressure[None, :] / (rho_j * rho_j)
            coef = coef + torch.where(mask, -self.m * (pi + pj) * dw / rm,
                                      0.0)
        return _radial_sum(coef, r)

    def _d_rho(self, v, r, rm, mask, dw):
        """Continuity-equation density derivative (legacy:262-266)."""
        return torch.where(mask, self.m * dw * _dot(v, r) / rm, 0.0).sum(1)

    def _p_update(self, rho):
        b = self.rho_0 * self.c_0 ** 2 / self.gamma
        return b * (_pow(rho * _recip(self.rho_0), self.gamma) - 1.0)

    # ------------------------------------------------------------------
    def _enforce_boundary(self, s: State2D):
        """Push-out + velocity reflection c_f = 0.3 (legacy:298-330).  Each
        wall's normal is axis-aligned, so v . n is the signed component and
        the reflection v - (1 + c_f) (v . n) n is v - (1 + c_f) v on that
        component, exactly."""
        c_f = 0.3
        fluid = (s.material == MATERIAL_FLUID)[:, None]
        x, v, vn = s.x, s.v, s.v_new
        for lim, sign in self._walls:
            off = x - lim
            hit = fluid & (sign * off < 0)
            x = torch.where(hit, x + sign * torch.abs(off), x)
            v = torch.where(hit, v - (1.0 + c_f) * v, v)
            if self.method == METHOD_DFSPH:
                vn = torch.where(hit, vn - (1.0 + c_f) * vn, vn)
        return s._replace(x=x, v=v, v_new=vn)

    # ------------------------------------------------------------------
    def _adaptive_dt(self, s: State2D, accel):
        """legacy adaptive_step (:731-761), fully on device.  max |v| is
        taken as sqrt(max |v|^2): the sqrt is monotone, so it is the same
        value."""
        if not self.adaptive_time_step:
            return s.dt
        fluid = (s.material == MATERIAL_FLUID)[:, None]
        rows = torch.stack(((s.v * s.v).sum(1), (accel * accel).sum(1),
                            s.density), dim=1)
        rows = torch.where(fluid, rows, 0.0)
        # the 0 row stands for the padding rows (and keeps an empty prefix
        # defined); the floors below are > 0, so it never decides
        top = torch.cat((rows, rows.new_zeros(1, 3))).amax(0)
        vmax = torch.clamp_min(_sqrt(top[0]), 1e-6)
        amax = torch.clamp_min(_sqrt(top[1]), 1e-6)
        dt_cfl = div_exact(self.CFL_v * self.dh, vmax)
        dt_f = self.CFL_a * _sqrt(div_exact(self.dh, amax))
        if self.method == METHOD_DFSPH:
            return torch.minimum(dt_cfl, dt_f)
        if self.method == METHOD_WCSPH:
            rho_max = torch.clamp_min(top[2], self.rho_0)
            dt_a = div_exact(0.20 * self.dh, self.c_0 * _sqrt(
                _pow(rho_max * _recip(self.rho_0), self.gamma)))
            return torch.minimum(torch.minimum(dt_cfl, dt_f), dt_a)
        return torch.minimum(dt_cfl, dt_f)  # PCISPH

    # ------------------------------------------------------------------
    def _step(self, s: State2D):
        """One step: returns (new state, iterations as an i32 tensor) and
        sets ``loop_reads`` to the loops' host reads."""
        n = s.n
        heads = {f: getattr(s, f)[:n] for f in _ARRAY_FIELDS}
        live = State2D(**heads, n=n, dt=s.dt)
        r, rm, mask = self._pairs(live.x, self._real_pairs(s.material, n))
        dw = cubic_kernel_derivative_2d(rm, self.dh)
        fluid = (live.material == MATERIAL_FLUID)[:, None]
        real = live.material >= 0
        dt = s.dt
        it = self._zero_i32
        self.loop_reads = 0
        # what the JAX step writes into the padding rows, where it is not
        # the incoming value
        tails = {"d_v": 0.0}

        if self.method == METHOD_WCSPH:
            d_rho = self._d_rho(live.v, r, rm, mask, dw)
            acc = self._visc_press_forces(live, r, rm, mask, dw)
            acc = torch.where(fluid, acc + self._g, 0.0)
            v = torch.where(fluid, live.v + dt * acc, live.v)
            x = torch.where(fluid, live.x + dt * v, live.x)
            density = torch.where(real, live.density + dt * d_rho,
                                  live.density)
            pressure = torch.where(real, self._p_update(density),
                                   live.pressure)
            live = live._replace(x=x, v=v, density=density,
                                 pressure=pressure,
                                 d_v=torch.where(fluid, acc, 0.0))

        elif self.method == METHOD_PCISPH:
            live, it = self._pcisph_step(live, r, rm, mask, dw, fluid, real)
            tails.update(pressure=0.0, pressure_acc=0.0)

        else:  # DFSPH (legacy variant, step order legacy:798-840)
            live, it, alpha_tail = self._dfsph_step(live, r, rm, mask, dw,
                                                    fluid, real)
            tails.update(alpha=alpha_tail, v_new=s.v[n:])

        live = self._enforce_boundary(live)
        if self.method != METHOD_DFSPH:
            live = live._replace(dt=self._adaptive_dt(
                live, live.d_v + live.pressure_acc))

        fields = {}
        for f in _ARRAY_FIELDS:
            head, old = getattr(live, f), getattr(s, f)
            if head is heads[f] and f not in tails:
                fields[f] = old
                continue
            tail = tails.get(f, old[n:])
            if not torch.is_tensor(tail):
                tail = torch.full_like(old[n:], tail)
            fields[f] = torch.cat((head, tail))
        return State2D(**fields, n=n, dt=live.dt), it

    # ------------------------------------------------------------------
    def _pcisph_step(self, s, r, rm, mask, dw, fluid, real):
        """Prediction-correction loop (legacy:458-483, 776-797)."""
        dt = s.dt
        # non-pressure deltas + zero pressure state (legacy:458-483)
        acc_np = self._visc_press_forces(s, r, rm, mask, dw,
                                         use_pressure=False)
        acc_np = torch.where(fluid, acc_np + self._g, 0.0)
        c = dt * self.m * _recip(self.rho_0)
        s_f = div_exact(1.0, torch.clamp_min(
            2.0 * (c * c) * self.s_f_base, 1e-6))
        rho_sq = s.density * s.density

        def body(carry, active):
            pressure, p_acc, d_rho, err, i = carry
            v_new = torch.where(fluid, s.v + dt * (acc_np + p_acc), s.v)
            x_new = torch.where(fluid, s.x + dt * v_new, s.x)
            # predicted divergence on predicted positions (legacy:414)
            r2 = (x_new[:, 0, None] - x_new[None, :, 0],
                  x_new[:, 1, None] - x_new[None, :, 1])
            rm2 = torch.clamp_min(_sqrt(r2[0] * r2[0] + r2[1] * r2[1]),
                                  1e-5)
            dw2 = cubic_kernel_derivative_2d(rm2, self.dh)
            m2 = mask & (rm2 > 1e-5)
            d_rho = torch.where(m2, dw2 * _dot(v_new, r2) / rm2, 0.0).sum(1)
            rho_err = torch.where(real, s.density + dt * d_rho - self.rho_0,
                                  0.0)
            pressure = pressure + s_f * rho_err
            # pressure force on predicted positions (legacy:443-456)
            pi = (pressure / rho_sq)[:, None]
            pj = (pressure / rho_sq)[None, :]
            coef = torch.where(m2, -self.m * (pi + pj) * dw2 / rm2, 0.0)
            p_acc = _radial_sum(coef, r2)
            err = torch.cat((torch.abs(rho_err), self._zero_f32)).amax()
            return pressure, p_acc, d_rho, err, i + 1

        def cond(carry):
            err, i = carry[3], carry[4]
            return ((err >= 0.01 * self.rho_0) | (i < 3)) & (i <= 1000)

        z1 = torch.zeros_like(s.pressure)
        init = (z1, torch.zeros_like(s.v), z1,
                self._inf, self._zero_i32)
        (pressure, p_acc, d_rho, _, it), self.loop_reads = jacobi_while(
            cond, body, init, every=PCISPH_CHECK_EVERY)
        v = torch.where(fluid, s.v + dt * (acc_np + p_acc), s.v)
        x = torch.where(fluid, s.x + dt * v, s.x)
        density = torch.where(real, s.density + dt * d_rho, s.density)
        return s._replace(x=x, v=v, density=density, pressure=pressure,
                          pressure_acc=p_acc,
                          d_v=torch.where(fluid, acc_np, 0.0)), it

    # ------------------------------------------------------------------
    def _dfsph_step(self, s, r, rm, mask, dw, fluid, real):
        """Returns (state, iterations, alpha of the padding rows)."""
        dt = s.dt
        n = s.n
        m2 = mask & (rm > 1e-4)
        fluid_j = fluid[:, 0][None, :]
        c = self.m * dw / rm
        grad = (torch.where(m2, c * r[0], 0.0), torch.where(m2, c * r[1], 0.0))

        # rho + alpha (legacy:600-625); note density fully recomputed
        w = cubic_kernel_2d(rm, self.dh)
        density = torch.where(m2, self.m * w, 0.0).sum(1)
        gs = (grad[0].sum(1), grad[1].sum(1))
        grad_sq = torch.where(fluid_j, grad[0] * grad[0] + grad[1] * grad[1],
                              0.0).sum(1)
        den = gs[0] * gs[0] + gs[1] * gs[1] + grad_sq
        # every row, as the JAX step writes it: 0 in the padding rows
        den = torch.cat((den, den.new_zeros(self.max_num_particles - n)))
        alpha = div_exact(-1.0, torch.clamp_min(den, 1e-6))
        density = torch.where(real, density, s.density)
        s = s._replace(density=density, alpha=alpha[:n], v_new=s.v)

        n_live = torch.clamp_min(real.to(torch.float32).sum(), 1.0)
        threshold = 0.01 * n_live * self.rho_0
        mdw = self.m * dw

        def df_drho(v_new):
            """legacy df d_rho: boundary neighbors contribute with v_j = 0
            (legacy:544-549, 637-648)."""
            vj = torch.where(fluid, v_new, 0.0)
            dot = ((v_new[:, 0, None] - vj[None, :, 0]) * r[0]
                   + (v_new[:, 1, None] - vj[None, :, 1]) * r[1])
            return torch.where(m2, mdw * dot / rm, 0.0).sum(1)

        def stiff_dv(stiff):
            """dv = sum_j m (k_i [+ k_j if fluid]) gradW (legacy:563-589)."""
            kj = torch.where(fluid[:, 0], stiff, 0.0)
            coef = torch.where(m2, self.m * (stiff[:, None] + kj[None, :])
                               * dw / rm, 0.0)
            return _radial_sum(coef, r)

        def div_iter(carry, active):
            v_new, _, i = carry
            d_rho = torch.clamp_min(df_drho(v_new), 0.0)
            # skip decompression (legacy:656-660)
            skip = ((s.density + dt * d_rho < self.rho_0)
                    & (s.density < self.rho_0))
            d_rho = torch.where(skip, 0.0, d_rho)
            v_new = v_new + stiff_dv(d_rho * s.alpha)
            return v_new, torch.where(real, d_rho, 0.0).sum(), i + 1

        def div_cond(carry):
            return (((carry[1] >= threshold) | (carry[2] < 1))
                    & (carry[2] <= 1000))

        (v_new, _, it1), reads1 = jacobi_while(
            div_cond, div_iter, (s.v, self._inf, self._zero_i32),
            every=JACOBI_CHECK_EVERY)
        v = torch.where(fluid, v_new, s.v)  # df_update_velocities
        s = s._replace(v=v, v_new=v_new)

        # non-pressure deltas (legacy:499-521)
        acc_np = self._visc_press_forces(s, r, rm, mask, dw,
                                         use_pressure=False)
        acc_np = torch.where(fluid, acc_np + self._g, 0.0)
        s = s._replace(d_v=acc_np, dt=self._adaptive_dt(s, acc_np))
        dt = s.dt

        # predict velocities v* (legacy:523-528)
        v_star = torch.where(fluid, s.v + dt * acc_np, s.v)

        def rho_iter(carry, active):
            v_new, _, i = carry
            rho_star = s.density + dt * df_drho(v_new)
            err = torch.clamp_min(rho_star - self.rho_0, 0.0)
            v_new = v_new + stiff_dv(err * s.alpha) / torch.clamp_min(dt,
                                                                       1e-5)
            return v_new, torch.where(real, err, 0.0).sum(), i + 1

        def rho_cond(carry):
            return (((carry[1] >= threshold) | (carry[2] < 2))
                    & (carry[2] <= 1000))

        (v_new, _, it2), reads2 = jacobi_while(
            rho_cond, rho_iter, (v_star, self._inf, self._zero_i32),
            every=JACOBI_CHECK_EVERY)
        self.loop_reads = reads1 + reads2
        x = torch.where(fluid, s.x + dt * v_new, s.x)
        return s._replace(x=x, v_new=v_new), it1 + it2, alpha[n:]

    # ------------------------------------------------------------------
    # public API (legacy names)
    # ------------------------------------------------------------------
    def step(self, frame=0, t=0.0, total_start=0.0):
        """One step; returns dt.  Reads dt and the iteration count to the
        host in one transfer."""
        self.state, it = self._step(self.state)
        host = torch.stack((self.state.dt, it.to(torch.float32))).cpu()
        self.it = int(host[1])
        self.reads = self.loop_reads + 1
        return float(host[0])

    def add_cube(self, lower_corner, cube_size, material, color=0xFFFFFF,
                 density=None, pressure=None, velocity=None):
        """Lattice fill at dx pitch into the next free slots
        (legacy:906-954).  Works mid-simulation: emission just claims more
        capacity; raises ValueError past it."""
        axes = [np.arange(lower_corner[i], lower_corner[i] + cube_size[i],
                          self.dx) for i in range(self.dim)]
        num = reduce(lambda a, b: a * b, [len(ax) for ax in axes])
        pos = np.array(np.meshgrid(*axes, sparse=False, indexing="ij"),
                       dtype=np.float32).reshape(self.dim, -1).T
        n0 = self.state.n
        if n0 + num > self.max_num_particles:
            raise ValueError(f"capacity exceeded: {n0} + {num} particles "
                             f"> max_num_particles {self.max_num_particles}")
        dens = float(density[0] if hasattr(density, "__len__") else
                     (density or 1000.0))
        pres = float(pressure[0] if hasattr(pressure, "__len__") else
                     (pressure or 0.0))
        vel = np.asarray(velocity if velocity is not None
                         else np.zeros(self.dim), np.float32)

        s = self.state
        dev = self.device
        block = slice(n0, n0 + num)

        def put(a, value):
            a = a.clone()
            a[block] = value
            return a

        vel_rows = torch.tensor(np.tile(vel, (num, 1)), device=dev)
        self.state = s._replace(
            x=put(s.x, torch.tensor(pos, device=dev)),
            v=put(s.v, vel_rows), v_new=put(s.v_new, vel_rows),
            pressure=put(s.pressure, pres), density=put(s.density, dens),
            material=put(s.material, int(material)),
            color=put(s.color, int(color)), n=n0 + num)

    def particle_info(self):
        """numpy export (legacy:956-972)."""
        s = self.state
        live = s.material[:s.n].cpu().numpy() >= 0
        return {
            "position": s.x[:s.n].cpu().numpy()[live],
            "velocity": s.v[:s.n].cpu().numpy()[live],
            "material": s.material[:s.n].cpu().numpy()[live],
            "color": s.color[:s.n].cpu().numpy()[live],
        }
