"""Predictive-corrective incompressible SPH (counterpart of sph_taichi_tpu/models/pcisph.py).

PCISPH (Solenthaler & Pajarola 2009) on the 3D machinery, as the JAX
package extends the reference (whose 3D engine has no PCISPH; its legacy 2D
engine has, legacy/engine/sph_solver.py:377-487):

- the scaling factor's lattice part is a host sum over an ideal lattice
  filling the support radius; per step s_f = 1 / max(2 (dt m_V0)^2 * base,
  1e-6) in f32, with dt the state's device scalar;
- the prediction-correction loop runs until max rho_err < 1% rho0, at
  least 3 and while at most 1000 iterations have run (up to 1001);
- each iteration evaluates the density derivative and the pressure
  acceleration at the predicted (x*, v*) over the step-start pair set
  (the fixed-neighbour-list PCISPH);
- the final predicted (x*, v*) are the fluid advect; dynamic rigids take
  v + dt acc and x + dt v; the non-pressure forces are those of WCSPH
  without a kick.

The loop has the JAX package's fused structure on both engines: on the
CUDA engine each iteration is the two kernels of ``ops/cuda_pcisph.py``
with their epilogues (the pressure correction, the velocity and position
predict), reading the step's pair list that the density kernel writes as
it sums (``compute_densities_and_pairs``, over the cell runs and the slot
walk alike), which the non-pressure kernel before the loop reads too over
the cell runs;
on the plain engine their plain versions apply the same epilogues in
torch, which is the JAX package's unfused loop with the same arithmetic.
The loop is ``jacobi_while`` (models/base.py): the JAX
condition is evaluated on the device and read to the host once every
``check_every`` iterations, so iteration counts and results equal the JAX
package's ``lax.while_loop``.  ``check_every`` is the minimum iteration
count, 3: the first read comes at the first iteration where the loop can
exit.

On a slab of a sharded run (parallel/sharding.py) the step refreshes the
ghost rows' density after the density kernel, the prediction (x*, v*) and
the pressure at the top of each iteration, and the corrected pressure
before the pressure acceleration reads it; the error is the largest over
the owned rows across ranks.  The step's pair list holds the ghost rows as
candidates and serves the slab's kernels.
"""

import numpy as np
import torch

from sph_taichi_torch.ops import cuda_pcisph
from sph_taichi_torch.ops.kernels import cubic_kernel_derivative_scalar
from sph_taichi_torch.ops.pairs import div_exact
from sph_taichi_torch.models.base import (
    SPHBase, compute_densities_and_pairs, compute_non_pressure_forces, ectx,
    jacobi_while, owned_max, sync_tensors)
from sph_taichi_torch.state import Particles


class PCISPHSolver(SPHBase):
    def __init__(self, params, device=None, engine=None):
        self.max_iterations = 1000   # legacy:794
        self.min_iterations = 3      # legacy:795 (i < 3 keeps looping)
        self.tolerance_frac = 0.01   # 1% rho0 (legacy:793)
        self.check_every = self.min_iterations
        super().__init__(params, device=device, engine=engine)
        self.s_f_base = self._scaling_base(params)
        # the step's pair list's device buffers (density_sum_list),
        # allocated at the first step and reused
        self._pair_buffers = {}

    @staticmethod
    def _scaling_base(params):
        """|sum gradW|^2 + sum |gradW|^2 over the ideal filled lattice
        (legacy:377-396, in 3D): a float64 host sum of the f32 gradient
        factor, as the JAX package computes it."""
        h = params.support_radius
        dx = params.particle_diameter
        half = int(np.ceil(h / dx)) + 1
        grad_sum = np.zeros(3)
        grad_dot = 0.0
        for xx in range(-half, half + 1):
            for yy in range(-half, half + 1):
                for zz in range(-half, half + 1):
                    r = -np.array([xx, yy, zz], np.float64) * dx
                    rm = float(np.linalg.norm(r))
                    if 1e-5 < rm < h:
                        d = float(cubic_kernel_derivative_scalar(
                            torch.tensor(rm, dtype=torch.float32), h, 3))
                        g = d * r
                        grad_sum += g
                        grad_dot += float(g @ g)
        return float(grad_sum @ grad_sum + grad_dot)

    def scaling_factor(self, dt):
        """s_f = 1 / max(2 (dt m_V0)^2 s_f_base, 1e-6) as a 0-d f32 tensor,
        in the JAX package's operation order (dt m / rho0 == dt m_V0)."""
        a = dt * self.params.m_V0
        return div_exact(1.0, torch.clamp_min(2.0 * (a * a) * self.s_f_base,
                                              1e-6))

    def _op(self, name):
        """The kernel wrapper on the CUDA engine, else its plain version;
        both take the engine's context (cell offsets or neighbour lists)
        first."""
        return getattr(cuda_pcisph,
                       name if self.engine.fused else f"{name}_plain")

    # ------------------------------------------------------------------
    def pressure_solve(self, p: Particles, ctx, dt):
        """Prediction-correction loop (legacy:776-797) as a device-tested
        loop over the step-start pairs of ``ctx`` (from
        ``compute_densities_and_pairs``: the loop's pair set is the step
        start's, so its list is read by every iteration).  Returns
        (pressure, (v*, x*), metrics): the final prediction is the fluid
        advect."""
        params = self.params
        fluid3 = p.is_fluid()[:, None]
        s_f = self.scaling_factor(dt)
        tol = self.tolerance_frac * params.density0
        d_rho_correct = self._op("d_rho_correct")
        accel_predict = self._op("pressure_accel_predict")

        pairs = ectx(ctx)

        def body(carry, active):
            pressure, vp, xp, _, it = carry
            xp, vp, pressure = sync_tensors(ctx, xp, vp, pressure)
            pressure, rho_err = d_rho_correct(pairs, p, xp, vp, pressure, dt,
                                              s_f, params, active=active)
            pressure = sync_tensors(ctx, pressure)
            # rho_err >= 0, and 0 off fluid rows
            err = owned_max(ctx, rho_err)
            vp, xp = accel_predict(pairs, p, xp, pressure, dt, params,
                                   active=active)
            return pressure, vp, xp, err, it + 1

        def cond(carry):
            _, _, _, err, it = carry
            return (((err >= tol) | (it < self.min_iterations))
                    & (it <= self.max_iterations))

        vp0 = torch.where(fluid3, p.v + dt * p.acc, p.v)
        xp0 = torch.where(fluid3, p.x + dt * vp0, p.x)
        init = (torch.zeros_like(p.pressure), vp0, xp0,
                torch.full((), np.inf, dtype=torch.float32,
                           device=self.device),
                torch.zeros((), dtype=torch.int32, device=self.device))
        (pressure, vp, xp, err, iters), reads = jacobi_while(
            cond, body, init, self.check_every)
        return pressure, (vp, xp), {"pressure_iters": iters,
                                    "pressure_error": err,
                                    "pressure_host_reads": reads}

    # ------------------------------------------------------------------
    def advect(self, p: Particles, vp, xp, dt):
        """Fluid rows take the loop's final prediction (v*, x*), the same
        formula as v += dt (a_np + a_p), x += dt v; dynamic rigids advect by
        the non-pressure acceleration alone (pcisph.py:265-277, 285-297)."""
        fluid3 = p.is_fluid()[:, None]
        v = torch.where(fluid3, vp, p.v)
        x = torch.where(fluid3, xp, p.x)
        dyn_r = p.is_dynamic_rigid()[:, None]
        v = torch.where(dyn_r, p.v + dt * p.acc, v)
        x = torch.where(dyn_r, p.x + dt * v, x)
        return p._replace(v=v, x=x)

    def substep(self, p: Particles, ctx, dt):
        p, ctx = compute_densities_and_pairs(p, ctx, self.engine, self.params,
                                             self._pair_buffers)
        p = compute_non_pressure_forces(p, ctx, self.engine, self.params)
        pressure, (vp, xp), metrics = self.pressure_solve(p, ctx, dt)
        return self.advect(p._replace(pressure=pressure), vp, xp, dt), metrics
