"""Implicit incompressible SPH solver (counterpart of sph_taichi_tpu/models/iisph.py).

Relaxed-Jacobi IISPH (Ihmsen et al. 2014) in the corrected form of the JAX
package (the reference's IISPH.py is stale and its a_ii loops carry index
typos): omega = 0.5, warm start last_p = 0.5 p, average error
|Ap - s| / rho0 below 1e-3 or at most 1000 iterations, at least one.

Substep (IISPH.py:259-267): densities -> gravity + fluid viscosity and the
fluid kick v* = v + dt a -> a_ii and the source term -> pressure solve ->
pressure acceleration and advection (fluid rows: v += dt a_p, x += dt v).
On the CUDA engine each pair sum is a kernel of ``ops/cuda_iisph.py`` with
its epilogue; on the plain engine its plain version, which applies the same
epilogue in torch (the JAX package's unfused path on its gather engine).
The positions stay those of the sort until the advect (the kick moves v),
so on the CUDA engine the density kernel writes the step's pair list of
every real centre as it sums (``compute_densities_and_pairs``), over the
cell runs or the slot map, and every later pair kernel of the step reads
it: the non-pressure kick, the advection prediction, the loop's pressure
acceleration and A, and the final pressure acceleration with the advect.

The pressure solve is ``jacobi_while`` (models/base.py): the test
``it == 0 | (err >= tol & it < 1000)`` is evaluated on the device and read
to the host once every JACOBI_CHECK_EVERY iterations, so iteration counts
and results equal the JAX package's ``lax.while_loop``.  Inside the loop
the pressure acceleration of every real row is kept, solids' too: A reads
it in (a_i - a_j) . r_ij.  Only the final acceleration is applied, to fluid
rows.

On a slab of a sharded run (parallel/sharding.py) the step refreshes the
ghost rows' density after the density kernel, v* after the kick, and in
each iteration the pressure acceleration (A reads a_j at neighbours; the
JAX package's sharded loop does not refresh it) and the new pressure; the
step's pair list holds the ghost rows as candidates and serves the slab's
kernels.  The error is summed over the owned real rows across ranks.  The
JAX package's lane buffers and fused switch are TPU machinery and are not
ported.
"""

import torch

from sph_taichi_torch.ops import cuda_iisph
from sph_taichi_torch.ops.pairs import div_exact
from sph_taichi_torch.models.base import (
    JACOBI_CHECK_EVERY, SPHBase, compute_densities_and_pairs, ectx,
    jacobi_while, owned_sum, sync_fields, sync_tensors)
from sph_taichi_torch.state import Particles


class IISPHSolver(SPHBase):
    def __init__(self, params, device=None, engine=None):
        self.omega = 0.5          # IISPH.py:116
        self.max_iterations = 1000
        self.tolerance = 1e-3     # IISPH.py:110
        self.check_every = JACOBI_CHECK_EVERY
        super().__init__(params, device=device, engine=engine)
        # the step's pair list's device buffers (density_sum_list),
        # allocated at the first step and reused
        self._pair_buffers = {}

    def _op(self, name):
        """The kernel wrapper on the CUDA engine, else its plain version;
        both take the step's context (from ``compute_densities_and_pairs``:
        the pair list, the slot map or the plain engine's neighbour lists)
        first."""
        return getattr(cuda_iisph,
                       name if self.engine.fused else f"{name}_plain")

    # ------------------------------------------------------------------
    def compute_non_pressure(self, p: Particles, ctx, dt):
        """Gravity + fluid viscosity for every real particle
        (IISPH.py:236-249) into p.acc, and the fluid kick v* = v + dt acc
        (IISPH.py:73-75) into p.v, whose ghost rows are refreshed."""
        acc, v = self._op("nonpressure_kick")(ectx(ctx), p, dt, self.params)
        return sync_fields(ctx, p._replace(acc=acc, v=v), ["v"])

    def predict_advection(self, p: Particles, ctx, dt):
        """(a_ii, source, last_p) from v* (IISPH.py:20-100)."""
        return self._op("predict_advection")(ectx(ctx), p, dt, self.params)

    def _pressure_accel(self, p: Particles, ctx, pressure, advect_dt=None,
                        active=None):
        """Symmetric pressure acceleration of every real row
        (IISPH.py:114-144); with ``advect_dt`` the fluid advect follows
        (IISPH.py:251-257) and p with the new (v, x) is returned."""
        out = self._op("pressure_accel")(ectx(ctx), p, pressure,
                                         self.params, advect_dt=advect_dt,
                                         active=active)
        if advect_dt is None:
            return out
        v, x = out
        return p._replace(v=v, x=x)

    def _apply_A(self, p: Particles, ctx, accel, a_ii, source, last_p, dt,
                 active=None):
        """One relaxed-Jacobi update from Ap_i = dt^2 rho0 sum_j m_V_j
        (a_i - a_j) . gradW_ij (IISPH.py:146-179): (new_p, per-row error
        term)."""
        return self._op("apply_A")(ectx(ctx), p, accel, a_ii, source,
                                   last_p, dt, self.omega, self.params,
                                   active=active)

    # ------------------------------------------------------------------
    def pressure_solve(self, p: Particles, ctx, a_ii, source, last_pressure,
                       dt):
        """Relaxed Jacobi to avg |Ap - s| / rho0 < 1e-3, at most 1000
        iterations (IISPH.py:102-179), as a device-tested loop over the
        step's context ``ctx``.  Returns (pressure, metrics)."""
        n_real = self.params.n_fluid + self.params.n_solid
        n_particles = float(self.params.n_particles)

        def body(carry, active):
            last_p, _, it = carry
            accel = sync_tensors(ctx, self._pressure_accel(p, ctx, last_p,
                                                           active=active))
            new_p, err_t = self._apply_A(p, ctx, accel, a_ii, source, last_p,
                                         dt, active=active)
            return (sync_tensors(ctx, new_p),
                    div_exact(owned_sum(ctx, err_t, n_real), n_particles),
                    it + 1)

        def cond(carry):
            _, err, it = carry
            return (it == 0) | ((err >= self.tolerance)
                                & (it < self.max_iterations))

        init = (last_pressure,
                torch.zeros((), dtype=torch.float32, device=self.device),
                torch.zeros((), dtype=torch.int32, device=self.device))
        (pressure, err, iters), reads = jacobi_while(cond, body, init,
                                                     self.check_every)
        return pressure, {"pressure_iters": iters, "pressure_error": err,
                          "pressure_host_reads": reads}

    # ------------------------------------------------------------------
    def advect(self, p: Particles, pressure_accel, dt):
        """Fluid only: v += dt a_p (v holds v*); x += dt v
        (IISPH.py:251-257)."""
        v, x = cuda_iisph.advect(p, pressure_accel, dt)
        return p._replace(v=v, x=x)

    def substep(self, p: Particles, ctx, dt):
        p, ctx = compute_densities_and_pairs(p, ctx, self.engine, self.params,
                                             self._pair_buffers)
        p = self.compute_non_pressure(p, ctx, dt)
        a_ii, source, last_p = self.predict_advection(p, ctx, dt)
        pressure, metrics = self.pressure_solve(p, ctx, a_ii, source, last_p,
                                                dt)
        p = p._replace(pressure=pressure)
        # the final acceleration with the advect in its epilogue
        return self._pressure_accel(p, ctx, pressure, advect_dt=dt), metrics
