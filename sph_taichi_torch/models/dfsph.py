"""Divergence-free SPH solver (counterpart of sph_taichi_tpu/models/dfsph.py).

Substep (DFSPH.py:400-408): densities and the alpha factor -> divergence
solver -> non-pressure forces with the velocity kick -> constant-density
pressure solver -> advection.  On the CUDA engine each pair sum is a
kernel of ``ops/cuda_dfsph.py``; on the plain engine its plain version.
The positions stay those of the sort until the advection, so on the CUDA
engine the density-and-factor kernel writes the step's pair list of the
fluid centres as it sums (``cuda_dfsph.density_factor_list``), and every
later pair kernel of the step is given that context: over the cell runs
the non-pressure kernel reads the list (the two solves' kernels walk the
cell runs in two phases), over the slot walk the two solves' kernels read
it (the non-pressure kernel walks the slot map).

The reference reads the average density error to the host every Jacobi
iteration (DFSPH.py:248-257, 330-337).  Here each solve is
``jacobi_while``: the loop test is evaluated on the device every
iteration and read to the host once every JACOBI_CHECK_EVERY iterations,
and an iteration whose test is false commits nothing, so iteration counts
and results equal the JAX package's ``lax.while_loop``.

Parity notes (as the JAX package):
- divergence eta = (1/dt) * 0.1% * rho0, density eta = 0.05% * rho0; at
  most 100 iterations; both loops run at least once;
- density_adv is zeroed below 20 (3D) / 7 (2D) neighbours;
- the m_eps = 1e-5 stiffness gate;
- alpha is divided by dt (divergence) and dt^2 (pressure) per solve;
- only the pressure solve's reaction on dynamic rigids is kept, in gather
  form: the divergence solve's reaction is overwritten by the non-pressure
  forces that follow it in the reference (DFSPH.py:98-99);
- advection: v += dt * acc for dynamic rigids, x += dt * v for every
  dynamic particle (DFSPH.py:105-112).
On a slab of a sharded run (parallel/sharding.py) the step refreshes the
ghost rows' copies where the JAX package syncs them: density and factor
after the density-and-factor kernel, v after each Jacobi velocity update
and after the non-pressure kick, the density change after each of its
kernels; the step's pair list, written over the step-start positions,
holds the ghost rows as candidates and serves the slab's kernels.  The
solves' errors are summed over the owned fluid rows across ranks, so every
rank runs the same iterations.  The JAX package's lane buffers and fused
solver update are TPU-only and not ported.
"""

import torch

from sph_taichi_torch.ops import cuda_dfsph
from sph_taichi_torch.ops.pairs import div_exact
from sph_taichi_torch.models.base import (
    JACOBI_CHECK_EVERY, SPHBase, compute_non_pressure_forces, ectx,
    jacobi_while, owned_sum, sync_fields, sync_tensors, with_engine_ctx)
from sph_taichi_torch.state import Particles

class DFSPHSolver(SPHBase):
    def __init__(self, params, device=None, engine=None):
        self.m_max_iterations_v = 100   # DFSPH.py:14
        self.m_max_iterations = 100     # DFSPH.py:15
        self.m_eps = cuda_dfsph.M_EPS   # DFSPH.py:17
        self.max_error_V = 0.1          # %, DFSPH.py:19
        self.max_error = 0.05           # %, DFSPH.py:20
        self.check_every = JACOBI_CHECK_EVERY
        super().__init__(params, device=device, engine=engine)
        # the step's pair list's device buffers (density_factor_list),
        # allocated at the first step and reused
        self._pair_buffers = {}

    def _op(self, name):
        """The kernel wrapper on the CUDA engine, else its plain version;
        both take the engine's context (cell offsets or neighbour lists)
        first."""
        return getattr(cuda_dfsph,
                       name if self.engine.fused else f"{name}_plain")

    # ------------------------------------------------------------------
    def density_and_factor(self, p: Particles, ctx):
        """compute_densities (DFSPH.py:37-47) and compute_DFSPH_factor
        (DFSPH.py:115-155) in one traversal."""
        return self.density_factor_and_pairs(p, ctx)[0]

    def density_factor_and_pairs(self, p: Particles, ctx):
        """``density_and_factor``, with the context of the step's later
        pair kernels (the two solves and the non-pressure kernel), which
        walk the same pairs at the same positions: returns (p, that
        context).  On the CUDA engine one kernel also writes the step's
        pair list into the solver's buffers, a ``PairList`` over the cell
        offsets or the slot map (``cuda_dfsph.density_factor_list``); on
        CPU tensors the context is the slot map or the plain engine's
        neighbour lists, and on the plain engine ``ctx``.  Given a
        ``StepCtx`` it refreshes the ghost rows' density and factor and
        returns a ``StepCtx`` over that context."""
        step, ctx = ctx, ectx(ctx)
        if self.engine.fused:
            density, factor, ctx = cuda_dfsph.density_factor_list(
                ctx, p, self.params, self._pair_buffers)
        else:
            density, factor = cuda_dfsph.density_factor_plain(ctx, p,
                                                               self.params)
        p = sync_fields(step, p._replace(density=density,
                                         dfsph_factor=factor),
                        ["density", "dfsph_factor"])
        return p, with_engine_ctx(step, ctx)

    def compute_factor(self, p: Particles, ctx):
        """alpha_i alone (DFSPH.py:115-155); no step calls it.  It is the
        factor output of the density-and-factor traversal."""
        return self.density_and_factor(p, ctx).dfsph_factor

    def _density_change(self, p: Particles, ctx, v, active=None):
        """(adv, errt) of compute_density_change (DFSPH.py:158-194); adv's
        ghost rows refreshed."""
        adv, errt = self._op("divergence")(ectx(ctx), p, v, None, None,
                                           "change", self.params,
                                           active=active)
        return sync_tensors(ctx, adv), errt

    def _density_adv(self, p: Particles, ctx, v, density, dt, active=None):
        """(adv, errt) of compute_density_adv (DFSPH.py:197-218); adv's
        ghost rows refreshed."""
        adv, errt = self._op("divergence")(ectx(ctx), p, v, density, dt,
                                           "adv", self.params, active=active)
        return sync_tensors(ctx, adv), errt

    def _avg_density_error(self, errt, ctx=None):
        """sum over fluid of (rho0 adv - offset) / n_fluid
        (DFSPH.py:221-227), from the traversal's per-centre column (0 off
        fluid rows): on a slab over its owned rows, across ranks."""
        n_real = self.params.n_fluid + self.params.n_solid
        return div_exact(owned_sum(ctx, errt, n_real),
                         float(self.params.n_fluid))

    def _solver_dv(self, p, ctx, kappa, with_reaction, dt, v, acc=None,
                   active=None):
        """One Jacobi velocity update (v, acc or None), v's ghost rows
        refreshed; see cuda_dfsph.solver_dv_plain."""
        v, acc = self._op("solver_dv")(ectx(ctx), p, kappa, v, acc, dt,
                                       with_reaction, self.params,
                                       active=active)
        return sync_tensors(ctx, v), acc

    # ------------------------------------------------------------------
    def divergence_solve(self, p: Particles, ctx, dt):
        """DFSPH.py:236-311 as a device-tested loop.  With
        params.dfsph_warm_start, one velocity kick from half of the last
        substep's accumulated stiffness precedes the loop, and the
        substep's kappa sum is kept in p.kappa_v."""
        factor = p.dfsph_factor / dt
        eta = div_exact(1.0, dt) * self.max_error_V * 0.01 * self.density_0
        fluid = p.is_fluid()
        warm = self.params.dfsph_warm_start and p.kappa_v is not None

        v_start = p.v
        kacc0 = torch.zeros_like(p.density)
        if warm:
            kappa0 = torch.where(fluid, 0.5 * p.kappa_v, 0.0)
            v_start, _ = self._solver_dv(p, ctx, kappa0, False, dt, p.v)
            kacc0 = kappa0
        adv0, _ = self._density_change(p, ctx, v_start)

        def body(carry, active):
            v, adv, kacc, _, it = carry
            kappa = adv * factor
            v, _ = self._solver_dv(p, ctx, kappa, False, dt, v,
                                   active=active)
            adv, errt = self._density_change(p, ctx, v, active=active)
            return (v, adv, kacc + kappa, self._avg_density_error(errt, ctx),
                    it + 1)

        def cond(carry):
            err, it = carry[-2:]
            return (it == 0) | ((err > eta)
                                & (it < self.m_max_iterations_v))

        init = (v_start, adv0, kacc0, self._zero(torch.float32),
                self._zero(torch.int32))
        (v, adv, kacc, err, iters), reads = jacobi_while(
            cond, body, init, self.check_every)
        p = p._replace(v=v, density_adv=adv)
        if warm:
            p = p._replace(kappa_v=kacc)
        return p, {"divergence_iters": iters, "divergence_error": err,
                   "divergence_host_reads": reads}

    # ------------------------------------------------------------------
    def pressure_solve(self, p: Particles, ctx, dt):
        """DFSPH.py:314-389 as a device-tested loop, accumulating the
        two-way reaction on dynamic-rigid accelerations."""
        factor = p.dfsph_factor / (dt * dt)
        eta = self.max_error * 0.01 * self.density_0
        fluid = p.is_fluid()
        react = bool(self.params.dynamic_rigid_ids)
        warm = self.params.dfsph_warm_start and p.kappa_p is not None

        v_start, acc_start = p.v, p.acc
        kacc0 = torch.zeros_like(p.density)
        if warm:
            kappa0 = torch.where(fluid, 0.5 * p.kappa_p, 0.0)
            v_start, acc_new = self._solver_dv(p, ctx, kappa0, react, dt,
                                               p.v, p.acc)
            if react:
                acc_start = acc_new
            kacc0 = kappa0
        adv0, _ = self._density_adv(p, ctx, v_start, p.density, dt)

        def body(carry, active):
            v, acc, adv, kacc, _, it = carry
            kappa = (adv - 1.0) * factor
            v, acc_new = self._solver_dv(p, ctx, kappa, react, dt, v, acc,
                                         active=active)
            if react:
                acc = acc_new
            adv, errt = self._density_adv(p, ctx, v, p.density, dt,
                                          active=active)
            return (v, acc, adv, kacc + kappa,
                    self._avg_density_error(errt, ctx), it + 1)

        def cond(carry):
            err, it = carry[-2:]
            return (it == 0) | ((err > eta) & (it < self.m_max_iterations))

        init = (v_start, acc_start, adv0, kacc0, self._zero(torch.float32),
                self._zero(torch.int32))
        (v, acc, adv, kacc, err, iters), reads = jacobi_while(
            cond, body, init, self.check_every)
        p = p._replace(v=v, acc=acc, density_adv=adv)
        if warm:
            p = p._replace(kappa_p=kacc)
        return p, {"pressure_iters": iters, "pressure_error": err,
                   "pressure_host_reads": reads}

    def _zero(self, dtype):
        return torch.zeros((), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def advect(self, p: Particles, dt):
        """v += dt * acc for dynamic rigids; x += dt * v for every dynamic
        particle (DFSPH.py:105-112)."""
        v = torch.where(p.is_dynamic_rigid()[:, None], p.v + dt * p.acc, p.v)
        dyn = (p.is_dynamic != 0)[:, None]
        return p._replace(v=v, x=torch.where(dyn, p.x + dt * v, p.x))

    def substep(self, p: Particles, ctx, dt):
        # the later pair kernels' context: on the CUDA engine the pair list
        # the density-and-factor kernel wrote
        p, pairs = self.density_factor_and_pairs(p, ctx)
        p, metrics = self.divergence_solve(p, pairs, dt)
        # non-pressure forces and the fluid kick v += dt * acc
        # (DFSPH.py:392-397) in one traversal
        p = compute_non_pressure_forces(p, pairs, self.engine, self.params,
                                        predict_dt=dt)
        p = sync_fields(pairs, p, ["v"])
        p, m = self.pressure_solve(p, pairs, dt)
        metrics.update(m)
        return self.advect(p, dt), metrics
