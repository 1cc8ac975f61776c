"""Weakly-compressible SPH solver (counterpart of sph_taichi_tpu/models/wcsph.py).

Substep (WCSPH.py:152-156): densities -> non-pressure and pressure forces
in one fused pair sum -> symplectic Euler.  On the CUDA engine the force
kernel also runs advection and the fluid box clamp in its epilogue; the
plain engine computes accelerations, then advects, and the step clamps.
The positions stay those of the sort until that epilogue, so on the CUDA
engine the density kernel writes the step's pair list as it sums, and
the force kernel reads it, over the cell runs and over the slot walk
(ops/cuda_pairs.py ``density_sum_list``).  On a slab of a sharded run
(parallel/sharding.py) the ghost densities are refreshed between the two
kernels; the list, written over the step-start positions, holds the ghost
rows as candidates and serves the force kernel there too.

Quirks of the reference kept as they are:
- density is clamped to >= rho0 *and stored* before the EOS (WCSPH.py:75);
- the boundary pressure mirror uses p_j := p_i and rho_j := rho0
  (WCSPH.py:58-65);
- boundary viscosity is 0.0 (WCSPH.py:118), so no viscosity reaction;
- two-way coupling: the reference's atomic scatter onto rigid neighbours
  (WCSPH.py:67-68) is a gather over the rigid particle's fluid neighbours.
"""

import torch

from sph_taichi_torch.state import Particles
from sph_taichi_torch.ops import cuda_pairs
from sph_taichi_torch.ops.pairs import div_exact
from sph_taichi_torch.models.base import (
    SPHBase, compute_densities_and_pairs, ectx)


class WCSPHSolver(SPHBase):
    def __init__(self, params, device=None, engine=None):
        self.exponent = params.exponent      # WCSPH.py:9-10
        self.stiffness = params.stiffness    # WCSPH.py:12-13
        super().__init__(params, device=device, engine=engine)
        # the step's pair list's device buffers (density_sum_list),
        # allocated at the first step and reused
        self._pair_buffers = {}

    def substep(self, p: Particles, ctx, dt):
        # the force kernel's context: the pair list the density kernel
        # wrote, on the CUDA engine over either walk
        p, ctx = compute_densities_and_pairs(p, ctx, self.engine,
                                             self.params, self._pair_buffers)
        fused = self.engine.fused
        p = self.compute_forces(p, ctx, dt=dt if fused else None)
        if not fused:
            p = self.advect(p, dt)
        # read by SPHBase.step right after this call
        self._boundary_fused = fused
        return p, {}

    def force_inputs(self, p: Particles):
        """Density clamp and Tait EOS (WCSPH.py:75-76), then the
        per-particle quotients the force term reads (WCSPH.py:56-65, 114).
        Returns (p with clamped density and pressure, dpi, p_r02, m_nc,
        rr0); rr0 = rho0 / density only when some rigid is dynamic."""
        rho0 = self.density_0
        fluid = p.is_fluid()
        density_nc = p.density  # pre-clamp value: viscosity parity
        density = torch.where(fluid, torch.clamp_min(p.density, rho0),
                              p.density)
        pressure = torch.where(
            fluid,
            self.stiffness * (torch.pow(div_exact(density, rho0), self.exponent)
                              - 1.0),
            p.pressure)
        p = p._replace(density=density, pressure=pressure)
        dpi = p.pressure / (p.density * p.density)
        p_r02 = div_exact(p.pressure, rho0 * rho0)
        m_nc = p.m / density_nc
        rr0 = (div_exact(rho0, p.density) if self.params.dynamic_rigid_ids
               else None)
        return p, dpi, p_r02, m_nc, rr0

    def compute_forces(self, p: Particles, ctx, dt=None):
        """Fused WCSPH.py:88-141 (non-pressure) + :46-85 (pressure) + :67-68
        (rigid reaction, gather form).  With ``dt`` (CUDA engine; ``ctx``
        from ``compute_densities_and_pairs``) the kernel also advects and
        clamps; without, p.acc is set."""
        p, dpi, p_r02, m_nc, rr0 = self.force_inputs(p)
        ctx = ectx(ctx)
        if dt is not None:
            x, v, acc = cuda_pairs.wcsph_forces(ctx, p, dpi, p_r02, m_nc,
                                                rr0, dt, self.params)
            return p._replace(x=x, v=v, acc=acc)
        acc = cuda_pairs.wcsph_accel_plain(ctx, p, dpi, p_r02, m_nc, rr0,
                                           self.params)
        return p._replace(acc=acc)

    def advect(self, p: Particles, dt):
        """Symplectic Euler for every dynamic particle (WCSPH.py:143-149)."""
        x, v = cuda_pairs.symplectic_euler(p.x, p.v, p.acc,
                                           p.is_dynamic != 0, dt)
        return p._replace(x=x, v=v)
