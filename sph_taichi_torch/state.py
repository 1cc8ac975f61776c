"""Particle state and static simulation parameters, on torch tensors.

Counterpart of ``sph_taichi_tpu/state.py``.  The particle store is a
NamedTuple of per-particle tensors (SoA) on one device; a step builds a new
tuple with ``_replace`` instead of updating fields in place, so a state
handed to ``step`` is never modified.

Capacity is padded to a multiple of PAD_MULTIPLE, as in the JAX package, so
that both packages lay out the same arrays; padding particles carry
``material == MATERIAL_PAD`` and sort into a virtual overflow cell that no
neighbour search visits.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

# Material codes (reference particle_system.py:30-31). PAD is ours.
MATERIAL_SOLID = 0
MATERIAL_FLUID = 1
MATERIAL_PAD = -1

PAD_MULTIPLE = 512


class Particles(NamedTuple):
    """SoA particle store (reference particle_system.py:102-117).

    Every tensor has leading dim n_pad.  ``density`` of solid particles
    keeps its scene-assigned value forever, as in the reference.
    """
    object_id: torch.Tensor   # i32[N]
    x: torch.Tensor           # f32[N,3] position
    x0: torch.Tensor          # f32[N,3] rest position (reference x_0)
    v: torch.Tensor           # f32[N,3] velocity
    acc: torch.Tensor         # f32[N,3] acceleration
    m_V: torch.Tensor         # f32[N]   volume (boundary particles: Akinci volume)
    m: torch.Tensor           # f32[N]   mass = m_V0 * density at creation
    density: torch.Tensor     # f32[N]
    pressure: torch.Tensor    # f32[N]
    material: torch.Tensor    # i32[N]  1=fluid 0=solid -1=padding
    is_dynamic: torch.Tensor  # i32[N]
    color: torch.Tensor       # i32[N,3]
    # DFSPH extras (kappa_* only with the warm start); None for WCSPH
    dfsph_factor: Optional[torch.Tensor] = None
    density_adv: Optional[torch.Tensor] = None
    kappa_v: Optional[torch.Tensor] = None
    kappa_p: Optional[torch.Tensor] = None

    @property
    def n(self):
        return self.x.shape[0]

    def is_fluid(self):
        return self.material == MATERIAL_FLUID

    def is_solid(self):
        return self.material == MATERIAL_SOLID

    def is_static_rigid(self):
        # reference particle_system.py:302-303
        return (self.material == MATERIAL_SOLID) & (self.is_dynamic == 0)

    def is_dynamic_rigid(self):
        # reference particle_system.py:306-308
        return (self.material == MATERIAL_SOLID) & (self.is_dynamic != 0)


class SimState(NamedTuple):
    """Full dynamic simulation state threaded through ``step``."""
    p: Particles
    rigid_rest_cm: torch.Tensor   # f32[n_objects, 3] rest centre of mass per object id
    dt: torch.Tensor              # f32[] current timestep
    t: torch.Tensor               # f32[] simulated time
    step_count: torch.Tensor      # i32[]


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static simulation parameters.

    Derived constants follow reference particle_system.py:33-46:
    support_radius = 4*particle_radius, particle_diameter = 2r,
    m_V0 = 0.8 * diameter**dim, grid cell = support_radius,
    padding = one grid cell.
    """
    dim: int
    particle_radius: float
    density0: float
    gravity: tuple                # (3,)
    dt0: float                    # timeStepSize from scene
    stiffness: float              # WCSPH Tait EOS
    exponent: float               # WCSPH Tait EOS
    simulation_method: int
    domain_start: tuple
    domain_end: tuple
    # particle counts
    n_particles: int              # real particles
    n_fluid: int
    n_solid: int
    n_pad: int                    # array capacity (>= n_particles, PAD_MULTIPLE multiple)
    # object/rigid bookkeeping
    num_objects: int              # max object id + 1
    rigid_body_ids: tuple         # object ids that are rigid bodies/blocks
    dynamic_rigid_ids: tuple      # subset that is dynamic (reference iteration order)
    # pair engine (ops/pairs.py make_engine): "auto" | "gather" |
    # "pallas_blocks" | "pallas_slots"
    backend: str = "auto"
    # capacities of the plain engine's neighbour lists (ops/neighbors.py);
    # the cell-run CUDA engine walks cell ranges and has no caps
    neighbor_cap: int = 64        # K: max stored neighbours per particle
    cell_cap: int = 32            # M: max particles fetched per grid cell
    # slot engine (ops/slots.py): a cell holds 8 * slot_layers particles;
    # 4 matches cell_cap's 32
    slot_layers: int = 4
    # Per-object constants: material, creation density, is_dynamic and
    # creation mass are single-valued per object id, so bin_and_sort does
    # not permute them and restores them from these tables after the sort.
    # Empty tuples turn this off (scene.py sets them only when every
    # object id is single-valued).
    obj_material: tuple = ()
    obj_density0: tuple = ()
    obj_is_dynamic: tuple = ()
    obj_m0: tuple = ()            # creation m per object, tabled VERBATIM
    #                               (recomputing m_V0*density0 lands 1 ulp
    #                               off creation's f64-multiply-then-cast)
    dfsph_warm_start: bool = False  # DFSPH kappa warm start (TPU.dfsphWarmStart)
    # spatial sharding (parallel/sharding.py): a slab's extended grid, the
    # name of the axis its reductions cross (set: the step's context must
    # carry a communicator), and the global x-layer of its grid's layer 0.
    # A centre's cell is trunc(x / cell) - x_origin in x (ops/grid.py
    # pos_to_cell, the kernels' cell_x), so a slab's cell lookups index
    # its own grid; 0 on one device.
    grid_num_override: tuple = ()
    axis_name: str = ""
    x_origin: int = 0
    # fixed reference constants
    viscosity: float = 0.01       # sph_base.py:15
    surface_tension: float = 0.01 # WCSPH.py:15 / DFSPH.py:9
    collision_factor: float = 0.5 # c_f, sph_base.py:121

    # ---- derived (reference particle_system.py:33-46) ----
    @property
    def particle_diameter(self):
        return 2.0 * self.particle_radius

    @property
    def support_radius(self):
        return 4.0 * self.particle_radius

    @property
    def m_V0(self):
        return 0.8 * self.particle_diameter ** self.dim

    @property
    def domain_size(self):
        return tuple(e - s for e, s in zip(self.domain_end, self.domain_start))

    @property
    def grid_size(self):
        return self.support_radius

    @property
    def grid_num(self):
        if self.grid_num_override:
            return self.grid_num_override
        return tuple(int(np.ceil(s / self.grid_size)) for s in self.domain_size)

    @property
    def num_cells(self):
        n = 1
        for g in self.grid_num:
            n *= g
        return n

    @property
    def padding(self):
        return self.grid_size


def resolve_device(device=None):
    """The device an entry point runs on: the card unless the caller names
    another.  With no card present, only an explicit CPU request runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sph_taichi_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def pad_count(n, multiple=PAD_MULTIPLE):
    return int(-(-n // multiple) * multiple)


def make_particles(np_arrays, n_pad, device, with_dfsph=False,
                   with_warm=False):
    """Padded Particles on ``device`` from host numpy arrays of length n.

    Padding particles: material=-1, is_dynamic=0, parked far outside the
    domain so any distance test fails; the grid stage also forces their
    cell id into the overflow cell.
    """
    n = np_arrays["x"].shape[0]
    if n_pad < n:
        raise ValueError(f"n_pad {n_pad} < particle count {n}")

    def pad(a, fill=0):
        out = np.full((n_pad,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    far = 1e9  # way outside any domain
    zeros = np.zeros(n, np.float32)
    return Particles(
        object_id=pad(np_arrays["object_id"].astype(np.int32), -1),
        x=pad(np_arrays["x"].astype(np.float32), far),
        x0=pad(np_arrays["x"].astype(np.float32), far),
        v=pad(np_arrays["v"].astype(np.float32)),
        acc=pad(np.zeros_like(np_arrays["x"], dtype=np.float32)),
        m_V=pad(np_arrays["m_V"].astype(np.float32)),
        m=pad(np_arrays["m"].astype(np.float32)),
        density=pad(np_arrays["density"].astype(np.float32)),
        pressure=pad(np_arrays["pressure"].astype(np.float32)),
        material=pad(np_arrays["material"].astype(np.int32), MATERIAL_PAD),
        is_dynamic=pad(np_arrays["is_dynamic"].astype(np.int32)),
        color=pad(np_arrays["color"].astype(np.int32)),
        dfsph_factor=pad(zeros) if with_dfsph else None,
        density_adv=pad(zeros) if with_dfsph else None,
        kappa_v=pad(zeros) if with_warm else None,
        kappa_p=pad(zeros) if with_warm else None,
    )
