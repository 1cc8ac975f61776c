"""sph_taichi_torch — the SPH framework on PyTorch, with CUDA kernels for Hopper.

The PyTorch/CUDA port of ``sph_taichi_tpu`` (the JAX package, which stays
as the reference).  It runs the reference's scene JSON on one
NVIDIA H100 through WCSPH, PCISPH, IISPH and DFSPH: the grid, sort and
elementwise stages are plain PyTorch, and the pair traversals of each step
are hand-written CUDA kernels (``csrc/pairs.cu``, ``csrc/dfsph.cu``,
``csrc/iisph.cu`` and ``csrc/pcisph.cu``, bound in ``ops/cuda_pairs.py``,
``ops/cuda_dfsph.py``, ``ops/cuda_iisph.py`` and ``ops/cuda_pcisph.py``).
``backend="pallas_slots"`` walks the slot map of ``ops/slots.py`` instead
of cell runs, under every solver.  On the CPU the same steps run through
the plain PyTorch engines.

Public entry points (device=None means the CUDA device; without one, pass
``device="cpu"``):
    ``SimConfig``        — scene JSON loader (config.py)
    ``build_scene``      — scene -> (SimParams, Particles, SceneObjects)
    ``build_solver``     — simulationMethod -> solver
    ``simulation.Simulation`` — scene file -> frames, exports, checkpoints
    ``parallel.sharding.ShardedSolver`` — one rank's slab of a spatially
                           sharded solver over ``torch.distributed``
    ``entry``            — a WCSPH step function and the sharded dry run

The package imports neither JAX nor ``sph_taichi_tpu``.
"""

from sph_taichi_torch.config import SimConfig
from sph_taichi_torch.scene import build_scene
from sph_taichi_torch.state import Particles, SimParams, SimState

__version__ = "0.1.0"


def build_solver(params, device=None, engine=None):
    """Instantiate the solver selected by ``simulationMethod``: 0 -> WCSPH,
    1 -> PCISPH, 2 -> IISPH, 4 -> DFSPH.

    Any other method is not implemented, as in the reference
    (particle_system.py:214-221).  (The reference's 3D engine has no
    PCISPH either; method 1 is the JAX package's extension.)
    """
    method = params.simulation_method
    if method == 0:
        from sph_taichi_torch.models.wcsph import WCSPHSolver
        return WCSPHSolver(params, device=device, engine=engine)
    if method == 4:
        from sph_taichi_torch.models.dfsph import DFSPHSolver
        return DFSPHSolver(params, device=device, engine=engine)
    if method == 2:
        from sph_taichi_torch.models.iisph import IISPHSolver
        return IISPHSolver(params, device=device, engine=engine)
    if method == 1:
        from sph_taichi_torch.models.pcisph import PCISPHSolver
        return PCISPHSolver(params, device=device, engine=engine)
    raise NotImplementedError(
        f"Solver type {method} has not been implemented.")

