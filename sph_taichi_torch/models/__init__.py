"""The solvers and the shared SPH machinery (models/base.py).

The names the JAX package's ``models`` exports; ``build_solver``
(sph_taichi_torch/__init__.py) also reaches PCISPH and IISPH
(models/pcisph.py, models/iisph.py).
"""

from sph_taichi_torch.models.base import SPHBase
from sph_taichi_torch.models.wcsph import WCSPHSolver
from sph_taichi_torch.models.dfsph import DFSPHSolver
