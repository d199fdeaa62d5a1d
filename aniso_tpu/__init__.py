"""aniso_tpu: anisotropic radiative-transfer integral-equation solver in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
C++/MEX solver (lowrank/aniso): Fourier-mode decomposition of the 2D RTE
with Henyey-Greenstein scattering, singular-quadrature-corrected integral
operator, fast hierarchical matvec, and device-resident GMRES -- designed
for SPMD execution over a mesh of GPUs rather than OpenMP threads.
"""

__version__ = "0.1.0"

from .core.config import SolverConfig, load_cfg
from .core.geometry import Grid, make_grid
