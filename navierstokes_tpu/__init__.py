"""navierstokes_tpu — a JAX-native incompressible Navier-Stokes FEM framework.

A from-scratch JAX/XLA re-design of the capabilities of
``LKM-code-base/NavierStokes-with-Fenics``.  The reference delegates all
heavy lifting to the FEniCS C++/PETSc stack; here the discretization lives
as static device arrays (mesh, dofmaps, sparsity, tabulated shape
functions) and everything executed per Newton iteration / per time step
(element-kernel assembly, SpMV, Krylov solves) is jit-compiled JAX.

Layer map (mirrors SURVEY.md §1 of the reference):

    L1  ``mesh``         -- structured + unstructured simplex meshes, markers
    L2  ``fem``          -- P1/P2 elements, Taylor-Hood dofmaps, BCs
        ``assembly``     -- batched element kernels, sparse scatter
        ``linalg``       -- device Krylov (CG/GMRES), Newton driver
        ``timestepping`` -- DiscreteTime / BDF / theta / IMEX schemes
        ``solvers``      -- stationary Picard->Newton, monolithic BDF, IPCS
    L3  ``problems``     -- app-facing Problem classes, coefficient handler
        ``io``           -- XDMF/VTU output, checkpointing
    LP  ``parallel``     -- device-mesh sharding + collectives (replaces MPI)
"""

from navierstokes_tpu import config as config  # noqa: F401
from navierstokes_tpu.fem.bcs import (  # noqa: F401
    PressureBCType,
    TractionBCType,
    VelocityBCType,
)
from navierstokes_tpu.problems.coefficients import (  # noqa: F401
    EquationCoefficientHandler,
)

__version__ = "0.1.0"
