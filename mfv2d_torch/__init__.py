"""mfv2d_torch: the 2D mimetic spectral element framework in PyTorch.

The port of ``mfv2d_tpu`` to PyTorch and CUDA.  The k-form DSL, compiler,
mesh and constraints are host NumPy/SciPy; element assembly and residuals
run as batched float64 tensor work on the CUDA device, or on the CPU where
the caller passes ``device="cpu"``, with the 1-form mass matrix and the
element inverses computed by hand-written CUDA kernels on the GPU.  Steady
Picard and Newton solves, the trapezoidal time marches, hp refinement and
VMS fine-scale estimation (``VMSSettings``, ``ErrorEstimateVMS``) are
ported, with checkpoints (``CheckpointSettings``), and each of them runs
element-sharded over ``torch.distributed`` with ``SolverSettings.device_mesh``
(``mfv2d_torch.parallel.sharding`` and ``mfv2d_torch.parallel.vms``, which,
as the JAX package's ``parallel`` modules, are not re-exported here).
"""

from mfv2d_torch import examples as examples

# Mesh
from mfv2d_torch.mesh.manifold import GeoID as GeoID
from mfv2d_torch.mesh.manifold import Line as Line
from mfv2d_torch.mesh.manifold import Manifold2D as Manifold2D
from mfv2d_torch.mesh.manifold import Surface as Surface
from mfv2d_torch.mesh.quadtree import Mesh as Mesh
from mfv2d_torch.mimetic import mesh_create as mesh_create
from mfv2d_torch.mimetic import integrate_over_elements as integrate_over_elements

# K-forms
from mfv2d_torch.kform import KEquation as KEquation
from mfv2d_torch.kform import KFormUnknown as KFormUnknown
from mfv2d_torch.kform import KWeight as KWeight
from mfv2d_torch.kform import TimeDependent as TimeDependent
from mfv2d_torch.kform import UnknownFormOrder as UnknownFormOrder

# System / compiler
from mfv2d_torch.system import ElementFormSpecification as ElementFormSpecification
from mfv2d_torch.system import KFormSystem as KFormSystem
from mfv2d_torch.compiler import CompiledSystem as CompiledSystem
from mfv2d_torch.compiler import system_as_string as system_as_string

# Boundary conditions
from mfv2d_torch.boundary import BoundaryCondition2DSteady as BoundaryCondition2DSteady
from mfv2d_torch.boundary import (
    BoundaryCondition2DUnsteady as BoundaryCondition2DUnsteady,
)

# Refinement
from mfv2d_torch.refinement import ErrorEstimateCustom as ErrorEstimateCustom
from mfv2d_torch.refinement import ErrorEstimateExplicit as ErrorEstimateExplicit
from mfv2d_torch.refinement import ErrorEstimateFineSolve as ErrorEstimateFineSolve
from mfv2d_torch.refinement import (
    ErrorEstimateL2OrderReduction as ErrorEstimateL2OrderReduction,
)
from mfv2d_torch.refinement import (
    ErrorEstimateLocalInverse as ErrorEstimateLocalInverse,
)
from mfv2d_torch.refinement import ErrorEstimateVMS as ErrorEstimateVMS
from mfv2d_torch.refinement import (
    RefinementLimitElementCount as RefinementLimitElementCount,
)
from mfv2d_torch.refinement import (
    RefinementLimitErrorValue as RefinementLimitErrorValue,
)
from mfv2d_torch.refinement import (
    RefinementLimitUnknownCount as RefinementLimitUnknownCount,
)
from mfv2d_torch.refinement import RefinementSettings as RefinementSettings
from mfv2d_torch.refinement import (
    compute_legendre_coefficients as compute_legendre_coefficients,
)
from mfv2d_torch.refinement import (
    compute_legendre_error_estimates as compute_legendre_error_estimates,
)

# Solver
from mfv2d_torch.solver.solve import ConvergenceSettings as ConvergenceSettings
from mfv2d_torch.solver.solve import SolutionStatistics as SolutionStatistics
from mfv2d_torch.solver.solve import SolverSettings as SolverSettings
from mfv2d_torch.solver.solve import SystemSettings as SystemSettings
from mfv2d_torch.solver.solve import TimeSettings as TimeSettings
from mfv2d_torch.solver.solve import VMSSettings as VMSSettings
from mfv2d_torch.solve_system_2d import solve_system_2d as solve_system_2d

# Checkpointing
from mfv2d_torch.checkpoint import CheckpointSettings as CheckpointSettings
from mfv2d_torch.checkpoint import load_mesh as load_mesh
from mfv2d_torch.checkpoint import save_mesh as save_mesh
