"""
User-facing API: `import dedalus_tpu_torch.public as d3`
(counterpart of dedalus_tpu/public.py; reference: dedalus/public.py:4-14).
"""

from .core.coords import (Coordinate, CartesianCoordinates, DirectProduct,
                          PolarCoordinates, S2Coordinates,
                          SphericalCoordinates)
from .core.distributor import Distributor
from .core.domain import Domain
from .core.basis import (Jacobi, ChebyshevT, Legendre, RealFourier,
                         ComplexFourier, Fourier)
from .core.polar import DiskBasis, AnnulusBasis
from .core.sphere import SphereBasis, MulCosine
from .core.spherical3d import ShellBasis, BallBasis
from .core.field import Field
from .core.problems import IVP, LBVP, NLBVP, EVP
from .core.operators import (
    AdvectiveCFL, Differentiate, Convert, Interpolate, Integrate, Average,
    AzimuthalAverageFactory as AzimuthalAverage, LiftFactory as Lift,
    Gradient, Divergence, Laplacian, Curl, SkewFactory as Skew, Radial,
    Azimuthal, Angular, Trace, TransposeComponents, SphericalEllProduct,
    TimeDerivative, UnaryGridFunction, dt)
from .core.arithmetic import Add, Multiply, DotProduct, CrossProduct, Power
from .core.timesteppers import (schemes, add_scheme, MultistepIMEX,
                                RungeKuttaIMEX, CNAB1, SBDF1, CNAB2, MCNAB2,
                                SBDF2, CNLF2, SBDF3, SBDF4, RK111, RK222,
                                RK443, RKSMR, RKGFY)
from .core.solvers import (InitialValueSolver, LinearBoundaryValueSolver,
                           NonlinearBoundaryValueSolver, EigenvalueSolver)
from .core.evaluator import Evaluator
from .core.ensemble import EnsembleSolver
from .extras.flow_tools import CFL, GlobalFlowProperty, GlobalArrayReducer
from .tools.exceptions import (CheckpointError, SilentCorruptionError,
                               SolverHealthError)
from .tools.health import HealthMonitor

# lowercase operator aliases (reference: core/operators.py aliases)
dot = DotProduct
cross = CrossProduct
InitialValueProblem = IVP
LinearBoundaryValueProblem = LBVP
NonlinearBoundaryValueProblem = NLBVP
EigenvalueProblem = EVP
Chebyshev = ChebyshevT
grad = Gradient
div = Divergence
lap = Laplacian
curl = Curl
trace = Trace
transpose = trans = TransposeComponents
integ = Integrate
ave = Average
skew = Skew
lift = Lift
radial = Radial
azimuthal = Azimuthal
angular = Angular
Component = RadialComponent = Radial
AzimuthalComponent = Azimuthal
interp = Interpolate
convert = Convert


def VectorField(dist, *args, **kw):
    """Module-level field factory (reference: core/field.py exports);
    equivalent to the Distributor method."""
    return dist.VectorField(*args, **kw)


def TensorField(dist, *args, **kw):
    return dist.TensorField(*args, **kw)


def ScalarField(dist, *args, **kw):
    return dist.Field(*args, **kw)
