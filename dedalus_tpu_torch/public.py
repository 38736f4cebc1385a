"""
User-facing API: `import dedalus_tpu_torch.public as d3`
(counterpart of dedalus_tpu/public.py; reference: dedalus/public.py:4-14).
"""

from .core.coords import Coordinate, CartesianCoordinates, S2Coordinates
from .core.distributor import Distributor
from .core.domain import Domain
from .core.basis import (Jacobi, ChebyshevT, Legendre, RealFourier,
                         ComplexFourier, Fourier)
from .core.sphere import SphereBasis, MulCosine
from .core.field import Field
from .core.problems import IVP, LBVP, NLBVP, EVP
from .core.operators import (
    AdvectiveCFL, Differentiate, Convert, Interpolate, Integrate, Average,
    Lift, Gradient, Divergence, Laplacian, SkewFactory as Skew, Trace,
    TimeDerivative, UnaryGridFunction, dt)
from .core.arithmetic import Add, Multiply, DotProduct, Power
from .core.timesteppers import (schemes, add_scheme, MultistepIMEX,
                                RungeKuttaIMEX, CNAB1, SBDF1, CNAB2, MCNAB2,
                                SBDF2, CNLF2, SBDF3, SBDF4, RK111, RK222,
                                RK443, RKSMR, RKGFY)
from .core.solvers import (InitialValueSolver, LinearBoundaryValueSolver,
                           NonlinearBoundaryValueSolver, EigenvalueSolver)
from .core.evaluator import Evaluator
from .extras.flow_tools import CFL, GlobalFlowProperty, GlobalArrayReducer

# lowercase operator aliases (reference: core/operators.py aliases)
dot = DotProduct
InitialValueProblem = IVP
LinearBoundaryValueProblem = LBVP
NonlinearBoundaryValueProblem = NLBVP
EigenvalueProblem = EVP
Chebyshev = ChebyshevT
grad = Gradient
div = Divergence
lap = Laplacian
trace = Trace
integ = Integrate
ave = Average
skew = Skew
lift = Lift
interp = Interpolate
convert = Convert


def VectorField(dist, *args, **kw):
    """Module-level field factory (reference: core/field.py exports);
    equivalent to the Distributor method."""
    return dist.VectorField(*args, **kw)


def ScalarField(dist, *args, **kw):
    return dist.Field(*args, **kw)
