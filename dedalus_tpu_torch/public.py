"""
User-facing API: `import dedalus_tpu_torch.public as d3`
(counterpart of dedalus_tpu/public.py; reference: dedalus/public.py:4-14).
"""

from .core.coords import Coordinate, CartesianCoordinates
from .core.distributor import Distributor
from .core.domain import Domain
from .core.basis import Jacobi, ChebyshevT, RealFourier
from .core.field import Field
from .core.problems import IVP
from .core.operators import (
    Differentiate, Convert, Interpolate, Integrate, Lift, Gradient,
    Divergence, Laplacian, Trace, TimeDerivative, dt)
from .core.arithmetic import Add, Multiply, DotProduct
from .core.timesteppers import (schemes, add_scheme, RungeKuttaIMEX, RK111,
                                RK222, RK443, RKSMR, RKGFY)
from .core.solvers import InitialValueSolver

# lowercase operator aliases (reference: core/operators.py aliases)
dot = DotProduct
InitialValueProblem = IVP
Chebyshev = ChebyshevT
grad = Gradient
div = Divergence
lap = Laplacian
trace = Trace
integ = Integrate
lift = Lift
interp = Interpolate
convert = Convert


def VectorField(dist, *args, **kw):
    """Module-level field factory (reference: core/field.py exports);
    equivalent to the Distributor method."""
    return dist.VectorField(*args, **kw)


def ScalarField(dist, *args, **kw):
    return dist.Field(*args, **kw)
