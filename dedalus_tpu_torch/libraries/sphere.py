"""
Spin-weighted spherical harmonics (SWSH) toolbox: a copy of
dedalus_tpu/libraries/sphere.py, host numpy/scipy only, with its cached
functions (reference: dedalus/libraries/dedalus_sphere/sphere.py — same
capabilities, different construction).

For azimuthal order m and spin weight s, the colatitude functions are

    Y_{l,(m,s)}(z) = phase * sqrt((1-z)^a (1+z)^b) * Phat_n^{(a,b)}(z)

with z = cos(theta), (a, b) = (|m+s|, |m-s|), n = l - l_min,
l_min = max(|m|, |s|), phase = (-1)^max(m, -s), and Phat the *orthonormal*
Jacobi polynomials from tools.jacobi. The functions are orthonormal under
plain dz on [-1, 1] (the envelope absorbs the measure); together with
e^{i m phi} / sqrt(2 pi) they are orthonormal on the unit sphere.

Design note: instead of the reference's lazy sparse operator algebra
(dedalus_sphere/operators.py), every operator matrix here is assembled by
Gauss-Jacobi quadrature of the *analytic differential operator* applied to
recurrence-evaluated basis functions. Because each result lies exactly in
the target SWSH space, quadrature of sufficient degree is exact to
roundoff, and the assembly is automatically consistent with whatever phase
conventions the basis functions use.

Spin ladder ("covariant derivative") operators, for f = g(theta) e^{i m phi}
of spin s on the unit sphere:

    D_{+1} g = (1/sqrt(2)) (d/dtheta - (m + s cos)/sin) g   -> spin s+1
    D_{-1} g = (1/sqrt(2)) (d/dtheta + (m + s cos)/sin) g   -> spin s-1

These are (-1/sqrt(2)) times the standard edth / edth-bar operators; the
gradient of a scalar has spin components (grad f)_{+-} = D_{+-} f / radius,
and the spin-weighted Laplacian is (D_{+1} D_{-1} + D_{-1} D_{+1}) / r^2
with eigenvalues -(l(l+1) - s^2)/r^2.
"""

import numpy as np

from ..tools import jacobi
from ..tools.cache import cached_function


def lmin(m, s):
    return max(abs(m), abs(s))


def spin2jacobi(Lmax, m, s):
    """(n, a, b): number of polynomials and Jacobi parameters for (m, s)
    (reference: dedalus_sphere/sphere.py:23 spin2Jacobi)."""
    n = Lmax + 1 - lmin(m, s)
    return n, abs(m + s), abs(m - s)


@cached_function
def quadrature(Lmax):
    """Gauss-Legendre nodes/weights in z = cos(theta), ascending in z.
    Exact for polynomials of degree <= 2*Lmax + 1
    (reference: dedalus_sphere/sphere.py:8 quadrature)."""
    z = jacobi.build_grid(Lmax + 1, 0, 0)
    w = jacobi.build_weights(Lmax + 1, 0, 0)
    return z, w


def _envelope(a, b, z):
    return np.sqrt((1 - z) ** a * (1 + z) ** b)


def harmonics(Lmax, m, s, z):
    """
    SWSH colatitude functions at points z: array (n, len(z)), rows l = l_min
    .. Lmax (reference: dedalus_sphere/sphere.py:43 harmonics).
    """
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    n, a, b = spin2jacobi(Lmax, m, s)
    if n <= 0:
        return np.zeros((0, z.size))
    phase = (-1.0) ** max(m, -s)
    P = jacobi.build_polynomials(n, a, b, z)
    return phase * _envelope(a, b, z) * P


def _harmonics_and_theta_derivatives(Lmax, m, s, z):
    """(Y, dY/dtheta) at z; both (n, len(z)). Interior points only."""
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    n, a, b = spin2jacobi(Lmax, m, s)
    if n <= 0:
        return np.zeros((0, z.size)), np.zeros((0, z.size))
    phase = (-1.0) ** max(m, -s)
    env = _envelope(a, b, z)
    P = jacobi.build_polynomials(n, a, b, z)
    dP = jacobi.build_polynomial_derivatives(n, a, b, z)
    sin = np.sqrt(1 - z * z)
    # dY/dtheta = -sin * dY/dz;  denv/dz = env * (-a/(2(1-z)) + b/(2(1+z)))
    denv_term = (a * (1 + z) - b * (1 - z)) / (2 * sin)  # = -sin * env'/env
    Y = phase * env * P
    dY = phase * env * (-sin * dP + denv_term * P)
    return Y, dY


def ladder_values(Lmax, m, s, ds, z):
    """
    Values of D_{ds} applied to each (m, s) harmonic, at interior points z.
    Shape (n_in, len(z)).
    """
    assert ds in (+1, -1)
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    Y, dY = _harmonics_and_theta_derivatives(Lmax, m, s, z)
    sin = np.sqrt(1 - z * z)
    connection = (m + s * z) / sin
    return (dY - ds * connection * Y) / np.sqrt(2)


def _project(Lmax, m, s_out, values_fn, n_in, extra=2):
    """
    Project function values onto the (m, s_out) SWSH space by Gauss-Jacobi
    quadrature: M[j, i] = <Y_out_j, F_i>_dz for F_i = values_fn(z)[i].
    Exact when each F_i lies in the output space.
    """
    n_out, a, b = spin2jacobi(Lmax, m, s_out)
    if n_out <= 0 or n_in <= 0:
        return np.zeros((max(n_out, 0), max(n_in, 0)))
    Nq = max(n_out, n_in) + extra
    zq = jacobi.build_grid(Nq, a, b)
    wq = jacobi.build_weights(Nq, a, b)
    env = _envelope(a, b, zq)
    # Y_out / env and F / env are polynomials; weight (1-z)^a (1+z)^b is in wq.
    Yout = harmonics(Lmax, m, s_out, zq)
    F = values_fn(zq)
    return (Yout / env * (wq / env)) @ F.T


def _selection_mask(Lmax, m, s_out, s_in, dl):
    """
    Analytic selection rule |l_out - l_in| <= dl as a boolean mask over the
    (m, s_out) x (m, s_in) coefficient spaces. Quadrature assembly leaves
    ~1e-15 dirt outside the rule that grows with Lmax and defeats band
    detection; masking restores exact sparsity.
    """
    l_out = np.arange(lmin(m, s_out), Lmax + 1)
    l_in = np.arange(lmin(m, s_in), Lmax + 1)
    return np.abs(l_out[:, None] - l_in[None, :]) <= dl


@cached_function
def ladder_matrix(Lmax, m, s, ds):
    """
    Coefficient-space matrix of D_{ds}: (m, s) -> (m, s + ds).
    Shape (n_out, n_in); diagonal in l (rectangular with offset).
    (reference: dedalus_sphere/sphere.py:120 SphereOperator.__D)
    """
    n_in = spin2jacobi(Lmax, m, s)[0]
    M = _project(Lmax, m, s + ds, lambda z: ladder_values(Lmax, m, s, ds, z), n_in)
    return M * _selection_mask(Lmax, m, s + ds, s, 0)


@cached_function
def cos_matrix(Lmax, m, s):
    """Multiplication by cos(theta) within the (m, s) space, truncated at
    Lmax: (n, n), tridiagonal in l (reference: sphere.py 'Cos' operator)."""
    n_in = spin2jacobi(Lmax, m, s)[0]
    M = _project(Lmax, m, s, lambda z: z * harmonics(Lmax, m, s, z), n_in)
    return M * _selection_mask(Lmax, m, s, s, 1)


@cached_function
def sin_matrix(Lmax, m, s_out, s_in):
    """
    Multiplication by sin(theta) mapping spin-s_in coefficients into the
    spin-s_out space (|s_out - s_in| = 1): the spin-mixing half of
    meridional (ez-type) couplings, banded with |l_out - l_in| <= 1.
    Quadrature-exact: sin(theta) = (1-z)^(1/2) (1+z)^(1/2) shifts the
    Jacobi envelope exponents by exactly the spin change, so the projected
    integrand stays polynomial (reference: the Gaunt/Clenshaw couplings of
    core/arithmetic.py:359-558 specialized to one sin(theta) factor).
    """
    if abs(s_out - s_in) != 1:
        raise ValueError("sin_matrix requires |s_out - s_in| = 1.")
    n_in = spin2jacobi(Lmax, m, s_in)[0]
    M = _project(Lmax, m, s_out,
                 lambda z: np.sqrt(1 - z * z) * harmonics(Lmax, m, s_in, z),
                 n_in)
    return M * _selection_mask(Lmax, m, s_out, s_in, 1)


@cached_function
def forward_matrix(Lmax, m, s, Ng=None):
    """
    Forward colatitude transform: values on the Ng-point Gauss-Legendre grid
    -> SWSH coefficients l = l_min..Lmax. Shape (n, Ng).
    """
    if Ng is None:
        Ng = Lmax + 1
    z, w = quadrature(Ng - 1)
    return harmonics(Lmax, m, s, z) * w


@cached_function
def backward_matrix(Lmax, m, s, Ng=None):
    """Backward colatitude transform: coefficients -> Ng grid values. (Ng, n)."""
    if Ng is None:
        Ng = Lmax + 1
    z, _ = quadrature(Ng - 1)
    return harmonics(Lmax, m, s, z).T


def interpolation_row(Lmax, m, s, theta0):
    """Row (1, n): evaluate each harmonic at colatitude theta0."""
    return harmonics(Lmax, m, s, np.array([np.cos(theta0)]))[:, 0][None, :]


def ell_range(Lmax, m, s):
    """The l values carried by the (m, s) coefficient vector."""
    return np.arange(lmin(m, s), Lmax + 1)
