"""
Zernike / generalized-Gegenbauer radial polynomials for the disk (dim=2) and
ball (dim=3): the port's copy of dedalus_tpu/libraries/zernike.py, host
numpy/scipy only, with its cached functions (reference:
dedalus/libraries/dedalus_sphere/zernike.py — same capabilities, different
construction).

Radial coordinate r on [0, 1] (the basis applies an affine radius scaling),
spectral variable z = 2 r^2 - 1. For weight parameter k and generalized
degree l, the radial functions are

    Q_n^{(k,l)}(r) = c * r^l * Phat_n^{(k, b)}(z),    b = l + dim/2 - 1,
    c = 2^{(k + b)/2 + 1},

with Phat the orthonormal Jacobi polynomials of tools.jacobi. They are
orthonormal under the dim-D radial measure

    integral_0^1 Q_n Q_n' (1 - r^2)^k r^{dim-1} dr = delta_{nn'}.

As in libraries.sphere, every operator matrix is assembled by Gauss-Jacobi
quadrature of the analytic operator applied to recurrence-evaluated basis
functions — exact to roundoff, convention-proof.

Radial ladder operators with connection exponent mu (for the disk,
mu = m + s; for the ball, the regularity machinery supplies mu):

    D_{+-} g = (1/sqrt(2)) (d/dr -+ mu/r) g

which map degree l -> l +- 1 (whichever of |mu +- 1| applies) and raise the
weight k -> k+1 (reference: dedalus_sphere/zernike.py ZernikeOperator.__D).
"""

import numpy as np

from ..tools import jacobi
from ..tools.cache import cached_function


def _b(dim, l):
    return l + dim / 2 - 1


def _norm_constant(dim, k, l):
    return 2.0 ** ((k + _b(dim, l)) / 2 + 1)


def _measure_logfactor(dim, k, l):
    """log2 of the z-measure prefactor: dmu = (1-z)^k (1+z)^{dim/2-1} dz / 2^f
    with the envelope (1+z)^l split off."""
    return l + k + dim / 2 + 1


@cached_function
def quadrature(dim, N, k=0):
    """
    Nodes z and weights w with sum(w f(z)) = integral_0^1 f(z(r))
    (1-r^2)^k r^{dim-1} dr, exact for polynomial f of degree < 2N
    (reference: dedalus_sphere/zernike.py:11 quadrature).
    """
    b = dim / 2 - 1
    z = jacobi.build_grid(N, k, b)
    w = jacobi.build_weights(N, k, b) / 2 ** (k + dim / 2 + 1)
    return z, w


def grid(dim, N, k=0):
    """Radial grid points r in (0, 1), ascending."""
    z, _ = quadrature(dim, N, k)
    return np.sqrt((1 + z) / 2)


def polynomials(dim, n, k, l, z):
    """
    Evaluate Q_0..Q_{n-1}^{(k,l)} at points z. Shape (n, len(z))
    (reference: dedalus_sphere/zernike.py:27 polynomials).
    """
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    if n <= 0:
        return np.zeros((0, z.size))
    env = ((1 + z) / 2) ** (l / 2)
    P = jacobi.build_polynomials(n, k, _b(dim, l), z)
    return _norm_constant(dim, k, l) * env * P


def polynomials_and_r_derivatives(dim, n, k, l, z):
    """(Q, dQ/dr) at z; both (n, len(z)). Interior points only (r > 0)."""
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    if n <= 0:
        return np.zeros((0, z.size)), np.zeros((0, z.size))
    r = np.sqrt((1 + z) / 2)
    b = _b(dim, l)
    env = ((1 + z) / 2) ** (l / 2)
    P = jacobi.build_polynomials(n, k, b, z)
    dP = jacobi.build_polynomial_derivatives(n, k, b, z)
    c = _norm_constant(dim, k, l)
    Q = c * env * P
    # dz/dr = 4r; d(env)/dr = (l/r) env
    dQ = (l / r) * Q + c * env * dP * 4 * r
    return Q, dQ


def _project(dim, n_out, k_out, l_out, values_fn, n_in, extra=2):
    """
    M[j, i] = <Q_out_j, F_i>_{mu_{k_out}} by Gauss-Jacobi quadrature, where
    F_i = values_fn(z)[i] must equal r^{l_out} * polynomial.
    """
    if n_out <= 0 or n_in <= 0:
        return np.zeros((max(n_out, 0), max(n_in, 0)))
    b = _b(dim, l_out)
    Nq = max(n_out, n_in) + extra
    zq = jacobi.build_grid(Nq, k_out, b)
    wq = jacobi.build_weights(Nq, k_out, b)
    env = ((1 + zq) / 2) ** (l_out / 2)
    Pout = jacobi.build_polynomials(n_out, k_out, b, zq)
    F = values_fn(zq)
    factor = _norm_constant(dim, k_out, l_out) / 2 ** _measure_logfactor(dim, k_out, l_out)
    return factor * (Pout * wq) @ (F / env).T


@cached_function
def conversion_matrix(dim, n, k, l, dk=1):
    """Connection matrix (k, l) -> (k + dk, l), shape (n, n)
    (reference: ZernikeOperator.__E)."""
    return _project(dim, n, k + dk, l, lambda z: polynomials(dim, n, k, l, z), n)


@cached_function
def ladder_matrix(dim, n, k, l_in, l_out, mu, ds):
    """
    Matrix of D_{ds} = (1/sqrt(2)) (d/dr - ds*mu/r): (k, l_in) -> (k+1, l_out),
    shape (n, n). l_out must be l_in +- 1 consistent with |mu + ds|.
    """
    assert ds in (+1, -1)
    assert l_out in (l_in + 1, l_in - 1)

    def values(z):
        Q, dQ = polynomials_and_r_derivatives(dim, n, k, l_in, z)
        r = np.sqrt((1 + z) / 2)
        return (dQ - ds * mu / r * Q) / np.sqrt(2)

    return _project(dim, n, k + 1, l_out, values, n)


@cached_function
def r2_multiplication_matrix(dim, n, k, l):
    """Multiplication by r^2 within (k, l): (n, n), tridiagonal in n."""
    def values(z):
        return (1 + z) / 2 * polynomials(dim, n, k, l, z)
    return _project(dim, n, k, l, values, n)


@cached_function
def interpolation_row(dim, n, k, l, r0=1.0):
    """Row (1, n): evaluate Q_n^{(k,l)} at radius r0 (e.g. the boundary)."""
    z0 = 2 * r0 ** 2 - 1
    return polynomials(dim, n, k, l, np.array([z0]))[:, 0][None, :]


@cached_function
def integration_row(dim, n, k, l):
    """Row (1, n): integral of each Q against the unweighted dim-D measure
    r^{dim-1} dr (for Integrate/Average). The r^l envelope is absorbed into
    the quadrature weight so half-integer powers (odd l) stay exact."""
    b_env = dim / 2 - 1 + l / 2
    Nq = n + 2
    z = jacobi.build_grid(Nq, 0, b_env)
    w = jacobi.build_weights(Nq, 0, b_env)
    P = jacobi.build_polynomials(n, k, _b(dim, l), z)
    factor = _norm_constant(dim, k, l) / 2 ** (l / 2 + dim / 2 + 1)
    return factor * (P @ w)[None, :]
