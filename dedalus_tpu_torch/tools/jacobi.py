"""
Orthonormal Jacobi polynomial toolbox (reference: dedalus/tools/jacobi.py and
dedalus/libraries/dedalus_sphere/jacobi.py — same capabilities, different
construction).

Design: instead of the reference's lazy sparse operator algebra, every
operator matrix (conversion, differentiation, multiplication-by-NCC,
interpolation, integration) is built **by Gauss-Jacobi quadrature** against
orthonormal polynomials evaluated with the stable three-term recurrence.
Quadrature of sufficient degree makes these matrices exact to roundoff, and
known analytic band structures are enforced by masking. All of this runs on
host (numpy, float64) once at setup; results ship to device as constants.

Conventions:
  * Native interval x in [-1, 1], weight (1-x)^a (1+x)^b, a,b > -1.
  * Polynomials are orthonormal: integral(w p_m p_n) = delta_{mn}.
  * ChebyshevT = Jacobi(a=b=-1/2), Legendre = Jacobi(a=b=0),
    Ultraspherical C^(k) used for k-th derivative bases (a+k, b+k).
"""

import numpy as np
from scipy import special

from .cache import cached_function


def mass(a, b):
    """Total measure: integral of (1-x)^a (1+x)^b over [-1, 1]."""
    return np.exp((a + b + 1) * np.log(2.0)
                  + special.gammaln(a + 1) + special.gammaln(b + 1)
                  - special.gammaln(a + b + 2))


@cached_function
def recurrence(N, a, b):
    """
    Three-term recurrence coefficients for orthonormal Jacobi polynomials:
        x p_n = beta[n] p_{n+1} + alpha[n] p_n + beta[n-1] p_{n-1}
    Returns (alpha[0..N-1], beta[0..N-1]).
    """
    n = np.arange(N, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = (b**2 - a**2) / ((2*n + a + b) * (2*n + a + b + 2))
        beta = (2.0 / (2*n + a + b + 2)) * np.sqrt(
            (n + 1) * (n + a + 1) * (n + b + 1) * (n + a + b + 1)
            / ((2*n + a + b + 1) * (2*n + a + b + 3)))
    # n = 0 entries hit degenerate denominators when a+b in {0, -1}; use limits.
    alpha[0] = (b - a) / (a + b + 2)
    beta[0] = (2.0 / (a + b + 2)) * np.sqrt((a + 1) * (b + 1) / (a + b + 3))
    return alpha, beta


def build_polynomials(N, a, b, grid):
    """
    Evaluate orthonormal Jacobi polynomials p_0..p_{N-1} at `grid`.
    Returns array of shape (N, len(grid)).
    """
    grid = np.asarray(grid, dtype=np.float64)
    alpha, beta = recurrence(max(N, 2), a, b)
    P = np.zeros((N, grid.size))
    if N == 0:
        return P
    P[0] = 1.0 / np.sqrt(mass(a, b))
    if N > 1:
        P[1] = (grid - alpha[0]) * P[0] / beta[0]
    for n in range(1, N - 1):
        P[n + 1] = ((grid - alpha[n]) * P[n] - beta[n - 1] * P[n - 1]) / beta[n]
    return P


def build_polynomial_derivatives(N, a, b, grid):
    """
    Evaluate d p_n / dx at `grid` by differentiating the recurrence.
    Returns array of shape (N, len(grid)).
    """
    grid = np.asarray(grid, dtype=np.float64)
    alpha, beta = recurrence(max(N, 2), a, b)
    P = build_polynomials(N, a, b, grid)
    D = np.zeros((N, grid.size))
    if N > 1:
        D[1] = P[0] / beta[0]
    for n in range(1, N - 1):
        D[n + 1] = ((grid - alpha[n]) * D[n] + P[n] - beta[n - 1] * D[n - 1]) / beta[n]
    return D


@cached_function
def build_grid(N, a, b):
    """Gauss-Jacobi quadrature nodes for weight (1-x)^a (1+x)^b (ascending)."""
    if N == 1:
        # Single-node Gauss rule: node at the weight's mean.
        alpha, _ = recurrence(2, a, b)
        return np.array([alpha[0]])
    x, _ = special.roots_jacobi(N, a, b)
    return x


@cached_function
def build_weights(N, a, b):
    """Gauss-Jacobi quadrature weights matching `build_grid`."""
    if N == 1:
        return np.array([mass(a, b)])
    _, w = special.roots_jacobi(N, a, b)
    return w


@cached_function
def forward_matrix(N, a, b, Ng=None):
    """
    Forward transform matrix: grid values on the Ng-point (a,b) Gauss grid
    -> first N orthonormal coefficients. Exact for polynomials of degree
    < 2*Ng - N. Shape (N, Ng).
    """
    if Ng is None:
        Ng = N
    x = build_grid(Ng, a, b)
    w = build_weights(Ng, a, b)
    P = build_polynomials(N, a, b, x)
    return P * w  # row n: p_n(x_i) w_i


def _quadrature_inner(Nrows, arow, brow, colvals_fn, Nq, aq, bq):
    """
    Generic quadrature assembly: M[m, n] = <q_m^(arow,brow), f_n>_(aq,bq)
    where f_n values come from `colvals_fn(x)` (shape (Ncols, Nq)).
    """
    x = build_grid(Nq, aq, bq)
    w = build_weights(Nq, aq, bq)
    Q = build_polynomials(Nrows, arow, brow, x)
    F = colvals_fn(x)
    return (Q * w) @ F.T


@cached_function
def conversion_matrix(N, a, b, da=0, db=0):
    """
    Connection matrix from (a, b) to (a+da, b+db), shape (N, N), upper
    triangular with bandwidth da+db (banded structure enforced).
    (reference: dedalus/tools/jacobi.py:229 conversion_matrix)
    """
    da, db = int(da), int(db)
    if da < 0 or db < 0:
        raise ValueError("Conversion only defined for nonnegative increments.")
    a2, b2 = a + da, b + db
    M = _quadrature_inner(N, a2, b2, lambda x: build_polynomials(N, a, b, x), N, a2, b2)
    # Exact structure: upper triangular, bandwidth da+db.
    mask = np.zeros((N, N), dtype=bool)
    for d in range(0, da + db + 1):
        mask |= np.eye(N, N, k=d, dtype=bool)
    return M * mask


@cached_function
def differentiation_matrix(N, a, b):
    """
    d/dx : coeffs in (a,b) -> coeffs in (a+1,b+1). Single superdiagonal.
    (reference: dedalus/tools/jacobi.py:247)
    """
    M = _quadrature_inner(N, a + 1, b + 1,
                          lambda x: build_polynomial_derivatives(N, a, b, x),
                          N, a + 1, b + 1)
    mask = np.eye(N, N, k=1, dtype=bool)
    return M * mask


def multiplication_matrix(N_out, a_out, b_out, N_in, a_in, b_in, f_coeffs, a_f, b_f):
    """
    NCC multiplication matrix: maps coeffs of u in (a_in, b_in) to coeffs of
    (f u) in (a_out, b_out), where f has coefficients `f_coeffs` in
    (a_f, b_f). Built by quadrature of sufficient degree — replaces the
    reference's Clenshaw assembly (dedalus/tools/clenshaw.py:24).
    """
    f_coeffs = np.asarray(f_coeffs)
    Nf = f_coeffs.shape[-1]
    # integrand degree <= (N_out-1) + (N_in-1) + (Nf-1); Gauss with Nq nodes
    # is exact to degree 2*Nq - 1.
    Nq = (N_out + N_in + Nf) // 2 + 2

    def colvals(x):
        fvals = f_coeffs @ build_polynomials(Nf, a_f, b_f, x)
        return build_polynomials(N_in, a_in, b_in, x) * fvals

    return _quadrature_inner(N_out, a_out, b_out, colvals, Nq, a_out, b_out)


@cached_function
def integration_vector(N, a, b):
    """
    Row vector of integrals: I[n] = integral of p_n(x) dx over [-1, 1].
    Computed with Gauss-Legendre (exact: p_n are polynomials).
    (reference: dedalus/tools/jacobi.py:253)
    """
    NL = N // 2 + 1
    xl, wl = special.roots_legendre(NL)
    P = build_polynomials(N, a, b, xl)
    return P @ wl


def interpolation_vector(N, a, b, x0):
    """Row vector: p_n(x0), for boundary/point interpolation."""
    return build_polynomials(N, a, b, np.array([float(x0)]))[:, 0]
