"""
Regularity <-> spin intertwiners for spherical (3D) tensors: the port's
copy of dedalus_tpu/libraries/spin_intertwiners.py, host numpy only
(reference: dedalus/libraries/dedalus_sphere/spin_operators.py:276
Intertwiner).

A rank-r tensor field on the ball/shell decomposes, for each spherical
harmonic degree ell, into *regularity components* indexed by tuples
a in {-1, 0, +1}^r: the combinations whose radial dependence is
r^(ell + sum(a)) * (analytic in r^2), which is what the Zernike radial
bases expand. The orthogonal matrix Q(ell) maps regularity components to
*spin components* (the frame in which the colatitude SWSH transforms act).

The coupling coefficients obey a first-index recursion (a Clebsch-Gordan
ladder): with sigma = spin[0], a = reg[0], tau = spin[1:], b = reg[1:],
J = ell + sum(b),

    R = sum_i [ (tau_i == -sigma) * -Q[tau|_i->0, b]
              + (tau_i ==  0    ) * +Q[tau|_i->sigma, b] ]
        - k(sigma, sum(tau)) * Q[tau, b],
    k(mu, s) = -mu sqrt((ell - s mu)(ell + s mu + 1)/2),

    Q[spin, reg] = (Q[tau,b]*J - R)/sqrt(J(2J+1))          if a == -1
                 = sigma*R/sqrt(J(J+1))                    if a ==  0
                 = (Q[tau,b]*(J+1) + R)/sqrt((J+1)(2J+1))  if a == +1

(with Q[tau,b] zeroed for sigma != 0 in the a = +-1 branches), seeded by
Q[(), ()] = 1 and zero for forbidden spins (|sum(spin)| > ell) and forbidden
regularities (the degree walk ell + partial sums dropping below zero or
stalling at (0,0)).
"""

import numpy as np
from itertools import product

from ..tools.cache import cached_function

SPIN_ORDERING = (-1, +1, 0)  # matches SphericalCoordinates component ordering


def _forbidden_spin(ell, spin):
    return ell < abs(sum(spin))


def _forbidden_regularity(ell, regularity):
    if ell >= len(regularity):
        return False
    walk = (ell,)
    for r in regularity[::-1]:
        walk += (walk[-1] + r,)
        if walk[-1] < 0 or walk[-2:] == (0, 0):
            return True
    return False


def _coefficient(ell, spin, regularity, memo):
    key = (spin, regularity)
    if key in memo:
        return memo[key]
    if len(spin) == 0:
        return 1.0
    if _forbidden_spin(ell, spin) or _forbidden_regularity(ell, regularity):
        memo[key] = 0.0
        return 0.0
    sigma, a = spin[0], regularity[0]
    tau, b = spin[1:], regularity[1:]

    def sub(t):
        return _coefficient(ell, t, b, memo)

    R = 0.0
    for i, t in enumerate(tau):
        if t + sigma == 0:
            R -= sub(tau[:i] + (0,) + tau[i + 1:])
        if t == 0:
            R += sub(tau[:i] + (sigma,) + tau[i + 1:])
    Q = sub(tau)
    s_tau = sum(tau)
    k = -sigma * np.sqrt(max((ell - s_tau * sigma) * (ell + s_tau * sigma + 1), 0) / 2)
    R -= k * Q
    J = ell + sum(b)
    if sigma != 0:
        Q = 0.0
    if a == -1:
        val = (Q * J - R) / np.sqrt(J * (2 * J + 1))
    elif a == 0:
        val = sigma * R / np.sqrt(J * (J + 1))
    else:
        val = (Q * (J + 1) + R) / np.sqrt((J + 1) * (2 * J + 1))
    if abs(val) < 1e-12:
        val = 0.0
    memo[key] = val
    return val


@cached_function
def regularity_to_spin(ell, rank, ordering=SPIN_ORDERING):
    """
    Q(ell): (3^rank, 3^rank) orthogonal matrix, spin rows x regularity
    columns, both flattened in `ordering` per index
    (reference: core/coords.py:359 SphericalCoordinates._Q_backward).
    """
    if rank == 0:
        return np.array([[1.0]])
    memo = {}
    tuples = list(product(ordering, repeat=rank))
    Q = np.zeros((3 ** rank, 3 ** rank))
    for i, spin in enumerate(tuples):
        for j, reg in enumerate(tuples):
            Q[i, j] = _coefficient(ell, spin, reg, memo)
    return Q


def spin_to_regularity(ell, rank, ordering=SPIN_ORDERING):
    """Inverse (transpose) intertwiner
    (reference: core/coords.py:356 _Q_forward)."""
    return regularity_to_spin(ell, rank, ordering).T


def valid_regularities(ell, rank, ordering=SPIN_ORDERING):
    """Boolean flat mask of allowed regularity tuples at this ell."""
    tuples = list(product(ordering, repeat=rank))
    return np.array([not _forbidden_regularity(ell, reg) for reg in tuples])


def regularity_degree_shifts(rank, ordering=SPIN_ORDERING):
    """sum(a) for each flattened regularity tuple: the shift of the radial
    degree l = ell + sum(a) used by the Zernike expansion."""
    tuples = list(product(ordering, repeat=rank))
    return np.array([sum(reg) for reg in tuples])
