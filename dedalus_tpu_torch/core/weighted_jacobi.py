"""
Weighted-Jacobi radial machinery of the annulus (counterpart of
dedalus_tpu/core/weighted_jacobi.py, which the shell shares; reference:
dedalus/libraries/dedalus_sphere/shell.py operator algebra,
dedalus/core/basis.py:2011 AnnulusBasis / :3682 ShellRadialBasis).

Level-k fields on [Ri, Ro] carry a hidden (dR/r)^k grid prefactor: the grid
values are f(r) = (dR/r)^k g(z) with g polynomial in the native coordinate
z in [-1, 1], r = (dR/2)(z + rho). In these spaces the ladder operators
D = d/dr + c/r map level k to level k+1 with polynomial-exact matrices:

    D f = (dR/r)^(k+1) (1/dR) [ (z+rho) g'(z) + (c - k) g(z) ]

so every radial operator decomposes as (A + c*B)/dR with the two
m/ell-independent quadrature projections A = proj[(z+rho) g' - k g] and
B = proj[g]. All matrices are assembled host-side by Gauss quadrature
(exact for the polynomial integrands) and uploaded to the device once
(tools/array.device_constant).

Host classes provide: Nr, alpha (tuple), k, rho, dR, radial_COV, clone_with.
"""

import numpy as np

from ..tools.cache import CachedMethod
from ..tools import jacobi as jacobi_tools
from ..tools.array import apply_matrix_torch


class WeightedJacobiRadial:
    """Mixin: transforms and operator parts on the weighted radial interval."""

    @property
    def a_k(self):
        return self.alpha[0] + self.k

    @property
    def b_k(self):
        return self.alpha[1] + self.k

    def _z_grid(self, scale=1.0, sub_axis=None):
        Ng = self.sub_grid_size(self.radial_sub_axis, scale)
        return jacobi_tools.build_grid(Ng, self.alpha[0], self.alpha[1])

    def radial_grid(self, scale=1.0):
        return self.radial_COV.problem_coord(self._z_grid(scale))

    # ----------------------------------------------------------- transforms

    @CachedMethod
    def _radial_forward_matrix(self, scale=1.0):
        """(Nr, Ngr): grid values -> level-k coefficients. Projects onto the
        base (alpha) polynomials then applies the banded base->k conversion,
        with the (r/dR)^k weight folded into the quadrature columns."""
        Ngr = self.sub_grid_size(self.radial_sub_axis, scale)
        a0, b0 = self.alpha
        F = jacobi_tools.forward_matrix(self.Nr, a0, b0, Ngr)
        if self.k:
            r = self.radial_grid(scale)
            F = F * (r / self.dR) ** self.k
            C = jacobi_tools.conversion_matrix(self.Nr, a0, b0, self.k, self.k)
            F = C @ F
        return F

    @CachedMethod
    def _radial_backward_matrix(self, scale=1.0):
        """(Ngr, Nr): level-k coefficients -> grid values."""
        z = self._z_grid(scale)
        P = jacobi_tools.build_polynomials(self.Nr, self.a_k, self.b_k, z)
        B = P.T
        if self.k:
            r = self.radial_grid(scale)
            B = B * ((self.dR / r) ** self.k)[:, None]
        return B

    def _radial_matmul(self, data, r_axis, scale, forward):
        # the HOST matrix: CachedMethod keeps its identity, so
        # device_constant uploads it once
        M = self._radial_forward_matrix(scale) if forward \
            else self._radial_backward_matrix(scale)
        return apply_matrix_torch(M, data, r_axis)

    # ------------------------------------------------------- operator parts

    @CachedMethod
    def _ladder_parts(self):
        """(A, B): the m/ell-independent pieces of every radial ladder at
        this level, as maps into the level-(k+1) polynomials."""
        N = self.Nr
        a, b = self.a_k, self.b_k
        Nq = N + 8
        z = jacobi_tools.build_grid(Nq, a + 1, b + 1)
        w = jacobi_tools.build_weights(Nq, a + 1, b + 1)
        P = jacobi_tools.build_polynomials(N, a, b, z)
        dP = jacobi_tools.build_polynomial_derivatives(N, a, b, z)
        Pout = jacobi_tools.build_polynomials(N, a + 1, b + 1, z)
        W = Pout * w
        A = W @ ((z + self.rho) * dP - self.k * P).T
        B = W @ P.T
        return A, B

    def radial_ladder(self, c):
        """(Nr, Nr): D = d/dr + c/r, level k -> k+1, problem units."""
        A, B = self._ladder_parts()
        return (A + c * B) / self.dR

    @CachedMethod
    def _conversion_matrix_single(self):
        """(Nr, Nr): level k -> k+1 identity-conversion E (exact)."""
        N = self.Nr
        a, b = self.a_k, self.b_k
        Nq = N + 8
        z = jacobi_tools.build_grid(Nq, a + 1, b + 1)
        w = jacobi_tools.build_weights(Nq, a + 1, b + 1)
        P = jacobi_tools.build_polynomials(N, a, b, z)
        Pout = jacobi_tools.build_polynomials(N, a + 1, b + 1, z)
        return (Pout * w) @ (((z + self.rho) / 2) * P).T

    def _conversion_matrix_total(self, dk):
        """(Nr, Nr): level k -> k+dk."""
        M = np.eye(self.Nr)
        basis = self
        for _ in range(int(dk)):
            M = basis._conversion_matrix_single() @ M
            basis = basis.clone_with(k=basis.k + 1)
        return M

    @CachedMethod
    def radial_interpolation_row(self, position):
        """(1, Nr): evaluate level-k coefficients at problem radius."""
        z0 = self.radial_COV.native_coord(position)
        row = jacobi_tools.build_polynomials(self.Nr, self.a_k, self.b_k,
                                             np.array([float(z0)]))[:, 0]
        return (row * (self.dR / float(position)) ** self.k)[None, :]

    @CachedMethod
    def radial_integration_row(self, power):
        """(1, Nr): integral against r^power dr in problem units. Rational
        for k > power but smooth on the interval, so a generous Legendre
        rule is spectrally exact."""
        from scipy import special
        Nq = self.Nr + self.k + 64
        z, w = special.roots_legendre(Nq)
        P = jacobi_tools.build_polynomials(self.Nr, self.a_k, self.b_k, z)
        r_over_dR = (z + self.rho) / 2
        vals = r_over_dR ** (power - self.k)
        row = (P * (w * vals)) @ np.ones(Nq)
        return row[None, :] * self.dR ** (power + 1) / 2

    @CachedMethod
    def radial_constant_column(self):
        """(Nr, 1): level-k coefficients representing the constant 1."""
        a, b = self.a_k, self.b_k
        Nq = self.Nr + self.k + 4
        z = jacobi_tools.build_grid(Nq, a, b)
        w = jacobi_tools.build_weights(Nq, a, b)
        P = jacobi_tools.build_polynomials(self.Nr, a, b, z)
        col = (P * w) @ ((z + self.rho) / 2) ** self.k
        return col[:, None]

    def radial_multiplication_matrix(self, f_radial_coeffs, f_k, k_out=0):
        """
        (Nr, Nr): maps level-`self.k` radial coefficients of u to
        level-`k_out` coefficients of (f*u), for an angularly-constant NCC
        f with level-`f_k` radial coefficients. Assembled as
        transform->pointwise multiply->transform by quadrature
        (reference: core/basis.py:2293 _last_axis_component_ncc_matrix,
        Clenshaw replaced by direct quadrature).
        """
        a0, b0 = self.alpha
        f_radial_coeffs = np.asarray(f_radial_coeffs)
        if not np.iscomplexobj(f_radial_coeffs):
            f_radial_coeffs = f_radial_coeffs.astype(np.float64)
        Nf = f_radial_coeffs.shape[-1]
        Nq = self.Nr + Nf + self.k + int(abs(k_out)) + 32
        z = jacobi_tools.build_grid(Nq, a0 + k_out, b0 + k_out)
        w = jacobi_tools.build_weights(Nq, a0 + k_out, b0 + k_out)
        rr = (z + self.rho) / 2  # r/dR
        fvals = (f_radial_coeffs @ jacobi_tools.build_polynomials(
            Nf, a0 + f_k, b0 + f_k, z)) * rr ** (-f_k)
        U = jacobi_tools.build_polynomials(self.Nr, self.a_k, self.b_k, z) \
            * rr ** (k_out - self.k)
        Pout = jacobi_tools.build_polynomials(self.Nr, a0 + k_out, b0 + k_out, z)
        return (Pout * w) @ (fvals * U).T
