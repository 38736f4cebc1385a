"""
The spherical shell: ShellBasis, the regularity-component helpers and the
spherical calculus operators (counterpart of the shell half of
dedalus_tpu/core/spherical3d.py; reference: dedalus/core/basis.py:3682
ShellRadialBasis, :4336 ShellBasis, dedalus/core/operators.py:3078
SphericalEllOperator family). The ball waits for its slice (ROADMAP
queue 1 item 3): no BallBasis is defined here, and the assembly paths
that only a ball reaches raise NotImplementedError.

  * Coefficient layout is rectangular (Nphi, Ntheta, Nr). Both angular
    axes are separable: every spherical operator is block-diagonal over
    the (m, ell) groups, so the pencil is the radial direction (unless a
    colatitude-varying NCC couples ell: then one pencil per m).
  * Tensor components in coefficient space are REGULARITY components: for
    each ell the orthogonal intertwiner Q(ell) maps spin components to
    the combinations with radial character r^(ell + sum(reg))
    (reference: core/basis.py:3545 radial_recombinations). The
    recombination is one batched product against a (Ntheta, 3^r, 3^r)
    stack over the ell axis.
  * In regularity components every calculus operator is radial-only,
    with per-(ell, regularity) matrices: gradient, divergence and curl are
    xi-weighted ladders D+ = d/dr - l/r, D- = d/dr + (l+1)/r at l = ell +
    regtotal, each (A + c B)/dR with the shared weighted-Jacobi parts A, B
    (core/weighted_jacobi.py), applied as ("gblocks", colatitude, stack)
    descriptors: one batched product over the ell groups on the device.
"""

import numpy as np
import torch
from itertools import product as iter_product

from ..tools.cache import CachedMethod, cached_function
from ..tools.array import match_precision
from ..tools.general import is_complex_dtype
from ..libraries import sphere as swsh
from ..libraries.spin_intertwiners import (regularity_to_spin,
                                           valid_regularities)
from .basis import Basis, AffineCOV
from .coords import SphericalCoordinates
from .domain import Domain
from .future import ev
from .operators import LinearOperator
from .polar import _expand_complex_terms
from .sphere import SphereBasis
from .weighted_jacobi import WeightedJacobiRadial

BALL_PENDING = ("The ball is not carried by the port yet (ROADMAP queue 1 "
                "item 3); the shell is.")

REG_ORDERING = (-1, +1, 0)  # index 0 = '-', 1 = '+', 2 = '0' (radial)


# ----------------------------------------------------------------------
# Regularity component helpers

@cached_function
def reg_tuples(rank):
    return tuple(iter_product(REG_ORDERING, repeat=rank))


@cached_function
def reg_totals(rank):
    return np.array([sum(t) for t in reg_tuples(rank)], dtype=int) \
        if rank else np.zeros(1, dtype=int)


@cached_function
def q_stack(Ntheta, rank):
    """(Ntheta, 3^rank, 3^rank): Q(ell) regularity->spin, per ell."""
    return np.stack([regularity_to_spin(ell, rank) for ell in range(Ntheta)])


def spherical_rank(tensorsig, cs):
    """Number of tensor indices over `cs`; mixed signatures are rejected
    (reference restriction: core/basis.py:3551)."""
    rank = 0
    for tcs in tensorsig:
        if tcs == cs:
            rank += 1
        else:
            raise NotImplementedError(
                "3D spherical bases support tensors over the spherical "
                f"coordinate system only, got index {tcs!r}.")
    return rank


def apply_regularity_recombination(data, tdim, theta_data_axis, stack,
                                   forward):
    """
    Batched per-ell component recombination: forward maps spin ->
    regularity (Q^T), backward regularity -> spin (Q). `stack` is the
    host (L, ncomp, ncomp) q_stack (cached, so its device copy is made
    once); the theta axis of `data` must be in ell space. One batched
    product over the ell axis, no loop over ell.
    """
    tshape = tuple(data.shape[:tdim])
    ncomp = int(np.prod(tshape, dtype=int)) if tdim else 1
    spatial = tuple(data.shape[tdim:])
    flat = data.reshape((ncomp,) + spatial)
    stack = match_precision(stack, data)
    a = 1 + (theta_data_axis - tdim)
    moved = torch.movedim(flat, a, 1)  # (ncomp, L, rest...)
    if forward:
        out = torch.einsum("lji,jl...->il...", stack, moved)
    else:
        out = torch.einsum("lij,jl...->il...", stack, moved)
    out = torch.movedim(out, 1, a)
    return out.reshape(tshape + spatial)


def xi(mu, l):
    """Normalized derivative factors: xi(-1,l)^2 + xi(+1,l)^2 = 1
    (reference: libraries/dedalus_sphere/spin_operators.py:260)."""
    l = np.asarray(l, dtype=float)
    return np.sqrt(np.maximum(l + (mu + 1) // 2, 0.0)
                   / np.maximum(2 * l + 1, 1.0))


# ----------------------------------------------------------------------
# Shell basis

class ShellBasis(WeightedJacobiRadial, Basis):
    """
    Spherical-shell basis: SWSH angular x weighted-Jacobi radius on
    [Ri, Ro] (dedalus_tpu/core/spherical3d.py:114; reference:
    dedalus/core/basis.py:4336 ShellBasis). Real dtypes only: complex
    shells wait with the complex spheres (ROADMAP queue 1 item 2b).
    """

    dim = 3
    radial_sub_axis = 2
    regularity = True

    def __init__(self, coordsystem, shape, dtype=np.float64, radii=(1.0, 2.0),
                 k=0, alpha=(-0.5, -0.5), dealias=(1, 1, 1),
                 radius_library=None):
        if not isinstance(coordsystem, SphericalCoordinates):
            raise ValueError("Shell coordsys must be SphericalCoordinates.")
        if is_complex_dtype(dtype):
            raise NotImplementedError(
                "Complex-dtype shells are not carried by the port yet "
                "(ROADMAP queue 1 item 2b).")
        radii = tuple(map(float, radii))
        if min(radii) <= 0:
            raise ValueError("Shell radii must be positive.")
        if radii[0] >= radii[1]:
            raise ValueError("Shell radii must be increasing.")
        self.coordsystem = self.cs = coordsystem
        self.coord = coordsystem.coords[0]
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.radii = radii
        self.k = int(k)
        if np.isscalar(alpha):
            alpha = (alpha, alpha)
        self.alpha = tuple(map(float, alpha))
        if np.isscalar(dealias):
            dealias = (dealias,) * 3
        self.dealias = tuple(map(float, dealias))
        self.volume = 4 / 3 * np.pi * (radii[1] ** 3 - radii[0] ** 3)
        self.dR = radii[1] - radii[0]
        self.rho = (radii[1] + radii[0]) / self.dR
        self.radial_COV = AffineCOV((-1.0, 1.0), radii)
        Nphi, Ntheta, Nr = self.shape
        self.Nphi, self.Ntheta, self.Nr = Nphi, Ntheta, Nr
        self.Lmax = Ntheta - 1
        self.complex = False
        self.sphere_basis = SphereBasis(
            coordsystem.S2coordsys, (Nphi, Ntheta), dtype=dtype,
            radius=radii[1], dealias=self.dealias[:2], ell_separable=True)
        self.azimuth_basis = self.sphere_basis.azimuth_basis
        self.radius_library = radius_library
        self.inner_surface = self.S2_basis(radii[0])
        self.outer_surface = self.S2_basis(radii[1])

    def __repr__(self):
        return f"ShellBasis({self.shape}, radii={self.radii}, k={self.k})"

    def S2_basis(self, radius=None):
        """Sphere basis for boundary (tau/BC) fields
        (reference: core/basis.py ShellBasis.S2_basis)."""
        if radius is None:
            radius = self.radii[1]
        return SphereBasis(
            self.coordsystem.S2coordsys, (self.Nphi, self.Ntheta),
            dtype=self.dtype, radius=radius, dealias=self.dealias[:2],
            ell_separable=True)

    @property
    def meridional_basis(self):
        """Basis for NCC fields varying along (theta, r) only (reference:
        core/basis.py ShellBasis.meridional_basis). Here NCC angular
        structure is detected from field DATA rather than the declared
        basis, so this aliases the full basis; phi-constancy is validated
        at assembly (grid memory for the extra phi dim is negligible at
        NCC-construction scales)."""
        return self

    @property
    def radial_basis(self):
        """Basis for radius-only NCC fields (reference: core/basis.py
        ShellBasis.radial_basis); aliases the full basis — see
        `meridional_basis`."""
        return self

    # ------------------------------------------------------------ structure

    @property
    def first_axis(self):
        return self.coordsystem.first_axis

    @property
    def family_key(self):
        return (type(self).__name__, self.shape, self.radii, self.alpha,
                self.dtype)

    def coeff_size(self, sub_axis):
        return self.shape[sub_axis]

    def sub_grid_size(self, sub_axis, scale):
        return int(np.ceil(scale * self.shape[sub_axis]))

    def sub_separable(self, sub_axis):
        return sub_axis in (0, 1)

    def sub_group_shape(self, sub_axis):
        return 2 if sub_axis == 0 else 1

    def sub_n_groups(self, sub_axis):
        if sub_axis == 0:
            return self.Nphi // 2
        if sub_axis == 1:
            return self.Ntheta
        return 1

    def group_m(self):
        return self.sphere_basis.group_m()

    def clone_with(self, **changes):
        args = dict(coordsystem=self.coordsystem, shape=self.shape,
                    dtype=self.dtype, radii=self.radii, k=self.k,
                    alpha=self.alpha, dealias=self.dealias)
        args.update(changes)
        return ShellBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    # --------------------------------------------------------------- grids

    def global_grids(self, scales=(1, 1, 1)):
        return (self.sphere_basis.azimuth_grid(scales[0]),
                self.sphere_basis.colatitude_grid(scales[1]),
                self.radial_grid(scales[2]))

    # ---------------------------------------------------------- validity

    def component_valid_mask(self, tensorsig, group, sep_widths):
        """(ncomp, gs_az, 1, Nr) at one (m, ell) group: regularity component
        valid iff ell >= |m| and the regularity tuple is allowed at ell
        (reference: core/basis.py:3183 regularity_allowed)."""
        rank = spherical_rank(tensorsig, self.cs)
        ncomp = 3 ** rank
        az_axis = self.first_axis
        colat_axis = az_axis + 1
        gs = self.sub_group_shape(0)
        if az_axis not in sep_widths:
            raise NotImplementedError(
                "Shell azimuth must be a pencil (group) axis.")
        ms = self.group_m()
        m = ms[group[az_axis]]
        if colat_axis in sep_widths:
            ells = np.array([group[colat_axis]])
        else:
            # layout-coupled colatitude (theta-dependent NCC): all ell
            # slots live in one per-m pencil
            ells = np.arange(self.Ntheta)
        comp_ok = np.stack([valid_regularities(int(ell), rank)
                            & (ell >= abs(m)) for ell in ells], axis=1)
        mask = np.broadcast_to(comp_ok[:, None, :, None],
                               (ncomp, gs, ells.size, self.Nr)).copy()
        if rank <= 1:
            # Drop msin slots at ell == 0 for real scalars and vectors
            # (reference: core/basis.py:4301)
            mask[:, 1, ells == 0, :] = False
        return mask

    # ----------------------------------------------------------- transforms

    def forward_transform(self, gdata, axis, scale, library=None,
                          tensorsig=(), sub_axis=0):
        if sub_axis in (0, 1):
            return self.sphere_basis.forward_transform(
                gdata, axis, scale, library, tensorsig=tensorsig,
                sub_axis=sub_axis)
        tdim = len(tensorsig)
        rank = spherical_rank(tensorsig, self.cs)
        out = gdata
        if rank:
            stack = q_stack(self.Ntheta, rank)
            out = apply_regularity_recombination(out, tdim, axis - 1, stack,
                                                 forward=True)
        return self._radial_matmul(out, axis, scale, forward=True)

    def backward_transform(self, cdata, axis, scale, library=None,
                           tensorsig=(), sub_axis=0):
        if sub_axis in (0, 1):
            return self.sphere_basis.backward_transform(
                cdata, axis, scale, library, tensorsig=tensorsig,
                sub_axis=sub_axis)
        tdim = len(tensorsig)
        rank = spherical_rank(tensorsig, self.cs)
        out = self._radial_matmul(cdata, axis, scale, forward=False)
        if rank:
            stack = q_stack(self.Ntheta, rank)
            out = apply_regularity_recombination(out, tdim, axis - 1, stack,
                                                 forward=False)
        return out

    # ------------------------------------------------- radial matrix stacks
    # All stacks are (Ntheta, Nr, Nr), indexed by the ell group.

    def _ell_l(self, regtotal):
        """l = ell + regtotal per ell slot, with invalid (l < 0) flagged."""
        ell = np.arange(self.Ntheta)
        l = ell + int(regtotal)
        return l, l >= 0

    @CachedMethod
    def dplus_stack(self, regtotal):
        """D+ = d/dr - l/r at l = ell + regtotal, k -> k+1."""
        l, ok = self._ell_l(regtotal)
        A, B = self._ladder_parts()
        stack = (A[None] - l[:, None, None] * B[None]) / self.dR
        stack[~ok] = 0.0
        return stack

    @CachedMethod
    def dminus_stack(self, regtotal):
        """D- = d/dr + (l+1)/r at l = ell + regtotal, k -> k+1."""
        l, ok = self._ell_l(regtotal)
        A, B = self._ladder_parts()
        stack = (A[None] + (l + 1)[:, None, None] * B[None]) / self.dR
        stack[~ok] = 0.0
        return stack

    @CachedMethod
    def laplacian_reg_stack(self, regtotal):
        """L = D-(l+1) @ D+(l) at l = ell + regtotal, k -> k+2
        (reference: core/basis.py:3855 operator_matrix 'L')."""
        l, ok = self._ell_l(regtotal)
        up = self.dplus_stack(regtotal)
        k1 = self.clone_with(k=self.k + 1)
        A1, B1 = k1._ladder_parts()
        down = (A1[None] + (l + 2)[:, None, None] * B1[None]) / self.dR
        stack = np.einsum("gij,gjk->gik", down, up)
        stack[~ok] = 0.0
        return stack

    def lift_column(self, index):
        col = np.zeros((self.Nr, 1))
        col[index, 0] = 1.0
        return col

    @CachedMethod
    def interp_stack(self, regtotal, position):
        """(Ntheta, 1, Nr): boundary evaluation rows (ell-independent on
        the shell)."""
        return np.tile(self.radial_interpolation_row(position),
                       (self.Ntheta, 1, 1))

    def scalar_radial_coeffs(self, profile_grid_values, l_env=0):
        """Level-k radial coefficients of a radial profile on the scale-1
        grid (the envelope degree is irrelevant on the shell)."""
        return self._radial_forward_matrix(1.0) @ profile_grid_values

    def ncc_radial_matrix(self, f_radial_coeffs, f_k, R_in, R_out, ell,
                          k_out=0, l_env=0):
        """Radial NCC multiplication on the shell is independent of ell and
        regularity (no origin singularity): one quadrature matrix."""
        return self.radial_multiplication_matrix(f_radial_coeffs, f_k, k_out)

    @property
    def constant_angular_mode_value(self):
        """Grid value of the lowest angular mode (Y_00 for SWSH): the factor
        between (m=0, ell=0) coefficients and the radial profile they carry."""
        return float(swsh.harmonics(self.Lmax, 0, 0, np.array([0.5]))[0, 0])

    def constant_component_descr(self, sub_axis, device):
        if sub_axis == 0:
            if device:
                col = np.zeros((self.Nphi, 1))
                col[0, 0] = 1.0
                return ("full", col)
            return ("blocks", self.azimuth_basis.constant_blocks())
        if sub_axis == 1:
            Y00 = self.constant_angular_mode_value
            col = np.zeros((self.Ntheta, 1))
            col[0, 0] = 1.0 / Y00
            if device:
                return ("full", col)
            # separable axis: per-ell 1x1 blocks embedding into ell = 0
            blocks = np.zeros((self.Ntheta, 1, 1))
            blocks[0, 0, 0] = 1.0 / Y00
            return ("blocks", blocks)
        return ("full", self.radial_constant_column())

    # ---------------------------------------------------- conversion terms

    def conversion_terms(self, target, tensorsig, tshape):
        """k -> k+dk conversion: regularity/ell-independent single radial
        matrix (reference: core/basis.py:3877 conversion_matrix)."""
        if not isinstance(target, ShellBasis) or target.shape != self.shape \
                or target.radii != self.radii:
            raise ValueError(f"No conversion from {self} to {target}.")
        dk = target.k - self.k
        if dk == 0:
            return [(None, {})]
        if dk < 0:
            raise ValueError("Cannot convert to lower k.")
        r_axis = self.first_axis + 2
        return [(None, {r_axis: ("full", self._conversion_matrix_total(dk))})]



# ----------------------------------------------------------------------
# Spherical calculus operators (regularity components, ell-diagonal)

class SphericalEllOperator(LinearOperator):
    """Base for ell-diagonal spherical operators over the shell basis
    (dedalus_tpu/core/spherical3d.py:932; reference:
    core/operators.py:3078 SphericalEllOperator)."""

    def _basis(self, operand=None):
        operand = operand or self.operand
        for b in operand.domain.bases:
            if getattr(b, "regularity", False):
                return b
        raise ValueError("Operand has no 3D spherical basis.")

    def _axes(self, basis):
        first = basis.first_axis
        return first, first + 1, first + 2


class SphericalGradient(SphericalEllOperator):
    """Gradient: prepends a regularity index; each input component maps to
    the '-' and '+' branches through xi-weighted ladders
    (reference: core/operators.py:3210 SphericalGradient)."""

    name = "Grad"

    def __init__(self, operand, cs):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return SphericalGradient(new_args[0], self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        basis = self._basis(operand)
        self.domain = operand.domain.substitute_basis(basis, basis.derivative_basis(1))
        self.tensorsig = (self.cs,) + tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, colat, rad = self._axes(basis)
        rank = spherical_rank(operand.tensorsig, basis.cs)
        ncomp = 3 ** rank
        totals = reg_totals(rank)
        dim = operand.domain.dim
        ell = np.arange(basis.Ntheta)
        terms = []
        for sigma_idx, sign in ((0, -1), (1, +1)):
            for R in np.unique(totals):
                sel = np.zeros((3 * ncomp, ncomp))
                for j in np.flatnonzero(totals == R):
                    sel[sigma_idx * ncomp + j, j] = 1.0
                l = ell + int(R)
                if sign == -1:
                    stack = basis.dminus_stack(int(R)) \
                        * xi(-1, l)[:, None, None]
                else:
                    stack = basis.dplus_stack(int(R)) \
                        * xi(+1, l)[:, None, None]
                descrs = [None] * dim
                descrs[rad] = ("gblocks", colat, stack)
                terms.append((sel, descrs))
        return terms


class SphericalDivergence(SphericalEllOperator):
    """Divergence: contracts the leading regularity index; only the '-' and
    '+' branches contribute (reference: core/operators.py:3516)."""

    name = "Div"

    def __init__(self, operand, index=0):
        if index != 0:
            raise NotImplementedError("Divergence only supports index=0.")
        self.cs = operand.tensorsig[0]
        super().__init__(operand)

    def rebuild(self, new_args):
        return SphericalDivergence(new_args[0])

    def _build_metadata(self):
        operand = self.args[0]
        basis = self._basis(operand)
        self.domain = operand.domain.substitute_basis(basis, basis.derivative_basis(1))
        self.tensorsig = tuple(operand.tensorsig[1:])
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, colat, rad = self._axes(basis)
        rank_rest = spherical_rank(operand.tensorsig[1:], basis.cs)
        nrest = 3 ** rank_rest
        rest_totals = reg_totals(rank_rest)
        dim = operand.domain.dim
        ell = np.arange(basis.Ntheta)
        terms = []
        for a_idx, a_reg in ((0, -1), (1, +1)):
            for Rb in np.unique(rest_totals):
                regtotal_in = int(Rb + a_reg)
                sel = np.zeros((nrest, 3 * nrest))
                for j in np.flatnonzero(rest_totals == Rb):
                    sel[j, a_idx * nrest + j] = 1.0
                l = ell + regtotal_in
                if a_reg == -1:
                    stack = basis.dplus_stack(regtotal_in) \
                        * xi(-1, l + 1)[:, None, None]
                else:
                    stack = basis.dminus_stack(regtotal_in) \
                        * xi(+1, l - 1)[:, None, None]
                descrs = [None] * dim
                descrs[rad] = ("gblocks", colat, stack)
                terms.append((sel, descrs))
        return terms


class SphericalCurl(SphericalEllOperator):
    """Curl on the leading index (reference: core/operators.py:3808)."""

    name = "Curl"

    def __init__(self, operand, index=0):
        if index != 0:
            raise NotImplementedError("Curl only supports index=0.")
        self.cs = operand.tensorsig[0]
        super().__init__(operand)

    def rebuild(self, new_args):
        return SphericalCurl(new_args[0])

    def _build_metadata(self):
        operand = self.args[0]
        basis = self._basis(operand)
        self.domain = operand.domain.substitute_basis(basis, basis.derivative_basis(1))
        self.tensorsig = (self.cs,) + tuple(operand.tensorsig[1:])
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, colat, rad = self._axes(basis)
        rank_rest = spherical_rank(operand.tensorsig[1:], basis.cs)
        nrest = 3 ** rank_rest
        rest_totals = reg_totals(rank_rest)
        dim = operand.domain.dim
        ell = np.arange(basis.Ntheta)
        raw = []
        # (in regindex0, out regindex0, factor sign, ladder, xi args)
        # reference: core/operators.py:3855 SphericalCurl._radial_matrix
        for Rb in np.unique(rest_totals):
            comps = np.flatnonzero(rest_totals == Rb)

            def add(in_idx, out_idx, coeff, stack):
                sel = np.zeros((3 * nrest, 3 * nrest), dtype=complex)
                for j in comps:
                    sel[out_idx * nrest + j, in_idx * nrest + j] = coeff
                descrs = [None] * dim
                descrs[rad] = ("gblocks", colat, stack)
                raw.append((sel, descrs))

            t_m = int(Rb - 1)  # regtotal of ('-',) + b
            l = ell + t_m
            add(0, 2, -1j, basis.dplus_stack(t_m) * xi(+1, l + 1)[:, None, None])
            t_p = int(Rb + 1)
            l = ell + t_p
            add(1, 2, +1j, basis.dminus_stack(t_p) * xi(-1, l - 1)[:, None, None])
            t_0 = int(Rb)
            l = ell + t_0
            add(2, 0, -1j, basis.dminus_stack(t_0) * xi(+1, l)[:, None, None])
            add(2, 1, +1j, basis.dplus_stack(t_0) * xi(-1, l)[:, None, None])
        return _expand_complex_terms(raw, az, basis.sub_n_groups(0),
                                     basis.complex)


class SphericalLaplacian(SphericalEllOperator):
    """Laplacian: diagonal over regularity components
    (reference: core/operators.py:4073)."""

    name = "Lap"

    def __init__(self, operand, cs=None):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return SphericalLaplacian(new_args[0], self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        basis = self._basis(operand)
        self.domain = operand.domain.substitute_basis(basis, basis.derivative_basis(2))
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, colat, rad = self._axes(basis)
        rank = spherical_rank(operand.tensorsig, basis.cs)
        ncomp = 3 ** rank
        totals = reg_totals(rank)
        dim = operand.domain.dim
        terms = []
        for R in np.unique(totals):
            sel = np.diag((totals == R).astype(float)) if ncomp > 1 else None
            descrs = [None] * dim
            descrs[rad] = ("gblocks", colat, basis.laplacian_reg_stack(int(R)))
            terms.append((sel, descrs))
        return terms


class SphericalTrace(SphericalEllOperator):
    """Trace of the two leading indices in regularity components: the
    spin-frame metric row pulled through Q(ell) x Q(ell)
    (reference: core/operators.py:1756 SphericalTrace)."""

    name = "Trace"
    natural_layout = "g"

    def _build_metadata(self):
        operand = self.args[0]
        if len(operand.tensorsig) < 2:
            raise ValueError("Trace requires two tensor indices.")
        self.cs = operand.tensorsig[0]
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig[2:])
        self.dtype = operand.dtype

    @staticmethod
    @cached_function
    def _trace_rows(Ntheta):
        """(Ntheta, 9): trace functional on rank-2 regularity components:
        the spin metric row through the (coupled, non-kron) rank-2
        intertwiner."""
        t_spin = np.zeros(9)
        t_spin[1] = 1.0  # (-,+)
        t_spin[3] = 1.0  # (+,-)
        t_spin[8] = 1.0  # (0,0)
        Q2 = q_stack(Ntheta, 2)
        return np.stack([t_spin @ Q2[l] for l in range(Ntheta)])

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, colat, rad = self._axes(basis)
        rank_rest = len(operand.tensorsig) - 2
        nrest = 3 ** rank_rest
        dim = operand.domain.dim
        rows = self._trace_rows(basis.Ntheta)  # (L, 9)
        terms = []
        for j in range(9):
            if not np.any(rows[:, j]):
                continue
            row = np.zeros((1, 9))
            row[0, j] = 1.0
            factor = np.kron(row, np.identity(nrest))
            blocks = rows[:, j].reshape(-1, 1, 1)
            descrs = [None] * dim
            descrs[colat] = ("blocks", blocks)
            terms.append((factor, descrs))
        return terms

    def ev_impl(self, ctx):
        # grid-space trace: coordinate components contract with delta
        data = ev(self.operand, ctx, "g")
        return torch.diagonal(data, dim1=0, dim2=1).sum(-1)


class SphericalTransposeComponents(LinearOperator):
    """
    Index transpose for tensors on shell (regularity-component)
    bases. The regularity intertwiner Q(ell) is NOT a kron over tensor
    indices, so a plain component permutation is wrong; the transpose in
    coefficient space is the per-ell sandwich Q(ell)^T P_swap Q(ell)
    with P_swap the index swap in the (kron-structured) spin frame
    (reference: core/operators.py:1870 TransposeComponents with
    radial_basis intertwiners). Entry-decomposed into one-hot tensor
    factors with per-ell colatitude blocks, like SphericalLift.
    """

    name = "TransposeComponents"
    natural_layout = "g"

    def __init__(self, operand, indices=(0, 1)):
        self.indices = indices
        super().__init__(operand)

    def rebuild(self, new_args):
        return SphericalTransposeComponents(new_args[0], self.indices)

    def _basis(self, operand):
        for b in operand.domain.bases:
            if getattr(b, "regularity", False):
                return b
        raise ValueError("Operand has no 3D spherical basis.")

    def _build_metadata(self):
        operand = self.args[0]
        i, j = self.indices
        ts = list(operand.tensorsig)
        ts[i], ts[j] = ts[j], ts[i]
        self.domain = operand.domain
        self.tensorsig = tuple(ts)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az = basis.first_axis
        colat = az + 1
        rank = spherical_rank(operand.tensorsig, basis.cs)
        ncomp = 3 ** rank
        tshape = operand.tshape
        perm = np.arange(ncomp).reshape(tshape)
        perm = np.swapaxes(perm, *self.indices).ravel()
        P = np.zeros((ncomp, ncomp))
        P[np.arange(ncomp), perm] = 1.0
        Q = q_stack(basis.Ntheta, rank)          # (Ntheta, spin, reg)
        M = np.einsum("lsi,st,ltj->lij", Q, P, Q)  # Q^T P Q per ell
        dim = operand.domain.dim
        terms = []
        for i in range(ncomp):
            for j in range(ncomp):
                col = M[:, i, j]
                if not np.any(np.abs(col) > 1e-14):
                    continue
                factor = np.zeros((ncomp, ncomp))
                factor[i, j] = 1.0
                descrs = [None] * dim
                descrs[colat] = ("blocks", col.reshape(-1, 1, 1))
                terms.append((factor, descrs))
        return terms

    def ev_impl(self, ctx):
        data = ev(self.operand, ctx, "g")
        i, j = self.indices
        return torch.swapaxes(data, i, j)


class SphericalSpinTrace(LinearOperator):
    """Trace of rank-2 spherical-signature tensors on S2 (boundary) bases,
    where components are stored in the 3D spin frame: the spin metric
    contracts (-,+), (+,-), and (0,0) with constant coefficients."""

    name = "Trace"
    natural_layout = "g"

    def _build_metadata(self):
        operand = self.args[0]
        if len(operand.tensorsig) < 2:
            raise ValueError("Trace requires two tensor indices.")
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig[2:])
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        rest = int(np.prod(operand.tshape[2:], dtype=int)) \
            if operand.tshape[2:] else 1
        row = np.zeros((1, 9))
        row[0, 1] = 1.0  # (-,+)
        row[0, 3] = 1.0  # (+,-)
        row[0, 8] = 1.0  # (0,0)
        factor = np.kron(row, np.identity(rest))
        return [(factor, [None] * operand.domain.dim)]

    def ev_impl(self, ctx):
        data = ev(self.operand, ctx, "g")
        return torch.diagonal(data, dim1=0, dim2=1).sum(-1)


class SphericalInterpolate(SphericalEllOperator):
    """Radial interpolation onto a bounding sphere: regularity -> spin
    recombination Q(ell) folded into per-ell blocks
    (reference: core/operators.py:1037 Interpolate + RegularityBasis
    recombination)."""

    name = "interp"

    def __init__(self, operand, position):
        self.position = position
        super().__init__(operand)

    def rebuild(self, new_args):
        return SphericalInterpolate(new_args[0], self.position)

    def _build_metadata(self):
        operand = self.args[0]
        basis = self._basis(operand)
        az, colat, rad = self._axes(basis)
        sphere = basis.S2_basis(self.position)
        bases = list(operand.domain.bases)
        bases[az] = sphere
        bases[colat] = sphere
        bases[rad] = None
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, colat, rad = self._axes(basis)
        rank = spherical_rank(operand.tensorsig, basis.cs)
        ncomp = 3 ** rank
        totals = reg_totals(rank)
        dim = operand.domain.dim
        Q = q_stack(basis.Ntheta, rank)  # (L, ncomp, ncomp) reg->spin
        terms = []
        for i in range(ncomp):
            for j in range(ncomp):
                if not np.any(Q[:, i, j]):
                    continue
                factor = np.zeros((ncomp, ncomp))
                factor[i, j] = 1.0
                # fold the per-ell Q scalar into the per-ell radial rows
                rows = basis.interp_stack(int(totals[j]), self.position)
                stack = Q[:, i, j, None, None] * rows
                descrs = [None] * dim
                descrs[rad] = ("gblocks", colat, stack)
                terms.append((factor if ncomp > 1 else None, descrs))
        return terms


class SphericalLift(SphericalEllOperator):
    """Lift a sphere (S2) tau field into the shell via radial mode `n`:
    spin -> regularity recombination Q(ell)^T folded into per-ell blocks
    (reference: core/operators.py:4228 Lift)."""

    name = "Lift"

    def __init__(self, operand, basis, n):
        self.basis = basis
        self.n = n
        super().__init__(operand)

    def rebuild(self, new_args):
        return SphericalLift(new_args[0], self.basis, self.n)

    def _basis(self, operand=None):
        return self.basis

    def _build_metadata(self):
        operand = self.args[0]
        basis = self.basis
        az, colat, rad = self._axes(basis)
        if operand.domain.bases[rad] is not None:
            raise ValueError("Lift operand must be constant along the radius.")
        bases = list(operand.domain.bases)
        bases[az] = basis
        bases[colat] = basis
        bases[rad] = basis
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        basis = self.basis
        az, colat, rad = self._axes(basis)
        rank = spherical_rank(self.operand.tensorsig, basis.cs)
        ncomp = 3 ** rank
        dim = self.operand.domain.dim
        index = self.n if self.n >= 0 else basis.Nr + self.n
        col = basis.lift_column(index)
        Q = q_stack(basis.Ntheta, rank)
        terms = []
        for i in range(ncomp):      # output regularity component
            for j in range(ncomp):  # input spin component
                if not np.any(Q[:, j, i]):
                    continue
                factor = np.zeros((ncomp, ncomp))
                factor[i, j] = 1.0
                blocks = Q[:, j, i].reshape(-1, 1, 1)
                descrs = [None] * dim
                descrs[colat] = ("blocks", blocks)
                descrs[rad] = ("full", col)
                terms.append((factor if ncomp > 1 else None, descrs))
        return terms


class SphericalIntegrate(SphericalEllOperator):
    """Integral of a scalar over the shell volume
    (reference: core/operators.py:1120 Integrate)."""

    name = "integ"

    def _build_metadata(self):
        operand = self.args[0]
        if operand.tensorsig:
            raise NotImplementedError("Shell integration of tensors not supported.")
        basis = self._basis(operand)
        az, colat, rad = self._axes(basis)
        bases = list(operand.domain.bases)
        bases[az] = bases[colat] = bases[rad] = None
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = ()
        self.dtype = operand.dtype

    @CachedMethod
    def _colat_row(self):
        basis = self._basis(self.operand)
        z, w = swsh.quadrature(basis.Lmax)
        Y = swsh.harmonics(basis.Lmax, 0, 0, z)
        return Y @ w  # (Ntheta,)

    def terms(self):
        basis = self._basis(self.operand)
        az, colat, rad = self._axes(basis)
        dim = self.operand.domain.dim
        G = basis.sub_n_groups(0)
        gs = basis.sub_group_shape(0)
        az_blocks = np.zeros((G, gs, gs))
        az_blocks[0, 0, 0] = 2 * np.pi
        col_row = self._colat_row()
        col_blocks = col_row.reshape(-1, 1, 1)
        descrs = [None] * dim
        descrs[az] = ("blocks", az_blocks)
        descrs[colat] = ("blocks", col_blocks)
        descrs[rad] = ("full", basis.radial_integration_row(power=2))
        return [(None, descrs)]

    def device_terms(self):
        basis = self._basis(self.operand)
        az, colat, rad = self._axes(basis)
        dim = self.operand.domain.dim
        row_az = np.zeros((1, basis.Nphi))
        row_az[0, 0] = 2 * np.pi
        descrs = [None] * dim
        descrs[az] = ("full", row_az)
        descrs[colat] = ("full", self._colat_row()[None, :])
        descrs[rad] = ("full", basis.radial_integration_row(power=2))
        return [(None, descrs)]


class SphericalComponent(LinearOperator):
    """
    Radial/angular component extraction on sphere-basis (S2 boundary)
    fields, where spin storage makes the selection a constant matrix in both
    layouts (reference: core/operators.py:2160-2283 RadialComponent/
    AngularComponent). Interior shell fields store regularity
    components, so LHS extraction there is not a constant selection; use it
    on boundary fields or on the RHS.
    """

    name = "Comp"

    def __init__(self, operand, which, index=0):
        self.which = which  # 'radial' | 'angular'
        self.index = index
        super().__init__(operand)

    def rebuild(self, new_args):
        return SphericalComponent(new_args[0], self.which, self.index)

    def _build_metadata(self):
        operand = self.args[0]
        cs = operand.tensorsig[self.index]
        if not isinstance(cs, SphericalCoordinates):
            raise ValueError("Component extraction needs a spherical index.")
        for b in operand.domain.bases:
            if getattr(b, "regularity", False):
                raise ValueError(
                    "Radial/angular extraction has no constant coefficient "
                    "matrix on shell interiors (regularity storage); "
                    "apply it to boundary (S2) fields or on the RHS.")
        self.cs = cs
        self.domain = operand.domain
        ts = list(operand.tensorsig)
        if self.which in ("radial", "azimuthal"):
            ts.pop(self.index)
        else:
            ts[self.index] = cs.S2coordsys
        self.tensorsig = tuple(ts)
        self.dtype = operand.dtype

    def _factor(self):
        before = int(np.prod([c.dim for c in self.operand.tensorsig[:self.index]],
                             dtype=int)) if self.index else 1
        after_sig = self.operand.tensorsig[self.index + 1:]
        after = int(np.prod([c.dim for c in after_sig], dtype=int)) \
            if after_sig else 1
        if self.which == "radial":
            row = np.array([[0.0, 0.0, 1.0]])  # spin/coordinate index 2
        else:
            row = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        return np.kron(np.kron(np.identity(before), row), np.identity(after))

    def terms(self):
        if self.which == "azimuthal":
            # u_phi alone is not a smooth spin-weighted scalar: spin-(+-1)
            # SWSH coefficients cannot map to scalar SWSH coefficients with
            # a constant matrix. Grid-space (RHS) use only.
            raise ValueError(
                "Azimuthal extraction on spherical fields has no "
                "coefficient-space matrix; use angular()/radial() in "
                "boundary conditions, or azimuthal() on the RHS.")
        dim = self.operand.domain.dim
        return [(self._factor(), [None] * dim)]

    def ev_impl(self, ctx):
        if self.which == "azimuthal":
            # NOTE: u_phi of a smooth vector is not a smooth scalar on S2;
            # storing the result in a scalar field projects it onto scalar
            # SWSH with only algebraic convergence. Pointwise use only.
            data = ev(self.operand, ctx, "g")
            index = [slice(None)] * self.index + [0]
            return data[tuple(index)]
        return super().ev_impl(ctx)

    @property
    def natural_layout(self):
        return "g" if self.which == "azimuthal" else "c"


# ----------------------------------------------------------------------
# Factory wiring helpers (used by core.operators dispatchers)

def spherical_basis_of(operand):
    for b in operand.domain.bases:
        if b is not None and getattr(b, "regularity", False):
            return b
    return None
