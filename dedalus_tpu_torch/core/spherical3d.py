"""
The 3-D spherical bases: ShellBasis and BallBasis, the regularity-component
helpers and the spherical calculus operators (counterpart of
dedalus_tpu/core/spherical3d.py; reference: dedalus/core/basis.py:3682
ShellRadialBasis, :4336 ShellBasis, :3920 BallRadialBasis, :4568
BallBasis, dedalus/core/operators.py:3078 SphericalEllOperator family).

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
    regtotal, applied as ("gblocks", colatitude, stack) descriptors: one
    batched product over the ell groups on the device. On the shell each
    is (A + c B)/dR with the shared weighted-Jacobi parts A, B
    (core/weighted_jacobi.py); on the ball each is a Zernike ladder at
    degree l, and the radial transforms themselves depend on ell.
"""

import numpy as np
import torch
from itertools import product as iter_product

from ..tools.cache import CachedMethod, cached_function
from ..tools.array import match_precision
from ..tools.general import is_complex_dtype
from ..libraries import sphere as swsh
from ..libraries import zernike
from ..tools import jacobi as jacobi_tools
from ..libraries.spin_intertwiners import (regularity_to_spin,
                                           valid_regularities)
from .basis import Basis, AffineCOV
from .coords import SphericalCoordinates
from .curvilinear import apply_group_stack, promote_complex
from .domain import Domain
from .future import ev
from .operators import LinearOperator
from .polar import _expand_complex_terms
from .sphere import SphereBasis
from .weighted_jacobi import WeightedJacobiRadial

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
    stack = promote_complex(match_precision(stack, data), data)
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
    dedalus/core/basis.py:4336 ShellBasis). Real dtypes carry (cos, -sin)
    azimuth pairs in Nphi/2 groups; complex ones one m per group over
    Nphi groups in fftfreq order, the Nyquist group without valid slots.
    """

    dim = 3
    radial_sub_axis = 2
    regularity = True

    def __init__(self, coordsystem, shape, dtype=np.float64, radii=(1.0, 2.0),
                 k=0, alpha=(-0.5, -0.5), dealias=(1, 1, 1),
                 radius_library=None):
        if not isinstance(coordsystem, SphericalCoordinates):
            raise ValueError("Shell coordsys must be SphericalCoordinates.")
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
        self.complex = is_complex_dtype(self.dtype)
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
        if sub_axis == 0:
            return 1 if self.complex else 2
        return 1

    def sub_n_groups(self, sub_axis):
        if sub_axis == 0:
            return self.Nphi if self.complex else self.Nphi // 2
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
        if self.sphere_basis.nyquist(group[az_axis]):
            mask[:] = False
        if not self.complex and rank <= 1:
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
# Ball basis

class BallBasis(Basis):
    """
    Solid-ball basis: SWSH angular x generalized-Zernike radius
    (dedalus_tpu/core/spherical3d.py:421; reference:
    dedalus/core/basis.py:4568 BallBasis, :3920 BallRadialBasis). Its
    structure is the shell's (real dtypes carry (cos, -sin) azimuth pairs
    in Nphi/2 groups, complex ones one m per group over Nphi groups in
    fftfreq order), with two differences rooted in the origin regularity:

      * each regularity component expands in Zernike polynomials at
        generalized degree l = ell + regtotal, so the radial transforms
        and operator matrices are (Ntheta, rows, cols) stacks over the ell
        groups, applied on the device as one batched product per
        regularity total (the reference loops per ell:
        core/transforms.py:1451 BallRadialTransform);
      * triangular truncation: radial slot n at harmonic degree ell is
        valid for n >= nmin(ell) = ell // 2, a mask on rectangular arrays
        (reference: core/basis.py:4086 _nmin).
    """

    dim = 3
    radial_sub_axis = 2
    regularity = True

    def __init__(self, coordsystem, shape, dtype=np.float64, radius=1.0,
                 k=0, alpha=0, dealias=(1, 1, 1), radius_library=None):
        if not isinstance(coordsystem, SphericalCoordinates):
            raise ValueError("Ball coordsys must be SphericalCoordinates.")
        self.coordsystem = self.cs = coordsystem
        self.coord = coordsystem.coords[0]
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.radius = float(radius)
        self.k = int(k)
        self.alpha = float(alpha)
        if np.isscalar(dealias):
            dealias = (dealias,) * 3
        self.dealias = tuple(map(float, dealias))
        self.volume = 4 / 3 * np.pi * radius ** 3
        self.radial_COV = AffineCOV((0.0, 1.0), (0.0, radius))
        Nphi, Ntheta, Nr = self.shape
        self.Nphi, self.Ntheta, self.Nr = Nphi, Ntheta, Nr
        self.Lmax = Ntheta - 1
        self.complex = is_complex_dtype(self.dtype)
        self.sphere_basis = SphereBasis(
            coordsystem.S2coordsys, (Nphi, Ntheta), dtype=dtype,
            radius=radius, dealias=self.dealias[:2], ell_separable=True)
        self.azimuth_basis = self.sphere_basis.azimuth_basis
        self.radius_library = radius_library
        self.surface = self.S2_basis(radius)

    def __repr__(self):
        return f"BallBasis({self.shape}, radius={self.radius}, k={self.k})"

    def S2_basis(self, radius=None):
        """Sphere basis for boundary (tau/BC) fields."""
        if radius is None:
            radius = self.radius
        return SphereBasis(
            self.coordsystem.S2coordsys, (self.Nphi, self.Ntheta),
            dtype=self.dtype, radius=radius, dealias=self.dealias[:2],
            ell_separable=True)

    @property
    def meridional_basis(self):
        """See ShellBasis.meridional_basis: aliases the full basis (NCC
        angular structure is detected from data)."""
        return self

    @property
    def radial_basis(self):
        """See ShellBasis.radial_basis: aliases the full basis."""
        return self

    # ------------------------------------------------------------ structure

    @property
    def first_axis(self):
        return self.coordsystem.first_axis

    @property
    def family_key(self):
        return (type(self).__name__, self.shape, self.radius, self.alpha,
                self.dtype)

    @property
    def a_k(self):
        """Absolute Zernike weight parameter."""
        return self.alpha + self.k

    @staticmethod
    def _nmin(ell):
        return int(ell) // 2

    def coeff_size(self, sub_axis):
        return self.shape[sub_axis]

    def sub_grid_size(self, sub_axis, scale):
        return int(np.ceil(scale * self.shape[sub_axis]))

    def sub_separable(self, sub_axis):
        return sub_axis in (0, 1)

    def sub_group_shape(self, sub_axis):
        if sub_axis == 0:
            return 1 if self.complex else 2
        return 1

    def sub_n_groups(self, sub_axis):
        if sub_axis == 0:
            return self.Nphi if self.complex else self.Nphi // 2
        if sub_axis == 1:
            return self.Ntheta
        return 1

    def group_m(self):
        return self.sphere_basis.group_m()

    def clone_with(self, **changes):
        args = dict(coordsystem=self.coordsystem, shape=self.shape,
                    dtype=self.dtype, radius=self.radius, k=self.k,
                    alpha=self.alpha, dealias=self.dealias)
        args.update(changes)
        return BallBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    # --------------------------------------------------------------- grids

    def radial_grid(self, scale=1.0):
        Ng = self.sub_grid_size(2, scale)
        return self.radius * zernike.grid(3, Ng, self.alpha)

    def global_grids(self, scales=(1, 1, 1)):
        return (self.sphere_basis.azimuth_grid(scales[0]),
                self.sphere_basis.colatitude_grid(scales[1]),
                self.radial_grid(scales[2]))

    # ---------------------------------------------------------- validity

    def component_valid_mask(self, tensorsig, group, sep_widths):
        """(ncomp, gs_az, 1, Nr): regularity validity at (m, ell) plus the
        radial triangular truncation n >= nmin(ell)."""
        rank = spherical_rank(tensorsig, self.cs)
        ncomp = 3 ** rank
        az_axis = self.first_axis
        colat_axis = az_axis + 1
        gs = self.sub_group_shape(0)
        if az_axis not in sep_widths:
            raise NotImplementedError(
                "Ball azimuth must be a pencil (group) axis.")
        ms = self.group_m()
        m = ms[group[az_axis]]
        if colat_axis in sep_widths:
            ells = np.array([group[colat_axis]])
        else:
            # layout-coupled colatitude (theta-dependent NCC)
            ells = np.arange(self.Ntheta)
        n = np.arange(self.Nr)
        mask = np.zeros((ncomp, gs, ells.size, self.Nr), dtype=bool)
        for i, ell in enumerate(ells):
            comp_ok = valid_regularities(int(ell), rank) & (ell >= abs(m))
            n_ok = n >= self._nmin(int(ell))
            mask[:, :, i, :] = (comp_ok[:, None, None]
                                & n_ok[None, None, :])
        if self.sphere_basis.nyquist(group[az_axis]):
            mask[:] = False
        if not self.complex and rank <= 1:
            # Drop msin slots at ell == 0 for real scalars and vectors
            # (reference: core/basis.py:4301)
            mask[:, 1, ells == 0, :] = False
        return mask

    # ------------------------------------------------- radial matrix stacks
    # (Ntheta, rows, cols) stacks over the ell groups; slot dimensions are
    # right-aligned at nmin(ell).

    def _build_ell_stack(self, build, rows, cols, align_rows=True,
                         align_cols=True):
        out = np.zeros((self.Ntheta, rows, cols))
        for ell in range(self.Ntheta):
            nmin = self._nmin(ell)
            n = self.Nr - nmin
            if n <= 0:
                continue
            mat = build(ell, n)
            if mat.size == 0:
                continue
            r0 = nmin if align_rows else 0
            c0 = nmin if align_cols else 0
            out[ell, r0:r0 + mat.shape[0], c0:c0 + mat.shape[1]] = mat
        return out

    @CachedMethod
    def radial_forward_stack(self, regtotal, scale=1.0):
        """(Ntheta, Nr, Ngr): grid -> aligned Zernike coefficients at
        l = ell + regtotal (reference: core/transforms.py:1451)."""
        Ngr = self.sub_grid_size(2, scale)
        z, w = zernike.quadrature(3, Ngr, self.alpha)
        extra = ((1 - z) / 2) ** self.k if self.k else 1.0

        def build(ell, n):
            l = ell + int(regtotal)
            if l < 0:
                return np.zeros((n, Ngr))
            Q = zernike.polynomials(3, n, self.a_k, l, z)
            Q = Q * w * extra
            dN = l // 2
            Q[max(Ngr - dN, 0):] = 0
            return Q
        return self._build_ell_stack(build, self.Nr, Ngr, align_cols=False)

    @CachedMethod
    def radial_backward_stack(self, regtotal, scale=1.0):
        """(Ntheta, Ngr, Nr): coefficients -> grid values."""
        Ngr = self.sub_grid_size(2, scale)
        z, _ = zernike.quadrature(3, Ngr, self.alpha)

        def build(ell, n):
            l = ell + int(regtotal)
            if l < 0:
                return np.zeros((Ngr, n))
            Q = zernike.polynomials(3, n, self.a_k, l, z)
            dN = l // 2
            Q[max(Ngr - dN, 0):] = 0
            return Q.T
        return self._build_ell_stack(build, Ngr, self.Nr, align_rows=False)

    @CachedMethod
    def dplus_stack(self, regtotal):
        """D+ = d/dr - l/r at l = ell + regtotal, k -> k+1, problem units."""
        def build(ell, n):
            l = ell + int(regtotal)
            if l < 0:
                return np.zeros((n, n))
            M = zernike.ladder_matrix(3, n, self.a_k, l, l + 1, l, +1)
            return np.sqrt(2) * M / self.radius
        return self._build_ell_stack(build, self.Nr, self.Nr)

    @CachedMethod
    def dminus_stack(self, regtotal):
        """D- = d/dr + (l+1)/r at l = ell + regtotal, k -> k+1."""
        def build(ell, n):
            l = ell + int(regtotal)
            if l < 1:
                # l = 0: D- output degree -1 does not exist
                return np.zeros((n, n))
            M = zernike.ladder_matrix(3, n, self.a_k, l, l - 1, -(l + 1), +1)
            return np.sqrt(2) * M / self.radius
        return self._build_ell_stack(build, self.Nr, self.Nr)

    @CachedMethod
    def laplacian_reg_stack(self, regtotal):
        """L = D-(l+1) @ D+(l), k -> k+2."""
        up = self.dplus_stack(regtotal)
        k1 = self.clone_with(k=self.k + 1)

        def build_down(ell, n):
            l = ell + int(regtotal)
            if l < 0:
                return np.zeros((n, n))
            M = zernike.ladder_matrix(3, n, k1.a_k, l + 1, l, -(l + 2), +1)
            return np.sqrt(2) * M / self.radius
        down = self._build_ell_stack(build_down, self.Nr, self.Nr)
        return np.einsum("gij,gjk->gik", down, up)

    @CachedMethod
    def interp_stack(self, regtotal, position):
        """(Ntheta, 1, Nr): evaluate regtotal components at problem radius
        `position` (per-ell rows: r = 0 keeps only l = 0)."""
        r0 = self.radial_COV.native_coord(position)

        def build(ell, n):
            l = ell + int(regtotal)
            if l < 0:
                return np.zeros((1, n))
            return zernike.interpolation_row(3, n, self.a_k, l, r0)
        return self._build_ell_stack(build, 1, self.Nr, align_rows=False)

    def lift_column(self, index):
        col = np.zeros((self.Nr, 1))
        col[index, 0] = 1.0
        return col

    @property
    def constant_angular_mode_value(self):
        return float(swsh.harmonics(self.Lmax, 0, 0, np.array([0.5]))[0, 0])

    @CachedMethod
    def radial_integration_row(self, power=2):
        """(1, Nr): integral against r^power dr for the (m=0, ell=0,
        regtotal=0) group, in problem units. Gauss-Jacobi with the
        r^(power-1) envelope folded into the weight, exact for any
        power > 0."""
        if power == 2:
            row = zernike.integration_row(3, self.Nr, self.a_k, 0)
        else:
            # int_0^1 Q_n(r) r^p dr = (1/4) int Q_n(z) ((1+z)/2)^((p-1)/2) dz
            b_env = (power - 1) / 2
            Nq = self.Nr + self.k + 4
            z = jacobi_tools.build_grid(Nq, 0, b_env)
            w = jacobi_tools.build_weights(Nq, 0, b_env)
            Q = zernike.polynomials(3, self.Nr, self.a_k, 0, z)
            row = ((Q * w) @ np.ones(Nq))[None, :] / 4
        return row * self.radius ** (power + 1)

    def radial_constant_column(self):
        """(Nr, 1): level-k coefficients of the constant 1 at l = 0."""
        Ngr = self.Nr + self.k + 2
        z, w = zernike.quadrature(3, Ngr, self.alpha)
        extra = ((1 - z) / 2) ** self.k if self.k else 1.0
        Q = zernike.polynomials(3, self.Nr, self.a_k, 0, z)
        col = (Q * w * extra) @ np.ones(Ngr)
        return col[:, None]

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
            blocks = np.zeros((self.Ntheta, 1, 1))
            blocks[0, 0, 0] = 1.0 / Y00
            return ("blocks", blocks)
        return ("full", self.radial_constant_column())

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
        return self._radial_reg_apply(out, tdim, axis, rank, scale,
                                      forward=True)

    def backward_transform(self, cdata, axis, scale, library=None,
                           tensorsig=(), sub_axis=0):
        if sub_axis in (0, 1):
            return self.sphere_basis.backward_transform(
                cdata, axis, scale, library, tensorsig=tensorsig,
                sub_axis=sub_axis)
        tdim = len(tensorsig)
        rank = spherical_rank(tensorsig, self.cs)
        out = self._radial_reg_apply(cdata, tdim, axis, rank, scale,
                                     forward=False)
        if rank:
            stack = q_stack(self.Ntheta, rank)
            out = apply_regularity_recombination(out, tdim, axis - 1, stack,
                                                 forward=False)
        return out

    def _radial_reg_apply(self, data, tdim, r_axis, rank, scale, forward):
        """The radial transform: per regularity total one batched product
        over the ell axis against its (Ntheta, out, in) stack (the
        colatitude is the group axis, width 1; the host stacks are cached,
        so each is uploaded once)."""
        totals = reg_totals(rank)
        ncomp = 3 ** rank
        tshape = tuple(data.shape[:tdim])
        flat = data.reshape((ncomp,) + tuple(data.shape[tdim:]))
        colat_axis = r_axis - 1
        a_groups = 1 + colat_axis - tdim
        a_target = 1 + r_axis - tdim
        if ncomp == 1:
            stack = self.radial_forward_stack(0, scale) if forward \
                else self.radial_backward_stack(0, scale)
            out = apply_group_stack(flat, stack, a_groups, a_target, 1)
            return out.reshape(tshape + tuple(out.shape[1:]))
        pieces = [None] * ncomp
        for R in np.unique(totals):
            stack = self.radial_forward_stack(int(R), scale) if forward \
                else self.radial_backward_stack(int(R), scale)
            idx = [int(i) for i in np.flatnonzero(totals == R)]
            # components gathered by integer views: an index array would
            # be copied to the device, a host synchronization
            sub = torch.stack([flat[i] for i in idx])
            sub = apply_group_stack(sub, stack, a_groups, a_target, 1)
            for j, i in enumerate(idx):
                pieces[i] = sub[j]
        out = torch.stack(pieces, dim=0)
        return out.reshape(tshape + tuple(out.shape[1:]))

    # ---------------------------------------------------- conversion terms

    def conversion_terms(self, target, tensorsig, tshape):
        """k -> k+dk conversion: per-(ell, regtotal) Zernike connection
        stacks (reference: core/basis.py:4057 conversion_matrix)."""
        if not isinstance(target, BallBasis) or target.shape != self.shape \
                or target.radius != self.radius:
            raise ValueError(f"No conversion from {self} to {target}.")
        dk = target.k - self.k
        if dk == 0:
            return [(None, {})]
        if dk < 0:
            raise ValueError("Cannot convert to lower k.")
        rank = spherical_rank(tensorsig, self.cs)
        totals = reg_totals(rank)
        ncomp = 3 ** rank
        colat = self.first_axis + 1
        r_axis = self.first_axis + 2
        terms = []
        for R in np.unique(totals):
            sel = np.diag((totals == R).astype(float)) if ncomp > 1 else None
            stack = self.conversion_reg_stack(int(R), int(dk))
            terms.append((sel, {r_axis: ("gblocks", colat, stack)}))
        return terms

    @CachedMethod
    def conversion_reg_stack(self, regtotal, dk):
        def build(ell, n):
            l = ell + int(regtotal)
            if l < 0:
                return np.zeros((n, n))
            M = np.eye(n)
            for dki in range(dk):
                M = zernike.conversion_matrix(3, n, self.a_k + dki, l) @ M
            return M
        return self._build_ell_stack(build, self.Nr, self.Nr)

    # ------------------------------------------------------- NCC products

    def scalar_radial_coeffs(self, profile_grid_values, l_env=0):
        """Project a radial profile (on the scale-1 grid) onto Zernike
        coefficients at envelope degree l_env (the all-radial component of
        a rank-r NCC carries an r^r envelope, so odd profiles like r*er
        stay exact; reference: core/basis.py:4110 b_ncc = regtotal +
        1/2)."""
        profile = np.asarray(profile_grid_values, dtype=np.float64)
        Ngr = profile.shape[-1]
        z, w = zernike.quadrature(3, Ngr, self.alpha)
        extra = ((1 - z) / 2) ** self.k if self.k else 1.0
        Q = zernike.polynomials(3, self.Nr, self.a_k, l_env, z)
        return (Q * (w * extra)) @ profile

    def ncc_radial_matrix(self, f_radial_coeffs, f_k, R_in, R_out, ell,
                          k_out=0, l_env=0):
        """(Nr, Nr): per-(ell, regularity) multiplication by the radial NCC
        with level-f_k l=0 coefficients, mapping regtotal R_in components
        at harmonic ell to R_out components at level k_out
        (reference: core/basis.py:4101 _last_axis_component_ncc_matrix)."""
        nmin = self._nmin(ell)
        n = self.Nr - nmin
        l_in = ell + int(R_in)
        l_out = ell + int(R_out)
        if n <= 0 or l_in < 0 or l_out < 0:
            return np.zeros((self.Nr, self.Nr))
        f_coeffs = np.asarray(f_radial_coeffs, dtype=np.float64)
        Nf = f_coeffs.shape[-1]
        a_f = self.alpha + f_k

        def values(z):
            fvals = f_coeffs @ zernike.polynomials(3, Nf, a_f, l_env, z)
            return fvals * zernike.polynomials(3, n, self.a_k, l_in, z)

        M = zernike._project(3, n, self.alpha + k_out, l_out, values, n,
                             extra=Nf + 16)
        out = np.zeros((self.Nr, self.Nr))
        out[nmin:, nmin:] = M
        return out

    def ncc_radial_pair_matrix(self, f_radial_coeffs, f_k, f_lenv, t_in,
                               t_out, ell_in, ell_out, k_out=0):
        """
        (Nr, Nr): multiplication by one angular mode's radial profile
        (Zernike coefficients `f_radial_coeffs` at envelope degree
        `f_lenv`, level k of this basis), mapping regtotal-`t_in`
        components at harmonic `ell_in` to regtotal-`t_out` components at
        harmonic `ell_out`, level `k_out`: the ell-coupled generalization
        of `ncc_radial_matrix` for theta-dependent NCC products
        (reference: the l-coupled Zernike Clenshaw couplings of
        core/basis.py:4101 + core/arithmetic.py:359-406).
        """
        nmin_in = self._nmin(int(ell_in))
        nmin_out = self._nmin(int(ell_out))
        n_in = self.Nr - nmin_in
        n_out = self.Nr - nmin_out
        l_in = int(ell_in) + int(t_in)
        l_out = int(ell_out) + int(t_out)
        if n_in <= 0 or n_out <= 0 or l_in < 0 or l_out < 0:
            return np.zeros((self.Nr, self.Nr))
        f_coeffs = np.asarray(f_radial_coeffs)
        if not np.iscomplexobj(f_coeffs):
            f_coeffs = f_coeffs.astype(np.float64)
        Nf = f_coeffs.shape[-1]

        def values(z):
            fvals = f_coeffs @ zernike.polynomials(3, Nf, self.alpha + f_k,
                                                   int(f_lenv), z)
            return fvals * zernike.polynomials(3, n_in, self.a_k, l_in, z)

        M = zernike._project(3, n_out, self.alpha + k_out, l_out, values,
                             n_in, extra=Nf + self.Nr + 16)
        out = np.zeros((self.Nr, self.Nr), dtype=M.dtype)
        out[nmin_out:, nmin_in:] = M
        return out


# ----------------------------------------------------------------------
# Spherical calculus operators (regularity components, ell-diagonal)

class SphericalEllOperator(LinearOperator):
    """Base for ell-diagonal spherical operators over the shell and ball
    bases (dedalus_tpu/core/spherical3d.py:932; reference:
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
    Index transpose for tensors on shell/ball (regularity-component)
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
    AngularComponent). Interior shell/ball fields store regularity
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
                    "matrix on shell/ball interiors (regularity storage); "
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
