"""
Disk and annulus bases, the spin-weighted circle bases, and the polar
calculus operators (counterpart of dedalus_tpu/core/polar.py; reference:
dedalus/core/basis.py:2305 DiskBasis, :2011 AnnulusBasis, :1798 S1_basis,
and the polar operator subclasses core/operators.py:2878 PolarMOperator,
:3023 PolarGradient etc.). The sphere (core/sphere.py) builds on the same
circle bases and spin operators.

  * Coefficient layout is rectangular (Nphi, Nr). On the disk, slot n of
    azimuthal group m carries Zernike mode (n - nmin(m)), nmin(m) =
    |m|//2 (triangular truncation as validity masking, reference:
    core/basis.py:2368 _nmin); on the annulus every slot is valid.
  * Every m-dependent radial operation (transforms, ladders, conversions)
    is a zero-padded (G, out, in) stack built once on the host and
    applied as one batched product over the m groups
    (curvilinear.apply_group_stack); the annulus radial transform is m-
    and spin-independent, one product along the radius.
  * Coefficient-space tensor components are SPIN components, ordered
    (-, +); the coordinate <-> spin rotation happens inside the transforms
    (reference: core/basis.py:1595 forward_spin_recombination). With a real
    dtype a complex factor acts on each (cos, -sin) azimuth pair as
    Re + Im J (_expand_complex_terms); a complex dtype keeps it complex.
  * Gradient, divergence and Laplacian are spin-ladder compositions
    D_{+-} = (1/sqrt(2))(d/dr -+ (m+s)/r), diagonal in spin, assembled as
    ("gblocks", az, stack) descriptors: on the pencil path one block per m
    group, on the device one batched product over the groups.
"""

import numpy as np

from ..tools.cache import CachedMethod
from ..tools.general import is_complex_dtype
from ..tools import jacobi as jacobi_tools
from ..libraries import zernike
from .basis import Basis, RealFourier, ComplexFourier, AffineCOV
from .coords import PolarCoordinates
from .curvilinear import (PAIR_J, SpinBasisMixin, apply_recombination,
                          component_spins, rotating_components)
from .domain import Domain
from .future import ev
from .operators import LinearOperator
from .weighted_jacobi import WeightedJacobiRadial


class S1SpinTransformMixin:
    """Spin recombination around the parent Fourier transform, shared by
    the real and complex circle bases: it runs after the forward Fourier
    transform and before the backward one (dedalus_tpu/core/polar.py:37;
    reference: core/basis.py:1798 S1_basis)."""

    def _relevant(self, tensorsig):
        """Does any component rotate with the polar system (a polar
        index, or the polar factor of a cylinder's DirectProduct index:
        the JAX package's circle bases miss the latter,
        dedalus_tpu/core/polar.py:41, and store an edge vector of a
        cylinder unrotated)?"""
        return bool(rotating_components(tuple(tensorsig), self.cs).any())

    @property
    def _pair_real(self):
        return not isinstance(self, ComplexFourier)

    def forward_transform(self, gdata, axis, scale, library=None,
                          tensorsig=(), sub_axis=0):
        out = super().forward_transform(gdata, axis, scale, library)
        if self._relevant(tensorsig):
            tdim = len(tensorsig)
            out = apply_recombination(out, tensorsig, self.cs, tdim,
                                      axis - tdim, not self._pair_real,
                                      False)
        return out

    def backward_transform(self, cdata, axis, scale, library=None,
                           tensorsig=(), sub_axis=0):
        out = cdata
        if self._relevant(tensorsig):
            tdim = len(tensorsig)
            out = apply_recombination(out, tensorsig, self.cs, tdim,
                                      axis - tdim, not self._pair_real, True)
        return super().backward_transform(out, axis, scale, library)


class S1Basis(S1SpinTransformMixin, RealFourier):
    """
    Circle basis: the azimuth basis of the disk, annulus and sphere, and
    the disk and annulus edges. Like RealFourier, but tensor components
    over the parent curvilinear coordinate system are stored as spin
    components in coefficient space (reference: core/basis.py:1798
    S1_basis).
    """

    def __init__(self, coord, size, bounds=(0, 2 * np.pi), dealias=1.0,
                 library=None):
        super().__init__(coord, size, bounds=bounds, dealias=dealias,
                         library=library)
        self.cs = coord.cs

    def component_valid_mask(self, tensorsig, group, sep_widths):
        """Spin pairs carry complex data: both m = 0 slots are valid for
        the components that rotate with the polar system; scalars and the
        other components drop the m = 0 minus-sin slot (reference:
        core/basis.py:1123-1133)."""
        tshape = tuple(cs.dim for cs in tensorsig)
        ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
        fixed = ~rotating_components(tuple(tensorsig), self.cs)
        axis = self.first_axis
        if axis in sep_widths:
            mask = np.ones((ncomp, 2), dtype=bool)
            if group[axis] == 0:
                mask[fixed, 1] = False
            return mask
        mask = np.ones((ncomp, self.size), dtype=bool)
        mask[fixed, 1] = False
        return mask


class S1ComplexBasis(S1SpinTransformMixin, ComplexFourier):
    """Complex-dtype circle basis with spin storage for tensors
    (dedalus_tpu/core/polar.py:106)."""

    def __init__(self, coord, size, bounds=(0, 2 * np.pi), dealias=1.0,
                 library=None):
        super().__init__(coord, size, bounds=bounds, dealias=dealias,
                         library=library)
        self.cs = coord.cs


class _PolarBasis(SpinBasisMixin, Basis):
    """The azimuthal structure the disk and the annulus share: Fourier
    (cos, -sin) pairs or complex modes in m groups, the circle edge, the
    constant embedding and the validity of the azimuth slots."""

    dim = 2

    def _init_azimuth(self, coordsystem, shape, dtype, dealias,
                      azimuth_library):
        if np.isscalar(dealias):
            dealias = (dealias, dealias)
        self.coordsystem = self.cs = coordsystem
        self.coord = coordsystem.coords[0]
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.dealias = tuple(map(float, dealias))
        self.Nphi, self.Nr = self.shape
        self.complex = is_complex_dtype(self.dtype)
        S1 = S1ComplexBasis if self.complex else S1Basis
        self.azimuth_basis = S1(coordsystem.azimuth, self.Nphi,
                                dealias=self.dealias[0],
                                library=azimuth_library)
        self.edge = self.azimuth_basis

    @property
    def first_axis(self):
        return self.coordsystem.first_axis

    def coeff_size(self, sub_axis):
        return self.shape[sub_axis]

    def sub_grid_size(self, sub_axis, scale):
        return int(np.ceil(scale * self.shape[sub_axis]))

    def sub_separable(self, sub_axis):
        return sub_axis == 0

    def sub_group_shape(self, sub_axis):
        if sub_axis == 0:
            return 1 if self.complex else 2
        return 1

    def sub_n_groups(self, sub_axis):
        if sub_axis == 0:
            return self.Nphi if self.complex else self.Nphi // 2
        return 1

    @CachedMethod
    def group_m(self):
        """Azimuthal wavenumber per group."""
        if self.complex:
            return np.fft.fftfreq(self.Nphi, d=1.0 / self.Nphi).astype(int)
        return np.arange(self.Nphi // 2)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    def global_grids(self, scales=(1, 1)):
        return (self.azimuth_grid(scales[0]), self.radial_grid(scales[1]))

    def azimuth_grid(self, scale=1.0):
        Ng = self.sub_grid_size(0, scale)
        return 2 * np.pi * np.arange(Ng) / Ng

    def lift_column(self, index):
        col = np.zeros((self.Nr, 1))
        col[index, 0] = 1.0
        return col

    def _azimuth_constant_descr(self, device):
        if device:
            col = np.zeros((self.Nphi, 1))
            col[0, 0] = 1.0
            return ("full", col)
        return ("blocks", self.azimuth_basis.constant_blocks())


class DiskBasis(_PolarBasis):
    """
    Full disk basis: Fourier azimuth x Zernike radius
    (dedalus_tpu/core/polar.py:114; reference: core/basis.py:2305
    DiskBasis).
    """

    def __init__(self, coordsystem, shape, dtype=np.float64, radius=1.0, k=0,
                 alpha=0, dealias=(1, 1), azimuth_library=None,
                 radius_library=None):
        if not isinstance(coordsystem, PolarCoordinates):
            raise ValueError("Disk coordsys must be PolarCoordinates.")
        self._init_azimuth(coordsystem, shape, dtype, dealias,
                           azimuth_library)
        self.radius = float(radius)
        self.k = int(k)
        self.alpha = alpha
        self.volume = np.pi * radius ** 2
        self.radial_COV = AffineCOV((0, 1), (0, radius))
        self.radius_library = radius_library

    def __repr__(self):
        return f"DiskBasis({self.shape}, k={self.k})"

    @property
    def family_key(self):
        return (type(self).__name__, self.shape, self.radius, self.alpha,
                self.dtype)

    @staticmethod
    def _nmin(m):
        return abs(int(m)) // 2

    def clone_with(self, **changes):
        args = dict(coordsystem=self.coordsystem, shape=self.shape,
                    dtype=self.dtype, radius=self.radius, k=self.k,
                    alpha=self.alpha, dealias=self.dealias)
        args.update(changes)
        return DiskBasis(**args)

    def radial_grid(self, scale=1.0):
        Ng = self.sub_grid_size(1, scale)
        z = jacobi_tools.build_grid(Ng, self.alpha, 0)
        return self.radius * np.sqrt((1 + z) / 2)

    # ---------------------------------------------------------- validity

    def component_valid_mask(self, tensorsig, group, sep_widths):
        """(ncomp, gs_az, Nr) at one m group: slot n valid iff n >=
        nmin(m) (reference: core/basis.py:1780). With the azimuth coupled
        (an azimuthally varying NCC, or matrix_coupling), every m group's
        slots live in one flattened (m x r) pencil, group-major:
        (ncomp, G * gs_az, Nr) (dedalus_tpu/core/polar.py:222-254)."""
        tshape = tuple(cs.dim for cs in tensorsig)
        ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
        az_axis = self.first_axis
        groups = ([group[az_axis]] if az_axis in sep_widths
                  else range(self.sub_n_groups(0)))
        return np.concatenate([self._group_valid_mask(tensorsig, ncomp, g)
                               for g in groups], axis=1)

    def _group_valid_mask(self, tensorsig, ncomp, g):
        """(ncomp, gs_az, Nr): the valid slots of m group g."""
        m = self.group_m()[g]
        mask = np.ones((ncomp, self.sub_group_shape(0), self.Nr), dtype=bool)
        mask &= (np.arange(self.Nr) >= self._nmin(m))[None, None, :]
        if self.complex and g == self.Nphi // 2:
            mask[:] = False  # Nyquist
        if (not self.complex) and m == 0:
            # the minus-sin slot of m = 0 for scalars and components that
            # do not rotate (S1Basis.component_valid_mask)
            mask[~rotating_components(tuple(tensorsig), self.cs), 1, :] = \
                False
        return mask

    # ------------------------------------------------- radial matrix stacks

    def _build_stack(self, build, rows, cols, align_rows=True,
                     align_cols=True):
        """Assemble a (G, rows, cols) stack from the per-m function
        `build(m, nmodes) -> (r, c)`; slot dimensions (align_*=True) are
        right-aligned at nmin(m), grid/point dimensions are not."""
        ms = self.group_m()
        out = np.zeros((len(ms), rows, cols))
        for g, m in enumerate(ms):
            if self.complex and g == self.Nphi // 2:
                continue  # Nyquist
            nmin = self._nmin(m)
            n = self.Nr - nmin
            if n <= 0:
                continue
            mat = build(int(m), n)
            r0 = nmin if align_rows else 0
            c0 = nmin if align_cols else 0
            out[g, r0:r0 + mat.shape[0], c0:c0 + mat.shape[1]] = mat
        return out

    @CachedMethod
    def radial_forward_stack(self, s, scale=1.0):
        """(G, Nr, Ngr): grid values -> right-aligned Zernike coefficients.
        Modes beyond the grid's quadrature exactness (the top |m+s|//2 per
        group) are zeroed, as are groups with |m| > 2(Nr-1)
        (reference: core/transforms.py:1408-1417)."""
        Ngr = self.sub_grid_size(1, scale)
        z = jacobi_tools.build_grid(Ngr, self.alpha, 0)
        _, w = zernike.quadrature(2, Ngr, self.alpha)
        extra = (1 - (1 + z) / 2) ** (self.k - self.alpha) \
            if self.k != self.alpha else 1.0

        def build(m, n):
            if abs(m) > 2 * (self.Nr - 1):
                return np.zeros((n, Ngr))
            Q = zernike.polynomials(2, n, self.k, abs(m + s), z)
            Q = Q * w * extra
            dN = abs(m + s) // 2
            Q[max(Ngr - dN, 0):] = 0
            return Q
        return self._build_stack(build, self.Nr, Ngr, align_cols=False)

    @CachedMethod
    def radial_backward_stack(self, s, scale=1.0):
        """(G, Ngr, Nr): coefficients -> grid values (top modes zeroed to
        mirror the forward truncation)."""
        Ngr = self.sub_grid_size(1, scale)
        z = jacobi_tools.build_grid(Ngr, self.alpha, 0)

        def build(m, n):
            if abs(m) > 2 * (self.Nr - 1):
                return np.zeros((Ngr, n))
            Q = zernike.polynomials(2, n, self.k, abs(m + s), z)
            dN = abs(m + s) // 2
            Q[max(Ngr - dN, 0):] = 0
            return Q.T
        return self._build_stack(build, Ngr, self.Nr, align_rows=False)

    @CachedMethod
    def ladder_stack(self, s, ds):
        """(G, Nr, Nr): D_{ds} on spin-s components, k -> k+1, in problem
        radius units."""
        def build(m, n):
            mu = m + s
            return zernike.ladder_matrix(2, n, self.k, abs(mu), abs(mu + ds),
                                         mu, ds) / self.radius
        return self._build_stack(build, self.Nr, self.Nr)

    @CachedMethod
    def conversion_stack(self, s, dk):
        """(G, Nr, Nr): k -> k+dk conversion on spin-s components."""
        if dk == 0:
            return np.tile(np.eye(self.Nr), (len(self.group_m()), 1, 1))

        def build(m, n):
            return zernike.conversion_matrix(2, n, self.k, abs(m + s), dk)
        return self._build_stack(build, self.Nr, self.Nr)

    @CachedMethod
    def laplacian_stack(self, s):
        """(G, Nr, Nr): spin-weighted Laplacian, k -> k+2."""
        up = self.ladder_stack(s, +1)
        down = self.clone_with(k=self.k + 1).ladder_stack(s + 1, -1)
        return 2 * np.einsum("gij,gjk->gik", down, up)

    @CachedMethod
    def interpolation_stack(self, s, position):
        """(G, 1, Nr): evaluate spin-s components at problem radius
        `position`."""
        r0 = self.radial_COV.native_coord(position)

        def build(m, n):
            return zernike.interpolation_row(2, n, self.k, abs(m + s), r0)
        return self._build_stack(build, 1, self.Nr, align_rows=False)

    @CachedMethod
    def integration_row(self):
        """(1, Nr) radial integral against r dr for the m=0, s=0 group, in
        problem units (x radius^2)."""
        row = np.zeros((1, self.Nr))
        row[:, :] = zernike.integration_row(2, self.Nr, self.k, 0)
        return row * self.radius ** 2

    def constant_component_descr(self, sub_axis, device):
        """Descriptor embedding a constant into this basis along one of its
        axes: the m=0 slot on the azimuth; on the radius 1 = c Q_0^{(k,0)}
        (the lowest mode is constant in r)."""
        if sub_axis == 0:
            return self._azimuth_constant_descr(device)
        Q0 = zernike.polynomials(2, 1, self.k, 0, np.array([0.0]))[0, 0]
        col = np.zeros((self.Nr, 1))
        col[0, 0] = 1.0 / Q0
        return ("full", col)

    def conversion_terms(self, target, tensorsig, tshape):
        """Terms converting coefficients into `target` (same family, higher
        k): [(tensor_selector, {abs_axis: descr})], one per spin."""
        if not isinstance(target, DiskBasis) or target.shape != self.shape \
                or target.radius != self.radius:
            raise ValueError(f"No conversion from {self} to {target}.")
        dk = target.k - self.k
        if dk == 0:
            return [(None, {})]
        if dk < 0:
            raise ValueError("Cannot convert to lower k.")
        az_axis = self.first_axis
        spins = component_spins(tensorsig, self.cs)
        terms = []
        for s in np.unique(spins):
            sel = np.diag((spins == s).astype(float))
            descr = {az_axis + 1: ("gblocks", az_axis,
                                   self.conversion_stack(int(s), dk))}
            terms.append((sel if len(spins) > 1 else None, descr))
        return terms


class AnnulusBasis(WeightedJacobiRadial, _PolarBasis):
    """
    Annulus basis: Fourier azimuth x weighted-Jacobi radius on [Ri, Ro]
    (dedalus_tpu/core/polar.py:411; reference: dedalus/core/basis.py:2011
    AnnulusBasis and the shell radial operator algebra
    dedalus/libraries/dedalus_sphere/shell.py).

    Level-k fields carry a hidden (dR/r)^k grid prefactor, so the spin
    ladders map level k to level k+1 with polynomial-exact matrices
    (core/weighted_jacobi.py). Every per-m radial operator is A - ds*(m+s)*B
    with m-independent A, B, and the radial transform is one product
    along the radius.
    """

    radial_sub_axis = 1

    def __init__(self, coordsystem, shape, dtype=np.float64, radii=(1.0, 2.0),
                 k=0, alpha=(-0.5, -0.5), dealias=(1, 1), azimuth_library=None,
                 radius_library=None):
        if not isinstance(coordsystem, PolarCoordinates):
            raise ValueError("Annulus coordsys must be PolarCoordinates.")
        radii = tuple(map(float, radii))
        if min(radii) <= 0:
            raise ValueError("Annulus radii must be positive.")
        if radii[0] >= radii[1]:
            raise ValueError("Annulus radii must be increasing.")
        self._init_azimuth(coordsystem, shape, dtype, dealias,
                           azimuth_library)
        self.radii = radii
        self.k = int(k)
        if np.isscalar(alpha):
            alpha = (alpha, alpha)
        self.alpha = tuple(map(float, alpha))
        self.volume = np.pi * (radii[1] ** 2 - radii[0] ** 2)
        self.dR = radii[1] - radii[0]
        self.rho = (radii[1] + radii[0]) / self.dR
        self.radial_COV = AffineCOV((-1.0, 1.0), radii)
        self.inner_edge = self.outer_edge = self.edge
        self.radius_library = radius_library

    def __repr__(self):
        return f"AnnulusBasis({self.shape}, radii={self.radii}, k={self.k})"

    @property
    def family_key(self):
        return (type(self).__name__, self.shape, self.radii, self.alpha,
                self.dtype)

    def clone_with(self, **changes):
        args = dict(coordsystem=self.coordsystem, shape=self.shape,
                    dtype=self.dtype, radii=self.radii, k=self.k,
                    alpha=self.alpha, dealias=self.dealias)
        args.update(changes)
        return AnnulusBasis(**args)

    # ---------------------------------------------------------- validity

    def component_valid_mask(self, tensorsig, group, sep_widths):
        """(ncomp, gs_az, Nr) at one m group: every radial slot is valid
        (reference: core/basis.py:2089 _nmin = 0). With the azimuth
        coupled, (ncomp, G * gs_az, Nr) over the flattened (m x r) pencil
        (dedalus_tpu/core/polar.py:532-552)."""
        tshape = tuple(cs.dim for cs in tensorsig)
        ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
        az_axis = self.first_axis
        groups = ([group[az_axis]] if az_axis in sep_widths
                  else range(self.sub_n_groups(0)))
        return np.concatenate([self._group_valid_mask(tensorsig, ncomp, g)
                               for g in groups], axis=1)

    def _group_valid_mask(self, tensorsig, ncomp, g):
        """(ncomp, gs_az, Nr): the valid slots of m group g."""
        mask = np.ones((ncomp, self.sub_group_shape(0), self.Nr), dtype=bool)
        if self.complex and g == self.Nphi // 2:
            mask[:] = False  # Nyquist
        if (not self.complex) and self.group_m()[g] == 0:
            # as on the disk (DiskBasis._group_valid_mask)
            mask[~rotating_components(tuple(tensorsig), self.cs), 1, :] = \
                False
        return mask

    # -------------------------------------------------- radial transforms

    def _radial_apply(self, data, tdim, az_axis, r_axis, spins, scale,
                      forward):
        """The annulus radial transform is m- and spin-independent: one
        product along the radial axis."""
        return self._radial_matmul(data, r_axis, scale, forward)

    # ------------------------------------------------- radial matrix stacks

    def _tile(self, M):
        """Tile an m-independent matrix over the azimuthal groups, zeroing
        the complex Nyquist group."""
        out = np.tile(M, (self.sub_n_groups(0), 1, 1))
        if self.complex:
            out[self.Nphi // 2] = 0.0
        return out

    @CachedMethod
    def ladder_stack(self, s, ds):
        """(G, Nr, Nr): D_{ds} on spin-s components, k -> k+1, in problem
        radius units."""
        A, B = self._ladder_parts()
        mu = (self.group_m() + s).astype(np.float64)
        stack = (A[None] - ds * mu[:, None, None] * B[None]) \
            / (np.sqrt(2) * self.dR)
        if self.complex:
            stack = stack.copy()
            stack[self.Nphi // 2] = 0.0
        return stack

    @CachedMethod
    def laplacian_stack(self, s):
        """(G, Nr, Nr): spin-weighted Laplacian, k -> k+2."""
        up = self.ladder_stack(s, +1)
        down = self.clone_with(k=self.k + 1).ladder_stack(s + 1, -1)
        return 2 * np.einsum("gij,gjk->gik", down, up)

    @CachedMethod
    def interpolation_stack(self, s, position):
        """(G, 1, Nr): evaluate spin-s components at problem radius
        `position`."""
        return self._tile(self.radial_interpolation_row(position))

    @CachedMethod
    def integration_row(self):
        """(1, Nr): radial integral against r dr for the (m=0, s=0) group,
        in problem units."""
        return self.radial_integration_row(power=1)

    def constant_component_descr(self, sub_axis, device):
        """Descriptor embedding a constant into this basis along one of its
        axes."""
        if sub_axis == 0:
            return self._azimuth_constant_descr(device)
        return ("full", self.radial_constant_column())

    def conversion_terms(self, target, tensorsig, tshape):
        """Terms converting coefficients into `target` (same family, higher
        k). Spin-independent: a single full radial matrix."""
        if not isinstance(target, AnnulusBasis) or target.shape != self.shape \
                or target.radii != self.radii:
            raise ValueError(f"No conversion from {self} to {target}.")
        dk = target.k - self.k
        if dk == 0:
            return [(None, {})]
        if dk < 0:
            raise ValueError("Cannot convert to lower k.")
        r_axis = self.first_axis + 1
        return [(None, {r_axis: ("full", self._conversion_matrix_total(dk))})]


# ======================================================================
# Polar calculus operators
# (reference: dedalus/core/operators.py:2878 PolarMOperator family)

def _tile_J(G):
    return np.tile(PAIR_J, (G, 1, 1))


def _expand_complex_terms(terms, az_axis, G, complex_dtype):
    """
    Convert terms with complex tensor factors to the dtype's representation
    (dedalus_tpu/core/polar.py:657): a complex dtype keeps them; a real
    dtype splits C into Re(C) + Im(C) * J, with J the per-m-pair rotation
    on the azimuth axis.
    """
    out = []
    for factor, descrs in terms:
        if factor is None or not np.iscomplexobj(factor) or complex_dtype:
            out.append((factor, descrs))
            continue
        if np.any(factor.real):
            out.append((factor.real, descrs))
        if np.any(factor.imag):
            descrs_J = list(descrs)
            if descrs_J[az_axis] is not None:
                kind, blocks = descrs_J[az_axis]
                assert kind == "blocks"
                descrs_J[az_axis] = ("blocks", np.einsum(
                    "gij,gjk->gik", _tile_J(G), blocks))
            else:
                descrs_J[az_axis] = ("blocks", _tile_J(G))
            out.append((factor.imag, descrs_J))
    return out


class PolarSpinOperator(LinearOperator):
    """Base for spin-structured operators over a spin-weighted basis
    (disk, annulus, sphere: any SpinBasisMixin basis exposing the stack
    interface)."""

    def _basis(self, operand=None):
        operand = operand or self.operand
        for b in operand.domain.bases:
            if isinstance(b, SpinBasisMixin):
                return b
        raise ValueError("Operand has no spin-weighted basis.")

    def _axes(self, basis):
        az = basis.first_axis
        return az, az + 1

    def _per_spin_terms(self, stack_fn):
        """One term per distinct spin s of the operand: the components of
        spin s through stack_fn(basis, s) along the coupled axis (a
        spin-diagonal operator)."""
        operand = self.operand
        basis = self._basis(operand)
        az, coupled = self._axes(basis)
        spins = component_spins(operand.tensorsig, basis.cs)
        ncomp = len(spins)
        terms = []
        for s in np.unique(spins):
            sel = np.diag((spins == s).astype(float)) if ncomp > 1 else None
            descrs = [None] * operand.domain.dim
            descrs[coupled] = ("gblocks", az, stack_fn(basis, int(s)))
            terms.append((sel, descrs))
        return terms


class PolarGradient(PolarSpinOperator):
    """Covariant gradient: prepends a spin index; spin-s components map
    through D_{+-} ladders, k -> k+1 (reference: core/operators.py:3023
    PolarGradient)."""

    name = "Grad"

    def __init__(self, operand, cs):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return PolarGradient(new_args[0], self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        basis = self._basis(operand)
        self.domain = operand.domain.substitute_basis(
            basis, basis.derivative_basis(1))
        self.tensorsig = (self.cs,) + tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, coupled = self._axes(basis)
        spins = component_spins(operand.tensorsig, basis.cs)
        ncomp = len(spins)
        terms = []
        for sigma, ds in ((0, -1), (1, +1)):
            for s in np.unique(spins):
                sel = np.zeros((2 * ncomp, ncomp))
                for c in np.flatnonzero(spins == s):
                    sel[sigma * ncomp + c, c] = 1.0
                descrs = [None] * operand.domain.dim
                descrs[coupled] = ("gblocks", az,
                                   basis.ladder_stack(int(s), ds))
                terms.append((sel, descrs))
        return terms


class PolarDivergence(PolarSpinOperator):
    """div u = D_+ u_- + D_- u_+ (contraction of the leading spin index)
    (reference: core/operators.py:3385 Divergence)."""

    name = "Div"

    def __init__(self, operand, index=0):
        if index != 0:
            raise NotImplementedError("Divergence only supports index=0.")
        self.cs = operand.tensorsig[0]
        super().__init__(operand)

    def rebuild(self, new_args):
        return PolarDivergence(new_args[0])

    def _build_metadata(self):
        operand = self.args[0]
        basis = self._basis(operand)
        self.domain = operand.domain.substitute_basis(
            basis, basis.derivative_basis(1))
        self.tensorsig = tuple(operand.tensorsig[1:])
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, coupled = self._axes(basis)
        rest_spins = component_spins(operand.tensorsig[1:], basis.cs)
        nrest = len(rest_spins)
        terms = []
        for sigma, sspin in ((0, -1), (1, +1)):
            for sr in np.unique(rest_spins):
                sel = np.zeros((nrest, 2 * nrest))
                for c in np.flatnonzero(rest_spins == sr):
                    sel[c, sigma * nrest + c] = 1.0
                stack = basis.ladder_stack(int(sspin + sr), -sspin)
                descrs = [None] * operand.domain.dim
                descrs[coupled] = ("gblocks", az, stack)
                terms.append((sel, descrs))
        return terms


class PolarLaplacian(PolarSpinOperator):
    """Spin-weighted Laplacian, diagonal over spin components, k -> k+2
    (reference: core/operators.py:3952 Laplacian)."""

    name = "Lap"

    def __init__(self, operand, cs=None):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return PolarLaplacian(new_args[0], self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        basis = self._basis(operand)
        self.domain = operand.domain.substitute_basis(
            basis, basis.derivative_basis(2))
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        return self._per_spin_terms(lambda b, s: b.laplacian_stack(s))


class PolarInterpolate(PolarSpinOperator):
    """Radial interpolation onto the circle at `position` (the edge basis)
    (reference: core/operators.py:1037 Interpolate)."""

    name = "interp"

    def __init__(self, operand, position):
        self.position = position
        super().__init__(operand)

    def rebuild(self, new_args):
        return PolarInterpolate(new_args[0], self.position)

    def _build_metadata(self):
        operand = self.args[0]
        basis = self._basis(operand)
        az, rad = self._axes(basis)
        bases = list(operand.domain.bases)
        bases[az] = basis.azimuth_basis
        bases[rad] = None
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        return self._per_spin_terms(
            lambda b, s: b.interpolation_stack(s, self.position))


class PolarIntegrate(PolarSpinOperator):
    """Integral of a scalar over the curvilinear basis
    (reference: core/operators.py:1120)."""

    name = "integ"

    def _build_metadata(self):
        operand = self.args[0]
        if operand.tensorsig:
            raise NotImplementedError("Integration of tensors over a "
                                      "curvilinear basis is not supported.")
        basis = self._basis(operand)
        az, coupled = self._axes(basis)
        bases = list(operand.domain.bases)
        bases[az] = None
        bases[coupled] = None
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = ()
        self.dtype = operand.dtype

    def terms(self):
        basis = self._basis(self.operand)
        az, coupled = self._axes(basis)
        G = basis.sub_n_groups(0)
        gs = basis.sub_group_shape(0)
        az_blocks = np.zeros((G, gs, gs))
        az_blocks[0, 0, 0] = 2 * np.pi
        descrs = [None] * self.operand.domain.dim
        descrs[az] = ("blocks", az_blocks)
        descrs[coupled] = ("full", basis.integration_row())
        return [(None, descrs)]

    def device_terms(self):
        basis = self._basis(self.operand)
        az, coupled = self._axes(basis)
        row = np.zeros((1, basis.Nphi))
        row[0, 0] = 2 * np.pi
        descrs = [None] * self.operand.domain.dim
        descrs[az] = ("full", row)
        descrs[coupled] = ("full", basis.integration_row())
        return [(None, descrs)]


class PolarLift(PolarSpinOperator):
    """Lift an edge (S1) tau field into the disk or annulus via radial
    mode `n` (reference: core/operators.py:4228 Lift)."""

    name = "Lift"

    def __init__(self, operand, basis, n):
        self.basis = basis
        self.n = n
        super().__init__(operand)

    def rebuild(self, new_args):
        return PolarLift(new_args[0], self.basis, self.n)

    def _basis(self, operand=None):
        return self.basis

    def _build_metadata(self):
        operand = self.args[0]
        az, rad = self._axes(self.basis)
        if operand.domain.bases[rad] is not None:
            raise ValueError("Lift operand must be constant along the radius.")
        bases = list(operand.domain.bases)
        bases[az] = self.basis
        bases[rad] = self.basis
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        az, rad = self._axes(self.basis)
        index = self.n if self.n >= 0 else self.basis.Nr + self.n
        descrs = [None] * self.operand.domain.dim
        descrs[rad] = ("full", self.basis.lift_column(index))
        return [(None, descrs)]


class PolarSkew(PolarSpinOperator):
    """skew(u) = z x u: multiplies spin-sigma components by +i*sigma
    ((z x u)_s = (-u_phi + s i u_r)/sqrt(2) = s i u_s;
    reference: core/operators.py:2019 Skew)."""

    name = "Skew"

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        spins = component_spins(operand.tensorsig, basis.cs)
        factor = np.diag(+1j * spins).astype(complex)
        raw = [(factor, [None] * operand.domain.dim)]
        return _expand_complex_terms(raw, basis.first_axis,
                                     basis.sub_n_groups(0), basis.complex)


class SpinTrace(PolarSpinOperator):
    """Trace of the two leading indices in 2D spin components: the spin
    metric contracts (-,+) and (+,-) (reference: core/operators.py:1693
    Trace with spin storage)."""

    name = "Trace"
    natural_layout = "g"

    def _build_metadata(self):
        operand = self.args[0]
        if len(operand.tensorsig) < 2 \
                or operand.tensorsig[0] != operand.tensorsig[1]:
            raise ValueError("Trace requires two equal leading indices.")
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig[2:])
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        rest = int(np.prod(operand.tshape[2:], dtype=int)) \
            if operand.tshape[2:] else 1
        # spin ordering (-, +): metric pairs (-,+) and (+,-)
        row = np.array([[0.0, 1.0, 1.0, 0.0]])
        return [(np.kron(row, np.identity(rest)),
                 [None] * operand.domain.dim)]

    def ev_impl(self, ctx):
        data = ev(self.operand, ctx, "g")
        return data[0, 0] + data[1, 1]


class PolarComponent(LinearOperator):
    """
    The radial or azimuthal coordinate component of the leading index
    (reference: core/operators.py:2160-2283 Component/Radial/Azimuthal).

    On the disk interior this is a grid-space selection (the coordinate
    component of a smooth vector is not a regular scalar there, so there
    is no coefficient-space matrix). On the annulus and on edge (S1)
    fields, where spin pairs store the rotated components, a coefficient
    matrix exists and the operator can appear on an equation's LHS
    (e.g. radial(u(r=R)) = 0).
    """

    name = "Comp"
    natural_layout = "g"

    def __init__(self, operand, which, index=0):
        self.which = which  # 'radial' | 'azimuthal'
        self.index = int(index)
        self.comp_index = {"azimuthal": 0, "radial": 1}[which]
        super().__init__(operand)

    def rebuild(self, new_args):
        return PolarComponent(new_args[0], self.which, self.index)

    def _build_metadata(self):
        operand = self.args[0]
        self.cs = operand.tensorsig[self.index]
        ts = list(operand.tensorsig)
        ts.pop(self.index)
        self.domain = operand.domain
        self.tensorsig = tuple(ts)
        self.dtype = operand.dtype

    def ev_impl(self, ctx):
        data = ev(self.operand, ctx, "g")
        return data[(slice(None),) * self.index + (self.comp_index,)]

    def terms(self):
        operand = self.operand
        az_basis = None
        for b in operand.domain.bases:
            if isinstance(b, AnnulusBasis):
                # no coordinate singularity: the pointwise spin->coordinate
                # rotation is a valid coefficient-space operation
                az_basis = b.azimuth_basis
            elif isinstance(b, SpinBasisMixin):
                raise ValueError(
                    "Component extraction has no coefficient matrix on the "
                    f"interior of {b!r} (coordinate components of smooth "
                    "tensors are not regular there); apply it to edge fields "
                    "or on the RHS.")
            elif isinstance(b, (S1Basis, S1ComplexBasis)):
                az_basis = b
        if az_basis is None:
            raise ValueError("Component extraction needs an S1/polar basis.")
        # spin storage (-, +): u_r = (u_- + u_+)/sqrt(2);
        # u_phi = (i u_- - i u_+)/sqrt(2)
        before = int(np.prod(operand.tshape[:self.index], dtype=int)) \
            if operand.tshape[:self.index] else 1
        after = int(np.prod(operand.tshape[self.index + 1:], dtype=int)) \
            if operand.tshape[self.index + 1:] else 1
        if self.which == "radial":
            row = np.array([[1.0, 1.0]]) / np.sqrt(2)
        else:
            row = np.array([[1j, -1j]]) / np.sqrt(2)
        factor = np.kron(np.identity(before), np.kron(row, np.identity(after)))
        raw = [(factor, [None] * operand.domain.dim)]
        return _expand_complex_terms(raw, az_basis.first_axis,
                                     az_basis.n_groups,
                                     isinstance(az_basis, S1ComplexBasis))
