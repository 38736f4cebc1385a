"""
Sphere (S2) basis: Fourier azimuth x spin-weighted spherical harmonic
colatitude (counterpart of dedalus_tpu/core/sphere.py; reference:
dedalus/core/basis.py:2672 SphereBasis and the SWSH colatitude transform
core/transforms.py:1252 SWSHColatitudeTransform).

  * Coefficient layout is rectangular (Nphi, Ntheta) with slot l of
    azimuthal group (m, spin s) carrying harmonic degree l; slots
    l < lmin(m, s) = max(|m|, |s|) are invalid (triangular truncation as
    validity masking, reference: core/basis.py:2770 valid ell >=
    max(|m|,|s|)).
  * All m- and spin-dependent colatitude operations are zero-padded stacks
    (G, out, in) applied as ONE batched matmul over the m groups; each
    stack is built once on the host (cached on the basis) and uploaded to
    the device once.
  * Tensor components are SPIN components in coefficient space; the
    coordinate<->spin rotation happens inside the transforms.
  * Operators are SWSH ladder compositions: D_{+-} maps spin s -> s +- 1
    and is diagonal in l; the spin-weighted Laplacian is diagonal with
    eigenvalues -(l(l+1) - s^2)/r^2.

The port carries real-dtype spheres, standalone (a 2-D problem, the
colatitude coupled) and as the boundary bases of a shell
(`ell_separable`: every operator of a 3-D spherical problem is diagonal
in ell, so the colatitude is a group axis there); complex-dtype spheres
are not carried yet.
"""

import numpy as np

from ..tools.cache import CachedMethod
from ..libraries import sphere as swsh
from .basis import Basis
from .coords import S2Coordinates, SphericalCoordinates
from .curvilinear import SpinBasisMixin, component_spins
from .polar import S1Basis, PolarSpinOperator
from ..tools.general import is_complex_dtype


class SphereBasis(SpinBasisMixin, Basis):
    """
    Two-sphere basis: Fourier azimuth x SWSH colatitude
    (dedalus_tpu/core/sphere.py:35; reference: core/basis.py:2672
    SphereBasis).
    """

    dim = 2

    def __init__(self, coordsystem, shape, dtype=np.float64, radius=1.0,
                 dealias=(1, 1), ell_separable=False):
        if isinstance(coordsystem, SphericalCoordinates):
            coordsystem = coordsystem.S2coordsys
        if not isinstance(coordsystem, S2Coordinates):
            raise ValueError("Sphere coordsys must be S2Coordinates.")
        if is_complex_dtype(dtype):
            raise NotImplementedError(
                "Complex-dtype spheres are not carried by the port yet.")
        self.coordsystem = self.cs = coordsystem
        self.coord = coordsystem.coords[0]
        # separability of the colatitude is a property of the problem: a
        # standalone sphere couples ell (MulCosine), a shell's boundary
        # sphere sits in an ell-diagonal 3-D problem
        # (dedalus_tpu/core/sphere.py:49)
        self.ell_separable = bool(ell_separable)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.radius = float(radius)
        if np.isscalar(dealias):
            dealias = (dealias, dealias)
        self.dealias = tuple(map(float, dealias))
        self.volume = 4 * np.pi * radius ** 2
        Nphi, Ntheta = self.shape
        self.Nphi, self.Ntheta = Nphi, Ntheta
        self.Lmax = Ntheta - 1
        self.azimuth_basis = S1Basis(coordsystem.azimuth, Nphi,
                                     dealias=self.dealias[0])

    def __repr__(self):
        return f"SphereBasis({self.shape}, radius={self.radius})"

    # ------------------------------------------------------------ structure

    @property
    def first_axis(self):
        return self.coordsystem.first_axis

    def coeff_size(self, sub_axis):
        return self.shape[sub_axis]

    def sub_grid_size(self, sub_axis, scale):
        return int(np.ceil(scale * self.shape[sub_axis]))

    def sub_separable(self, sub_axis):
        # the azimuth splits into m groups; the colatitude into ell groups
        # only inside a 3-D spherical problem (MulCosine couples ell)
        return sub_axis == 0 or self.ell_separable

    def sub_group_shape(self, sub_axis):
        return 2 if sub_axis == 0 else 1

    def sub_n_groups(self, sub_axis):
        if sub_axis == 0:
            return self.Nphi // 2
        return self.Ntheta if self.ell_separable else 1

    @CachedMethod
    def group_m(self):
        """Azimuthal wavenumber per group."""
        return np.arange(self.Nphi // 2)

    @staticmethod
    def _lmin(m, s):
        return max(abs(int(m)), abs(int(s)))

    def derivative_basis(self, order=1):
        # SWSH ladders stay within the basis (no Jacobi k-ladder).
        return self

    # --------------------------------------------------------------- grids

    def global_grids(self, scales=(1, 1)):
        return (self.azimuth_grid(scales[0]), self.colatitude_grid(scales[1]))

    def azimuth_grid(self, scale=1.0):
        Ng = self.sub_grid_size(0, scale)
        return 2 * np.pi * np.arange(Ng) / Ng

    def colatitude_grid(self, scale=1.0):
        """theta = arccos(z) at the Gauss-Legendre nodes (z ascending, so
        theta descends from pi to 0)."""
        Ng = self.sub_grid_size(1, scale)
        z, _ = swsh.quadrature(Ng - 1)
        return np.arccos(z)

    # ---------------------------------------------------------- validity

    def component_valid_mask(self, tensorsig, group, sep_widths):
        """(ncomp, 2, Ntheta) at one m group, or (ncomp, 2, 1) at one
        (m, ell) group when the colatitude is a group axis: slot l valid
        iff l >= lmin(m, s_component) (reference: core/basis.py:2770)."""
        spins = component_spins(tensorsig, self.cs)
        az_axis = self.first_axis
        colat_axis = az_axis + 1
        if az_axis not in sep_widths:
            raise NotImplementedError("Sphere azimuth must be a pencil axis.")
        m = self.group_m()[group[az_axis]]
        if colat_axis in sep_widths:
            ells = np.array([group[colat_axis]])
        else:
            ells = np.arange(self.Ntheta)
        mask = np.ones((len(spins), 2, ells.size), dtype=bool)
        for c, s in enumerate(spins):
            mask[c] &= (ells >= self._lmin(m, s))[None, :]
        if len(tensorsig) <= 1:
            # Drop msin slots at ell == 0 for real scalars and vectors; m == 0
            # symmetry is NOT imposed at ell > 0 (reference: core/basis.py:3206)
            mask[:, 1, ells == 0] = False
        return mask

    # ------------------------------------------- colatitude matrix stacks

    def _build_stack(self, build, rows, cols, row_off=None, col_off=None):
        """Assemble a (G, rows, cols) stack from the per-m builder
        `build(m) -> (r, c)`; `row_off(m)` / `col_off(m)` give the slot
        alignment offsets (None = 0, for grid/point dimensions)."""
        ms = self.group_m()
        out = np.zeros((len(ms), rows, cols))
        for g, m in enumerate(ms):
            if abs(m) > self.Lmax:
                continue  # no valid degrees at this m
            mat = build(int(m))
            if mat.size == 0:
                continue
            r0 = row_off(int(m)) if row_off else 0
            c0 = col_off(int(m)) if col_off else 0
            nr = min(mat.shape[0], rows - r0)
            nc = min(mat.shape[1], cols - c0)
            out[g, r0:r0 + nr, c0:c0 + nc] = mat[:nr, :nc]
        return out

    @CachedMethod
    def radial_forward_stack(self, s, scale=1.0):
        """(G, Ntheta, Ng): colatitude grid values -> aligned SWSH
        coefficients for spin s (reference: core/transforms.py:1252)."""
        Ng = self.sub_grid_size(1, scale)
        return self._build_stack(
            lambda m: swsh.forward_matrix(self.Lmax, m, s, Ng),
            self.Ntheta, Ng, row_off=lambda m: self._lmin(m, s))

    @CachedMethod
    def radial_backward_stack(self, s, scale=1.0):
        """(G, Ng, Ntheta): SWSH coefficients -> colatitude grid values."""
        Ng = self.sub_grid_size(1, scale)
        return self._build_stack(
            lambda m: swsh.backward_matrix(self.Lmax, m, s, Ng),
            Ng, self.Ntheta, col_off=lambda m: self._lmin(m, s))

    @CachedMethod
    def ladder_stack(self, s, ds):
        """(G, Ntheta, Ntheta): D_{ds} on spin-s components, in problem
        radius units (diagonal in l)."""
        return self._build_stack(
            lambda m: swsh.ladder_matrix(self.Lmax, m, s, ds) / self.radius,
            self.Ntheta, self.Ntheta,
            row_off=lambda m: self._lmin(m, s + ds),
            col_off=lambda m: self._lmin(m, s))

    @CachedMethod
    def laplacian_stack(self, s):
        """(G, Ntheta, Ntheta): spin-weighted Laplacian, diagonal with
        eigenvalues -(l(l+1) - s^2)/r^2."""
        ell = np.arange(self.Ntheta)
        eig = -(ell * (ell + 1) - s ** 2) / self.radius ** 2
        ms = self.group_m()
        out = np.zeros((len(ms), self.Ntheta, self.Ntheta))
        for g, m in enumerate(ms):
            lm = self._lmin(m, s)
            out[g, lm:, lm:] = np.diag(eig[lm:])
        return out

    @CachedMethod
    def cos_stack(self, s):
        """(G, Ntheta, Ntheta): multiplication by cos(theta) on spin-s
        components (tridiagonal in l; reference: core/operators.py:2695
        SeparableSphereOperator)."""
        return self._build_stack(
            lambda m: swsh.cos_matrix(self.Lmax, m, s),
            self.Ntheta, self.Ntheta,
            row_off=lambda m: self._lmin(m, s),
            col_off=lambda m: self._lmin(m, s))

    @CachedMethod
    def integration_row(self):
        """(1, Ntheta): integral against dz = sin(theta) dtheta for the
        (m=0, s=0) group, in problem units (x radius^2)."""
        z, w = swsh.quadrature(self.Lmax)
        Y = swsh.harmonics(self.Lmax, 0, 0, z)  # (Ntheta, Nz)
        row = (Y @ w)[None, :]
        return row * self.radius ** 2

    def constant_component_descr(self, sub_axis, device):
        """Descriptor embedding a constant into this basis along one of its
        axes (reference: core/basis.py constant-mode conversions)."""
        if sub_axis == 0:
            if device:
                col = np.zeros((self.Nphi, 1))
                col[0, 0] = 1.0
                return ("full", col)
            return ("blocks", self.azimuth_basis.constant_blocks())
        # colatitude: 1 = c * Y_00 with Y_00 the lowest harmonic
        Y00 = swsh.harmonics(self.Lmax, 0, 0, np.array([0.5]))[0, 0]
        col = np.zeros((self.Ntheta, 1))
        col[0, 0] = 1.0 / Y00
        return ("full", col)

    def conversion_terms(self, target, tensorsig, tshape):
        """Sphere -> sphere conversion is the identity (no k ladder), and
        only onto a sphere of the same shape and radius."""
        if not isinstance(target, SphereBasis) or target.shape != self.shape \
                or target.radius != self.radius:
            raise ValueError(f"No conversion from {self} to {target}.")
        return [(None, {})]


class MulCosine(PolarSpinOperator):
    """
    Multiplication by cos(theta) — a sparse (tridiagonal-in-l) separable
    sphere operator usable on equation LHS, e.g. Coriolis terms
    zcross(u) = MulCosine(skew(u)) (dedalus_tpu/core/sphere.py:319;
    reference: core/operators.py:2695 SeparableSphereOperator; the sphere
    shallow-water example's zcross).
    """

    name = "MulCos"

    def __init__(self, operand, cs=None):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return MulCosine(new_args[0], self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        if not isinstance(self._basis(operand), SphereBasis):
            raise ValueError("MulCosine requires a sphere basis.")
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        return self._per_spin_terms(lambda b, s: b.cos_stack(s))
