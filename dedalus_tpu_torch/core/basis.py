"""
Spectral bases (counterpart of dedalus_tpu/core/basis.py: the Jacobi and
RealFourier interval bases).

A basis owns: metadata (size, bounds, dealias), the affine change-of-variables
to its native interval, transform-plan dispatch, group/pair structure along
separable axes, validity masks, and the per-operator matrix builders used by
subproblem assembly.

Coefficient conventions (matching the reference where structure leaks into
matrices):
  * Jacobi: orthonormal Jacobi coefficients; derivative bases are
    (a0+k, b0+k); the grid is always the (a0, b0) Gauss grid
    (reference: core/basis.py:435 Jacobi).
  * RealFourier: interleaved (cos, -sin) pairs, group_shape=2, the k=0
    minus-sin slot is invalid (reference: core/basis.py:1108).
"""

import numpy as np

from ..tools.cache import CachedClass, CachedMethod
from ..tools import jacobi as jacobi_tools
from .transforms import get_plan

# the port's transform route (torch.fft and the DCT fast path); a basis
# may still ask for library="matrix", the MMT, which only the Jacobi
# family carries
DEFAULT_LIBRARY = "fft"


class AffineCOV:
    """
    Affine change-of-variables between native and problem coordinates
    (reference: core/basis.py:46 AffineCOV).
    """

    def __init__(self, native_bounds, problem_bounds):
        self.native_bounds = native_bounds
        self.problem_bounds = problem_bounds
        n0, n1 = native_bounds
        p0, p1 = problem_bounds
        self.stretch = (p1 - p0) / (n1 - n0)

    def problem_coord(self, native_coord):
        n0, _ = self.native_bounds
        p0, _ = self.problem_bounds
        return p0 + (np.asarray(native_coord) - n0) * self.stretch

    def native_coord(self, problem_coord):
        n0, _ = self.native_bounds
        p0, _ = self.problem_bounds
        pc = problem_coord
        if isinstance(pc, str):
            # accept 'left'/'right'/'center' for boundary interpolation
            if pc == "left":
                return self.native_bounds[0]
            if pc == "right":
                return self.native_bounds[1]
            if pc == "center":
                return (self.native_bounds[0] + self.native_bounds[1]) / 2
            raise ValueError(f"Unknown position: {pc}")
        return n0 + (np.asarray(pc) - p0) / self.stretch


class Basis(metaclass=CachedClass):
    """Base class for 1D spectral bases."""

    dim = 1

    def __init__(self, coord, size, bounds, dealias=1.0, library=None):
        self.coord = coord
        self.coordsystem = getattr(coord, "cs", None) or coord
        self.size = int(size)
        self.bounds = tuple(map(float, bounds))
        self.dealias = float(dealias)
        self.library = library or DEFAULT_LIBRARY

    def grid_size(self, scale):
        return int(np.ceil(scale * self.size))

    @CachedMethod
    def transform_plan(self, scale, library=None):
        return get_plan(self, scale, library)

    def _effective_library(self, library, dtype):
        return library or self.library

    def forward_transform(self, gdata, axis, scale, library=None,
                          tensorsig=(), sub_axis=0):
        library = self._effective_library(library, gdata.dtype)
        return self.transform_plan(scale, library).forward(gdata, axis)

    def backward_transform(self, cdata, axis, scale, library=None,
                           tensorsig=(), sub_axis=0):
        library = self._effective_library(library, cdata.dtype)
        return self.transform_plan(scale, library).backward(cdata, axis)

    # --- multi-axis accessors (1D defaults; curvilinear bases override) ---

    @property
    def first_axis(self):
        return self.coord.axis

    def coeff_size(self, sub_axis):
        return self.size

    def sub_grid_size(self, sub_axis, scale):
        return self.grid_size(scale)

    def sub_separable(self, sub_axis):
        return self.separable

    def sub_group_shape(self, sub_axis):
        return self.group_shape

    def sub_n_groups(self, sub_axis):
        return self.n_groups

    def component_valid_mask(self, tensorsig, group, sep_widths):
        """
        Component-resolved validity over this basis's axes at one group:
        bool array (ncomp, *per-axis slot sizes). 1D default broadcasts the
        axis mask over components.
        """
        tshape = tuple(cs.dim for cs in tensorsig)
        ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
        axis = self.first_axis
        if axis in sep_widths:
            ax_mask = self.valid_elements()[group[axis]]
        else:
            # layout-coupled axis: the whole-axis slot is the flattened
            # (group, pair) coefficient run
            ax_mask = np.ravel(self.valid_elements())
        return np.broadcast_to(ax_mask[None], (ncomp,) + ax_mask.shape)

    # --- group structure (separable axes); coupled bases override ---
    separable = False
    group_shape = 1

    def __repr__(self):
        return f"{type(self).__name__}({self.coord.name}, {self.size})"

    def derivative_basis(self, order=1):
        return self

    def constant_column(self):
        """Column embedding a constant into this basis's coefficients. (N, 1)."""
        raise NotImplementedError


class Jacobi(Basis):
    """
    Jacobi-family interval basis (reference: core/basis.py:435).

    Parameters a0, b0 give the family (grid); k gives the derivative level:
    coefficients are in (a, b) = (a0+k, b0+k).
    """

    separable = False

    def __init__(self, coord, size, bounds, a, b, a0=None, b0=None,
                 dealias=1.0, library=None, k=None):
        # the default 'fft' plan is the DCT fast path for Chebyshev grids
        # and falls back to the MMT internally for other Jacobi families
        super().__init__(coord, size, bounds, dealias=dealias, library=library)
        if a0 is None:
            a0 = a
        if b0 is None:
            b0 = b
        self.a, self.b = float(a), float(b)
        self.a0, self.b0 = float(a0), float(b0)
        self.k = int(round(self.a - self.a0))
        if not np.allclose([self.a - self.a0, self.b - self.b0], self.k):
            raise ValueError("Jacobi derivative level must be integer and equal in a and b.")
        self.COV = AffineCOV((-1.0, 1.0), self.bounds)

    def __repr__(self):
        return f"Jacobi({self.coord.name}, {self.size}, a={self.a}, b={self.b})"

    def derivative_basis(self, order=1):
        return Jacobi(self.coord, self.size, self.bounds,
                      a=self.a + order, b=self.b + order,
                      a0=self.a0, b0=self.b0, dealias=self.dealias, library=self.library)

    def base_basis(self):
        return Jacobi(self.coord, self.size, self.bounds, a=self.a0, b=self.b0,
                      dealias=self.dealias, library=self.library)

    def native_grid(self, scale=1.0):
        return jacobi_tools.build_grid(self.grid_size(scale), self.a0, self.b0)

    def global_grid(self, scale=1.0):
        return self.COV.problem_coord(self.native_grid(scale))

    # ---- operator submatrices (problem coordinates) ----

    @CachedMethod
    def conversion_matrix(self, dk):
        """(a,b) -> (a+dk, b+dk), shape (N, N)."""
        return jacobi_tools.conversion_matrix(self.size, self.a, self.b, dk, dk)

    @CachedMethod
    def differentiation_matrix(self):
        """d/dx in problem coords: (a,b) coeffs -> (a+1,b+1) coeffs."""
        D = jacobi_tools.differentiation_matrix(self.size, self.a, self.b)
        return D / self.COV.stretch

    @CachedMethod
    def interpolation_vector(self, position):
        """Row (1, N): evaluate (a,b) coefficients at problem position."""
        xi = self.COV.native_coord(position)
        return jacobi_tools.interpolation_vector(self.size, self.a, self.b, xi)[None, :]

    @CachedMethod
    def integration_vector(self):
        """Row (1, N): integral over the problem interval."""
        return jacobi_tools.integration_vector(self.size, self.a, self.b)[None, :] * self.COV.stretch

    def multiplication_matrix(self, f_coeffs, f_basis, dk_out=0):
        """
        Matrix mapping this basis's coeffs to coeffs of (f * u) in
        (a + dk_out, b + dk_out), for NCC f with coefficients in f_basis.
        """
        return jacobi_tools.multiplication_matrix(
            self.size, self.a + dk_out, self.b + dk_out,
            self.size, self.a, self.b,
            np.asarray(f_coeffs), f_basis.a, f_basis.b)

    def lift_column(self, index):
        """Column (N, 1): embed a constant-in-axis tau via mode `index`."""
        col = np.zeros((self.size, 1))
        col[index, 0] = 1.0
        return col

    def constant_column(self):
        col = np.zeros((self.size, 1))
        col[0, 0] = np.sqrt(jacobi_tools.mass(self.a0, self.b0))
        if self.k:
            C = jacobi_tools.conversion_matrix(self.size, self.a0, self.b0, self.k, self.k)
            col = C @ col
        return col

    def valid_elements(self):
        return np.ones(self.size, dtype=bool)


def ChebyshevT(coord, size, bounds, **kw):
    """First-kind Chebyshev basis (reference: core/basis.py:649)."""
    return Jacobi(coord, size, bounds, a=-1/2, b=-1/2, **kw)


class FourierBase(Basis):
    """Common machinery for periodic Fourier bases."""

    separable = True

    def __init__(self, coord, size, bounds=(0, 2*np.pi), dealias=1.0, library=None):
        super().__init__(coord, size, bounds, dealias=dealias, library=library)
        if self.size % 2:
            raise ValueError("Fourier basis size must be even.")
        self.COV = AffineCOV((0.0, 2*np.pi), self.bounds)
        self.length = self.bounds[1] - self.bounds[0]
        # native wavenumber -> problem wavenumber factor
        self.kappa = 2 * np.pi / self.length

    def native_grid(self, scale=1.0):
        Ng = self.grid_size(scale)
        return 2 * np.pi * np.arange(Ng) / Ng

    def global_grid(self, scale=1.0):
        return self.COV.problem_coord(self.native_grid(scale))

    def derivative_basis(self, order=1):
        return self


class RealFourier(FourierBase):
    """
    Real trigonometric basis with interleaved (cos, -sin) coefficient pairs
    (reference: core/basis.py:1108; group_shape=(2,) at :1114).
    """

    group_shape = 2

    @property
    def n_groups(self):
        return self.size // 2

    def group_wavenumber(self, g):
        """Problem-coordinate wavenumber of group g."""
        return np.asarray(g) * self.kappa

    def valid_elements(self):
        """(n_groups, 2) bool: the k=0 minus-sin slot is invalid."""
        valid = np.ones((self.n_groups, 2), dtype=bool)
        valid[0, 1] = False
        return valid

    # --- per-group operator blocks (each (2, 2), problem coordinates) ---

    def differentiation_blocks(self):
        """
        d/dx on (cos, -sin) amplitudes of mode k:
            f  = c cos(kx) + s (-sin(kx))
            f' = (-k s) cos(kx) + (k c)(-sin(kx))
        """
        k = self.group_wavenumber(np.arange(self.n_groups))
        blocks = np.zeros((self.n_groups, 2, 2))
        blocks[:, 0, 1] = -k
        blocks[:, 1, 0] = k
        return blocks

    def integration_blocks(self):
        """Integrate over the interval: L * cos0 amplitude, into the constant slot."""
        blocks = np.zeros((self.n_groups, 2, 2))
        blocks[0, 0, 0] = self.length
        return blocks

    def constant_blocks(self):
        """Embed a constant-along-axis value into (cos0, group 0)."""
        blocks = np.zeros((self.n_groups, 2, 2))
        blocks[0, 0, 0] = 1.0
        return blocks

    def interpolation_rows(self, position):
        """(n_groups, 2) row weights evaluating each group at `position`."""
        theta0 = self.COV.native_coord(position)
        g = np.arange(self.n_groups)
        rows = np.stack([np.cos(g * theta0), -np.sin(g * theta0)], axis=-1)
        rows[0, 1] = 0.0
        return rows
