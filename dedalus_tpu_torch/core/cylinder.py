"""
Cylinder calculus: vector operators over DirectProduct coordinate systems
(a straight coordinate times PolarCoordinates): periodic cylinders
(Fourier x disk) and cylindrical annuli (Fourier x annulus)
(counterpart of dedalus_tpu/core/cylinder.py; reference:
core/operators.py:2384 DirectProduct operator subclasses).

Component convention: the product's tensor components concatenate the
factors' components in order, the polar factor stored as spin (-, +)
components in coefficient space (curvilinear.recombination_matrix rotates
only the polar block inside the disk transforms). The straight factors'
components carry spin 0.

Every term is either a straight-axis derivative (separable Fourier
blocks) paired with a radial k -> k+1 conversion stack, so that all terms
land on the disk's derivative basis, or a polar ladder/Laplacian stack as
in the 2-D polar operators. The matrices are host numpy arrays, uploaded
once per node (LinearOperator._evaluation_terms).
"""

import numpy as np

from .coords import CurvilinearCoordinateSystem
from .curvilinear import SpinBasisMixin, component_spins, index_rotates
from .operators import LinearOperator, _diff_descr
from .polar import _expand_complex_terms

__all__ = ["CylinderGradient", "CylinderDivergence", "CylinderLaplacian",
           "CylinderCurl"]

SPIN_INDEX = {-1: 0, +1: 1}  # spin ordering (-, +) of PolarCoordinates


def _cyl_parts(operand, dp):
    """
    Decompose a DirectProduct operand: (polar_cs, disk, straight, pol_off),
    `straight` = [(comp_offset, coord, axis, basis or None)] for the
    straight factors' coordinates, `pol_off` the polar factor's component
    offset, `disk` None for a polar-constant operand.
    """
    polar = dp.curvilinear_sub()
    if polar is None:
        raise ValueError("DirectProduct calculus requires a curvilinear factor.")
    disk = None
    for b in operand.domain.bases:
        if isinstance(b, SpinBasisMixin) and b.cs == polar:
            disk = b
    if disk is None:
        # a polar-constant operand (a z-only profile): its derivatives are
        # straight ones, as long as no tensor index couples to the polar
        # factor (a constant-component polar vector is not a constant field)
        if any(index_rotates(tcs, polar).any()
               for tcs in operand.tensorsig):
            raise ValueError(
                "DirectProduct operand with polar tensor components has no "
                "basis on the polar factor (covariant derivatives of "
                "constant-component polar vectors are not representable).")
    straight = []
    off = 0
    for cs in dp.coordsystems:
        if not isinstance(cs, CurvilinearCoordinateSystem):
            for j, coord in enumerate(cs.coords):
                axis = operand.dist.get_axis(coord)
                basis = operand.domain.bases[axis]
                if basis is not None and not basis.separable:
                    raise NotImplementedError(
                        "DirectProduct calculus requires separable (Fourier) "
                        "bases on the straight factors (a coupled straight "
                        "axis would need two-coupled-axis pencils).")
                straight.append((off + j, coord, axis, basis))
        off += cs.dim
    return polar, disk, straight, dp.sub_slice(polar).start


def _conv_descr(disk, az, s, dk):
    """The radial k -> k+dk conversion: per-m spin stacks on the disk, one
    spin-independent matrix on the annulus; None for dk = 0 or a
    polar-constant operand."""
    if dk == 0 or disk is None:
        return None
    if hasattr(disk, "conversion_stack"):
        return ("gblocks", az, disk.conversion_stack(int(s), dk))
    return ("full", disk._conversion_matrix_total(dk))


def _selector(shape, pairs):
    """A 0/1 tensor factor of `shape` with ones at the (row, col) pairs."""
    sel = np.zeros(shape)
    for row, col in pairs:
        sel[row, col] = 1.0
    return sel


class CylinderOperator(LinearOperator):
    """Base for DirectProduct (cylinder) calculus operators."""

    def _parts(self):
        return _cyl_parts(self.operand, self.cs)

    def _out_domain(self, operand, order):
        _, disk, _, _ = _cyl_parts(operand, self.cs)
        if disk is None:
            return operand.domain
        return operand.domain.substitute_basis(disk,
                                               disk.derivative_basis(order))


class CylinderGradient(CylinderOperator):
    """Covariant gradient on the product: straight components are plain
    derivatives (with a radial k -> k+1 conversion), polar components map
    through the D_{+-} spin ladders (dedalus_tpu/core/cylinder.py:115)."""

    name = "Grad"

    def __init__(self, operand, cs):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return CylinderGradient(new_args[0], self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = self._out_domain(operand, 1)
        self.tensorsig = (self.cs,) + tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        polar, disk, straight, pol_off = self._parts()
        az = disk.first_axis if disk is not None else None
        spins = component_spins(operand.tensorsig, polar)
        ncomp = len(spins)
        dim = operand.domain.dim
        shape = (self.cs.dim * ncomp, ncomp)
        terms = []
        for off_c, coord, axis, basis in straight:
            if basis is None:
                continue  # derivative along a constant axis
            for s in np.unique(spins):
                sel = _selector(shape, [(off_c * ncomp + c, c)
                                        for c in np.flatnonzero(spins == s)])
                descrs = [None] * dim
                descrs[axis] = _diff_descr(basis)
                if disk is not None:
                    descrs[az + 1] = _conv_descr(disk, az, s, 1)
                terms.append((sel, descrs))
        if disk is None:
            return terms  # polar-constant operand: the ladder rows are zero
        for sigma, ds in ((0, -1), (1, +1)):
            for s in np.unique(spins):
                sel = _selector(shape, [((pol_off + sigma) * ncomp + c, c)
                                        for c in np.flatnonzero(spins == s)])
                descrs = [None] * dim
                descrs[az + 1] = ("gblocks", az, disk.ladder_stack(int(s), ds))
                terms.append((sel, descrs))
        return terms


class CylinderDivergence(CylinderOperator):
    """div u = sum_c d_c u_c + D_+ u_- + D_- u_+ over the leading product
    index (dedalus_tpu/core/cylinder.py:177)."""

    name = "Div"

    def __init__(self, operand, index=0):
        if index != 0:
            raise NotImplementedError("Divergence only supports index=0.")
        self.cs = operand.tensorsig[0]
        super().__init__(operand)

    def rebuild(self, new_args):
        return CylinderDivergence(new_args[0])

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = self._out_domain(operand, 1)
        self.tensorsig = tuple(operand.tensorsig[1:])
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        polar, disk, straight, pol_off = self._parts()
        az = disk.first_axis
        rest_spins = component_spins(operand.tensorsig[1:], polar)
        nrest = len(rest_spins)
        dim = operand.domain.dim
        shape = (nrest, self.cs.dim * nrest)
        terms = []
        for off_c, coord, axis, basis in straight:
            if basis is None:
                continue
            for s in np.unique(rest_spins):
                sel = _selector(shape, [(c, off_c * nrest + c)
                                        for c in np.flatnonzero(rest_spins == s)])
                descrs = [None] * dim
                descrs[axis] = _diff_descr(basis)
                descrs[az + 1] = _conv_descr(disk, az, s, 1)
                terms.append((sel, descrs))
        for sigma, sspin in ((0, -1), (1, +1)):
            for sr in np.unique(rest_spins):
                sel = _selector(shape, [(c, (pol_off + sigma) * nrest + c)
                                        for c in np.flatnonzero(rest_spins == sr)])
                descrs = [None] * dim
                descrs[az + 1] = ("gblocks", az,
                                  disk.ladder_stack(int(sspin + sr), -sspin))
                terms.append((sel, descrs))
        return terms


class CylinderLaplacian(CylinderOperator):
    """lap X = sum_c d_c^2 X + the polar spin-weighted Laplacian, diagonal
    over spin components (dedalus_tpu/core/cylinder.py:238)."""

    name = "Lap"

    def __init__(self, operand, cs=None):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return CylinderLaplacian(new_args[0], self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = self._out_domain(operand, 2)
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        polar, disk, straight, pol_off = self._parts()
        az = disk.first_axis if disk is not None else None
        spins = component_spins(operand.tensorsig, polar)
        ncomp = len(spins)
        dim = operand.domain.dim

        def spin_sel(s):
            return np.diag((spins == s).astype(float)) if ncomp > 1 else None

        terms = []
        for off_c, coord, axis, basis in straight:
            if basis is None:
                continue
            kind, blocks = _diff_descr(basis)
            assert kind == "blocks"
            blocks2 = np.einsum("gij,gjk->gik", blocks, blocks)
            for s in np.unique(spins):
                descrs = [None] * dim
                descrs[axis] = ("blocks", blocks2)
                if disk is not None:
                    descrs[az + 1] = _conv_descr(disk, az, s, 2)
                terms.append((spin_sel(s), descrs))
        if disk is None:
            return terms
        for s in np.unique(spins):
            descrs = [None] * dim
            descrs[az + 1] = ("gblocks", az, disk.laplacian_stack(int(s)))
            terms.append((spin_sel(s), descrs))
        return terms


class CylinderCurl(CylinderOperator):
    """
    Curl of a product vector (one straight coordinate z and the polar
    factor) in the standard embedding orientation
    (dedalus_tpu/core/cylinder.py:296):

        (curl u)_z = i (D_+ u_-  -  D_- u_+)
        (curl u)_+ = i (d_z u_+  -  D_+ u_z)
        (curl u)_- = -i (d_z u_-  -  D_- u_z)

    from the cylindrical curl with u_+- = (u_r +- i u_phi)/sqrt(2); on a
    real dtype the factor i is the azimuthal pair rotation
    (polar._expand_complex_terms).
    """

    name = "Curl"

    def __init__(self, operand):
        if len(operand.tensorsig) != 1:
            raise ValueError("Curl requires a vector operand.")
        self.cs = operand.tensorsig[0]
        if self.cs.dim != 3:
            raise ValueError("Curl requires a 3D coordinate system.")
        super().__init__(operand)

    def rebuild(self, new_args):
        return CylinderCurl(new_args[0])

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = self._out_domain(operand, 1)
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        polar, disk, straight, pol_off = self._parts()
        if len(straight) != 1:
            raise NotImplementedError(
                "Cylinder curl requires exactly one straight coordinate.")
        z_off, _, z_axis, z_basis = straight[0]
        az = disk.first_axis
        dim = operand.domain.dim
        m_row = pol_off + SPIN_INDEX[-1]
        p_row = pol_off + SPIN_INDEX[+1]
        raw = []

        def term(row, col, coeff, descrs):
            E = np.zeros((3, 3), dtype=complex)
            E[row, col] = coeff
            raw.append((E, descrs))

        def radial(stack):
            d = [None] * dim
            d[az + 1] = ("gblocks", az, stack)
            return d

        def dz(s):
            d = [None] * dim
            d[az + 1] = _conv_descr(disk, az, s, 1)
            d[z_axis] = _diff_descr(z_basis)
            return d

        # (curl u)_z = i D_+ u_-  -  i D_- u_+
        term(z_off, m_row, +1j, radial(disk.ladder_stack(-1, +1)))
        term(z_off, p_row, -1j, radial(disk.ladder_stack(+1, -1)))
        # (curl u)_+ = i d_z u_+  -  i D_+ u_z
        if z_basis is not None:
            term(p_row, p_row, +1j, dz(+1))
        term(p_row, z_off, -1j, radial(disk.ladder_stack(0, +1)))
        # (curl u)_- = -i d_z u_-  +  i D_- u_z
        if z_basis is not None:
            term(m_row, m_row, -1j, dz(-1))
        term(m_row, z_off, +1j, radial(disk.ladder_stack(0, -1)))
        return _expand_complex_terms(raw, az, disk.sub_n_groups(0),
                                     disk.complex)
