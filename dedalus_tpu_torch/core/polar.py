"""
Spin-weighted circle basis and the spin operators of the curvilinear
bases (counterpart of the parts of dedalus_tpu/core/polar.py the sphere
uses: S1SpinTransformMixin :37 and S1Basis :75, one class here;
PolarSpinOperator :687 and the gradient, divergence, Laplacian, integral
and skew built on it; reference: dedalus/core/basis.py:1798 S1_basis and
the polar operator subclasses core/operators.py:2878 PolarMOperator,
:3023 PolarGradient).

  * Coefficient-space tensor components are SPIN components; the
    coordinate<->spin rotation happens inside the transforms
    (reference: core/basis.py:1595 forward_spin_recombination).
  * Gradient, divergence and Laplacian are spin-ladder compositions,
    assembled from per-m stacks of the basis as ("gblocks", az, stack)
    descriptors: on the pencil path one block per m group, on the device
    one batched matmul over the groups.
"""

import numpy as np

from .basis import RealFourier
from .curvilinear import (PAIR_J, SpinBasisMixin, component_spins,
                          recombination_pair_matrix,
                          apply_component_pair_matrix)
from .domain import Domain
from .operators import LinearOperator


class S1Basis(RealFourier):
    """
    Circle basis: the azimuth basis of the sphere. Like RealFourier, but
    tensor components over the parent curvilinear coordinate system are
    stored as spin components in coefficient space: the recombination
    runs after the forward Fourier transform and before the backward one
    (reference: core/basis.py:1798 S1_basis).
    """

    def __init__(self, coord, size, bounds=(0, 2 * np.pi), dealias=1.0):
        super().__init__(coord, size, bounds=bounds, dealias=dealias)
        self.cs = coord.cs

    def _relevant(self, tensorsig):
        return any(tcs == self.cs for tcs in tensorsig)

    def forward_transform(self, gdata, axis, scale, library=None,
                          tensorsig=(), sub_axis=0):
        out = super().forward_transform(gdata, axis, scale, library)
        if self._relevant(tensorsig):
            R = recombination_pair_matrix(tuple(tensorsig), self.cs, False)
            tdim = len(tensorsig)
            out = apply_component_pair_matrix(out, R, tdim, axis - tdim)
        return out

    def backward_transform(self, cdata, axis, scale, library=None,
                           tensorsig=(), sub_axis=0):
        out = cdata
        if self._relevant(tensorsig):
            R = recombination_pair_matrix(tuple(tensorsig), self.cs, True)
            tdim = len(tensorsig)
            out = apply_component_pair_matrix(out, R, tdim, axis - tdim)
        return super().backward_transform(out, axis, scale, library)


class PolarSpinOperator(LinearOperator):
    """Base for spin-structured operators over a spin-weighted basis
    (any SpinBasisMixin basis exposing the stack interface)."""

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
        spin s through stack_fn(s) along the coupled axis (a spin-diagonal
        operator)."""
        operand = self.operand
        basis = self._basis(operand)
        az, colat = self._axes(basis)
        spins = component_spins(operand.tensorsig, basis.cs)
        ncomp = len(spins)
        terms = []
        for s in np.unique(spins):
            sel = np.diag((spins == s).astype(float)) if ncomp > 1 else None
            descrs = [None] * operand.domain.dim
            descrs[colat] = ("gblocks", az, stack_fn(basis, int(s)))
            terms.append((sel, descrs))
        return terms


class PolarGradient(PolarSpinOperator):
    """Covariant gradient: prepends a spin index; spin-s components map
    through D_{+-} ladders (reference: core/operators.py:3023
    PolarGradient)."""

    name = "Grad"

    def __init__(self, operand, cs):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return PolarGradient(new_args[0], self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = (self.cs,) + tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, colat = self._axes(basis)
        spins = component_spins(operand.tensorsig, basis.cs)
        ncomp = len(spins)
        terms = []
        for sigma, ds in ((0, -1), (1, +1)):
            for s in np.unique(spins):
                sel = np.zeros((2 * ncomp, ncomp))
                for c in np.flatnonzero(spins == s):
                    sel[sigma * ncomp + c, c] = 1.0
                descrs = [None] * operand.domain.dim
                descrs[colat] = ("gblocks", az, basis.ladder_stack(int(s), ds))
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
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig[1:])
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = self._basis(operand)
        az, colat = self._axes(basis)
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
                descrs[colat] = ("gblocks", az, stack)
                terms.append((sel, descrs))
        return terms


class PolarLaplacian(PolarSpinOperator):
    """Spin-weighted Laplacian, diagonal over spin components
    (reference: core/operators.py:3952 Laplacian)."""

    name = "Lap"

    def __init__(self, operand, cs=None):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return PolarLaplacian(new_args[0], self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        return self._per_spin_terms(lambda b, s: b.laplacian_stack(s))


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
        az, colat = self._axes(basis)
        bases = list(operand.domain.bases)
        bases[az] = None
        bases[colat] = None
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = ()
        self.dtype = operand.dtype

    def terms(self):
        basis = self._basis(self.operand)
        az, colat = self._axes(basis)
        G = basis.sub_n_groups(0)
        gs = basis.sub_group_shape(0)
        az_blocks = np.zeros((G, gs, gs))
        az_blocks[0, 0, 0] = 2 * np.pi
        descrs = [None] * self.operand.domain.dim
        descrs[az] = ("blocks", az_blocks)
        descrs[colat] = ("full", basis.integration_row())
        return [(None, descrs)]

    def device_terms(self):
        basis = self._basis(self.operand)
        az, colat = self._axes(basis)
        row = np.zeros((1, basis.Nphi))
        row[0, 0] = 2 * np.pi
        descrs = [None] * self.operand.domain.dim
        descrs[az] = ("full", row)
        descrs[colat] = ("full", basis.integration_row())
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
        # the factor i*s on spin-s components; i acts on each (cos, -sin)
        # azimuth pair as the rotation J (real storage)
        operand = self.operand
        basis = self._basis(operand)
        az, _ = self._axes(basis)
        spins = component_spins(operand.tensorsig, basis.cs)
        descrs = [None] * operand.domain.dim
        descrs[az] = ("blocks", np.tile(PAIR_J, (basis.sub_n_groups(0), 1, 1)))
        return [(np.diag(spins.astype(float)), descrs)]
