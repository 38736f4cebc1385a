"""
Symbolic linear operators (counterpart of dedalus_tpu/core/operators.py,
Cartesian subset).

Design: every linear operator is described by a list of **terms**; each term
is (tensor_factor, [axis_descriptor ...]) with one descriptor per distributor
axis. Descriptors:

  None                   identity on that axis
  ('full', A)            dense matrix applied along the (coupled/constant) axis
  ('blocks', B)          per-group blocks B[g] (gs_out, gs_in) on a separable
                         axis (group-diagonal action)

One descriptor set drives BOTH
  * host-side pencil matrix assembly (`subproblem_matrix`: kron of factors
    per group; reference: core/operators.py:900 subproblem_matrix), and
  * device-side evaluation (`ev_impl`: torch reshape/einsum application).
"""

import numpy as np
import scipy.sparse as sp
import torch

from .field import Field
from .future import Future, ev
from .domain import Domain
from .basis import Jacobi
from .coords import CartesianCoordinates
from ..tools.array import (kron as sparse_kron, sparsify, apply_matrix_torch,
                            match_precision)
from ..tools.exceptions import NonlinearOperatorError

# Registry of names injected into problem parsing namespaces
# (reference: core/operators.py:61-83 aliases/parseables).
parseables = {}


def parseable(*names):
    def register(obj):
        for name in names:
            parseables[name] = obj
        return obj
    return register


# ----------------------------------------------------------------------
# Shared helpers

def tensor_identity(tshape):
    n = int(np.prod(tshape, dtype=int)) if tshape else 1
    return sp.identity(n, format="csr")


def _axis_identity(basis, sep_width=None, sub_axis=0):
    """
    Identity factor for an untouched axis. On problem-separable axes the
    uniform pencil slot width (`sep_width` = group_shape) is used even when
    the operand is constant along the axis (its dummy slots are masked by
    validity later); any other axis carries its full coefficient size
    (including separable-capable bases the LAYOUT coupled, e.g. a Fourier
    axis an LHS NCC varies along).
    """
    if sep_width is not None:
        return sp.identity(sep_width, format="csr")
    if basis is None:
        return sp.identity(1, format="csr")
    return sp.identity(basis.coeff_size(sub_axis), format="csr")


def assemble_group_matrix(terms, operand_domain, tshape_in, tshape_out,
                          subproblem, out_domain=None):
    """
    Kron-assemble the pencil matrix of one operator at one group.
    `subproblem.group` is a full-length per-axis tuple (group index on
    separable axes, None elsewhere). `out_domain` (when given) marks axes
    the OUTPUT is constant along — on layout-coupled axes, per-group
    "blocks" reduce (hstack) instead of block-diagonalizing there.
    """
    group = subproblem.group
    sep_widths = subproblem.layout.sep_widths  # {axis: group_shape}
    total = None
    for tensor_factor, axis_descrs in terms:
        if tensor_factor is None:
            factors = [tensor_identity(tshape_in)]
        else:
            factors = [sparsify(tensor_factor)]
        for axis, descr in enumerate(axis_descrs):
            basis = operand_domain.bases[axis]
            sub = 0 if basis is None else axis - basis.first_axis
            if descr is None:
                factors.append(_axis_identity(basis, sep_widths.get(axis), sub))
                continue
            kind = descr[0]
            if kind == "full":
                factors.append(sparsify(descr[1]))
            elif kind == "blocks":
                if group[axis] is None:
                    # layout-coupled separable basis: the whole-axis matrix
                    # is the block diagonal of the per-group blocks in group
                    # order — except embeddings FROM a constant axis
                    # (operand basis None: stack the per-group columns) and
                    # reductions TO a constant axis (output basis None:
                    # concatenate the per-group rows)
                    out_const = (out_domain is not None
                                 and out_domain.bases[axis] is None)
                    if basis is None:
                        factors.append(sp.vstack(
                            [sparsify(b) for b in descr[1]], format="csr"))
                    elif out_const:
                        factors.append(sp.hstack(
                            [sparsify(b) for b in descr[1]], format="csr"))
                    else:
                        factors.append(sp.block_diag(
                            [sparsify(b) for b in descr[1]], format="csr"))
                else:
                    factors.append(sparsify(descr[1][group[axis]]))
            else:
                raise ValueError(kind)
        mat = sparse_kron(*factors)
        total = mat if total is None else total + mat
    return total


def apply_axis_blocks(data, blocks, axis):
    """Apply per-group blocks (G, so, si) along an axis of size G*si."""
    blocks = match_precision(blocks, data)
    G, so, si = blocks.shape
    moved = torch.movedim(data, axis, -1)
    moved = moved.reshape(moved.shape[:-1] + (G, si))
    out = torch.einsum("gij,...gj->...gi", blocks, moved)
    out = out.reshape(out.shape[:-2] + (G * so,))
    return torch.movedim(out, -1, axis)


def apply_tensor_factor(data, factor, tshape_in, tshape_out):
    """Apply a (ncomp_out, ncomp_in) factor to the flattened tensor axes."""
    factor = match_precision(factor, data)
    tdim_in = len(tshape_in)
    spatial = data.shape[tdim_in:]
    flat = data.reshape((int(np.prod(tshape_in, dtype=int)) if tshape_in else 1,) + spatial)
    out = torch.tensordot(factor, flat, dims=([1], [0]))
    return out.reshape(tuple(tshape_out) + spatial)


def apply_term(data, tensor_factor, axis_descrs, tshape_in, tshape_out, tdim_out):
    """Device-side application of one operator term to coeff data."""
    out = data
    tdim_in = len(tshape_in)
    for axis, descr in enumerate(axis_descrs):
        if descr is None:
            continue
        kind = descr[0]
        if kind == "full":
            out = apply_matrix_torch(descr[1], out, tdim_in + axis)
        elif kind == "blocks":
            out = apply_axis_blocks(out, descr[1], tdim_in + axis)
    if tensor_factor is not None:
        out = apply_tensor_factor(out, tensor_factor, tshape_in, tshape_out)
    elif tshape_in != tuple(tshape_out):
        raise ValueError("Tensor shape change requires a tensor factor.")
    return out


def operand_expression_matrices(operand, subproblem, vars, **kw):
    """Dispatch expression_matrices for Field leaves and Future nodes."""
    if isinstance(operand, Field):
        if operand in vars:
            size = subproblem.field_size(operand)
            return {operand: sp.identity(size, format="csr")}
        raise NonlinearOperatorError(
            f"Field {operand} on LHS outside an NCC product is not a problem variable.")
    if isinstance(operand, Future):
        return operand.expression_matrices(subproblem, vars, **kw)
    raise NonlinearOperatorError(f"Cannot build matrices for operand {operand!r}")


# ----------------------------------------------------------------------
# Linear operator base

class LinearOperator(Future):
    """Base: single-operand linear spectral operator
    (reference: core/operators.py:591 LinearOperator)."""

    natural_layout = "c"

    @property
    def operand(self):
        return self.args[0]

    def terms(self):
        """[(tensor_factor_or_None, [axis_descr ...]), ...]"""
        raise NotImplementedError

    def device_terms(self):
        """Descriptors for device evaluation (defaults to terms())."""
        return self.terms()

    def expression_matrices(self, subproblem, vars, **kw):
        op_mats = operand_expression_matrices(self.operand, subproblem, vars, **kw)
        M = self.subproblem_matrix(subproblem)
        return {var: M @ mat for var, mat in op_mats.items()}

    def subproblem_matrix(self, subproblem):
        return assemble_group_matrix(
            self.terms(), self.operand.domain,
            self.operand.tshape, self.tshape, subproblem,
            out_domain=self.domain)

    def ev_impl(self, ctx):
        data = ev(self.operand, ctx, "c")
        total = None
        for tensor_factor, axis_descrs in self.device_terms():
            term = apply_term(data, tensor_factor, axis_descrs,
                              self.operand.tshape, self.tshape, self.tdim)
            total = term if total is None else total + term
        return total


# ----------------------------------------------------------------------
# Differentiate

class DifferentiateCartesian(LinearOperator):
    """d/dx_i (reference: core/operators.py:1319 Differentiate)."""

    name = "Diff"

    def __init__(self, operand, coord):
        self.coord = coord
        super().__init__(operand, coord)
        self.axis = operand.dist.get_axis(coord)

    def rebuild(self, new_args):
        return DifferentiateCartesian(new_args[0], self.coord)

    def _build_metadata(self):
        operand = self.args[0]
        axis = operand.dist.get_axis(self.coord)
        basis = operand.domain.bases[axis]
        if basis is None:
            raise ValueError("Differentiate along a constant axis; use the factory.")
        bases = list(operand.domain.bases)
        bases[axis] = basis.derivative_basis(1)
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = operand.tensorsig
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        basis = operand.domain.bases[self.axis]
        descrs = [None] * operand.domain.dim
        if basis.separable:
            descrs[self.axis] = ("blocks", basis.differentiation_blocks())
        else:
            descrs[self.axis] = ("full", basis.differentiation_matrix())
        return [(None, descrs)]


def _resolve_coord(operand, coord):
    """Resolve a coordinate given by NAME to the distributor's Coordinate
    object (strings otherwise fail get_basis identity checks silently)."""
    if not isinstance(coord, str):
        return coord
    return operand.dist.get_coord(coord)


def _resolve_coords(operand, coords):
    """Normalize a coords spec (None, name, Coordinate, coordinate system,
    or sequence of these) to a list of Coordinate objects, or None for
    'all axes'. Resolution happens BEFORE any selection logic so names and
    objects take identical paths."""
    if coords is None:
        return None
    if isinstance(coords, str):
        coords = (coords,)
    expanded = getattr(coords, "coords", None)
    if expanded is not None:
        coords = expanded
    elif not isinstance(coords, (tuple, list)):
        coords = (coords,)
    return [_resolve_coord(operand, c) for c in coords]


@parseable("d", "Differentiate")
def Differentiate(operand, coord):
    if np.isscalar(operand):
        return 0
    if isinstance(coord, CartesianCoordinates):
        raise ValueError("Differentiate needs a single coordinate.")
    coord = _resolve_coord(operand, coord)
    if operand.domain.get_basis(coord) is None:
        return 0
    return DifferentiateCartesian(operand, coord)


# ----------------------------------------------------------------------
# Convert (basis conversion / constant embedding)

class ConvertNode(LinearOperator):
    """
    Convert operand coefficients to target bases: Jacobi derivative-level
    lifts and constant->basis embeddings (reference: core/operators.py:1506
    Convert).
    """

    name = "Convert"

    def __init__(self, operand, target_bases):
        self.target_bases = tuple(target_bases)
        super().__init__(operand)

    def rebuild(self, new_args):
        return ConvertNode(new_args[0], self.target_bases)

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = Domain(operand.dist, self.target_bases)
        self.tensorsig = operand.tensorsig
        self.dtype = operand.dtype

    def terms(self):
        return [(None, [_conversion_descr(b_in, b_out, device=False)
                        for b_in, b_out in zip(self.operand.domain.bases,
                                               self.target_bases)])]

    def device_terms(self):
        return [(None, [_conversion_descr(b_in, b_out, device=True)
                        for b_in, b_out in zip(self.operand.domain.bases,
                                               self.target_bases)])]


def _conversion_descr(b_in, b_out, device):
    if b_in is b_out or b_in == b_out:
        return None
    if b_in is None and b_out is None:
        return None
    if b_in is None:
        # constant -> basis embedding
        if b_out.separable:
            if device:
                col = np.zeros((b_out.size, 1))
                col[0, 0] = 1.0  # k=0 cos / k=0 complex mode slot
                return ("full", col)
            return ("blocks", b_out.constant_blocks())
        return ("full", b_out.constant_column())
    if b_out is None:
        raise ValueError("Cannot convert a basis to a constant.")
    if isinstance(b_in, Jacobi) and isinstance(b_out, Jacobi):
        dk = b_out.k - b_in.k
        if dk == 0:
            return None
        if dk < 0:
            raise ValueError("Cannot convert to a lower derivative basis.")
        return ("full", b_in.conversion_matrix(dk))
    raise ValueError(f"No conversion from {b_in} to {b_out}.")


@parseable("convert", "Convert")
def Convert(operand, target_bases, dist=None):
    if np.isscalar(operand):
        raise ValueError("Wrap scalars in constant fields before converting.")
    target_bases = tuple(target_bases)
    if tuple(operand.domain.bases) == target_bases:
        return operand
    return ConvertNode(operand, target_bases)


# ----------------------------------------------------------------------
# Interpolate

class InterpolateCartesian(LinearOperator):
    """Pointwise interpolation along one axis
    (reference: core/operators.py:1037 Interpolate)."""

    name = "interp"

    def __init__(self, operand, coord, position):
        self.coord = coord
        self.position = position
        super().__init__(operand)
        self.axis = operand.dist.get_axis(coord)

    def rebuild(self, new_args):
        return InterpolateCartesian(new_args[0], self.coord, self.position)

    def _build_metadata(self):
        operand = self.args[0]
        axis = operand.dist.get_axis(self.coord)
        bases = list(operand.domain.bases)
        self.basis_in = bases[axis]
        bases[axis] = None
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = operand.tensorsig
        self.dtype = operand.dtype

    def terms(self):
        basis = self.basis_in
        descrs = [None] * self.operand.domain.dim
        if basis.separable:
            raise NonlinearOperatorError(
                "Interpolation along a separable (Fourier) axis is not "
                "group-diagonal; it cannot appear on equation LHS.")
        descrs[self.axis] = ("full", basis.interpolation_vector(self.position))
        return [(None, descrs)]

    def device_terms(self):
        basis = self.basis_in
        descrs = [None] * self.operand.domain.dim
        if basis.separable:
            rows = basis.interpolation_rows(self.position).reshape(1, -1)
            descrs[self.axis] = ("full", rows)
        else:
            descrs[self.axis] = ("full", basis.interpolation_vector(self.position))
        return [(None, descrs)]


@parseable("interp", "Interpolate")
def Interpolate(operand, coord, position):
    if np.isscalar(operand):
        return operand
    coord = _resolve_coord(operand, coord)
    if operand.domain.get_basis(coord) is None:
        return operand
    return InterpolateCartesian(operand, coord, position)


# ----------------------------------------------------------------------
# Integrate / Average

class IntegrateCartesian(LinearOperator):
    """Definite integral along one axis
    (reference: core/operators.py:1120 Integrate)."""

    name = "integ"

    def __init__(self, operand, coord):
        self.coord = coord
        super().__init__(operand)
        self.axis = operand.dist.get_axis(coord)

    def rebuild(self, new_args):
        return IntegrateCartesian(new_args[0], self.coord)

    def _build_metadata(self):
        operand = self.args[0]
        axis = operand.dist.get_axis(self.coord)
        bases = list(operand.domain.bases)
        self.basis_in = bases[axis]
        bases[axis] = None
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = operand.tensorsig
        self.dtype = operand.dtype

    def terms(self):
        basis = self.basis_in
        descrs = [None] * self.operand.domain.dim
        if basis.separable:
            descrs[self.axis] = ("blocks", basis.integration_blocks())
        else:
            descrs[self.axis] = ("full", basis.integration_vector())
        return [(None, descrs)]

    def device_terms(self):
        basis = self.basis_in
        descrs = [None] * self.operand.domain.dim
        if basis.separable:
            row = np.zeros((1, basis.size))
            row[0, 0] = basis.length
            descrs[self.axis] = ("full", row)
        else:
            descrs[self.axis] = ("full", basis.integration_vector())
        return [(None, descrs)]


@parseable("integ", "Integrate")
def Integrate(operand, coords=None):
    if np.isscalar(operand):
        return operand
    coords = _resolve_coords(operand, coords)
    out = operand
    if coords is None:
        coords = [b.coord for b in out.domain.bases if b is not None]
    for coord in coords:
        if out.domain.get_basis(coord) is not None:
            out = IntegrateCartesian(out, coord)
    return out


# ----------------------------------------------------------------------
# Lift (tau terms)

class Lift(LinearOperator):
    """
    Embed a lower-dimensional tau field into `basis` via mode `n`
    (reference: core/operators.py:4228 Lift).
    """

    name = "Lift"

    def __init__(self, operand, basis, n):
        self.basis = basis
        self.n = n
        super().__init__(operand)
        self.axis = operand.dist.get_axis(basis.coord)

    def rebuild(self, new_args):
        return Lift(new_args[0], self.basis, self.n)

    def _build_metadata(self):
        operand = self.args[0]
        axis = operand.dist.get_axis(self.basis.coord)
        if operand.domain.bases[axis] is not None:
            raise ValueError("Lift operand must be constant along the lift axis.")
        bases = list(operand.domain.bases)
        bases[axis] = self.basis
        self.domain = Domain(operand.dist, bases)
        self.tensorsig = operand.tensorsig
        self.dtype = operand.dtype

    def terms(self):
        index = self.n if self.n >= 0 else self.basis.size + self.n
        descrs = [None] * self.operand.domain.dim
        descrs[self.axis] = ("full", self.basis.lift_column(index))
        return [(None, descrs)]


parseables["lift"] = Lift


# ----------------------------------------------------------------------
# TimeDerivative (marker)

class TimeDerivative(LinearOperator):
    """Marker for dt in IVPs (reference: core/operators.py:974)."""

    name = "dt"

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = operand.tensorsig
        self.dtype = operand.dtype

    def terms(self):
        return [(None, [None] * self.operand.domain.dim)]

    def ev_impl(self, ctx):
        raise NonlinearOperatorError("TimeDerivative cannot be evaluated explicitly.")


def dt(operand):
    if np.isscalar(operand):
        return 0
    return TimeDerivative(operand)


parseables["dt"] = dt
parseables["TimeDerivative"] = dt


# ----------------------------------------------------------------------
# Vector calculus (Cartesian)

def _coupled_lift_terms(operand, per_axis_terms, dist):
    """
    Combine per-axis derivative terms to a common output basis: each term's
    coupled-axis bases are lifted (via conversion factors) to the maximum
    derivative level across terms. Returns (terms, output_bases).
    """
    dim = operand.domain.dim
    bases_in = operand.domain.bases
    # Determine output bases: max derivative level per coupled axis.
    out_bases = list(bases_in)
    for _, descrs, d_levels in per_axis_terms:
        for axis in range(dim):
            if isinstance(bases_in[axis], Jacobi):
                lvl = d_levels.get(axis, 0)
                cur = out_bases[axis]
                tgt = bases_in[axis].derivative_basis(lvl)
                if tgt.k > cur.k:
                    out_bases[axis] = tgt
    # Add conversion factors where a term is below the output level.
    terms = []
    for tensor_factor, descrs, d_levels in per_axis_terms:
        descrs = list(descrs)
        for axis in range(dim):
            if isinstance(bases_in[axis], Jacobi):
                lvl = d_levels.get(axis, 0)
                src = bases_in[axis].derivative_basis(lvl)
                dk = out_bases[axis].k - src.k
                if dk > 0:
                    C = src.conversion_matrix(dk)
                    if descrs[axis] is None:
                        descrs[axis] = ("full", C)
                    else:
                        kind, mat = descrs[axis]
                        assert kind == "full"
                        descrs[axis] = ("full", C @ mat)
        terms.append((tensor_factor, descrs))
    return terms, tuple(out_bases)


def _diff_descr(basis):
    if basis.separable:
        return ("blocks", basis.differentiation_blocks())
    return ("full", basis.differentiation_matrix())


class CartesianVectorOperator(LinearOperator):
    """Shared machinery for grad/div/lap/curl over CartesianCoordinates."""

    def _vector_terms(self):
        """Subclasses return [(tensor_factor, descrs, d_levels)] raw terms."""
        raise NotImplementedError

    def terms(self):
        terms, out_bases = _coupled_lift_terms(self.operand, self._vector_terms(),
                                               self.dist)
        return terms

    def _build_metadata_common(self, operand, cs, tensorsig):
        _, out_bases = _coupled_lift_terms(operand, self._vector_terms_for(operand, cs),
                                           operand.dist)
        self.domain = Domain(operand.dist, out_bases)
        self.tensorsig = tensorsig
        self.dtype = operand.dtype


class CartesianGradient(CartesianVectorOperator):
    """grad: prepend a vector index of partial derivatives
    (reference: core/operators.py:2310 CartesianGradient)."""

    name = "Grad"

    def __init__(self, operand, cs):
        self.cs = cs
        super().__init__(operand)

    def rebuild(self, new_args):
        return CartesianGradient(new_args[0], self.cs)

    def _vector_terms_for(self, operand, cs):
        dim = cs.dim
        ncomp_in = int(np.prod(operand.tshape, dtype=int)) if operand.tshape else 1
        raw = []
        for i, coord in enumerate(cs.coords):
            axis = operand.dist.get_axis(coord)
            basis = operand.domain.bases[axis]
            e_col = np.zeros((dim, 1))
            e_col[i, 0] = 1.0
            tensor_factor = np.kron(e_col, np.identity(ncomp_in))
            if basis is None:
                continue  # derivative of constant axis = 0
            descrs = [None] * operand.domain.dim
            descrs[axis] = _diff_descr(basis)
            d_levels = {axis: 1} if isinstance(basis, Jacobi) else {}
            raw.append((tensor_factor, descrs, d_levels))
        return raw

    def _vector_terms(self):
        return self._vector_terms_for(self.operand, self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        self._build_metadata_common(operand, self.cs,
                                    (self.cs,) + tuple(operand.tensorsig))


class CartesianDivergence(CartesianVectorOperator):
    """div: contract the leading vector index with partial derivatives
    (reference: core/operators.py:3385 Divergence)."""

    name = "Div"

    def __init__(self, operand, index=0):
        self.index = index
        if index != 0:
            raise NotImplementedError("Divergence only supports index=0.")
        self.cs = operand.tensorsig[0]
        super().__init__(operand)

    def rebuild(self, new_args):
        return CartesianDivergence(new_args[0], self.index)

    def _vector_terms_for(self, operand, cs):
        dim = cs.dim
        rest = operand.tshape[1:]
        ncomp_rest = int(np.prod(rest, dtype=int)) if rest else 1
        raw = []
        for i, coord in enumerate(cs.coords):
            axis = operand.dist.get_axis(coord)
            basis = operand.domain.bases[axis]
            if basis is None:
                continue
            e_row = np.zeros((1, dim))
            e_row[0, i] = 1.0
            tensor_factor = np.kron(e_row, np.identity(ncomp_rest))
            descrs = [None] * operand.domain.dim
            descrs[axis] = _diff_descr(basis)
            d_levels = {axis: 1} if isinstance(basis, Jacobi) else {}
            raw.append((tensor_factor, descrs, d_levels))
        return raw

    def _vector_terms(self):
        return self._vector_terms_for(self.operand, self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        self._build_metadata_common(operand, self.cs, tuple(operand.tensorsig[1:]))


class CartesianLaplacian(CartesianVectorOperator):
    """lap = sum_i d_i^2 (reference: core/operators.py:3952 Laplacian)."""

    name = "Lap"

    def __init__(self, operand, cs=None):
        self.cs = cs or operand.dist.coordsystems[0]
        super().__init__(operand)

    def rebuild(self, new_args):
        return CartesianLaplacian(new_args[0], self.cs)

    def _vector_terms_for(self, operand, cs):
        raw = []
        for coord in cs.coords:
            axis = operand.dist.get_axis(coord)
            basis = operand.domain.bases[axis]
            if basis is None:
                continue
            descrs = [None] * operand.domain.dim
            if basis.separable:
                B = basis.differentiation_blocks()
                descrs[axis] = ("blocks", np.einsum("gij,gjk->gik", B, B))
                d_levels = {}
            else:
                D1 = basis.differentiation_matrix()
                D2 = basis.derivative_basis(1).differentiation_matrix()
                descrs[axis] = ("full", D2 @ D1)
                d_levels = {axis: 2}
            raw.append((None, descrs, d_levels))
        return raw

    def _vector_terms(self):
        return self._vector_terms_for(self.operand, self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        self._build_metadata_common(operand, self.cs, tuple(operand.tensorsig))


@parseable("grad", "Gradient")
def Gradient(operand, cs=None):
    if np.isscalar(operand):
        return 0
    return CartesianGradient(operand, cs or operand.dist.coordsystems[0])


@parseable("div", "Divergence")
def Divergence(operand, index=0):
    if np.isscalar(operand):
        return 0
    return CartesianDivergence(operand, index)


@parseable("lap", "Laplacian")
def Laplacian(operand, cs=None):
    if np.isscalar(operand):
        return 0
    return CartesianLaplacian(operand, cs)


# ----------------------------------------------------------------------
# Tensor-index operators

class TraceOperator(LinearOperator):
    """Contract the first two tensor indices with the coordinate delta
    (valid for Cartesian component storage;
    reference: core/operators.py:1693)."""

    name = "Trace"

    def _build_metadata(self):
        operand = self.args[0]
        if len(operand.tensorsig) < 2 or operand.tensorsig[0].dim != operand.tensorsig[1].dim:
            raise ValueError("Trace requires two leading indices of equal dimension.")
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig[2:])
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        d = operand.tensorsig[0].dim
        rest = int(np.prod(operand.tshape[2:], dtype=int)) if operand.tshape[2:] else 1
        row = np.zeros((1, d * d))
        for i in range(d):
            row[0, i * d + i] = 1.0
        tensor_factor = np.kron(row, np.identity(rest))
        return [(tensor_factor, [None] * operand.domain.dim)]


@parseable("trace", "Trace")
def Trace(operand):
    if np.isscalar(operand):
        return 0
    return TraceOperator(operand)
