"""
Symbolic linear operators (counterpart of dedalus_tpu/core/operators.py:
the Cartesian operators, the azimuthal interpolation and average of the
disk and annulus, and the dispatch of grad, div, lap, curl, skew, trace,
transpose, the components, interpolation, lifts and the integrals to the
spin operators of the disk, annulus and sphere in core/polar.py and
core/sphere.py, and to the regularity operators of the shell in
core/spherical3d.py).

Design: every linear operator is described by a list of **terms**; each term
is (tensor_factor, [axis_descriptor ...]) with one descriptor per distributor
axis. Descriptors:

  None                   identity on that axis
  ('full', A)            dense matrix applied along the (coupled/constant) axis
  ('blocks', B)          per-group blocks B[g] (gs_out, gs_in) on a separable
                         axis (group-diagonal action)
  ('gblocks', ax, B)     per-group blocks B[g] on a coupled axis, the group
                         read from the separable axis `ax` (the per-m
                         radial and colatitude stacks)

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
from .coords import (CartesianCoordinates, DirectProduct, PolarCoordinates,
                     S2Coordinates, SphericalCoordinates, AzimuthalCoordinate)
from .curvilinear import SpinBasisMixin, apply_group_stack, promote_complex
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
        # gblocks whose selector axis the LAYOUT coupled (the shell's
        # radial stacks selected by ell when a colatitude-varying NCC
        # couples ell): the (selector x this) joint factor is the block
        # diagonal of the stack in selector-group order, in place of the
        # selector axis's identity — valid for an adjacent, otherwise
        # untouched selector axis, where the kron ordering matches
        # block_diag's (dedalus_tpu/core/operators.py:50-65)
        joint_consumed = set()
        for axis, descr in enumerate(axis_descrs):
            if (descr is not None and descr[0] == "gblocks"
                    and group[descr[1]] is None):
                group_axis = descr[1]
                if group_axis != axis - 1 \
                        or axis_descrs[group_axis] is not None:
                    raise NotImplementedError(
                        "Layout-coupled gblocks selector must be the "
                        "adjacent untouched axis.")
                joint_consumed.add(group_axis)
        for axis, descr in enumerate(axis_descrs):
            basis = operand_domain.bases[axis]
            sub = 0 if basis is None else axis - basis.first_axis
            if axis in joint_consumed:
                continue  # replaced by the adjacent joint block factor
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
            elif kind == "gblocks":
                # per-group blocks on a coupled axis, the group read from
                # a separable axis — or, with the selector axis coupled,
                # the joint block diagonal over its groups, each group's
                # block acting alike on that group's slots
                _, group_axis, stack = descr
                if group[group_axis] is None:
                    gb = operand_domain.bases[group_axis]
                    gw = gb.sub_group_shape(group_axis - gb.first_axis)
                    eye_g = sp.identity(gw, format="csr")
                    factors.append(sp.block_diag(
                        [sp.kron(eye_g, sparsify(b), format="csr")
                         for b in stack], format="csr"))
                else:
                    factors.append(sparsify(stack[group[group_axis]]))
            else:
                raise ValueError(kind)
        mat = sparse_kron(*factors)
        total = mat if total is None else total + mat
    return total


def apply_axis_blocks(data, blocks, axis):
    """Apply per-group blocks (G, so, si) along an axis of size G*si."""
    blocks = promote_complex(match_precision(blocks, data), data)
    data = promote_complex(data, blocks)
    G, so, si = blocks.shape
    moved = torch.movedim(data, axis, -1)
    moved = moved.reshape(moved.shape[:-1] + (G, si))
    out = torch.einsum("gij,...gj->...gi", blocks, moved)
    out = out.reshape(out.shape[:-2] + (G * so,))
    return torch.movedim(out, -1, axis)


def apply_tensor_factor(data, factor, tshape_in, tshape_out):
    """Apply a (ncomp_out, ncomp_in) factor to the flattened tensor axes."""
    factor = promote_complex(match_precision(factor, data), data)
    data = promote_complex(data, factor)
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
        elif kind == "gblocks":
            _, group_axis, stack = descr
            gaxis = tdim_in + group_axis
            width = out.shape[gaxis] // stack.shape[0]
            out = apply_group_stack(out, stack, gaxis, tdim_in + axis, width)
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

    def _evaluation_terms(self):
        """device_terms(), built once per node: the host matrices keep
        their identity across evaluations, so tools/array.device_constant
        uploads each once instead of on every step (a host-to-device copy
        and a cache entry per evaluation otherwise)."""
        terms = self.__dict__.get("_device_terms")
        if terms is None:
            terms = self._device_terms = self.device_terms()
        return terms

    def ev_impl(self, ctx):
        data = ev(self.operand, ctx, "c")
        total = None
        for tensor_factor, axis_descrs in self._evaluation_terms():
            term = apply_term(data, tensor_factor, axis_descrs,
                              self.operand.tshape, self.tshape, self.tdim)
            total = term if total is None else total + term
        return total

    def ev(self, ctx, layout):
        # fused grid evaluation (core/fusedstep.py FUSED_TRANSFORMS): a
        # registered node's coupled-axis operator chain and dealiased
        # backward transform run as one precomposed composite GEMM,
        # memoized like the generic path; nodes outside the plan (or
        # contexts without one) take the generic path
        if layout == "g" and ctx.fusion is not None:
            key = (id(self), layout)
            if key in ctx.memo:
                return ctx.memo[key]
            out = ctx.fusion.grid_eval(self, ctx)
            if out is not None:
                ctx.memo[key] = out
                return out
        return super().ev(ctx, layout)


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

    def _build_terms(self, device):
        """One descriptor per axis: Jacobi derivative-level lifts and
        constant embeddings, crossed with the terms of a two-axis
        (curvilinear) basis's own conversion (conversion_terms: the
        disk's per-spin stacks, the annulus's radial matrix, the
        sphere's identity); a constant embeds into a two-axis basis with
        one descriptor per sub-axis."""
        dim = self.operand.domain.dim
        base_descrs = [None] * dim
        multi_terms = None
        handled = set()
        for axis, (b_in, b_out) in enumerate(zip(self.operand.domain.bases,
                                                 self.target_bases)):
            if b_in is not None and b_in.dim > 1:
                if b_in is b_out or id(b_in) in handled:
                    continue
                handled.add(id(b_in))
                if multi_terms is not None:
                    raise NotImplementedError(
                        "Multiple curvilinear conversions.")
                multi_terms = b_in.conversion_terms(
                    b_out, self.operand.tensorsig, self.operand.tshape)
            elif b_in is None and b_out is not None and b_out.dim > 1:
                base_descrs[axis] = b_out.constant_component_descr(
                    axis - b_out.first_axis, device)
            else:
                base_descrs[axis] = _conversion_descr(b_in, b_out,
                                                      device=device)
        if multi_terms is None:
            return [(None, base_descrs)]
        out = []
        for factor, dmap in multi_terms:
            descrs = list(base_descrs)
            for axis, d in dmap.items():
                descrs[axis] = d
            out.append((factor, descrs))
        return out

    def terms(self):
        return self._build_terms(device=False)

    def device_terms(self):
        return self._build_terms(device=True)


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


class AzimuthalInterpolate(Future):
    """
    Interpolation at phi = position on a disk or annulus, evaluated in
    GRID space (dedalus_tpu/core/operators.py:525): the uniform azimuth
    grid is contracted with the exact trigonometric interpolation row and
    the result broadcast back as a phi-CONSTANT field on the same domain.
    Tensor components come out in the coordinate frame at phi = position.
    It mixes the azimuthal groups, so it has no per-pencil matrix: RHS and
    output tasks only.
    """

    name = "interp"
    natural_layout = "g"

    _row_cache = {}

    def __init__(self, operand, basis, position):
        self.basis = basis
        self.position = float(position)
        super().__init__(operand)

    @property
    def operand(self):
        return self.args[0]

    def rebuild(self, new_args):
        return AzimuthalInterpolate(new_args[0], self.basis, self.position)

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = operand.tensorsig
        self.dtype = operand.dtype

    def __repr__(self):
        return f"interp({self.args[0]}, phi={self.position})"

    @classmethod
    def _interp_row(cls, Ng, phi0, complex_dtype):
        """Exact trig-interpolation row over Ng uniform azimuth samples
        (closed-form Dirichlet kernel): row @ samples = f(phi0) for any f
        band-limited to the grid. Even Ng carries a half-weight
        (cosine-only) Nyquist mode, matching real-DFT storage. Cached, so
        the device copy is made once."""
        key = (Ng, round(phi0, 15), complex_dtype)
        if key not in cls._row_cache:
            phis = 2 * np.pi * np.arange(Ng) / Ng
            delta = phi0 - phis
            if complex_dtype:
                ms = np.fft.fftfreq(Ng, d=1.0 / Ng)
                row = np.exp(1j * ms[None, :] * delta[:, None]).sum(1) / Ng
            elif Ng % 2 == 0:
                M = Ng // 2
                row = (1.0 + 2.0 * sum(np.cos(m * delta) for m in range(1, M))
                       + np.cos(M * delta)) / Ng
            else:
                M = (Ng - 1) // 2
                row = (1.0 + 2.0 * sum(np.cos(m * delta)
                                       for m in range(1, M + 1))) / Ng
            cls._row_cache[key] = np.ascontiguousarray(row)
        return cls._row_cache[key]

    def ev_impl(self, ctx):
        data = ev(self.operand, ctx, "g")
        ax = self.tdim + self.basis.first_axis
        row = self._interp_row(data.shape[ax], self.position,
                               data.is_complex())
        val = torch.tensordot(data, match_precision(row, data),
                              dims=([ax], [0]))
        return val.unsqueeze(ax).expand(data.shape)

    def expression_matrices(self, subproblem, vars, **kw):
        raise NotImplementedError(
            "Azimuthal interpolation mixes azimuthal groups and has no "
            "per-pencil matrix; use it on the RHS or in output tasks.")


def _polar_basis(basis):
    """Is `basis` a disk or annulus basis?"""
    from .polar import DiskBasis, AnnulusBasis
    return isinstance(basis, (DiskBasis, AnnulusBasis))


@parseable("interp", "Interpolate")
def Interpolate(operand, coord, position):
    if np.isscalar(operand):
        return operand
    coord = _resolve_coord(operand, coord)
    basis = operand.domain.get_basis(coord)
    if basis is None:
        return operand
    if getattr(basis, "regularity", False):
        if isinstance(coord, AzimuthalCoordinate):
            return AzimuthalInterpolate(operand, basis, position)
        if coord != basis.coordsystem.radius:
            raise NotImplementedError(
                "Colatitude interpolation is not supported on the shell "
                "(radial and azimuthal are).")
        from .spherical3d import SphericalInterpolate
        return SphericalInterpolate(operand, position)
    if _polar_basis(basis):
        if isinstance(coord, AzimuthalCoordinate):
            return AzimuthalInterpolate(operand, basis, position)
        from .polar import PolarInterpolate
        return PolarInterpolate(operand, position)
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


def _integrate(operand, coords):
    """(integral, volume) of `operand` over `coords` (None: every axis it
    has a basis on): a curvilinear basis integrates over all of its axes
    at once (a spec naming only some of them is refused), then each
    interval axis in turn (dedalus_tpu/core/operators.py:707-813)."""
    coords = _resolve_coords(operand, coords)
    out, volume = operand, 1.0
    curv = next((b for b in operand.domain.bases
                 if isinstance(b, SpinBasisMixin)
                 or getattr(b, "regularity", False)), None)
    if curv is not None:
        cs_coords = curv.coordsystem.coords
        selected = len(cs_coords) if coords is None \
            else sum(c in cs_coords for c in coords)
        if 0 < selected < len(cs_coords):
            raise NotImplementedError(
                f"Partial integration over a single coordinate of {curv!r} "
                "is not supported; integrate over the full coordinate "
                "system.")
        if selected and getattr(curv, "regularity", False):
            from .spherical3d import SphericalIntegrate
            out, volume = SphericalIntegrate(out), curv.volume
        elif selected:
            from .polar import PolarIntegrate
            out, volume = PolarIntegrate(out), curv.volume
    if coords is None:
        coords = [b.coord for b in out.domain.bases if b is not None]
    for coord in coords:
        basis = out.domain.get_basis(coord)
        if basis is not None:
            volume *= basis.bounds[1] - basis.bounds[0]
            out = IntegrateCartesian(out, coord)
    return out, volume


@parseable("integ", "Integrate")
def Integrate(operand, coords=None):
    if np.isscalar(operand):
        return operand
    return _integrate(operand, coords)[0]


class AzimuthalAverage(LinearOperator):
    """
    Average over the azimuth of a curvilinear basis (disk, annulus,
    sphere, shell, ball, or a circle edge): the m = 0 projection, identity on the m = 0 group and zero
    elsewhere (dedalus_tpu/core/operators.py:724; reference:
    core/basis.py:5202 AzimuthalAverage). The output is phi-constant on
    the same domain; its per-m blocks are constant, so it may stand on an
    equation's LHS.
    """

    name = "azavg"

    def __init__(self, operand, basis):
        self.basis = basis
        super().__init__(operand)

    def rebuild(self, new_args):
        return AzimuthalAverage(new_args[0], self.basis)

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = operand.tensorsig
        self.dtype = operand.dtype

    def terms(self):
        basis = self.basis
        if hasattr(basis, "group_m"):
            ms = np.asarray(basis.group_m())
            gs = basis.sub_group_shape(0)
        else:
            # 1-D azimuthal basis (S1 edge fields): group 0 is m = 0
            ms = np.arange(basis.n_groups)
            gs = basis.group_shape
        blocks = np.zeros((len(ms), gs, gs))
        blocks[ms == 0] = np.eye(gs)
        descrs = [None] * self.operand.domain.dim
        descrs[basis.first_axis] = ("blocks", blocks)
        return [(None, descrs)]


@parseable("azavg", "AzimuthalAverage")
def AzimuthalAverageFactory(operand, coord=None):
    """AzimuthalAverage over the azimuthal basis of `operand`: a circle,
    disk, annulus, sphere, shell or ball (the m = 0 blocks of its
    group_m(), dedalus_tpu/core/operators.py:769)."""
    if np.isscalar(operand):
        return operand
    if coord is not None:
        coord = _resolve_coord(operand, coord)
        if not isinstance(coord, AzimuthalCoordinate):
            raise ValueError("AzimuthalAverage requires an azimuthal "
                             "coordinate.")
        basis = operand.domain.get_basis(coord)
    else:
        def is_azimuthal(b):
            if b.dim >= 2:
                return isinstance(b.coordsystem.coords[0],
                                  AzimuthalCoordinate)
            return isinstance(getattr(b, "coord", None), AzimuthalCoordinate)
        basis = next((b for b in operand.domain.bases
                      if b is not None and is_azimuthal(b)), None)
    if basis is None:
        raise ValueError("Operand has no azimuthal basis.")
    return AzimuthalAverage(operand, basis)


@parseable("ave", "Average")
def Average(operand, coords=None):
    """Integral over the selected coordinates divided by their volume
    (the sphere's area 4 pi r^2, an interval's length)."""
    if np.isscalar(operand):
        return operand
    out, volume = _integrate(operand, coords)
    return out / volume


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


def LiftFactory(operand, basis, n):
    """Lift into `basis` via mode `n`: the spherical lift on a shell
    (core/spherical3d.SphericalLift), the polar lift on a disk or annulus
    (core/polar.PolarLift), else the Cartesian one
    (dedalus_tpu/core/operators.py:854)."""
    if getattr(basis, "regularity", False):
        from .spherical3d import SphericalLift
        return SphericalLift(operand, basis, n)
    if _polar_basis(basis):
        from .polar import PolarLift
        return PolarLift(operand, basis, n)
    return Lift(operand, basis, n)


parseables["lift"] = LiftFactory


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


class CartesianCurl(CartesianVectorOperator):
    """
    curl for 3D vectors; 2D vectors get the scalar curl
    (dedalus_tpu/core/operators.py:1090; reference: core/operators.py:3637
    Curl).
    """

    name = "Curl"

    def __init__(self, operand):
        self.cs = operand.tensorsig[0]
        super().__init__(operand)

    def rebuild(self, new_args):
        return CartesianCurl(new_args[0])

    def _vector_terms_for(self, operand, cs):
        dim = cs.dim
        raw = []
        if dim == 3:
            eps = np.zeros((3, 3, 3))
            for i, j, k in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
                eps[i, j, k] = 1.0
                eps[i, k, j] = -1.0
            for j, coord in enumerate(cs.coords):
                axis = operand.dist.get_axis(coord)
                basis = operand.domain.bases[axis]
                if basis is None:
                    continue
                tensor_factor = eps[:, j, :]  # (out_i, in_k)
                descrs = [None] * operand.domain.dim
                descrs[axis] = _diff_descr(basis)
                d_levels = {axis: 1} if isinstance(basis, Jacobi) else {}
                raw.append((tensor_factor, descrs, d_levels))
        elif dim == 2:
            # scalar curl: d_x u_y - d_y u_x
            for coord, sign, k in [(cs.coords[0], 1.0, 1),
                                   (cs.coords[1], -1.0, 0)]:
                axis = operand.dist.get_axis(coord)
                basis = operand.domain.bases[axis]
                if basis is None:
                    continue
                tensor_factor = np.zeros((1, 2))
                tensor_factor[0, k] = sign
                descrs = [None] * operand.domain.dim
                descrs[axis] = _diff_descr(basis)
                d_levels = {axis: 1} if isinstance(basis, Jacobi) else {}
                raw.append((tensor_factor, descrs, d_levels))
        else:
            raise ValueError("Curl requires 2D or 3D vectors.")
        return raw

    def _vector_terms(self):
        return self._vector_terms_for(self.operand, self.cs)

    def _build_metadata(self):
        operand = self.args[0]
        cs = self.cs
        if cs.dim == 3:
            tensorsig = tuple(operand.tensorsig)
        else:
            tensorsig = tuple(operand.tensorsig[1:])
        self._build_metadata_common(operand, cs, tensorsig)


# grad, div, lap and curl dispatch on the coordinate system: the polar
# and sphere systems' to the spin-ladder operators of core/polar.py, the
# spherical system's to the regularity operators of core/spherical3d.py,
# a curvilinear DirectProduct's to core/cylinder.py
# (dedalus_tpu/core/operators.py:1170-1245)

def _spin_cs(cs):
    return isinstance(cs, (PolarCoordinates, S2Coordinates))


def _spherical_cs(cs):
    return isinstance(cs, SphericalCoordinates)


def _product_cs(cs):
    return isinstance(cs, DirectProduct) and cs.curvilinear


@parseable("grad", "Gradient")
def Gradient(operand, cs=None):
    if np.isscalar(operand):
        return 0
    cs = cs or operand.dist.coordsystems[0]
    if _spherical_cs(cs):
        from .spherical3d import SphericalGradient
        return SphericalGradient(operand, cs)
    if _spin_cs(cs):
        from .polar import PolarGradient
        return PolarGradient(operand, cs)
    if _product_cs(cs):
        from .cylinder import CylinderGradient
        return CylinderGradient(operand, cs)
    return CartesianGradient(operand, cs)


@parseable("div", "Divergence")
def Divergence(operand, index=0):
    if np.isscalar(operand):
        return 0
    if _spherical_cs(operand.tensorsig[index]):
        from .spherical3d import SphericalDivergence
        return SphericalDivergence(operand, index)
    if _spin_cs(operand.tensorsig[index]):
        from .polar import PolarDivergence
        return PolarDivergence(operand, index)
    if _product_cs(operand.tensorsig[index]):
        from .cylinder import CylinderDivergence
        return CylinderDivergence(operand, index)
    return CartesianDivergence(operand, index)


@parseable("lap", "Laplacian")
def Laplacian(operand, cs=None):
    if np.isscalar(operand):
        return 0
    cs2 = cs or operand.dist.coordsystems[0]
    if _spherical_cs(cs2):
        from .spherical3d import SphericalLaplacian
        return SphericalLaplacian(operand, cs2)
    if _spin_cs(cs2):
        from .polar import PolarLaplacian
        return PolarLaplacian(operand, cs2)
    if _product_cs(cs2):
        from .cylinder import CylinderLaplacian
        return CylinderLaplacian(operand, cs2)
    return CartesianLaplacian(operand, cs)


@parseable("curl", "Curl")
def Curl(operand):
    if np.isscalar(operand):
        return 0
    if operand.tensorsig and _spherical_cs(operand.tensorsig[0]):
        from .spherical3d import SphericalCurl
        return SphericalCurl(operand)
    if operand.tensorsig and _product_cs(operand.tensorsig[0]):
        from .cylinder import CylinderCurl
        return CylinderCurl(operand)
    return CartesianCurl(operand)


class Skew(LinearOperator):
    """2D skew: (u, v) -> (-v, u) (reference: core/operators.py:2019)."""

    name = "Skew"

    def _build_metadata(self):
        operand = self.args[0]
        if operand.tensorsig[0].dim != 2:
            raise ValueError("Skew requires a 2D vector.")
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def terms(self):
        operand = self.operand
        rest = int(np.prod(operand.tshape[1:], dtype=int)) \
            if operand.tshape[1:] else 1
        R = np.array([[0.0, -1.0], [1.0, 0.0]])
        return [(np.kron(R, np.identity(rest)), [None] * operand.domain.dim)]


@parseable("skew", "Skew")
def SkewFactory(operand):
    """skew(u): the spin form on a disk, annulus or sphere basis
    (core/polar.PolarSkew), else the Cartesian rotation
    (dedalus_tpu/core/operators.py:1339)."""
    if any(isinstance(b, SpinBasisMixin) for b in operand.domain.bases):
        from .polar import PolarSkew
        return PolarSkew(operand)
    return Skew(operand)


@parseable("radial")
def Radial(operand, index=0):
    """The radial coordinate component of index `index` of a polar or
    spherical tensor (core/polar.PolarComponent,
    core/spherical3d.SphericalComponent;
    dedalus_tpu/core/operators.py:1347)."""
    if _spherical_cs(operand.tensorsig[index]):
        from .spherical3d import SphericalComponent
        return SphericalComponent(operand, "radial", index)
    from .polar import PolarComponent
    return PolarComponent(operand, "radial", index)


@parseable("azimuthal")
def Azimuthal(operand, index=0):
    """The azimuthal coordinate component of index `index` of a polar or
    spherical tensor (dedalus_tpu/core/operators.py:1355)."""
    if _spherical_cs(operand.tensorsig[index]):
        from .spherical3d import SphericalComponent
        return SphericalComponent(operand, "azimuthal", index)
    from .polar import PolarComponent
    return PolarComponent(operand, "azimuthal", index)


@parseable("angular")
def Angular(operand, index=0):
    """The angular (phi, theta) components of index `index` of a
    spherical tensor; the azimuthal component of a polar one
    (dedalus_tpu/core/operators.py:1388)."""
    if _spherical_cs(operand.tensorsig[index]):
        from .spherical3d import SphericalComponent
        return SphericalComponent(operand, "angular", index)
    from .polar import PolarComponent
    return PolarComponent(operand, "azimuthal", index)


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
    """Trace factory: the Q-intertwined spin metric on shell interiors
    (regularity components) and the (-,+) + (+,-) + (0,0) spin metric on
    their sphere fields, the spin metric (-,+) + (+,-) where the
    contracted polar or sphere indices are stored as spin components (the
    interiors and the circle edges), else the coordinate delta
    (dedalus_tpu/core/operators.py:1363)."""
    if np.isscalar(operand):
        return 0
    ts = operand.tensorsig
    if len(ts) >= 2 and _spherical_cs(ts[0]):
        from .spherical3d import (SphericalTrace, SphericalSpinTrace,
                                  spherical_basis_of)
        if spherical_basis_of(operand) is not None:
            return SphericalTrace(operand)
        # sphere (S2) fields store the 3-D spin components: the constant
        # spin metric contracts them
        return SphericalSpinTrace(operand)
    if len(ts) >= 2 and _spin_cs(ts[0]):
        from .polar import SpinTrace, S1SpinTransformMixin
        if any(isinstance(b, (SpinBasisMixin, S1SpinTransformMixin))
               for b in operand.domain.bases):
            return SpinTrace(operand)
    return TraceOperator(operand)


@parseable("transpose", "TransposeComponents")
def TransposeComponents(operand, indices=(0, 1)):
    """Swap two tensor indices (reference: core/operators.py:1849). The
    shell's regularity components need the per-ell intertwined transpose;
    everywhere else the coefficient components are a kron over indices
    and a plain permutation is exact (dedalus_tpu/core/operators.py:1276)."""
    if any(getattr(b, "regularity", False) for b in operand.domain.bases):
        from .spherical3d import SphericalTransposeComponents
        return SphericalTransposeComponents(operand, indices)
    return CartesianTransposeComponents(operand, indices)


class CartesianTransposeComponents(LinearOperator):
    """Swap two tensor indices: a permutation of the components
    (dedalus_tpu/core/operators.py:1287; reference:
    core/operators.py:1849)."""

    name = "TransposeComponents"

    def __init__(self, operand, indices=(0, 1)):
        self.indices = indices
        super().__init__(operand)

    def rebuild(self, new_args):
        return CartesianTransposeComponents(new_args[0], self.indices)

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
        tshape = operand.tshape
        n = int(np.prod(tshape, dtype=int))
        perm = np.arange(n).reshape(tshape)
        perm = np.swapaxes(perm, *self.indices).ravel()
        P = np.zeros((n, n))
        P[np.arange(n), perm] = 1.0
        return [(P, [None] * operand.domain.dim)]


class SphericalEllProduct(LinearOperator):
    """
    Multiplication by a function of the spherical-harmonic degree:
    out(ell) = ell_func(ell) * in(ell), diagonal in ell on sphere and
    shell bases (dedalus_tpu/core/operators.py:1404; reference:
    core/operators.py:4119 SphericalEllProduct, e.g. degree-dependent
    hyperdiffusion).
    """

    name = "SphericalEllProduct"

    def __init__(self, operand, cs, ell_func):
        self.cs = cs
        self.ell_func = ell_func
        super().__init__(operand)

    def rebuild(self, new_args):
        return SphericalEllProduct(new_args[0], self.cs, self.ell_func)

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = tuple(operand.tensorsig)
        self.dtype = operand.dtype

    def _sph_basis(self):
        from .sphere import SphereBasis
        for b in self.operand.domain.bases:
            if b is not None and (isinstance(b, SphereBasis)
                                  or getattr(b, "regularity", False)):
                return b
        raise ValueError("SphericalEllProduct requires a sphere or shell "
                         "basis.")

    def terms(self):
        basis = self._sph_basis()
        colat = basis.first_axis + 1
        vals = np.array([float(self.ell_func(ell))
                         for ell in range(basis.Ntheta)])
        descrs = [None] * self.operand.domain.dim
        descrs[colat] = ("blocks", vals.reshape(-1, 1, 1))
        return [(None, descrs)]


parseables["SphericalEllProduct"] = SphericalEllProduct


# ----------------------------------------------------------------------
# Grid-space nonlinear operators

def _torch_ufunc(np_ufunc):
    """The torch function of a numpy ufunc, by name (np.sqrt ->
    torch.sqrt; the JAX package's _jnp_ufunc table)."""
    fn = getattr(torch, np_ufunc.__name__, None)
    if fn is None:
        raise ValueError(f"No torch equivalent for ufunc {np_ufunc.__name__}")
    return fn


@parseable("advective_cfl", "AdvectiveCFL")
class AdvectiveCFL(Future):
    """
    Advective CFL frequency of a velocity field: sum over components of
    |u_i| / (local grid spacing), with Cartesian spacings (uniform
    Fourier, sin-theta Chebyshev; reference: core/operators.py:4306
    AdvectiveCFL + core/basis.py:6086-6215 cfl_spacing). Produces a
    scalar grid field; CFL flow tools reduce it to a timestep.
    """

    name = "AdvectiveCFL"
    natural_layout = "g"

    def __init__(self, operand, coords=None):
        if not operand.tensorsig:
            raise ValueError("AdvectiveCFL requires a vector (velocity) field.")
        super().__init__(operand)

    def rebuild(self, new_args):
        return AdvectiveCFL(new_args[0])

    @property
    def operand(self):
        return self.args[0]

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = ()
        self.dtype = operand.dtype

    def ev_impl(self, ctx):
        from ..extras.flow_tools import advective_cfl_frequency
        ug = ev(self.operand, ctx, "g")
        return advective_cfl_frequency(self.operand, ug)


class UnaryGridFunction(Future):
    """Pointwise grid-space function of a numpy ufunc, applied as its
    torch counterpart (reference: core/operators.py:504)."""

    name = "UnaryGridFunction"
    natural_layout = "g"

    def __init__(self, func, operand):
        self.func = func
        self._torch_func = _torch_ufunc(func)
        super().__init__(operand)

    def rebuild(self, new_args):
        return UnaryGridFunction(self.func, new_args[0])

    @property
    def operand(self):
        return self.args[0]

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = operand.tensorsig
        self.dtype = operand.dtype

    def __repr__(self):
        return f"{self.func.__name__}({self.args[0]})"

    __str__ = __repr__

    def ev_impl(self, ctx):
        return self._torch_func(ev(self.operand, ctx, "g"))

    def frechet_differential(self, variables, perturbations):
        """f(u) -> f'(u) du for the ufuncs with a derivative rule
        (dedalus_tpu/core/operators.py:1531)."""
        deriv_map = {
            np.exp: lambda x: UnaryGridFunction(np.exp, x),
            np.sin: lambda x: UnaryGridFunction(np.cos, x),
            np.cos: lambda x: -1 * UnaryGridFunction(np.sin, x),
            np.sinh: lambda x: UnaryGridFunction(np.cosh, x),
            np.cosh: lambda x: UnaryGridFunction(np.sinh, x),
            np.tanh: lambda x: 1 - UnaryGridFunction(np.tanh, x)**2,
            np.log: lambda x: x**(-1),
            np.sqrt: lambda x: (1 / 2) * x**(-1 / 2),
        }
        op = self.operand
        d_op = op.frechet_differential(variables, perturbations)
        if np.isscalar(d_op) and d_op == 0:
            return 0
        if self.func not in deriv_map:
            raise NotImplementedError(
                f"No derivative rule for {self.func.__name__}")
        return deriv_map[self.func](op) * d_op
