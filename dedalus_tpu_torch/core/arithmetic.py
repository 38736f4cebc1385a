"""
Arithmetic expression nodes (counterpart of dedalus_tpu/core/arithmetic.py:
the Cartesian products and the angularly constant polar NCCs): Add,
ScalarMultiply, MultiplyFields, DotProduct, Power.

Grid-space products are pointwise torch ops; LHS products with a
non-constant-coefficient (NCC) factor assemble multiplication matrices by
quadrature (tools.jacobi.multiplication_matrix; the annulus's
radial_multiplication_matrix; the disk's per-(m, spin) Zernike stacks); a
constant NCC factor (e.g. the unit vector in `b*ez`) becomes a
tensor-placement factor times a scalar. NCCs that vary with the azimuth of
a disk or annulus couple the m groups and are not carried yet: they raise
NotImplementedError.
"""

import numpy as np
import scipy.sparse as sp
import torch

from .field import Field
from .future import Future, ev
from .domain import Domain
from .basis import Jacobi
from ..tools.array import kron as sparse_kron, sparsify
from ..tools.exceptions import NonlinearOperatorError
from ..tools.general import is_complex_dtype

from .operators import operand_expression_matrices, ConvertNode
from .curvilinear import PAIR_J, component_spins


def _is_scalar(x):
    return np.isscalar(x) or (isinstance(x, np.ndarray) and x.ndim == 0)


def _max_basis(bases):
    out = None
    for b in bases:
        if b is None:
            continue
        if out is None:
            out = b
        elif isinstance(out, Jacobi) and isinstance(b, Jacobi):
            if (out.a0, out.b0, out.size, out.bounds) != (b.a0, b.b0, b.size, b.bounds):
                raise ValueError(f"Incompatible Jacobi bases: {out} vs {b}")
            if b.k > out.k:
                out = b
        elif type(out) is type(b) and hasattr(out, "family_key"):
            # two-axis bases of one family (disk, annulus) at two k levels
            if out.family_key != b.family_key:
                raise ValueError(f"Incompatible bases: {out} vs {b}")
            if getattr(b, "k", 0) > getattr(out, "k", 0):
                out = b
        elif out != b:
            raise ValueError(f"Incompatible bases along axis: {out} vs {b}")
    return out


def _union_domain(dist, operands):
    dim = dist.dim
    bases = []
    for axis in range(dim):
        axis_bases = [op.domain.bases[axis] for op in operands
                      if isinstance(op, (Field, Future))]
        bases.append(_max_basis(axis_bases))
    return Domain(dist, tuple(bases))


def _product_domain(dist, operands):
    """
    Output domain of a product. On a coupled (Jacobi) axis where BOTH
    operands carry a basis, a true multiplication happens and the output
    lives at BASE derivative level — matching the NCC matrices
    (multiplication_matrix with dk_out=-k in ProductBase._ncc_axis_matrices).
    Where only one operand has the axis basis, the other is a scalar factor
    along that axis and the derivative level survives.
    """
    ops = [op for op in operands if isinstance(op, (Field, Future))]
    bases = []
    for axis in range(dist.dim):
        axis_bases = [op.domain.bases[axis] for op in ops
                      if op.domain.bases[axis] is not None]
        merged = _max_basis(axis_bases)
        if len(axis_bases) > 1 and isinstance(merged, Jacobi):
            merged = merged.base_basis()
        elif len(axis_bases) > 1 and getattr(merged, "k", 0) \
                and hasattr(merged, "clone_with"):
            merged = merged.clone_with(k=0)
        bases.append(merged)
    return Domain(dist, tuple(bases))


def _promote_dtype(operands):
    dtypes = [op.dtype for op in operands if isinstance(op, (Field, Future))]
    dtypes += [np.asarray(op).dtype for op in operands if _is_scalar(op)]
    return np.result_type(*dtypes)


class Add(Future):
    """Addition (reference: core/arithmetic.py:50)."""

    name = "Add"
    natural_layout = "g"

    def __init__(self, *args):
        flat = []
        for a in args:
            if isinstance(a, Add):
                flat.extend(a.args)
            else:
                flat.append(a)
        super().__init__(*flat)

    def _build_metadata(self):
        operands = [a for a in self.args if isinstance(a, (Field, Future))]
        tensorsigs = {tuple(op.tensorsig) for op in operands}
        if len(tensorsigs) != 1:
            raise ValueError("Cannot add operands with different tensor signatures.")
        if any(_is_scalar(a) for a in self.args) and next(iter(tensorsigs)):
            raise ValueError("Cannot add scalars to tensor fields.")
        self.tensorsig = next(iter(tensorsigs))
        self.domain = _union_domain(self.dist, operands)
        self.dtype = _promote_dtype(self.args)

    def ev_impl(self, ctx):
        total = None
        for a in self.args:
            data = ev(a, ctx, "g") if isinstance(a, (Field, Future)) else a
            total = data if total is None else total + data
        return total

    def expression_matrices(self, subproblem, vars, **kw):
        out = {}
        for a in self.args:
            if _is_scalar(a):
                if a != 0:
                    raise NonlinearOperatorError("Nonzero constant on equation LHS.")
                continue
            term = a if tuple(a.domain.bases) == self.domain.bases else \
                ConvertNode(a, self.domain.bases)
            mats = operand_expression_matrices(term, subproblem, vars, **kw)
            for var, mat in mats.items():
                out[var] = out.get(var) + mat if var in out else mat
        return out

    def frechet_differential(self, variables, perturbations):
        # d(a + b) = da + db: the multilinear rule of Future would keep
        # the undifferentiated siblings
        out = 0
        for a in self.args:
            if isinstance(a, (Field, Future)):
                d = a.frechet_differential(variables, perturbations)
                if not (_is_scalar(d) and d == 0):
                    out = out + d
        return out


class ScalarMultiply(Future):
    """Multiplication by a scalar constant: linear, layout-agnostic."""

    name = "ScalarMul"

    def __init__(self, scalar, operand):
        self.scalar = scalar
        super().__init__(operand)

    def rebuild(self, new_args):
        return ScalarMultiply(self.scalar, new_args[0])

    @property
    def operand(self):
        return self.args[0]

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = operand.tensorsig
        self.dtype = np.result_type(operand.dtype, np.asarray(self.scalar).dtype)

    def __repr__(self):
        return f"({self.scalar}*{self.args[0]})"

    def ev(self, ctx, layout):
        key = (id(self), layout)
        if key in ctx.memo:
            return ctx.memo[key]
        out = self.scalar * ev(self.operand, ctx, layout)
        ctx.memo[key] = out
        return out

    def expression_matrices(self, subproblem, vars, **kw):
        mats = operand_expression_matrices(self.operand, subproblem, vars, **kw)
        return {var: self.scalar * mat for var, mat in mats.items()}

    def frechet_differential(self, variables, perturbations):
        d = self.operand.frechet_differential(variables, perturbations)
        if _is_scalar(d) and d == 0:
            return 0
        return ScalarMultiply(self.scalar, d)


def Multiply(a, b):
    """Multiplication factory (reference: core/arithmetic.py:257 Product)."""
    if _is_scalar(a) and _is_scalar(b):
        return a * b
    if _is_scalar(a):
        if a == 0:
            return 0
        if a == 1:
            return b
        return ScalarMultiply(a, b)
    if _is_scalar(b):
        if b == 0:
            return 0
        if b == 1:
            return a
        return ScalarMultiply(b, a)
    return MultiplyFields(a, b)


class ProductBase(Future):
    """Shared NCC machinery for Multiply/Dot: grid-space products that become
    linear matrices when one side has no problem variables."""

    natural_layout = "g"

    def _split_ncc(self, vars, layout=None):
        """Return (ncc_side_index, ncc_field, operand_expr)."""

        def contains_vars(x):
            if _is_scalar(x):
                return False
            if isinstance(x, Field):
                return x in vars
            return x.has(*vars)

        has = [contains_vars(a) for a in self.args]
        if all(has):
            raise NonlinearOperatorError(
                f"Nonlinear term on LHS: {self!r} has variables on both sides.")
        if not any(has):
            raise NonlinearOperatorError(f"LHS term {self!r} contains no variables.")
        op_index = has.index(True)
        ncc_index = 1 - op_index
        ncc = self.args[ncc_index]
        if not isinstance(ncc, Field):
            ncc = ncc.evaluate()
        # NCCs must be constant along axes the LAYOUT keeps separable for
        # group-diagonality; axes the layout coupled (forced by this very
        # NCC, see subsystems._ncc_forced_coupled_axes) build full
        # multiplication matrices instead. Without layout context, fall
        # back to the conservative basis-level check.
        for axis, basis in enumerate(ncc.domain.bases):
            if basis is None or basis.dim != 1:
                # two-axis (polar) NCC bases check their angular
                # constancy in their own assembly paths
                continue
            separable = (axis in layout.sep_widths) if layout is not None \
                else basis.separable
            if separable:
                raise NonlinearOperatorError(
                    "LHS coefficient fields must be constant along separable axes.")
        return ncc_index, ncc, self.args[op_index]

    def _ncc_axis_terms(self, ncc, comp_index, operand):
        """[(scalar, descrs)] kron terms multiplying by ncc component
        `comp_index`: a constant NCC is a scalar multiplier; an NCC varying
        along one Jacobi axis builds that axis's multiplication matrix; an
        angularly constant annulus NCC its radial multiplication matrix
        (an azimuthally varying one never gets here: the layout refuses
        it, subsystems._ncc_forced_coupled_axes)."""
        bases = list(ncc.domain.bases)
        if ncc.tensorsig and any(
                b is not None and b.dim > 1
                and hasattr(b, "radial_multiplication_matrix")
                for b in bases):
            raise NonlinearOperatorError(
                "Tensor-valued NCCs on curvilinear bases route through the "
                "spin assembly paths, not the per-axis path.")
        ccomp = np.asarray(ncc["c"])[comp_index]  # host transform of NCC data
        return [self._ncc_axis_matrices_from(ccomp, bases, operand)]

    def _ncc_axis_matrices_from(self, ccomp, ncc_bases, operand):
        """Per-axis matrices for a single-varying-axis coefficient array
        (`ncc_bases`: the NCC's per-axis basis list, None = constant)."""
        descrs = []
        axis = 0
        while axis < self.dist.dim:
            nb = ncc_bases[axis]
            ob = operand.domain.bases[axis]
            if nb is None:
                descrs.append(None)  # constant along axis: scalar handled below
                axis += 1
            elif isinstance(nb, Jacobi):
                # collapse other axes of the coefficient array
                ax_coeffs = np.moveaxis(ccomp, axis, -1)
                if ax_coeffs.size != ax_coeffs.shape[-1]:
                    raise NonlinearOperatorError(
                        "LHS NCCs varying along several axes are not "
                        "supported.")
                cut = self._ncc_sparsify_cutoff(ax_coeffs)
                if ob is None:
                    # operand constant along axis: column embedding the NCC
                    descrs.append(("full", sparsify(ax_coeffs.reshape(-1, 1),
                                                    cut)))
                else:
                    M = ob.multiplication_matrix(ax_coeffs.ravel(), nb, dk_out=-ob.k)
                    descrs.append(("full", sparsify(M, cut)))
                axis += 1
            elif nb.dim == 2 and hasattr(nb, "radial_multiplication_matrix"):
                # angularly constant annulus NCC: identity on the azimuth
                # (m=0 data only), a radial multiplication matrix on the
                # radius (dedalus_tpu/core/arithmetic.py:507)
                r_axis = axis + 1
                moved = np.moveaxis(ccomp, r_axis, -1)
                tol = 1e-10 * max(np.abs(ccomp).max(), 1e-300)
                non_const = moved.reshape(-1, moved.shape[-1])[1:]
                if non_const.size and np.abs(non_const).max() > tol:
                    raise NonlinearOperatorError(
                        "LHS coefficient fields on curvilinear bases must be "
                        "angularly constant (lowest angular mode only).")
                radial_coeffs = moved.reshape(-1, moved.shape[-1])[0]
                if ob is None:
                    raise NonlinearOperatorError(
                        "Embedding a curvilinear NCC into a constant operand "
                        "is not supported yet.")
                M = ob.radial_multiplication_matrix(radial_coeffs, nb.k,
                                                    k_out=0)
                descrs.append(None)  # azimuth identity
                descrs.append(("full", sparsify(
                    M, self._ncc_sparsify_cutoff(radial_coeffs))))
                axis += 2
            else:
                raise NonlinearOperatorError(
                    f"LHS NCCs may not vary along basis {nb!r}.")
        # fully-constant NCC: scalar multiplier
        if all(d is None for d in descrs):
            value = ccomp.ravel()[0]
            return (complex(value) if np.iscomplexobj(ccomp)
                    else float(value)), descrs
        return None, descrs

    def _polar_spin_basis(self, operand):
        """The disk or annulus basis of `operand`, or None."""
        from .polar import DiskBasis, AnnulusBasis
        for b in operand.domain.bases:
            if isinstance(b, (DiskBasis, AnnulusBasis)):
                return b
        return None

    def _disk_ncc_matrix(self, subproblem, ncc, operand, place_fn):
        """
        Pencil matrix of an angularly constant NCC on the DISK, scalar or
        tensor valued (dedalus_tpu/core/arithmetic.py:579). Zernike radial
        spaces are (m, spin)-dependent, so each coordinate component c of
        the NCC contributes per-m radial stacks bracketed by the spin
        coupling C = U_out P_c U_in^H:

            term(c, i, j) = C_ij * F_out(s_i)[m] diag(f_c) B_in(s_j)[m]

        assembled through ("gblocks", az, stack) descriptors. Profiles are
        sampled on the 2x radial quadrature grid through the field's own
        transforms. `place_fn(c)` gives the coordinate-space component
        placement (outer product or contraction).
        """
        from .curvilinear import recombination_matrix
        from .operators import assemble_group_matrix
        nb = self._polar_spin_basis(ncc)
        ob = self._polar_spin_basis(operand)
        if ob is None:
            raise NonlinearOperatorError(
                "Disk NCCs require the operand on the disk basis too.")
        cs = nb.cs
        az_axis = nb.first_axis
        r_axis = az_axis + 1
        dim = self.dist.dim
        # profiles on the 2x quadrature grid, via the field's transforms
        old_scales = ncc.scales
        ncc.change_scales(2)
        grid = np.asarray(ncc["g"])
        ncc.change_scales(old_scales)
        tdim_n = len(ncc.tensorsig)
        ncomp_n = int(np.prod(ncc.tshape, dtype=int)) if ncc.tshape else 1
        flat = grid.reshape((ncomp_n,) + grid.shape[tdim_n:])
        tol = 1e-10 * max(np.abs(flat).max(), 1e-300)
        moved = np.moveaxis(flat, 1 + az_axis, 1)
        if np.abs(moved - moved[:, :1]).max() > tol:
            raise NonlinearOperatorError(
                "LHS NCCs on disk bases must be angularly constant "
                "(sub-classifier azimuthal content at the data's own "
                "precision is treated as roundoff).")
        profiles = moved[:, 0].reshape(ncomp_n, -1)   # (ncomp_n, Ngr2)
        U_in = recombination_matrix(tuple(operand.tensorsig), cs)
        U_out = recombination_matrix(tuple(self.tensorsig), cs)
        s_in = component_spins(tuple(operand.tensorsig), cs)
        s_out = component_spins(tuple(self.tensorsig), cs)
        real = not is_complex_dtype(self.dtype)
        out_basis = self.domain.bases[az_axis]
        terms = []
        nonzero = [c for c in range(ncomp_n)
                   if np.abs(profiles[c]).max() > tol]
        for c in (nonzero or [0]):
            prof = profiles[c]
            C = U_out @ place_fn(c) @ U_in.conj().T
            for i in range(C.shape[0]):
                for j in range(C.shape[1]):
                    if abs(C[i, j]) < 1e-14 and nonzero:
                        continue
                    F = out_basis.radial_forward_stack(int(s_out[i]), 2.0)
                    B = ob.radial_backward_stack(int(s_in[j]), 2.0)
                    stack = np.einsum("gnr,r,grk->gnk", F, prof, B)
                    E = np.zeros((C.shape[0], C.shape[1]))
                    E[i, j] = 1.0
                    descrs = [None] * dim
                    if real:
                        az2 = (np.eye(2) * C[i, j].real
                               + PAIR_J * C[i, j].imag)
                        descrs[az_axis] = ("full", sparsify(az2, 1e-14))
                    else:
                        descrs[az_axis] = ("full", sp.csr_matrix(
                            np.array([[C[i, j]]])))
                    descrs[r_axis] = ("gblocks", az_axis, stack)
                    terms.append((E, descrs))
        return assemble_group_matrix(terms, operand.domain, operand.tshape,
                                     self.tshape, subproblem)

    def _polar_tensor_ncc_matrix(self, subproblem, ncc, operand, ncc_index):
        """
        Pencil matrix of a tensor-valued, angularly constant annulus NCC
        (e.g. the centrifugal-convection example's radial-vector gravity
        b*g; dedalus_tpu/core/arithmetic.py:799). The polar spin
        recombination U is m-independent, so each NCC COORDINATE component
        c with radial profile f_c(r) contributes
            (U_out P_c U_in^H)  (x)  angular-identity  (x)  RadialMult(f_c)
        with P_c placing component c in the coordinate component space.
        Real dtypes apply the complex component coupling jointly on the
        interleaved (cos, -sin) azimuth pair (real_pair_matrix).
        """
        from .curvilinear import recombination_matrix, real_pair_matrix
        from .operators import _axis_identity
        nb = self._polar_spin_basis(ncc)
        ob = self._polar_spin_basis(operand)
        if ob is None or not hasattr(ob, "radial_multiplication_matrix"):
            raise NonlinearOperatorError(
                "Tensor-valued polar NCCs require annulus bases on both "
                "factors (disk regularity spaces are not supported yet).")
        cs = nb.cs
        az_axis = nb.first_axis
        r_axis = az_axis + 1
        # angular constancy check on coordinate-component grid data, read
        # at scale 1 to match the radial forward matrix below
        old_scales = ncc.scales
        ncc.change_scales(1)
        grid = np.asarray(ncc["g"])
        ncc.change_scales(old_scales)
        ncomp_n = int(np.prod(ncc.tshape, dtype=int)) if ncc.tshape else 1
        flat = grid.reshape((ncomp_n,) + grid.shape[len(ncc.tshape):])
        tol = 1e-10 * max(np.abs(flat).max(), 1e-300)
        moved = np.moveaxis(flat, 1 + az_axis, 1)
        if np.abs(moved - moved[:, :1]).max() > tol:
            raise NonlinearOperatorError(
                "LHS tensor NCCs on polar bases must be angularly constant.")
        profiles = moved[:, 0].reshape(ncomp_n, -1)  # (ncomp_n, Nr)
        # radial coefficients of each component profile at the NCC's level
        fwd = np.asarray(nb._radial_forward_matrix(1.0))
        U_in = recombination_matrix(tuple(operand.tensorsig), cs)
        out_tsig = (tuple(ncc.tensorsig) + tuple(operand.tensorsig)
                    if ncc_index == 0
                    else tuple(operand.tensorsig) + tuple(ncc.tensorsig))
        U_out = recombination_matrix(out_tsig, cs)
        ncomp_op = U_in.shape[0]
        real = not is_complex_dtype(self.dtype)
        sep_widths = subproblem.layout.sep_widths
        nonzero = [c for c in range(ncomp_n)
                   if np.abs(profiles[c]).max() > tol]
        total = None
        for c in (nonzero or [0]):     # all-zero NCC: one zero term (shape)
            f_coeffs = fwd @ profiles[c]
            R = sparsify(ob.radial_multiplication_matrix(f_coeffs, nb.k,
                                                         k_out=0), 1e-12)
            P_c = np.zeros((ncomp_n, 1))
            P_c[c, 0] = 1.0
            place = (np.kron(P_c, np.eye(ncomp_op)) if ncc_index == 0
                     else np.kron(np.eye(ncomp_op), P_c))
            C = U_out @ place @ U_in.conj().T
            if real:
                # joint (component, azimuth-pair) real representation: the
                # azimuth slot is the (cos, -sin) pair, so the pair action
                # is absorbed into the leading factor; that holds while no
                # wider axis precedes the annulus in the pencil ordering
                wide = [ax for ax in range(az_axis)
                        if sep_widths.get(ax, 1) != 1]
                if wide:
                    raise NonlinearOperatorError(
                        "Tensor-valued polar NCCs with real dtype require "
                        "the annulus azimuth to lead the pencil ordering "
                        f"(axes {wide} precede it with width > 1).")
                T = sp.csr_matrix(real_pair_matrix(C))
            else:
                T = sp.csr_matrix(C)
            factors = [T]
            for axis in range(self.dist.dim):
                basisx = operand.domain.bases[axis]
                if axis == az_axis:
                    if not real:
                        factors.append(sp.identity(1, format="csr"))
                elif axis == r_axis:
                    factors.append(R)
                else:
                    sub = 0 if basisx is None else axis - basisx.first_axis
                    factors.append(_axis_identity(basisx,
                                                  sep_widths.get(axis), sub))
            mat = sparse_kron(*factors)
            total = mat if total is None else total + mat
        return total

    NCC_ANGULAR_CUTOFF = 1e-10

    @staticmethod
    def _ncc_real_eps(arr_or_dtype):
        """Machine epsilon of the SOURCE data precision. Accepts an array
        or a dtype; complex dtypes resolve to their real component. The
        source dtype matters because expansions get promoted to f64/c128
        on the host — the promotion launders the f32-level roundoff that
        the cutoffs must track."""
        if isinstance(arr_or_dtype, (np.dtype, type)):
            dt = np.dtype(arr_or_dtype)
        else:
            dt = np.asarray(arr_or_dtype).dtype
        dt = np.dtype(dt)
        if dt.kind == "c":
            dt = np.dtype(np.float32) if dt.itemsize == 8 \
                else np.dtype(np.float64)
        return np.finfo(dt).eps if dt.kind == "f" else 0.0

    @staticmethod
    def _ncc_sparsify_cutoff(arr_or_dtype):
        """Relative sparsify threshold for matrices BUILT from NCC data:
        f32-sourced coefficient vectors carry ~eps-relative junk in every
        entry, which would otherwise populate spurious matrix diagonals
        and defeat band detection."""
        return max(1e-12, 10 * ProductBase._ncc_real_eps(arr_or_dtype))

    @staticmethod
    def _ncc_data_cutoff(arr_or_dtype):
        """Relative significance cutoff for NCC data, scaled to the data's
        own precision (f32 data carries ~1e-7-relative roundoff in every
        coefficient)."""
        return max(ProductBase.NCC_ANGULAR_CUTOFF,
                   50 * ProductBase._ncc_real_eps(arr_or_dtype))

    @staticmethod
    def polar_azimuth_varies(ncc, basis):
        """Does a disk/annulus NCC vary with azimuth? Grid-space and
        dtype-aware, the classifier of the JAX package
        (dedalus_tpu/core/arithmetic.py:1099), shared by the layout
        (subsystems._ncc_forced_coupled_axes) and the term assembly."""
        grid = np.asarray(ncc["g"])
        az = len(ncc.tensorsig) + basis.first_axis
        moved = np.moveaxis(grid, az, 0)
        tol = (ProductBase._ncc_data_cutoff(grid)
               * max(np.abs(grid).max(), 1e-300))
        return bool(np.abs(moved - moved[:1]).max() > tol)

    def _assemble_ncc_matrix(self, subproblem, ncc, operand, tensor_factor_fn):
        """
        Sum over NCC components: kron(tensor_factor(comp), axis factors).
        `tensor_factor_fn(comp_index, value_is_scalar)` returns the sparse
        tensor factor for that component.
        """
        from .operators import _axis_identity
        operand_domain = operand.domain
        sep_widths = subproblem.layout.sep_widths
        total = None
        comp_indices = list(np.ndindex(*ncc.tshape)) if ncc.tshape else [()]
        for comp in comp_indices:
            for scalar, descrs in self._ncc_axis_terms(ncc, comp, operand):
                factors = [tensor_factor_fn(comp)]
                for axis, descr in enumerate(descrs):
                    ob = operand_domain.bases[axis]
                    if descr is None:
                        sub = 0 if ob is None else axis - ob.first_axis
                        factors.append(_axis_identity(ob,
                                                      sep_widths.get(axis),
                                                      sub))
                    else:
                        factors.append(descr[1])
                mat = sparse_kron(*factors)
                if scalar is not None:
                    mat = scalar * mat
                total = mat if total is None else total + mat
        return total


class MultiplyFields(ProductBase):
    """Pointwise (tensor outer) product (reference: core/arithmetic.py:822)."""

    name = "Mul"

    def _build_metadata(self):
        a, b = self.args
        self.tensorsig = tuple(a.tensorsig) + tuple(b.tensorsig)
        self.domain = _product_domain(self.dist, [a, b])
        self.dtype = _promote_dtype(self.args)

    def __repr__(self):
        return f"({self.args[0]}*{self.args[1]})"

    def ev_impl(self, ctx):
        a, b = self.args
        da = ev(a, ctx, "g")
        db = ev(b, ctx, "g")
        ta, tb = a.tdim, b.tdim
        da_x = da.reshape(da.shape[:ta] + (1,) * tb + da.shape[ta:])
        return da_x * db  # broadcasting over tensor + constant grid axes

    def expression_matrices(self, subproblem, vars, **kw):
        ncc_index, ncc, operand = self._split_ncc(vars, subproblem.layout)
        pol = self._polar_spin_basis(ncc)
        if pol is not None and (ncc.tensorsig or not hasattr(
                pol, "radial_multiplication_matrix")):
            if hasattr(pol, "radial_multiplication_matrix"):
                # annulus: spin-independent radial space, one matrix
                M = self._polar_tensor_ncc_matrix(subproblem, ncc, operand,
                                                  ncc_index)
            else:
                # disk: per-(m, spin) Zernike stacks
                n_n = int(np.prod(ncc.tshape, dtype=int)) if ncc.tshape else 1
                n_op = int(np.prod(operand.tshape, dtype=int)) \
                    if operand.tshape else 1

                def place(c):
                    P = np.zeros((n_n, 1))
                    P[c, 0] = 1.0
                    return (np.kron(P, np.eye(n_op)) if ncc_index == 0
                            else np.kron(np.eye(n_op), P))

                M = self._disk_ncc_matrix(subproblem, ncc, operand, place)
            op_mats = operand_expression_matrices(operand, subproblem, vars,
                                                  **kw)
            return {var: M @ mat for var, mat in op_mats.items()}
        ncomp_op = int(np.prod([cs.dim for cs in operand.tensorsig], dtype=int)) \
            if operand.tensorsig else 1
        ncomp_ncc_shape = ncc.tshape

        def tensor_factor(comp):
            # column selecting the ncc component within the output tensorsig
            n_ncc = int(np.prod(ncomp_ncc_shape, dtype=int)) if ncomp_ncc_shape else 1
            col = sp.lil_matrix((n_ncc, 1))
            flat = int(np.ravel_multi_index(comp, ncomp_ncc_shape)) if comp else 0
            col[flat, 0] = 1.0
            col = sp.csr_matrix(col)
            I_op = sp.identity(ncomp_op, format="csr")
            if ncc_index == 0:
                return sparse_kron(col, I_op)
            return sparse_kron(I_op, col)

        M = self._assemble_ncc_matrix(subproblem, ncc, operand, tensor_factor)
        op_mats = operand_expression_matrices(operand, subproblem, vars, **kw)
        return {var: M @ mat for var, mat in op_mats.items()}


class DotProduct(ProductBase):
    """
    Contraction of the last index of the first operand with the first index
    of the second (reference: core/arithmetic.py:586).
    """

    name = "Dot"

    def __init__(self, a, b):
        if _is_scalar(a) or _is_scalar(b):
            raise ValueError("DotProduct requires tensor operands.")
        if not a.tensorsig or not b.tensorsig:
            raise ValueError("DotProduct requires tensor operands.")
        if a.tensorsig[-1].dim != b.tensorsig[0].dim:
            raise ValueError("Contracted dimensions do not match.")
        super().__init__(a, b)

    def _build_metadata(self):
        a, b = self.args
        self.tensorsig = tuple(a.tensorsig[:-1]) + tuple(b.tensorsig[1:])
        self.domain = _product_domain(self.dist, [a, b])
        self.dtype = _promote_dtype(self.args)

    def __repr__(self):
        return f"({self.args[0]}@{self.args[1]})"

    @staticmethod
    def contraction_subscripts(ta, tb):
        """einsum subscripts contracting the left factor's LAST tensor
        index with the right factor's FIRST."""
        letters = "abcdefghijklm"
        l_sub = letters[:ta - 1] + "z" + "..."
        r_sub = "z" + letters[ta - 1:ta - 1 + tb - 1] + "..."
        o_sub = letters[:ta - 1] + letters[ta - 1:ta - 1 + tb - 1] + "..."
        return l_sub, r_sub, o_sub

    def ev_impl(self, ctx):
        a, b = self.args
        da = ev(a, ctx, "g")
        db = ev(b, ctx, "g")
        l_sub, r_sub, o_sub = self.contraction_subscripts(a.tdim, b.tdim)
        return torch.einsum(f"{l_sub},{r_sub}->{o_sub}", da, db)

    def expression_matrices(self, subproblem, vars, **kw):
        ncc_index, ncc, operand = self._split_ncc(vars, subproblem.layout)
        d = ncc.tensorsig[-1].dim if ncc_index == 0 else ncc.tensorsig[0].dim

        if ncc_index == 0:
            # out comps: ncc[:-1] + op[1:]; contraction over op's first index
            rest_op = operand.tshape[1:]
            n_rest_op = int(np.prod(rest_op, dtype=int)) if rest_op else 1
            lead_ncc = ncc.tshape[:-1]
            n_lead = int(np.prod(lead_ncc, dtype=int)) if lead_ncc else 1

            def tensor_factor(comp):
                *alpha, j = comp
                lead_flat = int(np.ravel_multi_index(tuple(alpha), lead_ncc)) if lead_ncc else 0
                col = sp.lil_matrix((n_lead, 1)); col[lead_flat, 0] = 1.0
                row = sp.lil_matrix((1, d)); row[0, j] = 1.0
                return sparse_kron(sp.csr_matrix(col), sp.csr_matrix(row),
                                   sp.identity(n_rest_op, format="csr"))
        else:
            # operand @ ncc: contract operand's last index with ncc's first
            lead_op = operand.tshape[:-1]
            n_lead_op = int(np.prod(lead_op, dtype=int)) if lead_op else 1
            rest_ncc = ncc.tshape[1:]
            n_rest = int(np.prod(rest_ncc, dtype=int)) if rest_ncc else 1

            def tensor_factor(comp):
                j, *beta = comp
                rest_flat = int(np.ravel_multi_index(tuple(beta), rest_ncc)) if rest_ncc else 0
                row = sp.lil_matrix((1, d)); row[0, j] = 1.0
                col = sp.lil_matrix((n_rest, 1)); col[rest_flat, 0] = 1.0
                return sparse_kron(sp.identity(n_lead_op, format="csr"),
                                   sp.csr_matrix(row), sp.csr_matrix(col))

        pol = self._polar_spin_basis(ncc)
        if pol is not None and not hasattr(pol, "radial_multiplication_matrix"):
            # disk contraction (e.g. pipe flow's u@grad(w0)): the same
            # coordinate placement feeds the per-(m, spin) stack path
            def place(cflat):
                comp = tuple(np.unravel_index(cflat, ncc.tshape))
                return np.asarray(tensor_factor(comp).toarray())
            M = self._disk_ncc_matrix(subproblem, ncc, operand, place)
            op_mats = operand_expression_matrices(operand, subproblem, vars,
                                                  **kw)
            return {var: M @ mat for var, mat in op_mats.items()}
        M = self._assemble_ncc_matrix(subproblem, ncc, operand, tensor_factor)
        op_mats = operand_expression_matrices(operand, subproblem, vars, **kw)
        return {var: M @ mat for var, mat in op_mats.items()}


class Power(Future):
    """Scalar field to a constant power (dedalus_tpu/core/arithmetic.py:
    1888), pointwise on the grid."""

    name = "Pow"
    natural_layout = "g"

    def __init__(self, base, exponent):
        if not _is_scalar(exponent):
            raise ValueError("Exponent must be a scalar constant.")
        self.exponent = exponent
        super().__init__(base)

    def rebuild(self, new_args):
        return Power(new_args[0], self.exponent)

    def _build_metadata(self):
        base = self.args[0]
        if base.tensorsig:
            raise ValueError("Power requires scalar fields.")
        self.domain = base.domain
        self.tensorsig = ()
        self.dtype = base.dtype

    def __repr__(self):
        return f"({self.args[0]}**{self.exponent})"

    def ev_impl(self, ctx):
        return ev(self.args[0], ctx, "g") ** self.exponent

    def frechet_differential(self, variables, perturbations):
        base = self.args[0]
        d = base.frechet_differential(variables, perturbations)
        if _is_scalar(d) and d == 0:
            return 0
        n = self.exponent
        return n * Power(base, n - 1) * d


# parseables
from .operators import parseables  # noqa: E402
parseables["dot"] = DotProduct
