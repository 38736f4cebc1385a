"""
Arithmetic expression nodes (counterpart of dedalus_tpu/core/arithmetic.py,
Cartesian subset): Add, ScalarMultiply, MultiplyFields, DotProduct.

Grid-space products are pointwise torch ops; LHS products with a
non-constant-coefficient (NCC) factor assemble multiplication matrices by
quadrature (tools.jacobi.multiplication_matrix); a constant NCC factor
(e.g. the unit vector in `b*ez`) becomes a tensor-placement factor times
a scalar.
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

from .operators import operand_expression_matrices, ConvertNode


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
            if basis is None:
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
        along one Jacobi axis builds that axis's multiplication matrix."""
        ccomp = np.asarray(ncc["c"])[comp_index]  # host transform of NCC data
        return [self._ncc_axis_matrices_from(ccomp, ncc.domain.bases, operand)]

    def _ncc_axis_matrices_from(self, ccomp, ncc_bases, operand):
        """Per-axis matrices for a single-varying-axis coefficient array
        (`ncc_bases`: the NCC's per-axis basis list, None = constant)."""
        descrs = []
        for axis in range(self.dist.dim):
            nb = ncc_bases[axis]
            ob = operand.domain.bases[axis]
            if nb is None:
                descrs.append(None)  # constant along axis: scalar handled below
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
            else:
                raise NonlinearOperatorError(
                    f"LHS NCCs may not vary along basis {nb!r}.")
        # fully-constant NCC: scalar multiplier
        if all(d is None for d in descrs):
            return float(ccomp.ravel()[0]), descrs
        return None, descrs

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

        M = self._assemble_ncc_matrix(subproblem, ncc, operand, tensor_factor)
        op_mats = operand_expression_matrices(operand, subproblem, vars, **kw)
        return {var: M @ mat for var, mat in op_mats.items()}


# parseables
from .operators import parseables  # noqa: E402
parseables["dot"] = DotProduct
