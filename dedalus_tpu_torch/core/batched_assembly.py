"""
Group-batched pencil matrix assembly.

The per-group path (subsystems.assemble_group_coo) walks the expression tree
once per pencil group with scipy kron/matmul calls — O(G) Python/scipy
overhead that dominates setup for separable problems (G can be 10^4-10^5).
This module assembles ALL groups at once by composing the operators' own
term descriptors (operators.py module docstring) symbolically:

    matrix = sum of terms; term = scalar * kron(tensor_factor, axis factors)
    axis factor = I(w) identity | D group-independent matrix
                | B(idx_axis, stack) per-group blocks indexed by the group
                  index of a separable axis ("blocks"/"gblocks")

Products of kron terms compose axis-wise ((A1 x A2)(B1 x B2) = A1B1 x A2B2),
so the whole expression tree reduces to a term list per variable WITHOUT any
per-group work; materialization then emits one shared COO pattern with a
(G, nnz) value matrix via vectorized gathers. The reference has no analogue
(its per-pencil scipy assembly is the direct counterpart of the slow path;
reference: core/subsystems.py:493-598 build_matrices).

Falls back (BatchUnsupported) for node types without batchable descriptors
(the polar tensor and disk NCCs, cross products, and the shell's NCCs on
an ell-coupled layout).

PARTIAL mode (`partial=True`, with `subproblems`): instead of abandoning
the whole system when one expression lacks batched terms, only THAT
expression drops to the per-group `operand_expression_matrices` walk; its
per-group entries are unioned onto the shared pattern alongside the
batched chunks. Layouts
with NCC-coupled separable axes are admitted here — descriptors on a
coupled axis convert to whole-axis block-diagonal matrices.
"""

import numpy as np
import scipy.sparse as sp

from .field import Field

__all__ = ["BatchUnsupported", "batched_system_coos"]


class BatchUnsupported(Exception):
    """Expression not representable as batched kron terms."""


# ----------------------------------------------------------------- factors
# Axis factor kinds: ("I", w) | ("D", mat) | ("B", idx_axis, stack)

def _dense(mat):
    return mat.toarray() if sp.issparse(mat) else np.asarray(mat)


def _factor_shape(f):
    kind = f[0]
    if kind == "I":
        return (f[1], f[1])
    if kind == "D":
        return f[1].shape
    return f[2].shape[1:]


def _factor_mul(f1, f2):
    """Axis-factor product f1 @ f2."""
    k1, k2 = f1[0], f2[0]
    if k1 == "I":
        return f2
    if k2 == "I":
        return f1
    if k1 == "D" and k2 == "D":
        m1, m2 = f1[1], f2[1]
        if sp.issparse(m1) or sp.issparse(m2):
            return ("D", sp.csr_matrix(m1) @ sp.csr_matrix(m2))
        return ("D", m1 @ m2)
    if k1 == "D" and k2 == "B":
        return ("B", f2[1], np.einsum("ij,gjk->gik", _dense(f1[1]), f2[2]))
    if k1 == "B" and k2 == "D":
        return ("B", f1[1], np.einsum("gij,jk->gik", f1[2], _dense(f2[1])))
    # B @ B
    if f1[1] != f2[1]:
        raise BatchUnsupported(
            f"Block factors indexed by different axes ({f1[1]} vs {f2[1]}).")
    return ("B", f1[1], np.einsum("gij,gjk->gik", f1[2], f2[2]))


class BTerm:
    """scalar * kron(tensor, factors[0], factors[1], ...)."""

    __slots__ = ("scalar", "tensor", "factors")

    def __init__(self, scalar, tensor, factors):
        self.scalar = scalar
        self.tensor = tensor    # None (identity) or dense (t_out, t_in)
        self.factors = factors  # list per distributor axis

    def matmul(self, other):
        if self.tensor is None:
            tensor = other.tensor
        elif other.tensor is None:
            tensor = self.tensor
        else:
            tensor = self.tensor @ other.tensor
        factors = [_factor_mul(a, b)
                   for a, b in zip(self.factors, other.factors)]
        return BTerm(self.scalar * other.scalar, tensor, factors)

    def scaled(self, scalar):
        return BTerm(self.scalar * scalar, self.tensor, self.factors)


def _coupled_blocks_matrix(stack, out_basis, in_basis):
    """
    Whole-axis matrix of a per-group "blocks" stack on a FORCE-COUPLED
    separable axis (the slot spans the whole axis, group-major):
    endomorphic blocks (both sides carry the axis) block-diagonalize;
    reductions (no output basis: integrate/interpolate rows) concatenate
    horizontally; embeddings (no operand basis) stack vertically.
    """
    blocks = [sp.csr_matrix(b) for b in stack]
    if out_basis is not None and in_basis is not None:
        return sp.block_diag(blocks, format="csr")
    if out_basis is None and in_basis is not None:
        if any(b.shape[0] != 1 for b in blocks):
            raise BatchUnsupported("coupled-axis reduction with >1 rows")
        return sp.hstack(blocks, format="csr")
    if out_basis is not None and in_basis is None:
        if any(b.shape[1] != 1 for b in blocks):
            raise BatchUnsupported("coupled-axis embedding with >1 cols")
        return sp.vstack(blocks, format="csr")
    raise BatchUnsupported("coupled-axis blocks without bases")


def _convert_descrs(layout, domain, terms, out_domain=None):
    """operators.terms() output -> [BTerm] (descr lists per axis).
    `domain` is the OPERAND's domain; `out_domain` (the expression's own
    domain) disambiguates reductions vs embeddings on coupled axes."""
    out = []
    for tensor_factor, axis_descrs in terms:
        tensor = None if tensor_factor is None else _dense(tensor_factor)
        factors = []
        for axis, descr in enumerate(axis_descrs):
            basis = domain.bases[axis]
            if descr is None:
                if axis in layout.sep_widths:
                    factors.append(("I", layout.sep_widths[axis]))
                elif basis is None:
                    factors.append(("I", 1))
                else:
                    # slot width of a coupled axis is the full coefficient
                    # size (subsystems.PencilLayout.slot_shape), including
                    # separable bases the layout force-coupled
                    factors.append(("I", basis.coeff_size(
                        axis - basis.first_axis)))
            else:
                kind = descr[0]
                if kind == "full":
                    factors.append(("D", descr[1]))
                elif kind == "blocks":
                    stack = np.asarray(descr[1])
                    if axis in layout.sep_widths:
                        factors.append(("B", axis, stack))
                    else:
                        out_basis = out_domain.bases[axis] \
                            if out_domain is not None else basis
                        factors.append(("D", _coupled_blocks_matrix(
                            stack, out_basis, basis)))
                elif kind == "gblocks":
                    _, group_axis, stack = descr
                    if group_axis not in layout.sep_widths:
                        raise BatchUnsupported(
                            f"gblocks indexed by coupled axis {group_axis}.")
                    factors.append(("B", group_axis, np.asarray(stack)))
                else:
                    raise BatchUnsupported(f"Descriptor kind {kind!r}.")
        out.append(BTerm(1.0, tensor, factors))
    return out


def _identity_terms(layout, operand):
    """Identity BTerm for a problem variable's slot space."""
    factors = []
    for axis, basis in enumerate(operand.domain.bases):
        if axis in layout.sep_widths:
            factors.append(("I", layout.sep_widths[axis]))
        elif basis is None:
            factors.append(("I", 1))
        else:
            factors.append(("I", basis.coeff_size(axis - basis.first_axis)))
    return [BTerm(1.0, None, factors)]


def _merge(into, other):
    for var, terms in other.items():
        into.setdefault(var, []).extend(terms)


def batched_expression_matrices(expr, layout, vars):
    """Compose the expression tree into {var: [BTerm]}."""
    from .operators import LinearOperator
    from .arithmetic import (Add, ScalarMultiply, ProductBase)
    if isinstance(expr, Field):
        if expr in vars:
            return {expr: _identity_terms(layout, expr)}
        raise BatchUnsupported(f"Field {expr} on LHS outside an NCC product.")
    if isinstance(expr, Add):
        from .operators import ConvertNode
        from ..tools.exceptions import NonlinearOperatorError
        out = {}
        for a in expr.args:
            if np.isscalar(a):
                if a != 0:
                    raise NonlinearOperatorError(
                        "Nonzero constant on equation LHS.")
                continue
            term = a if tuple(a.domain.bases) == expr.domain.bases else \
                ConvertNode(a, expr.domain.bases)
            _merge(out, batched_expression_matrices(term, layout, vars))
        return out
    if isinstance(expr, ScalarMultiply):
        sub = batched_expression_matrices(expr.operand, layout, vars)
        return {v: [t.scaled(expr.scalar) for t in ts] for v, ts in sub.items()}
    if isinstance(expr, ProductBase):
        return _batched_ncc_matrices(expr, layout, vars)
    if isinstance(expr, LinearOperator):
        if type(expr).expression_matrices is not LinearOperator.expression_matrices:
            raise BatchUnsupported(
                f"{type(expr).__name__} overrides expression_matrices.")
        op_terms = batched_expression_matrices(expr.operand, layout, vars)
        my_terms = _convert_descrs(layout, expr.operand.domain, expr.terms(),
                                   out_domain=expr.domain)
        out = {}
        for var, terms in op_terms.items():
            out[var] = [mt.matmul(ot) for mt in my_terms for ot in terms]
        return out
    raise BatchUnsupported(f"No batched matrices for {type(expr).__name__}.")


def _batched_spherical_ncc(expr, layout, vars, ncc_index, ncc, operand):
    """
    The shell's radial NCC products, batched over groups
    (dedalus_tpu/core/batched_assembly.py:240): the
    ell-dependent Q-intertwined coupling C_ij(ell) folds into per-ell
    radial stacks C_ij(ell) * M_ij(ell), leaving one BTerm per active
    regularity pair with a one-hot tensor factor and a colatitude-indexed
    "gblocks" radial factor.
    """
    basis = expr._spherical_regularity_basis(ncc)
    az_axis = basis.first_axis
    colat_axis = az_axis + 1
    r_axis = az_axis + 2
    # guard BEFORE the angularly-constant setup: on an ell-coupled layout
    # (theta-dependent NCC elsewhere in the system) this product assembles
    # through the per-group whole-axis path, and _sph_ncc_setup's
    # radial-only validation may legitimately reject it
    if colat_axis not in layout.sep_n_groups or \
            az_axis not in layout.sep_widths:
        raise BatchUnsupported("spherical NCC on a coupled angular axis")
    setup = expr._sph_ncc_setup(ncc, operand, ncc_index)
    Nell = layout.sep_n_groups[colat_axis]
    ncomp_in = 3 ** setup["rank_in"]
    ncomp_out = 3 ** (setup["rank_n"] + setup["rank_in"])
    # per-(i, j) stacks over ell
    stacks = {}
    for ell in range(Nell):
        for i, j, Cij, M in expr._sph_ncc_pairs(setup, ell):
            Md = _dense(M)
            stack = stacks.get((i, j))
            if stack is None:
                stack = stacks[(i, j)] = np.zeros((Nell,) + Md.shape)
            if Md.shape != stack.shape[1:]:
                raise BatchUnsupported(
                    f"Inconsistent radial NCC shapes across ell for pair "
                    f"({i}, {j}): {Md.shape} vs {stack.shape[1:]}.")
            stack[ell] = Cij * Md
    my_terms = []
    dim = operand.domain.dim
    for (i, j), stack in stacks.items():
        tensor = np.zeros((ncomp_out, ncomp_in))
        tensor[i, j] = 1.0
        factors = [("I", 1)] * dim
        factors[az_axis] = ("I", layout.sep_widths[az_axis])
        factors[colat_axis] = ("I", layout.sep_widths.get(colat_axis, 1))
        factors[r_axis] = ("B", colat_axis, stack)
        my_terms.append(BTerm(1.0, tensor, factors))
    op_terms = batched_expression_matrices(operand, layout, vars)
    out = {}
    for var, terms in op_terms.items():
        out[var] = [mt.matmul(ot) for mt in my_terms for ot in terms]
    return out


def _batched_ncc_matrices(expr, layout, vars):
    """NCC products (MultiplyFields/DotProduct/CrossProduct):
    group-independent axis matrices batch directly, the shell's radial
    NCCs via per-ell stacks; polar tensor and disk NCCs take the
    per-group path."""
    ncc_index, ncc, operand = expr._split_ncc(vars, layout)
    if expr._spherical_regularity_basis(ncc) is not None:
        return _batched_spherical_ncc(expr, layout, vars, ncc_index, ncc,
                                      operand)
    pol = expr._polar_spin_basis(ncc)
    if pol is not None and (ncc.tensorsig
                            or not hasattr(pol, "radial_multiplication_matrix")):
        # polar tensor NCCs (intertwiner sandwich) and disk NCCs (per-m
        # Zernike stacks) assemble through the per-group path
        raise BatchUnsupported("polar tensor/disk NCC")
    tensor_factor_fn = _ncc_tensor_factor_fn(expr, ncc, operand, ncc_index)
    comp_indices = list(np.ndindex(*ncc.tshape)) if ncc.tshape else [()]
    my_terms = []
    for comp in comp_indices:
        ncc_terms = expr._ncc_axis_terms(ncc, comp, operand)
        if len(ncc_terms) != 1:
            raise BatchUnsupported("jointly-varying (multi-axis) NCC")
        scalar, descrs = ncc_terms[0]
        bterms = _convert_descrs(layout, operand.domain,
                                 [(tensor_factor_fn(comp), descrs)],
                                 out_domain=expr.domain)
        if scalar is not None:
            bterms = [t.scaled(scalar) for t in bterms]
        my_terms.extend(bterms)
    op_terms = batched_expression_matrices(operand, layout, vars)
    out = {}
    for var, terms in op_terms.items():
        out[var] = [mt.matmul(ot) for mt in my_terms for ot in terms]
    return out


def _ncc_tensor_factor_fn(expr, ncc, operand, ncc_index):
    """The per-component tensor factor builders from arithmetic.py,
    reused via the classes' own closures."""
    from .arithmetic import MultiplyFields, DotProduct
    if isinstance(expr, MultiplyFields):
        ncomp_op = int(np.prod([cs.dim for cs in operand.tensorsig], dtype=int)) \
            if operand.tensorsig else 1
        shape = ncc.tshape

        def factor(comp):
            n_ncc = int(np.prod(shape, dtype=int)) if shape else 1
            col = np.zeros((n_ncc, 1))
            flat = int(np.ravel_multi_index(comp, shape)) if comp else 0
            col[flat, 0] = 1.0
            I_op = np.eye(ncomp_op)
            return np.kron(col, I_op) if ncc_index == 0 else np.kron(I_op, col)
        return factor
    if isinstance(expr, DotProduct):
        d = ncc.tensorsig[-1].dim if ncc_index == 0 else ncc.tensorsig[0].dim
        if ncc_index == 0:
            rest_op = operand.tshape[1:]
            n_rest_op = int(np.prod(rest_op, dtype=int)) if rest_op else 1
            lead_ncc = ncc.tshape[:-1]
            n_lead = int(np.prod(lead_ncc, dtype=int)) if lead_ncc else 1

            def factor(comp):
                *alpha, j = comp
                lead_flat = int(np.ravel_multi_index(tuple(alpha), lead_ncc)) \
                    if lead_ncc else 0
                col = np.zeros((n_lead, 1)); col[lead_flat, 0] = 1.0
                row = np.zeros((1, d)); row[0, j] = 1.0
                return np.kron(np.kron(col, row), np.eye(n_rest_op))
            return factor
        lead_op = operand.tshape[:-1]
        n_lead_op = int(np.prod(lead_op, dtype=int)) if lead_op else 1
        rest_ncc = ncc.tshape[1:]
        n_rest = int(np.prod(rest_ncc, dtype=int)) if rest_ncc else 1

        def factor(comp):
            j, *beta = comp
            rest_flat = int(np.ravel_multi_index(tuple(beta), rest_ncc)) \
                if rest_ncc else 0
            row = np.zeros((1, d)); row[0, j] = 1.0
            col = np.zeros((n_rest, 1)); col[rest_flat, 0] = 1.0
            return np.kron(np.kron(np.eye(n_lead_op), row), col)
        return factor
    raise BatchUnsupported(f"NCC tensor factors for {type(expr).__name__}.")


# ----------------------------------------------------------- materialization

def _factor_coo(f, group_idx):
    """Factor -> (rows, cols, vals) with vals (nnz,) or (G, nnz)."""
    kind = f[0]
    if kind == "I":
        w = f[1]
        r = np.arange(w)
        return r, r, np.ones(w)
    if kind == "D":
        coo = sp.coo_matrix(f[1])
        coo.eliminate_zeros()
        return coo.row, coo.col, coo.data
    _, idx_axis, stack = f
    union = np.abs(stack).max(axis=0) > 0
    rows, cols = np.nonzero(union)
    vals = stack[:, rows, cols][group_idx[idx_axis]]   # (G, nnz)
    return rows, cols, vals


def _kron_fold(parts):
    """Fold COO krons left to right; parts = [(shape, rows, cols, vals)]."""
    (m, n), rows, cols, vals = parts[0]
    for (m2, n2), r2, c2, v2 in parts[1:]:
        rows = (rows[:, None] * m2 + r2[None, :]).ravel()
        cols = (cols[:, None] * n2 + c2[None, :]).ravel()
        if vals.ndim == 1 and v2.ndim == 1:
            vals = (vals[:, None] * v2[None, :]).reshape(-1)
        else:
            a = vals if vals.ndim == 2 else vals[None, :]
            b = v2 if v2.ndim == 2 else v2[None, :]
            prod = a[:, :, None] * b[:, None, :]
            vals = prod.reshape(prod.shape[0], -1)
        m, n = m * m2, n * n2
    return (m, n), rows, cols, vals


def _materialize_term(term, group_idx, ncomp_in, ncomp_out):
    """BTerm -> ((R, C), rows, cols, vals (nnz,) or (G, nnz))."""
    parts = []
    if term.tensor is None:
        r = np.arange(ncomp_in)
        parts.append(((ncomp_in, ncomp_in), r, r, np.ones(ncomp_in)))
    else:
        t = np.asarray(term.tensor)
        rows, cols = np.nonzero(t)
        parts.append((t.shape, rows, cols, t[rows, cols]))
    for f in term.factors:
        shape = _factor_shape(f)
        rows, cols, vals = _factor_coo(f, group_idx)
        parts.append((shape, rows, cols, vals))
    shape, rows, cols, vals = _kron_fold(parts)
    if term.scalar != 1.0:
        vals = vals * term.scalar
    return shape, rows, cols, vals


def _pergroup_var_chunks(expr, subproblems, variables, act_groups, G, vdtype):
    """
    Per-group fallback of one expression (partial mode): walk
    `operand_expression_matrices` for each (active) group and union the
    per-group entries into shared-pattern chunks. Returns {var: (rows, cols, vals (G, nnz))}
    with rows/cols relative to the expression's own block.
    """
    from .operators import operand_expression_matrices
    vset = set(variables)
    sps = [subproblems[g] for g in act_groups]
    mats_list = [operand_expression_matrices(expr, spx, vset) for spx in sps]
    out = {}
    for var in {v for mats in mats_list for v in mats}:
        csrs = {}
        for g, mats in zip(act_groups, mats_list):
            if var in mats:
                m = sp.csr_matrix(mats[var])
                m.sum_duplicates()
                m.eliminate_zeros()
                csrs[g] = m
        if not csrs:
            continue
        ncols = next(iter(csrs.values())).shape[1]
        pat = None
        for m in csrs.values():
            p = m.copy()
            p.data = np.ones_like(p.data)
            pat = p if pat is None else pat + p
        pat = pat.tocoo()
        lin = pat.row.astype(np.int64) * ncols + pat.col
        order = np.argsort(lin)
        lin = lin[order]
        rows = pat.row[order].astype(int)
        cols = pat.col[order].astype(int)
        vals = np.zeros((G, lin.size), dtype=vdtype)
        for g, m in csrs.items():
            coo = m.tocoo()
            idx = np.searchsorted(
                lin, coo.row.astype(np.int64) * ncols + coo.col)
            vals[g, idx] = coo.data
        out[var] = (rows, cols, vals)
    return out


def batched_system_coos(layout, equations, variables, names,
                        subproblems=None, partial=False):
    """
    Assemble the full pencil system for all groups at once.

    Returns (pattern_rows, pattern_cols, {name: vals (G, nnz)},
    row_valid (G, S), col_valid (G, S)) — one shared COO pattern
    (duplicates summed) with per-group values; validity is applied by
    ZEROING values (pattern stays shared). No closure entries are added.
    Raises BatchUnsupported when any LHS expression lacks batched terms —
    unless `partial=True` (requires `subproblems`), where unbatchable
    expressions drop to the per-group walk individually and everything
    else stays vectorized (module docstring, PARTIAL mode).
    """
    from .subsystems import _system_sizes
    if partial and subproblems is None:
        raise ValueError("partial mode requires subproblems")
    if getattr(layout, "forced_coupled", None) and not partial:
        # NCC-coupled separable axes build whole-axis multiplication
        # matrices; their group structure is not batchable (and is tiny —
        # typically G=1), so use the per-group walk
        raise BatchUnsupported("layout has NCC-coupled separable axes")
    var_offsets, eq_sizes, S = _system_sizes(layout, equations, variables)
    groups = list(layout.groups())
    G = len(groups)
    # per-separable-axis group index arrays
    group_idx = {ax: np.array([g[ax] for g in groups], dtype=int)
                 for ax in layout.sep_axes}
    ncomps = {}

    def ncomp(tsig):
        key = tuple(tsig)
        if key not in ncomps:
            ncomps[key] = int(np.prod([cs.dim for cs in key], dtype=int)) \
                if key else 1
        return ncomps[key]

    complex_problem = any(np.issubdtype(np.dtype(v.dtype), np.complexfloating)
                          for v in variables)
    vdtype = np.complex128 if complex_problem else np.float64

    # validity masks, vectorized over groups
    from .subsystems import row_valid_masks
    col_valid = np.concatenate(
        [layout.valid_masks_all(v.domain, v.tensorsig) for v in variables],
        axis=1)
    row_valid = row_valid_masks(layout, equations).astype(bool)

    # member activity masks for conditioned equations
    def member_activity(cond):
        if cond is None:
            return None
        return np.array([cond(g) for g in groups], dtype=float)

    var_index = {v: i for i, v in enumerate(variables)}
    # Collect per-name COO chunks on the shared row/col space; one shared
    # pattern across names is built by merging tagged chunks at the end.
    chunks = []  # (name, rows, cols, vals)
    for eq, esize, row0 in zip(equations, eq_sizes,
                               np.concatenate([[0], np.cumsum(eq_sizes)[:-1]])):
        members = eq["members"] if "members" in eq else [(eq, None)]
        activities = [member_activity(cond) for _, cond in members]
        if len(members) > 1:
            # each group has at most one active member: overlapping
            # conditions would silently SUM members' rows here
            counts = np.sum([np.ones(G) if a is None else a
                             for a in activities], axis=0)
            if counts.max() > 1:
                bad = groups[int(np.argmax(counts))]
                raise ValueError(
                    f"Multiple conditioned equations active for group {bad}: "
                    f"{[m.get('LHS_str') for m, _ in members]}")
        for (member, cond), activity in zip(members, activities):
            for name in names:
                expr = member.get(name)
                if expr is None or (np.isscalar(expr) and expr == 0):
                    continue
                staged = []
                try:
                    bmats = batched_expression_matrices(expr, layout,
                                                        set(variables))
                    for var, terms in bmats.items():
                        c0 = var_offsets[var_index[var]]
                        n_in = ncomp(var.tensorsig)
                        n_out = ncomp(eq["tensorsig"])
                        for term in terms:
                            shape, r, c, v = _materialize_term(
                                term, group_idx, n_in, n_out)
                            if v.ndim == 1:
                                v = np.broadcast_to(v, (G, v.size))
                            if activity is not None:
                                v = v * activity[:, None]
                            staged.append((name, r + row0, c + c0, v))
                    chunks.extend(staged)
                except BatchUnsupported:
                    if not partial:
                        raise
                    # per-group walk of just this expression; only groups
                    # where the member is active are assembled (others
                    # contribute structural zeros, like activity masking)
                    act = np.arange(G) if activity is None \
                        else np.flatnonzero(activity)
                    pg = _pergroup_var_chunks(expr, subproblems, variables,
                                              act, G, vdtype)
                    for var, (r, c, v) in pg.items():
                        c0 = var_offsets[var_index[var]]
                        chunks.append((name, r + row0, c + c0, v))

    if not chunks:
        raise BatchUnsupported("No assembled entries.")
    # Shared pattern: union over all chunks/names
    all_rows = np.concatenate([r for _, r, _, _ in chunks])
    all_cols = np.concatenate([c for _, _, c, _ in chunks])
    lin = all_rows.astype(np.int64) * S + all_cols
    uniq, inverse = np.unique(lin, return_inverse=True)
    nnz = uniq.size
    pattern_rows = (uniq // S).astype(int)
    pattern_cols = (uniq % S).astype(int)
    out_vals = {name: np.zeros((G, nnz), dtype=vdtype) for name in names}
    pos = 0
    for name, r, c, v in chunks:
        idx = inverse[pos:pos + r.size]
        pos += r.size
        np.add.at(out_vals[name], (slice(None), idx), v)
    # validity: zero invalid entries (pattern stays shared)
    keep = (row_valid[:, pattern_rows] & col_valid[:, pattern_cols])
    for name in names:
        out_vals[name] *= keep
    return pattern_rows, pattern_cols, out_vals, row_valid, col_valid
