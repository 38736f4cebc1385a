"""
Pencil layout and subproblem matrix assembly (counterpart of
dedalus_tpu/core/subsystems.py).

ALL pencil groups form one uniform batch:

  * every variable occupies a fixed-size slot per group —
    (ncomp, group_shape per separable axis, coupled size or 1) — so the
    pencil matrices stack into a banded (G, S, S) batch (pencil index =
    leading batch dimension);
  * invalid slots (the reference's valid_modes masks, core/basis.py:1123)
    are zeroed and closed with identity rows, keeping every group the same
    shape instead of ragged per-group sizes;
  * gather/scatter between field coefficient tensors and the (G, S) state
    are torch reshapes/permutes (reference: core/subsystems.py:336-367
    gather_inputs/scatter_inputs).

The structural analysis and the band scatter are host code, identical to
the JAX package's, so both packages assemble the same arrays.
"""

import numpy as np
import scipy.sparse as sp
import torch

from .field import Field
from ..tools.array import zeropad


def _ncc_forced_coupled_axes(variables, equations):
    """
    Axes that LHS non-constant coefficients vary along: products on the
    matrix expressions whose non-variable factor has a basis on an
    otherwise-separable axis couple that axis's groups (the reference
    handles this by making such subproblems non-separable).
    """
    from .arithmetic import ProductBase
    from .future import Future
    vset = set(variables)

    def contains_vars(x):
        if isinstance(x, Field):
            return x in vset
        if isinstance(x, Future):
            return x.has(*vset)
        return False

    forced = set()

    def walk(expr):
        if not isinstance(expr, Future):
            return
        if isinstance(expr, ProductBase):
            sides = [a for a in expr.args if isinstance(a, (Field, Future))]
            ncc_sides = [a for a in sides if not contains_vars(a)]
            if len(ncc_sides) == 1:
                for axis, basis in enumerate(ncc_sides[0].domain.bases):
                    if basis is None:
                        continue
                    sub = axis - basis.first_axis
                    if basis.sub_separable(sub):
                        forced.add(axis)
        for a in expr.args:
            if isinstance(a, Future):
                walk(a)

    for eq in equations:
        for key in ("M", "L"):
            expr = eq.get(key)
            if isinstance(expr, Future):
                walk(expr)
    return forced


class PencilLayout:
    """Global pencil structure shared by all subproblems of a problem."""

    def __init__(self, dist, variables, equations):
        self.dist = dist
        dim = dist.dim
        sep_basis = [None] * dim      # (basis, sub_axis)
        coupled_basis = [None] * dim  # (basis, sub_axis)
        self.forced_coupled = _ncc_forced_coupled_axes(variables, equations)
        domains = [v.domain for v in variables] + [eq["domain"] for eq in equations]
        for domain in domains:
            for axis, basis in enumerate(domain.bases):
                if basis is None:
                    continue
                sub = axis - basis.first_axis
                if basis.sub_separable(sub) and axis not in self.forced_coupled:
                    if sep_basis[axis] is None:
                        sep_basis[axis] = (basis, sub)
                    else:
                        cur, csub = sep_basis[axis]
                        if (cur.sub_n_groups(csub) != basis.sub_n_groups(sub)
                                or cur.sub_group_shape(csub) != basis.sub_group_shape(sub)):
                            raise ValueError(f"Mismatched separable bases on axis {axis}")
                else:
                    cur = coupled_basis[axis]
                    if cur is None or getattr(basis, "k", 0) > getattr(cur[0], "k", 0):
                        coupled_basis[axis] = (basis, sub)
        self.sep_axes = [ax for ax in range(dim) if sep_basis[ax] is not None]
        self.sep_bases = {ax: sep_basis[ax][0] for ax in self.sep_axes}
        self.sep_widths = {ax: sep_basis[ax][0].sub_group_shape(sep_basis[ax][1])
                           for ax in self.sep_axes}
        self.coupled_axes = [ax for ax in range(dim) if coupled_basis[ax] is not None]
        self.group_counts = [sep_basis[ax][0].sub_n_groups(sep_basis[ax][1])
                             for ax in self.sep_axes]
        self.sep_n_groups = dict(zip(self.sep_axes, self.group_counts))
        self.n_groups = int(np.prod(self.group_counts, dtype=int)) if self.sep_axes else 1

    def groups(self):
        """Iterate full-length per-axis group tuples."""
        dim = self.dist.dim
        if not self.sep_axes:
            yield (None,) * dim
            return
        for multi in np.ndindex(*self.group_counts):
            group = [None] * dim
            for ax, g in zip(self.sep_axes, multi):
                group[ax] = int(g)
            yield tuple(group)

    # ------------------------------------------------------------ slots

    def slot_shape(self, domain, tensorsig):
        """(ncomp, *per-axis slot sizes) — uniform across groups."""
        tshape = tuple(cs.dim for cs in tensorsig)
        ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
        sizes = []
        for axis, basis in enumerate(domain.bases):
            if axis in self.sep_widths:
                sizes.append(self.sep_widths[axis])
            elif basis is None:
                sizes.append(1)
            else:
                sizes.append(basis.coeff_size(axis - basis.first_axis))
        return (ncomp,) + tuple(sizes)

    def slot_size(self, domain, tensorsig):
        return int(np.prod(self.slot_shape(domain, tensorsig), dtype=int))

    def valid_mask(self, domain, tensorsig, group):
        """
        Validity of each slot entry for one group (bool, slot_shape).
        Component-resolved: curvilinear bases mask per tensor component
        (spin/regularity validity, reference: core/basis.py:1780,3183).
        """
        shape = self.slot_shape(domain, tensorsig)
        mask = np.ones(shape, dtype=bool)
        handled = set()
        for axis, basis in enumerate(domain.bases):
            if basis is None:
                ax_len = shape[1 + axis]
                ax_mask = np.ones(ax_len, dtype=bool)
                if axis in self.sep_widths:
                    ax_mask[:] = False
                    if group[axis] == 0:
                        ax_mask[0] = True
                view = [np.newaxis] * len(shape)
                view[1 + axis] = slice(None)
                mask = mask & ax_mask[tuple(view)]
            elif id(basis) not in handled:
                handled.add(id(basis))
                bmask = basis.component_valid_mask(tensorsig, group, self.sep_widths)
                # bmask: (ncomp, *sizes over the basis's axes); place its
                # dims at the basis's axes and broadcast over the rest
                first = basis.first_axis
                full = [bmask.shape[0]] + [1] * len(domain.bases)
                for sub in range(basis.dim):
                    full[1 + first + sub] = bmask.shape[1 + sub]
                mask = mask & bmask.reshape(full)
        return mask

    def valid_masks_all(self, domain, tensorsig):
        """
        (G, slot_size) bool validity for ALL groups at once. For interval
        (1D) bases the mask factorizes over axes — per-axis mask stacks are
        built once (one call per distinct axis-group index) and folded with
        vectorized outer products. Multi-axis (curvilinear) bases couple
        group indices across axes, so those domains fall back to the
        per-group `valid_mask` loop (their group counts are small).
        """
        cache = self.__dict__.setdefault("_valid_masks_cache", {})
        key = (domain, tuple(tensorsig))
        if key in cache:
            return cache[key]
        groups = list(self.groups())
        G = len(groups)
        if any(b is not None and b.dim > 1 for b in domain.bases):
            out = np.stack([self.valid_mask(domain, tensorsig, g).ravel()
                            for g in groups])
            cache[key] = out
            return out
        tshape = tuple(cs.dim for cs in tensorsig)
        ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
        group_idx = {ax: np.array([g[ax] for g in groups], dtype=int)
                     for ax in self.sep_axes}
        out = np.ones((G, ncomp, 1), dtype=bool)
        for axis, basis in enumerate(domain.bases):
            if axis in self.sep_widths:
                Ga = self.sep_n_groups[axis]
                w = self.sep_widths[axis]
                if basis is None:
                    stack = np.zeros((Ga, ncomp, w), dtype=bool)
                    stack[0, :, 0] = True
                else:
                    probe = [None] * self.dist.dim
                    rows = []
                    for ga in range(Ga):
                        probe[axis] = ga
                        rows.append(basis.component_valid_mask(
                            tensorsig, tuple(probe), self.sep_widths))
                    stack = np.stack(rows).reshape(Ga, ncomp, w)
                axm = stack[group_idx[axis]]           # (G, ncomp, w)
            elif basis is None:
                axm = np.ones((1, ncomp, 1), dtype=bool)
            else:
                probe = (None,) * self.dist.dim
                m = basis.component_valid_mask(tensorsig, probe,
                                               self.sep_widths)
                axm = np.asarray(m).reshape(1, ncomp, -1)
            out = (out[:, :, :, None]
                   & axm[:, :, None, :]).reshape(G, ncomp, -1)
        out = out.reshape(G, -1)
        cache[key] = out
        return out

    # ------------------------------------------------- device gather/scatter

    def gather(self, array, domain, tensorsig):
        """
        (tensor..., coeff...) device tensor -> (G, slot) with constant
        separable axes zero-embedded at (group 0, element 0).
        """
        tshape = tuple(cs.dim for cs in tensorsig)
        tdim = len(tshape)
        ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
        data = array.reshape((ncomp,) + array.shape[tdim:])
        # expand/embed separable axes
        new_shape = [ncomp]
        group_positions = []
        pos = 1
        for axis, basis in enumerate(domain.bases):
            size = data.shape[1 + axis]
            if axis in self.sep_widths:
                gs = self.sep_widths[axis]
                G = self.sep_n_groups[axis]
                if basis is None:
                    pad = [(0, 0)] * data.ndim
                    pad[1 + axis] = (0, G * gs - size)
                    data = zeropad(data, pad)
                new_shape.extend([G, gs])
                group_positions.append(pos)
                pos += 2
            else:
                new_shape.append(size)
                pos += 1
        data = data.reshape(new_shape)
        # move group axes to the front (in separable-axis order)
        perm = group_positions + [i for i in range(data.ndim) if i not in group_positions]
        data = data.permute(perm)
        G_total = self.n_groups
        return data.reshape(G_total, -1)

    def scatter(self, pencils, domain, tensorsig):
        """(G, slot) -> (tensor..., coeff...); inverse of `gather`."""
        tshape = tuple(cs.dim for cs in tensorsig)
        ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
        # Rebuild the transposed intermediate shape
        group_dims = []
        slot_dims = [ncomp]
        for axis, basis in enumerate(domain.bases):
            if axis in self.sep_widths:
                group_dims.append(self.sep_n_groups[axis])
                slot_dims.append(self.sep_widths[axis])
            elif basis is None:
                slot_dims.append(1)
            else:
                slot_dims.append(basis.coeff_size(axis - basis.first_axis))
        data = pencils.reshape(group_dims + slot_dims)
        nG = len(group_dims)
        # inverse permutation: groups back next to their pair dims
        perm = []
        gi = 0
        si = nG  # position of ncomp
        perm.append(si)
        si += 1
        for axis, basis in enumerate(domain.bases):
            if axis in self.sep_widths:
                perm.append(gi)
                perm.append(si)
                gi += 1
                si += 1
            else:
                perm.append(si)
                si += 1
        data = data.permute(perm)
        # merge (G, gs) pairs and slice off constant-axis embeddings
        out_shape = []
        slices = []
        dims = list(data.shape)
        di = 1
        merged = [dims[0]]
        for axis, basis in enumerate(domain.bases):
            if axis in self.sep_widths:
                merged.append(dims[di] * dims[di + 1])
                di += 2
            else:
                merged.append(dims[di])
                di += 1
        data = data.reshape(merged)
        for axis, basis in enumerate(domain.bases):
            if axis in self.sep_widths and basis is None:
                slices.append(slice(0, 1))
            else:
                slices.append(slice(None))
        data = data[(slice(None),) + tuple(slices)]
        return data.reshape(tshape + data.shape[1:])


class Subproblem:
    """One pencil group (reference: core/subsystems.py:234 Subproblem)."""

    def __init__(self, layout, group, index):
        self.layout = layout
        self.group = group      # full-length per-axis tuple
        self.index = index      # flat group index

    def field_size(self, operand):
        return self.layout.slot_size(operand.domain, operand.tensorsig)


def build_subproblems(layout):
    return [Subproblem(layout, group, i) for i, group in enumerate(layout.groups())]


def merge_conditional_equations(equations, dist, layout):
    """
    Convert the raw equation list into row BLOCKS: unconditioned equations
    keep their own block; conditioned equations with identical (bases,
    tensor signature) pack into shared blocks whose active member is
    chosen per pencil group by evaluating the condition over separable
    group indices named 'n' + coordinate name (reference:
    core/subsystems.py:527-541 per-group equation conditions). Packing is
    greedy over the per-group activity vectors, so independent
    complementary pairs (e.g. conditioned BCs at both boundaries) occupy
    separate blocks and each block has at most one active member per group.

    Each block is an eq-like dict ({"domain", "tensorsig", "members"}) and,
    for single-member blocks, passes through M/L/F/residual keys.
    """
    groups = list(layout.groups())
    names = {f"n{coord.name}": coord.axis for coord in dist.coords}
    blocks = []
    by_key = {}
    for eq in equations:
        condition = eq.get("condition")
        if condition is None:
            block = dict(eq)
            block["members"] = [(eq, None)]
            blocks.append(block)
            continue
        code = compile(condition, "<equation condition>", "eval")

        def make_fn(code=code):
            def fn(group):
                env = {name: group[axis] for name, axis in names.items()
                       if group[axis] is not None}
                return bool(eval(code, {}, env))
            return fn

        fn = make_fn()
        activity = np.array([fn(g) for g in groups], dtype=bool)
        key = (tuple(eq["domain"].bases), tuple(eq["tensorsig"]))
        placed = False
        for block, taken in by_key.get(key, []):
            if not (taken & activity).any():
                block["members"].append((eq, fn))
                taken |= activity
                placed = True
                break
        if not placed:
            block = {"domain": eq["domain"], "tensorsig": eq["tensorsig"],
                     "members": [(eq, fn)]}
            by_key.setdefault(key, []).append((block, activity.copy()))
            blocks.append(block)
    return blocks


def active_member(block, group):
    """The block's active equation for `group` (None if none active)."""
    actives = [eq for eq, cond in block["members"]
               if cond is None or cond(group)]
    if len(actives) > 1:
        raise ValueError(
            f"Multiple conditioned equations active for group {group}: "
            f"{[eq.get('LHS_str') for eq in actives]}")
    return actives[0] if actives else None


def block_valid_mask(layout, eq, group):
    """Flat row validity of one equation block at one group: the active
    member's mask, or all-invalid when no member's condition holds."""
    if active_member(eq, group) is None:
        size = layout.slot_size(eq["domain"], eq["tensorsig"])
        return np.zeros(size, dtype=bool)
    return layout.valid_mask(eq["domain"], eq["tensorsig"], group).ravel()


def assemble_group_coos(subproblem, equations, variables, names):
    """
    All matrices of one pencil group in COO form, duplicates summed, with
    invalid rows and columns dropped and the enumeration-order identity
    closure of the invalid slots on the last name (the dense path's
    convention): the per-group walk of an eigenvalue problem too large
    for the batched store (dedalus_tpu/core/subsystems.py:498-571).
    Returns {name: (rows, cols, vals)}.
    """
    from .operators import operand_expression_matrices
    layout, group = subproblem.layout, subproblem.group
    var_offsets, eq_sizes, S = _system_sizes(layout, equations, variables)
    col_valid = np.concatenate([
        layout.valid_mask(v.domain, v.tensorsig, group).ravel()
        for v in variables])
    row_valid = np.concatenate([block_valid_mask(layout, eq, group)
                                for eq in equations])
    if col_valid.sum() != row_valid.sum():
        raise ValueError(
            f"Invalid row/column mismatch in group {group}: "
            f"{row_valid.sum()} valid rows vs {col_valid.sum()} valid "
            "columns.")
    out = {}
    for name in names:
        rows_l, cols_l, vals_l = [], [], []
        row0 = 0
        for eq, esize in zip(equations, eq_sizes):
            active = active_member(eq, group)
            expr = active.get(name) if active is not None else None
            if expr is not None and not (np.isscalar(expr) and expr == 0):
                mats = operand_expression_matrices(expr, subproblem,
                                                   variables)
                for vi, var in enumerate(variables):
                    if var in mats:
                        coo = sp.coo_matrix(mats[var])
                        rows_l.append(coo.row + row0)
                        cols_l.append(coo.col + var_offsets[vi])
                        vals_l.append(coo.data)
            row0 += esize
        rows = np.concatenate(rows_l) if rows_l else np.zeros(0, dtype=int)
        cols = np.concatenate(cols_l) if cols_l else np.zeros(0, dtype=int)
        vals = np.concatenate(vals_l) if vals_l else np.zeros(0)
        keep = row_valid[rows] & col_valid[cols]
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        if name == names[-1]:
            rows = np.concatenate([rows, np.flatnonzero(~row_valid)])
            cols = np.concatenate([cols, np.flatnonzero(~col_valid)])
            vals = np.concatenate([vals, np.ones((~row_valid).sum())])
        mat = sp.csr_matrix((vals, (rows, cols)), shape=(S, S))
        mat.sum_duplicates()
        coo = mat.tocoo()
        out[name] = (coo.row, coo.col, coo.data)
    return out


def _system_sizes(layout, equations, variables):
    var_sizes = [layout.slot_size(v.domain, v.tensorsig) for v in variables]
    var_offsets = np.concatenate([[0], np.cumsum(var_sizes)])
    S = int(var_offsets[-1])
    eq_sizes = [layout.slot_size(eq["domain"], eq["tensorsig"]) for eq in equations]
    R = int(np.sum(eq_sizes))
    if R != S:
        raise ValueError(f"Pencil system is not square: {R} equation rows for "
                         f"{S} variable columns.")
    return var_offsets, eq_sizes, S


class MatrixStructure:
    """
    Structural analysis of the pencil system enabling the banded + pinned
    Woodbury device solve (reference: the pre_left/pre_right
    bandwidth-minimizing permutations, core/subsystems.py:556-598,610-674,
    and the Woodbury bordered solve, libraries/matsolvers.py:285-316).

    The permutation interleaves all coupled-axis modes (mode-major:
    Modes > Equations/Variables > Components, matching the reference's
    interleave_components ordering). A maximum bipartite matching between
    coupled-equation rows and ALL columns — on the "qualified" pattern of
    entries present in every group where their row/column is valid —
    assigns each matched row the position of its matched column, making
    every banded diagonal structurally nonzero in every group. Dense rows
    (BCs, gauges) and unmatched rows are replaced by identity "pin" rows
    at leftover column positions, with their true content restored by a
    rank-t Woodbury correction. Pinning the low-mode coefficients removes
    the exponentially ill-conditioned null directions a boundary-row
    Schur complement would create (the pinned matrix's condition number
    matches the full tau system's).
    """

    def __init__(self, layout, variables, equations):
        self.layout = layout
        caxes = list(layout.coupled_axes)
        self.ok = len(caxes) in (1, 2)
        self.reason = None if self.ok else \
            f"{len(caxes)} coupled axes (banded supports 1 or 2)"
        if not self.ok:
            return
        var_offsets, eq_sizes, S = _system_sizes(layout, equations, variables)
        self.S = S
        self.n_caxes = len(caxes)

        def base_order(items):
            """items: [(domain, tensorsig)] -> (by_mode, uncoupled) indices.
            With two coupled axes (e.g. Chebyshev x Chebyshev, reference:
            core/subsystems.py:493-598 sparse coupled sets), modes are the
            FLATTENED (outer, inner) coupled slots — the banded machinery
            then sees one super-axis whose band is wide but whose occupied
            diagonals stay sparse (kron structure)."""
            by_mode = None
            uncoupled = []
            offset = 0
            for domain, tsig in items:
                shape = layout.slot_shape(domain, tsig)
                n_slots = int(np.prod(shape))
                present = [ax for ax in caxes if domain.bases[ax] is not None]
                if not present:
                    uncoupled.extend(range(offset, offset + n_slots))
                elif len(present) < len(caxes):
                    # partial extent (e.g. an x-boundary tau field on a
                    # 2-coupled-axis domain): modes along the missing axis
                    # collapse; treat every slot as uncoupled (pinned)
                    uncoupled.extend(range(offset, offset + n_slots))
                else:
                    Nc = int(np.prod([shape[1 + ax] for ax in caxes]))
                    if by_mode is None:
                        by_mode = [[] for _ in range(Nc)]
                    elif len(by_mode) != Nc:
                        self.ok = False
                        self.reason = "mismatched coupled sizes"
                        return None, None
                    idx = np.arange(n_slots).reshape(shape)
                    idx = np.moveaxis(idx, [1 + ax for ax in caxes],
                                      list(range(len(caxes))))
                    idx = idx.reshape(Nc, -1)
                    for m in range(Nc):
                        by_mode[m].extend((offset + idx[m]).tolist())
                offset += n_slots
            return by_mode, uncoupled

        cols_by_mode, cols_unc = base_order(
            [(v.domain, v.tensorsig) for v in variables])
        rows_by_mode, rows_unc = base_order(
            [(eq["domain"], eq["tensorsig"]) for eq in equations])
        if not self.ok:
            return
        if cols_by_mode is None or rows_by_mode is None:
            self.ok = False
            self.reason = "no coupled-extent slots"
            return
        self._rows_int = np.array([i for m in rows_by_mode for i in m])
        self._rows_unc = np.array(rows_unc, dtype=int)
        self.n_modes = len(rows_by_mode)
        # inner-axis mode count (window sizing for 2-coupled-axis systems)
        self._inner_modes = 1
        if self.n_caxes == 2:
            for v in variables:
                if all(v.domain.bases[ax] is not None for ax in caxes):
                    shape = layout.slot_shape(v.domain, v.tensorsig)
                    self._inner_modes = shape[1 + caxes[-1]]
                    break
        self._cols_by_mode = cols_by_mode
        self._cols_unc = np.array(cols_unc, dtype=int)
        self._row_mode = -np.ones(S, dtype=int)
        for m, rows in enumerate(rows_by_mode):
            self._row_mode[rows] = m

    def finalize(self, union_pat, qual_pat, row_valid_all, col_valid_all,
                 vmax=None, band_cutoff=0.5, min_blocks=2,
                 allow_uneconomic=False):
        """
        Complete the structure from sparsity patterns (scipy bool CSR, SxS,
        original ordering) and per-group validity masks (G, S). Sets
        self.ok; on success defines row_perm, pinned rows, and band sizes.
        """
        if not self.ok:
            return self
        S = self.S
        # Place each uncoupled (tau) column at the mode of the rows that
        # reference it, so tau entries stay near the diagonal (the
        # reference's tau_left placement generalized per-column).
        pu_all = sp.coo_matrix(union_pat)
        col_key = {}
        for c in self._cols_unc:
            modes = self._row_mode[pu_all.row[pu_all.col == c]]
            modes = modes[modes >= 0]
            col_key[int(c)] = int(np.median(modes)) if len(modes) \
                else self.n_modes - 1
        unc_by_mode = [[] for _ in range(self.n_modes)]
        for c in self._cols_unc:
            unc_by_mode[col_key[int(c)]].append(int(c))
        self.col_perm = np.array(
            [c for m in range(self.n_modes)
             for c in list(self._cols_by_mode[m]) + unc_by_mode[m]],
            dtype=int)
        # mode of each permuted column position (outer-block matching)
        self._col_pos_mode = np.array(
            [m for m in range(self.n_modes)
             for _ in list(self._cols_by_mode[m]) + unc_by_mode[m]],
            dtype=int)
        pos_col = np.argsort(self.col_perm)
        # Stage A: greedy structural matching of coupled-equation rows to
        # columns. Rows are processed from the highest mode down, each
        # taking its highest-OFFSET significant qualified candidate (within
        # a mode window): aligning on the principal part (highest
        # derivative) makes the banded elimination a stable downward
        # coefficient recurrence — lower-offset terms (k^2, mass) act as
        # bounded perturbations — while aligning on a lower-offset term
        # leaves the principal term as an unstable upward forcing (the
        # exponentially ill-conditioned truncations measured in testing).
        # Top-down greed leaves the unmatched (pinned) columns at LOW
        # modes, where coefficient-pinning is well-conditioned — the
        # homogeneous solutions a boundary-row replacement must suppress
        # have O(1) low coefficients but exponentially small high ones.
        qual_r = qual_pat[self._rows_int][:, self.col_perm]
        if vmax is not None:
            qual_r = vmax[self._rows_int][:, self.col_perm].multiply(qual_r)
        Q = sp.coo_matrix(qual_r)
        window = 16 * max(8, len(self._rows_int) // self.n_modes)
        if getattr(self, "n_caxes", 1) > 1:
            # two flattened coupled axes: outer-axis couplings sit a full
            # inner extent apart, so the matching window must span them
            window = min(window * max(self._inner_modes, 1), self.S)
        near = np.abs(Q.col - Q.row) <= window
        Qr = sp.csr_matrix((Q.data[near], (Q.row[near], Q.col[near])),
                           shape=Q.shape)
        nr = len(self._rows_int)
        match = -np.ones(nr, dtype=int)
        col_taken = np.zeros(S, dtype=bool)
        indptr, indices, data = Qr.indptr, Qr.indices, Qr.data
        # With two flattened coupled axes, stability requires a CONSISTENT
        # alignment choice. For NCC-forced couplings (ell-coupled shell/
        # ball problems) the principal operator is the inner (radial) one:
        # every outer-axis (dl != 0) coupling is a physical side term
        # (Coriolis, anisotropic conductivity, ...) whose magnitude can be
        # anything — aligning on it turns the block elimination into an
        # exponentially growing outer recurrence (1/Ekman-scaled Coriolis
        # entries defeated a magnitude gate). So restrict each row's
        # candidates to columns in its OWN outer-mode block (exact mode
        # comparison; flat-offset windows leak neighbouring blocks). Two
        # GENUINE coupled bases (a rectangle's Dxx vs Dzz) are same-order
        # principals and keep the plain highest-offset rule.
        ncc_forced = bool(getattr(self.layout, "forced_coupled", None))
        outer_match = (getattr(self, "n_caxes", 1) > 1 and ncc_forced)
        if outer_match:
            inner = max(self._inner_modes, 1)
            cand_outer = self._col_pos_mode // inner
        for i in range(nr - 1, -1, -1):
            cand = indices[indptr[i]:indptr[i + 1]]
            w = data[indptr[i]:indptr[i + 1]]
            free = ~col_taken[cand]
            if free.any():
                cand, w = cand[free], w[free]
                sig = w >= 1e-10 * w.max()
                cand = cand[sig]
                if outer_match:
                    row_outer = self._row_mode[self._rows_int[i]] // inner
                    near = cand_outer[cand] == row_outer
                    if near.any():
                        cand = cand[near]
                c = cand.max()
                match[i] = c
                col_taken[c] = True
        row_pos = -np.ones(S, dtype=int)     # orig row index -> position
        row_pos[self._rows_int] = match       # position = matched col position
        # leftover rows pair with leftover positions by validity signature
        # (so validity closure stays aligned with the pinning)
        left_rows = np.concatenate([self._rows_int[match < 0], self._rows_unc])
        filled = np.zeros(S, dtype=bool)
        filled[match[match >= 0]] = True
        left_positions = np.flatnonzero(~filled)
        if len(left_rows) != len(left_positions):
            self.ok = False
            self.reason = "matching bookkeeping mismatch"
            return self
        row_sig = {r: row_valid_all[:, r].tobytes() for r in left_rows}
        col_sig = {p: col_valid_all[:, self.col_perm[p]].tobytes()
                   for p in left_positions}
        from collections import defaultdict
        by_sig_rows = defaultdict(list)
        by_sig_pos = defaultdict(list)
        for r in left_rows:
            by_sig_rows[row_sig[r]].append(int(r))
        for p in left_positions:
            by_sig_pos[col_sig[p]].append(int(p))
        if set(by_sig_rows) != set(by_sig_pos) or any(
                len(by_sig_rows[s]) != len(by_sig_pos[s]) for s in by_sig_rows):
            self.ok = False
            self.reason = "validity signatures of pins do not pair"
            return self
        pinned_rows = []
        pinned_positions = []
        for sig in by_sig_rows:
            rs = sorted(by_sig_rows[sig])
            ps = sorted(by_sig_pos[sig])
            pinned_rows.extend(rs)
            pinned_positions.extend(ps)
        order = np.argsort(pinned_positions)
        self.pinned_rows = np.array(pinned_rows, dtype=int)[order]
        self.pinned_positions = np.array(pinned_positions, dtype=int)[order]
        row_pos[self.pinned_rows] = self.pinned_positions
        if (row_pos < 0).any():
            self.ok = False
            self.reason = "row placement incomplete"
            return self
        self.row_pos = row_pos                      # orig row -> position
        self.row_perm = np.argsort(row_pos)         # position -> orig row
        self.n_interior = S
        self.t_pins = len(self.pinned_rows)
        # validity alignment of matched rows (guaranteed by the qualified
        # pattern: entry present wherever either endpoint is valid)
        matched = np.ones(S, dtype=bool)
        matched[self.pinned_rows] = False
        mrows = np.flatnonzero(matched)
        if not np.array_equal(row_valid_all[:, mrows],
                              col_valid_all[:, self.col_perm[row_pos[mrows]]]):
            self.ok = False
            self.reason = "validity misalignment on matched rows"
            return self
        # band extent from union pattern of matched (true-banded) rows
        pu = sp.coo_matrix(union_pat)
        keep = matched[pu.row]
        pr, pc = row_pos[pu.row[keep]], pos_col[pu.col[keep]]
        if len(pr) == 0:
            self.ok = False
            self.reason = "empty banded pattern"
            return self
        d = pc - pr
        self.kl = int(max(-d.min(), 0))
        self.ku = int(max(d.max(), 0))
        nd = self.kl + self.ku + 1
        # Block size constraints of the windowed-pivoting factorization
        # (pencilops.BandedOps): pivot window needs kl <= q; the block
        # tridiagonal carries ku <= 2q-1; fill width needs kl+ku <= 2q.
        # The smallest q satisfying these minimizes factor storage, which
        # scales linearly in q.
        q = max(self.kl, -(-(self.ku + 1) // 2), -(-(self.kl + self.ku) // 2), 1)
        self.q = int(-(-q // 8) * 8) if q > 8 else max(q, 1)
        self.NB = -(-S // self.q)
        # Caps. The lattice width (nd) may legitimately be large for two
        # flattened coupled axes (kron terms land a full inner extent
        # apart) — what the per-step matvec unrolls is the number of
        # OCCUPIED diagonals, so cap that; the relative cap rejects
        # structures where the blocked factorization (storage ~ 4 S q)
        # cannot beat dense (~ S^2).
        from ..tools.config import config
        max_diags = int(config["linear algebra"].get(
            "BANDED_MAX_DIAGS", "384"))
        n_occ = len(np.unique(d))
        uneconomic = (8 * self.q > S) and not allow_uneconomic
        if (nd > band_cutoff * S or n_occ > max_diags
                or self.NB < min_blocks or uneconomic):
            self.ok = False
            self.reason = (f"band too wide ({n_occ} occupied of {nd} "
                           f"diagonals for S={S}, q={self.q})")
        if self.t_pins > max(64, 0.25 * S):
            self.ok = False
            self.reason = f"too many pinned rows ({self.t_pins} of {S})"
        return self


class PatternAccumulator:
    """
    Accumulates per-group sparsity evidence for the structural analysis:
    `union` of all real entries (band extent), and entry counts + per-row
    validity counts yielding the "qualified" pattern — entries present in
    every group where their row is valid — which is what the no-pivot
    block LU needs on its diagonal.
    """

    def __init__(self, S):
        self.S = S
        self.union = None
        self.count = None
        self.vmax = None
        self.n_row_valid = np.zeros(S, dtype=np.int64)
        self.n_col_valid = np.zeros(S, dtype=np.int64)

    def add_group(self, coos, row_valid, col_valid):
        rows = np.concatenate([c[0] for c in coos.values()])
        cols = np.concatenate([c[1] for c in coos.values()])
        vals = np.concatenate([np.abs(c[2]) for c in coos.values()])
        pat = sp.csr_matrix((np.ones(len(rows), dtype=np.int64), (rows, cols)),
                            shape=(self.S, self.S))
        pat.sum_duplicates()
        pat.data[:] = 1
        vm = sp.csr_matrix((vals, (rows, cols)), shape=(self.S, self.S))
        if self.union is None:
            self.union = pat.astype(bool)
            self.count = pat
            self.vmax = vm
        else:
            self.union = (self.union + pat.astype(bool)).astype(bool)
            self.count = self.count + pat
            self.vmax = self.vmax.maximum(vm)
        self.n_row_valid += row_valid
        self.n_col_valid += col_valid

    def qualified(self):
        """Entries present in every group where their row is valid AND in
        every group where their column is valid — safe no-pivot diagonals
        whose validity closure aligns with the matching."""
        coo = self.count.tocoo()
        keep = ((coo.data >= self.n_row_valid[coo.row])
                & (coo.data >= self.n_col_valid[coo.col]))
        return sp.csr_matrix(
            (np.ones(keep.sum(), dtype=bool), (coo.row[keep], coo.col[keep])),
            shape=(self.S, self.S))


def compute_group_closure(structure, row_valid, col_valid):
    """
    Identity-closure placement for one group's invalid slots, aligned with
    the structure: every invalid row closes at the column whose position it
    occupies (its matched column, or its pin column), which is a diagonal
    entry of the permuted system. The structure's signature pairing
    guarantees that column is invalid in exactly the same groups.
    Returns (rows, cols).
    """
    st = structure
    inv_rows = np.flatnonzero(~row_valid)
    cols = st.col_perm[st.row_pos[inv_rows]]
    if col_valid[cols].any():
        return None  # should not happen given finalize's signature checks
    return inv_rows, cols


def build_banded_arrays(coo_store, structure, names, dtype, drop_tol=0.0,
                        closures=None):
    """
    Scatter per-group COO matrices into banded + pinned-row storage:
    matched rows' entries go to the (G, D, n_pad) diagonal bands at their
    positions; pinned rows' true content goes to Vt (G, t, n_pad) for the
    Woodbury correction (the identity pins themselves are injected at
    factor time, not stored, so the per-name arrays represent the TRUE
    matrices and matvec needs no special casing).

    `closures` optionally supplies per-group (rows, cols) identity-closure
    entries (value 1.0) for the LAST name, kept out of the COO store so
    the batched-assembly path's SHARED pattern survives — when all groups
    share one (rows, cols) pattern the scatter vectorizes over the whole
    group batch instead of looping (the loop dominated large builds).
    Returns {name: {"bands": ..., "Vt": ...}}.
    """
    st = structure
    G = len(coo_store)
    n_pad = st.NB * st.q
    nd = st.kl + st.ku + 1
    pos_col = np.argsort(st.col_perm)
    pin_index = -np.ones(st.S, dtype=int)
    pin_index[st.pinned_rows] = np.arange(st.t_pins)

    def masks_for(rows, cols, oob_max):
        """(mb, mv, d, pr, pc, pi) for one (rows, cols) pattern; raises on
        a genuine out-of-band entry, drops sub-tolerance ones. `oob_max`
        maps an out-of-band index mask to the max |value| there (called
        only when out-of-band entries exist, so the common all-in-band
        build never materializes an abs temp)."""
        pi = pin_index[rows]
        pr, pc = st.row_pos[rows], pos_col[cols]
        mb = pi < 0               # entries of banded (non-pinned) rows
        mv = ~mb                  # entries of pinned rows
        d = pc - pr + st.kl
        oob = mb & ((d < 0) | (d >= nd))
        if oob.any():
            # sub-tolerance out-of-band entries (excluded from the
            # detected pattern) are dropped; anything larger is a
            # genuine structure violation
            if oob_max(oob) > drop_tol:
                raise ValueError("Entry outside detected band")
            mb = mb & ~oob
        return mb, mv, d, pr, pc, pi

    out = {}
    for name in names:
        is_last = (closures is not None and name == names[-1])
        if is_last:
            # vectorized closure entries: concatenated (g, row, col),
            # value 1.0 (closure columns are the matched diagonal, always
            # in band; closure rows may be pinned)
            cl_g = np.concatenate([np.full(len(c[0]), g, dtype=int)
                                   for g, c in enumerate(closures)])
            cl_rows = np.concatenate([c[0] for c in closures])
            cl_cols = np.concatenate([c[1] for c in closures])
            cl = masks_for(cl_rows, cl_cols, lambda oob: np.inf)
        r0, c0, _ = coo_store[0][name]
        shared = all(coo_store[g][name][0] is r0
                     and coo_store[g][name][1] is c0 for g in range(G))
        if shared:
            vals_all = np.stack([coo_store[g][name][2] for g in range(G)])
            mb, mv, d, pr, pc, pi = masks_for(
                r0, c0, lambda oob: np.abs(vals_all[:, oob]).max(initial=0.0))
            # assemble straight into TRIMMED storage: only the occupied
            # diagonals are allocated (dsel maps stored rows to the full
            # 0..nd-1 lattice), skipping the (G, nd, n_pad) host lattice
            # and the trim copy to_device would otherwise pay
            dsel = np.unique(np.concatenate(
                [d[mb], [st.kl]] + ([cl[2][cl[0]]] if is_last else [])))
            remap = np.zeros(nd, dtype=int)
            remap[dsel] = np.arange(len(dsel))
            bands = np.zeros((G, len(dsel), n_pad), dtype=dtype)
            Vt = np.zeros((G, st.t_pins, n_pad), dtype=dtype)
            bands[:, remap[d[mb]], pr[mb]] = vals_all[:, mb]
            Vt[:, pi[mv], pc[mv]] = vals_all[:, mv]
            if is_last and len(cl_g):
                mb_c, mv_c, d_c, pr_c, pc_c, pi_c = cl
                bands[cl_g[mb_c], remap[d_c[mb_c]], pr_c[mb_c]] = 1.0
                Vt[cl_g[mv_c], pi_c[mv_c], pc_c[mv_c]] = 1.0
            out[name] = {"bands": bands, "Vt": Vt,
                         "dsel": tuple(int(x) for x in dsel)}
        else:
            bands = np.zeros((G, nd, n_pad), dtype=dtype)
            Vt = np.zeros((G, st.t_pins, n_pad), dtype=dtype)
            for g in range(G):
                rows, cols, vals = coo_store[g][name]
                mb, mv, d, pr, pc, pi = masks_for(
                    rows, cols, lambda oob: np.abs(vals[oob]).max(initial=0.0))
                bands[g][d[mb], pr[mb]] = vals[mb]
                Vt[g][pi[mv], pc[mv]] = vals[mv]
            if is_last and len(cl_g):
                mb_c, mv_c, d_c, pr_c, pc_c, pi_c = cl
                bands[cl_g[mb_c], d_c[mb_c], pr_c[mb_c]] = 1.0
                Vt[cl_g[mv_c], pi_c[mv_c], pc_c[mv_c]] = 1.0
            out[name] = {"bands": bands, "Vt": Vt}
    return out


def state_key(v):
    """Dict key for a state field: unnamed fields (e.g. tau fields created
    without name=, as in the reference examples) must not collide on
    name=None."""
    return v.name if v.name is not None else f"_anon_{id(v):x}"


def gather_state(layout, variables, arrays):
    """Stack per-variable coeff arrays into the (G, S) state vector,
    keyed by `state_key`."""
    parts = [layout.gather(arrays[state_key(v)], v.domain, v.tensorsig)
             for v in variables]
    return torch.cat(parts, dim=1)


def scatter_state(layout, variables, X):
    """Split the (G, S) state vector back into per-variable coeff arrays."""
    out = {}
    offset = 0
    for v in variables:
        size = layout.slot_size(v.domain, v.tensorsig)
        out[state_key(v)] = layout.scatter(X[:, offset:offset + size],
                                           v.domain, v.tensorsig)
        offset += size
    return out


def row_valid_masks(layout, equations):
    """(G, S) float mask of valid equation rows (host numpy)."""
    groups = None
    parts = []
    for eq in equations:
        base = layout.valid_masks_all(eq["domain"], eq["tensorsig"])
        if "members" in eq and any(cond is not None
                                   for _, cond in eq["members"]):
            if groups is None:
                groups = list(layout.groups())
            active = np.zeros(len(groups), dtype=bool)
            for member, cond in eq["members"]:
                if cond is None:
                    active[:] = True
                else:
                    active |= np.array([cond(g) for g in groups], dtype=bool)
            base = base & active[:, None]
        parts.append(base)
    return np.concatenate(parts, axis=1).astype(np.float64)
