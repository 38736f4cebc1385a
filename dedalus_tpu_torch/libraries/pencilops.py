"""
Pencil operators (counterpart of dedalus_tpu/libraries/pencilops.py:
DenseOps and BandedOps under every [fusion]/[precision] plan of the JAX
package: fused or unfused solve, sequential, ascan or spike composition,
native, f32 or bf16 factor store). Both offer one surface (to_device, matvec,
matvec_pair, factor, factor_lincomb, solve(aux, rhs, mats),
densify_host), so every solver calls either: the timesteppers factor
a*M + b*L, a boundary value problem factors L itself, and an eigenvalue
problem reads its host matrices back per group.

DenseOps keeps (G, S, S) dense matrices; factor and solve delegate to a
registered batched matsolver (libraries/matsolvers.py).

BandedOps: the mode-interleaved, matching-aligned permutation
(core/subsystems.MatrixStructure) makes every true row banded; dense rows
(BCs, gauges) are replaced by identity "pin" rows and restored by a rank-t
Woodbury correction (reference Woodbury: libraries/matsolvers.py:285-316).
Storage is (G, D, n) diagonals plus the pinned-row block Vt (G, t, n). The
factorization is a blocked windowed-partial-pivoting banded LU (the batched
analogue of LAPACK dgbtrf) over q-wide block rows; at factor time its panel
factors are folded into per-block-row GEMM operators (FwdOp/BwdOp/lastOp),
so every solve is one banded substitution over those operators
(core/fusedstep.banded_substitution — a CUDA kernel on the card) plus the
t x t capacitance correction and iterative-refinement sweeps against the
assembled M and L.

The plan is resolved once per solver build and passed in (`fusion`, a
core/fusedstep.FusionPlan, and `solve_plan`, a
libraries/solvecomp.SolvePlan). Under FUSED_SOLVE = off, factor_lincomb
keeps the pivoted panel factors and a solve walks them with triangular
solves (`_solve_interior`). SOLVE_COMPOSITION = ascan or spike runs the
precomposed sweeps as batched GEMM programs (libraries/solvecomp.py)
instead of the kernel. SOLVE_DTYPE = f32 or bf16 stores the step
factor's operators and Woodbury pieces in that dtype; the refinement
against the native M and L polishes each solve. Like the JAX package, the
compositions and the ladder apply to factor_lincomb (the IVP step); a
boundary value problem's `factor` is the sequential native substitution.

Gradients: `solve` is a torch.autograd.Function (`AdjointSolveOps`, the
JAX package's custom-VJP funnel, dedalus_tpu/libraries/pencilops.py:
89-175) whose backward pass is the transposed solve against the same
factors, `solve_transpose` — public, as in the JAX package: S^T g, a plain
transpose. The factors and M/L get no gradient. On the sequential
banded composition the transpose is written out (one transposed
substitution, the kernel on the card, per substitution of the solve);
the dense solvers transpose their own factors (matsolvers.py).

The pencil batch G is the leading tensor dimension throughout.
"""

import numpy as np
import torch

from ..core.fusedstep import (WORK_DTYPE, as_columns, banded_substitution,
                              banded_substitution_transpose, resolve_fusion)
from . import solvecomp
from .matsolvers import (BatchedInverseRefined, get_solver, pivot_floor,
                         amax_abs, column_scale, count_floored_pivots,
                         lu_solve_transpose, refined_ladder,
                         transposed_refinement)
from ..tools.array import torch_dtype, zeropad
from ..tools.config import config

# aux entries whose group axis is the first (the rest are stacked over
# the block rows first)
_GROUP_FIRST = ("lastOp", "lastP", "lastLU")


def _cast_tree(tree, dtype):
    """A dict of tensors (nested dicts too) cast to `dtype`."""
    return {k: _cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def _transpose_by_vjp(fn, g):
    """S^T g for a linear torch function `fn` = S: autograd's backward of
    `fn` at a zero input. Torch's backward of a complex linear map is
    S^H, so a complex g goes through conj on both sides. The JAX package
    transposes the same way (jax.vjp at zeros)."""
    conj = g.is_complex()
    with torch.enable_grad():
        z = torch.zeros_like(g, requires_grad=True)
        (out,) = torch.autograd.grad(fn(z), z,
                                     g.conj_physical() if conj else g)
    return out.conj_physical() if conj else out


class _AdjointSolve(torch.autograd.Function):
    """x = solve(aux, rhs): linear in rhs, so its backward is one
    transposed solve against the same factors. Only references to the
    factors and matrices are kept for the backward pass; they get no
    gradient (M/L are not differentiable, as in the JAX package)."""

    @staticmethod
    def forward(ctx, rhs, ops, aux, mats):
        ctx.ops, ctx.aux, ctx.mats = ops, aux, mats
        return ops._solve_impl(aux, rhs, mats)

    @staticmethod
    def backward(ctx, ct):
        return ctx.ops.solve_adjoint(ctx.aux, ct, ctx.mats), None, None, None


class AdjointSolveOps:
    """The solve surface shared by DenseOps and BandedOps (the JAX
    package's AdjointSolveOps): `solve` runs `_solve_impl`, through the
    autograd Function when its right-hand side carries a gradient (so a
    step outside autograd runs exactly as before), and
    `solve_transpose` is its backward pass."""

    def solve(self, aux, rhs, mats=None):
        """Solve A x = rhs against the factored aux (see _solve_impl).
        Differentiable in rhs: the backward pass is `solve_adjoint`."""
        if torch.is_grad_enabled() and rhs.requires_grad:
            return _AdjointSolve.apply(rhs, self, aux, mats)
        return self._solve_impl(aux, rhs, mats)

    def solve_adjoint(self, aux, ct, mats=None):
        """S^H ct, torch's backward of the solve S: the conjugate of the
        transposed solve of conj(ct) (ct itself for a real solve)."""
        if ct.is_complex():
            return self.solve_transpose(aux, ct.conj_physical(),
                                        mats).conj_physical()
        return self.solve_transpose(aux, ct, mats)


class DenseOps(AdjointSolveOps):
    """Dense (G, S, S) pencil operators (small problems / fallback;
    reference DenseOps, dedalus_tpu/libraries/pencilops.py:209)."""

    kind = "dense"

    def __init__(self, device, matsolver=None, solve_plan=None):
        self.device = torch.device(device)
        # the solve plan the solver resolved once per build; the scan
        # compositions are inert here (no substitution to restructure),
        # and the precision ladder routes the solve through the refined
        # low-dtype inverse (matsolvers.refined_ladder)
        if solve_plan is None:
            solve_plan = solvecomp.resolve_solve_plan_for_ops("dense", 0)
        self._solve_plan = solve_plan
        self._composition = "sequential"
        if solve_plan.dtype != "native":
            self.solver_cls = refined_ladder(solve_plan)
        else:
            self.solver_cls = get_solver(matsolver)

    def to_device(self, host_mat, dtype):
        return torch.as_tensor(host_mat).to(device=self.device,
                                            dtype=torch_dtype(dtype))

    def matvec(self, A, X):
        return torch.einsum("gij,gj->gi", A, X)

    def matvec_pair(self, M, L, X):
        """(M @ X, L @ X): the two products, equal to separate calls."""
        return self.matvec(M, X), self.matvec(L, X)

    # per-group count of the pivots below the floor in the most recent
    # factorization (a device tensor; None before the first): read where
    # the host reads anyway, never on the step path
    floored_pivots = None

    def _factor_counted(self, A):
        counted = getattr(self.solver_cls, "factor_counted", None)
        if counted is None:
            return self.solver_cls.factor(A)
        aux, self.floored_pivots = counted(A)
        return aux

    def factor(self, A):
        """Factor a matrix already on the device (an LBVP's L)."""
        return self._factor_counted(A)

    def factor_lincomb(self, a, A, b, B):
        """Factor a*A + b*B. The validity-closure identity sits on the
        last matrix (L), so it stays b*I in the combination."""
        return self._factor_counted(a * A + b * B)

    def _solve_impl(self, aux, rhs, mats=None):
        return self.solver_cls.solve(aux, rhs)

    def solve_transpose(self, aux, rhs, mats=None):
        """A^T x = rhs against the same factors (the solver class's own
        transpose, libraries/matsolvers.py)."""
        return self.solver_cls.solve_transpose(aux, rhs)

    def solve_report(self, aux, rhs, mats=None):
        """A solve and its achieved relative residual as a device scalar
        (None unless the solver is the refined ladder, whose aux keeps
        the matrix). A diagnostic, off the step path."""
        x = self.solve(aux, rhs, mats=mats)
        if not (isinstance(self.solver_cls, type)
                and issubclass(self.solver_cls, BatchedInverseRefined)):
            return x, None
        return x, self.solver_cls.residual(aux, x, rhs).max()

    def densify_host(self, host_mat, g):
        """Group g's dense (S, S) host matrix."""
        return np.asarray(host_mat[g])


def _capacitance_deficit(Cap):
    """Per-group count of the Woodbury capacitance's pivots that mark a
    singular L (the rank deficiency that the dense factors' pivot floor
    counts): pivots of the LU of Cap, its rows and then its columns
    scaled to unit max |entry|, below sqrt(eps) of their max. The
    capacitance is formed from Y = B~^-1 E, so its rounding carries
    cond(B~): a null direction sits at ~1e-12..1e-10 of its scale, not
    at eps (the Chebyshev^2 rectangle's four corner modes: 4th pivot
    5.4e-11, 5th 1.1e-3 at 48x48), and an unscaled capacitance with a
    few huge pin columns (up to 3e17 in an m-coupled annulus, whose
    scaled pivots are all ~1) fools the dense floor S eps max|LU|. On
    the device: nothing waits on it."""
    with torch.no_grad():
        one = torch.ones((), dtype=Cap.real.dtype, device=Cap.device)
        row = amax_abs(Cap, -1)[..., :, None]
        C = Cap / torch.where(row > 0, row, one)
        col = amax_abs(C, -2)[..., None, :]
        C = C / torch.where(col > 0, col, one)
        LU = torch.linalg.lu_factor_ex(C)[0]
        eps = torch.finfo(Cap.real.dtype).eps
        floor = eps ** 0.5 * amax_abs(LU, (-2, -1))[..., None]
        return count_floored_pivots(LU, floor, scale=False)


class BandedMatrix:
    """
    One pencil matrix in trimmed banded + pinned-row storage: only the
    structurally nonzero diagonals are kept (`dsel` maps stored rows to the
    shared 0..nd-1 diagonal lattice), and an all-zero pinned-row block is
    dropped entirely.
    """

    def __init__(self, bands, Vt, dsel):
        self.bands = bands    # (G, len(dsel), n_pad)
        self.Vt = Vt          # (G, t, n_pad) or None
        self.dsel = tuple(int(d) for d in dsel)


class BandedOps(AdjointSolveOps):
    """
    Banded + pinned-row pencil operators.

    Host representation per matrix name (core/subsystems.build_banded_arrays):
        bands : (G, D, n_pad)  diagonals of the matched (true-banded)
                rows, offsets -kl..ku; bands[g, d, p] = A'[g, p, p+d-kl].
        Vt    : (G, t, n_pad)  true content of the pinned rows

    with A' the row/column-permuted matrix. The represented matrix is
    A' = B + sum_i e_{p_i} Vt_i^T where B carries zero rows at the pin
    positions. Factorization pins those rows (B~ = B + sum_i e_{p_i}
    e_{p_i}^T) and applies Woodbury:
        A'^-1 = B~^-1 - B~^-1 E (I + (Vt - E^T) B~^-1 E)^-1 (Vt - E^T) B~^-1
    """

    kind = "banded"
    # native refinement sweeps per solve (the JAX package's default)
    refine = 1

    def __init__(self, structure, device, fusion=None, solve_plan=None):
        st = structure
        missing = [attr for attr in
                   ("S", "NB", "q", "t_pins", "kl", "ku", "row_perm",
                    "col_perm", "pinned_positions")
                   if getattr(st, attr, None) is None]
        if missing:
            raise ValueError(f"BandedOps: structure is missing {missing}")
        self.device = torch.device(device)
        # the plans the solver resolved once per build (a bare
        # construction resolves them now), so a config edit mid-build
        # cannot split one solver across two plans. FUSED_SOLVE engages
        # on factor_lincomb (the step loop); factor() always precomposes.
        if fusion is None:
            fusion = resolve_fusion()
        self._fused_solve = fusion.solve
        self._fused_matvec = fusion.matvec
        if solve_plan is None:
            solve_plan = solvecomp.resolve_solve_plan_for_ops("banded", st.S)
        self._solve_plan = solve_plan
        if solve_plan.composition != "sequential" and not fusion.solve:
            raise ValueError(
                f"[fusion] SOLVE_COMPOSITION = {solve_plan.composition} "
                "requires FUSED_SOLVE: the restructured sweeps run over "
                "the precomposed FwdOp/BwdOp GEMM operators")
        self._composition = solve_plan.composition if fusion.solve \
            else "sequential"
        self._spike_chunks_cfg = solve_plan.spike_chunks
        self._ladder = solve_plan.dtype != "native"
        # refinement sweeps per solve: the plan's count, else `refine`
        self.sweeps = solve_plan.sweeps if solve_plan.sweeps is not None \
            else self.refine
        self._refine_tol = solve_plan.tol
        self.n = st.S                  # true system size
        self.t = st.t_pins
        self.kl = st.kl
        self.ku = st.ku
        self.nd = st.kl + st.ku + 1    # number of stored diagonals
        # the structural block size (the JAX package's BANDED_MIN_Q
        # re-blocking to a larger q is a TPU rule: fewer, fatter scan
        # steps for the MXU), so the factor width is the assembled width
        self.q = int(st.q)
        self.NB = int(st.NB)
        self.n_pad = self.NB * self.q
        # static permutation index arrays on the device:
        # row_perm: permuted pos -> orig row; col_perm likewise for columns
        index = lambda a: torch.as_tensor(np.array(a, dtype=np.int64),
                                          device=self.device)
        self._col_perm_t = index(st.col_perm)
        self._row_perm_t = index(st.row_perm)
        self._pos_col_t = index(np.argsort(st.col_perm))
        self._pos_row_t = index(np.argsort(st.row_perm))
        self._pin_pos_t = index(st.pinned_positions)
        # host copies for densify_host
        self.row_perm = np.asarray(st.row_perm, dtype=np.int64)
        self.col_perm = np.asarray(st.col_perm, dtype=np.int64)
        self.pin_pos = np.asarray(st.pinned_positions, dtype=np.int64)
        # static block-gather indices: block[o][ri, ci] reads
        # bands[:, o*q + ci - ri + kl, block_row*q + ri]
        ri = np.arange(self.q)[:, None]
        ci = np.arange(self.q)[None, :]
        self._ri_t = index(np.broadcast_to(ri, (self.q, self.q)))
        self._blk_idx = {}
        for o in (-1, 0, 1):
            d = o * self.q + ci - ri + self.kl       # (q, q)
            valid = (d >= 0) & (d < self.nd)
            self._blk_idx[o] = (index(np.where(valid, d, 0)),
                                torch.as_tensor(valid, device=self.device))

    # ------------------------------------------------------------ host side

    def to_device(self, host_arrs, dtype):
        """Host band store -> trimmed BandedMatrix on this ops' device.
        Accepts pre-trimmed storage (a "dsel" key, the assembly fast path)
        or a full (G, nd, n_pad) lattice, trimmed here."""
        tdt = torch_dtype(dtype)
        bands = host_arrs["bands"]
        Vt = host_arrs["Vt"]
        if "dsel" in host_arrs:
            dsel = list(host_arrs["dsel"])
        else:
            dsel = [d for d in range(self.nd) if np.any(bands[:, d, :])] \
                or [self.kl]
            bands = bands[:, dsel, :]
        trimmed = torch.as_tensor(np.ascontiguousarray(bands)).to(
            device=self.device, dtype=tdt)
        Vt_dev = None
        if self.t and np.any(Vt):
            Vt_dev = torch.as_tensor(np.ascontiguousarray(Vt)).to(
                device=self.device, dtype=tdt)
        return BandedMatrix(trimmed, Vt_dev, dsel)

    def densify_host(self, host_arrs, g):
        """Group g's dense (S, S) matrix in the original ordering,
        rebuilt from a host band store (dedalus_tpu/libraries/
        pencilops.py:491)."""
        S = self.n
        W = host_arrs["bands"].shape[-1]
        Ap = np.zeros((W, W), dtype=host_arrs["bands"].dtype)
        bands = host_arrs["bands"][g]
        dsel = host_arrs.get("dsel", range(self.nd))
        for i, d in enumerate(dsel):
            off = d - self.kl
            rr = np.arange(max(0, -off), min(W, W - off))
            Ap[rr, rr + off] = bands[i, rr]
        if self.t:
            Ap[self.pin_pos, :] += host_arrs["Vt"][g]
        Ap = Ap[:S, :S]
        # un-permute: Ap[i, j] = A[row_perm[i], col_perm[j]]
        A = np.zeros_like(Ap)
        A[np.ix_(self.row_perm, self.col_perm)] = Ap
        return A

    # ----------------------------------------------------------- device ops

    def _band_mv(self, bands, dsel, x):
        """y[g, p] = sum_{d in dsel} bands[g, i, p] * x[g, p + d - kl];
        width follows the band ARRAY (assembled storage)."""
        width = bands.shape[-1]
        xpad = zeropad(x, ((0, 0), (self.kl, self.ku)))
        y = torch.zeros_like(x)
        for i, d in enumerate(dsel):
            y = y + bands[:, i, :] * xpad[:, d:d + width]
        return y

    def _matvec_permuted(self, A, xp):
        """A @ x in permuted order, xp already column-permuted and padded."""
        yp = self._band_mv(A.bands, A.dsel, xp)
        if self.t and A.Vt is not None:
            pin_vals = torch.einsum("gtn,gn->gt", A.Vt, xp)
            yp[:, self._pin_pos_t] += pin_vals
        # yp[p] = (A @ X)[row_perm[p]]
        return yp[:, :self.n].index_select(1, self._pos_row_t)

    def matvec(self, A, X):
        """Full A @ X in the ORIGINAL slot ordering; X (G, S)."""
        xp = X.index_select(1, self._col_perm_t)
        xp = zeropad(xp, ((0, 0), (0, A.bands.shape[-1] - self.n)))
        return self._matvec_permuted(A, xp)

    def matvec_transpose(self, A, Y):
        """A^T @ Y (a plain transpose) in the original slot ordering, Y
        (G, S): the transpose of `matvec`, each step of it run backwards
        (the rows' permutation, the pinned rows, the band product, the
        columns' permutation)."""
        yp = zeropad(Y.index_select(1, self._row_perm_t),
                     ((0, 0), (0, A.bands.shape[-1] - self.n)))
        width = A.bands.shape[-1]
        xpad = torch.zeros((yp.shape[0], width + self.kl + self.ku),
                           dtype=yp.dtype, device=yp.device)
        for i, d in enumerate(A.dsel):
            xpad[:, d:d + width] += A.bands[:, i, :] * yp
        xp = xpad[:, self.kl:self.kl + width]
        if self.t and A.Vt is not None:
            xp = xp + torch.einsum("gtn,gt->gn", A.Vt,
                                   yp[:, self._pin_pos_t])
        return xp[:, :self.n].index_select(1, self._pos_col_t)

    def matvec_pair(self, M, L, X):
        """(M @ X, L @ X) in ONE pass over the operand under FUSED_MATVEC
        (two `matvec` calls when it is off): the column permutation and
        pad run once over a shared padded X; each matrix keeps its own
        trimmed diagonal loop, so both outputs equal separate `matvec`
        calls."""
        if not self._fused_matvec:
            return self.matvec(M, X), self.matvec(L, X)
        xp = X.index_select(1, self._col_perm_t)
        xp = zeropad(xp, ((0, 0), (0, M.bands.shape[-1] - self.n)))
        return self._matvec_permuted(M, xp), self._matvec_permuted(L, xp)

    def _chunk_blocks(self, chunk):
        """One block-row's (G, D, q) band chunk -> (diag, left, right) blocks
        ((i, i), (i, i-1), (i, i+1))."""
        out = {}
        for o in (-1, 0, 1):
            d, valid = self._blk_idx[o]                      # (q, q)
            out[o] = chunk[:, d, self._ri_t] * valid.to(chunk.dtype)
        return out[0], out[-1], out[1]

    @staticmethod
    def _lu(A):
        """Batched partially pivoted LU: (packed LU, perm) with
        A[perm] = L @ U, the convention of jax.lax.linalg.lu."""
        LU, pivots = torch.linalg.lu_factor(A)
        P, _, _ = torch.lu_unpack(LU, pivots, unpack_data=False)
        # P has A's dtype; argmax takes no complex input
        return LU, P.real.argmax(dim=-2)

    def _factor_interior(self, bands):
        """
        Blocked banded LU with windowed partial pivoting (the batched
        analogue of LAPACK dgbtrf, reference matsolver ScipyBanded:
        libraries/matsolvers.py:187): at block column i the (2q x q) panel
        [S_i; Lo_i] is factored with row pivoting (pivots confined to the
        window), the permutation + elimination are applied to the (2q x 2q)
        trailing window, and the upper fill is stored in a (q x 2q) U12
        block per step. Factors are stored LAPACK-packed.

        Returns (perms, panelLU, U12, lastP, lastLU); the first three are
        stacked over the NB-1 elimination steps (None when NB == 1).
        """
        G = bands.shape[0]
        q, NB, nd = self.q, self.NB, self.nd
        chunks = bands.reshape(G, nd, NB, q).permute(2, 0, 1, 3)  # (NB,G,nd,q)
        if NB == 1:
            Dg0, _, _ = self._chunk_blocks(chunks[0])
            lu, perm = self._lu(Dg0)
            return (None, None, None, perm, lu)
        eye_q = torch.eye(q, dtype=bands.dtype, device=bands.device)
        zero_qq = torch.zeros((G, q, q), dtype=bands.dtype,
                              device=bands.device)
        A11, _, Up0 = self._chunk_blocks(chunks[0])
        A12 = torch.cat([Up0, zero_qq], dim=2)
        perms, panels, U12s = [], [], []
        for i in range(1, NB):
            D_n, Lo_i, Up_n = self._chunk_blocks(chunks[i])
            panel = torch.cat([A11, Lo_i], dim=1)                  # (G,2q,q)
            lu, perm = self._lu(panel)
            L1 = torch.tril(lu[:, :q, :], -1) + eye_q             # (G,q,q)
            L2 = lu[:, q:, :]                                     # (G,q,q)
            T = torch.cat([A12, torch.cat([D_n, Up_n], dim=2)], dim=1)
            T = torch.gather(T, 1, perm[:, :, None].expand(-1, -1, 2 * q))
            U12 = torch.linalg.solve_triangular(
                L1, T[:, :q, :], upper=False, unitriangular=True)  # (G,q,2q)
            Tn = T[:, q:, :] - L2 @ U12                           # (G,q,2q)
            A11 = Tn[:, :, :q]
            A12 = torch.cat([Tn[:, :, q:], zero_qq], dim=2)
            perms.append(perm)
            panels.append(lu)
            U12s.append(U12)
        lu, lastP = self._lu(A11)
        return (torch.stack(perms), torch.stack(panels), torch.stack(U12s),
                lastP, lu)

    # per-group count of the pivots below the floor in the most recent
    # factorization (a device tensor; None before the first): those of
    # the pinned base B~ (`base_floored_pivots`, which the pin repair
    # reads), plus those of the Woodbury capacitance in a boundary value
    # problem's factor
    floored_pivots = None
    base_floored_pivots = None

    def _count_floored(self, interior):
        """Per-group count of the banded factor's pivots (its panels' and
        the last block's) that the dense factors would floor
        (matsolvers.singular_pivots): below n * eps * max|LU| of the
        group, n the banded system size, and below COLUMN_ULPS * eps of
        their column of U, which spans the block's own upper triangle and
        the U12 fill of the two block rows above it. A count only: the
        factors are not floored."""
        _, panels, U12, _, last = interior
        with torch.no_grad():
            if panels is None:
                floor = pivot_floor(last, self.n_pad)
                return count_floored_pivots(last, floor)
            q = self.q
            amax = torch.maximum(amax_abs(panels, (0, -2, -1)),
                                 amax_abs(last, (-2, -1)))
            eps = torch.finfo(last.real.dtype if last.is_complex()
                              else last.dtype).eps
            floor = (self.n_pad * eps * amax)[:, None]
            # (NB, G, q) column scales: block j's own triangle, then the
            # fill U12[j-1][:, :q] and U12[j-2][:, q:]
            col = torch.cat([column_scale(panels[..., :q, :]),
                             column_scale(last)[None]])
            fill = amax_abs(U12, -2)                      # (NB-1, G, 2q)
            col[1:] = torch.maximum(col[1:], fill[..., :q])
            col[2:] = torch.maximum(col[2:], fill[:-1, :, q:])
            return (count_floored_pivots(panels[..., :q, :], floor,
                                         col[:-1]).sum(dim=0)
                    + count_floored_pivots(last, floor, col[-1]))

    def _precompose_subst(self, interior):
        """Precomposed matmul-substitution operators (FUSED_SOLVE). At
        factor time each panel's unit-lower and upper blocks are inverted
        and FOLDED with the window permutation and the elimination update
        into per-step GEMM operators:

            fwd:  [y_i; w_next] = FwdOp_i @ [w; f_{i+1}]
                  FwdOp_i = [[L1inv P_top], [P_bot - L2 L1inv P_top]]
            bwd:  x_i = BwdOp_i @ [y_i; x_{i+1}; x_{i+2}]
                  BwdOp_i = [U11inv | -U11inv U12]
            last: x = lastOp @ w,  lastOp = U^-1 L^-1 P

        Returns {"FwdOp": (NB-1, G, 4q^2), "BwdOp": (NB-1, G, 3q^2),
        "lastOp": (G, q, q)}, each contiguous."""
        perms, panelLU, U12, lastP, lastLU = interior
        q = self.q
        eye = torch.eye(q, dtype=lastLU.dtype, device=lastLU.device)

        def inv_lower(lu):
            L1 = torch.tril(lu, -1) + eye
            return torch.linalg.solve_triangular(
                L1, eye.expand(L1.shape), upper=False, unitriangular=True)

        def inv_upper(lu):
            return torch.linalg.solve_triangular(
                torch.triu(lu), eye.expand(lu.shape), upper=True)

        def one_hot(perm, n):
            return torch.nn.functional.one_hot(perm, n).to(lastLU.dtype)

        # last block: A^-1 P = U^-1 L^-1 P composed once (perm folded)
        fsub = {"lastOp": (inv_upper(lastLU) @ inv_lower(lastLU)
                           @ one_hot(lastP, q)).contiguous()}
        if panelLU is not None:
            steps, G = panelLU.shape[:2]
            lu = panelLU.reshape(steps * G, 2 * q, q)
            L1inv = inv_lower(lu[:, :q, :])
            U11inv = inv_upper(lu[:, :q, :])
            Pmat = one_hot(perms.reshape(steps * G, 2 * q), 2 * q)
            top = L1inv @ Pmat[:, :q, :]                      # (., q, 2q)
            bot = Pmat[:, q:, :] - lu[:, q:, :] @ top
            fwd_op = torch.cat([top, bot], dim=1)             # (., 2q, 2q)
            bwd_op = torch.cat(
                [U11inv, -(U11inv @ U12.reshape(steps * G, q, 2 * q))],
                dim=2)                                        # (., q, 3q)
            fsub["FwdOp"] = fwd_op.reshape(steps, G, 4 * q * q).contiguous()
            fsub["BwdOp"] = bwd_op.reshape(steps, G, 3 * q * q).contiguous()
        return fsub

    def _pick_chunks(self, G, itemsize):
        """(C, Gc): chunk count and width for the G-chunked factorization,
        keeping a chunk's factor slab (panelLU + U12) under BANDED_CHUNK_MB.
        Chunk i factors groups [i*Gc, min(G, (i+1)*Gc)); the last chunk
        may be narrower."""
        target = float(config["linear algebra"]["BANDED_CHUNK_MB"]) * 1e6
        per_g = self.NB * (2 * self.q * self.q) * 2 * itemsize
        Gc = int(max(1, min(G, target // max(per_g, 1))))
        C = -(-G // Gc)
        if C <= 1:
            return 1, G
        Gc = -(-G // C)  # rebalance: the last chunk is at most Gc narrower
        return C, Gc

    def _pin(self, bands):
        """Identity pins at the pinned rows and the padded diagonal of a
        full-lattice band slab (in place)."""
        bands[:, self.kl, self._pin_pos_t] = 1.0
        if self.n_pad > self.n:
            bands[:, self.kl, self.n:] = 1.0
        return bands

    @staticmethod
    def _interior_dict(interior):
        """The pivoted factors of `_factor_interior` as a dict (the
        FUSED_SOLVE = off aux); the stacked ones are absent at NB == 1."""
        names = ("perms", "panelLU", "U12", "lastP", "lastLU")
        return {n: a for n, a in zip(names, interior) if a is not None}

    def _woodbury(self, aux, Vt, inverse):
        """The Woodbury pieces over the whole store: aux["YbT"] = (B~^-1
        E)^T, solved as t right-hand sides per group in one substitution
        (by the aux's composition), and the t x t capacitance: its
        inverse in fsub["CapInv"] with `inverse` (a fused step factor)
        or its LU in aux["CapLU"] (a boundary value problem's factor and
        the pivoted step factors), as the JAX package keeps them
        (dedalus_tpu/libraries/pencilops.py:925 _factor_core). A singular
        L with a nonsingular pinned base B~ (a rectangle's corner modes)
        has a singular capacitance: its LU solve stays backward stable
        and returns a member of the solution set, where the explicit
        inverse spreads its 1/eps entries over every component. Returns
        the capacitance."""
        G, dtype, device = Vt.shape[0], Vt.dtype, Vt.device
        # E = one-hot columns at the pin positions, kept transposed
        # (G, t, n_pad) like Y
        E = torch.zeros((G, self.t, self.n_pad), dtype=dtype, device=device)
        E[:, torch.arange(self.t, device=device), self._pin_pos_t] = 1.0
        YbT = self._substitute(aux, E)
        # capacitance: I + (Vt - E^T) Y
        Cap = (torch.eye(self.t, dtype=dtype, device=device)
               + Vt @ YbT.transpose(1, 2)
               - YbT[:, :, self._pin_pos_t].transpose(1, 2))
        if inverse:
            # the t x t capacitance solve becomes one GEMM
            aux["fsub"]["CapInv"] = torch.linalg.inv(Cap)
        else:
            LU, piv, _ = torch.linalg.lu_factor_ex(Cap)
            aux["CapLU"] = (LU, piv)
        aux["YbT"] = YbT
        return Cap

    def _combine_bands(self, mb, lb, a, b, dM, dL):
        """a*M + b*L as a full-lattice band slab from trimmed slabs."""
        bands = torch.zeros((mb.shape[0], self.nd, self.n_pad),
                            dtype=mb.dtype, device=mb.device)
        bands[:, dM] += a * mb
        bands[:, dL] += b * lb
        return bands

    def factor(self, A):
        """Factor a matrix already resident in band storage (an LBVP's or
        a Newton step's L; dedalus_tpu/libraries/pencilops.py:1035): the
        same chunked factorization into one operator store and the same
        Woodbury solve as factor_lincomb, with no M to combine, always
        precomposed and sequential in the native dtype. The aux keeps A,
        so the refinement residual is one matvec of A."""
        aux = self._factor_store(
            A.bands.shape[0], A.bands.element_size(),
            lambda lo, hi: self._expand_bands(A, lo, hi),
            [A.Vt], [1.0], A.bands.dtype)
        aux["A"] = A
        return aux

    def _expand_bands(self, A, lo, hi):
        """Groups [lo, hi) of a trimmed BandedMatrix as a full-lattice
        band slab (a factorization transient)."""
        bands = torch.zeros((hi - lo, self.nd, self.n_pad),
                            dtype=A.bands.dtype, device=A.bands.device)
        bands[:, torch.as_tensor(A.dsel, device=self.device)] = \
            A.bands[lo:hi]
        return bands

    def _factor_store(self, G, itemsize, slab, Vts, scales, dtype,
                      step=False):
        """Factor the full-lattice slabs `slab(lo, hi)` per G-chunk into
        one store over all G groups, then the Woodbury pieces of the
        pinned rows sum(scale * Vt). The store is the precomposed
        substitution operators ("fsub"), or with `step` under FUSED_SOLVE
        = off the pivoted factors ("interior"). With `step`, the plan's
        composition (the SPIKE operators, attached before the Woodbury
        solve so it runs through them) and precision ladder apply.
        Returns the aux {"fsub" or "interior", "factor_chunks",
        "composition"[, "Vt", "YbT", "CapLU"]}."""
        fused = self._fused_solve or not step
        C, Gc = self._pick_chunks(G, itemsize)
        store = {}
        counts = []
        for i in range(C):
            lo, hi = i * Gc, min(G, (i + 1) * Gc)
            interior = self._factor_interior(self._pin(slab(lo, hi)))
            counts.append(self._count_floored(interior))
            part = self._precompose_subst(interior) if fused \
                else self._interior_dict(interior)
            del interior
            if C == 1:
                store = part
                break
            for name, arr in part.items():
                axis = 0 if name in _GROUP_FIRST else 1       # the group axis
                if name not in store:
                    shape = list(arr.shape)
                    shape[axis] = G
                    store[name] = arr.new_empty(shape)
                store[name].narrow(axis, lo, hi - lo).copy_(arr)
            del part
        self.floored_pivots = self.base_floored_pivots = (
            counts[0] if C == 1 else torch.cat(counts))
        composition = self._composition if step else "sequential"
        aux = {"fsub" if fused else "interior": store, "factor_chunks": C,
               "composition": composition}
        if composition == "spike" and "FwdOp" in store:
            self._attach_spike(store)
        if self.t:
            Vt = torch.zeros((G, self.t, self.n_pad), dtype=dtype,
                             device=self.device)
            for V, scale in zip(Vts, scales):
                if V is not None:
                    Vt += scale * V
            aux["Vt"] = Vt
            Cap = self._woodbury(aux, Vt, inverse=step and fused)
            if not step:
                # a boundary value problem's singular L (the build warns
                # on it): the capacitance's floored pivots join the base's
                self.floored_pivots = (self.floored_pivots
                                       + _capacitance_deficit(Cap))
        if step and fused and self._ladder:
            # precision ladder: the substitution operators and the
            # Woodbury pieces, computed above at native precision, are
            # stored in the low dtype (halving or quartering the factor
            # store); `solve` refines against the native M and L
            low = solvecomp.low_dtype(self._solve_plan.dtype, dtype)
            aux["fsub"] = _cast_tree(store, low)
            for name in ("Vt", "YbT"):
                if name in aux:
                    aux[name] = aux[name].to(low)
        return aux

    def factor_lincomb(self, a, M, b, L):
        """Factor a*M + b*L without persisting the combined bands: the
        combination is a transient of the factorization, built per G-chunk
        (`_pick_chunks`), and the refinement residual uses matvecs of the
        resident M and L. Each chunk's operators are written into its
        slice of one store over all G groups, so a solve is one
        substitution whatever the chunk count; the Woodbury solve runs
        once over the store. Returns the aux: {"fsub" (or "interior"),
        "Vt", "YbT", "factor_chunks", "composition", "ab"}."""
        dM = torch.as_tensor(M.dsel, device=self.device)
        dL = torch.as_tensor(L.dsel, device=self.device)
        aux = self._factor_store(
            M.bands.shape[0], M.bands.element_size(),
            lambda lo, hi: self._combine_bands(
                M.bands[lo:hi], L.bands[lo:hi], a, b, dM, dL),
            [M.Vt, L.Vt], [a, b], M.bands.dtype, step=True)
        aux["ab"] = (a, b)
        return aux

    # ---------------------------------- restructured substitutions
    #
    # Both precomposed sweeps are affine recurrences over factor-time
    # operators: forward w_{i+1} = A_i w_i + B_i f_{i+1} with outputs
    # y_i = C_i w_i + D_i f_{i+1} ((A|B; C|D) = blocks of FwdOp), and
    # backward z_i = A'_i z_{i+1} + B'_i y_i over z_i = [x_i; x_{i+1}]
    # (A', B' from BwdOp = [Y | P]: x_i = Y_i y_i + P_i z_{i+1};
    # dedalus_tpu/libraries/pencilops.py:700-792).

    def _subst_fwd_system(self, fsub):
        """(A, B, C, D) of the forward sweep, views of the FwdOp blocks;
        state, input and output widths all q."""
        q = self.q
        steps, G = fsub["FwdOp"].shape[:2]
        op = fsub["FwdOp"].view(steps, G, 2 * q, 2 * q)
        return (op[:, :, q:, :q], op[:, :, q:, q:],
                op[:, :, :q, :q], op[:, :, :q, q:])

    def _subst_bwd_system(self, fsub):
        """(A', B', C', D') of the backward sweep, step-reversed into a
        forward recurrence over v_j = z_{NB-2-j}; state width 2q, input
        and output width q. The output extracts x_i = z_i[:q] (C' = P,
        D' = Y)."""
        q = self.q
        steps, G = fsub["BwdOp"].shape[:2]
        op = fsub["BwdOp"].view(steps, G, q, 3 * q)
        Yb = op[..., :q]                                   # acts on y_i
        Pb = op[..., q:]                                   # acts on z_{i+1}
        eye = torch.eye(q, dtype=op.dtype, device=op.device)
        shift = torch.cat([eye, torch.zeros_like(eye)], dim=1).expand(
            steps, G, q, 2 * q)                            # x_{i+1} carry row
        A = torch.cat([Pb, shift], dim=2).flip(0)
        B = torch.cat([Yb, torch.zeros_like(Yb)], dim=2).flip(0)
        return A, B, Pb.flip(0), Yb.flip(0)

    def _attach_spike(self, fsub):
        """Factor-time SPIKE precomposition of both sweeps
        (solvecomp.spike_precompose), dropping FwdOp/BwdOp: the SPIKE
        solve reads only the chunk operators. Too few steps to chunk keep
        the sequential operators."""
        chunks = solvecomp.spike_chunk_count(fsub["FwdOp"].shape[0],
                                             self._spike_chunks_cfg)
        if chunks <= 1:
            return
        fsub["spikeF"] = solvecomp.spike_precompose(
            *self._subst_fwd_system(fsub), chunks)
        fsub["spikeB"] = solvecomp.spike_precompose(
            *self._subst_bwd_system(fsub), chunks)
        del fsub["FwdOp"], fsub["BwdOp"]

    def _blocks(self, fp):
        """fp (G, n_pad) or (G, k, n_pad) -> (NB, G, q, k) block rows."""
        f = as_columns(fp)
        G, k, _ = f.shape
        return f.reshape(G, k, self.NB, self.q).permute(2, 0, 3, 1)

    @staticmethod
    def _unblocks(x, fp):
        """(NB, G, q, k) block rows -> fp's shape."""
        NB, G, q, k = x.shape
        return x.permute(1, 3, 0, 2).reshape(G, k, NB * q).reshape(fp.shape)

    def _solve_restructured(self, fp, fsub, apply_fwd, apply_bwd):
        """The two sweeps, each as one call of a solvecomp recurrence
        solver, with the last block's lastOp product between them."""
        fb = self._blocks(fp)
        ys, w_f = apply_fwd(fb[1:], fb[0])
        x_last = fsub["lastOp"] @ w_f
        z0 = torch.cat([x_last, torch.zeros_like(x_last)], dim=1)
        outs, _ = apply_bwd(ys.flip(0), z0)
        return self._unblocks(torch.cat([outs.flip(0), x_last[None]]), fp)

    def _solve_interior_ascan(self, fp, fsub):
        """Solve B~ x = fp with both sweeps as parallel prefixes
        (solvecomp.ascan_apply): O(log NB) dependent levels."""
        fwd = self._subst_fwd_system(fsub)
        bwd = self._subst_bwd_system(fsub)
        return self._solve_restructured(
            fp, fsub, lambda u, v0: solvecomp.ascan_apply(*fwd, u, v0),
            lambda u, v0: solvecomp.ascan_apply(*bwd, u, v0))

    def _solve_interior_spike(self, fp, fsub):
        """Solve B~ x = fp against the factor-time SPIKE operators: each
        sweep is two batched GEMMs over all chunks and the C-step reduced
        recurrence."""
        return self._solve_restructured(
            fp, fsub,
            lambda u, v0: solvecomp.spike_apply(fsub["spikeF"], u, v0),
            lambda u, v0: solvecomp.spike_apply(fsub["spikeB"], u, v0))

    def _solve_interior(self, interior, fp):
        """Solve B~ x = fp via the pivoted block factors (FUSED_SOLVE =
        off; dedalus_tpu/libraries/pencilops.py:836): the forward sweep
        permutes each (2q, k) window and eliminates with the unit-lower
        panel, the backward sweep substitutes with the upper blocks, all
        triangular solves."""
        q, NB = self.q, self.NB
        fb = self._blocks(fp)                            # (NB, G, q, k)
        eye = torch.eye(q, dtype=fb.dtype, device=fb.device)
        lastP, lastLU = interior["lastP"], interior["lastLU"]

        def rows(w, perm):
            return torch.gather(w, 1, perm[:, :, None].expand(
                -1, -1, w.shape[-1]))

        def lower(lu, b):
            return torch.linalg.solve_triangular(
                torch.tril(lu, -1) + eye, b, upper=False, unitriangular=True)

        def upper(lu, b):
            return torch.linalg.solve_triangular(torch.triu(lu), b,
                                                 upper=True)

        def last_solve(w):
            return upper(lastLU, lower(lastLU, rows(w, lastP)))

        if NB == 1:
            return self._unblocks(last_solve(fb[0])[None], fp)
        perms, panelLU, U12 = (interior[n] for n in
                               ("perms", "panelLU", "U12"))
        # forward: eliminate with pivots; carry the updated next block
        w, ys = fb[0], []
        for i in range(NB - 1):
            lu = panelLU[i]
            wf = rows(torch.cat([w, fb[i + 1]], dim=1), perms[i])
            y = lower(lu[:, :q], wf[:, :q])
            w = wf[:, q:] - lu[:, q:] @ y
            ys.append(y)
        # backward: x_i = U11_i^-1 (y_i - U12_i @ [x_{i+1}; x_{i+2}])
        x1 = last_solve(w)
        x2 = torch.zeros_like(x1)
        xs = [x1]
        for i in range(NB - 2, -1, -1):
            x = upper(panelLU[i][:, :q],
                      ys[i] - U12[i] @ torch.cat([x1, x2], dim=1))
            xs.append(x)
            x1, x2 = x, x1
        return self._unblocks(torch.stack(xs[::-1]), fp)

    def _substitute(self, aux, fp):
        """Solve B~ y = fp, fp (G, n_pad) or (G, k, n_pad), by the aux's
        composition: the pivoted sweeps (FUSED_SOLVE = off), SPIKE,
        ascan, or the sequential substitution (the CUDA kernel on a CUDA
        tensor)."""
        if "interior" in aux:
            return self._solve_interior(aux["interior"], fp)
        fsub = aux["fsub"]
        if "spikeF" in fsub:
            return self._solve_interior_spike(fp, fsub)
        if aux["composition"] == "ascan" and "FwdOp" in fsub:
            return self._solve_interior_ascan(fp, fsub)
        return banded_substitution(fsub, fp)

    # ----------------------------------------------------------- solves

    def _aux_matvec(self, aux, x, mats):
        if "A" in aux:
            return self.matvec(aux["A"], x)
        a, b = aux["ab"]
        MX, LX = self.matvec_pair(*mats, x)
        return a * MX + b * LX

    def _aux_matvec_transpose(self, aux, u, mats):
        """The transpose of `_aux_matvec`: A^T u, or a M^T u + b L^T u."""
        if "A" in aux:
            return self.matvec_transpose(aux["A"], u)
        a, b = aux["ab"]
        M, L = mats
        return a * self.matvec_transpose(M, u) + b * self.matvec_transpose(
            L, u)

    def _substitute_transpose(self, aux, g):
        """S^T g for the substitution `_substitute` runs: the transposed
        kernel on the sequential composition (the plain version on a CPU
        tensor). The pivoted sweeps (FUSED_SOLVE = off), SPIKE and ascan
        launch no kernel; their transposes are taken by autograd through
        their torch ops at a zero right-hand side, as the JAX package
        takes them with jax.vjp."""
        fsub = aux.get("fsub")
        if fsub is None or "spikeF" in fsub or (
                aux["composition"] == "ascan" and "FwdOp" in fsub):
            return _transpose_by_vjp(lambda f: self._substitute(aux, f), g)
        return banded_substitution_transpose(fsub, g)

    def _solve_once_transpose(self, aux, ct):
        """The transpose of `_solve_once`, its steps run backwards: the
        column permutation, the Woodbury correction (its t x t
        capacitance transposed), one transposed substitution in the
        store's dtype (the ladder casts as the solve does), the row
        permutation; the result in ct's dtype."""
        fsub = aux.get("fsub")
        low = fsub["lastOp"].dtype if fsub is not None else ct.dtype
        ydtype = WORK_DTYPE.get(low, low)      # the substitution's output
        yb = zeropad(ct.index_select(1, self._col_perm_t).to(ydtype),
                     ((0, 0), (0, self.n_pad - self.n)))
        if self.t:
            Vt, YbT = aux["Vt"].to(ydtype), aux["YbT"].to(ydtype)
            w = torch.einsum("gtn,gn->gt", YbT, yb)
            if fsub is not None and "CapInv" in fsub:
                z = torch.einsum("gji,gj->gi", fsub["CapInv"].to(ydtype), w)
            else:
                z = lu_solve_transpose(*aux["CapLU"], w)
            yb = (yb - torch.einsum("gtn,gt->gn", Vt, z)).index_add(
                1, self._pin_pos_t, z)
        if yb.dtype != low:
            yb = yb.to(low)
        fb = self._substitute_transpose(aux, yb)
        return fb[:, :self.n].index_select(1, self._pos_row_t).to(ct.dtype)

    def _solve_once(self, aux, rhs):
        """One solve against the factored aux: the row permutation, one
        substitution over all G groups, the Woodbury correction, the
        column permutation back. Under the ladder the substitution runs
        on the low-dtype operators (bf16 ones through the kernel give
        f32, and the Woodbury pieces follow), and the result comes back
        in the right-hand side's dtype."""
        fp = rhs.index_select(1, self._row_perm_t)
        fp = zeropad(fp, ((0, 0), (0, self.n_pad - self.n)))
        fsub = aux.get("fsub")
        if fsub is not None and fsub["lastOp"].dtype != fp.dtype:
            fp = fp.to(fsub["lastOp"].dtype)
        y = self._substitute(aux, fp)
        if self.t:
            Vt, YbT = aux["Vt"].to(y.dtype), aux["YbT"].to(y.dtype)
            Vy = (torch.einsum("gtn,gn->gt", Vt, y)
                  - y[:, self._pin_pos_t])
            if fsub is not None and "CapInv" in fsub:
                z = torch.einsum("gij,gj->gi", fsub["CapInv"].to(y.dtype),
                                 Vy)
            else:
                z = torch.linalg.lu_solve(*aux["CapLU"], Vy[..., None])[..., 0]
            y = y - torch.einsum("gtn,gt->gn", YbT, z)
        return y[:, :self.n].index_select(1, self._pos_col_t).to(rhs.dtype)

    def solve_transpose(self, aux, rhs, mats=None):
        """Solve A^T x = rhs (a plain transpose) against the same factors:
        the transpose of `_solve_impl`, each step run backwards. With k
        refinement sweeps that is k + 1 transposed one-shot solves and k
        transposed residual matvecs; under REFINE_TOL > 0 the masked
        sweeps pass nothing back (at a zero right-hand side every group
        keeps its iterate), so the transpose is one transposed one-shot
        solve, as the JAX package's jax.vjp at zeros gives."""
        if (mats is None and "A" not in aux) or self._refine_tol > 0.0:
            return self._solve_once_transpose(aux, rhs)
        return transposed_refinement(
            lambda r: self._solve_once_transpose(aux, r),
            lambda u: self._aux_matvec_transpose(aux, u, mats),
            self.sweeps, rhs)

    def _solve_impl(self, aux, rhs, mats=None):
        """Solve (a*M + b*L) x = rhs (or A x = rhs, for an aux of
        `factor`) against the factored aux, polished by `sweeps`
        residual-matvec refinement sweeps against mats = (M, L) (or the
        aux's A) in the native dtype. With [precision] REFINE_TOL > 0 a
        group whose residual is below tol * max|rhs| keeps its iterate (a
        masked update: nothing waits on the device)."""
        x = self._solve_once(aux, rhs)
        if mats is None and "A" not in aux:
            return x
        tol = self._refine_tol
        if tol > 0.0:
            bn = tol * rhs.abs().amax(dim=1, keepdim=True)
        for _ in range(self.sweeps):
            r = rhs - self._aux_matvec(aux, x, mats)
            dx = self._solve_once(aux, r)
            if tol > 0.0:
                x = torch.where(r.abs().amax(dim=1, keepdim=True) > bn,
                                x + dx, x)
            else:
                x = x + dx
        return x

    def solve_report(self, aux, rhs, mats=None):
        """A solve and its achieved relative residual max|r| / max|rhs|
        as a device scalar (None when the aux has no residual matvec). A
        diagnostic, off the step path."""
        x = self.solve(aux, rhs, mats=mats)
        if mats is None and "A" not in aux:
            return x, None
        r = rhs - self._aux_matvec(aux, x, mats)
        scale = rhs.abs().max()
        return x, r.abs().max() / torch.where(scale == 0, 1.0, scale)
