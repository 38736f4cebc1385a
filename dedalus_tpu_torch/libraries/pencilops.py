"""
Pencil operators (counterpart of dedalus_tpu/libraries/pencilops.py: DenseOps,
and BandedOps on the default plan: fused substitution, sequential
composition, native dtype). Both offer one surface (to_device, matvec,
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

The pencil batch G is the leading tensor dimension throughout.
"""

import numpy as np
import torch

from ..core.fusedstep import banded_substitution
from .matsolvers import get_solver
from .solvecomp import resolve_refine_sweeps
from ..tools.array import torch_dtype, zeropad
from ..tools.config import config


class DenseOps:
    """Dense (G, S, S) pencil operators (small problems / fallback;
    reference DenseOps, dedalus_tpu/libraries/pencilops.py:209)."""

    kind = "dense"

    def __init__(self, device, matsolver=None):
        self.device = torch.device(device)
        self.solver_cls = get_solver(matsolver)

    def to_device(self, host_mat, dtype):
        return torch.as_tensor(host_mat).to(device=self.device,
                                            dtype=torch_dtype(dtype))

    def matvec(self, A, X):
        return torch.einsum("gij,gj->gi", A, X)

    def matvec_pair(self, M, L, X):
        """(M @ X, L @ X): the two products, equal to separate calls."""
        return self.matvec(M, X), self.matvec(L, X)

    def factor(self, A):
        """Factor a matrix already on the device (an LBVP's L)."""
        return self.solver_cls.factor(A)

    def factor_lincomb(self, a, A, b, B):
        """Factor a*A + b*B. The validity-closure identity sits on the
        last matrix (L), so it stays b*I in the combination."""
        return self.solver_cls.factor(a * A + b * B)

    def solve(self, aux, rhs, mats=None):
        return self.solver_cls.solve(aux, rhs)

    def densify_host(self, host_mat, g):
        """Group g's dense (S, S) host matrix."""
        return np.asarray(host_mat[g])


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


class BandedOps:
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

    def __init__(self, structure, device):
        st = structure
        missing = [attr for attr in
                   ("S", "NB", "q", "t_pins", "kl", "ku", "row_perm",
                    "col_perm", "pinned_positions")
                   if getattr(st, attr, None) is None]
        if missing:
            raise ValueError(f"BandedOps: structure is missing {missing}")
        self.device = torch.device(device)
        # refinement sweeps per solve ([precision] REFINE_SWEEPS)
        self.sweeps = resolve_refine_sweeps()
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

    def matvec_pair(self, M, L, X):
        """(M @ X, L @ X) in ONE pass over the operand: the column
        permutation and pad run once over a shared padded X; each matrix
        keeps its own trimmed diagonal loop, so both outputs equal
        separate `matvec` calls."""
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

    def _factor_bands(self, bands):
        """Factor one full-lattice band slab (any leading batch size) into
        the precomposed substitution operators {FwdOp, BwdOp, lastOp}."""
        # identity pins at the pinned rows + padded diagonal
        bands[:, self.kl, self._pin_pos_t] = 1.0
        if self.n_pad > self.n:
            bands[:, self.kl, self.n:] = 1.0
        return self._precompose_subst(self._factor_interior(bands))

    def _woodbury(self, fsub, Vt):
        """The Woodbury pieces over the whole store: YbT = (B~^-1 E)^T,
        solved as t right-hand sides per group in one substitution, and
        the t x t capacitance inverse, put in fsub["CapInv"]."""
        G, dtype, device = Vt.shape[0], Vt.dtype, Vt.device
        # E = one-hot columns at the pin positions, kept transposed
        # (G, t, n_pad) like Y
        E = torch.zeros((G, self.t, self.n_pad), dtype=dtype, device=device)
        E[:, torch.arange(self.t, device=device), self._pin_pos_t] = 1.0
        YbT = banded_substitution(fsub, E)
        # capacitance: I + (Vt - E^T) Y
        Cap = (torch.eye(self.t, dtype=dtype, device=device)
               + Vt @ YbT.transpose(1, 2)
               - YbT[:, :, self._pin_pos_t].transpose(1, 2))
        # the t x t capacitance solve becomes one GEMM
        fsub["CapInv"] = torch.linalg.inv(Cap)
        return YbT

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
        Woodbury solve as factor_lincomb, with no M to combine. The aux
        keeps A, so the refinement residual is one matvec of A."""
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

    def _factor_store(self, G, itemsize, slab, Vts, scales, dtype):
        """Factor the full-lattice slabs `slab(lo, hi)` per G-chunk into
        one operator store over all G groups, then the Woodbury pieces of
        the pinned rows sum(scale * Vt). Returns the aux {"fsub",
        "factor_chunks"[, "Vt", "YbT"]}."""
        C, Gc = self._pick_chunks(G, itemsize)
        fsub = {}
        for i in range(C):
            lo, hi = i * Gc, min(G, (i + 1) * Gc)
            part = self._factor_bands(slab(lo, hi))
            if C == 1:
                fsub = part
                break
            for name, arr in part.items():
                axis = 0 if name == "lastOp" else 1          # the group axis
                if name not in fsub:
                    shape = list(arr.shape)
                    shape[axis] = G
                    fsub[name] = arr.new_empty(shape)
                fsub[name].narrow(axis, lo, hi - lo).copy_(arr)
            del part
        aux = {"fsub": fsub, "factor_chunks": C}
        if self.t:
            Vt = torch.zeros((G, self.t, self.n_pad), dtype=dtype,
                             device=self.device)
            for V, scale in zip(Vts, scales):
                if V is not None:
                    Vt += scale * V
            aux["Vt"] = Vt
            aux["YbT"] = self._woodbury(fsub, Vt)
        return aux

    def factor_lincomb(self, a, M, b, L):
        """Factor a*M + b*L without persisting the combined bands: the
        combination is a transient of the factorization, built per G-chunk
        (`_pick_chunks`), and the refinement residual uses matvecs of the
        resident M and L. Each chunk's operators are written into its
        slice of one store over all G groups, so a solve is one
        substitution whatever the chunk count; the Woodbury solve runs
        once over the store. Returns the aux: {"fsub", "Vt", "YbT",
        "factor_chunks", "ab"}."""
        dM = torch.as_tensor(M.dsel, device=self.device)
        dL = torch.as_tensor(L.dsel, device=self.device)
        aux = self._factor_store(
            M.bands.shape[0], M.bands.element_size(),
            lambda lo, hi: self._combine_bands(
                M.bands[lo:hi], L.bands[lo:hi], a, b, dM, dL),
            [M.Vt, L.Vt], [a, b], M.bands.dtype)
        aux["ab"] = (a, b)
        return aux

    def _aux_matvec(self, aux, x, mats):
        if "A" in aux:
            return self.matvec(aux["A"], x)
        a, b = aux["ab"]
        MX, LX = self.matvec_pair(*mats, x)
        return a * MX + b * LX

    def _solve_once(self, aux, rhs):
        """One solve against the factored aux: the row permutation, one
        substitution over all G groups, the Woodbury correction, the
        column permutation back."""
        fp = rhs.index_select(1, self._row_perm_t)
        fp = zeropad(fp, ((0, 0), (0, self.n_pad - self.n)))
        fsub = aux["fsub"]
        y = banded_substitution(fsub, fp)
        if self.t:
            Vy = (torch.einsum("gtn,gn->gt", aux["Vt"], y)
                  - y[:, self._pin_pos_t])
            z = torch.einsum("gij,gj->gi", fsub["CapInv"], Vy)
            y = y - torch.einsum("gtn,gt->gn", aux["YbT"], z)
        return y[:, :self.n].index_select(1, self._pos_col_t)

    def solve(self, aux, rhs, mats=None):
        """Solve (a*M + b*L) x = rhs (or A x = rhs, for an aux of
        `factor`) against the factored aux, polished by the
        residual-matvec refinement sweeps against mats = (M, L) (or the
        aux's A)."""
        x = self._solve_once(aux, rhs)
        for _ in range(self.sweeps):
            r = rhs - self._aux_matvec(aux, x, mats)
            x = x + self._solve_once(aux, r)
        return x
