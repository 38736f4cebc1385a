"""
Batched dense pencil matrix solvers (counterpart of
dedalus_tpu/libraries/matsolvers.py).

The pencil index G is the leading batch dimension: factorizations and
solves are batched dense torch.linalg calls on the solver's device.

    aux = Solver.factor(matrices)   # (G, S, S) -> factored aux
    aux, count = Solver.factor_counted(matrices)  # and the floored pivots
    x   = Solver.solve(aux, rhs)    # (G, S) -> (G, S)
    x   = Solver.solve_transpose(aux, rhs)   # A^T x = rhs, same factors

`solve_transpose` is the plain transpose (no conjugation), the backward
pass of a solve (libraries/pencilops.py AdjointSolveOps).
"""

import torch

matsolvers = {}


def lu_solve_transpose(LU, pivots, b):
    """A^T x = b from torch's LU of A, b (G, S): lu_solve's adjoint form
    solves A^H, so a complex b goes through conj on both sides."""
    if b.is_complex():
        return torch.linalg.lu_solve(LU, pivots, b.conj_physical()[..., None],
                                     adjoint=True)[..., 0].conj_physical()
    return torch.linalg.lu_solve(LU, pivots, b[..., None],
                                 adjoint=True)[..., 0]


def transposed_refinement(once_t, matvec_t, sweeps, g):
    """The transpose of `sweeps` refinement sweeps x += once(b - A x)
    after x = once(b), run backwards: each transposed one-shot solve
    `once_t` feeds the right-hand side's cotangent and, through the
    transposed matvec `matvec_t` (A^T), the iterate's; one more
    transposed one-shot solve ends it."""
    c_rhs, c_x = None, g
    for _ in range(sweeps):
        u = once_t(c_x)
        c_rhs = u if c_rhs is None else c_rhs + u
        c_x = c_x - matvec_t(u)
    x = once_t(c_x)
    return x if c_rhs is None else c_rhs + x


def add_solver(cls):
    """Register a solver class by lowercase name (reference:
    libraries/matsolvers.py:11 add_solver)."""
    matsolvers[cls.__name__.lower()] = cls
    return cls


def amax_abs(x, dim):
    """max |x| over `dim`; for a real x without the |x| copy (an LU
    store can be GBs)."""
    if x.is_complex():
        return x.abs().amax(dim=dim)
    return torch.maximum(x.amax(dim=dim), x.amin(dim=dim).neg())


def pivot_floor(LU, size=None):
    """The pivot floor size * eps * max|LU| of each group (..., 1), with
    `size` the system size (default the factor's own)."""
    eps = torch.finfo(LU.real.dtype if LU.is_complex() else LU.dtype).eps
    size = LU.shape[-1] if size is None else size
    return size * eps * amax_abs(LU, (-2, -1))[..., None]


# A pivot under the factor's floor is singular only where it is also
# under COLUMN_ULPS * eps of its own column of U. The rounding residue of
# a null direction sits at ~10-20 eps of its column (the Chebyshev^2
# rectangle's corner modes: 11.5 eps in f32, 21.6 eps in f64), while the
# smallest pivots of a nonsingular pencil whose columns are scaled by
# dt (the Coriolis shell, condition ~1e9: 6.4e-9 of max|LU|, under the
# f32 floor S eps32 max|LU| = 2.2e-4 max|LU|) sit at 117 eps32 of theirs.
COLUMN_ULPS = 50


def column_scale(LU, chunk_bytes=1 << 28):
    """max |U[i, j]| over i <= j for each column j of packed LU factors
    (..., S, S) -> (..., S), over chunks of the leading axis of at most
    `chunk_bytes` so the triangle's copy stays small beside a large
    store."""
    if LU.dim() < 3:
        return amax_abs(torch.triu(LU), -2)
    per = max(1, chunk_bytes // max(1, LU[0].numel() * LU.element_size()))
    return torch.cat([amax_abs(torch.triu(LU[i:i + per]), -2)
                      for i in range(0, LU.shape[0], per)])


def singular_pivots(LU, floor=None, scale=None):
    """Mask (..., S) of the pivots of packed LU factors below the pivot
    floor and below COLUMN_ULPS * eps of their column's scale (`scale`,
    default column_scale(LU); False for the floor alone)."""
    d = LU.diagonal(dim1=-2, dim2=-1).abs()
    floor = pivot_floor(LU) if floor is None else floor
    mask = d < floor
    if scale is not False:
        scale = column_scale(LU) if scale is None else scale
        eps = torch.finfo(d.dtype).eps
        mask = mask & (d < COLUMN_ULPS * eps * scale)
    return mask


def count_floored_pivots(LU, floor=None, scale=None):
    """Per-group count (a device tensor, one entry per leading index) of
    the pivots of packed LU factors that floor_pivots raises
    (singular_pivots), the mark of a singular pencil. Computed on the
    device; nothing waits on it."""
    return singular_pivots(LU, floor, scale).sum(dim=-1)


def floor_pivots(LU, floor=None, mask=None):
    """LU factors with every singular pivot (singular_pivots: below
    S * eps * max|LU| of its group and below COLUMN_ULPS * eps of its
    column) raised to the floor S * eps * max|LU| (keeping its phase; an
    exact zero becomes +floor). Such a pivot marks a structurally
    singular pencil (the annulus example's m = 0 group: a pressure
    profile against the velocity taus), where the plain factors amplify
    the right-hand side's roundoff by 1/pivot (~1e35) and the null-space
    component of the state grows each step until it overflows. With the
    floor a solve returns a bounded member of the solution set. The
    pivots of a nonsingular pencil stay bit for bit as they were, in
    f32 too, where a column scaled by dt puts them under S eps32
    max|LU|. `mask` is singular_pivots(LU, floor) where the caller has
    it. All on the device: nothing waits on it."""
    diag = LU.diagonal(dim1=-2, dim2=-1)
    floor = pivot_floor(LU) if floor is None else floor
    mask = singular_pivots(LU, floor) if mask is None else mask
    phase = torch.sgn(diag)
    phase = torch.where(phase == 0, torch.ones_like(phase), phase)
    new = torch.where(mask, floor * phase, diag)
    return torch.diagonal_scatter(LU, new, dim1=-2, dim2=-1)


class CountsFlooredPivots:
    """`factor_counted(matrices)` -> (aux, count): the factorization and
    the per-group count of its pivots below the floor (a device tensor).
    A solver that factors without an LU of its own (an inverse, a solve
    per call) counts on a separate LU of the same matrices, leaving its
    factors and results as they were; BatchedLUFactorized counts on its
    own factors before it floors them."""

    @classmethod
    def factor_counted(cls, matrices):
        with torch.no_grad():
            LU, _, _ = torch.linalg.lu_factor_ex(matrices.detach())
            count = count_floored_pivots(LU)
        return cls.factor(matrices), count


@add_solver
class BatchedLUFactorized(CountsFlooredPivots):
    """Batched dense LU with partial pivoting (the default dense solver off
    the TPU), its pivots floored (floor_pivots). The factorization runs
    without its error check, so no factor waits on the device."""

    @staticmethod
    def factor(matrices):
        LU, pivots, _ = torch.linalg.lu_factor_ex(matrices)
        return floor_pivots(LU), pivots

    @staticmethod
    def factor_counted(matrices):
        LU, pivots, _ = torch.linalg.lu_factor_ex(matrices)
        floor = pivot_floor(LU)
        mask = singular_pivots(LU, floor)
        return (floor_pivots(LU, floor, mask), pivots), mask.sum(dim=-1)

    @staticmethod
    def solve(aux, rhs):
        LU, pivots = aux
        return torch.linalg.lu_solve(LU, pivots, rhs[..., None])[..., 0]

    @staticmethod
    def solve_transpose(aux, rhs):
        return lu_solve_transpose(*aux, rhs)


@add_solver
class BatchedInverse(CountsFlooredPivots):
    """Precomputed batched inverse: each solve is one batched
    matrix-vector product (reference SparseInverse/DenseInverse,
    libraries/matsolvers.py:223)."""

    @staticmethod
    def factor(matrices):
        return torch.linalg.inv(matrices)

    @staticmethod
    def solve(inv, rhs):
        return torch.einsum("gij,gj->gi", inv, rhs)

    @staticmethod
    def solve_transpose(inv, rhs):
        return torch.einsum("gji,gj->gi", inv, rhs)


@add_solver
class BatchedInverseRefined(CountsFlooredPivots):
    """
    Mixed-precision dense solver (dedalus_tpu/libraries/matsolvers.py:76):
    the inverse is computed once in the low dtype and each solve is
    polished by iterative refinement with native-precision residual
    matvecs. The sweep count, the residual tolerance and the low dtype
    are class attributes bound per solver build (`refined_ladder`), and
    the refinement runs a fixed number of sweeps; with `tol` > 0 a group
    whose residual is below tol * max|rhs| keeps its iterate (a masked
    update: nothing waits on the device).
    """

    iterations = 3        # bound per build by refined_ladder()
    tol = 0.0             # 0: every sweep applies
    low_name = "f32"      # 'f32' or 'bf16' (libraries/solvecomp.py)

    @classmethod
    def _low(cls, dtype):
        from .solvecomp import low_dtype
        return low_dtype(cls.low_name, dtype)

    @classmethod
    def factor(cls, matrices):
        low = cls._low(matrices.dtype)
        # bf16 has no batched inverse: invert the bf16-rounded matrices
        # in f32 and store the result in bf16
        work = torch.float32 if low == torch.bfloat16 else low
        inv, _ = torch.linalg.inv_ex(matrices.to(low).to(work))
        return matrices, inv.to(low)

    @classmethod
    def _apply(cls, inv_low, r):
        return torch.einsum("gij,gj->gi", inv_low,
                            r.to(inv_low.dtype)).to(r.dtype)

    @classmethod
    def solve(cls, aux, rhs):
        A, inv_low = aux
        x = cls._apply(inv_low, rhs)
        if cls.tol > 0.0:
            bn = cls.tol * rhs.abs().amax(dim=-1, keepdim=True)
        for _ in range(cls.iterations):
            r = rhs - torch.einsum("gij,gj->gi", A, x)
            dx = cls._apply(inv_low, r)
            if cls.tol > 0.0:
                rn = r.abs().amax(dim=-1, keepdim=True)
                x = torch.where(rn > bn, x + dx, x)
            else:
                x = x + dx
        return x

    @classmethod
    def solve_transpose(cls, aux, rhs):
        """The transpose of `solve`, its sweeps run backwards: each
        transposed low-dtype apply feeds the right-hand side's cotangent
        and, through A^T, the iterate's. With `tol` > 0 the masked sweeps
        pass nothing back at a zero right-hand side (the JAX package's
        jax.vjp at zeros), leaving one transposed apply."""
        A, inv_low = aux

        def apply_t(r):
            return torch.einsum("gji,gj->gi", inv_low,
                                r.to(inv_low.dtype)).to(r.dtype)

        return transposed_refinement(
            apply_t, lambda u: torch.einsum("gji,gj->gi", A, u),
            0 if cls.tol > 0.0 else cls.iterations, rhs)

    @classmethod
    def residual(cls, aux, x, rhs):
        """Achieved relative residual per group (device values; a
        diagnostic, off the step path)."""
        A, _ = aux
        r = rhs - torch.einsum("gij,gj->gi", A, x)
        bn = rhs.abs().amax(dim=-1)
        return r.abs().amax(dim=-1) / torch.where(bn == 0, 1.0, bn)


def refined_ladder(plan):
    """A per-build BatchedInverseRefined subclass bound to the resolved
    `[precision]` plan (libraries/solvecomp.SolvePlan): the dense arm of
    the precision ladder."""
    low = plan.dtype if plan.dtype != "native" else "f32"
    sweeps = plan.sweeps if plan.sweeps is not None \
        else BatchedInverseRefined.iterations
    return type("BatchedInverseLadder", (BatchedInverseRefined,),
                {"iterations": int(sweeps), "tol": float(plan.tol),
                 "low_name": low})


@add_solver
class BatchedDenseSolve(CountsFlooredPivots):
    """Factor-per-solve (reference ScipyDenseLU analogue); aux = matrices."""

    @staticmethod
    def factor(matrices):
        return matrices

    @staticmethod
    def solve(matrices, rhs):
        return torch.linalg.solve(matrices, rhs[..., None])[..., 0]

    @staticmethod
    def solve_transpose(matrices, rhs):
        return torch.linalg.solve(matrices.mT, rhs[..., None])[..., 0]


@add_solver
class DummySolver(CountsFlooredPivots):
    """Testing solver returning zeros (reference: libraries/matsolvers.py:32)."""

    @staticmethod
    def factor(matrices):
        return matrices

    @staticmethod
    def solve(aux, rhs):
        return torch.zeros_like(rhs)

    solve_transpose = solve


def get_solver(spec):
    """The solver class for a registered name (any case) or a class;
    None is BatchedLUFactorized. BatchedInverseRefined comes bound to the
    `[precision]` schedule the config resolves to now."""
    if spec is None:
        return BatchedLUFactorized
    if isinstance(spec, str):
        name = spec.lower()
        if name not in matsolvers:
            raise ValueError(
                f"Unknown matsolver {spec!r}: 'auto', 'banded', 'dense' or "
                f"one of {sorted(matsolvers)}")
        spec = matsolvers[name]
    if spec is BatchedInverseRefined:
        from .solvecomp import resolve_solve_plan
        return refined_ladder(resolve_solve_plan())
    return spec
