"""
Batched dense pencil matrix solvers (counterpart of
dedalus_tpu/libraries/matsolvers.py).

The pencil index G is the leading batch dimension: factorizations and
solves are batched dense torch.linalg calls on the solver's device.

    aux = Solver.factor(matrices)   # (G, S, S) -> factored aux
    x   = Solver.solve(aux, rhs)    # (G, S) -> (G, S)
"""

import torch

matsolvers = {}

# the JAX package's mixed-precision dense solver: a TPU rule (its
# factorization only runs in 32 bits there) tied to the [precision]
# ladder, which comes with the precision-ladder slice of the port
LADDER_SOLVERS = ("batchedinverserefined",)


def add_solver(cls):
    """Register a solver class by lowercase name (reference:
    libraries/matsolvers.py:11 add_solver)."""
    matsolvers[cls.__name__.lower()] = cls
    return cls


@add_solver
class BatchedLUFactorized:
    """Batched dense LU with partial pivoting (the default dense solver off
    the TPU). The factorization runs without its error check, so no
    factor waits on the device."""

    @staticmethod
    def factor(matrices):
        LU, pivots, _ = torch.linalg.lu_factor_ex(matrices)
        return LU, pivots

    @staticmethod
    def solve(aux, rhs):
        LU, pivots = aux
        return torch.linalg.lu_solve(LU, pivots, rhs[..., None])[..., 0]


@add_solver
class BatchedInverse:
    """Precomputed batched inverse: each solve is one batched
    matrix-vector product (reference SparseInverse/DenseInverse,
    libraries/matsolvers.py:223)."""

    @staticmethod
    def factor(matrices):
        return torch.linalg.inv(matrices)

    @staticmethod
    def solve(inv, rhs):
        return torch.einsum("gij,gj->gi", inv, rhs)


@add_solver
class BatchedDenseSolve:
    """Factor-per-solve (reference ScipyDenseLU analogue); aux = matrices."""

    @staticmethod
    def factor(matrices):
        return matrices

    @staticmethod
    def solve(matrices, rhs):
        return torch.linalg.solve(matrices, rhs[..., None])[..., 0]


@add_solver
class DummySolver:
    """Testing solver returning zeros (reference: libraries/matsolvers.py:32)."""

    @staticmethod
    def factor(matrices):
        return matrices

    @staticmethod
    def solve(aux, rhs):
        return torch.zeros_like(rhs)


def get_solver(spec):
    """The solver class for a registered name (any case) or a class;
    None is BatchedLUFactorized."""
    if spec is None:
        return BatchedLUFactorized
    if not isinstance(spec, str):
        return spec
    name = spec.lower()
    if name in LADDER_SOLVERS:
        raise ValueError(
            f"matsolver {spec!r} is the JAX package's mixed-precision "
            "ladder solver; dedalus_tpu_torch brings it with the "
            "precision-ladder slice (ROADMAP queue 1, slice 10)")
    if name not in matsolvers:
        raise ValueError(
            f"Unknown matsolver {spec!r}: 'auto', 'banded', 'dense' or one "
            f"of {sorted(matsolvers)}")
    return matsolvers[name]
