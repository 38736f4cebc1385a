"""
Carry solver state across from the JAX package: numpy arrays in, this
port's equivalents on a given device out.

The JAX solver's arrays are passed as plain numpy (the caller converts
them; this module imports nothing of the JAX package):

  * the pencil state X (G, S)
  * the pencil matrix stores (M and L; an LBVP's L; real or complex):
    dense (G, S, S) arrays, or band stores {"bands", "Vt"[, "dsel"]}
  * for band stores, the MatrixStructure fields (S, NB, q, t_pins, kl, ku, row_perm,
    col_perm, pinned_positions)
  * field coefficient data by field name

so that both packages can step, solve or eigensolve from one state on
one assembled system, separately from the check that they assemble the
same system. The pencil layout is the same for every geometry the port
carries, so a polar (disk or annulus) solver's dense system carries as a
Cartesian one's does (tests/test_torch_disk.py, test_torch_annulus.py),
and so does a shell's or a ball's: their regularity-ordered tensor
components and (m, ell) group order are the JAX package's
(tests/test_torch_shell.py, tests/test_torch_ball.py; the ball's
triangular truncation is in the validity masks, which both packages
build alike). A complex-dtype cylinder's system carries too: a
DirectProduct(z, (phi, r)) tensor stores its components as (z, spin-,
spin+), the polar block rotated alone, and the pencils are the (kz, m)
groups in the JAX package's order, kz the outer index
(tests/test_torch_cylinder.py). A real-dtype cylinder's does not: in
its m = 0 groups the port drops u_z's minus-sin slot and keeps the
edge's spin slots, which the JAX package keeps and drops, so the two
packages' validity masks differ. install_system compares the carried
system's invalid slots with the solver's and raises when they differ.
A banded system carries its structure as given: the JAX
package's structure for the stress-free ball leaves the pinned base
singular (the port's first factorization repairs its own structure,
SolverBase.factor_checked), so that system carries dense.
"""

import types

import numpy as np
import torch

from ..tools.array import torch_dtype

STRUCTURE_FIELDS = ("S", "NB", "q", "t_pins", "kl", "ku", "row_perm",
                    "col_perm", "pinned_positions")


def structure(fields):
    """A structure object BandedOps accepts, from {name: value} of the
    MatrixStructure fields."""
    missing = [k for k in STRUCTURE_FIELDS if k not in fields]
    if missing:
        raise ValueError(f"structure fields missing: {missing}")
    out = {}
    for k in STRUCTURE_FIELDS:
        v = fields[k]
        out[k] = np.asarray(v, dtype=np.int64) if np.ndim(v) else int(v)
    return types.SimpleNamespace(**out)


def state(X, device, dtype=np.float64):
    """The (G, S) pencil state as a tensor on `device`."""
    return torch.as_tensor(np.array(X, dtype=dtype)).to(device)


def install_system(solver, structure_fields, matrices, X=None):
    """Install a carried pencil system into a built port solver, with its
    ops (and the state X when given). `structure_fields` None carries a
    dense system, {name: (G, S, S)}, solved with the solver's dense
    matsolver; otherwise the band stores with their structure. The
    carried system's invalid rows and columns (closure_slots) must be the
    solver's own, group by group, or this raises ValueError. `matrices`
    holds the solver's matrix names: M and L for an IVP or an EVP (real
    or complex), L for an LBVP. What follows is the solver's own: an IVP
    puts M/L on its device and drops the timestepper's factorization (the
    next step factors the carried matrices), an LBVP factors the carried
    L, an EVP eigensolves the carried host matrices."""
    # the solver's own invalid slots (a lazy EVP group leaves them zero)
    invalid_rows = ~np.asarray(solver.valid_row_mask).astype(bool)
    invalid_cols = ~np.concatenate([np.asarray(solver.layout.valid_masks_all(
        v.domain, v.tensorsig)) for v in solver.variables], axis=1) \
        .astype(bool)
    own = []
    for g in range(solver.pencil_shape[0]):
        rows, cols = closure_slots(group_matrices(solver, g))
        own.append((rows | invalid_rows[g], cols | invalid_cols[g]))
    if structure_fields is None:
        solver.structure = None
        solver._matrices = {name: np.asarray(arr)
                            for name, arr in matrices.items()}
    else:
        solver.structure = structure(structure_fields)
        solver._matrices = {name: {k: np.asarray(v) for k, v in arrs.items()}
                            for name, arrs in matrices.items()}
    # the ops under the plans the solver was built with
    solver._install_plan(solver._fusion_plan, solver._solve_plan)
    differ = [g for g, (rows, cols) in enumerate(own)
              if not all(np.array_equal(a, b) for a, b in zip(
                  (rows, cols), closure_slots(group_matrices(solver, g))))]
    if differ:
        raise ValueError(
            f"The carried system's invalid rows or columns differ from "
            f"this solver's in {len(differ)} of {len(own)} pencil groups "
            f"(first: group {differ[0]}); its validity masks are not this "
            f"solver's")
    # a carried structure is taken as given: its first factorization
    # repairs no pins
    solver._pin_repair = None
    solver._install_carried()
    if X is not None:
        install_state(solver, X)


def group_matrices(solver, g):
    """Group g's dense (S, S) host matrices in solver.matrices order: from
    the solver's host store through its ops, or an EVP's shared-pattern or
    lazy store."""
    if solver._matrices is None:
        csr = solver._group_csr(solver.subproblems[g])
        return [csr[name].toarray() for name in solver.matrices]
    return [solver.ops.densify_host(solver._matrices[name], g)
            for name in solver.matrices]


def closure_slots(mats):
    """(rows, cols) bool masks of one group's bare slots: a row zero in
    every matrix but the last, where it holds one entry, 1, in a column
    likewise zero but for that entry. The validity closure puts every
    invalid row and column there, whatever its pairing (dense or banded);
    an equation such as tau = 0 gives one too."""
    *others, last = [np.asarray(m) for m in mats]
    nz = last != 0
    other = np.zeros(nz.shape, dtype=bool)
    for m in others:
        other |= m != 0
    bare = nz & (last == 1) \
        & (nz.sum(axis=1, keepdims=True) == 1) \
        & (nz.sum(axis=0, keepdims=True) == 1) \
        & ~other.any(axis=1, keepdims=True) & ~other.any(axis=0, keepdims=True)
    return bare.any(axis=1), bare.any(axis=0)


def install_state(solver, X):
    """Set the solver's pencil state from a carried (G, S) array; the
    fields pull their data from it on access."""
    solver.X = state(X, solver.dist.device, solver.pencil_dtype)
    solver.defer_scatter(solver.X)
    solver.snapshot_versions()


def install_fields(fields, coeffs):
    """Set field coefficient data by name: `fields` {name: Field},
    `coeffs` {name: numpy coefficient array}."""
    for name, data in coeffs.items():
        f = fields[name]
        f.preset_coeff(torch.as_tensor(np.array(data)).to(
            device=f.dist.device, dtype=torch_dtype(f.coeff_dtype)))
        f.mark_modified()
