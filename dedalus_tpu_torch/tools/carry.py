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
same system.
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
    matsolver; otherwise the band stores with their structure. `matrices`
    holds the solver's matrix names: M and L for an IVP or an EVP (real
    or complex), L for an LBVP. What follows is the solver's own: an IVP
    puts M/L on its device and drops the timestepper's factorization (the
    next step factors the carried matrices), an LBVP factors the carried
    L, an EVP eigensolves the carried host matrices."""
    from ..libraries.pencilops import BandedOps, DenseOps
    if structure_fields is None:
        solver.structure = None
        solver.ops = DenseOps(solver.dist.device, solver._dense_solver)
        solver._matrices = {name: np.asarray(arr)
                            for name, arr in matrices.items()}
    else:
        st = structure(structure_fields)
        solver.structure = st
        solver.ops = BandedOps(st, solver.dist.device)
        solver._matrices = {name: {k: np.asarray(v) for k, v in arrs.items()}
                            for name, arrs in matrices.items()}
    solver._install_carried()
    if X is not None:
        install_state(solver, X)


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
