"""
The port's banded substitution (dedalus_tpu_torch/core/fusedstep.py) held
against the JAX package's Pallas kernel
(dedalus_tpu.core.fusedstep.pallas_substitution, interpret mode on CPU, as
tests/test_fusion.py runs it), on random operators and on the factor
operators of the RB 8x32 solver; complex operators against the JAX
package's fused XLA substitution (the Pallas kernel's interpret mode
refuses complex128), and so are operators at 3-D Rayleigh-Benard's block
size q = 80, one column and sixteen. The CUDA kernel itself is held
against the plain version in tests/test_torch_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedalus_tpu.core.fusedstep import pallas_substitution
from dedalus_tpu_torch.core import fusedstep as tfused

torch.set_num_threads(1)

RTOL = 1e-13


def random_fsub(rng, G, NB, q):
    """Random substitution operators scaled so the sweeps neither grow
    nor decay fast (entries ~ N(0, 1) / (2 sqrt(width)))."""
    return {
        "FwdOp": rng.standard_normal((NB - 1, G, 4 * q * q)) / (2 * np.sqrt(2 * q)),
        "BwdOp": rng.standard_normal((NB - 1, G, 3 * q * q)) / (2 * np.sqrt(3 * q)),
        "lastOp": rng.standard_normal((G, q, q)) / (2 * np.sqrt(q)),
    }


def jax_subst(fsub, fp):
    q = fsub["lastOp"].shape[-1]
    out = pallas_substitution({k: jnp.asarray(v) for k, v in fsub.items()},
                              jnp.asarray(fp), q)
    return np.asarray(out)


def torch_fsub(fsub, device="cpu", dtype=torch.float64):
    return {k: torch.as_tensor(np.array(v)).to(device=device, dtype=dtype)
            for k, v in fsub.items()}


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("G,NB,q", [(3, 2, 4), (3, 5, 4), (2, 9, 8)])
def test_plain_matches_pallas_random(G, NB, q):
    rng = np.random.default_rng(1234 + NB)
    fsub = random_fsub(rng, G, NB, q)
    fp = rng.standard_normal((G, NB * q))
    ref = jax_subst(fsub, fp)
    out = tfused.substitution_plain(torch_fsub(fsub),
                                    torch.as_tensor(fp)).numpy()
    assert rel_err(out, ref) <= RTOL


@pytest.fixture(scope="module")
def rb_factor_ops():
    """The JAX RB 8x32 solver's factor operators after one RK222 step."""
    from dedalus_tpu.extras.bench_problems import build_rb_solver
    solver, _ = build_rb_solver(8, 32, np.float64, matsolver="banded")
    solver.step(0.01)
    fsub = solver.timestepper._lhs_aux[0]["fsub"]
    return {k: np.asarray(fsub[k]) for k in ("FwdOp", "BwdOp", "lastOp")}


def test_plain_matches_pallas_rb_factors(rb_factor_ops):
    fsub = rb_factor_ops
    G, q = fsub["lastOp"].shape[:2]
    NB = fsub["FwdOp"].shape[0] + 1
    assert NB > 1
    fp = np.random.default_rng(7).standard_normal((G, NB * q))
    ref = jax_subst(fsub, fp)
    out = tfused.substitution_plain(torch_fsub(fsub),
                                    torch.as_tensor(fp)).numpy()
    assert rel_err(out, ref) <= RTOL


def jax_fused_subst(fsub, fp):
    """The JAX package's fused XLA substitution (BandedOps.
    _solve_interior_fused, the sequential composition: the path its
    default plan takes off the TPU, and the one that takes complex data;
    the Pallas kernel in interpret mode refuses complex128)."""
    import types
    from dedalus_tpu.libraries.pencilops import BandedOps
    G, q = fsub["lastOp"].shape[:2]
    NB = fsub["FwdOp"].shape[0] + 1
    ops = types.SimpleNamespace(q=q, NB=NB, n_pad=NB * q,
                                _composition="sequential")
    out = BandedOps._solve_interior_fused(
        ops, None, jnp.asarray(fp)[..., None],
        {k: jnp.asarray(v) for k, v in fsub.items()})
    return np.asarray(out)[..., 0]


@pytest.mark.parametrize("G,NB,q", [(3, 5, 6), (4, 9, 7), (2, 2, 6)])
def test_plain_matches_jax_complex(G, NB, q):
    """Complex operators and right-hand side (the ComplexFourier banded
    solves): the plain version against the JAX fused solve (bound 1e-13
    relative)."""
    rng = np.random.default_rng(4321 + NB)
    re, im = random_fsub(rng, G, NB, q), random_fsub(rng, G, NB, q)
    fsub = {k: (re[k] + 1j * im[k]) / np.sqrt(2) for k in re}
    fp = rng.standard_normal((G, NB * q)) + 1j * rng.standard_normal(
        (G, NB * q))
    ref = jax_fused_subst(fsub, fp)
    out = tfused.substitution_plain(
        torch_fsub(fsub, dtype=torch.complex128), torch.as_tensor(fp))
    assert out.dtype == torch.complex128
    assert rel_err(out.numpy(), ref) <= RTOL


@pytest.mark.parametrize("k", [1, 16])
def test_plain_matches_jax_at_q80(k):
    """3-D Rayleigh-Benard's block size q = 80 (above the kernel's former
    bound 64), one column and the k = 16 Woodbury form: the plain version
    against the JAX fused XLA substitution (bound 1e-13 relative)."""
    rng = np.random.default_rng(80 + k)
    G, NB, q = 2, 4, 80
    fsub = random_fsub(rng, G, NB, q)
    fp = rng.standard_normal((G, k, NB * q))
    ref = np.stack([jax_fused_subst(fsub, fp[:, c]) for c in range(k)],
                   axis=1)
    out = tfused.substitution_plain(torch_fsub(fsub), torch.as_tensor(
        fp if k > 1 else fp[:, 0]))
    assert rel_err(out.numpy().reshape(ref.shape), ref) <= RTOL
