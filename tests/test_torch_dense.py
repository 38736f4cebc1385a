"""
The dense pencil path of the port (dedalus_tpu_torch/libraries/
matsolvers.py, DenseOps, the MATRIX_SOLVER path choice of
core/solvers.py) held against the JAX package: each matsolver on the same
random well-conditioned matrices to 1e-13 relative, DenseOps on the
matrices carried from a JAX shear 16x16 solver to 1e-13, the assembled
dense M and L bit-equal (np.array_equal) on shear 16x16, KdV 64 and RB
8x32, and the same path as the JAX package for the same matsolver and
BANDED_CUTOFF_BYTES.
"""

import sys
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "benchmarks"))
from progression import build_kdv, build_shear  # noqa: E402

from dedalus_tpu.extras.bench_problems import build_rb_solver as jax_rb  # noqa: E402
from dedalus_tpu.libraries import matsolvers as jax_matsolvers  # noqa: E402
from dedalus_tpu.tools.config import config as jconfig  # noqa: E402
from dedalus_tpu_torch.extras.bench_problems import (  # noqa: E402
    build_kdv_solver, build_shear_solver, build_rb_solver as torch_rb)
from dedalus_tpu_torch.libraries import matsolvers  # noqa: E402
from dedalus_tpu_torch.libraries.pencilops import DenseOps  # noqa: E402
from dedalus_tpu_torch.tools import carry  # noqa: E402
from dedalus_tpu_torch.tools.config import config as tconfig  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-13


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def random_system(G=16, S=12, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((G, S, S)) + S * np.eye(S)
    return A, rng.standard_normal((G, S))


@pytest.mark.parametrize("name", ["BatchedLUFactorized", "BatchedInverse",
                                  "BatchedDenseSolve"])
def test_matsolver_matches_jax(name):
    A, rhs = random_system()
    jcls = jax_matsolvers.get_solver(name)
    ref = np.asarray(jcls.solve(jcls.factor(jnp.asarray(A)),
                                jnp.asarray(rhs)))
    tcls = matsolvers.get_solver(name)
    out = tcls.solve(tcls.factor(torch.as_tensor(A)),
                     torch.as_tensor(rhs)).numpy()
    assert rel_err(out, ref) <= RTOL
    # and it solves the system
    assert rel_err(np.einsum("gij,gj->gi", A, out), rhs) <= RTOL


def test_dummy_solver_returns_zeros_like_jax():
    A, rhs = random_system()
    jcls = jax_matsolvers.get_solver("DummySolver")
    tcls = matsolvers.get_solver("dummysolver")
    ref = np.asarray(jcls.solve(jcls.factor(jnp.asarray(A)),
                                jnp.asarray(rhs)))
    out = tcls.solve(tcls.factor(torch.as_tensor(A)), torch.as_tensor(rhs))
    assert out.shape == ref.shape and not out.any() and not ref.any()


@pytest.mark.parametrize("spec,match", [
    ("BatchedInverseRefined", "precision-ladder slice"),
    ("superlu", "Unknown matsolver")])
def test_matsolver_not_carried_raises(spec, match):
    with pytest.raises(ValueError, match=match):
        matsolvers.get_solver(spec)


@pytest.fixture(scope="module")
def shear16():
    js, dt = build_shear(16, np.float64)
    ts, _ = build_shear_solver(16, device="cpu")
    return js, ts, dt


def test_dense_ops_on_carried_matrices(shear16):
    """matvec, matvec_pair, factor_lincomb and solve of DenseOps on the M/L
    of a JAX shear 16x16 solver, against the JAX DenseOps."""
    js, _, dt = shear16
    jops = js.ops
    assert jops.kind == "dense"
    M = np.asarray(js._matrices["M"])
    L = np.asarray(js._matrices["L"])
    X = np.asarray(js.X)
    ops = DenseOps("cpu", "BatchedLUFactorized")
    tM = ops.to_device(M, np.float64)
    tL = ops.to_device(L, np.float64)
    tX = torch.as_tensor(np.array(X))
    jM, jL = jnp.asarray(M), jnp.asarray(L)
    assert rel_err(ops.matvec(tL, tX).numpy(),
                   np.asarray(jops.matvec(jL, jnp.asarray(X)))) <= RTOL
    pair = ops.matvec_pair(tM, tL, tX)
    jpair = jops.matvec_pair(jM, jL, jnp.asarray(X))
    for out, ref in zip(pair, jpair):
        assert rel_err(out.numpy(), np.asarray(ref)) <= RTOL
    a, b = 1.0, dt * (2 - np.sqrt(2)) / 2
    aux = ops.factor_lincomb(a, tM, b, tL)
    jaux = jops.factor_lincomb(a, jM, b, jL)
    x = ops.solve(aux, tX, mats=(tM, tL)).numpy()
    ref = np.asarray(jops.solve(jaux, jnp.asarray(X), mats=(jM, jL)))
    assert rel_err(x, ref) <= RTOL


def test_step_from_carried_dense_system_matches_jax():
    """tools/carry.py with a dense system: a JAX shear 16x16 solver's M/L
    and mid-run state installed into a port solver; both step 5 more
    times (RK222) to 1e-12."""
    js, dt = build_shear(16, np.float64)
    ts, _ = build_shear_solver(16, device="cpu")
    for _ in range(3):
        js.step(dt)
    matrices = {name: np.asarray(js._matrices[name]) for name in "ML"}
    carry.install_system(ts, None, matrices, X=np.asarray(js.X))
    ts.iteration = js.iteration
    ts.sim_time = js.sim_time
    for _ in range(5):
        js.step(dt)
        ts.step(dt)
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= 1e-12


def _pair(kind):
    if kind == "shear16":
        js, _ = build_shear(16, np.float64)
        ts, _ = build_shear_solver(16, device="cpu")
    elif kind == "kdv64":
        js, _ = build_kdv(64, np.float64)
        ts, _ = build_kdv_solver(64, device="cpu")
    else:
        js, _ = jax_rb(8, 32, np.float64)
        ts, _ = torch_rb(8, 32, np.float64, device="cpu")
    return js, ts


@pytest.mark.parametrize("kind", ["shear16", "kdv64", "rb8x32"])
def test_dense_matrices_bit_equal(kind):
    """matsolver=None ('auto' below the cutoff): the dense M and L of both
    packages, validity-closure identity included, are the same arrays."""
    js, ts = _pair(kind)
    assert js.ops.kind == ts.ops.kind == "dense"
    assert ts.structure is None
    for name in ("M", "L"):
        ref = np.asarray(js._matrices[name])
        out = ts._matrices[name]
        assert out.shape == ref.shape == (ts.pencil_shape[0],
                                          ts.pencil_shape[1],
                                          ts.pencil_shape[1])
        assert np.array_equal(out, ref)
        assert np.array_equal(getattr(ts, name + "_mat").numpy(), ref)
    assert np.array_equal(ts.valid_row_mask, js.valid_row_mask)


def test_dense_closure_matches_per_group_loop(shear16):
    """The vectorized validity closure of _dense_from_batched equals the
    JAX package's per-group loop (dedalus_tpu/core/solvers.py:284-287) on
    the same batched store."""
    from dedalus_tpu_torch.core.batched_assembly import batched_system_coos
    _, ts, _ = shear16
    batched = batched_system_coos(ts.layout, ts.equations, ts.variables,
                                  ts.matrices, subproblems=ts.subproblems,
                                  partial=True)
    pr, pc, vals, row_valid, col_valid = batched
    G, S = ts.pencil_shape
    ref = np.zeros((G, S, S))
    ref[:, pr, pc] = vals["L"]
    for g in range(G):
        ref[g, np.flatnonzero(~row_valid[g]),
            np.flatnonzero(~col_valid[g])] = 1.0
    assert (~row_valid).any()
    out = ts._dense_from_batched(batched, ts.matrices)
    assert np.array_equal(out["L"], ref)
    assert np.array_equal(out["L"], ts._matrices["L"])


@pytest.fixture
def cutoff():
    """Set [linear algebra] BANDED_CUTOFF_BYTES alike in both packages."""
    sections = (jconfig["linear algebra"], tconfig["linear algebra"])
    old = [s["BANDED_CUTOFF_BYTES"] for s in sections]

    def set_cutoff(value):
        for s in sections:
            s["BANDED_CUTOFF_BYTES"] = str(value)

    yield set_cutoff
    for s, value in zip(sections, old):
        s["BANDED_CUTOFF_BYTES"] = value


@pytest.mark.parametrize("kind,cutoff_bytes,path", [
    ("rb8x32", None, "dense"),
    ("rb8x32", 1000, "banded"),
    ("shear16", 0, "dense")])
def test_default_matsolver_takes_the_jax_path(cutoff, kind, cutoff_bytes,
                                              path):
    """matsolver=None follows [linear algebra] MATRIX_SOLVER = auto as the
    JAX package does: dense RB 8x32 at the default cutoff; banded once the
    cutoff (1000 bytes) is below its dense size; and an all-Fourier
    problem above the cutoff falls back to dense (no coupled axis)."""
    if cutoff_bytes is not None:
        cutoff(cutoff_bytes)
    js, ts = _pair(kind)
    assert ts.matsolver == js.matsolver == "auto"
    assert ts.ops.kind == js.ops.kind == path
    if path == "dense":
        for name in ("M", "L"):
            assert np.array_equal(ts._matrices[name],
                                  np.asarray(js._matrices[name]))


def test_forced_banded_raises_on_all_fourier_like_jax():
    """matsolver='banded' on the shear problem (no coupled axis) raises in
    both packages."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    for d3, kw in ((jd3, {}), (td3, {"device": "cpu"})):
        coords = d3.CartesianCoordinates("x", "z")
        dist = d3.Distributor(coords, dtype=np.float64, **kw)
        xb = d3.RealFourier(coords["x"], size=8, bounds=(0, 1))
        zb = d3.RealFourier(coords["z"], size=8, bounds=(0, 1))
        s = dist.Field(name="s", bases=(xb, zb))
        problem = d3.IVP([s], namespace=locals())
        problem.add_equation("dt(s) - lap(s) = 0")
        with pytest.raises(ValueError,
                           match="Banded solve forced but not applicable"):
            problem.build_solver(d3.RK222, matsolver="banded")
