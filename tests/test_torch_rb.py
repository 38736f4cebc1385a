"""
The Rayleigh-Benard IVP main path of the port (dedalus_tpu_torch) held
against the JAX package: RB 8x32 and 32x16 (RealFourier x ChebyshevT,
dealias 3/2, RK222, banded, f64), same seed, dt = 0.01, 10 steps. The
states agree to 1e-12 relative (the cross-program tolerance class of
served-vs-direct RB, CHANGES.md PR 11/12). The boundary conditions hold
on the port's own state. And, through tools/carry.py, both packages step
from one state on one assembled system.
"""

import numpy as np
import pytest
import torch

from dedalus_tpu.extras.bench_problems import build_rb_solver as jax_rb
from dedalus_tpu_torch.extras.bench_problems import build_rb_solver as torch_rb
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.tools import carry

torch.set_num_threads(1)

RTOL = 1e-12
DT = 0.01
STEPS = 10


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.fixture(scope="module", params=[(8, 32), (32, 16)],
                ids=["rb8x32", "rb32x16"])
def stepped(request):
    Nx, Nz = request.param
    js, jb = jax_rb(Nx, Nz, np.float64, matsolver="banded")
    ts, tb = torch_rb(Nx, Nz, np.float64, matsolver="banded", device="cpu")
    for _ in range(STEPS):
        js.step(DT)
        ts.step(DT)
    return js, ts, jb, tb


def test_trajectory_matches_jax(stepped):
    js, ts, _, _ = stepped
    x_ref = np.asarray(js.X)
    x = ts.X.numpy()
    assert np.isfinite(x).all()
    assert rel_err(x, x_ref) <= RTOL
    assert ts.iteration == js.iteration == STEPS
    assert ts.sim_time == pytest.approx(js.sim_time, rel=0, abs=1e-15)


def test_fields_match_jax_in_grid_space(stepped):
    js, ts, jb, tb = stepped
    assert rel_err(tb["g"], np.asarray(jb["g"])) <= RTOL


def test_boundary_conditions_hold(stepped):
    """b(z=0) = Lz, b(z=Lz) = 0 and u(z=0) = u(z=Lz) = 0 on the port's
    stepped state."""
    _, ts, _, tb = stepped
    u = next(v for v in ts.variables if v.name == "u")
    bot = td3.Interpolate(tb, "z", 0.0).evaluate()["g"]
    top = td3.Interpolate(tb, "z", 1.0).evaluate()["g"]
    assert np.max(np.abs(bot - 1.0)) <= 1e-12
    assert np.max(np.abs(top)) <= 1e-12
    for z in (0.0, 1.0):
        assert np.max(np.abs(td3.Interpolate(u, "z", z).evaluate()["g"])) <= 1e-12


def test_incompressibility_residual(stepped):
    """trace(grad_u) + tau_p = 0, the first equation of the system, with
    grad_u = grad(u) + ez*lift(tau_u1) as the problem defines it."""
    _, ts, _, _ = stepped
    names = {v.name: v for v in ts.variables}
    u, tau_p, tau_u1 = names["u"], names["tau_p"], names["tau_u1"]
    _, ez = u.tensorsig[0].unit_vector_fields(u.dist)
    lift_basis = u.domain.bases[1].derivative_basis(1)
    grad_u = td3.grad(u) + ez * td3.Lift(tau_u1, lift_basis, -1)
    resid = (td3.trace(grad_u) + tau_p).evaluate()["c"]
    assert np.max(np.abs(resid)) <= 1e-12 * np.max(np.abs(u["c"]))


def test_step_from_carried_state_matches_jax():
    """tools/carry.py: the JAX solver's assembled system and mid-run state
    installed into a port solver; both then step 5 more times."""
    js, _ = jax_rb(8, 32, np.float64, matsolver="banded")
    ts, _ = torch_rb(8, 32, np.float64, matsolver="banded", device="cpu")
    for _ in range(3):
        js.step(DT)
    st = js.structure
    fields = {k: getattr(st, k) for k in carry.STRUCTURE_FIELDS}
    matrices = {name: {k: np.asarray(v) for k, v in arrs.items()}
                for name, arrs in js._matrices.items()}
    carry.install_system(ts, fields, matrices, X=np.asarray(js.X))
    ts.iteration = js.iteration
    ts.sim_time = js.sim_time
    for _ in range(5):
        js.step(DT)
        ts.step(DT)
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL


@pytest.mark.parametrize("Nx,Nz,chunk_mb,chunks", [(8, 32, "0.6", 2),
                                                   (32, 16, "0.5", 6)])
def test_chunked_factor_matches_jax(Nx, Nz, chunk_mb, chunks):
    """The G-chunked factorization (BANDED_CHUNK_MB small enough to split
    the groups; 6 chunks of at most 3 cover the 16 groups of RB 32x16)
    steps like the JAX package's unchunked solve. The chunks write one
    operator store of exactly G groups: no padded duplicates."""
    from dedalus_tpu_torch.tools.config import config
    section = config["linear algebra"]
    old = section["BANDED_CHUNK_MB"]
    section["BANDED_CHUNK_MB"] = chunk_mb
    try:
        ts, _ = torch_rb(Nx, Nz, np.float64, matsolver="banded", device="cpu")
        for _ in range(3):
            ts.step(DT)
    finally:
        section["BANDED_CHUNK_MB"] = old
    aux = ts.timestepper._lhs_aux[0]
    G = ts.X.shape[0]
    assert aux["factor_chunks"] == chunks
    assert aux["fsub"]["FwdOp"].shape[1] == aux["fsub"]["BwdOp"].shape[1] == G
    assert aux["fsub"]["lastOp"].shape[0] == G
    assert aux["fsub"]["CapInv"].shape[0] == aux["YbT"].shape[0] == G
    assert aux["Vt"].shape[0] == G
    js, _ = jax_rb(Nx, Nz, np.float64, matsolver="banded")
    for _ in range(3):
        js.step(DT)
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL


def test_chunked_solve_matches_unchunked(monkeypatch):
    """RB 32x16 factored in 6 G-chunks (BANDED_CHUNK_MB = 0.5) solves like
    the same system factored in one piece, to 1e-14 relative; the factor
    makes one substitution call (the Woodbury solve over the whole store)
    and a solve makes one, whatever the chunk count."""
    from dedalus_tpu_torch.libraries import pencilops
    from dedalus_tpu_torch.tools.config import config
    ts, _ = torch_rb(32, 16, np.float64, matsolver="banded", device="cpu")
    ops, M, L = ts.ops, ts.M_mat, ts.L_mat
    b = DT * ts.timestepper.uniq_H_diag[0]
    rhs = torch.as_tensor(np.random.default_rng(17).standard_normal(
        tuple(ts.X.shape)))
    calls = []
    substitution = pencilops.banded_substitution

    def counted(fsub, fp):
        calls.append(tuple(fp.shape))
        return substitution(fsub, fp)

    monkeypatch.setattr(pencilops, "banded_substitution", counted)
    section = config["linear algebra"]
    solves = {}
    for chunk_mb, chunks in (("0.5", 6), ("2048", 1)):
        monkeypatch.setitem(section, "BANDED_CHUNK_MB", chunk_mb)
        calls.clear()
        aux = ops.factor_lincomb(1.0, M, b, L)
        assert aux["factor_chunks"] == chunks
        assert calls == [(ts.X.shape[0], ops.t, ops.n_pad)]
        calls.clear()
        solves[chunks] = ops._solve_once(aux, rhs).numpy()
        assert calls == [(ts.X.shape[0], ops.n_pad)]
    assert rel_err(solves[6], solves[1]) <= 1e-14


@pytest.mark.parametrize("sweeps", ["2", "3"])
def test_refine_sweeps_match_jax(sweeps):
    """[precision] REFINE_SWEEPS set alike in both packages: the port
    refines as often as the JAX package and steps like it. (With 0 sweeps
    the two unrefined factorizations differ by their own roundoff, about
    1e-10 relative after 3 steps at RB 8x32: the refinement is what puts
    them in the 1e-12 class.)"""
    from dedalus_tpu.tools.config import config as jconfig
    from dedalus_tpu_torch.tools.config import config as tconfig
    for cfg in (jconfig, tconfig):
        cfg["precision"]["REFINE_SWEEPS"] = sweeps
    try:
        js, _ = jax_rb(8, 32, np.float64, matsolver="banded")
        ts, _ = torch_rb(8, 32, np.float64, matsolver="banded", device="cpu")
    finally:
        for cfg in (jconfig, tconfig):
            cfg["precision"]["REFINE_SWEEPS"] = "auto"
    assert ts.ops.sweeps == int(sweeps)
    for _ in range(3):
        js.step(DT)
        ts.step(DT)
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL


@pytest.mark.parametrize("matsolver", ["block", "superlu"])
def test_unknown_matsolver_raises(matsolver):
    """A matsolver that is neither a path nor a registered dense solver
    raises before assembly."""
    with pytest.raises(ValueError, match="Unknown matsolver"):
        torch_rb(8, 32, np.float64, matsolver=matsolver, device="cpu")


def test_carried_field_data_is_gathered():
    """tools/carry.install_fields sets coefficient data by name and the
    next step picks it up (version-tracked)."""
    ts, tb = torch_rb(8, 32, np.float64, matsolver="banded", device="cpu")
    coeffs = {"b": np.asarray(tb["c"]) * 0.5}
    carry.install_fields({v.name: v for v in ts.variables}, coeffs)
    assert ts.fields_dirty()
    assert np.array_equal(tb["c"], coeffs["b"])


def test_default_device_is_cuda():
    """Entry points run on the card unless asked for the CPU: with no CUDA
    device a Distributor built without device='cpu' raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    coords = td3.CartesianCoordinates("x", "z")
    with pytest.raises(RuntimeError, match="CUDA"):
        td3.Distributor(coords, dtype=np.float64)


def test_step_many_is_a_loop_of_steps():
    ts1, _ = torch_rb(8, 32, np.float64, matsolver="banded", device="cpu")
    ts2, _ = torch_rb(8, 32, np.float64, matsolver="banded", device="cpu")
    ts1.step_many(3, DT)
    for _ in range(3):
        ts2.step(DT)
    assert ts1.iteration == ts2.iteration == 3
    assert torch.equal(ts1.X, ts2.X)


@pytest.mark.parametrize("explicit", [True, False],
                         ids=["banded-rk222", "defaults"])
def test_tau_ivp_matches_jax(explicit):
    """The small 2-D nonlinear heat IVP with tau lines (the second bench
    builder) at 16x32, 5 steps: banded RK222 as asked, and with the
    builder's defaults, which in both packages are SBDF2 and the
    configured matsolver (auto: dense at this size)."""
    from dedalus_tpu.extras.bench_problems import build_tau_ivp as jax_tau
    from dedalus_tpu_torch.extras.bench_problems import build_tau_ivp as torch_tau
    import dedalus_tpu.public as jd3
    if explicit:
        js, *_ = jax_tau(16, 32, matsolver="banded", timestepper=jd3.RK222)
        ts, *_ = torch_tau(16, 32, matsolver="banded", timestepper=td3.RK222,
                           device="cpu")
    else:
        js, *_ = jax_tau(16, 32)
        ts, *_ = torch_tau(16, 32, device="cpu")
        assert type(ts.timestepper).__name__ == "SBDF2" \
            == type(js.timestepper).__name__
    assert ts.ops.kind == js.ops.kind == ("banded" if explicit else "dense")
    for _ in range(5):
        js.step(DT)
        ts.step(DT)
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL
