"""
ComplexFourier initial value problems in the port held against the JAX
package on the CPU:

  * the traveling, decaying wave of tests/test_ivp.py:72 (complex
    advection-diffusion, RK443): the port's state equals the JAX
    package's to 1e-12 after 100 steps and the exact solution to 1e-6,
    the JAX test's own bound;
  * `enforce_hermitian_symmetry` as tests/test_ivp.py:140 drives it: a
    polluted Nyquist slot of ComplexFourier(16) is cleared, the valid
    content is kept to 1e-12, and the re-projected states and 6 SBDF1
    steps at cadence 2 equal the JAX package's to 1e-12;
  * extras/bench_problems.py build_complex_ivp (complex128, a quadratic
    term b*b, taus): dense and forced banded assemble bit-equal M/L and
    the same banded structure (q = 3) as the JAX package, and 10 RK222
    steps agree to 1e-12 relative, banded vs dense vs the JAX package.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.extras.bench_problems import build_complex_ivp

torch.set_num_threads(1)

RTOL = 1e-12


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def state(solver):
    X = solver.X
    return X.numpy() if isinstance(X, torch.Tensor) else np.asarray(X)


def advection_diffusion(d3):
    """tests/test_ivp.py:72: dt(u) + c dx(u) - nu lap(u) = 0 on
    ComplexFourier(32), u = exp(2ix), RK443."""
    xc = d3.Coordinate("x")
    dist = d3.Distributor(xc, dtype=np.complex128, **dist_kw(d3))
    xb = d3.ComplexFourier(xc, size=32, bounds=(0, 2 * np.pi))
    u = dist.Field(name="u", bases=xb)
    c, nu = 1.5, 0.1
    dx = lambda A: d3.Differentiate(A, xc)  # noqa: E731
    problem = d3.IVP([u], namespace={"u": u, "c": c, "nu": nu, "dx": dx,
                                     "lap": d3.lap})
    problem.add_equation("dt(u) + c*dx(u) - nu*lap(u) = 0")
    x = dist.local_grid(xb)
    u["g"] = np.exp(2j * x)
    return problem.build_solver(d3.RK443), u, x, c, nu


def test_advection_diffusion_matches_jax_and_exact():
    js, _, _, _, _ = advection_diffusion(jd3)
    ts, u, x, c, nu = advection_diffusion(td3)
    for _ in range(100):
        js.step(1e-3)
        ts.step(1e-3)
    assert ts.X.dtype == torch.complex128
    assert rel_err(state(ts), state(js)) <= RTOL
    t = ts.sim_time
    exact = np.exp(2j * (x - c * t)) * np.exp(-nu * 4 * t)
    assert np.max(np.abs(np.asarray(u["g"]) - exact.ravel())) < 1e-6


def nyquist_problem(d3):
    """tests/test_ivp.py:140: dt(u) - lap(u) = 0 on ComplexFourier(16),
    SBDF1 with enforce_real_cadence = 2."""
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.complex128, **dist_kw(d3))
    xb = d3.ComplexFourier(coords["x"], size=16, bounds=(0, 2 * np.pi))
    u = dist.Field(name="u", bases=xb)
    problem = d3.IVP([u], namespace={})
    problem.add_equation((d3.dt(u) - d3.lap(u), 0))
    solver = problem.build_solver(d3.SBDF1, enforce_real_cadence=2)
    x, = dist.local_grids(xb)
    u["g"] = np.exp(1j * x) + np.exp(-2j * x)
    return solver


def test_enforce_real_cadence_clears_nyquist_as_jax():
    import jax.numpy as jnp
    nyq = 8   # ComplexFourier(16) group layout [0..7, nyquist, -7..-1]
    out = {}
    for d3, put in ((jd3, jnp.asarray), (td3, torch.as_tensor)):
        solver = nyquist_problem(d3)
        # the initial fields (set after the build), re-projected once
        solver.X = put(np.asarray(solver.gather_fields()))
        solver.enforce_hermitian_symmetry()
        X0 = state(solver).copy()
        pol = X0.copy()
        pol[nyq, :] += 10.0
        solver.X = put(pol)
        solver.enforce_hermitian_symmetry()
        X1 = state(solver).copy()
        others = np.ones(len(X1), dtype=bool)
        others[nyq] = False
        assert np.abs(X1[others] - X0[others]).max() < 1e-12
        assert np.abs(X1[nyq] - X0[nyq]).max() < 1e-12
        # the state set here, not the fields, is the one to step
        solver.snapshot_versions()
        for _ in range(6):
            solver.step(1e-3)
        X2 = state(solver)
        assert np.isfinite(X2).all()
        out[d3] = (X0, X1, X2)
    for a, b in zip(out[td3], out[jd3]):
        assert rel_err(a, b) <= RTOL


def jax_complex_ivp(Nx, Nz, matsolver):
    """The JAX package's twin of build_complex_ivp."""
    from dedalus_tpu.tools.config import config
    d3 = jd3
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.complex128)
    xb = d3.ComplexFourier(coords["x"], size=Nx, bounds=(0, 4.0),
                           dealias=3 / 2)
    zb = d3.ChebyshevT(coords["z"], size=Nz, bounds=(0, 1.0), dealias=3 / 2)
    b = dist.Field(name="b", bases=(xb, zb))
    t1 = dist.Field(name="t1", bases=xb)
    t2 = dist.Field(name="t2", bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)  # noqa: E731
    problem = d3.IVP([b, t1, t2], namespace=locals())
    problem.add_equation("dt(b) - lap(b) + lift(t1,-1) + lift(t2,-2) = - b*b")
    problem.add_equation("b(z=0) = 0")
    problem.add_equation("b(z=1) = 0")
    section = config["linear algebra"]
    old = section.get("MATRIX_SOLVER", "auto")
    if matsolver is not None:
        section["MATRIX_SOLVER"] = matsolver
    try:
        solver = problem.build_solver(d3.RK222)
    finally:
        section["MATRIX_SOLVER"] = old
    x, z = dist.local_grids(xb, zb)
    b["g"] = np.sin(np.pi * z) * (0.5 + 0.3 * np.exp(0.5j * np.pi * x)
                                  + 0.2j * np.cos(np.pi * x))
    return solver, 1e-3


@pytest.fixture(scope="module")
def complex_pairs():
    """{path: (jax solver, port solver, dt)} at 16x16, dense ('auto') and
    forced banded."""
    out = {}
    for path, matsolver in (("dense", None), ("banded", "banded")):
        js, dt = jax_complex_ivp(16, 16, matsolver)
        ts, tdt = build_complex_ivp(16, 16, matsolver=matsolver,
                                    device="cpu")
        assert dt == tdt
        out[path] = (js, ts, dt)
    return out


@pytest.mark.parametrize("path", ["dense", "banded"])
def test_complex_ivp_system_is_the_jax_one(complex_pairs, path):
    js, ts, _ = complex_pairs[path]
    assert ts.ops.kind == js.ops.kind == path
    assert ts.pencil_dtype == np.complex128
    for name in ("M", "L"):
        if path == "banded":
            for part in ("bands", "Vt", "dsel"):
                assert np.array_equal(np.asarray(ts._matrices[name][part]),
                                      np.asarray(js._matrices[name][part]))
        else:
            assert np.array_equal(np.asarray(ts._matrices[name]),
                                  np.asarray(js._matrices[name]))
    if path == "banded":
        for k in ("q", "NB", "t_pins", "kl", "ku"):
            assert getattr(ts.structure, k) == getattr(js.structure, k)
        assert ts.structure.q == 3


def test_complex_ivp_steps_match_jax(complex_pairs):
    """10 RK222 steps: banded and dense port runs against the JAX runs and
    against each other, 1e-12 relative."""
    states = {}
    for path, (js, ts, dt) in complex_pairs.items():
        for _ in range(10):
            js.step(dt)
            ts.step(dt)
        assert np.isfinite(state(ts)).all()
        assert rel_err(state(ts), state(js)) <= RTOL
        states[path] = state(ts)
    assert rel_err(states["banded"], states["dense"]) <= RTOL
