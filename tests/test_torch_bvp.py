"""
Boundary value problems in the port (dedalus_tpu_torch: LBVP and its
LinearBoundaryValueSolver, NLBVP and its Newton iteration, Frechet
differentials and Power) held against the JAX package on the CPU:

  * the LBVPs of the JAX package's tests/test_lbvp.py, the Poisson
    example, a complex 1-D problem and the complex ComplexFourier x
    ChebyshevT Poisson assemble bit-equal L stores (np.array_equal),
    dense and forced banded, and the same valid-row masks;
  * their solutions agree to 1e-12 relative, dense and banded, and again
    when the port solves the L carried from the JAX solver
    (tools/carry.py);
  * the NLBVPs (sin-Jacobi of tests/test_nlbvp.py at dealias 1 and 1.5,
    Bratu N = 32, dense and banded) take the same number of Newton
    iterations; every Newton step taken from the JAX iterate lands within
    1e-12 of the next JAX iterate, and the Bratu iterates agree to 1e-12
    when each package iterates on its own.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.extras import bench_problems as tbench
from dedalus_tpu_torch.tools import carry
from dedalus_tpu_torch.tools.carry import STRUCTURE_FIELDS

torch.set_num_threads(1)

RTOL = 1e-12


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


# ------------------------------------------------------------ the LBVPs
# Each builder makes the same problem with either package's public API
# and returns (problem, variables); the forcing is set on the grid.

def poisson_1d(d3):
    """lap(u) = 6z, u(0) = 0, u(1) = 1 -> u = z^3."""
    zc = d3.Coordinate("z")
    dist = d3.Distributor(zc, dtype=np.float64, **dist_kw(d3))
    zb = d3.ChebyshevT(zc, size=16, bounds=(0, 1))
    z = dist.local_grid(zb)
    u = dist.Field(name="u", bases=zb)
    t1 = dist.Field(name="t1")
    t2 = dist.Field(name="t2")
    rhs = dist.Field(name="rhs", bases=zb)
    rhs["g"] = 6 * z.ravel()
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)  # noqa: E731
    problem = d3.LBVP([u, t1, t2], namespace=locals())
    problem.add_equation("lap(u) + lift(t1,-1) + lift(t2,-2) = rhs")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("u(z=1) = 1")
    return problem


def poisson_2d(d3):
    """RealFourier x ChebyshevT 16x16 Poisson with an x-dependent RHS."""
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    xb = d3.RealFourier(coords["x"], size=16, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords["z"], size=16, bounds=(0, 1))
    x, z = dist.local_grids(xb, zb)
    u = dist.Field(name="u", bases=(xb, zb))
    t1 = dist.Field(name="t1", bases=xb)
    t2 = dist.Field(name="t2", bases=xb)
    rhs = dist.Field(name="rhs", bases=(xb, zb))
    rhs["g"] = -np.sin(x) * z * (1 - z) - 2 * np.sin(x)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)  # noqa: E731
    problem = d3.LBVP([u, t1, t2], namespace=locals())
    problem.add_equation("lap(u) + lift(t1,-1) + lift(t2,-2) = rhs")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("u(z=1) = 0")
    return problem


def ncc_coeffs():
    """The coefficients of zf = z on ChebyshevT(16) over (0, 1), from the
    JAX package's transform: both packages take the same NCC data, so
    their NCC matrices can be bit-equal (the transforms themselves agree
    to 1e-13, tests/test_torch_transforms.py)."""
    zc = jd3.Coordinate("z")
    dist = jd3.Distributor(zc, dtype=np.float64)
    zb = jd3.ChebyshevT(zc, size=16, bounds=(0, 1))
    zf = dist.Field(name="zf", bases=zb)
    zf["g"] = dist.local_grid(zb).ravel()
    return np.array(zf["c"])


def ncc_lbvp(d3):
    """z*dz(u) + u = 3z^2, u(0) = 0 (an NCC on a derivative operand)."""
    zc = d3.Coordinate("z")
    dist = d3.Distributor(zc, dtype=np.float64, **dist_kw(d3))
    zb = d3.ChebyshevT(zc, size=16, bounds=(0, 1))
    z = dist.local_grid(zb)
    u = dist.Field(name="u", bases=zb)
    tau = dist.Field(name="tau")
    zf = dist.Field(name="zf", bases=zb)
    zf["c"] = ncc_coeffs()
    rhs = dist.Field(name="rhs", bases=zb)
    rhs["g"] = 3 * z.ravel() ** 2
    dz = lambda A: d3.Differentiate(A, zc)  # noqa: E731
    lift = lambda A: d3.Lift(A, zb.derivative_basis(1), -1)  # noqa: E731
    problem = d3.LBVP([u, tau], namespace=locals())
    problem.add_equation("zf*dz(u) + u + lift(tau) = rhs")
    problem.add_equation("u(z=0) = 0")
    return problem


def vector_lbvp(d3):
    """Vector Poisson with Dirichlet conditions per component."""
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    xb = d3.RealFourier(coords["x"], size=8, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords["z"], size=16, bounds=(0, 1))
    x, z = dist.local_grids(xb, zb)
    u = dist.VectorField(coords, name="u", bases=(xb, zb))
    t1 = dist.VectorField(coords, name="t1", bases=xb)
    t2 = dist.VectorField(coords, name="t2", bases=xb)
    rhs = dist.VectorField(coords, name="rhs", bases=(xb, zb))
    rg = np.zeros((2, 8, 16))
    rg[0] = -np.sin(x) * z * (1 - z) - 2 * np.sin(x)
    rg[1] = 6 * z * np.ones_like(x)
    rhs["g"] = rg
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)  # noqa: E731
    top = dist.VectorField(coords, name="top")
    top["g"] = np.array([0.0, 1.0]).reshape(2, 1, 1)
    problem = d3.LBVP([u, t1, t2], namespace=locals())
    problem.add_equation("lap(u) + lift(t1,-1) + lift(t2,-2) = rhs")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation((d3.Interpolate(u, coords["z"], 1.0), top))
    return problem


def conditioned_bcs(d3, pairs=1):
    """Complementary conditioned bottom conditions (Dirichlet at nx == 0,
    Neumann elsewhere); with pairs=2 also at the top, packed into separate
    row blocks."""
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    xb = d3.RealFourier(coords["x"], size=8, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords["z"], size=16, bounds=(0, 1))
    u = dist.Field(name="u", bases=(xb, zb))
    tau1 = dist.Field(name="tau1", bases=xb)
    tau2 = dist.Field(name="tau2", bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(1), n)  # noqa: E731
    dz = lambda A: d3.Differentiate(A, coords["z"])  # noqa: E731
    problem = d3.LBVP([u, tau1, tau2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau1,-1) + lift(tau2,-2) = 0")
    if pairs == 1:
        problem.add_equation("u(z=1) = 0")
    else:
        problem.add_equation("u(z=1) = 2", condition="nx == 0")
        problem.add_equation("dz(u)(z=1) = 0", condition="nx != 0")
    problem.add_equation("u(z=0) = 1", condition="nx == 0")
    problem.add_equation("dz(u)(z=0) = 0", condition="nx != 0")
    return problem


def poisson_example(d3, dtype=np.float64):
    """examples/poisson.py at 32x16 (the port's build_poisson_solver
    makes the same problem); a complex dtype takes the ComplexFourier
    carrier, so its banded solve runs the complex substitution."""
    coords = d3.CartesianCoordinates("x", "y")
    dist = d3.Distributor(coords, dtype=dtype, **dist_kw(d3))
    Lx, Ly = 2 * np.pi, np.pi
    xbasis = d3.Fourier(coords["x"], size=32, bounds=(0, Lx), dtype=dtype)
    ybasis = d3.ChebyshevT(coords["y"], size=16, bounds=(0, Ly))
    u = dist.Field(name="u", bases=(xbasis, ybasis))
    tau_1 = dist.Field(name="tau_1", bases=xbasis)
    tau_2 = dist.Field(name="tau_2", bases=xbasis)
    x, y = dist.local_grids(xbasis, ybasis)
    f = dist.Field(name="f", bases=(xbasis, ybasis))
    g = dist.Field(name="g", bases=xbasis)
    h = dist.Field(name="h", bases=xbasis)
    f.fill_random("g", seed=40)
    f.low_pass_filter(shape=(8, 4))
    g["g"] = np.sin(8 * x) * 0.025
    h["g"] = 0
    dy = lambda A: d3.Differentiate(A, coords["y"])  # noqa: E731
    lift_basis = ybasis.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)  # noqa: E731
    problem = d3.LBVP([u, tau_1, tau_2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau_1,-1) + lift(tau_2,-2) = f")
    problem.add_equation("u(y=0) = g")
    problem.add_equation("dy(u)(y=Ly) = h")
    return problem


def complex_1d(d3):
    """lap(u) + k u = f with a complex k and f, u(0) = i, u'(1) = 0: the
    complex L store, dense and banded."""
    zc = d3.Coordinate("z")
    dist = d3.Distributor(zc, dtype=np.complex128, **dist_kw(d3))
    zb = d3.ChebyshevT(zc, size=16, bounds=(0, 1))
    z = dist.local_grid(zb)
    u = dist.Field(name="u", bases=zb)
    t1 = dist.Field(name="t1")
    t2 = dist.Field(name="t2")
    rhs = dist.Field(name="rhs", bases=zb)
    rhs["g"] = (1 + 2j) * np.exp(3j * z.ravel())
    k = 2 - 1j
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)  # noqa: E731
    dz = lambda A: d3.Differentiate(A, zc)  # noqa: E731
    problem = d3.LBVP([u, t1, t2], namespace=locals())
    problem.add_equation("lap(u) + k*u + lift(t1,-1) + lift(t2,-2) = rhs")
    problem.add_equation("u(z=0) = 1j")
    problem.add_equation("dz(u)(z=1) = 0")
    return problem


LBVPS = {
    "poisson1d": poisson_1d,
    "complex": complex_1d,
    "complex_poisson_example": lambda d3: poisson_example(d3,
                                                         np.complex128),
    "poisson2d": poisson_2d,
    "ncc": ncc_lbvp,
    "vector": vector_lbvp,
    "conditioned": conditioned_bcs,
    "conditioned_pairs": lambda d3: conditioned_bcs(d3, pairs=2),
    "poisson_example": poisson_example,
}


def build_pair(name, path):
    """(JAX solver, port solver) of one LBVP on one path, or None where
    the JAX package finds the banded path not applicable (the port must
    refuse it too)."""
    matsolver = "dense" if path == "dense" else "banded"
    try:
        js = LBVPS[name](jd3).build_solver(matsolver=matsolver)
    except ValueError as exc:
        assert "not applicable" in str(exc)
        with pytest.raises(ValueError, match="not applicable"):
            LBVPS[name](td3).build_solver(matsolver=matsolver)
        return None
    ts = LBVPS[name](td3).build_solver(matsolver=matsolver)
    return js, ts


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(name, path):
        if (name, path) not in cache:
            cache[name, path] = build_pair(name, path)
        return cache[name, path]
    return get


PATHS = ["dense", "banded"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", list(LBVPS))
def test_lbvp_assembly_bit_equal(built, name, path):
    pair = built(name, path)
    if pair is None:
        return
    js, ts = pair
    assert ts.ops.kind == js.ops.kind == path
    assert np.array_equal(ts.valid_row_mask, js.valid_row_mask)
    ref, out = js._matrices["L"], ts._matrices["L"]
    if path == "dense":
        assert out.shape == ref.shape and np.array_equal(out, ref)
        return
    for part in ("bands", "Vt", "dsel"):
        assert np.array_equal(np.asarray(out[part]), np.asarray(ref[part]))
    for field in STRUCTURE_FIELDS:
        assert np.array_equal(np.asarray(getattr(ts.structure, field)),
                              np.asarray(getattr(js.structure, field)))


def solution(solver):
    return np.concatenate([np.asarray(v["c"]).ravel()
                           for v in solver.problem.variables])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", list(LBVPS))
def test_lbvp_solution_matches_jax(built, name, path):
    pair = built(name, path)
    if pair is None:
        return
    js, ts = pair
    js.solve()
    ts.solve()
    assert rel_err(solution(ts), solution(js)) <= RTOL


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", ["poisson2d", "vector", "conditioned_pairs",
                                  "poisson_example"])
def test_carried_L_solution_matches_jax(name, path):
    """The port solves the L carried from the JAX solver (dense arrays or
    band stores with their structure) to the JAX solution."""
    pair = build_pair(name, path)
    if pair is None:
        return
    js, ts = pair
    if path == "dense":
        fields, mats = None, {"L": np.asarray(js._matrices["L"])}
    else:
        fields = {k: getattr(js.structure, k) for k in STRUCTURE_FIELDS}
        mats = {"L": {k: np.asarray(v)
                      for k, v in js._matrices["L"].items()}}
    carry.install_system(ts, fields, mats)
    js.solve()
    ts.solve()
    assert rel_err(solution(ts), solution(js)) <= RTOL


def test_complex_poisson_builder_matches_jax():
    """extras/bench_problems.py build_poisson_solver with complex128,
    forced banded at 32x16, solves the JAX package's complex Poisson to
    1e-12 (the complex substitution's plain version on the CPU)."""
    js = poisson_example(jd3, np.complex128).build_solver(
        matsolver="banded")
    ts, fields = tbench.build_poisson_solver(32, 16, "banded", device="cpu",
                                             dtype=np.complex128)
    assert ts.ops.kind == js.ops.kind == "banded"
    js.solve()
    ts.solve()
    assert rel_err(solution(ts), solution(js)) <= RTOL


def test_exact_solutions():
    """The port alone against the closed forms of tests/test_lbvp.py."""
    s = poisson_1d(td3).build_solver()
    s.solve()
    u = s.problem.variables[0]
    z = u.domain.bases[0].global_grid(1.0)
    assert np.allclose(u["g"], z ** 3, rtol=0, atol=1e-14)
    s = conditioned_bcs(td3, pairs=2).build_solver()
    s.solve()
    z = s.problem.variables[0].domain.bases[1].global_grid(1.0)
    assert np.abs(np.asarray(s.problem.variables[0]["g"])
                  - (1 + z)).max() < 1e-12


@pytest.mark.parametrize("path", PATHS)
def test_bench_poisson_builder(path):
    """build_poisson_solver (the chip run's Poisson) against the JAX
    package's example at 32x16: same L, same solution (1e-12); the
    boundary conditions and the tau-corrected equation hold."""
    matsolver = None if path == "dense" else "banded"
    js = poisson_example(jd3).build_solver(matsolver=matsolver)
    ts, f = tbench.build_poisson_solver(32, 16, matsolver=matsolver,
                                        device="cpu")
    assert ts.ops.kind == js.ops.kind == path
    js.solve()
    ts.solve()
    assert rel_err(solution(ts), solution(js)) <= RTOL
    u, g = f["u"], f["g"]
    ybasis = u.domain.bases[1]
    bc = np.asarray(td3.Interpolate(u, "y", 0.0).evaluate()["g"]) \
        - np.asarray(g["g"])
    assert np.abs(bc).max() <= 1e-12 * np.abs(g["g"]).max()
    lift = lambda A, n: td3.Lift(A, ybasis.derivative_basis(2), n)  # noqa: E731
    resid = (td3.lap(u) + lift(f["tau_1"], -1) + lift(f["tau_2"], -2)
             - f["f"]).evaluate()["c"]
    assert np.abs(resid).max() <= 1e-10 * np.abs(f["f"]["c"]).max()


def test_lbvp_refactor_free_resolve():
    """A second solve with a changed RHS reuses the factor and solves the
    new problem (u = 2 z^3 for twice the forcing and boundary value)."""
    s = poisson_1d(td3).build_solver()
    aux = s._aux
    ns = s.problem.namespace
    ns["rhs"]["g"] = 2 * np.asarray(ns["rhs"]["g"])
    s.problem.equations[2]["F"]["g"] = 2.0
    s.solve()
    assert s._aux is aux and s.iteration == 1
    u = s.problem.variables[0]
    z = u.domain.bases[0].global_grid(1.0)
    assert np.allclose(u["g"], 2 * z ** 3, rtol=0, atol=1e-13)


def test_lbvp_rejects_time_derivative():
    zc = td3.Coordinate("z")
    dist = td3.Distributor(zc, dtype=np.float64, device="cpu")
    zb = td3.ChebyshevT(zc, size=8, bounds=(0, 1))
    u = dist.Field(name="u", bases=zb)
    problem = td3.LBVP([u])
    with pytest.raises(Exception, match="time derivatives"):
        problem.add_equation("dt(u) = 0")


# ----------------------------------------------------------- the NLBVPs

def sin_jacobi(d3, dealias):
    """tests/test_nlbvp.py:12: dx(u)^2 + u^2 = 1, u(0) = 1 -> cos(x)."""
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    xb = d3.ChebyshevT(coords["x"], size=12, bounds=(0, 1), dealias=dealias)
    x, = dist.local_grids(xb)
    u = dist.Field(name="u", bases=xb)
    tau = dist.Field(name="tau")
    dx = lambda A: d3.Differentiate(A, coords["x"])  # noqa: E731
    lift = lambda A: d3.Lift(A, xb.derivative_basis(1), -1)  # noqa: E731
    problem = d3.NLBVP([u, tau], namespace=locals())
    problem.add_equation("dx(u)**2 + u**2 + lift(tau) = 1")
    problem.add_equation("u(x=0) = 1")
    u["g"] = 1 - x / 2
    return problem, u, x


def bratu(d3, N=32, lam=1.0):
    """u'' + lam exp(u) = 0, u(0) = u(1) = 0, from u = 0."""
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    xb = d3.ChebyshevT(coords["x"], size=N, bounds=(0, 1))
    x, = dist.local_grids(xb)
    u = dist.Field(name="u", bases=xb)
    t1 = dist.Field(name="t1")
    t2 = dist.Field(name="t2")
    dx = lambda A: d3.Differentiate(A, coords["x"])  # noqa: E731
    lift = lambda A, n: d3.Lift(A, xb.derivative_basis(2), n)  # noqa: E731
    problem = d3.NLBVP([u, t1, t2], namespace=locals())
    problem.add_equation(
        "dx(dx(u)) + lam*np.exp(u) + lift(t1,-1) + lift(t2,-2) = 0")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation("u(x=1) = 0")
    return problem, u, x


def newton(solver, u, tolerance, max_iter=30):
    """Newton to `tolerance` of the perturbation norm; the iterates' grid
    data."""
    iterates = []
    error = np.inf
    while error > tolerance and solver.iteration < max_iter:
        solver.newton_iteration()
        error = solver.perturbation_norm()
        iterates.append(np.array(u["g"]))
    return iterates


NLBVPS = {
    # (jax problem builder, port solver builder, tolerance, exact)
    "sin_jacobi_1": (lambda: sin_jacobi(jd3, 1),
                     lambda ms: tbench.build_sin_jacobi_solver(
                         12, 1, device="cpu"), 1e-6, np.cos),
    "sin_jacobi_1.5": (lambda: sin_jacobi(jd3, 1.5),
                       lambda ms: tbench.build_sin_jacobi_solver(
                           12, 1.5, device="cpu"), 1e-6, np.cos),
    "bratu32": (lambda: bratu(jd3),
                lambda ms: tbench.build_bratu_solver(32, device="cpu"),
                1e-10, tbench.bratu_exact),
}


@pytest.mark.parametrize("name", list(NLBVPS))
def test_newton_steps_match_jax(name):
    """Each Newton step of the port, taken from the JAX package's current
    iterate (all variables carried over), lands within 1e-12 of the JAX
    package's next iterate, relative to its size; the JAX count of steps
    reaches the tolerance. Bound: 1e-12, or the step's round-off floor
    eps * ||J^-1||_inf where that is larger. The sin-Jacobi root is
    degenerate: ||J^-1|| doubles every step (to ~7e6 at the last), so its
    residual, computed by cancellation to ~eps, fixes the step only to
    that floor in any implementation (on the CPU: 5.4e-11 at step 18
    against a floor of 7.3e-10); the Bratu floor is 4.6e-16."""
    jbuild, tbuild, tol, exact = NLBVPS[name]
    jproblem, ju, x = jbuild()
    js = jproblem.build_solver(matsolver="dense")
    ts, tu, tx = tbuild(None)
    error = np.inf
    while error > tol and js.iteration < 30:
        for jv, tv in zip(js.problem.variables, ts.problem.variables):
            tv["c"] = np.array(jv["c"])
        js.newton_iteration()
        ts.newton_iteration()
        error = js.perturbation_norm()
        J = np.asarray(js._matrices["L"])[0]
        bound = max(RTOL, np.finfo(np.float64).eps
                    * np.abs(np.linalg.inv(J)).sum(axis=1).max())
        assert abs(ts.perturbation_norm() - error) <= bound * max(error, 1)
        ref = np.array(ju["g"])
        assert np.max(np.abs(np.array(tu["g"]) - ref)) \
            <= bound * np.max(np.abs(ref))
    assert error <= tol


@pytest.mark.parametrize("name", list(NLBVPS))
def test_newton_iterations_match_jax(name):
    """The port iterating on its own takes as many Newton iterations as
    the JAX package and converges to the exact solution (1e-6 for the
    sin-Jacobi root, as in the reference: the root is degenerate, so
    Newton converges linearly there and the two packages' iterates part
    by up to ~1e-10 late in the run; Bratu to 1e-10, with every iterate
    within 1e-12 of the JAX iterate)."""
    jbuild, tbuild, tol, exact = NLBVPS[name]
    jproblem, ju, x = jbuild()
    ref = newton(jproblem.build_solver(), ju, tol)
    ts, tu, tx = tbuild(None)
    out = newton(ts, tu, tol)
    assert len(out) == len(ref) < 30
    if name == "bratu32":
        for a, b in zip(out, ref):
            assert np.max(np.abs(a - b)) <= RTOL * np.max(np.abs(b))
        assert np.max(np.abs(out[-1] - exact(tx))) <= 1e-10
    else:
        assert np.max(np.abs(out[-1] - exact(tx))) <= 1e-6


def test_bratu_banded_matches_jax():
    """The Bratu Newton iteration at N = 64 on the forced banded path
    (BandedOps.factor of each Jacobian) against the JAX package's banded
    iterates (1e-12) over the first two iterations: the first Jacobian
    has the constant NCC exp(0), the second a varying one (the JAX
    package compiles each banded Jacobian anew, ~4 s an iteration on one
    core, so the run stops there; the dense runs go to convergence). At
    N = 32 the JAX package refuses the banded path (its re-blocking to
    q = 16 leaves a band of 26 of 27 diagonals)."""
    jproblem, ju, x = bratu(jd3, N=64)
    ref = newton(jproblem.build_solver(matsolver="banded"), ju, 0, 2)
    tproblem, tu, _ = bratu(td3, N=64)
    ts = tproblem.build_solver(matsolver="banded")
    assert ts.ops.kind == "banded"
    out = newton(ts, tu, 0, 2)
    assert len(out) == len(ref) == 2
    for a, b in zip(out, ref):
        assert np.max(np.abs(a - b)) <= RTOL * np.max(np.abs(b))


def test_frechet_rules_match_jax():
    """The Jacobian of u*dx(u) + u**3 + exp(u) + sin(u) around a random
    state assembles to the same dense matrix in both packages."""
    mats = []
    for d3 in (jd3, td3):
        xc = d3.Coordinate("x")
        dist = d3.Distributor(xc, dtype=np.float64, **dist_kw(d3))
        xb = d3.ChebyshevT(xc, size=10, bounds=(0, 1))
        u = dist.Field(name="u", bases=xb)
        tau = dist.Field(name="tau")
        dx = lambda A: d3.Differentiate(A, xc)  # noqa: E731
        lift = lambda A: d3.Lift(A, xb.derivative_basis(1), -1)  # noqa: E731
        u["c"] = np.random.default_rng(8).standard_normal(10) * 0.1
        problem = d3.NLBVP([u, tau], namespace=locals())
        problem.add_equation(
            "dx(u) + u*dx(u) + u**3 + np.exp(u) + np.sin(u) + lift(tau) = 0")
        problem.add_equation("u(x=0) = 0")
        mats.append(np.asarray(problem.build_solver(
            matsolver="dense")._matrices["L"]))
    assert rel_err(mats[1], mats[0]) <= 1e-13
