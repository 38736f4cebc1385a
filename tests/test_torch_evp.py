"""
Eigenvalue problems in the port (dedalus_tpu_torch: EVP, IVP.build_EVP,
EigenvalueSolver with solve_dense, solve_sparse, set_state and lazy
per-group assembly; complex fields and ComplexFourier) held against the
JAX package on the CPU:

  * complex M/L assemble bit-equal (np.array_equal), also under a
    forced banded matsolver, which builds no device store for an EVP;
  * the waves EVPs (ChebyshevT of tests/test_evp.py, Legendre of
    examples/waves_on_a_string.py) give the JAX package's sorted finite
    eigenvalues to 1e-10 relative over the lowest 8, and (n pi)^2 to
    1e-8; left eigenvectors are biorthonormal against -M (1e-8);
  * solve_sparse near the 3rd mode (1e-6), set_state's mode shape, and
    IVP.build_EVP;
  * the Rayleigh-Benard onset EVP at Nz = 16 (ComplexFourier carrier):
    the growth rate at one kx to 1e-8 against the JAX package;
  * a small EVP_LAZY_BYTES gives the same eigenvalues, and the port
    eigensolves the M/L carried from the JAX solver to its eigenvalues.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.extras import bench_problems as tbench
from dedalus_tpu_torch.tools import carry
from dedalus_tpu_torch.tools.carry import STRUCTURE_FIELDS
from dedalus_tpu_torch.tools.config import config as tconfig

torch.set_num_threads(1)


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def waves_cheb(d3, N=32, L=1.0):
    """lap(u) + lam*u = 0 with Dirichlet BCs on ChebyshevT (tests/
    test_evp.py build_waves): lam_k = (k pi / L)^2."""
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.complex128, **dist_kw(d3))
    xb = d3.ChebyshevT(coords["x"], size=N, bounds=(0, L))
    u = dist.Field(name="u", bases=xb)
    t1 = dist.Field(name="t1")
    t2 = dist.Field(name="t2")
    lam = dist.Field(name="lam")
    lift = lambda A, n: d3.Lift(A, xb.derivative_basis(1), n)  # noqa: E731
    problem = d3.EVP([u, t1, t2], eigenvalue=lam, namespace=locals())
    problem.add_equation("lap(u) + lam*u + lift(t1,-1) + lift(t2,-2) = 0")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation(f"u(x={L}) = 0")
    return problem


def waves_legendre(d3, N=64):
    """examples/waves_on_a_string.py (the port's build_waves_evp makes
    the same problem)."""
    Lx = 1
    xcoord = d3.Coordinate("x")
    dist = d3.Distributor(xcoord, dtype=np.complex128, **dist_kw(d3))
    xbasis = d3.Legendre(xcoord, size=N, bounds=(0, Lx))
    u = dist.Field(name="u", bases=xbasis)
    tau_1 = dist.Field(name="tau_1")
    tau_2 = dist.Field(name="tau_2")
    s = dist.Field(name="s")
    dx = lambda A: d3.Differentiate(A, xcoord)  # noqa: E731
    lift_basis = xbasis.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)  # noqa: E731
    ux = dx(u) + lift(tau_1)
    uxx = dx(ux) + lift(tau_2)
    problem = d3.EVP([u, tau_1, tau_2], eigenvalue=s, namespace=locals())
    problem.add_equation("s*u + uxx = 0")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation("u(x=Lx) = 0")
    return problem


def heat_ivp_evp(d3, L=1.0):
    """dt(u) = lap(u) with Dirichlet BCs through IVP.build_EVP: lam_k =
    -(k pi / L)^2."""
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.complex128, **dist_kw(d3))
    xb = d3.ChebyshevT(coords["x"], size=32, bounds=(0, L))
    u = dist.Field(name="u", bases=xb)
    t1 = dist.Field(name="t1")
    t2 = dist.Field(name="t2")
    lift = lambda A, n: d3.Lift(A, xb.derivative_basis(1), n)  # noqa: E731
    problem = d3.IVP([u, t1, t2], namespace=locals())
    problem.add_equation("dt(u) - lap(u) + lift(t1,-1) + lift(t2,-2) = 0")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation(f"u(x={L}) = 0")
    return problem.build_EVP()


def burgers_ivp_evp(d3):
    """A nonlinear IVP, dt(u) - lap(u) = -u*dx(u), linearized by
    IVP.build_EVP about a background state: F'(X0) supplies NCCs."""
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.complex128, **dist_kw(d3))
    xb = d3.ChebyshevT(coords["x"], size=24, bounds=(0, 1))
    u = dist.Field(name="u", bases=xb)
    t1 = dist.Field(name="t1")
    t2 = dist.Field(name="t2")
    dx = lambda A: d3.Differentiate(A, coords["x"])  # noqa: E731
    lift = lambda A, n: d3.Lift(A, xb.derivative_basis(1), n)  # noqa: E731
    problem = d3.IVP([u, t1, t2], namespace=locals())
    problem.add_equation(
        "dt(u) - lap(u) + lift(t1,-1) + lift(t2,-2) = - u*dx(u)")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation("u(x=1) = 0")
    u["c"] = np.asarray(BACKGROUND, dtype=np.complex128)
    return problem.build_EVP()


# the background state of burgers_ivp_evp, in coefficients (both packages
# take the same numbers)
BACKGROUND = np.random.default_rng(4).standard_normal(24) \
    * np.exp(-np.arange(24) / 3.0)


def rb_evp(d3, Nz=16, kx=3.117, Ra=1710):
    """examples/rayleigh_benard_evp.py's max_growth_rate problem (the
    port's build_rb_evp makes the same problem)."""
    Pr, Lz, Nx = 1, 1, 4
    Lx = 2 * np.pi / kx
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.complex128, **dist_kw(d3))
    xbasis = d3.ComplexFourier(coords["x"], size=Nx, bounds=(0, Lx))
    zbasis = d3.ChebyshevT(coords["z"], size=Nz, bounds=(0, Lz))
    omega = dist.Field(name="omega")
    p = dist.Field(name="p", bases=(xbasis, zbasis))
    b = dist.Field(name="b", bases=(xbasis, zbasis))
    u = dist.VectorField(coords, name="u", bases=(xbasis, zbasis))
    tau_p = dist.Field(name="tau_p")
    tau_b1 = dist.Field(name="tau_b1", bases=xbasis)
    tau_b2 = dist.Field(name="tau_b2", bases=xbasis)
    tau_u1 = dist.VectorField(coords, name="tau_u1", bases=xbasis)
    tau_u2 = dist.VectorField(coords, name="tau_u2", bases=xbasis)
    kappa = (Ra * Pr) ** (-1 / 2)
    nu = (Ra / Pr) ** (-1 / 2)
    ex, ez = coords.unit_vector_fields(dist)
    lift_basis = zbasis.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)  # noqa: E731
    grad_u = d3.grad(u) + ez * lift(tau_u1)
    grad_b = d3.grad(b) + ez * lift(tau_b1)
    dt = lambda A: -1j * omega * A  # noqa: E731
    problem = d3.EVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2],
                     eigenvalue=omega, namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation(
        "dt(b) - kappa*div(grad_b) + lift(tau_b2) - ez@u = 0")
    problem.add_equation(
        "dt(u) - nu*div(grad_u) + grad(p) - b*ez + lift(tau_u2) = 0")
    problem.add_equation("b(z=0) = 0")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("b(z=Lz) = 0")
    problem.add_equation("u(z=Lz) = 0")
    problem.add_equation("integ(p) = 0")
    return problem


EVPS = {"waves_cheb": waves_cheb, "waves_legendre": waves_legendre,
        "heat_build_evp": heat_ivp_evp, "burgers_build_evp": burgers_ivp_evp,
        "rb_evp16": rb_evp}


def lowest(evals, n=8):
    """The n finite eigenvalues of smallest magnitude, in that order."""
    return evals[np.argsort(np.abs(evals))][:n]


# ------------------------------------------------------------- assembly

@pytest.mark.parametrize("name", list(EVPS))
def test_evp_matrices_bit_equal(name):
    js = EVPS[name](jd3).build_solver()
    ts = EVPS[name](td3).build_solver()
    assert js.pencil_shape == ts.pencil_shape
    assert np.array_equal(ts.valid_row_mask, js.valid_row_mask)
    for sp_j, sp_t in zip(js.subproblems, ts.subproblems):
        jm, tm = js._group_csr(sp_j), ts._group_csr(sp_t)
        for key in ("M", "L"):
            ref, out = jm[key].toarray(), tm[key].toarray()
            assert out.dtype == ref.dtype == np.complex128
            assert np.array_equal(out, ref)


def test_evp_forced_banded_keeps_no_store():
    """An EVP eigensolves on the host from the shared-pattern store:
    with matsolver="banded" the port builds no band store and no ops,
    and its group M/L are bit-equal to the JAX package's (which reads
    the same store)."""
    js = waves_cheb(jd3).build_solver(matsolver="banded")
    ts = waves_cheb(td3).build_solver(matsolver="banded")
    assert ts.ops is None and ts._matrices is None and ts.structure is None
    jm, tm = js._group_csr(js.subproblems[0]), ts._group_csr(ts.subproblems[0])
    for name in ("M", "L"):
        assert np.array_equal(tm[name].toarray(), jm[name].toarray())


# ---------------------------------------------------------- eigensolves

@pytest.mark.parametrize("name", ["waves_cheb", "waves_legendre",
                                  "heat_build_evp", "burgers_build_evp"])
def test_dense_eigenvalues_match_jax(name):
    """The lowest 8 finite eigenvalues to 1e-10 relative."""
    js = EVPS[name](jd3).build_solver()
    ts = EVPS[name](td3).build_solver()
    ref = lowest(js.solve_dense(js.subproblems[0]))
    out = lowest(ts.solve_dense(ts.subproblems[0]))
    assert np.all(np.abs(out - ref) <= 1e-10 * np.abs(ref))


@pytest.mark.parametrize("name", ["waves_cheb", "waves_legendre",
                                  "heat_build_evp"])
def test_dense_eigenvalues_exact(name):
    """(n pi)^2 to 1e-8 relative (-(n pi)^2 for dt(u) = lap(u))."""
    ts = EVPS[name](td3).build_solver()
    out = lowest(ts.solve_dense(ts.subproblems[0]))
    exact = (np.arange(1, 9) * np.pi) ** 2
    sign = -1 if name == "heat_build_evp" else 1
    assert np.all(np.abs(out.real - sign * exact) <= 1e-8 * exact)
    assert np.all(np.abs(out.imag) <= 1e-8 * exact)


@pytest.mark.parametrize("name", ["waves_cheb", "waves_legendre"])
def test_left_biorthonormality(name):
    """solve_dense(left=True): conj(left)^T (-M) right = I over the 8
    lowest modes (1e-8)."""
    ts = EVPS[name](td3).build_solver()
    sp = ts.subproblems[0]
    ts.solve_dense(sp, left=True)
    M = ts._group_csr(sp)["M"].toarray()
    idx = np.argsort(np.abs(ts.eigenvalues))[:8]
    right = ts.eigenvectors[:, idx]
    left = ts.left_eigenvectors[:, idx]
    B = np.conj(left).T @ (-M) @ right
    assert np.allclose(B, np.eye(8), rtol=0, atol=1e-8)


def test_sparse_near_third_mode():
    """solve_sparse around (3 pi)^2 + 1 finds (3 pi)^2 to 1e-6 relative,
    as the JAX package does."""
    target = (3 * np.pi) ** 2
    found = []
    for d3 in (jd3, td3):
        s = waves_cheb(d3).build_solver()
        evals = s.solve_sparse(s.subproblems[0], N=3, target=target + 1.0)
        found.append(evals[np.argmin(np.abs(evals - target))])
    assert abs(found[1] - target) <= 1e-6 * target
    assert abs(found[1] - found[0]) <= 1e-10 * target


def test_set_state_mode_shape():
    """set_state loads the lowest mode: sin(pi x) up to a complex scale
    (1e-8), and equal to the JAX package's mode up to that scale."""
    grids = []
    for d3 in (jd3, td3):
        s = waves_cheb(d3).build_solver()
        s.solve_dense(s.subproblems[0])
        s.set_state(int(np.argmin(np.abs(s.eigenvalues))))
        u = s.problem.variables[0]
        grids.append(np.asarray(u["g"]).ravel())
    grid = waves_cheb(td3).variables[0].domain.bases[0].global_grid(1.0)
    ref = np.sin(np.pi * grid)
    g = grids[1]
    k = np.argmax(np.abs(g))
    scale = g[k] / ref[k]
    assert np.allclose(g, scale * ref, rtol=0, atol=1e-8 * abs(scale))
    phase = grids[0][k] / g[k]
    assert np.allclose(g * phase, grids[0], rtol=0,
                       atol=1e-10 * np.abs(grids[0]).max())


def test_rb_growth_rate_matches_jax():
    """The RB onset EVP at Nz = 16, kx = 3.117, Ra = 1710: the largest
    growth rate Im(omega) of group (1, None) from solve_sparse (10 modes
    around 0) to 1e-8 against the JAX package, and the port's
    build_rb_evp gives the same. The fastest mode put on the fields by
    set_state meets the no-slip conditions (1e-10)."""
    rates = []
    for d3 in (jd3, td3):
        s = rb_evp(d3).build_solver()
        evals = s.solve_sparse(s.subproblems_by_group[(1, None)], 10,
                               target=0)
        rates.append(np.max(evals.imag))
    assert abs(rates[1] - rates[0]) <= 1e-8
    ts, fields = tbench.build_rb_evp(16, 3.117, 1710, device="cpu")
    evals = ts.solve_sparse(ts.subproblems_by_group[(1, None)], 10, target=0)
    assert abs(np.max(evals.imag) - rates[0]) <= 1e-8
    ts.set_state(int(np.argmax(evals.imag)))
    u = fields["u"]
    for z in (0.0, 1.0):
        wall = np.asarray(td3.Interpolate(u, "z", z).evaluate()["g"])
        assert np.abs(wall).max() <= 1e-10 * np.abs(u["g"]).max()


def test_waves_builder_matches_example():
    """build_waves_evp(64) is examples/waves_on_a_string.py at N = 64."""
    js = waves_legendre(jd3).build_solver()
    ts, u = tbench.build_waves_evp(64, device="cpu")
    ref = lowest(js.solve_dense(js.subproblems[0]))
    out = lowest(ts.solve_dense(ts.subproblems[0]))
    assert np.all(np.abs(out - ref) <= 1e-10 * np.abs(ref))


@pytest.fixture
def lazy_config():
    """[linear algebra] EVP_LAZY_BYTES set to 1 byte for one test."""
    section = tconfig["linear algebra"]
    old = section.get("EVP_LAZY_BYTES")
    section["EVP_LAZY_BYTES"] = "1"
    yield
    section["EVP_LAZY_BYTES"] = old


@pytest.mark.parametrize("name", ["waves_cheb", "rb_evp16"])
def test_lazy_assembly_same_eigenvalues(lazy_config, name):
    """Under a small EVP_LAZY_BYTES the solver keeps no store and
    assembles the group it is asked for; the eigenvalues are those of
    the batched store (1e-10 relative)."""
    ts = EVPS[name](td3).build_solver()
    assert ts._lazy and ts._matrices is None and ts.ops is None
    tconfig["linear algebra"]["EVP_LAZY_BYTES"] = str(1 << 28)
    ref_solver = EVPS[name](td3).build_solver()
    assert not ref_solver._lazy
    sp = ts.subproblems[-1]
    ref = lowest(ref_solver.solve_dense(ref_solver.subproblems[-1]))
    out = lowest(ts.solve_dense(sp))
    assert np.all(np.abs(out - ref) <= 1e-10 * np.abs(ref))


@pytest.mark.parametrize("path", ["dense", "banded"])
def test_carried_matrices_eigenvalues(path):
    """The port eigensolves the complex M/L carried from the JAX solver
    (dense arrays, or band stores with their structure) to the JAX
    eigenvalues (1e-10 relative)."""
    js = waves_cheb(jd3).build_solver(matsolver=path)
    ts = waves_cheb(td3).build_solver(matsolver=path)
    if path == "dense":
        fields = None
        mats = {n: np.asarray(js._matrices[n]) for n in ("M", "L")}
    else:
        fields = {k: getattr(js.structure, k) for k in STRUCTURE_FIELDS}
        mats = {n: {k: np.asarray(v) for k, v in js._matrices[n].items()}
                for n in ("M", "L")}
    carry.install_system(ts, fields, mats)
    assert ts._batched is None
    ref = lowest(js.solve_dense(js.subproblems[0]))
    out = lowest(ts.solve_dense(ts.subproblems[0]))
    assert np.all(np.abs(out - ref) <= 1e-10 * np.abs(ref))


def test_evp_rejects_rhs():
    xc = td3.Coordinate("x")
    dist = td3.Distributor(xc, dtype=np.complex128, device="cpu")
    xb = td3.ChebyshevT(xc, size=8, bounds=(0, 1))
    u = dist.Field(name="u", bases=xb)
    lam = dist.Field(name="lam")
    problem = td3.EVP([u], eigenvalue=lam, namespace={"lam": lam})
    with pytest.raises(Exception, match="zero RHS"):
        problem.add_equation("lam*u + lap(u) = 1")
    with pytest.raises(ValueError, match="complex dtype"):
        td3.Distributor(xc, dtype=np.float64, device="cpu").Field(
            bases=td3.ComplexFourier(xc, size=8, bounds=(0, 1)))
