"""
The ball in the port (dedalus_tpu_torch: BallBasis, real and complex128,
the ball's radial and ell-coupled NCCs, its CFL arm, and the
examples/internally_heated_convection.py and examples/lane_emden.py
build functions) held against the JAX package on the CPU, inputs from numpy
seeds and closed forms, with one intra-op thread:

  * the cases of tests/test_ball.py through both packages: scalar and
    vector transforms (coefficients and the grid roundtrip, 1e-13
    relative), the calculus operators, interpolation at r = R and r = 0,
    integration and cross products (1e-12 relative); the NCC, r_vec NCC
    and Poisson LBVPs (L np.array_equal, solutions 1e-12); the Bessel
    decay rate; vector diffusion and the stress-free setup (states 1e-12);
  * the ball cases of tests/test_coupled_ncc.py, real and complex: per-m
    pencil matrices against the JAX package's to 1e-14 absolute, and
    against the port's own grid products to 2e-10 (the JAX test's bar);
    the ball case of tests/test_batched_assembly.py (M and L
    np.array_equal);
  * build_ball_convection(16, 8, 12), dense and forced banded: M and L
    np.array_equal with the JAX package's (the banded stores through
    their matvec), the banded structure's shape equal to the JAX
    package's, 10 SBDF2 steps within 1e-12 of the state, the CFL dt to
    1e-14, the carried system;
  * Lane-Emden (Nr = 32): every Newton iterate against the JAX package's
    to 1e-12, the same iteration count, R within 1e-5 of Boyd's value.

The banded structure of the stress-free ball, the same in both packages,
pins one pressure mode too many: its pinned base is singular in every
group of ell >= 1, and the JAX package's forced-banded steps are
non-finite. The port's first factorization finds those groups by their
floored pivots and repairs the pins by one swap
(SolverBase.factor_checked, MatrixStructure.repair_pins), so its banded
run is held against the JAX package's dense one.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.extras import bench_problems as tbench
from dedalus_tpu_torch.tools import carry

torch.set_num_threads(1)

R = 1.5
RTOL = 1e-12
TRANSFORM_RTOL = 1e-13


@pytest.fixture(scope="module", autouse=True)
def no_jax_assembly_cache():
    """The JAX package's assembly cache moves each NCC field through
    coefficient space while it fingerprints (tests/test_torch_shell.py):
    off, so both packages read the same NCC grid data."""
    saved = os.environ.get("DEDALUS_TPU_ASSEMBLY_CACHE")
    os.environ["DEDALUS_TPU_ASSEMBLY_CACHE"] = ""
    yield
    if saved is None:
        os.environ.pop("DEDALUS_TPU_ASSEMBLY_CACHE", None)
    else:
        os.environ["DEDALUS_TPU_ASSEMBLY_CACHE"] = saved


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def subsystems(d3):
    return importlib.import_module(d3.__name__.replace(".public", "")
                                   + ".core.subsystems")


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def make_ball(d3, dtype=np.float64, shape=(12, 8, 10), radius=R, dealias=1):
    cs = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(cs, dtype=dtype, **dist_kw(d3))
    ball = d3.BallBasis(cs, shape=shape, dtype=dtype, radius=radius,
                        dealias=dealias)
    return cs, dist, ball


def xyz(phi, theta, r):
    return (r * np.sin(theta) * np.cos(phi),
            r * np.sin(theta) * np.sin(phi),
            r * np.cos(theta))


def spherical_vector(phi, theta, vx, vy, vz):
    """Coordinate components (phi, theta, r) of a Cartesian vector."""
    return np.array([
        -np.sin(phi) * vx + np.cos(phi) * vy,
        np.cos(theta) * np.cos(phi) * vx + np.cos(theta) * np.sin(phi) * vy
        - np.sin(theta) * vz,
        np.sin(theta) * np.cos(phi) * vx + np.sin(theta) * np.sin(phi) * vy
        + np.cos(theta) * vz])


def smooth_field(d3, rank, seed, dtype=np.float64):
    """A band-limited polynomial field of rank 0, 1 or 2 (a random
    combination from a numpy seed), the same grid data in both
    packages."""
    cs, dist, ball = make_ball(d3, dtype)
    phi, theta, r = dist.local_grids(ball)
    x, y, z = xyz(phi, theta, r)
    c = np.random.default_rng(seed).standard_normal(8)
    f = dist.Field(name="f", bases=ball)
    f["g"] = (c[0] * x * y + c[1] * z ** 2 + c[2] * x + c[3] + c[4] * y * z
              + c[5] * x * z ** 2)
    if rank == 0:
        return cs, dist, ball, f
    u = dist.VectorField(cs, name="u", bases=ball)
    u["g"] = spherical_vector(phi, theta, c[6] * y + 1 + x ** 2,
                              c[7] * x * z + y ** 2, z + 0.5 * x * y)
    if rank == 1:
        return cs, dist, ball, u
    return cs, dist, ball, d3.grad(u).evaluate()


# ------------------------------------------------------------ transforms

@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["real", "complex"])
@pytest.mark.parametrize("rank", [0, 1], ids=["scalar", "vector"])
def test_roundtrip_matches_jax(rank, dtype):
    """grid -> coeff -> grid of the same grid data in both packages: the
    coefficients and the returned grid data agree to 1e-13 relative, and
    the port's roundtrip returns its input (tests/test_ball.py bars:
    1e-12 scalar, 1e-11 vector)."""
    out = {}
    for d3 in (td3, jd3):
        f = smooth_field(d3, rank, 3 + rank, dtype)[3]
        g0 = np.array(f["g"])
        c = np.array(f["c"])
        f["c"] = c
        out[d3] = (c, np.array(f["g"]), g0)
    for i in range(2):
        assert rel_err(out[td3][i], out[jd3][i]) <= TRANSFORM_RTOL
    c, g, g0 = out[td3]
    assert np.abs(g - g0).max() < (1e-12 if rank == 0 else 1e-11)


def test_complex_ball_groups_in_fftfreq_order():
    """A complex ball has one m per group over Nphi groups (fftfreq
    order), the Nyquist group without valid slots; a real one Nphi/2
    (cos, -sin) pairs."""
    cs, _, cb = make_ball(td3, np.complex128, shape=(8, 6, 6))
    rb = td3.BallBasis(cs, shape=(8, 6, 6), dtype=np.float64)
    assert cb.complex and cb.sub_n_groups(0) == 8 and cb.sub_group_shape(0) == 1
    assert rb.sub_n_groups(0) == 4 and rb.sub_group_shape(0) == 2
    assert list(cb.group_m()) == [0, 1, 2, 3, -4, -3, -2, -1]
    mask = cb.component_valid_mask((), (4, 5, None), [0, 1])
    assert not mask.any()
    # triangular truncation n >= ell // 2, and the real rule at ell = 0
    mask = rb.component_valid_mask((cs,), (0, 5, None), [0, 1])
    assert not mask[..., :2].any() and mask[..., 2:].any()
    mask = rb.component_valid_mask((), (0, 0, None), [0, 1])
    assert mask[:, 0].all() and not mask[:, 1].any()


# ---------------------------------------------------------- calculus

OPERATORS = {
    "grad": (0, lambda d3, f: d3.grad(f)),
    "grad_vector": (1, lambda d3, f: d3.grad(f)),
    "div": (1, lambda d3, f: d3.div(f)),
    "curl": (1, lambda d3, f: d3.curl(f)),
    "lap": (0, lambda d3, f: d3.lap(f)),
    "lap_vector": (1, lambda d3, f: d3.lap(f)),
    "trace": (2, lambda d3, f: d3.trace(f)),
    "trans": (2, lambda d3, f: d3.trans(f)),
    "interp_R": (1, lambda d3, f: f(r=R)),
    "interp_0": (0, lambda d3, f: d3.Interpolate(f, f.domain.bases[0]
                                                 .coordsystem["r"], 0.0)),
    "radial_R": (2, lambda d3, f: d3.radial(f(r=R), index=1)),
    "integ": (0, lambda d3, f: d3.integ(f)),
}


@pytest.mark.parametrize("op", list(OPERATORS))
def test_operators_match_jax(op):
    """Each spherical operator the two examples use, on the same input in
    both packages: coefficients to 1e-12 relative."""
    rank, fn = OPERATORS[op]
    out = {}
    for d3 in (td3, jd3):
        f = smooth_field(d3, rank, 21 + rank)[3]
        out[d3] = np.array(fn(d3, f).evaluate()["c"])
    assert out[td3].shape == out[jd3].shape
    assert rel_err(out[td3], out[jd3]) <= RTOL


def test_calculus_closed_forms():
    """tests/test_ball.py::test_ball_calculus through the port: lap, div
    grad and curl grad of a quadratic, and the curl of the rigid
    rotation z x r (2 z), to 1e-9 and 1e-10."""
    cs, dist, ball = make_ball(td3)
    phi, theta, r = dist.local_grids(ball)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=ball)
    f["g"] = x * y + z ** 2 + x + 3
    assert np.abs(td3.lap(f).evaluate()["g"] - 2.0).max() < 1e-9
    assert np.abs(td3.div(td3.grad(f)).evaluate()["g"] - 2.0).max() < 1e-9
    assert np.abs(td3.curl(td3.grad(f)).evaluate()["g"]).max() < 1e-9
    u = dist.VectorField(cs, name="u", bases=ball)
    u["g"] = spherical_vector(phi, theta, -y, x, 0 * z)
    c = td3.curl(u).evaluate()["g"]
    assert np.abs(c[0]).max() < 1e-10
    assert np.abs(c[1] + 2 * np.sin(theta)).max() < 1e-10
    assert np.abs(c[2] - 2 * np.cos(theta)).max() < 1e-10


def test_cross_product_orientation_and_parity():
    """x_hat cross y_hat = z_hat in the left-handed (phi, theta, r)
    components (1e-12), and a general cross product against the JAX
    package's (1e-12 relative)."""
    cs, dist, ball = make_ball(td3)
    phi, theta, r = dist.local_grids(ball)
    zero = 0 * (phi + theta + r)
    u = dist.VectorField(cs, name="u", bases=ball)
    v = dist.VectorField(cs, name="v", bases=ball)
    u["g"] = spherical_vector(phi, theta, 1 + zero, zero, zero)
    v["g"] = spherical_vector(phi, theta, zero, 1 + zero, zero)
    w = td3.cross(u, v).evaluate()["g"]
    expect = np.array([zero, -np.sin(theta) + zero, np.cos(theta) + zero])
    assert np.abs(w - expect).max() < 1e-12
    out = {}
    for d3 in (td3, jd3):
        a = smooth_field(d3, 1, 7)[3]
        b = smooth_field(d3, 1, 8)[3]
        out[d3] = np.array(d3.cross(a, b).evaluate()["g"])
    assert rel_err(out[td3], out[jd3]) <= RTOL


def test_interpolation_and_integration():
    """f(r = R) against the closed form (1e-11), the volume integral
    against 4 pi R^3 + 4 pi R^5 / 15 (1e-11), and r = 0 returns f(0)."""
    cs, dist, ball = make_ball(td3)
    phi, theta, r = dist.local_grids(ball)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=ball)
    f["g"] = x * y + z ** 2 + x + 3
    xo, yo, zo = xyz(phi[:, :, 0], theta[:, :, 0], R)
    fo = f(r=R).evaluate()["g"]
    assert np.abs(fo[:, :, 0] - (xo * yo + zo ** 2 + xo + 3)).max() < 1e-11
    total = float(td3.integ(f).evaluate()["g"].ravel()[0])
    exact = 4 * np.pi / 3 * R ** 3 * 3 + 4 * np.pi / 3 * R ** 5 / 5
    assert abs(total - exact) < 1e-11
    f0 = td3.Interpolate(f, cs["r"], 0.0).evaluate()["g"]
    assert np.abs(np.asarray(f0) - 3.0).max() < 1e-12


# --------------------------------------------------------------- LBVPs

def ncc_lbvp(d3, which):
    cs, dist, ball = make_ball(d3, shape=(8, 6, 12),
                               dealias=1 if which == "poisson" else 3 / 2)
    phi, theta, r = dist.local_grids(ball)
    x, y, z = xyz(phi, theta, r)
    r = np.asarray(r)
    if which == "ncc":
        ncc = dist.Field(name="ncc", bases=ball)
        ncc["g"] = r ** 2 + 1
        v = dist.Field(name="v", bases=ball)
        w = dist.Field(name="w", bases=ball)
        w["g"] = x * z + r ** 2
        problem = d3.LBVP([v], namespace=locals())
        problem.add_equation("ncc*v = ncc*w")
        expect = lambda: np.asarray(w["g"])  # noqa: E731
        out = v
    elif which == "rvec":
        rvec = dist.VectorField(cs, name="rvec", bases=ball)
        rvec["g"][2] = np.broadcast_to(r, np.asarray(rvec["g"])[2].shape)
        v = dist.Field(name="v", bases=ball)
        w = dist.VectorField(cs, name="w", bases=ball)
        f = dist.Field(name="f", bases=ball)
        f["g"] = x * z + r ** 2
        problem = d3.LBVP([v, w], namespace=locals())
        problem.add_equation("w - rvec*v = 0")
        problem.add_equation("v = f")

        def expect():
            e = np.zeros_like(np.asarray(w["g"]))
            e[2] = np.asarray(f["g"]) * r
            return e
        out = w
    else:
        u = dist.Field(name="u", bases=ball)
        t1 = dist.Field(name="t1", bases=ball.surface)
        six = dist.Field(name="six", bases=ball)
        six["g"] = 6.0
        lift = lambda A, n: d3.Lift(A, ball.derivative_basis(2), n)  # noqa: E731
        problem = d3.LBVP([u, t1], namespace={**locals(), "R": R})
        problem.add_equation("lap(u) + lift(t1, -1) = six")
        problem.add_equation("u(r=R) = R**2")
        expect = lambda: r ** 2 + 0 * np.asarray(u["g"])  # noqa: E731
        out = u
    solver = problem.build_solver()
    solver.solve()
    return solver, out, expect


@pytest.mark.parametrize("which", ["ncc", "rvec", "poisson"])
def test_lbvps_match_jax(which):
    """The NCC, r_vec NCC and Poisson LBVPs of tests/test_ball.py: L
    np.array_equal with the JAX package's, the solutions within 1e-12
    relative of its solutions and within 1e-12 of the closed forms."""
    ts, tout, texpect = ncc_lbvp(td3, which)
    js, jout, _ = ncc_lbvp(jd3, which)
    assert np.array_equal(np.asarray(ts._matrices["L"]),
                          np.asarray(js._matrices["L"]))
    assert rel_err(np.array(tout["c"]), np.array(jout["c"])) <= RTOL
    assert np.abs(np.asarray(tout["g"]) - texpect()).max() < 1e-12


# ----------------------------------------------------------------- IVPs

def bessel_decay(d3, n):
    cs, dist, ball = make_ball(d3, shape=(4, 4, 16), radius=1.0)
    phi, theta, r = dist.local_grids(ball)
    u = dist.Field(name="u", bases=ball)
    t1 = dist.Field(name="t1", bases=ball.surface)
    lift = lambda A, k: d3.Lift(A, ball.derivative_basis(2), k)  # noqa: E731
    problem = d3.IVP([u, t1], namespace=locals())
    problem.add_equation("dt(u) - lap(u) + lift(t1, -1) = 0")
    problem.add_equation("u(r=1.0) = 0")
    solver = problem.build_solver(d3.SBDF2)
    u["g"] = np.sinc(np.asarray(r))  # j_0(pi r)
    E0 = float(np.asarray(d3.integ(u * u).evaluate()["g"]).ravel()[0])
    for _ in range(n):
        solver.step(5e-5)
    E1 = float(np.asarray(d3.integ(u * u).evaluate()["g"]).ravel()[0])
    return E0, E1, np.array(u["c"])


def test_bessel_diffusion_rate():
    """The lowest diffusion decay rate in the unit ball is pi^2 (1e-2, the
    JAX test's bar), and the decayed state agrees with the JAX package's
    to 1e-12 relative."""
    n = 400
    E0, E1, tc = bessel_decay(td3, n)
    rate = -np.log(E1 / E0) / (2 * n * 5e-5)
    assert abs(rate - np.pi ** 2) < 1e-2
    _, _, jc = bessel_decay(jd3, n)
    assert rel_err(tc, jc) <= RTOL


def vector_ivp(d3, which):
    cs, dist, ball = make_ball(d3, shape=(8, 6, 10), radius=1.0,
                               dealias=3 / 2)
    phi, theta, r = dist.local_grids(ball)
    x, y, z = xyz(phi, theta, r)
    u = dist.VectorField(cs, name="u", bases=ball)
    if which == "diffusion":
        t1 = dist.VectorField(cs, name="t1", bases=ball.surface)
        lift = lambda A, n: d3.Lift(A, ball.derivative_basis(2), n)  # noqa: E731
        problem = d3.IVP([u, t1], namespace=locals())
        problem.add_equation("dt(u) - lap(u) + lift(t1, -1) = - u@grad(u)")
        problem.add_equation("u(r=1.0) = 0")
        solver = problem.build_solver(d3.RK222)
        h = dist.Field(name="h", bases=ball)
        h["g"] = (1 - np.asarray(r) ** 2) ** 2 * (1 + 0.2 * x)
        u["g"] = np.asarray(d3.grad(h).evaluate()["g"])
        steps = 20
    else:
        p = dist.Field(name="p", bases=ball)
        tau_p = dist.Field(name="tau_p")
        tau_u = dist.VectorField(cs, name="tau_u", bases=ball.surface)
        lift = lambda A: d3.Lift(A, ball, -1)  # noqa: E731
        strain_rate = d3.grad(u) + d3.trans(d3.grad(u))
        shear_stress = d3.angular(d3.radial(strain_rate(r=1.0), index=1))
        problem = d3.IVP([p, u, tau_p, tau_u], namespace=locals())
        problem.add_equation("div(u) + tau_p = 0")
        problem.add_equation(
            "dt(u) - lap(u) + grad(p) + lift(tau_u) = - u@grad(u)")
        problem.add_equation("shear_stress = 0")
        problem.add_equation("radial(u(r=1.0)) = 0")
        problem.add_equation("integ(p) = 0")
        solver = problem.build_solver(d3.RK222)
        u.fill_random("g", seed=7, distribution="normal", scale=1e-3)
        steps = 10
    for _ in range(steps):
        solver.step(1e-3)
    return solver, u


def state_errors(ts, js):
    """Each field's max |port - JAX| over its coefficients, relative to
    the largest entry of the JAX state."""
    scale = np.abs(np.asarray(js.X)).max()
    return {tv.name or f"var{i}": float(np.abs(
        np.array(tv["c"]) - np.array(jv["c"])).max() / scale)
        for i, (tv, jv) in enumerate(zip(ts.variables, js.variables))}


# The stress-free setup's pencils M + dt gamma L have condition up to
# 1.0e7 (dt 1e-3, unit viscosity, a random non-solenoidal start): on one
# solve with a random right-hand side jaxlib's LU and torch's differ by
# 6.9e-15 of the solution, but after 10 RK222 steps the algebraic fields
# (p, tau_u: no dt term) differ by 4.0e-11 and 6.7e-13 of the state, as
# much as the port's own exact dense solvers differ from one another on
# the same run (LU against the explicit inverse: 3.2e-11 and 6.9e-13;
# against the refined inverse 4.6e-11). u agrees to 1.3e-14.
STRESS_FREE_ALGEBRAIC = ("p", "tau_p", "tau_u")
STRESS_FREE_ALGEBRAIC_BOUND = 1e-10


@pytest.mark.parametrize("which", ["diffusion", "stress_free"])
def test_vector_ivps_match_jax(which):
    """The vector diffusion IVP (20 RK222 steps) and the stress-free
    setup (transpose, index-1 radial and angular extraction on boundary
    tensors; 10 steps): u within 1e-12 of the state (and every field of
    the diffusion run), the stress-free run's algebraic p and taus within
    STRESS_FREE_ALGEBRAIC_BOUND (see its comment), finite, and the
    boundary condition held to 1e-10 (tests/test_ball.py bars)."""
    ts, tu = vector_ivp(td3, which)
    js, _ = vector_ivp(jd3, which)
    errs = state_errors(ts, js)
    for name, err in errs.items():
        algebraic = which == "stress_free" and name in STRESS_FREE_ALGEBRAIC
        assert err <= (STRESS_FREE_ALGEBRAIC_BOUND if algebraic else RTOL), \
            errs
    if which == "diffusion":
        bc = tu(r=1.0).evaluate()["g"]
    else:
        bc = td3.radial(tu(r=1.0)).evaluate()["g"]
    assert np.abs(np.asarray(bc)).max() < 1e-10
    assert bool(torch.isfinite(ts.X).all())


# ------------------------------------------------------ ell-coupled NCCs

def ball_ncc(d3, which, dtype):
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=dtype, **dist_kw(d3))
    ball = d3.BallBasis(coords, shape=(8, 8, 8), radius=1.0, dtype=dtype)
    phi, theta, r = dist.local_grids(ball)
    z = r * np.cos(theta)
    ez = dist.VectorField(coords, name="ez", bases=ball.meridional_basis)
    ez["g"][1] = -np.sin(theta)
    ez["g"][2] = np.cos(theta)
    if which == "scalar":
        f = dist.Field(name="f", bases=ball.meridional_basis)
        f["g"] = 2.0 + z ** 2 + 0.3 * z
        u = dist.Field(name="u", bases=ball)
        x = r * np.sin(theta) * np.cos(phi)
        u["g"] = x ** 2 + 0.5 * z + 0.2 * z ** 2
        return dist, f * u, u
    if which == "vector_times_scalar":
        u = dist.Field(name="u", bases=ball)
        u["g"] = z + 0.3 * (r * np.sin(theta)) ** 2 * np.cos(2 * phi)
        return dist, ez * u, u
    v = dist.VectorField(coords, name="v", bases=ball)
    v["g"][0] = r * np.sin(theta) * np.sin(phi)
    v["g"][1] = z * np.sin(theta)
    v["g"][2] = 0.4 * z + 0.1 * r ** 2
    return dist, d3.cross(ez, v), v


def ncc_matrices(d3, which, dtype):
    """Per-group pencil matrices of the LHS product, and the largest
    error of their action against the product evaluated on the grid
    (valid slots, relative to the product's largest coefficient)."""
    dist, expr, operand = ball_ncc(d3, which, dtype)
    sub = subsystems(d3)
    eq = {"domain": expr.domain, "tensorsig": tuple(expr.tensorsig),
          "L": expr}
    layout = sub.PencilLayout(dist, [operand], [eq])
    colat = expr.domain.bases[-1].first_axis + 1
    assert colat not in layout.sep_widths
    Xin = np.asarray(layout.gather(operand.coeff_data(), operand.domain,
                                   operand.tensorsig))
    out = expr.evaluate()
    Xout = np.asarray(layout.gather(out.coeff_data(), out.domain,
                                    out.tensorsig))
    scale = max(np.abs(Xout).max(), 1e-12)
    mats, err = [], 0.0
    for sp in sub.build_subproblems(layout):
        M = expr.expression_matrices(sp, [operand])[operand]
        M = np.asarray(M.toarray() if hasattr(M, "toarray") else M)
        mats.append(M)
        valid = np.asarray(layout.valid_mask(
            expr.domain, tuple(expr.tensorsig), sp.group)).ravel()
        y = M @ Xin[sp.index]
        err = max(err, np.abs(y - Xout[sp.index])[valid].max(initial=0.0)
                  / scale)
    return mats, err


@pytest.mark.parametrize("dtype", [np.complex128, np.float64],
                         ids=["complex", "real"])
@pytest.mark.parametrize("which", ["scalar", "vector_times_scalar",
                                   "cross"])
def test_coupled_ncc_matches_jax(which, dtype):
    """The ball cases of tests/test_coupled_ncc.py (f(theta, r)*u, ez*u,
    cross(ez, v); the per-(ell', ell) Zernike pair matrices of
    _sph_coupled_ncc_matrix_ball): each m group's matrix against the JAX
    package's to 1e-14 absolute, the port's matrices against its own
    grid evaluation to 2e-10."""
    ours, err = ncc_matrices(td3, which, dtype)
    theirs, _ = ncc_matrices(jd3, which, dtype)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-14
    assert err < 2e-10


def radial_ncc_ivp(d3):
    """tests/test_batched_assembly.py::test_ball_radial_ncc's IVP."""
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    ball = d3.BallBasis(coords, shape=(8, 4, 8), radius=1.0, dealias=3 / 2)
    u = dist.VectorField(coords, name="u", bases=ball)
    p = dist.Field(name="p", bases=ball)
    T = dist.Field(name="T", bases=ball)
    tau_p = dist.Field(name="tau_p")
    tau_u = dist.VectorField(coords, name="tau_u", bases=ball.surface)
    tau_T = dist.Field(name="tau_T", bases=ball.surface)
    r_vec = dist.VectorField(coords, name="r_vec", bases=ball)
    phi, theta, r = dist.local_grids(ball)
    r_vec["g"][2] = np.broadcast_to(np.asarray(r),
                                    np.asarray(r_vec["g"])[2].shape)
    nu = kappa = 1e-2  # noqa: F841
    lift = lambda A: d3.Lift(A, ball, -1)  # noqa: E731
    problem = d3.IVP([p, u, T, tau_p, tau_u, tau_T], namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation(
        "dt(u) - nu*lap(u) + grad(p) - T*r_vec + lift(tau_u) = - u@grad(u)")
    problem.add_equation(
        "dt(T) - kappa*lap(T) + lift(tau_T) = - u@grad(T) + 1")
    problem.add_equation("u(r=1) = 0")
    problem.add_equation("T(r=1) = 0")
    problem.add_equation("integ(p) = 0")
    return problem.build_solver(d3.RK222)


def test_batched_radial_ncc_matches_jax():
    """The radial NCC T*r_vec batches through per-ell stacks
    (_batched_spherical_ncc) in both packages: the port's strict batched
    walk (no per-group fallback) scattered with the validity closure, and
    its solver's M and L, np.array_equal with the JAX package's."""
    from dedalus_tpu_torch.core.batched_assembly import batched_system_coos
    ts, js = radial_ncc_ivp(td3), radial_ncc_ivp(jd3)
    pr, pc, vals, row_valid, col_valid = batched_system_coos(
        ts.layout, ts.equations, ts.variables, ("M", "L"))
    G, S = ts.pencil_shape
    for name in ("M", "L"):
        dense = np.zeros((G, S, S), dtype=vals[name].dtype)
        dense[:, pr, pc] = vals[name]
        if name == "L":
            g_rows, inv_rows = np.nonzero(~row_valid)
            _, inv_cols = np.nonzero(~col_valid)
            dense[g_rows, inv_rows, inv_cols] = 1.0
        ref = np.asarray(js._matrices[name])
        assert np.array_equal(dense, ref)
        assert np.array_equal(np.asarray(ts._matrices[name]), ref)


# ------------------------------------- internally heated convection 16x8x12

def jax_ball_convection(Nphi, Ntheta, Nr, matsolver=None):
    """examples/internally_heated_convection.py with the JAX package,
    without its loop (the port's counterpart is
    bench_problems.build_ball_convection)."""
    d3 = jd3
    Rayleigh, Prandtl = 1e4, 1
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=np.float64)
    ball = d3.BallBasis(coords, shape=(Nphi, Ntheta, Nr), radius=1,
                        dealias=3 / 2, dtype=np.float64)
    sphere = ball.surface
    u = dist.VectorField(coords, name="u", bases=ball)
    p = dist.Field(name="p", bases=ball)
    T = dist.Field(name="T", bases=ball)
    tau_p = dist.Field(name="tau_p")
    tau_u = dist.VectorField(coords, name="tau_u", bases=sphere)
    tau_T = dist.Field(name="tau_T", bases=sphere)
    phi, theta, r = dist.local_grids(ball)
    r_vec = dist.VectorField(coords, name="r_vec", bases=ball)
    r_vec["g"][2] = np.broadcast_to(np.asarray(r),
                                    np.asarray(r_vec["g"])[2].shape)
    T_source = 6  # noqa: F841
    kappa = (Rayleigh * Prandtl) ** (-1 / 2)  # noqa: F841
    nu = (Rayleigh / Prandtl) ** (-1 / 2)  # noqa: F841
    lift = lambda A: d3.Lift(A, ball, -1)  # noqa: E731
    strain_rate = d3.grad(u) + d3.trans(d3.grad(u))
    shear_stress = d3.angular(d3.radial(strain_rate(r=1), index=1))  # noqa: F841
    problem = d3.IVP([p, u, T, tau_p, tau_u, tau_T], namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("dt(u) - nu*lap(u) + grad(p) - r_vec*T "
                         "+ lift(tau_u) = - cross(curl(u),u)")
    problem.add_equation("dt(T) - kappa*lap(T) + lift(tau_T) "
                         "= - u@grad(T) + kappa*T_source")
    problem.add_equation("shear_stress = 0")
    problem.add_equation("radial(u(r=1)) = 0")
    problem.add_equation("T(r=1) = 0")
    problem.add_equation("integ(p) = 0")
    kw = {"matsolver": matsolver} if matsolver else {}
    solver = problem.build_solver(d3.SBDF2, **kw)
    T.fill_random("g", seed=42, distribution="normal", scale=0.01)
    T["g"] += 1 - np.asarray(r) ** 2
    return solver


@pytest.fixture(scope="module")
def ball16():
    js = jax_ball_convection(16, 8, 12)
    ts, dt, flow = tbench.build_ball_convection(16, 8, 12, device="cpu")
    tb, _, _ = tbench.build_ball_convection(16, 8, 12, matsolver="banded",
                                            device="cpu")
    return js, ts, tb, dt, flow


def test_ball_convection_pencils_equal(ball16):
    """One pencil per (m, ell) in both packages (the radial NCC r_vec*T is
    angularly constant), the same G, S and valid rows; the dense M and L
    np.array_equal with the JAX package's."""
    js, ts, tb, _, _ = ball16
    assert ts.layout.forced_coupled == set() == js.layout.forced_coupled
    assert ts.pencil_shape == tuple(js.pencil_shape) == (64, 130)
    assert ts.ops.kind == "dense" and tb.ops.kind == "banded"
    assert np.array_equal(ts.valid_row_mask, np.asarray(js.valid_row_mask))
    for name in ("M", "L"):
        assert np.array_equal(np.asarray(ts._matrices[name]),
                              np.asarray(js._matrices[name]))


def singular_pinned_groups(structure, A, rows, cols):
    """The groups g whose pinned base is numerically singular: the block
    of A[g] on the valid unpinned rows and columns has its smallest
    singular value below n * eps of its largest."""
    pinned = structure.col_perm[structure.pinned_positions]
    bad = []
    for g in range(len(A)):
        r = rows[g].copy()
        r[structure.pinned_rows] = False
        c = cols[g].copy()
        c[pinned] = False
        if not r.any():
            continue
        s = np.linalg.svd(A[g][r][:, c], compute_uv=False)
        if s[-1] <= r.sum() * np.finfo(np.float64).eps * s[0]:
            bad.append(g)
    return bad


def test_ball_convection_banded_structure(ball16):
    """Forced banded, both packages build the same structure (S = 130,
    q = 32, NB = 5, kl = 20, ku = 36, 18 pins, the same row placement and
    band stores). Its pinned base is singular in all 35 groups of ell >= 1
    (the JAX package's first step is non-finite): the port's first
    factorization floors pivots there and repairs the pins by one swap,
    after which no group is singular and the factor floors no pivot."""
    from dedalus_tpu.tools.config import config as jconfig
    section = jconfig["linear algebra"]
    saved = section.get("MATRIX_SOLVER")
    section["MATRIX_SOLVER"] = "banded"
    try:
        js = jax_ball_convection(16, 8, 12)
    finally:
        section["MATRIX_SOLVER"] = saved
    tb, dt, _ = tbench.build_ball_convection(16, 8, 12, matsolver="banded",
                                             device="cpu")
    st, jst = tb.structure, js.structure
    fields = ("S", "q", "NB", "kl", "ku", "t_pins")
    assert {k: getattr(st, k) for k in fields} == \
        {k: getattr(jst, k) for k in fields} == \
        {"S": 130, "q": 32, "NB": 5, "kl": 20, "ku": 36, "t_pins": 18}
    assert st.pin_swaps == 0
    assert np.array_equal(st.row_pos, np.asarray(jst.row_pos))
    assert np.array_equal(st.col_perm, np.asarray(jst.col_perm))
    for name in ("M", "L"):
        for key in ("dsel", "bands", "Vt"):
            assert np.array_equal(np.asarray(tb._matrices[name][key]),
                                  np.asarray(js._matrices[name][key]))
    G, S = tb.pencil_shape
    rows = np.asarray(js.valid_row_mask, dtype=bool)
    cols = np.stack([np.concatenate([
        tb.layout.valid_mask(v.domain, v.tensorsig, sp.group).ravel()
        for v in tb.variables]) for sp in tb.subproblems])
    dense = ball16[0]
    A = (np.asarray(dense._matrices["M"])
         + 1e-2 * np.asarray(dense._matrices["L"]))
    bad = singular_pinned_groups(st, A, rows, cols)
    assert len(bad) == 35
    assert all(1 <= ell and m <= ell
               for m, ell, _ in (tb.subproblems[g].group for g in bad))
    jrow_pos = np.asarray(jst.row_pos)
    jpinned = {int(r): i for i, r in enumerate(np.asarray(jst.pinned_rows))}
    old = {name: {k: np.asarray(js._matrices[name][k])
                  for k in ("bands", "Vt")} for name in ("M", "L")}
    tb.step(dt)
    assert st.pin_swaps == 1
    assert int(tb.floored_pivots.sum()) == 0
    assert singular_pinned_groups(tb.structure, A, rows, cols) == []
    # every row the repair did not move sits at the same position with
    # the same entries, and every pinned row it did not move has the same
    # Vt row (np.array_equal; a moved pin's closure follows its position)
    st = tb.structure
    moved = set(st.repaired_rows)
    assert 0 < len(moved) <= 16
    still = np.array([r for r in range(S) if r not in moved])
    assert np.array_equal(st.row_pos[still], jrow_pos[still])
    positions = st.row_pos[still]
    ours_i = {int(r): i for i, r in enumerate(st.pinned_rows)}
    assert set(ours_i) == set(jpinned)
    for name in ("M", "L"):
        ours = tb._matrices[name]
        assert np.array_equal(np.asarray(ours["bands"])[:, :, positions],
                              old[name]["bands"][:, :, positions])
        for r in set(ours_i) - moved:
            assert np.array_equal(np.asarray(ours["Vt"])[:, ours_i[r]],
                                  old[name]["Vt"][:, jpinned[r]])
    js.step(dt)
    assert not np.isfinite(np.asarray(js.X)).all()


def test_ball_banded_repair_when_the_capacitance_inverse_raises(
        monkeypatch):
    """A singular pinned base can leave the Woodbury capacitance exactly
    singular, and torch.linalg.inv then raises after the factor has
    counted its floored pivots (as at 64x32x48 on the card). Here the
    inverse raises whenever a group floored: the first step still
    repairs the pins by one swap and runs, as without the raise."""
    from dedalus_tpu_torch.libraries import pencilops
    woodbury = pencilops.BandedOps._woodbury

    def raising(self, aux, Vt, **kw):
        if int(self.floored_pivots.sum()):
            raise torch.linalg.LinAlgError("singular capacitance")
        return woodbury(self, aux, Vt, **kw)

    monkeypatch.setattr(pencilops.BandedOps, "_woodbury", raising)
    tb, dt, _ = tbench.build_ball_convection(16, 8, 12, matsolver="banded",
                                             device="cpu")
    tb.step(dt)
    assert tb.structure.pin_swaps == 1
    assert int(tb.floored_pivots.sum()) == 0
    assert bool(torch.isfinite(tb.X).all())


def test_ball_convection_trajectory_matches_jax(ball16):
    """10 SBDF2 steps at dt 0.01: the port's dense and banded runs within
    1e-12 of the JAX package's dense state on every field; the boundary
    conditions and the incompressibility constraint (the constraint rows
    of L X) held; the flow property finite."""
    js, ts, tb, dt, flow = ball16
    for _ in range(10):
        js.step(dt)
        ts.step(dt)
        tb.step(dt)
    for solver in (ts, tb):
        errs = state_errors(solver, js)
        assert max(errs.values()) <= RTOL, errs
    assert int(tb.floored_pivots.sum()) == 0
    assert np.isfinite(flow.max("u2"))
    fields = {v.name: v for v in tb.variables}
    u, T = fields["u"], fields["T"]
    scale_u = np.abs(np.asarray(u["g"])).max()
    assert np.abs(np.asarray(td3.radial(u(r=1)).evaluate()["g"])).max() \
        <= 1e-10 * scale_u
    assert np.abs(np.asarray(T(r=1).evaluate()["g"])).max() <= 1e-10 * \
        np.abs(np.asarray(T["g"])).max()
    from test_torch_shell import constraint_residual
    assert constraint_residual(tb) < 1e-12
    assert constraint_residual(ts) < 1e-12
    # the shear stress evaluated on the grid: the port's equals the JAX
    # package's dense run's to 1e-12 of max|u| (both within the 1e-10 bar
    # of tests/test_ball.py here; both grow with the resolution alike)
    ref = grid_shear_stress(jd3, js)
    scale_u = np.abs(np.asarray(
        {v.name: v for v in js.variables}["u"]["g"])).max()
    assert np.abs(ref).max() <= 1e-10 * scale_u
    for solver in (ts, tb):
        assert np.abs(grid_shear_stress(td3, solver) - ref).max() \
            <= 1e-12 * scale_u


def grid_shear_stress(d3, solver):
    """angular(radial(strain_rate(r=1), index=1)) of the solver's u, on
    the grid."""
    u = {v.name: v for v in solver.variables}["u"]
    strain = d3.grad(u) + d3.trans(d3.grad(u))
    return np.asarray(d3.angular(d3.radial(strain(r=1), index=1))
                      .evaluate()["g"])


def test_ball_cfl_matches_jax():
    """The ball arm of the CFL spacing (angular R / k, radial the
    dealias-scaled grid gradient): the same velocity in both packages
    gives the same dt (1e-14)."""
    dts = {}
    for d3 in (td3, jd3):
        cs, dist, ball = make_ball(d3, shape=(16, 8, 12), radius=1.0,
                                   dealias=3 / 2)
        phi, theta, r = dist.local_grids(ball)
        x, y, z = xyz(phi, theta, r)
        u = dist.VectorField(cs, name="u", bases=ball)
        u["g"] = spherical_vector(phi, theta, 1e-3 * (y + z),
                                  2e-3 * x * z, 1e-3 * (x * y - z))
        p = dist.Field(name="p", bases=ball)
        problem = d3.IVP([p], namespace=locals())
        problem.add_equation("dt(p) = - u@grad(p)")
        solver = problem.build_solver(d3.SBDF2)
        cfl = d3.CFL(solver, initial_dt=1.0, cadence=1, safety=0.5)
        cfl.add_velocity(u)
        dts[d3] = cfl.compute_timestep()
    assert abs(dts[td3] - dts[jd3]) <= 1e-14 * dts[jd3]


def test_ball_convection_step_from_carried_system():
    """tools/carry.py: the JAX solver's dense M, L and state (regularity
    components, (m, ell) group order; its T perturbed first, so the
    carried state is not the port's own) installed into a port solver
    before its first step; both step 5 times (1e-12 of the state)."""
    js = jax_ball_convection(8, 4, 6)
    ts, dt, _ = tbench.build_ball_convection(8, 4, 6, device="cpu")
    jT = js.problem.namespace["T"]
    noise = np.random.default_rng(5).standard_normal(np.shape(jT["g"]))
    jT["g"] = np.asarray(jT["g"]) + 1e-2 * noise
    X = np.asarray(js.gather_fields())
    assert np.abs(X - ts.gather_fields().numpy()).max() > 1e-4
    carry.install_system(ts, None, {name: np.asarray(js._matrices[name])
                                    for name in ("M", "L")}, X=X)
    for _ in range(5):
        js.step(dt)
        ts.step(dt)
    assert max(state_errors(ts, js).values()) <= RTOL


# ----------------------------------------------------------- Lane-Emden

def test_lane_emden_newton_matches_jax():
    """examples/lane_emden.py at Nr = 32 (n = 3): every Newton iterate of
    the port within 1e-12 of the JAX package's (relative to its largest
    coefficient), the same iteration count to a perturbation norm of
    1e-10, and R = f(0)^((n-1)/2) within 1e-5 of Boyd's 6.896848619376960."""
    n, Nr = 3.0, 32
    ts, tf, radius = tbench.build_lane_emden(Nr=Nr, n=n, device="cpu")
    d3 = jd3
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=np.float64)
    ball = d3.BallBasis(coords, (4, 2, Nr), radius=1, dtype=np.float64,
                        dealias=2)
    f = dist.Field(name="f", bases=ball)
    tau = dist.Field(name="tau", bases=ball.surface)
    lift = lambda A: d3.Lift(A, ball, -1)  # noqa: E731
    problem = d3.NLBVP([f, tau], namespace=locals())
    problem.add_equation("lap(f) + lift(tau) = - f**n")
    problem.add_equation("f(r=1) = 0")
    phi, theta, r = dist.local_grids(ball)
    f["g"] = 5 ** (2 / (n - 1)) * (1 - np.asarray(r) ** 2) ** 2
    js = problem.build_solver()
    errs = []
    pn = np.inf
    while pn > 1e-10:
        js.newton_iteration()
        ts.newton_iteration()
        pn = js.perturbation_norm()
        assert (ts.perturbation_norm() > 1e-10) == (pn > 1e-10)
        jc = np.array(f["c"])
        errs.append(rel_err(np.array(tf["c"]), jc))
        assert js.iteration <= 20
    assert ts.iteration == js.iteration
    assert max(errs) <= RTOL, errs
    assert abs(radius() - tbench.LANE_EMDEN_R[n]) < 1e-5
