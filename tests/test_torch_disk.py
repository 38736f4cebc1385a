"""
The disk in the port (dedalus_tpu_torch: PolarCoordinates, DiskBasis and
its circle edge, the Zernike library copy, the polar operators, the
angularly constant disk NCCs, low_pass_filter, and the libration IVP of
examples/libration.py) held against the JAX package on the CPU, inputs
from numpy seeds:

  * libraries/zernike.py matrices equal the JAX copy's (np.array_equal);
  * scalar, vector and rank-2 transforms, grid -> coeff -> grid, f64 and
    complex128, at the grid and the dealias scale, agree to 1e-13
    relative;
  * grad, div, lap, skew, trace, the components (rank 2, either index),
    interpolation, the azimuthal interpolation and average, integration
    and lift agree to 1e-12, and m = 0, 1 and a high m separately;
  * the scalar and vector Poisson LBVPs and the LHS NCC LBVP (scalar,
    radial-vector and contraction NCCs; f64 and complex128) agree to
    1e-12;
  * libration at 16x32: the valid masks and S bit for bit, M and L
    np.array_equal, 10 SBDF2 steps with u to 1e-12 (the algebraic p and
    taus to 1e-10, bounded by the pencils' conditioning), also from the
    system
    carried from the JAX solver; problem.time is not the user's t in
    both packages; a time-dependent RHS on the problem's own time field
    agrees to 1e-12;
  * an azimuthally varying disk NCC builds one m-coupled pencil (it
    raised NotImplementedError until the m-coupled pencils came).
"""

import numpy as np
import pytest
import torch
from scipy.special import jv

import dedalus_tpu.public as jd3
from dedalus_tpu.libraries import zernike as jzernike
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.libraries import zernike as tzernike
from dedalus_tpu_torch.extras import bench_problems as tbench
from dedalus_tpu_torch.tools import carry

torch.set_num_threads(1)

RTOL = 1e-12
TRANSFORM_RTOL = 1e-13


def rel_err(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) \
        / np.max(np.abs(np.asarray(b)))


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def make_disk(d3, dtype=np.float64, shape=(16, 12), radius=1.5,
              dealias=(1, 1)):
    cs = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(cs, dtype=dtype, **dist_kw(d3))
    disk = d3.DiskBasis(cs, shape=shape, dtype=dtype, radius=radius,
                        dealias=dealias)
    return cs, dist, disk


def random_data(shape, dtype, seed):
    """Normal random data from a numpy seed (complex for a complex
    dtype)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        data = data + 1j * rng.standard_normal(shape)
    return data


def random_field(dist, cs, basis, rank, seed, name="f"):
    f = dist.Field(name=name, bases=basis, tensorsig=(cs,) * rank)
    f["g"] = random_data(f["g"].shape, f.dtype, seed)
    return f


# ---------------------------------------------------- the Zernike library

ZERNIKE_CASES = [(8, 0, 0), (8, 1, 3), (12, 2, 5), (12, 0, 1)]
ZERNIKE_FUNCTIONS = {
    "quadrature": lambda lib, n, k, l: lib.quadrature(2, n, k),
    "grid": lambda lib, n, k, l: lib.grid(2, n, k),
    "polynomials": lambda lib, n, k, l: lib.polynomials(
        2, n, k, l, np.linspace(-0.9, 0.9, 7)),
    "derivatives": lambda lib, n, k, l: lib.polynomials_and_r_derivatives(
        2, n, k, l, np.linspace(-0.9, 0.9, 7)),
    "conversion": lambda lib, n, k, l: lib.conversion_matrix(2, n, k, l),
    "ladder_up": lambda lib, n, k, l: lib.ladder_matrix(
        2, n, k, l, l + 1, l, +1),
    "ladder_down": lambda lib, n, k, l: lib.ladder_matrix(
        2, n, k, l, abs(l - 1), l, -1),
    "r2": lambda lib, n, k, l: lib.r2_multiplication_matrix(2, n, k, l),
    "interpolation": lambda lib, n, k, l: lib.interpolation_row(
        2, n, k, l, 0.8),
    "integration": lambda lib, n, k, l: lib.integration_row(2, n, k, l),
    "ball_conversion": lambda lib, n, k, l: lib.conversion_matrix(
        3, n, k, l),
}


@pytest.mark.parametrize("case", ZERNIKE_CASES, ids=str)
@pytest.mark.parametrize("fn", list(ZERNIKE_FUNCTIONS))
def test_zernike_matrices_equal_jax_copy(fn, case):
    out = ZERNIKE_FUNCTIONS[fn](tzernike, *case)
    ref = ZERNIKE_FUNCTIONS[fn](jzernike, *case)
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert o.shape == r.shape
        assert np.array_equal(o, r)


# ------------------------------------------------------------ transforms

@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("scale", [1, 1.5])
def test_transforms_match_jax(scale, rank, dtype):
    """grid -> coeff (spin recombination and the per-m Zernike stacks) and
    back (bound 1e-13 relative)."""
    out = {}
    for d3 in (jd3, td3):
        cs, dist, disk = make_disk(d3, dtype)
        f = dist.Field(name="f", bases=disk, tensorsig=(cs,) * rank)
        f.change_scales(scale)
        f["g"] = random_data(f["g"].shape, dtype, 21 + rank)
        c = np.array(f["c"])
        f["c"] = c
        out[d3] = (c, np.array(f["g"]))
    for part in range(2):
        assert rel_err(out[td3][part], out[jd3][part]) <= TRANSFORM_RTOL


@pytest.mark.parametrize("m", [0, 1, 7])
def test_vector_transform_single_m(m):
    """A vector field of one azimuthal wavenumber (m = 0, 1, and the
    highest carried at Nphi = 16): the real (cos, -sin) spin pairs of that
    group alone, against the JAX package (1e-13) and the grid roundtrip
    (1e-12)."""
    out = {}
    for d3 in (jd3, td3):
        cs, dist, disk = make_disk(d3)
        phi, r = dist.local_grids(disk)
        x, y = r * np.cos(phi), r * np.sin(phi)
        u = dist.VectorField(cs, name="u", bases=disk)
        ux = r ** 2 * np.cos(m * phi) + x
        uy = r ** 3 * np.sin(m * phi) - y
        u["g"] = np.array([-np.sin(phi) * ux + np.cos(phi) * uy,
                           np.cos(phi) * ux + np.sin(phi) * uy])
        g0 = np.array(u["g"])
        c = np.array(u["c"])
        grad = np.array(d3.div(u).evaluate()["g"])
        out[d3] = (c, grad, g0)
    assert rel_err(out[td3][0], out[jd3][0]) <= TRANSFORM_RTOL
    assert rel_err(out[td3][1], out[jd3][1]) <= RTOL


# ------------------------------------------------------------- operators

OPERATORS = {
    "grad": lambda d3, cs, u, f: d3.grad(f),
    "div": lambda d3, cs, u, f: d3.div(u),
    "lap_scalar": lambda d3, cs, u, f: d3.lap(f),
    "lap_vector": lambda d3, cs, u, f: d3.lap(u),
    "grad_grad": lambda d3, cs, u, f: d3.grad(d3.grad(f)),
    "skew": lambda d3, cs, u, f: d3.skew(u),
    "vorticity": lambda d3, cs, u, f: -d3.div(d3.skew(u)),
    "trace_grad": lambda d3, cs, u, f: d3.trace(d3.grad(u)),
    "radial": lambda d3, cs, u, f: d3.radial(u),
    "azimuthal": lambda d3, cs, u, f: d3.azimuthal(u),
    "radial_index1": lambda d3, cs, u, f: d3.radial(d3.grad(u), 1),
    "azimuthal_index1": lambda d3, cs, u, f: d3.azimuthal(d3.grad(u), 1),
    "interp_edge": lambda d3, cs, u, f: u(r=1.5),
    "interp_mid": lambda d3, cs, u, f: d3.lap(f)(r=0.7),
    "radial_edge": lambda d3, cs, u, f: d3.radial(u(r=1.5)),
    "azimuthal_edge": lambda d3, cs, u, f: d3.azimuthal(u(r=1.5)),
    "integ": lambda d3, cs, u, f: d3.integ(f),
    "ave": lambda d3, cs, u, f: d3.ave(f * f),
    "interp_phi": lambda d3, cs, u, f: d3.Interpolate(u, cs["phi"], 0.73),
    "azavg": lambda d3, cs, u, f: d3.AzimuthalAverage(f),
    "azavg_edge": lambda d3, cs, u, f: d3.AzimuthalAverage(u(r=1.5)),
    "u_grad_u": lambda d3, cs, u, f: u @ d3.grad(u),
    "lift": lambda d3, cs, u, f: d3.Lift(
        u(r=1.5), f.domain.bases[0].derivative_basis(2), -1),
    "lift_scalar": lambda d3, cs, u, f: d3.Lift(
        f(r=1.5), f.domain.bases[0], -1),
}


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("op", list(OPERATORS))
def test_operators_match_jax(op, dtype):
    """Each operator on the same random u, f (dealias 3/2): coefficients
    and grid values (bound 1e-12 relative)."""
    out = {}
    for d3 in (jd3, td3):
        cs, dist, disk = make_disk(d3, dtype, dealias=(3 / 2, 3 / 2))
        u = random_field(dist, cs, disk, 1, 41, "u")
        f = random_field(dist, cs, disk, 0, 42, "f")
        r = OPERATORS[op](d3, cs, u, f).evaluate()
        out[d3] = (np.array(r["c"]), np.array(r["g"]))
    for part in range(2):
        assert out[td3][part].shape == out[jd3][part].shape
        assert rel_err(out[td3][part], out[jd3][part]) <= RTOL


def test_operators_on_closed_forms():
    """The port's grad, lap, skew, edge components and integral on the
    JAX package's tests/test_disk.py oracles, and the rank-2 component
    extraction at index 1 against the grid (tests/test_azimuthal_ops.py)."""
    cs, dist, disk = make_disk(td3, shape=(24, 16), radius=2.0)
    phi, r = dist.local_grids(disk)
    x, y = r * np.cos(phi), r * np.sin(phi)
    f = dist.Field(name="f", bases=disk)
    f["g"] = x ** 3 * y - y ** 2 + x
    dfx, dfy = 3 * x ** 2 * y + 1, x ** 3 - 2 * y
    gphi = -np.sin(phi) * dfx + np.cos(phi) * dfy
    gr = np.cos(phi) * dfx + np.sin(phi) * dfy
    g = td3.grad(f).evaluate()["g"]
    assert np.abs(g[0] - gphi).max() < 1e-9
    assert np.abs(g[1] - gr).max() < 1e-9
    assert np.abs(td3.lap(f).evaluate()["g"] - (6 * x * y - 2)).max() < 1e-7
    sk = td3.skew(td3.grad(f)).evaluate()["g"]
    assert np.abs(sk[0] - gr).max() < 1e-9
    assert np.abs(sk[1] + gphi).max() < 1e-9
    uR = td3.grad(f)(r=2.0)
    p0 = phi[:, 0]
    dfx0 = 3 * (2 * np.cos(p0)) ** 2 * (2 * np.sin(p0)) + 1
    dfy0 = (2 * np.cos(p0)) ** 3 - 2 * (2 * np.sin(p0))
    er = np.cos(p0) * dfx0 + np.sin(p0) * dfy0
    assert np.abs(td3.radial(uR).evaluate()["g"][:, 0] - er).max() < 1e-9
    h = dist.Field(name="h", bases=disk)
    h["g"] = x ** 2 * y - y + 2
    total = float(np.asarray(td3.integ(h).evaluate()["g"]).ravel()[0])
    assert abs(total - 2 * np.pi * 4) < 1e-10
    from dedalus_tpu_torch.core.future import EvalContext
    T = dist.TensorField(cs, name="T", bases=disk)
    Tc = np.array([[x * y + 0 * r, x ** 2 + 0 * r],
                   [y ** 2 + 0 * r, x + y + 0 * r]])
    Rot = np.array([[-np.sin(phi) + 0 * r, np.cos(phi) + 0 * r],
                    [np.cos(phi) + 0 * r, np.sin(phi) + 0 * r]])
    T["g"] = np.einsum("ia...,ab...,jb...->ij...", Rot, Tc, Rot)
    tg = np.array(T["g"])
    rad1 = td3.radial(T, 1).ev(EvalContext(), "g").numpy()
    azi1 = td3.azimuthal(T, 1).ev(EvalContext(), "g").numpy()
    assert np.abs(rad1 - tg[:, 1]).max() < 1e-12
    assert np.abs(azi1 - tg[:, 0]).max() < 1e-12


def test_low_pass_filter_matches_jax():
    """low_pass_filter(scales=0.25) of a random vector field, as the
    libration example filters its initial state (bound 1e-13)."""
    out = {}
    for d3 in (jd3, td3):
        cs, dist, disk = make_disk(d3, shape=(16, 32), radius=1.0,
                                   dealias=(3 / 2, 3 / 2))
        u = dist.VectorField(cs, name="u", bases=disk)
        u.fill_random("g", seed=42, distribution="normal")
        u.low_pass_filter(scales=0.25)
        out[d3] = (np.array(u["c"]), np.array(u["g"]))
    for part in range(2):
        assert rel_err(out[td3][part], out[jd3][part]) <= TRANSFORM_RTOL


# ------------------------------------------------------------- the LBVPs

def poisson_scalar(d3, dtype):
    cs, dist, disk = make_disk(d3, dtype, shape=(24, 16), radius=1.5)
    R = 1.5
    phi, r = dist.local_grids(disk)
    x, y = r * np.cos(phi), r * np.sin(phi)
    u = dist.Field(name="u", bases=disk)
    tau = dist.Field(name="tau", bases=disk.edge)
    f = dist.Field(name="f", bases=disk)
    f["g"] = -12 * x * y
    lift = lambda A: d3.Lift(A, disk.derivative_basis(2), -1)  # noqa: E731
    problem = d3.LBVP([u, tau], namespace=locals())
    problem.add_equation("lap(u) + lift(tau) = f")
    problem.add_equation("u(r=1.5) = 0")
    problem.build_solver().solve()
    return [u, tau], (R ** 2 - r ** 2) * x * y


def poisson_vector(d3, dtype):
    cs, dist, disk = make_disk(d3, dtype, shape=(24, 16), radius=1.0)
    phi, r = dist.local_grids(disk)
    x, y = r * np.cos(phi), r * np.sin(phi)
    u = dist.VectorField(cs, name="u", bases=disk)
    tau_u = dist.VectorField(cs, name="tau_u", bases=disk.edge)
    F = dist.VectorField(cs, name="F", bases=disk)
    F["g"] = np.array([-np.sin(phi) * 32 * x + np.cos(phi) * 32 * y,
                       np.cos(phi) * 32 * x + np.sin(phi) * 32 * y])
    lift = lambda A: d3.Lift(A, disk.derivative_basis(2), -1)  # noqa: E731
    problem = d3.LBVP([u, tau_u], namespace=locals())
    problem.add_equation("lap(u) + lift(tau_u) = F")
    problem.add_equation("u(r=1) = 0")
    problem.build_solver().solve()
    ex, ey = -4 * x * (1 - r ** 2), -4 * y * (1 - r ** 2)
    return [u, tau_u], np.array([-np.sin(phi) * ex + np.cos(phi) * ey,
                                 np.cos(phi) * ex + np.sin(phi) * ey])


def ncc_lhs(d3, dtype):
    """tests/test_disk.py:182: scalar, radial-vector and contraction LHS
    NCCs (the per-(m, spin) Zernike stack path)."""
    cs, dist, disk = make_disk(d3, dtype, shape=(16, 12), radius=1.0)
    phi, r = dist.local_grids(disk)
    shape = np.broadcast_shapes(phi.shape, r.shape)
    w0 = dist.Field(name="w0", bases=disk)
    w0["g"] = np.broadcast_to(np.asarray(1 - r ** 2), shape)
    gv = dist.VectorField(cs, name="gv", bases=disk)
    gv["g"][1] = np.broadcast_to(np.asarray(r), shape)
    bsrc = dist.Field(name="bsrc", bases=disk)
    bsrc["g"] = (r * np.cos(phi)) ** 2 + r * np.sin(phi)
    vsrc = dist.VectorField(cs, name="vsrc", bases=disk)
    vsrc["g"][0] = r * np.cos(phi)
    vsrc["g"][1] = r ** 2
    b2 = dist.Field(name="b2", bases=disk)
    u = dist.VectorField(cs, name="u", bases=disk)
    v2 = dist.VectorField(cs, name="v2", bases=disk)
    s2 = dist.Field(name="s2", bases=disk)
    w2 = dist.Field(name="w2", bases=disk)
    problem = d3.LBVP([b2, u, v2, s2, w2], namespace=locals())
    problem.add_equation("b2 = bsrc")
    problem.add_equation("v2 = vsrc")
    problem.add_equation("u + gv*b2 = 0")
    problem.add_equation("s2 - w0*b2 = 0")
    problem.add_equation("w2 + gv@v2 = 0")
    problem.build_solver().solve()
    expect = -np.asarray(gv["g"]) * np.asarray(bsrc["g"])[None]
    return [b2, v2, s2, w2, u], expect


LBVPS = {"poisson_scalar": poisson_scalar, "poisson_vector": poisson_vector,
         "ncc_lhs": ncc_lhs}
LBVP_CASES = [("poisson_scalar", np.float64), ("poisson_vector", np.float64),
              ("ncc_lhs", np.float64), ("ncc_lhs", np.complex128)]


@pytest.mark.parametrize("case", LBVP_CASES,
                         ids=[f"{n}-{np.dtype(d).name}" for n, d in LBVP_CASES])
def test_lbvps_match_jax(case):
    """The port's solution equals the JAX package's to 1e-12 relative,
    and the closed form (the JAX tests' bounds)."""
    name, dtype = case
    jvars, _ = LBVPS[name](jd3, dtype)
    tvars, expect = LBVPS[name](td3, dtype)
    scale = max(np.abs(np.array(b["g"])).max() for b in jvars)
    for a, b in zip(tvars, jvars):
        err = np.abs(np.array(a["g"]) - np.array(b["g"])).max() / scale
        assert err <= RTOL, a.name
    assert np.abs(np.array(tvars[-1]["g"] if name == "ncc_lhs"
                           else tvars[0]["g"]) - expect).max() < 1e-11


def test_azimuth_varying_ncc_raises():
    """An LHS NCC varying with azimuth couples the m groups. The port
    refused it until the m-coupled polar pencils came; it now builds one
    flattened (m x r) pencil (the azimuth forced coupled), and the
    solution of ncc*u = v reproduces v through the grid product to
    1e-10 (tests/test_torch_polar_azncc.py holds these pencils against
    the JAX package)."""
    cs, dist, disk = make_disk(td3)
    phi, r = dist.local_grids(disk)
    ncc = dist.Field(name="ncc", bases=disk)
    ncc["g"] = 1 + 0.3 * np.cos(phi) * r
    u = dist.Field(name="u", bases=disk)
    v = dist.Field(name="v", bases=disk)
    v["g"] = (1 + 0.5 * r * np.sin(phi)) * r ** 2
    problem = td3.LBVP([u], namespace=locals())
    problem.add_equation("ncc*u = v")
    solver = problem.build_solver()
    assert disk.first_axis in solver.layout.forced_coupled
    assert solver.pencil_shape[0] == 1
    solver.solve()
    out = (ncc * u).evaluate()
    out.change_scales(1)
    assert np.abs(np.asarray(out["g"]) - np.asarray(v["g"])).max() < 1e-10


# ---------------------------------------------------- libration 16x32

def jax_disk_libration(Nphi, Nr):
    """examples/libration.py with the JAX package, without its file
    handlers (the port's counterpart is bench_problems.build_disk_libration).
    Returns (solver, dt, t)."""
    d3 = jd3
    Ekman, Ro, dealias, dtype = 1 / 2 / 20 ** 2, 40, 3 / 2, np.float64
    coords = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(coords, dtype=dtype)
    disk = d3.DiskBasis(coords, shape=(Nphi, Nr), radius=1, dealias=dealias,
                        dtype=dtype)
    edge = disk.edge
    u = dist.VectorField(coords, name="u", bases=disk)
    p = dist.Field(name="p", bases=disk)
    tau_u = dist.VectorField(coords, name="tau_u", bases=edge)
    tau_p = dist.Field(name="tau_p")
    phi, r = dist.local_grids(disk)
    nu = Ekman
    lift = lambda A: d3.Lift(A, disk, -1)  # noqa: E731
    u0_real = dist.VectorField(coords, bases=disk)
    u0_imag = dist.VectorField(coords, bases=disk)
    u0_real["g"][0] = Ro * np.real(jv(1, (1 - 1j) * r / np.sqrt(2 * Ekman))
                                   / jv(1, (1 - 1j) / np.sqrt(2 * Ekman)))
    u0_imag["g"][0] = Ro * np.imag(jv(1, (1 - 1j) * r / np.sqrt(2 * Ekman))
                                   / jv(1, (1 - 1j) / np.sqrt(2 * Ekman)))
    t = dist.Field()
    u0 = np.cos(t) * u0_real - np.sin(t) * u0_imag
    problem = d3.IVP([p, u, tau_u, tau_p], time=t, namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation(
        "dt(u) - nu*lap(u) + grad(p) + lift(tau_u) = - u@grad(u0) - u0@grad(u)")
    problem.add_equation("u(r=1) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(d3.SBDF2)
    u.fill_random("g", seed=42, distribution="normal")
    u.low_pass_filter(scales=0.25)
    return solver, 1e-3, t


# p, tau_u and tau_p carry no time derivative: each step solves for them
# afresh from pencils whose condition number reaches 1.1e6 at 16x32
# (numpy.linalg.cond of M + dt L), so the two packages' LU roundoff
# (~1e-16 each) may differ there by up to cond * eps ~ 1e-10 of the
# state; measured up to 1.2e-11 in 10 steps. The evolved field u is held
# to 1e-12.
ALGEBRAIC_RTOL = 1e-10


def state_errors(ts, js):
    """{name: max |port - JAX| / max |JAX state|} per variable."""
    scale = np.abs(np.asarray(js.X)).max()
    return {tv.name: np.abs(np.array(tv["c"]) - np.array(jv["c"])).max()
            / scale for tv, jv in zip(ts.variables, js.variables)}


def assert_state_matches(ts, js):
    errors = state_errors(ts, js)
    assert errors["u"] <= RTOL, errors
    assert max(errors.values()) <= ALGEBRAIC_RTOL, errors


@pytest.fixture(scope="module")
def libration16():
    js, dt, jt = jax_disk_libration(16, 32)
    ts, tdt, flow, tt = tbench.build_disk_libration(16, 32, device="cpu")
    assert tdt == dt
    return js, jt, ts, tt, flow, dt


def test_libration_pencils_bit_equal(libration16):
    """The JAX package's path (dense), G, S, the valid-row mask and M, L
    (np.array_equal)."""
    js, _, ts, _, _, _ = libration16
    assert ts.ops.kind == js.ops.kind == "dense"
    assert ts.X.shape == tuple(np.asarray(js.X).shape) == (8, 198)
    assert np.array_equal(ts.valid_row_mask, np.asarray(js.valid_row_mask))
    for name in ("M", "L"):
        assert np.array_equal(np.asarray(ts._matrices[name]),
                              np.asarray(js._matrices[name]))


def test_libration_trajectory_matches_jax(libration16):
    """10 SBDF2 steps at the example's dt from the same filtered random
    state (u to 1e-12 of the state, the algebraic p and taus to 1e-10, as
    ALGEBRAIC_RTOL states); u(r=1) = 0 and div(u) + tau_p = 0 hold
    to 1e-10; the user's t stays 0 in both packages (the problem keeps its
    own time field)."""
    js, jt, ts, tt, flow, dt = libration16
    assert rel_err(ts.gather_fields().numpy(),
                   np.asarray(js.gather_fields())) <= 1e-13
    for _ in range(10):
        js.step(dt)
        ts.step(dt)
    assert_state_matches(ts, js)
    assert js.problem.time is not jt and ts.problem.time is not tt
    assert float(np.asarray(jt["g"]).ravel()[0]) == 0.0
    assert float(np.asarray(tt["g"]).ravel()[0]) == 0.0
    assert abs(ts.sim_time - js.sim_time) <= 1e-15
    p, u, tau_u, tau_p = ts.variables
    assert np.abs(np.array(u(r=1).evaluate()["g"])).max() < 1e-10
    resid = (td3.div(u) + tau_p).evaluate()
    assert np.abs(np.array(resid["g"])).max() < 1e-10
    assert np.isfinite(flow.max("u2"))


def test_libration_step_from_carried_system():
    """tools/carry.py: the JAX solver's dense M, L and its initial state
    installed into a port solver before either steps (SBDF2 keeps a
    history the carry does not move); both step 5 times (u to 1e-12, the
    algebraic fields to 1e-10)."""
    js, dt, _ = jax_disk_libration(16, 32)
    ts, _, _, _ = tbench.build_disk_libration(16, 32, device="cpu")
    matrices = {name: np.asarray(js._matrices[name]) for name in ("M", "L")}
    carry.install_system(ts, None, matrices, X=np.asarray(js.gather_fields()))
    for _ in range(5):
        js.step(dt)
        ts.step(dt)
    assert_state_matches(ts, js)


def time_dependent_ivp(d3, dtype):
    """A disk IVP whose RHS reads the problem's own time field by name:
    dt(u) - lap(u) + lift(tau) = sin(3 t) f, u(r=1) = 0."""
    cs, dist, disk = make_disk(d3, dtype, shape=(16, 12), radius=1.0,
                               dealias=(3 / 2, 3 / 2))
    phi, r = dist.local_grids(disk)
    u = dist.Field(name="u", bases=disk)
    tau = dist.Field(name="tau", bases=disk.edge)
    f = dist.Field(name="f", bases=disk)
    f["g"] = (1 - r ** 2) * (1 + r * np.cos(phi))
    lift = lambda A: d3.Lift(A, disk.derivative_basis(2), -1)  # noqa: E731
    problem = d3.IVP([u, tau], namespace=locals())
    problem.add_equation("dt(u) - lap(u) + lift(tau) = np.sin(3*t)*f")
    problem.add_equation("u(r=1) = 0")
    return problem.build_solver(d3.RK222), problem


def test_time_dependent_rhs_matches_jax():
    """10 RK222 steps of an RHS on the problem's time field `t` (set on
    the solver's device each stage), against the JAX package (bound
    1e-12 relative)."""
    js, jp = time_dependent_ivp(jd3, np.float64)
    ts, tp = time_dependent_ivp(td3, np.float64)
    assert tp.time.name == "t" and jp.time.name == "t"
    for _ in range(10):
        js.step(0.05)
        ts.step(0.05)
    assert np.abs(ts.X.numpy()).max() > 1e-3
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL
