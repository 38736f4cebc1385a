"""
The annulus in the port (dedalus_tpu_torch: PolarCoordinates,
AnnulusBasis, the weighted-Jacobi radial copy, the polar operators, the
angularly constant scalar and tensor NCCs, the azimuthal interpolation and
average, the polar CFL, and the centrifugal-convection IVP of
examples/centrifugal_convection.py) held against the JAX package on the
CPU, inputs from numpy seeds:

  * core/weighted_jacobi.py matrices equal the JAX copy's (np.array_equal);
  * scalar, vector and rank-2 transforms, grid -> coeff -> grid, at k = 0
    and k = 1, f64 and complex128, agree to 1e-13 relative;
  * grad, div, lap, skew, trace, the components, interpolation, the
    azimuthal interpolation and average, integration and lift agree to
    1e-12;
  * the scalar and vector Poisson LBVPs and the scalar and vector LHS NCC
    LBVPs (f64 and complex128) agree to 1e-12;
  * centrifugal convection at 32x16: the pencil valid masks and S bit for
    bit, M and L np.array_equal, 10 RK222 steps to 1e-12 (also from the
    system carried from the JAX solver), the CFL timestep equal;
  * an azimuthally varying annulus NCC builds one m-coupled pencil
    (it raised NotImplementedError until the m-coupled pencils came).
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.extras import bench_problems as tbench
from dedalus_tpu_torch.tools import carry

torch.set_num_threads(1)

RTOL = 1e-12
TRANSFORM_RTOL = 1e-13
RI, RO = 1.0, 3.0


def rel_err(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) \
        / np.max(np.abs(np.asarray(b)))


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def make_annulus(d3, dtype=np.float64, shape=(24, 16), k=0,
                 dealias=(1, 1)):
    cs = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(cs, dtype=dtype, **dist_kw(d3))
    ann = d3.AnnulusBasis(cs, shape=shape, dtype=dtype, radii=(RI, RO), k=k,
                          dealias=dealias)
    return cs, dist, ann


def random_data(shape, dtype, seed):
    """Normal random data from a numpy seed (complex for a complex
    dtype)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        data = data + 1j * rng.standard_normal(shape)
    return data


def random_field(dist, cs, basis, rank, seed, name="f"):
    """A field of the given tensor rank over cs with random grid data
    (the same data in both packages)."""
    f = dist.Field(name=name, bases=basis, tensorsig=(cs,) * rank)
    f["g"] = random_data(f["g"].shape, f.dtype, seed)
    return f


# ------------------------------------------- the weighted-Jacobi radial copy

WJ_FUNCTIONS = {
    "forward": lambda b: b._radial_forward_matrix(1.0),
    "forward_dealias": lambda b: b._radial_forward_matrix(1.5),
    "backward": lambda b: b._radial_backward_matrix(1.5),
    "ladder_parts": lambda b: np.stack(b._ladder_parts()),
    "conversion": lambda b: b._conversion_matrix_total(2),
    "interpolation": lambda b: b.radial_interpolation_row(2.2),
    "integration": lambda b: b.radial_integration_row(1),
    "constant": lambda b: b.radial_constant_column(),
    "multiplication": lambda b: b.radial_multiplication_matrix(
        np.linspace(1.0, 0.1, 7), 1, k_out=0),
    "ladder_stack": lambda b: b.ladder_stack(1, -1),
    "laplacian_stack": lambda b: b.laplacian_stack(-1),
}


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("fn", list(WJ_FUNCTIONS))
def test_weighted_jacobi_matrices_equal_jax_copy(fn, k):
    out = {}
    for d3 in (jd3, td3):
        _, _, ann = make_annulus(d3, shape=(16, 12), k=k)
        out[d3] = np.asarray(WJ_FUNCTIONS[fn](ann))
    assert out[td3].shape == out[jd3].shape
    assert np.array_equal(out[td3], out[jd3])


# ------------------------------------------------------------ transforms

@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("rank", [0, 1, 2])
def test_transforms_match_jax(rank, k, dtype):
    """grid -> coeff (spin recombination and the radial product) and back,
    at the dealias scale 3/2 (bound 1e-13 relative)."""
    out = {}
    for d3 in (jd3, td3):
        cs, dist, ann = make_annulus(d3, dtype, shape=(16, 12), k=k)
        f = dist.Field(name="f", bases=ann, tensorsig=(cs,) * rank)
        f.change_scales(1.5)
        f["g"] = random_data(f["g"].shape, dtype, 9 + rank)
        c = np.array(f["c"])
        f["c"] = c
        out[d3] = (c, np.array(f["g"]))
    for part in range(2):
        assert rel_err(out[td3][part], out[jd3][part]) <= TRANSFORM_RTOL


# ------------------------------------------------------------- operators

OPERATORS = {
    "grad": lambda d3, cs, u, f: d3.grad(f),
    "div": lambda d3, cs, u, f: d3.div(u),
    "lap_scalar": lambda d3, cs, u, f: d3.lap(f),
    "lap_vector": lambda d3, cs, u, f: d3.lap(u),
    "skew": lambda d3, cs, u, f: d3.skew(u),
    "vorticity": lambda d3, cs, u, f: -d3.div(d3.skew(u)),
    "trace_grad": lambda d3, cs, u, f: d3.trace(d3.grad(u)),
    "radial": lambda d3, cs, u, f: d3.radial(u),
    "azimuthal": lambda d3, cs, u, f: d3.azimuthal(u),
    "interp_outer": lambda d3, cs, u, f: u(r=RO),
    "interp_mid": lambda d3, cs, u, f: d3.lap(f)(r=2.2),
    "radial_edge": lambda d3, cs, u, f: d3.radial(u(r=RI)),
    "integ": lambda d3, cs, u, f: d3.integ(f),
    "ave": lambda d3, cs, u, f: d3.ave(f * f),
    "interp_phi": lambda d3, cs, u, f: d3.Interpolate(u, cs["phi"], 0.73),
    "azavg": lambda d3, cs, u, f: d3.AzimuthalAverage(f),
    "azavg_vector": lambda d3, cs, u, f: d3.AzimuthalAverage(u),
    "u_grad_u": lambda d3, cs, u, f: u @ d3.grad(u),
    "lift": lambda d3, cs, u, f: d3.Lift(
        u(r=RI), f.domain.bases[0].derivative_basis(2), -1),
}


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("op", list(OPERATORS))
def test_operators_match_jax(op, dtype):
    """Each operator on the same random u, f (dealias 3/2): coefficients
    and grid values (bound 1e-12 relative)."""
    out = {}
    for d3 in (jd3, td3):
        cs, dist, ann = make_annulus(d3, dtype, shape=(16, 12),
                                     dealias=(3 / 2, 3 / 2))
        u = random_field(dist, cs, ann, 1, 31, "u")
        f = random_field(dist, cs, ann, 0, 32, "f")
        r = OPERATORS[op](d3, cs, u, f).evaluate()
        out[d3] = (np.array(r["c"]), np.array(r["g"]))
    for part in range(2):
        assert out[td3][part].shape == out[jd3][part].shape
        assert rel_err(out[td3][part], out[jd3][part]) <= RTOL


def test_operators_on_closed_forms():
    """grad, lap, skew and the azimuthal interpolation of the port on
    closed forms (the JAX package's tests/test_annulus.py oracles)."""
    cs, dist, ann = make_annulus(td3, shape=(32, 24))
    phi, r = dist.local_grids(ann)
    x, y = r * np.cos(phi), r * np.sin(phi)
    f = dist.Field(name="f", bases=ann)
    f["g"] = x ** 3 * y - y ** 2 + x + np.log(r)
    dfx = 3 * x ** 2 * y + 1 + x / r ** 2
    dfy = x ** 3 - 2 * y + y / r ** 2
    gphi = -np.sin(phi) * dfx + np.cos(phi) * dfy
    gr = np.cos(phi) * dfx + np.sin(phi) * dfy
    g = td3.grad(f).evaluate()["g"]
    assert np.abs(g[0] - gphi).max() < 1e-8
    assert np.abs(g[1] - gr).max() < 1e-8
    assert np.abs(td3.lap(f).evaluate()["g"] - (6 * x * y - 2)).max() < 1e-7
    sk = td3.skew(td3.grad(f)).evaluate()["g"]
    assert np.abs(sk[0] - gr).max() < 1e-8
    assert np.abs(sk[1] + gphi).max() < 1e-8
    h = dist.Field(name="h", bases=ann)
    h["g"] = np.cos(3 * phi) * r ** 2 + np.sin(phi) / r
    out = np.asarray(td3.Interpolate(h, cs["phi"], 0.73).evaluate()["g"])
    expect = np.cos(3 * 0.73) * r ** 2 + np.sin(0.73) / r
    assert np.abs(out - expect).max() < 1e-12


# ------------------------------------------------------------- the LBVPs

def poisson_scalar(d3, dtype):
    cs, dist, ann = make_annulus(d3, dtype, shape=(24, 24))
    phi, r = dist.local_grids(ann)
    u = dist.Field(name="u", bases=ann)
    tau1 = dist.Field(name="tau1", bases=ann.edge)
    tau2 = dist.Field(name="tau2", bases=ann.edge)
    f = dist.Field(name="f", bases=ann)
    f["g"] = -16 * r ** 2 + 4 * (RI ** 2 + RO ** 2) + 0 * phi
    lift_basis = ann.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)  # noqa: E731
    problem = d3.LBVP([u, tau1, tau2],
                      namespace={**locals(), "RI": RI, "RO": RO})
    problem.add_equation("lap(u) + lift(tau1, -1) + lift(tau2, -2) = f")
    problem.add_equation("u(r=RI) = 0")
    problem.add_equation("u(r=RO) = 0")
    problem.build_solver().solve()
    return [u], (r ** 2 - RI ** 2) * (RO ** 2 - r ** 2)


def poisson_vector(d3, dtype):
    cs, dist, ann = make_annulus(d3, dtype, shape=(24, 28))
    phi, r = dist.local_grids(ann)
    x = r * np.cos(phi)
    h = dist.Field(name="h", bases=ann)
    h["g"] = ((r ** 2 - RI ** 2) * (RO ** 2 - r ** 2)) ** 2 * (1 + 0.1 * x)
    F = dist.VectorField(cs, name="F", bases=ann)
    F["g"] = np.asarray(d3.lap(d3.grad(h)).evaluate()["g"])
    u = dist.VectorField(cs, name="u", bases=ann)
    tau1 = dist.VectorField(cs, name="tau1", bases=ann.edge)
    tau2 = dist.VectorField(cs, name="tau2", bases=ann.edge)
    lift_basis = ann.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)  # noqa: E731
    problem = d3.LBVP([u, tau1, tau2],
                      namespace={**locals(), "RI": RI, "RO": RO})
    problem.add_equation("lap(u) + lift(tau1, -1) + lift(tau2, -2) = F")
    problem.add_equation("u(r=RI) = 0")
    problem.add_equation("u(r=RO) = 0")
    problem.build_solver().solve()
    return [u], np.asarray(d3.grad(h).evaluate()["g"])


def ncc_scalar(d3, dtype):
    cs, dist, ann = make_annulus(d3, dtype, shape=(16, 16))
    phi, r = dist.local_grids(ann)
    x, y = r * np.cos(phi), r * np.sin(phi)
    ncc = dist.Field(name="ncc", bases=ann)
    ncc["g"] = r ** 2 + 1 / r + 0 * phi
    u = dist.Field(name="u", bases=ann)
    v = dist.Field(name="v", bases=ann)
    v["g"] = x * y + 3 * y + r
    problem = d3.LBVP([u], namespace=locals())
    problem.add_equation("ncc*u = ncc*v")
    problem.build_solver().solve()
    return [u], np.asarray(v["g"])


def ncc_vector(d3, dtype):
    """tests/test_annulus.py:213: b*g with a radial-vector gv (the tensor
    NCC path)."""
    cs, dist, ann = make_annulus(d3, dtype, shape=(16, 12))
    phi, r = dist.local_grids(ann)
    gv = dist.VectorField(cs, name="gv", bases=ann)
    gv["g"][1] = np.broadcast_to(np.asarray(0.5 + r ** 2),
                                 np.broadcast_shapes(phi.shape, r.shape))
    bsrc = dist.Field(name="bsrc", bases=ann)
    bsrc["g"] = np.cos(2 * phi) * (r - 2) ** 2 + np.sin(phi) * r
    b2 = dist.Field(name="b2", bases=ann)
    u = dist.VectorField(cs, name="u", bases=ann)
    problem = d3.LBVP([b2, u], namespace=locals())
    problem.add_equation("b2 = bsrc")
    problem.add_equation("u + gv*b2 = 0")
    problem.build_solver().solve()
    return [b2, u], -np.asarray(gv["g"]) * np.asarray(bsrc["g"])[None]


LBVPS = {"poisson_scalar": poisson_scalar, "poisson_vector": poisson_vector,
         "ncc_scalar": ncc_scalar, "ncc_vector": ncc_vector}
LBVP_CASES = [("poisson_scalar", np.float64), ("poisson_vector", np.float64),
              ("ncc_scalar", np.float64), ("ncc_vector", np.float64),
              ("ncc_vector", np.complex128)]


@pytest.mark.parametrize("case", LBVP_CASES,
                         ids=[f"{n}-{np.dtype(d).name}" for n, d in LBVP_CASES])
def test_lbvps_match_jax(case):
    """The port's solution equals the JAX package's to 1e-12 relative,
    and the closed form (the JAX tests' bounds)."""
    name, dtype = case
    jv, _ = LBVPS[name](jd3, dtype)
    tv, expect = LBVPS[name](td3, dtype)
    for a, b in zip(tv, jv):
        assert rel_err(np.array(a["g"]), np.array(b["g"])) <= RTOL
    assert rel_err(np.array(tv[-1]["g"]), expect) <= 1e-8


def test_azimuth_varying_ncc_raises():
    """An LHS NCC varying with azimuth couples the m groups. The port
    refused it until the m-coupled polar pencils came; it now builds one
    flattened (m x r) pencil (the azimuth forced coupled), and the
    solution of ncc*u = v reproduces v through the grid product to
    1e-10 (tests/test_torch_polar_azncc.py holds these pencils against
    the JAX package)."""
    cs, dist, ann = make_annulus(td3, shape=(16, 12))
    phi, r = dist.local_grids(ann)
    ncc = dist.Field(name="ncc", bases=ann)
    ncc["g"] = 1 + 0.3 * np.cos(phi) * r
    u = dist.Field(name="u", bases=ann)
    v = dist.Field(name="v", bases=ann)
    v["g"] = (1 + 0.5 * r * np.sin(phi)) * r ** 2
    problem = td3.LBVP([u], namespace=locals())
    problem.add_equation("ncc*u = v")
    solver = problem.build_solver()
    assert ann.first_axis in solver.layout.forced_coupled
    assert solver.pencil_shape[0] == 1
    solver.solve()
    out = (ncc * u).evaluate()
    out.change_scales(1)
    assert np.abs(np.asarray(out["g"]) - np.asarray(v["g"])).max() < 1e-10


# -------------------------------------------- centrifugal convection 32x16

def jax_annulus_convection(Nphi, Nr):
    """examples/centrifugal_convection.py with the JAX package, without
    its file handlers (the port's counterpart is
    bench_problems.build_annulus_convection)."""
    d3 = jd3
    eta, Rayleigh, Prandtl = 3, 1e6, 1
    dealias, max_timestep, dtype = 3 / 2, 0.125, np.float64
    Ri, Ro = 2 / (1 + eta), 2 * eta / (1 + eta)
    coords = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(coords, dtype=dtype)
    annulus = d3.AnnulusBasis(coords, shape=(Nphi, Nr), radii=(Ri, Ro),
                              dealias=dealias, dtype=dtype)
    edge = annulus.outer_edge
    p = dist.Field(name="p", bases=annulus)
    b = dist.Field(name="b", bases=annulus)
    u = dist.VectorField(coords, name="u", bases=annulus)
    tau_p = dist.Field(name="tau_p")
    tau_b1 = dist.Field(name="tau_b1", bases=edge)
    tau_b2 = dist.Field(name="tau_b2", bases=edge)
    tau_u1 = dist.VectorField(coords, name="tau_u1", bases=edge)
    tau_u2 = dist.VectorField(coords, name="tau_u2", bases=edge)
    kappa = (Rayleigh * Prandtl) ** (-1 / 2)
    nu = (Rayleigh / Prandtl) ** (-1 / 2)
    phi, r = dist.local_grids(annulus)
    rvec = dist.VectorField(coords, name="rvec", bases=annulus)
    rvec["g"][1] = np.broadcast_to(np.asarray(r), rvec["g"][1].shape)
    lift_basis = annulus.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)  # noqa: E731
    gravity = 2 * (eta - 1) / (eta + 1)
    g = gravity * rvec
    problem = d3.IVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2],
                     namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*lap(b) + lift(tau_b1, -1) "
                         "+ lift(tau_b2, -2) = - u@grad(b)")
    problem.add_equation("dt(u) - nu*lap(u) + grad(p) + b*g "
                         "+ lift(tau_u1, -1) + lift(tau_u2, -2) = - u@grad(u)")
    problem.add_equation("b(r=Ri) = 0")
    problem.add_equation("u(r=Ri) = 0")
    problem.add_equation("b(r=Ro) = 1")
    problem.add_equation("u(r=Ro) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(d3.RK222)
    b.fill_random("g", seed=42, distribution="normal", scale=1e-3)
    b["g"] *= (r - Ri) * (Ro - r)
    b["g"] += np.log(r / Ri) / np.log(Ro / Ri)
    cfl = d3.CFL(solver, initial_dt=max_timestep, max_dt=max_timestep,
                 safety=0.5, cadence=10, threshold=0.1, max_change=1.5,
                 min_change=0.5)
    cfl.add_velocity(u)
    return solver, cfl


@pytest.fixture(scope="module")
def convection32():
    js, jcfl = jax_annulus_convection(32, 16)
    ts, tcfl, flow = tbench.build_annulus_convection(32, 16, device="cpu")
    return js, jcfl, ts, tcfl, flow


# The example's second-order tau form leaves the m = 0 pencil singular in
# the JAX package's own matrices: a radial pressure profile p(r) trades
# against the velocity taus (tau_u1, tau_u2) of lift(., -1) and lift(., -2).
# b, u, tau_b1, tau_b2 and tau_p are determined; p and tau_u are determined
# only up to that null direction, which each package's LU fills with its
# own roundoff. The state is therefore compared on the determined fields.
DETERMINED = ("b", "u", "tau_p", "tau_b1", "tau_b2")


def ncc_block(solver, eq_index, var_name):
    """Row and column slices of one equation's block on one variable."""
    from dedalus_tpu_torch.core.subsystems import _system_sizes
    eqs = solver.problem.equations
    var_offsets, eq_sizes, _ = _system_sizes(solver.layout, eqs,
                                             solver.variables)
    row0 = int(np.sum(eq_sizes[:eq_index]))
    vi = [v.name for v in solver.variables].index(var_name)
    return (slice(row0, row0 + eq_sizes[eq_index]),
            slice(int(var_offsets[vi]), int(var_offsets[vi + 1])))


def test_convection_pencils_bit_equal(convection32):
    """The JAX package's path (dense), S, G, the valid-row mask, M
    (np.array_equal) and L: np.array_equal except the b*g block of the
    momentum equation, which agrees to 1e-14 relative (its radial profile
    is read from the NCC's grid data, which each package transforms with
    its own products)."""
    js, _, ts, _, _ = convection32
    assert ts.ops.kind == js.ops.kind == "dense"
    assert ts.X.shape == tuple(np.asarray(js.X).shape) == (16, 142)
    assert np.array_equal(ts.valid_row_mask, np.asarray(js.valid_row_mask))
    assert np.array_equal(np.asarray(ts._matrices["M"]),
                          np.asarray(js._matrices["M"]))
    tL = np.array(ts._matrices["L"])
    jL = np.array(js._matrices["L"])
    rows, cols = ncc_block(ts, 2, "b")
    assert rel_err(tL[:, rows, cols], jL[:, rows, cols]) <= 1e-14
    tL[:, rows, cols] = jL[:, rows, cols] = 0
    assert np.array_equal(tL, jL)


def test_convection_m0_pencil_singular_in_the_reference(convection32):
    """The m = 0 pencil of M + dt L is singular in both packages (the
    same matrices), with its null vector on p and the velocity taus
    only: a fact of the reference's formulation, not of the port."""
    js, _, ts, _, _ = convection32
    dt = 0.125
    null_vars = set()
    for solver in (js, ts):
        A = np.asarray(solver._matrices["M"]) \
            + dt * np.asarray(solver._matrices["L"])
        s = np.linalg.svd(A[0], compute_uv=False)
        assert s[-1] < 1e-14 * s[0] and s[-2] > 1e-6 * s[0]
        assert np.linalg.svd(A[1], compute_uv=False)[-1] > 1e-6 * s[0]
        v = np.linalg.svd(A[0])[2][-1]
        _, cols = ncc_block(ts, 0, "p")
        for name in [v_.name for v_ in ts.variables]:
            _, cols = ncc_block(ts, 0, name)
            if np.abs(v[cols]).max() > 1e-8:
                null_vars.add(name)
    assert null_vars <= {"p", "tau_u1", "tau_u2"} and "p" in null_vars


def determined_error(ts, js):
    """max |port - JAX| over the determined fields' coefficients,
    relative to their largest value (the state's relative error with
    the null pair left out)."""
    diff = scale = 0.0
    for tv, jv in zip(ts.variables, js.variables):
        if tv.name in DETERMINED:
            ref = np.array(jv["c"])
            diff = max(diff, np.abs(np.array(tv["c"]) - ref).max())
            scale = max(scale, np.abs(ref).max())
    return diff / scale


def test_convection_trajectory_matches_jax(convection32):
    """10 RK222 steps under each package's own CFL (cadence 10, so the
    first dt is read once): the CFL timestep equal, the determined fields
    to 1e-12 relative, the flow property Re finite, and the boundary
    conditions held."""
    js, jcfl, ts, tcfl, flow = convection32
    assert rel_err(ts.gather_fields().numpy(),
                   np.asarray(js.gather_fields())) <= 1e-13
    for _ in range(10):
        jdt, tdt = jcfl.compute_timestep(), tcfl.compute_timestep()
        assert tdt == jdt
        js.step(jdt)
        ts.step(tdt)
    assert determined_error(ts, js) <= RTOL
    # a CFL read from the stepped state (iteration 10: cadence hit)
    assert abs(tcfl.compute_timestep() - jcfl.compute_timestep()) \
        <= RTOL * jcfl.current_dt
    assert np.isfinite(flow.max("Re"))
    u, b = ts.variables[2], ts.variables[1]
    Ri, Ro = 0.5, 1.5
    assert np.abs(np.array(u(r=Ri).evaluate()["g"])).max() < 1e-10
    assert np.abs(np.array(u(r=Ro).evaluate()["g"])).max() < 1e-10
    assert np.abs(np.array(b(r=Ro).evaluate()["g"]) - 1).max() < 1e-10


def test_convection_step_from_carried_system():
    """tools/carry.py: the JAX solver's dense M, L and a mid-run state
    installed into a port solver; both step 5 more times at the
    example's max_dt (bound 1e-12 relative on the determined fields)."""
    js, _ = jax_annulus_convection(32, 16)
    ts, _, _ = tbench.build_annulus_convection(32, 16, device="cpu")
    dt = 0.125
    for _ in range(3):
        js.step(dt)
    matrices = {name: np.asarray(js._matrices[name]) for name in ("M", "L")}
    carry.install_system(ts, None, matrices, X=np.asarray(js.X))
    for _ in range(5):
        js.step(dt)
        ts.step(dt)
    assert determined_error(ts, js) <= RTOL


def test_pivot_floor_keeps_nonsingular_factors_bit_equal():
    """matsolvers.floor_pivots leaves the LU factors of nonsingular
    matrices (real and complex) bit for bit as torch computes them."""
    from dedalus_tpu_torch.libraries.matsolvers import floor_pivots
    rng = np.random.default_rng(7)
    for dtype in (np.float64, np.complex128):
        A = torch.as_tensor(random_data((6, 40, 40), dtype, 8))
        LU, _, _ = torch.linalg.lu_factor_ex(A)
        assert torch.equal(floor_pivots(LU), LU)


def test_singular_m0_pencil_steps_finite():
    """At dt = 0.05 the JAX package's 32x16 run is NaN after its first
    step (a pivot of ~1e-35 in the singular m = 0 pencil); the port's
    floored pivots keep the state finite over 20 steps, the boundary
    conditions within 1e-10, the pressure's null-space component bounded
    and the determined fields at the size of the 0.125 run's."""
    js, _ = jax_annulus_convection(32, 16)
    js.step(0.05)
    assert not np.isfinite(np.asarray(js.X)).all()
    ts, _, _ = tbench.build_annulus_convection(32, 16, device="cpu")
    for _ in range(20):
        ts.step(0.05)
    assert bool(torch.isfinite(ts.X).all())
    f = {v.name: v for v in ts.variables}
    assert np.abs(np.array(f["p"]["c"])).max() < 10
    assert np.abs(np.array(f["b"]["c"])).max() < 2
    assert np.abs(np.array(f["u"](r=0.5).evaluate()["g"])).max() < 1e-10
    assert np.abs(np.array(f["u"](r=1.5).evaluate()["g"])).max() < 1e-10
    assert np.abs(np.array(f["b"](r=1.5).evaluate()["g"]) - 1).max() < 1e-10
