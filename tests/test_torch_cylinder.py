"""
The cylinder in the port (dedalus_tpu_torch: DirectProduct coordinates,
Fourier x disk and Fourier x annulus, core/cylinder.py's grad, div, lap
and curl, cylinder NCCs, the DirectProduct CFL arm and the builders of
extras/bench_problems.py) held against the JAX package on the CPU, inputs
from numpy seeds or the closed forms of tests/test_cylinder.py:

  * DirectProduct: equality, hash, handedness, spin ordering and the
    coordinate -> spin maps equal the JAX package's;
  * scalar, vector and rank-2 transforms on test_cylinder.py's five
    parameter sets (disk/annulus, dealias 1 and 3/2, f64 and complex128):
    coefficients and the round trip to 1e-13 relative;
  * grad (scalar, vector), div (vector, tensor), curl and lap (scalar,
    vector): coefficients to 1e-12 relative, and the grid values against
    test_cylinder.py's closed forms at its bounds;
  * LHS NCCs varying in r (disk, annulus, a vector operand) or in z: the
    pencil matrices to 1e-14 (a disk NCC's after the first group to the
    JAX package's drift, JAX_NCC_DRIFT_RTOL), the solutions to 1e-12, and
    the NCC product equal to the RHS one (test_cylinder.py's 1e-9);
  * the Poisson LBVPs (disk; annulus, f64 and complex128), the heat IVP
    (50 RK443 steps: 1e-12 against the JAX package, 1e-6 against the
    exact decay), integrals and interpolation;
  * the pipe-flow IVP (bench_problems.build_pipe_flow) at 8x8x12: the
    pencils and M, L np.array_equal (on a real dtype off the m = 0 slots
    the JAX package gets wrong: the port keeps no slip for the
    axisymmetric swirl), the gauge row in the (kz, m) = (0, 0) group
    only, 20 RK222 steps with u to 1e-12 and p and the taus to
    PIPE_ALGEBRAIC_RTOL (the port's complex run against the JAX
    package's, the port's real run against that on the grid), also from
    the system carried from the JAX solver; the CFL's DirectProduct arm
    to 1e-13;
  * the pipe-flow EVP (examples/pipe_flow.py --quick): its 5 slowest
    modes to 1e-10; the path choice under a lowered BANDED_CUTOFF_BYTES and
    under forced 'banded'.
"""

import os

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
from dedalus_tpu.core import curvilinear as jcurv
from dedalus_tpu.extras import flow_tools as jflow
from dedalus_tpu.tools.config import config as jconfig
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.core import curvilinear as tcurv
from dedalus_tpu_torch.core.subsystems import _system_sizes
from dedalus_tpu_torch.extras import bench_problems as tbench
from dedalus_tpu_torch.extras import flow_tools as tflow
from dedalus_tpu_torch.tools import carry
from dedalus_tpu_torch.tools.config import config as tconfig

torch.set_num_threads(1)

RTOL = 1e-12
TRANSFORM_RTOL = 1e-13
MATRIX_RTOL = 1e-14
EIGEN_RTOL = 1e-10
CFL_RTOL = 1e-13

LENGTH = 1.88
RADIUS = 1.5
RADII = (0.5, 3.0)
KZ = 4 * np.pi / LENGTH


@pytest.fixture(scope="module", autouse=True)
def no_jax_assembly_cache():
    """The JAX package's assembly cache moves NCC fields through
    coefficient space while it fingerprints them (~5e-15 in the NCC
    blocks): off, so that the matrices compare bit for bit."""
    saved = os.environ.get("DEDALUS_TPU_ASSEMBLY_CACHE")
    os.environ["DEDALUS_TPU_ASSEMBLY_CACHE"] = ""
    yield
    if saved is None:
        os.environ.pop("DEDALUS_TPU_ASSEMBLY_CACHE", None)
    else:
        os.environ["DEDALUS_TPU_ASSEMBLY_CACHE"] = saved


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def build_cylinder(d3, Nz, Nphi, Nr, dealias, dtype, shape="disk"):
    """tests/test_cylinder.py's build_cylinder in package d3."""
    cz = d3.Coordinate("z")
    cp = d3.PolarCoordinates("phi", "r")
    c = d3.DirectProduct(cz, cp)
    dist = d3.Distributor(c, dtype=dtype, **dist_kw(d3))
    fourier = d3.ComplexFourier if np.dtype(dtype).kind == "c" \
        else d3.RealFourier
    bz = fourier(cz, size=Nz, bounds=(0, LENGTH), dealias=dealias)
    if shape == "disk":
        bp = d3.DiskBasis(cp, (Nphi, Nr), dtype=dtype, radius=RADIUS,
                          dealias=dealias)
    else:
        bp = d3.AnnulusBasis(cp, (Nphi, Nr), dtype=dtype, radii=RADII,
                             dealias=dealias)
    z, phi, r = (np.asarray(a) for a in dist.local_grids(bz, bp))
    x, y = r * np.cos(phi), r * np.sin(phi)
    return c, dist, (bz, bp), z, phi, r, x, y


PARAMS = [("disk", 1, np.float64), ("disk", 3 / 2, np.float64),
          ("disk", 1, np.complex128), ("annulus", 1, np.float64),
          ("annulus", 3 / 2, np.complex128)]
PARAM_IDS = [f"{s}-{d:g}-{np.dtype(t).name}" for s, d, t in PARAMS]


def polar_comps(fx, fy, phi):
    """Cartesian (fx, fy) -> cylinder (phi, r) components."""
    return (-fx * np.sin(phi) + fy * np.cos(phi),
            fx * np.cos(phi) + fy * np.sin(phi))


def stack(comps, shape):
    return np.stack([np.broadcast_to(c, shape) for c in comps])


# ------------------------------------------------------ DirectProduct

def test_direct_product_matches_jax():
    """Equality and hash by factors, the left-handed 3-D default (the
    curl's sign), spin ordering, the polar factor's component slice, and
    the coordinate -> spin maps of vectors and rank-2 tensors
    (np.array_equal with the JAX package's)."""
    products = {}
    for d3 in (jd3, td3):
        cz, cp = d3.Coordinate("z"), d3.PolarCoordinates("phi", "r")
        c = d3.DirectProduct(cz, cp)
        twin = d3.DirectProduct(d3.Coordinate("z"),
                                d3.PolarCoordinates("phi", "r"))
        assert c == twin and hash(c) == hash(twin)
        assert c != d3.DirectProduct(d3.Coordinate("x"), cp)
        assert c.right_handed is False and c.dim == 3 and c.curvilinear
        assert c.spin_ordering == (0, -1, 1)
        assert c.sub_slice(cp) == slice(1, 3) and c.curvilinear_sub() == cp
        assert d3.DirectProduct(d3.Coordinate("z"),
                                d3.Coordinate("y")).right_handed is True
        products[d3] = (c, cp)
    (jc, jcp), (tc, tcp) = products[jd3], products[td3]
    assert np.array_equal(tc.U_forward(), jc.U_forward(1))
    for rank in (1, 2):
        assert np.array_equal(
            tcurv.recombination_matrix((tc,) * rank, tcp),
            jcurv.recombination_matrix((jc,) * rank, jcp))
        assert np.array_equal(tcurv.component_spins((tc,) * rank, tcp),
                              jcurv.component_spins((jc,) * rank, jcp))
    with pytest.raises(ValueError, match="repeat"):
        td3.DirectProduct(td3.Coordinate("r"), td3.PolarCoordinates("phi",
                                                                    "r"))


# --------------------------------------------------------- transforms

@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("params", PARAMS, ids=PARAM_IDS)
def test_transforms_match_jax(params, rank):
    """grid -> coeff (the z FFT, the spin recombination of the polar
    block only, the radial stacks) and back, at the bases' dealias scale
    (bound 1e-13 relative)."""
    shape, dealias, dtype = params
    out = {}
    for d3 in (jd3, td3):
        c, dist, b, *_ = build_cylinder(d3, 8, 16, 8, dealias, dtype, shape)
        f = dist.Field(name="f", bases=b, tensorsig=(c,) * rank, dtype=dtype)
        f.change_scales(dealias)
        rng = np.random.default_rng(10 + rank)
        data = rng.standard_normal(f["g"].shape)
        if np.dtype(dtype).kind == "c":
            data = data + 1j * rng.standard_normal(data.shape)
        f["g"] = data
        coeffs = np.array(f["c"])
        f["c"] = coeffs
        out[d3] = (coeffs, np.array(f["g"]))
    for part in range(2):
        assert out[td3][part].shape == out[jd3][part].shape
        assert rel_err(out[td3][part], out[jd3][part]) <= TRANSFORM_RTOL


# ---------------------------------------------------------- calculus

def grad_scalar(d3, ctx):
    c, dist, b, z, phi, r, x, y, dtype = ctx
    f = dist.Field(bases=b, dtype=dtype)
    f["g"] = 3 * x ** 2 + 2 * y + np.sin(KZ * z) * x
    gphi, gr = polar_comps(6 * x + np.sin(KZ * z), 2 + 0 * x, phi)
    shape = np.broadcast_shapes(x.shape, z.shape)
    return d3.grad(f), stack((KZ * np.cos(KZ * z) * x, gphi, gr), shape), \
        1e-8


def grad_vector(d3, ctx):
    c, dist, b, z, phi, r, x, y, dtype = ctx
    f = dist.Field(bases=b, dtype=dtype)
    f["g"] = 3 * x ** 4 + 2 * y ** 3 + np.sin(KZ * z) * x * y
    s, cz_ = np.sin(KZ * z), np.cos(KZ * z)
    fxx, fyy, fxy = 36 * x ** 2, 12 * y + 0 * x, s + 0 * x
    fzz = -KZ ** 2 * s * x * y
    zphi, zr = polar_comps(KZ * cz_ * y, KZ * cz_ * x, phi)
    phix, rx = polar_comps(fxx, fxy, phi)
    phiy, ry = polar_comps(fxy, fyy, phi)
    pp, pr = polar_comps(phix, phiy, phi)
    rp, rr = polar_comps(rx, ry, phi)
    shape = np.broadcast_shapes(x.shape, z.shape)
    rows = [(fzz, zphi, zr), (zphi, pp, pr), (zr, rp, rr)]
    return d3.grad(d3.grad(f)), np.stack([stack(row, shape) for row in rows]), \
        1e-7


def div_vector(d3, ctx):
    c, dist, b, z, phi, r, x, y, dtype = ctx
    f = dist.Field(bases=b, dtype=dtype)
    f["g"] = 3 * x ** 2 + 2 * y ** 2 + np.sin(KZ * z) * x
    shape = np.broadcast_shapes(x.shape, z.shape)
    return d3.div(d3.grad(f)), np.broadcast_to(
        10 - KZ ** 2 * np.sin(KZ * z) * x + 0 * y, shape), 1e-8


def lap_grad_parts(x, y, z, phi):
    """grad(lap f) of f = x^4 + y^4 + sin(kz z) x y as (z, phi, r)."""
    s = np.sin(KZ * z)
    gphi, gr = polar_comps(24 * x - KZ ** 2 * s * y, 24 * y - KZ ** 2 * s * x,
                           phi)
    return (-KZ ** 3 * np.cos(KZ * z) * x * y, gphi, gr)


def div_tensor(d3, ctx):
    c, dist, b, z, phi, r, x, y, dtype = ctx
    f = dist.Field(bases=b, dtype=dtype)
    f["g"] = x ** 4 + y ** 4 + np.sin(KZ * z) * x * y
    shape = np.broadcast_shapes(x.shape, z.shape)
    return d3.div(d3.grad(d3.grad(f))), \
        stack(lap_grad_parts(x, y, z, phi), shape), 1e-7


def curl_vector(d3, ctx):
    c, dist, b, z, phi, r, x, y, dtype = ctx
    v = dist.VectorField(c, bases=b, dtype=dtype)
    shape = np.broadcast_shapes(x.shape, z.shape)
    vphi, vr = polar_comps(0 * x, 4 * x ** 3 + 3 * y ** 2, phi)
    v["g"] = stack((x * y * np.sin(KZ * z), vphi, vr), shape)
    s = np.sin(KZ * z)
    uphi, ur = polar_comps(x * s, -y * s, phi)
    return d3.curl(v), stack((12 * x ** 2 + 0 * y, uphi, ur), shape), 1e-8


def lap_scalar(d3, ctx):
    c, dist, b, z, phi, r, x, y, dtype = ctx
    f = dist.Field(bases=b, dtype=dtype)
    f["g"] = x ** 4 + 2 * y ** 4 + np.sin(KZ * z) * x
    shape = np.broadcast_shapes(x.shape, z.shape)
    return d3.lap(f), np.broadcast_to(
        12 * x ** 2 + 24 * y ** 2 - KZ ** 2 * np.sin(KZ * z) * x, shape), 1e-7


def lap_vector(d3, ctx):
    c, dist, b, z, phi, r, x, y, dtype = ctx
    f = dist.Field(bases=b, dtype=dtype)
    f["g"] = x ** 4 + y ** 4 + np.sin(KZ * z) * x * y
    shape = np.broadcast_shapes(x.shape, z.shape)
    return d3.lap(d3.grad(f)), stack(lap_grad_parts(x, y, z, phi), shape), \
        1e-7


# operator -> (case, Nr): test_cylinder.py's closed forms and sizes
CALCULUS = {"grad_scalar": (grad_scalar, 8), "grad_vector": (grad_vector, 10),
            "div_vector": (div_vector, 8), "div_tensor": (div_tensor, 10),
            "curl": (curl_vector, 8), "lap_scalar": (lap_scalar, 8),
            "lap_vector": (lap_vector, 10)}


@pytest.mark.parametrize("params", PARAMS, ids=PARAM_IDS)
@pytest.mark.parametrize("op", list(CALCULUS))
def test_calculus_matches_jax_and_closed_form(op, params):
    """The operator's coefficients equal the JAX package's to 1e-12
    relative (component order, spin signs, the curl's handedness), and
    its grid values the closed form at test_cylinder.py's bound."""
    shape, dealias, dtype = params
    case, Nr = CALCULUS[op]
    out = {}
    for d3 in (jd3, td3):
        ctx = build_cylinder(d3, 8, 16, Nr, dealias, dtype, shape) + (dtype,)
        expr, expected, tol = case(d3, ctx)
        h = expr.evaluate()
        h.change_scales(1)
        out[d3] = np.array(h["c"])
        if d3 is td3:
            got = np.array(h["g"])
            assert np.abs(got - np.broadcast_to(expected, got.shape)).max() \
                < tol
    assert out[td3].shape == out[jd3].shape
    assert rel_err(out[td3], out[jd3]) <= RTOL


@pytest.mark.parametrize("params", [PARAMS[1], PARAMS[4]],
                         ids=[PARAM_IDS[1], PARAM_IDS[4]])
@pytest.mark.parametrize("op", ["grad", "grad_grad", "div_grad_grad",
                                "curl", "lap_vector"])
def test_calculus_random_inputs_match_jax(op, params):
    """The operators on seeded random data, every (kz, m) mode populated
    (bound 1e-12 relative)."""
    shape, dealias, dtype = params
    out = {}
    for d3 in (jd3, td3):
        c, dist, b, *_ = build_cylinder(d3, 8, 12, 10, dealias, dtype, shape)
        rank = 1 if op == "curl" else 0
        f = dist.Field(name="f", bases=b, tensorsig=(c,) * rank, dtype=dtype)
        rng = np.random.default_rng(77)
        data = rng.standard_normal(f["c"].shape)
        if np.dtype(dtype).kind == "c":
            data = data + 1j * rng.standard_normal(data.shape)
        f["c"] = data
        f["g"] = np.array(f["g"])   # project onto the valid modes
        expr = {"grad": lambda: d3.grad(f),
                "grad_grad": lambda: d3.grad(d3.grad(f)),
                "div_grad_grad": lambda: d3.div(d3.grad(d3.grad(f))),
                "curl": lambda: d3.curl(f),
                "lap_vector": lambda: d3.lap(d3.grad(f))}[op]()
        out[d3] = np.array(expr.evaluate()["c"])
    assert rel_err(out[td3], out[jd3]) <= RTOL


# --------------------------------------------------------------- NCCs

def ncc_problem(d3, kind):
    """tests/test_cylinder.py:193 and :214 (a radial NCC on the disk or
    annulus, a vector operand) and an NCC varying along z (the Fourier
    axis, coupled by the layout): ncc*u = ncc*v. Returns (solver, u, v,
    the NCC's coefficients before the build, the NCC field)."""
    shape = "annulus" if kind == "annulus" else "disk"
    Nr = 24 if kind == "annulus" else 12
    c, dist, b, z, phi, r, x, y = build_cylinder(d3, 8, 8, Nr, 1,
                                                 np.float64, shape)
    if kind == "axial":
        ncc = dist.Field(name="ncc", bases=b[0])
        ncc["g"] = 2 + np.cos(2 * np.pi * z / LENGTH)
    else:
        ncc = dist.Field(name="ncc", bases=b[1])
        ncc["g"] = {"disk": r ** 2, "annulus": r ** 2 + 1 / r,
                    "vector": 1 + r ** 2}[kind] + 0 * phi
    before = np.array(ncc["c"])
    if kind == "vector":
        u = dist.VectorField(c, name="u", bases=b)
        v = dist.VectorField(c, name="v", bases=b)
        shape3 = np.broadcast_shapes(x.shape, z.shape)
        vphi, vr = polar_comps(3 * x ** 2 + y, x + 2 * y, phi)
        v["g"] = stack((x * y * np.sin(KZ * z), vphi, vr), shape3)
    else:
        u = dist.Field(name="u", bases=b)
        v = dist.Field(name="v", bases=b)
        v["g"] = (x * y + 3 * y + r) * (1 + 0.5 * np.sin(KZ * z))
    problem = d3.LBVP([u], namespace={"ncc": ncc, "u": u, "v": v})
    problem.add_equation("ncc*u = ncc*v")
    solver = problem.build_solver()
    solver.solve()
    return solver, u, v, before, ncc


# The JAX package's _disk_ncc_matrix reads a disk NCC field at scale 2 and
# back once per group, round-tripping the user's field through coefficient
# space: its data drifts by ~1e-13 relative a group (measured 1.7e-13 a
# call at 8x8x12), and the matrix of group g with it (1.5e-13 relative in
# the last of 16 groups). The port reads a scratch copy, so its matrices do
# not depend on the group order; they agree with the JAX package's first
# group to MATRIX_RTOL (measured 1.2e-16; 7.4e-15 for the vector
# operand) and with its later groups to this bound (measured 1.4e-13).
JAX_NCC_DRIFT_RTOL = 5e-13


@pytest.mark.parametrize("kind", ["disk", "annulus", "vector", "axial"])
def test_ncc_lhs_matches_jax(kind):
    """The pencil matrices of the NCC product (on the rows and columns
    valid in both packages): the first group to 1e-14
    relative of the JAX package's, every group to 1e-14 (annulus, axial)
    or the JAX package's drift bound (disk NCCs); the pencil shape equal
    (the axial NCC couples the z groups); the solution to 1e-12; u = v to
    test_cylinder.py's 1e-9; the port's NCC coefficients unchanged by the
    build to 1e-14, whatever the group count (measured 3.8e-15 at 16, 32
    and 64 groups; the JAX package's move 1.0e-13 in 16)."""
    (js, ju, _, _, _) = ncc_problem(jd3, kind)
    (ts, tu, tv, before, ncc) = ncc_problem(td3, kind)
    assert tuple(ts.pencil_shape) == tuple(js.pencil_shape)
    tL, jL = np.asarray(ts._matrices["L"]), np.asarray(js._matrices["L"])
    scale = np.abs(jL).max()
    # the vector operand's z component drops its m = 0 minus-sin slot in
    # the port (a null mode; test_pipe_flow_pencils_match_jax): compare
    # on the rows and columns valid in both
    rows = np.asarray(ts.valid_row_mask).astype(bool) \
        & np.asarray(js.valid_row_mask).astype(bool)
    cols = col_masks(ts) & col_masks(js)
    if kind != "vector":
        assert rows.all() or np.array_equal(ts.valid_row_mask,
                                            np.asarray(js.valid_row_mask))
    tL = np.where(rows[:, :, None] & cols[:, None, :], tL, 0)
    jL = np.where(rows[:, :, None] & cols[:, None, :], jL, 0)
    assert np.abs(tL[0] - jL[0]).max() <= MATRIX_RTOL * scale
    bound = JAX_NCC_DRIFT_RTOL if kind in ("disk", "vector") else MATRIX_RTOL
    assert np.abs(tL - jL).max() <= bound * scale
    assert rel_err(np.array(ncc["c"]), before) <= MATRIX_RTOL
    assert rel_err(np.array(tu["c"]), np.asarray(ju["c"])) <= RTOL
    tu.change_scales(1)
    tv.change_scales(1)
    assert np.abs(np.array(tu["g"]) - np.array(tv["g"])).max() < 1e-9


def wall_values(d3, dtype):
    """u(r=R) on the grid for a polynomial cylinder vector, and its closed
    form."""
    c, dist, b, z, phi, r, x, y = build_cylinder(d3, 8, 8, 12, 1, dtype)
    u = dist.VectorField(c, name="u", bases=b)
    shape = np.broadcast_shapes(x.shape, z.shape)
    uphi, ur = polar_comps(y + 0.5, x ** 2 - 0.3 * y, phi)
    u["g"] = stack((np.sin(KZ * z) * x, uphi, ur), shape)
    xr, yr = RADIUS * np.cos(phi), RADIUS * np.sin(phi)
    ephi, er = polar_comps(yr + 0.5, xr ** 2 - 0.3 * yr, phi)
    exact = np.stack([np.broadcast_to(a, (8, 8, 1)) for a in (
        np.sin(KZ * z) * xr, ephi, er)])
    return np.array(u(r=RADIUS).evaluate()["g"]), exact


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_wall_interpolation_grid_values(dtype):
    """A cylinder vector interpolated to the wall holds its (z, phi, r)
    components on the circle's grid: the port's circle basis rotates the
    polar factor of the DirectProduct index (to 1e-12 of the closed form,
    measured 1.1e-13); the JAX package's does not, so its grid values
    are off by O(1) (measured 3.6 and 2.5)."""
    got, exact = wall_values(td3, dtype)
    assert np.abs(got - exact).max() <= RTOL * np.abs(exact).max()
    jgot, _ = wall_values(jd3, dtype)
    assert np.abs(jgot - exact).max() > 0.1


# ----------------------------------------------------------- problems

def disk_poisson(d3):
    """tests/test_cylinder.py:236 test_poisson_lbvp: returns (u, exact)."""
    c, dist, b, z, phi, r, x, y = build_cylinder(d3, 8, 8, 16, 1, np.float64)
    bz, bp = b
    R = RADIUS
    u = dist.Field(name="u", bases=b)
    tau = dist.Field(name="tau", bases=(bz, bp.edge))
    f = dist.Field(name="f", bases=b)
    s = np.sin(KZ * z)
    f["g"] = (-6 * x - 2 * x - KZ ** 2 * (R ** 2 - r ** 2) * x) * s
    lift = lambda A: d3.Lift(A, bp.derivative_basis(2), -1)  # noqa: E731
    problem = d3.LBVP([u, tau], namespace=locals())
    problem.add_equation("lap(u) + lift(tau) = f")
    problem.add_equation("u(r=1.5) = 0")
    problem.build_solver().solve()
    return u, (R ** 2 - r ** 2) * x * s


def annulus_poisson_jax(dtype):
    """bench_problems.build_annulus_cylinder_poisson in the JAX
    package."""
    d3 = jd3
    Ri, Ro = RADII
    cz, cp = d3.Coordinate("z"), d3.PolarCoordinates("phi", "r")
    coords = d3.DirectProduct(cz, cp)
    dist = d3.Distributor(coords, dtype=dtype)
    bz = (d3.ComplexFourier if np.dtype(dtype).kind == "c"
          else d3.RealFourier)(cz, size=8, bounds=(0, LENGTH))
    annulus = d3.AnnulusBasis(cp, (16, 16), dtype=dtype, radii=RADII)
    z, phi, r = (np.asarray(a) for a in dist.local_grids(bz, annulus))
    x, y = r * np.cos(phi), r * np.sin(phi)
    u_exact = dist.Field(name="u_exact", bases=(bz, annulus))
    u_exact["g"] = (r ** 2 - Ri ** 2) * (Ro ** 2 - r ** 2) \
        * (1 + x + y * np.cos(2 * np.pi * z / LENGTH))
    f = d3.lap(u_exact).evaluate()
    u = dist.Field(name="u", bases=(bz, annulus))
    tau1 = dist.Field(name="tau1", bases=(bz, annulus.outer_edge))
    tau2 = dist.Field(name="tau2", bases=(bz, annulus.outer_edge))
    lift_basis = annulus.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)  # noqa: E731
    problem = d3.LBVP([u, tau1, tau2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau1, -1) + lift(tau2, -2) = f")
    problem.add_equation(f"u(r={Ri}) = 0")
    problem.add_equation(f"u(r={Ro}) = 0")
    problem.build_solver().solve()
    return u


@pytest.mark.parametrize("case", ["disk", "annulus-f64", "annulus-c128"])
def test_poisson_lbvps_match_jax(case):
    """The disk Poisson of test_cylinder.py and the annulus-cylinder
    Poisson of build_annulus_cylinder_poisson: the solution to 1e-12 of
    the JAX package's and 1e-10 of the exact one."""
    if case == "disk":
        (ju, _), (tu, exact) = disk_poisson(jd3), disk_poisson(td3)
    else:
        dtype = np.complex128 if case.endswith("c128") else np.float64
        ju = annulus_poisson_jax(dtype)
        tu, tu_exact = tbench.build_annulus_cylinder_poisson(dtype=dtype,
                                                             device="cpu")
        exact = np.array(tu_exact["g"])
    assert rel_err(np.array(tu["c"]), np.asarray(ju["c"])) <= RTOL
    tu.change_scales(1)
    assert np.abs(np.array(tu["g"]) - exact).max() \
        <= 1e-10 * max(1.0, np.abs(exact).max())


def heat_ivp(d3):
    """tests/test_cylinder.py:258 test_heat_ivp_decay: returns (solver, u,
    u0, rate)."""
    from scipy.special import j0, jn_zeros
    c, dist, b, z, phi, r, x, y = build_cylinder(d3, 8, 8, 32, 1, np.float64)
    bz, bp = b
    u = dist.Field(name="u", bases=b)
    tau = dist.Field(name="tau", bases=(bz, bp.edge))
    lift = lambda A: d3.Lift(A, bp, -1)  # noqa: E731
    problem = d3.IVP([u, tau], namespace=locals())
    problem.add_equation("dt(u) - lap(u) + lift(tau) = 0")
    problem.add_equation("u(r=1.5) = 0")
    solver = problem.build_solver(d3.RK443)
    j01 = jn_zeros(0, 1)[0]
    u["g"] = j0(j01 * r / RADIUS) * np.cos(KZ * z) + 0 * phi
    u0 = np.array(u["g"]).copy()
    return solver, u, u0, KZ ** 2 + (j01 / RADIUS) ** 2


def test_heat_ivp_matches_jax_and_exact_decay():
    """50 RK443 steps at dt 2e-4: the state to 1e-12 of the JAX
    package's, u to 1e-6 of the exact Fourier-Bessel decay."""
    js, _, _, _ = heat_ivp(jd3)
    ts, tu, u0, rate = heat_ivp(td3)
    for _ in range(50):
        js.step(2e-4)
        ts.step(2e-4)
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL
    expected = u0 * np.exp(-rate * 50 * 2e-4)
    assert np.abs(np.array(tu["g"]) - expected).max() \
        < 1e-6 * np.abs(u0).max()


def test_cylinder_diffusion_builder_exact_decay():
    """bench_problems.build_cylinder_diffusion at examples/
    cylinder_diffusion.py's size (16x16x32, 200 RK443 steps at 2e-4):
    the exact decay to the example's 1e-6."""
    solver, dt, decay_error = tbench.build_cylinder_diffusion(device="cpu")
    for _ in range(200):
        solver.step(dt)
    assert abs(solver.sim_time - 0.04) < 1e-12
    assert decay_error() < 1e-6


def integrals(d3):
    c, dist, b, z, phi, r, x, y = build_cylinder(d3, 8, 8, 16, 1, np.float64)
    f = dist.Field(name="f", bases=b)
    f["g"] = (1 + np.cos(2 * np.pi * z / LENGTH)) * (RADIUS ** 2 - r ** 2) \
        * (1 + 0.2 * x * y)
    out = {"volume": d3.Integrate(f, c),
           "nested": d3.Integrate(d3.Integrate(f, c.coordsystems[0]),
                                  c.coordsystems[1]),
           "z0.5": d3.Interpolate(f, c["z"], 0.5),
           "r1.2": d3.Interpolate(f, c.coordsystems[1]["r"], 1.2)}
    return {k: np.array(v.evaluate()["g"]) for k, v in out.items()}, \
        (z, phi, r, x, y)


def test_integrals_and_interpolation_match_jax():
    """Integrate over the product and factor by factor, interpolation
    along z and along r: to 1e-12 of the JAX package's, and the closed
    forms (volume integral length pi R^4 / 2)."""
    jout, _ = integrals(jd3)
    tout, (z, phi, r, x, y) = integrals(td3)
    for key in tout:
        assert tout[key].shape == jout[key].shape, key
        assert rel_err(tout[key], jout[key]) <= RTOL, key
    exact = LENGTH * np.pi * RADIUS ** 4 / 2
    assert abs(tout["volume"].ravel()[0] - exact) <= 1e-13 * exact
    assert abs(tout["nested"].ravel()[0] - exact) <= 1e-13 * exact
    expect = (1 + np.cos(2 * np.pi * 0.5 / LENGTH)) \
        * (RADIUS ** 2 - r ** 2) * (1 + 0.2 * x * y)
    assert np.abs(tout["z0.5"][0] - expect).max() < 1e-12
    expect = (1 + np.cos(2 * np.pi * z / LENGTH)) * (RADIUS ** 2 - 1.2 ** 2) \
        * (1 + 0.2 * 1.2 ** 2 * np.cos(phi) * np.sin(phi))
    assert np.abs(tout["r1.2"][..., 0] - expect[..., 0]).max() < 1e-12


# -------------------------------------------------- pipe flow 8x8x12

PIPE = dict(Re=100.0, radius=RADIUS, length=LENGTH, amplitude=0.1, seed=3)
PIPE_DT = 2e-3

# p and the taus carry no time derivative: each step solves for them
# afresh, on pencils whose condition (numpy.linalg.cond of M + dt L)
# reaches 2.2e8 at 8x8x12. The two packages' LU round-off may differ by
# cond * eps there; measured 9.9e-14 (p) and 3.7e-14 (tau_u) after 20
# steps, 3.1e-13 (tau_u) from the carried system. u stays at 1e-12.
PIPE_ALGEBRAIC_RTOL = 1e-10


def jax_pipe_flow(Nz, Nphi, Nr, Re, radius, length, amplitude, seed,
                  dtype=np.float64):
    """bench_problems.build_pipe_flow in the JAX package (the equations of
    tests/test_cylinder.py:305 with nu = 1/Re, the laminar profile plus
    bench_problems.pipe_perturbation, a numpy function)."""
    d3 = jd3
    nu = 1 / Re
    cz, cp = d3.Coordinate("z"), d3.PolarCoordinates("phi", "r")
    coords = d3.DirectProduct(cz, cp)
    dist = d3.Distributor(coords, dtype=dtype)
    fourier = d3.ComplexFourier if np.dtype(dtype).kind == "c" \
        else d3.RealFourier
    bz = fourier(cz, size=Nz, bounds=(0, length), dealias=3 / 2)
    disk = d3.DiskBasis(cp, (Nphi, Nr), dtype=dtype, radius=radius,
                        dealias=3 / 2)
    u = dist.VectorField(coords, name="u", bases=(bz, disk))
    p = dist.Field(name="p", bases=(bz, disk))
    tau_u = dist.VectorField(coords, name="tau_u", bases=(bz, disk.edge))
    tau_p = dist.Field(name="tau_p")
    Fz = dist.VectorField(coords, name="Fz")
    Fz["g"] = np.array([4 * nu / radius ** 2, 0, 0]).reshape((3, 1, 1, 1))
    lift = lambda A: d3.Lift(A, disk, -1)  # noqa: E731
    problem = d3.IVP([u, p, tau_u, tau_p], namespace=locals())
    problem.add_equation(
        "dt(u) - nu*lap(u) + grad(p) + lift(tau_u) = - u@grad(u) + Fz")
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation(f"u(r={radius}) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(d3.RK222)
    z, phi, r = dist.local_grids(bz, disk)
    ug = tbench.pipe_perturbation(z, phi, r, radius, length, amplitude, seed)
    ug[0] += 1 - (np.asarray(r) / radius) ** 2
    u["g"] = ug
    return solver


def col_masks(solver):
    """(G, S) bool mask of the valid state columns."""
    return np.concatenate([np.asarray(solver.layout.valid_masks_all(
        v.domain, v.tensorsig)) for v in solver.variables], axis=1) \
        .astype(bool)


def var_of_column(solver):
    """The variable name of each state column."""
    names = []
    for v in solver.variables:
        width = np.asarray(solver.layout.valid_masks_all(
            v.domain, v.tensorsig)).shape[1]
        names += [v.name] * width
    return np.array(names)


@pytest.fixture(scope="module")
def pipe8():
    """The 8x8x12 pipe: the JAX package's complex-dtype run and the
    port's real- and complex-dtype runs, built from one real state."""
    return {"jax_c128": jax_pipe_flow(8, 8, 12, **PIPE, dtype=np.complex128),
            "port_f64": tbench.build_pipe_flow(8, 8, 12, device="cpu",
                                               **PIPE)[0],
            "port_c128": tbench.build_pipe_flow(8, 8, 12, dtype=np.complex128,
                                                device="cpu", **PIPE)[0]}


def state_errors(ts, js):
    """{name: max |port - JAX| / max |JAX state|} per variable."""
    scale = np.abs(np.asarray(js.X)).max()
    return {tv.name: np.abs(np.array(tv["c"]) - np.asarray(jv["c"])).max()
            / scale for tv, jv in zip(ts.variables, js.variables)}


def assert_pipe_matches(ts, js):
    errors = state_errors(ts, js)
    assert errors["u"] <= RTOL, errors
    assert max(errors.values()) <= PIPE_ALGEBRAIC_RTOL, errors


def test_pipe_flow_pencils_match_jax():
    """Real dtype: the dense path, G = (Nz/2)(Nphi/2) (kz, m) groups in the
    JAX package's order (kz outer), S = 16 Nr + 16, the gauge row
    integ(p) = 0 valid in the (kz, m) = (0, 0) group only, and M, L
    np.array_equal with the JAX package's on the rows and columns valid
    in both. The masks differ in the m = 0 groups only: the port drops
    the minus-sin slot of u's z component (a null mode: zero on the grid)
    and keeps the edge's spin slots that carry the axisymmetric swirl, so
    that u(r=R) = 0 holds for it (the JAX package's circle basis misses
    the cylinder's polar factor and drops them). Complex dtype: the masks
    and M, L np.array_equal."""
    js = jax_pipe_flow(8, 8, 12, **PIPE)
    ts, _ = tbench.build_pipe_flow(8, 8, 12, device="cpu", **PIPE)
    assert ts.ops.kind == js.ops.kind == "dense"
    assert tuple(ts.pencil_shape) == tuple(js.pencil_shape) == (16, 208)
    groups = list(ts.subproblems_by_group)
    assert groups == list(js.subproblems_by_group)
    assert groups == [(kz, m, None) for kz in range(4) for m in range(4)]
    tr = np.asarray(ts.valid_row_mask).astype(bool)
    jr = np.asarray(js.valid_row_mask).astype(bool)
    tc, jc = col_masks(ts), col_masks(js)
    m0 = np.array([g[1] == 0 for g in groups])
    assert (tr == jr)[~m0].all() and (tc == jc)[~m0].all()
    names = var_of_column(ts)
    assert set(names[(jc & ~tc).any(axis=0)]) == {"u"}
    assert set(names[(tc & ~jc).any(axis=0)]) == {"tau_u"}
    rows, cols = tr & jr, tc & jc
    for name in ("M", "L"):
        tm, jm = np.asarray(ts._matrices[name]), np.asarray(js._matrices[name])
        for g in range(len(groups)):
            assert np.array_equal(tm[g][np.ix_(rows[g], cols[g])],
                                  jm[g][np.ix_(rows[g], cols[g])]), (name, g)
    _, eq_sizes, _ = _system_sizes(ts.layout, ts.equations, ts.variables)
    gauge_rows = tr[:, sum(eq_sizes[:-1]):]
    assert gauge_rows[0].sum() == 1 and not gauge_rows[1:].any()
    jcx = jax_pipe_flow(8, 8, 12, **PIPE, dtype=np.complex128)
    tcx, _ = tbench.build_pipe_flow(8, 8, 12, dtype=np.complex128,
                                    device="cpu", **PIPE)
    assert np.array_equal(tcx.valid_row_mask, np.asarray(jcx.valid_row_mask))
    for name in ("M", "L"):
        assert np.array_equal(np.asarray(tcx._matrices[name]),
                              np.asarray(jcx._matrices[name])), name


def pipe_checks(solver, d3):
    """test_cylinder.py:305's checks: no slip, div(u) + tau_p, the gauge,
    and the axial flow; returns their values."""
    u, p, tau_u, tau_p = solver.variables
    cp = u.tensorsig[0].coordsystems[1]
    R = u.domain.bases[1].radius
    ez = u.tensorsig[0].unit_vector_fields(u.dist)[0]
    return {"wall": np.abs(np.array(d3.Interpolate(u, cp["r"], R)
                                    .evaluate()["g"])).max(),
            "div": np.abs(np.array((d3.div(u) + tau_p)
                                   .evaluate()["g"])).max(),
            "gauge": abs(complex(np.array(d3.Integrate(p, u.tensorsig[0])
                                          .evaluate()["g"]).ravel()[0])),
            "axial": complex(np.array(d3.Integrate(u @ ez, u.tensorsig[0])
                                      .evaluate()["g"]).ravel()[0]).real}


def test_pipe_flow_trajectory_matches_jax(pipe8):
    """20 RK222 steps of the nonlinear pipe flow at dt 2e-3 from one real
    state: the port's complex run against the JAX package's (u to 1e-12
    of the state, p and the taus to PIPE_ALGEBRAIC_RTOL), the port's real
    run's grid velocity against the JAX complex run's (1e-12 of max|u|);
    no slip, div(u) + tau_p and the gauge within 1e-10 in each
    (test_cylinder.py's bars), the axial flux equal to the JAX package's
    to 1e-12."""
    js, tr, tc = pipe8["jax_c128"], pipe8["port_f64"], pipe8["port_c128"]
    assert rel_err(tc.gather_fields().numpy(),
                   np.asarray(js.gather_fields())) <= 1e-15
    for _ in range(20):
        for solver in (js, tr, tc):
            solver.step(PIPE_DT)
    assert_pipe_matches(tc, js)
    # on the dealias grid, which holds every mode: the tau lift fills the
    # last radial mode, which the scale-1 grid drops (in both packages)
    ju, tu = js.variables[0], tr.variables[0]
    for f in (ju, tu):
        f.change_scales(3 / 2)
    jg = np.asarray(ju["g"])
    assert np.abs(np.array(tu["g"]) - jg).max() <= RTOL * np.abs(jg).max()
    assert np.abs(jg.imag).max() <= RTOL * np.abs(jg).max()
    jcheck = pipe_checks(js, jd3)
    for solver in (tr, tc):
        check = pipe_checks(solver, td3)
        for key in ("wall", "div", "gauge"):
            assert check[key] < 1e-10, check
        assert check["axial"] > 0
        assert abs(check["axial"] - jcheck["axial"]) \
            <= RTOL * jcheck["axial"]


def test_jax_real_cylinder_leaves_m0_swirl_unbounded(pipe8):
    """The fault the port repairs: the JAX package's real-dtype run of the
    same pipe drops the no-slip rows of the axisymmetric swirl (its
    circle basis treats the cylinder vector as unrotated), so after 20
    steps its u_phi at m = 0 is far from 0 at the wall, which the port
    evaluates from the JAX coefficients; the port's real run holds no
    slip to 1e-10 (test_pipe_flow_trajectory_matches_jax)."""
    jr = jax_pipe_flow(8, 8, 12, **PIPE)
    for _ in range(20):
        jr.step(PIPE_DT)
    tr = pipe8["port_f64"]
    u = tr.variables[0]
    probe = tr.dist.VectorField(u.tensorsig[0], name="probe",
                                bases=u.domain.bases[:2])
    probe["c"] = np.asarray(jr.variables[0]["c"])
    wall = np.array(probe(r=RADIUS).evaluate()["g"])
    scale = np.abs(np.asarray(jr.variables[0]["g"])).max()
    assert np.abs(wall).max() > 1e-6 * scale


def test_pipe_flow_step_from_carried_system():
    """tools/carry.py: the JAX solver's dense M, L (complex dtype: the
    (kz, m) group order, the (z, spin-, spin+) components) and its
    initial state installed into a port solver; 20 RK222 steps of both
    (u to 1e-12, p and the taus to PIPE_ALGEBRAIC_RTOL)."""
    js = jax_pipe_flow(8, 8, 12, **PIPE, dtype=np.complex128)
    ts, _ = tbench.build_pipe_flow(8, 8, 12, dtype=np.complex128,
                                   device="cpu", **PIPE)
    matrices = {name: np.asarray(js._matrices[name]) for name in ("M", "L")}
    carry.install_system(ts, None, matrices, X=np.asarray(js.gather_fields()))
    for _ in range(20):
        js.step(PIPE_DT)
        ts.step(PIPE_DT)
    assert_pipe_matches(ts, js)


def test_real_pipe_flow_carry_raises():
    """tools/carry.py refuses the JAX package's real-dtype pipe system: its
    m = 0 groups keep u_z's minus-sin slot and drop the edge's spin slots,
    where the port does the opposite (test_pipe_flow_pencils_match_jax),
    so the carried invalid slots are not the solver's."""
    js = jax_pipe_flow(8, 8, 12, **PIPE)
    ts, _ = tbench.build_pipe_flow(8, 8, 12, device="cpu", **PIPE)
    matrices = {name: np.asarray(js._matrices[name]) for name in ("M", "L")}
    with pytest.raises(ValueError, match=r"differ from this solver's in 4 "
                       r"of 16 pencil groups \(first: group 0\)"):
        carry.install_system(ts, None, matrices)


@pytest.mark.parametrize("shape", ["disk", "annulus"])
def test_cfl_direct_product_arm_matches_jax(shape):
    """The CFL frequencies of a cylinder velocity (interval spacing on z,
    the polar spacings on the (phi, r) slice) on the dealias grid, to
    1e-13 relative of the JAX package's, and the CFL's maximum."""
    freqs = {}
    for d3, flow in ((jd3, jflow), (td3, tflow)):
        c, dist, b, z, phi, r, x, y = build_cylinder(d3, 8, 8, 12, 3 / 2,
                                                     np.float64, shape)
        u = dist.VectorField(c, name="u", bases=b)
        shape3 = np.broadcast_shapes(x.shape, z.shape)
        u["g"] = tbench.pipe_perturbation(z, phi, r, 3.0, LENGTH, 1.0, 5) \
            + stack((1 + 0 * r, 0 * r, 0 * r), shape3)
        u.change_scales(3 / 2)
        ug = np.asarray(u["g"]) if d3 is jd3 else u.require_grid_space()
        total = flow.advective_cfl_frequency(u, ug)
        freqs[d3] = np.asarray(total)
    assert freqs[td3].shape == freqs[jd3].shape
    assert rel_err(freqs[td3], freqs[jd3]) <= CFL_RTOL


def test_pipe_flow_cfl_matches_jax():
    """The pipe's CFL (safety 0.4, max_dt 5e-3) computes the JAX CFL's
    maximum frequency (1e-13) on the same state."""
    js = jax_pipe_flow(8, 8, 12, **PIPE)
    ts, cfl = tbench.build_pipe_flow(8, 8, 12, device="cpu", **PIPE)
    jcfl = jd3.CFL(js, initial_dt=5e-3, max_dt=5e-3, safety=0.4, cadence=10)
    jcfl.add_velocity(js.variables[0])
    jf, tf = jcfl.compute_max_frequency(), cfl.compute_max_frequency()
    assert abs(tf - jf) <= CFL_RTOL * jf


# ------------------------------------------------------- path choice

def set_cutoff(value):
    saved = [c["linear algebra"].get("BANDED_CUTOFF_BYTES")
             for c in (jconfig, tconfig)]
    for c in (jconfig, tconfig):
        c["linear algebra"]["BANDED_CUTOFF_BYTES"] = value
    return saved


def restore_cutoff(saved):
    for c, value in zip((jconfig, tconfig), saved):
        if value is None:
            c["linear algebra"].pop("BANDED_CUTOFF_BYTES", None)
        else:
            c["linear algebra"]["BANDED_CUTOFF_BYTES"] = value


def test_path_choice_matches_jax():
    """With BANDED_CUTOFF_BYTES below the pipe's dense store, 'auto' tries
    the banded path in both packages, both refuse it for the same reason
    (the band is too wide; complex dtype, where the two packages assemble
    the same pencils) and take the dense one; the port's real pipe is
    refused for the same kind of reason."""
    saved = set_cutoff("1000")
    try:
        js = jax_pipe_flow(8, 8, 12, **PIPE, dtype=np.complex128)
        ts, _ = tbench.build_pipe_flow(8, 8, 12, dtype=np.complex128,
                                       device="cpu", **PIPE)
        tr, _ = tbench.build_pipe_flow(8, 8, 12, device="cpu", **PIPE)
    finally:
        restore_cutoff(saved)
    assert ts.ops.kind == js.ops.kind == tr.ops.kind == "dense"
    assert ts._banded_reason == js._banded_reason
    for solver in (ts, tr):
        assert solver._banded_reason.startswith("band too wide")
        assert "refused_banded" in solver.build_seconds


def jax_forced_banded(Nr):
    """The complex jax_pipe_flow(8, 8, Nr) under MATRIX_SOLVER = banded:
    the solver, or the ValueError it raises."""
    saved = jconfig["linear algebra"].get("MATRIX_SOLVER")
    jconfig["linear algebra"]["MATRIX_SOLVER"] = "banded"
    try:
        return jax_pipe_flow(8, 8, Nr, **PIPE, dtype=np.complex128)
    except ValueError as exc:
        return exc
    finally:
        if saved is None:
            jconfig["linear algebra"].pop("MATRIX_SOLVER", None)
        else:
            jconfig["linear algebra"]["MATRIX_SOLVER"] = saved


@pytest.mark.parametrize("Nr", [12, 48])
def test_forced_banded_matches_jax(Nr):
    """Forced 'banded' (the uneconomic band allowed, as in the JAX
    package; complex dtype): at Nr = 12 both take it with the same q, NB,
    kl, ku and pins; at Nr = 48 (the card's radial size) both raise the
    same message, the band being too wide."""
    js = jax_forced_banded(Nr)
    kw = dict(matsolver="banded", dtype=np.complex128, device="cpu", **PIPE)
    if Nr == 12:
        ts, _ = tbench.build_pipe_flow(8, 8, Nr, **kw)
        assert ts.ops.kind == js.ops.kind == "banded"
        for key in ("q", "NB", "kl", "ku"):
            assert getattr(ts.structure, key) == getattr(js.structure, key)
        assert np.array_equal(ts.structure.pinned_positions,
                              np.asarray(js.structure.pinned_positions))
        return
    with pytest.raises(ValueError) as terr:
        tbench.build_pipe_flow(8, 8, Nr, **kw)
    assert isinstance(js, ValueError)
    assert str(terr.value) == str(js)
    assert "band too wide" in str(js)


# --------------------------------------------------- pipe-flow EVP

def jax_pipe_flow_evp(Nr, Re=1e4, kz=1, m=1):
    """examples/pipe_flow.py's problem in the JAX package."""
    d3 = jd3
    dtype = np.complex128
    coords = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(coords, dtype=dtype)
    disk = d3.DiskBasis(coords, shape=(2 * max(m, 4) + 2, Nr), radius=1,
                        dtype=dtype)
    phi, r = dist.local_grids(disk)
    s = dist.Field(name="s")
    u = dist.VectorField(coords, name="u", bases=disk)
    w = dist.Field(name="w", bases=disk)
    p = dist.Field(name="p", bases=disk)
    tau_u = dist.VectorField(coords, name="tau_u", bases=disk.edge)
    tau_w = dist.Field(name="tau_w", bases=disk.edge)
    dt = lambda A: s * A  # noqa: E731
    dz = lambda A: 1j * kz * A  # noqa: E731
    lift_basis = disk.derivative_basis(2)
    lift = lambda A: d3.Lift(A, lift_basis, -1)  # noqa: E731
    w0 = dist.Field(name="w0", bases=disk)
    w0["g"] = np.broadcast_to(np.asarray(1 - r ** 2),
                              np.broadcast_shapes(phi.shape, r.shape))
    problem = d3.EVP([u, w, p, tau_u, tau_w], eigenvalue=s,
                     namespace=locals())
    problem.add_equation("div(u) + dz(w) = 0")
    problem.add_equation("dt(u) + w0*dz(u) + grad(p) - (1/Re)*(lap(u) "
                         "+ dz(dz(u))) + lift(tau_u) = 0")
    problem.add_equation("dt(w) + w0*dz(w) + u@grad(w0) + dz(p) "
                         "- (1/Re)*(lap(w) + dz(dz(w))) + lift(tau_w) = 0")
    problem.add_equation("u(r=1) = 0")
    problem.add_equation("w(r=1) = 0")
    solver = problem.build_solver()
    return solver, solver.subproblems_by_group[(m, None)]


def slowest(evals, n):
    evals = np.asarray(evals)
    evals = evals[np.isfinite(evals)]
    return evals[np.argsort(-evals.real)][:n]


def test_pipe_flow_evp_matches_jax():
    """examples/pipe_flow.py --quick (Nr = 32) through the port's
    build_pipe_flow_evp: the m = 1 pencil's M and L equal the JAX
    package's to its drift bound (the background w0 is a disk NCC
    field), its 5 slowest modes to 1e-10 relative to the slowest's
    modulus (measured 1.8e-11), all decaying; the slowest near the
    example's converged -0.0227050 - 0.9514810i (5e-6 at this size).
    Further down the spectrum the gap is the matrices' own: scipy's eig
    on the two packages' m = 1 matrices (3.4e-13 apart) gives the same
    gaps, 1.5e-10 at the 10th mode."""
    js, jsp = jax_pipe_flow_evp(32)
    ts, tsp = tbench.build_pipe_flow_evp(32, device="cpu")
    tm, jm = ts._group_csr(tsp), js._group_csr(jsp)
    for name in ("M", "L"):
        assert rel_err(tm[name].toarray(), jm[name].toarray()) \
            <= JAX_NCC_DRIFT_RTOL, name
    js.solve_dense(jsp)
    ts.solve_dense(tsp)
    jev, tev = slowest(js.eigenvalues, 5), slowest(ts.eigenvalues, 5)
    assert np.abs(tev - jev).max() <= EIGEN_RTOL * np.abs(jev[0])
    assert (tev.real < 0).all()
    assert abs(tev[0] - tbench.PIPE_FLOW_EVP_TARGET) < 5e-6
