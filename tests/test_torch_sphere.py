"""
The sphere in the port (dedalus_tpu_torch: S2Coordinates, SphereBasis,
the SWSH library copy, spin recombination, the spin operators, MulCosine,
the shallow-water IVP and its balanced-height LBVP) held against the JAX
package on the CPU, inputs from numpy seeds:

  * libraries/sphere.py matrices equal the JAX copy's (np.array_equal);
  * scalar, vector and rank-2 transforms, grid -> coeff -> grid, agree to
    1e-13 relative, at the grid and at the dealias scale;
  * grad, div, lap (scalar and vector), lap(lap(u)), skew, MulCosine,
    integ, ave, u@grad(u), div(u*h) and -div(skew(u)) agree to 1e-12;
  * the shallow-water M/L (dense, and the banded stores with their
    structure) are bit-equal (np.array_equal) at 32x16;
  * 10 RK222 steps of the JAX package's sphere IVP test (32x16) and of
    benchmarks/progression.py build_shallow_water(64, 32), dense and
    forced banded, agree to 1e-12 relative, also when the port steps the
    system carried from the JAX solver (tools/carry.py);
  * the balanced-height LBVP of examples/shallow_water.py agrees at 64x32
    to 1e-12.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
from dedalus_tpu.libraries import sphere as jswsh
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.libraries import sphere as tswsh
from dedalus_tpu_torch.extras import bench_problems as tbench
from dedalus_tpu_torch.tools import carry
from dedalus_tpu_torch.tools.carry import STRUCTURE_FIELDS

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "benchmarks"))
import progression  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-12
TRANSFORM_RTOL = 1e-13


def rel_err(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) \
        / np.max(np.abs(np.asarray(b)))


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def make_sphere(d3, shape, radius=1.5, dealias=(1, 1)):
    cs = d3.S2Coordinates("phi", "theta")
    dist = d3.Distributor(cs, dtype=np.float64, **dist_kw(d3))
    basis = d3.SphereBasis(cs, shape=shape, dtype=np.float64, radius=radius,
                           dealias=dealias)
    return cs, dist, basis


# ------------------------------------------------------- the SWSH library

SWSH_CASES = [(7, 0, 0), (7, 2, -1), (15, 3, 1), (15, 0, 2)]
SWSH_FUNCTIONS = {
    "quadrature": lambda lib, L, m, s: lib.quadrature(L),
    "harmonics": lambda lib, L, m, s: lib.harmonics(
        L, m, s, np.linspace(-0.9, 0.9, 7)),
    "ladder_up": lambda lib, L, m, s: lib.ladder_matrix(L, m, s, +1),
    "ladder_down": lambda lib, L, m, s: lib.ladder_matrix(L, m, s, -1),
    "cos": lambda lib, L, m, s: lib.cos_matrix(L, m, s),
    "sin": lambda lib, L, m, s: lib.sin_matrix(L, m, s + 1, s),
    "forward": lambda lib, L, m, s: lib.forward_matrix(L, m, s,
                                                      3 * (L + 1) // 2),
    "backward": lambda lib, L, m, s: lib.backward_matrix(L, m, s,
                                                        3 * (L + 1) // 2),
    "interpolation": lambda lib, L, m, s: lib.interpolation_row(L, m, s,
                                                                0.7),
    "ell_range": lambda lib, L, m, s: lib.ell_range(L, m, s),
}


@pytest.mark.parametrize("case", SWSH_CASES, ids=str)
@pytest.mark.parametrize("fn", list(SWSH_FUNCTIONS))
def test_swsh_matrices_equal_jax_copy(fn, case):
    out = SWSH_FUNCTIONS[fn](tswsh, *case)
    ref = SWSH_FUNCTIONS[fn](jswsh, *case)
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert o.shape == r.shape
        assert np.array_equal(o, r)


# ------------------------------------------------------------ transforms

def random_field(d3, dist, cs, basis, rank, seed, name="f"):
    """A field of the given tensor rank over cs with random grid data
    from a numpy seed (the same data in both packages)."""
    f = dist.Field(name=name, bases=basis, tensorsig=(cs,) * rank)
    rng = np.random.default_rng(seed)
    f["g"] = rng.standard_normal(f["g"].shape)
    return f


@pytest.mark.parametrize("shape", [(16, 8), (24, 12)], ids=str)
@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("scale", [1, 1.5])
def test_transforms_match_jax(shape, rank, scale):
    """grid -> coeff (spin recombination and the SWSH stacks) and back,
    at scale 1 and at the dealias scale 3/2 (bound 1e-13 relative)."""
    out = {}
    for d3 in (jd3, td3):
        cs, dist, basis = make_sphere(d3, shape)
        f = dist.Field(name="f", bases=basis, tensorsig=(cs,) * rank)
        f.change_scales(scale)
        rng = np.random.default_rng(21 + rank)
        f["g"] = rng.standard_normal(f["g"].shape)
        c = np.array(f["c"])
        f["c"] = c
        out[d3] = (c, np.array(f["g"]))
    for part in range(2):
        assert rel_err(out[td3][part], out[jd3][part]) <= TRANSFORM_RTOL


# ------------------------------------------------------------- operators

OPERATORS = {
    "grad": lambda d3, u, h: d3.grad(h),
    "div": lambda d3, u, h: d3.div(u),
    "lap_scalar": lambda d3, u, h: d3.lap(h),
    "lap_vector": lambda d3, u, h: d3.lap(u),
    "lap_lap_vector": lambda d3, u, h: d3.lap(d3.lap(u)),
    "skew": lambda d3, u, h: d3.Skew(u),
    "mulcosine": lambda d3, u, h: d3.MulCosine(d3.Skew(u)),
    "integ": lambda d3, u, h: d3.integ(h),
    "ave": lambda d3, u, h: d3.ave(h),
    "u_grad_u": lambda d3, u, h: u @ d3.grad(u),
    "div_u_h": lambda d3, u, h: d3.div(u * h),
    "vorticity": lambda d3, u, h: -d3.div(d3.Skew(u)),
    "grad_grad": lambda d3, u, h: d3.grad(d3.grad(h)),
}


@pytest.mark.parametrize("shape", [(16, 8), (24, 12)], ids=str)
@pytest.mark.parametrize("op", list(OPERATORS))
def test_operators_match_jax(op, shape):
    """Each operator evaluated on the same random u, h (dealias 3/2):
    coefficients and grid values (bound 1e-12 relative)."""
    out = {}
    for d3 in (jd3, td3):
        cs, dist, basis = make_sphere(d3, shape, dealias=(3 / 2, 3 / 2))
        u = random_field(d3, dist, cs, basis, 1, 31, "u")
        h = random_field(d3, dist, cs, basis, 0, 32, "h")
        r = OPERATORS[op](d3, u, h).evaluate()
        out[d3] = (np.array(r["c"]), np.array(r["g"]))
    for part in range(2):
        assert out[td3][part].shape == out[jd3][part].shape
        assert rel_err(out[td3][part], out[jd3][part]) <= RTOL


def test_lap_lap_vector_small_ntheta_masks():
    """lap(lap(u)) at Ntheta = 4, where slots l < |s| are masked: the
    port's result equals the JAX package's, and grad(Y_1) is an
    eigenvector with eigenvalue (-(l(l+1) - 1)/r^2)^2 = 1/r^4."""
    out = {}
    for d3 in (jd3, td3):
        cs, dist, basis = make_sphere(d3, (8, 4), radius=1.0)
        phi, theta = dist.local_grids(basis)
        f = dist.Field(name="f", bases=basis)
        f["g"] = np.cos(theta) + 0 * phi
        u = d3.grad(f).evaluate()
        out[d3] = (np.array(d3.lap(d3.lap(u)).evaluate()["g"]),
                   np.array(u["g"]))
    assert rel_err(out[td3][0], out[jd3][0]) <= RTOL
    assert rel_err(out[td3][0], out[td3][1]) <= RTOL


# ------------------------------------------------------ the shallow water

def sphere_ivp(d3, matsolver=None):
    """tests/test_sphere.py:185's rotating shallow-water IVP at 32x16."""
    Nphi, Ntheta = 32, 16
    R, Omega, nu, g, H = 2.0, 0.5, 1e-4, 1.0, 1.0
    cs = d3.S2Coordinates("phi", "theta")
    dist = d3.Distributor(cs, dtype=np.float64, **dist_kw(d3))
    basis = d3.SphereBasis(cs, shape=(Nphi, Ntheta), dtype=np.float64,
                           radius=R, dealias=(3 / 2, 3 / 2))
    u = dist.VectorField(cs, name="u", bases=basis)
    h = dist.Field(name="h", bases=basis)
    zcross = lambda A: d3.MulCosine(d3.Skew(A))  # noqa: E731
    problem = d3.IVP([u, h], namespace=locals())
    problem.add_equation(
        "dt(u) + nu*lap(lap(u)) + g*grad(h) + 2*Omega*zcross(u) = - u@grad(u)")
    problem.add_equation("dt(h) + nu*lap(lap(h)) + H*div(u) = - div(u*h)")
    if d3 is td3:
        kw = {"matsolver": matsolver} if matsolver else {}
        solver = problem.build_solver(d3.RK222, **kw)
    else:
        solver = build_jax(lambda: problem.build_solver(d3.RK222), matsolver)
    h.fill_random("g", seed=7, scale=1e-2)
    u.fill_random("g", seed=8, scale=1e-3)
    return solver, 0.05


def build_jax(build, matsolver):
    """Build with the JAX package's MATRIX_SOLVER set to `matsolver`."""
    from dedalus_tpu.tools.config import config
    old = config["linear algebra"].get("MATRIX_SOLVER", "auto")
    if matsolver is not None:
        config["linear algebra"]["MATRIX_SOLVER"] = matsolver
    try:
        return build()
    finally:
        config["linear algebra"]["MATRIX_SOLVER"] = old


@pytest.fixture(scope="module", params=[None, "banded"],
                ids=["dense", "banded"])
def sw32(request):
    js, dt = sphere_ivp(jd3, request.param)
    ts, _ = sphere_ivp(td3, request.param)
    return js, ts, dt, request.param


def test_sw_path_is_the_jax_path(sw32):
    """The port takes the JAX package's path: dense under 'auto' at this
    size, banded when forced, with equal q, NB, pins and bands."""
    js, ts, _, matsolver = sw32
    assert ts.ops.kind == js.ops.kind == ("banded" if matsolver else "dense")
    if matsolver:
        for k in ("q", "NB", "t_pins", "kl", "ku"):
            assert getattr(ts.structure, k) == getattr(js.structure, k)


def test_sw_matrices_bit_equal(sw32):
    """M and L: dense (G, S, S) arrays or band stores, np.array_equal, and
    the banded structure's fields; the valid-row mask."""
    js, ts, _, matsolver = sw32
    for name in ("M", "L"):
        if matsolver:
            for part in ("bands", "Vt", "dsel"):
                ref = np.asarray(js._matrices[name][part])
                out = np.asarray(ts._matrices[name][part])
                assert out.shape == ref.shape
                assert np.array_equal(out, ref)
        else:
            assert np.array_equal(np.asarray(ts._matrices[name]),
                                  np.asarray(js._matrices[name]))
    if matsolver:
        for field in STRUCTURE_FIELDS:
            assert np.array_equal(np.asarray(getattr(ts.structure, field)),
                                  np.asarray(getattr(js.structure, field)))
    assert np.array_equal(ts.valid_row_mask, js.valid_row_mask)


def test_sw_trajectory_matches_jax(sw32):
    """10 RK222 steps from the same random state (bound 1e-12 relative);
    mass integ(h) conserved in both."""
    js, ts, dt, _ = sw32
    assert rel_err(ts.gather_fields().numpy(),
                   np.asarray(js.gather_fields())) <= 1e-13
    mass0 = float(np.asarray(td3.integ(ts.variables[1]).evaluate()["g"])
                  .ravel()[0])
    for _ in range(10):
        js.step(dt)
        ts.step(dt)
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL
    mass1 = float(np.asarray(td3.integ(ts.variables[1]).evaluate()["g"])
                  .ravel()[0])
    assert abs(mass1 - mass0) < 1e-10


@pytest.fixture(scope="module", params=[None, "banded"],
                ids=["dense", "banded"])
def galewsky64(request):
    """benchmarks/progression.py build_shallow_water(64, 32) and the
    port's builder without the balance solve (the same initial state)."""
    js, dt = progression.build_shallow_water(64, 32, np.float64,
                                             matsolver=request.param)
    ts, tdt, bal = tbench.build_shallow_water(64, 32, np.float64,
                                              matsolver=request.param,
                                              balance=False, device="cpu")
    assert tdt == dt and bal is None
    return js, ts, dt, request.param


def test_galewsky_trajectory_matches_jax(galewsky64):
    js, ts, dt, matsolver = galewsky64
    assert ts.ops.kind == js.ops.kind == ("banded" if matsolver else "dense")
    if matsolver:
        assert (ts.structure.q, ts.structure.NB, ts.structure.t_pins) \
            == (js.structure.q, js.structure.NB, js.structure.t_pins)
    for _ in range(10):
        js.step(dt)
        ts.step(dt)
    assert np.isfinite(ts.X.numpy()).all()
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL


def test_sw_step_from_carried_system_matches_jax():
    """tools/carry.py: the JAX banded shallow-water solver's band stores,
    structure and mid-run state installed into a port solver; both step
    5 more times (bound 1e-12 relative)."""
    js, dt = sphere_ivp(jd3, "banded")
    ts, _ = sphere_ivp(td3, "banded")
    for _ in range(3):
        js.step(dt)
    fields = {k: getattr(js.structure, k) for k in STRUCTURE_FIELDS}
    matrices = {name: {k: np.asarray(v) for k, v in
                       js._matrices[name].items()} for name in ("M", "L")}
    carry.install_system(ts, fields, matrices, X=np.asarray(js.X))
    for _ in range(5):
        js.step(dt)
        ts.step(dt)
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL


def balanced_height_jax(Nphi, Ntheta):
    """The balanced-height LBVP of examples/shallow_water.py:53-61 with
    the JAX package, on the jet of benchmarks/progression.py, then the
    perturbation added, as the port's builder does with balance=True.
    Returns (h grid data, c)."""
    js, _ = progression.build_shallow_water(Nphi, Ntheta, np.float64)
    u, h = js.variables
    hpert = np.array(h["g"])  # the JAX builder sets h to the perturbation
    d3 = jd3
    meter, second = 1 / 6.37122e6, 1 / 3600
    Omega = 7.292e-5 / second
    g = 9.80616 * meter / second ** 2
    zcross = lambda A: d3.MulCosine(d3.Skew(A))  # noqa: E731
    c = u.dist.Field(name="c")
    problem = d3.LBVP([h, c], namespace=locals())
    problem.add_equation(
        "g*lap(h) + c = - div(u@grad(u) + 2*Omega*zcross(u))")
    problem.add_equation("ave(h) = 0")
    problem.build_solver().solve()
    return np.array(h["g"]) + hpert, float(np.asarray(c["g"]).ravel()[0])


def test_balanced_height_lbvp_matches_jax():
    """The port's builder with balance=True solves the example's LBVP
    (dense under 'auto') and adds the perturbation: h agrees with the JAX
    package's to 1e-12 relative, and the tau c (0 here: the forcing is a
    divergence) to 1e-12 of the forcing's size."""
    jh, jc = balanced_height_jax(64, 32)
    ts, dt, bal = tbench.build_shallow_water(64, 32, np.float64,
                                             device="cpu")
    assert bal.ops.kind == "dense"
    th, tc = bal.variables
    assert th is ts.variables[1]
    assert rel_err(np.array(th["g"]), jh) <= RTOL
    forcing = np.abs(bal.problem.equations[0]["F"].evaluate()["c"]).max()
    assert abs(float(np.asarray(tc["g"]).ravel()[0]) - jc) <= RTOL * forcing


def test_sphere_distributor_needs_cuda_unless_cpu():
    cs = td3.S2Coordinates("phi", "theta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        td3.Distributor(cs, dtype=np.float64)
    dist = td3.Distributor(cs, dtype=np.float64, device="cpu")
    assert dist.device.type == "cpu"


def test_cartesian_skew_matches_jax():
    """Skew off the sphere: the Cartesian rotation (u, v) -> (-v, u) of a
    Fourier x Chebyshev vector field, against the JAX package (bound
    1e-12 relative)."""
    out = {}
    for d3 in (jd3, td3):
        coords = d3.CartesianCoordinates("x", "z")
        dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
        xb = d3.RealFourier(coords["x"], size=8, bounds=(0, 2 * np.pi))
        zb = d3.ChebyshevT(coords["z"], size=8, bounds=(0, 1))
        u = dist.VectorField(coords, name="u", bases=(xb, zb))
        u["g"] = np.random.default_rng(41).standard_normal(u["g"].shape)
        out[d3] = np.array(d3.Skew(u).evaluate()["g"])
    assert rel_err(out[td3], out[jd3]) <= RTOL
    ug = np.array(u["g"])
    assert rel_err(out[td3], np.array([-ug[1], ug[0]])) <= RTOL
