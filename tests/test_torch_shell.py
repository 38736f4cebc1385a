"""
The spherical shell in the port (dedalus_tpu_torch: SphericalCoordinates,
ShellBasis, the regularity helpers, the spherical ell operators,
CrossProduct and the radial and ell-coupled shell NCCs, the spherical
CFL, and the examples/shell_convection.py and progression rotconv IVPs)
held against the JAX package on the CPU, in f64, inputs from numpy seeds,
with one intra-op thread:

  * the real-dtype cases of tests/test_shell.py, through the port;
  * scalar (k = 0, 1), vector and rank-2 transforms, grid -> coeff, agree
    to 1e-13 relative; grad, div, curl, lap, trace and transpose
    coefficients to 1e-13 relative;
  * shell_convection 16x8x6: per-group M and L np.array_equal (bound
    1e-14 absolute), per-(m, ell) pencils in both packages, 20 SBDF2
    steps at dt 0.05 to 1e-12 of the state on every field;
  * rotconv 16x8x8: per-m M and L np.array_equal (the theta-varying
    cross(ez, u) of _sph_coupled_ncc_matrix), per-m pencils in both
    packages, 5 RK222 steps: u and T to 1e-12 of the state, the
    algebraic p and taus to 1e-10 (see ROTCONV_ALGEBRAIC_BOUND);
  * a scalar and a vector shell LBVP to 1e-12; the spherical CFL dt to
    1e-14; the carried shell system;
  * the floored-pivot count: nonzero on the annulus example's singular
    m = 0 pencil (where the JAX package's step is non-finite), zero and
    bit-equal on nonsingular factors, for every dense solver and the
    banded factor.

The JAX package's persistent assembly cache is off in this module: its
fingerprint moves each NCC field through coefficient space and back, so
the NCC grid data the JAX build reads would be a roundtrip of the data
the port reads (a 5e-15 difference in the NCC blocks of L).
"""

import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.extras import bench_problems as tbench
from dedalus_tpu_torch.libraries import matsolvers as tms
from dedalus_tpu_torch.tools import carry

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "benchmarks"))
from progression import build_rotconv_ivp  # noqa: E402

torch.set_num_threads(1)

RI, RO = 1.0, 2.0
RTOL = 1e-12
TRANSFORM_RTOL = 1e-13
# rotconv's pencils M + dt h L have condition ~9.4e9 (Ekman 1e-3,
# Rayleigh 3e5): one solve of the same system and right-hand side by
# jaxlib's LU and torch's differs by 1.2e-12 of the solution (both
# backward stable, residuals ~5e-19). After 5 RK222 steps the fields
# with a time derivative (u, T) agree to 6.1e-15 of the state; the
# algebraic ones (p and the taus: no dt term) reached 1.8e-11 (p) and
# 3.0e-11 over the first steps, held to ROTCONV_ALGEBRAIC_BOUND
ROTCONV_DYNAMIC = ("u", "T")
ROTCONV_ALGEBRAIC_BOUND = 1e-10


@pytest.fixture(scope="module", autouse=True)
def no_jax_assembly_cache():
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


def make_shell(d3, shape=(12, 8, 12), radii=(RI, RO), dealias=1, k=0):
    cs = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(cs, dtype=np.float64, **dist_kw(d3))
    shell = d3.ShellBasis(cs, shape=shape, dtype=np.float64, radii=radii,
                          dealias=dealias, k=k)
    return cs, dist, shell


def xyz(phi, theta, r):
    return (r * np.sin(theta) * np.cos(phi),
            r * np.sin(theta) * np.sin(phi),
            r * np.cos(theta))


def cartesian_vector_to_spherical(phi, theta, vx, vy, vz):
    """Coordinate components (phi, theta, r) of a Cartesian vector."""
    v_phi = -np.sin(phi) * vx + np.cos(phi) * vy
    v_theta = (np.cos(theta) * np.cos(phi) * vx
               + np.cos(theta) * np.sin(phi) * vy - np.sin(theta) * vz)
    v_r = (np.sin(theta) * np.cos(phi) * vx
           + np.sin(theta) * np.sin(phi) * vy + np.cos(theta) * vz)
    return v_phi, v_theta, v_r


def smooth_field(d3, rank, seed, shape=(12, 8, 12), k=0):
    """A band-limited field of the given rank: random coefficients (from
    a numpy seed) on the valid slots, through the basis's own transform,
    so the same grid data feeds both packages."""
    cs, dist, shell = make_shell(d3, shape=shape, k=k)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(12)
    scalar = (c[0] * x * y + c[1] * z ** 2 + c[2] * x + c[3] / r
              + c[4] * y * z * r + c[5])
    f = dist.Field(name="f", bases=shell)
    f["g"] = scalar
    if rank == 0:
        return cs, dist, shell, f
    vp, vt, vr = cartesian_vector_to_spherical(
        phi, theta, c[6] * y + 1 + x ** 2, c[7] * x * z + y ** 2 * z,
        c[8] * z + c[9] * x + z ** 3)
    u = dist.VectorField(cs, name="u", bases=shell)
    u["g"] = np.array([vp + 0 * r, vt + 0 * r, vr + 0 * r])
    if rank == 1:
        return cs, dist, shell, u
    T = dist.TensorField(cs, name="T", bases=shell)
    g = np.zeros(T["g"].shape)
    for i in range(3):
        for j in range(3):
            g[i, j] = np.asarray(u["g"])[i] * np.asarray(u["g"])[j] \
                * (1 + 0.1 * (i - j))
    T["g"] = g
    return cs, dist, shell, T


# ------------------------------------- tests/test_shell.py through the port

@pytest.mark.parametrize("k", [0, 1])
def test_shell_scalar_roundtrip(k):
    cs, dist, shell = make_shell(td3, k=k)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=shell)
    f["g"] = x * y + z ** 2 + x + 3 / r
    g0 = np.array(f["g"])
    f["c"] = f["c"]
    assert np.abs(f["g"] - g0).max() < 1e-11


def test_shell_vector_roundtrip():
    cs, dist, shell = make_shell(td3)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    vp, vt, vr = cartesian_vector_to_spherical(phi, theta, y + 1, x, 2 * z)
    u = dist.VectorField(cs, name="u", bases=shell)
    u["g"] = np.array([vp + 0 * r, vt + 0 * r, vr + 0 * r])
    g0 = np.array(u["g"])
    u["c"] = u["c"]
    assert np.abs(u["g"] - g0).max() < 1e-11


def test_shell_tensor_roundtrip():
    cs, dist, shell = make_shell(td3)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=shell)
    f["g"] = x * y * z + z ** 3
    T = td3.grad(td3.grad(f)).evaluate()
    g0 = np.array(T["g"])
    T["c"] = T["c"]
    assert np.abs(T["g"] - g0).max() < 1e-10


def test_shell_gradient():
    cs, dist, shell = make_shell(td3)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=shell)
    f["g"] = x * y + z ** 2 + x + 3
    vp, vt, vr = cartesian_vector_to_spherical(phi, theta, y + 1, x, 2 * z)
    g = td3.grad(f).evaluate()["g"]
    assert np.abs(g[0] - vp).max() < 1e-11
    assert np.abs(g[1] - vt).max() < 1e-11
    assert np.abs(g[2] - vr).max() < 1e-11


def test_shell_laplacian_divergence_curl():
    cs, dist, shell = make_shell(td3)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=shell)
    f["g"] = x * y + z ** 2 + x + 3
    assert np.abs(td3.lap(f).evaluate()["g"] - 2.0).max() < 1e-9
    assert np.abs(td3.div(td3.grad(f)).evaluate()["g"] - 2.0).max() < 1e-9
    assert np.abs(td3.curl(td3.grad(f)).evaluate()["g"]).max() < 1e-9


def test_shell_curl_of_rotation():
    """curl of the rigid rotation u = Omega x r is 2 Omega."""
    cs, dist, shell = make_shell(td3)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    vp, vt, vr = cartesian_vector_to_spherical(phi, theta, -y, x, 0 * z)
    u = dist.VectorField(cs, name="u", bases=shell)
    u["g"] = np.array([vp, vt, vr + 0 * x])
    c = td3.curl(u).evaluate()["g"]
    wp, wt, wr = cartesian_vector_to_spherical(phi, theta, 0 * x, 0 * x,
                                               2 + 0 * x)
    assert np.abs(c[0] - wp).max() < 1e-10
    assert np.abs(c[1] - wt).max() < 1e-10
    assert np.abs(c[2] - wr).max() < 1e-10


def test_shell_trace_vs_laplacian():
    cs, dist, shell = make_shell(td3)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=shell)
    f["g"] = x * y * z + z ** 3
    lap = td3.lap(f).evaluate()["g"]
    tr = td3.trace(td3.grad(td3.grad(f))).evaluate()["g"]
    assert np.abs(tr - lap).max() < 1e-9


def test_shell_trace_lhs_matrix():
    """The coefficient-space trace matrix (Q-intertwined spin metric)
    agrees with trace(grad(grad(f))) == lap(f)."""
    cs, dist, shell = make_shell(td3, dealias=3 / 2)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=shell)
    f["g"] = x * z + np.asarray(r) ** 3
    f2 = dist.Field(name="f2", bases=shell)
    s = dist.Field(name="s", bases=shell)
    problem = td3.LBVP([f2, s], namespace=locals())
    problem.add_equation("s - trace(grad(grad(f2))) = 0")
    problem.add_equation("f2 = f")
    problem.build_solver().solve()
    lap = td3.lap(f).evaluate()["g"]
    assert np.abs(np.asarray(s["g"]) - np.asarray(lap)).max() < 1e-9


def test_shell_vector_ncc():
    """Radial vector NCCs (b*er) assemble exact LHS matrices."""
    cs, dist, shell = make_shell(td3, shape=(8, 6, 8), dealias=3 / 2)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    er = dist.VectorField(cs, name="er", bases=shell)
    er["g"][2] = 1.0
    bvar = dist.Field(name="bvar", bases=shell)
    w = dist.VectorField(cs, name="w", bases=shell)
    f = dist.Field(name="f", bases=shell)
    f["g"] = x * z + np.asarray(r) ** 2
    problem = td3.LBVP([bvar, w], namespace=locals())
    problem.add_equation("w - bvar*er = 0")
    problem.add_equation("bvar = f")
    problem.build_solver().solve()
    expect = np.zeros_like(np.asarray(w["g"]))
    expect[2] = np.asarray(f["g"])
    assert np.abs(np.asarray(w["g"]) - expect).max() < 1e-12


def test_field_view_writeback():
    """u['g'][comp] = ... writes through to the field; derived arrays
    don't."""
    cs, dist, shell = make_shell(td3, shape=(4, 3, 4))
    u = dist.VectorField(cs, name="u", bases=shell)
    u["g"][2] = 1.0
    assert np.abs(np.asarray(u["g"])[2] - 1.0).max() < 1e-15
    assert np.abs(np.asarray(u["g"])[0]).max() < 1e-15
    t = dist.Field(name="t", bases=shell)
    t["g"] = 3.0
    w = t["g"] * 2
    w[0] = 99.0
    assert np.abs(np.asarray(t["g"]) - 3.0).max() < 1e-15
    t["g"] += 1.0
    assert np.abs(np.asarray(t["g"]) - 4.0).max() < 1e-15


def test_shell_interpolation_and_components():
    cs, dist, shell = make_shell(td3)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=shell)
    f["g"] = x * y + z ** 2 + x + 3
    phig, thetag = phi[:, :, 0], theta[:, :, 0]
    for r0 in (RI, RO):
        xo, yo, zo = xyz(phig, thetag, r0)
        fo = f(r=r0).evaluate()["g"]
        assert np.abs(fo[:, :, 0] - (xo * yo + zo ** 2 + xo + 3)).max() \
            < 1e-11
    uo = td3.grad(f)(r=RO).evaluate()
    xo, yo, zo = xyz(phig, thetag, RO)
    vp, vt, vr = cartesian_vector_to_spherical(phig, thetag, yo + 1, xo,
                                               2 * zo)
    assert np.abs(td3.radial(uo).evaluate()["g"][:, :, 0] - vr).max() \
        < 1e-10
    ang = td3.angular(uo).evaluate()["g"]
    assert np.abs(ang[0][:, :, 0] - vp).max() < 1e-10
    assert np.abs(ang[1][:, :, 0] - vt).max() < 1e-10


def test_shell_integration():
    cs, dist, shell = make_shell(td3)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    f = dist.Field(name="f", bases=shell)
    f["g"] = z ** 2 + 3 + x  # odd x integrates to zero
    total = float(td3.integ(f).evaluate()["g"].ravel()[0])
    exact = 4 * np.pi / 3 * ((RO ** 5 - RI ** 5) / 5
                             + 3 * (RO ** 3 - RI ** 3))
    assert abs(total - exact) < 1e-11
    ave = float(td3.ave(f).evaluate()["g"].ravel()[0])
    assert abs(ave - exact / shell.volume) < 1e-12


def test_shell_ncc_lhs_vs_rhs():
    cs, dist, shell = make_shell(td3, shape=(8, 6, 10), dealias=3 / 2)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    ncc = dist.Field(name="ncc", bases=shell)
    ncc["g"] = r ** 2 + 1 / r
    v = dist.Field(name="v", bases=shell)
    w = dist.Field(name="w", bases=shell)
    problem = td3.LBVP([v], namespace=locals())
    problem.add_equation("ncc*v = ncc*w")
    w["g"] = x * z + r
    problem.build_solver().solve()
    assert np.abs(v["g"] - w["g"]).max() < 1e-12


def scalar_poisson(d3):
    cs, dist, shell = make_shell(d3)
    phi, theta, r = dist.local_grids(shell)
    u = dist.Field(name="u", bases=shell)
    t1 = dist.Field(name="t1", bases=shell.S2_basis(RO))
    t2 = dist.Field(name="t2", bases=shell.S2_basis(RI))
    six = dist.Field(name="six", bases=shell)
    six["g"] = 6.0
    lift_basis = shell.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)  # noqa: E731
    problem = d3.LBVP([u, t1, t2], namespace={**locals(), "RI": RI,
                                              "RO": RO})
    problem.add_equation("lap(u) + lift(t1, -1) + lift(t2, -2) = six")
    problem.add_equation("u(r=RI) = RI**2")
    problem.add_equation("u(r=RO) = RO**2")
    problem.build_solver().solve()
    return u, r


def vector_lbvp(d3):
    """lap(u) = 0 for u = grad(xyz) with exact boundary data."""
    cs, dist, shell = make_shell(d3)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    h = dist.Field(name="h", bases=shell)
    h["g"] = x * y * z
    u_exact = d3.grad(h).evaluate()
    u = dist.VectorField(cs, name="u", bases=shell)
    tu1 = dist.VectorField(cs, name="tu1", bases=shell.S2_basis(RO))
    tu2 = dist.VectorField(cs, name="tu2", bases=shell.S2_basis(RI))
    bco = u_exact(r=RO).evaluate()
    bci = u_exact(r=RI).evaluate()
    lift_basis = shell.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)  # noqa: E731
    problem = d3.LBVP([u, tu1, tu2], namespace={**locals(), "RI": RI,
                                                "RO": RO})
    problem.add_equation("lap(u) + lift(tu1, -1) + lift(tu2, -2) = 0")
    problem.add_equation("u(r=RI) = bci")
    problem.add_equation("u(r=RO) = bco")
    problem.build_solver().solve()
    return u, u_exact


def test_shell_scalar_poisson_lbvp():
    u, r = scalar_poisson(td3)
    assert np.abs(u["g"] - r ** 2).max() < 1e-12


def test_shell_vector_lbvp():
    u, u_exact = vector_lbvp(td3)
    assert np.abs(u["g"] - u_exact["g"]).max() < 1e-11


@pytest.mark.parametrize("case", ["scalar", "vector"])
def test_shell_lbvps_match_jax(case):
    """The scalar Poisson and the vector Laplace LBVP: the port's
    solution against the JAX package's, 1e-12 relative."""
    run = scalar_poisson if case == "scalar" else vector_lbvp
    tu, ju = run(td3)[0], run(jd3)[0]
    assert rel_err(np.array(tu["c"]), np.array(ju["c"])) <= RTOL


def test_shell_diffusion_ivp():
    cs, dist, shell = make_shell(td3, shape=(8, 6, 10), dealias=3 / 2)
    phi, theta, r = dist.local_grids(shell)
    x, y, z = xyz(phi, theta, r)
    u = dist.Field(name="u", bases=shell)
    t1 = dist.Field(name="t1", bases=shell.S2_basis(RO))
    t2 = dist.Field(name="t2", bases=shell.S2_basis(RI))
    lift_basis = shell.derivative_basis(2)
    lift = lambda A, n: td3.Lift(A, lift_basis, n)  # noqa: E731
    problem = td3.IVP([u, t1, t2], namespace={**locals(), "RI": RI,
                                              "RO": RO})
    problem.add_equation("dt(u) - lap(u) + lift(t1,-1) + lift(t2,-2) "
                         "= - u*u")
    problem.add_equation("u(r=RI) = 0")
    problem.add_equation("u(r=RO) = 0")
    solver = problem.build_solver(td3.RK222)
    u["g"] = np.sin(np.pi * (r - RI)) * (1 + 0.3 * x / r)
    E0 = float(td3.integ(u * u).evaluate()["g"].ravel()[0])
    for _ in range(40):
        solver.step(2e-3)
    E1 = float(td3.integ(u * u).evaluate()["g"].ravel()[0])
    assert np.isfinite(E1)
    assert E1 < E0
    assert np.abs(u(r=RI).evaluate()["g"]).max() < 1e-12
    assert np.abs(u(r=RO).evaluate()["g"]).max() < 1e-12


def test_spherical_ell_product_shell_lhs():
    """SphericalEllProduct on an LHS (per-(m, ell) pencil matrices)."""
    coords = td3.SphericalCoordinates("phi", "theta", "r")
    dist = td3.Distributor(coords, dtype=np.float64, device="cpu")
    shell = td3.ShellBasis(coords, shape=(8, 8, 8), radii=(0.5, 1.5),
                           dtype=np.float64)
    phi, theta, r = dist.local_grids(shell)
    u = dist.Field(name="u", bases=shell)
    u_target = dist.Field(name="u_target", bases=shell)
    u_target["g"] = np.cos(theta) * r + np.sin(theta) * np.cos(phi)
    ellp = lambda A: td3.SphericalEllProduct(  # noqa: E731
        A, coords, lambda l: 1 + l * l)
    F = ellp(u_target).evaluate()
    problem = td3.LBVP([u], namespace=locals())
    problem.add_equation("ellp(u) = F")
    problem.build_solver().solve()
    err = np.abs(np.asarray(u["g"]) - np.asarray(u_target["g"])).max()
    assert err < 1e-12


def test_complex_shell_refused():
    """Complex-dtype shells wait for the complex spheres."""
    cs = td3.SphericalCoordinates("phi", "theta", "r")
    with pytest.raises(NotImplementedError, match="2b"):
        td3.ShellBasis(cs, shape=(8, 6, 6), dtype=np.complex128)


# ------------------------------------------------ held against the package

@pytest.mark.parametrize("rank,k", [(0, 0), (0, 1), (1, 0), (2, 0)])
def test_transforms_match_jax(rank, k):
    """grid -> coeff -> grid of the same grid data in both packages: the
    coefficients (regularity components) and the returned grid data agree
    to 1e-13 relative."""
    out = {}
    for d3 in (td3, jd3):
        f = smooth_field(d3, rank, 11 + rank, k=k)[3]
        c = np.array(f["c"])
        f["c"] = c
        out[d3] = (c, np.array(f["g"]))
    for i in range(2):
        assert rel_err(out[td3][i], out[jd3][i]) <= TRANSFORM_RTOL


OPERATORS = {
    "grad": (0, lambda d3, f: d3.grad(f)),
    "grad_vector": (1, lambda d3, f: d3.grad(f)),
    "div": (1, lambda d3, f: d3.div(f)),
    "curl": (1, lambda d3, f: d3.curl(f)),
    "lap": (0, lambda d3, f: d3.lap(f)),
    "lap_vector": (1, lambda d3, f: d3.lap(f)),
    "trace": (2, lambda d3, f: d3.trace(f)),
    "transpose": (2, lambda d3, f: d3.transpose(f)),
    "interp": (1, lambda d3, f: f(r=1.5)),
    "interp_phi": (1, lambda d3, f: f(phi=0.3)),
    "integ": (0, lambda d3, f: d3.integ(f)),
}


@pytest.mark.parametrize("op", list(OPERATORS))
def test_operators_match_jax(op):
    """Coefficients of each spherical operator on the same input in both
    packages, 1e-13 relative."""
    rank, fn = OPERATORS[op]
    out = {}
    for d3 in (td3, jd3):
        f = smooth_field(d3, rank, 21 + rank)[3]
        out[d3] = np.array(fn(d3, f).evaluate()["c"])
    assert rel_err(out[td3], out[jd3]) <= TRANSFORM_RTOL


def test_cross_product_grid():
    """cross(ez, u) on the grid against the JAX package's (the spherical
    (phi, theta, r) system is left-handed)."""
    out = {}
    for d3 in (td3, jd3):
        cs, dist, shell, u = smooth_field(d3, 1, 5)
        phi, theta, r = dist.local_grids(shell)
        ez = dist.VectorField(cs, name="ez", bases=shell)
        ez["g"][1] = -np.sin(theta) + 0 * phi
        ez["g"][2] = np.cos(theta) + 0 * phi
        out[d3] = np.array(d3.cross(ez, u).evaluate()["g"])
    assert rel_err(out[td3], out[jd3]) <= TRANSFORM_RTOL


# ------------------------------------------------ shell convection 16x8x6

def jax_shell_convection(Nphi, Ntheta, Nr):
    """examples/shell_convection.py with the JAX package, without its
    loop (the port's counterpart is bench_problems.build_shell_convection)."""
    d3 = jd3
    Ri, Ro = 14.0, 15.0
    Rayleigh, Prandtl = 3500, 1
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=np.float64)
    shell = d3.ShellBasis(coords, shape=(Nphi, Ntheta, Nr), radii=(Ri, Ro),
                          dealias=3 / 2, dtype=np.float64)
    sphere = shell.outer_surface
    p = dist.Field(name="p", bases=shell)
    b = dist.Field(name="b", bases=shell)
    u = dist.VectorField(coords, name="u", bases=shell)
    tau_p = dist.Field(name="tau_p")
    tau_b1 = dist.Field(name="tau_b1", bases=sphere)
    tau_b2 = dist.Field(name="tau_b2", bases=sphere)
    tau_u1 = dist.VectorField(coords, name="tau_u1", bases=sphere)
    tau_u2 = dist.VectorField(coords, name="tau_u2", bases=sphere)
    kappa = (Rayleigh * Prandtl) ** (-1 / 2)
    nu = (Rayleigh / Prandtl) ** (-1 / 2)
    phi, theta, r = dist.local_grids(shell)
    er = dist.VectorField(coords, name="er", bases=shell)
    er["g"][2] = 1.0
    rvec = dist.VectorField(coords, name="rvec", bases=shell)
    rvec["g"][2] = np.broadcast_to(np.asarray(r),
                                   np.asarray(er["g"])[2].shape)
    lift_basis = shell.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)  # noqa: E731
    grad_u = d3.grad(u) + rvec * lift(tau_u1)
    grad_b = d3.grad(b) + rvec * lift(tau_b1)
    problem = d3.IVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2],
                     namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*div(grad_b) + lift(tau_b2) "
                         "= - u@grad(b)")
    problem.add_equation("dt(u) - nu*div(grad_u) + grad(p) - b*er "
                         "+ lift(tau_u2) = - u@grad(u)")
    problem.add_equation("b(r=Ri) = 1")
    problem.add_equation("u(r=Ri) = 0")
    problem.add_equation("b(r=Ro) = 0")
    problem.add_equation("u(r=Ro) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(d3.SBDF2)
    b.fill_random("g", seed=42, distribution="normal", scale=1e-3)
    b["g"] += (Ri - Ri * Ro / np.asarray(r)) / (Ri - Ro)
    return solver


@pytest.fixture(scope="module")
def shell16():
    js = jax_shell_convection(16, 8, 6)
    ts, dt, flow = tbench.build_shell_convection(16, 8, 6, device="cpu")
    return js, ts, dt, flow


def state_errors(ts, js):
    """Each field's max |port - JAX| over its coefficients, relative to
    the largest entry of the JAX state (a field that is zero up to
    roundoff, such as tau_p at 1e-24, has no error of its own scale)."""
    scale = np.abs(np.asarray(js.X)).max()
    return {tv.name or f"var{i}": float(np.abs(
        np.array(tv["c"]) - np.array(jv["c"])).max() / scale)
        for i, (tv, jv) in enumerate(zip(ts.variables, js.variables))}


def constraint_residual(solver, eq_index=0):
    """max |L X| over the valid rows of one equation: the residual of a
    constraint (no dt term) as the solver's own matrices apply it."""
    from dedalus_tpu_torch.core.subsystems import _system_sizes
    _, eq_sizes, _ = _system_sizes(solver.layout, solver.equations,
                                   solver.variables)
    row0 = int(np.sum(eq_sizes[:eq_index]))
    rows = slice(row0, row0 + eq_sizes[eq_index])
    LX = solver.ops.matvec(solver.L_mat, solver.X) * solver._row_mask()
    return float(LX[:, rows].abs().max())


def test_shell_convection_pencils_equal(shell16):
    """One pencil per (m, ell) in both packages (the classifier finds the
    radial NCCs angularly constant: no coupled axis), the same S, G and
    valid rows, per-group M and L np.array_equal."""
    js, ts, _, _ = shell16
    assert ts.layout.forced_coupled == set() == js.layout.forced_coupled
    assert ts.pencil_shape == tuple(js.pencil_shape) == (64, 78)
    assert ts.ops.kind == "dense"
    assert np.array_equal(ts.valid_row_mask, np.asarray(js.valid_row_mask))
    for name in ("M", "L"):
        a = np.asarray(ts._matrices[name])
        b = np.asarray(js._matrices[name])
        assert np.abs(a - b).max() <= 1e-14
        assert np.array_equal(a, b)


def test_shell_convection_trajectory_matches_jax(shell16):
    """20 SBDF2 steps at dt 0.05: every field within 1e-12 of the state,
    the flow property finite, the boundary conditions and the
    incompressibility constraint held, and the CFL dt of the stepped
    state equal to the JAX package's to 1e-14."""
    js, ts, dt, flow = shell16
    for _ in range(20):
        js.step(dt)
        ts.step(dt)
    errs = state_errors(ts, js)
    assert max(errs.values()) <= RTOL, errs
    assert np.isfinite(flow.max("u2"))
    fields = {v.name: v for v in ts.variables}
    b, u, tau_p = fields["b"], fields["u"], fields["tau_p"]
    assert np.abs(np.array(u(r=14.0).evaluate()["g"])).max() < 1e-12
    assert np.abs(np.array(u(r=15.0).evaluate()["g"])).max() < 1e-12
    assert np.abs(np.array(b(r=14.0).evaluate()["g"]) - 1).max() < 1e-12
    assert np.abs(np.array(b(r=15.0).evaluate()["g"])).max() < 1e-12
    # trace(grad_u) + tau_p as the pencils hold it: the constraint rows
    # of L X (its grid evaluation carries the truncation of the
    # rvec*lift(tau) product, 7.6e-8 in both packages)
    assert constraint_residual(ts) < 1e-12


def test_shell_cfl_matches_jax():
    """The spherical arm of the CFL spacing: the same velocity grid data
    on the example's shell (dealias 3/2) in both packages gives the same
    dt (1e-14)."""
    dts = {}
    for d3 in (td3, jd3):
        cs, dist, shell = make_shell(d3, shape=(16, 8, 6),
                                     radii=(14.0, 15.0), dealias=3 / 2)
        phi, theta, r = dist.local_grids(shell)
        x, y, z = xyz(phi, theta, r)
        vp, vt, vr = cartesian_vector_to_spherical(
            phi, theta, 1e-3 * (y + z), 2e-3 * x * z / r, 1e-3 * (r - 14.5))
        u = dist.VectorField(cs, name="u", bases=shell)
        u["g"] = np.array([vp + 0 * r, vt + 0 * r, vr + 0 * r])
        p = dist.Field(name="p", bases=shell)
        problem = d3.IVP([p], namespace=locals())
        problem.add_equation("dt(p) = - u@grad(p)")
        solver = problem.build_solver(d3.SBDF2)
        cfl = d3.CFL(solver, initial_dt=1.0, cadence=1, safety=0.5)
        cfl.add_velocity(u)
        dts[d3] = cfl.compute_timestep()
    assert abs(dts[td3] - dts[jd3]) <= 1e-14 * dts[jd3]


def test_shell_convection_builder_is_the_example():
    """bench_problems.build_shell_convection assembles the JAX example's
    system: M and L equal at 16x8x6 (as the fixture's), at another size."""
    js = jax_shell_convection(8, 6, 4)
    ts, _, _ = tbench.build_shell_convection(8, 6, 4, device="cpu")
    for name in ("M", "L"):
        assert np.array_equal(np.asarray(ts._matrices[name]),
                              np.asarray(js._matrices[name]))


def test_shell_convection_step_from_carried_system():
    """tools/carry.py: the JAX solver's dense M, L and state
    (regularity-ordered components, (m, ell) group order; the JAX
    package's b perturbed first, so the carried state is not the port's
    own) installed into a port solver before its first step (SBDF2 keeps
    a history, so both start it together); both step 5 times (1e-12 of
    the state)."""
    js = jax_shell_convection(8, 6, 4)
    ts, dt, _ = tbench.build_shell_convection(8, 6, 4, device="cpu")
    jb = js.problem.namespace["b"]
    noise = np.random.default_rng(5).standard_normal(np.shape(jb["g"]))
    jb["g"] = np.asarray(jb["g"]) + 1e-2 * noise
    X = np.asarray(js.gather_fields())
    assert np.abs(X - ts.gather_fields().numpy()).max() > 1e-4
    carry.install_system(ts, None, {name: np.asarray(js._matrices[name])
                                    for name in ("M", "L")}, X=X)
    for _ in range(5):
        js.step(dt)
        ts.step(dt)
    assert max(state_errors(ts, js).values()) <= RTOL
    assert constraint_residual(ts) < 1e-12


# --------------------------------------------------------- rotconv 16x8x8

@pytest.fixture(scope="module")
def rotconv16():
    js, dt = build_rotconv_ivp(16, 8, 8, np.float64)
    ts, tdt = tbench.build_rotconv(16, 8, 8, device="cpu")
    assert tdt == dt
    return js, ts, dt


def test_rotconv_pencils_equal(rotconv16):
    """The theta-varying cross(ez, u) couples ell in both packages: one
    pencil per m (G = 8, S = 770), M and L np.array_equal — the
    ell-coupled NCC assembly (_sph_coupled_ncc_matrix) and the
    layout-coupled gblocks of every other shell operator."""
    js, ts, _ = rotconv16
    colat = 1
    assert ts.layout.forced_coupled == {colat} == js.layout.forced_coupled
    assert ts.pencil_shape == tuple(js.pencil_shape) == (8, 770)
    assert np.array_equal(ts.valid_row_mask, np.asarray(js.valid_row_mask))
    for name in ("M", "L"):
        a = np.asarray(ts._matrices[name])
        b = np.asarray(js._matrices[name])
        assert np.abs(a - b).max() <= 1e-14
        assert np.array_equal(a, b)


def test_rotconv_trajectory_matches_jax(rotconv16):
    """5 RK222 steps at dt 1e-4: u and T within 1e-12 of the state, the
    algebraic p and taus within ROTCONV_ALGEBRAIC_BOUND (the pencils'
    conditioning, see its comment)."""
    js, ts, dt = rotconv16
    for _ in range(5):
        js.step(dt)
        ts.step(dt)
    errs = state_errors(ts, js)
    for name, err in errs.items():
        bound = RTOL if name in ROTCONV_DYNAMIC else ROTCONV_ALGEBRAIC_BOUND
        assert err <= bound, errs
    assert bool(torch.isfinite(ts.X).all())


# ------------------------------------------------------------ S2 and CFL

def test_sphere_cfl_matches_jax():
    """The S2 arm of the CFL spacing: the same velocity on a sphere in
    both packages gives the same dt (1e-14)."""
    dts = {}
    for d3 in (td3, jd3):
        cs = d3.S2Coordinates("phi", "theta")
        dist = d3.Distributor(cs, dtype=np.float64, **dist_kw(d3))
        sphere = d3.SphereBasis(cs, shape=(16, 8), radius=2.0,
                                dtype=np.float64, dealias=3 / 2)
        u = dist.VectorField(cs, name="u", bases=sphere)
        phi, theta = dist.local_grids(sphere)
        u["g"][0] = np.sin(theta) * (1 + 0.2 * np.cos(phi))
        u["g"][1] = 0.1 * np.sin(2 * theta) * np.sin(phi)
        h = dist.Field(name="h", bases=sphere)
        problem = d3.IVP([h], namespace=locals())
        problem.add_equation("dt(h) = - u@grad(h)")
        solver = problem.build_solver(d3.RK222)
        cfl = d3.CFL(solver, initial_dt=1.0, cadence=1, safety=0.4)
        cfl.add_velocity(u)
        dts[d3] = cfl.compute_timestep()
    assert abs(dts[td3] - dts[jd3]) <= 1e-14 * dts[jd3]


# ------------------------------------------------- the floored-pivot count

@pytest.mark.parametrize("name", ["BatchedLUFactorized", "BatchedInverse",
                                  "BatchedDenseSolve",
                                  "BatchedInverseRefined"])
def test_pivot_count_zero_and_factors_unchanged(name):
    """On nonsingular matrices every dense solver counts no floored
    pivot, and its factors are bit-equal to its plain factor()."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.standard_normal((5, 30, 30)))
    solver = tms.get_solver(name)
    aux, count = solver.factor_counted(A)
    plain = solver.factor(A)
    assert torch.equal(count, torch.zeros(5, dtype=count.dtype))
    flat = [t for t in (aux if isinstance(aux, tuple) else (aux,))]
    ref = [t for t in (plain if isinstance(plain, tuple) else (plain,))]
    assert all(torch.equal(a, b) for a, b in zip(flat, ref))


def test_pivot_count_on_singular_annulus_pencil():
    """The annulus example's m = 0 pencil at 32x16 is singular: at
    dt 0.05 the JAX package's first step is non-finite, while the port's
    count marks that group (and only that group) and its step is finite;
    the count reaches the solver, DenseOps and health.check_values."""
    from dedalus_tpu_torch.tools import health
    from dedalus_tpu_torch.tools.exceptions import SolverHealthError
    from test_torch_annulus import jax_annulus_convection
    js, _ = jax_annulus_convection(32, 16)
    js.step(0.05)
    assert not np.isfinite(np.asarray(js.X)).all()
    ts, _, _ = tbench.build_annulus_convection(32, 16, device="cpu")
    assert ts.floored_pivots is None
    ts.step(0.05)
    counts = ts.floored_pivots
    assert isinstance(counts, torch.Tensor) and counts.shape == (16,)
    assert int(counts[0]) > 0 and int(counts[1:].sum()) == 0
    assert counts is ts.ops.floored_pivots
    assert bool(torch.isfinite(ts.X).all())
    # the count rides check_values' pull into its error
    with pytest.raises(SolverHealthError, match="pivots floored"):
        health.check_values({"x": torch.tensor([np.nan])}, solver=ts)
    # a numerically singular matrix: one row scaled by 1e-30
    A = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, 12, 12)))
    A[1, 4] *= 1e-30
    for name in ("BatchedLUFactorized", "BatchedInverse",
                 "BatchedDenseSolve"):
        _, count = tms.get_solver(name).factor_counted(A)
        assert count.tolist() == [0, 1, 0]


def test_banded_factor_counts_floored_pivots():
    """BandedOps counts its factor's floored pivots per group: zero on
    the banded RB pencils (a nonsingular banded system)."""
    solver, _ = tbench.build_rb_solver(16, 32, np.float64,
                                       matsolver="banded", device="cpu")
    solver.step(1e-3)
    assert solver.ops.kind == "banded"
    counts = solver.floored_pivots
    assert counts.shape == (solver.pencil_shape[0],)
    assert int(counts.sum()) == 0


# ------------------------------------------- the sphere's coupled NCC matrix

def s2_ncc_products(d3):
    """ncc*u and ncc*v on a standalone sphere with a colatitude-varying
    NCC, their layout and per-m subproblems (neither package builds a
    solver for them: the batched walk refuses an NCC varying along a
    sphere basis)."""
    cs = d3.S2Coordinates("phi", "theta")
    dist = d3.Distributor(cs, dtype=np.float64, **dist_kw(d3))
    sphere = d3.SphereBasis(cs, shape=(16, 12), radius=1.0,
                            dtype=np.float64, dealias=3 / 2)
    phi, theta = dist.local_grids(sphere)
    ncc = dist.Field(name="ncc", bases=sphere)
    ncc["g"] = 2 + np.cos(theta) + 0 * phi
    uz = dist.VectorField(cs, name="uz", bases=sphere)
    uz["g"][0] = np.sin(theta) + 0 * phi
    u = dist.Field(name="u", bases=sphere)
    v = dist.VectorField(cs, name="v", bases=sphere)
    problem = d3.LBVP([u, v], namespace=locals())
    problem.add_equation("ncc*u = 0")
    problem.add_equation("ncc*v + uz*u = 0")
    subsystems = sys.modules[d3.__name__.replace(".public", "")
                             + ".core.subsystems"]
    layout = subsystems.PencilLayout(dist, problem.variables,
                                     problem.equations)
    return problem, layout, subsystems.build_subproblems(layout)


def test_s2_coupled_ncc_matrix_matches_jax():
    """_s2_coupled_ncc_matrix (SWSH triple-product couplings, scalar and
    vector operands, and a vector NCC on a scalar operand) per m group
    against the JAX package's, 1e-14 absolute."""
    import importlib
    mats = {}
    for d3 in (td3, jd3):
        importlib.import_module(d3.__name__.replace(".public", "")
                                + ".core.subsystems")
        problem, layout, sps = s2_ncc_products(d3)
        assert layout.sep_axes == [0]
        vars_ = set(problem.variables)
        out = []
        for spx in sps:
            for eq in problem.equations:
                for var, M in eq["L"].expression_matrices(spx,
                                                          vars_).items():
                    out.append(np.asarray(M.toarray()))
        mats[d3] = out
    assert len(mats[td3]) == len(mats[jd3]) == 3 * 8
    for a, b in zip(mats[td3], mats[jd3]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-14
