"""
Two coupled axes in the port's banded path, held against the JAX package
on the CPU: the cases of tests/test_two_coupled.py, with its bounds.

  * The Chebyshev x Chebyshev Poisson rectangle (tau lines on both axes)
    has a singular L: its four corner modes. The port's banded factor
    formed the Woodbury capacitance's explicit inverse, which spreads
    the singular capacitance's 1/eps entries over every component (3e-3
    off at 24x24 and 48x48); it now keeps the capacitance's LU, as the
    JAX package's `factor` does (dedalus_tpu/libraries/pencilops.py:925),
    and counts the singular capacitance's pivots among the floored ones.
    Dense at 24x24 to 1e-8 of exact; banded at 48x48 to 1e-7 of exact,
    1e-8 of the dense path and 1e-12 of max |u| from the JAX package's
    banded answer (measured 1.9e-15, 1.7e-16 and 2.1e-15), with 4 floored
    pivots as the dense path counts; 128x128 under 'auto' with
    BANDED_MAX_DIAGS = 768 banded (q = 528), its band store under 1/20
    of dense, 1e-8 of exact (measured 1.3e-13; the port alone: the JAX
    package's own test covers its side).
  * The shell's theta-NCC diffusion IVP (ell x r coupled pencils) and
    the Coriolis IVP in f64, forced banded against the port's dense path
    at the reference's bounds (1e-11 and 1e-10 of the state), and the
    banded run against the JAX package's dense run after the same steps
    at the same bounds. The sizes are cut to keep the file near 35 s on
    one core: the theta-NCC shell from 8x40x24 to 8x40x16, the Coriolis
    shell from 8x40x16 to 8x24x8.
  * The Coriolis shell in f32, dense, within 1e-2 of max|u| of the f64
    state and of the JAX package's f32 run, with the f64 factor's count
    of floored pivots (the f32 pivot floor's repair).
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.extras import bench_problems as tbench
from dedalus_tpu_torch.libraries.pencilops import BandedOps
from dedalus_tpu_torch.tools.config import config

torch.set_num_threads(1)


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def poisson_rect(d3, Nx, Nz, matsolver):
    """tests/test_two_coupled.py:21 _build_poisson_rect."""
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    xb = d3.ChebyshevT(coords["x"], size=Nx, bounds=(0, 1))
    zb = d3.ChebyshevT(coords["z"], size=Nz, bounds=(0, 1))
    x, z = dist.local_grids(xb, zb)
    u = dist.Field(name="u", bases=(xb, zb))
    tx1 = dist.Field(name="tx1", bases=zb)
    tx2 = dist.Field(name="tx2", bases=zb)
    tz1 = dist.Field(name="tz1", bases=xb)
    tz2 = dist.Field(name="tz2", bases=xb)
    u_ex = np.sin(np.pi * x) * np.sin(np.pi * z) * np.exp(x)
    rhs = dist.Field(name="rhs", bases=(xb, zb))
    rhs["g"] = (np.exp(x) * np.sin(np.pi * z)
                * ((1 - np.pi ** 2) * np.sin(np.pi * x)
                   + 2 * np.pi * np.cos(np.pi * x))
                - np.pi ** 2 * np.sin(np.pi * x) * np.sin(np.pi * z)
                * np.exp(x))
    liftx = lambda A, n: d3.Lift(A, xb.derivative_basis(2), n)
    liftz = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)
    problem = d3.LBVP([u, tx1, tx2, tz1, tz2], namespace=locals())
    problem.add_equation("lap(u) + liftx(tx1,-1) + liftx(tx2,-2)"
                         " + liftz(tz1,-1) + liftz(tz2,-2) = rhs")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation("u(x=1) = 0")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("u(z=1) = 0")
    solver = problem.build_solver(matsolver=matsolver)
    return solver, u, u_ex


def test_poisson_rectangle_dense():
    solver, u, u_ex = poisson_rect(td3, 24, 24, "dense")
    solver.solve()
    assert np.abs(np.asarray(u["g"]) - u_ex).max() < 1e-8


def test_poisson_rectangle_banded_matches_dense_and_jax():
    solver_d, u_d, u_ex = poisson_rect(td3, 48, 48, "dense")
    solver_d.solve()
    ref = np.array(u_d["g"])
    solver_b, u_b, _ = poisson_rect(td3, 48, 48, "banded")
    assert isinstance(solver_b.ops, BandedOps), solver_b._banded_reason
    st = solver_b.structure
    assert (st.S, st.t_pins, st.kl, st.ku, st.q) == (2496, 192, 201, 196,
                                                      208)
    solver_b.solve()
    sol = np.array(u_b["g"])
    assert np.abs(sol - u_ex).max() < 1e-7
    assert np.abs(sol - ref).max() < 1e-8
    solver_j, u_j, _ = poisson_rect(jd3, 48, 48, "banded")
    solver_j.solve()
    ju = np.asarray(u_j["g"])
    assert np.abs(sol - ju).max() <= 1e-12 * np.abs(ju).max()


def test_singular_two_coupled_pencil_counts_floored_pivots(caplog):
    """A singular L over a nonsingular pinned base: the banded factor
    counts the capacitance's floored pivots as the dense factor counts
    L's (four corner modes), the pin repair leaves the base alone (its
    own count stays 0), and the build logs the warning."""
    solver_d, _, _ = poisson_rect(td3, 24, 24, "dense")
    with caplog.at_level("WARNING"):
        solver_b, _, _ = poisson_rect(td3, 24, 24, "banded")
    assert int(solver_d.floored_pivots.sum()) == 4
    assert int(solver_b.floored_pivots.sum()) == 4
    assert int(solver_b.ops.base_floored_pivots.sum()) == 0
    assert solver_b.structure.pin_swaps == 0
    assert any("below the floor" in r.message for r in caplog.records)


def test_poisson_rectangle_banded_at_scale():
    """128^2 under 'auto' with BANDED_MAX_DIAGS = 768: banded (dense
    would be (1, S, S) ~ 2.3 GB), the band store under 1/20 of dense, to
    spectral accuracy."""
    old = config["linear algebra"].get("BANDED_MAX_DIAGS", "384")
    config["linear algebra"]["BANDED_MAX_DIAGS"] = "768"
    try:
        solver, u, u_ex = poisson_rect(td3, 128, 128, "auto")
    finally:
        config["linear algebra"]["BANDED_MAX_DIAGS"] = old
    assert isinstance(solver.ops, BandedOps), solver._banded_reason
    st = solver.structure
    assert st.q == 528
    band_bytes = sum(v["bands"].nbytes for v in solver._matrices.values())
    assert band_bytes < st.S * st.S * 8 / 20
    solver.solve()
    assert np.abs(np.asarray(u["g"]) - u_ex).max() < 1e-8


def shell_theta_ncc(d3, matsolver, Nr=16):
    """tests/test_two_coupled.py:69: shell diffusion with a theta-varying
    conductivity NCC (ell x r coupled pencils), SBDF2, 5 steps."""
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    shell = d3.ShellBasis(coords, shape=(8, 40, Nr), radii=(0.5, 1.5),
                          dtype=np.float64)
    phi, theta, r = dist.local_grids(shell)
    T = dist.Field(name="T", bases=shell)
    tau1 = dist.Field(name="tau1", bases=shell.outer_surface)
    tau2 = dist.Field(name="tau2", bases=shell.outer_surface)
    kap = dist.Field(name="kap", bases=shell.meridional_basis)
    kap["g"] = 1.0 + 0.4 * np.cos(theta) + 0.2 * r * np.cos(theta) ** 2
    lift_basis = shell.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)
    rvec = dist.VectorField(coords, bases=shell.meridional_basis)
    rvec["g"][2] = np.broadcast_to(r, rvec["g"][2].shape)
    grad_T = d3.grad(T) + rvec * lift(tau1)
    problem = d3.IVP([T, tau1, tau2], namespace=locals())
    problem.add_equation("dt(T) - div(kap*grad_T) + lift(tau2) = 0")
    problem.add_equation("T(r=0.5) = 0")
    problem.add_equation("T(r=1.5) = 0")
    solver = problem.build_solver(d3.SBDF2, matsolver=matsolver)
    T["g"] = (np.sin(np.pi * (r - 0.5))
              * (1 + 0.3 * np.cos(theta)
                 + 0.2 * np.sin(theta) * np.cos(phi)))
    for _ in range(5):
        solver.step(2e-3)
    return solver, np.array(T["g"])


def test_shell_theta_ncc_ivp_banded_matches_dense():
    s_b, sol = shell_theta_ncc(td3, "banded")
    assert isinstance(s_b.ops, BandedOps), s_b._banded_reason
    _, ref = shell_theta_ncc(td3, "dense")
    _, jref = shell_theta_ncc(jd3, "dense")
    assert np.isfinite(sol).all()
    assert np.abs(sol - ref).max() < 1e-11 * max(np.abs(ref).max(), 1.0)
    assert np.abs(sol - jref).max() <= 1e-12 * np.abs(jref).max()


def shell_coriolis(d3, dtype, matsolver, Ntheta=24, Nr=8):
    """tests/test_two_coupled.py:127: the Coriolis-dominant shell IVP
    (1/Ekman = 1e3), RK222, 4 steps from seeded random data."""
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=dtype, **dist_kw(d3))
    shell = d3.ShellBasis(coords, shape=(8, Ntheta, Nr), radii=(0.35, 1.0),
                          dtype=dtype)
    sphere = shell.outer_surface
    phi, theta, r = dist.local_grids(shell)
    u = dist.VectorField(coords, name="u", bases=shell)
    p = dist.Field(name="p", bases=shell)
    tau_u1 = dist.VectorField(coords, name="tau_u1", bases=sphere)
    tau_u2 = dist.VectorField(coords, name="tau_u2", bases=sphere)
    tau_p = dist.Field(name="tau_p")
    Ekman = 1e-3
    rvec = dist.VectorField(coords, name="rvec",
                            bases=shell.meridional_basis)
    rvec["g"][2] = np.broadcast_to(r, rvec["g"][2].shape)
    ez = dist.VectorField(coords, name="ez", bases=shell.meridional_basis)
    ez["g"][1] = -np.sin(theta)
    ez["g"][2] = np.cos(theta)
    lift_basis = shell.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)
    grad_u = d3.grad(u) + rvec * lift(tau_u1)
    problem = d3.IVP([p, u, tau_u1, tau_u2, tau_p], namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation(
        "dt(u) + (1/Ekman)*cross(ez, u) + grad(p) - div(grad_u)"
        " + lift(tau_u2) = 0")
    problem.add_equation("u(r=0.35) = 0")
    problem.add_equation("u(r=1.0) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(d3.RK222, matsolver=matsolver)
    rng = np.random.default_rng(11)
    u["g"] = 1e-3 * rng.standard_normal(u["g"].shape)
    for _ in range(4):
        solver.step(1e-4)
    return solver, np.array(u["g"])


def test_shell_coriolis_ivp_banded_matches_dense():
    """Banded against dense at the reference's f64 bound (1e-10, scaled
    by max(|ref|, 1)), and the port's banded run against the JAX
    package's banded run (the same structure and sweeps) to 1e-12 of
    max |u| (measured 1.2e-13). Two different factorizations of these
    pencils are compared only at the reference's bound: at 1/Ekman = 1e3
    they spread over ~1e-10 of the state (the JAX package's own banded
    and dense runs differ by 7.9e-11 of max |u|, its dense run and the
    port's by 1.4e-11)."""
    s_b, sol = shell_coriolis(td3, np.float64, "banded")
    assert isinstance(s_b.ops, BandedOps), s_b._banded_reason
    _, ref = shell_coriolis(td3, np.float64, "dense")
    _, jsol = shell_coriolis(jd3, np.float64, "banded")
    assert np.isfinite(sol).all()
    assert np.abs(sol - ref).max() < 1e-10 * max(np.abs(ref).max(), 1.0)
    assert np.abs(sol - jsol).max() <= 1e-12 * np.abs(jsol).max()


def test_shell_coriolis_f32_dense_matches_f64():
    """The Coriolis shell in f32, dense, at 8x24x8: its pencils (condition
    ~1e9) have legitimate pivots at 6.4e-9 of max|LU|, under the old f32
    floor S eps32 max|LU| (2.2e-4 max|LU|), which raised 2199 of them and
    left the state 4.5 max|u| off the f64 one. The floor now also needs a
    pivot under COLUMN_ULPS eps of its column (libraries/matsolvers.py):
    the f32 factor floors as many pivots as the f64 factor (none), the
    state lands within 1e-2 max|u| of the port's f64 state (measured
    3.7e-3; the JAX package's dense f32 run is 2.7e-3 off it) and within
    1e-2 max|u| of the JAX package's dense f32 run (measured 4.3e-3:
    two f32 factorizations of these pencils, each ~3e-3 from f64)."""
    s64, ref = shell_coriolis(td3, np.float64, "dense")
    s32, sol = shell_coriolis(td3, np.float32, "dense")
    _, jsol = shell_coriolis(jd3, np.float32, "dense")
    scale = np.abs(ref).max()
    assert np.isfinite(sol).all()
    assert np.abs(sol - ref).max() <= 1e-2 * scale
    assert np.abs(sol - jsol).max() <= 1e-2 * scale
    assert s32.floored_pivots.tolist() == s64.floored_pivots.tolist()


def test_shell_coriolis_f32_banded_pivot_count():
    """The banded factor's count of floored pivots at f32 takes the same
    column test: the f32 Coriolis shell's banded factor counts what its
    f64 factor counts (none), where the old f32 threshold reported
    482-566 per group. (The banded f32 state itself diverges in both
    packages at this size, ROADMAP queue 3.)"""
    counts = {}
    for dtype in (np.float64, np.float32):
        solver, _ = shell_coriolis(td3, dtype, "banded")
        assert isinstance(solver.ops, BandedOps), solver._banded_reason
        counts[dtype] = solver.floored_pivots.tolist()
    assert counts[np.float32] == counts[np.float64]


def test_bench_builder_matches_the_test():
    """extras/bench_problems.build_poisson_rect (the card's phase 24)
    is this rectangle: the same banded solution bit for bit at 24x24."""
    solver, u, _ = poisson_rect(td3, 24, 24, "banded")
    solver.solve()
    bsolver, bu, _ = tbench.build_poisson_rect(24, "banded", device="cpu")
    bsolver.solve()
    assert np.array_equal(np.array(bu["g"]), np.array(u["g"]))
