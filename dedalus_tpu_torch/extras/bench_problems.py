"""
Shared benchmark/test problem builders (counterpart of
dedalus_tpu/extras/bench_problems.py): the 2-D Rayleigh-Benard flagship
configuration (reference: examples/ivp_2d_rayleigh_benard/
rayleigh_benard.py) and the small 2-D nonlinear heat IVP with tau lines.
Both build on `device` (default `cuda`; pass "cpu" to run on the host).
"""

import numpy as np


def build_rb_solver(Nx, Nz, dtype, matsolver=None, device=None):
    import dedalus_tpu_torch.public as d3
    Lx, Lz = 4.0, 1.0
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    xbasis = d3.RealFourier(coords["x"], size=Nx, bounds=(0, Lx), dealias=3 / 2)
    zbasis = d3.ChebyshevT(coords["z"], size=Nz, bounds=(0, Lz), dealias=3 / 2)
    p = dist.Field(name="p", bases=(xbasis, zbasis))
    b = dist.Field(name="b", bases=(xbasis, zbasis))
    u = dist.VectorField(coords, name="u", bases=(xbasis, zbasis))
    tau_p = dist.Field(name="tau_p")
    tau_b1 = dist.Field(name="tau_b1", bases=xbasis)
    tau_b2 = dist.Field(name="tau_b2", bases=xbasis)
    tau_u1 = dist.VectorField(coords, name="tau_u1", bases=xbasis)
    tau_u2 = dist.VectorField(coords, name="tau_u2", bases=xbasis)
    kappa = nu = 2.0e-6 ** 0.5
    x, z = dist.local_grids(xbasis, zbasis)
    ex, ez = coords.unit_vector_fields(dist)
    lift_basis = zbasis.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)  # noqa: E731
    grad_u = d3.grad(u) + ez * lift(tau_u1)
    grad_b = d3.grad(b) + ez * lift(tau_b1)
    problem = d3.IVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2],
                     namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*div(grad_b) + lift(tau_b2) = - u@grad(b)")
    problem.add_equation("dt(u) - nu*div(grad_u) + grad(p) - b*ez + lift(tau_u2) = - u@grad(u)")
    problem.add_equation("b(z=0) = Lz")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("b(z=Lz) = 0")
    problem.add_equation("u(z=Lz) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(d3.RK222, matsolver=matsolver)
    b.fill_random("g", seed=42, distribution="normal", scale=1e-3)
    b["g"] += (Lz - z)
    return solver, b


def build_tau_ivp(Nx=16, Nz=8, cadence=100, matsolver=None,
                  timestepper=None, device=None):
    """2-D nonlinear heat IVP with tau lines (Fourier x Chebyshev).
    Returns (solver, u, x, z)."""
    import dedalus_tpu_torch.public as d3
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    xb = d3.RealFourier(coords["x"], size=Nx, bounds=(0, 4.0), dealias=3 / 2)
    zb = d3.ChebyshevT(coords["z"], size=Nz, bounds=(0, 1.0), dealias=3 / 2)
    u = dist.Field(name="u", bases=(xb, zb))
    t1 = dist.Field(name="t1", bases=xb)
    t2 = dist.Field(name="t2", bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)  # noqa: E731
    problem = d3.IVP([u, t1, t2], namespace=locals())
    problem.add_equation("dt(u) - lap(u) + lift(t1,-1) + lift(t2,-2) = - u*u")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("u(z=1) = 0")
    kw = {"matsolver": matsolver} if matsolver else {}
    solver = problem.build_solver(timestepper or d3.RK222,
                                  enforce_real_cadence=cadence, **kw)
    x, z = dist.local_grids(xb, zb)
    u["g"] = np.sin(np.pi * z) * (1 + 0.3 * np.cos(np.pi * x / 2))
    return solver, u, x, z
