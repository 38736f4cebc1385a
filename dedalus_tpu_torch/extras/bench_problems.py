"""
Shared benchmark/test problem builders (counterpart of
dedalus_tpu/extras/bench_problems.py): the 1-D forced nonlinear heat IVP,
the progression's KdV-Burgers and shear-flow IVPs (the JAX package's
benchmarks/progression.py build_kdv/build_shear), the 2-D Rayleigh-Benard
flagship configuration (reference:
examples/ivp_2d_rayleigh_benard/rayleigh_benard.py), the small 2-D
nonlinear heat IVP with tau lines, and the boundary and eigenvalue
problems of the JAX package's examples and tests: the Poisson LBVP
(examples/poisson.py, real or on a complex ComplexFourier carrier), the Bratu and sin-Jacobi NLBVPs, the
Rayleigh-Benard onset EVP (examples/rayleigh_benard_evp.py) and the
waves-on-a-string EVP (examples/waves_on_a_string.py); and the
progression's sphere shallow-water IVP (benchmarks/progression.py
build_shallow_water, with the balanced-height LBVP of
examples/shallow_water.py), the 3-D Rayleigh-Benard IVP of the
progression's config 5 (benchmarks/progression.py build_rb3d), a
complex ComplexFourier x ChebyshevT IVP with a quadratic term, and the
polar examples: centrifugal convection in an annulus
(examples/centrifugal_convection.py) and the librating disk
(examples/libration.py); and the shell: Boussinesq convection in a
spherical shell (examples/shell_convection.py), the progression's
rotating shell convection (benchmarks/progression.py build_rotconv_ivp)
and the rotating-convection onset EVP on a complex shell
(examples/rotating_convection.py); and the ball: internally heated
convection (examples/internally_heated_convection.py) and the Lane-Emden
NLBVP (examples/lane_emden.py); and the cylinder: flow in a periodic pipe
(the equations of the JAX package's tests/test_cylinder.py:305), heat
diffusion in a periodic cylinder (examples/cylinder_diffusion.py), a
Poisson LBVP in a cylindrical annulus and the pipe flow's
linear-stability EVP (examples/pipe_flow.py); and the two ensemble fleets
of the JAX package's benchmarks/ensemble.py (the forced heat equation and
RB 256x64, each with its member initial conditions); and the coupled
pencils: an azimuthally varying annulus NCC (LBVP and IVP) and disk NCC,
the disk Poisson under matrix_coupling, the Chebyshev x Chebyshev
Poisson rectangle (two coupled axes) and a joint f(x, z) NCC.
Each builds on `device` (default `cuda`; pass "cpu" to run on the host).
"""

import numpy as np


def build_diffusion_solver(size=64, dtype=np.float64, device=None):
    """1-D forced nonlinear heat IVP (SBDF2, dense pencil path): parameter
    field `a`, forcing `f`, and a Burgers term, so the dealiased transform
    chain and the multistep histories are both exercised."""
    import dedalus_tpu_torch.public as d3
    xc = d3.Coordinate("x")
    dist = d3.Distributor(xc, dtype=dtype, device=device)
    xb = d3.RealFourier(xc, size=size, bounds=(0, 2 * np.pi))
    u = dist.Field(name="u", bases=xb)
    a = dist.Field(name="a", bases=xb)
    f = dist.Field(name="f", bases=xb)
    dx = lambda A: d3.Differentiate(A, xc)  # noqa: E731
    problem = d3.IVP([u], namespace={"u": u, "a": a, "f": f,
                                     "lap": d3.lap, "dx": dx})
    problem.add_equation("dt(u) - lap(u) = a*u + f - u*dx(u)")
    x = dist.local_grid(xb)
    u["g"] = np.sin(3 * x)
    a["g"] = 0.1 * np.cos(x)
    f["g"] = 0.05 * np.sin(2 * x)
    return problem.build_solver(d3.SBDF2, warmup_iterations=2,
                                enforce_real_cadence=0)


def build_diffusion_ensemble(size=64, device=None):
    """The dispatch-bound fleet of the JAX package's benchmarks/ensemble.py
    (`build_diffusion`, :61): the 1-D forced heat IVP dt(u) - lap(u) =
    a*u on RealFourier(size), SBDF2, dense, with a per-member parameter
    field `a`. Returns (solver, member_init): member i starts from
    u = sin((1 + i mod 4) x) with a = 0.1 (1 + i mod 7) cos(x)."""
    import dedalus_tpu_torch.public as d3
    xc = d3.Coordinate("x")
    dist = d3.Distributor(xc, dtype=np.float64, device=device)
    xb = d3.RealFourier(xc, size=size, bounds=(0, 2 * np.pi))
    u = dist.Field(name="u", bases=xb)
    a = dist.Field(name="a", bases=xb)
    problem = d3.IVP([u], namespace={"u": u, "a": a, "lap": d3.lap})
    problem.add_equation("dt(u) - lap(u) = a*u")
    solver = problem.build_solver(d3.SBDF2, warmup_iterations=2,
                                  enforce_real_cadence=0)
    x = dist.local_grid(xb)

    def member_init(i):
        u["g"] = np.sin((1 + i % 4) * x)
        a["g"] = 0.1 * (1 + i % 7) * np.cos(x)

    return solver, member_init


def build_rb_ensemble(Nx=256, Nz=64, matsolver="banded", device=None):
    """The flagship fleet of the JAX package's benchmarks/ensemble.py
    (`build_rb`, :84): `build_rb_solver(Nx, Nz)` in f64, RK222 (banded
    here: G = 128, q = 32, NB = 17 at 256x64), warmup 2. Returns (solver,
    member_init): member i's buoyancy is seeded noise (seed 100 + i,
    scale 1e-3) on the conductive profile 1 - z."""
    solver, b = build_rb_solver(Nx, Nz, np.float64, matsolver=matsolver,
                                device=device)
    solver.warmup_iterations = 2
    z = b.dist.local_grids(*b.domain.bases)[1]

    def member_init(i):
        b.fill_random("g", seed=100 + i, distribution="normal", scale=1e-3)
        b["g"] += (1.0 - z)

    return solver, member_init


def build_kdv_solver(N, dtype=np.float64, device=None):
    """1-D KdV-Burgers (RealFourier N, dealias 3/2, SBDF2; reference:
    examples/ivp_1d_kdv_burgers). Returns (solver, dt)."""
    import dedalus_tpu_torch.public as d3
    xcoord = d3.Coordinate("x")
    dist = d3.Distributor(xcoord, dtype=dtype, device=device)
    xbasis = d3.RealFourier(xcoord, size=N, bounds=(0, 10), dealias=3 / 2)
    u = dist.Field(name="u", bases=xbasis)
    a, b = 1e-4, 2e-4
    dx = lambda A: d3.Differentiate(A, xcoord)  # noqa: E731
    problem = d3.IVP([u], namespace=locals())
    problem.add_equation("dt(u) - a*dx(dx(u)) - b*dx(dx(dx(u))) = - u*dx(u)")
    solver = problem.build_solver(d3.SBDF2)
    x = dist.local_grids(xbasis)[0]
    n = 20
    u["g"] = np.log(1 + np.cosh(n) ** 2 / np.cosh(n * (x - 3)) ** 2) / (2 * n)
    return solver, 2e-3


def build_shear_solver(N, dtype=np.float64, device=None):
    """2-D doubly periodic shear flow with a passive tracer (RealFourier^2
    N x N, dealias 3/2, RK222; reference: examples/ivp_2d_shear_flow).
    Returns (solver, dt), dt = 0.25 / N."""
    import dedalus_tpu_torch.public as d3
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    xbasis = d3.RealFourier(coords["x"], size=N, bounds=(0, 1), dealias=3 / 2)
    zbasis = d3.RealFourier(coords["z"], size=N, bounds=(-1, 1), dealias=3 / 2)
    p = dist.Field(name="p", bases=(xbasis, zbasis))
    s = dist.Field(name="s", bases=(xbasis, zbasis))
    u = dist.VectorField(coords, name="u", bases=(xbasis, zbasis))
    tau_p = dist.Field(name="tau_p")
    nu = 1 / 5e4
    D = nu
    x, z = dist.local_grids(xbasis, zbasis)
    problem = d3.IVP([u, s, p, tau_p], namespace=locals())
    problem.add_equation("dt(u) + grad(p) - nu*lap(u) = - u@grad(u)")
    problem.add_equation("dt(s) - D*lap(s) = - u@grad(s)")
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("integ(p) = 0")
    ug = np.zeros((2,) + np.broadcast_shapes((N, 1), (1, N)))
    ug[0] = 1 / 2 + 1 / 2 * (np.tanh((z - 0.5) / 0.1) - np.tanh((z + 0.5) / 0.1))
    ug[1] = (0.1 * np.sin(2 * np.pi * x) * np.exp(-(z - 0.5) ** 2 / 0.01)
             + 0.1 * np.sin(2 * np.pi * x) * np.exp(-(z + 0.5) ** 2 / 0.01))
    u["g"] = ug
    s["g"] = ug[0]
    solver = problem.build_solver(d3.RK222)
    # CFL-stable fixed step (u ~ 1, dx = 1/N, safety ~ 0.25)
    return solver, 0.25 / N


def build_rb_solver(Nx, Nz, dtype, matsolver=None, device=None,
                    timestepper="RK222", **solver_kw):
    """2-D Rayleigh-Benard convection (the JAX package's
    extras/bench_problems.py build_rb_solver). `solver_kw` goes to
    build_solver (metrics, health, their cadences, ...). Returns
    (solver, b)."""
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
    solver = problem.build_solver(getattr(d3, timestepper),
                                  matsolver=matsolver, **solver_kw)
    b.fill_random("g", seed=42, distribution="normal", scale=1e-3)
    b["g"] += (Lz - z)
    return solver, b


def build_rb3d(Nx, Ny, Nz, dtype, matsolver=None, device=None):
    """3-D Rayleigh-Benard convection (the JAX package's
    benchmarks/progression.py:91 build_rb3d, BASELINE config 5's one-card
    variant rb3d_128 at 128x128x64): RealFourier(x) x RealFourier(y) on
    (0, 4) with dealias 3/2 and ChebyshevT(z) on (0, 1), kappa = nu =
    (2e-6)^(1/2), RK222, buoyancy from normal noise of seed 42 (scale
    1e-3) plus 1 - z. Returns (solver, dt), dt = 1e-3."""
    import dedalus_tpu_torch.public as d3
    coords = d3.CartesianCoordinates("x", "y", "z")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    xb = d3.RealFourier(coords["x"], size=Nx, bounds=(0, 4.0), dealias=3 / 2)
    yb = d3.RealFourier(coords["y"], size=Ny, bounds=(0, 4.0), dealias=3 / 2)
    zb = d3.ChebyshevT(coords["z"], size=Nz, bounds=(0, 1.0), dealias=3 / 2)
    p = dist.Field(name="p", bases=(xb, yb, zb))
    b = dist.Field(name="b", bases=(xb, yb, zb))
    u = dist.VectorField(coords, name="u", bases=(xb, yb, zb))
    tau_p = dist.Field(name="tau_p")
    tau_b1 = dist.Field(name="tau_b1", bases=(xb, yb))
    tau_b2 = dist.Field(name="tau_b2", bases=(xb, yb))
    tau_u1 = dist.VectorField(coords, name="tau_u1", bases=(xb, yb))
    tau_u2 = dist.VectorField(coords, name="tau_u2", bases=(xb, yb))
    kappa = nu = 2.0e-6 ** 0.5
    x, y, z = dist.local_grids(xb, yb, zb)
    ex, ey, ez = coords.unit_vector_fields(dist)
    lift_basis = zb.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)  # noqa: E731
    grad_u = d3.grad(u) + ez * lift(tau_u1)
    grad_b = d3.grad(b) + ez * lift(tau_b1)
    problem = d3.IVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2],
                     namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*div(grad_b) + lift(tau_b2) = - u@grad(b)")
    problem.add_equation(
        "dt(u) - nu*div(grad_u) + grad(p) - b*ez + lift(tau_u2) = - u@grad(u)")
    problem.add_equation("b(z=0) = 1")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("b(z=1) = 0")
    problem.add_equation("u(z=1) = 0")
    problem.add_equation("integ(p) = 0")
    kw = {"matsolver": matsolver} if matsolver else {}
    solver = problem.build_solver(d3.RK222, **kw)
    b.fill_random("g", seed=42, distribution="normal", scale=1e-3)
    b["g"] += (1 - z)
    return solver, 1e-3


def build_tau_ivp(Nx=16, Nz=8, cadence=100, matsolver=None,
                  timestepper=None, device=None):
    """2-D nonlinear heat IVP with tau lines (Fourier x Chebyshev), SBDF2
    and the configured matsolver unless given. Returns (solver, u, x, z)."""
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
    solver = problem.build_solver(timestepper or d3.SBDF2,
                                  enforce_real_cadence=cadence, **kw)
    x, z = dist.local_grids(xb, zb)
    u["g"] = np.sin(np.pi * z) * (1 + 0.3 * np.cos(np.pi * x / 2))
    return solver, u, x, z


def build_complex_ivp(Nx, Nz, matsolver=None, device=None):
    """A complex128 IVP with a quadratic term on ComplexFourier(x) x
    ChebyshevT(z) over (0, 4) x (0, 1), dealias 3/2: dt(b) - lap(b) +
    lift(t1, -1) + lift(t2, -2) = -b*b, b(z=0) = b(z=1) = 0, RK222, from
    b = sin(pi z) (1/2 + 0.3 e^(i pi x / 2) + 0.2i cos(pi x)). Its pencils
    are complex (one mode each) and, banded, q = 3 with 2 pins, so the
    banded path runs the complex substitution in every stage solve.
    Returns (solver, dt), dt = 1e-3."""
    import dedalus_tpu_torch.public as d3
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.complex128, device=device)
    xb = d3.ComplexFourier(coords["x"], size=Nx, bounds=(0, 4.0),
                           dealias=3 / 2)
    zb = d3.ChebyshevT(coords["z"], size=Nz, bounds=(0, 1.0), dealias=3 / 2)
    b = dist.Field(name="b", bases=(xb, zb))
    t1 = dist.Field(name="t1", bases=xb)
    t2 = dist.Field(name="t2", bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)  # noqa: E731
    problem = d3.IVP([b, t1, t2], namespace=locals())
    problem.add_equation("dt(b) - lap(b) + lift(t1,-1) + lift(t2,-2) = - b*b")
    problem.add_equation("b(z=0) = 0")
    problem.add_equation("b(z=1) = 0")
    kw = {"matsolver": matsolver} if matsolver else {}
    solver = problem.build_solver(d3.RK222, **kw)
    x, z = dist.local_grids(xb, zb)
    b["g"] = np.sin(np.pi * z) * (0.5 + 0.3 * np.exp(0.5j * np.pi * x)
                                  + 0.2j * np.cos(np.pi * x))
    return solver, 1e-3


def build_poisson_solver(Nx, Ny, matsolver=None, device=None,
                         dtype=np.float64):
    """2-D Poisson LBVP of examples/poisson.py (reference:
    examples/lbvp_2d_poisson): lap(u) = f, u(y=0) = g, dy(u)(y=Ly) = h on
    Fourier(Nx) x ChebyshevT(Ny) over (0, 2 pi) x (0, pi), f random
    from seed 40 low-passed to (Nx/4, Ny/4) modes, g = 0.025 sin(8x),
    h = 0. A complex `dtype` takes the ComplexFourier carrier, whose
    pencils are complex (a banded solve runs the complex substitution).
    Returns (solver, fields) with fields {u, tau_1, tau_2, f, g, h}; the
    solver is built, not yet solved."""
    import dedalus_tpu_torch.public as d3
    Lx, Ly = 2 * np.pi, np.pi
    coords = d3.CartesianCoordinates("x", "y")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    xbasis = d3.Fourier(coords["x"], size=Nx, bounds=(0, Lx), dtype=dtype)
    ybasis = d3.ChebyshevT(coords["y"], size=Ny, bounds=(0, Ly))
    u = dist.Field(name="u", bases=(xbasis, ybasis))
    tau_1 = dist.Field(name="tau_1", bases=xbasis)
    tau_2 = dist.Field(name="tau_2", bases=xbasis)
    x, y = dist.local_grids(xbasis, ybasis)
    f = dist.Field(name="f", bases=(xbasis, ybasis))
    g = dist.Field(name="g", bases=xbasis)
    h = dist.Field(name="h", bases=xbasis)
    f.fill_random("g", seed=40)
    f.low_pass_filter(shape=(Nx // 4, Ny // 4))
    g["g"] = np.sin(8 * x) * 0.025
    h["g"] = 0
    dy = lambda A: d3.Differentiate(A, coords["y"])  # noqa: E731
    lift_basis = ybasis.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)  # noqa: E731
    problem = d3.LBVP([u, tau_1, tau_2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau_1,-1) + lift(tau_2,-2) = f")
    problem.add_equation("u(y=0) = g")
    problem.add_equation("dy(u)(y=Ly) = h")
    kw = {"matsolver": matsolver} if matsolver else {}
    solver = problem.build_solver(**kw)
    fields = {"u": u, "tau_1": tau_1, "tau_2": tau_2, "f": f, "g": g,
              "h": h}
    return solver, fields


def bratu_theta(lam):
    """theta of the lower-branch Bratu solution: the fixed point of
    theta = sqrt(2 lam) cosh(theta / 4) (a contraction there for lam
    below the fold at ~3.51)."""
    theta = 0.0
    for _ in range(200):
        theta = np.sqrt(2 * lam) * np.cosh(theta / 4)
    return theta


def bratu_exact(x, lam=1.0):
    """The closed-form lower-branch solution of u'' + lam e^u = 0,
    u(0) = u(1) = 0: u = -2 ln[cosh((x - 1/2) theta / 2) / cosh(theta / 4)]."""
    theta = bratu_theta(lam)
    return -2 * np.log(np.cosh((x - 0.5) * theta / 2) / np.cosh(theta / 4))


def build_bratu_solver(N, lam=1.0, device=None):
    """The Bratu NLBVP u'' + lam exp(u) = 0 with u(0) = u(1) = 0 on
    ChebyshevT(N) over (0, 1), two taus lifted to the second derivative
    basis, from u = 0. Returns (solver, u, x) with x the grid."""
    import dedalus_tpu_torch.public as d3
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
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
    return problem.build_solver(), u, x


def build_sin_jacobi_solver(N, dealias=1, device=None):
    """The NLBVP of the JAX package's tests/test_nlbvp.py:12: dx(u)^2 +
    u^2 = 1, u(0) = 1 on ChebyshevT(N) over (0, 1), from u = 1 - x/2; its
    solution is cos(x). Returns (solver, u, x)."""
    import dedalus_tpu_torch.public as d3
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    xb = d3.ChebyshevT(coords["x"], size=N, bounds=(0, 1), dealias=dealias)
    x, = dist.local_grids(xb)
    u = dist.Field(name="u", bases=xb)
    tau = dist.Field(name="tau")
    dx = lambda A: d3.Differentiate(A, coords["x"])  # noqa: E731
    lift = lambda A: d3.Lift(A, xb.derivative_basis(1), -1)  # noqa: E731
    problem = d3.NLBVP([u, tau], namespace=locals())
    problem.add_equation("dx(u)**2 + u**2 + lift(tau) = 1")
    problem.add_equation("u(x=0) = 1")
    solver = problem.build_solver()
    u["g"] = 1 - x / 2
    return solver, u, x


def build_rb_evp(Nz, kx, Ra, Pr=1, device=None):
    """The no-slip Rayleigh-Benard onset EVP of
    examples/rayleigh_benard_evp.py's max_growth_rate (reference:
    examples/evp_1d_rayleigh_benard): complex128, a ComplexFourier(4)
    carrier whose k=+1 group is the wavenumber kx, ChebyshevT(Nz) over
    (0, 1), dt -> -1j*omega. Returns (solver, fields); the growth rates
    are the imaginary parts of omega of group (1, None)."""
    import dedalus_tpu_torch.public as d3
    Lz, Nx = 1, 4
    Lx = 2 * np.pi / kx
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.complex128, device=device)
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
    fields = {"p": p, "b": b, "u": u, "omega": omega}
    return problem.build_solver(), fields


def build_waves_evp(N, device=None):
    """The clamped-string EVP of examples/waves_on_a_string.py (reference:
    examples/evp_1d_waves_on_a_string): s*u + dx(dx(u)) = 0, u(0) =
    u(1) = 0 on Legendre(N), complex128, first-order tau reduction. The
    eigenvalues are s_n = (n pi)^2. Returns (solver, u)."""
    import dedalus_tpu_torch.public as d3
    Lx = 1
    xcoord = d3.Coordinate("x")
    dist = d3.Distributor(xcoord, dtype=np.complex128, device=device)
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
    return problem.build_solver(), u


def build_shallow_water(Nphi, Ntheta, dtype, matsolver=None, balance=True,
                        device=None):
    """
    Rotating shallow water on the sphere (the Galewsky et al. 2004
    unstable jet; the JAX package's benchmarks/progression.py:133
    build_shallow_water, reference: examples/ivp_sphere_shallow_water/
    shallow_water.py): SphereBasis (Nphi, Ntheta), dealias 3/2, RK222,
    nondimensional units R = 1, hour = 1 (raw SI units put the
    hyperdiffusion entries at the f32 denormal boundary). The Coriolis
    term MulCosine(Skew(u)) couples ell +- 1 within each m group.

    With `balance` the height starts from the balanced-height LBVP of
    examples/shallow_water.py:53-61, g lap(h) + c = -div(u@grad(u) +
    2 Omega zcross(u)), ave(h) = 0, solved once, before the perturbation
    is added; without it h is the perturbation alone, as the JAX builder
    sets it. Returns (solver, dt, balance_solver): dt is 300 s in
    simulation units; balance_solver is the solved LBVP (None without
    `balance`).
    """
    import dedalus_tpu_torch.public as d3
    meter = 1 / 6.37122e6
    hour = 1
    second = hour / 3600
    R = 6.37122e6 * meter
    Omega = 7.292e-5 / second
    nu = 1e5 * meter ** 2 / second / 32 ** 2  # hyperdiffusion matched at ell=32
    g = 9.80616 * meter / second ** 2
    H = 1e4 * meter
    coords = d3.S2Coordinates("phi", "theta")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    basis = d3.SphereBasis(coords, shape=(Nphi, Ntheta), dtype=dtype,
                           radius=R, dealias=3 / 2)
    u = dist.VectorField(coords, name="u", bases=basis)
    h = dist.Field(name="h", bases=basis)
    zcross = lambda A: d3.MulCosine(d3.Skew(A))  # noqa: E731
    phi, theta = dist.local_grids(basis)
    lat = np.pi / 2 - theta + 0 * phi
    umax = 80 * meter / second  # reference: shallow_water.py:44
    lat0, lat1 = np.pi / 7, np.pi / 2 - np.pi / 7
    en = np.exp(-4 / (lat1 - lat0) ** 2)
    jet = (lat0 <= lat) * (lat <= lat1)
    u_jet = umax / en * np.exp(1 / ((lat[jet] - lat0) * (lat[jet] - lat1)))
    ug = np.zeros_like(np.broadcast_to(lat, (Nphi, Ntheta)))
    ug = np.array([ug, 0 * ug])
    ug[0][jet] = u_jet
    u["g"] = ug
    hpert = 120 * meter * np.cos(lat) * np.exp(-(phi / (1 / 3)) ** 2) \
        * np.exp(-((np.pi / 4 - lat) / (1 / 15)) ** 2)
    balance_solver = None
    if balance:
        c = dist.Field(name="c")
        problem = d3.LBVP([h, c], namespace=locals())
        problem.add_equation(
            "g*lap(h) + c = - div(u@grad(u) + 2*Omega*zcross(u))")
        problem.add_equation("ave(h) = 0")
        balance_solver = problem.build_solver()
        balance_solver.solve()
        h["g"] = h["g"] + hpert
    else:
        h["g"] = hpert
    problem = d3.IVP([u, h], namespace=locals())
    problem.add_equation(
        "dt(u) + nu*lap(lap(u)) + g*grad(h) + 2*Omega*zcross(u) "
        "= - u@grad(u)")
    problem.add_equation("dt(h) + nu*lap(lap(h)) + H*div(u) = - div(u*h)")
    kw = {"matsolver": matsolver} if matsolver else {}
    solver = problem.build_solver(d3.RK222, **kw)
    return solver, 300.0 * second, balance_solver


def build_annulus_convection(Nphi, Nr, dtype=np.float64, device=None):
    """
    Centrifugal convection in an annulus: the equations, bases, taus,
    initial state, CFL and flow property of
    examples/centrifugal_convection.py (reference:
    examples/ivp_annulus_centrifugal_convection), without its file
    handlers. AnnulusBasis (Nphi, Nr), radii (1/2, 3/2), dealias 3/2,
    RK222, Rayleigh 1e6, Prandtl 1; the buoyancy b*g against the radial
    gravity g = gravity*rvec is a tensor LHS NCC. The example's reduced
    default is 256 x 64. Returns (solver, cfl, flow): the CFL as the
    example sets it (cadence 10, safety 0.5, max_dt 0.125) and the flow
    property Re = sqrt(u@u)/nu at cadence 10.
    """
    import dedalus_tpu_torch.public as d3
    eta, Rayleigh, Prandtl = 3, 1e6, 1
    dealias, max_timestep = 3 / 2, 0.125
    Ri, Ro = 2 / (1 + eta), 2 * eta / (1 + eta)
    coords = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
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
    flow = d3.GlobalFlowProperty(solver, cadence=10)
    flow.add_property(np.sqrt(u @ u) / nu, name="Re")
    return solver, cfl, flow


def build_disk_libration(Nphi, Nr, dtype=np.float64, device=None):
    """
    The librational instability in a disk: the equations, bases, taus,
    background flow and initial state of examples/libration.py (reference:
    examples/ivp_disk_libration), without its file handlers. DiskBasis
    (Nphi, Nr), radius 1, dealias 3/2, SBDF2, Ekman 1/800, Ro 40. The
    background u0 = cos(t) u0_real - sin(t) u0_imag is built on the
    user's field t, passed as IVP(..., time=t) exactly as the example
    does; the problem keeps its own time field, so t stays 0 and u0 stays
    u0_real (as in the JAX package). The example's size is 32 x 128.
    Returns (solver, dt, flow, t): dt = 1e-3, the flow property u2 = u@u
    at cadence 10, and the user's time field.
    """
    from scipy.special import jv
    import dedalus_tpu_torch.public as d3
    Ekman, Ro, dealias = 1 / 2 / 20 ** 2, 40, 3 / 2
    coords = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
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
    profile = jv(1, (1 - 1j) * r / np.sqrt(2 * Ekman)) \
        / jv(1, (1 - 1j) / np.sqrt(2 * Ekman))
    u0_real["g"][0] = Ro * np.real(profile)
    u0_imag["g"][0] = Ro * np.imag(profile)
    t = dist.Field()
    u0 = np.cos(t) * u0_real - np.sin(t) * u0_imag
    problem = d3.IVP([p, u, tau_u, tau_p], time=t, namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("dt(u) - nu*lap(u) + grad(p) + lift(tau_u) "
                         "= - u@grad(u0) - u0@grad(u)")
    problem.add_equation("u(r=1) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(d3.SBDF2)
    u.fill_random("g", seed=42, distribution="normal")
    u.low_pass_filter(scales=0.25)
    flow = d3.GlobalFlowProperty(solver, cadence=10)
    flow.add_property(u @ u, name="u2")
    return solver, 1e-3, flow, t


def build_shell_convection(Nphi, Ntheta, Nr, dtype=np.float64, device=None):
    """
    Boussinesq convection in a spherical shell: the equations, bases, taus
    and initial state of examples/shell_convection.py (reference:
    examples/ivp_shell_convection), first-order tau form, without its
    file handlers. ShellBasis (Nphi, Ntheta, Nr), radii (14, 15), dealias
    3/2, SBDF2, Rayleigh 3500, Prandtl 1; the radial NCCs rvec*lift(tau)
    and b*er keep one pencil per (m, ell). The example's size is
    96 x 48 x 6 (16 x 8 x 6 with --quick). Returns (solver, dt, flow): the
    example's timestep 0.05 and its flow property u2 = u@u at cadence 10.
    """
    import dedalus_tpu_torch.public as d3
    Ri, Ro = 14.0, 15.0
    Rayleigh, Prandtl = 3500, 1
    dealias, timestep = 3 / 2, 0.05
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    shell = d3.ShellBasis(coords, shape=(Nphi, Ntheta, Nr), radii=(Ri, Ro),
                          dealias=dealias, dtype=dtype)
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
    grad_u = d3.grad(u) + rvec * lift(tau_u1)  # first-order reduction
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
    flow = d3.GlobalFlowProperty(solver, cadence=10)
    flow.add_property(u @ u, name="u2")
    return solver, timestep, flow


def build_rotconv(Nphi, Ntheta, Nr, dtype=np.float64, matsolver=None,
                  device=None):
    """
    Rotating Boussinesq convection in a shell (IVP): a copy of the
    progression's build_rotconv_ivp (benchmarks/progression.py:193;
    reference formulation: examples/evp_shell_rotating_convection).
    ShellBasis (Nphi, Ntheta, Nr), radii (0.35, 1), RK222, Ekman 1e-3,
    Rayleigh 3e5, Prandtl 1. The Coriolis term cross(ez, u) varies in
    colatitude, so ell is coupled and each pencil is one m. `matsolver`
    as for build_rb3d (None: the configured MATRIX_SOLVER; "banded"
    forces the banded path at a size 'auto' solves dense). Returns
    (solver, dt) with dt = 1e-4.
    """
    import dedalus_tpu_torch.public as d3
    Ri, Ro = 0.35, 1.0
    Ekman, Prandtl, Rayleigh = 1e-3, 1.0, 3e5
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    shell = d3.ShellBasis(coords, shape=(Nphi, Ntheta, Nr), radii=(Ri, Ro),
                          dtype=dtype)
    sphere = shell.outer_surface
    phi, theta, r = dist.local_grids(shell)
    u = dist.VectorField(coords, name="u", bases=shell)
    p = dist.Field(name="p", bases=shell)
    T = dist.Field(name="T", bases=shell)
    tau_u1 = dist.VectorField(coords, bases=sphere)
    tau_u2 = dist.VectorField(coords, bases=sphere)
    tau_T1 = dist.Field(bases=sphere)
    tau_T2 = dist.Field(bases=sphere)
    tau_p = dist.Field()
    rvec = dist.VectorField(coords, bases=shell.meridional_basis)
    rvec["g"][2] = np.broadcast_to(r, rvec["g"][2].shape)
    ez = dist.VectorField(coords, bases=shell.meridional_basis)
    ez["g"][1] = -np.sin(theta)
    ez["g"][2] = np.cos(theta)
    lift_basis = shell.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)  # noqa: E731
    grad_u = d3.grad(u) + rvec * lift(tau_u1)
    grad_T = d3.grad(T) + rvec * lift(tau_T1)
    problem = d3.IVP([p, u, T, tau_u1, tau_u2, tau_T1, tau_T2, tau_p],
                     namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(u) + (1/Ekman)*cross(ez, u) + grad(p) "
                         "- Rayleigh*T*rvec - div(grad_u) + lift(tau_u2) "
                         "= - u@grad(u)")
    problem.add_equation("dt(T) - dot(rvec,u)/Prandtl - div(grad_T)/Prandtl "
                         "+ lift(tau_T2) = - u@grad(T)")
    problem.add_equation("u(r=0.35) = 0")
    problem.add_equation("u(r=1.0) = 0")
    problem.add_equation("T(r=0.35) = 0")
    problem.add_equation("T(r=1.0) = 0")
    problem.add_equation("integ(p) = 0")
    kw = {"matsolver": matsolver} if matsolver else {}
    solver = problem.build_solver(d3.RK222, **kw)
    T.fill_random("g", seed=3, scale=1e-4)
    return solver, 1e-4


# Marti, Calkins & Julien (G^3 2016) Table 1: the critical m = 13
# eigenvalue of the rotating-convection EVP, stress-free and no-slip
ROTATING_CONVECTION_TARGET = {True: 963.765, False: 731.753}


def build_rotating_convection_evp(Nphi=28, Ntheta=64, Nr=64,
                                  stress_free=True, device=None):
    """
    Linear onset of rotating convection in a complex shell (EVP): a copy
    of examples/rotating_convection.py (reference:
    examples/evp_shell_rotating_convection). ShellBasis (Nphi, Ntheta,
    Nr) in complex128, radii (0.35, 1), Ekman 1e-5, Prandtl 1, Rayleigh
    at its critical value; the colatitude-varying cross(ez, u) couples
    ell, so each pencil is one m (fftfreq order: group 13 is m = 13);
    stress-free (radial u and the tangential stress angular(radial(
    strain_rate)) zero at both radii) or no-slip. The example's full size
    is 28x64x64, its --quick one 28x32x32 (the example's ncc_cutoff is
    left out: no solver reads it). Returns (solver, target), the target
    the m = 13 eigenvalue of ROTATING_CONVECTION_TARGET.
    """
    import dedalus_tpu_torch.public as d3
    Ri, Ro = 0.35, 1.0
    Prandtl, Ekman = 1, 1e-5
    Rayleigh = 2.1029e7 if stress_free else 2.0732e7
    dtype = np.complex128
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    shell = d3.ShellBasis(coords, shape=(Nphi, Ntheta, Nr), radii=(Ri, Ro),
                          dtype=dtype)
    sphere = shell.outer_surface
    phi, theta, r = dist.local_grids(shell)
    om = dist.Field(name="om")
    u = dist.VectorField(coords, name="u", bases=shell)
    p = dist.Field(name="p", bases=shell)
    T = dist.Field(name="T", bases=shell)
    tau_u1 = dist.VectorField(coords, bases=sphere)
    tau_u2 = dist.VectorField(coords, bases=sphere)
    tau_T1 = dist.Field(bases=sphere)
    tau_T2 = dist.Field(bases=sphere)
    tau_p = dist.Field()
    dt = lambda A: -1j * om * A  # noqa: E731
    rvec = dist.VectorField(coords, bases=shell.meridional_basis)
    rvec["g"][2] = np.broadcast_to(r, rvec["g"][2].shape)
    ez = dist.VectorField(coords, bases=shell.meridional_basis)
    ez["g"][1] = -np.sin(theta)
    ez["g"][2] = np.cos(theta)
    lift_basis = shell.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)  # noqa: E731
    grad_u = d3.grad(u) + rvec * lift(tau_u1)
    grad_T = d3.grad(T) + rvec * lift(tau_T1)
    strain_rate = d3.grad(u) + d3.transpose(d3.grad(u))
    problem = d3.EVP([p, u, T, tau_u1, tau_u2, tau_T1, tau_T2, tau_p],
                     eigenvalue=om, namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(u) + (1/Ekman)*cross(ez, u) + grad(p) "
                         "- Rayleigh*T*rvec - div(grad_u) + lift(tau_u2) = 0")
    problem.add_equation("Prandtl*dt(T) - dot(rvec,u) - div(grad_T) "
                         "+ lift(tau_T2) = 0")
    if stress_free:
        problem.add_equation("radial(u(r=Ri)) = 0")
        problem.add_equation("radial(u(r=Ro)) = 0")
        problem.add_equation("angular(radial(strain_rate(r=Ri), 0), 0) = 0")
        problem.add_equation("angular(radial(strain_rate(r=Ro), 0), 0) = 0")
    else:
        problem.add_equation("u(r=Ri) = 0")
        problem.add_equation("u(r=Ro) = 0")
    problem.add_equation("T(r=Ri) = 0")
    problem.add_equation("T(r=Ro) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver()
    return solver, ROTATING_CONVECTION_TARGET[stress_free]


def build_ball_convection(Nphi, Ntheta, Nr, dtype=np.float64, matsolver=None,
                          device=None):
    """
    Internally heated Boussinesq convection in a full ball with stress-free
    boundaries: the equations, bases, taus and initial state of
    examples/internally_heated_convection.py (reference:
    examples/ivp_ball_internally_heated_convection), without its loop.
    BallBasis (Nphi, Ntheta, Nr) of radius 1, dealias 3/2, SBDF2, Rayleigh
    1e4, Prandtl 1, T_source 6; the radial NCC r_vec*T keeps one pencil per
    (m, ell). The example's size is 64 x 32 x 48 (16 x 8 x 12 with
    --quick). `matsolver` as for build_rb3d (None: the configured
    MATRIX_SOLVER; "banded" forces the banded path at a size 'auto'
    solves dense). Returns (solver, dt, flow): the example's timestep 0.01
    and its flow property u2 = u@u at cadence 10.
    """
    import dedalus_tpu_torch.public as d3
    Rayleigh, Prandtl = 1e4, 1
    dealias, timestep = 3 / 2, 0.01
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    ball = d3.BallBasis(coords, shape=(Nphi, Ntheta, Nr), radius=1,
                        dealias=dealias, dtype=dtype)
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
    T_source = 6
    kappa = (Rayleigh * Prandtl) ** (-1 / 2)
    nu = (Rayleigh / Prandtl) ** (-1 / 2)
    lift = lambda A: d3.Lift(A, ball, -1)  # noqa: E731
    strain_rate = d3.grad(u) + d3.trans(d3.grad(u))
    shear_stress = d3.angular(d3.radial(strain_rate(r=1), index=1))
    problem = d3.IVP([p, u, T, tau_p, tau_u, tau_T], namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("dt(u) - nu*lap(u) + grad(p) - r_vec*T "
                         "+ lift(tau_u) = - cross(curl(u),u)")
    problem.add_equation("dt(T) - kappa*lap(T) + lift(tau_T) "
                         "= - u@grad(T) + kappa*T_source")
    problem.add_equation("shear_stress = 0")  # stress free
    problem.add_equation("radial(u(r=1)) = 0")  # no penetration
    problem.add_equation("T(r=1) = 0")
    problem.add_equation("integ(p) = 0")  # pressure gauge
    kw = {"matsolver": matsolver} if matsolver else {}
    solver = problem.build_solver(d3.SBDF2, **kw)
    T.fill_random("g", seed=42, distribution="normal", scale=0.01)
    T["g"] += 1 - np.asarray(r) ** 2  # conductive profile for T_source = 6
    flow = d3.GlobalFlowProperty(solver, cadence=10)
    flow.add_property(u @ u, name="u2")
    return solver, timestep, flow


# Boyd's stellar radii R = f(0)^((n-1)/2) of the Lane-Emden polytropes
# (examples/lane_emden.py)
LANE_EMDEN_R = {0.0: np.sqrt(6), 0.5: 2.752698054065, 1.0: np.pi,
                1.5: 3.65375373621912608, 2.0: 4.3528745959461246769735700,
                2.5: 5.355275459010779, 3.0: 6.896848619376960375454528,
                3.25: 8.018937527, 3.5: 9.535805344244850444,
                4.0: 14.971546348838095097611066,
                4.5: 31.836463244694285264}


def build_lane_emden(Nr=64, n=3.0, device=None):
    """
    The Lane-Emden equation lap(f) = -f^n, f(r=1) = 0 in the ball (NLBVP
    with floating amplitude): a copy of examples/lane_emden.py (reference:
    examples/nlbvp_ball_lane_emden). BallBasis (4, 2, Nr) of radius 1,
    dealias 2, one tau lifted to the ball's last mode, from the example's
    guess f = R0^(2/(n-1)) (1 - r^2)^2 with R0 = 5. Returns (solver, f,
    radius) with radius() the stellar radius f(0)^((n-1)/2) of the
    current iterate (compare with LANE_EMDEN_R[n]).
    """
    import dedalus_tpu_torch.public as d3
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    ball = d3.BallBasis(coords, (4, 2, Nr), radius=1, dtype=np.float64,
                        dealias=2)
    f = dist.Field(name="f", bases=ball)
    tau = dist.Field(name="tau", bases=ball.surface)
    lift = lambda A: d3.Lift(A, ball, -1)  # noqa: E731
    problem = d3.NLBVP([f, tau], namespace=locals())
    problem.add_equation("lap(f) + lift(tau) = - f**n")
    problem.add_equation("f(r=1) = 0")
    phi, theta, r = dist.local_grids(ball)
    R0 = 5
    f["g"] = R0 ** (2 / (n - 1)) * (1 - np.asarray(r) ** 2) ** 2
    solver = problem.build_solver()
    f0 = d3.Interpolate(f, coords["r"], 0.0)

    def radius():
        return float(np.asarray(f0.evaluate()["g"]).ravel()[0]) \
            ** ((n - 1) / 2)
    return solver, f, radius


def pipe_perturbation(z, phi, r, radius, length, amplitude, seed):
    """
    A smooth perturbation of a pipe's velocity from numpy's
    default_rng(seed), as (3, ...) cylinder components (z, phi, r) on the
    grids (z, phi, r): each Cartesian component (x, y, z) a sum of three
    axial Fourier modes (wavenumbers 2 pi k / length, k < 3, random
    phases) times a random linear function of (x, y) / radius,
    all times (1 - r^2 / radius^2), so it is regular at the axis and
    vanishes at the wall; scaled to max |component| = amplitude.
    """
    rng = np.random.default_rng(seed)
    z, phi, r = (np.asarray(a) for a in (z, phi, r))
    x, y = r * np.cos(phi) / radius, r * np.sin(phi) / radius
    shape = np.broadcast_shapes(z.shape, phi.shape, r.shape)
    envelope = 1 - (r / radius) ** 2
    cart = np.zeros((3,) + shape)
    for c in range(3):
        for k in range(3):
            a, cx, cy = rng.standard_normal(3)
            phase = 2 * np.pi * rng.uniform()
            cart[c] += (a + cx * x + cy * y) \
                * np.cos(2 * np.pi * k * z / length + phase)
        cart[c] *= envelope
    cart *= amplitude / np.abs(cart).max()
    out = np.empty_like(cart)
    out[0] = cart[2]
    out[1] = -cart[0] * np.sin(phi) + cart[1] * np.cos(phi)
    out[2] = cart[0] * np.cos(phi) + cart[1] * np.sin(phi)
    return out


def build_pipe_flow(Nz, Nphi, Nr, Re=2000.0, radius=1.0, length=10.0,
                    dtype=np.float64, amplitude=1e-3, seed=0, matsolver=None,
                    device=None):
    """
    Incompressible flow in a periodic pipe: the equations of the JAX
    package's tests/test_cylinder.py:305 test_pipe_flow_ivp_structure
    with nu = 1/Re: RealFourier z (Nz, length) x DiskBasis (Nphi, Nr,
    radius) on DirectProduct(z, (phi, r)) (ComplexFourier and a complex
    disk for a complex dtype), dealias 3/2, RK222, the
    velocity u, pressure p, a vector tau on the disk's edge lifted to the
    disk's last mode, tau_p and the gauge integ(p) = 0:

        dt(u) - nu*lap(u) + grad(p) + lift(tau_u) = - u@grad(u) + Fz
        div(u) + tau_p = 0,   u(r=radius) = 0,   integ(p) = 0

    with the axial force Fz = 4 nu / radius^2 e_z, which holds the
    laminar profile w = 1 - r^2/radius^2. Starts from that
    profile plus pipe_perturbation(amplitude, seed). `matsolver` None
    takes the configured 'auto' path choice. Returns (solver, cfl): the
    CFL on u with safety 0.4, cadence 10 and max_dt = initial dt 5e-3.
    """
    import dedalus_tpu_torch.public as d3
    nu = 1 / Re
    dealias = 3 / 2
    cz = d3.Coordinate("z")
    cp = d3.PolarCoordinates("phi", "r")
    coords = d3.DirectProduct(cz, cp)
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    fourier = d3.ComplexFourier if np.dtype(dtype).kind == "c" \
        else d3.RealFourier
    bz = fourier(cz, size=Nz, bounds=(0, length), dealias=dealias)
    disk = d3.DiskBasis(cp, (Nphi, Nr), dtype=dtype, radius=radius,
                        dealias=dealias)
    u = dist.VectorField(coords, name="u", bases=(bz, disk))
    p = dist.Field(name="p", bases=(bz, disk))
    tau_u = dist.VectorField(coords, name="tau_u", bases=(bz, disk.edge))
    tau_p = dist.Field(name="tau_p")
    Fz = dist.VectorField(coords, name="Fz")
    Fz["g"] = np.array([4 * nu / radius ** 2, 0.0, 0.0]).reshape(
        (3, 1, 1, 1))
    lift = lambda A: d3.Lift(A, disk, -1)  # noqa: E731
    problem = d3.IVP([u, p, tau_u, tau_p], namespace=locals())
    problem.add_equation(
        "dt(u) - nu*lap(u) + grad(p) + lift(tau_u) = - u@grad(u) + Fz")
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation(f"u(r={radius}) = 0")
    problem.add_equation("integ(p) = 0")
    kw = {} if matsolver is None else {"matsolver": matsolver}
    solver = problem.build_solver(d3.RK222, **kw)
    z, phi, r = dist.local_grids(bz, disk)
    ug = pipe_perturbation(z, phi, r, radius, length, amplitude, seed)
    ug[0] += 1 - (np.asarray(r) / radius) ** 2
    u["g"] = ug
    cfl = d3.CFL(solver, initial_dt=5e-3, max_dt=5e-3, safety=0.4,
                 cadence=10)
    cfl.add_velocity(u)
    return solver, cfl


def build_cylinder_diffusion(Nz=16, Nphi=16, Nr=32, dtype=np.float64,
                             device=None):
    """
    Heat diffusion in a periodic cylinder, a copy of
    examples/cylinder_diffusion.py: RealFourier z (Nz, length 2) x
    DiskBasis (Nphi, Nr, radius 1.5), dealias 3/2, RK443,
    dt(u) - lap(u) + lift(tau) = 0 with u(r=R) = 0, from the exact
    eigenmode J0(j01 r / R) cos(kz z). The example's size is 16x16x32 with
    200 steps. Returns (solver, dt, decay_error): dt = 2e-4 and
    decay_error() the max |u - exact| / max |u0| at the solver's sim_time
    (the exact decay rate kz^2 + (j01 / R)^2).
    """
    from scipy.special import j0, jn_zeros
    import dedalus_tpu_torch.public as d3
    length, radius = 2.0, 1.5
    cz = d3.Coordinate("z")
    cp = d3.PolarCoordinates("phi", "r")
    coords = d3.DirectProduct(cz, cp)
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    zbasis = d3.RealFourier(cz, size=Nz, bounds=(0, length), dealias=3 / 2)
    disk = d3.DiskBasis(cp, shape=(Nphi, Nr), dtype=dtype, radius=radius,
                        dealias=3 / 2)
    u = dist.Field(name="u", bases=(zbasis, disk))
    tau = dist.Field(name="tau", bases=(zbasis, disk.edge))
    lift = lambda A: d3.Lift(A, disk, -1)  # noqa: E731
    problem = d3.IVP([u, tau], namespace=locals())
    problem.add_equation("dt(u) - lap(u) + lift(tau) = 0")
    problem.add_equation(f"u(r={radius}) = 0")
    solver = problem.build_solver(d3.RK443)
    z, phi, r = dist.local_grids(zbasis, disk)
    kz = 2 * np.pi / length
    j01 = jn_zeros(0, 1)[0]
    u0 = j0(j01 * np.asarray(r) / radius) * np.cos(kz * np.asarray(z)) \
        + 0 * np.asarray(phi)
    u["g"] = u0
    rate = kz ** 2 + (j01 / radius) ** 2

    def decay_error():
        u.change_scales(1)
        exact = u0 * np.exp(-rate * solver.sim_time)
        return float(np.abs(np.array(u["g"]) - exact).max()
                     / np.abs(u0).max())
    return solver, 2e-4, decay_error


def build_annulus_cylinder_poisson(Nz=8, Nphi=16, Nr=16, dtype=np.float64,
                                   device=None):
    """
    A Poisson LBVP in a cylindrical annulus: Fourier z (Nz, length 1.88)
    x AnnulusBasis (Nphi, Nr, radii (0.5, 3.0)), the geometry of the JAX
    package's tests/test_cylinder.py, on DirectProduct(z, (phi, r)),
    lap(u) + lift(tau1, -1) + lift(tau2, -2) = f with u = 0 on both walls,
    f = lap(u_exact) evaluated in the same package for the polynomial
    u_exact = (r^2 - Ri^2)(Ro^2 - r^2)(1 + x + y cos(kz z)), kz = 2 pi /
    length, which the bases resolve exactly. Returns (u, u_exact): the
    solved field and the exact one, as fields.
    """
    import dedalus_tpu_torch.public as d3
    length, radii = 1.88, (0.5, 3.0)
    Ri, Ro = radii
    cz = d3.Coordinate("z")
    cp = d3.PolarCoordinates("phi", "r")
    coords = d3.DirectProduct(cz, cp)
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    bz = (d3.ComplexFourier if np.dtype(dtype).kind == "c"
          else d3.RealFourier)(cz, size=Nz, bounds=(0, length))
    annulus = d3.AnnulusBasis(cp, (Nphi, Nr), dtype=dtype, radii=radii)
    z, phi, r = (np.asarray(a) for a in dist.local_grids(bz, annulus))
    x, y = r * np.cos(phi), r * np.sin(phi)
    u_exact = dist.Field(name="u_exact", bases=(bz, annulus))
    u_exact["g"] = (r ** 2 - Ri ** 2) * (Ro ** 2 - r ** 2) \
        * (1 + x + y * np.cos(2 * np.pi * z / length))
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
    return u, u_exact


# examples/pipe_flow.py's converged slowest mode (Re 1e4, kz 1, m 1; Nr 48
# and 64 agree to 6 digits) and the example's bar
PIPE_FLOW_EVP_TARGET = -0.0227050 - 0.9514810j
PIPE_FLOW_EVP_BAR = 1e-4


def build_pipe_flow_evp(Nr=64, device=None):
    """
    The linear stability of laminar pipe flow, a copy of
    examples/pipe_flow.py (reference: examples/evp_disk_pipe_flow) at its
    Re = 1e4, kz = 1 and m = 1: a complex128 DiskBasis (10, Nr) of radius
    1, the axial wavenumber kz as dz -> 1j kz, the background w0 = 1 - r^2
    as a disk LHS NCC, no-slip walls, eigenvalue s. The example's size is
    Nr = 64 (--quick: 32). Returns (solver, subproblem): the m = 1
    azimuthal pencil, solver.subproblems_by_group[(1, None)], for
    solve_dense.
    """
    import dedalus_tpu_torch.public as d3
    Re, kz, m = 1e4, 1, 1
    dtype = np.complex128
    Nphi = 2 * max(m, 4) + 2
    coords = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    disk = d3.DiskBasis(coords, shape=(Nphi, Nr), radius=1, dtype=dtype)
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


# the coupled-pencil problems: the annulus radii and the NCC of the JAX
# package's tests/test_polar_azimuthal_ncc.py:104
AZNCC_RADII = (0.7, 1.8)
AZNCC_DT = 1e-3


def build_annulus_azncc(Nphi, Nr, kind="lbvp", matsolver=None, device=None):
    """
    An azimuthally varying annulus NCC, w = 1 + 0.3 r cos(phi), which
    couples every m group into one (m x r) pencil: the LBVP of the JAX
    package's tests/test_polar_azimuthal_ncc.py:104 (kind "lbvp": w*u -
    lap(u) = g with u = 0 on both walls, g made from the manufactured u =
    (r - 0.7)(1.8 - r)(1 + 0.5 cos(phi))), or its IVP (kind "ivp": dt(u)
    + w*u - lap(u) = 0 with the same walls, RK222, u starting from the
    manufactured profile; step it at AZNCC_DT). AnnulusBasis (Nphi, Nr),
    radii AZNCC_RADII, f64, dealias 2 (the product's exact projection).
    Returns (solver, u, u_true) with u_true the manufactured grid values.
    """
    import dedalus_tpu_torch.public as d3
    Ri, Ro = AZNCC_RADII
    coords = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    ann = d3.AnnulusBasis(coords, shape=(Nphi, Nr), dtype=np.float64,
                          radii=AZNCC_RADII, dealias=2)
    phi, r = dist.local_grids(ann)
    u_true = (r - Ri) * (Ro - r) * (1 + 0.5 * np.cos(phi))
    w = dist.Field(name="w", bases=ann)
    w["g"] = 1.0 + 0.3 * np.cos(phi) * r
    u = dist.Field(name="u", bases=ann)
    tau1 = dist.Field(name="tau1", bases=ann.edge)
    tau2 = dist.Field(name="tau2", bases=ann.edge)
    lift_basis = ann.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)  # noqa: E731
    if kind == "lbvp":
        ut = dist.Field(name="ut", bases=ann)
        ut["g"] = u_true
        g = (w * ut - d3.lap(ut)).evaluate()
        problem = d3.LBVP([u, tau1, tau2], namespace=locals())
        problem.add_equation("w*u - lap(u) + lift(tau1,-1) + lift(tau2,-2) "
                             "= g")
    elif kind == "ivp":
        problem = d3.IVP([u, tau1, tau2], namespace=locals())
        problem.add_equation("dt(u) + w*u - lap(u) + lift(tau1,-1) "
                             "+ lift(tau2,-2) = 0")
    else:
        raise ValueError(f"kind {kind!r}: 'lbvp' or 'ivp'")
    problem.add_equation(f"u(r={Ri}) = 0")
    problem.add_equation(f"u(r={Ro}) = 0")
    if kind == "ivp":
        solver = problem.build_solver(d3.RK222, matsolver=matsolver)
        u["g"] = u_true
    else:
        solver = problem.build_solver(matsolver=matsolver)
    return solver, u, u_true


def build_disk_azncc(Nphi, Nr, kind="ncc", device=None):
    """
    The disk's coupled pencils. Kind "ncc": w*u - lap(u) = g on a
    DiskBasis (Nphi, Nr) of radius 1, dealias 2, with the azimuthally
    varying w = 1 + 0.3 r cos(phi) (one (m x r) pencil) and u = 0 on the
    edge, g made from the manufactured u = (1 - r^2)(1 + 0.5 x + 0.3 x y).
    Kind "coupled_poisson": the disk Poisson lap(u) = g of the JAX
    package's tests/test_two_coupled.py:207, with u = (1 - r^2)(1 + 0.5 x
    + 0.3 y), solved with matrix_coupling=[True, True] (one flattened
    pencil; its solution is the separable one's). Returns (solver, u,
    u_true).
    """
    import dedalus_tpu_torch.public as d3
    coords = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    disk = d3.DiskBasis(coords, shape=(Nphi, Nr), dtype=np.float64,
                        radius=1.0, dealias=2)
    phi, r = dist.local_grids(disk)
    x, y = r * np.cos(phi), r * np.sin(phi)
    u = dist.Field(name="u", bases=disk)
    tau = dist.Field(name="tau", bases=disk.edge)
    lift = lambda A: d3.Lift(A, disk, -1)  # noqa: E731
    g = dist.Field(name="g", bases=disk)
    if kind == "ncc":
        u_true = (1 - r ** 2) * (1 + 0.5 * x + 0.3 * x * y)
        w = dist.Field(name="w", bases=disk)
        w["g"] = 1.0 + 0.3 * r * np.cos(phi)
        ut = dist.Field(name="ut", bases=disk)
        ut["g"] = u_true
        g = (w * ut - d3.lap(ut)).evaluate()
        problem = d3.LBVP([u, tau], namespace=locals())
        problem.add_equation("w*u - lap(u) + lift(tau) = g")
        kw = {}
    elif kind == "coupled_poisson":
        u_true = (1 - r ** 2) * (1 + 0.5 * x + 0.3 * y)
        # lap((1 - r^2) v) = -4 v + 2 grad(1 - r^2).grad(v), v harmonic
        g["g"] = -4.0 - 4.0 * x - 2.4 * y
        problem = d3.LBVP([u, tau], namespace=locals())
        problem.add_equation("lap(u) + lift(tau) = g")
        kw = {"matrix_coupling": [True, True]}
    else:
        raise ValueError(f"kind {kind!r}: 'ncc' or 'coupled_poisson'")
    problem.add_equation("u(r=1) = 0")
    solver = problem.build_solver(**kw)
    return solver, u, u_true


def build_poisson_rect(N, matsolver=None, device=None):
    """
    The Chebyshev x Chebyshev Poisson rectangle of the JAX package's
    tests/test_two_coupled.py:21 at N x N on [0, 1]^2: lap(u) = f with
    tau lines on both axes (two coupled axes; the four corner modes make
    L singular), u = 0 on the four sides, against u = sin(pi x) sin(pi z)
    exp(x). Returns (solver, u, u_exact).
    """
    import dedalus_tpu_torch.public as d3
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    xb = d3.ChebyshevT(coords["x"], size=N, bounds=(0, 1))
    zb = d3.ChebyshevT(coords["z"], size=N, bounds=(0, 1))
    x, z = dist.local_grids(xb, zb)
    u = dist.Field(name="u", bases=(xb, zb))
    tx1 = dist.Field(name="tx1", bases=zb)
    tx2 = dist.Field(name="tx2", bases=zb)
    tz1 = dist.Field(name="tz1", bases=xb)
    tz2 = dist.Field(name="tz2", bases=xb)
    u_exact = np.sin(np.pi * x) * np.sin(np.pi * z) * np.exp(x)
    rhs = dist.Field(name="rhs", bases=(xb, zb))
    rhs["g"] = (np.exp(x) * np.sin(np.pi * z)
                * ((1 - np.pi ** 2) * np.sin(np.pi * x)
                   + 2 * np.pi * np.cos(np.pi * x))
                - np.pi ** 2 * np.sin(np.pi * x) * np.sin(np.pi * z)
                * np.exp(x))
    liftx = lambda A, n: d3.Lift(A, xb.derivative_basis(2), n)  # noqa: E731
    liftz = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)  # noqa: E731
    problem = d3.LBVP([u, tx1, tx2, tz1, tz2], namespace=locals())
    problem.add_equation("lap(u) + liftx(tx1,-1) + liftx(tx2,-2)"
                         " + liftz(tz1,-1) + liftz(tz2,-2) = rhs")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation("u(x=1) = 0")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("u(z=1) = 0")
    solver = problem.build_solver(matsolver=matsolver)
    return solver, u, u_exact


def build_joint_ncc(Nx, Nz, device=None):
    """
    The joint-NCC LBVP of the JAX package's tests/test_joint_ncc.py:70:
    (2 + 0.5 sin(x) z) u = F on RealFourier(Nx) x ChebyshevT(Nz), dealias
    2, for a known u; the NCC varies along both axes, so the Fourier axis
    is forced coupled (one pencil). Returns (solver, u, u_target).
    """
    import dedalus_tpu_torch.public as d3
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    xb = d3.RealFourier(coords["x"], size=Nx, bounds=(0, 2 * np.pi),
                        dealias=2)
    zb = d3.ChebyshevT(coords["z"], size=Nz, bounds=(0, 1), dealias=2)
    x, z = dist.local_grids(xb, zb)
    f = dist.Field(name="f", bases=(xb, zb))
    f["g"] = 2.0 + 0.5 * np.sin(x) * z
    u = dist.Field(name="u", bases=(xb, zb))
    u_target = dist.Field(name="u_target", bases=(xb, zb))
    u_target["g"] = np.cos(x) * z + 0.3 * np.sin(2 * x) * (1 - z)
    F = (f * u_target).evaluate()
    problem = d3.LBVP([u], namespace=locals())
    problem.add_equation("f*u = F")
    solver = problem.build_solver()
    return solver, u, np.array(u_target["g"])
