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
examples/shallow_water.py). Each builds on `device` (default `cuda`; pass
"cpu" to run on the host).
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
