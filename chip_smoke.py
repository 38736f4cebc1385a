#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (dedalus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase at full size
    python3 chip_smoke.py --real 1024 512 # a smaller real-size phase

Phases (each prints its own lines; any failure exits non-zero):

  1. The card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of the banded substitution kernel from
     dedalus_tpu_torch/csrc/banded_subst.cu (nvcc, sm_90a).
  2. Kernel vs its plain PyTorch version on the card, at the RB 2048x1024
     shapes (random operators from a seed) in f64 and f32, and in the
     factor-time Woodbury form (16 right-hand sides per group, f64): max
     relative error against a stated bound, median times of both (warm,
     and cold: each launch after a 64 MB write that flushes the 50 MB L2),
     one torch.sum over the same operator bytes as a read-bandwidth
     yardstick of the card, the byte bound.
  3. The main path: build_rb_solver(256, 64, float64, matsolver="banded")
     on cuda through the public API, 50 RK222 steps. Checks: finite state,
     boundary conditions, the incompressibility equation, an RB 8x32 run
     on the card against the same run on the CPU, and the kernel's launch
     count (factorizations + stage solves x (1 + refinement sweeps),
     whatever the factor's G-chunk count). Then the kernel vs plain check
     at the solver's own factor operators (f64 and f32), and a per-layer
     time breakdown of one stage. Beside it, RB 256x64 with
     matsolver=None ('auto' picks the dense path at this size, as the JAX
     package does off the TPU): build, factor, steps/s, and its state
     after the same 50 steps against the banded one (1e-10 relative).
     Neither path may synchronize the host in a steady step (torch's
     sync debug mode; so too in phases 5 and 6).
  4. Real size: RB 2048x1024 (the target of BASELINE.json): build,
     factor, 10 steps, steps/s, peak device memory, the same checks.
  5. kdv1024 (benchmarks/progression.py config 1: RealFourier 1024,
     SBDF2, dt 2e-3, dense): build, 2 factorizations, steps/s over 500
     steps after 10 warm ones, no host syncs in steady steps, a per-layer
     breakdown, launches per step and the idle share (torch.profiler).
     Checks: mass integ(u) conserved to 1e-13 relative; KdV 64, 50 steps,
     card vs CPU to 1e-12.
  6. shear512 (config 2: RealFourier^2 512x512, RK222, dt 0.25/512,
     dense, G = 65536, S = 20): build with its parts, factor, steps/s
     over 100 steps after 10 warm ones, peak memory, the same profile.
     Checks: div(u) + tau_p within 1e-10 of max|grad u|, |integ(p)| <=
     1e-10, integ(s) conserved to 1e-12 relative, shear 32x32 10 steps
     card vs CPU to 1e-12; then 30 steps driven by CFL with the settings
     of examples/shear_flow.py: the dt sequence and the refactorizations.
  7. poisson2048x1024 (examples/poisson.py at the target resolution,
     LBVP, MATRIX_SOLVER 'auto', so banded: G = 1024, S = 2052, q = 6,
     NB = 342, 4 pins): build with its phases, solve, 25 warm solves with
     f changed on the card between them (median ms, CUDA events, and
     host wall), a re-factor, peak memory; launches from the build to
     the last timed solve = 1 (the factor's Woodbury solve) + one per
     solve pass; no host synchronization in a warm solve(); u(y=0) = g
     to 1e-12 of max|g|, dy(u)(y=Ly) to 1e-10 of max|dy(u)|, the
     tau-corrected equation to 1e-10 of max|f|; Poisson 64x32 banded
     card vs CPU to 1e-12. The kernel vs plain on this factor's own
     operators (q = 6).
  8. poisson256x128 (the example's size; 'auto' takes the dense path):
     the same checks and timings, and the forced banded run of the same
     problem beside it; the two solutions within 1e-12.
  9. bratu256 (NLBVP u'' + exp(u) = 0, dense): Newton from u = 0 to a
     perturbation norm below 1e-10 in at most 8 iterations, seconds per
     iteration split into host Jacobian assembly and factor + solve,
     error against the closed form <= 1e-10; Bratu 32 card vs CPU to
     1e-12; the sin-Jacobi NLBVP of the JAX package's tests at N = 64
     within 1e-6 of cos(x).
 10. rbevp64 (examples/rayleigh_benard_evp.py at Nz = 64, complex128,
     ComplexFourier carrier, solve_sparse of 10 modes around 0) for 5 kx
     in [3.0, 3.25] at Ra = 1700 and 1710: build and eigensolve seconds
     per kx; the peak growth rate < 0 at 1700 and > 0 at 1710; the
     fastest mode put on the card by set_state is finite and no-slip
     to 1e-10.
 11. waves128 (examples/waves_on_a_string.py, Legendre, solve_dense with
     left eigenvectors): the lowest 8 eigenvalues within 1e-8 of
     (n pi)^2, left eigenvectors biorthonormal against -M to 1e-8.
     Phases 5, 6 and 9-11 each run with the kernel's count set to 0
     just before and read just after; it must stay 0.
 12. sw512x256 (benchmarks/progression.py config 4, the Galewsky jet
     on the sphere, through extras/bench_problems.py
     build_shallow_water: SphereBasis 512x256, dealias 3/2, RK222,
     dt = 300 s in simulation units; 'auto' takes the banded path,
     q = 7): sw64x32 forced banded card vs CPU to 1e-12 after the
     balanced-height LBVP and 10 steps; build with its phases, the
     balance LBVP re-solved (|ave(h)| <= 1e-13 max|h|, tau-corrected
     residual <= 1e-10 of its RHS), the factor and SW_STEPS timed steps
     (steps/s), launches = 1 + 4 x (1 + SW_STEPS) (the factoring first
     step and the timed ones), no host sync in a steady
     step, finite state, integ(h) drift <= 1e-12 of 4 pi max|h|, the
     vorticity -div(skew(u)) through a DictionaryHandler, peak memory,
     the per-layer breakdown, launches per step and the idle share
     (torch.profiler), and the kernel vs plain at this factor's own
     operators (q = 7, f64).
 13. Complex banded solves: the complex128 Poisson (build_poisson_solver
     on a ComplexFourier x ChebyshevT domain) at 64x32 forced banded card
     vs CPU to 1e-12; at 1024x512 under 'auto' (banded: dense would be
     4.3 GB) the Poisson phase's timings, launches and checks, all to
     1e-12; the complex kernel vs plain at its factor's operators in
     complex128 (1e-12) and complex64 (1e-5).
 14. rb3d_128 (benchmarks/progression.py config 5 on one card: 3-D
     Rayleigh-Benard, RealFourier^2 x ChebyshevT 128x128x64, RK222, dt =
     1e-3, through extras/bench_problems.py build_rb3d; 'auto' takes the
     banded path, q = 80): 16x16x32 forced banded card vs CPU (p, b, u to
     1e-12, the taus to 1e-12 of the state); build with its phases, the
     factor, RB3D_STEPS timed steps after the factoring first one,
     launches = 1 + 4 x (1 + RB3D_STEPS), no host sync in a steady step,
     peak memory, BCs and incompressibility to 1e-10; the kernel at this
     factor's operators (q = 80, f64, k = 1 and the Woodbury k = pins);
     the breakdown without a second factor.
 15. The complex128 IVP of build_complex_ivp (ComplexFourier x
     ChebyshevT, a b*b term, taus) at 1024x512 under 'auto' (banded, q =
     3): 32x16 forced banded card vs CPU to 1e-12, CIVP_STEPS timed steps,
     launches = 1 + 4 x (1 + CIVP_STEPS), no host sync, a finite state.
     Phases 3, 5, 6, 12 and 14 also take the same steps from the same
     state as a loop of step and as step_many, the step recorded once as
     a CUDA graph and replayed (core/stepgraph.py): the states must be
     bit-equal (else within 1e-13), the replayed block records nothing,
     the launches equal the loop's, no host sync in a replayed block;
     steps/s of both and the idle share of a step in each
     (extras/profile_step.py).
 16. The kernels line, the card line, and the result line.

Each phase prints its seconds and one JSON record on its own line.

Detailed results also go to chiprun_out/chip_smoke.json.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor-core
# FP64/FP32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "complex128": 34e12,
              "complex64": 67e12}
# kernel vs plain: relative to max|plain| (summation order differs; f32
# against f64 on the RB 256x64 factor operators differs by ~5e-7); the
# complex types as their real parts
BOUND = {"float64": 1e-12, "float32": 1e-5, "complex128": 1e-12,
         "complex64": 1e-5}
# bytes written between cold launches: more than the H100's 50 MB L2
FLUSH_BYTES = 64 * 2 ** 20
# operator stores up to this size are copied flat for the torch.sum
# yardstick (rb3d_128's 23.5 GB are summed per tensor instead)
STREAM_COPY_BYTES = 4 * 10 ** 9
# warm Poisson solves timed per run (the median is reported)
POISSON_SOLVES = 25
# the sphere phase: progression config 4's size, and the timed steps
# after the factoring first one
SW_SIZE = (512, 256)
SW_STEPS = 20
# 3-D Rayleigh-Benard (progression config 5, one card) and its timed
# steps after the factoring first one; the small size of its card vs CPU
# check
RB3D_SIZE = (128, 128, 64)
RB3D_STEPS = 10
RB3D_SMALL = (16, 16, 32)
# the complex IVP (build_complex_ivp) and its timed steps
CIVP_SIZE = (1024, 512)
CIVP_STEPS = 20
RESULTS = {}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def log(*args):
    print(*args, flush=True)


def median_ms(fn, reps=25, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def cold_median_ms(fn, reps=10):
    """Median device time of fn, each run right after a write of
    FLUSH_BYTES of scratch, so the L2 holds none of fn's inputs."""
    import torch
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device="cuda")
    fn()
    times = []
    for rep in range(reps):
        scratch.fill_(float(rep))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def subst_cost(fsub, fp):
    """(bytes, flops) the substitution must move and do: each input read
    once, the output written once; 2 flops per operator word per column
    (8 real flops for a complex multiply-add)."""
    G, q = fsub["lastOp"].shape[:2]
    item = fp.element_size()
    k = 1 if fp.ndim == 2 else fp.shape[1]
    words = fsub["FwdOp"].numel() + fsub["BwdOp"].numel() \
        + fsub["lastOp"].numel()
    nbytes = (words + 2 * fp.numel()) * item
    return nbytes, (8 if fp.is_complex() else 2) * words * k


def check_kernel(label, fsub, fp):
    """Kernel vs plain on the same inputs; returns the measured record.
    The right-hand side is first scaled so that the plain solution has
    max |y| = 1 (the substitution is linear; the RB factor operators map
    a unit right-hand side to ~1e11), so the absolute error is in units
    of the solution's size."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    dtype = str(fp.dtype).replace("torch.", "")
    fp = fp / fusedstep.substitution_plain(fsub, fp).abs().max()
    out = fusedstep.substitution_cuda(fsub, fp)
    ref = fusedstep.substitution_plain(fsub, fp)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"kernel[{label}] returned non-finite values")
    abs_err = float((out - ref).abs().max())
    rel_err = abs_err / float(ref.abs().max())
    if not rel_err <= BOUND[dtype]:
        fail(f"kernel[{label}] disagrees with the plain version: max "
             f"relative error {rel_err:.3e} > {BOUND[dtype]:.0e}")
    launch = lambda: fusedstep.substitution_cuda(fsub, fp)
    ms = median_ms(launch)
    cold_ms = cold_median_ms(launch)
    plain_ms = median_ms(lambda: fusedstep.substitution_plain(fsub, fp))
    # the read-bandwidth yardstick: one torch.sum over a flat copy of the
    # operator bytes (timed here only; the port never calls it); above
    # STREAM_COPY_BYTES, no copy: one torch.sum per operator tensor
    parts = [fsub[k].reshape(-1) for k in ("FwdOp", "BwdOp", "lastOp")]
    if sum(t.numel() * t.element_size() for t in parts) <= STREAM_COPY_BYTES:
        parts = [torch.cat(parts)]
    stream_ms = median_ms(lambda: [torch.sum(t) for t in parts])
    del parts
    nbytes, flops = subst_cost(fsub, fp)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    G, q = fsub["lastOp"].shape[:2]
    NB = fsub["FwdOp"].shape[0] + 1
    k = 1 if fp.ndim == 2 else fp.shape[1]
    rec = {"shape": label, "dtype": dtype, "G": G, "q": q, "NB": NB, "k": k,
           "max_abs_err": abs_err, "max_rel_err": rel_err,
           "bound_rel": BOUND[dtype], "ms": ms, "cold_ms": cold_ms,
           "stream_ms": stream_ms, "plain_ms": plain_ms,
           "bytes": nbytes, "flops": flops,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "plan": fusedstep.kernel_plan(G, k, NB, q, fp.dtype)}
    rec["share_of_bound"] = rec["bound_ms"] / ms
    log(f"kernel[{label},{dtype}] " + json.dumps(rec))
    RESULTS.setdefault("kernel_checks", []).append(rec)
    return rec


def random_fsub(G, NB, q, dtype, seed, k=1):
    """Random substitution operators on the card, scaled so the sweeps
    neither grow nor decay fast, and a right-hand side of k columns per
    group."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, width):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float64).div_(2 * width ** 0.5).to(dtype)

    fsub = {"FwdOp": rnd((NB - 1, G, 4 * q * q), 2 * q),
            "BwdOp": rnd((NB - 1, G, 3 * q * q), 3 * q),
            "lastOp": rnd((G, q, q), q)}
    shape = (G, NB * q) if k == 1 else (G, k, NB * q)
    fp = torch.randn(shape, generator=gen, device="cuda",
                     dtype=torch.float64).to(dtype)
    return fsub, fp


def rb_checks(label, solver, b):
    """Finite state, boundary conditions and the incompressibility
    equation of an RB solver (2-D or 3-D, z last) on the card."""
    import torch
    import numpy as np
    import dedalus_tpu_torch.public as d3
    if not bool(torch.isfinite(solver.X).all()):
        fail(f"{label}: non-finite state")
    names = {v.name: v for v in solver.variables}
    u, tau_p, tau_u1 = names["u"], names["tau_p"], names["tau_u1"]
    errs = {
        "b(z=0)-Lz": float(np.max(np.abs(
            d3.Interpolate(b, "z", 0.0).evaluate()["g"] - 1.0))),
        "b(z=Lz)": float(np.max(np.abs(
            d3.Interpolate(b, "z", 1.0).evaluate()["g"]))),
        "u(z=0)": float(np.max(np.abs(
            d3.Interpolate(u, "z", 0.0).evaluate()["g"]))),
        "u(z=Lz)": float(np.max(np.abs(
            d3.Interpolate(u, "z", 1.0).evaluate()["g"]))),
    }
    ez = u.tensorsig[0].unit_vector_fields(u.dist)[-1]
    lift_basis = u.domain.bases[-1].derivative_basis(1)
    grad_u = d3.grad(u) + ez * d3.Lift(tau_u1, lift_basis, -1)
    resid = (d3.trace(grad_u) + tau_p).evaluate()["c"]
    errs["trace(grad_u)+tau_p (rel)"] = float(
        np.max(np.abs(resid)) / np.max(np.abs(u["c"])))
    log(f"{label} checks " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 1e-10}
    if bad:
        fail(f"{label}: checks out of bound 1e-10: {bad}")
    return errs


def breakdown(label, solver, dt, reps, factor=True):
    """Per-layer device times (median ms, CUDA events) of the pieces one
    step is made of, on the solver's current state: one stage's RHS
    evaluation and L matvec, one solve with its refinement sweep, one
    substitution kernel launch, the state scatter/gather, a dealiased
    transform roundtrip of the state, one factorization (unless `factor`
    is False: a second factor store would not fit beside the first), and
    one step."""
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.core.subsystems import gather_state, scatter_state
    ops, X = solver.ops, solver.X
    M, L = solver.M_mat, solver.L_mat
    aux = solver.timestepper._lhs_aux[0]
    fp = X.new_ones((X.shape[0], ops.n_pad))
    layout, variables = solver.layout, solver.variables
    out = {
        "rhs_eval": median_ms(lambda: solver.eval_F(X, 0.0), reps=reps),
        "matvec_L": median_ms(lambda: ops.matvec(L, X), reps=reps),
        "solve_with_refinement": median_ms(
            lambda: ops.solve(aux, X, mats=(M, L)), reps=reps),
        "substitution_kernel": median_ms(
            lambda: fusedstep.substitution_cuda(aux["fsub"], fp), reps=reps),
        "scatter_gather": median_ms(lambda: gather_state(
            layout, variables, scatter_state(layout, variables, X)),
            reps=reps),
        "transform_roundtrip": median_ms(solver.enforce_hermitian_symmetry,
                                         reps=reps),
    }
    if factor:
        out["factor"] = median_ms(lambda: ops.factor_lincomb(
            1.0, M, dt * solver.timestepper.uniq_H_diag[0], L),
            reps=3, warm=1)
    out["step"] = median_ms(lambda: solver.step(dt), reps=reps, warm=1)
    log(f"breakdown {label} ms " + json.dumps(out))
    return out


def rel_diff(a, b):
    import numpy as np
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def card_vs_cpu(label, build, steps):
    """The same small run on the card and on the CPU (the CPU path is held
    against the JAX package by tests/test_torch_*.py): max relative
    difference of the states, failing above 1e-12."""
    xs = []
    for device in ("cuda", "cpu"):
        solver, dt = build(device)
        for _ in range(steps):
            solver.step(dt)
        xs.append(solver.X.cpu().numpy())
    err = rel_diff(xs[0], xs[1])
    log(f"{label} cuda vs cpu, {steps} steps: max relative difference "
        f"{err:.3e}")
    if not err <= 1e-12:
        fail(f"{label} on the card disagrees with the CPU run: {err:.3e}")
    return err


def steps_per_s(solver, dt, steps):
    """Steps per second over `steps` steps, closed by a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        solver.step(dt)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def host_syncs(run, reps=3):
    """Host synchronizations torch reports in `reps` calls of `run` (a
    steady step, a warm solve; torch.cuda.set_sync_debug_mode('warn')):
    count per call and the first messages."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(reps):
                run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    msgs = [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]
    return len(msgs) / reps, msgs[:3]


def check_no_host_syncs(label, rec, solver, dt):
    """Record the host synchronizations of steady steps; a step must
    queue its work without waiting for the card."""
    rec["host_syncs_per_step"], rec["host_sync_messages"] = \
        host_syncs(lambda: solver.step(dt))
    if rec["host_syncs_per_step"]:
        fail(f"{label}: {rec['host_syncs_per_step']} host synchronizations "
             f"per steady step: {rec['host_sync_messages']}")


def release():
    """Free the previous phase's solver: its fields and lazy pulls form
    reference cycles, which only the collector frees."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def dense_breakdown(label, solver, dt, reps, cfl=None):
    """Per-layer device times (median ms, CUDA events) of a dense-path
    step on the solver's current state: the RHS evaluation, the M/L
    matvec pair, one dense solve, one factorization, a dealiased transform
    roundtrip of the state, the CFL frequency (with its one host read)
    and one step."""
    ops, X = solver.ops, solver.X
    M, L = solver.M_mat, solver.L_mat
    aux = solver.timestepper._lhs_aux
    aux = aux[0] if isinstance(aux, list) else aux
    out = {
        "rhs_eval": median_ms(lambda: solver.eval_F(X, 0.0), reps=reps),
        "matvec_pair": median_ms(lambda: ops.matvec_pair(M, L, X),
                                 reps=reps),
        "dense_solve": median_ms(lambda: ops.solve(aux, X), reps=reps),
        "factor": median_ms(lambda: ops.factor_lincomb(1.0, M, dt, L),
                            reps=5, warm=1),
        "transform_roundtrip": median_ms(solver.enforce_hermitian_symmetry,
                                         reps=reps),
    }
    if cfl is not None:
        out["cfl"] = median_ms(cfl.compute_max_frequency, reps=reps)
    out["step"] = median_ms(lambda: solver.step(dt), reps=reps, warm=1)
    log(f"breakdown {label} ms " + json.dumps(out))
    return out


def poisson_checks(label, f, bound=1e-10):
    """Boundary conditions and the tau-corrected equation of a solved
    Poisson LBVP (build_poisson_solver or its complex twin): |u(y=0) - g|
    / max|g| <= 1e-12, |dy(u)(y=Ly)| / max|dy(u)| (h = 0), and the
    coefficients of lap(u) + lift(tau_1) + lift(tau_2) - f over max|f|,
    each <= `bound`."""
    import numpy as np
    import dedalus_tpu_torch.public as d3
    u, g, rhs = f["u"], f["g"], f["f"]
    ybasis = u.domain.bases[1]
    lift = lambda A, n: d3.Lift(A, ybasis.derivative_basis(2), n)  # noqa: E731
    dyu = d3.Differentiate(u, "y")
    Ly = ybasis.bounds[1]
    checks = {
        "u(y=0)-g / max|g|": float(
            np.max(np.abs(d3.Interpolate(u, "y", 0.0).evaluate()["g"]
                          - g["g"])) / np.max(np.abs(g["g"]))),
        "dy(u)(y=Ly) / max|dy(u)|": float(
            np.max(np.abs(d3.Interpolate(dyu, "y", Ly).evaluate()["g"]))
            / np.max(np.abs(dyu.evaluate()["g"]))),
        "lap(u)+taus-f / max|f| (coeff)": float(
            np.max(np.abs((d3.lap(u) + lift(f["tau_1"], -1)
                           + lift(f["tau_2"], -2) - rhs).evaluate()["c"]))
            / np.max(np.abs(rhs["c"]))),
    }
    bounds = {"u(y=0)-g / max|g|": 1e-12, "dy(u)(y=Ly) / max|dy(u)|": bound,
              "lap(u)+taus-f / max|f| (coeff)": bound}
    log(f"{label} checks " + json.dumps(checks))
    bad = {k: v for k, v in checks.items() if not v <= bounds[k]}
    if bad:
        fail(f"{label}: checks out of bound: {bad}")
    return checks


def solution_of(fields):
    """The solved variables' coefficients, flattened, on the host."""
    import numpy as np
    return np.concatenate([np.asarray(fields[k]["c"]).ravel()
                           for k in ("u", "tau_1", "tau_2")])


def timed_solves(solver, f, n):
    """n warm solves, f changed on the card before each: the median
    device time (CUDA events) and host wall time (to a synchronize) of
    one solve, in ms."""
    import torch
    rhs = f["f"]
    f0 = rhs.coeff_data().clone()
    ev_ms, wall_ms = [], []
    for i in range(n):
        rhs["c"] = f0 * (1 + 1e-3 * (i + 1))
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        solver.solve()
        e1.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(e0.elapsed_time(e1))
    rhs["c"] = f0
    return statistics.median(ev_ms), statistics.median(wall_ms)


def poisson_run(label, Nx, Ny, matsolver, dtype="float64"):
    """Build, factor (in the build), solve and check one Poisson LBVP on
    the card (complex128: the ComplexFourier carrier, checked to 1e-12
    throughout); time POISSON_SOLVES warm solves and a re-factor; count
    the kernel's launches from the build to the last timed solve.
    Returns (record, solver, fields)."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_poisson_solver
    torch.cuda.reset_peak_memory_stats()
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    solver, f = build_poisson_solver(Nx, Ny, matsolver=matsolver,
                                     device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    rec = {"size": f"{Nx}x{Ny}", "matsolver": matsolver,
           "dtype": str(solver.pencil_dtype),
           "build_s": time.perf_counter() - t0,
           "build_phases_s": dict(solver.build_seconds),
           "pencil_shape": list(solver.pencil_shape),
           "ops": solver.ops.kind}
    if solver.ops.kind == "banded":
        rec.update(q=solver.ops.q, NB=solver.ops.NB, pins=solver.ops.t,
                   kl=solver.ops.kl, ku=solver.ops.ku,
                   factor_chunks=solver._aux["factor_chunks"])
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    rec["first_solve_s"] = time.perf_counter() - t0
    rec["solve_ms"], rec["solve_wall_ms"] = timed_solves(solver, f,
                                                         POISSON_SOLVES)
    rec["warm_solves"] = POISSON_SOLVES
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    if solver.ops.kind == "banded":
        rec["expected_launches"] = (1 if solver.ops.t else 0) \
            + (1 + POISSON_SOLVES) * (1 + solver.ops.sweeps)
    else:
        rec["expected_launches"] = 0
    rec["host_syncs_per_solve"], rec["host_sync_messages"] = \
        host_syncs(solver.solve, 1)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    solver.ops.factor(solver.L_mat)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    rec["checks"] = poisson_checks(label, f, 1e-12 if dtype == "complex128"
                                   else 1e-10)
    log(f"{label} " + json.dumps(rec))
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']}")
    if rec["host_syncs_per_solve"]:
        fail(f"{label}: {rec['host_syncs_per_solve']} host synchronizations "
             f"in a warm solve(): {rec['host_sync_messages']}")
    return rec, solver, f


def poisson_card_vs_cpu(Nx, Ny, matsolver, dtype="float64"):
    """The same Poisson LBVP solved on the card and on the CPU (held
    against the JAX package by tests/test_torch_bvp.py): max relative
    difference of the solutions, failing above 1e-12."""
    from dedalus_tpu_torch.extras.bench_problems import build_poisson_solver
    out = []
    for device in ("cuda", "cpu"):
        solver, f = build_poisson_solver(Nx, Ny, matsolver=matsolver,
                                         device=device, dtype=dtype)
        solver.solve()
        out.append(solution_of(f))
    label = f"{dtype} poisson{Nx}x{Ny} {matsolver}"
    err = rel_diff(out[0], out[1])
    log(f"{label} cuda vs cpu: {err:.3e}")
    if not err <= 1e-12:
        fail(f"{label} on the card disagrees with the CPU: {err:.3e}")
    return err


def newton_run(solver, u, tol, max_iter=30):
    """Newton iterations to `tol` of the perturbation norm: per iteration
    the synced seconds, split into the host Jacobian assembly (the
    solver's build phases of that rebuild) and the factor + solve."""
    import torch
    its = []
    error = float("inf")
    while error > tol and solver.iteration < max_iter:
        if solver.dist.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.newton_iteration()
        error = solver.perturbation_norm()
        total = time.perf_counter() - t0
        host = solver.build_seconds["host_assembly"] \
            + solver.build_seconds["structure"]
        its.append({"s": total, "host_assembly_s": host,
                    "factor_solve_s": total - host,
                    "perturbation_norm": error})
    return its


def bratu_phase(N):
    """bratu256: Newton from u = 0 on the card to a perturbation norm
    below 1e-10 (iterations, seconds per iteration split host/device,
    error against the closed form); N = 32 card vs CPU; the sin-Jacobi
    NLBVP of the JAX package's tests at N = 64 against cos(x)."""
    import numpy as np
    from dedalus_tpu_torch.extras.bench_problems import (
        build_bratu_solver, bratu_exact, build_sin_jacobi_solver)
    finals = []
    for device in ("cuda", "cpu"):
        s, u, x = build_bratu_solver(32, device=device)
        its = newton_run(s, u, 1e-10)
        finals.append((len(its), np.asarray(u["g"])))
    rec = {"card_vs_cpu_bratu32_rel": rel_diff(finals[0][1], finals[1][1]),
           "card_vs_cpu_iterations": [finals[0][0], finals[1][0]]}
    t0 = time.perf_counter()
    solver, u, x = build_bratu_solver(N, device="cuda")
    rec["build_s"] = time.perf_counter() - t0
    rec["ops"] = solver.ops.kind
    rec["iterations"] = newton_run(solver, u, 1e-10)
    rec["n_iterations"] = len(rec["iterations"])
    rec["max_err_vs_closed_form"] = float(
        np.max(np.abs(np.asarray(u["g"]) - bratu_exact(x))))
    rec["residual_norm"] = float(solver.residual_norm())
    s, u, x = build_sin_jacobi_solver(64, device="cuda")
    its = newton_run(s, u, 1e-6)
    rec["sin_jacobi64"] = {
        "iterations": len(its),
        "max_err_vs_cos": float(np.max(np.abs(np.asarray(u["g"])
                                              - np.cos(x))))}
    log(f"bratu{N} " + json.dumps(rec))
    checks = [
        (rec["card_vs_cpu_bratu32_rel"] <= 1e-12
         and finals[0][0] == finals[1][0], "bratu32 card vs CPU"),
        (rec["n_iterations"] <= 8, "Newton iterations <= 8"),
        (rec["max_err_vs_closed_form"] <= 1e-10, "error vs closed form"),
        (rec["sin_jacobi64"]["max_err_vs_cos"] <= 1e-6, "sin-Jacobi vs cos"),
    ]
    bad = [name for ok, name in checks if not ok]
    if bad:
        fail(f"bratu{N}: {bad}")
    return rec


def rbevp_phase(Nz, kxs, NEV=10):
    """rbevp64: the RB onset EVP at Ra = 1700 and 1710 for each kx (build
    and eigensolve seconds, the peak growth rate, which must change sign
    across Ra_c = 1707.76); the fastest Ra = 1710 mode put on the card by
    set_state: finite, and no-slip at both walls."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.extras.bench_problems import build_rb_evp
    rec = {"Nz": Nz, "NEV": NEV, "kx": list(map(float, kxs)), "runs": {}}
    for Ra in (1700, 1710):
        runs = []
        for kx in kxs:
            t0 = time.perf_counter()
            solver, fields = build_rb_evp(Nz, kx, Ra, device="cuda")
            t1 = time.perf_counter()
            evals = solver.solve_sparse(
                solver.subproblems_by_group[(1, None)], NEV, target=0)
            runs.append({"kx": float(kx), "build_s": t1 - t0,
                         "eigensolve_s": time.perf_counter() - t1,
                         "growth_rate": float(np.max(evals.imag))})
        rec["runs"][str(Ra)] = runs
    peak = {Ra: max(r["growth_rate"] for r in rec["runs"][str(Ra)])
            for Ra in (1700, 1710)}
    rec["peak_growth_rate"] = {str(k): v for k, v in peak.items()}
    best = max(rec["runs"]["1710"], key=lambda r: r["growth_rate"])
    solver, fields = build_rb_evp(Nz, best["kx"], 1710, device="cuda")
    evals = solver.solve_sparse(solver.subproblems_by_group[(1, None)], NEV,
                                target=0)
    solver.set_state(int(np.argmax(evals.imag)))
    u = fields["u"]
    ug = u["g"]
    walls = max(float(np.max(np.abs(d3.Interpolate(u, "z", z).evaluate()
                                     ["g"]))) for z in (0.0, 1.0))
    rec["mode"] = {"kx": best["kx"], "finite": bool(np.isfinite(ug).all()),
                   "device": str(u.data.device),
                   "no_slip_rel": walls / float(np.max(np.abs(ug)))}
    log(f"rbevp{Nz} " + json.dumps(rec))
    if not (peak[1710] > 0 > peak[1700]):
        fail(f"rbevp{Nz}: peak growth rates {peak} do not change sign "
             "across Ra_c = 1707.76")
    if not (rec["mode"]["finite"] and rec["mode"]["no_slip_rel"] <= 1e-10):
        fail(f"rbevp{Nz}: the fastest mode {rec['mode']}")
    if u.data.device.type != "cuda":
        fail(f"rbevp{Nz}: set_state left the mode on {u.data.device}")
    torch.cuda.synchronize()
    return rec


def waves_phase(N):
    """waves128: the Legendre string EVP by solve_dense(left=True): the
    lowest 8 eigenvalues against (n pi)^2 (1e-8 relative) and the left
    eigenvectors biorthonormal against -M (1e-8)."""
    import numpy as np
    from dedalus_tpu_torch.extras.bench_problems import build_waves_evp
    t0 = time.perf_counter()
    solver, u = build_waves_evp(N, device="cuda")
    t1 = time.perf_counter()
    sp = solver.subproblems[0]
    evals = solver.solve_dense(sp, left=True)
    t2 = time.perf_counter()
    idx = np.argsort(np.abs(evals))[:8]
    exact = (np.arange(1, 9) * np.pi) ** 2
    M = solver._group_csr(sp)["M"].toarray()
    B = np.conj(solver.left_eigenvectors[:, idx]).T @ (-M) \
        @ solver.eigenvectors[:, idx]
    rec = {"N": N, "build_s": t1 - t0, "eigensolve_s": t2 - t1,
           "max_rel_err_8": float(np.max(np.abs(evals[idx] - exact)
                                         / exact)),
           "biorthonormality_err": float(np.max(np.abs(B - np.eye(8))))}
    solver.set_state(int(idx[0]))
    rec["mode_finite"] = bool(np.isfinite(u["g"]).all())
    log(f"waves{N} " + json.dumps(rec))
    if not (rec["max_rel_err_8"] <= 1e-8
            and rec["biorthonormality_err"] <= 1e-8 and rec["mode_finite"]):
        fail(f"waves{N}: {rec}")
    return rec


def kdv_phase(N, steps):
    """kdv1024: build, factorizations, steps/s, host syncs, breakdown and
    profile; mass conservation; KdV 64 card vs CPU."""
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.extras.bench_problems import build_kdv_solver
    from dedalus_tpu_torch.extras.profile_step import profile_solver
    rec = {"size": N, "steps": steps, "card_vs_cpu_kdv64_rel": card_vs_cpu(
        "kdv64", lambda device: build_kdv_solver(64, device=device), 50)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt = build_kdv_solver(N, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["ops"] = f"{solver.ops.kind} {solver.ops.solver_cls.__name__}"
    u = solver.variables[0]
    mass = lambda: float(d3.integ(u).evaluate()["g"].ravel()[0])  # noqa: E731
    mass0 = mass()
    t0 = time.perf_counter()
    for _ in range(10):
        solver.step(dt)
    torch.cuda.synchronize()
    rec["warm_10_steps_s"] = time.perf_counter() - t0
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    check_no_host_syncs(f"kdv{N}", rec, solver, dt)
    rec["factorizations"] = solver.timestepper.factorizations
    rec["step_many"] = step_many_check(f"kdv{N}", solver, dt, 80, 20)
    rec["mass_drift_rel"] = abs(mass() - mass0) / abs(mass0)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.isfinite(solver.X).all()):
        fail("kdv: non-finite state")
    if rec["factorizations"] != 2:
        fail(f"kdv: {rec['factorizations']} factorizations, SBDF2 at "
             "constant dt makes 2")
    if not rec["mass_drift_rel"] <= 1e-13:
        fail(f"kdv: mass drift {rec['mass_drift_rel']:.3e} > 1e-13")
    rec["breakdown_ms"] = dense_breakdown(f"kdv{N}", solver, dt, 20)
    rec["profile"] = profile_solver(solver, dt, steps=20, warm=2)
    return rec


def shear_phase(N, steps, cfl_steps):
    """shear512: build, factor, steps/s, host syncs, peak memory,
    breakdown and profile; incompressibility, gauge and tracer checks;
    shear 32x32 card vs CPU; a CFL-driven run with the example's
    settings."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.extras.bench_problems import build_shear_solver
    from dedalus_tpu_torch.extras.profile_step import profile_solver
    rec = {"size": N, "steps": steps,
           "card_vs_cpu_shear32_rel": card_vs_cpu(
               "shear32", lambda device: build_shear_solver(
                   32, device=device), 10)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt = build_shear_solver(N, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["ops"] = f"{solver.ops.kind} {solver.ops.solver_cls.__name__}"
    t0 = time.perf_counter()
    solver.timestepper._ensure_factor(dt)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    f = {v.name: v for v in solver.variables}
    u, s, p, tau_p = f["u"], f["s"], f["p"], f["tau_p"]
    integ = lambda e: float(d3.integ(e).evaluate()["g"].ravel()[0])  # noqa: E731
    # integ(s) sits near 0 for this initial condition: its drift is taken
    # relative to integ(|s|)
    s0, s_abs = integ(s), integ(np.abs(s))
    t0 = time.perf_counter()
    for _ in range(10):
        solver.step(dt)
    torch.cuda.synchronize()
    rec["warm_10_steps_s"] = time.perf_counter() - t0
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    check_no_host_syncs(f"shear{N}", rec, solver, dt)
    rec["step_many"] = step_many_check(f"shear{N}", solver, dt, 50, 10)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.isfinite(solver.X).all()):
        fail("shear: non-finite state")
    div = (d3.div(u) + tau_p).evaluate()["c"]
    grad = d3.grad(u).evaluate()["c"]
    checks = {"div(u)+tau_p / max|grad u|":
              float(np.max(np.abs(div)) / np.max(np.abs(grad))),
              "|integ(p)|": abs(integ(p)),
              "integ(s) drift / integ(|s|)": abs(integ(s) - s0) / s_abs}
    rec["checks"] = checks
    log(f"shear{N} checks " + json.dumps(checks))
    bounds = {"div(u)+tau_p / max|grad u|": 1e-10, "|integ(p)|": 1e-10,
              "integ(s) drift / integ(|s|)": 1e-12}
    bad = {k: v for k, v in checks.items() if not v <= bounds[k]}
    if bad:
        fail(f"shear{N}: checks out of bound: {bad}")
    cfl = d3.CFL(solver, initial_dt=1e-2, cadence=10, safety=0.2,
                 threshold=0.1, max_change=1.5, min_change=0.5, max_dt=1e-2)
    cfl.add_velocity(u)
    rec["breakdown_ms"] = dense_breakdown(f"shear{N}", solver, dt, 10, cfl)
    rec["profile"] = profile_solver(solver, dt, steps=10, warm=2)
    # the main loop of examples/shear_flow.py
    factorizations = solver.timestepper.factorizations
    t0 = time.perf_counter()
    for _ in range(cfl_steps):
        solver.step(cfl.compute_timestep())
    torch.cuda.synchronize()
    dts = [h["dt"] for h in cfl.history]
    rec["cfl"] = {"steps": cfl_steps, "dt": dts,
                  "refactorizations": solver.timestepper.factorizations
                  - factorizations,
                  "steps_per_s": cfl_steps / (time.perf_counter() - t0)}
    log(f"shear{N} CFL run " + json.dumps(rec["cfl"]))
    if not (bool(torch.isfinite(solver.X).all())
            and all(0 < dt <= 1e-2 for dt in dts)):
        fail(f"shear{N}: the CFL run gave a bad state or dt")
    return rec


def sw_balance_checks(label, solver, balance):
    """Re-solve the balanced-height LBVP (a warm solve on the card, timed)
    and check it: |ave(h)| <= 1e-13 max|h| and the tau-corrected residual
    L - F of its first equation <= 1e-10 max|F| (coefficients). Then put
    the IVP's state back (h = balanced + perturbation), so the steps start
    where the build left them."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.tools import carry
    X0 = solver.X.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    balance.solve()
    torch.cuda.synchronize()
    rec = {"balance_solve_s": time.perf_counter() - t0,
           "balance_pencil_shape": list(balance.pencil_shape),
           "balance_ops": balance.ops.kind,
           "balance_build_phases_s": dict(balance.build_seconds)}
    h = balance.variables[0]
    eq = balance.problem.equations[0]
    resid = (eq["L"] - eq["F"]).evaluate()["c"]
    checks = {
        "|ave(h)| / max|h|": float(
            np.abs(d3.ave(h).evaluate()["g"]).max() / np.abs(h["g"]).max()),
        "balance L-F / max|F| (coeff)": float(
            np.abs(resid).max() / np.abs(eq["F"].evaluate()["c"]).max()),
    }
    bounds = {"|ave(h)| / max|h|": 1e-13,
              "balance L-F / max|F| (coeff)": 1e-10}
    rec["checks"] = checks
    log(f"{label} balance checks " + json.dumps(checks))
    bad = {k: v for k, v in checks.items() if not v <= bounds[k]}
    if bad:
        fail(f"{label}: balance checks out of bound: {bad}")
    carry.install_state(solver, X0)
    return rec


def sw_phase(Nphi, Ntheta, steps):
    """sw512x256 (benchmarks/progression.py config 4 through the port's
    build_shallow_water: the Galewsky jet, balanced-height LBVP, then
    RK222 at dt = 300 s in simulation units, 'auto' -> banded): build,
    the balance checks, the factoring first step and `steps` timed
    steps, launches against 1 + 4 (1 + steps), host syncs, mass conservation, the vorticity
    through a DictionaryHandler, peak memory, the breakdown; the kernel
    at this factor's operators; sw64x32 forced banded card vs CPU."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_shallow_water
    from dedalus_tpu_torch.extras.profile_step import profile_solver
    rec = {"size": f"{Nphi}x{Ntheta}", "steps": steps,
           "card_vs_cpu_sw64x32_banded_rel": card_vs_cpu(
               "sw64x32 banded", lambda device: build_shallow_water(
                   64, 32, np.float64, matsolver="banded",
                   device=device)[:2], 10)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt, balance = build_shallow_water(Nphi, Ntheta, np.float64,
                                              device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["ops"] = solver.ops.kind
    if solver.ops.kind != "banded":
        fail(f"sw{Nphi}x{Ntheta} under 'auto' took the {solver.ops.kind} "
             "path")
    st = solver.structure
    rec.update(q=st.q, NB=st.NB, pins=st.t_pins, kl=st.kl, ku=st.ku,
               dense_GB=solver.pencil_shape[0] * solver.pencil_shape[1] ** 2
               * 8 / 1e9)
    log(f"sw{Nphi}x{Ntheta} build " + json.dumps(rec))
    rec.update(sw_balance_checks(f"sw{Nphi}x{Ntheta}", solver, balance))
    h = solver.variables[1]
    mass = lambda: float(d3.integ(h).evaluate()["g"].ravel()[0])  # noqa: E731
    mass0 = mass()
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    solver.step(dt)
    torch.cuda.synchronize()
    rec["first_step_s"] = time.perf_counter() - t0
    rec["factor_chunks"] = solver.timestepper._lhs_aux[0]["factor_chunks"]
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    rec["expected_launches"], _ = expected_launches(solver, 1 + steps,
                                                    factorizations=1)
    if rec["launches"] != rec["expected_launches"]:
        fail(f"sw{Nphi}x{Ntheta}: {rec['launches']} kernel launches, "
             f"expected {rec['expected_launches']}")
    check_no_host_syncs(f"sw{Nphi}x{Ntheta}", rec, solver, dt)
    rec["step_many"] = step_many_check(f"sw{Nphi}x{Ntheta}", solver, dt, 20,
                                       5)
    hmax = float(np.abs(h["g"]).max())
    rec["mass_drift / (4 pi max|h|)"] = abs(mass() - mass0) \
        / (4 * np.pi * hmax)
    if not bool(torch.isfinite(solver.X).all()):
        fail(f"sw{Nphi}x{Ntheta}: non-finite state")
    if not rec["mass_drift / (4 pi max|h|)"] <= 1e-12:
        fail(f"sw{Nphi}x{Ntheta}: mass drift "
             f"{rec['mass_drift / (4 pi max|h|)']:.3e} > 1e-12")
    # the example's snapshot tasks, through a DictionaryHandler
    u = solver.variables[0]
    handler = solver.evaluator.add_dictionary_handler(iter=1)
    handler.add_task(h, name="height")
    handler.add_task(-d3.div(d3.Skew(u)), name="vorticity")
    solver.step(dt)
    vort = np.asarray(handler["vorticity"])
    rec["vorticity_max"] = float(np.abs(vort).max())
    if vort.shape != (Nphi, Ntheta) or not np.isfinite(vort).all():
        fail(f"sw{Nphi}x{Ntheta}: bad vorticity task {vort.shape}")
    solver.evaluator.handlers.remove(handler)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"sw{Nphi}x{Ntheta} " + json.dumps(rec))
    rec["breakdown_ms"] = breakdown(f"sw{Nphi}x{Ntheta}", solver, dt, 5)
    rec["profile"] = profile_solver(solver, dt, steps=5, warm=1)
    log(f"sw{Nphi}x{Ntheta} profile " + json.dumps(rec["profile"]))
    fsub = {k: solver.timestepper._lhs_aux[0]["fsub"][k]
            for k in ("FwdOp", "BwdOp", "lastOp")}
    gen = torch.Generator(device="cuda").manual_seed(7)
    fp = torch.randn((fsub["lastOp"].shape[0], solver.ops.n_pad),
                     generator=gen, device="cuda", dtype=torch.float64)
    kernel = check_kernel(f"sw{Nphi}x{Ntheta}-factors", fsub, fp)
    return rec, kernel


def complex_phase(Nx, Ny):
    """Complex banded solves (the complex kernel): the complex128 Poisson
    (ComplexFourier x ChebyshevT) at 64x32 forced banded, card vs CPU; at Nx x Ny under 'auto' (banded above the 1 GiB cutoff) with the
    Poisson checks at 1e-12; the kernel vs plain at its factor's
    operators in complex128 and complex64."""
    import torch
    rec = {"card_vs_cpu_64x32_banded_rel": poisson_card_vs_cpu(
        64, 32, "banded", "complex128")}
    run, solver, f = poisson_run(f"complex poisson{Nx}x{Ny}", Nx, Ny, None,
                                 "complex128")
    if run["ops"] != "banded":
        fail(f"complex poisson{Nx}x{Ny} under 'auto' took the {run['ops']} "
             "path")
    run["dense_GB"] = run["pencil_shape"][0] * run["pencil_shape"][1] ** 2 \
        * 16 / 1e9
    rec.update(run)
    fsub = {k: solver._aux["fsub"][k] for k in ("FwdOp", "BwdOp", "lastOp")}
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = (fsub["lastOp"].shape[0], solver.ops.n_pad)
    fp = torch.complex(
        torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64),
        torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64))
    kernels = [check_kernel(f"complex-poisson{Nx}x{Ny}-factors", fsub, fp),
               check_kernel(f"complex-poisson{Nx}x{Ny}-factors",
                            {k: v.to(torch.complex64).contiguous()
                             for k, v in fsub.items()},
                            fp.to(torch.complex64))]
    return rec, kernels


HISTORIES = ("F_hist", "MX_hist", "LX_hist")


def snapshot(solver):
    """The solver's stepping state on the card (state, time, counters,
    the multistep histories), to take the same steps twice."""
    ts = solver.timestepper
    return {"X": solver.X.clone(), "sim_time": solver.sim_time,
            "iteration": solver.iteration, "ts_iteration": ts.iteration,
            "dt_hist": list(getattr(ts, "dt_hist", [])),
            "hists": [h.clone() for name in HISTORIES
                      for h in getattr(ts, name, [])]}


def restore(solver, snap):
    """Put a snapshot back, the histories into their own buffers."""
    ts = solver.timestepper
    solver.X = snap["X"].clone()
    solver.defer_scatter(solver.X)
    solver.snapshot_versions()
    solver.sim_time = snap["sim_time"]
    solver.iteration = snap["iteration"]
    ts.iteration = snap["ts_iteration"]
    if hasattr(ts, "dt_hist"):
        ts.dt_hist = list(snap["dt_hist"])
    live = [h for name in HISTORIES for h in getattr(ts, name, [])]
    for h, saved in zip(live, snap["hists"]):
        h.copy_(saved)


def reset_launches():
    from dedalus_tpu_torch.core import fusedstep
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0


def step_many_check(label, solver, dt, n, prof_steps):
    """The same n steps from the same state as a loop of step and as
    step_many (the step recorded as a CUDA graph and replayed): the
    states must be bit-equal, else within 1e-13 relative; the block runs
    twice, the second time replaying the recording of the first (it must
    record nothing). Steps/s of the loop and of the replayed block, the
    recording block's seconds, the kernel's launches in each run (equal),
    host syncs of a replayed block (0), and the idle share of a step in a
    loop and in a block (torch.profiler, extras/profile_step.py). The
    window must not reach an iteration where either run re-projects."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.profile_step import profile_solver
    ts = solver.timestepper
    cadence = solver.enforce_real_cadence
    r = solver.iteration % cadence if cadence else 0
    if cadence and (r < ts.steps or cadence - r < n):
        fail(f"{label} step_many: iterations {solver.iteration}.."
             f"{solver.iteration + n} reach the re-projection cadence")
    snap = snapshot(solver)
    runs = {}
    for run in ("loop", "record", "replay"):
        if run != "loop":
            restore(solver, snap)
        recordings = ts.recordings
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "loop":
            for _ in range(n):
                solver.step(dt)
        else:
            solver.step_many(n, dt)
        torch.cuda.synchronize()
        runs[run] = {"s": time.perf_counter() - t0,
                     "launches": fusedstep.LAUNCHES["banded_subst"],
                     "recordings": ts.recordings - recordings,
                     "X": solver.X.clone()}
    ref = runs["loop"]["X"]
    rec = {"steps": n, "start_iteration": snap["iteration"],
           "loop_steps_per_s": n / runs["loop"]["s"],
           "block_steps_per_s": n / runs["replay"]["s"],
           "record_block_s": runs["record"]["s"],
           "launches": {k: v["launches"] for k, v in runs.items()},
           "recordings": {k: v["recordings"] for k, v in runs.items()}}
    for run in ("record", "replay"):
        X = runs[run]["X"]
        rec[f"{run}_bit_equal"] = bool(torch.equal(X, ref))
        rec[f"{run}_max_rel_diff"] = float(
            (X - ref).abs().max() / ref.abs().max())
    rec["block_speedup"] = rec["block_steps_per_s"] / rec["loop_steps_per_s"]
    rec["host_syncs_per_block"], rec["host_sync_messages"] = host_syncs(
        lambda: solver.step_many(n, dt), 1)
    rec["profile_loop"] = profile_solver(solver, dt, prof_steps, warm=1)
    rec["profile_block"] = profile_solver(solver, dt, prof_steps, warm=1,
                                          block=True)
    log(f"{label} step_many vs step " + json.dumps(rec))
    bad = []
    if rec["recordings"] != {"loop": 0, "record": 1, "replay": 0}:
        bad.append(f"recordings {rec['recordings']}")
    if len(set(rec["launches"].values())) != 1:
        bad.append(f"launches {rec['launches']}")
    for run in ("record", "replay"):
        if not rec[f"{run}_max_rel_diff"] <= 1e-13:
            bad.append(f"{run} differs from the loop by "
                       f"{rec[f'{run}_max_rel_diff']:.3e}")
    if rec["host_syncs_per_block"]:
        bad.append(f"host syncs {rec['host_sync_messages']}")
    if bad:
        fail(f"{label} step_many: {bad}")
    return rec


def rb3d_card_vs_cpu(sizes, steps):
    """3-D RB forced banded at a small size on the card and on the CPU
    (held against the JAX package by tests/test_torch_rb3d.py): p, b and
    u within 1e-12 relative each, the taus within 1e-12 of the largest
    state entry (a tau of the mean mode can sit at round-off level)."""
    import numpy as np
    from dedalus_tpu_torch.extras.bench_problems import build_rb3d
    out = {}
    for device in ("cuda", "cpu"):
        solver, dt = build_rb3d(*sizes, np.float64, matsolver="banded",
                                device=device)
        for _ in range(steps):
            solver.step(dt)
        out[device] = ({v.name: np.asarray(v["c"]) for v in solver.variables},
                       float(solver.X.abs().max()))
    scale = out["cpu"][1]
    errs = {}
    for name, ref in out["cpu"][0].items():
        diff = np.max(np.abs(out["cuda"][0][name] - ref))
        errs[name] = float(diff / (scale if name.startswith("tau")
                                   else np.max(np.abs(ref))))
    label = "rb3d " + "x".join(map(str, sizes))
    log(f"{label} cuda vs cpu, {steps} steps: " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 1e-12}
    if bad:
        fail(f"{label} on the card disagrees with the CPU run: {bad}")
    return errs


def rb3d_phase(sizes, steps):
    """rb3d_128 (benchmarks/progression.py config 5 on one card through
    the port's build_rb3d, 'auto' -> banded, q = 80): the small card vs
    CPU check; build with its phases, factor, the factoring first step
    and `steps` timed steps (steps/s), launches = 1 + 4 (1 + steps), host
    syncs, peak memory, BCs and incompressibility; the kernel at this
    factor's operators (k = 1 and the Woodbury k = pins, f64); step_many
    against the loop of step; the breakdown. Returns (record, the
    kernel's k = 1 record)."""
    import numpy as np
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_rb3d
    label = "rb3d_" + "x".join(map(str, sizes))
    rec = {"size": "x".join(map(str, sizes)), "steps": steps,
           "card_vs_cpu_" + "x".join(map(str, RB3D_SMALL)):
               rb3d_card_vs_cpu(RB3D_SMALL, 10)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt = build_rb3d(*sizes, np.float64, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["ops"] = solver.ops.kind
    if solver.ops.kind != "banded":
        fail(f"{label} under 'auto' took the {solver.ops.kind} path")
    st = solver.structure
    G, S = solver.pencil_shape
    rec.update(S=st.S, q=st.q, NB=st.NB, pins=st.t_pins, kl=st.kl, ku=st.ku,
               dense_GB=G * S * S * 8 / 1e9,
               after_build_GB=torch.cuda.memory_allocated() / 1e9)
    log(f"{label} build " + json.dumps(rec))
    reset_launches()
    t0 = time.perf_counter()
    solver.timestepper._ensure_factor(dt)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    rec["factor_chunks"] = solver.timestepper._lhs_aux[0]["factor_chunks"]
    rec["after_factor_GB"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    solver.step(dt)
    torch.cuda.synchronize()
    rec["first_step_s"] = time.perf_counter() - t0
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    rec["expected_launches"], _ = expected_launches(solver, 1 + steps,
                                                    factorizations=1)
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']}")
    check_no_host_syncs(label, rec, solver, dt)
    b = next(v for v in solver.variables if v.name == "b")
    rec["checks"] = rb_checks(label, solver, b)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label} " + json.dumps(rec))
    rec["step_many"] = step_many_check(label, solver, dt, 10, 3)
    aux = solver.timestepper._lhs_aux[0]
    fsub = {k: aux["fsub"][k] for k in ("FwdOp", "BwdOp", "lastOp")}
    gen = torch.Generator(device="cuda").manual_seed(11)
    fp = torch.randn((G, solver.ops.n_pad), generator=gen, device="cuda",
                     dtype=torch.float64)
    kernel = check_kernel(f"{label}-factors", fsub, fp)
    fpw = torch.randn((G, solver.ops.t, solver.ops.n_pad), generator=gen,
                      device="cuda", dtype=torch.float64)
    rec["woodbury_kernel"] = check_kernel(f"{label}-factors-woodbury", fsub,
                                          fpw)
    del fp, fpw, aux, fsub
    rec["breakdown_ms"] = breakdown(label, solver, dt, 5, factor=False)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    return rec, kernel


def complex_ivp_phase(Nx, Nz, steps):
    """The complex128 IVP of build_complex_ivp (ComplexFourier x
    ChebyshevT, b*b, taus): 32x16 forced banded card vs CPU (1e-12); at
    Nx x Nz under 'auto' (banded: dense would be 4.3 GB) the factoring
    first step and `steps` timed steps, launches = 1 + 4 (1 + steps),
    host syncs, a finite state, peak memory."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_complex_ivp
    label = f"complex ivp{Nx}x{Nz}"
    rec = {"size": f"{Nx}x{Nz}", "steps": steps,
           "card_vs_cpu_32x16_banded_rel": card_vs_cpu(
               "complex ivp32x16 banded", lambda device: build_complex_ivp(
                   32, 16, "banded", device=device), 10)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt = build_complex_ivp(Nx, Nz, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["dtype"] = str(solver.pencil_dtype)
    rec["ops"] = solver.ops.kind
    if solver.ops.kind != "banded":
        fail(f"{label} under 'auto' took the {solver.ops.kind} path")
    st = solver.structure
    G, S = solver.pencil_shape
    rec.update(q=st.q, NB=st.NB, pins=st.t_pins, kl=st.kl, ku=st.ku,
               dense_GB=G * S * S * 16 / 1e9)
    reset_launches()
    t0 = time.perf_counter()
    solver.step(dt)
    torch.cuda.synchronize()
    rec["first_step_s"] = time.perf_counter() - t0
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    rec["expected_launches"], _ = expected_launches(solver, 1 + steps,
                                                    factorizations=1)
    check_no_host_syncs(label, rec, solver, dt)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    rec["finite"] = bool(torch.isfinite(solver.X).all())
    log(f"{label} " + json.dumps(rec))
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']}")
    if not rec["finite"] or solver.X.dtype != torch.complex128:
        fail(f"{label}: a non-finite or non-complex128 state")
    return rec


def expected_launches(solver, steps, factorizations):
    """One launch per factorization (the Woodbury solve) and one per
    solve, whatever the factor's G-chunk count; also returns that count."""
    ts = solver.timestepper
    solves = steps * ts.stages * (1 + solver.ops.sweeps)
    return factorizations + solves, ts._lhs_aux[0]["factor_chunks"]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--real", type=int, nargs=2, default=(2048, 1024),
                        metavar=("NX", "NZ"))
    parser.add_argument("--real-steps", type=int, default=10)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    phase_t0 = [time.perf_counter()]

    def phase_done(name):
        """Print the phase's seconds and write the results so far."""
        now = time.perf_counter()
        RESULTS.setdefault("phase_s", {})[name] = now - phase_t0[0]
        log(f"phase {name}: {now - phase_t0[0]:.2f} s")
        phase_t0[0] = now
        (out_dir / "chip_smoke.json").write_text(json.dumps(RESULTS,
                                                            indent=1))

    # ---------------------------------------------------------- phase 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    RESULTS["card"] = card
    RESULTS["torch"] = torch.__version__
    RESULTS["cuda"] = torch.version.cuda
    RESULTS["python"] = sys.version.split()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    fusedstep.load_kernel_library()
    RESULTS["kernel_build_s"] = time.perf_counter() - t0
    log(f"kernel build: {RESULTS['kernel_build_s']:.2f} s")
    RESULTS["ptxas"] = fusedstep.ptxas_report()
    log(RESULTS["ptxas"])
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_done("1 card and build")

    # ---------------------------------------------------------- phase 2
    Gr, NBr, qr = 1024, 257, 32       # RB 2048x1024: G = Nx/2, NB, q
    for dtype, seed, k in ((torch.float64, 1, 1), (torch.float32, 2, 1),
                           (torch.float64, 4, 16)):
        fsub, fp = random_fsub(Gr, NBr, qr, dtype, seed, k)
        check_kernel("rb2048x1024-random" + ("-woodbury" if k > 1 else ""),
                     fsub, fp)
        del fsub, fp
    torch.cuda.empty_cache()
    phase_done("2 kernel vs plain")

    # ---------------------------------------------------------- phase 3
    # a small input against the port's CPU path (held against the JAX
    # package by tests/test_torch_rb.py)
    RESULTS["rb8x32_cuda_vs_cpu_rel"] = card_vs_cpu(
        "rb8x32", lambda device: (build_rb_solver(
            8, 32, np.float64, matsolver="banded", device=device)[0], 0.01),
        10)

    dt = 1e-3
    t0 = time.perf_counter()
    solver, b = build_rb_solver(256, 64, np.float64, matsolver="banded",
                                device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    solver.step(dt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.steps - 1):
        solver.step(dt)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(fusedstep.LAUNCHES)
    expect, chunks = expected_launches(solver, args.steps, factorizations=1)
    main = {"size": "256x64", "steps": args.steps, "build_s": build_s,
            "first_step_s": first_s,
            "steps_per_s": (args.steps - 1) / run_s,
            "launches": launches["banded_subst"],
            "expected_launches": expect, "chunks": chunks,
            "pencil_shape": list(solver.pencil_shape),
            "q": solver.ops.q, "NB": solver.ops.NB, "pins": solver.ops.t}
    log("main path rb256x64 " + json.dumps(main))
    RESULTS["main"] = main
    if launches["banded_subst"] != expect:
        fail(f"kernel launches on the main path {launches['banded_subst']} "
             f"!= expected {expect}")
    main["checks"] = rb_checks("rb256x64", solver, b)
    x_banded = solver.X.cpu().numpy()
    check_no_host_syncs("rb256x64", main, solver, dt)
    main["step_many"] = step_many_check("rb256x64", solver, dt, 20, 5)

    # the same run with matsolver=None: 'auto' takes the dense path here
    # (the JAX package's rule, written for a TPU, sizes it at 283 MB)
    t0 = time.perf_counter()
    dsolver, _ = build_rb_solver(256, 64, np.float64, device="cuda")
    torch.cuda.synchronize()
    dense = {"size": "256x64", "steps": args.steps,
             "build_s": time.perf_counter() - t0,
             "ops": f"{dsolver.ops.kind} {dsolver.ops.solver_cls.__name__}"}
    t0 = time.perf_counter()
    dsolver.timestepper._ensure_factor(dt)
    torch.cuda.synchronize()
    dense["factor_s"] = time.perf_counter() - t0
    dsolver.step(dt)
    dense["steps_per_s"] = steps_per_s(dsolver, dt, args.steps - 1)
    dense["vs_banded_rel"] = rel_diff(dsolver.X.cpu().numpy(), x_banded)
    check_no_host_syncs("rb256x64 dense", dense, dsolver, dt)
    dense["banded"] = {"steps_per_s": main["steps_per_s"]}
    t0 = time.perf_counter()
    solver.ops.factor_lincomb(1.0, solver.M_mat,
                              dt * solver.timestepper.uniq_H_diag[0],
                              solver.L_mat)
    torch.cuda.synchronize()
    dense["banded"]["factor_s"] = time.perf_counter() - t0
    log("rb256x64 dense vs banded " + json.dumps(dense))
    RESULTS["rb256x64_dense"] = dense
    if dense["ops"].split()[0] != "dense":
        fail(f"rb256x64 with matsolver=None took {dense['ops']}")
    if not dense["vs_banded_rel"] <= 1e-10:
        fail(f"rb256x64 dense state differs from the banded one: "
             f"{dense['vs_banded_rel']:.3e}")
    del dsolver

    # the kernel at the main path's own shapes and factor operators
    aux = solver.timestepper._lhs_aux[0]
    fsub64 = aux["fsub"]
    fsub64 = {k: fsub64[k] for k in ("FwdOp", "BwdOp", "lastOp")}
    G, q = fsub64["lastOp"].shape[:2]
    gen = torch.Generator(device="cuda").manual_seed(3)
    fp64 = torch.randn((G, solver.ops.n_pad), generator=gen, device="cuda",
                       dtype=torch.float64)
    main_rec = check_kernel("rb256x64-factors", fsub64, fp64)
    check_kernel("rb256x64-factors",
                 {k: v.float().contiguous() for k, v in fsub64.items()},
                 fp64.float())

    RESULTS["breakdown_rb256x64_ms"] = breakdown("rb256x64", solver, dt, 20)
    del solver, b, aux, fsub64, fp64
    release()
    phase_done("3 rb256x64")

    # ---------------------------------------------------------- phase 4
    Nx, Nz = args.real
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, b = build_rb_solver(Nx, Nz, np.float64, matsolver="banded",
                                device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver.timestepper._ensure_factor(dt)
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for _ in range(args.real_steps):
        solver.step(dt)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    expect, chunks = expected_launches(solver, args.real_steps,
                                       factorizations=0)
    real = {"size": f"{Nx}x{Nz}", "steps": args.real_steps,
            "build_s": build_s, "build_phases_s": solver.build_seconds,
            "factor_s": factor_s, "steps_per_s": args.real_steps / run_s,
            "launches": fusedstep.LAUNCHES["banded_subst"],
            "expected_launches": expect, "chunks": chunks,
            "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
            "pencil_shape": list(solver.pencil_shape),
            "q": solver.ops.q, "NB": solver.ops.NB, "pins": solver.ops.t}
    log(f"real size rb{Nx}x{Nz} " + json.dumps(real))
    RESULTS["real"] = real
    if real["launches"] != expect:
        fail(f"kernel launches at real size {real['launches']} != "
             f"expected {expect}")
    real["checks"] = rb_checks(f"rb{Nx}x{Nz}", solver, b)
    RESULTS[f"breakdown_rb{Nx}x{Nz}_ms"] = breakdown(f"rb{Nx}x{Nz}", solver,
                                                     dt, 5)
    del solver, b
    release()
    phase_done(f"4 rb{Nx}x{Nz}")

    def dense_path(path, run):
        """Run a path that takes the dense solve with the substitution
        kernel's count set to 0 just before it; record the count read
        just after, which must stay 0."""
        for name in fusedstep.LAUNCHES:
            fusedstep.LAUNCHES[name] = 0
        rec = run()
        n = fusedstep.LAUNCHES["banded_subst"]
        RESULTS.setdefault("dense_path_launches", {})[path] = n
        if n:
            fail(f"the dense {path} path launched the banded kernel {n} "
                 "times")
        return rec

    # ---------------------------------------------------------- phase 5
    RESULTS["kdv"] = dense_path("kdv1024", lambda: kdv_phase(1024, 500))
    log("kdv1024 " + json.dumps(RESULTS["kdv"]))
    release()
    phase_done("5 kdv1024")

    # ---------------------------------------------------------- phase 6
    RESULTS["shear"] = dense_path("shear512",
                                  lambda: shear_phase(512, 100, 30))
    log("shear512 " + json.dumps(RESULTS["shear"]))
    release()
    phase_done("6 shear512")

    # ---------------------------------------------------------- phase 7
    # the boundary value problems: card vs CPU at 64x32 on the banded path
    # (held against the JAX package by tests/test_torch_bvp.py), then
    # Poisson at the target resolution through the public API, 'auto'
    # picking the banded path there (dense would be 34.5 GB)
    RESULTS["poisson64x32_cuda_vs_cpu_rel"] = poisson_card_vs_cpu(
        64, 32, "banded")
    rec, solver, f = poisson_run("poisson2048x1024", 2048, 1024, None)
    if rec["ops"] != "banded":
        fail(f"poisson2048x1024 under 'auto' took the {rec['ops']} path")
    RESULTS["poisson2048x1024"] = rec
    fsub = {k: solver._aux["fsub"][k] for k in ("FwdOp", "BwdOp", "lastOp")}
    gen = torch.Generator(device="cuda").manual_seed(5)
    fp = torch.randn((fsub["lastOp"].shape[0], solver.ops.n_pad),
                     generator=gen, device="cuda", dtype=torch.float64)
    poisson_kernel = check_kernel("poisson2048x1024-factors", fsub, fp)
    del solver, f, fsub, fp
    release()
    phase_done("7 poisson2048x1024")

    # ---------------------------------------------------------- phase 8
    # the example's own size: 'auto' takes the dense path (69 MB), as the
    # JAX package does off the TPU; the banded path of the same problem
    # beside it
    dense, dsolver, dfields = poisson_run("poisson256x128", 256, 128, None)
    if dense["ops"] != "dense":
        fail(f"poisson256x128 under 'auto' took the {dense['ops']} path")
    banded, bsolver, bfields = poisson_run("poisson256x128 banded", 256, 128,
                                           "banded")
    dense["banded"] = banded
    dense["banded_vs_dense_rel"] = rel_diff(solution_of(bfields),
                                            solution_of(dfields))
    log("poisson256x128 dense vs banded: solve ms "
        f"{dense['solve_ms']:.4f} vs {banded['solve_ms']:.4f}, factor s "
        f"{dense['factor_s']:.4f} vs {banded['factor_s']:.4f}, solutions "
        f"{dense['banded_vs_dense_rel']:.3e} apart")
    RESULTS["poisson256x128"] = dense
    if not dense["banded_vs_dense_rel"] <= 1e-12:
        fail("poisson256x128: banded and dense solutions differ by "
             f"{dense['banded_vs_dense_rel']:.3e}")
    del dsolver, dfields, bsolver, bfields
    release()
    phase_done("8 poisson256x128")

    # ---------------------------------------------------------- phase 9
    # the nonlinear BVPs (dense under 'auto') and the EVPs (host
    # eigensolves) launch no substitution
    RESULTS["bratu"] = dense_path("bratu256", lambda: bratu_phase(256))
    release()
    phase_done("9 bratu256")

    # --------------------------------------------------------- phase 10
    RESULTS["rbevp"] = dense_path(
        "rbevp64", lambda: rbevp_phase(64, np.linspace(3.0, 3.25, 5)))
    release()
    phase_done("10 rbevp64")

    # --------------------------------------------------------- phase 11
    RESULTS["waves"] = dense_path("waves128", lambda: waves_phase(128))
    release()
    phase_done("11 waves128")

    # --------------------------------------------------------- phase 12
    # the sphere: progression config 4 through the banded kernel at q = 7
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    RESULTS["sw"], sw_kernel = sw_phase(*SW_SIZE, SW_STEPS)
    release()
    phase_done("12 sw512x256")

    # --------------------------------------------------------- phase 13
    # complex banded solves on the card (the complex instantiations)
    RESULTS["complex_poisson"], complex_kernels = complex_phase(1024, 512)
    release()
    phase_done("13 complex poisson1024x512")

    # --------------------------------------------------------- phase 14
    # 3-D Rayleigh-Benard at config 5's one-card size through the kernel
    # at q = 80
    reset_launches()
    RESULTS["rb3d"], rb3d_kernel = rb3d_phase(RB3D_SIZE, RB3D_STEPS)
    release()
    phase_done("14 rb3d_128")

    # --------------------------------------------------------- phase 15
    # a complex IVP through the complex kernel
    RESULTS["complex_ivp"] = complex_ivp_phase(*CIVP_SIZE, CIVP_STEPS)
    release()
    phase_done("15 complex ivp1024x512")

    # --------------------------------------------------------- phase 16
    # times and bound at this slice's main path shapes (rb3d_128's own
    # factor operators, q = 80, f64); the errors are the worst over every
    # kernel-vs-plain check (f32 and complex ones included), each also
    # listed with its relative bound, times and byte bound
    checks = [{k: rec[k] for k in ("shape", "dtype", "k", "max_abs_err",
                                   "max_rel_err", "bound_rel", "ms",
                                   "cold_ms", "stream_ms", "plain_ms",
                                   "bound_ms", "share_of_bound")}
              for rec in RESULTS["kernel_checks"]]
    by_path = {"rb256x64": launches["banded_subst"],
               f"rb{Nx}x{Nz}": real["launches"],
               "poisson2048x1024": RESULTS["poisson2048x1024"]["launches"],
               "poisson256x128 banded": banded["launches"],
               "poisson256x128 dense": dense["launches"],
               "sw512x256": RESULTS["sw"]["launches"],
               "complex poisson1024x512":
                   RESULTS["complex_poisson"]["launches"],
               "rb3d_128": RESULTS["rb3d"]["launches"],
               "complex ivp1024x512": RESULTS["complex_ivp"]["launches"],
               **{f"{path} step_many": rec["step_many"]["launches"]["replay"]
                  for path, rec in (("rb256x64", main), ("kdv1024",
                                                          RESULTS["kdv"]),
                                    ("shear512", RESULTS["shear"]),
                                    ("sw512x256", RESULTS["sw"]),
                                    ("rb3d_128", RESULTS["rb3d"]))},
               **RESULTS["dense_path_launches"]}
    kernels = {"kernels": [{
        "name": "banded_subst", "route": "cuda",
        "source": "dedalus_tpu_torch/csrc/banded_subst.cu",
        "replaces": "dedalus_tpu/core/fusedstep.py:520",
        "launches": RESULTS["rb3d"]["launches"],
        "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "max_rel_err": max(c["max_rel_err"] for c in checks),
        "ms": rb3d_kernel["ms"], "cold_ms": rb3d_kernel["cold_ms"],
        "stream_ms": rb3d_kernel["stream_ms"],
        "plain_ms": rb3d_kernel["plain_ms"],
        "bound_ms": rb3d_kernel["bound_ms"],
        "bound_by": rb3d_kernel["bound_by"],
        "library_ms": None,
        **{path: {k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")}
           for path, rec in (("rb256x64", main_rec),
                             ("sw512x256", sw_kernel),
                             ("rb3d_128 woodbury",
                              RESULTS["rb3d"]["woodbury_kernel"]),
                             ("poisson2048x1024", poisson_kernel),
                             ("complex128 poisson1024x512",
                              complex_kernels[0]),
                             ("complex64 poisson1024x512",
                              complex_kernels[1]))},
        "checks": checks}]}
    RESULTS["kernels"] = kernels["kernels"]
    phase_done("16 kernels line")
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
