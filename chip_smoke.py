#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (dedalus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # RB 256x64 main path + RB 2048x1024
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
     time breakdown of one stage.
  4. Real size: RB 2048x1024 (the target of BASELINE.json): build,
     factor, 10 steps, steps/s, peak device memory, the same checks.
  5. The kernels line, the card line, and the result line.

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
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
# kernel vs plain: relative to max|plain| (summation order differs; f32
# against f64 on the RB 256x64 factor operators differs by ~5e-7)
BOUND = {"float64": 1e-12, "float32": 1e-5}
# bytes written between cold launches: more than the H100's 50 MB L2
FLUSH_BYTES = 64 * 2 ** 20
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
    once, the output written once; 2 flops per operator word per column."""
    G, q = fsub["lastOp"].shape[:2]
    item = fp.element_size()
    k = 1 if fp.ndim == 2 else fp.shape[1]
    words = fsub["FwdOp"].numel() + fsub["BwdOp"].numel() \
        + fsub["lastOp"].numel()
    nbytes = (words + 2 * fp.numel()) * item
    return nbytes, 2 * words * k


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
    # operator bytes (timed here only; the port never calls it)
    flat = torch.cat([fsub[k].reshape(-1)
                      for k in ("FwdOp", "BwdOp", "lastOp")])
    stream_ms = median_ms(lambda: torch.sum(flat))
    del flat
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
    equation of an RB solver on the card."""
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
    _, ez = u.tensorsig[0].unit_vector_fields(u.dist)
    lift_basis = u.domain.bases[1].derivative_basis(1)
    grad_u = d3.grad(u) + ez * d3.Lift(tau_u1, lift_basis, -1)
    resid = (d3.trace(grad_u) + tau_p).evaluate()["c"]
    errs["trace(grad_u)+tau_p (rel)"] = float(
        np.max(np.abs(resid)) / np.max(np.abs(u["c"])))
    log(f"{label} checks " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 1e-10}
    if bad:
        fail(f"{label}: checks out of bound 1e-10: {bad}")
    return errs


def breakdown(label, solver, dt, reps):
    """Per-layer device times (median ms, CUDA events) of the pieces one
    step is made of, on the solver's current state: one stage's RHS
    evaluation and L matvec, one solve with its refinement sweep, one
    substitution kernel launch, the state scatter/gather, a dealiased
    transform roundtrip of the state, one factorization, and one step."""
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
        "factor": median_ms(lambda: ops.factor_lincomb(
            1.0, M, dt * solver.timestepper.uniq_H_diag[0], L),
            reps=3, warm=1),
        "step": median_ms(lambda: solver.step(dt), reps=reps, warm=1),
    }
    log(f"breakdown {label} ms " + json.dumps(out))
    return out


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

    # ---------------------------------------------------------- phase 2
    Gr, NBr, qr = 1024, 257, 32       # RB 2048x1024: G = Nx/2, NB, q
    for dtype, seed, k in ((torch.float64, 1, 1), (torch.float32, 2, 1),
                           (torch.float64, 4, 16)):
        fsub, fp = random_fsub(Gr, NBr, qr, dtype, seed, k)
        check_kernel("rb2048x1024-random" + ("-woodbury" if k > 1 else ""),
                     fsub, fp)
        del fsub, fp
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 3
    # a small input against the port's CPU path (held against the JAX
    # package by tests/test_torch_rb.py)
    small = []
    for device in ("cuda", "cpu"):
        s, _ = build_rb_solver(8, 32, np.float64, matsolver="banded",
                               device=device)
        for _ in range(10):
            s.step(0.01)
        small.append(s.X.cpu().numpy())
    small_err = float(np.max(np.abs(small[0] - small[1]))
                      / np.max(np.abs(small[1])))
    RESULTS["rb8x32_cuda_vs_cpu_rel"] = small_err
    log(f"rb8x32 cuda vs cpu, 10 steps: max relative difference {small_err:.3e}")
    if not small_err <= 1e-12:
        fail(f"rb8x32 on the card disagrees with the CPU run: {small_err:.3e}")

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
    torch.cuda.empty_cache()

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

    # ---------------------------------------------------------- phase 5
    # times and bound at the main path's own shapes (f64); the errors are
    # the worst over every kernel-vs-plain check (f32 ones included), each
    # also listed with its relative bound, times and byte bound
    checks = [{k: rec[k] for k in ("shape", "dtype", "k", "max_abs_err",
                                   "max_rel_err", "bound_rel", "ms",
                                   "cold_ms", "stream_ms", "plain_ms",
                                   "bound_ms", "share_of_bound")}
              for rec in RESULTS["kernel_checks"]]
    kernels = {"kernels": [{
        "name": "banded_subst", "route": "cuda",
        "source": "dedalus_tpu_torch/csrc/banded_subst.cu",
        "replaces": "dedalus_tpu/core/fusedstep.py:520",
        "launches": launches["banded_subst"],
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "max_rel_err": max(c["max_rel_err"] for c in checks),
        "launches_real_size": real["launches"],
        "ms": main_rec["ms"], "cold_ms": main_rec["cold_ms"],
        "stream_ms": main_rec["stream_ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None, "checks": checks}]}
    RESULTS["kernels"] = kernels["kernels"]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
