"""
Host build times of the geometry cells of one checkout of this
repository, for comparing two commits on one card. Unpack each commit
(`git archive`) into its own directory and run this once per checkout,
alternating them in one session (parent, change, change, parent), so the
host's load between sessions does not enter:

    python dedalus_tpu_torch/extras/build_ab.py --tree <checkout> \\
        --label parent-1 --out chiprun_out/build_ab.jsonl

It imports `dedalus_tpu_torch` from <checkout> and times each builder of
`extras/bench_problems.py` as `chip_smoke.py` calls it, on the card, from
the call to the end of its uploads (the wall clock, after a
synchronize): annulus_convection256x64 (polar, dense),
shell_convection96x48x6 (shell, dense), rotconv64x32x32 (shell, banded
at q = 392), ball_convection64x32x48 (ball, banded at q = 32) and, as a
control that runs no curvilinear code, RB 2048x1024 (banded). Each cell
records its seconds and the solver's `build_seconds` phases; `--cells`
builds only the cells it names, in its order, in one process.

With `--solves`, the cells are the boundary value problems of
`chip_smoke.py` phases 7, 9 and 13 instead (poisson2048x1024 and
complex_poisson1024x512, banded; bratu256, the NLBVP), and each records
after its build: the median of 5 re-factors of L (the wall clock to a
synchronize), the median device time of 25 warm solves (CUDA events),
and for Bratu the seconds of each Newton iteration from u = 0 (its
Jacobian's assembly, factor and solve).

Appends one JSON line to --out: the label, the checkout, the card's name
and power limit as nvidia-smi prints them, and each cell's record.
"""

import argparse
import gc
import json
import pathlib
import subprocess
import sys
import time


def cells(bp, np):
    """{name: builder returning the solver first} at chip_smoke.py's sizes."""
    return {
        "annulus_convection256x64":
            lambda: bp.build_annulus_convection(256, 64, device="cuda"),
        "shell_convection96x48x6":
            lambda: bp.build_shell_convection(96, 48, 6, device="cuda"),
        "rotconv64x32x32":
            lambda: bp.build_rotconv(64, 32, 32, device="cuda"),
        "ball_convection64x32x48":
            lambda: bp.build_ball_convection(64, 32, 48, device="cuda"),
        "rb2048x1024":
            lambda: bp.build_rb_solver(2048, 1024, np.float64,
                                       device="cuda"),
    }


def solve_cells(bp):
    """{name: builder returning the solver first} of `--solves`."""
    return {
        "poisson2048x1024":
            lambda: bp.build_poisson_solver(2048, 1024, device="cuda"),
        "complex_poisson1024x512":
            lambda: bp.build_poisson_solver(1024, 512, device="cuda",
                                            dtype="complex128"),
        "bratu256": lambda: bp.build_bratu_solver(256, device="cuda"),
    }


def solve_record(solver, torch, factors=5, solves=25):
    """The median re-factor seconds and warm solve ms of a built LBVP,
    or the seconds of each Newton iteration of an NLBVP."""
    import statistics
    if hasattr(solver, "newton_iteration"):
        its = []
        while solver.iteration < 30:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.newton_iteration()
            norm = solver.perturbation_norm()
            its.append(time.perf_counter() - t0)
            if norm <= 1e-10:
                break
        return {"newton_iteration_s": its}
    seconds = []
    for _ in range(factors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.ops.factor(solver.L_mat)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    solver.solve()
    ms = []
    for _ in range(solves):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        solver.solve()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return {"factor_s": statistics.median(seconds),
            "solve_ms": statistics.median(ms)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--tree", required=True,
                        help="root of the checkout to measure")
    parser.add_argument("--label", required=True)
    parser.add_argument("--out", default="chiprun_out/build_ab.jsonl")
    parser.add_argument("--cells", nargs="+", default=None,
                        help="the cells to build, in this order "
                        "(default: all)")
    parser.add_argument("--solves", action="store_true",
                        help="time the boundary value problems' factors "
                        "and solves instead of the geometry builds")
    args = parser.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("build_ab: no CUDA device available", file=sys.stderr)
        return 1
    import dedalus_tpu_torch
    from dedalus_tpu_torch.extras import bench_problems
    package = pathlib.Path(dedalus_tpu_torch.__file__).resolve()
    if tree not in package.parents:
        print(f"build_ab: imported {package}, not the package of {tree}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    record = {"label": args.label, "tree": str(tree), "card": card}
    builders = (solve_cells(bench_problems) if args.solves
                else cells(bench_problems, np))
    for name in args.cells or list(builders):
        build = builders[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = build()[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        record[name] = {"build_s": seconds,
                        "build_phases_s": dict(solver.build_seconds),
                        "ops": solver.ops.kind,
                        "pencil_shape": list(solver.pencil_shape)}
        if args.solves:
            record[name].update(solve_record(solver, torch))
        print(f"{args.label} {name}: {json.dumps(record[name])}", flush=True)
        del solver
        gc.collect()
        torch.cuda.empty_cache()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        f.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
