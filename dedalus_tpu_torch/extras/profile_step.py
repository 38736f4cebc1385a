"""
Device time and idle share of an IVP step on one NVIDIA GPU.

    python -m dedalus_tpu_torch.extras.profile_step             # RB 256x64
    python -m dedalus_tpu_torch.extras.profile_step rb 2048 1024
    python -m dedalus_tpu_torch.extras.profile_step kdv 1024
    python -m dedalus_tpu_torch.extras.profile_step shear 512

Builds the problem's solver on `cuda` (RB on the banded path, KdV and
shear with the configured matsolver), takes 3 warm steps, then traces
`--steps` steps with torch.profiler (CPU + CUDA activities). Prints one
JSON object: the host wall time per step under the profiler (closed by a
synchronize; the profiler slows the host side), the device time per step
(sum of the kernels' device time; one stream, so kernels do not overlap),
the idle share 1 - device/wall, the kernel launches per step, and the ten
kernels with the most device time. Raises when no CUDA device is present
or the trace holds no device time.
"""

import argparse
import json
import time

import numpy as np
import torch

from .bench_problems import build_kdv_solver, build_rb_solver, build_shear_solver


def build(problem, sizes=()):
    """(solver, dt) of `problem` at `sizes` on the card."""
    if problem == "rb":
        Nx, Nz = sizes or (256, 64)
        solver, _ = build_rb_solver(Nx, Nz, np.float64, matsolver="banded",
                                    device="cuda")
        return solver, 1e-3
    if problem == "kdv":
        return build_kdv_solver(*(sizes or (1024,)), device="cuda")
    if problem == "shear":
        return build_shear_solver(*(sizes or (512,)), device="cuda")
    raise ValueError(f"Unknown problem {problem!r}: rb, kdv or shear")


def profile_solver(solver, dt, steps, warm=3):
    """Trace `steps` steps of a built solver on the card after `warm`
    untraced ones."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    for _ in range(warm):
        solver.step(dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            solver.step(dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries only: the CPU-side op entries carry the same
    # kernels' time as self device time and would count it twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        raise RuntimeError("the trace holds no device time")
    by_name = {}
    for e in kernels:   # kernel names truncated to 80 characters
        name = e.key[:80]
        by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    wall_ms = wall / steps * 1e3
    device_ms = device_us / steps / 1e3
    return {
        "pencil_shape": list(solver.pencil_shape), "steps": steps,
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels_ms_per_step": {
            name: us / steps / 1e3 for name, us in top},
    }


def profile_steps(problem, sizes, steps):
    """Build `problem` at `sizes` on the card and trace `steps` steps."""
    solver, dt = build(problem, tuple(sizes))
    out = {"problem": problem, "sizes": list(sizes)}
    out.update(profile_solver(solver, dt, steps))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("problem", nargs="?", default="rb",
                        choices=("rb", "kdv", "shear"))
    parser.add_argument("sizes", type=int, nargs="*")
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    print(json.dumps(profile_steps(args.problem, args.sizes, args.steps)))


if __name__ == "__main__":
    main()
