"""
Device time and idle share of the RB IVP step on one NVIDIA GPU.

    python -m dedalus_tpu_torch.extras.profile_step            # RB 256x64
    python -m dedalus_tpu_torch.extras.profile_step 2048 1024

Builds the Rayleigh-Benard solver on `cuda`, takes 3 warm steps, then
traces `--steps` steps with torch.profiler (CPU + CUDA activities). Prints
one JSON object: the host wall time per step under the profiler (closed
by a synchronize; the profiler slows the host side), the device time per
step (sum of the kernels' device time; one stream, so kernels do not
overlap), the idle share 1 - device/wall, the kernel launches per step,
and the ten kernels with the most device time. Raises when no CUDA device
is present or the trace holds no device time.
"""

import argparse
import json
import time

import numpy as np
import torch

from .bench_problems import build_rb_solver


def profile_steps(Nx, Nz, steps, dt=1e-3):
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    solver, _ = build_rb_solver(Nx, Nz, np.float64, matsolver="banded",
                                device="cuda")
    for _ in range(3):
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
        "size": f"{Nx}x{Nz}", "steps": steps,
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels_ms_per_step": {
            name: us / steps / 1e3 for name, us in top},
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("Nx", type=int, nargs="?", default=256)
    parser.add_argument("Nz", type=int, nargs="?", default=64)
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    print(json.dumps(profile_steps(args.Nx, args.Nz, args.steps)))


if __name__ == "__main__":
    main()
