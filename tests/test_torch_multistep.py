"""
Multistep IMEX timestepping of the port (dedalus_tpu_torch/core/
timesteppers.py MultistepIMEX and its 8 schemes) held against the JAX
package: every scheme on the 1-D forced nonlinear heat IVP
(build_diffusion_solver(64), dense path) for 20 steps with the timestep
changed once at step 10, the 2-D tau IVP 16x32 under SBDF2 on the banded
path (the substitution's plain version here), each to 1e-12 relative;
and the factorization keys (the order ramp and the dt change) step for
step.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.extras.bench_problems import (
    build_diffusion_solver as jax_diffusion, build_tau_ivp as jax_tau)
from dedalus_tpu_torch.extras.bench_problems import (
    build_diffusion_solver as torch_diffusion, build_tau_ivp as torch_tau)

torch.set_num_threads(1)

RTOL = 1e-12
SCHEMES = ["CNAB1", "SBDF1", "SBDF2", "SBDF3", "SBDF4", "CNAB2", "MCNAB2",
           "CNLF2"]
DTS = [1e-3] * 10 + [1.5e-3] * 10


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def count_jax_factorizations(js):
    """Count the JAX timestepper's factorizations (it keeps no count)."""
    calls = []
    factor = js.timestepper._factor

    def counted(*args):
        calls.append(js.timestepper._lhs_key)
        return factor(*args)

    js.timestepper._factor = counted
    return calls


def diffusion_pair(scheme):
    js = jax_diffusion(64)
    ts = torch_diffusion(64, device="cpu")
    js.timestepper = jd3.schemes[scheme](js)
    ts.timestepper = td3.schemes[scheme](ts)
    return js, ts


def test_every_scheme_is_public():
    assert set(SCHEMES) <= set(td3.schemes)
    for name in SCHEMES:
        assert getattr(td3, name) is td3.schemes[name]
        assert issubclass(td3.schemes[name], td3.MultistepIMEX)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_matches_jax_with_a_dt_change(scheme):
    js, ts = diffusion_pair(scheme)
    assert ts.ops.kind == js.ops.kind == "dense"
    jkeys = count_jax_factorizations(js)
    tkeys = []
    for dt in DTS:
        js.step(dt)
        ts.step(dt)
        tkeys.append(ts.timestepper._lhs_key)
        assert ts.timestepper._lhs_key == js.timestepper._lhs_key
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL
    assert ts.sim_time == pytest.approx(js.sim_time, rel=1e-15)
    # one factorization per distinct key run, in the JAX package's order
    assert ts.timestepper.factorizations == len(jkeys)
    distinct = [k for i, k in enumerate(tkeys) if i == 0 or k != tkeys[i - 1]]
    assert distinct == jkeys


@pytest.mark.parametrize("scheme,expected", [("SBDF2", 2), ("SBDF4", 4),
                                             ("CNAB2", 1), ("SBDF1", 1)])
def test_constant_dt_factorizations(scheme, expected):
    """At constant dt SBDFk refactors once per order of its ramp (a0
    changes with the order); the CN family keeps one factorization."""
    _, ts = diffusion_pair(scheme)
    for _ in range(6):
        ts.step(1e-3)
    assert ts.timestepper.factorizations == expected


def test_tau_ivp_sbdf2_banded_matches_jax():
    """The 2-D tau IVP 16x32 under SBDF2 on the banded path: the pinned
    Woodbury solve and the refinement sweeps under multistep
    coefficients."""
    js, *_ = jax_tau(16, 32, matsolver="banded", timestepper=jd3.SBDF2)
    ts, *_ = torch_tau(16, 32, matsolver="banded", timestepper=td3.SBDF2,
                       device="cpu")
    assert ts.ops.kind == js.ops.kind == "banded"
    for _ in range(8):
        js.step(0.01)
        ts.step(0.01)
    assert ts.timestepper.factorizations == 2
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL


def test_histories_do_not_alias():
    """The three histories are distinct tensors, newest first."""
    _, ts = diffusion_pair("SBDF3")
    for _ in range(4):
        ts.step(1e-3)
    tsr = ts.timestepper
    ptrs = [t.data_ptr() for hist in (tsr.F_hist, tsr.MX_hist, tsr.LX_hist)
            for t in hist]
    assert len(ptrs) == 9 and len(set(ptrs)) == 9
