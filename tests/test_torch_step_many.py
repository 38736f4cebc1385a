"""
The port's blocked step (`InitialValueSolver.step_many`, core/
timesteppers.py `step_many`, core/stepgraph.py) against single steps and
against the JAX package's `step_many` (dedalus_tpu/core/solvers.py:929,
a lax.scan per block), on a 1-D problem with a nonlinear term and an
explicit time dependence, F = -u*u + sin(3t) f:

  * `step_many(n)` is bit-equal (torch.equal) to n calls of `step` for
    RK222, RK443, SBDF2 and SBDF3, over odd block lengths and a dt change
    between blocks (no re-projection, enforce_real_cadence = 0, so both
    runs take the same operations); the counts of steps and
    factorizations and sim_time (dt added n times) agree;
  * the port's `step_many` equals the JAX package's to 1e-12 relative,
    with the re-projection cadence (4) crossed inside blocks and a
    dictionary handler (iter = 3) evaluated at block ends only; the
    banded Rayleigh-Benard 8x32 and the SBDF2 KdV-Burgers 64 step in
    blocks like the JAX package too;
  * on the card (marker `cuda`), the replayed graph is bit-equal to the
    loop of `step`, a second block replays the same recording, a dt
    change records anew, and the launch count equals the loop's.

The JAX package is imported inside the tests that compare with it, so
that on a machine with a card and no jax this file is collected and its
port-only and card tests run,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_many.py
"""

import numpy as np
import pytest
import torch

import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.core import fusedstep

torch.set_num_threads(1)

RTOL = 1e-12
SCHEMES = ["RK222", "RK443", "SBDF2", "SBDF3"]
# blocks of (n, dt): odd lengths, and a dt change after the first block
BLOCKS = [(7, 1e-2), (5, 2e-2), (3, 2e-2)]


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def forced(d3, scheme, cadence, device="cpu", handler=False):
    """dt(u) - lap(u) = -u*u + sin(3t) f on RealFourier(16); with
    `handler`, a dictionary handler of u every 3 iterations."""
    coords = d3.CartesianCoordinates("x")
    kw = {"device": device} if d3 is td3 else {}
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    xb = d3.RealFourier(coords["x"], size=16, bounds=(0, 2 * np.pi))
    u = dist.Field(name="u", bases=xb)
    f = dist.Field(name="f", bases=xb)
    problem = d3.IVP([u], namespace={"u": u, "f": f, "lap": d3.lap,
                                     "np": np})
    problem.add_equation("dt(u) - lap(u) = - u*u + np.sin(3*t)*f")
    solver = problem.build_solver(scheme, enforce_real_cadence=cadence)
    x, = dist.local_grids(xb)
    u["g"] = np.sin(x) + 0.1 * np.cos(3 * x)
    f["g"] = np.cos(2 * x)
    if handler:
        solver.evaluator.add_dictionary_handler(iter=3).add_task(u, name="u")
    return solver


def jax_public():
    """The JAX package's public API (skips where jax is not installed)."""
    pytest.importorskip("jax")
    import dedalus_tpu.public as jd3
    return jd3


def state(solver):
    X = solver.X
    return X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_step_many_equals_single_steps(scheme):
    blocked = forced(td3, scheme, 0)
    single = forced(td3, scheme, 0)
    for n, dt in BLOCKS:
        blocked.step_many(n, dt)
        for _ in range(n):
            single.step(dt)
        assert torch.equal(blocked.X, single.X)
    assert blocked.iteration == single.iteration == 15
    assert blocked.sim_time == single.sim_time
    assert blocked.timestepper.factorizations == \
        single.timestepper.factorizations
    assert blocked.timestepper.recordings == 0   # no graph on the CPU


@pytest.mark.parametrize("scheme", SCHEMES)
def test_step_many_matches_jax(scheme):
    """Blocks crossing the re-projection cadence, a time-dependent
    forcing and a handler due at block ends: state, time, iteration and
    the handler's last output as the JAX package's."""
    jd3 = jax_public()
    js = forced(jd3, scheme, 4, handler=True)
    ts = forced(td3, scheme, 4, handler=True)
    for n, dt in BLOCKS:
        js.step_many(n, dt)
        ts.step_many(n, dt)
        assert rel_err(state(ts), state(js)) <= RTOL
    assert ts.iteration == js.iteration == 15
    # the port adds dt n times, the JAX package adds n * dt
    assert ts.sim_time == pytest.approx(js.sim_time, rel=0, abs=1e-15)
    jh, th = js.evaluator.handlers[0], ts.evaluator.handlers[0]
    assert rel_err(np.asarray(th["u"]), np.asarray(jh["u"])) <= RTOL


def test_banded_rb_blocks_match_jax():
    """RB 8x32, banded, RK222: two blocks (the first factors) as the JAX
    package's step_many."""
    jax_public()
    from dedalus_tpu.extras.bench_problems import build_rb_solver as jax_rb
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    js, _ = jax_rb(8, 32, np.float64, matsolver="banded")
    ts, _ = build_rb_solver(8, 32, np.float64, matsolver="banded",
                            device="cpu")
    for n in (5, 4):
        js.step_many(n, 0.01)
        ts.step_many(n, 0.01)
    assert ts.ops.kind == "banded"
    assert rel_err(state(ts), state(js)) <= RTOL
    assert ts.iteration == js.iteration == 9


def test_kdv_blocks_match_jax():
    """KdV-Burgers 64 (SBDF2, the progression's config 1 at a small
    size): the ramp runs as single steps, the rest as one block."""
    jax_public()
    from benchmarks.progression import build_kdv
    from dedalus_tpu_torch.extras.bench_problems import build_kdv_solver
    js, dt = build_kdv(64, np.float64)
    ts, tdt = build_kdv_solver(64, device="cpu")
    assert dt == tdt
    js.step_many(9, dt)
    ts.step_many(9, dt)
    assert rel_err(state(ts), state(js)) <= RTOL
    assert ts.timestepper.factorizations == 2


# ------------------------------------------------------------- the card

def card_pair(build):
    """Two solvers of one problem on the card: the blocked one and the
    loop of step."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return build(), build()


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
def test_replayed_graph_equals_steps_on_card(scheme):
    """The recorded step replayed is bit-equal to the loop of step (dense
    path); the second block at the same dt replays the same recording and
    the dt change records once more."""
    blocked, single = card_pair(lambda: forced(td3, scheme, 0, "cuda"))
    for i, (n, dt) in enumerate(BLOCKS):
        blocked.step_many(n, dt)
        graph = blocked.timestepper._graph
        for _ in range(n):
            single.step(dt)
        assert torch.equal(blocked.X, single.X)
        assert blocked.sim_time == single.sim_time
        if i == 2:
            assert graph is kept
        kept = graph
    assert blocked.timestepper.recordings == 2


@pytest.mark.cuda
def test_banded_replay_counts_launches_on_card():
    """RB 8x32 banded on the card: the replays are bit-equal to the loop
    of step and add their recorded kernel launches to the count, which
    equals the loop's (1 factorization + 4 substitutions a step)."""
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    blocked, single = card_pair(lambda: build_rb_solver(
        8, 32, np.float64, matsolver="banded", device="cuda")[0])
    counts = []
    for solver, run in ((blocked, lambda: blocked.step_many(9, 0.01)),
                        (single, lambda: [single.step(0.01)
                                          for _ in range(9)])):
        before = fusedstep.LAUNCHES["banded_subst"]
        run()
        torch.cuda.synchronize()
        counts.append(fusedstep.LAUNCHES["banded_subst"] - before)
    assert torch.equal(blocked.X, single.X)
    assert counts[0] == counts[1] == 1 + 9 * 4
    assert blocked.timestepper.recordings == 1
    assert blocked.timestepper._graph.launches["banded_subst"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["SBDF2", "SBDF3"])
def test_single_steps_between_replays_on_card(scheme):
    """Single steps between two blocks at one dt rebind the multistep
    histories; the second block copies them into the recording's buffers
    and replays that recording, bit-equal to the loop of step."""
    blocked, single = card_pair(lambda: forced(td3, scheme, 0, "cuda"))
    blocked.step_many(7, 1e-2)
    for _ in range(2):
        blocked.step(1e-2)
    blocked.step_many(5, 1e-2)
    for _ in range(14):
        single.step(1e-2)
    assert torch.equal(blocked.X, single.X)
    assert blocked.timestepper.recordings == 1
