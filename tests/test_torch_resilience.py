"""
The port's resilient loop (dedalus_tpu_torch/tools/resilience.py), its
sharded checkpoints (tools/dcheckpoint.py) and the solver half of the
chaos harness (tools/chaos.py) held against the JAX package on the CPU:
the cases of tests/test_resilience.py and tests/test_dcheckpoint.py that
mean something on one device.

Each scenario runs in both packages from the same initial data with the
same fault schedule; the loops' summaries agree (rewinds, retries,
snapshots, the dt cap, the stop cause, SDC checks and detections,
checkpoints written, the lineage's outcomes and rewind points) and the
states agree within 1e-12 of max|X|. Checkpoints cross between the
packages: a checkpoint written by either resumes in the other (HDF5 and
dedalus-sharded-v1), restoring the writer's state bit for bit. The
snapshot and the async checkpoint of the port hold copies: a later step
or step_many block writing the state in place leaves them as they were.
One intra-op thread.
"""

import errno
import pathlib
import signal

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.tools import chaos as jchaos
from dedalus_tpu.tools import dcheckpoint as jdc
from dedalus_tpu.tools import resilience as jres
from dedalus_tpu_torch.tools import chaos as tchaos
from dedalus_tpu_torch.tools import dcheckpoint as tdc
from dedalus_tpu_torch.tools import resilience as tres
from dedalus_tpu_torch.tools.exceptions import (CheckpointError,
                                                SilentCorruptionError,
                                                SolverHealthError)

torch.set_num_threads(1)

CHAOS = {jd3: jchaos, td3: tchaos}
RES = {jd3: jres, td3: tres}


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def tag(d3):
    return "torch" if d3 is td3 else "jax"


def state_of(solver):
    X = solver.X
    return X.numpy() if isinstance(X, torch.Tensor) else np.asarray(X)


def diffusion(d3, tmp_path, scheme="RK222", **solver_kw):
    """tests/test_resilience.py:30: 1-D heat on RealFourier(32)."""
    xc = d3.Coordinate("x")
    dist = d3.Distributor(xc, dtype=np.float64, **dist_kw(d3))
    xb = d3.RealFourier(xc, size=32, bounds=(0, 2 * np.pi))
    u = dist.Field(name="u", bases=xb)
    problem = d3.IVP([u], namespace={"u": u, "lap": d3.lap})
    problem.add_equation("dt(u) - lap(u) = 0")
    kw = dict(health_cadence=1, warmup_iterations=2,
              enforce_real_cadence=0,
              postmortem_dir=str(tmp_path / "pm"))
    kw.update(solver_kw)
    solver = problem.build_solver(getattr(d3, scheme), **kw)
    x = dist.local_grid(xb)
    u["g"] = np.sin(3 * np.asarray(x))
    return solver, u


def blowup(d3, tmp_path, **solver_kw):
    """tests/test_resilience.py:50: dt(s) = s*s from s0 = 2, divergent at
    any dt."""
    xc = d3.Coordinate("x")
    dist = d3.Distributor(xc, dtype=np.float64, **dist_kw(d3))
    xb = d3.RealFourier(xc, size=16, bounds=(0, 2 * np.pi))
    s = dist.Field(name="s", bases=xb)
    problem = d3.IVP([s], namespace={})
    problem.add_equation((d3.dt(s), s * s))
    kw = dict(health_cadence=1, warmup_iterations=2,
              postmortem_dir=str(tmp_path / "pm"))
    kw.update(solver_kw)
    solver = problem.build_solver(d3.SBDF1, **kw)
    s["g"] = 2.0
    return solver, s


def core(summary):
    """The comparable part of a loop summary."""
    out = {k: summary.get(k) for k in ("rewinds", "retries", "snapshots",
                                       "dt_limit", "stopped_by",
                                       "sdc_checks", "sdc_detected")}
    if "checkpoint" in summary:
        out["written"] = summary["checkpoint"].get("written")
    out["lineage"] = [{k: e.get(k) for k in ("failure_iteration", "attempt",
                                             "outcome", "rewind_iteration",
                                             "dt_limit")}
                      for e in summary.get("lineage", [])]
    return out


def close(a, b, rtol=1e-12):
    return np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300)


def n_checkpoints(directory):
    directory = pathlib.Path(directory)
    return len(list(directory.glob("*.h5"))) + len(
        tdc.list_checkpoints(directory))


# ------------------------------------------------ scenarios in both packages

SCENARIOS = {
    # tests/test_resilience.py:68: NaN at 12 -> rewind, dt backoff
    "nan_rewind": dict(stop=30, loop=dict(
        dt=1e-3, snapshot_cadence=5, max_retries=3, dt_backoff=0.5,
        retry_base_delay=0.0), chaos=dict(nan_field="u", nan_iteration=12)),
    # the multistep histories ride the snapshot
    "nan_rewind_sbdf2": dict(scheme="SBDF2", stop=24, loop=dict(
        dt=1e-3, snapshot_cadence=4, retry_base_delay=0.0),
        chaos=dict(nan_field="u", nan_iteration=10)),
    # :243: preemption on the divergent step rewinds first
    "sigterm_during_divergence": dict(stop=30, ckpt="hdf5", loop=dict(
        dt=1e-3, snapshot_cadence=3, retry_base_delay=0.0),
        chaos=dict(nan_field="u", nan_iteration=8, sigterm_iteration=8)),
    # :322: a transient IO fault on the first checkpoint write
    "io_retry": dict(stop=6, ckpt="hdf5", loop=dict(dt=1e-3),
                     chaos=dict(fail_checkpoint_write=1)),
    # :457: clean sentinel re-executions are invisible
    "sdc_clean": dict(stop=30, loop=dict(dt=1e-3, sdc_cadence=5)),
    # :472: a flipped bit in a checked window, recovered bit-exactly
    "sdc_flip": dict(stop=30, loop=dict(
        dt=1e-3, sdc_cadence=5, snapshot_cadence=50, retry_base_delay=0.0),
        chaos=dict(seed=3, flip_bit_iteration=15)),
    # :525: a flip in an unchecked window is absorbed
    "sdc_unchecked": dict(stop=30, loop=dict(dt=1e-3, sdc_cadence=5),
                          chaos=dict(seed=3, flip_bit_iteration=12)),
    # :408: async periodic sharded checkpoints
    "async_periodic": dict(stop=18, ckpt="sharded", loop=dict(
        dt=1e-3, checkpoint_async=True, checkpoint_iter=5)),
    # a torn sharded write mid-run: the loop goes on, the next lands
    "torn_shard": dict(scheme="SBDF2", stop=12, ckpt="sharded", loop=dict(
        dt=1e-3, checkpoint_iter=4),
        chaos=dict(torn_shard_write=2, torn_after_shards=2)),
}


def run_scenario(d3, tmp_path, spec):
    root = tmp_path / tag(d3)
    solver, _ = diffusion(d3, root, scheme=spec.get("scheme", "RK222"))
    solver.stop_iteration = spec["stop"]
    loop = dict(spec["loop"])
    if "ckpt" in spec:
        loop.update(checkpoint_dir=root / "ckpt",
                    checkpoint_format=spec["ckpt"])
    injector = None
    if "chaos" in spec:
        injector = CHAOS[d3].ChaosInjector(**spec["chaos"])
        loop["chaos"] = injector
    summary = solver.evolve_resilient(**loop)
    fired = [f["kind"] for f in injector.fired] if injector else []
    return solver, summary, fired, root


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(tmp_path, name):
    spec = SCENARIOS[name]
    runs = {d3: run_scenario(d3, tmp_path, spec) for d3 in (jd3, td3)}
    (ts, tsum, tfired, troot), (js, jsum, jfired, jroot) = \
        runs[td3], runs[jd3]
    assert core(tsum) == core(jsum)
    assert tfired == jfired
    assert ts.iteration == js.iteration and ts.sim_time == js.sim_time
    assert close(state_of(ts), state_of(js))
    assert np.isfinite(state_of(ts)).all()
    if "ckpt" in spec:
        assert n_checkpoints(troot / "ckpt") == n_checkpoints(jroot / "ckpt")
    # the counters of the port's record
    rec = ts.flush_metrics()
    assert rec["resilience"]["rewinds"] == tsum["rewinds"]
    if tsum["rewinds"]:
        assert rec["counters"]["resilience/rewinds"] == tsum["rewinds"]
    if name == "nan_rewind":
        assert tsum["lineage"][0]["dt_limit"] == pytest.approx(5e-4)
        assert rec["counters"]["resilience/dt_backoffs"] == 1
        from dedalus_tpu_torch.tools.health import (read_postmortem,
                                                    format_postmortem)
        pm = sorted((troot / "pm").iterdir())[-1]
        record, _ = read_postmortem(pm)
        assert "resilience" in record
        assert "rewind" in "\n".join(format_postmortem(record))
    if name == "sdc_flip":
        assert tsum["sdc_detected"] == 1 and tsum["dt_limit"] is None
        ref, _ = diffusion(td3, tmp_path / "ref", metrics=False)
        for _ in range(30):
            ref.step(1e-3)
        assert torch.equal(ts.X, ref.X)
    if name == "sigterm_during_divergence":
        assert tsum["stopped_by"] == "SIGTERM" and tsum["rewinds"] == 1
        resumed, _ = diffusion(td3, tmp_path / "resumed")
        event = tres.resume_latest(resumed, troot / "ckpt")
        assert event["iteration"] <= 8
        assert np.isfinite(state_of(resumed)).all()
    if name == "io_retry":
        assert rec["counters"]["resilience/io_retries"] >= 1
        n_valid, reason = tres.validate_checkpoint(
            sorted((troot / "ckpt").glob("*.h5"))[-1])
        assert (n_valid, reason) == (1, None)
    if name == "async_periodic":
        ck = tsum["checkpoint"]
        assert ck["async"] is True and ck["errors"] == 0
        assert ck["written"] >= 3 and ck["bytes_written"] > 0


def test_rb_nan_divergence_recovers_like_jax(tmp_path):
    """tests/test_resilience.py:103 at RB 64x16 banded, f64: the same
    rewinds, lineage and final state (1e-12) in both packages."""
    from dedalus_tpu.extras.bench_problems import build_rb_solver as jrb
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    out = {}
    for d3, build in ((jd3, jrb), (td3, build_rb_solver)):
        solver, b = build(64, 16, np.float64, matsolver="banded",
                          **dist_kw(d3))
        solver.warmup_iterations = 2
        solver.health.cadence = 1
        solver.health.postmortem_dir = str(tmp_path / tag(d3))
        solver.stop_iteration = 20
        injector = CHAOS[d3].ChaosInjector(nan_field="b", nan_iteration=8)
        summary = solver.evolve_resilient(
            dt=1e-3, snapshot_cadence=4, max_retries=3,
            retry_base_delay=0.0, chaos=injector)
        out[d3] = (solver, summary)
    (ts, tsum), (js, jsum) = out[td3], out[jd3]
    assert core(tsum) == core(jsum) and tsum["rewinds"] == 1
    assert ts.iteration == 20
    assert close(state_of(ts), state_of(js))


@pytest.mark.parametrize("case", ["budget", "ring"])
def test_escalation_matches_jax(tmp_path, case):
    """tests/test_resilience.py:159 and :174: a run that diverges at any
    dt escalates with the structured error once the retry budget or the
    ring is spent, in both packages alike."""
    lineages = {}
    for d3 in (jd3, td3):
        solver, s = blowup(d3, tmp_path / tag(d3))
        solver.health.max_abs_limit = 1e6
        solver.stop_iteration = 500
        import dedalus_tpu.tools.exceptions as jexc
        with pytest.raises((SolverHealthError, jexc.SolverHealthError)):
            solver.evolve_resilient(dt=1.0, snapshot_cadence=1000,
                                    max_retries=0 if case == "budget" else 5,
                                    retry_base_delay=0.0)
        lineages[d3] = core(solver.resilience.summary())
    assert lineages[td3] == lineages[jd3]
    outcome = lineages[td3]["lineage"][-1]["outcome"]
    assert outcome == ("escalated: retry budget exhausted" if case == "budget"
                       else "escalated: no finite snapshot")


def test_sdc_mismatch_escalates_structured(tmp_path):
    """tests/test_resilience.py:508."""
    solver, u = diffusion(td3, tmp_path)
    solver.stop_iteration = 30
    injector = tchaos.ChaosInjector(seed=3, flip_bit_iteration=15)
    with pytest.raises(SilentCorruptionError) as excinfo:
        solver.evolve_resilient(dt=1e-3, sdc_cadence=5, max_retries=0,
                                retry_base_delay=0.0, chaos=injector)
    err = excinfo.value
    assert err.mismatched >= 1 and err.anchor_iteration == 14
    assert isinstance(err, SolverHealthError) and err.postmortem_dir


def test_flip_bit_picks_the_jax_element_and_bit(tmp_path):
    """One seed flips the same element and mantissa bit in both packages,
    and the flipped state differs from the JAX package's flipped state by
    the states' own difference only."""
    flips = {}
    for d3 in (jd3, td3):
        solver, _ = diffusion(d3, tmp_path / tag(d3))
        for _ in range(3):
            solver.step(1e-3)
        before = state_of(solver).copy()
        index, bit = CHAOS[d3].ChaosInjector(seed=7).flip_bit(solver)
        after = state_of(solver)
        flips[d3] = (index, bit, before, after)
        diff = np.argwhere(before != after)
        assert [tuple(d) for d in diff] == [tuple(index)]
        assert np.isfinite(after).all()
    assert flips[td3][:2] == flips[jd3][:2]
    assert close(flips[td3][3], flips[jd3][3])


# --------------------------------------------- checkpoints across packages

@pytest.mark.parametrize("writer", [jd3, td3], ids=["jax_writes",
                                                    "torch_writes"])
@pytest.mark.parametrize("scheme,fmt", [("RK222", "hdf5"),
                                        ("RK222", "sharded"),
                                        ("SBDF2", "sharded")])
def test_sigterm_checkpoint_resumes_across_packages(tmp_path, writer, fmt,
                                                    scheme):
    """tests/test_resilience.py:203, :344 and :385 across packages: a
    SIGTERM at iteration 9 writes a final checkpoint; a fresh solver of
    either package resumes from it (the format found in the directory)
    with the writer's clocks and state bit for bit (the multistep
    histories too, in the sharded format), and finishes 20 steps within
    1e-12 of an uninterrupted run of the reader (bit-equal when reader
    and writer are one package). An HDF5 checkpoint holds no multistep
    history, so SBDF2 resumes from the sharded format only, as in
    tests/test_resilience.py."""
    ckpt = tmp_path / "ckpt"
    w, _ = diffusion(writer, tmp_path / "w", scheme=scheme, metrics=False)
    w.stop_iteration = 20
    injector = CHAOS[writer].ChaosInjector(sigterm_iteration=9)
    summary = w.evolve_resilient(dt=1e-3, checkpoint_dir=ckpt,
                                 checkpoint_format=fmt, chaos=injector)
    assert summary["stopped_by"] == "SIGTERM" and w.iteration == 9
    assert signal.getsignal(signal.SIGTERM) is not None
    X_w = state_of(w).copy()
    for reader in (jd3, td3):
        ref, _ = diffusion(reader, tmp_path / "ref", scheme=scheme,
                           metrics=False)
        for _ in range(20):
            ref.step(1e-3)
        r, _ = diffusion(reader, tmp_path / "r", scheme=scheme,
                         metrics=False)
        r.stop_iteration = 20
        loop = RES[reader].ResilientLoop(
            r, dt=1e-3, checkpoint_dir=ckpt, checkpoint_format=fmt,
            resume=True, install_signal_handlers=False)
        loop._resume_any()
        assert loop.resume_event["iteration"] == 9
        assert r.sim_time == w.sim_time
        assert np.array_equal(state_of(r), X_w)
        if fmt == "sharded" and scheme == "SBDF2":
            hist = r.timestepper.F_hist
            hist = torch.stack(hist).numpy() if isinstance(hist, list) \
                else np.asarray(hist)
            whist = w.timestepper.F_hist
            whist = torch.stack(whist).numpy() if isinstance(whist, list) \
                else np.asarray(whist)
            assert np.array_equal(hist, whist)
        while r.proceed:
            r.step(1e-3)
        assert r.iteration == 20
        if reader is writer:
            assert np.array_equal(state_of(r), state_of(ref))
        else:
            assert close(state_of(r), state_of(ref))


@pytest.mark.parametrize("writer", [jdc, tdc], ids=["jax_writes",
                                                    "torch_writes"])
def test_sharded_format_crosses_bit_equal(tmp_path, writer):
    """tests/test_dcheckpoint.py:60: a dedalus-sharded-v1 checkpoint of
    either package loads in the other bit for bit, with its meta; both
    write the same manifest entries for the same arrays."""
    rng = np.random.default_rng(11)
    arrays = {"X": rng.standard_normal((16, 24)),
              "Z": (rng.standard_normal((3, 5))
                    + 1j * rng.standard_normal((3, 5))).astype(np.complex64)}
    src = {k: torch.as_tensor(v) for k, v in arrays.items()} \
        if writer is tdc else arrays
    path = writer.write_checkpoint(tmp_path, src, {"iteration": 7, "k": "v"})
    for reader in (jdc, tdc):
        got, meta = reader.load_checkpoint(path)
        assert meta == {"iteration": 7, "k": "v"}
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    other = (jdc if writer is tdc else tdc).write_checkpoint(
        tmp_path / "other", arrays, {"iteration": 7, "k": "v"})
    mine, theirs = tdc.read_manifest(path), tdc.read_manifest(other)
    assert mine["arrays"] == theirs["arrays"]
    assert mine["format"] == theirs["format"] == "dedalus-sharded-v1"


def test_corrupted_newest_hdf5_checkpoint_falls_back(tmp_path):
    """tests/test_resilience.py:266 and :286: the restore is exact; a
    truncated newest set falls back to the previous one; all sets
    corrupt raise the structured error; no directory is a fresh start."""
    ckpt = tmp_path / "ckpt"
    solver, u = diffusion(td3, tmp_path, metrics=False)
    loop = tres.ResilientLoop(solver, dt=1e-3, checkpoint_dir=ckpt,
                              install_signal_handlers=False)
    marks = {}
    for _ in range(3):
        for _ in range(4):
            solver.step(1e-3)
        loop.write_checkpoint()
        marks[solver.iteration] = state_of(solver).copy()
    sets = sorted(ckpt.glob("*.h5"),
                  key=lambda p: int(p.stem.rsplit("_s", 1)[1]))
    assert len(sets) == 3
    s1, _ = diffusion(td3, tmp_path, metrics=False)
    event = tres.resume_latest(s1, ckpt)
    assert not event["fallbacks"] and s1.iteration == 12
    assert np.array_equal(state_of(s1), marks[12]) and s1.dt == solver.dt
    tchaos.corrupt_checkpoint(sets[-1], mode="truncate")
    s2, _ = diffusion(td3, tmp_path, metrics=False)
    event = tres.resume_latest(s2, ckpt)
    assert event["path"] == str(sets[-2]) and len(event["fallbacks"]) == 1
    assert "unreadable" in event["fallbacks"][0]["reason"]
    assert s2.iteration == 8 and np.array_equal(state_of(s2), marks[8])
    for p in sets[:-1]:
        tchaos.corrupt_checkpoint(p, mode="truncate")
    with pytest.raises(CheckpointError, match="no loadable checkpoint"):
        tres.resume_latest(s2, ckpt)
    assert tres.resume_latest(s2, tmp_path / "nowhere") is None


def test_load_state_structured_errors_and_fallback(tmp_path):
    """tests/test_resilience.py:540."""
    import h5py
    ckpt = tmp_path / "ckpt"
    solver, u = diffusion(td3, tmp_path, metrics=False)
    handler = solver.evaluator.add_file_handler(ckpt, max_writes=10)
    handler.add_task(u, layout="c", name="u")
    clocks = []
    for _ in range(3):
        solver.step(1e-3)
        handler.process(iteration=solver.iteration,
                        sim_time=solver.sim_time, timestep=solver.dt)
        clocks.append((solver.iteration, solver.sim_time))
    path = handler.current_file
    with h5py.File(path, "r+") as f:
        ds = f["tasks/u"]
        ds.resize((2,) + ds.shape[1:])
    solver2, _ = diffusion(td3, tmp_path, metrics=False)
    with pytest.raises(CheckpointError) as excinfo:
        solver2.load_state(path, index=-1)
    err = excinfo.value
    assert isinstance(err, OSError) and str(path) in str(err)
    assert "torn write" in str(err) and err.index == 2
    write, dt = solver2.load_state(path, index=-1, fallback=True)
    assert write == 2 and (solver2.iteration, solver2.sim_time) == clocks[1]
    assert tres.validate_checkpoint(path) == jres.validate_checkpoint(path)
    n_valid, reason = tres.validate_checkpoint(path)
    assert n_valid == 2 and "torn write" in reason
    tchaos.corrupt_checkpoint(path, mode="truncate")
    with pytest.raises(CheckpointError, match="unreadable"):
        solver2.load_state(path)
    with pytest.raises(CheckpointError):
        solver2.load_state(tmp_path / "missing.h5")


# ------------------------------------------------- dcheckpoint on its own

def write_two(tmp_path):
    a = {"X": np.arange(12.0).reshape(3, 4)}
    b = {"X": np.arange(12.0).reshape(3, 4) + 100}
    tdc.write_checkpoint(tmp_path, a, {"iteration": 1})
    tdc.write_checkpoint(tmp_path, b, {"iteration": 2})
    return a, b


@pytest.mark.parametrize("damage", ["torn", "garbage", "truncate", "delete"])
def test_damaged_newest_quarantined_with_fallback(tmp_path, damage):
    """tests/test_dcheckpoint.py:119 and :138: a manifest-less (torn) or
    corrupted newest checkpoint is quarantined and the previous one
    restored; the JAX package's restore agrees on a copy."""
    import shutil
    a, b = write_two(tmp_path)
    newest = tdc.list_checkpoints(tmp_path)[-1]
    if damage == "torn":
        (newest / tdc.MANIFEST).unlink()
    else:
        tchaos.corrupt_shard(newest, mode=damage)
    shutil.copytree(tmp_path, tmp_path.parent / (tmp_path.name + "_jax"))
    event = tdc.restore_latest(tmp_path)
    jevent = jdc.restore_latest(tmp_path.parent / (tmp_path.name + "_jax"))
    for ev in (event, jevent):
        assert ev["meta"]["iteration"] == 1 and len(ev["fallbacks"]) == 1
        assert np.array_equal(ev["arrays"]["X"], a["X"])
        assert "quarantined" in ev["fallbacks"][0]
    assert len(tdc.list_checkpoints(tmp_path)) == 1


def test_all_corrupt_raises_and_retention(tmp_path):
    """tests/test_dcheckpoint.py:153 and :213."""
    write_two(tmp_path)
    for path in tdc.list_checkpoints(tmp_path):
        tchaos.corrupt_shard(path, mode="garbage")
    with pytest.raises(CheckpointError, match="no loadable sharded"):
        tdc.restore_latest(tmp_path)
    ck = tdc.ShardedCheckpointer(tmp_path / "keep", keep=2)
    for i in range(5):
        ck.save({"X": np.full(4, float(i))}, {"iteration": i})
    kept = tdc.list_checkpoints(tmp_path / "keep")
    assert len(kept) == 2
    assert tdc.restore_latest(tmp_path / "keep")["meta"]["iteration"] == 4


def test_torn_shard_chaos_fires_once_and_async_barrier(tmp_path):
    """tests/test_dcheckpoint.py:164 and :187: the torn write fires once
    and leaves the previous checkpoint valid; an async writer slowed per
    shard holds the loop at its in-flight budget and lands everything."""
    inj = tchaos.ChaosInjector(torn_shard_write=2, torn_after_shards=1)
    ck = tdc.ShardedCheckpointer(tmp_path / "torn", keep=3)
    inj.wire_checkpointer(ck)
    ck.save({"X": np.ones(4), "Y": np.zeros(3)}, {"iteration": 1})
    with pytest.raises(RuntimeError, match="torn"):
        ck.save({"X": np.ones(4) * 2, "Y": np.zeros(3)}, {"iteration": 2})
    ck.save({"X": np.ones(4) * 3, "Y": np.zeros(3)}, {"iteration": 3})
    assert [f["kind"] for f in inj.fired] == ["torn_shard"]
    assert tdc.restore_latest(tmp_path / "torn")["meta"]["iteration"] == 3
    slow = tchaos.ChaosInjector(slow_shard_sec=0.05)
    ck = tdc.ShardedCheckpointer(tmp_path / "async", async_write=True,
                                 inflight=1, keep=10)
    slow.wire_checkpointer(ck)
    for i in range(4):
        ck.save({"X": torch.full((4,), float(i))}, {"iteration": i})
    assert ck.close() == []
    assert ck.written == 4 and ck.max_inflight == 1
    assert ck.stall_sec > 0.05
    assert len(tdc.list_checkpoints(tmp_path / "async")) == 4


# ------------------------------------------- copies, not references

def test_snapshot_and_async_checkpoint_hold_copies(tmp_path):
    """A snapshot and an async checkpoint captured before a plain step and
    before a step_many block still hold the state of their capture after
    the steps ran (and after the state is written in place): the port
    copies on capture."""
    solver, u = diffusion(td3, tmp_path, scheme="SBDF2", metrics=False)
    for _ in range(4):
        solver.step(1e-3)
    ck = tdc.ShardedCheckpointer(tmp_path / "ck", async_write=True,
                                 inflight=4, keep=10)
    loop = tres.ResilientLoop(solver, dt=1e-3, install_signal_handlers=False)
    for advance in (lambda: solver.step(1e-3),
                    lambda: solver.step_many(6, 1e-3)):
        before = solver.X.clone()
        hists = [h.clone() for h in solver.timestepper.F_hist]
        snap = tres.capture_snapshot(solver)
        arrays, meta = loop._sharded_state()
        ck.save(arrays, meta)
        advance()
        solver.X.add_(1.0)                       # an in-place write
        for h in solver.timestepper.F_hist:
            h.add_(1.0)
        assert torch.equal(snap.X, before)
        assert torch.equal(snap.timestepper_state["F_hist"],
                           torch.stack(hists))
        assert ck.drain() == []
        got = tdc.restore_latest(tmp_path / "ck")["arrays"]
        assert np.array_equal(got["X"], before.numpy())
        assert np.array_equal(got["F_hist"], torch.stack(hists).numpy())
        solver.X.sub_(1.0)
        for h in solver.timestepper.F_hist:
            h.sub_(1.0)
        solver.defer_scatter(solver.X)
        solver.snapshot_versions()
    # a rewind restores copies: a second rewind to the same snapshot
    # finds it intact
    tres.restore_snapshot(solver, snap)
    solver.X.add_(1.0)
    tres.restore_snapshot(solver, snap)
    assert torch.equal(solver.X, snap.X)
    ck.close()


def test_poisoned_snapshot_skipped_and_postmortems_distinct(tmp_path):
    """tests/test_resilience.py:136 and :190."""
    solver, u = diffusion(td3, tmp_path)
    loop = tres.ResilientLoop(solver, dt=1e-3, snapshot_cadence=5,
                              retry_base_delay=0.0,
                              install_signal_handlers=False)
    loop._capture()
    good_iter = solver.iteration
    for _ in range(3):
        solver.step(1e-3)
    tchaos.ChaosInjector().poison_field(solver, "u")
    loop._capture()
    assert len(loop.ring) == 2
    solver.health.check()
    assert solver.health_error is not None
    loop._recover(solver.health_error)
    assert solver.iteration == good_iter and loop.rewinds == 1
    assert np.isfinite(state_of(solver)).all()
    s, _ = blowup(td3, tmp_path)
    paths = {s.health.dump_postmortem(f"attempt {i}") for i in range(3)}
    assert len(paths) == 3 and all(p.is_dir() for p in paths)


def test_retry_policy_and_loop_validation(tmp_path):
    """tests/test_resilience.py:442 and :586."""
    policy = tres.RetryPolicy(max_attempts=3, base_delay=0.0)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(errno.EIO, "flaky disk")
        return "ok"
    assert policy.call(flaky) == "ok" and calls["n"] == 3

    def denied():
        calls["n"] += 1
        raise OSError(errno.EACCES, "permission denied")
    calls["n"] = 0
    with pytest.raises(PermissionError):
        policy.call(denied)
    assert calls["n"] == 1
    with pytest.raises(ValueError):
        policy.call(lambda: (_ for _ in ()).throw(ValueError("not IO")))
    with pytest.raises(OSError):
        tres.RetryPolicy(max_attempts=2, base_delay=0.0).call(
            lambda: (_ for _ in ()).throw(OSError(errno.EIO, "always")))
    p = tres.RetryPolicy(max_attempts=5, base_delay=0.1, max_delay=0.25)
    jp = jres.RetryPolicy(max_attempts=5, base_delay=0.1, max_delay=0.25)
    assert [p.delay(k) for k in (1, 2, 3)] == [jp.delay(k)
                                               for k in (1, 2, 3)]
    solver, u = diffusion(td3, tmp_path, metrics=False)
    with pytest.raises(ValueError, match="sharded"):
        tres.ResilientLoop(solver, dt=1e-3, checkpoint_format="hdf5",
                           checkpoint_async=True,
                           install_signal_handlers=False)
    with pytest.raises(ValueError, match="hdf5"):
        tres.ResilientLoop(solver, dt=1e-3, checkpoint_format="zip",
                           install_signal_handlers=False)


def test_disabled_resilience_zero_overhead_and_schedule(tmp_path):
    """tests/test_resilience.py:628 and :641: a plain run never touches
    the resilience machinery; the evaluator's schedule rewinds."""
    solver, u = diffusion(td3, tmp_path)
    for _ in range(5):
        solver.step(1e-3)
    assert getattr(solver, "resilience", None) is None
    assert solver.evaluator.handlers == []
    rec = solver.flush_metrics()
    assert "resilience" not in rec
    assert not any(k.startswith("resilience/") for k in rec["counters"])
    solver, u = diffusion(td3, tmp_path, metrics=False)
    handler = solver.evaluator.add_dictionary_handler(iter=5)
    handler.add_task(u, name="u")
    state0 = handler.schedule_state()
    for _ in range(6):
        solver.step(1e-3)
    assert handler.last_iter_div == 1
    handler.restore_schedule_state(state0)
    assert handler.check_schedule(iteration=5) is True
