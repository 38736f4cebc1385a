"""
The port's numerical-health monitor and flight recorder
(dedalus_tpu_torch/tools/health.py) held against the JAX package's on the
CPU: the cases of tests/test_health.py, each problem built in both
packages from the same data. Health records are compared field by field:
NaN/Inf counts exactly, max|coefficient| and L2 within 1e-12 relative
(NaN where the JAX package has NaN), tail fractions within 1e-6 (both
records round them to 6 digits). One intra-op thread.
"""

import json
import math
import pathlib

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.tools import health as jhealth
from dedalus_tpu_torch.tools import health as thealth
from dedalus_tpu_torch.tools.exceptions import SolverHealthError

torch.set_num_threads(1)


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def state_of(solver):
    X = solver.X
    return X.numpy() if isinstance(X, torch.Tensor) else np.asarray(X)


def set_state(solver, X):
    if isinstance(solver.X, torch.Tensor):
        solver.X = torch.as_tensor(X)
    else:
        import jax.numpy as jnp
        solver.X = jnp.asarray(X)


def blowup(d3, tmp_path, N=16, **solver_kw):
    """tests/test_health.py:23: dt(s) = s*s from s0 = 2 at dt = 1, which
    overflows float64 within ~10 steps."""
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    xb = d3.RealFourier(coords["x"], size=N, bounds=(0, 2 * np.pi))
    s = dist.Field(name="s", bases=xb)
    problem = d3.IVP([s], namespace={})
    problem.add_equation((d3.dt(s), s * s))
    kw = dict(health_cadence=1, postmortem_dir=str(tmp_path / "pm"),
              warmup_iterations=2)
    kw.update(solver_kw)
    solver = problem.build_solver(d3.SBDF1, **kw)
    s["g"] = 2.0
    return solver, s


def static_2d(d3, Nx=16, Nz=24, **solver_kw):
    """tests/test_health.py:40: dt(s) = 0 on Fourier x Chebyshev."""
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    xb = d3.RealFourier(coords["x"], size=Nx, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords["z"], size=Nz, bounds=(0, 1))
    s = dist.Field(name="s", bases=(xb, zb))
    problem = d3.IVP([s], namespace={})
    problem.add_equation((d3.dt(s), 0))
    solver = problem.build_solver(d3.SBDF1, **solver_kw)
    return solver, s, dist, xb, zb


def same_value(a, b, rtol=1e-12):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return abs(a - b) <= rtol * max(abs(a), abs(b)) or a == b


def assert_same_fields(tfields, jfields):
    assert tfields.keys() == jfields.keys()
    for name, t in tfields.items():
        j = jfields[name]
        assert (t["nan"], t["inf"]) == (j["nan"], j["inf"]), name
        assert same_value(t["max_abs"], j["max_abs"]), name
        assert same_value(t["l2"], j["l2"]), name
        assert t["tail_frac"].keys() == j["tail_frac"].keys()
        for label, v in t["tail_frac"].items():
            assert abs(v - j["tail_frac"][label]) <= 1e-6, (name, label)


def run_until_halt(solver, dt, limit=60):
    while solver.proceed and solver.iteration < limit:
        solver.step(dt)
    return solver.health_error


@pytest.mark.parametrize("limit", [float("inf"), 1e6],
                         ids=["non_finite", "growth_bound"])
def test_divergent_ivp_halts_like_jax(tmp_path, limit):
    """tests/test_health.py:55 and :123: the same halt iteration, reason
    and health record as the JAX package; the flight-recorder directory
    holds the ring, the strict-JSON record and the HDF5 state; the
    summary rides the flush."""
    errs = {}
    for d3 in (jd3, td3):
        solver, _ = blowup(d3, tmp_path / d3.__name__.split(".")[0])
        solver.health.max_abs_limit = limit
        errs[d3] = (run_until_halt(solver, 1.0), solver)
    (terr, ts), (jerr, _) = errs[td3], errs[jd3]
    assert isinstance(terr, SolverHealthError) and isinstance(terr, ValueError)
    assert terr.iteration == jerr.iteration == ts.iteration
    assert terr.reason == jerr.reason
    assert_same_fields(terr.record["fields"], jerr.record["fields"])
    if limit == 1e6:
        assert "growth bound exceeded" in terr.reason
        assert terr.record["fields"]["s"]["nan"] == 0
    else:
        assert "non-finite state" in terr.reason
    pm = pathlib.Path(terr.postmortem_dir)
    record = json.loads((pm / "postmortem.json").read_text())
    assert record["kind"] == "health_postmortem"
    assert record["reason"] == terr.reason

    def reject_constant(name):
        raise AssertionError(f"non-strict JSON literal {name} in record")
    line = (pm / "record.jsonl").read_text().strip()
    assert json.loads(line, parse_constant=reject_constant)["reason"] \
        == terr.reason
    ring = [json.loads(ln, parse_constant=reject_constant) for ln
            in (pm / "health_ring.jsonl").read_text().splitlines()]
    assert ring[-1]["iteration"] == terr.iteration
    assert (pm / "state_at_failure.h5").exists()
    rec = ts.flush_metrics()
    assert rec["health"]["ok"] is False
    assert rec["health"]["reason"] == terr.reason
    # the forensic state loads back through load_state (finite there)
    if limit == 1e6:
        s2, _ = blowup(td3, tmp_path / "reload", health=False)
        s2.load_state(str(pm / "state_at_failure.h5"))
        assert s2.iteration == terr.iteration
        assert np.isfinite(state_of(s2)).all()


def test_postmortem_readers_match_jax(tmp_path):
    """read_postmortem/format_postmortem of the port render the port's
    dump as the JAX package's readers render it (the `postmortem` CLI
    of the JAX package reads the same files)."""
    solver, _ = blowup(td3, tmp_path)
    err = run_until_halt(solver, 1.0)
    record, ring = thealth.read_postmortem(err.postmortem_dir)
    jrecord, jring = jhealth.read_postmortem(err.postmortem_dir)
    assert record == jrecord and ring == jring
    lines = thealth.format_postmortem(record, ring)
    assert lines == jhealth.format_postmortem(jrecord, jring)
    text = "\n".join(lines)
    assert "Post-mortem:" in text and f"iteration={err.iteration}" in text
    assert "ring buffer" in text


def test_no_output_written_after_failure(tmp_path):
    """tests/test_health.py:138: the scheduled FileHandler is skipped on
    the poisoned step, in both packages alike."""
    import h5py
    iters = {}
    for d3 in (jd3, td3):
        solver, s = blowup(d3, tmp_path / d3.__name__.split(".")[0])
        solver.health.max_abs_limit = float("inf")
        snaps = solver.evaluator.add_file_handler(
            tmp_path / d3.__name__.split(".")[0] / "snaps", iter=1)
        snaps.add_task(s, name="s")
        err = run_until_halt(solver, 1.0)
        files = sorted((tmp_path / d3.__name__.split(".")[0]
                        / "snaps").glob("*.h5"))
        with h5py.File(files[-1], "r") as f:
            iters[d3] = np.asarray(f["scales/iteration"])
            data = np.asarray(f["tasks/s"])
        assert iters[d3].max() < err.iteration
        assert np.all(np.isfinite(data))
    assert np.array_equal(iters[td3], iters[jd3])


def test_rb_divergent_halts_like_jax(tmp_path):
    """tests/test_health.py:160 at RB 64x16 banded, f64: an explicitly
    unstable dt halts both packages at the same iteration with the same
    non-finite fields."""
    from dedalus_tpu.extras.bench_problems import build_rb_solver as jrb
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    errs = {}
    for name, build in (("jax", jrb), ("torch", build_rb_solver)):
        kw = {"device": "cpu"} if name == "torch" else {}
        solver, _ = build(64, 16, np.float64, matsolver="banded", **kw)
        solver.health.cadence = 1
        solver.health.max_abs_limit = float("inf")
        solver.health.postmortem_dir = str(tmp_path / name)
        steps = 0
        while solver.proceed and steps < 300:
            solver.step(100.0)
            steps += 1
        errs[name] = solver.health_error
        assert errs[name] is not None
        assert errs[name].iteration == solver.iteration
        assert pathlib.Path(errs[name].postmortem_dir).is_dir()
    assert errs["torch"].iteration == errs["jax"].iteration
    bad = {name: sorted(n for n, st in err.record["fields"].items()
                        if st["nan"] or st["inf"])
           for name, err in errs.items()}
    assert bad["torch"] == bad["jax"] and bad["torch"]


@pytest.mark.parametrize("case", ["flat", "resolved", "zero"])
def test_tail_energy_record_matches_jax(case, caplog):
    """tests/test_health.py:183 and :233: a flat spectrum warns once per
    field and axis, a resolved one and a zero field stay quiet; the probe
    records equal the JAX package's."""
    import logging
    recs, warnings = {}, {}
    for d3 in (jd3, td3):
        solver, s, dist, xb, zb = static_2d(d3)
        if case == "flat":
            s["c"] = np.ones_like(np.asarray(s["c"]))
        elif case == "resolved":
            z = dist.local_grids(xb, zb)[1]
            s["g"] = np.exp(-((np.asarray(z) - 0.5) ** 2) * 8.0) \
                * np.ones((16, 1))
        solver.X = solver.gather_fields()
        with caplog.at_level(logging.WARNING):
            recs[d3] = solver.health.check()
            solver.health.check()      # the same state: no second warning
        warnings[d3] = solver.health.warnings
    assert_same_fields(recs[td3]["fields"], recs[jd3]["fields"])
    assert warnings[td3] == warnings[jd3]
    tail = recs[td3]["fields"]["s"]["tail_frac"]["z"]
    if case == "flat":
        assert tail > 0.25 and warnings[td3] >= 2
        assert "axis 'z'" in caplog.text
    elif case == "resolved":
        assert tail < 0.01 and warnings[td3] == 0
    else:
        assert recs[td3]["fields"]["s"]["l2"] == 0.0 and warnings[td3] == 0


def test_probe_counts_and_tau_exemption_match_jax(tmp_path):
    """tests/test_health.py:209 and :242: exact NaN/Inf counts, and a
    tau field's flat spectrum recorded without a warning, its NaN still
    fatal."""
    recs = {}
    for d3 in (jd3, td3):
        solver, s, *_ = static_2d(d3, postmortem_dir=str(
            tmp_path / d3.__name__.split(".")[0]))
        X = state_of(solver).copy()
        X[0, 0] = np.nan
        X[0, 1] = np.inf
        X[1, 2] = -np.inf
        set_state(solver, X)
        recs[d3] = solver.health.check()
        assert solver.health_error is not None
        assert "non-finite state" in solver.health_error.reason
    assert recs[td3]["fields"]["s"]["nan"] == 1
    assert recs[td3]["fields"]["s"]["inf"] == 2
    assert_same_fields(recs[td3]["fields"], recs[jd3]["fields"])
    # tau_* fields: recorded, exempt from the tail warning
    recs = {}
    for d3 in (jd3, td3):
        coords = d3.CartesianCoordinates("x")
        dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
        xb = d3.RealFourier(coords["x"], size=16, bounds=(0, 2 * np.pi))
        tau_s = dist.Field(name="tau_s", bases=xb)
        problem = d3.IVP([tau_s], namespace={})
        problem.add_equation((d3.dt(tau_s), 0))
        solver = problem.build_solver(d3.SBDF1, postmortem_dir=str(
            tmp_path / ("tau" + d3.__name__.split(".")[0])))
        tau_s["c"] = np.ones_like(np.asarray(tau_s["c"]))
        solver.X = solver.gather_fields()
        recs[d3] = solver.health.check()
        assert solver.health.warnings == 0
        X = state_of(solver).copy()
        X[0, 0] = np.nan
        set_state(solver, X)
        solver.health.check()
        assert solver.health_error is not None
    assert recs[td3]["fields"]["tau_s"]["tail_frac"]["x"] > 0.25
    assert_same_fields(recs[td3]["fields"], recs[jd3]["fields"])


def test_invalid_dt_routes_through_health(tmp_path):
    """tests/test_health.py:268: a non-finite dt raises the structured
    error with one dump per run and leaves the solver healthy; with
    health off a ValueError still guards step_many."""
    solver, s = blowup(td3, tmp_path)
    solver.step(0.01)
    with pytest.raises(SolverHealthError) as excinfo:
        solver.step(np.nan)
    err = excinfo.value
    assert "Invalid timestep" in str(err)
    assert f"iteration {solver.iteration}" in str(err)
    assert err.postmortem_dir and pathlib.Path(err.postmortem_dir).is_dir()
    assert solver.proceed and solver.health_error is None
    solver.step(0.01)
    assert np.isfinite(state_of(solver)).all()
    pm_parent = pathlib.Path(err.postmortem_dir).parent
    n_dumps = len(list(pm_parent.iterdir()))
    with pytest.raises(SolverHealthError):
        solver.step(np.nan)
    assert len(list(pm_parent.iterdir())) == n_dumps
    with pytest.raises(ValueError):
        solver2, _ = blowup(td3, tmp_path, health=False)
        solver2.step_many(3, np.inf)


def test_ring_cadence_and_summary(tmp_path):
    """tests/test_health.py:258, :300 and :346: the ring stays bounded, a
    new cadence re-arms the gate, and a healthy run flushes ok=True with
    its check count."""
    solver, s = blowup(td3, tmp_path)
    solver.health.ring = type(solver.health.ring)(maxlen=4)
    for _ in range(10):
        solver.health.check()
    assert len(solver.health.ring) == 4
    solver, s = blowup(td3, tmp_path, health_cadence=1000)
    for _ in range(3):
        solver.step(1e-3)
    checks0 = solver.health.checks
    solver.health.cadence = 2
    for _ in range(6):
        solver.step(1e-3)
    assert solver.health.checks >= checks0 + 2
    solver.stop_iteration = 12
    while solver.proceed:
        solver.step(1e-3)
    health = solver.flush_metrics()["health"]
    assert health["ok"] is True and health["checks"] >= 1
    assert "max_abs" in health


def test_health_off_zero_overhead(tmp_path):
    """tests/test_health.py:313: health=False builds no probe plan and
    keeps no records; flushes carry no health key."""
    solver, s = blowup(td3, tmp_path, health=False)
    for _ in range(5):
        solver.step(0.01)
    monitor = solver.health
    assert monitor.enabled is False
    assert monitor._plan is None
    assert monitor.checks == 0 and len(monitor.ring) == 0
    assert monitor.summary() is None
    rec = solver.flush_metrics()
    assert rec is None or "health" not in rec


def test_probe_reads_the_host_once_per_check(tmp_path, monkeypatch):
    """The probe's reductions of every field come back in ONE host read
    (Tensor.tolist on the stacked tensor), and an off-cadence step reads
    nothing."""
    solver, s, *_ = static_2d(td3, health_cadence=4)
    reads = []
    tolist = torch.Tensor.tolist

    def counted(self):
        reads.append(tuple(self.shape))
        return tolist(self)
    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    solver.step(1e-3)
    solver.step(1e-3)
    assert reads == []
    solver.health.check()
    assert len(reads) == 1
