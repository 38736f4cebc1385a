"""
The port's step-loop metrics (dedalus_tpu_torch/tools/metrics.py) held
against the JAX package's on the CPU: the cases of tests/test_metrics.py.
Records, histograms and phase tables built from the same inputs in both
packages are compared exactly (`format_phase_table` lines, percentiles);
the instrumented solver runs RB 64x16 banded. One intra-op thread.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dedalus_tpu.tools import metrics as jmetrics
from dedalus_tpu_torch.tools import metrics as tmetrics
from dedalus_tpu_torch.tools.metrics import (PHASES, Counter, Metrics,
                                             MemoryWatermark, PhaseTimer)

torch.set_num_threads(1)


def test_counter_timer_and_gate_semantics():
    """tests/test_metrics.py:17, :32 and :56."""
    c = Counter("steps")
    assert (c.value, c.inc(), c.inc(5)) == (0, 1, 6)
    m = Metrics(sample_cadence=10)
    m.inc("a")
    m.inc("a", 2)
    assert m.counter("a").value == 3
    off = Metrics(enabled=False)
    off.inc("a", 7)
    assert off.counter("a").value == 0
    t = PhaseTimer()
    assert set(t.totals) == set(PHASES) == set(jmetrics.PHASES)
    t.add("transform", 0.5)
    t.add("transform", 1.5)
    t.add("matsolve", 1.0)
    assert t.mean("transform") == pytest.approx(1.0)
    assert t.mean("transpose") == 0.0 and t.samples == 2
    m = Metrics(sample_cadence=5)
    fired = []
    for i in range(1, 21):
        m.observe_steps(1)
        if m.due():
            fired.append(i)
    assert fired == [5, 10, 15, 20]
    m2 = Metrics(sample_cadence=5)
    m2.observe_steps(17)
    assert m2.due() and not m2.due()
    m3 = Metrics(sample_cadence=5, sampling=False)
    m3.observe_steps(50)
    assert not m3.due()


def test_histograms_match_jax():
    """The same seeded samples give the JAX package's p50/p95/p99."""
    samples = np.random.default_rng(5).lognormal(-7, 1.5, 400)
    tt, jt = PhaseTimer(), jmetrics.PhaseTimer()
    for x in samples:
        tt.add("matsolve", float(x))
        jt.add("matsolve", float(x))
    assert tt.percentiles("matsolve") == jt.percentiles("matsolve")
    assert tt.percentiles("transform") is None


def test_memory_watermark_cpu():
    """On the CPU the watermark is the process RSS."""
    w = MemoryWatermark(torch.device("cpu"))
    first = w.sample()
    keep = torch.ones((4096, 1024), dtype=torch.float64)
    second = w.sample()
    assert second >= first > 0 and w.peak_bytes == max(first, second)
    assert w.source == "rss"
    del keep
    assert tmetrics.process_rss_bytes() > 0


def test_time_thunk_warms_once_and_synchronizes(monkeypatch):
    """tests/test_metrics.py:75: the first call per name runs untimed;
    each run is followed by a device synchronization."""
    calls = []
    m = Metrics(sample_cadence=1)
    monkeypatch.setattr(m, "synchronize", lambda: calls.append("sync"))
    thunk = lambda: calls.append("run")  # noqa: E731
    m.time_thunk("x", thunk)
    assert calls == ["run", "sync", "run", "sync"]
    calls.clear()
    m.time_thunk("x", thunk)
    assert calls == ["run", "sync"]


def test_jsonl_flush_roundtrip(tmp_path):
    """tests/test_metrics.py:92, and the same record in both packages."""
    sink = tmp_path / "metrics.jsonl"
    recs = {}
    for name, mod in (("torch", tmetrics), ("jax", jmetrics)):
        m = mod.Metrics(sample_cadence=2, sink=str(tmp_path / f"{name}.jsonl"),
                        meta={"config": "unit", "backend": "cpu"})
        m.observe_steps(4)
        m.add_phase_sample({"transform": 0.01, "matsolve": 0.02,
                            "transpose": 0.0, "evaluator": 0.005})
        recs[name] = m.flush(extra={"note": "roundtrip"})
    drop = ("ts", "loop_wall_sec", "steps_per_sec", "phase_sum_frac",
            "device_mem_peak_bytes", "mem_source")
    assert {k: v for k, v in recs["torch"].items() if k not in drop} == \
        {k: v for k, v in recs["jax"].items() if k not in drop}
    parsed = json.loads((tmp_path / "torch.jsonl").read_text().splitlines()[0])
    assert parsed["kind"] == "step_metrics" and parsed["note"] == "roundtrip"
    assert parsed["phase_total_sec"]["matsolve"] == pytest.approx(0.08)
    m = Metrics(sink=str(sink))
    m.flush()
    m.flush()
    assert len(sink.read_text().splitlines()) == 2
    assert Metrics(enabled=False).flush() is None


def test_resolve_respects_spec_and_config():
    """tests/test_metrics.py:120, with the JAX package's config values."""
    m = Metrics(sample_cadence=7, meta={"backend": "x"})
    same = tmetrics.resolve(m, meta={"backend": "y", "dtype": "f32"})
    assert same is m and same.meta == {"backend": "x", "dtype": "f32"}
    assert not tmetrics.resolve(False).enabled
    on = tmetrics.resolve(True, sink=None, cadence=33)
    assert on.enabled and on.sample_cadence == 33
    default, jdefault = tmetrics.resolve(None), jmetrics.resolve(None)
    assert (default.enabled, default.sample_cadence, default.sink) == \
        (jdefault.enabled, jdefault.sample_cadence, jdefault.sink)


FORMAT_RECORDS = {
    "zero_samples": {"phase_samples": 0, "iterations": 0,
                     "loop_wall_sec": 0.0},
    "overlap_split": {"phase_samples": 0, "iterations": 10,
                      "loop_wall_sec": 1.0,
                      "phase_total_sec": {"transpose_exposed": 0.25,
                                          "transpose_overlapped": 0.75}},
    "percentiles": {"phase_samples": 8, "iterations": 40,
                    "loop_wall_sec": 4.0, "sample_cadence": 5,
                    "phase_mean_sec": {"transform": 0.01, "matsolve": 0.02},
                    "phase_total_sec": {"transform": 0.4, "matsolve": 0.8},
                    "phase_pct_sec": {"matsolve": {"p50": 0.019, "p95": 0.03,
                                                   "p99": 0.05}},
                    "device_mem_peak_bytes": 123456789,
                    "mem_source": "memory_stats"},
    "fused": {"phase_samples": 3, "iterations": 30, "loop_wall_sec": 2.0,
              "sample_cadence": 10,
              "phase_mean_sec": {"fused": 0.05, "evaluator": 0.01},
              "phase_total_sec": {"fused": 1.5, "evaluator": 0.3}},
    "empty": {},
    "none": None,
}


@pytest.mark.parametrize("case", sorted(FORMAT_RECORDS))
def test_format_phase_table_matches_jax(case):
    """tests/test_metrics.py:297-:367: the port renders every record as
    the JAX package does, line for line."""
    rec = FORMAT_RECORDS[case]
    lines = tmetrics.format_phase_table(rec)
    assert lines == jmetrics.format_phase_table(rec)
    if case == "overlap_split":
        text = "\n".join(lines)
        assert "(75% hidden" in text and "sum        0.000 s" in text


def test_build_phases_record_matches_jax():
    """BuildPhases flattens to the JAX package's keys."""
    t, j = tmetrics.BuildPhases(), jmetrics.BuildPhases()
    for bp in (t, j):
        bp.add("factor", 1.25)
        bp.add("factor", 0.5)
        bp.add("host_assembly", 2.0)
    assert t.record() == {k: v for k, v in j.record().items()}
    with t.scope("structure"):
        pass
    assert t.record()["structure_sec"] >= 0.0


def instrumented_rb(tmp_path, cadence=4):
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    solver, b = build_rb_solver(64, 16, np.float64, matsolver="banded",
                                device="cpu")
    solver.warmup_iterations = 2
    solver.metrics = tmetrics.resolve(
        True, sink=str(tmp_path / "m.jsonl"), cadence=cadence,
        meta={"backend": "cpu", "dtype": "float64", "config": "rb_smoke"},
        device=torch.device("cpu"))
    return solver


def test_instrumented_solver_records_phases(tmp_path, caplog):
    """tests/test_metrics.py:142, :169 and :219: a step/step_many run
    emits a phase record whose rows are positive (transpose 0 on one
    device), the sampler runs at the warmup end and on the cadence only,
    sampling leaves the state as a plain run leaves it, and log_stats
    prints the table."""
    import logging
    solver = instrumented_rb(tmp_path)
    calls = []
    orig = solver._sample_phases

    def spy():
        calls.append(solver.iteration)
        return orig()
    solver._sample_phases = spy
    dt = 1e-4
    for _ in range(3):
        solver.step(dt)
    solver.step_many(9, dt)
    assert calls == [2, 12]
    rec = solver.flush_metrics()
    assert rec["iterations"] == 10 and rec["phase_samples"] == 2
    assert set(rec["phase_total_sec"]) == set(PHASES)
    assert rec["phase_total_sec"]["transpose"] == 0.0
    for phase in ("transform", "matsolve", "evaluator"):
        assert rec["phase_total_sec"][phase] > 0.0
    assert rec["counters"]["step_many_blocks"] == 1
    assert rec["build_phases"]["factor_sec"] >= 0.0
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["phase_total_sec"] == rec["phase_total_sec"]
    # the same steps with metrics off: bit-equal states
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    plain, _ = build_rb_solver(64, 16, np.float64, matsolver="banded",
                               device="cpu", metrics=False, health=False)
    plain.warmup_iterations = 2
    for _ in range(3):
        plain.step(dt)
    plain.step_many(9, dt)
    assert torch.equal(plain.X, solver.X)
    assert plain.flush_metrics() is None
    with caplog.at_level(logging.INFO, logger="dedalus_tpu_torch"):
        solver.log_stats()
    for phase in tmetrics.SUM_PHASES:
        assert phase in caplog.text
    assert "Per-phase wall time" in caplog.text


def test_step_many_only_caller_defers_warm(tmp_path):
    """tests/test_metrics.py:191: a caller of step_many alone crosses
    warmup before the first factor; the first sample waits for the end
    of that block and the loop window starts after it."""
    solver = instrumented_rb(tmp_path, cadence=1000)
    solver.step_many(6, 1e-4)
    assert not solver._metrics_warm_pending and solver.metrics.sampling
    solver.step_many(4, 1e-4)
    rec = solver.flush_metrics()
    assert rec["phase_samples"] == 1 and rec["iterations"] == 4


def test_sigint_chains_abnormal_exit_flush(tmp_path):
    """tests/test_metrics.py:253: SIGINT on an unflushed run flushes one
    record through the chaining hook, then the process still dies by
    KeyboardInterrupt."""
    sink = tmp_path / "flush.jsonl"
    script = f"""
import os, signal
from dedalus_tpu_torch.tools import metrics as metrics_mod
class Stub:
    metrics = metrics_mod.Metrics(sink={str(sink)!r}, enabled=True)
    def flush_metrics(self, extra=None):
        return self.metrics.flush(extra=extra)
stub = Stub()
metrics_mod.register_exit_flush(stub)
stub.metrics.observe_steps(3)
os.kill(os.getpid(), signal.SIGINT)
print("UNREACHABLE")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "UNREACHABLE" not in proc.stdout
    assert "KeyboardInterrupt" in proc.stderr
    records = [json.loads(line)
               for line in sink.read_text().splitlines() if line.strip()]
    assert len(records) == 1
    assert records[0]["flush_source"] == "signal:2"
    assert records[0]["iterations"] == 3
