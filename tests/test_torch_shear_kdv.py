"""
The progression's KdV-Burgers and shear-flow IVPs (the JAX package's
benchmarks/progression.py build_kdv/build_shear) through the port's
public API, held against the JAX package: shear 32x32 RK222 10 steps and
KdV 64 SBDF2 50 steps to 1e-12 relative; a CFL-driven shear 32x32 run
with the settings of examples/shear_flow.py whose dt sequence equals the
JAX package's to 1e-13 relative; GlobalFlowProperty reductions of
np.sqrt(u@u)/nu to 1e-12; the run loop's stop conditions; and a
DictionaryHandler on the JAX package's schedule.
"""

import sys
import pathlib

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "benchmarks"))
from progression import build_kdv, build_shear  # noqa: E402

import dedalus_tpu.public as jd3  # noqa: E402
import dedalus_tpu_torch.public as td3  # noqa: E402
from dedalus_tpu_torch.core.future import EvalContext  # noqa: E402
from dedalus_tpu_torch.extras.bench_problems import (  # noqa: E402
    build_kdv_solver, build_shear_solver)

torch.set_num_threads(1)

RTOL = 1e-12


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def fields(solver):
    return {v.name: v for v in solver.variables}


def test_shear_rk222_matches_jax():
    js, dt = build_shear(32, np.float64)
    ts, tdt = build_shear_solver(32, device="cpu")
    assert tdt == dt and ts.pencil_shape == js.pencil_shape == (256, 20)
    for _ in range(10):
        js.step(dt)
        ts.step(dt)
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL
    for name in ("u", "s", "p"):
        assert rel_err(fields(ts)[name]["g"],
                       np.asarray(fields(js)[name]["g"])) <= RTOL


def test_kdv_sbdf2_matches_jax():
    js, dt = build_kdv(64, np.float64)
    ts, tdt = build_kdv_solver(64, device="cpu")
    assert tdt == dt and ts.pencil_shape == js.pencil_shape == (32, 2)
    for _ in range(50):
        js.step(dt)
        ts.step(dt)
    assert ts.timestepper.factorizations == 2
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL
    u = fields(ts)["u"]
    assert rel_err(u["g"], np.asarray(fields(js)["u"]["g"])) <= RTOL


def cfl_run(d3, solver, steps, safety):
    """The main loop of examples/shear_flow.py for `steps` iterations."""
    cfl = d3.CFL(solver, initial_dt=1e-2, cadence=10, safety=safety,
                 threshold=0.1, max_change=1.5, min_change=0.5, max_dt=1e-2)
    cfl.add_velocity(fields(solver)["u"])
    dts = []
    solver.stop_iteration = steps
    while solver.proceed:
        dts.append(cfl.compute_timestep())
        solver.step(dts[-1])
    return np.array(dts)


@pytest.mark.parametrize("safety,distinct", [(0.2, 1), (0.05, 2)],
                         ids=["example", "tight"])
def test_cfl_dt_sequence_matches_jax(safety, distinct):
    """With the example's safety 0.2 the frequency at 32x32 (about 16)
    keeps dt at max_dt; at safety 0.05 the controller moves it (the
    min_change clamp at iteration 0, a smaller dt at 10)."""
    js, _ = build_shear(32, np.float64)
    ts, _ = build_shear_solver(32, device="cpu")
    jdts = cfl_run(jd3, js, 30, safety)
    tdts = cfl_run(td3, ts, 30, safety)
    assert len(tdts) == len(jdts) == 30 == ts.iteration
    assert np.max(np.abs(tdts - jdts) / jdts) <= 1e-13
    assert len(set(tdts.tolist())) >= distinct
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) <= RTOL


def test_advective_cfl_operator_matches_host_frequency():
    """AdvectiveCFL(u) evaluated on the device equals the CFL's frequency
    field."""
    ts, _ = build_shear_solver(16, device="cpu")
    u = fields(ts)["u"]
    data = td3.AdvectiveCFL(u).ev(EvalContext(), "g").numpy()
    cfl = td3.CFL(ts, initial_dt=1e-2)
    cfl.add_velocity(u)
    assert data.max() == cfl.compute_max_frequency() > 0


def test_flow_property_matches_jax():
    nu = 1 / 5e4
    js, dt = build_shear(32, np.float64)
    ts, _ = build_shear_solver(32, device="cpu")
    props = []
    for d3, solver in ((jd3, js), (td3, ts)):
        u = fields(solver)["u"]
        flow = d3.GlobalFlowProperty(solver, cadence=2)
        flow.add_property(np.sqrt(u @ u) / nu, name="Re")
        for _ in range(4):
            solver.step(dt)
        props.append(flow)
    jflow, tflow = props
    assert type(tflow.properties["Re"]) is np.ndarray
    for reduce in ("max", "min", "grid_average"):
        ref = getattr(jflow, reduce)("Re")
        assert abs(getattr(tflow, reduce)("Re") - ref) <= RTOL * abs(ref)


def test_unary_grid_function_dispatch():
    ts, _ = build_shear_solver(16, device="cpu")
    s = fields(ts)["s"]
    op = np.exp(s)
    assert isinstance(op, td3.UnaryGridFunction) and str(op) == "exp(s)"
    s.change_scales(s.domain.dealias)
    assert np.array_equal(op.ev(EvalContext(), "g").numpy(), np.exp(s["g"]))


@pytest.mark.parametrize("stop", ["sim_time", "iteration", "wall_time"])
def test_proceed_stops(stop):
    ts, dt = build_kdv_solver(64, device="cpu")
    if stop == "sim_time":
        ts.stop_sim_time = 7.5 * dt
        expected = 8
    elif stop == "iteration":
        ts.stop_iteration = 5
        expected = 5
    else:
        ts.stop_wall_time = 0.0
        expected = 0
    while ts.proceed:
        ts.step(dt)
    assert ts.iteration == expected
    ts.log_stats()


def test_dictionary_handler_schedule_matches_jax():
    fired = []
    outputs = []
    for d3, build in ((jd3, build_kdv), (td3, build_kdv_solver)):
        kw = {"device": "cpu"} if d3 is td3 else {}
        solver, dt = build(64, np.float64, **kw)
        handler = solver.evaluator.add_dictionary_handler(iter=5)
        handler.add_task(fields(solver)["u"], name="u")
        handler.add_task("u*u", layout="c")
        its = []
        process = handler.process

        def recorded(process=process, its=its, **kw):
            its.append(kw["iteration"])
            return process(**kw)

        handler.process = recorded
        for _ in range(17):
            solver.step(dt)
        fired.append(its)
        outputs.append(handler)
    assert fired[0] == fired[1] == [1, 5, 10, 15]
    for name in ("u", "u*u"):
        assert rel_err(outputs[1][name], np.asarray(outputs[0][name])) <= RTOL


def test_file_handler_names_its_slice(tmp_path, monkeypatch):
    """add_file_handler writes HDF5 sets on a KdV 64 run (10 steps at
    iter=5: writes 1, 2 and 3 of one set, at iterations 1, 5 and 10, u in
    coefficient layout equal to the solver's field at the last), and
    without h5py it raises the ImportError naming h5py."""
    import builtins
    h5py = pytest.importorskip("h5py")
    ts, dt = build_kdv_solver(64, device="cpu")
    u = ts.state[0]
    handler = ts.evaluator.add_file_handler(tmp_path / "snapshots", iter=5)
    handler.add_task(u, layout="c", name="u")
    for _ in range(10):
        ts.step(dt)
    files = sorted((tmp_path / "snapshots").glob("snapshots_s*.h5"))
    assert [f.name for f in files] == ["snapshots_s1.h5"]
    with h5py.File(files[0], "r") as f:
        assert list(np.asarray(f["scales/write_number"])) == [1, 2, 3]
        assert list(np.asarray(f["scales/iteration"])) == [1, 5, 10]
        assert np.array_equal(np.asarray(f["tasks/u"])[-1],
                              np.asarray(u["c"]))
    real_import = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py" or name.startswith("h5py."):
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        ts.evaluator.add_file_handler(tmp_path / "more", iter=10)


def test_operator_constants_upload_once():
    """Steady steps upload no operator matrix (each node builds its terms
    once, so the device copies are cache hits: no host-to-device copy,
    which on the card is a host synchronization), and the matrices of an
    expression evaluated once leave the cache with it."""
    import gc
    from dedalus_tpu_torch.tools import array
    ts, dt = build_shear_solver(32, device="cpu")
    for _ in range(2):
        ts.step(dt)
    gc.collect()
    before = set(array._CONSTANTS)
    for _ in range(3):
        ts.step(dt)
    assert set(array._CONSTANTS) <= before
    op = td3.lap(fields(ts)["u"])
    op.evaluate()
    assert len(array._CONSTANTS) > len(before)
    del op
    gc.collect()
    assert set(array._CONSTANTS) <= before
