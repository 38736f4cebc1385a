"""
The port's HDF5 output (dedalus_tpu_torch/core/evaluator.py FileHandler,
tools/post.py) and `load_state` held against the JAX package on the CPU:
the cases of tests/test_output.py, run in both packages from the same
data, with the files compared object by object — datasets, shapes,
dtypes, the `layout` attribute, dimension labels, attached grid scales
(names and values) and set numbering equal; task data within 1e-12 of
max|data| (wall_time, a clock, is left out). A checkpoint written by
either package loads through the other's `load_state` with the state
equal bit for bit (coefficient layout) or within 1e-13 (grid layout:
one transform each way). One intra-op thread.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3

h5py = pytest.importorskip("h5py")
torch.set_num_threads(1)


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def tag(d3):
    return "torch" if d3 is td3 else "jax"


def state_of(solver):
    X = solver.X
    return X.numpy() if isinstance(X, torch.Tensor) else np.asarray(X)


def heat(d3, scheme="SBDF1"):
    """tests/test_output.py:13: 1-D heat on RealFourier(16)."""
    coords = d3.CartesianCoordinates("x")
    dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
    xb = d3.RealFourier(coords["x"], size=16, bounds=(0, 2 * np.pi))
    u = dist.Field(name="u", bases=xb)
    problem = d3.IVP([u], namespace={})
    problem.add_equation((d3.dt(u) - 0.1 * d3.lap(u), 0))
    solver = problem.build_solver(getattr(d3, scheme))
    x, = dist.local_grids(xb)
    u["g"] = np.cos(x) + 0.5 * np.cos(3 * x)
    return solver, u, x


def static_fields(d3, curvilinear=False):
    """Fields held still (dt = 0) on Fourier x Chebyshev, or on a disk:
    a scalar and a vector, for grid scales of two axes, tensor components
    and a multi-dimensional basis."""
    if curvilinear:
        coords = d3.PolarCoordinates("phi", "r")
        dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
        basis = d3.DiskBasis(coords, shape=(16, 8), radius=1.0,
                             dtype=np.float64)
        bases = basis
        phi, r = dist.local_grids(basis)
        grids = (np.asarray(phi), np.asarray(r))
    else:
        coords = d3.CartesianCoordinates("x", "z")
        dist = d3.Distributor(coords, dtype=np.float64, **dist_kw(d3))
        xb = d3.RealFourier(coords["x"], size=16, bounds=(0, 2 * np.pi))
        zb = d3.ChebyshevT(coords["z"], size=12, bounds=(0, 1))
        bases = (xb, zb)
        grids = tuple(np.asarray(g) for g in dist.local_grids(xb, zb))
    s = dist.Field(name="s", bases=bases)
    v = dist.VectorField(coords, name="v", bases=bases)
    problem = d3.IVP([s, v], namespace={})
    problem.add_equation((d3.dt(s), 0))
    problem.add_equation((d3.dt(v), 0))
    solver = problem.build_solver(d3.SBDF1)
    a, b = grids
    s["g"] = np.cos(a) * b ** 2 + 0.0 * a
    vg = np.zeros(np.asarray(v["g"]).shape)
    vg[0] = np.sin(a) * b + 0.0 * a
    vg[1] = b ** 3 * np.cos(2 * a) + 0.0 * a
    v["g"] = vg
    return solver, s, v


def h5_contents(path):
    """{name: (kind, shape, dtype, attrs, dim labels, attached scales,
    data)} of every object in a file."""
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            labels = tuple(d.label for d in obj.dims)
            scales = tuple(tuple(np.asarray(d[0]).tolist()) if len(d) else ()
                           for d in obj.dims)
            out[name] = {"shape": obj.shape, "dtype": str(obj.dtype),
                         "attrs": {k: (v.decode() if isinstance(v, bytes)
                                       else v) for k, v in obj.attrs.items()
                                   if k in ("layout",)},
                         "labels": labels, "scales": scales,
                         "data": np.asarray(obj)}
        else:
            out[name] = "group"
    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def assert_same_files(tdir, jdir, stem):
    tfiles = sorted(p.name for p in tdir.glob(f"{stem}_s*.h5"))
    jfiles = sorted(p.name for p in jdir.glob(f"{stem}_s*.h5"))
    assert tfiles == jfiles and tfiles
    for name in tfiles:
        t, j = h5_contents(tdir / name), h5_contents(jdir / name)
        assert t.keys() == j.keys(), name
        for key, tv in t.items():
            jv = j[key]
            if tv == "group" or key == "scales/wall_time":
                continue
            for field in ("shape", "dtype", "attrs", "labels"):
                assert tv[field] == jv[field], (name, key, field)
            for ts, js in zip(tv["scales"], jv["scales"]):
                np.testing.assert_allclose(ts, js, rtol=0, atol=1e-14)
            scale = max(np.abs(jv["data"]).max(), 1.0) \
                if jv["data"].size else 1.0
            assert np.abs(tv["data"] - jv["data"]).max() <= 1e-12 * scale, \
                (name, key)


def test_filehandler_schema_and_sets_match_jax(tmp_path):
    """tests/test_output.py:26 and :123: 6 writes at 2 per set make 3
    sets; datasets, scales, dimension labels and grid scales equal the
    JAX package's files."""
    for d3 in (jd3, td3):
        solver, u, x = heat(d3)
        handler = solver.evaluator.add_file_handler(
            tmp_path / tag(d3) / "snaps", iter=2, max_writes=2)
        handler.add_task(u, name="u")
        handler.add_task(d3.lap(u), name="lap_u")
        handler.add_task(u, name="u_c", layout="c")
        for _ in range(10):
            solver.step(1e-3)
    assert_same_files(tmp_path / "torch" / "snaps",
                      tmp_path / "jax" / "snaps", "snaps")
    files = sorted((tmp_path / "torch" / "snaps").glob("snaps_s*.h5"))
    assert len(files) == 3
    with h5py.File(files[-1], "r") as f:
        assert np.asarray(f["scales/write_number"])[-1] == 6
        assert f["tasks/u"].dims[1].label == "x"
        assert f["tasks/u_c"].attrs["layout"] == "c"


@pytest.mark.parametrize("curvilinear", [False, True], ids=["xz", "disk"])
def test_multi_axis_and_vector_tasks_match_jax(tmp_path, curvilinear):
    """Two-axis grids, tensor components, a dealiased-scale task and a
    multi-dimensional (disk) basis: the same schema and data."""
    for d3 in (jd3, td3):
        solver, s, v = static_fields(d3, curvilinear)
        handler = solver.evaluator.add_file_handler(
            tmp_path / tag(d3) / "fields", iter=1, max_writes=4)
        handler.add_task(s, name="s")
        handler.add_task(v, name="v")
        handler.add_task(v, name="v_c", layout="c")
        handler.add_task(s, name="s_fine", scales=3 / 2)
        for _ in range(3):
            solver.step(1e-3)
    assert_same_files(tmp_path / "torch" / "fields",
                      tmp_path / "jax" / "fields", "fields")


@pytest.mark.parametrize("max_writes,expect_sets,expect",
                         [(3, 2, [4, 5]), (5, 1, [1, 2, 3, 4])],
                         ids=["new_set", "partial_set"])
def test_append_mode_matches_jax(tmp_path, max_writes, expect_sets, expect):
    """tests/test_output.py:50 and :103: append mode continues the set
    and write numbering (a fresh set, or the partial last one)."""
    first = 3 if max_writes == 3 else 2
    for d3 in (jd3, td3):
        out = tmp_path / tag(d3) / "snaps"
        for run, steps in ((0, first), (1, 2)):
            solver, u, _ = heat(d3)
            h = solver.evaluator.add_file_handler(
                out, iter=1, max_writes=max_writes,
                **({"mode": "append"} if run else {}))
            h.add_task(u, name="u")
            for _ in range(steps):
                solver.step(1e-3)
    assert_same_files(tmp_path / "torch" / "snaps",
                      tmp_path / "jax" / "snaps", "snaps")
    files = sorted((tmp_path / "torch" / "snaps").glob("snaps_s*.h5"))
    assert len(files) == expect_sets
    with h5py.File(files[-1], "r") as f:
        assert list(np.asarray(f["scales/write_number"]))[-len(expect):] \
            == expect


@pytest.mark.parametrize("layout", ["c", "g"])
@pytest.mark.parametrize("writer", [jd3, td3], ids=["jax_writes",
                                                    "torch_writes"])
def test_checkpoint_cross_loads(tmp_path, writer, layout):
    """tests/test_output.py:71 across packages: a checkpoint written by
    either package after 5 SBDF1 steps loads through the other's
    load_state with the clocks and the state of the writer (bit for bit
    in coefficient layout), and 5 more steps land within 1e-12 of an
    uninterrupted run of the reader."""
    reader = td3 if writer is jd3 else jd3
    dt = 1e-3
    ref, _, _ = heat(reader, "SBDF1")
    for _ in range(10):
        ref.step(dt)
    w, _, _ = heat(writer, "SBDF1")
    h = w.evaluator.add_file_handler(tmp_path / "ckpt", iter=5)
    h.add_tasks(w.state, layout=layout)
    for _ in range(5):
        w.step(dt)
    r, _, _ = heat(reader, "SBDF1")
    files = sorted((tmp_path / "ckpt").glob("ckpt_s*.h5"))
    write, dt_loaded = r.load_state(files[-1])
    assert (r.iteration, dt_loaded, write) == (5, dt, 2)
    assert r.sim_time == w.sim_time
    if layout == "c":
        assert np.array_equal(state_of(r), state_of(w))
    else:
        assert np.abs(state_of(r) - state_of(w)).max() \
            <= 1e-13 * np.abs(state_of(w)).max()
    for _ in range(5):
        r.step(dt)
    assert np.abs(state_of(r) - state_of(ref)).max() \
        <= 1e-12 * np.abs(state_of(ref)).max()


def test_post_merge_and_sets(tmp_path):
    """tests/test_output.py:144: merge_sets concatenates the sets as the
    JAX package's does, and get_assigned_sets orders them alike."""
    from dedalus_tpu.tools import post as jpost
    from dedalus_tpu_torch.tools import post as tpost
    out = tmp_path / "snaps"
    solver, u, x = heat(td3)
    h = solver.evaluator.add_file_handler(out, iter=1, max_writes=2)
    h.add_task(u, name="u")
    for _ in range(5):
        solver.step(1e-3)
    assert tpost.get_assigned_sets(out) == jpost.get_assigned_sets(out)
    joint = tpost.merge_sets(out)
    jjoint = jpost.merge_sets(out, output=tmp_path / "jax_joint.h5")
    with h5py.File(joint, "r") as f, h5py.File(jjoint, "r") as g:
        assert f["tasks/u"].shape == (5, 16)
        assert list(np.asarray(f["scales/write_number"])) == [1, 2, 3, 4, 5]
        for key in ("tasks/u", "scales/sim_time", "scales/write_number"):
            assert np.array_equal(np.asarray(f[key]), np.asarray(g[key]))


def test_xarray_loader(tmp_path):
    """tools/post.load_tasks_to_xarray (xarray is optional)."""
    pytest.importorskip("xarray")
    from dedalus_tpu_torch.tools import post
    out = tmp_path / "snaps"
    solver, u, x = heat(td3)
    h = solver.evaluator.add_file_handler(out, iter=1, max_writes=2)
    h.add_task(u, name="u")
    for _ in range(5):
        solver.step(1e-3)
    arrays = post.load_tasks_to_xarray(post.merge_sets(out))
    assert arrays["u"].shape == (5, 16)
    assert list(arrays["u"].coords["write_number"].values) == [1, 2, 3, 4, 5]


def test_file_handler_without_h5py_raises(monkeypatch, tmp_path):
    """Without h5py, add_file_handler raises the ImportError naming it
    (no write is skipped in silence)."""
    import builtins
    real_import = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py" or name.startswith("h5py."):
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kw)
    solver, u, x = heat(td3)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        solver.evaluator.add_file_handler(tmp_path / "snaps", iter=1)
    assert solver.evaluator.handlers == []
