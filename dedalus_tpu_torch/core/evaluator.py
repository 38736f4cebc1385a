"""
Evaluator and output handlers (counterpart of dedalus_tpu/core/evaluator.py:
Evaluator, Handler, DictionaryHandler and FileHandler).

Handlers own lists of tasks (symbolic expressions) evaluated on wall-time /
sim-time / iteration cadences (reference: core/evaluator.py:248-278
check_schedule). A handler's tasks are evaluated eagerly on the solver's
device in one pass with a shared memo, so shared subexpressions and their
transforms run once; the results come back to the host as numpy arrays.

FileHandler writes HDF5 with the JAX package's schema (tasks/<name>,
scales/sim_time|wall_time|iteration|write_number|timestep, one file per
set, grid scales attached as HDF5 dimension scales), so the two packages
read each other's output and checkpoints. It needs h5py: without it,
`add_file_handler` raises the ImportError.
"""

import hashlib
import os
import pathlib

import numpy as np

from .field import Field, transform_to_grid
from .future import EvalContext


class Evaluator:
    """Coordinates scheduled evaluation of handler tasks
    (reference: core/evaluator.py:30 Evaluator)."""

    def __init__(self, solver):
        self.solver = solver
        self.handlers = []

    def add_dictionary_handler(self, **kw):
        handler = DictionaryHandler(self.solver, **kw)
        self.handlers.append(handler)
        return handler

    def add_file_handler(self, base_path, **kw):
        handler = FileHandler(self.solver, base_path, **kw)
        self.handlers.append(handler)
        return handler

    def evaluate_scheduled(self, iteration=0, wall_time=0.0, sim_time=0.0,
                           timestep=None):
        due = [h for h in self.handlers
               if h.check_schedule(iteration=iteration, wall_time=wall_time,
                                   sim_time=sim_time)]
        self.evaluate_handlers(due, iteration=iteration, wall_time=wall_time,
                               sim_time=sim_time, timestep=timestep)

    def evaluate_handlers(self, handlers=None, iteration=0, wall_time=0.0,
                          sim_time=0.0, timestep=None):
        if handlers is None:
            handlers = self.handlers
        for handler in handlers:
            handler.process(iteration=iteration, wall_time=wall_time,
                            sim_time=sim_time, timestep=timestep)


class Handler:
    """Task list with a schedule (reference: core/evaluator.py:209 Handler)."""

    def __init__(self, solver, group=None, wall_dt=None, sim_dt=None,
                 iter=None, custom_schedule=None):
        self.solver = solver
        self.tasks = []
        self.group = group
        self.wall_dt = wall_dt
        self.sim_dt = sim_dt
        self.iter = iter
        self.custom_schedule = custom_schedule
        self.last_wall_div = -1
        self.last_sim_div = -1
        self.last_iter_div = -1
        # optional transient-IO retry policy (tools/resilience.RetryPolicy)
        # around file writes; None writes directly
        self.io_retry = None

    def schedule_state(self):
        """The scheduling counters as a restorable dict (captured into
        resilience snapshots, so a rewound run re-arms its output cadences
        with the rewound clock; dedalus_tpu/core/evaluator.py:81)."""
        return {"last_wall_div": self.last_wall_div,
                "last_sim_div": self.last_sim_div,
                "last_iter_div": self.last_iter_div}

    def restore_schedule_state(self, state):
        self.last_wall_div = state["last_wall_div"]
        self.last_sim_div = state["last_sim_div"]
        self.last_iter_div = state["last_iter_div"]

    def add_task(self, task, layout="g", name=None, scales=None):
        """Add a task (operand expression, field, or namespace string)."""
        if isinstance(task, str):
            namespace = self.solver.problem.namespace
            name = name or task
            task = eval(task, {}, namespace)
        if name is None:
            name = getattr(task, "name", None) or str(task)
        self.tasks.append({"operator": task, "layout": layout, "name": name,
                           "scales": scales})

    def add_tasks(self, tasks, **kw):
        for task in tasks:
            self.add_task(task, **kw)

    def check_schedule(self, iteration=0, wall_time=0.0, sim_time=0.0):
        """Divisor-crossing cadence logic (reference: core/evaluator.py:248)."""
        scheduled = False
        if self.wall_dt is not None:
            div = int(wall_time // self.wall_dt)
            if div > self.last_wall_div:
                scheduled = True
                self.last_wall_div = div
        if self.sim_dt is not None:
            div = int((sim_time + 1e-12) // self.sim_dt)
            if div > self.last_sim_div:
                scheduled = True
                self.last_sim_div = div
        if self.iter is not None:
            div = iteration // self.iter
            if div > self.last_iter_div:
                scheduled = True
                self.last_iter_div = div
        if self.custom_schedule is not None:
            scheduled = scheduled or self.custom_schedule(
                iteration=iteration, wall_time=wall_time, sim_time=sim_time)
        return scheduled

    def evaluate_tasks(self):
        """Evaluate all tasks in one pass, returning {name: numpy array}."""
        dist = self.solver.dist
        ctx = EvalContext()
        out = {}
        for task in self.tasks:
            op = task["operator"]
            if isinstance(op, Field):
                data = ctx.field_data(op, "c")
            else:
                data = op.ev(ctx, "c")
            if task["layout"] == "g":
                scales = dist.remedy_scales(task["scales"] or 1)
                data = transform_to_grid(data, op.domain, scales,
                                         len(op.tensorsig),
                                         tensorsig=op.tensorsig)
            out[task["name"]] = data
        return {name: np.asarray(data.cpu()) for name, data in out.items()}

    def process(self, **kw):
        raise NotImplementedError


class DictionaryHandler(Handler):
    """Stores task results in a dict (reference: core/evaluator.py:325)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.fields = {}

    def __getitem__(self, name):
        return self.fields[name]

    def process(self, **kw):
        self.fields.update(self.evaluate_tasks())


class FileHandler(Handler):
    """HDF5 output handler (reference: core/evaluator.py:369 H5FileHandler;
    dedalus_tpu/core/evaluator.py:239): sets of at most `max_writes`
    writes, one file `<name>_s<set>.h5` each under `base_path`; mode
    'append' continues the set and write numbering of the files already
    there (and fills the last set if it has room), 'overwrite' starts
    afresh. Needs h5py."""

    def __init__(self, solver, base_path, max_writes=np.inf, mode=None, **kw):
        import h5py  # noqa: F401  (HDF5 output needs it: raise here)
        super().__init__(solver, **kw)
        from ..tools.config import config
        self.base_path = pathlib.Path(base_path)
        self.max_writes = max_writes
        self.mode = mode or config["analysis"].get("FILEHANDLER_MODE_DEFAULT",
                                                   "overwrite")
        self.set_num = 0
        self.write_num = 0
        self.current_file = None
        self.writes_in_set = 0
        os.makedirs(self.base_path, exist_ok=True)
        if self.mode == "append":
            self._scan_existing_sets()

    def _scan_existing_sets(self):
        import h5py
        from ..tools.post import get_assigned_sets
        existing = get_assigned_sets(self.base_path)
        if not existing:
            return
        self.set_num = int(existing[-1].stem.rsplit("_s", 1)[1])
        # scan back past empty or partial sets (a crashed run) so
        # write_number stays globally unique
        for path in reversed(existing):
            with h5py.File(path, "r") as f:
                if "scales/write_number" in f \
                        and len(f["scales/write_number"]):
                    self.write_num = int(
                        np.asarray(f["scales/write_number"])[-1])
                    break
        # resume the last set if it still has room
        with h5py.File(existing[-1], "r") as f:
            writes = (len(f["scales/write_number"])
                      if "scales/write_number" in f else 0)
        if writes < self.max_writes:
            self.current_file = str(existing[-1])
            self.writes_in_set = writes

    def _new_file(self):
        import h5py
        self.set_num += 1
        self.writes_in_set = 0
        path = self.base_path / f"{self.base_path.name}_s{self.set_num}.h5"
        self.current_file = str(path)
        with h5py.File(path, "w") as f:
            f.create_group("tasks")
            f.create_group("scales")
        return path

    def process(self, iteration=0, wall_time=0.0, sim_time=0.0, timestep=None,
                **kw):
        if self.current_file is None or self.writes_in_set >= self.max_writes:
            self._new_file()
        self.write_num += 1
        self.writes_in_set += 1
        results = self.evaluate_tasks()

        def write():
            self._write_results(results, iteration=iteration,
                                wall_time=wall_time, sim_time=sim_time,
                                timestep=timestep)

        if self.io_retry is not None:
            # transient host/IO faults retried with backoff
            # (tools/resilience.py)
            self.io_retry.call(write, label=f"write {self.current_file}")
        else:
            write()

    def _write_results(self, results, iteration, wall_time, sim_time,
                       timestep):
        import h5py
        with h5py.File(self.current_file, "a") as f:
            scales = f["scales"]
            for key, val in [("sim_time", sim_time), ("wall_time", wall_time),
                             ("iteration", iteration),
                             ("write_number", self.write_num),
                             ("timestep", timestep if timestep is not None
                              else np.nan)]:
                if key not in scales:
                    scales.create_dataset(key, shape=(0,), maxshape=(None,),
                                          dtype=np.float64)
                ds = scales[key]
                ds.resize((ds.shape[0] + 1,))
                ds[-1] = val
            tasks = f["tasks"]
            for name, data in results.items():
                if name not in tasks:
                    tasks.create_dataset(name, shape=(0,) + data.shape,
                                         maxshape=(None,) + data.shape,
                                         dtype=data.dtype)
                    task = next((t for t in self.tasks
                                 if t["name"] == name), None)
                    # load_state restores through the layout the data was
                    # written in ('c' round-trips bit for bit)
                    tasks[name].attrs["layout"] = \
                        task["layout"] if task else "g"
                    self._attach_grid_scales(f, tasks[name], name)
                ds = tasks[name]
                ds.resize((ds.shape[0] + 1,) + data.shape)
                ds[-1] = data

    def _attach_grid_scales(self, f, ds, name):
        """Store the task's grid arrays once and attach them as HDF5
        dimension scales (reference: core/evaluator.py:656-728), so
        post-processing recovers coordinates from the file alone."""
        task = next((t for t in self.tasks if t["name"] == name), None)
        if task is None or task["layout"] != "g":
            return
        op = task["operator"]
        scales = self.solver.dist.remedy_scales(task["scales"] or 1)
        tdim = len(op.tensorsig)
        grp = f["scales"]
        dim = 0
        ds.dims[dim].label = "write"
        dim += 1
        for _ in range(tdim):
            ds.dims[dim].label = "component"
            dim += 1
        grids = []
        for axis, basis in enumerate(op.domain.bases):
            if basis is None:
                grids.append((f"const_{axis}", np.zeros(1)))
            elif basis.dim == 1:
                grids.append((basis.coord.name,
                              basis.global_grid(scales[axis])))
            elif axis == basis.first_axis:
                gs = basis.global_grids(
                    tuple(scales[basis.first_axis + i]
                          for i in range(basis.dim)))
                for i, g in enumerate(gs):
                    grids.append((basis.cs.names[i], np.ravel(g)))
        for gname, grid in grids:
            flat = np.ravel(np.asarray(grid))
            key = f"{gname}_{hashlib.sha1(flat.tobytes()).hexdigest()[:12]}"
            if key not in grp:
                grp.create_dataset(key, data=flat)
                grp[key].make_scale(gname)
            ds.dims[dim].attach_scale(grp[key])
            ds.dims[dim].label = gname
            dim += 1
