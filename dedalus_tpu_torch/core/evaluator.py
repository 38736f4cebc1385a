"""
Evaluator and output handlers (counterpart of dedalus_tpu/core/evaluator.py:
Evaluator, Handler and DictionaryHandler).

Handlers own lists of tasks (symbolic expressions) evaluated on wall-time /
sim-time / iteration cadences (reference: core/evaluator.py:248-278
check_schedule). A handler's tasks are evaluated eagerly on the solver's
device in one pass with a shared memo, so shared subexpressions and their
transforms run once; the results come back to the host as numpy arrays.
"""

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
        raise NotImplementedError(
            "FileHandler (HDF5 output) is not in dedalus_tpu_torch yet: it "
            "comes with the output slice, ROADMAP queue 1 slice 9 "
            "(FileHandler and tools/post.py, on h5py)")

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
