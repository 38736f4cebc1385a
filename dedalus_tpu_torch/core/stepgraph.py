"""
One step recorded as a CUDA graph and replayed: the port's counterpart of
the JAX package's blocked `step_many`, which runs a block of steps as one
device dispatch, a `lax.scan` over the jitted step
(dedalus_tpu/core/timesteppers.py:217 `_advance_n`, :645 `_step_n`).

A timestepper's `_advance_in_place(X, t, dt)` is the body of one step at
stationary coefficients: it reads the state X (G, S) and the time t,
returns the new state, and writes whatever else it carries (the
multistep histories) in place. `StepGraph` records that body once, on a side stream, against
static buffers for X and t (t a 0-d float64 tensor), followed by the
copy of the new state into the X buffer and t += dt, so that each replay
is one step and the next replay starts from its output. A block of n
steps is one copy in, n replays and one copy out: the host launches n
graphs instead of every kernel of n steps.

What the recorded kernels read by address (the factor, M and L, the
parameter fields' data) is held by the graph and compared by identity
before each block (`matches`): a refactor, new matrices or a parameter
field given new data need a new recording. Launches of the substitution
kernel recorded in the graph (fusedstep.RECORDED during the capture) are
added to fusedstep.LAUNCHES once per replay, so a launch count read
around a block equals the count of the same steps taken one by one.
"""

import gc

import torch

from . import fusedstep


class StepGraph:
    """`advance` recorded once on `stream` and replayed per step. `key`
    (the baked scalars: dt or the multistep coefficients) and `inputs`
    (the tensors the body reads by address) identify the recording."""

    def __init__(self, advance, X, dt, stream, key, inputs):
        self.key = key
        self.inputs = tuple(inputs)
        self.X = X.clone()
        self.t = torch.zeros((), dtype=torch.float64, device=X.device)
        self.graph = torch.cuda.CUDAGraph()
        before = dict(fusedstep.RECORDED)
        stream.wait_stream(torch.cuda.current_stream(X.device))
        # a CUDA graph destroyed while a stream captures (a dead solver's,
        # freed by the cycle collector) invalidates the capture: collect
        # before it, and not during it
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.X.copy_(advance(self.X, self.t))
                self.t.add_(float(dt))
        finally:
            if enabled:
                gc.enable()
        self.launches = {name: fusedstep.RECORDED[name] - before[name]
                         for name in before}

    def matches(self, key, inputs):
        """Whether this recording steps with `key` reading `inputs`."""
        inputs = tuple(inputs)
        return key == self.key and len(inputs) == len(self.inputs) and \
            all(a is b for a, b in zip(inputs, self.inputs))

    def replay(self, X, t, n):
        """n steps from state X at time t (a float): returns the new
        state, a tensor of its own."""
        self.X.copy_(X)
        self.t.fill_(float(t))
        for _ in range(n):
            self.graph.replay()
        for name, count in self.launches.items():
            fusedstep.LAUNCHES[name] += n * count
        return self.X.clone()
