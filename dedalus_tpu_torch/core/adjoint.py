"""
DifferentiableIVP: gradients through the IVP step loop (counterpart of
dedalus_tpu/core/adjoint.py).

The loss of the final state after n constant-dt steps, and its gradients
with respect to the initial state and the RHS's non-variable field
operands (parameters, forcings), by torch autograd through the step
loop:

  * The loop is rebuilt from the timestepper's pure step bodies
    (`MultistepIMEX.advance_body`, `RungeKuttaIMEX.step_body`), the
    pieces `step` composes, so the forward pass gives the same bits as n
    calls of solver.step(dt) from a fresh history. The multistep startup
    ramp is replayed from `coefficient_schedule`.
  * Every pencil solve is a torch.autograd.Function
    (libraries/pencilops.AdjointSolveOps) whose backward pass is the
    transposed solve against the same factors: on the banded sequential
    path one transposed substitution kernel (csrc/banded_subst.cu,
    banded_subst_T) per substitution of the solve. The factors are built
    before the differentiated program and cached per leading
    coefficients (dt); they and M/L get no gradient.
  * Memory: K checkpointed segments (torch.utils.checkpoint,
    non-reentrant) of the stationary steps plus a plain remainder keep
    K segment boundaries and recompute inside a segment, so the saved
    activations are those of about n/K steps. K = None picks ceil(sqrt n);
    K = 1 keeps every step's activations. K does not change the numbers.
  * Loss and gradients go through one fused non-finite check
    (tools/health.check_values), the one host synchronization of a
    value_and_grad call; a non-finite value raises a SolverHealthError
    naming the adjoint phase.

Complex states: torch's gradient of a real loss of a complex input is
the conjugate of jax.grad's (the directional derivative along v is
Re sum(conj(g) * v)). The JAX package's compiled-program handle, its
telemetry flush and its retrace sentinel belong to its jit layer and
have no counterpart here.
"""

import time as time_mod

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .subsystems import scatter_state, state_key
from . import timesteppers as timesteppers_mod
from ..tools import health
from ..tools.array import torch_dtype

__all__ = ["DifferentiableIVP"]

# wrt tokens: "parameters" and "forcing" both select every non-variable
# field operand of the RHS; field names select one each
WRT_STATE = "initial_state"
WRT_EXTRA_GROUPS = ("parameters", "forcing")


class DifferentiableIVP:
    """
    Differentiable view of one built InitialValueSolver: value and
    gradients of `loss(XT)` over n constant-dt steps from the solver's
    current state (or given operands) and a fresh history.

    Parameters
    ----------
    solver : InitialValueSolver
        Built, undistributed, on the native step path.
    wrt : tuple of str
        "initial_state", the group tokens "parameters"/"forcing" (all
        RHS non-variable fields), and/or individual field names.
    loss : callable
        `loss(XT) -> 0-d tensor` over the final (G, S) pencil state, in
        torch; `state_arrays(XT)` splits XT into per-field coefficients.
    checkpoint_segments : int or None
        Checkpointed segments K over the stationary steps (None:
        ceil(sqrt n)); K = 1 keeps every step's activations.
    """

    def __init__(self, solver, wrt=(WRT_STATE,), loss=None,
                 checkpoint_segments=None):
        if loss is None or not callable(loss):
            raise ValueError(
                "DifferentiableIVP requires loss=fn with fn(XT) -> scalar "
                "(torch code over the final pencil state).")
        if getattr(solver, "_dd", None) is not None:
            raise ValueError(
                "DifferentiableIVP requires the native step path; the "
                "solver uses the emulated-f64 (double-double) runner. "
                "Build it with [execution] EMULATED_F64 = never.")
        if getattr(solver.dist, "mesh", None) is not None:
            raise ValueError(
                "DifferentiableIVP requires an undistributed solver (the "
                "distributed solves have no transpose yet).")
        ts = solver.timestepper
        self._multistep = isinstance(ts, timesteppers_mod.MultistepIMEX)
        if not self._multistep and not isinstance(
                ts, timesteppers_mod.RungeKuttaIMEX):
            raise ValueError(f"Unsupported timestepper {type(ts).__name__}")
        self.solver = solver
        self.timestepper = ts
        self.loss = loss
        if checkpoint_segments is not None:
            checkpoint_segments = int(checkpoint_segments)
            if checkpoint_segments < 1:
                raise ValueError("checkpoint_segments must be >= 1")
        self.checkpoint_segments = checkpoint_segments
        extra_fields = solver.eval_F.extra_fields
        self.extra_names = [state_key(f) for f in extra_fields]
        sel = set()
        self._wrt_state = False
        for token in tuple(wrt):
            if token == WRT_STATE:
                self._wrt_state = True
            elif token in WRT_EXTRA_GROUPS:
                if not extra_fields:
                    raise ValueError(
                        f"wrt={token!r} selects the RHS's non-variable "
                        "field operands, but this problem's F has none.")
                sel.update(range(len(extra_fields)))
            elif token in self.extra_names:
                sel.add(self.extra_names.index(token))
            else:
                raise ValueError(
                    f"unknown wrt operand {token!r}: expected "
                    f"'initial_state', 'parameters', 'forcing', or one of "
                    f"the RHS field names {self.extra_names}")
        self._wrt_idx = tuple(sorted(sel))
        if not self._wrt_state and not self._wrt_idx:
            raise ValueError("wrt selects no differentiable operand")
        self.wrt = ((WRT_STATE,) if self._wrt_state else ()) + tuple(
            self.extra_names[i] for i in self._wrt_idx)
        self._factor_cache = {}     # rounded lead coefficients -> aux
        self._last_segments = None
        self._grad_calls = self._grad_steps = self._fwd_steps = 0
        self._grad_wall = self._fwd_wall = self._factor_sec = 0.0

    # -------------------------------------------------------------- helpers

    def state_arrays(self, X):
        """Split a (G, S) pencil state into per-field coefficient tensors
        keyed by field name (differentiable: usable inside a loss)."""
        return scatter_state(self.solver.layout, self.solver.variables, X)

    def _segments(self, n_scan):
        K = self.checkpoint_segments
        if K is None:
            K = int(np.ceil(np.sqrt(max(n_scan, 1))))
        return max(1, min(int(K), max(n_scan, 1)))

    def _scan_checkpointed(self, one, state, n_scan, dt):
        """n_scan applications of `one` ((t, tensors) -> (t, tensors)):
        K segments of n_scan // K steps, each checkpointed when K > 1 (the
        backward pass keeps the segment's input and recomputes the rest),
        then the remainder as plain steps."""
        if n_scan <= 0:
            return state
        K = self._segments(n_scan)
        self._last_segments = K
        L = n_scan // K

        def segment(t0):
            def run(*tensors):
                t, tensors = t0, tensors
                for _ in range(L):
                    t, tensors = one(t, tensors)
                return tensors
            return run

        for _ in range(K if L else 0):
            t, tensors = state
            if K > 1:
                tensors = checkpoint(segment(t), *tensors,
                                     use_reentrant=False)
                for _ in range(L):
                    t = t + dt
                state = (t, tuple(tensors))
            else:
                for _ in range(L):
                    state = one(*state)
        for _ in range(n_scan - K * L):
            state = one(*state)
        return state

    # ----------------------------------------------------- factorizations

    def _factor(self, key, build):
        """The factor of a key: the timestepper's own where it holds the
        same coefficients (the same factorization, so no second factor
        store), else built once and cached."""
        ts = self.timestepper
        if key == ts._lhs_key and ts._lhs_aux is not None:
            return ts._lhs_aux
        aux = self._factor_cache.get(key)
        if aux is None:
            t0 = time_mod.perf_counter()
            aux = self._factor_cache[key] = build()
            self._factor_sec += time_mod.perf_counter() - t0
        return aux

    def _factors_multistep(self, dt, n):
        """(ramp [(a, b, c)], ramp auxes, stationary (a, b, c), its aux)
        for n constant-dt steps; each aux factored once per leading
        coefficient pair (the timestepper's own key) and cached."""
        ts, solver = self.timestepper, self.solver
        ramp, stat = ts.coefficient_schedule(dt, n)

        def aux_for(a, b):
            key = (round(float(a[0]), 14), round(float(b[0]), 14))
            return self._factor(key, lambda: solver.factor_checked(
                lambda: solver.ops.factor_lincomb(
                    float(a[0]), solver.M_mat, float(b[0]), solver.L_mat),
                {"M": float(a[0]), "L": float(b[0])}))

        return (ramp, [aux_for(a, b) for a, b, _ in ramp], stat,
                aux_for(*stat[:2]))

    def _factors_rk(self, dt):
        """The stage factors at dt, as the timestepper's `_factor` builds
        them (one per distinct implicit diagonal), cached per dt."""
        ts, solver = self.timestepper, self.solver

        def build():
            auxs = [solver.factor_checked(
                lambda: solver.ops.factor_lincomb(1.0, solver.M_mat, dt * h,
                                                  solver.L_mat),
                {"M": 1.0, "L": dt * h}) for h in ts.uniq_H_diag]
            return [auxs[j] for j in ts.stage_slot]

        return self._factor(round(float(dt), 14), build)

    # ---------------------------------------------------------- the program

    def _run(self, n, dt, X0, extras):
        """The loss and the final state of n steps of dt from X0 at the
        solver's sim_time with a fresh history."""
        ts = self.timestepper
        t0 = float(self.solver.sim_time)
        if self._multistep:
            s = ts.steps
            ramp, ramp_auxs, abc, aux = self._factors_multistep(dt, n)
            zeros = [torch.zeros_like(X0, requires_grad=False)
                     for _ in range(3 * s)]

            def stepper(abc, aux):
                def one(t, tensors):
                    hists = (list(tensors[1:1 + s]),
                             list(tensors[1 + s:1 + 2 * s]),
                             list(tensors[1 + 2 * s:]))
                    X, shifted = ts.advance_body(tensors[0], t, extras,
                                                 hists, abc, aux)
                    return t + dt, (X, *(h for hist in shifted
                                         for h in hist))
                return one

            state = (t0, (X0, *zeros))
            for abc_r, aux_r in zip(ramp, ramp_auxs):
                state = stepper(abc_r, aux_r)(*state)
            state = self._scan_checkpointed(stepper(abc, aux), state,
                                            n - len(ramp), dt)
        else:
            auxs = self._factors_rk(dt)

            def one(t, tensors):
                return t + dt, (ts.step_body(tensors[0], t, dt, extras,
                                             auxs),)

            state = self._scan_checkpointed(one, (t0, (X0,)), n, dt)
        XT = state[1][0]
        return self.loss(XT), XT

    def _operands(self, initial_state, fields):
        """(X0, extras): the initial state and the RHS's extra field
        coefficients (the solver's own, or the overrides), each operand
        in `wrt` a fresh leaf that requires a gradient."""
        solver = self.solver
        device = solver.dist.device
        dtype = torch_dtype(solver.pencil_dtype)
        if initial_state is not None:
            X0 = torch.as_tensor(initial_state).to(device=device, dtype=dtype)
        else:
            X0 = solver.gather_fields() if solver.fields_dirty() \
                else solver.X
        extras = list(solver.rhs_extra())
        for name, arr in (fields or {}).items():
            if name not in self.extra_names:
                raise ValueError(
                    f"field override {name!r} is not an RHS operand of "
                    f"this problem ({self.extra_names})")
            i = self.extra_names.index(name)
            extras[i] = torch.as_tensor(arr).to(device=device,
                                                dtype=extras[i].dtype)
        X0 = X0.detach().requires_grad_(self._wrt_state)
        extras = [e.detach().requires_grad_(i in self._wrt_idx)
                  for i, e in enumerate(extras)]
        return X0, extras

    # -------------------------------------------------------------- public

    def forward(self, n_steps, dt, initial_state=None, fields=None):
        """The forward pass: (loss as a float, final pencil state), the
        same bits as n solver.step(dt) calls from a fresh history (the
        grad/forward cost ratio's denominator)."""
        n = int(n_steps)
        if n < 1:
            raise ValueError("n_steps must be >= 1")
        X0, extras = self._operands(initial_state, fields)
        with torch.no_grad():
            self._factors(n, dt)
            t0 = time_mod.perf_counter()
            val, XT = self._run(n, float(dt), X0, extras)
            val = float(val)
        self._fwd_wall += time_mod.perf_counter() - t0
        self._fwd_steps += n
        return val, XT

    def value(self, n_steps, dt, initial_state=None, fields=None):
        """The loss of the forward pass (finite-difference probes, line
        searches)."""
        return self.forward(n_steps, dt, initial_state=initial_state,
                            fields=fields)[0]

    def _factors(self, n, dt):
        """Build (or find) every factor of an n-step run before the
        program, so no factorization runs inside it."""
        if self._multistep:
            self._factors_multistep(float(dt), n)
        else:
            self._factors_rk(float(dt))

    def value_and_grad(self, n_steps, dt, initial_state=None, fields=None,
                       check_health=True):
        """
        Loss and gradients of n constant-dt steps from the solver's
        current state (or the operand overrides): `(loss, grads)` with
        grads keyed by operand name ("initial_state" and/or RHS field
        names). With `check_health`, a non-finite loss or gradient raises
        a SolverHealthError naming the adjoint phase; the check is the
        call's one host synchronization (it also brings the loss back).
        """
        n = int(n_steps)
        if n < 1:
            raise ValueError("n_steps must be >= 1")
        X0, extras = self._operands(initial_state, fields)
        with torch.no_grad():
            self._factors(n, dt)
        inputs = ([X0] if self._wrt_state else []) + \
            [extras[i] for i in self._wrt_idx]
        t0 = time_mod.perf_counter()
        with torch.enable_grad():
            val, _ = self._run(n, float(dt), X0, extras)
            grads = torch.autograd.grad(val, inputs)
        out = dict(zip(self.wrt, grads))
        if check_health:
            val = health.check_values(
                (val, grads), phase="adjoint", solver=self.solver,
                scalar=val.detach(),
                context=f"backward pass over {n} steps, "
                        f"wrt={list(self.wrt)}, dt={float(dt):.3e}")
        else:
            val = float(val.detach())
        self._grad_wall += time_mod.perf_counter() - t0
        self._grad_steps += n
        self._grad_calls += 1
        return val, out

    def summary(self):
        """The adjoint record: calls, steps per second of the gradient and
        forward passes (their ratio is the grad/forward cost ratio, JAX's
        theory 2-4x), factor seconds, the checkpoint segments of the last
        run, and the device's peak memory (torch.cuda.max_memory_allocated
        on a CUDA solver, None on the CPU)."""
        grad_sps = self._grad_steps / self._grad_wall \
            if self._grad_wall > 0 else None
        fwd_sps = self._fwd_steps / self._fwd_wall \
            if self._fwd_wall > 0 else None
        device = self.solver.dist.device
        return {
            "wrt": list(self.wrt),
            "checkpoint_segments": self._last_segments,
            "grad_calls": self._grad_calls,
            "grad_steps": self._grad_steps,
            "grad_steps_per_sec": grad_sps,
            "forward_steps_per_sec": fwd_sps,
            "grad_forward_ratio": fwd_sps / grad_sps
            if grad_sps and fwd_sps else None,
            "factor_sec": self._factor_sec,
            "device_mem_peak_bytes": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None,
        }
