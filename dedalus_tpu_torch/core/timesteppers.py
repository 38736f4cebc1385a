"""
IMEX timesteppers (counterpart of dedalus_tpu/core/timesteppers.py:
MultistepIMEX and RungeKuttaIMEX with their schemes).

Schemes integrate M.dt(X) + L.X = F with implicit L and explicit F.

Multistep form (reference: core/timesteppers.py:22 MultistepIMEX):
    sum_j a_j M.X(n-j) + sum_j b_j L.X(n-j) = sum_{j>=1} c_j F(n-j)
with variable-timestep coefficients. The SBDF family generates its
coefficients from Lagrange derivative/extrapolation weights (equivalent to
the reference's closed forms from Wang & Ruuth 2008, JCM 26).

IMEX Runge-Kutta form (reference: core/timesteppers.py:486 RungeKuttaIMEX,
tableaux from Ascher, Ruuth & Spiteri 1997):
    M.X(i) - M.X(0) = dt * sum_j [ A[i,j] F(j) - H[i,j] L.X(j) ]

Each step runs eagerly on the solver's device: M/L matvecs, the RHS
evaluation (transforms + grid products), and the pencil solves of the
solver's ops (dense or banded). The LHS factorization (a0*M + b0*L, or
M + dt*H[i,i]*L) is recomputed only when its coefficients change
(reference: core/timesteppers.py:123-128,160-168); `factorizations`
counts them.

Each family also has a pure step body that takes its histories and the
RHS's extra field operands explicitly and neither reads nor writes the
timestepper's state (`MultistepIMEX.advance_body`,
`RungeKuttaIMEX.step_body`; the JAX package's names): the differentiable
path (core/adjoint.py) steps through them, and `_advance` composes the
same pieces, so the two give the same bits.

`step_many(n, dt)` is the JAX package's blocked step
(dedalus_tpu/core/timesteppers.py:345 and :723): the multistep ramp and
any dt change run as single steps until the coefficients are stationary,
then the remaining steps run the same step body `_advance` at those
coefficients. On a CUDA solver that body is recorded once as a CUDA
graph and replayed per step (core/stepgraph.py); on the CPU it is a loop.

`capture_state()` / `restore_state(state)` carry what a resilience
snapshot or a checkpoint needs besides the solver's X and clocks: the
iteration count and, for a multistep scheme, the F, M.X and L.X
histories (device copies, stacked (s, G, S) as the JAX package keeps
them) and the dt history (tools/resilience.py capture_snapshot).
`phase_probes()` gives the metrics sampler its measurement thunks
(dedalus_tpu/core/timesteppers.py:387 and :740).
"""

import numpy as np
import torch

from .stepgraph import StepGraph, on_stream

schemes = {}


def add_scheme(cls):
    schemes[cls.__name__] = cls
    return cls


def _valid_row_mask(solver):
    return torch.as_tensor(solver.valid_row_mask,
                           device=solver.dist.device).to(solver.X.dtype)


def _lagrange_derivative_weights(nodes):
    """Weights w: sum_j w_j p(nodes_j) = p'(0) for all deg < len(nodes)."""
    n = len(nodes)
    V = np.vander(np.asarray(nodes, dtype=float), n, increasing=True).T
    d = np.zeros(n)
    if n > 1:
        d[1] = 1.0
    return np.linalg.solve(V, d)


def _lagrange_extrapolation_weights(nodes):
    """Weights e: sum_j e_j p(nodes_j) = p(0)."""
    n = len(nodes)
    V = np.vander(np.asarray(nodes, dtype=float), n, increasing=True).T
    d = np.zeros(n)
    d[0] = 1.0
    return np.linalg.solve(V, d)


def _past_times(dt_hist, s):
    """[0, -k0, -(k0+k1), ...] for s+1 time levels."""
    times = [0.0]
    acc = 0.0
    for j in range(s):
        acc += dt_hist[j]
        times.append(-acc)
    return times


def _combine(coeffs, tensors, out=None, sign=1.0):
    """out + sign * sum_j coeffs[j] * tensors[j], skipping zero
    coefficients (histories not yet filled are zero-coefficient)."""
    for coeff, tensor in zip(coeffs, tensors):
        coeff = sign * float(coeff)
        if coeff == 0.0:
            continue
        out = coeff * tensor if out is None else out + coeff * tensor
    return out


class BlockStepper:
    """The blocked steps shared by both families: `_run_block(n, dt)`
    advances the solver's state n steps with `_advance(X, t, dt)` at the
    coefficients the caller has set; `_graph_key(dt)` gives the scalars a
    recording bakes in. On a CUDA solver the step is
    recorded as a StepGraph after one uncaptured step (which warms the
    kernel library, the cuFFT plans and the cuBLAS workspace on the
    capture stream), kept while its scalars and inputs match, and
    replayed; `recordings` counts the recordings. A failed capture
    raises. A recording runs `_advance_in_place`, which writes whatever
    the step carries besides X into fixed buffers, and `_adopt_buffers`
    puts that state into those buffers before a recorded step runs."""

    _graph = None
    _stream = None
    _probe_cache = None
    recordings = 0

    def drop_factor(self):
        """Forget the factorization and the step recording: the next step
        factors the solver's current M, L and ops."""
        self._lhs_key = self._lhs_aux = None
        self._graph = None
        self._probe_cache = None

    def capture_state(self):
        """The timestepper state a snapshot or checkpoint carries: the
        iteration count (a one-step scheme has no other)."""
        return {"iteration": int(self.iteration)}

    def restore_state(self, state):
        """Put a captured state back and drop the factorization (the next
        step refactors for its own dt)."""
        self.iteration = int(state["iteration"])
        self.drop_factor()

    def _advance_in_place(self, X, t, dt):
        return self._advance(X, t, dt)

    def _adopt_buffers(self, record):
        """Nothing besides X to carry (a one-step scheme)."""

    def _graph_inputs(self):
        """The tensors a recorded step reads by address besides its own
        buffers: the factor, M, L and the parameter fields' data (put in
        coefficient space here, outside any capture)."""
        solver = self.solver
        aux = self._lhs_aux
        return (*(aux if isinstance(aux, list) else [aux]), solver.M_mat,
                solver.L_mat,
                *(f.coeff_data() for f in solver.eval_F.extra_fields))

    def _run_block(self, n, dt):
        """n steps from the solver's state; sim_time advances by n
        additions of dt, as in n single steps (the recorded step adds dt
        to its device time the same way)."""
        solver = self.solver
        dt = float(dt)
        X, t = solver.X, float(solver.sim_time)
        for _ in range(n):
            solver.sim_time = float(solver.sim_time) + dt
        if solver.dist.device.type != "cuda":
            for _ in range(n):
                X = self._advance(X, t, dt)
                t = t + dt
            solver.X = X
            return
        key, inputs = self._graph_key(dt), self._graph_inputs()
        graph = self._graph
        if graph is None or not graph.matches(key, inputs):
            self._graph = graph = None
            if self._stream is None:
                self._stream = torch.cuda.Stream(solver.dist.device)
            self._adopt_buffers(record=True)
            X = on_stream(self._stream, solver.dist.device,
                          lambda: self._advance_in_place(X, t, dt))
            t = t + dt
            n -= 1
            if n:
                graph = self._graph = StepGraph(
                    lambda X, t: self._advance_in_place(X, t, dt), X, dt,
                    self._stream, key, inputs)
                self.recordings += 1
        if n:
            self._adopt_buffers(record=False)
            X = graph.replay(X, t, n)
        solver.X = X


class MultistepIMEX(BlockStepper):
    """Base multistep IMEX integrator (reference: core/timesteppers.py:22).

    The F, M.X and L.X histories are lists of s (G, S) tensors, newest
    first; a step puts a new head on each list and drops the tail, so no
    two histories share a buffer. A recorded step reads them at fixed
    addresses, so it writes the new head into the lists' buffers in
    place instead (the others move down one)."""

    _buffers = None     # the histories' tensors a recorded step writes

    steps = None
    stages = 1

    def __init__(self, solver):
        self.solver = solver
        G, S = solver.pencil_shape
        zeros = lambda: [torch.zeros((G, S), dtype=solver.X.dtype,  # noqa: E731
                                     device=solver.dist.device)
                         for _ in range(self.steps)]
        self.F_hist = zeros()
        self.MX_hist = zeros()
        self.LX_hist = zeros()
        self.dt_hist = []
        self._lhs_key = None
        self._lhs_aux = None
        self.iteration = 0
        self.factorizations = 0
        self._mask = _valid_row_mask(solver)

    def compute_coefficients(self, dt_hist, order):
        """Return (a[0..order], b[0..order], c[1..order])."""
        raise NotImplementedError

    def _pad_coeffs(self, a, b, c):
        """Pad (a, b, c) to the stationary lengths (s+1, s+1, s)."""
        s = self.steps
        a = np.concatenate([a, np.zeros(s + 1 - len(a))])
        b = np.concatenate([b, np.zeros(s + 1 - len(b))])
        c = np.concatenate([c, np.zeros(s - len(c))])
        return a, b, c

    def coefficient_schedule(self, dt, n):
        """The padded (a, b, c) of n constant-dt steps from a fresh history
        (dedalus_tpu/core/timesteppers.py:271): the startup ramp's triples
        (orders 1 .. min(s-1, n), one per step) and the stationary triple
        of every later step, as n calls of step(dt) would set them."""
        s = self.steps
        dt = float(dt)
        ramp = [self._pad_coeffs(*self.compute_coefficients([dt] * it, it))
                for it in range(1, min(s - 1, int(n)) + 1)]
        return ramp, self._pad_coeffs(*self.compute_coefficients([dt] * s,
                                                                 s))

    def _prepare(self, dt):
        """Push dt into the history, count the step, and set its padded
        coefficients, refactoring when the leading ones change."""
        s = self.steps
        self.dt_hist = [float(dt)] + self.dt_hist[:s - 1]
        self.iteration += 1
        self._set_coefficients(min(s, self.iteration))

    def _set_coefficients(self, order):
        solver = self.solver
        a, b, c = self._pad_coeffs(
            *self.compute_coefficients(self.dt_hist, order))
        # refactor on the leading coefficients (the JAX package's key)
        key = (round(float(a[0]), 14), round(float(b[0]), 14))
        if key != self._lhs_key:
            self._lhs_key, self._lhs_aux = key, self._factor(a[0], b[0])
        self._abc = (a, b, c)

    def _factor(self, a0, b0):
        """The factored LHS a0 M + b0 L (counted in `factorizations`)."""
        solver = self.solver
        a0, b0 = float(a0), float(b0)
        aux = solver.factor_checked(
            lambda: solver.ops.factor_lincomb(a0, solver.M_mat, b0,
                                              solver.L_mat),
            {"M": a0, "L": b0})
        self.factorizations += 1
        return aux

    def _update(self, X, t, extras, hists, abc):
        """The new heads (F, MX, LX) of state X at time t, the histories
        shifted onto them, and the step's right-hand side."""
        solver = self.solver
        a, b, c = abc
        Fn = solver.eval_F(X, t, extras) * self._mask
        MXn, LXn = solver.ops.matvec_pair(solver.M_mat, solver.L_mat, X)
        news = (Fn, MXn, LXn)
        F, MX, LX = ([new] + hist[:-1] for new, hist in zip(news, hists))
        RHS = _combine(c, F)
        RHS = _combine(a[1:], MX, RHS, sign=-1.0)
        RHS = _combine(b[1:], LX, RHS, sign=-1.0)
        return news, (F, MX, LX), RHS

    def advance_body(self, X, t, extras, hists, abc, lhs_aux):
        """One step as a pure function (dedalus_tpu/core/timesteppers.py:
        210): state X at time t, the RHS's extra field operands (None
        reads the fields), the histories (F, MX, LX) as lists newest
        first, the padded (a, b, c) and the factored LHS. Returns (the
        new state, the shifted histories); the timestepper's own state
        is not touched."""
        solver = self.solver
        _, shifted, RHS = self._update(X, t, extras, hists, abc)
        return solver.ops.solve(lhs_aux, RHS,
                                mats=(solver.M_mat, solver.L_mat)), shifted

    def _advance(self, X, t, dt, in_place=False):
        """One step from state X at time t with the coefficients set
        (they carry dt): returns the new state. The histories take their
        new heads by rebinding the lists, or with `in_place` by copies
        into their buffers."""
        solver = self.solver
        hists = (self.F_hist, self.MX_hist, self.LX_hist)
        (Fn, MXn, LXn), (F, MX, LX), RHS = self._update(X, t, None, hists,
                                                        self._abc)
        if in_place:
            for new, hist in zip((Fn, MXn, LXn), hists):
                for j in range(len(hist) - 1, 0, -1):
                    hist[j].copy_(hist[j - 1])
                hist[0].copy_(new)
        else:
            self.F_hist, self.MX_hist, self.LX_hist = F, MX, LX
        return solver.ops.solve(self._lhs_aux, RHS,
                                mats=(solver.M_mat, solver.L_mat))

    def _advance_in_place(self, X, t, dt):
        return self._advance(X, t, dt, in_place=True)

    def _adopt_buffers(self, record):
        """With `record`, the histories' tensors become the buffers a
        recording writes; else histories rebound by single steps since
        are copied into those buffers, tail first (a single step moves a
        buffer only towards the tail, so each is read before it is
        written)."""
        hists = (self.F_hist, self.MX_hist, self.LX_hist)
        if record:
            self._buffers = [list(hist) for hist in hists]
            return
        for hist, own in zip(hists, self._buffers):
            for j in range(len(hist) - 1, -1, -1):
                if hist[j] is not own[j]:
                    own[j].copy_(hist[j])
                    hist[j] = own[j]

    def capture_state(self):
        """Iteration, dt history and the three histories as (s, G, S)
        device copies (a recorded step writes the live buffers in place,
        so a reference would not keep them)."""
        state = super().capture_state()
        state["dt_hist"] = list(self.dt_hist)
        for name in ("F_hist", "MX_hist", "LX_hist"):
            state[name] = torch.stack(getattr(self, name))
        return state

    def restore_state(self, state):
        """Copy the captured histories into the live buffers (the
        snapshot keeps its own copy for a second rewind)."""
        self.load_histories(state["F_hist"], state["MX_hist"],
                            state["LX_hist"], state["dt_hist"])
        super().restore_state(state)

    def load_histories(self, F, MX, LX, dt_hist):
        """Histories from (s, G, S) arrays (tensors or host arrays, as a
        checkpoint holds them) into the live buffers, and the dt
        history."""
        for name, saved in (("F_hist", F), ("MX_hist", MX), ("LX_hist", LX)):
            saved = torch.as_tensor(saved)
            for hist, row in zip(getattr(self, name), saved):
                hist.copy_(row)
        self.dt_hist = [float(v) for v in dt_hist]

    def phase_probes(self):
        """Measurement thunks re-running the step pieces on a copy of the
        current state, no state mutation: {name: (thunk, per-step
        scale)}; None until the first step has factored the LHS. The
        inputs are cached per LHS key; the solve reads the live factor,
        so a superseded factorization is never kept alive by the cache
        (dedalus_tpu/core/timesteppers.py:387)."""
        if self._lhs_aux is None or not self.dt_hist:
            return None
        cache = self._probe_cache
        if cache is None or cache[0] != self._lhs_key:
            solver = self.solver
            ops, M, L = solver.ops, solver.M_mat, solver.L_mat
            X = solver.X.clone()
            t = float(solver.sim_time)
            _, _, RHS = self._update(
                X, t, None, (self.F_hist, self.MX_hist, self.LX_hist),
                self._abc)

            def eval_thunk():
                return (solver.eval_F(X, t) * self._mask,
                        ops.matvec_pair(M, L, X))

            def solve_thunk():
                return ops.solve(self._lhs_aux, RHS, mats=(M, L))

            cache = self._probe_cache = (self._lhs_key, {
                "rhs_eval": (eval_thunk, 1.0),
                "matsolve": (solve_thunk, 1.0)})
        return cache[1]

    def step(self, dt):
        solver = self.solver
        self._prepare(dt)
        solver.X = self._advance(solver.X, float(solver.sim_time), dt)
        solver.sim_time = float(solver.sim_time) + float(dt)

    def _stationary(self, dt):
        s = self.steps
        return (self.iteration >= s and len(self.dt_hist) == s
                and all(abs(k - dt) < 1e-15 * abs(dt) for k in self.dt_hist))

    def _graph_key(self, dt):
        return (dt, *(tuple(map(float, v)) for v in self._abc))

    def step_many(self, n, dt):
        """n constant-dt steps (dedalus_tpu/core/timesteppers.py:345): the
        startup ramp and a dt change run as single steps until the
        coefficients are stationary; the rest is one block."""
        dt = float(dt)
        n = int(n)
        while n > 0 and not self._stationary(dt):
            self.step(dt)
            n -= 1
        if n == 0:
            return
        self._set_coefficients(self.steps)
        self._run_block(n, dt)
        self.iteration += n


@add_scheme
class CNAB1(MultistepIMEX):
    """Crank-Nicolson / Adams-Bashforth 1 (reference: core/timesteppers.py:179)."""
    steps = 1

    def compute_coefficients(self, dt_hist, order):
        k0 = dt_hist[0]
        return np.array([1/k0, -1/k0]), np.array([0.5, 0.5]), np.array([1.0])


@add_scheme
class SBDF1(MultistepIMEX):
    """1st-order semi-implicit BDF / backward Euler (reference: :212)."""
    steps = 1

    def compute_coefficients(self, dt_hist, order):
        k0 = dt_hist[0]
        return np.array([1/k0, -1/k0]), np.array([1.0, 0.0]), np.array([1.0])


class SBDFBase(MultistepIMEX):
    """Variable-step SBDF via Lagrange weights."""

    def compute_coefficients(self, dt_hist, order):
        p = min(order, self.steps)
        times = _past_times(dt_hist, p)
        a = _lagrange_derivative_weights(times)
        b = np.zeros(p + 1)
        b[0] = 1.0
        c = _lagrange_extrapolation_weights(times[1:])
        return a, b, c


@add_scheme
class SBDF2(SBDFBase):
    """2nd-order SBDF (reference: core/timesteppers.py:321)."""
    steps = 2


@add_scheme
class SBDF3(SBDFBase):
    """3rd-order SBDF (reference: core/timesteppers.py:398)."""
    steps = 3


@add_scheme
class SBDF4(SBDFBase):
    """4th-order SBDF (reference: core/timesteppers.py:439)."""
    steps = 4


@add_scheme
class CNAB2(MultistepIMEX):
    """Crank-Nicolson / Adams-Bashforth 2 (reference: :244)."""
    steps = 2

    def compute_coefficients(self, dt_hist, order):
        if order == 1:
            return CNAB1.compute_coefficients(self, dt_hist, order)
        k0, k1 = dt_hist[0], dt_hist[1]
        w = k0 / k1
        a = np.array([1/k0, -1/k0, 0.0])
        b = np.array([0.5, 0.5, 0.0])
        c = np.array([1 + w/2, -w/2])
        return a, b, c


@add_scheme
class MCNAB2(MultistepIMEX):
    """Modified CNAB2 (Wang & Ruuth 2008; reference: :282)."""
    steps = 2

    def compute_coefficients(self, dt_hist, order):
        if order == 1:
            return CNAB1.compute_coefficients(self, dt_hist, order)
        k0, k1 = dt_hist[0], dt_hist[1]
        w = k0 / k1
        a = np.array([1/k0, -1/k0, 0.0])
        b = np.array([(8 + 1/w)/16, (7 - 1/w)/16, 1/16])  # Wang 2008 eqn 2.10
        c = np.array([1 + w/2, -w/2])
        return a, b, c


@add_scheme
class CNLF2(MultistepIMEX):
    """Crank-Nicolson leapfrog (reference: core/timesteppers.py:359)."""
    steps = 2

    def compute_coefficients(self, dt_hist, order):
        if order == 1:
            return CNAB1.compute_coefficients(self, dt_hist, order)
        k0, k1 = dt_hist[0], dt_hist[1]
        w = k0 / k1
        # Wang 2008 eqn 2.11 (variable-step leapfrog + wide Crank-Nicolson)
        a = np.array([1/((1 + w)*k0), (w - 1)/k0, -w**2/((1 + w)*k0)])
        b = np.array([1/(2*w), (1 - 1/w)/2, 0.5])
        c = np.array([1.0, 0.0])
        return a, b, c


class RungeKuttaIMEX(BlockStepper):
    """IMEX Runge-Kutta base (reference: core/timesteppers.py:486)."""

    stages = None
    A = None  # explicit tableau (s+1, s+1)
    H = None  # implicit tableau (s+1, s+1)
    c = None  # stage times (s+1,)
    steps = 1

    def __init__(self, solver):
        self.solver = solver
        self.iteration = 0
        self._lhs_key = None
        self._lhs_aux = None
        # stages with equal implicit diagonal coefficients H[i,i] share one
        # factorization (all ARS tableaux here have constant diagonals, so
        # typically a single LHS factor serves every stage)
        H_diag = [float(self.H[i, i]) for i in range(1, self.stages + 1)]
        self.uniq_H_diag = sorted(set(H_diag))
        self.stage_slot = [self.uniq_H_diag.index(h) for h in H_diag]
        self.factorizations = 0
        self._mask = _valid_row_mask(solver)

    def _factor(self, dt):
        solver = self.solver
        auxs = [solver.factor_checked(
            lambda: solver.ops.factor_lincomb(1.0, solver.M_mat, dt * h,
                                              solver.L_mat),
            {"M": 1.0, "L": dt * h}) for h in self.uniq_H_diag]
        self.factorizations += len(auxs)
        return [auxs[j] for j in self.stage_slot]

    def step_body(self, X0, t0, dt, extras, lhs_auxs):
        """One RK step as a pure function (dedalus_tpu/core/
        timesteppers.py:631): state X0 at time t0 (a float or a 0-d
        tensor), the RHS's extra field operands (None reads the fields)
        and the factored LHS of each stage. Returns the new state."""
        solver = self.solver
        ops = solver.ops
        M, L = solver.M_mat, solver.L_mat
        A, H, c = self.A.tolist(), self.H.tolist(), self.c.tolist()
        MX0 = ops.matvec(M, X0)
        LXs = []
        Fs = []
        Xi = X0
        for i in range(1, self.stages + 1):
            LXs.append(ops.matvec(L, Xi))
            Fs.append(solver.eval_F(Xi, t0 + c[i - 1] * dt, extras)
                      * self._mask)
            RHS = MX0
            for j in range(i):
                RHS = RHS + dt * (A[i][j] * Fs[j] - H[i][j] * LXs[j])
            Xi = ops.solve(lhs_auxs[i - 1], RHS, mats=(M, L))
        return Xi

    def _advance(self, X0, t0, dt):
        """One RK step from state X0 at time t0 with the factors set."""
        return self.step_body(X0, t0, dt, None, self._lhs_aux)

    def _ensure_factor(self, dt):
        key = round(float(dt), 14)
        if key != self._lhs_key:
            self._lhs_key = key
            self._lhs_aux = self._factor(float(dt))

    def phase_probes(self):
        """Measurement thunks re-running one stage (evaluation, solve) on
        a copy of the current state, scale = stages; None until the
        first step has factored the LHS (dedalus_tpu/core/
        timesteppers.py:740). The solve reads the live factor."""
        if self._lhs_aux is None:
            return None
        cache = self._probe_cache
        if cache is None or cache[0] != self._lhs_key:
            solver = self.solver
            ops, M, L = solver.ops, solver.M_mat, solver.L_mat
            X = solver.X.clone()
            t = float(solver.sim_time)
            dt = float(self._lhs_key)
            A, H = self.A.tolist(), self.H.tolist()
            LX1 = ops.matvec(L, X)
            F1 = solver.eval_F(X, t) * self._mask
            RHS = ops.matvec(M, X) + dt * (A[1][0] * F1 - H[1][0] * LX1)

            def eval_thunk():
                return ops.matvec(L, X), solver.eval_F(X, t) * self._mask

            def solve_thunk():
                return ops.solve(self._lhs_aux[0], RHS, mats=(M, L))

            scale = float(self.stages)
            cache = self._probe_cache = (self._lhs_key, {
                "rhs_eval": (eval_thunk, scale),
                "matsolve": (solve_thunk, scale)})
        return cache[1]

    def step(self, dt):
        solver = self.solver
        self._ensure_factor(dt)
        solver.X = self._advance(solver.X, float(solver.sim_time), float(dt))
        solver.sim_time = float(solver.sim_time) + float(dt)
        self.iteration += 1

    def _graph_key(self, dt):
        return dt

    def step_many(self, n, dt):
        """n constant-dt steps as one block
        (dedalus_tpu/core/timesteppers.py:723)."""
        n = int(n)
        self._ensure_factor(dt)
        self._run_block(n, dt)
        self.iteration += n


@add_scheme
class RK111(RungeKuttaIMEX):
    """1st-order 1-stage IMEX RK (reference: core/timesteppers.py:636)."""
    stages = 1
    A = np.array([[0., 0.], [1., 0.]])
    H = np.array([[0., 0.], [0., 1.]])
    c = np.array([0., 1.])


@add_scheme
class RK222(RungeKuttaIMEX):
    """2nd-order 2-stage IMEX RK, ARS(2,2,2) (reference: :651)."""
    stages = 2
    _gamma = (2. - np.sqrt(2.)) / 2.
    _delta = 1. - 1. / (2. * _gamma)
    A = np.array([[0., 0., 0.],
                  [_gamma, 0., 0.],
                  [_delta, 1. - _delta, 0.]])
    H = np.array([[0., 0., 0.],
                  [0., _gamma, 0.],
                  [0., 1. - _gamma, _gamma]])
    c = np.array([0., _gamma, 1.])


@add_scheme
class RKSMR(RungeKuttaIMEX):
    """(3-eps)-order 3-stage DIRK+ERK scheme of Spalart, Moser & Rogers
    (1991, Appendix); coefficients are the published constants
    (reference: core/timesteppers.py:692 RKSMR)."""
    stages = 3
    _a1, _a2, _a3 = (29/96, -3/40, 1/6)
    _b1, _b2, _b3 = (37/160, 5/24, 1/6)
    _g1, _g2, _g3 = (8/15, 5/12, 3/4)
    _z2, _z3 = (-17/60, -5/12)
    A = np.array([[0., 0., 0., 0.],
                  [_g1, 0., 0., 0.],
                  [_g1 + _z2, _g2, 0., 0.],
                  [_g1 + _z2, _g2 + _z3, _g3, 0.]])
    H = np.array([[0., 0., 0., 0.],
                  [_a1, _b1, 0., 0.],
                  [_a1, _b1 + _a2, _b2, 0.],
                  [_a1, _b1 + _a2, _b2 + _a3, _b3]])
    c = np.array([0., 8/15, 2/3, 1.])


@add_scheme
class RK443(RungeKuttaIMEX):
    """3rd-order 4-stage IMEX RK, ARS(4,4,3) (reference: :671)."""
    stages = 4
    A = np.array([[0., 0., 0., 0., 0.],
                  [1/2, 0., 0., 0., 0.],
                  [11/18, 1/18, 0., 0., 0.],
                  [5/6, -5/6, 1/2, 0., 0.],
                  [1/4, 7/4, 3/4, -7/4, 0.]])
    H = np.array([[0., 0., 0., 0., 0.],
                  [0., 1/2, 0., 0., 0.],
                  [0., 1/6, 1/2, 0., 0.],
                  [0., -1/2, 1/2, 1/2, 0.],
                  [0., 3/2, -3/2, 1/2, 1/2]])
    c = np.array([0., 1/2, 2/3, 1/2, 1.])


@add_scheme
class RKGFY(RungeKuttaIMEX):
    """2nd-order 2-stage IMEX RK of Hollerbach & Marti (published
    tableau; reference keeps it unregistered at core/timesteppers.py:715)."""
    stages = 2
    A = np.array([[0., 0., 0.],
                  [1., 0., 0.],
                  [0.5, 0.5, 0.]])
    H = np.array([[0., 0., 0.],
                  [0.5, 0.5, 0.],
                  [0.5, 0., 0.5]])
    c = np.array([0., 1., 1.])
