"""
IMEX Runge-Kutta timesteppers (counterpart of
dedalus_tpu/core/timesteppers.py: RungeKuttaIMEX and its tableaux).

Schemes integrate M.dt(X) + L.X = F with implicit L and explicit F
(reference: core/timesteppers.py:486 RungeKuttaIMEX, tableaux from Ascher,
Ruuth & Spiteri 1997):
    M.X(i) - M.X(0) = dt * sum_j [ A[i,j] F(j) - H[i,j] L.X(j) ]

Each step runs the stage bodies eagerly on the solver's device: banded
matvecs, the RHS evaluation (transforms + grid products), and one banded
solve per stage. The LHS factorization M + dt*H[i,i]*L is recomputed only
when dt changes (reference: core/timesteppers.py:123-128,160-168), once per
unique implicit diagonal.
"""

import numpy as np
import torch

schemes = {}


def add_scheme(cls):
    schemes[cls.__name__] = cls
    return cls


class RungeKuttaIMEX:
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
        self._mask = torch.as_tensor(
            solver.valid_row_mask, device=solver.dist.device).to(
                solver.X.dtype)

    def _factor(self, dt):
        solver = self.solver
        ops = solver.ops
        auxs = [ops.factor_lincomb(1.0, solver.M_mat, dt * h, solver.L_mat)
                for h in self.uniq_H_diag]
        return [auxs[j] for j in self.stage_slot]

    def step_body(self, X0, t0, dt):
        """One RK step from state X0 at time t0: returns the new state."""
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
            Fs.append(solver.eval_F(Xi, t0 + c[i - 1] * dt) * self._mask)
            RHS = MX0
            for j in range(i):
                RHS = RHS + dt * (A[i][j] * Fs[j] - H[i][j] * LXs[j])
            Xi = ops.solve(self._lhs_aux[i - 1], RHS, mats=(M, L))
        return Xi

    def _ensure_factor(self, dt):
        key = round(float(dt), 14)
        if key != self._lhs_key:
            self._lhs_key = key
            self._lhs_aux = self._factor(float(dt))

    def step(self, dt):
        solver = self.solver
        self._ensure_factor(dt)
        solver.X = self.step_body(solver.X, float(solver.sim_time), float(dt))
        solver.sim_time = float(solver.sim_time) + float(dt)
        self.iteration += 1


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
