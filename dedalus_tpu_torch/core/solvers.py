"""
Solvers (counterpart of dedalus_tpu/core/solvers.py: the initial value
solver on the banded pencil path).

The solver holds the state as ONE device tensor X of shape (G, S) (all
pencils batched); fields are synchronized at step boundaries so user code
sees reference-like Field semantics while the step loop stays on the
device (reference hot loop anatomy: core/solvers.py:683-711).
"""

import logging
import time as time_mod

import numpy as np
import torch

from .subsystems import (PencilLayout, build_subproblems, MatrixStructure,
                         build_banded_arrays, gather_state, scatter_state,
                         row_valid_masks, merge_conditional_equations,
                         state_key, PatternAccumulator, compute_group_closure)
from .batched_assembly import batched_system_coos
from .future import EvalContext, ev
from . import timesteppers as timesteppers_mod
from ..libraries import pencilops
from ..tools.array import torch_dtype
from ..tools.config import config

logger = logging.getLogger(__name__)


class SolverBase:
    """Shared setup: pencil layout, subproblems, banded device matrices
    (reference: core/solvers.py:31 SolverBase)."""

    matrices = ("L",)

    def __init__(self, problem, matsolver=None):
        self.problem = problem
        self.dist = problem.dist
        self.variables = problem.variables
        if str(matsolver or "banded").lower() != "banded":
            raise ValueError(f"matsolver={matsolver!r}: dedalus_tpu_torch "
                             "carries the banded pencil path only")
        self.matsolver = "banded"
        self.layout = PencilLayout(self.dist, self.variables,
                                   problem.equations)
        self.equations = merge_conditional_equations(problem.equations,
                                                     self.dist, self.layout)
        self.subproblems = build_subproblems(self.layout)
        self.build_seconds = {}
        self._build_pencil_system()
        self.valid_row_mask = row_valid_masks(self.layout, self.equations)

    def _build_pencil_system(self):
        """
        Assemble the pencil matrices (group-batched kron-term assembly,
        core/batched_assembly.py, with per-expression fallback to the
        per-group walk) and build the banded + pinned representation:
        structural analysis, validity closure aligned with the matching,
        and banded storage (reference: ScipyBanded + Woodbury,
        libraries/matsolvers.py:186-194,285-316). Sets self._matrices
        (host arrays), self.structure and self.ops.
        """
        names = self.matrices
        t0 = time_mod.perf_counter()
        pr, pc, bvals, row_valid_b, col_valid_b = batched_system_coos(
            self.layout, self.equations, self.variables, names,
            subproblems=self.subproblems, partial=True)
        self.build_seconds["host_assembly"] = time_mod.perf_counter() - t0
        t0 = time_mod.perf_counter()
        S = self.pencil_shape[1]
        # Relative drop tolerance for the PATTERN only (band detection /
        # matching); stored matrix values are never filtered.
        tol = float(config["linear algebra"].get("BAND_DETECT_CUTOFF", "1e-14"))
        coo_store = []
        masks = []
        for g in range(len(self.subproblems)):
            coo_store.append({name: (pr, pc, bvals[name][g]) for name in names})
            masks.append((row_valid_b[g], col_valid_b[g]))
        scale = max((np.abs(bvals[name]).max() if bvals[name].size else 0.0)
                    for name in names)
        tol_abs = tol * (scale or 1.0)
        # Per-ROW relative significance, scaled to the pencil precision
        eps_p = np.finfo(self.pencil_dtype).eps
        row_frac = max(tol, 10.0 * eps_p)
        acc = PatternAccumulator(S)
        for coos, (row_valid, col_valid) in zip(coo_store, masks):
            rowmax = np.zeros(S)
            for r, c, v in coos.values():
                if len(r):
                    np.maximum.at(rowmax, r, np.abs(v))
            pat = {}
            for k, (r, c, v) in coos.items():
                # row-significant AND above the global assembly-dirt floor
                keep = (np.abs(v) >= row_frac * rowmax[r]) \
                    & (np.abs(v) > tol_abs)
                pat[k] = (r[keep], c[keep], v[keep])
            acc.add_group(pat, row_valid, col_valid)
        structure = MatrixStructure(self.layout, self.variables,
                                    self.equations)
        structure.finalize(acc.union, acc.qualified(),
                           np.array([m[0] for m in masks]),
                           np.array([m[1] for m in masks]),
                           vmax=acc.vmax, allow_uneconomic=True)
        if not structure.ok:
            raise ValueError("Banded solve not applicable: "
                             f"{structure.reason}")
        # validity closure aligned with the matching
        closures = []
        for row_valid, col_valid in masks:
            closure = compute_group_closure(structure, row_valid, col_valid)
            if closure is None:
                raise ValueError("Banded solve not applicable: validity "
                                 "closure misaligned with matching")
            closures.append(closure)
        self.build_seconds["structure"] = time_mod.perf_counter() - t0
        t0 = time_mod.perf_counter()
        self._matrices = build_banded_arrays(
            coo_store, structure, names, np.float64,
            drop_tol=max(tol_abs, row_frac * (scale or 1.0)),
            closures=closures)
        self.build_seconds["host_assembly"] += time_mod.perf_counter() - t0
        self.structure = structure
        self.ops = pencilops.BandedOps(structure, self.dist.device)
        logger.info(
            f"Pencil system: banded path (S={structure.S}, "
            f"pins={structure.t_pins}, kl={structure.kl}, "
            f"ku={structure.ku}, q={structure.q})")

    @property
    def pencil_shape(self):
        S = sum(self.layout.slot_size(v.domain, v.tensorsig) for v in self.variables)
        return (self.layout.n_groups, S)

    @property
    def pencil_dtype(self):
        """Device working dtype: float32 when every variable is float32."""
        bits32 = all(np.dtype(v.dtype) == np.dtype(np.float32)
                     for v in self.variables)
        return np.dtype(np.float32) if bits32 else np.dtype(np.float64)

    # ---------------------------------------------------------------- fields

    def gather_fields(self, fields=None):
        fields = fields or self.variables
        arrays = {state_key(v): v.coeff_data() for v in fields}
        return gather_state(self.layout, fields, arrays)

    def defer_scatter(self, X):
        """
        Install lazy pulls: fields fetch their slice of X only when accessed
        (keeps the stepping loop free of per-step scatter work).
        """
        cache = {}
        layout, variables = self.layout, self.variables

        def make_pull(var):
            def pull():
                if "arrays" not in cache:
                    cache["arrays"] = scatter_state(layout, variables, X)
                var.preset_coeff(cache["arrays"][state_key(var)])
            return pull

        for v in variables:
            v.install_pull(make_pull(v))

    def snapshot_versions(self):
        self._field_versions = {v.name: v._version for v in self.variables}

    def fields_dirty(self):
        versions = getattr(self, "_field_versions", None)
        if versions is None:
            return True
        return any(v._version != versions.get(v.name) for v in self.variables)

    # ------------------------------------------------------------------ RHS

    def build_rhs_evaluator(self, key="F", time_field=None):
        """
        Build `eval_F(X, t=None) -> (G, S)` evaluating the per-equation
        `key` expressions on the state X. Non-variable fields feeding the
        RHS (parameters, forcings) are read at evaluation time, so user
        updates to them take effect on the next step.
        """
        layout = self.layout
        variables = self.variables
        equations = self.equations
        dim = self.dist.dim
        device = self.dist.device
        dtype = torch_dtype(self.pencil_dtype)
        # per-block member selection masks for conditioned equations
        groups = list(layout.groups())
        member_masks = [
            [None if cond is None
             else torch.as_tensor([float(cond(g)) for g in groups],
                                  dtype=dtype, device=device)[:, None]
             for _, cond in eq["members"]]
            for eq in equations]

        def eval_F(X, t=None):
            arrays = scatter_state(layout, variables, X)
            subs = {var: arrays[state_key(var)] for var in variables}
            if time_field is not None:
                subs[time_field] = torch.full((1,) * dim, float(t or 0.0),
                                              dtype=dtype, device=device)
            ctx = EvalContext(subs)
            parts = []
            for eq, masks in zip(equations, member_masks):
                size = layout.slot_size(eq["domain"], eq["tensorsig"])
                total = None
                for (member, cond), mask in zip(eq["members"], masks):
                    expr = member.get(key)
                    if expr is None:
                        continue
                    data = ev(expr, ctx, "c")
                    part = layout.gather(data, eq["domain"], eq["tensorsig"])
                    if mask is not None:
                        part = part * mask
                    total = part if total is None else total + part
                if total is None:
                    total = torch.zeros((layout.n_groups, size), dtype=dtype,
                                        device=device)
                parts.append(total)
            return torch.cat(parts, dim=1).to(dtype)

        return eval_F


class InitialValueSolver(SolverBase):
    """IVP solver (reference: core/solvers.py:503 InitialValueSolver)."""

    matrices = ("M", "L")

    def __init__(self, problem, timestepper, matsolver=None,
                 enforce_real_cadence=100):
        super().__init__(problem, matsolver=matsolver)
        self.M_mat = self.ops.to_device(self._matrices["M"], self.pencil_dtype)
        self.L_mat = self.ops.to_device(self._matrices["L"], self.pencil_dtype)
        self.eval_F = self.build_rhs_evaluator("F", time_field=problem.time)
        # timestepping state
        self.sim_time = 0.0
        self.iteration = 0
        self.enforce_real_cadence = enforce_real_cadence
        self.X = self.gather_fields()
        if isinstance(timestepper, str):
            timestepper = timesteppers_mod.schemes[timestepper]
        self.timestepper = timestepper(self)
        self.dt = None

    def enforce_hermitian_symmetry(self):
        """
        Re-project the state through a dealiased grid roundtrip
        (reference: core/solvers.py:675-692 enforce_hermitian_symmetry):
        projects accumulated drift out of non-representable modes.
        """
        from .field import transform_to_grid, transform_to_coeff
        arrays = scatter_state(self.layout, self.variables, self.X)
        out = {}
        for v in self.variables:
            scales = tuple(v.domain.dealias)
            tdim = len(v.tensorsig)
            g = transform_to_grid(arrays[state_key(v)], v.domain, scales,
                                  tdim, tensorsig=v.tensorsig)
            out[state_key(v)] = transform_to_coeff(g, v.domain, scales, tdim,
                                                   tensorsig=v.tensorsig)
        self.X = gather_state(self.layout, self.variables, out)

    def step(self, dt):
        """Advance the system by one timestep (reference: core/solvers.py:683)."""
        dt = float(dt)
        if not np.isfinite(dt):
            raise ValueError(f"Invalid timestep: {dt}")
        # pick up user modifications of the state fields (version-tracked)
        if self.fields_dirty():
            self.X = self.gather_fields()
        # Hermitian/valid-mode re-projection cadence (reference:
        # core/solvers.py:688-692 — enforced for timestepper.steps
        # consecutive iterations so the multistep history stays consistent)
        if self.enforce_real_cadence:
            if self.iteration % self.enforce_real_cadence < self.timestepper.steps:
                self.enforce_hermitian_symmetry()
        self.timestepper.step(dt)
        self.defer_scatter(self.X)
        self.snapshot_versions()
        self.problem.sim_time = self.sim_time
        self.iteration += 1
        self.dt = dt

    def step_many(self, n, dt):
        """Advance n constant-dt steps: a loop of `step`, so every step
        keeps its own re-projection cadence."""
        for _ in range(int(n)):
            self.step(dt)
