"""
Solvers (counterpart of dedalus_tpu/core/solvers.py):

  InitialValueSolver           IMEX timestepping and its run loop
  LinearBoundaryValueSolver    batched pencil solve of L.X = F
  NonlinearBoundaryValueSolver Newton-Kantorovich iteration
  EigenvalueSolver             dense/sparse generalized eigensolves per
                               pencil, on the host with scipy

The solver holds the state as ONE device tensor X of shape (G, S) (all
pencils batched); fields are synchronized at step boundaries so user code
sees reference-like Field semantics while the step loop stays on the
device (reference hot loop anatomy: core/solvers.py:683-711).
"""

import logging
import time as time_mod

import numpy as np
import scipy.linalg
import scipy.sparse as sps
import torch

from .subsystems import (PencilLayout, build_subproblems, MatrixStructure,
                         build_banded_arrays, gather_state, scatter_state,
                         row_valid_masks, merge_conditional_equations,
                         state_key, PatternAccumulator, compute_group_closure,
                         assemble_group_coos)
from .batched_assembly import batched_system_coos
from .future import EvalContext, ev
from . import timesteppers as timesteppers_mod
from ..libraries import matsolvers, pencilops
from ..tools.array import torch_dtype, to_numpy, scipy_sparse_eigs
from ..tools.config import config
from ..tools.general import is_complex_dtype

logger = logging.getLogger(__name__)


def resolve_matsolver(spec):
    """(path, dense solver class) for a `[linear algebra] MATRIX_SOLVER`
    value or a `matsolver=` argument: 'auto' (dense below
    BANDED_CUTOFF_BYTES, banded tried above), 'banded' or 'dense' with
    the backend's default dense solver, or a registered dense solver
    name or class. Off the TPU the JAX package's default dense solver is
    BatchedLUFactorized (dedalus_tpu/core/solvers.py:416-431), and so it
    is here."""
    if isinstance(spec, str) and spec.lower() in ("auto", "banded", "dense"):
        return spec.lower(), matsolvers.BatchedLUFactorized
    return "dense", matsolvers.get_solver(spec)


class SolverBase:
    """Shared setup: pencil layout, subproblems, device matrices
    (reference: core/solvers.py:31 SolverBase)."""

    matrices = ("L",)
    lazy_ok = False   # EVP: per-group on-demand assembly at large sizes

    def __init__(self, problem, matsolver=None):
        self.problem = problem
        self.dist = problem.dist
        self.variables = self.matrix_variables(problem)
        if matsolver is None:
            matsolver = config["linear algebra"].get("MATRIX_SOLVER", "auto")
        self.matsolver = matsolver
        self._path, self._dense_solver = resolve_matsolver(matsolver)
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
        per-group walk) and pick the device representation with the JAX
        package's rule (dedalus_tpu/core/solvers.py:205-238): dense
        (G, S, S) below BANDED_CUTOFF_BYTES under 'auto'; banded + pinned
        Woodbury when forced, or under 'auto' above the cutoff when the
        banded path applies (else dense). Sets self._matrices (host
        arrays), self.structure (None on the dense path) and self.ops.
        An EVP keeps only the shared-pattern store (or, above
        EVP_LAZY_BYTES, nothing) and has no ops.
        """
        names = self.matrices
        G, S = self.pencil_shape
        dense_bytes = G * S * S * self.pencil_dtype.itemsize
        self._lazy = False
        self._batched = None
        if self.lazy_ok and dense_bytes > int(config["linear algebra"].get(
                "EVP_LAZY_BYTES", str(1 << 28))):
            # an EVP at scale: no (G, S, S) store at all; solve_dense and
            # solve_sparse assemble the group they are asked for
            # (dedalus_tpu/core/solvers.py:136-156)
            logger.info(f"EVP pencil system: lazy per-group assembly "
                        f"(G={G}, S={S}; dense store would be "
                        f"{dense_bytes / 1e9:.2f} GB)")
            self._lazy = True
            self._matrices = None
            self.structure = None
            self.ops = None
            return
        t0 = time_mod.perf_counter()
        batched = batched_system_coos(
            self.layout, self.equations, self.variables, names,
            subproblems=self.subproblems, partial=True)
        self.build_seconds["host_assembly"] = time_mod.perf_counter() - t0
        self.build_seconds["structure"] = 0.0
        self.structure = None
        if self.lazy_ok:
            # an EVP eigensolves on the host: the shared-pattern store
            # scatters straight to each group's CSR in _group_csr, and no
            # device representation is built
            self._batched = batched
            self._matrices = None
            self.ops = None
            return
        cutoff = int(config["linear algebra"].get("BANDED_CUTOFF_BYTES",
                                                  str(1 << 30)))
        if self._path == "banded" or (self._path == "auto"
                                      and dense_bytes > cutoff):
            reason = self._try_banded(batched, names, S)
            if reason is None:
                return
            if self._path == "banded":
                raise ValueError("Banded solve forced but not applicable: "
                                 f"{reason}")
            msg = (f"Banded path not applicable ({reason}); using dense "
                   f"({dense_bytes / 1e9:.2f} GB)")
            if dense_bytes > 4 * cutoff:
                logger.warning(msg + " — this exceeds the banded cutoff 4x")
            else:
                logger.info(msg)
        t0 = time_mod.perf_counter()
        self._matrices = self._dense_from_batched(batched, names)
        self.build_seconds["host_assembly"] += time_mod.perf_counter() - t0
        self.ops = pencilops.DenseOps(self.dist.device, self._dense_solver)
        logger.info(f"Pencil system: dense path (G={G}, S={S}, "
                    f"{self._dense_solver.__name__})")

    def _dense_from_batched(self, batched, names):
        """Scatter the shared-pattern COO store of batched_system_coos into
        dense (G, S, S) arrays with the enumeration-order validity closure
        on the last name: the i-th invalid row of a group gets a 1 at its
        i-th invalid column (dedalus_tpu/core/solvers.py:274-288,
        vectorized over the groups; the output is the same array)."""
        pr, pc, vals, row_valid, col_valid = batched
        G, S = self.pencil_shape
        out = {}
        for name in names:
            dense = np.zeros((G, S, S), dtype=vals[name].dtype)
            dense[:, pr, pc] = vals[name]
            out[name] = dense
        g_rows, inv_rows = np.nonzero(~row_valid)
        g_cols, inv_cols = np.nonzero(~col_valid)
        if not np.array_equal(g_rows, g_cols):
            raise ValueError("Validity closure: a pencil group has unequal "
                             "counts of invalid rows and columns")
        out[names[-1]][g_rows, inv_rows, inv_cols] = 1.0
        return out

    def _try_banded(self, batched, names, S):
        """
        Attempt the banded + pinned representation: run the structural
        analysis on the assembled (pre-closure) entries, place the
        validity closure on the matched diagonal, and extract banded
        storage (reference: ScipyBanded + Woodbury,
        libraries/matsolvers.py:186-194,285-316). Returns None on success
        (with self._matrices, self.structure and self.ops set), else the
        reason the banded path does not apply.
        """
        t0 = time_mod.perf_counter()
        pr, pc, bvals, row_valid_b, col_valid_b = batched
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
                           vmax=acc.vmax,
                           allow_uneconomic=(self._path == "banded"))
        if not structure.ok:
            return structure.reason
        # validity closure aligned with the matching
        closures = []
        for row_valid, col_valid in masks:
            closure = compute_group_closure(structure, row_valid, col_valid)
            if closure is None:
                return "validity closure misaligned with matching"
            closures.append(closure)
        self.build_seconds["structure"] = time_mod.perf_counter() - t0
        t0 = time_mod.perf_counter()
        try:
            host_dtype = (np.complex128 if is_complex_dtype(self.pencil_dtype)
                          else np.float64)
            matrices = build_banded_arrays(
                coo_store, structure, names, host_dtype,
                drop_tol=max(tol_abs, row_frac * (scale or 1.0)),
                closures=closures)
        except ValueError as exc:
            return str(exc)
        self.build_seconds["host_assembly"] += time_mod.perf_counter() - t0
        self._matrices = matrices
        self.structure = structure
        self.ops = pencilops.BandedOps(structure, self.dist.device)
        logger.info(
            f"Pencil system: banded path (S={structure.S}, "
            f"pins={structure.t_pins}, kl={structure.kl}, "
            f"ku={structure.ku}, q={structure.q})")
        return None

    @property
    def pencil_shape(self):
        S = sum(self.layout.slot_size(v.domain, v.tensorsig) for v in self.variables)
        return (self.layout.n_groups, S)

    @property
    def subproblems_by_group(self):
        """Subproblems keyed by their group tuple
        (dedalus_tpu/core/solvers.py:442)."""
        return {sp.group: sp for sp in self.subproblems}

    def matrix_variables(self, problem):
        """The variables the pencil matrices act on (an NLBVP's are its
        perturbations)."""
        return problem.variables

    @property
    def state(self):
        return self.problem.variables

    @property
    def pencil_dtype(self):
        """Device working dtype: complex when a variable is complex,
        32-bit when every variable is 32-bit."""
        cplx = any(is_complex_dtype(v.dtype) for v in self.variables)
        bits32 = all(np.dtype(v.dtype) in (np.dtype(np.float32),
                                           np.dtype(np.complex64))
                     for v in self.variables)
        if cplx:
            return np.dtype(np.complex64 if bits32 else np.complex128)
        return np.dtype(np.float32 if bits32 else np.float64)

    @property
    def real_dtype(self):
        low = self.pencil_dtype in (np.dtype(np.float32),
                                    np.dtype(np.complex64))
        return np.dtype(np.float32 if low else np.float64)

    def _row_mask(self):
        """The valid-row mask on the device at the real working dtype,
        uploaded once."""
        mask = self.__dict__.get("_row_mask_t")
        if mask is None:
            mask = self._row_mask_t = torch.as_tensor(
                self.valid_row_mask, dtype=torch_dtype(self.real_dtype),
                device=self.dist.device)
        return mask

    # ---------------------------------------------------------------- fields

    def gather_fields(self, fields=None):
        fields = fields or self.variables
        arrays = {state_key(v): v.coeff_data() for v in fields}
        return gather_state(self.layout, fields, arrays)

    def scatter_fields(self, X):
        """Eager scatter of a (G, S) state into the variables' coefficient
        data; counts as a user mutation, so a solver sharing the fields
        gathers this data again."""
        arrays = scatter_state(self.layout, self.variables, X)
        for v in self.variables:
            v.preset_coeff(arrays[state_key(v)])
            v.mark_modified()

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

    def build_rhs_evaluator(self, key="F", time_field=None, get_expr=None):
        """
        Build `eval_F(X, t=None) -> (G, S)` evaluating the per-equation
        expressions selected by `get_expr` (default: the member's `key`
        entry) on the state X; X=None reads every field's own data (an
        NLBVP residual). Non-variable fields feeding the RHS (parameters,
        forcings) are read at evaluation time, so user updates to them
        take effect on the next evaluation.
        """
        if get_expr is None:
            get_expr = lambda member: member.get(key)  # noqa: E731
        layout = self.layout
        variables = self.variables
        equations = self.equations
        dim = self.dist.dim
        device = self.dist.device
        dtype = torch_dtype(self.pencil_dtype)
        real = torch_dtype(self.real_dtype)
        # per-block member selection masks for conditioned equations
        groups = list(layout.groups())
        member_masks = [
            [None if cond is None
             else torch.as_tensor([float(cond(g)) for g in groups],
                                  dtype=real, device=device)[:, None]
             for _, cond in eq["members"]]
            for eq in equations]

        def eval_F(X, t=None):
            subs = {}
            if X is not None:
                arrays = scatter_state(layout, variables, X)
                subs = {var: arrays[state_key(var)] for var in variables}
            if time_field is not None:
                subs[time_field] = torch.full((1,) * dim, float(t or 0.0),
                                              dtype=real, device=device)
            ctx = EvalContext(subs)
            parts = []
            for eq, masks in zip(equations, member_masks):
                size = layout.slot_size(eq["domain"], eq["tensorsig"])
                total = None
                for (member, cond), mask in zip(eq["members"], masks):
                    expr = get_expr(member)
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
                 enforce_real_cadence=100, warmup_iterations=10):
        init_t0 = time_mod.time()
        super().__init__(problem, matsolver=matsolver)
        self.M_mat = self.ops.to_device(self._matrices["M"], self.pencil_dtype)
        self.L_mat = self.ops.to_device(self._matrices["L"], self.pencil_dtype)
        self.eval_F = self.build_rhs_evaluator("F", time_field=problem.time)
        # timestepping state and the run loop's stop conditions
        self.sim_time = 0.0
        self.iteration = 0
        self.stop_sim_time = np.inf
        self.stop_wall_time = np.inf
        self.stop_iteration = np.inf
        self.warmup_iterations = warmup_iterations
        self.enforce_real_cadence = enforce_real_cadence
        self.start_time = self.init_time = time_mod.time()
        self.warmup_time = None
        self.X = self.gather_fields()
        if isinstance(timestepper, str):
            timestepper = timesteppers_mod.schemes[timestepper]
        self.timestepper = timestepper(self)
        from .evaluator import Evaluator
        self.evaluator = Evaluator(self)
        self.dt = None
        self._setup_time = time_mod.time() - init_t0

    def _install_carried(self):
        """Put carried M/L (tools/carry.py) on the device and drop the
        timestepper's factorization, so the next step factors them."""
        self.M_mat = self.ops.to_device(self._matrices["M"],
                                        self.pencil_dtype)
        self.L_mat = self.ops.to_device(self._matrices["L"],
                                        self.pencil_dtype)
        self.timestepper._lhs_key = None
        self.timestepper._lhs_aux = None

    @property
    def proceed(self):
        """Whether to keep iterating (reference: core/solvers.py:618)."""
        if self.sim_time >= self.stop_sim_time:
            logger.info("Simulation stop time reached.")
            return False
        if self.iteration >= self.stop_iteration:
            logger.info("Simulation stop iteration reached.")
            return False
        if (time_mod.time() - self.start_time) >= self.stop_wall_time:
            logger.info("Simulation stop wall time reached.")
            return False
        return True

    def _synchronize(self):
        """Wait for the solver's device, so a host clock read after it
        covers the work queued before it."""
        if self.dist.device.type == "cuda":
            torch.cuda.synchronize(self.dist.device)

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
        """Advance the system by one timestep, then evaluate the handlers
        that are due (reference: core/solvers.py:683)."""
        dt = float(dt)
        if not np.isfinite(dt):
            raise ValueError(f"Invalid timestep: {dt}")
        if self.iteration == self.warmup_iterations:
            # the run window of log_stats starts after the queued warmup
            self._synchronize()
            self.warmup_time = time_mod.time()
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
        self.evaluator.evaluate_scheduled(
            iteration=self.iteration,
            wall_time=time_mod.time() - self.start_time,
            sim_time=self.sim_time, timestep=dt)

    def step_many(self, n, dt):
        """Advance n constant-dt steps: a loop of `step`, so every step
        keeps its own re-projection cadence and handler schedule."""
        for _ in range(int(n)):
            self.step(dt)

    def log_stats(self, format=".4g"):
        """Log run statistics with the reference's throughput metric,
        mode-stages per second over the iterations after warmup
        (reference: core/solvers.py:755-778 log_stats)."""
        self._synchronize()
        log_time = time_mod.time()
        logger.info(f"Final iteration: {self.iteration}")
        logger.info(f"Final sim time: {self.sim_time}")
        logger.info(f"Setup time (init - iter 0): "
                    f"{self.start_time - self.init_time:{format}} sec")
        logger.info("Build phases: " + ", ".join(
            f"{k} {v:{format}} s" for k, v in self.build_seconds.items()))
        if self.iteration > self.warmup_iterations and self.warmup_time:
            warmup = self.warmup_time - self.start_time
            run = log_time - self.warmup_time
            iters = self.iteration - self.warmup_iterations
            logger.info(f"Warmup time (iter 0-{self.warmup_iterations}): "
                        f"{warmup:{format}} sec")
            logger.info(f"Run time (iter {self.warmup_iterations}-end): "
                        f"{run:{format}} sec")
            G, S = self.pencil_shape
            rate = G * S * self.timestepper.stages * iters / run \
                if run > 0 else 0.0
            logger.info(f"Speed: {rate:.2e} mode-stages/sec")
        else:
            logger.info(f"Total time: {log_time - self.init_time:{format}} sec")


class LinearBoundaryValueSolver(SolverBase):
    """LBVP solver (dedalus_tpu/core/solvers.py:1400; reference:
    core/solvers.py:324): L is factored once at build time; each `solve`
    evaluates F, masks the invalid rows, solves and scatters, all queued
    on the device without waiting for it."""

    matrices = ("L",)

    def __init__(self, problem, matsolver=None):
        super().__init__(problem, matsolver=matsolver)
        self._factor_L()
        self.eval_F = self.build_rhs_evaluator("F")
        self.iteration = 0

    def _factor_L(self):
        self.L_mat = self.ops.to_device(self._matrices["L"],
                                        self.pencil_dtype)
        self._aux = self.ops.factor(self.L_mat)

    def _install_carried(self):
        """Factor a carried L (tools/carry.py)."""
        self._factor_L()

    def solve(self):
        """Solve L.X = F with the current NCC/RHS field data
        (reference: core/solvers.py:369)."""
        F = self.eval_F(self.gather_fields()) * self._row_mask()
        self.scatter_fields(self.ops.solve(self._aux, F))
        self.iteration += 1
        return self.state


class NonlinearBoundaryValueSolver(SolverBase):
    """Newton-Kantorovich NLBVP solver (dedalus_tpu/core/solvers.py:1436;
    reference: core/solvers.py:418). The pencil matrices act on the
    perturbations; each Newton iteration assembles the Jacobian around
    the current state on the host (its NCCs read the state), then factors
    and solves on the device."""

    matrices = ("L",)

    def __init__(self, problem, matsolver=None):
        super().__init__(problem, matsolver=matsolver)
        self.iteration = 0
        self._last_perturbation = None
        # residual expressions converted to their equation blocks' domains
        self._residual_exprs = {}
        for block in self.equations:
            for member, cond in block["members"]:
                if member.get("residual") is not None:
                    self._residual_exprs[id(member)] = problem._wrap(
                        member["residual"], block["domain"])
        self.eval_R = self.build_rhs_evaluator(
            get_expr=lambda member: self._residual_exprs.get(id(member)))

    def matrix_variables(self, problem):
        return problem.perturbations

    def _eval_residual(self):
        """The masked (G, S) residual G(X) of the current state."""
        return self.eval_R(None) * self._row_mask()

    def newton_iteration(self, damping=1.0):
        """One Newton step: rebuild the Jacobian around the current state,
        solve dG.dX = -G, update the variables (reference:
        core/solvers.py:470)."""
        self._build_pencil_system()
        L = self.ops.to_device(self._matrices["L"], self.pencil_dtype)
        aux = self.ops.factor(L)
        dX = self.ops.solve(aux, -self._eval_residual())
        self._last_perturbation = dX
        arrays = scatter_state(self.layout, self.variables, dX)
        for var, pert in zip(self.problem.variables, self.variables):
            var.preset_coeff(var.coeff_data()
                             + damping * arrays[state_key(pert)])
            var.mark_modified()
        self.iteration += 1

    def perturbation_norm(self, order=2):
        """Norm of the last Newton update dX, the convergence metric: one
        read from the device."""
        if self._last_perturbation is None:
            return np.inf
        return _norm(to_numpy(self._last_perturbation), order)

    def residual_norm(self, order=2):
        return _norm(to_numpy(self._eval_residual()), order)


def _norm(data, order):
    if order == np.inf:
        return np.max(np.abs(data))
    return np.sum(np.abs(data) ** order) ** (1.0 / order)


class EigenvalueSolver(SolverBase):
    """EVP solver: lam*M.X + L.X = 0 (dedalus_tpu/core/solvers.py:1512;
    reference: core/solvers.py:134). The pencil matrices stay on the
    host: each eigensolve is one group's generalized problem in scipy,
    and `set_state` scatters a mode into the fields on the solver's
    device. The build keeps the shared-pattern store and no device
    representation, whatever `matsolver`; above [linear algebra]
    EVP_LAZY_BYTES of dense store, a group is assembled only when asked
    for."""

    matrices = ("M", "L")
    lazy_ok = True

    def __init__(self, problem, matsolver=None):
        super().__init__(problem, matsolver=matsolver)
        self.eigenvalues = None
        self.eigenvectors = None
        self.eigenvalue_subproblem = None

    def _install_carried(self):
        """Read the carried host matrices (tools/carry.py) from now on."""
        self._batched = None
        self._lazy = False
        self._lazy_cache = None

    def _group_csr(self, subproblem):
        """{name: scipy CSR} of one group's pencil matrices: assembled on
        demand in lazy mode, scattered from the shared-pattern store, or
        densified from a carried dense or band store."""
        names = self.matrices
        G, S = self.pencil_shape
        g = subproblem.index
        if self._lazy:
            cache = getattr(self, "_lazy_cache", None)
            if cache is not None and cache[0] == g:
                return cache[1]
            coos = assemble_group_coos(subproblem, self.equations,
                                       self.variables, names)
            out = {name: sps.csr_matrix((vals, (rows, cols)), shape=(S, S))
                   for name, (rows, cols, vals) in coos.items()}
            self._lazy_cache = (g, out)
            return out
        if self._batched is not None:
            pr, pc, vals, row_valid, col_valid = self._batched
            out = {name: sps.csr_matrix((vals[name][g], (pr, pc)),
                                        shape=(S, S))
                   for name in names}
            inv_rows = np.flatnonzero(~row_valid[g])
            inv_cols = np.flatnonzero(~col_valid[g])
            if len(inv_rows):
                out[names[-1]] = out[names[-1]] + sps.csr_matrix(
                    (np.ones(len(inv_rows)), (inv_rows, inv_cols)),
                    shape=(S, S))
            return out
        return {name: sps.csr_matrix(
            self.ops.densify_host(self._matrices[name], g))
            for name in names}

    def _rebuild(self):
        """Reassemble M/L around the current NCC field data (parameter
        continuation)."""
        if self._lazy:
            self._lazy_cache = None
        else:
            self._build_pencil_system()

    def solve_dense(self, subproblem, left=False, normalize_left=True,
                    rebuild_matrices=False, **kw):
        """Dense generalized eigensolve of one pencil (reference:
        core/solvers.py:180 solve_dense); infinite eigenvalues (closure
        and tau rows) are dropped. With `left`, the left eigenvectors are
        normalized against -M when `normalize_left`."""
        if rebuild_matrices:
            self._rebuild()
        mats = self._group_csr(subproblem)
        L = mats["L"].toarray()
        M = mats["M"].toarray()
        out = scipy.linalg.eig(L, b=-M, left=left, **kw)
        if left:
            evals, evecs_left, evecs = out
        else:
            evals, evecs = out
        finite = np.isfinite(evals)
        self.eigenvalues = evals[finite]
        self.eigenvectors = evecs[:, finite]
        if left:
            self.left_eigenvectors = evecs_left[:, finite]
            if normalize_left:
                norms = np.einsum("ij,ij->j", np.conj(self.left_eigenvectors),
                                  -M @ self.eigenvectors)
                safe = np.where(np.abs(norms) > 0, norms, 1.0)
                self.left_eigenvectors = \
                    self.left_eigenvectors / np.conj(safe)
        self.eigenvalue_subproblem = subproblem
        return self.eigenvalues

    def solve_sparse(self, subproblem, N, target, left=False,
                     rebuild_matrices=False, **kw):
        """Sparse shift-invert eigensolve of one pencil around `target`
        (reference: core/solvers.py:225 solve_sparse)."""
        if rebuild_matrices:
            self._rebuild()
        mats = self._group_csr(subproblem)
        out = scipy_sparse_eigs(A=mats["L"], B=-mats["M"], N=N,
                                target=target, left=left, **kw)
        if left:
            self.eigenvalues, self.eigenvectors, self.left_eigenvalues, \
                self.left_eigenvectors = out
        else:
            self.eigenvalues, self.eigenvectors = out
        self.eigenvalue_subproblem = subproblem
        return self.eigenvalues

    def set_state(self, index, subproblem=None):
        """Load eigenvector `index` into the state fields on the solver's
        device (reference: core/solvers.py:296 set_state); real fields
        take the real part."""
        subproblem = subproblem or self.eigenvalue_subproblem
        G, S = self.pencil_shape
        X = torch.zeros((G, S), dtype=torch.complex128,
                        device=self.dist.device)
        X[subproblem.index] = torch.as_tensor(
            self.eigenvectors[:, index], dtype=torch.complex128).to(
                self.dist.device)
        arrays = scatter_state(self.layout, self.variables, X)
        for var in self.variables:
            data = arrays[state_key(var)]
            if not is_complex_dtype(var.dtype):
                data = data.real
            var.preset_coeff(data.to(torch_dtype(var.dtype)).contiguous())
            var.mark_modified()
