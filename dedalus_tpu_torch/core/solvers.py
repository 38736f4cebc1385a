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

An IVP carries the run-side layers of the JAX package: `metrics`
(tools/metrics.py: counters, sampled phase timers, the memory watermark,
a JSONL sink), `health` (tools/health.py: the cadence-gated state probe
and the flight recorder) and `build_phases`; `evolve` runs the main loop,
`evolve_resilient` the resilient one (tools/resilience.py) and
`load_state` restores an HDF5 checkpoint. With both layers off
(`metrics=False, health=False`) a step runs what it ran before them.
"""

import contextlib
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
from .field import Field
from .future import EvalContext, Future, ev
from . import fusedstep
from . import timesteppers as timesteppers_mod
from ..libraries import matsolvers, pencilops, solvecomp
from ..tools.array import torch_dtype, to_numpy, scipy_sparse_eigs
from ..tools.config import config
from ..tools.general import is_complex_dtype
from ..tools import health as health_mod
from ..tools import metrics as metrics_mod

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
    # a banded structure's pin repair inputs, until its first factorization
    _pin_repair = None

    def __init__(self, problem, matsolver=None, matrix_coupling=None):
        self.problem = problem
        self.dist = problem.dist
        self.variables = self.matrix_variables(problem)
        if matsolver is None:
            matsolver = config["linear algebra"].get("MATRIX_SOLVER", "auto")
        self.matsolver = matsolver
        self._path, self._dense_solver = resolve_matsolver(matsolver)
        # matrix_coupling (per-axis bools) forces axes coupled beyond
        # what the NCCs require (dedalus_tpu/core/solvers.py:51, :66)
        self.layout = PencilLayout(self.dist, self.variables,
                                   problem.equations,
                                   matrix_coupling=matrix_coupling)
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
        # the [fusion] switches and the [precision]/composition plan,
        # resolved once per build, before anything is built under them:
        # the ops and the RHS evaluation plan read these, so a config edit mid-build cannot split one solver
        # across two plans; an unknown value raises here
        self._fusion_plan = fusedstep.resolve_fusion()
        self._solve_plan = solvecomp.resolve_solve_plan()
        G, S = self.pencil_shape
        dense_bytes = G * S * S * self.pencil_dtype.itemsize
        self._lazy = False
        self._pin_repair = None
        self._batched = None
        # why the banded path was refused (None: not tried, or taken)
        self._banded_reason = None
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
            t0 = time_mod.perf_counter()
            reason = self._banded_reason = self._try_banded(batched, names,
                                                            S)
            if reason is None:
                return
            self.build_seconds["refused_banded"] = \
                time_mod.perf_counter() - t0
            if self._path == "banded":
                raise ValueError("Banded solve forced but not applicable: "
                                 f"{reason}")
            msg = (f"Banded path not applicable ({reason}); using dense "
                   f"({dense_bytes / 1e9:.2f} GB)")
            if dense_bytes > 4 * cutoff:
                logger.warning(
                    msg + " — this exceeds the banded cutoff 4x; consider "
                    "lowering the coupled-axis resolution or making more "
                    "axes separable (Fourier).")
            else:
                logger.info(msg)
        t0 = time_mod.perf_counter()
        self._matrices = self._dense_from_batched(batched, names)
        self.build_seconds["host_assembly"] += time_mod.perf_counter() - t0
        self._install_plan(self._fusion_plan, self._solve_plan)
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
        t_struct = time_mod.perf_counter() - t0
        host_dtype = (np.complex128 if is_complex_dtype(self.pencil_dtype)
                      else np.float64)
        drop_tol = max(tol_abs, row_frac * (scale or 1.0))

        def band_stores():
            """The band stores under the current structure, with the
            validity closure aligned with its matching (a string: the
            reason they do not apply), and the seconds of the two."""
            t0 = time_mod.perf_counter()
            closures = []
            for row_valid, col_valid in masks:
                closure = compute_group_closure(structure, row_valid,
                                                col_valid)
                if closure is None:
                    return ("validity closure misaligned with matching",
                            0.0, 0.0)
                closures.append(closure)
            t1 = time_mod.perf_counter()
            try:
                matrices = build_banded_arrays(
                    coo_store, structure, names, host_dtype,
                    drop_tol=drop_tol, closures=closures)
            except ValueError as exc:
                matrices = str(exc)
            return matrices, t1 - t0, time_mod.perf_counter() - t1

        matrices, t_closure, t_arrays = band_stores()
        if isinstance(matrices, str):
            return matrices
        self.build_seconds["structure"] = t_struct + t_closure
        self.build_seconds["host_assembly"] += t_arrays
        self._matrices = matrices
        self.structure = structure
        structure.pin_swaps = 0
        # the pinned base is checked by the first factorization's floored
        # pivots (factor_checked); until then the repair keeps its inputs
        self._pin_repair = (acc.union, acc.qualified(),
                            np.array([m[0] for m in masks]),
                            np.array([m[1] for m in masks]),
                            coo_store, band_stores)
        self._install_plan(self._fusion_plan, self._solve_plan)
        logger.info(
            f"Pencil system: banded path (S={structure.S}, "
            f"pins={structure.t_pins}, kl={structure.kl}, "
            f"ku={structure.ku}, q={structure.q})")
        return None

    def _install_plan(self, fusion, solve_plan):
        """Put the solver under a fusion plan and a solve plan (the
        resolved [fusion] and [precision] sections:
        fusedstep.resolve_fusion, solvecomp.resolve_solve_plan): the
        device ops for them on the assembled system, banded where the
        build found a structure, else dense. The pencil build calls this
        once; a later call moves a built solver to another plan without
        assembling again."""
        self._fusion_plan, self._solve_plan = fusion, solve_plan
        if self.structure is not None:
            self.ops = pencilops.BandedOps(self.structure, self.dist.device,
                                           fusion=fusion,
                                           solve_plan=solve_plan)
        else:
            self.ops = pencilops.DenseOps(self.dist.device,
                                          self._dense_solver,
                                          solve_plan=solve_plan)

    @property
    def pencil_shape(self):
        S = sum(self.layout.slot_size(v.domain, v.tensorsig) for v in self.variables)
        return (self.layout.n_groups, S)

    def _upload_matrices(self):
        """Put the host pencil matrices on the device as the ops store
        them (self.M_mat, self.L_mat, ...), each replacing its old store
        only after that one is released."""
        for name in self.matrices:
            setattr(self, f"{name}_mat", None)
            setattr(self, f"{name}_mat", self.ops.to_device(
                self._matrices[name], self.pencil_dtype))

    def factor_checked(self, factor, coeffs):
        """
        factor() -> aux, a factorization of sum(coeffs[name] * name) under
        the current ops and device matrices. The first factorization of a
        banded structure also checks its pinned base: its floored-pivot
        count (one read from the device, once per structure) names the
        groups whose factor floored a pivot; a singular pinned base there
        is repaired one pin swap at a time (MatrixStructure.repair_pins,
        on the factored matrix), the band stores rebuilt and put on the
        device, and the factor run again. The repair stops when no group
        floors, no swap applies or a swap floors no fewer groups; a
        healthy base costs the one read. A singular base can make the
        Woodbury capacitance singular, so that the factorization raises
        after counting: the repair handles that too, and the error is
        raised again if the repair does not remove it.
        """
        pending, self._pin_repair = self._pin_repair, None
        if pending is None:
            return factor()

        def attempt():
            try:
                return factor(), None
            except torch.linalg.LinAlgError as exc:
                # without its traceback, whose frames hold the failed store
                return None, exc.with_traceback(None)

        aux, error = attempt()
        if error is not None and self._base_floored is None:
            raise error
        union, qual, rows_all, cols_all, coo_store, band_stores = pending
        structure = self.structure
        S = structure.S
        pr, pc = coo_store[0][self.matrices[0]][:2]

        def group_matrix(g):
            return sum(c * sps.csr_matrix((coo_store[g][name][2], (pr, pc)),
                                          shape=(S, S))
                       for name, c in coeffs.items())

        bad = np.flatnonzero(to_numpy(self._base_floored))
        while len(bad):
            t0 = time_mod.perf_counter()
            if not structure.repair_pins(union, qual, rows_all, cols_all,
                                         group_matrix, bad):
                break
            matrices = band_stores()[0]
            if isinstance(matrices, str):
                raise ValueError(f"pin repair: {matrices}")
            self._matrices = matrices
            self._install_plan(self._fusion_plan, self._solve_plan)
            self._upload_matrices()
            structure.pin_swaps += 1
            aux, error = attempt()
            self.build_seconds["pin_repair"] = self.build_seconds.get(
                "pin_repair", 0.0) + time_mod.perf_counter() - t0
            now = np.flatnonzero(to_numpy(self._base_floored))
            logger.info(f"Pinned base singular in {len(bad)} group(s): "
                        f"pin swap {structure.pin_swaps} leaves {len(now)}")
            if len(now) >= len(bad):
                break
            bad = now
        if error is not None:
            raise error
        return aux

    @property
    def floored_pivots(self):
        """Per-group count of the pivots below the floor in the ops' most
        recent factorization (matsolvers.count_floored_pivots): a device
        tensor, None before the first factorization. Nonzero marks a
        singular pencil; reading it waits on the device, so it is read
        where the host reads anyway (at build, tools/health)."""
        return getattr(getattr(self, "ops", None), "floored_pivots", None)

    @property
    def _base_floored(self):
        """The floored-pivot count of the pinned base alone (a banded
        factor's; the dense factors have no other): the pin repair reads
        it, since a singular capacitance over a nonsingular base is a
        singular L, which no pin swap repairs."""
        ops = getattr(self, "ops", None)
        return getattr(ops, "base_floored_pivots",
                       getattr(ops, "floored_pivots", None))

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
        Build `eval_F(X, t=None, extra_arrays=None) -> (G, S)` evaluating
        the per-equation expressions selected by `get_expr` (default: the
        member's `key` entry) on the state X at time t (a float, or a 0-d
        device tensor, as a recorded step passes it); X=None reads every
        field's own data (an NLBVP residual). Non-variable fields feeding
        the RHS (parameters, forcings; `eval_F.extra_fields`) are read at
        evaluation time, so user updates to them take effect on the next
        evaluation; `extra_arrays` (ordered as `eval_F.extra_fields`, see
        `rhs_extra`) substitutes coefficient tensors for them, as the
        differentiable path does with tensors that carry a gradient.
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

        # the non-variable fields feeding the RHS, which a recorded step
        # reads by address (dedalus_tpu/core/solvers.py:562-573)
        extra = set()
        for eq in equations:
            for member, _ in eq["members"]:
                expr = get_expr(member)
                if isinstance(expr, (Field, Future)):
                    extra |= expr.atoms(Field)
        extra -= set(variables)
        extra.discard(time_field)

        extra_fields = sorted(extra, key=lambda f: (f.name or "", id(f)))

        def eval_F(X, t=None, extra_arrays=None):
            subs = {}
            if X is not None:
                arrays = scatter_state(layout, variables, X)
                subs = {var: arrays[state_key(var)] for var in variables}
            if extra_arrays is not None:
                subs.update(zip(extra_fields, extra_arrays))
            if time_field is not None and isinstance(t, torch.Tensor):
                subs[time_field] = t.to(real).reshape((1,) * dim)
            elif time_field is not None:
                subs[time_field] = torch.full((1,) * dim, float(t or 0.0),
                                              dtype=real, device=device)
            ctx = EvalContext(subs)
            # the fused operator-chain composites of the IVP's current
            # plan, read per call: _install_plan may replace them
            ctx.fusion = getattr(self, "_fused_eval_plan", None)
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

        eval_F.extra_fields = extra_fields
        return eval_F

    def rhs_extra(self):
        """Current coefficient data of the RHS's non-variable field inputs,
        ordered as eval_F.extra_fields (dedalus_tpu/core/solvers.py:620)."""
        return [f.coeff_data() for f in self.eval_F.extra_fields]


class InitialValueSolver(SolverBase):
    """IVP solver (reference: core/solvers.py:503 InitialValueSolver)."""

    matrices = ("M", "L")
    timestepper = None

    def __init__(self, problem, timestepper, matsolver=None,
                 enforce_real_cadence=100, warmup_iterations=10,
                 matrix_coupling=None, metrics=None, metrics_file=None,
                 sample_cadence=None, health=None, health_cadence=None,
                 postmortem_dir=None):
        init_t0 = time_mod.time()
        super().__init__(problem, matsolver=matsolver,
                         matrix_coupling=matrix_coupling)
        self.build_phases = metrics_mod.BuildPhases(self.build_seconds)
        with self.build_phases.scope("factor"):
            self._upload_matrices()
        self.eval_F = self.build_rhs_evaluator("F", time_field=problem.time)
        # timestepping state and the run loop's stop conditions
        self.sim_time = 0.0
        self.initial_sim_time = 0.0
        self.iteration = 0
        self.initial_iteration = 0
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
        # step-loop metrics (tools/metrics.py): default-on per [profiling];
        # an off-cadence step pays host bookkeeping only
        self.metrics = metrics_mod.resolve(
            metrics, sink=metrics_file, cadence=sample_cadence,
            meta={"backend": self.dist.device.type,
                  "dtype": str(np.dtype(self.pencil_dtype)),
                  "pencil_shape": list(self.pencil_shape)},
            device=self.dist.device)
        self._metrics_warm_pending = False
        # an interrupted run still flushes one telemetry record
        metrics_mod.register_exit_flush(self)
        # numerical-health monitor (tools/health.py): default-on per
        # [health]; a disabled one runs no probe but keeps the structured
        # invalid-dt error
        self.health = health_mod.resolve(
            health, solver=self, cadence=health_cadence,
            postmortem_dir=postmortem_dir)
        self._health_error = None
        self._setup_time = time_mod.time() - init_t0

    def differentiable(self, wrt=("initial_state",), loss=None,
                       checkpoint_segments=None):
        """A DifferentiableIVP over this built IVP (core/adjoint.py; the
        JAX package's dedalus_tpu/core/solvers.py:1185): the loss of the
        final state after n constant-dt steps and its gradients by
        autograd through the step loop, each pencil solve's backward a
        transposed solve against the same factors, memory bounded by
        checkpointed segments."""
        from .adjoint import DifferentiableIVP
        return DifferentiableIVP(self, wrt=wrt, loss=loss,
                                 checkpoint_segments=checkpoint_segments)

    def ensemble(self, members, **kw):
        """An EnsembleSolver over this built IVP (core/ensemble.py; the JAX
        package's dedalus_tpu/core/solvers.py:1177): one step advancing
        `members` independent copies with per-member initial conditions,
        RHS parameter fields and (RK schemes) per-member dt, on this
        solver's device."""
        from .ensemble import EnsembleSolver
        return EnsembleSolver(self, members, **kw)

    def _install_plan(self, fusion, solve_plan):
        """The ops under the plans (SolverBase._install_plan), and the
        fused RHS operator chains of FUSED_TRANSFORMS: the foldable
        linear-operator nodes get host-precomposed backward-MMT @
        operator composite GEMMs (None when transform fusion is off or
        nothing folds). A built timestepper drops its factorization and
        step recording, so the next step factors under the new plan."""
        super()._install_plan(fusion, solve_plan)
        self._fused_eval_plan = fusedstep.build_eval_plan(self)
        if self.timestepper is not None:
            self.timestepper.drop_factor()

    def _install_carried(self):
        """Put carried M/L (tools/carry.py) on the device and drop the
        timestepper's factorization, so the next step factors them."""
        self._upload_matrices()
        self.timestepper.drop_factor()

    @property
    def health_error(self):
        """The SolverHealthError that halted the run (None while healthy)."""
        return self._health_error

    @property
    def proceed(self):
        """Whether to keep iterating (reference: core/solvers.py:618)."""
        if self._health_error is not None:
            # logged once at detection (health monitor): a graceful halt
            return False
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
        self.X = self.project_state(self.X)

    def project_state(self, X):
        """The projection of `enforce_hermitian_symmetry` as a pure
        function of a (G, S) state (the JAX package's `_project_body`,
        dedalus_tpu/core/solvers.py:787): an ensemble vmaps it over its
        members."""
        from .field import transform_to_grid, transform_to_coeff
        arrays = scatter_state(self.layout, self.variables, X)
        out = {}
        for v in self.variables:
            scales = tuple(v.domain.dealias)
            tdim = len(v.tensorsig)
            g = transform_to_grid(arrays[state_key(v)], v.domain, scales,
                                  tdim, tensorsig=v.tensorsig)
            out[state_key(v)] = transform_to_coeff(g, v.domain, scales, tdim,
                                                   tensorsig=v.tensorsig)
        return gather_state(self.layout, self.variables, out)

    def _end_warmup(self):
        """Warmup end (dedalus_tpu/core/solvers.py:852): a first phase
        sample and a baseline health record, then the loop window of the
        metrics and of log_stats starts. A caller of step_many alone
        reaches this before the first block has factored the LHS: the
        first sample then waits for the end of that block."""
        self._metrics_warm_pending = False
        if self.metrics.sampling:
            if not self._try_sample_phases():
                self._metrics_warm_pending = self.metrics.sampling
        self.health.warm(self.X)
        self.metrics.reset_loop()
        self._synchronize()
        self.warmup_time = time_mod.time()

    def _annotate(self, label):
        """A profiler range around a step while metrics are on; nothing
        with them off."""
        if self.metrics.enabled:
            return metrics_mod.annotate(label)
        return contextlib.nullcontext()

    def _after_steps(self, n, dt):
        """The step hooks (dedalus_tpu/core/solvers.py:909-927): fields see
        the new state, the counters advance, the metrics and health ticks
        run at their cadences, and the scheduled handlers run unless the
        health probe found the state poisoned."""
        self.defer_scatter(self.X)
        self.snapshot_versions()
        self.problem.sim_time = self.sim_time
        self.iteration += n
        self.dt = dt
        self._metrics_tick(n)
        self.health.tick(n)
        if self._health_error is None:
            # a poisoned step must not flow into scheduled outputs (no
            # NaN-filled checkpoint written as a good write)
            self.evaluator.evaluate_scheduled(
                iteration=self.iteration,
                wall_time=time_mod.time() - self.start_time,
                sim_time=self.sim_time, timestep=dt)

    def step(self, dt):
        """Advance the system by one timestep, then evaluate the handlers
        that are due (reference: core/solvers.py:683)."""
        dt = float(dt)
        if not np.isfinite(dt):
            # structured: names the iteration and dumps the flight
            # recorder; a SolverHealthError is a ValueError
            raise self.health.invalid_dt(dt)
        if self.iteration == self.warmup_iterations:
            self._end_warmup()
        # pick up user modifications of the state fields (version-tracked)
        if self.fields_dirty():
            self.X = self.gather_fields()
        # Hermitian/valid-mode re-projection cadence (reference:
        # core/solvers.py:688-692 — enforced for timestepper.steps
        # consecutive iterations so the multistep history stays consistent)
        if self.enforce_real_cadence:
            if self.iteration % self.enforce_real_cadence < self.timestepper.steps:
                self.enforce_hermitian_symmetry()
        with self._annotate("dedalus/step"):
            self.timestepper.step(dt)
        self._after_steps(1, dt)

    def step_many(self, n, dt):
        """
        Advance n constant-dt steps as one block (the JAX package's
        step_many, dedalus_tpu/core/solvers.py:929): on a CUDA solver the
        stationary steps replay one recorded CUDA graph of the step
        (core/stepgraph.py), on the CPU they loop over the same step
        body. Scheduled handlers are evaluated once at the END of the
        block, so per-step output cadences inside a block coarsen to the
        block boundary; the Hermitian re-projection runs at the block
        start when the block crosses its cadence. Use step() when
        per-step cadences or adaptive dt matter.
        """
        n = int(n)
        dt = float(dt)
        if not np.isfinite(dt):
            raise self.health.invalid_dt(dt)
        if n <= 0:
            return
        if self.iteration <= self.warmup_iterations < self.iteration + n:
            self._end_warmup()
        if self.fields_dirty():
            self.X = self.gather_fields()
        cadence = self.enforce_real_cadence
        if cadence:
            r = self.iteration % cadence
            if (n >= cadence or r < self.timestepper.steps
                    or (cadence - r) < n):
                self.enforce_hermitian_symmetry()
        with self._annotate("dedalus/step_many"):
            self.timestepper.step_many(n, dt)
        self.metrics.inc("step_many_blocks")
        self._after_steps(n, dt)

    # -------------------------------------------------------------- metrics

    def _metrics_tick(self, n):
        """Per-step metrics hook: count iterations (no device wait) and
        run the cadence-gated phase sample, the only point that waits for
        the device, every SAMPLE_CADENCE-th post-warmup iteration."""
        m = self.metrics
        if not m.enabled:
            return
        m.observe_steps(n)
        if not (m.sampling and self.warmup_time is not None):
            return
        if self._metrics_warm_pending:
            # deferred first sample (a caller of step_many alone): sample now
            # and re-anchor the loop window past the factoring block
            self._metrics_warm_pending = False
            self._try_sample_phases()
            m.reset_loop()
            return
        if m.due():
            self._try_sample_phases()

    def _try_sample_phases(self):
        """_sample_phases behind a telemetry firewall: a failing sample
        turns sampling off with a warning instead of ending the run.
        Returns whether a sample was recorded."""
        try:
            return self._sample_phases()
        except Exception as exc:
            logger.warning(f"metrics phase sampling disabled: {exc}")
            self.metrics.sampling = False
            return False

    def _sample_phases(self):
        """
        One phase sample (dedalus_tpu/core/solvers.py:1015): wait for the
        device, then wall-time the step pieces (the timestepper's probes
        and the dealiased transform roundtrip) on the current state, each
        between two device synchronizations. The transform share of the
        RHS evaluation is measured by the roundtrip and subtracted, so
        transform/evaluator/matsolve/transpose sum to about one step. The
        solve probe launches the substitution kernel on the banded path.
        Returns True when a sample was recorded (False: no factor yet).
        """
        m = self.metrics
        probes = self.timestepper.phase_probes()
        if probes is None:
            return False
        with metrics_mod.annotate("dedalus/metrics/sample"):
            m.synchronize()
            scale = float(getattr(self.timestepper, "stages", 1) or 1)
            X = self.X
            times = {name: m.time_thunk(name, thunk) * s
                     for name, (thunk, s) in probes.items()}
            trans = m.time_thunk("transform",
                                 lambda: self.project_state(X)) * scale
            rhs = times.get("rhs_eval", 0.0)
            trans = min(trans, rhs) if rhs else trans
            m.add_phase_sample({
                "transform": trans,
                "evaluator": max(rhs - trans, 0.0),
                "matsolve": times.get("matsolve", 0.0),
                "transpose": times.get("transpose", 0.0),
            })
        return True

    def flush_metrics(self, extra=None):
        """Wait for the device (so the loop window covers the queued
        work) and flush one telemetry record, appended to the JSONL sink
        when one is set; the health summary, the resilience summary, the
        build phases and the plan ride along (dedalus_tpu/core/
        solvers.py:1057). Returns the record dict."""
        self._synchronize()
        extra = dict(extra or {})
        health_summary = self.health.summary()
        if health_summary is not None:
            extra.setdefault("health", health_summary)
        resilience = getattr(self, "resilience", None)
        if resilience is not None:
            extra.setdefault("resilience", resilience.summary())
        extra.setdefault("build_phases", self.build_phases.record())
        extra.setdefault("plan", self.plan_provenance())
        return self.metrics.flush(extra=extra)

    # ----------------------------------------------------------- run loops

    def evolve(self, timestep_function=None, log_cadence=100):
        """Run the main loop to completion (reference: core/solvers.py:713;
        dedalus_tpu/core/solvers.py:1198)."""
        try:
            while self.proceed:
                dt = timestep_function() if timestep_function else self.dt
                if dt is None:
                    raise ValueError(
                        "evolve() requires a timestep_function, or a prior "
                        "solver.step(dt) to set the timestep.")
                self.step(dt)
                if self.iteration % log_cadence == 0:
                    logger.info(f"Iteration={self.iteration}, "
                                f"Time={self.sim_time:.6e}, dt={dt:.6e}")
            if self._health_error is not None:
                logger.error(
                    f"Main loop halted by health monitor: "
                    f"{self._health_error.reason} (error available as "
                    f"solver.health_error)")
        except Exception:
            logger.error("Exception raised, triggering end of main loop.")
            raise
        finally:
            self.log_stats()

    def evolve_resilient(self, timestep_function=None, dt=None,
                         log_cadence=100, **kw):
        """
        Run the main loop under the resilient loop
        (tools/resilience.ResilientLoop; dedalus_tpu/core/solvers.py:1156):
        a ring of state snapshots, rewind with dt backoff on a
        SolverHealthError, SIGTERM/SIGINT-safe durable checkpoints with
        validated resume, the SDC sentinel and transient-IO retry. Keyword
        arguments (snapshot_cadence, max_retries, dt_backoff,
        checkpoint_dir, checkpoint_format, resume, sdc_cadence, chaos,
        ...) configure the loop; defaults come from [resilience]. Returns
        the loop's summary dict.
        """
        from ..tools.resilience import ResilientLoop
        loop = ResilientLoop(self, timestep_function=timestep_function,
                             dt=dt, **kw)
        try:
            return loop.run(log_cadence=log_cadence)
        finally:
            self.log_stats()

    # ---------------------------------------------------------- checkpoints

    def load_state(self, path, index=-1, allow_missing=False,
                   fallback=False):
        """Restore state from an HDF5 checkpoint (reference:
        core/solvers.py:632 load_state; dedalus_tpu/core/solvers.py:1238).
        A truncated or corrupt file raises a CheckpointError naming the
        file and write index. With `fallback=True` a corrupt write falls
        back to the previous writes of the same file (the newest
        surviving write wins); tools.resilience.resume_latest extends the
        fallback across set files. Returns (write number, dt). Needs
        h5py."""
        import h5py
        from ..tools.exceptions import CheckpointError
        try:
            f = h5py.File(path, "r")
        except OSError as exc:
            raise CheckpointError(
                f"checkpoint {path} unreadable (truncated or corrupt): "
                f"{exc}", path=path) from exc
        with f:
            try:
                n_writes = len(f["scales/write_number"])
            except KeyError as exc:
                raise CheckpointError(
                    f"checkpoint {path} has no scales/write_number "
                    f"(not a handler file?)", path=path) from exc
            if n_writes == 0:
                raise CheckpointError(
                    f"checkpoint {path} has an empty write index",
                    path=path)
            start = index if index >= 0 else n_writes + index
            if not 0 <= start < n_writes:
                raise CheckpointError(
                    f"checkpoint {path}: write index {index} out of range "
                    f"({n_writes} writes)", path=path, index=index)
            candidates = range(start, -1, -1) if fallback else (start,)
            failures = []
            for idx in candidates:
                try:
                    self._load_write(f, path, idx, allow_missing)
                except CheckpointError as exc:
                    if not fallback:
                        raise
                    failures.append(str(exc))
                    logger.warning(f"checkpoint write unusable, "
                                   f"falling back: {exc}")
                    continue
                if failures:
                    logger.info(f"loaded write {idx} of {path} after "
                                f"{len(failures)} fallback(s)")
                write = int(np.asarray(f["scales/write_number"])[idx])
                break
            else:
                raise CheckpointError(
                    f"checkpoint {path}: no loadable write at or before "
                    f"index {index} ({'; '.join(failures)})",
                    path=path, index=index)
        self.X = self.gather_fields()
        return write, self.dt

    def _load_write(self, f, path, idx, allow_missing):
        """Load ONE write of an open checkpoint file into the solver; a
        data-level corruption (h5py OSError/ValueError) becomes a
        CheckpointError. The clocks are set only after every field read
        back."""
        from ..tools.exceptions import CheckpointError
        try:
            sim_time = float(np.asarray(f["scales/sim_time"])[idx])
            iteration = int(np.asarray(f["scales/iteration"])[idx])
            dt = float(np.asarray(f["scales/timestep"])[idx]) \
                if "scales/timestep" in f else None
            tasks = f["tasks"]
            data = {}
            for var in self.state:
                if var.name not in tasks:
                    if allow_missing:
                        continue
                    raise KeyError(
                        f"State variable {var.name} not found in {path}")
                ds = tasks[var.name]
                if len(ds) <= idx:
                    raise CheckpointError(
                        f"checkpoint {path} write {idx}: task "
                        f"'{var.name}' has only {len(ds)} write(s) "
                        f"(torn write)", path=path, index=idx)
                layout = ds.attrs.get("layout", "g")
                if isinstance(layout, bytes):
                    layout = layout.decode()
                data[var.name] = (layout, np.asarray(ds[idx]))
        except CheckpointError:
            raise
        except (OSError, ValueError, IndexError) as exc:
            raise CheckpointError(
                f"checkpoint {path} write {idx} unreadable: {exc}",
                path=path, index=idx) from exc
        for var in self.state:
            if var.name in data:
                layout, arr = data[var.name]
                var[layout if layout in ("c", "g") else "g"] = arr
        self.sim_time = self.initial_sim_time = sim_time
        self.iteration = self.initial_iteration = iteration
        self.dt = dt
        logger.info(f"Loading iteration: {iteration} (write index {idx})")

    def log_stats(self, format=".4g"):
        """Log run statistics with the reference's throughput metric,
        mode-stages per second over the iterations after warmup
        (reference: core/solvers.py:755-778 log_stats), the sampled phase
        table and the health summary."""
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
        plan = self.plan_provenance()
        logger.info("Plan: " + ", ".join(
            f"{k} {v}" for k, v in plan.items()))
        if self._solve_plan.dtype != "native":
            logger.info("Precision: " + ", ".join(
                f"{k} {v}" for k, v in self._precision_summary().items()))
        if self.metrics.enabled:
            record = self.flush_metrics()
            if record and record.get("phase_samples"):
                for line in metrics_mod.format_phase_table(record):
                    logger.info(line)
        health_summary = self.health.summary()
        if health_summary is not None:
            status = "ok" if health_summary.get("ok") else \
                f"FAILED ({health_summary.get('reason')})"
            logger.info(f"Health: {status}, "
                        f"{health_summary.get('checks', 0)} checks, "
                        f"{health_summary.get('warnings', 0)} warnings")

    def plan_provenance(self):
        """The execution plan this solver was built under (resolved once
        per build): the fusion switches, the solve composition and the
        precision ladder (dedalus_tpu/core/solvers.py:1097)."""
        fusion, solve = self._fusion_plan, self._solve_plan
        return {"fusion": {"solve": fusion.solve, "matvec": fusion.matvec,
                           "transforms": fusion.transforms},
                "fused_nodes": len(self._fused_eval_plan or ()),
                "solve_composition": solve.composition,
                "solve_dtype": solve.dtype,
                "refine_sweeps": solve.sweeps,
                "spike_chunks": solve.spike_chunks}

    def _precision_summary(self):
        """The resolved solve plan and the achieved relative residual of a
        probe solve of the current state against the current LHS
        factorization (absent until the first factor; one read from the
        device), as one block (dedalus_tpu/core/solvers.py:1130)."""
        plan = self._solve_plan
        block = {
            "solve_dtype": plan.dtype,
            "composition": plan.composition,
            "refine_sweeps": plan.sweeps if plan.sweeps is not None
            else getattr(self.ops, "refine", None),
            "refine_tol": plan.tol,
        }
        aux = self.timestepper._lhs_aux
        if aux is None:
            return block
        aux0 = aux[0] if isinstance(aux, list) else aux
        _, rel = self.ops.solve_report(aux0, self.X,
                                       mats=(self.M_mat, self.L_mat))
        if rel is not None:
            block["achieved_residual"] = float(rel)
        return block


class LinearBoundaryValueSolver(SolverBase):
    """LBVP solver (dedalus_tpu/core/solvers.py:1400; reference:
    core/solvers.py:324): L is factored once at build time; each `solve`
    evaluates F, masks the invalid rows, solves and scatters, all queued
    on the device without waiting for it."""

    matrices = ("L",)

    def __init__(self, problem, matsolver=None, matrix_coupling=None):
        super().__init__(problem, matsolver=matsolver,
                         matrix_coupling=matrix_coupling)
        self._factor_L()
        self.eval_F = self.build_rhs_evaluator("F")
        self.iteration = 0

    def _factor_L(self):
        self._upload_matrices()
        self._aux = self.factor_checked(lambda: self.ops.factor(self.L_mat),
                                        {"L": 1.0})
        # the build reads the floored-pivot count (a singular pencil)
        floored = self.floored_pivots
        if floored is not None:
            groups = int((floored > 0).sum())
            if groups:
                logger.warning(f"{groups} pencil group(s) of L have pivots "
                               "below the floor (a singular pencil): the "
                               "solve returns a bounded member of the "
                               "solution set")

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

    def __init__(self, problem, matsolver=None, matrix_coupling=None):
        super().__init__(problem, matsolver=matsolver,
                         matrix_coupling=matrix_coupling)
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
        self.L_mat = None
        self._build_pencil_system()
        self._upload_matrices()
        aux = self.factor_checked(lambda: self.ops.factor(self.L_mat),
                                  {"L": 1.0})
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

    def __init__(self, problem, matsolver=None, matrix_coupling=None):
        super().__init__(problem, matsolver=matsolver,
                         matrix_coupling=matrix_coupling)
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
