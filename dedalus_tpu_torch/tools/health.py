"""
Numerical-health monitor and divergence flight recorder for the IVP loop
(counterpart of dedalus_tpu/tools/health.py).

A cadence-gated probe over the gathered (G, S) pencil state computes, per
state field, as torch reductions on the solver's device:

  * NaN and Inf entry counts,
  * max |coefficient| and the L2 norm,
  * the spectral tail-energy fraction per basis axis: the energy in the
    top third of the modes, the mark of an under-resolved field.

The reductions of every field go into one device tensor and come back in
one host read per `CHECK_CADENCE` iterations; an off-cadence iteration
pays one gate comparison and never touches the device. A disabled
monitor runs no probe.

Failure policy: NaN/Inf anywhere in the state, or max|coefficient| above
the growth bound, is fatal. The solver halts gracefully: `proceed` turns
False, `solver.health_error` holds a structured SolverHealthError,
scheduled outputs are skipped from the detecting step on, and the
monitor dumps a flight-recorder directory (the ring of recent health
records, the metrics flush, the CFL dt history, a load_state-compatible
HDF5 state when h5py is installed, and the summary record). Tail energy
above the warn threshold logs an under-resolution warning once per
field and axis.

`check_values` (the differentiable-solve path's explicit check) and
`member_probe` (the ensemble's per-member reduction) are module-level
functions here, as the port's earlier slices use them.
"""

import json
import logging
import pathlib
import time
from collections import deque

import numpy as np
import torch

from .config import config
from .exceptions import SolverHealthError
from . import metrics as metrics_mod

logger = logging.getLogger(__name__)

__all__ = ["HealthMonitor", "SolverHealthError", "resolve",
           "read_postmortem", "format_postmortem", "check_values",
           "member_probe", "tensor_leaves"]

# Tail = top third of the resolved modes along an axis (by wavenumber
# magnitude for separable axes, by polynomial degree for coupled axes).
TAIL_FRACTION = 1.0 / 3.0
# Fields with less energy than this (L2) carry round-off only: no tail
# warning.
TAIL_ENERGY_FLOOR = 1e-10


def _jsonable(obj):
    """Non-finite floats as their repr strings ('inf', '-inf', 'nan'):
    strict JSON for a diverged state's record."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return repr(obj)
    return obj


def _fmt(value):
    if isinstance(value, (int, float)):
        return f"{value:#.4g}"
    return str(value)


def _tau_like(name):
    """Tau fields absorb boundary and gauge error and are spectrally
    broad by construction: no tail warning for them (NaN/Inf and growth
    checks still apply)."""
    return name == "tau" or name.startswith("tau_") \
        or name.startswith("_anon_")


def _axis_label(basis, axis):
    """Coordinate name of one axis of a (possibly multi-dim) basis."""
    if getattr(basis, "dim", 1) == 1:
        return basis.coord.name
    sub = axis - basis.first_axis
    names = getattr(getattr(basis, "cs", None), "names", None)
    if names is not None and sub < len(names):
        return names[sub]
    return f"axis{axis}"


class HealthMonitor:
    """
    Per-solver numerical-health state (dedalus_tpu/tools/health.py:112):
    the probe plan (built at the first probe, so a disabled monitor
    builds nothing), the ring of recent records, threshold bookkeeping
    and the flight-recorder dump.
    """

    def __init__(self, enabled=True, cadence=200, ring_size=64,
                 max_abs_limit=1e12, tail_warn_frac=0.25,
                 postmortem_dir="postmortems"):
        self.enabled = bool(enabled)
        self.solver = None
        self.cadence = int(cadence)
        self.ring = deque(maxlen=max(int(ring_size), 1))
        self.max_abs_limit = float(max_abs_limit)
        self.tail_warn_frac = float(tail_warn_frac)
        self.postmortem_dir = postmortem_dir
        self.checks = 0
        self.warnings = 0
        self.failed_reason = None
        self.postmortem_path = None
        self._plan = None
        self._warned = set()
        self._dt_dumped = False
        self._dt_sources = []     # CFL instances (dt/frequency history)

    # ------------------------------------------------------------ wiring

    @property
    def cadence(self):
        return self._cadence

    @cadence.setter
    def cadence(self, value):
        """A new cadence rebuilds the gate (re-anchored at the solver's
        current iteration when attached)."""
        self._cadence = int(value)
        self.gate = metrics_mod.CadenceGate(self._cadence)
        if self.solver is not None:
            self.gate.reset(int(self.solver.iteration))

    def attach(self, solver):
        self.solver = solver
        return self

    def reset_failure(self):
        """Clear the failure latch after a resilient rewind
        (tools/resilience.py): health_error is dropped and the gate
        re-anchors at the rewound iteration. The ring, the postmortem
        path and the counts stay."""
        self.failed_reason = None
        self._dt_dumped = False
        if self.solver is not None:
            self.solver._health_error = None
            self.gate.reset(int(self.solver.iteration))

    def attach_dt_source(self, cfl):
        """Register a CFL controller whose dt/frequency history feeds the
        flight recorder (extras.flow_tools.CFL registers itself)."""
        if cfl not in self._dt_sources:
            self._dt_sources.append(cfl)

    # ------------------------------------------------------------- probe

    def _build_specs(self):
        """Host-side probe plan: per state field, the (offset, size)
        slice of the gathered X and the tail masks per monitored basis
        axis: a separable axis's mask over the groups (G), a coupled
        axis's over the field's slot (S_f)."""
        from ..core.subsystems import state_key
        solver = self.solver
        layout = solver.layout
        groups = None
        specs = []
        offset = 0
        for v in solver.variables:
            size = layout.slot_size(v.domain, v.tensorsig)
            slot_shape = layout.slot_shape(v.domain, v.tensorsig)
            axes = []
            for axis, basis in enumerate(v.domain.bases):
                if basis is None:
                    continue
                label = _axis_label(basis, axis)
                if axis in layout.sep_widths:
                    if (getattr(basis, "dim", 1) != 1
                            or not hasattr(basis, "group_wavenumber")):
                        continue
                    n_ax = layout.sep_n_groups[axis]
                    if n_ax < 4:
                        continue
                    k = np.abs(np.asarray(basis.group_wavenumber(
                        np.arange(n_ax)), dtype=float))
                    kmax = k.max()
                    if kmax <= 0:
                        continue
                    tail_ax = k > (1.0 - TAIL_FRACTION) * kmax
                    if groups is None:
                        groups = list(layout.groups())
                    mask = np.array([tail_ax[g[axis]] for g in groups],
                                    dtype=float)
                    axes.append((label, "group", mask))
                else:
                    n_ax = slot_shape[1 + axis]
                    if n_ax < 4:
                        continue
                    idx = np.indices(slot_shape)[1 + axis].reshape(-1)
                    cut = int(np.ceil((1.0 - TAIL_FRACTION) * n_ax))
                    mask = (idx >= cut).astype(float)
                    axes.append((label, "slot", mask))
            specs.append((state_key(v), offset, size, axes))
            offset += size
        return specs

    def _ensure_plan(self):
        """The probe plan with its masks on the solver's device (once)."""
        if self._plan is None:
            solver = self.solver
            rdtype = solver.X.real.dtype if solver.X.is_complex() \
                else solver.X.dtype
            plan = []
            for name, off, size, axes in self._build_specs():
                plan.append((name, off, size, [
                    (label, kind, torch.as_tensor(mask, dtype=rdtype,
                                                  device=solver.X.device))
                    for label, kind, mask in axes]))
            self._plan = plan
        return self._plan

    def probe_tensor(self, X):
        """The probe's reductions of state X as ONE float64 device
        tensor, five entries and one per tail axis for each field: NaN
        count, Inf count, max|x|, L2 norm, tail fractions. Nothing waits
        on it."""
        out = []
        with metrics_mod.trace_scope("health", "probe"):
            for name, off, size, axes in self._ensure_plan():
                Xf = X[:, off:off + size]
                a = Xf.abs()
                a2 = a * a
                total = a2.sum()
                vals = [torch.isnan(Xf).sum().to(torch.float64),
                        torch.isinf(Xf).sum().to(torch.float64),
                        a.amax().to(torch.float64),
                        total.sqrt().to(torch.float64)]
                for label, kind, m in axes:
                    te = (a2 * m[:, None]).sum() if kind == "group" \
                        else (a2 * m[None, :]).sum()
                    vals.append(torch.where(total > 0, te / total,
                                            torch.zeros_like(te))
                                .to(torch.float64))
                out.extend(vals)
        return torch.stack(out)

    def _stats(self, values):
        """The host list of probe_tensor back into per-field stats."""
        stats = {}
        i = 0
        for name, _, _, axes in self._ensure_plan():
            nan, inf, max_abs, l2 = values[i:i + 4]
            i += 4
            tails = {}
            for label, _, _ in axes:
                tails[label] = round(float(values[i]), 6)
                i += 1
            stats[name] = {"nan": int(nan), "inf": int(inf),
                           "max_abs": float(max_abs), "l2": float(l2),
                           "tail_frac": tails}
        return stats

    # ------------------------------------------------------------- ticks

    def warm(self, X):
        """Take a baseline record at warmup end (the JAX package compiles
        its probe here)."""
        if not self.enabled or self.solver is None:
            return
        try:
            self.check(X)
        except SolverHealthError:
            raise
        except Exception as exc:
            # telemetry firewall: a probe failure disables the monitor
            # instead of killing the simulation
            logger.warning(f"health probe disabled: {exc}")
            self.enabled = False

    def tick(self, n=1):
        """Per-step hook: cadence-check the solver state. Off cadence it
        is one gate comparison; nothing touches the device."""
        if not self.enabled or self.failed_reason is not None:
            return
        solver = self.solver
        if solver is None or not self.gate.due(solver.iteration):
            return
        try:
            self.check(solver.X)
        except SolverHealthError:
            raise
        except Exception as exc:
            logger.warning(f"health probe disabled: {exc}")
            self.enabled = False

    def check(self, X=None):
        """Run the probe now (one host read), record, and evaluate the
        thresholds. Returns the health record. A fatal finding marks the
        solver (graceful halt); nothing raises from here."""
        solver = self.solver
        if X is None:
            X = solver.X
        with metrics_mod.annotate("dedalus/health/check"):
            fields = self._stats(self.probe_tensor(X).tolist())
        self.checks += 1
        record = {
            "kind": "health_sample",
            "ts": round(time.time(), 3),
            "iteration": int(solver.iteration),
            "sim_time": float(solver.sim_time),
            "dt": float(solver.dt) if solver.dt is not None else None,
            "fields": fields,
        }
        self.ring.append(record)
        self._evaluate(record)
        return record

    def nonfinite_count(self, tree, phase="values"):
        """The non-finite entry count over the tensors of `tree`: one
        device reduction and one host read, no verdict (the snapshot
        validation of tools/resilience.py)."""
        leaves = tensor_leaves(tree)
        if not leaves:
            return 0
        with metrics_mod.annotate(f"dedalus/health/{phase}"):
            return int(_nonfinite(leaves))

    def check_values(self, tree, phase="adjoint", context=None):
        """Explicit non-finite check (dedalus_tpu/tools/health.py:404):
        counts toward `checks`, runs on a disabled monitor too, raises a
        SolverHealthError naming `phase`, and never latches the monitor
        failed. Returns 0."""
        self.checks += 1
        check_values(tree, phase=phase, context=context, solver=self.solver)
        return 0

    def _evaluate(self, record):
        fatal = None
        for name, s in record["fields"].items():
            if s["nan"] or s["inf"]:
                fatal = (f"non-finite state: field '{name}' has "
                         f"{s['nan']} NaN / {s['inf']} Inf entries at "
                         f"iteration {record['iteration']}, "
                         f"sim_time {record['sim_time']:.6e}")
                break
            if np.isfinite(self.max_abs_limit) \
                    and s["max_abs"] > self.max_abs_limit:
                fatal = (f"growth bound exceeded: field '{name}' "
                         f"max|coeff| = {s['max_abs']:.3e} > "
                         f"{self.max_abs_limit:.3e} at iteration "
                         f"{record['iteration']}, "
                         f"sim_time {record['sim_time']:.6e}")
                break
            if s["l2"] > TAIL_ENERGY_FLOOR and not _tau_like(name):
                for label, frac in s["tail_frac"].items():
                    if frac > self.tail_warn_frac \
                            and (name, label) not in self._warned:
                        self._warned.add((name, label))
                        self.warnings += 1
                        logger.warning(
                            f"under-resolution: field '{name}' axis "
                            f"'{label}' holds {100 * frac:.1f}% of its "
                            f"energy in the top-third modes (warn "
                            f"threshold {100 * self.tail_warn_frac:.0f}%) "
                            f"at iteration {record['iteration']} — "
                            f"consider raising the resolution")
        if fatal:
            err = self._fail(fatal, record)
            self.solver._health_error = err
            logger.error(f"Numerical health failure, halting run: {fatal}"
                         + (f" (post-mortem: {err.postmortem_dir})"
                            if err.postmortem_dir else ""))

    # ----------------------------------------------------------- failure

    def invalid_dt(self, dt):
        """The structured error of a non-finite timestep: dumps the flight
        recorder (when enabled, once per run) and returns the
        SolverHealthError for the caller to raise. The state is not
        poisoned, so a caller catching ValueError can retry."""
        solver = self.solver
        reason = (f"Invalid timestep: dt={dt!r} is non-finite at iteration "
                  f"{solver.iteration}, sim_time {solver.sim_time:.6e} "
                  f"(adaptive-CFL frequency blow-up upstream?)")
        pm = None
        if self.enabled and not self._dt_dumped:
            self._dt_dumped = True
            try:
                pm = self.dump_postmortem(reason)
            except Exception as exc:
                logger.warning(f"flight-recorder dump failed: {exc}")
        logger.error(f"Numerical health failure: {reason}"
                     + (f" (post-mortem: {pm})" if pm else ""))
        return SolverHealthError(
            reason, iteration=int(solver.iteration),
            sim_time=float(solver.sim_time),
            record=self.ring[-1] if self.ring else None,
            postmortem_dir=str(pm) if pm else None)

    def _fail(self, reason, record=None):
        """Mark failed, dump the flight recorder, build the error."""
        self.failed_reason = reason
        pm = None
        if self.enabled:
            try:
                pm = self.dump_postmortem(reason)
            except Exception as exc:
                logger.warning(f"flight-recorder dump failed: {exc}")
        self.postmortem_path = pm
        solver = self.solver
        if record is None and self.ring:
            record = self.ring[-1]
        return SolverHealthError(
            reason,
            iteration=int(solver.iteration) if solver else None,
            sim_time=float(solver.sim_time) if solver else None,
            record=record,
            postmortem_dir=str(pm) if pm else None)

    # --------------------------------------------------- flight recorder

    def dt_history(self):
        """Recent (iteration, dt, freq_max) entries of the attached CFL
        controllers, oldest first."""
        out = []
        for src in self._dt_sources:
            out.extend(dict(e) for e in getattr(src, "history", ()))
        out.sort(key=lambda e: e.get("iteration", 0))
        return out

    def dump_postmortem(self, reason):
        """
        Write the post-mortem directory (dedalus_tpu/tools/health.py:547):
          postmortem.json       the summary record (indented)
          record.jsonl          the same record on one line
          health_ring.jsonl     the ring buffer, one record per line
          state_at_failure.h5   a load_state-compatible HDF5 state (needs
                                h5py; without it the record's
                                `checkpoint` is None and a warning says
                                why), forensic, never a restart point
        Also appends the summary record to the metrics JSONL sink when
        one is configured. Returns the directory path.
        """
        solver = self.solver
        base = pathlib.Path(self.postmortem_dir)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        stem = f"postmortem_i{int(solver.iteration):08d}_{stamp}"
        path = base / stem
        n = 0
        while path.exists():
            n += 1
            path = base / f"{stem}_{n}"
        path.mkdir(parents=True)
        self.postmortem_path = path
        with open(path / "health_ring.jsonl", "w") as f:
            for rec in self.ring:
                f.write(json.dumps(_jsonable(rec)) + "\n")
        metrics_rec = None
        try:
            metrics_rec = solver.flush_metrics()
        except Exception as exc:
            logger.warning(f"post-mortem metrics flush failed: {exc}")
        checkpoint = None
        try:
            checkpoint = self._write_checkpoint(path / "state_at_failure.h5")
        except Exception as exc:
            logger.warning(f"post-mortem checkpoint failed: {exc}")
        record = {
            "kind": "health_postmortem",
            "ts": round(time.time(), 3),
            "reason": reason,
            "iteration": int(solver.iteration),
            "sim_time": float(solver.sim_time),
            "dt": float(solver.dt) if solver.dt is not None else None,
            "checks": self.checks,
            "warnings": self.warnings,
            "ring_records": len(self.ring),
            "fields": self.ring[-1]["fields"] if self.ring else {},
            "dt_history": self.dt_history(),
            "metrics": metrics_rec,
            "checkpoint": checkpoint,
            "directory": str(path),
        }
        resilience = getattr(solver, "resilience", None)
        if resilience is not None:
            record["resilience"] = resilience.summary()
        record.update({k: v for k, v in solver.metrics.meta.items()
                       if k not in record})
        record = _jsonable(record)
        with open(path / "postmortem.json", "w") as f:
            json.dump(record, f, indent=2)
        with open(path / "record.jsonl", "w") as f:
            f.write(json.dumps(record) + "\n")
        solver.metrics.emit(record)
        return path

    def _write_checkpoint(self, path):
        """One-write HDF5 state with the FileHandler/load_state schema
        (scales/sim_time|iteration|write_number|timestep, tasks/<name> in
        grid layout)."""
        import h5py
        from ..core.subsystems import state_key
        solver = self.solver
        with h5py.File(path, "w") as f:
            scales = f.create_group("scales")
            dt = solver.dt if solver.dt is not None else np.nan
            for key, val in (("sim_time", solver.sim_time),
                             ("iteration", solver.iteration),
                             ("write_number", 1),
                             ("timestep", dt)):
                scales.create_dataset(
                    key, data=np.array([val], dtype=np.float64))
            tasks = f.create_group("tasks")
            for var in solver.state:
                var.change_scales(1)
                data = np.asarray(var["g"])
                tasks.create_dataset(state_key(var), data=data[None])
        return path.name

    # ----------------------------------------------------------- summary

    def summary(self):
        """Compact health summary for telemetry flushes (None when
        disabled and never failed)."""
        if not self.enabled and self.failed_reason is None:
            return None
        out = {"checks": self.checks, "warnings": self.warnings,
               "ok": self.failed_reason is None}
        if self.failed_reason is not None:
            out["reason"] = self.failed_reason
        if self.postmortem_path is not None:
            out["postmortem"] = str(self.postmortem_path)
        if self.ring:
            last = self.ring[-1]
            out["last_iteration"] = last["iteration"]
            out["max_abs"] = max(
                (s["max_abs"] for s in last["fields"].values()), default=0.0)
            out["max_tail_frac"] = max(
                (v for s in last["fields"].values()
                 for v in s["tail_frac"].values()), default=0.0)
        return _jsonable(out)


def resolve(spec=None, solver=None, cadence=None, ring_size=None,
            postmortem_dir=None):
    """
    A solver's `health` argument against the [health] config
    (dedalus_tpu/tools/health.py:673): a HealthMonitor passes through
    (attached to the solver); True/None build from config (None respects
    HEALTH_DEFAULT, True forces on); False builds a disabled monitor
    (still attached, so the invalid-dt error stays structured).
    """
    if isinstance(spec, HealthMonitor):
        return spec.attach(solver)
    section = config["health"] if config.has_section("health") else {}

    def get(key, fallback):
        try:
            return section.get(key, fallback) or fallback
        except AttributeError:
            return fallback

    if spec is None:
        default = str(get("HEALTH_DEFAULT", "True")).strip().lower()
        enabled = default in ("1", "true", "yes", "on")
    else:
        enabled = bool(spec)
    if cadence is None:
        cadence = int(get("CHECK_CADENCE", "200"))
    if ring_size is None:
        ring_size = int(get("RING_SIZE", "64"))
    if postmortem_dir is None:
        postmortem_dir = get("POSTMORTEM_DIR", "postmortems")
    monitor = HealthMonitor(
        enabled=enabled, cadence=cadence, ring_size=ring_size,
        max_abs_limit=float(get("MAX_ABS_LIMIT", "1e12")),
        tail_warn_frac=float(get("TAIL_WARN_FRAC", "0.25")),
        postmortem_dir=postmortem_dir)
    return monitor.attach(solver)


# ------------------------------------------------------- post-mortem reading

def read_postmortem(path):
    """A post-mortem summary record from a directory (postmortem.json /
    record.jsonl) or a record file path: (record, ring), ring the list of
    health records (empty when absent)."""
    path = pathlib.Path(path)
    if path.is_dir():
        for name in ("postmortem.json", "record.jsonl"):
            cand = path / name
            if cand.exists():
                rec_path = cand
                break
        else:
            raise FileNotFoundError(
                f"{path}: no postmortem.json or record.jsonl")
        ring_path = path / "health_ring.jsonl"
    else:
        rec_path = path
        ring_path = path.parent / "health_ring.jsonl"
    text = rec_path.read_text().strip()
    record = json.loads(text.splitlines()[0]) if rec_path.suffix == ".jsonl" \
        else json.loads(text)
    ring = []
    if ring_path.exists():
        for line in ring_path.read_text().splitlines():
            line = line.strip()
            if line:
                try:
                    ring.append(json.loads(line))
                except ValueError:
                    pass
    return record, ring


def format_postmortem(record, ring=()):
    """A post-mortem record as text lines (the JAX package's format,
    dedalus_tpu/tools/health.py:746)."""
    lines = []
    lines.append(f"Post-mortem: {record.get('reason', '(no reason recorded)')}")
    it = record.get("iteration")
    st = record.get("sim_time")
    dt = record.get("dt")
    lines.append(f"  iteration={it}  sim_time={st}  dt={dt}")
    ident = " ".join(f"{k}={record[k]}"
                     for k in ("config", "backend", "dtype")
                     if record.get(k) is not None)
    if ident:
        lines.append(f"  {ident}")
    fields = record.get("fields") or {}
    if fields:
        lines.append(f"  fields at failure ({len(fields)}):")
        for name, s in fields.items():
            tails = s.get("tail_frac") or {}
            numeric = [v for v in tails.values()
                       if isinstance(v, (int, float))]
            strings = [v for v in tails.values() if isinstance(v, str)]
            worst = strings[0] if strings else max(numeric, default=0.0)
            lines.append(
                f"    {name:<12} nan={s.get('nan', 0):<6} "
                f"inf={s.get('inf', 0):<6} "
                f"max|c|={_fmt(s.get('max_abs', 0.0))}  "
                f"L2={_fmt(s.get('l2', 0.0))}  tail={_fmt(worst)}")
    hist = record.get("dt_history") or []
    if hist:
        last = hist[-1]
        lines.append(f"  dt history: {len(hist)} entries, last "
                     f"dt={last.get('dt')} freq_max={last.get('freq_max')} "
                     f"at iteration {last.get('iteration')}")
    flow = record.get("flow") or {}
    for name, s in flow.items():
        lines.append(f"  flow {name}: {s}")
    if ring:
        lines.append(f"  ring buffer: {len(ring)} records, iterations "
                     f"{ring[0].get('iteration')}..{ring[-1].get('iteration')}")
    metrics_rec = record.get("metrics")
    if metrics_rec:
        lines.append(f"  metrics: {metrics_rec.get('iterations', 0)} "
                     f"iterations, "
                     f"{metrics_rec.get('steps_per_sec', 0.0)} steps/s")
    if record.get("checkpoint"):
        lines.append(f"  checkpoint: {record['checkpoint']} "
                     f"(state at failure — forensic, may be non-finite)")
    resilience = record.get("resilience")
    if isinstance(resilience, dict):
        lines.append(
            f"  resilience: {resilience.get('rewinds', 0)} rewind(s), "
            f"{resilience.get('retries', 0)} retry(ies)"
            + (f", resumed from {resilience['resumed_from']}"
               if resilience.get("resumed_from") else ""))
        for attempt in resilience.get("lineage") or []:
            lines.append(
                f"    attempt {attempt.get('attempt', '?')}: failed at "
                f"iteration {attempt.get('failure_iteration', '?')} "
                f"({attempt.get('reason', '?')}) -> "
                f"{attempt.get('outcome', '?')}"
                + (f" @ iteration {attempt['rewind_iteration']}, "
                   f"dt capped {_fmt(attempt.get('dt_limit'))}"
                   if attempt.get("rewind_iteration") is not None else ""))
    lines.append(f"  checks={record.get('checks', 0)} "
                 f"warnings={record.get('warnings', 0)}")
    return lines


# -------------------------------------------------- explicit value checks

def tensor_leaves(tree):
    """The tensors of a nested structure of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tensor_leaves(item)]
    return []


def _nonfinite(leaves):
    """A 0-d device count of the non-finite entries across `leaves`."""
    counts = [(~torch.isfinite(leaf)).sum() for leaf in leaves]
    return torch.stack(counts).sum() if len(counts) > 1 else counts[0]


def check_values(tree, phase="adjoint", context=None, solver=None,
                 scalar=None):
    """Raise a SolverHealthError naming `phase` when any tensor of `tree`
    holds a non-finite value (the JAX package's HealthMonitor.
    check_values): one device count and one host pull, whatever the
    number of tensors. `solver` (optional) puts its iteration and
    sim_time on the error, and its floored-pivot count
    (Solver.floored_pivots) rides the same pull into the error's reason.
    A 0-d real tensor `scalar` rides the same pull and its value is
    returned; else 0 is."""
    leaves = tensor_leaves(tree)
    if not leaves:
        return 0 if scalar is None else float(scalar)
    count = _nonfinite(leaves)
    # the solver's floored-pivot count rides the same pull
    floored = getattr(solver, "floored_pivots", None)
    pulled = [count.to(torch.float64)]
    if isinstance(floored, torch.Tensor):
        pulled.append(floored.sum().to(device=count.device,
                                       dtype=torch.float64))
    if scalar is not None:
        pulled.append(scalar.to(device=count.device, dtype=torch.float64))
    values = torch.stack(pulled).tolist() if len(pulled) > 1 \
        else [float(pulled[0])]
    count = values[0]
    n_floored = values[1] if isinstance(floored, torch.Tensor) else 0
    value = values[-1] if scalar is not None else 0
    if count:
        reason = (f"{phase}: non-finite values ({int(count)} entries across "
                  "the checked outputs)"
                  + (f"; {int(n_floored)} LU pivots floored in the last "
                     "factorization" if n_floored else "")
                  + (f" — {context}" if context else ""))
        raise SolverHealthError(
            reason,
            iteration=int(solver.iteration) if solver is not None else None,
            sim_time=float(solver.sim_time) if solver is not None else None)
    return value


def member_probe(X):
    """(non-finite count, max |x|) of each member of a member-leading
    tensor X (N, ...): two (N,) device tensors, computed on the device;
    nothing waits on them until the caller reads them."""
    flat = X.reshape(X.shape[0], -1)
    return (~torch.isfinite(flat)).sum(dim=1), flat.abs().amax(dim=1)
