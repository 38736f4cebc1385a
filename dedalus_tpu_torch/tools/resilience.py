"""
Resilient solve loop: snapshot rewind with dt backoff, preemption-safe
checkpoints, the silent-corruption sentinel and transient-IO retry
(counterpart of dedalus_tpu/tools/resilience.py).

A `ResilientLoop` (surfaced as `solver.evolve_resilient(...)`) wraps the
stepping loop with these layers:

  1. **Snapshot ring**: the last-known-good states, captured every
     `SNAPSHOT_CADENCE` iterations. The JAX package's ring holds
     references to immutable arrays; a torch step writes its state in
     place (a replayed CUDA graph writes into static buffers), so a
     snapshot here holds DEVICE COPIES of X and the multistep histories,
     taken in the device stream's order: capture waits for nothing.
  2. **Rewind + dt backoff**: on a SolverHealthError (NaN/Inf state,
     growth bound, non-finite dt) the loop rewinds to the newest finite
     snapshot, caps the timestep at `DT_BACKOFF` times the one that
     failed (the refactor at the new dt follows), waits an exponential
     backoff and retries, up to `MAX_RETRIES` consecutive failures. The
     cap relaxes by `DT_RECOVERY` per clean snapshot cadence.
  3. **Preemption safety**: SIGTERM/SIGINT request a graceful stop: the
     current step completes, a final durable checkpoint is written and
     `run()` returns with `stopped_by` set. `resume_latest(...)` finds,
     validates and loads the newest good checkpoint, falling back write
     by write and set by set.
  4. **Transient-IO retry**: checkpoint writes and telemetry go through a
     `RetryPolicy` that retries transient OSErrors with backoff and
     raises structural ones at once.
  5. **Sharded, asynchronous checkpoints**: `CHECKPOINT_FORMAT = sharded`
     writes the `dedalus-sharded-v1` format (tools/dcheckpoint.py);
     with `CHECKPOINT_ASYNC` the step loop pays a device clone and a
     submit, and a background writer does the host copy and the IO. The
     stall is measured per write (`resilience/checkpoint_stall_sec`).
  6. **SDC sentinel**: every `SDC_CADENCE` iterations the loop captures
     an anchor, steps, re-executes that step from the anchor (with an
     LHS refactor) and compares value-exactly, NaN-aware, in one host
     read. A mismatch raises a SilentCorruptionError with a flight
     recording and rewinds to the anchor without a dt backoff.

Everything is counted under `resilience/...` in the solver's metrics
(rewinds, retries, dt_backoffs, snapshots, io_retries,
checkpoints_written/validated, checkpoint_stall_sec, sdc_checks,
sdc_detected, resumes) and summarized in `summary()`. tools/chaos.py
drives every branch deterministically.
"""

import errno
import json
import logging
import os
import pathlib
import signal
import time

import torch

from .config import config
from .exceptions import (CheckpointError, SilentCorruptionError,
                         SolverHealthError)
from . import dcheckpoint
from . import metrics as metrics_mod

logger = logging.getLogger(__name__)

__all__ = ["ResilientLoop", "RetryPolicy", "SilentCorruptionError",
           "Snapshot", "SnapshotRing", "capture_snapshot",
           "restore_snapshot", "resume_latest", "validate_checkpoint",
           "io_retry_policy", "jsonable_summary"]


# --------------------------------------------------------------- IO retry

# errnos that indicate a *structural* problem retrying cannot fix
_PERSISTENT_ERRNOS = frozenset({
    errno.ENOENT, errno.EACCES, errno.EPERM, errno.EISDIR, errno.ENOTDIR,
    errno.EROFS, errno.ENAMETOOLONG,
})


class RetryPolicy:
    """
    Retry-with-backoff classification for transient host/IO faults.

    `call(fn)` runs `fn`, retrying on *transient* failures (OSError whose
    errno is not structurally persistent) with exponential wall-clock
    backoff, up to `max_attempts` total attempts. Non-transient
    exceptions — and transient ones past the attempt budget — propagate.
    `on_retry(attempt, exc)` observes each retry (the metrics hook).
    """

    def __init__(self, max_attempts=3, base_delay=0.05, max_delay=2.0,
                 on_retry=None):
        self.max_attempts = max(int(max_attempts), 1)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.on_retry = on_retry

    @staticmethod
    def is_transient(exc):
        """Classify one exception: worth retrying?"""
        if isinstance(exc, OSError):
            return exc.errno not in _PERSISTENT_ERRNOS
        return False

    def delay(self, attempt):
        """Backoff before retry `attempt` (1-based): base * 2^(attempt-1),
        capped."""
        return min(self.base_delay * (2.0 ** (attempt - 1)), self.max_delay)

    def call(self, fn, label="io"):
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except Exception as exc:
                if attempt >= self.max_attempts or not self.is_transient(exc):
                    raise
                delay = self.delay(attempt)
                logger.warning(
                    f"transient {label} fault (attempt {attempt}/"
                    f"{self.max_attempts}): {exc}; retrying in {delay:.3g}s")
                if self.on_retry is not None:
                    self.on_retry(attempt, exc)
                time.sleep(delay)


# -------------------------------------------------------------- snapshots

class Snapshot:
    """
    One last-known-good state capture (dedalus_tpu/tools/resilience.py:
    212). A step writes its state in place (a replayed CUDA graph writes
    into static buffers), so the state and the multistep histories are
    device COPIES, taken in the order of the device's stream: capture
    waits for nothing. Host metadata: sim_time/iteration/dt, the
    timestepper's bookkeeping and the evaluator scheduling counters.
    """

    __slots__ = ("X", "sim_time", "iteration", "dt", "timestepper_state",
                 "evaluator_state", "_finite", "_probe")

    def __init__(self, X, sim_time, iteration, dt, timestepper_state,
                 evaluator_state, probe=None):
        self.X = X
        self.sim_time = sim_time
        self.iteration = iteration
        self.dt = dt
        self.timestepper_state = timestepper_state
        self.evaluator_state = evaluator_state
        self._finite = None
        self._probe = probe

    def is_finite(self):
        """Whether the captured state is fully finite: one device
        reduction and one host read (the HealthMonitor's
        `nonfinite_count`), only on the recovery path."""
        if self._finite is None:
            if self._probe is not None:
                self._finite = self._probe(self.X) == 0
            else:
                self._finite = bool(torch.isfinite(self.X).all())
        return self._finite


def capture_snapshot(solver):
    """The solver's current state as a Snapshot: device copies of X and
    of the timestepper state (Timestepper.capture_state), with no host
    wait. The attached HealthMonitor's non-finite count rides along for
    a later `is_finite()`."""
    health = getattr(solver, "health", None)
    return Snapshot(
        X=solver.X.clone(),
        sim_time=float(solver.sim_time),
        iteration=int(solver.iteration),
        dt=float(solver.dt) if solver.dt is not None else None,
        timestepper_state=solver.timestepper.capture_state(),
        evaluator_state=[h.schedule_state()
                         for h in solver.evaluator.handlers],
        probe=health.nonfinite_count if health is not None else None)


def restore_snapshot(solver, snap):
    """Rewind the solver to a snapshot: state, clocks, timestepper state
    and evaluator scheduling counters (copies: the snapshot stays valid
    for a second rewind). The LHS factorization is dropped (the next
    step refactors for its own dt) and the health monitor's failure latch
    is cleared."""
    solver.X = snap.X.clone()
    solver.sim_time = snap.sim_time
    solver.iteration = snap.iteration
    solver.dt = snap.dt
    solver.problem.sim_time = snap.sim_time
    solver.timestepper.restore_state(snap.timestepper_state)
    for handler, state in zip(solver.evaluator.handlers,
                              snap.evaluator_state):
        handler.restore_schedule_state(state)
    # the fields see the rewound state (lazy pulls, version-synced)
    solver.defer_scatter(solver.X)
    solver.snapshot_versions()
    solver.health.reset_failure()


class SnapshotRing:
    """Bounded ring of Snapshots, newest last."""

    def __init__(self, size=4):
        self.size = max(int(size), 1)
        self._ring = []

    def __len__(self):
        return len(self._ring)

    @property
    def newest(self):
        return self._ring[-1] if self._ring else None

    def push(self, snap):
        self._ring.append(snap)
        del self._ring[:-self.size]

    def pop_newest_finite(self):
        """Pop and return the newest snapshot whose state is finite,
        discarding poisoned ones (a snapshot taken between the true onset
        and the probe's detection can already carry NaNs). None when the
        whole ring is poisoned or empty."""
        while self._ring:
            snap = self._ring.pop()
            if snap.is_finite():
                return snap
            logger.warning(
                f"snapshot at iteration {snap.iteration} is non-finite; "
                "discarding and rewinding further")
        return None


# -------------------------------------------------- checkpoint validation

def validate_checkpoint(path):
    """
    Integrity-check one checkpoint set file. Returns (n_valid_writes,
    reason): n_valid_writes is the number of trailing-consistent writes
    (0 = unusable), reason explains a rejection. Detects crash-truncated
    files (h5py cannot open them) and torn writes (task datasets shorter
    than the scales cursor — the write died between resizes).
    """
    import h5py
    try:
        with h5py.File(path, "r") as f:
            if "scales/write_number" not in f:
                return 0, "no scales/write_number"
            n = len(f["scales/write_number"])
            if n == 0:
                return 0, "empty write index"
            if "tasks" not in f or not len(f["tasks"]):
                return 0, "no task datasets"
            n_tasks = min(len(f["tasks"][name]) for name in f["tasks"])
            if n_tasks < n:
                return n_tasks, (f"torn write: scales cursor at {n}, "
                                 f"shortest task at {n_tasks}")
            return n, None
    except OSError as exc:
        return 0, f"unreadable (truncated/corrupt?): {exc}"


def resume_latest(solver, base_path, metrics=None):
    """
    Restore the solver from the newest valid checkpoint under
    `base_path` (a FileHandler output directory). Walks the numbered set
    files newest-first, validating each (`validate_checkpoint`) and
    falling back write-by-write within a set (`load_state(...,
    fallback=True)`), so a crash-truncated or torn newest write resumes
    from the previous good one. Returns a resume-event dict, or None
    when no checkpoint directory/sets exist (fresh start). Raises
    CheckpointError when sets exist but none are loadable.
    """
    from .post import get_assigned_sets
    base_path = pathlib.Path(base_path)
    if not base_path.is_dir():
        return None
    sets = get_assigned_sets(base_path)
    if not sets:
        return None
    rejected = []
    for path in reversed(sets):
        n_valid, reason = validate_checkpoint(path)
        if metrics is not None:
            metrics.inc("resilience/checkpoints_validated")
        if n_valid == 0:
            logger.warning(f"checkpoint {path} rejected: {reason}")
            rejected.append({"path": str(path), "reason": reason})
            continue
        try:
            # index clamped to the validated prefix: a torn final write
            # is skipped even though its scales row exists
            write, dt = solver.load_state(path, index=n_valid - 1,
                                          fallback=True)
        except CheckpointError as exc:
            logger.warning(f"checkpoint {path} unloadable: {exc}")
            rejected.append({"path": str(path), "reason": str(exc)})
            continue
        event = {
            "path": str(path),
            "write": int(write),
            "iteration": int(solver.iteration),
            "sim_time": float(solver.sim_time),
            "dt": dt,
            "fallbacks": rejected,
        }
        if reason is not None:
            event["validation"] = reason
        logger.info(
            f"resumed from {path} (write {write}, iteration "
            f"{solver.iteration}, sim_time {solver.sim_time:.6e})"
            + (f" after skipping {len(rejected)} bad set(s)"
               if rejected else ""))
        return event
    raise CheckpointError(
        f"no loadable checkpoint under {base_path} "
        f"({len(rejected)} set(s) rejected: "
        f"{'; '.join(r['reason'] for r in rejected)})",
        path=str(base_path))


# ---------------------------------------------------------- the main loop

def _cfg(key, fallback):
    section = config["resilience"] if config.has_section("resilience") else {}
    try:
        return section.get(key, fallback) or fallback
    except AttributeError:
        return fallback


def _as_bool(value):
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    return bool(value)


def io_retry_policy(on_retry=None):
    """The [resilience]-configured transient-IO RetryPolicy — the single
    construction point for checkpoint writes AND telemetry-sink emits
    (tools/metrics.py), so IO_RETRIES/IO_BASE_DELAY govern both."""
    return RetryPolicy(max_attempts=int(_cfg("IO_RETRIES", "3")),
                       base_delay=float(_cfg("IO_BASE_DELAY", "0.05")),
                       on_retry=on_retry)


class ResilientLoop:
    """
    The loop around `solver.step` with snapshot rewind, dt backoff,
    preemption-safe checkpointing, and transient-IO retry. Build one via
    `solver.evolve_resilient(...)` (which constructs and runs it) or
    directly for finer control; `run()` returns a summary dict.

    Parameters (None pulls the [resilience] config default):
      timestep_function — adaptive dt callable (e.g. CFL.compute_timestep);
          its output is capped by the post-rewind backoff limit.
      dt — constant timestep when no timestep_function is given.
      snapshot_cadence — iterations between ring captures.
      ring_size — snapshots retained.
      max_retries — consecutive recoveries before escalating.
      dt_backoff — dt shrink factor per recovery (< 1).
      dt_recovery — dt cap growth factor per clean snapshot cadence (> 1).
      retry_base_delay — wall backoff base between recoveries (doubles
          per consecutive retry).
      checkpoint_dir — durable checkpoint directory (None disables
          durable checkpoints AND resume; preemption then stops without
          a final write).
      checkpoint_iter — iterations between durable checkpoints (0: only
          the final preemption/completion write).
      checkpoint_format — "hdf5" (the evaluator FileHandler path) or
          "sharded" (tools/dcheckpoint.py: per-shard files + blake2b
          checksums + manifest-last commit).
      checkpoint_async — sharded format only: a device clone in the
          step loop, then host copy-out + IO on a background writer
          thread with a bounded in-flight budget (CHECKPOINT_INFLIGHT).
      sdc_cadence — iterations between silent-corruption sentinel
          checks (0 disables): each check re-executes the step just
          taken from an anchor snapshot and compares value-exactly.
      resume — locate/validate/load the newest checkpoint before
          starting (ignored without checkpoint_dir; the format is
          auto-detected from what the directory holds, so a run can
          migrate formats across restarts).
      chaos — a tools/chaos.ChaosInjector exercised by tests.
      install_signal_handlers — trap SIGTERM/SIGINT for the run (the
          previous handlers are restored on exit). With False a caller
          drives `request_stop` itself.
      step_hook — callable(solver) invoked after every successfully
          completed step (never after a failed/rewound one); it must not
          mutate the solver.
      flush_telemetry — flush one telemetry record when the loop exits
          (default); False leaves the flush to the caller.
    """

    def __init__(self, solver, timestep_function=None, dt=None,
                 snapshot_cadence=None, ring_size=None, max_retries=None,
                 dt_backoff=None, dt_recovery=None, retry_base_delay=None,
                 checkpoint_dir=None, checkpoint_iter=None,
                 checkpoint_format=None, checkpoint_async=None,
                 checkpoint_inflight=None, checkpoint_keep=None,
                 sdc_cadence=None, resume=False,
                 chaos=None, install_signal_handlers=True, step_hook=None,
                 flush_telemetry=True):
        self.solver = solver
        self.timestep_function = timestep_function
        self.dt = float(dt) if dt is not None else None
        self.snapshot_cadence = int(snapshot_cadence
                                    if snapshot_cadence is not None
                                    else _cfg("SNAPSHOT_CADENCE", "50"))
        self.max_retries = int(max_retries if max_retries is not None
                               else _cfg("MAX_RETRIES", "3"))
        self.dt_backoff = float(dt_backoff if dt_backoff is not None
                                else _cfg("DT_BACKOFF", "0.5"))
        self.dt_recovery = float(dt_recovery if dt_recovery is not None
                                 else _cfg("DT_RECOVERY", "2.0"))
        self.retry_base_delay = float(
            retry_base_delay if retry_base_delay is not None
            else _cfg("RETRY_BASE_DELAY", "0.05"))
        self.ring = SnapshotRing(int(ring_size if ring_size is not None
                                     else _cfg("RING_SNAPSHOTS", "4")))
        self.io_retry = io_retry_policy(
            on_retry=lambda attempt, exc:
                solver.metrics.inc("resilience/io_retries"))
        self.checkpoint_dir = (pathlib.Path(checkpoint_dir)
                               if checkpoint_dir else None)
        self.checkpoint_iter = int(checkpoint_iter
                                   if checkpoint_iter is not None
                                   else _cfg("CHECKPOINT_ITER", "0"))
        self.checkpoint_format = str(
            checkpoint_format if checkpoint_format is not None
            else _cfg("CHECKPOINT_FORMAT", "hdf5")).strip().lower()
        if self.checkpoint_format not in ("hdf5", "sharded"):
            raise ValueError(
                f"checkpoint_format must be 'hdf5' or 'sharded', got "
                f"{self.checkpoint_format!r}")
        self.checkpoint_async = _as_bool(
            checkpoint_async if checkpoint_async is not None
            else _cfg("CHECKPOINT_ASYNC", "False"))
        if self.checkpoint_async and self.checkpoint_format != "sharded":
            raise ValueError(
                "checkpoint_async requires checkpoint_format='sharded' "
                "(the HDF5 FileHandler path is synchronous by design)")
        self.checkpoint_inflight = int(
            checkpoint_inflight if checkpoint_inflight is not None
            else _cfg("CHECKPOINT_INFLIGHT", "2"))
        self.checkpoint_keep = int(
            checkpoint_keep if checkpoint_keep is not None
            else _cfg("CHECKPOINT_KEEP", "2"))
        self.sdc_cadence = int(sdc_cadence if sdc_cadence is not None
                               else _cfg("SDC_CADENCE", "0"))
        self._sdc_gate = metrics_mod.CadenceGate(self.sdc_cadence)
        self._ckpt_gate = metrics_mod.CadenceGate(self.checkpoint_iter)
        self.sdc_checks = 0
        self.sdc_detected = 0
        self.checkpoint_stall_sec = 0.0
        self._checkpointer = None
        self._compare_prog = None
        self.resume = bool(resume)
        self.chaos = chaos
        self.install_signal_handlers = bool(install_signal_handlers)
        self.step_hook = step_hook
        self.flush_telemetry = bool(flush_telemetry)
        # recovery bookkeeping
        self.rewinds = 0
        self.retries = 0
        self.snapshots_captured = 0
        self.dt_limit = None          # post-rewind dt cap (None: unlimited)
        self._consecutive = 0
        self._last_failure_iter = None
        self.lineage = []             # one entry per recovery attempt
        self.resume_event = None
        # wall seconds of the recovery paths (the port's addition): a
        # resume's load, each rewind through the end of the first step
        # after it (its refactor included; that step waits for the
        # device), each SDC check (its re-executed step and refactor
        # included: the comparison reads the host)
        self.timing = {"resume_sec": None, "rewind_sec": [],
                       "sdc_check_sec": []}
        self._rewind_t0 = None
        self.stopped_by = None
        self._stop_signal = None
        self._checkpoint_handler = None
        solver.resilience = self
        if chaos is not None:
            chaos.attach(self)

    # ------------------------------------------------------- checkpoints

    def _ensure_checkpoint_handler(self):
        """The durable-checkpoint FileHandler: one write per set file
        (a crash can at worst truncate the newest set — exactly what
        resume_latest validates), append-mode numbering across restarts,
        coefficient-layout tasks so restore is bitwise."""
        if self._checkpoint_handler is None:
            handler = self.solver.evaluator.add_file_handler(
                self.checkpoint_dir, max_writes=1, mode="append",
                iter=self.checkpoint_iter or None)
            handler.io_retry = self.io_retry
            for var in self.solver.state:
                handler.add_task(var, layout="c", name=var.name)
            self._checkpoint_handler = handler
        return self._checkpoint_handler

    def _ensure_checkpointer(self):
        """The sharded-checkpoint writer (tools/dcheckpoint.py): per-shard
        commit with the transient-IO retry policy inside the writer, so
        async writes retry on their own thread under the same
        IO_RETRIES/IO_BASE_DELAY budget as everything else."""
        if self._checkpointer is None:
            self._checkpointer = dcheckpoint.ShardedCheckpointer(
                self.checkpoint_dir, async_write=self.checkpoint_async,
                inflight=self.checkpoint_inflight, keep=self.checkpoint_keep,
                io_retry=io_retry_policy(on_retry=lambda attempt, exc:
                    self.solver.metrics.inc("resilience/io_retries")))
            if self.chaos is not None:
                wire = getattr(self.chaos, "wire_checkpointer", None)
                if wire is not None:
                    wire(self._checkpointer)
        return self._checkpointer

    def _sharded_state(self):
        """The solver state as named arrays and JSON meta for the sharded
        format: X and, for a multistep scheme, the (s, G, S) histories
        (Timestepper.capture_state: device copies), the names and meta of
        the JAX package's, so either package restores the other's
        checkpoint. The checkpointer copies X out before the next step
        can write it."""
        solver = self.solver
        if solver.fields_dirty():
            solver.X = solver.gather_fields()
        ts = solver.timestepper
        arrays = {"X": solver.X}
        meta = {
            "kind": "ivp",
            "iteration": int(solver.iteration),
            "sim_time": float(solver.sim_time),
            "dt": float(solver.dt) if solver.dt is not None else None,
            "ts_iteration": int(ts.iteration),
            "scheme": type(ts).__name__,
            "pencil_shape": [int(s) for s in solver.pencil_shape],
        }
        state = ts.capture_state()
        if "F_hist" in state:
            arrays.update(F_hist=state["F_hist"], MX_hist=state["MX_hist"],
                          LX_hist=state["LX_hist"])
            meta["dt_hist"] = [float(v) for v in state["dt_hist"]]
        return arrays, meta

    def write_checkpoint(self):
        """Force one durable checkpoint write now (the preemption and
        end-of-run path; periodic writes ride the evaluator schedule for
        HDF5, the loop's own gate for sharded). Refuses a known-poisoned
        state: a checkpoint is a promise of restartability. The wall
        time this call holds the step loop is the measured
        `checkpoint_stall_sec` — for async sharded writes that is just
        the submit (plus any overrun-barrier wait). On the HDF5 path,
        retry is the CALLER's job (_final_checkpoint wraps this whole
        call), so the handler's own per-write retry is suspended to keep
        the attempt budget single-layered."""
        if self.checkpoint_dir is None:
            return None
        solver = self.solver
        if solver.health_error is not None:
            raise SolverHealthError(
                f"refusing durable checkpoint of a poisoned state: "
                f"{solver.health_error.reason}",
                iteration=int(solver.iteration),
                sim_time=float(solver.sim_time))
        t0 = time.perf_counter()
        # the range's duration is the stall this write holds the step
        # loop for (async sharded: the device clone and the submit)
        with metrics_mod.annotate("dedalus/checkpoint/write"):
            if self.checkpoint_format == "sharded":
                arrays, meta = self._sharded_state()
                result = self._ensure_checkpointer().save(arrays, meta)
            else:
                handler = self._ensure_checkpoint_handler()
                saved, handler.io_retry = handler.io_retry, None
                try:
                    handler.process(
                        iteration=int(solver.iteration),
                        wall_time=time.time() - solver.start_time,
                        sim_time=float(solver.sim_time),
                        timestep=float(solver.dt)
                        if solver.dt is not None else None)
                finally:
                    handler.io_retry = saved
                result = handler.current_file
        stall = time.perf_counter() - t0
        self.checkpoint_stall_sec += stall
        solver.metrics.inc("resilience/checkpoint_stall_sec", stall)
        solver.metrics.inc("resilience/checkpoints_written")
        return result

    # ----------------------------------------------------------- signals

    def _handle_stop_signal(self, signum, frame):
        """SIGTERM/SIGINT: request a graceful stop. The loop notices at
        the next step boundary; nothing solver-side happens here (the
        handler can interrupt a step mid-dispatch)."""
        self._stop_signal = signum
        logger.warning(
            f"received {signal.Signals(signum).name}: finishing the "
            "current step, writing a final checkpoint, and stopping")

    def _install_signals(self):
        if not self.install_signal_handlers:
            return {}
        previous = {}
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[signum] = signal.signal(
                    signum, self._handle_stop_signal)
            except (ValueError, OSError):
                # non-main thread or unsupported platform: degrade to
                # cooperative stops (request_stop) only
                pass
        return previous

    # ---------------------------------------------------------- recovery

    def _recover(self, err):
        """Rewind to the newest finite snapshot, tighten the dt cap, and
        wait the exponential backoff. Raises the original error when the
        retry budget or the snapshot ring is exhausted (the flight
        recorder of every attempt is already on disk)."""
        solver = self.solver
        t0 = time.perf_counter()
        self.retries += 1
        self._consecutive += 1
        solver.metrics.inc("resilience/retries")
        entry = {
            "failure_iteration": int(solver.iteration),
            "reason": getattr(err, "reason", str(err)),
            "postmortem": getattr(err, "postmortem_dir", None),
            "attempt": self._consecutive,
        }
        if self._consecutive > self.max_retries:
            entry["outcome"] = "escalated: retry budget exhausted"
            self.lineage.append(entry)
            logger.error(
                f"resilience: {self.max_retries} consecutive recoveries "
                "exhausted; escalating")
            raise err
        snap = self.ring.pop_newest_finite()
        if snap is None:
            entry["outcome"] = "escalated: no finite snapshot"
            self.lineage.append(entry)
            logger.error("resilience: snapshot ring exhausted (no finite "
                         "state to rewind to); escalating")
            raise err
        # dt backoff: cap future timesteps below the dt that failed —
        # except for silent corruption, where the numerics were never
        # wrong (the bits were): shrinking dt would slow the run for a
        # fault dt cannot influence
        failed_dt = None if isinstance(err, SilentCorruptionError) \
            else (solver.dt or snap.dt or self.dt)
        if failed_dt:
            base = self.dt_limit if self.dt_limit is not None else failed_dt
            self.dt_limit = min(base, failed_dt) * self.dt_backoff
            solver.metrics.inc("resilience/dt_backoffs")
        restore_snapshot(solver, snap)
        self.rewinds += 1
        self._last_failure_iter = entry["failure_iteration"]
        solver.metrics.inc("resilience/rewinds")
        entry.update({
            "outcome": "rewound",
            "rewind_iteration": snap.iteration,
            "dt_limit": self.dt_limit,
        })
        self.lineage.append(entry)
        delay = self.retry_base_delay * (2.0 ** (self._consecutive - 1))
        elapsed = time.perf_counter() - t0
        logger.warning(
            f"resilience: rewound iteration "
            f"{entry['failure_iteration']} -> {snap.iteration}, dt capped "
            f"at {self.dt_limit}, retry {self._consecutive}/"
            f"{self.max_retries} in {delay:.3g}s")
        if delay > 0:
            time.sleep(delay)
        # the backoff wait is left out of the rewind's seconds
        self._rewind_t0 = time.perf_counter() - elapsed

    def _effective_dt(self):
        dt = (self.timestep_function() if self.timestep_function
              else (self.solver.dt or self.dt))
        if dt is None:
            raise ValueError(
                "evolve_resilient() requires dt=..., a timestep_function, "
                "or a prior solver.step(dt)")
        if self.dt_limit is not None:
            dt = min(float(dt), self.dt_limit)
        return dt

    def _capture(self):
        solver = self.solver
        if solver.fields_dirty():
            # user edits (initial conditions, checkpoint restore) not yet
            # gathered: the anchor snapshot must hold the state the next
            # step will actually use, not the stale X
            solver.X = solver.gather_fields()
        self.ring.push(capture_snapshot(solver))
        self.snapshots_captured += 1
        solver.metrics.inc("resilience/snapshots")
        # a clean cadence past the last failure: relax the dt cap and
        # reset the consecutive-failure budget
        if (self._last_failure_iter is None
                or solver.iteration > self._last_failure_iter):
            self._consecutive = 0
            if self.dt_limit is not None:
                self.dt_limit *= self.dt_recovery
                # with a constant dt the cap clears once it stops binding;
                # under a timestep_function there is no base to compare
                # against, so the cap keeps doubling until min() makes it
                # moot — an effective un-cap
                if self.dt is not None and self.dt_limit >= self.dt:
                    self.dt_limit = None

    def request_stop(self, why="requested"):
        """Cooperative stop request (the signal handler's path, also
        callable directly): honored at the next step boundary."""
        if self._stop_signal is None:
            self._stop_signal = why

    # ---------------------------------------------------------- the loop

    def run(self, log_cadence=100):
        """Drive the solver to completion (or preemption). Returns a
        summary dict (also available as `self.summary()`)."""
        solver = self.solver
        previous_handlers = self._install_signals()
        try:
            if self.resume and self.checkpoint_dir is not None:
                t0 = time.perf_counter()
                self._resume_any()
                self.timing["resume_sec"] = time.perf_counter() - t0
            if self.checkpoint_dir is not None:
                if self.checkpoint_format == "hdf5":
                    self._ensure_checkpoint_handler()
                else:
                    self._ensure_checkpointer()
                    self._ckpt_gate.reset(int(solver.iteration))
            self._capture()   # iteration-0 (or resume-point) anchor
            next_snapshot = solver.iteration + self.snapshot_cadence
            while True:
                # recovery BEFORE the stop check: a preemption landing on
                # the same step as a divergence must rewind first, so the
                # final checkpoint is written from a good state, never
                # the poisoned one
                if solver.health_error is not None:
                    self._recover(solver.health_error)
                    next_snapshot = solver.iteration + self.snapshot_cadence
                    continue
                if self._stop_signal is not None:
                    self._graceful_stop()
                    break
                if not solver.proceed:
                    self.stopped_by = "completed"
                    break
                dt = self._effective_dt()
                # SDC sentinel anchor: captured BEFORE the step that the
                # sentinel will re-execute; pushed on the ring so a
                # detection rewinds exactly here
                sdc_anchor = None
                if self.sdc_cadence \
                        and self._sdc_gate.due(solver.iteration + 1):
                    if solver.fields_dirty():
                        solver.X = solver.gather_fields()
                    sdc_anchor = capture_snapshot(solver)
                    self.ring.push(sdc_anchor)
                try:
                    if self.chaos is not None:
                        self.chaos.before_step(solver)
                    solver.step(dt)
                except SolverHealthError as err:
                    # the raising path (invalid dt): state is unpoisoned
                    # but dt production is broken — same rewind + backoff
                    self._recover(err)
                    next_snapshot = solver.iteration + self.snapshot_cadence
                    continue
                if self._rewind_t0 is not None:
                    solver._synchronize()
                    self.timing["rewind_sec"].append(
                        time.perf_counter() - self._rewind_t0)
                    self._rewind_t0 = None
                if self.chaos is not None:
                    self.chaos.after_step(solver)
                if self.step_hook is not None \
                        and solver.health_error is None:
                    self.step_hook(solver)
                if sdc_anchor is not None and solver.health_error is None:
                    err = self._sdc_check(sdc_anchor, dt)
                    if err is not None:
                        self._recover(err)
                        next_snapshot = (solver.iteration
                                         + self.snapshot_cadence)
                        continue
                if solver.health_error is None \
                        and solver.iteration >= next_snapshot:
                    self._capture()
                    next_snapshot = solver.iteration + self.snapshot_cadence
                if solver.health_error is None \
                        and self.checkpoint_dir is not None \
                        and self.checkpoint_format == "sharded" \
                        and self.checkpoint_iter \
                        and self._ckpt_gate.due(solver.iteration):
                    # periodic sharded writes run from the loop (the HDF5
                    # path rides the evaluator schedule instead)
                    try:
                        self.write_checkpoint()
                    except Exception as exc:
                        logger.warning(f"periodic checkpoint failed: {exc}")
                if log_cadence and solver.iteration % log_cadence == 0:
                    logger.info(
                        f"Iteration={solver.iteration}, "
                        f"Time={solver.sim_time:.6e}, dt={dt:.6e}")
            if self.stopped_by == "completed" and self.checkpoint_dir:
                self._final_checkpoint()
        finally:
            for signum, handler in previous_handlers.items():
                try:
                    signal.signal(signum, handler)
                except (ValueError, OSError):
                    pass
            if self._checkpointer is not None:
                for exc in self._checkpointer.close():
                    logger.error(f"async checkpoint write failed: {exc}")
            if self.flush_telemetry:
                try:
                    solver.flush_metrics()
                except Exception as exc:
                    logger.warning(f"final telemetry flush failed: {exc}")
        return self.summary()

    def _newest_sharded_ts(self):
        """Commit timestamp of the newest COMMITTED sharded checkpoint
        under checkpoint_dir (torn, manifest-less directories skipped),
        or None."""
        for path in reversed(dcheckpoint.list_checkpoints(
                self.checkpoint_dir)):
            try:
                return float(dcheckpoint.read_manifest(path).get("ts", 0))
            except CheckpointError:
                continue
        return None

    def _newest_hdf5_ts(self):
        """mtime of the newest HDF5 set file under checkpoint_dir, or
        None."""
        from .post import get_assigned_sets
        base = pathlib.Path(self.checkpoint_dir)
        if not base.is_dir():
            return None
        sets = get_assigned_sets(base)
        if not sets:
            return None
        try:
            return os.path.getmtime(sets[-1])
        except OSError:
            return None

    def _resume_any(self):
        """Resume from whatever the checkpoint directory holds — by
        RECENCY when both formats are present (a run can migrate
        CHECKPOINT_FORMAT in either direction across restarts without
        silently resuming older work), with each format falling back to
        the other when its newest data turns out unloadable (e.g. the
        half-migrated case where the first sharded write tore while
        valid HDF5 sets exist). Only when neither format yields anything
        does a failure escalate: checkpoints existed, and a silent fresh
        start would discard the history the operator asked to resume."""
        solver = self.solver

        def try_sharded():
            return self._sharded_resume()

        def try_hdf5():
            return resume_latest(solver, self.checkpoint_dir,
                                 metrics=solver.metrics)

        sharded_ts = self._newest_sharded_ts()
        hdf5_ts = self._newest_hdf5_ts()
        # torn-only sharded dirs (no committed manifest) still mean "a
        # sharded write was attempted"; try that path first only when a
        # commit exists or there is no HDF5 alternative
        if sharded_ts is not None and (hdf5_ts is None
                                       or sharded_ts >= hdf5_ts):
            order = (try_sharded, try_hdf5)
        elif hdf5_ts is not None:
            order = (try_hdf5, try_sharded)
        elif dcheckpoint.list_checkpoints(self.checkpoint_dir):
            order = (try_sharded,)   # torn sharded dirs only: structured
        else:
            order = (try_hdf5,)      # nothing at all: fresh start (None)
        event = None
        first_error = None
        for attempt in order:
            try:
                event = attempt()
            except CheckpointError as exc:
                if first_error is None:
                    first_error = exc
                logger.warning(f"resume attempt failed ({exc}); trying "
                               f"the other checkpoint format")
                continue
            if event is not None:
                break
        if event is None and first_error is not None:
            raise first_error
        self.resume_event = event
        if self.resume_event is not None:
            solver.metrics.inc("resilience/resumes")
            if self.dt is None and self.resume_event["dt"]:
                self.dt = self.resume_event["dt"]

    def _sharded_resume(self):
        """Restore the solver from the newest valid sharded checkpoint:
        digests validated, torn or corrupt checkpoints quarantined with a
        fallback to the previous manifest (dcheckpoint.restore_latest).
        The arrays go onto the solver's device; a checkpoint of either
        package restores bit for bit."""
        solver = self.solver
        event = dcheckpoint.restore_latest(self.checkpoint_dir)
        if event is None:
            return None
        solver.metrics.inc("resilience/checkpoints_validated",
                           event.pop("validated", 1))
        arrays = event.pop("arrays")
        meta = event["meta"]
        if meta.get("kind") != "ivp":
            raise CheckpointError(
                f"sharded checkpoint {event['path']} holds "
                f"{meta.get('kind')!r} state, not a single-solver IVP",
                path=event["path"])
        # an incompatible checkpoint fails here with a named cause, not
        # as a shape error or a wrong history under another scheme
        if meta.get("scheme") is not None \
                and meta["scheme"] != type(solver.timestepper).__name__:
            raise CheckpointError(
                f"sharded checkpoint {event['path']} was written by "
                f"scheme {meta['scheme']}, this solver runs "
                f"{type(solver.timestepper).__name__}", path=event["path"])
        if meta.get("pencil_shape") is not None \
                and list(meta["pencil_shape"]) != \
                [int(s) for s in solver.pencil_shape]:
            raise CheckpointError(
                f"sharded checkpoint {event['path']} pencil shape "
                f"{meta['pencil_shape']} does not match this solver's "
                f"{list(solver.pencil_shape)}", path=event["path"])
        device = solver.X.device
        solver.X = torch.as_tensor(arrays["X"]).to(device)
        ts = solver.timestepper
        if "F_hist" in arrays:
            ts.load_histories(arrays["F_hist"], arrays["MX_hist"],
                              arrays["LX_hist"], meta.get("dt_hist", []))
        ts.iteration = int(meta.get("ts_iteration", 0))
        ts.drop_factor()
        solver.sim_time = solver.initial_sim_time = float(meta["sim_time"])
        solver.iteration = solver.initial_iteration = int(meta["iteration"])
        solver.dt = meta.get("dt")
        solver.problem.sim_time = solver.sim_time
        solver.defer_scatter(solver.X)
        solver.snapshot_versions()
        event.update({
            "write": event.pop("seq"),
            "iteration": int(solver.iteration),
            "sim_time": float(solver.sim_time),
            "dt": solver.dt,
            "format": "sharded",
        })
        logger.info(
            f"resumed from sharded checkpoint {event['path']} (iteration "
            f"{solver.iteration}, sim_time {solver.sim_time:.6e})")
        return event

    # ------------------------------------------------------- SDC sentinel

    @staticmethod
    def _mismatched(live, replay):
        """The count of elements that differ between two lists of
        tensors, NaN-aware (NaN == NaN here), as one device tensor. The
        lists cover the multistep histories beside X: corruption in a
        history would leave this step's X intact and poison every later
        one."""
        total = None
        with metrics_mod.trace_scope("resilience", "sdc_compare"):
            for a, b in zip(live, replay):
                same = (a == b) | (torch.isnan(a) & torch.isnan(b))
                n = (~same).sum()
                total = n if total is None else total + n
        return total

    def _sdc_check(self, anchor, dt):
        """Redundantly re-execute the step just taken from `anchor` and
        compare against the live state. Returns None on a value-exact
        match (the solver is left on the — identical — re-executed
        state), or a SilentCorruptionError (postmortem already dumped)
        for the caller to route through recovery. Scheduled outputs are
        suppressed during the re-execution so a replayed step can never
        double-write analysis files; the redundant step is subtracted
        from the iteration throughput accounting."""
        solver = self.solver
        t0 = time.perf_counter()
        self.sdc_checks += 1
        solver.metrics.inc("resilience/sdc_checks")
        live = capture_snapshot(solver)
        restore_snapshot(solver, anchor)
        evaluator = solver.evaluator
        saved_eval = evaluator.evaluate_scheduled
        evaluator.evaluate_scheduled = lambda **kw: None
        try:
            solver.step(dt)
        finally:
            evaluator.evaluate_scheduled = saved_eval
        solver.metrics.observe_steps(-1)   # verification, not progress
        live_leaves = [live.X]
        replay_leaves = [solver.X]
        st = live.timestepper_state
        if "F_hist" in st:
            now = solver.timestepper.capture_state()
            for name in ("F_hist", "MX_hist", "LX_hist"):
                live_leaves.append(st[name])
                replay_leaves.append(now[name])
        # one host read per SDC_CADENCE iterations
        mismatched = int(self._mismatched(live_leaves, replay_leaves))
        self.timing["sdc_check_sec"].append(time.perf_counter() - t0)
        if mismatched == 0:
            # bit-for-bit agreement: the solver now holds the (identical)
            # re-executed state; only the evaluator's schedule counters
            # need the live values back (the replay skipped them)
            for handler, state in zip(evaluator.handlers,
                                      live.evaluator_state):
                handler.restore_schedule_state(state)
            return None
        self.sdc_detected += 1
        solver.metrics.inc("resilience/sdc_detected")
        reason = (f"silent corruption detected: re-executing step "
                  f"{anchor.iteration} -> {live.iteration} from the anchor "
                  f"snapshot diverges from the live state in {mismatched} "
                  f"element(s)")
        pm = None
        try:
            pm = solver.health.dump_postmortem(reason)
        except Exception as exc:
            logger.warning(f"SDC flight-recorder dump failed: {exc}")
        logger.error(f"resilience: {reason}"
                     + (f" (post-mortem: {pm})" if pm else ""))
        return SilentCorruptionError(
            reason, mismatched=mismatched,
            anchor_iteration=anchor.iteration,
            iteration=live.iteration, sim_time=live.sim_time,
            postmortem_dir=str(pm) if pm else None)

    def _graceful_stop(self):
        solver = self.solver
        sig = self._stop_signal
        self.stopped_by = (signal.Signals(sig).name
                           if isinstance(sig, int) else str(sig))
        logger.info(f"resilience: graceful stop ({self.stopped_by}) at "
                    f"iteration {solver.iteration}")
        # last-chance integrity check: preemption can land between a
        # divergence and its cadenced detection — the final checkpoint is
        # a promise of restartability, so probe now and rewind first if
        # the state is poisoned
        if solver.health.enabled and solver.health_error is None:
            try:
                solver.health.check()
            except Exception as exc:
                logger.warning(f"pre-checkpoint health check failed: {exc}")
        if solver.health_error is not None:
            try:
                self._recover(solver.health_error)
            except SolverHealthError:
                logger.error(
                    "resilience: state unrecoverable at preemption; "
                    "skipping the final checkpoint (the flight recorder "
                    "holds the forensic state)")
                return
        self._final_checkpoint()

    def _final_checkpoint(self):
        if self.checkpoint_dir is None:
            return
        try:
            if self.checkpoint_format == "sharded":
                # the ShardedCheckpointer already wraps each commit in
                # the io_retry policy (on its writer thread for async);
                # wrapping the call again would square the attempt
                # budget — the exact double-layering the HDF5 branch
                # suspends the handler's retry to avoid
                path = self.write_checkpoint()
            else:
                path = self.io_retry.call(self.write_checkpoint,
                                          label="final checkpoint")
            if path is None:
                # async submit: durability is confirmed (or denied) at
                # the writer drain in run()'s finally — do not log a
                # "written" line the operator could mistake for durable
                logger.info("final checkpoint submitted to the async "
                            "writer; durability confirmed at drain")
            else:
                logger.info(f"final checkpoint written: {path}")
        except Exception as exc:
            logger.error(f"final checkpoint failed: {exc}")

    # ----------------------------------------------------------- summary

    def summary(self):
        """Compact record of this loop's resilience activity — attached
        to telemetry flushes (solver.flush_metrics), bench rows, and
        post-mortem dumps (retry lineage)."""
        out = {
            "rewinds": self.rewinds,
            "retries": self.retries,
            "snapshots": self.snapshots_captured,
            "dt_limit": self.dt_limit,
            "stopped_by": self.stopped_by,
        }
        if self.sdc_cadence:
            out["sdc_checks"] = self.sdc_checks
            out["sdc_detected"] = self.sdc_detected
        if self.checkpoint_dir is not None:
            ckpt = (dict(self._checkpointer.summary())
                    if self._checkpointer is not None else {})
            ckpt["format"] = self.checkpoint_format
            # authoritative stall: the wall the STEP LOOP was held per
            # write_checkpoint (includes the state capture), matching the
            # resilience/checkpoint_stall_sec counter — NOT the writer-
            # internal save() time the checkpointer summary reports
            ckpt["stall_sec"] = round(self.checkpoint_stall_sec, 6)
            out["checkpoint"] = ckpt
        if self.lineage:
            out["lineage"] = list(self.lineage)
        if self.resume_event is not None:
            out["resumed_from"] = self.resume_event["path"]
            out["resume_write"] = self.resume_event["write"]
        out["timing"] = {k: (list(v) if isinstance(v, list) else v)
                         for k, v in self.timing.items()}
        return out


def jsonable_summary(summary):
    """Strict-JSON view of a summary (non-finite floats stringified)."""
    return json.loads(json.dumps(summary, default=str))
