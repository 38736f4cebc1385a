"""
Step-loop metrics (counterpart of dedalus_tpu/tools/metrics.py): named
counters, phase timers, memory watermarks and a JSONL telemetry sink.

Launches are asynchronous on a CUDA device, so a host timer around a
queued computation measures enqueue latency, not device work, unless the
device is synchronized, and synchronizing every iteration would stall
the queue. Phase timers therefore bracket `torch.cuda.synchronize` only
on sampled iterations (every `SAMPLE_CADENCE`-th step, config section
[profiling]); an off-cadence iteration pays one counter bump and no
device wait. A sample re-runs the step pieces on the current state (the
solver supplies the thunks), so sampling never perturbs the solution;
on the banded path those re-runs launch the substitution kernel.

Naming: phase timer names are the `torch.profiler.record_function`
labels of the code they time, prefixed `dedalus/` (`dedalus/step`,
`dedalus/health/...`, `dedalus/metrics/sample`,
`dedalus/build/...`), so a torch.profiler trace and the JSONL records
share one vocabulary. Flush emits ONE flat JSON record per call with the
phase breakdown; `format_phase_table` renders it.

The ensemble (core/ensemble.py) reads `CadenceGate` and `Counters`.
"""

import atexit
import json
import logging
import math
import os
import signal
import threading
import time
import weakref

from .config import config

__all__ = ["PHASES", "SUM_PHASES", "BUILD_PHASES", "CadenceGate", "Counter",
           "Counters", "PhaseTimer", "LogHistogram", "MemoryWatermark",
           "Metrics", "BuildPhases", "trace_scope", "annotate", "resolve", "format_phase_table", "register_exit_flush",
           "flush_pending", "process_rss_bytes"]

# The step decomposition: rows that partition one step and should sum to
# about the loop wall. `fused` and the transpose split overlap them
# (dedalus_tpu/tools/metrics.py:108) and stay out of phase sums.
SUM_PHASES = ("transform", "matsolve", "transpose", "evaluator")
PHASES = SUM_PHASES + ("fused", "transpose_exposed", "transpose_overlapped")

# The cold-start (build) phases: host assembly, banded structure, device
# upload and factorization, and the first step ("compile": the JAX
# package's trace and compile; the port compiles nothing, so it stays 0).
BUILD_PHASES = ("host_assembly", "structure", "factor", "compile")


def trace_scope(phase, detail=None):
    """A `torch.profiler.record_function` range named
    `dedalus/<phase>[/<detail>]`: the ops launched under it group in a
    torch.profiler trace by the names the timers report."""
    import torch
    name = f"dedalus/{phase}" + (f"/{detail}" if detail else "")
    return torch.profiler.record_function(name)


def annotate(label):
    """A host-level profiler range around a dispatch; near free when no
    trace is being captured."""
    import torch
    return torch.profiler.record_function(label)


class CadenceGate:
    """
    Consuming iteration-cadence gate: `due(iterations)` fires once per
    cadence crossing and advances the next due point past the observed
    count (a block of steps crossing several multiples fires once)
    (dedalus_tpu/tools/metrics.py:149). The gate behind the phase
    sampler, the health probe, the SDC sentinel and the ensemble's probe.
    """

    __slots__ = ("cadence", "_next_due")

    def __init__(self, cadence):
        self.cadence = int(cadence)
        self._next_due = max(self.cadence, 1)

    def reset(self, iterations=0):
        """Re-anchor: the next fire is one full cadence past `iterations`."""
        self._next_due = iterations + max(self.cadence, 1)

    def due(self, iterations):
        if self.cadence <= 0:
            return False
        if iterations >= self._next_due:
            self._next_due = iterations + self.cadence
            return True
        return False


class Counters:
    """Named counters (`counters`, e.g. "ensemble/member_steps") and the
    loop window of an ensemble: `iterations` counts the steps observed
    since `reset_loop`, `loop_wall` the host seconds since it."""

    def __init__(self):
        self.counters = {}
        self.iterations = 0
        self._loop_t0 = time.perf_counter()

    def inc(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    def observe_steps(self, n):
        self.iterations += int(n)

    def reset_loop(self):
        self.iterations = 0
        self._loop_t0 = time.perf_counter()

    def loop_wall(self):
        return time.perf_counter() - self._loop_t0


class BuildPhases:
    """
    Wall-clock accounting of the solver build phases
    (dedalus_tpu/tools/metrics.py:176): `scope(name)` brackets one phase
    (accumulating across re-entries) under a `dedalus/build/<name>`
    profiler range; `record()` flattens to the `<name>_sec` keys of
    BUILD_PHASES plus the assembly-cache verdict (the port has no
    assembly cache: "off"). `seconds` may be a solver's own
    `build_seconds` dict, which the build fills.
    """

    def __init__(self, seconds=None):
        self.seconds = {} if seconds is None else seconds
        self.cache = "off"

    class _Scope:
        def __init__(self, phases, name):
            self.phases = phases
            self.name = name

        def __enter__(self):
            self.ann = annotate(f"dedalus/build/{self.name}")
            self.ann.__enter__()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.phases.add(self.name, time.perf_counter() - self.t0)
            return self.ann.__exit__(*exc)

    def scope(self, name):
        return self._Scope(self, name)

    def add(self, name, seconds):
        self.seconds[name] = self.seconds.get(name, 0.0) + float(seconds)

    def record(self):
        out = {f"{name}_sec": round(self.seconds.get(name, 0.0), 4)
               for name in BUILD_PHASES}
        out["assembly_cache"] = self.cache
        return out


class Counter:
    """Named monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        self.value += n
        return self.value


# LogHistogram buckets: geometric with ratio 2**(1/4) above 1 ns
_LOG_FLOOR = 1e-9
_LOG_BASE = 2.0 ** 0.25
_INV_LOG_BASE = 1.0 / math.log(_LOG_BASE)


class LogHistogram:
    """Log-bucketed latency histogram (the JAX package's
    tools/tracing.py:86): O(1) `add`, tail percentiles by a cumulative
    bucket walk with geometric-midpoint interpolation, clamped to the
    observed min/max."""

    __slots__ = ("counts", "total", "sum", "min", "max")

    def __init__(self):
        self.counts = {}
        self.total = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def _bucket(self, seconds):
        if seconds <= _LOG_FLOOR:
            return 0
        return 1 + int(math.log(seconds / _LOG_FLOOR) * _INV_LOG_BASE)

    def add(self, seconds):
        seconds = float(seconds)
        b = self._bucket(seconds)
        self.counts[b] = self.counts.get(b, 0) + 1
        self.total += 1
        self.sum += seconds
        self.min = seconds if self.min is None else min(self.min, seconds)
        self.max = seconds if self.max is None else max(self.max, seconds)

    def percentile(self, q):
        """q in [0, 100]."""
        if not self.total:
            return 0.0
        rank = q / 100.0 * self.total
        seen = 0
        for b in sorted(self.counts):
            seen += self.counts[b]
            if seen >= rank:
                value = _LOG_FLOOR if b == 0 \
                    else _LOG_FLOOR * _LOG_BASE ** (b - 0.5)
                return min(max(value, self.min), self.max)
        return self.max

    def summary(self):
        return {"count": self.total, "p50": self.percentile(50),
                "p95": self.percentile(95), "p99": self.percentile(99)}


class PhaseTimer:
    """Sampled per-step seconds of each phase, with a LogHistogram per
    phase for the p50/p95/p99 columns (dedalus_tpu/tools/metrics.py:239)."""

    def __init__(self, phases=PHASES):
        self.totals = {p: 0.0 for p in phases}
        self.counts = {p: 0 for p in phases}
        self.hists = {}

    def add(self, phase, seconds):
        self.totals[phase] = self.totals.get(phase, 0.0) + float(seconds)
        self.counts[phase] = self.counts.get(phase, 0) + 1
        h = self.hists.get(phase)
        if h is None:
            h = self.hists[phase] = LogHistogram()
        h.add(seconds)

    def mean(self, phase):
        n = self.counts.get(phase, 0)
        return self.totals.get(phase, 0.0) / n if n else 0.0

    def percentiles(self, phase):
        """{p50, p95, p99} seconds of one phase, or None without samples."""
        h = self.hists.get(phase)
        if h is None or not h.total:
            return None
        return {"p50": h.percentile(50), "p95": h.percentile(95),
                "p99": h.percentile(99)}

    @property
    def samples(self):
        return max(self.counts.values(), default=0)


def process_rss_bytes():
    """Resident-set size of this process in bytes (0 when unreadable)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError, AttributeError):
        try:
            import resource
            import sys
            scale = 1 if sys.platform == "darwin" else 1024
            return resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * scale
        except Exception:
            return 0


class MemoryWatermark:
    """Peak memory across samples: on a CUDA device the caching
    allocator's peak (`torch.cuda.max_memory_allocated`, source
    "memory_stats"), on the CPU the process RSS (source "rss")."""

    def __init__(self, device=None):
        self.device = device
        self.peak_bytes = 0
        self.source = None

    def sample(self):
        current = None
        device = self.device
        if device is not None and getattr(device, "type", None) == "cuda":
            import torch
            current = int(torch.cuda.max_memory_allocated(device))
            self.source = "memory_stats"
        else:
            current = process_rss_bytes()
            self.source = "rss"
        self.peak_bytes = max(self.peak_bytes, int(current))
        return self.peak_bytes


class Metrics:
    """
    Registry of counters, one phase timer and a memory watermark, with
    cadence-gated sampling and a JSONL sink
    (dedalus_tpu/tools/metrics.py:332). `device` (the solver's) is what
    `time_thunk` synchronizes.

    Loop accounting: `observe_steps(n)` counts iterations and stamps the
    loop clock (the first call, or `reset_loop()` at warmup end, anchors
    t0). `flush()` turns the sampled per-step phase means into loop-total
    estimates and appends one JSONL record to `sink` when set.
    """

    def __init__(self, sample_cadence=200, sink=None, enabled=True,
                 sampling=True, meta=None, device=None):
        self.enabled = bool(enabled)
        self.sampling = bool(sampling) and self.enabled
        self.sample_cadence = int(sample_cadence)
        self.sink = str(sink) if sink else None
        self.meta = dict(meta or {})
        self.device = device
        self.counters = {}
        self.timer = PhaseTimer()
        self.memory = MemoryWatermark(device)
        self.iterations = 0
        self.dirty = False
        self._loop_t0 = None
        self._gate = CadenceGate(self.sample_cadence)
        self._warmed = set()

    def set_device(self, device):
        self.device = device
        self.memory.device = device

    # ------------------------------------------------------------- counters

    def counter(self, name):
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def inc(self, name, n=1):
        if not self.enabled:
            return 0
        self.dirty = True
        return self.counter(name).inc(n)

    # ----------------------------------------------------------------- loop

    def observe_steps(self, n=1):
        """Count n completed steps (no device wait)."""
        if not self.enabled:
            return
        if self._loop_t0 is None:
            self._loop_t0 = time.perf_counter()
        self.iterations += int(n)
        self.dirty = True

    def reset_loop(self):
        """Re-anchor the loop window (at warmup end)."""
        self.iterations = 0
        self._loop_t0 = time.perf_counter()
        self._gate.reset(0)

    def loop_wall(self):
        if self._loop_t0 is None:
            return 0.0
        return time.perf_counter() - self._loop_t0

    # ------------------------------------------------------------- sampling

    def due(self):
        """Whether a phase sample is due at the current iteration count;
        consuming."""
        if not self.sampling:
            return False
        return self._gate.due(self.iterations)

    def synchronize(self):
        """Wait for the device's current stream, which every step's work
        is ordered on (a recorded step's side stream joins it); nothing on
        the CPU. A stream synchronization, so torch's sync debug mode
        counts it as one host read."""
        device = self.device
        if device is not None and getattr(device, "type", None) == "cuda":
            import torch
            torch.cuda.current_stream(device).synchronize()

    def time_thunk(self, name, thunk):
        """Wall-time one thunk between two device synchronizations. The
        first call per name runs untimed (allocator and library warm)."""
        if name not in self._warmed:
            thunk()
            self.synchronize()
            self._warmed.add(name)
        t0 = time.perf_counter()
        thunk()
        self.synchronize()
        return time.perf_counter() - t0

    def add_phase_sample(self, seconds_by_phase):
        """Record one sampled per-step attribution {phase: seconds}."""
        for phase, sec in seconds_by_phase.items():
            self.timer.add(phase, sec)
        self.inc("phase_samples")
        self.memory.sample()

    # ---------------------------------------------------------------- flush

    def emit(self, record):
        """Append one record to the JSONL sink (with a `ts` stamped when
        missing). Returns the record, or None when disabled or sinkless.
        Transient IO faults retry under the [resilience] IO_RETRIES
        budget; a sink that keeps failing logs a warning."""
        if not (self.enabled and self.sink):
            return None
        record = dict(record)
        record.setdefault("ts", round(time.time(), 1))

        def write():
            parent = os.path.dirname(os.path.abspath(self.sink))
            os.makedirs(parent, exist_ok=True)
            with open(self.sink, "a") as f:
                f.write(json.dumps(record) + "\n")

        try:
            from .resilience import io_retry_policy
            io_retry_policy().call(write, label=f"metrics sink {self.sink}")
        except OSError as exc:
            logging.getLogger(__name__).warning(
                f"metrics sink {self.sink}: {exc}")
        return record

    def flush(self, extra=None):
        """One telemetry record (appended to the JSONL sink when set).
        Callers synchronize the device first (the solver's
        `flush_metrics` does) so the loop wall covers the queued work."""
        if not self.enabled:
            return None
        self.memory.sample()
        wall = self.loop_wall()
        iters = self.iterations
        phase_mean = {p: self.timer.mean(p) for p in PHASES}
        phase_total = {p: phase_mean[p] * iters for p in PHASES}
        phase_pct = {}
        for p in PHASES:
            pct = self.timer.percentiles(p)
            if pct:
                phase_pct[p] = {k: round(v, 6) for k, v in pct.items()}
        phase_sum = sum(phase_total[p] for p in SUM_PHASES)
        record = {
            "kind": "step_metrics",
            "ts": round(time.time(), 1),
            "iterations": iters,
            "loop_wall_sec": round(wall, 6),
            "steps_per_sec": round(iters / wall, 4) if wall > 0 else 0.0,
            "sample_cadence": self.sample_cadence,
            "phase_samples": self.timer.samples,
            "phase_mean_sec": {p: round(v, 6) for p, v in phase_mean.items()},
            "phase_pct_sec": phase_pct,
            "phase_total_sec": {p: round(v, 6)
                                for p, v in phase_total.items()},
            "phase_sum_frac": round(phase_sum / wall, 4) if wall > 0 else 0.0,
            "device_mem_peak_bytes": self.memory.peak_bytes,
            "mem_source": self.memory.source,
            "counters": {name: c.value for name, c in self.counters.items()},
        }
        record.update(self.meta)
        if extra:
            record.update(extra)
        self.emit(record)
        self.dirty = False
        return record


# --------------------------------------------------- abnormal-exit flush
#
# A run ended by an exception or a termination signal still leaves a
# telemetry record (dedalus_tpu/tools/metrics.py:555): registered solvers
# with unflushed activity and a sink are flushed at exit, and SIGTERM /
# SIGINT (while their default disposition is in place) get a chaining
# hook that flushes, restores the previous disposition and re-delivers
# the signal.

_exit_solvers = []          # weakrefs to registered solvers
_signal_previous = {}       # {signum: previous handler} once installed
_exit_lock = threading.Lock()


def flush_pending(source="atexit"):
    """Flush every registered solver with unflushed activity and a JSONL
    sink. Best effort: one failing flush never blocks the others."""
    for ref in list(_exit_solvers):
        solver = ref()
        if solver is None:
            continue
        m = getattr(solver, "metrics", None)
        if m is None or not (m.enabled and m.sink and m.dirty):
            continue
        try:
            solver.flush_metrics(extra={"flush_source": source})
        except Exception:
            pass


def _signal_flush(signum, frame):
    """Restore the previous disposition first (a second signal during
    the flush gets default semantics), flush, then re-deliver."""
    previous = _signal_previous.get(signum, signal.SIG_DFL)
    try:
        signal.signal(signum, previous)
        restored = True
    except (ValueError, OSError):
        restored = False
    flush_pending(source=f"signal:{signum}")
    if restored:
        os.kill(os.getpid(), signum)


_HOOKABLE_DEFAULTS = {
    signal.SIGTERM: (signal.SIG_DFL,),
    signal.SIGINT: (signal.SIG_DFL, signal.default_int_handler),
}


def register_exit_flush(solver):
    """Register a solver for the abnormal-exit telemetry flush (atexit,
    SIGTERM, SIGINT). Idempotent per solver; a signal is hooked once, and
    only while its default disposition is in place."""
    with _exit_lock:
        if not any(ref() is solver for ref in _exit_solvers):
            _exit_solvers.append(weakref.ref(solver))
        _exit_solvers[:] = [ref for ref in _exit_solvers
                            if ref() is not None]
        for signum, defaults in _HOOKABLE_DEFAULTS.items():
            if signum in _signal_previous:
                continue
            try:
                current = signal.getsignal(signum)
                if current in defaults:
                    _signal_previous[signum] = current
                    signal.signal(signum, _signal_flush)
            except (ValueError, OSError):
                pass   # not the main thread


atexit.register(flush_pending)


def resolve(spec=None, sink=None, cadence=None, meta=None, device=None):
    """
    A solver's `metrics` argument against the [profiling] config
    (dedalus_tpu/tools/metrics.py:647): a Metrics instance passes through
    (meta keys merged in); True/None build from config (None respects
    METRICS_DEFAULT, True forces on); False disables.
    """
    if isinstance(spec, Metrics):
        for key, val in (meta or {}).items():
            spec.meta.setdefault(key, val)
        if device is not None and spec.device is None:
            spec.set_device(device)
        return spec
    section = config["profiling"]
    if spec is None:
        enabled = section.getboolean("METRICS_DEFAULT", fallback=True)
    else:
        enabled = bool(spec)
    if cadence is None:
        cadence = int(section.get("SAMPLE_CADENCE", "200") or 200)
    if sink is None:
        sink = section.get("METRICS_FILE", "").strip() or None
    return Metrics(sample_cadence=cadence, sink=sink, enabled=enabled,
                   meta=meta, device=device)


def format_phase_table(record, indent="  "):
    """A flushed record's phase breakdown as aligned text lines (the JAX
    package's format, dedalus_tpu/tools/metrics.py:674)."""
    if not record:
        return []
    wall = record.get("loop_wall_sec") or 0.0
    iters = record.get("iterations") or 0
    total = record.get("phase_total_sec") or {}
    mean = record.get("phase_mean_sec") or {}
    pct = record.get("phase_pct_sec") or {}
    lines = [f"Per-phase wall time ({record.get('phase_samples', 0)} samples,"
             f" cadence {record.get('sample_cadence', '?')}):"]
    for phase in SUM_PHASES:
        t = total.get(phase, 0.0)
        frac = 100.0 * t / wall if wall > 0 else 0.0
        line = (f"{indent}{phase:<10} {mean.get(phase, 0.0):#.4g} s/step"
                f"  {t:#.4g} s total  {frac:5.1f}%")
        p = pct.get(phase)
        if p:
            line += (f"  p50/p95/p99 {p.get('p50', 0.0):#.3g}"
                     f"/{p.get('p95', 0.0):#.3g}"
                     f"/{p.get('p99', 0.0):#.3g} s")
        lines.append(line)
    psum = sum(total.get(p, 0.0) for p in SUM_PHASES)
    frac = 100.0 * psum / wall if wall > 0 else 0.0
    lines.append(f"{indent}{'sum':<10} {psum:#.4g} s of {wall:#.4g} s loop"
                 f" wall ({frac:.1f}%), {iters} iterations")
    if total.get("fused"):
        lines.append(
            f"{indent}{'fused':<10} {mean.get('fused', 0.0):#.4g} s/step"
            f"  (whole fused step program; overlaps the split rows, "
            f"excluded from sum)")
    if total.get("transpose_exposed") or total.get("transpose_overlapped"):
        exp = total.get("transpose_exposed", 0.0)
        ovl = total.get("transpose_overlapped", 0.0)
        tot = exp + ovl
        share = 100.0 * ovl / tot if tot > 0 else 0.0
        lines.append(
            f"{indent}{'transpose':<10} exposed {exp:#.4g} s / overlapped "
            f"{ovl:#.4g} s ({share:.0f}% hidden; overlaps the transpose "
            f"row, excluded from sum)")
    mem = record.get("device_mem_peak_bytes")
    if mem:
        lines.append(f"{indent}device memory peak: {mem / 1e9:.3f} GB"
                     f" ({record.get('mem_source')})")
    return lines
