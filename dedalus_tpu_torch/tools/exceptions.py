"""
Framework exception types (counterpart of dedalus_tpu/tools/exceptions.py).
"""


class DedalusError(Exception):
    """Base class for framework errors."""


class NonlinearOperatorError(DedalusError):
    """Raised when a linear path receives a nonlinear operator."""


class SymbolicParsingError(DedalusError):
    """Raised when an equation string cannot be parsed."""


class UnsupportedEquationError(DedalusError):
    """Raised when an equation is structurally unsupported."""


class SolverHealthError(DedalusError, ValueError):
    """
    Structured numerical-health failure (a non-finite state, a growth
    bound exceeded, a non-finite timestep or, from the
    differentiable-solve path, a non-finite loss or gradient): carries
    the failure context so post-mortems need no rerun (dedalus_tpu/tools/
    exceptions.py:26). Subclasses ValueError so callers that guarded a
    bare ValueError keep working.

    Attributes: reason (str), iteration (int), sim_time (float), record
    (the triggering health-probe record, when one exists), postmortem_dir
    (path of the flight-recorder dump, when one was written).
    """

    def __init__(self, reason, iteration=None, sim_time=None, record=None,
                 postmortem_dir=None):
        self.reason = reason
        self.iteration = iteration
        self.sim_time = sim_time
        self.record = record
        self.postmortem_dir = postmortem_dir
        super().__init__(reason)


class SilentCorruptionError(SolverHealthError):
    """
    Silent data corruption detected by the SDC sentinel
    (tools/resilience.py, [resilience] SDC_CADENCE; dedalus_tpu/tools/
    exceptions.py:49): a redundant re-execution of the last step from the
    anchor snapshot did not reproduce the live state bit for bit. The
    corrupted state is still plausible, so recovery rewinds without a dt
    backoff (the numerics are fine; the bits are not).

    Extra attributes: mismatched (element count that differed),
    anchor_iteration (the trusted snapshot the re-execution ran from).
    """

    def __init__(self, reason, mismatched=None, anchor_iteration=None,
                 **kwargs):
        self.mismatched = mismatched
        self.anchor_iteration = anchor_iteration
        super().__init__(reason, **kwargs)


class CheckpointError(DedalusError, OSError):
    """
    Structured checkpoint load/validation failure: names the file and the
    write index that failed (and the underlying cause) instead of a raw
    h5py or numpy traceback (dedalus_tpu/tools/exceptions.py:71).
    Subclasses OSError so callers that guarded an h5py OSError keep
    working.

    Attributes: path (str), index (write index attempted, or None for a
    file-level failure).
    """

    def __init__(self, message, path=None, index=None):
        self.path = str(path) if path is not None else None
        self.index = index
        super().__init__(message)
