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

