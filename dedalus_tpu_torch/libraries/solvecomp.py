"""
The solve plan (counterpart of dedalus_tpu/libraries/solvecomp.py, minimal
subset): the port carries the default composition only — the sequential
substitution in the native dtype — so the one setting left to resolve is
the refinement sweep count that `BandedOps` reads. The log-depth
compositions (ascan/spike) and the mixed-precision ladder are not carried.
"""

from ..tools.config import config

# sweeps per solve under REFINE_SWEEPS = auto: the JAX package's native
# default (its BandedOps.refine)
AUTO_SWEEPS = 1


def resolve_refine_sweeps():
    """Resolve `[precision] REFINE_SWEEPS`: auto = AUTO_SWEEPS, or an
    integer >= 0."""
    raw = config["precision"].get("REFINE_SWEEPS", "auto") \
        if config.has_section("precision") else "auto"
    raw = raw.strip().lower()
    if raw in ("auto", ""):
        return AUTO_SWEEPS
    try:
        sweeps = int(raw)
    except ValueError:
        raise ValueError(
            f"[precision] REFINE_SWEEPS = {raw!r} is not a recognized "
            "value (auto or an integer >= 0)")
    if sweeps < 0:
        raise ValueError(f"[precision] REFINE_SWEEPS = {sweeps} must be >= 0")
    return sweeps
