"""
Numerical health checks (counterpart of dedalus_tpu/tools/health.py).

Only the explicit value check of the JAX package's HealthMonitor
(`HealthMonitor.check_values`, dedalus_tpu/tools/health.py:404) is here:
the differentiable-solve path routes its loss and gradients through it.
The cadence-gated state probe, the growth bounds and the flight recorder
of the rest of HealthMonitor are not ported yet.
"""

import torch

from .exceptions import SolverHealthError

__all__ = ["check_values"]


def _leaves(tree):
    """The tensors of a nested structure of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
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
    leaves = _leaves(tree)
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
