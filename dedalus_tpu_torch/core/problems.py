"""
Problem classes (counterpart of dedalus_tpu/core/problems.py: the IVP).

Equations enter as strings (parsed with Python eval over a namespace of
variables + operator parseables + the user's namespace; reference:
core/problems.py:74-76) or as (LHS, RHS) operand tuples, and are split into
matrix expressions  M.dt(X) + L.X = F(X,t)  (reference:
core/problems.py:319-362).
"""

import numpy as np

from .field import Field
from .future import Future
from .operators import parseables, TimeDerivative, ConvertNode
from .arithmetic import Add, _union_domain, _is_scalar
from ..tools.parsing import split_equation
from ..tools.exceptions import UnsupportedEquationError, SymbolicParsingError


def _public_parseables():
    """Public operator/arithmetic names usable in equation strings
    (reference: core/problems.py:28-33)."""
    from . import operators as ops
    from .arithmetic import DotProduct
    return {"Lift": ops.Lift, "Gradient": ops.Gradient,
            "Divergence": ops.Divergence, "Laplacian": ops.Laplacian,
            "Differentiate": ops.Differentiate,
            "DotProduct": DotProduct, "dot": DotProduct}


def _flatten_terms(expr):
    """Flatten an expression into additive terms."""
    if isinstance(expr, Add):
        out = []
        for a in expr.args:
            out.extend(_flatten_terms(a))
        return out
    return [expr]


def _contains_marker(expr, marker):
    if expr is marker:
        return True
    if isinstance(marker, type) and isinstance(expr, marker):
        return True
    if isinstance(expr, Future):
        return any(_contains_marker(a, marker) for a in expr.args
                   if isinstance(a, (Field, Future)))
    return False


def _strip_dt(expr):
    """Replace dt(X) -> X; the result must contain no further dt."""
    if isinstance(expr, TimeDerivative):
        operand = expr.operand
        if _contains_marker(operand, TimeDerivative):
            raise UnsupportedEquationError("Nested time derivatives are not supported.")
        return operand
    if isinstance(expr, Future):
        new_args = [(_strip_dt(a) if isinstance(a, (Field, Future)) else a)
                    for a in expr.args]
        return expr.rebuild(new_args)
    return expr


class ProblemBase:
    """Base problem (reference: core/problems.py:27 ProblemBase)."""

    def __init__(self, variables, namespace=None, time="t"):
        if not variables:
            raise ValueError("Problems require at least one variable.")
        self.variables = list(variables)
        self.dist = variables[0].dist
        self.equations = []
        self.time_name = time
        self._user_namespace = dict(namespace or {})
        self.LHS_variables = self.variables

    @property
    def namespace(self):
        ns = {}
        ns.update(parseables)
        ns.update(_public_parseables())
        ns["np"] = np
        for var in self.variables:
            if var.name:
                ns[var.name] = var
        for coord in self.dist.coords:
            ns.setdefault(coord.name, coord)
        ns.update(self._user_namespace)
        return ns

    def add_equation(self, equation, condition=None):
        """
        Add an equation as a string or (LHS, RHS) tuple
        (reference: core/problems.py:67 add_equation).

        `condition` is a per-group guard evaluated over separable group
        indices named 'n' + coordinate name (e.g. "nx != 0"): the equation
        only enters pencil groups satisfying it. Conditioned equations with
        matching (bases, tensor signature) share one row block, exactly one
        active per group (reference: core/subsystems.py:527-541).
        """
        if isinstance(equation, str):
            lhs_str, rhs_str = split_equation(equation)
            ns = self.namespace
            try:
                lhs = eval(lhs_str, {}, ns)
                rhs = eval(rhs_str, {}, ns)
            except Exception as exc:
                raise SymbolicParsingError(
                    f"Failed to parse equation {equation!r}: {exc}") from exc
        else:
            lhs, rhs = equation
        if not isinstance(lhs, (Field, Future)):
            raise UnsupportedEquationError("Equation LHS must involve variables.")
        eq = self._build_matrix_expressions(lhs, rhs)
        eq["LHS_str"] = str(lhs)
        eq["condition"] = condition
        self.equations.append(eq)
        return eq

    # -- helpers shared by problem types --

    def _eq_domain(self, exprs):
        operands = [e for e in exprs if isinstance(e, (Field, Future))]
        domain = _union_domain(self.dist, operands)
        tensorsigs = {tuple(op.tensorsig) for op in operands}
        if len(tensorsigs) != 1:
            raise UnsupportedEquationError("LHS terms have mismatched tensor signatures.")
        return domain, next(iter(tensorsigs))

    def _wrap(self, expr, domain):
        if expr is None:
            return None
        if tuple(expr.domain.bases) == domain.bases:
            return expr
        return ConvertNode(expr, domain.bases)

    def _wrap_rhs(self, rhs, domain, tensorsig):
        if rhs is None or (_is_scalar(rhs) and rhs == 0):
            return None
        if _is_scalar(rhs):
            if tensorsig:
                raise UnsupportedEquationError("Scalar RHS for a tensor equation.")
            const = self.dist.Field(name=f"const_{len(self.equations)}")
            const["g"] = rhs
            rhs = const
        if tuple(rhs.tensorsig) != tuple(tensorsig):
            raise UnsupportedEquationError("RHS tensor signature does not match LHS.")
        return self._wrap(rhs, domain)

    def build_solver(self, *args, **kw):
        raise NotImplementedError


class IVP(ProblemBase):
    """Initial value problem: M.dt(X) + L.X = F
    (reference: core/problems.py:241 IVP)."""

    def __init__(self, variables, namespace=None, time="t"):
        super().__init__(variables, namespace=namespace, time=time)
        self.time = self.dist.Field(name=time)
        self._user_namespace.setdefault(time, self.time)
        self.sim_time = 0.0

    def _build_matrix_expressions(self, lhs, rhs):
        terms = _flatten_terms(lhs)
        m_terms, l_terms = [], []
        for term in terms:
            if _is_scalar(term):
                if term != 0:
                    raise UnsupportedEquationError("Constant terms belong on the RHS.")
                continue
            if _contains_marker(term, TimeDerivative):
                m_terms.append(_strip_dt(term))
            else:
                l_terms.append(term)
        M_expr = Add(*m_terms) if len(m_terms) > 1 else (m_terms[0] if m_terms else None)
        L_expr = Add(*l_terms) if len(l_terms) > 1 else (l_terms[0] if l_terms else None)
        domain, tensorsig = self._eq_domain([e for e in (M_expr, L_expr) if e is not None])
        return {"domain": domain, "tensorsig": tensorsig,
                "M": self._wrap(M_expr, domain),
                "L": self._wrap(L_expr, domain),
                "F": self._wrap_rhs(rhs, domain, tensorsig)}

    def build_solver(self, timestepper, **kw):
        from .solvers import InitialValueSolver
        return InitialValueSolver(self, timestepper, **kw)
