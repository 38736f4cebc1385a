"""
Problem classes (counterpart of dedalus_tpu/core/problems.py): IVP, LBVP,
NLBVP, EVP.

Equations enter as strings (parsed with Python eval over a namespace of
variables + operator parseables + the user's namespace; reference:
core/problems.py:74-76) or as (LHS, RHS) operand tuples, and are split into
matrix expressions:

  IVP:   M.dt(X) + L.X = F(X,t)     (reference: core/problems.py:319-362)
  LBVP:  L.X = F                    (:156)
  EVP:   lam*M.X + L.X = 0          (:466)
  NLBVP: G(X) = H(X), Newton via Frechet differentials (:242)
"""

import numpy as np

from .field import Field
from .future import Future
from .operators import parseables, TimeDerivative, ConvertNode
from .arithmetic import (Add, Multiply, ScalarMultiply, MultiplyFields,
                         _union_domain, _is_scalar)
from ..tools.parsing import split_equation
from ..tools.exceptions import UnsupportedEquationError, SymbolicParsingError


def _public_parseables():
    """Public operator/arithmetic names usable in equation strings
    (reference: core/problems.py:28-33)."""
    from . import operators as ops
    from .arithmetic import DotProduct
    from .sphere import MulCosine
    return {"Lift": ops.Lift, "Gradient": ops.Gradient,
            "Divergence": ops.Divergence, "Laplacian": ops.Laplacian,
            "Differentiate": ops.Differentiate,
            "UnaryGridFunction": ops.UnaryGridFunction,
            "DotProduct": DotProduct, "dot": DotProduct,
            "MulCosine": MulCosine}


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


def _distribute_marker(expr, marker):
    """
    Distribute products over Add factors containing `marker`, so that each
    top-level additive term carries at most one linear marker occurrence
    (dedalus_tpu/core/problems.py:93: lets "(a - 2*q*cos_2x)*y = 0" split
    into eigenvalue and non-eigenvalue terms; reference: core/problems.py:431).
    """
    if not isinstance(expr, (Field, Future)) or expr is marker:
        return expr
    if not _contains_marker(expr, marker):
        return expr
    if isinstance(expr, Add):
        return Add(*[_distribute_marker(a, marker) for a in expr.args])
    if isinstance(expr, ScalarMultiply):
        inner = _distribute_marker(expr.operand, marker)
        if isinstance(inner, Add):
            return Add(*[ScalarMultiply(expr.scalar, t) for t in inner.args])
        return ScalarMultiply(expr.scalar, inner)
    if isinstance(expr, MultiplyFields):
        a, b = expr.args
        a = _distribute_marker(a, marker)
        b = _distribute_marker(b, marker)
        if isinstance(a, Add) and _contains_marker(a, marker):
            return Add(*[_distribute_marker(MultiplyFields(t, b), marker)
                         for t in a.args])
        if isinstance(b, Add) and _contains_marker(b, marker):
            return Add(*[_distribute_marker(MultiplyFields(a, t), marker)
                         for t in b.args])
        # hoist scalar prefactors off the marker side so the linear-factor
        # strip sees MultiplyFields(marker, X) directly (the
        # dt = -1j*omega*A idiom builds ((-1j)*omega)*A)
        if isinstance(a, ScalarMultiply) and _contains_marker(a, marker):
            return ScalarMultiply(a.scalar, _distribute_marker(
                MultiplyFields(a.operand, b), marker))
        if isinstance(b, ScalarMultiply) and _contains_marker(b, marker):
            return ScalarMultiply(b.scalar, _distribute_marker(
                MultiplyFields(a, b.operand), marker))
        return MultiplyFields(a, b)
    if isinstance(expr, Future):
        new_args = [_distribute_marker(arg, marker) for arg in expr.args]
        return expr.rebuild(new_args)
    return expr


def _strip_linear_factor(expr, marker):
    """Remove one linear occurrence of `marker` (a constant Field) from
    expr (dedalus_tpu/core/problems.py:138)."""
    if expr is marker:
        raise UnsupportedEquationError(
            "Eigenvalue must multiply variables, not appear alone.")
    if isinstance(expr, ScalarMultiply):
        return ScalarMultiply(expr.scalar,
                              _strip_linear_factor(expr.operand, marker))
    if isinstance(expr, MultiplyFields):
        a, b = expr.args
        if a is marker:
            return b
        if b is marker:
            return a
        if _contains_marker(a, marker):
            return MultiplyFields(_strip_linear_factor(a, marker), b)
        return MultiplyFields(a, _strip_linear_factor(b, marker))
    if isinstance(expr, Future):
        new_args = []
        for arg in expr.args:
            if isinstance(arg, (Field, Future)) and _contains_marker(arg, marker):
                new_args.append(_strip_linear_factor(arg, marker))
            else:
                new_args.append(arg)
        return expr.rebuild(new_args)
    raise UnsupportedEquationError(f"Cannot strip eigenvalue from {expr!r}")


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


class LBVP(ProblemBase):
    """Linear boundary value problem: L.X = F
    (dedalus_tpu/core/problems.py:256; reference: core/problems.py:128)."""

    def _build_matrix_expressions(self, lhs, rhs):
        if _contains_marker(lhs, TimeDerivative):
            raise UnsupportedEquationError(
                "LBVPs cannot contain time derivatives.")
        domain, tensorsig = self._eq_domain([lhs])
        return {"domain": domain, "tensorsig": tensorsig,
                "L": self._wrap(lhs, domain),
                "F": self._wrap_rhs(rhs, domain, tensorsig)}

    def build_solver(self, **kw):
        from .solvers import LinearBoundaryValueSolver
        return LinearBoundaryValueSolver(self, **kw)


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

    def build_EVP(self, eigenvalue=None, perturbations=None, **kw):
        """
        This IVP as an EVP linearized about the CURRENT variable values
        (dedalus_tpu/core/problems.py:307; reference:
        core/problems.py:364 build_EVP):
            M.dt(X) + L.X = F(X)   ->   lam*M.X1 + L.X1 - F'(X0).X1 = 0
        NCC data in the linearized operators reads the IVP variables, so
        set the background state on them before solving.
        """
        variables = self.variables
        if eigenvalue is None:
            eigenvalue = self.dist.Field(name="lam")
        if perturbations is None:
            perturbations = [
                Field(var.dist, bases=var.domain.bases,
                      tensorsig=var.tensorsig, name=f"d_{var.name}",
                      dtype=var.dtype)
                for var in variables]
        evp = EVP(perturbations, eigenvalue=eigenvalue)
        for eq in self.equations:
            terms = []
            M_expr, L_expr, F_expr = eq.get("M"), eq.get("L"), eq.get("F")
            for expr, scale in ((M_expr, eigenvalue), (L_expr, None)):
                if expr is None:
                    continue
                for var, pert in zip(variables, perturbations):
                    expr = expr.replace(var, pert)
                terms.append(expr if scale is None else Multiply(scale, expr))
            if F_expr is not None:
                if _contains_marker(F_expr, self.time):
                    raise UnsupportedEquationError(
                        "Cannot convert a time-dependent IVP to an EVP.")
                dF = F_expr.frechet_differential(variables, perturbations)
                if not (np.isscalar(dF) and dF == 0):
                    terms.append(ScalarMultiply(-1.0, dF))
            lhs = Add(*terms) if len(terms) > 1 else terms[0]
            evp.add_equation((lhs, 0), condition=eq.get("condition"))
        return evp


class EVP(ProblemBase):
    """Eigenvalue problem: lam*M.X + L.X = 0
    (dedalus_tpu/core/problems.py:351; reference: core/problems.py:410)."""

    def __init__(self, variables, eigenvalue=None, namespace=None, **kw):
        super().__init__(variables, namespace=namespace, **kw)
        if eigenvalue is None:
            raise ValueError("EVP requires an eigenvalue field.")
        self.eigenvalue = eigenvalue

    def _build_matrix_expressions(self, lhs, rhs):
        if not (_is_scalar(rhs) and rhs == 0):
            raise UnsupportedEquationError("EVP equations must have zero RHS.")
        lhs = _distribute_marker(lhs, self.eigenvalue)
        m_terms, l_terms = [], []
        for term in _flatten_terms(lhs):
            if _is_scalar(term):
                continue
            if _contains_marker(term, self.eigenvalue):
                m_terms.append(_strip_linear_factor(term, self.eigenvalue))
            else:
                l_terms.append(term)
        M_expr = Add(*m_terms) if len(m_terms) > 1 else (m_terms[0] if m_terms else None)
        L_expr = Add(*l_terms) if len(l_terms) > 1 else (l_terms[0] if l_terms else None)
        domain, tensorsig = self._eq_domain([e for e in (M_expr, L_expr) if e is not None])
        return {"domain": domain, "tensorsig": tensorsig,
                "M": self._wrap(M_expr, domain),
                "L": self._wrap(L_expr, domain),
                "F": None}

    def build_solver(self, **kw):
        from .solvers import EigenvalueSolver
        return EigenvalueSolver(self, **kw)


class NLBVP(ProblemBase):
    """Nonlinear boundary value problem solved by Newton-Kantorovich
    iteration (dedalus_tpu/core/problems.py:386; reference:
    core/problems.py:196): each equation's residual G = lhs - rhs is
    linearized by its Frechet differential in the perturbations."""

    def __init__(self, variables, namespace=None, **kw):
        super().__init__(variables, namespace=namespace, **kw)
        self.perturbations = [
            Field(var.dist, bases=var.domain.bases, tensorsig=var.tensorsig,
                  name=f"d_{var.name}", dtype=var.dtype)
            for var in self.variables]

    def _build_matrix_expressions(self, lhs, rhs):
        if _is_scalar(rhs) and rhs == 0:
            residual = lhs
        elif _is_scalar(rhs):
            const = self.dist.Field(name=f"const_{len(self.equations)}")
            const["g"] = rhs
            residual = lhs - const
        else:
            residual = lhs - rhs
        dG = residual.frechet_differential(self.variables, self.perturbations)
        if _is_scalar(dG):
            raise UnsupportedEquationError(
                "Equation has no dependence on variables.")
        domain, tensorsig = self._eq_domain([dG])
        return {"domain": domain, "tensorsig": tensorsig,
                "L": self._wrap(dG, domain),
                "residual": residual,
                "F": None}

    def build_solver(self, **kw):
        from .solvers import NonlinearBoundaryValueSolver
        return NonlinearBoundaryValueSolver(self, **kw)
