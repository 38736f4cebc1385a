"""
Deferred-evaluation expression nodes (counterpart of
dedalus_tpu/core/future.py).

Each node implements `ev(ctx, layout)` — a torch computation memoized per
(node, layout) within one evaluation pass, so shared subexpressions and
their transforms run once per pass.

Layout protocol: 'c' = full coefficient space (in the node's output bases,
including Jacobi derivative levels), 'g' = full grid space at dealias scales.
"""

from .field import Operand, Field, transform_to_coeff, transform_to_grid


class EvalContext:
    """Carries substitutions (Field -> coeff tensor) and the memo of one
    evaluation pass."""

    def __init__(self, subs=None):
        self.subs = subs or {}
        self.memo = {}

    def field_data(self, field, layout):
        key = (id(field), layout)
        if key in self.memo:
            return self.memo[key]
        if field in self.subs:
            coeff = self.subs[field]
        else:
            coeff = field.coeff_data()
        if layout == "c":
            out = coeff
        else:
            out = transform_to_grid(coeff, field.domain, field.domain.dealias,
                                    field.tdim, tensorsig=field.tensorsig)
        self.memo[key] = out
        return out


def ev(node, ctx, layout):
    """Evaluate an operand (Field, Future, or scalar) in the given layout."""
    if isinstance(node, Field):
        return ctx.field_data(node, layout)
    if isinstance(node, Future):
        return node.ev(ctx, layout)
    # plain number
    return node


class Future(Operand):
    """Expression-tree node base (reference: core/future.py:22 Future)."""

    name = "Future"
    natural_layout = "g"

    def __init__(self, *args):
        self.args = list(args)
        self.dist = self._find_dist(args)
        self._build_metadata()

    @staticmethod
    def _find_dist(args):
        for arg in args:
            if isinstance(arg, (Field, Future)):
                return arg.dist
        raise ValueError("Expression has no field operands.")

    def _build_metadata(self):
        """Subclasses set self.domain, self.tensorsig, self.dtype."""
        raise NotImplementedError

    @property
    def tshape(self):
        return tuple(cs.dim for cs in self.tensorsig)

    @property
    def tdim(self):
        return len(self.tensorsig)

    def __repr__(self):
        argstr = ", ".join(map(str, self.args))
        return f"{self.name}({argstr})"

    __str__ = __repr__

    # ------------------------------------------------------------ evaluation

    def ev(self, ctx, layout):
        key = (id(self), layout)
        if key in ctx.memo:
            return ctx.memo[key]
        if layout == self.natural_layout:
            out = self.ev_impl(ctx)
        elif layout == "g":
            out = transform_to_grid(self.ev(ctx, "c"), self.domain,
                                    self.domain.dealias, self.tdim,
                                    tensorsig=self.tensorsig)
        else:
            out = transform_to_coeff(self.ev(ctx, "g"), self.domain,
                                     self.domain.dealias, self.tdim,
                                     tensorsig=self.tensorsig)
        ctx.memo[key] = out
        return out

    def ev_impl(self, ctx):
        raise NotImplementedError

    def evaluate(self):
        """Host-facing evaluation: returns a new Field with this node's
        data, computed from the current data of every Field atom."""
        data = self.ev(EvalContext(), "c")
        out = Field(self.dist, bases=self.domain.bases, tensorsig=self.tensorsig,
                    dtype=self.dtype)
        out.preset_coeff(data)
        return out

    # --------------------------------------------------------- symbolic API

    def operand_args(self):
        return [a for a in self.args if isinstance(a, (Field, Future))]

    def atoms(self, *types):
        out = set()
        if not types or isinstance(self, types):
            out.add(self)
        for arg in self.operand_args():
            if isinstance(arg, Future):
                out |= arg.atoms(*types)
            elif not types or isinstance(arg, types):
                out.add(arg)
        return out

    def has(self, *operands):
        for op in operands:
            if self is op:
                return True
            if isinstance(op, type) and isinstance(self, op):
                return True
        return any(isinstance(a, (Field, Future)) and _has(a, operands)
                   for a in self.args)

    def rebuild(self, new_args):
        return type(self)(*new_args)

    # -------------------------------------------------- matrix construction

    def expression_matrices(self, subproblem, vars, **kw):
        """Sparse matrices mapping each var's pencil to this node's pencil
        (reference: core/operators.py:739 expression_matrices)."""
        raise NotImplementedError(f"{type(self).__name__} has no matrix form.")


def _has(operand, operands):
    if isinstance(operand, Future):
        return operand.has(*operands)
    return any(operand is op for op in operands
               if not isinstance(op, type))
