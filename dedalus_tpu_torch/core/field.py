"""
Operands and Fields (counterpart of dedalus_tpu/core/field.py).

`Operand` is the arithmetic-overload base: `+ - * / @` and calls build
symbolic expression nodes (reference: core/field.py:39-327). `Field` is the
concrete data container: a torch tensor on the distributor's device plus a
current layout tag ('c' coefficient / 'g' grid) and grid scales.

User-facing Fields behave like the reference's (mutable layout walked on
access); the solver hot loop never touches Fields — it works on the (G, S)
pencil state tensor (see solvers.py). Field data tensors are never updated
in place: every write replaces `field.data` wholesale.
"""

import numpy as np
import torch

from .domain import Domain
from ..tools.array import torch_dtype, to_numpy
from ..tools.general import is_complex_dtype


def transform_to_coeff(data, domain, scales, tdim, library=None, tensorsig=()):
    """Full grid -> full coefficient transform, first axis first
    (reference layout-walk direction: core/distributor.py:128-166)."""
    for axis in range(domain.dim):
        basis = domain.bases[axis]
        if basis is not None:
            data = basis.forward_transform(data, tdim + axis, scales[axis],
                                           library, tensorsig=tensorsig,
                                           sub_axis=axis - basis.first_axis)
    return data


def transform_to_grid(data, domain, scales, tdim, library=None, tensorsig=()):
    """Full coefficient -> full grid transform: last axis first."""
    for axis in range(domain.dim - 1, -1, -1):
        basis = domain.bases[axis]
        if basis is not None:
            data = basis.backward_transform(data, tdim + axis, scales[axis],
                                            library, tensorsig=tensorsig,
                                            sub_axis=axis - basis.first_axis)
    return data


class _FieldDataView(np.ndarray):
    """
    Host ndarray tied to a Field layout: item assignment writes the whole
    array back into the field, emulating the reference's live data views
    (reference: core/field.py:561 __getitem__ returning self.data).
    """

    def __new__(cls, arr, field, layout):
        obj = np.asarray(arr).view(cls)
        obj._field = field
        obj._field_layout = layout
        # Shared mutable cell tracking the field data epoch this view
        # mirrors: all slices of this view share it, so sequential writes
        # through any of them stay valid while external data changes (user
        # mutation OR solver updates) invalidate all.
        obj._view_version = [field._data_epoch]
        return obj

    def __array_finalize__(self, obj):
        # Memory-sharing views (slices) keep the backref so
        # `u['g'][2][...] = v` lands in the field; fresh arrays produced by
        # ufuncs drop it so `w = u['g']*2; w[0] = ...` does not.
        self._field = None
        self._field_layout = None
        self._view_version = None
        if obj is not None and getattr(obj, "_field", None) is not None:
            try:
                shared = np.shares_memory(self, obj)
            except Exception:
                shared = False
            if shared:
                self._field = obj._field
                self._field_layout = obj._field_layout
                self._view_version = obj._view_version

    def _writeback(self):
        field, layout = self._field, self._field_layout
        if field is None:
            return
        if field._data_epoch != self._view_version[0]:
            raise RuntimeError(
                "Writing through a stale field data view: the field's data "
                "changed (user assignment or solver step) after this view "
                f"was taken. Re-read the data (field['{layout}']) and apply "
                "the mutation to the fresh view.")
        root = self
        while isinstance(root.base, np.ndarray):
            root = root.base
        field[layout] = np.asarray(root)
        self._view_version[0] = field._data_epoch

    def __setitem__(self, key, value):
        np.ndarray.__setitem__(self, key, value)
        self._writeback()


def _inplace_with_writeback(name):
    base_op = getattr(np.ndarray, name)

    def op(self, other):
        out = base_op(self, other)
        self._writeback()
        return out
    op.__name__ = name
    return op


for _name in ("__iadd__", "__isub__", "__imul__", "__itruediv__",
              "__ifloordiv__", "__imod__", "__ipow__", "__iand__",
              "__ior__", "__ixor__", "__ilshift__", "__irshift__"):
    setattr(_FieldDataView, _name, _inplace_with_writeback(_name))


class Operand:
    """Base class for everything that can appear in symbolic expressions."""

    __array_priority__ = 100.0  # win dispatch against numpy arrays

    # ---- arithmetic overloads (lazy imports avoid circular deps) ----

    def __add__(self, other):
        from .arithmetic import Add
        if np.isscalar(other) and other == 0:
            return self
        return Add(self, other)

    def __radd__(self, other):
        from .arithmetic import Add
        if np.isscalar(other) and other == 0:
            return self
        return Add(other, self)

    def __sub__(self, other):
        return self + (-1) * other

    def __rsub__(self, other):
        return other + (-1) * self

    def __neg__(self):
        return (-1) * self

    def __mul__(self, other):
        from .arithmetic import Multiply
        return Multiply(self, other)

    def __rmul__(self, other):
        from .arithmetic import Multiply
        return Multiply(other, self)

    def __truediv__(self, other):
        from .arithmetic import Multiply
        if np.isscalar(other):
            return Multiply(1.0 / other, self)
        return NotImplemented

    def __matmul__(self, other):
        from .arithmetic import DotProduct
        return DotProduct(self, other)

    def __rmatmul__(self, other):
        from .arithmetic import DotProduct
        return DotProduct(other, self)

    def __call__(self, **positions):
        """Interpolation: f(x=0.5) (reference: core/field.py API)."""
        from .operators import Interpolate
        out = self
        for name, position in positions.items():
            coord = self._lookup_coord(name)
            out = Interpolate(out, coord, position)
        return out

    def _lookup_coord(self, name):
        return self.dist.get_coord(name)

    def __array_ufunc__(self, ufunc, method, *inputs, **kw):
        """Dispatch numpy binary ufuncs on operands (e.g. a numpy scalar
        times a field) to symbolic nodes (reference: core/field.py:44)."""
        from .arithmetic import Add, Multiply, DotProduct
        if method != "__call__":
            return NotImplemented
        binary = {np.add: Add, np.multiply: Multiply, np.matmul: DotProduct}
        if ufunc in binary and len(inputs) == 2:
            return binary[ufunc](*inputs)
        if ufunc is np.subtract and len(inputs) == 2:
            return inputs[0] - inputs[1]
        if ufunc is np.true_divide and len(inputs) == 2 \
                and isinstance(inputs[0], Operand):
            return inputs[0] / inputs[1]
        if ufunc is np.negative:
            return -inputs[0]
        return NotImplemented

    # ---- symbolic tree API (overridden by Future) ----

    def atoms(self, *types):
        return set()

    def has(self, *operands):
        return any(self is op for op in operands)


class Field(Operand):
    """
    Spectral field (reference: core/field.py:32 Field/ScalarField, with
    VectorField as a tensorsig variant).
    """

    def __init__(self, dist, bases=None, name=None, tensorsig=(), dtype=None):
        self.dist = dist
        self.name = name
        self.tensorsig = tuple(tensorsig)
        self.dtype = np.dtype(dtype or dist.dtype)
        self.domain = Domain(dist, dist.expand_bases(bases))
        self.scales = dist.remedy_scales(1)
        self.layout = "c"
        self.data = torch.zeros(self.coeff_shape,
                                dtype=torch_dtype(self.coeff_dtype),
                                device=dist.device)
        # Solver synchronization: `_version` counts user mutations;
        # `_data_epoch` counts ALL data changes (including solver updates,
        # for data-view staleness detection); `_pull`
        # is a deferred fetch installed by solvers after a step so field data
        # is only scattered from the device state when actually accessed.
        self._version = 0
        self._data_epoch = 0
        self._pull = None

    def atoms(self, *types):
        if not types or isinstance(self, types):
            return {self}
        return set()

    # ---- shapes & dtypes ----

    @property
    def tshape(self):
        return tuple(cs.dim for cs in self.tensorsig)

    @property
    def tdim(self):
        return len(self.tshape)

    @property
    def coeff_dtype(self):
        return self.dtype

    @property
    def grid_dtype(self):
        return self.dtype

    @property
    def coeff_shape(self):
        return self.tshape + self.domain.coeff_shape

    def grid_shape(self, scales=None):
        scales = self.dist.remedy_scales(scales if scales is not None else self.scales)
        return self.tshape + self.domain.grid_shape(scales)

    def __repr__(self):
        return f"Field(name={self.name!r}, bases={self.domain.bases})"

    def __str__(self):
        return self.name or f"F{id(self)%10000}"

    # ---- layout management ----

    def _sync(self):
        if self._pull is not None:
            pull, self._pull = self._pull, None
            pull()

    def require_coeff_space(self):
        self._sync()
        if self.layout == "g":
            self.data = transform_to_coeff(self.data, self.domain,
                                           tuple(self.scales), self.tdim,
                                           tensorsig=self.tensorsig)
            self.layout = "c"
        return self.data

    def require_grid_space(self, scales=None):
        self._sync()
        if scales is not None:
            self.change_scales(scales)
        if self.layout == "c":
            self.data = transform_to_grid(self.data, self.domain,
                                          tuple(self.scales), self.tdim,
                                          tensorsig=self.tensorsig)
            self.layout = "g"
        return self.data

    def change_scales(self, scales):
        scales = self.dist.remedy_scales(scales)
        if scales != self.scales:
            self.require_coeff_space()
            self.scales = scales

    def __getitem__(self, layout):
        # Return a host view that writes back on item assignment, so the
        # reference idiom `u['g'][2] = ...` works (the data lives on the
        # device, so the host view pushes mutations back through
        # __setitem__).
        if layout in ("c", 0, "coeff"):
            return _FieldDataView(to_numpy(self.require_coeff_space()),
                                  self, "c")
        elif layout in ("g", 1, "grid"):
            return _FieldDataView(to_numpy(self.require_grid_space()),
                                  self, "g")
        raise KeyError(f"Unknown layout: {layout}")

    def __setitem__(self, layout, value):
        if layout in ("c", 0, "coeff"):
            new_layout = "c"
            shape, dtype = self.coeff_shape, self.coeff_dtype
        elif layout in ("g", 1, "grid"):
            new_layout = "g"
            shape, dtype = self.grid_shape(), self.grid_dtype
        else:
            raise KeyError(f"Unknown layout: {layout}")
        if isinstance(value, torch.Tensor):
            value = value.to(device=self.dist.device, dtype=torch_dtype(dtype))
        else:
            value = torch.as_tensor(np.asarray(value, dtype=dtype),
                                    device=self.dist.device)
        data = value.expand(shape).contiguous()
        # Only after validation: discard pending solver data, count mutation.
        self._pull = None
        self._version += 1
        self._data_epoch += 1
        self.layout = new_layout
        self.data = data

    # Solver-facing accessors -------------------------------------------------

    def coeff_data(self):
        """Device coefficient tensor (triggers transform if needed)."""
        return self.require_coeff_space()

    def preset_coeff(self, array):
        """Install device coefficient data directly (solver scatter).
        Does not count as a user mutation (no version bump, but existing
        data views become stale); the grid-scale selection is preserved
        (coefficient data is scale-independent)."""
        self.data = array
        self.layout = "c"
        self._data_epoch += 1

    def mark_modified(self):
        self._version += 1

    def install_pull(self, pull):
        """Install a lazy solver-data pull; any outstanding data views
        become stale immediately (the field's data is now solver-owned)."""
        self._pull = pull
        self._data_epoch += 1

    # ---- utilities ----

    def fill_random(self, layout="g", seed=None, distribution="normal", **kw):
        """
        Deterministic random fill (reference: core/field.py:847 fill_random).
        Uses a global-shape numpy RNG, so the JAX package and this port
        draw the same data from the same seed.
        """
        rng = np.random.default_rng(seed)
        if layout in ("g", 1, "grid"):
            shape, dtype = self.grid_shape(), self.grid_dtype
        else:
            shape, dtype = self.coeff_shape, self.coeff_dtype
        scale = kw.pop("scale", 1)
        if distribution in ("normal", "standard_normal"):
            data = rng.standard_normal(shape)
            if is_complex_dtype(dtype):
                data = data + 1j * rng.standard_normal(shape)
        elif distribution == "uniform":
            data = rng.uniform(size=shape, **{k: kw[k] for k in ("low", "high") if k in kw})
        else:
            data = getattr(rng, distribution)(size=shape)
        self[layout] = scale * data.astype(dtype)
