"""
Domains: cached direct products of bases (counterpart of
dedalus_tpu/core/domain.py).

A Domain is a tuple of bases indexed by distributor axis, with `None` marking
axes along which fields are constant (size-1 in both layouts).
"""

from ..tools.cache import CachedClass


class Domain(metaclass=CachedClass):

    def __init__(self, dist, bases):
        bases = tuple(bases)
        if len(bases) != dist.dim:
            raise ValueError("Domain needs one basis (or None) per distributor axis.")
        self.dist = dist
        self.bases = bases

    def get_basis(self, coord):
        for basis in self.bases:
            if basis is None:
                continue
            if basis.coord is coord:
                return basis
            if getattr(coord, "coords", None) and basis.coord in coord.coords:
                return basis
            cs = getattr(basis, "coordsystem", None)
            if cs is not None and (coord is cs or coord in cs.coords):
                return basis
        return None

    @property
    def dim(self):
        return self.dist.dim

    @property
    def coeff_shape(self):
        return tuple(1 if b is None else b.coeff_size(axis - b.first_axis)
                     for axis, b in enumerate(self.bases))

    def grid_shape(self, scales):
        scales = self.dist.remedy_scales(scales)
        return tuple(1 if b is None else b.sub_grid_size(axis - b.first_axis, s)
                     for axis, (b, s) in enumerate(zip(self.bases, scales)))

    @property
    def dealias(self):
        out = []
        for axis, b in enumerate(self.bases):
            if b is None:
                out.append(1.0)
            elif isinstance(b.dealias, tuple):
                out.append(b.dealias[axis - b.first_axis])
            else:
                out.append(b.dealias)
        return tuple(out)

    @property
    def coeff_dtype_is_complex(self):
        from .basis import ComplexFourier
        return any(isinstance(b, ComplexFourier) for b in self.bases)

    def __repr__(self):
        return f"Domain({self.bases})"

    def substitute_basis(self, old_basis, new_basis):
        """This domain with `old_basis` replaced by `new_basis` on every
        axis it spans."""
        bases = tuple(new_basis if b is old_basis else b for b in self.bases)
        return Domain(self.dist, bases)
