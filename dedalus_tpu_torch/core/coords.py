"""
Coordinate systems (counterpart of dedalus_tpu/core/coords.py, Cartesian
subset). Coordinates are pure metadata: axis names and ordering.
"""

import numpy as np


class CoordinateSystem:
    """Base class for coordinate systems."""

    def __eq__(self, other):
        return (type(self) is type(other)) and (self.names == other.names)

    def __hash__(self):
        return hash((type(self).__name__,) + tuple(self.names))

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.coords[self.names.index(key)]
        return self.coords[key]

    @property
    def first_axis(self):
        return self.coords[0].axis

    @property
    def _cache_token(self):
        """Interning key for CachedClass arguments (tools/cache.serialize):
        name-equality PLUS the distributor-assigned axes, so equal-named
        systems at different axis positions never alias cached bases."""
        return (type(self).__name__, self.names,
                tuple(getattr(c, "axis", None) for c in self.coords))

    def set_distributor(self, dist):
        self.dist = dist
        for coord in self.coords:
            coord.dist = dist

    def unit_vector_fields(self, dist):
        """Constant unit vector fields e_1 .. e_dim."""
        fields = []
        for i, name in enumerate(self.names):
            ei = dist.VectorField(self, name=f"e{name}")
            data = np.zeros(self.dim)
            data[i] = 1.0
            ei["g"] = data.reshape((self.dim,) + (1,) * dist.dim)
            fields.append(ei)
        return tuple(fields)


class Coordinate(CoordinateSystem):
    """A single named coordinate (reference: core/coords.py:66)."""

    dim = 1

    def __init__(self, name, cs=None):
        self.name = name
        self.names = (name,)
        self.cs = cs
        self.coords = (self,)
        self.dist = None
        self.axis = None  # set by Distributor

    def __repr__(self):
        return f"Coordinate({self.name!r})"

    def __eq__(self, other):
        return isinstance(other, Coordinate) and self.name == other.name and self.cs == other.cs

    def __hash__(self):
        return hash(("Coordinate", self.name))

    @property
    def _cache_token(self):
        # mirror __eq__ (name + owning system) plus the assigned axis
        cs_token = None
        if self.cs is not None:
            cs_token = (type(self.cs).__name__, tuple(self.cs.names))
        return ("Coordinate", self.name, getattr(self, "axis", None), cs_token)

    def set_distributor(self, dist):
        self.dist = dist


class CartesianCoordinates(CoordinateSystem):
    """
    Cartesian coordinate system of any dimension
    (reference: core/coords.py:159).
    """

    def __init__(self, *names, right_handed=True):
        if len(set(names)) != len(names):
            raise ValueError("Coordinate names must be unique.")
        self.names = tuple(names)
        self.dim = len(names)
        self.right_handed = right_handed
        self.coords = tuple(Coordinate(name, cs=self) for name in names)
        self.dist = None

    def __repr__(self):
        return f"CartesianCoordinates{self.names}"
