"""
Coordinate systems (counterpart of dedalus_tpu/core/coords.py: Cartesian
systems, polar coordinates, the two-sphere and spherical coordinates). Coordinates are pure
metadata: axis names and ordering, plus, for the curvilinear systems, the
small unitary intertwiner mapping tensor components to spin components.
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


class AzimuthalCoordinate(Coordinate):
    """Periodic azimuthal coordinate of a curvilinear system
    (reference: core/coords.py AzimuthalCoordinate)."""


class CurvilinearCoordinateSystem(CoordinateSystem):
    """Base for curvilinear systems: defines spin intertwiners
    (reference: core/coords.py CurvilinearCoordinateSystem)."""


class PolarCoordinates(CurvilinearCoordinateSystem):
    """
    Polar coordinates (azimuth, radius); spin ordering (-, +)
    (dedalus_tpu/core/coords.py:241; reference: core/coords.py:255
    PolarCoordinates).
    """

    spin_ordering = (-1, +1)
    dim = 2
    right_handed = True

    def __init__(self, azimuth, radius):
        self.names = (azimuth, radius)
        self.azimuth = AzimuthalCoordinate(azimuth, cs=self)
        self.radius = Coordinate(radius, cs=self)
        self.coords = (self.azimuth, self.radius)
        self.dist = None

    def __repr__(self):
        return f"PolarCoordinates{self.names}"

    @classmethod
    def U_forward(cls):
        """The unitary coordinate -> spin map of one tensor index:
        u[+-] = (u[r] +- 1j u[phi]) / sqrt(2), rows in spin order (-, +),
        columns (phi, r) (reference: core/coords.py:282 _U_forward)."""
        Ui = {+1: np.array([+1j, 1]) / np.sqrt(2),
              -1: np.array([-1j, 1]) / np.sqrt(2)}
        return np.array([Ui[spin] for spin in cls.spin_ordering])


class S2Coordinates(CurvilinearCoordinateSystem):
    """
    Two-sphere coordinates (azimuth, colatitude); spin ordering (-, +)
    (dedalus_tpu/core/coords.py:276; reference: core/coords.py:201
    S2Coordinates).
    """

    spin_ordering = (-1, +1)
    dim = 2
    right_handed = True

    def __init__(self, azimuth, colatitude):
        self.names = (azimuth, colatitude)
        self.azimuth = AzimuthalCoordinate(azimuth, cs=self)
        self.colatitude = Coordinate(colatitude, cs=self)
        self.coords = (self.azimuth, self.colatitude)
        self.dist = None

    def __repr__(self):
        return f"S2Coordinates{self.names}"

    @classmethod
    def U_forward(cls):
        """The unitary coordinate -> spin map of one tensor index:
        u[+-] = (u[theta] +- 1j u[phi]) / sqrt(2), rows in spin order,
        columns (phi, theta) (reference: core/coords.py:216)."""
        Ui = {+1: np.array([+1j, 1]) / np.sqrt(2),
              -1: np.array([-1j, 1]) / np.sqrt(2)}
        return np.array([Ui[spin] for spin in cls.spin_ordering])


class SphericalCoordinates(CurvilinearCoordinateSystem):
    """
    Spherical coordinates (azimuth, colatitude, radius); spin and
    regularity ordering (-, +, 0) (dedalus_tpu/core/coords.py:314;
    reference: core/coords.py:315 SphericalCoordinates). The angular
    coordinate objects are shared with the embedded S2Coordinates, so
    sphere bases built on `S2coordsys` see the distributor's axes.
    """

    spin_ordering = (-1, +1, 0)
    reg_ordering = (-1, +1, 0)
    dim = 3
    right_handed = False

    def __init__(self, azimuth, colatitude, radius):
        self.names = (azimuth, colatitude, radius)
        self.S2coordsys = S2Coordinates(azimuth, colatitude)
        self.azimuth = self.S2coordsys.azimuth
        self.colatitude = self.S2coordsys.colatitude
        self.radius = Coordinate(radius, cs=self)
        self.coords = (self.azimuth, self.colatitude, self.radius)
        self.dist = None

    def __repr__(self):
        return f"SphericalCoordinates{self.names}"

    @classmethod
    def U_forward(cls):
        """The unitary coordinate -> spin map of one tensor index:
        u[+-] = (u[theta] +- 1j u[phi]) / sqrt(2), u[0] = u[r], rows in
        spin order (-, +, 0), columns (phi, theta, r) (reference:
        core/coords.py:337)."""
        Ui = {+1: np.array([+1j, 1, 0]) / np.sqrt(2),
              -1: np.array([-1j, 1, 0]) / np.sqrt(2),
              0: np.array([0, 0, 1.0])}
        return np.array([Ui[spin] for spin in cls.spin_ordering])

    @classmethod
    def U_backward(cls):
        return cls.U_forward().T.conj()

    @classmethod
    def Q_backward(cls, ell, order):
        """The orthogonal regularity -> spin map of `order` indices at
        harmonic degree ell (reference: core/coords.py:359 _Q_backward)."""
        from ..libraries.spin_intertwiners import regularity_to_spin
        return regularity_to_spin(ell, order, cls.reg_ordering)

    @classmethod
    def Q_forward(cls, ell, order):
        return cls.Q_backward(ell, order).T
