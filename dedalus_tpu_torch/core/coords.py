"""
Coordinate systems (counterpart of dedalus_tpu/core/coords.py: Cartesian
systems, direct products, polar coordinates, the two-sphere and spherical
coordinates). Coordinates are pure
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


class DirectProduct(CoordinateSystem):
    """
    Direct product of coordinate systems, the cylinder's coordinates, e.g.
    DirectProduct(Coordinate('z'), PolarCoordinates('phi', 'r'))
    (dedalus_tpu/core/coords.py:130; reference: core/coords.py:99
    DirectProduct).

    Tensor components over the product concatenate the factors' components
    in order; the coordinate -> spin map is the block diagonal of the
    factors' maps (identity on straight factors), so a cylinder vector
    stores (z, spin-, spin+) components in coefficient space.
    """

    def __init__(self, *coordsystems, right_handed=None):
        self.coordsystems = tuple(coordsystems)
        coords = []
        for cs in coordsystems:
            coords.extend(cs.coords)
        names = tuple(c.name for c in coords)
        if len(set(names)) != len(names):
            raise ValueError("Cannot repeat coordinate names in DirectProduct.")
        self.coords = tuple(coords)
        self.names = names
        self.dim = sum(cs.dim for cs in coordsystems)
        if right_handed is None:
            # a 3-D product with a curvilinear factor is left-handed in its
            # (z, phi, r) order, as in the reference
            right_handed = not (self.dim == 3 and self.curvilinear)
        self.right_handed = right_handed
        self.dist = None

    def __repr__(self):
        return f"DirectProduct{self.names}"

    def __eq__(self, other):
        # the same factors in the same order: equal flattened names alone
        # would alias distinct products in the cached intertwiners
        return (isinstance(other, DirectProduct)
                and self.coordsystems == other.coordsystems)

    def __hash__(self):
        return hash(("DirectProduct",)
                    + tuple((type(cs).__name__,) + tuple(cs.names)
                            for cs in self.coordsystems))

    @property
    def _cache_token(self):
        return ("DirectProduct",
                tuple(cs._cache_token for cs in self.coordsystems))

    @property
    def curvilinear(self):
        return any(isinstance(cs, CurvilinearCoordinateSystem)
                   for cs in self.coordsystems)

    @property
    def spin_ordering(self):
        """The factors' spin labels concatenated (zeros on straight
        factors)."""
        out = []
        for cs in self.coordsystems:
            out.extend(getattr(cs, "spin_ordering", (0,) * cs.dim))
        return tuple(out)

    def set_distributor(self, dist):
        self.dist = dist
        for cs in self.coordsystems:
            cs.set_distributor(dist)

    def sub_slice(self, sub_cs):
        """The component slice of the factor equal to `sub_cs`."""
        start = 0
        for cs in self.coordsystems:
            if cs == sub_cs:
                return slice(start, start + cs.dim)
            start += cs.dim
        raise ValueError(f"{sub_cs} is not a factor of {self}.")

    def curvilinear_sub(self):
        """The (single) curvilinear factor, or None."""
        subs = [cs for cs in self.coordsystems
                if isinstance(cs, CurvilinearCoordinateSystem)]
        if len(subs) > 1:
            raise NotImplementedError(
                "Products of multiple curvilinear systems.")
        return subs[0] if subs else None

    def U_forward(self):
        """The block-diagonal coordinate -> spin map of one tensor index."""
        import scipy.linalg
        return scipy.linalg.block_diag(*[
            cs.U_forward() if hasattr(cs, "U_forward") else np.eye(cs.dim)
            for cs in self.coordsystems])

    def U_backward(self):
        return self.U_forward().T.conj()


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
