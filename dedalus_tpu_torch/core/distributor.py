"""
Distributor: device placement and field factories (counterpart of
dedalus_tpu/core/distributor.py, single-device path; Cartesian systems,
polar coordinates (disk, annulus) and the two-sphere).

The distributor carries the torch device every field and solver array of
the problem lives on. It defaults to `cuda` and raises when no CUDA device
is present: a run that asked for the card never carries on on the CPU.
Pass `device="cpu"` to run on the host (the tests do).
"""

import numpy as np
import torch

from .coords import Coordinate, CoordinateSystem


def resolve_device(device=None):
    """The torch device for `device` (default `cuda`); raises when a CUDA
    device is asked for and none is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available; pass device='cpu' to run on the "
            "host.")
    return device


class Distributor:

    def __init__(self, coordsystems, dtype=np.float64, device=None):
        if isinstance(coordsystems, CoordinateSystem):
            coordsystems = (coordsystems,)
        self.coordsystems = tuple(coordsystems)
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        # Flatten coordinates and assign axes.
        coords = []
        for cs in self.coordsystems:
            cs.set_distributor(self)
            for coord in cs.coords:
                coord.axis = len(coords)
                coords.append(coord)
        self.coords = tuple(coords)
        self.dim = len(coords)

    # ------------------------------------------------------------ factories

    def Field(self, name=None, bases=None, dtype=None, tensorsig=()):
        from .field import Field
        return Field(self, bases=bases, name=name, tensorsig=tensorsig,
                     dtype=dtype or self.dtype)

    def VectorField(self, coordsys, name=None, bases=None, dtype=None):
        from .field import Field
        return Field(self, bases=bases, name=name, tensorsig=(coordsys,),
                     dtype=dtype or self.dtype)

    def TensorField(self, coordsys, name=None, bases=None, dtype=None,
                    order=2):
        """A field with `order` indices over `coordsys` (or the tensor
        signature `coordsys` when it is a tuple)."""
        from .field import Field
        tensorsig = coordsys if isinstance(coordsys, tuple) \
            else (coordsys,) * order
        return Field(self, bases=bases, name=name, tensorsig=tensorsig,
                     dtype=dtype or self.dtype)

    # -------------------------------------------------------------- helpers

    def get_axis(self, coord):
        if isinstance(coord, Coordinate):
            return coord.axis
        return coord.first_axis

    def get_coord(self, name):
        """The Coordinate object with the given name (the single name
        lookup behind f(z=...) and string coord specs)."""
        for coord in self.coords:
            if coord.name == name:
                return coord
        raise ValueError(f"Unknown coordinate name: {name!r}")

    def expand_bases(self, bases):
        """Expand a basis/tuple-of-bases spec to a full per-axis tuple."""
        full = [None] * self.dim
        if bases is None:
            return tuple(full)
        if not isinstance(bases, (tuple, list)):
            bases = (bases,)
        seen = set()
        for basis in bases:
            if basis is None or id(basis) in seen:
                continue
            seen.add(id(basis))
            axis = self.get_axis(basis.coord)
            for sub in range(basis.dim):
                if full[axis + sub] is not None:
                    raise ValueError(f"Multiple bases along axis {axis + sub}")
                full[axis + sub] = basis
        return tuple(full)

    def remedy_scales(self, scales):
        if scales is None:
            scales = 1.0
        if np.isscalar(scales):
            return (float(scales),) * self.dim
        return tuple(float(s) for s in scales)

    def local_grid(self, basis, scale=None):
        """Grid points of `basis`, shaped for broadcasting over the domain."""
        scale = 1.0 if scale is None else scale
        grid = basis.global_grid(scale)
        axis = self.get_axis(basis.coord)
        shape = [1] * self.dim
        shape[axis] = grid.size
        return grid.reshape(shape)

    def local_grids(self, *bases, scales=None):
        """Broadcast-shaped grids at `scales` (e.g. the dealias scale); a
        two-axis basis yields one grid per sub-axis (`phi, r =
        dist.local_grids(disk)`, `phi, theta = dist.local_grids(sphere)`)."""
        scales = self.remedy_scales(scales)
        out = []
        for b in bases:
            first = self.get_axis(b.coord)
            if b.dim == 1:
                out.append(self.local_grid(b, scales[first]))
                continue
            grids = b.global_grids(tuple(scales[first:first + b.dim]))
            for sub, grid in enumerate(grids):
                shape = [1] * self.dim
                shape[first + sub] = grid.size
                out.append(np.reshape(grid, shape))
        return tuple(out)
