"""
Flow diagnostics and adaptive timestep control (counterpart of
dedalus_tpu/extras/flow_tools.py: Cartesian, polar, S2 and spherical
geometry).

CFL frequencies are computed on the solver's device and reduced to one
host scalar per velocity; flow properties reduce the numpy arrays their
dictionary handler holds.
"""

from collections import deque

import numpy as np
import torch


def _axis_profile(values, axis, ndim):
    """Reshape a 1D per-axis profile for broadcasting over the grid."""
    shape = [1] * ndim
    shape[axis] = np.size(values)
    return np.reshape(values, shape)


def interval_cfl_spacing(basis):
    """
    Local grid spacing of an interval basis at dealias scales, rescaled
    by dealias so the frequency reflects the nominal resolution
    (reference: core/basis.py:6091 CartesianAdvectiveCFL.cfl_spacing).
    """
    from ..core.basis import Jacobi, FourierBase
    dealias = basis.dealias if np.isscalar(basis.dealias) else basis.dealias[0]
    grid = basis.global_grid(dealias)
    N = grid.size
    if isinstance(basis, FourierBase):
        # uniform: dealias * (2 pi / N_dealias) * stretch
        return np.full(N, dealias * 2 * np.pi / N * basis.COV.stretch)
    if isinstance(basis, Jacobi) and basis.a0 == -0.5 and basis.b0 == -0.5:
        # Chebyshev: analytic sin(theta) spacing
        theta = np.pi * (np.arange(N) + 0.5) / N
        return dealias * basis.COV.stretch * np.sin(theta) * np.pi / N
    return dealias * (np.gradient(grid) if N > 1 else np.array([np.inf]))


def _device_profile(values, axis, ndim, like):
    """A per-axis spacing profile as a tensor on `like`'s device, shaped
    for broadcasting over the grid."""
    return torch.as_tensor(_axis_profile(values, axis, ndim),
                           dtype=like.dtype, device=like.device)


def advective_cfl_frequency(u, ug):
    """
    Advective CFL frequency of velocity field `u`, from its grid tensor
    `ug` on the dealias grid (reference: core/basis.py:6086-6215
    *AdvectiveCFL.cfl_spacing): sum_i |u_i| / dx_i with Cartesian
    spacings, |u_phi| / dphi + |u_r| / dr on a disk or annulus
    (components (phi, r)), |u_angular| k / R on the sphere with
    k = sqrt(Lmax (Lmax + 1)), on the shell |u_angular| k / r + |u_r| / dr
    and on the ball |u_angular| k / R + |u_r| / dr (components (phi,
    theta, r); dedalus_tpu/extras/flow_tools.py:98-120). On a
    DirectProduct (the cylinder) the straight factors take interval
    spacings and the polar factor its (phi, r) spacings on its component
    slice (dedalus_tpu/extras/flow_tools.py:82-95).
    """
    from ..core.coords import (CartesianCoordinates, Coordinate,
                               CurvilinearCoordinateSystem, DirectProduct,
                               PolarCoordinates, S2Coordinates,
                               SphericalCoordinates)
    cs = u.tensorsig[0]
    dist = u.dist

    def polar_frequency(polar_cs, u_az, u_r):
        basis = u.domain.bases[dist.get_axis(polar_cs.coords[1])]
        if basis is None:
            return 0.0  # velocity constant over the polar factor
        # the azimuthal spacing r / mmax on the annulus, R / mmax on the
        # disk; the radial one the dealias-rescaled gradient of the grid
        # (dedalus_tpu/extras/flow_tools.py:53 polar_frequency)
        r = np.ravel(basis.global_grids(basis.dealias)[1])
        mmax = max(basis.shape[0] // 2 - 1, 0)
        if mmax == 0:
            az = np.array([np.inf])
        elif hasattr(basis, "radii"):
            az = r / mmax
        else:
            az = np.array([basis.radius / mmax])
        dr = basis.dealias[1] * (np.gradient(r) if r.size > 1
                                 else np.array([np.inf]))
        r_axis = basis.first_axis + 1
        return (u_az.abs() / _device_profile(az, r_axis, dist.dim, ug)
                + u_r.abs() / _device_profile(dr, r_axis, dist.dim, ug))

    def interval_frequency(coord, u_c):
        axis = dist.get_axis(coord)
        basis = u.domain.bases[axis]
        if basis is None:
            return 0.0
        dx = _device_profile(interval_cfl_spacing(basis), axis, dist.dim, ug)
        return u_c.abs() / dx

    if isinstance(cs, S2Coordinates):
        basis = u.domain.bases[dist.get_axis(cs.coords[0])]
        Lmax = basis.Lmax
        k = np.sqrt(Lmax * (Lmax + 1)) if Lmax > 0 else 0.0
        return torch.sqrt(ug[0] ** 2 + ug[1] ** 2) * (k / basis.radius)
    if isinstance(cs, SphericalCoordinates):
        basis = u.domain.bases[dist.get_axis(cs.coords[2])]
        r_axis = basis.first_axis + 2
        r = np.ravel(basis.global_grids(basis.dealias)[2])
        Lmax = basis.shape[1] - 1
        k = np.sqrt(Lmax * (Lmax + 1)) if Lmax > 0 else 0.0
        # the angular spacing r / k on the shell, R / k on the ball; the
        # radial one the dealias-rescaled gradient of the grid
        total = torch.sqrt(ug[0] ** 2 + ug[1] ** 2)
        if not k:
            total = total * 0.0
        elif hasattr(basis, "radii"):
            total = total * _device_profile(k / r, r_axis, dist.dim, ug)
        else:
            total = total * (k / basis.radius)
        dr = basis.dealias[2] * (np.gradient(r) if r.size > 1
                                 else np.array([np.inf]))
        return total + ug[2].abs() / _device_profile(dr, r_axis, dist.dim,
                                                     ug)
    total = 0.0
    if isinstance(cs, PolarCoordinates):
        total = polar_frequency(cs, ug[0], ug[1])
    elif isinstance(cs, DirectProduct):
        off = 0
        for sub in cs.coordsystems:
            if isinstance(sub, PolarCoordinates):
                total = total + polar_frequency(sub, ug[off], ug[off + 1])
            elif isinstance(sub, CurvilinearCoordinateSystem):
                # an S2 or spherical factor must not fall into the polar
                # formula (it would read the colatitude as a radius)
                raise NotImplementedError(
                    "CFL spacing for this DirectProduct factor.")
            else:
                for j, coord in enumerate(sub.coords):
                    total = total + interval_frequency(coord, ug[off + j])
            off += sub.dim
    elif isinstance(cs, (CartesianCoordinates, Coordinate)):
        for i, coord in enumerate(cs.coords):
            total = total + interval_frequency(coord, ug[i])
    else:
        raise NotImplementedError(
            f"CFL spacing for {type(cs).__name__}: dedalus_tpu_torch has "
            "the Cartesian, polar, direct-product, S2 and spherical "
            "spacings only")
    if np.isscalar(total):
        total = ug.new_zeros(ug.shape[1:])
    return total


class GlobalArrayReducer:
    """Global reductions over grid data (reference: extras/flow_tools.py:15).
    One process holds the whole array; reductions are direct."""

    def __init__(self, comm=None, dtype=np.float64):
        self.dtype = dtype

    def reduce_scalar(self, local_scalar, mpi_reduce_op=None):
        return local_scalar

    def global_min(self, data, empty=np.inf):
        return np.min(data) if data.size else empty

    def global_max(self, data, empty=-np.inf):
        return np.max(data) if data.size else empty

    def global_mean(self, data):
        return np.mean(data)


class GlobalFlowProperty:
    """Scheduled scalar diagnostics of flow expressions
    (reference: extras/flow_tools.py:64)."""

    def __init__(self, solver, cadence=1):
        self.solver = solver
        self.cadence = cadence
        self.reducer = GlobalArrayReducer()
        self.properties = solver.evaluator.add_dictionary_handler(iter=cadence)

    def add_property(self, property, name):
        self.properties.add_task(property, name=name)

    def min(self, name):
        return self.reducer.global_min(self.properties[name])

    def max(self, name):
        return self.reducer.global_max(self.properties[name])

    def grid_average(self, name):
        return self.reducer.global_mean(self.properties[name])

    def volume_integral(self, name):
        # tasks are integrals already when requested via integ(...)
        return np.sum(self.properties[name])


class CFL:
    """
    Adaptive timestep from advective CFL frequencies
    (reference: extras/flow_tools.py:139 CFL, core/operators.py:4306
    AdvectiveCFL). Frequencies |u_i| / dx_i are computed on the grid and
    reduced to a stable timestep with safety/threshold/bounds logic
    (reference: extras/flow_tools.py:191 compute_timestep). `history`
    keeps the last (iteration, dt, freq_max) records.
    """

    def __init__(self, solver, initial_dt, cadence=1, safety=1.0,
                 max_dt=np.inf, min_dt=0.0, max_change=np.inf, min_change=0.0,
                 threshold=0.0, history_size=256):
        self.solver = solver
        self.initial_dt = initial_dt
        self.cadence = cadence
        self.safety = safety
        self.max_dt = max_dt
        self.min_dt = min_dt
        self.max_change = max_change
        self.min_change = min_change
        self.threshold = threshold
        self.velocities = []
        self.frequencies = []
        self.current_dt = initial_dt
        self.history = deque(maxlen=max(int(history_size), 1))
        self._last_freq_max = None
        # the dt/frequency history is flight-recorder evidence
        # (tools/health.py dt_history)
        monitor = getattr(solver, "health", None)
        if monitor is not None and hasattr(monitor, "attach_dt_source"):
            monitor.attach_dt_source(self)

    def add_velocity(self, velocity):
        """Register a velocity vector field for CFL frequencies."""
        self.velocities.append(velocity)

    def add_frequency(self, freq):
        """Register an additional frequency expression."""
        self.frequencies.append(freq)

    def compute_max_frequency(self):
        freq_max = 0.0
        for u in self.velocities:
            u.change_scales(u.domain.dealias)
            total = advective_cfl_frequency(u, u.require_grid_space())
            if total.numel():
                freq_max = max(freq_max, float(total.max()))
        for fexpr in self.frequencies:
            data = fexpr.evaluate().require_grid_space()
            freq_max = max(freq_max, float(data.abs().max()))
        return freq_max

    def compute_timestep(self):
        iteration = self.solver.iteration
        if iteration % self.cadence == 0:
            freq_max = self.compute_max_frequency()
            self._last_freq_max = float(freq_max)
            if freq_max == 0.0:
                dt = self.max_dt
            else:
                dt = self.safety / freq_max
            dt = min(dt, self.max_dt)
            dt = max(dt, self.min_dt)
            # bounded relative change with threshold hysteresis
            if self.current_dt:
                change = dt / self.current_dt
                change = min(change, self.max_change)
                change = max(change, self.min_change)
                if abs(change - 1.0) > self.threshold:
                    self.current_dt = self.current_dt * change
            else:
                self.current_dt = dt
        self.history.append({"iteration": int(iteration),
                             "dt": float(self.current_dt),
                             "freq_max": self._last_freq_max})
        return self.current_dt
