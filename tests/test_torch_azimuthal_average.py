"""
AzimuthalAverage on the sphere, the shell and the ball in the port (the
m = 0 blocks of each basis's group_m(), core/operators.py), and the
Mathieu EVP's Fourier-varying LHS NCC, held against the JAX package on
the CPU, inputs from the same grid data:

  * tests/test_azimuthal_ops.py:196 extended to the shell and the ball:
    the average of scalar and vector fields (f64 and complex128) equals
    the phi-mean of the grid data to 1e-12 and the JAX package's average
    to 1e-12 of max |data| (measured <= 1.1e-14 and 2.2e-16);
  * azavg on an equation's LHS: the shell and ball pencil matrices of
    u - azavg(u) equal the JAX package's, group by group
    (np.array_equal);
  * tests/test_evp.py:105 test_mathieu_fourier_ncc: the cos(2x) NCC
    couples the Fourier modes into one pencil; the characteristic values
    at q = 0 and 5 equal the JAX package's to 1e-10 (measured 0 and
    5.3e-15) and Abramowitz & Stegun's to 1e-6 (the reference's bound;
    measured 4.5e-9).
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.core import subsystems as jsub
from dedalus_tpu_torch.core import subsystems as tsub

torch.set_num_threads(1)

RTOL = 1e-12


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def to_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def curvilinear(d3, kind, dtype):
    """(coords, dist, basis) of a sphere 16x8, a shell or ball 16x8x8."""
    if kind == "sphere":
        cs = d3.S2Coordinates("phi", "theta")
        dist = d3.Distributor(cs, dtype=dtype, **dist_kw(d3))
        return cs, dist, d3.SphereBasis(cs, shape=(16, 8), dtype=dtype,
                                        radius=1.0)
    cs = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(cs, dtype=dtype, **dist_kw(d3))
    if kind == "shell":
        return cs, dist, d3.ShellBasis(cs, shape=(16, 8, 8),
                                       radii=(0.5, 1.5), dtype=dtype)
    return cs, dist, d3.BallBasis(cs, shape=(16, 8, 8), radius=1.0,
                                  dtype=dtype)


def averaged(d3, kind, dtype, vector):
    """(grid data, azavg grid data) of a field of one wavenumber mix."""
    cs, dist, basis = curvilinear(d3, kind, dtype)
    grids = dist.local_grids(basis)
    phi, theta = grids[0], grids[1]
    r = grids[2] if kind != "sphere" else 1.0
    profile = (np.cos(theta) ** 2 * (1 + 0.4 * np.cos(3 * phi)) * r ** 2
               + np.sin(phi) * r * np.sin(theta))
    if vector:
        f = dist.VectorField(cs, name="f", bases=basis)
        x = r * np.sin(theta) * np.cos(phi)
        y = r * np.sin(theta) * np.sin(phi)
        # a smooth Cartesian field x ez - y ex + r^2 ey in spherical
        # components
        ex = (-np.sin(phi), np.cos(theta) * np.cos(phi),
              np.sin(theta) * np.cos(phi))
        ey = (np.cos(phi), np.cos(theta) * np.sin(phi),
              np.sin(theta) * np.sin(phi))
        ez = (0 * phi, -np.sin(theta), np.cos(theta))
        f["g"] = np.array([x * ez[i] - y * ex[i] + r ** 2 * ey[i]
                           for i in range(len(f["g"]))])
    else:
        f = dist.Field(name="f", bases=basis)
        f["g"] = profile
    data = np.array(f["g"])
    out = d3.AzimuthalAverage(f).evaluate()
    out.change_scales(1)
    return data, np.array(out["g"])


AVERAGE_CASES = [("sphere", np.float64, False)] + [
    (kind, dtype, vector) for kind in ("shell", "ball")
    for dtype in (np.float64, np.complex128) for vector in (False, True)]


@pytest.mark.parametrize("kind,dtype,vector", AVERAGE_CASES)
def test_azimuthal_average_matches_mean_and_jax(kind, dtype, vector):
    data, tout = averaged(td3, kind, dtype, vector)
    _, jout = averaged(jd3, kind, dtype, vector)
    phi_axis = 1 if vector else 0
    mean = data.mean(axis=phi_axis, keepdims=True)
    assert np.abs(tout - mean).max() < RTOL
    assert np.abs(tout - jout).max() <= RTOL * np.abs(data).max()


def lhs_matrices(d3, kind):
    """The pencil matrices of u - azavg(u) on its own layout."""
    sub = tsub if d3 is td3 else jsub
    cs, dist, basis = curvilinear(d3, kind, np.float64)
    u = dist.Field(name="u", bases=basis)
    expr = u - d3.AzimuthalAverage(u)
    eq = {"domain": expr.domain, "tensorsig": (), "L": expr}
    layout = sub.PencilLayout(dist, [u], [eq])
    return [expr.expression_matrices(sp, [u])[u].toarray()
            for sp in sub.build_subproblems(layout)]


@pytest.mark.parametrize("kind", ["shell", "ball"])
def test_azimuthal_average_lhs_matrices_match_jax(kind):
    tm, jm = lhs_matrices(td3, kind), lhs_matrices(jd3, kind)
    assert len(tm) == len(jm)
    for T, J in zip(tm, jm):
        assert np.array_equal(T, J)


def mathieu(d3):
    """tests/test_evp.py:105: dx(dx(y)) + (a - 2 q cos(2x)) y = 0 on
    ComplexFourier(32); the sorted characteristic values at q = 0 (the
    lowest 5) and q = 5 (the lowest 4)."""
    xcoord = d3.Coordinate("x")
    dist = d3.Distributor(xcoord, dtype=np.complex128, **dist_kw(d3))
    xbasis = d3.ComplexFourier(xcoord, size=32, bounds=(0, 2 * np.pi))
    x = dist.local_grids(xbasis)[0]
    y = dist.Field(name="y", bases=xbasis)
    a = dist.Field(name="a")
    q = dist.Field(name="q")
    cos_2x = dist.Field(name="cos_2x", bases=xbasis)
    cos_2x["g"] = np.cos(2 * x)
    dx = lambda A: d3.Differentiate(A, xcoord)
    problem = d3.EVP([y], eigenvalue=a, namespace=locals())
    problem.add_equation("dx(dx(y)) + (a - 2*q*cos_2x)*y = 0")
    solver = problem.build_solver()
    assert solver.pencil_shape[0] == 1  # NCC coupling -> single pencil
    solver.solve_dense(solver.subproblems[0])
    got0 = np.sort(to_numpy(solver.eigenvalues).real)[:5]
    q["g"] = 5.0
    solver.solve_dense(solver.subproblems[0], rebuild_matrices=True)
    got5 = np.sort(to_numpy(solver.eigenvalues).real)[:4]
    return got0, got5


def test_mathieu_fourier_ncc_matches_jax():
    t0, t5 = mathieu(td3)
    j0, j5 = mathieu(jd3)
    assert np.allclose(t0, [0, 1, 1, 4, 4], atol=1e-10)
    expect5 = [-5.80004602, -5.79008060, 1.85818754, 2.09946045]
    assert np.allclose(t5, expect5, atol=1e-6), t5
    assert np.abs(t0 - j0).max() < 1e-10
    assert np.abs(t5 - j5).max() < 1e-10 * np.abs(j5).max()
