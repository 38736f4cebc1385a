"""
Jointly varying (multi-axis) Cartesian NCCs in the port
(arithmetic.ProductBase._ncc_axis_terms_from: the modal expansion along
the NCC's first varying axis, one kron term per mode), held against the
JAX package on the CPU: the four cases of tests/test_joint_ncc.py at the
same sizes (12 x 10, dealias 2), inputs from the same grid data:

  * the port's pencil matrices act on coefficients as the port's grid
    product does, to 2e-10 (the reference's bound), and equal the JAX
    package's, group by group, to 1e-12 of max |matrix| (measured
    <= 3.8e-16);
  * Fourier x Chebyshev forces the Fourier axis coupled (one pencil);
  * the LBVP (2 + 0.5 sin(x) z) u = F returns its target to 1e-10 and
    the JAX package's solution to 1e-12 (measured 7.8e-16).
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.core import subsystems as jsub
from dedalus_tpu_torch.core import subsystems as tsub
from dedalus_tpu_torch.extras import bench_problems as tbench

torch.set_num_threads(1)

ORACLE_TOL = 2e-10     # tests/test_joint_ncc.py's bound
MATRIX_RTOL = 1e-12
PARITY_RTOL = 1e-12


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def to_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pencil_matrices(d3, dist, expr, operand):
    """(layout, [(group, matrix)]) of `expr`, each matrix checked against
    the grid product (tests/test_joint_ncc.py's _check)."""
    sub = tsub if d3 is td3 else jsub
    eq = {"domain": expr.domain, "tensorsig": tuple(expr.tensorsig),
          "L": expr}
    layout = sub.PencilLayout(dist, [operand], [eq])
    Xin = to_numpy(layout.gather(operand.coeff_data(), operand.domain,
                                 operand.tensorsig))
    out = expr.evaluate()
    Xout = to_numpy(layout.gather(out.coeff_data(), out.domain,
                                  out.tensorsig))
    scale = max(np.abs(Xout).max(), 1e-12)
    mats = []
    for sp in sub.build_subproblems(layout):
        M = expr.expression_matrices(sp, [operand])[operand]
        y = M @ Xin[sp.index]
        valid = np.asarray(layout.valid_mask(
            expr.domain, tuple(expr.tensorsig), sp.group)).ravel()
        err = np.abs(y - Xout[sp.index])[valid].max(initial=0.0) / scale
        assert err < ORACLE_TOL, (d3.__name__, sp.group, err)
        mats.append((sp.group, M.toarray()))
    return layout, mats


def rectangle(d3, dtype, x_kind):
    coords = d3.CartesianCoordinates("x", "z")
    dist = d3.Distributor(coords, dtype=dtype, **dist_kw(d3))
    if x_kind == "fourier":
        Fourier = d3.RealFourier if dtype == np.float64 else d3.ComplexFourier
        xb = Fourier(coords["x"], size=12, bounds=(0, 2 * np.pi), dealias=2)
    else:
        xb = d3.ChebyshevT(coords["x"], size=12, bounds=(0, 1), dealias=2)
    zb = d3.ChebyshevT(coords["z"], size=10, bounds=(0, 1), dealias=2)
    return dist, xb, zb


def fourier_jacobi(d3, dtype):
    dist, xb, zb = rectangle(d3, dtype, "fourier")
    x, z = dist.local_grids(xb, zb)
    f = dist.Field(name="f", bases=(xb, zb))
    f["g"] = 2.0 + np.sin(x) * z ** 2 + 0.3 * np.cos(2 * x) * z
    u = dist.Field(name="u", bases=(xb, zb))
    u["g"] = np.cos(x) * (1 - z) + 0.5 * np.sin(2 * x) * z ** 2
    return dist, f * u, u


def jacobi_jacobi(d3):
    dist, xb, zb = rectangle(d3, np.float64, "chebyshev")
    x, z = dist.local_grids(xb, zb)
    f = dist.Field(name="f", bases=(xb, zb))
    f["g"] = 1.0 + 0.5 * x * z + 0.2 * x ** 2 * z ** 2
    u = dist.Field(name="u", bases=(xb, zb))
    u["g"] = np.sin(2 * x) * (1 - z ** 2)
    return dist, f * u, u


CASES = {
    "fourier_jacobi_f64": lambda d3: fourier_jacobi(d3, np.float64),
    "fourier_jacobi_c128": lambda d3: fourier_jacobi(d3, np.complex128),
    "jacobi_jacobi": jacobi_jacobi,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_joint_ncc_matrix_matches_grid_and_jax(case):
    """f(x, z) * u: the pencil matrices against the grid product and the
    JAX package's; a Fourier x axis is forced coupled."""
    jdist, jexpr, ju = CASES[case](jd3)
    tdist, texpr, tu = CASES[case](td3)
    jlayout, jm = pencil_matrices(jd3, jdist, jexpr, ju)
    tlayout, tm = pencil_matrices(td3, tdist, texpr, tu)
    assert tlayout.sep_widths == jlayout.sep_widths
    if case.startswith("fourier"):
        assert 0 not in tlayout.sep_widths     # the x axis forced coupled
    assert [g for g, _ in tm] == [g for g, _ in jm]
    for (_, T), (_, J) in zip(tm, jm):
        assert np.abs(T - J).max() <= MATRIX_RTOL * np.abs(J).max()


def joint_lbvp(d3, matsolver=None):
    """tests/test_joint_ncc.py:70: (2 + 0.5 sin(x) z) u = F for a known
    u (a 2-D variable coefficient on the LHS)."""
    dist, xb, zb = rectangle(d3, np.float64, "fourier")
    x, z = dist.local_grids(xb, zb)
    f = dist.Field(name="f", bases=(xb, zb))
    f["g"] = 2.0 + 0.5 * np.sin(x) * z
    u = dist.Field(name="u", bases=(xb, zb))
    u_target = dist.Field(name="u_target", bases=(xb, zb))
    u_target["g"] = np.cos(x) * z + 0.3 * np.sin(2 * x) * (1 - z)
    F = (f * u_target).evaluate()
    problem = d3.LBVP([u], namespace=locals())
    problem.add_equation("f*u = F")
    solver = problem.build_solver(matsolver=matsolver)
    solver.solve()
    return solver, np.array(u["g"]), np.array(u_target["g"])


def test_joint_ncc_lbvp_roundtrip():
    """The LBVP (one dense pencil: its band is too wide at this size)
    returns its target to 1e-10 (the reference's bound) and the JAX
    package's solution to 1e-12."""
    ts, tu, target = joint_lbvp(td3)
    assert ts.pencil_shape[0] == 1
    assert np.abs(tu - target).max() < 1e-10
    _, ju, _ = joint_lbvp(jd3)
    assert np.abs(tu - ju).max() <= PARITY_RTOL * np.abs(ju).max()


def test_bench_builder_matches_the_test():
    """extras/bench_problems.build_joint_ncc (the card's phase 24) is
    this LBVP: the same solution bit for bit."""
    _, ref, _ = joint_lbvp(td3)
    solver, u, target = tbench.build_joint_ncc(12, 10, device="cpu")
    solver.solve()
    assert np.array_equal(np.array(u["g"]), ref)
