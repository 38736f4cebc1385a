"""
Azimuthally varying polar NCCs in the port (m-coupled disk and annulus
pencils: subsystems' couples_azimuth_polar, the coupled-azimuth validity
masks of core/polar.py, arithmetic's _polar_coupled_azimuth_terms and
_disk_coupled_ncc_matrix), held against the JAX package on the CPU: the
nine cases of tests/test_polar_azimuthal_ncc.py at the same sizes (12x8,
16x10, dealias 2), inputs from the same grid data in both packages:

  * the port's assembled pencil matrix acts on coefficients as the
    port's grid product does, to 2e-10 (the reference's bound);
  * it equals the JAX package's matrix for the same group to 1e-12 of
    max |matrix| (measured <= 3.0e-16 on the annulus, 4.5e-16 on the
    disk);
  * the annulus LBVP reaches 1e-10 of its manufactured solution and the
    JAX package's solution to 1e-12, dense and forced banded (the
    m-coupled banded structure aligns each m block on its lifted taus:
    MatrixStructure.finalize; measured 1.2e-15 / 1.8e-15 and 2.3e-15 /
    1.3e-15);
  * matrix_coupling=[True, True] makes the disk Poisson one flattened
    pencil within 1e-11 of the separable solve
    (tests/test_two_coupled.py:207 test_matrix_coupling_forced_disk;
    measured 4.4e-15), and 1e-12 of the JAX package's coupled solve
    (4.2e-16);
  * the coupled-pencil builders of extras/bench_problems.py build these
    problems, and the m-coupled annulus IVP forced banded follows its
    dense run to 1e-12 after 10 RK222 steps.
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

ORACLE_TOL = 2e-10     # tests/test_polar_azimuthal_ncc.py's bound
MATRIX_RTOL = 1e-12
SOLUTION_TOL = 1e-10
PARITY_RTOL = 1e-12


def dist_kw(d3):
    return {"device": "cpu"} if d3 is td3 else {}


def to_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pencil_matrices(d3, dist, expr, operand):
    """[(group, matrix)] of `expr` on its own layout, after checking it
    against the grid product (the reference's oracle, _check_expr)."""
    sub = tsub if d3 is td3 else jsub
    eq = {"domain": expr.domain, "tensorsig": tuple(expr.tensorsig),
          "L": expr}
    layout = sub.PencilLayout(dist, [operand], [eq])
    az = expr.domain.bases[-1].first_axis
    assert az not in layout.sep_widths, "NCC should have coupled azimuth"
    sps = sub.build_subproblems(layout)
    Xin = to_numpy(layout.gather(operand.coeff_data(), operand.domain,
                                 operand.tensorsig))
    out = expr.evaluate()
    Xout = to_numpy(layout.gather(out.coeff_data(), out.domain,
                                  out.tensorsig))
    scale = max(np.abs(Xout).max(), 1e-12)
    mats = []
    for sp in sps:
        M = expr.expression_matrices(sp, [operand])[operand]
        y = M @ Xin[sp.index]
        valid = np.asarray(layout.valid_mask(
            expr.domain, tuple(expr.tensorsig), sp.group)).ravel()
        err = np.abs(y - Xout[sp.index])[valid].max(initial=0.0) / scale
        assert err < ORACLE_TOL, (d3.__name__, sp.group, err)
        mats.append((sp.group, M.toarray()))
    return mats


def polar_basis(d3, kind, dtype, Nphi=12, Nr=8):
    coords = d3.PolarCoordinates("phi", "r")
    dist = d3.Distributor(coords, dtype=dtype, **dist_kw(d3))
    if kind == "annulus":
        basis = d3.AnnulusBasis(coords, shape=(Nphi, Nr), dtype=dtype,
                                radii=(0.7, 1.8), dealias=2)
    else:
        basis = d3.DiskBasis(coords, shape=(Nphi, Nr), dtype=dtype,
                             radius=1.0, dealias=2)
    return coords, dist, basis


def vector_field(d3, dist, coords, basis):
    phi, r = dist.local_grids(basis)
    x, y = r * np.cos(phi), r * np.sin(phi)
    u = dist.VectorField(coords, name="u", bases=basis)
    ux, uy = x * y, x ** 2 - y ** 2 + 0.5
    u["g"] = np.array([-np.sin(phi) * ux + np.cos(phi) * uy,
                       np.cos(phi) * ux + np.sin(phi) * uy])
    return u


def annulus_scalar(d3, dtype):
    coords, dist, ann = polar_basis(d3, "annulus", dtype)
    phi, r = dist.local_grids(ann)
    f = dist.Field(name="f", bases=ann)
    f["g"] = 2.0 + np.cos(2 * phi) * (1 + 0.3 * r) + 0.4 * np.sin(phi) * r ** 2
    u = dist.Field(name="u", bases=ann)
    u["g"] = np.cos(phi) * r ** 2 + np.sin(3 * phi) + 0.7
    return dist, [(f * u, u)]


def annulus_vector(d3, dtype, both_sides=False):
    coords, dist, ann = polar_basis(d3, "annulus", dtype)
    phi, r = dist.local_grids(ann)
    f = dist.Field(name="f", bases=ann)
    f["g"] = 1.5 + 0.5 * np.cos(phi) * r
    u = vector_field(d3, dist, coords, ann)
    exprs = [(f * u, u)]
    if both_sides:
        # the NCC on the right: the mixers' other component placement
        exprs.append((u * f, u))
    return dist, exprs


def disk_scalar(d3, dtype):
    coords, dist, disk = polar_basis(d3, "disk", dtype)
    phi, r = dist.local_grids(disk)
    x, y = r * np.cos(phi), r * np.sin(phi)
    f = dist.Field(name="f", bases=disk)
    f["g"] = 1.0 + 0.5 * x + 0.3 * (x * y - y)
    u = dist.Field(name="u", bases=disk)
    u["g"] = x ** 2 - y ** 2 + y + 0.5
    return dist, [(f * u, u)]


def disk_vector(d3, dtype, ncc):
    coords, dist, disk = polar_basis(d3, "disk", dtype)
    phi, r = dist.local_grids(disk)
    f = dist.Field(name="f", bases=disk)
    f["g"] = ncc(phi, r)
    u = vector_field(d3, dist, coords, disk)
    return dist, [(f * u, u)]


CASES = {
    "annulus_scalar_f64": lambda d3: annulus_scalar(d3, np.float64),
    "annulus_scalar_c128": lambda d3: annulus_scalar(d3, np.complex128),
    "annulus_vector_c128": lambda d3: annulus_vector(d3, np.complex128),
    "annulus_vector_f64": lambda d3: annulus_vector(d3, np.float64, True),
    "disk_scalar_f64": lambda d3: disk_scalar(d3, np.float64),
    "disk_scalar_c128": lambda d3: disk_scalar(d3, np.complex128),
    "disk_vector_c128": lambda d3: disk_vector(
        d3, np.complex128, lambda phi, r: 1.0 + 0.4 * r * np.sin(phi)),
    "disk_vector_f64": lambda d3: disk_vector(
        d3, np.float64, lambda phi, r: 1.0 + 0.5 * r * np.cos(phi)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_coupled_ncc_matrix_matches_grid_and_jax(case):
    """The m-coupled pencil matrix against the port's grid product
    (2e-10) and the JAX package's matrix (1e-12 of max |matrix|)."""
    jdist, jexprs = CASES[case](jd3)
    tdist, texprs = CASES[case](td3)
    for (jexpr, ju), (texpr, tu) in zip(jexprs, texprs):
        jm = pencil_matrices(jd3, jdist, jexpr, ju)
        tm = pencil_matrices(td3, tdist, texpr, tu)
        assert [g for g, _ in tm] == [g for g, _ in jm]
        for (_, T), (_, J) in zip(tm, jm):
            assert T.shape == J.shape
            scale = np.abs(J).max()
            assert np.abs(T - J).max() <= MATRIX_RTOL * scale


def annulus_lbvp(d3, matsolver=None, Nphi=16, Nr=10):
    """tests/test_polar_azimuthal_ncc.py:104: (1 + 0.3 r cos(phi)) u -
    lap(u) = g on the annulus with u = 0 on both walls, against the
    manufactured u = (r - 0.7)(1.8 - r)(1 + 0.5 cos(phi))."""
    coords, dist, ann = polar_basis(d3, "annulus", np.float64, Nphi, Nr)
    phi, r = dist.local_grids(ann)
    u_true = (r - 0.7) * (1.8 - r) * (1 + 0.5 * np.cos(phi))
    w = dist.Field(name="w", bases=ann)
    w["g"] = 1.0 + 0.3 * np.cos(phi) * r
    u = dist.Field(name="u", bases=ann)
    tau1 = dist.Field(name="tau1", bases=ann.edge)
    tau2 = dist.Field(name="tau2", bases=ann.edge)
    lift_basis = ann.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)
    ut = dist.Field(name="ut", bases=ann)
    ut["g"] = u_true
    g = (w * ut - d3.lap(ut)).evaluate()
    problem = d3.LBVP([u, tau1, tau2], namespace=locals())
    problem.add_equation("w*u - lap(u) + lift(tau1,-1) + lift(tau2,-2) = g")
    problem.add_equation("u(r=0.7) = 0")
    problem.add_equation("u(r=1.8) = 0")
    solver = problem.build_solver(matsolver=matsolver)
    solver.solve()
    return solver, np.array(u["g"]), u_true


@pytest.mark.parametrize("matsolver", [None, "banded"])
def test_annulus_azimuthal_ncc_lbvp(matsolver):
    """The annulus LBVP on one m-coupled pencil: 1e-10 of the
    manufactured solution and 1e-12 of the JAX package's ('auto', which
    is dense at this size, in the JAX package; the port also forced
    banded, which the JAX package's structure solves to only 2.2e-12 at
    32x32 and 1.3e14 at 256x64 — see MatrixStructure.finalize)."""
    ts, tu, u_true = annulus_lbvp(td3, matsolver)
    assert ts.pencil_shape[0] == 1
    assert (ts.structure is not None) == (matsolver == "banded")
    assert np.abs(tu - u_true).max() < SOLUTION_TOL
    js, ju, _ = annulus_lbvp(jd3)
    assert np.abs(tu - ju).max() <= PARITY_RTOL * np.abs(ju).max()


def forced_disk_poisson(d3, **kw):
    """tests/test_two_coupled.py:207: the disk Poisson with u = 0 on the
    edge, separable or with matrix_coupling forcing one (m x r) pencil."""
    coords, dist, disk = polar_basis(d3, "disk", np.float64, 8, 16)
    phi, r = dist.local_grids(disk)
    u = dist.Field(name="u", bases=disk)
    tau = dist.Field(name="tau", bases=disk.edge)
    rhs = dist.Field(name="rhs", bases=disk)
    x = r * np.cos(phi)
    y = r * np.sin(phi)
    u_ex = (1 - r ** 2) * (1 + 0.5 * x + 0.3 * y)
    rhs["g"] = -4.0 - 4.0 * x - 2.4 * y
    lift = lambda A: d3.Lift(A, disk, -1)
    problem = d3.LBVP([u, tau], namespace=locals())
    problem.add_equation("lap(u) + lift(tau) = rhs")
    problem.add_equation("u(r=1) = 0")
    solver = problem.build_solver(**kw)
    solver.solve()
    return solver, np.array(u["g"]), u_ex


def test_matrix_coupling_forced_disk():
    """matrix_coupling=[True, True]: one flattened pencil, within 1e-11
    of the separable solve (the reference's bound) and 1e-12 of the JAX
    package's coupled solve."""
    s_sep, u_sep, u_ex = forced_disk_poisson(td3)
    assert np.abs(u_sep - u_ex).max() < 1e-10
    s_cpl, u_cpl, _ = forced_disk_poisson(td3, matrix_coupling=[True, True])
    assert s_cpl.pencil_shape[0] == 1
    assert np.abs(u_cpl - u_sep).max() < 1e-11
    _, ju, _ = forced_disk_poisson(jd3, matrix_coupling=[True, True])
    assert np.abs(u_cpl - ju).max() <= PARITY_RTOL * np.abs(ju).max()


def test_bench_builders_match_the_tests():
    """extras/bench_problems.py's coupled-pencil builders (the card's
    phase 24) build the problems these tests hold against the JAX
    package: the annulus LBVP bit for bit, the disk's NCC LBVP and its
    matrix_coupling Poisson within 1e-10 of their manufactured
    solutions, each one pencil."""
    _, ref, _ = annulus_lbvp(td3)
    solver, u, exact = tbench.build_annulus_azncc(16, 10, device="cpu")
    solver.solve()
    assert np.array_equal(np.array(u["g"]), ref)
    for kind in ("ncc", "coupled_poisson"):
        solver, u, exact = tbench.build_disk_azncc(16, 12, kind,
                                                   device="cpu")
        assert solver.pencil_shape[0] == 1
        solver.solve()
        assert np.abs(np.array(u["g"]) - exact).max() < SOLUTION_TOL


def test_annulus_azncc_ivp_banded_matches_dense():
    """The m-coupled annulus IVP (the card's phase 24 at 64x32): forced
    banded (q = 80, one pencil group, the structure aligned on the
    lifted taus) against the dense path after 10 RK222 steps, to 1e-12
    of the state (measured 1.3e-15)."""
    runs = {}
    for matsolver in ("banded", "dense"):
        solver, u, _ = tbench.build_annulus_azncc(64, 32, "ivp",
                                                  matsolver=matsolver,
                                                  device="cpu")
        for _ in range(10):
            solver.step(tbench.AZNCC_DT)
        runs[matsolver] = (solver, np.array(u["g"]))
    banded, dense = runs["banded"][1], runs["dense"][1]
    st = runs["banded"][0].structure
    assert (st.q, st.t_pins) == (80, 160)
    assert np.abs(banded - dense).max() <= 1e-12 * np.abs(dense).max()
