"""
3-D Rayleigh-Benard convection in the port (dedalus_tpu_torch/extras/
bench_problems.py build_rb3d) held against the JAX package's
benchmarks/progression.py build_rb3d (BASELINE config 5; rb3d_128 at
128x128x64 on the card) on the CPU, at 8x8x16 and 16x16x16:

  * forced banded, the structure is the JAX package's (S, pins, kl, ku,
    q = 80, NB, the permutations), and the M/L band stores are bit-equal
    (np.array_equal); under 'auto' both take the dense path at these
    sizes, with bit-equal dense M/L;
  * 10 RK222 steps at dt = 1e-3: p, b and u agree to 1e-12 relative,
    banded and dense; the taus to 5e-12 of the state (their mean-mode
    round-off noise, as large within the JAX package).
"""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.extras.bench_problems import build_rb3d as torch_rb3d
from dedalus_tpu_torch.tools.carry import STRUCTURE_FIELDS

torch.set_num_threads(1)

RTOL = 1e-12
STEPS = 10


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def jax_rb3d(Nx, Ny, Nz, matsolver):
    """benchmarks/progression.py build_rb3d with the JAX package's
    MATRIX_SOLVER set to `matsolver` (None keeps 'auto')."""
    from benchmarks.progression import build_rb3d
    from dedalus_tpu.tools.config import config
    section = config["linear algebra"]
    old = section.get("MATRIX_SOLVER", "auto")
    if matsolver is not None:
        section["MATRIX_SOLVER"] = matsolver
    try:
        return build_rb3d(Nx, Ny, Nz, np.float64)
    finally:
        section["MATRIX_SOLVER"] = old


@pytest.fixture(scope="module",
                params=[((8, 8, 16), "banded"), ((8, 8, 16), None),
                        ((16, 16, 16), "banded"), ((16, 16, 16), None)],
                ids=["8x8x16-banded", "8x8x16-dense", "16x16x16-banded",
                     "16x16x16-dense"])
def built(request):
    sizes, matsolver = request.param
    js, jdt = jax_rb3d(*sizes, matsolver)
    ts, tdt = torch_rb3d(*sizes, np.float64, matsolver=matsolver,
                         device="cpu")
    assert jdt == tdt
    return js, ts, tdt, matsolver


def test_path_and_structure_are_the_jax_ones(built):
    """Forced banded: q = 80 and the JAX package's S, NB, pins, kl, ku
    and every structure field; under 'auto' both packages take the dense
    path at these sizes."""
    js, ts, _, matsolver = built
    assert ts.ops.kind == js.ops.kind == ("banded" if matsolver else "dense")
    assert ts.pencil_shape == tuple(js.pencil_shape)
    if matsolver:
        for k in ("S", "q", "NB", "t_pins", "kl", "ku"):
            assert getattr(ts.structure, k) == getattr(js.structure, k), k
        assert ts.structure.q == 80
        for field in STRUCTURE_FIELDS:
            assert np.array_equal(np.asarray(getattr(ts.structure, field)),
                                  np.asarray(getattr(js.structure, field)))


def test_matrices_bit_equal(built):
    """M and L, band stores (bands, Vt, dsel) or dense (G, S, S) arrays,
    np.array_equal; the valid-row mask."""
    js, ts, _, matsolver = built
    for name in ("M", "L"):
        if matsolver:
            for part in ("bands", "Vt", "dsel"):
                ref = np.asarray(js._matrices[name][part])
                out = np.asarray(ts._matrices[name][part])
                assert out.shape == ref.shape
                assert np.array_equal(out, ref)
        else:
            assert np.array_equal(np.asarray(ts._matrices[name]),
                                  np.asarray(js._matrices[name]))
    assert np.array_equal(ts.valid_row_mask, js.valid_row_mask)


def test_trajectory_matches_jax(built):
    """10 RK222 steps from the same seeded state (equal grid data; its
    coefficients within 1e-15, the transforms' round-off). The fields p,
    b and u agree to 1e-12 relative, each against its own largest
    coefficient. The tau variables agree to 5e-12 of the largest state
    entry: the taus of the mean (kx, ky) = (0, 0) pencil carry round-off
    noise of a few 1e-12, as large between the JAX package's own dense
    and banded solves of this problem (up to 2.4e-12 at 8x8x16) as
    between the two packages."""
    js, ts, dt, _ = built
    assert rel_err(ts.gather_fields().numpy(),
                   np.asarray(js.gather_fields())) <= 1e-15
    for _ in range(STEPS):
        js.step(dt)
        ts.step(dt)
    x = ts.X.numpy()
    assert np.isfinite(x).all()
    assert ts.iteration == js.iteration == STEPS
    scale = np.max(np.abs(np.asarray(js.X)))
    jvars = {v.name: v for v in js.problem.variables}
    for var in ts.problem.variables:
        out = np.asarray(var["c"])
        ref = np.asarray(jvars[var.name]["c"])
        if var.name.startswith("tau"):
            assert np.max(np.abs(out - ref)) <= 5e-12 * scale, var.name
        else:
            assert rel_err(out, ref) <= RTOL, var.name
