"""
Pencil assembly of the port (dedalus_tpu_torch/core/subsystems.py,
batched_assembly.py — host code carried over from the JAX package) held
against the JAX package on RB 8x32 and 16x16: the banded M/L stores and
the MatrixStructure fields are equal element for element.
"""

import numpy as np
import pytest
import torch

from dedalus_tpu.extras.bench_problems import build_rb_solver as jax_rb
from dedalus_tpu_torch.extras.bench_problems import build_rb_solver as torch_rb
from dedalus_tpu_torch.tools.carry import STRUCTURE_FIELDS

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(8, 32), (16, 16)],
                ids=["rb8x32", "rb16x16"])
def built(request):
    Nx, Nz = request.param
    js, _ = jax_rb(Nx, Nz, np.float64, matsolver="banded")
    ts, _ = torch_rb(Nx, Nz, np.float64, matsolver="banded", device="cpu")
    return js, ts


@pytest.mark.parametrize("name", ["M", "L"])
@pytest.mark.parametrize("part", ["bands", "Vt", "dsel"])
def test_band_stores_equal(built, name, part):
    js, ts = built
    ref = np.asarray(js._matrices[name][part])
    out = np.asarray(ts._matrices[name][part])
    assert out.shape == ref.shape
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("field", STRUCTURE_FIELDS)
def test_structure_fields_equal(built, field):
    js, ts = built
    assert np.array_equal(np.asarray(getattr(ts.structure, field)),
                          np.asarray(getattr(js.structure, field)))


def test_device_matrices_and_state_equal(built):
    """The device copies of M/L and the gathered initial state."""
    js, ts = built
    for name, ref in (("M", js.M_mat), ("L", js.L_mat)):
        out = getattr(ts, name + "_mat")
        assert out.dsel == ref.dsel
        assert np.array_equal(out.bands.numpy(), np.asarray(ref.bands))
    assert np.array_equal(ts.valid_row_mask, js.valid_row_mask)
    x0 = ts.gather_fields().numpy()
    assert np.max(np.abs(x0 - np.asarray(js.gather_fields()))) \
        <= 1e-13 * np.max(np.abs(x0))
