"""
The port's spectral transforms (dedalus_tpu_torch/core/transforms.py:
RealFourierFFT on torch.fft, FastChebyshevTransform with its DCT and
parity-strided cumsum, the JacobiMMT fallback) held against the JAX
package's, grid <-> coeff on a RealFourier x ChebyshevT domain at scales
1 and 3/2, including the Chebyshev derivative bases the RHS evaluates in.
Tolerance: 1e-13 relative to the largest output entry.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.core.field import (transform_to_coeff as j_to_coeff,
                                    transform_to_grid as j_to_grid)
from dedalus_tpu_torch.core.field import (transform_to_coeff as t_to_coeff,
                                          transform_to_grid as t_to_grid)

torch.set_num_threads(1)

RTOL = 1e-13
NX, NZ = 16, 12


def domains(k, dtype=np.float64):
    """The same RealFourier x ChebyshevT (derivative level k) domain in
    both packages."""
    out = []
    for d3, kw in ((jd3, {}), (td3, {"device": "cpu"})):
        coords = d3.CartesianCoordinates("x", "z")
        dist = d3.Distributor(coords, dtype=dtype, **kw)
        xb = d3.RealFourier(coords["x"], size=NX, bounds=(0, 4.0))
        zb = d3.ChebyshevT(coords["z"], size=NZ, bounds=(0, 1.0))
        if k:
            zb = zb.derivative_basis(k)
        out.append(dist.Field(bases=(xb, zb)).domain)
    return out


def rel_err(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("scale", [1.0, 1.5])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_backward_matches_jax(scale, k):
    jdom, tdom = domains(k)
    rng = np.random.default_rng(10 * k + int(2 * scale))
    c = rng.standard_normal((NX, NZ))
    c[1, :] = 0.0   # the invalid k=0 minus-sin slot
    ref = np.asarray(j_to_grid(c, jdom, (scale, scale), 0))
    out = t_to_grid(torch.as_tensor(c), tdom, (scale, scale), 0).numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) <= RTOL


@pytest.mark.parametrize("scale", [1.0, 1.5])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_forward_matches_jax(scale, k):
    jdom, tdom = domains(k)
    rng = np.random.default_rng(100 + 10 * k + int(2 * scale))
    shape = (int(np.ceil(scale * NX)), int(np.ceil(scale * NZ)))
    g = rng.standard_normal(shape)
    ref = np.asarray(j_to_coeff(g, jdom, (scale, scale), 0))
    out = t_to_coeff(torch.as_tensor(g), tdom, (scale, scale), 0).numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) <= RTOL


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_vector_roundtrip_matches_jax(scale):
    """A tensor field (leading component axis) round trip coeff -> grid ->
    coeff through both packages."""
    jdom, tdom = domains(0)
    rng = np.random.default_rng(7)
    c = rng.standard_normal((2, NX, NZ))
    c[:, 1, :] = 0.0
    jg = j_to_grid(c, jdom, (scale, scale), 1)
    tg = t_to_grid(torch.as_tensor(c), tdom, (scale, scale), 1)
    assert rel_err(tg.numpy(), np.asarray(jg)) <= RTOL
    jc = np.asarray(j_to_coeff(jg, jdom, (scale, scale), 1))
    tc = t_to_coeff(tg, tdom, (scale, scale), 1).numpy()
    assert rel_err(tc, jc) <= RTOL
    assert rel_err(tc, c) <= 1e-12


def test_float32_stays_float32():
    """f32 data is transformed in f32 end to end (as the JAX package keeps
    f32 data f32), and agrees with the f64 transform to f32 precision."""
    _, tdom = domains(1, dtype=np.float32)
    rng = np.random.default_rng(3)
    c = rng.standard_normal((NX, NZ))
    c[1, :] = 0.0
    g32 = t_to_grid(torch.as_tensor(c, dtype=torch.float32), tdom,
                    (1.5, 1.5), 0)
    assert g32.dtype == torch.float32
    g64 = t_to_grid(torch.as_tensor(c), tdom, (1.5, 1.5), 0)
    assert rel_err(g32.double().numpy(), g64.numpy()) <= 1e-5
    c32 = t_to_coeff(g32, tdom, (1.5, 1.5), 0)
    assert c32.dtype == torch.float32
