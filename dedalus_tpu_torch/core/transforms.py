"""
Spectral transform plans (counterpart of dedalus_tpu/core/transforms.py:
RealFourierFFT, FastChebyshevTransform and the JacobiMMT fallback).

Each plan converts one axis of an N-d tensor between coefficient and grid
representations. Plans are registered per (basis class, library name) like
the reference's `@register_transform` registry (core/transforms.py:27-32).
All plan methods are plain torch functions of their tensor argument; the
transform matrices are host-built numpy constants uploaded once per device
(tools/array.device_constant). float32 data stays float32 end to end.
"""

import functools

import numpy as np
import torch

from ..tools.array import zeropad, apply_matrix_torch, device_constant

# Registry: {(basis_class_name, library): plan_class}
transform_registry = {}


def register_transform(basis_cls_name, name):
    def wrapper(cls):
        transform_registry[(basis_cls_name, name)] = cls
        cls.library = name
        return cls
    return wrapper


def get_plan(basis, scale, library=None):
    """Build a transform plan. Callers go through Basis.transform_plan
    (@CachedMethod), so plans — and the host matrices they own — are built
    once per (basis, scale, library)."""
    lib = library or basis.library
    key = (type(basis).__name__, lib)
    # Fall back through base classes (e.g. ChebyshevT -> Jacobi)
    for klass in type(basis).__mro__:
        cls = transform_registry.get((klass.__name__, lib))
        if cls is not None:
            return cls(basis, scale)
    raise KeyError(f"No transform plan registered for {key}")


def _complex_dtype(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


@functools.lru_cache(maxsize=None)
def _dct_phase(N, sign, cdt, device):
    """exp(sign * i pi n / (2N)) for n < N, on `device` (cached: the
    twiddles are uploaded once per size, dtype and device)."""
    n = np.arange(N)
    return torch.as_tensor(np.exp(sign * 1j * np.pi * n / (2 * N))).to(
        device=device, dtype=cdt)


class TransformPlan:
    """Base transform plan for one axis at one grid scale."""

    def __init__(self, basis, scale):
        self.basis = basis
        self.scale = scale
        self.N = basis.size
        self.Ng = basis.grid_size(scale)


@register_transform("Jacobi", "matrix")
class JacobiMMT(TransformPlan):
    """
    Jacobi matrix-multiply transform (reference: core/transforms.py:115
    JacobiMMT). Grid is always the (a0, b0) Gauss grid of the basis family;
    forward projects onto (a0, b0) then applies the conversion to the
    basis's derivative level (a, b) = (a0+k, b0+k).
    """

    def __init__(self, basis, scale):
        super().__init__(basis, scale)
        from ..tools import jacobi
        Ng = self.Ng
        F = jacobi.forward_matrix(basis.size, basis.a0, basis.b0, Ng)
        if basis.k > 0:
            C = jacobi.conversion_matrix(basis.size, basis.a0, basis.b0,
                                         basis.k, basis.k)
            F = C @ F
        self.forward_mat = F                                   # (N, Ng)
        x = jacobi.build_grid(Ng, basis.a0, basis.b0)
        self.backward_mat = jacobi.build_polynomials(
            basis.size, basis.a, basis.b, x).T                 # (Ng, N)

    def forward(self, gdata, axis):
        return apply_matrix_torch(self.forward_mat, gdata, axis)

    def backward(self, cdata, axis):
        return apply_matrix_torch(self.backward_mat, cdata, axis)


def _dct2(x):
    """
    Unnormalized DCT-II along the last axis:
    y_n = 2 sum_j x_j cos(pi n (2j+1) / (2N)), via Makhoul's single
    length-N FFT of the even/odd reordering (real input).
    """
    N = x.shape[-1]
    cdt = _complex_dtype(x.dtype)
    v = torch.cat([x[..., 0::2], torch.flip(x[..., 1::2], dims=(-1,))],
                  dim=-1)
    V = torch.fft.fft(v.to(cdt), dim=-1)
    phase = _dct_phase(N, -1, cdt, x.device)
    return (2.0 * (phase * V).real).to(x.dtype)


def _idct2(y):
    """
    Inverse of _dct2 (up to the factor 2N): x_j such that _dct2(x) = y;
    equivalently a DCT-III evaluation
    x_j = y_0/(2N) + (1/N) sum_{n>=1} y_n cos(pi n (2j+1)/(2N)).
    """
    N = y.shape[-1]
    cdt = _complex_dtype(y.dtype)
    phase = _dct_phase(N, 1, cdt, y.device) / 2
    yrev = torch.cat([torch.zeros_like(y[..., :1]),
                      torch.flip(y[..., 1:], dims=(-1,))], dim=-1)
    W = phase * (y.to(cdt) - 1j * yrev.to(cdt))
    v = torch.fft.ifft(W, dim=-1).real.to(y.dtype)
    half = (N + 1) // 2
    x = torch.empty_like(v)
    x[..., 0::2] = v[..., :half]
    x[..., 1::2] = torch.flip(v[..., half:], dims=(-1,))
    return x


@register_transform("Jacobi", "fft")
class FastChebyshevTransform(TransformPlan):
    """
    O(N log N) Chebyshev transform via DCT with ultraspherical conversion
    (reference: core/transforms.py:801-890 FastChebyshevTransform).

    Applies to the Chebyshev grid family (a0 = b0 = -1/2):
      forward : flip grid -> DCT-II -> classical->orthonormal rescale ->
                truncate -> banded conversion to level k (diagonal shifts,
                offsets 0, 2, .., 2k)
      backward: inverse conversion k -> 0 solved level-by-level; each
                2-diagonal upper-triangular level telescopes into a
                strided reversed CUMSUM -> rescale -> zero-pad -> DCT-III
                -> flip.
    Non-Chebyshev families, coarse scales and unstable cumsum chains fall
    back to the MMT.
    """

    def __init__(self, basis, scale):
        super().__init__(basis, scale)
        self.cheb = (basis.a0 == -0.5 and basis.b0 == -0.5)
        self._mmt = None
        # no DCT grid for non-Chebyshev families; coarse scales (Ng < N)
        # need the rectangular MMT
        if not self.cheb or self.Ng < self.N:
            self._mmt = JacobiMMT(basis, scale)
            return
        from ..tools import jacobi as jt
        N, k = self.N, basis.k
        self.k = k
        # orthonormal P_n = r_n * cos(n theta): r_0 = 1/sqrt(pi), else sqrt(2/pi)
        r = np.full(N, np.sqrt(2.0 / np.pi))
        r[0] = 1.0 / np.sqrt(np.pi)
        self.rescale = r
        # per-level conversion diagonals (a0+l, b0+l) -> (a0+l+1, b0+l+1)
        self.levels = []
        stable = True
        for l in range(k):
            C = np.asarray(jt.conversion_matrix(N, basis.a0 + l, basis.b0 + l, 1, 1))
            d0 = np.diagonal(C).copy()
            d2 = np.zeros(N)
            d2[:N - 2] = np.diagonal(C, 2)
            # chain prefix products H_n (parity-strided) for the cumsum
            # inverse: u_n = (1/H_n) * revcumsum_parity(H * v/d0), with
            # H_{n+2} = H_n * (-d2_n / d0_n)
            rho = -d2 / d0
            H = np.ones(N)
            for n in range(2, N):
                H[n] = H[n - 2] * rho[n - 2]
            if not np.all(np.isfinite(H)) or np.abs(H).max() > 1e280 or \
                    np.abs(H[H != 0]).min() < 1e-280:
                stable = False
            self.levels.append((d0, d2[:N - 2].copy(), H))
        if not stable:
            self._mmt = JacobiMMT(basis, scale)

    @staticmethod
    def _revcumsum_parity(x):
        """Reversed cumulative sum along the last axis within each parity
        chain (stride-2): out[n] = sum_{m >= n, m = n mod 2} x[m]."""
        n = x.shape[-1]
        if n % 2:
            x = zeropad(x, [(0, 0)] * (x.ndim - 1) + [(0, 1)])
        pairs = x.reshape(x.shape[:-1] + (-1, 2))
        acc = torch.flip(torch.cumsum(torch.flip(pairs, dims=(-2,)), dim=-2),
                         dims=(-2,))
        return acc.reshape(x.shape[:-1] + (-1,))[..., :n]

    def forward(self, gdata, axis):
        if self._mmt is not None:
            return self._mmt.forward(gdata, axis)
        N, Ng = self.N, self.Ng
        data = torch.flip(torch.movedim(gdata, axis, -1), dims=(-1,))
        dt, dev = data.dtype, data.device
        y = _dct2(data)                                # y_n = 2 sum g cos(n th)
        chat = y / Ng
        chat[..., 0] /= 2.0
        u = chat[..., :N] / device_constant(self.rescale, dt, dev)
        for d0, d2, H in self.levels:
            v = device_constant(d0, dt, dev) * u
            v[..., :N - 2] += device_constant(d2, dt, dev) * u[..., 2:]
            u = v
        return torch.movedim(u, -1, axis)

    def backward(self, cdata, axis):
        if self._mmt is not None:
            return self._mmt.backward(cdata, axis)
        N, Ng = self.N, self.Ng
        u = torch.movedim(cdata, axis, -1)
        dt, dev = u.dtype, u.device
        for d0, d2, H in reversed(self.levels):
            Hj = device_constant(H, dt, dev)
            u = self._revcumsum_parity(Hj * u / device_constant(d0, dt, dev)) / Hj
        chat = u * device_constant(self.rescale, dt, dev)
        chat = zeropad(chat, [(0, 0)] * (chat.ndim - 1) + [(0, Ng - N)])
        # _idct2(y)_j = y_0/(2Ng) + (1/Ng) sum_n y_n cos(n th_j)
        chat[..., 0] *= 2.0
        g = _idct2(chat * Ng)
        return torch.movedim(torch.flip(g, dims=(-1,)), -1, axis)


@register_transform("RealFourier", "fft")
class RealFourierFFT(TransformPlan):
    """
    Real Fourier fast path via torch.fft.rfft/irfft
    (reference: core/transforms.py:513 ScipyRealFFT / :538 FFTWRealFFT).
    Coefficient layout: interleaved (cos, -sin) pairs,
    c[2g] = cos-amplitude, c[2g+1] = minus-sin-amplitude of mode g.
    """

    def forward(self, gdata, axis):
        N, Ng = self.N, self.Ng
        data = torch.movedim(gdata, axis, -1)
        F = torch.fft.rfft(data, dim=-1) / Ng
        K = N // 2
        F = F[..., :K]
        cos = 2.0 * F.real
        cos[..., 0] /= 2.0
        msin = 2.0 * F.imag
        msin[..., 0] = 0.0
        out = torch.stack([cos, msin], dim=-1).reshape(data.shape[:-1] + (N,))
        return torch.movedim(out, -1, axis)

    def backward(self, cdata, axis):
        N, Ng = self.N, self.Ng
        data = torch.movedim(cdata, axis, -1)
        K = N // 2
        pairs = data.reshape(data.shape[:-1] + (K, 2))
        cos = pairs[..., 0]
        msin = pairs[..., 1].clone()
        msin[..., 0] = 0.0
        F = torch.complex(cos, msin) / 2.0
        F[..., 0] *= 2.0
        # pad spectrum to the grid's rfft length
        F = zeropad(F, [(0, 0)] * (F.ndim - 1) + [(0, Ng // 2 + 1 - K)])
        out = torch.fft.irfft(F * Ng, n=Ng, dim=-1)
        return torch.movedim(out, -1, axis)
