"""
Array helpers: host-side sparse utilities and device-side axis-wise matrix
application (counterpart of dedalus_tpu/tools/array.py).

Host functions use numpy/scipy.sparse and run only at problem-setup time.
Device functions are plain torch functions of their tensor arguments.
"""

import numpy as np
import scipy.sparse as sp
import torch


_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def torch_dtype(dtype):
    """torch dtype of a numpy dtype (or pass a torch dtype through)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def to_numpy(tensor):
    """Host numpy copy of a tensor on any device."""
    return tensor.detach().cpu().numpy()


# -------------------------------------------------------------- device side

def zeropad(x, pad_width):
    """Zero padding of `x` with a numpy-style spec: one non-negative
    (before, after) pair per dim."""
    flat = []
    for before, after in reversed(pad_width):
        flat.extend((int(before), int(after)))
    if not any(flat):
        return x
    return torch.nn.functional.pad(x, flat)


_CONSTANTS = {}


def device_constant(matrix, dtype, device):
    """Device copy of a host (numpy/scipy) operator matrix, cached per
    (object identity, dtype, device): transform and operator matrices are
    built once on the host and uploaded once, not on every evaluation.
    The cache holds a reference to the host object so its identity cannot
    be reused by another matrix."""
    dtype = torch_dtype(dtype)
    key = (id(matrix), dtype, str(device))
    hit = _CONSTANTS.get(key)
    if hit is not None:
        return hit[1]
    host = matrix.toarray() if sp.issparse(matrix) else np.asarray(matrix)
    out = torch.as_tensor(host).to(device=device, dtype=dtype)
    _CONSTANTS[key] = (matrix, out)
    return out


def match_precision(matrix, data):
    """Device copy of a host operator matrix at the working precision of the
    tensor `data` (f32 data keeps f32 operators), preserving complexness
    only when the matrix is complex."""
    if isinstance(matrix, torch.Tensor):
        return matrix.to(device=data.device)
    low = data.dtype in (torch.float32, torch.complex64)
    host_dtype = matrix.dtype
    if np.issubdtype(host_dtype, np.complexfloating):
        target = torch.complex64 if low else torch.complex128
    else:
        target = torch.float32 if low else torch.float64
    return device_constant(matrix, target, data.device)


def apply_matrix_torch(matrix, array, axis):
    """
    Device-side: contract ``matrix`` (m_out, m_in) with ``array`` along
    ``axis`` (the counterpart of apply_matrix_jax). The matrix precision
    follows the data.
    """
    matrix = match_precision(matrix, array)
    if matrix.is_complex() and not array.is_complex():
        array = array.to(matrix.dtype)
    arr = torch.movedim(array, axis, -1)
    out = torch.matmul(arr, matrix.T)
    return torch.movedim(out, -1, axis)


# ---------------------------------------------------------------- host side

def kron(*factors):
    """Sparse Kronecker product of several factors (reference: tools/array.py:325)."""
    out = factors[0]
    for f in factors[1:]:
        out = sp.kron(out, f, format="csr")
    return sp.csr_matrix(out)


def sparsify(dense, cutoff=1e-14):
    """
    Convert a dense matrix to CSR, dropping entries below `cutoff` relative
    to the max magnitude. Used to recover exact band structure from
    quadrature-built matrices. Sparse input passes through as CSR.
    """
    if sp.issparse(dense):
        return dense.tocsr()
    dense = np.asarray(dense)
    scale = np.max(np.abs(dense)) if dense.size else 0.0
    if scale == 0.0:
        return sp.csr_matrix(dense.shape)
    clipped = np.where(np.abs(dense) >= cutoff * scale, dense, 0.0)
    return sp.csr_matrix(clipped)
