"""
Array helpers: host-side sparse utilities and device-side axis-wise matrix
application (counterpart of dedalus_tpu/tools/array.py).

Host functions use numpy/scipy.sparse and run only at problem-setup time.
Device functions are plain torch functions of their tensor arguments.
"""

import weakref

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
    An entry lives as long as its host matrix (a finalizer drops it), so
    the identity cannot be reused while it is cached, and the matrices of
    an expression evaluated once do not stay on the device."""
    dtype = torch_dtype(dtype)
    key = (id(matrix), dtype, str(device))
    hit = _CONSTANTS.get(key)
    if hit is not None:
        return hit
    host = matrix.toarray() if sp.issparse(matrix) else np.asarray(matrix)
    # a copy also on the CPU: a tensor sharing the host buffer would keep
    # the matrix, and so its entry, alive
    out = torch.tensor(host, dtype=dtype, device=device)
    _CONSTANTS[key] = out
    weakref.finalize(matrix, _CONSTANTS.pop, key, None)
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
    follows the data; a complex matrix promotes real data, and a real
    matrix acts on the real and imaginary parts of complex data (torch's
    matmul takes one dtype, where jnp.matmul promotes).
    """
    matrix = match_precision(matrix, array)
    if matrix.is_complex() and not array.is_complex():
        array = array.to(matrix.dtype)
    if array.is_complex() and not matrix.is_complex():
        return torch.complex(apply_matrix_torch(matrix, array.real, axis),
                             apply_matrix_torch(matrix, array.imag, axis))
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


def scipy_sparse_eigs(A, B, N, target, matsolver=None, left=False, **kw):
    """
    Shift-invert sparse eigensolve of the generalized problem
    A.x = lambda B.x around `target`, on the host with scipy/ARPACK
    (counterpart of dedalus_tpu/tools/array.py:118; reference:
    tools/array.py:398-444). Returns (evals, evecs), and with `left` also
    the left eigenvalues and eigenvectors.
    """
    import scipy.sparse.linalg as spla
    A = sp.csc_matrix(A)
    B = sp.csc_matrix(B)
    C = A - target * B
    solver = spla.factorized(C)

    def matvec(x):
        return solver(B @ x)

    op = spla.LinearOperator(dtype=np.complex128, shape=A.shape,
                             matvec=matvec)
    evals, evecs = spla.eigs(op, k=N, which="LM", sigma=None, **kw)
    # shift-invert eigenvalues mu = 1 / (lambda - target)
    evals = target + 1.0 / evals
    if left:
        solver_H = spla.factorized(C.conj().T)

        def matvec_H(x):
            return B.conj().T @ solver_H(x)

        op_H = spla.LinearOperator(dtype=np.complex128, shape=A.shape,
                                   matvec=matvec_H)
        evals_left, evecs_left = spla.eigs(op_H, k=N, which="LM", **kw)
        evals_left = target + 1.0 / np.conj(evals_left)
        return evals, evecs, evals_left, evecs_left
    return evals, evecs


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
