"""
Fused spectral step (counterpart of dedalus_tpu/core/fusedstep.py): the
banded substitution kernel.

The port carries one solve composition, the JAX package's FUSED_SOLVE:
at factor time the banded panel factors are precomposed into per-block-row
GEMM operators (libraries/pencilops.BandedOps._precompose_subst), so every
solve is one banded substitution over them. The JAX package's other
[fusion] layers (the unfused solve, the precomposed transform chains) are
not carried, so the port has no [fusion] switches: the RHS transforms run
the FFT/DCT path, as the JAX package does on CPU.

The substitution: `banded_substitution(fsub, fp)` solves B~ y = fp against
the precomposed operators. On a CUDA tensor it launches the hand-written
kernel of csrc/banded_subst.cu (the port of the JAX package's Pallas
kernel, dedalus_tpu/core/fusedstep.py:520 pallas_substitution); on a CPU
tensor it runs `substitution_plain`, the same arithmetic as a loop over
block rows batched over the pencil groups. Nothing falls back from the
kernel to the plain version: a failed build or launch raises.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = ["banded_substitution", "substitution_plain", "substitution_cuda",
           "LAUNCHES", "RECORDED", "KERNEL_SOURCE", "build_dir",
           "load_kernel_library", "ptxas_report", "kernel_plan"]


# --------------------------------------------------------- the substitution

# kernel launches made by `substitution_cuda`, by kernel name
LAUNCHES = {"banded_subst": 0}
# launches recorded into a CUDA graph while a stream captures: they run
# when the graph is replayed, and the replays add them to LAUNCHES
# (core/stepgraph.py)
RECORDED = {"banded_subst": 0}

KERNEL_SOURCE = pathlib.Path(__file__).resolve().parent.parent \
    / "csrc" / "banded_subst.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_Q = 128

_LIB = None
_LIB_LOCK = threading.Lock()

# the kernel library's entry point for each dtype it takes (complex data
# as interleaved (re, im) pairs, torch's own layout)
_ENTRY = {torch.float64: "banded_subst_f64", torch.float32: "banded_subst_f32",
          torch.complex128: "banded_subst_c128",
          torch.complex64: "banded_subst_c64"}


def build_dir():
    """Where the kernel library is built: `$TORCH_EXTENSIONS_DIR/
    dedalus_tpu_torch` when that is set (an installed package), else
    build/kernels/ at the root of the checkout this package lies in
    (listed in .gitignore)."""
    ext = os.environ.get("TORCH_EXTENSIONS_DIR")
    if ext:
        return pathlib.Path(ext) / "dedalus_tpu_torch"
    return pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"


def build_tag(source, nvcc_version):
    """Cache key of a built library: the source, the nvcc flags and the
    compiler's version, so a changed toolkit or flag set rebuilds."""
    h = hashlib.sha256(source)
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version.encode())
    return h.hexdigest()[:12]


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the banded substitution kernel is "
                       "built from csrc/banded_subst.cu at first use")


def load_kernel_library():
    """Build csrc/banded_subst.cu with nvcc for sm_90a into `build_dir()`
    (a shared library with a plain C interface, keyed by `build_tag`) and
    load it with ctypes. Returns the loaded library; raises on a failed
    build. The compiler's register and shared-memory report (ptxas -v)
    is kept beside the library (`ptxas_report`)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        nvcc = _nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, check=True).stdout
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = build_tag(KERNEL_SOURCE.read_bytes(), version)
        target = out_dir / f"libbanded_subst_{tag}.so"
        if not target.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(KERNEL_SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed building {KERNEL_SOURCE.name}:\n"
                    f"{proc.stdout}\n{proc.stderr}")
            target.with_suffix(".ptxas.txt").write_text(proc.stderr)
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            fn.restype = i32
        lib.banded_subst_plan.argtypes = [i32, i32, i32, i32, i32, ptr]
        lib.banded_subst_plan.restype = i32
        lib.path = target
        _LIB = lib
        return lib


def ptxas_report():
    """The ptxas -v lines of the built kernel library (registers, shared
    memory and spills of each instantiation)."""
    path = load_kernel_library().path.with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


PLAN_KEYS = ("column_tile", "columns_per_block", "blocks_per_group",
             "blocks_per_sm", "stages", "panel_bytes", "smem_bytes",
             "y_in_smem", "split_rows")


def kernel_plan(G, k, NB, q, dtype):
    """The launch shape the kernel takes for a solve of G groups, k
    columns, NB block rows of width q in `dtype` on the current CUDA
    device: {PLAN_KEYS: int}. Raises where the kernel would refuse the
    shape."""
    lib = load_kernel_library()
    plan = (ctypes.c_int * len(PLAN_KEYS))()
    item = torch.empty((), dtype=dtype).element_size()
    err = lib.banded_subst_plan(G, k, NB, q, item, plan)
    if err != 0:
        raise RuntimeError(f"banded_subst plan refused: CUDA error {err}")
    return dict(zip(PLAN_KEYS, plan))


def _as_columns(fp):
    """(G, n_pad) or (G, k, n_pad) -> (G, k, n_pad) view."""
    return fp[:, None, :] if fp.ndim == 2 else fp


def substitution_plain(fsub, fp):
    """Plain torch version of the substitution kernel: solve B~ y = fp,
    `fp` (G, n_pad) or (G, k, n_pad) (k independent right-hand sides per
    group). Mirrors the JAX package's _solve_interior_fused
    (dedalus_tpu/libraries/pencilops.py:793): a loop over block rows,
    batched over the pencil groups.

        forward:  [y_i; w] = FwdOp_i @ [w; f_{i+1}]       i < NB-1
        last:     x_{NB-1} = lastOp @ w
        backward: x_i = BwdOp_i @ [y_i; x_{i+1}; x_{i+2}]
    """
    last = fsub["lastOp"]
    f = _as_columns(fp)
    G, k, n_pad = f.shape
    q = last.shape[-1]
    NB = n_pad // q
    fb = f.reshape(G, k, NB, q).permute(2, 0, 3, 1)         # (NB, G, q, k)
    w = fb[0]
    ys = []
    for i in range(NB - 1):
        op = fsub["FwdOp"][i].view(G, 2 * q, 2 * q)
        yw = op @ torch.cat([w, fb[i + 1]], dim=1)
        ys.append(yw[:, :q])
        w = yw[:, q:]
    x1 = last @ w
    x2 = torch.zeros_like(x1)
    xs = [x1]
    for i in range(NB - 2, -1, -1):
        op = fsub["BwdOp"][i].view(G, q, 3 * q)
        x = op @ torch.cat([ys[i], x1, x2], dim=1)
        xs.append(x)
        x1, x2 = x, x1
    x = torch.stack(xs[::-1])                                # (NB, G, q, k)
    out = x.permute(1, 3, 0, 2).reshape(G, k, n_pad)
    return out.reshape(fp.shape)


def substitution_cuda(fsub, fp):
    """Launch the banded substitution kernel (csrc/banded_subst.cu) on
    CUDA tensors: one thread block per pencil group (and per 16
    right-hand sides), on the current stream. The kernel sizes its
    shared-memory ring itself. Raises on a tensor it does not take (q
    above MAX_Q among them) or a launch error code. A launch made while
    the stream captures a CUDA graph counts in RECORDED, not LAUNCHES."""
    fwd, bwd, last = fsub["FwdOp"], fsub["BwdOp"], fsub["lastOp"]
    f = _as_columns(fp)
    G, k, n_pad = f.shape
    q = last.shape[-1]
    NB = n_pad // q
    tensors = (fwd, bwd, last, f)
    if any(t.dtype != fp.dtype for t in tensors) or fp.dtype not in _ENTRY:
        raise ValueError("substitution_cuda: operators and right-hand side "
                         "must share one dtype, float64, float32, "
                         "complex128 or complex64")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("substitution_cuda: tensors must be contiguous")
    if q > MAX_Q:
        raise ValueError(f"substitution_cuda: block size q = {q} exceeds "
                         f"the kernel's limit {MAX_Q}")
    if (n_pad % q or NB < 2 or last.shape != (G, q, q)
            or fwd.shape != (NB - 1, G, 4 * q * q)
            or bwd.shape != (NB - 1, G, 3 * q * q)):
        raise ValueError(
            f"substitution_cuda: shapes FwdOp {tuple(fwd.shape)}, BwdOp "
            f"{tuple(bwd.shape)}, lastOp {tuple(last.shape)}, fp "
            f"{tuple(fp.shape)} do not match one (NB={NB}, G={G}, q={q}) "
            "system")
    if any(t.device.type != "cuda" or t.device != fp.device for t in tensors):
        raise ValueError("substitution_cuda: all tensors must be on one CUDA "
                         "device")
    lib = load_kernel_library()
    fn = getattr(lib, _ENTRY[fp.dtype])
    out = torch.empty_like(f)
    stream = torch.cuda.current_stream(fp.device).cuda_stream
    with torch.cuda.device(fp.device):
        err = fn(fwd.data_ptr(), bwd.data_ptr(), last.data_ptr(),
                 f.data_ptr(), out.data_ptr(), G, k, NB, q, stream)
    if err != 0:
        raise RuntimeError(f"banded_subst kernel launch failed: CUDA error "
                           f"{err}")
    if torch.cuda.is_current_stream_capturing():
        RECORDED["banded_subst"] += 1
    else:
        LAUNCHES["banded_subst"] += 1
    return out.reshape(fp.shape)


def banded_substitution(fsub, fp):
    """Solve B~ y = fp against the precomposed substitution operators:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    A single block row (no FwdOp) is one lastOp product."""
    if "FwdOp" not in fsub:
        f = _as_columns(fp)
        return (fsub["lastOp"][:, None] @ f[..., None])[..., 0].reshape(fp.shape)
    if fp.device.type == "cuda":
        return substitution_cuda(fsub, fp)
    return substitution_plain(fsub, fp)
