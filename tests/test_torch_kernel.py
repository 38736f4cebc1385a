"""
The banded substitution kernel's wrapper (dedalus_tpu_torch/core/
fusedstep.py): the plain version's multi-column form, the dispatch by
device, the wrapper's checks, and — on an NVIDIA GPU — the CUDA kernel
held against the plain version. No jax import: on a machine with a card
and no jax this file runs alone,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py
"""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.core import fusedstep as tfused

torch.set_num_threads(1)


def random_fsub(rng, G, NB, q):
    """Random substitution operators scaled so the sweeps neither grow
    nor decay fast (entries ~ N(0, 1) / (2 sqrt(width)))."""
    return {
        "FwdOp": rng.standard_normal((NB - 1, G, 4 * q * q)) / (2 * np.sqrt(2 * q)),
        "BwdOp": rng.standard_normal((NB - 1, G, 3 * q * q)) / (2 * np.sqrt(3 * q)),
        "lastOp": rng.standard_normal((G, q, q)) / (2 * np.sqrt(q)),
    }


def torch_fsub(fsub, device="cpu", dtype=torch.float64):
    return {k: torch.as_tensor(np.array(v)).to(device=device, dtype=dtype)
            for k, v in fsub.items()}


def test_plain_columns_are_independent_solves():
    """The (G, k, n_pad) form solves k right-hand sides per group, each
    equal to its single-column solve."""
    rng = np.random.default_rng(3)
    G, NB, q, k = 2, 4, 4, 3
    fsub = torch_fsub(random_fsub(rng, G, NB, q))
    fp = torch.as_tensor(rng.standard_normal((G, k, NB * q)))
    out = tfused.substitution_plain(fsub, fp)
    for c in range(k):
        col = tfused.substitution_plain(fsub, fp[:, c].contiguous())
        assert torch.allclose(out[:, c], col, rtol=0, atol=1e-15)


def test_dispatch_uses_plain_on_cpu():
    rng = np.random.default_rng(5)
    fsub = torch_fsub(random_fsub(rng, 2, 3, 4))
    fp = torch.as_tensor(rng.standard_normal((2, 12)))
    before = tfused.LAUNCHES["banded_subst"]
    out = tfused.banded_substitution(fsub, fp)
    assert torch.equal(out, tfused.substitution_plain(fsub, fp))
    assert tfused.LAUNCHES["banded_subst"] == before


# (G, NB, q, k): several columns per group; NB = 2; q < 32 and not a
# multiple of 8 (q = 17: BwdOp and, in f32, lastOp slabs that are not
# 16-byte multiples, so the ring takes plain loads there); k = 16 (the
# Woodbury form); q = 64 (a FwdOp of 128 KB in f64, streamed in row
# panels); more groups than the H100's 132 SMs (two blocks per SM, so a
# warp per row, where the smaller grids split each row over threads);
# q = 8 with two columns; the Poisson 2048x1024 LBVP's shape (q = 6,
# NB = 342, G = 1024: a chain of 683 tiny operators per group)
CARD_SHAPES = [(5, 7, 32, 3), (3, 2, 32, 1), (4, 9, 17, 1), (4, 9, 17, 16),
               (2, 5, 64, 1), (2, 5, 64, 16), (200, 33, 32, 1), (6, 12, 8, 2),
               (1024, 342, 6, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("G,NB,q,k", CARD_SHAPES)
def test_kernel_matches_plain_on_card(G, NB, q, k, dtype):
    """CUDA kernel vs plain version on the card (bound: 1e-12 relative in
    f64, 1e-5 in f32 — the summation order differs; f32 against f64 on
    these operators differs by ~4e-7)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng = np.random.default_rng(11)
    fsub = torch_fsub(random_fsub(rng, G, NB, q), "cuda", dtype)
    shape = (G, NB * q) if k == 1 else (G, k, NB * q)
    fp = torch.as_tensor(rng.standard_normal(shape)).to("cuda", dtype)
    out = tfused.substitution_cuda(fsub, fp)
    ref = tfused.substitution_plain(fsub, fp)
    torch.cuda.synchronize()
    assert out.shape == fp.shape
    err = (out - ref).abs().max() / ref.abs().max()
    assert float(err) <= (1e-12 if dtype == torch.float64 else 1e-5)


def complex_fsub(rng, G, NB, q, device, dtype):
    """Random complex operators: independent real and imaginary parts,
    each scaled as in random_fsub, so |entries| match the real case up
    to sqrt(2)."""
    re, im = random_fsub(rng, G, NB, q), random_fsub(rng, G, NB, q)
    return {k: torch.complex(torch.as_tensor(re[k]), torch.as_tensor(im[k]))
            .to(device=device, dtype=dtype) / np.sqrt(2)
            for k in re}


# the complex instantiations at q = 6 and q = 7 (odd: BwdOp slabs that
# are not 16-byte multiples in complex64), one column and the k = 16
# Woodbury form, fewer and more groups than the card's SMs, and the
# complex Poisson 1024x512's own shape (q = 3, NB = 172, G = 1024)
COMPLEX_SHAPES = [(4, 9, 6, 1), (1024, 40, 6, 1), (3, 8, 6, 16),
                  (5, 11, 7, 1), (256, 30, 7, 1), (4, 6, 7, 16),
                  (1024, 172, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("G,NB,q,k", COMPLEX_SHAPES)
def test_complex_kernel_matches_plain_on_card(G, NB, q, k, dtype):
    """Complex CUDA kernel vs plain version on the card (bound: 1e-12
    relative in complex128, 1e-5 in complex64, as for f64/f32)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng = np.random.default_rng(17)
    fsub = complex_fsub(rng, G, NB, q, "cuda", dtype)
    shape = (G, NB * q) if k == 1 else (G, k, NB * q)
    fp = torch.complex(torch.as_tensor(rng.standard_normal(shape)),
                       torch.as_tensor(rng.standard_normal(shape)))
    fp = fp.to("cuda", dtype)
    out = tfused.substitution_cuda(fsub, fp)
    ref = tfused.substitution_plain(fsub, fp)
    torch.cuda.synchronize()
    assert out.shape == fp.shape and out.dtype == dtype
    err = (out - ref).abs().max() / ref.abs().max()
    assert float(err) <= (1e-12 if dtype == torch.complex128 else 1e-5)


# the kernel above q = 64: 3-D Rayleigh-Benard's q = 80 (its NB = 17 at
# few groups, and more groups than the card's SMs), k = 16 (the Woodbury
# form: working vectors of 60 KB in f64, so one block per SM) and k = 40
# (three column blocks per group), and the bound q = 128
LARGE_Q_SHAPES = [(3, 17, 80, 1), (200, 5, 80, 1), (3, 4, 80, 16),
                  (140, 3, 80, 40), (2, 3, 128, 1), (150, 3, 128, 1),
                  (2, 3, 128, 16)]
DTYPES = [torch.float64, torch.float32, torch.complex128, torch.complex64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,NB,q,k", LARGE_Q_SHAPES)
def test_large_q_kernel_matches_plain_on_card(G, NB, q, k, dtype):
    """Repair test: q = 80 and q = 128 run through the kernel (it refused
    q > 64 before) in all four dtypes and match the plain version (bound
    1e-12 relative in float64/complex128, 1e-5 in float32/complex64)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng = np.random.default_rng(23)
    shape = (G, NB * q) if k == 1 else (G, k, NB * q)
    if dtype.is_complex:
        fsub = complex_fsub(rng, G, NB, q, "cuda", dtype)
        fp = torch.complex(torch.as_tensor(rng.standard_normal(shape)),
                           torch.as_tensor(rng.standard_normal(shape)))
    else:
        fsub = torch_fsub(random_fsub(rng, G, NB, q), "cuda", dtype)
        fp = torch.as_tensor(rng.standard_normal(shape))
    fp = fp.to("cuda", dtype)
    before = tfused.LAUNCHES["banded_subst"]
    out = tfused.banded_substitution(fsub, fp)
    ref = tfused.substitution_plain(fsub, fp)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES["banded_subst"] == before + 1
    assert out.shape == fp.shape and out.dtype == dtype
    err = (out - ref).abs().max() / ref.abs().max()
    low = dtype in (torch.float32, torch.complex64)
    assert float(err) <= (1e-5 if low else 1e-12)


@pytest.mark.cuda
def test_complex_banded_lbvp_solves_on_card():
    """Repair test: a complex LBVP forced onto the banded path solves on
    the card (it raised ValueError in substitution_cuda before the
    kernel had complex instantiations), and its solution equals the CPU
    solve's to 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dedalus_tpu_torch.extras.bench_problems import build_poisson_solver
    out = {}
    for device in ("cuda", "cpu"):
        before = tfused.LAUNCHES["banded_subst"]
        ts, fields = build_poisson_solver(64, 32, "banded", device=device,
                                          dtype=np.complex128)
        ts.solve()
        launched = tfused.LAUNCHES["banded_subst"] - before
        assert launched > 0 if device == "cuda" else launched == 0
        out[device] = np.concatenate([np.asarray(fields[k]["c"]).ravel()
                                      for k in ("u", "tau_1", "tau_2")])
    err = np.max(np.abs(out["cuda"] - out["cpu"])) / np.max(np.abs(out["cpu"]))
    assert err <= 1e-12


def test_single_block_row_is_one_product():
    """NB == 1 (no FwdOp): the solve is lastOp @ f."""
    rng = np.random.default_rng(9)
    last = torch.as_tensor(rng.standard_normal((3, 4, 4)))
    fp = torch.as_tensor(rng.standard_normal((3, 4)))
    out = tfused.banded_substitution({"lastOp": last}, fp)
    assert torch.allclose(out, (last @ fp[..., None])[..., 0], rtol=0,
                          atol=1e-15)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "dtype"), ("half", "dtype"), ("contiguity", "contiguous"),
    ("q", "limit"),
    ("shape", "shapes"), ("device", "CUDA device")])
def test_wrapper_checks_refuse_bad_input(bad, match):
    """The wrapper checks dtype (one of float64, float32, complex128,
    complex64, shared by all inputs), contiguity, the q <= 128 limit,
    shapes and (last) the device before it builds or launches
    anything."""
    rng = np.random.default_rng(13)
    q = tfused.MAX_Q + 1 if bad == "q" else 4
    fsub = torch_fsub(random_fsub(rng, 2, 3, q))
    fp = torch.as_tensor(rng.standard_normal((2, 3 * q)))
    if bad == "dtype":
        fp = fp.float()
    elif bad == "half":
        fp = fp.half()
        fsub = {k: v.half() for k, v in fsub.items()}
    elif bad == "contiguity":
        fsub["BwdOp"] = fsub["BwdOp"].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "shape":
        fp = fp[:, :2 * q].contiguous()
    with pytest.raises(ValueError, match=match):
        tfused.substitution_cuda(fsub, fp)


@pytest.fixture
def port_config():
    """Edit the port's config for one test, restoring it afterwards."""
    from dedalus_tpu_torch.tools.config import config
    saved = {s: dict(config[s]) for s in config.sections()}
    yield config
    for s, items in saved.items():
        config[s].clear()
        config[s].update(items)


@pytest.mark.parametrize("raw,sweeps", [("auto", 1), ("0", 0), ("3", 3),
                                        ("-1", ValueError), ("x", ValueError)])
def test_refine_sweeps_parsing(port_config, raw, sweeps):
    from dedalus_tpu_torch.libraries.solvecomp import resolve_refine_sweeps
    port_config["precision"]["REFINE_SWEEPS"] = raw
    if sweeps is ValueError:
        with pytest.raises(ValueError, match="REFINE_SWEEPS"):
            resolve_refine_sweeps()
    else:
        assert resolve_refine_sweeps() == sweeps


def test_chunking_at_real_size(port_config):
    """The port's default BANDED_CHUNK_MB (2048, read from its cfg) splits
    the RB 2048x1024 factor (G = 1024, NB = 257, q = 32, f64) into 5
    chunks of 205 groups; a smaller setting gives more chunks."""
    import types
    from dedalus_tpu_torch.libraries.pencilops import BandedOps
    ops = types.SimpleNamespace(NB=257, q=32)
    assert port_config["linear algebra"]["BANDED_CHUNK_MB"] == "2048"
    assert BandedOps._pick_chunks(ops, 1024, 8) == (5, 205)
    port_config["linear algebra"]["BANDED_CHUNK_MB"] = "256"
    assert BandedOps._pick_chunks(ops, 1024, 8) == (35, 30)


def test_build_dir(monkeypatch):
    """The kernel is built beside the checkout unless TORCH_EXTENSIONS_DIR
    names a place for it."""
    monkeypatch.delenv("TORCH_EXTENSIONS_DIR", raising=False)
    root = tfused.KERNEL_SOURCE.parents[2]
    assert tfused.build_dir() == root / "build" / "kernels"
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", "/ext")
    assert str(tfused.build_dir()) == "/ext/dedalus_tpu_torch"


def test_build_tag_keys_source_flags_and_compiler(monkeypatch):
    src = tfused.KERNEL_SOURCE.read_bytes()
    tag = tfused.build_tag(src, "release 12.8")
    assert tag == tfused.build_tag(src, "release 12.8")
    assert tag != tfused.build_tag(src + b"\n", "release 12.8")
    assert tag != tfused.build_tag(src, "release 12.9")
    monkeypatch.setattr(tfused, "NVCC_FLAGS", tfused.NVCC_FLAGS + ("-G",))
    assert tag != tfused.build_tag(src, "release 12.8")


def test_profile_step_needs_a_card():
    """extras/profile_step.py measures device time on the card only."""
    from dedalus_tpu_torch.extras.profile_step import profile_steps
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_steps("rb", (8, 32), 1)
