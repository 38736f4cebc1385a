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
               (1024, 342, 6, 1),
               # the ball's shapes: internally heated convection 16x8x12
               # forced banded, and 64x32x48 under 'auto' with its
               # Woodbury form (42 pins)
               (64, 5, 32, 1), (1024, 16, 32, 1), (1024, 16, 32, 42)]


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


# the bf16 instantiation (the SOLVE_DTYPE = bf16 ladder) at the q of the
# sphere (7), 2-D RB (32), 3-D RB (80) and the bound (128): one column,
# the k = 16 Woodbury form, fewer and more groups than the card's SMs
BF16_SHAPES = [(5, 11, 7, 1), (256, 30, 7, 1), (3, 9, 32, 1),
               (200, 17, 32, 1), (4, 6, 32, 16), (3, 17, 80, 1),
               (150, 5, 80, 1), (2, 3, 128, 1), (2, 3, 128, 16)]


def test_bf16_plain_sums_in_f32():
    """The plain version takes bf16 operators and right-hand side and
    gives f32: the f32 solve of the bf16-rounded inputs, bit for bit."""
    rng = np.random.default_rng(29)
    fsub = torch_fsub(random_fsub(rng, 3, 5, 7), dtype=torch.bfloat16)
    fp = torch.as_tensor(rng.standard_normal((3, 2, 35))).bfloat16()
    out = tfused.banded_substitution(fsub, fp)
    ref = tfused.substitution_plain({k: v.float() for k, v in fsub.items()},
                                    fp.float())
    assert out.dtype == torch.float32 and torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("G,NB,q,k", BF16_SHAPES)
def test_bf16_kernel_matches_plain_on_card(G, NB, q, k):
    """The bf16 kernel (bf16 operators and right-hand side, f32 sums and
    output) against the plain version's f32 solve of the same bf16
    inputs: 1e-5 relative (the summation order differs, as in f32), one
    launch counted as banded_subst_bf16."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng = np.random.default_rng(31)
    fsub = torch_fsub(random_fsub(rng, G, NB, q), "cuda", torch.bfloat16)
    shape = (G, NB * q) if k == 1 else (G, k, NB * q)
    fp = torch.as_tensor(rng.standard_normal(shape)).to("cuda",
                                                        torch.bfloat16)
    before = dict(tfused.LAUNCHES)
    out = tfused.banded_substitution(fsub, fp)
    ref = tfused.substitution_plain(fsub, fp)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES["banded_subst_bf16"] == \
        before["banded_subst_bf16"] + 1
    assert tfused.LAUNCHES["banded_subst"] == before["banded_subst"]
    assert out.shape == fp.shape and out.dtype == torch.float32
    err = (out - ref).abs().max() / ref.abs().max()
    assert float(err) <= 1e-5


def ladder_states(build, device, steps, config):
    """States of `steps` steps of build(device) under `config` ({(section,
    key): value}, restored afterwards), and the kernel's launches by
    name."""
    from dedalus_tpu_torch.tools.config import config as port_config
    saved = {key: port_config[key[0]].get(key[1], "auto") for key in config}
    for (section, key), value in config.items():
        port_config[section][key] = value
    try:
        solver, dt = build(device)
        before = dict(tfused.LAUNCHES)
        for _ in range(steps):
            solver.step(dt)
        launched = {k: tfused.LAUNCHES[k] - before[k] for k in before}
    finally:
        for (section, key), value in saved.items():
            port_config[section][key] = value
    return solver, solver.X.cpu().numpy(), launched


def rb8x32(device):
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    return build_rb_solver(8, 32, np.float64, matsolver="banded",
                           device=device)[0], 0.01


def sw32x16(device):
    from dedalus_tpu_torch.extras.bench_problems import build_shallow_water
    return build_shallow_water(32, 16, np.float64, matsolver="banded",
                               device=device)[:2]


# a ladder step on the card against the native step and against the same
# step on the CPU: the f32 ladder on RB 8x32 (bound 1e-9 of max|X| at its
# 2 auto sweeps, as for the JAX package's tests/test_solvecomp.py); the
# bf16 ladder on the sphere, where its 6 sweeps refine to the f64 class
# (bound 1e-12; on RB the bf16 refinement does not converge, in the JAX
# package either: NaN after 8 steps at RB 8x32)
@pytest.mark.cuda
@pytest.mark.parametrize("build,dtype,name,bound", [
    (rb8x32, "f32", "banded_subst", 1e-9),
    (sw32x16, "bf16", "banded_subst_bf16", 1e-12)],
    ids=["rb8x32-f32", "sw32x16-bf16"])
def test_ladder_step_on_card_matches_cpu(build, dtype, name, bound):
    """One ladder step on the card through the kernel (launches equal to
    the plan's count: one per factor for the Woodbury solve at native
    precision, one per solve in the ladder's dtype) within `bound` of
    max|X| of the native step on the card, and within twice that of the
    same ladder step on the CPU (each side's rounding is its own)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cfg = {("precision", "SOLVE_DTYPE"): dtype}
    solver, x_card, launched = ladder_states(build, "cuda", 1, cfg)
    _, x_native, _ = ladder_states(build, "cuda", 1, {})
    _, x_cpu, cpu_launched = ladder_states(build, "cpu", 1, cfg)
    ts = solver.timestepper
    solves = ts.stages * (1 + solver.ops.sweeps)
    low = launched["banded_subst_bf16"] if name != "banded_subst" \
        else launched["banded_subst"] - ts.factorizations
    assert low == solves
    assert launched["banded_subst"] == (ts.factorizations if name !=
                                        "banded_subst" else
                                        ts.factorizations + solves)
    assert not any(cpu_launched.values())
    scale = np.max(np.abs(x_native))
    assert np.max(np.abs(x_card - x_native)) <= bound * scale
    assert np.max(np.abs(x_card - x_cpu)) <= 2 * bound * scale


@pytest.mark.cuda
@pytest.mark.parametrize("config", [
    {("fusion", "SOLVE_COMPOSITION"): "ascan"},
    {("fusion", "SOLVE_COMPOSITION"): "spike"},
    {("fusion", "FUSED_SOLVE"): "off"}], ids=["ascan", "spike", "unfused"])
def test_compositions_launch_no_kernel_on_card(config):
    """ascan, spike and the unfused solve run their GEMM and triangular
    programs: 0 kernel launches over the factor and two RB 8x32 steps,
    and the state within 1e-11 of the sequential run's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _, x_seq, seq = ladder_states(rb8x32, "cuda", 2, {})
    _, x_new, launched = ladder_states(rb8x32, "cuda", 2, config)
    assert seq["banded_subst"] > 0 and not any(launched.values())
    assert np.max(np.abs(x_new - x_seq)) <= 1e-11 * np.max(np.abs(x_seq))


# the transposed solve's kernel (banded_subst_T) at the q of the sphere
# (7), 2-D RB (32), 3-D RB (80) and the bound (128), more and fewer groups
# than the card's SMs
TRANSPOSE_SHAPES = {7: (256, 12, 7), 32: (200, 17, 32), 80: (3, 9, 80),
                    128: (2, 3, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES + [torch.bfloat16])
@pytest.mark.parametrize("q", sorted(TRANSPOSE_SHAPES))
def test_transposed_kernel_matches_plain_on_card(q, dtype):
    """banded_subst_T against substitution_transpose_plain on the same
    inputs: 1e-12 of max|plain| in f64/complex128, 1e-5 in f32/complex64
    and in bf16 (against the plain version's f32 transpose of the same
    bf16 inputs); one launch counted under its name; in f64 the
    identity <S f, g> = <f, S^T g> through both kernels to 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    G, NB = TRANSPOSE_SHAPES[q][:2]
    rng = np.random.default_rng(37 + q)
    if dtype.is_complex:
        fsub = complex_fsub(rng, G, NB, q, "cuda", dtype)
        g = rng.standard_normal((G, NB * q)) \
            + 1j * rng.standard_normal((G, NB * q))
    else:
        fsub = torch_fsub(random_fsub(rng, G, NB, q), "cuda", dtype)
        g = rng.standard_normal((G, NB * q))
    g = torch.as_tensor(g).to("cuda", dtype)
    name = "banded_subst_T_bf16" if dtype == torch.bfloat16 \
        else "banded_subst_T"
    before = dict(tfused.LAUNCHES)
    out = tfused.banded_substitution_transpose(fsub, g)
    ref = tfused.substitution_transpose_plain(fsub, g)
    torch.cuda.synchronize()
    assert {k: tfused.LAUNCHES[k] - before[k] for k in before} == \
        {k: int(k == name) for k in before}
    assert out.shape == g.shape and out.dtype == ref.dtype
    bound = 1e-12 if dtype in (torch.float64, torch.complex128) else 1e-5
    assert float((out - ref).abs().max() / ref.abs().max()) <= bound
    if dtype == torch.float64:
        f = torch.as_tensor(rng.standard_normal((G, NB * q)), device="cuda")
        lhs = float((tfused.substitution_cuda(fsub, f) * g).sum())
        rhs = float((f * out).sum())
        assert lhs == pytest.approx(rhs, rel=1e-12)


def rb64x16(device):
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    return build_rb_solver(64, 16, np.float64, matsolver="banded",
                           device=device)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("K,sweeps", [
    pytest.param(1, "auto", id="1"), pytest.param(2, "auto", id="2"),
    pytest.param(1, "2", id="1-2sweeps")])
def test_value_and_grad_on_card_matches_cpu(port_config, K, sweeps):
    """value_and_grad of sum(XT**2) over 4 RK222 steps of RB 64x16
    (banded, 1 and 2 refinement sweeps) on the card against the same
    call on the CPU: the loss within 1e-12 relative, the gradient within
    5e-11 of max|g|.
    Launches on the card: the forward pass's banded_subst count equals a
    forward() call's; the backward pass launches banded_subst_T exactly
    as often; the recompute adds exactly K (L per_step - per_solve)
    banded_subst launches (0 at K = 1): each of the K segments of L =
    4 // K steps runs again up to its last solve, whose backward pass
    keeps no tensor, so checkpoint stops before it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    port_config["precision"]["REFINE_SWEEPS"] = sweeps
    n = 4
    out = {}
    for device in ("cuda", "cpu"):
        solver = rb64x16(device)
        div = solver.differentiable(loss=lambda X: (X ** 2).sum(),
                                    checkpoint_segments=K)
        before = dict(tfused.LAUNCHES)
        div.forward(n, 1e-3)                   # builds and caches factors
        after_factor_and_forward = dict(tfused.LAUNCHES)
        val, grads = div.value_and_grad(n, 1e-3)
        launched = {k: tfused.LAUNCHES[k] - after_factor_and_forward[k]
                    for k in before}
        out[device] = (val, grads["initial_state"].cpu().numpy(), launched)
        if device == "cuda":
            # the forward pass alone, with its factors cached
            per_solve = 1 + solver.ops.sweeps
            per_step = solver.timestepper.stages * per_solve
            mark = dict(tfused.LAUNCHES)
            div.forward(n, 1e-3)
            fwd = tfused.LAUNCHES["banded_subst"] - mark["banded_subst"]
            assert fwd == n * per_step
    val, g, launched = out["cuda"]
    assert launched["banded_subst_T"] == fwd
    assert launched["banded_subst"] - fwd == \
        (0 if K == 1 else K * ((n // K) * per_step - per_solve))
    assert not any(out["cpu"][2].values())
    loss_err = abs(val - out["cpu"][0]) / abs(out["cpu"][0])
    grad_err = np.max(np.abs(g - out["cpu"][1])) / np.max(np.abs(g))
    print(f"K={K}, sweeps {sweeps}: loss {loss_err:.3e}, gradient "
          f"{grad_err:.3e} relative card vs CPU")
    assert loss_err <= 1e-12
    # measured 1.475e-11 at one sweep and 1.485e-11 at two on an H100:
    # a second sweep does not narrow it (on the CPU alone it narrows the
    # banded-vs-dense gap from 9.1e-12 to 2.1e-12), so the gap is not the
    # refinement's accuracy; the pencil matrices' condition number here
    # is up to 1.5e7, so the normwise worst case of a rounding difference
    # is ~3e-9
    assert grad_err <= 5e-11


def annulus32x16(device):
    from dedalus_tpu_torch.extras.bench_problems import \
        build_annulus_convection
    return build_annulus_convection(32, 16, device=device)[0], 0.125


def disk16x32(device):
    from dedalus_tpu_torch.extras.bench_problems import build_disk_libration
    return build_disk_libration(16, 32, device=device)[:2]


def shell16x8x6(device):
    from dedalus_tpu_torch.extras.bench_problems import \
        build_shell_convection
    return build_shell_convection(16, 8, 6, device=device)[:2]


def rotconv16x8x8(device):
    from dedalus_tpu_torch.extras.bench_problems import build_rotconv
    return build_rotconv(16, 8, 8, device=device)


# the annulus's m = 0 pencil is singular in the example's formulation (p
# against the velocity taus), so p and tau_u are left out; the disk's p
# and taus carry no time derivative and sit on pencils of condition
# ~1e6, so they are held to 1e-10 of the state, u to 1e-12; rotconv's
# (unnamed taus by index, var<i>) on pencils of condition ~1e10 to 1e-9
@pytest.mark.cuda
@pytest.mark.parametrize("build,held,others", [
    (annulus32x16, ("b", "u", "tau_p", "tau_b1", "tau_b2"), None),
    (disk16x32, ("u",), 1e-10),
    (shell16x8x6, ("p", "b", "u", "tau_p", "tau_b1", "tau_b2", "tau_u1",
                   "tau_u2"), None),
    (rotconv16x8x8, ("u", "T"), 1e-9)],
    ids=["annulus32x16", "disk16x32", "shell16x8x6", "rotconv16x8x8"])
def test_polar_ivp_on_card_matches_cpu(build, held, others):
    """10 steps of the polar and shell examples' build functions (dense:
    no kernel launch) on the card against the CPU: the held fields within
    1e-12 of the state's largest entry, the others within `others`."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = {}
    for device in ("cuda", "cpu"):
        before = dict(tfused.LAUNCHES)
        solver, dt = build(device)
        for _ in range(10):
            solver.step(dt)
        assert tfused.LAUNCHES == before
        assert bool(torch.isfinite(solver.X).all())
        out[device] = ({v.name or f"var{i}": np.array(v["c"])
                        for i, v in enumerate(solver.variables)},
                       np.abs(solver.X.cpu().numpy()).max())
    (card, _), (cpu, scale) = out["cuda"], out["cpu"]
    for name in cpu:
        err = np.max(np.abs(card[name] - cpu[name])) / scale
        bound = 1e-12 if name in held else others
        assert bound is None or err <= bound, (name, err)


@pytest.mark.cuda
def test_ball_banded_on_card_matches_cpu():
    """build_ball_convection(16, 8, 12) forced banded (q = 32, NB = 5, 18
    pins; its pinned base repaired by one swap at the first
    factorization) on the card and on the CPU: 10 SBDF2 steps, every
    field within 1e-12 of the state's largest entry, the card's run
    through the kernel, no floored pivot."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dedalus_tpu_torch.extras.bench_problems import build_ball_convection
    out = {}
    for device in ("cuda", "cpu"):
        before = tfused.LAUNCHES["banded_subst"]
        solver, dt, _ = build_ball_convection(16, 8, 12, matsolver="banded",
                                              device=device)
        assert (solver.ops.q, solver.ops.NB, solver.ops.t) == (32, 5, 18)
        for _ in range(10):
            solver.step(dt)
        launched = tfused.LAUNCHES["banded_subst"] - before
        assert launched > 0 if device == "cuda" else launched == 0
        assert solver.structure.pin_swaps == 1
        assert int(solver.floored_pivots.sum()) == 0
        assert bool(torch.isfinite(solver.X).all())
        out[device] = ({v.name: np.array(v["c"]) for v in solver.variables},
                       np.abs(solver.X.cpu().numpy()).max())
    (card, _), (cpu, scale) = out["cuda"], out["cpu"]
    for name in cpu:
        err = np.max(np.abs(card[name] - cpu[name])) / scale
        assert err <= 1e-12, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("per_member_dt", [False, True],
                         ids=["shared-dt", "per-member-dt"])
def test_fleet_on_card_matches_cpu(per_member_dt):
    """An RB 8x32 banded fleet (bench_problems.build_rb_ensemble, 3
    members, RK222; core/ensemble.py) on the card and on the CPU: after
    its factoring first step, 4 steps of step_many (a replayed CUDA graph
    on the card) launch one kernel per solve, 2 stages x (1 + sweeps) a
    step, with the members as the kernel's columns (a shared dt) or its
    pencil groups (per-member dts); the states agree within 1e-12 of the
    largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dedalus_tpu_torch.extras.bench_problems import build_rb_ensemble
    out = {}
    for device in ("cuda", "cpu"):
        solver, member_init = build_rb_ensemble(8, 32, device=device)
        ens = solver.ensemble(3, per_member_dt=per_member_dt)
        ens.init_members(member_init)
        if per_member_dt:
            ens.set_member_dts([0.01, 0.007, 0.005])
            ens.step()
        else:
            ens.step(0.01)
        before = tfused.LAUNCHES["banded_subst"]
        ens.step_many(4)
        launched = tfused.LAUNCHES["banded_subst"] - before
        expected = 4 * 2 * (1 + solver.ops.sweeps) if device == "cuda" else 0
        assert launched == expected
        assert bool(torch.isfinite(ens.X).all())
        out[device] = ens.X.cpu().numpy()
    err = np.max(np.abs(out["cuda"] - out["cpu"])) / np.abs(out["cpu"]).max()
    assert err <= 1e-12, err


def test_transpose_dispatch_uses_plain_on_cpu():
    rng = np.random.default_rng(41)
    fsub = torch_fsub(random_fsub(rng, 2, 3, 4))
    g = torch.as_tensor(rng.standard_normal((2, 12)))
    before = dict(tfused.LAUNCHES)
    out = tfused.banded_substitution_transpose(fsub, g)
    assert torch.equal(out, tfused.substitution_transpose_plain(fsub, g))
    assert tfused.LAUNCHES == before


@pytest.mark.parametrize("bad,match", [
    ("dtype", "dtype"), ("contiguity", "contiguous"), ("device", "CUDA")])
def test_transposed_wrapper_checks_refuse_bad_input(bad, match):
    rng = np.random.default_rng(43)
    fsub = torch_fsub(random_fsub(rng, 2, 3, 4))
    g = torch.as_tensor(rng.standard_normal((2, 12)))
    if bad == "dtype":
        g = g.float()
    elif bad == "contiguity":
        g = torch.as_tensor(rng.standard_normal((12, 2))).T
    with pytest.raises(ValueError, match=match):
        tfused.substitution_transpose_cuda(fsub, g)


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
    """[precision] REFINE_SWEEPS through the solve plan: auto keeps the
    ops' own count (None: BandedOps.refine, 1, at the native dtype)."""
    from dedalus_tpu_torch.libraries.solvecomp import resolve_solve_plan
    port_config["precision"]["REFINE_SWEEPS"] = raw
    if sweeps is ValueError:
        with pytest.raises(ValueError, match="REFINE_SWEEPS"):
            resolve_solve_plan()
    else:
        plan = resolve_solve_plan()
        assert (1 if plan.sweeps is None else plan.sweeps) == sweeps


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


@pytest.mark.cuda
def test_snapshot_survives_replayed_block_on_card(tmp_path):
    """On the card step_many replays a recorded CUDA graph that writes
    the state and the histories into static buffers: a snapshot and an
    async checkpoint taken before the block still hold the old state."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    from dedalus_tpu_torch.tools import dcheckpoint as tdc
    from dedalus_tpu_torch.tools import resilience as tres
    solver, _ = build_rb_solver(64, 16, np.float64, matsolver="banded",
                                device="cuda", timestepper="SBDF2",
                                metrics=False, health=False)
    for _ in range(3):
        solver.step(1e-3)
    solver.step_many(4, 1e-3)           # records the graph
    before = solver.X.clone()
    snap = tres.capture_snapshot(solver)
    ck = tdc.ShardedCheckpointer(tmp_path, async_write=True)
    loop = tres.ResilientLoop(solver, dt=1e-3, install_signal_handlers=False)
    ck.save(*loop._sharded_state())
    solver.step_many(8, 1e-3)           # replays into the static buffers
    assert not torch.equal(solver.X, before)
    assert torch.equal(snap.X, before)
    assert ck.close() == []
    got = tdc.restore_latest(tmp_path)["arrays"]["X"]
    assert np.array_equal(got, before.cpu().numpy())
