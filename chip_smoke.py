#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (dedalus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase at full size
    python3 chip_smoke.py --real 1024 512 # a smaller real-size phase

Phases (each prints its own lines; any failure exits non-zero):

  1. The card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of the banded substitution kernel from
     dedalus_tpu_torch/csrc/banded_subst.cu (nvcc, sm_90a).
  2. Kernel vs its plain PyTorch version on the card, at the RB 2048x1024
     shapes (random operators from a seed) in f64 and f32, and in the
     factor-time Woodbury form (16 right-hand sides per group, f64): max
     relative error against a stated bound, median times of both (warm,
     and cold: each launch after a 64 MB write that flushes the 50 MB L2),
     one torch.sum over the same operator bytes as a read-bandwidth
     yardstick of the card, the byte bound.
  3. The main path: build_rb_solver(256, 64, float64, matsolver="banded")
     on cuda through the public API, 50 RK222 steps. Checks: finite state,
     boundary conditions, the incompressibility equation, an RB 8x32 run
     on the card against the same run on the CPU, and the kernel's launch
     count (factorizations + stage solves x (1 + refinement sweeps),
     whatever the factor's G-chunk count). Then the kernel vs plain check
     at the solver's own factor operators (f64 and f32), and a per-layer
     time breakdown of one stage. Beside it, RB 256x64 with
     matsolver=None ('auto' picks the dense path at this size, as the JAX
     package does off the TPU): build, factor, steps/s, and its state
     after the same 50 steps against the banded one (1e-10 relative).
     Neither path may synchronize the host in a steady step (torch's
     sync debug mode; so too in phases 5 and 6).
  4. Real size: RB 2048x1024 (the target of BASELINE.json): build,
     factor, 10 steps, steps/s, peak device memory, the same checks.
  5. kdv1024 (benchmarks/progression.py config 1: RealFourier 1024,
     SBDF2, dt 2e-3, dense): build, 2 factorizations, steps/s over 500
     steps after 10 warm ones, no host syncs in steady steps, a per-layer
     breakdown, launches per step and the idle share (torch.profiler).
     Checks: mass integ(u) conserved to 1e-13 relative; KdV 64, 50 steps,
     card vs CPU to 1e-12.
  6. shear512 (config 2: RealFourier^2 512x512, RK222, dt 0.25/512,
     dense, G = 65536, S = 20): build with its parts, factor, steps/s
     over 100 steps after 10 warm ones, peak memory, the same profile.
     Checks: div(u) + tau_p within 1e-10 of max|grad u|, |integ(p)| <=
     1e-10, integ(s) conserved to 1e-12 relative, shear 32x32 10 steps
     card vs CPU to 1e-12; then 30 steps driven by CFL with the settings
     of examples/shear_flow.py: the dt sequence and the refactorizations.
  7. poisson2048x1024 (examples/poisson.py at the target resolution,
     LBVP, MATRIX_SOLVER 'auto', so banded: G = 1024, S = 2052, q = 6,
     NB = 342, 4 pins): build with its phases, solve, 25 warm solves with
     f changed on the card between them (median ms, CUDA events, and
     host wall), a re-factor, peak memory; launches from the build to
     the last timed solve = 1 (the factor's Woodbury solve) + one per
     solve pass; no host synchronization in a warm solve(); u(y=0) = g
     to 1e-12 of max|g|, dy(u)(y=Ly) to 1e-10 of max|dy(u)|, the
     tau-corrected equation to 1e-10 of max|f|; Poisson 64x32 banded
     card vs CPU to 1e-12. The kernel vs plain on this factor's own
     operators (q = 6).
  8. poisson256x128 (the example's size; 'auto' takes the dense path):
     the same checks and timings, and the forced banded run of the same
     problem beside it; the two solutions within 1e-12.
  9. bratu256 (NLBVP u'' + exp(u) = 0, dense): Newton from u = 0 to a
     perturbation norm below 1e-10 in at most 8 iterations, seconds per
     iteration split into host Jacobian assembly and factor + solve,
     error against the closed form <= 1e-10; Bratu 32 card vs CPU to
     1e-12; the sin-Jacobi NLBVP of the JAX package's tests at N = 64
     within 1e-6 of cos(x).
 10. rbevp64 (examples/rayleigh_benard_evp.py at Nz = 64, complex128,
     ComplexFourier carrier, solve_sparse of 10 modes around 0) for 5 kx
     in [3.0, 3.25] at Ra = 1700 and 1710: build and eigensolve seconds
     per kx; the peak growth rate < 0 at 1700 and > 0 at 1710; the
     fastest mode put on the card by set_state is finite and no-slip
     to 1e-10.
 11. waves128 (examples/waves_on_a_string.py, Legendre, solve_dense with
     left eigenvectors): the lowest 8 eigenvalues within 1e-8 of
     (n pi)^2, left eigenvectors biorthonormal against -M to 1e-8.
     Phases 5, 6 and 9-11 each run with the kernel's count set to 0
     just before and read just after; it must stay 0.
 12. sw512x256 (benchmarks/progression.py config 4, the Galewsky jet
     on the sphere, through extras/bench_problems.py
     build_shallow_water: SphereBasis 512x256, dealias 3/2, RK222,
     dt = 300 s in simulation units; 'auto' takes the banded path,
     q = 7): sw64x32 forced banded card vs CPU to 1e-12 after the
     balanced-height LBVP and 10 steps; build with its phases, the
     balance LBVP re-solved (|ave(h)| <= 1e-13 max|h|, tau-corrected
     residual <= 1e-10 of its RHS), the factor and SW_STEPS timed steps
     (steps/s), launches = 1 + 4 x (1 + SW_STEPS) (the factoring first
     step and the timed ones), no host sync in a steady
     step, finite state, integ(h) drift <= 1e-12 of 4 pi max|h|, the
     vorticity -div(skew(u)) through a DictionaryHandler, peak memory,
     the per-layer breakdown, launches per step and the idle share
     (torch.profiler), and the kernel vs plain at this factor's own
     operators (q = 7, f64).
 13. Complex banded solves: the complex128 Poisson (build_poisson_solver
     on a ComplexFourier x ChebyshevT domain) at 64x32 forced banded card
     vs CPU to 1e-12; at 1024x512 under 'auto' (banded: dense would be
     4.3 GB) the Poisson phase's timings, launches and checks, all to
     1e-12; the complex kernel vs plain at its factor's operators in
     complex128 (1e-12) and complex64 (1e-5).
 14. rb3d_128 (benchmarks/progression.py config 5 on one card: 3-D
     Rayleigh-Benard, RealFourier^2 x ChebyshevT 128x128x64, RK222, dt =
     1e-3, through extras/bench_problems.py build_rb3d; 'auto' takes the
     banded path, q = 80): 16x16x32 forced banded card vs CPU (p, b, u to
     1e-12, the taus to 1e-12 of the state); build with its phases, the
     factor, RB3D_STEPS timed steps after the factoring first one,
     launches = 1 + 4 x (1 + RB3D_STEPS), no host sync in a steady step,
     peak memory, BCs and incompressibility to 1e-10; the kernel at this
     factor's operators (q = 80, f64, k = 1 and the Woodbury k = pins);
     the breakdown without a second factor.
 15. The complex128 IVP of build_complex_ivp (ComplexFourier x
     ChebyshevT, a b*b term, taus) at 1024x512 under 'auto' (banded, q =
     3): 32x16 forced banded card vs CPU to 1e-12, CIVP_STEPS timed steps,
     launches = 1 + 4 x (1 + CIVP_STEPS), no host sync, a finite state.
     Phases 3, 5, 6, 12 and 14 also take the same steps from the same
     state as a loop of step and as step_many, the step recorded once as
     a CUDA graph and replayed (core/stepgraph.py): the states must be
     bit-equal (else within 1e-13), the replayed block records nothing,
     the launches equal the loop's, no host sync in a replayed block;
     steps/s of both and the idle share of a step in each
     (extras/profile_step.py).
 16. The [fusion] and [precision] layers (plan_cells), run on the solvers
     of phases 3, 4, 6, 12 and 14 with no builds of their own: each cell puts
     the built solver under a plan resolved by the build's resolvers and
     installed by the solver's own _install_plan, the method its build
     calls (apply_plan), factors and takes the same timed steps
     from the same state; records steps/s, the factor store's bytes, the
     achieved residual of the ladder, solve ms, the kernel's launches
     (equal to the plan's count: none on ascan, spike, FUSED_SOLVE = off
     and dense; the bf16 ladder's as banded_subst_bf16), no host sync in
     a steady step, and the state against the default plan's (FUSED_SOLVE
     off and FUSED_TRANSFORMS on 1e-12, ascan/spike 1e-11, the f32 ladder
     1e-9, the bf16 ladder 1e-12 on the sphere and recorded only on RB,
     where its refinement does not converge in the JAX package either).
     The RB cells run at the main path's dt = 1e-3, where the f32 ladder
     is recorded only (its 2 sweeps do not reach 1e-9 there, in the JAX
     package either); the f32 ladder's 1e-9 is held in a cell of its own
     at LADDER_DT = 0.01 against the default plan at that dt.
     rb256x64: every plan kind, each non-default one but bf16 also as a
     replayed step_many (bit-equal), RHS ms and kernels per step with
     transforms on and off; rb2048x1024: transforms, the ladders, and
     ascan/spike where their reckoning fits under ASCAN_BUDGET_GB;
     shear512: the dense f32 ladder; sw512x256 (q = 7): ascan, spike and
     both ladders (ascan, spike and bf16 also replayed, bit-equal);
     rb3d_128 (phase 14): transforms off and on. The bf16
     kernel vs plain runs in phases 2 and 3.
 17. Gradients (DifferentiableIVP, core/adjoint.py): value_and_grad of
     sum |XT|^2 through the step loop, each solve's backward pass the
     transposed solve (on the sequential banded path the transposed
     kernel, banded_subst_T). Cells (gradient_cell): rb256x64 RK222 and
     SBDF2, 20 steps, K = 1 and ceil(sqrt n), each forward pass bit-equal
     to 20 solver.step calls from the same fresh state (end of phase 3);
     rb2048x1024, 10 steps, K = ceil(sqrt n), and K = 1 where its
     reckoned peak (the allocated store plus n + 1 steps of measured
     saved activations) fits 70 GB (end of phase 4); the sphere's
     sw512x256 2 steps native and under the bf16 ladder (the bf16
     transposed kernel; held to the native gradient within 1e-6 of
     max|g|; end of phase 12); the complex IVP 1024x512, 5 steps (end of
     phase 15); diffusion64 (dense: no kernel), 200 SBDF2 steps wrt the
     initial state, a and f (this phase). Each records the value-and-grad
     and forward seconds and their ratio, peak memory, host syncs (1:
     the health check) and the launches of the forward pass, the
     backward pass (the transposed kernel's, equal to the forward
     pass's) and the recompute (exactly K (L per_step - per_solve): each
     of the K segments of L steps runs again up to its last solve; 0 at
     K = 1); the loss equal to the forward pass's, every K's
     loss and gradients within 1e-14 and 1e-12 of the first's, and a
     central finite difference along a seeded direction per operand
     within 1e-5 (complex: Re sum(conj(g) v), torch's convention). The
     transposed kernel alone runs beside the solve's in phases 2 (the
     rb2048x1024 shapes: f64, f32, bf16), 3 (rb256x64), 12 (sw512x256,
     f64 and bf16: the bf16 gradient's shapes), 14 (rb3d_128) and 15
     (the complex IVP's operators, complex128): its error against substitution_transpose_plain,
     warm and cold ms, the solve kernel's ms on the same operators, the
     byte bound, torch.sum over the same bytes, and <S f, g> = <f, S^T g>
     to 1e-12 in f64.
 18. The polar geometry (dense: no kernel; each cell runs with the
     kernel's counts set to 0 just before and read just after, and they
     must stay 0, as the solve plan says): annulus256x64, the centrifugal
     convection of examples/centrifugal_convection.py through
     extras/bench_problems.py build_annulus_convection (AnnulusBasis
     256x64, RK222, G = 128, S = 526), and disk_libration32x128, the
     librating disk of examples/libration.py through build_disk_libration
     (DiskBasis 32x128, SBDF2, dt 1e-3, G = 16, S = 774). Each: a small
     run (32x16 annulus at dt 0.125, 16x32 disk) card vs CPU after 10
     steps, its determined fields to 1e-12 of the state; build with its
     phases, one dense factor, steps/s of a loop of fixed-dt
     steps, no host sync in a steady step, step_many bit-equal to the
     loop with no host sync in a replayed block (steps/s of both, the
     idle share and kernels per step of each; the example's flow
     property, a host read every 10 steps, is off for these runs), peak
     memory, a finite state, the boundary conditions and div(u) + tau_p
     within 1e-10. The annulus's fixed-dt steps run from rest at the
     CFL's initial dt (0.125); then ANNULUS_CFL_STEPS steps under the
     example's CFL (cadence 10: the host reads the velocity every 10
     steps), recording the dt sequence and the refactorizations (a fixed
     dt after the convection has grown outruns the CFL limit and
     diverges). The annulus's m = 0
     pencil is singular in the JAX package's own formulation (a pressure
     profile against the velocity taus): p and tau_u are determined only
     up to that null direction, so they are recorded, not compared. The
     disk's p and taus carry no time derivative and sit on pencils of
     condition ~1e6: card vs CPU they are held to 1e-10, u to 1e-12.
 19. The spherical shell. shell_convection96x48x6, dense (no kernel: its
     substitution counts must stay 0): the example
     examples/shell_convection.py through extras/bench_problems.py
     build_shell_convection (ShellBasis 96x48x6, SBDF2 at dt 0.05, one
     pencil per (m, ell): G = 2304, S = 78): card vs CPU at 16x8x6 after
     20 steps (every field to 1e-12 of the state), build with its phases,
     one dense factor, steps/s of a loop and of the replayed step_many
     block (bit-equal to the loop, no host sync in a steady step or a
     replayed block, idle share and kernels per step of each), peak
     memory, the floored-pivot count of the last factorization (its
     ell = 0 pencils apart), the boundary conditions and trace(grad_u) +
     tau_p (the constraint rows of L X) within 1e-12.
     rotconv64x32x32, the progression's rotating shell convection at its
     own size through build_rotconv (RK222 at dt 1e-4; the
     colatitude-varying cross(ez, u) couples ell, one pencil per m), the
     slice's main path through the kernels' large range: 'auto' takes the
     banded path, asserted with its structure (pencils (32, 10754), q =
     392 <= MAX_Q, NB = 28, 738 pins). Card vs CPU at 16x8x8 forced
     banded (q = 152, NB = 6, 186 pins) after 5 steps: u and T to 1e-12
     of the state; p and the taus, with no dt term on pencils of
     condition ~1e10, to ROTCONV_ALGEBRAIC_BOUND. Then build (host
     assembly and structure apart), the factor (its Woodbury solve one
     launch at k = 738), the first step and ROTCONV_STEPS timed steps
     (steps/s), the launches counted from 0 around them = 1 + 2 x 2 x
     (1 + ROTCONV_STEPS), no host sync in a steady step, the
     floored-pivot count, the velocity and temperature boundary
     conditions and trace(grad_u) + tau_p (the constraint rows of L X)
     within 1e-12, a finite state, peak memory; both kernels at
     this factor's own operators (k = 1) and the solve kernel at the
     Woodbury shape (the factor's one-hot E, k = 738: its ms is the
     Woodbury launch's, median of WOODBURY_REPS); the banded per-layer
     breakdown. The complex shell (dense): the coupled-NCC LBVP of
     tests/test_coupled_ncc.py on a complex128 shell card vs CPU to
     1e-12 (and within 1e-9 of the known solution), and the
     rotating-convection EVP of examples/rotating_convection.py at its
     full 28x64x64 through build_rotating_convection_evp (complex shell,
     stress-free): build s, the m = 13 group's eigensolve s (scipy on the
     host), the eigenvalue nearest 963.765 within EVP_BAR.
 20. The ball. ball_convection64x32x48, the example
     examples/internally_heated_convection.py at its own size through
     extras/bench_problems.py build_ball_convection (BallBasis 64x32x48,
     SBDF2 at dt 0.01, stress-free; the radial NCC r_vec*T keeps one
     pencil per (m, ell)), the slice's main path: 'auto' takes the banded
     path (dense would be 1.97 GB, above BANDED_CUTOFF_BYTES), asserted
     with its structure (pencils (1024, 490), q = 32, NB = 16, 42 pins,
     kl = 20, ku = 36; the first factorization finds the pinned base
     singular by its floored pivots, repairs the pins by one swap and
     factors again: SolverBase.factor_checked). Card vs CPU at
     16x8x12 forced banded (q = 32, NB = 5, 18 pins) after 10 steps:
     every field to 1e-12 of the state. Then build (host assembly and
     structure apart), the two factoring first steps (SBDF2 starts at
     first order; the first one repairs the pins) and BALL_STEPS
     timed steps (steps/s), the launches counted from 0 around them =
     (2 + 1 for the repair) + 2 x (2 + BALL_STEPS), no host sync in a
     steady step, step_many bit-equal to the loop (steps/s of both, no
     host sync in a replayed block, idle share and kernels per step of
     each), no floored pivot,
     u_r(r = 1), T(r = 1) and the shear stress (its boundary rows of
     L X; its grid value recorded) within 1e-10 of max|u| or max|T|,
     div(u) + tau_p (the constraint rows of L X) within 1e-12, a finite
     state, peak memory, then one factor of M + dt L timed alone; the
     kernel at this factor's own operators
     (k = 1) and at its Woodbury shape (the one-hot E, k = 42: its ms is
     the Woodbury launch's); the banded per-layer breakdown. Lane-Emden
     (examples/lane_emden.py through build_lane_emden, Nr = 64, n = 3,
     dense): Newton iterations to a perturbation norm of 1e-10, s per
     iteration, R = f(0)^((n-1)/2) within 1e-5 of Boyd's
     6.896848619376960. The complex ball (dense): an ell-coupled NCC LBVP
     on a complex128 ball card vs CPU to 1e-12 (and within 1e-9 of the
     known solution).
 21. Both kernels past q = 128 against their plain versions at random
     operators of LARGE_Q_SHAPES (q = 232 and 512) in f64, f32,
     complex128, complex64 and bf16 (each with its error, warm and cold
     ms, byte bound, torch.sum over the same bytes, plain ms).
 22. The cylinder (dense: no kernel; each cell runs with the kernel's
     counts set to 0 just before and read just after, and they must stay
     0). pipe_flow64x64x48, a periodic pipe through
     extras/bench_problems.py build_pipe_flow (DirectProduct(z, (phi,
     r)): RealFourier 64 x DiskBasis 64x48, R = 1, length 10, Re = 2000,
     dealias 3/2, RK222, the axial force 4 nu that holds w = 1 - r^2,
     from it plus a seeded 1e-3 perturbation), the slice's main path:
     'auto' tries the banded path and is refused (the band is too wide,
     as in the JAX package), so it is dense with pencils (1024, 784),
     asserted with the reason. Card vs CPU at 8x8x12 after 20 steps: u to
     1e-12 of the state, p and the taus to PIPE_ALGEBRAIC_BOUND. Then
     build (its phases, the dense store's GB, the host's RSS), the
     factoring first step and PIPE_STEPS steps at the example's CFL
     (safety 0.4, cadence 10, max_dt 5e-3), no host sync in a steady
     step, steps/s, step_many bit-equal to the loop over PIPE_BLOCK steps
     (steps/s of both, no host sync in a replayed block, idle share,
     kernels per step and the TRSM kernels' share of each), no slip
     within 1e-10 of max|u|, div(u) + tau_p and |integ(p)| within 1e-10,
     the mean axial velocity within 1% of the laminar 1/2, the own peak
     under 80 GB, one factor timed alone, the dense breakdown.
     examples/cylinder_diffusion.py at its 16x16x32 (200 RK443 steps at
     2e-4, the exact decay within 1e-6); the Poisson LBVP in a
     cylindrical annulus (f64 and complex128) card vs CPU to 1e-12 and
     within 1e-10 of the exact solution; examples/pipe_flow.py at Nr = 64
     (the m = 1 eigensolve on the host, the mode nearest -0.0227050 -
     0.9514810i within 1e-4).
 23. The ensemble fleets (core/ensemble.py, EnsembleSolver: the step
     body vmapped over a member axis, a block recorded as one CUDA graph
     of a fleet step): the two cells of the JAX package's
     benchmarks/ensemble.py through extras/bench_problems.py.
     rb256x64_ensemble (build_rb_ensemble: RK222, f64, banded, G = 128, q
     = 32, NB = 17, dt 0.01) at N = 1, 8, 64 and 256 (256 where its
     peak, reckoned from N = 64's, fits FLEET_PEAK_BUDGET_GB);
     diffusion64_ensemble (build_diffusion_ensemble: SBDF2, dense, dt
     1e-3, blocks of 32) at N = 1, 64 and 256. Each: the template's
     build s, its serial step_many steps/s (the baseline of
     benchmarks/ensemble.py:96), then per N the member init s, the first
     block's s, member-steps/s over FLEET_TIMED_BLOCKS blocks after a warm
     one, the substitution launches a fleet step (asserted equal to the
     serial step's, 2 stages x (1 + sweeps) on the banded cell, 0 on the
     dense one, whatever N), host syncs in a steady block (0), idle share
     and kernels a fleet step (torch.profiler), own peak memory, one
     recording, and members 0 and N - 1 against their serial runs on the
     card (1e-12 relative; bit-equality recorded). On the banded cell
     also: the kernel against its plain version at the fleet's own factor
     operators with the 64 members as columns (warm and cold ms, the byte
     bound of the operators once plus 64 columns, torch.sum over the
     same bytes); per_member_dt at N = 8 with dts in [5e-3, 1e-2] (one
     launch per solve at G' = 8 G, the launches counted, members 0 and 7
     against their serial runs); a NaN written into member 3 (dropped
     at the next probe, frozen at its snapshot slot, the others equal to
     their serial runs), then a member detached and a fresh one attached
     at a block boundary (no new recording; the attached member equal to
     its serial run from the attach).
 24. The coupled pencils (coupled_phase). annulus_azncc256x64, the
     slice's main path: the azimuthally varying NCC w = 1 + 0.3 r cos(phi)
     of the JAX package's tests/test_polar_azimuthal_ncc.py:104 on the
     annulus of radii (0.7, 1.8), f64, dealias 2, through
     extras/bench_problems.py build_annulus_azncc; the NCC couples every
     m group, so 'auto' takes the banded path with one pencil group,
     asserted with its structure (pencils (1, 16896), q = 144, NB = 118,
     576 pins). The LBVP w*u - lap(u) = g against its manufactured u:
     build with its phases, the factor, POISSON_SOLVES warm solves
     (median ms), launches = 1 + (1 + sweeps) a solve, no host sync in a
     warm solve, own peak, the error <= AZNCC_BOUND; 64x32 forced banded
     card vs CPU (u 1e-12 of the state, the taus 1e-10). The IVP (RK222
     at dt 1e-3): build, the factoring first step and AZNCC_STEPS timed
     ones (launches asserted, no host sync), a factor timed alone,
     step_many bit-equal to the loop (steps/s, idle share and kernels a
     step of each), the walls within 1e-10 of max |u|, max |u| decaying,
     own peak; 64x32 forced banded card vs CPU after 10 steps. The kernel
     at the LBVP factor's operators (G = 1, q = 144, k = 1), its Woodbury
     form (k = 576) and the IVP factor's (k = 1). The disk (dense, counts
     0): the azimuthally varying NCC LBVP at 32x16 and the Poisson under
     matrix_coupling = [True, True] at 16x32, one pencil each, card vs
     CPU to 1e-12, within 1e-10 of the manufactured solution.
     poisson_rect120 (build_poisson_rect, two coupled axes, L singular by
     its four corner modes; BANDED_MAX_DIAGS = 768) forced banded, q =
     496, NB = 30, 480 pins: the same solve record, the floored pivots
     read, within 1e-8 of exact and of its dense run on the card; 48x48
     card vs CPU (u to 1e-12; the taus, determined only up to the corner
     modes, recorded); the kernel at its operators (k = 1) and its
     Woodbury form (k = 480). At both LBVP factors (annulus and
     rectangle) the kernel is also held to the plain versions' backward
     error through the pinned base (backward_witness). At 128x128 'auto'
     takes banded at q = 528 and the build must raise the kernel's limit
     error. joint_ncc64x32
     (build_joint_ncc, dense): card vs CPU to 1e-12, within 1e-10 of its
     target.
     Phases 1-24 run with the run-side layers off ([profiling]
     METRICS_DEFAULT and [health] HEALTH_DEFAULT set False here: a solver
     with both off runs what it ran before them).
 25. The run-side tools (runside_phase) at RB 2048x1024 (RK222, f64,
     banded, build_rb_solver through the public API) with both layers
     on: the health probe at cadence RUNSIDE_HEALTH_CADENCE, the phase
     sampler at RUNSIDE_SAMPLE_CADENCE with a JSONL sink in a temporary
     directory, every run a solver.evolve_resilient loop (snapshots every
     RUNSIDE_SNAPSHOT_CADENCE, the SDC sentinel every RUNSIDE_SDC_CADENCE)
     with the kernel's counts set to 0 around it and asserted equal to
     the solve plan's count for what it executed (every step taken,
     rewound ones and SDC re-executions included, x stages x (1 +
     sweeps), one Woodbury launch a factorization, one solve a phase
     sample): a clean run to RUNSIDE_CKPT_AT with an async sharded
     checkpoint there and on to RUNSIDE_CLEAN; a second solver, built
     fresh, resumes from that checkpoint and steps to RUNSIDE_CLEAN,
     bit-equal to the uninterrupted run; then, on the resumed solver, a
     NaN (one rewind at the DT_BACKOFF dt, the refactors of the backoff
     and of the cap's relaxation, a finite state), a flipped mantissa bit
     on a checked step (one detection, a rewind without backoff, bit-equal
     to a clean re-run of the same steps from the same snapshot), a
     SIGTERM after a periodic async checkpoint (a graceful stop and a
     final checkpoint), and the newest checkpoint corrupted (quarantined;
     the resume falls back to the periodic one, bit-equal); a FileHandler
     set written and read back where h5py imports, else the ImportError
     naming h5py; host reads of single steps (0 off the cadences, 1 on a
     probe step, 1 + 3 on a sample step); steps/s of a step loop with the
     layers on and off; the async checkpoint's stall per write and its
     bytes, the resume's, rewinds' and SDC checks' seconds (each refactor
     included), the own peak, and the format_phase_table lines.
     Then the kernels line (banded_subst, banded_subst_bf16,
     banded_subst_T, banded_subst_T_bf16, each launched on some path of
     this run), the card line, and the result line.

Each phase prints its seconds and one JSON record on its own line.

Detailed results also go to chiprun_out/chip_smoke.json.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the largest rate
# the card has for each type: FP64 on the tensor cores (67 TFLOP/s; 34
# outside them), FP32 outside the tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "complex128": 67e12,
              "complex64": 67e12, "bfloat16": 989e12}
# kernel vs plain: relative to max|plain| (summation order differs; f32
# against f64 on the RB 256x64 factor operators differs by ~5e-7); the
# complex types as their real parts; bf16 operators against the plain
# version's f32 solve of the same bf16 inputs
BOUND = {"float64": 1e-12, "float32": 1e-5, "complex128": 1e-12,
         "complex64": 1e-5, "bfloat16": 1e-5}
# bytes written between cold launches: more than the H100's 50 MB L2
FLUSH_BYTES = 64 * 2 ** 20
# operator stores up to this size are copied flat for the torch.sum
# yardstick (rb3d_128's 23.5 GB are summed per tensor instead)
STREAM_COPY_BYTES = 4 * 10 ** 9
# warm Poisson solves timed per run (the median is reported)
POISSON_SOLVES = 25
# the sphere phase: progression config 4's size, and the timed steps
# after the factoring first one
SW_SIZE = (512, 256)
SW_STEPS = 20
# 3-D Rayleigh-Benard (progression config 5, one card) and its timed
# steps after the factoring first one; the small size of its card vs CPU
# check
RB3D_SIZE = (128, 128, 64)
RB3D_STEPS = 10
RB3D_SMALL = (16, 16, 32)
# the complex IVP (build_complex_ivp) and its timed steps
CIVP_SIZE = (1024, 512)
CIVP_STEPS = 20
# the polar cells: the examples' (non-quick) sizes, their small card vs
# CPU sizes, and the steps of each run
ANNULUS_SIZE = (256, 64)
ANNULUS_SMALL = (32, 16)
ANNULUS_CFL_STEPS = 100
DISK_SIZE = (32, 128)
DISK_SMALL = (16, 32)
# fixed-dt steps of each polar cell: the annulus's, from rest at dt
# 0.125, end (with the replays and profiles) by iteration ~90, before the
# growing convection outruns that dt (the example's CFL halves it near
# iteration 90)
ANNULUS_STEPS = 20
DISK_STEPS = 40
# the annulus fields its pencils determine (p and tau_u: see phase 18)
ANNULUS_DETERMINED = ("b", "u", "tau_p", "tau_b1", "tau_b2")
DISK_ALGEBRAIC_BOUND = 1e-10
# the shell (phase 19): the example's size and timestep; the progression's
# rotating shell at its own size, banded under 'auto' (the structure
# asserted: the pencil shape, q, NB and the pins), and its small card vs
# CPU size forced banded
SHELL_SIZE = (96, 48, 6)
SHELL_SMALL = (16, 8, 6)
SHELL_STEPS = 20
ROTCONV_SIZE = (64, 32, 32)
ROTCONV_STRUCTURE = {"pencil_shape": [32, 10754], "q": 392, "NB": 28,
                     "pins": 738}
ROTCONV_SMALL = (16, 8, 8)
ROTCONV_SMALL_STRUCTURE = {"q": 152, "NB": 6, "pins": 186}
ROTCONV_STEPS = 10
# the complex shell (phase 19): the coupled-NCC LBVP of
# tests/test_coupled_ncc.py (card vs CPU), and the rotating-convection EVP
# of examples/rotating_convection.py at its full size, whose critical
# m = 13 eigenvalue must land within EVP_BAR of the target (the bar of
# tests/test_coupled_ncc.py::test_rotating_convection_evp_full)
EVP_SIZE = (28, 64, 64)
EVP_BAR = 0.05
# the kernels past q = 128 (phase 21): random operators at rotconv
# 32x16x16's shape (q = 232), at rotconv 64x32x32's (q = 392, NB = 28)
# and at the kernels' bound q = 512, in every dtype, both directions:
# (G, NB, q)
LARGE_Q_SHAPES = ((16, 13, 232), (32, 28, 392), (32, 6, 512))
# timed launches of a kernel check at the Woodbury shape (k = 738 columns
# a group: each launch re-streams the operators per column tile)
WOODBURY_REPS = 3
# rotconv's factor operators chain pencils of condition ~9.4e9: two plain
# versions (cuBLAS on the card, the CPU's BLAS) of the same substitution
# differ by more than 1e-12 of the solution. At those operators the
# kernel is held to this many times that difference, and never to more
# than ROTCONV_ALGEBRAIC_BOUND (the check fails outright where the two
# plain versions differ by more); to BOUND at random operators of the
# same shape
CONDITIONED_FACTOR = 10
# seeded draws of the operators' eps perturbation (backward_witness)
SENSITIVITY_TRIALS = 3
# rotconv's pencils have condition ~9.4e9: one solve of one system by
# two LU implementations differs by ~1e-12 of the solution
# (tests/test_torch_shell.py ROTCONV_ALGEBRAIC_BOUND). Card vs CPU after
# 5 RK222 steps holds the fields with a time derivative (u, T) to 1e-12
# of the state and the algebraic ones (p and the taus, no dt term) to
# 1e-9 (measured: p 1.16e-10, tau_u2 1.79e-11; NVIDIA H100 80GB HBM3,
# 700.00 W)
ROTCONV_DYNAMIC = ("u", "T")
ROTCONV_ALGEBRAIC_BOUND = 1e-9
# the ball (phase 20): examples/internally_heated_convection.py at its own
# size, banded under 'auto' (the structure asserted: the pencil shape, q,
# NB, the pins and the band), its timed steps after the two factoring
# first ones, and its small card vs CPU size forced banded; Lane-Emden
# (examples/lane_emden.py) at the example's Nr and n, to the example's
# tolerance
BALL_SIZE = (64, 32, 48)
BALL_STRUCTURE = {"pencil_shape": [1024, 490], "q": 32, "NB": 16,
                  "pins": 42, "kl": 20, "ku": 36}
BALL_SMALL = (16, 8, 12)
BALL_SMALL_STRUCTURE = {"q": 32, "NB": 5, "pins": 18}
BALL_STEPS = 20
LANE_EMDEN_NR = 64
LANE_EMDEN_N = 3.0
LANE_EMDEN_TOL = 1e-10
# phase 22, the cylinder: a periodic pipe (R = 1, length 10, Re = 2000;
# bench_problems.build_pipe_flow) at 64x64x48, dense under 'auto' (the
# banded attempt refused: the band is too wide, as in the JAX package);
# 20 CFL steps, then a step_many block of 10; card vs CPU at 8x8x12;
# examples/cylinder_diffusion.py at its own size and steps; the pipe-flow
# EVP of examples/pipe_flow.py at its Nr = 64
PIPE_SIZE = (64, 64, 48)
PIPE_PENCILS = [1024, 784]
PIPE_SMALL = (8, 8, 12)
PIPE_STEPS = 20
PIPE_BLOCK = 10
PIPE_ALGEBRAIC_BOUND = 1e-10
DIFFUSION_STEPS = 200
PIPE_EVP_NR = 64
# phase 23, the ensemble fleets of the JAX package's benchmarks/ensemble.py
# (bench_problems.build_rb_ensemble, build_diffusion_ensemble): members,
# dt and block size of each cell (warm blocks, then FLEET_TIMED_BLOCKS
# timed ones); rb256x64_ensemble's largest N runs only where its peak,
# reckoned from the N = 64 fleet's, fits FLEET_PEAK_BUDGET_GB
FLEET_RB_MEMBERS = (1, 8, 64, 256)
FLEET_RB_DT = 0.01
FLEET_RB_BLOCK = 10
FLEET_DIFF_MEMBERS = (1, 64, 256)
FLEET_DIFF_DT = 1e-3
FLEET_DIFF_BLOCK = 32
FLEET_TIMED_BLOCKS = 2
FLEET_PEAK_BUDGET_GB = 70.0
# the kernel held against its plain version at the fleet's own factor
# operators with the members as columns; the per-member-dt fleet and its
# dts; members against their serial runs on the card
FLEET_KERNEL_K = 64
FLEET_PMDT_MEMBERS = 8
FLEET_PMDT_DT_RANGE = (5e-3, 1e-2)
FLEET_RTOL = 1e-12
# phase 24, the coupled pencils: an m-coupled annulus (the azimuthally
# varying NCC w = 1 + 0.3 r cos(phi) of the JAX package's
# tests/test_polar_azimuthal_ncc.py:104) at the centrifugal-convection
# example's 256x64, banded under 'auto' with one pencil group (the
# structure asserted), as an LBVP against its manufactured solution and
# as an RK222 IVP at AZNCC_DT; its small card vs CPU size forced banded
AZNCC_SIZE = (256, 64)
AZNCC_STRUCTURE = {"pencil_shape": [1, 16896], "q": 144, "NB": 118,
                   "pins": 576}
AZNCC_SMALL = (64, 32)
AZNCC_STEPS = 20
AZNCC_BOUND = 1e-10          # the JAX test's manufactured-solution bound
# fields with no time derivative held card vs CPU at the algebraic bound
# the repo uses elsewhere (DISK_ALGEBRAIC_BOUND); u to 1e-12 of the state
AZNCC_DYNAMIC = ("u",)
# the disk's coupled pencils (dense): the azimuthally varying NCC LBVP and
# the Poisson under matrix_coupling, card vs CPU
DISK_AZNCC_SIZE = (32, 16)
DISK_COUPLED_SIZE = (16, 32)
# the Chebyshev^2 Poisson rectangle (two coupled axes, singular L: four
# corner modes) forced banded at RECT_N (q = 4 N + 16 = 496 <= MAX_Q), its
# dense run beside it; at RECT_LIMIT_N 'auto' takes banded at q = 528,
# past the kernel's limit, where the factor's first launch must raise
RECT_N = 120
RECT_STRUCTURE = {"q": 496, "NB": 30, "pins": 480}
RECT_LIMIT_N = 128
RECT_MAX_DIAGS = "768"
RECT_BOUND = 1e-8
# the joint f(x, z) NCC LBVP of the JAX package's tests/test_joint_ncc.py:70
JOINT_SIZE = (64, 32)
# phase 25, the run-side tools at RB 2048x1024 (RK222, f64, banded): the
# health probe's and the phase sampler's cadences, the snapshot and SDC
# cadences of the resilient loops, the clean run's checkpoint iteration
# and its end, the NaN's and the bit flip's schedules (the NaN lands
# after a step the sentinel does not check), and the steps of the layers
# on/off timing
RUNSIDE_SIZE = (2048, 1024)
RUNSIDE_DT = 1e-3
RUNSIDE_HEALTH_CADENCE = 5
RUNSIDE_SAMPLE_CADENCE = 10
RUNSIDE_SNAPSHOT_CADENCE = 10
RUNSIDE_SDC_CADENCE = 20
RUNSIDE_CKPT_AT = 20
RUNSIDE_CLEAN = 40
RUNSIDE_NAN_AFTER = 5       # steps into the chaos run
RUNSIDE_CHAOS_STEPS = 30
RUNSIDE_FLIP_STEPS = 10
RUNSIDE_STOP_CKPT_ITER = 5
RUNSIDE_SIGTERM_AFTER = 8
RUNSIDE_TIMED_STEPS = 20
AZNCC_LBVP = "annulus_azncc%dx%d lbvp" % AZNCC_SIZE
AZNCC_IVP = "annulus_azncc%dx%d ivp" % AZNCC_SIZE
RESULTS = {}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def log(*args):
    print(*args, flush=True)


def median_ms(fn, reps=25, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def cold_median_ms(fn, reps=10):
    """Median device time of fn, each run right after a write of
    FLUSH_BYTES of scratch, so the L2 holds none of fn's inputs."""
    import torch
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device="cuda")
    fn()
    times = []
    for rep in range(reps):
        scratch.fill_(float(rep))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def subst_cost(fsub, fp):
    """(bytes, flops) the substitution must move and do: each input read
    once, the output written once (f32 for bf16 inputs); 2 flops per
    operator word per column (8 real flops for a complex multiply-add)."""
    from dedalus_tpu_torch.core import fusedstep
    k = 1 if fp.ndim == 2 else fp.shape[1]
    words = fsub["FwdOp"].numel() + fsub["BwdOp"].numel() \
        + fsub["lastOp"].numel()
    out_item = torch_item(fusedstep.WORK_DTYPE.get(fp.dtype, fp.dtype))
    nbytes = (words + fp.numel()) * fp.element_size() + fp.numel() * out_item
    return nbytes, (8 if fp.is_complex() else 2) * words * k


def torch_item(dtype):
    import torch
    return torch.empty((), dtype=dtype).element_size()


def conditioned_bound(label, what, bound, gap, capped=True):
    """A kernel check's bound at ill-conditioned operators: the larger of
    `bound` and CONDITIONED_FACTOR x `gap` (the same check between two
    plain versions), at most ROTCONV_ALGEBRAIC_BOUND, failing where `gap`
    itself exceeds that cap; neither limit holds where not `capped`
    (there backward_witness holds the kernel to the plain versions'
    backward error, whatever the conditioning)."""
    if capped and not gap <= ROTCONV_ALGEBRAIC_BOUND:
        fail(f"kernel[{label}]: {what} differ by {gap:.3e} > "
             f"{ROTCONV_ALGEBRAIC_BOUND:g}")
    bound = max(bound, CONDITIONED_FACTOR * gap)
    return min(bound, ROTCONV_ALGEBRAIC_BOUND) if capped else bound


def backward_witness(label, base, fsub, fp, out, ref, ref_cpu):
    """The second witness at the operators of a factored pinned base
    `base` = (bands (G, nd, n_pad) of B~ in full-lattice band storage,
    kl, ku), which tells ill-conditioning from a kernel fault. For the
    kernel's solution and the plain version's on the card and on the
    CPU: the backward error, max over columns of |B~ y - f| / (|B~| |y|
    + |f|) (infinity norms; the residual through the band matvec on the
    card). A correct substitution leaves a residual as small as the
    plain versions' even where its solution moves far from theirs; a
    fault leaves a large one. And two readings of how far rounding moves
    the solution at these operators, relative to max |y|: the plain
    version's response to the operators times (1 + eps r), r standard
    normal (the largest of SENSITIVITY_TRIALS seeded draws; a different
    summation order rounds each product by about that much), and with k
    > 1 columns the plain version on the card one column at a time
    against it on all columns at once (the kernel tiles columns in its
    own order). Returns the record; fails where the kernel's backward
    error exceeds CONDITIONED_FACTOR x the larger plain one."""
    import torch
    from dedalus_tpu_torch.core.fusedstep import as_columns, \
        substitution_plain
    bands, kl, ku = base
    width = bands.shape[-1]
    norm = bands.abs().sum(1).amax(-1)[:, None]           # (G, 1)
    f = as_columns(fp)

    def backward(y):
        y = as_columns(y)
        yp = torch.nn.functional.pad(y, (kl, ku))
        r = -f
        for d in range(bands.shape[1]):
            r = r + bands[:, d, None, :] * yp[..., d:d + width]
        return float((r.abs().amax(-1) / (norm * y.abs().amax(-1)
                                          + f.abs().amax(-1))).max())

    rec = {"kernel": backward(out), "plain": backward(ref),
           "plain_cpu": backward(ref_cpu.to(fp.device))}
    gen = torch.Generator(device=fp.device).manual_seed(17)
    eps = torch.finfo(ref.dtype).eps
    moved = []
    for _ in range(SENSITIVITY_TRIALS):
        nudged = {k: v * (1 + eps * torch.randn(
            v.shape, generator=gen, device=v.device, dtype=v.dtype))
            for k, v in fsub.items()}
        moved.append(float((substitution_plain(nudged, fp) - ref).abs().max()
                           / ref.abs().max()))
        del nudged
    rec["operator_sensitivity_rel"] = max(moved)
    if f.shape[1] > 1:
        cols = torch.stack([substitution_plain(fsub, f[:, j])
                            for j in range(f.shape[1])], dim=1)
        rec["plain_columns_vs_all_rel"] = float(
            (cols - as_columns(ref)).abs().max() / ref.abs().max())
        del cols
    rec["bound"] = CONDITIONED_FACTOR * max(rec["plain"], rec["plain_cpu"])
    if not rec["kernel"] <= rec["bound"]:
        fail(f"kernel[{label}]: backward error {rec['kernel']:.3e} > "
             f"{rec['bound']:.3e} ({CONDITIONED_FACTOR}x the plain "
             f"versions'): {rec}")
    return rec


def check_kernel(label, fsub, fp, transposed=False, reps=25,
                 conditioned=False, base=None):
    """Kernel vs plain on the same inputs; returns the measured record.
    The right-hand side is first scaled so that the plain solution has
    max |y| = 1 (the substitution is linear; the RB factor operators map
    a unit right-hand side to ~1e11), so the absolute error is in units
    of the solution's size; each time is the median of `reps` launches
    (cold: of fewer). With `transposed`, the transposed solve's
    kernel (banded_subst_T) against substitution_transpose_plain, timed
    beside the solve's kernel on the same operators, and the identity
    <S f, g> = <f, S^T g> through both kernels (bound 1e-12 in f64 and
    complex128). With `conditioned` (operators of an ill-conditioned
    factor, whose chain amplifies rounding beyond 1e-12 of the solution
    whatever the summation order), the plain version also runs on the
    CPU, and the kernel is held to the larger of BOUND and
    CONDITIONED_FACTOR times that plain-vs-plain difference, capped at
    ROTCONV_ALGEBRAIC_BOUND (as is the identity's bound); a
    plain-vs-plain difference above the cap fails. With `base` (the
    pinned base the operators factor, see backward_witness) as well, the
    kernel is held to its backward error, and its forward bound is
    CONDITIONED_FACTOR times the largest of the plain version's card vs
    CPU gap and backward_witness's two readings, uncapped."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    dtype = str(fp.dtype).replace("torch.", "")
    if transposed:
        kernel, plain = (fusedstep.substitution_transpose_cuda,
                         fusedstep.substitution_transpose_plain)
    else:
        kernel, plain = fusedstep.substitution_cuda, fusedstep.substitution_plain
    fp = (fp / plain(fsub, fp).abs().max()).to(fp.dtype)
    out = kernel(fsub, fp)
    ref = plain(fsub, fp)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"kernel[{label}] returned non-finite values")
    abs_err = float((out - ref).abs().max())
    rel_err = abs_err / float(ref.abs().max())
    bound, floor, witness = BOUND[dtype], None, None
    if conditioned:
        ref_cpu = plain({k: v.cpu() for k, v in fsub.items()}, fp.cpu())
        floor = float((ref.cpu() - ref_cpu).abs().max()
                      / ref_cpu.abs().max())
        gap = floor
        if base is not None:
            witness = backward_witness(label, base, fsub, fp, out, ref,
                                       ref_cpu)
            gap = max(gap, witness["operator_sensitivity_rel"],
                      witness.get("plain_columns_vs_all_rel", 0.0))
        del ref_cpu
        bound = conditioned_bound(label, "two plain versions", bound, gap,
                                  capped=base is None)
    if not rel_err <= bound:
        fail(f"kernel[{label}] disagrees with the plain version: max "
             f"relative error {rel_err:.3e} > {bound:.3e} (the plain "
             f"version on the card and on the CPU differ by {floor}; "
             f"witness {witness})")
    launch = lambda: kernel(fsub, fp)  # noqa: E731
    warm = min(3, reps)
    ms = median_ms(launch, reps=reps, warm=warm)
    cold_ms = cold_median_ms(launch, reps=min(10, reps))
    plain_ms = median_ms(lambda: plain(fsub, fp), reps=reps, warm=warm)
    # the read-bandwidth yardstick: one torch.sum over a flat copy of the
    # operator bytes (timed here only; the port never calls it); above
    # STREAM_COPY_BYTES, no copy: one torch.sum per operator tensor
    parts = [fsub[k].reshape(-1) for k in ("FwdOp", "BwdOp", "lastOp")]
    if sum(t.numel() * t.element_size() for t in parts) <= STREAM_COPY_BYTES:
        parts = [torch.cat(parts)]
    stream_ms = median_ms(lambda: [torch.sum(t) for t in parts], reps=reps,
                          warm=warm)
    del parts
    nbytes, flops = subst_cost(fsub, fp)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    G, q = fsub["lastOp"].shape[:2]
    NB = fsub["FwdOp"].shape[0] + 1
    k = 1 if fp.ndim == 2 else fp.shape[1]
    name = ("banded_subst_T" if transposed else "banded_subst") \
        + ("_bf16" if dtype == "bfloat16" else "")
    rec = {"shape": label, "kernel": name, "dtype": dtype, "G": G, "q": q,
           "NB": NB, "k": k,
           "max_abs_err": abs_err, "max_rel_err": rel_err,
           "bound_rel": bound, "plain_card_vs_cpu_rel": floor,
           "backward_error": witness,
           "ms": ms, "cold_ms": cold_ms,
           "stream_ms": stream_ms, "plain_ms": plain_ms,
           "bytes": nbytes, "flops": flops,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "plan": fusedstep.kernel_plan(G, k, NB, q, fp.dtype,
                                         transposed=transposed)}
    rec["share_of_bound"] = rec["bound_ms"] / ms
    if transposed:
        rec["forward_ms"] = median_ms(
            lambda: fusedstep.substitution_cuda(fsub, fp), reps=reps,
            warm=warm)
        f = torch.randn(fp.shape, generator=torch.Generator(
            device="cuda").manual_seed(11), device="cuda",
            dtype=torch.float64).to(fp.dtype)
        lhs = (fusedstep.substitution_cuda(fsub, f).double() * fp.double()
               if not fp.is_complex() else
               fusedstep.substitution_cuda(fsub, f) * fp).sum()
        rhs = (f.double() * out.double() if not fp.is_complex()
               else f * out).sum()
        rec["identity_rel"] = float((lhs - rhs).abs() / rhs.abs())
        ibound = 1e-12
        if conditioned:
            # the identity through the plain versions on the same inputs
            plhs = (fusedstep.substitution_plain(fsub, f) * fp).sum()
            prhs = (f * ref).sum()
            rec["identity_plain_rel"] = float((plhs - prhs).abs()
                                              / prhs.abs())
            ibound = conditioned_bound(
                label, "the identity through the plain versions", ibound,
                rec["identity_plain_rel"])
        if dtype in ("float64", "complex128") and \
                not rec["identity_rel"] <= ibound:
            fail(f"kernel[{label}] transposed: <S f, g> and <f, S^T g> "
                 f"differ by {rec['identity_rel']:.3e} > {ibound:.3e}")
    log(f"kernel[{label},{dtype}{',T' if transposed else ''}] "
        + json.dumps(rec))
    RESULTS.setdefault("kernel_checks", []).append(rec)
    return rec


def random_fsub(G, NB, q, dtype, seed, k=1):
    """Random substitution operators on the card, scaled so the sweeps
    neither grow nor decay fast, and a right-hand side of k columns per
    group."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, width):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float64).div_(2 * width ** 0.5).to(dtype)

    fsub = {"FwdOp": rnd((NB - 1, G, 4 * q * q), 2 * q),
            "BwdOp": rnd((NB - 1, G, 3 * q * q), 3 * q),
            "lastOp": rnd((G, q, q), q)}
    shape = (G, NB * q) if k == 1 else (G, k, NB * q)
    fp = torch.randn(shape, generator=gen, device="cuda",
                     dtype=torch.float64).to(dtype)
    return fsub, fp


def rb_checks(label, solver, b):
    """Finite state, boundary conditions and the incompressibility
    equation of an RB solver (2-D or 3-D, z last) on the card."""
    import torch
    import numpy as np
    import dedalus_tpu_torch.public as d3
    if not bool(torch.isfinite(solver.X).all()):
        fail(f"{label}: non-finite state")
    names = {v.name: v for v in solver.variables}
    u, tau_p, tau_u1 = names["u"], names["tau_p"], names["tau_u1"]
    errs = {
        "b(z=0)-Lz": float(np.max(np.abs(
            d3.Interpolate(b, "z", 0.0).evaluate()["g"] - 1.0))),
        "b(z=Lz)": float(np.max(np.abs(
            d3.Interpolate(b, "z", 1.0).evaluate()["g"]))),
        "u(z=0)": float(np.max(np.abs(
            d3.Interpolate(u, "z", 0.0).evaluate()["g"]))),
        "u(z=Lz)": float(np.max(np.abs(
            d3.Interpolate(u, "z", 1.0).evaluate()["g"]))),
    }
    ez = u.tensorsig[0].unit_vector_fields(u.dist)[-1]
    lift_basis = u.domain.bases[-1].derivative_basis(1)
    grad_u = d3.grad(u) + ez * d3.Lift(tau_u1, lift_basis, -1)
    resid = (d3.trace(grad_u) + tau_p).evaluate()["c"]
    errs["trace(grad_u)+tau_p (rel)"] = float(
        np.max(np.abs(resid)) / np.max(np.abs(u["c"])))
    log(f"{label} checks " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 1e-10}
    if bad:
        fail(f"{label}: checks out of bound 1e-10: {bad}")
    return errs


def breakdown(label, solver, dt, reps, factor=True):
    """Per-layer device times (median ms, CUDA events) of the pieces one
    step is made of, on the solver's current state: one stage's RHS
    evaluation and L matvec, one solve with its refinement sweep, one
    substitution kernel launch, the state scatter/gather, a dealiased
    transform roundtrip of the state, one factorization (unless `factor`
    is False: a second factor store would not fit beside the first), and
    one step."""
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.core.subsystems import gather_state, scatter_state
    ops, X = solver.ops, solver.X
    M, L = solver.M_mat, solver.L_mat
    aux = step_aux(solver)
    fp = X.new_ones((X.shape[0], ops.n_pad))
    layout, variables = solver.layout, solver.variables
    out = {
        "rhs_eval": median_ms(lambda: solver.eval_F(X, 0.0), reps=reps),
        "matvec_L": median_ms(lambda: ops.matvec(L, X), reps=reps),
        "solve_with_refinement": median_ms(
            lambda: ops.solve(aux, X, mats=(M, L)), reps=reps),
        "substitution_kernel": median_ms(
            lambda: fusedstep.substitution_cuda(aux["fsub"], fp), reps=reps),
        "scatter_gather": median_ms(lambda: gather_state(
            layout, variables, scatter_state(layout, variables, X)),
            reps=reps),
        "transform_roundtrip": median_ms(solver.enforce_hermitian_symmetry,
                                         reps=reps),
    }
    if factor:
        out["factor"] = median_ms(lambda: ops.factor_lincomb(
            1.0, M, dt * solver.timestepper.uniq_H_diag[0], L),
            reps=3, warm=1)
    out["step"] = median_ms(lambda: solver.step(dt), reps=reps, warm=1)
    log(f"breakdown {label} ms " + json.dumps(out))
    return out


def rel_diff(a, b):
    import numpy as np
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def card_vs_cpu(label, build, steps):
    """The same small run on the card and on the CPU (the CPU path is held
    against the JAX package by tests/test_torch_*.py): max relative
    difference of the states, failing above 1e-12."""
    xs = []
    for device in ("cuda", "cpu"):
        solver, dt = build(device)
        for _ in range(steps):
            solver.step(dt)
        xs.append(solver.X.cpu().numpy())
    err = rel_diff(xs[0], xs[1])
    log(f"{label} cuda vs cpu, {steps} steps: max relative difference "
        f"{err:.3e}")
    if not err <= 1e-12:
        fail(f"{label} on the card disagrees with the CPU run: {err:.3e}")
    return err


def steps_per_s(solver, dt, steps):
    """Steps per second over `steps` steps, closed by a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        solver.step(dt)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def host_syncs(run, reps=3):
    """Host synchronizations torch reports in `reps` calls of `run` (a
    steady step, a warm solve; torch.cuda.set_sync_debug_mode('warn')):
    count per call and the first messages."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(reps):
                run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    msgs = [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]
    return len(msgs) / reps, msgs[:3]


def check_no_host_syncs(label, rec, solver, dt):
    """Record the host synchronizations of steady steps; a step must
    queue its work without waiting for the card."""
    rec["host_syncs_per_step"], rec["host_sync_messages"] = \
        host_syncs(lambda: solver.step(dt))
    if rec["host_syncs_per_step"]:
        fail(f"{label}: {rec['host_syncs_per_step']} host synchronizations "
             f"per steady step: {rec['host_sync_messages']}")


def release():
    """Free the previous phase's solver: its fields and lazy pulls form
    reference cycles, which only the collector frees."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def dense_breakdown(label, solver, dt, reps, cfl=None):
    """Per-layer device times (median ms, CUDA events) of a dense-path
    step on the solver's current state: the RHS evaluation, the M/L
    matvec pair, one dense solve, one factorization, a dealiased transform
    roundtrip of the state, the CFL frequency (with its one host read)
    and one step."""
    ops, X = solver.ops, solver.X
    M, L = solver.M_mat, solver.L_mat
    aux = solver.timestepper._lhs_aux
    aux = aux[0] if isinstance(aux, list) else aux
    out = {
        "rhs_eval": median_ms(lambda: solver.eval_F(X, 0.0), reps=reps),
        "matvec_pair": median_ms(lambda: ops.matvec_pair(M, L, X),
                                 reps=reps),
        "dense_solve": median_ms(lambda: ops.solve(aux, X), reps=reps),
        "factor": median_ms(lambda: ops.factor_lincomb(1.0, M, dt, L),
                            reps=5, warm=1),
        "transform_roundtrip": median_ms(solver.enforce_hermitian_symmetry,
                                         reps=reps),
    }
    if cfl is not None:
        out["cfl"] = median_ms(cfl.compute_max_frequency, reps=reps)
    out["step"] = median_ms(lambda: solver.step(dt), reps=reps, warm=1)
    log(f"breakdown {label} ms " + json.dumps(out))
    return out


def poisson_checks(label, f, bound=1e-10):
    """Boundary conditions and the tau-corrected equation of a solved
    Poisson LBVP (build_poisson_solver or its complex twin): |u(y=0) - g|
    / max|g| <= 1e-12, |dy(u)(y=Ly)| / max|dy(u)| (h = 0), and the
    coefficients of lap(u) + lift(tau_1) + lift(tau_2) - f over max|f|,
    each <= `bound`."""
    import numpy as np
    import dedalus_tpu_torch.public as d3
    u, g, rhs = f["u"], f["g"], f["f"]
    ybasis = u.domain.bases[1]
    lift = lambda A, n: d3.Lift(A, ybasis.derivative_basis(2), n)  # noqa: E731
    dyu = d3.Differentiate(u, "y")
    Ly = ybasis.bounds[1]
    checks = {
        "u(y=0)-g / max|g|": float(
            np.max(np.abs(d3.Interpolate(u, "y", 0.0).evaluate()["g"]
                          - g["g"])) / np.max(np.abs(g["g"]))),
        "dy(u)(y=Ly) / max|dy(u)|": float(
            np.max(np.abs(d3.Interpolate(dyu, "y", Ly).evaluate()["g"]))
            / np.max(np.abs(dyu.evaluate()["g"]))),
        "lap(u)+taus-f / max|f| (coeff)": float(
            np.max(np.abs((d3.lap(u) + lift(f["tau_1"], -1)
                           + lift(f["tau_2"], -2) - rhs).evaluate()["c"]))
            / np.max(np.abs(rhs["c"]))),
    }
    bounds = {"u(y=0)-g / max|g|": 1e-12, "dy(u)(y=Ly) / max|dy(u)|": bound,
              "lap(u)+taus-f / max|f| (coeff)": bound}
    log(f"{label} checks " + json.dumps(checks))
    bad = {k: v for k, v in checks.items() if not v <= bounds[k]}
    if bad:
        fail(f"{label}: checks out of bound: {bad}")
    return checks


def solution_of(fields):
    """The solved variables' coefficients, flattened, on the host."""
    import numpy as np
    return np.concatenate([np.asarray(fields[k]["c"]).ravel()
                           for k in ("u", "tau_1", "tau_2")])


def timed_solves(solver, f, n):
    """n warm solves, f changed on the card before each: the median
    device time (CUDA events) and host wall time (to a synchronize) of
    one solve, in ms."""
    import torch
    rhs = f["f"]
    f0 = rhs.coeff_data().clone()
    ev_ms, wall_ms = [], []
    for i in range(n):
        rhs["c"] = f0 * (1 + 1e-3 * (i + 1))
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        solver.solve()
        e1.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(e0.elapsed_time(e1))
    rhs["c"] = f0
    return statistics.median(ev_ms), statistics.median(wall_ms)


def poisson_run(label, Nx, Ny, matsolver, dtype="float64"):
    """Build, factor (in the build), solve and check one Poisson LBVP on
    the card (complex128: the ComplexFourier carrier, checked to 1e-12
    throughout); time POISSON_SOLVES warm solves and a re-factor; count
    the kernel's launches from the build to the last timed solve.
    Returns (record, solver, fields)."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_poisson_solver
    torch.cuda.reset_peak_memory_stats()
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    solver, f = build_poisson_solver(Nx, Ny, matsolver=matsolver,
                                     device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    rec = {"size": f"{Nx}x{Ny}", "matsolver": matsolver,
           "dtype": str(solver.pencil_dtype),
           "build_s": time.perf_counter() - t0,
           "build_phases_s": dict(solver.build_seconds),
           "pencil_shape": list(solver.pencil_shape),
           "ops": solver.ops.kind}
    if solver.ops.kind == "banded":
        rec.update(q=solver.ops.q, NB=solver.ops.NB, pins=solver.ops.t,
                   kl=solver.ops.kl, ku=solver.ops.ku,
                   factor_chunks=solver._aux["factor_chunks"])
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    rec["first_solve_s"] = time.perf_counter() - t0
    rec["solve_ms"], rec["solve_wall_ms"] = timed_solves(solver, f,
                                                         POISSON_SOLVES)
    rec["warm_solves"] = POISSON_SOLVES
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    if solver.ops.kind == "banded":
        rec["expected_launches"] = (1 if solver.ops.t else 0) \
            + (1 + POISSON_SOLVES) * (1 + solver.ops.sweeps)
    else:
        rec["expected_launches"] = 0
    rec["host_syncs_per_solve"], rec["host_sync_messages"] = \
        host_syncs(solver.solve, 1)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    solver.ops.factor(solver.L_mat)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    rec["checks"] = poisson_checks(label, f, 1e-12 if dtype == "complex128"
                                   else 1e-10)
    log(f"{label} " + json.dumps(rec))
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']}")
    if rec["host_syncs_per_solve"]:
        fail(f"{label}: {rec['host_syncs_per_solve']} host synchronizations "
             f"in a warm solve(): {rec['host_sync_messages']}")
    return rec, solver, f


def poisson_card_vs_cpu(Nx, Ny, matsolver, dtype="float64"):
    """The same Poisson LBVP solved on the card and on the CPU (held
    against the JAX package by tests/test_torch_bvp.py): max relative
    difference of the solutions, failing above 1e-12."""
    from dedalus_tpu_torch.extras.bench_problems import build_poisson_solver
    out = []
    for device in ("cuda", "cpu"):
        solver, f = build_poisson_solver(Nx, Ny, matsolver=matsolver,
                                         device=device, dtype=dtype)
        solver.solve()
        out.append(solution_of(f))
    label = f"{dtype} poisson{Nx}x{Ny} {matsolver}"
    err = rel_diff(out[0], out[1])
    log(f"{label} cuda vs cpu: {err:.3e}")
    if not err <= 1e-12:
        fail(f"{label} on the card disagrees with the CPU: {err:.3e}")
    return err


def newton_run(solver, u, tol, max_iter=30):
    """Newton iterations to `tol` of the perturbation norm: per iteration
    the synced seconds, split into the host Jacobian assembly (the
    solver's build phases of that rebuild) and the factor + solve."""
    import torch
    its = []
    error = float("inf")
    while error > tol and solver.iteration < max_iter:
        if solver.dist.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.newton_iteration()
        error = solver.perturbation_norm()
        total = time.perf_counter() - t0
        host = solver.build_seconds["host_assembly"] \
            + solver.build_seconds["structure"]
        its.append({"s": total, "host_assembly_s": host,
                    "factor_solve_s": total - host,
                    "perturbation_norm": error})
    return its


def bratu_phase(N):
    """bratu256: Newton from u = 0 on the card to a perturbation norm
    below 1e-10 (iterations, seconds per iteration split host/device,
    error against the closed form); N = 32 card vs CPU; the sin-Jacobi
    NLBVP of the JAX package's tests at N = 64 against cos(x)."""
    import numpy as np
    from dedalus_tpu_torch.extras.bench_problems import (
        build_bratu_solver, bratu_exact, build_sin_jacobi_solver)
    finals = []
    for device in ("cuda", "cpu"):
        s, u, x = build_bratu_solver(32, device=device)
        its = newton_run(s, u, 1e-10)
        finals.append((len(its), np.asarray(u["g"])))
    rec = {"card_vs_cpu_bratu32_rel": rel_diff(finals[0][1], finals[1][1]),
           "card_vs_cpu_iterations": [finals[0][0], finals[1][0]]}
    t0 = time.perf_counter()
    solver, u, x = build_bratu_solver(N, device="cuda")
    rec["build_s"] = time.perf_counter() - t0
    rec["ops"] = solver.ops.kind
    rec["iterations"] = newton_run(solver, u, 1e-10)
    rec["n_iterations"] = len(rec["iterations"])
    rec["max_err_vs_closed_form"] = float(
        np.max(np.abs(np.asarray(u["g"]) - bratu_exact(x))))
    rec["residual_norm"] = float(solver.residual_norm())
    s, u, x = build_sin_jacobi_solver(64, device="cuda")
    its = newton_run(s, u, 1e-6)
    rec["sin_jacobi64"] = {
        "iterations": len(its),
        "max_err_vs_cos": float(np.max(np.abs(np.asarray(u["g"])
                                              - np.cos(x))))}
    log(f"bratu{N} " + json.dumps(rec))
    checks = [
        (rec["card_vs_cpu_bratu32_rel"] <= 1e-12
         and finals[0][0] == finals[1][0], "bratu32 card vs CPU"),
        (rec["n_iterations"] <= 8, "Newton iterations <= 8"),
        (rec["max_err_vs_closed_form"] <= 1e-10, "error vs closed form"),
        (rec["sin_jacobi64"]["max_err_vs_cos"] <= 1e-6, "sin-Jacobi vs cos"),
    ]
    bad = [name for ok, name in checks if not ok]
    if bad:
        fail(f"bratu{N}: {bad}")
    return rec


def rbevp_phase(Nz, kxs, NEV=10):
    """rbevp64: the RB onset EVP at Ra = 1700 and 1710 for each kx (build
    and eigensolve seconds, the peak growth rate, which must change sign
    across Ra_c = 1707.76); the fastest Ra = 1710 mode put on the card by
    set_state: finite, and no-slip at both walls."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.extras.bench_problems import build_rb_evp
    rec = {"Nz": Nz, "NEV": NEV, "kx": list(map(float, kxs)), "runs": {}}
    for Ra in (1700, 1710):
        runs = []
        for kx in kxs:
            t0 = time.perf_counter()
            solver, fields = build_rb_evp(Nz, kx, Ra, device="cuda")
            t1 = time.perf_counter()
            evals = solver.solve_sparse(
                solver.subproblems_by_group[(1, None)], NEV, target=0)
            runs.append({"kx": float(kx), "build_s": t1 - t0,
                         "eigensolve_s": time.perf_counter() - t1,
                         "growth_rate": float(np.max(evals.imag))})
        rec["runs"][str(Ra)] = runs
    peak = {Ra: max(r["growth_rate"] for r in rec["runs"][str(Ra)])
            for Ra in (1700, 1710)}
    rec["peak_growth_rate"] = {str(k): v for k, v in peak.items()}
    best = max(rec["runs"]["1710"], key=lambda r: r["growth_rate"])
    solver, fields = build_rb_evp(Nz, best["kx"], 1710, device="cuda")
    evals = solver.solve_sparse(solver.subproblems_by_group[(1, None)], NEV,
                                target=0)
    solver.set_state(int(np.argmax(evals.imag)))
    u = fields["u"]
    ug = u["g"]
    walls = max(float(np.max(np.abs(d3.Interpolate(u, "z", z).evaluate()
                                     ["g"]))) for z in (0.0, 1.0))
    rec["mode"] = {"kx": best["kx"], "finite": bool(np.isfinite(ug).all()),
                   "device": str(u.data.device),
                   "no_slip_rel": walls / float(np.max(np.abs(ug)))}
    log(f"rbevp{Nz} " + json.dumps(rec))
    if not (peak[1710] > 0 > peak[1700]):
        fail(f"rbevp{Nz}: peak growth rates {peak} do not change sign "
             "across Ra_c = 1707.76")
    if not (rec["mode"]["finite"] and rec["mode"]["no_slip_rel"] <= 1e-10):
        fail(f"rbevp{Nz}: the fastest mode {rec['mode']}")
    if u.data.device.type != "cuda":
        fail(f"rbevp{Nz}: set_state left the mode on {u.data.device}")
    torch.cuda.synchronize()
    return rec


def waves_phase(N):
    """waves128: the Legendre string EVP by solve_dense(left=True): the
    lowest 8 eigenvalues against (n pi)^2 (1e-8 relative) and the left
    eigenvectors biorthonormal against -M (1e-8)."""
    import numpy as np
    from dedalus_tpu_torch.extras.bench_problems import build_waves_evp
    t0 = time.perf_counter()
    solver, u = build_waves_evp(N, device="cuda")
    t1 = time.perf_counter()
    sp = solver.subproblems[0]
    evals = solver.solve_dense(sp, left=True)
    t2 = time.perf_counter()
    idx = np.argsort(np.abs(evals))[:8]
    exact = (np.arange(1, 9) * np.pi) ** 2
    M = solver._group_csr(sp)["M"].toarray()
    B = np.conj(solver.left_eigenvectors[:, idx]).T @ (-M) \
        @ solver.eigenvectors[:, idx]
    rec = {"N": N, "build_s": t1 - t0, "eigensolve_s": t2 - t1,
           "max_rel_err_8": float(np.max(np.abs(evals[idx] - exact)
                                         / exact)),
           "biorthonormality_err": float(np.max(np.abs(B - np.eye(8))))}
    solver.set_state(int(idx[0]))
    rec["mode_finite"] = bool(np.isfinite(u["g"]).all())
    log(f"waves{N} " + json.dumps(rec))
    if not (rec["max_rel_err_8"] <= 1e-8
            and rec["biorthonormality_err"] <= 1e-8 and rec["mode_finite"]):
        fail(f"waves{N}: {rec}")
    return rec


def kdv_phase(N, steps):
    """kdv1024: build, factorizations, steps/s, host syncs, breakdown and
    profile; mass conservation; KdV 64 card vs CPU."""
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.extras.bench_problems import build_kdv_solver
    from dedalus_tpu_torch.extras.profile_step import profile_solver
    rec = {"size": N, "steps": steps, "card_vs_cpu_kdv64_rel": card_vs_cpu(
        "kdv64", lambda device: build_kdv_solver(64, device=device), 50)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt = build_kdv_solver(N, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["ops"] = f"{solver.ops.kind} {solver.ops.solver_cls.__name__}"
    u = solver.variables[0]
    mass = lambda: float(d3.integ(u).evaluate()["g"].ravel()[0])  # noqa: E731
    mass0 = mass()
    t0 = time.perf_counter()
    for _ in range(10):
        solver.step(dt)
    torch.cuda.synchronize()
    rec["warm_10_steps_s"] = time.perf_counter() - t0
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    check_no_host_syncs(f"kdv{N}", rec, solver, dt)
    rec["factorizations"] = solver.timestepper.factorizations
    rec["step_many"] = step_many_check(f"kdv{N}", solver, dt, 80, 20)
    rec["mass_drift_rel"] = abs(mass() - mass0) / abs(mass0)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.isfinite(solver.X).all()):
        fail("kdv: non-finite state")
    if rec["factorizations"] != 2:
        fail(f"kdv: {rec['factorizations']} factorizations, SBDF2 at "
             "constant dt makes 2")
    if not rec["mass_drift_rel"] <= 1e-13:
        fail(f"kdv: mass drift {rec['mass_drift_rel']:.3e} > 1e-13")
    rec["breakdown_ms"] = dense_breakdown(f"kdv{N}", solver, dt, 20)
    rec["profile"] = profile_solver(solver, dt, steps=20, warm=2)
    return rec


def shear_phase(N, steps, cfl_steps):
    """shear512: build, factor, steps/s, host syncs, peak memory,
    breakdown and profile; incompressibility, gauge and tracer checks;
    shear 32x32 card vs CPU; a CFL-driven run with the example's
    settings."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.extras.bench_problems import build_shear_solver
    from dedalus_tpu_torch.extras.profile_step import profile_solver
    rec = {"size": N, "steps": steps,
           "card_vs_cpu_shear32_rel": card_vs_cpu(
               "shear32", lambda device: build_shear_solver(
                   32, device=device), 10)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt = build_shear_solver(N, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["ops"] = f"{solver.ops.kind} {solver.ops.solver_cls.__name__}"
    t0 = time.perf_counter()
    solver.timestepper._ensure_factor(dt)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    f = {v.name: v for v in solver.variables}
    u, s, p, tau_p = f["u"], f["s"], f["p"], f["tau_p"]
    integ = lambda e: float(d3.integ(e).evaluate()["g"].ravel()[0])  # noqa: E731
    # integ(s) sits near 0 for this initial condition: its drift is taken
    # relative to integ(|s|)
    s0, s_abs = integ(s), integ(np.abs(s))
    t0 = time.perf_counter()
    for _ in range(10):
        solver.step(dt)
    torch.cuda.synchronize()
    rec["warm_10_steps_s"] = time.perf_counter() - t0
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    check_no_host_syncs(f"shear{N}", rec, solver, dt)
    rec["step_many"] = step_many_check(f"shear{N}", solver, dt, 50, 10)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.isfinite(solver.X).all()):
        fail("shear: non-finite state")
    div = (d3.div(u) + tau_p).evaluate()["c"]
    grad = d3.grad(u).evaluate()["c"]
    checks = {"div(u)+tau_p / max|grad u|":
              float(np.max(np.abs(div)) / np.max(np.abs(grad))),
              "|integ(p)|": abs(integ(p)),
              "integ(s) drift / integ(|s|)": abs(integ(s) - s0) / s_abs}
    rec["checks"] = checks
    log(f"shear{N} checks " + json.dumps(checks))
    bounds = {"div(u)+tau_p / max|grad u|": 1e-10, "|integ(p)|": 1e-10,
              "integ(s) drift / integ(|s|)": 1e-12}
    bad = {k: v for k, v in checks.items() if not v <= bounds[k]}
    if bad:
        fail(f"shear{N}: checks out of bound: {bad}")
    cfl = d3.CFL(solver, initial_dt=1e-2, cadence=10, safety=0.2,
                 threshold=0.1, max_change=1.5, min_change=0.5, max_dt=1e-2)
    cfl.add_velocity(u)
    rec["breakdown_ms"] = dense_breakdown(f"shear{N}", solver, dt, 10, cfl)
    rec["profile"] = profile_solver(solver, dt, steps=10, warm=2)
    # phase 16's dense cell: the f32 ladder (the refined f32 inverse)
    rec["plans"] = plan_cells(
        f"shear{N}", solver, dt, 20,
        [("default", {}), ("f32", {"SOLVE_DTYPE": "f32"})],
        solve_ms=("default", "f32"), bounds={"f32": 1e-9})
    # the main loop of examples/shear_flow.py
    factorizations = solver.timestepper.factorizations
    t0 = time.perf_counter()
    for _ in range(cfl_steps):
        solver.step(cfl.compute_timestep())
    torch.cuda.synchronize()
    dts = [h["dt"] for h in cfl.history]
    rec["cfl"] = {"steps": cfl_steps, "dt": dts,
                  "refactorizations": solver.timestepper.factorizations
                  - factorizations,
                  "steps_per_s": cfl_steps / (time.perf_counter() - t0)}
    log(f"shear{N} CFL run " + json.dumps(rec["cfl"]))
    if not (bool(torch.isfinite(solver.X).all())
            and all(0 < dt <= 1e-2 for dt in dts)):
        fail(f"shear{N}: the CFL run gave a bad state or dt")
    return rec


def sw_balance_checks(label, solver, balance):
    """Re-solve the balanced-height LBVP (a warm solve on the card, timed)
    and check it: |ave(h)| <= 1e-13 max|h| and the tau-corrected residual
    L - F of its first equation <= 1e-10 max|F| (coefficients). Then put
    the IVP's state back (h = balanced + perturbation), so the steps start
    where the build left them."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.tools import carry
    X0 = solver.X.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    balance.solve()
    torch.cuda.synchronize()
    rec = {"balance_solve_s": time.perf_counter() - t0,
           "balance_pencil_shape": list(balance.pencil_shape),
           "balance_ops": balance.ops.kind,
           "balance_build_phases_s": dict(balance.build_seconds)}
    h = balance.variables[0]
    eq = balance.problem.equations[0]
    resid = (eq["L"] - eq["F"]).evaluate()["c"]
    checks = {
        "|ave(h)| / max|h|": float(
            np.abs(d3.ave(h).evaluate()["g"]).max() / np.abs(h["g"]).max()),
        "balance L-F / max|F| (coeff)": float(
            np.abs(resid).max() / np.abs(eq["F"].evaluate()["c"]).max()),
    }
    bounds = {"|ave(h)| / max|h|": 1e-13,
              "balance L-F / max|F| (coeff)": 1e-10}
    rec["checks"] = checks
    log(f"{label} balance checks " + json.dumps(checks))
    bad = {k: v for k, v in checks.items() if not v <= bounds[k]}
    if bad:
        fail(f"{label}: balance checks out of bound: {bad}")
    carry.install_state(solver, X0)
    return rec


def sw_phase(Nphi, Ntheta, steps):
    """sw512x256 (benchmarks/progression.py config 4 through the port's
    build_shallow_water: the Galewsky jet, balanced-height LBVP, then
    RK222 at dt = 300 s in simulation units, 'auto' -> banded): build,
    the balance checks, the factoring first step and `steps` timed
    steps, launches against 1 + 4 (1 + steps), host syncs, mass conservation, the vorticity
    through a DictionaryHandler, peak memory, the breakdown; the kernel
    and the transposed kernel (f64, and bf16: the bf16 gradient's
    shapes) at this factor's operators; sw64x32 forced banded card vs
    CPU. Returns the record and the f64 solve kernel's check."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_shallow_water
    from dedalus_tpu_torch.extras.profile_step import profile_solver
    rec = {"size": f"{Nphi}x{Ntheta}", "steps": steps,
           "card_vs_cpu_sw64x32_banded_rel": card_vs_cpu(
               "sw64x32 banded", lambda device: build_shallow_water(
                   64, 32, np.float64, matsolver="banded",
                   device=device)[:2], 10)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt, balance = build_shallow_water(Nphi, Ntheta, np.float64,
                                              device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["ops"] = solver.ops.kind
    if solver.ops.kind != "banded":
        fail(f"sw{Nphi}x{Ntheta} under 'auto' took the {solver.ops.kind} "
             "path")
    st = solver.structure
    rec.update(q=st.q, NB=st.NB, pins=st.t_pins, kl=st.kl, ku=st.ku,
               dense_GB=solver.pencil_shape[0] * solver.pencil_shape[1] ** 2
               * 8 / 1e9)
    log(f"sw{Nphi}x{Ntheta} build " + json.dumps(rec))
    rec.update(sw_balance_checks(f"sw{Nphi}x{Ntheta}", solver, balance))
    h = solver.variables[1]
    mass = lambda: float(d3.integ(h).evaluate()["g"].ravel()[0])  # noqa: E731
    mass0 = mass()
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    solver.step(dt)
    torch.cuda.synchronize()
    rec["first_step_s"] = time.perf_counter() - t0
    rec["factor_chunks"] = solver.timestepper._lhs_aux[0]["factor_chunks"]
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    rec["expected_launches"], _ = expected_launches(solver, 1 + steps,
                                                    factorizations=1)
    if rec["launches"] != rec["expected_launches"]:
        fail(f"sw{Nphi}x{Ntheta}: {rec['launches']} kernel launches, "
             f"expected {rec['expected_launches']}")
    check_no_host_syncs(f"sw{Nphi}x{Ntheta}", rec, solver, dt)
    rec["step_many"] = step_many_check(f"sw{Nphi}x{Ntheta}", solver, dt, 20,
                                       5)
    hmax = float(np.abs(h["g"]).max())
    rec["mass_drift / (4 pi max|h|)"] = abs(mass() - mass0) \
        / (4 * np.pi * hmax)
    if not bool(torch.isfinite(solver.X).all()):
        fail(f"sw{Nphi}x{Ntheta}: non-finite state")
    if not rec["mass_drift / (4 pi max|h|)"] <= 1e-12:
        fail(f"sw{Nphi}x{Ntheta}: mass drift "
             f"{rec['mass_drift / (4 pi max|h|)']:.3e} > 1e-12")
    # the example's snapshot tasks, through a DictionaryHandler
    u = solver.variables[0]
    handler = solver.evaluator.add_dictionary_handler(iter=1)
    handler.add_task(h, name="height")
    handler.add_task(-d3.div(d3.Skew(u)), name="vorticity")
    solver.step(dt)
    vort = np.asarray(handler["vorticity"])
    rec["vorticity_max"] = float(np.abs(vort).max())
    if vort.shape != (Nphi, Ntheta) or not np.isfinite(vort).all():
        fail(f"sw{Nphi}x{Ntheta}: bad vorticity task {vort.shape}")
    solver.evaluator.handlers.remove(handler)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"sw{Nphi}x{Ntheta} " + json.dumps(rec))
    rec["breakdown_ms"] = breakdown(f"sw{Nphi}x{Ntheta}", solver, dt, 5)
    rec["profile"] = profile_solver(solver, dt, steps=5, warm=1)
    log(f"sw{Nphi}x{Ntheta} profile " + json.dumps(rec["profile"]))
    fsub = {k: solver.timestepper._lhs_aux[0]["fsub"][k]
            for k in ("FwdOp", "BwdOp", "lastOp")}
    gen = torch.Generator(device="cuda").manual_seed(7)
    fp = torch.randn((fsub["lastOp"].shape[0], solver.ops.n_pad),
                     generator=gen, device="cuda", dtype=torch.float64)
    kernel = check_kernel(f"sw{Nphi}x{Ntheta}-factors", fsub, fp)
    rec["transposed_kernel"] = check_kernel(f"sw{Nphi}x{Ntheta}-factors",
                                            fsub, fp, transposed=True)
    # the bf16 transposed kernel at the shapes its main path (the bf16
    # gradient below) gives it: these operators cast to bf16
    rec["transposed_kernel_bf16"] = check_kernel(
        f"sw{Nphi}x{Ntheta}-factors",
        {k: v.bfloat16().contiguous() for k, v in fsub.items()},
        fp.bfloat16(), transposed=True)
    del fsub, fp
    # phase 16's cells on this solver: the compositions where the kernel
    # is latency-bound (q = 7), and the ladders (bf16 refines to the f64
    # class on the sphere: bound 1e-12)
    rec["plans"] = plan_cells(
        f"sw{Nphi}x{Ntheta}", solver, dt, 20,
        [("default", {}), ("ascan", {"SOLVE_COMPOSITION": "ascan"}),
         ("spike", {"SOLVE_COMPOSITION": "spike"}),
         ("f32", {"SOLVE_DTYPE": "f32"}), ("bf16", {"SOLVE_DTYPE": "bf16"})],
        step_many=("ascan", "spike", "bf16"),
        solve_ms=("default", "ascan", "spike", "f32", "bf16"),
        bounds={"ascan": 1e-11, "spike": 1e-11, "f32": 1e-9, "bf16": 1e-12})
    # the transposed kernel's bf16 path: a gradient under the bf16 ladder
    # (its solves and their transposes in bf16, refined in f64), held to
    # the default plan's gradient at the same state
    label = f"sw{Nphi}x{Ntheta}"
    _, g_native = gradient_cell(f"{label} native", solver, dt, 2, (1,),
                                fd=False)
    apply_plan(solver, SOLVE_DTYPE="bf16")
    solver.timestepper._ensure_factor(dt)
    gradient_cell(f"{label} bf16", solver, dt, 2, (1,), fd=False,
                  against=(1e-6, g_native))
    del g_native
    apply_plan(solver)
    solver.timestepper._ensure_factor(dt)
    return rec, kernel


def complex_phase(Nx, Ny):
    """Complex banded solves (the complex kernel): the complex128 Poisson
    (ComplexFourier x ChebyshevT) at 64x32 forced banded, card vs CPU; at Nx x Ny under 'auto' (banded above the 1 GiB cutoff) with the
    Poisson checks at 1e-12; the kernel vs plain at its factor's
    operators in complex128 and complex64."""
    import torch
    rec = {"card_vs_cpu_64x32_banded_rel": poisson_card_vs_cpu(
        64, 32, "banded", "complex128")}
    run, solver, f = poisson_run(f"complex poisson{Nx}x{Ny}", Nx, Ny, None,
                                 "complex128")
    if run["ops"] != "banded":
        fail(f"complex poisson{Nx}x{Ny} under 'auto' took the {run['ops']} "
             "path")
    run["dense_GB"] = run["pencil_shape"][0] * run["pencil_shape"][1] ** 2 \
        * 16 / 1e9
    rec.update(run)
    fsub = {k: solver._aux["fsub"][k] for k in ("FwdOp", "BwdOp", "lastOp")}
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = (fsub["lastOp"].shape[0], solver.ops.n_pad)
    fp = torch.complex(
        torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64),
        torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64))
    kernels = [check_kernel(f"complex-poisson{Nx}x{Ny}-factors", fsub, fp),
               check_kernel(f"complex-poisson{Nx}x{Ny}-factors",
                            {k: v.to(torch.complex64).contiguous()
                             for k, v in fsub.items()},
                            fp.to(torch.complex64))]
    return rec, kernels


HISTORIES = ("F_hist", "MX_hist", "LX_hist")


def snapshot(solver):
    """The solver's stepping state on the card (state, time, counters,
    the multistep histories), to take the same steps twice."""
    ts = solver.timestepper
    return {"X": solver.X.clone(), "sim_time": solver.sim_time,
            "iteration": solver.iteration, "ts_iteration": ts.iteration,
            "dt_hist": list(getattr(ts, "dt_hist", [])),
            "hists": [h.clone() for name in HISTORIES
                      for h in getattr(ts, name, [])]}


def restore(solver, snap):
    """Put a snapshot back, the histories into their own buffers."""
    ts = solver.timestepper
    solver.X = snap["X"].clone()
    solver.defer_scatter(solver.X)
    solver.snapshot_versions()
    solver.sim_time = snap["sim_time"]
    solver.iteration = snap["iteration"]
    ts.iteration = snap["ts_iteration"]
    if hasattr(ts, "dt_hist"):
        ts.dt_hist = list(snap["dt_hist"])
    live = [h for name in HISTORIES for h in getattr(ts, name, [])]
    for h, saved in zip(live, snap["hists"]):
        h.copy_(saved)


def reset_launches():
    from dedalus_tpu_torch.core import fusedstep
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0


def dense_path(path, run):
    """Run a path that takes the dense solve with the substitution
    kernel's count set to 0 just before it; record the count read just
    after, which must stay 0."""
    from dedalus_tpu_torch.core import fusedstep
    reset_launches()
    rec = run()
    n = sum(fusedstep.LAUNCHES.values())
    RESULTS.setdefault("dense_path_launches", {})[path] = n
    if n:
        fail(f"the dense {path} path launched the banded kernel {n} times")
    return rec


def step_many_check(label, solver, dt, n, prof_steps):
    """The same n steps from the same state as a loop of step and as
    step_many (the step recorded as a CUDA graph and replayed): the
    states must be bit-equal, else within 1e-13 relative; the block runs
    twice, the second time replaying the recording of the first (it must
    record nothing). Steps/s of the loop and of the replayed block, the
    recording block's seconds, the kernel's launches in each run (equal),
    host syncs of a replayed block (0), and the idle share of a step in a
    loop and in a block (torch.profiler, extras/profile_step.py). The
    window must not reach an iteration where either run re-projects."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.profile_step import profile_solver
    ts = solver.timestepper
    cadence = solver.enforce_real_cadence
    r = solver.iteration % cadence if cadence else 0
    if cadence and (r < ts.steps or cadence - r < n):
        fail(f"{label} step_many: iterations {solver.iteration}.."
             f"{solver.iteration + n} reach the re-projection cadence")
    snap = snapshot(solver)
    runs = {}
    for run in ("loop", "record", "replay"):
        if run != "loop":
            restore(solver, snap)
        recordings = ts.recordings
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "loop":
            for _ in range(n):
                solver.step(dt)
        else:
            solver.step_many(n, dt)
        torch.cuda.synchronize()
        runs[run] = {"s": time.perf_counter() - t0,
                     "launches": sum(fusedstep.LAUNCHES.values()),
                     "recordings": ts.recordings - recordings,
                     "X": solver.X.clone()}
    ref = runs["loop"]["X"]
    rec = {"steps": n, "start_iteration": snap["iteration"],
           "loop_steps_per_s": n / runs["loop"]["s"],
           "block_steps_per_s": n / runs["replay"]["s"],
           "record_block_s": runs["record"]["s"],
           "launches": {k: v["launches"] for k, v in runs.items()},
           "recordings": {k: v["recordings"] for k, v in runs.items()}}
    for run in ("record", "replay"):
        X = runs[run]["X"]
        rec[f"{run}_bit_equal"] = bool(torch.equal(X, ref))
        rec[f"{run}_max_rel_diff"] = float(
            (X - ref).abs().max() / ref.abs().max())
    rec["block_speedup"] = rec["block_steps_per_s"] / rec["loop_steps_per_s"]
    rec["host_syncs_per_block"], rec["host_sync_messages"] = host_syncs(
        lambda: solver.step_many(n, dt), 1)
    if prof_steps:
        rec["profile_loop"] = profile_solver(solver, dt, prof_steps, warm=1)
        rec["profile_block"] = profile_solver(solver, dt, prof_steps,
                                              warm=1, block=True)
    log(f"{label} step_many vs step " + json.dumps(rec))
    bad = []
    if rec["recordings"] != {"loop": 0, "record": 1, "replay": 0}:
        bad.append(f"recordings {rec['recordings']}")
    if len(set(rec["launches"].values())) != 1:
        bad.append(f"launches {rec['launches']}")
    for run in ("record", "replay"):
        if not rec[f"{run}_max_rel_diff"] <= 1e-13:
            bad.append(f"{run} differs from the loop by "
                       f"{rec[f'{run}_max_rel_diff']:.3e}")
    if rec["host_syncs_per_block"]:
        bad.append(f"host syncs {rec['host_sync_messages']}")
    if bad:
        fail(f"{label} step_many: {bad}")
    return rec


def rb3d_card_vs_cpu(sizes, steps):
    """3-D RB forced banded at a small size on the card and on the CPU
    (held against the JAX package by tests/test_torch_rb3d.py): p, b and
    u within 1e-12 relative each, the taus within 1e-12 of the largest
    state entry (a tau of the mean mode can sit at round-off level)."""
    import numpy as np
    from dedalus_tpu_torch.extras.bench_problems import build_rb3d
    out = {}
    for device in ("cuda", "cpu"):
        solver, dt = build_rb3d(*sizes, np.float64, matsolver="banded",
                                device=device)
        for _ in range(steps):
            solver.step(dt)
        out[device] = ({v.name: np.asarray(v["c"]) for v in solver.variables},
                       float(solver.X.abs().max()))
    scale = out["cpu"][1]
    errs = {}
    for name, ref in out["cpu"][0].items():
        diff = np.max(np.abs(out["cuda"][0][name] - ref))
        errs[name] = float(diff / (scale if name.startswith("tau")
                                   else np.max(np.abs(ref))))
    label = "rb3d " + "x".join(map(str, sizes))
    log(f"{label} cuda vs cpu, {steps} steps: " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 1e-12}
    if bad:
        fail(f"{label} on the card disagrees with the CPU run: {bad}")
    return errs


def rb3d_phase(sizes, steps):
    """rb3d_128 (benchmarks/progression.py config 5 on one card through
    the port's build_rb3d, 'auto' -> banded, q = 80): the small card vs
    CPU check; build with its phases, factor, the factoring first step
    and `steps` timed steps (steps/s), launches = 1 + 4 (1 + steps), host
    syncs, peak memory, BCs and incompressibility; the kernel at this
    factor's operators (k = 1 and the Woodbury k = pins, f64); step_many
    against the loop of step; the breakdown. Returns (record, the
    kernel's k = 1 record)."""
    import numpy as np
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_rb3d
    label = "rb3d_" + "x".join(map(str, sizes))
    rec = {"size": "x".join(map(str, sizes)), "steps": steps,
           "card_vs_cpu_" + "x".join(map(str, RB3D_SMALL)):
               rb3d_card_vs_cpu(RB3D_SMALL, 10)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt = build_rb3d(*sizes, np.float64, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["ops"] = solver.ops.kind
    if solver.ops.kind != "banded":
        fail(f"{label} under 'auto' took the {solver.ops.kind} path")
    st = solver.structure
    G, S = solver.pencil_shape
    rec.update(S=st.S, q=st.q, NB=st.NB, pins=st.t_pins, kl=st.kl, ku=st.ku,
               dense_GB=G * S * S * 8 / 1e9,
               after_build_GB=torch.cuda.memory_allocated() / 1e9)
    log(f"{label} build " + json.dumps(rec))
    reset_launches()
    t0 = time.perf_counter()
    solver.timestepper._ensure_factor(dt)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    rec["factor_chunks"] = solver.timestepper._lhs_aux[0]["factor_chunks"]
    rec["after_factor_GB"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    solver.step(dt)
    torch.cuda.synchronize()
    rec["first_step_s"] = time.perf_counter() - t0
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    rec["expected_launches"], _ = expected_launches(solver, 1 + steps,
                                                    factorizations=1)
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']}")
    check_no_host_syncs(label, rec, solver, dt)
    b = next(v for v in solver.variables if v.name == "b")
    rec["checks"] = rb_checks(label, solver, b)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label} " + json.dumps(rec))
    rec["step_many"] = step_many_check(label, solver, dt, 10, 3)
    aux = solver.timestepper._lhs_aux[0]
    fsub = {k: aux["fsub"][k] for k in ("FwdOp", "BwdOp", "lastOp")}
    gen = torch.Generator(device="cuda").manual_seed(11)
    fp = torch.randn((G, solver.ops.n_pad), generator=gen, device="cuda",
                     dtype=torch.float64)
    kernel = check_kernel(f"{label}-factors", fsub, fp)
    rec["transposed_kernel"] = check_kernel(f"{label}-factors", fsub, fp,
                                            transposed=True)
    fpw = torch.randn((G, solver.ops.t, solver.ops.n_pad), generator=gen,
                      device="cuda", dtype=torch.float64)
    rec["woodbury_kernel"] = check_kernel(f"{label}-factors-woodbury", fsub,
                                          fpw)
    del fp, fpw, aux, fsub
    rec["breakdown_ms"] = breakdown(label, solver, dt, 5, factor=False)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    # phase 16's 3-D cells: transform fusion off and on (the store is
    # freed before each refactor, so the peak stays the phase's own)
    rec["plans"] = plan_cells(
        label, solver, dt, 5,
        [("default", {}), ("transforms", {"FUSED_TRANSFORMS": "on"})],
        step_many=("default", "transforms"),
        profile=("default", "transforms"), rhs_ms=("default", "transforms"),
        bounds={"transforms": 1e-12})
    return rec, kernel


def complex_ivp_phase(Nx, Nz, steps):
    """The complex128 IVP of build_complex_ivp (ComplexFourier x
    ChebyshevT, b*b, taus): 32x16 forced banded card vs CPU (1e-12); at
    Nx x Nz under 'auto' (banded: dense would be 4.3 GB) the factoring
    first step and `steps` timed steps, launches = 1 + 4 (1 + steps),
    host syncs, a finite state, peak memory; the complex128 transposed
    kernel at this factor's operators; the gradient cell (5 steps)."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_complex_ivp
    label = f"complex ivp{Nx}x{Nz}"
    rec = {"size": f"{Nx}x{Nz}", "steps": steps,
           "card_vs_cpu_32x16_banded_rel": card_vs_cpu(
               "complex ivp32x16 banded", lambda device: build_complex_ivp(
                   32, 16, "banded", device=device), 10)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, dt = build_complex_ivp(Nx, Nz, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["dtype"] = str(solver.pencil_dtype)
    rec["ops"] = solver.ops.kind
    if solver.ops.kind != "banded":
        fail(f"{label} under 'auto' took the {solver.ops.kind} path")
    st = solver.structure
    G, S = solver.pencil_shape
    rec.update(q=st.q, NB=st.NB, pins=st.t_pins, kl=st.kl, ku=st.ku,
               dense_GB=G * S * S * 16 / 1e9)
    reset_launches()
    t0 = time.perf_counter()
    solver.step(dt)
    torch.cuda.synchronize()
    rec["first_step_s"] = time.perf_counter() - t0
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    rec["expected_launches"], _ = expected_launches(solver, 1 + steps,
                                                    factorizations=1)
    check_no_host_syncs(label, rec, solver, dt)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    rec["finite"] = bool(torch.isfinite(solver.X).all())
    log(f"{label} " + json.dumps(rec))
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']}")
    if not rec["finite"] or solver.X.dtype != torch.complex128:
        fail(f"{label}: a non-finite or non-complex128 state")
    # the complex128 kernels at this factor's operators (the transposed
    # one: the backward pass of the gradient below)
    fsub = {k: solver.timestepper._lhs_aux[0]["fsub"][k]
            for k in ("FwdOp", "BwdOp", "lastOp")}
    gen = torch.Generator(device="cuda").manual_seed(13)
    fp = torch.complex(*(torch.randn(
        (G, solver.ops.n_pad), generator=gen, device="cuda",
        dtype=torch.float64) for _ in range(2)))
    rec["transposed_kernel"] = check_kernel(f"{label}-factors", fsub, fp,
                                            transposed=True)
    del fsub, fp
    # gradients of a complex state through the complex kernels
    gradient_cell(label, solver, dt, 5, (1, None))
    return rec


# ------------------------------------------------ fusion and precision plans

FUSION_KEYS = ("FUSED_SOLVE", "FUSED_MATVEC", "FUSED_TRANSFORMS",
               "SOLVE_COMPOSITION", "SPIKE_CHUNKS")
PLAN_KEYS = FUSION_KEYS + ("SOLVE_DTYPE", "REFINE_SWEEPS", "REFINE_TOL",
                           "MMT_DTYPE")
# device memory the ascan composition may plan for at the real size
ASCAN_BUDGET_GB = 60.0
# the timestep of the RB cell that holds the f32 ladder to 1e-9: the JAX
# package's ladder regime (benchmarks/fusion.py steps RB at 0.01, where 2
# f32 sweeps hold 1e-9; at the main path's 1e-3 they do not, in the JAX
# package either: tests/test_torch_solvecomp.py reads both)
LADDER_DT = 0.01


def apply_plan(solver, **settings):
    """Put a built solver under a [fusion]/[precision] plan ({KEY: value};
    every other key auto), resolved by the build's own resolvers and
    installed by the solver (`_install_plan`: the ops and the RHS plan on
    its assembled M and L, so no host assembly runs again; the factor and
    the step recording are dropped). Returns the plan's settings."""
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.libraries import solvecomp
    from dedalus_tpu_torch.tools.config import config
    saved = {}
    for key in PLAN_KEYS:
        section = "fusion" if key in FUSION_KEYS else "precision"
        saved[(section, key)] = config[section].get(key, "auto")
        config[section][key] = settings.get(key, "auto")
    try:
        fusion = fusedstep.resolve_fusion()
        plan = solvecomp.resolve_solve_plan()
    finally:
        for (section, key), value in saved.items():
            config[section][key] = value
    solver._install_plan(fusion, plan)
    release()
    return dict(settings)


def aux_bytes(aux):
    """Device bytes of a factor's stored tensors (operators, Woodbury
    pieces), nested dicts included."""
    import torch
    if isinstance(aux, (list, tuple)):
        # an RK timestepper lists one aux per stage, shared between stages
        return sum(aux_bytes(a) for a in {id(a): a for a in aux}.values())
    if isinstance(aux, dict):
        return sum(aux_bytes(v) for k, v in aux.items() if k not in ("A", "ab"))
    if isinstance(aux, torch.Tensor):
        return aux.numel() * aux.element_size()
    return 0


def ascan_reckoning_GB(solver):
    """Device GB an ascan build and step of this banded solver needs: the
    f64 factor store (FwdOp, BwdOp, lastOp), the Woodbury pieces (Vt,
    YbT), M and L, and one solve's scratch at the factor's t Woodbury
    columns: the backward system's step-reversed copies (A (m, G, 2q, 2q),
    B and C (m, G, 2q, q) and (m, G, q, 2q), D (m, G, q, q)), the up-sweep
    compositions of both sweeps (about m blocks of q^2 and of 4 q^2), and
    the b vectors of the levels and prefixes (about 4 m of (G, 2q, t))."""
    ops = solver.ops
    G = solver.pencil_shape[0]
    m, q, t, item = ops.NB - 1, ops.q, max(ops.t, 1), 8
    store = G * (m * 7 * q * q + q * q) * item
    woodbury = 2 * G * t * ops.n_pad * item
    mats = sum(aux_bytes([A.bands, A.Vt]) for A in (solver.M_mat,
                                                     solver.L_mat)
               if A is not None)
    scratch = item * G * m * (4 + 2 + 2 + 1 + 1 + 4) * q * q \
        + item * G * m * 4 * 2 * q * t
    return (store + woodbury + mats + scratch) / 1e9


def spike_reckoning_GB(solver):
    """Device GB a spike build of this banded solver needs: the chunk
    operators of both sweeps (Y (C, G, L q, L q) each, with C chunks of L
    steps, and YH, P, T), and while they are built the f64 step operators
    they fold (FwdOp, BwdOp), the Woodbury pieces and M and L."""
    from dedalus_tpu_torch.libraries import solvecomp
    ops = solver.ops
    G = solver.pencil_shape[0]
    m, q, t, item = ops.NB - 1, ops.q, max(ops.t, 1), 8
    C = solvecomp.spike_chunk_count(m, 0)
    L = -(-m // C)
    # forward (state q) and backward (state 2q) chunk operators
    chunk = C * G * ((L * q) ** 2 + L * q * q + q * L * q + q * q) \
        + C * G * ((L * q) ** 2 + L * q * 2 * q + 2 * q * L * q + 4 * q * q)
    store = G * m * 7 * q * q
    mats = sum(aux_bytes([A.bands, A.Vt]) for A in (solver.M_mat,
                                                     solver.L_mat))
    return (item * (chunk + store + 2 * G * t * ops.n_pad) + mats) / 1e9


def plan_cells(label, solver, dt, steps, cells, step_many=(), solve_ms=(),
               profile=(), rhs_ms=(), bounds=None):
    """Run each cell (name, {KEY: value}) of a plan matrix on a built RB,
    shear or sphere solver (RK222) from the same state: the factor and
    `steps` timed steps, then the records the new phase reports. The
    first cell is the reference (the default plan); each later cell's
    state after the same steps is compared with it (`bounds`: name ->
    relative bound, or None where it is recorded only). The kernel's
    launches are counted from 0 around the factor and the steps and must
    equal the plan's count: one per factor (the Woodbury solve at native
    precision) and one per solve in the step's dtype on a sequential
    fused plan (the bf16 ones as banded_subst_bf16), none on ascan,
    spike, FUSED_SOLVE = off or dense paths. Steady steps must queue
    without a host sync. Cells in `step_many` also take the same steps as
    a replayed CUDA graph (bit-equal); `solve_ms` times one solve with
    its refinement; `profile` traces kernels per step; `rhs_ms` times
    one RHS evaluation. The solver ends under the default plan."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.profile_step import profile_solver
    bounds = bounds or {}
    snap = snapshot(solver)
    ts = solver.timestepper
    iteration = snap["iteration"]
    cadence = solver.enforce_real_cadence
    if cadence:
        # each cell starts just past a re-projection block, so its steps,
        # the sync probe and a step_many window stay clear of the next
        snap["iteration"] = (iteration // cadence + 1) * cadence + ts.steps
    out = {}
    x_ref = None
    for name, settings in cells:
        rec = {"plan": apply_plan(solver, **settings), "steps": steps}
        restore(solver, snap)
        reset_launches()
        fact0 = ts.factorizations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts._ensure_factor(dt)
        torch.cuda.synchronize()
        rec["factor_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(steps):
            solver.step(dt)
        torch.cuda.synchronize()
        rec["steps_per_s"] = steps / (time.perf_counter() - t0)
        X = solver.X.clone()
        launched = dict(fusedstep.LAUNCHES)
        ops = solver.ops
        factors = ts.factorizations - fact0
        solves = steps * ts.stages * (1 + getattr(ops, "sweeps", 0))
        expect = dict.fromkeys(fusedstep.LAUNCHES, 0)
        if ops.kind != "banded" or ops._composition != "sequential" \
                or not ops._fused_solve:
            pass
        elif solver._solve_plan.dtype == "bf16":
            expect.update(banded_subst=factors, banded_subst_bf16=solves)
        else:
            expect.update(banded_subst=factors + solves)
        rec.update(launches=launched, expected_launches=expect,
                   ops=ops.kind, composition=ops._composition,
                   solve_dtype=solver._solve_plan.dtype,
                   sweeps=getattr(ops, "sweeps", None),
                   factor_store_bytes=aux_bytes(ts._lhs_aux),
                   fused_nodes=len(solver._fused_eval_plan or ()))
        if launched != expect:
            fail(f"{label} plan {name}: kernel launches {launched} != the "
                 f"plan's {expect}")
        if solver._solve_plan.dtype != "native":
            rec["achieved_residual"] = \
                solver._precision_summary().get("achieved_residual")
        if x_ref is None:
            x_ref = X
        else:
            rec["max_rel_diff_vs_default"] = float(
                (X - x_ref).abs().max() / x_ref.abs().max())
            bound = bounds.get(name)
            rec["bound"] = bound
            if bound is not None and not \
                    rec["max_rel_diff_vs_default"] <= bound:
                fail(f"{label} plan {name}: state differs from the default "
                     f"plan's by {rec['max_rel_diff_vs_default']:.3e} > "
                     f"{bound:.0e}")
        if name in rhs_ms:
            rec["rhs_eval_ms"] = median_ms(lambda: solver.eval_F(X, 0.0),
                                           reps=10)
        if name in solve_ms:
            aux = ts._lhs_aux[0]
            rec["solve_ms"] = median_ms(lambda: ops.solve(
                aux, X, mats=(solver.M_mat, solver.L_mat)), reps=10)
        check_no_host_syncs(f"{label} plan {name}", rec, solver, dt)
        if name in step_many:
            rec["step_many"] = step_many_check(f"{label} plan {name}",
                                               solver, dt, 10, 0)
        if name in profile:
            rec["profile"] = profile_solver(solver, dt, 2, warm=1)
        log(f"{label} plan {name} " + json.dumps(rec))
        out[name] = rec
    # back to the default plan, the state and the iteration (a CFL's
    # cadence counts it) the cells started from
    apply_plan(solver)
    snap["iteration"] = iteration
    restore(solver, snap)
    ts._ensure_factor(dt)
    return out




# ------------------------------------------------------------ gradients

# the central finite difference of the gradient cells, and its bound
# (tests/test_adjoint.py:139)
GRAD_EPS = 1e-6
GRAD_FD_RTOL = 1e-5
# device memory a value_and_grad at K = 1 may plan for
GRAD_BUDGET_GB = 70.0
# the steps of the rb256x64 and diffusion64 gradient cells (rb2048x1024
# takes --real-steps)
GRAD_STEPS = 20
DIFFUSION_STEPS = 200


def sum_sq(X):
    """The gradient cells' loss: sum |XT|^2 over the final pencil state."""
    return (X.abs() ** 2).sum()


def saved_GB_per_step(solver, dt):
    """Device GB autograd keeps for the backward pass of one RK step of
    `solver` from its state (memory_allocated with the step's graph
    alive, less before): the per-step term of a K = 1 reckoning."""
    import torch
    ts = solver.timestepper
    ts._ensure_factor(dt)
    X0 = solver.X.detach().clone().requires_grad_()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with torch.enable_grad():
        X1 = ts.step_body(X0, float(solver.sim_time), dt, None,
                          ts._lhs_aux)
    torch.cuda.synchronize()
    out = (torch.cuda.memory_allocated() - before) / 1e9
    del X1, X0
    release()
    return out


def grad_reckoning_GB(solver, dt, n):
    """The K = 1 peak of an n-step value_and_grad, reckoned: what is
    allocated now (the factor store, its Woodbury pieces, M, L, the
    state) and n + 1 steps of saved activations (n kept for the backward
    pass, one step's transients of the backward pass itself)."""
    import torch
    per_step = saved_GB_per_step(solver, dt)
    now = torch.cuda.memory_allocated() / 1e9
    return {"allocated_GB": now, "saved_GB_per_step": per_step,
            "factor_store_GB": aux_bytes(solver.timestepper._lhs_aux) / 1e9,
            "K1_peak_GB": now + (n + 1) * per_step,
            "budget_GB": GRAD_BUDGET_GB}


def directional_fd(div, n, dt, X0, v, operand, base):
    """Central finite difference of the loss along v."""
    if operand == "initial_state":
        plus = div.value(n, dt, initial_state=X0 + GRAD_EPS * v)
        minus = div.value(n, dt, initial_state=X0 - GRAD_EPS * v)
    else:
        plus = div.value(n, dt, initial_state=X0,
                         fields={operand: base + GRAD_EPS * v})
        minus = div.value(n, dt, initial_state=X0,
                          fields={operand: base - GRAD_EPS * v})
    return (plus - minus) / (2 * GRAD_EPS)


def expected_recompute(solver, div, n, dt, forward):
    """The solve-kernel launches the checkpoint recompute of an n-step
    value_and_grad adds to a forward pass of `forward` launches: each of
    the K segments of L = n_scan // K steps (n_scan: the steps after a
    multistep ramp, which runs plain) runs again up to its last solve,
    whose backward pass keeps no tensor, so checkpoint stops before it:
    K (L per_step - per_solve), per_step = forward / n, per_solve =
    1 + sweeps; 0 at K = 1."""
    K = div.summary()["checkpoint_segments"]
    if K == 1:
        return 0
    ts = solver.timestepper
    n_scan = n - (len(ts.coefficient_schedule(dt, n)[0])
                  if hasattr(ts, "coefficient_schedule") else 0)
    return K * ((n_scan // K) * (forward // n) - (1 + solver.ops.sweeps))


def gradient_cell(label, solver, dt, n, segments, wrt=("initial_state",),
                  fd=True, reference=None, against=None):
    """value_and_grad of sum |XT|^2 over n steps of dt from the solver's
    state, once per checkpoint-segment count in `segments` (None: ceil
    sqrt n). Each run: a forward() pass (timed; launches counted), then
    value_and_grad (timed: its one host pull ends it; launches counted
    from 0 just before it and read just after; peak memory; host syncs
    under torch's sync debug mode, which must be 1: the health check).
    On a sequential banded solve the backward pass launches the
    transposed kernel exactly as often as the forward pass launched the
    solve's, and the recompute exactly expected_recompute's count of
    solve kernels (0 at K = 1). The loss equals the forward
    pass's bit for bit and every K gives the first run's loss (1e-14)
    and gradients (1e-12 of max|g|). With `fd`, a central finite
    difference along a seeded direction per operand within 1e-5 of
    Re sum(conj(g) v) (torch's gradient of a real loss of a complex
    operand is the conjugate of jax.grad's). `reference`: a state the
    forward pass must equal bit for bit (n solver.step calls from the
    same fresh state); `against`: gradients the first run's must be
    within (bound, grads) of, by max|g|."""
    import torch
    import warnings
    from dedalus_tpu_torch.core import fusedstep
    ops = solver.ops
    # the state a step would start from (the fields, where set since)
    X0 = (solver.gather_fields() if solver.fields_dirty()
          else solver.X).detach().clone()
    extras = dict(zip(solver.differentiable(loss=sum_sq).extra_names,
                      solver.rhs_extra()))
    rec = {"n": n, "dt": dt, "scheme": type(solver.timestepper).__name__,
           "wrt": list(wrt), "pencil_shape": list(solver.pencil_shape),
           "dtype": str(X0.dtype).replace("torch.", ""), "ops": ops.kind,
           "solve_dtype": solver._solve_plan.dtype, "card": RESULTS["card"],
           "conjugation": "torch: g = conj(jax.grad); d/de L(X0 + e v) = "
                          "Re sum(conj(g) v)" if X0.is_complex() else None,
           "runs": []}
    banded = ops.kind == "banded" and ops._composition == "sequential" \
        and ops._fused_solve
    low = "_bf16" if solver._solve_plan.dtype == "bf16" else ""
    first = None
    for K in segments:
        div = solver.differentiable(wrt=wrt, loss=sum_sq,
                                    checkpoint_segments=K)
        div.forward(n, dt, initial_state=X0)   # factors found, kernels warm
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd_loss, XT = div.forward(n, dt, initial_state=X0)
        fwd_s = time.perf_counter() - t0
        fwd_launches = dict(fusedstep.LAUNCHES)
        if reference is not None and first is None:
            rec["forward_bit_equal_to_steps"] = bool(torch.equal(XT,
                                                                 reference))
            if not rec["forward_bit_equal_to_steps"]:
                fail(f"{label}: the differentiable forward pass differs "
                     f"from {n} solver.step calls")
        del XT
        release()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 1e9
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                loss, grads = div.value_and_grad(n, dt, initial_state=X0)
                vg_s = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]
        launches = dict(fusedstep.LAUNCHES)
        run = {"K": div.summary()["checkpoint_segments"],
               "forward_s": fwd_s, "value_and_grad_s": vg_s,
               "grad_forward_ratio": vg_s / fwd_s,
               "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
               "allocated_before_GB": base, "loss": loss,
               "loss_equals_forward": loss == fwd_loss,
               "host_syncs": len(syncs), "host_sync_messages": syncs[:3],
               "launches_forward": fwd_launches,
               "launches_value_and_grad": launches}
        bad = []
        if not run["loss_equals_forward"]:
            bad.append(f"loss {loss!r} != forward {fwd_loss!r}")
        if len(syncs) != 1:
            bad.append(f"{len(syncs)} host syncs: {syncs[:3]}")
        if banded:
            F = fwd_launches["banded_subst" + low]
            T = launches["banded_subst_T" + low]
            R = launches["banded_subst" + low] - F
            E = expected_recompute(solver, div, n, dt, F)
            run.update(forward_launches=F, backward_launches=T,
                       recompute_launches=R, expected_recompute_launches=E)
            if F == 0 or T != F or R != E:
                bad.append(f"launches: forward {F}, backward {T}, "
                           f"recompute {R} (expected {E}) at "
                           f"K = {run['K']}")
        elif any(launches.values()) or any(fwd_launches.values()):
            bad.append(f"kernel launches on a non-kernel path {launches}")
        if first is None:
            first = (loss, grads)
            if against is not None:
                bound, ref = against
                run["vs_reference_rel"] = max(
                    float((grads[k] - ref[k]).abs().max()
                          / ref[k].abs().max()) for k in ref)
                if not run["vs_reference_rel"] <= bound:
                    bad.append(f"gradient {run['vs_reference_rel']:.3e} "
                               f"from the reference's > {bound:.0e}")
            if fd:
                gen = torch.Generator(device="cuda").manual_seed(7)
                run["fd"] = {}
                for operand, g in grads.items():
                    base_ = X0 if operand == "initial_state" \
                        else extras[operand]
                    v = torch.randn(base_.shape, generator=gen,
                                    device="cuda", dtype=torch.float64)
                    if base_.is_complex():
                        v = v + 1j * torch.randn(
                            base_.shape, generator=gen, device="cuda",
                            dtype=torch.float64)
                    v = v.to(base_.dtype)
                    fd_ = directional_fd(div, n, dt, X0, v, operand, base_)
                    an = float((g.conj() * v).real.sum())
                    err = abs(fd_ - an) / abs(an)
                    run["fd"][operand] = {"fd": fd_, "analytic": an,
                                          "rel": err}
                    if not err <= GRAD_FD_RTOL:
                        bad.append(f"{operand}: finite difference {fd_!r} "
                                   f"vs <g, v> {an!r} (rel {err:.3e})")
        else:
            run["loss_rel_vs_first"] = abs(loss - first[0]) / abs(first[0])
            run["grad_rel_vs_first"] = max(
                float((grads[k] - first[1][k]).abs().max()
                      / first[1][k].abs().max()) for k in grads)
            if not (run["loss_rel_vs_first"] <= 1e-14
                    and run["grad_rel_vs_first"] <= 1e-12):
                bad.append(f"K = {run['K']} changes the loss by "
                           f"{run['loss_rel_vs_first']:.3e} or the gradient "
                           f"by {run['grad_rel_vs_first']:.3e}")
        run["summary"] = div.summary()
        rec["runs"].append(run)
        log(f"{label} gradients K={run['K']} " + json.dumps(run))
        if bad:
            fail(f"{label} gradients: {bad}")
        del grads, div
        release()
    RESULTS.setdefault("gradients", {})[label] = rec
    return rec, first[1]


def polar_card_vs_cpu(label, build, steps, held, other_bound,
                      bound=1e-12):
    """The same small curvilinear run on the card and on the CPU: each
    field's max difference relative to the CPU state's largest entry
    (a field with no name by its index, var<i>). The fields in `held`
    (None: every field) must agree to `bound`, the others to
    `other_bound` (None: recorded only)."""
    import numpy as np
    runs = {}
    for device in ("cuda", "cpu"):
        solver, dt = build(device)
        for _ in range(steps):
            solver.step(dt)
        runs[device] = ({v.name or f"var{i}": np.array(v["c"])
                         for i, v in enumerate(solver.variables)},
                        float(np.abs(solver.X.cpu().numpy()).max()))
    (card, _), (cpu, scale) = runs["cuda"], runs["cpu"]
    errs = {name: float(np.max(np.abs(card[name] - cpu[name])) / scale)
            for name in cpu}
    log(f"{label} cuda vs cpu, {steps} steps: " + json.dumps(errs))
    bad = {k: v for k, v in errs.items()
           if not v <= (bound if held is None or k in held else
                        (np.inf if other_bound is None else other_bound))}
    if bad:
        fail(f"{label} on the card disagrees with the CPU run: {bad}")
    return errs


def constraint_residual(solver, eq_index=0):
    """max |L X| over the valid rows of equation `eq_index`: a constraint
    (no dt term) as the solver's own pencil matrices apply it."""
    from dedalus_tpu_torch.core.subsystems import _system_sizes
    _, eq_sizes, _ = _system_sizes(solver.layout, solver.equations,
                                   solver.variables)
    row0 = sum(eq_sizes[:eq_index])
    LX = solver.ops.matvec(solver.L_mat, solver.X) * solver._row_mask()
    return float(LX[:, row0:row0 + eq_sizes[eq_index]].abs().max())


def polar_checks(label, solver, bcs, bound=1e-10, constraint=None):
    """A finite state, the boundary conditions `bcs` ({name: (field,
    radius, value)}) and the incompressibility constraint, each within
    `bound` (absolute; their sizes relative to the field's largest value
    are recorded). The constraint is div(u) + tau_p on the grid, or with
    `constraint` = (name, equation index) that equation's rows of L X
    (the shell's first-order trace(grad_u) + tau_p, whose grid value
    carries the truncation of the rvec*lift(tau) product)."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    if not bool(torch.isfinite(solver.X).all()):
        fail(f"{label}: non-finite state")
    names = {v.name: v for v in solver.variables}
    u = names["u"]
    errs = {}
    for name, (field, r, value) in bcs.items():
        errs[name] = float(np.max(np.abs(
            np.array(field(r=r).evaluate()["g"]) - value)))
    if constraint is None:
        div = np.array((d3.div(u) + names["tau_p"]).evaluate()["g"])
        errs["div(u)+tau_p"] = float(np.max(np.abs(div)))
    else:
        errs[constraint[0]] = constraint_residual(solver, constraint[1])
    scale = {"u_max": float(np.max(np.abs(np.array(u["g"])))),
             "grad_u_max": float(np.max(np.abs(np.array(
                 d3.grad(u).evaluate()["g"]))))}
    log(f"{label} checks " + json.dumps({**errs, **scale}))
    bad = {k: v for k, v in errs.items() if not v <= bound}
    if bad:
        fail(f"{label}: checks out of bound {bound:g}: {bad}")
    return {**errs, **scale}


def polar_steps(rec, label, solver, dt, warm, steps, flow):
    """The fixed-dt part of a polar or shell cell: `warm` steps, then,
    without the example's flow-property handler (a host read every 10
    steps, read just before and put back after; `flow` None: none),
    steps/s over `steps`, no host sync in a steady step, the loop against
    the replayed block, peak memory."""
    import torch
    for _ in range(warm):
        solver.step(dt)
    torch.cuda.synchronize()
    if flow is not None:
        rec["flow_property_max"] = {
            task["name"]: float(flow.max(task["name"]))
            for task in flow.properties.tasks}
        solver.evaluator.handlers.remove(flow.properties)
    rec["dt"] = dt
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    check_no_host_syncs(label, rec, solver, dt)
    rec["step_many"] = step_many_check(label, solver, dt, steps, 10)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    if flow is not None:
        solver.evaluator.handlers.append(flow.properties)


def polar_build(rec, build, dt):
    """Build on the card through `build`, timing it and its phases, and
    one dense factorization of M + dt L; the pencil shape and the path
    (dense, as in the JAX package at these sizes)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold counts in the peak: recorded apart
    rec["allocated_before_build_GB"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    built = build()
    torch.cuda.synchronize()
    solver = built[0]
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec["pencil_shape"] = list(solver.pencil_shape)
    rec["ops"] = f"{solver.ops.kind} {solver.ops.solver_cls.__name__}"
    if solver.ops.kind != "dense":
        fail(f"{rec['cell']} took the {solver.ops.kind} path; the solve "
             "plan is dense at this size")
    t0 = time.perf_counter()
    solver.ops.factor_lincomb(1.0, solver.M_mat, dt, solver.L_mat)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    return built


def annulus_phase(size, cfl_steps, steps):
    """annulus256x64: centrifugal convection (phase 18). The fixed-dt
    part runs first, at the CFL's initial dt (0.125, where the example's
    CFL keeps it while the convection grows from rest); the example's
    CFL-driven loop follows."""
    import torch
    from dedalus_tpu_torch.extras.bench_problems import \
        build_annulus_convection
    label = f"annulus{size[0]}x{size[1]}"
    rec = {"cell": label, "size": list(size),
           "card_vs_cpu_rel": polar_card_vs_cpu(
               f"annulus{ANNULUS_SMALL[0]}x{ANNULUS_SMALL[1]}",
               lambda device: (build_annulus_convection(
                   *ANNULUS_SMALL, device=device)[0], 0.125), 10,
               ANNULUS_DETERMINED, None)}
    solver, cfl, flow = polar_build(
        rec, lambda: build_annulus_convection(*size, device="cuda"), 0.125)
    polar_steps(rec, label, solver, cfl.initial_dt, 3, steps, flow)
    # the example's main loop: the CFL reads the host every 10 steps
    factorizations = solver.timestepper.factorizations
    start = solver.iteration
    t0 = time.perf_counter()
    for _ in range(cfl_steps):
        solver.step(cfl.compute_timestep())
    torch.cuda.synchronize()
    dts = [h["dt"] for h in cfl.history if h["iteration"] >= start]
    rec["cfl"] = {"steps": cfl_steps, "start_iteration": start, "dt": dts,
                  "refactorizations": solver.timestepper.factorizations
                  - factorizations,
                  "steps_per_s": cfl_steps / (time.perf_counter() - t0),
                  "max_Re": float(flow.max("Re"))}
    log(f"{label} CFL run " + json.dumps(rec["cfl"]))
    if not (bool(torch.isfinite(solver.X).all())
            and all(0 < dt <= 0.125 for dt in dts)):
        fail(f"{label}: the CFL run gave a bad state or dt")
    rec["breakdown_ms"] = dense_breakdown(label, solver, dts[-1], 10, cfl)
    fields = {v.name: v for v in solver.variables}
    Ri, Ro = fields["b"].domain.bases[0].radii
    rec["checks"] = polar_checks(label, solver, {
        "u(r=Ri)": (fields["u"], Ri, 0.0), "u(r=Ro)": (fields["u"], Ro, 0.0),
        "b(r=Ri)": (fields["b"], Ri, 0.0), "b(r=Ro)-1": (fields["b"], Ro, 1.0)})
    rec["iteration"] = solver.iteration
    del solver, cfl, flow
    return rec


def disk_phase(size, steps):
    """disk_libration32x128: the librating disk (phase 18)."""
    import numpy as np
    from dedalus_tpu_torch.extras.bench_problems import build_disk_libration
    label = f"disk_libration{size[0]}x{size[1]}"
    rec = {"cell": label, "size": list(size),
           "card_vs_cpu_rel": polar_card_vs_cpu(
               f"disk_libration{DISK_SMALL[0]}x{DISK_SMALL[1]}",
               lambda device: build_disk_libration(
                   *DISK_SMALL, device=device)[:2], 10,
               ("u",), DISK_ALGEBRAIC_BOUND)}
    solver, dt, flow, t = polar_build(
        rec, lambda: build_disk_libration(*size, device="cuda"), 1e-3)
    polar_steps(rec, label, solver, dt, 10, steps, flow)
    rec["factorizations"] = solver.timestepper.factorizations
    u = {v.name: v for v in solver.variables}["u"]
    rec["checks"] = polar_checks(label, solver, {"u(r=1)": (u, 1.0, 0.0)})
    # the background is frozen at t = 0, as in the JAX package: the
    # problem keeps its own time field and the user's t stays 0
    rec["user_t"] = float(np.asarray(t["g"]).ravel()[0])
    if solver.problem.time is t or rec["user_t"] != 0.0:
        fail(f"{label}: the user's time field moved")
    rec["breakdown_ms"] = dense_breakdown(label, solver, dt, 10)
    rec["iteration"] = solver.iteration
    del solver, flow, t
    return rec


def floored_pivot_counts(solver):
    """The floored-pivot count of the solver's last factorization
    (Solver.floored_pivots, read here where the phase reads anyway): the
    total, the groups it marks, and the same over the ell = 0 pencils,
    the first place a singular shell pencil would appear."""
    counts = solver.floored_pivots.cpu()
    colat = solver.layout.sep_axes[1] if len(solver.layout.sep_axes) > 1 \
        else None
    groups = list(solver.layout.groups())
    ell0 = [i for i, g in enumerate(groups)
            if colat is not None and g[colat] == 0]
    out = {"total": int(counts.sum()), "groups": int((counts > 0).sum()),
           "ell0_groups": len(ell0),
           "ell0_total": int(counts[ell0].sum()) if ell0 else None}
    log("floored pivots " + json.dumps(out))
    return out


def shell_phase(size, steps):
    """shell_convection96x48x6: examples/shell_convection.py (phase 19)."""
    from dedalus_tpu_torch.extras.bench_problems import \
        build_shell_convection
    label = "shell_convection%dx%dx%d" % size
    rec = {"cell": label, "size": list(size),
           "card_vs_cpu_rel": polar_card_vs_cpu(
               "shell_convection%dx%dx%d" % SHELL_SMALL,
               lambda device: build_shell_convection(
                   *SHELL_SMALL, device=device)[:2], 20, None, None)}
    solver, dt, flow = polar_build(
        rec, lambda: build_shell_convection(*size, device="cuda"), 0.05)
    polar_steps(rec, label, solver, dt, 3, steps, flow)
    rec["floored_pivots"] = floored_pivot_counts(solver)
    rec["factorizations"] = solver.timestepper.factorizations
    fields = {v.name: v for v in solver.variables}
    Ri, Ro = fields["b"].domain.bases[0].radii
    rec["checks"] = polar_checks(label, solver, {
        "u(r=Ri)": (fields["u"], Ri, 0.0), "u(r=Ro)": (fields["u"], Ro, 0.0),
        "b(r=Ri)-1": (fields["b"], Ri, 1.0), "b(r=Ro)": (fields["b"], Ro, 0.0)},
        bound=1e-12, constraint=("trace(grad_u)+tau_p", 0))
    rec["breakdown_ms"] = dense_breakdown(label, solver, dt, 10)
    rec["iteration"] = solver.iteration
    del solver, flow
    return rec


def banded_rotconv(size, structure, device):
    """build_rotconv forced banded on `device`; fails unless its
    structure is `structure` (q, NB, pins)."""
    from dedalus_tpu_torch.extras.bench_problems import build_rotconv
    solver, dt = build_rotconv(*size, matsolver="banded", device=device)
    ops = solver.ops
    got = {"q": ops.q, "NB": ops.NB, "pins": ops.t}
    if ops.kind != "banded" or got != structure:
        fail(f"rotconv {size} forced banded: {ops.kind} path with {got}, "
             f"not {structure}")
    return solver, dt


def rotconv_phase(size, steps):
    """rotconv64x32x32: the progression's rotating shell convection at its
    own size, ell-coupled and banded (q = 392), the slice's main path
    through the kernels' large range (phase 19). Returns (record, the
    solve kernel's k = 1 record at this factor's operators)."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_rotconv
    label = "rotconv%dx%dx%d" % size
    if ROTCONV_STRUCTURE["q"] > fusedstep.MAX_Q:
        fail(f"{label}: q = {ROTCONV_STRUCTURE['q']} above the kernels' "
             f"MAX_Q = {fusedstep.MAX_Q}")
    small = "rotconv%dx%dx%d" % ROTCONV_SMALL
    rec = {"cell": label, "size": list(size), "steps": steps,
           "card_vs_cpu_rel": polar_card_vs_cpu(
               small + " banded",
               lambda device: banded_rotconv(
                   ROTCONV_SMALL, ROTCONV_SMALL_STRUCTURE, device),
               5, ROTCONV_DYNAMIC, ROTCONV_ALGEBRAIC_BOUND)}
    release()
    torch.cuda.reset_peak_memory_stats()
    rec["allocated_before_build_GB"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    solver, dt = build_rotconv(*size, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    ops, st = solver.ops, solver.structure
    rec.update(ops=ops.kind, pencil_shape=list(solver.pencil_shape),
               S=st.S, q=ops.q, NB=ops.NB, pins=ops.t, kl=st.kl, ku=st.ku,
               coupled_axes=sorted(solver.layout.forced_coupled),
               after_build_GB=torch.cuda.memory_allocated() / 1e9)
    log(f"{label} build " + json.dumps(rec))
    got = {k: rec[k] for k in ROTCONV_STRUCTURE}
    if ops.kind != "banded" or got != ROTCONV_STRUCTURE:
        fail(f"{label}: {ops.kind} path with {got}, not banded with "
             f"{ROTCONV_STRUCTURE}")
    if rec["coupled_axes"] != [1]:
        fail(f"{label}: the layout coupled {rec['coupled_axes']}, not ell")
    # the main path: the factor (its Woodbury solve, one launch) and the
    # steps, with the counts set to 0 just before and read just after
    reset_launches()
    t0 = time.perf_counter()
    solver.timestepper._ensure_factor(dt)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    rec["factor_chunks"] = solver.timestepper._lhs_aux[0]["factor_chunks"]
    rec["after_factor_GB"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    solver.step(dt)
    torch.cuda.synchronize()
    rec["first_step_s"] = time.perf_counter() - t0
    rec["dt"] = dt
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["launches"] = dict(fusedstep.LAUNCHES)
    rec["expected_launches"], _ = expected_launches(solver, 1 + steps,
                                                    factorizations=1)
    if rec["launches"]["banded_subst"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']} of banded_subst")
    check_no_host_syncs(label, rec, solver, dt)
    rec["floored_pivots"] = floored_pivot_counts(solver)
    fields = {v.name: v for v in solver.variables}
    Ri, Ro = fields["T"].domain.bases[0].radii
    rec["checks"] = polar_checks(label, solver, {
        "u(r=Ri)": (fields["u"], Ri, 0.0), "u(r=Ro)": (fields["u"], Ro, 0.0),
        "T(r=Ri)": (fields["T"], Ri, 0.0), "T(r=Ro)": (fields["T"], Ro, 0.0)},
        bound=1e-12, constraint=("trace(grad_u)+tau_p", 0))
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label} " + json.dumps(rec))
    # the kernels at this factor's own operators: k = 1 (the step's
    # solves) both directions, and the factor's Woodbury solve (its E:
    # one-hot columns at the 738 pins)
    aux = solver.timestepper._lhs_aux[0]
    fsub = {k: aux["fsub"][k] for k in ("FwdOp", "BwdOp", "lastOp")}
    G = solver.pencil_shape[0]
    gen = torch.Generator(device="cuda").manual_seed(19)
    fp = torch.randn((G, ops.n_pad), generator=gen, device="cuda",
                     dtype=torch.float64)
    kernel = check_kernel(f"{label}-factors", fsub, fp, conditioned=True)
    rec["transposed_kernel"] = check_kernel(f"{label}-factors", fsub, fp,
                                            transposed=True, conditioned=True)
    del fp
    E = torch.zeros((G, ops.t, ops.n_pad), dtype=torch.float64,
                    device="cuda")
    E[:, torch.arange(ops.t, device="cuda"), ops._pin_pos_t] = 1.0
    rec["woodbury_kernel"] = check_kernel(
        f"{label}-factors-woodbury", fsub, E, reps=WOODBURY_REPS,
        conditioned=True)
    rec["woodbury_ms"] = rec["woodbury_kernel"]["ms"]
    del E, aux, fsub
    release()
    # the Woodbury shape at random operators (held to BOUND)
    fsub, fp = random_fsub(G, ops.NB, ops.q, torch.float64, 23, k=ops.t)
    rec["woodbury_random_kernel"] = check_kernel(
        f"{label}-random-woodbury", fsub, fp, reps=WOODBURY_REPS)
    del fsub, fp
    release()
    rec["breakdown_ms"] = breakdown(label, solver, dt, 5, factor=False)
    # the peak with the kernel checks' inputs and outputs beside the
    # solver (the main path's own is max_memory_allocated_GB)
    rec["phase_max_memory_allocated_GB"] = \
        torch.cuda.max_memory_allocated() / 1e9
    rec["iteration"] = solver.iteration
    log(f"{label} " + json.dumps({k: rec[k] for k in (
        "build_s", "build_phases_s", "factor_s", "woodbury_ms",
        "steps_per_s", "pencil_shape", "q", "NB", "pins",
        "max_memory_allocated_GB", "host_syncs_per_step")}))
    del solver
    return rec, kernel


def complex_shell_lbvp(device):
    """The coupled-NCC LBVP of tests/test_coupled_ncc.py
    (test_lbvp_coupled_ncc_roundtrip) on a complex128 shell 8x8x6:
    (2 + cos(theta)(1 + r)/2) u = F for a known u. Returns (u
    coefficients, max grid error against the known u)."""
    import numpy as np
    import dedalus_tpu_torch.public as d3
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=np.complex128, device=device)
    shell = d3.ShellBasis(coords, shape=(8, 8, 6), radii=(0.6, 1.5),
                          dtype=np.complex128)
    phi, theta, r = dist.local_grids(shell)
    f = dist.Field(name="f", bases=shell.meridional_basis)
    f["g"] = 2.0 + 0.5 * np.cos(theta) * (1 + r)
    u = dist.Field(name="u", bases=shell)
    u_target = dist.Field(name="u_target", bases=shell)
    u_target["g"] = (np.cos(theta) * r
                     + np.sin(theta) * np.sin(phi) * (r - 1.0) ** 2)
    F = (f * u_target).evaluate()
    problem = d3.LBVP([u], namespace={"f": f, "u": u, "F": F})
    problem.add_equation("f*u = F")
    problem.build_solver().solve()
    err = float(np.abs(np.asarray(u["g"])
                       - np.asarray(u_target["g"])).max())
    return np.array(u["c"]), err


def complex_shell_phase(evp_size):
    """The complex shell (phase 19): the coupled-NCC LBVP card vs CPU
    (1e-12 of the solution, and within 1e-9 of the known u), and the
    rotating-convection EVP of examples/rotating_convection.py at
    `evp_size`: build s, the m = 13 group's eigensolve s (scipy on the
    host, as the port's EVP solves), its eigenvalue nearest the target
    within EVP_BAR."""
    import numpy as np
    from dedalus_tpu_torch.extras.bench_problems import \
        build_rotating_convection_evp
    card, card_err = complex_shell_lbvp("cuda")
    cpu, cpu_err = complex_shell_lbvp("cpu")
    rec = {"lbvp_card_vs_cpu_rel": rel_diff(card, cpu),
           "lbvp_error_vs_exact": [card_err, cpu_err]}
    log("complex shell lbvp " + json.dumps(rec))
    if not rec["lbvp_card_vs_cpu_rel"] <= 1e-12 or not card_err < 1e-9:
        fail(f"complex shell LBVP: {rec}")
    label = "rotating_convection_evp%dx%dx%d" % evp_size
    t0 = time.perf_counter()
    solver, target = build_rotating_convection_evp(*evp_size, device="cuda")
    evp = {"size": list(evp_size), "build_s": time.perf_counter() - t0,
           "pencil_shape": list(solver.pencil_shape), "target": target}
    sp = solver.subproblems_by_group[(13, None, None)]
    t0 = time.perf_counter()
    solver.solve_sparse(sp, 3, target)
    evp["eigensolve_s"] = time.perf_counter() - t0
    ev = complex(solver.eigenvalues[0])
    evp["eigenvalue"] = [ev.real, ev.imag]
    evp["distance"] = abs(ev - target)
    log(f"{label} " + json.dumps(evp))
    if not evp["distance"] < EVP_BAR:
        fail(f"{label}: m = 13 eigenvalue {ev} is {evp['distance']:.3g} "
             f"from {target}, above {EVP_BAR}")
    rec[label] = evp
    del solver
    return rec


def banded_ball(size, structure, device):
    """build_ball_convection forced banded on `device`; fails unless its
    structure is `structure` (q, NB, pins) and no pivot of its pinned base
    needs flooring after the first step."""
    from dedalus_tpu_torch.extras.bench_problems import \
        build_ball_convection
    solver, dt, _ = build_ball_convection(*size, matsolver="banded",
                                          device=device)
    ops = solver.ops
    got = {"q": ops.q, "NB": ops.NB, "pins": ops.t}
    if ops.kind != "banded" or got != structure:
        fail(f"ball {size} forced banded: {ops.kind} path with {got}, not "
             f"{structure}")
    return solver, dt


def ball_checks(label, solver):
    """A finite state, u_r(r = 1), T(r = 1) and the shear stress within
    1e-10 of max|u| or max|T| (tests/test_ball.py's bar), and div(u) +
    tau_p as the constraint rows of L X within 1e-12. The shear stress
    is held as its boundary rows of L X, as the pencils enforce it; its
    value on the grid is recorded. That grid value grows with the
    resolution (5e-13, 1.9e-11 and 6.6e-10 of max|u| at 16x8x12,
    32x16x24 and 64x32x48 after 30, 30 and ~60 steps, the boundary rows
    ~1e-18), and the JAX package's dense run gives the same one on the
    CPU (5.1e-13 and 2.0e-11 at the first two sizes;
    tests/test_torch_ball.py holds the two to 1e-12 of max|u|)."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    if not bool(torch.isfinite(solver.X).all()):
        fail(f"{label}: non-finite state")
    fields = {v.name: v for v in solver.variables}
    u, T = fields["u"], fields["T"]
    u_max = float(np.abs(np.array(u["g"])).max())
    T_max = float(np.abs(np.array(T["g"])).max())
    strain = d3.grad(u) + d3.trans(d3.grad(u))
    errs = {
        "u_r(r=1)/max|u|": float(np.abs(np.array(
            d3.radial(u(r=1)).evaluate()["g"])).max()) / u_max,
        "shear_stress rows of L X/max|u|": constraint_residual(solver, 3)
        / u_max,
        "T(r=1)/max|T|": float(np.abs(np.array(
            T(r=1).evaluate()["g"])).max()) / T_max}
    bad = {k: v for k, v in errs.items() if not v <= 1e-10}
    errs["shear_stress on the grid/max|u| (recorded)"] = float(np.abs(
        np.array(d3.angular(d3.radial(strain(r=1), index=1)).evaluate()[
            "g"])).max()) / u_max
    errs["div(u)+tau_p"] = constraint_residual(solver, 0)
    if not errs["div(u)+tau_p"] <= 1e-12:
        bad["div(u)+tau_p"] = errs["div(u)+tau_p"]
    errs.update(u_max=u_max, T_max=T_max)
    log(f"{label} checks " + json.dumps(errs))
    if bad:
        fail(f"{label}: checks out of bound: {bad}")
    return errs


def ball_phase(size, steps):
    """ball_convection64x32x48: examples/internally_heated_convection.py
    at its own size, banded under 'auto' (phase 20). Returns (record, the
    solve kernel's k = 1 record at this factor's operators)."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import \
        build_ball_convection
    label = "ball_convection%dx%dx%d" % size
    small = "ball_convection%dx%dx%d" % BALL_SMALL
    rec = {"cell": label, "size": list(size), "steps": steps,
           "card_vs_cpu_rel": polar_card_vs_cpu(
               small + " banded",
               lambda device: banded_ball(BALL_SMALL, BALL_SMALL_STRUCTURE,
                                          device),
               10, None, None)}
    release()
    torch.cuda.reset_peak_memory_stats()
    rec["allocated_before_build_GB"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    solver, dt, flow = build_ball_convection(*size, device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    ops, st = solver.ops, solver.structure
    rec.update(ops=ops.kind, pencil_shape=list(solver.pencil_shape),
               S=st.S, q=ops.q, NB=ops.NB, pins=ops.t, kl=st.kl, ku=st.ku,
               after_build_GB=torch.cuda.memory_allocated() / 1e9)
    log(f"{label} build " + json.dumps(rec))
    got = {k: rec[k] for k in BALL_STRUCTURE}
    if ops.kind != "banded" or got != BALL_STRUCTURE:
        fail(f"{label}: {ops.kind} path with {got}, not banded with "
             f"{BALL_STRUCTURE}")
    ts = solver.timestepper
    # the main path: the two factoring first steps (SBDF2 starts at first
    # order; the first one repairs the pins and factors again) and the
    # timed ones, the counts set to 0 just before and read just after;
    # the example's flow property (a host read every 10 steps) is off
    solver.evaluator.handlers.remove(flow.properties)
    reset_launches()
    t0 = time.perf_counter()
    solver.step(dt)
    solver.step(dt)
    torch.cuda.synchronize()
    rec["first_two_steps_s"] = time.perf_counter() - t0
    rec["dt"] = dt
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["launches"] = dict(fusedstep.LAUNCHES)
    rec["build_phases_s"] = dict(solver.build_seconds)
    ops, st = solver.ops, solver.structure
    rec["pin_swaps"] = st.pin_swaps
    rec["factorizations"] = ts.factorizations
    # each pin swap factors the first step's matrix once more
    rec["expected_launches"], _ = expected_launches(
        solver, 2 + steps, factorizations=ts.factorizations + st.pin_swaps)
    if ts.factorizations != 2:
        fail(f"{label}: {ts.factorizations} factorizations; SBDF2 at a "
             "constant dt makes 2")
    if rec["launches"]["banded_subst"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']} of banded_subst")
    check_no_host_syncs(label, rec, solver, dt)
    rec["step_many"] = step_many_check(label, solver, dt, steps, 10)
    if not rec["step_many"]["replay_bit_equal"]:
        fail(f"{label}: the replayed block is not bit-equal to the loop")
    rec["floored_pivots"] = floored_pivot_counts(solver)
    if rec["floored_pivots"]["total"]:
        fail(f"{label}: {rec['floored_pivots']} floored pivots")
    rec["checks"] = ball_checks(label, solver)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    # one factor of M + dt L timed alone, outside the counted window and
    # after the first step has repaired the pins (the structure's first
    # factorization is the solver's own, through factor_checked)
    t0 = time.perf_counter()
    aux = ops.factor_lincomb(1.0, solver.M_mat, dt, solver.L_mat)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    rec["factor_chunks"] = aux["factor_chunks"]
    del aux
    release()
    log(f"{label} " + json.dumps(rec))
    # the kernel at this factor's own operators: k = 1 (the step's
    # solves) and the factor's Woodbury solve (its E: one-hot columns at
    # the pins)
    aux = step_aux(solver)
    fsub = {k: aux["fsub"][k] for k in ("FwdOp", "BwdOp", "lastOp")}
    G = solver.pencil_shape[0]
    gen = torch.Generator(device="cuda").manual_seed(29)
    fp = torch.randn((G, ops.n_pad), generator=gen, device="cuda",
                     dtype=torch.float64)
    kernel = check_kernel(f"{label}-factors", fsub, fp, conditioned=True)
    del fp
    E = torch.zeros((G, ops.t, ops.n_pad), dtype=torch.float64,
                    device="cuda")
    E[:, torch.arange(ops.t, device="cuda"), ops._pin_pos_t] = 1.0
    rec["woodbury_kernel"] = check_kernel(
        f"{label}-factors-woodbury", fsub, E, conditioned=True)
    rec["woodbury_ms"] = rec["woodbury_kernel"]["ms"]
    del E, aux, fsub
    release()
    rec["breakdown_ms"] = breakdown(label, solver, dt, 10, factor=False)
    rec["phase_max_memory_allocated_GB"] = \
        torch.cuda.max_memory_allocated() / 1e9
    rec["iteration"] = solver.iteration
    log(f"{label} " + json.dumps({k: rec[k] for k in (
        "build_s", "build_phases_s", "factor_s", "woodbury_ms",
        "steps_per_s", "pencil_shape", "q", "NB", "pins", "pin_swaps",
        "max_memory_allocated_GB", "host_syncs_per_step")}))
    del solver, flow
    return rec, kernel


def lane_emden_phase(Nr, n):
    """examples/lane_emden.py (dense NLBVP, phase 20): Newton iterations
    to a perturbation norm of LANE_EMDEN_TOL, seconds per iteration, and
    the stellar radius R = f(0)^((n-1)/2) within 1e-5 of Boyd's."""
    import torch
    from dedalus_tpu_torch.extras.bench_problems import (build_lane_emden,
                                                         LANE_EMDEN_R)
    t0 = time.perf_counter()
    solver, f, radius = build_lane_emden(Nr, n, device="cuda")
    torch.cuda.synchronize()
    rec = {"Nr": Nr, "n": n, "build_s": time.perf_counter() - t0,
           "pencil_shape": list(solver.pencil_shape),
           "ops": solver.ops.kind}
    norms, secs = [], []
    while not norms or norms[-1] > LANE_EMDEN_TOL:
        t0 = time.perf_counter()
        solver.newton_iteration()
        norms.append(float(solver.perturbation_norm()))
        secs.append(time.perf_counter() - t0)
        if len(norms) > 30:
            fail(f"lane_emden{Nr}: no convergence in 30 iterations: {norms}")
    R = radius()
    rec.update(iterations=len(norms), perturbation_norms=norms,
               s_per_iteration=sum(secs) / len(secs), R=R,
               R_error=abs(R - LANE_EMDEN_R[n]))
    log(f"lane_emden{Nr} " + json.dumps(rec))
    if not rec["R_error"] < 1e-5:
        fail(f"lane_emden{Nr}: R = {R} is {rec['R_error']:.3e} from "
             f"{LANE_EMDEN_R[n]}")
    del solver, f
    return rec


def complex_ball_lbvp(device):
    """An ell-coupled NCC LBVP on a complex128 ball 8x8x8 (the f(theta,
    r)*u product of tests/test_coupled_ncc.py's ball cases): f u = F for a
    known u. Returns (u coefficients, max grid error against it)."""
    import numpy as np
    import dedalus_tpu_torch.public as d3
    coords = d3.SphericalCoordinates("phi", "theta", "r")
    dist = d3.Distributor(coords, dtype=np.complex128, device=device)
    ball = d3.BallBasis(coords, shape=(8, 8, 8), radius=1.0,
                        dtype=np.complex128)
    phi, theta, r = dist.local_grids(ball)
    z = r * np.cos(theta)
    f = dist.Field(name="f", bases=ball.meridional_basis)
    f["g"] = 2.0 + z ** 2 + 0.3 * z
    u = dist.Field(name="u", bases=ball)
    u_target = dist.Field(name="u_target", bases=ball)
    u_target["g"] = ((r * np.sin(theta) * np.cos(phi)) ** 2 + 0.5 * z
                     + 0.2 * z ** 2 + 1j * r * np.sin(theta) * np.sin(phi))
    F = (f * u_target).evaluate()
    problem = d3.LBVP([u], namespace={"f": f, "u": u, "F": F})
    problem.add_equation("f*u = F")
    problem.build_solver().solve()
    err = float(np.abs(np.asarray(u["g"])
                       - np.asarray(u_target["g"])).max())
    return np.array(u["c"]), err


def complex_ball_phase():
    """The complex ball (dense, phase 20): the coupled-NCC LBVP card vs
    CPU to 1e-12 of the solution, and within 1e-9 of the known u."""
    card, card_err = complex_ball_lbvp("cuda")
    cpu, cpu_err = complex_ball_lbvp("cpu")
    rec = {"lbvp_card_vs_cpu_rel": rel_diff(card, cpu),
           "lbvp_error_vs_exact": [card_err, cpu_err]}
    log("complex ball lbvp " + json.dumps(rec))
    if not rec["lbvp_card_vs_cpu_rel"] <= 1e-12 or not card_err < 1e-9:
        fail(f"complex ball LBVP: {rec}")
    return rec


def host_rss_GB():
    """The resident set size of this process in GB, from /proc/self/statm."""
    import os
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e9


class RssPeak:
    """A thread that samples host_rss_GB every `period` seconds while the
    `with` block runs; `peak_GB` is the largest sample (the process's
    getrusage high-water mark is set by whichever earlier phase peaked)."""

    def __init__(self, period=0.01):
        self.period = period
        self.peak_GB = 0.0

    def _poll(self):
        while not self._stop.wait(self.period):
            self.peak_GB = max(self.peak_GB, host_rss_GB())

    def __enter__(self):
        import threading
        self.peak_GB = host_rss_GB()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_GB = max(self.peak_GB, host_rss_GB())


def pipe_checks(label, solver):
    """A finite state, no slip within 1e-10 of max|u|, div(u) + tau_p on
    the grid within 1e-10 (its rows of L X recorded), |integ(p)| within
    1e-10, and the mean axial velocity finite and within 1% of the
    laminar profile's 1/2."""
    import numpy as np
    import torch
    import dedalus_tpu_torch.public as d3
    if not bool(torch.isfinite(solver.X).all()):
        fail(f"{label}: non-finite state")
    u, p, tau_u, tau_p = solver.variables
    c = u.tensorsig[0]
    bz, disk = u.domain.bases[:2]
    R = disk.radius
    ez = c.unit_vector_fields(u.dist)[0]
    volume = np.pi * R ** 2 * bz.length
    wall = float(np.abs(np.array(u(r=R).evaluate()["g"])).max())
    errs = {
        "div(u)+tau_p": float(np.abs(np.array(
            (d3.div(u) + tau_p).evaluate()["g"])).max()),
        "|integ(p)|": abs(float(np.array(
            d3.Integrate(p, c).evaluate()["g"]).ravel()[0]))}
    mean_w = float(np.array(d3.Integrate(u @ ez, c).evaluate()[
        "g"]).ravel()[0]) / volume
    # u's grid data last, on the dealias grid: the scale-1 grid drops the
    # last radial mode, where the tau lift puts its content
    u.change_scales(u.domain.dealias)
    u_max = float(np.abs(np.array(u["g"])).max())
    errs["u(r=R)/max|u|"] = wall / u_max
    bad = {k: v for k, v in errs.items() if not v <= 1e-10}
    errs.update(mean_axial_velocity=mean_w, u_max=u_max,
                div_rows_of_LX=constraint_residual(solver, 1))
    if not (np.isfinite(mean_w) and abs(mean_w - 0.5) <= 0.005):
        bad["mean_axial_velocity"] = mean_w
    log(f"{label} checks " + json.dumps(errs))
    if bad:
        fail(f"{label}: checks out of bound: {bad}")
    return errs


def pipe_phase(size, steps, block):
    """pipe_flow64x64x48 (phase 22): build_pipe_flow on the card under
    'auto' (dense: the banded attempt refused, the band too wide), the
    CFL's 20 steps and a step_many block, the checks, the breakdown."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_pipe_flow
    label = "pipe_flow%dx%dx%d" % size
    small = "pipe_flow%dx%dx%d" % PIPE_SMALL
    rec = {"cell": label, "size": list(size),
           "card_vs_cpu_rel": polar_card_vs_cpu(
               small, lambda device: (build_pipe_flow(
                   *PIPE_SMALL, device=device)[0], 5e-3), 20, ("u",),
               PIPE_ALGEBRAIC_BOUND)}
    release()
    torch.cuda.reset_peak_memory_stats()
    rec["allocated_before_build_GB"] = torch.cuda.memory_allocated() / 1e9
    rec["host_rss_before_build_GB"] = host_rss_GB()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        solver, cfl = build_pipe_flow(*size, device="cuda")
        torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["host_rss_after_build_GB"] = host_rss_GB()
    rec["host_peak_rss_GB"] = rss.peak_GB      # sampled during the build
    G, S = solver.pencil_shape
    rec.update(build_phases_s=dict(solver.build_seconds),
               pencil_shape=[G, S], ops=solver.ops.kind,
               matsolver=solver.ops.solver_cls.__name__,
               banded_reason=solver._banded_reason,
               dense_store_GB=G * S * S * 8 / 1e9,
               after_build_GB=torch.cuda.memory_allocated() / 1e9)
    log(f"{label} build " + json.dumps(rec))
    if rec["pencil_shape"] != PIPE_PENCILS or solver.ops.kind != "dense" \
            or not str(solver._banded_reason).startswith("band too wide"):
        fail(f"{label}: {solver.ops.kind} path, pencils {rec['pencil_shape']}"
             f", reason {solver._banded_reason!r}; expected dense "
             f"{PIPE_PENCILS} after 'band too wide'")
    # the main path: the factoring first step and the CFL's steps, the
    # kernel's counts set to 0 just before and read just after
    reset_launches()
    t0 = time.perf_counter()
    solver.step(cfl.compute_timestep())
    torch.cuda.synchronize()
    rec["first_step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        solver.step(cfl.compute_timestep())
    torch.cuda.synchronize()
    rec["cfl_steps_per_s"] = steps / (time.perf_counter() - t0)
    rec["launches"] = dict(fusedstep.LAUNCHES)
    dt = cfl.compute_timestep()
    rec["dt"] = [h["dt"] for h in cfl.history]
    rec["factorizations"] = solver.timestepper.factorizations
    if sum(rec["launches"].values()):
        fail(f"{label}: the dense path launched {rec['launches']}")
    # steady steps at the CFL's dt: no host sync, then the replayed block
    check_no_host_syncs(label, rec, solver, dt)
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["step_many"] = step_many_check(label, solver, dt, block, 10)
    if not rec["step_many"]["replay_bit_equal"]:
        fail(f"{label}: the replayed block is not bit-equal to the loop")
    top = rec["step_many"]["profile_block"]["top_kernels_ms_per_step"]
    rec["trsm_share_of_replayed_step"] = sum(
        ms for name, ms in top.items() if "trsm" in name.lower()) \
        / rec["step_many"]["profile_block"]["device_ms_per_step"]
    rec["floored_pivots"] = int(solver.floored_pivots.sum())
    rec["checks"] = pipe_checks(label, solver)
    rec["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    rec["own_peak_GB"] = rec["max_memory_allocated_GB"] \
        - rec["allocated_before_build_GB"]
    if not rec["own_peak_GB"] < 80:
        fail(f"{label}: own peak {rec['own_peak_GB']:.2f} GB")
    t0 = time.perf_counter()
    aux = solver.ops.factor_lincomb(1.0, solver.M_mat, dt, solver.L_mat)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    del aux
    release()
    rec["breakdown_ms"] = dense_breakdown(label, solver, dt, 10, cfl)
    rec["iteration"] = solver.iteration
    log(f"{label} " + json.dumps({k: rec[k] for k in (
        "build_s", "build_phases_s", "factor_s", "first_step_s",
        "cfl_steps_per_s", "steps_per_s", "pencil_shape", "banded_reason",
        "dense_store_GB", "own_peak_GB", "host_peak_rss_GB",
        "host_syncs_per_step", "trsm_share_of_replayed_step")}))
    del solver, cfl
    return rec


def cylinder_diffusion_phase(steps):
    """examples/cylinder_diffusion.py at its own 16x16x32 (dense, phase
    22): RK443 steps at dt 2e-4 and the exact Fourier-Bessel decay within
    the example's 1e-6."""
    import torch
    from dedalus_tpu_torch.extras.bench_problems import \
        build_cylinder_diffusion
    t0 = time.perf_counter()
    solver, dt, decay_error = build_cylinder_diffusion(device="cuda")
    torch.cuda.synchronize()
    rec = {"build_s": time.perf_counter() - t0,
           "pencil_shape": list(solver.pencil_shape),
           "ops": solver.ops.kind, "steps": steps, "dt": dt}
    rec["steps_per_s"] = steps_per_s(solver, dt, steps)
    rec["decay_error"] = decay_error()
    log("cylinder_diffusion16x16x32 " + json.dumps(rec))
    if not rec["decay_error"] < 1e-6:
        fail(f"cylinder diffusion: decay error {rec['decay_error']:.3e}")
    del solver
    return rec


def annulus_cylinder_lbvp_phase():
    """The Poisson LBVP in a cylindrical annulus (dense, phase 22;
    build_annulus_cylinder_poisson, f64 and complex128) card vs CPU to
    1e-12 of the solution, and within 1e-10 of the exact one."""
    import numpy as np
    from dedalus_tpu_torch.extras.bench_problems import \
        build_annulus_cylinder_poisson
    rec = {}
    for dtype in (np.float64, np.complex128):
        runs = {}
        for device in ("cuda", "cpu"):
            u, u_exact = build_annulus_cylinder_poisson(dtype=dtype,
                                                        device=device)
            exact = np.array(u_exact["g"])
            runs[device] = (np.array(u["c"]), float(
                np.abs(np.array(u["g"]) - exact).max()
                / np.abs(exact).max()))
        rec[np.dtype(dtype).name] = {
            "card_vs_cpu_rel": rel_diff(runs["cuda"][0], runs["cpu"][0]),
            "error_vs_exact": [runs["cuda"][1], runs["cpu"][1]]}
    log("annulus cylinder lbvp " + json.dumps(rec))
    for name, r in rec.items():
        if not (r["card_vs_cpu_rel"] <= 1e-12
                and max(r["error_vs_exact"]) <= 1e-10):
            fail(f"annulus cylinder LBVP {name}: {r}")
    return rec


def pipe_evp_phase(Nr):
    """examples/pipe_flow.py at its Nr (complex disk EVP, dense, phase
    22): build s, the m = 1 eigensolve s (scipy on the host), the mode
    nearest -0.0227050 - 0.9514810i within the example's 1e-4, the
    slowest mode decaying."""
    import numpy as np
    import torch
    from dedalus_tpu_torch.extras.bench_problems import (
        build_pipe_flow_evp, PIPE_FLOW_EVP_BAR, PIPE_FLOW_EVP_TARGET)
    t0 = time.perf_counter()
    solver, sp = build_pipe_flow_evp(Nr, device="cuda")
    torch.cuda.synchronize()
    rec = {"Nr": Nr, "build_s": time.perf_counter() - t0,
           "pencil_shape": list(solver.pencil_shape)}
    t0 = time.perf_counter()
    solver.solve_dense(sp)
    rec["eigensolve_s"] = time.perf_counter() - t0
    evals = np.asarray(solver.eigenvalues)
    evals = evals[np.isfinite(evals)]
    slowest = evals[np.argmax(evals.real)]
    match = evals[np.argmin(np.abs(evals - PIPE_FLOW_EVP_TARGET))]
    rec.update(slowest=[slowest.real, slowest.imag],
               nearest=[match.real, match.imag],
               nearest_error=float(abs(match - PIPE_FLOW_EVP_TARGET)))
    log(f"pipe_flow_evp{Nr} " + json.dumps(rec))
    if not (rec["nearest_error"] < PIPE_FLOW_EVP_BAR and slowest.real < 0):
        fail(f"pipe_flow_evp{Nr}: {rec}")
    del solver
    return rec


def large_q_kernels():
    """Both kernels against their plain versions past q = 128, at random
    operators of LARGE_Q_SHAPES in every dtype (phase 21)."""
    import torch
    recs = []
    for G, NB, q in LARGE_Q_SHAPES:
        for seed, dtype in enumerate((torch.float64, torch.float32,
                                      torch.complex128, torch.complex64,
                                      torch.bfloat16)):
            fsub, fp = random_fsub(G, NB, q, dtype, 40 + seed)
            label = f"random-q{q}"
            recs.append(check_kernel(label, fsub, fp))
            recs.append(check_kernel(label, fsub, fp, transposed=True))
            del fsub, fp
            release()
    return recs


def step_aux(solver):
    """The factor of the solver's current step: a Runge-Kutta scheme
    keeps one per distinct implicit coefficient (the first here), a
    multistep scheme the one of its leading coefficients."""
    aux = solver.timestepper._lhs_aux
    return aux if isinstance(aux, dict) and "factor_chunks" in aux \
        else aux[0]


def expected_launches(solver, steps, factorizations):
    """One launch per factorization (the Woodbury solve) and one per
    solve, whatever the factor's G-chunk count; also returns that count."""
    ts = solver.timestepper
    solves = steps * ts.stages * (1 + solver.ops.sweeps)
    return factorizations + solves, step_aux(solver)["factor_chunks"]


def cylinder_phase(card):
    """Phase 22, the cylinder: the pipe at PIPE_SIZE (the slice's main
    path, dense under 'auto': its counts set to 0 around its steps and
    read after; every cell here runs inside dense_path), the example's
    diffusion, an annulus-cylinder LBVP and the pipe-flow EVP. Logs and
    returns the summary."""
    pipe_label = "pipe_flow%dx%dx%d" % PIPE_SIZE
    RESULTS["cylinder"] = {}
    RESULTS["cylinder"][pipe_label] = dense_path(
        pipe_label, lambda: pipe_phase(PIPE_SIZE, PIPE_STEPS, PIPE_BLOCK))
    release()
    for cell, run in (
            ("cylinder_diffusion16x16x32",
             lambda: cylinder_diffusion_phase(DIFFUSION_STEPS)),
            ("annulus_cylinder_lbvp", annulus_cylinder_lbvp_phase),
            ("pipe_flow_evp%d" % PIPE_EVP_NR,
             lambda: pipe_evp_phase(PIPE_EVP_NR))):
        RESULTS["cylinder"][cell] = dense_path(cell, run)
        release()
    prec = RESULTS["cylinder"][pipe_label]
    sm = prec["step_many"]
    summary = {pipe_label: {k: prec.get(k) for k in (
        "pencil_shape", "ops", "matsolver", "banded_reason",
        "dense_store_GB", "build_s", "build_phases_s", "factor_s",
        "first_step_s", "cfl_steps_per_s", "steps_per_s",
        "max_memory_allocated_GB", "own_peak_GB",
        "allocated_before_build_GB", "host_rss_after_build_GB",
        "host_peak_rss_GB", "host_syncs_per_step", "card_vs_cpu_rel",
        "launches", "trsm_share_of_replayed_step", "checks")}}
    summary[pipe_label].update({
        "loop_steps_per_s": sm["loop_steps_per_s"],
        "block_steps_per_s": sm["block_steps_per_s"],
        "replay_bit_equal": sm["replay_bit_equal"],
        "host_syncs_per_block": sm["host_syncs_per_block"],
        "idle_share": [sm["profile_loop"]["idle_share"],
                       sm["profile_block"]["idle_share"]],
        "kernels_per_step": [sm["profile_loop"]["kernels_per_step"],
                             sm["profile_block"]["kernels_per_step"]],
        "substitution_launches":
            RESULTS["dense_path_launches"][pipe_label]})
    for cell in RESULTS["cylinder"]:
        if cell != pipe_label:
            summary[cell] = RESULTS["cylinder"][cell]
    summary["card"] = card
    log("cylinder " + json.dumps(summary))
    return summary


def fleet_template(build, device="cuda"):
    """A fleet's template solver and a `reset()` that puts its fields back
    to the state it was built with (a serial run or a fleet's
    init_members reads the template's fields), at iteration 0."""
    solver, member_init = build(device)
    X0 = solver.gather_fields()

    def reset():
        solver.scatter_fields(X0)
        solver.sim_time, solver.iteration = 0.0, 0
        return solver, member_init

    return solver, member_init, reset


def fleet_serial(reset, i, n, dt):
    """Member i stepped alone, n steps of step_many from a reset
    template (a fresh one for a multistep scheme): its state."""
    solver, member_init = reset()
    member_init(i)
    solver.step_many(n, dt)
    return solver.X.clone()


def fleet_members_vs_serial(label, rows, reset, n, dt):
    """Fleet members ({index: state}) after n steps against their serial
    runs on the card: relative difference and bit-equality of each;
    fails above FLEET_RTOL."""
    import torch
    out = {}
    for i, row in rows.items():
        ref = fleet_serial(reset, i, n, dt)
        out[i] = {"rel": float((row - ref).abs().max() / ref.abs().max()),
                  "bit_equal": bool(torch.equal(row, ref))}
        if not out[i]["rel"] <= FLEET_RTOL:
            fail(f"{label}: member {i} differs from its serial run by "
                 f"{out[i]['rel']:.3e}")
    return out


def fleet_run(label, reset, members, dt, block, per_step, kernel_k=None):
    """One fleet of `members` on a reset template: init, the first block
    (the factor and the recording), a warm block, FLEET_TIMED_BLOCKS timed
    blocks (member-steps/s), the launches of a fleet step (equal to
    `per_step`, the serial step's, whatever N), host syncs in a steady
    block (0), the profile of a block (idle share, kernels per fleet
    step), peak memory, and members 0 and N - 1 against their serial
    runs. With `kernel_k`, the kernel against its plain version at the
    fleet's own factor operators with k columns."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.profile_step import profile_run
    solver, member_init = reset()
    release()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    ens = solver.ensemble(members, health_cadence=0)
    ens.init_members(member_init)
    torch.cuda.synchronize()
    rec = {"members": members, "init_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ens.step_many(block, dt)
    torch.cuda.synchronize()
    rec["first_block_s"] = time.perf_counter() - t0
    ens.step_many(block, dt)
    before = sum(fusedstep.LAUNCHES.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FLEET_TIMED_BLOCKS):
        ens.step_many(block, dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = block * FLEET_TIMED_BLOCKS
    rec["fleet_steps_per_s"] = steps / wall
    rec["member_steps_per_s"] = members * steps / wall
    rec["launches_per_fleet_step"] = \
        (sum(fusedstep.LAUNCHES.values()) - before) / steps
    rec["host_syncs_per_block"], rec["host_sync_messages"] = host_syncs(
        lambda: ens.step_many(block, dt), 1)
    rec["profile"] = profile_run(lambda: ens.step_many(block, dt), block)
    rec["recordings"] = ens.recordings
    rec["launches"] = sum(fusedstep.LAUNCHES.values())
    rec["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    rec["own_peak_GB"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    if not torch.isfinite(ens.X).all():
        fail(f"{label} N={members}: non-finite fleet state")
    if kernel_k:
        fsub = ens._lhs_aux[0]["fsub"]
        G = fsub["lastOp"].shape[0]
        fp = torch.randn((G, kernel_k, solver.ops.n_pad),
                         generator=torch.Generator(device="cuda").manual_seed(
                             23), device="cuda", dtype=torch.float64)
        rec["kernel"] = check_kernel(f"{label}-k{kernel_k}", fsub, fp)
        del fsub, fp
    n = ens.iteration
    rows = {i: ens.X[i].clone() for i in sorted({0, members - 1})}
    del ens
    release()
    rec["vs_serial"] = fleet_members_vs_serial(f"{label} N={members}", rows,
                                               reset, n, dt)
    bad = []
    if rec["launches_per_fleet_step"] != per_step:
        bad.append(f"{rec['launches_per_fleet_step']} launches a fleet "
                   f"step, the serial step's {per_step}")
    if rec["host_syncs_per_block"]:
        bad.append(f"host syncs {rec['host_sync_messages']}")
    if rec["recordings"] != 1:
        bad.append(f"{rec['recordings']} recordings")
    log(f"{label} N={members} " + json.dumps(rec))
    if bad:
        fail(f"{label} N={members}: {bad}")
    return rec


def fleet_serial_rate(reset, dt, warm, steps):
    """The serial baseline of benchmarks/ensemble.py:96: one member on
    the template through step_many blocks, steps/s after a warm block,
    and the substitution launches a step."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    solver, member_init = reset()
    member_init(0)
    solver.step_many(warm, dt)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.step_many(steps, dt)
    torch.cuda.synchronize()
    return {"steps_per_s": steps / (time.perf_counter() - t0),
            "launches_per_step": sum(fusedstep.LAUNCHES.values()) / steps}


def fleet_per_member_dt(label, reset, dt_range, members, steps):
    """per_member_dt on the banded template: `members` distinct dts in
    `dt_range`, one factorization each; one fleet step's launches are one
    per solve with the members as pencil groups (G' = N G, read from an
    uncaptured step); the launches from the start = the factorizations'
    Woodbury solves + steps x stages x (1 + sweeps); members 0 and N - 1
    against their serial runs."""
    import numpy as np
    import torch
    from dedalus_tpu_torch.core import fusedstep
    solver, member_init = reset()
    release()
    ts = solver.timestepper
    dts = np.linspace(*dt_range, members)
    factors = ts.factorizations
    reset_launches()
    ens = solver.ensemble(members, per_member_dt=True, health_cadence=0)
    ens.init_members(member_init)
    ens.set_member_dts(dts)
    ens.step_many(1)
    ens.step_many(steps - 1)
    torch.cuda.synchronize()
    launches = sum(fusedstep.LAUNCHES.values())
    factors = ts.factorizations - factors
    shapes = []
    cuda_subst = fusedstep.substitution_cuda

    def recorded(fsub, fp):
        shapes.append(list(fp.shape))
        return cuda_subst(fsub, fp)

    fusedstep.substitution_cuda = recorded
    try:
        ens._rk_body(ens.X, ens.T, ens.DT, ens._extras)
    finally:
        fusedstep.substitution_cuda = cuda_subst
    G = solver.pencil_shape[0]
    rows = {i: ens.X[i].clone() for i in (0, members - 1)}
    del ens
    release()
    rec = {"members": members, "dts": dts.tolist(), "steps": steps,
           "factorizations": factors, "launches": launches,
           "launch_shapes": shapes}
    expected = factors + steps * ts.stages * (1 + solver.ops.sweeps)
    bad = []
    if launches != expected:
        bad.append(f"{launches} launches, expected {expected}")
    if shapes != [[members * G, solver.ops.n_pad]] * (
            ts.stages * (1 + solver.ops.sweeps)):
        bad.append(f"launch shapes {shapes}")
    rec["vs_serial"] = {}
    for i, row in rows.items():
        rec["vs_serial"].update(fleet_members_vs_serial(
            f"{label} per-member dt", {i: row}, reset, steps, dts[i]))
    log(f"{label} per-member dt " + json.dumps(rec))
    if bad:
        fail(f"{label} per-member dt: {bad}")
    return rec


def fleet_drop_and_seats(label, reset, members, dt, block):
    """Drop: NaN written (set_states) into member 3 of a fleet after its
    first probe; the next probe drops it, restored to its snapshot slot,
    and the others go on, equal to their serial runs. Seats: then member
    2 detached and a fresh member (member `members + 1`'s initial
    condition) attached at a block boundary, projected as a fresh serial
    run is at its iteration 0, stepped by step_fleet: the recording is
    kept, and the attached member equals its serial run from the
    attach."""
    import numpy as np
    import torch
    solver, member_init = reset()
    release()
    ens = solver.ensemble(members, health_cadence=block,
                          snapshot_cadence=block)
    ens.init_members(member_init)
    ens.step_many(block, dt)
    ens.snapshot()
    X = ens.X.clone()
    X[3, 0, 0] = float("nan")
    ens.set_states(X)
    ens.step_many(block, dt)
    recordings = ens.recordings
    ens.step_many(block, dt)
    rec = {"members": members, "dropped": [e["member"] for e in ens.dropped],
           "frozen_iteration": [e["frozen_iteration"] for e in ens.dropped],
           "n_active": ens.n_active}
    frozen = bool(torch.equal(ens.X[3], ens.ring[0].X[3])) \
        if ens.ring else False
    rows = {i: ens.X[i].clone() for i in (0, members - 1)}
    n = ens.iteration
    solver, member_init = reset()
    member_init(members + 1)
    X_row = solver.gather_fields()
    ens.detach_member(2)
    ens.attach_member(2, X_row)
    ens.project_members([2])
    taken = ens.step_fleet(block)
    rec["seat_recordings"] = ens.recordings - recordings
    rec["seat_taken"] = taken.tolist()
    seat = ens.X[2].clone()
    del ens
    release()
    rec["frozen_at_snapshot"] = frozen
    rec["vs_serial"] = fleet_members_vs_serial(f"{label} drop", rows, reset,
                                               n, dt)
    ref = fleet_serial(reset, members + 1, block, dt)
    rec["seat_vs_serial"] = float((seat - ref).abs().max()
                                  / ref.abs().max())
    rec["seat_bit_equal"] = bool(torch.equal(seat, ref))
    log(f"{label} drop and seats " + json.dumps(rec))
    bad = []
    if rec["dropped"] != [3] or rec["n_active"] != members - 1:
        bad.append(f"dropped {rec['dropped']}, {rec['n_active']} active")
    if not frozen:
        bad.append("the dropped member is not its snapshot slot")
    if rec["seat_recordings"]:
        bad.append(f"{rec['seat_recordings']} recordings after the seat")
    if not rec["seat_vs_serial"] <= FLEET_RTOL:
        bad.append(f"the attached member differs from its serial run by "
                   f"{rec['seat_vs_serial']:.3e}")
    if np.asarray(taken)[2] != block:
        bad.append(f"taken {rec['seat_taken']}")
    if bad:
        fail(f"{label}: {bad}")
    return rec


def fleet_cell(label, build, members, dt, block, banded):
    """One cell of phase 23: the template's build, its serial baseline,
    one fleet per N of `members` (the largest only where its peak,
    reckoned from the N = 64 fleet's own, fits FLEET_PEAK_BUDGET_GB),
    and on the banded cell the kernel at k = FLEET_KERNEL_K, the
    per-member-dt fleet and the drop and seat checks."""
    t0 = time.perf_counter()
    solver, member_init, reset = fleet_template(build)
    rec = {"build_s": time.perf_counter() - t0,
           "pencil_shape": list(solver.pencil_shape),
           "ops": solver.ops.kind,
           "scheme": type(solver.timestepper).__name__}
    if banded:
        ops = solver.ops
        rec["structure"] = {"q": ops.q, "NB": ops.NB, "pins": ops.t}
        if ops.kind != "banded":
            fail(f"{label}: the template is not banded")
    else:
        # a multistep template is stepped by its serial runs: each of them
        # runs on a fresh solver
        def reset():
            fresh, init = build("cuda")
            return fresh, init
    rec["serial"] = fleet_serial_rate(reset, dt, block, 4 * block)
    per_step = rec["serial"]["launches_per_step"]
    rec["fleets"] = {}
    for N in members:
        own = rec["fleets"].get(64, {}).get("own_peak_GB")
        if N > 64 and own is not None and \
                own * N / 64 > FLEET_PEAK_BUDGET_GB:
            rec["fleets"][N] = {"skipped": f"reckoned peak "
                                f"{own * N / 64:.1f} GB"}
            continue
        rec["fleets"][N] = fleet_run(
            label, reset, N, dt, block, per_step,
            kernel_k=FLEET_KERNEL_K if banded and N == FLEET_KERNEL_K
            else None)
    if banded:
        rec["per_member_dt"] = fleet_per_member_dt(
            label, reset, FLEET_PMDT_DT_RANGE, FLEET_PMDT_MEMBERS, block + 1)
        rec["drop_and_seats"] = fleet_drop_and_seats(label, reset, 8, dt,
                                                     block)
    return rec


def fleet_phase(card):
    """Phase 23, the ensemble fleets: rb256x64_ensemble (banded, RK222,
    the members as the kernel's columns) and diffusion64_ensemble (dense,
    SBDF2), each at every N of its list. Logs and returns the summary."""
    from dedalus_tpu_torch.extras.bench_problems import (
        build_diffusion_ensemble, build_rb_ensemble)
    RESULTS["fleets"] = cells = {}
    cells["rb256x64_ensemble"] = fleet_cell(
        "rb256x64_ensemble",
        lambda device: build_rb_ensemble(256, 64, device=device),
        FLEET_RB_MEMBERS, FLEET_RB_DT, FLEET_RB_BLOCK, banded=True)
    release()
    cells["diffusion64_ensemble"] = fleet_cell(
        "diffusion64_ensemble",
        lambda device: build_diffusion_ensemble(64, device=device),
        FLEET_DIFF_MEMBERS, FLEET_DIFF_DT, FLEET_DIFF_BLOCK, banded=False)
    release()
    keys = ("member_steps_per_s", "fleet_steps_per_s", "init_s",
            "first_block_s", "own_peak_GB", "launches_per_fleet_step",
            "host_syncs_per_block")
    summary = {}
    for label, cell in cells.items():
        summary[label] = {
            "build_s": cell["build_s"], "serial": cell["serial"],
            "fleets": {N: ({k: run[k] for k in keys} | {
                "idle_share": run["profile"]["idle_share"],
                "kernels_per_fleet_step": run["profile"]["kernels_per_step"],
                "vs_serial": run["vs_serial"]} if "skipped" not in run
                else run) for N, run in cell["fleets"].items()}}
    summary["card"] = card
    log("fleets " + json.dumps(summary))
    return summary


def lbvp_card_vs_cpu(label, build, held, other_bound, bound=1e-12):
    """The same small LBVP solved on the card and on the CPU (held against
    the JAX package by tests/test_torch_*.py): each variable's max
    difference relative to the CPU solution's largest coefficient. The
    variables in `held` agree to `bound`, the others to `other_bound`
    (None: recorded only)."""
    import numpy as np
    runs = {}
    for device in ("cuda", "cpu"):
        solver = build(device)
        solver.solve()
        runs[device] = {v.name: np.array(v["c"]) for v in solver.variables}
    card, cpu = runs["cuda"], runs["cpu"]
    scale = max(float(np.abs(a).max()) for a in cpu.values())
    errs = {k: float(np.max(np.abs(card[k] - cpu[k])) / scale) for k in cpu}
    log(f"{label} cuda vs cpu: " + json.dumps(errs))
    bad = {k: v for k, v in errs.items()
           if not v <= (bound if k in held else (
               float("inf") if other_bound is None else other_bound))}
    if bad:
        fail(f"{label} on the card disagrees with the CPU: {bad}")
    return errs


def coupled_structure(label, solver, want):
    """Assert the banded structure `want` ({pencil_shape, q, NB, pins})
    of a built solver; returns its record."""
    ops, st = solver.ops, solver.structure
    got = {"ops": ops.kind, "pencil_shape": list(solver.pencil_shape)}
    if ops.kind == "banded":
        got.update(q=ops.q, NB=ops.NB, pins=ops.t, kl=st.kl, ku=st.ku,
                   S=st.S)
    if ops.kind != "banded" or any(got.get(k) != v for k, v in want.items()):
        fail(f"{label}: {got}, not banded with {want}")
    return got


def wall_values(u, radii):
    """max |u| at each of `radii` (the annulus walls)."""
    import numpy as np
    import dedalus_tpu_torch.public as d3
    return [float(np.abs(np.asarray(d3.Interpolate(u, "r", r).evaluate()[
        "g"])).max()) for r in radii]


def substitution_kernels(label, solver, aux, woodbury=True):
    """The kernel against its plain version at a factor's own operators:
    k = 1 (a solve) and, with `woodbury`, the factor's Woodbury form (the
    one-hot E at the pins: k = pins columns, the launch the factor makes
    once). Each held to 1e-12 of the plain solution, or 10x the plain
    versions' gap (check_kernel's conditioned bound); at a boundary value
    problem's factor (the aux keeps its matrix), also to the backward
    error of the plain versions through the pinned base."""
    import torch
    ops = solver.ops
    fsub = {k: aux["fsub"][k] for k in ("FwdOp", "BwdOp", "lastOp")}
    G = solver.pencil_shape[0]
    base = None
    if "A" in aux:
        base = (ops._pin(ops._expand_bands(aux["A"], 0, G)), ops.kl, ops.ku)
    gen = torch.Generator(device="cuda").manual_seed(31)
    fp = torch.randn((G, ops.n_pad), generator=gen, device="cuda",
                     dtype=torch.float64)
    out = {"k1": check_kernel(f"{label}-factors", fsub, fp,
                              conditioned=True, base=base)}
    del fp
    if woodbury:
        E = torch.zeros((G, ops.t, ops.n_pad), dtype=torch.float64,
                        device="cuda")
        E[:, torch.arange(ops.t, device="cuda"), ops._pin_pos_t] = 1.0
        out["woodbury"] = check_kernel(f"{label}-factors-woodbury", fsub,
                                       E, reps=WOODBURY_REPS,
                                       conditioned=True, base=base)
        del E
    del base
    release()
    return out


def solve_cell(label, solver, u, exact, bound):
    """A built LBVP's first solve, its error against `exact`, the warm
    solve's median ms (POISSON_SOLVES solves, CUDA events), host syncs a
    warm solve (0), one factor timed alone, and the substitution
    launches from the build's count on: 1 (the build's Woodbury solve)
    + (1 + sweeps) a solve, asserted."""
    import numpy as np
    import torch
    from dedalus_tpu_torch.core import fusedstep
    ops = solver.ops
    rec = {}
    t0 = time.perf_counter()
    solver.solve()
    torch.cuda.synchronize()
    rec["first_solve_s"] = time.perf_counter() - t0
    rec["error"] = float(np.abs(np.asarray(u["g"]) - exact).max())
    rec["solve_ms"] = median_ms(solver.solve, reps=POISSON_SOLVES)
    rec["host_syncs_per_solve"], rec["host_sync_messages"] = \
        host_syncs(solver.solve, 1)
    solves = 1 + 3 + POISSON_SOLVES + 1
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    # a pin swap factors once more (SolverBase.factor_checked)
    rec["pin_swaps"] = solver.structure.pin_swaps
    rec["expected_launches"] = (1 + rec["pin_swaps"] if ops.t else 0) \
        + solves * (1 + ops.sweeps)
    rec["floored_pivots"] = int(solver.floored_pivots.sum())
    t0 = time.perf_counter()
    ops.factor(solver.L_mat)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    log(f"{label} " + json.dumps(rec))
    if not rec["error"] <= bound:
        fail(f"{label}: {rec['error']:.3e} from the exact solution > "
             f"{bound:g}")
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']}")
    if rec["host_syncs_per_solve"]:
        fail(f"{label}: {rec['host_syncs_per_solve']} host "
             f"synchronizations in a warm solve(): "
             f"{rec['host_sync_messages']}")
    return rec


def azncc_lbvp_phase(size):
    """annulus_azncc LBVP at `size`: 'auto' takes the banded path with
    one pencil group (AZNCC_STRUCTURE asserted), solved against its
    manufactured solution (AZNCC_BOUND). Returns (record, kernels)."""
    import torch
    from dedalus_tpu_torch.extras.bench_problems import build_annulus_azncc
    label = "annulus_azncc%dx%d lbvp" % size
    small = "annulus_azncc%dx%d lbvp banded" % AZNCC_SMALL
    rec = {"card_vs_cpu_rel": lbvp_card_vs_cpu(
        small, lambda device: build_annulus_azncc(
            *AZNCC_SMALL, "lbvp", matsolver="banded", device=device)[0],
        AZNCC_DYNAMIC, DISK_ALGEBRAIC_BOUND)}
    release()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    solver, u, exact = build_annulus_azncc(*size, "lbvp", device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec.update(coupled_structure(label, solver, AZNCC_STRUCTURE))
    rec.update(solve_cell(label, solver, u, exact, AZNCC_BOUND))
    rec["own_peak_GB"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    kernels = substitution_kernels(label, solver, solver._aux)
    log(f"{label} " + json.dumps({k: rec[k] for k in (
        "build_s", "build_phases_s", "factor_s", "solve_ms", "error",
        "launches", "own_peak_GB", "floored_pivots")}))
    del solver, u
    release()
    return rec, kernels


def azncc_ivp_phase(size, steps):
    """annulus_azncc IVP at `size`: the same structure, RK222 at AZNCC_DT
    from the manufactured profile: the factoring first step and `steps`
    timed ones (launches asserted, no host sync), a replayed step_many
    block bit-equal to a loop (idle share and kernels a step of each),
    the walls within 1e-10 of max |u|, max |u| decaying (w > 0 damps
    every mode)."""
    import numpy as np
    import torch
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import (AZNCC_DT,
                                                          AZNCC_RADII,
                                                          build_annulus_azncc)
    label = "annulus_azncc%dx%d ivp" % size
    small = "annulus_azncc%dx%d ivp banded" % AZNCC_SMALL
    rec = {"card_vs_cpu_rel": polar_card_vs_cpu(
        small, lambda device: (build_annulus_azncc(
            *AZNCC_SMALL, "ivp", matsolver="banded", device=device)[0],
            AZNCC_DT), 10, AZNCC_DYNAMIC, DISK_ALGEBRAIC_BOUND)}
    release()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    solver, u, exact = build_annulus_azncc(*size, "ivp", device="cuda")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    rec["build_phases_s"] = dict(solver.build_seconds)
    rec.update(coupled_structure(label, solver, AZNCC_STRUCTURE))
    ts = solver.timestepper
    u0 = float(np.abs(exact).max())
    reset_launches()
    t0 = time.perf_counter()
    solver.step(AZNCC_DT)
    torch.cuda.synchronize()
    rec["first_step_s"] = time.perf_counter() - t0
    rec["dt"] = AZNCC_DT
    rec["steps"] = steps
    rec["steps_per_s"] = steps_per_s(solver, AZNCC_DT, steps)
    rec["launches"] = fusedstep.LAUNCHES["banded_subst"]
    rec["expected_launches"], _ = expected_launches(
        solver, 1 + steps, factorizations=ts.factorizations)
    if rec["launches"] != rec["expected_launches"]:
        fail(f"{label}: {rec['launches']} kernel launches, expected "
             f"{rec['expected_launches']}")
    check_no_host_syncs(label, rec, solver, AZNCC_DT)
    t0 = time.perf_counter()
    aux = solver.ops.factor_lincomb(1.0, solver.M_mat, AZNCC_DT,
                                    solver.L_mat)
    torch.cuda.synchronize()
    rec["factor_s"] = time.perf_counter() - t0
    del aux
    rec["step_many"] = step_many_check(label, solver, AZNCC_DT, steps, 10)
    if not rec["step_many"]["replay_bit_equal"]:
        fail(f"{label}: the replayed block is not bit-equal to the loop")
    rec["floored_pivots"] = int(solver.floored_pivots.sum())
    ug = np.asarray(u["g"])
    umax = float(np.abs(ug).max())
    rec["max_u"] = [u0, umax]
    rec["walls_rel"] = [w / umax for w in wall_values(u, AZNCC_RADII)]
    rec["own_peak_GB"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    rec["iteration"] = solver.iteration
    log(f"{label} " + json.dumps({k: v for k, v in rec.items()
                                  if k != "step_many"}))
    if not (np.isfinite(ug).all() and umax < u0):
        fail(f"{label}: max |u| {u0} -> {umax} (finite and decaying "
             "expected)")
    if not max(rec["walls_rel"]) <= 1e-10:
        fail(f"{label}: walls {rec['walls_rel']} > 1e-10 of max |u|")
    kernels = substitution_kernels(label, solver, step_aux(solver),
                                   woodbury=False)
    del solver, u
    release()
    return rec, kernels


def disk_coupled_phase():
    """The disk's m-coupled pencils (dense: the kernel's counts stay 0):
    the azimuthally varying NCC LBVP and the Poisson under
    matrix_coupling, each card vs CPU to 1e-12 and within 1e-10 of its
    manufactured solution on the card, its solve ms."""
    import numpy as np
    import torch
    from dedalus_tpu_torch.extras.bench_problems import build_disk_azncc
    out = {}
    for kind, size in (("ncc", DISK_AZNCC_SIZE),
                       ("coupled_poisson", DISK_COUPLED_SIZE)):
        label = "disk_azncc%dx%d %s" % (size + (kind,))

        def run():
            rec = {"card_vs_cpu_rel": lbvp_card_vs_cpu(
                label, lambda device: build_disk_azncc(
                    *size, kind, device=device)[0], ("u", "tau"), None)}
            t0 = time.perf_counter()
            solver, u, exact = build_disk_azncc(*size, kind, device="cuda")
            torch.cuda.synchronize()
            rec["build_s"] = time.perf_counter() - t0
            rec["build_phases_s"] = dict(solver.build_seconds)
            rec["pencil_shape"] = list(solver.pencil_shape)
            rec["ops"] = solver.ops.kind
            solver.solve()
            rec["error"] = float(np.abs(np.asarray(u["g"]) - exact).max())
            rec["solve_ms"] = median_ms(solver.solve, reps=POISSON_SOLVES)
            rec["host_syncs_per_solve"], _ = host_syncs(solver.solve, 1)
            log(f"{label} " + json.dumps(rec))
            if solver.pencil_shape[0] != 1 or not rec["error"] <= 1e-10 \
                    or rec["host_syncs_per_solve"]:
                fail(f"{label}: {rec}")
            return rec

        out[label] = dense_path(label, run)
        release()
    return out


def rect_phase(N, limit_N):
    """poisson_rect at N forced banded (RECT_STRUCTURE asserted; the
    corner modes make L singular: the floored pivots read), its dense run
    on the card beside it (both within RECT_BOUND of the exact solution
    and of each other), card vs CPU at 48x48 forced banded; the kernel at
    its factor's operators; then at limit_N under 'auto' the build must
    raise the kernel's limit error. Returns (record, kernels)."""
    import numpy as np
    import torch
    from dedalus_tpu_torch.extras.bench_problems import build_poisson_rect
    from dedalus_tpu_torch.tools.config import config
    label = f"poisson_rect{N}"
    old = config["linear algebra"].get("BANDED_MAX_DIAGS", "384")
    config["linear algebra"]["BANDED_MAX_DIAGS"] = RECT_MAX_DIAGS
    try:
        # the taus are determined only up to the corner modes' null
        # directions: recorded, not compared
        rec = {"card_vs_cpu_rel": lbvp_card_vs_cpu(
            "poisson_rect48 banded", lambda device: build_poisson_rect(
                48, "banded", device=device)[0], ("u",), None)}
        release()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        solver, u, exact = build_poisson_rect(N, "banded", device="cuda")
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        rec["build_phases_s"] = dict(solver.build_seconds)
        rec.update(coupled_structure(label, solver, RECT_STRUCTURE))
        rec.update(solve_cell(label, solver, u, exact, RECT_BOUND))
        rec["own_peak_GB"] = (torch.cuda.max_memory_allocated()
                              - before) / 1e9
        ub = np.array(u["g"])
        kernels = substitution_kernels(label, solver, solver._aux)
        del solver, u
        release()

        def dense():
            solver, u, _ = build_poisson_rect(N, "dense", device="cuda")
            t0 = time.perf_counter()
            solver.solve()
            torch.cuda.synchronize()
            out = {"build_phases_s": dict(solver.build_seconds),
                   "first_solve_s": time.perf_counter() - t0,
                   "solve_ms": median_ms(solver.solve, reps=5, warm=1),
                   "floored_pivots": int(solver.floored_pivots.sum()),
                   "error": float(np.abs(np.asarray(u["g"])
                                         - exact).max()),
                   "banded_vs_dense": float(np.abs(ub - np.asarray(
                       u["g"])).max())}
            return out

        rec["dense"] = dense_path(label + " dense", dense)
        release()
        log(f"{label} dense " + json.dumps(rec["dense"]))
        if not (rec["dense"]["error"] <= RECT_BOUND
                and rec["dense"]["banded_vs_dense"] <= RECT_BOUND):
            fail(f"{label}: dense {rec['dense']}")
        t0 = time.perf_counter()
        try:
            build_poisson_rect(limit_N, "auto", device="cuda")
        except ValueError as exc:
            rec["limit"] = {"N": limit_N, "raised": str(exc),
                            "s": time.perf_counter() - t0}
        else:
            fail(f"poisson_rect{limit_N}: solved past the kernel's limit")
        if "exceeds the kernel's limit" not in rec["limit"]["raised"]:
            fail(f"poisson_rect{limit_N}: {rec['limit']['raised']}")
        log(f"poisson_rect{limit_N} " + json.dumps(rec["limit"]))
    finally:
        config["linear algebra"]["BANDED_MAX_DIAGS"] = old
    release()
    return rec, kernels


def joint_ncc_phase(size):
    """The joint f(x, z) NCC LBVP (dense, one pencil): card vs CPU to
    1e-12, within 1e-10 of its target on the card, its solve ms."""
    import numpy as np
    import torch
    from dedalus_tpu_torch.extras.bench_problems import build_joint_ncc
    label = "joint_ncc%dx%d" % size

    def run():
        rec = {"card_vs_cpu_rel": lbvp_card_vs_cpu(
            label, lambda device: build_joint_ncc(*size, device=device)[0],
            ("u",), None)}
        t0 = time.perf_counter()
        solver, u, target = build_joint_ncc(*size, device="cuda")
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        rec["build_phases_s"] = dict(solver.build_seconds)
        rec["pencil_shape"] = list(solver.pencil_shape)
        solver.solve()
        rec["error"] = float(np.abs(np.asarray(u["g"]) - target).max())
        rec["solve_ms"] = median_ms(solver.solve, reps=POISSON_SOLVES)
        rec["host_syncs_per_solve"], _ = host_syncs(solver.solve, 1)
        log(f"{label} " + json.dumps(rec))
        if solver.pencil_shape[0] != 1 or not rec["error"] <= 1e-10 \
                or rec["host_syncs_per_solve"]:
            fail(f"{label}: {rec}")
        return rec

    rec = dense_path(label, run)
    release()
    return rec


def coupled_phase(card):
    """Phase 24: the coupled pencils. Returns the phase's record; its
    kernel records under "kernels"."""
    out = {"card": card}
    lbvp, lk = azncc_lbvp_phase(AZNCC_SIZE)
    ivp, ik = azncc_ivp_phase(AZNCC_SIZE, AZNCC_STEPS)
    rect, rk = rect_phase(RECT_N, RECT_LIMIT_N)
    out.update({AZNCC_LBVP: lbvp, AZNCC_IVP: ivp, f"poisson_rect{RECT_N}":
                rect, **disk_coupled_phase(),
                "joint_ncc%dx%d" % JOINT_SIZE: joint_ncc_phase(JOINT_SIZE)})
    out["kernels"] = {AZNCC_LBVP: lk["k1"],
                      AZNCC_LBVP + " woodbury": lk["woodbury"],
                      AZNCC_IVP: ik["k1"],
                      f"poisson_rect{RECT_N}": rk["k1"],
                      f"poisson_rect{RECT_N} woodbury": rk["woodbury"]}
    return out


def runside_loop(label, solver, **kw):
    """One `solver.evolve_resilient` run at RUNSIDE_DT with the kernel's
    counts set to 0 just before it and read just after: the launches
    must equal the solve plan's count for what the loop executed, i.e.
    every step taken (those a rewind undid and each SDC re-execution
    included) x stages x (1 + sweeps), one Woodbury launch a
    factorization, and one solve a phase sample (two at the sampler's
    first). Returns (summary, record)."""
    import torch
    from dedalus_tpu_torch.core import fusedstep
    ts, m = solver.timestepper, solver.metrics
    it0, f0 = solver.iteration, ts.factorizations
    samples0 = m.counter("phase_samples").value
    warm0 = "matsolve" in m._warmed
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = solver.evolve_resilient(
        dt=RUNSIDE_DT, snapshot_cadence=RUNSIDE_SNAPSHOT_CADENCE,
        retry_base_delay=0.0, log_cadence=0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fusedstep.LAUNCHES)
    undone = sum(e["failure_iteration"] - e["rewind_iteration"]
                 for e in summary.get("lineage", [])
                 if e.get("rewind_iteration") is not None)
    event = solver.resilience.resume_event
    if event is not None:
        it0 = event["iteration"]        # the loop steps from the resume
    executed = (solver.iteration - it0) + undone \
        + summary.get("sdc_checks", 0)
    factors = ts.factorizations - f0
    sampled = m.counter("phase_samples").value - samples0 \
        + int(not warm0 and "matsolve" in m._warmed)
    per_solve = 1 + solver.ops.sweeps
    expect = executed * ts.stages * per_solve + factors + sampled * per_solve
    rec = {"iterations": [it0, solver.iteration], "wall_s": wall,
           "steps_executed": executed, "factorizations": factors,
           "phase_sample_solves": sampled, "launches": launches,
           "expected_launches": expect,
           "summary": {k: v for k, v in summary.items()
                       if k in ("rewinds", "retries", "snapshots", "dt_limit",
                                "stopped_by", "sdc_checks", "sdc_detected",
                                "checkpoint", "timing", "resumed_from")},
           "lineage": [{k: e.get(k) for k in (
               "failure_iteration", "outcome", "rewind_iteration",
               "dt_limit")} for e in summary.get("lineage", [])]}
    log(f"runside {label} " + json.dumps(rec, default=str))
    if launches["banded_subst"] != expect or \
            sum(launches.values()) != launches["banded_subst"]:
        fail(f"runside {label}: launches {launches} != expected {expect}")
    return summary, rec


def runside_phase(card):
    """Phase 25: the run-side tools at RB 2048x1024 through the public
    API (see the module docstring). Returns the phase's record."""
    import tempfile
    import numpy as np
    import torch
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    from dedalus_tpu_torch.tools import chaos, dcheckpoint, resilience
    from dedalus_tpu_torch.tools.metrics import format_phase_table
    out = {"card": card, "size": "%dx%d" % RUNSIDE_SIZE}
    tmp = tempfile.TemporaryDirectory(prefix="runside_")
    root = pathlib.Path(tmp.name)
    sink, ck, ck_stop = root / "metrics.jsonl", root / "ckpt", \
        root / "ckpt_stop"
    torch.cuda.reset_peak_memory_stats()
    dt = RUNSIDE_DT
    sdc = {"sdc_cadence": RUNSIDE_SDC_CADENCE}
    async_ckpt = {"checkpoint_format": "sharded", "checkpoint_async": True}

    def build():
        t0 = time.perf_counter()
        solver, _ = build_rb_solver(
            *RUNSIDE_SIZE, np.float64, matsolver="banded", device="cuda",
            metrics=True, metrics_file=str(sink),
            sample_cadence=RUNSIDE_SAMPLE_CADENCE, health=True,
            health_cadence=RUNSIDE_HEALTH_CADENCE,
            postmortem_dir=str(root / "postmortems"))
        torch.cuda.synchronize()
        return solver, time.perf_counter() - t0

    # the clean run: a checkpoint at RUNSIDE_CKPT_AT (async, sharded),
    # then on to RUNSIDE_CLEAN without one
    A, out["build_s"] = build()
    out["pencil_shape"] = list(A.pencil_shape)
    A.stop_iteration = RUNSIDE_CKPT_AT
    s1, out["clean_to_checkpoint"] = runside_loop(
        "clean 0-%d" % RUNSIDE_CKPT_AT, A, checkpoint_dir=ck, **async_ckpt,
        **sdc)
    A.stop_iteration = RUNSIDE_CLEAN
    s2, out["clean_on"] = runside_loop(
        "clean %d-%d" % (RUNSIDE_CKPT_AT, RUNSIDE_CLEAN), A, **sdc)
    X_ref, t_ref = A.X.clone(), A.sim_time
    ckpt = s1["checkpoint"]
    out["checkpoint_stall_s_per_write"] = ckpt["stall_sec"] / max(
        ckpt["written"], 1)
    out["checkpoint_bytes"] = ckpt["bytes_written"]
    out["resilient_loop_steps_per_s"] = \
        (RUNSIDE_CLEAN - RUNSIDE_CKPT_AT) / out["clean_on"]["wall_s"]
    bad = [f"{k}: {v}" for k, v in (
        ("stopped_by", s1["stopped_by"]), ("stopped_by", s2["stopped_by"]))
        if v != "completed"]
    bad += [f"sdc_detected {s['sdc_detected']}" for s in (s1, s2)
            if s["sdc_detected"]]
    if ckpt["written"] < 1 or ckpt["errors"]:
        bad.append(f"checkpoint {ckpt}")
    if bad:
        fail(f"runside clean run: {bad}")
    del A
    release()

    # a fresh solver resumes from the checkpoint and steps to the clean
    # run's end: bit-equal; its warmup (the first phase sample and health
    # record) just after the resume
    B, out["resume_build_s"] = build()
    B.warmup_iterations = RUNSIDE_CKPT_AT + 2
    B.stop_iteration = RUNSIDE_CLEAN
    s3, out["resume"] = runside_loop("resume", B, checkpoint_dir=ck,
                                     checkpoint_format="sharded",
                                     resume=True, **sdc)
    out["resume_s"] = s3["timing"]["resume_sec"]
    out["resumed_bit_equal"] = bool(torch.equal(B.X, X_ref)) \
        and B.sim_time == t_ref
    log(f"runside resume: {out['resume_s']:.3f} s, bit-equal "
        f"{out['resumed_bit_equal']} at iteration {B.iteration}")
    if not out["resumed_bit_equal"] or not s3.get("resumed_from"):
        fail("runside: the resumed state is not the uninterrupted one")
    del X_ref

    # chaos: a NaN after RUNSIDE_NAN_AFTER steps, found by the health
    # probe: one rewind with the dt backoff (its refactor, and the one
    # when the cap relaxes after a clean snapshot cadence)
    start = B.iteration
    B.stop_iteration = start + RUNSIDE_CHAOS_STEPS
    inj = chaos.ChaosInjector(nan_field="b",
                              nan_iteration=start + RUNSIDE_NAN_AFTER)
    s4, out["nan"] = runside_loop("nan", B, chaos=inj, **sdc)
    lineage = s4.get("lineage", [])
    out["rewind_s"] = s4["timing"]["rewind_sec"]
    if not (s4["rewinds"] == 1 and len(lineage) == 1
            and lineage[0]["dt_limit"] == dt * B.resilience.dt_backoff
            and [f["kind"] for f in inj.fired] == ["nan"]
            and s4["sdc_detected"] == 0 and B.health_error is None
            and bool(torch.isfinite(B.X).all())):
        fail(f"runside nan: {out['nan']}")

    # a flipped mantissa bit on a checked step: one detection, a rewind
    # without backoff, and the state of a clean re-run of the same steps
    anchor = resilience.capture_snapshot(B)
    B.stop_iteration = B.iteration + RUNSIDE_FLIP_STEPS
    inj = chaos.ChaosInjector(seed=3, flip_bit_iteration=B.iteration + 1)
    s5, out["flip"] = runside_loop("bit flip", B, chaos=inj, **sdc)
    X_flip = B.X.clone()
    resilience.restore_snapshot(B, anchor)
    s6, out["flip_clean"] = runside_loop("clean re-run", B, **sdc)
    out["sdc_check_s"] = s5["timing"]["sdc_check_sec"] \
        + s6["timing"]["sdc_check_sec"]
    out["flip_recovered_bit_equal"] = bool(torch.equal(B.X, X_flip))
    if not (s5["sdc_detected"] == 1 and s5["rewinds"] == 1
            and s5["dt_limit"] is None and s6["sdc_detected"] == 0
            and [f["kind"] for f in inj.fired] == ["flip_bit"]
            and out["flip_recovered_bit_equal"]):
        fail(f"runside bit flip: {out['flip']} {out['flip_clean']} "
             f"bit-equal {out['flip_recovered_bit_equal']}")
    del anchor, X_flip

    # SIGTERM: a graceful stop and a final checkpoint after a periodic
    # one; the newest corrupted, a resume falls back to the periodic one
    kept = {}
    periodic = B.iteration + RUNSIDE_STOP_CKPT_ITER

    def keep(solver):
        if solver.iteration == periodic:
            kept["X"] = solver.X.clone()
    B.stop_iteration = B.iteration + 10 * RUNSIDE_SIGTERM_AFTER
    inj = chaos.ChaosInjector(
        sigterm_iteration=B.iteration + RUNSIDE_SIGTERM_AFTER)
    s7, out["sigterm"] = runside_loop(
        "sigterm", B, chaos=inj, checkpoint_dir=ck_stop,
        checkpoint_iter=RUNSIDE_STOP_CKPT_ITER, step_hook=keep,
        **async_ckpt)
    ckpts = dcheckpoint.list_checkpoints(ck_stop)
    final_meta = dcheckpoint.read_manifest(ckpts[-1])["meta"] if ckpts \
        else {}
    if not (s7["stopped_by"] == "SIGTERM" and len(ckpts) == 2
            and final_meta.get("iteration") == B.iteration
            and s7["checkpoint"]["errors"] == 0 and "X" in kept):
        fail(f"runside sigterm: {out['sigterm']} checkpoints {ckpts}")
    chaos.corrupt_shard(ckpts[-1], mode="garbage")
    B.stop_iteration = periodic
    s8, out["fallback"] = runside_loop(
        "corrupt newest", B, checkpoint_dir=ck_stop,
        checkpoint_format="sharded", resume=True)
    event = B.resilience.resume_event
    out["fallback_event"] = {"iteration": event["iteration"],
                             "fallbacks": event["fallbacks"]}
    if not (event["iteration"] == periodic and len(event["fallbacks"]) == 1
            and "quarantined" in event["fallbacks"][0]
            and torch.equal(B.X, kept["X"])):
        fail(f"runside fallback: {out['fallback_event']}")
    del kept

    # HDF5 output: h5py is optional on this machine
    try:
        import h5py
    except ImportError:
        h5py = None
    if h5py is None:
        try:
            B.evaluator.add_file_handler(root / "snaps", iter=1)
        except ImportError as exc:
            out["file_handler"] = f"ImportError: {exc}"
            if "h5py" not in str(exc):
                fail(f"runside: the ImportError does not name h5py: {exc}")
        else:
            fail("runside: add_file_handler without h5py did not raise")
    else:
        handler = B.evaluator.add_file_handler(root / "snaps", iter=1,
                                               max_writes=1)
        b = next(v for v in B.variables if v.name == "b")
        handler.add_task(b, layout="c", name="b")
        B.evaluator.evaluate_handlers([handler], iteration=B.iteration,
                                      sim_time=B.sim_time, timestep=dt)
        with h5py.File(handler.current_file, "r") as f:
            data = np.asarray(f["tasks/b"])[0]
        ok = np.array_equal(data, np.asarray(b["c"]))
        out["file_handler"] = f"one set written and read back: {ok}"
        B.evaluator.handlers.remove(handler)
        if not ok:
            fail("runside: the FileHandler's set does not read back")
    log(f"runside FileHandler: {out['file_handler']}")

    # host reads of single steps: 0 off the cadences, the probe's one on
    # a health step, the sampler's on a sample step (one stream
    # synchronization, then one after each timed thunk: the RHS
    # evaluation, the solve and the transform roundtrip)
    B.stop_iteration = np.inf
    B.step(dt)                  # the factor after the resume
    B.health.cadence = 4
    B.metrics.reset_loop()
    thunks = 3
    syncs, expect = [], []
    for k in range(1, RUNSIDE_SAMPLE_CADENCE + 1):
        n, _ = host_syncs(lambda: B.step(dt), reps=1)
        syncs.append(n)
        expect.append((k % 4 == 0) + (
            1 + thunks if k == RUNSIDE_SAMPLE_CADENCE else 0))
    out["host_syncs_by_step"] = {"measured": syncs, "expected": expect}
    log(f"runside host syncs by step {syncs} (expected {expect})")
    if syncs != expect:
        fail(f"runside host syncs {syncs} != expected {expect}")

    # steps/s of a step loop with the layers on (their cadences crossed)
    # and off (the same solver, both layers disabled)
    rates = {}
    for layers in ("on", "off"):
        if layers == "off":
            B.metrics.enabled = B.metrics.sampling = False
            B.health.enabled = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RUNSIDE_TIMED_STEPS):
            B.step(dt)
        torch.cuda.synchronize()
        rates[layers] = RUNSIDE_TIMED_STEPS / (time.perf_counter() - t0)
    out["steps_per_s_layers"] = rates
    out["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    records = [json.loads(line) for line in sink.read_text().splitlines()
               if '"step_metrics"' in line]
    last = next((r for r in reversed(records) if r.get("phase_samples")),
                None)
    out["phase_table"] = format_phase_table(last)
    for line in out["phase_table"]:
        log("runside " + line)
    out["launches"] = sum(out[k]["launches"]["banded_subst"] for k in (
        "clean_to_checkpoint", "clean_on", "resume", "nan", "flip",
        "flip_clean", "sigterm", "fallback"))
    summary = {k: out[k] for k in (
        "build_s", "resume_build_s", "resilient_loop_steps_per_s",
        "steps_per_s_layers", "checkpoint_stall_s_per_write",
        "checkpoint_bytes", "resume_s", "rewind_s", "sdc_check_s",
        "max_memory_allocated_GB", "resumed_bit_equal",
        "flip_recovered_bit_equal", "launches", "card")}
    log("runside " + json.dumps(summary))
    del B
    tmp.cleanup()
    release()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--real", type=int, nargs=2, default=(2048, 1024),
                        metavar=("NX", "NZ"))
    parser.add_argument("--real-steps", type=int, default=10)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from dedalus_tpu_torch.core import fusedstep
    from dedalus_tpu_torch.extras.bench_problems import build_rb_solver
    from dedalus_tpu_torch.tools.config import config
    # phases 1-24 measure the step path with the run-side layers off (a
    # solver with both off runs what it ran before them, and their launch
    # and host-sync counts hold as they were); phase 25 turns them on
    config["profiling"]["METRICS_DEFAULT"] = "False"
    config["health"]["HEALTH_DEFAULT"] = "False"

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    phase_t0 = [time.perf_counter()]

    def phase_done(name):
        """Print the phase's seconds and write the results so far."""
        now = time.perf_counter()
        RESULTS.setdefault("phase_s", {})[name] = now - phase_t0[0]
        log(f"phase {name}: {now - phase_t0[0]:.2f} s")
        phase_t0[0] = now
        (out_dir / "chip_smoke.json").write_text(json.dumps(RESULTS,
                                                            indent=1))

    # ---------------------------------------------------------- phase 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    RESULTS["card"] = card
    RESULTS["torch"] = torch.__version__
    RESULTS["cuda"] = torch.version.cuda
    RESULTS["python"] = sys.version.split()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    fusedstep.load_kernel_library()
    RESULTS["kernel_build_s"] = time.perf_counter() - t0
    log(f"kernel build: {RESULTS['kernel_build_s']:.2f} s")
    RESULTS["ptxas"] = fusedstep.ptxas_report()
    log(RESULTS["ptxas"])
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_done("1 card and build")

    # ---------------------------------------------------------- phase 2
    Gr, NBr, qr = 1024, 257, 32       # RB 2048x1024: G = Nx/2, NB, q
    transposed = {}
    for dtype, seed, k in ((torch.float64, 1, 1), (torch.float32, 2, 1),
                           (torch.bfloat16, 5, 1), (torch.float64, 4, 16)):
        fsub, fp = random_fsub(Gr, NBr, qr, dtype, seed, k)
        check_kernel("rb2048x1024-random" + ("-woodbury" if k > 1 else ""),
                     fsub, fp)
        if k == 1:
            # the transposed solve's kernel on the same operators
            transposed[dtype] = check_kernel("rb2048x1024-random", fsub, fp,
                                             transposed=True)
        del fsub, fp
    torch.cuda.empty_cache()
    phase_done("2 kernel vs plain")

    # ---------------------------------------------------------- phase 3
    # a small input against the port's CPU path (held against the JAX
    # package by tests/test_torch_rb.py)
    RESULTS["rb8x32_cuda_vs_cpu_rel"] = card_vs_cpu(
        "rb8x32", lambda device: (build_rb_solver(
            8, 32, np.float64, matsolver="banded", device=device)[0], 0.01),
        10)

    dt = 1e-3
    t0 = time.perf_counter()
    solver, b = build_rb_solver(256, 64, np.float64, matsolver="banded",
                                device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    solver.step(dt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.steps - 1):
        solver.step(dt)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(fusedstep.LAUNCHES)
    expect, chunks = expected_launches(solver, args.steps, factorizations=1)
    main = {"size": "256x64", "steps": args.steps, "build_s": build_s,
            "first_step_s": first_s,
            "steps_per_s": (args.steps - 1) / run_s,
            "launches": launches["banded_subst"],
            "expected_launches": expect, "chunks": chunks,
            "pencil_shape": list(solver.pencil_shape),
            "q": solver.ops.q, "NB": solver.ops.NB, "pins": solver.ops.t}
    log("main path rb256x64 " + json.dumps(main))
    RESULTS["main"] = main
    if launches["banded_subst"] != expect:
        fail(f"kernel launches on the main path {launches['banded_subst']} "
             f"!= expected {expect}")
    main["checks"] = rb_checks("rb256x64", solver, b)
    x_banded = solver.X.cpu().numpy()
    check_no_host_syncs("rb256x64", main, solver, dt)
    main["step_many"] = step_many_check("rb256x64", solver, dt, 20, 5)

    # the same run with matsolver=None: 'auto' takes the dense path here
    # (the JAX package's rule, written for a TPU, sizes it at 283 MB)
    t0 = time.perf_counter()
    dsolver, _ = build_rb_solver(256, 64, np.float64, device="cuda")
    torch.cuda.synchronize()
    dense = {"size": "256x64", "steps": args.steps,
             "build_s": time.perf_counter() - t0,
             "ops": f"{dsolver.ops.kind} {dsolver.ops.solver_cls.__name__}"}
    t0 = time.perf_counter()
    dsolver.timestepper._ensure_factor(dt)
    torch.cuda.synchronize()
    dense["factor_s"] = time.perf_counter() - t0
    dsolver.step(dt)
    dense["steps_per_s"] = steps_per_s(dsolver, dt, args.steps - 1)
    dense["vs_banded_rel"] = rel_diff(dsolver.X.cpu().numpy(), x_banded)
    check_no_host_syncs("rb256x64 dense", dense, dsolver, dt)
    dense["banded"] = {"steps_per_s": main["steps_per_s"]}
    t0 = time.perf_counter()
    solver.ops.factor_lincomb(1.0, solver.M_mat,
                              dt * solver.timestepper.uniq_H_diag[0],
                              solver.L_mat)
    torch.cuda.synchronize()
    dense["banded"]["factor_s"] = time.perf_counter() - t0
    log("rb256x64 dense vs banded " + json.dumps(dense))
    RESULTS["rb256x64_dense"] = dense
    if dense["ops"].split()[0] != "dense":
        fail(f"rb256x64 with matsolver=None took {dense['ops']}")
    if not dense["vs_banded_rel"] <= 1e-10:
        fail(f"rb256x64 dense state differs from the banded one: "
             f"{dense['vs_banded_rel']:.3e}")
    del dsolver

    # the kernel at the main path's own shapes and factor operators
    aux = solver.timestepper._lhs_aux[0]
    fsub64 = aux["fsub"]
    fsub64 = {k: fsub64[k] for k in ("FwdOp", "BwdOp", "lastOp")}
    G, q = fsub64["lastOp"].shape[:2]
    gen = torch.Generator(device="cuda").manual_seed(3)
    fp64 = torch.randn((G, solver.ops.n_pad), generator=gen, device="cuda",
                       dtype=torch.float64)
    main_rec = check_kernel("rb256x64-factors", fsub64, fp64)
    check_kernel("rb256x64-factors",
                 {k: v.float().contiguous() for k, v in fsub64.items()},
                 fp64.float())
    bf16_rec = check_kernel(
        "rb256x64-factors",
        {k: v.bfloat16().contiguous() for k, v in fsub64.items()},
        fp64.bfloat16())
    check_kernel("rb256x64-factors", fsub64, fp64, transposed=True)

    RESULTS["breakdown_rb256x64_ms"] = breakdown("rb256x64", solver, dt, 20)
    del aux, fsub64, fp64
    # phase 16's cells on the main path's solver: every plan kind, each
    # non-default one also as a replayed step (bf16 does not converge on
    # RB, in the JAX package either, so its state is recorded only)
    RESULTS["fusion_precision"] = {"rb256x64": plan_cells(
        "rb256x64", solver, dt, 20,
        [("default", {}), ("transforms", {"FUSED_TRANSFORMS": "on"}),
         ("unfused", {"FUSED_SOLVE": "off"}),
         ("ascan", {"SOLVE_COMPOSITION": "ascan"}),
         ("spike", {"SOLVE_COMPOSITION": "spike"}),
         ("f32", {"SOLVE_DTYPE": "f32"}), ("bf16", {"SOLVE_DTYPE": "bf16"})],
        step_many=("default", "transforms", "unfused", "ascan", "spike",
                   "f32"),
        solve_ms=("default", "unfused", "ascan", "spike", "f32", "bf16"),
        profile=("default", "transforms"), rhs_ms=("default", "transforms"),
        bounds={"transforms": 1e-12, "unfused": 1e-12, "ascan": 1e-11,
                "spike": 1e-11, "f32": None, "bf16": None})}
    RESULTS["fusion_precision"]["rb256x64_ladder_dt"] = plan_cells(
        f"rb256x64 dt {LADDER_DT}", solver, LADDER_DT, 20,
        [("default", {}), ("f32", {"SOLVE_DTYPE": "f32"})],
        bounds={"f32": 1e-9})
    del solver, b
    release()
    # gradients on the main path's problem (RK222 and the multistep ramp
    # of SBDF2), each forward pass against GRAD_STEPS solver.step calls
    # from the same fresh state
    for scheme in ("RK222", "SBDF2"):
        solvers = [build_rb_solver(256, 64, np.float64, matsolver="banded",
                                   device="cuda", timestepper=scheme)[0]
                   for _ in range(2)]
        for s_ in solvers:
            s_.enforce_real_cadence = 0
        for _ in range(GRAD_STEPS):
            solvers[0].step(dt)
        reference = solvers[0].X.clone()
        del solvers[0]
        release()
        gradient_cell(f"rb256x64 {scheme}", solvers[0], dt, GRAD_STEPS,
                      (1, None), reference=reference)
        del solvers, reference
        release()
    phase_done("3 rb256x64")

    # ---------------------------------------------------------- phase 4
    Nx, Nz = args.real
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, b = build_rb_solver(Nx, Nz, np.float64, matsolver="banded",
                                device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver.timestepper._ensure_factor(dt)
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    for _ in range(args.real_steps):
        solver.step(dt)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    expect, chunks = expected_launches(solver, args.real_steps,
                                       factorizations=0)
    real = {"size": f"{Nx}x{Nz}", "steps": args.real_steps,
            "build_s": build_s, "build_phases_s": solver.build_seconds,
            "factor_s": factor_s, "steps_per_s": args.real_steps / run_s,
            "launches": fusedstep.LAUNCHES["banded_subst"],
            "expected_launches": expect, "chunks": chunks,
            "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
            "pencil_shape": list(solver.pencil_shape),
            "q": solver.ops.q, "NB": solver.ops.NB, "pins": solver.ops.t}
    log(f"real size rb{Nx}x{Nz} " + json.dumps(real))
    RESULTS["real"] = real
    if real["launches"] != expect:
        fail(f"kernel launches at real size {real['launches']} != "
             f"expected {expect}")
    real["checks"] = rb_checks(f"rb{Nx}x{Nz}", solver, b)
    RESULTS[f"breakdown_rb{Nx}x{Nz}_ms"] = breakdown(f"rb{Nx}x{Nz}", solver,
                                                     dt, 5)
    # phase 16's cells at the real size; the compositions only where
    # their reckoning fits the card
    cells = [("default", {}), ("transforms", {"FUSED_TRANSFORMS": "on"}),
             ("f32", {"SOLVE_DTYPE": "f32"}), ("bf16", {"SOLVE_DTYPE": "bf16"})]
    reckon = {"ascan_GB": ascan_reckoning_GB(solver),
              "spike_GB": spike_reckoning_GB(solver),
              "budget_GB": ASCAN_BUDGET_GB}
    for comp in ("ascan", "spike"):
        if reckon[f"{comp}_GB"] <= ASCAN_BUDGET_GB:
            cells.append((comp, {"SOLVE_COMPOSITION": comp}))
    log(f"rb{Nx}x{Nz} composition reckoning " + json.dumps(reckon))
    RESULTS["fusion_precision"][f"rb{Nx}x{Nz}"] = plan_cells(
        f"rb{Nx}x{Nz}", solver, dt, 5, cells,
        step_many=("default", "transforms"),
        solve_ms=("default", "f32", "bf16", "ascan", "spike"),
        profile=("default", "transforms"), rhs_ms=("default", "transforms"),
        bounds={"transforms": 1e-12, "ascan": 1e-11, "spike": 1e-11,
                "f32": None, "bf16": None})
    RESULTS["fusion_precision"][f"rb{Nx}x{Nz}"]["reckoning"] = reckon
    RESULTS["fusion_precision"][f"rb{Nx}x{Nz}_ladder_dt"] = plan_cells(
        f"rb{Nx}x{Nz} dt {LADDER_DT}", solver, LADDER_DT, 5,
        [("default", {}), ("f32", {"SOLVE_DTYPE": "f32"})],
        bounds={"f32": 1e-9})
    # gradients at the real size: K = ceil(sqrt n) always, K = 1 where
    # its reckoned peak fits GRAD_BUDGET_GB
    reckon = grad_reckoning_GB(solver, dt, args.real_steps)
    log(f"rb{Nx}x{Nz} gradient reckoning " + json.dumps(reckon))
    fits = reckon["K1_peak_GB"] <= GRAD_BUDGET_GB
    gradient_cell(f"rb{Nx}x{Nz}", solver, dt, args.real_steps,
                  (None, 1) if fits else (None,))
    RESULTS["gradients"][f"rb{Nx}x{Nz}"]["reckoning"] = reckon
    del solver, b
    release()
    phase_done(f"4 rb{Nx}x{Nz}")

    # ---------------------------------------------------------- phase 5
    RESULTS["kdv"] = dense_path("kdv1024", lambda: kdv_phase(1024, 500))
    log("kdv1024 " + json.dumps(RESULTS["kdv"]))
    release()
    phase_done("5 kdv1024")

    # ---------------------------------------------------------- phase 6
    RESULTS["shear"] = dense_path("shear512",
                                  lambda: shear_phase(512, 100, 30))
    log("shear512 " + json.dumps(RESULTS["shear"]))
    release()
    phase_done("6 shear512")

    # ---------------------------------------------------------- phase 7
    # the boundary value problems: card vs CPU at 64x32 on the banded path
    # (held against the JAX package by tests/test_torch_bvp.py), then
    # Poisson at the target resolution through the public API, 'auto'
    # picking the banded path there (dense would be 34.5 GB)
    RESULTS["poisson64x32_cuda_vs_cpu_rel"] = poisson_card_vs_cpu(
        64, 32, "banded")
    rec, solver, f = poisson_run("poisson2048x1024", 2048, 1024, None)
    if rec["ops"] != "banded":
        fail(f"poisson2048x1024 under 'auto' took the {rec['ops']} path")
    RESULTS["poisson2048x1024"] = rec
    fsub = {k: solver._aux["fsub"][k] for k in ("FwdOp", "BwdOp", "lastOp")}
    gen = torch.Generator(device="cuda").manual_seed(5)
    fp = torch.randn((fsub["lastOp"].shape[0], solver.ops.n_pad),
                     generator=gen, device="cuda", dtype=torch.float64)
    poisson_kernel = check_kernel("poisson2048x1024-factors", fsub, fp)
    del solver, f, fsub, fp
    release()
    phase_done("7 poisson2048x1024")

    # ---------------------------------------------------------- phase 8
    # the example's own size: 'auto' takes the dense path (69 MB), as the
    # JAX package does off the TPU; the banded path of the same problem
    # beside it
    dense, dsolver, dfields = poisson_run("poisson256x128", 256, 128, None)
    if dense["ops"] != "dense":
        fail(f"poisson256x128 under 'auto' took the {dense['ops']} path")
    banded, bsolver, bfields = poisson_run("poisson256x128 banded", 256, 128,
                                           "banded")
    dense["banded"] = banded
    dense["banded_vs_dense_rel"] = rel_diff(solution_of(bfields),
                                            solution_of(dfields))
    log("poisson256x128 dense vs banded: solve ms "
        f"{dense['solve_ms']:.4f} vs {banded['solve_ms']:.4f}, factor s "
        f"{dense['factor_s']:.4f} vs {banded['factor_s']:.4f}, solutions "
        f"{dense['banded_vs_dense_rel']:.3e} apart")
    RESULTS["poisson256x128"] = dense
    if not dense["banded_vs_dense_rel"] <= 1e-12:
        fail("poisson256x128: banded and dense solutions differ by "
             f"{dense['banded_vs_dense_rel']:.3e}")
    del dsolver, dfields, bsolver, bfields
    release()
    phase_done("8 poisson256x128")

    # ---------------------------------------------------------- phase 9
    # the nonlinear BVPs (dense under 'auto') and the EVPs (host
    # eigensolves) launch no substitution
    RESULTS["bratu"] = dense_path("bratu256", lambda: bratu_phase(256))
    release()
    phase_done("9 bratu256")

    # --------------------------------------------------------- phase 10
    RESULTS["rbevp"] = dense_path(
        "rbevp64", lambda: rbevp_phase(64, np.linspace(3.0, 3.25, 5)))
    release()
    phase_done("10 rbevp64")

    # --------------------------------------------------------- phase 11
    RESULTS["waves"] = dense_path("waves128", lambda: waves_phase(128))
    release()
    phase_done("11 waves128")

    # --------------------------------------------------------- phase 12
    # the sphere: progression config 4 through the banded kernel at q = 7
    for name in fusedstep.LAUNCHES:
        fusedstep.LAUNCHES[name] = 0
    RESULTS["sw"], sw_kernel = sw_phase(*SW_SIZE, SW_STEPS)
    release()
    phase_done("12 sw512x256")

    # --------------------------------------------------------- phase 13
    # complex banded solves on the card (the complex instantiations)
    RESULTS["complex_poisson"], complex_kernels = complex_phase(1024, 512)
    release()
    phase_done("13 complex poisson1024x512")

    # --------------------------------------------------------- phase 14
    # 3-D Rayleigh-Benard at config 5's one-card size through the kernel
    # at q = 80
    reset_launches()
    RESULTS["rb3d"], rb3d_kernel = rb3d_phase(RB3D_SIZE, RB3D_STEPS)
    release()
    phase_done("14 rb3d_128")

    # --------------------------------------------------------- phase 15
    # a complex IVP through the complex kernel
    RESULTS["complex_ivp"] = complex_ivp_phase(*CIVP_SIZE, CIVP_STEPS)
    release()
    phase_done("15 complex ivp1024x512")

    # --------------------------------------------------------- phase 16
    # the [fusion] and [precision] layers: their cells ran on the solvers
    # of phases 3, 4, 6, 12 and 14 (no builds of their own); the summary
    fp = RESULTS["fusion_precision"]
    fp["shear512"] = RESULTS["shear"]["plans"]
    fp["sw512x256"] = RESULTS["sw"]["plans"]
    fp["rb3d_128"] = RESULTS["rb3d"]["plans"]
    keys = ("steps_per_s", "max_rel_diff_vs_default", "bound", "launches",
            "factor_store_bytes", "achieved_residual", "solve_ms",
            "rhs_eval_ms", "fused_nodes")
    summary = {cell: {name: {k: rec[k] for k in keys if k in rec}
                      for name, rec in plans.items() if "plan" in rec}
               for cell, plans in fp.items()}
    summary["card"] = card
    log("fusion and precision " + json.dumps(summary))
    phase_done("16 fusion and precision")

    # --------------------------------------------------------- phase 17
    # gradients: diffusion64 (the JAX package's adjoint benchmark problem,
    # dense: no kernel) wrt the initial state, a and f; then the summary
    # of every gradient cell (phases 3, 4, 12, 15 and this one)
    from dedalus_tpu_torch.extras.bench_problems import \
        build_diffusion_solver
    dsolver = build_diffusion_solver(64, device="cuda")
    gradient_cell("diffusion64", dsolver, 1e-3, DIFFUSION_STEPS, (None, 1),
                  wrt=("initial_state", "a", "f"))
    del dsolver
    release()
    grads = RESULTS["gradients"]
    summary = {cell: [{k: run.get(k) for k in (
        "K", "forward_s", "value_and_grad_s", "grad_forward_ratio",
        "peak_GB", "forward_launches", "backward_launches",
        "recompute_launches", "host_syncs")} for run in rec["runs"]]
        for cell, rec in grads.items()}
    summary["card"] = card
    log("gradients " + json.dumps(summary))
    phase_done("17 gradients")

    # --------------------------------------------------------- phase 18
    # the polar geometry: the annulus and disk examples at their sizes,
    # dense (no kernel: each cell's counts must stay 0)
    RESULTS["polar"] = {}
    for cell, run in (
            ("annulus%dx%d" % ANNULUS_SIZE,
             lambda: annulus_phase(ANNULUS_SIZE, ANNULUS_CFL_STEPS,
                                   ANNULUS_STEPS)),
            ("disk_libration%dx%d" % DISK_SIZE,
             lambda: disk_phase(DISK_SIZE, DISK_STEPS))):
        RESULTS["polar"][cell] = dense_path(cell, run)
        release()
    summary = {cell: {k: rec.get(k) for k in (
        "pencil_shape", "ops", "build_s", "factor_s", "steps_per_s",
        "max_memory_allocated_GB", "allocated_before_build_GB",
        "host_syncs_per_step")}
        for cell, rec in RESULTS["polar"].items()}
    for cell, rec in RESULTS["polar"].items():
        sm = rec["step_many"]
        summary[cell].update({
            "loop_steps_per_s": sm["loop_steps_per_s"],
            "block_steps_per_s": sm["block_steps_per_s"],
            "replay_bit_equal": sm["replay_bit_equal"],
            "host_syncs_per_block": sm["host_syncs_per_block"],
            "idle_share": [sm["profile_loop"]["idle_share"],
                           sm["profile_block"]["idle_share"]],
            "kernels_per_step": [sm["profile_loop"]["kernels_per_step"],
                                 sm["profile_block"]["kernels_per_step"]],
            "substitution_launches":
                RESULTS["dense_path_launches"][cell]})
    summary["card"] = card
    log("polar " + json.dumps(summary))
    phase_done("18 polar")

    # --------------------------------------------------------- phase 19
    # the spherical shell: the shell_convection example at its size, dense
    # (no kernel: its counts must stay 0); the rotating shell at its own
    # size, banded through the kernels' large range (the slice's main
    # path: its launches counted from 0 around the factor and the steps);
    # the complex shell (an LBVP card vs CPU, the rotating-convection EVP)
    RESULTS["shell"] = {}
    cell = "shell_convection%dx%dx%d" % SHELL_SIZE
    RESULTS["shell"][cell] = dense_path(
        cell, lambda: shell_phase(SHELL_SIZE, SHELL_STEPS))
    release()
    rotconv_label = "rotconv%dx%dx%d" % ROTCONV_SIZE
    RESULTS["shell"][rotconv_label], rotconv_kernel = rotconv_phase(
        ROTCONV_SIZE, ROTCONV_STEPS)
    release()
    RESULTS["complex_shell"] = dense_path(
        "complex shell", lambda: complex_shell_phase(EVP_SIZE))
    release()
    summary = {cell: {k: rec.get(k) for k in (
        "pencil_shape", "ops", "q", "NB", "pins", "build_s",
        "build_phases_s", "factor_s", "woodbury_ms", "steps_per_s",
        "max_memory_allocated_GB", "allocated_before_build_GB",
        "host_syncs_per_step", "floored_pivots", "card_vs_cpu_rel",
        "launches", "expected_launches", "breakdown_ms")}
        for cell, rec in RESULTS["shell"].items()}
    summary["complex_shell"] = RESULTS["complex_shell"]
    for cell, rec in RESULTS["shell"].items():
        if cell in RESULTS["dense_path_launches"]:
            summary[cell]["substitution_launches"] = \
                RESULTS["dense_path_launches"][cell]
        sm = rec.get("step_many")
        if sm is not None:
            summary[cell].update({
                "loop_steps_per_s": sm["loop_steps_per_s"],
                "block_steps_per_s": sm["block_steps_per_s"],
                "replay_bit_equal": sm["replay_bit_equal"],
                "host_syncs_per_block": sm["host_syncs_per_block"],
                "idle_share": [sm["profile_loop"]["idle_share"],
                               sm["profile_block"]["idle_share"]],
                "kernels_per_step": [
                    sm["profile_loop"]["kernels_per_step"],
                    sm["profile_block"]["kernels_per_step"]]})
    summary["card"] = card
    log("shell " + json.dumps(summary))
    phase_done("19 shell")

    # --------------------------------------------------------- phase 20
    # the ball: internally heated convection at the example's size, banded
    # under 'auto' (the slice's main path: its launches counted from 0
    # around the factoring steps and the timed ones); Lane-Emden and the
    # complex ball, dense (no kernel: their counts must stay 0)
    ball_label = "ball_convection%dx%dx%d" % BALL_SIZE
    RESULTS["ball"] = {}
    RESULTS["ball"][ball_label], ball_kernel = ball_phase(BALL_SIZE,
                                                          BALL_STEPS)
    release()
    le_label = "lane_emden%d" % LANE_EMDEN_NR
    RESULTS["ball"][le_label] = dense_path(
        le_label, lambda: lane_emden_phase(LANE_EMDEN_NR, LANE_EMDEN_N))
    release()
    RESULTS["ball"]["complex_ball"] = dense_path(
        "complex ball", complex_ball_phase)
    release()
    brec = RESULTS["ball"][ball_label]
    summary = {ball_label: {k: brec.get(k) for k in (
        "pencil_shape", "ops", "q", "NB", "pins", "kl", "ku", "pin_swaps",
        "build_s", "build_phases_s", "factor_s", "woodbury_ms",
        "steps_per_s", "max_memory_allocated_GB",
        "allocated_before_build_GB", "host_syncs_per_step",
        "floored_pivots", "card_vs_cpu_rel", "launches",
        "expected_launches", "factorizations", "breakdown_ms")}}
    sm = brec["step_many"]
    summary[ball_label].update({
        "loop_steps_per_s": sm["loop_steps_per_s"],
        "block_steps_per_s": sm["block_steps_per_s"],
        "replay_bit_equal": sm["replay_bit_equal"],
        "host_syncs_per_block": sm["host_syncs_per_block"],
        "idle_share": [sm["profile_loop"]["idle_share"],
                       sm["profile_block"]["idle_share"]],
        "kernels_per_step": [sm["profile_loop"]["kernels_per_step"],
                             sm["profile_block"]["kernels_per_step"]],
        "kernel_ms": ball_kernel["ms"],
        "kernel_share_of_bound": ball_kernel["share_of_bound"]})
    summary[le_label] = {k: RESULTS["ball"][le_label][k] for k in (
        "iterations", "s_per_iteration", "R", "R_error", "build_s")}
    summary["complex_ball"] = RESULTS["ball"]["complex_ball"]
    summary["card"] = card
    log("ball " + json.dumps(summary))
    phase_done("20 ball")

    # --------------------------------------------------------- phase 21
    # both kernels past q = 128 at random operators in every dtype
    RESULTS["large_q_kernels"] = large_q_kernels()
    phase_done("21 large-q kernels")

    # --------------------------------------------------------- phase 22
    # the cylinder: the pipe at 64x64x48 (the slice's main path, dense
    # under 'auto': its counts set to 0 around its steps and read after;
    # every cell here runs inside dense_path), the example's diffusion,
    # an annulus-cylinder LBVP and the pipe-flow EVP
    cylinder_phase(card)
    phase_done("22 cylinder")

    # --------------------------------------------------------- phase 23
    # the ensemble fleets: rb256x64_ensemble (banded: every solve of a
    # fleet step one launch with the members as columns, counted from 0
    # around each fleet) and diffusion64_ensemble (dense)
    fleet_phase(card)
    phase_done("23 fleets")

    # --------------------------------------------------------- phase 24
    # the coupled pencils: the m-coupled annulus at 256x64 (banded, one
    # pencil group: its counts set to 0 around its build and solves, and
    # around its steps), the disk's coupled pencils (dense), the
    # Chebyshev^2 rectangle at q = 496 and past the kernel's limit, and a
    # joint NCC (dense)
    coupled = RESULTS["coupled"] = coupled_phase(card)
    phase_done("24 coupled pencils")

    # --------------------------------------------------------- phase 25
    # the run-side tools at RB 2048x1024 with both layers on: the
    # resilient loop's clean run, resume, NaN, bit flip and SIGTERM
    # (their launches counted from 0 around each loop), host reads of
    # single steps, steps/s with the layers on and off
    runside = RESULTS["runside"] = runside_phase(card)
    phase_done("25 run-side tools")
    # times and bound at each kernel's main path shapes (the solve's
    # kernel at rb3d_128's own factor operators, q = 80, f64; the
    # transposed solve's at the rb2048x1024 shapes, the gradients' main
    # path, in f64, and at the sphere's operators in bf16); the errors are the worst over every kernel-vs-plain
    # check (f32 and complex ones included), each also listed with its
    # relative bound, times and byte bound
    fields = ("shape", "dtype", "k", "max_abs_err", "max_rel_err",
              "bound_rel", "ms", "cold_ms", "stream_ms", "plain_ms",
              "bound_ms", "share_of_bound")

    def checks_of(name):
        return [{k: rec[k] for k in fields + (
            ("forward_ms", "identity_rel") if "_T" in name else ())}
            for rec in RESULTS["kernel_checks"] if rec["kernel"] == name]

    checks, bf16_checks = checks_of("banded_subst"), \
        checks_of("banded_subst_bf16")
    grad_paths = {f"{cell} value_and_grad K={run['K']}": run
                  for cell, rec in grads.items() for run in rec["runs"]
                  if "forward_launches" in run}
    by_path = {"rb256x64": launches["banded_subst"],
               f"rb{Nx}x{Nz}": real["launches"],
               "poisson2048x1024": RESULTS["poisson2048x1024"]["launches"],
               "poisson256x128 banded": banded["launches"],
               "poisson256x128 dense": dense["launches"],
               "sw512x256": RESULTS["sw"]["launches"],
               "complex poisson1024x512":
                   RESULTS["complex_poisson"]["launches"],
               "rb3d_128": RESULTS["rb3d"]["launches"],
               "complex ivp1024x512": RESULTS["complex_ivp"]["launches"],
               rotconv_label: RESULTS["shell"][rotconv_label]["launches"][
                   "banded_subst"],
               ball_label: brec["launches"]["banded_subst"],
               **{f"{path} step_many": rec["step_many"]["launches"]["replay"]
                  for path, rec in (("rb256x64", main), ("kdv1024",
                                                          RESULTS["kdv"]),
                                    ("shear512", RESULTS["shear"]),
                                    ("sw512x256", RESULTS["sw"]),
                                    ("rb3d_128", RESULTS["rb3d"]),
                                    (ball_label, brec))},
               **{path: run["launches_value_and_grad"]["banded_subst"]
                  for path, run in grad_paths.items()},
               **RESULTS["dense_path_launches"],
               **{f"{cell} N={N}": run["launches"]
                  for cell, rec in RESULTS["fleets"].items()
                  for N, run in rec["fleets"].items() if "launches" in run},
               "rb256x64_ensemble per-member dt": RESULTS["fleets"][
                   "rb256x64_ensemble"]["per_member_dt"]["launches"],
               AZNCC_LBVP: coupled[AZNCC_LBVP]["launches"],
               AZNCC_IVP: coupled[AZNCC_IVP]["launches"],
               AZNCC_IVP + " step_many": coupled[AZNCC_IVP][
                   "step_many"]["launches"]["replay"],
               f"poisson_rect{RECT_N}": coupled[f"poisson_rect{RECT_N}"][
                   "launches"],
               "rb%dx%d run-side" % RUNSIDE_SIZE: runside["launches"]}
    # each transposed entry's main path: the rb2048x1024 value_and_grad,
    # and for the bf16 one the sphere's gradient under the bf16 ladder
    main_grad = {"banded_subst_T": grads[f"rb{Nx}x{Nz}"]["runs"][0],
                 "banded_subst_T_bf16": grads[
                     f"sw{SW_SIZE[0]}x{SW_SIZE[1]} bf16"]["runs"][0]}
    t64, tbf16 = (transposed[torch.float64],
                  RESULTS["sw"]["transposed_kernel_bf16"])
    kernels = {"kernels": [{
        "name": "banded_subst", "route": "cuda",
        "source": "dedalus_tpu_torch/csrc/banded_subst.cu",
        "replaces": "dedalus_tpu/core/fusedstep.py:520",
        "launches": RESULTS["rb3d"]["launches"],
        "launches_by_path": by_path,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "max_rel_err": max(c["max_rel_err"] for c in checks),
        "ms": rb3d_kernel["ms"], "cold_ms": rb3d_kernel["cold_ms"],
        "stream_ms": rb3d_kernel["stream_ms"],
        "plain_ms": rb3d_kernel["plain_ms"],
        "bound_ms": rb3d_kernel["bound_ms"],
        "bound_by": rb3d_kernel["bound_by"],
        "library_ms": None,
        **{path: {k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")}
           for path, rec in (("rb256x64", main_rec),
                             (rotconv_label, rotconv_kernel),
                             (rotconv_label + " woodbury",
                              RESULTS["shell"][rotconv_label][
                                  "woodbury_kernel"]),
                             (ball_label, ball_kernel),
                             (ball_label + " woodbury",
                              brec["woodbury_kernel"]),
                             ("sw512x256", sw_kernel),
                             ("rb3d_128 woodbury",
                              RESULTS["rb3d"]["woodbury_kernel"]),
                             ("poisson2048x1024", poisson_kernel),
                             ("complex128 poisson1024x512",
                              complex_kernels[0]),
                             ("complex64 poisson1024x512",
                              complex_kernels[1]),
                             (f"rb256x64_ensemble k={FLEET_KERNEL_K}",
                              RESULTS["fleets"]["rb256x64_ensemble"][
                                  "fleets"][FLEET_KERNEL_K]["kernel"]),
                             *coupled["kernels"].items())},
        "checks": checks}, {
        # the bf16 instantiation (SOLVE_DTYPE = bf16): its main path is
        # rb256x64 under the bf16 ladder, its times at that factor's
        # operators cast to bf16
        "name": "banded_subst_bf16", "route": "cuda",
        "source": "dedalus_tpu_torch/csrc/banded_subst.cu",
        "replaces": "dedalus_tpu/core/fusedstep.py:520",
        "launches": fp["rb256x64"]["bf16"]["launches"]["banded_subst_bf16"],
        "launches_by_path": {
            **{cell: plans["bf16"]["launches"]["banded_subst_bf16"]
               for cell, plans in fp.items() if "bf16" in plans},
            **{path: run["launches_value_and_grad"]["banded_subst_bf16"]
               for path, run in grad_paths.items()
               if run["launches_value_and_grad"]["banded_subst_bf16"]}},
        "max_abs_err": max(c["max_abs_err"] for c in bf16_checks),
        "max_rel_err": max(c["max_rel_err"] for c in bf16_checks),
        "ms": bf16_rec["ms"], "cold_ms": bf16_rec["cold_ms"],
        "stream_ms": bf16_rec["stream_ms"], "plain_ms": bf16_rec["plain_ms"],
        "bound_ms": bf16_rec["bound_ms"], "bound_by": bf16_rec["bound_by"],
        "library_ms": None, "checks": bf16_checks}]}
    # the transposed solve's kernel (the backward pass of every sequential
    # banded solve): its main path is the rb2048x1024 value_and_grad, its
    # times at those shapes; the bf16 entry's main path is the sphere's
    # bf16 gradient, its times at those operators in bf16 (q = 7; the
    # rb2048x1024 bf16 row stays among its checks); the JAX package
    # transposes its XLA scan there (no Pallas kernel)
    for name, rec in (("banded_subst_T", t64),
                      ("banded_subst_T_bf16", tbf16)):
        tchecks = checks_of(name)
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "dedalus_tpu_torch/csrc/banded_subst.cu",
            "replaces": "dedalus_tpu/libraries/pencilops.py:147",
            "launches": main_grad[name]["launches_value_and_grad"][name],
            "launches_by_path": {
                path: run["launches_value_and_grad"][name]
                for path, run in grad_paths.items()
                if run["launches_value_and_grad"][name]},
            "max_abs_err": max(c["max_abs_err"] for c in tchecks),
            "max_rel_err": max(c["max_rel_err"] for c in tchecks),
            "ms": rec["ms"], "cold_ms": rec["cold_ms"],
            "stream_ms": rec["stream_ms"], "plain_ms": rec["plain_ms"],
            "forward_ms": rec["forward_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "checks": tchecks})
    for entry in kernels["kernels"]:
        if not any(entry["launches_by_path"].values()):
            fail(f"{entry['name']} was launched on no path of this run")
    RESULTS["kernels"] = kernels["kernels"]
    phase_done("kernels line")
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
