#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line (with `at_s`, the seconds since the
script started); any failure raises, so the script
exits non-zero and never prints the final `"ok": true` line:

  1. device  — nvidia-smi name and power limit, torch/CUDA versions; TF32
               off for matmuls and cuDNN.
  2. build   — the four kernel sources under `hank_tpu_torch/csrc/` (the
               one-asset and the two-asset household sweeps, the two-asset
               f64 residual pair, and the one-asset sweeps on a
               thread-block cluster), one nvcc each (sm_90a) started
               together, with the build seconds and ptxas' registers and
               spill bytes per kernel (the f64 pair's six kernels, single
               and batched, the global-list forward push's two among them,
               required not to spill; the six batched two-asset kernels and
               the four global-list forward kernels singled out); the
               global-list forward kernels, kernel 5 and the f64 backward
               within a block at 50×70, 48×64 and 64×64 (×5×2) by the
               libraries' counts, and how many grids past 2048 asset states
               up to 4096 the global-list ones take; the f64 pair's shared memory on its
               default clusters, required to fit at 40×20×5×2, and how many
               of the grids the previous kernels 5 and 6 take it takes;
               every one-asset grid (n_e ≤ 20) the counting template takes
               in one block fits kernels 2-4 and the f64 tangent sweep too,
               in all three arithmetics, and every grid the previous kernel
               7 takes fits kernel 7 (the library's counts); the kernel
               maps' fit check at n_e = 7 on both sides of each
               kernel's limit (kernel 2 n_a 1036/1037, kernel 1 1147/1148,
               kernels 3-4 1148/1149, the f64 tangent sweep 529/530), the
               decision one past each picking the cluster instantiation
               (on both sides of its own limit per block on a cluster of
               7: 2694/2695 in kernel 2's place, 3597/3598 in kernel 1's
               and kernels 3-4's, 1660/1661 in the f64 tangent sweep's,
               with the card holding such a cluster, and the decision one
               past it the global-state one); each global-state one on
               both sides of its own limit (5390/5391 in kernel 2's place,
               10792/10793 in kernel 1's and kernels 3-4's, 4980/4981 in
               the f64 tangent sweep's), the decision raising past it; the
               five cluster instantiations built (ptxas' registers and
               spills; the three values-only or batched ones required not
               to spill); the ranged kernel's
               nine instantiations built (ptxas' registers and spills
               reported) and, from `nvcc -ptx`, each global-state one with
               as many `ld.global.nc` loads as the shared-state ones of its
               arithmetic (no load of its state workspace takes the
               read-only path); the SASS of kernel 1, of the previous
               kernel 7 and of the template's and the ranged kernel's
               earlier instantiations (these under their <..., false>
               names), and of every single-path kernel of the two
               two-asset libraries (the cluster kernels as their <false>
               instantiations, the forward ones as <false, false>, and the
               four global-list forward kernels as first built) and of the
               cluster library's five kernels
               (the two tangent ones as their <..., false> instantiations),
               against the previous builds'
               (`hank_tpu_torch/tools/sass_reference.json`, per library,
               compared where nvcc is the same), where the seven batched
               f64 tangent instantiations are recorded as first built too.
               Since the batched f64 directions: the ranged kernel's
               eleven instantiations (six global-state), the cluster
               library's six, the f64 library's eight tangent ones (the
               backward ones not spilling) and ten batched two-asset ones;
               the seven new ones' registers and spills reported
               (`ptxas_of_this_pr`); the batched f64 tangent sweep's fit
               decisions at its three tiers' limits (529/530, 1660/1661,
               4980/4981 at n_e = 7, the last raising naming fused='xla').
  3. setup   — Krusell-Smith 200×7, T=300 on the card: both steady states
               (max|F_ss| ≤ 1e-9 each, `find_ss`'s own stopping target) and
               the steady-state Jacobian J̄.
  4. kernels — the warm-up run of the headline solve (permanent TFP shock
               Z 1→2, Newton-Krylov, f32 directions, eps 1e-8, GMRES
               restart 10, from x_ss), then each kernel against its plain
               PyTorch version on the card at the main path's shapes:
               kernel 1 within 3e-5·max(scale, 1) at x_ss, at the warm-up's
               solution and at a smooth seeded point near x_ss (seeded v),
               and exactly zero tangents for a zero direction; kernel 2
               within 1e-11. Then kernel 1 against the previous kernel 1
               (the counting template's B = 1 launch,
               `fused_sweep_jvp_batch_previous` on one row), bit for bit on
               all four outputs, at those three points and at three inputs
               that take its fallback branches: V_T with seeded positive
               noise, V_T with one NaN, the grid with two adjacent knots
               swapped; and kernel 2 against the previous kernel 2
               (`fused_residual_sweep_previous`) bit for bit at the same six
               inputs in f64; the counts of rows that took each branch are
               reported. The f64 tangent sweep (`fused_sweep_jvp_f64`,
               `<double, true, false>`) against its yardstick, the counting
               template's `<double, true, false>`
               (`fused_sweep_jvp_f64_previous`), bit for bit on all four
               outputs at the same six inputs in f64, within
               1e-10·max(scale, 1) of its plain version in f64 at the three
               points (on their last CHECK_PERIODS = 100 periods, a depth
               cut for the time limit), and a zero tangent exactly zero. Median ms per
               sweep of kernel 1, the previous kernel 1, kernel 2 and the
               previous kernel 2, the f64 tangent sweep and its yardstick
               (in turns: previous, new, new, previous) and kernel 2's
               plain version, and one timed run each of kernel 1's and the
               f64 tangent sweep's. The global-state instantiations
               (`household_sweep_ranged_kernel<S, TANGENT, BATCHED, true>`)
               against the one-block kernels whose places they take, bit
               for bit on every output and fallback count at the same six
               inputs (the stress inputs taking their fallback branches):
               `<float, true, false, true>` against kernel 1,
               `<double, false, false, true>` against kernel 2,
               `<double, true, false, true>` against the f64 tangent sweep.
               The single-path cluster instantiations
               (`household_sweep_cluster_kernel<S, TANGENT, false>`, one
               cluster of 7 blocks, one income row a block) the same way
               against kernel 1, the f64 tangent sweep and kernel 2, and
               timed in turns with them at the solution (one-block,
               cluster, cluster, one-block).
  5. solve   — 3 timed runs of the same solve. The launch counters are zeroed right
               before the timed runs; both kernels must have launched and
               neither plain version nor a previous kernel been called. The
               timed runs must return
               bit-identical paths, and ‖F‖ re-evaluated by the plain f64
               pipeline must be < 1e-8.
  6. ensemble — B=64 shock paths Z_b,t = 2 − ρ_bᵗ, ρ_b = 0.5 + 0.4·b/B, from
               x_ss on every row (the workload of scripts/measure_ensemble.py),
               through `solve_ensemble_host` and the path-batched kernels.
               One warm-up Newton-Krylov solve, then: the batched kernel 1
               (kernels 3-4) at x_ss and at the warm-up's rows (smooth
               seeded v), every row bit-identical to a single kernel-1
               launch, rows {0, 63} within 3e-5·max(scale, 1) of the
               plain version run in float64 on the same input values, a
               zero tangent exactly zero; the batched kernel 2 at
               the warm-up's rows, every row bit-identical to a single
               kernel-2 launch, rows {0, 63} within 1e-11 of the plain
               version. Both batched kernels against their previous kernels
               (the counting template), bit for bit on every row at x_ss, at
               the warm-up's rows and on the grid with two knots swapped
               (fallback rows required there), each timed in turns with its
               previous kernel on a few rows and on all B. The batched
               global-state instantiations bit for bit kernels 3-4 and the
               batched kernel 2 on every row at the same three inputs, and
               every row of a B=16 launch of each bit for bit a single-path
               global-state launch (the warm-up's rows, the swapped grid);
               the batched cluster instantiations (on the cluster the rule
               takes at B = 64) the same way against kernels 3-4 and the
               batched kernel 2, each row of a B=16 launch bit for bit a
               single-path cluster launch, each timed in turns with its
               one-block kernel at B=16.
               Then 3 timed
               Newton-Krylov solves (counters zeroed right before: both
               batched kernels launched, neither plain version nor a
               previous kernel called; bit-identical paths; ‖F‖ ≤ 1e-8 on
               every row, no stalled path; the plain f64 pipeline's ‖F‖ <
               1e-8 on rows 0, 63 and the worst row), the gap of row 63 to
               the single-path solve of its shock (reported), one boehl
               Richardson solve to the same bounds, and the ms per launch of
               kernels 3-4 and of the previous kernels, in turns, at
               B ∈ {1, 64, 132, 256, 1024}, with the plain version's at B=4.
               Then f64 directions: the batched f64 tangent sweep
               (`<double,true,true>`) at the warm-up's rows along smooth
               seeded f64 directions at B = 1, 16, 64 (and on the swapped
               grid at 16), every row and fallback count bit for bit a
               single `fused_sweep_jvp_f64` launch, every output bit for
               bit the template's `<double,true,true>`, the two timed in
               turns; row 0 within 1e-10·max(scale, 1) of its plain
               version; and the ensemble with f64 directions
               (`direction_dtype=None`, GMRES to 1e-12): a warm-up and 3
               timed solves, only the batched f64 tangent sweep and the
               batched kernel 2 launched (no plain version, single-path or
               f32 kernel, previous kernel, or plain F or AD direction),
               bit-identical, every row ‖F‖ ≤ 1e-8, re-checked by the plain
               f64 pipeline on rows 0 and 63 and by the batched kernel 2
               on every row, and within 1e-7 of the f32 ensemble's row.
  7. two-asset — `hank_two_asset` at its published width (40×20×5×2,
               `hank_tpu/models/hank_two_asset.yaml`), T=300, fiscal shock G
               from `generate_exog_paths`. Setup: the one steady state of the
               transitory shock and J̄ by `get_or_solve` into a fresh
               temporary cache (timed); max|F_ss| ≤ 1e-9, B = Bg and A = KS
               to 1e-8, every steady-state variable within 1e-8 of the JAX
               package's (`hank_tpu_torch/data/hank_two_asset_T300_jax_cpu.npz`).
               The route is `bench.py:282-310`'s: when the linear step beats
               the forcing (‖F(x_lin)‖ < ‖F(x_ss)‖), the linear impulse
               response, then the GMRES-endgame-only boehl solve (host_inner,
               richardson_max_outer=0); when it does not, or that solve misses
               EPS, the two-phase boehl solve from x_ss (Richardson, then the
               endgame); f32 directions through kernels 5-6, eps = EPS. One
               warm-up run of it. Kernels 5 and 6 at x_ss and the warm-up's
               solution along smooth seeded directions, against their plain
               versions run in float64 on the same inputs, within
               5e-5·max(scale, 1): kernel 5's policies pointwise, its
               tangents as kernel 6's plain version aggregates them, kernel
               6's aggregates and tangents; a zero tangent exactly zero,
               repeated launches bit-identical, an i.i.d. direction reported
               only. Kernel 5 (the thread-block cluster) against the previous
               kernel 5 (one block), bit for bit on all six outputs (NaNs
               included), at x_ss, the solution and a smooth seeded point
               along smooth seeded directions, and at three stress inputs:
               V_T with seeded positive noise, V_T with one NaN (which must
               give NaN), an illiquid return that caps every a' of a > 0;
               and on seeded inputs at 24×12×3×2, 12×8×17×2 (16 blocks, one
               holding two incomes), 48×24×2×2 and 60×60×1×2 (the kernel's
               other layouts). Kernel 6 (the thread-block cluster)
               against the previous kernel 6 (one block), bit for bit on all
               six outputs (NaNs included), on kernel 5's policies at x_ss,
               the solution and a smooth seeded point, and at three stress
               inputs: every liquid policy on the first knot, 1% i.i.d.
               noise on the policies, one NaN policy (which must give NaN).
               ms per launch of each kernel (kernels 5 and 6 each with its
               previous one in turns: previous, new, new, previous), of the
               plain versions, of the kernel pair's jvp_dir and the plain
               f32 one (one run), and of the f64 F; both kernels' cluster
               sizes and all four kernels' ptxas registers and spills; the
               shared memory of kernel 5 (kernel 6), by the library's own
               count, within one block at every grid the previous kernel 5
               takes (the previous kernel 6 takes with at least 6 knots on
               each asset axis); and kernel 6 bit for bit against the
               previous one at 38×38×2×2 (a grid that keeps fewer counts for
               room) on seeded policies.
               The f64 residual pair (`ops/fused_residual2.py`, every
               full-precision F of the route) at x_ss, the solution and the
               smooth point: its F within 1e-11 of the plain f64 F, the
               backward kernel's policies pointwise within
               1e-10·max(scale, 1) of the plain backward scan (largest gaps
               reported), the forward kernel's aggregates within 1e-11 of
               `forward_iteration` on the same policies; repeats
               bit-identical, a NaN in V_T giving NaN; ms per F of the pair
               and of the plain F, and of each kernel and its plain version.
               Then 3 timed runs of the route (counters zeroed right
               before: kernels 5-6 and the f64 pair launched, no plain
               version, no previous kernel and no plain f64 F called;
               paths bit-identical to the warm-up's; the plain f64 ‖F‖ < EPS;
               within 1e-6 of the JAX package's root; `prof["F"]`
               reported), and the other route
               once: the two-phase one (to ‖F‖ < EPS) after a certified
               endgame-only route, else the endgame-only one cut at 2 outers,
               reported only. (The script's time limit: the plain f32
               direction is timed once, and the checks of kernels 5-6 and
               the cut route are kept to these depths.) Then the f64
               directions: the f64 tangent pair
               (`fused2_policies_jvp_f64`, `fused2_forward_jvp_f64`; its
               shared-state backward and shared-list forward push at this
               grid) at x_ss and the solution on kernels 5-6's inputs
               there in f64 (whose plain run kernel 5's check made) and at
               the smooth point along a smooth seeded direction, each
               kernel pointwise within 1e-9·max(scale, 1) of its plain
               version in f64 (the largest gaps reported), its primal bit
               for bit the f64 pair's,
               repeats bit-identical, a zero tangent exactly zero; ms per
               launch of each and of the f64 pair, the plain versions' ms,
               and one timed plain f64 direction (`ad_direction` of the
               plain F, the route f64 directions took on the card before),
               the pair's jvp_dir within 1e-9·max(scale, 1) of it. Then the
               CLI's default, `hank_tpu_torch.run.main(["--model",
               "hank_two_asset"])` (Newton-Krylov with f64 directions; its
               steady state and J̄ read from this phase's cache), counters
               zeroed right before: the tangent pair and the f64 pair
               launched and nothing else (no AD direction, plain version,
               plain f64 F or f32 kernel 5-6); ‖F‖ < 1e-8 by the plain f64
               pipeline, within 1e-6 of the JAX CPU root; and the same
               default solve timed, 3 runs.
  8. driver  — `hank_tpu_torch.run` on the two other one-asset families at
               their published widths (DRIVER_CASES: one-asset HANK 50×7,
               T=300, monetary shock; large-grid KS 500×7, T=150, kinked ZLB
               shock; both from `generate_exog_paths`), with a fresh artifact
               cache (HANK_TPU_TORCH_CACHE). Per model: setup by
               `get_or_solve` (timed; max|F_ss| ≤ 1e-9, the steady state
               within 1e-8 of the JAX package's CPU one), the CLI once
               (`main([... "--mixed", "--method", "newton_krylov", "--eps",
               "1e-8"])`, the warm-up), kernels 1 and 2 at x_ss and at its
               solution against their plain versions at phase 4's bounds
               (smooth seeded directions; kernel 1's plain version in float64
               on the same f32 inputs), kernel 1 bit for bit against the
               previous kernel 1 at x_ss, the solution and a smooth seeded
               point, kernel 2 bit for bit against the previous kernel 2 at
               the same points in f64 and on the grid with two knots
               swapped, with the ms of kernels 1-2 and of their previous
               kernels at these shapes and the shared memory they take, then
               3 timed `solve_model` calls (counters zeroed right before:
               both kernels launched, no plain call and no previous kernel;
               paths bit-identical to the CLI's; plain-f64 ‖F‖ < 1e-8;
               within 1e-7 of the JAX package's CPU root in
               `hank_tpu_torch/data/`; the economics of the JAX package's
               tests). Then the CLI without --mixed once per model (its
               default: f64 directions through the f64 tangent sweep,
               kernel-2 residuals), counters zeroed right before: the
               f64 tangent sweep launched, no AD direction and no plain or
               previous kernel; plain-f64 ‖F‖ < 1e-8 and within 1e-7 of the
               JAX CPU root; seconds, outers and directions. At large-grid
               500×7 the five global-state instantiations bit for bit
               their one-block kernels at phase 8's points (the batched
               ones on 16 rows of them) and on the swapped grid, and timed
               in turns with them (one-block, global, global, one-block):
               the price of global memory at a grid both take; the five
               cluster instantiations the same way against kernel 1, the
               f64 tangent sweep, kernel 2 and the batched kernels (B=16).
               Then large-grid KS at 1200×7, T=150 (LARGE_GRID_CASE, past
               every one-block kernel's shared memory): setup by
               `get_or_solve` (timed; max|F_ss| ≤ 1e-9, within 1e-8 of the
               JAX CPU steady state), every one-asset map deciding on its
               cluster instantiation; one
               warm-up each of `solve_model`'s default (Newton-Krylov, f64
               directions) and of the mixed one (f32 directions), eps
               1e-8; the three single-path cluster and global-state
               instantiations against their plain versions at x_ss, the
               default's solution and a smooth seeded point at phase 4's
               bounds, each cluster one bit for bit the global-state one
               there (outputs and fallback counts), a zero tangent exactly
               zero; 3 timed runs of each solve (counters zeroed right
               before: only the cluster instantiations of its directions
               and of kernel 2 launched, no one-block kernel, global-state
               one, plain version, AD direction or previous kernel;
               bit-identical; plain-f64 ‖F‖ < 1e-8; within 1e-7 of
               the JAX CPU root `ks_large_grid_1200x7_T150_jax_cpu.npz`;
               the ZLB economics); then a B=16 Newton-Krylov ensemble of
               the model's own kinked shock at ρ_b = 0.75 + 0.2·b/16 (the
               floor binding on every row) through `solve_ensemble_host`:
               the batched cluster instantiations at the warm-up's rows and
               on the swapped grid bit for bit the global-state ones
               (outputs and fallback counts), every row of both bit for bit
               a single launch of its kind, rows 0 and 15 within phase 4's
               bounds of the plain versions; 3 timed solves (only the
               batched cluster instantiations launched, bit-identical,
               every row ≤ 1e-8 or a stalled row that mixed Newton-Krylov
               on its own shock does not bring under 1e-8 either); ms per
               launch of each instantiation at 1200×7 (each cluster one in
               turns with its global-state one) and its bound; the batched
               cluster ones at B ∈ {1, 16, 64} on the cluster the rule
               takes, and at B = 16 and 64 on clusters of 7, 6, 5 and 4 in
               turns (every such launch first held bit for bit to the
               B=16 rows), beside the card's max active clusters per size.
               f64 directions at 1200×7, as phase 6 holds them, on the
               cluster tier (`household_sweep_cluster_kernel<double,true,
               true>`, which the map must decide): rows bit for bit single
               launches at B = 1, 16, 64 (the warm-up's 16 rows cycled),
               the global-state `<double,true,true,true>` bit for bit it
               through its `_global` entry point (also at 500×7, against
               the cluster and the one-block kernel, timed in turns), row
               0 against the plain version, and the B=16 ensemble with f64
               directions (a warm-up and 3 timed solves, the same bounds
               and counters as phase 6's).
  9. forward scan — kernel 7 on the f32 savings policies of the plain
               backward block at phase 4's warm-up solution (KS 200×7, 299
               periods, from ss0.D) and at phase 8's large-grid solution
               (500×7, 149 periods): counters zeroed, one launch each and no
               plain call; each against its plain version run in float64 on
               the same f32 inputs (aggregates within 5e-5·max(scale, 1), D_T
               within 1e-6, |ΣD_T − 1| ≤ 1e-5), repeats bit-identical, ms per
               launch of kernel 7 and of the previous kernel 7 in turns
               (previous, new, new, previous) and of the plain version.
               Kernel 7 against the previous kernel 7 bit for bit on both
               outputs at both inputs and at four more on the KS policies:
               1% i.i.d. noise (fallback rows required), one NaN policy (a
               NaN aggregate in its period only), every policy below g_0 and
               every policy above g_top (no fallback row); and at the
               large-grid input on its grid with every interval halved
               (999×7, 6993 cells, past the 4096 destinations whose ranges
               kernel 7 keeps in registers); the fallback counts reported.
 10. mesh    — the sharded paths of `hank_tpu_torch/parallel/` in a one-rank
               NCCL group (`init_distributed()`, a FileStore in a temporary
               directory), destroyed at the phase's end: J̄ with its seed
               sweeps on the mesh within 1e-12 of phase 3's J̄, and bit for
               bit an unmeshed J̄ when both are built under torch's
               deterministic algorithms (the lottery's scatter_add sums with
               atomics on the card, so two J̄ builds differ in their last
               bits; an unmeshed rebuild's gap to phase 3's is reported); phase 6's B=64
               Newton-Krylov ensemble on the mesh (one warm-up, then 3 timed
               solves, counters zeroed right before: kernels 3-4 and the
               batched kernel 2 launched, no plain version and no previous
               kernel), bit for bit phase 6's paths and residual norms with
               its outers and matvecs, its median beside phase 6's; the
               state-sharded backward and forward blocks at phase 4's warm-up
               solution within 1e-12 of the unsplit blocks (whether the bits
               match is reported). Then `direct_jacobian_columns` (jvp) for
               the last period's n_endog columns at the initial steady state
               within 1e-9 of the meshed J̄ there (`tests/test_jacobian.py:84`),
               with the fd columns' gap, the gap at the ending steady state
               to J̄ there and `single_run`'s ‖F‖ reported, the AD tools and
               their J̄ on the KS model cut to T = AD_TOOLS_T = 150 (a depth
               cut for the time limit); and the port's `dryrun_multichip(1)`
               (one spawned NCCL rank: SP, TP and DP on a 16×2
               Krusell-Smith), which runs beside phase 7's host-bound setup
               (started before it; phase 7 waits for it before its first
               timed check) and is reported here. The `kernels` line's rows of
               kernels 3-4 and of the batched kernel 2 gain `launches_mesh`.
 11. two-asset ensemble — run right after phase 7, on its model, steady
               states and J̄: B=16 fiscal shocks G_b,t = s_b·ρ_bᵗ, s_b = 0.005
               + 0.005·b/(B−1), ρ_b = 0.5 + 0.4·b/B, from x_ss on every row,
               through `solve_ensemble_host` (f32 directions through the
               batched kernels 5-6, every F_b through the batched f64
               pair). One warm-up Newton-Krylov solve, then: at x_ss and at
               the warm-up's rows (smooth seeded directions) every row of
               the four batched kernels bit for bit a single-path launch, a
               zero tangent exactly zero, F_b within 1e-13 of the
               single-path pair's F (whether the bits match reported), rows
               0 and B−1 of F_b within 1e-11 of the plain f64 F; the
               batched plain versions at B = 1 on row 0 (kernel 5's
               policies and kernel 6 within 5e-5·max(scale, 1), the f64
               pair within 1e-10·max(scale, 1) and 1e-11); the card's max
               active clusters per cluster size, the cluster each kernel
               takes at B ∈ {1, 16, 64}, and where it is not the default,
               every row at that width bit for bit a single launch; ms per
               launch of each batched kernel at B ∈ {1, 16, 64}, in turns
               with the single-path kernel on one row. Then 3 timed
               Newton-Krylov solves (counters zeroed right before: all four
               batched kernels launched, no plain version, no plain f64 F
               and no single-path two-asset kernel; bit-identical paths;
               every row ‖F‖ ≤ EPS or a stalled path, not all stalled; each
               stalled row stalled in phase 7's single-path route on its own
               shock too (some of these shocks stall at kinks of F in every
               solver of the port, PERF.md §6), that route's ‖F‖ and
               gap reported for it and for row B−1; the plain f64 ‖F‖ of rows
               0, B−1 and the worst row the solver's within 1e-12 + 1e-6
               relative, and < EPS on converged rows), and one lockstep boehl
               solve, capped at 10 outers of 200 sweeps (reported). Then f64
               directions: the batched tangent pair
               (`fused2_policies_jvp_f64_batch`, `<true,true,false>`;
               `fused2_forward_jvp_f64_batch`, `<true,false,true>`) at the
               warm-up's rows along smooth seeded directions at B = 1, 16,
               64 (rows cycled), every row bit for bit a single launch of
               the single-path pair, each timed in turns with the values
               pair's batched kernel at the same width, beside the cluster
               taken and the card's max active clusters; and the ensemble
               with f64 directions (a warm-up and one timed solve; only the
               batched tangent pair and f64 pair launched, no plain
               version, single-path or f32 kernel, AD or plain F;
               bit-identical; every row the f32 solve brings to EPS at EPS
               and within 1e-7 of it; its stalled rows beside the f32
               solve's).
 12. two-asset large grid — `hank_two_asset` at 50×70×5×2, T=150
               (LARGE_TWO_ASSET: the yaml's bounds, income and access, 50
               liquid and 70 illiquid knots, the published two-asset width
               of `sequence_jacobian`'s hh_twoasset; 3,500 asset states,
               past the shared-list forward kernels' 2048), fiscal shock G
               from `generate_exog_paths`. Setup, cut: the steady state is
               the reference file's (`hank_two_asset_50x70_T150_jax_cpu.npz`,
               the one the JAX CPU root was solved from), carried across
               (the port's steady-state Newton takes ~6 min an iteration at
               this grid on the card), J̄ by
               `get_or_solve` into a fresh temporary cache (timed);
               max|F_ss| ≤ 1e-9 by the port's equations, markets to 1e-8,
               and the port's household at it a fixed point (one Bellman
               step off the value by ≤ 1e-13 and giving its policies to
               1e-10, one period of D off D by ≤ 1e-15, the aggregates
               Σ policy·D to 1e-12); the
               routes' decisions by the libraries' counts (kernel 6 and the
               f64 forward push on their global-list instantiations
               `<*, true>`, kernel 5 and the f64 backward untabled) required.
               Phase 7's route once (warm-up), then kernels 5-6 and the f64
               pair at x_ss and at its solution against their plain versions
               at phase 7's bounds (the f64 pair's F within 1e-11 of the
               plain F), repeats bit-identical; the batched global-list
               forward kernels on the solution's policies at B = 4, every
               row bit for bit the single launch, and their ms per launch at
               B = 1, 4, 16 beside the cluster `batch_cluster_of` takes; ms
               per launch of each kernel of the route and of the pair's F.
               Then 3 timed runs of the route (counters zeroed right before:
               kernel 5, the global-list kernel 6 and the f64 pair launched,
               no shared-list forward kernel, plain version, previous kernel
               or plain f64 F; bit-identical; the plain f64 ‖F‖ ≤ EPS;
               within 1e-7 of the JAX CPU root), with outers, matvecs and
               launches per solve. Phase 7 holds this PR's instantiations
               to the route's kernels at 40×20 on its own inputs: kernel 6
               on global lists bit for bit kernel 6 at its six inputs on
               clusters of 10 and 5, kernel 5 untabled kernel 5 at its six,
               the f64 backward untabled, the forward push on global lists
               and the F through it the pair's at its three points (each
               instantiation launched by its wrapper's launcher with
               `which` given), and the batched
               global-list kernels the batched shared-list ones at B = 4;
               each global-list forward kernel timed in turns with its
               shared-list one at the solution there;
               phase 2 builds the four global-list instantiations (the f64
               ones required not to spill) and requires them, kernel 5 and
               the f64 backward to fit 50×70, 48×64 and 64×64 (×5×2) by the
               libraries' counts. Then the f64 directions at 50×70: the
               tangent pair (its backward with dW and the knots' tangents
               in the workspace, `<false, true, true>`, and the global-list
               push, `<false, true, true>`, required) checked and timed as
               in phase 7 at x_ss, the solution and a smooth seeded point,
               and a Newton-Krylov solve with f64 directions from x_ss (a
               warm-up and a timed run; counters zeroed right before: only
               those two instantiations and the f64 pair launched), the
               plain f64 ‖F‖ ≤ EPS and within 1e-7 of the JAX CPU root.
               Phase 2 builds the tangent pair's four instantiations (ptxas'
               registers and spills; the two backward ones required not to
               spill) and requires, by the library's counts, the
               decisions at 40×20 (shared state, tabled; shared lists) and
               50×70 (global state, untabled; global lists), and the build
               to raise at 64×64. Then the batched tangent pair's global
               instantiations (`<true,true,true>` both) at B = 4 on x_ss,
               the solution and the smooth point, every row bit for bit a
               single launch, timed in turns with the values pair's.

Every entry of the `kernels` line carries the least time the card could
take for its timed call (`bound_ms`, `bound_by`: bytes over 3.35 TB/s
against operations over 67 TFLOP/s f32 or 34 TFLOP/s FP64, whichever is
larger) and `library_ms` null: no single PyTorch call computes a household
sweep, the forward scan or the two-asset residual. The rows of phase 11's
batched kernels give `ms` at B=16 (with `ms_B1`, `ms_B64` and the
single-path kernel's beside them), their bound from `two_asset_ops` × B,
their plain version's time at B = 1 (`plain_ms_at`) and their launches
per ensemble solve. Phase 12's six rows give the ms, plain ms, error and
bound at 50×70×5×2, T=150 (`grid`), their launches per route solve (the
two batched global-list rows 0: no ensemble runs at 50×70 here;
`main_path` says so; their ms at B=16 with `ms_B1`, `ms_B4`). The f64
tangent pair's four rows (two at 40×20, T=300, two at 50×70, T=150,
`grid`) give the ms, plain ms, error and bound of each instantiation at
its grid beside the f64 pair's kernel (`ms_values_kernel`), and their
launches in the CLI default's run (40×20) and per 50×70 f64-direction
solve. The five cluster rows give `ms`, `plain_ms`, the
error and the bound at 1200×7 (the batched ones at B=16, with their ms by
B and by cluster size), their launches in phase 8's three timed solves of
their route, `ms_global` (in turns) and their ms at 200×7 (the batched
ones at B=16) and 500×7 beside the one-block kernel's. The five
global-state rows give `ms`, `plain_ms`, the error and the bound at
1200×7 (the batched ones at B=16), their launches in phase 8's three
timed solves of their route (0: every one of them takes 1200×7 on its
cluster instantiation; `main_path` says so), and their ms at 500×7
beside the one-block kernel's (`ms_500x7`, `ms_one_block_500x7`). The
batched f64 direction rows (phase 6's `<double,true,true>` at B=64,
phase 8's cluster and global-state tiers at 1200×7, B=16, phase 11's
tangent pair at B=16 and phase 12's at B=4) give `ms` at that width with
their ms at the other widths, the template's or the values pair's beside
them, their plain version's time at B = 1 (the tangent pair's: its
single-path plain version, which its B = 1 loop is, timed in phases 7 and
12), and their launches per f64 ensemble solve (0 where no solver takes
them; `main_path` says so).
The last three lines
are the kernel summary JSON, the nvidia-smi line and `{"ok": true,
"device": {...}}`. There is no CPU path:
without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# The two-asset route's target, and the bound its result is checked at.
EPS = 1e-8

# The depth (periods) of phase 4's check of the f64 tangent sweep against
# its plain version in f64: the last CHECK_PERIODS periods of each input
# path (of 299 at T=300), cut for the script's time limit; its bit-for-bit
# checks, its timings and the plain version's timed run keep the full depth.
CHECK_PERIODS = 100

# Phase 10's horizon for the AD validation tools (the direct JVP and
# finite-difference columns of the last period against J̄ of the same
# horizon): the KS model cut from T = 300 to this, for the time limit.
AD_TOOLS_T = 150


class Background:
    """`fn(*args, **kw)` on a thread, started at once, beside the caller's
    work; `wait()` joins it, re-raises its error and returns its result
    (`seconds`: its wall-clock)."""

    def __init__(self, fn, *args, **kw):
        import threading

        self.result = self.error = None
        self.seconds = 0.0
        t0 = time.perf_counter()

        def run():
            try:
                self.result = fn(*args, **kw)
            except BaseException as exc:       # re-raised by wait()
                self.error = exc
            self.seconds = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def wait(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result

# Phase 8's models and horizons: BASELINE.json configs 2 and 4, solved as
# `scripts/measure_configs.py:36-63` solves them.
DRIVER_CASES = (("hank_one_asset", 300), ("ks_large_grid", 150))

# The JAX package's steady state and root of the same two-asset path, solved
# on a CPU (`scripts/hank2_cpu_groundtruth.py`'s recipe).
TWO_ASSET_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hank_tpu_torch",
                                   "data", "hank_two_asset_T300_jax_cpu.npz")


def jax_root_file(name: str, T: int) -> str:
    """The JAX package's steady state and root of a phase-8 path, solved on
    a CPU (the recipe: `tests/test_torch_one_asset_families.py::jax_cpu_root`)."""
    return os.path.join(os.path.dirname(TWO_ASSET_REFERENCE), f"{name}_T{T}_jax_cpu.npz")


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of `phase`, with the script's seconds so far."""
    print(json.dumps({"phase": phase, "at_s": round(time.perf_counter() - START, 1), **fields}),
          flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Median device milliseconds of `fn()` over `reps` event-timed calls
    after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def cuda_once(fn):
    """(fn(), device milliseconds of that one event-timed call)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


@contextlib.contextmanager
def timed_calls(module, names):
    """Within the block, each function `module.<name>` is replaced by one
    that runs it under `cuda_once`; yields {name: device ms of its last
    call}. A plain version counts its calls on its module-level name
    (`<name>.calls`), which is the replacement's in the block: the calls
    counted there are handed back."""
    ms, originals = {}, {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def run(*a, **kw):
            out, ms[name] = cuda_once(lambda: fn(*a, **kw))
            return out

        run.calls = 0
        return run

    for name, fn in originals.items():
        setattr(module, name, timed(name, fn))
    try:
        yield ms
    finally:
        for name, fn in originals.items():
            if hasattr(fn, "calls"):
                fn.calls += getattr(module, name).calls
            setattr(module, name, fn)


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM bytes per second, and operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def least_time(bytes_moved: float, ops: float, kind: str) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its operations over the peak rate of their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


# Operations the household sweeps need, per state and period, counted from
# the algorithm: a bracket search is ⌈log2 n⌉ compares, a Markov mix 2·n_e,
# a pow one operation; a dual-number (primal + tangent) operation counts 3.
def one_asset_sweep_ops(Tm1: int, n_a: int, n_e: int, tangent: bool, paths: int = 1) -> float:
    """Kernels 1-4: the backward EGM step (expectation 2·n_e, Euler,
    implied wealth, bracket, lerp, clip, budget, envelope: ~20) and the
    forward step (bracket, hat weights and lottery, mix, two aggregates:
    ~14)."""
    per = 4 * n_e + 2 * log2_ceil(n_a) + 34
    return paths * Tm1 * n_a * n_e * per * (3 if tangent else 1)


def forward_scan_ops(T: int, n_a: int, n_e: int) -> float:
    """Kernel 7: bracket, weights (5), lottery (4), mix (2·n_e), aggregate (2)."""
    return T * n_a * n_e * (log2_ceil(n_a) + 2 * n_e + 11)


def two_asset_ops(Tm1: int, n_b: int, n_a: int, n_e: int, which: int,
                  tangent: bool = True) -> float:
    """Kernel 5 (which = 0): per state and access branch the expectations of
    both marginal values (4·n_e), the EGM brackets on both axes and ~40
    arithmetic operations. Kernel 6 (which = 1): both brackets, the joint
    lottery's weights and 4 corners (~18), the income and access mixes
    (2·n_e + 4) and three aggregates (6). Dual numbers (tangent=True,
    kernels 5-6) or values only (the f64 residual pair)."""
    brackets = 2 * (log2_ceil(n_b) + log2_ceil(n_a))
    per = (4 * n_e + brackets + 40) * 2 if which == 0 else brackets + 2 * n_e + 28
    return Tm1 * n_b * n_a * n_e * 2 * per * (3 if tangent else 1)


def previous_kernel1(args, kw):
    """The previous kernel 1, which kernel 1 is held to bit for bit: the
    counting template's B = 1 launch (`fused_sweep_jvp_batch_previous` on
    one row). `args` are kernel 1's nine inputs."""
    from hank_tpu_torch.ops.fused_sweep_batch import fused_sweep_jvp_batch_previous

    rows = [a[None].contiguous() for a in args[:4]]
    return tuple(o[0] for o in fused_sweep_jvp_batch_previous(*rows, *args[4:], **kw))


def same_bits(a, b) -> bool:
    """Equal shapes and bit patterns (NaNs included), f32 or f64."""
    import torch

    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


def vs_previous(name: str, new_fn, old_fn, inputs: dict, kw, batch: int | None = None) -> dict:
    """A kernel with fallback counters (`new_fn`, which takes `fallback_rows`)
    against its previous kernel (`old_fn`) on every input {label: args}, bit
    for bit on all outputs (NaNs included). Per input: the (period, income
    row) pairs that took each fallback branch, summed over the paths of a
    batched launch (`batch` paths), and whether the outputs are finite."""
    import torch

    report = {}
    for label, args in inputs.items():
        shape = (2,) if batch is None else (batch, 2)
        fallback = torch.zeros(shape, dtype=torch.int32, device=args[0].device)
        new = new_fn(*args, **kw, fallback_rows=fallback)
        old = old_fn(*args, **kw)
        require(all(same_bits(a, b) for a, b in zip(new, old)),
                f"{name} at {label} differs from the previous {name}")
        counts = fallback.reshape(-1, 2).sum(0)
        report[label] = {"fallback_rows_implied_wealth": int(counts[0]),
                         "fallback_rows_policy": int(counts[1]),
                         "finite": all(bool(torch.isfinite(o).all()) for o in new)}
    return report


def kernel1_vs_previous(inputs: dict, kw) -> dict:
    """Kernel 1 against the previous kernel 1 on every input {label: args},
    bit for bit on all four outputs (NaNs included), with the count of
    (period, income row) pairs that took each fallback branch."""
    from hank_tpu_torch.ops.fused_sweep import fused_sweep_jvp

    return vs_previous("kernel 1", fused_sweep_jvp, lambda *a, **k: previous_kernel1(a, k),
                       inputs, kw)


def kernel2_vs_previous(inputs: dict, kw) -> dict:
    """Kernel 2 against the previous kernel 2 (the counting template's
    `<double, false, false>`) on every input {label: its seven f64 args},
    as `vs_previous` holds them."""
    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                                   fused_residual_sweep_previous)

    return vs_previous("kernel 2", fused_residual_sweep, fused_residual_sweep_previous,
                       inputs, kw)


def bits_vs(name: str, new_fn, old_fn, inputs: dict, kw, batch: int | None = None) -> dict:
    """A global-state or cluster instantiation (`new_fn`, a `_global` or
    `_cluster` entry point) against the kernel it is held to (`old_fn`: the
    one-block kernel's wrapper, or a `_global` entry point), on every input
    {label: args}: bit for bit on all outputs (NaNs included) and on the
    fallback counts. Per input: the (period, income row) pairs that took
    each fallback branch, summed over the paths of a batched launch, and
    whether the outputs are finite."""
    import torch

    report = {}
    for label, args in inputs.items():
        shape = (2,) if batch is None else (batch, 2)
        fb_new, fb_old = (torch.zeros(shape, dtype=torch.int32, device=args[0].device)
                          for _ in range(2))
        new = new_fn(*args, **kw, fallback_rows=fb_new)
        old = old_fn(*args, **kw, fallback_rows=fb_old)
        require(all(same_bits(a, b) for a, b in zip(new, old)),
                f"{name} at {label} differs from {old_fn.__name__}")
        require(torch.equal(fb_new, fb_old), f"{name} at {label}: fallback counts differ")
        counts = fb_new.reshape(-1, 2).sum(0)
        report[label] = {"fallback_rows_implied_wealth": int(counts[0]),
                         "fallback_rows_policy": int(counts[1]),
                         "finite": all(bool(torch.isfinite(o).all()) for o in new)}
    return report


def require_fallbacks(name: str, report: dict) -> None:
    """The stress inputs of phase 4 took their fallback branches."""
    require(report["V_T_noise"]["fallback_rows_implied_wealth"] > 0
            and report["V_T_nan"]["fallback_rows_implied_wealth"] > 0
            and report["grid_swapped"]["fallback_rows_policy"] > 0,
            f"{name}: an input meant to take a fallback branch did not: {report}")


def fallback_sum(report: dict, labels) -> list:
    """[implied wealth, policy] fallback rows summed over `labels` of a
    `vs_previous` report."""
    return [sum(report[k][f"fallback_rows_{what}"] for k in labels)
            for what in ("implied_wealth", "policy")]


def in_turns(fns: dict, reps: int) -> dict:
    """Median ms of each callable {name: fn}, timed in turns: in order,
    then in reverse order (first, second, second, first for two), `reps`
    launches a turn."""
    turns = {name: [] for name in fns}
    for name in (*fns, *reversed(fns)):
        turns[name].append(cuda_ms(fns[name], reps))
    return {name: statistics.median(t) for name, t in turns.items()}


def previous_wrappers() -> dict:
    """The `_previous` wrappers of the one-asset kernels (the counting
    template's builds and the previous kernel 7); no solver may launch
    them."""
    from hank_tpu_torch.ops.forward_scan import forward_scan_previous
    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep_batch_previous,
                                                   fused_residual_sweep_previous)
    from hank_tpu_torch.ops.fused_sweep import fused_sweep_jvp_f64_previous
    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch_previous,
                                                      fused_sweep_jvp_f64_batch_previous)

    return {"k2_previous": fused_residual_sweep_previous,
            "k2_batch_previous": fused_residual_sweep_batch_previous,
            "k3_4_previous": fused_sweep_jvp_batch_previous,
            "jvp_f64_previous": fused_sweep_jvp_f64_previous,
            "jvp_f64_batch_previous": fused_sweep_jvp_f64_batch_previous,
            "k7_previous": forward_scan_previous}


def previous_launches() -> dict:
    """The launch counts of `previous_wrappers`."""
    return {name: fn.launches for name, fn in previous_wrappers().items()}


def zero_previous_launches() -> None:
    for fn in previous_wrappers().values():
        fn.launches = 0


def zero_batch_counts() -> None:
    """Zero the launch counts of the batched kernels (kernels 3-4, the batched
    kernel 2), their plain versions' calls and the previous kernels'."""
    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep_batch,
                                                   fused_residual_sweep_batch_reference)
    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
                                                      fused_sweep_jvp_batch_reference)

    fused_sweep_jvp_batch.launches = fused_residual_sweep_batch.launches = 0
    fused_sweep_jvp_batch_reference.calls = fused_residual_sweep_batch_reference.calls = 0
    zero_previous_launches()


def read_batch_counts(path: str) -> tuple:
    """(launches, plain calls) of the batched kernels since
    `zero_batch_counts`; raises when a previous kernel ran on `path`."""
    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep_batch,
                                                   fused_residual_sweep_batch_reference)
    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
                                                      fused_sweep_jvp_batch_reference)

    previous = previous_launches()
    require(not any(previous.values()), f"a previous kernel ran on the {path}: {previous}")
    return ({"k3_4": fused_sweep_jvp_batch.launches,
             "k2_batch": fused_residual_sweep_batch.launches},
            {"k3_4": fused_sweep_jvp_batch_reference.calls,
             "k2_batch": fused_residual_sweep_batch_reference.calls})


def one_asset_grids() -> dict:
    """Every one-asset grid (n_a ≥ 2, n_e ≤ 20) that the counting template
    takes in one block, per arithmetic (which 0: f64 values, 1: f32 dual,
    6: f64 dual): kernels 2 and 3-4 and the f64 tangent sweep (which 4, 3,
    5) fit it too, by the library's own shared-memory count; and every grid
    the previous kernel 7 takes fits kernel 7. Fails otherwise. Reports the
    grids kernel 1 (which 2, whose row flags take 8·n_e bytes more)
    refuses."""
    from hank_tpu_torch.ops import cuda_build

    lib = cuda_build.load_library()
    limit = cuda_build.MAX_SMEM_BYTES
    report = {}
    taken, refused = 0, []
    for n_e in range(1, 21):
        n_a = 2
        while lib.hank_forward_scan_smem_bytes(0, n_a, n_e) <= limit:
            taken += 1
            if lib.hank_forward_scan_smem_bytes(1, n_a, n_e) > limit:
                refused.append((n_a, n_e))
            n_a += 1
    require(taken > 10_000 and not refused,
            f"kernel 7 refuses {len(refused)} grids the previous kernel 7 takes: {refused[:5]}")
    report["forward_scan"] = {"grids_of_the_previous_kernel": taken, "refused": 0}
    for old, new, label in ((0, 4, "f64_values"), (1, 3, "f32_dual"), (6, 5, "f64_dual")):
        taken, refused, k1_refused = 0, [], []
        for n_e in range(1, 21):
            n_a = 2
            while lib.hank_sweep_smem_bytes(old, n_a, n_e) <= limit:
                taken += 1
                if lib.hank_sweep_smem_bytes(new, n_a, n_e) > limit:
                    refused.append((n_a, n_e))
                if old == 1 and lib.hank_sweep_smem_bytes(2, n_a, n_e) > limit:
                    k1_refused.append((n_a, n_e))
                n_a += 1
        require(taken > 10_000 and not refused,
                f"{label}: the new kernel refuses {len(refused)} grids the template "
                f"takes: {refused[:5]}")
        report[label] = {"grids_of_the_template": taken, "refused": 0,
                         **({"kernel1_refuses": k1_refused} if old == 1 else {})}
    return report


def fit_decisions() -> dict:
    """The kernel maps' fit check (`cuda_build.check_fit` of the library's
    count) at n_e = 7 on both sides of each one-asset kernel's limit: the
    last n_a it takes and the first it refuses; then its cluster
    instantiation's limit (per block, on a cluster of 7 the card holds:
    `cuda_build.max_clusters`) between the one-block and the global-state
    ones. The batched f64 tangent sweep's three tiers end where the single
    path's do. Fails if the libraries' counts disagree with those limits or
    the decision with the tiers."""
    from hank_tpu_torch.ops import cuda_build as cb

    def fits(need):
        try:
            cb.check_fit(need, "")
        except ValueError:
            return False
        return True

    from hank_tpu_torch.ops.fused_sweep import KERNEL_NAMES, sweep_kernel

    from hank_tpu_torch.ops.fused_sweep import ENSEMBLE_ROUTE

    limits = {"kernel2": (cb.KERNEL2, 1036), "kernel1": (cb.KERNEL1, 1147),
              "kernels3_4": (cb.KERNELS3_4, 1148), "jvp_f64": (cb.JVP_F64, 529),
              "jvp_f64_batch": (cb.JVP_F64_BATCH, 529)}
    global_limits = {"kernel2": 5390, "kernel1": 10792, "kernels3_4": 10792, "jvp_f64": 4980,
                     "jvp_f64_batch": 4980}
    cluster_limits = {"kernel2": 2694, "kernel1": 3597, "kernels3_4": 3597, "jvp_f64": 1660,
                      "jvp_f64_batch": 1660}
    report = {}
    for name, (which, last) in limits.items():
        taken = {n_a: fits(cb.sweep_smem_bytes(which, n_a, 7)) for n_a in (last, last + 1)}
        require(taken == {last: True, last + 1: False},
                f"{name}: the fit decision at n_e = 7 is {taken}, not a limit at {last}")
        glob, g_last = cb.GLOBAL_STATE[which], global_limits[name]
        kind, c_last = cb.CLUSTER[which], cluster_limits[name]
        taken = {n_a: fits(cb.sweep_smem_bytes(kind, n_a, 7)) for n_a in (c_last, c_last + 1)}
        require(taken == {c_last: True, c_last + 1: False},
                f"{name} on a cluster: the fit at n_e = 7 is {taken}, not a limit at {c_last}")
        held = {n_a: cb.max_clusters("household_sweep_cluster", kind, n_a, 7)
                for n_a in (last + 1, c_last)}
        require(min(held.values()) >= 1, f"{name}: the card holds no cluster: {held}")
        decided = {n_a: sweep_kernel(which, n_a, 7)
                   for n_a in (last, last + 1, c_last, c_last + 1, g_last)}
        require(decided == {last: which, last + 1: kind, c_last: kind, c_last + 1: glob,
                            g_last: glob},
                f"{name}: the kernel decided at n_e = 7 is {decided}")
        cluster = {"cluster": {"last_n_a_taken": c_last, "one_past_takes": KERNEL_NAMES[glob],
                               "bytes": [cb.sweep_smem_bytes(kind, n_a, 7)
                                         for n_a in (c_last, c_last + 1)],
                               "clusters_the_card_holds": held}}
        taken = {n_a: fits(cb.sweep_smem_bytes(glob, n_a, 7)) for n_a in (g_last, g_last + 1)}
        require(taken == {g_last: True, g_last + 1: False},
                f"{name} on global state: the fit at n_e = 7 is {taken}, not a limit at {g_last}")
        # The batched f64 tangent sweep's map names the ensemble's plain
        # route (`make_fused_jvp_batch` passes ENSEMBLE_ROUTE).
        ensemble = which == cb.JVP_F64_BATCH
        try:
            sweep_kernel(which, g_last + 1, 7, *((ENSEMBLE_ROUTE,) if ensemble else ()))
            error = None
        except ValueError as exc:
            error = str(exc)
        named = "fused='xla'" if ensemble else "direction_mode='xla'"
        require(error is not None and named in error,
                f"{name}: past the global-state count the decision did not raise: {error}")
        report[name] = {"last_n_a_taken": last, "bytes": [cb.sweep_smem_bytes(which, n_a, 7)
                                                           for n_a in (last, last + 1)],
                        "one_past_takes": KERNEL_NAMES[decided[last + 1]], **cluster,
                        "global_state": {"last_n_a_taken": g_last,
                                         "bytes": [cb.sweep_smem_bytes(glob, n_a, 7)
                                                   for n_a in (g_last, g_last + 1)]}}
    return report


def start_ptx():
    """nvcc -ptx of the one-asset source, started in the background
    (~20 s): (process, temporary directory, output path)."""
    from hank_tpu_torch.ops import cuda_build

    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "household_sweep.ptx")
    cmd = [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-ptx", "-o", out, cuda_build.SOURCES["household_sweep"]]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out


def state_loads_coherent(job) -> dict:
    """From `start_ptx`'s PTX: each global-state instantiation of the ranged
    kernel has as many non-coherent loads (`ld.global.nc`, the read-only
    path) as the shared-state instantiations of its arithmetic, whose state
    is in shared memory: none of its loads of the state workspace, which
    the launch writes, takes that path. Fails otherwise."""
    proc, tmp, out = job
    log = proc.communicate(timeout=900)[0]
    require(proc.returncode == 0, f"nvcc -ptx failed: {log}")
    with open(out) as f:
        text = f.read()
    tmp.cleanup()
    counts = {}
    for m in re.finditer(r"\.entry (\S+)\(", text):
        tag = re.search(r"ranged_kernelI([fd])Lb([01])ELb([01])ELb([01])E", m.group(1))
        if tag:
            body = text[m.end():text.find("\n}", m.end())]
            counts[tag.groups()] = len(re.findall(r"ld\.global\.nc\.", body))
    report = {}
    for (S, tangent, batched, glob), n in counts.items():
        if glob == "1":
            twins = {v for k, v in counts.items() if k[:2] == (S, tangent) and k[3] == "0"}
            require(twins == {n}, f"<{S},{tangent},{batched},G>: {n} ld.global.nc against the "
                                  f"shared-state instantiations' {twins}")
            report[f"<{S},{tangent},{batched},G>"] = n
    require(len(report) == 6, f"the six global-state instantiations were not found: {report}")
    return report


# The previous build's SASS of the kernels a PR leaves alone (their names as
# `tools/sass_compare.parse_sass` gives them), recorded on the card with
# `python -m hank_tpu_torch.tools.sass_compare --digest`.
SASS_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hank_tpu_torch",
                              "tools", "sass_reference.json")


def sass_vs_reference(libraries: dict) -> dict:
    """Per library of `SASS_REFERENCE` ({name: built library}), the built
    SASS of every kernel it records, digest against digest. Compared, and
    required identical, where nvcc is the reference's; reported as not
    compared otherwise."""
    from hank_tpu_torch.tools import sass_compare

    with open(SASS_REFERENCE) as f:
        ref = json.load(f)
    nvcc = sass_compare.nvcc_version()
    compared = nvcc == ref["nvcc"]
    report = {"nvcc": nvcc, "compared": compared}
    for name, rec in ref["libraries"].items():
        got = sass_compare.digests(sass_compare.sass(libraries[name]))
        same = {kernel: got.get(kernel) == d for kernel, d in rec["kernels"].items()}
        if compared:
            require(all(same.values()), f"{name}: SASS differs from the previous build: "
                                        f"{[k for k, v in same.items() if not v]}")
        report[name] = {"reference": rec["source"], "identical": same}
    return report


def kernel6_vs_previous(inputs: dict, D0, model) -> dict:
    """Kernel 6 (the cluster kernel) against the previous kernel 6 on every
    input {label: (policies, dpolicies)}, bit for bit on all six outputs
    (NaNs included); reports whether each output is finite."""
    import torch

    from hank_tpu_torch.ops import fused_sweep2 as fs2

    def bits(t):
        return t.contiguous().view(torch.int32)

    report = {}
    for label, (pol, dpol) in inputs.items():
        new = fs2.fused2_forward_jvp(pol, dpol, D0, model)
        old = fs2.fused2_forward_jvp_previous(pol, dpol, D0, model)
        require(all(torch.equal(bits(a[k]), bits(b[k])) for a, b in zip(new, old) for k in a),
                f"kernel 6 at {label} differs from the previous kernel 6")
        report[label] = {"finite": all(bool(torch.isfinite(o[k]).all()) for o in new for k in o)}
    return report


def kernel6_grids() -> dict:
    """Every two-asset grid (n_b, n_a ≥ 6, n_b·n_a ≤ 2048, n_e ≤ 8) whose
    previous kernel 6 fits in one block: kernel 6 on its default cluster
    fits too, by the library's own shared-memory count. Fails otherwise."""
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    lib = cuda_build.load_library("household_sweep2")
    taken, refused = 0, []
    for n_e in range(1, 9):
        c = fs2.default_cluster(n_e)
        for n_b in range(6, 2048 // 6 + 1):
            for n_a in range(6, 2048 // n_b + 1):
                if lib.hank_sweep2_smem_bytes(1, n_b, n_a, n_e, 1) <= cuda_build.MAX_SMEM_BYTES:
                    taken += 1
                    if lib.hank_sweep2_smem_bytes(2, n_b, n_a, n_e, c) > cuda_build.MAX_SMEM_BYTES:
                        refused.append((n_b, n_a, n_e))
    require(taken > 10_000 and not refused,
            f"kernel 6 refuses {len(refused)} grids the previous kernel 6 takes: {refused[:5]}")
    return {"grids_of_the_previous_kernel": taken, "refused": 0,
            "smem_bytes_40x20x5x2": lib.hank_sweep2_smem_bytes(2, 40, 20, 5, 10)}


def kernel6_large_grid(model) -> dict:
    """Kernel 6 against the previous kernel 6, bit for bit, at 38×38×2×2 and
    40 periods (a grid whose destinations keep a count before every few
    bitmap words only, for room), on seeded policies and tangents with a
    third of the liquid policies at the borrowing limit."""
    import dataclasses

    import torch

    from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    f32, dev = torch.float32, model.heterogeneity["liquid"].grid.device
    n_b, n_a, n_e, Tm1 = 38, 38, 2, 40
    gen = torch.Generator().manual_seed(11)

    def t(a):
        return torch.as_tensor(a, dtype=f32).to(dev)

    het = model.heterogeneity
    Pi, _, z = rouwenhorst(n_e, 0.966, 0.283)
    big = dataclasses.replace(model, heterogeneity={
        "liquid": dataclasses.replace(het["liquid"], n=n_b,
                                      grid=t(make_double_exponential_grid(0.0, 120.0, n_b))),
        "illiquid": dataclasses.replace(het["illiquid"], n=n_a,
                                        grid=t(make_double_exponential_grid(0.0, 200.0, n_a))),
        "income": dataclasses.replace(het["income"], n=n_e, grid=t(z), transition=t(Pi)),
        "access": het["access"]})
    shape = (Tm1, n_b, n_a, n_e, 2)
    pol = {"B": torch.rand(shape, generator=gen) * 130.0 - 5.0,
           "A": torch.rand(shape, generator=gen) * 210.0 - 5.0,
           "C": torch.rand(shape, generator=gen) + 0.1}
    pol["B"][torch.rand(shape, generator=gen) < 1 / 3] = 0.0
    pol = {k: v.to(dev) for k, v in pol.items()}
    dpol = {k: torch.randn(shape, generator=gen).to(dev) for k in pol}
    D0 = torch.rand((n_b, n_a, n_e, 2), generator=gen)
    D0 = (D0 / D0.sum()).to(dev)
    new = fs2.fused2_forward_jvp(pol, dpol, D0, big)
    old = fs2.fused2_forward_jvp_previous(pol, dpol, D0, big)
    require(all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
                for a, b in zip(new, old) for k in a),
            "kernel 6 at 38x38x2x2 differs from the previous kernel 6")
    lib = cuda_build.load_library("household_sweep2")
    return {"grid": [n_b, n_a, n_e, 2], "periods": Tm1, "bit_identical": True,
            "smem_bytes": lib.hank_sweep2_smem_bytes(2, n_b, n_a, n_e, fs2.default_cluster(n_e)),
            "finite": all(bool(torch.isfinite(o[k]).all()) for o in new for k in o)}


def kernel5_vs_previous(inputs: dict, model) -> dict:
    """Kernel 5 (the cluster kernel) against the previous kernel 5 on every
    input {label: (eight price and tangent paths, V_T)}, bit for bit on all
    six outputs (NaNs included); reports whether each output is finite."""
    import torch

    from hank_tpu_torch.ops import fused_sweep2 as fs2

    def bits(t):
        return t.contiguous().view(torch.int32)

    report = {}
    for label, (args, VT) in inputs.items():
        new = fs2.fused2_policies_jvp(*args, VT, model)
        old = fs2.fused2_policies_jvp_previous(*args, VT, model)
        require(all(torch.equal(bits(a[k]), bits(b[k])) for a, b in zip(new, old) for k in a),
                f"kernel 5 at {label} differs from the previous kernel 5")
        report[label] = {"finite": all(bool(torch.isfinite(o[k]).all()) for o in new for k in o)}
    return report


def kernel5_grids() -> dict:
    """Every two-asset grid (n_b, n_a ≥ 2, n_e ≤ 20) whose previous kernel 5
    fits in one block: kernel 5 on its default cluster fits too, by the
    library's own shared-memory count. Fails otherwise."""
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    lib = cuda_build.load_library("household_sweep2")
    limit = cuda_build.MAX_SMEM_BYTES
    taken, refused = 0, []
    for n_e in range(1, 21):
        c = fs2.default_bwd_cluster(n_e)
        for n_b in range(2, 5000):
            if lib.hank_sweep2_smem_bytes(0, n_b, 2, n_e, 1) > limit:
                break
            for n_a in range(2, 5000):
                if lib.hank_sweep2_smem_bytes(0, n_b, n_a, n_e, 1) > limit:
                    break
                taken += 1
                if lib.hank_sweep2_smem_bytes(3, n_b, n_a, n_e, c) > limit:
                    refused.append((n_b, n_a, n_e))
    require(taken > 50_000 and not refused,
            f"kernel 5 refuses {len(refused)} grids the previous kernel 5 takes: {refused[:5]}")
    return {"grids_of_the_previous_kernel": taken, "refused": 0,
            "smem_bytes_40x20x5x2": lib.hank_sweep2_smem_bytes(3, 40, 20, 5, 5)}


def kernel5_other_grids(model) -> dict:
    """Kernel 5 against the previous kernel 5, bit for bit, at four more
    grids on seeded prices, tangents and V_T, 40 periods, across its
    branches: 24×12×3×2 (a cluster of 3), 12×8×17×2 (the card's largest
    cluster, 16 blocks: block 0 holds incomes 0 and 16), 48×24×2×2 (B2 in
    two passes: the policies written where they are computed) and 60×60×1×2
    (one block, no room for the candidates' bracket table)."""
    import dataclasses

    import torch

    from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    f32, dev = torch.float32, model.heterogeneity["liquid"].grid.device
    lib = cuda_build.load_library("household_sweep2")
    gen = torch.Generator().manual_seed(13)
    Tm1, het, report = 40, model.heterogeneity, {}

    def t(a):
        return torch.as_tensor(a, dtype=f32).to(dev)

    for n_b, n_a, n_e in ((24, 12, 3), (12, 8, 17), (48, 24, 2), (60, 60, 1)):
        Pi, _, z = rouwenhorst(n_e, 0.966, 0.283) if n_e > 1 else ([[1.0]], None, [1.0])
        grid = dataclasses.replace(model, heterogeneity={
            "liquid": dataclasses.replace(het["liquid"], n=n_b,
                                          grid=t(make_double_exponential_grid(0.0, 120.0, n_b))),
            "illiquid": dataclasses.replace(het["illiquid"], n=n_a,
                                            grid=t(make_double_exponential_grid(0.0, 200.0, n_a))),
            "income": dataclasses.replace(het["income"], n=n_e, grid=t(z), transition=t(Pi)),
            "access": het["access"]})
        level = torch.tensor([0.01, 0.015, 0.8, 0.3])[:, None]
        prices = level * (1.0 + 0.05 * torch.rand((4, Tm1), generator=gen))
        tangents = 1e-3 * torch.randn((4, Tm1), generator=gen)
        args = [q.contiguous().to(dev) for q in (*prices, *tangents)]
        VT = (0.05 + 2.0 * torch.rand((2, n_b, n_a, n_e, 2), generator=gen)).to(dev)
        label = f"{n_b}x{n_a}x{n_e}x2"
        bits = kernel5_vs_previous({label: (args, VT)}, grid)[label]
        report[label] = {**bits, "cluster": fs2.default_bwd_cluster(n_e),
                         "smem_bytes": lib.hank_sweep2_smem_bytes(
                             3, n_b, n_a, n_e, fs2.default_bwd_cluster(n_e))}
    return report


def f64_pair_grids() -> dict:
    """The f64 residual pair's shared memory per block on its default
    clusters, by the library's own count: at 40×20×5×2 (required to fit),
    and at every grid of `kernel5_grids` (the backward kernel: the grids
    the previous kernel 5 takes) and of `kernel6_grids` (the forward
    kernel: those the previous kernel 6 takes), how many each takes
    (reported)."""
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    lib2 = cuda_build.load_library("household_sweep2")
    f64 = cuda_build.load_library("household_sweep2_f64")
    limit = cuda_build.MAX_SMEM_BYTES
    bwd, fwd = [0, 0], [0, 0]                    # [grids, of which the pair takes]
    for n_e in range(1, 21):
        c = fs2.default_bwd_cluster(n_e)
        for n_b in range(2, 5000):
            if lib2.hank_sweep2_smem_bytes(0, n_b, 2, n_e, 1) > limit:
                break
            for n_a in range(2, 5000):
                if lib2.hank_sweep2_smem_bytes(0, n_b, n_a, n_e, 1) > limit:
                    break
                bwd[0] += 1
                bwd[1] += f64.hank_sweep2_f64_smem_bytes(0, n_b, n_a, n_e, c) <= limit
    for n_e in range(1, 9):
        c = fs2.default_cluster(n_e)
        for n_b in range(6, 2048 // 6 + 1):
            for n_a in range(6, 2048 // n_b + 1):
                if lib2.hank_sweep2_smem_bytes(1, n_b, n_a, n_e, 1) <= limit:
                    fwd[0] += 1
                    fwd[1] += f64.hank_sweep2_f64_smem_bytes(1, n_b, n_a, n_e, c) <= limit
    at = {"backward": f64.hank_sweep2_f64_smem_bytes(0, 40, 20, 5, fs2.default_bwd_cluster(5)),
          "forward": f64.hank_sweep2_f64_smem_bytes(1, 40, 20, 5, fs2.default_cluster(5))}
    require(max(at.values()) <= limit, f"the f64 pair does not fit 40x20x5x2: {at}")
    return {"smem_bytes_40x20x5x2": at,
            "backward_of_kernel5_grids": {"grids": bwd[0], "taken": bwd[1]},
            "forward_of_kernel6_grids": {"grids": fwd[0], "taken": fwd[1]}}


def tangent_pair_grids() -> dict:
    """The f64 tangent pair's shared memory per block on its default
    clusters, by the library's own count (which 4-9 of
    `hank_sweep2_f64_smem_bytes`): at 40×20×5×2 the shared-state backward
    (tabled) and the shared-list forward push, at 50×70×5×2 the backward
    with its tangent state in the workspace and the global-list push,
    required to fit and to be what the maps decide; at 64×64×5×2 the
    decision raising (reported)."""
    import dataclasses

    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    limit = cuda_build.MAX_SMEM_BYTES
    at, decided = {}, {}
    model = load_model("hank_two_asset", device="cpu")
    het = model.heterogeneity
    for n_b, n_a in ((40, 20), (50, 70), (64, 64)):
        c5, c6 = fs2.default_bwd_cluster(5), fs2.default_cluster(5)
        at[f"{n_b}x{n_a}x5x2"] = {w: cuda_build.sweep2_f64_smem_bytes(
            w, n_b, n_a, 5, c5 if w in (4, 7, 8, 9) else c6) for w in range(4, 10)}
        grid = dataclasses.replace(model, heterogeneity={
            **het, "liquid": dataclasses.replace(het["liquid"], n=n_b),
            "illiquid": dataclasses.replace(het["illiquid"], n=n_a)})
        try:
            decided[f"{n_b}x{n_a}x5x2"] = fs2.check_fit_jvp_f64(grid)
        except ValueError as e:
            decided[f"{n_b}x{n_a}x5x2"] = str(e)
    # (backward, forward, whether the backward tables its candidates)
    need = {"40x20x5x2": (fs2.JVP_F64_BWD, 5, True),
            "50x70x5x2": (fs2.JVP_F64_BWD_GLOBAL, 6, False)}
    for g, (b, f, tabled) in need.items():
        require(decided[g] == (b, f) and at[g][b] <= limit and at[g][f] <= limit
                and (at[g][b] != at[g][{4: 7, 8: 9}[b]]) == tabled,
                f"the tangent pair at {g}: decided {decided[g]}, counts {at[g]}")
    require(isinstance(decided["64x64x5x2"], str),
            f"the tangent pair's build did not raise at 64x64x5x2: {decided}")
    return {"smem_bytes": at, "decided": decided}


def steady_residual(model, ss) -> float:
    """max |F| of the model's equations at the steady state `ss`."""
    import torch

    from hank_tpu_torch.blocks.assemble import residuals as eval_residuals

    cs = model.compspec
    col = torch.stack([torch.as_tensor(ss.vars[k]) for k in model.var_names()])
    x_mat = col[:, None].expand(cs.n_v, 1 + cs.max_lag + cs.max_lead)
    return float(eval_residuals(x_mat, model).abs().max())


def ensemble_phase(model, ss0, ssT, Jbar, x_ss, B: int = 64,
                   widths=(1, 64, 132, 256, 1024)) -> tuple:
    """Phase 6: the ensemble path at B paths (see the module docstring).
    Emits its JSON lines and returns the `kernels` entries of the batched
    kernels and the timed Newton-Krylov solve (its shocks, path, info and
    median seconds), which phase 10 repeats on a mesh."""
    import torch

    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                                   fused_residual_sweep_batch,
                                                   fused_residual_sweep_batch_cluster,
                                                   fused_residual_sweep_batch_global,
                                                   fused_residual_sweep_batch_previous,
                                                   fused_residual_sweep_batch_reference,
                                                   fused_residual_sweep_cluster,
                                                   fused_residual_sweep_global)
    from hank_tpu_torch.ops.fused_sweep import (fused_sweep_jvp, fused_sweep_jvp_cluster,
                                                fused_sweep_jvp_global)
    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
                                                      fused_sweep_jvp_batch_cluster,
                                                      fused_sweep_jvp_batch_global,
                                                      fused_sweep_jvp_batch_previous,
                                                      fused_sweep_jvp_batch_reference)
    from hank_tpu_torch.parallel.ensemble import solve_ensemble_host
    from hank_tpu_torch.solvers.newton import make_full_residual_fn, make_path_solver

    f32, f64 = torch.float32, torch.float64
    dev = x_ss.device
    cs = model.compspec
    Tm1, nE = cs.T - 1, cs.n_endog
    endog = model.vars_of_type("endogenous")
    i_r, i_w = endog.index("r"), endog.index("w")
    wealth, prod = model.endog_dims()[0], model.exog_dims()[0]
    p = model.params
    kw = dict(beta=p["β"], gamma=p["γ"], borrow_cons=p["borrow_cons"])
    c32, c64 = [[t.to(dtype).contiguous() for t in
                 (ssT.value, ss0.D, wealth.grid, prod.grid, prod.transition)]
                for dtype in (f32, f64)]
    t = torch.arange(1, Tm1 + 1, dtype=f64)
    rhos = 0.5 + 0.4 * torch.arange(B, dtype=f64) / B
    exog_b = {"Z": (2.0 + (1.0 - 2.0) * rhos[:, None] ** t[None, :]).to(dev)}

    def solve(method):
        x, info = solve_ensemble_host(x_ss, Jbar, exog_b, model, ss0, ssT, eps=1e-8,
                                      method=method, direction_dtype=f32)
        torch.cuda.synchronize()
        return x, info

    def prices(x_b, dtype):
        xp = x_b.reshape(x_b.shape[0], Tm1, nE)
        return xp[:, :, i_r].to(dtype).contiguous(), xp[:, :, i_w].to(dtype).contiguous()

    def rows_of(args, rows):
        return [a[rows].contiguous() for a in args]

    x_warm, _ = solve("newton_krylov")

    # Batched kernel 1 at the solver's own points, x_ss on every row and the
    # rows of the warm-up solution, along smooth seeded directions (a random
    # amplitude per variable and row, decaying as 0.9ᵗ). Its plain version
    # runs in float64 on the same input values: at those rows the f32 plain
    # version's own rounding is as large as the kernel's (up to ~7e-5 of a
    # tangent's scale), and along i.i.d. directions both f32 versions land up
    # to ~3e-3 relative off the f64 tangent (PERF.md, PR 2).
    gen = torch.Generator().manual_seed(1)
    check_rows = [0, B // 3, 2 * B // 3, B - 1]      # 0, 21, 42, 63 at B=64
    decay = (0.9 ** torch.arange(Tm1, dtype=f64))[None, :, None]
    c32_as64 = [c.double() for c in c32]
    k3_err = 0.0
    k34_inputs, k2b_inputs = {}, {}
    for label, x_b in (("x_ss", x_ss.expand(B, -1)), ("solution", x_warm)):
        v_b = (torch.randn((B, 1, nE), generator=gen, dtype=f64) * decay).reshape(B, -1).to(dev)
        paths = (*prices(x_b, f32), *prices(v_b, f32))
        k34_inputs[label] = (*paths, *c32)
        k2b_inputs[label] = (*prices(x_b, f64), *c64)
        out = fused_sweep_jvp_batch(*paths, *c32, **kw)
        for b in range(B):
            single = fused_sweep_jvp(*(q[b].contiguous() for q in paths), *c32, **kw)
            require(all(torch.equal(o[b], s_) for o, s_ in zip(out, single)),
                    f"batched kernel 1: row {b} differs from its single launch")
        # Held on the first and last check rows (all four before the batched
        # f64 directions' checks, cut for the script's time limit).
        ref = fused_sweep_jvp_batch_reference(
            *(q.double() for q in rows_of(paths, check_rows[::3])), *c32_as64, **kw)
        for o, r_ in zip(out, ref):
            err = max_abs(o[check_rows[::3]].double(), r_)
            scale = float(r_.abs().max())
            require(err <= 3e-5 * max(scale, 1.0),
                    f"batched kernel 1 off its plain version by {err:.3e} (scale {scale:.3e})")
            k3_err = max(k3_err, err)
    zero = torch.zeros_like(paths[2])
    out0 = fused_sweep_jvp_batch(paths[0], paths[1], zero, zero, *c32, **kw)
    require(bool((out0[1] == 0).all() and (out0[3] == 0).all()),
            "batched kernel 1: a zero tangent did not give exactly zero")
    small = rows_of(paths, check_rows)
    ref32, plain_ms = cuda_once(lambda: fused_sweep_jvp_batch_reference(*small, *c32, **kw))
    k3_err_f32 = max(max_abs(o[check_rows], r_) for o, r_ in zip(out, ref32))

    # Batched kernel 2 at the rows of the warm-up solution.
    r64, w64 = prices(x_warm, f64)
    out2 = fused_residual_sweep_batch(r64, w64, *c64, **kw)
    for b in range(B):
        single = fused_residual_sweep(r64[b].contiguous(), w64[b].contiguous(), *c64, **kw)
        require(all(torch.equal(o[b], s_) for o, s_ in zip(out2, single)),
                f"batched kernel 2: row {b} differs from its single launch")
    ref2, plain2_ms = cuda_once(lambda: fused_residual_sweep_batch_reference(
        *rows_of((r64, w64), [0, B - 1]), *c64, **kw))
    k2b_err = max(max_abs(o[[0, B - 1]], r_) for o, r_ in zip(out2, ref2))
    require(k2b_err <= 1e-11, f"batched kernel 2 off its plain version by {k2b_err:.3e}")

    # Kernels 3-4 and the batched kernel 2 against their previous kernels,
    # bit for bit on every row, at x_ss, at the warm-up's rows and on the
    # grid with two knots swapped (the fallback branches).
    k = int(wealth.n) // 2
    swap32, swap64 = c32[2].clone(), c64[2].clone()
    swap32[[k, k + 1]] = swap32[[k + 1, k]]
    swap64[[k, k + 1]] = swap64[[k + 1, k]]
    sol32, sol64 = k34_inputs["solution"], k2b_inputs["solution"]
    k34_inputs["grid_swapped"] = (*sol32[:6], swap32, *sol32[7:])
    k2b_inputs["grid_swapped"] = (*sol64[:4], swap64, *sol64[5:])
    k34_bits = vs_previous("batched kernel 1 (kernels 3-4)", fused_sweep_jvp_batch,
                           fused_sweep_jvp_batch_previous, k34_inputs, kw, batch=B)
    k2b_bits = vs_previous("batched kernel 2", fused_residual_sweep_batch,
                           fused_residual_sweep_batch_previous, k2b_inputs, kw, batch=B)
    require(sum(fallback_sum(k34_bits, ["grid_swapped"])) > 0
            and sum(fallback_sum(k2b_bits, ["grid_swapped"])) > 0,
            f"the swapped grid took no fallback branch: {k34_bits}, {k2b_bits}")

    # The batched global-state instantiations against kernels 3-4 and the
    # batched kernel 2 at the same inputs, bit for bit on every row and
    # fallback count; and every row of a B=16 launch of each bit for bit a
    # single-path launch of the global-state instantiation.
    k34_global = bits_vs("kernels 3-4 on global state", fused_sweep_jvp_batch_global,
                         fused_sweep_jvp_batch, k34_inputs, kw, batch=B)
    k2b_global = bits_vs("batched kernel 2 on global state", fused_residual_sweep_batch_global,
                         fused_residual_sweep_batch, k2b_inputs, kw, batch=B)
    require(sum(fallback_sum(k34_global, ["grid_swapped"])) > 0
            and sum(fallback_sum(k2b_global, ["grid_swapped"])) > 0,
            f"the swapped grid took no fallback branch on global state: {k34_global}")
    rows16 = list(range(16))
    for label in ("solution", "grid_swapped"):
        args = k34_inputs[label]
        out = fused_sweep_jvp_batch_global(*rows_of(args[:4], rows16), *args[4:], **kw)
        args64 = k2b_inputs[label]
        out64 = fused_residual_sweep_batch_global(*rows_of(args64[:2], rows16), *args64[2:],
                                                  **kw)
        for b in rows16:
            single = fused_sweep_jvp_global(*(q[b].contiguous() for q in args[:4]),
                                            *args[4:], **kw)
            single64 = fused_residual_sweep_global(*(q[b].contiguous() for q in args64[:2]),
                                                   *args64[2:], **kw)
            require(all(same_bits(o[b], s_) for o, s_ in zip(out, single))
                    and all(same_bits(o[b], s_) for o, s_ in zip(out64, single64)),
                    f"batched global-state kernels at {label}: row {b} differs from its "
                    f"single launch")
    emit("global_state_ensemble", B=B, rows_vs_single_B=16,
         k3_4_bit_identical=k34_global, k2_batch_bit_identical=k2b_global)

    # The batched cluster instantiations the same way (at B the cluster
    # size the rule takes), every row of a B=16 launch bit for bit a
    # single-path cluster launch, and each timed in turns with its one-block
    # kernel at B=16 (one-block, cluster, cluster, one-block).
    k34_cluster = bits_vs("kernels 3-4 on a cluster", fused_sweep_jvp_batch_cluster,
                          fused_sweep_jvp_batch, k34_inputs, kw, batch=B)
    k2b_cluster = bits_vs("batched kernel 2 on a cluster", fused_residual_sweep_batch_cluster,
                          fused_residual_sweep_batch, k2b_inputs, kw, batch=B)
    require(sum(fallback_sum(k34_cluster, ["grid_swapped"])) > 0
            and sum(fallback_sum(k2b_cluster, ["grid_swapped"])) > 0,
            f"the swapped grid took no fallback branch on a cluster: {k34_cluster}")
    for label in ("solution", "grid_swapped"):
        args, args64 = k34_inputs[label], k2b_inputs[label]
        out = fused_sweep_jvp_batch_cluster(*rows_of(args[:4], rows16), *args[4:], **kw)
        out64 = fused_residual_sweep_batch_cluster(*rows_of(args64[:2], rows16), *args64[2:],
                                                   **kw)
        for b in rows16:
            single = fused_sweep_jvp_cluster(*(q[b].contiguous() for q in args[:4]),
                                             *args[4:], **kw)
            single64 = fused_residual_sweep_cluster(*(q[b].contiguous() for q in args64[:2]),
                                                    *args64[2:], **kw)
            require(all(same_bits(o[b], s_) for o, s_ in zip(out, single))
                    and all(same_bits(o[b], s_) for o, s_ in zip(out64, single64)),
                    f"batched cluster kernels at {label}: row {b} differs from its single "
                    f"launch")
    sol16, sol16_64 = (*rows_of(sol32[:4], rows16), *c32), (*rows_of(sol64[:2], rows16), *c64)
    cluster_200 = {
        "k3_4": in_turns({"one_block": lambda: fused_sweep_jvp_batch(*sol16, **kw),
                          "cluster": lambda: fused_sweep_jvp_batch_cluster(*sol16, **kw)}, 10),
        "k2_batch": in_turns({"one_block": lambda: fused_residual_sweep_batch(*sol16_64, **kw),
                              "cluster": lambda: fused_residual_sweep_batch_cluster(*sol16_64,
                                                                                    **kw)}, 10)}
    emit("cluster_ensemble", B=B, rows_vs_single_B=16, k3_4_bit_identical=k34_cluster,
         k2_batch_bit_identical=k2b_cluster, ms_in_turns_B16=cluster_200)

    # ms of each against its previous kernel in turns: kernels 3-4 on the 4
    # check rows and on all B, the batched kernel 2 on rows {0, B-1} and on
    # all B.
    full = k34_inputs["solution"]
    rows2 = rows_of((r64, w64), [0, B - 1])
    k34_turns = {
        "B4": in_turns({"previous": lambda: fused_sweep_jvp_batch_previous(*small, *c32, **kw),
                        "new": lambda: fused_sweep_jvp_batch(*small, *c32, **kw)}, 10),
        f"B{B}": in_turns({"previous": lambda: fused_sweep_jvp_batch_previous(*full, **kw),
                           "new": lambda: fused_sweep_jvp_batch(*full, **kw)}, 10)}
    k2b_turns = {
        "B2": in_turns({"previous": lambda: fused_residual_sweep_batch_previous(*rows2, *c64,
                                                                               **kw),
                        "new": lambda: fused_residual_sweep_batch(*rows2, *c64, **kw)}, 10),
        f"B{B}": in_turns({"previous": lambda: fused_residual_sweep_batch_previous(
                               r64, w64, *c64, **kw),
                           "new": lambda: fused_residual_sweep_batch(r64, w64, *c64, **kw)}, 10)}
    k3_ms, k2b_ms, k2b_ms_full = (k34_turns["B4"]["new"], k2b_turns["B2"]["new"],
                                  k2b_turns[f"B{B}"]["new"])
    emit("ensemble_kernels", B=B, k3_max_abs_err=k3_err,
         k3_max_abs_err_vs_plain_f32=k3_err_f32, k3_ms_B4=k3_ms,
         k3_plain_ms_B4=plain_ms, k2_batch_max_abs_err=k2b_err, k2_batch_ms_B2=k2b_ms,
         k2_batch_plain_ms_B2=plain2_ms, k2_batch_ms_full_B=k2b_ms_full,
         rows_bit_identical=True, k3_4_vs_previous_bit_identical=k34_bits,
         k2_batch_vs_previous_bit_identical=k2b_bits, k3_4_turns_ms=k34_turns,
         k2_batch_turns_ms=k2b_turns)

    # Newton-Krylov: 3 timed runs after the warm-up.
    zero_batch_counts()
    runs, xs, infos = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        x_sol, info = solve("newton_krylov")
        runs.append(time.perf_counter() - t0)
        xs.append(x_sol)
        infos.append(info)
    launches, plain_calls = read_batch_counts("ensemble path")
    require(launches["k3_4"] > 0 and launches["k2_batch"] > 0,
            f"a batched kernel of the ensemble path never launched: {launches}")
    require(plain_calls["k3_4"] == 0 and plain_calls["k2_batch"] == 0,
            f"a plain version ran on the ensemble path: {plain_calls}")
    require(all(torch.equal(xs[0], xi) for xi in xs[1:]) and torch.equal(xs[0], x_warm),
            "repeated ensemble solves returned different paths")
    info = infos[0]
    fn = info["residual_norm"]
    require(xs[0].shape == (B, x_ss.numel()) and bool(torch.isfinite(xs[0]).all()),
            "ensemble solution is not finite paths of the expected shape")
    require(bool((fn <= 1e-8).all()) and info["stalled_paths"] == 0,
            f"ensemble NK: max ‖F‖ {float(fn.max()):.3e}, "
            f"{info['stalled_paths']} stalled paths")
    worst = int(fn.argmax())
    plain_fn = {}
    for b in sorted({0, B - 1, worst}):
        F_plain = make_full_residual_fn(model, ss0, ssT, {"Z": exog_b["Z"][b]})
        plain_fn[b] = float(torch.linalg.norm(F_plain(xs[0][b])))
        require(plain_fn[b] < 1e-8, f"plain f64 ‖F‖ of row {b} is {plain_fn[b]:.3e}")
    single = make_path_solver(Jbar, {"Z": exog_b["Z"][B - 1]}, model, ss0, ssT,
                              method="newton_krylov", direction_dtype=f32, eps=1e-8,
                              gmres_restart=10)
    x_one, _ = single(x_ss)
    emit("ensemble_nk", B=B, median_s=statistics.median(runs), runs_s=runs,
         outer_iterations=info["iterations"], matvecs=info["inner_iterations"],
         residual_norm_max=float(fn.max()), residual_norm_median=float(fn.median()),
         residual_norm_plain_f64=plain_fn, host_ls_s=[i["host_ls_seconds"] for i in infos],
         stalled_paths=info["stalled_paths"], launches=launches, plain_calls=plain_calls,
         bit_identical=True, row_last_vs_single_path_max_abs=max_abs(xs[0][B - 1], x_one))

    # Lockstep boehl Richardson: one run.
    zero_batch_counts()
    t0 = time.perf_counter()
    x_rich, info_r = solve("boehl")
    rich_s = time.perf_counter() - t0
    rich_launches, rich_plain = read_batch_counts("boehl ensemble path")
    fr = info_r["residual_norm"]
    require(bool((fr <= 1e-8).all()) and info_r["stalled_paths"] == 0,
            f"ensemble boehl: max ‖F‖ {float(fr.max()):.3e}, "
            f"{info_r['stalled_paths']} stalled paths")
    require(rich_plain["k3_4"] == 0 and rich_plain["k2_batch"] == 0,
            f"a plain version ran on the boehl ensemble path: {rich_plain}")
    emit("ensemble_boehl", B=B, seconds=rich_s, outer_iterations=info_r["iterations"],
         sweeps=info_r["inner_iterations"], residual_norm_max=float(fr.max()),
         launches=rich_launches, max_abs_vs_nk=max_abs(x_rich, xs[0]))

    # Throughput of kernels 3-4 and of the previous kernels by width (rows of
    # the solution), in turns at each width.
    gen = torch.Generator().manual_seed(2)
    width_ms, width_ms_previous = {}, {}
    for Bw in widths:
        idx = torch.arange(Bw, device=dev) % B
        v_w = torch.randn((Bw, x_ss.numel()), generator=gen, dtype=f64).to(dev)
        args_w = (*prices(xs[0][idx], f32), *prices(v_w, f32))
        turns = in_turns({"previous": lambda: fused_sweep_jvp_batch_previous(*args_w, *c32, **kw),
                          "new": lambda: fused_sweep_jvp_batch(*args_w, *c32, **kw)}, 5)
        width_ms[Bw], width_ms_previous[Bw] = turns["new"], turns["previous"]
    emit("ensemble_throughput", ms_per_launch=width_ms,
         sweeps_per_s={Bw: Bw / (ms / 1e3) for Bw, ms in width_ms.items()},
         ms_per_launch_previous=width_ms_previous)

    # f64 directions: the batched f64 tangent sweep and the f64-direction
    # Newton-Krylov solve, held to the f32 solve's rows.
    f64_entry, f64_solved = ensemble_f64_phase(model, ss0, ssT, Jbar, x_ss, exog_b, x_warm,
                                               xs[0], c64, kw)

    # Bounds of the timed calls: the batched kernel 1 on the 4 check rows,
    # the batched kernel 2 on rows {0, B-1}.
    n_a, n_e = wealth.n, prod.n
    k3_bound = least_time(nbytes(*small, *c32) + 4 * nbytes(small[0]),
                          one_asset_sweep_ops(Tm1, n_a, n_e, True, len(check_rows)), "f32")
    rows2 = rows_of((r64, w64), [0, B - 1])
    k2b_bound = least_time(nbytes(*rows2, *c64) + 2 * nbytes(rows2[0]),
                           one_asset_sweep_ops(Tm1, n_a, n_e, False, 2), "f64")
    solver_points = ("x_ss", "solution")
    entry = {"route": "cuda", "source": "hank_tpu_torch/csrc/household_sweep.cu",
             "launches": launches["k3_4"], "max_abs_err": k3_err, "ms": k3_ms,
             "plain_ms": plain_ms, **k3_bound, "library_ms": None,
             "ms_previous": k34_turns["B4"]["previous"],
             "fallback_rows": fallback_sum(k34_bits, solver_points),
             f"ms_B{B}": k34_turns[f"B{B}"]["new"],
             f"ms_previous_B{B}": k34_turns[f"B{B}"]["previous"]}
    solved = {"exog_b": exog_b, "x": xs[0], "info": info, "median_s": statistics.median(runs),
              "cluster_200": cluster_200, "f64": f64_solved}
    return [
        {"name": "fused_sweep_jvp_batch (backward EGM)",
         "replaces": "hank_tpu/ops/fused_sweep_batch.py:87", **entry},
        {"name": "fused_sweep_jvp_batch (forward lottery)",
         "replaces": "hank_tpu/ops/fused_sweep_batch.py:177", **entry},
        {"name": "fused_residual_sweep_batch", "route": "cuda",
         "source": "hank_tpu_torch/csrc/household_sweep.cu",
         "replaces": "hank_tpu/ops/fused_ds.py:338", "launches": launches["k2_batch"],
         "max_abs_err": k2b_err, "ms": k2b_ms, "plain_ms": plain2_ms, **k2b_bound,
         "library_ms": None, "ms_previous": k2b_turns["B2"]["previous"],
         "fallback_rows": fallback_sum(k2b_bits, solver_points),
         f"ms_B{B}": k2b_ms_full, f"ms_previous_B{B}": k2b_turns[f"B{B}"]["previous"],
         "launches_f64_ensemble": f64_solved["launches_per_solve"]["k2_batch"]["launches"]},
        f64_entry,
    ], solved


def f64_sweep_batch_rows(args, consts, kw, widths, template: bool) -> dict:
    """The batched f64 tangent sweep (`fused_sweep_jvp_f64_batch`, the tier
    its wrapper decides) on the first Bw rows of `args` ((B, T-1) f64 r, w,
    dr, dw) for each width Bw in `widths`: every output row and fallback
    count bit for bit a single `fused_sweep_jvp_f64` launch on its row.
    With `template`, every output bit for bit the counting template's
    `<double, true, true>` (`fused_sweep_jvp_f64_batch_previous`), the two
    timed in turns (template, batched, batched, template); else the batched
    one timed alone. Returns {Bw: report}."""
    import torch

    from hank_tpu_torch.ops.fused_sweep import fused_sweep_jvp_f64
    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_f64_batch,
                                                      fused_sweep_jvp_f64_batch_previous)

    report = {}
    for Bw in widths:
        rows = [a[:Bw].contiguous() for a in args]
        fb, fb_single = (torch.zeros((Bw, 2), dtype=torch.int32, device=rows[0].device)
                         for _ in range(2))
        out = fused_sweep_jvp_f64_batch(*rows, *consts, **kw, fallback_rows=fb)
        for b in range(Bw):
            single = fused_sweep_jvp_f64(*(q[b].contiguous() for q in rows), *consts, **kw,
                                         fallback_rows=fb_single[b])
            require(all(same_bits(o[b], s_) for o, s_ in zip(out, single)),
                    f"batched f64 tangent sweep at B={Bw}: row {b} differs from its single "
                    f"launch")
        require(torch.equal(fb, fb_single),
                f"batched f64 tangent sweep at B={Bw}: fallback counts differ")
        entry = {"rows_bit_identical": True, "fallback_rows": fb.sum(0).tolist(),
                 "finite": all(bool(torch.isfinite(o).all()) for o in out)}
        if template:
            previous = fused_sweep_jvp_f64_batch_previous(*rows, *consts, **kw)
            require(all(same_bits(a, b) for a, b in zip(out, previous)),
                    f"batched f64 tangent sweep at B={Bw} differs from the template's "
                    f"<double, true, true>")
            turns = in_turns({
                "template": lambda: fused_sweep_jvp_f64_batch_previous(*rows, *consts, **kw),
                "batched": lambda: fused_sweep_jvp_f64_batch(*rows, *consts, **kw)}, 5)
            entry.update(template_bit_identical=True, ms=turns["batched"],
                         ms_template=turns["template"])
        else:
            entry["ms"] = cuda_ms(lambda: fused_sweep_jvp_f64_batch(*rows, *consts, **kw), 5)
        report[Bw] = entry
    return report


def counter_total(fn) -> int:
    """A wrapper's launches on every tier, or a plain version's calls."""
    return sum(getattr(fn, a, 0) for a in ("launches", "launches_cluster", "launches_global",
                                           "calls"))


def zero_counter(fn) -> None:
    for a in ("launches", "launches_cluster", "launches_global", "calls"):
        if hasattr(fn, a):
            setattr(fn, a, 0)


@contextlib.contextmanager
def plain_F_counter():
    """Within the block, the plain f64 F's evaluations by the ensemble's
    routes (taken by `parallel.ensemble.make_full_residual_fn`, vmapped for
    F_b or under `torch.func.jvp` for the AD directions); yields [count]."""
    import hank_tpu_torch.parallel.ensemble as ens

    calls, plain = [0], ens.make_full_residual_fn

    def counted_residual(*a):
        F = plain(*a)

        def counted(x):
            calls[0] += 1
            return F(x)

        return counted

    ens.make_full_residual_fn = counted_residual
    try:
        yield calls
    finally:
        ens.make_full_residual_fn = plain


def f64_ensemble_solve(path: str, solve, launched: dict, quiet: dict, timed: int) -> dict:
    """The f64-direction ensemble solve `solve()` (-> x, info): one warm-up,
    then `timed` runs with every counter zeroed right before: each wrapper
    of `launched` ({key: wrapper}) launched on some tier, each of `quiet`
    (wrappers, plain versions) and the plain f64 F (`plain_F_counter`: the
    vmapped F and the AD directions) not at all, no previous kernel, and
    the runs bit-identical to the warm-up. Returns the path, info, seconds
    and counts."""
    import torch

    x_warm, _ = solve()
    for fn in (*launched.values(), *quiet.values()):
        zero_counter(fn)
    zero_previous_launches()
    runs, xs = [], []
    with plain_F_counter() as plain_F:
        for _ in range(timed):
            t0 = time.perf_counter()
            x, info = solve()
            runs.append(time.perf_counter() - t0)
            xs.append(x)
    launches = {k: {a: getattr(fn, a) for a in ("launches", "launches_cluster",
                                               "launches_global") if hasattr(fn, a)}
                for k, fn in launched.items()}
    others = {k: counter_total(fn) for k, fn in quiet.items()}
    previous = previous_launches()
    require(all(sum(n.values()) > 0 for n in launches.values()),
            f"{path}: a kernel of the route never launched: {launches}")
    require(not any(others.values()) and plain_F[0] == 0 and not any(previous.values()),
            f"{path}: a plain version, another kernel, the plain F or AD ran: {others}, "
            f"plain F {plain_F[0]}, previous {previous}")
    require(all(torch.equal(x_warm, xi) for xi in xs),
            f"{path}: repeated solves returned different paths")
    return {"x": xs[0], "info": info, "runs": runs, "launches": launches, "others": others,
            "plain_F_calls": plain_F[0]}


def one_asset_f64_ensemble(path: str, model, ss0, ssT, Jbar, x0, exog_b, x_f32,
                           timed: int = 3) -> dict:
    """Phases 6 and 8: the one-asset ensemble with f64 directions
    (`solve_ensemble_host(direction_dtype=None)`, Newton-Krylov, eps 1e-8,
    GMRES to 1e-12) through `f64_ensemble_solve`: the batched f64 tangent
    sweep and the batched kernel 2 launched, no plain version, AD or other
    kernel; every row ‖F‖ ≤ 1e-8, re-checked by the plain f64 pipeline on
    the first and last rows and by the batched kernel 2 on all rows
    (`residual_ensemble`), and within 1e-7 of the f32 ensemble's row
    (`x_f32`). Emits its JSON line and returns the measurements."""
    import torch

    from hank_tpu_torch.ops import fused_residual as fr
    from hank_tpu_torch.ops import fused_sweep as fs
    from hank_tpu_torch.ops import fused_sweep_batch as fsb
    from hank_tpu_torch.parallel.ensemble import residual_ensemble, solve_ensemble_host
    from hank_tpu_torch.solvers.newton import make_full_residual_fn

    def solve():
        x, info = solve_ensemble_host(x0, Jbar, exog_b, model, ss0, ssT, eps=1e-8,
                                      method="newton_krylov", direction_dtype=None)
        torch.cuda.synchronize()
        return x, info

    got = f64_ensemble_solve(
        path, solve, {"jvp_f64_batch": fsb.fused_sweep_jvp_f64_batch,
                      "k2_batch": fr.fused_residual_sweep_batch},
        {"jvp_f64_batch_plain": fsb.fused_sweep_jvp_f64_batch_reference,
         "k2_batch_plain": fr.fused_residual_sweep_batch_reference,
         "k3_4": fsb.fused_sweep_jvp_batch, "k3_4_plain": fsb.fused_sweep_jvp_batch_reference,
         "jvp_f64": fs.fused_sweep_jvp_f64, "jvp_f64_plain": fs.fused_sweep_jvp_reference,
         "k2": fr.fused_residual_sweep, "k2_plain": fr.fused_residual_sweep_reference},
        timed)
    x, info = got["x"], got["info"]
    B = x.shape[0]
    fn = info["residual_norm"]
    require(bool(torch.isfinite(x).all()) and x.shape == x_f32.shape,
            f"{path}: not finite paths of the expected shape")
    require(bool((fn <= 1e-8).all()) and info["stalled_paths"] == 0,
            f"{path}: max ‖F‖ {float(fn.max()):.3e}, {info['stalled_paths']} stalled paths")
    plain_fn = {}
    for b in (0, B - 1):
        F_plain = make_full_residual_fn(model, ss0, ssT, {k: v[b] for k, v in exog_b.items()})
        plain_fn[b] = float(torch.linalg.norm(F_plain(x[b])))
        require(plain_fn[b] <= 1e-8, f"{path}: plain f64 ‖F‖ of row {b} is {plain_fn[b]:.3e}")
    kernel2_fn = torch.linalg.vector_norm(residual_ensemble(x, exog_b, model, ss0, ssT), dim=1)
    require(bool((kernel2_fn <= 1e-8).all()),
            f"{path}: batched kernel 2's ‖F‖ up to {float(kernel2_fn.max()):.3e}")
    vs_f32 = float((x - x_f32).abs().amax(dim=1).max())
    require(vs_f32 <= 1e-7, f"{path}: a row is {vs_f32:.3e} off the f32 ensemble's")
    n = len(got["runs"])
    per_solve = {k: {a: c // n for a, c in v.items()} for k, v in got["launches"].items()}
    report = {"B": B, "median_s": statistics.median(got["runs"]), "runs_s": got["runs"],
              "outer_iterations": info["iterations"], "directions": info["inner_iterations"],
              "F_b_per_solve": sum(per_solve["k2_batch"].values()),
              "residual_norm_max": float(fn.max()), "residual_norm_plain_f64": plain_fn,
              "residual_norm_kernel2_max": float(kernel2_fn.max()),
              "max_abs_vs_f32_ensemble": vs_f32, "launches_per_solve": per_solve,
              "others": got["others"], "plain_F_calls": got["plain_F_calls"],
              "host_ls_s": info["host_ls_seconds"], "bit_identical": True}
    emit(path, **report)
    return {**report, "launches_total": got["launches"]}


def ensemble_f64_entry(name: str, launches: int, err: float, ms: float, plain_ms: float,
                       bound: dict, **extra) -> dict:
    """A `kernels` entry of the batched f64 tangent sweep (one of its three
    tiers)."""
    return {"name": name, "route": "cuda",
            "source": ("hank_tpu_torch/csrc/household_sweep_cluster.cu" if "cluster" in name
                       else "hank_tpu_torch/csrc/household_sweep.cu"),
            "replaces": "hank_tpu/parallel/ensemble.py:247-279 (f64 ensemble directions by "
                        "vmapped jax.jvp under XLA; no TPU kernel)",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound, "library_ms": None, **extra}


def ensemble_f64_phase(model, ss0, ssT, Jbar, x_ss, exog_b, x_rows, x_f32, c64, kw) -> tuple:
    """Phase 6's f64 directions (KS 200×7, T=300, B rows): the batched f64
    tangent sweep on the warm-up's rows along smooth seeded f64 directions,
    at B = 1, 16 and 64, rows bit for bit single launches and the whole bit
    for bit the counting template's `<double, true, true>`, timed in turns
    with it; on the grid with two knots swapped (its fallback branches) at
    B = 16; row 0 within 1e-10·max(scale, 1) of its plain version; then the
    f64-direction ensemble solve (`one_asset_f64_ensemble`). Returns its
    `kernels` entry and the solve's report."""
    import torch

    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_f64_batch,
                                                      fused_sweep_jvp_f64_batch_reference)

    f64 = torch.float64
    B, n = x_rows.shape
    cs = model.compspec
    Tm1, nE = cs.T - 1, cs.n_endog
    endog = model.vars_of_type("endogenous")
    i_r, i_w = endog.index("r"), endog.index("w")

    def prices(x_b):
        xp = x_b.reshape(B, Tm1, nE)
        return [xp[:, :, i].to(f64).contiguous() for i in (i_r, i_w)]

    gen = torch.Generator().manual_seed(23)
    decay = (0.9 ** torch.arange(Tm1, dtype=f64))[None, :, None]
    v_b = (torch.randn((B, 1, nE), generator=gen, dtype=f64) * decay).reshape(B, -1).to(
        x_rows.device)
    args = [*prices(x_rows), *prices(v_b)]
    rows = f64_sweep_batch_rows(args, c64, kw, (1, 16, B), template=True)
    k = int(model.endog_dims()[0].n) // 2
    swapped = c64[2].clone()
    swapped[[k, k + 1]] = swapped[[k + 1, k]]
    rows_swapped = f64_sweep_batch_rows(args, (*c64[:2], swapped, *c64[3:]), kw, (16,),
                                        template=True)
    require(rows_swapped[16]["fallback_rows"][1] > 0,
            f"the swapped grid took no fallback branch: {rows_swapped}")
    one = [a[:1].contiguous() for a in args]
    out = fused_sweep_jvp_f64_batch(*one, *c64, **kw)
    ref, plain_ms = cuda_once(lambda: fused_sweep_jvp_f64_batch_reference(*one, *c64, **kw))
    err = max(max_abs(o, r_) for o, r_ in zip(out, ref))
    scale = max(float(r_.abs().max()) for r_ in ref)
    require(err <= 1e-10 * max(scale, 1.0),
            f"batched f64 tangent sweep off its plain version by {err:.3e} (scale {scale:.3e})")
    emit("ensemble_f64_kernels", B=B, rows=rows, rows_grid_swapped=rows_swapped,
         max_abs_err_vs_plain_row0=err, plain_ms_B1=plain_ms)
    solved = one_asset_f64_ensemble("ensemble_f64_nk", model, ss0, ssT, Jbar, x_ss, exog_b,
                                    x_f32)
    n_a, n_e = model.endog_dims()[0].n, model.exog_dims()[0].n
    bound = least_time(nbytes(*args, *c64) + 4 * nbytes(args[0]),
                       one_asset_sweep_ops(Tm1, n_a, n_e, True, B), "f64")
    entry = ensemble_f64_entry(
        "fused_sweep_jvp_f64_batch <double,true,true>",
        solved["launches_per_solve"]["jvp_f64_batch"]["launches"], err, rows[B]["ms"], plain_ms,
        bound, B=B, plain_ms_at="B=1", ms_template=rows[B]["ms_template"],
        **{f"ms_B{Bw}": r["ms"] for Bw, r in rows.items()},
        **{f"ms_template_B{Bw}": r["ms_template"] for Bw, r in rows.items()},
        grid="200x7, T=300")
    return entry, solved


def mesh_phase(model, ss0, ssT, Jbar, x_ss, x_warm, exog, ensemble: dict, dryrun) -> dict:
    """Phase 10: the meshed paths in a one-rank group on the card (see the
    module docstring); `dryrun` the `Background` job of
    `dryrun_multichip(1)`, run beside phase 7's setup. Emits its JSON line
    and returns the batched kernels' launches in the meshed solves."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from hank_tpu_torch.blocks.backward import backward_iteration
    from hank_tpu_torch.blocks.forward import forward_iteration
    from hank_tpu_torch.parallel.ensemble import solve_ensemble_host
    from hank_tpu_torch.parallel.mesh import destroy_distributed, init_distributed, make_mesh
    from hank_tpu_torch.parallel.state_sharding import (backward_iteration_sharded,
                                                        forward_iteration_sharded)
    from hank_tpu_torch.solvers.ss_jacobian import (direct_jacobian_columns,
                                                    get_steady_state_jacobian)
    from hank_tpu_torch.solvers.steady_state import single_run

    cs = model.compspec
    Tm1, nE = cs.T - 1, cs.n_endog
    out = {}
    init_distributed(x_ss.device)
    try:
        out["backend"], out["world_size"] = dist.get_backend(), dist.get_world_size()
        mesh = make_mesh()

        # J̄ with its seeds on the mesh. The lottery's scatter_add sums with
        # atomics on the card, so two builds of J̄ differ in the last bits:
        # the meshed J̄ is held bit for bit to an unmeshed one with both
        # built under torch's deterministic algorithms, and to phase 3's J̄
        # within 1e-12 (an unmeshed rebuild's gap to it is reported).
        t0 = time.perf_counter()
        J_mesh = get_steady_state_jacobian(ssT, model, mesh=mesh)
        torch.cuda.synchronize()
        out["jacobian_s"] = time.perf_counter() - t0
        out["jacobian_vs_phase3_max_abs"] = max_abs(J_mesh, Jbar)
        out["jacobian_rebuild_vs_phase3_max_abs"] = max_abs(
            get_steady_state_jacobian(ssT, model), Jbar)
        require(out["jacobian_vs_phase3_max_abs"] <= 1e-12,
                f"the meshed J̄ is off phase 3's by {out['jacobian_vs_phase3_max_abs']:.3e}")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            J_det = get_steady_state_jacobian(ssT, model)
            J_det_mesh = get_steady_state_jacobian(ssT, model, mesh=mesh)
        finally:
            torch.use_deterministic_algorithms(False)
        require(torch.equal(J_det_mesh, J_det), "under deterministic algorithms the meshed "
                f"J̄ differs from the unmeshed one (max abs {max_abs(J_det_mesh, J_det):.3e})")
        out["jacobian_deterministic_bits_equal"] = True
        # J̄ of the AD tools' horizon (below), on the mesh.
        ad_model = dataclasses.replace(model, compspec=dataclasses.replace(cs, T=AD_TOOLS_T))
        J0_mesh = get_steady_state_jacobian(ss0, ad_model, mesh=mesh)

        # Phase 6's Newton-Krylov ensemble on the mesh: its path bit for bit,
        # its outers and matvecs, through kernels 3-4 and the batched kernel 2.
        def solve():
            x, info = solve_ensemble_host(x_ss, Jbar, ensemble["exog_b"], model, ss0, ssT,
                                          mesh=mesh, eps=1e-8, method="newton_krylov",
                                          direction_dtype=torch.float32)
            torch.cuda.synchronize()
            return x, info

        solve()
        zero_batch_counts()
        runs, xs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            x, info = solve()
            runs.append(time.perf_counter() - t0)
            xs.append(x)
        launches, plain_calls = read_batch_counts("meshed ensemble path")
        require(launches["k3_4"] > 0 and launches["k2_batch"] > 0,
                f"a batched kernel never launched on the meshed ensemble path: {launches}")
        require(not any(plain_calls.values()),
                f"a plain version ran on the meshed ensemble path: {plain_calls}")
        ref = ensemble["info"]
        require(all(torch.equal(xi, ensemble["x"]) for xi in xs),
                "the meshed ensemble solve differs from phase 6's")
        require((info["iterations"], info["inner_iterations"], info["stalled_paths"])
                == (ref["iterations"], ref["inner_iterations"], ref["stalled_paths"])
                and torch.equal(info["residual_norm"], ref["residual_norm"]),
                f"the meshed ensemble solve took another schedule: {info} against {ref}")
        out.update(ensemble_nk_median_s=statistics.median(runs), ensemble_nk_runs_s=runs,
                   phase6_median_s=ensemble["median_s"], outer_iterations=info["iterations"],
                   matvecs=info["inner_iterations"], launches=launches, plain_calls=plain_calls,
                   bit_identical_to_phase6=True)

        # The household blocks with the state split over a one-rank axis, at
        # phase 4's warm-up solution.
        state_mesh = make_mesh(axis_names=("state",))
        pol = backward_iteration(x_warm, exog, model, ssT.vars, ssT.value)
        pol_sh = backward_iteration_sharded(x_warm, exog, model, ssT.vars, ssT.value, state_mesh)
        agg = forward_iteration(pol, model, ss0.D)
        agg_sh = forward_iteration_sharded(pol_sh, model, ss0.D, state_mesh)
        out["state_backward_max_abs"] = max(max_abs(pol_sh[k], pol[k]) for k in pol)
        out["state_forward_max_abs"] = max(max_abs(agg_sh[k], agg[k]) for k in agg)
        out["state_bits_equal"] = (all(torch.equal(pol_sh[k], pol[k]) for k in pol)
                                   and all(torch.equal(agg_sh[k], agg[k]) for k in agg))
        require(out["state_backward_max_abs"] <= 1e-12 and out["state_forward_max_abs"] <= 1e-12,
                f"state-split blocks off the unsplit ones: {out}")
    finally:
        destroy_distributed()

    # The AD validation tools on the last period's n_endog columns, held to
    # J̄ at the initial steady state (Z = 1, the point `tests/test_jacobian.py`
    # checks at); at the ending steady state the difference is reported. On
    # the model cut to T = AD_TOOLS_T (the steady states do not depend on T).
    cols = [(AD_TOOLS_T - 2) * nE + i for i in range(nE)]
    t0 = time.perf_counter()
    jvp_cols = direct_jacobian_columns(ss0, ss0, ad_model, cols)
    torch.cuda.synchronize()
    out["jvp_columns_s"] = time.perf_counter() - t0
    out["ad_tools_T"] = AD_TOOLS_T
    out["jvp_columns_vs_jbar_ss0_max_abs"] = max_abs(jvp_cols, J0_mesh[:, cols])
    require(out["jvp_columns_vs_jbar_ss0_max_abs"] <= 1e-9,
            f"direct JVP columns off J̄'s by {out['jvp_columns_vs_jbar_ss0_max_abs']:.3e}")
    out["fd_columns_vs_jvp_max_abs"] = max_abs(
        direct_jacobian_columns(ss0, ss0, ad_model, cols, mode="fd"), jvp_cols)
    out["fd_step"] = cs.dx
    out["jvp_columns_vs_jbar_ssT_max_abs"] = max_abs(
        direct_jacobian_columns(ssT, ssT, ad_model, cols),
        get_steady_state_jacobian(ssT, ad_model)[:, cols])
    out["single_run_norm"] = float(torch.linalg.norm(single_run(ss0, ssT, model, exog)))

    # The dry run of the SP, TP and DP paths, one spawned NCCL rank, which
    # ran beside phase 7's setup (its seconds are its own wall-clock there).
    out["dryrun"] = dryrun.wait()
    out["dryrun_s"] = dryrun.seconds
    emit("mesh", **out)
    return launches


def two_asset_phase(dev, ptxas, cache: str, beside=None) -> tuple:
    """Phase 7: the two-asset production route at full width (see the
    module docstring). Emits its JSON lines and returns the `kernels`
    entries of kernels 5 and 6, of the f64 pair and of the f64 tangent
    pair, and what phase 11 reuses: the model, both steady states, J̄ and
    x_ss. `ptxas` is phase 2's per-kernel report; the steady state and J̄
    go to `cache` (a `HANK_TPU_TORCH_CACHE` directory), where the CLI's
    default run reads them. `beside`, a `Background` job started before
    this phase, is waited for after the setup, before any timed check."""
    import numpy as np
    import torch

    from hank_tpu_torch.blocks.assemble import residuals as eval_residuals
    from hank_tpu_torch.model.structures import generate_exog_paths
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.models.hank_two_asset import fused2_prices
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2
    from hank_tpu_torch.solvers import newton as newton_mod
    from hank_tpu_torch.solvers.linear import linear_impulse_response
    from hank_tpu_torch.solvers.newton import make_full_residual_fn, make_path_solver
    from hank_tpu_torch.utils.checkpoint import get_or_solve

    f32, f64 = torch.float32, torch.float64
    model = load_model("hank_two_asset", T=300, device=dev)
    cs = model.compspec
    Tm1, nE = cs.T - 1, cs.n_endog
    p = model.params

    # Setup: the steady state (transitory shock: one) and J̄, solved afresh
    # into the phase's cache.
    t0 = time.perf_counter()
    artifacts = os.path.join(cache, "artifacts")
    os.makedirs(artifacts, exist_ok=True)
    ss0, ssT, Jbar = get_or_solve(model, cache_dir=artifacts)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if beside is not None:
        beside.wait()          # a `Background` job, done before any timed check
    col = torch.stack([torch.as_tensor(ssT.vars[k]) for k in model.var_names()])
    F_ss = float(eval_residuals(col[:, None].expand(cs.n_v, 1 + cs.max_lag + cs.max_lead),
                                model).abs().max())
    require(F_ss <= 1e-9, f"two-asset steady state residual {F_ss:.3e} > 1e-9")
    clearing = max(abs(float(ssT.vars["B"]) - p["Bg"]),
                   abs(float(ssT.vars["A"]) - float(ssT.vars["KS"])))
    require(clearing <= 1e-8, f"two-asset markets off by {clearing:.3e}")
    with np.load(TWO_ASSET_REFERENCE) as z:
        ref_vars = dict(zip([str(s) for s in z["var_names"]], z["var_values"]))
        x_jax = torch.as_tensor(z["x"], dtype=f64, device=dev)
    ss_gap = max(abs(float(ssT.vars[k]) - float(v)) for k, v in ref_vars.items())
    require(ss_gap <= 1e-8, f"two-asset steady state {ss_gap:.3e} off the JAX reference")
    emit("two_asset_setup", grid=list(model.state_shape()), T=cs.T, seconds=setup_s,
         max_abs_F_ss=F_ss, market_clearing=clearing, max_abs_vs_jax_ss=ss_gap,
         KS=float(ssT.vars["KS"]), r=float(ssT.vars["r"]), ra=float(ssT.vars["ra"]))

    # The route of `bench.py:282-310`: the linear warm start, then the
    # GMRES-endgame-only boehl solve, when the linear step beats the forcing
    # (‖F(x_lin)‖ < ‖F(x_ss)‖) and the endgame reaches EPS; otherwise the
    # two-phase boehl solve from x_ss (Richardson, then the endgame).
    exog = generate_exog_paths(model, Tm1)
    endog = model.vars_of_type("endogenous")
    x_ss = torch.stack([torch.as_tensor(ssT.vars[k]) for k in endog]).repeat(Tm1)

    def boehl(**kw):
        return make_path_solver(Jbar, exog, model, ss0, ssT, method="boehl",
                                direction_dtype=f32, eps=EPS, host_inner=True, **kw)

    # The plain f64 F's calls by these solvers (their F, and the endgame's AD
    # and fd rungs), counted through the name they are built from.
    plain_F_calls = [0]
    plain_residual = newton_mod.make_full_residual_fn

    def counted_residual(*a):
        F = plain_residual(*a)

        def counted(x):
            plain_F_calls[0] += 1
            return F(x)

        return counted

    newton_mod.make_full_residual_fn = counted_residual
    endgame_only, two_phase = boehl(richardson_max_outer=0), boehl()
    newton_mod.make_full_residual_fn = plain_residual

    def lin_route():
        x_lin, _ = linear_impulse_response(Jbar, exog, model, ss0, ssT,
                                           compute_residual=False)
        x, info = endgame_only(x_lin)
        torch.cuda.synchronize()
        return x, info

    def ss_route():
        x, info = two_phase(x_ss)
        torch.cuda.synchronize()
        return x, info

    x_lin, lin_info = linear_impulse_response(Jbar, exog, model, ss0, ssT)
    lin_ok = lin_info["residual_norm"] < lin_info["f0_norm"]
    route, route_name = lin_route, "linstart_endgame_only"
    if lin_ok:
        x_warm, info_warm = route()
    if not lin_ok or info_warm["residual_norm"] > EPS:
        route, route_name = ss_route, "ss_two_phase_fallback"
        x_warm, info_warm = route()

    # Kernels 5 and 6 at the route's own points, along smooth seeded
    # directions (a random amplitude per variable, decaying as 0.9ᵗ), each
    # against its plain version run in float64 on the same input values.
    # Kernel 5's primal policies are held pointwise. Its tangents are held
    # where the path consumes them, aggregated by kernel 6's plain version:
    # pointwise, a state that f32 and f64 rounding put on different sides of
    # a bracket or clip takes a different one-sided tangent (reported).
    m32 = fs2.cast_model(model, f32)
    VT32, D32 = ssT.value.to(f32).contiguous(), ss0.D.to(f32).contiguous()
    VT64, D64 = VT32.double(), D32.double()
    gen = torch.Generator().manual_seed(7)
    decay = (0.9 ** torch.arange(Tm1, dtype=f64))[:, None]

    def smooth():
        return (torch.randn(nE, generator=gen, dtype=f64) * decay).reshape(-1).to(dev)

    def k5_args(x, v):
        return [q.to(f32).contiguous() for q in
                (*fused2_prices(x.reshape(Tm1, nE), exog, model),
                 *fused2_prices(v.reshape(Tm1, nE), exog, model))]

    def as64(d):
        return {k: t.double() for k, t in d.items()}

    def bound(err, ref):
        scale = max(float(t.abs().max()) for t in ref.values())
        return err <= 5e-5 * max(scale, 1.0), scale

    def dict_err(a, b):
        return max(max_abs(a[k].double(), b[k]) for k in b)

    checks, k5_err, k6_err, f64_inputs = {}, 0.0, 0.0, {}
    for name, x in (("x_ss", x_ss), ("solution", x_warm)):
        args = k5_args(x, smooth())
        pol, dpol = fs2.fused2_policies_jvp(*args, VT32, m32)
        ref, dref = fs2.fused2_policies_jvp_reference(*(a.double() for a in args), VT64, model)
        # The same f64 inputs, and their plain run, check the f64 tangent pair.
        f64_inputs[name] = ([a.double() for a in args], VT64, D64, (ref, dref))
        agg, dagg = fs2.fused2_forward_jvp(pol, dpol, D32, m32)
        ragg, rdagg = fs2.fused2_forward_jvp_reference(as64(pol), as64(dpol), D64, model)
        _, pdagg = fs2.fused2_forward_jvp_reference(ref, dref, D64, model)
        e5p, e5t, e6 = dict_err(pol, ref), dict_err(rdagg, pdagg), max(
            dict_err(agg, ragg), dict_err(dagg, rdagg))
        for what, err, refs in (("kernel 5 policies", e5p, ref),
                                ("kernel 5 tangents (aggregated)", e5t, pdagg),
                                ("kernel 6", e6, {**ragg, **{"d" + k: t for k, t in rdagg.items()}})):
            ok, scale = bound(err, refs)
            require(ok, f"{what} at {name} off its plain version by {err:.3e} (scale {scale:.3e})")
        e5_point = dict_err(dpol, dref)
        ok_share = min(float(((dpol[k].double() - dref[k]).abs()
                              <= 5e-5 * max(float(dref[k].abs().max()), 1.0)).double().mean())
                       for k in dref)
        checks[name] = {"k5_policies": e5p, "k5_tangents_aggregated": e5t, "k6": e6,
                        "k5_tangents_pointwise": e5_point,
                        "k5_tangent_share_within_bound": ok_share}
        k5_err, k6_err = max(k5_err, e5p, e5t), max(k6_err, e6)

    # Zero tangent, bit-identical repeats, and an i.i.d. direction (reported).
    zero = [torch.zeros_like(a) for a in args[4:]]
    pol0, dpol0 = fs2.fused2_policies_jvp(*args[:4], *zero, VT32, m32)
    _, dagg0 = fs2.fused2_forward_jvp(pol0, dpol0, D32, m32)
    require(all(bool((t == 0).all()) for t in (*dpol0.values(), *dagg0.values())),
            "kernels 5-6: a zero tangent did not give exactly zero")
    pol_b, dpol_b = fs2.fused2_policies_jvp(*args, VT32, m32)
    agg_b, dagg_b = fs2.fused2_forward_jvp(pol_b, dpol_b, D32, m32)
    require(all(torch.equal(a[k], b[k]) for a, b in ((pol, pol_b), (dpol, dpol_b),
                                                     (agg, agg_b), (dagg, dagg_b)) for k in a),
            "kernels 5-6: repeated launches differ")
    # Kernel 6 against the previous kernel 6, bit for bit, at x_ss, at the
    # solution, at a smooth seeded point, and at three stress inputs: every
    # liquid policy on the first knot (all sources at the borrowing limit),
    # 1% i.i.d. noise on the policies, and one NaN policy.
    k5_inputs, k6_inputs = {}, {}
    smooth_x = x_ss + (1e-3 * torch.randn(nE, generator=gen, dtype=f64)
                       * decay).reshape(-1).to(dev)
    for name, x in (("x_ss", x_ss), ("solution", x_warm), ("smooth", smooth_x)):
        k5_inputs[name] = (k5_args(x, smooth()), VT32)
        k6_inputs[name] = fs2.fused2_policies_jvp(*k5_inputs[name][0], VT32, m32)
    pol_s, dpol_s = k6_inputs["solution"]
    liquid = model.heterogeneity["liquid"]
    knot = {**pol_s, "B": torch.full_like(pol_s["B"], float(liquid.grid[0]))}
    noisy = {k: t * (1.0 + 0.01 * torch.randn(t.shape, generator=gen).to(dev))
             for k, t in pol_s.items()}
    nan_pol = {k: t.clone() for k, t in pol_s.items()}
    nan_pol["B"].view(-1)[int(torch.randint(0, nan_pol["B"].numel(), (1,), generator=gen))] = \
        float("nan")
    k6_inputs.update(first_knot=(knot, dpol_s), noise_1pct=(noisy, dpol_s),
                     one_nan=(nan_pol, dpol_s))
    k6_bits = kernel6_vs_previous(k6_inputs, D32, m32)
    require(not k6_bits["one_nan"]["finite"] and k6_bits["solution"]["finite"],
            f"kernel 6: the NaN input gave finite outputs or the solution did not: {k6_bits}")
    # Kernel 5 against the previous kernel 5, bit for bit, at the same three
    # points and at three stress inputs: V_T with seeded positive noise, V_T
    # with one NaN, and an illiquid return so large that every a' = (1 + ra) a
    # of a > 0 is capped at the top knot.
    gen5 = torch.Generator().manual_seed(9)
    base = k5_inputs["solution"][0]
    V_nan = VT32.clone()
    V_nan.view(-1)[int(torch.randint(0, V_nan.numel(), (1,), generator=gen5))] = float("nan")
    illiquid = model.heterogeneity["illiquid"].grid
    ra_cap = torch.full_like(base[1], float(illiquid[-1] / illiquid[1]))
    k5_inputs.update(
        V_T_noise=(base, VT32 * (1.0 + 0.5 * torch.rand(VT32.shape, generator=gen5).to(dev))),
        V_T_nan=(base, V_nan), ra_capped=([base[0], ra_cap, *base[2:]], VT32))
    k5_bits = kernel5_vs_previous(k5_inputs, m32)
    require(not k5_bits["V_T_nan"]["finite"] and k5_bits["solution"]["finite"],
            f"kernel 5: the NaN input gave finite outputs or the solution did not: {k5_bits}")

    args_iid = k5_args(x_warm, torch.randn(x_ss.shape, generator=gen, dtype=f64).to(dev))
    pol_i, dpol_i = fs2.fused2_policies_jvp(*args_iid, VT32, m32)
    ref_i, dref_i = fs2.fused2_policies_jvp_reference(*(a.double() for a in args_iid),
                                                      VT64, model)
    iid = {"k5_tangents_aggregated": dict_err(
        fs2.fused2_forward_jvp_reference(as64(pol_i), as64(dpol_i), D64, model)[1],
        fs2.fused2_forward_jvp_reference(ref_i, dref_i, D64, model)[1]),
        "k5_tangents_pointwise": dict_err(dpol_i, dref_i)}

    # Timings at the solution: each kernel, the kernel pair's jvp_dir, and
    # the same jvp_dir through both plain versions in f32.
    v = smooth()
    jvp_dir = fs2.make_fused2_jvp_dir(model, ss0, ssT, exog)
    plain_dir = fs2.make_fused2_jvp_dir(model, ss0, ssT, exog, plain=True)
    # One run of the plain f32 map (15-27 s each, host-bound): the script's
    # time limit is better spent on the route's timed runs. The one run of
    # each plain kernel inside it is timed too (their `plain_ms`).
    with timed_calls(fs2, ("fused2_policies_jvp_reference",
                           "fused2_forward_jvp_reference")) as inner_ms:
        dir_plain, dir_plain_ms = cuda_once(lambda: plain_dir(x_warm, v))
    dir_kernel = jvp_dir(x_warm, v)
    dir_err = max_abs(dir_kernel, dir_plain)
    dir_scale = float(dir_plain.abs().max())
    require(dir_err <= 5e-5 * max(dir_scale, 1.0),
            f"kernel-pair jvp_dir off the plain f32 one by {dir_err:.3e} (scale {dir_scale:.3e})")
    # Kernels 5 and 6 each against its previous kernel in turns (previous,
    # new, new, previous), medians of their two turns.
    k5_turns = {"k5": [], "k5_previous": []}
    for name in ("k5_previous", "k5", "k5", "k5_previous"):
        fn = fs2.fused2_policies_jvp if name == "k5" else fs2.fused2_policies_jvp_previous
        k5_turns[name].append(cuda_ms(lambda: fn(*args, VT32, m32), 5))
    k6_turns = {"k6": [], "k6_previous": []}
    for name in ("k6_previous", "k6", "k6", "k6_previous"):
        fn = fs2.fused2_forward_jvp if name == "k6" else fs2.fused2_forward_jvp_previous
        k6_turns[name].append(cuda_ms(lambda: fn(pol, dpol, D32, m32), 5))
    timing = {
        "k5_ms": statistics.median(k5_turns["k5"]),
        "k5_previous_ms": statistics.median(k5_turns["k5_previous"]),
        "k6_ms": statistics.median(k6_turns["k6"]),
        "k6_previous_ms": statistics.median(k6_turns["k6_previous"]),
        "jvp_dir_ms": cuda_ms(lambda: jvp_dir(x_warm, v), 10),
        "k5_plain_f32_ms": inner_ms["fused2_policies_jvp_reference"],
        "k6_plain_f32_ms": inner_ms["fused2_forward_jvp_reference"],
        "jvp_dir_plain_f32_ms": dir_plain_ms,
    }
    F_plain = make_full_residual_fn(model, ss0, ssT, exog)
    pair = f64_pair_checks(model, ss0, ssT, exog, F_plain,
                           {"x_ss": x_ss, "solution": x_warm, "smooth": smooth_x}, ptxas)
    timing["F_f64_ms"] = pair["k5_f64"]["F_plain_ms"]
    lists = global_lists_at_published(model, ss0, ssT, exog, k5_inputs, k6_inputs,
                                      {"x_ss": x_ss, "solution": x_warm, "smooth": smooth_x})
    k6_ptxas = [k for k in ptxas if "two_asset_fwd" in k["kernel"]]
    k6_grids = kernel6_grids()
    k6_large = kernel6_large_grid(m32)
    n_e = model.heterogeneity["income"].n
    emit("two_asset_kernels", checks=checks, iid_direction_at_solution=iid,
         jvp_dir_vs_plain_f32=dir_err, jvp_dir_scale=dir_scale,
         k5_vs_previous_bit_identical=k5_bits, k5_turns_ms=k5_turns,
         k5_cluster=fs2.default_bwd_cluster(n_e),
         k5_ptxas=[k for k in ptxas if "two_asset_bwd" in k["kernel"]],
         k5_grids=kernel5_grids(), k5_other_grids_vs_previous=kernel5_other_grids(m32),
         k6_vs_previous_bit_identical=k6_bits, k6_turns_ms=k6_turns,
         k6_cluster=fs2.default_cluster(model.heterogeneity["income"].n),
         k6_ptxas=k6_ptxas, k6_grids=k6_grids, k6_large_grid_vs_previous=k6_large,
         global_lists_and_untabled_vs_route_kernels=lists, **timing)

    # Three timed runs of the route; counts zeroed right before them.
    fs2.fused2_policies_jvp.launches = fs2.fused2_forward_jvp.launches = 0
    fs2.fused2_policies_jvp_previous.launches = fs2.fused2_forward_jvp_previous.launches = 0
    fs2.fused2_policies_jvp_reference.calls = fs2.fused2_forward_jvp_reference.calls = 0
    fr2.fused2_policies_f64.launches = fr2.fused2_forward_f64.launches = 0
    fr2.fused2_policies_f64_reference.calls = fr2.fused2_forward_f64_reference.calls = 0
    plain_F_calls[0] = 0
    runs, xs, infos = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        x_sol, info = route()
        runs.append(time.perf_counter() - t0)
        xs.append(x_sol)
        infos.append(info)
    launches = {"k5": fs2.fused2_policies_jvp.launches, "k6": fs2.fused2_forward_jvp.launches,
                "k5_f64": fr2.fused2_policies_f64.launches,
                "k6_f64": fr2.fused2_forward_f64.launches}
    plain_calls = {"k5": fs2.fused2_policies_jvp_reference.calls,
                   "k6": fs2.fused2_forward_jvp_reference.calls,
                   "k5_f64": fr2.fused2_policies_f64_reference.calls,
                   "k6_f64": fr2.fused2_forward_f64_reference.calls,
                   "F_f64": plain_F_calls[0]}
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the two-asset route never launched: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran on the two-asset route: {plain_calls}")
    previous = {"k5": fs2.fused2_policies_jvp_previous.launches,
                "k6": fs2.fused2_forward_jvp_previous.launches}
    require(previous["k5"] == 0 and previous["k6"] == 0,
            f"a previous kernel ran on the two-asset route: {previous}")
    require(all(torch.equal(x_warm, xi) for xi in xs),
            "repeated two-asset solves returned different paths")
    require(bool(torch.isfinite(x_warm).all()) and x_warm.shape == x_ss.shape,
            "two-asset solution is not a finite path of the expected shape")
    fnorm_plain = float(torch.linalg.norm(F_plain(x_warm)))
    require(fnorm_plain < EPS, f"two-asset plain f64 ‖F‖ is {fnorm_plain:.3e}")
    vs_jax = max_abs(x_warm, x_jax)
    require(vs_jax <= 1e-6, f"two-asset path {vs_jax:.3e} off the JAX reference")
    info = infos[0]
    emit("two_asset_solve", route=route_name, median_s=statistics.median(runs), runs_s=runs,
         linear_residual_norm=lin_info["residual_norm"], forcing_norm=lin_info["f0_norm"],
         outer_iterations=info["iterations"], matvecs_and_sweeps=info["inner_iterations"],
         prof=info["prof"], residual_norm=info["residual_norm"],
         residual_norm_plain_f64=fnorm_plain, max_abs_vs_jax=vs_jax, launches=launches,
         plain_calls=plain_calls, previous_kernel_launches=previous, bit_identical=True)

    # The other route once: the two-phase one (gated) when the endgame-only
    # route certified; else the endgame-only one from x_lin, cut at 2 outers
    # and reported only.
    t0 = time.perf_counter()
    if route_name == "linstart_endgame_only":
        other_name, (x_o, info_o) = "ss_two_phase", ss_route()
        fnorm_o = float(torch.linalg.norm(F_plain(x_o)))
        require(fnorm_o < EPS, f"two-phase route: plain f64 ‖F‖ is {fnorm_o:.3e}")
    else:
        other_name = "linstart_endgame_only, max_outer=2"
        x_o, info_o = boehl(richardson_max_outer=0, max_outer=2)(x_lin)
        fnorm_o = float(torch.linalg.norm(F_plain(x_o)))
    torch.cuda.synchronize()
    emit("two_asset_other_route", route=other_name, seconds=time.perf_counter() - t0,
         outer_iterations=info_o["iterations"], matvecs_and_sweeps=info_o["inner_iterations"],
         residual_norm_plain_f64=fnorm_o, max_abs_vs_route=max_abs(x_o, x_warm))

    # f64 directions: the tangent pair at the route's three points (at x_ss
    # and the solution on the f32 checks' inputs in f64), then the CLI's
    # default (Newton-Krylov with f64 directions) through it.
    v = (torch.randn(nE, generator=gen, dtype=f64) * decay).reshape(-1).to(dev)
    tangent = tangent_pair_checks(model, ss0, ssT, exog, f64_inputs, smooth_x, v, 10)
    emit("two_asset_f64_directions", **{k: v for k, v in tangent.items()
                                        if not k.endswith("_bytes")},
         ptxas=[k for k in ptxas if re.search(r"(bwd_f64_cluster_kernelILb0ELb1E|"
                                              r"fwd_f64_cluster_kernelILb0ELb[01]ELb1E)",
                                              k["kernel"])])
    default_counts = two_asset_f64_default(model, ss0, ssT, Jbar, exog, x_jax, cache)

    source = "hank_tpu_torch/csrc/household_sweep2.cu"
    n_b, n_a, n_e = model.state_shape()[:3]
    pol_bytes = nbytes(*pol.values(), *dpol.values())
    k5_bound = least_time(nbytes(*args, VT32) + pol_bytes,
                          two_asset_ops(Tm1, n_b, n_a, n_e, 0), "f32")
    k6_bound = least_time(pol_bytes + nbytes(D32, *agg.values(), *dagg.values()),
                          two_asset_ops(Tm1, n_b, n_a, n_e, 1), "f32")
    replaces_f64 = ("hank_tpu/solvers/newton.py:352-376 (the two-asset F in f64 under XLA; "
                    "no TPU kernel)")
    setup = {"model": model, "ss0": ss0, "ssT": ssT, "Jbar": Jbar, "x_ss": x_ss,
             "tangent": tangent}
    return [*({**entry, "launches": launches[key], "replaces": replaces_f64}
              for key, entry in pair.items()),
        *tangent_pair_entries(tangent, model, default_counts, "40x20x5x2, T=300"),
        {"name": "fused2_policies_jvp", "route": "cuda", "source": source,
         "replaces": "hank_tpu/ops/fused_sweep2.py:673", "launches": launches["k5"],
         "max_abs_err": k5_err, "ms": timing["k5_ms"], "plain_ms": timing["k5_plain_f32_ms"],
         **k5_bound, "library_ms": None, "ms_previous": timing["k5_previous_ms"],
         "cluster": fs2.default_bwd_cluster(n_e)},
        {"name": "fused2_forward_jvp", "route": "cuda", "source": source,
         "replaces": "hank_tpu/ops/fused_sweep2.py:984", "launches": launches["k6"],
         "max_abs_err": k6_err, "ms": timing["k6_ms"], "plain_ms": timing["k6_plain_f32_ms"],
         **k6_bound, "library_ms": None, "ms_previous": timing["k6_previous_ms"],
         "cluster": fs2.default_cluster(n_e)},
    ], setup


def f64_pair_checks(model, ss0, ssT, exog, F_plain, points: dict, ptxas) -> dict:
    """Phase 7's checks of the f64 residual pair (`ops/fused_residual2.py`)
    on the two-asset route's inputs: at each point {label: x} the pair's F
    within 1e-11 of the plain f64 F (kernel 2's bound), the backward
    kernel's policies against the plain backward scan pointwise within
    1e-10·max(scale, 1) (the largest gaps reported, over the path and in
    the first backward period, t = T-2), the forward kernel's
    aggregates against `forward_iteration` on the same policies within
    1e-11; two launches of each bit-identical; a NaN in V_T gives NaN. Then
    ms per F of the pair (CUDA events) and of the plain F (one run), each
    kernel alone and its plain version (its run at the solution), ptxas'
    registers and spills. Emits one JSON line; returns the `kernels`
    entries by launch-count key."""
    import torch

    from hank_tpu_torch.models.hank_two_asset import fused2_prices
    from hank_tpu_torch.ops import fused_residual2 as fr2

    f64 = torch.float64
    cs = model.compspec
    Tm1, nE = cs.T - 1, cs.n_endog
    VT, D0 = ssT.value.to(f64).contiguous(), ss0.D.to(f64).contiguous()
    F_pair = fr2.make_fused2_residual_fn_f64(model, ss0, ssT, exog)
    checks, k5_err, k6_err, plain_ms = {}, 0.0, 0.0, {}
    for name, x in points.items():
        F_ref, F_ms = cuda_once(lambda: F_plain(x))
        F_err = max_abs(F_pair(x), F_ref)
        require(F_err <= 1e-11, f"the f64 pair's F at {name} is {F_err:.3e} off the plain F")
        prices = [q.contiguous() for q in fused2_prices(x.reshape(Tm1, nE), exog, model)]
        pol = fr2.fused2_policies_f64(*prices, VT, model)
        ref, k5_ms = cuda_once(lambda: fr2.fused2_policies_f64_reference(*prices, VT, model))
        gaps = {k: (pol[k] - ref[k]).abs() for k in ref}
        e5 = max(float(g.max()) for g in gaps.values())
        scale = max(float(t.abs().max()) for t in ref.values())
        require(e5 <= 1e-10 * max(scale, 1.0),
                f"the f64 backward kernel at {name} is {e5:.3e} off its plain version")
        aggs = fr2.fused2_forward_f64(pol, D0, model)
        raggs, k6_ms = cuda_once(lambda: fr2.fused2_forward_f64_reference(pol, D0, model))
        e6 = max_abs(torch.stack(list(aggs.values())), torch.stack(list(raggs.values())))
        require(e6 <= 1e-11, f"the f64 forward kernel at {name} is {e6:.3e} off its plain version")
        if name == "solution":
            plain_ms = {"F_plain_ms": F_ms, "k5_f64_plain_ms": k5_ms, "k6_f64_plain_ms": k6_ms}
        checks[name] = {"F": F_err, "policies": {k: float(g.max()) for k, g in gaps.items()},
                        "policies_first_backward_period": {k: float(g[-1].max())
                                                           for k, g in gaps.items()},
                        "policy_states_past_1e-13": {k: int((g > 1e-13).sum())
                                                     for k, g in gaps.items()},
                        "aggregates": e6}
        k5_err, k6_err = max(k5_err, e5), max(k6_err, e6)
    # Repeats bit-identical; a NaN in V_T gives NaN (at the last point).
    pol_b = fr2.fused2_policies_f64(*prices, VT, model)
    require(all(torch.equal(pol[k], pol_b[k]) for k in pol)
            and all(torch.equal(aggs[k], v) for k, v in
                    fr2.fused2_forward_f64(pol_b, D0, model).items()),
            "the f64 pair: repeated launches differ")
    V_nan = VT.clone()
    V_nan.view(-1)[V_nan.numel() // 3] = float("nan")
    nan_aggs = fr2.fused2_forward_f64(fr2.fused2_policies_f64(*prices, V_nan, model), D0, model)
    require(any(bool(torch.isnan(v).any()) for v in nan_aggs.values()),
            "the f64 pair: a NaN in V_T gave finite aggregates")
    # Timings at the solution.
    x = points["solution"]
    prices = [q.contiguous() for q in fused2_prices(x.reshape(Tm1, nE), exog, model)]
    pol = fr2.fused2_policies_f64(*prices, VT, model)
    timing = {
        "F_pair_ms": cuda_ms(lambda: F_pair(x), 10),
        "k5_f64_ms": cuda_ms(lambda: fr2.fused2_policies_f64(*prices, VT, model), 10),
        "k6_f64_ms": cuda_ms(lambda: fr2.fused2_forward_f64(pol, D0, model), 10),
        **plain_ms,
    }
    emit("two_asset_f64_pair", checks=checks, bit_identical=True, nan_gives_nan=True,
         ptxas=[k for k in ptxas if "f64_cluster" in k["kernel"]], **timing)
    n_b, n_a, n_e = model.state_shape()[:3]
    pol_bytes = nbytes(*pol.values())
    source = "hank_tpu_torch/csrc/household_sweep2_f64.cu"
    return {
        "k5_f64": {"name": "fused2_policies_f64", "route": "cuda", "source": source,
                   "max_abs_err": k5_err, "ms": timing["k5_f64_ms"],
                   "plain_ms": timing["k5_f64_plain_ms"],
                   **least_time(nbytes(*prices, VT) + pol_bytes,
                                two_asset_ops(Tm1, n_b, n_a, n_e, 0, tangent=False), "f64"),
                   "library_ms": None, "F_ms": timing["F_pair_ms"],
                   "F_plain_ms": timing["F_plain_ms"]},
        "k6_f64": {"name": "fused2_forward_f64", "route": "cuda", "source": source,
                   "max_abs_err": k6_err, "ms": timing["k6_f64_ms"],
                   "plain_ms": timing["k6_f64_plain_ms"],
                   **least_time(pol_bytes + nbytes(D0, *aggs.values()),
                                two_asset_ops(Tm1, n_b, n_a, n_e, 1, tangent=False), "f64"),
                   "library_ms": None},
    }


def guarded_route(Jbar, exog, model, ss0, ssT, x_ss):
    """Phase 7's route (`bench.py:282-310`) on the shock `exog`: the linear
    start and the endgame-only boehl solve when the linear step beats the
    forcing and that solve reaches EPS, else the two-phase boehl solve from
    x_ss; f32 directions. Returns (x, ‖F(x)‖ by the route's own full-precision
    F, the route's name)."""
    import torch

    from hank_tpu_torch.solvers.linear import linear_impulse_response
    from hank_tpu_torch.solvers.newton import make_path_solver

    def boehl(**kw):
        return make_path_solver(Jbar, exog, model, ss0, ssT, method="boehl",
                                direction_dtype=torch.float32, eps=EPS, host_inner=True, **kw)

    x_lin, lin = linear_impulse_response(Jbar, exog, model, ss0, ssT)
    if lin["residual_norm"] < lin["f0_norm"]:
        x, info = boehl(richardson_max_outer=0)(x_lin)
        if info["residual_norm"] <= EPS:
            return x, float(info["residual_norm"]), "linstart_endgame_only"
    x, info = boehl()(x_ss)
    return x, float(info["residual_norm"]), "ss_two_phase_fallback"


def tangent_pair_checks(model, ss0, ssT, exog, reused: dict, x, v, reps: int) -> dict:
    """The f64 tangent pair (`fused_sweep2.fused2_policies_jvp_f64`,
    `fused2_forward_jvp_f64`) on a two-asset route's inputs: at each point
    of `reused` ({label: (the eight f64 price and tangent paths, V_T, D0,
    the plain backward's (policies, dpolicies) on them)}: the f32 kernels'
    checks' inputs in f64, whose plain run the caller made) and at x along
    v (smooth seeded; the plain backward run here), each kernel pointwise
    within 1e-9·max(scale, 1) of its plain version in f64
    (`fused2_*_jvp_reference`, primal and tangents; the largest gaps
    reported), its primal bit for bit the values pair's
    (`fused_residual2.fused2_policies_f64`, `fused2_forward_f64`); two
    launches bit-identical and a zero tangent exactly zero at x. Then, at
    x, ms per launch of each kernel and of the values pair (`reps`
    event-timed calls), each plain version's ms (one run), the map's
    jvp_dir ms and one timed plain f64 direction (`ad_direction` of the
    plain F: what f64 directions ran on the card before the pair), the map
    within 1e-9·max(scale, 1) of it. Returns the measurements."""
    import torch

    from hank_tpu_torch.models.hank_two_asset import fused2_prices
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2
    from hank_tpu_torch.solvers.newton import ad_direction, make_full_residual_fn

    f64 = torch.float64
    cs = model.compspec
    Tm1, nE = cs.T - 1, cs.n_endog
    VT, D0 = ssT.value.to(f64).contiguous(), ss0.D.to(f64).contiguous()

    def gaps(a, b):
        return {k: max_abs(a[k], b[k]) for k in b}

    def within(err: dict, ref: dict, bound: float) -> bool:
        return all(err[k] <= bound * max(float(ref[k].abs().max()), 1.0) for k in ref)

    checks, errs, plain_ms = {}, {"bwd": 0.0, "fwd": 0.0}, {}

    def check(name, paths, VT_, D0_, plain):
        pol, dpol = fs2.fused2_policies_jvp_f64(*paths, VT_, model)
        if plain is None:
            plain, plain_ms["bwd"] = cuda_once(lambda: fs2.fused2_policies_jvp_reference(
                *paths, VT_, model))
        ref, dref = plain
        values = fr2.fused2_policies_f64(*paths[:4], VT_, model)
        aggs, daggs = fs2.fused2_forward_jvp_f64(pol, dpol, D0_, model)
        (ragg, rdagg), plain_ms["fwd"] = cuda_once(lambda: fs2.fused2_forward_jvp_reference(
            pol, dpol, D0_, model))
        vaggs = fr2.fused2_forward_f64(pol, D0_, model)
        e = {"policies": gaps(pol, ref), "dpolicies": gaps(dpol, dref),
             "aggregates": gaps(aggs, ragg), "daggregates": gaps(daggs, rdagg)}
        bits = {"policies": all(same_bits(pol[k], values[k]) for k in fs2.KEYS),
                "aggregates": all(same_bits(aggs[k], vaggs[k]) for k in fs2.KEYS)}
        require(bits["policies"] and bits["aggregates"],
                f"the tangent pair's primal at {name} is not the values pair's bits: {bits}")
        for what, ref_ in (("policies", ref), ("dpolicies", dref), ("aggregates", ragg),
                           ("daggregates", rdagg)):
            require(within(e[what], ref_, 1e-9),
                    f"the tangent pair's {what} at {name} off the plain f64 version: {e[what]}")
        checks[name] = {**e, "dpolicies_scale": max(float(t.abs().max()) for t in dref.values()),
                        "daggregates_scale": max(float(t.abs().max()) for t in rdagg.values()),
                        "dpolicy_states_past_1e-12": {k: int(((dpol[k] - dref[k]).abs()
                                                              > 1e-12).sum()) for k in dref},
                        "primal_bits": bits}
        errs["bwd"] = max(errs["bwd"], *e["policies"].values(), *e["dpolicies"].values())
        errs["fwd"] = max(errs["fwd"], *e["aggregates"].values(), *e["daggregates"].values())
        return pol, dpol, aggs, daggs

    for name, (paths, VT_, D0_, plain) in reused.items():
        check(name, paths, VT_, D0_, plain)
    paths = [q.contiguous() for q in (*fused2_prices(x.reshape(Tm1, nE), exog, model),
                                      *fused2_prices(v.reshape(Tm1, nE), exog, model))]
    pol, dpol, aggs, daggs = check("smooth", paths, VT, D0, None)
    # Repeats and a zero tangent.
    pol2, dpol2 = fs2.fused2_policies_jvp_f64(*paths, VT, model)
    aggs2, daggs2 = fs2.fused2_forward_jvp_f64(pol2, dpol2, D0, model)
    require(all(same_bits(a[k], b[k]) for a, b in ((pol, pol2), (dpol, dpol2), (aggs, aggs2),
                                                   (daggs, daggs2)) for k in fs2.KEYS),
            "the tangent pair: repeated launches differ")
    zero = [torch.zeros_like(q) for q in paths[4:]]
    _, dz = fs2.fused2_policies_jvp_f64(*paths[:4], *zero, VT, model)
    _, dza = fs2.fused2_forward_jvp_f64(pol, dz, D0, model)
    require(all(bool((t == 0).all()) for t in (*dz.values(), *dza.values())),
            "the tangent pair: a zero tangent did not give exactly zero")
    # Timings at x.
    jvp_dir = fs2.make_fused2_jvp_dir_f64(model, ss0, ssT, exog)
    ad = ad_direction(make_full_residual_fn(model, ss0, ssT, exog))
    dir_ad, dir_ad_ms = cuda_once(lambda: ad(x, v))
    dir_err = max_abs(jvp_dir(x, v), dir_ad)
    dir_scale = float(dir_ad.abs().max())
    require(dir_err <= 1e-9 * max(dir_scale, 1.0),
            f"the tangent pair's jvp_dir is {dir_err:.3e} off AD of the plain F")
    timing = {
        "bwd_ms": cuda_ms(lambda: fs2.fused2_policies_jvp_f64(*paths, VT, model), reps),
        "fwd_ms": cuda_ms(lambda: fs2.fused2_forward_jvp_f64(pol, dpol, D0, model), reps),
        "bwd_values_ms": cuda_ms(lambda: fr2.fused2_policies_f64(*paths[:4], VT, model), reps),
        "fwd_values_ms": cuda_ms(lambda: fr2.fused2_forward_f64(pol, D0, model), reps),
        "jvp_dir_ms": cuda_ms(lambda: jvp_dir(x, v), reps),
        "plain_direction_ms": dir_ad_ms, "bwd_plain_ms": plain_ms["bwd"],
        "fwd_plain_ms": plain_ms["fwd"]}
    return {"checks": checks, "jvp_dir_vs_ad": dir_err, "jvp_dir_scale": dir_scale,
            "kernels": {"backward": jvp_dir.backward_kernel, "forward": jvp_dir.forward_kernel},
            "err_bwd": errs["bwd"], "err_fwd": errs["fwd"], "timing": timing,
            "bwd_bytes": nbytes(*paths, VT, *pol.values(), *dpol.values()),
            "fwd_bytes": nbytes(*pol.values(), *dpol.values(), D0, *aggs.values(),
                                *daggs.values())}


def tangent_pair_entries(pair: dict, model, launches: dict, label: str) -> list:
    """The `kernels` entries of the tangent pair's two instantiations that
    `tangent_pair_checks` measured (`pair`), with `launches` {"bwd", "fwd"}
    from a main-path run."""
    Tm1 = model.compspec.T - 1
    n_b, n_a, n_e = model.state_shape()[:3]
    source = "hank_tpu_torch/csrc/household_sweep2_f64.cu"
    t = pair["timing"]
    back = ("<false, true, false> (tangent state in shared memory)"
            if pair["kernels"]["backward"] == 4 else
            "<false, true, true> (dW and the knots' tangents in a global workspace)")
    fwd = ("<false, false, true> (shared lists)" if pair["kernels"]["forward"] == 5
           else "<false, true, true> (global lists)")
    common = {"route": "cuda", "source": source, "library_ms": None, "grid": label}
    return [
        {**common, "name": f"fused2_policies_jvp_f64 {back}",
         "replaces": "hank_tpu/ops/fused_sweep2.py:673 (its f32 dual sweep, here in FP64)",
         "launches": launches["bwd"], "max_abs_err": pair["err_bwd"], "ms": t["bwd_ms"],
         "plain_ms": t["bwd_plain_ms"], "ms_values_kernel": t["bwd_values_ms"],
         **least_time(pair["bwd_bytes"], two_asset_ops(Tm1, n_b, n_a, n_e, 0), "f64")},
        {**common, "name": f"fused2_forward_jvp_f64 {fwd}",
         "replaces": "hank_tpu/ops/fused_sweep2.py:984 (its f32 dual push, here in FP64)",
         "launches": launches["fwd"], "max_abs_err": pair["err_fwd"], "ms": t["fwd_ms"],
         "plain_ms": t["fwd_plain_ms"], "ms_values_kernel": t["fwd_values_ms"],
         **least_time(pair["fwd_bytes"], two_asset_ops(Tm1, n_b, n_a, n_e, 1), "f64")},
    ]


def tangent_pair_counts() -> dict:
    """The tangent pair's counters, by key: launches of each instantiation,
    the plain versions' calls, AD directions, and the f32 kernels 5-6's
    launches."""
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2
    from hank_tpu_torch.solvers.newton import ad_direction

    return {"bwd": fs2.fused2_policies_jvp_f64.launches,
            "bwd_global": fs2.fused2_policies_jvp_f64.launches_global,
            "fwd": fs2.fused2_forward_jvp_f64.launches,
            "fwd_global": fs2.fused2_forward_jvp_f64.launches_global,
            "values_bwd": fr2.fused2_policies_f64.launches,
            "values_fwd": fr2.fused2_forward_f64.launches + fr2.fused2_forward_f64.launches_global,
            "plain": (fs2.fused2_policies_jvp_reference.calls
                      + fs2.fused2_forward_jvp_reference.calls
                      + fr2.fused2_policies_f64_reference.calls
                      + fr2.fused2_forward_f64_reference.calls),
            "ad_directions": ad_direction.calls,
            "k5_k6_f32": (fs2.fused2_policies_jvp.launches + fs2.fused2_forward_jvp.launches
                          + fs2.fused2_forward_jvp.launches_global)}


def zero_tangent_pair_counts() -> None:
    """`tangent_pair_counts`' counters (every two-asset wrapper's) to 0."""
    from hank_tpu_torch.solvers.newton import ad_direction

    zero_two_asset_counts()
    ad_direction.calls = 0


def require_tangent_route(counts: dict, plain_F: int, launched: set, path: str) -> None:
    """On `path` the tangent pair's instantiations `launched` (keys of
    `tangent_pair_counts`) and the values pair ran, and nothing else: no
    other instantiation, plain version, AD direction, plain f64 F or f32
    kernel 5-6."""
    ran = {k for k, n in counts.items() if n}
    require(ran == launched | {"values_bwd", "values_fwd"} and plain_F == 0,
            f"{path}: the counters that moved are {sorted(ran)} (plain F {plain_F}), not "
            f"{sorted(launched)} and the values pair: {counts}")


def two_asset_f64_default(model, ss0, ssT, Jbar, exog, x_jax, cache: str) -> dict:
    """Phase 7's CLI default: `hank_tpu_torch.run.main(["--model",
    "hank_two_asset"])` in-process (Newton-Krylov, f64 directions, its
    steady state and J̄ read from phase 7's cache, `cache`), its path read
    back from the CSV it writes; counters zeroed right before: the tangent
    pair's shared-memory instantiations and the values pair launched, and
    nothing else (no AD direction, plain version, plain f64 F or f32 kernel
    5-6). ‖F‖ < 1e-8 by the plain f64 pipeline and within 1e-6 of the JAX
    CPU root. Then the same default solve (`make_path_solver`'s defaults
    with Newton-Krylov) timed, 3 runs. Emits one JSON line; returns the
    CLI run's counts."""
    import contextlib
    import io

    import numpy as np
    import torch

    from hank_tpu_torch import run
    from hank_tpu_torch.solvers import newton as newton_mod

    plain_F = [0]
    plain = newton_mod.make_full_residual_fn

    def counted_residual(*a):
        F = plain(*a)

        def counted(x):
            plain_F[0] += 1
            return F(x)

        return counted

    previous = os.environ.get("HANK_TPU_TORCH_CACHE")
    out = os.path.join(cache, "hank_two_asset_default.csv")
    os.environ["HANK_TPU_TORCH_CACHE"] = cache
    newton_mod.make_full_residual_fn = counted_residual
    zero_tangent_pair_counts()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = run.main(["--model", "hank_two_asset", "--out", out])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts, plain_calls = tangent_pair_counts(), plain_F[0]
    finally:
        newton_mod.make_full_residual_fn = plain
        if previous is None:
            os.environ.pop("HANK_TPU_TORCH_CACHE", None)
        else:
            os.environ["HANK_TPU_TORCH_CACHE"] = previous
    require_tangent_route(counts, plain_calls, {"bwd", "fwd"}, "the two-asset CLI default")
    path = np.loadtxt(out, delimiter=",", skiprows=1)[:, 1:]
    x = torch.as_tensor(path.reshape(-1), dtype=torch.float64, device=x_jax.device)
    fnorm = float(torch.linalg.norm(plain(model, ss0, ssT, exog)(x)))
    vs_jax = max_abs(x, x_jax)
    require(summary["residual_norm"] < 1e-8 and fnorm < 1e-8 and vs_jax <= 1e-6,
            f"the two-asset CLI default: ‖F‖ {summary['residual_norm']:.3e}, plain f64 "
            f"{fnorm:.3e}, {vs_jax:.3e} off the JAX CPU root")
    endog = model.vars_of_type("endogenous")
    x_ss = torch.stack([torch.as_tensor(ssT.vars[k]) for k in endog]).repeat(model.compspec.T - 1)
    solve = newton_mod.make_path_solver(Jbar, exog, model, ss0, ssT, method="newton_krylov",
                                        eps=1e-8)
    runs, xs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        xs.append(solve(x_ss)[0])
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    require(all(torch.equal(xs[0], xi) for xi in xs) and max_abs(xs[0], x) <= 1e-12,
            "the timed default solves differ from each other or from the CLI's")
    emit("two_asset_f64_default", cli_s=cli_s, cli_summary=summary,
         outer_iterations=summary["iterations"], directions=counts["bwd"],
         F_calls=counts["values_bwd"], residual_norm_plain_f64=fnorm, max_abs_vs_jax=vs_jax,
         launches=counts, solve_median_s=statistics.median(runs), solve_runs_s=runs)
    return counts


def two_asset_batch_wrappers() -> dict:
    """The four batched two-asset wrappers {key: (wrapper, its plain
    version)}: kernels 5 and 6 and the f64 pair over B paths."""
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    return {"k5_batch": (fs2.fused2_policies_jvp_batch, fs2.fused2_policies_jvp_batch_reference),
            "k6_batch": (fs2.fused2_forward_jvp_batch, fs2.fused2_forward_jvp_batch_reference),
            "k5_f64_batch": (fr2.fused2_policies_f64_batch,
                             fr2.fused2_policies_f64_batch_reference),
            "k6_f64_batch": (fr2.fused2_forward_f64_batch,
                             fr2.fused2_forward_f64_batch_reference)}


def two_asset_single_wrappers() -> dict:
    """The single-path two-asset wrappers {key: (wrapper, its plain
    version)}, which no ensemble may launch or call."""
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    return {"k5": (fs2.fused2_policies_jvp, fs2.fused2_policies_jvp_reference),
            "k6": (fs2.fused2_forward_jvp, fs2.fused2_forward_jvp_reference),
            "k5_f64": (fr2.fused2_policies_f64, fr2.fused2_policies_f64_reference),
            "k6_f64": (fr2.fused2_forward_f64, fr2.fused2_forward_f64_reference),
            "k5_jvp_f64": (fs2.fused2_policies_jvp_f64, fs2.fused2_policies_jvp_reference),
            "k6_jvp_f64": (fs2.fused2_forward_jvp_f64, fs2.fused2_forward_jvp_reference),
            "k5_previous": (fs2.fused2_policies_jvp_previous, None),
            "k6_previous": (fs2.fused2_forward_jvp_previous, None)}


def zero_two_asset_counts() -> None:
    for group in (two_asset_batch_wrappers(), two_asset_single_wrappers()):
        for fn, plain in group.values():
            fn.launches = 0
            if hasattr(fn, "launches_global"):
                fn.launches_global = 0
            if plain is not None:
                plain.calls = 0


def read_two_asset_counts() -> tuple:
    """(batched launches, batched plain calls, single-path launches and
    plain calls) since `zero_two_asset_counts`."""
    batch = two_asset_batch_wrappers()
    single = {**{k: fn.launches for k, (fn, _) in two_asset_single_wrappers().items()},
              **{f"{k}_plain": plain.calls for k, (_, plain) in
                 two_asset_single_wrappers().items() if plain is not None}}
    return ({k: fn.launches for k, (fn, _) in batch.items()},
            {k: plain.calls for k, (_, plain) in batch.items()}, single)


F_B_REPLACES = ("hank_tpu/parallel/ensemble.py:76-95 (the ensemble's F, vmapped under XLA in "
                "f64; no TPU kernel)")


def tangent_pair_batch_rows(model, ss0, ssT, paths, widths, reps: int = 5) -> dict:
    """The batched f64 tangent pair (`fused2_policies_jvp_f64_batch`,
    `fused2_forward_jvp_f64_batch`, the instantiations their wrappers
    decide) on `paths` (the eight (R, T-1) f64 price and tangent paths of R
    source rows), at each width Bw of `widths` on rows i % R: every row of
    each bit for bit a single launch of `fused2_policies_jvp_f64` /
    `fused2_forward_jvp_f64` on its source row; then ms per launch of each
    at each width in turns with the values pair's batched kernel
    (`fused_residual2.fused2_*_f64_batch`) on the same rows (values,
    tangent, tangent, values), the cluster each takes and the bytes each
    launch reads and writes. Returns {"widths": {Bw: ...}, ...}."""
    import torch

    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    f64 = torch.float64
    VT, D0 = ssT.value.to(f64).contiguous(), ss0.D.to(f64).contiguous()
    grid = tuple(model.state_shape()[:3])
    R = paths[0].shape[0]
    single = {}
    for r in range(R):
        sp, sd = fs2.fused2_policies_jvp_f64(*(q[r].contiguous() for q in paths), VT, model)
        single[r] = (sp, sd, *fs2.fused2_forward_jvp_f64(sp, sd, D0, model))
    backward = fs2.jvp_f64_backward(grid)
    forward = fs2.forward_kernel(fs2.F64_PUSH_JVP, *grid)
    report = {}
    for Bw in widths:
        idx = [i % R for i in range(Bw)]
        rows = [q[idx].contiguous() for q in paths]
        pol, dpol = fs2.fused2_policies_jvp_f64_batch(*rows, VT, model)
        aggs, daggs = fs2.fused2_forward_jvp_f64_batch(pol, dpol, D0, model)
        for i, r in enumerate(idx):
            for got, ref in zip((pol, dpol, aggs, daggs), single[r]):
                require(all(same_bits(got[k][i], ref[k]) for k in fs2.KEYS),
                        f"the batched tangent pair at B={Bw}: row {i} differs from the "
                        f"single-path launch")
        pol64 = fr2.fused2_policies_f64_batch(*rows[:4], VT, model)
        bwd = in_turns({"values": lambda: fr2.fused2_policies_f64_batch(*rows[:4], VT, model),
                        "tangent": lambda: fs2.fused2_policies_jvp_f64_batch(*rows, VT, model)},
                       reps)
        fwd = in_turns({"values": lambda: fr2.fused2_forward_f64_batch(pol64, D0, model),
                        "tangent": lambda: fs2.fused2_forward_jvp_f64_batch(pol, dpol, D0,
                                                                            model)}, reps)
        report[Bw] = {"rows_bit_identical": True,
                      "bwd_ms": bwd["tangent"], "bwd_values_ms": bwd["values"],
                      "fwd_ms": fwd["tangent"], "fwd_values_ms": fwd["values"],
                      "bwd_cluster": fs2.batch_cluster_of(fr2.LIBRARY, backward, Bw, grid),
                      "fwd_cluster": fs2.batch_cluster_of(fr2.LIBRARY, forward, Bw, grid),
                      "finite": all(bool(torch.isfinite(t[k]).all())
                                    for t in (aggs, daggs) for k in fs2.KEYS),
                      "bwd_bytes": nbytes(*rows, VT, *pol.values(), *dpol.values()),
                      "fwd_bytes": nbytes(*pol.values(), *dpol.values(), D0, *aggs.values(),
                                          *daggs.values())}
        torch.cuda.empty_cache()
    def held(which, default):
        """The card's max active clusters of each size whose blocks fit."""
        return {C: cuda_build.max_clusters(fr2.LIBRARY, which, *grid, C)
                for C in range(1, default + 1)
                if cuda_build.sweep2_f64_smem_bytes(which, *grid, C) <= cuda_build.MAX_SMEM_BYTES}

    return {"widths": report, "backward": backward, "forward": forward,
            "max_active_clusters": {"bwd": held(backward, fs2.default_bwd_cluster(grid[2])),
                                    "fwd": held(forward, fs2.default_cluster(grid[2]))}}


def tangent_pair_batch_entries(rows: dict, pair: dict, model, launches: dict, B: int,
                               grid_label: str, **extra) -> list:
    """The `kernels` entries of the batched tangent pair's two
    instantiations that `tangent_pair_batch_rows` measured (`rows`) at the
    ensemble's width B. Every row is bit for bit the single-path kernel, so
    the error against the plain version and the plain version's ms (its
    B = 1 loop is the single-path plain version) are the single-path
    checks' of this run (`pair`, `tangent_pair_checks`)."""
    Tm1 = model.compspec.T - 1
    n_b, n_a, n_e = model.state_shape()[:3]
    at = rows["widths"][B]
    back = ("<true, true, false> (tangent state in shared memory)" if rows["backward"] == 4
            else "<true, true, true> (dW and the knots' tangents in a global workspace)")
    fwd = ("<true, false, true> (shared lists)" if rows["forward"] == 5
           else "<true, true, true> (global lists)")
    common = {"route": "cuda", "source": "hank_tpu_torch/csrc/household_sweep2_f64.cu",
              "library_ms": None, "grid": grid_label, "B": B, "plain_ms_at": "B=1",
              "max_abs_err_of": "the single-path kernel (every row bit for bit), against its "
                                "plain version in this run", **extra}
    return [
        {**common, "name": f"fused2_policies_jvp_f64_batch {back}",
         "replaces": "hank_tpu/ops/fused_sweep2.py:673 over B paths, in FP64 (the reference "
                     "vmaps jax.jvp of its f64 F: hank_tpu/parallel/ensemble.py:247-279)",
         "launches": launches["bwd"], "max_abs_err": pair["err_bwd"], "ms": at["bwd_ms"],
         "plain_ms": pair["timing"]["bwd_plain_ms"], "ms_values_kernel": at["bwd_values_ms"],
         "cluster": at["bwd_cluster"],
         **{f"ms_B{Bw}": r["bwd_ms"] for Bw, r in rows["widths"].items()},
         **{f"ms_values_B{Bw}": r["bwd_values_ms"] for Bw, r in rows["widths"].items()},
         **least_time(at["bwd_bytes"], B * two_asset_ops(Tm1, n_b, n_a, n_e, 0), "f64")},
        {**common, "name": f"fused2_forward_jvp_f64_batch {fwd}",
         "replaces": "hank_tpu/ops/fused_sweep2.py:984 over B paths, in FP64 (as above)",
         "launches": launches["fwd"], "max_abs_err": pair["err_fwd"], "ms": at["fwd_ms"],
         "plain_ms": pair["timing"]["fwd_plain_ms"], "ms_values_kernel": at["fwd_values_ms"],
         "cluster": at["fwd_cluster"],
         **{f"ms_B{Bw}": r["fwd_ms"] for Bw, r in rows["widths"].items()},
         **{f"ms_values_B{Bw}": r["fwd_values_ms"] for Bw, r in rows["widths"].items()},
         **least_time(at["fwd_bytes"], B * two_asset_ops(Tm1, n_b, n_a, n_e, 1), "f64")},
    ]


def two_asset_f64_ensemble(two: dict, exog_b, x_f32, f32_norms, paths, widths) -> list:
    """Phase 11's f64 directions: the batched tangent pair at `widths`
    (`tangent_pair_batch_rows` on `paths`, the warm-up's rows along smooth
    directions), then the f64-direction Newton-Krylov ensemble solve of
    the same shocks (a warm-up and one timed run, `f64_ensemble_solve`):
    the batched tangent pair and the batched f64 pair launched, no plain
    version, AD, single-path or f32 kernel; every row the f32 ensemble
    solves to EPS (`f32_norms`) at EPS and within 1e-7 of its row
    (`x_f32`); the stalled rows reported beside the f32 solve's. Returns
    the pair's `kernels` entries."""
    import torch

    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2
    from hank_tpu_torch.parallel.ensemble import solve_ensemble_host
    from hank_tpu_torch.solvers.newton import ad_direction, make_full_residual_fn

    model, ss0, ssT, Jbar, x_ss = (two[k] for k in ("model", "ss0", "ssT", "Jbar", "x_ss"))
    B = x_f32.shape[0]
    rows = tangent_pair_batch_rows(model, ss0, ssT, paths, widths)
    emit("two_asset_ensemble_f64_kernels", B=B,
         **{k: v for k, v in rows.items() if not k.endswith("_bytes")})

    def solve():
        x, info = solve_ensemble_host(x_ss, Jbar, exog_b, model, ss0, ssT, eps=EPS,
                                      method="newton_krylov", direction_dtype=None)
        torch.cuda.synchronize()
        return x, info

    quiet = {f"{k}{'_plain' if i else ''}": fn
             for group in (two_asset_single_wrappers(),
                           {k: v for k, v in two_asset_batch_wrappers().items()
                            if k in ("k5_batch", "k6_batch")})
             for k, pair_ in group.items() for i, fn in enumerate(pair_) if fn is not None}
    quiet.update(bwd_plain=fs2.fused2_policies_jvp_f64_batch_reference,
                 fwd_plain=fs2.fused2_forward_jvp_f64_batch_reference,
                 k5_f64_batch_plain=fr2.fused2_policies_f64_batch_reference,
                 k6_f64_batch_plain=fr2.fused2_forward_f64_batch_reference,
                 ad_directions=ad_direction)
    got = f64_ensemble_solve("two-asset f64 ensemble", solve,
                             {"bwd": fs2.fused2_policies_jvp_f64_batch,
                              "fwd": fs2.fused2_forward_jvp_f64_batch,
                              "k5_f64_batch": fr2.fused2_policies_f64_batch,
                              "k6_f64_batch": fr2.fused2_forward_f64_batch}, quiet, 1)
    x, info = got["x"], got["info"]
    fn = info["residual_norm"]
    require(bool(torch.isfinite(x).all()) and x.shape == x_f32.shape,
            "two-asset f64 ensemble: not finite paths of the expected shape")
    solved_f32 = [r for r in range(B) if float(f32_norms[r]) <= EPS]
    stalled = [r for r in range(B) if float(fn[r]) > EPS]
    require(not set(stalled) & set(solved_f32),
            f"two-asset f64 ensemble: rows {sorted(set(stalled) & set(solved_f32))} that f32 "
            f"directions solve stay above EPS")
    require(len(stalled) == info["stalled_paths"],
            f"two-asset f64 ensemble: rows {stalled} above EPS but {info['stalled_paths']} "
            f"stalled paths")
    vs_f32 = max(max_abs(x[r], x_f32[r]) for r in solved_f32)
    require(vs_f32 <= 1e-7, f"two-asset f64 ensemble: a row is {vs_f32:.3e} off the f32 row")
    plain_fn = {}
    for r in sorted({solved_f32[0], solved_f32[-1]}):
        F_plain = make_full_residual_fn(model, ss0, ssT, {"G": exog_b["G"][r]})
        plain_fn[r] = float(torch.linalg.norm(F_plain(x[r])))
        require(plain_fn[r] <= EPS, f"two-asset f64 ensemble: plain f64 ‖F‖ of row {r} is "
                                    f"{plain_fn[r]:.3e}")
    per_solve = {k: sum(v.values()) for k, v in got["launches"].items()}
    emit("two_asset_ensemble_f64_nk", B=B, seconds=got["runs"][0],
         per_path_s=got["runs"][0] / B, outer_iterations=info["iterations"],
         directions=info["inner_iterations"], F_b_per_solve=per_solve["k5_f64_batch"],
         residual_norm_max=float(fn.max()), rows_within_eps=B - len(stalled),
         stalled_rows=stalled, stalled_rows_f32=[r for r in range(B) if r not in solved_f32],
         max_abs_vs_f32_rows=vs_f32, residual_norm_plain_f64=plain_fn,
         launches_per_solve=got["launches"], others=got["others"],
         plain_F_calls=got["plain_F_calls"], host_ls_s=info["host_ls_seconds"],
         bit_identical=True)
    return tangent_pair_batch_entries(rows, two["tangent"], model,
                                      {"bwd": per_solve["bwd"], "fwd": per_solve["fwd"]}, B,
                                      "40x20x5x2, T=300")


def two_asset_ensemble_phase(two: dict, ptxas, B: int = 16, widths=(1, 16, 64)) -> list:
    """Phase 11: a B-path two-asset ensemble through `solve_ensemble_host`
    and the path-batched kernels 5-6 and f64 pair, on phase 7's model,
    steady states and J̄ (see the module docstring). Emits its JSON lines
    and returns the `kernels` entries of the four batched kernels."""
    import torch

    import hank_tpu_torch.parallel.ensemble as ens
    from hank_tpu_torch.models.hank_two_asset import fused2_prices
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2
    from hank_tpu_torch.solvers.newton import make_full_residual_fn

    f32, f64 = torch.float32, torch.float64
    model, ss0, ssT, Jbar, x_ss = (two[k] for k in ("model", "ss0", "ssT", "Jbar", "x_ss"))
    dev = x_ss.device
    cs = model.compspec
    Tm1, nE = cs.T - 1, cs.n_endog
    n_b, n_a, n_e = model.state_shape()[:3]
    grid = (n_b, n_a, n_e)
    # The fiscal shocks G_b,t = s_b·ρ_bᵗ: sizes up to fiscalShock's default
    # 0.01 (larger ones stall any Newton method at the kinks,
    # hank_tpu/models/hank_two_asset.py:115-123), ρ as
    # scripts/r5_ensemble_two_asset.py's.
    b = torch.arange(B, dtype=f64)
    size, rho = 0.005 + 0.005 * b / (B - 1), 0.5 + 0.4 * b / B
    t = torch.arange(1, Tm1 + 1, dtype=f64)
    exog_b = {"G": (size[:, None] * rho[:, None] ** t[None, :]).to(dev)}

    def solve(method, **kw):
        x, info = ens.solve_ensemble_host(x_ss, Jbar, exog_b, model, ss0, ssT, eps=EPS,
                                          method=method, direction_dtype=f32, **kw)
        torch.cuda.synchronize()
        return x, info

    def prices(x_b, dtype):
        rows = [fused2_prices(x.reshape(Tm1, nE), None, model) for x in x_b]
        return [torch.stack(q).to(dtype).contiguous() for q in zip(*rows)]

    def rows_of(args, rows):
        return [a[rows].contiguous() for a in args]

    x_warm, info_warm = solve("newton_krylov")

    # The batched kernels at the solver's own points, x_ss on every row and
    # the warm-up's rows, along smooth seeded directions: every row bit for
    # bit a single-path launch (NaNs included), a zero tangent exactly zero;
    # the f64 pair's F_b row by row within 1e-13 of the single-path pair's F.
    m32 = fs2.cast_model(model, f32)
    VT32, D32 = ssT.value.to(f32).contiguous(), ss0.D.to(f32).contiguous()
    VT64, D64 = ssT.value.to(f64).contiguous(), ss0.D.to(f64).contiguous()
    gen = torch.Generator().manual_seed(17)
    decay = (0.9 ** torch.arange(Tm1, dtype=f64))[None, :, None]
    F_b = fr2.make_fused2_residual_fn_f64_batch(model, ss0, ssT)

    def k56(args):
        pol, dpol = fs2.fused2_policies_jvp_batch(*args, VT32, m32)
        return (pol, dpol, *fs2.fused2_forward_jvp_batch(pol, dpol, D32, m32))

    def pair(p64):
        pol = fr2.fused2_policies_f64_batch(*p64, VT64, model)
        return pol, fr2.fused2_forward_f64_batch(pol, D64, model)

    def single_rows(args, p64, rows):
        """{source row: its single-path kernels 5-6 and pair outputs}."""
        out = {}
        for r in rows:
            sp, sd = fs2.fused2_policies_jvp(*(a[r].contiguous() for a in args), VT32, m32)
            sp64 = fr2.fused2_policies_f64(*(q[r].contiguous() for q in p64), VT64, model)
            out[r] = (sp, sd, *fs2.fused2_forward_jvp(sp, sd, D32, m32), sp64,
                      fr2.fused2_forward_f64(sp64, D64, model))
        return out

    def rows_bit_for_bit(args, p64, label, source=None):
        """Every row of the four batched kernels on (args, p64) against the
        single-path launch on its source row (`source[i]`, default i)."""
        got = (*k56(args), *pair(p64))
        width = args[0].shape[0]
        source = list(range(width)) if source is None else source
        single = single_rows(args, p64, sorted(set(source)))
        for i in range(width):
            ref = single[source[i]]
            for o, s_ in zip(got, ref):
                require(all(same_bits(o[k][i], s_[k]) for k in s_),
                        f"a batched two-asset kernel at {label}: row {i} differs from the "
                        f"single-path launch")
        return got

    checks = {}
    for label, x_b in (("x_ss", x_ss.expand(B, -1)), ("solution", x_warm)):
        v_b = (torch.randn((B, 1, nE), generator=gen, dtype=f64) * decay).reshape(B, -1).to(dev)
        args = [*prices(x_b, f32), *prices(v_b, f32)]
        p64 = prices(x_b, f64)
        got = rows_bit_for_bit(args, p64, label)
        zero = [torch.zeros_like(a) for a in args[4:]]
        _, dpol0, _, dagg0 = k56([*args[:4], *zero])
        require(all(bool((d == 0).all()) for d in (*dpol0.values(), *dagg0.values())),
                f"batched kernels 5-6 at {label}: a zero tangent did not give exactly zero")
        Fb = F_b(x_b, exog_b)
        F_single = torch.stack([fr2.make_fused2_residual_fn_f64(
            model, ss0, ssT, {"G": exog_b["G"][i]})(x_b[i]) for i in range(B)])
        gap = max_abs(Fb, F_single)
        require(gap <= 1e-13, f"F_b at {label} is {gap:.3e} off the single-path pair's F")
        checks[label] = {"rows_bit_identical": True, "F_b_vs_single_pair_max_abs": gap,
                         "F_b_bits_equal_single_pair": same_bits(Fb, F_single),
                         "finite": all(bool(torch.isfinite(o[k]).all())
                                       for o in got for k in o)}
    # Rows 0 and B-1 of F_b at the warm-up's rows against the plain f64 F.
    plain = {r: make_full_residual_fn(model, ss0, ssT, {"G": exog_b["G"][r]})(x_warm[r])
             for r in (0, B - 1)}
    F_plain_gap = max(max_abs(Fb[r], plain[r]) for r in plain)
    require(F_plain_gap <= 1e-11, f"F_b is {F_plain_gap:.3e} off the plain f64 F")
    checks["F_b_rows_0_and_last_vs_plain_f64_F"] = F_plain_gap
    sol_args, sol_p64 = args, p64

    # The batched plain versions at B = 1 (row 0 of the warm-up's rows):
    # kernel 5's policies and kernel 6 on kernel 5's outputs within
    # 5e-5·max(scale, 1), kernel 6's tangents aggregated from kernel 5's
    # reported; the f64 pair within 1e-10·max(scale, 1) and 1e-11.
    one = rows_of(sol_args, [0])
    one64 = rows_of(sol_p64, [0])
    (pol_r, dpol_r), k5_plain_ms = cuda_once(
        lambda: fs2.fused2_policies_jvp_batch_reference(*one, VT32, m32))
    pol_k, dpol_k, aggs_k, daggs_k = k56(one)
    (agg_r, dagg_r), k6_plain_ms = cuda_once(
        lambda: fs2.fused2_forward_jvp_batch_reference(pol_k, dpol_k, D32, m32))
    agg_rr, dagg_rr = fs2.fused2_forward_jvp_batch_reference(pol_r, dpol_r, D32, m32)

    def err_scale(a, r):
        return (max(max_abs(a[k], r[k]) for k in r),
                max(1.0, max(float(r[k].abs().max()) for k in r)))

    k5_err, k5_scale = err_scale(pol_k, pol_r)
    k6_err, k6_scale = err_scale({**aggs_k, **{f"d{k}": v for k, v in daggs_k.items()}},
                                 {**agg_r, **{f"d{k}": v for k, v in dagg_r.items()}})
    require(k5_err <= 5e-5 * k5_scale and k6_err <= 5e-5 * k6_scale,
            f"batched kernels 5-6 off their plain versions: {k5_err:.3e}, {k6_err:.3e}")
    k5_tangent_aggregated = err_scale(daggs_k, dagg_rr)[0]
    pol64_r, k5_f64_plain_ms = cuda_once(
        lambda: fr2.fused2_policies_f64_batch_reference(*one64, VT64, model))
    pol64_k, aggs64_k = pair(one64)
    aggs64_r, k6_f64_plain_ms = cuda_once(
        lambda: fr2.fused2_forward_f64_batch_reference(pol64_k, D64, model))
    k5_f64_err, k5_f64_scale = err_scale(pol64_k, pol64_r)
    k6_f64_err = err_scale(aggs64_k, aggs64_r)[0]
    require(k5_f64_err <= 1e-10 * k5_f64_scale and k6_f64_err <= 1e-11,
            f"the batched f64 pair off its plain versions: {k5_f64_err:.3e}, {k6_f64_err:.3e}")

    # The cluster each batched kernel takes at each width, the card's max
    # active clusters per size, and the rows at any width whose cluster is
    # not the default bit for bit their single-path launches.
    kinds = {"k5_batch": ("household_sweep2", 3, fs2.default_bwd_cluster(n_e)),
             "k6_batch": ("household_sweep2", 2, fs2.default_cluster(n_e)),
             "k5_f64_batch": (fr2.LIBRARY, 0, fs2.default_bwd_cluster(n_e)),
             "k6_f64_batch": (fr2.LIBRARY, 1, fs2.default_cluster(n_e))}
    max_clusters = {k: {C: cuda_build.max_clusters(lib, which, *grid, C)
                        for C in range(1, default + 1)}
                    for k, (lib, which, default) in kinds.items()}
    picks = {Bw: {k: fs2.batch_cluster_of(lib, which, Bw, grid)
                  for k, (lib, which, _) in kinds.items()} for Bw in widths}
    wide = {}
    for Bw in widths:
        idx = [i % B for i in range(Bw)]
        wide[Bw] = (rows_of(sol_args, idx), rows_of(sol_p64, idx))
        if any(picks[Bw][k] != kinds[k][2] for k in kinds):
            rows_bit_for_bit(*wide[Bw], f"width {Bw}", source=idx)
            checks[f"rows_bit_identical_at_width_{Bw}"] = True

    # ms per launch of each batched kernel at each width, in turns with the
    # single-path kernel on row 0 (single, batched, batched, single).
    def launchers(args, p64):
        pol, dpol = fs2.fused2_policies_jvp_batch(*args, VT32, m32)
        pol64 = fr2.fused2_policies_f64_batch(*p64, VT64, model)
        row = [a[0].contiguous() for a in args]
        sp, sd = fs2.fused2_policies_jvp(*row, VT32, m32)
        row64 = [q[0].contiguous() for q in p64]
        sp64 = fr2.fused2_policies_f64(*row64, VT64, model)
        return {
            "k5_batch": (lambda: fs2.fused2_policies_jvp(*row, VT32, m32),
                         lambda: fs2.fused2_policies_jvp_batch(*args, VT32, m32)),
            "k6_batch": (lambda: fs2.fused2_forward_jvp(sp, sd, D32, m32),
                         lambda: fs2.fused2_forward_jvp_batch(pol, dpol, D32, m32)),
            "k5_f64_batch": (lambda: fr2.fused2_policies_f64(*row64, VT64, model),
                             lambda: fr2.fused2_policies_f64_batch(*p64, VT64, model)),
            "k6_f64_batch": (lambda: fr2.fused2_forward_f64(sp64, D64, model),
                             lambda: fr2.fused2_forward_f64_batch(pol64, D64, model))}

    width_ms = {k: {} for k in kinds}
    for Bw in widths:
        for k, (single, batched) in launchers(*wide[Bw]).items():
            turns = in_turns({"single": single, "batched": batched}, 5)
            width_ms[k][Bw] = {"ms": turns["batched"], "ms_per_path": turns["batched"] / Bw,
                               "single_ms": turns["single"], "cluster": picks[Bw][k]}
        torch.cuda.empty_cache()
    emit("two_asset_ensemble_kernels", B=B, checks=checks,
         k5_policies_vs_plain=k5_err, k6_vs_plain=k6_err,
         k5_tangents_aggregated_vs_plain=k5_tangent_aggregated,
         k5_f64_vs_plain=k5_f64_err, k6_f64_vs_plain=k6_f64_err,
         plain_ms_B1={"k5_batch": k5_plain_ms, "k6_batch": k6_plain_ms,
                      "k5_f64_batch": k5_f64_plain_ms, "k6_f64_batch": k6_f64_plain_ms},
         max_active_clusters=max_clusters, clusters_by_width=picks, width_ms=width_ms,
         ptxas_batched=[k for k in ptxas if "cluster_kernelILb1E" in k["kernel"]])

    # Three timed lockstep Newton-Krylov solves; counts zeroed right before:
    # every batched kernel launched, no plain version and no single-path
    # two-asset kernel, no plain f64 F (counted through the name the
    # ensemble takes it by).
    with plain_F_counter() as plain_F_calls:
        zero_two_asset_counts()
        runs, xs, infos = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            x_sol, info = solve("newton_krylov")
            runs.append(time.perf_counter() - t0)
            xs.append(x_sol)
            infos.append(info)
        launches, plain_calls, single = read_two_asset_counts()
    require(all(n > 0 for n in launches.values()),
            f"a batched two-asset kernel never launched: {launches}")
    require(not any(plain_calls.values()) and plain_F_calls[0] == 0 and not any(single.values()),
            f"a plain version, the plain F or a single-path kernel ran on the two-asset "
            f"ensemble path: {plain_calls}, {plain_F_calls[0]}, {single}")
    require(all(torch.equal(x_warm, xi) for xi in xs),
            "repeated two-asset ensemble solves returned different paths")
    info = infos[0]
    fn = info["residual_norm"]
    require(xs[0].shape == (B, x_ss.numel()) and bool(torch.isfinite(xs[0]).all()),
            "two-asset ensemble solution is not finite paths of the expected shape")
    # Every row reaches EPS or is a stalled (frozen) path. Some of these
    # shocks stall at kinks of F, in the single-path solvers too (PERF.md
    # §6): each stalled row must stall in phase 7's single-path
    # route on its own shock as well, or the batched route is at fault.
    stalled_rows = [r for r in range(B) if float(fn[r]) > EPS]
    require(len(stalled_rows) == info["stalled_paths"],
            f"two-asset ensemble NK: rows {stalled_rows} above EPS but "
            f"{info['stalled_paths']} stalled paths")
    single_route = {}
    for r in sorted({*stalled_rows, B - 1}):
        x_r, norm_r, route_r = guarded_route(Jbar, {"G": exog_b["G"][r]}, model, ss0, ssT, x_ss)
        single_route[r] = {"route": route_r, "ensemble_norm": float(fn[r]),
                           "single_path_norm": norm_r, "max_abs": max_abs(xs[0][r], x_r)}
        require(r not in stalled_rows or norm_r > EPS,
                f"row {r} stalls in the ensemble at {float(fn[r]):.3e}, but the single-path "
                f"route reaches {norm_r:.3e}")
    require(len(stalled_rows) < B, "every row of the two-asset ensemble stalled")
    # ‖F‖ of rows 0, B-1 and the worst row by the plain f64 pipeline: the
    # solver's own within 1e-12 + 1e-6 relative, and < EPS where it converged.
    worst = int(fn.argmax())
    plain_fn = {}
    for r in sorted({0, B - 1, worst}):
        F_plain = make_full_residual_fn(model, ss0, ssT, {"G": exog_b["G"][r]})
        plain_fn[r] = float(torch.linalg.norm(F_plain(xs[0][r])))
        require(abs(plain_fn[r] - float(fn[r])) <= 1e-12 + 1e-6 * float(fn[r])
                and (r in stalled_rows or plain_fn[r] < EPS),
                f"plain f64 ‖F‖ of row {r} is {plain_fn[r]:.3e}, the solver's {float(fn[r]):.3e}")
    emit("two_asset_ensemble_nk", B=B, median_s=statistics.median(runs), runs_s=runs,
         per_path_s=statistics.median(runs) / B, outer_iterations=info["iterations"],
         matvecs=info["inner_iterations"], residual_norm_max=float(fn.max()),
         residual_norm_median=float(fn.median()), residual_norm_plain_f64=plain_fn,
         host_ls_s=[i["host_ls_seconds"] for i in infos], stalled_paths=info["stalled_paths"],
         launches=launches, plain_calls=plain_calls, plain_F_calls=plain_F_calls[0],
         single_path_counts=single, bit_identical=True,
         warm_up={"outer_iterations": info_warm["iterations"],
                  "matvecs": info_warm["inner_iterations"]},
         rows_within_eps=B - len(stalled_rows), stalled_rows=stalled_rows,
         single_path_route=single_route)

    # One lockstep boehl solve (Richardson), reported; capped for the
    # script's time limit.
    zero_two_asset_counts()
    t0 = time.perf_counter()
    x_rich, info_r = solve("boehl", max_outer=10, max_inner=200)
    rich_s = time.perf_counter() - t0
    fr = info_r["residual_norm"]
    emit("two_asset_ensemble_boehl", B=B, seconds=rich_s, outer_iterations=info_r["iterations"],
         sweeps=info_r["inner_iterations"], residual_norm_max=float(fr.max()),
         rows_within_eps=int((fr <= EPS).sum()), stalled_paths=info_r["stalled_paths"],
         launches=read_two_asset_counts()[0], max_abs_vs_nk=max_abs(x_rich, xs[0]))

    # f64 directions: the batched tangent pair, then the f64-direction
    # Newton-Krylov solve of the same shocks, held to the f32 solve's rows.
    gen64 = torch.Generator().manual_seed(29)
    v64 = (torch.randn((B, 1, nE), generator=gen64, dtype=f64) * decay).reshape(B, -1).to(dev)
    f64_entries = two_asset_f64_ensemble(two, exog_b, xs[0], fn,
                                         [*prices(x_warm, f64), *prices(v64, f64)], widths)

    # The `kernels` entries: launches per ensemble solve, the ms of the
    # ensemble's width B, the bound of that launch from two_asset_ops × B.
    per_solve = {k: n // len(runs) for k, n in launches.items()}
    args_B, p64_B = wide[B] if B in wide else (sol_args, sol_p64)
    pol, dpol = fs2.fused2_policies_jvp_batch(*args_B, VT32, m32)
    pol_bytes = nbytes(*pol.values(), *dpol.values())
    pol64 = fr2.fused2_policies_f64_batch(*p64_B, VT64, model)
    pol64_bytes = nbytes(*pol64.values())
    agg_bytes = B * 6 * Tm1 * 4
    bounds = {
        "k5_batch": least_time(nbytes(*args_B, VT32) + pol_bytes,
                               B * two_asset_ops(Tm1, *grid, 0), "f32"),
        "k6_batch": least_time(pol_bytes + nbytes(D32) + agg_bytes,
                               B * two_asset_ops(Tm1, *grid, 1), "f32"),
        "k5_f64_batch": least_time(nbytes(*p64_B, VT64) + pol64_bytes,
                                   B * two_asset_ops(Tm1, *grid, 0, tangent=False), "f64"),
        "k6_f64_batch": least_time(pol64_bytes + nbytes(D64) + agg_bytes,
                                   B * two_asset_ops(Tm1, *grid, 1, tangent=False), "f64")}
    meta = {
        "k5_batch": ("fused2_policies_jvp_batch", "hank_tpu_torch/csrc/household_sweep2.cu",
                     "hank_tpu/ops/fused_sweep2.py:673", k5_err,
                     width_ms["k5_batch"], k5_plain_ms),
        "k6_batch": ("fused2_forward_jvp_batch", "hank_tpu_torch/csrc/household_sweep2.cu",
                     "hank_tpu/ops/fused_sweep2.py:984", k6_err,
                     width_ms["k6_batch"], k6_plain_ms),
        "k5_f64_batch": ("fused2_policies_f64_batch",
                         "hank_tpu_torch/csrc/household_sweep2_f64.cu",
                         F_B_REPLACES, k5_f64_err,
                         width_ms["k5_f64_batch"], k5_f64_plain_ms),
        "k6_f64_batch": ("fused2_forward_f64_batch",
                         "hank_tpu_torch/csrc/household_sweep2_f64.cu",
                         F_B_REPLACES, k6_f64_err,
                         width_ms["k6_f64_batch"], k6_f64_plain_ms)}
    return [*({"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": per_solve[k], "max_abs_err": err, "ms": ms[B]["ms"],
               "plain_ms": plain_ms, **bounds[k], "library_ms": None, "B": B,
               "plain_ms_at": "B=1", "cluster": ms[B]["cluster"],
               **{f"ms_B{Bw}": ms[Bw]["ms"] for Bw in widths},
               **{f"single_ms_B{Bw}": ms[Bw]["single_ms"] for Bw in widths}}
              for k, (name, source, replaces, err, ms, plain_ms) in meta.items()),
            *f64_entries]


# Phase 12's model: the shipped two-asset calibration at the published
# two-asset width of `sequence_jacobian`'s hh_twoasset (Auclert, Bardóczy,
# Rognlie & Straub 2021): 50 liquid × 70 illiquid knots on the yaml's
# bounds, T = 150; and the JAX package's CPU root of its fiscal shock.
LARGE_TWO_ASSET = (50, 70, 150)
LARGE_TWO_ASSET_REFERENCE = os.path.join(os.path.dirname(TWO_ASSET_REFERENCE),
                                         "hank_two_asset_50x70_T150_jax_cpu.npz")


def large_two_asset_model(dev):
    """`hank_two_asset` on `dev` with LARGE_TWO_ASSET's grids and horizon."""
    import dataclasses

    import torch

    from hank_tpu_torch.model.grids import make_double_exponential_grid
    from hank_tpu_torch.models import load_model

    n_b, n_a, T = LARGE_TWO_ASSET
    model = load_model("hank_two_asset", T=T, device=dev)
    het = model.heterogeneity

    def axis(name, hi, n):
        grid = torch.tensor(make_double_exponential_grid(0.0, hi, n), dtype=torch.float64,
                            device=dev)
        return dataclasses.replace(het[name], n=n, grid=grid)

    return dataclasses.replace(model, heterogeneity={
        **het, "liquid": axis("liquid", 120.0, n_b), "illiquid": axis("illiquid", 300.0, n_a)})


def forward_global_lists(pol, dpol, D0, model, cluster=None):
    """Kernel 6 (`dpol` given, an f32 model) or the f64 forward push (`dpol`
    None) through its global-list instantiation at any grid it takes, by
    the wrappers' own launchers with `which` the global-list one: single
    path ((T-1, ...) policies) on `cluster` blocks (default the wrapper's),
    or batched ((B, T-1, ...)) on `batch_cluster_of`'s. Counted nowhere."""
    import torch

    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    grid = tuple(model.state_shape())[:3]
    C = cluster or fs2.default_cluster(grid[2])
    if dpol is None:
        if pol["B"].dim() == 5:
            return fr2._launch_forward(*fr2._forward_f64_inputs("f64 push", pol, D0, model),
                                       model, fr2.GLOBAL_LISTS, C)
        tensors, B, Tm1 = fs2._forward_batch_inputs("f64 push", (pol,), D0, model,
                                                    torch.float64, fs2.KEYS)
        return fr2._launch_forward_batch(
            tensors, B, Tm1, D0, model, fr2.GLOBAL_LISTS,
            fs2.batch_cluster_of(fr2.LIBRARY, fr2.GLOBAL_LISTS, B, grid))
    if pol["B"].dim() == 5:
        return fs2._launch_cluster(*fs2._forward_inputs("k6", pol, dpol, D0, model), model, C, 4)
    tensors, B, Tm1 = fs2._forward_batch_inputs("k6", (pol, dpol), D0, model, torch.float32,
                                                fs2.KEYS)
    return fs2._launch_forward_batch(tensors, B, Tm1, D0, model, 4,
                                     fs2.batch_cluster_of("household_sweep2", 4, B, grid))


def global_lists_at_published(model, ss0, ssT, exog, k5_inputs, k6_inputs, points) -> dict:
    """Phase 7's A/B of the global-list forward kernels and the untabled
    backward ones against what the routes launch at 40×20×5×2 (shared
    lists, tabled), on phase 7's inputs: kernel 6 on global lists
    (`forward_global_lists`) bit for bit
    `fused2_forward_jvp` at its six inputs on clusters of 10 and 5; kernel 5
    untabled bit for bit `fused2_policies_jvp` at its six; the f64
    backward untabled, the forward push on global lists and the f64 F through it
    bit for bit the pair's at `points`; at B = 4 the batched global-list
    kernels bit for bit the batched shared-list ones on four of those
    inputs. Emits nothing; returns the report."""
    import torch

    from hank_tpu_torch.models.hank_two_asset import fused2_prices
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    f32, f64 = torch.float32, torch.float64
    m32 = fs2.cast_model(model, f32)
    D32, VT64, D64 = (ss0.D.to(f32).contiguous(), ssT.value.to(f64).contiguous(),
                      ss0.D.to(f64).contiguous())
    Tm1, nE = model.compspec.T - 1, model.compspec.n_endog
    report = {"k6_global": {}, "k5_untabled": {}, "f64": {}}
    for label, (pol, dpol) in k6_inputs.items():
        new = fs2.fused2_forward_jvp(pol, dpol, D32, m32)
        for C in (fs2.default_cluster(model.heterogeneity["income"].n), 5):
            got = forward_global_lists(pol, dpol, D32, m32, C)
            require(all(same_bits(a[k], b[k]) for a, b in zip(got, new) for k in a),
                    f"the global-list kernel 6 at {label} (cluster {C}) differs from kernel 6")
        report["k6_global"][label] = True
    for label, (args, VT) in k5_inputs.items():
        new = fs2.fused2_policies_jvp(*args, VT, m32)
        got = fs2._launch_bwd_cluster(tuple(args), VT, m32, fs2.default_bwd_cluster(
            model.heterogeneity["income"].n), untabled=True)
        require(all(same_bits(a[k], b[k]) for a, b in zip(got, new) for k in a),
                f"kernel 5 untabled at {label} differs from kernel 5 tabled")
        report["k5_untabled"][label] = True
    F_pair = fr2.make_fused2_residual_fn_f64(model, ss0, ssT, exog)
    for label, x in points.items():
        prices = [q.contiguous() for q in fused2_prices(x.reshape(Tm1, nE), exog, model)]
        pol = fr2.fused2_policies_f64(*prices, VT64, model)
        untabled = fr2._launch_policies(prices, VT64, model, untabled=True)
        aggs = fr2.fused2_forward_f64(pol, D64, model)
        glob = forward_global_lists(pol, None, D64, model)
        F = F_pair(x)
        forward = fr2.forward_kernel
        fr2.forward_kernel = lambda *a: fr2.GLOBAL_LISTS
        try:
            F_global = F_pair(x)
        finally:
            fr2.forward_kernel = forward
        require(all(same_bits(untabled[k], pol[k]) and same_bits(glob[k], aggs[k]) for k in pol)
                and same_bits(F_global, F),
                f"the f64 pair's untabled or global-list kernel at {label} differs")
        report["f64"][label] = True
    labels = list(k6_inputs)[:4]
    pol_b = {k: torch.stack([k6_inputs[lb][0][k] for lb in labels]) for k in fs2.KEYS}
    dpol_b = {k: torch.stack([k6_inputs[lb][1][k] for lb in labels]) for k in fs2.KEYS}
    got = forward_global_lists(pol_b, dpol_b, D32, m32)
    new = fs2.fused2_forward_jvp_batch(pol_b, dpol_b, D32, m32)
    pol64_b = {k: v.double() for k, v in pol_b.items()}
    got64 = forward_global_lists(pol64_b, None, D64, model)
    new64 = fr2.fused2_forward_f64_batch(pol64_b, D64, model)
    require(all(same_bits(a[k], b[k]) for a, b in [*zip(got, new), (got64, new64)] for k in a),
            "a batched global-list forward kernel at B = 4 differs from the shared-list one")
    report["batched_B4"] = labels
    # The price of global lists at a grid both take: each forward kernel in
    # turns with its shared-list instantiation at the solution (shared,
    # global, global, shared), medians of the turns.
    pol, dpol = k6_inputs["solution"]
    pol64 = {k: v.double() for k, v in pol.items()}
    report["ms_in_turns"] = {
        "k6": in_turns({"shared": lambda: fs2.fused2_forward_jvp(pol, dpol, D32, m32),
                        "global": lambda: forward_global_lists(pol, dpol, D32, m32)},
                       5),
        "k6_f64": in_turns({"shared": lambda: fr2.fused2_forward_f64(pol64, D64, model),
                            "global": lambda: forward_global_lists(pol64, None, D64, model)},
                           5)}
    return report


def two_asset_large_grid_phase(dev, ptxas) -> list:
    """Phase 12: the two-asset route at LARGE_TWO_ASSET (50×70×5×2, T=150),
    past the shared-list forward kernels' 2048 asset states (see the module
    docstring). Emits its JSON lines and returns the `kernels` entries of
    the instantiations it launches."""
    import numpy as np
    import torch

    from hank_tpu_torch.blocks.assemble import residuals as eval_residuals
    from hank_tpu_torch.model.structures import generate_exog_paths
    from hank_tpu_torch.models.hank_two_asset import fused2_prices
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2
    from hank_tpu_torch.ops.transition import exog_apply, lottery_apply_multi
    from hank_tpu_torch.solvers import newton as newton_mod
    from hank_tpu_torch.solvers.linear import linear_impulse_response
    from hank_tpu_torch.solvers.newton import make_full_residual_fn, make_path_solver
    from hank_tpu_torch.utils.checkpoint import (get_or_solve, save_steady_state,
                                                 steady_state_from_numpy)

    f32, f64 = torch.float32, torch.float64
    model = large_two_asset_model(dev)
    cs = model.compspec
    Tm1, nE = cs.T - 1, cs.n_endog
    n_b, n_a, n_e = model.state_shape()[:3]
    grid = (n_b, n_a, n_e)
    p = model.params

    # Setup, cut (PERF.md §4): the port's steady-state Newton takes ~6 min an
    # iteration at this grid on the card, and one household solve near the
    # root up to minutes, so the steady state is the reference file's (the
    # one the JAX CPU root was solved from: the port's, by a warm-started
    # Newton, `tests/two_asset_50x70_recipe.py`; the JAX package's household
    # gives the same arrays at its prices, a slow test), carried across by
    # `steady_state_from_numpy`, and the card builds J̄ by `get_or_solve`
    # into a fresh temporary cache (timed).
    with np.load(LARGE_TWO_ASSET_REFERENCE) as z:
        ref_vars = dict(zip([str(s) for s in z["var_names"]], z["var_values"]))
        x_jax = torch.as_tensor(z["x"], dtype=f64, device=dev)
        ss = steady_state_from_numpy(
            {"vars": ref_vars, "policies": {k: z[f"policy_{k}"] for k in fs2.KEYS},
             "D": z["D"], "value": z["value"]}, device=dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as cache:
        save_steady_state(ss, model, "initial", cache_dir=cache)
        ss0, ssT, Jbar = get_or_solve(model, cache_dir=cache)
    torch.cuda.synchronize()
    jbar_s = time.perf_counter() - t0
    col = torch.stack([torch.as_tensor(ssT.vars[k]) for k in model.var_names()])
    F_ss = float(eval_residuals(col[:, None].expand(cs.n_v, 1 + cs.max_lag + cs.max_lead),
                                model).abs().max())
    require(F_ss <= 1e-9, f"50x70 steady state residual {F_ss:.3e} > 1e-9")
    clearing = max(abs(float(ssT.vars["B"]) - p["Bg"]),
                   abs(float(ssT.vars["A"]) - float(ssT.vars["KS"])))
    require(clearing <= 1e-8, f"50x70 markets off by {clearing:.3e}")
    # The file's steady state is a fixed point of the port's household, on
    # the card: one Bellman step returns its value and policies, one period
    # of the distribution its D, and its B, A, C are Σ policy·D
    # (`tests/test_torch_fused2_large_grid.py`'s limits).
    step = model.value_fn(ssT.value, ssT.vars, model)
    dims = model.endog_dims()
    D_next = exog_apply(lottery_apply_multi([step[d.policy_var] for d in dims], ssT.D,
                                            [d.grid for d in dims]),
                        [d.transition for d in model.exog_dims()], len(dims))
    fixed_point = {
        "bellman": max_abs(step["Value"], ssT.value),
        "policies": max(max_abs(step[k], ssT.policies[k]) for k in fs2.KEYS),
        "transition": max_abs(D_next, ssT.D),
        "aggregates": max(abs(float(torch.sum(ssT.policies[k] * ssT.D)) - float(ssT.vars[k]))
                          for k in fs2.KEYS)}
    limits = {"bellman": 1e-13, "policies": 1e-10, "transition": 1e-15, "aggregates": 1e-12}
    require(all(fixed_point[k] <= limits[k] for k in limits),
            f"the 50x70 steady state is not the household's fixed point: {fixed_point}")

    # The routes' decisions on the card: kernel 6 and the f64 forward push on
    # their global-list instantiations, kernel 5 and the f64 backward untabled.
    decisions = {"k6": fs2.check_fit_kernels(model), "k6_f64": fr2.check_fit_f64(model),
                 "k5_tabled": cuda_build.sweep2_smem_bytes(3, *grid, 5)
                 != cuda_build.sweep2_smem_bytes(5, *grid, 5),
                 "k5_f64_tabled": cuda_build.sweep2_f64_smem_bytes(0, *grid, 5)
                 != cuda_build.sweep2_f64_smem_bytes(3, *grid, 5),
                 "smem": {"k5": cuda_build.sweep2_smem_bytes(3, *grid, 5),
                          "k6_global": cuda_build.sweep2_smem_bytes(4, *grid, 10),
                          "k5_f64": cuda_build.sweep2_f64_smem_bytes(0, *grid, 5),
                          "k6_f64_global": cuda_build.sweep2_f64_smem_bytes(2, *grid, 10)}}
    require(decisions["k6"] == 4 and decisions["k6_f64"] == fr2.GLOBAL_LISTS
            and not decisions["k5_tabled"] and not decisions["k5_f64_tabled"],
            f"at 50x70 the routes did not take the global-list and untabled kernels: {decisions}")
    emit("two_asset_large_setup", grid=list(model.state_shape()), T=cs.T, jbar_s=jbar_s,
         max_abs_F_ss=F_ss, market_clearing=clearing,
         household_fixed_point={k: [fixed_point[k], limits[k]] for k in limits},
         KS=float(ssT.vars["KS"]), r=float(ssT.vars["r"]), ra=float(ssT.vars["ra"]),
         decisions=decisions)

    # Phase 7's route (`bench.py:282-310`), its full-precision F through the
    # f64 pair; the plain f64 F's calls counted through the name the solvers
    # are built from.
    exog = generate_exog_paths(model, Tm1)
    endog = model.vars_of_type("endogenous")
    x_ss = torch.stack([torch.as_tensor(ssT.vars[k]) for k in endog]).repeat(Tm1)
    plain_F_calls = [0]
    plain_residual = newton_mod.make_full_residual_fn

    def counted_residual(*a):
        F = plain_residual(*a)

        def counted(x):
            plain_F_calls[0] += 1
            return F(x)

        return counted

    def boehl(**kw):
        return make_path_solver(Jbar, exog, model, ss0, ssT, method="boehl",
                                direction_dtype=f32, eps=EPS, host_inner=True, **kw)

    newton_mod.make_full_residual_fn = counted_residual
    endgame_only, two_phase = boehl(richardson_max_outer=0), boehl()
    newton_mod.make_full_residual_fn = plain_residual

    def lin_route():
        x_lin, _ = linear_impulse_response(Jbar, exog, model, ss0, ssT,
                                           compute_residual=False)
        x, info = endgame_only(x_lin)
        torch.cuda.synchronize()
        return x, info

    def ss_route():
        x, info = two_phase(x_ss)
        torch.cuda.synchronize()
        return x, info

    lin_info = linear_impulse_response(Jbar, exog, model, ss0, ssT)[1]
    lin_ok = lin_info["residual_norm"] < lin_info["f0_norm"]
    route, route_name = lin_route, "linstart_endgame_only"
    if lin_ok:
        x_warm, info_warm = route()
    if not lin_ok or info_warm["residual_norm"] > EPS:
        route, route_name = ss_route, "ss_two_phase_fallback"
        x_warm, info_warm = route()

    # Each kernel the route launches at x_ss and at the solution against its
    # plain version (phase 7's bounds; smooth seeded directions; kernel 5's
    # tangents aggregated by kernel 6's plain version); its plain ms once.
    m32 = fs2.cast_model(model, f32)
    VT32, D32 = ssT.value.to(f32).contiguous(), ss0.D.to(f32).contiguous()
    VT32d, D32d = VT32.double(), D32.double()     # the f32 kernels' inputs, for their plain runs
    VT64, D64 = ssT.value.to(f64).contiguous(), ss0.D.to(f64).contiguous()
    gen = torch.Generator().manual_seed(12)
    decay = (0.9 ** torch.arange(Tm1, dtype=f64))[:, None]

    def k5_args(x, v):
        return [q.to(f32).contiguous() for q in
                (*fused2_prices(x.reshape(Tm1, nE), exog, model),
                 *fused2_prices(v.reshape(Tm1, nE), exog, model))]

    def as64(d):
        return {k: t.double() for k, t in d.items()}

    def dict_err(a, b):
        return max(max_abs(a[k].double(), b[k]) for k in b)

    def scale_of(*ds):
        return max(1.0, max(float(t.abs().max()) for d in ds for t in d.values()))

    F_plain = make_full_residual_fn(model, ss0, ssT, exog)
    F_pair = fr2.make_fused2_residual_fn_f64(model, ss0, ssT, exog)
    checks, errs, plain_ms = {}, {"k5": 0.0, "k6": 0.0, "k5_f64": 0.0, "k6_f64": 0.0}, {}
    f64_inputs = {}             # for the f64 tangent pair: the same inputs in f64, their plain run
    for name, x in (("x_ss", x_ss), ("solution", x_warm)):
        v = (torch.randn(nE, generator=gen, dtype=f64) * decay).reshape(-1).to(dev)
        args = k5_args(x, v)
        pol, dpol = fs2.fused2_policies_jvp(*args, VT32, m32)
        (ref, dref), plain_ms["k5"] = cuda_once(lambda: fs2.fused2_policies_jvp_reference(
            *(a.double() for a in args), VT32d, model))
        f64_inputs[name] = ([a.double() for a in args], VT32d, D32d, (ref, dref))
        agg, dagg = fs2.fused2_forward_jvp(pol, dpol, D32, m32)
        (ragg, rdagg), plain_ms["k6"] = cuda_once(lambda: fs2.fused2_forward_jvp_reference(
            as64(pol), as64(dpol), D32d, model))
        _, pdagg = fs2.fused2_forward_jvp_reference(ref, dref, D32d, model)
        e5p, e5t = dict_err(pol, ref), dict_err(rdagg, pdagg)
        e6 = max(dict_err(agg, ragg), dict_err(dagg, rdagg))
        for what, err, scale in (("kernel 5 policies", e5p, scale_of(ref)),
                                 ("kernel 5 tangents (aggregated)", e5t, scale_of(pdagg)),
                                 ("kernel 6", e6, scale_of(ragg, rdagg))):
            require(err <= 5e-5 * scale,
                    f"50x70 {what} at {name} off its plain version by {err:.3e} (scale {scale})")
        prices = [q.contiguous() for q in fused2_prices(x.reshape(Tm1, nE), exog, model)]
        pol64 = fr2.fused2_policies_f64(*prices, VT64, model)
        ref64, plain_ms["k5_f64"] = cuda_once(lambda: fr2.fused2_policies_f64_reference(
            *prices, VT64, model))
        aggs64 = fr2.fused2_forward_f64(pol64, D64, model)
        raggs64, plain_ms["k6_f64"] = cuda_once(lambda: fr2.fused2_forward_f64_reference(
            pol64, D64, model))
        e5f, e6f = dict_err(pol64, ref64), dict_err(aggs64, raggs64)
        F_ref, plain_ms["F"] = cuda_once(lambda: F_plain(x))
        F_err = max_abs(F_pair(x), F_ref)
        require(e5f <= 1e-10 * scale_of(ref64) and e6f <= 1e-11 and F_err <= 1e-11,
                f"the 50x70 f64 pair at {name}: {e5f:.3e}, {e6f:.3e}, F {F_err:.3e}")
        checks[name] = {"k5_policies": e5p, "k5_tangents_aggregated": e5t, "k6": e6,
                        "k5_f64": e5f, "k6_f64": e6f, "F_pair_vs_plain": F_err}
        errs = {"k5": max(errs["k5"], e5p, e5t), "k6": max(errs["k6"], e6),
                "k5_f64": max(errs["k5_f64"], e5f), "k6_f64": max(errs["k6_f64"], e6f)}
    require(all(torch.equal(a, b) for a, b in
                ((pol["B"], fs2.fused2_policies_jvp(*args, VT32, m32)[0]["B"]),
                 (agg["A"], fs2.fused2_forward_jvp(pol, dpol, D32, m32)[0]["A"]))),
            "50x70 kernels 5-6: repeated launches differ")

    # The batched global-list kernels on the solution's policies: at B = 4
    # every row bit for bit a single launch; ms per launch at B = 1, 4, 16
    # beside the cluster `batch_cluster_of` takes.
    def rows(d, B):
        return {k: t.unsqueeze(0).expand(B, *t.shape).contiguous() for k, t in d.items()}

    b4 = fs2.fused2_forward_jvp_batch(rows(pol, 4), rows(dpol, 4), D32, m32)
    b4_64 = fr2.fused2_forward_f64_batch(rows(pol64, 4), D64, model)
    require(all(same_bits(b4[i][k][r], (agg, dagg)[i][k]) and same_bits(b4_64[k][r], aggs64[k])
                for i in range(2) for k in agg for r in range(4)),
            "a batched global-list forward kernel's row at 50x70 differs from a single launch")
    batched = {"k6_batch": {}, "k6_f64_batch": {}}
    for B in (1, 4, 16):
        pb, db, pb64 = rows(pol, B), rows(dpol, B), rows(pol64, B)
        batched["k6_batch"][B] = {
            "ms": cuda_ms(lambda: fs2.fused2_forward_jvp_batch(pb, db, D32, m32), 3),
            "cluster": fs2.batch_cluster_of("household_sweep2", 4, B, grid)}
        batched["k6_f64_batch"][B] = {
            "ms": cuda_ms(lambda: fr2.fused2_forward_f64_batch(pb64, D64, model), 3),
            "cluster": fs2.batch_cluster_of(fr2.LIBRARY, fr2.GLOBAL_LISTS, B, grid)}
        del pb, db, pb64
        torch.cuda.empty_cache()
    timing = {"k5_ms": cuda_ms(lambda: fs2.fused2_policies_jvp(*args, VT32, m32), 3),
              "k6_ms": cuda_ms(lambda: fs2.fused2_forward_jvp(pol, dpol, D32, m32), 3),
              "k5_f64_ms": cuda_ms(lambda: fr2.fused2_policies_f64(*prices, VT64, model), 3),
              "k6_f64_ms": cuda_ms(lambda: fr2.fused2_forward_f64(pol64, D64, model), 3),
              "F_pair_ms": cuda_ms(lambda: F_pair(x_warm), 3),
              "F_plain_ms": plain_ms.pop("F")}
    emit("two_asset_large_kernels", checks=checks, batched=batched, plain_ms=plain_ms,
         cluster={"k5": fs2.default_bwd_cluster(n_e), "k6": fs2.default_cluster(n_e)},
         ptxas=[k for k in ptxas if "fwd_cluster_kernelI" in k["kernel"]
                or "fwd_f64_cluster_kernelI" in k["kernel"]], **timing)

    # Three timed runs of the route; counts zeroed right before: kernel 5,
    # the global-list kernel 6 and the f64 pair (its global-list forward
    # push) launched, no shared-list forward kernel, plain version, previous
    # kernel or plain f64 F.
    zero_two_asset_counts()
    for fn in (fs2.fused2_forward_jvp, fr2.fused2_forward_f64):
        fn.launches_global = 0
    plain_F_calls[0] = 0
    runs, xs, infos = [], [], []
    newton_mod.make_full_residual_fn = counted_residual     # the linear start's F too
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            x_sol, info = route()
            runs.append(time.perf_counter() - t0)
            xs.append(x_sol)
            infos.append(info)
    finally:
        newton_mod.make_full_residual_fn = plain_residual
    launches = {"k5": fs2.fused2_policies_jvp.launches,
                "k6_global": fs2.fused2_forward_jvp.launches_global,
                "k5_f64": fr2.fused2_policies_f64.launches,
                "k6_f64_global": fr2.fused2_forward_f64.launches_global}
    others = {**read_two_asset_counts()[2], "F_f64": plain_F_calls[0]}
    others = {k: n for k, n in others.items() if k not in ("k5", "k5_f64")}
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the 50x70 route never launched: {launches}")
    require(not any(others.values()),
            f"a shared-list forward kernel, a plain version, a previous kernel or the plain "
            f"f64 F ran on the 50x70 route: {others}")
    require(all(torch.equal(x_warm, xi) for xi in xs),
            "repeated 50x70 solves returned different paths")
    require(bool(torch.isfinite(x_warm).all()) and x_warm.shape == x_ss.shape,
            "the 50x70 solution is not a finite path of the expected shape")
    fnorm_plain = float(torch.linalg.norm(F_plain(x_warm)))
    require(fnorm_plain <= EPS, f"50x70 plain f64 ‖F‖ is {fnorm_plain:.3e}")
    vs_jax = max_abs(x_warm, x_jax)
    require(vs_jax <= 1e-7, f"the 50x70 path is {vs_jax:.3e} off the JAX CPU root")
    info = infos[0]
    per_solve = {k: n // 3 for k, n in launches.items()}
    emit("two_asset_large_solve", route=route_name, median_s=statistics.median(runs),
         runs_s=runs, linear_residual_norm=lin_info["residual_norm"],
         forcing_norm=lin_info["f0_norm"], outer_iterations=info["iterations"],
         matvecs_and_sweeps=info["inner_iterations"], prof=info["prof"],
         residual_norm=info["residual_norm"], residual_norm_plain_f64=fnorm_plain,
         max_abs_vs_jax=vs_jax, launches=launches, launches_per_solve=per_solve,
         other_counts=others, stalled_rows=[], bit_identical=True)

    # f64 directions at 50x70: the tangent pair (its global-state backward
    # and global-list forward push) at x_ss, the solution and a smooth
    # seeded point; then a Newton-Krylov solve with f64 directions (a
    # warm-up and a timed run; counts zeroed right before them).
    smooth_x = x_ss + (1e-3 * torch.randn(nE, generator=gen, dtype=f64)
                       * decay).reshape(-1).to(dev)
    v = (torch.randn(nE, generator=gen, dtype=f64) * decay).reshape(-1).to(dev)
    pair = tangent_pair_checks(model, ss0, ssT, exog, f64_inputs, smooth_x, v, 3)
    require(pair["kernels"] == {"backward": fs2.JVP_F64_BWD_GLOBAL, "forward": 6},
            f"at 50x70 the tangent pair did not take its global instantiations: {pair}")
    emit("two_asset_large_f64_directions", **{k: v for k, v in pair.items()
                                              if not k.endswith("_bytes")})
    zero_tangent_pair_counts()
    plain_F_calls[0] = 0
    newton_mod.make_full_residual_fn = counted_residual
    try:
        nk = make_path_solver(Jbar, exog, model, ss0, ssT, method="newton_krylov", eps=EPS)
        nk_runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            x_nk, info_nk = nk(x_ss)
            torch.cuda.synchronize()
            nk_runs.append(time.perf_counter() - t0)
    finally:
        newton_mod.make_full_residual_fn = plain_residual
    nk_counts = tangent_pair_counts()
    require_tangent_route(nk_counts, plain_F_calls[0], {"bwd_global", "fwd_global"},
                          "the 50x70 f64-direction solve")
    fnorm_nk = float(torch.linalg.norm(F_plain(x_nk)))
    nk_vs_jax = max_abs(x_nk, x_jax)
    require(fnorm_nk <= EPS and nk_vs_jax <= 1e-7,
            f"the 50x70 f64-direction solve: plain f64 ‖F‖ {fnorm_nk:.3e}, "
            f"{nk_vs_jax:.3e} off the JAX CPU root")
    emit("two_asset_large_f64_solve", method="newton_krylov", seconds=nk_runs[-1],
         runs_s=nk_runs, outer_iterations=info_nk["iterations"],
         directions_per_solve=nk_counts["bwd_global"] // 2,
         F_calls_per_solve=nk_counts["values_bwd"] // 2, residual_norm=info_nk["residual_norm"],
         residual_norm_plain_f64=fnorm_nk, max_abs_vs_jax=nk_vs_jax, launches=nk_counts)

    # The batched tangent pair at 50x70 (its global-state backward and
    # global-list push, on no solver's path: no ensemble at this grid here)
    # at B = 4 on x_ss, the solution, the smooth point and x_ss again along
    # v, every row bit for bit a single launch.
    rows4 = [torch.stack(q) for q in zip(*(
        [q_.contiguous() for q_ in (*fused2_prices(x_.reshape(Tm1, nE), exog, model),
                                   *fused2_prices(v.reshape(Tm1, nE), exog, model))]
        for x_ in (x_ss, x_nk, smooth_x)))]
    batch4 = tangent_pair_batch_rows(model, ss0, ssT, [q.to(f64).contiguous() for q in rows4],
                                     (4,), reps=3)
    require((batch4["backward"], batch4["forward"]) == (fs2.JVP_F64_BWD_GLOBAL, 6),
            f"at 50x70 the batched tangent pair did not take its global instantiations: "
            f"{batch4}")
    emit("two_asset_large_f64_batch", **{k: v for k, v in batch4.items()
                                         if not k.endswith("_bytes")})

    # The `kernels` entries at 50x70: launches per route solve, bounds from
    # the timed calls' inputs.
    s2, s64 = "hank_tpu_torch/csrc/household_sweep2.cu", "hank_tpu_torch/csrc/household_sweep2_f64.cu"
    pol_bytes = nbytes(*pol.values(), *dpol.values())
    pol64_bytes = nbytes(*pol64.values())
    replaces_f64 = ("hank_tpu/solvers/newton.py:352-376 (the two-asset F in f64 under XLA; "
                    "no TPU kernel)")
    common = {"route": "cuda", "library_ms": None, "grid": "50x70x5x2, T=150"}
    out = [
        {**common, "name": "fused2_policies_jvp (untabled, 50x70)", "source": s2,
         "replaces": "hank_tpu/ops/fused_sweep2.py:673", "launches": per_solve["k5"],
         "max_abs_err": errs["k5"], "ms": timing["k5_ms"], "plain_ms": plain_ms["k5"],
         **least_time(nbytes(*args, VT32) + pol_bytes, two_asset_ops(Tm1, *grid, 0), "f32"),
         "cluster": fs2.default_bwd_cluster(n_e)},
        {**common, "name": "fused2_forward_jvp (global lists)", "source": s2,
         "replaces": "hank_tpu/ops/fused_sweep2.py:984", "launches": per_solve["k6_global"],
         "max_abs_err": errs["k6"], "ms": timing["k6_ms"], "plain_ms": plain_ms["k6"],
         **least_time(pol_bytes + nbytes(D32, *agg.values(), *dagg.values()),
                      two_asset_ops(Tm1, *grid, 1), "f32"), "cluster": fs2.default_cluster(n_e)},
        {**common, "name": "fused2_policies_f64 (untabled, 50x70)", "source": s64,
         "replaces": replaces_f64, "launches": per_solve["k5_f64"],
         "max_abs_err": errs["k5_f64"], "ms": timing["k5_f64_ms"],
         "plain_ms": plain_ms["k5_f64"],
         **least_time(nbytes(*prices, VT64) + pol64_bytes,
                      two_asset_ops(Tm1, *grid, 0, tangent=False), "f64"),
         "F_ms": timing["F_pair_ms"], "F_plain_ms": timing["F_plain_ms"]},
        {**common, "name": "fused2_forward_f64 (global lists)", "source": s64,
         "replaces": replaces_f64, "launches": per_solve["k6_f64_global"],
         "max_abs_err": errs["k6_f64"], "ms": timing["k6_f64_ms"],
         "plain_ms": plain_ms["k6_f64"],
         **least_time(pol64_bytes + nbytes(D64, *aggs64.values()),
                      two_asset_ops(Tm1, *grid, 1, tangent=False), "f64")},
    ]
    for key, name, source, replaces, err, kind, tangent in (
            ("k6_batch", "fused2_forward_jvp_batch (global lists)", s2,
             "hank_tpu/ops/fused_sweep2.py:984", errs["k6"], "f32", True),
            ("k6_f64_batch", "fused2_forward_f64_batch (global lists)", s64, F_B_REPLACES,
             errs["k6_f64"], "f64", False)):
        per_path = (pol_bytes + nbytes(*agg.values(), *dagg.values()) if tangent
                    else pol64_bytes + nbytes(*aggs64.values()))
        out.append({**common, "name": name, "source": source, "replaces": replaces,
                    "launches": 0, "main_path": "no ensemble at 50x70 on this script's path",
                    "max_abs_err": err, "ms": batched[key][16]["ms"], "B": 16,
                    "plain_ms": plain_ms["k6" if tangent else "k6_f64"], "plain_ms_at": "B=1",
                    **least_time(16 * per_path + nbytes(D32 if tangent else D64),
                                 16 * two_asset_ops(Tm1, *grid, 1, tangent=tangent), kind),
                    "cluster": batched[key][16]["cluster"],
                    **{f"ms_B{B}": batched[key][B]["ms"] for B in (1, 4, 16)}})
    out += tangent_pair_entries(pair, model, {"bwd": nk_counts["bwd_global"] // 2,
                                                 "fwd": nk_counts["fwd_global"] // 2},
                                "50x70x5x2, T=150")
    out += tangent_pair_batch_entries(batch4, pair, model, {"bwd": 0, "fwd": 0}, 4,
                                      "50x70x5x2, T=150",
                                      main_path="no ensemble at 50x70 on this script's path")
    return out


def global_list_grids() -> dict:
    """The global-list forward kernels' shared memory on their default
    clusters by the libraries' own counts: required to fit at 50×70×5×2,
    48×64×5×2 and 64×64×5×2 (the 4096-state cap), with kernel 5 and the f64
    backward (untabled where their tables have no room); and of every grid
    past 2048 asset states up to the cap (n_b, n_a ≥ 6, n_e ≤ 8), how many
    each takes (reported)."""
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    lib2 = cuda_build.load_library("household_sweep2")
    f64 = cuda_build.load_library("household_sweep2_f64")
    limit = cuda_build.MAX_SMEM_BYTES
    at = {}
    for n_b, n_a in ((50, 70), (48, 64), (64, 64)):
        c5, c6 = fs2.default_bwd_cluster(5), fs2.default_cluster(5)
        at[f"{n_b}x{n_a}x5x2"] = {
            "k5": lib2.hank_sweep2_smem_bytes(3, n_b, n_a, 5, c5),
            "k6_global": lib2.hank_sweep2_smem_bytes(4, n_b, n_a, 5, c6),
            "k5_f64": f64.hank_sweep2_f64_smem_bytes(0, n_b, n_a, 5, c5),
            "k6_f64_global": f64.hank_sweep2_f64_smem_bytes(2, n_b, n_a, 5, c6)}
        require(max(at[f"{n_b}x{n_a}x5x2"].values()) <= limit,
                f"a kernel of the two-asset route does not fit {n_b}x{n_a}x5x2: {at}")
    taken = {"grids": 0, "k6_global": 0, "k6_f64_global": 0}
    for n_e in range(1, 9):
        c = fs2.default_cluster(n_e)
        for n_b in range(6, 4096 // 6 + 1):
            for n_a in range(max(6, 2048 // n_b + 1), 4096 // n_b + 1):
                taken["grids"] += 1
                taken["k6_global"] += lib2.hank_sweep2_smem_bytes(4, n_b, n_a, n_e, c) <= limit
                taken["k6_f64_global"] += f64.hank_sweep2_f64_smem_bytes(
                    2, n_b, n_a, n_e, c) <= limit
    return {"smem_bytes": at, "grids_past_2048_states": taken}


def driver_case(name: str, T: int, dev, cache: str) -> dict:
    """Phase 8 for one model family (see the module docstring). Emits its
    JSON lines and returns what phase 9 and the summary need."""
    import contextlib
    import io

    import numpy as np
    import torch

    from hank_tpu_torch import run
    from hank_tpu_torch.model.structures import generate_exog_paths
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                                   fused_residual_sweep_previous,
                                                   fused_residual_sweep_reference)
    from hank_tpu_torch.ops.fused_sweep import (fused_sweep_jvp, fused_sweep_jvp_f64,
                                                fused_sweep_jvp_reference, sweep_setup)
    from hank_tpu_torch.solvers.newton import make_full_residual_fn
    from hank_tpu_torch.utils.checkpoint import get_or_solve

    f32, f64 = torch.float32, torch.float64
    model = load_model(name, T=T, device=dev)
    cs = model.compspec
    Tm1, nE = T - 1, cs.n_endog
    n_a, n_e = model.state_shape()
    endog = model.vars_of_type("endogenous")

    # Setup into the fresh cache the driver then reads.
    t0 = time.perf_counter()
    ss0, ssT, Jbar = get_or_solve(model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    F_ss = steady_residual(model, ssT)
    require(F_ss <= 1e-9, f"{name}: steady state residual {F_ss:.3e} > 1e-9")
    with np.load(jax_root_file(name, T)) as z:
        ref_vars = dict(zip([str(s) for s in z["var_names"]], z["var_values"]))
        x_jax = torch.as_tensor(z["x"], dtype=f64, device=dev)
    ss_gap = max(abs(float(ssT.vars[k]) - float(v)) for k, v in ref_vars.items())
    require(ss_gap <= 1e-8, f"{name}: steady state {ss_gap:.3e} off the JAX reference")
    lib = cuda_build.load_library()
    smem = {"k1": lib.hank_sweep_smem_bytes(2, n_a, n_e),
            "k1_previous": lib.hank_sweep_smem_bytes(1, n_a, n_e),
            "k2": lib.hank_sweep_smem_bytes(4, n_a, n_e),
            "k2_previous": lib.hank_sweep_smem_bytes(0, n_a, n_e)}
    emit("driver_setup", model=name, grid=[n_a, n_e], T=T, seconds=setup_s,
         max_abs_F_ss=F_ss, max_abs_vs_jax_ss=ss_gap, smem_bytes=smem,
         **{k: float(ssT.vars[k]) for k in endog})

    # The user's entry point once: `python -m hank_tpu_torch.run` in-process,
    # its path read back from the CSV it writes (%.18e: exact in f64).
    def cli(extra):
        out = os.path.join(cache, f"{name}{''.join(extra)}.csv")
        with contextlib.redirect_stdout(io.StringIO()):
            summary = run.main(["--model", name, "--T", str(T), "--device", str(dev),
                                "--out", out, *extra])
        path = np.loadtxt(out, delimiter=",", skiprows=1)[:, 1:]
        return summary, torch.as_tensor(path.reshape(-1), dtype=f64, device=dev)

    summary, x_cli = cli(["--mixed", "--method", "newton_krylov", "--eps", "1e-8"])

    # Kernels 1 and 2 against their plain versions at x_ss and the solution,
    # along smooth seeded directions, at the bounds of phase 4.
    exog = generate_exog_paths(model, Tm1)
    x_ss = torch.stack([torch.as_tensor(ssT.vars[k]) for k in endog]).repeat(Tm1)
    hook, c32, kw, _, _ = sweep_setup(model, ss0, ssT, f32)
    c64 = [c.double() for c in sweep_setup(model, ss0, ssT, f64)[1]]
    gen = torch.Generator().manual_seed(8)
    decay = (0.9 ** torch.arange(Tm1, dtype=f64))[:, None]

    def sweep_args(x, v, dtype):
        (r, s), (dr, ds) = torch.func.jvp(
            lambda xx: hook(xx.reshape(Tm1, nE), exog, model), (x,), (v,))
        return [t.to(dtype).contiguous() for t in (r, s, dr, ds)]

    # Kernel 1's plain version runs in float64 on the same f32 input values,
    # as in phases 6-7: an f32 rounding of the EGM knots can put a query
    # exactly on a knot in one f32 computation and not in another.
    c32_as64 = [c.double() for c in c32]
    k1_err = k2_err = 0.0
    bit_inputs = {}
    for label, x in (("x_ss", x_ss), ("solution", x_cli)):
        v = (torch.randn(nE, generator=gen, dtype=f64) * decay).reshape(-1).to(dev)
        args = sweep_args(x, v, f32)
        bit_inputs[label] = (*args, *c32)
        for o, r_ in zip(fused_sweep_jvp(*args, *c32, **kw),
                         fused_sweep_jvp_reference(*(a.double() for a in args), *c32_as64,
                                                   **kw)):
            err, scale = max_abs(o.double(), r_), float(r_.abs().max())
            require(err <= 3e-5 * max(scale, 1.0),
                    f"{name}: kernel 1 off its plain version by {err:.3e} (scale {scale:.3e})")
            k1_err = max(k1_err, err)
        args64 = sweep_args(x, v, f64)[:2]
        k2_err = max(k2_err, *(max_abs(o, r_) for o, r_ in zip(
            fused_residual_sweep(*args64, *c64, **kw),
            fused_residual_sweep_reference(*args64, *c64, **kw))))
    require(k2_err <= 1e-11, f"{name}: kernel 2 off its plain version by {k2_err:.3e}")
    smooth = x_ss + (1e-3 * torch.randn(nE, generator=gen, dtype=f64)
                     * decay).reshape(-1).to(dev)
    v = (torch.randn(nE, generator=gen, dtype=f64) * decay).reshape(-1).to(dev)
    bit_inputs["smooth"] = (*sweep_args(smooth, v, f32), *c32)
    bits = kernel1_vs_previous(bit_inputs, kw)
    # Kernel 2 against the previous kernel 2 at the same points in f64, and
    # with two knots of the grid swapped (its fallback branches).
    bit_inputs64 = {label: (*sweep_args(x, v, f64)[:2], *c64) for label, x in
                    (("x_ss", x_ss), ("solution", x_cli), ("smooth", smooth))}
    k = n_a // 2
    swapped = c64[2].clone()
    swapped[[k, k + 1]] = swapped[[k + 1, k]]
    bit_inputs64["grid_swapped"] = (*bit_inputs64["x_ss"][:4], swapped,
                                    *bit_inputs64["x_ss"][5:])
    bits2 = kernel2_vs_previous(bit_inputs64, kw)
    require(sum(fallback_sum(bits2, ["grid_swapped"])) > 0,
            f"{name}: kernel 2 on the swapped grid took no fallback branch: {bits2}")
    k2_turns = in_turns({
        "k2_previous": lambda: fused_residual_sweep_previous(*args64, *c64, **kw),
        "k2": lambda: fused_residual_sweep(*args64, *c64, **kw)}, 10)
    jvp64_args = sweep_args(x_cli, v, f64)
    global_500 = None
    if name == "ks_large_grid":
        global_500 = global_state_at_500(bit_inputs, bit_inputs64, sweep_args, x_ss, x_cli,
                                         smooth, v, c32, c64, swapped, kw)
    timing = {"k1_ms": cuda_ms(lambda: fused_sweep_jvp(*args, *c32, **kw), 20),
              "k1_previous_ms": cuda_ms(lambda: previous_kernel1((*args, *c32), kw), 20),
              "k2_ms": k2_turns["k2"], "k2_previous_ms": k2_turns["k2_previous"],
              "k1_plain_ms": cuda_once(lambda: fused_sweep_jvp_reference(*args, *c32, **kw))[1],
              "k2_plain_ms": cuda_once(
                  lambda: fused_residual_sweep_reference(*args64, *c64, **kw))[1],
              "jvp_f64_ms": cuda_ms(lambda: fused_sweep_jvp_f64(*jvp64_args, *c64, **kw), 10)}
    emit("driver_kernels", model=name, k1_max_abs_err=k1_err, k2_max_abs_err=k2_err,
         k1_vs_previous_bit_identical=bits, k2_vs_previous_bit_identical=bits2, **timing)

    # Three timed `solve_model` calls, counts zeroed right before them.
    fused_sweep_jvp.launches = fused_residual_sweep.launches = 0
    fused_sweep_jvp_reference.calls = fused_residual_sweep_reference.calls = 0
    zero_previous_launches()
    runs, solve_s, xs = [], [], []
    for _ in range(3):
        recs = []
        t0 = time.perf_counter()
        x_path, info, _, _ = run.solve_model(model, method="newton_krylov",
                                             direction_dtype=f32, eps=1e-8,
                                             verbose=False, records=recs)
        runs.append(time.perf_counter() - t0)
        solve_s.append(next(r["seconds"] for r in recs if r.get("phase") == "path solve"))
        xs.append(x_path)
    launches = {"k1": fused_sweep_jvp.launches, "k2": fused_residual_sweep.launches}
    plain_calls = {"k1": fused_sweep_jvp_reference.calls,
                   "k2": fused_residual_sweep_reference.calls}
    require(launches["k1"] > 0 and launches["k2"] > 0,
            f"{name}: a kernel of the driver's path never launched: {launches}")
    require(plain_calls["k1"] == 0 and plain_calls["k2"] == 0,
            f"{name}: a plain version ran on the driver's path: {plain_calls}")
    previous = previous_launches()
    require(not any(previous.values()),
            f"{name}: a previous kernel ran on the driver's path: {previous}")
    x_sol = torch.as_tensor(xs[0].reshape(-1), dtype=f64, device=dev)
    require(all(np.array_equal(xs[0], xi) for xi in xs[1:]) and torch.equal(x_sol, x_cli),
            f"{name}: repeated solves returned different paths")
    require(bool(torch.isfinite(x_sol).all()) and x_sol.shape == x_ss.shape,
            f"{name}: the solution is not a finite path of the expected shape")
    F_plain = make_full_residual_fn(model, ss0, ssT, exog)
    fnorm_plain = float(torch.linalg.norm(F_plain(x_sol)))
    require(fnorm_plain < 1e-8, f"{name}: plain f64 ‖F‖ is {fnorm_plain:.3e}")
    vs_jax = max_abs(x_sol, x_jax)
    require(vs_jax <= 1e-7, f"{name}: path {vs_jax:.3e} off the JAX reference")

    # The economics the JAX package's tests hold its solution to.
    path = xs[0]
    if name == "hank_one_asset":
        pi_dev = path[:, endog.index("pi")] - float(ssT.vars["pi"])
        r_gap = float(np.max(np.abs(path[:, endog.index("r")] - float(ssT.vars["r"]))))
        predicted = -0.002 * 0.6 / ((1 + float(ssT.vars["r"])) - model.params["phi_pi"])
        econ = {"r_path_vs_ss": r_gap, "pi_dev_impact": float(pi_dev[0]),
                "pi_dev_2": float(pi_dev[1]), "pi_dev_2_predicted": predicted}
        require(r_gap < 1e-6 and abs(pi_dev[0]) < 1e-6
                and abs(pi_dev[1] - predicted) < 0.2 * abs(predicted)
                and abs(pi_dev[-1]) < 0.05 * np.max(np.abs(pi_dev)),
                f"{name}: the monetary-shock path fails the reference's economics: {econ}")
    else:
        y0, r_max = float(path[0, endog.index("Y")]), float(path[:, endog.index("r")].max())
        econ = {"Y_impact": y0, "Y_ss": float(ssT.vars["Y"]), "r_max": r_max,
                "r_ss": float(ssT.vars["r"])}
        require(y0 < 0.95 * float(ssT.vars["Y"]) and r_max > float(ssT.vars["r"]),
                f"{name}: the ZLB path fails the reference's economics: {econ}")
    emit("driver_solve", model=name, cli_summary=summary, median_s=statistics.median(runs),
         runs_s=runs, path_solve_s=solve_s, outer_iterations=info["iterations"],
         residual_norm=info["residual_norm"], residual_norm_plain_f64=fnorm_plain,
         max_abs_vs_jax=vs_jax, launches=launches, plain_calls=plain_calls,
         previous_kernel_launches=previous, k1_launches_per_solve=launches["k1"] / 3, k2_launches_per_solve=launches["k2"] / 3,
         bit_identical=True, economics=econ)
    return {"model": model, "ss0": ss0, "ssT": ssT, "exog": exog, "x": x_sol, "cli": cli,
            "x_jax": x_jax, "k1_ms": timing["k1_ms"], "k1_previous_ms": timing["k1_previous_ms"],
            "k2_ms": timing["k2_ms"], "k2_previous_ms": timing["k2_previous_ms"],
            "jvp_f64_ms": timing["jvp_f64_ms"], "global_500": global_500}


def global_state_at_500(bit_inputs, bit_inputs64, sweep_args, x_ss, x_sol, smooth, v,
                        c32, c64, swapped, kw) -> dict:
    """Phase 8 at large-grid KS 500×7: each global-state instantiation
    against its one-block kernel, bit for bit on every output and fallback
    count at phase 8's points (x_ss, the solution, the smooth point; and
    the swapped grid for kernel 2 and the f64 tangent sweep), the batched
    ones on 16 rows of those points and on the swapped grid; then both
    timed in turns (one-block, global, global, one-block), the single-path
    ones at the solution: the price of global memory at a grid both take.
    The five cluster instantiations the same way against kernel 1, the f64
    tangent sweep, kernel 2 and the batched kernels (keys "k1_cluster",
    "jvp_f64_cluster", "k2_cluster", "k3_4_cluster_B16",
    "k2_batch_cluster_B16"); the batched f64 tangent sweep's global-state
    instantiation against its cluster one and that one against its
    one-block kernel ("jvp_f64_batch_B16", "jvp_f64_batch_cluster_B16").
    Returns {kernel: {"ms": ..., "ms_one_block": ...}}."""
    import torch

    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                                   fused_residual_sweep_batch,
                                                   fused_residual_sweep_batch_cluster,
                                                   fused_residual_sweep_batch_global,
                                                   fused_residual_sweep_cluster,
                                                   fused_residual_sweep_global)
    from hank_tpu_torch.ops.fused_sweep import (fused_sweep_jvp, fused_sweep_jvp_cluster,
                                                fused_sweep_jvp_f64, fused_sweep_jvp_f64_cluster,
                                                fused_sweep_jvp_f64_global,
                                                fused_sweep_jvp_global)
    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
                                                      fused_sweep_jvp_batch_cluster,
                                                      fused_sweep_jvp_batch_global,
                                                      fused_sweep_jvp_f64_batch,
                                                      fused_sweep_jvp_f64_batch_cluster,
                                                      fused_sweep_jvp_f64_batch_global)

    f32, f64 = torch.float32, torch.float64
    jvp64_inputs = {label: (*sweep_args(x, v, f64), *c64) for label, x in
                    (("x_ss", x_ss), ("solution", x_sol), ("smooth", smooth))}
    jvp64_inputs["grid_swapped"] = (*jvp64_inputs["x_ss"][:6], swapped,
                                    *jvp64_inputs["x_ss"][7:])
    bits = {"k1": bits_vs("kernel 1 on global state", fused_sweep_jvp_global, fused_sweep_jvp,
                          bit_inputs, kw),
            "k2": bits_vs("kernel 2 on global state", fused_residual_sweep_global,
                          fused_residual_sweep, bit_inputs64, kw),
            "jvp_f64": bits_vs("f64 tangent sweep on global state", fused_sweep_jvp_f64_global,
                               fused_sweep_jvp_f64, jvp64_inputs, kw)}
    require(sum(fallback_sum(bits["k2"], ["grid_swapped"])) > 0
            and sum(fallback_sum(bits["jvp_f64"], ["grid_swapped"])) > 0,
            f"500x7: the swapped grid took no fallback branch on global state: {bits}")
    bits["k1_cluster"] = bits_vs("kernel 1 on a cluster", fused_sweep_jvp_cluster,
                                 fused_sweep_jvp, bit_inputs, kw)
    bits["jvp_f64_cluster"] = bits_vs("f64 tangent sweep on a cluster",
                                      fused_sweep_jvp_f64_cluster, fused_sweep_jvp_f64,
                                      jvp64_inputs, kw)
    bits["k2_cluster"] = bits_vs("kernel 2 on a cluster", fused_residual_sweep_cluster,
                                 fused_residual_sweep, bit_inputs64, kw)
    require(sum(fallback_sum(bits["jvp_f64_cluster"], ["grid_swapped"])) > 0
            and sum(fallback_sum(bits["k2_cluster"], ["grid_swapped"])) > 0,
            f"500x7: the swapped grid took no fallback branch on a cluster: {bits}")
    a32 = (*sweep_args(x_sol, v, f32), *c32)
    a64 = (*sweep_args(x_sol, v, f64), *c64)
    # 16 rows cycling through the three points, for the batched ones: bit
    # for bit their one-block kernels on the grid and on the swapped grid.
    rows = [(x_ss, x_sol, smooth)[b % 3] for b in range(16)]
    r32 = [torch.stack(p) for p in zip(*(sweep_args(x, v, f32) for x in rows))]
    r64 = [torch.stack(p) for p in zip(*(sweep_args(x, v, f64)[:2] for x in rows))]
    b32, b64 = (*r32, *c32), (*r64, *c64)
    bits["k3_4_B16"] = bits_vs(
        "kernels 3-4 on global state", fused_sweep_jvp_batch_global, fused_sweep_jvp_batch,
        {"points": b32, "grid_swapped": (*r32, *c32[:2], swapped.float(), *c32[3:])}, kw,
        batch=16)
    bits["k2_batch_B16"] = bits_vs(
        "batched kernel 2 on global state", fused_residual_sweep_batch_global,
        fused_residual_sweep_batch,
        {"points": b64, "grid_swapped": (*r64, *c64[:2], swapped, *c64[3:])}, kw, batch=16)
    bits["k3_4_cluster_B16"] = bits_vs(
        "kernels 3-4 on a cluster", fused_sweep_jvp_batch_cluster, fused_sweep_jvp_batch,
        {"points": b32, "grid_swapped": (*r32, *c32[:2], swapped.float(), *c32[3:])}, kw,
        batch=16)
    bits["k2_batch_cluster_B16"] = bits_vs(
        "batched kernel 2 on a cluster", fused_residual_sweep_batch_cluster,
        fused_residual_sweep_batch,
        {"points": b64, "grid_swapped": (*r64, *c64[:2], swapped, *c64[3:])}, kw, batch=16)
    # The batched f64 tangent sweep's global-state instantiation, on no
    # solver's path at this grid or at 1200×7, bit for bit its cluster one;
    # the cluster one bit for bit the one-block kernel.
    r64j = [torch.stack(p) for p in zip(*(sweep_args(x, v, f64) for x in rows))]
    b64j = (*r64j, *c64)
    f64_inputs = {"points": b64j, "grid_swapped": (*r64j, *c64[:2], swapped, *c64[3:])}
    bits["jvp_f64_batch_B16"] = bits_vs(
        "batched f64 tangent sweep on global state", fused_sweep_jvp_f64_batch_global,
        fused_sweep_jvp_f64_batch_cluster, f64_inputs, kw, batch=16)
    bits["jvp_f64_batch_cluster_B16"] = bits_vs(
        "batched f64 tangent sweep on a cluster", fused_sweep_jvp_f64_batch_cluster,
        fused_sweep_jvp_f64_batch, f64_inputs, kw, batch=16)
    require(sum(fallback_sum(bits["jvp_f64_batch_B16"], ["grid_swapped"])) > 0,
            f"500x7: the swapped grid took no fallback branch: {bits['jvp_f64_batch_B16']}")
    pairs = {
        "k1": (lambda: fused_sweep_jvp(*a32, **kw),
               lambda: fused_sweep_jvp_global(*a32, **kw)),
        "k2": (lambda: fused_residual_sweep(*a64[:2], *c64, **kw),
               lambda: fused_residual_sweep_global(*a64[:2], *c64, **kw)),
        "jvp_f64": (lambda: fused_sweep_jvp_f64(*a64, **kw),
                    lambda: fused_sweep_jvp_f64_global(*a64, **kw)),
        "k1_cluster": (lambda: fused_sweep_jvp(*a32, **kw),
                       lambda: fused_sweep_jvp_cluster(*a32, **kw)),
        "jvp_f64_cluster": (lambda: fused_sweep_jvp_f64(*a64, **kw),
                            lambda: fused_sweep_jvp_f64_cluster(*a64, **kw)),
        "k2_cluster": (lambda: fused_residual_sweep(*a64[:2], *c64, **kw),
                       lambda: fused_residual_sweep_cluster(*a64[:2], *c64, **kw)),
        "k3_4_B16": (lambda: fused_sweep_jvp_batch(*b32, **kw),
                     lambda: fused_sweep_jvp_batch_global(*b32, **kw)),
        "k2_batch_B16": (lambda: fused_residual_sweep_batch(*b64, **kw),
                         lambda: fused_residual_sweep_batch_global(*b64, **kw)),
        "k3_4_cluster_B16": (lambda: fused_sweep_jvp_batch(*b32, **kw),
                             lambda: fused_sweep_jvp_batch_cluster(*b32, **kw)),
        "k2_batch_cluster_B16": (lambda: fused_residual_sweep_batch(*b64, **kw),
                                 lambda: fused_residual_sweep_batch_cluster(*b64, **kw)),
        "jvp_f64_batch_B16": (lambda: fused_sweep_jvp_f64_batch(*b64j, **kw),
                              lambda: fused_sweep_jvp_f64_batch_global(*b64j, **kw)),
        "jvp_f64_batch_cluster_B16": (lambda: fused_sweep_jvp_f64_batch(*b64j, **kw),
                                      lambda: fused_sweep_jvp_f64_batch_cluster(*b64j, **kw))}
    timing = {}
    for key, (one_block, glob) in pairs.items():
        turns = in_turns({"one_block": one_block, "global": glob}, 10)
        timing[key] = {"ms": turns["global"], "ms_one_block": turns["one_block"]}
    emit("global_state_500", grid=list(c64[0].shape), bit_identical=bits, ms=timing)
    return timing


# Past every one-block one-asset kernel's shared memory at n_e = 7 (the
# f64 tangent sweep takes n_a ≤ 529, kernel 2 ≤ 1036, kernel 1 ≤ 1147,
# kernels 3-4 ≤ 1148): large-grid KS with 1200 wealth knots at its published
# horizon, and the JAX package's CPU root of it
# (`tests/test_torch_large_grid.py::jax_cpu_root_large_grid`).
LARGE_GRID_CASE = ("ks_large_grid", 1200, 150)
LARGE_GRID_REFERENCE = os.path.join(os.path.dirname(TWO_ASSET_REFERENCE),
                                    "ks_large_grid_1200x7_T150_jax_cpu.npz")


def one_asset_wrappers() -> dict:
    """The five one-asset sweep wrappers that launch the ranged kernel or
    kernel 1, by key, with their plain versions."""
    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                                   fused_residual_sweep_batch,
                                                   fused_residual_sweep_batch_reference,
                                                   fused_residual_sweep_reference)
    from hank_tpu_torch.ops.fused_sweep import (fused_sweep_jvp, fused_sweep_jvp_f64,
                                                fused_sweep_jvp_reference)
    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
                                                      fused_sweep_jvp_batch_reference)

    return {"k1": (fused_sweep_jvp, fused_sweep_jvp_reference),
            "jvp_f64": (fused_sweep_jvp_f64, fused_sweep_jvp_reference),
            "k2": (fused_residual_sweep, fused_residual_sweep_reference),
            "k3_4": (fused_sweep_jvp_batch, fused_sweep_jvp_batch_reference),
            "k2_batch": (fused_residual_sweep_batch, fused_residual_sweep_batch_reference)}


def zero_one_asset_counts() -> None:
    """Every counter of the one-asset routes: kernel launches (one-block,
    cluster and global-state), plain-version calls, AD directions and the
    previous kernels."""
    from hank_tpu_torch.solvers.newton import ad_direction

    for fn, plain in one_asset_wrappers().values():
        fn.launches = fn.launches_global = plain.calls = 0
        if hasattr(fn, "launches_cluster"):
            fn.launches_cluster = 0
    ad_direction.calls = 0
    zero_previous_launches()


def one_asset_counts() -> dict:
    from hank_tpu_torch.solvers.newton import ad_direction

    wrappers = one_asset_wrappers()
    return {**{k: fn.launches for k, (fn, _) in wrappers.items()},
            **{f"{k}_cluster": fn.launches_cluster for k, (fn, _) in wrappers.items()
               if hasattr(fn, "launches_cluster")},
            **{f"{k}_global": fn.launches_global for k, (fn, _) in wrappers.items()},
            "ad_directions": ad_direction.calls,
            "plain_calls": sum({id(p): p.calls for _, p in wrappers.values()}.values()),
            "previous": sum(previous_launches().values())}


def require_only(counts: dict, launched: set, path: str) -> None:
    """On `path` the kernels `launched` (keys of `one_asset_counts`) ran and
    no other counter moved: no other one-asset kernel, no plain version, no
    AD direction, no previous kernel."""
    ran = {k for k, n in counts.items() if n}
    require(ran == launched, f"{path}: the counters that moved are {sorted(ran)}, not "
                             f"{sorted(launched)}: {counts}")


def cli_default(name: str, case: dict) -> dict:
    """The CLI's default on one model (without --mixed: f64
    directions through the f64 tangent sweep, kernel-2 residuals), counters
    zeroed right before. Returns the counts of that run."""
    import torch

    from hank_tpu_torch.solvers.newton import make_full_residual_fn

    zero_one_asset_counts()
    t0 = time.perf_counter()
    summary, x64 = case["cli"]([])
    seconds = time.perf_counter() - t0
    counts = one_asset_counts()
    require(counts["jvp_f64"] > 0 and counts["k2"] > 0 and counts["ad_directions"] == 0
            and counts["k1"] == 0 and counts["plain_calls"] == 0 and counts["previous"] == 0,
            f"{name}: the CLI's default did not run through the f64 tangent sweep "
            f"and kernel 2 alone: {counts}")
    F_plain = make_full_residual_fn(case["model"], case["ss0"], case["ssT"], case["exog"])
    fnorm = float(torch.linalg.norm(F_plain(x64)))
    vs_jax = max_abs(x64, case["x_jax"])
    require(summary["residual_norm"] < 1e-8 and fnorm < 1e-8 and vs_jax <= 1e-7,
            f"{name}: f64-direction solve: ‖F‖ {summary['residual_norm']:.3e}, plain f64 "
            f"{fnorm:.3e}, {vs_jax:.3e} off the JAX reference")
    emit("driver_f64_directions", model=name, T=case["model"].compspec.T, seconds=seconds,
         cli_summary=summary, outer_iterations=summary["iterations"],
         directions=counts["jvp_f64"], residual_norm_plain_f64=fnorm, max_abs_vs_jax=vs_jax,
         max_abs_vs_mixed=max_abs(x64, case["x"]), launches=counts)
    return counts


def large_grid_case(dev) -> dict:
    """Phase 8 at `LARGE_GRID_CASE` (large-grid KS 1200×7, T=150), past
    every one-block kernel's shared memory (see the module docstring).
    Emits its JSON lines and returns the rows and launches of the five
    cluster and five global-state instantiations."""
    import dataclasses

    import numpy as np
    import torch

    from hank_tpu_torch import run
    from hank_tpu_torch.model.grids import make_double_exponential_grid
    from hank_tpu_torch.model.structures import generate_exog_paths
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.ops import cuda_build as cb
    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                                   fused_residual_sweep_batch,
                                                   fused_residual_sweep_batch_cluster,
                                                   fused_residual_sweep_batch_global,
                                                   fused_residual_sweep_batch_reference,
                                                   fused_residual_sweep_cluster,
                                                   fused_residual_sweep_global,
                                                   fused_residual_sweep_reference)
    from hank_tpu_torch.ops.fused_sweep import (KERNEL_NAMES, fused_sweep_jvp,
                                                fused_sweep_jvp_cluster, fused_sweep_jvp_f64,
                                                fused_sweep_jvp_f64_cluster,
                                                fused_sweep_jvp_f64_global,
                                                fused_sweep_jvp_global, fused_sweep_jvp_reference,
                                                state_workspace_bytes, sweep_batch_cluster,
                                                sweep_setup)
    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
                                                      fused_sweep_jvp_batch_cluster,
                                                      fused_sweep_jvp_batch_global,
                                                      fused_sweep_jvp_batch_reference,
                                                      fused_sweep_jvp_f64_batch,
                                                      fused_sweep_jvp_f64_batch_cluster,
                                                      fused_sweep_jvp_f64_batch_global,
                                                      fused_sweep_jvp_f64_batch_reference)
    from hank_tpu_torch.parallel.ensemble import solve_ensemble_host
    from hank_tpu_torch.solvers.newton import make_full_residual_fn, make_path_solver
    from hank_tpu_torch.utils.checkpoint import get_or_solve

    f32, f64 = torch.float32, torch.float64
    name, n_a, T = LARGE_GRID_CASE
    model = load_model(name, T=T, device=dev)
    wealth = model.endog_dims()[0]
    grid = torch.tensor(make_double_exponential_grid(0.0, 200.0, n_a), dtype=f64, device=dev)
    model = dataclasses.replace(model, heterogeneity={
        **model.heterogeneity, wealth.name: dataclasses.replace(wealth, n=n_a, grid=grid)})
    n_e = model.exog_dims()[0].n
    cs = model.compspec
    Tm1, nE = T - 1, cs.n_endog
    endog = model.vars_of_type("endogenous")

    # Setup into the fresh cache, and the kernel each map decides on.
    t0 = time.perf_counter()
    ss0, ssT, Jbar = get_or_solve(model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    F_ss = steady_residual(model, ssT)
    require(F_ss <= 1e-9, f"{n_a}x{n_e}: steady state residual {F_ss:.3e} > 1e-9")
    with np.load(LARGE_GRID_REFERENCE) as z:
        ref_vars = dict(zip([str(v) for v in z["var_names"]], z["var_values"]))
        x_jax = torch.as_tensor(z["x"], dtype=f64, device=dev)
    ss_gap = max(abs(float(ssT.vars[k]) - float(v)) for k, v in ref_vars.items())
    require(ss_gap <= 1e-8, f"{n_a}x{n_e}: steady state {ss_gap:.3e} off the JAX reference")
    decided = {KERNEL_NAMES[w]: sweep_setup(model, ss0, ssT, dtype, w).kernel
               for w, dtype in ((cb.KERNEL1, f32), (cb.KERNELS3_4, f32), (cb.KERNEL2, f64),
                                (cb.JVP_F64, f64), (cb.JVP_F64_BATCH, f64))}
    require(set(decided.values()) == set(cb.CLUSTER.values()),
            f"{n_a}x{n_e}: the maps decided on {decided}")
    emit("large_grid_setup", model=name, grid=[n_a, n_e], T=T, seconds=setup_s,
         max_abs_F_ss=F_ss, max_abs_vs_jax_ss=ss_gap,
         kernels_decided={k: KERNEL_NAMES[w] for k, w in decided.items()},
         smem_bytes={KERNEL_NAMES[w]: cb.sweep_smem_bytes(w, n_a, n_e)
                     for w in (*cb.GLOBAL_STATE, *cb.GLOBAL_STATE.values(),
                               *cb.CLUSTER.values())},
         **{k: float(ssT.vars[k]) for k in endog})

    exog = generate_exog_paths(model, Tm1)
    x_ss = torch.stack([torch.as_tensor(ssT.vars[k]) for k in endog]).repeat(Tm1)
    F_plain = make_full_residual_fn(model, ss0, ssT, exog)
    modes = {"default": None, "mixed": f32}

    def solve(mode):
        recs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_path, info, _, _ = run.solve_model(model, method="newton_krylov",
                                             direction_dtype=modes[mode], eps=1e-8,
                                             verbose=False, records=recs)
        seconds = time.perf_counter() - t0
        x = torch.as_tensor(x_path.reshape(-1), dtype=f64, device=dev)
        return x, info, seconds, next(r["seconds"] for r in recs
                                      if r.get("phase") == "path solve")

    warm = {mode: solve(mode) for mode in modes}

    # Each single-path cluster and global-state instantiation against its
    # plain version at x_ss, the default's solution and a smooth seeded
    # point, along smooth seeded directions, at phase 4's bounds (the f32
    # ones' plain version in float64 on the same f32 inputs), each cluster
    # one bit for bit the global-state one there; a zero tangent exactly
    # zero.
    hook, c32, kw, _, _ = sweep_setup(model, ss0, ssT, f32)
    c64 = [c.double() for c in c32]
    gen = torch.Generator().manual_seed(12)
    decay = (0.9 ** torch.arange(Tm1, dtype=f64))[:, None]

    def sweep_args(x, v, dtype):
        (r, s_), (dr, ds) = torch.func.jvp(
            lambda xx: hook(xx.reshape(Tm1, nE), exog, model), (x,), (v,))
        return [t.to(dtype).contiguous() for t in (r, s_, dr, ds)]

    smooth = x_ss + (1e-3 * torch.randn(nE, generator=gen, dtype=f64)
                     * decay).reshape(-1).to(dev)
    err = {"k1": 0.0, "k1_global": 0.0, "k2": 0.0, "k2_global": 0.0, "jvp_f64": 0.0,
           "jvp_f64_global": 0.0}
    plain_ms = {}
    cluster_inputs = {"k1": {}, "jvp_f64": {}, "k2": {}}
    for label, x in (("x_ss", x_ss), ("solution", warm["default"][0]), ("smooth", smooth)):
        v = (torch.randn(nE, generator=gen, dtype=f64) * decay).reshape(-1).to(dev)
        a32, a64 = sweep_args(x, v, f32), sweep_args(x, v, f64)
        cluster_inputs["k1"][label] = (*a32, *c32)
        cluster_inputs["jvp_f64"][label] = (*a64, *c64)
        cluster_inputs["k2"][label] = (*a64[:2], *c64)
        ref, plain_ms["k1"] = cuda_once(lambda: fused_sweep_jvp_reference(
            *(a.double() for a in a32), *c64, **kw))
        plain_ms["k1_global"] = plain_ms["k1"]
        for key, fn in (("k1", fused_sweep_jvp), ("k1_global", fused_sweep_jvp_global)):
            for o, r_ in zip(fn(*a32, *c32, **kw), ref):
                e, scale = max_abs(o.double(), r_), float(r_.abs().max())
                require(e <= 3e-5 * max(scale, 1.0),
                        f"{n_a}x{n_e} at {label}: {fn.__name__} off its plain version by "
                        f"{e:.3e} (scale {scale:.3e})")
                err[key] = max(err[key], e)
        ref, plain_ms["jvp_f64"] = cuda_once(lambda: fused_sweep_jvp_reference(*a64, *c64, **kw))
        plain_ms["jvp_f64_global"] = plain_ms["jvp_f64"]
        for key, fn in (("jvp_f64", fused_sweep_jvp_f64),
                        ("jvp_f64_global", fused_sweep_jvp_f64_global)):
            for o, r_ in zip(fn(*a64, *c64, **kw), ref):
                e, scale = max_abs(o, r_), float(r_.abs().max())
                require(e <= 1e-10 * max(scale, 1.0),
                        f"{n_a}x{n_e} at {label}: {fn.__name__} off its plain version by "
                        f"{e:.3e} (scale {scale:.3e})")
                err[key] = max(err[key], e)
        ref, plain_ms["k2"] = cuda_once(lambda: fused_residual_sweep_reference(
            *a64[:2], *c64, **kw))
        plain_ms["k2_global"] = plain_ms["k2"]
        for key, fn in (("k2", fused_residual_sweep), ("k2_global", fused_residual_sweep_global)):
            err[key] = max(err[key], *(max_abs(o, r_) for o, r_ in zip(
                fn(*a64[:2], *c64, **kw), ref)))
    require(err["k2"] <= 1e-11 and err["k2_global"] <= 1e-11,
            f"{n_a}x{n_e}: an f64 residual sweep off its plain version by {err}")
    zero32, zero64 = torch.zeros(Tm1, dtype=f32, device=dev), torch.zeros(Tm1, dtype=f64,
                                                                         device=dev)
    out32 = fused_sweep_jvp(*a32[:2], zero32, zero32, *c32, **kw)
    out64 = fused_sweep_jvp_f64(*a64[:2], zero64, zero64, *c64, **kw)
    require(all(bool((o[i] == 0).all()) for o in (out32, out64) for i in (1, 3)),
            f"{n_a}x{n_e}: a zero tangent did not give exactly zero on a cluster")
    cluster_bits = {
        "k1": bits_vs("kernel 1 on a cluster", fused_sweep_jvp_cluster, fused_sweep_jvp_global,
                      cluster_inputs["k1"], kw),
        "jvp_f64": bits_vs("f64 tangent sweep on a cluster", fused_sweep_jvp_f64_cluster,
                           fused_sweep_jvp_f64_global, cluster_inputs["jvp_f64"], kw),
        "k2": bits_vs("kernel 2 on a cluster", fused_residual_sweep_cluster,
                      fused_residual_sweep_global, cluster_inputs["k2"], kw)}
    emit("large_grid_cluster", grid=[n_a, n_e], T=T, bit_identical_to_global_state=cluster_bits,
         max_abs_err_vs_plain=err)

    # Three timed runs of each solve, counters zeroed right before each set:
    # only the cluster instantiations of its directions and of kernel 2
    # launched.
    solves = {}
    for mode, launched in (("default", {"jvp_f64_cluster", "k2_cluster"}),
                           ("mixed", {"k1_cluster", "k2_cluster"})):
        zero_one_asset_counts()
        runs = [solve(mode) for _ in range(3)]
        counts = one_asset_counts()
        require_only(counts, launched, f"{n_a}x{n_e} {mode} solve")
        x_sol, info = runs[0][0], runs[0][1]
        require(all(torch.equal(r[0], warm[mode][0]) for r in runs),
                f"{n_a}x{n_e} {mode}: repeated solves returned different paths")
        require(bool(torch.isfinite(x_sol).all()) and x_sol.shape == x_ss.shape,
                f"{n_a}x{n_e} {mode}: the solution is not a finite path of the expected shape")
        fnorm = float(torch.linalg.norm(F_plain(x_sol)))
        vs_jax = max_abs(x_sol, x_jax)
        require(fnorm < 1e-8 and vs_jax <= 1e-7,
                f"{n_a}x{n_e} {mode}: plain f64 ‖F‖ {fnorm:.3e}, {vs_jax:.3e} off the JAX root")
        solves[mode] = {"median_s": statistics.median(r[2] for r in runs),
                        "runs_s": [r[2] for r in runs], "path_solve_s": [r[3] for r in runs],
                        "outer_iterations": info["iterations"],
                        "residual_norm": info["residual_norm"],
                        "residual_norm_plain_f64": fnorm, "max_abs_vs_jax": vs_jax,
                        "launches": counts, "bit_identical": True}
    path = warm["default"][0].reshape(Tm1, nE)
    y0, r_max = float(path[0, endog.index("Y")]), float(path[:, endog.index("r")].max())
    require(y0 < 0.95 * float(ssT.vars["Y"]) and r_max > float(ssT.vars["r"]),
            f"{n_a}x{n_e}: the ZLB path fails the reference's economics: {y0}, {r_max}")
    emit("large_grid_solve", model=name, grid=[n_a, n_e], T=T, solves=solves,
         max_abs_default_vs_mixed=max_abs(warm["default"][0], warm["mixed"][0]))

    # The B=16 ensemble: rows of the model's own kinked shock at ρ_b = 0.75 +
    # 0.2·b/16 (the floor binds on every row), Newton-Krylov with f32
    # directions through the batched cluster instantiations.
    B = 16
    rhos = [0.75 + 0.2 * b / B for b in range(B)]
    exog_b = {"Z": torch.stack([generate_exog_paths(model, Tm1, rho=r)["Z"] for r in rhos])}
    require(all(bool((exog_b["Z"][b] <= 0.88 + 1e-15).any()) for b in range(B)),
            "a row of the ensemble's shocks never reaches the floor")

    def solve_b():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_b, info_b = solve_ensemble_host(x_ss, Jbar, exog_b, model, ss0, ssT, eps=1e-8,
                                          method="newton_krylov", direction_dtype=f32)
        torch.cuda.synchronize()
        return x_b, info_b, time.perf_counter() - t0

    x_warm_b, _, _ = solve_b()
    i_r, i_w = endog.index("r"), endog.index("w")

    def prices(x_b, dtype):
        xp = x_b.reshape(x_b.shape[0], Tm1, nE)
        return xp[:, :, i_r].to(dtype).contiguous(), xp[:, :, i_w].to(dtype).contiguous()

    # The batched instantiations at the warm-up's rows and on the grid with
    # two knots swapped: the cluster ones (the wrappers' route, on the
    # cluster size the rule takes at B) bit for bit the global-state ones on
    # every row and fallback count, every row bit for bit a single-path
    # launch of the cluster instantiation (and of the global-state one),
    # rows 0 and B-1 of both within phase 4's bounds of the plain versions.
    v_b = (torch.randn((B, 1, nE), generator=gen, dtype=f64) * decay[None]).reshape(B, -1)
    paths32 = (*prices(x_warm_b, f32), *prices(v_b.to(dev), f32))
    paths64 = prices(x_warm_b, f64)
    k_sw = n_a // 2
    swapped = c64[2].clone()
    swapped[[k_sw, k_sw + 1]] = swapped[[k_sw + 1, k_sw]]
    batch_bits = {
        "k3_4": bits_vs("kernels 3-4 on a cluster", fused_sweep_jvp_batch_cluster,
                        fused_sweep_jvp_batch_global,
                        {"warm_rows": (*paths32, *c32),
                         "grid_swapped": (*paths32, *c32[:2], swapped.float(), *c32[3:])},
                        kw, batch=B),
        "k2_batch": bits_vs("batched kernel 2 on a cluster", fused_residual_sweep_batch_cluster,
                            fused_residual_sweep_batch_global,
                            {"warm_rows": (*paths64, *c64),
                             "grid_swapped": (*paths64, *c64[:2], swapped, *c64[3:])},
                            kw, batch=B)}
    require(all(sum(fallback_sum(r, ["grid_swapped"])) > 0 for r in batch_bits.values()),
            f"{n_a}x{n_e}: the swapped grid took no fallback branch: {batch_bits}")
    out_b = fused_sweep_jvp_batch(*paths32, *c32, **kw)
    out_b64 = fused_residual_sweep_batch(*paths64, *c64, **kw)
    out_bg = fused_sweep_jvp_batch_global(*paths32, *c32, **kw)
    out_bg64 = fused_residual_sweep_batch_global(*paths64, *c64, **kw)
    for b in range(B):
        rows = ((fused_sweep_jvp_cluster, fused_sweep_jvp_global, paths32, c32, out_b, out_bg),
                (fused_residual_sweep_cluster, fused_residual_sweep_global, paths64, c64,
                 out_b64, out_bg64))
        for cluster_fn, global_fn, paths, c, out_c, out_g in rows:
            row = [q[b].contiguous() for q in paths]
            require(all(same_bits(o[b], s_) for o, s_ in zip(out_c, cluster_fn(*row, *c, **kw)))
                    and all(same_bits(o[b], s_)
                            for o, s_ in zip(out_g, global_fn(*row, *c, **kw))),
                    f"{n_a}x{n_e}: batched row {b} differs from its single launch "
                    f"({cluster_fn.__name__})")
    ends = [0, B - 1]
    ref, plain_ms["k3_4"] = cuda_once(lambda: fused_sweep_jvp_batch_reference(
        *(q[ends].double() for q in paths32), *c64, **kw))
    plain_ms["k3_4_global"] = plain_ms["k3_4"]
    for key, out in (("k3_4", out_b), ("k3_4_global", out_bg)):
        err[key] = 0.0
        for o, r_ in zip(out, ref):
            e, scale = max_abs(o[ends].double(), r_), float(r_.abs().max())
            require(e <= 3e-5 * max(scale, 1.0),
                    f"{n_a}x{n_e}: the batched f32 tangent sweep ({key}) off its plain "
                    f"version by {e:.3e} (scale {scale:.3e})")
            err[key] = max(err[key], e)
    ref, plain_ms["k2_batch"] = cuda_once(lambda: fused_residual_sweep_batch_reference(
        *(q[ends].contiguous() for q in paths64), *c64, **kw))
    plain_ms["k2_batch_global"] = plain_ms["k2_batch"]
    for key, out in (("k2_batch", out_b64), ("k2_batch_global", out_bg64)):
        err[key] = max(max_abs(o[ends], r_) for o, r_ in zip(out, ref))
        require(err[key] <= 1e-11,
                f"{n_a}x{n_e}: the batched f64 residual sweep ({key}) off its plain version "
                f"by {err[key]:.3e}")
    emit("large_grid_cluster_batch", B=B, cluster=sweep_batch_cluster(cb.CLUSTER_KERNELS3_4, B,
                                                                      n_a, n_e),
         cluster_k2_batch=sweep_batch_cluster(cb.CLUSTER_KERNEL2, B, n_a, n_e),
         bit_identical_to_global_state=batch_bits, rows_bit_identical_to_single=True)

    zero_one_asset_counts()
    runs_b = [solve_b() for _ in range(3)]
    counts_b = one_asset_counts()
    require_only(counts_b, {"k3_4_cluster", "k2_batch_cluster"}, f"{n_a}x{n_e} B={B} ensemble")
    require(all(torch.equal(r[0], x_warm_b) for r in runs_b),
            f"{n_a}x{n_e}: repeated ensemble solves returned different paths")
    info_b = runs_b[0][1]
    fn = info_b["residual_norm"]
    require(bool(torch.isfinite(x_warm_b).all()) and x_warm_b.shape == (B, x_ss.numel()),
            f"{n_a}x{n_e}: the ensemble solution is not finite paths of the expected shape")
    # Every row within 1e-8, or a stalled row that the single-path route
    # (mixed Newton-Krylov on its own shock) does not bring under 1e-8 either.
    stalled = [b for b in range(B) if float(fn[b]) > 1e-8]
    require(len(stalled) == info_b["stalled_paths"] and len(stalled) < B,
            f"{n_a}x{n_e}: rows {stalled} above 1e-8, {info_b['stalled_paths']} stalled paths")
    single_route = {}
    for b in sorted({*stalled, B - 1}):
        x_b, info_1 = make_path_solver(Jbar, {"Z": exog_b["Z"][b]}, model, ss0, ssT,
                                       method="newton_krylov", direction_dtype=f32,
                                       eps=1e-8)(x_ss)
        single_route[b] = {"ensemble_norm": float(fn[b]),
                           "single_path_norm": float(info_1["residual_norm"]),
                           "max_abs": max_abs(x_warm_b[b], x_b)}
        require(b not in stalled or float(info_1["residual_norm"]) > 1e-8,
                f"{n_a}x{n_e}: row {b} stalls in the ensemble at {float(fn[b]):.3e}, but the "
                f"single-path route reaches {float(info_1['residual_norm']):.3e}")
    plain_fn = {}
    for b in sorted({0, B - 1, int(fn.argmax())}):
        F_b = make_full_residual_fn(model, ss0, ssT, {"Z": exog_b["Z"][b]})
        plain_fn[b] = float(torch.linalg.norm(F_b(x_warm_b[b])))
        require(b in stalled or plain_fn[b] < 1e-8,
                f"{n_a}x{n_e}: plain f64 ‖F‖ of row {b} is {plain_fn[b]:.3e}")
    emit("large_grid_ensemble", B=B, rhos=[rhos[0], rhos[-1]],
         median_s=statistics.median(r[2] for r in runs_b), runs_s=[r[2] for r in runs_b],
         outer_iterations=info_b["iterations"], matvecs=info_b["inner_iterations"],
         residual_norm_max=float(fn.max()), residual_norm_plain_f64=plain_fn,
         stalled_rows=stalled, single_path_route=single_route, launches=counts_b,
         host_ls_s=[r[1]["host_ls_seconds"] for r in runs_b], bit_identical=True)

    # f64 directions on the cluster tier: the batched f64 tangent sweep (its
    # cluster instantiation here, as the setup's decisions require) at the
    # warm-up's rows along the smooth
    # directions, cycled to B = 64, every row bit for bit a single launch
    # (the single-path f64 tangent sweep's cluster kernel) at B = 1, 16 and
    # 64; its global-state instantiation bit for bit the cluster one at B
    # and on the swapped grid; row 0 within 1e-10·max(scale, 1) of the
    # plain version; then the f64-direction ensemble solve of the same
    # shocks, held to the f32 ensemble's rows.
    args_j = [*paths64, *prices(v_b.to(dev), f64)]
    idx64 = torch.arange(64, device=dev) % B
    f64_rows = f64_sweep_batch_rows([q[idx64].contiguous() for q in args_j], c64, kw,
                                    (1, 16, 64), template=False)
    f64_global = bits_vs("the batched f64 tangent sweep on global state",
                         fused_sweep_jvp_f64_batch_global, fused_sweep_jvp_f64_batch_cluster,
                         {"warm_rows": (*args_j, *c64),
                          "grid_swapped": (*args_j, *c64[:2], swapped, *c64[3:])}, kw, batch=B)
    require(sum(fallback_sum(f64_global, ["grid_swapped"])) > 0,
            f"{n_a}x{n_e}: the swapped grid took no fallback branch: {f64_global}")
    one = [q[:1].contiguous() for q in args_j]
    ref, plain_ms["jvp_f64_batch"] = cuda_once(lambda: fused_sweep_jvp_f64_batch_reference(
        *one, *c64, **kw))
    plain_ms["jvp_f64_batch_global"] = plain_ms["jvp_f64_batch"]
    for key, fn in (("jvp_f64_batch", fused_sweep_jvp_f64_batch),
                    ("jvp_f64_batch_global", fused_sweep_jvp_f64_batch_global)):
        out = fn(*one, *c64, **kw)
        err[key] = max(max_abs(o, r_) for o, r_ in zip(out, ref))
        scale = max(float(r_.abs().max()) for r_ in ref)
        require(err[key] <= 1e-10 * max(scale, 1.0),
                f"{n_a}x{n_e}: {key} off its plain version by {err[key]:.3e}")
    emit("large_grid_f64_kernels", B=B, rows=f64_rows, global_state_bit_identical=f64_global,
         max_abs_err_vs_plain_row0=err["jvp_f64_batch"], plain_ms_B1=plain_ms["jvp_f64_batch"],
         cluster=sweep_batch_cluster(cb.CLUSTER_JVP_F64_BATCH, B, n_a, n_e))
    f64_solved = one_asset_f64_ensemble("large_grid_f64_ensemble", model, ss0, ssT, Jbar, x_ss,
                                        exog_b, x_warm_b)

    # ms per launch of each instantiation at 1200×7 (the solution; B=16 for
    # the batched ones) and its bound from the timed call's inputs; the
    # cluster ones (the wrappers' route) in turns with the global-state ones
    # (global, cluster, cluster, global).
    a32 = (*sweep_args(warm["mixed"][0], v, f32), *c32)
    a64 = (*sweep_args(warm["default"][0], v, f64), *c64)
    b32, b64 = (*paths32, *c32), (*paths64, *c64)
    pairs = {"k1": (fused_sweep_jvp_global, fused_sweep_jvp, a32, 4, True, "f32", 1),
             "jvp_f64": (fused_sweep_jvp_f64_global, fused_sweep_jvp_f64, a64, 4, True, "f64", 1),
             "k2": (fused_residual_sweep_global, fused_residual_sweep, (*a64[:2], *c64), 2,
                    False, "f64", 1),
             "k3_4": (fused_sweep_jvp_batch_global, fused_sweep_jvp_batch, b32, 4, True, "f32", B),
             "k2_batch": (fused_residual_sweep_batch_global, fused_residual_sweep_batch, b64, 2,
                          False, "f64", B),
             "jvp_f64_batch": (fused_sweep_jvp_f64_batch_global, fused_sweep_jvp_f64_batch,
                               (*args_j, *c64), 4, True, "f64", B)}
    f64_launches = f64_solved["launches_total"]["jvp_f64_batch"]
    launched = {"k1": solves["mixed"]["launches"], "jvp_f64": solves["default"]["launches"],
                "k3_4": counts_b, "k2_batch": counts_b,
                "jvp_f64_batch": {"jvp_f64_batch_cluster": f64_launches["launches_cluster"],
                                  "jvp_f64_batch_global": f64_launches["launches_global"]}}
    rows, launches = {}, {}
    for key, (glob, wrapper, args, n_out, tangent, kind, paths) in pairs.items():
        turns = in_turns({"global": lambda g=glob, a=args: g(*a, **kw),
                          "cluster": lambda w=wrapper, a=args: w(*a, **kw)}, 5)
        bound = least_time(nbytes(*args) + n_out * nbytes(args[0]),
                           one_asset_sweep_ops(Tm1, n_a, n_e, tangent, paths), kind)
        for row, tier in ((key, "cluster"), (f"{key}_global", "global")):
            if key == "k2":       # both solves' residuals, six solves in all
                launches[row] = sum(solves[m]["launches"][f"k2_{tier}"] for m in solves)
            else:
                launches[row] = launched[key][f"{key}_{tier}"]
            rows[row] = {"ms": turns[tier], "plain_ms": plain_ms[row], "max_abs_err": err[row],
                         "launches_per_solve": launches[row] / (6 if key == "k2" else 3),
                         **bound}

    # The batched cluster kernels at B ∈ {1, 16, 64} (rows of the warm-up's,
    # cycled) on the cluster size the rule takes, and at B = 16 and 64 on
    # clusters of 7, 6, 5 and 4 in turns (7, 6, 5, 4, 4, 5, 6, 7), each
    # launch first held bit for bit to the B=16 rows (whose rows are the
    # single-path launches above); the card's max active clusters of each
    # size.
    batched = {}
    for key, fn, args, n_paths, kind, out16 in (
            ("k3_4", fused_sweep_jvp_batch_cluster, b32, 4, cb.CLUSTER_KERNELS3_4, out_b),
            ("k2_batch", fused_residual_sweep_batch_cluster, b64, 2, cb.CLUSTER_KERNEL2,
             out_b64)):
        rec = {"max_active_clusters": {C: cb.max_clusters("household_sweep_cluster", kind, n_a,
                                                          n_e, C) for C in range(7, 2, -1)},
               "by_width": {}, "by_cluster": {}}
        for Bw in (1, 16, 64):
            idx = torch.arange(Bw, device=dev) % B
            args_w = (*(q[idx].contiguous() for q in args[:n_paths]), *args[n_paths:])
            C = sweep_batch_cluster(kind, Bw, n_a, n_e)
            sizes = (C,) if Bw == 1 else (C, 7, 6, 5, 4)
            for size in sizes:
                out = fn(*args_w, **kw, cluster=size)
                require(all(same_bits(o, q[idx]) for o, q in zip(out, out16)),
                        f"{n_a}x{n_e}: {key} at B={Bw} on clusters of {size} differs from "
                        f"its B={B} rows")
            rec["by_width"][Bw] = {"cluster": C, "ms": cuda_ms(lambda: fn(*args_w, **kw), 5)}
            if Bw > 1:
                rec["by_cluster"][Bw] = in_turns(
                    {C: (lambda C=C, a=args_w: fn(*a, **kw, cluster=C)) for C in (7, 6, 5, 4)}, 3)
        batched[key] = rec
    emit("large_grid_kernels", grid=[n_a, n_e], T=T, kernels=rows, batched_cluster=batched,
         workspace_mb={k: state_workspace_bytes(f32 if kind == "f32" else f64, t, n_a, n_e,
                                                p_) / 1e6
                       for k, (_, _, _, _, t, kind, p_) in pairs.items()})
    f64_entries = [
        ensemble_f64_entry(
            f"fused_sweep_jvp_f64_batch ({tier}: {inst})", launches[row], rows[row]["max_abs_err"],
            rows[row]["ms"], rows[row]["plain_ms"],
            {k: rows[row][k] for k in ("bound_ms", "bound_by")}, B=B, plain_ms_at="B=1",
            grid="1200x7, T=150", launches_per_solve=rows[row]["launches_per_solve"],
            **({"cluster": sweep_batch_cluster(cb.CLUSTER_JVP_F64_BATCH, B, n_a, n_e),
                "ms_global": rows["jvp_f64_batch_global"]["ms"],
                **{f"ms_B{Bw}": r["ms"] for Bw, r in f64_rows.items()}} if tier == "cluster"
               else {"main_path": "past the cluster instantiation's count only (at n_e = 7: "
                                  "n_a > 1660), or on a card that holds no such cluster: held "
                                  "through its _global entry point here"}))
        for row, tier, inst in (("jvp_f64_batch", "cluster",
                                 "household_sweep_cluster_kernel<double,true,true>"),
                                ("jvp_f64_batch_global", "global state",
                                 "household_sweep_ranged_kernel<double,true,true,true>"))]
    return {"rows": rows, "launches": launches, "batched": batched, "f64": f64_solved,
            "f64_entries": f64_entries}


def driver_phase(dev) -> dict:
    """Phase 8: `hank_tpu_torch.run` on the two families (module
    docstring), then the CLI's default on each and the grid past every
    one-block kernel's fit. Returns the cases for phase 9 and the summary
    (`"f64_default_launches"`: the f64 tangent sweep's launches in the
    default runs; `"large_grid"`: the 1200×7 case's rows)."""
    cases = {}
    previous = os.environ.get("HANK_TPU_TORCH_CACHE")
    with tempfile.TemporaryDirectory() as cache:
        os.environ["HANK_TPU_TORCH_CACHE"] = cache
        try:
            for name, T in DRIVER_CASES:
                cases[name] = driver_case(name, T, dev, cache)
            launches = sum(cli_default(name, case)["jvp_f64"]
                           for name, case in cases.items())
            large = large_grid_case(dev)
        finally:
            if previous is None:
                os.environ.pop("HANK_TPU_TORCH_CACHE", None)
            else:
                os.environ["HANK_TPU_TORCH_CACHE"] = previous
    return {"cases": cases, "f64_default_launches": launches, "large_grid": large}


def global_state_kernels(large: dict, at_500: dict) -> list:
    """The `kernels` entries of the five global-state instantiations: ms,
    plain ms, error and bound at 1200×7 (B=16 for the batched ones), their
    launches in phase 8's three timed solves of each route (0 there: every
    one of them takes the 1200×7 grid on its cluster instantiation, so each
    is held through its `_global` entry point, `main_path` saying so), and
    at 500×7 their ms beside the one-block kernel's, timed in turns."""
    source = "hank_tpu_torch/csrc/household_sweep.cu"
    specs = (
        ("k1_global", "k1", "fused_sweep_jvp (global state: household_sweep_ranged_kernel"
                            "<float,true,false,true>)", "hank_tpu/ops/fused_sweep.py:385"),
        ("k3_4_global", "k3_4_B16", "fused_sweep_jvp_batch (global state: <float,true,true,true>)",
         "hank_tpu/ops/fused_sweep_batch.py:87 and :177"),
        ("k2_global", "k2", "fused_residual_sweep (global state: <double,false,false,true>)",
         "hank_tpu/ops/fused_ds.py:338"),
        ("k2_batch_global", "k2_batch_B16", "fused_residual_sweep_batch (global state: "
                                            "<double,false,true,true>)",
         "hank_tpu/ops/fused_ds.py:338"),
        ("jvp_f64_global", "jvp_f64",
         "fused_sweep_jvp_f64 (global state: <double,true,false,true>)",
         "hank_tpu/solvers/newton.py:389 (f64 directions by jax.jvp under XLA; no TPU kernel)"))
    entries = []
    for key, key_500, name, replaces in specs:
        row = large["rows"][key]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": large["launches"][key], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "grid": "1200x7, T=150",
            "launches_per_solve": row["launches_per_solve"],
            "ms_500x7": at_500[key_500]["ms"], "ms_one_block_500x7": at_500[key_500]["ms_one_block"],
            "main_path": "past the cluster instantiation's count only (at n_e = 7: n_a > 3597 "
                         "f32 with a tangent, > 1660 f64 with one, > 2694 f64 values only), or "
                         "on a card that holds no such cluster: held through its _global entry "
                         "point here"})
    return entries


def cluster_kernels(large: dict, at_500: dict, at_200: dict) -> list:
    """The `kernels` entries of the five cluster instantiations: ms (in
    turns with the global-state one, `ms_global`), plain ms, error and
    bound at 1200×7 (B=16 for the batched ones, with their ms at B = 1 and
    64 on the cluster the rule takes and at B = 16 and 64 on clusters of 7
    to 4), their launches in phase 8's three timed solves of their route,
    and at 200×7 (B=16) and 500×7 their ms beside the one-block kernel's,
    timed in turns."""
    source = "hank_tpu_torch/csrc/household_sweep_cluster.cu"
    specs = (
        ("k1", "k1_cluster", "fused_sweep_jvp (cluster: household_sweep_cluster_kernel"
                             "<float,true,false>)", "hank_tpu/ops/fused_sweep.py:385"),
        ("jvp_f64", "jvp_f64_cluster", "fused_sweep_jvp_f64 (cluster: "
                                       "household_sweep_cluster_kernel<double,true,false>)",
         "hank_tpu/solvers/newton.py:389 (f64 directions by jax.jvp under XLA; no TPU kernel)"),
        ("k2", "k2_cluster", "fused_residual_sweep (cluster: household_sweep_cluster_kernel"
                             "<double,false,false>)", "hank_tpu/ops/fused_ds.py:338"),
        ("k3_4", "k3_4_cluster_B16", "fused_sweep_jvp_batch (cluster: "
                                     "household_sweep_cluster_kernel<float,true,true>)",
         "hank_tpu/ops/fused_sweep_batch.py:87 and :177"),
        ("k2_batch", "k2_batch_cluster_B16", "fused_residual_sweep_batch (cluster: "
                                             "household_sweep_cluster_kernel<double,false,true>)",
         "hank_tpu/ops/fused_ds.py:338"))
    entries = []
    for key, key_500, name, replaces in specs:
        row = large["rows"][key]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": large["launches"][key], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "grid": "1200x7, T=150",
            "launches_per_solve": row["launches_per_solve"],
            "ms_global": large["rows"][f"{key}_global"]["ms"],
            "ms_200x7": at_200[key]["cluster"], "ms_one_block_200x7": at_200[key]["one_block"],
            "ms_500x7": at_500[key_500]["ms"], "ms_one_block_500x7": at_500[key_500]["ms_one_block"]}
        if key in large["batched"]:
            rec = large["batched"][key]
            entry.update(B=16, cluster=rec["by_width"][16]["cluster"],
                         ms_by_B={Bw: r["ms"] for Bw, r in rec["by_width"].items()},
                         cluster_by_B={Bw: r["cluster"] for Bw, r in rec["by_width"].items()},
                         ms_by_cluster=rec["by_cluster"],
                         max_active_clusters=rec["max_active_clusters"])
        entries.append(entry)
    return entries


def forward_scan_phase(inputs: dict) -> dict:
    """Phase 9: kernel 7 on `inputs` {label: (policies, D0, grid, Pi)} (f32
    on the card), then against the previous kernel 7 on those and on stress
    inputs made from the first; returns its `kernels` entry, timed at the
    first label."""
    import torch

    from hank_tpu_torch.ops.forward_scan import (forward_scan, forward_scan_previous,
                                                 forward_scan_reference)

    # Its path is its own entry point: one call per input, counts zeroed
    # right before.
    forward_scan.launches = forward_scan_reference.calls = 0
    zero_previous_launches()
    outs = {label: forward_scan(*args) for label, args in inputs.items()}
    launches, plain_calls = forward_scan.launches, forward_scan_reference.calls
    require(launches == len(inputs) and plain_calls == 0 and forward_scan_previous.launches == 0,
            f"forward scan: {launches} launches, {plain_calls} plain calls, "
            f"{forward_scan_previous.launches} of the previous kernel")

    checks, err_max = {}, 0.0
    for label, args in inputs.items():
        agg, D_T = outs[label]
        again = forward_scan(*args)
        require(torch.equal(agg, again[0]) and torch.equal(D_T, again[1]),
                f"forward scan at {label}: repeated launches differ")
        ref_agg, ref_D = forward_scan_reference(*(a.double() for a in args))
        e_agg, e_D = max_abs(agg.double(), ref_agg), max_abs(D_T.double(), ref_D)
        scale, mass = float(ref_agg.abs().max()), float(D_T.double().sum())
        require(e_agg <= 5e-5 * max(scale, 1.0) and e_D <= 1e-6 and abs(mass - 1.0) <= 1e-5,
                f"forward scan at {label}: agg off by {e_agg:.3e} (scale {scale:.3e}), "
                f"D_T by {e_D:.3e}, mass {mass:.9f}")
        T, n_a, n_e = args[0].shape
        turns = in_turns({"previous": lambda: forward_scan_previous(*args),
                          "new": lambda: forward_scan(*args)}, 20)
        checks[label] = {"shape": [T, n_a, n_e], "agg_max_abs_err": e_agg, "agg_scale": scale,
                         "D_T_max_abs_err": e_D, "mass_minus_1": mass - 1.0,
                         "ms": turns["new"], "ms_previous": turns["previous"],
                         "plain_ms": cuda_once(lambda: forward_scan_reference(*args))[1],
                         **least_time(nbytes(*args, agg, D_T),
                                      forward_scan_ops(T, n_a, n_e), "f32")}
        err_max = max(err_max, e_agg, e_D)

    # Kernel 7 against the previous kernel 7, bit for bit, at the main
    # path's inputs and at stress inputs on the first one's policies: 1%
    # i.i.d. noise (rows out of order), one NaN policy, and every policy
    # clamped (the lower half of each row below g_0, the upper above g_top).
    first = next(iter(inputs))
    pols, D0, grid, Pi = inputs[first]
    gen = torch.Generator().manual_seed(9)
    noisy = pols * (1.0 + 0.01 * torch.randn(pols.shape, generator=gen)).to(pols.device)
    nan = pols.clone()
    t_nan = int(torch.randint(0, pols.shape[0], (1,), generator=gen))
    nan[t_nan, int(torch.randint(0, pols.shape[1], (1,), generator=gen)),
        int(torch.randint(0, pols.shape[2], (1,), generator=gen))] = float("nan")
    low = torch.arange(pols.shape[1], device=pols.device)[None, :, None] < pols.shape[1] // 2
    clamped = torch.where(low, grid[0] - 1.0, grid[-1] + 1.0).expand(pols.shape).contiguous()
    # And the last input on its grid with every interval halved, past the
    # 4 × 1024 destinations whose ranges kernel 7 keeps in registers.
    halved = halve_grid(*inputs[list(inputs)[-1]])
    require(halved[1].numel() > 4 * 1024, f"halved grid: {tuple(halved[1].shape)}")
    cases = {**inputs, "noise_1pct": (noisy.contiguous(), D0, grid, Pi),
             "one_nan": (nan, D0, grid, Pi), "clamped": (clamped, D0, grid, Pi),
             f"halved_{halved[2].numel()}x{halved[3].shape[0]}": halved}
    bits = {}
    for label, args in cases.items():
        fallback = torch.zeros(1, dtype=torch.int32, device=pols.device)
        new = forward_scan(*args, fallback_rows=fallback)
        old = forward_scan_previous(*args)
        require(all(same_bits(a, b) for a, b in zip(new, old)),
                f"forward scan at {label} differs from the previous kernel 7")
        bits[label] = {"fallback_rows": int(fallback[0]),
                       "nan_periods": torch.nonzero(torch.isnan(new[0])).flatten().tolist()}
    require(bits["noise_1pct"]["fallback_rows"] > 0 and bits["clamped"]["fallback_rows"] == 0
            and bits["one_nan"]["nan_periods"] == [t_nan]
            and all(not bits[k]["nan_periods"] for k in cases if k != "one_nan"),
            f"forward scan: the stress inputs did not take their branches: {bits}")
    emit("forward_scan", launches=launches, plain_calls=plain_calls, checks=checks,
         bit_identical=True, vs_previous_bit_identical=bits)
    c = checks[first]
    return {"name": "forward_scan", "route": "cuda",
            "source": "hank_tpu_torch/csrc/household_sweep.cu",
            "replaces": "hank_tpu/ops/pallas_kernels.py:62", "launches": launches,
            "max_abs_err": err_max, "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": None,
            "ms_previous": c["ms_previous"],
            "fallback_rows": sum(bits[k]["fallback_rows"] for k in inputs),
            **{f"ms_{label}": c["ms"] for label, c in checks.items()},
            **{f"ms_previous_{label}": c["ms_previous"] for label, c in checks.items()}}


def halve_grid(pols, D0, grid, Pi) -> tuple:
    """Kernel 7's input on the grid with every interval halved (2 n_a - 1
    knots): policies, D0 and knots at each midpoint are the means of their
    two neighbours, so rows stay non-decreasing; D0 renormalised."""
    import torch

    def halve(x, dim):
        n = x.shape[dim]
        left, right = x.narrow(dim, 0, n - 1), x.narrow(dim, 1, n - 1)
        pairs = torch.stack((left, 0.5 * (left + right)), dim + 1).flatten(dim, dim + 1)
        return torch.cat((pairs, x.narrow(dim, n - 1, 1)), dim).contiguous()

    D0h = halve(D0, 0)
    return halve(pols, 1), (D0h / D0h.sum()).contiguous(), halve(grid, 0), Pi


def scan_inputs(model, ss0, ssT, exog, x) -> tuple:
    """Kernel 7's inputs at path x: the f32 savings policies of the plain
    backward block, the initial distribution, the grid and Pi."""
    import torch

    from hank_tpu_torch.blocks.backward import backward_iteration

    policy_var = model.endog_dims()[0].policy_var
    pols = backward_iteration(x, exog, model, ssT.vars, ssT.value)[policy_var]
    wealth, prod = model.endog_dims()[0], model.exog_dims()[0]
    return tuple(t.to(torch.float32).contiguous()
                 for t in (pols, ss0.D, wealth.grid, prod.transition))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1

    from hank_tpu_torch.blocks.assemble import residuals as eval_residuals
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.models.krusell_smith import exogenousZ
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                                   fused_residual_sweep_cluster,
                                                   fused_residual_sweep_global,
                                                   fused_residual_sweep_previous,
                                                   fused_residual_sweep_reference)
    from hank_tpu_torch.ops.fused_sweep import (fused_sweep_jvp, fused_sweep_jvp_cluster,
                                                fused_sweep_jvp_f64, fused_sweep_jvp_f64_cluster,
                                                fused_sweep_jvp_f64_global,
                                                fused_sweep_jvp_f64_previous,
                                                fused_sweep_jvp_global,
                                                fused_sweep_jvp_reference)
    from hank_tpu_torch.solvers.newton import make_full_residual_fn, make_path_solver
    from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
    from hank_tpu_torch.solvers.steady_state import find_ss

    # ── 1. device ──────────────────────────────────────────────────────────
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    dev = torch.device("cuda:0")
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # ── 2. build ───────────────────────────────────────────────────────────
    ptx_job = start_ptx()
    built = cuda_build.build()
    for name in cuda_build.LIBRARIES:
        cuda_build.load_library(name)
    ptxas = cuda_build.ptxas_report(built.log)
    # The f64 library's values pair (six kernels) and tangent pair (eight:
    # four single-path, four over B paths): the backward kernel's second
    # template flag and the forward's third are TANGENT, the first BATCHED.
    tangent_re = r"(bwd_f64_cluster_kernelILb[01]ELb1E|fwd_f64_cluster_kernelILb[01]ELb[01]ELb1E)"
    f64_kernels = [k for k in ptxas if "f64_cluster" in k["kernel"]
                   and not re.search(tangent_re, k["kernel"])]
    require(len(f64_kernels) == 6 and not any(k.get("spill_stores") or k.get("spill_loads")
                                              for k in f64_kernels),
            f"the f64 residual pair spills (or was not built): {f64_kernels}")
    tangent_kernels = [k for k in ptxas if re.search(tangent_re, k["kernel"])]
    tangent_bwd = [k for k in tangent_kernels if "bwd_" in k["kernel"]]
    require(len(tangent_kernels) == 8 and len(tangent_bwd) == 4
            and not any(k.get("spill_stores") or k.get("spill_loads") for k in tangent_bwd),
            f"the f64 tangent pair's eight instantiations were not built, or a backward one "
            f"spills: {tangent_kernels}")
    batched = [k for k in ptxas if "cluster_kernelILb1E" in k["kernel"]]
    require(len(batched) == 10, f"the ten batched two-asset kernels were not built: {batched}")
    # The instantiations of the batched f64 directions: the one-asset f64
    # tangent sweep over B paths in its three tiers, the tangent pair's
    # four over B paths.
    f64_directions_re = (r"ranged_kernelIdLb1ELb1E|cluster_kernelIdLb1ELb1E|"
                         r"bwd_f64_cluster_kernelILb1ELb1E|fwd_f64_cluster_kernelILb1ELb[01]ELb1E")
    ensemble_f64 = [k for k in ptxas if re.search(f64_directions_re, k["kernel"])]
    require(len(ensemble_f64) == 7,
            f"the seven batched f64 tangent instantiations were not built: {ensemble_f64}")
    global_lists = [k for k in ptxas if re.search(r"fwd_cluster_kernelILb[01]ELb1E|"
                                                  r"fwd_f64_cluster_kernelILb[01]ELb1ELb0E",
                                                  k["kernel"])]
    require(len(global_lists) == 4,
            f"the four global-list forward kernels were not built: {global_lists}")
    ranged = [k for k in ptxas if "household_sweep_ranged_kernel" in k["kernel"]]
    global_state = [k for k in ranged if "ELb1EEEv" in k["kernel"]]
    require(len(ranged) == 11 and len(global_state) == 6,
            f"the ranged kernel's eleven instantiations were not built: {ranged}")
    cluster_ptxas = [k for k in ptxas if "household_sweep_cluster_kernel" in k["kernel"]]
    added = [k for k in cluster_ptxas if re.search(r"kernelI(dLb0|fLb1ELb1|dLb1ELb1)",
                                                   k["kernel"])]
    require(len(cluster_ptxas) == 6 and len(added) == 4
            and not any(k.get("spill_stores") or k.get("spill_loads") for k in added),
            f"the six cluster instantiations were not built, or one added since the path "
            f"axis spills: {cluster_ptxas}")
    emit("build", seconds=built.seconds, libraries=built.paths, ptxas=ptxas,
         ptxas_two_asset_batched=batched, ptxas_ranged=ranged, ptxas_global_state=global_state,
         ptxas_cluster=cluster_ptxas, ptxas_global_lists=global_lists,
         ptxas_tangent_pair=tangent_kernels, ptxas_of_this_pr=ensemble_f64,
         tangent_pair_fit=tangent_pair_grids(),
         f64_pair_fit=f64_pair_grids(), global_list_fit=global_list_grids(),
         one_asset_grids=one_asset_grids(), fit_decisions=fit_decisions(),
         sass_vs_previous_build=sass_vs_reference(built.paths),
         global_state_nc_loads=state_loads_coherent(ptx_job))

    # ── 3. setup ───────────────────────────────────────────────────────────
    model = load_model("krusell_smith", T=300, device=dev)
    cs = model.compspec
    Tm1, nE = cs.T - 1, cs.n_endog
    setup = {"grid": list(model.state_shape()), "T": cs.T}

    def ss_residual(ss):
        col = torch.stack([torch.as_tensor(ss.vars[k]) for k in model.var_names()])
        x_mat = col[:, None].expand(cs.n_v, 1 + cs.max_lag + cs.max_lead)
        return float(eval_residuals(x_mat, model).abs().max())

    sss = {}
    for label, spec in (("initial", model.ss_initial), ("ending", model.ss_ending)):
        t0 = time.perf_counter()
        sss[label] = find_ss(model, spec, label)
        torch.cuda.synchronize()
        setup[f"ss_{label}_s"] = time.perf_counter() - t0
        setup[f"max_abs_F_ss_{label}"] = ss_residual(sss[label])
        setup[f"KS_{label}"] = float(sss[label].vars["KS"])
        require(setup[f"max_abs_F_ss_{label}"] <= 1e-9,
                f"steady state '{label}' residual {setup[f'max_abs_F_ss_{label}']:.3e} > 1e-9")
    ss0, ssT = sss["initial"], sss["ending"]
    t0 = time.perf_counter()
    Jbar = get_steady_state_jacobian(ssT, model)
    torch.cuda.synchronize()
    setup["jacobian_s"] = time.perf_counter() - t0
    require(bool(torch.isfinite(Jbar).all()), "J̄ has non-finite entries")
    emit("setup", **setup)

    # ── 4. kernels against their plain versions ────────────────────────────
    exog = {"Z": exogenousZ(Tm1, rho=0.8, z_start=1.0, z_end=2.0).to(dev)}
    endog = model.vars_of_type("endogenous")
    x_ss = torch.stack([torch.as_tensor(ssT.vars[k]) for k in endog]).repeat(Tm1)
    i_r, i_w = endog.index("r"), endog.index("w")
    wealth, prod = model.endog_dims()[0], model.exog_dims()[0]
    p = model.params
    kw = dict(beta=p["β"], gamma=p["γ"], borrow_cons=p["borrow_cons"])
    f32, f64 = torch.float32, torch.float64

    def consts(dtype):
        return [t.to(dtype).contiguous() for t in
                (ssT.value, ss0.D, wealth.grid, prod.grid, prod.transition)]

    def prices(x, dtype):
        xp = x.reshape(Tm1, nE)
        return xp[:, i_r].to(dtype).contiguous(), xp[:, i_w].to(dtype).contiguous()

    # Kernel 1 is checked at points the main path evaluates it at: its first
    # iterate x_ss, its last iterate (from the warm-up solve, which the
    # timed runs below must reproduce bit for bit) and a smooth seeded
    # deviation from x_ss. Off those, on paths that move households across
    # the borrowing kink, the f32 tangent is ill-conditioned: two f32
    # computations of it (kernel and plain version) then differ from each
    # other, and from the f64 tangent, by up to ~1e-2 relative (PERF.md).
    solver = make_path_solver(Jbar, exog, model, ss0, ssT, method="newton_krylov",
                              direction_dtype=f32, eps=1e-8, gmres_restart=10)
    x_warm, _ = solver(x_ss)
    torch.cuda.synchronize()
    gen = torch.Generator().manual_seed(0)
    decay = (0.9 ** torch.arange(Tm1, dtype=f64))[:, None]
    smooth = x_ss + (1e-3 * torch.randn(nE, generator=gen, dtype=f64)
                     * decay).reshape(-1).to(dev)
    c32, c64 = consts(f32), consts(f64)
    k1_err = 0.0
    bit_inputs = {}
    for label, x in (("x_ss", x_ss), ("solution", x_warm), ("smooth", smooth)):
        v = torch.randn(x_ss.shape, generator=gen, dtype=f64).to(dev)
        args = (*prices(x, f32), *prices(v, f32), *c32)
        out = fused_sweep_jvp(*args, **kw)
        ref = fused_sweep_jvp_reference(*args, **kw)
        for o, r_ in zip(out, ref):
            err = max_abs(o, r_)
            scale = float(r_.abs().max())
            require(err <= 3e-5 * max(scale, 1.0),
                    f"kernel 1 off its plain version by {err:.3e} (scale {scale:.3e})")
            k1_err = max(k1_err, err)
        bit_inputs[label] = args
    zero = torch.zeros(Tm1, dtype=f32, device=dev)
    out0 = fused_sweep_jvp(*prices(x_ss, f32), zero, zero, *c32, **kw)
    require(bool((out0[1] == 0).all() and (out0[3] == 0).all()),
            "kernel 1: a zero tangent did not give exactly zero")

    # Kernel 1 against the previous kernel 1, bit for bit, at those points
    # and at three inputs that put rows out of order: V_T with seeded
    # positive noise and V_T with one NaN (implied-wealth rows out of order
    # or holding a NaN), and the grid with two adjacent knots swapped. The
    # count bracket makes the policy non-decreasing in the query whatever
    # the knots' order, so a policy row goes out of order only on a grid
    # out of order (or by one ulp of rounding at a bracket's end).
    gen_fb = torch.Generator().manual_seed(4)
    V_noisy = c32[0] * (1.0 + 0.5 * torch.rand(c32[0].shape, generator=gen_fb).to(dev))
    V_nan = c32[0].clone()
    V_nan[int(torch.randint(1, wealth.n - 1, (1,), generator=gen_fb)),
          int(torch.randint(0, prod.n, (1,), generator=gen_fb))] = float("nan")
    k = int(torch.randint(2, wealth.n - 3, (1,), generator=gen_fb))
    swapped = c32[2].clone()
    swapped[[k, k + 1]] = swapped[[k + 1, k]]
    base = bit_inputs["x_ss"]
    bit_inputs["V_T_noise"] = (*base[:4], V_noisy.contiguous(), *base[5:])
    bit_inputs["V_T_nan"] = (*base[:4], V_nan, *base[5:])
    bit_inputs["grid_swapped"] = (*base[:6], swapped, *base[7:])
    bits = kernel1_vs_previous(bit_inputs, kw)
    require(bits["V_T_noise"]["fallback_rows_implied_wealth"] > 0
            and bits["V_T_nan"]["fallback_rows_implied_wealth"] > 0
            and bits["grid_swapped"]["fallback_rows_policy"] > 0,
            f"kernel 1: an input meant to take a fallback branch did not: {bits}")

    x = x_ss + 0.01 * torch.randn(x_ss.shape, generator=gen, dtype=f64).to(dev)
    args64 = (*prices(x, f64), *c64)       # no tangent: i.i.d. noise is fine
    out2 = fused_residual_sweep(*args64, **kw)
    ref2 = fused_residual_sweep_reference(*args64, **kw)
    k2_err = max(max_abs(o, r_) for o, r_ in zip(out2, ref2))
    require(k2_err <= 1e-11, f"kernel 2 off its plain version by {k2_err:.3e}")

    # Kernel 2 against the previous kernel 2, bit for bit, at kernel 1's
    # points and stress inputs in f64 (the same seeded noise, NaN and swap).
    bit_inputs64 = {label: (*prices(x, f64), *c64) for label, x in
                    (("x_ss", x_ss), ("solution", x_warm), ("smooth", smooth))}
    base64 = bit_inputs64["x_ss"]
    bit_inputs64["V_T_noise"] = (*base64[:2], V_noisy.double().contiguous(), *base64[3:])
    bit_inputs64["V_T_nan"] = (*base64[:2], V_nan.double(), *base64[3:])
    bit_inputs64["grid_swapped"] = (*base64[:4], swapped.double(), *base64[5:])
    bits2 = kernel2_vs_previous(bit_inputs64, kw)
    require(bits2["V_T_noise"]["fallback_rows_implied_wealth"] > 0
            and bits2["V_T_nan"]["fallback_rows_implied_wealth"] > 0
            and bits2["grid_swapped"]["fallback_rows_policy"] > 0,
            f"kernel 2: an input meant to take a fallback branch did not: {bits2}")

    # The f64 tangent sweep at kernel 1's three points (the f64 prices, kernel
    # 1's directions) against its plain version in f64, then against its
    # yardstick bit for bit there and at kernel 1's stress inputs in f64.
    jvp64_inputs = {label: (*prices(x, f64), *(a.double() for a in bit_inputs[label][2:4]),
                            *c64)
                    for label, x in (("x_ss", x_ss), ("solution", x_warm), ("smooth", smooth))}
    jvp64_err = 0.0
    for label, args in jvp64_inputs.items():
        tail = (*(a[-CHECK_PERIODS:].contiguous() for a in args[:4]), *c64)
        for o, r_ in zip(fused_sweep_jvp_f64(*tail, **kw), fused_sweep_jvp_reference(*tail, **kw)):
            err, scale = max_abs(o, r_), float(r_.abs().max())
            require(err <= 1e-10 * max(scale, 1.0),
                    f"f64 tangent sweep at {label} off its plain version by {err:.3e} "
                    f"(scale {scale:.3e})")
            jvp64_err = max(jvp64_err, err)
    zero64 = torch.zeros(Tm1, dtype=f64, device=dev)
    out0 = fused_sweep_jvp_f64(*prices(x_ss, f64), zero64, zero64, *c64, **kw)
    require(bool((out0[1] == 0).all() and (out0[3] == 0).all()),
            "f64 tangent sweep: a zero tangent did not give exactly zero")
    base64j = jvp64_inputs["x_ss"]
    jvp64_inputs["V_T_noise"] = (*base64j[:4], V_noisy.double().contiguous(), *base64j[5:])
    jvp64_inputs["V_T_nan"] = (*base64j[:4], V_nan.double(), *base64j[5:])
    jvp64_inputs["grid_swapped"] = (*base64j[:6], swapped.double(), *base64j[7:])
    bits64 = vs_previous("f64 tangent sweep", fused_sweep_jvp_f64, fused_sweep_jvp_f64_previous,
                         jvp64_inputs, kw)
    require(bits64["V_T_noise"]["fallback_rows_implied_wealth"] > 0
            and bits64["V_T_nan"]["fallback_rows_implied_wealth"] > 0
            and bits64["grid_swapped"]["fallback_rows_policy"] > 0,
            f"f64 tangent sweep: an input meant to take a fallback branch did not: {bits64}")

    # The global-state instantiations against the one-block kernels whose
    # places they take, bit for bit on every output and fallback count, at
    # the same points and stress inputs: <float, true, false, G> against
    # kernel 1, <double, false, false, G> against kernel 2, <double, true,
    # false, G> against the f64 tangent sweep.
    globals_ks = {
        "k1": bits_vs("kernel 1 on global state", fused_sweep_jvp_global, fused_sweep_jvp,
                      bit_inputs, kw),
        "k2": bits_vs("kernel 2 on global state", fused_residual_sweep_global,
                      fused_residual_sweep, bit_inputs64, kw),
        "jvp_f64": bits_vs("f64 tangent sweep on global state", fused_sweep_jvp_f64_global,
                           fused_sweep_jvp_f64, jvp64_inputs, kw)}
    for name, report in globals_ks.items():
        require_fallbacks(f"{name} on global state", report)
    emit("global_state_ks", grid=[wealth.n, prod.n], T=cs.T, bit_identical=globals_ks)

    # The single-path cluster instantiations against the one-block kernels,
    # bit for bit at the same points and stress inputs, and timed in turns
    # with them at the solution (one-block, cluster, cluster, one-block).
    clusters_ks = {
        "k1": bits_vs("kernel 1 on a cluster", fused_sweep_jvp_cluster, fused_sweep_jvp,
                      bit_inputs, kw),
        "jvp_f64": bits_vs("f64 tangent sweep on a cluster", fused_sweep_jvp_f64_cluster,
                           fused_sweep_jvp_f64, jvp64_inputs, kw),
        "k2": bits_vs("kernel 2 on a cluster", fused_residual_sweep_cluster,
                      fused_residual_sweep, bit_inputs64, kw)}
    for name, report in clusters_ks.items():
        require_fallbacks(f"{name} on a cluster", report)
    a32 = bit_inputs["solution"]
    cluster_200 = {
        "k1": in_turns({"one_block": lambda: fused_sweep_jvp(*a32, **kw),
                        "cluster": lambda: fused_sweep_jvp_cluster(*a32, **kw)}, 10),
        "jvp_f64": in_turns({"one_block": lambda: fused_sweep_jvp_f64(*jvp64_inputs["solution"],
                                                                      **kw),
                             "cluster": lambda: fused_sweep_jvp_f64_cluster(
                                 *jvp64_inputs["solution"], **kw)}, 10),
        "k2": in_turns({"one_block": lambda: fused_residual_sweep(*bit_inputs64["solution"],
                                                                  **kw),
                        "cluster": lambda: fused_residual_sweep_cluster(
                            *bit_inputs64["solution"], **kw)}, 10)}
    emit("cluster_ks", grid=[wealth.n, prod.n], T=cs.T, bit_identical=clusters_ks,
         ms_in_turns=cluster_200)

    args32 = (*prices(x, f32), *prices(v, f32), *c32)
    args64j = jvp64_inputs["solution"]
    k2_turns = in_turns({"k2_previous": lambda: fused_residual_sweep_previous(*args64, **kw),
                         "k2": lambda: fused_residual_sweep(*args64, **kw)}, 10)
    jvp64_turns = in_turns({
        "jvp_f64_previous": lambda: fused_sweep_jvp_f64_previous(*args64j, **kw),
        "jvp_f64": lambda: fused_sweep_jvp_f64(*args64j, **kw)}, 10)
    timing = {
        "k1_ms": cuda_ms(lambda: fused_sweep_jvp(*args32, **kw), 20),
        "k1_previous_ms": cuda_ms(lambda: previous_kernel1(args32, kw), 20),
        "k1_plain_ms": cuda_once(lambda: fused_sweep_jvp_reference(*args32, **kw))[1],
        "k2_ms": k2_turns["k2"], "k2_previous_ms": k2_turns["k2_previous"],
        "k2_plain_ms": cuda_ms(lambda: fused_residual_sweep_reference(*args64, **kw), 3),
        "jvp_f64_ms": jvp64_turns["jvp_f64"],
        "jvp_f64_previous_ms": jvp64_turns["jvp_f64_previous"],
        "jvp_f64_plain_ms": cuda_once(lambda: fused_sweep_jvp_reference(*args64j, **kw))[1],
    }
    emit("kernels", k1_max_abs_err=k1_err, k2_max_abs_err=k2_err, jvp_f64_max_abs_err=jvp64_err,
         k1_vs_previous_bit_identical=bits, k2_vs_previous_bit_identical=bits2,
         jvp_f64_vs_previous_bit_identical=bits64, **timing)

    # ── 5. solve ───────────────────────────────────────────────────────────
    fused_sweep_jvp.launches = 0
    fused_residual_sweep.launches = 0
    fused_sweep_jvp_reference.calls = 0
    fused_residual_sweep_reference.calls = 0
    zero_previous_launches()
    runs, xs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        x_sol, info = solver(x_ss)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        xs.append(x_sol)
    launches = {"k1": fused_sweep_jvp.launches, "k2": fused_residual_sweep.launches}
    plain_calls = {"k1": fused_sweep_jvp_reference.calls,
                   "k2": fused_residual_sweep_reference.calls}
    require(launches["k1"] > 0 and launches["k2"] > 0,
            f"a kernel of the main path never launched: {launches}")
    require(plain_calls["k1"] == 0 and plain_calls["k2"] == 0,
            f"a plain version ran on the main path: {plain_calls}")
    previous = previous_launches()
    require(not any(previous.values()), f"a previous kernel ran on the main path: {previous}")
    require(all(torch.equal(xs[0], xi) for xi in xs[1:]) and torch.equal(xs[0], x_warm),
            "repeated solves returned different paths")
    F_plain = make_full_residual_fn(model, ss0, ssT, exog)
    fnorm_plain = float(torch.linalg.norm(F_plain(xs[0])))
    require(bool(torch.isfinite(xs[0]).all()) and xs[0].shape == x_ss.shape,
            "solution is not a finite path of the expected shape")
    require(fnorm_plain < 1e-8, f"plain f64 ‖F‖ at the solution is {fnorm_plain:.3e}")
    emit("solve", median_s=statistics.median(runs), runs_s=runs,
         outer_iterations=info["iterations"], residual_norm=info["residual_norm"],
         residual_norm_plain_f64=fnorm_plain, launches=launches,
         plain_calls=plain_calls, previous_kernel_launches=previous, bit_identical=True)

    # ── 6. ensemble ────────────────────────────────────────────────────────
    ensemble_kernels, ensemble = ensemble_phase(model, ss0, ssT, Jbar, x_ss)

    # ── 7. two-asset ───────────────────────────────────────────────────────
    # Phase 10's dry run (a spawned NCCL rank of its own) runs beside phase
    # 7's host-bound setup, which waits for it before its first timed check.
    from hank_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun = Background(dryrun_multichip, 1, device=dev.type)
    with tempfile.TemporaryDirectory() as cache:
        two_asset_kernels, two = two_asset_phase(dev, ptxas, cache, dryrun)

    # ── 11. two-asset ensemble (on phase 7's setup) ────────────────────────
    two_asset_kernels += two_asset_ensemble_phase(two, ptxas)
    del two
    torch.cuda.empty_cache()

    # ── 12. two-asset large grid (50×70×5×2, T=150) ────────────────────────
    two_asset_kernels += two_asset_large_grid_phase(dev, ptxas)
    torch.cuda.empty_cache()

    # ── 8. driver ──────────────────────────────────────────────────────────
    phase8 = driver_phase(dev)
    driver = phase8["cases"]

    # ── 9. forward scan ────────────────────────────────────────────────────
    lg = driver["ks_large_grid"]
    scan_kernel = forward_scan_phase({
        "ks_200x7_T300": scan_inputs(model, ss0, ssT, exog, x_warm),
        "ks_large_grid_500x7_T150": scan_inputs(lg["model"], lg["ss0"], lg["ssT"],
                                                lg["exog"], lg["x"])})

    # ── 10. mesh ───────────────────────────────────────────────────────────
    mesh_launches = mesh_phase(model, ss0, ssT, Jbar, x_ss, x_warm, exog, ensemble, dryrun)
    for entry, key in zip(ensemble_kernels, ("k3_4", "k3_4", "k2_batch")):
        entry["launches_mesh"] = mesh_launches[key]

    n_a, n_e = wealth.n, prod.n
    k1_bound = least_time(nbytes(*args32) + 4 * nbytes(args32[0]),
                          one_asset_sweep_ops(Tm1, n_a, n_e, True), "f32")
    k2_bound = least_time(nbytes(*args64) + 2 * nbytes(args64[0]),
                          one_asset_sweep_ops(Tm1, n_a, n_e, False), "f64")
    jvp64_bound = least_time(nbytes(*args64j) + 4 * nbytes(args64j[0]),
                             one_asset_sweep_ops(Tm1, n_a, n_e, True), "f64")
    kernels = [
        {"name": "fused_sweep_jvp", "route": "cuda",
         "source": "hank_tpu_torch/csrc/household_sweep.cu",
         "replaces": "hank_tpu/ops/fused_sweep.py:385", "launches": launches["k1"],
         "max_abs_err": k1_err, "ms": timing["k1_ms"], "plain_ms": timing["k1_plain_ms"],
         **k1_bound, "library_ms": None, "ms_previous": timing["k1_previous_ms"],
         **{f"ms_{k}": c["k1_ms"] for k, c in driver.items()},
         **{f"ms_previous_{k}": c["k1_previous_ms"] for k, c in driver.items()}},
        {"name": "fused_residual_sweep", "route": "cuda",
         "source": "hank_tpu_torch/csrc/household_sweep.cu",
         "replaces": "hank_tpu/ops/fused_ds.py:338", "launches": launches["k2"],
         "max_abs_err": k2_err, "ms": timing["k2_ms"], "plain_ms": timing["k2_plain_ms"],
         **k2_bound, "library_ms": None, "ms_previous": timing["k2_previous_ms"],
         "fallback_rows": fallback_sum(bits2, ("x_ss", "solution", "smooth")),
         **{f"ms_{k}": c["k2_ms"] for k, c in driver.items()},
         **{f"ms_previous_{k}": c["k2_previous_ms"] for k, c in driver.items()}},
        {"name": "fused_sweep_jvp_f64", "route": "cuda",
         "source": "hank_tpu_torch/csrc/household_sweep.cu",
         "replaces": "hank_tpu/solvers/newton.py:389 (f64 directions by jax.jvp under XLA; "
                     "no TPU kernel)",
         "launches": phase8["f64_default_launches"], "max_abs_err": jvp64_err,
         "ms": timing["jvp_f64_ms"], "plain_ms": timing["jvp_f64_plain_ms"], **jvp64_bound,
         "library_ms": None, "ms_previous": timing["jvp_f64_previous_ms"],
         "fallback_rows": fallback_sum(bits64, ("x_ss", "solution", "smooth")),
         **{f"ms_{k}": c["jvp_f64_ms"] for k, c in driver.items()}},
        *ensemble_kernels,
        *two_asset_kernels,
        scan_kernel,
        *cluster_kernels(phase8["large_grid"], lg["global_500"],
                         {**cluster_200, **ensemble["cluster_200"]}),
        *global_state_kernels(phase8["large_grid"], lg["global_500"]),
        *phase8["large_grid"]["f64_entries"],
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
