#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the script
exits non-zero and never prints the final `"ok": true` line:

  1. device  — nvidia-smi name and power limit, torch/CUDA versions; TF32
               off for matmuls and cuDNN.
  2. build   — both household-sweep kernels from `hank_tpu_torch/csrc/` by
               nvcc (sm_90a), with the build seconds and ptxas' report.
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
               within 1e-11. Median ms per sweep of kernel and plain version.
  5. solve   — 3 timed runs of the same solve. The launch counters are zeroed right
               before the timed runs; both kernels must have launched and
               neither plain version been called. The timed runs must return
               bit-identical paths, and ‖F‖ re-evaluated by the plain f64
               pipeline must be < 1e-8.
  6. ensemble — B=64 shock paths Z_b,t = 2 − ρ_bᵗ, ρ_b = 0.5 + 0.4·b/B, from
               x_ss on every row (the workload of scripts/measure_ensemble.py),
               through `solve_ensemble_host` and the path-batched kernels.
               One warm-up Newton-Krylov solve, then: the batched kernel 1
               (kernels 3-4) at x_ss and at the warm-up's rows (smooth
               seeded v), every row bit-identical to a single kernel-1
               launch, rows {0, 21, 42, 63} within 3e-5·max(scale, 1) of the
               plain version run in float64 on the same input values, a
               zero tangent exactly zero; the batched kernel 2 at
               the warm-up's rows, every row bit-identical to a single
               kernel-2 launch, rows {0, 63} within 1e-11 of the plain
               version. Then 3 timed Newton-Krylov solves (counters zeroed
               right before: both batched kernels launched, neither plain
               version called; bit-identical paths; ‖F‖ ≤ 1e-8 on every row,
               no stalled path; the plain f64 pipeline's ‖F‖ < 1e-8 on rows
               0, 63 and the worst row), the gap of row 63 to the single-path
               solve of its shock (reported), one boehl Richardson solve to
               the same bounds, and the batched kernel 1's ms per launch at
               B ∈ {1, 64, 132, 256, 1024} with the plain version's at B=4.

The last three lines are the kernel summary JSON, the nvidia-smi line and
`{"ok": true, "device": {...}}`. There is no CPU path: without a CUDA
device the script exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def ensemble_phase(model, ss0, ssT, Jbar, x_ss, B: int = 64,
                   widths=(1, 64, 132, 256, 1024)) -> list:
    """Phase 6: the ensemble path at B paths (see the module docstring).
    Emits its JSON lines and returns the `kernels` entries of the batched
    kernels."""
    import torch

    from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                                   fused_residual_sweep_batch,
                                                   fused_residual_sweep_batch_reference)
    from hank_tpu_torch.ops.fused_sweep import fused_sweep_jvp
    from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
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
    for x_b in (x_ss.expand(B, -1), x_warm):
        v_b = (torch.randn((B, 1, nE), generator=gen, dtype=f64) * decay).reshape(B, -1).to(dev)
        paths = (*prices(x_b, f32), *prices(v_b, f32))
        out = fused_sweep_jvp_batch(*paths, *c32, **kw)
        for b in range(B):
            single = fused_sweep_jvp(*(q[b].contiguous() for q in paths), *c32, **kw)
            require(all(torch.equal(o[b], s_) for o, s_ in zip(out, single)),
                    f"batched kernel 1: row {b} differs from its single launch")
        ref = fused_sweep_jvp_batch_reference(
            *(q.double() for q in rows_of(paths, check_rows)), *c32_as64, **kw)
        for o, r_ in zip(out, ref):
            err = max_abs(o[check_rows].double(), r_)
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
    k3_ms = cuda_ms(lambda: fused_sweep_jvp_batch(*small, *c32, **kw), 10)

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
    k2b_ms = cuda_ms(lambda: fused_residual_sweep_batch(
        *rows_of((r64, w64), [0, B - 1]), *c64, **kw), 10)
    k2b_ms_full = cuda_ms(lambda: fused_residual_sweep_batch(r64, w64, *c64, **kw), 10)
    emit("ensemble_kernels", B=B, k3_max_abs_err=k3_err,
         k3_max_abs_err_vs_plain_f32=k3_err_f32, k3_ms_B4=k3_ms,
         k3_plain_ms_B4=plain_ms, k2_batch_max_abs_err=k2b_err, k2_batch_ms_B2=k2b_ms,
         k2_batch_plain_ms_B2=plain2_ms, k2_batch_ms_full_B=k2b_ms_full,
         rows_bit_identical=True)

    # Newton-Krylov: 3 timed runs after the warm-up.
    def zero_counts():
        fused_sweep_jvp_batch.launches = fused_residual_sweep_batch.launches = 0
        fused_sweep_jvp_batch_reference.calls = 0
        fused_residual_sweep_batch_reference.calls = 0

    def read_counts():
        return ({"k3_4": fused_sweep_jvp_batch.launches,
                 "k2_batch": fused_residual_sweep_batch.launches},
                {"k3_4": fused_sweep_jvp_batch_reference.calls,
                 "k2_batch": fused_residual_sweep_batch_reference.calls})

    zero_counts()
    runs, xs, infos = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        x_sol, info = solve("newton_krylov")
        runs.append(time.perf_counter() - t0)
        xs.append(x_sol)
        infos.append(info)
    launches, plain_calls = read_counts()
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
    zero_counts()
    t0 = time.perf_counter()
    x_rich, info_r = solve("boehl")
    rich_s = time.perf_counter() - t0
    rich_launches, rich_plain = read_counts()
    fr = info_r["residual_norm"]
    require(bool((fr <= 1e-8).all()) and info_r["stalled_paths"] == 0,
            f"ensemble boehl: max ‖F‖ {float(fr.max()):.3e}, "
            f"{info_r['stalled_paths']} stalled paths")
    require(rich_plain["k3_4"] == 0 and rich_plain["k2_batch"] == 0,
            f"a plain version ran on the boehl ensemble path: {rich_plain}")
    emit("ensemble_boehl", B=B, seconds=rich_s, outer_iterations=info_r["iterations"],
         sweeps=info_r["inner_iterations"], residual_norm_max=float(fr.max()),
         launches=rich_launches, max_abs_vs_nk=max_abs(x_rich, xs[0]))

    # Throughput of the batched kernel 1 by width (rows of the solution).
    gen = torch.Generator().manual_seed(2)
    width_ms = {}
    for Bw in widths:
        idx = torch.arange(Bw, device=dev) % B
        v_w = torch.randn((Bw, x_ss.numel()), generator=gen, dtype=f64).to(dev)
        args_w = (*prices(xs[0][idx], f32), *prices(v_w, f32))
        width_ms[Bw] = cuda_ms(lambda: fused_sweep_jvp_batch(*args_w, *c32, **kw), 10)
    emit("ensemble_throughput", ms_per_launch=width_ms,
         sweeps_per_s={Bw: Bw / (ms / 1e3) for Bw, ms in width_ms.items()})

    entry = {"route": "cuda", "source": "hank_tpu_torch/csrc/household_sweep.cu",
             "launches": launches["k3_4"], "max_abs_err": k3_err, "ms": k3_ms,
             "plain_ms": plain_ms, f"ms_B{B}": width_ms.get(B)}
    return [
        {"name": "fused_sweep_jvp_batch (backward EGM)",
         "replaces": "hank_tpu/ops/fused_sweep_batch.py:87", **entry},
        {"name": "fused_sweep_jvp_batch (forward lottery)",
         "replaces": "hank_tpu/ops/fused_sweep_batch.py:177", **entry},
        {"name": "fused_residual_sweep_batch", "route": "cuda",
         "source": "hank_tpu_torch/csrc/household_sweep.cu",
         "replaces": "hank_tpu/ops/fused_ds.py:338", "launches": launches["k2_batch"],
         "max_abs_err": k2b_err, "ms": k2b_ms, "plain_ms": plain2_ms,
         f"ms_B{B}": k2b_ms_full},
    ]


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
                                                   fused_residual_sweep_reference)
    from hank_tpu_torch.ops.fused_sweep import (fused_sweep_jvp,
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
    info = cuda_build.build()
    cuda_build.load_library()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=info.seconds, library=info.path, ptxas=ptxas)

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
    for x in (x_ss, x_warm, smooth):
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
    zero = torch.zeros(Tm1, dtype=f32, device=dev)
    out0 = fused_sweep_jvp(*prices(x_ss, f32), zero, zero, *c32, **kw)
    require(bool((out0[1] == 0).all() and (out0[3] == 0).all()),
            "kernel 1: a zero tangent did not give exactly zero")

    x = x_ss + 0.01 * torch.randn(x_ss.shape, generator=gen, dtype=f64).to(dev)
    args64 = (*prices(x, f64), *c64)       # no tangent: i.i.d. noise is fine
    out2 = fused_residual_sweep(*args64, **kw)
    ref2 = fused_residual_sweep_reference(*args64, **kw)
    k2_err = max(max_abs(o, r_) for o, r_ in zip(out2, ref2))
    require(k2_err <= 1e-11, f"kernel 2 off its plain version by {k2_err:.3e}")

    args32 = (*prices(x, f32), *prices(v, f32), *c32)
    timing = {
        "k1_ms": cuda_ms(lambda: fused_sweep_jvp(*args32, **kw), 20),
        "k1_plain_ms": cuda_ms(lambda: fused_sweep_jvp_reference(*args32, **kw), 3),
        "k2_ms": cuda_ms(lambda: fused_residual_sweep(*args64, **kw), 20),
        "k2_plain_ms": cuda_ms(lambda: fused_residual_sweep_reference(*args64, **kw), 3),
    }
    emit("kernels", k1_max_abs_err=k1_err, k2_max_abs_err=k2_err, **timing)

    # ── 5. solve ───────────────────────────────────────────────────────────
    fused_sweep_jvp.launches = 0
    fused_residual_sweep.launches = 0
    fused_sweep_jvp_reference.calls = 0
    fused_residual_sweep_reference.calls = 0
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
         plain_calls=plain_calls, bit_identical=True)

    # ── 6. ensemble ────────────────────────────────────────────────────────
    ensemble_kernels = ensemble_phase(model, ss0, ssT, Jbar, x_ss)

    kernels = [
        {"name": "fused_sweep_jvp", "route": "cuda",
         "source": "hank_tpu_torch/csrc/household_sweep.cu",
         "replaces": "hank_tpu/ops/fused_sweep.py:385", "launches": launches["k1"],
         "max_abs_err": k1_err, "ms": timing["k1_ms"], "plain_ms": timing["k1_plain_ms"]},
        {"name": "fused_residual_sweep", "route": "cuda",
         "source": "hank_tpu_torch/csrc/household_sweep.cu",
         "replaces": "hank_tpu/ops/fused_ds.py:338", "launches": launches["k2"],
         "max_abs_err": k2_err, "ms": timing["k2_ms"], "plain_ms": timing["k2_plain_ms"]},
        *ensemble_kernels,
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
