"""Structured profiling (port of `hank_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` trace (CPU and, where there is a card,
CUDA activity) and writes it as a Chrome trace into the directory given;
`solve_breakdown` times each building block of one solve, waiting for the
card around every call.
"""

from __future__ import annotations

import contextlib
import os

import torch

from hank_tpu_torch.utils.timing import timeit


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a profiler trace into `log_dir/trace.json` (open it in
    chrome://tracing or Perfetto); yields the profiler, whose
    `key_averages()` sums the time by kernel.

        with profiling.trace("/tmp/hank_trace"):
            solver(x0)
    """
    log_dir = log_dir or os.path.join(
        os.environ.get("HANK_TPU_TORCH_CACHE", os.path.expanduser("~/.cache/hank_tpu_torch")),
        "traces")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def solve_breakdown(model, ss_initial, ss_ending, Jbar, exog_paths,
                    *, direction_dtype=None, iters: int = 3) -> dict:
    """Per-block wall-clock of one solve's building blocks at the
    steady-state path (median of `iters` after a warm-up): the residual F
    (plain f64 pipeline), one direction JVP (kernel 1 or 5-6 for
    `direction_dtype=torch.float32`, `torch.func.jvp` of F otherwise), one
    J̄⁻¹ solve, one backward scan and one forward scan. The keys are those of
    `hank_tpu/utils/profiling.py:76-82`."""
    from hank_tpu_torch.blocks.backward import backward_iteration
    from hank_tpu_torch.blocks.forward import forward_iteration
    from hank_tpu_torch.ops.linalg import make_reusable_solver
    from hank_tpu_torch.solvers.newton import kernel_pair, make_full_residual_fn

    Tm1 = model.compspec.T - 1
    endog = model.vars_of_type("endogenous")
    x0 = torch.stack([torch.as_tensor(ss_ending.vars[k]) for k in endog]).repeat(Tm1)
    y = torch.full_like(x0, 1e-3)

    F = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)
    if direction_dtype == torch.float32:
        jvp_fn = kernel_pair(model, ss_initial, ss_ending, exog_paths)[0]
    else:
        def jvp_fn(x, v):
            return torch.func.jvp(F, (x,), (v,))[1]

    solve_jbar = make_reusable_solver(Jbar)

    def back(x):
        return backward_iteration(x, exog_paths, model, ss_ending.vars, ss_ending.value)

    pol = back(x0)
    b = F(x0)
    return {
        "residual_F_seconds": timeit(F, x0, iters=iters),
        "jvp_sweep_seconds": timeit(jvp_fn, x0, y, iters=iters),
        "precond_solve_seconds": timeit(solve_jbar, b, iters=iters),
        "backward_scan_seconds": timeit(back, x0, iters=iters),
        "forward_scan_seconds": timeit(
            lambda p: forward_iteration(p, model, ss_initial.D), pol, iters=iters),
    }
