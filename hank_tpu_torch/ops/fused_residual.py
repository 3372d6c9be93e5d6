"""Kernel 2: the full-precision household residual sweep in native FP64.

Replaces the TPU kernel `hank_tpu/ops/fused_ds.py::fused_ds_residual_sweep`
(`_make_fused_ds_kernel`), which carried double-single f32 pairs because the
TPU has no f64 hardware. The H100 has native FP64, so this is the same
recursion as kernel 1 (`csrc/household_sweep.cu`,
`household_sweep_ranged_kernel<double, false, false>`): values only, no
tangent, general `pow`, with kernel 1's binary-search brackets and lottery
source ranges on rows checked non-decreasing — the integer-γ gate,
`ops/ds.py` and the interpret-mode `pure_callback` fence of the reference
are gone.

`fused_residual_sweep` launches the kernel for CUDA tensors and runs the
plain PyTorch version `fused_residual_sweep_reference` (the f64 household
blocks) only for CPU tensors. `make_sweep_residual_fn` is the reference's
`make_ds_residual_fn` F (`hank_tpu/ops/fused_ds.py:497-507`): every
full-precision F(x) of the path solver.

`fused_residual_sweep_batch` is the same kernel over an ensemble
(`<double, false, true>`, one block per path; plain version
`fused_residual_sweep_batch_reference`), and `make_sweep_residual_fn_batch`
the ensemble's F_b: every full-precision residual of `parallel/ensemble.py`.
The reference computes that one as `jax.vmap` of the f64 pipeline
(`hank_tpu/parallel/ensemble.py:76-95`).

`fused_residual_sweep_previous` and `fused_residual_sweep_batch_previous`
launch the previous kernel 2 (the counting template
`household_sweep_kernel<double, false, *>`), which both are held to bit for
bit on the card; no solver calls them. `.launches` counts kernel launches
and `.calls` plain-version calls.

Past one block's shared memory (at n_e = 7, n_a > 1036) both wrappers
launch the global-state instantiations `<double, false, *, true>`
(`fused_sweep.sweep_kernel`, counted in `.launches_global`), bit for bit
the one-block kernel where both fit; `fused_residual_sweep_global` and
`fused_residual_sweep_batch_global` launch them at any grid, for the checks.
"""

from __future__ import annotations

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_sweep import (_check_inputs, count_launch, fallback_pointer,
                                            household_aggregates, launch_sweep,
                                            require_card, sweep_kernel, sweep_setup)

f64 = torch.float64


def fused_residual_sweep(r_path, w_path, V_T, D0, grid, e_grid, Pi,
                         *, beta: float, gamma: float, borrow_cons: float,
                         fallback_rows: torch.Tensor | None = None):
    """(r, w) f64 price paths ↦ (agg, aggc): the (T-1,) f64 savings and
    consumption aggregate paths. Inputs float64, contiguous, on one device;
    state arrays (n_a, n_e). fallback_rows: optional (2,) int32 CUDA
    tensor, as in `fused_sweep_jvp`; refused on CPU tensors."""
    _check_inputs("fused_residual_sweep", f64, (r_path, w_path),
                  V_T, D0, grid, e_grid, Pi)
    fallback = fallback_pointer("fused_residual_sweep", fallback_rows, V_T, (2,))
    kw = dict(beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    if V_T.device.type == "cpu":
        return fused_residual_sweep_reference(r_path, w_path, V_T, D0, grid,
                                              e_grid, Pi, **kw)
    kernel = sweep_kernel(cuda_build.KERNEL2, *V_T.shape)
    out = launch_sweep("hank_sweep_residual_f64", (r_path, w_path), V_T, D0, grid,
                       e_grid, Pi, n_out=2, smem_kind=kernel, extra_ptrs=fallback, **kw)
    count_launch(fused_residual_sweep, cuda_build.KERNEL2, kernel)
    return out


fused_residual_sweep.launches = fused_residual_sweep.launches_global = 0


def fused_residual_sweep_global(r_path, w_path, V_T, D0, grid, e_grid, Pi,
                                *, beta: float, gamma: float, borrow_cons: float,
                                fallback_rows: torch.Tensor | None = None):
    """`fused_residual_sweep` through `household_sweep_ranged_kernel<double,
    false, false, true>` at any grid, held to kernel 2 bit for bit. No
    solver calls it. CUDA tensors only; counted in
    `fused_residual_sweep.launches_global`."""
    _check_inputs("fused_residual_sweep_global", f64, (r_path, w_path),
                  V_T, D0, grid, e_grid, Pi)
    require_card("fused_residual_sweep_global", V_T, "fused_residual_sweep_reference")
    fallback = fallback_pointer("fused_residual_sweep_global", fallback_rows, V_T, (2,))
    out = launch_sweep("hank_sweep_residual_f64", (r_path, w_path), V_T, D0, grid, e_grid,
                       Pi, n_out=2, smem_kind=cuda_build.GLOBAL_KERNEL2, extra_ptrs=fallback,
                       beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    fused_residual_sweep.launches_global += 1
    return out


def fused_residual_sweep_previous(r_path, w_path, V_T, D0, grid, e_grid, Pi,
                                  *, beta: float, gamma: float, borrow_cons: float):
    """The previous kernel 2 (`household_sweep_kernel<double, false, false>`,
    which counts brackets and scans every source), with
    `fused_residual_sweep`'s arguments and outputs. CUDA tensors only."""
    _check_inputs("fused_residual_sweep_previous", f64, (r_path, w_path),
                  V_T, D0, grid, e_grid, Pi)
    require_card("fused_residual_sweep_previous", V_T, "fused_residual_sweep_reference")
    out = launch_sweep("hank_sweep_residual_f64_previous", (r_path, w_path), V_T, D0,
                       grid, e_grid, Pi, n_out=2, smem_kind=0, beta=beta, gamma=gamma,
                       borrow_cons=borrow_cons)
    fused_residual_sweep_previous.launches += 1
    return out


fused_residual_sweep_previous.launches = 0


def fused_residual_sweep_reference(r_path, w_path, V_T, D0, grid, e_grid, Pi,
                                   *, beta: float, gamma: float, borrow_cons: float):
    """Plain PyTorch version of kernel 2: the household blocks in the
    inputs' dtype."""
    fused_residual_sweep_reference.calls += 1
    return household_aggregates(r_path, w_path, V_T, D0, grid, e_grid, Pi,
                                beta, gamma, borrow_cons)


fused_residual_sweep_reference.calls = 0


def fused_residual_sweep_batch(r_b, w_b, V_T, D0, grid, e_grid, Pi,
                               *, beta: float, gamma: float, borrow_cons: float,
                               fallback_rows: torch.Tensor | None = None):
    """Kernel 2 over an ensemble: (B, T-1) f64 price paths ↦ (agg, aggc),
    each (B, T-1), in one launch of one block per path. Row b is
    bit-identical to `fused_residual_sweep` on row b. fallback_rows:
    optional (B, 2) int32 CUDA tensor, row b path b's counts; refused on
    CPU tensors."""
    _check_inputs("fused_residual_sweep_batch", f64, (r_b, w_b),
                  V_T, D0, grid, e_grid, Pi, batched=True)
    fallback = fallback_pointer("fused_residual_sweep_batch", fallback_rows, V_T,
                                (r_b.shape[0], 2))
    kw = dict(beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    if V_T.device.type == "cpu":
        return fused_residual_sweep_batch_reference(r_b, w_b, V_T, D0, grid,
                                                    e_grid, Pi, **kw)
    kernel = sweep_kernel(cuda_build.KERNEL2, *V_T.shape)
    out = launch_sweep("hank_sweep_residual_f64_batch", (r_b, w_b), V_T, D0, grid,
                       e_grid, Pi, n_out=2, smem_kind=kernel, extra_ptrs=fallback, **kw)
    count_launch(fused_residual_sweep_batch, cuda_build.KERNEL2, kernel)
    return out


fused_residual_sweep_batch.launches = fused_residual_sweep_batch.launches_global = 0


def fused_residual_sweep_batch_global(r_b, w_b, V_T, D0, grid, e_grid, Pi,
                                      *, beta: float, gamma: float, borrow_cons: float,
                                      fallback_rows: torch.Tensor | None = None):
    """`fused_residual_sweep_batch` through `household_sweep_ranged_kernel<
    double, false, true, true>` at any grid, held to the batched kernel 2
    bit for bit. No solver calls it. CUDA tensors only; counted in
    `fused_residual_sweep_batch.launches_global`."""
    _check_inputs("fused_residual_sweep_batch_global", f64, (r_b, w_b),
                  V_T, D0, grid, e_grid, Pi, batched=True)
    require_card("fused_residual_sweep_batch_global", V_T,
                 "fused_residual_sweep_batch_reference")
    fallback = fallback_pointer("fused_residual_sweep_batch_global", fallback_rows, V_T,
                                (r_b.shape[0], 2))
    out = launch_sweep("hank_sweep_residual_f64_batch", (r_b, w_b), V_T, D0, grid, e_grid,
                       Pi, n_out=2, smem_kind=cuda_build.GLOBAL_KERNEL2, extra_ptrs=fallback,
                       beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    fused_residual_sweep_batch.launches_global += 1
    return out


def fused_residual_sweep_batch_previous(r_b, w_b, V_T, D0, grid, e_grid, Pi,
                                        *, beta: float, gamma: float,
                                        borrow_cons: float):
    """The previous batched kernel 2 (`household_sweep_kernel<double, false,
    *>`), with `fused_residual_sweep_batch`'s arguments and outputs. CUDA
    tensors only."""
    _check_inputs("fused_residual_sweep_batch_previous", f64, (r_b, w_b),
                  V_T, D0, grid, e_grid, Pi, batched=True)
    require_card("fused_residual_sweep_batch_previous", V_T,
                 "fused_residual_sweep_batch_reference")
    out = launch_sweep("hank_sweep_residual_f64_batch_previous", (r_b, w_b), V_T, D0,
                       grid, e_grid, Pi, n_out=2, smem_kind=0, beta=beta, gamma=gamma,
                       borrow_cons=borrow_cons)
    fused_residual_sweep_batch_previous.launches += 1
    return out


fused_residual_sweep_batch_previous.launches = 0


def fused_residual_sweep_batch_reference(r_b, w_b, V_T, D0, grid, e_grid, Pi,
                                         *, beta: float, gamma: float,
                                         borrow_cons: float):
    """Plain PyTorch version of the batched kernel 2: a loop over rows of
    `fused_residual_sweep_reference`."""
    fused_residual_sweep_batch_reference.calls += 1
    rows = [fused_residual_sweep_reference(r_b[b], w_b[b], V_T, D0, grid, e_grid, Pi,
                                           beta=beta, gamma=gamma,
                                           borrow_cons=borrow_cons)
            for b in range(r_b.shape[0])]
    return tuple(torch.stack(o) for o in zip(*rows))


fused_residual_sweep_batch_reference.calls = 0


def make_sweep_residual_fn(model, ss_initial, ss_ending, exog_paths):
    """F(x) -> f64 residual with the household block in kernel 2; the price
    map and the residual tail (assembly + equations over the (n_v, T)
    matrix) run in f64 torch ops."""
    hook, consts, kw, to_aggs, _ = sweep_setup(model, ss_initial, ss_ending, f64,
                                               cuda_build.KERNEL2)
    cs = model.compspec

    def F(x):
        x64 = x.to(f64)
        r, s = hook(x64.reshape(cs.T - 1, cs.n_endog), exog_paths, model)
        agg, aggc = fused_residual_sweep(r.to(f64).contiguous(), s.to(f64).contiguous(),
                                         *consts, **kw)
        x_mat = assemble_full_xmat(x64, to_aggs(agg, aggc), exog_paths, model,
                                   ss_initial.vars, ss_ending.vars)
        return residuals(x_mat, model)

    return F


def make_sweep_residual_fn_batch(model, ss_initial, ss_ending):
    """F_b(x_b, exog_batch) -> the f64 (B, n) residual of an ensemble: row b
    is F(x_b[b]) under the shock paths {k: exog_batch[k][b]}, (B, T-1) each.
    The household block of every row runs in one batched kernel-2 launch;
    the price map and the residual tail run per row under
    `torch.func.vmap` in f64 torch ops."""
    hook, consts, kw, to_aggs, _ = sweep_setup(model, ss_initial, ss_ending, f64,
                                               cuda_build.KERNEL2)
    cs = model.compspec

    def prices(xx, ex):
        r, s = hook(xx.reshape(cs.T - 1, cs.n_endog), ex, model)
        return r.to(f64), s.to(f64)

    def tail(xx, aggs, ex):
        x_mat = assemble_full_xmat(xx, aggs, ex, model, ss_initial.vars, ss_ending.vars)
        return residuals(x_mat, model)

    def F_b(x_b, exog_batch):
        x64 = x_b.to(f64)
        r, s = torch.func.vmap(prices)(x64, exog_batch)
        agg, aggc = fused_residual_sweep_batch(r.contiguous(), s.contiguous(), *consts, **kw)
        return torch.func.vmap(tail)(x64, to_aggs(agg, aggc), exog_batch)

    return F_b
