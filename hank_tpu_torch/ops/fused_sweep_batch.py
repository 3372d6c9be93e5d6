"""Kernels 3-4: the f32 primal + tangent household sweep over an ensemble.

Replaces the TPU kernel pair of `hank_tpu/ops/fused_sweep_batch.py`:
`_make_bwd_kernel` (backward dual EGM for B paths) and `_make_fwd_kernel`
(forward dual lottery, Markov mix and aggregates for B paths), both reached
through `fused_sweep_jvp_batch`. On the TPU they are two kernels only
because the policies of B paths (B × 137 MB at KS size) cannot stay in
VMEM; their contract is kernel 1's, per path. Here they are one launch of
`household_sweep_ranged_kernel<float, true, true>`
(`csrc/household_sweep.cu`), the kernel template with kernel 1's
binary-search brackets and lottery source ranges, with a grid axis over
paths: one block per path, its own row of prices and tangents, its own
slice of the policy scratch and its own output row; V_T, D0, the grids and
Pi are shared. Row b of a batched launch is bit-identical to a single
`fused_sweep_jvp` launch (kernel 1) on row b.

`fused_sweep_jvp_batch` launches the kernel for CUDA tensors and runs the
plain version `fused_sweep_jvp_batch_reference` (a loop over rows of
kernel 1's plain version) only for CPU tensors. `.launches` counts kernel
launches and `.calls` plain-version calls. `fused_sweep_jvp_batch_previous`
launches the previous kernels 3-4 (the counting template
`household_sweep_kernel<float, true, *>`), which kernels 1 and 3-4 are held
to bit for bit on the card; no solver calls it.

Past one block's shared memory (at n_e = 7, n_a > 1148) the wrapper
launches the global-state instantiation `<float, true, true, true>`
(`fused_sweep.sweep_kernel`, counted in `.launches_global`), bit for bit
`<float, true, true>` where both fit; `fused_sweep_jvp_batch_global`
launches it at any grid, for the checks.

`make_fused_jvp_batch` is the ensemble's direction map
(`hank_tpu/ops/fused_sweep_batch.py:412-495`): per row, the price-map JVP,
then the kernel for all rows at once, then the f32 assembly + residual tail
JVP per row, both per-row parts under `torch.func.vmap`. The reference's
VMEM chunking (`kernel_batch_width`), static Markov constants and
horizon bucketing are TPU workarounds and are not ported.
"""

from __future__ import annotations

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_sweep import (_check_inputs, count_launch, fallback_pointer,
                                            fused_sweep_jvp_reference, launch_sweep,
                                            require_card, supports_fused_sweep,
                                            sweep_kernel, sweep_setup)

f32 = torch.float32


def fused_sweep_jvp_batch(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                          *, beta: float, gamma: float, borrow_cons: float,
                          fallback_rows: torch.Tensor | None = None):
    """Batched JVP of the household map: (B, T-1) price paths and tangents
    ↦ (agg, dagg, aggc, daggc), each (B, T-1) float32.

    All inputs float32 and contiguous on one device; V_T, D0 (n_a, n_e),
    grid (n_a,), e_grid (n_e,), Pi (n_e, n_e) are shared by every path.
    fallback_rows: optional (B, 2) int32 CUDA tensor; row b receives path
    b's counts of (period, income row) pairs whose implied-wealth knots [0]
    and clamped policies [1] were not non-decreasing (as in
    `fused_sweep_jvp`). Refused on CPU tensors.
    """
    paths = (r_b, w_b, dr_b, dw_b)
    _check_inputs("fused_sweep_jvp_batch", f32, paths, V_T, D0, grid, e_grid, Pi,
                  batched=True)
    B = r_b.shape[0]
    fallback = fallback_pointer("fused_sweep_jvp_batch", fallback_rows, V_T, (B, 2))
    kw = dict(beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    if V_T.device.type == "cpu":
        return fused_sweep_jvp_batch_reference(*paths, V_T, D0, grid, e_grid, Pi, **kw)
    kernel = sweep_kernel(cuda_build.KERNELS3_4, *V_T.shape)
    out = launch_sweep("hank_sweep_jvp_f32_batch", paths, V_T, D0, grid, e_grid, Pi,
                       n_out=4, smem_kind=kernel, extra_ptrs=fallback, **kw)
    count_launch(fused_sweep_jvp_batch, cuda_build.KERNELS3_4, kernel)
    return out


fused_sweep_jvp_batch.launches = fused_sweep_jvp_batch.launches_global = 0


def fused_sweep_jvp_batch_global(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                                 *, beta: float, gamma: float, borrow_cons: float,
                                 fallback_rows: torch.Tensor | None = None):
    """`fused_sweep_jvp_batch` through `household_sweep_ranged_kernel<float,
    true, true, true>` at any grid, held to kernels 3-4 bit for bit. No
    solver calls it. CUDA tensors only; counted in
    `fused_sweep_jvp_batch.launches_global`."""
    paths = (r_b, w_b, dr_b, dw_b)
    _check_inputs("fused_sweep_jvp_batch_global", f32, paths, V_T, D0, grid, e_grid, Pi,
                  batched=True)
    require_card("fused_sweep_jvp_batch_global", V_T, "fused_sweep_jvp_batch_reference")
    fallback = fallback_pointer("fused_sweep_jvp_batch_global", fallback_rows, V_T,
                                (r_b.shape[0], 2))
    out = launch_sweep("hank_sweep_jvp_f32_batch", paths, V_T, D0, grid, e_grid, Pi, n_out=4,
                       smem_kind=cuda_build.GLOBAL_KERNELS3_4, extra_ptrs=fallback,
                       beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    fused_sweep_jvp_batch.launches_global += 1
    return out


def fused_sweep_jvp_batch_previous(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                                   *, beta: float, gamma: float, borrow_cons: float):
    """The previous kernels 3-4 (`household_sweep_kernel<float, true, *>`,
    which counts brackets and scans every source), with
    `fused_sweep_jvp_batch`'s arguments and outputs. Kernels 1 and 3-4 are
    held to it bit for bit on the card; no solver calls it. CUDA tensors
    only."""
    paths = (r_b, w_b, dr_b, dw_b)
    _check_inputs("fused_sweep_jvp_batch_previous", f32, paths, V_T, D0, grid, e_grid, Pi,
                  batched=True)
    require_card("fused_sweep_jvp_batch_previous", V_T, "fused_sweep_jvp_batch_reference")
    out = launch_sweep("hank_sweep_jvp_f32_batch_previous", paths, V_T, D0, grid, e_grid,
                       Pi, n_out=4, smem_kind=1, beta=beta, gamma=gamma,
                       borrow_cons=borrow_cons)
    fused_sweep_jvp_batch_previous.launches += 1
    return out


fused_sweep_jvp_batch_previous.launches = 0


def fused_sweep_jvp_batch_reference(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                                    *, beta: float, gamma: float,
                                    borrow_cons: float):
    """Plain PyTorch version of the batched kernel: a loop over rows of
    `fused_sweep_jvp_reference`."""
    fused_sweep_jvp_batch_reference.calls += 1
    rows = [fused_sweep_jvp_reference(r_b[b], w_b[b], dr_b[b], dw_b[b], V_T, D0,
                                      grid, e_grid, Pi, beta=beta, gamma=gamma,
                                      borrow_cons=borrow_cons)
            for b in range(r_b.shape[0])]
    return tuple(torch.stack(o) for o in zip(*rows))


fused_sweep_jvp_batch_reference.calls = 0


def supports_fused_batch(model) -> bool:
    """Same structural contract as the single-path sweep."""
    return supports_fused_sweep(model)


def make_fused_jvp_batch(model, ss_initial, ss_ending):
    """Batched direction map of an ensemble.

    Returns jvp_batch(x_b, v_b, exog_batch) -> float32 (B, n): row b is the
    directional derivative of F at x_b[b] along v_b[b] under the shock paths
    {k: exog_batch[k][b]}, (B, T-1) each — the batched analogue of
    `fused_sweep._build_fused`'s jvp_dir, with the same f32 tail.
    """
    hook, consts, kw, to_aggs, _ = sweep_setup(model, ss_initial, ss_ending, f32,
                                               cuda_build.KERNELS3_4)
    cs = model.compspec
    Tm1 = cs.T - 1
    vars0 = {k: torch.as_tensor(v).to(f32) for k, v in ss_initial.vars.items()}
    varsT = {k: torch.as_tensor(v).to(f32) for k, v in ss_ending.vars.items()}

    def price_jvp(xx, vv, ex):
        def price_map(z):
            r, s = hook(z.reshape(Tm1, cs.n_endog), ex, model)
            return r.to(f32), s.to(f32)
        return torch.func.jvp(price_map, (xx,), (vv,))

    def tail_jvp(xx, vv, agg, dagg, aggc, daggc, ex):
        def tail(z, a):
            return residuals(assemble_full_xmat(z, a, ex, model, vars0, varsT), model)
        return torch.func.jvp(tail, (xx, to_aggs(agg, aggc)), (vv, to_aggs(dagg, daggc)))[1]

    def jvp_batch(x_b, v_b, exog_batch):
        x32, v32 = x_b.to(f32), v_b.to(f32)
        ex32 = {k: pth.to(f32) for k, pth in exog_batch.items()}
        (r, s), (dr, ds) = torch.func.vmap(price_jvp)(x32, v32, ex32)
        out = fused_sweep_jvp_batch(r.contiguous(), s.contiguous(), dr.contiguous(),
                                    ds.contiguous(), *consts, **kw)
        return torch.func.vmap(tail_jvp)(x32, v32, *out, ex32)

    return jvp_batch
