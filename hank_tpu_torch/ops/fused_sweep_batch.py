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
launches the cluster instantiation `household_sweep_cluster_kernel<float,
true, true>` (`csrc/household_sweep_cluster.cu`: one thread-block cluster
a path, of `fused_sweep.sweep_batch_cluster`'s size for B; at n_e = 7 to
n_a = 3597), counted in `.launches_cluster`, and past that the
global-state instantiation `<float, true, true, true>` (counted in
`.launches_global`), as `fused_sweep.sweep_kernel` decides; each bit for
bit `<float, true, true>` where both fit. `fused_sweep_jvp_batch_cluster`
and `fused_sweep_jvp_batch_global` launch them at any grid they take, for
the checks.

`fused_sweep_jvp_f64_batch` is the same over B paths in f64, primal and
tangent: the f64 tangent sweep (`fused_sweep.fused_sweep_jvp_f64`) with a
path axis, `household_sweep_ranged_kernel<double, true, true>`, past one
block its cluster instantiation `household_sweep_cluster_kernel<double,
true, true>` and past that `<double, true, true, true>`, decided as above
(`cuda_build.JVP_F64_BATCH`; the bytes of a block are the single path's,
so the tiers end where its do: n_a = 529, 1660 and 4980 at n_e = 7). Row b
is a single `fused_sweep_jvp_f64` launch on row b, bit for bit. Its
`_cluster`, `_global` and `_previous` (the counting template's `<double,
true, true>`) entry points and its plain version
`fused_sweep_jvp_f64_batch_reference` (a loop over rows of the f64 plain
version) are those of the f32 one. The reference has no kernel for f64
directions: it vmaps `jax.jvp` of its f64 F (`hank_tpu/parallel/ensemble.py:247-279`).

`make_fused_jvp_batch` is the ensemble's direction map
(`hank_tpu/ops/fused_sweep_batch.py:412-495`): per row, the price-map JVP,
then the kernel for all rows at once, then the assembly + residual tail
JVP per row, both per-row parts under `torch.func.vmap`; in f32 through
kernels 3-4 (the reference's f32 tail), in f64 through
`fused_sweep_jvp_f64_batch` with the price map and the tail in f64. The
reference's VMEM chunking (`kernel_batch_width`), static Markov constants
and horizon bucketing are TPU workarounds and are not ported.
"""

from __future__ import annotations

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_sweep import (ENSEMBLE_ROUTE, _check_inputs, count_launch,
                                            fallback_pointer, fused_sweep_jvp_reference,
                                            launch_sweep, require_card, supports_fused_sweep,
                                            sweep_kernel, sweep_setup)

f32, f64 = torch.float32, torch.float64


def fused_sweep_jvp_batch(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                          *, beta: float, gamma: float, borrow_cons: float,
                          fallback_rows: torch.Tensor | None = None):
    """Batched JVP of the household map: (B, T-1) price paths and tangents
    ↦ (agg, dagg, aggc, daggc), each (B, T-1) float32: one launch of one
    block per path, or past its shared memory one cluster per path (or one
    global-state block per path), as `fused_sweep.sweep_kernel` decides.

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


fused_sweep_jvp_batch.launches = fused_sweep_jvp_batch.launches_cluster = 0
fused_sweep_jvp_batch.launches_global = 0


def fused_sweep_jvp_batch_cluster(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                                  *, beta: float, gamma: float, borrow_cons: float,
                                  fallback_rows: torch.Tensor | None = None,
                                  cluster: int | None = None):
    """`fused_sweep_jvp_batch` through `household_sweep_cluster_kernel<float,
    true, true>` at any grid its shared memory takes, one cluster of
    `cluster` blocks per path (default: `fused_sweep.sweep_batch_cluster`'s
    size, as the wrapper launches it), held bit for bit to kernels 3-4, to
    the global-state instantiation and, row by row, to
    `fused_sweep.fused_sweep_jvp_cluster`. No solver calls it. CUDA tensors
    only; counted in `fused_sweep_jvp_batch.launches_cluster`."""
    paths = (r_b, w_b, dr_b, dw_b)
    _check_inputs("fused_sweep_jvp_batch_cluster", f32, paths, V_T, D0, grid, e_grid, Pi,
                  batched=True)
    require_card("fused_sweep_jvp_batch_cluster", V_T, "fused_sweep_jvp_batch_reference")
    fallback = fallback_pointer("fused_sweep_jvp_batch_cluster", fallback_rows, V_T,
                                (r_b.shape[0], 2))
    out = launch_sweep("hank_sweep_jvp_f32_batch", paths, V_T, D0, grid, e_grid, Pi, n_out=4,
                       smem_kind=cuda_build.CLUSTER_KERNELS3_4, extra_ptrs=fallback,
                       cluster=cluster, beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    fused_sweep_jvp_batch.launches_cluster += 1
    return out


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
    return _rows_of_reference(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi, beta=beta,
                              gamma=gamma, borrow_cons=borrow_cons)


fused_sweep_jvp_batch_reference.calls = 0


def _rows_of_reference(r_b, w_b, dr_b, dw_b, *consts, **kw):
    """`fused_sweep_jvp_reference` on each row, stacked."""
    rows = [fused_sweep_jvp_reference(r_b[b], w_b[b], dr_b[b], dw_b[b], *consts, **kw)
            for b in range(r_b.shape[0])]
    return tuple(torch.stack(o) for o in zip(*rows))


def fused_sweep_jvp_f64_batch(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                              *, beta: float, gamma: float, borrow_cons: float,
                              fallback_rows: torch.Tensor | None = None):
    """`fused_sweep_jvp_batch` in float64: all inputs float64, the same
    outputs and `fallback_rows`. On the card one launch of
    `household_sweep_ranged_kernel<double, true, true>` (`.launches`), or
    past its shared memory of `household_sweep_cluster_kernel<double, true,
    true>` (`.launches_cluster`) or `<double, true, true, true>`
    (`.launches_global`), as `fused_sweep.sweep_kernel` decides; row b bit
    for bit `fused_sweep_jvp_f64` on row b. On CPU tensors the plain version
    `fused_sweep_jvp_f64_batch_reference`."""
    paths = (r_b, w_b, dr_b, dw_b)
    _check_inputs("fused_sweep_jvp_f64_batch", f64, paths, V_T, D0, grid, e_grid, Pi,
                  batched=True)
    fallback = fallback_pointer("fused_sweep_jvp_f64_batch", fallback_rows, V_T,
                                (r_b.shape[0], 2))
    kw = dict(beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    if V_T.device.type == "cpu":
        return fused_sweep_jvp_f64_batch_reference(*paths, V_T, D0, grid, e_grid, Pi, **kw)
    kernel = sweep_kernel(cuda_build.JVP_F64_BATCH, *V_T.shape)
    out = launch_sweep("hank_sweep_jvp_f64_batch", paths, V_T, D0, grid, e_grid, Pi,
                       n_out=4, smem_kind=kernel, extra_ptrs=fallback, **kw)
    count_launch(fused_sweep_jvp_f64_batch, cuda_build.JVP_F64_BATCH, kernel)
    return out


fused_sweep_jvp_f64_batch.launches = fused_sweep_jvp_f64_batch.launches_cluster = 0
fused_sweep_jvp_f64_batch.launches_global = 0


def fused_sweep_jvp_f64_batch_cluster(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                                      *, beta: float, gamma: float, borrow_cons: float,
                                      fallback_rows: torch.Tensor | None = None,
                                      cluster: int | None = None):
    """`fused_sweep_jvp_f64_batch` through `household_sweep_cluster_kernel<double,
    true, true>` at any grid its shared memory takes, one cluster of
    `cluster` blocks per path (default `fused_sweep.sweep_batch_cluster`'s
    size). No solver calls it. CUDA tensors only; counted in
    `fused_sweep_jvp_f64_batch.launches_cluster`."""
    paths = (r_b, w_b, dr_b, dw_b)
    _check_inputs("fused_sweep_jvp_f64_batch_cluster", f64, paths, V_T, D0, grid, e_grid, Pi,
                  batched=True)
    require_card("fused_sweep_jvp_f64_batch_cluster", V_T, "fused_sweep_jvp_f64_batch_reference")
    fallback = fallback_pointer("fused_sweep_jvp_f64_batch_cluster", fallback_rows, V_T,
                                (r_b.shape[0], 2))
    out = launch_sweep("hank_sweep_jvp_f64_batch", paths, V_T, D0, grid, e_grid, Pi, n_out=4,
                       smem_kind=cuda_build.CLUSTER_JVP_F64_BATCH, extra_ptrs=fallback,
                       cluster=cluster, beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    fused_sweep_jvp_f64_batch.launches_cluster += 1
    return out


def fused_sweep_jvp_f64_batch_global(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                                     *, beta: float, gamma: float, borrow_cons: float,
                                     fallback_rows: torch.Tensor | None = None):
    """`fused_sweep_jvp_f64_batch` through `household_sweep_ranged_kernel<double,
    true, true, true>` at any grid. No solver calls it. CUDA tensors only;
    counted in `fused_sweep_jvp_f64_batch.launches_global`."""
    paths = (r_b, w_b, dr_b, dw_b)
    _check_inputs("fused_sweep_jvp_f64_batch_global", f64, paths, V_T, D0, grid, e_grid, Pi,
                  batched=True)
    require_card("fused_sweep_jvp_f64_batch_global", V_T, "fused_sweep_jvp_f64_batch_reference")
    fallback = fallback_pointer("fused_sweep_jvp_f64_batch_global", fallback_rows, V_T,
                                (r_b.shape[0], 2))
    out = launch_sweep("hank_sweep_jvp_f64_batch", paths, V_T, D0, grid, e_grid, Pi, n_out=4,
                       smem_kind=cuda_build.GLOBAL_JVP_F64_BATCH, extra_ptrs=fallback,
                       beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    fused_sweep_jvp_f64_batch.launches_global += 1
    return out


def fused_sweep_jvp_f64_batch_previous(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                                       *, beta: float, gamma: float, borrow_cons: float):
    """The counting template's f64 dual build over B paths
    (`household_sweep_kernel<double, true, true>`), with
    `fused_sweep_jvp_f64_batch`'s arguments and outputs: the yardstick it is
    held to bit for bit on the card. No solver calls it. CUDA tensors
    only."""
    paths = (r_b, w_b, dr_b, dw_b)
    _check_inputs("fused_sweep_jvp_f64_batch_previous", f64, paths, V_T, D0, grid, e_grid, Pi,
                  batched=True)
    require_card("fused_sweep_jvp_f64_batch_previous", V_T, "fused_sweep_jvp_f64_batch_reference")
    out = launch_sweep("hank_sweep_jvp_f64_batch_previous", paths, V_T, D0, grid, e_grid, Pi,
                       n_out=4,
                       smem_kind=cuda_build.PREVIOUS_JVP_F64, beta=beta, gamma=gamma,
                       borrow_cons=borrow_cons)
    fused_sweep_jvp_f64_batch_previous.launches += 1
    return out


fused_sweep_jvp_f64_batch_previous.launches = 0


def fused_sweep_jvp_f64_batch_reference(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi,
                                        *, beta: float, gamma: float, borrow_cons: float):
    """Plain PyTorch version of the batched f64 tangent sweep: a loop over
    rows of `fused_sweep_jvp_reference` (the f64 sweep's plain version) in
    f64."""
    fused_sweep_jvp_f64_batch_reference.calls += 1
    return _rows_of_reference(r_b, w_b, dr_b, dw_b, V_T, D0, grid, e_grid, Pi, beta=beta,
                              gamma=gamma, borrow_cons=borrow_cons)


fused_sweep_jvp_f64_batch_reference.calls = 0


def supports_fused_batch(model) -> bool:
    """Same structural contract as the single-path sweep."""
    return supports_fused_sweep(model)


def make_fused_jvp_batch(model, ss_initial, ss_ending, dtype=f32):
    """Batched direction map of an ensemble, in `dtype`.

    Returns jvp_batch(x_b, v_b, exog_batch) -> `dtype` (B, n): row b is the
    directional derivative of F at x_b[b] along v_b[b] under the shock paths
    {k: exog_batch[k][b]}, (B, T-1) each — the batched analogue of
    `fused_sweep._build_fused`'s jvp_dir in the same dtype: in f32 through
    kernels 3-4 with the f32 tail, in f64 through `fused_sweep_jvp_f64_batch`
    with the price map and the tail in f64 (`make_fused_jvp_dir_f64` over B
    paths). On the card the grid is held to the kernel's tiers here
    (`sweep_setup`), before any launch, and past the last one the build
    raises naming the ensemble's plain route (`fused='xla'`).
    """
    which = cuda_build.KERNELS3_4 if dtype == f32 else cuda_build.JVP_F64_BATCH
    kernel = fused_sweep_jvp_batch if dtype == f32 else fused_sweep_jvp_f64_batch
    hook, consts, kw, to_aggs, _ = sweep_setup(model, ss_initial, ss_ending, dtype, which,
                                               ENSEMBLE_ROUTE)
    cs = model.compspec
    Tm1 = cs.T - 1
    vars0 = {k: torch.as_tensor(v).to(dtype) for k, v in ss_initial.vars.items()}
    varsT = {k: torch.as_tensor(v).to(dtype) for k, v in ss_ending.vars.items()}

    def price_jvp(xx, vv, ex):
        def price_map(z):
            r, s = hook(z.reshape(Tm1, cs.n_endog), ex, model)
            return r.to(dtype), s.to(dtype)
        return torch.func.jvp(price_map, (xx,), (vv,))

    def tail_jvp(xx, vv, agg, dagg, aggc, daggc, ex):
        def tail(z, a):
            return residuals(assemble_full_xmat(z, a, ex, model, vars0, varsT), model)
        return torch.func.jvp(tail, (xx, to_aggs(agg, aggc)), (vv, to_aggs(dagg, daggc)))[1]

    def jvp_batch(x_b, v_b, exog_batch):
        xd, vd = x_b.to(dtype), v_b.to(dtype)
        exd = {k: pth.to(dtype) for k, pth in exog_batch.items()}
        (r, s), (dr, ds) = torch.func.vmap(price_jvp)(xd, vd, exd)
        out = kernel(r.contiguous(), s.contiguous(), dr.contiguous(), ds.contiguous(), *consts,
                     **kw)
        return torch.func.vmap(tail_jvp)(xd, vd, *out, exd)

    return jvp_batch
