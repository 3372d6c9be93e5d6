"""The two-asset full-precision residual F(x) in native FP64 on the card.

The two-asset counterpart of `ops/fused_residual.py`, as kernels 5-6 are of
kernel 1. The reference computes this F under XLA in f64: its
double-single residual kernel (`hank_tpu/ops/fused_ds.py`) takes the
one-asset family only (`supports_ds_residual`, `:425-427`), so
`make_path_solver` leaves the two-asset F on the compiled f64 pipeline
(`hank_tpu/solvers/newton.py:352-376`). Here it is a kernel pair in
`csrc/household_sweep2_f64.cu`, kernels 5-6's cluster designs in double,
values only:
  - `fused2_policies_f64` (`two_asset_bwd_f64_cluster_kernel`): the
    backward Bellman recursion of `models/hank_two_asset.ValueFunction`
    over T-1 periods, the B/A/C policies of both access branches, on one
    thread-block cluster (one income state per block); plain version
    `fused2_policies_f64_reference` (`fused_sweep2.backward_policies` in
    f64);
  - `fused2_forward_f64` (`two_asset_fwd_f64_cluster_kernel`):
    `forward_iteration` (joint two-axis Young lottery, income then access
    mixing, the B/A/C aggregates against the mixed distribution), on one
    cluster (one (income, access) group per block); plain version
    `fused2_forward_f64_reference` (`forward_iteration` in f64).
On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel, and a build or launch error raises. `.launches`
counts kernel launches and `.calls` plain calls.

`make_fused2_residual_fn_f64` is F(x) through the pair: the model's
`fused2_prices` hook, the two kernels, and the f64 tail (`assemble_full_xmat`
+ `residuals`), as `fused_sweep2._build_fused2`'s `residual32` is in f32.
Past 2048 asset states (or where the shared lists have no room) the
forward push keeps its lottery lists in a global workspace (its
`<*, true>` instantiations, the same bits), to 4096; the builds record
which (`F.forward_kernel`) and raise past it.

For ensembles, `fused2_policies_f64_batch` and `fused2_forward_f64_batch`
launch the pair over B paths, one cluster per path (plain versions
`*_batch_reference`, loops over rows), row b bit for bit the single-path
launch on row b, and `make_fused2_residual_fn_f64_batch` is F_b through
them. The reference's ensemble F for this family is its vmapped XLA
pipeline (`hank_tpu/parallel/ensemble.py:76-95`).
"""

from __future__ import annotations

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals
from hank_tpu_torch.blocks.forward import forward_iteration
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_sweep import check_tensors
from hank_tpu_torch.ops.fused_sweep2 import (FORWARD_KERNELS, KEYS, _batch_inputs, _dims,
                                             _forward_batch_inputs, _fused2_price_hook,
                                             _policies_inputs, _state, backward_policies,
                                             batch_cluster_of, check_fit_forward,
                                             count_forward, default_bwd_cluster,
                                             default_cluster, forward_kernel, lists_scratch,
                                             path_block, supports_fused_sweep2)
from hank_tpu_torch.ops.precision import cast_model

f64 = torch.float64
LIBRARY = "household_sweep2_f64"
# The forward push's instantiations by `which` of the library's count: its
# lists in shared memory, or in a global workspace.
SHARED_LISTS, GLOBAL_LISTS = FORWARD_KERNELS[LIBRARY]
# What the card's check names when the pair does not take a grid.
PLAIN_ROUTE = "; on the card only the plain residual takes this grid (residual_mode='f64')"


def _launch(entry, tensors, ints, doubles=()):
    """Launch `entry` of the f64 library on the card of `tensors` (their
    data pointers in order), after its ints and doubles."""
    dev = tensors[-1].device
    lib = cuda_build.load_library(LIBRARY)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), *ints, *doubles,
                                  torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, entry)


def _on_card(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=f64).contiguous()


def fused2_policies_f64(r, ra, w, tau, value_T, model):
    """Backward recursion: (T-1,) f64 price paths (r, ra, w, tau) and the
    ending steady state's packed value (2, n_b, n_a, n_e, 2) f64 ↦ {B, A,
    C} dict of (T-1, n_b, n_a, n_e, 2) f64 policy paths.

    On the card: `two_asset_bwd_f64_cluster_kernel` on one cluster of
    `default_bwd_cluster(n_e)` blocks."""
    paths = (r, ra, w, tau)
    _policies_inputs("fused2_policies_f64", paths, value_T, model, f64)
    if value_T.device.type == "cpu":
        return fused2_policies_f64_reference(*paths, value_T, model)
    out = _launch_policies(paths, value_T, model)
    fused2_policies_f64.launches += 1
    return out


fused2_policies_f64.launches = 0


def _launch_policies(paths, value_T, model, untabled: bool = False):
    """The backward recursion on one cluster of `default_bwd_cluster(n_e)`
    blocks, on CUDA tensors. `untabled` never tables the candidates'
    brackets: the branch the kernel takes where the table has no room, bit
    for bit the tabled one where both fit (a check on the card; no route
    asks it)."""
    liquid, illiq, income, access = _dims(model)
    state = _state(model)
    Tm1 = paths[0].shape[0]
    cluster = default_bwd_cluster(income.n)
    cuda_build.check_shared_memory2_f64(cuda_build.load_library(LIBRARY), 3 if untabled else 0,
                                        *state[:3], cluster)
    dev, p = value_T.device, model.params
    out = torch.empty((3, Tm1, *state), dtype=f64, device=dev)
    _launch("hank_sweep2_policies_f64_untabled" if untabled else "hank_sweep2_policies_f64",
            [*paths, value_T, *(_on_card(t, dev) for t in (liquid.grid, illiq.grid, income.grid,
                                                           income.transition)), out],
            (Tm1, *state[:3], cluster),
            (float(p["β"]), float(access.transition[0, 1]), float(p.get("portfolio_reg", 0.0)),
             float(p["borrow_cons"])))
    return dict(zip(KEYS, out))


def fused2_policies_f64_reference(r, ra, w, tau, value_T, model):
    """Plain PyTorch version of the backward recursion: the backward scan
    through the ported `ValueFunction`, in f64."""
    fused2_policies_f64_reference.calls += 1
    return backward_policies(r, ra, w, tau, value_T, cast_model(model, f64))


fused2_policies_f64_reference.calls = 0


def fused2_forward_f64(policies, D0, model):
    """Forward push: {B, A, C} (T-1, n_b, n_a, n_e, 2) f64 policy paths and
    the initial distribution D0 (n_b, n_a, n_e, 2) f64 ↦ {B, A, C} dict of
    (T-1,) f64 aggregate paths (`forward_iteration`).

    On the card: `two_asset_fwd_f64_cluster_kernel` on one cluster of
    `default_cluster(n_e)` blocks, its lists in shared memory
    (`<false, false>`, counted in `.launches`) or, where the grid decides so
    (`fused_sweep2.forward_kernel`), in a global workspace (`<false, true>`,
    `.launches_global`), which gives the same bits."""
    tensors, Tm1 = _forward_f64_inputs("fused2_forward_f64", policies, D0, model)
    if D0.device.type == "cpu":
        return fused2_forward_f64_reference(policies, D0, model)
    which = forward_kernel(LIBRARY, *_state(model)[:3])
    out = _launch_forward(tensors, Tm1, model, which, default_cluster(_state(model)[2]))
    count_forward(fused2_forward_f64, LIBRARY, which)
    return out


fused2_forward_f64.launches = fused2_forward_f64.launches_global = 0


def _forward_f64_inputs(name, policies, D0, model):
    tensors = [*(policies[k] for k in KEYS), D0]
    check_tensors(name, tensors, f64)
    state = _state(model)
    Tm1 = tensors[0].shape[0]
    if any(t.shape != (Tm1, *state) for t in tensors[:3]) or D0.shape != state or Tm1 < 1:
        raise ValueError(f"{name}: expected (T-1, *{state}) policies and D0 "
                         f"{state}; got {[tuple(t.shape) for t in tensors]}")
    return tensors, Tm1


def _launch_forward(tensors, Tm1, model, which: int, cluster: int):
    """The forward push's instantiation `which` on one cluster of `cluster`
    blocks, on `_forward_f64_inputs`' CUDA tensors."""
    liquid, illiq, income, access = _dims(model)
    state = _state(model)
    cuda_build.check_shared_memory2_f64(cuda_build.load_library(LIBRARY), which, *state[:3],
                                        cluster)
    dev = tensors[-1].device
    # Scratch: each period's D, which the aggregates read after the
    # recursion, and the global-list instantiation's lists.
    scratch = [torch.empty(shape, dtype=f64, device=dev) for shape in
               [(Tm1, tensors[-1].numel()), *lists_scratch(which, LIBRARY, cluster, state)]]
    out = torch.empty((3, Tm1), dtype=f64, device=dev)
    _launch("hank_sweep2_forward_f64" if which == SHARED_LISTS else
            "hank_sweep2_forward_f64_global",
            [*tensors, *(_on_card(t, dev) for t in (liquid.grid, illiq.grid, income.transition,
                                                    access.transition)), *scratch, out],
            (Tm1, *state[:3], cluster))
    return dict(zip(KEYS, out))


def fused2_forward_f64_reference(policies, D0, model):
    """Plain PyTorch version of the forward push: `forward_iteration` in
    f64."""
    fused2_forward_f64_reference.calls += 1
    return forward_iteration(policies, cast_model(model, f64), D0)


fused2_forward_f64_reference.calls = 0


def fused2_policies_f64_batch(r_b, ra_b, w_b, tau_b, value_T, model):
    """The backward recursion over an ensemble: (B, T-1) f64 price paths and
    the shared value_T ↦ {B, A, C} dict of (B, T-1, n_b, n_a, n_e, 2) f64
    policy paths, views of one (B, 3, T-1, ...) tensor.

    On the card: one launch of `two_asset_bwd_f64_cluster_kernel<true>`, one
    cluster per path; row b is bit for bit `fused2_policies_f64` on row b.
    On CPU tensors: the plain version."""
    paths = (r_b, ra_b, w_b, tau_b)
    B, Tm1, state = _batch_inputs("fused2_policies_f64_batch", paths, value_T, model, f64)
    if value_T.device.type == "cpu":
        return fused2_policies_f64_batch_reference(*paths, value_T, model)
    liquid, illiq, income, access = _dims(model)
    cluster = batch_cluster_of(LIBRARY, 0, B, state[:3])
    cuda_build.check_shared_memory2_f64(cuda_build.load_library(LIBRARY), 0, *state[:3],
                                        cluster)
    dev, p = value_T.device, model.params
    out = torch.empty((B, 3, Tm1, *state), dtype=f64, device=dev)
    _launch("hank_sweep2_policies_f64_batch",
            [*paths, value_T, *(_on_card(t, dev) for t in (liquid.grid, illiq.grid, income.grid,
                                                           income.transition)), out],
            (Tm1, *state[:3], cluster, B),
            (float(p["β"]), float(access.transition[0, 1]), float(p.get("portfolio_reg", 0.0)),
             float(p["borrow_cons"])))
    fused2_policies_f64_batch.launches += 1
    return dict(zip(KEYS, out.transpose(0, 1)))


fused2_policies_f64_batch.launches = 0


def fused2_policies_f64_batch_reference(r_b, ra_b, w_b, tau_b, value_T, model):
    """Plain version of the batched backward recursion: a loop over rows of
    `fused2_policies_f64_reference`."""
    fused2_policies_f64_batch_reference.calls += 1
    rows = [fused2_policies_f64_reference(r_b[b], ra_b[b], w_b[b], tau_b[b], value_T, model)
            for b in range(r_b.shape[0])]
    return {k: torch.stack([r[k] for r in rows]) for k in KEYS}


fused2_policies_f64_batch_reference.calls = 0


def fused2_forward_f64_batch(policies, D0, model):
    """The forward push over an ensemble: {B, A, C} (B, T-1, n_b, n_a, n_e,
    2) f64 policy paths and the shared D0 ↦ {B, A, C} dict of (B, T-1) f64
    aggregate paths.

    On the card: one launch of `two_asset_fwd_f64_cluster_kernel<true>`, one
    cluster per path, on the policies as `fused2_policies_f64_batch` returns
    them (other layouts are stacked into that one first); row b is bit for
    bit `fused2_forward_f64` on row b. On CPU tensors: the plain version."""
    tensors, B, Tm1 = _forward_batch_inputs("fused2_forward_f64_batch", (policies,), D0, model,
                                            f64, KEYS)
    if D0.device.type == "cpu":
        return fused2_forward_f64_batch_reference(policies, D0, model)
    grid = _state(model)[:3]
    which = forward_kernel(LIBRARY, *grid)
    out = _launch_forward_batch(tensors, B, Tm1, D0, model, which,
                                batch_cluster_of(LIBRARY, which, B, grid))
    count_forward(fused2_forward_f64_batch, LIBRARY, which)
    return out


fused2_forward_f64_batch.launches = fused2_forward_f64_batch.launches_global = 0


def _launch_forward_batch(tensors, B, Tm1, D0, model, which: int, cluster: int):
    """The batched forward push's instantiation `which` on B clusters of
    `cluster` blocks, on `_forward_batch_inputs`' CUDA tensors."""
    liquid, illiq, income, access = _dims(model)
    state = _state(model)
    cuda_build.check_shared_memory2_f64(cuda_build.load_library(LIBRARY), which, *state[:3],
                                        cluster)
    dev = D0.device
    # Scratch: each path's D of every period, which the aggregates read
    # after the recursion, and the global-list instantiation's lists.
    scratch = [torch.empty(shape, dtype=f64, device=dev) for shape in
               [(B, Tm1, D0.numel()), *lists_scratch(which, LIBRARY, cluster, state, (B,))]]
    out = torch.empty((B, 3, Tm1), dtype=f64, device=dev)
    _launch("hank_sweep2_forward_f64_batch" if which == SHARED_LISTS else
            "hank_sweep2_forward_f64_global_batch",
            [path_block(tensors), D0, *(_on_card(t, dev) for t in (
                liquid.grid, illiq.grid, income.transition, access.transition)), *scratch, out],
            (Tm1, *state[:3], cluster, B))
    return dict(zip(KEYS, out.transpose(0, 1)))


def fused2_forward_f64_batch_reference(policies, D0, model):
    """Plain version of the batched forward push: a loop over rows of
    `fused2_forward_f64_reference`."""
    fused2_forward_f64_batch_reference.calls += 1
    rows = [fused2_forward_f64_reference({k: policies[k][b] for k in KEYS}, D0, model)
            for b in range(policies["B"].shape[0])]
    return {k: torch.stack([r[k] for r in rows]) for k in KEYS}


fused2_forward_f64_batch_reference.calls = 0


def check_fit_f64(model) -> int:
    """ValueError (naming the plain route, residual_mode='f64') where the
    pair does not take the model's grid: past the forward kernel's
    global-list instantiation's 4096 asset states, or past a block's shared
    memory by the library's count of the backward kernel and of the forward
    instantiation `fused_sweep2.forward_kernel` picks, on their default
    clusters. Returns that instantiation (SHARED_LISTS or GLOBAL_LISTS)."""
    return check_fit_forward(LIBRARY, _state(model)[:3], 0, "the f64 residual pair",
                             PLAIN_ROUTE)


def make_fused2_residual_fn_f64(model, ss_initial, ss_ending, exog_paths):
    """F(x) -> f64 residual through the pair: the `fused2_prices` hook in
    f64, the backward recursion, the forward push, then the f64 tail
    (`assemble_full_xmat` + `residuals`). On the card the pair is held to
    the model's grid here (`check_fit_f64`), before any launch."""
    if not supports_fused_sweep2(model):
        raise ValueError("model does not declare the two-asset price hook "
                         "(fused2_prices) and structure the kernels need")
    hook = _fused2_price_hook(model)
    cs = model.compspec
    value_T = ss_ending.value.to(f64).contiguous()
    D0 = ss_initial.D.to(f64).contiguous()
    forward = check_fit_f64(model) if value_T.is_cuda else None

    def F(x):
        x64 = x.to(f64)
        prices = (q.to(f64).contiguous()
                  for q in hook(x64.reshape(cs.T - 1, cs.n_endog), exog_paths, model))
        aggs = fused2_forward_f64(fused2_policies_f64(*prices, value_T, model), D0, model)
        x_mat = assemble_full_xmat(x64, aggs, exog_paths, model, ss_initial.vars,
                                   ss_ending.vars)
        return residuals(x_mat, model)

    F.forward_kernel = forward
    return F


def make_fused2_residual_fn_f64_batch(model, ss_initial, ss_ending):
    """F_b(x_b, exog_batch) -> the f64 (B, n) residual of a two-asset
    ensemble: row b is F(x_b[b]) under the shock paths {k: exog_batch[k][b]},
    (B, T-1) each, as `make_fused2_residual_fn_f64` computes it. The price
    hook and the f64 tail run per row under `torch.func.vmap`; every row's
    household block is one launch each of the batched pair. On the card
    the pair is held to the model's grid here (`check_fit_f64`), before any
    launch."""
    if not supports_fused_sweep2(model):
        raise ValueError("model does not declare the two-asset price hook "
                         "(fused2_prices) and structure the kernels need")
    hook = _fused2_price_hook(model)
    cs = model.compspec
    value_T = ss_ending.value.to(f64).contiguous()
    D0 = ss_initial.D.to(f64).contiguous()
    forward = check_fit_f64(model) if value_T.is_cuda else None

    def prices(xx, ex):
        return tuple(q.to(f64) for q in hook(xx.reshape(cs.T - 1, cs.n_endog), ex, model))

    def tail(xx, aggs, ex):
        x_mat = assemble_full_xmat(xx, aggs, ex, model, ss_initial.vars, ss_ending.vars)
        return residuals(x_mat, model)

    def F_b(x_b, exog_batch):
        x64 = x_b.to(f64)
        paths = torch.func.vmap(prices)(x64, exog_batch)
        aggs = fused2_forward_f64_batch(
            fused2_policies_f64_batch(*(q.contiguous() for q in paths), value_T, model), D0,
            model)
        return torch.func.vmap(tail)(x64, aggs, exog_batch)

    F_b.forward_kernel = forward
    return F_b
