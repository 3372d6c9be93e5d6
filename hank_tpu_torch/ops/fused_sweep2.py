"""Kernels 5 and 6: the two-asset household sweep, primal + tangent, in f32.

Replace the TPU kernel pair of `hank_tpu/ops/fused_sweep2.py`:
  - `fused2_policies_jvp` (kernel 5, `_make_bwd2_kernel`): the backward dual
    Bellman recursion of `models/hank_two_asset.ValueFunction` over T-1
    periods, returning the B/A/C policies of both access branches and
    their tangents, on one thread-block cluster;
    `fused2_policies_jvp_previous` launches the previous kernel 5 (one
    block), which it is held to bit for bit;
  - `fused2_forward_jvp` (kernel 6, `_make_fwd2_kernel`): the forward dual
    push of the distribution (joint two-axis Young lottery, income and
    access mixing) and the B/A/C aggregates with their tangents, on one
    thread-block cluster; `fused2_forward_jvp_previous` launches the
    previous kernel 6 (one block), which it is held to bit for bit.
The CUDA source is `hank_tpu_torch/csrc/household_sweep2.cu`. Every f32
direction (GMRES or Richardson matvec) of the two-asset path solver is one
launch of kernels 5 and 6, back to back.

Kernel 6 and the f64 forward push (`ops/fused_residual2.py`) keep each
source's lottery-list entries in shared memory and give a thread two
sources of 1024: n_b·n_a ≤ 2048. Past that, or where the shared lists have
no room, the maps take their `GLOBAL_LISTS` instantiations (the lists in a
global workspace the wrapper allocates, four sources a thread, the same
bits) to 4096 asset states; `forward_kernel` decides by the library's
count before any launch, the builds record it (`.forward_kernel` on the
map) and raise past it (`check_fit_forward`). The card's bit-for-bit checks
launch an instantiation the grid does not decide through the private
launchers: `_launch_cluster` and `_launch_forward_batch` take `which`, and
`_launch_bwd_cluster(..., untabled=True)` runs kernel 5's untabled branch
(which the routes take where the brackets' table has no room).

For ensembles, `fused2_policies_jvp_batch` and `fused2_forward_jvp_batch`
launch the same kernels over B paths, one cluster per path (plain versions
`*_batch_reference`, loops over rows), row b bit for bit the single-path
launch on row b; `make_fused2_jvp_batch` is the ensemble's direction map
through them. The reference has no such pair for this family: it vmaps its
XLA pipeline (`hank_tpu/parallel/ensemble.py:283-292`).

On CPU tensors each wrapper runs its plain PyTorch version
(`fused2_policies_jvp_reference`: `torch.func.jvp` of the backward scan
through the ported `ValueFunction`; `fused2_forward_jvp_reference`:
`torch.func.jvp` of `forward_iteration`), in the inputs' dtype. On CUDA
tensors it launches the kernel, and a build or launch error raises.
`<wrapper>.launches` counts kernel launches and `<plain>.calls` plain
calls.

A model opts in by defining `fused2_prices(xp, exog_paths, model) ->
(r, ra, w, tau)` next to its `ValueFunction` (the reference's hook).
"""

from __future__ import annotations

import sys

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals
from hank_tpu_torch.blocks.forward import forward_iteration
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_sweep import PLAIN_ROUTES, check_tensors
from hank_tpu_torch.ops.precision import cast_model

f32 = torch.float32
KEYS = ("B", "A", "C")


def _dims(model):
    het = model.heterogeneity
    return het["liquid"], het["illiquid"], het["income"], het["access"]


def _state(model) -> tuple:
    liquid, illiq, income, _ = _dims(model)
    return liquid.n, illiq.n, income.n, 2


def _policies_inputs(name, paths, value_T, model, dtype=f32):
    check_tensors(name, [value_T, *paths], dtype)
    Tm1 = paths[0].shape[0]
    liquid, illiq, income, _ = _dims(model)
    state = (liquid.n, illiq.n, income.n, 2)
    if any(p.shape != (Tm1,) for p in paths) or Tm1 < 1 or value_T.shape != (2, *state):
        raise ValueError(f"{name}: expected (T-1,) paths and value_T "
                         f"{(2, *state)}; got {[tuple(p.shape) for p in paths]}, "
                         f"{tuple(value_T.shape)}")
    return Tm1, state


def _launch_backward(entry, paths, value_T, model, Tm1, state, scratch=(), extra=(),
                     batch: int | None = None):
    """Launch a kernel-5 entry point of the two-asset library on the inputs'
    card, with `scratch` (numbers of f32 of device scratch) before the
    output and `extra` ints after the grid: (policies, dpolicies) as
    `fused2_policies_jvp` returns them, or with `batch` paths as
    `fused2_policies_jvp_batch` does (views of one (B, 6, T-1, ...) output)."""
    liquid, illiq, income, access = _dims(model)
    dev = value_T.device
    p = model.params
    lib = cuda_build.load_library("household_sweep2")
    with torch.cuda.device(dev):
        lead = (6,) if batch is None else (batch, 6)
        out = torch.empty((*lead, Tm1, *state), dtype=f32, device=dev)
        args = [*paths, value_T,
                *(t.to(device=dev, dtype=f32).contiguous() for t in
                  (liquid.grid, illiq.grid, income.grid, income.transition)),
                *(torch.empty(k, dtype=f32, device=dev) for k in scratch), out]
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in args), Tm1, liquid.n, illiq.n, income.n, *extra,
            float(p["β"]), float(access.transition[0, 1]), float(p.get("portfolio_reg", 0.0)),
            float(p["borrow_cons"]), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, entry)
    rows = out if batch is None else out.transpose(0, 1)
    return dict(zip(KEYS, rows[:3])), dict(zip(KEYS, rows[3:]))


def default_bwd_cluster(n_e: int) -> int:
    """Kernel 5's cluster size: one income state per block, at most 16
    blocks (the card's largest cluster; past it a block takes several)."""
    return min(n_e, 16)


def fused2_policies_jvp(r_p, ra_p, w_p, tau_p, dr_p, dra_p, dw_p, dtau_p, value_T, model):
    """Backward dual sweep (kernel 5): (T-1,) f32 price paths (r, ra, w,
    tau) and their tangents ↦ (policies, dpolicies), {B, A, C} dicts of
    (T-1, n_b, n_a, n_e, 2) f32 paths. value_T is the ending steady state's
    packed (2, n_b, n_a, n_e, 2) value in f32; it carries no tangent.

    On the card: `two_asset_bwd_cluster_kernel` on one thread-block cluster
    of `default_bwd_cluster(n_e)` blocks (one income state per block), bit
    for bit `fused2_policies_jvp_previous`. A cluster the card cannot
    schedule raises."""
    paths = (r_p, ra_p, w_p, tau_p, dr_p, dra_p, dw_p, dtau_p)
    Tm1, state = _policies_inputs("fused2_policies_jvp", paths, value_T, model)
    if value_T.device.type == "cpu":
        return fused2_policies_jvp_reference(*paths, value_T, model)
    out = _launch_bwd_cluster(paths, value_T, model, default_bwd_cluster(state[2]))
    fused2_policies_jvp.launches += 1
    return out


fused2_policies_jvp.launches = 0


def _launch_bwd_cluster(paths, value_T, model, cluster: int, untabled: bool = False):
    """Kernel 5 on one cluster of `cluster` blocks (1 to
    default_bwd_cluster(n_e)), on CUDA tensors. `fused2_policies_jvp` passes
    the default; the split tool and `chip_smoke.py` also try other sizes.
    `untabled` never tables the candidates' brackets: the branch the kernel
    takes where the table has no room, bit for bit the tabled one where
    both fit (a check on the card; no route asks it)."""
    Tm1, state = _policies_inputs("fused2_policies_jvp", paths, value_T, model)
    cuda_build.check_shared_memory2(cuda_build.load_library("household_sweep2"),
                                    5 if untabled else 3, *state[:3], cluster)
    entry = ("hank_sweep2_policies_jvp_cluster_untabled_f32" if untabled
             else "hank_sweep2_policies_jvp_cluster_f32")
    return _launch_backward(entry, paths, value_T, model, Tm1, state, extra=(cluster,))


def fused2_policies_jvp_previous(r_p, ra_p, w_p, tau_p, dr_p, dra_p, dw_p, dtau_p, value_T,
                                 model):
    """The previous kernel 5 (`two_asset_bwd_kernel`: one block walking
    every income state of each period), which kernel 5 is held to bit for
    bit on the card. No solver calls it. CUDA tensors only."""
    paths = (r_p, ra_p, w_p, tau_p, dr_p, dra_p, dw_p, dtau_p)
    Tm1, state = _policies_inputs("fused2_policies_jvp_previous", paths, value_T, model)
    if value_T.device.type != "cuda":
        raise ValueError("fused2_policies_jvp_previous: the previous kernel runs on the "
                         "card only; fused2_policies_jvp_reference is the plain version")
    cuda_build.check_shared_memory2(cuda_build.load_library("household_sweep2"), 0,
                                    *state[:3])
    # Scratch: the no-access illiquid margin and its tangent (2 * N3).
    out = _launch_backward("hank_sweep2_policies_jvp_f32", paths, value_T, model, Tm1, state,
                           scratch=[2 * state[0] * state[1] * state[2]])
    fused2_policies_jvp_previous.launches += 1
    return out


fused2_policies_jvp_previous.launches = 0


def backward_policies(r, ra, w, tau, value_T, model):
    """The backward scan of `ValueFunction` over the price paths, in their
    dtype: {B, A, C} (T-1, n_b, n_a, n_e, 2) policy paths."""
    value = value_T
    out = {k: [None] * r.shape[0] for k in KEYS}
    for t in range(r.shape[0] - 1, -1, -1):
        res = model.value_fn(value, {"r": r[t], "ra": ra[t], "w": w[t], "tau": tau[t]}, model)
        value = res["Value"]
        for k in KEYS:
            out[k][t] = res[k]
    return {k: torch.stack(v) for k, v in out.items()}


def fused2_policies_jvp_reference(r_p, ra_p, w_p, tau_p, dr_p, dra_p, dw_p, dtau_p,
                                  value_T, model):
    """Plain PyTorch version of kernel 5: `torch.func.jvp` of the backward
    scan through the ported `ValueFunction`, in the inputs' dtype."""
    fused2_policies_jvp_reference.calls += 1
    m = cast_model(model, r_p.dtype)
    return torch.func.jvp(lambda *q: backward_policies(*q, value_T, m),
                          (r_p, ra_p, w_p, tau_p), (dr_p, dra_p, dw_p, dtau_p))


fused2_policies_jvp_reference.calls = 0


def batch_cluster(B: int, units: int, default: int, fits, clusters) -> int:
    """The cluster size of a batched launch of B paths, each path a cluster
    of C blocks sharing `units` work units (income states, or (income,
    access) groups) ⌈units / C⌉ a block: among C = default, ..., 1 whose
    blocks fit (`fits(C)`) and of which the card holds at least one
    (`clusters(C)`, its max active clusters), the least ⌈B / clusters(C)⌉ ·
    ⌈units / C⌉ (waves of clusters times units a block), the larger C on a
    tie. One path takes the default. Every size gives the default's bits."""
    best, cost = default, None
    for C in range(default, 0, -1):
        if not fits(C):
            continue
        n = clusters(C)
        if n < 1:
            continue
        c = -(-B // n) * -(-units // C)
        if cost is None or c < cost:
            best, cost = C, c
    return best


def _smem_count(library: str):
    return (cuda_build.sweep2_smem_bytes if library == "household_sweep2"
            else cuda_build.sweep2_f64_smem_bytes)


def batch_cluster_of(library: str, which: int, B: int, grid) -> int:
    """`batch_cluster` for a batched two-asset kernel (`cuda_build.max_clusters`'
    library and `which`, a forward kernel's the instantiation
    `forward_kernel` chose) at an n_b×n_a×n_e grid: the backward kernels
    share n_e income states over up to `default_bwd_cluster(n_e)` blocks, the
    forward kernels 2·n_e groups over up to `default_cluster(n_e)`; sizes
    held to that instantiation's shared-memory count."""
    n_e = grid[2]
    forward = which in FORWARD_KERNELS[library]
    units, default = ((2 * n_e, default_cluster(n_e)) if forward
                      else (n_e, default_bwd_cluster(n_e)))
    count = _smem_count(library)
    return batch_cluster(B, units, default,
                         lambda C: count(which, *grid, C) <= cuda_build.MAX_SMEM_BYTES,
                         lambda C: cuda_build.max_clusters(library, which, *grid, C))


# The two instantiations of each forward kernel (kernel 6 in
# `household_sweep2`, the f64 forward push in `household_sweep2_f64`), by
# `which` of the library's shared-memory count and max-clusters query: the
# lottery lists in each block's shared memory (two sources a thread of 1024),
# or in a global workspace the wrapper allocates (GLOBAL_LISTS; four sources a
# thread), and the asset states (n_b·n_a) each takes.
FORWARD_KERNELS = {"household_sweep2": (2, 4), "household_sweep2_f64": (1, 2)}
FORWARD_MAX_STATES = (2048, 4096)


def forward_kernel(library: str, n_b: int, n_a: int, n_e: int) -> int:
    """The forward kernel's instantiation (`FORWARD_KERNELS[library]`) a map
    launches at an n_b×n_a×n_e×2 grid, decided by the library's count on the
    default cluster before any launch: the shared-list one where it takes
    the grid (n_b·n_a ≤ 2048 and its count fits a block), else the
    global-list one. Whether that one fits is the builds' check
    (`check_fit_forward`), which raises past it; a launch past it raises."""
    return _forward_choice(library, (n_b, n_a, n_e))[0]


def _forward_choice(library: str, grid) -> tuple:
    """(`forward_kernel`'s instantiation, its count on the default cluster),
    each count asked once."""
    shared, global_lists = FORWARD_KERNELS[library]
    count, C = _smem_count(library), default_cluster(grid[2])
    if grid[0] * grid[1] <= FORWARD_MAX_STATES[0]:
        need = count(shared, *grid, C)
        if need <= cuda_build.MAX_SMEM_BYTES:
            return shared, need
    return global_lists, count(global_lists, *grid, C)


def check_fit_forward(library: str, grid, backward: int, what: str, hint: str) -> int:
    """ValueError (ending in `hint`) where a backward kernel (`backward`, on
    its default cluster) and the forward kernel's instantiation
    `forward_kernel` picks do not take an n_b×n_a×n_e grid: past the
    global-list one's asset states (before any count is asked), or past a
    block's shared memory by the library's count. Returns that
    instantiation."""
    n_b, n_a, n_e = grid
    what = f"{what} at grid {n_b}x{n_a}x{n_e}x2"
    if n_b * n_a > FORWARD_MAX_STATES[1]:
        raise ValueError(f"{what} has {n_b * n_a} asset states; the forward kernel takes "
                         f"{FORWARD_MAX_STATES[1]}{hint}")
    which, need = _forward_choice(library, grid)
    cuda_build.check_fit(max(_smem_count(library)(backward, *grid, default_bwd_cluster(n_e)),
                             need), what, hint)
    return which


def _batch_inputs(name, paths, value_T, model, dtype=f32):
    """`_policies_inputs` for (B, T-1) paths: (B, T-1, state)."""
    check_tensors(name, [value_T, *paths], dtype)
    B, Tm1 = paths[0].shape if paths[0].dim() == 2 else (0, 0)
    liquid, illiq, income, _ = _dims(model)
    state = (liquid.n, illiq.n, income.n, 2)
    if (any(p.shape != (B, Tm1) for p in paths) or B < 1 or Tm1 < 1
            or value_T.shape != (2, *state)):
        raise ValueError(f"{name}: expected (B, T-1) paths and value_T "
                         f"{(2, *state)}; got {[tuple(p.shape) for p in paths]}, "
                         f"{tuple(value_T.shape)}")
    return B, Tm1, state


def fused2_policies_jvp_batch(r_b, ra_b, w_b, tau_b, dr_b, dra_b, dw_b, dtau_b, value_T,
                              model):
    """Kernel 5 over an ensemble: (B, T-1) f32 price paths and tangents ↦
    (policies, dpolicies), {B, A, C} dicts of (B, T-1, n_b, n_a, n_e, 2)
    f32 paths; value_T as in `fused2_policies_jvp`, shared by every path.

    On the card: one launch of `two_asset_bwd_cluster_kernel<true>`, one
    cluster per path (`batch_cluster`'s size); the six outputs are views
    of one (B, 6, T-1, ...) tensor, and row b is bit for bit
    `fused2_policies_jvp` on row b. On CPU tensors: the plain version."""
    paths = (r_b, ra_b, w_b, tau_b, dr_b, dra_b, dw_b, dtau_b)
    B, Tm1, state = _batch_inputs("fused2_policies_jvp_batch", paths, value_T, model)
    if value_T.device.type == "cpu":
        return fused2_policies_jvp_batch_reference(*paths, value_T, model)
    cluster = batch_cluster_of("household_sweep2", 3, B, state[:3])
    cuda_build.check_shared_memory2(cuda_build.load_library("household_sweep2"), 3,
                                    *state[:3], cluster)
    out = _launch_backward("hank_sweep2_policies_jvp_cluster_f32_batch", paths, value_T, model,
                           Tm1, state, extra=(cluster, B), batch=B)
    fused2_policies_jvp_batch.launches += 1
    return out


fused2_policies_jvp_batch.launches = 0


def _stack_rows(rows):
    """[(dict, dict)] per path ↦ the (dict, dict) of their stacks."""
    return tuple({k: torch.stack([r[i][k] for r in rows]) for k in KEYS} for i in range(2))


def fused2_policies_jvp_batch_reference(r_b, ra_b, w_b, tau_b, dr_b, dra_b, dw_b, dtau_b,
                                        value_T, model):
    """Plain version of the batched kernel 5: a loop over rows of
    `fused2_policies_jvp_reference`."""
    fused2_policies_jvp_batch_reference.calls += 1
    paths = (r_b, ra_b, w_b, tau_b, dr_b, dra_b, dw_b, dtau_b)
    return _stack_rows([fused2_policies_jvp_reference(*(q[b] for q in paths), value_T, model)
                        for b in range(r_b.shape[0])])


fused2_policies_jvp_batch_reference.calls = 0


def default_cluster(n_e: int) -> int:
    """Kernel 6's cluster size: one (income, access) group per block, at
    most 16 blocks (the card's largest cluster)."""
    return min(2 * n_e, 16)


def _forward_inputs(name, policies, dpolicies, D0, model):
    tensors = [*(policies[k] for k in KEYS), *(dpolicies[k] for k in KEYS), D0]
    check_tensors(name, tensors, f32)
    liquid, illiq, income, _ = _dims(model)
    state = (liquid.n, illiq.n, income.n, 2)
    Tm1 = policies["B"].shape[0]
    if any(t.shape != (Tm1, *state) for t in tensors[:6]) or D0.shape != state or Tm1 < 1:
        raise ValueError(f"{name}: expected (T-1, *{state}) policies and D0 "
                         f"{state}; got {[tuple(t.shape) for t in tensors]}")
    return tensors, Tm1


def _launch_forward(entry, tensors, Tm1, model, scratch=(), extra=()):
    """Launch a kernel-6 entry point of the two-asset library on the inputs'
    card, with `scratch` (shapes of f32 device scratch) before the output:
    (aggs, daggs) as `fused2_forward_jvp` returns them."""
    liquid, illiq, income, access = _dims(model)
    dev = tensors[-1].device
    lib = cuda_build.load_library("household_sweep2")
    with torch.cuda.device(dev):
        out = torch.empty((6, Tm1), dtype=f32, device=dev)
        args = [*tensors,
                *(t.to(device=dev, dtype=f32).contiguous() for t in
                  (liquid.grid, illiq.grid, income.transition, access.transition)),
                *(torch.empty(shape, dtype=f32, device=dev) for shape in scratch),
                out]
        err = getattr(lib, entry)(*(t.data_ptr() for t in args), Tm1, liquid.n, illiq.n,
                                  income.n, *extra, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, entry)
    return dict(zip(KEYS, out[:3])), dict(zip(KEYS, out[3:]))


def fused2_forward_jvp(policies, dpolicies, D0, model):
    """Forward dual push (kernel 6): {B, A, C} (T-1, n_b, n_a, n_e, 2) f32
    policy paths and tangents, and the initial distribution D0 (n_b, n_a,
    n_e, 2) f32 ↦ (aggs, daggs), {B, A, C} dicts of (T-1,) f32 aggregate
    paths: `forward_iteration` under jvp (joint lottery, then income and
    access mixing, aggregates against the updated distribution).

    On the card: `two_asset_fwd_cluster_kernel` on one thread-block cluster
    of `default_cluster(n_e)` blocks (one (income, access) group per block),
    bit for bit `fused2_forward_jvp_previous`; the grid decides
    (`forward_kernel`) whether its lottery lists live in shared memory
    (`<false, false>`, counted in `.launches`) or in a global workspace
    (`<false, true>`, past 2048 asset states or where the shared lists have
    no room; `.launches_global`), which gives the same bits. A cluster the
    card cannot schedule raises."""
    tensors, Tm1 = _forward_inputs("fused2_forward_jvp", policies, dpolicies, D0, model)
    if D0.device.type == "cpu":
        return fused2_forward_jvp_reference(policies, dpolicies, D0, model)
    liquid, illiq, income, _ = _dims(model)
    which = forward_kernel("household_sweep2", liquid.n, illiq.n, income.n)
    out = _launch_cluster(tensors, Tm1, model, default_cluster(income.n), which)
    count_forward(fused2_forward_jvp, "household_sweep2", which)
    return out


fused2_forward_jvp.launches = fused2_forward_jvp.launches_global = 0


def count_forward(wrapper, library: str, which: int) -> None:
    """One launch of a forward kernel's instantiation `which`: `.launches`
    counts the shared-list one, `.launches_global` the global-list one."""
    if which == FORWARD_KERNELS[library][0]:
        wrapper.launches += 1
    else:
        wrapper.launches_global += 1


def lists_scratch(which: int, library: str, cluster: int, state, lead=()) -> list:
    """The global-list instantiation's workspace shape, (*lead, cluster,
    4·n_b·n_a, entry) of the library's dtype (an f32 entry is a float4),
    or none for the shared-list one."""
    if which == FORWARD_KERNELS[library][0]:
        return []
    entry = (4,) if library == "household_sweep2" else ()
    return [(*lead, cluster, 4 * state[0] * state[1], *entry)]


def _launch_cluster(tensors, Tm1, model, cluster: int, which: int = 2):
    """Kernel 6 on one cluster of `cluster` blocks (1 to default_cluster(n_e)),
    on `_forward_inputs`' CUDA tensors: the shared-list instantiation
    (which = 2) or the global-list one (4). `fused2_forward_jvp` passes the
    default cluster and `forward_kernel`'s choice; the split tool and the
    card tests also try other sizes."""
    liquid, illiq, income, _ = _dims(model)
    cuda_build.check_shared_memory2(cuda_build.load_library("household_sweep2"), which,
                                    liquid.n, illiq.n, income.n, cluster)
    entry = ("hank_sweep2_forward_jvp_cluster_f32" if which == 2
             else "hank_sweep2_forward_jvp_cluster_global_f32")
    # Scratch: each period's D and dD, which the aggregates read after the
    # recursion, and the global-list instantiation's lists.
    return _launch_forward(entry, tensors, Tm1, model,
                           scratch=[(Tm1, 2, tensors[-1].numel()),
                                    *lists_scratch(which, "household_sweep2", cluster,
                                                   (liquid.n, illiq.n))],
                           extra=(cluster,))


def fused2_forward_jvp_previous(policies, dpolicies, D0, model):
    """The previous kernel 6 (`two_asset_fwd_kernel`: one block walking the
    (income, access) groups of each period in turn), which kernel 6 is held
    to bit for bit on the card. No solver calls it. CUDA tensors only."""
    tensors, Tm1 = _forward_inputs("fused2_forward_jvp_previous", policies, dpolicies, D0,
                                   model)
    if D0.device.type != "cuda":
        raise ValueError("fused2_forward_jvp_previous: the previous kernel runs on the "
                         "card only; fused2_forward_jvp_reference is the plain version")
    liquid, illiq, income, _ = _dims(model)
    cuda_build.check_shared_memory2(cuda_build.load_library("household_sweep2"), 1,
                                    liquid.n, illiq.n, income.n)
    out = _launch_forward("hank_sweep2_forward_jvp_f32", tensors, Tm1, model)
    fused2_forward_jvp_previous.launches += 1
    return out


fused2_forward_jvp_previous.launches = 0


def fused2_forward_jvp_reference(policies, dpolicies, D0, model):
    """Plain PyTorch version of kernel 6: `torch.func.jvp` of
    `forward_iteration`, in the inputs' dtype."""
    fused2_forward_jvp_reference.calls += 1
    m = cast_model(model, D0.dtype)
    keys = model.vars_of_type("heterogeneous")
    return torch.func.jvp(lambda pol: forward_iteration(pol, m, D0),
                          ({k: policies[k] for k in keys},),
                          ({k: dpolicies[k] for k in keys},))


fused2_forward_jvp_reference.calls = 0


def path_block(tensors):
    """The (B, n, T-1, ...) tensor whose [:, q] is tensors[q], (B, T-1, ...)
    each: the one they are views of where they are laid out so (as a
    batched backward kernel writes its outputs), else a stacked copy."""
    t0 = tensors[0]
    n, row = len(tensors), t0[0].numel()
    size = t0.element_size()
    if (t0[0].is_contiguous() and t0.stride(0) == n * row
            and all(t.shape == t0.shape and t.stride() == t0.stride()
                    and t.data_ptr() == t0.data_ptr() + q * row * size
                    for q, t in enumerate(tensors))):
        return t0.as_strided((t0.shape[0], n, *t0.shape[1:]), (n * row, row, *t0.stride()[1:]))
    return torch.stack(tensors, 1)


def _forward_batch_inputs(name, policies, D0, model, dtype, keys):
    """Checks of a batched forward kernel's inputs (policy dicts with `keys`,
    (B, T-1, *state) each, and the shared D0): (the policies in order, B,
    T-1)."""
    tensors = [d[k] for d in policies for k in keys]
    check_tensors(name, [D0], dtype)
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.device != D0.device:
            raise TypeError(f"{name}: expected {dtype} tensors on {D0.device}")
    state = (_dims(model)[0].n, _dims(model)[1].n, _dims(model)[2].n, 2)
    B, Tm1 = tensors[0].shape[:2] if tensors[0].dim() == 6 else (0, 0)
    if any(t.shape != (B, Tm1, *state) for t in tensors) or D0.shape != state or B < 1 or Tm1 < 1:
        raise ValueError(f"{name}: expected (B, T-1, *{state}) policies and D0 "
                         f"{state}; got {[tuple(t.shape) for t in tensors]}, {tuple(D0.shape)}")
    return tensors, B, Tm1


def fused2_forward_jvp_batch(policies, dpolicies, D0, model):
    """Kernel 6 over an ensemble: {B, A, C} (B, T-1, n_b, n_a, n_e, 2) f32
    policy paths and tangents, and D0 (n_b, n_a, n_e, 2) f32 shared by
    every path ↦ (aggs, daggs), {B, A, C} dicts of (B, T-1) f32 paths.

    On the card: one launch of `two_asset_fwd_cluster_kernel<true>`, one
    cluster per path (`batch_cluster`'s size), on the policies as
    `fused2_policies_jvp_batch` returns them (other layouts are stacked
    into that one first); row b is bit for bit `fused2_forward_jvp` on row
    b. On CPU tensors: the plain version."""
    tensors, B, Tm1 = _forward_batch_inputs("fused2_forward_jvp_batch", (policies, dpolicies),
                                            D0, model, f32, KEYS)
    if D0.device.type == "cpu":
        return fused2_forward_jvp_batch_reference(policies, dpolicies, D0, model)
    grid = _state(model)[:3]
    which = forward_kernel("household_sweep2", *grid)
    out = _launch_forward_batch(tensors, B, Tm1, D0, model, which,
                                batch_cluster_of("household_sweep2", which, B, grid))
    count_forward(fused2_forward_jvp_batch, "household_sweep2", which)
    return out


fused2_forward_jvp_batch.launches = fused2_forward_jvp_batch.launches_global = 0


def _launch_forward_batch(tensors, B, Tm1, D0, model, which: int, cluster: int):
    """The batched kernel 6's instantiation `which` (2 shared lists, 4 global
    lists) on B clusters of `cluster` blocks, on `_forward_batch_inputs`'
    CUDA tensors: (aggs, daggs) as `fused2_forward_jvp_batch` returns them."""
    liquid, illiq, income, access = _dims(model)
    grid = (liquid.n, illiq.n, income.n)
    lib = cuda_build.load_library("household_sweep2")
    cuda_build.check_shared_memory2(lib, which, *grid, cluster)
    dev = D0.device
    entry = ("hank_sweep2_forward_jvp_cluster_f32_batch" if which == 2
             else "hank_sweep2_forward_jvp_cluster_global_f32_batch")
    with torch.cuda.device(dev):
        # Scratch: each path's D and dD of every period, which the
        # aggregates read after the recursion, and the global-list
        # instantiation's lists.
        scratch = [torch.empty(shape, dtype=f32, device=dev) for shape in
                   [(B, Tm1, 2, D0.numel()),
                    *lists_scratch(which, "household_sweep2", cluster, grid, (B,))]]
        out = torch.empty((B, 6, Tm1), dtype=f32, device=dev)
        args = [path_block(tensors), D0, *(t.to(device=dev, dtype=f32).contiguous() for t in
                             (liquid.grid, illiq.grid, income.transition, access.transition)),
                *scratch, out]
        err = getattr(lib, entry)(*(t.data_ptr() for t in args), Tm1, *grid, cluster, B,
                                  torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, entry)
    rows = out.transpose(0, 1)
    return dict(zip(KEYS, rows[:3])), dict(zip(KEYS, rows[3:]))


def fused2_forward_jvp_batch_reference(policies, dpolicies, D0, model):
    """Plain version of the batched kernel 6: a loop over rows of
    `fused2_forward_jvp_reference`."""
    fused2_forward_jvp_batch_reference.calls += 1
    return _stack_rows([fused2_forward_jvp_reference({k: policies[k][b] for k in KEYS},
                                                     {k: dpolicies[k][b] for k in KEYS},
                                                     D0, model)
                        for b in range(policies["B"].shape[0])])


fused2_forward_jvp_batch_reference.calls = 0


def _fused2_price_hook(model):
    mod = sys.modules.get(getattr(model.value_fn, "__module__", ""))
    return getattr(mod, "fused2_prices", None)


def supports_fused_sweep2(model) -> bool:
    """True iff `model` is the Calvo-access two-asset structure of the
    kernels: the `fused2_prices` hook, two endogenous (liquid, illiquid) and
    two exogenous (income, access) dimensions, γ = 2, and B, A, C as its
    heterogeneous variables."""
    if _fused2_price_hook(model) is None:
        return False
    if not (len(model.endog_dims()) == 2 and len(model.exog_dims()) == 2):
        return False
    if not {"liquid", "illiquid", "income", "access"} <= set(model.heterogeneity):
        return False
    p = model.params
    if not ({"β", "γ", "borrow_cons"} <= set(p)) or float(p["γ"]) != 2.0:
        return False
    return set(model.vars_of_type("heterogeneous")) == set(KEYS)


def check_fit_kernels(model) -> int:
    """ValueError (naming the plain routes) where kernels 5-6 on their
    default clusters do not take the model's grid: past kernel 6's
    global-list instantiation's 4096 asset states, or past a block's shared
    memory by the library's count of kernel 5 and of the kernel 6
    `forward_kernel` picks. A path axis adds nothing to a block. Returns
    that kernel 6 (2 shared lists, 4 global lists)."""
    return check_fit_forward("household_sweep2", _state(model)[:3], 3, "kernels 5-6",
                             PLAIN_ROUTES)


def _build_fused2(model, ss_initial, ss_ending, exog_paths, plain: bool = False):
    """Kernel 5-6 entry points (`hank_tpu/ops/fused_sweep2.py:748-819`);
    `plain` runs both kernels' plain versions instead, on every device (the
    cross-check the reference's `forward="xla"` option serves).

    Returns (jvp_dir, residual32):
      jvp_dir(x, v) -> f32 directional derivative of F at x along v: the
        price map by `torch.func.jvp`, the household JVP in kernels 5 and 6,
        the assembly + residual tail by `torch.func.jvp` in f32 (the
        reference's f32 tail).
      residual32(x) -> f32 F(x) through the same kernels with zero tangent.
    """
    if not supports_fused_sweep2(model):
        raise ValueError("model does not declare the two-asset price hook "
                         "(fused2_prices) and structure the kernels need")
    hook = _fused2_price_hook(model)
    model32 = cast_model(model, f32)
    cs = model.compspec
    Tm1 = cs.T - 1
    exog32 = {k: v.to(f32) for k, v in exog_paths.items()}
    vars0 = {k: torch.as_tensor(v).to(f32) for k, v in ss_initial.vars.items()}
    varsT = {k: torch.as_tensor(v).to(f32) for k, v in ss_ending.vars.items()}
    value_T = ss_ending.value.to(f32).contiguous()
    D0 = ss_initial.D.to(f32).contiguous()
    forward = check_fit_kernels(model) if not plain and value_T.is_cuda else None

    def price_map(xx):
        return tuple(q.to(f32) for q in hook(xx.reshape(Tm1, cs.n_endog), exog32, model32))

    def sweep(x32, v32):
        prices, dprices = torch.func.jvp(price_map, (x32,), (v32,))
        paths = [q.contiguous() for q in (*prices, *dprices)]
        if plain:
            pol, dpol = fused2_policies_jvp_reference(*paths, value_T, model32)
            return fused2_forward_jvp_reference(pol, dpol, D0, model32)
        pol, dpol = fused2_policies_jvp(*paths, value_T, model32)
        return fused2_forward_jvp(pol, dpol, D0, model32)

    def tail(xx, aggs):
        x_mat = assemble_full_xmat(xx, aggs, exog32, model32, vars0, varsT)
        return residuals(x_mat, model32)

    def jvp_dir(x, v):
        x32, v32 = x.to(f32), v.to(f32)
        aggs, daggs = sweep(x32, v32)
        return torch.func.jvp(tail, (x32, aggs), (v32, daggs))[1]

    def residual32(x):
        x32 = x.to(f32)
        aggs, _ = sweep(x32, torch.zeros_like(x32))
        return tail(x32, aggs)

    jvp_dir.forward_kernel = residual32.forward_kernel = forward
    return jvp_dir, residual32


def make_fused2_jvp_dir(model, ss_initial, ss_ending, exog_paths, plain: bool = False):
    """jvp_dir(x, v) through kernels 5-6, or with `plain` through their
    plain versions (see `_build_fused2`)."""
    return _build_fused2(model, ss_initial, ss_ending, exog_paths, plain)[0]


def make_fused2_residual_fn(model, ss_initial, ss_ending, exog_paths):
    """f32 F(x) through kernels 5-6 with zero tangent (see `_build_fused2`)."""
    return _build_fused2(model, ss_initial, ss_ending, exog_paths)[1]


def make_fused2_jvp_batch(model, ss_initial, ss_ending):
    """The direction map of a two-asset ensemble, `_build_fused2`'s jvp_dir
    over B paths (as `ops/fused_sweep_batch.make_fused_jvp_batch` is for
    the one-asset family).

    Returns jvp_batch(x_b, v_b, exog_batch) -> f32 (B, n): row b is the
    directional derivative of F at x_b[b] along v_b[b] under the shock
    paths {k: exog_batch[k][b]}, (B, T-1) each. The price map's JVP per row
    under `torch.func.vmap`, one launch each of the batched kernels 5 and
    6, then the f32 assembly and residual tail's JVP per row under
    `torch.func.vmap`. On the card the grid is held to the kernels' shared
    memory here (`check_fit_kernels`), before any launch, and the kernel 6
    it launches is recorded as `jvp_batch.forward_kernel` (None off the
    card).
    """
    if not supports_fused_sweep2(model):
        raise ValueError("model does not declare the two-asset price hook "
                         "(fused2_prices) and structure the kernels need")
    hook = _fused2_price_hook(model)
    model32 = cast_model(model, f32)
    cs = model.compspec
    Tm1 = cs.T - 1
    vars0 = {k: torch.as_tensor(v).to(f32) for k, v in ss_initial.vars.items()}
    varsT = {k: torch.as_tensor(v).to(f32) for k, v in ss_ending.vars.items()}
    value_T = ss_ending.value.to(f32).contiguous()
    D0 = ss_initial.D.to(f32).contiguous()
    forward = check_fit_kernels(model) if value_T.is_cuda else None

    def price_jvp(xx, vv, ex):
        def price_map(z):
            return tuple(q.to(f32) for q in hook(z.reshape(Tm1, cs.n_endog), ex, model32))
        return torch.func.jvp(price_map, (xx,), (vv,))

    def tail_jvp(xx, vv, aggs, daggs, ex):
        def tail(z, a):
            return residuals(assemble_full_xmat(z, a, ex, model32, vars0, varsT), model32)
        return torch.func.jvp(tail, (xx, aggs), (vv, daggs))[1]

    def jvp_batch(x_b, v_b, exog_batch):
        x32, v32 = x_b.to(f32), v_b.to(f32)
        ex32 = {k: p.to(f32) for k, p in exog_batch.items()}
        prices, dprices = torch.func.vmap(price_jvp)(x32, v32, ex32)
        pol, dpol = fused2_policies_jvp_batch(*(q.contiguous() for q in (*prices, *dprices)),
                                              value_T, model32)
        aggs, daggs = fused2_forward_jvp_batch(pol, dpol, D0, model32)
        return torch.func.vmap(tail_jvp)(x32, v32, aggs, daggs, ex32)

    jvp_batch.forward_kernel = forward
    return jvp_batch
