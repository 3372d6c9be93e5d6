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
launch on row b, and `fused2_policies_jvp_f64_batch` and
`fused2_forward_jvp_f64_batch` the f64 tangent pair (below) the same way;
`make_fused2_jvp_batch` is the ensemble's direction map through either
pair (`dtype`). The reference has no such kernels for this family: it
vmaps its XLA pipeline (`hank_tpu/parallel/ensemble.py:247-292`).

On CPU tensors each wrapper runs its plain PyTorch version
(`fused2_policies_jvp_reference`: `torch.func.jvp` of the backward scan
through the ported `ValueFunction`; `fused2_forward_jvp_reference`:
`torch.func.jvp` of `forward_iteration`), in the inputs' dtype. On CUDA
tensors it launches the kernel, and a build or launch error raises.
`<wrapper>.launches` counts kernel launches and `<plain>.calls` plain
calls.

The same computation in FP64, the f64 directions of this family on the
card: `fused2_policies_jvp_f64` and `fused2_forward_jvp_f64` launch the
TANGENT instantiations of the f64 pair's kernels
(`csrc/household_sweep2_f64.cu`; their layouts in
`ops/fused_residual2.py`), plain versions the same
`fused2_*_jvp_reference` in f64; `make_fused2_jvp_dir_f64` is the f64
direction map through them, which `solvers/newton.f64_direction_route`
takes on the card under "auto" and on any device under "pallas". The
reference's f64 directions are `jax.jvp` of its f64 pipeline under XLA
(`hank_tpu/solvers/newton.py:389`); its kernels 5-6 compute the same
primal and tangent in f32.

A model opts in by defining `fused2_prices(xp, exog_paths, model) ->
(r, ra, w, tau)` next to its `ValueFunction` (the reference's hook).
"""

from __future__ import annotations

import sys

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals
from hank_tpu_torch.blocks.forward import forward_iteration
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_sweep import ENSEMBLE_ROUTE, PLAIN_ROUTES, check_tensors
from hank_tpu_torch.ops.precision import cast_model

f32, f64 = torch.float32, torch.float64
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
    """The library's shared-memory count by `which`; ValueError for a name
    that is not one of the two two-asset libraries."""
    counts = {"household_sweep2": cuda_build.sweep2_smem_bytes,
              "household_sweep2_f64": cuda_build.sweep2_f64_smem_bytes}
    if library not in counts:
        raise ValueError(f"no two-asset kernel library {library!r} (expected one of "
                         f"{sorted(counts)})")
    return counts[library]


def batch_cluster_of(library: str, which: int, B: int, grid) -> int:
    """`batch_cluster` for a batched two-asset kernel (`cuda_build.max_clusters`'
    library and `which`, a forward kernel's the instantiation
    `forward_kernel` chose) at an n_b×n_a×n_e grid: the backward kernels
    share n_e income states over up to `default_bwd_cluster(n_e)` blocks, the
    forward kernels 2·n_e groups over up to `default_cluster(n_e)`; sizes
    held to that instantiation's shared-memory count."""
    n_e = grid[2]
    forward = any(which in pair for (lib, _), pair in FORWARD_KERNELS.items() if lib == library)
    units, default = ((2 * n_e, default_cluster(n_e)) if forward
                      else (n_e, default_bwd_cluster(n_e)))
    count = _smem_count(library)
    return batch_cluster(B, units, default,
                         lambda C: count(which, *grid, C) <= cuda_build.MAX_SMEM_BYTES,
                         lambda C: cuda_build.max_clusters(library, which, *grid, C))


# The forward kernels, each by (library, tangent): kernel 6 in
# `household_sweep2`, the f64 forward push in `household_sweep2_f64` and that
# push with tangents in the same library.
KERNEL6 = ("household_sweep2", True)
F64_PUSH, F64_PUSH_JVP = ("household_sweep2_f64", False), ("household_sweep2_f64", True)
# The two instantiations of each, by `which` of its library's shared-memory
# count and max-clusters query: the lottery lists in each block's shared
# memory (two sources a thread of 1024), or in a global workspace the
# wrapper allocates (GLOBAL_LISTS; four sources a thread), and the asset
# states (n_b·n_a) each takes; an entry of the global lists, in the
# library's dtype (a float4 in f32; with tangents in f64 a term and its
# tangent).
FORWARD_KERNELS = {KERNEL6: (2, 4), F64_PUSH: (1, 2), F64_PUSH_JVP: (5, 6)}
LIST_ENTRY = {KERNEL6: (4,), F64_PUSH: (), F64_PUSH_JVP: (2,)}
FORWARD_MAX_STATES = (2048, 4096)


def forward_kernel(kernel: tuple, n_b: int, n_a: int, n_e: int) -> int:
    """The forward kernel's instantiation (`FORWARD_KERNELS[kernel]`) a map
    launches at an n_b×n_a×n_e×2 grid, decided by the library's count on the
    default cluster before any launch: the shared-list one where it takes
    the grid (n_b·n_a ≤ 2048 and its count fits a block), else the
    global-list one. Whether that one fits is the builds' check
    (`check_fit_forward`), which raises past it; a launch past it raises."""
    return _forward_choice(kernel, (n_b, n_a, n_e))[0]


def _forward_choice(kernel: tuple, grid) -> tuple:
    """(`forward_kernel`'s instantiation, its count on the default cluster),
    each count asked once."""
    shared, global_lists = FORWARD_KERNELS[kernel]
    count, C = _smem_count(kernel[0]), default_cluster(grid[2])
    if grid[0] * grid[1] <= FORWARD_MAX_STATES[0]:
        need = count(shared, *grid, C)
        if need <= cuda_build.MAX_SMEM_BYTES:
            return shared, need
    return global_lists, count(global_lists, *grid, C)


def check_fit_forward(kernel: tuple, grid, backward: int, what: str, hint: str) -> int:
    """ValueError (ending in `hint`) where a backward kernel of the same
    library (`backward`, on its default cluster) and the forward kernel's
    instantiation
    `forward_kernel` picks do not take an n_b×n_a×n_e grid: past the
    global-list one's asset states (before any count is asked), or past a
    block's shared memory by the library's count. Returns that
    instantiation."""
    n_b, n_a, n_e = grid
    what = f"{what} at grid {n_b}x{n_a}x{n_e}x2"
    if n_b * n_a > FORWARD_MAX_STATES[1]:
        raise ValueError(f"{what} has {n_b * n_a} asset states; the forward kernel takes "
                         f"{FORWARD_MAX_STATES[1]}{hint}")
    which, need = _forward_choice(kernel, grid)
    cuda_build.check_fit(max(_smem_count(kernel[0])(backward, *grid, default_bwd_cluster(n_e)),
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


def _forward_inputs(name, policies, dpolicies, D0, model, dtype=f32):
    tensors = [*(policies[k] for k in KEYS), *(dpolicies[k] for k in KEYS), D0]
    check_tensors(name, tensors, dtype)
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
    which = forward_kernel(KERNEL6, liquid.n, illiq.n, income.n)
    out = _launch_cluster(tensors, Tm1, model, default_cluster(income.n), which)
    count_forward(fused2_forward_jvp, KERNEL6, which)
    return out


fused2_forward_jvp.launches = fused2_forward_jvp.launches_global = 0


def count_forward(wrapper, kernel: tuple, which: int) -> None:
    """One launch of a forward kernel's instantiation `which`: `.launches`
    counts the shared-list one, `.launches_global` the global-list one."""
    if which == FORWARD_KERNELS[kernel][0]:
        wrapper.launches += 1
    else:
        wrapper.launches_global += 1


def lists_scratch(which: int, kernel: tuple, cluster: int, state, lead=()) -> list:
    """The global-list instantiation's workspace shape, (*lead, cluster,
    4·n_b·n_a, *LIST_ENTRY[kernel]) of the library's dtype, or none for the
    shared-list one."""
    if which == FORWARD_KERNELS[kernel][0]:
        return []
    return [(*lead, cluster, 4 * state[0] * state[1], *LIST_ENTRY[kernel])]


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
                                    *lists_scratch(which, KERNEL6, cluster,
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
    which = forward_kernel(KERNEL6, *grid)
    out = _launch_forward_batch(tensors, B, Tm1, D0, model, which,
                                batch_cluster_of("household_sweep2", which, B, grid))
    count_forward(fused2_forward_jvp_batch, KERNEL6, which)
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
                    *lists_scratch(which, KERNEL6, cluster, grid, (B,))]]
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


def check_fit_kernels(model, hint: str = PLAIN_ROUTES) -> int:
    """ValueError (ending in `hint`, the routes that take the grid) where
    kernels 5-6 on their default clusters do not take the model's grid:
    past kernel 6's global-list instantiation's 4096 asset states, or past
    a block's shared memory by the library's count of kernel 5 and of the
    kernel 6 `forward_kernel` picks. A path axis adds nothing to a block.
    Returns that kernel 6 (2 shared lists, 4 global lists)."""
    return check_fit_forward(KERNEL6, _state(model)[:3], 3, "kernels 5-6", hint)


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


def make_fused2_jvp_batch(model, ss_initial, ss_ending, dtype=f32):
    """The direction map of a two-asset ensemble in `dtype`: `_build_fused2`'s
    jvp_dir over B paths in f32, `make_fused2_jvp_dir_f64`'s in f64 (as
    `ops/fused_sweep_batch.make_fused_jvp_batch` is for the one-asset
    family).

    Returns jvp_batch(x_b, v_b, exog_batch) -> `dtype` (B, n): row b is the
    directional derivative of F at x_b[b] along v_b[b] under the shock
    paths {k: exog_batch[k][b]}, (B, T-1) each. The price map's JVP per row
    under `torch.func.vmap`, one launch each of the batched kernels 5 and 6
    (f32) or of the batched tangent pair (f64, `fused2_policies_jvp_f64_batch`
    and `fused2_forward_jvp_f64_batch`), then the assembly and residual
    tail's JVP per row under `torch.func.vmap`, in `dtype`. On the card the
    grid is held to the kernels' shared memory here (`check_fit_kernels`,
    `check_fit_jvp_f64`), before any launch, naming the ensemble's plain
    route (`fused='xla'`) past it, and the instantiations it launches are
    recorded as `jvp_batch.backward_kernel` (f64 only) and
    `jvp_batch.forward_kernel` (None off the card).
    """
    if not supports_fused_sweep2(model):
        raise ValueError("model does not declare the two-asset price hook "
                         "(fused2_prices) and structure the kernels need")
    hook = _fused2_price_hook(model)
    m = cast_model(model, dtype)
    cs = model.compspec
    Tm1 = cs.T - 1
    vars0 = {k: torch.as_tensor(v).to(dtype) for k, v in ss_initial.vars.items()}
    varsT = {k: torch.as_tensor(v).to(dtype) for k, v in ss_ending.vars.items()}
    value_T = ss_ending.value.to(dtype).contiguous()
    D0 = ss_initial.D.to(dtype).contiguous()
    if not value_T.is_cuda:
        kernels = (None, None)
    elif dtype == f32:
        kernels = (None, check_fit_kernels(model, ENSEMBLE_ROUTE))
    else:
        kernels = check_fit_jvp_f64(model, ENSEMBLE_ROUTE)
    backward, forward = ((fused2_policies_jvp_batch, fused2_forward_jvp_batch) if dtype == f32
                         else (fused2_policies_jvp_f64_batch, fused2_forward_jvp_f64_batch))

    def price_jvp(xx, vv, ex):
        def price_map(z):
            return tuple(q.to(dtype) for q in hook(z.reshape(Tm1, cs.n_endog), ex, m))
        return torch.func.jvp(price_map, (xx,), (vv,))

    def tail_jvp(xx, vv, aggs, daggs, ex):
        def tail(z, a):
            return residuals(assemble_full_xmat(z, a, ex, m, vars0, varsT), m)
        return torch.func.jvp(tail, (xx, aggs), (vv, daggs))[1]

    def jvp_batch(x_b, v_b, exog_batch):
        xd, vd = x_b.to(dtype), v_b.to(dtype)
        exd = {k: p.to(dtype) for k, p in exog_batch.items()}
        prices, dprices = torch.func.vmap(price_jvp)(xd, vd, exd)
        pol, dpol = backward(*(q.contiguous() for q in (*prices, *dprices)), value_T, m)
        aggs, daggs = forward(pol, dpol, D0, m)
        return torch.func.vmap(tail_jvp)(xd, vd, aggs, daggs, exd)

    jvp_batch.backward_kernel, jvp_batch.forward_kernel = kernels
    return jvp_batch


# ── The f64 tangent pair (f64 directions on the card) ─────────────────────
# `which` of `cuda_build.sweep2_f64_smem_bytes` for the TANGENT
# instantiations of `csrc/household_sweep2_f64.cu`: the backward recursion
# with its tangent state in shared memory, untabled, with dW and the knots'
# tangents in a global workspace, and that one untabled (the forward push's
# two are FORWARD_KERNELS[F64_PUSH_JVP]).
JVP_F64_BWD, JVP_F64_BWD_UNTABLED, JVP_F64_BWD_GLOBAL, JVP_F64_BWD_GLOBAL_UNTABLED = 4, 7, 8, 9
# What the builds name when the pair does not take a grid.
F64_DIRECTIONS_HINT = ("; direction_mode='xla' takes this grid (torch.func.jvp of the plain "
                       "f64 pipeline)")


def jvp_f64_backward(grid) -> int:
    """The tangent backward instantiation a map launches at an n_b×n_a×n_e
    grid, by the library's count on the default cluster before any launch:
    JVP_F64_BWD where its tangent state fits a block, else
    JVP_F64_BWD_GLOBAL (whether that one fits is `check_fit_jvp_f64`'s)."""
    count = cuda_build.sweep2_f64_smem_bytes(JVP_F64_BWD, *grid, default_bwd_cluster(grid[2]))
    return JVP_F64_BWD if count <= cuda_build.MAX_SMEM_BYTES else JVP_F64_BWD_GLOBAL


def check_fit_jvp_f64(model, hint: str = F64_DIRECTIONS_HINT) -> tuple:
    """ValueError (ending in `hint`: direction_mode='xla' for the single
    path's map, fused='xla' for the ensemble's) where the tangent pair does
    not take the model's grid: past the forward push's 4096 asset states
    (before any count is asked), or past a block's shared memory by the
    library's count of the backward instantiation `jvp_f64_backward` picks
    and of the forward one `forward_kernel` picks, on their default
    clusters. A path axis adds nothing to a block, so the batched pair's
    builds hold the same counts. Returns those two (backward, forward)
    `which`."""
    grid = _state(model)[:3]
    backward = (jvp_f64_backward(grid) if grid[0] * grid[1] <= FORWARD_MAX_STATES[1]
                else JVP_F64_BWD_GLOBAL)
    return backward, check_fit_forward(F64_PUSH_JVP, grid, backward, "the f64 tangent pair",
                                       hint)


def fused2_policies_jvp_f64(r_p, ra_p, w_p, tau_p, dr_p, dra_p, dw_p, dtau_p, value_T, model):
    """Backward dual sweep in FP64: (T-1,) f64 price paths and their
    tangents, value_T (2, n_b, n_a, n_e, 2) f64 without tangent ↦
    (policies, dpolicies), {B, A, C} dicts of (T-1, n_b, n_a, n_e, 2) f64
    paths. What kernel 5 computes in f32, in double.

    On the card: `two_asset_bwd_f64_cluster_kernel<false, true, *>` on one
    cluster of `default_bwd_cluster(n_e)` blocks, its tangent state in
    shared memory (counted in `.launches`) or, where that has no room
    (`jvp_f64_backward`), dW and the knots' tangents in a global workspace
    (`.launches_global`); the policies are the values kernel's
    (`fused_residual2.fused2_policies_f64`) bit for bit. On CPU tensors the
    plain version, `fused2_policies_jvp_reference` in f64."""
    paths = (r_p, ra_p, w_p, tau_p, dr_p, dra_p, dw_p, dtau_p)
    _, state = _policies_inputs("fused2_policies_jvp_f64", paths, value_T, model, f64)
    if value_T.device.type == "cpu":
        return fused2_policies_jvp_reference(*paths, value_T, model)
    which = jvp_f64_backward(state[:3])
    out = _launch_bwd_jvp_f64(paths, value_T, model, which)
    if which == JVP_F64_BWD:
        fused2_policies_jvp_f64.launches += 1
    else:
        fused2_policies_jvp_f64.launches_global += 1
    return out


fused2_policies_jvp_f64.launches = fused2_policies_jvp_f64.launches_global = 0


def _launch_bwd_jvp_f64(paths, value_T, model, which: int, batch: int | None = None,
                        cluster: int | None = None):
    """The tangent backward instantiation `which` (JVP_F64_BWD,
    JVP_F64_BWD_GLOBAL or their untabled branches, which no route asks: the
    card's checks hold them to the tabled ones) on one cluster of
    `default_bwd_cluster(n_e)` blocks, on CUDA tensors; with `batch` paths
    ((B, T-1) paths; the tabled ones only) on B clusters of `cluster`
    blocks, as `fused2_policies_jvp_f64_batch` returns them (views of one
    (B, 6, T-1, ...) output)."""
    liquid, illiq, income, access = _dims(model)
    state = _state(model)
    Tm1 = paths[0].shape[-1]
    cluster = default_bwd_cluster(income.n) if cluster is None else cluster
    lib = cuda_build.load_library("household_sweep2_f64")
    cuda_build.check_shared_memory2_f64(lib, which, *state[:3], cluster)
    dev, p = value_T.device, model.params
    global_state = which in (JVP_F64_BWD_GLOBAL, JVP_F64_BWD_GLOBAL_UNTABLED)
    untabled = which in (JVP_F64_BWD_UNTABLED, JVP_F64_BWD_GLOBAL_UNTABLED)
    lead = () if batch is None else (batch,)
    with torch.cuda.device(dev):
        # The workspace of dW and the knots' tangents: 3 n a block, n the
        # ⌈n_e / cluster⌉·n_b·n_a states it holds room for.
        n = -(-income.n // cluster) * liquid.n * illiq.n
        tws = (torch.empty((*lead, cluster, 3 * n), dtype=f64, device=dev) if global_state
               else None)
        out = torch.empty((*lead, 6, Tm1, *state), dtype=f64, device=dev)
        grids = [t.to(device=dev, dtype=f64).contiguous() for t in
                 (liquid.grid, illiq.grid, income.grid, income.transition)]
        ptrs = [*(t.data_ptr() for t in (*paths, value_T, *grids)),
                None if tws is None else tws.data_ptr(), out.data_ptr(), Tm1, *state[:3], cluster]
        doubles = (float(p["β"]), float(access.transition[0, 1]),
                   float(p.get("portfolio_reg", 0.0)), float(p["borrow_cons"]),
                   torch.cuda.current_stream(dev).cuda_stream)
        if batch is None:
            entry = "hank_sweep2_policies_jvp_f64"
            err = lib.hank_sweep2_policies_jvp_f64(*ptrs, int(global_state), int(untabled),
                                                   *doubles)
        else:
            if untabled:
                raise ValueError("the batched tangent backward has no untabled entry point")
            entry = "hank_sweep2_policies_jvp_f64_batch"
            err = lib.hank_sweep2_policies_jvp_f64_batch(*ptrs, batch, int(global_state),
                                                         *doubles)
    cuda_build.check_launch(lib, err, entry)
    rows = out if batch is None else out.transpose(0, 1)
    return dict(zip(KEYS, rows[:3])), dict(zip(KEYS, rows[3:]))


def fused2_forward_jvp_f64(policies, dpolicies, D0, model):
    """Forward dual push in FP64: {B, A, C} (T-1, n_b, n_a, n_e, 2) f64
    policy paths and tangents, D0 (n_b, n_a, n_e, 2) f64 ↦ (aggs, daggs),
    {B, A, C} dicts of (T-1,) f64 paths. What kernel 6 computes in f32, in
    double.

    On the card: `two_asset_fwd_f64_cluster_kernel<false, *, true>` on one
    cluster of `default_cluster(n_e)` blocks, its lists in shared memory
    (counted in `.launches`) or, where the grid decides so
    (`forward_kernel(F64_PUSH_JVP, ...)`), in a global workspace
    (`.launches_global`); the aggregates are the values kernel's
    (`fused_residual2.fused2_forward_f64`) bit for bit. On CPU tensors the
    plain version, `fused2_forward_jvp_reference` in f64."""
    tensors, Tm1 = _forward_inputs("fused2_forward_jvp_f64", policies, dpolicies, D0, model, f64)
    if D0.device.type == "cpu":
        return fused2_forward_jvp_reference(policies, dpolicies, D0, model)
    grid = _state(model)[:3]
    which = forward_kernel(F64_PUSH_JVP, *grid)
    out = _launch_fwd_jvp_f64(tensors, Tm1, model, which, default_cluster(grid[2]))
    count_forward(fused2_forward_jvp_f64, F64_PUSH_JVP, which)
    return out


fused2_forward_jvp_f64.launches = fused2_forward_jvp_f64.launches_global = 0


def _launch_fwd_jvp_f64(tensors, Tm1, model, which: int, cluster: int):
    """The forward push with tangents, instantiation `which`
    (FORWARD_KERNELS[F64_PUSH_JVP]: shared or global lists), on one cluster of
    `cluster` blocks, on `_forward_inputs`' CUDA tensors (B, A, C, dB, dA,
    dC, D0)."""
    liquid, illiq, income, access = _dims(model)
    state = _state(model)
    lib = cuda_build.load_library("household_sweep2_f64")
    cuda_build.check_shared_memory2_f64(lib, which, *state[:3], cluster)
    dev = tensors[-1].device
    global_lists = which == FORWARD_KERNELS[F64_PUSH_JVP][1]
    with torch.cuda.device(dev):
        # Scratch: each period's D and dD, which the aggregates read after
        # the recursion, and the global-list instantiation's lists.
        Dpath = torch.empty((2, Tm1, tensors[-1].numel()), dtype=f64, device=dev)
        lists = [torch.empty(shape, dtype=f64, device=dev)
                 for shape in lists_scratch(which, F64_PUSH_JVP, cluster, state)]
        out = torch.empty((6, Tm1), dtype=f64, device=dev)
        grids = [t.to(device=dev, dtype=f64).contiguous() for t in
                 (liquid.grid, illiq.grid, income.transition, access.transition)]
        err = lib.hank_sweep2_forward_jvp_f64(
            *(t.data_ptr() for t in (*tensors, *grids, Dpath)),
            lists[0].data_ptr() if lists else None, out.data_ptr(), Tm1, *state[:3], cluster,
            int(global_lists), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "hank_sweep2_forward_jvp_f64")
    return dict(zip(KEYS, out[:3])), dict(zip(KEYS, out[3:]))


def fused2_policies_jvp_f64_batch(r_b, ra_b, w_b, tau_b, dr_b, dra_b, dw_b, dtau_b, value_T,
                                  model):
    """`fused2_policies_jvp_f64` over an ensemble: (B, T-1) f64 price paths
    and their tangents, value_T shared ↦ (policies, dpolicies), {B, A, C}
    dicts of (B, T-1, n_b, n_a, n_e, 2) f64 paths, views of one (B, 6, T-1,
    ...) tensor.

    On the card: one launch of `two_asset_bwd_f64_cluster_kernel<true, true,
    *>`, one cluster per path of `batch_cluster_of`'s size, its tangent
    state in shared memory (`.launches`) or, as `jvp_f64_backward` decides,
    dW and the knots' tangents in a (B, C, 3n) workspace
    (`.launches_global`); row b is bit for bit `fused2_policies_jvp_f64` on
    row b. On CPU tensors the plain version."""
    paths = (r_b, ra_b, w_b, tau_b, dr_b, dra_b, dw_b, dtau_b)
    B, _, state = _batch_inputs("fused2_policies_jvp_f64_batch", paths, value_T, model, f64)
    if value_T.device.type == "cpu":
        return fused2_policies_jvp_f64_batch_reference(*paths, value_T, model)
    which = jvp_f64_backward(state[:3])
    out = _launch_bwd_jvp_f64(paths, value_T, model, which, B,
                              batch_cluster_of("household_sweep2_f64", which, B, state[:3]))
    if which == JVP_F64_BWD:
        fused2_policies_jvp_f64_batch.launches += 1
    else:
        fused2_policies_jvp_f64_batch.launches_global += 1
    return out


fused2_policies_jvp_f64_batch.launches = fused2_policies_jvp_f64_batch.launches_global = 0


def fused2_policies_jvp_f64_batch_reference(r_b, ra_b, w_b, tau_b, dr_b, dra_b, dw_b, dtau_b,
                                            value_T, model):
    """Plain version of the batched tangent backward: a loop over rows of
    `fused2_policies_jvp_reference` in f64."""
    fused2_policies_jvp_f64_batch_reference.calls += 1
    paths = (r_b, ra_b, w_b, tau_b, dr_b, dra_b, dw_b, dtau_b)
    return _stack_rows([fused2_policies_jvp_reference(*(q[b] for q in paths), value_T, model)
                        for b in range(r_b.shape[0])])


fused2_policies_jvp_f64_batch_reference.calls = 0


def fused2_forward_jvp_f64_batch(policies, dpolicies, D0, model):
    """`fused2_forward_jvp_f64` over an ensemble: {B, A, C} (B, T-1, n_b,
    n_a, n_e, 2) f64 policy paths and tangents, D0 shared ↦ (aggs, daggs),
    {B, A, C} dicts of (B, T-1) f64 paths.

    On the card: one launch of `two_asset_fwd_f64_cluster_kernel<true, *,
    true>`, one cluster per path of `batch_cluster_of`'s size, on the
    policies as `fused2_policies_jvp_f64_batch` returns them (other layouts
    are stacked into that one first), its lists in shared memory
    (`.launches`) or, as `forward_kernel` decides, in a (B, C,
    4·n_b·n_a, 2) workspace (`.launches_global`); row b is bit for bit
    `fused2_forward_jvp_f64` on row b. On CPU tensors the plain version."""
    tensors, B, Tm1 = _forward_batch_inputs("fused2_forward_jvp_f64_batch",
                                            (policies, dpolicies), D0, model, f64, KEYS)
    if D0.device.type == "cpu":
        return fused2_forward_jvp_f64_batch_reference(policies, dpolicies, D0, model)
    grid = _state(model)[:3]
    which = forward_kernel(F64_PUSH_JVP, *grid)
    out = _launch_fwd_jvp_f64_batch(tensors, B, Tm1, D0, model, which,
                                    batch_cluster_of("household_sweep2_f64", which, B, grid))
    count_forward(fused2_forward_jvp_f64_batch, F64_PUSH_JVP, which)
    return out


fused2_forward_jvp_f64_batch.launches = fused2_forward_jvp_f64_batch.launches_global = 0


def _launch_fwd_jvp_f64_batch(tensors, B, Tm1, D0, model, which: int, cluster: int):
    """The batched forward push with tangents, instantiation `which`, on B
    clusters of `cluster` blocks, on `_forward_batch_inputs`' CUDA tensors:
    (aggs, daggs) as `fused2_forward_jvp_f64_batch` returns them."""
    liquid, illiq, income, access = _dims(model)
    state = _state(model)
    lib = cuda_build.load_library("household_sweep2_f64")
    cuda_build.check_shared_memory2_f64(lib, which, *state[:3], cluster)
    dev = D0.device
    with torch.cuda.device(dev):
        # Scratch: each path's D and dD of every period, which the
        # aggregates read after the recursion, and the global-list
        # instantiation's lists.
        Dpath = torch.empty((B, 2, Tm1, D0.numel()), dtype=f64, device=dev)
        lists = [torch.empty(shape, dtype=f64, device=dev)
                 for shape in lists_scratch(which, F64_PUSH_JVP, cluster, state, (B,))]
        out = torch.empty((B, 6, Tm1), dtype=f64, device=dev)
        grids = [t.to(device=dev, dtype=f64).contiguous() for t in
                 (liquid.grid, illiq.grid, income.transition, access.transition)]
        err = lib.hank_sweep2_forward_jvp_f64_batch(
            *(t.data_ptr() for t in (path_block(tensors), D0, *grids, Dpath)),
            lists[0].data_ptr() if lists else None, out.data_ptr(), Tm1, *state[:3], cluster, B,
            int(which == FORWARD_KERNELS[F64_PUSH_JVP][1]),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "hank_sweep2_forward_jvp_f64_batch")
    rows = out.transpose(0, 1)
    return dict(zip(KEYS, rows[:3])), dict(zip(KEYS, rows[3:]))


def fused2_forward_jvp_f64_batch_reference(policies, dpolicies, D0, model):
    """Plain version of the batched tangent push: a loop over rows of
    `fused2_forward_jvp_reference` in f64."""
    fused2_forward_jvp_f64_batch_reference.calls += 1
    return _stack_rows([fused2_forward_jvp_reference({k: policies[k][b] for k in KEYS},
                                                     {k: dpolicies[k][b] for k in KEYS},
                                                     D0, model)
                        for b in range(policies["B"].shape[0])])


fused2_forward_jvp_f64_batch_reference.calls = 0


def make_fused2_jvp_dir_f64(model, ss_initial, ss_ending, exog_paths):
    """jvp_dir(x, v) -> f64 directional derivative of F at x along v, through
    the tangent pair: the `fused2_prices` price map by `torch.func.jvp` in
    f64, the household JVP in `fused2_policies_jvp_f64` and
    `fused2_forward_jvp_f64`, the f64 tail (`assemble_full_xmat` +
    `residuals`) by `torch.func.jvp`; the f64 mirror of `_build_fused2`'s
    jvp_dir. On CPU tensors the wrappers run their plain versions (the same
    function as `torch.func.jvp` of the plain f64 F). On the card the grid
    is held to the pair's counts here (`check_fit_jvp_f64`), before any
    launch, and the instantiations it launches are recorded as
    `jvp_dir.backward_kernel` and `jvp_dir.forward_kernel` (None off the
    card)."""
    if not supports_fused_sweep2(model):
        raise ValueError("model does not declare the two-asset price hook "
                         "(fused2_prices) and structure the kernels need")
    hook = _fused2_price_hook(model)
    cs = model.compspec
    Tm1 = cs.T - 1
    value_T = ss_ending.value.to(f64).contiguous()
    D0 = ss_initial.D.to(f64).contiguous()
    kernels = check_fit_jvp_f64(model) if value_T.is_cuda else (None, None)

    def price_map(xx):
        return tuple(q.to(f64) for q in hook(xx.reshape(Tm1, cs.n_endog), exog_paths, model))

    def tail(xx, aggs):
        x_mat = assemble_full_xmat(xx, aggs, exog_paths, model, ss_initial.vars, ss_ending.vars)
        return residuals(x_mat, model)

    def jvp_dir(x, v):
        x64, v64 = x.to(f64), v.to(f64)
        prices, dprices = torch.func.jvp(price_map, (x64,), (v64,))
        pol, dpol = fused2_policies_jvp_f64(*(q.contiguous() for q in (*prices, *dprices)),
                                            value_T, model)
        aggs, daggs = fused2_forward_jvp_f64(pol, dpol, D0, model)
        return torch.func.jvp(tail, (x64, aggs), (v64, daggs))[1]

    jvp_dir.backward_kernel, jvp_dir.forward_kernel = kernels
    return jvp_dir
