"""Kernel 1: the fused f32 primal + tangent household sweep.

Replaces the TPU kernel `hank_tpu/ops/fused_sweep.py::fused_sweep_jvp`
(`_make_fused_sweep_kernel`). The CUDA source is
`hank_tpu_torch/csrc/household_sweep.cu`, `household_sweep_jvp_kernel`;
it runs the backward EGM recursion and the forward lottery push-forward of
the canonical one-asset CRRA EGM (`ops/egm.crra_egm_step`) with
dual-number arithmetic in one launch, and returns the savings and
consumption aggregate paths and their directional derivatives. Every f32
GMRES matvec of the Newton-Krylov path solver is one launch. It brackets
by binary search and sums the lottery over source ranges where the rows
are monotone, and is bit for bit the counting kernel template's
`<float, true>` B = 1 launch (`fused_sweep_batch.fused_sweep_jvp_batch_previous`
on one row).

`fused_sweep_jvp` launches the kernel for CUDA tensors and runs the plain
PyTorch version `fused_sweep_jvp_reference` (`torch.func.jvp` through the
f32 blocks plus the budget-rebuilt consumption aggregate) only for CPU
tensors. `fused_sweep_jvp.launches` counts kernel launches and
`fused_sweep_jvp_reference.calls` counts plain-version calls.

`fused_sweep_jvp_f64` is the same sweep in f64, primal and tangent
(`household_sweep_ranged_kernel<double, true, false>`), the port's own
kernel: the reference takes its f64 directions by XLA AD of the f64
pipeline (`hank_tpu/solvers/newton.py:389`), with no Pallas kernel. Its
plain version is `fused_sweep_jvp_reference` in f64, and it is held bit for
bit to the counting template's `<double, true, false>` launch
(`fused_sweep_jvp_f64_previous`) on the card. `make_fused_jvp_dir_f64` is
the f64 direction map around it.

Every kernel map over the sweep is built through `sweep_setup`, which on
the card decides by the model's grid, with the library's shared-memory
counts, which instantiation the map launches (`sweep_kernel`): the
one-block kernel where its shared memory takes the grid, else its
global-state instantiation (`household_sweep_ranged_kernel<S, TANGENT,
BATCHED, true>`, the six state arrays in a global workspace the wrapper
allocates, bit for bit the one-block kernel where both fit), and past that
one's count ValueError when the map is built, before a solve starts. No
route falls back to a plain version on the card. The reference probes its
kernel and degrades to XLA instead (`hank_tpu/solvers/newton.py:356-376,
431-450`). Each wrapper takes the same decision at each launch, by shape;
`.launches` counts its one-block launches and `.launches_global` its
global-state ones. The `_global` entry points (`fused_sweep_jvp_global`,
`fused_sweep_jvp_f64_global`) launch the global-state instantiation at any
grid, for the checks that hold it to the one-block kernel; no solver
calls them.

A model opts in by defining `fused_prices(xp, exog_paths, model) -> (r, s)`
next to its `ValueFunction` (the hook lookup goes through
`value_fn.__module__`, `hank_tpu/ops/fused_sweep.py:455-467`).
"""

from __future__ import annotations

import sys
from typing import Callable, NamedTuple

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.clip import floor
from hank_tpu_torch.ops.egm import crra_egm_step
from hank_tpu_torch.ops.transition import forward_step

f32, f64 = torch.float32, torch.float64


def household_aggregates(r_path, w_path, V_T, D0, grid, e_grid, Pi,
                         beta, gamma, borrow_cons):
    """Plain PyTorch household sweep in the inputs' dtype: (T-1,) savings
    and consumption aggregates. The consumption policy is rebuilt from the
    budget with the same-period prices and aggregated against the
    post-transition distribution (`hank_tpu/ops/fused_sweep.py:364-374`)."""
    Tm1 = r_path.shape[0]
    V = V_T
    pols = [None] * Tm1
    for t in range(Tm1 - 1, -1, -1):
        V, pols[t] = crra_egm_step(V, r_path[t], w_path[t], grid, e_grid, Pi,
                                   beta, gamma, borrow_cons)
    D = D0
    agg, aggc = [], []
    for t in range(Tm1):
        D = forward_step(pols[t], D, grid, [Pi])
        agg.append(torch.sum(pols[t] * D))
        c = floor((1.0 + r_path[t]) * grid[:, None] + w_path[t] * e_grid[None, :]
                  - pols[t], 1e-12)
        aggc.append(torch.sum(c * D))
    return torch.stack(agg), torch.stack(aggc)


def check_tensors(name, tensors, dtype) -> None:
    """Type, device, dtype and contiguity checks shared by every kernel
    wrapper (`ops/fused_sweep2.py` too): contiguous `dtype` tensors on one
    CPU or CUDA device."""
    device = tensors[0].device
    for x in tensors:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(x).__name__}")
        if x.device != device:
            raise ValueError(f"{name}: all inputs must be on one device "
                             f"({x.device} vs {device})")
        if x.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


def _check_inputs(name, dtype, paths, V_T, D0, grid, e_grid, Pi, *, batched=False):
    """Device, dtype, shape and contiguity checks shared by the one-asset
    kernels' wrappers. Price paths are (T-1,) each, or (B, T-1) when
    `batched`."""
    check_tensors(name, [V_T, *paths, D0, grid, e_grid, Pi], dtype)
    shape = tuple(paths[0].shape)
    if (len(shape) != (2 if batched else 1) or min(shape) < 1
            or any(p.shape != shape for p in paths)):
        want = "(B, T-1) with B ≥ 1" if batched else "(T-1,)"
        raise ValueError(f"{name}: price paths must all be {want} with T-1 ≥ 1; "
                         f"got {[tuple(p.shape) for p in paths]}")
    n_a, n_e = V_T.shape
    if (D0.shape != (n_a, n_e) or grid.shape != (n_a,) or e_grid.shape != (n_e,)
            or Pi.shape != (n_e, n_e) or n_a < 2):
        raise ValueError(f"{name}: expected V_T, D0 (n_a, n_e), grid (n_a,), "
                         f"e_grid (n_e,), Pi (n_e, n_e) with n_a ≥ 2; got "
                         f"{tuple(V_T.shape)}, {tuple(D0.shape)}, {tuple(grid.shape)}, "
                         f"{tuple(e_grid.shape)}, {tuple(Pi.shape)}")


def state_workspace_bytes(dtype, tangent: bool, n_a: int, n_e: int, B: int = 1) -> int:
    """Bytes of the global workspace a global-state launch takes: the six
    (three without a tangent) n_a·n_e state arrays of each of B paths."""
    return torch.empty((), dtype=dtype).element_size() * (6 if tangent else 3) * n_a * n_e * B


def launch_sweep(entry, paths, V_T, D0, grid, e_grid, Pi, *, n_out, beta, gamma,
                 borrow_cons, smem_kind, extra_ptrs=()):
    """Launch one entry point of `csrc/household_sweep.cu` on checked CUDA
    tensors and return its `n_out` output paths, each of the price paths'
    shape. `paths` are (r, w) or (r, w, dr, dw), (T-1,) each for a
    single-path entry point and (B, T-1) for a `_batch` one; the wrapper
    allocates the policy scratch, one (*shape, n_e, n_a) buffer for the
    policies and one for their tangents. `smem_kind` names the kernel for
    the shared-memory check (`cuda_build.check_shared_memory`); a
    global-state one (`cuda_build.GLOBAL_STATE`'s values) launches the
    entry point's `_global` twin with its state workspace
    (`state_workspace_bytes`) after `extra_ptrs`, which follow the
    outputs."""
    lib = cuda_build.load_library()
    n_a, n_e = V_T.shape
    cuda_build.check_shared_memory(lib, smem_kind, n_a, n_e)
    shape = tuple(paths[0].shape)
    dev = V_T.device
    global_state = smem_kind in cuda_build.GLOBAL_STATE.values()
    with torch.cuda.device(dev):
        V_eT = V_T.T.contiguous()          # kernel layout (n_e, n_a)
        D_eT = D0.T.contiguous()
        scratch = [torch.empty((*shape, n_e, n_a), dtype=V_T.dtype, device=dev)
                   for _ in range(len(paths) // 2)]
        out = torch.empty((n_out, *shape), dtype=V_T.dtype, device=dev)
        ptrs = [t.data_ptr() for t in (*paths, V_eT, D_eT, grid, e_grid, Pi,
                                       *scratch, *out)] + list(extra_ptrs)
        if global_state:
            entry = f"{entry}_global"
            B = shape[0] if len(shape) == 2 else 1
            state = torch.empty(state_workspace_bytes(V_T.dtype, len(paths) == 4, n_a, n_e, B),
                                dtype=torch.uint8, device=dev)
            ptrs.append(state.data_ptr())
        err = getattr(lib, entry)(
            *ptrs, *shape, n_a, n_e, float(beta), float(gamma), float(borrow_cons),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, entry)
    return tuple(out)


def count_launch(wrapper, which: int, kernel: int) -> None:
    """One launch of `kernel` by the wrapper of one-block kernel `which`:
    `.launches` counts the one-block kernel, `.launches_global` its
    global-state instantiation."""
    if kernel == which:
        wrapper.launches += 1
    else:
        wrapper.launches_global += 1


def fallback_pointer(name, fallback_rows, V_T, shape) -> list:
    """`launch_sweep`'s extra pointer for a kernel that counts the rows
    taking its fallback branches: null, or `fallback_rows` checked to be a
    contiguous int32 tensor of `shape` on the inputs' CUDA device. The
    plain versions have no such branches, so on CPU tensors it must be
    None."""
    if fallback_rows is None:
        return [0]
    if V_T.device.type == "cpu":
        raise ValueError(f"{name}: fallback_rows counts branches of the CUDA kernel; "
                         "the plain version has none")
    if (not isinstance(fallback_rows, torch.Tensor) or fallback_rows.dtype != torch.int32
            or tuple(fallback_rows.shape) != shape or fallback_rows.device != V_T.device
            or not fallback_rows.is_contiguous()):
        raise ValueError(f"{name}: fallback_rows must be a contiguous {shape} int32 "
                         "tensor on the inputs' device")
    return [fallback_rows.data_ptr()]


def require_card(name, V_T, plain) -> None:
    """The previous kernels and the `_global` entry points run on the card
    only: their plain version is `plain`, the wrapper's."""
    if V_T.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on the card only; "
                         f"{plain} is the plain version")


def fused_sweep_jvp(r_path, w_path, dr_path, dw_path, V_T, D0, grid, e_grid, Pi,
                    *, beta: float, gamma: float, borrow_cons: float,
                    fallback_rows: torch.Tensor | None = None):
    """JVP of the household map (r, w paths) ↦ aggregate paths, fused.

    All inputs float32 and contiguous on one device; state arrays in the
    (n_a, n_e) convention. V_T and D0 carry zero tangent (the terminal value
    and the initial distribution are fixed steady-state arrays).

    fallback_rows: optional (2,) int32 CUDA tensor; the kernel writes into
    it how many (period, income row) pairs had implied-wealth knots [0] and
    clamped policies [1] that were not non-decreasing, and so took the
    count loop and the full source scan. The plain version has no such
    branches and refuses it.

    On CUDA tensors the grid decides (`sweep_kernel`): kernel 1 where its
    shared memory takes it, else `household_sweep_ranged_kernel<float,
    true, false, true>` (`fused_sweep_jvp_global` launches the latter at
    any grid).

    Returns (agg, dagg, aggc, daggc): the (T-1,) savings and consumption
    aggregates and their directional derivatives.
    """
    paths = (r_path, w_path, dr_path, dw_path)
    _check_inputs("fused_sweep_jvp", f32, paths, V_T, D0, grid, e_grid, Pi)
    fallback = fallback_pointer("fused_sweep_jvp", fallback_rows, V_T, (2,))
    kw = dict(beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    if V_T.device.type == "cpu":
        return fused_sweep_jvp_reference(*paths, V_T, D0, grid, e_grid, Pi, **kw)
    kernel = sweep_kernel(cuda_build.KERNEL1, *V_T.shape)
    out = launch_sweep("hank_sweep_jvp_f32", paths, V_T, D0, grid, e_grid, Pi,
                       n_out=4, smem_kind=kernel, extra_ptrs=fallback, **kw)
    count_launch(fused_sweep_jvp, cuda_build.KERNEL1, kernel)
    return out


fused_sweep_jvp.launches = fused_sweep_jvp.launches_global = 0


def fused_sweep_jvp_global(r_path, w_path, dr_path, dw_path, V_T, D0, grid, e_grid, Pi,
                           *, beta: float, gamma: float, borrow_cons: float,
                           fallback_rows: torch.Tensor | None = None):
    """`fused_sweep_jvp` through `household_sweep_ranged_kernel<float, true,
    false, true>` at any grid: kernel 1's place past its shared memory,
    held to kernel 1 bit for bit. No solver calls it. CUDA tensors only;
    counted in `fused_sweep_jvp.launches_global`."""
    paths = (r_path, w_path, dr_path, dw_path)
    _check_inputs("fused_sweep_jvp_global", f32, paths, V_T, D0, grid, e_grid, Pi)
    require_card("fused_sweep_jvp_global", V_T, "fused_sweep_jvp_reference")
    fallback = fallback_pointer("fused_sweep_jvp_global", fallback_rows, V_T, (2,))
    out = launch_sweep("hank_sweep_jvp_f32", paths, V_T, D0, grid, e_grid, Pi, n_out=4,
                       smem_kind=cuda_build.GLOBAL_KERNEL1, extra_ptrs=fallback,
                       beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    fused_sweep_jvp.launches_global += 1
    return out


def fused_sweep_jvp_reference(r_path, w_path, dr_path, dw_path, V_T, D0, grid,
                              e_grid, Pi, *, beta: float, gamma: float,
                              borrow_cons: float):
    """Plain PyTorch version of kernel 1: `torch.func.jvp` through the
    household blocks, in the inputs' dtype (`tests/test_fused_sweep.py:59-103`
    validates the TPU kernel the same way)."""
    fused_sweep_jvp_reference.calls += 1

    def f(r, w):
        return household_aggregates(r, w, V_T, D0, grid, e_grid, Pi,
                                    beta, gamma, borrow_cons)

    (agg, aggc), (dagg, daggc) = torch.func.jvp(f, (r_path, w_path), (dr_path, dw_path))
    return agg, dagg, aggc, daggc


fused_sweep_jvp_reference.calls = 0


def fused_sweep_jvp_f64(r_path, w_path, dr_path, dw_path, V_T, D0, grid, e_grid, Pi,
                        *, beta: float, gamma: float, borrow_cons: float,
                        fallback_rows: torch.Tensor | None = None):
    """`fused_sweep_jvp` in float64: all inputs float64, the same outputs
    and `fallback_rows` (a (2,) int32 CUDA tensor, refused on CPU tensors).
    On the card `household_sweep_ranged_kernel<double, true, false>`, or
    past its shared memory its global-state instantiation
    (`fused_sweep_jvp_f64_global` launches that one at any grid); on CPU
    tensors the plain version `fused_sweep_jvp_reference` in f64."""
    paths = (r_path, w_path, dr_path, dw_path)
    _check_inputs("fused_sweep_jvp_f64", f64, paths, V_T, D0, grid, e_grid, Pi)
    fallback = fallback_pointer("fused_sweep_jvp_f64", fallback_rows, V_T, (2,))
    kw = dict(beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    if V_T.device.type == "cpu":
        return fused_sweep_jvp_reference(*paths, V_T, D0, grid, e_grid, Pi, **kw)
    kernel = sweep_kernel(cuda_build.JVP_F64, *V_T.shape)
    out = launch_sweep("hank_sweep_jvp_f64", paths, V_T, D0, grid, e_grid, Pi,
                       n_out=4, smem_kind=kernel, extra_ptrs=fallback, **kw)
    count_launch(fused_sweep_jvp_f64, cuda_build.JVP_F64, kernel)
    return out


fused_sweep_jvp_f64.launches = fused_sweep_jvp_f64.launches_global = 0


def fused_sweep_jvp_f64_global(r_path, w_path, dr_path, dw_path, V_T, D0, grid, e_grid,
                               Pi, *, beta: float, gamma: float, borrow_cons: float,
                               fallback_rows: torch.Tensor | None = None):
    """`fused_sweep_jvp_f64` through `household_sweep_ranged_kernel<double,
    true, false, true>` at any grid, held to `<double, true, false>` bit for
    bit. No solver calls it. CUDA tensors only; counted in
    `fused_sweep_jvp_f64.launches_global`."""
    paths = (r_path, w_path, dr_path, dw_path)
    _check_inputs("fused_sweep_jvp_f64_global", f64, paths, V_T, D0, grid, e_grid, Pi)
    require_card("fused_sweep_jvp_f64_global", V_T, "fused_sweep_jvp_reference")
    fallback = fallback_pointer("fused_sweep_jvp_f64_global", fallback_rows, V_T, (2,))
    out = launch_sweep("hank_sweep_jvp_f64", paths, V_T, D0, grid, e_grid, Pi, n_out=4,
                       smem_kind=cuda_build.GLOBAL_JVP_F64, extra_ptrs=fallback,
                       beta=beta, gamma=gamma, borrow_cons=borrow_cons)
    fused_sweep_jvp_f64.launches_global += 1
    return out


def fused_sweep_jvp_f64_previous(r_path, w_path, dr_path, dw_path, V_T, D0, grid, e_grid,
                                 Pi, *, beta: float, gamma: float, borrow_cons: float):
    """The counting template's `<double, true, false>` launch
    (`household_sweep_kernel`, which counts brackets and scans every
    source), with `fused_sweep_jvp_f64`'s arguments and outputs: the
    yardstick it is held to bit for bit. No solver calls it. CUDA tensors
    only."""
    paths = (r_path, w_path, dr_path, dw_path)
    _check_inputs("fused_sweep_jvp_f64_previous", f64, paths, V_T, D0, grid, e_grid, Pi)
    require_card("fused_sweep_jvp_f64_previous", V_T, "fused_sweep_jvp_reference")
    out = launch_sweep("hank_sweep_jvp_f64_previous", paths, V_T, D0, grid, e_grid, Pi,
                       n_out=4, smem_kind=cuda_build.PREVIOUS_JVP_F64, beta=beta,
                       gamma=gamma, borrow_cons=borrow_cons)
    fused_sweep_jvp_f64_previous.launches += 1
    return out


fused_sweep_jvp_f64_previous.launches = 0


def _fused_price_hook(model):
    """The model's `fused_prices(xp, exog_paths, model)` hook, or None.
    Defining it declares the Bellman step to be the canonical one-asset
    CRRA EGM of the kernels under the returned (r, s) prices."""
    mod = sys.modules.get(getattr(model.value_fn, "__module__", ""))
    return getattr(mod, "fused_prices", None)


def supports_fused_sweep(model) -> bool:
    """True iff `model` declares the price hook and has one endogenous and
    one exogenous household dimension, CRRA parameters and the savings
    [+ one consumption] heterogeneous variables."""
    if _fused_price_hook(model) is None:
        return False
    if not (len(model.endog_dims()) == 1 and len(model.exog_dims()) == 1
            and {"β", "γ", "borrow_cons"} <= set(model.params)):
        return False
    het = model.vars_of_type("heterogeneous")
    return model.endog_dims()[0].policy_var in het and len(het) <= 2


def aggregate_keys(model) -> tuple[str, str | None]:
    """(savings variable, consumption variable or None) of a supported model."""
    het = model.vars_of_type("heterogeneous")
    policy_var = model.endog_dims()[0].policy_var
    extra = [k for k in het if k != policy_var]
    if len(extra) > 1:
        raise ValueError("the household sweep aggregates the savings policy "
                         "plus at most one consumption variable")
    return policy_var, (extra[0] if extra else None)


# The one-asset sweep's kernel maps, by `cuda_build`'s `which`.
KERNEL_NAMES = {cuda_build.KERNEL1: "kernel 1 (the f32 tangent sweep)",
                cuda_build.KERNELS3_4: "kernels 3-4 (the batched f32 tangent sweep)",
                cuda_build.KERNEL2: "kernel 2 (the f64 residual sweep)",
                cuda_build.JVP_F64: "the f64 tangent sweep",
                cuda_build.GLOBAL_KERNEL1: "the global-state f32 tangent sweep",
                cuda_build.GLOBAL_KERNELS3_4: "the global-state batched f32 tangent sweep",
                cuda_build.GLOBAL_KERNEL2: "the global-state f64 residual sweep",
                cuda_build.GLOBAL_JVP_F64: "the global-state f64 tangent sweep"}
PLAIN_ROUTES = ("; on the card only the plain routes take this grid "
                "(direction_mode='xla', residual_mode='f64')")


def sweep_kernel(which: int, n_a: int, n_e: int) -> int:
    """The kernel a map over one-block kernel `which` launches at an n_a×n_e
    grid, decided by the library's shared-memory counts before any launch:
    `which` where one block holds it, else its global-state instantiation
    (`cuda_build.GLOBAL_STATE`), and ValueError, naming that one and the
    plain routes, where its count does not fit either."""
    if cuda_build.sweep_smem_bytes(which, n_a, n_e) <= cuda_build.MAX_SMEM_BYTES:
        return which
    kernel = cuda_build.GLOBAL_STATE[which]
    cuda_build.check_fit(cuda_build.sweep_smem_bytes(kernel, n_a, n_e),
                         f"{KERNEL_NAMES[kernel]} at grid {n_a}x{n_e}", PLAIN_ROUTES)
    return kernel


class SweepSetup(NamedTuple):
    """`sweep_setup`'s result: the model's `fused_prices` hook; the shared
    kernel inputs (V_T, D0, grid, e_grid, Pi), contiguous; the kernels' CRRA
    parameters; to_aggs(agg, aggc), the {variable: path} mapping of the
    sweep's aggregates that the assembly takes; and the kernel the map
    launches on the card (`sweep_kernel`; None off the card or without
    `which`)."""

    hook: Callable
    consts: list
    kw: dict
    to_aggs: Callable
    kernel: int | None


def sweep_setup(model, ss_initial, ss_ending, dtype, which: int | None = None) -> SweepSetup:
    """What `_build_fused` and the `make_*` functions over the household
    sweep take from a supported model, with the steady-state arrays in
    `dtype`. With `which` (the one-block kernel the map launches,
    `cuda_build`'s numbering) and the arrays on the card, the kernel it
    launches at the model's grid (`sweep_kernel`: `which` or its
    global-state instantiation), and ValueError where neither one's shared
    memory takes the grid.
    """
    if not supports_fused_sweep(model):
        raise ValueError("model does not declare the canonical one-asset EGM "
                         "price hook (fused_prices) the household sweep needs")
    policy_var, c_key = aggregate_keys(model)
    wealth, prod = model.endog_dims()[0], model.exog_dims()[0]
    p = model.params
    consts = [t.to(dtype).contiguous() for t in
              (ss_ending.value, ss_initial.D, wealth.grid, prod.grid, prod.transition)]
    kw = dict(beta=float(p["β"]), gamma=float(p["γ"]), borrow_cons=float(p["borrow_cons"]))
    kernel = None
    if which is not None and consts[0].is_cuda:
        kernel = sweep_kernel(which, wealth.n, prod.n)

    def to_aggs(agg, aggc):
        return {policy_var: agg} if c_key is None else {policy_var: agg, c_key: aggc}

    return SweepSetup(_fused_price_hook(model), consts, kw, to_aggs, kernel)


def _build_fused(model, ss_initial, ss_ending, exog_paths, dtype=f32):
    """The direction map through the household sweep in `dtype`
    (`hank_tpu/ops/fused_sweep.py:505-592` for f32): kernel 1 in f32,
    `fused_sweep_jvp_f64` in f64, each or its global-state instantiation
    as `sweep_setup` decides.

    Returns (jvp_dir, residual):
      jvp_dir(x, v) -> `dtype` directional derivative of F at x along v: the
        household JVP in the kernel, the price map and the assembly +
        residual tail by `torch.func.jvp` in `dtype` (the reference's f32
        tail; in f64 the f64 pipeline's).
      residual(x) -> `dtype` F(x) through the same kernel with zero tangent.
    """
    which = cuda_build.KERNEL1 if dtype == f32 else cuda_build.JVP_F64
    hook, consts, kw, to_aggs, _ = sweep_setup(model, ss_initial, ss_ending, dtype, which)
    kernel = fused_sweep_jvp if dtype == f32 else fused_sweep_jvp_f64
    cs = model.compspec
    Tm1 = cs.T - 1
    exog_d = {k: v.to(dtype) for k, v in exog_paths.items()}
    vars0 = {k: torch.as_tensor(v).to(dtype) for k, v in ss_initial.vars.items()}
    varsT = {k: torch.as_tensor(v).to(dtype) for k, v in ss_ending.vars.items()}

    def price_map(xx):
        r, s = hook(xx.reshape(Tm1, cs.n_endog), exog_d, model)
        return r.to(dtype), s.to(dtype)

    def sweep(x_d, v_d):
        (r, s), (dr, ds) = torch.func.jvp(price_map, (x_d,), (v_d,))
        agg, dagg, aggc, daggc = kernel(
            r.contiguous(), s.contiguous(), dr.contiguous(), ds.contiguous(),
            *consts, **kw)
        return to_aggs(agg, aggc), to_aggs(dagg, daggc)

    def tail(xx, aggs):
        x_mat = assemble_full_xmat(xx, aggs, exog_d, model, vars0, varsT)
        return residuals(x_mat, model)

    def jvp_dir(x, v):
        x_d, v_d = x.to(dtype), v.to(dtype)
        aggs, daggs = sweep(x_d, v_d)
        return torch.func.jvp(tail, (x_d, aggs), (v_d, daggs))[1]

    def residual(x):
        x_d = x.to(dtype)
        aggs, _ = sweep(x_d, torch.zeros_like(x_d))
        return tail(x_d, aggs)

    return jvp_dir, residual


def make_fused_jvp_dir(model, ss_initial, ss_ending, exog_paths):
    """f32 jvp_dir(x, v) through kernel 1 (see `_build_fused`)."""
    return _build_fused(model, ss_initial, ss_ending, exog_paths)[0]


def make_fused_jvp_dir_f64(model, ss_initial, ss_ending, exog_paths):
    """f64 jvp_dir(x, v) through `fused_sweep_jvp_f64` (see `_build_fused`)."""
    return _build_fused(model, ss_initial, ss_ending, exog_paths, f64)[0]


def make_fused_residual_fn(model, ss_initial, ss_ending, exog_paths):
    """f32 F(x) through kernel 1 with zero tangent (see `_build_fused`)."""
    return _build_fused(model, ss_initial, ss_ending, exog_paths)[1]
