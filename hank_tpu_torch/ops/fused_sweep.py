"""Kernel 1: the fused f32 primal + tangent household sweep.

Replaces the TPU kernel `hank_tpu/ops/fused_sweep.py::fused_sweep_jvp`
(`_make_fused_sweep_kernel`). The CUDA source is
`hank_tpu_torch/csrc/household_sweep.cu`, instantiated as `<float, true>`;
it runs the backward EGM recursion and the forward lottery push-forward of
the canonical one-asset CRRA EGM (`ops/egm.crra_egm_step`) with
dual-number arithmetic in one launch, and returns the savings and
consumption aggregate paths and their directional derivatives. Every f32
GMRES matvec of the Newton-Krylov path solver is one launch.

`fused_sweep_jvp` launches the kernel for CUDA tensors and runs the plain
PyTorch version `fused_sweep_jvp_reference` (`torch.func.jvp` through the
f32 blocks plus the budget-rebuilt consumption aggregate) only for CPU
tensors. `fused_sweep_jvp.launches` counts kernel launches and
`fused_sweep_jvp_reference.calls` counts plain-version calls.

A model opts in by defining `fused_prices(xp, exog_paths, model) -> (r, s)`
next to its `ValueFunction` (the hook lookup goes through
`value_fn.__module__`, `hank_tpu/ops/fused_sweep.py:455-467`).
"""

from __future__ import annotations

import sys

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.clip import floor
from hank_tpu_torch.ops.egm import crra_egm_step
from hank_tpu_torch.ops.transition import forward_step

f32 = torch.float32


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


def _check_inputs(name, dtype, paths, V_T, D0, grid, e_grid, Pi):
    """Device, dtype, shape and contiguity checks shared by both kernels."""
    tensors = [*paths, V_T, D0, grid, e_grid, Pi]
    device = V_T.device
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
    Tm1 = paths[0].shape[0]
    n_a, n_e = V_T.shape
    if any(p.shape != (Tm1,) for p in paths) or Tm1 < 1:
        raise ValueError(f"{name}: price paths must all be ({Tm1},) with T-1 ≥ 1")
    if (D0.shape != (n_a, n_e) or grid.shape != (n_a,) or e_grid.shape != (n_e,)
            or Pi.shape != (n_e, n_e) or n_a < 2):
        raise ValueError(f"{name}: expected V_T, D0 (n_a, n_e), grid (n_a,), "
                         f"e_grid (n_e,), Pi (n_e, n_e) with n_a ≥ 2; got "
                         f"{tuple(V_T.shape)}, {tuple(D0.shape)}, {tuple(grid.shape)}, "
                         f"{tuple(e_grid.shape)}, {tuple(Pi.shape)}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return Tm1, n_a, n_e


def fused_sweep_jvp(r_path, w_path, dr_path, dw_path, V_T, D0, grid, e_grid, Pi,
                    *, beta: float, gamma: float, borrow_cons: float):
    """JVP of the household map (r, w paths) ↦ aggregate paths, fused.

    All inputs float32 and contiguous on one device; state arrays in the
    (n_a, n_e) convention. V_T and D0 carry zero tangent (the terminal value
    and the initial distribution are fixed steady-state arrays).

    Returns (agg, dagg, aggc, daggc): the (T-1,) savings and consumption
    aggregates and their directional derivatives.
    """
    Tm1, n_a, n_e = _check_inputs("fused_sweep_jvp", f32,
                                  (r_path, w_path, dr_path, dw_path),
                                  V_T, D0, grid, e_grid, Pi)
    if V_T.device.type == "cpu":
        return fused_sweep_jvp_reference(
            r_path, w_path, dr_path, dw_path, V_T, D0, grid, e_grid, Pi,
            beta=beta, gamma=gamma, borrow_cons=borrow_cons)

    lib = cuda_build.load_library()
    cuda_build.check_shared_memory(lib, True, n_a, n_e)
    dev = V_T.device
    with torch.cuda.device(dev):
        V_eT = V_T.T.contiguous()          # kernel layout (n_e, n_a)
        D_eT = D0.T.contiguous()
        pol = torch.empty((Tm1, n_e, n_a), dtype=f32, device=dev)
        dpol = torch.empty_like(pol)
        out = torch.empty((4, Tm1), dtype=f32, device=dev)
        err = lib.hank_sweep_jvp_f32(
            r_path.data_ptr(), w_path.data_ptr(), dr_path.data_ptr(), dw_path.data_ptr(),
            V_eT.data_ptr(), D_eT.data_ptr(), grid.data_ptr(), e_grid.data_ptr(),
            Pi.data_ptr(), pol.data_ptr(), dpol.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
            Tm1, n_a, n_e, float(beta), float(gamma), float(borrow_cons),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "fused_sweep_jvp")
    fused_sweep_jvp.launches += 1
    return out[0], out[1], out[2], out[3]


fused_sweep_jvp.launches = 0


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


def _build_fused(model, ss_initial, ss_ending, exog_paths):
    """Kernel-1 entry points (`hank_tpu/ops/fused_sweep.py:505-592`).

    Returns (jvp_dir, residual32):
      jvp_dir(x, v) -> f32 directional derivative of F at x along v: the
        household JVP in the kernel, the price map and the assembly +
        residual tail by `torch.func.jvp` in f32 (the reference's f32 tail).
      residual32(x) -> f32 F(x) through the same kernel with zero tangent.
    """
    if not supports_fused_sweep(model):
        raise ValueError("model does not declare the canonical one-asset EGM "
                         "price hook (fused_prices) the household sweep needs")
    cs = model.compspec
    Tm1 = cs.T - 1
    policy_var, c_key = aggregate_keys(model)
    wealth = model.endog_dims()[0]
    prod = model.exog_dims()[0]
    p = model.params
    hook = _fused_price_hook(model)

    grid32 = wealth.grid.to(f32).contiguous()
    e32 = prod.grid.to(f32).contiguous()
    Pi32 = prod.transition.to(f32).contiguous()
    V32 = ss_ending.value.to(f32).contiguous()
    D32 = ss_initial.D.to(f32).contiguous()
    exog32 = {k: v.to(f32) for k, v in exog_paths.items()}
    vars0 = {k: torch.as_tensor(v).to(f32) for k, v in ss_initial.vars.items()}
    varsT = {k: torch.as_tensor(v).to(f32) for k, v in ss_ending.vars.items()}

    def price_map(xx):
        r, s = hook(xx.reshape(Tm1, cs.n_endog), exog32, model)
        return r.to(f32), s.to(f32)

    def sweep(x32, v32):
        (r, s), (dr, ds) = torch.func.jvp(price_map, (x32,), (v32,))
        agg, dagg, aggc, daggc = fused_sweep_jvp(
            r.contiguous(), s.contiguous(), dr.contiguous(), ds.contiguous(),
            V32, D32, grid32, e32, Pi32, beta=float(p["β"]),
            gamma=float(p["γ"]), borrow_cons=float(p["borrow_cons"]))
        aggs, daggs = {policy_var: agg}, {policy_var: dagg}
        if c_key is not None:
            aggs[c_key], daggs[c_key] = aggc, daggc
        return aggs, daggs

    def tail(xx, aggs):
        x_mat = assemble_full_xmat(xx, aggs, exog32, model, vars0, varsT)
        return residuals(x_mat, model)

    def jvp_dir(x, v):
        x32, v32 = x.to(f32), v.to(f32)
        aggs, daggs = sweep(x32, v32)
        return torch.func.jvp(tail, (x32, aggs), (v32, daggs))[1]

    def residual32(x):
        x32 = x.to(f32)
        aggs, _ = sweep(x32, torch.zeros_like(x32))
        return tail(x32, aggs)

    return jvp_dir, residual32


def make_fused_jvp_dir(model, ss_initial, ss_ending, exog_paths):
    """jvp_dir(x, v) through kernel 1 (see `_build_fused`)."""
    return _build_fused(model, ss_initial, ss_ending, exog_paths)[0]


def make_fused_residual_fn(model, ss_initial, ss_ending, exog_paths):
    """f32 F(x) through kernel 1 with zero tangent (see `_build_fused`)."""
    return _build_fused(model, ss_initial, ss_ending, exog_paths)[1]
