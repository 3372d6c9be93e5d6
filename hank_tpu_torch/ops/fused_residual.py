"""Kernel 2: the full-precision household residual sweep in native FP64.

Replaces the TPU kernel `hank_tpu/ops/fused_ds.py::fused_ds_residual_sweep`
(`_make_fused_ds_kernel`), which carried double-single f32 pairs because the
TPU has no f64 hardware. The H100 has native FP64, so this is the same
recursion as kernel 1 (`csrc/household_sweep.cu`, instantiated as
`<double, false>`): values only, no tangent, general `pow` — the integer-γ
gate, `ops/ds.py` and the interpret-mode `pure_callback` fence of the
reference are gone.

`fused_residual_sweep` launches the kernel for CUDA tensors and runs the
plain PyTorch version `fused_residual_sweep_reference` (the f64 household
blocks) only for CPU tensors. `make_sweep_residual_fn` is the reference's
`make_ds_residual_fn` F (`hank_tpu/ops/fused_ds.py:497-507`): every
full-precision F(x) of the path solver.
"""

from __future__ import annotations

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_sweep import (_check_inputs, _fused_price_hook,
                                            aggregate_keys, household_aggregates,
                                            supports_fused_sweep)

f64 = torch.float64


def fused_residual_sweep(r_path, w_path, V_T, D0, grid, e_grid, Pi,
                         *, beta: float, gamma: float, borrow_cons: float):
    """(r, w) f64 price paths ↦ (agg, aggc): the (T-1,) f64 savings and
    consumption aggregate paths. Inputs float64, contiguous, on one device;
    state arrays (n_a, n_e)."""
    Tm1, n_a, n_e = _check_inputs("fused_residual_sweep", f64, (r_path, w_path),
                                  V_T, D0, grid, e_grid, Pi)
    if V_T.device.type == "cpu":
        return fused_residual_sweep_reference(
            r_path, w_path, V_T, D0, grid, e_grid, Pi,
            beta=beta, gamma=gamma, borrow_cons=borrow_cons)

    lib = cuda_build.load_library()
    cuda_build.check_shared_memory(lib, False, n_a, n_e)
    dev = V_T.device
    with torch.cuda.device(dev):
        V_eT = V_T.T.contiguous()          # kernel layout (n_e, n_a)
        D_eT = D0.T.contiguous()
        pol = torch.empty((Tm1, n_e, n_a), dtype=f64, device=dev)
        out = torch.empty((2, Tm1), dtype=f64, device=dev)
        err = lib.hank_sweep_residual_f64(
            r_path.data_ptr(), w_path.data_ptr(), V_eT.data_ptr(), D_eT.data_ptr(),
            grid.data_ptr(), e_grid.data_ptr(), Pi.data_ptr(), pol.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), Tm1, n_a, n_e,
            float(beta), float(gamma), float(borrow_cons),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "fused_residual_sweep")
    fused_residual_sweep.launches += 1
    return out[0], out[1]


fused_residual_sweep.launches = 0


def fused_residual_sweep_reference(r_path, w_path, V_T, D0, grid, e_grid, Pi,
                                   *, beta: float, gamma: float, borrow_cons: float):
    """Plain PyTorch version of kernel 2: the household blocks in the
    inputs' dtype."""
    fused_residual_sweep_reference.calls += 1
    return household_aggregates(r_path, w_path, V_T, D0, grid, e_grid, Pi,
                                beta, gamma, borrow_cons)


fused_residual_sweep_reference.calls = 0


def make_sweep_residual_fn(model, ss_initial, ss_ending, exog_paths):
    """F(x) -> f64 residual with the household block in kernel 2; the price
    map and the residual tail (assembly + equations over the (n_v, T)
    matrix) run in f64 torch ops."""
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
    consts = [t.to(f64).contiguous() for t in
              (ss_ending.value, ss_initial.D, wealth.grid, prod.grid, prod.transition)]

    def F(x):
        x64 = x.to(f64)
        r, s = hook(x64.reshape(Tm1, cs.n_endog), exog_paths, model)
        agg, aggc = fused_residual_sweep(
            r.to(f64).contiguous(), s.to(f64).contiguous(), *consts,
            beta=float(p["β"]), gamma=float(p["γ"]),
            borrow_cons=float(p["borrow_cons"]))
        aggs = {policy_var: agg}
        if c_key is not None:
            aggs[c_key] = aggc
        x_mat = assemble_full_xmat(x64, aggs, exog_paths, model,
                                   ss_initial.vars, ss_ending.vars)
        return residuals(x_mat, model)

    return F
