"""Kernel 7: the f32 forward distribution scan.

Replaces the TPU kernel `hank_tpu/ops/pallas_kernels.py::forward_scan_pallas`
(`_make_forward_scan_kernel`): T periods of Young lottery, Markov mixing
and aggregation over given savings policies, from D0. The CUDA source is
`hank_tpu_torch/csrc/household_sweep.cu`: `forward_scan_kernel` and the two
kernels around it (the clamped rows and each destination's source range of
every period, computed on all SMs before the scan; the aggregates of every
period after it), bit for bit the previous kernel 7,
`forward_scan_previous_kernel` (`forward_scan_previous`, card only), which
walked every source of a row for each destination.

`forward_scan` launches the kernels for CUDA tensors and runs the plain
PyTorch version `forward_scan_reference` (a loop of
`ops/transition.forward_step`) only for CPU tensors.
`forward_scan.launches` counts kernel launches (one per call),
`forward_scan_previous.launches` the previous kernel's and
`forward_scan_reference.calls` plain-version calls.
"""

from __future__ import annotations

import torch

from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_sweep import check_tensors, fallback_pointer
from hank_tpu_torch.ops.transition import forward_step

f32 = torch.float32


def _scan_inputs(name, policies, D0, grid, Pi):
    """f32 casts and checks of `forward_scan`'s inputs; returns them and
    (T, n_a, n_e)."""
    policies, D0, grid, Pi = (x.to(f32) if isinstance(x, torch.Tensor) else x
                              for x in (policies, D0, grid, Pi))
    check_tensors(name, [policies, D0, grid, Pi], f32)
    if policies.ndim != 3 or policies.shape[0] < 1:
        raise ValueError(f"{name}: policies must be (T, n_a, n_e) with T ≥ 1; "
                         f"got {tuple(policies.shape)}")
    T, n_a, n_e = policies.shape
    if (D0.shape != (n_a, n_e) or grid.shape != (n_a,) or Pi.shape != (n_e, n_e)
            or n_a < 2):
        raise ValueError(f"{name}: expected D0 (n_a, n_e), grid (n_a,), Pi (n_e, n_e) "
                         f"with n_a ≥ 2 for policies {tuple(policies.shape)}; got "
                         f"{tuple(D0.shape)}, {tuple(grid.shape)}, {tuple(Pi.shape)}")
    return (policies, D0, grid, Pi), (T, n_a, n_e)


def forward_scan(policies, D0, grid, Pi, *, fallback_rows: torch.Tensor | None = None):
    """Fused f32 distribution scan: returns (agg (T,), D_T (n_a, n_e)), with
    agg[t] = Σ policies[t]·D_{t+1} and D_{t+1} the distribution after period
    t's lottery and Markov mix.

    `policies` (T, n_a, n_e), `D0` (n_a, n_e), `grid` (n_a,), `Pi`
    (n_e, n_e) row-stochastic, on one device. Everything is cast to f32, as
    the JAX function does. fallback_rows: optional (1,) int32 CUDA tensor;
    the kernels write into it how many (period, income row) pairs had a
    clamped policy row that was not non-decreasing, and so took the full
    source scan. The plain version has no such branch and refuses it.
    """
    (policies, D0, grid, Pi), (T, n_a, n_e) = _scan_inputs("forward_scan", policies, D0,
                                                           grid, Pi)
    fallback = fallback_pointer("forward_scan", fallback_rows, policies, (1,))
    if policies.device.type == "cpu":
        return forward_scan_reference(policies, D0, grid, Pi)
    lib = cuda_build.load_library()
    cuda_build.check_shared_memory_scan(lib, 1, n_a, n_e)
    dev = policies.device
    with torch.cuda.device(dev):
        agg = torch.empty(T, dtype=f32, device=dev)
        D_T = torch.empty((n_a, n_e), dtype=f32, device=dev)
        # Scratch: each period's clamped rows, source ranges and D_{t+1}.
        Pc = torch.empty((T, n_e, n_a), dtype=f32, device=dev)
        ranges = torch.empty((T, n_e, n_a), dtype=torch.int32, device=dev)
        D_hist = torch.empty((T, n_e, n_a), dtype=f32, device=dev)
        if fallback_rows is not None:
            fallback_rows.zero_()
        err = lib.hank_forward_scan_f32(
            policies.data_ptr(), D0.data_ptr(), grid.data_ptr(), Pi.data_ptr(),
            agg.data_ptr(), D_T.data_ptr(), Pc.data_ptr(), ranges.data_ptr(),
            D_hist.data_ptr(), *fallback, T, n_a, n_e,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "hank_forward_scan_f32")
    forward_scan.launches += 1
    return agg, D_T


forward_scan.launches = 0


def forward_scan_previous(policies, D0, grid, Pi):
    """The previous kernel 7 (`forward_scan_previous_kernel`, which walks
    every source of a row for each destination), with `forward_scan`'s
    arguments and outputs; `forward_scan` is held to it bit for bit. No
    caller but that comparison launches it. CUDA tensors only."""
    (policies, D0, grid, Pi), (T, n_a, n_e) = _scan_inputs("forward_scan_previous",
                                                           policies, D0, grid, Pi)
    if policies.device.type != "cuda":
        raise ValueError("forward_scan_previous: the previous kernel runs on the card "
                         "only; forward_scan_reference is the plain version")
    lib = cuda_build.load_library()
    cuda_build.check_shared_memory_scan(lib, 0, n_a, n_e)
    dev = policies.device
    with torch.cuda.device(dev):
        agg = torch.empty(T, dtype=f32, device=dev)
        D_T = torch.empty((n_a, n_e), dtype=f32, device=dev)
        err = lib.hank_forward_scan_f32_previous(
            policies.data_ptr(), D0.data_ptr(), grid.data_ptr(), Pi.data_ptr(),
            agg.data_ptr(), D_T.data_ptr(), T, n_a, n_e,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, err, "hank_forward_scan_f32_previous")
    forward_scan_previous.launches += 1
    return agg, D_T


forward_scan_previous.launches = 0


def forward_scan_reference(policies, D0, grid, Pi):
    """Plain PyTorch version of kernel 7 in its inputs' dtype (so it also
    runs in f64 on f32 inputs cast up): the bracket-form lottery and the
    Markov mix of `ops/transition.forward_step`, period by period."""
    forward_scan_reference.calls += 1
    D = D0
    agg = []
    for p in policies:
        D = forward_step(p, D, grid, [Pi])
        agg.append(torch.sum(p * D))
    return torch.stack(agg), D


forward_scan_reference.calls = 0
