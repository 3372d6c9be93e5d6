"""Process-level defaults of the PyTorch port (mirrors `hank_tpu/config.py`).

Per-model values live on `CompSpec`; per-call values are solver kwargs.
Dtypes are passed explicitly everywhere: the port never calls
`torch.set_default_dtype`, because the parity tests share one process with
JAX.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    # Compute dtype of the solver pipeline. float64 is required for the
    # 1e-8 pointwise path target; the H100 has native FP64.
    dtype: torch.dtype = torch.float64

    # Defaults matching the reference (`ModelParser.jl:312`).
    default_T: int = 150
    default_eps: float = 1e-6
    default_dx: float = 1e-8

    # VFI inner loop cap (`SteadyState.jl:134`) and sup-norm tolerance: the
    # backward scan amplifies terminal-value error, so the SS value must be
    # converged to ~1e-12 for 1e-8 pointwise path accuracy.
    vfi_max_iter: int = 10_000
    vfi_eps: float = 1e-12

    # Outer Newton caps (`SteadyState.jl:192-193`, `NewtonRaphson.jl:38`).
    ss_newton_max_iter: int = 100
    path_newton_max_iter: int = 100

    # The dense invariant-distribution solve is used up to this many
    # household states (one endogenous axis); the matrix-free solve beyond.
    invariant_dense_max_states: int = 4096

    # Matrix-free invariant-distribution sup-norm tolerance: tighter than
    # vfi_eps, because the forward push-forward carries D's error into every
    # aggregate of the path.
    invariant_eps: float = 1e-14


config = Config()

# Division-guard epsilon (`hank_tpu/config.py::TINY`).
TINY = 1e-36

