"""hank_tpu_torch — the PyTorch/CUDA port of hank_tpu for one NVIDIA H100.

Sequence-space Newton-Raphson for perfect-foresight transition paths of
heterogeneous-agent models (Boehl 2024). Plain functions on torch tensors;
the household sweeps of the path solver and of the ensemble solver
(`parallel/ensemble.py`) run in hand-written CUDA kernels
(`ops/fused_sweep.py`, `ops/fused_sweep_batch.py`, `ops/fused_residual.py`,
`csrc/household_sweep.cu`) on CUDA tensors and in their plain PyTorch
versions on CPU tensors.

This package imports torch and numpy, never jax or hank_tpu. Dtypes are
passed explicitly (float64 by default); it never changes torch's default
dtype.
"""

from hank_tpu_torch import config
from hank_tpu_torch.model.parser import build_model_from_yaml
from hank_tpu_torch.model.structures import (
    CompSpec,
    HeterogeneityDimension,
    SequenceModel,
    SteadyStateSpec,
    Variable,
)
from hank_tpu_torch.models import load_model
from hank_tpu_torch.parallel.ensemble import (
    residual_ensemble,
    solve_ensemble,
    solve_ensemble_host,
)
from hank_tpu_torch.solvers.newton import (
    make_full_residual_fn,
    make_path_solver,
    newton_raphson_hank,
)
from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
from hank_tpu_torch.solvers.steady_state import SteadyState, find_ss, get_steady_states
from hank_tpu_torch.utils.checkpoint import get_or_solve

__all__ = [
    "CompSpec",
    "HeterogeneityDimension",
    "SequenceModel",
    "SteadyState",
    "SteadyStateSpec",
    "Variable",
    "build_model_from_yaml",
    "config",
    "find_ss",
    "get_or_solve",
    "get_steady_state_jacobian",
    "get_steady_states",
    "load_model",
    "make_full_residual_fn",
    "make_path_solver",
    "newton_raphson_hank",
    "residual_ensemble",
    "solve_ensemble",
    "solve_ensemble_host",
]
