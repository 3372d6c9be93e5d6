"""hank_tpu_torch — the PyTorch/CUDA port of hank_tpu for one NVIDIA H100.

Sequence-space Newton-Raphson for perfect-foresight transition paths of
heterogeneous-agent models (Boehl 2024). Plain functions on torch tensors;
the household sweeps of the path solver and of the ensemble solver
(`parallel/ensemble.py`) run in hand-written CUDA kernels
(`ops/fused_sweep.py`, `ops/fused_sweep_batch.py`, `ops/fused_residual.py`,
`csrc/household_sweep.cu`; the two-asset pair `ops/fused_sweep2.py`,
`csrc/household_sweep2.cu`; the forward scan `ops/forward_scan.py`) on CUDA
tensors and in their plain PyTorch versions on CPU tensors. `run.py` is the
driver (`solve_model`, `python -m hank_tpu_torch.run`); the model loader and
the driver target the card unless the caller asks for the CPU.
`parallel/mesh.py` and `parallel/state_sharding.py` shard ensembles, the J̄
seed sweeps and the household state over `torch.distributed`, one process
per device (`parallel/dryrun.py` runs all three paths).

This package imports torch and numpy, never jax or hank_tpu. Dtypes are
passed explicitly (float64 by default); it never changes torch's default
dtype.
"""

from hank_tpu_torch import config
from hank_tpu_torch.blocks.forward import distribution_path
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
from hank_tpu_torch.solvers.linear import irf_table, linear_impulse_response
from hank_tpu_torch.solvers.newton import (
    make_full_residual_fn,
    make_path_solver,
    newton_raphson_hank,
    solve_path_dense,
)
from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
from hank_tpu_torch.solvers.steady_state import SteadyState, find_ss, get_steady_states
from hank_tpu_torch.utils.checkpoint import get_or_solve


def __getattr__(name):
    # `solve_model` is imported on first use, so that `python -m
    # hank_tpu_torch.run` does not find its module imported already.
    if name == "solve_model":
        from hank_tpu_torch.run import solve_model

        return solve_model
    raise AttributeError(f"module 'hank_tpu_torch' has no attribute {name!r}")


__all__ = [
    "CompSpec",
    "HeterogeneityDimension",
    "SequenceModel",
    "SteadyState",
    "SteadyStateSpec",
    "Variable",
    "build_model_from_yaml",
    "config",
    "distribution_path",
    "find_ss",
    "get_or_solve",
    "get_steady_state_jacobian",
    "get_steady_states",
    "irf_table",
    "linear_impulse_response",
    "load_model",
    "make_full_residual_fn",
    "make_path_solver",
    "newton_raphson_hank",
    "residual_ensemble",
    "solve_ensemble",
    "solve_ensemble_host",
    "solve_model",
    "solve_path_dense",
]
