from hank_tpu_torch.model.structures import (
    CompSpec,
    HeterogeneityDimension,
    SequenceModel,
    SteadyStateSpec,
    Variable,
    generate_exog_paths,
)
from hank_tpu_torch.model.parser import build_model_from_yaml, compile_residuals, detect_max_lag_lead
from hank_tpu_torch.model import grids

__all__ = [
    "CompSpec",
    "HeterogeneityDimension",
    "SequenceModel",
    "SteadyStateSpec",
    "Variable",
    "build_model_from_yaml",
    "compile_residuals",
    "detect_max_lag_lead",
    "generate_exog_paths",
    "grids",
]
