"""dtype-cast views of models, steady states and shock paths (port of
`hank_tpu/ops/precision.py:23-47`).

The f32 direction maps run the household blocks on an f32 copy of the
model's grids and transitions and of the steady-state arrays, while the
residuals and the solution stay f64 (inexact Newton). The reference's
`one_minus` is a TPU workaround and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch


def cast_model(model, dtype):
    """The model with its household grids and transitions in `dtype`."""
    het = {k: dataclasses.replace(
        d, grid=d.grid.to(dtype),
        transition=None if d.transition is None else d.transition.to(dtype))
        for k, d in model.heterogeneity.items()}
    return dataclasses.replace(model, heterogeneity=het)


def cast_ss(ss, dtype):
    """The steady state with its variables, policies, D and value in `dtype`."""
    return dataclasses.replace(
        ss,
        vars={k: torch.as_tensor(v).to(dtype) for k, v in ss.vars.items()},
        policies={k: v.to(dtype) for k, v in ss.policies.items()},
        D=ss.D.to(dtype), value=ss.value.to(dtype))


def cast_paths(paths: Mapping[str, torch.Tensor], dtype) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dtype) for k, v in paths.items()}
