"""Core model data structures (port of `hank_tpu/model/structures.py`).

Grids and transition matrices are float64 tensors on the model's device.
A dataclass `==` over tensors would raise (tensor truth values are
ambiguous), so `HeterogeneityDimension` compares them with `torch.equal`.

State-array convention: policies and distributions have shape
`state_shape = (*endog_dims.n, *exog_dims.n)` — (n_a, n_e) for KS.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class HeterogeneityDimension:
    """One dimension of household heterogeneity (`GeneralStructures.jl:43-49`)."""

    name: str
    dim_type: str                       # "endogenous" | "exogenous"
    n: int
    grid: torch.Tensor                  # (n,)
    transition: torch.Tensor | None     # (n, n) row-stochastic, exogenous only
    policy_var: str | None              # endogenous only

    def __post_init__(self):
        if self.dim_type not in ("endogenous", "exogenous"):
            raise ValueError(
                f"dimension '{self.name}': dim_type must be 'endogenous' or "
                f"'exogenous', got '{self.dim_type}'")
        if self.dim_type == "exogenous" and self.transition is None:
            raise ValueError(
                f"exogenous dimension '{self.name}' requires a transition matrix")
        if self.dim_type == "endogenous" and self.policy_var is None:
            raise ValueError(
                f"endogenous dimension '{self.name}' requires a policy_var")

    def __eq__(self, other):
        if not isinstance(other, HeterogeneityDimension):
            return NotImplemented
        if (self.name, self.dim_type, self.n, self.policy_var) != (
                other.name, other.dim_type, other.n, other.policy_var):
            return False
        if (self.transition is None) != (other.transition is None):
            return False
        return (torch.equal(self.grid, other.grid)
                and (self.transition is None
                     or torch.equal(self.transition, other.transition)))

    __hash__ = None


@dataclasses.dataclass(frozen=True)
class SteadyStateSpec:
    """Pinned values, Newton guesses and optional boxes for one steady state
    (`GeneralStructures.jl:73-76`)."""

    fixed: Mapping[str, float]
    guesses: Mapping[str, float]
    bounds: Mapping[str, tuple[float, float]] = dataclasses.field(default_factory=dict)

    def __eq__(self, other):
        if not isinstance(other, SteadyStateSpec):
            return NotImplemented
        return (dict(self.fixed) == dict(other.fixed)
                and dict(self.guesses) == dict(other.guesses)
                and dict(self.bounds) == dict(other.bounds))


@dataclasses.dataclass(frozen=True)
class Variable:
    """Aggregate-variable metadata (`GeneralStructures.jl:106-120`)."""

    name: str
    var_type: str
    description: str = ""
    seq_fn: Callable[..., torch.Tensor] | None = None


@dataclasses.dataclass(frozen=True)
class CompSpec:
    """Computational parameters (`GeneralStructures.jl:166-174`)."""

    T: int
    eps: float
    dx: float
    n_v: int
    n_endog: int
    max_lag: int
    max_lead: int

    @property
    def T_pad(self) -> int:
        return (self.T - 1) + self.max_lag + self.max_lead


@dataclasses.dataclass(frozen=True, eq=False)
class SequenceModel:
    """Complete model specification (`GeneralStructures.jl:216-226`).

    `device` is where the grids and transitions live; every tensor the
    solvers build for this model goes there.
    """

    variables: Mapping[str, Variable]
    equations: Sequence[str]
    compspec: CompSpec
    params: Mapping[str, float]
    residuals_fn: Callable[[torch.Tensor, Mapping[str, float]], torch.Tensor]
    ss_initial: SteadyStateSpec
    ss_ending: SteadyStateSpec
    heterogeneity: Mapping[str, HeterogeneityDimension]
    value_fn: Callable[..., Mapping[str, torch.Tensor]]
    name: str = ""
    device: torch.device = torch.device("cpu")

    def var_names(self) -> tuple[str, ...]:
        return tuple(self.variables.keys())

    def vars_of_type(self, t: str) -> tuple[str, ...]:
        return tuple(k for k, v in self.variables.items() if v.var_type == t)

    def var_index(self, name: str) -> int:
        return self.var_names().index(name)

    def endog_dims(self) -> tuple[HeterogeneityDimension, ...]:
        return tuple(d for d in self.heterogeneity.values()
                     if d.dim_type == "endogenous")

    def exog_dims(self) -> tuple[HeterogeneityDimension, ...]:
        return tuple(d for d in self.heterogeneity.values()
                     if d.dim_type == "exogenous")

    def state_shape(self) -> tuple[int, ...]:
        return tuple(d.n for d in self.endog_dims()) + tuple(
            d.n for d in self.exog_dims())

    def n_total(self) -> int:
        """Total household states (`GeneralStructures.jl:59`)."""
        n = 1
        for d in self.heterogeneity.values():
            n *= d.n
        return n


def generate_exog_paths(model: SequenceModel, T: int, **kwargs: Any) -> dict[str, torch.Tensor]:
    """Call each exogenous variable's `seq_fn(T)` (`GeneralStructures.jl:279-289`).

    Extra kwargs (e.g. a `torch.Generator`, a shock scale) are forwarded to
    every seq_fn. The paths are float64 tensors on the model's device.
    """
    paths = {}
    for name in model.vars_of_type("exogenous"):
        var = model.variables[name]
        if var.seq_fn is None:
            raise ValueError(
                f"Exogenous variable '{name}' has no seq_fn. "
                "Specify a seq_function in the YAML.")
        paths[name] = torch.as_tensor(var.seq_fn(T, **kwargs),
                                      dtype=torch.float64, device=model.device)
    return paths
