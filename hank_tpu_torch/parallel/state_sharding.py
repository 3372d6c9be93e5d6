"""Household-state sharding over a mesh axis (port of
`hank_tpu/parallel/state_sharding.py`, the TP row of SURVEY §2.10).

The LAST exogenous axis of the state arrays (*endog, *exog) splits over the
ranks of the mesh's "state" axis in contiguous blocks; each rank keeps its
block of the policies, the distribution and the value. The Young lottery
and the EGM step act on each exogenous state on its own
(`ForwardIteration.jl:8-10`), so they run locally on the block, through the
port's own `blocks/` and `ops/` functions. The two operations that contract
the exogenous axis all-gather that period's array and then compute this
rank's columns:
  - the Markov mix of D after the lottery: D'[..., e'] = Σ_e D[..., e] Π[e, e'],
    this rank's columns e' of Π;
  - the expectation over e' inside the model's `value_fn`, which gets the
    whole next-period value and a model whose sharded dimension holds this
    rank's grid points and rows of Π. A `value_fn` that takes its
    expectation as V' Πᵀ with the dimension's own transition and sizes its
    outputs from that model (the shipped one-asset models,
    `ops/egm.crra_egm_step`) computes this rank's block. One that returns
    the split axis at full width whatever the dimension holds (the
    two-asset `value_fn` stacks both access columns) does not: from its
    first step on, each rank runs the whole step with the unsplit model on
    the gathered value and keeps its block of each output, as XLA does
    with the reference's shardings (`hank_tpu/parallel/state_sharding.py:
    66-90`). A `value_fn` that returns any other width is refused with
    ValueError.
The aggregates are one all-reduce sum. Where the reference lets XLA insert
these collectives from `NamedSharding`s, the port writes them out.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.distributed as dist

from hank_tpu_torch.blocks.backward import backward_iteration
from hank_tpu_torch.ops.transition import exog_apply, lottery_apply_multi
from hank_tpu_torch.parallel.mesh import gather_rows, row_block


@dataclasses.dataclass(frozen=True)
class StateShard:
    """This rank's block [start, stop) of the split dimension `dim` (the
    last exogenous axis, the last axis) of a state array, whose full extent
    is n."""

    dim: int
    n: int
    start: int
    stop: int

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last axis of `t` (a state array, or a
        value with leading axes before the state), given at full width or
        already as the block; ValueError for any other width."""
        width = t.shape[-1]
        if width == self.stop - self.start:
            return t
        if width != self.n:
            raise ValueError(f"state axis {self.dim} has {width} entries; expected the "
                             f"full {self.n} or this rank's {self.stop - self.start}")
        return t.narrow(-1, self.start, self.stop - self.start)


def state_sharding(mesh, model, time_axis: bool = False, axis: str = "state") -> StateShard:
    """The split of the state arrays (*endog, *exog) over the mesh's `axis`:
    the last exogenous axis, in contiguous blocks; with `time_axis`, of
    arrays with a leading T axis (policy paths). ValueError when the
    axis's size does not divide that dimension."""
    n = model.exog_dims()[-1].n
    try:
        start, count = row_block(n, mesh, axis)
    except ValueError as e:
        raise ValueError(f"the last exogenous dimension does not split: {e}") from None
    return StateShard(dim=len(model.heterogeneity) - 1 + int(time_axis), n=n,
                      start=start, stop=start + count)


def _gather_last(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's block of the last axis of `t`, in rank order."""
    return gather_rows(t.movedim(-1, 0), mesh, axis).movedim(0, -1).contiguous()


def forward_iteration_sharded(
    policy_seqs: Mapping[str, torch.Tensor],
    model,
    D_initial: torch.Tensor,
    mesh,
    axis: str = "state",
) -> dict[str, torch.Tensor]:
    """`blocks.forward.forward_iteration` with the household state split over
    the mesh's `axis` (module docstring). Policies (T-1, *state) and D
    (*state) may come at full width or as this rank's block. Returns the
    (T-1,) aggregate paths, the same on every rank."""
    shard_t = state_sharding(mesh, model, time_axis=True, axis=axis)
    shard = state_sharding(mesh, model, axis=axis)
    het_keys = model.vars_of_type("heterogeneous")
    endog_dims = model.endog_dims()
    grids = [d.grid for d in endog_dims]
    policy_vars = [d.policy_var for d in endog_dims]
    k = len(endog_dims)
    transitions = [d.transition for d in model.exog_dims()]
    transitions[-1] = transitions[-1][:, shard.start:shard.stop]

    pols = {v: shard_t.take(p) for v, p in policy_seqs.items()}
    D = shard.take(D_initial).to(pols[het_keys[0]].dtype)
    partial = []
    for t in range(pols[het_keys[0]].shape[0]):
        D_half = lottery_apply_multi([pols[v][t] for v in policy_vars], D, grids)
        D = exog_apply(_gather_last(D_half, mesh, axis), transitions, k)
        partial.append(torch.stack([torch.sum(pols[v][t] * D) for v in het_keys]))
    aggs = torch.stack(partial, dim=1)                       # (n_het, T-1)
    dist.all_reduce(aggs, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return dict(zip(het_keys, aggs))


def backward_iteration_sharded(
    x_endog: torch.Tensor,
    exog_paths: Mapping[str, torch.Tensor],
    model,
    ss_end_vars: Mapping[str, torch.Tensor],
    terminal_value: torch.Tensor,
    mesh,
    axis: str = "state",
) -> dict[str, torch.Tensor]:
    """`blocks.backward.backward_iteration` with the value and the policies
    split over the mesh's `axis` (module docstring). `terminal_value` may
    come at full width or as this rank's block. Returns this rank's block
    of each (T-1, *state) policy path; gathering is left to the caller."""
    shard = state_sharding(mesh, model, axis=axis)
    name = [k for k, d in model.heterogeneity.items() if d.dim_type == "exogenous"][-1]
    d = model.heterogeneity[name]
    d = dataclasses.replace(d, n=shard.stop - shard.start, grid=d.grid[shard.start:shard.stop],
                            transition=d.transition[shard.start:shard.stop])
    value_fn = model.value_fn
    unsplit = False       # set once the value_fn has returned the split axis at full width

    def local_value_fn(value_next, xvals, local):
        nonlocal unsplit
        full = _gather_last(value_next, mesh, axis)
        if not unsplit:
            result = value_fn(full, xvals, local)
            widths = {k: t.shape[-1] for k, t in result.items()}
            if set(widths.values()) == {d.n}:
                return result
            if set(widths.values()) != {shard.n}:
                found = ", ".join(f"{k} with {w} entries" for k, w in widths.items())
                raise ValueError(
                    f"backward_iteration_sharded: the value_fn of model {model.name!r} returns "
                    f"{found} on the split {name!r} axis; it must return all of them at this "
                    f"rank's {d.n} or all at the full {shard.n}")
            unsplit = True
        return {k: shard.take(t) for k, t in value_fn(full, xvals, model).items()}

    local = dataclasses.replace(model, heterogeneity={**model.heterogeneity, name: d},
                                value_fn=local_value_fn)
    return backward_iteration(x_endog, exog_paths, local, ss_end_vars, shard.take(terminal_value))
