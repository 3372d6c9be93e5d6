"""Rank bodies of the port's multi-process tests (no tests here).

`hank_tpu_torch.parallel.dryrun.spawn_ranks` runs each function below on
every rank of a gloo group of new processes. This module imports torch and
the port only, never jax or hank_tpu, so a spawned rank starts in a few
seconds; the test modules that spawn them hold the results against the
unsplit port and against hank_tpu.
"""

import dataclasses

import torch

from hank_tpu_torch.model import grids as tgrids
from hank_tpu_torch.model.structures import HeterogeneityDimension
from hank_tpu_torch.models import load_model
from hank_tpu_torch.parallel.dryrun import tiny_model
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy

f64 = torch.float64


def _small_ks(ss_np, n_a=40, n_e=5, T=12):
    """The small KS of `tests/conftest.py::build_small_ks` on the CPU, with the
    JAX package's steady state carried across."""
    return tiny_model(n_a=n_a, n_e=n_e, T=T, device="cpu"), steady_state_from_numpy(
        ss_np, device="cpu")


def build_small_two_asset_torch(T: int = 12, n_b: int = 24, n_a: int = 12, n_e: int = 4,
                                lam: float = 0.10, device="cpu"):
    """The port's twin of `tests/test_hank_two_asset.py::build_small_two_asset`."""
    from hank_tpu_torch.models.hank_two_asset import access_process

    def t(a):
        return torch.tensor(a, dtype=f64, device=device)

    model = load_model("hank_two_asset", T=T, device=device)
    liq = HeterogeneityDimension(
        "liquid", "endogenous", n_b, t(tgrids.make_double_exponential_grid(0.0, 120.0, n_b)),
        None, "B")
    ill = HeterogeneityDimension(
        "illiquid", "endogenous", n_a, t(tgrids.make_double_exponential_grid(0.0, 200.0, n_a)),
        None, "A")
    Pi, _, z = tgrids.rouwenhorst(n_e, 0.966, 0.283)
    inc = HeterogeneityDimension("income", "exogenous", n_e, t(z), t(Pi), None)
    g, P = access_process(2, lam)
    acc = HeterogeneityDimension("access", "exogenous", 2, t(g), t(P), None)
    return dataclasses.replace(model, heterogeneity={"liquid": liq, "illiquid": ill,
                                                     "income": inc, "access": acc})


def _raises_value_error(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def mesh_rank(device, ss_np, J, x0, Z, x_b) -> dict:
    """Everything the dp mesh carries, on a 1-D mesh over the whole group:
    mesh shapes, the row round trip, `residual_ensemble`, both ensemble
    methods and J̄."""
    from hank_tpu_torch.parallel.ensemble import residual_ensemble, solve_ensemble
    from hank_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_rows
    from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian

    model, ss = _small_ks(ss_np)
    mesh = make_mesh()
    mesh2 = make_mesh(axis_names=("dp", "state"))
    size = mesh.size(0)
    rows = torch.arange(6 * size, dtype=f64).reshape(2 * size, 3)
    out = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
           "shape_2d": tuple(mesh2.shape), "names_2d": mesh2.mesh_dim_names,
           "local_rank": mesh.get_local_rank("dp"),
           "round_trip": torch.equal(gather_rows(shard_rows(rows, mesh), mesh), rows),
           "shard": shard_rows(rows, mesh).clone(),
           "odd_rows_raise": size > 1 and _raises_value_error(
               lambda: shard_rows(rows[:2 * size - 1], mesh))}
    exog = {"Z": torch.as_tensor(Z)}
    out["residual"] = residual_ensemble(torch.as_tensor(x_b), exog, model, ss, ss, mesh=mesh)
    for method in ("newton_krylov", "boehl"):
        records = []
        x, info = solve_ensemble(torch.as_tensor(x0), torch.as_tensor(J), exog, model, ss, ss,
                                 mesh=mesh, method=method, eps=1e-9, records=records)
        out[method] = (x, info, records)
    out["jacobian"] = get_steady_state_jacobian(ss, model, mesh=mesh)
    return out


def mesh_rank_subsets(device, ss_np) -> dict:
    """On a group of 4: the 2-D grid, and J̄ refused over a mesh of 3 ranks
    (3 does not divide n_endog = 4) before any sweep."""
    from hank_tpu_torch.parallel.mesh import make_mesh
    from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian

    model, ss = _small_ks(ss_np)
    mesh2 = make_mesh(4, ("dp", "state"))
    mesh3 = make_mesh(3)
    in_mesh3 = mesh3.get_coordinate() is not None
    return {"shape_2d": tuple(mesh2.shape), "coordinate_2d": tuple(mesh2.get_coordinate()),
            "in_mesh3": in_mesh3,
            "mesh3_raises": in_mesh3 and _raises_value_error(
                lambda: get_steady_state_jacobian(ss, model, mesh=mesh3))}


def state_rank(device, ss_np, x, Z, n_a, n_e, T) -> dict:
    """The state-sharded backward and forward blocks, this rank's blocks of
    the policy paths, and the split refused at n_e = 7."""
    from hank_tpu_torch.parallel.mesh import make_mesh
    from hank_tpu_torch.parallel.state_sharding import (backward_iteration_sharded,
                                                        forward_iteration_sharded,
                                                        state_sharding)

    model, ss = _small_ks(ss_np, n_a=n_a, n_e=n_e, T=T)
    mesh = make_mesh(axis_names=("state",))
    exog = {"Z": torch.as_tensor(Z)}
    pol = backward_iteration_sharded(torch.as_tensor(x), exog, model, ss.vars, ss.value, mesh)
    shard = state_sharding(mesh, model, time_axis=True)
    return {"policies": pol, "start": shard.start, "stop": shard.stop, "dim": shard.dim,
            "aggregates": forward_iteration_sharded(pol, model, ss.D, mesh),
            "n_e7_raises": _raises_value_error(lambda: state_sharding(
                mesh, tiny_model(n_a=n_a, n_e=7, T=T, device="cpu")))}


def two_asset_block_inputs(model) -> tuple:
    """(x, exog, ss_vars, terminal value) of the small two-asset model's
    backward block, as numpy f64: the steady-state guesses along the path, a
    fiscal shock G_t = 0.01·0.8ᵗ, and seeded marginal values (V_b, V_a) that
    fall in both assets, as a CRRA value's do."""
    import numpy as np

    spec = model.ss_initial
    ss_vars = {k: 1.0 for k in model.var_names()}
    ss_vars.update({k: float(v) for k, v in {**spec.guesses, **spec.fixed}.items()})
    Tm1 = model.compspec.T - 1
    x = np.tile([ss_vars[k] for k in model.vars_of_type("endogenous")], Tm1)
    exog = {k: np.zeros(Tm1) for k in model.vars_of_type("exogenous")}
    exog["G"] = 0.01 * 0.8 ** np.arange(1, Tm1 + 1, dtype=np.float64)
    rng = np.random.default_rng(11)
    b, a, e = (np.asarray(model.heterogeneity[k].grid, dtype=np.float64)
               for k in ("liquid", "illiquid", "income"))
    c = (0.3 + 0.05 * b[:, None, None, None] + 0.02 * a[None, :, None, None]
         + 0.5 * e[None, None, :, None]) * rng.uniform(0.95, 1.05, (1, 1, 1, 2))
    value = np.stack([1.01 * c ** -2.0, 1.02 * (1.0 + 0.1 * c) * c ** -2.0])
    return x, exog, ss_vars, value


def two_asset_state_rank(device) -> dict:
    """The state-sharded backward block on the small two-asset model, whose
    value_fn computes both access columns at any split: this rank's block of
    each policy path on `two_asset_block_inputs`, and the ValueError's
    message for a value_fn that returns a third width ("tripled") and for
    one that returns one output at this rank's width and the others at
    full width ("mixed")."""
    from hank_tpu_torch.parallel.mesh import make_mesh
    from hank_tpu_torch.parallel.state_sharding import backward_iteration_sharded, state_sharding

    model = build_small_two_asset_torch()
    x, exog, ss_vars, value = two_asset_block_inputs(model)

    def t(a):
        return torch.as_tensor(a, dtype=f64)

    args = (t(x), {k: t(v) for k, v in exog.items()}, model,
            {k: t(v) for k, v in ss_vars.items()}, t(value))
    mesh = make_mesh(axis_names=("state",))
    policies = backward_iteration_sharded(*args, mesh)

    def mixed(v, xv, m):
        """The first output at the width of m's split axis, the rest as the
        model returns them (at full width)."""
        n = m.exog_dims()[-1].n
        out = model.value_fn(v, xv, m)
        first = next(iter(out))
        return {**out, first: out[first].narrow(-1, 0, n)}

    value_fns = {"tripled": lambda v, xv, m: {
                     k: torch.cat([p, p, p], dim=-1) for k, p in model.value_fn(v, xv, m).items()},
                 "mixed": mixed}
    errors = {}
    for label, value_fn in value_fns.items():
        try:
            backward_iteration_sharded(args[0], args[1],
                                       dataclasses.replace(model, value_fn=value_fn),
                                       *args[3:], mesh)
            errors[label] = None
        except ValueError as e:
            errors[label] = str(e)
    shard = state_sharding(mesh, model, time_axis=True)
    return {"policies": policies, "start": shard.start, "stop": shard.stop, "errors": errors}


def failing_rank(device) -> None:
    """Rank 1 raises; rank 0 waits at a barrier that rank 1 never reaches."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def sleeping_rank(device, seconds: float) -> None:
    import time

    time.sleep(seconds)


class MeshOfSize:
    """A stand-in for a `DeviceMesh` of `size` ranks on one "dp" axis, seen
    from rank 0, for the checks a meshed call makes before any collective."""

    mesh_dim_names = ("dp",)

    def __init__(self, size: int):
        self._size = size

    def size(self, mesh_dim: int = 0) -> int:
        return self._size

    def get_local_rank(self, axis) -> int:
        return 0
