"""PyTorch port: the one-asset HANK and large-grid Krusell-Smith families
against hank_tpu.

One-asset HANK at 30×4, T=12 (the grid of `tests/test_hank_one_asset.py`)
and large-grid KS at its full 500×7, T=12, with the JAX package's steady
states carried across (`steady_state_from_numpy`). The `slow` test holds the
recipe of the JAX CPU roots the card's check compares with
(`hank_tpu_torch/data/<name>_T<T>_jax_cpu.npz`) and rebuilds them.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import REPO

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64

# Horizon of each family's JAX CPU root (BASELINE.json configs 2 and 4).
REFERENCE_T = {"hank_one_asset": 300, "ks_large_grid": 150}


def reference_file(name: str) -> str:
    return os.path.join(REPO, "hank_tpu_torch", "data",
                        f"{name}_T{REFERENCE_T[name]}_jax_cpu.npz")


def jax_cpu_root(name: str) -> dict:
    """The recipe of `reference_file(name)`: `hank_tpu` on a CPU, the
    shipped model at its published width and horizon, the shock of
    `generate_exog_paths` (`scripts/measure_configs.py:36-44`), solved by
    Newton-Krylov with f32 directions to eps 1e-10 from the steady-state
    path. Returns the arrays the file holds."""
    from hank_tpu.model.structures import generate_exog_paths
    from hank_tpu.models import load_model
    from hank_tpu.solvers.newton import make_path_solver
    from hank_tpu.utils.checkpoint import get_or_solve

    T = REFERENCE_T[name]
    model = load_model(name, T=T)
    ss0, ssT, Jbar = get_or_solve(model)
    exog = generate_exog_paths(model, T - 1)
    endog = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]), T - 1)
    x, info = make_path_solver(Jbar, exog, model, ss0, ssT, method="newton_krylov",
                               direction_dtype=jnp.float32, eps=1e-10)(x0)
    names = list(model.var_names())
    return {"var_names": np.array(names),
            "var_values": np.array([float(ssT.vars[k]) for k in names]),
            "x": np.asarray(x), "residual_norm": np.array(float(info["residual_norm"]))}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(REFERENCE_T))
def test_shipped_jax_cpu_root_is_rebuilt_by_its_recipe(name):
    ref = jax_cpu_root(name)
    assert float(ref["residual_norm"]) < 1e-10
    with np.load(reference_file(name)) as z:
        assert list(z["var_names"]) == list(ref["var_names"])
        assert np.max(np.abs(z["var_values"] - ref["var_values"])) <= 1e-10
        assert np.max(np.abs(z["x"] - ref["x"])) <= 1e-9


def build_small_hank_torch(T: int = 12, n_b: int = 30, n_e: int = 4):
    """The port's twin of `tests/test_hank_one_asset.py::build_small_hank`."""
    from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst
    from hank_tpu_torch.model.structures import HeterogeneityDimension
    from hank_tpu_torch.models import load_model

    model = load_model("hank_one_asset", T=T, device="cpu")
    bonds = HeterogeneityDimension(
        "bonds", "endogenous", n_b,
        torch.tensor(make_double_exponential_grid(0.0, 150.0, n_b), dtype=f64), None, "B")
    Pi, _, z = rouwenhorst(n_e, 0.966, 0.283)
    income = HeterogeneityDimension("income", "exogenous", n_e, torch.tensor(z, dtype=f64),
                                    torch.tensor(Pi, dtype=f64), None)
    return dataclasses.replace(model, heterogeneity={"bonds": bonds, "income": income})


def monetary_exog(T: int) -> dict:
    """The shock of `tests/test_hank_one_asset.py:96-97`, numpy f64."""
    t = np.arange(1, T, dtype=np.float64)
    return {"Y": np.ones(T - 1), "eps_m": -0.002 * 0.6 ** t}


def _np_ss(ss) -> dict:
    return {"vars": {k: np.asarray(v) for k, v in ss.vars.items()},
            "policies": {k: np.asarray(v) for k, v in ss.policies.items()},
            "D": np.asarray(ss.D), "value": np.asarray(ss.value)}


def _x_ss(model, ss) -> np.ndarray:
    endog = model.vars_of_type("endogenous")
    return np.tile(np.array([float(ss.vars[k]) for k in endog]), model.compspec.T - 1)


class Pair:
    """One family in both packages: JAX model, steady state, exog; the
    port's model, the carried-across steady state, exog; x_ss; J̄ (JAX's)."""

    def __init__(self, jm, jss, exog, tm):
        from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian
        from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy

        self.jm, self.jss, self.tm = jm, jss, tm
        self.jex = {k: jnp.asarray(v) for k, v in exog.items()}
        self.tex = {k: torch.tensor(v, dtype=f64) for k, v in exog.items()}
        self.tss = steady_state_from_numpy(_np_ss(jss), device="cpu")
        self.x_ss = _x_ss(jm, jss)
        self.J = np.asarray(get_steady_state_jacobian(jss, jm))

    def jax_root(self) -> np.ndarray:
        """The JAX package's root at eps 1e-11 (f64 directions)."""
        from hank_tpu.solvers.newton import make_path_solver

        x, info = make_path_solver(jnp.asarray(self.J), self.jex, self.jm, self.jss, self.jss,
                                   method="newton_krylov", eps=1e-11)(jnp.asarray(self.x_ss))
        assert float(info["residual_norm"]) < 1e-11
        return np.asarray(x)


@pytest.fixture(scope="module")
def hank():
    from tests.conftest import solve_ss_cached
    from tests.test_hank_one_asset import build_small_hank

    jm = build_small_hank()
    return Pair(jm, solve_ss_cached(jm), monetary_exog(12), build_small_hank_torch())


@pytest.fixture(scope="module")
def large():
    from hank_tpu.models import load_model
    from hank_tpu.models.ks_large_grid import exogenousZ
    from hank_tpu_torch.models import load_model as tload
    from tests.conftest import solve_ss_cached

    jm = load_model("ks_large_grid", T=12)
    return Pair(jm, solve_ss_cached(jm), {"Z": np.asarray(exogenousZ(11))},
                tload("ks_large_grid", T=12, device="cpu"))


def test_hank_structure_has_a_lead(hank):
    from hank_tpu_torch.ops.fused_sweep import aggregate_keys, supports_fused_sweep

    cs = hank.tm.compspec
    assert cs.max_lag == 1 and cs.max_lead == 1
    assert dataclasses.asdict(cs) == dataclasses.asdict(hank.jm.compspec)
    assert hank.tm.vars_of_type("endogenous") == ("pi", "i", "r")
    assert hank.tm.vars_of_type("heterogeneous") == ("B", "C")
    assert supports_fused_sweep(hank.tm) and aggregate_keys(hank.tm) == ("B", "C")


def test_hank_find_ss_matches_jax(hank):
    from hank_tpu_torch.solvers.steady_state import find_ss

    ss = find_ss(hank.tm, hank.tm.ss_initial, "initial")
    for k, v in hank.jss.vars.items():
        assert abs(float(ss.vars[k]) - float(v)) <= 1e-10, k
    assert float(np.max(np.abs(ss.D.numpy() - np.asarray(hank.jss.D)))) <= 1e-10
    p = hank.tm.params
    assert abs(float(ss.vars["B"]) - p["Bbar"]) < 1e-8 and abs(float(ss.vars["C"]) - 1.0) < 1e-9


@pytest.mark.parametrize("family", ["hank", "large"])
def test_residual_and_jvp_match_jax(request, family):
    from hank_tpu.solvers.newton import make_full_residual_fn as jmake
    from hank_tpu_torch.ops.fused_residual import make_sweep_residual_fn
    from hank_tpu_torch.solvers.newton import make_full_residual_fn as tmake

    pair = request.getfixturevalue(family)
    rng = np.random.default_rng(5)
    x = pair.x_ss * (1.0 + 1e-3 * rng.normal(size=pair.x_ss.shape))
    v = rng.normal(size=x.shape)
    Fj = jmake(pair.jm, pair.jss, pair.jss, pair.jex)
    ref, ref_t = jax.jit(lambda a, b: jax.jvp(Fj, (a,), (b,)))(jnp.asarray(x), jnp.asarray(v))
    Ft = tmake(pair.tm, pair.tss, pair.tss, pair.tex)
    out, out_t = torch.func.jvp(Ft, (torch.tensor(x),), (torch.tensor(v),))
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) <= 1e-12
    assert float(np.max(np.abs(out_t.numpy() - np.asarray(ref_t)))) <= 1e-11
    # Kernel 2's plain version (C from its consumption aggregate for HANK).
    F2 = make_sweep_residual_fn(pair.tm, pair.tss, pair.tss, pair.tex)(torch.tensor(x))
    assert float(np.max(np.abs(F2.numpy() - np.asarray(ref)))) <= 1e-12


def test_hank_jacobian_matches_jax_and_dense(hank):
    from hank_tpu_torch.solvers.newton import make_full_residual_fn
    from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian

    J = get_steady_state_jacobian(hank.tss, hank.tm)
    assert float(np.max(np.abs(J.numpy() - hank.J))) <= 1e-9
    T = hank.tm.compspec.T
    steady = {"Y": torch.ones(T - 1, dtype=f64), "eps_m": torch.zeros(T - 1, dtype=f64)}
    F = make_full_residual_fn(hank.tm, hank.tss, hank.tss, steady)
    J_dense = torch.func.jacfwd(F)(torch.tensor(hank.x_ss))
    assert float((J - J_dense).abs().max()) <= 1e-9


@pytest.mark.parametrize("direction_dtype", [f32, None])
def test_hank_path_solve_matches_jax(hank, direction_dtype):
    """Newton-Krylov with f32 directions (kernel 1's plain version) and with
    f64 ones; economics of `tests/test_hank_one_asset.py:108-119`."""
    from hank_tpu_torch.solvers.newton import make_path_solver

    x_ref = hank.jax_root()
    x, info = make_path_solver(torch.tensor(hank.J), hank.tex, hank.tm, hank.tss, hank.tss,
                               method="newton_krylov", direction_dtype=direction_dtype,
                               direction_mode="pallas", eps=1e-10)(torch.tensor(hank.x_ss))
    assert info["residual_norm"] < 1e-10
    assert float(np.max(np.abs(x.numpy() - x_ref))) <= 1e-9
    path = x.numpy().reshape(11, 3)
    pi_dev = path[:, 0] - float(hank.jss.vars["pi"])
    assert np.max(np.abs(path[:, 2] - float(hank.jss.vars["r"]))) < 1e-6
    assert abs(pi_dev[0]) < 1e-6


def test_zlb_shock_is_kinked():
    from hank_tpu.models.ks_large_grid import exogenousZ as jz
    from hank_tpu_torch.models.ks_large_grid import exogenousZ

    z = exogenousZ(40).numpy()
    assert np.array_equal(z, np.asarray(jz(40)))
    assert z.min() == pytest.approx(0.88)
    n_floor = int((z == 0.88).sum())
    assert 5 <= n_floor <= 12
    d = np.diff(z)
    assert int((d == 0.0).sum()) == n_floor - 1 and d[n_floor - 1] > 1e-3


def test_large_grid_path_solve_matches_jax(large):
    """The full 500×7 grid, T=12, the kinked ZLB shock: Newton-Krylov with
    f32 directions (kernel 1's plain version), kernel-2 residuals."""
    from hank_tpu_torch.ops.fused_sweep import supports_fused_sweep
    from hank_tpu_torch.solvers.newton import make_path_solver

    assert supports_fused_sweep(large.tm) and large.tm.state_shape() == (500, 7)
    x_ref = large.jax_root()
    x, info = make_path_solver(torch.tensor(large.J), large.tex, large.tm, large.tss,
                               large.tss, method="newton_krylov", direction_dtype=f32,
                               direction_mode="pallas", eps=1e-10)(torch.tensor(large.x_ss))
    assert info["residual_norm"] < 1e-10
    assert float(np.max(np.abs(x.numpy() - x_ref))) <= 1e-9
    path = x.numpy().reshape(11, 4)
    assert path[0, 0] < 0.95 * float(large.jss.vars["Y"])
    assert path[:, 2].max() > float(large.jss.vars["r"])
