"""PyTorch port: a model outside the shipped families, with two endogenous
heterogeneity dimensions, against hank_tpu on the same toy.

`tests/test_two_endog_dims.py`'s synthetic liquid × illiquid × productivity
model (12×10×3, a smooth contraction "Bellman" with two policies, one
equation q = 0.12·BH + 0.06·AH + 0.3·Z + 0.1·q(−1), T=8) built with the
port's structures and parser, driven through the port's VFI, invariant
distribution and `find_ss`, `single_run`, J̄ against `dense_path_jacobian`
and the Newton-Krylov path solve, each held to the JAX package's result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.model.grids import rouwenhorst
from hank_tpu_torch.model.parser import compile_residuals, detect_max_lag_lead
from hank_tpu_torch.model.structures import (CompSpec, HeterogeneityDimension, SequenceModel,
                                             SteadyStateSpec, Variable)
from hank_tpu_torch.solvers.newton import newton_raphson_hank
from hank_tpu_torch.solvers.ss_jacobian import dense_path_jacobian, get_steady_state_jacobian
from hank_tpu_torch.solvers.steady_state import find_ss, single_run
from tests.test_two_endog_dims import N_A, N_B, N_E, build_two_asset_toy

torch.set_num_threads(1)
f64 = torch.float64


def _toy_value_fn(value_next, xvals, model):
    """`tests/test_two_endog_dims.py::_toy_value_fn` in torch."""
    bonds = model.heterogeneity["liquid"]
    illiq = model.heterogeneity["illiquid"]
    prod = model.heterogeneity["prod"]
    q, Z = xvals["q"], xvals["Z"]
    b = bonds.grid[:, None, None]
    a = illiq.grid[None, :, None]
    e = prod.grid[None, None, :]
    ev = value_next @ prod.transition.T
    value = 0.8 * ev + 0.05 * (b + a) * e + 0.1 * q
    pol_b = 0.55 * b + 0.25 * a * 0.2 + 0.6 * q + 0.08 * e * Z
    pol_a = 0.70 * a + 0.10 * b * 0.3 + 0.4 * q + 0.05 * e
    shape = (N_B, N_A, N_E)
    return {"Value": value.expand(shape), "BH": pol_b.expand(shape), "AH": pol_a.expand(shape)}


def build_two_asset_toy_torch(T=8):
    """The port's twin of `tests/test_two_endog_dims.py::build_two_asset_toy`."""
    Pi, _, z = rouwenhorst(N_E, 0.8, 0.3)
    het = {
        "liquid": HeterogeneityDimension("liquid", "endogenous", N_B,
                                         torch.tensor(np.linspace(0.0, 10.0, N_B)), None, "BH"),
        "illiquid": HeterogeneityDimension("illiquid", "endogenous", N_A,
                                           torch.tensor(np.linspace(0.0, 14.0, N_A)), None, "AH"),
        "prod": HeterogeneityDimension("prod", "exogenous", N_E, torch.tensor(z, dtype=f64),
                                       torch.tensor(Pi, dtype=f64), None),
    }
    variables = {
        "q": Variable("q", "endogenous"),
        "BH": Variable("BH", "heterogeneous"),
        "AH": Variable("AH", "heterogeneous"),
        "Z": Variable("Z", "exogenous", seq_fn=lambda TT, **kw: torch.ones(TT, dtype=f64)),
    }
    equations = ("q = 0.12*BH + 0.06*AH + 0.3*Z + 0.1*q(-1)",)
    names = tuple(variables)
    max_lag, max_lead = detect_max_lag_lead(list(equations), names)
    residuals_fn = compile_residuals(list(equations), names, set())
    compspec = CompSpec(T=T, eps=1e-9, dx=1e-8, n_v=4, n_endog=1,
                        max_lag=max_lag, max_lead=max_lead)
    spec = SteadyStateSpec(fixed={"Z": 1.0}, guesses={"q": 1.0})
    return SequenceModel(
        variables=variables, equations=equations, compspec=compspec, params={},
        residuals_fn=residuals_fn, ss_initial=spec, ss_ending=spec, heterogeneity=het,
        value_fn=_toy_value_fn, name="two-asset toy", device=torch.device("cpu"))


@pytest.fixture(scope="module")
def toys():
    from hank_tpu.solvers.steady_state import find_ss as jfind

    jm = build_two_asset_toy()
    tm = build_two_asset_toy_torch()
    return jm, jfind(jm, jm.ss_initial, "toy"), tm, find_ss(tm, tm.ss_initial, "toy")


def test_two_dim_grids_match_jax(toys):
    jm, _, tm, _ = toys
    assert tm.state_shape() == jm.state_shape() == (N_B, N_A, N_E)
    for name, jd in jm.heterogeneity.items():
        td = tm.heterogeneity[name]
        assert np.max(np.abs(td.grid.numpy() - np.asarray(jd.grid))) == 0.0
        if jd.transition is not None:
            assert np.max(np.abs(td.transition.numpy() - np.asarray(jd.transition))) <= 1e-15


def test_two_dim_steady_state_matches_jax(toys):
    from hank_tpu_torch.ops.transition import exog_apply, lottery_apply_multi

    _, jss, tm, tss = toys
    D = tss.D
    assert D.shape == (N_B, N_A, N_E)
    assert abs(float(D.sum()) - 1.0) < 1e-10 and float(D.min()) >= -1e-12
    grids = [tm.heterogeneity["liquid"].grid, tm.heterogeneity["illiquid"].grid]
    D_next = exog_apply(lottery_apply_multi([tss.policies["BH"], tss.policies["AH"]], D, grids),
                        [tm.heterogeneity["prod"].transition], 2)
    assert float((D_next - D).abs().max()) < 1e-9
    assert abs(float((tss.policies["BH"] * D).sum()) - float(tss.vars["BH"])) < 1e-9
    for k in jss.vars:
        assert abs(float(tss.vars[k]) - float(jss.vars[k])) <= 1e-9, k
    assert float(np.max(np.abs(D.numpy() - np.asarray(jss.D)))) <= 1e-9
    for k in ("BH", "AH"):
        assert float(np.max(np.abs(tss.policies[k].numpy() - np.asarray(jss.policies[k])))) <= 1e-9


def test_two_dim_pipeline_zero_at_ss_matches_jax(toys):
    from hank_tpu.solvers.steady_state import single_run as jsingle

    jm, jss, tm, tss = toys
    Tm1 = tm.compspec.T - 1
    res = single_run(tss, tss, tm, {"Z": torch.ones(Tm1, dtype=f64)})
    ref = np.asarray(jsingle(jss, jss, jm, {"Z": jnp.ones(Tm1)}))
    assert float(res.abs().max()) < 1e-8
    assert float(np.max(np.abs(res.numpy() - ref))) <= 1e-9


def test_two_dim_jacobian_matches_dense_and_jax(toys):
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    jm, jss, tm, tss = toys
    J = get_steady_state_jacobian(tss, tm)
    dense = dense_path_jacobian(tss, tss, tm)
    assert float((J - dense).abs().max()) < 1e-8
    assert float(np.max(np.abs(J.numpy() - np.asarray(jjac(jss, jm))))) <= 1e-9


def test_two_dim_path_solve_matches_jax(toys):
    from hank_tpu.solvers.newton import newton_raphson_hank as jsolve
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    jm, jss, tm, tss = toys
    T = tm.compspec.T
    t = np.arange(1, T, dtype=np.float64)
    Z = 1.0 + 0.05 * 0.7 ** t
    x0 = torch.full((T - 1,), float(tss.vars["q"]), dtype=f64)
    x, info = newton_raphson_hank(x0, get_steady_state_jacobian(tss, tm), {"Z": torch.tensor(Z)},
                                  tm, tss, tss, method="newton_krylov", eps=1e-10)
    assert float(info["residual_norm"]) < 1e-10
    assert float((x - x0).abs().max()) > 1e-3
    x_ref, _ = jsolve(jnp.full((T - 1,), float(jss.vars["q"])), jjac(jss, jm),
                      {"Z": jnp.asarray(Z)}, jm, jss, jss, method="newton_krylov", eps=1e-10)
    assert float(np.max(np.abs(x.numpy() - np.asarray(x_ref)))) <= 1e-9
