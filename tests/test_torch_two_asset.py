"""PyTorch port: the two-asset HANK model against hank_tpu, in float64.

On the small two-asset model (24×12×4×2, T=12; the JAX package's
`build_small_two_asset` and its cached steady state): one Bellman step
(`ValueFunction`, values, policies and forward-mode tangents), the joint
two-axis Young lottery, the steady state from `find_ss`, J̄, the
checkpoint round trip and the linear impulse response. Tolerances are
relative to each output's scale: 1e-12 for the Bellman step, 1e-14 for the
lottery, 1e-10 for the steady state, 1e-9 for J̄ and the linear path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.models import load_model as load_model_torch
from hank_tpu_torch.models.hank_two_asset import ValueFunction, fiscalShock
from hank_tpu_torch.ops.transition import lottery_apply_multi
from hank_tpu_torch.solvers.linear import irf_table, linear_impulse_response
from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
from hank_tpu_torch.solvers.steady_state import find_ss
from hank_tpu_torch.utils import checkpoint
from tests.test_torch_common import build_small_two_asset_torch, ss_to_numpy, to_torch

torch.set_num_threads(1)
f64 = torch.float64
PRICES = ("r", "ra", "tau", "w")


@pytest.fixture(scope="module")
def jax_side():
    from tests.conftest import solve_ss_cached
    from tests.test_hank_two_asset import build_small_two_asset

    jm = build_small_two_asset()
    return jm, solve_ss_cached(jm)


@pytest.fixture(scope="module")
def port_side(jax_side):
    _, jss = jax_side
    return build_small_two_asset_torch(), checkpoint.steady_state_from_numpy(ss_to_numpy(jss), device="cpu")


@pytest.fixture(scope="module")
def jbar(jax_side):
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jax_jacobian

    jm, jss = jax_side
    return np.asarray(jax_jacobian(jss, jm))


def rel_err(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(out.detach().numpy() - ref))) / max(float(np.max(np.abs(ref))), 1.0)


def bellman_inputs(jss, trial: int):
    """The steady-state value and prices, then perturbed ones (seeded)."""
    rng = np.random.default_rng(trial)
    V = np.asarray(jss.value)
    if trial:
        V = V * (1.0 + 0.05 * rng.normal(size=V.shape))
    x = np.array([float(jss.vars[k]) for k in PRICES]) * (1.0 + 0.02 * trial)
    return V, x, rng.normal(size=V.shape), rng.normal(size=len(PRICES))


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_value_function_matches_jax(jax_side, port_side, trial):
    from hank_tpu.models.hank_two_asset import ValueFunction as jax_value_function

    jm, jss = jax_side
    tm, _ = port_side
    V, x, dV, dx = bellman_inputs(jss, trial)

    def jf(v, xx):
        return jax_value_function(v, dict(zip(PRICES, xx)), jm)

    def tf(v, xx):
        return ValueFunction(v, dict(zip(PRICES, xx)), tm)

    ref, dref = jax.jvp(jf, (jnp.asarray(V), jnp.asarray(x)), (jnp.asarray(dV), jnp.asarray(dx)))
    out, dout = torch.func.jvp(tf, (to_torch(V), to_torch(x)), (to_torch(dV), to_torch(dx)))
    assert ValueFunction.n_values == 2 and out["Value"].shape == (2, 24, 12, 4, 2)
    for k in ("Value", "B", "A", "C"):
        assert rel_err(out[k], ref[k]) <= 1e-12, k
        assert rel_err(dout[k], dref[k]) <= 1e-12, k


@pytest.mark.parametrize("where", ["steady_state", "perturbed"])
def test_joint_lottery_matches_jax(jax_side, port_side, where):
    """The dense soft-one-hot joint lottery (every device) against the JAX
    package's, at the steady-state policies and at perturbed ones that also
    leave the grid box on both sides."""
    from hank_tpu.ops.transition import lottery_apply_multi as jax_lottery

    jm, jss = jax_side
    tm, _ = port_side
    rng = np.random.default_rng(3)
    D = np.asarray(jss.D)
    pb, pa = np.asarray(jss.policies["B"]), np.asarray(jss.policies["A"])
    if where == "perturbed":
        D = rng.random(D.shape)
        D /= D.sum()
        pb = pb + 30.0 * rng.normal(size=pb.shape)
        pa = pa + 60.0 * rng.normal(size=pa.shape)
    jgrids = [jm.heterogeneity[k].grid for k in ("liquid", "illiquid")]
    tgrids = [tm.heterogeneity[k].grid for k in ("liquid", "illiquid")]
    ref = jax_lottery([jnp.asarray(pb), jnp.asarray(pa)], jnp.asarray(D), jgrids)
    out = lottery_apply_multi([to_torch(pb), to_torch(pa)], to_torch(D), tgrids)
    assert out.shape == D.shape
    assert rel_err(out, ref) <= 1e-14
    assert abs(float(out.sum()) - float(D.sum())) <= 1e-14
    with pytest.raises(ValueError, match="1 or 2 endogenous axes"):
        lottery_apply_multi([to_torch(pb)] * 3, to_torch(D), tgrids * 2)


def test_find_ss_matches_jax(jax_side, port_side):
    """The port's projected Newton (VFI with the (V_b, V_a) axis, the
    matrix-free invariant distribution with its implicit derivative) lands
    on the JAX package's steady state. It starts 2% off that state, so the
    test takes two to three Newton steps, not the cold start's four."""
    jm, jss = jax_side
    tm, _ = port_side
    spec = dataclasses.replace(
        tm.ss_initial, guesses={k: 1.02 * float(jss.vars[k]) for k in tm.ss_initial.guesses})
    ss = find_ss(tm, spec, "initial")
    for k in tm.var_names():
        assert abs(float(ss.vars[k]) - float(jss.vars[k])) <= 1e-10, k
    assert rel_err(ss.D, jss.D) <= 1e-10
    assert rel_err(ss.value, jss.value) <= 1e-10
    for k in ("B", "A", "C"):
        assert rel_err(ss.policies[k], jss.policies[k]) <= 1e-10, k
    p = tm.params
    assert abs(float(ss.vars["B"]) - p["Bg"]) <= 1e-8
    assert abs(float(ss.vars["A"]) - float(ss.vars["KS"])) <= 1e-8


def test_steady_state_jacobian_matches_jax(port_side, jbar):
    tm, tss = port_side
    J = get_steady_state_jacobian(tss, tm)
    assert J.shape == jbar.shape == (11 * 5, 11 * 5)
    assert rel_err(J, jbar) <= 1e-9


def test_checkpoint_round_trip(port_side, tmp_path):
    tm, tss = port_side
    path = checkpoint.save_steady_state(tss, tm, "initial", str(tmp_path))
    back = checkpoint.load_steady_state(tm, "initial", str(tmp_path))
    assert path.endswith(".npz") and back.value.shape == (2, 24, 12, 4, 2)
    assert torch.equal(back.value, tss.value) and torch.equal(back.D, tss.D)
    assert all(torch.equal(back.policies[k], tss.policies[k]) for k in ("B", "A", "C"))
    ks = load_model_torch("krusell_smith", T=12, device="cpu")
    assert checkpoint.model_hash(tm) != checkpoint.model_hash(ks)
    assert checkpoint.model_hash(tm) != checkpoint.model_hash(build_small_two_asset_torch(lam=0.2))


def test_linear_impulse_response_matches_jax(jax_side, port_side, jbar):
    from hank_tpu.models.hank_two_asset import fiscalShock as jax_fiscal_shock
    from hank_tpu.solvers.linear import irf_table as jax_irf_table
    from hank_tpu.solvers.linear import linear_impulse_response as jax_linear

    jm, jss = jax_side
    tm, tss = port_side
    Tm1 = tm.compspec.T - 1
    G = fiscalShock(Tm1)
    np.testing.assert_array_equal(G.numpy(), np.asarray(jax_fiscal_shock(Tm1)))
    xj, ij = jax_linear(jnp.asarray(jbar), {"G": jnp.asarray(G.numpy())}, jm, jss, jss)
    x, info = linear_impulse_response(to_torch(jbar), {"G": G}, tm, tss, tss)
    assert rel_err(x, xj) <= 1e-9 and rel_err(info["dx"], ij["dx"]) <= 1e-9
    for k in ("f0_norm", "residual_norm"):
        assert info[k] == pytest.approx(float(ij[k]), rel=1e-9), k
    irf, jirf = irf_table(x, tm, tss), jax_irf_table(xj, jm, jss)
    assert set(irf) == set(jirf)
    for k in irf:
        assert float(np.max(np.abs(irf[k].numpy() - np.asarray(jirf[k])))) <= 1e-9, k
