"""PyTorch port: steady states, J̄ and the npz artifacts against hank_tpu,
on the small Krusell-Smith (40×5, T=12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
from hank_tpu_torch.solvers.steady_state import find_ss
from hank_tpu_torch.utils.checkpoint import (load_jacobian_npz, load_steady_state_npz,
                                             steady_state_from_numpy)
from tests.test_torch_common import build_small_ks_torch, ss_to_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ported_initial_ss():
    tm = build_small_ks_torch(T=12)
    return tm, find_ss(tm, tm.ss_initial, "initial")


def test_find_ss_matches_jax(ks_small_ss, ported_initial_ss):
    _, tss = ported_initial_ss
    for k, v in ks_small_ss.vars.items():
        assert abs(float(tss.vars[k]) - float(v)) <= 1e-10, k
    assert float(np.max(np.abs(tss.D.numpy() - np.asarray(ks_small_ss.D)))) <= 1e-10
    assert float(np.max(np.abs(tss.policies["KD"].numpy()
                               - np.asarray(ks_small_ss.policies["KD"])))) <= 1e-9


def test_ss_residual_and_stationarity(ported_initial_ss):
    from hank_tpu_torch.blocks.assemble import residuals
    from hank_tpu_torch.ops.transition import forward_step

    tm, tss = ported_initial_ss
    cs = tm.compspec
    col = torch.stack([tss.vars[k] for k in tm.var_names()])
    z = residuals(col[:, None].expand(cs.n_v, 1 + cs.max_lag + cs.max_lead), tm)
    assert float(torch.linalg.norm(z)) <= 1e-9
    e = tm.exog_dims()[0]
    D1 = forward_step(tss.policies["KD"], tss.D, tm.endog_dims()[0].grid, [e.transition])
    assert float((D1 - tss.D).abs().max()) <= 1e-12
    assert abs(float(torch.sum(tss.D)) - 1.0) <= 1e-13


def test_steady_state_jacobian_matches_jax(ks_small, ks_small_ss):
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    tm = build_small_ks_torch(T=12)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    J_t = get_steady_state_jacobian(tss, tm).numpy()
    J_j = np.asarray(jjac(ks_small_ss, ks_small))
    assert J_t.shape == J_j.shape == (44, 44)
    assert float(np.max(np.abs(J_t - J_j))) <= 1e-9


def test_jax_npz_artifacts_load_into_the_port(ks_small, ks_small_ss, tmp_path):
    from hank_tpu.utils.checkpoint import save_jacobian, save_steady_state

    path = save_steady_state(ks_small_ss, ks_small, "initial", cache_dir=str(tmp_path))
    tss = load_steady_state_npz(path, device="cpu")
    for k, v in ks_small_ss.vars.items():
        assert float(tss.vars[k]) == float(v)
    assert np.array_equal(tss.value.numpy(), np.asarray(ks_small_ss.value))
    assert np.array_equal(tss.D.numpy(), np.asarray(ks_small_ss.D))
    J = jnp.asarray(np.random.default_rng(0).normal(size=(8, 8)))
    jpath = save_jacobian(J, ks_small, cache_dir=str(tmp_path))
    assert np.array_equal(load_jacobian_npz(jpath, device="cpu").numpy(), np.asarray(J))


def test_port_cache_round_trip(ks_small_ss, tmp_path):
    from hank_tpu_torch.utils.checkpoint import (load_jacobian, load_steady_state,
                                                 save_jacobian, save_steady_state)

    tm = build_small_ks_torch(T=12)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    assert load_steady_state(tm, "initial", str(tmp_path)) is None
    save_steady_state(tss, tm, "initial", str(tmp_path))
    back = load_steady_state(tm, "initial", str(tmp_path))
    assert all(torch.equal(back.vars[k], tss.vars[k]) for k in tss.vars)
    assert torch.equal(back.policies["KD"], tss.policies["KD"])
    J = torch.arange(16.0, dtype=torch.float64).reshape(4, 4)
    save_jacobian(J, tm, str(tmp_path))
    assert torch.equal(load_jacobian(tm, str(tmp_path)), J)
    other_T = build_small_ks_torch(T=13)
    assert load_jacobian(other_T, str(tmp_path)) is None          # J̄ keys on T
    assert load_steady_state(other_T, "initial", str(tmp_path)) is not None
