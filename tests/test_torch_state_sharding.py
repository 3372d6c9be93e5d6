"""PyTorch port: the household state split over a mesh's "state" axis against
the unsplit port and against hank_tpu.

Two gloo ranks (`spawn_ranks`, rank body `tests/torch_ranks.py::state_rank`)
on the Krusell-Smith model with n_a = 32, n_e = 8, T = 10 and the JAX steady
state carried across (`tests/test_sharded_jacobian.py:29-34`'s model), at
x = 1.01·x_ss under Z_t = 1 + 0.1·0.8ᵗ: each rank's block of the backward
block's policy paths within 1e-11, and the forward block's aggregates
within 1e-12, of the port's unsplit blocks and of hank_tpu's
(`tests/test_sharded_jacobian.py:54, 72`); the split refused at n_e = 7.
The small two-asset model's backward block split over its access axis at
two ranks against the unsplit port within 1e-12 and hank_tpu within 1e-12
of the policies' scale, and a value_fn of a third or of mixed widths
refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.blocks.backward import backward_iteration
from hank_tpu_torch.blocks.forward import forward_iteration
from hank_tpu_torch.parallel.dryrun import spawn_ranks
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests import torch_ranks
from tests.test_torch_common import build_small_ks_torch, ss_to_numpy, to_torch

torch.set_num_threads(1)
N_A, N_E, T = 32, 8, 10


@pytest.fixture(scope="module")
def setup():
    from tests.conftest import build_small_ks, solve_ss_cached

    jm = build_small_ks(T=T, n_a=N_A, n_e=N_E)
    jss = solve_ss_cached(jm)
    endog = jm.vars_of_type("endogenous")
    x = np.tile(np.array([float(jss.vars[k]) for k in endog]), T - 1) * 1.01
    Z = 1.0 + 0.1 * 0.8 ** np.arange(1, T, dtype=np.float64)
    return jm, jss, x, Z


@pytest.fixture(scope="module")
def ranks(setup):
    _, jss, x, Z = setup
    return spawn_ranks(torch_ranks.state_rank, 2, ss_to_numpy(jss), x, Z, N_A, N_E, T,
                       device="cpu", timeout=300)


@pytest.fixture(scope="module")
def unsplit(setup):
    _, jss, x, Z = setup
    tm = build_small_ks_torch(T=T, n_a=N_A, n_e=N_E)
    tss = steady_state_from_numpy(ss_to_numpy(jss), device="cpu")
    pol = backward_iteration(to_torch(x), {"Z": to_torch(Z)}, tm, tss.vars, tss.value)
    return pol, forward_iteration(pol, tm, tss.D)


def test_ranks_hold_contiguous_blocks_of_the_last_exogenous_axis(ranks):
    assert [(r["start"], r["stop"], r["dim"]) for r in ranks] == [(0, 4, 2), (4, 8, 2)]
    for r in ranks:
        for p in r["policies"].values():
            assert p.shape == (T - 1, N_A, N_E // 2)


def test_backward_iteration_sharded_matches_unsplit_and_jax(setup, ranks, unsplit):
    from hank_tpu.blocks.backward import backward_iteration as jbackward

    jm, jss, x, Z = setup
    ref = jbackward(jnp.asarray(x), {"Z": jnp.asarray(Z)}, jm, jss.vars, jss.value)
    for k, p_unsplit in unsplit[0].items():
        gathered = torch.cat([r["policies"][k] for r in ranks], dim=-1)
        assert gathered.shape == p_unsplit.shape
        assert float((gathered - p_unsplit).abs().max()) <= 1e-11
        assert float(np.max(np.abs(gathered.numpy() - np.asarray(ref[k])))) <= 1e-11


def test_forward_iteration_sharded_matches_unsplit_and_jax(setup, ranks, unsplit):
    from hank_tpu.blocks.backward import backward_iteration as jbackward
    from hank_tpu.blocks.forward import forward_iteration as jforward

    jm, jss, x, Z = setup
    ref = jforward(jbackward(jnp.asarray(x), {"Z": jnp.asarray(Z)}, jm, jss.vars, jss.value),
                   jm, jss.D)
    for k, agg in unsplit[1].items():
        for r in ranks:                       # the same on every rank
            assert r["aggregates"][k].shape == (T - 1,)
            assert float((r["aggregates"][k] - agg).abs().max()) <= 1e-12
            assert float(np.max(np.abs(r["aggregates"][k].numpy() - np.asarray(ref[k])))) <= 1e-12


def test_state_split_refuses_an_axis_the_ranks_do_not_divide(ranks):
    assert all(r["n_e7_raises"] for r in ranks)


def test_backward_iteration_sharded_refuses_a_value_fn_that_does_not_split():
    """The two-asset value_fn stacks both access columns whatever the access
    dimension holds. Split over two ranks, each rank runs the whole step on
    the gathered value and keeps its access column: gathered, the policy
    paths are the port's unsplit block's within 1e-12, and the JAX
    package's (`backward_iteration` on the same inputs) within 1e-12 of
    their scale (the policies reach 120). A value_fn that
    returns a third width (its outputs three times over), or one output at
    the rank's width and the others at full width, is refused with
    ValueError on every rank, naming the model, the axis and the widths."""
    from hank_tpu.blocks.backward import backward_iteration as jbackward
    from tests.test_hank_two_asset import build_small_two_asset

    ranks = spawn_ranks(torch_ranks.two_asset_state_rank, 2, device="cpu", timeout=300)
    model = torch_ranks.build_small_two_asset_torch()
    x, exog, ss_vars, value = torch_ranks.two_asset_block_inputs(model)
    unsplit = backward_iteration(to_torch(x), {k: to_torch(v) for k, v in exog.items()}, model,
                                 {k: torch.tensor(v, dtype=torch.float64)
                                  for k, v in ss_vars.items()}, to_torch(value))
    ref = jbackward(jnp.asarray(x), {k: jnp.asarray(v) for k, v in exog.items()},
                    build_small_two_asset(), {k: jnp.asarray(v) for k, v in ss_vars.items()},
                    jnp.asarray(value))
    assert [(r["start"], r["stop"]) for r in ranks] == [(0, 1), (1, 2)]
    for k, p_unsplit in unsplit.items():
        gathered = torch.cat([r["policies"][k] for r in ranks], dim=-1)
        assert gathered.shape == p_unsplit.shape
        assert bool(torch.isfinite(gathered).all())
        assert float((gathered - p_unsplit).abs().max()) <= 1e-12
        scale = max(float(np.max(np.abs(np.asarray(ref[k])))), 1.0)
        assert float(np.max(np.abs(gathered.numpy() - np.asarray(ref[k])))) <= 1e-12 * scale
    for r in ranks:
        for label, width in (("tripled", "with 6 entries"), ("mixed", "with 1 entries")):
            msg = r["errors"][label]
            assert msg is not None and "Two-Asset HANK" in msg and "'access'" in msg, msg
            assert "returns" in msg and width in msg, msg
