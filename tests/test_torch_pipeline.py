"""PyTorch port: the F(x) pipeline and the linear algebra against hank_tpu.

Same inputs, made with numpy from a seed, go through the JAX function and
its port on the small Krusell-Smith (40×5, T=12). The steady state is the
JAX suite's disk-cached one, carried across with `steady_state_from_numpy`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import (build_small_ks_torch, ss_to_numpy, to_torch,
                                     transitory_exog)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both(ks_small, ks_small_ss):
    """(jax model, jax ss, jax exog, torch model, torch ss, torch exog, x_ss)."""
    T = ks_small.compspec.T
    z = transitory_exog(T)
    tm = build_small_ks_torch(T=T)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    endog = ks_small.vars_of_type("endogenous")
    x_ss = np.tile(np.array([float(ks_small_ss.vars[k]) for k in endog]), T - 1)
    return (ks_small, ks_small_ss, {"Z": jnp.asarray(z)}, tm, tss,
            {"Z": to_torch(z)}, x_ss)


def test_interp_columns_matches_jax_gather_form():
    from hank_tpu.ops.egm import interp_columns as jinterp
    from hank_tpu_torch.ops.egm import interp_columns as tinterp

    rng = np.random.default_rng(0)
    knots = np.sort(rng.uniform(0.0, 10.0, size=(30, 4)), axis=0)
    knots[5:8, 1] = knots[5:8, 1][::-1]            # locally non-monotone column
    vals = rng.normal(size=(30, 4))
    x = rng.uniform(-1.0, 11.0, size=(25, 4))
    out_t = tinterp(to_torch(x), to_torch(knots), to_torch(vals)).numpy()
    out_j = np.asarray(jinterp(jnp.asarray(x), jnp.asarray(knots), jnp.asarray(vals),
                               mode="gather"))
    assert np.max(np.abs(out_t - out_j)) <= 1e-14


def test_lottery_forward_and_reverse_ad_match_jax():
    """`scatter_add` lottery: values, forward-mode and reverse-mode
    derivatives in the policy against jax.jvp / jax.vjp."""
    from hank_tpu.ops.transition import forward_step as jstep
    from hank_tpu_torch.ops.transition import forward_step as tstep

    rng = np.random.default_rng(1)
    grid = np.sort(rng.uniform(0.0, 10.0, 20))
    grid[0] = 0.0
    Pi = rng.uniform(size=(3, 3))
    Pi /= Pi.sum(axis=1, keepdims=True)
    pol = rng.uniform(-0.5, 10.5, size=(20, 3))
    pol[:4, 0] = 0.0                                # mass at the bottom knot
    D = rng.uniform(size=(20, 3))
    D /= D.sum()
    dpol = rng.normal(size=(20, 3))
    cot = rng.normal(size=(20, 3))

    jf = lambda p: jstep(p, jnp.asarray(D), jnp.asarray(grid), [jnp.asarray(Pi)])  # noqa: E731
    tf = lambda p: tstep(p, to_torch(D), to_torch(grid), [to_torch(Pi)])           # noqa: E731
    jv, jt = jax.jvp(jf, (jnp.asarray(pol),), (jnp.asarray(dpol),))
    tv, tt = torch.func.jvp(tf, (to_torch(pol),), (to_torch(dpol),))
    assert np.max(np.abs(tv.numpy() - np.asarray(jv))) <= 1e-15
    assert np.max(np.abs(tt.numpy() - np.asarray(jt))) <= 1e-13
    _, jpb = jax.vjp(jf, jnp.asarray(pol))
    _, tpb = torch.func.vjp(tf, to_torch(pol))
    assert np.max(np.abs(tpb(to_torch(cot))[0].numpy()
                         - np.asarray(jpb(jnp.asarray(cot))[0]))) <= 1e-13


@pytest.mark.parametrize("seed", [0, 1])
def test_full_residual_matches_jax(both, seed):
    from hank_tpu.solvers.newton import make_full_residual_fn as jmake
    from hank_tpu_torch.solvers.newton import make_full_residual_fn as tmake

    jm, jss, jex, tm, tss, tex, x_ss = both
    rng = np.random.default_rng(seed)
    x = x_ss + 0.01 * rng.normal(size=x_ss.shape)
    out_j = np.asarray(jax.jit(jmake(jm, jss, jss, jex))(jnp.asarray(x)))
    out_t = tmake(tm, tss, tss, tex)(to_torch(x)).numpy()
    assert np.max(np.abs(out_t - out_j)) <= 1e-12


def test_full_residual_jvp_matches_jax(both):
    from hank_tpu.solvers.newton import make_full_residual_fn as jmake
    from hank_tpu_torch.solvers.newton import make_full_residual_fn as tmake

    jm, jss, jex, tm, tss, tex, x_ss = both
    rng = np.random.default_rng(2)
    x = x_ss + 0.01 * rng.normal(size=x_ss.shape)
    v = rng.normal(size=x_ss.shape)
    Fj = jmake(jm, jss, jss, jex)
    _, jt = jax.jit(lambda a, b: jax.jvp(Fj, (a,), (b,)))(jnp.asarray(x), jnp.asarray(v))
    _, tt = torch.func.jvp(tmake(tm, tss, tss, tex), (to_torch(x),), (to_torch(v),))
    assert np.max(np.abs(tt.numpy() - np.asarray(jt))) <= 1e-11


def test_dense_transition_and_invariant_distribution_match_jax(both):
    from hank_tpu.ops.linalg import invariant_dist_colstoch as jinv
    from hank_tpu.ops.transition import dense_full_transition as jdense
    from hank_tpu_torch.ops.linalg import invariant_dist_colstoch as tinv
    from hank_tpu_torch.ops.transition import dense_full_transition as tdense

    jm, jss, _, tm, tss, _, _ = both
    w, e = jm.heterogeneity["wealth"], jm.heterogeneity["productivity"]
    lam_j = jdense(jss.policies["KD"], w.grid, [e.transition])
    tw, te = tm.heterogeneity["wealth"], tm.heterogeneity["productivity"]
    lam_t = tdense(tss.policies["KD"], tw.grid, [te.transition])
    assert np.max(np.abs(lam_t.numpy() - np.asarray(lam_j))) <= 1e-15
    D_t = tinv(lam_t).numpy()
    assert np.max(np.abs(D_t - np.asarray(jinv(lam_j)))) <= 1e-12
    assert np.max(np.abs(D_t.reshape(tss.D.shape) - tss.D.numpy())) <= 1e-12


@pytest.mark.parametrize("restart,maxiter", [(10, 2), (5, 3), (40, 1)])
def test_gmres_matches_jax(restart, maxiter):
    """Same operator, preconditioner and right-hand side from one seed;
    restart=40 > n also exercises the zero-basis-vector breakdown path."""
    from hank_tpu.ops.linalg import gmres_matfree as jgmres
    from hank_tpu_torch.ops.linalg import gmres_matfree as tgmres

    rng = np.random.default_rng(restart)
    n = 30
    A = np.eye(n) + 0.3 * rng.normal(size=(n, n)) / np.sqrt(n)
    Minv = np.linalg.inv(A + 0.05 * rng.normal(size=(n, n)) / np.sqrt(n))
    b = rng.normal(size=n)
    x0 = 0.1 * rng.normal(size=n)
    Aj, Mj, At, Mt = jnp.asarray(A), jnp.asarray(Minv), to_torch(A), to_torch(Minv)
    xj, rj = jax.jit(lambda bb, xx: jgmres(lambda v: Aj @ v, bb, xx, M=lambda v: Mj @ v,
                                           restart=restart, maxiter=maxiter,
                                           tol=1e-14))(jnp.asarray(b), jnp.asarray(x0))
    xt, rt = tgmres(lambda v: At @ v, to_torch(b), to_torch(x0), M=lambda v: Mt @ v,
                    restart=restart, maxiter=maxiter, tol=1e-14)
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) <= 1e-12
    assert abs(float(rt) - float(rj)) <= 1e-12


def test_reusable_solver_and_rayleigh_quotient():
    from hank_tpu_torch.ops.linalg import make_reusable_solver, rayleigh_quotient

    rng = np.random.default_rng(4)
    A = to_torch(np.eye(12) + 0.2 * rng.normal(size=(12, 12)))
    b = to_torch(rng.normal(size=12))
    solve = make_reusable_solver(A)
    assert float((A @ solve(b) - b).abs().max()) <= 1e-13
    assert solve.A_inv.shape == (12, 12)
    y = to_torch(rng.normal(size=12))
    assert abs(float(rayleigh_quotient(A @ y, y)) - float(y @ (A @ y) / (y @ y))) <= 1e-14
    assert float(rayleigh_quotient(b, torch.zeros(12, dtype=torch.float64))) == 0.0
