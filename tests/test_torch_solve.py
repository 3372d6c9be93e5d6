"""PyTorch port: the slice as a whole against hank_tpu.

Newton-Krylov with f32 directions (kernel 1's plain version on the CPU)
and full-precision residuals (kernel 2's plain version) on the small
Krusell-Smith (40×5, T=12) at eps = 1e-10, held pointwise to 1e-9 against
the JAX package's solution, from the JAX steady state and J̄ carried across
(`tests/test_torch_solve_own.py` runs it from the port's own setup).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.solvers.newton import (make_full_residual_fn, make_path_solver,
                                           newton_raphson_hank)
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import (build_small_ks_torch, ss_to_numpy, to_torch,
                                     transitory_exog)

torch.set_num_threads(1)


def jax_reference_solution(Jbar, exog, model, ss0, ssT, x0):
    """The hank_tpu root at eps 1e-11 (f64 directions)."""
    from hank_tpu.solvers.newton import make_path_solver as jmake

    x, info = jmake(Jbar, exog, model, ss0, ssT, method="newton_krylov",
                    eps=1e-11)(x0)
    assert float(info["residual_norm"]) < 1e-11
    return np.asarray(x)


def x_ss_of(model, ss):
    endog = model.vars_of_type("endogenous")
    return np.tile(np.array([float(ss.vars[k]) for k in endog]), model.compspec.T - 1)


def test_slice_from_carried_across_steady_state(ks_small, ks_small_ss):
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    T = ks_small.compspec.T
    z = transitory_exog(T)
    Jj = jjac(ks_small_ss, ks_small)
    x0 = x_ss_of(ks_small, ks_small_ss)
    x_ref = jax_reference_solution(Jj, {"Z": jnp.asarray(z)}, ks_small, ks_small_ss,
                                   ks_small_ss, jnp.asarray(x0))

    tm = build_small_ks_torch(T=T)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss))
    records = []
    x, info = newton_raphson_hank(to_torch(x0), to_torch(np.asarray(Jj)),
                                  {"Z": to_torch(z)}, tm, tss, tss,
                                  direction_dtype=torch.float32, eps=1e-10,
                                  gmres_restart=10, records=records)
    assert info["residual_norm"] < 1e-10
    assert len(records) == info["iterations"] >= 1
    assert float(np.max(np.abs(x.numpy() - x_ref))) <= 1e-9


def test_path_solver_rejects_what_is_not_ported(ks_small_ss):
    tm = build_small_ks_torch(T=12)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss))
    J = torch.eye(44, dtype=torch.float64)
    exog = {"Z": to_torch(transitory_exog(12))}
    with pytest.raises(ValueError, match="host_inner"):
        make_path_solver(J, exog, tm, tss, tss, method="newton_krylov", host_inner=True)
    with pytest.raises(NotImplementedError):
        make_path_solver(J, exog, tm, tss, tss, direction_dtype=torch.float64)
    with pytest.raises(ValueError):
        make_path_solver(J, exog, tm, tss, tss, method="dense")


@pytest.mark.slow
def test_full_size_residual_matches_jax():
    """KS 200×7, T=300: F(x) of the port's plain blocks and kernel-2 plain
    version against the JAX f64 pipeline, from the JAX steady states."""
    import jax

    from hank_tpu.models import load_model
    from hank_tpu.solvers.newton import make_full_residual_fn as jmake
    from hank_tpu.utils.checkpoint import get_or_solve as jget_or_solve
    from hank_tpu_torch.models import load_model as tload
    from hank_tpu_torch.ops.fused_residual import make_sweep_residual_fn

    jm = load_model("krusell_smith", T=300)
    jss0, jssT, _ = jget_or_solve(jm)
    tm = tload("krusell_smith", T=300)
    ss0 = steady_state_from_numpy(ss_to_numpy(jss0))
    ssT = steady_state_from_numpy(ss_to_numpy(jssT))
    z = transitory_exog(300)
    x = x_ss_of(jm, jssT) + 0.01 * np.random.default_rng(0).normal(size=4 * 299)
    ref = np.asarray(jax.jit(jmake(jm, jss0, jssT, {"Z": jnp.asarray(z)}))(jnp.asarray(x)))
    for F in (make_full_residual_fn(tm, ss0, ssT, {"Z": to_torch(z)}),
              make_sweep_residual_fn(tm, ss0, ssT, {"Z": to_torch(z)})):
        assert float(np.max(np.abs(F(to_torch(x)).numpy() - ref))) <= 1e-11
