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
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    records = []
    x, info = newton_raphson_hank(to_torch(x0), to_torch(np.asarray(Jj)),
                                  {"Z": to_torch(z)}, tm, tss, tss, method="newton_krylov",
                                  direction_dtype=torch.float32, direction_mode="pallas",
                                  eps=1e-10, gmres_restart=10, records=records)
    assert info["residual_norm"] < 1e-10
    assert len(records) == info["iterations"] >= 1
    assert float(np.max(np.abs(x.numpy() - x_ref))) <= 1e-9


def test_path_solver_rejects_what_is_not_ported(ks_small_ss):
    tm = build_small_ks_torch(T=12)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    J = torch.eye(44, dtype=torch.float64)
    exog = {"Z": to_torch(transitory_exog(12))}
    with pytest.raises(ValueError, match="host_inner"):
        make_path_solver(J, exog, tm, tss, tss, method="newton_krylov", host_inner=True)
    with pytest.raises(ValueError, match="direction_dtype"):
        make_path_solver(J, exog, tm, tss, tss, direction_dtype=torch.float16)
    with pytest.raises(ValueError):
        make_path_solver(J, exog, tm, tss, tss, method="dense")
    with pytest.raises(ValueError, match="residual_mode"):
        make_path_solver(J, exog, tm, tss, tss, residual_mode="bf16")


@pytest.mark.parametrize("direction_dtype", [None, torch.float64])
def test_slice_with_f64_directions(ks_small, ks_small_ss, direction_dtype):
    """f64 directions (`torch.func.jvp` of the plain pipeline, GMRES to
    1e-12, the f64 J̄⁻¹ preconditioner): the same root as the JAX package's
    to 1e-9, and the same outer count as its f64-direction solve."""
    from hank_tpu.solvers.newton import make_path_solver as jmake
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    T = ks_small.compspec.T
    z = transitory_exog(T)
    Jj = jjac(ks_small_ss, ks_small)
    x0 = x_ss_of(ks_small, ks_small_ss)
    xj, ij = jmake(Jj, {"Z": jnp.asarray(z)}, ks_small, ks_small_ss, ks_small_ss,
                   method="newton_krylov", eps=1e-10)(jnp.asarray(x0))
    tm = build_small_ks_torch(T=T)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    x, info = make_path_solver(to_torch(np.asarray(Jj)), {"Z": to_torch(z)}, tm, tss, tss,
                               method="newton_krylov", direction_dtype=direction_dtype,
                               eps=1e-10)(to_torch(x0))
    assert info["residual_norm"] < 1e-10 and x.dtype == torch.float64
    assert info["iterations"] == int(ij["iterations"])
    assert float(np.max(np.abs(x.numpy() - np.asarray(xj)))) <= 1e-9


@pytest.mark.parametrize("mode", ["auto", "ds", "f64"])
def test_residual_mode_picks_the_residual(ks_small_ss, mode):
    """"auto" and "ds" take kernel 2 (its plain version on the CPU), "f64"
    the plain pipeline; all three agree to 1e-12."""
    from hank_tpu_torch.ops.fused_residual import fused_residual_sweep_reference
    from hank_tpu_torch.solvers.newton import residual_route

    tm = build_small_ks_torch(T=12)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    exog = {"Z": to_torch(transitory_exog(12))}
    x = to_torch(x_ss_of(tm, tss)) * 1.001
    calls = fused_residual_sweep_reference.calls
    F = residual_route(tm, tss, tss, exog, mode)(x)
    assert fused_residual_sweep_reference.calls == calls + (mode != "f64")
    assert float((F - make_full_residual_fn(tm, tss, tss, exog)(x)).abs().max()) <= 1e-12


def test_residual_mode_ds_needs_the_kernel_family(ks_small_ss):
    import dataclasses

    from hank_tpu_torch.solvers.newton import residual_route

    tm = build_small_ks_torch(T=12)
    other = dataclasses.replace(tm, value_fn=lambda v, x, m: None)
    with pytest.raises(ValueError, match="residual_mode='ds'"):
        residual_route(other, None, None, {}, "ds")


def test_path_solver_defaults_follow_the_jax_package():
    """Every parameter the two `make_path_solver`s share has the same
    default (None and torch.float64 both mean f64 directions), and so do the
    drivers' `solve_model`s (`hank_tpu/run.py:41-45`)."""
    import inspect

    from hank_tpu.run import solve_model as jsolve_model
    from hank_tpu.solvers.newton import make_path_solver as jmake
    from hank_tpu_torch.run import solve_model

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    port, ref = defaults(make_path_solver), defaults(jmake)
    for k in ("method", "eps", "max_inner", "gmres_restart", "gmres_maxiter",
              "direction_dtype", "direction_mode", "stall_rescue", "endgame", "max_outer",
              "richardson_max_outer", "residual_mode", "host_inner"):
        assert port[k] == ref[k], k
    assert port["method"] == "boehl" and port["direction_dtype"] is None
    assert port["direction_mode"] == "auto"
    # Left out on purpose: `host_outer` (every loop of the port is a host
    # loop: torch runs eagerly, there is no traced twin to switch to).
    assert set(ref) - set(port) == {"host_outer"}
    # `endgame_gmres_tol`: None here means the reference's 1e-3 and lets the
    # port refuse the option where it would be ignored (ADVICE.md).
    assert ref["endgame_gmres_tol"] == 1e-3 and port["endgame_gmres_tol"] is None
    assert defaults(solve_model) == defaults(jsolve_model)


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
    tm = tload("krusell_smith", T=300, device="cpu")
    ss0 = steady_state_from_numpy(ss_to_numpy(jss0), device="cpu")
    ssT = steady_state_from_numpy(ss_to_numpy(jssT), device="cpu")
    z = transitory_exog(300)
    x = x_ss_of(jm, jssT) + 0.01 * np.random.default_rng(0).normal(size=4 * 299)
    ref = np.asarray(jax.jit(jmake(jm, jss0, jssT, {"Z": jnp.asarray(z)}))(jnp.asarray(x)))
    for F in (make_full_residual_fn(tm, ss0, ssT, {"Z": to_torch(z)}),
              make_sweep_residual_fn(tm, ss0, ssT, {"Z": to_torch(z)})):
        assert float(np.max(np.abs(F(to_torch(x)).numpy() - ref))) <= 1e-11
