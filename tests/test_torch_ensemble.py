"""PyTorch port: the ensemble solvers against hank_tpu.

`solve_ensemble_host` (lockstep Newton-Krylov and lockstep boehl Richardson,
f32 directions from the batched kernel's plain version on the CPU, f64
residuals from the batched kernel 2's plain version) on the small
Krusell-Smith (40×5, T=12) with B=6 shock paths Z_b,t = 1 + 0.05·ρ_bᵗ, held
pointwise to 1e-7 against the JAX package's `solve_ensemble_host` with its
vmapped XLA sweeps, from the JAX steady state and J̄ carried across
(`tests/test_sharding.py:131-202` holds the reference to the same bounds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hank_tpu_torch
from hank_tpu_torch.parallel import ensemble
from hank_tpu_torch.parallel.ensemble import solve_ensemble, solve_ensemble_host
from hank_tpu_torch.solvers.newton import _boehl_alpha, newton_raphson_hank
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import build_small_ks_torch, ss_to_numpy, to_torch
from tests.torch_ranks import MeshOfSize

torch.set_num_threads(1)
B = 6


@pytest.fixture(scope="module")
def setup(ks_small, ks_small_ss):
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    T = ks_small.compspec.T
    t = np.arange(1, T, dtype=np.float64)
    rhos = 0.5 + 0.4 * np.arange(B) / B
    Z = 1.0 + 0.05 * rhos[:, None] ** t[None, :]
    endog = ks_small.vars_of_type("endogenous")
    x0 = np.tile(np.array([float(ks_small_ss.vars[k]) for k in endog]), T - 1)
    J = np.asarray(jjac(ks_small_ss, ks_small))
    tm = build_small_ks_torch(T=T)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    return ks_small, ks_small_ss, tm, tss, x0, J, Z


@pytest.fixture(scope="module")
def port_solves(setup):
    """The port's ensemble solve by each method, with its records."""
    _, _, tm, tss, x0, J, Z = setup
    out = {}
    for method in ("newton_krylov", "boehl"):
        records = []
        x, info = solve_ensemble_host(to_torch(x0), to_torch(J), {"Z": to_torch(Z)},
                                      tm, tss, tss, eps=1e-9, method=method,
                                      records=records)
        out[method] = (x, info, records)
    return out


@pytest.mark.parametrize("method", ["newton_krylov", "boehl"])
def test_solve_ensemble_host_matches_jax(setup, port_solves, method):
    from hank_tpu.parallel.ensemble import solve_ensemble_host as jsolve

    jm, jss, _, _, x0, J, Z = setup
    x_ref, info_ref = jsolve(jnp.asarray(x0), jnp.asarray(J), {"Z": jnp.asarray(Z)},
                             jm, jss, jss, eps=1e-9, method=method, fused="xla")
    assert bool(jnp.all(info_ref["residual_norm"] < 1e-9))
    x, info, records = port_solves[method]
    assert x.shape == (B, x0.shape[0]) and x.dtype == torch.float64
    assert bool((info["residual_norm"] < 1e-9).all()) and info["stalled_paths"] == 0
    assert records and records[-1]["converged"] == B
    assert len(records) == info["iterations"]
    assert float(np.max(np.abs(x.numpy() - np.asarray(x_ref)))) <= 1e-7


def test_newton_krylov_needs_a_third_of_the_richardson_sweeps(port_solves):
    x_nk, info_nk, _ = port_solves["newton_krylov"]
    x_rich, info_rich, _ = port_solves["boehl"]
    assert float((x_nk - x_rich).abs().max()) <= 1e-7
    assert info_nk["inner_iterations"] < info_rich["inner_iterations"] / 3
    assert info_nk["host_ls_seconds"] >= 0.0


def test_ensemble_row_matches_the_single_path_solver(setup, port_solves):
    _, _, tm, tss, x0, J, Z = setup
    x_one, info = newton_raphson_hank(to_torch(x0), to_torch(J), {"Z": to_torch(Z[2])},
                                      tm, tss, tss, method="newton_krylov",
                                      direction_dtype=torch.float32, direction_mode="pallas",
                                      eps=1e-10, gmres_restart=10)
    assert info["residual_norm"] < 1e-10
    x_nk = port_solves["newton_krylov"][0]
    assert float((x_nk[2] - x_one).abs().max()) <= 1e-7


@pytest.mark.parametrize("method", ["boehl", "newton_krylov"])
def test_solve_ensemble_host_survives_a_bad_path(setup, method):
    """A Z < 0 row (an infeasible economy) freezes at its best iterate and is
    reported in `stalled_paths`; the other rows converge
    (`tests/test_sharding.py:131-160`, there for boehl)."""
    _, _, tm, tss, x0, J, _ = setup
    T = tm.compspec.T
    t = np.arange(1, T, dtype=np.float64)
    Z = np.stack([1.0 + 0.05 * 0.8 ** t, 1.0 + 0.08 * 0.6 ** t,
                  1.0 - 1.5 * 0.999 ** t, 1.0 + 0.03 * 0.9 ** t])
    x, info = solve_ensemble_host(to_torch(x0), to_torch(J), {"Z": to_torch(Z)},
                                  tm, tss, tss, eps=1e-9, max_outer=30, method=method)
    good = [0, 1, 3]
    assert x.shape == (4, x0.shape[0])
    assert bool((info["residual_norm"][good] < 1e-9).all())
    assert bool(torch.isfinite(x[good]).all())
    assert info["stalled_paths"] >= 1


def test_what_is_not_ported_raises(setup):
    _, _, tm, tss, x0, J, Z = setup
    args = (to_torch(x0), to_torch(J), {"Z": to_torch(Z)}, tm, tss, tss)
    with pytest.raises(ValueError, match="6 rows do not split over the 4 ranks"):
        solve_ensemble_host(*args, mesh=MeshOfSize(4))
    with pytest.raises(ValueError, match="direction_dtype"):
        solve_ensemble_host(*args, direction_dtype=torch.float16)
    with pytest.raises(ValueError):
        solve_ensemble_host(*args, method="dense")
    with pytest.raises(NotImplementedError):
        solve_ensemble(*args, chunk=64)
    with pytest.raises(NotImplementedError):
        solve_ensemble(*args, method="dense")


def test_solve_ensemble_routes_to_solve_ensemble_host(setup, monkeypatch):
    _, _, tm, tss, x0, J, Z = setup
    seen = {}

    def host(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        return "routed"

    monkeypatch.setattr(ensemble, "solve_ensemble_host", host)
    args = (to_torch(x0), to_torch(J), {"Z": to_torch(Z)}, tm, tss, tss)
    out = solve_ensemble(*args, method="newton_krylov", eps=1e-9, max_outer=7)
    assert out == "routed"
    assert all(a is b for a, b in zip(seen["args"], args, strict=True))
    assert seen["kwargs"] == {"mesh": None, "method": "newton_krylov", "eps": 1e-9,
                              "max_outer": 7}
    assert hank_tpu_torch.solve_ensemble is solve_ensemble
    assert hank_tpu_torch.solve_ensemble_host is solve_ensemble_host


@pytest.mark.parametrize("ray", [0.0, 0.5, 1.0, 4.0, 30.0])
def test_boehl_alpha_matches_jax(ray):
    from hank_tpu.solvers.newton import _boehl_alpha as jalpha

    ref = float(jalpha(jnp.asarray(ray)))
    assert float(_boehl_alpha(torch.tensor(ray, dtype=torch.float64))) == ref
