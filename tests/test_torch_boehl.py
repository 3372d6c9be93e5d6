"""PyTorch port: the boehl path solver against hank_tpu.

The y-iteration (host-outer), its host-inner form with the Richardson
phase and the host-PGMRES endgame, and the endgame-only route from the
linear warm start, on the small Krusell-Smith (40×5, T=12, transitory TFP
shock) and the small two-asset model (24×12×4×2, T=12, fiscal shock) from
the JAX steady state and J̄ carried across, held pointwise to 1e-9 against
the JAX package's Newton-Krylov root at eps 1e-11. f32 directions come from
the kernels' plain versions on the CPU. Then one test per branch of the
endgame's operator ladder, the Newton-Krylov stall rescue into boehl, and
the solver's argument checks.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hank_tpu_torch.solvers.newton as newton_mod
from hank_tpu_torch.solvers.linear import linear_impulse_response
from hank_tpu_torch.solvers.newton import make_full_residual_fn, make_path_solver
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import (build_small_ks_torch, build_small_two_asset_torch,
                                     ss_to_numpy, to_torch, transitory_exog)
from tests.test_torch_solve import x_ss_of

torch.set_num_threads(1)
f32 = torch.float32


class Case:
    """One model's port inputs and the JAX root."""

    def __init__(self, jm, jss, tm, exog_np):
        from hank_tpu.solvers.linear import linear_impulse_response as jlin
        from hank_tpu.solvers.newton import make_path_solver as jmake
        from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

        Jj = jjac(jss, jm)
        jexog = {k: jnp.asarray(v) for k, v in exog_np.items()}
        xl, _ = jlin(Jj, jexog, jm, jss, jss, compute_residual=False)
        x_ref, info = jmake(Jj, jexog, jm, jss, jss, method="newton_krylov", eps=1e-11)(xl)
        assert float(info["residual_norm"]) < 1e-11
        self.x_ref = np.asarray(x_ref)
        self.model = tm
        self.ss = steady_state_from_numpy(ss_to_numpy(jss), device="cpu")
        self.J = to_torch(np.asarray(Jj))
        self.exog = {k: to_torch(v) for k, v in exog_np.items()}
        self.x_ss = to_torch(x_ss_of(jm, jss))

    def solver(self, **kw):
        return make_path_solver(self.J, self.exog, self.model, self.ss, self.ss,
                                method="boehl", direction_dtype=f32, direction_mode="pallas",
                                **kw)

    def x_lin(self):
        return linear_impulse_response(self.J, self.exog, self.model, self.ss, self.ss,
                                       compute_residual=False)[0]

    def plain_fnorm(self, x):
        F = make_full_residual_fn(self.model, self.ss, self.ss, self.exog)
        return float(torch.linalg.norm(F(x)))


@pytest.fixture(scope="module")
def ks(ks_small, ks_small_ss):
    T = ks_small.compspec.T
    return Case(ks_small, ks_small_ss, build_small_ks_torch(T=T), {"Z": transitory_exog(T)})


@pytest.fixture(scope="module")
def two_asset():
    from hank_tpu.models.hank_two_asset import fiscalShock
    from tests.conftest import solve_ss_cached
    from tests.test_hank_two_asset import build_small_two_asset

    jm = build_small_two_asset()
    Tm1 = jm.compspec.T - 1
    return Case(jm, solve_ss_cached(jm), build_small_two_asset_torch(),
                {"G": np.asarray(fiscalShock(Tm1))})


def check_root(case, x, info, eps):
    assert info["residual_norm"] < eps
    assert case.plain_fnorm(x) < 2 * eps
    assert float(np.max(np.abs(x.numpy() - case.x_ref))) <= 1e-9


@pytest.mark.parametrize("start", ["x_ss", "x_lin"])
def test_boehl_host_outer_ks(ks, start):
    x0 = ks.x_ss if start == "x_ss" else ks.x_lin()
    records = []
    x, info = ks.solver(eps=1e-10, records=records)(x0)
    check_root(ks, x, info, 1e-10)
    assert len(records) == info["iterations"] and info["inner_iterations"] > 0
    x2, _ = ks.solver(eps=1e-10)(x0)
    assert torch.equal(x, x2)


def test_boehl_host_inner_ks(ks):
    x, info = ks.solver(eps=1e-10, host_inner=True)(ks.x_ss)
    check_root(ks, x, info, 1e-10)
    prof = info["prof"]
    assert prof["sweep"]["calls"] > 0
    assert prof["F"]["calls"] >= info["iterations"] + 1


@pytest.mark.parametrize("name", ["ks", "two_asset"])
def test_boehl_endgame_only_from_linear_start(name, request):
    """richardson_max_outer=0: no Richardson sweep, the GMRES endgame from
    the linear warm start (the two-asset production route)."""
    case = request.getfixturevalue(name)
    x, info = case.solver(eps=1e-10, host_inner=True, richardson_max_outer=0)(case.x_lin())
    check_root(case, x, info, 1e-10)
    assert info["prof"]["sweep"]["calls"] == 0
    assert info["prof"]["pgmres_mv"]["calls"] == info["inner_iterations"] > 0


def test_boehl_host_outer_two_asset(two_asset):
    x, info = two_asset.solver(eps=1e-10)(two_asset.x_lin())
    check_root(two_asset, x, info, 1e-10)


# ── the endgame's operator ladder (`hank_tpu/solvers/newton.py:749-843`) ───

def wrap_f32_operator(monkeypatch, transform):
    """Route the f32 rung through `transform(jvp)(x, v)`."""
    real = newton_mod.make_fused_jvp_dir
    monkeypatch.setattr(newton_mod, "make_fused_jvp_dir",
                        lambda *a: transform(real(*a)))


def script_pgmres(monkeypatch, script):
    """The endgame's GMRES solves in order: "good" returns the real step,
    "bad" its negative (an ascent direction, so no step length descends);
    past the script every solve is good. Returns the list of solves made."""
    real = newton_mod._host_pgmres
    calls = []

    def scripted(apply_A, b, m, tol):
        dx, rrel, mv = real(apply_A, b, m, tol)
        kind = script[len(calls)] if len(calls) < len(script) else "good"
        calls.append(kind)
        return (-dx if kind == "bad" and dx is not None else dx), rrel, mv

    monkeypatch.setattr(newton_mod, "_host_pgmres", scripted)
    return calls


def endgame(ks, capsys, **kw):
    records = []
    x, info = ks.solver(host_inner=True, richardson_max_outer=0, verbose=True,
                        records=records, **kw)(ks.x_ss)
    return x, info, records, capsys.readouterr().out


def test_ladder_raises_damping_after_a_failed_step(ks, monkeypatch, capsys):
    script_pgmres(monkeypatch, ["bad"])
    x, info, records, out = endgame(ks, capsys, eps=1e-10)
    assert "no descent (f32); raising LM damping to 1.0e-02" in out
    # The next (accepted) outer ran at λ = 1e-2 and shrank it by 0.3.
    assert "lam 3.0e-03" in out
    check_root(ks, x, info, 1e-10)
    assert all(r["operator"] == "f32" for r in records)


def test_ladder_escalates_once_damping_is_exhausted(ks, monkeypatch, capsys):
    # λ: 1e-2, 0.3, (accept) 0.09, 2.7, 81, then ≥ 10: escalate to f64-ad.
    calls = script_pgmres(monkeypatch, ["bad", "bad", "good", "bad", "bad", "bad"])
    x, info, records, out = endgame(ks, capsys, eps=1e-10)
    assert "damping exhausted with f32 operator; escalating to f64-ad" in out
    assert len(calls) > 6
    assert records[0]["operator"] == "f32" and records[-1]["operator"] == "f64-ad"
    check_root(ks, x, info, 1e-10)


def test_ladder_escalates_at_once_on_a_non_finite_matvec(ks, monkeypatch, capsys):
    wrap_f32_operator(monkeypatch, lambda jvp: (lambda x, v: jvp(x, v) * float("nan")))
    x, info, records, out = endgame(ks, capsys, eps=1e-10)
    assert "non-finite f32 matvec; escalating to f64-ad" in out
    assert "raising LM damping" not in out
    assert records and all(r["operator"] == "f64-ad" for r in records)
    check_root(ks, x, info, 1e-10)


def test_ladder_returns_the_best_iterate(ks, monkeypatch, capsys):
    """A Richardson outer that overshoots (the f32 operator scaled by 1/3,
    so y → 3·J⁻¹F) with the outer budget spent: the solver returns the
    best iterate it saw, x0."""
    wrap_f32_operator(monkeypatch, lambda jvp: (lambda x, v: jvp(x, v) / 3.0))
    F0 = ks.plain_fnorm(ks.x_ss)
    x, info = ks.solver(host_inner=True, eps=1e-10, max_outer=1)(ks.x_ss)
    assert info["iterations"] == 1
    assert torch.equal(x, ks.x_ss)
    assert info["residual_norm"] == pytest.approx(F0, rel=1e-9)
    # With outers left, the endgame starts from that best iterate and
    # stops on the stall rule (three outers without a 2% gain).
    script_pgmres(monkeypatch, ["bad"] * 10)
    _, info, _, out = endgame(ks, capsys, eps=1e-10, max_outer=20)
    assert info["residual_norm"] == pytest.approx(F0, rel=1e-9)
    assert info["iterations"] == 3 and out.count("raising LM damping") == 3


def test_newton_krylov_stall_rescue_hands_off_to_boehl(ks, monkeypatch):
    """A Newton-Krylov outer without descent (GMRES forced to return a zero
    step) hands the iterate to host-inner boehl, which converges."""
    real = newton_mod.gmres_matfree
    calls = {"n": 0}

    def zero_gmres(A, b, **kw):
        calls["n"] += 1
        d, info = real(A, b, **kw)
        return torch.zeros_like(d), info

    monkeypatch.setattr(newton_mod, "gmres_matfree", zero_gmres)
    with pytest.warns(UserWarning, match="switching to the boehl"):
        x, info = make_path_solver(ks.J, ks.exog, ks.model, ks.ss, ks.ss,
                                   method="newton_krylov", direction_dtype=f32,
                                   direction_mode="pallas", eps=1e-10)(ks.x_ss)
    assert calls["n"] == 1
    check_root(ks, x, info, 1e-10)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(UserWarning, match="stalled"):
            make_path_solver(ks.J, ks.exog, ks.model, ks.ss, ks.ss, method="newton_krylov",
                             direction_dtype=f32, direction_mode="pallas", eps=1e-10,
                             stall_rescue=False)(ks.x_ss)


@pytest.mark.parametrize("kw", [dict(richardson_max_outer=0),
                                dict(endgame_gmres_tol=1e-6),
                                dict(method="boehl", richardson_max_outer=0),
                                dict(method="boehl", endgame_gmres_tol=1e-6)])
def test_endgame_options_need_host_inner_boehl(ks, kw):
    with pytest.raises(ValueError, match="host_inner=True"):
        make_path_solver(ks.J, ks.exog, ks.model, ks.ss, ks.ss, **kw)


def test_solver_rejects_unknown_options_and_models(ks):
    with pytest.raises(ValueError, match="endgame"):
        ks.solver(host_inner=True, endgame="bogus")
    other = dataclasses.replace(build_small_ks_torch(T=12), value_fn=lambda v, x, m: None)
    with pytest.raises(ValueError, match="neither household-sweep kernel pair"):
        make_path_solver(ks.J, ks.exog, other, ks.ss, ks.ss, method="boehl",
                         direction_dtype=f32, direction_mode="pallas")
