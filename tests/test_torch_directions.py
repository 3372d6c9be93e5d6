"""PyTorch port: the f32 direction routes, the Newton-Krylov f32-residual
phase and ensembles over any model, against hank_tpu.

On the small Krusell-Smith (40×5, T=12, transitory TFP shock) and the small
two-asset model (24×12×4×2, T=12, fiscal shock G), from the JAX steady
states carried across:
  - `direction_mode="xla"`, the mixed-tail map (household blocks in f32,
    assembly and residual tail in f64), against the same map built from the
    JAX package's functions (`hank_tpu/solvers/newton.py:462-494`);
  - Newton-Krylov with `residual_mode="f64"` and f32 directions: outers,
    f64 residual evaluations and the outer of the switch to f64 residuals
    against the JAX package's (`:975-1025`), the path within 1e-9;
  - the direction-mode checks ("pallas" without a kernel pair raises);
  - `residual_ensemble` on the two-asset model and `solve_ensemble_host`
    with f64 directions against the JAX package's vmapped pipeline;
  - the checkpoint loaders' device default.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hank_tpu_torch.solvers.newton as newton_mod
from hank_tpu_torch.ops.fused_sweep import fused_sweep_jvp_reference
from hank_tpu_torch.parallel.ensemble import residual_ensemble, solve_ensemble_host
from hank_tpu_torch.solvers.newton import make_path_solver, mixed_tail_map
from hank_tpu_torch.utils import checkpoint
from tests.test_torch_common import (build_small_ks_torch, build_small_two_asset_torch,
                                     ss_to_numpy, to_torch, transitory_exog)
from tests.test_torch_solve import x_ss_of

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64


class Pair:
    """One model in both packages, its steady state, shock and x_ss."""

    def __init__(self, jm, jss, tm, exog_np):
        self.jm, self.jss, self.tm = jm, jss, tm
        self.tss = checkpoint.steady_state_from_numpy(ss_to_numpy(jss), device="cpu")
        self.exog_np = exog_np
        self.jexog = {k: jnp.asarray(v) for k, v in exog_np.items()}
        self.exog = {k: to_torch(v) for k, v in exog_np.items()}
        self.x_ss = x_ss_of(jm, jss)


@pytest.fixture(scope="module")
def ks(ks_small, ks_small_ss):
    T = ks_small.compspec.T
    return Pair(ks_small, ks_small_ss, build_small_ks_torch(T=T), {"Z": transitory_exog(T)})


@pytest.fixture(scope="module")
def two_asset():
    from hank_tpu.models.hank_two_asset import fiscalShock
    from tests.conftest import solve_ss_cached
    from tests.test_hank_two_asset import build_small_two_asset

    jm = build_small_two_asset()
    return Pair(jm, solve_ss_cached(jm), build_small_two_asset_torch(),
                {"G": np.asarray(fiscalShock(jm.compspec.T - 1))})


def jax_xla_jvp_dir(pair):
    """The JAX package's mixed-tail direction map, `jvp_dir` of
    `make_path_solver(direction_dtype=jnp.float32, direction_mode="xla")`,
    built line for line from its functions (`hank_tpu/solvers/newton.py:463-491`)."""
    from hank_tpu.blocks.assemble import assemble_full_xmat, residuals
    from hank_tpu.blocks.backward import backward_iteration
    from hank_tpu.blocks.forward import forward_iteration
    from hank_tpu.ops.precision import cast_model, cast_paths, cast_ss

    model, ss = pair.jm, pair.jss
    m_lo, s_lo = cast_model(model, jnp.float32), cast_ss(ss, jnp.float32)
    ex_lo = cast_paths(pair.jexog, jnp.float32)

    def F_dir(x_lo):
        pols = backward_iteration(x_lo, ex_lo, m_lo, s_lo.vars, s_lo.value)
        aggs = forward_iteration(pols, m_lo, s_lo.D)
        aggs_hi = {k: v.astype(jnp.float64) for k, v in aggs.items()}
        x_mat = assemble_full_xmat(x_lo.astype(jnp.float64), aggs_hi, pair.jexog, model,
                                   ss.vars, ss.vars)
        return residuals(x_mat, model)

    def jvp_dir(x, v):
        return jax.jvp(F_dir, (x.astype(jnp.float32),), (v.astype(jnp.float32),))[1]

    return jax.jit(jvp_dir)


# The bound of the f32 map against the JAX package's: both run the household
# blocks in f32 and differ only in the order of their f32 roundings
# (ε32 ≈ 6e-8) through T-1 backward and forward periods. Measured: 5.3e-7
# (KS) and 1.6e-6 (two-asset) of the direction's scale, the same order as
# each map's own gap to the f64 JVP (2.1e-7 and 1.1e-6); 2e-5 leaves a
# factor of 12.
XLA_MAP_RTOL = 2e-5


@pytest.mark.parametrize("name", ["ks", "two_asset"])
def test_xla_direction_map_matches_jax(name, request):
    pair = request.getfixturevalue(name)
    rng = np.random.default_rng(11)
    x = pair.x_ss * (1.0 + 0.002 * rng.normal(size=pair.x_ss.shape))
    v = rng.normal(size=pair.x_ss.shape)
    ref = np.asarray(jax_xla_jvp_dir(pair)(jnp.asarray(x), jnp.asarray(v)))
    jvp_dir, F_lo = mixed_tail_map(pair.tm, pair.tss, pair.tss)
    out = jvp_dir(to_torch(x), to_torch(v), pair.exog)
    assert out.dtype == f64 and out.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    assert float(np.max(np.abs(out.numpy() - ref))) <= XLA_MAP_RTOL * scale
    # Against the f64 JVP: the f32 blocks' own roundoff, at the same bound.
    F = newton_mod.make_full_residual_fn(pair.tm, pair.tss, pair.tss, pair.exog)
    exact = torch.func.jvp(F, (to_torch(x),), (to_torch(v),))[1]
    assert float((out - exact).abs().max()) <= XLA_MAP_RTOL * scale
    # The f32 residual of the same map, against the f64 one.
    Fx, Fx_lo = F(to_torch(x)), F_lo(to_torch(x), pair.exog)
    assert Fx_lo.dtype == f64
    assert float((Fx_lo - Fx).abs().max()) <= 1e-5 * max(float(Fx.abs().max()), 1.0)


@pytest.mark.parametrize("mode,plain_calls", [("auto", 0), ("xla", 0), ("pallas", 1)])
def test_direction_mode_picks_the_route_on_the_cpu(ks, mode, plain_calls):
    """On CPU tensors "auto" takes the mixed-tail map, as the reference does
    off its TPU; "pallas" takes kernel 1's plain version."""
    J = torch.eye(ks.x_ss.shape[0], dtype=f64)
    calls = fused_sweep_jvp_reference.calls
    run = make_path_solver(J, ks.exog, ks.tm, ks.tss, ks.tss, method="boehl",
                           direction_dtype=f32, direction_mode=mode, max_outer=1, max_inner=1)
    run(to_torch(ks.x_ss) * 1.001)
    assert fused_sweep_jvp_reference.calls == calls + plain_calls


def test_direction_mode_pallas_needs_a_kernel_pair(ks):
    import dataclasses

    other = dataclasses.replace(ks.tm, value_fn=lambda v, x, m: None)
    J = torch.eye(ks.x_ss.shape[0], dtype=f64)
    for method in ("boehl", "newton_krylov"):
        with pytest.raises(ValueError, match="direction_mode='pallas'"):
            make_path_solver(J, ks.exog, other, ks.tss, ks.tss, method=method,
                             direction_dtype=f32, direction_mode="pallas")
        # "auto" and "xla" take the mixed-tail map, which needs no kernel.
        for mode in ("auto", "xla"):
            make_path_solver(J, ks.exog, other, ks.tss, ks.tss, method=method,
                             direction_dtype=f32, direction_mode=mode)
    with pytest.raises(ValueError, match="direction_mode"):
        make_path_solver(J, ks.exog, ks.tm, ks.tss, ks.tss, direction_mode="mosaic")


def counted_residual_fn(module, counter, jax_side):
    """`module.make_full_residual_fn`, whose F adds one to `counter` per
    evaluation (in the JAX package through a host callback, so an
    evaluation inside a jitted step counts too)."""
    real = module.make_full_residual_fn

    def make(*a, **kw):
        F = real(*a, **kw)

        def bump():
            counter["F"] += 1

        def counted(x):
            if jax_side:
                jax.debug.callback(bump)
            else:
                bump()
            return F(x)

        return counted

    return make


def f32_phase_outers(out: str) -> int:
    return sum(1 for ln in out.splitlines()
               if ln.startswith("[newton_krylov] outer") and ln.endswith("(f32 phase)"))


@pytest.mark.parametrize("direction_mode", ["xla", "auto"])
def test_newton_krylov_f32_residual_phase_matches_jax(ks, monkeypatch, capsys,
                                                      direction_mode):
    """residual_mode="f64" with f32 directions: the early outers run on the
    f32 residual of the mixed-tail map, then a re-anchor on the f64 F. The
    outers, the f64 F evaluations and the outer of the switch are the JAX
    package's; the path is within 1e-9 of its."""
    import hank_tpu.solvers.newton as jnewton
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    Jj = jjac(ks.jss, ks.jm)
    counts = {"jax": {"F": 0}, "port": {"F": 0}}
    monkeypatch.setattr(jnewton, "make_full_residual_fn",
                        counted_residual_fn(jnewton, counts["jax"], True))
    monkeypatch.setattr(newton_mod, "make_full_residual_fn",
                        counted_residual_fn(newton_mod, counts["port"], False))
    jrec, trec = [], []
    xj, ij = jnewton.make_path_solver(
        Jj, ks.jexog, ks.jm, ks.jss, ks.jss, method="newton_krylov", eps=1e-10,
        direction_dtype=jnp.float32, direction_mode="xla", residual_mode="f64",
        verbose=True, records=jrec)(jnp.asarray(ks.x_ss))
    jax.effects_barrier()
    jout = capsys.readouterr().out
    x, info = make_path_solver(
        to_torch(np.asarray(Jj)), ks.exog, ks.tm, ks.tss, ks.tss, method="newton_krylov",
        eps=1e-10, direction_dtype=f32, direction_mode=direction_mode, residual_mode="f64",
        verbose=True, records=trec)(to_torch(ks.x_ss))
    tout = capsys.readouterr().out
    assert float(ij["residual_norm"]) < 1e-10 and info["residual_norm"] < 1e-10
    assert info["iterations"] == int(ij["iterations"]) == len(trec) == len(jrec)
    assert counts["port"]["F"] == counts["jax"]["F"] > 0
    assert f32_phase_outers(tout) == f32_phase_outers(jout) >= 1
    assert float(np.max(np.abs(x.numpy() - np.asarray(xj)))) <= 1e-9


def test_newton_krylov_skips_the_f32_phase_on_kernel_2(ks, monkeypatch, capsys):
    """With kernel 2 as F (residual_mode="auto" on the one-asset family) no
    outer runs on the f32 residual (`:985-992`)."""
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    J = to_torch(np.asarray(jjac(ks.jss, ks.jm)))
    x, info = make_path_solver(J, ks.exog, ks.tm, ks.tss, ks.tss, method="newton_krylov",
                               eps=1e-10, direction_dtype=f32, verbose=True)(
        to_torch(ks.x_ss))
    assert info["residual_norm"] < 1e-10
    assert f32_phase_outers(capsys.readouterr().out) == 0


def test_residual_ensemble_on_the_two_asset_model_matches_jax(two_asset):
    from hank_tpu.parallel.ensemble import residual_ensemble as jres

    rng = np.random.default_rng(5)
    x_b = two_asset.x_ss[None] * (1.0 + 0.002 * rng.normal(size=(2, two_asset.x_ss.shape[0])))
    G = two_asset.exog_np["G"]
    G_b = np.stack([G, 0.5 * G])
    ref = np.asarray(jres(jnp.asarray(x_b), {"G": jnp.asarray(G_b)}, two_asset.jm,
                          two_asset.jss, two_asset.jss))
    out = residual_ensemble(to_torch(x_b), {"G": to_torch(G_b)}, two_asset.tm,
                            two_asset.tss, two_asset.tss)
    assert out.dtype == f64 and out.shape == ref.shape == x_b.shape
    assert float(np.max(np.abs(out.numpy() - ref))) <= 1e-11
    for b in range(2):
        F = newton_mod.make_full_residual_fn(two_asset.tm, two_asset.tss, two_asset.tss,
                                             {"G": to_torch(G_b[b])})
        assert torch.equal(out[b], F(to_torch(x_b[b])))


@pytest.mark.parametrize("method", ["newton_krylov", "boehl"])
def test_solve_ensemble_host_with_f64_directions_matches_jax(ks, method):
    """f64 directions (`torch.func.vmap` of the f64 JVP, GMRES to 1e-12) and
    the vmapped plain F, B=2, against the JAX package's vmapped XLA route."""
    from hank_tpu.parallel.ensemble import solve_ensemble_host as jsolve
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    T = ks.tm.compspec.T
    t = np.arange(1, T, dtype=np.float64)
    Z = 1.0 + 0.05 * np.array([0.6, 0.85])[:, None] ** t[None, :]
    J = np.asarray(jjac(ks.jss, ks.jm))
    x_ref, info_ref = jsolve(jnp.asarray(ks.x_ss), jnp.asarray(J), {"Z": jnp.asarray(Z)},
                             ks.jm, ks.jss, ks.jss, eps=1e-10, method=method,
                             direction_dtype=None, fused="xla")
    calls = fused_sweep_jvp_reference.calls
    x, info = solve_ensemble_host(to_torch(ks.x_ss), to_torch(J), {"Z": to_torch(Z)},
                                  ks.tm, ks.tss, ks.tss, eps=1e-10, method=method,
                                  direction_dtype=None)
    assert fused_sweep_jvp_reference.calls == calls
    assert bool((info["residual_norm"] < 1e-10).all()) and info["stalled_paths"] == 0
    assert info["iterations"] == int(info_ref["iterations"])
    assert float(np.max(np.abs(x.numpy() - np.asarray(x_ref)))) <= 1e-9


def test_solve_ensemble_host_f32_directions_without_the_kernel_hook(ks):
    """A one-asset model without the kernel hook takes the plain route with
    f32 directions (the vmapped mixed-tail map) and reaches the kernel
    route's root."""
    import dataclasses

    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    value_fn = ks.tm.value_fn
    other = dataclasses.replace(ks.tm, value_fn=lambda *a: value_fn(*a))
    assert not newton_mod.supports_fused_sweep(other)
    T = ks.tm.compspec.T
    Z = 1.0 + 0.05 * np.array([0.6, 0.85])[:, None] ** np.arange(1, T)[None, :]
    J = to_torch(np.asarray(jjac(ks.jss, ks.jm)))
    args = (to_torch(ks.x_ss), J, {"Z": to_torch(Z)})
    x, info = solve_ensemble_host(*args, other, ks.tss, ks.tss, eps=1e-10,
                                  method="newton_krylov")
    x_k, _ = solve_ensemble_host(*args, ks.tm, ks.tss, ks.tss, eps=1e-10,
                                 method="newton_krylov")
    assert bool((info["residual_norm"] < 1e-10).all())
    assert float((x - x_k).abs().max()) <= 1e-9


def test_checkpoint_loaders_default_to_the_card():
    for fn in (checkpoint.steady_state_from_numpy, checkpoint.load_steady_state_npz,
               checkpoint.load_jacobian_npz):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
