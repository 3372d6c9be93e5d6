"""PyTorch port: kernels 5-6 (the two-asset household sweep) against hank_tpu.

On the CPU the wrappers `fused2_policies_jvp` / `fused2_forward_jvp` run
their plain versions (`torch.func.jvp` of the f32 backward scan through the
ported `ValueFunction`, and of the f32 `forward_iteration`). Here they are
held, on the small two-asset model (24×12×4×2, T=12) at a point near the
steady state along an i.i.d. direction, to the JAX package's Pallas pair
run in interpret mode, and the direction operator built on them to
`jax.jvp` of the JAX package's f32 pipeline, at the JAX test's bound
5e-5·max(scale, 1) (`tests/test_fused_sweep2.py`). The JAX side is pinned
to the hat lowerings its kernels mirror, as that test pins it. The CUDA
kernels themselves run only on a card (`gpu` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.models import load_model as load_model_torch
from hank_tpu_torch.models.hank_two_asset import fused2_prices
from hank_tpu_torch.ops import fused_sweep2 as fs2
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import build_small_two_asset_torch, ss_to_numpy, to_torch

torch.set_num_threads(1)
f32 = torch.float32
KEYS = ("B", "A", "C")


@pytest.fixture(autouse=True)
def hat_lowerings(monkeypatch):
    monkeypatch.setenv("HANK_TPU_BILINEAR", "hat")
    monkeypatch.setenv("HANK_TPU_INTERP", "hat")


@pytest.fixture(scope="module")
def setup():
    from tests.conftest import solve_ss_cached
    from tests.test_hank_two_asset import build_small_two_asset

    jm = build_small_two_asset()
    jss = solve_ss_cached(jm)
    tm = build_small_two_asset_torch()
    tss = steady_state_from_numpy(ss_to_numpy(jss), device="cpu")
    Tm1 = jm.compspec.T - 1
    G = 0.005 * 0.8 ** np.arange(1, Tm1 + 1)
    endog = jm.vars_of_type("endogenous")
    x_ss = np.tile(np.array([float(jss.vars[k]) for k in endog]), Tm1)
    rng = np.random.default_rng(7)
    x = x_ss + 0.005 * rng.normal(size=x_ss.shape)
    v = rng.normal(size=x_ss.shape)
    return jm, jss, tm, tss, G, x, v


def bounded(out, ref, bound=5e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = float(np.max(np.abs(ref)))
    return float(np.max(np.abs(out - ref))) <= bound * max(scale, 1.0)


def jax_policies(setup):
    """JAX kernel 5 in interpret mode at (x, v): policies, tangents, and the
    f32 price paths it was given."""
    from hank_tpu.models.hank_two_asset import fused2_prices as jax_prices
    from hank_tpu.ops.fused_sweep2 import fused2_policies_jvp
    from hank_tpu.ops.precision import cast_model

    jm, jss, _, _, G, x, v = setup
    Tm1, nE = jm.compspec.T - 1, jm.compspec.n_endog
    exog = {"G": jnp.asarray(G)}
    paths = [np.asarray(q, np.float32) for q in
             (*jax_prices(jnp.asarray(x).reshape(Tm1, nE), exog, jm),
              *jax_prices(jnp.asarray(v).reshape(Tm1, nE), exog, jm))]
    pol, dpol = fused2_policies_jvp(*(jnp.asarray(p) for p in paths),
                                    jnp.asarray(jss.value, jnp.float32),
                                    cast_model(jm, jnp.float32), interpret=True)
    return paths, pol, dpol


def test_kernel5_plain_version_matches_jax_kernel(setup):
    _, jss, tm, tss, G, x, v = setup
    paths, ref, dref = jax_policies(setup)
    Tm1, nE = tm.compspec.T - 1, tm.compspec.n_endog
    # The port's price hook gives the same f32 paths.
    ported = fused2_prices(to_torch(x).reshape(Tm1, nE), {"G": to_torch(G)}, tm)
    for a, b in zip(ported, paths[:4]):
        np.testing.assert_array_equal(a.to(f32).numpy(), b)
    calls, launches = fs2.fused2_policies_jvp_reference.calls, fs2.fused2_policies_jvp.launches
    pol, dpol = fs2.fused2_policies_jvp(*(torch.from_numpy(p) for p in paths),
                                        tss.value.to(f32), fs2.cast_model(tm, f32))
    assert fs2.fused2_policies_jvp_reference.calls == calls + 1
    assert fs2.fused2_policies_jvp.launches == launches
    for k in KEYS:
        assert pol[k].shape == dpol[k].shape == (Tm1, 24, 12, 4, 2) and pol[k].dtype == f32
        assert bounded(pol[k], ref[k]), k
        assert bounded(dpol[k], dref[k]), k


def test_kernel6_plain_version_matches_jax_kernel(setup):
    from hank_tpu.ops.fused_sweep2 import fused2_forward_jvp
    from hank_tpu.ops.precision import cast_model

    jm, jss, tm, tss, *_ = setup
    _, pol, dpol = jax_policies(setup)
    ref, dref = fused2_forward_jvp(pol, dpol, jnp.asarray(jss.D, jnp.float32),
                                   cast_model(jm, jnp.float32), interpret=True)
    calls = fs2.fused2_forward_jvp_reference.calls
    aggs, daggs = fs2.fused2_forward_jvp({k: torch.tensor(np.asarray(pol[k])) for k in KEYS},
                                         {k: torch.tensor(np.asarray(dpol[k])) for k in KEYS},
                                         tss.D.to(f32), fs2.cast_model(tm, f32))
    assert fs2.fused2_forward_jvp_reference.calls == calls + 1
    for k in KEYS:
        assert aggs[k].shape == (tm.compspec.T - 1,) and aggs[k].dtype == f32
        assert bounded(aggs[k], ref[k]), k
        assert bounded(daggs[k], dref[k]), k


def test_direction_operator_matches_jax_jvp_of_the_f32_pipeline(setup):
    """`make_fused2_jvp_dir` (price JVP, kernels 5-6, f32 tail) and the f32
    residual through the same sweep, against `jax.jvp` of the JAX package's
    f32 equilibrium map, as `tests/test_fused_sweep2.py` holds the TPU pair."""
    from hank_tpu.ops.precision import cast_model, cast_paths, cast_ss
    from hank_tpu.solvers.newton import make_full_residual_fn

    jm, jss, tm, tss, G, x, v = setup
    F32 = make_full_residual_fn(cast_model(jm, jnp.float32), cast_ss(jss, jnp.float32),
                                cast_ss(jss, jnp.float32),
                                cast_paths({"G": jnp.asarray(G)}, jnp.float32))
    ref_F, ref = jax.jvp(F32, (jnp.asarray(x, jnp.float32),), (jnp.asarray(v, jnp.float32),))
    exog = {"G": to_torch(G)}
    jvp_dir = fs2.make_fused2_jvp_dir(tm, tss, tss, exog)
    out = jvp_dir(to_torch(x), to_torch(v))
    assert out.dtype == f32 and bounded(out, ref)
    F = fs2.make_fused2_residual_fn(tm, tss, tss, exog)(to_torch(x))
    assert bounded(F, ref_F)
    # `plain=True` routes both sweeps to the plain versions on every device:
    # on the CPU that is the same computation, bit for bit.
    assert torch.equal(fs2.make_fused2_jvp_dir(tm, tss, tss, exog, plain=True)(
        to_torch(x), to_torch(v)), out)


def test_wrappers_check_their_inputs(setup):
    _, _, tm, tss, *_ = setup
    Tm1 = tm.compspec.T - 1
    paths = [torch.zeros(Tm1, dtype=f32) for _ in range(8)]
    value = tss.value.to(f32)
    with pytest.raises(TypeError, match="expected torch.float32"):
        fs2.fused2_policies_jvp(*paths, value.double(), tm)
    with pytest.raises(ValueError, match="value_T"):
        fs2.fused2_policies_jvp(*paths, value[:, :-1].contiguous(), tm)
    with pytest.raises(ValueError, match="contiguous"):
        fs2.fused2_policies_jvp(*paths, value.transpose(1, 2), tm)
    with pytest.raises(ValueError, match="expected"):
        fs2.fused2_policies_jvp(*paths[:7], torch.zeros(Tm1 + 1, dtype=f32), value, tm)
    pol = {k: torch.zeros((Tm1, 24, 12, 4, 2), dtype=f32) for k in KEYS}
    with pytest.raises(ValueError, match="D0"):
        fs2.fused2_forward_jvp(pol, pol, tss.D.to(f32)[:-1], tm)
    with pytest.raises(TypeError):
        fs2.fused2_forward_jvp(pol, pol, tss.D, tm)


def test_supports_fused_sweep2(setup):
    _, _, tm, *_ = setup
    assert fs2.supports_fused_sweep2(tm)
    assert fs2.supports_fused_sweep2(load_model_torch("hank_two_asset", T=8, device="cpu"))
    assert not fs2.supports_fused_sweep2(load_model_torch("krusell_smith", T=8, device="cpu"))
    with pytest.raises(ValueError, match="fused2_prices"):
        fs2.make_fused2_jvp_dir(load_model_torch("krusell_smith", T=8, device="cpu"), None, None, {})


# ── On the card ────────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_kernels5_6_on_card_match_their_plain_versions(setup, cuda):
    _, _, tm, tss, G, x, v = setup
    Tm1, nE = tm.compspec.T - 1, tm.compspec.n_endog
    exog = {"G": to_torch(G)}
    paths = [q.to(f32).contiguous().to(cuda) for q in
             (*fused2_prices(to_torch(x).reshape(Tm1, nE), exog, tm),
              *fused2_prices(to_torch(v).reshape(Tm1, nE), exog, tm))]
    m32 = fs2.cast_model(tm, f32)
    value, D = tss.value.to(f32).to(cuda), tss.D.to(f32).to(cuda)
    launches = fs2.fused2_policies_jvp.launches
    pol, dpol = fs2.fused2_policies_jvp(*paths, value, m32)
    pol2, dpol2 = fs2.fused2_policies_jvp(*paths, value, m32)
    assert fs2.fused2_policies_jvp.launches == launches + 2
    assert all(torch.equal(pol[k], pol2[k]) and torch.equal(dpol[k], dpol2[k]) for k in KEYS)
    ref, dref = fs2.fused2_policies_jvp_reference(*paths, value, m32)
    for k in KEYS:
        assert bounded(pol[k].cpu(), ref[k].cpu()), k
    aggs, daggs = fs2.fused2_forward_jvp(pol, dpol, D, m32)
    raggs, rdaggs = fs2.fused2_forward_jvp_reference(pol, dpol, D, m32)
    for k in KEYS:
        assert bounded(aggs[k].cpu(), raggs[k].cpu()), k
        assert bounded(daggs[k].cpu(), rdaggs[k].cpu()), k
