"""PyTorch port: the path-batched household sweeps (kernels 3-4, batched kernel 2).

On the CPU the batched wrappers run their plain versions (loops over rows of
the single-path plain versions); those are held against the JAX package's
batched Pallas pair in interpret mode and its vmapped f64 pipeline, on the
small Krusell-Smith (40×5, T=12). The kernels themselves run only on a CUDA
card: those tests carry the `gpu` marker and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                               fused_residual_sweep_batch,
                                               fused_residual_sweep_batch_previous,
                                               fused_residual_sweep_batch_reference,
                                               fused_residual_sweep_reference)
from hank_tpu_torch.ops.fused_sweep import fused_sweep_jvp, fused_sweep_jvp_reference
from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
                                                  fused_sweep_jvp_batch_previous,
                                                  fused_sweep_jvp_batch_reference,
                                                  make_fused_jvp_batch)
from hank_tpu_torch.parallel.ensemble import residual_ensemble
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import build_small_ks_torch, ss_to_numpy, to_torch
from tests.test_torch_kernels import kernel_kwargs
from tests.torch_ranks import MeshOfSize

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64


@pytest.fixture(scope="module")
def both(ks_small, ks_small_ss):
    T = ks_small.compspec.T
    tm = build_small_ks_torch(T=T)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    endog = ks_small.vars_of_type("endogenous")
    x_ss = np.tile(np.array([float(ks_small_ss.vars[k]) for k in endog]), T - 1)
    return ks_small, ks_small_ss, tm, tss, x_ss


def price_batch(ss, Tm1, B, seed):
    """Per-path (r, w) price paths near the SS and tangents, (B, T-1) f64
    numpy each (`tests/test_fused_batch.py::_price_batch`)."""
    rng = np.random.default_rng(seed)
    r0, w0 = float(ss.vars["r"]), float(ss.vars["w"])
    return (r0 * (1.0 + 0.02 * rng.normal(size=(B, Tm1))),
            w0 * (1.0 + 0.02 * rng.normal(size=(B, Tm1))),
            0.01 * rng.normal(size=(B, Tm1)), 0.01 * rng.normal(size=(B, Tm1)))


def consts(tm, tss, dtype):
    wealth, prod = tm.endog_dims()[0], tm.exog_dims()[0]
    return [t.to(dtype).contiguous() for t in
            (tss.value, tss.D, wealth.grid, prod.grid, prod.transition)]


def shock_batch(T, rhos, size=0.05):
    """Z_b,t = 1 + size·ρ_bᵗ, (B, T-1) f64 numpy."""
    t = np.arange(1, T, dtype=np.float64)
    return 1.0 + size * np.asarray(rhos)[:, None] ** t[None, :]


def test_batched_plain_sweep_matches_jax_interpret_and_single_rows(both):
    from hank_tpu.ops.fused_sweep_batch import fused_sweep_jvp_batch as jbatch

    _, jss, tm, tss, _ = both
    Tm1 = tm.compspec.T - 1
    paths = [to_torch(a, f32) for a in price_batch(jss, Tm1, 3, seed=0)]
    c32 = consts(tm, tss, f32)
    kw = kernel_kwargs(tm)
    calls = fused_sweep_jvp_batch_reference.calls
    out = fused_sweep_jvp_batch(*paths, *c32, **kw)
    assert fused_sweep_jvp_batch_reference.calls == calls + 1
    ref = jbatch(*(jnp.asarray(a.numpy()) for a in (*paths, *c32)), **kw, interpret=True)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape == (3, Tm1) and o.dtype == f32
        assert float(np.max(np.abs(o.numpy() - r))) <= 2e-5 * max(float(np.max(np.abs(r))), 1.0)
    for b in range(3):
        single = fused_sweep_jvp_reference(*(p[b] for p in paths), *c32, **kw)
        for o, s in zip(out, single):
            assert torch.equal(o[b], s)


def test_make_fused_jvp_batch_matches_jax_interpret_per_row(both):
    """Rows carry different shock paths (ρ 0.7, 0.8, 0.9)."""
    from hank_tpu.ops.fused_sweep_batch import make_fused_jvp_batch as jmake

    jm, jss, tm, tss, x_ss = both
    T = tm.compspec.T
    rng = np.random.default_rng(4)
    Z = shock_batch(T, [0.7, 0.8, 0.9], size=0.1)
    x_b = x_ss[None] * (1.0 + 0.005 * rng.normal(size=(3, x_ss.shape[0])))
    v_b = rng.normal(size=(3, x_ss.shape[0]))
    ref = np.asarray(jmake(jm, jss, jss, interpret=True)(
        jnp.asarray(x_b), jnp.asarray(v_b), {"Z": jnp.asarray(Z)}))
    out = make_fused_jvp_batch(tm, tss, tss)(to_torch(x_b), to_torch(v_b), {"Z": to_torch(Z)})
    assert out.dtype == f32 and out.shape == ref.shape == x_b.shape
    for b in range(3):
        scale = float(np.max(np.abs(ref[b])))
        assert float(np.max(np.abs(out[b].numpy() - ref[b]))) <= 3e-5 * max(scale, 1.0)


def test_residual_ensemble_matches_jax(both):
    from hank_tpu.parallel.ensemble import residual_ensemble as jres

    jm, jss, tm, tss, x_ss = both
    T = tm.compspec.T
    B = 4
    Z = shock_batch(T, 0.5 + 0.4 * np.arange(B) / B)
    x_b = x_ss[None] + 0.01 * np.random.default_rng(7).normal(size=(B, x_ss.shape[0]))
    ref = np.asarray(jres(jnp.asarray(x_b), {"Z": jnp.asarray(Z)}, jm, jss, jss))
    calls = fused_residual_sweep_batch_reference.calls
    out = residual_ensemble(to_torch(x_b), {"Z": to_torch(Z)}, tm, tss, tss)
    assert fused_residual_sweep_batch_reference.calls == calls + 1
    assert out.dtype == f64 and out.shape == ref.shape == (B, x_ss.shape[0])
    assert float(np.max(np.abs(out.numpy() - ref))) <= 1e-12
    with pytest.raises(ValueError, match="4 rows do not split over the 3 ranks"):
        residual_ensemble(to_torch(x_b), {"Z": to_torch(Z)}, tm, tss, tss, mesh=MeshOfSize(3))


def test_batched_plain_residual_rows_equal_single_rows(both):
    _, jss, tm, tss, _ = both
    Tm1 = tm.compspec.T - 1
    r_b, w_b, _, _ = (to_torch(a) for a in price_batch(jss, Tm1, 3, seed=1))
    c64 = consts(tm, tss, f64)
    kw = kernel_kwargs(tm)
    agg, aggc = fused_residual_sweep_batch(r_b, w_b, *c64, **kw)
    for b in range(3):
        s_agg, s_aggc = fused_residual_sweep_reference(r_b[b], w_b[b], *c64, **kw)
        assert torch.equal(agg[b], s_agg) and torch.equal(aggc[b], s_aggc)


def test_batched_wrappers_reject_what_the_kernel_does_not_take(both):
    _, jss, tm, tss, _ = both
    Tm1 = tm.compspec.T - 1
    kw = kernel_kwargs(tm)
    paths = [to_torch(a, f32) for a in price_batch(jss, Tm1, 2, seed=2)]
    c32 = consts(tm, tss, f32)
    with pytest.raises(TypeError):                       # dtype
        fused_sweep_jvp_batch(paths[0].double(), *paths[1:], *c32, **kw)
    with pytest.raises(ValueError):                      # one path, not a batch
        fused_sweep_jvp_batch(*(p[0] for p in paths), *c32, **kw)
    with pytest.raises(ValueError):                      # ragged batch
        fused_sweep_jvp_batch(paths[0][:1], *paths[1:], *c32, **kw)
    with pytest.raises(ValueError):                      # layout
        fused_sweep_jvp_batch(paths[0].T.contiguous().T, *paths[1:], *c32, **kw)
    with pytest.raises(ValueError):                      # shared state shape
        fused_sweep_jvp_batch(*paths, c32[0][:-1].contiguous(), *c32[1:], **kw)
    with pytest.raises(ValueError):                      # empty batch
        fused_sweep_jvp_batch(*(p[:0] for p in paths), *c32, **kw)
    with pytest.raises(ValueError):                      # a batch into the single wrapper
        fused_sweep_jvp(*paths, *c32, **kw)
    c64 = consts(tm, tss, f64)
    r64, w64 = paths[0].double(), paths[1].double()
    with pytest.raises(TypeError):
        fused_residual_sweep_batch(r64, w64, c64[0].float(), *c64[1:], **kw)
    with pytest.raises(ValueError):
        fused_residual_sweep_batch(r64, w64[:, :-1].contiguous(), *c64, **kw)
    launches = (fused_sweep_jvp_batch.launches, fused_residual_sweep_batch.launches)
    fused_sweep_jvp_batch(*paths, *c32, **kw)
    fused_residual_sweep_batch(r64, w64, *c64, **kw)
    assert (fused_sweep_jvp_batch.launches, fused_residual_sweep_batch.launches) == launches


def test_batched_wrappers_refuse_fallback_rows_on_cpu_tensors(both):
    """The plain versions have no fallback branches to count."""
    _, jss, tm, tss, _ = both
    Tm1 = tm.compspec.T - 1
    kw = kernel_kwargs(tm)
    paths = [to_torch(a, f32) for a in price_batch(jss, Tm1, 2, seed=2)]
    fallback = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="fallback_rows"):
        fused_sweep_jvp_batch(*paths, *consts(tm, tss, f32), **kw, fallback_rows=fallback)
    with pytest.raises(ValueError, match="fallback_rows"):
        fused_residual_sweep_batch(paths[0].double(), paths[1].double(),
                                   *consts(tm, tss, f64), **kw, fallback_rows=fallback)


@pytest.mark.parametrize("which", ["kernels 3-4", "batched kernel 2"])
def test_previous_batched_kernels_refuse_cpu_tensors(both, which):
    """The previous kernels run on the card only (their plain versions are
    the new kernels'), and count no launch when they refuse."""
    _, jss, tm, tss, _ = both
    Tm1 = tm.compspec.T - 1
    kw = kernel_kwargs(tm)
    paths = [to_torch(a, f32) for a in price_batch(jss, Tm1, 2, seed=2)]
    if which == "kernels 3-4":
        fn, args = fused_sweep_jvp_batch_previous, (*paths, *consts(tm, tss, f32))
    else:
        fn, args = fused_residual_sweep_batch_previous, (
            paths[0].double(), paths[1].double(), *consts(tm, tss, f64))
    launches = fn.launches
    with pytest.raises(ValueError, match="card only"):
        fn(*args, **kw)
    assert fn.launches == launches


# ── On the card ────────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_batched_kernel1_on_card_rows_equal_single_launches(both, cuda):
    _, jss, tm, tss, _ = both
    Tm1 = tm.compspec.T - 1
    kw = kernel_kwargs(tm)
    paths = [to_torch(a, f32).to(cuda) for a in price_batch(jss, Tm1, 5, seed=3)]
    c32 = [c.to(cuda) for c in consts(tm, tss, f32)]
    launches = fused_sweep_jvp_batch.launches
    out = fused_sweep_jvp_batch(*paths, *c32, **kw)
    assert fused_sweep_jvp_batch.launches == launches + 1
    ref = fused_sweep_jvp_batch_reference(*paths, *c32, **kw)
    for o, r in zip(out, ref):
        assert float((o - r).abs().max()) <= 3e-5 * max(float(r.abs().max()), 1.0)
    for b in range(5):
        single = fused_sweep_jvp(*(p[b].contiguous() for p in paths), *c32, **kw)
        for o, s in zip(out, single):
            assert torch.equal(o[b], s)
    zero = torch.zeros_like(paths[2])
    out0 = fused_sweep_jvp_batch(paths[0], paths[1], zero, zero, *c32, **kw)
    assert bool((out0[1] == 0).all()) and bool((out0[3] == 0).all())


@pytest.mark.gpu
def test_batched_kernel2_on_card_rows_equal_single_launches(both, cuda):
    _, jss, tm, tss, _ = both
    Tm1 = tm.compspec.T - 1
    kw = kernel_kwargs(tm)
    r_b, w_b, _, _ = (to_torch(a).to(cuda) for a in price_batch(jss, Tm1, 5, seed=4))
    c64 = [c.to(cuda) for c in consts(tm, tss, f64)]
    out = fused_residual_sweep_batch(r_b, w_b, *c64, **kw)
    ref = fused_residual_sweep_batch_reference(r_b, w_b, *c64, **kw)
    for o, r in zip(out, ref):
        assert float((o - r).abs().max()) <= 1e-11
    for b in range(5):
        single = fused_residual_sweep(r_b[b].contiguous(), w_b[b].contiguous(), *c64, **kw)
        for o, s in zip(out, single):
            assert torch.equal(o[b], s)

