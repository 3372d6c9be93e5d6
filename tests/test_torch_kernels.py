"""PyTorch port: the two household-sweep kernels and their plain versions.

On the CPU the wrappers run the plain PyTorch versions; those are held
against the JAX package's Pallas kernels in interpret mode and against its
f64 pipeline, on the small Krusell-Smith (40×5, T=12). The kernels
themselves run only on a CUDA card: those tests carry the `gpu` marker and
skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                               fused_residual_sweep_reference,
                                               make_sweep_residual_fn)
from hank_tpu_torch.ops.fused_sweep import (fused_sweep_jvp, fused_sweep_jvp_reference,
                                            make_fused_jvp_dir)
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import (build_small_ks_torch, ss_to_numpy, to_torch,
                                     transitory_exog)

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64


@pytest.fixture(scope="module")
def both(ks_small, ks_small_ss):
    T = ks_small.compspec.T
    z = transitory_exog(T)
    tm = build_small_ks_torch(T=T)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    endog = ks_small.vars_of_type("endogenous")
    x_ss = np.tile(np.array([float(ks_small_ss.vars[k]) for k in endog]), T - 1)
    return (ks_small, ks_small_ss, {"Z": jnp.asarray(z)}, tm, tss,
            {"Z": to_torch(z)}, x_ss)


def sweep_args(tm, tss, x, v, dtype):
    """Kernel-1 arguments (r, w, dr, dw, V_T, D0, grid, e_grid, Pi) from flat
    f64 numpy x, v on the small model (v=None: the kernel-2 arguments)."""
    endog = tm.vars_of_type("endogenous")
    i_r, i_w = endog.index("r"), endog.index("w")
    nE = tm.compspec.n_endog

    def col(a, i):
        return to_torch(a.reshape(-1, nE)[:, i], dtype).contiguous()

    wealth, prod = tm.endog_dims()[0], tm.exog_dims()[0]
    consts = [t.to(dtype).contiguous() for t in
              (tss.value, tss.D, wealth.grid, prod.grid, prod.transition)]
    paths = [col(x, i_r), col(x, i_w)]
    if v is not None:
        paths += [col(v, i_r), col(v, i_w)]
    return (*paths, *consts)


def kernel_kwargs(tm):
    p = tm.params
    return dict(beta=p["β"], gamma=p["γ"], borrow_cons=p["borrow_cons"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel1_plain_jvp_dir_matches_jax_interpret(both, seed):
    from hank_tpu.ops.fused_sweep import make_fused_jvp_dir as jmake

    jm, jss, jex, tm, tss, tex, x_ss = both
    rng = np.random.default_rng(seed)
    x = x_ss + 0.01 * rng.normal(size=x_ss.shape)
    v = rng.normal(size=x_ss.shape)
    ref = np.asarray(jmake(jm, jss, jss, jex, interpret=True)(jnp.asarray(x), jnp.asarray(v)))
    out = make_fused_jvp_dir(tm, tss, tss, tex)(to_torch(x), to_torch(v))
    assert out.dtype == f32
    scale = float(np.max(np.abs(ref)))
    assert float(np.max(np.abs(out.numpy() - ref))) <= 3e-5 * max(scale, 1.0)


def test_kernel1_plain_sweep_matches_jax_interpret_and_zero_tangent(both):
    from hank_tpu.ops.fused_sweep import fused_sweep_jvp as jsweep

    jm, jss, jex, tm, tss, tex, x_ss = both
    rng = np.random.default_rng(3)
    x = x_ss + 0.02 * rng.normal(size=x_ss.shape)
    v = rng.normal(size=x_ss.shape)
    args = sweep_args(tm, tss, x, v, f32)
    kw = kernel_kwargs(tm)
    calls = fused_sweep_jvp_reference.calls
    out = fused_sweep_jvp(*args, **kw)
    assert fused_sweep_jvp_reference.calls == calls + 1
    ref = jsweep(*(jnp.asarray(a.numpy()) for a in args), **kw, interpret=True)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert float(np.max(np.abs(o.numpy() - r))) <= 3e-5 * max(float(np.max(np.abs(r))), 1.0)

    zero = torch.zeros_like(args[2])
    out0 = fused_sweep_jvp(args[0], args[1], zero, zero, *args[4:], **kw)
    assert float(out0[1].abs().max()) == 0.0 and float(out0[3].abs().max()) == 0.0
    assert torch.equal(out0[0], out[0]) and torch.equal(out0[2], out[2])


def test_kernel1_plain_f32_residual_matches_jax_interpret(both):
    """`_build_fused`'s residual32: kernel 1 with a zero tangent + f32 tail."""
    from hank_tpu.ops.fused_sweep import make_fused_residual_fn as jmake
    from hank_tpu_torch.ops.fused_sweep import make_fused_residual_fn

    jm, jss, jex, tm, tss, tex, x_ss = both
    x = x_ss + 0.01 * np.random.default_rng(4).normal(size=x_ss.shape)
    ref = np.asarray(jmake(jm, jss, jss, jex, interpret=True)(jnp.asarray(x)))
    out = make_fused_residual_fn(tm, tss, tss, tex)(to_torch(x))
    assert out.dtype == f32
    assert float(np.max(np.abs(out.numpy() - ref))) <= 3e-5 * max(float(np.max(np.abs(ref))), 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel2_plain_matches_jax_f64_pipeline(both, seed):
    from hank_tpu.solvers.newton import make_full_residual_fn as jmake

    jm, jss, jex, tm, tss, tex, x_ss = both
    rng = np.random.default_rng(10 + seed)
    x = x_ss + 0.01 * rng.normal(size=x_ss.shape)
    ref = np.asarray(jax.jit(jmake(jm, jss, jss, jex))(jnp.asarray(x)))
    calls = fused_residual_sweep_reference.calls
    out = make_sweep_residual_fn(tm, tss, tss, tex)(to_torch(x))
    assert fused_residual_sweep_reference.calls == calls + 1
    assert out.dtype == f64
    assert float(np.max(np.abs(out.numpy() - ref))) <= 1e-12


def test_kernel2_plain_matches_jax_double_single_interpret(both):
    from hank_tpu.ops.fused_ds import make_ds_residual_fn

    jm, jss, jex, tm, tss, tex, x_ss = both
    rng = np.random.default_rng(11)
    x = x_ss + 0.01 * rng.normal(size=x_ss.shape)
    ref = np.asarray(make_ds_residual_fn(jm, jss, jss, jex, interpret=True)(jnp.asarray(x)))
    out = make_sweep_residual_fn(tm, tss, tss, tex)(to_torch(x))
    assert float(np.max(np.abs(out.numpy() - ref))) <= 2e-10


def test_wrappers_reject_what_the_kernels_do_not_take(both):
    _, _, _, tm, tss, _, x_ss = both
    kw = kernel_kwargs(tm)
    args = sweep_args(tm, tss, x_ss, x_ss, f32)
    with pytest.raises(TypeError):
        fused_sweep_jvp(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError):
        fused_sweep_jvp(*args[:4], args[4].T.contiguous().T, *args[5:], **kw)
    with pytest.raises(ValueError):
        fused_sweep_jvp(args[0][:-1], *args[1:], **kw)
    args64 = sweep_args(tm, tss, x_ss, None, f64)
    with pytest.raises(TypeError):
        fused_residual_sweep(*args64[:2], args64[2].float(), *args64[3:], **kw)
    with pytest.raises(ValueError):
        fused_residual_sweep(*args64[:6], args64[6][:2, :2].contiguous(), **kw)
    with pytest.raises(ValueError, match="fallback_rows"):
        fused_sweep_jvp(*args, **kw, fallback_rows=torch.zeros(2, dtype=torch.int32))
    launches = (fused_sweep_jvp.launches, fused_residual_sweep.launches)
    fused_residual_sweep(*args64, **kw)
    fused_sweep_jvp(*args, **kw)
    assert (fused_sweep_jvp.launches, fused_residual_sweep.launches) == launches


# ── On the card ────────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel1_on_card_matches_its_plain_version(both, cuda, seed):
    _, _, _, tm, tss, _, x_ss = both
    rng = np.random.default_rng(seed)
    x = x_ss + 0.01 * rng.normal(size=x_ss.shape)
    v = rng.normal(size=x_ss.shape)
    args = [a.to(cuda) for a in sweep_args(tm, tss, x, v, f32)]
    kw = kernel_kwargs(tm)
    launches = fused_sweep_jvp.launches
    out = fused_sweep_jvp(*args, **kw)
    again = fused_sweep_jvp(*args, **kw)
    assert fused_sweep_jvp.launches == launches + 2
    ref = fused_sweep_jvp_reference(*args, **kw)
    for o, a, r in zip(out, again, ref):
        assert torch.equal(o, a)                       # no float atomics
        scale = float(r.abs().max())
        assert float((o - r).abs().max()) <= 3e-5 * max(scale, 1.0)
    zero = torch.zeros_like(args[2])
    out0 = fused_sweep_jvp(args[0], args[1], zero, zero, *args[4:], **kw)
    assert bool((out0[1] == 0).all()) and bool((out0[3] == 0).all())


@pytest.mark.gpu
def test_kernel1_on_card_is_bit_for_bit_the_template(both, cuda):
    """Kernel 1 against the kernel template's B = 1 launch on all four
    outputs, at a smooth point and with the grid's knots 5 and 6 swapped
    (policy rows out of order: the fallback branches)."""
    from hank_tpu_torch.ops.fused_sweep_batch import fused_sweep_jvp_batch

    _, _, _, tm, tss, _, x_ss = both
    rng = np.random.default_rng(3)
    kw = kernel_kwargs(tm)
    args = [a.to(cuda) for a in sweep_args(tm, tss, x_ss * 1.001, rng.normal(size=x_ss.shape),
                                           f32)]
    grid = args[6].clone()
    grid[[5, 6]] = grid[[6, 5]]
    for inputs in (args, [*args[:6], grid, *args[7:]]):
        fallback = torch.zeros(2, dtype=torch.int32, device=cuda)
        out = fused_sweep_jvp(*inputs, **kw, fallback_rows=fallback)
        rows = fused_sweep_jvp_batch(*(a[None].contiguous() for a in inputs[:4]), *inputs[4:],
                                     **kw)
        for o, r in zip(out, rows):
            assert torch.equal(o.view(torch.int32), r[0].view(torch.int32))
    assert int(fallback[1]) > 0


@pytest.mark.gpu
def test_kernel2_on_card_matches_its_plain_version(both, cuda):
    _, _, _, tm, tss, _, x_ss = both
    rng = np.random.default_rng(5)
    x = x_ss + 0.01 * rng.normal(size=x_ss.shape)
    args = [a.to(cuda) for a in sweep_args(tm, tss, x, None, f64)]
    kw = kernel_kwargs(tm)
    launches = fused_residual_sweep.launches
    out = fused_residual_sweep(*args, **kw)
    assert fused_residual_sweep.launches == launches + 1
    ref = fused_residual_sweep_reference(*args, **kw)
    for o, r in zip(out, ref):
        assert float((o - r).abs().max()) <= 1e-11
