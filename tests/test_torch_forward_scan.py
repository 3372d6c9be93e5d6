"""PyTorch port: kernel 7, the forward distribution scan, against hank_tpu.

The plain version (`forward_scan_reference`, which the wrapper runs on CPU
tensors) is held to the JAX package's Pallas kernel in interpret mode on the
inputs of `tests/test_pallas_kernels.py`, and in f64 to the JAX f64
`lax.scan` of `lottery_apply` / `exog_apply`. The CUDA kernel runs only on
a card: its test carries the `gpu` marker and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst
from hank_tpu_torch.ops.forward_scan import forward_scan, forward_scan_reference

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64


def scan_inputs(seed: int = 0, n_a: int = 24, n_e: int = 4, T: int = 11):
    """The inputs of `tests/test_pallas_kernels.py:14-22`, in float64 numpy:
    sorted random policies reaching past the grid top, a random D0."""
    rng = np.random.default_rng(seed)
    grid = make_double_exponential_grid(0.0, 50.0, n_a)
    Pi, _, _ = rouwenhorst(n_e, 0.9, 0.3)
    pols = np.sort(rng.uniform(0, 52, size=(T, n_a, n_e)), axis=1)
    D0 = rng.uniform(0.1, 1.0, size=(n_a, n_e))
    return pols, D0 / D0.sum(), grid, Pi


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_pallas_interpret(seed):
    from hank_tpu.ops.pallas_kernels import forward_scan_pallas

    pols, D0, grid, Pi = scan_inputs(seed)
    agg_j, D_j = forward_scan_pallas(*(jnp.asarray(a, dtype=jnp.float32)
                                       for a in (pols, D0, grid, Pi)), interpret=True)
    calls, launches = forward_scan_reference.calls, forward_scan.launches
    agg, D_T = forward_scan(*(torch.tensor(a, dtype=f32) for a in (pols, D0, grid, Pi)))
    assert forward_scan_reference.calls == calls + 1 and forward_scan.launches == launches
    assert agg.dtype == D_T.dtype == f32 and agg.shape == (11,) and D_T.shape == (24, 4)
    # f32 on both sides, summed in other orders: 1e-5 on aggregates of
    # scale ~20, 1e-6 on the masses.
    assert float(np.max(np.abs(agg.numpy() - np.asarray(agg_j)))) <= 1e-5
    assert float(np.max(np.abs(D_T.numpy() - np.asarray(D_j)))) <= 1e-6
    assert abs(float(D_T.sum()) - 1.0) <= 1e-5


def test_plain_version_in_f64_matches_jax_f64_scan():
    from hank_tpu.ops.transition import exog_apply, lottery_apply

    pols, D0, grid, Pi = scan_inputs(2, n_a=40, n_e=5, T=20)
    g, P = jnp.asarray(grid), jnp.asarray(Pi)

    def step(d, p):
        dn = exog_apply(lottery_apply(p, d, g, dense=True), [P], 1)
        return dn, jnp.sum(p * dn)

    D_j, agg_j = jax.lax.scan(step, jnp.asarray(D0), jnp.asarray(pols))
    agg, D_T = forward_scan_reference(*(torch.tensor(a, dtype=f64)
                                        for a in (pols, D0, grid, Pi)))
    assert agg.dtype == f64
    assert float(np.max(np.abs(agg.numpy() - np.asarray(agg_j)))) <= 1e-13
    assert float(np.max(np.abs(D_T.numpy() - np.asarray(D_j)))) <= 1e-13


def test_wrapper_casts_to_f32_and_rejects_what_the_kernel_does_not_take():
    pols, D0, grid, Pi = (torch.tensor(a, dtype=f64) for a in scan_inputs(3))
    agg, D_T = forward_scan(pols, D0, grid, Pi)              # cast, as the JAX function
    ref = forward_scan_reference(pols.float(), D0.float(), grid.float(), Pi.float())
    assert agg.dtype == f32 and torch.equal(agg, ref[0]) and torch.equal(D_T, ref[1])
    with pytest.raises(ValueError, match="contiguous"):
        forward_scan(pols.float(), D0.float().T.contiguous().T, grid, Pi)
    with pytest.raises(ValueError, match="policies"):
        forward_scan(pols[0], D0, grid, Pi)
    with pytest.raises(ValueError, match="policies"):
        forward_scan(pols[:0], D0, grid, Pi)
    with pytest.raises(ValueError, match="expected D0"):
        forward_scan(pols, D0[:-1], grid, Pi)
    with pytest.raises(ValueError, match="expected D0"):
        forward_scan(pols, D0, grid, Pi[:2, :2])
    with pytest.raises(TypeError):
        forward_scan(pols.numpy(), D0, grid, Pi)


# ── On the card ────────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_kernel_on_card_matches_its_plain_version_in_f64(cuda):
    pols, D0, grid, Pi = (torch.tensor(a, dtype=f32, device=cuda)
                          for a in scan_inputs(4, n_a=200, n_e=7, T=50))
    launches = forward_scan.launches
    agg, D_T = forward_scan(pols, D0, grid, Pi)
    again = forward_scan(pols, D0, grid, Pi)
    assert forward_scan.launches == launches + 2
    assert torch.equal(agg, again[0]) and torch.equal(D_T, again[1])    # no atomics
    ref_agg, ref_D = forward_scan_reference(pols.double(), D0.double(), grid.double(),
                                            Pi.double())
    scale = float(ref_agg.abs().max())
    assert float((agg.double() - ref_agg).abs().max()) <= 5e-5 * max(scale, 1.0)
    assert float((D_T.double() - ref_D).abs().max()) <= 1e-6
