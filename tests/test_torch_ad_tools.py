"""PyTorch port: the AD validation tools and the last setup options against
hank_tpu, on the small Krusell-Smith (40×5, T=12) with the JAX steady state
carried across.

`direct_jacobian_columns` (jvp and fd, the columns of
`tests/test_jacobian.py:80`), `dense_path_jacobian` (against JAX's and
against J̄, the Toeplitz assembly's ground truth, `tests/test_jacobian.py:28`),
J̄ with `boundary_correction=True`, `single_run` and `egm_consumption`, each
against the JAX package's function on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.config import default_dtype
from hank_tpu_torch.ops.egm import egm_consumption
from hank_tpu_torch.solvers.ss_jacobian import (dense_path_jacobian, direct_jacobian_blocks,
                                                direct_jacobian_columns,
                                                get_steady_state_jacobian)
from hank_tpu_torch.solvers.steady_state import single_run
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import build_small_ks_torch, ss_to_numpy, to_torch, transitory_exog

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port(ks_small, ks_small_ss):
    tm = build_small_ks_torch(T=ks_small.compspec.T)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    return tm, tss


@pytest.fixture(scope="module")
def columns(ks_small):
    n = ks_small.compspec.n_endog * (ks_small.compspec.T - 1)
    return [0, 1, 2, n // 2, n - 2, n - 1]


@pytest.fixture(scope="module")
def jbar(port):
    tm, tss = port
    return get_steady_state_jacobian(tss, tm)


@pytest.mark.parametrize("mode,bound", [("jvp", 1e-12), ("fd", 1e-9)])
def test_direct_jacobian_columns_match_jax(ks_small, ks_small_ss, port, columns, mode, bound):
    from hank_tpu.solvers.ss_jacobian import direct_jacobian_columns as jcols

    tm, tss = port
    ref = np.asarray(jcols(ks_small_ss, ks_small_ss, ks_small, columns, mode=mode))
    out = direct_jacobian_columns(tss, tss, tm, columns, mode=mode)
    assert out.shape == ref.shape == (len(ref), len(columns))
    assert float(np.max(np.abs(out.numpy() - ref))) <= bound


def test_direct_jacobian_columns_agree_with_jbar_and_refuse_other_modes(port, columns, jbar):
    tm, tss = port
    out = direct_jacobian_columns(tss, tss, tm, columns)
    assert float((out - jbar[:, columns]).abs().max()) <= 1e-9
    fd = direct_jacobian_columns(tss, tss, tm, columns, mode="fd", fd_step=1e-6)
    assert float((fd - out).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="mode must be 'jvp' or 'fd'"):
        direct_jacobian_columns(tss, tss, tm, columns, mode="rev")


def test_dense_path_jacobian_matches_jax_and_the_toeplitz_assembly(ks_small, ks_small_ss,
                                                                   port, jbar):
    from hank_tpu.solvers.ss_jacobian import dense_path_jacobian as jdense

    tm, tss = port
    dense = dense_path_jacobian(tss, tss, tm)
    ref = np.asarray(jdense(ks_small_ss, ks_small_ss, ks_small))
    assert dense.shape == jbar.shape
    assert float(np.max(np.abs(dense.numpy() - ref))) <= 1e-12
    assert float((dense - jbar).abs().max()) <= 1e-9


def test_boundary_correction_matches_jax(ks_small, ks_small_ss, port, jbar):
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    tm, tss = port
    corrected = get_steady_state_jacobian(tss, tm, boundary_correction=True)
    ref = np.asarray(jjac(ks_small_ss, ks_small, boundary_correction=True))
    assert float(np.max(np.abs(corrected.numpy() - ref))) <= 1e-12
    blocks, k = direct_jacobian_blocks(tss, tm)
    nE = tm.compspec.n_endog
    diff = corrected - jbar
    assert float((diff[:nE, :nE] - blocks[k + 1]).abs().max()) <= 1e-15
    diff[:nE, :nE] = 0.0
    assert float(diff.abs().max()) == 0.0


def test_single_run_matches_jax(ks_small, ks_small_ss, port):
    from hank_tpu.solvers.steady_state import single_run as jsingle

    tm, tss = port
    T = tm.compspec.T
    Z = transitory_exog(T)
    out = single_run(tss, tss, tm, {"Z": to_torch(Z)})
    ref = np.asarray(jsingle(ks_small_ss, ks_small_ss, ks_small, {"Z": jnp.asarray(Z)}))
    assert out.dtype == default_dtype() == torch.float64
    assert float(np.max(np.abs(out.numpy() - ref))) <= 1e-12
    flat = single_run(tss, tss, tm, {"Z": torch.ones(T - 1, dtype=torch.float64)})
    assert float(flat.abs().max()) < 1e-8


@pytest.mark.parametrize("seed", [0, 1])
def test_egm_consumption_matches_jax(seed):
    from hank_tpu.ops.egm import egm_consumption as jegm
    from hank_tpu_torch.model.grids import rouwenhorst

    rng = np.random.default_rng(seed)
    V = rng.uniform(0.5, 3.0, size=(40, 5))
    Pi = rouwenhorst(5, 0.966, 0.283)[0]
    out = egm_consumption(to_torch(V), to_torch(Pi), 0.98, 2.0)
    ref = np.asarray(jegm(jnp.asarray(V), jnp.asarray(Pi), 0.98, 2.0))
    assert out.shape == (40, 5)
    assert float(np.max(np.abs(out.numpy() - ref) / np.abs(ref))) <= 1e-14
