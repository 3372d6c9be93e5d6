"""PyTorch port: f64 directions through the f64 tangent sweep, on the CPU.

With f64 directions (`direction_dtype=None`, the default) the port's
`f64_direction_route` takes the one-asset f64 tangent sweep
(`fused_sweep_jvp_f64`, `household_sweep_ranged_kernel<double, true,
false>` on the card) under "pallas", and under "auto" on the card; "xla",
and "auto" on CPU tensors, take `torch.func.jvp` of the plain f64 pipeline,
as the reference does for every f64 direction (`hank_tpu/solvers/
newton.py:389`). On the small Krusell-Smith (40×5, T=12, transitory TFP
shock), from the JAX steady state carried across:
  - the f64 kernel map's plain version against the JAX package's
    `jax.jvp` of its f64 F and against the port's AD route, to 1e-12 of
    the direction's scale;
  - the route each mode takes on CPU tensors (AD under "auto");
  - a boehl solve and a Newton-Krylov solve through the f64 kernel map
    reach the AD route's path within 1e-9;
  - "pallas" with f64 directions raises for a model outside the family.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hank_tpu_torch.solvers.newton as newton_mod
from hank_tpu_torch.ops.fused_sweep import fused_sweep_jvp_reference, make_fused_jvp_dir_f64
from hank_tpu_torch.solvers.newton import make_path_solver
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import build_small_ks_torch, ss_to_numpy, to_torch, transitory_exog
from tests.test_torch_solve import x_ss_of

torch.set_num_threads(1)
f64 = torch.float64
RTOL = 1e-12


class Case:
    def __init__(self, jm, jss):
        T = jm.compspec.T
        self.jm, self.jss = jm, jss
        self.tm = build_small_ks_torch(T=T)
        self.tss = steady_state_from_numpy(ss_to_numpy(jss), device="cpu")
        self.z = transitory_exog(T)
        self.exog = {"Z": to_torch(self.z)}
        self.x_ss = x_ss_of(jm, jss)


@pytest.fixture(scope="module")
def ks(ks_small, ks_small_ss):
    return Case(ks_small, ks_small_ss)


def points(case, seed):
    rng = np.random.default_rng(seed)
    x = case.x_ss * (1.0 + 0.002 * rng.normal(size=case.x_ss.shape))
    return x, rng.normal(size=case.x_ss.shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_f64_kernel_map_matches_jax_and_ad(ks, seed):
    """The f64 kernel map (its plain version: the price map, `torch.func.jvp`
    through the f64 household blocks, the f64 tail) against `jax.jvp` of the
    JAX package's f64 F and the port's AD route."""
    from hank_tpu.solvers.newton import make_full_residual_fn as jmake_F

    x, v = points(ks, seed)
    jF = jmake_F(ks.jm, ks.jss, ks.jss, {"Z": jnp.asarray(ks.z)})
    ref = np.asarray(jax.jvp(jF, (jnp.asarray(x),), (jnp.asarray(v),))[1])
    calls = fused_sweep_jvp_reference.calls
    out = make_fused_jvp_dir_f64(ks.tm, ks.tss, ks.tss, ks.exog)(to_torch(x), to_torch(v))
    assert fused_sweep_jvp_reference.calls == calls + 1
    assert out.dtype == f64 and out.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    assert float(np.max(np.abs(out.numpy() - ref))) <= RTOL * scale
    ad = newton_mod.f64_direction_route(ks.tm, ks.tss, ks.tss, ks.exog, "xla")
    assert float((out - ad(to_torch(x), to_torch(v))).abs().max()) <= RTOL * scale


@pytest.mark.parametrize("mode,kernel_calls,ad_calls", [("auto", 0, 1), ("xla", 0, 1),
                                                        ("pallas", 1, 0)])
def test_f64_direction_mode_picks_the_route_on_the_cpu(ks, mode, kernel_calls, ad_calls):
    """On CPU tensors "auto" is AD, as in the reference; "pallas" takes the
    f64 kernel map's plain version."""
    x, v = points(ks, 2)
    calls, ad = fused_sweep_jvp_reference.calls, newton_mod.ad_direction.calls
    newton_mod.f64_direction_route(ks.tm, ks.tss, ks.tss, ks.exog, mode)(to_torch(x),
                                                                         to_torch(v))
    assert fused_sweep_jvp_reference.calls - calls == kernel_calls
    assert newton_mod.ad_direction.calls - ad == ad_calls


@pytest.mark.parametrize("method", ["boehl", "newton_krylov"])
def test_solves_through_the_f64_kernel_map_match_ad(ks, method):
    """The same solve with f64 directions through the f64 kernel map's plain
    version ("pallas") and by AD ("xla"): the same path within 1e-9."""
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    J = to_torch(np.asarray(jjac(ks.jss, ks.jm)))
    paths = {}
    for mode in ("pallas", "xla"):
        calls, ad = fused_sweep_jvp_reference.calls, newton_mod.ad_direction.calls
        x, info = make_path_solver(J, ks.exog, ks.tm, ks.tss, ks.tss, method=method,
                                   direction_mode=mode, eps=1e-10)(to_torch(ks.x_ss))
        assert info["residual_norm"] < 1e-10
        used_kernel = fused_sweep_jvp_reference.calls > calls
        used_ad = newton_mod.ad_direction.calls > ad
        assert (used_kernel, used_ad) == ((True, False) if mode == "pallas" else (False, True))
        paths[mode] = x
    assert float((paths["pallas"] - paths["xla"]).abs().max()) <= 1e-9


def test_f64_pallas_needs_the_one_asset_sweep(ks):
    other = dataclasses.replace(ks.tm, value_fn=lambda v, x, m: None)
    J = torch.eye(ks.x_ss.shape[0], dtype=f64)
    with pytest.raises(ValueError, match="direction_mode='pallas' with f64 directions"):
        make_path_solver(J, ks.exog, other, ks.tss, ks.tss, direction_mode="pallas")
    for mode in ("auto", "xla"):
        make_path_solver(J, ks.exog, other, ks.tss, ks.tss, direction_mode=mode)
