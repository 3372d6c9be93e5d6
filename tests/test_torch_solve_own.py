"""PyTorch port: the slice as a whole from the port's own setup.

The headline scenario (permanent TFP shock Z 1→2) on the small
Krusell-Smith (40×5, T=12): both steady states and J̄ from the port's
`get_or_solve` with no JAX artifact, Newton-Krylov with f32 directions at
eps = 1e-10, held pointwise to 1e-9 against the JAX package's solution from
its own `get_or_solve`.
"""

import jax.numpy as jnp
import numpy as np
import torch

from hank_tpu_torch.models.krusell_smith import exogenousZ
from hank_tpu_torch.solvers.newton import make_full_residual_fn, make_path_solver
from hank_tpu_torch.utils.checkpoint import get_or_solve
from tests.test_torch_common import build_small_ks_torch, to_torch
from tests.test_torch_solve import jax_reference_solution, x_ss_of

torch.set_num_threads(1)


def test_slice_from_its_own_setup(ks_small, tmp_path):
    """Permanent TFP shock Z 1→2 (the headline scenario): both steady states
    and J̄ from the port's `get_or_solve`; the JAX side from its own."""
    from hank_tpu.models.krusell_smith import exogenousZ as jexogenousZ
    from hank_tpu.utils.checkpoint import get_or_solve as jget_or_solve

    T = ks_small.compspec.T
    tm = build_small_ks_torch(T=T)
    ss0, ssT, J = get_or_solve(tm, cache_dir=str(tmp_path))
    jss0, jssT, jJ = jget_or_solve(ks_small)
    for k in ssT.vars:
        assert abs(float(ssT.vars[k]) - float(jssT.vars[k])) <= 1e-10, k
    assert float(np.max(np.abs(J.numpy() - np.asarray(jJ)))) <= 1e-9

    x0 = x_ss_of(tm, ssT)
    x_ref = jax_reference_solution(jJ, {"Z": jexogenousZ(T - 1)}, ks_small, jss0, jssT,
                                   jnp.asarray(x0))
    exog = {"Z": exogenousZ(T - 1)}
    solver = make_path_solver(J, exog, tm, ss0, ssT, method="newton_krylov",
                              direction_dtype=torch.float32, direction_mode="pallas", eps=1e-10,
                              gmres_restart=10)
    x, info = solver(to_torch(x0))
    assert info["residual_norm"] < 1e-10
    assert float(torch.linalg.norm(make_full_residual_fn(tm, ss0, ssT, exog)(x))) < 1e-10
    assert float(np.max(np.abs(x.numpy() - x_ref))) <= 1e-9
    x2, _ = solver(to_torch(x0))
    assert torch.equal(x, x2)

    cached = get_or_solve(tm, cache_dir=str(tmp_path))       # served from disk
    assert torch.equal(cached[2], J) and torch.equal(cached[1].value, ssT.value)
