"""PyTorch port: one-asset grids past one block's shared memory, on the CPU.

On the card every one-asset kernel map decides by the model's grid, with
the library's shared-memory counts and before any launch, which kernel it
launches (`ops/fused_sweep.sweep_kernel`, recorded as `sweep_setup(...).kernel`):
the one-block kernel where its count fits, else its global-state
instantiation (`household_sweep_ranged_kernel<S, TANGENT, BATCHED, true>`,
whose six state arrays live in a global workspace), and ValueError past
that one's count. Without a card the library cannot count, so the tests
feed `cuda_build.sweep_smem_bytes` a count that puts every one-block kernel
one byte past a block and the transcriptions of
`tests/test_torch_kernel_fit.py` for the global-state ones; the steady
state reports its arrays on the card (`OnCard`) while the wrappers, which
look at the device, run their plain versions.

On the small Krusell-Smith (40×5, T=12, the transitory TFP shock) every
one-asset route under "auto" then builds on the global-state kernels and
solves to the JAX package's root within 1e-9: the default boehl solve (f64
directions, kernel-2 residuals), Newton-Krylov with f32 directions, and a
B=2 ensemble. The `slow` test rebuilds
`hank_tpu_torch/data/ks_large_grid_1200x7_T150_jax_cpu.npz` (large-grid KS
at 1200×7, T=150, the grid past every one-block kernel at n_e = 7) from
`hank_tpu` on the CPU and holds the port's CPU solve to it.
"""

import dataclasses
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hank_tpu_torch.parallel.ensemble as ensemble_mod
import hank_tpu_torch.solvers.newton as newton_mod
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                               fused_residual_sweep_batch,
                                               fused_residual_sweep_batch_global,
                                               fused_residual_sweep_global,
                                               fused_residual_sweep_reference)
from hank_tpu_torch.ops.fused_sweep import (fused_sweep_jvp, fused_sweep_jvp_f64,
                                            fused_sweep_jvp_f64_global, fused_sweep_jvp_global,
                                            fused_sweep_jvp_reference, state_workspace_bytes,
                                            sweep_setup)
from hank_tpu_torch.ops.fused_sweep_batch import fused_sweep_jvp_batch, fused_sweep_jvp_batch_global
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import (REPO, build_small_ks_torch, ss_to_numpy, to_torch,
                                     transitory_exog)
from tests.test_torch_kernel_fit import BYTES, on_card, past_one_block  # noqa: F401 (fixture)
from tests.test_torch_solve import x_ss_of

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64

# Large-grid KS past every one-block kernel's shared memory at n_e = 7.
LARGE_GRID = ("ks_large_grid", 1200, 150)
LARGE_GRID_FILE = os.path.join(REPO, "hank_tpu_torch", "data",
                               "ks_large_grid_1200x7_T150_jax_cpu.npz")


class Case:
    def __init__(self, jm, jss):
        from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian

        T = jm.compspec.T
        self.jm, self.jss = jm, jss
        self.tm = build_small_ks_torch(T=T)
        self.tss = steady_state_from_numpy(ss_to_numpy(jss), device="cpu")
        self.card = on_card(self.tss)
        self.z = transitory_exog(T)
        self.exog = {"Z": to_torch(self.z)}
        self.x_ss = x_ss_of(jm, jss)
        self.J = np.asarray(get_steady_state_jacobian(jss, jm))

    def jax_root(self, z) -> np.ndarray:
        """The JAX package's root under the shock path z, eps 1e-11."""
        from hank_tpu.solvers.newton import make_path_solver

        x, info = make_path_solver(jnp.asarray(self.J), {"Z": jnp.asarray(z)}, self.jm,
                                   self.jss, self.jss, method="boehl",
                                   eps=1e-11)(jnp.asarray(self.x_ss))
        assert float(info["residual_norm"]) < 1e-11
        return np.asarray(x)


@pytest.fixture(scope="module")
def ks(ks_small, ks_small_ss):
    case = Case(ks_small, ks_small_ss)
    case.root = case.jax_root(case.z)
    return case


@pytest.mark.parametrize("which", sorted(cuda_build.GLOBAL_STATE))
def test_sweep_setup_records_the_kernel_it_launches(ks, past_one_block, monkeypatch, which):
    """Past one block the map records the global-state instantiation, on
    CPU tensors nothing, and where the one-block kernel fits, that one."""
    dtype = f32 if which in (cuda_build.KERNEL1, cuda_build.KERNELS3_4) else f64
    assert sweep_setup(ks.tm, ks.card, ks.card, dtype, which).kernel == \
        cuda_build.GLOBAL_STATE[which]
    assert past_one_block == [which, cuda_build.GLOBAL_STATE[which]]
    assert sweep_setup(ks.tm, ks.tss, ks.tss, dtype, which).kernel is None
    assert sweep_setup(ks.tm, ks.card, ks.card, dtype).kernel is None
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", lambda w, n_a, n_e: BYTES[w](n_a, n_e))
    assert sweep_setup(ks.tm, ks.card, ks.card, dtype, which).kernel == which


@pytest.mark.parametrize("method,direction_dtype", [("boehl", None), ("newton_krylov", f32)])
def test_solves_past_one_block_take_the_global_state_kernels(ks, past_one_block, method,
                                                             direction_dtype):
    """The default (f64 directions, boehl) and Newton-Krylov with f32
    directions, under "auto" with the steady state on the card: the solver
    builds on the global-state kernels (their plain versions here), takes
    no AD direction, and reaches the JAX package's root within 1e-9."""
    calls = (fused_sweep_jvp_reference.calls, fused_residual_sweep_reference.calls,
             newton_mod.ad_direction.calls)
    x, info = newton_mod.make_path_solver(
        to_torch(ks.J), ks.exog, ks.tm, ks.card, ks.card, method=method,
        direction_dtype=direction_dtype, eps=1e-10)(to_torch(ks.x_ss))
    assert info["residual_norm"] < 1e-10
    expected = {cuda_build.GLOBAL_KERNEL2,
                cuda_build.GLOBAL_KERNEL1 if direction_dtype == f32
                else cuda_build.GLOBAL_JVP_F64}
    assert {w for w in past_one_block if w >= cuda_build.GLOBAL_KERNEL1} == expected
    assert fused_sweep_jvp_reference.calls > calls[0]
    assert fused_residual_sweep_reference.calls > calls[1]
    assert newton_mod.ad_direction.calls == calls[2]
    assert float(np.max(np.abs(x.numpy() - ks.root))) <= 1e-9


def test_ensemble_past_one_block_takes_the_global_state_kernels(ks, past_one_block):
    """A B=2 Newton-Krylov ensemble (f32 directions) under "auto" with the
    steady state on the card builds on the batched global-state kernels
    (their plain versions here); each row reaches the JAX package's root of
    its own shock within 1e-9."""
    T = ks.tm.compspec.T
    t = np.arange(1, T, dtype=np.float64)
    shocks = [1.0 + 0.1 * rho ** t for rho in (0.6, 0.8)]
    exog_b = {"Z": torch.tensor(np.stack(shocks), dtype=f64)}
    x, info = ensemble_mod.solve_ensemble_host(to_torch(ks.x_ss), to_torch(ks.J), exog_b,
                                               ks.tm, ks.card, ks.card, eps=1e-10,
                                               method="newton_krylov")
    assert float(info["residual_norm"].max()) < 1e-10
    assert {w for w in past_one_block if w >= cuda_build.GLOBAL_KERNEL1} == \
        {cuda_build.GLOBAL_KERNELS3_4, cuda_build.GLOBAL_KERNEL2}
    for b, z in enumerate(shocks):
        root = ks.root if b == 1 else ks.jax_root(z)
        assert float(np.max(np.abs(x[b].numpy() - root))) <= 1e-9


@pytest.mark.parametrize("dtype,tangent,B", [(f32, True, 1), (f32, True, 64), (f64, False, 1),
                                             (f64, False, 16), (f64, True, 1)])
def test_state_workspace_is_six_or_three_states_a_path(dtype, tangent, B):
    n_a, n_e = 1200, 7
    size = 4 if dtype == f32 else 8
    assert state_workspace_bytes(dtype, tangent, n_a, n_e, B) == \
        size * (6 if tangent else 3) * n_a * n_e * B


@pytest.mark.parametrize("entry,wrapper,dtype,n_paths,batched", [
    (fused_sweep_jvp_global, fused_sweep_jvp, f32, 4, False),
    (fused_sweep_jvp_batch_global, fused_sweep_jvp_batch, f32, 4, True),
    (fused_residual_sweep_global, fused_residual_sweep, f64, 2, False),
    (fused_residual_sweep_batch_global, fused_residual_sweep_batch, f64, 2, True),
    (fused_sweep_jvp_f64_global, fused_sweep_jvp_f64, f64, 4, False)])
def test_global_state_entry_points_refuse_cpu_tensors(entry, wrapper, dtype, n_paths, batched):
    """The `_global` entry points launch their instantiation or raise: on
    CPU tensors ValueError naming the wrapper's plain version, and no
    launch is counted."""
    n_a, n_e, Tm1 = 6, 3, 4
    paths = [torch.zeros((2, Tm1) if batched else (Tm1,), dtype=dtype) for _ in range(n_paths)]
    states = [torch.ones(n_a, n_e, dtype=dtype),
              torch.full((n_a, n_e), 1 / (n_a * n_e), dtype=dtype),
              torch.linspace(0, 1, n_a, dtype=dtype), torch.ones(n_e, dtype=dtype),
              torch.eye(n_e, dtype=dtype)]
    counts = (wrapper.launches, wrapper.launches_global)
    with pytest.raises(ValueError, match="card only.*_reference is the plain version"):
        entry(*paths, *states, beta=0.98, gamma=2.0, borrow_cons=0.0)
    assert (wrapper.launches, wrapper.launches_global) == counts


# ── 1200×7, T=150 ──────────────────────────────────────────────────────────

def large_grid(model, n_a, device=None):
    """`model` (either package's) with `n_a` knots on its wealth grid, the
    family's double-exponential grid on [0, 200]."""
    wealth = model.endog_dims()[0]
    grid = np.asarray(_grid(n_a))
    grid = jnp.asarray(grid) if device is None else torch.tensor(grid, dtype=f64, device=device)
    return dataclasses.replace(model, heterogeneity={
        **model.heterogeneity, wealth.name: dataclasses.replace(wealth, n=n_a, grid=grid)})


def _grid(n_a):
    from hank_tpu_torch.model.grids import make_double_exponential_grid

    return make_double_exponential_grid(0.0, 200.0, n_a)


def jax_cpu_root_large_grid() -> tuple[dict, dict]:
    """The recipe of `LARGE_GRID_FILE`: `hank_tpu` on a CPU, large-grid KS
    at 1200×7, T=150 (the shipped model with 1200 wealth knots), its own
    shock from `generate_exog_paths`, solved by Newton-Krylov with f32
    directions to eps 1e-10 from the steady-state path, as
    `tests/test_torch_one_asset_families.py::jax_cpu_root` solves the
    shipped families. Returns the arrays the file holds, and the initial
    and ending steady states as `steady_state_from_numpy` takes them."""
    from hank_tpu.model.structures import generate_exog_paths
    from hank_tpu.models import load_model
    from hank_tpu.solvers.newton import make_path_solver
    from hank_tpu.utils.checkpoint import get_or_solve

    name, n_a, T = LARGE_GRID
    model = large_grid(load_model(name, T=T), n_a)
    ss0, ssT, Jbar = get_or_solve(model)
    exog = generate_exog_paths(model, T - 1)
    endog = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ssT.vars[k] for k in endog]), T - 1)
    x, info = make_path_solver(Jbar, exog, model, ss0, ssT, method="newton_krylov",
                               direction_dtype=jnp.float32, eps=1e-10)(x0)
    names = list(model.var_names())
    arrays = {"var_names": np.array(names),
              "var_values": np.array([float(ssT.vars[k]) for k in names]),
              "x": np.asarray(x), "residual_norm": np.array(float(info["residual_norm"]))}
    return arrays, {"initial": ss_to_numpy(ss0), "ending": ss_to_numpy(ssT)}


@pytest.mark.slow
def test_shipped_large_grid_root_is_rebuilt_and_the_port_solves_to_it():
    """The shipped 1200×7 root is the recipe's, and the port's CPU solve
    (`run.solve_model`, f32-direction Newton-Krylov to eps 1e-10, plain
    versions) reaches it within 1e-7 (phase 8's bound on the card). The
    port starts from the recipe's steady states, put in its cache (its own
    eager CPU steady state at 1200×7 takes tens of minutes on one
    thread); J̄ and the path solve are the port's."""
    from hank_tpu_torch import run
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.utils.checkpoint import save_steady_state

    ref, steady_states = jax_cpu_root_large_grid()
    assert float(ref["residual_norm"]) < 1e-10
    with np.load(LARGE_GRID_FILE) as z:
        assert list(z["var_names"]) == list(ref["var_names"])
        assert np.max(np.abs(z["var_values"] - ref["var_values"])) <= 1e-10
        assert np.max(np.abs(z["x"] - ref["x"])) <= 1e-9
        x_jax = z["x"]
    name, n_a, T = LARGE_GRID
    model = large_grid(load_model(name, T=T, device="cpu"), n_a, device="cpu")
    with tempfile.TemporaryDirectory() as cache:
        os.environ["HANK_TPU_TORCH_CACHE"] = cache
        try:
            for label, ss in steady_states.items():
                save_steady_state(steady_state_from_numpy(ss, device="cpu"), model, label)
            x, info, _, _ = run.solve_model(model, method="newton_krylov",
                                            direction_dtype=f32, eps=1e-10, verbose=False)
        finally:
            os.environ.pop("HANK_TPU_TORCH_CACHE")
    assert info["residual_norm"] < 1e-10
    assert np.max(np.abs(np.asarray(x).reshape(-1) - x_jax)) <= 1e-7
