"""PyTorch port: the dp mesh over torch.distributed against the unmeshed port
and against hank_tpu.

Ranks are new processes (`spawn_ranks`, gloo on the CPU, rank bodies in
`tests/torch_ranks.py`) on the small Krusell-Smith (40×5, T=12) with the JAX
steady state and J̄ carried across. B = 4 shock paths Z_b,t = 1 + 0.05·ρ_bᵗ
split over 2 ranks: `residual_ensemble` bit for bit the unmeshed one and
within 1e-12 of JAX's F per path; both ensemble methods with the unmeshed
solve's outer and sweep counts, rows within 1e-9 of it, one row within 1e-7
of hank_tpu's single-path solve (`tests/test_sharding.py:52-79`); J̄ with
its seeds over 2 ranks within 1e-12 of the unmeshed and of JAX's
(`tests/test_sharded_jacobian.py:25`). One rank gives the unmeshed bits.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.parallel.dryrun import spawn_ranks
from hank_tpu_torch.parallel.ensemble import residual_ensemble, solve_ensemble
from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests import torch_ranks
from tests.test_torch_common import REPO, build_small_ks_torch, ss_to_numpy, to_torch

torch.set_num_threads(1)
B = 4
METHODS = ("newton_krylov", "boehl")
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def setup(ks_small, ks_small_ss):
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

    T = ks_small.compspec.T
    t = np.arange(1, T, dtype=np.float64)
    rhos = 0.5 + 0.4 * np.arange(B) / B
    Z = 1.0 + 0.05 * rhos[:, None] ** t[None, :]
    endog = ks_small.vars_of_type("endogenous")
    x0 = np.tile(np.array([float(ks_small_ss.vars[k]) for k in endog]), T - 1)
    x_b = x0[None, :] * (1.0 + 0.01 * np.random.default_rng(0).standard_normal((B, x0.size)))
    J = np.asarray(jjac(ks_small_ss, ks_small))
    return dict(ss_np=ss_to_numpy(ks_small_ss), J=J, x0=x0, Z=Z, x_b=x_b)


@pytest.fixture(scope="module")
def unmeshed(setup):
    """The port without a mesh, in this process."""
    tm = build_small_ks_torch(T=12)
    tss = steady_state_from_numpy(setup["ss_np"], device="cpu")
    exog = {"Z": to_torch(setup["Z"])}
    out = {"residual": residual_ensemble(to_torch(setup["x_b"]), exog, tm, tss, tss),
           "jacobian": get_steady_state_jacobian(tss, tm)}
    for method in METHODS:
        records = []
        x, info = solve_ensemble(to_torch(setup["x0"]), to_torch(setup["J"]), exog, tm, tss, tss,
                                 method=method, eps=1e-9, records=records)
        out[method] = (x, info, records)
    return out


def _spawn(fn, n, setup):
    return spawn_ranks(fn, n, setup["ss_np"], setup["J"], setup["x0"], setup["Z"],
                       setup["x_b"], device="cpu", timeout=TIMEOUT_S)


@pytest.fixture(scope="module")
def two_ranks(setup):
    return _spawn(torch_ranks.mesh_rank, 2, setup)


@pytest.fixture(scope="module")
def one_rank(setup):
    return _spawn(torch_ranks.mesh_rank, 1, setup)[0]


def test_make_mesh_shapes_and_row_round_trip(two_ranks):
    for rank, out in enumerate(two_ranks):
        assert out["shape"] == (2,) and out["names"] == ("dp",)
        assert out["shape_2d"] == (1, 2) and out["names_2d"] == ("dp", "state")
        assert out["local_rank"] == rank
        assert out["round_trip"] and out["odd_rows_raise"]
        rows = torch.arange(12, dtype=torch.float64).reshape(4, 3)
        assert torch.equal(out["shard"], rows[2 * rank:2 * rank + 2])


def test_make_mesh_on_four_ranks_and_jacobian_mesh_must_divide_n_endog(setup):
    outs = spawn_ranks(torch_ranks.mesh_rank_subsets, 4, setup["ss_np"], device="cpu",
                       timeout=TIMEOUT_S)
    assert [o["shape_2d"] for o in outs] == [(2, 2)] * 4
    assert [o["coordinate_2d"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [o["in_mesh3"] for o in outs] == [True, True, True, False]
    assert all(o["mesh3_raises"] for o in outs[:3])


def test_meshed_residual_ensemble_matches_unmeshed_bits_and_jax(ks_small, ks_small_ss, setup,
                                                                 unmeshed, two_ranks):
    from hank_tpu.solvers.newton import make_full_residual_fn

    for out in two_ranks:
        assert torch.equal(out["residual"], unmeshed["residual"])
    for b in range(B):
        F = make_full_residual_fn(ks_small, ks_small_ss, ks_small_ss,
                                  {"Z": jnp.asarray(setup["Z"][b])})
        ref = np.asarray(F(jnp.asarray(setup["x_b"][b])))
        assert float(np.max(np.abs(two_ranks[0]["residual"][b].numpy() - ref))) <= 1e-12


@pytest.mark.parametrize("method", METHODS)
def test_meshed_solve_takes_the_unmeshed_schedule(method, unmeshed, two_ranks):
    x_u, info_u, rec_u = unmeshed[method]
    for out in two_ranks:
        x, info, records = out[method]
        assert x.shape == x_u.shape
        assert (info["iterations"], info["inner_iterations"]) == (
            info_u["iterations"], info_u["inner_iterations"])
        assert bool((info["residual_norm"] <= 1e-9).all()) and info["stalled_paths"] == 0
        assert float((x - x_u).abs().max()) <= 1e-9
        assert len(records) == len(rec_u) and records[-1]["converged"] == B
        assert [r.get("matvecs", r.get("inner_sweeps")) for r in records] == [
            r.get("matvecs", r.get("inner_sweeps")) for r in rec_u]
    assert torch.equal(two_ranks[0][method][0], two_ranks[1][method][0])


def test_meshed_solve_row_matches_jax_single_path(ks_small, ks_small_ss, setup, two_ranks):
    from hank_tpu.solvers.newton import newton_raphson_hank

    x_one, _ = newton_raphson_hank(jnp.asarray(setup["x0"]), jnp.asarray(setup["J"]),
                                   {"Z": jnp.asarray(setup["Z"][2])}, ks_small, ks_small_ss,
                                   ks_small_ss, method="boehl", eps=1e-9,
                                   direction_dtype=jnp.float32, direction_mode="xla")
    for method in METHODS:
        x = two_ranks[0][method][0]
        assert float(np.max(np.abs(x[2].numpy() - np.asarray(x_one)))) <= 1e-7


def test_meshed_jacobian_matches_unmeshed_and_jax(setup, unmeshed, two_ranks):
    for out in two_ranks:
        assert float((out["jacobian"] - unmeshed["jacobian"]).abs().max()) <= 1e-12
        assert float(np.max(np.abs(out["jacobian"].numpy() - setup["J"]))) <= 1e-12


def test_one_rank_mesh_gives_the_unmeshed_bits(unmeshed, one_rank):
    assert one_rank["shape"] == (1,) and one_rank["shape_2d"] == (1, 1)
    assert torch.equal(one_rank["residual"], unmeshed["residual"])
    assert torch.equal(one_rank["jacobian"], unmeshed["jacobian"])
    for method in METHODS:
        x, info, records = one_rank[method]
        x_u, info_u, rec_u = unmeshed[method]
        assert torch.equal(x, x_u) and torch.equal(info["residual_norm"], info_u["residual_norm"])
        assert {k: v for k, v in info.items() if k not in ("residual_norm", "host_ls_seconds")} \
            == {k: v for k, v in info_u.items() if k not in ("residual_norm", "host_ls_seconds")}
        assert records == rec_u


def test_init_distributed_without_a_launcher_is_one_rank_and_never_falls_back(tmp_path):
    """With no RANK/WORLD_SIZE, a one-rank group from a FileStore in a
    temporary directory, which `destroy_distributed` removes; a card rank on a
    machine without CUDA raises instead of taking the CPU."""
    code = ("import os, tempfile, torch, torch.distributed as dist\n"
            "from hank_tpu_torch.parallel.mesh import (destroy_distributed, gather_rows,\n"
            "                                          init_distributed, make_mesh)\n"
            "if not torch.cuda.is_available():\n"
            "    try:\n"
            "        init_distributed()\n"
            "        raise SystemExit('a card rank started without CUDA')\n"
            "    except RuntimeError:\n"
            "        pass\n"
            "    assert not dist.is_initialized()\n"
            "dev = init_distributed('cpu')\n"
            "assert dev == torch.device('cpu') and dist.get_world_size() == 1\n"
            "assert dist.get_backend() == 'gloo'\n"
            "mesh = make_mesh()\n"
            "t = torch.arange(6.0).reshape(3, 2)\n"
            "assert mesh.shape == (1,) and torch.equal(gather_rows(t, mesh), t)\n"
            "assert len(os.listdir(tempfile.gettempdir())) == 1\n"
            "destroy_distributed()\n"
            "assert not dist.is_initialized()\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert list(tmp_path.iterdir()) == []
