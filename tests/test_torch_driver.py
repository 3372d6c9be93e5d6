"""PyTorch port: the driver (`hank_tpu_torch/run.py`) and `utils/` against
hank_tpu.

The first tests mirror `tests/test_run.py` on the small Krusell-Smith
(40×5, T=12) on the CPU; the port's artifact cache is a temporary directory
seeded with the JAX package's steady states and J̄ (carried across with
`steady_state_from_numpy`), so the driver's own path is what is tested.
Then: the argument checks the reference lacks (ADVICE.md), `solve_path_dense`,
the CLI, the timing and profiling helpers, `distribution_path` and the plots.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.run import _accept_warm_start, main, solve_model
from hank_tpu_torch.utils import checkpoint
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import build_small_ks_torch, ss_to_numpy, to_torch

torch.set_num_threads(1)
f64 = torch.float64


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """A port artifact cache seeded with the JAX package's small-KS steady
    states and J̄, and with its one-asset HANK (50×7, T=12) ones."""
    from hank_tpu.models import load_model
    from hank_tpu.utils.checkpoint import get_or_solve as jget_or_solve
    from hank_tpu_torch.models import load_model as tload
    from tests.conftest import build_small_ks

    d = str(tmp_path_factory.mktemp("port_cache"))
    for jm, tm in ((build_small_ks(T=12), build_small_ks_torch(T=12)),
                   (load_model("hank_one_asset", T=12),
                    tload("hank_one_asset", T=12, device="cpu"))):
        ss0, ssT, J = jget_or_solve(jm)
        for label, ss in (("initial", ss0), ("ending", ssT)):
            checkpoint.save_steady_state(steady_state_from_numpy(ss_to_numpy(ss), device="cpu"), tm,
                                         label, d)
        checkpoint.save_jacobian(to_torch(np.asarray(J)), tm, d)
    return d


@pytest.fixture(scope="module")
def ks(cache_dir):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(checkpoint, "default_cache_dir", lambda: cache_dir)
        yield build_small_ks_torch(T=12)


@pytest.fixture(scope="module")
def solved(ks):
    """`solve_model` with its defaults from the steady-state path."""
    return solve_model(ks, verbose=False)


def test_solve_model_end_to_end(ks, solved):
    x, info, ss0, ssT = solved
    Tm1 = ks.compspec.T - 1
    endog = ks.vars_of_type("endogenous")
    assert isinstance(x, np.ndarray) and x.shape == (Tm1, len(endog))
    assert float(info["residual_norm"]) < 1e-8
    iY = endog.index("Y")
    assert abs(float(ss0.vars["Y"]) - float(ssT.vars["Y"])) > 0.1
    assert abs(x[-1, iY] - float(ssT.vars["Y"])) < abs(x[0, iY] - float(ssT.vars["Y"]))


def test_solve_model_matches_jax_driver(solved, ks_small):
    from hank_tpu.run import solve_model as jsolve_model

    x, info, *_ = solved
    xj, ij, *_ = jsolve_model(ks_small, verbose=False)
    assert int(info["iterations"]) == int(ij["iterations"])
    assert float(np.max(np.abs(x - np.asarray(xj)))) <= 1e-9


def test_warm_start_linear_agrees_with_ss_start(ks, solved):
    x_ss, i_ss, *_ = solved
    x_lin, i_lin, *_ = solve_model(ks, verbose=False, warm_start="linear")
    assert float(i_ss["residual_norm"]) < 1e-8 and float(i_lin["residual_norm"]) < 1e-8
    np.testing.assert_allclose(x_lin, x_ss, atol=1e-6)
    assert int(i_lin["iterations"]) <= int(i_ss["iterations"]) + 1


def test_warm_start_rejects_unknown(ks):
    with pytest.raises(ValueError, match="warm_start"):
        solve_model(ks, verbose=False, warm_start="banana")


def test_warm_start_guard_rejects_bad_linear_step():
    x_ss, x_lin = torch.zeros(4), torch.ones(4)
    ok = {"residual_norm": 1e-3, "f0_norm": 1.0}
    assert _accept_warm_start(x_ss, x_lin, ok, False) is x_lin
    nan = {"residual_norm": float("nan"), "f0_norm": 1.0}
    assert _accept_warm_start(x_ss, x_lin, nan, False) is x_ss
    worse = {"residual_norm": 2.0, "f0_norm": 1.0}
    assert _accept_warm_start(x_ss, x_lin, worse, False) is x_ss


def test_method_linear_first_order_quality(ks, solved):
    x_lin, info, ss0, ssT = solve_model(ks, verbose=False, method="linear")
    x_nl = solved[0]
    Tm1 = ks.compspec.T - 1
    endog = ks.vars_of_type("endogenous")
    assert x_lin.shape == (Tm1, len(endog))
    assert float(info["residual_norm"]) < float(info["f0_norm"])
    x_sspath = np.tile([float(ssT.vars[k]) for k in endog], (Tm1, 1))
    assert float(np.max(np.abs(x_lin - x_nl))) < float(np.max(np.abs(x_sspath - x_nl)))


@pytest.mark.parametrize("method", ["linear", "dense"])
@pytest.mark.parametrize("kw", [dict(warm_start="linear"), dict(host_inner=True),
                                dict(richardson_max_outer=0)])
def test_non_iterative_methods_refuse_solver_options(ks, method, kw):
    """ADVICE.md:4: the reference drops these silently on the linear and
    dense branches; the port refuses them before it solves anything."""
    with pytest.raises(ValueError, match="iterative solvers"):
        solve_model(ks, verbose=False, method=method, **kw)


def test_unknown_method_is_refused_before_setup(ks, monkeypatch):
    monkeypatch.setattr(checkpoint, "get_or_solve", None)       # never reached
    with pytest.raises(ValueError, match="method"):
        solve_model(ks, verbose=False, method="bisection")


def test_solve_path_dense_matches_jax(ks, ks_small):
    from hank_tpu.solvers.newton import solve_path_dense as jdense
    from hank_tpu.utils.checkpoint import get_or_solve as jget_or_solve
    from hank_tpu_torch.models.krusell_smith import exogenousZ
    from hank_tpu_torch.solvers.newton import solve_path_dense

    jss0, jssT, _ = jget_or_solve(ks_small)
    ss0 = steady_state_from_numpy(ss_to_numpy(jss0), device="cpu")
    ssT = steady_state_from_numpy(ss_to_numpy(jssT), device="cpu")
    endog = ks.vars_of_type("endogenous")
    x0 = np.tile([float(jssT.vars[k]) for k in endog], 11)
    z = exogenousZ(11)
    xj, ij = jdense(jnp.asarray(x0), {"Z": jnp.asarray(z.numpy())}, ks_small, jss0, jssT)
    x, info = solve_path_dense(to_torch(x0), {"Z": z}, ks, ss0, ssT)
    assert info["iterations"] == int(ij["iterations"]) and info["residual_norm"] < 1e-9
    assert float(np.max(np.abs(x.numpy() - np.asarray(xj)))) <= 1e-9
    xd, idd, *_ = solve_model(ks, verbose=False, method="dense")
    assert float(np.max(np.abs(xd.reshape(-1) - x.numpy()))) <= 1e-12


def printed_json(out: str) -> dict:
    """The indented JSON summary among a CLI run's progress lines."""
    return json.loads(out[out.index("{\n"):out.rindex("}") + 1])


def test_cli_writes_the_path_and_the_jax_summary(cache_dir, tmp_path, monkeypatch, capsys):
    from hank_tpu.run import main as jmain

    monkeypatch.setattr(checkpoint, "default_cache_dir", lambda: cache_dir)
    out = tmp_path / "path.csv"
    summary = main(["--model", "hank_one_asset", "--T", "12", "--device", "cpu",
                    "--out", str(out)])
    assert printed_json(capsys.readouterr().out) == summary
    jmain(["--model", "hank_one_asset", "--T", "12"])
    jsummary = printed_json(capsys.readouterr().out)
    assert set(summary) == set(jsummary)
    assert (summary["model"], summary["T"], summary["method"]) == (
        jsummary["model"], 12, "newton_krylov")
    assert summary["residual_norm"] < 1e-8 and summary["iterations"] == jsummary["iterations"]
    for part in ("impact", "terminal"):
        assert set(summary[part]) == {"pi", "i", "r"}
        for k, v in summary[part].items():
            assert abs(v - jsummary[part][k]) <= 1e-9, (part, k)
    lines = out.read_text().splitlines()
    assert lines[0] == "t,pi,i,r" and len(lines) == 12
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    assert rows.shape == (11, 4) and list(rows[:, 0]) == list(range(1, 12))
    assert abs(rows[0, 1] - summary["impact"]["pi"]) <= 1e-15


def test_phase_records_and_timeit():
    from hank_tpu_torch.utils.timing import block, phase, timeit

    records = []
    with phase("work", records, verbose=False):
        torch.ones(3).sum()
    assert len(records) == 1 and records[0]["phase"] == "work"
    assert records[0]["seconds"] >= 0.0
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), 3]}
    assert block(tree) is tree
    calls = []
    assert timeit(lambda: calls.append(1), warmup=2, iters=3) >= 0.0
    assert len(calls) == 5


def test_solve_breakdown_has_the_jax_keys(ks_small, ks_small_ss):
    from hank_tpu_torch.utils.profiling import solve_breakdown

    tm = build_small_ks_torch(T=12)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    exog = {"Z": torch.ones(11, dtype=f64)}
    J = torch.eye(44, dtype=f64)
    out = solve_breakdown(tm, tss, tss, J, exog, iters=1)
    assert set(out) == {"residual_F_seconds", "jvp_sweep_seconds", "precond_solve_seconds",
                        "backward_scan_seconds", "forward_scan_seconds"}
    assert all(v >= 0.0 for v in out.values())
    out32 = solve_breakdown(tm, tss, tss, J, exog, direction_dtype=torch.float32, iters=1)
    assert set(out32) == set(out)


def test_trace_writes_a_chrome_trace(tmp_path):
    from hank_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path)) as prof:
        torch.ones(8).cumsum(0)
    assert (tmp_path / "trace.json").exists() and prof.key_averages()


def test_distribution_path_matches_jax(ks_small, ks_small_ss):
    from hank_tpu.blocks.backward import backward_iteration as jback
    from hank_tpu.blocks.forward import distribution_path as jdist
    from hank_tpu_torch.blocks.forward import distribution_path

    endog = ks_small.vars_of_type("endogenous")
    x = np.tile([float(ks_small_ss.vars[k]) for k in endog], 11)
    x = x * (1.0 + 1e-3 * np.random.default_rng(0).normal(size=x.shape))
    z = {"Z": jnp.asarray(1.0 + 0.1 * 0.8 ** np.arange(1, 12))}
    pols = jback(jnp.asarray(x), z, ks_small, ks_small_ss.vars, ks_small_ss.value)
    ref = np.asarray(jdist(pols, ks_small, ks_small_ss.D))
    tm = build_small_ks_torch(T=12)
    out = distribution_path({k: to_torch(v) for k, v in pols.items()}, tm,
                            to_torch(ks_small_ss.D))
    assert out.shape == (12, 40, 5) == ref.shape
    assert float(np.max(np.abs(out.numpy() - ref))) <= 1e-13


def test_plots_are_written(ks_small_ss, tmp_path):
    pytest.importorskip("matplotlib")
    from hank_tpu_torch.utils.plotting import plot_distribution, plot_transition

    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    x = torch.ones((11, 4), dtype=f64)
    p1 = plot_transition(x, ("Y", "KS", "r", "w"), str(tmp_path / "t.png"),
                         ss_initial=tss, ss_ending=tss, title="KS")
    Ds = torch.stack([tss.D] * 5)
    p2 = plot_distribution(Ds, torch.linspace(0, 200, 40, dtype=f64),
                           str(tmp_path / "d.png"), every=2, title="D")
    for p in (p1, p2):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
