"""PyTorch port: shared test helpers and the model layer against hank_tpu.

The helpers build the small Krusell-Smith instance (40×5, T=12) in both
packages and carry arrays between them as numpy. Tests here hold the port's
grids, parser, structures and model loader to the JAX package, and check
that the port imports neither jax nor hank_tpu.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hank_tpu_torch.model import grids as tgrids
from hank_tpu_torch.model.structures import HeterogeneityDimension, SteadyStateSpec
from hank_tpu_torch.models import load_model as load_model_torch
from tests.torch_ranks import build_small_two_asset_torch  # noqa: F401  (shared helper)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
f64 = torch.float64


def build_small_ks_torch(T: int, n_a: int = 40, n_e: int = 5, device="cpu"):
    """The port's twin of `tests/conftest.py::build_small_ks`."""
    model = load_model_torch("krusell_smith", T=T, device=device)
    wealth = HeterogeneityDimension(
        name="wealth", dim_type="endogenous", n=n_a,
        grid=torch.tensor(tgrids.make_double_exponential_grid(0.0, 200.0, n_a),
                          dtype=f64, device=device),
        transition=None, policy_var="KD")
    Pi, _, z = tgrids.rouwenhorst(n_e, 0.966, 0.283)
    prod = HeterogeneityDimension(
        name="productivity", dim_type="exogenous", n=n_e,
        grid=torch.tensor(z, dtype=f64, device=device),
        transition=torch.tensor(Pi, dtype=f64, device=device), policy_var=None)
    return dataclasses.replace(model, heterogeneity={"wealth": wealth,
                                                     "productivity": prod})


def ss_to_numpy(ss) -> dict:
    """A hank_tpu SteadyState as the numpy mapping `steady_state_from_numpy` takes."""
    return {"vars": {k: np.asarray(v) for k, v in ss.vars.items()},
            "policies": {k: np.asarray(v) for k, v in ss.policies.items()},
            "D": np.asarray(ss.D), "value": np.asarray(ss.value)}


def to_torch(a, dtype=f64) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype)


def transitory_exog(T: int) -> np.ndarray:
    """The JAX suite's transitory TFP shock Z_t = 1 + 0.1·0.8ᵗ."""
    return 1.0 + 0.1 * 0.8 ** np.arange(1, T, dtype=np.float64)


@pytest.mark.parametrize("n,rho,sigma", [(5, 0.966, 0.283), (7, 0.966, 0.283), (3, 0.5, 0.1)])
def test_rouwenhorst_matches_jax_package(n, rho, sigma):
    from hank_tpu.model import grids as jgrids

    for a, b in zip(tgrids.rouwenhorst(n, rho, sigma), jgrids.rouwenhorst(n, rho, sigma)):
        assert np.max(np.abs(a - b)) <= 1e-12


@pytest.mark.parametrize("n", [40, 200, 500])
def test_double_exponential_grid_matches_jax_package(n):
    from hank_tpu.model import grids as jgrids

    a = tgrids.make_double_exponential_grid(0.0, 200.0, n)
    b = jgrids.make_double_exponential_grid(0.0, 200.0, n)
    assert np.max(np.abs(a - b)) <= 1e-12


def test_ks_model_matches_jax_package():
    from hank_tpu.models import load_model

    jm = load_model("krusell_smith", T=300)
    tm = load_model_torch("krusell_smith", T=300, device="cpu")
    assert tm.var_names() == jm.var_names()
    assert dataclasses.asdict(tm.compspec) == dataclasses.asdict(jm.compspec)
    assert dict(tm.params) == dict(jm.params)
    for ts, js in ((tm.ss_initial, jm.ss_initial), (tm.ss_ending, jm.ss_ending)):
        assert (dict(ts.fixed), dict(ts.guesses), dict(ts.bounds)) == (
            dict(js.fixed), dict(js.guesses), dict(js.bounds))
    for name, jd in jm.heterogeneity.items():
        td = tm.heterogeneity[name]
        assert (td.n, td.dim_type, td.policy_var) == (jd.n, jd.dim_type, jd.policy_var)
        assert np.max(np.abs(td.grid.numpy() - np.asarray(jd.grid))) <= 1e-12
        if jd.transition is not None:
            assert np.max(np.abs(td.transition.numpy() - np.asarray(jd.transition))) <= 1e-12
    assert tm.state_shape() == (200, 7) and tm.compspec.n_endog == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parser_residuals_match_jax_on_random_padded_matrices(seed):
    """The compiled KS residuals, and a set exercising leads, lags and the
    equation functions, on random padded matrices to 1e-14."""
    from hank_tpu.model.parser import compile_residuals as jcompile
    from hank_tpu_torch.model.parser import compile_residuals as tcompile

    rng = np.random.default_rng(seed)
    tm = load_model_torch("krusell_smith", T=10, device="cpu")
    cs = tm.compspec
    x = rng.uniform(0.5, 2.0, size=(cs.n_v, cs.T_pad))
    jm_fn = jcompile(tm.equations, tm.var_names(), set(tm.params))
    out_t = tm.residuals_fn(torch.tensor(x), tm.params).numpy()
    out_j = np.asarray(jm_fn(jnp.asarray(x), tm.params))
    assert out_t.shape == out_j.shape == (cs.n_endog * (cs.T - 1),)
    assert np.max(np.abs(out_t - out_j)) <= 1e-14

    eqs = ["A = log(B(-2)) + exp(C(+1)) * α", "B = sqrt(abs(A(+2))) - max(C, B) ^ 2",
           "C = min(A(-1), tanh(B)) / α"]
    names = ("A", "B", "C")
    xs = rng.uniform(0.5, 2.0, size=(3, 7 + 2 + 2))
    params = {"α": 0.7}
    out_t = tcompile(eqs, names, {"α"})(torch.tensor(xs), params).numpy()
    out_j = np.asarray(jcompile(eqs, names, {"α"})(jnp.asarray(xs), params))
    assert np.max(np.abs(out_t - out_j)) <= 1e-14


def test_detect_max_lag_lead_matches_jax_package():
    from hank_tpu.model.parser import detect_max_lag_lead as jdetect
    from hank_tpu_torch.model.parser import detect_max_lag_lead as tdetect

    eqs = ["Y = K(-3) + C(+2)", "K = Y(+1)", "C = Y"]
    assert tdetect(eqs, ("Y", "K", "C")) == jdetect(eqs, ("Y", "K", "C")) == (3, 2)


def test_structures_compare_tensors_with_torch_equal():
    g = torch.linspace(0.0, 1.0, 5, dtype=f64)
    a = HeterogeneityDimension("w", "endogenous", 5, g, None, "KD")
    b = HeterogeneityDimension("w", "endogenous", 5, g.clone(), None, "KD")
    c = HeterogeneityDimension("w", "endogenous", 5, g + 1e-9, None, "KD")
    assert a == b and a != c
    spec = SteadyStateSpec(fixed={"Z": 1.0}, guesses={"r": 0.01})
    assert spec == SteadyStateSpec(fixed=dict(spec.fixed), guesses=dict(spec.guesses))
    with pytest.raises(ValueError):
        HeterogeneityDimension("e", "exogenous", 5, g, None, None)


@pytest.mark.parametrize("name", ["krusell_smith", "hank_two_asset", "hank_one_asset",
                                  "ks_large_grid"])
def test_yaml_specs_are_byte_identical_copies(name):
    """The port reads its own copies of the shipped specs; they may not
    drift from the JAX package's."""
    from hank_tpu_torch.models import SHIPPED, model_path

    with open(model_path(name), "rb") as a, \
            open(os.path.join(REPO, "hank_tpu", "models", f"{name}.yaml"), "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(model_path(name)) == os.path.join(REPO, "hank_tpu_torch", "models")
    assert set(SHIPPED) == {"krusell_smith", "hank_two_asset", "hank_one_asset",
                            "ks_large_grid"}


@pytest.mark.parametrize("name", ["hank_one_asset", "ks_large_grid"])
def test_one_asset_families_match_jax_package(name):
    from hank_tpu.models import load_model

    jm = load_model(name, T=300)
    tm = load_model_torch(name, T=300, device="cpu")
    assert tm.var_names() == jm.var_names() and tm.name == jm.name
    assert dataclasses.asdict(tm.compspec) == dataclasses.asdict(jm.compspec)
    assert dict(tm.params) == dict(jm.params)
    for name_, jd in jm.heterogeneity.items():
        td = tm.heterogeneity[name_]
        assert (td.n, td.dim_type, td.policy_var) == (jd.n, jd.dim_type, jd.policy_var)
        assert np.max(np.abs(td.grid.numpy() - np.asarray(jd.grid))) <= 1e-12


def test_entry_points_default_to_the_card():
    """Without a device the model loader and the YAML builder target CUDA;
    on a machine without a card that is torch's own error, never a quiet
    CPU model."""
    import inspect

    from hank_tpu_torch.model.parser import build_model_from_yaml
    from hank_tpu_torch.models import load_model

    for fn in (load_model, build_model_from_yaml):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert load_model_torch("krusell_smith", T=5).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            load_model_torch("krusell_smith", T=5)


def test_exogenousZ_matches_jax_and_is_seeded():
    from hank_tpu.models.krusell_smith import exogenousZ as jz
    from hank_tpu_torch.models.krusell_smith import exogenousZ as tz

    assert np.max(np.abs(tz(299).numpy() - np.asarray(jz(299)))) <= 1e-15
    a = tz(50, sigma=0.1, generator=torch.Generator().manual_seed(3))
    b = tz(50, sigma=0.1, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, tz(50))
    with pytest.raises(ValueError):
        tz(50, sigma=0.1)


def test_generate_exog_paths_uses_each_seq_function():
    from hank_tpu.model.structures import generate_exog_paths as jgen
    from hank_tpu.models import load_model
    from hank_tpu_torch.model.structures import generate_exog_paths as tgen

    tm = load_model_torch("krusell_smith", T=40, device="cpu")
    paths = tgen(tm, 39, z_end=1.5)
    assert set(paths) == {"Z"} and paths["Z"].dtype == f64 and paths["Z"].shape == (39,)
    ref = np.asarray(jgen(load_model("krusell_smith", T=40), 39, z_end=1.5)["Z"])
    assert np.max(np.abs(paths["Z"].numpy() - ref)) <= 1e-15


def test_package_imports_neither_jax_nor_hank_tpu():
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import hank_tpu_torch, hank_tpu_torch.ops.fused_residual, "
            "hank_tpu_torch.utils.checkpoint, hank_tpu_torch.models.krusell_smith, "
            "hank_tpu_torch.models.hank_two_asset, hank_tpu_torch.ops.fused_sweep2, "
            "hank_tpu_torch.solvers.linear, hank_tpu_torch.run, "
            "hank_tpu_torch.ops.forward_scan, hank_tpu_torch.utils.timing, "
            "hank_tpu_torch.utils.profiling, hank_tpu_torch.utils.plotting, "
            "hank_tpu_torch.models.hank_one_asset, hank_tpu_torch.models.ks_large_grid, "
            "hank_tpu_torch.tools.kernel6_split, hank_tpu_torch.tools.kernel5_split, "
            "hank_tpu_torch.tools.sweep_ab, hank_tpu_torch.tools.sass_compare, "
            "hank_tpu_torch.parallel.mesh, hank_tpu_torch.parallel.state_sharding, "
            "hank_tpu_torch.parallel.dryrun, hank_tpu_torch.utils.native, tests.torch_ranks\n"
            "for name in ('krusell_smith', 'hank_two_asset', 'hank_one_asset', "
            "'ks_large_grid'):\n"
            "    hank_tpu_torch.load_model(name, T=5, device='cpu')\n"
            "bad = [m for m in set(sys.modules) - before if m == 'jax' "
            "or m.startswith('jax.') or m == 'hank_tpu' or m.startswith('hank_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_a_card():
    """Without a CUDA device the script must exit non-zero and print no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_two_asset_route_has_one_eps():
    """Phase 7 builds every solver with `eps=EPS` and holds every path
    residual to the same constant: the target and the check cannot drift."""
    import inspect
    import re

    import chip_smoke

    src = inspect.getsource(chip_smoke.two_asset_phase)
    assert chip_smoke.EPS == 1e-8
    targets = re.findall(r"\beps=([\w.+-]+)", src)
    checks = re.findall(r"(?:fnorm\w*|\[\"residual_norm\"\])\s*[<>]=?\s*(EPS|[\d.]+e-?\d+)", src)
    assert targets and set(targets) == {"EPS"}
    assert len(checks) >= 3 and set(checks) == {"EPS"}
