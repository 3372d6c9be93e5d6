"""The plain reference against the program's plain pipeline on the CPU, at
test sizes: the small Krusell-Smith economy (40 × 5, T = 12) and the small
two-asset one (24 × 12 × 4 × 2, T = 12). This test imports both sides;
the reference itself imports nothing of the program."""

from __future__ import annotations

import os

import pytest
import torch

from hank_bench import harness, program
from hank_bench.check import reference

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "configs")


@pytest.fixture(scope="module", params=["ks_40x5_T12", "hank2_24x12x4x2_T12"])
def case(request):
    torch.set_num_threads(2)
    config = harness.load_json(FIX, f"{request.param}.json")
    system = program.Program(config, "cpu", program.Spans("cpu"))
    system.set_up()
    return config, system


@pytest.mark.parametrize("config", [os.path.join(FIX, "ks_40x5_T12.json"),
                                    os.path.join(FIX, "hank2_24x12x4x2_T12.json"),
                                    os.path.join(harness.HERE, "configs", "ks_200x7_T300.json")])
def test_the_programs_grids_are_the_references(config):
    """The program builds its own grids from a configuration's numbers;
    they are the arrays the reference builds from the same numbers."""
    from hank_bench.reference.common import make_dimensions

    config = harness.load_json(config)
    model = program.build_model(config, "cpu")
    for name, (grid, transition) in make_dimensions(config).items():
        dim = model.heterogeneity[name]
        assert dim.n == len(grid)
        assert torch.allclose(dim.grid, torch.as_tensor(grid), rtol=1e-13, atol=1e-15), name
        if transition is not None:
            assert torch.allclose(dim.transition, torch.as_tensor(transition),
                                  rtol=1e-13, atol=1e-15), name


def _households(system):
    """The program's own steady-state households, as the reference takes them."""
    return ({"V": system.ss0.value, "D": system.ss0.D},
            {"V": system.ssT.value, "D": system.ssT.D})


def test_the_path_residual_is_the_programs(case):
    """With the program's households, the reference's F is the plain F."""
    from hank_tpu_torch.solvers.newton import make_full_residual_fn

    config, system = case
    eco = reference(config).Economy(config, "cpu")
    var = reference(config).SHOCK
    Tm1 = config["T"] - 1
    t = torch.arange(1, Tm1 + 1, dtype=torch.float64)
    shock = 2.0 - 0.7 ** t if var == "Z" else 0.01 * 0.8 ** t
    F = make_full_residual_fn(system.model, system.ss0, system.ssT, {var: shock})
    gen = torch.Generator().manual_seed(5)
    hh0, hhT = _households(system)
    ss0, ssT = system.steady_state_vars()
    for x in (system.x_ss, system.x_ss * (1 + 1e-3 * torch.randn(system.x_ss.shape,
                                                                   dtype=torch.float64,
                                                                   generator=gen))):
        mine = eco.path_residual(x[None], {var: shock[None]}, ss0, ssT, hh0, hhT)[0]
        theirs = F(x)
        assert float((mine - theirs).abs().max()) <= 1e-12 * max(1.0, float(theirs.abs().max()))


def test_the_households_are_the_programs(case):
    """The reference's own fixed point and distribution at the program's
    steady-state prices sit where the program's do, to the program's
    fixed-point tolerance; so do the steady-state equations."""
    config, system = case
    eco = reference(config).Economy(config, "cpu")
    for ss, vars in zip((system.ss0, system.ssT), system.steady_state_vars()):
        res, hh = eco.steady_state(vars)
        assert float((hh["V"] - ss.value).abs().max()) <= 1e-9 * float(ss.value.abs().max())
        assert float((hh["D"] - ss.D).abs().max()) <= 1e-9
        assert float(res.abs().max()) <= 1e-7


def test_float32_is_far_from_float64(case):
    """The control's precision: the reference in float32 misses the float64
    residual of a path by far more than the program's answers do."""
    config, system = case
    eco = reference(config).Economy(config, "cpu")
    var = reference(config).SHOCK
    shock = torch.zeros(1, config["T"] - 1, dtype=torch.float64) + (1.0 if var == "Z" else 0.0)
    hh0, hhT = _households(system)
    ss0, ssT = system.steady_state_vars()
    r64 = eco.path_residual(system.x_ss[None], {var: shock}, ss0, ssT, hh0, hhT)
    r32 = eco.to(torch.float32).path_residual(system.x_ss[None], {var: shock}, ss0, ssT, hh0, hhT)
    assert float((r32 - r64).norm()) > 1e-7
