"""The traffic generator's draws, the metrics' arithmetic and the frozen
work counts."""

from __future__ import annotations

import statistics
import types

import numpy as np
import pytest
import torch

from hank_bench import harness, tracing, yardstick
from hank_bench.traffic import Traffic


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def _mix(bench, cell):
    return harness.find_cell(bench, cell)[2]


@pytest.mark.parametrize("cell", ["ks_200x7_T300.solve_f32", "ks_200x7_T300.ensemble_b256_f32"])
def test_draws_repeat_for_a_seed_and_differ_across_seeds(bench, cell):
    mix = _mix(bench, cell)
    var, seed = mix["shock"]["var"], 2**31 + 977
    a, b, c = ([t.request(i)[0][var] for i in range(12)]
               for t in (Traffic(mix, 300, s) for s in (seed, seed, seed + 1)))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert a[0].shape == (mix["batch"], 299)
    warm = [Traffic(mix, 300, s).request(0, warm=True)[0] for s in (1, 2)]
    assert np.array_equal(warm[0][mix["shock"]["var"]], warm[1][mix["shock"]["var"]])


def test_stratified_draws_cover_every_slice():
    mix = {"kind": "single_path", "batch": 1, "strata": 8,
           "shock": {"var": "Z", "level": 2.0, "scale": -1.0, "rho": [0.5, 0.9]}}
    for seed in (3, 2**33 + 5):
        t = Traffic(mix, 10, seed)
        rho = np.array([t.request(i)[1]["rho"][0] for i in range(8)])
        assert sorted(np.floor((rho - 0.5) / 0.05).astype(int)) == list(range(8))
        X = t.request(0)[0]["Z"][0]
        assert np.allclose(X, 2.0 - rho[0] ** np.arange(1, 10))


def test_rate_and_p90():
    reqs = [{"start": i, "end": i + 0.1 * (1 + i % 10), "paths": 2, "solved": 2 - (i == 3)}
            for i in range(40)]
    run = types.SimpleNamespace(requests=reqs, solved=sum(r["solved"] for r in reqs),
                                window_s=40.7)
    assert harness.metric_reader("paths_per_s").read(run) == pytest.approx(79 / 40.7)
    times = [r["end"] - r["start"] for r in reqs]
    assert harness.metric_reader("solve_p90_s").read(run) == \
        pytest.approx(statistics.quantiles(times, n=10)[8])
    assert harness.metric_reader("solve_p90_s").read(
        types.SimpleNamespace(requests=reqs[:9])) is None


class FakeTrace(tracing.Trace):
    """A trace from (name, start_ns, end_ns) device operations and spans."""

    def __init__(self, ops, spans, start, end):
        self.ops = [(n, max(s, start), min(e, end)) for n, s, e in ops]
        self.spans, self.start, self.end = spans, start, end
        self.busy = tracing.merge((s, e) for _, s, e in self.ops)


def test_busy_idle_gaps_and_host_time():
    k1 = "void (anonymous namespace)::household_sweep_jvp_kernel(float const*, int)"
    ops = [(k1, 100, 300), (k1, 250, 400), ("Memcpy DtoH", 600, 700), (k1, 900, 1000)]
    spans = [("request", 120, 450), ("solve", 130, 440),
             ("request", 460, 1000), ("build", 460, 600), ("solve", 600, 705),
             ("fetch", 705, 1000)]
    tr = FakeTrace(ops, spans, 0, 1000)
    assert tr.busy == [[100, 400], [600, 700], [900, 1000]]
    assert tr.busy_s == pytest.approx(500e-9)
    assert tr.idle_gaps() == [["fetch", pytest.approx(200e-9)], ["build", pytest.approx(200e-9)],
                              ["between requests", pytest.approx(100e-9)]]
    assert tr.kernel(tracing.kernel_matcher("household_sweep_jvp_kernel")) == \
        (3, pytest.approx(450e-9))
    run = types.SimpleNamespace(trace=tr, traced_solved=2, solved=4, window_s=2000e-9)
    assert harness.metric_reader("device.idle_share").read(run) == \
        pytest.approx(100 * (1 - 250e-9 * 4 / 2000e-9))
    assert harness.metric_reader("newton.host_s_per_path").read(run) == \
        pytest.approx(500e-9 - 250e-9)


def test_kernel_names_match_in_both_forms():
    m = tracing.kernel_matcher("household_sweep_ranged_kernel", ("double", "false", "false",
                                                                 "false"))
    assert m("void (anonymous namespace)::household_sweep_ranged_kernel<double, false, false, "
             "false>(double const*)")
    assert m("_ZN_anon_29household_sweep_ranged_kernelIdLb0ELb0ELb0EEEvPKT_")
    assert not m("void (anonymous namespace)::household_sweep_ranged_kernel<double, false, true,"
                 " false>(double const*)")
    assert not m("_ZN_anon_29household_sweep_ranged_kernelIdLb1ELb1ELb0EEEvPKT_")


def _cfg(bench, name):
    entry = {c["name"]: c for c in bench["configs"]}[name]
    return harness.load_json(harness.ROOT, entry["file"])


@pytest.mark.parametrize("metric, config, batch, bound_us", [
    ("kernel.sweep_jvp_f32_roofline", "ks_200x7_T300", 1, 1.46),
    ("kernel.sweep_residual_f64_roofline", "ks_200x7_T300", 1, 0.96),
    ("kernel.sweep_jvp_f32_batch_roofline", "ks_200x7_T300", 4, 5.85),
])
def test_frozen_counts_give_the_kernel_tables_bounds(bench, metric, config, batch, bound_us):
    """The bound column of PERF.md's kernel table (chip_smoke.py's counts), to
    the digits it prints."""
    run = types.SimpleNamespace(config=_cfg(bench, config), mix={"batch": batch})
    digits = len(str(bound_us).split(".")[1])
    assert round(harness.metric_reader(metric).least_seconds(run) * 1e6, digits) == bound_us


@pytest.mark.parametrize("which, tangent, bound_us", [(0, True, 34.6), (1, True, 34.3),
                                                     (0, False, 17.2), (1, False, 17.2)])
def test_frozen_two_asset_counts_give_the_kernel_tables_bounds(which, tangent, bound_us):
    """The two-asset FP64 pair's bounds in PERF.md's kernel table, at
    40 liquid x 20 illiquid x 5 income states, T = 300."""
    least = yardstick.least_seconds(yardstick.two_asset_bytes(299, 40, 20, 5, which, tangent),
                                    yardstick.two_asset_ops(299, 40, 20, 5, which, tangent),
                                    "f64")
    assert round(least * 1e6, 1) == bound_us


class FakeProfiler:
    """The part of torch.profiler's results that `tracing.Trace` reads."""

    def __init__(self, ops):
        class Event:
            def __init__(self, name, start, end):
                self.name = lambda: name
                self.device_type = lambda: torch.autograd.DeviceType.CUDA
                self.start_ns, self.duration_ns = lambda: start, lambda: end - start

        results = types.SimpleNamespace(events=lambda: [Event(*op) for op in ops])
        self.profiler = types.SimpleNamespace(kineto_results=results)


def test_the_markers_bound_the_window_and_place_the_host_spans():
    """The first and the last operation traced are the window's markers:
    they bound the window and leave the operations; the host spans move
    onto the trace's clock by the first marker's time."""
    k1 = "household_sweep_jvp_kernel"
    ops = [(k1, 5_400, 5_600), ("spin_kernel", 5_000, 5_001), (k1, 5_700, 5_900),
           ("spin_kernel", 6_000, 6_002)]
    t0 = 2.0                                   # the host clock at the first marker
    spans = [("setup.jacobian", 1.0, 1.5), ("request", t0 + 300e-9, t0 + 950e-9),
             ("solve", t0 + 350e-9, t0 + 920e-9)]
    tr = tracing.Trace(FakeProfiler(ops), spans, t0, t0 + 1e-6)
    assert (tr.start, tr.end) == (5_000, 6_002) and tr.window_s == pytest.approx(1002e-9)
    assert [n for n, _, _ in tr.ops] == [k1, k1] and tr.busy_s == pytest.approx(400e-9)
    assert tr.spans == [("request", 5_300, 5_950), ("solve", 5_350, 5_920)]
    assert tr.idle_gaps() == [["between requests", pytest.approx(400e-9)],
                              ["between requests", pytest.approx(102e-9)],
                              ["solve", pytest.approx(100e-9)]]
    with pytest.raises(RuntimeError):
        tracing.Trace(FakeProfiler(ops[:1]), spans, t0, t0 + 1e-6)
    empty = tracing.Trace(FakeProfiler([]), spans, t0, t0 + 1e-6)
    assert empty.busy_s == 0 and empty.window_s == pytest.approx(1e-6)


def test_roofline_share_and_solve_mfu(bench):
    cfg = _cfg(bench, "ks_200x7_T300")
    k1 = "void (anonymous namespace)::household_sweep_jvp_kernel(float const*)"
    tr = FakeTrace([(k1, i * 10_000_000, i * 10_000_000 + 3_700_000) for i in range(4)],
                   [("window", 0, 10**9)], 0, 10**9)
    work = {"kernel.sweep_jvp_f32_roofline": 55, "kernel.sweep_residual_f64_roofline": 6}
    run = types.SimpleNamespace(config=cfg, mix={"batch": 1}, trace=tr, solved=5, window_s=2.0,
                                data={"launches_per_path": work})
    least1 = yardstick.least_seconds(yardstick.one_asset_sweep_bytes(299, 200, 7, True, "f32"),
                                     yardstick.one_asset_sweep_ops(299, 200, 7, True), "f32")
    least2 = yardstick.least_seconds(yardstick.one_asset_sweep_bytes(299, 200, 7, False, "f64"),
                                     yardstick.one_asset_sweep_ops(299, 200, 7, False), "f64")
    assert harness.metric_reader("kernel.sweep_jvp_f32_roofline").read(run) == \
        pytest.approx(100 * least1 / 3.7e-3)
    assert harness.metric_reader("kernel.sweep_residual_f64_roofline").read(run) is None
    assert harness.metric_reader("solve_mfu").read(run) == \
        pytest.approx(100 * 5 / 2.0 * (55 * least1 + 6 * least2))
