"""A run of the harness on the CPU at test sizes, past its look for a card:
sound, it is correct; with the float32 control or any fault that the cell
can have in the program's place, it is not.

The steady states and J̄ of each test model are solved once for the module
and handed to every run's set-up."""

from __future__ import annotations

import copy
import os
import time

import pytest
import torch

from hank_bench import harness
from hank_bench.tests import controls

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CELLS = {"ks_40x5_T12.solve_f32": ("ks_40x5_T12", "tfp_solve_f32"),
         "ks_40x5_T12.ensemble_b4_f32": ("ks_40x5_T12", "tfp_ensemble_b4_f32")}
# The benchmark's cell whose metrics each test cell reports.
STANDS_FOR = {"ks_200x7_T300.solve_f32": "ks_40x5_T12.solve_f32",
              "ks_200x7_T300.ensemble_b256_f32": "ks_40x5_T12.ensemble_b4_f32"}


@pytest.fixture(scope="module")
def bench():
    b = copy.deepcopy(harness.load_json(harness.ROOT, "BENCHMARK.json"))
    b["configs"] = [{"name": "ks_40x5_T12", "file": os.path.relpath(
        os.path.join(FIX, "configs", "ks_40x5_T12.json"), harness.ROOT)}]
    b["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1}
                      for n, (c, t) in CELLS.items()]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [STANDS_FOR[w] for w in m["workloads"] if w in STANDS_FOR]
    return b


@pytest.fixture(scope="module")
def set_up_once(bench):
    torch.set_num_threads(2)
    with controls.shared_set_up():
        yield


def _run(bench, cell, patch=None, traced=False):
    try:
        return harness.run_cell(bench, cell, 2**31 + 4321, 0.01, traced, "cpu",
                                time.perf_counter(), patch=patch, here=FIX)
    finally:
        controls.undo()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(bench, set_up_once, cell):
    r = _run(bench, cell, traced=True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["residual"]["value"] < 1e-6
    assert list(r)[-1] == "checks"
    assert "device.idle_share" in r["metrics"] and r["device"]["window_s"] > 0


@pytest.mark.parametrize("cell, patch", [
    ("ks_40x5_T12.solve_f32", "control_f32"),
    ("ks_40x5_T12.solve_f32", "state_unchanged"),
    ("ks_40x5_T12.solve_f32", "answer_altered"),
    ("ks_40x5_T12.ensemble_b4_f32", "control_f32"),
    ("ks_40x5_T12.ensemble_b4_f32", "state_unchanged"),
    ("ks_40x5_T12.ensemble_b4_f32", "half_batch"),
    ("ks_40x5_T12.ensemble_b4_f32", "answer_altered"),
])
def test_the_control_and_each_fault_are_caught(bench, set_up_once, cell, patch):
    r = _run(bench, cell, controls.PATCHES[patch])
    assert not r["correct"], r["checks"]
    assert r["checks"]["residual"]["value"] > r["checks"]["residual"]["limit"]
