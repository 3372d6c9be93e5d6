"""Each cell of BENCHMARK.json run on the card for a short window, as the
benchmark's command runs it, in a process of its own. Skipped without a
card; on the card:

    python -m pytest -m gpu hank_bench/tests -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from hank_bench import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_window_of_each_cell(card, cell):
    out = subprocess.run([sys.executable, "-m", "hank_bench", "--workload", cell,
                          "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["device"]["platform"] == "gpu"
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    assert {m["name"] for m in harness.metrics_of(bench, cell, True)} <= set(result["metrics"])
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name, m in result["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 100


def test_no_card_no_result(tmp_path):
    """Without a card (or in a directory with the benchmark alone) the
    command exits with an error and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "hank_bench", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, without the program, the command fails and prints no result."""
    import shutil

    shutil.copy(f"{harness.ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "hank_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "hank_bench", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
