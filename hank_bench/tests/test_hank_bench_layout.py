"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell, configuration, mix and metric by name."""

from __future__ import annotations

import copy
import json
import os
import re
import shutil

import pytest
import yaml

from hank_bench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(ROOT, "BENCHMARK.json")


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["hank_bench"] and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[g]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hank_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        reported = {m["name"] for m in harness.metrics_of(bench, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.metrics_of(bench, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in e2e and m["moves"] in reported, (w["name"], m["name"])


def test_everything_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell, config, mix, data = harness.find_cell(bench, w["name"])
        assert config["name"] == cell["config"] and mix["kind"] in ("single_path", "ensemble")
        assert "limits" in data and "launches_per_path" in data
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


def test_a_file_and_an_entry_add_a_cell(bench, tmp_path):
    here = tmp_path / "hank_bench"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((here / "traffic" / "tfp_solve_f32.json").read_text())
    mix["shock"]["rho"] = [0.6, 0.7]
    (here / "traffic" / "tfp_narrow.json").write_text(json.dumps(mix))
    more = copy.deepcopy(bench)
    more["workloads"].append({"name": "ks_200x7_T300.narrow", "config": "ks_200x7_T300",
                              "traffic": "tfp_narrow", "chips": 1, "why": "a test"})
    cell, config, found, data = harness.find_cell(more, "ks_200x7_T300.narrow", str(here))
    assert found["shock"]["rho"] == [0.6, 0.7] and data == {}
    assert {m["name"] for m in harness.metrics_of(more, "ks_200x7_T300.narrow", False)} == \
        {"paths_per_s", "setup_s"}


def test_harness_core_names_no_cell_mix_or_metric(bench):
    names = [x["name"] for g in ("workloads", "end_to_end", "per_layer") for x in bench[g]]
    names += [w["traffic"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    for core in ("harness.py", "program.py", "check.py", "tracing.py", "traffic.py",
                 "__main__.py"):
        text = open(os.path.join(harness.HERE, core)).read()
        for n in names:
            assert n not in text, (core, n)


@pytest.mark.parametrize("config", ["ks_200x7_T300"])
def test_configuration_is_the_shipped_model(bench, config):
    """Every number of the configuration is the shipped YAML's, but T
    where `reduced` names it."""
    entry = {c["name"]: c for c in bench["configs"]}[config]
    cfg = harness.load_json(ROOT, entry["file"])
    assert cfg["reduced"] == entry["reduced"]
    spec = yaml.safe_load(open(os.path.join(ROOT, "hank_tpu_torch", "models",
                                            f"{cfg['family']}.yaml")))
    assert cfg["params"] == {p["name"]: p["value"] for p in spec["parameters"]["model"]}
    for d in spec["dimensions"]:
        mine = cfg["dimensions"][d["name"]]
        theirs = {"ρ": "rho", "σ": "sigma"}
        assert {theirs.get(k, k): v for k, v in d["params"].items()} == \
            {k: v for k, v in mine.items() if k != "grid"}
    T = {p["name"]: p["value"] for p in spec["parameters"]["computational"]}["T"]
    assert (cfg["T"] != T) == ("T" in cfg["reduced"])
