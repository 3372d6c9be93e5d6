"""The benchmark's core: one run of one cell.

    python -m hank_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything particular to a cell is found by name: the cell's entry in
BENCHMARK.json gives its configuration (`file`) and its traffic mix
(`traffic/<traffic>.json`); `cells/<cell>.json` holds the cell's frozen
numbers (the limits of its comparison, the work of one path); each metric
is read by `metrics/<metric>.py`. This module names none of them.

A run: set-up (the program's import and CUDA start, its model, both
steady states, J̄ and one warm-up request of the cell's shapes), then a
closed loop of requests for `seconds` (the last one in flight finishes),
which the host clock times; a traced run goes on with the same loop under
the profiler, which traces the card alone, for at most TRACE_SECONDS,
and reads the card's side of the work there; then the program's state is dropped and
the reference judges the answers; the last line of standard output is the
result as one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hank_tpu")
# The longest window a traced run traces: the profiler's handling of a
# window's trace takes a multiple of the window itself, and a run has to
# end within 360 s.
TRACE_SECONDS = 10.0


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str, here: str = HERE) -> tuple[dict, dict, dict, dict]:
    """(cell entry, configuration, traffic mix, frozen cell data) of `name`;
    the mixes and the cells' data are looked up under `here`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT, entry["file"])
    mix = load_json(here, "traffic", f"{cell['traffic']}.json")
    data_path = os.path.join(here, "cells", f"{name}.json")
    data = load_json(data_path) if os.path.exists(data_path) else {}
    return cell, config, mix, data


def metric_reader(name: str):
    """The module `metrics/<name>.py` (names hold dots, so loaded by path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"hank_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced)."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def card_state() -> str | None:
    """The card's name, power limit and draw, SM clock and its maximum, and
    temperature, as nvidia-smi reads them at the window's close."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
                              "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, patch=None, here: str = HERE) -> dict:
    """One run of cell `name` on `device`; returns the result object.
    `patch(program)`, when given, is called after the set-up and before the
    warm-up: the tests put faults and controls in the program's place."""
    import torch

    from hank_bench import check, program as prog, tracing
    from hank_bench.traffic import Traffic

    cell, config, mix, data = find_cell(bench, name, here)
    spans = prog.Spans(device)
    system = prog.Program(config, device, spans)
    system.set_up()
    if patch is not None:
        patch(system)
    traffic = Traffic(mix, config["T"], seed)
    kind, solver, eps = mix["kind"], mix.get("solver", {}), mix["eps"]
    system.serve(kind, traffic.request(0, warm=True)[0], solver, eps)
    prog.sync(device)

    def loop(seconds: float, mark, first: int):
        """Requests first, first + 1, ... in a closed loop for `seconds` (the
        one in flight finishes), between two readings of `mark`."""
        requests, answers = [], []
        t0 = mark()
        while not requests or time.perf_counter() - t0 < seconds:
            shocks, _ = traffic.request(first + len(requests))
            start = time.perf_counter()
            try:
                with spans("request"):
                    out = system.serve(kind, shocks, solver, eps)
            except Exception:            # a request that raises gives no answer
                traceback.print_exc()
                out = None
            end = time.perf_counter()
            paths = next(iter(shocks.values())).shape[0]
            solved = 0 if out is None else int(
                (torch.isfinite(out["x"]).all(dim=1).numpy() & (out["norms"] <= eps)).sum())
            info = {} if out is None else {k: v for k, v in out["info"].items()
                                           if isinstance(v, (int, float))}
            requests.append({"start": start, "end": end, "paths": paths, "solved": solved,
                             "info": info})
            answers.append(None if out is None else
                           {"x": out["x"], "norms": out["norms"], "shocks": shocks})
        return requests, answers, t0, mark()

    before = prog.launch_counters()
    requests, answers, t0, _ = loop(seconds, time.perf_counter, 0)
    counters = prog.launch_counters()
    counters = {k: v - before.get(k, 0) for k, v in counters.items()}
    trace, traced_requests = None, []
    if traced:                           # then the card's own view of the same work
        with tracing.profile(device) as prof:
            traced_requests, more, u0, u1 = loop(min(seconds, TRACE_SECONDS),
                                                 lambda: tracing.mark(device), len(requests))
        trace = tracing.Trace(prof, spans.closed, u0, u1)
        answers += more
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    card = card_state() if on_card else None
    ss_vars = system.steady_state_vars()
    system.release()

    numbers = check.judge(config, mix, answers, ss_vars, seed, device)
    limits = data.get("limits", {})
    checks = {k: {"value": numbers[k], "limit": limits.get(k)} for k in ("residual", "unanswered")}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())

    run = types.SimpleNamespace(
        name=name, cell=cell, config=config, mix=mix, data=data, seconds=seconds,
        set_up=t0 - t_start, window_s=requests[-1]["end"] - t0, spans=spans,
        requests=requests, counters=counters, trace=trace,
        solved=sum(r["solved"] for r in requests),
        traced_solved=sum(r["solved"] for r in traced_requests))
    metrics = {}
    for m in metrics_of(bench, name, traced):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell["chips"] if on_card else 1,
           "memory_peak_bytes": peak}
    every = requests + traced_requests
    attempted = sum(r["paths"] for r in every)
    result = {"correct": correct, "attempted": attempted,
              "failed": attempted - sum(r["solved"] for r in every), "metrics": metrics,
              "device": dev}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}

    result["card"] = card
    result["request_s"] = [r["end"] - r["start"] for r in requests]
    result["launches"] = {k: v for k, v in counters.items() if v}
    result["checked"] = {"paths": numbers["checked_paths"], "parts": numbers["parts"]}
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python -m hank_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(bench, args.workload)[0]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"hank_bench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"hank_bench: the run loaded {found}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
