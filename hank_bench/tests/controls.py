"""The control and the faults that a cell's comparison has to catch.

Each is a `patch(system)` for `harness.run_cell`: called after the
program's set-up, it puts something in the program's place for the
warm-up and the window. `undo()` takes every patch out again.

  control_f32      the reference, computed in float32, as the program's
                   residual F (one path: `residual_route`, its stall rescue
                   off, which would rerun the same F at its f32 floor; an
                   ensemble: the batched F); the program's directions stay
  state_unchanged  the solve returns the state it started from
  half_batch       an ensemble solves only the first half of its rows and
                   returns the rest as it got them
  answer_altered   one entry of the answer moves by 1e-4 of its size

A fault claims its answers solved (the program's own norm 0), so only the
comparison can see it. The exchange between chips does not exist in a
one-card cell.

On the card, the runs that set a cell's limits, in one process that sets
each configuration up once (`shared_set_up`): every seed with every patch
("none" for the program as it is),
    python -m hank_bench.tests.controls --workload <cell> \
        --run none:10:1,2,3 --run control_f32:60:4,5,6
(`--run patch:window seconds:seeds`), one JSON line a run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from unittest import mock

import torch

from hank_bench import check, program


def undo() -> None:
    mock.patch.stopall()


@contextlib.contextmanager
def shared_set_up():
    """Within the block, `Program.set_up` solves each configuration once and
    hands the same steady states and J̄ to every later run."""
    done, original = {}, program.Program.set_up

    def cached(self):
        key = self.config["name"]
        if key not in done:
            original(self)
            done[key] = {k: getattr(self, k) for k in ("ss0", "ssT", "Jbar", "x_ss")}
        self.__dict__.update(done[key])

    program.Program.set_up = cached
    try:
        yield
    finally:
        program.Program.set_up = original


def _claim_solved(x, info, B=None):
    info = dict(info)
    info["residual_norm"] = 0.0 if B is None else torch.zeros(B, dtype=torch.float64)
    return x, info


def _wrap_path_solver(change):
    import hank_tpu_torch.solvers.newton as newton

    build = newton.make_path_solver

    def make(*a, **kw):
        run = build(*a, **kw)
        return lambda x0: change(x0, *run(x0))

    mock.patch.object(newton, "make_path_solver", make).start()


def _wrap_ensemble(change):
    import hank_tpu_torch.parallel.ensemble as ensemble

    solve = ensemble.solve_ensemble_host

    def patched(x0, Jbar, exog, *a, **kw):
        return change(x0, exog, *solve(x0, Jbar, exog, *a, **kw))

    mock.patch.object(ensemble, "solve_ensemble_host", patched).start()


def state_unchanged(system):
    _wrap_path_solver(lambda x0, x, info: _claim_solved(x0.clone(), info))
    _wrap_ensemble(lambda x0, exog, x, info: _claim_solved(x0.expand_as(x).clone(), info,
                                                           x.shape[0]))


def half_batch(system):
    def change(x0, exog, x, info):
        x = x.clone()
        x[x.shape[0] // 2:] = x0
        return _claim_solved(x, info, x.shape[0])

    _wrap_ensemble(change)


def answer_altered(system):
    def alter(x):
        x = x.clone()
        k = x.shape[-1] // 3
        x[..., k] += 1e-4 * x[..., k].abs()
        return x

    _wrap_path_solver(lambda x0, x, info: _claim_solved(alter(x), info))
    _wrap_ensemble(lambda x0, exog, x, info: _claim_solved(alter(x), info, x.shape[0]))


def control_f32(system):
    """The reference in float32 as the program's residual."""
    import hank_tpu_torch.parallel.ensemble as ensemble
    import hank_tpu_torch.solvers.newton as newton

    ref = check.reference(system.config)
    eco = ref.Economy(system.config, system.device)
    ss0, ssT = system.steady_state_vars()
    hh0 = eco.steady_state(ss0)[1]
    hhT = hh0 if ss0 == ssT else eco.steady_state(ssT)[1]
    eco32 = eco.to(torch.float32)

    def F_batch(x, exog):
        return eco32.path_residual(x, exog, ss0, ssT, hh0, hhT).to(x.dtype)

    def route(model, s0, sT, exog, mode="auto"):
        return lambda x: F_batch(x[None], {k: v[None] for k, v in exog.items()})[0]

    mock.patch.object(newton, "residual_route", route).start()
    build = newton.make_path_solver
    mock.patch.object(newton, "make_path_solver",
                      lambda *a, **kw: build(*a, **{**kw, "stall_rescue": False})).start()
    mock.patch.object(ensemble, "_kernel_residual_batch",
                      lambda model, s0, sT: F_batch).start()


PATCHES = {f.__name__: f for f in (control_f32, state_unchanged, half_batch, answer_altered)}


def main(argv=None) -> int:
    from hank_bench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--run", action="append", required=True, help="patch:seconds:seed,seed,…")
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    with shared_set_up():
        for name in args.workload:
            for spec in args.run:
                patch, seconds, seeds = spec.split(":")
                for seed in (int(x) for x in seeds.split(",")):
                    t0 = time.perf_counter()
                    try:
                        r = harness.run_cell(bench, name, seed, float(seconds), False, "cuda",
                                             t0, patch=PATCHES.get(patch))
                    finally:
                        undo()
                    print(json.dumps({"workload": name, "patch": patch, "seed": seed,
                                      "wall_s": time.perf_counter() - t0, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
