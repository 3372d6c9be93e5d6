"""The system under test, hank_tpu_torch, driven as its users drive it: a
model from a configuration, its set-up (both steady states and J̄), and
requests of two kinds, one path or one ensemble of paths, each solved by
the program's own solver.

This is the only module of the benchmark that imports the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

DTYPES = {None: None, "float32": torch.float32}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """Host spans of the benchmark's own calls into the program: (name,
    start, end) on the perf_counter clock, each closed after the card has
    finished its work."""

    def __init__(self, device):
        self.device = device
        self.closed: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.closed.append((name, start, time.perf_counter()))

    def seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.closed if n == name)


# The configuration's grid functions, by the names of the program's own.
PROGRAM_GRIDS = {"double_exponential": "double_exponential",
                 "rouwenhorst": "rouwenhorst_discretization",
                 "access": "access_process"}


def build_model(config: dict, device):
    """The shipped model of the configuration's family, with the
    configuration's parameters and horizon, and with grids that the
    program's own parser builds from the configuration's grid numbers."""
    from hank_tpu_torch.model.parser import build_model_from_yaml
    from hank_tpu_torch.models import load_model, model_path

    model = load_model(config["family"], params=config["params"], device=device,
                       T=config["T"])
    shipped = model_path(config["family"])
    with open(shipped) as f:
        spec = yaml.safe_load(f)
    dims = config["dimensions"]
    if {d["name"] for d in spec["dimensions"]} != set(dims):
        raise ValueError(f"configuration dimensions {sorted(dims)} are not the model's "
                         f"{sorted(d['name'] for d in spec['dimensions'])}")
    for d in spec["dimensions"]:
        mine = dims[d["name"]]
        if PROGRAM_GRIDS[mine["grid"]] != d["grid_function"]:
            raise ValueError(f"{d['name']}: the configuration's grid {mine['grid']!r} is not "
                             f"the model's {d['grid_function']!r}")
        d["params"] = {k: v for k, v in mine.items() if k != "grid"}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, os.path.basename(shipped))
        with open(path, "w") as f:
            yaml.safe_dump(spec, f, allow_unicode=True)
        het = build_model_from_yaml(path, function_dir=os.path.dirname(shipped),
                                    device=device).heterogeneity
    model = dataclasses.replace(model, heterogeneity=het)
    for label, spec in (("initial", model.ss_initial), ("ending", model.ss_ending)):
        if spec.fixed != config["steady_states"][label]:
            raise ValueError(f"the model's {label} steady state fixes {spec.fixed}, the "
                             f"configuration {config['steady_states'][label]}")
    return model


class Program:
    """One configuration's model, set up, and the requests it serves."""

    def __init__(self, config: dict, device, spans: Spans):
        self.config, self.device, self.spans = config, torch.device(device), spans
        self.model = build_model(config, self.device)

    def set_up(self) -> None:
        """Both steady states and J̄, solved afresh as
        `utils/checkpoint.get_or_solve(cache=False)` solves them."""
        from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
        from hank_tpu_torch.solvers.steady_state import find_ss

        m = self.model
        with self.spans("setup.steady_state"):
            self.ss0 = find_ss(m, m.ss_initial, "initial")
        if m.ss_initial == m.ss_ending:
            self.ssT = self.ss0
        else:
            with self.spans("setup.steady_state"):
                self.ssT = find_ss(m, m.ss_ending, "ending")
        with self.spans("setup.jacobian"):
            self.Jbar = get_steady_state_jacobian(self.ssT, m)
        endog = m.vars_of_type("endogenous")
        self.x_ss = torch.stack([torch.as_tensor(self.ssT.vars[k]) for k in endog]
                                ).repeat(m.compspec.T - 1)

    def steady_state_vars(self) -> tuple[dict, dict]:
        """The judged steady-state scalars, as Python floats."""
        return tuple({k: float(v) for k, v in ss.vars.items()} for ss in (self.ss0, self.ssT))

    def release(self) -> None:
        """Drop the program's state from the card."""
        for k in ("ss0", "ssT", "Jbar", "x_ss", "model"):
            self.__dict__.pop(k, None)
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ── requests ──────────────────────────────────────────────────────────
    def serve(self, kind: str, shocks: dict, solver: dict, eps: float) -> dict:
        """Solve one request: {"x": the answer on the host (B, n), "norms":
        the program's own residual norms (B,), "info": its solver info}."""
        return getattr(self, f"_serve_{kind}")(
            {k: torch.as_tensor(v, dtype=torch.float64, device=self.device)
             for k, v in shocks.items()}, dict(solver), eps)

    def _serve_single_path(self, shocks, solver, eps):
        from hank_tpu_torch.solvers.newton import make_path_solver

        solver["direction_dtype"] = DTYPES[solver.get("direction_dtype")]
        with self.spans("build"):
            run = make_path_solver(self.Jbar, {k: v[0] for k, v in shocks.items()}, self.model,
                                   self.ss0, self.ssT, eps=eps, **solver)
        with self.spans("solve"):
            x, info = run(self.x_ss)
        with self.spans("fetch"):
            x = x.cpu()[None]
        return {"x": x, "norms": np.array([info["residual_norm"]], dtype=np.float64),
                "info": info}

    def _serve_ensemble(self, shocks, solver, eps):
        from hank_tpu_torch.parallel.ensemble import solve_ensemble_host

        solver["direction_dtype"] = DTYPES[solver.get("direction_dtype")]
        with self.spans("solve"):
            x, info = solve_ensemble_host(self.x_ss, self.Jbar, shocks, self.model, self.ss0,
                                          self.ssT, eps=eps, **solver)
        with self.spans("fetch"):
            x = x.cpu()
            norms = info["residual_norm"].double().cpu().numpy()
        return {"x": x, "norms": norms, "info": info}


def launch_counters() -> dict:
    """Every launch and plain-call counter of the program's kernel
    wrappers loaded so far: {"<module>.<function>.<counter>": count}."""
    out = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith("hank_tpu_torch.ops.") or module is None:
            continue
        short = name.rsplit(".", 1)[1]
        for attr, fn in vars(module).items():
            if not callable(fn) or getattr(fn, "__module__", None) != name:
                continue
            for counter in ("launches", "launches_cluster", "launches_global", "calls"):
                value = getattr(fn, counter, None)
                if isinstance(value, int):
                    out[f"{short}.{attr}.{counter}"] = value
    return out
