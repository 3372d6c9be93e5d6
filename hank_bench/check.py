"""The comparison that decides `correct`: the plain reference judges the
answers of the window, and the steady states of the set-up, by the
residual of the configuration's equations.

The reference is the configuration's family module under
`hank_bench/reference/`. It works out its own households (marginal values
and stationary distributions) at the judged steady-state prices and takes
nothing else of the program's: the shocks are the benchmark's, and the
program's answers are read only to be judged.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def reference(config: dict):
    return importlib.import_module(f"hank_bench.reference.{config['family']}")


def pick(n: int, k: int, seed: int) -> list[int]:
    """k of n request indices drawn from the seed (all of them for k = 0)."""
    if k <= 0 or k >= n:
        return list(range(n))
    rng = np.random.default_rng([abs(int(seed)), 7])
    return sorted(rng.choice(n, size=k, replace=False).tolist())


# Paths the reference takes at once: one batch of the ensemble cell.
ROWS_PER_PASS = 256


def judge(config: dict, mix: dict, answers: list, ss_vars: tuple, seed: int, device) -> dict:
    """{number: value} of the answers of the window.

    answers: per request {"x": (B, n) on the host, "norms": the residual
    norms (B,) the program reported for them, "shocks": {var: (B, T−1)}},
    or None where the request raised. ss_vars: the judged (initial, ending)
    steady-state scalars. An answer is judged by what it says: the
    reference's residual norm of a path is held against the norm the program
    reported for it, so a solve that reports its own stall is a failure
    (counted in `failed`), not a wrong answer. Numbers:
      residual   the largest of the reference's residual norms of both
                 steady states' equations, and of the amounts by which a
                 checked path's reference residual norm exceeds the norm
                 the program reported for it;
      unanswered the requests that gave no answer."""
    ref = reference(config)
    eco = ref.Economy(config, device)
    ss0, ssT = ss_vars
    res0, hh0 = eco.steady_state(ss0)
    resT, hhT = (res0, hh0) if ss0 == ssT else eco.steady_state(ssT)
    worst = {"steady_state": max(float(res0.norm()), float(resT.norm())), "path": 0.0,
             "path_excess": 0.0}
    chosen = pick(len(answers), int(mix.get("check_requests", 0)), seed)
    done = [answers[i] for i in chosen if answers[i] is not None]
    if done:
        X = torch.cat([a["x"] for a in done])
        said = torch.as_tensor(np.concatenate([a["norms"] for a in done]))
        said = torch.where(torch.isfinite(said), said, torch.full_like(said, float("inf")))
        S = {k: torch.cat([torch.as_tensor(a["shocks"][k]) for a in done])
             for k in done[0]["shocks"]}
        for lo in range(0, X.shape[0], ROWS_PER_PASS):
            rows = slice(lo, lo + ROWS_PER_PASS)
            R = eco.path_residual(X[rows].to(device), {k: v[rows].to(device) for k, v in S.items()},
                                  ss0, ssT, hh0, hhT)
            norms = torch.linalg.norm(R, dim=1).cpu()
            norms = torch.where(torch.isfinite(norms), norms, torch.full_like(norms, float("inf")))
            excess = norms - said[rows]
            excess = torch.where(torch.isnan(excess), torch.zeros_like(excess), excess)
            worst["path"] = max(worst["path"], float(norms.max()))
            worst["path_excess"] = max(worst["path_excess"], float(excess.max()))
    return {"residual": max(worst["steady_state"], worst["path_excess"]),
            "unanswered": float(sum(a is None for a in answers)),
            "parts": worst, "checked_paths": sum(a["x"].shape[0] for a in done)}
