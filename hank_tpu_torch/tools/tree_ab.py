"""The KS headline solve and the B=64 ensemble of two source trees, in turns
on one card.

    python -m hank_tpu_torch.tools.tree_ab --tree OLD --tree NEW [--reps N] [--rounds R]
                                           [--out FILE]

Each tree is a checkout of the repo (for example a parent commit unpacked
with `git archive`). The script runs one process per turn, in the order
OLD, NEW, NEW, OLD, repeated `rounds` times, each with the tree as its
working directory and `PYTHONPATH`, so each imports its own
`hank_tpu_torch` and builds its own kernels. A turn solves Krusell-Smith
200×7, T=300 (`chip_smoke.py`'s phases 3, 5 and 6): the steady states and
J̄, then one warm-up and `reps` timed calls of
  - ks_headline: the permanent TFP shock Z 1→2, Newton-Krylov, f32
    directions, eps 1e-8, GMRES restart 10, from x_ss;
  - ensemble_b64: B=64 shock paths Z_b,t = 2 − ρ_bᵗ, `solve_ensemble_host`
    Newton-Krylov, f32 directions, eps 1e-8;
  - where the tree has `parallel/mesh.py`, after `reps` unmeshed calls
    (ensemble_b64) a one-rank group is started (`init_distributed`), and
    `reps` calls each follow on its mesh (ensemble_b64_mesh), unmeshed
    while the group lives (ensemble_b64_group), and on the mesh again;
    without it, 2·reps unmeshed calls.
Every timed call must return its warm-up's path bit for bit. Each turn
prints one JSON line with the medians, the outer and matvec counts and the
ensemble's host least-squares seconds (host work that is the same in both
trees, so it tracks the host's speed). The last line gives each tree's
median over all its timed calls and each turn's largest path difference
from the first turn's: J̄ does not repeat its last bits from one build to
the next on the card (the lottery's `scatter_add` sums with atomics), so
paths from two processes differ in their last bits even for one tree.
Needs a CUDA device and nvcc.

    python -m hank_tpu_torch.tools.tree_ab --summarize FILE... [--at SECONDS]

reads the `--out` files of earlier runs (no device needed) and prints, for
each tree and block of timed ensemble calls, the count, the median time,
the median host least-squares seconds and the time that a least-squares
line of time against host least-squares seconds gives at `--at` (0.05 s by
default): the blocks compared at one host speed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def _turn(reps: int, paths_file: str) -> dict:
    """One turn in this process's tree (module docstring)."""
    import torch

    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.models.krusell_smith import exogenousZ
    from hank_tpu_torch.parallel.ensemble import solve_ensemble_host
    from hank_tpu_torch.solvers.newton import make_path_solver
    from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
    from hank_tpu_torch.solvers.steady_state import find_ss

    torch.backends.cuda.matmul.allow_tf32 = False
    f32, f64 = torch.float32, torch.float64
    dev = torch.device("cuda:0")
    model = load_model("krusell_smith", T=300, device=dev)
    Tm1 = model.compspec.T - 1
    t0 = time.perf_counter()
    ss0 = find_ss(model, model.ss_initial, "initial")
    ssT = find_ss(model, model.ss_ending, "ending")
    Jbar = get_steady_state_jacobian(ssT, model)
    torch.cuda.synchronize()
    out = {"setup_s": time.perf_counter() - t0}
    endog = model.vars_of_type("endogenous")
    x_ss = torch.stack([torch.as_tensor(ssT.vars[k]) for k in endog]).repeat(Tm1)

    def timed(fn, runs: list, ref=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = fn()
        torch.cuda.synchronize()
        if runs is not None:
            runs.append(time.perf_counter() - t0)
        if ref is not None and not torch.equal(x, ref):
            raise RuntimeError("a timed solve differs from its warm-up")
        return x, info

    exog = {"Z": exogenousZ(Tm1, rho=0.8, z_start=1.0, z_end=2.0).to(dev)}
    solver = make_path_solver(Jbar, exog, model, ss0, ssT, method="newton_krylov",
                              direction_dtype=f32, eps=1e-8, gmres_restart=10)
    x_ref, info = timed(lambda: solver(x_ss), None)
    runs = []
    for _ in range(reps):
        timed(lambda: solver(x_ss), runs, x_ref)
    out["ks_headline"] = {"median_s": statistics.median(runs), "runs_s": runs,
                          "outer_iterations": info["iterations"]}

    B = 64
    t = torch.arange(1, Tm1 + 1, dtype=f64)
    rhos = 0.5 + 0.4 * torch.arange(B, dtype=f64) / B
    exog_b = {"Z": (2.0 + (1.0 - 2.0) * rhos[:, None] ** t[None, :]).to(dev)}
    host_ls = {}

    def ensemble(label, mesh=None):
        kw = {} if mesh is None else {"mesh": mesh}
        x, info = solve_ensemble_host(x_ss, Jbar, exog_b, model, ss0, ssT, eps=1e-8,
                                      method="newton_krylov", direction_dtype=f32, **kw)
        if label is not None:
            host_ls.setdefault(label, []).append(info["host_ls_seconds"])
        return x, info

    def block(label, n, mesh=None):
        for _ in range(n):
            timed(lambda: ensemble(label, mesh), runs.setdefault(label, []), xe_ref)

    xe_ref, info = timed(lambda: ensemble(None), None)
    runs = {}
    try:
        from hank_tpu_torch.parallel.mesh import destroy_distributed, init_distributed, make_mesh
    except ImportError:
        block("ensemble_b64", 2 * reps)
    else:
        block("ensemble_b64", reps)
        init_distributed(dev)
        try:
            mesh = make_mesh()
            timed(lambda: ensemble(None, mesh), None, xe_ref)
            for label in ("ensemble_b64_mesh", "ensemble_b64_group", "ensemble_b64_mesh"):
                block(label, reps, mesh if label.endswith("mesh") else None)
        finally:
            destroy_distributed()
    for label, r in runs.items():
        out[label] = {"median_s": statistics.median(r), "runs_s": r, "host_ls_s": host_ls[label]}
    out["ensemble_b64"].update(outer_iterations=info["iterations"],
                               matvecs=info["inner_iterations"])
    torch.save({"ks_headline": x_ref.cpu(), "ensemble_b64": xe_ref.cpu()}, paths_file)
    return out


def summarize(files: list[str], at: float) -> dict:
    """Each (tree, ensemble block)'s timed calls across `files` (module
    docstring)."""
    import numpy as np

    pts = {}
    for name in files:
        with open(name) as f:
            for line in f:
                rec = json.loads(line)
                for k, v in rec.items():
                    if "turn" in rec and k.startswith("ensemble_b64"):
                        pts.setdefault(f"{rec['tree']}/{k}", []).extend(
                            zip(v["host_ls_s"], v["runs_s"]))
    out = {}
    for key, p in sorted(pts.items()):
        a = np.asarray(p)
        slope, icpt = np.polyfit(a[:, 0], a[:, 1], 1)
        out[key] = {"calls": len(a), "median_s": float(np.median(a[:, 1])),
                    "median_host_ls_s": float(np.median(a[:, 0])),
                    "s_at_host_ls": float(icpt + slope * at)}
    return {"host_ls_s": at, "blocks": out}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout of the repo; give two, the older first")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--summarize", nargs="+", metavar="FILE")
    ap.add_argument("--at", type=float, default=0.05)
    ap.add_argument("--turn", help=argparse.SUPPRESS)    # a turn's path file
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize, args.at)))
        return 0
    if args.turn:
        print(json.dumps(_turn(args.reps, args.turn)), flush=True)
        return 0
    if len(args.tree) != 2:
        ap.error("give two trees: --tree OLD --tree NEW")

    fh = open(args.out, "w") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if fh is not None:
            fh.write(line + "\n")
            fh.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    emit({"device": smi, "reps": args.reps})
    import torch

    trees = [os.path.abspath(t) for t in args.tree]
    names = ("old", "new")
    runs = {}
    first, gaps = None, {"ks_headline": [], "ensemble_b64": []}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, i in enumerate((0, 1, 1, 0) * args.rounds):
            paths_file = os.path.join(tmp, f"turn{turn}.pt")
            env = dict(os.environ, PYTHONPATH=trees[i])
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                                   paths_file, "--reps", str(args.reps)], cwd=trees[i],
                                  env=env, capture_output=True, text=True, timeout=900)
            if proc.returncode:
                sys.stderr.write(proc.stderr[-4000:])
                return proc.returncode
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            emit({"turn": turn, "tree": names[i], **rec})
            for k, v in rec.items():
                if isinstance(v, dict):
                    runs.setdefault(f"{names[i]}/{k}", []).extend(v["runs_s"])
            paths = torch.load(paths_file)
            first = first or paths
            for k in gaps:
                gaps[k].append(float((paths[k] - first[k]).abs().max()))
    emit({"median_s": {k: statistics.median(v) for k, v in runs.items()},
          "path_max_abs_vs_turn_0": gaps})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
