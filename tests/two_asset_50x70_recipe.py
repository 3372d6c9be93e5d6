"""The recipe of `hank_tpu_torch/data/hank_two_asset_50x70_T150_jax_cpu.npz`.

    JAX_PLATFORMS=cpu python -m tests.two_asset_50x70_recipe OUT.npz [--threads N]

The shipped two-asset model with 50 liquid and 70 illiquid knots
(`make_double_exponential_grid` on the yaml's bounds [0, 120] and [0, 300]),
T = 150, its fiscal shock from `generate_exog_paths`:

1. `steady_state_search`: the port's steady state on the CPU, a Newton on
   the two household markets (B = Bg, KS = A) in (r, ra); the firm's and
   budget equations give KS, w and tau in closed form. `find_ss` (and
   `hank_tpu`'s) re-solves the household from scratch at every evaluation
   (VFI from a constant marginal value, the distribution from the uniform
   one), minutes an evaluation near the root at this grid; here each
   evaluation's fixed points start from the last one's value and
   distribution. From the yaml's guesses, a finite-difference Jacobian
   (recomputed every third step) with Broyden updates between, steps
   capped at (0.002, 0.0004), to max|F_ss| ≤ 1e-8: at the pipeline's
   tolerances (sup-norm changes 1e-12 and 1e-14) F is noisy at ~1e-9
   there. Then, with the fixed points tightened to 1e-14 and 1e-16, a
   finite-difference Jacobian and chord steps on it until max|F_ss| ≤
   `tol`; the best of those evaluations is kept, and it must reach 1e-9.
2. `jax_cpu_root_large`: `hank_tpu`'s J̄ and its Newton-Krylov path solve
   from that steady state (`scripts/hank2_cpu_groundtruth.py`'s path solve).

`jax_household_large` evaluates `hank_tpu`'s household at the file's
prices: its VFI, and the invariant distribution by plain iteration of its
transition operator (its `make_invariant_solver`, Aitken-accelerated,
diverges at this grid: PERF.md §6), against which the slow test holds the
file's steady state. Only tests import this module; it imports `hank_tpu`
inside the functions that need it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGE = (50, 70, 150)
LARGE_FILE = os.path.join(REPO, "hank_tpu_torch", "data",
                          "hank_two_asset_50x70_T150_jax_cpu.npz")
KEYS = ("B", "A", "C")
STEADY_KEYS = ("D", "value", *(f"policy_{k}" for k in KEYS))
f64 = torch.float64


def published_width(model, jnp=None, n_b: int = LARGE[0], n_a: int = LARGE[1]):
    """`model` (either package's) with `n_b` liquid and `n_a` illiquid knots
    (default 50 and 70) on the shipped bounds ([0, 120] and [0, 300],
    double-exponential)."""
    from hank_tpu_torch.model.grids import make_double_exponential_grid

    het = model.heterogeneity
    device = getattr(model, "device", "cpu")

    def grid(hi, n):
        g = make_double_exponential_grid(0.0, hi, n)
        return jnp.asarray(g) if jnp is not None else torch.tensor(g, dtype=f64, device=device)

    return dataclasses.replace(model, heterogeneity={
        **het, "liquid": dataclasses.replace(het["liquid"], n=n_b, grid=grid(120.0, n_b)),
        "illiquid": dataclasses.replace(het["illiquid"], n=n_a, grid=grid(300.0, n_a))})


def shipped_steady_state(path: str = LARGE_FILE) -> dict:
    """The steady state a file of this recipe records (`var_names`,
    `var_values`, D, value and the policies), as `steady_state_from_numpy`
    takes it."""
    with np.load(path) as z:
        return {"vars": dict(zip([str(k) for k in z["var_names"]], z["var_values"].tolist())),
                "policies": {k: z[f"policy_{k}"] for k in KEYS}, "D": z["D"],
                "value": z["value"]}


def steady_state_search(start=(-0.007, 0.0158), tol: float = 1e-10, max_evals: int = 60,
                        chord_steps: int = 12, device: str = "cpu", log=print) -> dict:
    """Step 1 of the recipe: the steady state as `shipped_steady_state`
    returns it, with `records` (each evaluation's point, max|F_ss| and
    seconds). Raises if no evaluation reaches max|F_ss| ≤ 1e-9."""
    from hank_tpu_torch.blocks.assemble import residuals
    from hank_tpu_torch.config import config
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.ops.linalg import accelerated_fixed_point
    from hank_tpu_torch.ops.transition import exog_apply, lottery_apply_multi

    model = published_width(load_model("hank_two_asset", T=3, device=device))
    names = model.var_names()
    p = model.params
    alpha, delta, Bg = float(p["α"]), float(p["δ"]), float(p["Bg"])
    endog = model.endog_dims()
    grids, pvars = [d.grid for d in endog], [d.policy_var for d in endog]
    trans = [d.transition for d in model.exog_dims()]
    cs = model.compspec
    shape = model.state_shape()
    state = {"v": torch.ones((2, *shape), dtype=f64, device=device),
             "D": torch.full(shape, 1.0 / model.n_total(), dtype=f64, device=device)}
    records, best = [], {"err": float("inf")}

    def evaluate(q, tight=False):
        t0 = time.perf_counter()
        eps_v, eps_D = ((1e-14, 1e-16) if tight else
                        (min(cs.eps, config.vfi_eps), min(cs.eps, config.invariant_eps)))
        r, ra = q.tolist()
        KS = ((ra + delta) / alpha) ** (1.0 / (alpha - 1.0))
        w = (1 - alpha) * KS ** alpha
        vals = {"r": r, "ra": ra, "w": w, "tau": r * Bg / w, "KS": KS, "G": 0.0}
        x = torch.tensor([vals.get(n, 0.0) for n in names], dtype=f64, device=device)
        xvals = {n: x[i] for i, n in enumerate(names)}
        v = accelerated_fixed_point(lambda v: model.value_fn(v, xvals, model)["Value"],
                                    state["v"], eps_v, config.vfi_max_iter)
        res = model.value_fn(v, xvals, model)
        pols = [res[k] for k in pvars]
        D = accelerated_fixed_point(
            lambda D: exog_apply(lottery_apply_multi(pols, D, grids), trans, len(endog)),
            state["D"], eps_D, 200_000)
        D = D / torch.sum(D)
        state.update(v=v, D=D)
        aggs = {k: torch.sum(res[k] * D) for k in KEYS}
        x = torch.stack([aggs[n] if n in aggs else x[i] for i, n in enumerate(names)])
        F = residuals(x[:, None].expand(len(names), 1 + cs.max_lag + cs.max_lead), model)
        err = float(F.abs().max())
        rec = {"r": r, "ra": ra, "max_abs_F": err, "tight": tight,
               "seconds": time.perf_counter() - t0}
        records.append(rec)
        log(json.dumps(rec))
        if tight and err < best["err"]:
            best.update(err=err, vars=dict(zip(names, x.cpu().tolist())), D=D.cpu().numpy(),
                        value=v.cpu().numpy(),
                        policies={k: res[k].cpu().numpy() for k in KEYS})
        return F[:2].cpu(), err

    q = torch.tensor(start, dtype=f64)
    g, err = evaluate(q)
    J, steps = None, 0
    cap = torch.tensor([0.002, 0.0004], dtype=f64)
    while err > 1e-8 and len(records) < max_evals:
        if J is None or steps % 3 == 0:
            saved = dict(state)
            J = torch.empty(2, 2, dtype=f64)
            for j in range(2):
                qq = q.clone()
                qq[j] += 1e-7
                J[:, j] = (evaluate(qq)[0] - g) / 1e-7
                state.update(saved)
        step = torch.linalg.solve(J, g)
        step = step * min(1.0, float((cap / step.abs()).min()))
        qn = q - step
        gn, err = evaluate(qn)
        J = J + torch.outer(gn - g - J @ (qn - q), qn - q) / float((qn - q) @ (qn - q))
        q, g, steps = qn, gn, steps + 1
    g, err = evaluate(q, tight=True)
    saved = dict(state)
    for j in range(2):
        qq = q.clone()
        qq[j] += 1e-7
        J[:, j] = (evaluate(qq, tight=True)[0] - g) / 1e-7
        state.update(saved)
    for _ in range(chord_steps if err > tol else 0):
        q = q - torch.linalg.solve(J, g)
        g, err = evaluate(q, tight=True)
        if err <= tol:
            break
    if best["err"] > 1e-9:
        raise RuntimeError(f"steady_state_search: best max|F_ss| {best['err']:.3e} > 1e-9")
    return {"vars": best["vars"], "policies": best["policies"], "D": best["D"],
            "value": best["value"], "records": records}


def jax_cpu_root_large(steady: dict | None = None, verbose: bool = False) -> dict:
    """Step 2 of the recipe: `hank_tpu` on a CPU, the model at 50×70, T=150,
    from the steady state `steady` (default: the one the file records): its
    J̄ and its fiscal shock from `generate_exog_paths`, Newton-Krylov with
    f32 directions to eps 1e-10 from the steady-state path. Returns the
    arrays the file holds."""
    import jax.numpy as jnp

    from hank_tpu.model.structures import generate_exog_paths
    from hank_tpu.models import load_model
    from hank_tpu.solvers.newton import make_path_solver
    from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian
    from hank_tpu.solvers.steady_state import SteadyState

    _, _, T = LARGE
    model = published_width(load_model("hank_two_asset", T=T), jnp)
    steady = shipped_steady_state() if steady is None else steady
    ss = SteadyState(vars={k: jnp.asarray(v) for k, v in steady["vars"].items()},
                     policies={k: jnp.asarray(v) for k, v in steady["policies"].items()},
                     D=jnp.asarray(steady["D"]), value=jnp.asarray(steady["value"]))
    Jbar = get_steady_state_jacobian(ss, model)
    exog = generate_exog_paths(model, T - 1)
    endog = model.vars_of_type("endogenous")
    x0 = jnp.tile(jnp.asarray([ss.vars[k] for k in endog]), T - 1)
    x, info = make_path_solver(Jbar, exog, model, ss, ss, method="newton_krylov",
                               direction_dtype=jnp.float32, eps=1e-10, verbose=verbose)(x0)
    names = list(model.var_names())
    return {"var_names": np.array(names),
            "var_values": np.array([float(steady["vars"][k]) for k in names]),
            "x": np.asarray(x), "residual_norm": np.array(float(info["residual_norm"])),
            "grid": np.array(LARGE), "G": np.asarray(exog["G"]), "D": np.asarray(steady["D"]),
            "value": np.asarray(steady["value"]),
            **{f"policy_{k}": np.asarray(steady["policies"][k]) for k in KEYS}}


def jax_household_large(steady: dict | None = None, max_iter: int = 400_000) -> dict:
    """`hank_tpu`'s household at the prices of `steady` (default: the
    file's): `make_vfi_solver`'s value from its constant start, the
    policies of one `value_fn` call on it, the invariant distribution by
    plain iteration of `lottery_apply_multi` + `exog_apply` from the uniform
    one until the sup-norm change is ≤ 1e-14 (`config.invariant_eps`), the
    aggregates and the model's steady-state residuals on them. Returns
    numpy arrays and floats: value, policies, D, vars, F_ss, iterations."""
    import jax
    import jax.numpy as jnp

    from hank_tpu.blocks.assemble import residuals
    from hank_tpu.config import config
    from hank_tpu.models import load_model
    from hank_tpu.ops.transition import exog_apply, lottery_apply_multi
    from hank_tpu.solvers.steady_state import make_vfi_solver

    steady = shipped_steady_state() if steady is None else steady
    model = published_width(load_model("hank_two_asset", T=3), jnp)
    names = model.var_names()
    xvec = jnp.asarray([float(steady["vars"][k]) for k in names])
    value = jax.jit(make_vfi_solver(model))(xvec)
    res = model.value_fn(value, {n: xvec[i] for i, n in enumerate(names)}, model)
    endog = model.endog_dims()
    pols = [res[d.policy_var] for d in endog]
    grids, trans = [d.grid for d in endog], [d.transition for d in model.exog_dims()]

    def step(D):
        return exog_apply(lottery_apply_multi(pols, D, grids), trans, len(endog))

    def body(c):
        D, _, it = c
        Dn = step(D)
        return Dn, jnp.max(jnp.abs(Dn - D)), it + 1

    shape = model.state_shape()
    D, _, iters = jax.jit(lambda D0: jax.lax.while_loop(
        lambda c: (c[1] > config.invariant_eps) & (c[2] < max_iter), body,
        (D0, jnp.inf, 0)))(jnp.full(shape, 1.0 / model.n_total()))
    D = D / jnp.sum(D)
    aggs = {k: jnp.sum(res[k] * D) for k in KEYS}
    x = jnp.stack([aggs.get(n, xvec[i]) for i, n in enumerate(names)])
    cs = model.compspec
    F_ss = residuals(jnp.tile(x[:, None], (1, 1 + cs.max_lag + cs.max_lead)), model)
    return {"value": np.asarray(value), "policies": {k: np.asarray(res[k]) for k in KEYS},
            "D": np.asarray(D), "vars": dict(zip(names, np.asarray(x).tolist())),
            "F_ss": np.asarray(F_ss), "iterations": int(iters),
            "transition_residual": float(jnp.max(jnp.abs(step(D) - D)))}


def jax_find_ss_household(steady: dict | None = None, n_b: int = LARGE[0],
                          n_a: int = LARGE[1]) -> dict:
    """`hank_tpu`'s own steady-state household (`make_ss_pipeline`'s, which
    `find_ss` evaluates: VFI from its constant start, then
    `make_invariant_solver`'s Aitken-accelerated power iteration from the
    uniform distribution) at the prices of `steady` (default: the file's)
    on an n_b×n_a grid: the largest |D| and the steady-state residuals."""
    import jax
    import jax.numpy as jnp

    from hank_tpu.models import load_model
    from hank_tpu.solvers.steady_state import make_ss_pipeline

    steady = shipped_steady_state() if steady is None else steady
    model = published_width(load_model("hank_two_asset", T=3), jnp, n_b, n_a)
    F, household, free = make_ss_pipeline(model, model.ss_initial)
    p = jnp.asarray([float(steady["vars"][k]) for k in free])
    D = jax.jit(household)(p)[3]
    return {"max_abs_D": float(jnp.max(jnp.abs(D))), "F_ss": np.asarray(jax.jit(F)(p))}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description="Rebuild the 50×70 two-asset reference file.")
    ap.add_argument("out")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--start", type=float, nargs=2, default=(-0.007, 0.0158),
                    metavar=("R", "RA"))
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    steady = steady_state_search(args.start, log=lambda s: print(s, flush=True))
    print(json.dumps({"steady_state_s": time.perf_counter() - t0,
                      "evaluations": len(steady["records"]),
                      "max_abs_F_ss": min(r["max_abs_F"] for r in steady["records"])}),
          flush=True)
    arrays = jax_cpu_root_large(steady, verbose=True)
    print(json.dumps({"seconds": time.perf_counter() - t0,
                      "residual_norm": float(arrays["residual_norm"])}), flush=True)
    np.savez_compressed(args.out, **arrays)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
