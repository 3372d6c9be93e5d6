"""Disk cache of steady states and J̄ (port of `hank_tpu/utils/checkpoint.py`).

The npz layout is the JAX package's (`checkpoint.py:80-129`): a steady
state holds `var_names`, `var_values`, `het_names`, `D`, `value` and one
`policy_<name>` per heterogeneous variable; J̄ is `J`. So the port reads the
JAX package's files too (`load_steady_state_npz`, `load_jacobian_npz`), and
`steady_state_from_numpy` turns arrays handed over from the JAX package into
port tensors. The cache directory is the port's own.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
from typing import Mapping

import numpy as np
import torch

from hank_tpu_torch.config import config


def default_cache_dir() -> str:
    d = os.environ.get("HANK_TPU_TORCH_CACHE",
                       os.path.expanduser("~/.cache/hank_tpu_torch"))
    path = os.path.join(d, "artifacts")
    os.makedirs(path, exist_ok=True)
    return path


def model_hash(model, include_horizon: bool = False) -> str:
    """Structural hash: anything that changes the SS (or, with
    `include_horizon`, the T-dependent J̄) changes the key."""
    h = hashlib.sha256()
    payload = {
        "name": model.name,
        "equations": list(model.equations),
        "params": {k: float(v) for k, v in model.params.items()},
        "eps": model.compspec.eps,
        "vars": [(k, v.var_type) for k, v in model.variables.items()],
        "ss_initial": [sorted(model.ss_initial.fixed.items()),
                       sorted(model.ss_initial.guesses.items()),
                       sorted(model.ss_initial.bounds.items())],
        "ss_ending": [sorted(model.ss_ending.fixed.items()),
                      sorted(model.ss_ending.guesses.items()),
                      sorted(model.ss_ending.bounds.items())],
        "dtype": str(config.dtype),
    }
    if include_horizon:
        payload["T"] = model.compspec.T
    h.update(json.dumps(payload, sort_keys=True).encode())
    h.update(inspect.getsource(model.value_fn).encode())
    for name, dim in model.heterogeneity.items():
        h.update(name.encode())
        h.update(dim.grid.detach().cpu().numpy().astype(np.float64).tobytes())
        if dim.transition is not None:
            h.update(dim.transition.detach().cpu().numpy().astype(np.float64).tobytes())
    return h.hexdigest()[:16]


def steady_state_from_numpy(arrays: Mapping, device="cuda"):
    """SteadyState from numpy arrays: `arrays` maps "vars" ({name: scalar}),
    "policies" ({name: array}), "D" and "value" to the JAX package's
    steady-state arrays. Everything becomes float64 on `device`: the card
    unless the caller asks for the CPU, as with the port's other loaders."""
    from hank_tpu_torch.solvers.steady_state import SteadyState

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), device=device)

    return SteadyState(vars={k: t(v) for k, v in arrays["vars"].items()},
                       policies={k: t(v) for k, v in arrays["policies"].items()},
                       D=t(arrays["D"]), value=t(arrays["value"]))


def load_steady_state_npz(path: str, device="cuda"):
    """SteadyState from a steady-state npz (the JAX package's or the port's)."""
    with np.load(path, allow_pickle=False) as z:
        names = [str(s) for s in z["var_names"]]
        het = [str(s) for s in z["het_names"]]
        return steady_state_from_numpy(
            {"vars": dict(zip(names, z["var_values"])),
             "policies": {k: z[f"policy_{k}"] for k in het},
             "D": z["D"], "value": z["value"]}, device)


def load_jacobian_npz(path: str, device="cuda") -> torch.Tensor:
    """J̄ from a Jacobian npz (the JAX package's or the port's)."""
    with np.load(path, allow_pickle=False) as z:
        return torch.as_tensor(np.array(z["J"], dtype=np.float64), device=device)


def _ss_path(model, label, cache_dir):
    return os.path.join(cache_dir or default_cache_dir(),
                        f"ss_{model_hash(model)}_{label}.npz")


def _jbar_path(model, cache_dir):
    return os.path.join(cache_dir or default_cache_dir(),
                        f"jbar_{model_hash(model, include_horizon=True)}.npz")


def save_steady_state(ss, model, label: str, cache_dir: str | None = None) -> str:
    path = _ss_path(model, label, cache_dir)
    names = list(model.var_names())
    het = list(model.vars_of_type("heterogeneous"))
    np.savez(path,
             var_names=np.array(names),
             var_values=np.array([float(ss.vars[k]) for k in names]),
             het_names=np.array(het),
             D=ss.D.detach().cpu().numpy(),
             value=ss.value.detach().cpu().numpy(),
             **{f"policy_{k}": ss.policies[k].detach().cpu().numpy() for k in het})
    return path


def load_steady_state(model, label: str, cache_dir: str | None = None):
    """The cached SteadyState on the model's device, or None."""
    path = _ss_path(model, label, cache_dir)
    return load_steady_state_npz(path, model.device) if os.path.exists(path) else None


def save_jacobian(J, model, cache_dir: str | None = None) -> str:
    path = _jbar_path(model, cache_dir)
    np.savez(path, J=J.detach().cpu().numpy())
    return path


def load_jacobian(model, cache_dir: str | None = None):
    path = _jbar_path(model, cache_dir)
    return load_jacobian_npz(path, model.device) if os.path.exists(path) else None


def get_or_solve(model, verbose: bool = False, cache_dir: str | None = None,
                 cache: bool = True):
    """Steady states + J̄ with disk caching; the standard model-setup call.
    `cache=False` solves afresh and writes nothing."""
    from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
    from hank_tpu_torch.solvers.steady_state import find_ss

    ss0 = load_steady_state(model, "initial", cache_dir) if cache else None
    if ss0 is None:
        ss0 = find_ss(model, model.ss_initial, "initial", verbose)
        if cache:
            save_steady_state(ss0, model, "initial", cache_dir)

    if model.ss_initial == model.ss_ending:
        ssT = ss0
    else:
        ssT = load_steady_state(model, "ending", cache_dir) if cache else None
        if ssT is None:
            ssT = find_ss(model, model.ss_ending, "ending", verbose)
            if cache:
                save_steady_state(ssT, model, "ending", cache_dir)

    J = load_jacobian(model, cache_dir) if cache else None
    if J is None:
        J = get_steady_state_jacobian(ssT, model)
        if cache:
            save_jacobian(J, model, cache_dir)
    return ss0, ssT, J
