"""Built-in model families of the port.

Each model is a (YAML spec, Python function file) pair. The YAML is shared
with the JAX package and read from `hank_tpu/models/` as a data file; the
function file is the port's own, in this directory.
"""

from __future__ import annotations

import dataclasses
import os

from hank_tpu_torch.model.parser import build_model_from_yaml

_HERE = os.path.dirname(os.path.abspath(__file__))
_YAML_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "hank_tpu", "models")

SHIPPED = {"krusell_smith": "krusell_smith.yaml",
           "hank_two_asset": "hank_two_asset.yaml"}

# Families that `hank_tpu` ships and the port does not load yet, with the
# ROADMAP.md item that ports them.
NOT_YET_PORTED = {
    "ks_large_grid": "Queue 1 item 8 (other one-asset families)",
    "hank_one_asset": "Queue 1 item 8 (other one-asset families)",
}


def model_path(name: str) -> str:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"model '{name}' is not ported to hank_tpu_torch yet: "
            f"ROADMAP.md {NOT_YET_PORTED[name]}")
    if name not in SHIPPED:
        raise KeyError(f"Unknown shipped model '{name}'. Available: {sorted(SHIPPED)}")
    return os.path.join(_YAML_DIR, SHIPPED[name])


def load_model(name: str, params=None, device="cpu", **overrides):
    """Build a shipped model on `device`; `overrides` patch CompSpec fields
    (e.g. T=300); `params` patches model parameters."""
    model = build_model_from_yaml(model_path(name), function_dir=_HERE,
                                  device=device)
    if params:
        unknown = set(params) - set(model.params)
        if unknown:
            raise KeyError(f"Unknown parameter override(s) {sorted(unknown)} "
                           f"for model '{name}'; available: {sorted(model.params)}")
        merged = dict(model.params)
        merged.update({k: float(v) for k, v in params.items()})
        model = dataclasses.replace(model, params=merged)
    if overrides:
        model = dataclasses.replace(
            model, compspec=dataclasses.replace(model.compspec, **overrides))
    return model
