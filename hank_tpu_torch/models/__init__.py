"""Built-in model families of the port (port of `hank_tpu/models/__init__.py`).

Each model is a (YAML spec, Python function file) pair, both in this
directory. The YAML specs are copies of `hank_tpu/models/*.yaml`, byte for
byte (a test holds them so); the function files are the port's own.
"""

from __future__ import annotations

import dataclasses
import os

from hank_tpu_torch.model.parser import build_model_from_yaml

_HERE = os.path.dirname(os.path.abspath(__file__))

SHIPPED = {"krusell_smith": "krusell_smith.yaml",
           "hank_two_asset": "hank_two_asset.yaml",
           "hank_one_asset": "hank_one_asset.yaml",
           "ks_large_grid": "ks_large_grid.yaml"}


def model_path(name: str) -> str:
    if name not in SHIPPED:
        raise KeyError(f"Unknown shipped model '{name}'. Available: {sorted(SHIPPED)}")
    return os.path.join(_HERE, SHIPPED[name])


def load_model(name: str, params=None, device="cuda", **overrides):
    """Build a shipped model on `device` (the card unless the caller asks
    for the CPU); `overrides` patch CompSpec fields (e.g. T=300); `params`
    patches model parameters."""
    model = build_model_from_yaml(model_path(name), device=device)
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
