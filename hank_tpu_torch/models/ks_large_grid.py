"""Large-grid Krusell-Smith model functions (BASELINE config 4; port of
`hank_tpu/models/ks_large_grid.py`).

Same household EGM step as the 200-point model: `ValueFunction` is
imported from `models/krusell_smith.py`, so the household-sweep kernels
find that module's `fused_prices` hook through `value_fn.__module__`
(`ops/fused_sweep.py`); the hook and the function must stay in that one
module. The shock generator is a nonlinear ZLB-style productivity path: a
deep drop clamped at a floor, then geometric recovery to the steady state.
"""

from __future__ import annotations

import torch

from hank_tpu_torch.models.krusell_smith import ValueFunction  # noqa: F401 — shared EGM step


def exogenousZ(T: int, *, drop: float = 0.30, rho: float = 0.90,
               floor: float = 0.88, z_ss: float = 1.0, **kwargs) -> torch.Tensor:
    """ZLB-style kinked shock Z_t = max(floor, z_ss − drop·ρᵗ), a float64
    CPU tensor. With the defaults the floor binds for ~9 periods, a
    non-smooth path a linearised solution cannot represent."""
    t = torch.arange(1, T + 1, dtype=torch.float64)
    return torch.clamp(z_ss - drop * rho ** t, min=floor)
