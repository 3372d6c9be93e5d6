"""Floors and clips with JAX's derivative at a tie.

`jnp.maximum` / `jnp.clip` split the derivative evenly when the argument
equals the bound; `torch.clamp` passes all of it. Ties are exact here, not
rare: a constrained household's savings policy IS the bottom grid point.
`torch.maximum` / `torch.minimum` with a tensor bound have the JAX rule, so
the port's floors and clips go through these two helpers. The bound is a
0-d CPU tensor, which torch broadcasts to a CUDA operand as a scalar
(no host-to-device copy).
"""

from __future__ import annotations

import torch


def floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo) with a balanced derivative at x == lo (`jnp.maximum`)."""
    return torch.maximum(x, torch.tensor(lo, dtype=x.dtype))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi) with balanced derivatives at the bounds (`jnp.clip`)."""
    return torch.minimum(floor(x, lo), torch.tensor(hi, dtype=x.dtype))
