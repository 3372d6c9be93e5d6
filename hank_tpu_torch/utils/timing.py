"""Structured timing (port of `hank_tpu/utils/timing.py`).

A phase timer that waits for the card before it reads the clock, so its
wall-clock covers device execution and not only the enqueue, plus the
median-of-runs helper of the bench scripts. `torch.cuda.synchronize` takes
the place of `jax.effects_barrier` and `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import torch


def _synchronize(devices=None) -> None:
    """Wait for `devices` (default: the current CUDA device, if CUDA was
    used in this process)."""
    if devices is None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def phase(name: str, records: list[dict] | None = None, verbose: bool = True):
    """Time a phase, waiting for the card at its end."""
    t0 = time.perf_counter()
    yield
    _synchronize()
    dt = time.perf_counter() - t0
    if verbose:
        print(f"[hank_tpu_torch] {name}: {dt:.3f}s")
    if records is not None:
        records.append({"phase": name, "seconds": dt})


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def block(tree: Any) -> Any:
    """Wait until every CUDA tensor in a nested tuple/list/dict is computed
    (synchronises each CUDA device they live on); returns `tree`."""
    _synchronize({t.device for t in _leaves(tree) if t.is_cuda})
    return tree


def timeit(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Median wall-clock seconds of `fn(*args)` after `warmup` calls."""
    for _ in range(warmup):
        block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
