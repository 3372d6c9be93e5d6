"""The yardstick of the kernel metrics: the card's published peaks and the
work a household sweep needs, counted from the algorithm at a call's
shapes. Frozen here so that a rewrite of a kernel does not move them.
"""

from __future__ import annotations

# One H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes per
# second, and operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 34e12}
BYTES = {"f32": 4, "f64": 8}


def least_seconds(bytes_moved: float, ops: float, kind: str) -> float:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its operations over the peak rate of their type."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


# Operations per state and period: a bracket search is ⌈log2 n⌉ compares, a
# Markov mix 2·n_e, a pow one operation; a dual-number (value and tangent)
# operation counts 3.
def one_asset_sweep_ops(Tm1: int, n_a: int, n_e: int, tangent: bool, paths: int = 1) -> float:
    """The one-asset sweep (kernels 1-4, kernel 2): the backward EGM step
    (expectation 2·n_e, Euler, implied wealth, bracket, lerp, clip, budget,
    envelope: ~20) and the forward step (bracket, lottery weights, mix, two
    aggregates: ~14)."""
    per = 4 * n_e + 2 * log2_ceil(n_a) + 34
    return paths * Tm1 * n_a * n_e * per * (3 if tangent else 1)


def one_asset_sweep_bytes(Tm1: int, n_a: int, n_e: int, tangent: bool, kind: str,
                          paths: int = 1) -> float:
    """Prices in (r, w, and their tangents), the constants (terminal value,
    initial distribution, wealth grid, income grid, income transition) and
    the aggregates out (KD, and with a tangent its tangent and the two
    returned tangents of the price hook's outputs)."""
    n_paths_in = 4 if tangent else 2
    n_out = 4 if tangent else 2
    consts = 2 * n_a * n_e + n_a + n_e + n_e * n_e
    return BYTES[kind] * (paths * (n_paths_in + n_out) * Tm1 + consts)


def two_asset_ops(Tm1: int, n_b: int, n_a: int, n_e: int, which: int,
                  tangent: bool = True, paths: int = 1) -> float:
    """Backward (which = 0): per state and access branch the expectations of
    both marginal values (4·n_e), the brackets on both axes and ~40
    operations. Forward (which = 1): both brackets, the joint lottery's
    weights and 4 corners (~18), the income and access mixes (2·n_e + 4)
    and three aggregates (6)."""
    brackets = 2 * (log2_ceil(n_b) + log2_ceil(n_a))
    per = (4 * n_e + brackets + 40) * 2 if which == 0 else brackets + 2 * n_e + 28
    return paths * Tm1 * n_b * n_a * n_e * 2 * per * (3 if tangent else 1)


def two_asset_bytes(Tm1: int, n_b: int, n_a: int, n_e: int, which: int,
                    tangent: bool = True, paths: int = 1) -> float:
    """FP64. Backward: the four price paths (and tangents) and the terminal
    (V_b, V_a) in, the three policies (and tangents) over every period
    out. Forward: those policies in, the initial distribution in and the
    three aggregates (and tangents) out."""
    N = n_b * n_a * n_e * 2
    mult = 2 if tangent else 1
    policies = paths * 3 * mult * Tm1 * N
    if which == 0:
        return 8 * (paths * 4 * mult * Tm1 + 2 * N + policies)
    return 8 * (policies + N + paths * 3 * mult * Tm1)


def sizes(config: dict) -> tuple:
    """(T − 1, the configuration's state sizes in its dimensions' order)."""
    return (config["T"] - 1, *(d["n"] for d in config["dimensions"].values()))


def roofline_share(run, match, least_per_launch: float):
    """100 × the launches' least time over their device time in the traced
    window, for the kernel whose name `match` accepts; None where the trace
    holds no such kernel."""
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel(match)
    if launches == 0 or seconds <= 0.0:
        return None
    return 100.0 * launches * least_per_launch / seconds
