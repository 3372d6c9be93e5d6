"""PyTorch port: the source-range rule kernel 7 relies on, on the CPU.

Kernel 7 (`forward_scan_kernel` with its pre-pass `forward_scan_prep_kernel`,
`hank_tpu_torch/csrc/household_sweep.cu`) sums each destination's lottery
over a range of sources that the pre-pass finds by two binary searches on a
clamped policy row it has checked to be non-decreasing, and there takes
every source of the range; a row that fails the check gets the whole row,
[0, n_a), marked to keep the previous kernel 7's test (gl < P[a] < gh) on
each source. Its sums are the previous kernel's bit for bit only if, on
every row, the sources it keeps are the ones the previous kernel's full
scan keeps, in the same order. The functions below transcribe both in
float32 (the clamp with C's fminf/fmaxf, which drop a NaN, the check, the
searches, the packing of a range and its mark into one int), and the tests
hold them equal on seeded and hypothesis-drawn rows: monotone, with ties,
with policies on the knots, clamped at either end, out of order, with NaN.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

f32 = np.float32


def clamp(pol, grid):
    """fminf(fmaxf(p, g_0), g_top): a NaN policy becomes g_0."""
    return np.fmin(np.fmax(pol.astype(f32), grid[0]), grid[-1]).astype(f32)


def hat_supports(grid):
    """(glo, ghi) of each destination, as both kernels build them."""
    g = grid.astype(f32)
    n = len(g)
    glo = np.array([g[0] - (g[1] - g[0]) if i == 0 else g[i - 1] for i in range(n)], f32)
    ghi = np.array([g[-1] + (g[-1] - g[-2]) if i == n - 1 else g[i + 1] for i in range(n)],
                   f32)
    return glo, ghi


def previous_sources(P, gl, gh) -> list:
    """The previous kernel 7's scan: every a with gl < P[a] < gh, ascending."""
    return [a for a, p in enumerate(P) if p > gl and p < gh]


def row_is_non_decreasing(P) -> bool:
    """The pre-pass's check: P[a] <= P[a+1] for every a; a NaN fails it."""
    return all(P[a] <= P[a + 1] for a in range(len(P) - 1))


TESTED = 0x8000                                       # bit 15: a fallback row


def pack(begin: int, end: int, tested: bool = False) -> int:
    value = begin | (end << 16) | (TESTED if tested else 0)
    assert 0 <= value < 2 ** 31 and begin < TESTED    # a non-negative int32
    return value


def prep_range(P, gl, gh, mono: bool) -> int:
    """The pre-pass's packed range of one destination: the searches on a
    checked row, the whole row marked for the test otherwise."""
    n = len(P)
    begin, end = 0, n
    if mono:
        hi = n                                        # the first a with P[a] > gl
        while begin < hi:
            mid = (begin + hi) >> 1
            if P[mid] > gl:
                hi = mid
            else:
                begin = mid + 1
        lo = begin                                    # the first a >= begin with !(P[a] < gh)
        while lo < end:
            mid = (lo + end) >> 1
            if P[mid] < gh:
                lo = mid + 1
            else:
                end = mid
    return pack(begin, end, tested=not mono)


def kernel_sources(P, packed: int, gl, gh) -> list:
    """The serial kernel's loop over a packed range: every source, or those
    that pass the test where the range is marked."""
    sources = range(packed & 0x7FFF, packed >> 16)
    if packed & TESTED:
        return [a for a in sources if P[a] > gl and P[a] < gh]
    return list(sources)


def check_row(pol, grid) -> bool:
    """Both rules on every destination of one policy row; returns whether
    the row took the ranges (True) or the fallback."""
    P = clamp(pol, grid)
    mono = row_is_non_decreasing(P)
    for gl, gh in zip(*hat_supports(grid)):
        packed = prep_range(P, gl, gh, mono)
        assert kernel_sources(P, packed, gl, gh) == previous_sources(P, gl, gh)
        assert packed == (pack(0, len(P), tested=True) if not mono else packed & ~TESTED)
    return mono


def seeded_rows(seed, n_a=60):
    rng = np.random.default_rng(seed)
    grid = np.sort(rng.uniform(0.0, 50.0, n_a)).astype(f32)
    grid[0] = f32(0.0)
    smooth = np.sort(rng.uniform(-5.0, 60.0, n_a)).astype(f32)
    ties = np.sort(rng.choice(rng.uniform(-5.0, 60.0, n_a // 4), n_a)).astype(f32)
    on_knots = np.sort(np.concatenate([grid[::2], rng.uniform(-5.0, 60.0,
                                                               n_a - len(grid[::2]))])).astype(f32)
    noisy = (smooth * (1.0 + 0.01 * rng.normal(size=n_a))).astype(f32)
    noisy[n_a // 2], noisy[n_a // 2 + 1] = noisy[n_a // 2 + 1], noisy[n_a // 2]
    with_nan = smooth.copy()
    with_nan[n_a // 3] = np.nan
    return grid, {"smooth": smooth, "ties": ties, "on_knots": on_knots,
                  "below": np.full(n_a, -1.0, f32), "above": np.full(n_a, 99.0, f32),
                  "both_ends": np.where(np.arange(n_a) < n_a // 2, -1.0, 99.0).astype(f32),
                  "noisy": noisy, "with_nan": with_nan}


@pytest.mark.parametrize("seed", range(5))
def test_ranges_keep_the_previous_sources_on_seeded_rows(seed):
    grid, rows = seeded_rows(seed)
    took_ranges = {name: check_row(pol, grid) for name, pol in rows.items()}
    # A NaN policy clamps to g_0 and bends the row back: the full scan.
    assert took_ranges == {"smooth": True, "ties": True, "on_knots": True, "below": True,
                           "above": True, "both_ends": True, "noisy": False,
                           "with_nan": False}


def test_policies_on_the_knots_and_at_the_ends():
    """A policy on knot b belongs to destination b alone (strict tests at
    both ends of the support); clamped policies pile on the end knots."""
    grid = np.array([0.0, 1.0, 2.0, 3.0], f32)
    P = np.array([0.0, 0.0, 1.0, 1.0, 1.5, 2.0, 3.0, 3.0], f32)
    glo, ghi = hat_supports(grid)
    assert [previous_sources(P, glo[b], ghi[b]) for b in range(4)] == \
        [[0, 1], [2, 3, 4], [4, 5], [6, 7]]
    for b in range(4):
        packed = prep_range(P, glo[b], ghi[b], True)
        assert kernel_sources(P, packed, glo[b], ghi[b]) == previous_sources(P, glo[b], ghi[b])


def test_a_nan_in_a_clamped_row_takes_the_full_scan():
    """fmaxf drops a NaN policy (it clamps to g_0); a NaN left in a clamped
    row (a NaN grid end) fails the check and takes [0, n_a)."""
    grid = np.array([0.0, 1.0, 2.0, 3.0], f32)
    assert clamp(np.array([np.nan], f32), grid)[0] == f32(0.0)
    P = np.array([0.0, np.nan, 2.0, 3.0], f32)
    assert not row_is_non_decreasing(P)
    glo, ghi = hat_supports(grid)
    for b in range(4):
        packed = prep_range(P, glo[b], ghi[b], False)
        assert packed == pack(0, 4, tested=True)
        assert kernel_sources(P, packed, glo[b], ghi[b]) == previous_sources(P, glo[b], ghi[b])


def test_the_packed_range_holds_every_grid_that_fits():
    """Every grid the previous kernel 7 fits has n_a ≤ 7135 (one income
    state: 4·(8·n_a + 1 + 1024) ≤ 232,448 bytes), well inside the 15 bits
    the packing keeps non-negative."""
    assert 4 * (8 * 7135 + 1 + 1024) <= 232_448 < 4 * (8 * 7136 + 1 + 1024)
    for n in (2, 7135, 32767):
        for tested in (False, True):
            assert kernel_sources(np.zeros(n, f32), pack(0, n, tested), f32(-1),
                                  f32(1)) == list(range(n))
        assert kernel_sources(np.zeros(n, f32), pack(0, n, True), f32(0), f32(1)) == []


def finite():
    return st.floats(-100.0, 100.0, width=32, allow_nan=False)


@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_ranges_keep_the_previous_sources_on_drawn_rows(data):
    steps = data.draw(st.lists(st.floats(0.0625, 10.0, width=32), min_size=2, max_size=12))
    grid = np.cumsum(np.array(steps, f32)).astype(f32)
    values = data.draw(st.lists(st.one_of(finite(), st.sampled_from([float(g) for g in grid])),
                                min_size=2, max_size=40))
    pol = np.array(values, f32)
    if data.draw(st.booleans()):
        pol = np.sort(pol)
    if data.draw(st.booleans()):
        pol[data.draw(st.integers(0, len(pol) - 1))] = np.nan
    check_row(pol, grid)


def test_the_register_ab_inputs_take_the_ranges_with_a_pile_at_g0():
    """`tools/scan_owned_ab.py`'s seeded inputs (here at 60×7, 3 periods):
    every clamped row takes the ranges, the sources match the previous
    scan's, the lowest income row piles sources on g_0 (the long range the
    borrowing limit makes), and D0 is a distribution. Without a card the
    tool refuses to run."""
    import torch

    from hank_tpu_torch.tools import scan_owned_ab

    pols, D0, grid, Pi = (t.numpy() for t in scan_owned_ab.scan_input(3, 60, 7, 0, "cpu"))
    assert pols.shape == (3, 60, 7) and D0.shape == (60, 7) and Pi.shape == (7, 7)
    assert abs(float(D0.sum()) - 1.0) < 1e-5 and np.allclose(Pi.sum(axis=1), 1.0, atol=1e-6)
    for t in range(3):
        for e in range(7):
            assert check_row(pols[t, :, e], grid)
    assert (pols[:, :, 0] <= grid[0]).sum(axis=1).min() >= 3
    if not torch.cuda.is_available():
        assert scan_owned_ab.main([]) == 1
