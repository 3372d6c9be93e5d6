"""PyTorch port: the index rules kernel 1 relies on, on the CPU.

`household_sweep_jvp_kernel` (`hank_tpu_torch/csrc/household_sweep.cu`)
replaces two O(n_a) scans of the kernel template by binary searches on rows
it has checked to be non-decreasing. Its output is bit for bit the
template's only if, on every such row, the searches give the template's
integers. The functions below transcribe the kernel's loops line for line
(f32 values, the same comparisons) and the template's scans beside them;
the tests hold them equal on seeded and hypothesis-drawn rows: monotone,
with ties, with knots equal to queries, non-monotone, with NaN.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

f32 = np.float32


def row_is_non_decreasing(K) -> bool:
    """The kernel's check: no k with !(K[k] <= K[k+1]); a NaN fails it."""
    return not any(not (K[k] <= K[k + 1]) for k in range(len(K) - 1))


def template_count(K, x) -> int:
    """The template's bracket: the count of knots below the query."""
    return sum(1 for k in K if k < x)


def kernel_lower_bound(K, x) -> int:
    """The kernel's binary search: the first k with !(K[k] < x)."""
    cnt, hi = 0, len(K)
    while cnt < hi:
        mid = (cnt + hi) >> 1
        if K[mid] < x:
            cnt = mid + 1
        else:
            hi = mid
    return cnt


def template_sources(P, gl, gh) -> list:
    """The template's lottery scan: the sources a with gl < P[a] <= gh, in
    ascending a."""
    return [a for a, p in enumerate(P) if p > gl and p <= gh]


def kernel_source_range(P, gl, gh) -> range:
    """The kernel's two searches: from the first a with P[a] > gl to the
    first with P[a] > gh."""
    n = len(P)
    a_begin, hi = 0, n
    while a_begin < hi:
        mid = (a_begin + hi) >> 1
        if P[mid] > gl:
            hi = mid
        else:
            a_begin = mid + 1
    lo, a_end = a_begin, n
    while lo < a_end:
        mid = (lo + a_end) >> 1
        if P[mid] > gh:
            a_end = mid
        else:
            lo = mid + 1
    return range(a_begin, a_end)


def hat_supports(grid):
    """(glo, ghi) of each destination, as the kernel builds them."""
    g = grid.astype(f32)
    n = len(g)
    glo = np.array([g[0] - (g[1] - g[0]) if i == 0 else g[i - 1] for i in range(n)], f32)
    ghi = np.array([g[-1] + (g[-1] - g[-2]) if i == n - 1 else g[i + 1] for i in range(n)],
                   f32)
    return glo, ghi


def check_row(K, queries, grid):
    """Both rules on one row K (as implied wealth) and on clip(K) as the
    clamped policy over `grid`."""
    mono = row_is_non_decreasing(K)
    if mono:
        for x in queries:
            assert kernel_lower_bound(K, x) == template_count(K, x)
        P = np.minimum(np.maximum(K, grid[0]), grid[-1]).astype(f32)
        assert row_is_non_decreasing(P)
        for gl, gh in zip(*hat_supports(grid)):
            assert list(kernel_source_range(P, gl, gh)) == template_sources(P, gl, gh)
    return mono


def seeded_rows(seed, n_a=60):
    """Rows of the kinds the sweep meets, with the query grid they are read at."""
    rng = np.random.default_rng(seed)
    grid = np.sort(rng.uniform(0.0, 50.0, n_a)).astype(f32)
    grid[0] = f32(0.0)
    smooth = np.sort(rng.uniform(-5.0, 60.0, n_a)).astype(f32)
    ties = np.sort(rng.choice(rng.uniform(-5.0, 60.0, n_a // 4), n_a)).astype(f32)
    on_knots = np.sort(np.concatenate([grid[::2], rng.uniform(-5.0, 60.0, n_a - len(grid[::2]))])
                       ).astype(f32)
    flat = np.full(n_a, grid[7], f32)
    bent = smooth.copy()
    bent[n_a // 2] = bent[n_a // 2 - 3]             # bends back
    with_nan = smooth.copy()
    with_nan[n_a // 3] = np.nan
    return grid, {"smooth": smooth, "ties": ties, "on_knots": on_knots, "flat": flat,
                  "bent": bent, "with_nan": with_nan}


@pytest.mark.parametrize("seed", range(5))
def test_rules_on_seeded_rows(seed):
    grid, rows = seeded_rows(seed)
    monotone = {name: check_row(K, grid, grid) for name, K in rows.items()}
    assert monotone == {"smooth": True, "ties": True, "on_knots": True, "flat": True,
                        "bent": False, "with_nan": False}


def test_knots_equal_to_queries_count_as_not_below():
    """A knot equal to the query is not counted (the template's `<`), and
    the lower bound stops at it: the bracket is [K[j-1], K[j]] with
    K[j] == x, the case the template's tie rule serves."""
    K = np.array([0.0, 1.0, 2.0, 2.0, 3.0], f32)
    for x, want in ((f32(2.0), 2), (f32(0.0), 0), (f32(3.0), 4), (f32(3.5), 5), (f32(-1.0), 0)):
        assert kernel_lower_bound(K, x) == template_count(K, x) == want


def test_source_range_edges():
    """Sources on the upper knot belong to the destination (p <= gh), those
    on the lower knot do not (p > gl), and clamped sources at the grid's
    ends fall to the end destinations only."""
    grid = np.array([0.0, 1.0, 2.0, 3.0], f32)
    P = np.array([0.0, 0.0, 1.0, 1.0, 1.5, 2.0, 3.0, 3.0], f32)
    glo, ghi = hat_supports(grid)
    for b in range(4):
        assert list(kernel_source_range(P, glo[b], ghi[b])) == template_sources(P, glo[b], ghi[b])
    assert template_sources(P, glo[0], ghi[0]) == [0, 1, 2, 3]     # (−1, 1]
    assert template_sources(P, glo[3], ghi[3]) == [6, 7]           # (2, 4]


def test_the_monotone_check_rejects_nan():
    for K in (np.array([np.nan, 1.0, 2.0], f32), np.array([0.0, np.nan, 2.0], f32),
              np.array([0.0, 1.0, np.nan], f32), np.array([np.nan], f32) * np.ones(3, f32)):
        assert not row_is_non_decreasing(K)
    assert row_is_non_decreasing(np.array([1.0], f32))
    assert row_is_non_decreasing(np.array([-np.inf, 0.0, 0.0, np.inf], f32))


finite = st.floats(-100.0, 100.0, width=32, allow_nan=False)


@settings(max_examples=300, deadline=None)
@given(st.lists(finite, min_size=2, max_size=40), st.lists(finite, min_size=1, max_size=10))
def test_lower_bound_equals_the_count_on_sorted_rows(values, queries):
    K = np.sort(np.array(values, f32))
    queries = [f32(q) for q in queries] + list(K)              # queries on the knots too
    for x in queries:
        assert kernel_lower_bound(K, x) == template_count(K, x)


@settings(max_examples=300, deadline=None)
@given(st.lists(finite, min_size=2, max_size=40),
       st.lists(st.floats(0.0625, 10.0, width=32), min_size=2, max_size=12))
def test_source_range_equals_the_scan_on_sorted_rows(values, steps):
    grid = np.cumsum(np.array(steps, f32)).astype(f32)
    P = np.minimum(np.maximum(np.sort(np.array(values, f32)), grid[0]), grid[-1]).astype(f32)
    for gl, gh in zip(*hat_supports(grid)):
        assert list(kernel_source_range(P, gl, gh)) == template_sources(P, gl, gh)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(finite, st.just(float("nan"))), min_size=2, max_size=30))
def test_rows_that_fail_the_check_are_the_unsorted_or_nan_ones(values):
    K = np.array(values, f32)
    expected = not np.isnan(K).any() and bool(np.all(K[:-1] <= K[1:]))
    assert row_is_non_decreasing(K) == expected
