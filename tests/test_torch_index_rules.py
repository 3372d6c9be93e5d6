"""PyTorch port: the index rules kernels 1-4 rely on, on the CPU.

`household_sweep_jvp_kernel` (kernel 1, f32) and
`household_sweep_ranged_kernel` (kernels 3-4 in f32, kernel 2 in f64;
`hank_tpu_torch/csrc/household_sweep.cu`) replace two O(n_a) scans of the
counting kernel template by binary searches on rows they have checked to be
non-decreasing. Their outputs are bit for bit the template's only if, on
every such row, the searches give the template's integers. The functions
below transcribe the kernels' loops line for line (values in the kernel's
type, the same comparisons) and the template's scans beside them; the
tests hold them equal in float32 and float64 on seeded and
hypothesis-drawn rows: monotone, with ties, with knots equal to queries,
non-monotone, with NaN. A last test transcribes where a batched launch
writes its fallback counts.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

f32 = np.float32
DTYPES = pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])


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


def hat_supports(grid, dt=f32):
    """(glo, ghi) of each destination, as the kernel builds them."""
    g = grid.astype(dt)
    n = len(g)
    glo = np.array([g[0] - (g[1] - g[0]) if i == 0 else g[i - 1] for i in range(n)], dt)
    ghi = np.array([g[-1] + (g[-1] - g[-2]) if i == n - 1 else g[i + 1] for i in range(n)],
                   dt)
    return glo, ghi


def check_row(K, queries, grid):
    """Both rules on one row K (as implied wealth) and on clip(K) as the
    clamped policy over `grid`, in K's type."""
    mono = row_is_non_decreasing(K)
    if mono:
        for x in queries:
            assert kernel_lower_bound(K, x) == template_count(K, x)
        P = np.minimum(np.maximum(K, grid[0]), grid[-1]).astype(K.dtype)
        assert row_is_non_decreasing(P)
        for gl, gh in zip(*hat_supports(grid, K.dtype)):
            assert list(kernel_source_range(P, gl, gh)) == template_sources(P, gl, gh)
    return mono


def seeded_rows(seed, n_a=60, dt=f32):
    """Rows of the kinds the sweep meets, with the query grid they are read at."""
    rng = np.random.default_rng(seed)
    grid = np.sort(rng.uniform(0.0, 50.0, n_a)).astype(dt)
    grid[0] = dt(0.0)
    smooth = np.sort(rng.uniform(-5.0, 60.0, n_a)).astype(dt)
    ties = np.sort(rng.choice(rng.uniform(-5.0, 60.0, n_a // 4), n_a)).astype(dt)
    on_knots = np.sort(np.concatenate([grid[::2], rng.uniform(-5.0, 60.0, n_a - len(grid[::2]))])
                       ).astype(dt)
    flat = np.full(n_a, grid[7], dt)
    bent = smooth.copy()
    bent[n_a // 2] = bent[n_a // 2 - 3]             # bends back
    with_nan = smooth.copy()
    with_nan[n_a // 3] = np.nan
    return grid, {"smooth": smooth, "ties": ties, "on_knots": on_knots, "flat": flat,
                  "bent": bent, "with_nan": with_nan}


@DTYPES
@pytest.mark.parametrize("seed", range(5))
def test_rules_on_seeded_rows(seed, dt):
    grid, rows = seeded_rows(seed, dt=dt)
    monotone = {name: check_row(K, grid, grid) for name, K in rows.items()}
    assert monotone == {"smooth": True, "ties": True, "on_knots": True, "flat": True,
                        "bent": False, "with_nan": False}


@DTYPES
def test_knots_equal_to_queries_count_as_not_below(dt):
    """A knot equal to the query is not counted (the template's `<`), and
    the lower bound stops at it: the bracket is [K[j-1], K[j]] with
    K[j] == x, the case the template's tie rule serves."""
    K = np.array([0.0, 1.0, 2.0, 2.0, 3.0], dt)
    for x, want in ((dt(2.0), 2), (dt(0.0), 0), (dt(3.0), 4), (dt(3.5), 5), (dt(-1.0), 0)):
        assert kernel_lower_bound(K, x) == template_count(K, x) == want


@DTYPES
def test_source_range_edges(dt):
    """Sources on the upper knot belong to the destination (p <= gh), those
    on the lower knot do not (p > gl), and clamped sources at the grid's
    ends fall to the end destinations only."""
    grid = np.array([0.0, 1.0, 2.0, 3.0], dt)
    P = np.array([0.0, 0.0, 1.0, 1.0, 1.5, 2.0, 3.0, 3.0], dt)
    glo, ghi = hat_supports(grid, dt)
    for b in range(4):
        assert list(kernel_source_range(P, glo[b], ghi[b])) == template_sources(P, glo[b], ghi[b])
    assert template_sources(P, glo[0], ghi[0]) == [0, 1, 2, 3]     # (−1, 1]
    assert template_sources(P, glo[3], ghi[3]) == [6, 7]           # (2, 4]


@DTYPES
def test_the_monotone_check_rejects_nan(dt):
    for K in (np.array([np.nan, 1.0, 2.0], dt), np.array([0.0, np.nan, 2.0], dt),
              np.array([0.0, 1.0, np.nan], dt), np.array([np.nan], dt) * np.ones(3, dt)):
        assert not row_is_non_decreasing(K)
    assert row_is_non_decreasing(np.array([1.0], dt))
    assert row_is_non_decreasing(np.array([-np.inf, 0.0, 0.0, np.inf], dt))


def finite(dt):
    return st.floats(-100.0, 100.0, width=np.dtype(dt).itemsize * 8, allow_nan=False)


@DTYPES
@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_lower_bound_equals_the_count_on_sorted_rows(dt, data):
    values = data.draw(st.lists(finite(dt), min_size=2, max_size=40))
    queries = data.draw(st.lists(finite(dt), min_size=1, max_size=10))
    K = np.sort(np.array(values, dt))
    queries = [dt(q) for q in queries] + list(K)               # queries on the knots too
    for x in queries:
        assert kernel_lower_bound(K, x) == template_count(K, x)


@DTYPES
@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_source_range_equals_the_scan_on_sorted_rows(dt, data):
    values = data.draw(st.lists(finite(dt), min_size=2, max_size=40))
    steps = data.draw(st.lists(st.floats(0.0625, 10.0, width=np.dtype(dt).itemsize * 8),
                               min_size=2, max_size=12))
    grid = np.cumsum(np.array(steps, dt)).astype(dt)
    P = np.minimum(np.maximum(np.sort(np.array(values, dt)), grid[0]), grid[-1]).astype(dt)
    for gl, gh in zip(*hat_supports(grid, dt)):
        assert list(kernel_source_range(P, gl, gh)) == template_sources(P, gl, gh)


@DTYPES
@settings(max_examples=200, deadline=None)
@given(data=st.data())
def test_rows_that_fail_the_check_are_the_unsorted_or_nan_ones(dt, data):
    values = data.draw(st.lists(st.one_of(finite(dt), st.just(float("nan"))),
                                min_size=2, max_size=30))
    K = np.array(values, dt)
    expected = not np.isnan(K).any() and bool(np.all(K[:-1] <= K[1:]))
    assert row_is_non_decreasing(K) == expected


def batched_fallback_counts(implied, policy):
    """Transcription of where a batched launch of
    `household_sweep_ranged_kernel` writes its fallback counts. `implied`
    and `policy` are (B, T-1, n_e, n_a): each path's implied-wealth and
    clamped-policy rows, per period. Block b (thread 0) counts, over its
    periods, the income rows whose check failed, and writes them at
    fallback + 2 * path: [2b] implied wealth, [2b + 1] policy."""
    B = implied.shape[0]
    fallback = np.full(2 * B, -1, np.int32)       # the kernel writes every slot
    for path in range(B):
        fell_k = sum(not row_is_non_decreasing(row) for per in implied[path] for row in per)
        fell_p = sum(not row_is_non_decreasing(row) for per in policy[path] for row in per)
        fallback[2 * path] = fell_k
        fallback[2 * path + 1] = fell_p
    return fallback.reshape(B, 2)


@DTYPES
def test_batched_fallback_counts_move_only_for_the_path_that_fell_back(dt):
    """B = 3 paths of sorted rows; one row of path 1 bends back in one
    period (implied wealth), another is out of order (policy): only row 1
    of the (B, 2) counters moves, by one each."""
    rng = np.random.default_rng(3)
    B, Tm1, n_e, n_a = 3, 4, 2, 9
    implied = np.sort(rng.uniform(-5.0, 60.0, (B, Tm1, n_e, n_a)), axis=-1).astype(dt)
    policy = np.sort(rng.uniform(0.0, 50.0, (B, Tm1, n_e, n_a)), axis=-1).astype(dt)
    assert batched_fallback_counts(implied, policy).tolist() == [[0, 0]] * B
    implied[1, 2, 0, 4] = implied[1, 2, 0, 1]
    policy[1, 0, 1, 6] = policy[1, 0, 1, 2]
    assert batched_fallback_counts(implied, policy).tolist() == [[0, 0], [1, 1], [0, 0]]
