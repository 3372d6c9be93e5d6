"""PyTorch port: the schedule of kernel 6 on a thread-block cluster, on the CPU.

`two_asset_fwd_cluster_kernel` (`hank_tpu_torch/csrc/household_sweep2.cu`)
is held bit for bit to the previous kernel 6, `two_asset_fwd_kernel`. That
holds only if every sum keeps its terms, their roundings and their order
under the new schedule. The functions below transcribe both kernels line for
line in numpy float32, with the kernels' roundings (an FMA is one rounding
of the exact product plus the addend: the product of two float32 is exact in
float64, and rounding that sum to float32 is the FMA but for a double
rounding, which both transcriptions share):

  - `previous_kernel`: groups one after another; per destination row j a
    list of the row's sources in ascending order, built by warp ballots over
    chunks of 32; one lane per column m walks the list and skips the
    sources off its column; mixing and the aggregates per period.
  - `cluster_kernel`: the groups split over the ranks of a cluster (group g
    on rank g mod C); per source its brackets; bitmaps of each row's and
    column's sources; per destination its count before every 2^shift-th
    bitmap word and a place for its list (warp scans and one atomicAdd per
    warp, in an order the test varies); each source computes its weights
    and its terms at its four corners and writes them at their ranks; one
    thread per destination sums its list; mixing by cells (rank r mixes its
    cells of every group); the aggregates after the recursion from each
    period's D, in the previous kernel's thread order.
  - `cluster_smem_bytes`: the kernel's shared memory per block and the
    count shift it picks (`fwd_cluster_smem_bytes`, `fwd_cluster_shift`).

The tests hold the two bit for bit equal, at clusters of 3, 5 and 10 blocks,
at count shifts 0 to 4 and in two placements of the lists, hold them to the
plain version
`fused2_forward_jvp_reference` at the 5e-5·max(scale, 1) bound of
`tests/test_torch_fused2.py`, on the small two-asset grid (24×12×n_e×2,
T=12; here n_e = 5, so that the ten (income, access) groups split over
clusters of 5 and 10 as they do at the published width) with seeded and
hypothesis-drawn policies: smooth draws, sources piled at the liquid
borrowing limit (two rows holding most sources), policies on the knots,
below the first knot and above the last, and one NaN policy; and hold the
kernel's shared memory to every grid the previous kernel 6 takes with at
least 6 knots on each asset axis.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hank_tpu_torch.ops import fused_sweep2 as fs2
from tests.test_torch_common import build_small_two_asset_torch

torch.set_num_threads(1)
f32 = np.float32
THREADS = 1024                  # both kernels' block size
WARPS = THREADS // 32
SMEM = 232_448                  # dynamic shared memory of one block (227 KB)
KEYS = ("B", "A", "C")


def fma(a, b, c):
    """float32 FMA: the exact product plus c, rounded once."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def lottery(g, p, dp):
    """`lottery` of household_sweep2.cu on a vector of sources: bracket
    jc in [1, n-1] (the count of knots below p), weight w = clip(raw, 0, 1)
    and its tangent with torch's tie rule."""
    n = len(g)
    jc = np.clip((g[None, :] < p[:, None]).sum(axis=1), 1, n - 1)
    h = (g[jc] - g[jc - 1]).astype(f32)
    raw = ((p - g[jc - 1]) / h).astype(f32)
    w = np.where(raw < 0, f32(0), np.where(raw > 1, f32(1), raw)).astype(f32)
    d = np.where((raw > 0) & (raw < 1), f32(1),
                 np.where((raw == 0) | (raw == 1), f32(0.5), f32(0))).astype(f32)
    return jc, w, (d * (dp / h).astype(f32)).astype(f32)


def mix(H, dH, Pi, Pacc, e2, acc2):
    """One mixed cell: income then access, access outer and income inner,
    `x += H * Pi` and `Dn += x * Pacc` as FMAs."""
    NE = Pi.shape[0]
    Dn = dDn = np.zeros(H.shape[:-1], f32)
    for acc in range(2):
        x = dx = np.zeros(H.shape[:-1], f32)
        for e in range(NE):
            x = fma(H[..., 2 * e + acc], Pi[e, e2], x)
            dx = fma(dH[..., 2 * e + acc], Pi[e, e2], dx)
        Dn = fma(x, Pacc[acc, acc2], Dn)
        dDn = fma(dx, Pacc[acc, acc2], dDn)
    return Dn, dDn


def aggregates(D, dD, pol, dpol):
    """One period's six aggregates from D, dD (N4,) in the kernels' order:
    thread tid sums k = tid + 1024 i, then warp butterflies and warp 0's."""
    N4 = D.size
    s = np.zeros((6, THREADS), f32)
    for k0 in range(0, N4, THREADS):
        k = np.arange(k0, min(k0 + THREADS, N4))
        tid = k - k0
        b, a, c = pol[0][k], pol[1][k], pol[2][k]
        Dn, dDn = D[k], dD[k]
        s[0, tid] = fma(b, Dn, s[0, tid])
        s[1, tid] = fma(a, Dn, s[1, tid])
        s[2, tid] = fma(c, Dn, s[2, tid])
        for q, (x, dx) in enumerate(((b, dpol[0][k]), (a, dpol[1][k]), (c, dpol[2][k]))):
            s[3 + q, tid] = (s[3 + q, tid] + fma(dx, Dn, (x * dDn).astype(f32))).astype(f32)
    v = s.reshape(6, WARPS, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, :, lane ^ o]).astype(f32)
    x = v[:, :, 0]                                   # lane 0 of each warp -> red
    for o in (16, 8, 4, 2, 1):
        x = (x + x[:, lane ^ o]).astype(f32)
    return x[:, 0]


def inputs(policies, dpolicies, D0):
    pol = np.stack([policies[k].numpy() for k in KEYS]).astype(f32)
    dpol = np.stack([dpolicies[k].numpy() for k in KEYS]).astype(f32)
    Tm1, NB, NA, NE = pol.shape[1:5]
    return (pol.reshape(3, Tm1, -1), dpol.reshape(3, Tm1, -1), D0.numpy().reshape(-1).astype(f32),
            (Tm1, NB, NA, NE))


def previous_kernel(policies, dpolicies, D0, grids):
    """Transcription of `two_asset_fwd_kernel`: (6, T-1) outputs."""
    pol, dpol, D0, (Tm1, NB, NA, NE) = inputs(policies, dpolicies, D0)
    bg, ag, Pi, Pacc = grids
    NS, NG = NB * NA, 2 * NE
    D, dD = D0.copy(), np.zeros_like(D0)
    out = np.zeros((6, Tm1), f32)
    lanes = np.arange(NA)
    for t in range(Tm1):
        H, dH = np.zeros(NS * NG, f32), np.zeros(NS * NG, f32)
        for grp in range(NG):
            k = np.arange(NS) * NG + grp
            jb, wb, dwb = lottery(bg, pol[0, t, k], dpol[0, t, k])
            ja, wa, dwa = lottery(ag, pol[1, t, k], dpol[1, t, k])
            src, dsrc = D[k], dD[k]
            for j in range(NB):
                lst = []                      # the warp's ballots, chunk by chunk
                for c in range(0, NS, 32):
                    s = np.arange(c, min(c + 32, NS))
                    lst.extend(s[(jb[s] == j) | (jb[s] - 1 == j)])
                v, dv = np.zeros(NA, f32), np.zeros(NA, f32)     # one lane per column m
                for s in lst:
                    lo, hi = lanes == ja[s] - 1, lanes == ja[s]  # any other lane skips s
                    wm = np.where(lo, f32(1) - wa[s], wa[s]).astype(f32)
                    dwm = np.where(lo, -dwa[s], dwa[s]).astype(f32)
                    low = jb[s] - 1 == j
                    wj = f32(1) - wb[s] if low else wb[s]
                    dwj = -dwb[s] if low else dwb[s]
                    mass = f32(wj * src[s])
                    A = fma(dwj, src[s], f32(wj * dsrc[s]))
                    hit = lo | hi
                    v = np.where(hit, fma(mass, wm, v), v)
                    dv = np.where(hit, (dv + fma(mass, dwm, (A * wm).astype(f32))).astype(f32), dv)
                H[(j * NA + lanes) * NG + grp] = v
                dH[(j * NA + lanes) * NG + grp] = dv
        g2 = np.arange(NS * NG) % NG
        D, dD = mix(H.reshape(NS, NG)[np.arange(NS * NG) // NG],
                    dH.reshape(NS, NG)[np.arange(NS * NG) // NG], Pi, Pacc, g2 >> 1, g2 & 1)
        out[:, t] = aggregates(D, dD, pol[:, t], dpol[:, t])
    return out


def popc(x):
    return np.bitwise_count(np.asarray(x, np.uint32)).astype(np.int64)


def cluster_kernel(policies, dpolicies, D0, grids, C, warp_order=None, shift=0):
    """Transcription of `two_asset_fwd_cluster_kernel` on a cluster of C
    blocks: (6, T-1) outputs. `warp_order` is the order in which the warps
    take their lists' places (any order gives the same sums); each
    destination keeps its count before every 2^`shift`-th bitmap word."""
    pol, dpol, D0, (Tm1, NB, NA, NE) = inputs(policies, dpolicies, D0)
    bg, ag, Pi, Pacc = grids
    NS, NG = NB * NA, 2 * NE
    N4, nw, cells = NS * NG, (NS + 31) // 32, (NS + C - 1) // C
    order = np.arange(WARPS) if warp_order is None else np.asarray(warp_order)
    owned = {g: (g % C, g // C) for g in range(NG)}           # group -> (rank, slot)
    D = {g: (D0[np.arange(NS) * NG + g].copy(), np.zeros(NS, f32)) for g in range(NG)}
    Dpath = np.zeros((Tm1, 2, N4), f32)
    d_all = np.arange(NS)
    j_all, m_all = d_all // NA, d_all % NA
    for t in range(Tm1):
        Hc = np.zeros((C, 2, NG, cells), f32)                 # every block's cells
        for rank in range(C):
            for g in (g for g in range(NG) if owned[g][0] == rank):
                # L. Brackets and bitmaps.
                k = np.arange(NS) * NG + g
                jb, wb, dwb = lottery(bg, pol[0, t, k], dpol[0, t, k])
                ja, wa, dwa = lottery(ag, pol[1, t, k], dpol[1, t, k])
                rowbits = np.zeros((NB, nw), np.uint32)
                colbits = np.zeros((NA, nw), np.uint32)
                bit = (np.uint32(1) << (d_all % 32).astype(np.uint32)).astype(np.uint32)
                for rows, bits, idx in ((rowbits, bit, jb - 1), (rowbits, bit, jb),
                                        (colbits, bit, ja - 1), (colbits, bit, ja)):
                    np.bitwise_or.at(rows, (idx, d_all // 32), bits)
                # R. Counts before every 2^shift-th word, totals, places (warp
                #    by warp).
                pair = popc(rowbits[j_all] & colbits[m_all])            # (NS, nw)
                cnt = pair.sum(axis=1)
                before = (np.cumsum(pair, axis=1) - pair)[:, ::1 << shift]
                per_thread = np.zeros(THREADS, np.int64)
                np.add.at(per_thread, d_all % THREADS, cnt)
                offs_thread = np.zeros(THREADS, np.int64)
                alloc = 0
                for w in order:
                    tids = np.arange(32 * w, 32 * w + 32)
                    incl = np.cumsum(per_thread[tids])
                    offs_thread[tids] = alloc + incl - per_thread[tids]
                    alloc += incl[-1]
                offs = offs_thread[d_all % THREADS].copy()
                second = d_all >= THREADS                              # a thread's 2nd destination
                offs[second] += cnt[d_all[second] - THREADS]
                assert alloc == 4 * NS
                # Each source's terms at its four corners, written at their
                # ranks: the kept count, the words after it, the bits below.
                src, dsrc = D[g]
                mass, T = np.zeros((NS, 2), f32), np.zeros((NS, 2, 2), f32)
                wmc = np.stack([f32(1) - wa, wa], axis=1).astype(f32)
                for rc in range(2):
                    wj = (f32(1) - wb if rc == 0 else wb).astype(f32)
                    dwj = -dwb if rc == 0 else dwb
                    mass[:, rc] = (wj * src).astype(f32)
                    A = fma(dwj, src, (wj * dsrc).astype(f32))
                    for cc in range(2):
                        dwm = -dwa if cc == 0 else dwa
                        T[:, rc, cc] = fma(mass[:, rc], dwm, (A * wmc[:, cc]).astype(f32))
                lists = np.full((4 * NS, 3), np.nan, f32)
                w_s, below = d_all // 32, (np.uint32(1) << (d_all % 32).astype(np.uint32)) - 1
                first = w_s >> shift << shift
                for rc in range(2):
                    j = jb - 1 + rc
                    for cc in range(2):
                        m = ja - 1 + cc
                        d = j * NA + m
                        rank_ = (before[d, w_s >> shift]
                                 + popc(rowbits[j, w_s] & colbits[m, w_s] & below))
                        for u in range((1 << shift) - 1):
                            wu = first + u
                            wc = np.minimum(wu, nw - 1)
                            rank_ += np.where(wu < w_s, popc(rowbits[j, wc] & colbits[m, wc]), 0)
                        lists[offs[d] + rank_] = np.stack([mass[:, rc], wmc[:, cc], T[:, rc, cc]], 1)
                # One thread per destination sums its list in order.
                v, dv = np.zeros(NS, f32), np.zeros(NS, f32)
                for q in range(int(cnt.max())):
                    live = q < cnt
                    e = lists[offs[live] + q]
                    v[live] = fma(e[:, 0], e[:, 1], v[live])
                    dv[live] = (dv[live] + e[:, 2]).astype(f32)
                owner = d_all // cells
                Hc[owner, 0, g, d_all - owner * cells] = v
                Hc[owner, 1, g, d_all - owner * cells] = dv
        # M by cells: rank r mixes its cells of every group.
        for rank in range(C):
            my = max(0, min(NS - rank * cells, cells))
            i = np.arange(my * NG)
            g2, c = i % NG, i // NG
            Dn, dDn = mix(Hc[rank, 0][:, c].T, Hc[rank, 1][:, c].T, Pi, Pacc, g2 >> 1, g2 & 1)
            s = rank * cells + c
            for g in range(NG):
                sel = g2 == g
                D[g][0][s[sel]], D[g][1][s[sel]] = Dn[sel], dDn[sel]
            Dpath[t, 0, s * NG + g2], Dpath[t, 1, s * NG + g2] = Dn, dDn
    out = np.zeros((6, Tm1), f32)
    for t in range(Tm1):                                       # block t mod C
        out[:, t] = aggregates(Dpath[t, 0], Dpath[t, 1], pol[:, t], dpol[:, t])
    return out


def previous_smem_bytes(NB, NA, NE):
    """Transcription of `fwd_smem_bytes` (the previous kernel 6)."""
    NS, N4 = NB * NA, NB * NA * NE * 2
    return 4 * (4 * N4 + 6 * NS + NB + NA + NE * NE + 4 + 6 * WARPS) + 4 * 2 * NS + 2 * WARPS * NS


def cluster_smem_bytes(NB, NA, NE, C):
    """Transcription of `fwd_cluster_shift` and `fwd_cluster_smem_bytes`:
    the least count shift whose layout fits in a block (or the one keeping
    a single count per destination), and the bytes per block there."""
    NS, NG = NB * NA, 2 * NE
    G, nw, cells = -(-NG // C), -(-NS // 32), -(-NS // C)

    def size(shift):
        counts = ((nw - 1) >> shift) + 1
        return (16 * 4 * NS + 4 * (2 * NG * cells + 2 * G * NS + NB + NA + NE * NE + 4 + 6 * WARPS)
                + 4 * ((NB + NA) * nw + NS + 4) + 2 * NS * counts)

    shift = 0
    while (1 << shift) < nw and size(shift) > SMEM:
        shift += 1
    return shift, size(shift)


# ── inputs ─────────────────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def setup():
    model = build_small_two_asset_torch(n_e=5)
    m32 = fs2.cast_model(model, torch.float32)
    liquid, illiq, income, access = fs2._dims(m32)
    grids = tuple(x.numpy().astype(f32) for x in
                  (liquid.grid, illiq.grid, income.transition, access.transition))
    return m32, grids


def draw(model, seed, piled=0.0, on_knots=0.0, outside=0.0, nan=False, scale=1.0):
    """Seeded policies and tangents on the model's grids, and a distribution.
    `piled`: share of sources at the liquid borrowing limit; `on_knots`: share
    of policies on a knot; `outside`: share below the first or above the
    last knot."""
    rng = np.random.default_rng(seed)
    liquid, illiq, income, _ = fs2._dims(model)
    Tm1 = model.compspec.T - 1
    shape = (Tm1, liquid.n, illiq.n, income.n, 2)
    bg, ag = liquid.grid.numpy(), illiq.grid.numpy()
    pol = {"B": rng.uniform(bg[0], bg[-1], shape), "A": rng.uniform(ag[0], ag[-1], shape),
           "C": rng.uniform(0.1, 2.0, shape)}
    for key, g in (("B", bg), ("A", ag)):
        p = pol[key]
        knots = rng.random(shape) < on_knots
        p[knots] = g[rng.integers(0, len(g), knots.sum())]
        out = rng.random(shape) < outside
        p[out] = np.where(rng.random(out.sum()) < 0.5, g[0] - rng.uniform(0.1, 5, out.sum()),
                          g[-1] + rng.uniform(0.1, 5, out.sum()))
    pol["B"][rng.random(shape) < piled] = bg[0]
    if nan:
        pol["B"][tuple(int(rng.integers(0, n)) for n in shape)] = np.nan
    dpol = {k: scale * rng.normal(size=shape) for k in KEYS}
    D0 = rng.random((liquid.n, illiq.n, income.n, 2))
    D0 /= D0.sum()
    t = lambda a: torch.tensor(a, dtype=torch.float32)       # noqa: E731
    return ({k: t(v) for k, v in pol.items()}, {k: t(v) for k, v in dpol.items()}, t(D0))


def same_bits(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def check(model, grids, policies, dpolicies, D0, clusters=(5, 10)):
    """Both transcriptions bit for bit at every cluster size, and within the
    plain version's bound (NaNs where it has NaNs)."""
    old = previous_kernel(policies, dpolicies, D0, grids)
    for C in clusters:
        assert same_bits(cluster_kernel(policies, dpolicies, D0, grids, C), old), C
    aggs, daggs = fs2.fused2_forward_jvp_reference(policies, dpolicies, D0, model)
    ref = np.stack([*(aggs[k].numpy() for k in KEYS), *(daggs[k].numpy() for k in KEYS)])
    assert np.array_equal(np.isnan(old), np.isnan(ref))
    fin = ~np.isnan(ref)
    scale = float(np.max(np.abs(ref[fin]))) if fin.any() else 0.0
    assert float(np.max(np.abs(old[fin] - ref[fin]), initial=0.0)) <= 5e-5 * max(scale, 1.0)
    return old


# ── tests ──────────────────────────────────────────────────────────────────

@pytest.mark.parametrize("seed", [0, 1])
def test_schedules_agree_on_seeded_policies(setup, seed):
    model, grids = setup
    out = check(model, grids, *draw(model, seed), clusters=(3, 5, 10))
    assert np.isfinite(out).all()


def test_sources_piled_at_the_borrowing_limit(setup):
    """Most sources at the liquid limit: rows 0 and 1 hold most of them,
    the case that set the previous kernel's time."""
    model, grids = setup
    policies, dpolicies, D0 = draw(model, 2, piled=0.8)
    jb = (grids[0][None, :] < policies["B"].numpy().reshape(-1)[:, None]).sum(1).clip(1)
    assert (jb == 1).mean() > 0.75
    check(model, grids, policies, dpolicies, D0)


def test_policies_on_and_beyond_the_knots(setup):
    model, grids = setup
    check(model, grids, *draw(model, 3, on_knots=0.3, outside=0.2))


def test_one_nan_policy(setup):
    """A NaN policy takes bracket 1 and spreads NaN through the mixing; both
    schedules give the same bits, NaNs included, and NaN where the plain
    version has it."""
    model, grids = setup
    out = check(model, grids, *draw(model, 4, nan=True))
    assert np.isnan(out).any() and not np.isnan(out).all()


def test_where_the_lists_lie_does_not_change_the_sums(setup):
    """The warps take their lists' places in an order the hardware picks
    (one atomicAdd each); the sums do not depend on it."""
    model, grids = setup
    policies, dpolicies, D0 = draw(model, 5, piled=0.5)
    rng = np.random.default_rng(0)
    base = cluster_kernel(policies, dpolicies, D0, grids, 10)
    for _ in range(2):
        assert same_bits(cluster_kernel(policies, dpolicies, D0, grids, 10,
                                        warp_order=rng.permutation(WARPS)), base)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), piled=st.floats(0.0, 0.9),
       on_knots=st.floats(0.0, 0.5), outside=st.floats(0.0, 0.3),
       scale=st.sampled_from([1e-3, 1.0, 1e3]))
def test_schedules_agree_on_drawn_policies(setup, seed, piled, on_knots, outside, scale):
    model, grids = setup
    check(model, grids, *draw(model, seed, piled, on_knots, outside, scale=scale))


@pytest.mark.parametrize("shift", [1, 2, 4])
def test_count_shift_does_not_change_the_ranks(setup, shift):
    """A destination that keeps its count before every 2^shift-th word only
    (the room a large grid needs) adds the words after it: the same ranks,
    the same bits. At shift 4 one count per destination is left (9 words)."""
    model, grids = setup
    policies, dpolicies, D0 = draw(model, 9, piled=0.5, on_knots=0.2)
    base = cluster_kernel(policies, dpolicies, D0, grids, 10)
    assert same_bits(cluster_kernel(policies, dpolicies, D0, grids, 10, shift=shift), base)


def test_cluster_kernel_takes_the_previous_kernels_grids():
    """Every grid (n_b, n_a ≥ 6, n_b·n_a ≤ 2048, n_e ≤ 8) the previous kernel
    6 fits in one block, kernel 6 fits on its default cluster, keeping every
    count at the published 40×20×5×2 and fewer where the grid needs the
    room; only grids with 5 or fewer knots on an asset axis can need more
    (the bitmaps of the long axis)."""
    taken = 0
    for NE in range(1, 9):
        C = fs2.default_cluster(NE)
        for NB in range(6, 2048 // 6 + 1):
            for NA in range(6, 2048 // NB + 1):
                if previous_smem_bytes(NB, NA, NE) <= SMEM:
                    taken += 1
                    assert cluster_smem_bytes(NB, NA, NE, C)[1] <= SMEM, (NB, NA, NE)
    assert taken > 10_000
    assert cluster_smem_bytes(40, 20, 5, 10)[0] == 0
    shift, need = cluster_smem_bytes(38, 38, 2, 4)              # NS = 1444 at n_e = 2
    assert previous_smem_bytes(38, 38, 2) <= SMEM and 0 < shift and need <= SMEM
    assert previous_smem_bytes(353, 5, 1) <= SMEM < cluster_smem_bytes(353, 5, 1, 2)[1]


def test_wrappers_of_kernel_6(setup):
    """On CPU tensors `fused2_forward_jvp` runs the plain version; the
    previous kernel 6 runs on the card only."""
    model, _ = setup
    policies, dpolicies, D0 = draw(model, 6)
    calls = fs2.fused2_forward_jvp_reference.calls
    launches = fs2.fused2_forward_jvp.launches
    out = fs2.fused2_forward_jvp(policies, dpolicies, D0, model)
    ref = fs2.fused2_forward_jvp_reference(policies, dpolicies, D0, model)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(out, ref) for k in KEYS)
    assert fs2.fused2_forward_jvp_reference.calls == calls + 2
    assert fs2.fused2_forward_jvp.launches == launches
    with pytest.raises(ValueError, match="on the card only"):
        fs2.fused2_forward_jvp_previous(policies, dpolicies, D0, model)
    assert fs2.fused2_forward_jvp_previous.launches == 0
    assert [fs2.default_cluster(n) for n in (1, 4, 5, 8, 9)] == [2, 8, 10, 16, 16]


def test_the_split_tool_counts_the_lists_by_brute_force():
    """`tools/kernel6_split.list_lengths` (the row and column list lengths
    and hits per destination it reports from the card) against counting
    every (source, row, column) by hand."""
    from hank_tpu_torch.tools.kernel6_split import list_lengths

    rng = np.random.default_rng(8)
    bg, ag = np.sort(rng.uniform(0, 10, 7)), np.sort(rng.uniform(0, 5, 5))
    shape = (3, 7, 5, 2, 2)
    pB = rng.uniform(-1, 11, shape)
    pB[rng.random(shape) < 0.3] = bg[0]
    pA = rng.uniform(-1, 6, shape)
    out = list_lengths(*(torch.tensor(a, dtype=torch.float32) for a in (pB, pA, bg, ag)))
    jb = np.clip((bg.astype(f32)[None] < pB.astype(f32).reshape(-1)[:, None]).sum(1), 1, 6)
    ja = np.clip((ag.astype(f32)[None] < pA.astype(f32).reshape(-1)[:, None]).sum(1), 1, 4)
    jb, ja = jb.reshape(3, 35, 4), ja.reshape(3, 35, 4)        # (t, source, group)
    rows = np.array([[[((jb[t, :, g] == j) | (jb[t, :, g] - 1 == j)).sum() for j in range(7)]
                      for g in range(4)] for t in range(3)])
    hits = np.array([[[[(((jb[t, :, g] == j) | (jb[t, :, g] - 1 == j))
                         & ((ja[t, :, g] == m) | (ja[t, :, g] - 1 == m))).sum()
                        for m in range(5)] for j in range(7)] for g in range(4)]
                     for t in range(3)])
    assert out["rows"]["max"] == rows.max() and out["rows"]["lists"] == rows.size
    assert out["rows"]["mean"] == pytest.approx(rows.mean())
    assert sum(out["rows"]["histogram"]) == rows.size
    assert out["hits_per_destination"]["max"] == hits.max()
    assert out["hits_per_destination"]["mean"] == pytest.approx(hits.mean())


def test_the_split_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hank_tpu_torch.tools import kernel6_split

    assert kernel6_split.main([]) == 1
