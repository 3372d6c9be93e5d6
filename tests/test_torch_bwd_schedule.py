"""PyTorch port: the schedule of kernel 5 on a thread-block cluster, on the CPU.

`two_asset_bwd_cluster_kernel` (`hank_tpu_torch/csrc/household_sweep2.cu`)
is held bit for bit to the previous kernel 5, `two_asset_bwd_kernel`. Every
state's arithmetic is the previous kernel's, expression for expression; the
cluster changes the owner or the order of two stages only, and the functions
below transcribe both forms of each in numpy float32 with the kernels'
roundings (an FMA is one rounding of the exact product plus the addend: the
product of two float32 is exact in float64, and rounding that sum to float32
is the FMA but for a double rounding, which both forms share):

  - stage A, the continuations W = max(β · Σ_f Π[e, f] · vm_f, 1e-12) and
    their tangents: the previous kernel mixes the access branches inline,
    vm = fma(1 − λ, V₀, λ·V₁) (the rounding its SASS shows), and sums over
    the incomes f in order; the cluster kernel's block r owns the incomes
    e ≡ r (mod C), computes their vm itself, and block e reads every
    income's vm from its owner (slot f / C of block f mod C) and sums in the
    same order;
  - C3's scan of the FOC gaps g_k at the breakpoint candidates c_k: the
    previous kernel walks k = 0..K−1 serially (lo = fmaxf over c of the
    negative gaps, g0 = fmaxf of them, hi and g1 by fminf over the rest, a
    NaN gap falling to the second side); the cluster kernel gives one warp a
    row, each lane a contiguous run of candidates, then a butterfly over
    the lanes that keeps their order (fmaxf(earlier, later)) and ballots for
    has_neg / has_pos;
  - the shared memory of a block (`bwd_cluster_smem_bytes`, with the
    candidates' brackets tabled where they fit) at every grid the previous
    kernel takes (`bwd_smem_bytes`).

fmaxf/fminf on the card order −0 below +0 in either operand order and drop a
NaN operand (probed on the H100, PERF.md §6), so any order of the reduction
gives the serial scan's bits. The butterfly keeps the lanes' order all the
same, and the tests hold it to the serial scan also under the rules that a
tie of ±0 goes to the first or to the second operand.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst
from hank_tpu_torch.ops import fused_sweep2 as fs2
from tests.test_torch_common import build_small_two_asset_torch

torch.set_num_threads(1)
f32 = np.float32
FLT_MAX = np.finfo(f32).max
SMEM = 232_448                  # dynamic shared memory of one block (227 KB)
RULES = ("signed", "first", "second")


def fma(a, b, c):
    """float32 FMA: the exact product plus c, rounded once."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def floor_f(x, lo):
    return np.where(x < lo, f32(lo), x).astype(f32)


def floor_d(x, lo):
    return np.where(x > lo, f32(1), np.where(x == lo, f32(0.5), f32(0))).astype(f32)


# ── stage A ────────────────────────────────────────────────────────────────

def mix(one_lam, lam, x0, x1):
    """The previous kernel's access mix: fma(1 − λ, x0, x1·λ)."""
    return fma(one_lam, x0, (x1 * lam).astype(f32))


def stage_a_previous(V, dV, Pi, beta, lam, NB, NA, NE):
    """Transcription of stage A of `two_asset_bwd_kernel`: W (4, N3) in the
    global state order i = (b·n_a + a)·n_e + e."""
    N3 = NB * NA * NE
    one_lam = f32(1) - lam
    i = np.arange(N3)
    e = i % NE
    ba = i - e
    W = np.zeros((4, N3), f32)
    for s in range(2):
        E = np.zeros(N3, f32)
        dE = np.zeros(N3, f32)
        for f in range(NE):
            k = (ba + f) * 2
            E = fma(mix(one_lam, lam, V[s, k], V[s, k + 1]), Pi[e, f], E)
            dE = fma(mix(one_lam, lam, dV[s, k], dV[s, k + 1]), Pi[e, f], dE)
        x = (beta * E).astype(f32)
        W[s] = floor_f(x, f32(1e-12))
        W[2 + s] = (floor_d(x, f32(1e-12)) * (beta * dE).astype(f32)).astype(f32)
    return W


def stage_a_cluster(V, dV, Pi, beta, lam, NB, NA, NE, C):
    """Transcription of stage A of `two_asset_bwd_cluster_kernel` on a
    cluster of C blocks: each owner mixes its incomes' branches into its vm
    region ([vm_b, vm_a, dvm_b, dvm_a][G·n_b·n_a]); block r reads income f
    at slot f // C of block f % C. Returns W (4, N3) in the global order."""
    NBA, G = NB * NA, -(-NE // C)
    n = G * NBA
    one_lam = f32(1) - lam
    ba = np.arange(NBA)
    vm = np.zeros((C, 4, n), f32)
    for e in range(NE):
        r, gi = e % C, e // C
        k = (ba * NE + e) * 2
        for s in range(2):
            vm[r, s, gi * NBA + ba] = mix(one_lam, lam, V[s, k], V[s, k + 1])
            vm[r, 2 + s, gi * NBA + ba] = mix(one_lam, lam, dV[s, k], dV[s, k + 1])
    W = np.zeros((4, NBA * NE), f32)
    for e in range(NE):                       # block e % C, its state j = (e // C)·NBA + ba
        for s in range(2):
            E = np.zeros(NBA, f32)
            dE = np.zeros(NBA, f32)
            for f in range(NE):
                src = vm[f % C][:, (f // C) * NBA + ba]
                E = fma(src[s], Pi[e, f], E)
                dE = fma(src[2 + s], Pi[e, f], dE)
            x = (beta * E).astype(f32)
            W[s, ba * NE + e] = floor_f(x, f32(1e-12))
            W[2 + s, ba * NE + e] = (floor_d(x, f32(1e-12))
                                     * (beta * dE).astype(f32)).astype(f32)
    return W


def draw_values(NB, NA, NE, seed, nan=False, zero_tangent=False):
    """Seeded envelopes V, dV (2, N4) of the kernels' layout, (b, a, e, acc)
    with acc fastest, a Rouwenhorst Π and the model's β and λ."""
    rng = np.random.default_rng(seed)
    N4 = NB * NA * NE * 2
    V = rng.uniform(0.05, 20.0, (2, N4)).astype(f32)
    V[:, rng.random(N4) < 0.05] = rng.uniform(1e-13, 1e-11)        # near the floor
    dV = np.zeros((2, N4), f32) if zero_tangent else rng.normal(size=(2, N4)).astype(f32)
    if nan:
        V[int(rng.integers(0, 2)), int(rng.integers(0, N4))] = np.nan
    Pi = rouwenhorst(NE, 0.966, 0.283)[0].astype(f32)
    return V, dV, Pi, f32(0.976), f32(0.10)


def same_bits(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("NE", [3, 5, 7])
@pytest.mark.parametrize("clusters", ["n_e", "half", "one"])
def test_stage_a_owner_mix_read_remotely_is_the_inline_mix(NE, clusters):
    NB, NA = 12, 8
    C = {"n_e": NE, "half": -(-NE // 2), "one": 1}[clusters]
    V, dV, Pi, beta, lam = draw_values(NB, NA, NE, seed=NE)
    old = stage_a_previous(V, dV, Pi, beta, lam, NB, NA, NE)
    assert same_bits(stage_a_cluster(V, dV, Pi, beta, lam, NB, NA, NE, C), old)
    # Against the same sums in float64: the transcription is the stage.
    vm = (1 - 0.1) * V[:, 0::2].astype(np.float64) + 0.1 * V[:, 1::2]
    vm = vm.reshape(2, NB * NA, NE)
    E = np.einsum("sbf,ef->sbe", vm, Pi.astype(np.float64)).reshape(2, -1)
    assert np.allclose(old[:2], np.maximum(0.976 * E, 1e-12), rtol=1e-5, atol=0)


def test_stage_a_at_the_published_incomes_and_a_capped_cluster():
    """n_e = 17 on the card's largest cluster (16 blocks: block 0 owns
    incomes 0 and 16); a zero tangent gives exactly zero."""
    NB, NA, NE = 6, 4, 17
    V, dV, Pi, beta, lam = draw_values(NB, NA, NE, seed=2, zero_tangent=True)
    old = stage_a_previous(V, dV, Pi, beta, lam, NB, NA, NE)
    new = stage_a_cluster(V, dV, Pi, beta, lam, NB, NA, NE, fs2.default_bwd_cluster(NE))
    assert same_bits(new, old)
    assert not old[2:].any() and not np.signbit(old[2:]).any()


def test_stage_a_nan_spreads_alike():
    NB, NA, NE = 12, 8, 5
    V, dV, Pi, beta, lam = draw_values(NB, NA, NE, seed=4, nan=True)
    old = stage_a_previous(V, dV, Pi, beta, lam, NB, NA, NE)
    assert np.isnan(old).any() and not np.isnan(old).all()
    assert same_bits(stage_a_cluster(V, dV, Pi, beta, lam, NB, NA, NE, NE), old)


# ── C3's scan ──────────────────────────────────────────────────────────────

def fmaxf(a, b, rule):
    """fmaxf on float32 scalars: a NaN operand is dropped; a tie of ±0 goes
    to +0 ("signed", the card's), or to the first or second operand."""
    if np.isnan(a):
        return b
    if np.isnan(b):
        return a
    if a == b:
        if rule == "signed":
            return a if not np.signbit(a) else b
        return a if rule == "first" else b
    return a if a > b else b


def fminf(a, b, rule):
    if np.isnan(a):
        return b
    if np.isnan(b):
        return a
    if a == b:
        if rule == "signed":
            return a if np.signbit(a) else b
        return a if rule == "first" else b
    return a if a < b else b


def scan_serial(c, g, s2, rule):
    """Transcription of the previous kernel's C3 loop (`:412-428`):
    (lo, hi, g0, g1, g_lo, g_hi) after the !has_neg / !has_pos defaults."""
    lo, hi, g0, g1 = -FLT_MAX, FLT_MAX, -FLT_MAX, FLT_MAX
    has_neg = has_pos = False
    for ck, gk in zip(c, g):
        if gk < 0:
            has_neg = True
            lo, g0 = fmaxf(lo, ck, rule), fmaxf(g0, gk, rule)
        else:
            has_pos = True
            hi, g1 = fminf(hi, ck, rule), fminf(g1, gk, rule)
    if not has_neg:
        lo, g0 = f32(0), f32(-1)
    if not has_pos:
        hi, g1 = s2, f32(1)
    return tuple(f32(v) for v in (lo, hi, g0, g1, g[0], g[-1]))


def scan_warp(c, g, s2, rule):
    """Transcription of the cluster kernel's scan: lane l walks candidates
    [l·per, (l + 1)·per), per = ⌈K/32⌉; a butterfly over xor offsets 1..16
    in which the lane whose run comes later puts the other's value first;
    ballots; lane 0 applies the defaults."""
    K = len(g)
    per = -(-K // 32)
    lo, hi = [f32(-FLT_MAX)] * 32, [f32(FLT_MAX)] * 32
    g0, g1 = [f32(-FLT_MAX)] * 32, [f32(FLT_MAX)] * 32
    neg, pos = [False] * 32, [False] * 32
    first, last = [f32(0)] * 32, [f32(0)] * 32
    for lane in range(32):
        for k in range(lane * per, min(K, (lane + 1) * per)):
            if k == 0:
                first[lane] = g[k]
            if k == K - 1:
                last[lane] = g[k]
            if g[k] < 0:
                neg[lane] = True
                lo[lane], g0[lane] = fmaxf(lo[lane], c[k], rule), fmaxf(g0[lane], g[k], rule)
            else:
                pos[lane] = True
                hi[lane], g1[lane] = fminf(hi[lane], c[k], rule), fminf(g1[lane], g[k], rule)
    o = 1
    while o < 32:
        olo, ohi, og0, og1 = ([v[lane ^ o] for lane in range(32)] for v in (lo, hi, g0, g1))
        upper = [(lane & o) != 0 for lane in range(32)]
        lo = [fmaxf(olo[x], lo[x], rule) if upper[x] else fmaxf(lo[x], olo[x], rule)
              for x in range(32)]
        hi = [fminf(ohi[x], hi[x], rule) if upper[x] else fminf(hi[x], ohi[x], rule)
              for x in range(32)]
        g0 = [fmaxf(og0[x], g0[x], rule) if upper[x] else fmaxf(g0[x], og0[x], rule)
              for x in range(32)]
        g1 = [fminf(og1[x], g1[x], rule) if upper[x] else fminf(g1[x], og1[x], rule)
              for x in range(32)]
        o <<= 1
    assert len(set(np.asarray(lo, f32).view(np.int32))) == 1     # every lane holds the result
    out_lo, out_hi, out_g0, out_g1 = lo[0], hi[0], g0[0], g1[0]
    if not any(neg):
        out_lo, out_g0 = f32(0), f32(-1)
    if not any(pos):
        out_hi, out_g1 = s2, f32(1)
    return tuple(f32(v) for v in (out_lo, out_hi, out_g0, out_g1, first[0],
                                  last[(K - 1) // per]))


def candidates(NB, NA, s):
    """The breakpoint candidates of row s on the published grids' shape:
    0, the illiquid knots, s2 − the liquid knots, s2, clipped to [0, s2]."""
    bg = make_double_exponential_grid(0.0, 120.0, NB).astype(f32)
    ag = make_double_exponential_grid(0.0, 200.0, NA).astype(f32)
    s2 = (bg[s] * ((bg[-1] + ag[-1]) / bg[-1]).astype(f32)).astype(f32)
    raw = np.concatenate([[f32(0)], ag, (s2 - bg).astype(f32), [s2]]).astype(f32)
    return np.where(raw < 0, f32(0), np.where(raw > s2, s2, raw)).astype(f32), s2


def row_gaps(c, s2, rng, kind):
    """FOC gaps along a row: a sign change (the usual case), ties, ±0 gaps
    and ±0 candidates, one NaN gap, all negative or all positive."""
    K = len(c)
    g = (rng.normal(size=K) + np.linspace(-2, 2, K)).astype(f32)
    c = c.copy()
    if kind == "ties":
        g[rng.integers(0, K, K // 2)] = g[int(rng.integers(0, K))]
        c[rng.integers(0, K, K // 3)] = c[int(rng.integers(0, K))]
    elif kind == "signed_zeros":
        g[rng.random(K) < 0.3] = f32(-0.0)
        g[rng.random(K) < 0.3] = f32(0.0)
        c[rng.random(K) < 0.3] = f32(-0.0)
        c[rng.random(K) < 0.2] = f32(0.0)
    elif kind == "nan":
        g[int(rng.integers(0, K))] = np.nan
    elif kind == "all_negative":
        g = -np.abs(g) - f32(1e-3)
    elif kind == "all_positive":
        g = np.abs(g)
    return c, g.astype(f32), s2


KINDS = ("sign_change", "ties", "signed_zeros", "nan", "all_negative", "all_positive")
GRIDS = ((40, 20), (24, 12), (12, 8), (6, 6))       # K = 62, 38, 22, 14


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("grid", GRIDS)
def test_warp_scan_is_the_serial_scan(rule, grid):
    NB, NA = grid
    rng = np.random.default_rng(NB * 100 + NA)
    for s in (1, NB // 2, NB - 1):
        c0, s2 = candidates(NB, NA, s)
        for kind in KINDS:
            c, g, s2 = row_gaps(c0, s2, rng, kind)
            assert all(same_bits(np.asarray(x), np.asarray(y)) for x, y in
                       zip(scan_warp(c, g, s2, rule), scan_serial(c, g, s2, rule))), (s, kind)


def test_the_scan_rows_take_each_branch():
    """The drawn rows reach the branches the reductions must keep: a NaN gap
    on the second side, a −0 gap on the second side, rows with no negative
    and with no positive gap (the defaults)."""
    c0, s2 = candidates(40, 20, 20)
    rng = np.random.default_rng(0)
    out = {kind: scan_serial(*row_gaps(c0, s2, rng, kind), "signed") for kind in KINDS}
    assert out["all_negative"][1] == s2 and out["all_negative"][3] == 1
    assert out["all_positive"][0] == 0 and out["all_positive"][2] == -1
    lo, hi = out["sign_change"][:2]
    assert 0 <= lo and hi <= s2


@settings(max_examples=40, deadline=None)
@given(K=st.integers(2, 70), seed=st.integers(0, 2**31 - 1),
       zeros=st.floats(0.0, 0.6), ties=st.floats(0.0, 0.6), nans=st.integers(0, 2),
       rule=st.sampled_from(RULES))
def test_warp_scan_on_drawn_rows(K, seed, zeros, ties, nans, rule):
    rng = np.random.default_rng(seed)
    s2 = f32(rng.uniform(0.5, 300.0))
    c = np.sort(rng.uniform(0, s2, K)).astype(f32)
    g = rng.normal(size=K).astype(f32)
    g[rng.random(K) < ties] = g[0]
    c[rng.random(K) < ties] = c[-1]
    g[rng.random(K) < zeros] = f32(-0.0)
    g[rng.random(K) < zeros / 2] = f32(0.0)
    c[rng.random(K) < zeros] = f32(-0.0)
    g[rng.integers(0, K, nans)] = np.nan
    assert all(same_bits(np.asarray(x), np.asarray(y)) for x, y in
               zip(scan_warp(c, g, s2, rule), scan_serial(c, g, s2, rule)))


# ── shared memory ──────────────────────────────────────────────────────────

def previous_smem_bytes(NB, NA, NE):
    """Transcription of `bwd_smem_bytes` (the previous kernel 5)."""
    N3, K = NB * NA * NE, NA + NB + 2
    R = max(8 * N3, (K + 6) * NB * NE)
    return 4 * (R + 4 * N3 + 3 * NB + NA + NE + NE * NE)


def cluster_smem_bytes(NB, NA, NE, C, tabled=None):
    """Transcription of `bwd_cluster_smem` and `bwd_cluster_tabled`: per
    block, for the G = ⌈n_e / C⌉ incomes it has room for (n = G·n_b·n_a
    states, G·n_b rows), vm and W (4n each), the EGM's knots (2n), the rows'
    scratch (12 a row), the period's illiquid brackets (3 n_a), the grids,
    two periods' prices and tangents (16), and the breakpoint candidates'
    brackets (4 a candidate, K·n_b of them) where they fit. Returns
    (tabled, bytes)."""
    G, K = -(-NE // C), NA + NB + 2
    n, R = G * NB * NA, G * NB

    def size(table):
        return 4 * (10 * n + 12 * R + 3 * NA + 2 * NB + NA + NE + NE * NE + 16
                    + (4 * K * NB if table else 0))

    if tabled is None:
        tabled = size(True) <= SMEM
    return tabled, size(tabled)


def test_cluster_kernel_takes_the_previous_kernels_grids():
    """Every grid (n_b, n_a ≥ 2, n_e ≤ 20) the previous kernel 5 fits in one
    block, kernel 5 fits on its default cluster (past 16 incomes a block
    holds two), with the candidates' brackets tabled where they fit."""
    taken, untabled = 0, 0
    for NE in range(1, 21):
        C = fs2.default_bwd_cluster(NE)
        for NB in range(2, 4900):
            if previous_smem_bytes(NB, 2, NE) > SMEM:
                break
            for NA in range(2, 4900):
                if previous_smem_bytes(NB, NA, NE) > SMEM:
                    break
                taken += 1
                tabled, need = cluster_smem_bytes(NB, NA, NE, C)
                assert need <= SMEM, (NB, NA, NE)
                untabled += not tabled
    assert taken > 50_000 and 0 < untabled < taken // 2
    K = 20 + 40 + 2
    assert cluster_smem_bytes(40, 20, 5, 5) == (
        True, 4 * (10 * 800 + 12 * 40 + 60 + 80 + 20 + 5 + 25 + 16 + 4 * K * 40))
    assert [cluster_smem_bytes(*g)[0] for g in ((24, 12, 3, 3), (12, 8, 17, 16),
                                                 (48, 24, 2, 2), (60, 60, 1, 1))] == [
        True, True, True, False]
    assert previous_smem_bytes(40, 20, 5) == 4 * (8 * 4000 + 4 * 4000 + 120 + 20 + 5 + 25)


def test_wrappers_of_kernel_5():
    """On CPU tensors `fused2_policies_jvp` runs the plain version; the
    previous kernel 5 runs on the card only."""
    model = fs2.cast_model(build_small_two_asset_torch(T=4, n_b=8, n_a=6, n_e=3),
                           torch.float32)
    Tm1 = model.compspec.T - 1
    gen = torch.Generator().manual_seed(0)
    paths = [0.01 + 0.001 * torch.rand(Tm1, generator=gen) for _ in range(2)] + [
        torch.full((Tm1,), 0.8), torch.full((Tm1,), 0.3)]
    paths += [1e-3 * torch.randn(Tm1, generator=gen) for _ in range(4)]
    VT = 0.5 + torch.rand((2, 8, 6, 3, 2), generator=gen)
    calls = fs2.fused2_policies_jvp_reference.calls
    launches = fs2.fused2_policies_jvp.launches
    out = fs2.fused2_policies_jvp(*paths, VT, model)
    ref = fs2.fused2_policies_jvp_reference(*paths, VT, model)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(out, ref) for k in fs2.KEYS)
    assert fs2.fused2_policies_jvp_reference.calls == calls + 2
    assert fs2.fused2_policies_jvp.launches == launches
    with pytest.raises(ValueError, match="on the card only"):
        fs2.fused2_policies_jvp_previous(*paths, VT, model)
    assert fs2.fused2_policies_jvp_previous.launches == 0
    with pytest.raises(ValueError, match="expected"):
        fs2.fused2_policies_jvp(*paths[:7], paths[7][:-1], VT, model)
    assert [fs2.default_bwd_cluster(n) for n in (1, 3, 5, 16, 17)] == [1, 3, 5, 16, 16]
    assert math.isfinite(float(out[0]["C"].sum()))


def test_the_split_tool_reads_stage_shares():
    """`tools/kernel5_split.stage_split`: cycles per period and shares of a
    block's stamp slots, the rest unattributed."""
    from hank_tpu_torch.tools.kernel5_split import (CLUSTER_STAGES, PREVIOUS_STAGES,
                                                   SWEEP_SLOT, stage_split)

    stamps = [0] * 32
    for slot in PREVIOUS_STAGES:
        stamps[slot] = 10 * (slot + 1)
    stamps[SWEEP_SLOT["previous"]] = 400
    out = stage_split(stamps, PREVIOUS_STAGES, SWEEP_SLOT["previous"], 4)
    assert out["cycles_per_period"]["A"] == 2.5 and out["sweep_cycles_per_period"] == 100
    assert out["share"]["D"] == 0.2 and out["share"]["unattributed"] == pytest.approx(0.1)
    assert SWEEP_SLOT["cluster"] not in CLUSTER_STAGES


def test_the_split_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hank_tpu_torch.tools import kernel5_split

    assert kernel5_split.main([]) == 1
