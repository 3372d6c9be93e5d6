"""PyTorch port: two-asset grids past 2048 asset states, on the CPU.

Kernel 6 (`two_asset_fwd_cluster_kernel`) and the f64 forward push
(`two_asset_fwd_f64_cluster_kernel`) keep every source's four lottery-list
entries in shared memory and give a thread two sources of 1024, so they take
n_b·n_a ≤ 2048. Their `GLOBAL_LISTS` instantiations keep the lists in a
global workspace, one slice per (path, block) that is never cleared (each
group overwrites the entries it reads), each source's brackets packed in one
int of shared memory in their place, and give a thread up to four sources;
each stage reads the policies where it needs them. The routes decide by the
libraries' counts (`fused_sweep2.forward_kernel`), and the builds raise past
4096 asset states or a block's shared memory.

Here, without a card:
  - numpy transcriptions of both global-list kernels, with a thread count
    shrunk so that 24×12 and 24×14 (×5×2, T=12) take 3 and 4 sources a
    thread, held bit for bit to the shared-list schedule (kernel 6: the
    transcription of `tests/test_torch_lottery_schedule.py`; the f64
    forward push: the same transcription at 1024 threads with fresh
    shared lists) on clusters of 5 and 10, at several count shifts and
    list placements, on seeded, piled, on-knot and NaN policies, and to
    the plain versions at the bounds of `tests/test_torch_fused2.py` and
    `tests/test_torch_fused2_f64.py`;
  - transcriptions of the new shared-memory counts, fitting 50×70×5×2 and
    48×64×5×2 on the default clusters;
  - the routes with the counts patched: at 50×70×5×2 "auto" on the card
    builds kernel 6 and the f64 pair on the global-list instantiations, and
    the ensemble maps too; past 4096 states the builds raise naming the
    plain routes; CPU tensors never ask a count;
  - the JAX CPU root at 50×70×5×2, T=150
    (`hank_tpu_torch/data/hank_two_asset_50x70_T150_jax_cpu.npz`, made by
    `tests/two_asset_50x70_recipe.py`: the port's warm-started steady state,
    then `hank_tpu`'s J̄ and path solve from it): its grid, horizon and
    shock against the recipe, its steady state against the model's
    equations and a fixed point of the port's household, its ‖F‖ as
    recorded (tier 1); (`slow`) its steady state against `hank_tpu`'s
    household at its prices, `hank_tpu`'s own `find_ss` household there,
    and the root rebuilt from `hank_tpu`'s steady state with the port's CPU
    solve held to it;
  - why two card checks compare as they do: the plain kernel 5 in f32 on
    seeded synthetic prices, and the plain kernel 6 across grid roundings.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import hank_tpu_torch.parallel.ensemble as ens
import hank_tpu_torch.solvers.newton as newton_mod
from hank_tpu_torch.blocks.assemble import residuals
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops import fused_residual2 as fr2
from hank_tpu_torch.ops import fused_sweep2 as fs2
from tests.test_torch_bwd_schedule import cluster_smem_bytes as bwd_cluster_smem_bytes
from tests.test_torch_common import build_small_two_asset_torch
from tests.test_torch_kernel_fit import OnCard
from tests.test_torch_lottery_schedule import (KEYS, SMEM, WARPS, aggregates, cluster_kernel,
                                               cluster_smem_bytes, draw, fma, inputs, mix,
                                               popc, same_bits)
from tests.two_asset_50x70_recipe import (LARGE, LARGE_FILE, jax_cpu_root_large,
                                          jax_household_large, published_width,
                                          shipped_steady_state)

torch.set_num_threads(1)
f32 = np.float32
f64 = torch.float64



# ── transcriptions ─────────────────────────────────────────────────────────

def weights(g, jc, p, dp):
    """`lottery_weights` of household_sweep2.cu at a bracket jc already
    found (the global-list kernel unpacks it from shared memory): clipped
    weight and its tangent with torch's tie rule."""
    h = (g[jc] - g[jc - 1]).astype(f32)
    raw = ((p - g[jc - 1]) / h).astype(f32)
    w = np.where(raw < 0, f32(0), np.where(raw > 1, f32(1), raw)).astype(f32)
    d = np.where((raw > 0) & (raw < 1), f32(1),
                 np.where((raw == 0) | (raw == 1), f32(0.5), f32(0))).astype(f32)
    return w, (d * (dp / h).astype(f32)).astype(f32)


def count_bracket(g, p):
    """`lottery_bracket`: the count of knots below p, clipped to [1, n-1]
    (a NaN counts no knot)."""
    return np.clip((g[None, :] < p[:, None]).sum(axis=1), 1, len(g) - 1)


def bitmaps(jb, ja, NB, NA, NS):
    """Each row's and column's sources, one bit a source (L)."""
    nw, d_all = -(-NS // 32), np.arange(NS)
    rowbits, colbits = np.zeros((NB, nw), np.uint32), np.zeros((NA, nw), np.uint32)
    bit = (np.uint32(1) << (d_all % 32).astype(np.uint32)).astype(np.uint32)
    for rows, idx in ((rowbits, jb - 1), (rowbits, jb), (colbits, ja - 1), (colbits, ja)):
        np.bitwise_or.at(rows, (idx, d_all // 32), bit)
    return rowbits, colbits


def places(cnt, threads, order):
    """Each destination's list offset: thread tid holds destinations tid,
    tid + threads, ... in order, a warp scan of the threads' totals, and
    one atomicAdd a warp in `order` (R)."""
    NS = cnt.size
    d_all = np.arange(NS)
    tid, slot = d_all % threads, d_all // threads
    assert slot.max() < 4                             # kCluSourcesGlobal / kFwdSourcesGlobal
    per_thread = np.zeros(threads, np.int64)
    np.add.at(per_thread, tid, cnt)
    offs_thread = np.zeros(threads, np.int64)
    alloc = 0
    for w in order:
        tids = np.arange(32 * w, min(32 * w + 32, threads))
        incl = np.cumsum(per_thread[tids])
        offs_thread[tids] = alloc + incl - per_thread[tids]
        alloc += incl[-1]
    assert alloc == 4 * NS
    offs = offs_thread[tid].copy()
    for i in range(1, 4):                             # the thread's earlier destinations
        later = slot >= i
        offs[later] += cnt[d_all[later] - i * threads]
    return offs


def ranks(rowbits, colbits, jb, ja, NA, shift):
    """Per source and corner (rc, cc): its destination and its rank in that
    destination's list, from the count kept before its word, the words
    after it and the set bits below it."""
    NS = jb.size
    nw, d_all = rowbits.shape[1], np.arange(NS)
    j_all, m_all = d_all // NA, d_all % NA
    pair = popc(rowbits[j_all] & colbits[m_all])
    cnt = pair.sum(axis=1)
    before = (np.cumsum(pair, axis=1) - pair)[:, ::1 << shift]
    w_s, below = d_all // 32, (np.uint32(1) << (d_all % 32).astype(np.uint32)) - 1
    first = w_s >> shift << shift
    out = {}
    for rc in range(2):
        j = jb - 1 + rc
        for cc in range(2):
            m = ja - 1 + cc
            d = j * NA + m
            r = before[d, w_s >> shift] + popc(rowbits[j, w_s] & colbits[m, w_s] & below)
            for u in range((1 << shift) - 1):
                wu = first + u
                wc = np.minimum(wu, nw - 1)
                r = r + np.where(wu < w_s, popc(rowbits[j, wc] & colbits[m, wc]), 0)
            out[rc, cc] = d, r
    return cnt, out


def global_list_kernel(policies, dpolicies, D0, grids, C, threads, shift=0, warp_order=None):
    """Transcription of `two_asset_fwd_cluster_kernel<false, true>` on a
    cluster of C blocks of `threads` threads (1024 in the kernel; fewer here
    so that a small grid gives a thread several sources): (6, T-1)
    outputs. Each rank's lists live in its own workspace of 4·NS entries,
    written and read for each of its groups in turn and never cleared (a
    read of an entry that this group did not write fails); L packs each
    source's brackets in one int, the terms stage unpacks them and reads the
    policies again; the aggregates are the kernel's (1024 threads)."""
    pol, dpol, D0, (Tm1, NB, NA, NE) = inputs(policies, dpolicies, D0)
    bg, ag, Pi, Pacc = grids
    NS, NG = NB * NA, 2 * NE
    N4, cells = NS * NG, -(-NS // C)
    order = np.arange(-(-threads // 32)) if warp_order is None else np.asarray(warp_order)
    owned = {g: g % C for g in range(NG)}
    D = {g: (D0[np.arange(NS) * NG + g].copy(), np.zeros(NS, f32)) for g in range(NG)}
    Dpath = np.zeros((Tm1, 2, N4), f32)
    workspace = {r: np.full((4 * NS, 3), np.nan, f32) for r in range(C)}
    written = {r: np.full(4 * NS, -1) for r in range(C)}
    d_all, stamp = np.arange(NS), 0
    for t in range(Tm1):
        Hc = np.zeros((C, 2, NG, cells), f32)
        for rank in range(C):
            for g in (g for g in range(NG) if owned[g] == rank):
                stamp += 1
                k = d_all * NG + g
                # L. Brackets from the policies, packed; bitmaps.
                jbs, jas = count_bracket(bg, pol[0, t, k]), count_bracket(ag, pol[1, t, k])
                brk = (jbs.astype(np.int64) << 16) | jas
                rowbits, colbits = bitmaps(jbs, jas, NB, NA, NS)
                cnt, corner = ranks(rowbits, colbits, jbs, jas, NA, shift)
                offs = places(cnt, threads, order)
                # Terms: brackets unpacked, policies read again.
                jb, ja = brk >> 16, brk & 0xffff
                wb, dwb = weights(bg, jb, pol[0, t, k], dpol[0, t, k])
                wa, dwa = weights(ag, ja, pol[1, t, k], dpol[1, t, k])
                src, dsrc = D[g]
                wmc = np.stack([f32(1) - wa, wa], axis=1).astype(f32)
                lists, mark = workspace[rank], written[rank]
                for rc in range(2):
                    wj = (f32(1) - wb if rc == 0 else wb).astype(f32)
                    dwj = -dwb if rc == 0 else dwb
                    mass = (wj * src).astype(f32)
                    A = fma(dwj, src, (wj * dsrc).astype(f32))
                    for cc in range(2):
                        dwm = -dwa if cc == 0 else dwa
                        d, r = corner[rc, cc]
                        at = offs[d] + r
                        lists[at] = np.stack([mass, wmc[:, cc],
                                              fma(mass, dwm, (A * wmc[:, cc]).astype(f32))], 1)
                        mark[at] = stamp
                # One thread per destination sums its list in order.
                v, dv = np.zeros(NS, f32), np.zeros(NS, f32)
                for q in range(int(cnt.max())):
                    live = q < cnt
                    assert (mark[offs[live] + q] == stamp).all()
                    e = lists[offs[live] + q]
                    v[live] = fma(e[:, 0], e[:, 1], v[live])
                    dv[live] = (dv[live] + e[:, 2]).astype(f32)
                owner = d_all // cells
                Hc[owner, 0, g, d_all - owner * cells] = v
                Hc[owner, 1, g, d_all - owner * cells] = dv
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
    for t in range(Tm1):
        out[:, t] = aggregates(Dpath[t, 0], Dpath[t, 1], pol[:, t], dpol[:, t])
    return out


def aggregates_f64(D, pol):
    """One period's three f64 aggregates in the forward push's order: thread
    tid sums k = tid + 1024 i (each product and sum rounded, -fmad=false),
    then warp butterflies and warp 0's."""
    N4 = D.size
    s = np.zeros((3, 1024))
    for k0 in range(0, N4, 1024):
        k = np.arange(k0, min(k0 + 1024, N4))
        for q in range(3):
            s[q, k - k0] = s[q, k - k0] + pol[q][k] * D[k]
    v = s.reshape(3, 32, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, :, lane ^ o]
    x = v[:, :, 0]
    for o in (16, 8, 4, 2, 1):
        x = x + x[:, lane ^ o]
    return x[:, 0]


def forward_f64(policies, D0, grids, C, threads=1024, shift=0, global_lists=False,
                warp_order=None):
    """Transcription of `two_asset_fwd_f64_cluster_kernel<false,
    GLOBAL_LISTS>` on a cluster of C blocks of `threads` threads: (3, T-1)
    outputs. Without `global_lists` each group's lists are fresh (shared
    memory), with it each rank's workspace is never cleared (a read of an
    entry this group did not write fails) and the terms stage unpacks the
    brackets and reads the policies again. Every product and sum rounds on
    its own, as the library's -fmad=false build does."""
    pol = np.stack([policies[k].numpy() for k in KEYS]).astype(np.float64)
    Tm1, NB, NA, NE = pol.shape[1:5]
    pol = pol.reshape(3, Tm1, -1)
    D0 = D0.numpy().reshape(-1).astype(np.float64)
    bg, ag, Pi, Pacc = grids
    NS, NG = NB * NA, 2 * NE
    N4, cells = NS * NG, -(-NS // C)
    order = np.arange(-(-threads // 32)) if warp_order is None else np.asarray(warp_order)
    D = {g: D0[np.arange(NS) * NG + g].copy() for g in range(NG)}
    Dpath = np.zeros((Tm1, N4))
    workspace = {r: np.full(4 * NS, np.nan) for r in range(C)}
    written = {r: np.full(4 * NS, -1) for r in range(C)}
    d_all, stamp = np.arange(NS), 0

    def weight(g, jc, p):
        raw = (p - g[jc - 1]) / (g[jc] - g[jc - 1])
        return np.where(np.isnan(raw), raw, np.clip(raw, 0.0, 1.0))

    for t in range(Tm1):
        Hc = np.zeros((C, NG, cells))
        for rank in range(C):
            for g in (g for g in range(NG) if g % C == rank):
                stamp += 1
                k = d_all * NG + g
                jbs, jas = count_bracket(bg, pol[0, t, k]), count_bracket(ag, pol[1, t, k])
                rowbits, colbits = bitmaps(jbs, jas, NB, NA, NS)
                cnt, corner = ranks(rowbits, colbits, jbs, jas, NA, shift)
                offs = places(cnt, threads, order)
                if global_lists:
                    brk = (jbs.astype(np.int64) << 16) | jas
                    jb, ja = brk >> 16, brk & 0xffff
                    lists, mark = workspace[rank], written[rank]
                else:
                    jb, ja = jbs, jas
                    lists, mark = np.full(4 * NS, np.nan), np.full(4 * NS, -1)
                wbs, was = weight(bg, jb, pol[0, t, k]), weight(ag, ja, pol[1, t, k])
                for rc in range(2):
                    mass = (1.0 - wbs if rc == 0 else wbs) * D[g]
                    for cc in range(2):
                        d, r = corner[rc, cc]
                        lists[offs[d] + r] = mass * (1.0 - was if cc == 0 else was)
                        mark[offs[d] + r] = stamp
                v = np.zeros(NS)
                for q in range(int(cnt.max())):
                    live = q < cnt
                    assert (mark[offs[live] + q] == stamp).all()
                    v[live] = v[live] + lists[offs[live] + q]
                owner = d_all // cells
                Hc[owner, g, d_all - owner * cells] = v
        for rank in range(C):
            my = max(0, min(NS - rank * cells, cells))
            i = np.arange(my * NG)
            g2, c = i % NG, i // NG
            e2, acc2 = g2 >> 1, g2 & 1
            Dn = np.zeros(i.size)
            for acc in range(2):
                x = np.zeros(i.size)
                for e in range(NE):
                    x = x + Hc[rank, 2 * e + acc, c] * Pi[e, e2]
                Dn = Dn + x * Pacc[acc, acc2]
            s = rank * cells + c
            for g in range(NG):
                D[g][s[g2 == g]] = Dn[g2 == g]
            Dpath[t, s * NG + g2] = Dn
    return np.stack([aggregates_f64(Dpath[t], pol[:, t]) for t in range(Tm1)], axis=1)


# ── inputs ─────────────────────────────────────────────────────────────────

def small(n_a):
    """The small two-asset model (24×n_a×5×2, T=12) in f32 and f64, with its
    grids and transitions as the kernels read them in each."""
    model = build_small_two_asset_torch(n_a=n_a, n_e=5)
    m32 = fs2.cast_model(model, torch.float32)
    dims = [fs2._dims(m) for m in (m32, model)]
    g32, g64 = (tuple(np.asarray(x.numpy(), dt) for x in
                      (d[0].grid, d[1].grid, d[2].transition, d[3].transition))
                for d, dt in zip(dims, (f32, np.float64)))
    return m32, model, g32, g64


@pytest.fixture(scope="module")
def grids12():
    return small(12)


@pytest.fixture(scope="module")
def grids14():
    return small(14)


def as64(policies, D0):
    return {k: v.double() for k, v in policies.items()}, D0.double()


def bounded32(out, model, policies, dpolicies, D0):
    """Within `tests/test_torch_fused2.py`'s bound of the plain version
    (NaN where it has NaN)."""
    aggs, daggs = fs2.fused2_forward_jvp_reference(policies, dpolicies, D0, model)
    ref = np.stack([*(aggs[k].numpy() for k in KEYS), *(daggs[k].numpy() for k in KEYS)])
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    fin = ~np.isnan(ref)
    scale = float(np.max(np.abs(ref[fin]))) if fin.any() else 0.0
    assert float(np.max(np.abs(out[fin] - ref[fin]), initial=0.0)) <= 5e-5 * max(scale, 1.0)


def bounded64(out, model, policies, D0):
    """Within 1e-12 of `forward_iteration` in f64 (the order of the plain
    version's einsum and sums differs from the kernel's)."""
    pol64, D64 = as64(policies, D0)
    ref = fr2.fused2_forward_f64_reference(pol64, D64, model)
    ref = np.stack([ref[k].numpy() for k in KEYS])
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    fin = ~np.isnan(ref)
    assert float(np.max(np.abs(out[fin] - ref[fin]), initial=0.0)) <= 1e-12


SOURCES = {"3 a thread": ("grids12", 96), "4 a thread": ("grids14", 96)}


def sources_case(request, which):
    name, threads = SOURCES[which]
    m32, m64, g32, g64 = request.getfixturevalue(name)
    NS = g32[0].size * g32[1].size
    assert -(-NS // threads) == int(which[0])
    return m32, m64, g32, g64, threads


POLICIES = {"seeded": {}, "piled": {"piled": 0.8},
            "on and past the knots": {"on_knots": 0.3, "outside": 0.2},
            "one NaN": {"nan": True}}


# ── the global-list schedules ──────────────────────────────────────────────

@pytest.mark.parametrize("kind", sorted(POLICIES))
@pytest.mark.parametrize("which", sorted(SOURCES))
def test_global_list_kernel6_is_the_shared_list_schedule(request, which, kind):
    """Kernel 6 with its lists in global memory, 3 or 4 sources a thread, on
    clusters of 5 and 10: bit for bit the shared-list schedule (two sources
    a thread of 1024, fresh lists in shared memory), NaNs included, and
    within the plain version's bound."""
    m32, _, g32, _, threads = sources_case(request, which)
    policies, dpolicies, D0 = draw(m32, 11, **POLICIES[kind])
    for C in (5, 10):
        shared = cluster_kernel(policies, dpolicies, D0, g32, C)
        assert same_bits(global_list_kernel(policies, dpolicies, D0, g32, C, threads), shared)
    bounded32(shared, m32, policies, dpolicies, D0)
    assert np.isnan(shared).any() == (kind == "one NaN")


@pytest.mark.parametrize("shift", [1, 3])
def test_global_list_kernel6_at_other_shifts_and_placements(grids14, shift):
    """The count shift (the room a large grid needs) and the order in which
    the warps take their lists' places change no bit."""
    m32, _, g32, _ = grids14
    policies, dpolicies, D0 = draw(m32, 12, piled=0.5, on_knots=0.2)
    base = cluster_kernel(policies, dpolicies, D0, g32, 10)
    order = np.random.default_rng(shift).permutation(3)
    assert same_bits(global_list_kernel(policies, dpolicies, D0, g32, 10, 96, shift=shift,
                                        warp_order=order), base)


@pytest.mark.parametrize("kind", sorted(POLICIES))
@pytest.mark.parametrize("which", sorted(SOURCES))
def test_global_list_f64_forward_is_the_shared_list_schedule(request, which, kind):
    """The f64 forward push with its lists in global memory, 3 or 4 sources
    a thread, on clusters of 5 and 10: bit for bit the shared-list schedule
    (1024 threads, fresh lists), NaNs included, and within 1e-12 of
    `forward_iteration`."""
    _, m64, _, g64, threads = sources_case(request, which)
    policies, _, D0 = draw(m64, 13, **POLICIES[kind])
    pol64, D64 = as64(policies, D0)
    for C in (5, 10):
        shared = forward_f64(pol64, D64, g64, C)
        got = forward_f64(pol64, D64, g64, C, threads, global_lists=True)
        assert np.array_equal(got.view(np.int64), shared.view(np.int64)), C
    bounded64(shared, m64, pol64, D64)


@pytest.mark.parametrize("shift", [2, 4])
def test_global_list_f64_forward_at_other_shifts_and_placements(grids12, shift):
    _, m64, _, g64 = grids12
    policies, _, D0 = draw(m64, 14, piled=0.5, on_knots=0.2)
    pol64, D64 = as64(policies, D0)
    base = forward_f64(pol64, D64, g64, 10)
    order = np.random.default_rng(shift).permutation(3)
    got = forward_f64(pol64, D64, g64, 10, 96, shift, True, order)
    assert np.array_equal(got.view(np.int64), base.view(np.int64))


# ── shared memory ──────────────────────────────────────────────────────────

def forward_smem(NB, NA, NE, C, f64_push=False, global_lists=False):
    """Transcription of `fwd_cluster_smem_bytes` / `fwd_cluster_shift`
    (kernel 6) and `fwd_smem_bytes` / `fwd_shift` (the f64 forward push):
    the least count shift that fits a block (or the one keeping a single
    count), and the bytes there. Under global lists each source's packed
    brackets (4 bytes; an even count in f64) take the lists' place (64 bytes
    a source in f32, 32 in f64)."""
    NS, NG = NB * NA, 2 * NE
    G, nw, cells = -(-NG // C), -(-NS // 32), -(-NS // C)
    if f64_push:
        lists = 4 * (NS + NS % 2) if global_lists else 32 * NS
        rest = 8 * (NG * cells + G * NS + NB + NA + NE * NE + 4 + 3 * WARPS)
    else:
        lists = 4 * NS if global_lists else 64 * NS
        rest = 4 * (2 * NG * cells + 2 * G * NS + NB + NA + NE * NE + 4 + 6 * WARPS)

    def size(shift):
        return lists + rest + 4 * ((NB + NA) * nw + NS + 4) + 2 * NS * (((nw - 1) >> shift) + 1)

    shift = 0
    while (1 << shift) < nw and size(shift) > SMEM:
        shift += 1
    return shift, size(shift)


def f64_bwd_smem(NB, NA, NE, C, tabled):
    """Transcription of the f64 backward kernel's `bwd_smem`."""
    G, K = -(-NE // C), NA + NB + 2
    n, R = G * NB * NA, G * NB
    return (8 * (5 * n + 9 * R + 2 * NA + 2 * NB + NE + NE * NE + 8) + 4 * NA
            + (32 * K * NB if tabled else 0))


def test_forward_transcription_is_kernel6s_shared_list_count():
    """Without global lists the transcription is the shared-list kernel 6's
    count of `tests/test_torch_lottery_schedule.py`."""
    for grid in ((40, 20, 5, 10), (38, 38, 2, 4), (24, 12, 4, 8), (12, 8, 8, 16)):
        assert forward_smem(*grid) == cluster_smem_bytes(*grid)


@pytest.mark.parametrize("grid,k5_tabled", [((50, 70), False), ((48, 64), True),
                                             ((64, 64), False)])
def test_large_grids_fit_the_global_list_instantiations(grid, k5_tabled):
    """At 50×70×5×2, 48×64×5×2 and 64×64×5×2 (4096 states, the cap) both
    global-list forward kernels fit on the default cluster of 10 at a count
    shift that fits; the shared-list ones do not take them (past 2048
    sources; kernel 6 past a block with its lists too). Kernel 5 fits its
    default cluster of 5, tabled only at 48×64; the f64 backward untabled
    at all three."""
    NB, NA = grid
    C = fs2.default_cluster(5)
    assert NB * NA > fs2.FORWARD_MAX_STATES[0] and NB * NA <= fs2.FORWARD_MAX_STATES[1]
    for f64_push in (False, True):
        shift, need = forward_smem(NB, NA, 5, C, f64_push, global_lists=True)
        assert need <= SMEM and (1 << shift) < -(-NB * NA // 32), (f64_push, shift, need)
    assert forward_smem(NB, NA, 5, C)[1] > SMEM
    C5 = fs2.default_bwd_cluster(5)
    tabled, need = bwd_cluster_smem_bytes(NB, NA, 5, C5)
    assert tabled == k5_tabled and need <= SMEM
    assert f64_bwd_smem(NB, NA, 5, C5, False) <= SMEM < f64_bwd_smem(NB, NA, 5, C5, True)


def test_published_grid_keeps_its_shared_lists():
    """40×20×5×2 (800 states) keeps the shared-list kernels and every count
    (shift 0); the global-list ones would take it too."""
    for f64_push in (False, True):
        assert forward_smem(40, 20, 5, 10, f64_push)[0] == 0
        assert forward_smem(40, 20, 5, 10, f64_push)[1] <= SMEM
        assert forward_smem(40, 20, 5, 10, f64_push, True)[1] <= SMEM


# ── the routes, with the libraries' counts patched ─────────────────────────

def large_model(n_b=50, n_a=70, T=12):
    """The small model's structure at an n_b×n_a×5×2 grid (the routes read
    the grid's sizes only)."""
    return build_small_two_asset_torch(T=T, n_b=n_b, n_a=n_a, n_e=5)


def zero_state(model):
    """A steady state of zeros on the model's grid (the builds read its
    shapes and where its arrays lie)."""
    from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy

    state = tuple(model.state_shape())
    return steady_state_from_numpy(
        {"vars": {k: 0.0 for k in model.var_names()},
         "policies": {k: np.zeros(state) for k in KEYS},
         "D": np.zeros(state), "value": np.zeros((2, *state))}, device="cpu")


def card_state(model):
    """`zero_state` with its arrays reporting themselves on the card."""
    ss = zero_state(model)
    return dataclasses.replace(ss, D=ss.D.as_subclass(OnCard),
                               value=ss.value.as_subclass(OnCard))


def transcribed_counts(monkeypatch):
    """Both libraries' counts by the transcriptions above (which = 2, 4 of
    kernel 6, 3 of kernel 5; 0 backward, 1 and 2 forward in f64), the
    default tables where they fit; returns the (library, which) asked."""
    asked = []

    def f32_count(which, n_b, n_a, n_e, cluster=1):
        asked.append(("f32", which))
        if which == 3:
            return bwd_cluster_smem_bytes(n_b, n_a, n_e, cluster)[1]
        return forward_smem(n_b, n_a, n_e, cluster, global_lists=which == 4)[1]

    def f64_count(which, n_b, n_a, n_e, cluster=1):
        asked.append(("f64", which))
        if which == 0:
            tabled = f64_bwd_smem(n_b, n_a, n_e, cluster, True) <= SMEM
            return f64_bwd_smem(n_b, n_a, n_e, cluster, tabled)
        return forward_smem(n_b, n_a, n_e, cluster, True, global_lists=which == 2)[1]

    monkeypatch.setattr(cuda_build, "sweep2_smem_bytes", f32_count)
    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", f64_count)
    return asked


@pytest.mark.parametrize("grid,forward", [((50, 70), "global"), ((48, 64), "global"),
                                          ((64, 64), "global"), ((40, 20), "shared")])
def test_auto_on_the_card_takes_the_global_list_kernels(monkeypatch, grid, forward):
    """On the card "auto" builds kernels 5-6 (direction route) and the f64
    pair (residual route) with the forward kernels on their global-list
    instantiations past 2048 states, and on the shared-list ones at the
    published 40×20; the ensemble's maps build on the same ones. Each map
    records its choice."""
    model = large_model(*grid)
    ss = card_state(model)
    asked = transcribed_counts(monkeypatch)
    want = {"global": (4, fr2.GLOBAL_LISTS), "shared": (2, fr2.SHARED_LISTS)}[forward]
    jvp_dir, F32 = newton_mod.direction_route(model, ss, ss, {}, "auto")
    F = newton_mod.residual_route(model, ss, ss, {}, "auto")
    assert (jvp_dir.forward_kernel, F32.forward_kernel, F.forward_kernel) == (
        want[0], want[0], want[1])
    assert fs2.make_fused2_jvp_batch(model, ss, ss).forward_kernel == want[0]
    assert ens._residual_batch(model, ss, ss).forward_kernel == want[1]
    assert ("f32", 3) in asked and ("f64", 0) in asked
    assert (("f32", 2) in asked) == (("f64", 1) in asked) == (grid[0] * grid[1] <= 2048)


@pytest.mark.parametrize("grid", [(64, 65), (90, 50)])
def test_past_4096_states_the_builds_raise_naming_the_plain_routes(monkeypatch, grid):
    """Past the global-list instantiations' 4096 asset states every two-asset
    map on the card raises at its build, before asking any count, naming
    the plain routes; the plain routes build."""
    model = large_model(*grid)
    ss = card_state(model)
    asked = transcribed_counts(monkeypatch)
    n = grid[0] * grid[1]
    f32_match = f"kernels 5-6 at grid {grid[0]}x{grid[1]}x5x2 has {n} asset states.*direction_mode='xla'"
    f64_match = (f"f64 residual pair at grid {grid[0]}x{grid[1]}x5x2 has {n} asset "
                 "states.*residual_mode='f64'")
    for build, match in (
            (lambda: newton_mod.direction_route(model, ss, ss, {}, "auto"), f32_match),
            (lambda: fs2.make_fused2_jvp_batch(model, ss, ss), f32_match),
            (lambda: newton_mod.residual_route(model, ss, ss, {}, "auto"), f64_match),
            (lambda: ens._residual_batch(model, ss, ss), f64_match)):
        with pytest.raises(ValueError, match=match):
            build()
    assert not asked
    newton_mod.residual_route(model, ss, ss, {}, "f64")
    newton_mod.direction_route(model, ss, ss, {}, "xla")
    assert not asked


def test_past_a_block_the_builds_raise(monkeypatch):
    """One byte past a block in every count: the builds raise at 50×70 after
    asking the global-list instantiations (no shared-list one takes the
    grid), naming the plain routes."""
    model = large_model()
    ss = card_state(model)
    asked = []

    def over(name):
        def count(which, n_b, n_a, n_e, cluster=1):
            asked.append((name, which))
            return SMEM + 1
        return count

    monkeypatch.setattr(cuda_build, "sweep2_smem_bytes", over("f32"))
    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", over("f64"))
    with pytest.raises(ValueError, match="kernels 5-6 at grid 50x70x5x2 needs 232449"):
        newton_mod.direction_route(model, ss, ss, {}, "auto")
    with pytest.raises(ValueError, match="f64 residual pair at grid 50x70x5x2 needs 232449"):
        newton_mod.residual_route(model, ss, ss, {}, "auto")
    assert sorted(set(asked)) == [("f32", 3), ("f32", 4), ("f64", 0), ("f64", 2)]


def test_cpu_tensors_never_ask_a_count(monkeypatch):
    """CPU tensors at 50×70: the routes and the wrappers never ask either
    library (there is none here); the maps record no kernel."""
    def refuse(*a):
        raise AssertionError("the count was asked off the card")

    monkeypatch.setattr(cuda_build, "sweep2_smem_bytes", refuse)
    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", refuse)
    model = large_model(T=3)
    cpu = zero_state(model)
    assert fr2.make_fused2_residual_fn_f64(model, cpu, cpu, {}).forward_kernel is None
    assert fs2.make_fused2_jvp_batch(model, cpu, cpu).forward_kernel is None
    assert fs2.make_fused2_jvp_dir(model, cpu, cpu, {}).forward_kernel is None
    newton_mod.residual_route(model, cpu, cpu, {}, "auto")
    rng = np.random.default_rng(0)
    shape = (2, 50, 70, 5, 2)
    pol = {k: torch.tensor(rng.uniform(0, 100, shape)) for k in KEYS}
    D0 = torch.full(shape[1:], 1.0 / np.prod(shape[1:]), dtype=f64)
    calls = fr2.fused2_forward_f64_reference.calls
    fr2.fused2_forward_f64(pol, D0, model)
    assert fr2.fused2_forward_f64_reference.calls == calls + 1


def test_lists_workspace_shapes():
    """The global-list instantiations' workspace: (B, C, 4·n_b·n_a) float4 in
    f32 (224 KB a block at 50×70), f64 entries in f64; none for the
    shared-list ones."""
    assert fs2.lists_scratch(4, "household_sweep2", 10, (50, 70)) == [(10, 14000, 4)]
    assert fs2.lists_scratch(4, "household_sweep2", 6, (50, 70), (16,)) == [(16, 6, 14000, 4)]
    assert fs2.lists_scratch(2, "household_sweep2_f64", 10, (50, 70)) == [(10, 14000)]
    assert fs2.lists_scratch(2, "household_sweep2", 10, (40, 20)) == []
    assert fs2.lists_scratch(1, "household_sweep2_f64", 10, (40, 20)) == []
    assert 14000 * 16 == 224_000


# ── the JAX CPU root at 50×70×5×2, T = 150 ─────────────────────────────────

def test_shipped_large_root_is_the_recipes_case():
    """The shipped 50×70 root: the recipe's grid, horizon and shock (the
    yaml's `fiscalShock` defaults, as the port generates it), every
    steady-state variable, the steady state's arrays on the grid (D sums to
    one) and a path of the right length, and ‖F‖ ≤ 1e-8 as the recipe
    recorded it."""
    from hank_tpu_torch.model.structures import generate_exog_paths
    from hank_tpu_torch.models import load_model

    with np.load(LARGE_FILE) as z:
        assert tuple(z["grid"]) == LARGE
        n_b, n_a, T = LARGE
        model = published_width(load_model("hank_two_asset", T=T, device="cpu"))
        assert list(z["var_names"]) == list(model.var_names())
        assert z["x"].shape == ((T - 1) * len(model.vars_of_type("endogenous")),)
        G = generate_exog_paths(model, T - 1)["G"].numpy()
        assert z["G"].shape == G.shape and np.max(np.abs(z["G"] - G)) <= 1e-15
        assert float(z["residual_norm"]) <= 1e-8
        assert np.isfinite(z["x"]).all()
        state = tuple(model.state_shape())
        assert z["D"].shape == state and z["value"].shape == (2, *state)
        assert all(z[f"policy_{k}"].shape == state for k in KEYS)
        assert abs(float(z["D"].sum()) - 1.0) <= 1e-12
        # The steady state clears both markets and the firm's and budget
        # equations, by the port's residuals (the shipped model's equations).
        values = dict(zip(model.var_names(), z["var_values"].tolist()))
        col = torch.tensor([values[k] for k in model.var_names()], dtype=f64)
        cs = model.compspec
        F_ss = residuals(col[:, None].expand(cs.n_v, 1 + cs.max_lag + cs.max_lead), model)
        assert float(F_ss.abs().max()) <= 1e-9


def test_kernel6_plain_version_moves_with_the_grids_rounding():
    """Why the card holds kernel 6 at 50×70 to its plain version on the
    kernel's own f32 grids: on the card tests' seeded policies (T = 12,
    spread past both ends of each grid, 10% of the illiquid ones on knots)
    the plain version in f64 moves by far more than kernel 6's bound
    (5e-5·scale) when only its grids change from the f32-rounded knots to
    the f64 ones, since a policy on or next to a knot changes bracket and
    the tangent's 1/Δ with it; run in f32 on the same grids it stays within
    the bound. A comparison across the two roundings (as a first check on
    the card made, 72.6 off at scale 158, PERF.md §6) measures the grids,
    not the kernel."""
    from tests.test_torch_sweep_bits import two_asset_on, two_asset_policies

    model = two_asset_on(torch.device("cpu"), 50, 70, T=12)
    m32 = fs2.cast_model(model, torch.float32)
    pol, dpol, D0 = two_asset_policies(m32, torch.float32, 4)
    P, dP = ({k: v.double() for k, v in d.items()} for d in (pol, dpol))
    on_f32 = fs2.fused2_forward_jvp_reference(P, dP, D0.double(), m32)
    on_f64 = fs2.fused2_forward_jvp_reference(P, dP, D0.double(), model)
    in_f32 = fs2.fused2_forward_jvp_reference(pol, dpol, D0, m32)
    bound = 5e-5 * max(1.0, max(float(r[k].abs().max()) for r in on_f32 for k in r))
    assert max(float((a[k] - b[k]).abs().max()) for a, b in zip(on_f32, on_f64) for k in a) \
        > 100 * bound
    assert max(float((a[k].double() - b[k]).abs().max())
               for a, b in zip(in_f32, on_f32) for k in a) <= bound


# The port's household at the file's steady state, each residual's limit:
# one Bellman step moves the value by at most the recipe's VFI stopping
# change (1e-14) and its Aitken tail; the policies are that step's; one
# period of the lottery and the Markov mix moves D by at most the recipe's
# invariant-solve stopping change (1e-16) and its tail; the aggregates are
# Σ policy·D.
FIXED_POINT = {"bellman": 1e-13, "policies": 1e-10, "transition": 1e-15, "aggregates": 1e-12}


@pytest.fixture(scope="module")
def port_at_shipped_steady_state() -> dict:
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.ops.transition import exog_apply, lottery_apply_multi

    model = published_width(load_model("hank_two_asset", T=3, device="cpu"))
    ss = shipped_steady_state()
    xvals = {k: torch.tensor(ss["vars"][k], dtype=f64) for k in model.var_names()}
    value, D = torch.tensor(ss["value"]), torch.tensor(ss["D"])
    step = model.value_fn(value, xvals, model)
    endog = model.endog_dims()
    D1 = exog_apply(lottery_apply_multi([step[d.policy_var] for d in endog], D,
                                        [d.grid for d in endog]),
                    [d.transition for d in model.exog_dims()], len(endog))
    return {"bellman": float((step["Value"] - value).abs().max()),
            "policies": max(float((step[k] - torch.tensor(ss["policies"][k])).abs().max())
                            for k in KEYS),
            "transition": float((D1 - D).abs().max()),
            "aggregates": max(abs(float(torch.sum(torch.tensor(ss["policies"][k]) * D))
                                  - ss["vars"][k]) for k in KEYS)}


@pytest.mark.parametrize("what", sorted(FIXED_POINT))
def test_shipped_steady_state_is_the_ports_household_fixed_point(port_at_shipped_steady_state,
                                                                  what):
    """The file's steady state is a fixed point of the port's household, not
    only aggregates that satisfy the equations: one Bellman step
    (`ValueFunction`) returns its value and its policies, one period of the
    distribution (`lottery_apply_multi` + `exog_apply`) returns its D, and
    its B, A, C are Σ policy·D; each within `FIXED_POINT`."""
    assert port_at_shipped_steady_state[what] <= FIXED_POINT[what]


@pytest.mark.slow
def test_shipped_steady_state_is_hank_tpus_household():
    """`hank_tpu`'s household at the file's prices (`jax_household_large`:
    its VFI from its constant start, its transition iterated from the
    uniform distribution) gives the file's value, policies and D, and its
    aggregates clear both markets: the file's steady state is the JAX
    package's fixed point, not only the port's."""
    ss = shipped_steady_state()
    hh = jax_household_large(ss)
    assert hh["iterations"] < 400_000 and hh["transition_residual"] <= 1e-13
    assert np.max(np.abs(hh["value"] - ss["value"])) <= 1e-10
    assert max(np.max(np.abs(hh["policies"][k] - ss["policies"][k])) for k in KEYS) <= 1e-8
    assert np.max(np.abs(hh["D"] - ss["D"])) <= 1e-10
    assert np.max(np.abs(hh["F_ss"])) <= 5e-9


@pytest.mark.slow
@pytest.mark.parametrize("grid,diverges", [((50, 70), True), ((48, 64), False)])
def test_hank_tpus_own_invariant_solve_at_the_files_prices(grid, diverges):
    """Why the file's steady state is not `hank_tpu`'s `find_ss` output:
    at the file's prices `hank_tpu`'s own steady-state household
    (`make_ss_pipeline`'s, whose Aitken-accelerated invariant solve `find_ss`
    evaluates every time) diverges at 50×70 (its D grows past 1e10 and the
    market residuals with it), while at 48×64 the same solve converges.
    Its VFI and its transition operator iterated plainly do converge at
    50×70, to the file's arrays (`test_shipped_steady_state_is_hank_tpus_household`)."""
    from tests.two_asset_50x70_recipe import jax_find_ss_household

    hh = jax_find_ss_household(n_b=grid[0], n_a=grid[1])
    assert (hh["max_abs_D"] > 1e10) == diverges
    assert (np.max(np.abs(hh["F_ss"])) > 1e6) == diverges


@pytest.mark.parametrize("grid", [(40, 20), (50, 70)])
def test_seeded_prices_put_the_plain_f32_backward_past_the_card_bound(grid):
    """Why the card holds kernel 5 to 5e-5·scale of its plain version at
    50×70 on the household's own prices and value: on the seeded synthetic
    prices and V_T of `tests/test_torch_sweep_bits.two_asset_prices` (seed
    7, T = 12) the plain version run in f32 is itself past that bound of
    the plain version in f64, at 40×20 (where the routes table the
    brackets) as at 50×70 (where they do not). The EGM in f32 is that
    sensitive on these inputs, whichever branch runs; the card test holds
    kernel 5 there to twice the plain f32 version's error instead."""
    from tests.test_torch_sweep_bits import two_asset_on, two_asset_prices

    model = two_asset_on(torch.device("cpu"), *grid)
    prices, tangents, VT = two_asset_prices(model, torch.float32, 7)
    ref, _ = fs2.fused2_policies_jvp_reference(*(q.double() for q in (*prices, *tangents)),
                                               VT.double(), model)
    ref32, _ = fs2.fused2_policies_jvp_reference(*prices, *tangents, VT,
                                                 fs2.cast_model(model, torch.float32))
    scale = max(float(r.abs().max()) for r in ref.values())
    err = max(float((ref32[k].double() - ref[k]).abs().max()) for k in ref)
    assert 5e-5 * scale < err <= 1e-3 * scale


@pytest.mark.slow
def test_shipped_large_root_is_rebuilt_and_the_port_solves_to_it():
    """Seeded from `hank_tpu`'s steady state at the file's prices
    (`jax_household_large`'s value, policies, D and aggregates), the
    recipe's path solve (`hank_tpu`'s J̄ and Newton-Krylov) lands within
    1e-7 of the shipped root (the two steady states agree to ~1e-9), and the
    port's CPU solve from the same steady state (`run.solve_model`'s route:
    f32-direction Newton-Krylov to eps 1e-10, plain versions, the port's own
    J̄) reaches `hank_tpu`'s root within 1e-9."""
    from hank_tpu_torch import run
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.utils.checkpoint import save_steady_state, steady_state_from_numpy

    hh = jax_household_large()
    steady = {"vars": hh["vars"], "policies": hh["policies"], "D": hh["D"],
              "value": hh["value"]}
    ref = jax_cpu_root_large(steady)
    assert float(ref["residual_norm"]) < 1e-10
    with np.load(LARGE_FILE) as z:
        assert list(z["var_names"]) == list(ref["var_names"])
        assert np.max(np.abs(z["x"] - ref["x"])) <= 1e-7
    _, _, T = LARGE
    model = published_width(load_model("hank_two_asset", T=T, device="cpu"))
    ss = steady_state_from_numpy(steady, device="cpu")
    with tempfile.TemporaryDirectory() as cache:
        os.environ["HANK_TPU_TORCH_CACHE"] = cache
        try:
            save_steady_state(ss, model, "initial")
            x, info, _, _ = run.solve_model(model, method="newton_krylov",
                                            direction_dtype=torch.float32, eps=1e-10,
                                            verbose=False)
        finally:
            os.environ.pop("HANK_TPU_TORCH_CACHE")
    assert info["residual_norm"] < 1e-10
    assert np.max(np.abs(np.asarray(x).reshape(-1) - ref["x"])) <= 1e-9
