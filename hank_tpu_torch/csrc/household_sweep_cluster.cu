// Household sweep for the canonical one-asset CRRA EGM model family
// (Krusell-Smith) on one thread-block cluster per path: the one-asset sweeps
// at the grids past one block's shared memory. A backward EGM recursion over
// T-1 periods, then the forward Young-lottery push-forward of the
// distribution, returning the savings and consumption aggregate paths (and,
// with a tangent, their directional derivatives).
//
// household_sweep_cluster_kernel<S, TANGENT, BATCHED>, instantiated as
//   <float, true, false>   in kernel 1's place past its shared memory: every
//       f32 GMRES matvec of a single path there. It replaces the TPU kernel
//       hank_tpu/ops/fused_sweep.py:385 fused_sweep_jvp
//       (_make_fused_sweep_kernel), as kernel 1 does;
//   <double, true, false>  in the f64 tangent sweep's place past its shared
//       memory: every f64 direction of a one-asset solve there (the port's
//       own kernel: the reference takes f64 directions by XLA AD,
//       hank_tpu/solvers/newton.py:389, with no Pallas kernel);
//   <double, false, false> in kernel 2's place past its shared memory: every
//       full-precision residual F(x) of a single path there. It replaces the
//       TPU kernel hank_tpu/ops/fused_ds.py:338 fused_ds_residual_sweep, as
//       kernel 2 does (native FP64 for the double-single pairs);
//   <double, false, true>  the batched kernel 2 past its shared memory: every
//       residual of an ensemble there;
//   <float, true, true>    kernels 3-4 past their shared memory: every
//       lockstep matvec of an ensemble there. It replaces the TPU kernel pair
//       hank_tpu/ops/fused_sweep_batch.py:87 _make_bwd_kernel and :177
//       _make_fwd_kernel, as kernels 3-4 do.
// It computes what household_sweep_ranged_kernel<S, TANGENT, BATCHED, *> of
// csrc/household_sweep.cu computes, bit for bit (chip_smoke.py holds each
// instantiation to the global-state instantiation it takes the place of at
// 1200x7, and to the one-block kernel on every grid both take), on another
// schedule.
//
// The path axis. A batched launch is a grid of (C, B) blocks, one cluster of
// C blocks a path, the path in blockIdx.y; each path reads its own row of the
// prices (and tangents), writes its own slice of the policy scratch, its own
// row of the aggregates and its own two fallback counts at 2 b, at offsets
// path_offset<BATCHED> gives (compiled out of the single-path
// instantiations). V_T, D0, the grid and Pi are shared, so row b is bit for
// bit a single-path launch on row b. The cluster size C is the launch's: a
// single path takes C = cluster_of(n_e); a batch the size
// ops/fused_sweep2.batch_cluster picks for B (fewer blocks a path, more rows
// a block, where that runs fewer waves). Any C gives the same bits: the rows
// a block owns change, no state's arithmetic or order does.
//
// Why a cluster. The global-state instantiation walks all 2(T-1) dependent
// half-periods with one block of 1024 threads on one SM of 132, each thread
// handling ~8 states a stage at 1200x7, every state access an L1 or L2 round
// trip. Only two stages of the sweep read across income rows: the backward
// expectation E[e, a] = sum_k Pi[e, k] V[k, a], and the forward Markov mix
// D'[e', b] = sum_e Pi[e, e'] D_half[e, b]. The bracket search, the
// interpolation, the budget and envelope, the policy clamp and the lottery's
// source ranges stay inside one row. So a cluster of C <= min(n_e, 8) blocks
// (C = min(n_e, 8) on a single path) takes one path, block (rank) r owning the income rows e = r, r + C, ...
// (kernel 5's rule, fused_sweep2.default_bwd_cluster), each block keeping its
// rows of the state in its own SM's shared memory: at 1200x7 one row a
// block, ~1.2 states a thread.
//
// Layout of a block (G = ceil(n_e / C) row slots of n_a, m = G n_a): X and Y
// twice (V and implied wealth backward; D and D_half forward, by period
// parity), P once, their tangents likewise, then the grid with its hat-basis
// neighbours and slopes, labor, Pi, the reduction slots (kRed x 1024) and the
// row flags (cluster_smem_bytes). The policies and their tangents go to the
// global scratch, as in every one-asset sweep.
//
// Cross-row reads go over distributed shared memory
// (cluster.map_shared_rank), in the one-block kernel's order: the
// expectation over k = 0 ... n_e-1, the mix over e = 0 ... n_e-1. X is
// double-buffered in the backward half and Y in the forward half, so one
// cluster barrier a half-period (arrive after the stage that publishes,
// wait before the stage that reads) orders every remote read before the
// owner overwrites the buffer: ~2(T-1) barriers a sweep.
//
// The aggregates keep their bits. The one-block kernel sums each of the four
// aggregates as a fixed-order fold: thread tid adds the terms of states idx =
// tid, tid + 1024, ... over all n states, then a tree over the 1024 partials
// (its levels by barrier, its last five by warp shuffle). Here block 0
// replays exactly that loop and tree for period t once every row's D_{t+1}
// is with its owner: it reads each D_{t+1} and dD_{t+1} from its owner over
// distributed shared memory and the policies from the global scratch, right
// after the next period's barrier, while the other blocks run period t+1's
// mix (D is double-buffered in the forward half too, so D_{t+1} is
// overwritten only after the barrier after that). The fallback rows (rows
// that took the count loop or the full source scan) are counted by each
// block's thread 0 for its own rows; block 0 sums the integers at the end,
// so the counts are exact in any order.
//
// Every per-element expression is the ranged kernel's, written as it writes
// them, with its one explicit fma (the envelope's tangent dX). Without a
// tangent (kernel 2's places) the state is X, Y twice and P (5 m values) and
// block 0's tree folds two sums, as the ranged kernel's <double, false, *>.
//
// What bounds it: latency, as every one-asset sweep: the 2(T-1) dependent
// half-periods, each a few barriers (one of them cluster-wide) around
// O(log n_a) searches and a lottery over each destination's source range.
// Block 0 carries the aggregate replay (n states, ~8 a thread at 1200x7) on
// top of its own rows.
//
// Determinism: no float atomics; every sum has one owner and one order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // power of two: the tree reduction needs it
constexpr int kMaxCluster = 8;  // the portable cluster size

template <typename S> __device__ __forceinline__ S spow(S a, S b);
template <> __device__ __forceinline__ float spow<float>(float a, float b) { return powf(a, b); }
template <> __device__ __forceinline__ double spow<double>(double a, double b) { return pow(a, b); }

// Cycle stamps of each block's thread 0, compiled only into the measurement
// build of hank_tpu_torch/tools/sweep_split.py (nvcc -DHANK_CLUSTER_STAMPS);
// without the macro CLUSTER_STAMP is empty. CLUSTER_STAMP(i) adds the cycles
// since the last stamp to slot i of the block's rank (kClusterSlots a rank,
// summed over launches into g_cluster_stamps): 0 set-up, 1 the backward
// half's waits and the forward half's head, 2 the expectation and Euler
// inversion, 3 the row check, 4 bracket, lerp and envelope, 5 the forward
// clamp, 6 the lottery, 7 the forward wait, 8 the Markov mix, 9 block 0's
// aggregates, 10 the end.
#ifdef HANK_CLUSTER_STAMPS
constexpr int kClusterSlots = 16;
__device__ unsigned long long g_cluster_stamps[kMaxCluster * kClusterSlots];
#define CLUSTER_STAMPS_INIT                                                      \
    __shared__ unsigned long long cl_slot[kClusterSlots];                       \
    long long cl_last = clock64();                                              \
    if (threadIdx.x < kClusterSlots) cl_slot[threadIdx.x] = 0;
#define CLUSTER_STAMP(i)                                                         \
    if (threadIdx.x == 0) {                                                      \
        const long long cl_now = clock64();                                     \
        cl_slot[i] += cl_now - cl_last;                                         \
        cl_last = cl_now;                                                       \
    }
#define CLUSTER_STAMPS_SAVE(rank)                                                \
    if (threadIdx.x == 0)                                                        \
        for (int i = 0; i < kClusterSlots; ++i)                                 \
            atomicAdd(&g_cluster_stamps[(rank) * kClusterSlots + i], cl_slot[i]);
#else
#define CLUSTER_STAMPS_INIT
#define CLUSTER_STAMP(i)
#define CLUSTER_STAMPS_SAVE(rank)
#endif

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The cluster a single path takes: one block an income row, at most
// kMaxCluster.
int cluster_of(int n_e) { return n_e < kMaxCluster ? n_e : kMaxCluster; }

// Shared memory of a block of a cluster of C: the state (10 m values with a
// tangent, 5 m without), the grid tables (5 n_a), labor, Pi, the reduction
// slots and the row flags (G implied-wealth flags, 2 G policy flags, 2
// counts).
template <typename S, bool TANGENT>
size_t cluster_smem_bytes(int n_a, int n_e, int C) {
    const size_t G = (n_e + C - 1) / C, m = G * n_a;
    return sizeof(S) * ((TANGENT ? 10 : 5) * m + 5 * (size_t)n_a + n_e + (size_t)n_e * n_e
                        + (TANGENT ? 4 : 2) * kThreads)
           + sizeof(int) * (3 * G + 2);
}

// The path of a batched launch (blockIdx.y) times `per_path` elements; 0
// without BATCHED, which compiles it out. blockIdx.y is read anew at every
// use (a volatile read the compiler cannot hoist), so no path offset stays
// live in registers across the periods (household_sweep2.cu's rule).
template <bool BATCHED>
__device__ __forceinline__ size_t path_offset(size_t per_path) {
    if constexpr (BATCHED) {
        unsigned b;
        asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(b));
        return b * per_path;
    } else {
        return 0;
    }
}

template <typename S, bool TANGENT, bool BATCHED>
__global__ void __launch_bounds__(kThreads) household_sweep_cluster_kernel(
    const S* __restrict__ r_path, const S* __restrict__ w_path,     // (B, Tm1)
    const S* __restrict__ dr_path, const S* __restrict__ dw_path,   // (B, Tm1) or null
    const S* __restrict__ V_T, const S* __restrict__ D0,            // (n_e, n_a)
    const S* __restrict__ grid_g, const S* __restrict__ egrid_g,    // (n_a,), (n_e,)
    const S* __restrict__ Pi_g,                                     // (n_e, n_e) row-stochastic
    S* __restrict__ pol_scr, S* __restrict__ dpol_scr,              // (B, Tm1, n_e, n_a)
    S* __restrict__ agg, S* __restrict__ dagg,                      // (B, Tm1)
    S* __restrict__ aggc, S* __restrict__ daggc,                    // (B, Tm1)
    int* __restrict__ fallback,                                     // (B, 2) or null
    int Tm1, int n_a, int n_e, S beta, S gamma, S borrow_cons)
{
    constexpr int kRed = TANGENT ? 4 : 2;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    S* smem = reinterpret_cast<S*>(smem_raw);
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int G = (n_e + C - 1) / C;              // row slots of a block
    const int own = (n_e - rank + C - 1) / C;     // rows rank, rank + C, ...
    const int m = G * n_a, my_n = own * n_a;
    const int n = n_a * n_e;
    const int tid = threadIdx.x;
    CLUSTER_STAMPS_INIT

    // Row slot gi of a block holds income row rank + gi * C; buffer p of X2,
    // Y2 and their tangents holds the values of period parity p.
    S* X2 = smem;                // V (backward) / D (forward), two periods
    S* Y2 = X2 + 2 * m;          // implied wealth (backward, slot 0) / D_half (forward)
    S* P = Y2 + 2 * m;           // clipped policy (forward)
    S* dX2 = P + m;              // tangents (TANGENT only)
    S* dY2 = dX2 + 2 * m;
    S* dQ = dY2 + 2 * m;         // dpol * D (forward)
    S* g = smem + (TANGENT ? 10 : 5) * (size_t)m;
    S* glo = g + n_a;
    S* ghi = glo + n_a;
    S* iup = ghi + n_a;
    S* idn = iup + n_a;
    S* lab = idn + n_a;
    S* Pi = lab + n_e;
    S* red = Pi + n_e * n_e;     // (kRed, kThreads): block 0's aggregate tree
    int* kmono = reinterpret_cast<int*>(red + kRed * kThreads);   // implied wealth rows
    int* pmono = kmono + G;      // policy rows, two periods
    int* fell = pmono + 2 * G;   // this block's fallback counts, for block 0
    int fell_k = 0, fell_p = 0;  // thread 0's fallback counts of its block's rows

    const S tiny = S(1e-12);
    const S inv_g = S(-1) / gamma;

    // Block 0: the aggregates of period t, the one-block kernel's fold and
    // tree, with every row's D_{t+1} read from its owner.
    auto aggregates = [&](int t) {
        const S r = (r_path + path_offset<BATCHED>(Tm1))[t];
        const S w = (w_path + path_offset<BATCHED>(Tm1))[t];
        const S dr = TANGENT ? (dr_path + path_offset<BATCHED>(Tm1))[t] : S(0);
        const S dw = TANGENT ? (dw_path + path_offset<BATCHED>(Tm1))[t] : S(0);
        const S one_r = S(1) + r;
        const S* pol_t = pol_scr + path_offset<BATCHED>((size_t)Tm1 * n) + (size_t)t * n;
        const S* dpol_t =
            TANGENT ? dpol_scr + path_offset<BATCHED>((size_t)Tm1 * n) + (size_t)t * n : nullptr;
        const S* Dq = X2 + ((t + 1) & 1) * m;
        const S* dDq = dX2 + ((t + 1) & 1) * m;
        S s0 = S(0), s1 = S(0), s2 = S(0), s3 = S(0);
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e2 = idx / n_a;
            const int b = idx - e2 * n_a;
            const int slot = (e2 / C) * n_a + b, owner = e2 % C;
            const S Dn = cluster.map_shared_rank(Dq, owner)[slot];
            const S pol = pol_t[idx];
            const S cg_raw = one_r * g[b] + w * lab[e2] - pol;
            const bool cg_live = cg_raw > tiny;
            const S cg = cg_live ? cg_raw : tiny;
            s0 += pol * Dn;
            s2 += cg * Dn;
            if (TANGENT) {
                const S dDn = cluster.map_shared_rank(dDq, owner)[slot];
                const S dpol = dpol_t[idx];
                const S dcg = cg_live ? dr * g[b] + dw * lab[e2] - dpol : S(0);
                s1 += dpol * Dn + pol * dDn;
                s3 += dcg * Dn + cg * dDn;
            }
        }
        red[0 * kThreads + tid] = s0;
        red[1 * kThreads + tid] = s2;
        if (TANGENT) {
            red[(kRed - 2) * kThreads + tid] = s1;
            red[(kRed - 1) * kThreads + tid] = s3;
        }
        __syncthreads();
        for (int s = kThreads / 2; s >= 32; s >>= 1) {
            if (tid < s) {
                for (int q = 0; q < kRed; ++q)
                    red[q * kThreads + tid] += red[q * kThreads + tid + s];
            }
            __syncthreads();
        }
        if (tid < 32) {
            // Strides 16 ... 1 in warp 0: lane i adds lane i + s, the tree's
            // own pairing, so the sums keep their bits.
            S v[kRed];
            for (int q = 0; q < kRed; ++q) v[q] = red[q * kThreads + tid];
            for (int s = 16; s > 0; s >>= 1)
                for (int q = 0; q < kRed; ++q) v[q] += __shfl_down_sync(0xffffffffu, v[q], s);
            if (tid == 0) {
                (agg + path_offset<BATCHED>(Tm1))[t] = v[0];
                (aggc + path_offset<BATCHED>(Tm1))[t] = v[1];
                if (TANGENT) {
                    (dagg + path_offset<BATCHED>(Tm1))[t] = v[kRed - 2];
                    (daggc + path_offset<BATCHED>(Tm1))[t] = v[kRed - 1];
                }
            }
        }
    };

    for (int i = tid; i < n_a; i += kThreads) g[i] = grid_g[i];
    for (int i = tid; i < n_e; i += kThreads) lab[i] = egrid_g[i];
    for (int i = tid; i < n_e * n_e; i += kThreads) Pi[i] = Pi_g[i];
    // V_T of this block's rows, in the buffer period Tm1 - 1 reads.
    for (int j = tid; j < my_n; j += kThreads) {
        const int gi = j / n_a, a = j - gi * n_a, e = rank + gi * C;
        X2[(Tm1 & 1) * m + j] = V_T[e * n_a + a];
        if (TANGENT) dX2[(Tm1 & 1) * m + j] = S(0);
    }
    __syncthreads();
    for (int i = tid; i < n_a; i += kThreads) {
        const S lo = i == 0 ? g[0] - (g[1] - g[0]) : g[i - 1];
        const S hi = i == n_a - 1 ? g[n_a - 1] + (g[n_a - 1] - g[n_a - 2]) : g[i + 1];
        glo[i] = lo;
        ghi[i] = hi;
        iup[i] = S(1) / (g[i] - lo);
        idn[i] = S(1) / (hi - g[i]);
    }
    cluster_arrive();   // V_T of this block's rows is published
    CLUSTER_STAMP(0)

    // ── Backward EGM recursion: t = Tm1-1 … 0 ─────────────────────────────
    S* Y = Y2;
    S* dY = dY2;
    for (int t = Tm1 - 1; t >= 0; --t) {
        const S r = (r_path + path_offset<BATCHED>(Tm1))[t];
        const S w = (w_path + path_offset<BATCHED>(Tm1))[t];
        const S dr = TANGENT ? (dr_path + path_offset<BATCHED>(Tm1))[t] : S(0);
        const S dw = TANGENT ? (dw_path + path_offset<BATCHED>(Tm1))[t] : S(0);
        const S one_r = S(1) + r;
        const S* Xn = X2 + ((t + 1) & 1) * m;      // V_{t+1}, every row with its owner
        const S* dXn = dX2 + ((t + 1) & 1) * m;
        S* Xo = X2 + (t & 1) * m;                  // V_t of this block's rows
        S* dXo = dX2 + (t & 1) * m;
        cluster_wait();     // every row's V_{t+1} is with its owner
        CLUSTER_STAMP(1)
        for (int gi = tid; gi < own; gi += kThreads) kmono[gi] = 1;   // read last in period t+1

        // 1-3. Expectation over e' (rows from their owners), Euler
        //      inversion, implied wealth.
        for (int j = tid; j < my_n; j += kThreads) {
            const int gi = j / n_a, a = j - gi * n_a, e = rank + gi * C;
            S E = S(0), dE = S(0);
            for (int k = 0; k < n_e; ++k) {
                const int slot = (k / C) * n_a + a, owner = k % C;
                E += Pi[e * n_e + k] * cluster.map_shared_rank(Xn, owner)[slot];
                if (TANGENT) dE += Pi[e * n_e + k] * cluster.map_shared_rank(dXn, owner)[slot];
            }
            const bool live = E > tiny;
            E = live ? E : tiny;
            const S c = spow(beta * E, inv_g);
            const S implied = (c - w * lab[e] + g[a]) / one_r;
            Y[j] = implied;
            if (TANGENT) {
                const S dc = live ? inv_g * c / E * dE : S(0);
                dY[j] = (dc - dw * lab[e]) / one_r - implied * dr / one_r;
            }
        }
        __syncthreads();
        CLUSTER_STAMP(2)

        // Which implied-wealth rows are non-decreasing.
        for (int j = tid; j < my_n; j += kThreads) {
            const int a = j - (j / n_a) * n_a;
            if (a < n_a - 1 && !(Y[j] <= Y[j + 1])) kmono[j / n_a] = 0;
        }
        __syncthreads();
        if (fallback != nullptr && tid == 0)
            for (int gi = 0; gi < own; ++gi) fell_k += kmono[gi] == 0;
        CLUSTER_STAMP(3)

        // 4-6. Interpolate the savings policy onto the grid, borrowing clip,
        //      budget, envelope.
        for (int j = tid; j < my_n; j += kThreads) {
            const int gi = j / n_a, a = j - gi * n_a, e = rank + gi * C;
            const S x = g[a];
            const S* K = Y + gi * n_a;
            int cnt = 0;
            if (kmono[gi]) {
                int hi_k = n_a;      // lower bound: the first k with !(K[k] < x)
                while (cnt < hi_k) {
                    const int mid = (cnt + hi_k) >> 1;
                    if (K[mid] < x) cnt = mid + 1; else hi_k = mid;
                }
            } else {
                for (int k = 0; k < n_a; ++k) cnt += K[k] < x ? 1 : 0;
            }
            const int jb = min(max(cnt, 1), n_a - 1);
            const S lo = K[jb - 1], hi = K[jb];
            const S vlo = g[jb - 1], vhi = g[jb];
            const S den = hi - lo;
            const S safe = den > S(0) ? den : S(1);
            const S tw_raw = (x - lo) / safe;
            const S tw = fmin(fmax(tw_raw, S(0)), S(1));
            S pol = vlo + tw * (vhi - vlo);
            S dpol = S(0);
            if (TANGENT) {
                // Interior: lo < x <= hi, on the operands (the template's tie rule).
                const bool interior = x > lo && x <= hi && den > S(0);
                const S dlo = dY[gi * n_a + jb - 1], dhi = dY[gi * n_a + jb];
                const S dtw = interior ? -(dlo + tw * (dhi - dlo)) / safe : S(0);
                dpol = dtw * (vhi - vlo);
            }
            const bool unbound = pol > borrow_cons;
            pol = unbound ? pol : borrow_cons;
            const S cg_raw = one_r * x + w * lab[e] - pol;
            const bool cg_live = cg_raw > tiny;
            const S cg = cg_live ? cg_raw : tiny;
            const S cpow = spow(cg, -gamma);
            const size_t at = path_offset<BATCHED>((size_t)Tm1 * n) + (size_t)t * n + e * n_a + a;
            Xo[j] = one_r * cpow;
            pol_scr[at] = pol;
            if (TANGENT) {
                dpol = unbound ? dpol : S(0);
                const S dcg = cg_live ? dr * x + dw * lab[e] - dpol : S(0);
                // The ranged kernel's contraction, written out (its note).
                dXo[j] = fma(dr, cpow, one_r * (-gamma) * cpow / cg * dcg);
                dpol_scr[at] = dpol;
            }
        }
        cluster_arrive();   // V_t of this block's rows is published
        CLUSTER_STAMP(4)
    }

    // ── Forward push-forward: t = 0 … Tm1-1 ───────────────────────────────
    cluster_wait();     // every read of V is done: X2 takes D
    for (int j = tid; j < my_n; j += kThreads) {
        const int gi = j / n_a, a = j - gi * n_a, e = rank + gi * C;
        X2[j] = D0[e * n_a + a];                   // D_0 in buffer 0
        if (TANGENT) dX2[j] = S(0);
    }
    for (int i = tid; i < 2 * G; i += kThreads) pmono[i] = 1;
    __syncthreads();
    CLUSTER_STAMP(1)
    const S g_bot = g[0], g_top = g[n_a - 1];
    for (int t = 0; t < Tm1; ++t) {
        const S* pol_t = pol_scr + path_offset<BATCHED>((size_t)Tm1 * n) + (size_t)t * n;
        const S* dpol_t =
            TANGENT ? dpol_scr + path_offset<BATCHED>((size_t)Tm1 * n) + (size_t)t * n : nullptr;
        const S* D = X2 + (t & 1) * m;             // D_t of this block's rows
        const S* dD = dX2 + (t & 1) * m;
        S* Dn_o = X2 + ((t + 1) & 1) * m;          // D_{t+1} of this block's rows
        S* dDn_o = dX2 + ((t + 1) & 1) * m;
        S* Yt = Y2 + (t & 1) * m;                  // D_half of period t
        S* dYt = dY2 + (t & 1) * m;
        int* pm = pmono + (t & 1) * G;

        // The clamped policy, and whether its rows are non-decreasing.
        for (int j = tid; j < my_n; j += kThreads) {
            const int gi = j / n_a, a = j - gi * n_a, e = rank + gi * C;
            const int idx = e * n_a + a;
            const S p = fmin(fmax(pol_t[idx], g_bot), g_top);
            P[j] = p;
            if (TANGENT) dQ[j] = dpol_t[idx] * D[j];
            if (a < n_a - 1 && !(p <= fmin(fmax(pol_t[idx + 1], g_bot), g_top)))
                pm[gi] = 0;
        }
        __syncthreads();
        // Period t+1's flags: their last reader, period t-1's lottery, is
        // behind the barrier of period t-1.
        for (int gi = tid; gi < own; gi += kThreads) pmono[((t + 1) & 1) * G + gi] = 1;
        if (fallback != nullptr && tid == 0)
            for (int gi = 0; gi < own; ++gi) fell_p += pm[gi] == 0;
        CLUSTER_STAMP(5)

        // Hat-basis Young lottery: D_half[e, b] = Σ_a hat_b(p[e, a]) D[e, a].
        for (int j = tid; j < my_n; j += kThreads) {
            const int gi = j / n_a;
            const int b = j - gi * n_a;
            const S gl = glo[b], gh = ghi[b], iu = iup[b], id = idn[b];
            const S* Pe = P + gi * n_a;
            const S* Xe = D + gi * n_a;
            S acc = S(0), dacc = S(0);
            const S gb = g[b];
            int a_begin = 0, a_end = n_a;
            if (pm[gi]) {
                int hi_a = n_a;      // the first a with P[a] > gl
                while (a_begin < hi_a) {
                    const int mid = (a_begin + hi_a) >> 1;
                    if (Pe[mid] > gl) hi_a = mid; else a_begin = mid + 1;
                }
                int lo_a = a_begin;  // the first a with P[a] > gh
                while (lo_a < a_end) {
                    const int mid = (lo_a + a_end) >> 1;
                    if (Pe[mid] > gh) a_end = mid; else lo_a = mid + 1;
                }
            }
            for (int a = a_begin; a < a_end; ++a) {
                const S p = Pe[a];
                // Outside (g_{b-1}, g_{b+1}] both the hat and its left-sided
                // slope are exactly 0 (the template's rule).
                if (!(p > gl && p <= gh)) continue;
                const S up = (p - gl) * iu;
                const S down = (gh - p) * id;
                const S hat = down < up ? down : up;
                acc += hat * Xe[a];
                if (TANGENT) {
                    const S slope = p > gb ? -id : iu;
                    dacc += hat * dD[gi * n_a + a] + slope * dQ[gi * n_a + a];
                }
            }
            Yt[j] = acc;
            if (TANGENT) dYt[j] = dacc;
        }
        cluster_arrive();   // D_half of period t is published
        CLUSTER_STAMP(6)
        cluster_wait();     // every row's D_half of t, and its D_t, is with its owner
        CLUSTER_STAMP(7)

        // Markov mix D'[e', b] = Σ_e Pi[e, e'] D_half[e, b] (rows from their
        // owners).
        for (int j = tid; j < my_n; j += kThreads) {
            const int gi = j / n_a, b = j - gi * n_a, e2 = rank + gi * C;
            S Dn = S(0), dDn = S(0);
            for (int e = 0; e < n_e; ++e) {
                const int slot = (e / C) * n_a + b, owner = e % C;
                Dn += Pi[e * n_e + e2] * cluster.map_shared_rank(Yt, owner)[slot];
                if (TANGENT)
                    dDn += Pi[e * n_e + e2] * cluster.map_shared_rank(dYt, owner)[slot];
            }
            Dn_o[j] = Dn;
            if (TANGENT) dDn_o[j] = dDn;
        }
        CLUSTER_STAMP(8)
        // Period t-1's aggregates: D_t is complete since the barrier above,
        // and is overwritten only after the next one, which block 0 reaches
        // after this.
        if (rank == 0 && t > 0) aggregates(t - 1);
        CLUSTER_STAMP(9)
    }
    if (fallback != nullptr && tid == 0) {
        fell[0] = fell_k;
        fell[1] = fell_p;
    }
    cluster_arrive();
    cluster_wait();     // every row's D_{Tm1}, and every block's counts
    if (rank == 0) {
        aggregates(Tm1 - 1);
        if (fallback != nullptr && tid == 0) {
            int k = 0, p = 0;
            for (int q = 0; q < C; ++q) {
                const int* f = cluster.map_shared_rank(fell, q);
                k += f[0];
                p += f[1];
            }
            (fallback + path_offset<BATCHED>(2))[0] = k;
            (fallback + path_offset<BATCHED>(2))[1] = p;
        }
    }
    cluster_arrive();
    cluster_wait();     // no block leaves while block 0 reads its shared memory
    CLUSTER_STAMP(10)
    CLUSTER_STAMPS_SAVE(rank)
}

// A grid of `paths` clusters of `cluster` blocks of `threads` threads with
// `smem` bytes of dynamic shared memory each: the kernel's attributes set,
// `cfg` filled (its cluster dimension in `attr`), and in `clusters` how many
// such clusters the card holds at once (cudaOccupancyMaxActiveClusters).
template <typename... KArgs>
cudaError_t cluster_config(void (*kernel)(KArgs...), int cluster, int paths, int threads,
                           size_t smem, void* stream, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute* attr, int& clusters) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cfg = {};
    cfg.gridDim = dim3(cluster, paths, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    clusters = 0;
    return cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
}

// `paths` clusters of `kernel` on `stream`; cudaErrorLaunchOutOfResources when
// the card cannot hold one such cluster.
template <typename... KArgs, typename... Args>
cudaError_t launch_paths(void (*kernel)(KArgs...), int cluster, int paths, int threads,
                         size_t smem, void* stream, Args... args) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int clusters = 0;
    cudaError_t err = cluster_config(kernel, cluster, paths, threads, smem, stream, cfg, attr,
                                     clusters);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// One cluster of `cluster` blocks a path for each of the B paths (B = 1
// without BATCHED) of household_sweep_cluster_kernel<S, TANGENT, BATCHED>.
template <typename S, bool TANGENT, bool BATCHED>
int launch_cluster(const void* r, const void* w, const void* dr, const void* dw,
                   const void* V_T, const void* D0, const void* grid, const void* egrid,
                   const void* Pi, void* pol, void* dpol, void* agg, void* dagg, void* aggc,
                   void* daggc, void* fallback, int B, int Tm1, int n_a, int n_e, int cluster,
                   double beta, double gamma, double borrow_cons, void* stream) {
    if (cluster < 1 || cluster > (n_e < kMaxCluster ? n_e : kMaxCluster) || B < 1)
        return (int)cudaErrorInvalidValue;
    return (int)launch_paths(household_sweep_cluster_kernel<S, TANGENT, BATCHED>, cluster, B,
                             kThreads, cluster_smem_bytes<S, TANGENT>(n_a, n_e, cluster), stream,
                             r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol, dpol, agg, dagg, aggc,
                             daggc, fallback, Tm1, n_a, n_e, beta, gamma, borrow_cons);
}

// `which` as ops/cuda_build.py numbers the one-asset kernels: the cluster
// instantiations in kernel 1's place, in the f64 tangent sweep's, in kernels
// 3-4's, in kernel 2's (single path and batched) and in the batched f64
// tangent sweep's.
constexpr int kClusterKernel1 = 11, kClusterJvpF64 = 12, kClusterKernels3_4 = 13,
              kClusterKernel2 = 14, kClusterJvpF64Batch = 17;

}  // namespace

// Plain C interface (loaded with ctypes). Each launcher returns the
// cudaError_t of the attribute calls or of the launch; 0 means the kernel was
// enqueued on `stream`, cudaErrorLaunchOutOfResources that the card holds no
// cluster of this size, cudaErrorInvalidValue a cluster size outside
// [1, min(n_e, 8)]. Arguments as the entry point of csrc/household_sweep.cu
// whose place each takes (without its `_cluster`), the batched ones with the
// cluster size after n_e; `fallback` may be null.
extern "C" {

int hank_sweep_jvp_f32_cluster(const void* r, const void* w, const void* dr, const void* dw,
                               const void* V_T, const void* D0, const void* grid,
                               const void* egrid, const void* Pi, void* pol, void* dpol,
                               void* agg, void* dagg, void* aggc, void* daggc, void* fallback,
                               int Tm1, int n_a, int n_e, double beta, double gamma,
                               double borrow_cons, void* stream) {
    return launch_cluster<float, true, false>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol, dpol,
                                              agg, dagg, aggc, daggc, fallback, 1, Tm1, n_a, n_e,
                                              cluster_of(n_e), beta, gamma, borrow_cons, stream);
}

int hank_sweep_jvp_f64_cluster(const void* r, const void* w, const void* dr, const void* dw,
                               const void* V_T, const void* D0, const void* grid,
                               const void* egrid, const void* Pi, void* pol, void* dpol,
                               void* agg, void* dagg, void* aggc, void* daggc, void* fallback,
                               int Tm1, int n_a, int n_e, double beta, double gamma,
                               double borrow_cons, void* stream) {
    return launch_cluster<double, true, false>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol, dpol,
                                               agg, dagg, aggc, daggc, fallback, 1, Tm1, n_a, n_e,
                                               cluster_of(n_e), beta, gamma, borrow_cons, stream);
}

int hank_sweep_jvp_f32_batch_cluster(const void* r, const void* w, const void* dr,
                                     const void* dw, const void* V_T, const void* D0,
                                     const void* grid, const void* egrid, const void* Pi,
                                     void* pol, void* dpol, void* agg, void* dagg, void* aggc,
                                     void* daggc, void* fallback, int B, int Tm1, int n_a,
                                     int n_e, int cluster, double beta, double gamma,
                                     double borrow_cons, void* stream) {
    return launch_cluster<float, true, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol, dpol,
                                             agg, dagg, aggc, daggc, fallback, B, Tm1, n_a, n_e,
                                             cluster, beta, gamma, borrow_cons, stream);
}

int hank_sweep_jvp_f64_batch_cluster(const void* r, const void* w, const void* dr,
                                     const void* dw, const void* V_T, const void* D0,
                                     const void* grid, const void* egrid, const void* Pi,
                                     void* pol, void* dpol, void* agg, void* dagg, void* aggc,
                                     void* daggc, void* fallback, int B, int Tm1, int n_a,
                                     int n_e, int cluster, double beta, double gamma,
                                     double borrow_cons, void* stream) {
    return launch_cluster<double, true, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol, dpol,
                                              agg, dagg, aggc, daggc, fallback, B, Tm1, n_a, n_e,
                                              cluster, beta, gamma, borrow_cons, stream);
}

int hank_sweep_residual_f64_cluster(const void* r, const void* w, const void* V_T,
                                    const void* D0, const void* grid, const void* egrid,
                                    const void* Pi, void* pol, void* agg, void* aggc,
                                    void* fallback, int Tm1, int n_a, int n_e, double beta,
                                    double gamma, double borrow_cons, void* stream) {
    return launch_cluster<double, false, false>(r, w, nullptr, nullptr, V_T, D0, grid, egrid, Pi,
                                                pol, nullptr, agg, nullptr, aggc, nullptr,
                                                fallback, 1, Tm1, n_a, n_e, cluster_of(n_e), beta,
                                                gamma, borrow_cons, stream);
}

int hank_sweep_residual_f64_batch_cluster(const void* r, const void* w, const void* V_T,
                                          const void* D0, const void* grid, const void* egrid,
                                          const void* Pi, void* pol, void* agg, void* aggc,
                                          void* fallback, int B, int Tm1, int n_a, int n_e,
                                          int cluster, double beta, double gamma,
                                          double borrow_cons, void* stream) {
    return launch_cluster<double, false, true>(r, w, nullptr, nullptr, V_T, D0, grid, egrid, Pi,
                                               pol, nullptr, agg, nullptr, aggc, nullptr,
                                               fallback, B, Tm1, n_a, n_e, cluster, beta, gamma,
                                               borrow_cons, stream);
}

// Shared memory of each block of the cluster instantiation `which` (11:
// <float, true, *>, 12: <double, true, *>, 13: <float, true, *> in kernels
// 3-4's place, 14: <double, false, *>, 17: <double, true, *> in the batched
// f64 tangent sweep's) at an n_a x n_e grid on a cluster of `cluster`
// blocks; 0 for another `which`.
size_t hank_sweep_cluster_smem_bytes(int which, int n_a, int n_e, int cluster) {
    if (cluster < 1) return 0;
    return which == kClusterKernel1 || which == kClusterKernels3_4
               ? cluster_smem_bytes<float, true>(n_a, n_e, cluster)
         : which == kClusterJvpF64 || which == kClusterJvpF64Batch
               ? cluster_smem_bytes<double, true>(n_a, n_e, cluster)
         : which == kClusterKernel2 ? cluster_smem_bytes<double, false>(n_a, n_e, cluster) : 0;
}

// How many clusters of `cluster` blocks of the instantiation `which` (the
// batched one for 13, 14 and 17) the card holds at once at an n_a x n_e grid
// (cudaOccupancyMaxActiveClusters), or -cudaError_t.
int hank_sweep_cluster_max_clusters(int which, int n_a, int n_e, int cluster) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int clusters = 0;
    const size_t smem = hank_sweep_cluster_smem_bytes(which, n_a, n_e, cluster);
    cudaError_t err;
    if (smem == 0)
        err = cudaErrorInvalidValue;
    else if (which == kClusterKernel1)
        err = cluster_config(household_sweep_cluster_kernel<float, true, false>, cluster, 1,
                             kThreads, smem, nullptr, cfg, attr, clusters);
    else if (which == kClusterJvpF64)
        err = cluster_config(household_sweep_cluster_kernel<double, true, false>, cluster, 1,
                             kThreads, smem, nullptr, cfg, attr, clusters);
    else if (which == kClusterKernels3_4)
        err = cluster_config(household_sweep_cluster_kernel<float, true, true>, cluster, 1,
                             kThreads, smem, nullptr, cfg, attr, clusters);
    else if (which == kClusterJvpF64Batch)
        err = cluster_config(household_sweep_cluster_kernel<double, true, true>, cluster, 1,
                             kThreads, smem, nullptr, cfg, attr, clusters);
    else
        err = cluster_config(household_sweep_cluster_kernel<double, false, true>, cluster, 1,
                             kThreads, smem, nullptr, cfg, attr, clusters);
    return err == cudaSuccess ? clusters : -(int)err;
}

const char* hank_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef HANK_CLUSTER_STAMPS
// The measurement build's stamps (kMaxCluster x kClusterSlots unsigned long
// long) into `out` (host memory), then set to zero; or only set to zero when
// `out` is null.
int hank_sweep_cluster_stamps(void* out) {
    cudaError_t err = cudaSuccess;
    if (out != nullptr)
        err = cudaMemcpyFromSymbol(out, g_cluster_stamps, sizeof(g_cluster_stamps));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[kMaxCluster * kClusterSlots] = {};
    return (int)cudaMemcpyToSymbol(g_cluster_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"
