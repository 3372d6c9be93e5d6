// Household sweep for the canonical one-asset CRRA EGM model family
// (Krusell-Smith): a backward EGM recursion over T-1 periods, then the
// forward Young-lottery push-forward of the distribution, returning the
// savings and consumption aggregate paths.
//
// One source, two kernel templates with a grid axis over paths
// (gridDim.x = B, one block per path), in two arithmetics, each built for
// B = 1 (path offset compiled out) and for B > 1, and two kernels of their
// own:
//   household_sweep_ranged_kernel<S, TANGENT, BATCHED, GLOBAL_STATE>: the
//       template's arithmetic with kernel 1's binary-search brackets and
//       lottery source ranges (its own note below). With its state in shared
//       memory (GLOBAL_STATE = false) it serves
//     <float, true, true>    kernels 3-4, the f32 primal + tangent (dual
//       numbers) sweep over B > 1 paths, which replaces the TPU kernel pair
//       of hank_tpu/ops/fused_sweep_batch.py (_make_bwd_kernel and
//       _make_fwd_kernel), every lockstep matvec of an ensemble. The TPU
//       split the batch into a backward and a forward kernel only because
//       B x 137 MB of policies cannot stay in VMEM; here each block keeps
//       its path's policies in its own slice of a global scratch buffer.
//     <double, false, false> kernel 2, values only in native FP64, which
//       replaces the TPU kernel hank_tpu/ops/fused_ds.py:
//       fused_ds_residual_sweep (_make_fused_ds_kernel), here in native FP64
//       instead of double-single f32 pairs, with general pow (no
//       integer-gamma gate);
//     <double, false, true>  the batched kernel 2, the residual of an
//       ensemble;
//     <double, true, false>  the f64 primal + tangent sweep, every f64
//       direction of a one-asset solve on the card (the port's own kernel:
//       the reference takes f64 directions by XLA AD,
//       hank_tpu/solvers/newton.py:389, with no Pallas kernel).
//     With its six state arrays in a global workspace (GLOBAL_STATE = true)
//     the same five arithmetics, <float, true, false> in kernel 1's place,
//     take the grids past one block's shared memory (its note below).
//   household_sweep_jvp_kernel: kernel 1, the single-path f32 primal +
//       tangent sweep, which replaces the TPU kernel
//       hank_tpu/ops/fused_sweep.py:385 fused_sweep_jvp
//       (_make_fused_sweep_kernel), every GMRES matvec of a single path. It
//       is the first form of the design (its own note below);
//   household_sweep_kernel<S, TANGENT, BATCHED>: the previous kernels 1-4,
//       counting brackets and scanning every source, kept unchanged as the
//       yardstick the three kernels above are held to bit for bit (the
//       `_previous` entry points; no solver launches it);
//   forward_scan_kernel: kernel 7, the forward half alone in primal f32
//       over given policies (replaces forward_scan_pallas), with a pre-pass
//       and a post-pass on every SM (its own note below);
//       forward_scan_previous_kernel, the kernel it replaced, kept as its
//       yardstick.
// A block reads only its own row of the price paths (and tangents), writes
// only its own policy slice and output row, and shares V_T, D0, the grids
// and Pi with every other block, so row b of a batched launch does the same
// arithmetic in the same order on the same values as a B = 1 launch on row
// b: the two are bit-identical (chip_smoke.py checks every row).
//
// Semantics follow hank_tpu/ops/fused_sweep.py:215-375 step for step: the
// 1e-12 expectation floor (tangent zeroed where it binds), the Euler
// inversion, the implied wealth, the bracket as the COUNT of knots below the
// query clipped to [1, n_a-1] (right for non-monotone knots too), the
// interior-masked lerp tangent, the borrowing clip that kills the tangent,
// the consumption floor and the envelope; forward: the hat-basis lottery,
// the Markov mix, aggregates against the post-transition distribution.
// One departure: where the query equals a knot exactly, the TPU kernel's mask
// gives the policy a zero tangent; here it takes the bracket's one-sided
// tangent, and the lottery takes left-sided hat slopes at the knots, so
// both agree with the f64 plain version, which sees no tie there.
//
// What bounds it on the H100: it is latency-bound. One block of 1024 threads
// walks the 2*(T-1) periods of its path one after another on a single SM;
// the carries (V, D and their tangents) live in shared memory and the
// per-period policies go to a global scratch buffer. Every period is a few
// block-wide barriers around O(n_e*n_a*n_a) compares and FMAs in the
// template, O(n_e*n_a*log n_a) in the kernels with bracket searches and
// source ranges (on rows checked non-decreasing). One path
// occupies one SM of 132; the path axis fills the others, and past 132
// paths the launch runs in waves. The scratch traffic is small (at B = 64,
// 214 MB written and read once per sweep, ~0.13 ms at HBM rate), so a wave
// costs about what one path does.
//
// Determinism: no float atomics. Each destination is summed by one thread in
// a fixed order and the aggregates by a fixed-order tree, so two runs are
// bit-identical.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // power of two: the tree reduction needs it

template <typename S> __device__ __forceinline__ S spow(S a, S b);
template <> __device__ __forceinline__ float spow<float>(float a, float b) { return powf(a, b); }
template <> __device__ __forceinline__ double spow<double>(double a, double b) { return pow(a, b); }

// Cycle stamps of household_sweep_ranged_kernel, compiled only into the
// measurement build of hank_tpu_torch/tools/sweep_split.py (nvcc
// -DHANK_SWEEP_STAMPS); without the macro every SWEEP_* below is empty and
// the kernels are the library's. Slots (kSweepSlots, summed over the blocks
// of a launch into g_sweep_stamps): 0-6 the cycles of block thread 0 in each
// stage, barrier included (0 expectation and Euler inversion, 1 the
// implied-wealth row check, 2 bracket, lerp and envelope, 3 the policy clamp
// and row check, 4 the lottery, 5 the Markov mix with the aggregates'
// partials, 6 the aggregate tree), 7 the set-up; 10-17 the cycles every
// thread spends in two parts of a stage's loop, summed over the threads (10
// the expectation's fold over e', 11 the Euler inversion and implied
// wealth, 12 the bracket search, 13 the lerp, budget and envelope, 14 the
// lottery's source-range search, 15 its sum, 16 the Markov mix's fold, 17
// the aggregates' terms).
#ifdef HANK_SWEEP_STAMPS
constexpr int kSweepSlots = 24, kSweepParts = 8, kSweepWarps = kThreads / 32;
__device__ unsigned long long g_sweep_stamps[kSweepSlots];
#define SWEEP_STAMPS_INIT                                                        \
    __shared__ unsigned long long sw_slot[kSweepSlots];                         \
    __shared__ unsigned long long sw_warp[kSweepParts * kSweepWarps];           \
    long long sw_b = clock64();                                                 \
    for (int i = threadIdx.x; i < kSweepSlots; i += kThreads) sw_slot[i] = 0;    \
    for (int i = threadIdx.x; i < kSweepParts * kSweepWarps; i += kThreads)      \
        sw_warp[i] = 0;
#define SWEEP_BLOCK(i)                                                           \
    if (threadIdx.x == 0) {                                                      \
        const long long sw_now = clock64();                                     \
        sw_slot[i] += sw_now - sw_b;                                            \
        sw_b = sw_now;                                                          \
    }
#define SWEEP_ACC(a) long long a = 0
#define SWEEP_MARK(v) long long v = clock64()
#define SWEEP_LAP(a, v)                                                          \
    {                                                                           \
        const long long sw_now = clock64();                                     \
        a += sw_now - v;                                                        \
        v = sw_now;                                                             \
    }
// A warp's sum of `a` into its own slot of part i (10 <= i < 18), no atomics.
#define SWEEP_FLUSH(i, a)                                                        \
    {                                                                           \
        long long sw_v = a;                                                     \
        for (int o = 16; o > 0; o >>= 1) sw_v += __shfl_down_sync(0xffffffffu, sw_v, o); \
        if ((threadIdx.x & 31) == 0)                                             \
            sw_warp[((i) - 10) * kSweepWarps + (threadIdx.x >> 5)] += sw_v;      \
    }
#define SWEEP_SAVE()                                                             \
    __syncthreads();                                                            \
    if (threadIdx.x < kSweepParts) {                                             \
        unsigned long long sw_sum = 0;                                          \
        for (int w = 0; w < kSweepWarps; ++w) sw_sum += sw_warp[threadIdx.x * kSweepWarps + w]; \
        sw_slot[10 + threadIdx.x] = sw_sum;                                     \
    }                                                                           \
    __syncthreads();                                                            \
    for (int i = threadIdx.x; i < kSweepSlots; i += kThreads)                    \
        atomicAdd(&g_sweep_stamps[i], sw_slot[i]);
#else
#define SWEEP_STAMPS_INIT
#define SWEEP_BLOCK(i)
#define SWEEP_ACC(a)
#define SWEEP_MARK(v)
#define SWEEP_LAP(a, v)
#define SWEEP_FLUSH(i, a)
#define SWEEP_SAVE()
#endif

template <typename S, bool TANGENT, bool BATCHED>
__global__ void __launch_bounds__(kThreads) household_sweep_kernel(
    const S* __restrict__ r_path, const S* __restrict__ w_path,     // (B, Tm1)
    const S* __restrict__ dr_path, const S* __restrict__ dw_path,   // (B, Tm1) or null
    const S* __restrict__ V_T, const S* __restrict__ D0,            // (n_e, n_a)
    const S* __restrict__ grid_g, const S* __restrict__ egrid_g,    // (n_a,), (n_e,)
    const S* __restrict__ Pi_g,                                     // (n_e, n_e) row-stochastic
    S* __restrict__ pol_scr, S* __restrict__ dpol_scr,              // (B, Tm1, n_e, n_a)
    S* __restrict__ agg, S* __restrict__ dagg,                      // (B, Tm1)
    S* __restrict__ aggc, S* __restrict__ daggc,                    // (B, Tm1)
    int Tm1, int n_a, int n_e, S beta, S gamma, S borrow_cons)
{
    constexpr int kRed = TANGENT ? 4 : 2;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    S* smem = reinterpret_cast<S*>(smem_raw);
    const int n = n_a * n_e;
    const int tid = threadIdx.x;

    // This block's path. Offsets in size_t: at B = 1024 one scratch buffer
    // holds 1024*299*1400 f32 values, past 2^31 bytes. A single-path launch
    // (BATCHED = false) compiles the offset out: with a runtime offset nvcc
    // schedules the f32 body differently and it runs ~9% slower per path.
    const size_t path = BATCHED ? blockIdx.x : 0;
    r_path += path * Tm1;
    w_path += path * Tm1;
    pol_scr += path * Tm1 * n;
    agg += path * Tm1;
    aggc += path * Tm1;
    if (TANGENT) {
        dr_path += path * Tm1;
        dw_path += path * Tm1;
        dpol_scr += path * Tm1 * n;
        dagg += path * Tm1;
        daggc += path * Tm1;
    }

    // Shared layout: three state buffers (and their tangents), the grid
    // with its hat-basis neighbours and slopes, labor, Pi, reduction slots.
    S* X = smem;                 // V (backward) / D (forward)
    S* Y = X + n;                // implied wealth (backward) / D_half (forward)
    S* P = Y + n;                // clipped policy (forward)
    S* dX = P + n;               // tangents (TANGENT only)
    S* dY = dX + n;
    S* dQ = dY + n;              // dpol * D (forward)
    S* g = smem + (TANGENT ? 6 : 3) * n;
    S* glo = g + n_a;
    S* ghi = glo + n_a;
    S* iup = ghi + n_a;
    S* idn = iup + n_a;
    S* lab = idn + n_a;
    S* Pi = lab + n_e;
    S* red = Pi + n_e * n_e;     // (kRed, kThreads)

    const S tiny = S(1e-12);
    const S inv_g = S(-1) / gamma;

    for (int i = tid; i < n_a; i += kThreads) g[i] = grid_g[i];
    for (int i = tid; i < n_e; i += kThreads) lab[i] = egrid_g[i];
    for (int i = tid; i < n_e * n_e; i += kThreads) Pi[i] = Pi_g[i];
    for (int i = tid; i < n; i += kThreads) {
        X[i] = V_T[i];
        if (TANGENT) dX[i] = S(0);
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
    __syncthreads();

    // ── Backward EGM recursion: t = Tm1-1 … 0 ─────────────────────────────
    for (int t = Tm1 - 1; t >= 0; --t) {
        const S r = r_path[t], w = w_path[t];
        const S dr = TANGENT ? dr_path[t] : S(0);
        const S dw = TANGENT ? dw_path[t] : S(0);
        const S one_r = S(1) + r;

        // 1-3. Expectation over e', Euler inversion, implied wealth.
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e = idx / n_a;
            const int a = idx - e * n_a;
            S E = S(0), dE = S(0);
            for (int k = 0; k < n_e; ++k) {
                E += Pi[e * n_e + k] * X[k * n_a + a];
                if (TANGENT) dE += Pi[e * n_e + k] * dX[k * n_a + a];
            }
            const bool live = E > tiny;
            E = live ? E : tiny;
            const S c = spow(beta * E, inv_g);
            const S implied = (c - w * lab[e] + g[a]) / one_r;
            Y[idx] = implied;
            if (TANGENT) {
                const S dc = live ? inv_g * c / E * dE : S(0);
                dY[idx] = (dc - dw * lab[e]) / one_r - implied * dr / one_r;
            }
        }
        __syncthreads();

        // 4-6. Interpolate the savings policy onto the grid, borrowing clip,
        //      budget, envelope.
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e = idx / n_a;
            const int a = idx - e * n_a;
            const S x = g[a];
            const S* K = Y + e * n_a;
            int cnt = 0;
            for (int k = 0; k < n_a; ++k) cnt += K[k] < x ? 1 : 0;
            const int j = min(max(cnt, 1), n_a - 1);
            const S lo = K[j - 1], hi = K[j];
            const S vlo = g[j - 1], vhi = g[j];
            const S den = hi - lo;
            const S safe = den > S(0) ? den : S(1);
            const S tw_raw = (x - lo) / safe;
            const S tw = fmin(fmax(tw_raw, S(0)), S(1));
            S pol = vlo + tw * (vhi - vlo);
            S dpol = S(0);
            if (TANGENT) {
                // Interior: lo < x <= hi, on the operands and not on the
                // rounded quotient. At x == hi (which f32 rounding of the
                // knots produces, e.g. on the 500-point grid) the tangent is
                // the bracket's, one-sided from below, as it is for any x
                // just below hi; the f64 plain version sees no tie there.
                const bool interior = x > lo && x <= hi && den > S(0);
                const S dlo = dY[e * n_a + j - 1], dhi = dY[e * n_a + j];
                const S dtw = interior ? -(dlo + tw * (dhi - dlo)) / safe : S(0);
                dpol = dtw * (vhi - vlo);
            }
            const bool unbound = pol > borrow_cons;
            pol = unbound ? pol : borrow_cons;
            const S cg_raw = one_r * x + w * lab[e] - pol;
            const bool cg_live = cg_raw > tiny;
            const S cg = cg_live ? cg_raw : tiny;
            const S cpow = spow(cg, -gamma);
            X[idx] = one_r * cpow;
            pol_scr[(size_t)t * n + idx] = pol;
            if (TANGENT) {
                dpol = unbound ? dpol : S(0);
                const S dcg = cg_live ? dr * x + dw * lab[e] - dpol : S(0);
                dX[idx] = dr * cpow + one_r * (-gamma) * cpow / cg * dcg;
                dpol_scr[(size_t)t * n + idx] = dpol;
            }
        }
        __syncthreads();
    }

    // ── Forward push-forward: t = 0 … Tm1-1 ───────────────────────────────
    for (int i = tid; i < n; i += kThreads) {
        X[i] = D0[i];
        if (TANGENT) dX[i] = S(0);
    }
    __syncthreads();
    const S g_bot = g[0], g_top = g[n_a - 1];
    for (int t = 0; t < Tm1; ++t) {
        const S r = r_path[t], w = w_path[t];
        const S dr = TANGENT ? dr_path[t] : S(0);
        const S dw = TANGENT ? dw_path[t] : S(0);
        const S one_r = S(1) + r;
        const S* pol_t = pol_scr + (size_t)t * n;
        const S* dpol_t = TANGENT ? dpol_scr + (size_t)t * n : nullptr;

        for (int idx = tid; idx < n; idx += kThreads) {
            P[idx] = fmin(fmax(pol_t[idx], g_bot), g_top);
            if (TANGENT) dQ[idx] = dpol_t[idx] * X[idx];
        }
        __syncthreads();

        // Hat-basis Young lottery: D_half[e, b] = Σ_a hat_b(p[e, a]) D[e, a].
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e = idx / n_a;
            const int b = idx - e * n_a;
            const S gl = glo[b], gh = ghi[b], iu = iup[b], id = idn[b];
            const S* Pe = P + e * n_a;
            const S* Xe = X + e * n_a;
            S acc = S(0), dacc = S(0);
            const S gb = g[b];
            for (int a = 0; a < n_a; ++a) {
                const S p = Pe[a];
                // Outside (g_{b-1}, g_{b+1}] both the hat and its left-sided
                // slope are exactly 0: skipping the source changes no bit of
                // the sums. At p == g_{b+1} the hat is 0 and its slope from
                // the left is -id, the counterpart of destination b+1's +iu,
                // so a policy on a knot moves tangent mass without creating
                // it.
                if (!(p > gl && p <= gh)) continue;
                const S up = (p - gl) * iu;
                const S down = (gh - p) * id;
                const S hat = down < up ? down : up;
                acc += hat * Xe[a];
                if (TANGENT) {
                    const S slope = p > gb ? -id : iu;
                    dacc += hat * dX[e * n_a + a] + slope * dQ[e * n_a + a];
                }
            }
            Y[idx] = acc;
            if (TANGENT) dY[idx] = dacc;
        }
        __syncthreads();

        // Markov mix D'[e', b] = Σ_e Pi[e, e'] D_half[e, b], then this
        // thread's share of the aggregates.
        S s0 = S(0), s1 = S(0), s2 = S(0), s3 = S(0);
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e2 = idx / n_a;
            const int b = idx - e2 * n_a;
            S Dn = S(0), dDn = S(0);
            for (int e = 0; e < n_e; ++e) {
                Dn += Pi[e * n_e + e2] * Y[e * n_a + b];
                if (TANGENT) dDn += Pi[e * n_e + e2] * dY[e * n_a + b];
            }
            X[idx] = Dn;
            const S pol = pol_t[idx];
            const S cg_raw = one_r * g[b] + w * lab[e2] - pol;
            const bool cg_live = cg_raw > tiny;
            const S cg = cg_live ? cg_raw : tiny;
            s0 += pol * Dn;
            s2 += cg * Dn;
            if (TANGENT) {
                dX[idx] = dDn;
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
        for (int s = kThreads / 2; s > 0; s >>= 1) {
            if (tid < s) {
                for (int q = 0; q < kRed; ++q)
                    red[q * kThreads + tid] += red[q * kThreads + tid + s];
            }
            __syncthreads();
        }
        if (tid == 0) {
            agg[t] = red[0];
            aggc[t] = red[kThreads];
            if (TANGENT) {
                dagg[t] = red[(kRed - 2) * kThreads];
                daggc[t] = red[(kRed - 1) * kThreads];
            }
        }
    }
}

template <typename S, bool TANGENT>
size_t smem_bytes(int n_a, int n_e) {
    const size_t n = (size_t)n_a * n_e;
    return sizeof(S) * ((TANGENT ? 6 : 3) * n + 5 * (size_t)n_a + n_e
                        + (size_t)n_e * n_e + (TANGENT ? 4 : 2) * kThreads);
}

template <typename S, bool TANGENT>
int launch(const void* r, const void* w, const void* dr, const void* dw,
           const void* V_T, const void* D0, const void* grid, const void* egrid,
           const void* Pi, void* pol, void* dpol, void* agg, void* dagg,
           void* aggc, void* daggc, int B, int Tm1, int n_a, int n_e,
           double beta, double gamma, double borrow_cons, void* stream) {
    const size_t smem = smem_bytes<S, TANGENT>(n_a, n_e);
    auto kern = B > 1 ? household_sweep_kernel<S, TANGENT, true>
                      : household_sweep_kernel<S, TANGENT, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const S*)r, (const S*)w, (const S*)dr, (const S*)dw,
        (const S*)V_T, (const S*)D0, (const S*)grid, (const S*)egrid,
        (const S*)Pi, (S*)pol, (S*)dpol, (S*)agg, (S*)dagg, (S*)aggc,
        (S*)daggc, Tm1, n_a, n_e, (S)beta, (S)gamma, (S)borrow_cons);
    return (int)cudaGetLastError();
}

// Kernel 1: the single-path f32 primal + tangent sweep, replacing the TPU
// kernel hank_tpu/ops/fused_sweep.py:385 fused_sweep_jvp. Its outputs are
// bit for bit those of household_sweep_kernel<float, true, false> (the
// yardstick: chip_smoke.py holds all four outputs to a B = 1 launch of the
// template). Three changes, none of which alters an operation on a value:
//   (a) The EGM bracket. The template counts the knots of the implied
//       wealth row below each query, O(n_a) compares per state. Here, when
//       the row is non-decreasing (K[k] <= K[k+1] for every k, a test a NaN
//       fails), the count is the row's lower bound of the query, found by
//       binary search in ceil(log2(n_a + 1)) steps: on a non-decreasing row
//       "K[k] < x" is true for a prefix of k, so the count and the lower
//       bound are the same integer, ties included.
//   (b) The lottery. The template scans all n_a sources of a destination b
//       and skips those outside its support gl < P[a] <= gh. When the row of
//       the clamped policy is non-decreasing, those sources are the
//       contiguous range from the first a with P[a] > gl to the first with
//       P[a] > gh: two binary searches. Summed in ascending a they are the
//       same terms in the same order, so the sums have the same bits.
//   (c) The aggregate tree's last five levels (strides 16 ... 1) run in warp
//       0 by __shfl_down_sync: the tree's own pairing, five barriers fewer
//       per forward period.
// A row that is not non-decreasing keeps the template's count loop and full
// scan. The EGM gives monotone rows at and near a steady state, but nothing
// guarantees them: a value function that is not decreasing in wealth (a
// noisy terminal value, an iterate far from the path) bends the implied
// wealth back, and a NaN in a row must give the template's answer too. The
// count bracket makes the policy non-decreasing in the query whatever the
// knots' order, so a policy row goes out of order only by one ulp of
// rounding at a bracket's end or on a grid out of order; the check keeps
// the template's bits there as well. It costs one compare per state per
// period and, in the backward half, one barrier per period. `fallback`,
// when not null, receives the number of (period, income row) pairs that
// took each fallback: [0] implied wealth, [1] policy.
//
// What bounds it: still latency, one block of 1024 threads walking 2(T-1)
// dependent periods on one SM, but each period now does
// O(n_e n_a log n_a) compares in place of O(n_e n_a^2), so the barriers
// (11 per backward-forward pair of periods, the template's 15) and the
// pow/division chains of the EGM step take a larger share.
__global__ void __launch_bounds__(kThreads) household_sweep_jvp_kernel(
    const float* __restrict__ r_path, const float* __restrict__ w_path,    // (Tm1,)
    const float* __restrict__ dr_path, const float* __restrict__ dw_path,  // (Tm1,)
    const float* __restrict__ V_T, const float* __restrict__ D0,           // (n_e, n_a)
    const float* __restrict__ grid_g, const float* __restrict__ egrid_g,   // (n_a,), (n_e,)
    const float* __restrict__ Pi_g,                                        // (n_e, n_e)
    float* __restrict__ pol_scr, float* __restrict__ dpol_scr,             // (Tm1, n_e, n_a)
    float* __restrict__ agg, float* __restrict__ dagg,                     // (Tm1,)
    float* __restrict__ aggc, float* __restrict__ daggc,                   // (Tm1,)
    int* __restrict__ fallback,                                            // (2,) or null
    int Tm1, int n_a, int n_e, float beta, float gamma, float borrow_cons)
{
    using S = float;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    S* smem = reinterpret_cast<S*>(smem_raw);
    const int n = n_a * n_e;
    const int tid = threadIdx.x;

    // The template's shared layout, then one flag per income row for each
    // half: 1 while the row is non-decreasing.
    S* X = smem;                 // V (backward) / D (forward)
    S* Y = X + n;                // implied wealth (backward) / D_half (forward)
    S* P = Y + n;                // clipped policy (forward)
    S* dX = P + n;
    S* dY = dX + n;
    S* dQ = dY + n;              // dpol * D (forward)
    S* g = smem + 6 * n;
    S* glo = g + n_a;
    S* ghi = glo + n_a;
    S* iup = ghi + n_a;
    S* idn = iup + n_a;
    S* lab = idn + n_a;
    S* Pi = lab + n_e;
    S* red = Pi + n_e * n_e;     // (4, kThreads)
    int* kmono = reinterpret_cast<int*>(red + 4 * kThreads);   // implied wealth rows
    int* pmono = kmono + n_e;                                   // policy rows
    int fell_k = 0, fell_p = 0;  // thread 0's fallback counts

    const S tiny = S(1e-12);
    const S inv_g = S(-1) / gamma;

    for (int i = tid; i < n_a; i += kThreads) g[i] = grid_g[i];
    for (int i = tid; i < n_e; i += kThreads) lab[i] = egrid_g[i];
    for (int i = tid; i < n_e * n_e; i += kThreads) Pi[i] = Pi_g[i];
    for (int i = tid; i < n; i += kThreads) {
        X[i] = V_T[i];
        dX[i] = S(0);
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
    __syncthreads();

    // ── Backward EGM recursion: t = Tm1-1 … 0 ─────────────────────────────
    for (int t = Tm1 - 1; t >= 0; --t) {
        const S r = r_path[t], w = w_path[t];
        const S dr = dr_path[t];
        const S dw = dw_path[t];
        const S one_r = S(1) + r;
        for (int e = tid; e < n_e; e += kThreads) kmono[e] = 1;   // read last in period t+1

        // 1-3. Expectation over e', Euler inversion, implied wealth.
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e = idx / n_a;
            const int a = idx - e * n_a;
            S E = S(0), dE = S(0);
            for (int k = 0; k < n_e; ++k) {
                E += Pi[e * n_e + k] * X[k * n_a + a];
                dE += Pi[e * n_e + k] * dX[k * n_a + a];
            }
            const bool live = E > tiny;
            E = live ? E : tiny;
            const S c = powf(beta * E, inv_g);
            const S implied = (c - w * lab[e] + g[a]) / one_r;
            Y[idx] = implied;
            const S dc = live ? inv_g * c / E * dE : S(0);
            dY[idx] = (dc - dw * lab[e]) / one_r - implied * dr / one_r;
        }
        __syncthreads();

        // Which implied-wealth rows are non-decreasing.
        for (int idx = tid; idx < n; idx += kThreads) {
            const int a = idx - (idx / n_a) * n_a;
            if (a < n_a - 1 && !(Y[idx] <= Y[idx + 1])) kmono[idx / n_a] = 0;
        }
        __syncthreads();
        if (fallback != nullptr && tid == 0)
            for (int e = 0; e < n_e; ++e) fell_k += kmono[e] == 0;

        // 4-6. Interpolate the savings policy onto the grid, borrowing clip,
        //      budget, envelope.
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e = idx / n_a;
            const int a = idx - e * n_a;
            const S x = g[a];
            const S* K = Y + e * n_a;
            int cnt = 0;
            if (kmono[e]) {
                int hi_k = n_a;      // lower bound: the first k with !(K[k] < x)
                while (cnt < hi_k) {
                    const int mid = (cnt + hi_k) >> 1;
                    if (K[mid] < x) cnt = mid + 1; else hi_k = mid;
                }
            } else {
                for (int k = 0; k < n_a; ++k) cnt += K[k] < x ? 1 : 0;
            }
            const int j = min(max(cnt, 1), n_a - 1);
            const S lo = K[j - 1], hi = K[j];
            const S vlo = g[j - 1], vhi = g[j];
            const S den = hi - lo;
            const S safe = den > S(0) ? den : S(1);
            const S tw_raw = (x - lo) / safe;
            const S tw = fmin(fmax(tw_raw, S(0)), S(1));
            S pol = vlo + tw * (vhi - vlo);
            // Interior: lo < x <= hi, on the operands (the template's tie rule).
            const bool interior = x > lo && x <= hi && den > S(0);
            const S dlo = dY[e * n_a + j - 1], dhi = dY[e * n_a + j];
            const S dtw = interior ? -(dlo + tw * (dhi - dlo)) / safe : S(0);
            S dpol = dtw * (vhi - vlo);
            const bool unbound = pol > borrow_cons;
            pol = unbound ? pol : borrow_cons;
            const S cg_raw = one_r * x + w * lab[e] - pol;
            const bool cg_live = cg_raw > tiny;
            const S cg = cg_live ? cg_raw : tiny;
            const S cpow = powf(cg, -gamma);
            X[idx] = one_r * cpow;
            pol_scr[(size_t)t * n + idx] = pol;
            dpol = unbound ? dpol : S(0);
            const S dcg = cg_live ? dr * x + dw * lab[e] - dpol : S(0);
            dX[idx] = dr * cpow + one_r * (-gamma) * cpow / cg * dcg;
            dpol_scr[(size_t)t * n + idx] = dpol;
        }
        __syncthreads();
    }

    // ── Forward push-forward: t = 0 … Tm1-1 ───────────────────────────────
    for (int i = tid; i < n; i += kThreads) {
        X[i] = D0[i];
        dX[i] = S(0);
    }
    for (int e = tid; e < n_e; e += kThreads) pmono[e] = 1;
    __syncthreads();
    const S g_bot = g[0], g_top = g[n_a - 1];
    for (int t = 0; t < Tm1; ++t) {
        const S r = r_path[t], w = w_path[t];
        const S dr = dr_path[t];
        const S dw = dw_path[t];
        const S one_r = S(1) + r;
        const S* pol_t = pol_scr + (size_t)t * n;
        const S* dpol_t = dpol_scr + (size_t)t * n;

        // The clamped policy, and whether its rows are non-decreasing (each
        // thread clamps its right neighbour again: no extra barrier).
        for (int idx = tid; idx < n; idx += kThreads) {
            const S p = fmin(fmax(pol_t[idx], g_bot), g_top);
            P[idx] = p;
            dQ[idx] = dpol_t[idx] * X[idx];
            const int a = idx - (idx / n_a) * n_a;
            if (a < n_a - 1 && !(p <= fmin(fmax(pol_t[idx + 1], g_bot), g_top)))
                pmono[idx / n_a] = 0;
        }
        __syncthreads();
        if (fallback != nullptr && tid == 0)
            for (int e = 0; e < n_e; ++e) fell_p += pmono[e] == 0;

        // Hat-basis Young lottery: D_half[e, b] = Σ_a hat_b(p[e, a]) D[e, a].
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e = idx / n_a;
            const int b = idx - e * n_a;
            const S gl = glo[b], gh = ghi[b], iu = iup[b], id = idn[b];
            const S* Pe = P + e * n_a;
            const S* Xe = X + e * n_a;
            S acc = S(0), dacc = S(0);
            const S gb = g[b];
            int a_begin = 0, a_end = n_a;
            if (pmono[e]) {
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
                // slope are exactly 0 (the template's rule; on a monotone
                // row the range above holds only sources inside).
                if (!(p > gl && p <= gh)) continue;
                const S up = (p - gl) * iu;
                const S down = (gh - p) * id;
                const S hat = down < up ? down : up;
                acc += hat * Xe[a];
                const S slope = p > gb ? -id : iu;
                dacc += hat * dX[e * n_a + a] + slope * dQ[e * n_a + a];
            }
            Y[idx] = acc;
            dY[idx] = dacc;
        }
        __syncthreads();

        // Markov mix D'[e', b] = Σ_e Pi[e, e'] D_half[e, b], then this
        // thread's share of the aggregates.
        for (int e = tid; e < n_e; e += kThreads) pmono[e] = 1;   // the lottery has read them
        S s0 = S(0), s1 = S(0), s2 = S(0), s3 = S(0);
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e2 = idx / n_a;
            const int b = idx - e2 * n_a;
            S Dn = S(0), dDn = S(0);
            for (int e = 0; e < n_e; ++e) {
                Dn += Pi[e * n_e + e2] * Y[e * n_a + b];
                dDn += Pi[e * n_e + e2] * dY[e * n_a + b];
            }
            X[idx] = Dn;
            const S pol = pol_t[idx];
            const S cg_raw = one_r * g[b] + w * lab[e2] - pol;
            const bool cg_live = cg_raw > tiny;
            const S cg = cg_live ? cg_raw : tiny;
            s0 += pol * Dn;
            s2 += cg * Dn;
            dX[idx] = dDn;
            const S dpol = dpol_t[idx];
            const S dcg = cg_live ? dr * g[b] + dw * lab[e2] - dpol : S(0);
            s1 += dpol * Dn + pol * dDn;
            s3 += dcg * Dn + cg * dDn;
        }
        red[0 * kThreads + tid] = s0;
        red[1 * kThreads + tid] = s2;
        red[2 * kThreads + tid] = s1;
        red[3 * kThreads + tid] = s3;
        __syncthreads();
        for (int s = kThreads / 2; s >= 32; s >>= 1) {
            if (tid < s) {
                for (int q = 0; q < 4; ++q)
                    red[q * kThreads + tid] += red[q * kThreads + tid + s];
            }
            __syncthreads();
        }
        if (tid < 32) {
            // Strides 16 … 1 in warp 0: lane i adds lane i + s, the tree's
            // own pairing, so the sums keep their bits.
            S v[4];
            for (int q = 0; q < 4; ++q) v[q] = red[q * kThreads + tid];
            for (int s = 16; s > 0; s >>= 1)
                for (int q = 0; q < 4; ++q) v[q] += __shfl_down_sync(0xffffffffu, v[q], s);
            if (tid == 0) {
                agg[t] = v[0];
                aggc[t] = v[1];
                dagg[t] = v[2];
                daggc[t] = v[3];
            }
        }
    }
    if (fallback != nullptr && tid == 0) {
        fallback[0] = fell_k;
        fallback[1] = fell_p;
    }
}

size_t jvp_smem_bytes(int n_a, int n_e) {
    return smem_bytes<float, true>(n_a, n_e) + 2 * sizeof(int) * (size_t)n_e;
}

// Kernels 2-4: the kernel template with kernel 1's design. Its outputs are
// bit for bit those of household_sweep_kernel<S, TANGENT, BATCHED> on every
// input (chip_smoke.py holds each instantiation to the template's launch,
// every row of a batched one):
//   <float, true, true>    kernels 3-4, the batched f32 primal + tangent
//       sweep (every lockstep matvec of an ensemble);
//   <double, false, false> kernel 2, the f64 residual sweep (every
//       full-precision F(x) of a one-asset solve);
//   <double, false, true>  the batched kernel 2 (every F_b of an ensemble);
//   <double, true, false>  the f64 tangent sweep (every f64 direction of a
//       one-asset solve on the card), held to the template's <double, true,
//       false> launch (hank_sweep_jvp_f64_previous). At its ties (a query
//       on a knot, a policy on the borrowing limit) it takes the template's
//       one-sided rules; the f64 plain version, AD with ops/clip.py's
//       balanced rule, agrees where the tangent the rules split is zero (a
//       policy clipped to the limit has none) or no tie occurs, which
//       chip_smoke.py checks at the solver's points to 1e-10.
// It carries kernel 1's three changes (a) the bracket by binary search on
// implied-wealth rows checked non-decreasing, (b) the lottery over the
// source range of clamped-policy rows checked non-decreasing, (c) the
// aggregate tree's last five levels by warp shuffle, with kernel 1's
// barriers, and the template's S, TANGENT and BATCHED: tangent lines only
// under TANGENT, the path offset compiled out when not BATCHED. Kernel 1's
// note above says why none of them alters an operation on a value. Unlike
// kernel 1 it keeps its row flags in reduction slots that are free while
// they live, so it takes no shared memory beyond the template's and fits
// every grid the template fits; the policy flags are therefore set again
// during the aggregate tree's second level, by threads that level leaves
// idle, and not at the start of the Markov mix (the same barriers).
// `fallback`, when not null, is (B, 2): row b receives path b's counts of
// (period, income row) pairs that took each fallback.
//
// What bounds it: as kernel 1, latency, one block of 1024 threads walking
// 2(T-1) dependent periods on one SM. In f64 the two pows per state and
// period are long dependent sequences (FP64 runs at half the f32 rate and
// pow is a library routine, not an SFU instruction), so with the count
// loops gone they take a larger share than in kernel 1. The batched
// instantiation runs one path per SM, in waves past 132 paths.
//
// GLOBAL_STATE: the six n = n_a*n_e state arrays (X, Y, P and the tangents
// dX, dY, dQ; three without TANGENT) live in this path's slice of `state`,
// a (B, 6n) or (B, 3n) workspace in global memory that the caller
// allocates, and only the grid arrays, labor, Pi and the reduction slots
// (with the row flags) stay in shared memory: global_smem_bytes, 5 n_a +
// n_e + n_e^2 + kRed*kThreads values, so at n_e = 7 the f64 tangent sweep
// takes n_a up to 4980 in place of 529. Every operation, its order and
// every barrier are the shared-state kernel's (one sum written as the fma
// that ptxas makes of it there, below), and __syncthreads() orders a
// block's global accesses as it orders its shared ones, so on every grid
// both take the outputs are bit for bit the shared-state kernel's
// (chip_smoke.py holds each instantiation to it; <float, true, false> to
// kernel 1, which is bit for bit the template's B = 1 launch). `state` is
// written and read within the launch, so it is not const __restrict__: no
// load of it may take the read-only path. The workspace stays in L2 at the
// grids it serves (0.40 MB a path for the f64 tangent sweep at 1200x7), so
// each state access costs an L2 round trip in place of a shared one.
// Without GLOBAL_STATE, `state` is null and compiled out, and the shared
// layout is the template's.
template <typename S, bool TANGENT, bool BATCHED, bool GLOBAL_STATE>
__global__ void __launch_bounds__(kThreads) household_sweep_ranged_kernel(
    const S* __restrict__ r_path, const S* __restrict__ w_path,     // (B, Tm1)
    const S* __restrict__ dr_path, const S* __restrict__ dw_path,   // (B, Tm1) or null
    const S* __restrict__ V_T, const S* __restrict__ D0,            // (n_e, n_a)
    const S* __restrict__ grid_g, const S* __restrict__ egrid_g,    // (n_a,), (n_e,)
    const S* __restrict__ Pi_g,                                     // (n_e, n_e) row-stochastic
    S* __restrict__ pol_scr, S* __restrict__ dpol_scr,              // (B, Tm1, n_e, n_a)
    S* __restrict__ agg, S* __restrict__ dagg,                      // (B, Tm1)
    S* __restrict__ aggc, S* __restrict__ daggc,                    // (B, Tm1)
    int* __restrict__ fallback,                                     // (B, 2) or null
    int Tm1, int n_a, int n_e, S beta, S gamma, S borrow_cons,
    S* state)                                    // (B, 6n or 3n) under GLOBAL_STATE, else null
{
    constexpr int kRed = TANGENT ? 4 : 2;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    S* smem = reinterpret_cast<S*>(smem_raw);
    const int n = n_a * n_e;
    const int tid = threadIdx.x;
    SWEEP_STAMPS_INIT

    // This block's path, as in the template (size_t offsets, compiled out
    // of a single-path launch); under GLOBAL_STATE also its state slice.
    const size_t path = BATCHED ? blockIdx.x : 0;
    r_path += path * Tm1;
    w_path += path * Tm1;
    pol_scr += path * Tm1 * n;
    agg += path * Tm1;
    aggc += path * Tm1;
    if (TANGENT) {
        dr_path += path * Tm1;
        dw_path += path * Tm1;
        dpol_scr += path * Tm1 * n;
        dagg += path * Tm1;
        daggc += path * Tm1;
    }

    // The template's shared layout, no byte more: the one flag per income
    // row for each half, 1 while the row is non-decreasing, lives in row 0
    // of the reduction slots. The backward half does not use them, and the
    // forward half leaves slots [kThreads/2, kThreads) alone from the tree's
    // first level to the next period's aggregates: the implied-wealth flags
    // take slots [0, n_e), the policy flags [kThreads/2, kThreads/2 + n_e)
    // (n_e <= kThreads/2, which the launcher checks). Under GLOBAL_STATE
    // the six state arrays move to `state` and the rest keeps its order.
    S* X = GLOBAL_STATE ? state + path * (TANGENT ? 6 : 3) * (size_t)n
                        : smem;  // V (backward) / D (forward)
    S* Y = X + n;                // implied wealth (backward) / D_half (forward)
    S* P = Y + n;                // clipped policy (forward)
    S* dX = P + n;               // tangents (TANGENT only)
    S* dY = dX + n;
    S* dQ = dY + n;              // dpol * D (forward)
    S* g = GLOBAL_STATE ? smem : smem + (TANGENT ? 6 : 3) * n;
    S* glo = g + n_a;
    S* ghi = glo + n_a;
    S* iup = ghi + n_a;
    S* idn = iup + n_a;
    S* lab = idn + n_a;
    S* Pi = lab + n_e;
    S* red = Pi + n_e * n_e;     // (kRed, kThreads)
    int* kmono = reinterpret_cast<int*>(red);                  // implied wealth rows
    int* pmono = reinterpret_cast<int*>(red + kThreads / 2);   // policy rows
    int fell_k = 0, fell_p = 0;  // thread 0's fallback counts

    const S tiny = S(1e-12);
    const S inv_g = S(-1) / gamma;

    for (int i = tid; i < n_a; i += kThreads) g[i] = grid_g[i];
    for (int i = tid; i < n_e; i += kThreads) lab[i] = egrid_g[i];
    for (int i = tid; i < n_e * n_e; i += kThreads) Pi[i] = Pi_g[i];
    for (int i = tid; i < n; i += kThreads) {
        X[i] = V_T[i];
        if (TANGENT) dX[i] = S(0);
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
    __syncthreads();
    SWEEP_BLOCK(7)

    // ── Backward EGM recursion: t = Tm1-1 … 0 ─────────────────────────────
    for (int t = Tm1 - 1; t >= 0; --t) {
        const S r = r_path[t], w = w_path[t];
        const S dr = TANGENT ? dr_path[t] : S(0);
        const S dw = TANGENT ? dw_path[t] : S(0);
        const S one_r = S(1) + r;
        for (int e = tid; e < n_e; e += kThreads) kmono[e] = 1;   // read last in period t+1

        // 1-3. Expectation over e', Euler inversion, implied wealth.
        SWEEP_ACC(sw_fold);
        SWEEP_ACC(sw_euler);
        for (int idx = tid; idx < n; idx += kThreads) {
            SWEEP_MARK(sw_t);
            const int e = idx / n_a;
            const int a = idx - e * n_a;
            S E = S(0), dE = S(0);
            for (int k = 0; k < n_e; ++k) {
                E += Pi[e * n_e + k] * X[k * n_a + a];
                if (TANGENT) dE += Pi[e * n_e + k] * dX[k * n_a + a];
            }
            SWEEP_LAP(sw_fold, sw_t);
            const bool live = E > tiny;
            E = live ? E : tiny;
            const S c = spow(beta * E, inv_g);
            const S implied = (c - w * lab[e] + g[a]) / one_r;
            Y[idx] = implied;
            if (TANGENT) {
                const S dc = live ? inv_g * c / E * dE : S(0);
                dY[idx] = (dc - dw * lab[e]) / one_r - implied * dr / one_r;
            }
            SWEEP_LAP(sw_euler, sw_t);
        }
        SWEEP_FLUSH(10, sw_fold);
        SWEEP_FLUSH(11, sw_euler);
        __syncthreads();
        SWEEP_BLOCK(0)

        // Which implied-wealth rows are non-decreasing.
        for (int idx = tid; idx < n; idx += kThreads) {
            const int a = idx - (idx / n_a) * n_a;
            if (a < n_a - 1 && !(Y[idx] <= Y[idx + 1])) kmono[idx / n_a] = 0;
        }
        __syncthreads();
        if (fallback != nullptr && tid == 0)
            for (int e = 0; e < n_e; ++e) fell_k += kmono[e] == 0;
        SWEEP_BLOCK(1)

        // 4-6. Interpolate the savings policy onto the grid, borrowing clip,
        //      budget, envelope.
        SWEEP_ACC(sw_bracket);
        SWEEP_ACC(sw_envelope);
        for (int idx = tid; idx < n; idx += kThreads) {
            SWEEP_MARK(sw_t);
            const int e = idx / n_a;
            const int a = idx - e * n_a;
            const S x = g[a];
            const S* K = Y + e * n_a;
            int cnt = 0;
            if (kmono[e]) {
                int hi_k = n_a;      // lower bound: the first k with !(K[k] < x)
                while (cnt < hi_k) {
                    const int mid = (cnt + hi_k) >> 1;
                    if (K[mid] < x) cnt = mid + 1; else hi_k = mid;
                }
            } else {
                for (int k = 0; k < n_a; ++k) cnt += K[k] < x ? 1 : 0;
            }
            const int j = min(max(cnt, 1), n_a - 1);
            const S lo = K[j - 1], hi = K[j];
            SWEEP_LAP(sw_bracket, sw_t);
            const S vlo = g[j - 1], vhi = g[j];
            const S den = hi - lo;
            const S safe = den > S(0) ? den : S(1);
            const S tw_raw = (x - lo) / safe;
            const S tw = fmin(fmax(tw_raw, S(0)), S(1));
            S pol = vlo + tw * (vhi - vlo);
            S dpol = S(0);
            if (TANGENT) {
                // Interior: lo < x <= hi, on the operands (the template's tie rule).
                const bool interior = x > lo && x <= hi && den > S(0);
                const S dlo = dY[e * n_a + j - 1], dhi = dY[e * n_a + j];
                const S dtw = interior ? -(dlo + tw * (dhi - dlo)) / safe : S(0);
                dpol = dtw * (vhi - vlo);
            }
            const bool unbound = pol > borrow_cons;
            pol = unbound ? pol : borrow_cons;
            const S cg_raw = one_r * x + w * lab[e] - pol;
            const bool cg_live = cg_raw > tiny;
            const S cg = cg_live ? cg_raw : tiny;
            const S cpow = spow(cg, -gamma);
            X[idx] = one_r * cpow;
            pol_scr[(size_t)t * n + idx] = pol;
            if (TANGENT) {
                dpol = unbound ? dpol : S(0);
                const S dcg = cg_live ? dr * x + dw * lab[e] - dpol : S(0);
                // Under GLOBAL_STATE the contraction the shared-state builds
                // get from ptxas (dr * cpow fused, the other product rounded)
                // is written out: left to itself, ptxas fuses the other
                // product in the global-state <double, true, false>.
                if constexpr (GLOBAL_STATE)
                    dX[idx] = fma(dr, cpow, one_r * (-gamma) * cpow / cg * dcg);
                else
                    dX[idx] = dr * cpow + one_r * (-gamma) * cpow / cg * dcg;
                dpol_scr[(size_t)t * n + idx] = dpol;
            }
            SWEEP_LAP(sw_envelope, sw_t);
        }
        SWEEP_FLUSH(12, sw_bracket);
        SWEEP_FLUSH(13, sw_envelope);
        __syncthreads();
        SWEEP_BLOCK(2)
    }

    // ── Forward push-forward: t = 0 … Tm1-1 ───────────────────────────────
    for (int i = tid; i < n; i += kThreads) {
        X[i] = D0[i];
        if (TANGENT) dX[i] = S(0);
    }
    for (int e = tid; e < n_e; e += kThreads) pmono[e] = 1;
    __syncthreads();
    SWEEP_BLOCK(7)
    const S g_bot = g[0], g_top = g[n_a - 1];
    for (int t = 0; t < Tm1; ++t) {
        const S r = r_path[t], w = w_path[t];
        const S dr = TANGENT ? dr_path[t] : S(0);
        const S dw = TANGENT ? dw_path[t] : S(0);
        const S one_r = S(1) + r;
        const S* pol_t = pol_scr + (size_t)t * n;
        const S* dpol_t = TANGENT ? dpol_scr + (size_t)t * n : nullptr;

        // The clamped policy, and whether its rows are non-decreasing (each
        // thread clamps its right neighbour again: no extra barrier).
        for (int idx = tid; idx < n; idx += kThreads) {
            const S p = fmin(fmax(pol_t[idx], g_bot), g_top);
            P[idx] = p;
            if (TANGENT) dQ[idx] = dpol_t[idx] * X[idx];
            const int a = idx - (idx / n_a) * n_a;
            if (a < n_a - 1 && !(p <= fmin(fmax(pol_t[idx + 1], g_bot), g_top)))
                pmono[idx / n_a] = 0;
        }
        __syncthreads();
        if (fallback != nullptr && tid == 0)
            for (int e = 0; e < n_e; ++e) fell_p += pmono[e] == 0;
        SWEEP_BLOCK(3)

        // Hat-basis Young lottery: D_half[e, b] = Σ_a hat_b(p[e, a]) D[e, a].
        SWEEP_ACC(sw_range);
        SWEEP_ACC(sw_sum);
        for (int idx = tid; idx < n; idx += kThreads) {
            SWEEP_MARK(sw_t);
            const int e = idx / n_a;
            const int b = idx - e * n_a;
            const S gl = glo[b], gh = ghi[b], iu = iup[b], id = idn[b];
            const S* Pe = P + e * n_a;
            const S* Xe = X + e * n_a;
            S acc = S(0), dacc = S(0);
            const S gb = g[b];
            int a_begin = 0, a_end = n_a;
            if (pmono[e]) {
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
            SWEEP_LAP(sw_range, sw_t);
            for (int a = a_begin; a < a_end; ++a) {
                const S p = Pe[a];
                // Outside (g_{b-1}, g_{b+1}] both the hat and its left-sided
                // slope are exactly 0 (the template's rule; on a monotone
                // row the range above holds only sources inside).
                if (!(p > gl && p <= gh)) continue;
                const S up = (p - gl) * iu;
                const S down = (gh - p) * id;
                const S hat = down < up ? down : up;
                acc += hat * Xe[a];
                if (TANGENT) {
                    const S slope = p > gb ? -id : iu;
                    dacc += hat * dX[e * n_a + a] + slope * dQ[e * n_a + a];
                }
            }
            Y[idx] = acc;
            if (TANGENT) dY[idx] = dacc;
            SWEEP_LAP(sw_sum, sw_t);
        }
        SWEEP_FLUSH(14, sw_range);
        SWEEP_FLUSH(15, sw_sum);
        __syncthreads();
        SWEEP_BLOCK(4)

        // Markov mix D'[e', b] = Σ_e Pi[e, e'] D_half[e, b], then this
        // thread's share of the aggregates.
        S s0 = S(0), s1 = S(0), s2 = S(0), s3 = S(0);
        SWEEP_ACC(sw_mix);
        SWEEP_ACC(sw_terms);
        for (int idx = tid; idx < n; idx += kThreads) {
            SWEEP_MARK(sw_t);
            const int e2 = idx / n_a;
            const int b = idx - e2 * n_a;
            S Dn = S(0), dDn = S(0);
            for (int e = 0; e < n_e; ++e) {
                Dn += Pi[e * n_e + e2] * Y[e * n_a + b];
                if (TANGENT) dDn += Pi[e * n_e + e2] * dY[e * n_a + b];
            }
            X[idx] = Dn;
            SWEEP_LAP(sw_mix, sw_t);
            const S pol = pol_t[idx];
            const S cg_raw = one_r * g[b] + w * lab[e2] - pol;
            const bool cg_live = cg_raw > tiny;
            const S cg = cg_live ? cg_raw : tiny;
            s0 += pol * Dn;
            s2 += cg * Dn;
            if (TANGENT) {
                dX[idx] = dDn;
                const S dpol = dpol_t[idx];
                const S dcg = cg_live ? dr * g[b] + dw * lab[e2] - dpol : S(0);
                s1 += dpol * Dn + pol * dDn;
                s3 += dcg * Dn + cg * dDn;
            }
            SWEEP_LAP(sw_terms, sw_t);
        }
        SWEEP_FLUSH(16, sw_mix);
        SWEEP_FLUSH(17, sw_terms);
        red[0 * kThreads + tid] = s0;
        red[1 * kThreads + tid] = s2;
        if (TANGENT) {
            red[(kRed - 2) * kThreads + tid] = s1;
            red[(kRed - 1) * kThreads + tid] = s3;
        }
        __syncthreads();
        SWEEP_BLOCK(5)
        for (int s = kThreads / 2; s >= 32; s >>= 1) {
            if (tid < s) {
                for (int q = 0; q < kRed; ++q)
                    red[q * kThreads + tid] += red[q * kThreads + tid + s];
            } else if (s == kThreads / 4 && tid >= kThreads / 2 && tid < kThreads / 2 + n_e) {
                // The first level has read slots [kThreads/2, kThreads), and
                // the lottery the policy flags: set them for the next period.
                pmono[tid - kThreads / 2] = 1;
            }
            __syncthreads();
        }
        if (tid < 32) {
            // Strides 16 … 1 in warp 0: lane i adds lane i + s, the tree's
            // own pairing, so the sums keep their bits.
            S v[kRed];
            for (int q = 0; q < kRed; ++q) v[q] = red[q * kThreads + tid];
            for (int s = 16; s > 0; s >>= 1)
                for (int q = 0; q < kRed; ++q) v[q] += __shfl_down_sync(0xffffffffu, v[q], s);
            if (tid == 0) {
                agg[t] = v[0];
                aggc[t] = v[1];
                if (TANGENT) {
                    dagg[t] = v[kRed - 2];
                    daggc[t] = v[kRed - 1];
                }
            }
        }
        SWEEP_BLOCK(6)
    }
    if (fallback != nullptr && tid == 0) {
        fallback[2 * path] = fell_k;
        fallback[2 * path + 1] = fell_p;
    }
    SWEEP_SAVE()
}


// The global-state instantiations' shared memory: the grid with its
// hat-basis neighbours and slopes, labor, Pi and the reduction slots.
template <typename S, bool TANGENT>
size_t global_smem_bytes(int n_a, int n_e) {
    return sizeof(S) * (5 * (size_t)n_a + n_e + (size_t)n_e * n_e
                        + (TANGENT ? 4 : 2) * kThreads);
}

template <typename S, bool TANGENT, bool BATCHED, bool GLOBAL_STATE = false>
int launch_ranged(const void* r, const void* w, const void* dr, const void* dw,
                  const void* V_T, const void* D0, const void* grid, const void* egrid,
                  const void* Pi, void* pol, void* dpol, void* agg, void* dagg,
                  void* aggc, void* daggc, void* fallback, int B, int Tm1, int n_a,
                  int n_e, double beta, double gamma, double borrow_cons, void* stream,
                  void* state = nullptr) {
    if (n_e > kThreads / 2) return (int)cudaErrorInvalidValue;   // the flags' slots
    if (GLOBAL_STATE && state == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = GLOBAL_STATE ? global_smem_bytes<S, TANGENT>(n_a, n_e)
                                     : smem_bytes<S, TANGENT>(n_a, n_e);
    auto kern = household_sweep_ranged_kernel<S, TANGENT, BATCHED, GLOBAL_STATE>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const S*)r, (const S*)w, (const S*)dr, (const S*)dw,
        (const S*)V_T, (const S*)D0, (const S*)grid, (const S*)egrid,
        (const S*)Pi, (S*)pol, (S*)dpol, (S*)agg, (S*)dagg, (S*)aggc,
        (S*)daggc, (int*)fallback, Tm1, n_a, n_e, (S)beta, (S)gamma, (S)borrow_cons,
        (S*)state);
    return (int)cudaGetLastError();
}

// The previous kernel 7: the forward distribution scan, f32 primal, as it
// was first written (`forward_scan_previous`; forward_scan_kernel below is
// held to it bit for bit, and no caller but that comparison launches it).
// Given T per-period savings policies, it runs the Young lottery, the
// Markov mix and the aggregation T times from D0 and returns agg[t] =
// sum(policy_t * D_{t+1}) (the policy unclipped) and D_T. It is
// household_sweep_kernel's forward loop in primal f32, with three
// differences: the policies come from an input (laid out (T, n_a, n_e), as
// the JAX function takes them) in place of the scratch, it runs T periods,
// it writes the final D, and it has no consumption aggregate.
//
// The hat form here (policy clamped to [g_0, g_last], then the hat weight)
// is the same operator as the reference's bracket form (count of grid
// points below the policy, clipped to [1, n_a-1], then the clipped weight),
// but it rounds differently, by a few f32 ulps per period.
//
// What bounds it on the H100: latency. T dependent periods run one after
// another on one SM, each 13 block-wide barriers (the clamp, the lottery,
// the mix and a 10-level reduction tree) around O(n_a) compares per
// destination: every destination walks all n_a sources of its row.
__global__ void __launch_bounds__(kThreads) forward_scan_previous_kernel(
    const float* __restrict__ pol_g,     // (T, n_a, n_e)
    const float* __restrict__ D0,        // (n_a, n_e)
    const float* __restrict__ grid_g,    // (n_a,)
    const float* __restrict__ Pi_g,      // (n_e, n_e) row-stochastic
    float* __restrict__ agg,             // (T,)
    float* __restrict__ D_T,             // (n_a, n_e)
    int T, int n_a, int n_e)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* X = reinterpret_cast<float*>(smem_raw);   // D, laid out (n_e, n_a)
    const int n = n_a * n_e;
    const int tid = threadIdx.x;
    float* Y = X + n;             // D_half
    float* P = Y + n;             // clamped policy
    float* g = P + n;
    float* glo = g + n_a;
    float* ghi = glo + n_a;
    float* iup = ghi + n_a;
    float* idn = iup + n_a;
    float* Pi = idn + n_a;
    float* red = Pi + n_e * n_e;  // (kThreads,)

    for (int i = tid; i < n_a; i += kThreads) g[i] = grid_g[i];
    for (int i = tid; i < n_e * n_e; i += kThreads) Pi[i] = Pi_g[i];
    for (int idx = tid; idx < n; idx += kThreads) {
        const int e = idx / n_a;
        const int a = idx - e * n_a;
        X[idx] = D0[a * n_e + e];
    }
    __syncthreads();
    for (int i = tid; i < n_a; i += kThreads) {
        const float lo = i == 0 ? g[0] - (g[1] - g[0]) : g[i - 1];
        const float hi = i == n_a - 1 ? g[n_a - 1] + (g[n_a - 1] - g[n_a - 2]) : g[i + 1];
        glo[i] = lo;
        ghi[i] = hi;
        iup[i] = 1.0f / (g[i] - lo);
        idn[i] = 1.0f / (hi - g[i]);
    }
    __syncthreads();
    const float g_bot = g[0], g_top = g[n_a - 1];

    for (int t = 0; t < T; ++t) {
        const float* pol_t = pol_g + (size_t)t * n;
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e = idx / n_a;
            const int a = idx - e * n_a;
            P[idx] = fminf(fmaxf(pol_t[a * n_e + e], g_bot), g_top);
        }
        __syncthreads();

        // Hat-basis Young lottery: D_half[e, b] = sum_a hat_b(p[e, a]) D[e, a].
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e = idx / n_a;
            const int b = idx - e * n_a;
            const float gl = glo[b], gh = ghi[b], iu = iup[b], id = idn[b];
            const float* Pe = P + e * n_a;
            const float* Xe = X + e * n_a;
            float acc = 0.0f;
            for (int a = 0; a < n_a; ++a) {
                const float p = Pe[a];
                if (!(p > gl && p < gh)) continue;   // the hat is exactly 0 there
                const float up = (p - gl) * iu;
                const float down = (gh - p) * id;
                acc += fmaxf(down < up ? down : up, 0.0f) * Xe[a];
            }
            Y[idx] = acc;
        }
        __syncthreads();

        // Markov mix D'[e', b] = sum_e Pi[e, e'] D_half[e, b], then this
        // thread's share of the aggregate.
        float s = 0.0f;
        for (int idx = tid; idx < n; idx += kThreads) {
            const int e2 = idx / n_a;
            const int b = idx - e2 * n_a;
            float Dn = 0.0f;
            for (int e = 0; e < n_e; ++e) Dn += Pi[e * n_e + e2] * Y[e * n_a + b];
            X[idx] = Dn;
            s += pol_t[b * n_e + e2] * Dn;
        }
        red[tid] = s;
        __syncthreads();
        for (int k = kThreads / 2; k > 0; k >>= 1) {
            if (tid < k) red[tid] += red[tid + k];
            __syncthreads();
        }
        if (tid == 0) agg[t] = red[0];
    }
    for (int idx = tid; idx < n; idx += kThreads) {
        const int e = idx / n_a;
        const int a = idx - e * n_a;
        D_T[a * n_e + e] = X[idx];
    }
}

size_t forward_scan_previous_smem_bytes(int n_a, int n_e) {
    return sizeof(float) * (3 * (size_t)n_a * n_e + 5 * (size_t)n_a
                            + (size_t)n_e * n_e + kThreads);
}

// Kernel 7: the forward distribution scan, f32 primal, replacing the TPU
// kernel hank_tpu/ops/pallas_kernels.py:62 forward_scan_pallas
// (_make_forward_scan_kernel). Its outputs are bit for bit those of
// forward_scan_previous_kernel above on every input (chip_smoke.py holds
// both outputs to it). Three launches on one stream; only the second is a
// serial chain, and the work that does not depend on D is taken off it:
//   forward_scan_prep_kernel, one block per (period, income row), all
//       periods at once on every SM: the clamped policy row in the (e, a)
//       layout, whether it is non-decreasing, and for every destination b
//       of the row the range of sources inside its hat. On a non-decreasing
//       row the sources with gl < P[a] < gh (the previous kernel's test)
//       are exactly the contiguous range from the first a with P[a] > gl to
//       the first with !(P[a] < gh): two binary searches. A row that is not
//       non-decreasing (noise, a NaN) gets the range [0, n_a) marked for
//       the previous kernel's test on every source (its full scan), and is
//       counted in `fallback`.
//   forward_scan_kernel, one block of 1024 threads: per period the lottery
//       over each destination's range in ascending a, so the same terms in
//       the same order; a barrier; the Markov mix, written to shared memory
//       and to the history of D; a barrier. Two barriers a period in place
//       of 13. On a checked row the range needs no test, so the hat weights
//       and loads of its sources are independent and only the sum is a
//       chain (the sources piled on g_0 by the borrowing limit make one
//       destination's range tens of sources long). The next period's
//       clamped rows are copied into shared memory by cp.async during the
//       mix (a second buffer, copied a period ahead, measured no faster),
//       and each thread's next ranges (its first kMaxOwned destinations)
//       are loaded into registers a period ahead.
//   forward_scan_agg_kernel, one block per period: agg[t] from the stored
//       D_{t+1} with the previous kernel's per-thread partial sums (the same
//       FMAs in the same order) and its reduction tree.
// Shared memory: D, D_half and the clamped rows (3 n), the hat-basis grid
// arrays (4 n_a) and Pi, less than the previous kernel's, so every grid it
// takes fits. Global scratch: the clamped rows, the ranges and the history
// of D, T n each.
//
// What bounds it: latency still, one block walking T dependent periods on
// one SM: two barriers, each thread's short lottery loops and mix, and the
// longest range of the period (the borrowing limit's pile) as one chain of
// FMAs.
// Destinations per thread whose ranges live in registers (4 × 1024 in all);
// `tools/scan_owned_ab.py` builds the source with -DHANK_SCAN_OWNED=0 to time
// the kernel with every range read in its period's own loop.
#ifndef HANK_SCAN_OWNED
#define HANK_SCAN_OWNED 4
#endif
constexpr int kMaxOwned = HANK_SCAN_OWNED;
constexpr int kOwnedSlots = kMaxOwned > 0 ? kMaxOwned : 1;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A destination's source range [begin, end), packed as begin | end << 16,
// a non-negative int while n_a < 32768 (the launcher checks; every grid the
// shared memory takes has n_a < 7200), with bit 15 set on a fallback row:
// there the range is the whole row and each source is tested. On a
// non-decreasing row every source of the range passes the test (P[a] > gl
// from `begin` on, P[a] < gh before `end`), so it is not repeated.
constexpr int kTested = 0x8000;

__device__ __forceinline__ int pack_range(int begin, int end) { return begin | (end << 16); }

__global__ void __launch_bounds__(256) forward_scan_prep_kernel(
    const float* __restrict__ pol_g,     // (T, n_a, n_e)
    const float* __restrict__ grid_g,    // (n_a,)
    float* __restrict__ Pc,              // (T, n_e, n_a) clamped rows
    int* __restrict__ Rg,                // (T, n_e, n_a) packed source ranges
    int* __restrict__ fallback,          // (1,) or null
    int n_a, int n_e)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* P = reinterpret_cast<float*>(smem_raw);     // this row, (n_a,)
    const int t = blockIdx.x, e = blockIdx.y;
    const size_t n = (size_t)n_a * n_e;
    const float* pol_t = pol_g + (size_t)t * n;
    const float g_bot = grid_g[0], g_top = grid_g[n_a - 1];
    for (int a = threadIdx.x; a < n_a; a += blockDim.x) {
        const float p = fminf(fmaxf(pol_t[a * n_e + e], g_bot), g_top);
        P[a] = p;
        Pc[(size_t)t * n + (size_t)e * n_a + a] = p;
    }
    __syncthreads();
    int ok = 1;
    for (int a = threadIdx.x; a < n_a - 1; a += blockDim.x) ok &= P[a] <= P[a + 1];
    const bool mono = __syncthreads_and(ok);
    if (!mono && fallback != nullptr && threadIdx.x == 0) atomicAdd(fallback, 1);
    for (int b = threadIdx.x; b < n_a; b += blockDim.x) {
        int begin = 0, end = n_a;
        if (mono) {
            // The hat's support, as the previous kernel computes glo/ghi.
            const float gl = b == 0 ? grid_g[0] - (grid_g[1] - grid_g[0]) : grid_g[b - 1];
            const float gh = b == n_a - 1
                ? grid_g[n_a - 1] + (grid_g[n_a - 1] - grid_g[n_a - 2]) : grid_g[b + 1];
            int hi_a = n_a;      // the first a with P[a] > gl
            while (begin < hi_a) {
                const int mid = (begin + hi_a) >> 1;
                if (P[mid] > gl) hi_a = mid; else begin = mid + 1;
            }
            int lo_a = begin;    // the first a >= begin with !(P[a] < gh)
            while (lo_a < end) {
                const int mid = (lo_a + end) >> 1;
                if (P[mid] < gh) lo_a = mid + 1; else end = mid;
            }
        }
        Rg[(size_t)t * n + (size_t)e * n_a + b] = pack_range(begin, end) | (mono ? 0 : kTested);
    }
}

// One destination of the lottery: D_half[e, b] over the sources of `range`
// (`row` = e * n_a).
__device__ __forceinline__ float lottery_dest(
    const float* __restrict__ P, const float* __restrict__ X, const float* __restrict__ glo,
    const float* __restrict__ ghi, const float* __restrict__ iup,
    const float* __restrict__ idn, int row, int b, int range)
{
    const float gl = glo[b], gh = ghi[b], iu = iup[b], id = idn[b];
    const float* Pe = P + row;
    const float* Xe = X + row;
    float acc = 0.0f;
    const int begin = range & 0x7fff, end = range >> 16;
    if (range & kTested) {
        for (int a = begin; a < end; ++a) {
            const float p = Pe[a];
            if (!(p > gl && p < gh)) continue;   // the previous kernel's test
            const float up = (p - gl) * iu;
            const float down = (gh - p) * id;
            acc += fmaxf(down < up ? down : up, 0.0f) * Xe[a];
        }
        return acc;
    }
    // Every source passes the test: the hat weights and loads of several
    // sources are independent, and only the ascending sum is a chain.
#pragma unroll 8
    for (int a = begin; a < end; ++a) {
        const float p = Pe[a];
        const float up = (p - gl) * iu;
        const float down = (gh - p) * id;
        acc += fmaxf(down < up ? down : up, 0.0f) * Xe[a];
    }
    return acc;
}

// Markov mix of one destination: D'[e2, b] = sum_e Pi[e, e2] D_half[e, b].
__device__ __forceinline__ float mix_dest(const float* __restrict__ Pi,
                                          const float* __restrict__ Y, int e2, int b,
                                          int n_a, int n_e)
{
    float Dn = 0.0f;
    for (int e = 0; e < n_e; ++e) Dn += Pi[e * n_e + e2] * Y[e * n_a + b];
    return Dn;
}

__global__ void __launch_bounds__(kThreads) forward_scan_kernel(
    const float* __restrict__ Pc,        // (T, n_e, n_a) clamped rows
    const int* __restrict__ Rg,          // (T, n_e, n_a) packed source ranges
    const float* __restrict__ D0,        // (n_a, n_e)
    const float* __restrict__ grid_g,    // (n_a,)
    const float* __restrict__ Pi_g,      // (n_e, n_e) row-stochastic
    float* __restrict__ Dhist,           // (T, n_e, n_a): D_{t+1}
    float* __restrict__ D_T,             // (n_a, n_e)
    int T, int n_a, int n_e)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* X = reinterpret_cast<float*>(smem_raw);   // D, laid out (n_e, n_a)
    const int n = n_a * n_e;
    const int tid = threadIdx.x;
    float* Y = X + n;             // D_half
    float* glo = Y + n;
    float* ghi = glo + n_a;
    float* iup = ghi + n_a;
    float* idn = iup + n_a;
    float* Pi = idn + n_a;
    float* P = Pi + n_e * n_e;    // the period's clamped rows

    for (int i = tid; i < n_e * n_e; i += kThreads) Pi[i] = Pi_g[i];
    for (int idx = tid; idx < n; idx += kThreads) {
        const int e = idx / n_a;
        const int a = idx - e * n_a;
        X[idx] = D0[a * n_e + e];
        P[idx] = Pc[idx];
    }
    for (int i = tid; i < n_a; i += kThreads) {
        // The previous kernel's expressions on the same values.
        const float gi = grid_g[i];
        const float lo = i == 0 ? grid_g[0] - (grid_g[1] - grid_g[0]) : grid_g[i - 1];
        const float hi = i == n_a - 1 ? grid_g[n_a - 1] + (grid_g[n_a - 1] - grid_g[n_a - 2])
                                      : grid_g[i + 1];
        glo[i] = lo;
        ghi[i] = hi;
        iup[i] = 1.0f / (gi - lo);
        idn[i] = 1.0f / (hi - gi);
    }
    // This thread's first kMaxOwned destinations: income row, knot, and
    // the period's source range (the next period's is loaded a period ahead).
    int own_e[kOwnedSlots], own_b[kOwnedSlots], rr[kOwnedSlots], rr_next[kOwnedSlots];
#pragma unroll
    for (int k = 0; k < kMaxOwned; ++k) {
        const int idx = tid + k * kThreads;
        own_e[k] = idx < n ? idx / n_a : 0;
        own_b[k] = idx - own_e[k] * n_a;
        rr[k] = idx < n ? Rg[idx] : 0;
        rr_next[k] = 0;
    }
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        const bool next = t + 1 < T;
        if (next) {
#pragma unroll
            for (int k = 0; k < kMaxOwned; ++k) {
                const int idx = tid + k * kThreads;
                if (idx < n) rr_next[k] = Rg[(size_t)(t + 1) * n + idx];
            }
        }

        // Hat-basis Young lottery: D_half[e, b] = sum_a hat_b(p[e, a]) D[e, a].
#pragma unroll
        for (int k = 0; k < kMaxOwned; ++k) {
            const int idx = tid + k * kThreads;
            if (idx < n)
                Y[idx] = lottery_dest(P, X, glo, ghi, iup, idn, own_e[k] * n_a, own_b[k],
                                      rr[k]);
        }
        for (int idx = tid + kMaxOwned * kThreads; idx < n; idx += kThreads) {
            const int e = idx / n_a;
            Y[idx] = lottery_dest(P, X, glo, ghi, iup, idn, e * n_a, idx - e * n_a,
                                  Rg[(size_t)t * n + idx]);
        }
        __syncthreads();

        // The next period's rows, copied while the mix runs.
        if (next) {
            const float* Pn = Pc + (size_t)(t + 1) * n;
            for (int idx = tid; idx < n; idx += kThreads) cp_async4(P + idx, Pn + idx);
        }
        // Markov mix D'[e', b] = sum_e Pi[e, e'] D_half[e, b].
        float* Dt = Dhist + (size_t)t * n;
#pragma unroll
        for (int k = 0; k < kMaxOwned; ++k) {
            const int idx = tid + k * kThreads;
            if (idx < n) {
                const float Dn = mix_dest(Pi, Y, own_e[k], own_b[k], n_a, n_e);
                X[idx] = Dn;
                Dt[idx] = Dn;
            }
        }
        for (int idx = tid + kMaxOwned * kThreads; idx < n; idx += kThreads) {
            const int e2 = idx / n_a;
            const float Dn = mix_dest(Pi, Y, e2, idx - e2 * n_a, n_a, n_e);
            X[idx] = Dn;
            Dt[idx] = Dn;
        }
#pragma unroll
        for (int k = 0; k < kMaxOwned; ++k) rr[k] = rr_next[k];
        cp_async_wait_all();
        __syncthreads();
    }
    for (int idx = tid; idx < n; idx += kThreads) {
        const int e = idx / n_a;
        const int a = idx - e * n_a;
        D_T[a * n_e + e] = X[idx];
    }
}

__global__ void __launch_bounds__(kThreads) forward_scan_agg_kernel(
    const float* __restrict__ pol_g,     // (T, n_a, n_e)
    const float* __restrict__ Dhist,     // (T, n_e, n_a): D_{t+1}
    float* __restrict__ agg,             // (T,)
    int n_a, int n_e)
{
    __shared__ float red[kThreads];
    const int t = blockIdx.x, tid = threadIdx.x;
    const int n = n_a * n_e;
    const float* pol_t = pol_g + (size_t)t * n;
    const float* Dt = Dhist + (size_t)t * n;
    // The previous kernel's share of thread tid, in its order.
    float s = 0.0f;
    for (int idx = tid; idx < n; idx += kThreads) {
        const int e2 = idx / n_a;
        const int b = idx - e2 * n_a;
        s += pol_t[b * n_e + e2] * Dt[idx];
    }
    red[tid] = s;
    __syncthreads();
    for (int k = kThreads / 2; k > 0; k >>= 1) {
        if (tid < k) red[tid] += red[tid + k];
        __syncthreads();
    }
    if (tid == 0) agg[t] = red[0];
}

size_t forward_scan_smem_bytes(int n_a, int n_e) {
    return sizeof(float) * (3 * (size_t)n_a * n_e + 4 * (size_t)n_a + (size_t)n_e * n_e);
}

size_t forward_scan_prep_smem_bytes(int n_a) { return sizeof(float) * (size_t)n_a; }

}  // namespace

// Plain C interface (loaded with ctypes). Each launcher returns the
// cudaError_t of the attribute call or of cudaGetLastError() right after the
// launch; 0 means the kernel was enqueued on `stream`. The batched entry
// points launch the BATCHED build at every B, B = 1 included (the template
// there compiled the offset out; a batched entry point at B = 1 is on no
// solver's path). `fallback` may be null. The `_previous` entry points
// launch the template, which the new kernels are held to.
extern "C" {

int hank_sweep_jvp_f32(const void* r, const void* w, const void* dr, const void* dw,
                       const void* V_T, const void* D0, const void* grid,
                       const void* egrid, const void* Pi, void* pol, void* dpol,
                       void* agg, void* dagg, void* aggc, void* daggc, void* fallback,
                       int Tm1, int n_a, int n_e, double beta, double gamma,
                       double borrow_cons, void* stream) {
    const size_t smem = jvp_smem_bytes(n_a, n_e);
    cudaError_t err = cudaFuncSetAttribute(
        household_sweep_jvp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    household_sweep_jvp_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const float*)r, (const float*)w, (const float*)dr, (const float*)dw,
        (const float*)V_T, (const float*)D0, (const float*)grid, (const float*)egrid,
        (const float*)Pi, (float*)pol, (float*)dpol, (float*)agg, (float*)dagg,
        (float*)aggc, (float*)daggc, (int*)fallback, Tm1, n_a, n_e, (float)beta,
        (float)gamma, (float)borrow_cons);
    return (int)cudaGetLastError();
}

int hank_sweep_jvp_f32_batch(const void* r, const void* w, const void* dr,
                             const void* dw, const void* V_T, const void* D0,
                             const void* grid, const void* egrid, const void* Pi,
                             void* pol, void* dpol, void* agg, void* dagg,
                             void* aggc, void* daggc, void* fallback, int B, int Tm1,
                             int n_a, int n_e, double beta, double gamma,
                             double borrow_cons, void* stream) {
    return launch_ranged<float, true, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol,
                                            dpol, agg, dagg, aggc, daggc, fallback, B,
                                            Tm1, n_a, n_e, beta, gamma, borrow_cons,
                                            stream);
}

int hank_sweep_residual_f64_batch(const void* r, const void* w, const void* V_T,
                                  const void* D0, const void* grid,
                                  const void* egrid, const void* Pi, void* pol,
                                  void* agg, void* aggc, void* fallback, int B, int Tm1,
                                  int n_a, int n_e, double beta, double gamma,
                                  double borrow_cons, void* stream) {
    return launch_ranged<double, false, true>(r, w, nullptr, nullptr, V_T, D0, grid,
                                              egrid, Pi, pol, nullptr, agg, nullptr,
                                              aggc, nullptr, fallback, B, Tm1, n_a, n_e,
                                              beta, gamma, borrow_cons, stream);
}

int hank_sweep_residual_f64(const void* r, const void* w, const void* V_T,
                            const void* D0, const void* grid, const void* egrid,
                            const void* Pi, void* pol, void* agg, void* aggc,
                            void* fallback, int Tm1, int n_a, int n_e, double beta,
                            double gamma, double borrow_cons, void* stream) {
    return launch_ranged<double, false, false>(r, w, nullptr, nullptr, V_T, D0, grid,
                                               egrid, Pi, pol, nullptr, agg, nullptr,
                                               aggc, nullptr, fallback, 1, Tm1, n_a, n_e,
                                               beta, gamma, borrow_cons, stream);
}

int hank_sweep_jvp_f64(const void* r, const void* w, const void* dr, const void* dw,
                       const void* V_T, const void* D0, const void* grid,
                       const void* egrid, const void* Pi, void* pol, void* dpol,
                       void* agg, void* dagg, void* aggc, void* daggc, void* fallback,
                       int Tm1, int n_a, int n_e, double beta, double gamma,
                       double borrow_cons, void* stream) {
    return launch_ranged<double, true, false>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol,
                                              dpol, agg, dagg, aggc, daggc, fallback, 1,
                                              Tm1, n_a, n_e, beta, gamma, borrow_cons,
                                              stream);
}

// The f64 tangent sweep over B paths: hank_sweep_jvp_f32_batch's arguments
// in double, household_sweep_ranged_kernel<double, true, true>; row b is a
// single hank_sweep_jvp_f64 launch on row b, bit for bit.
int hank_sweep_jvp_f64_batch(const void* r, const void* w, const void* dr,
                             const void* dw, const void* V_T, const void* D0,
                             const void* grid, const void* egrid, const void* Pi,
                             void* pol, void* dpol, void* agg, void* dagg,
                             void* aggc, void* daggc, void* fallback, int B, int Tm1,
                             int n_a, int n_e, double beta, double gamma,
                             double borrow_cons, void* stream) {
    return launch_ranged<double, true, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol,
                                             dpol, agg, dagg, aggc, daggc, fallback, B,
                                             Tm1, n_a, n_e, beta, gamma, borrow_cons,
                                             stream);
}

// The global-state instantiations: the same arguments with `state`, the
// (B, 6n) workspace (3n for the residual sweeps) in the inputs' type, after
// `fallback`.
int hank_sweep_jvp_f32_global(const void* r, const void* w, const void* dr, const void* dw,
                              const void* V_T, const void* D0, const void* grid,
                              const void* egrid, const void* Pi, void* pol, void* dpol,
                              void* agg, void* dagg, void* aggc, void* daggc,
                              void* fallback, void* state, int Tm1, int n_a, int n_e,
                              double beta, double gamma, double borrow_cons, void* stream) {
    return launch_ranged<float, true, false, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi,
                                                   pol, dpol, agg, dagg, aggc, daggc,
                                                   fallback, 1, Tm1, n_a, n_e, beta, gamma,
                                                   borrow_cons, stream, state);
}

int hank_sweep_jvp_f32_batch_global(const void* r, const void* w, const void* dr,
                                    const void* dw, const void* V_T, const void* D0,
                                    const void* grid, const void* egrid, const void* Pi,
                                    void* pol, void* dpol, void* agg, void* dagg,
                                    void* aggc, void* daggc, void* fallback, void* state,
                                    int B, int Tm1, int n_a, int n_e, double beta,
                                    double gamma, double borrow_cons, void* stream) {
    return launch_ranged<float, true, true, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi,
                                                  pol, dpol, agg, dagg, aggc, daggc,
                                                  fallback, B, Tm1, n_a, n_e, beta, gamma,
                                                  borrow_cons, stream, state);
}

int hank_sweep_residual_f64_global(const void* r, const void* w, const void* V_T,
                                   const void* D0, const void* grid, const void* egrid,
                                   const void* Pi, void* pol, void* agg, void* aggc,
                                   void* fallback, void* state, int Tm1, int n_a, int n_e,
                                   double beta, double gamma, double borrow_cons,
                                   void* stream) {
    return launch_ranged<double, false, false, true>(r, w, nullptr, nullptr, V_T, D0, grid,
                                                     egrid, Pi, pol, nullptr, agg, nullptr,
                                                     aggc, nullptr, fallback, 1, Tm1, n_a,
                                                     n_e, beta, gamma, borrow_cons, stream,
                                                     state);
}

int hank_sweep_residual_f64_batch_global(const void* r, const void* w, const void* V_T,
                                         const void* D0, const void* grid,
                                         const void* egrid, const void* Pi, void* pol,
                                         void* agg, void* aggc, void* fallback,
                                         void* state, int B, int Tm1, int n_a, int n_e,
                                         double beta, double gamma, double borrow_cons,
                                         void* stream) {
    return launch_ranged<double, false, true, true>(r, w, nullptr, nullptr, V_T, D0, grid,
                                                    egrid, Pi, pol, nullptr, agg, nullptr,
                                                    aggc, nullptr, fallback, B, Tm1, n_a,
                                                    n_e, beta, gamma, borrow_cons, stream,
                                                    state);
}

int hank_sweep_jvp_f64_global(const void* r, const void* w, const void* dr, const void* dw,
                              const void* V_T, const void* D0, const void* grid,
                              const void* egrid, const void* Pi, void* pol, void* dpol,
                              void* agg, void* dagg, void* aggc, void* daggc,
                              void* fallback, void* state, int Tm1, int n_a, int n_e,
                              double beta, double gamma, double borrow_cons, void* stream) {
    return launch_ranged<double, true, false, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi,
                                                    pol, dpol, agg, dagg, aggc, daggc,
                                                    fallback, 1, Tm1, n_a, n_e, beta, gamma,
                                                    borrow_cons, stream, state);
}

int hank_sweep_jvp_f64_batch_global(const void* r, const void* w, const void* dr,
                                    const void* dw, const void* V_T, const void* D0,
                                    const void* grid, const void* egrid, const void* Pi,
                                    void* pol, void* dpol, void* agg, void* dagg,
                                    void* aggc, void* daggc, void* fallback, void* state,
                                    int B, int Tm1, int n_a, int n_e, double beta,
                                    double gamma, double borrow_cons, void* stream) {
    return launch_ranged<double, true, true, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi,
                                                   pol, dpol, agg, dagg, aggc, daggc,
                                                   fallback, B, Tm1, n_a, n_e, beta, gamma,
                                                   borrow_cons, stream, state);
}

int hank_sweep_jvp_f64_previous(const void* r, const void* w, const void* dr,
                                const void* dw, const void* V_T, const void* D0,
                                const void* grid, const void* egrid, const void* Pi,
                                void* pol, void* dpol, void* agg, void* dagg, void* aggc,
                                void* daggc, int Tm1, int n_a, int n_e, double beta,
                                double gamma, double borrow_cons, void* stream) {
    return launch<double, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol, dpol, agg,
                                dagg, aggc, daggc, 1, Tm1, n_a, n_e, beta, gamma,
                                borrow_cons, stream);
}

int hank_sweep_jvp_f32_batch_previous(const void* r, const void* w, const void* dr,
                                      const void* dw, const void* V_T, const void* D0,
                                      const void* grid, const void* egrid,
                                      const void* Pi, void* pol, void* dpol, void* agg,
                                      void* dagg, void* aggc, void* daggc, int B,
                                      int Tm1, int n_a, int n_e, double beta,
                                      double gamma, double borrow_cons, void* stream) {
    return launch<float, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol, dpol,
                               agg, dagg, aggc, daggc, B, Tm1, n_a, n_e, beta,
                               gamma, borrow_cons, stream);
}

// The counting template's f64 dual build over B paths (<double, true, true>
// at B > 1): the yardstick of hank_sweep_jvp_f64_batch.
int hank_sweep_jvp_f64_batch_previous(const void* r, const void* w, const void* dr,
                                      const void* dw, const void* V_T, const void* D0,
                                      const void* grid, const void* egrid,
                                      const void* Pi, void* pol, void* dpol, void* agg,
                                      void* dagg, void* aggc, void* daggc, int B,
                                      int Tm1, int n_a, int n_e, double beta,
                                      double gamma, double borrow_cons, void* stream) {
    return launch<double, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol, dpol,
                                agg, dagg, aggc, daggc, B, Tm1, n_a, n_e, beta,
                                gamma, borrow_cons, stream);
}

int hank_sweep_residual_f64_batch_previous(const void* r, const void* w, const void* V_T,
                                           const void* D0, const void* grid,
                                           const void* egrid, const void* Pi, void* pol,
                                           void* agg, void* aggc, int B, int Tm1,
                                           int n_a, int n_e, double beta, double gamma,
                                           double borrow_cons, void* stream) {
    return launch<double, false>(r, w, nullptr, nullptr, V_T, D0, grid, egrid, Pi,
                                 pol, nullptr, agg, nullptr, aggc, nullptr, B, Tm1,
                                 n_a, n_e, beta, gamma, borrow_cons, stream);
}

int hank_sweep_residual_f64_previous(const void* r, const void* w, const void* V_T,
                                     const void* D0, const void* grid, const void* egrid,
                                     const void* Pi, void* pol, void* agg, void* aggc,
                                     int Tm1, int n_a, int n_e, double beta,
                                     double gamma, double borrow_cons, void* stream) {
    return hank_sweep_residual_f64_batch_previous(r, w, V_T, D0, grid, egrid, Pi, pol,
                                                  agg, aggc, 1, Tm1, n_a, n_e, beta,
                                                  gamma, borrow_cons, stream);
}

int hank_forward_scan_f32(const void* pol, const void* D0, const void* grid,
                          const void* Pi, void* agg, void* D_T, void* Pc, void* Rg,
                          void* Dhist, void* fallback, int T, int n_a, int n_e,
                          void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = forward_scan_smem_bytes(n_a, n_e);
    const size_t smem_prep = forward_scan_prep_smem_bytes(n_a);
    if (n_a >= 32768) return (int)cudaErrorInvalidValue;   // the packed ranges
    cudaError_t err = cudaFuncSetAttribute(
        forward_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(forward_scan_prep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_prep);
    if (err != cudaSuccess) return (int)err;
    forward_scan_prep_kernel<<<dim3(T, n_e), 256, smem_prep, st>>>(
        (const float*)pol, (const float*)grid, (float*)Pc, (int*)Rg, (int*)fallback, n_a, n_e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    forward_scan_kernel<<<1, kThreads, smem, st>>>(
        (const float*)Pc, (const int*)Rg, (const float*)D0, (const float*)grid,
        (const float*)Pi, (float*)Dhist, (float*)D_T, T, n_a, n_e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    forward_scan_agg_kernel<<<T, kThreads, 0, st>>>(
        (const float*)pol, (const float*)Dhist, (float*)agg, n_a, n_e);
    return (int)cudaGetLastError();
}

int hank_forward_scan_f32_previous(const void* pol, const void* D0, const void* grid,
                                   const void* Pi, void* agg, void* D_T, int T, int n_a,
                                   int n_e, void* stream) {
    const size_t smem = forward_scan_previous_smem_bytes(n_a, n_e);
    cudaError_t err = cudaFuncSetAttribute(
        forward_scan_previous_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    forward_scan_previous_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const float*)pol, (const float*)D0, (const float*)grid, (const float*)Pi,
        (float*)agg, (float*)D_T, T, n_a, n_e);
    return (int)cudaGetLastError();
}

// which: 0 the previous kernel 7, 1 kernel 7 (its serial kernel; the prep
// kernel takes 4 n_a bytes).
size_t hank_forward_scan_smem_bytes(int which, int n_a, int n_e) {
    return which == 0 ? forward_scan_previous_smem_bytes(n_a, n_e)
                      : forward_scan_smem_bytes(n_a, n_e);
}

// which: 0 the template <double, false>, 1 the template <float, true>,
// 2 household_sweep_jvp_kernel, 3 household_sweep_ranged_kernel
// <float, true>, 4 household_sweep_ranged_kernel <double, false>,
// 5 household_sweep_ranged_kernel <double, true>, 6 the template
// <double, true>; the global-state instantiations 7 <float, true, false>
// (kernel 1's place), 8 <float, true, true>, 9 <double, false, *>,
// 10 <double, true, false>; the f64 tangent sweep over B paths, 15
// household_sweep_ranged_kernel <double, true, true> and 16 its global-state
// instantiation (the bytes of 5 and 10: a path axis adds nothing to a block).
size_t hank_sweep_smem_bytes(int which, int n_a, int n_e) {
    switch (which) {
        case 7:
        case 8: return global_smem_bytes<float, true>(n_a, n_e);
        case 9: return global_smem_bytes<double, false>(n_a, n_e);
        case 10:
        case 16: return global_smem_bytes<double, true>(n_a, n_e);
        case 15: return smem_bytes<double, true>(n_a, n_e);
        case 1: return smem_bytes<float, true>(n_a, n_e);
        case 2: return jvp_smem_bytes(n_a, n_e);
        case 3: return smem_bytes<float, true>(n_a, n_e);      // the template's bytes
        case 4: return smem_bytes<double, false>(n_a, n_e);
        case 5: return smem_bytes<double, true>(n_a, n_e);     // the template's bytes
        case 6: return smem_bytes<double, true>(n_a, n_e);
        default: return smem_bytes<double, false>(n_a, n_e);
    }
}

const char* hank_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef HANK_SWEEP_STAMPS
// The measurement build's stamps (kSweepSlots unsigned long long) into `out`
// (host memory), then set to zero; or only set to zero when `out` is null.
int hank_sweep_stamps(void* out) {
    cudaError_t err = cudaSuccess;
    if (out != nullptr)
        err = cudaMemcpyFromSymbol(out, g_sweep_stamps, sizeof(g_sweep_stamps));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[kSweepSlots] = {};
    return (int)cudaMemcpyToSymbol(g_sweep_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"
