// Household sweep for the canonical one-asset CRRA EGM model family
// (Krusell-Smith): a backward EGM recursion over T-1 periods, then the
// forward Young-lottery push-forward of the distribution, returning the
// savings and consumption aggregate paths.
//
// One source, one kernel template with a grid axis over paths
// (gridDim.x = B, one block per path), in two arithmetics, each built for
// B = 1 (path offset compiled out) and for B > 1:
//   household_sweep_kernel<float, true>   f32 primal + tangent (dual numbers).
//       B > 1 replaces the TPU kernel pair of
//       hank_tpu/ops/fused_sweep_batch.py (_make_bwd_kernel and
//       _make_fwd_kernel), every lockstep matvec of an ensemble. The TPU
//       split the batch into a backward and a forward kernel only because
//       B x 137 MB of policies cannot stay in VMEM; here each block keeps
//       its path's policies in its own slice of a global scratch buffer.
//       B = 1 is the earlier single-path kernel 1, kept as the yardstick
//       household_sweep_jvp_kernel is held to bit for bit.
//   household_sweep_kernel<double, false> values only, native FP64.
//       B = 1 replaces the TPU kernel hank_tpu/ops/fused_ds.py:
//       fused_ds_residual_sweep (_make_fused_ds_kernel), here in native FP64
//       instead of double-single f32 pairs, with general pow (no
//       integer-gamma gate); B > 1 is the batched residual of an ensemble.
// and, beside the template, two kernels of their own:
//   household_sweep_jvp_kernel: kernel 1, the single-path f32 primal +
//       tangent sweep, which replaces the TPU kernel
//       hank_tpu/ops/fused_sweep.py:385 fused_sweep_jvp
//       (_make_fused_sweep_kernel), every GMRES matvec of a single path. It
//       does the template's arithmetic with binary-search brackets and
//       lottery source ranges (its own note below);
//   forward_scan_kernel: the forward half alone in primal f32 over given
//       policies (replaces forward_scan_pallas; its own note below).
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
// block-wide barriers around O(n_e*n_a*n_a) compares and FMAs. One path
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

// Forward distribution scan, f32 primal: replaces the TPU kernel
// hank_tpu/ops/pallas_kernels.py:forward_scan_pallas
// (_make_forward_scan_kernel). Given T per-period savings policies, it runs
// the Young lottery, the Markov mix and the aggregation T times from D0 and
// returns agg[t] = sum(policy_t * D_{t+1}) (the policy unclipped) and D_T.
// It is household_sweep_kernel's forward loop in primal f32, with three
// differences: the policies come from an input (laid out (T, n_a, n_e), as
// the JAX function takes them) in place of the scratch, it runs T periods,
// it writes the final D, and it has no consumption aggregate. It is a body
// of its own: nvcc's schedule of household_sweep_kernel is fragile (a
// runtime offset alone cost it 9%), so that kernel's code is left as it is.
//
// The hat form here (policy clamped to [g_0, g_last], then the hat weight)
// is the same operator as the reference's bracket form (count of grid
// points below the policy, clipped to [1, n_a-1], then the clipped weight),
// but it rounds differently, by a few f32 ulps per period.
//
// What bounds it on the H100: latency. T dependent periods run one after
// another on one SM, each a handful of block-wide barriers (the clamp, the
// lottery, the mix and a 10-level reduction tree) around a few thousand
// compares and FMAs per thread; the 1.7 MB of policies it reads at
// 200x7, T=300 would take ~0.5 us at HBM rate. One block, 1024 threads, D in
// shared memory, no float atomics (one owner thread per destination and a
// fixed reduction tree), so two runs are bit-identical.
__global__ void __launch_bounds__(kThreads) forward_scan_kernel(
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

size_t forward_scan_smem_bytes(int n_a, int n_e) {
    return sizeof(float) * (3 * (size_t)n_a * n_e + 5 * (size_t)n_a
                            + (size_t)n_e * n_e + kThreads);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each launcher returns the
// cudaError_t of the attribute call or of cudaGetLastError() right after the
// launch; 0 means the kernel was enqueued on `stream`. The single-path
// residual is a B = 1 launch of the batched one; the single-path direction
// sweep launches household_sweep_jvp_kernel.
extern "C" {

int hank_sweep_jvp_f32_batch(const void* r, const void* w, const void* dr,
                             const void* dw, const void* V_T, const void* D0,
                             const void* grid, const void* egrid, const void* Pi,
                             void* pol, void* dpol, void* agg, void* dagg,
                             void* aggc, void* daggc, int B, int Tm1, int n_a,
                             int n_e, double beta, double gamma,
                             double borrow_cons, void* stream) {
    return launch<float, true>(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol, dpol,
                               agg, dagg, aggc, daggc, B, Tm1, n_a, n_e, beta,
                               gamma, borrow_cons, stream);
}

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

int hank_sweep_residual_f64_batch(const void* r, const void* w, const void* V_T,
                                  const void* D0, const void* grid,
                                  const void* egrid, const void* Pi, void* pol,
                                  void* agg, void* aggc, int B, int Tm1, int n_a,
                                  int n_e, double beta, double gamma,
                                  double borrow_cons, void* stream) {
    return launch<double, false>(r, w, nullptr, nullptr, V_T, D0, grid, egrid, Pi,
                                 pol, nullptr, agg, nullptr, aggc, nullptr, B, Tm1,
                                 n_a, n_e, beta, gamma, borrow_cons, stream);
}

int hank_sweep_residual_f64(const void* r, const void* w, const void* V_T,
                            const void* D0, const void* grid, const void* egrid,
                            const void* Pi, void* pol, void* agg, void* aggc,
                            int Tm1, int n_a, int n_e, double beta, double gamma,
                            double borrow_cons, void* stream) {
    return hank_sweep_residual_f64_batch(r, w, V_T, D0, grid, egrid, Pi, pol, agg,
                                         aggc, 1, Tm1, n_a, n_e, beta, gamma,
                                         borrow_cons, stream);
}

int hank_forward_scan_f32(const void* pol, const void* D0, const void* grid,
                          const void* Pi, void* agg, void* D_T, int T, int n_a,
                          int n_e, void* stream) {
    const size_t smem = forward_scan_smem_bytes(n_a, n_e);
    cudaError_t err = cudaFuncSetAttribute(
        forward_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    forward_scan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const float*)pol, (const float*)D0, (const float*)grid, (const float*)Pi,
        (float*)agg, (float*)D_T, T, n_a, n_e);
    return (int)cudaGetLastError();
}

size_t hank_forward_scan_smem_bytes(int n_a, int n_e) {
    return forward_scan_smem_bytes(n_a, n_e);
}

// which: 0 the template <double, false>, 1 the template <float, true>,
// 2 household_sweep_jvp_kernel.
size_t hank_sweep_smem_bytes(int which, int n_a, int n_e) {
    return which == 2 ? jvp_smem_bytes(n_a, n_e)
         : which == 1 ? smem_bytes<float, true>(n_a, n_e)
                      : smem_bytes<double, false>(n_a, n_e);
}

const char* hank_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
