// Household sweep for the canonical one-asset CRRA EGM model family
// (Krusell-Smith): a backward EGM recursion over T-1 periods, then the
// forward Young-lottery push-forward of the distribution, returning the
// savings and consumption aggregate paths.
//
// One source, one kernel template with a grid axis over paths
// (gridDim.x = B, one block per path), in two arithmetics, each built for
// B = 1 (path offset compiled out) and for B > 1:
//   household_sweep_kernel<float, true>   f32 primal + tangent (dual numbers).
//       B = 1 replaces the TPU kernel hank_tpu/ops/fused_sweep.py:
//       fused_sweep_jvp (_make_fused_sweep_kernel), every GMRES matvec of a
//       single path. B > 1 replaces the TPU kernel pair of
//       hank_tpu/ops/fused_sweep_batch.py (_make_bwd_kernel and
//       _make_fwd_kernel), every lockstep matvec of an ensemble. The TPU
//       split the batch into a backward and a forward kernel only because
//       B x 137 MB of policies cannot stay in VMEM; here each block keeps
//       its path's policies in its own slice of a global scratch buffer.
//   household_sweep_kernel<double, false> values only, native FP64.
//       B = 1 replaces the TPU kernel hank_tpu/ops/fused_ds.py:
//       fused_ds_residual_sweep (_make_fused_ds_kernel), here in native FP64
//       instead of double-single f32 pairs, with general pow (no
//       integer-gamma gate); B > 1 is the batched residual of an ensemble.
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
                const bool interior = tw_raw > S(0) && tw_raw < S(1) && den > S(0);
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
            for (int a = 0; a < n_a; ++a) {
                const S p = Pe[a];
                // Outside (g_{b-1}, g_{b+1}) both the hat and its slope are
                // exactly 0: skipping the source changes no bit of the sums.
                if (!(p > gl && p < gh)) continue;
                const S up = (p - gl) * iu;
                const S down = (gh - p) * id;
                const bool falling = down < up;
                const S hat_raw = falling ? down : up;
                const S hat = fmax(hat_raw, S(0));
                acc += hat * Xe[a];
                if (TANGENT) {
                    const S slope = hat_raw > S(0) ? (falling ? -id : iu) : S(0);
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

}  // namespace

// Plain C interface (loaded with ctypes). Each launcher returns the
// cudaError_t of the attribute call or of cudaGetLastError() right after the
// launch; 0 means the kernel was enqueued on `stream`. The single-path entry
// points are B = 1 launches of the batched ones.
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
                       void* agg, void* dagg, void* aggc, void* daggc,
                       int Tm1, int n_a, int n_e, double beta, double gamma,
                       double borrow_cons, void* stream) {
    return hank_sweep_jvp_f32_batch(r, w, dr, dw, V_T, D0, grid, egrid, Pi, pol,
                                    dpol, agg, dagg, aggc, daggc, 1, Tm1, n_a,
                                    n_e, beta, gamma, borrow_cons, stream);
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

size_t hank_sweep_smem_bytes(int tangent, int n_a, int n_e) {
    return tangent ? smem_bytes<float, true>(n_a, n_e)
                   : smem_bytes<double, false>(n_a, n_e);
}

const char* hank_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
