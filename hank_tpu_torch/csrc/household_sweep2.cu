// Two-asset household sweep (Calvo-access portfolio model,
// hank_tpu_torch/models/hank_two_asset.py), f32 primal + tangent.
//
//   two_asset_bwd_cluster_kernel  (kernel 5) replaces the TPU kernel
//       hank_tpu/ops/fused_sweep2.py: fused2_policies_jvp (_make_bwd2_kernel):
//       the backward dual Bellman recursion over T-1 periods, writing the
//       B/A/C policies of both access branches and their tangents.
//   two_asset_fwd_cluster_kernel  (kernel 6) replaces the TPU kernel
//       hank_tpu/ops/fused_sweep2.py: fused2_forward_jvp (_make_fwd2_kernel):
//       the forward dual push of the distribution (joint two-axis Young
//       lottery, income and access mixing) and the B/A/C aggregates, on one
//       thread-block cluster (its note is below). two_asset_fwd_kernel is the
//       previous kernel 6, one block, which it is held to bit for bit.
// two_asset_bwd_cluster_kernel (kernel 5 on a thread-block cluster, its note
// is below) is held bit for bit to two_asset_bwd_kernel, the previous
// kernel 5: one block walking the periods in order. Kernels 5 and 6 launch
// back to back, the same split as on the TPU.
//
// Ensembles: both cluster kernels take a path axis (template flag BATCHED,
// the `_batch` entry points): a grid of (C, B) blocks, one cluster per path,
// each path on its own rows of the inputs and its own slice of the outputs
// and scratch, the steady state, grids and transitions shared. The
// reference vmaps its XLA pipeline for a two-asset ensemble
// (hank_tpu/parallel/ensemble.py:283-292: its batched Pallas pair takes the
// one-asset family only). A row of a batched launch is the single-path
// launch on that row, bit for bit: the path offset is the only difference,
// and neither kernel's arithmetic depends on the cluster size.
//
// Grids past 2048 (b, a) states: kernel 6 takes a second template flag,
// GLOBAL_LISTS (its note is at the kernel), whose instantiations keep the
// lottery lists in a global workspace and take up to 4096 states, bit for
// bit the shared-list kernel; the wrappers pick it by the shared-memory
// count (hank_sweep2_smem_bytes, which = 4). Kernel 5 past its table's room
// runs untabled (bwd_cluster_tabled); hank_sweep2_policies_jvp_cluster_
// untabled_f32 launches that branch at any grid, for the card's A/B.
//
// Semantics are those of the plain PyTorch version (torch.func.jvp of
// ValueFunction and of forward_iteration), stage by stage: the gather-form
// interpolations (count bracket clipped to [1, n-1], clipped lerp, flat
// extrapolation with zero slopes outside the grid), the analytic
// breakpoint root of the portfolio split with its implicit-function
// tangent at the detached root, the slope-weighted envelope combination,
// and torch's derivative of min/max/clip at a tie (half to each side).
// Static sorted grids are bracketed by binary search, which gives the same
// count; the EGM's traced knots by the count of knots below the query,
// which stays right for non-monotone knots.
//
// What bounds the previous kernels on the H100: latency. One block walks
// its periods on one SM, every period a chain of block-wide barriers around
// O(states x knots) compares and FMAs. The previous kernel 5 keeps (V_b,
// V_a) and their tangents (4*N4 f32, 125 KB at 40x20x5x2) and the
// continuation surfaces W (64 KB) in shared memory; the V region doubles as
// the period's scratch between barriers. Policies go to the output (57 MB
// per sweep at T=300, which kernel 6 reads once). The previous kernel 6
// keeps D, the post-lottery D and their tangents (125 KB) in shared memory
// and works one (income, access) group at a time.
//
// Determinism: no float atomics. Every sum has one owner thread and a fixed
// order; the lottery's destinations sum their sources in source order (from
// per-row lists built with warp ballots in the previous kernel 6, from lists
// ranked by bitmaps in kernel 6); aggregates go through a fixed tree. Two
// runs are bit-identical.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBwdThreads = 512;
constexpr int kFwdThreads = 1024;   // power of two: the tree reduction needs it
constexpr size_t kSmemOptin = 227 * 1024;   // dynamic shared memory a block may use

// ── torch's derivative rules at ties ───────────────────────────────────────
// max(x, lo) / min(x, hi) pass the tangent on the strict side and half of it
// at a tie; clip(x, lo, hi) = min(max(x, lo), hi).
__device__ __forceinline__ float floor_f(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float floor_d(float x, float lo) {
    return x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
}
__device__ __forceinline__ float clip_f(float x, float lo, float hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float clip_d(float x, float lo, float hi) {
    return (x > lo && x < hi) ? 1.f : ((x == lo || x == hi) ? 0.5f : 0.f);
}
// minimum(a, b) of two duals (torch: b_t + where(a == b, 0.5, a < b)(a_t - b_t)).
__device__ __forceinline__ void min2(float a, float da, float b, float db,
                                     float& v, float& dv) {
    const float f = a == b ? 0.5f : (a < b ? 1.f : 0.f);
    v = a < b ? a : b;
    if (a != a) v = a;          // NaN propagates as in torch
    dv = db + f * (da - db);
}
__device__ __forceinline__ void max2(float a, float da, float b, float db,
                                     float& v, float& dv) {
    const float f = a == b ? 0.5f : (a > b ? 1.f : 0.f);
    v = a > b ? a : b;
    if (a != a) v = a;
    dv = db + f * (da - db);
}

// W^(-1/2) as rsqrt with one Newton polish (models/hank_two_asset._crra_inv_marg).
__device__ __forceinline__ void inv_marg2(float W, float dW, float& c, float& dc) {
    const float y = rsqrtf(W);
    const float dy = -0.5f * y * y * y * dW;
    const float u = 1.5f - 0.5f * W * y * y;
    const float du = -0.5f * (dW * y * y + W * (2.f * y * dy));
    c = y * u;
    dc = dy * u + y * du;
}

// First index i in [0, n] with !(g[i] < q): the count of knots below q for a
// sorted grid.
__device__ __forceinline__ int count_below_sorted(const float* g, int n, float q) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (g[mid] < q) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Bracket of a dual query q on a static sorted grid: index i in [1, n-1],
// clipped weight t and its tangent, and the open-interval flag of the slopes.
struct Bracket {
    int i;
    float lo, hi, t, dt;
    bool in;
};

__device__ __forceinline__ Bracket bracket(const float* g, int n, float q, float dq) {
    Bracket B;
    B.i = min(max(count_below_sorted(g, n, q), 1), n - 1);
    B.lo = g[B.i - 1];
    B.hi = g[B.i];
    const float raw = (q - B.lo) / (B.hi - B.lo);
    B.t = clip_f(raw, 0.f, 1.f);
    B.dt = clip_d(raw, 0.f, 1.f) * (dq / (B.hi - B.lo));
    B.in = q > g[0] && q < g[n - 1];
    return B;
}

// Bilinear value and axis slopes of a surface over (b, a) for income state e,
// with tangents through the surface (dW) and through the queries (dt). The
// surface is W[(b*NA + a)*NE + e] of mode 0 (Wb), 1 (Wa), 2 (Wb - Wa) or
// 3 (Wb + Wa), read from the W region (Wb, Wa, dWb, dWa each N3 long).
struct Bi {
    float v, dv, sb, dsb, sa, dsa;
};

__device__ __forceinline__ float surf(const float* W, int N3, int mode, int k) {
    const float b = W[k], a = W[N3 + k];
    return mode == 0 ? b : (mode == 1 ? a : (mode == 2 ? b - a : b + a));
}

__device__ Bi bilinear(const float* W, int N3, int NA, int NE, int e, int mode,
                       const Bracket& B, const Bracket& A) {
    const int k00 = ((B.i - 1) * NA + A.i - 1) * NE + e;
    const int k01 = k00 + NE;
    const int k10 = k00 + NA * NE;
    const int k11 = k10 + NE;
    const float* dW = W + 2 * N3;
    const float W00 = surf(W, N3, mode, k00), W01 = surf(W, N3, mode, k01);
    const float W10 = surf(W, N3, mode, k10), W11 = surf(W, N3, mode, k11);
    const float d00 = surf(dW, N3, mode, k00), d01 = surf(dW, N3, mode, k01);
    const float d10 = surf(dW, N3, mode, k10), d11 = surf(dW, N3, mode, k11);
    const float tb = B.t, ta = A.t, dtb = B.dt, dta = A.dt;
    Bi o;
    o.v = (1.f - tb) * (1.f - ta) * W00 + (1.f - tb) * ta * W01
          + tb * (1.f - ta) * W10 + tb * ta * W11;
    o.dv = (1.f - tb) * (1.f - ta) * d00 + (1.f - tb) * ta * d01
           + tb * (1.f - ta) * d10 + tb * ta * d11
           + dtb * ((1.f - ta) * (W10 - W00) + ta * (W11 - W01))
           + dta * ((1.f - tb) * (W01 - W00) + tb * (W11 - W10));
    const float hb = B.hi - B.lo, ha = A.hi - A.lo;
    if (B.in) {
        o.sb = ((1.f - ta) * (W10 - W00) + ta * (W11 - W01)) / hb;
        o.dsb = (dta * ((W11 - W01) - (W10 - W00))
                 + (1.f - ta) * (d10 - d00) + ta * (d11 - d01)) / hb;
    } else {
        o.sb = 0.f;
        o.dsb = 0.f;
    }
    if (A.in) {
        o.sa = ((1.f - tb) * (W01 - W00) + tb * (W11 - W10)) / ha;
        o.dsa = (dtb * ((W11 - W10) - (W01 - W00))
                 + (1.f - tb) * (d01 - d00) + tb * (d11 - d10)) / ha;
    } else {
        o.sa = 0.f;
        o.dsa = 0.f;
    }
    return o;
}

// Cycle stamps of each block's thread 0, compiled only into the measurement
// builds of hank_tpu_torch/tools/kernel5_split.py (nvcc -DHANK_K5_STAMPS:
// both kernel 5s) and hank_tpu_torch/tools/kernel6_split.py
// (-DHANK_K6_STAMPS: both kernel 6s): from(i) notes the clock, to(i) adds
// the cycles since from(i) to slot i, save() writes the slots to
// out[0, kStampSlots). Without its macro a kernel's stamps are empty and
// its entry point takes no stamps argument.
#if defined(HANK_K5_STAMPS) || defined(HANK_K6_STAMPS)
constexpr int kStampSlots = 32;
struct Stamps {
    long long* out;
    long long at[kStampSlots], sum[kStampSlots];
    __device__ explicit Stamps(long long* o) : out(o) {
        for (int i = 0; i < kStampSlots; ++i) sum[i] = 0;
    }
    __device__ void from(int i) { if (threadIdx.x == 0) at[i] = clock64(); }
    __device__ void to(int i) { if (threadIdx.x == 0) sum[i] += clock64() - at[i]; }
    __device__ void save() const {
        if (threadIdx.x == 0) for (int i = 0; i < kStampSlots; ++i) out[i] = sum[i];
    }
};
#endif
struct NoStamps {
    __device__ void from(int) {}
    __device__ void to(int) {}
    __device__ void save() const {}
};
#ifdef HANK_K5_STAMPS
#define K5_STAMPS_PARAM , long long* stamps_out
#define K5_STAMPS(offset) Stamps st(stamps_out + (offset))
#define K5_ENTRY_PARAM , void* stamps
#define K5_ENTRY_ARG , static_cast<long long*>(stamps)
#else
#define K5_STAMPS_PARAM
#define K5_STAMPS(offset) NoStamps st
#define K5_ENTRY_PARAM
#define K5_ENTRY_ARG
#endif
#ifdef HANK_K6_STAMPS
#define K6_STAMPS_PARAM , long long* stamps_out
#define K6_STAMPS(offset) Stamps st(stamps_out + (offset))
#define K6_ENTRY_PARAM , void* stamps
#define K6_ENTRY_ARG , static_cast<long long*>(stamps)
#else
#define K6_STAMPS_PARAM
#define K6_STAMPS(offset) NoStamps st
#define K6_ENTRY_PARAM
#define K6_ENTRY_ARG
#endif

struct BwdLayout {
    int N3, N4, NS, K, R;
};

__host__ __device__ inline BwdLayout bwd_layout(int NB, int NA, int NE) {
    BwdLayout L;
    L.N3 = NB * NA * NE;
    L.N4 = 2 * L.N3;
    L.NS = NB;
    L.K = NA + NB + 2;
    const int c = (L.K + 6) * L.NS * NE;
    L.R = 8 * L.N3 > c ? 8 * L.N3 : c;
    return L;
}

size_t bwd_smem_bytes(int NB, int NA, int NE) {
    const BwdLayout L = bwd_layout(NB, NA, NE);
    return sizeof(float) * ((size_t)L.R + 4 * (size_t)L.N3 + 3 * (size_t)NB + NA
                            + NE + (size_t)NE * NE);
}

// ── The previous kernel 5: the backward dual Bellman recursion, one block ─
// Outputs out[q][t][i4], q = B, A, C, dB, dA, dC, each (Tm1, N4) with
// i4 = ((b*NA + a)*NE + e)*2 + access. margin_g: 2*N3 floats of global
// scratch (the no-access illiquid margin and its tangent). Stamp slots: [0]
// A, [1] B1, [2] B2, [3] C1, [4] C2, [5] C3, [6] C4, [7] D, [8] the sweep.
__global__ void __launch_bounds__(kBwdThreads) two_asset_bwd_kernel(
    const float* __restrict__ r_p, const float* __restrict__ ra_p,
    const float* __restrict__ w_p, const float* __restrict__ tau_p,
    const float* __restrict__ dr_p, const float* __restrict__ dra_p,
    const float* __restrict__ dw_p, const float* __restrict__ dtau_p,
    const float* __restrict__ V_T,
    const float* __restrict__ bgrid_g, const float* __restrict__ agrid_g,
    const float* __restrict__ egrid_g, const float* __restrict__ Pi_g,
    float* __restrict__ margin_g, float* __restrict__ out,
    int Tm1, int NB, int NA, int NE, float beta, float lam, float chi, float borrow
    K5_STAMPS_PARAM)
{
    extern __shared__ __align__(16) float sm[];
    K5_STAMPS(0);
    st.from(8);
    const BwdLayout L = bwd_layout(NB, NA, NE);
    const int N3 = L.N3, N4 = L.N4, NS = L.NS, K = L.K;
    const int tid = threadIdx.x;
    const size_t TN = (size_t)Tm1 * N4;

    float* R = sm;                    // V, dV at period ends; scratch inside
    float* W = R + L.R;               // Wb, Wa, dWb, dWa
    float* bg = W + 4 * N3;
    float* ag = bg + NB;
    float* sg = ag + NA;              // s grid of the access EGM
    float* eg = sg + NB;
    float* Pi = eg + NE;

    for (int i = tid; i < NB; i += kBwdThreads) bg[i] = bgrid_g[i];
    for (int i = tid; i < NA; i += kBwdThreads) ag[i] = agrid_g[i];
    for (int i = tid; i < NE; i += kBwdThreads) eg[i] = egrid_g[i];
    for (int i = tid; i < NE * NE; i += kBwdThreads) Pi[i] = Pi_g[i];
    for (int i = tid; i < 2 * N4; i += kBwdThreads) {
        R[i] = V_T[i];
        R[2 * N4 + i] = 0.f;
    }
    __syncthreads();
    const float btop = bg[NB - 1], atop = ag[NA - 1];
    const float ratio = (btop + atop) / btop;
    for (int i = tid; i < NB; i += kBwdThreads) sg[i] = bg[i] * ratio;
    __syncthreads();
    const float s1 = sg[1];

    for (int t = Tm1 - 1; t >= 0; --t) {
        const float r = r_p[t], ra = ra_p[t], w = w_p[t], tau = tau_p[t];
        const float dr = dr_p[t], dra = dra_p[t], dw = dw_p[t], dtau = dtau_p[t];
        const float one_r = 1.f + r, one_ra = 1.f + ra;
        const float pre = (1.f - tau) * w;
        const float dpre = -dtau * w + (1.f - tau) * dw;
        const float ymax = floor_f(pre, 1e-9f);
        const float dymax = floor_d(pre, 1e-9f) * dpre;
        float* Bo = out + (size_t)t * N4;          // B, A, C, dB, dA, dC rows of t

        st.from(0);
        // A. Continuations: access mix, income expectation, floor.
        for (int i = tid; i < N3; i += kBwdThreads) {
            const int e = i % NE;
            const int ba = i - e;
            for (int s = 0; s < 2; ++s) {
                const float* V = R + s * N4;
                const float* dV = R + 2 * N4 + s * N4;
                float E = 0.f, dE = 0.f;
                for (int f = 0; f < NE; ++f) {
                    const int k = (ba + f) * 2;
                    const float vm = (1.f - lam) * V[k] + lam * V[k + 1];
                    const float dvm = (1.f - lam) * dV[k] + lam * dV[k + 1];
                    E += vm * Pi[e * NE + f];
                    dE += dvm * Pi[e * NE + f];
                }
                const float x = beta * E;
                W[s * N3 + i] = floor_f(x, 1e-12f);
                W[(2 + s) * N3 + i] = floor_d(x, 1e-12f) * (beta * dE);
            }
        }
        __syncthreads();
        st.to(0);

        st.from(1);
        // B1. No access: both surfaces at the capped accrual point a_next(a),
        //     then the implied liquid wealth of the EGM.
        for (int i = tid; i < N3; i += kBwdThreads) {
            const int e = i % NE;
            const int a = (i / NE) % NA;
            const float a_raw = one_ra * ag[a];
            const float da_raw = dra * ag[a];
            float a_next, da_next;
            min2(a_raw, da_raw, atop, 0.f, a_next, da_next);
            const Bracket Q = bracket(ag, NA, a_next, da_next);
            const int b = i / (NA * NE);
            const int klo = (b * NA + Q.i - 1) * NE + e, khi = klo + NE;
            float wn[2], dwn[2];
            for (int s = 0; s < 2; ++s) {
                const float lo = W[s * N3 + klo], hi = W[s * N3 + khi];
                const float dlo = W[(2 + s) * N3 + klo], dhi = W[(2 + s) * N3 + khi];
                wn[s] = lo + Q.t * (hi - lo);
                dwn[s] = dlo + Q.dt * (hi - lo) + Q.t * (dhi - dlo);
                R[s * N3 + i] = wn[s];
                R[(2 + s) * N3 + i] = dwn[s];
            }
            float c, dc;
            inv_marg2(wn[0], dwn[0], c, dc);
            const float inc = (a_raw - a_next) + ymax * eg[e];
            const float dinc = (da_raw - da_next) + dymax * eg[e];
            const float num = c + bg[b] - inc;
            const float imp = num / one_r;
            R[4 * N3 + i] = imp;
            R[5 * N3 + i] = ((dc - dinc) - imp * dr) / one_r;
        }
        __syncthreads();
        st.to(1);

        st.from(2);
        // B2. Liquid policy on the grid (traced knots: count bracket), clips,
        //     consumption, and the illiquid margin at (b', a_next).
        for (int i = tid; i < N3; i += kBwdThreads) {
            const int e = i % NE;
            const int a = (i / NE) % NA;
            const int b = i / (NA * NE);
            const int col = a * NE + e;                 // knots R[4N3 + k*NA*NE + col]
            const float x = bg[b];
            int cnt = 0;
            for (int k = 0; k < NB; ++k) cnt += R[4 * N3 + k * NA * NE + col] < x ? 1 : 0;
            const int j = min(max(cnt, 1), NB - 1);
            const float lo = R[4 * N3 + (j - 1) * NA * NE + col];
            const float hi = R[4 * N3 + j * NA * NE + col];
            const float dlo = R[5 * N3 + (j - 1) * NA * NE + col];
            const float dhi = R[5 * N3 + j * NA * NE + col];
            const float den = hi - lo;
            const float safe = den > 0.f ? den : 1.f;
            const float dsafe = den > 0.f ? dhi - dlo : 0.f;
            const float raw = (x - lo) / safe;
            const float draw = (-dlo - raw * dsafe) / safe;
            const float tt = clip_f(raw, 0.f, 1.f);
            const float dtt = clip_d(raw, 0.f, 1.f) * draw;
            const float vlo = bg[j - 1], vhi = bg[j];
            float pol = vlo + tt * (vhi - vlo);
            float dpol = dtt * (vhi - vlo);
            const float f1 = floor_f(pol, borrow);
            const float df1 = floor_d(pol, borrow) * dpol;
            min2(f1, df1, btop, 0.f, pol, dpol);

            const float a_raw = one_ra * ag[a];
            const float da_raw = dra * ag[a];
            float a_next, da_next;
            min2(a_raw, da_raw, atop, 0.f, a_next, da_next);
            const float inc = (a_raw - a_next) + ymax * eg[e];
            const float dinc = (da_raw - da_next) + dymax * eg[e];
            const float craw = one_r * x + inc - pol;
            const float dcraw = dr * x + dinc - dpol;
            const float c = floor_f(craw, 1e-12f);
            const float dc = floor_d(craw, 1e-12f) * dcraw;
            Bo[2 * i] = pol;
            Bo[TN + 2 * i] = a_next;
            Bo[2 * TN + 2 * i] = c;
            Bo[3 * TN + 2 * i] = dpol;
            Bo[4 * TN + 2 * i] = da_next;
            Bo[5 * TN + 2 * i] = dc;

            // W_a(b', a_next) along b (static grid, traced query).
            const Bracket Q = bracket(bg, NB, pol, dpol);
            const int klo = (Q.i - 1) * NA * NE + col, khi = klo + NA * NE;
            const float wlo = R[N3 + klo], whi = R[N3 + khi];
            const float dwlo = R[3 * N3 + klo], dwhi = R[3 * N3 + khi];
            const bool capped = a_raw >= atop;
            margin_g[i] = capped ? 0.f : wlo + Q.t * (whi - wlo);
            margin_g[N3 + i] = capped ? 0.f : dwlo + Q.dt * (whi - wlo) + Q.t * (dwhi - dwlo);
        }
        __syncthreads();
        st.to(2);

        st.from(3);
        // C1. Penalty scale of the portfolio split, per (s, e).
        const int SE = NS * NE;
        float* gc = R;                           // (K, NS, NE) FOC gaps
        float* pen = R + K * SE;
        float* dpen = pen + SE;
        float* ast = dpen + SE;
        float* dast = ast + SE;
        float* wkn = dast + SE;
        float* dwkn = wkn + SE;
        for (int q = tid; q < SE; q += kBwdThreads) {
            if (chi > 0.f) {
                const int s = q / NE, e = q % NE;
                const float mid = 0.5f * sg[s];
                const Bracket Bq = bracket(bg, NB, mid, 0.f);
                const Bracket Aq = bracket(ag, NA, mid, 0.f);
                const Bi m = bilinear(W, N3, NA, NE, e, 3, Bq, Aq);
                const float den = sg[s] > s1 ? sg[s] : s1;
                pen[q] = chi * m.v / den;
                dpen[q] = chi * m.dv / den;
            } else {
                pen[q] = 0.f;
                dpen[q] = 0.f;
            }
        }
        __syncthreads();
        st.to(3);

        st.from(4);
        // C2. FOC gap at every breakpoint candidate (primal only: the root is
        //     detached).
        for (int q = tid; q < K * SE; q += kBwdThreads) {
            const int k = q / SE;
            const int se = q - k * SE;
            const int s = se / NE, e = se % NE;
            const float s2 = sg[s];
            float c = k == 0 ? 0.f : (k <= NA ? ag[k - 1] : (k <= NA + NB ? s2 - bg[k - NA - 1] : s2));
            c = clip_f(c, 0.f, s2);
            const Bracket Bq = bracket(bg, NB, s2 - c, 0.f);
            const Bracket Aq = bracket(ag, NA, c, 0.f);
            const Bi g = bilinear(W, N3, NA, NE, e, 2, Bq, Aq);
            gc[q] = chi > 0.f ? g.v + pen[se] * (c - 0.5f * s2) : g.v;
        }
        __syncthreads();
        st.to(4);

        st.from(5);
        // C3. Bracket, quadratic root, implicit-function step, envelope
        //     surfaces at the split, endogenous cash-on-hand knots; per (s, e).
        for (int se = tid; se < SE; se += kBwdThreads) {
            const int s = se / NE, e = se % NE;
            const float s2 = sg[s];
            float lo = -FLT_MAX, hi = FLT_MAX, g0 = -FLT_MAX, g1 = FLT_MAX;
            bool has_neg = false, has_pos = false;
            for (int k = 0; k < K; ++k) {
                float c = k == 0 ? 0.f : (k <= NA ? ag[k - 1] : (k <= NA + NB ? s2 - bg[k - NA - 1] : s2));
                c = clip_f(c, 0.f, s2);
                const float g = gc[k * SE + se];
                if (g < 0.f) {
                    has_neg = true;
                    lo = fmaxf(lo, c);
                    g0 = fmaxf(g0, g);
                } else {
                    has_pos = true;
                    hi = fminf(hi, c);
                    g1 = fminf(g1, g);
                }
            }
            const float g_lo = gc[se], g_hi = gc[(K - 1) * SE + se];
            if (!has_neg) { lo = 0.f; g0 = -1.f; }
            if (!has_pos) { hi = s2; g1 = 1.f; }
            const float h = hi - lo;
            const float p = pen[se], dp = dpen[se];
            float gm;
            {
                const float am = 0.5f * (lo + hi);
                const Bi g = bilinear(W, N3, NA, NE, e, 2, bracket(bg, NB, s2 - am, 0.f),
                                      bracket(ag, NA, am, 0.f));
                gm = chi > 0.f ? g.v + p * (am - 0.5f * s2) : g.v;
            }
            const float a1c = -3.f * g0 + 4.f * gm - g1;
            const float a2c = 2.f * g0 - 4.f * gm + 2.f * g1;
            const float disc = floor_f(a1c * a1c - 4.f * a2c * g0, 0.f);
            const float sgn = a1c >= 0.f ? 1.f : -1.f;
            const float qq = -0.5f * (a1c + sgn * sqrtf(disc));
            const float u_a = g0 / (fabsf(qq) > 0.f ? qq : 1.f);
            const float u_b = qq / (fabsf(a2c) > 0.f ? a2c : 1.f);
            const bool in01 = u_a >= 0.f && u_a <= 1.f && fabsf(qq) > 0.f;
            const float u = clip_f(in01 ? u_a : u_b, 0.f, 1.f);
            const float a_it = h > 0.f ? lo + u * h : lo;

            // One Newton step at the detached root, slope held constant.
            const Bi g = bilinear(W, N3, NA, NE, e, 2, bracket(bg, NB, s2 - a_it, 0.f),
                                  bracket(ag, NA, a_it, 0.f));
            float g_at = g.v, dg_at = g.dv, gp = g.sa - g.sb;
            if (chi > 0.f) {
                g_at = g_at + p * (a_it - 0.5f * s2);
                dg_at = dg_at + dp * (a_it - 0.5f * s2);
                gp = gp + p;
            }
            const float g_a = floor_f(gp, 1e-10f);
            const float araw = a_it - g_at / g_a;
            const float daraw = -(dg_at / g_a);
            float a_star = clip_f(araw, 0.f, s2);
            float da_star = clip_d(araw, 0.f, s2) * daraw;
            if (g_lo >= 0.f) { a_star = 0.f; da_star = 0.f; }
            else if (g_hi <= 0.f) { a_star = s2; da_star = 0.f; }
            const float b_star = s2 - a_star, db_star = -da_star;

            const Bracket Bq = bracket(bg, NB, b_star, db_star);
            const Bracket Aq = bracket(ag, NA, a_star, da_star);
            const Bi vb = bilinear(W, N3, NA, NE, e, 0, Bq, Aq);
            const Bi va = bilinear(W, N3, NA, NE, e, 1, Bq, Aq);
            const float wbp = vb.sa - vb.sb, dwbp = vb.dsa - vb.dsb;
            const float wap = va.sa - va.sb, dwap = va.dsa - va.dsb;
            const float gps = wbp - wap, dgps = dwbp - dwap;
            const bool ok = a_star > 0.f && a_star < s2 && wbp >= 0.f && wap <= 0.f
                            && gps > 1e-10f;
            float Ws, dWs;
            if (ok) {
                const float num = wbp * va.v - wap * vb.v;
                const float dnum = dwbp * va.v + wbp * va.dv - (dwap * vb.v + wap * vb.dv);
                Ws = num / gps;
                dWs = (dnum - Ws * dgps) / gps;
            } else {
                max2(vb.v, vb.dv, va.v, va.dv, Ws, dWs);
            }
            float c, dc;
            inv_marg2(Ws, dWs, c, dc);
            ast[se] = a_star;
            dast[se] = da_star;
            wkn[se] = c + s2;
            dwkn[se] = dc;
        }
        __syncthreads();
        st.to(5);

        st.from(6);
        // C4. Access branch on the grid: savings through the endogenous
        //     cash-on-hand knots, split at s*, clips, consumption.
        for (int i = tid; i < N3; i += kBwdThreads) {
            const int e = i % NE;
            const int a = (i / NE) % NA;
            const int b = i / (NA * NE);
            const float ye = ymax * eg[e], dye = dymax * eg[e];
            const float coh = one_r * bg[b] + one_ra * ag[a] + ye;
            const float dcoh = dr * bg[b] + dra * ag[a] + dye;
            int cnt = 0;
            for (int k = 0; k < NS; ++k) cnt += wkn[k * NE + e] < coh ? 1 : 0;
            const int j = min(max(cnt, 1), NS - 1);
            const float lo = wkn[(j - 1) * NE + e], hi = wkn[j * NE + e];
            const float dlo = dwkn[(j - 1) * NE + e], dhi = dwkn[j * NE + e];
            const float den = hi - lo;
            const float safe = den > 0.f ? den : 1.f;
            const float dsafe = den > 0.f ? dhi - dlo : 0.f;
            const float raw = (coh - lo) / safe;
            const float draw = (dcoh - dlo - raw * dsafe) / safe;
            const float tt = clip_f(raw, 0.f, 1.f);
            const float dtt = clip_d(raw, 0.f, 1.f) * draw;
            const float ps0 = sg[j - 1] + tt * (sg[j] - sg[j - 1]);
            const float dps0 = dtt * (sg[j] - sg[j - 1]);
            const float ps = floor_f(ps0, 0.f);
            const float dps = floor_d(ps0, 0.f) * dps0;

            // a' = interp(s-knots ↦ a*) at the savings policy.
            const Bracket Q = bracket(sg, NS, ps, dps);
            const float alo = ast[(Q.i - 1) * NE + e], ahi = ast[Q.i * NE + e];
            const float dalo = dast[(Q.i - 1) * NE + e], dahi = dast[Q.i * NE + e];
            const float pa0 = alo + Q.t * (ahi - alo);
            const float dpa0 = dalo + Q.dt * (ahi - alo) + Q.t * (dahi - dalo);
            float cap, dcap, pa, dpa;
            min2(ps, dps, atop, 0.f, cap, dcap);
            min2(floor_f(pa0, 0.f), floor_d(pa0, 0.f) * dpa0, cap, dcap, pa, dpa);
            const float pb0 = ps - pa, dpb0 = dps - dpa;
            float pb, dpb;
            min2(floor_f(pb0, borrow), floor_d(pb0, borrow) * dpb0, btop, 0.f, pb, dpb);
            const float craw = coh - pb - pa;
            const float dcraw = dcoh - dpb - dpa;
            Bo[2 * i + 1] = pb;
            Bo[TN + 2 * i + 1] = pa;
            Bo[2 * TN + 2 * i + 1] = floor_f(craw, 1e-12f);
            Bo[3 * TN + 2 * i + 1] = dpb;
            Bo[4 * TN + 2 * i + 1] = dpa;
            Bo[5 * TN + 2 * i + 1] = floor_d(craw, 1e-12f) * dcraw;
        }
        __syncthreads();
        st.to(6);

        st.from(7);
        // D. Envelopes: the next period's (V_b, V_a) and tangents.
        for (int i = tid; i < N3; i += kBwdThreads) {
            for (int acc = 0; acc < 2; ++acc) {
                const float c = Bo[2 * TN + 2 * i + acc];
                const float dc = Bo[5 * TN + 2 * i + acc];
                const float cc = c * c;
                const float up = 1.f / cc;
                const float dup = -(dc * c + c * dc) * up * up;
                const int k = 2 * i + acc;
                R[k] = one_r * up;
                R[2 * N4 + k] = dr * up + one_r * dup;
                if (acc == 0) {
                    const float m = margin_g[i], dm = margin_g[N3 + i];
                    R[N4 + k] = one_ra * m;
                    R[3 * N4 + k] = dra * m + one_ra * dm;
                } else {
                    R[N4 + k] = one_ra * up;
                    R[3 * N4 + k] = dra * up + one_ra * dup;
                }
            }
        }
        __syncthreads();
        st.to(7);
    }
    st.to(8);
    st.save();
}

// ── Kernel 5 on a thread-block cluster ────────────────────────────────────
// two_asset_bwd_cluster_kernel replaces, like two_asset_bwd_kernel above,
// the TPU kernel hank_tpu/ops/fused_sweep2.py: fused2_policies_jvp
// (_make_bwd2_kernel), and gives two_asset_bwd_kernel's bits.
//
// Why a new design (PERF.md §6; H100 80GB HBM3, 700 W; measured with
// hank_tpu_torch/tools/kernel5_split.py): at 40x20x5x2, T=300 the previous
// kernel takes 83 us (163k cycles) a period on one SM of 132: the FOC gaps
// at 62 x 200 candidates (C2) 35% of it, the two 40-knot count loops (B2,
// C4) 31%, the serial candidate scan and root chain (C3) 10%.
//
// The design:
//   - one cluster of C blocks (C = min(n_e, 16)); block r owns the incomes
//     e = r (mod C) and runs every stage for them: after stage A the income
//     states are independent until the next period's A;
//   - each block keeps the access-mixed continuations of its incomes, vm =
//     fma(1 - lam, V_0, lam * V_1) and its tangent, one float4 a state
//     (computed by the owner in D with the previous kernel's rounding, read
//     from its SASS); stage A reads every income's through distributed
//     shared memory and sums them in income order, as before;
//   - split cluster barriers: arrive (relaxed: A's remote reads are done)
//     after A and wait before B2 (nobody reads the vm region after that, so
//     B2 keeps the no-access consumption and illiquid margin there for D);
//     arrive after D and wait before the next A. Only the policies go to
//     global memory: as (access 0, access 1) float2 pairs after the arrive
//     where B2 takes one pass, else where they are computed;
//   - the candidates' brackets of C2 depend on the static grids alone: they
//     are tabled once a launch (where the room is), and the brackets of
//     a_next(a) once a period; C2's bilinear value then has the previous
//     kernel's roundings spelled out (gap_value), which nvcc otherwise
//     chose differently beside the table;
//   - the two branches overlap: C1 runs on the threads B1 leaves idle, and
//     the root chain of C3 (one thread a row, latency-bound) on two warps
//     while the others run B2. B2 recomputes the no-access W_a at a_next(a)
//     (B1's expression) where it needs it instead of keeping it;
//   - C2 and C3's scan fused: one warp per (s, e) row, each lane a
//     contiguous run of candidates; fmaxf/fminf in a butterfly that keeps
//     lane order and ballots for has_neg / has_pos give the serial scan's
//     values (fmaxf/fminf order -0 below +0 and drop a NaN operand, so any
//     order would);
//   - C4 and D fused per state; every other state's arithmetic is the
//     previous kernel's, expression for expression.
// What bounds it now (stamped, 40x20x5x2, ~41k cycles a period on each
// block): the root chain's latency on its two warps (~10k), the strided
// policy stores (each block writes 8 bytes of every 40, ~8k), C2 (~6k),
// C4 and D (~6k). Shared memory per block (floats, n = G * NB * NA states
// and R = G * NB rows of the G incomes a block holds room for): vm 4n, W
// 4n, the EGM's knots 2n, the rows' 12R, the period's brackets 3 NA, the
// grids, two periods' prices (16), and the table (4 K NB) where it fits:
// every grid the previous kernel takes fits.
constexpr int kB5Threads = 1024;
constexpr int kB5Warps = kB5Threads / 32;

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
// For an arrive whose block has nothing to publish.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Shared memory of a block, with or without the table of the breakpoint
// candidates' brackets (K * NB entries of 16 bytes).
size_t bwd_cluster_smem(int NB, int NA, int NE, int C, bool tabled) {
    const size_t G = (NE + C - 1) / C, n = G * NB * NA, R = G * NB, K = NA + NB + 2;
    return sizeof(float) * (10 * n + 12 * R + 3 * (size_t)NA + 2 * (size_t)NB + NA + NE
                            + (size_t)NE * NE + 16 + (tabled ? 4 * K * NB : 0));
}

// Whether the candidates' brackets are tabled (where the room is), and the
// bytes a block uses.
bool bwd_cluster_tabled(int NB, int NA, int NE, int C) {
    return bwd_cluster_smem(NB, NA, NE, C, true) <= kSmemOptin;
}

size_t bwd_cluster_smem_bytes(int NB, int NA, int NE, int C) {
    return bwd_cluster_smem(NB, NA, NE, C, bwd_cluster_tabled(NB, NA, NE, C));
}

// The FOC gap's bilinear value (bilinear()'s v of the surface Wb - Wa, one
// income: NE = 1) at the brackets (ib, tb), (ia, ta), with the previous
// kernel's roundings in C2 spelled out (read from its SASS): the corner
// weights as products, the first term a product, the others FMAs in order.
__device__ __forceinline__ float gap_value(const float* W, int N3, int NA, int ib, int ia,
                                           float tb, float ta) {
    const int k00 = (ib - 1) * NA + ia - 1, k01 = k00 + 1, k10 = k00 + NA, k11 = k10 + 1;
    const float ub = 1.f - tb, ua = 1.f - ta;
    float v = __fmul_rn(__fmul_rn(ub, ua), W[k00] - W[N3 + k00]);
    v = __fmaf_rn(__fmul_rn(ub, ta), W[k01] - W[N3 + k01], v);
    v = __fmaf_rn(__fmul_rn(tb, ua), W[k10] - W[N3 + k10], v);
    return __fmaf_rn(__fmul_rn(tb, ta), W[k11] - W[N3 + k11], v);
}

// bracket() from a count already taken (bracket2), the same arithmetic.
__device__ __forceinline__ Bracket bracket_at(const float* g, int n, int cnt, float q, float dq) {
    Bracket B;
    B.i = min(max(cnt, 1), n - 1);
    B.lo = g[B.i - 1];
    B.hi = g[B.i];
    const float raw = (q - B.lo) / (B.hi - B.lo);
    B.t = clip_f(raw, 0.f, 1.f);
    B.dt = clip_d(raw, 0.f, 1.f) * (dq / (B.hi - B.lo));
    B.in = q > g[0] && q < g[n - 1];
    return B;
}

// The brackets of a query pair on the liquid and illiquid grids: both
// count_below_sorted() bisections, step for step, interleaved (the same
// counts on any grid, in max rather than sum of their steps).
__device__ __forceinline__ void bracket2(const float* gb, int nb, float qb, float dqb,
                                         const float* ga, int na, float qa, float dqa,
                                         Bracket& B, Bracket& A) {
    int lb = 0, hb = nb, la = 0, ha = na;
    while (lb < hb || la < ha) {
        if (lb < hb) {
            const int m = (lb + hb) >> 1;
            if (gb[m] < qb) lb = m + 1; else hb = m;
        }
        if (la < ha) {
            const int m = (la + ha) >> 1;
            if (ga[m] < qa) la = m + 1; else ha = m;
        }
    }
    B = bracket_at(gb, nb, lb, qb, dqb);
    A = bracket_at(ga, na, la, qa, dqa);
}

// The access mix of the previous kernel's stage A, with its rounding:
// (1 - lam) * x0 + lam * x1 as fma(1 - lam, x0, x1 * lam).
__device__ __forceinline__ float access_mix(float one_lam, float lam, float x0, float x1) {
    return __fmaf_rn(one_lam, x0, __fmul_rn(x1, lam));
}

// An L2 prefetch of the line holding *p (no register waits for it).
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The path of a batched launch (blockIdx.y) times `per_path` elements; 0
// without BATCHED, which compiles it out. blockIdx.y is read anew at every
// use (a volatile read the compiler cannot hoist), so no path offset stays
// live in registers across the periods: the cluster kernels take every
// register ptxas gives a thread at their block size.
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

// Outputs as two_asset_bwd_kernel's; `tabled` as bwd_cluster_tabled(). Stamp
// slots (per block, 32 apart): [0] the wait before A, [1] A, [2] B1 and C1,
// [3] C2 and the scan, [4] the wait before B2, [5] B2 and the root chain,
// [6] thread 0's share of B2, [7] C4 and D, [8] from D to the next wait,
// [9] the sweep.
// BATCHED: a grid of (C, B) blocks, one cluster per path b = blockIdx.y, which
// reads row b of each (B, Tm1) price and tangent path and writes its own
// (6, Tm1, N4) slice of out (B, 6, Tm1, N4); V_T, the grids and Pi are
// shared. Without it (the single-path entry point) the offset compiles out.
template <bool BATCHED>
__global__ void __launch_bounds__(kB5Threads, 1) two_asset_bwd_cluster_kernel(
    const float* __restrict__ r_p, const float* __restrict__ ra_p,
    const float* __restrict__ w_p, const float* __restrict__ tau_p,
    const float* __restrict__ dr_p, const float* __restrict__ dra_p,
    const float* __restrict__ dw_p, const float* __restrict__ dtau_p,
    const float* __restrict__ V_T,
    const float* __restrict__ bgrid_g, const float* __restrict__ agrid_g,
    const float* __restrict__ egrid_g, const float* __restrict__ Pi_g,
    float* __restrict__ out,
    int Tm1, int NB, int NA, int NE, float beta, float lam, float chi, float borrow,
    int tabled K5_STAMPS_PARAM)
{
    extern __shared__ __align__(16) float sm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    K5_STAMPS(kStampSlots * rank);
    st.from(9);
    const int NBA = NB * NA, NS = NB, K = NA + NB + 2;
    const int G = (NE + C - 1) / C;               // room for this many incomes
    const int own = (NE - rank + C - 1) / C;      // incomes rank, rank + C, ...
    const int n = G * NBA, R = G * NS, my_n = own * NBA, my_rows = own * NS;
    const int N4 = 2 * NBA * NE;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t TN = (size_t)Tm1 * N4;
    const float one_lam = 1.f - lam;
    // The root chain's threads (whole warps) beside B2's. Where B2 takes one
    // pass, thread j keeps state j's no-access policies in registers and
    // puts them beside the access branch's, a float2 a pair.
    const int Tc = min(32 * ((my_rows + 31) / 32), kB5Threads / 2), Tb = kB5Threads - Tc;
    const bool pair = my_n <= Tb;

    float4* vm = reinterpret_cast<float4*>(sm);   // (vm_b, vm_a, dvm_b, dvm_a) a state;
                                                  // (c, dc, margin, dmargin) in B2..D
    // The brackets of the breakpoint candidates (period-free: the static
    // grids alone place them), row s's K in a run: (t_b, t_a, i_b | i_a << 16, c).
    float4* tab = reinterpret_cast<float4*>(sm + 4 * n);
    float* W = sm + 4 * n + (tabled ? 4 * K * NS : 0);   // [Wb, Wa, dWb, dWa][n]
    float* imp = W + 4 * n;           // implied liquid wealth (the EGM's knots), B1 -> B2
    float* dimp = imp + n;
    float* pen = dimp + n;            // per row q = gi * NS + s
    float* dpen = pen + R;
    float* ast = dpen + R;
    float* dast = ast + R;
    float* wkn = dast + R;
    float* dwkn = wkn + R;
    float* scan = dwkn + R;           // [lo, hi, g0, g1, g_lo, g_hi][R]
    int* aq_i = reinterpret_cast<int*>(scan + 6 * R);   // the period's bracket of
    float* aq_t = reinterpret_cast<float*>(aq_i + NA);  // a_next(a) on the
    float* aq_dt = aq_t + NA;                           // illiquid grid
    float* bg = aq_dt + NA;
    float* ag = bg + NB;
    float* sg = ag + NA;              // s grid of the access EGM
    float* eg = sg + NB;
    float* Pi = eg + NE;
    float* pc = Pi + NE * NE;         // the prices and tangents of a period, two periods
    // Threads 0-7 load period t's (r, ra, w, tau, dr, dra, dw, dtau) into
    // pc[8 * (t & 1)], a period ahead.
    const float* const prices[8] = {r_p, ra_p, w_p, tau_p, dr_p, dra_p, dw_p, dtau_p};

    for (int i = tid; i < NB; i += kB5Threads) bg[i] = bgrid_g[i];
    for (int i = tid; i < NA; i += kB5Threads) ag[i] = agrid_g[i];
    for (int i = tid; i < NE; i += kB5Threads) eg[i] = egrid_g[i];
    for (int i = tid; i < NE * NE; i += kB5Threads) Pi[i] = Pi_g[i];
    if (tid < 8)
        pc[8 * ((Tm1 - 1) & 1) + tid] = (prices[tid] + path_offset<BATCHED>(Tm1))[Tm1 - 1];
    // The access mix of V_T (no tangent) for the own incomes.
    for (int j = tid; j < my_n; j += kB5Threads) {
        const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
        const int k = (ba * NE + e) * 2;
        vm[j] = make_float4(access_mix(one_lam, lam, V_T[k], V_T[k + 1]),
                            access_mix(one_lam, lam, V_T[N4 + k], V_T[N4 + k + 1]),
                            access_mix(one_lam, lam, 0.f, 0.f),
                            access_mix(one_lam, lam, 0.f, 0.f));
    }
    __syncthreads();
    const float btop = bg[NB - 1], atop = ag[NA - 1];
    const float ratio = (btop + atop) / btop;
    for (int i = tid; i < NB; i += kB5Threads) sg[i] = bg[i] * ratio;
    if (tabled) {
        __syncthreads();
        for (int u = tid; u < NS * K; u += kB5Threads) {
            const int s = u / K, k = u - s * K;
            const float s2 = sg[s];
            float c = k == 0 ? 0.f : (k <= NA ? ag[k - 1] : (k <= NA + NB ? s2 - bg[k - NA - 1] : s2));
            c = clip_f(c, 0.f, s2);
            Bracket Bq, Aq;
            bracket2(bg, NB, s2 - c, 0.f, ag, NA, c, 0.f, Bq, Aq);
            tab[u] = make_float4(Bq.t, Aq.t, __int_as_float(Bq.i | (Aq.i << 16)), c);
        }
    }
    cluster_arrive();

    st.from(8);
    for (int t = Tm1 - 1; t >= 0; --t) {
        const float* pt = pc + 8 * (t & 1);
        const float r = pt[0], ra = pt[1], w = pt[2], tau = pt[3];
        const float dr = pt[4], dra = pt[5], dw = pt[6], dtau = pt[7];
        if (t > 0 && tid < 8)
            pc[8 * ((t - 1) & 1) + tid] = (prices[tid] + path_offset<BATCHED>(Tm1))[t - 1];
        const float one_r = 1.f + r, one_ra = 1.f + ra;
        const float pre = (1.f - tau) * w;
        const float dpre = -dtau * w + (1.f - tau) * dw;
        const float ymax = floor_f(pre, 1e-9f);
        const float dymax = floor_d(pre, 1e-9f) * dpre;
        // B, A, C, dB, dA, dC rows of t
        float* Bo = out + path_offset<BATCHED>(6 * TN) + (size_t)t * N4;

        // Every income's vm of period t + 1 is with its owner.
        st.to(8);
        st.from(0);
        cluster_wait();
        st.to(0);
        st.from(1);
        // A. Continuations: income expectation of the access mixes, floor.
        for (int j = tid; j < my_n; j += kB5Threads) {
            const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
            float E[2] = {0.f, 0.f}, dE[2] = {0.f, 0.f};
            for (int f = 0; f < NE; ++f) {
                const float4 v = cluster.map_shared_rank(vm, f % C)[(f / C) * NBA + ba];
                const float p = Pi[e * NE + f];
                E[0] += v.x * p;
                dE[0] += v.z * p;
                E[1] += v.y * p;
                dE[1] += v.w * p;
            }
            for (int s = 0; s < 2; ++s) {
                const float x = beta * E[s];
                W[s * n + j] = floor_f(x, 1e-12f);
                W[(2 + s) * n + j] = floor_d(x, 1e-12f) * (beta * dE[s]);
            }
        }
        // The period's brackets of a_next(a), on threads past the states.
        for (int a = tid - my_n; a < NA; a += kB5Threads) {
            if (a < 0) continue;
            const float a_raw = one_ra * ag[a];
            const float da_raw = dra * ag[a];
            float a_next, da_next;
            min2(a_raw, da_raw, atop, 0.f, a_next, da_next);
            const Bracket Q = bracket(ag, NA, a_next, da_next);
            aq_i[a] = Q.i;
            aq_t[a] = Q.t;
            aq_dt[a] = Q.dt;
        }
        // A's remote reads are done (their values are in W): nothing to order.
        cluster_arrive_relaxed();
        __syncthreads();
        st.to(1);
        st.from(2);

        // B1. No access: W_b at the capped accrual point a_next(a), the
        //     implied liquid wealth of the EGM. C1, on the threads past the
        //     states: the penalty scale of the portfolio split per row.
        const float s1 = sg[1];
        for (int j = tid; j < my_n + my_rows; j += kB5Threads) {
            if (j < my_n) {
                const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
                const int b = ba / NA, a = ba - b * NA;
                const float a_raw = one_ra * ag[a];
                const float da_raw = dra * ag[a];
                float a_next, da_next;
                min2(a_raw, da_raw, atop, 0.f, a_next, da_next);
                const float Qt = aq_t[a], Qdt = aq_dt[a];
                const int klo = gi * NBA + b * NA + aq_i[a] - 1, khi = klo + 1;
                const float lo = W[klo], hi = W[khi];
                const float dlo = W[2 * n + klo], dhi = W[2 * n + khi];
                const float wn0 = lo + Qt * (hi - lo);
                const float dwn0 = dlo + Qdt * (hi - lo) + Qt * (dhi - dlo);
                float c, dc;
                inv_marg2(wn0, dwn0, c, dc);
                const float inc = (a_raw - a_next) + ymax * eg[e];
                const float dinc = (da_raw - da_next) + dymax * eg[e];
                const float num = c + bg[b] - inc;
                const float imp_ = num / one_r;
                imp[j] = imp_;
                dimp[j] = ((dc - dinc) - imp_ * dr) / one_r;
            } else {
                const int q = j - my_n;
                if (chi > 0.f) {
                    const int gi = q / NS, s = q - gi * NS;
                    const float mid = 0.5f * sg[s];
                    Bracket Bq, Aq;
                    bracket2(bg, NB, mid, 0.f, ag, NA, mid, 0.f, Bq, Aq);
                    const Bi m = bilinear(W + gi * NBA, n, NA, 1, 0, 3, Bq, Aq);
                    const float den = sg[s] > s1 ? sg[s] : s1;
                    pen[q] = chi * m.v / den;
                    dpen[q] = chi * m.dv / den;
                } else {
                    pen[q] = 0.f;
                    dpen[q] = 0.f;
                }
            }
        }
        __syncthreads();
        st.to(2);
        st.from(3);

        // C2 and the scan of C3, one warp per row: the FOC gap at each
        //     breakpoint candidate (primal only: the root is detached), lane
        //     l taking candidates [l * per, (l + 1) * per); then the bracket
        //     of sign changes, combined in lane order.
        const int per = (K + 31) / 32;
        for (int q = warp; q < my_rows; q += kB5Warps) {
            const int gi = q / NS, s = q - gi * NS;
            const float* Wg = W + gi * NBA;
            const float s2 = sg[s];
            const float p = pen[q];
            float lo = -FLT_MAX, hi = FLT_MAX, g0 = -FLT_MAX, g1 = FLT_MAX;
            bool has_neg = false, has_pos = false;
            float g_first = 0.f, g_last = 0.f;
            for (int k = lane * per; k < min(K, (lane + 1) * per); ++k) {
                float c = k == 0 ? 0.f : (k <= NA ? ag[k - 1] : (k <= NA + NB ? s2 - bg[k - NA - 1] : s2));
                c = clip_f(c, 0.f, s2);
                float v;
                if (tabled) {
                    const float4 e = tab[s * K + k];
                    const int ii = __float_as_int(e.z);
                    v = gap_value(Wg, n, NA, ii & 0xffff, ii >> 16, e.x, e.y);
                } else {
                    Bracket Bq, Aq;
                    bracket2(bg, NB, s2 - c, 0.f, ag, NA, c, 0.f, Bq, Aq);
                    v = gap_value(Wg, n, NA, Bq.i, Aq.i, Bq.t, Aq.t);
                }
                const float g = chi > 0.f ? __fmaf_rn(p, __fmaf_rn(s2, -0.5f, c), v) : v;
                if (k == 0) g_first = g;
                if (k == K - 1) g_last = g;
                if (g < 0.f) {
                    has_neg = true;
                    lo = fmaxf(lo, c);
                    g0 = fmaxf(g0, g);
                } else {
                    has_pos = true;
                    hi = fminf(hi, c);
                    g1 = fminf(g1, g);
                }
            }
            for (int o = 1; o < 32; o <<= 1) {
                const bool upper = (lane & o) != 0;     // this lane's run follows the other's
                const float olo = __shfl_xor_sync(0xffffffffu, lo, o);
                const float ohi = __shfl_xor_sync(0xffffffffu, hi, o);
                const float og0 = __shfl_xor_sync(0xffffffffu, g0, o);
                const float og1 = __shfl_xor_sync(0xffffffffu, g1, o);
                lo = upper ? fmaxf(olo, lo) : fmaxf(lo, olo);
                hi = upper ? fminf(ohi, hi) : fminf(hi, ohi);
                g0 = upper ? fmaxf(og0, g0) : fmaxf(g0, og0);
                g1 = upper ? fminf(og1, g1) : fminf(g1, og1);
            }
            has_neg = __any_sync(0xffffffffu, has_neg);
            has_pos = __any_sync(0xffffffffu, has_pos);
            g_first = __shfl_sync(0xffffffffu, g_first, 0);
            g_last = __shfl_sync(0xffffffffu, g_last, (K - 1) / per);
            if (lane == 0) {
                if (!has_neg) { lo = 0.f; g0 = -1.f; }
                if (!has_pos) { hi = s2; g1 = 1.f; }
                scan[q] = lo;
                scan[R + q] = hi;
                scan[2 * R + q] = g0;
                scan[3 * R + q] = g1;
                scan[4 * R + q] = g_first;
                scan[5 * R + q] = g_last;
            }
        }
        __syncthreads();
        st.to(3);
        // Every block has read the vm regions: this block's is scratch till D.
        st.from(4);
        cluster_wait();
        st.to(4);
        st.from(5);

        float pol0[6];                    // B2's policies where they are paired
        if (tid < Tb) {
            st.from(6);
            // B2. Liquid policy on the grid (traced knots: count bracket),
            //     clips, consumption, and the illiquid margin at (b', a_next).
            for (int j = tid; j < my_n; j += Tb) {
                const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
                const int b = ba / NA, a = ba - b * NA;
                const int i = ba * NE + e;
                const int col = gi * NBA + a;               // knots imp[col + k*NA]
                const float x = bg[b];
                int cnt = 0;
                for (int k = 0; k < NB; ++k) cnt += imp[col + k * NA] < x ? 1 : 0;
                const int jj = min(max(cnt, 1), NB - 1);
                const float lo = imp[col + (jj - 1) * NA];
                const float hi = imp[col + jj * NA];
                const float dlo = dimp[col + (jj - 1) * NA];
                const float dhi = dimp[col + jj * NA];
                const float den = hi - lo;
                const float safe = den > 0.f ? den : 1.f;
                const float dsafe = den > 0.f ? dhi - dlo : 0.f;
                const float raw = (x - lo) / safe;
                const float draw = (-dlo - raw * dsafe) / safe;
                const float tt = clip_f(raw, 0.f, 1.f);
                const float dtt = clip_d(raw, 0.f, 1.f) * draw;
                const float vlo = bg[jj - 1], vhi = bg[jj];
                float pol = vlo + tt * (vhi - vlo);
                float dpol = dtt * (vhi - vlo);
                const float f1 = floor_f(pol, borrow);
                const float df1 = floor_d(pol, borrow) * dpol;
                min2(f1, df1, btop, 0.f, pol, dpol);

                const float a_raw = one_ra * ag[a];
                const float da_raw = dra * ag[a];
                float a_next, da_next;
                min2(a_raw, da_raw, atop, 0.f, a_next, da_next);
                const float inc = (a_raw - a_next) + ymax * eg[e];
                const float dinc = (da_raw - da_next) + dymax * eg[e];
                const float craw = one_r * x + inc - pol;
                const float dcraw = dr * x + dinc - dpol;
                const float c = floor_f(craw, 1e-12f);
                const float dc = floor_d(craw, 1e-12f) * dcraw;
                const float o[6] = {pol, a_next, c, dpol, da_next, dc};
                for (int q = 0; q < 6; ++q) {
                    if (pair) pol0[q] = o[q];
                    else Bo[q * TN + 2 * i] = o[q];
                }

                // W_a(b', a_next) along b (static grid, traced query), from W_a
                // at a_next on the two knots b' and b' + 1 (B1's expression).
                const Bracket Q = bracket(bg, NB, pol, dpol);
                const float Qat = aq_t[a], Qadt = aq_dt[a];
                float wn[2], dwn[2];
                for (int h = 0; h < 2; ++h) {
                    const int klo = gi * NBA + (Q.i - 1 + h) * NA + aq_i[a] - 1, khi = klo + 1;
                    const float lo1 = W[n + klo], hi1 = W[n + khi];
                    const float dlo1 = W[3 * n + klo], dhi1 = W[3 * n + khi];
                    wn[h] = lo1 + Qat * (hi1 - lo1);
                    dwn[h] = dlo1 + Qadt * (hi1 - lo1) + Qat * (dhi1 - dlo1);
                }
                const float wlo = wn[0], whi = wn[1];
                const float dwlo = dwn[0], dwhi = dwn[1];
                const bool capped = a_raw >= atop;
                vm[j] = make_float4(
                    c, dc, capped ? 0.f : wlo + Q.t * (whi - wlo),
                    capped ? 0.f : dwlo + Q.dt * (whi - wlo) + Q.t * (dwhi - dwlo));
            }
            st.to(6);
        } else {
            // C3. Quadratic root, implicit-function step, envelope surfaces
            //     at the split, endogenous cash-on-hand knots; per row.
            for (int q = tid - Tb; q < my_rows; q += Tc) {
                const int gi = q / NS, s = q - gi * NS;
                const float* Wg = W + gi * NBA;
                const float s2 = sg[s];
                const float lo = scan[q], hi = scan[R + q];
                const float g0 = scan[2 * R + q], g1 = scan[3 * R + q];
                const float g_lo = scan[4 * R + q], g_hi = scan[5 * R + q];
                const float h = hi - lo;
                const float p = pen[q], dp = dpen[q];
                float gm;
                {
                    const float am = 0.5f * (lo + hi);
                    Bracket Bm, Am;
                    bracket2(bg, NB, s2 - am, 0.f, ag, NA, am, 0.f, Bm, Am);
                    const Bi g = bilinear(Wg, n, NA, 1, 0, 2, Bm, Am);
                    gm = chi > 0.f ? g.v + p * (am - 0.5f * s2) : g.v;
                }
                const float a1c = -3.f * g0 + 4.f * gm - g1;
                const float a2c = 2.f * g0 - 4.f * gm + 2.f * g1;
                const float disc = floor_f(a1c * a1c - 4.f * a2c * g0, 0.f);
                const float sgn = a1c >= 0.f ? 1.f : -1.f;
                const float qq = -0.5f * (a1c + sgn * sqrtf(disc));
                const float u_a = g0 / (fabsf(qq) > 0.f ? qq : 1.f);
                const float u_b = qq / (fabsf(a2c) > 0.f ? a2c : 1.f);
                const bool in01 = u_a >= 0.f && u_a <= 1.f && fabsf(qq) > 0.f;
                const float u = clip_f(in01 ? u_a : u_b, 0.f, 1.f);
                const float a_it = h > 0.f ? lo + u * h : lo;

                // One Newton step at the detached root, slope held constant.
                Bracket Bn, An;
                bracket2(bg, NB, s2 - a_it, 0.f, ag, NA, a_it, 0.f, Bn, An);
                const Bi g = bilinear(Wg, n, NA, 1, 0, 2, Bn, An);
                float g_at = g.v, dg_at = g.dv, gp = g.sa - g.sb;
                if (chi > 0.f) {
                    g_at = g_at + p * (a_it - 0.5f * s2);
                    dg_at = dg_at + dp * (a_it - 0.5f * s2);
                    gp = gp + p;
                }
                const float g_a = floor_f(gp, 1e-10f);
                const float araw = a_it - g_at / g_a;
                const float daraw = -(dg_at / g_a);
                float a_star = clip_f(araw, 0.f, s2);
                float da_star = clip_d(araw, 0.f, s2) * daraw;
                if (g_lo >= 0.f) { a_star = 0.f; da_star = 0.f; }
                else if (g_hi <= 0.f) { a_star = s2; da_star = 0.f; }
                const float b_star = s2 - a_star, db_star = -da_star;

                Bracket Bq, Aq;
                bracket2(bg, NB, b_star, db_star, ag, NA, a_star, da_star, Bq, Aq);
                const Bi vb = bilinear(Wg, n, NA, 1, 0, 0, Bq, Aq);
                const Bi va = bilinear(Wg, n, NA, 1, 0, 1, Bq, Aq);
                const float wbp = vb.sa - vb.sb, dwbp = vb.dsa - vb.dsb;
                const float wap = va.sa - va.sb, dwap = va.dsa - va.dsb;
                const float gps = wbp - wap, dgps = dwbp - dwap;
                const bool ok = a_star > 0.f && a_star < s2 && wbp >= 0.f && wap <= 0.f
                                && gps > 1e-10f;
                float Ws, dWs;
                if (ok) {
                    const float num = wbp * va.v - wap * vb.v;
                    const float dnum = dwbp * va.v + wbp * va.dv - (dwap * vb.v + wap * vb.dv);
                    Ws = num / gps;
                    dWs = (dnum - Ws * dgps) / gps;
                } else {
                    max2(vb.v, vb.dv, va.v, va.dv, Ws, dWs);
                }
                float c, dc;
                inv_marg2(Ws, dWs, c, dc);
                ast[q] = a_star;
                dast[q] = da_star;
                wkn[q] = c + s2;
                dwkn[q] = dc;
            }
        }
        __syncthreads();
        st.to(5);
        st.from(7);

        // C4. Access branch on the grid: savings through the endogenous
        //     cash-on-hand knots, split at s*, clips, consumption. D. The
        //     envelopes of both branches, and their access mix for A.
        float pol1[6];
        for (int j = tid; j < my_n; j += kB5Threads) {
            const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
            const int b = ba / NA, a = ba - b * NA;
            const int i = ba * NE + e;
            const float* wk = wkn + gi * NS;
            const float* dwk = dwkn + gi * NS;
            const float ye = ymax * eg[e], dye = dymax * eg[e];
            const float coh = one_r * bg[b] + one_ra * ag[a] + ye;
            const float dcoh = dr * bg[b] + dra * ag[a] + dye;
            int cnt = 0;
            for (int k = 0; k < NS; ++k) cnt += wk[k] < coh ? 1 : 0;
            const int jj = min(max(cnt, 1), NS - 1);
            const float lo = wk[jj - 1], hi = wk[jj];
            const float dlo = dwk[jj - 1], dhi = dwk[jj];
            const float den = hi - lo;
            const float safe = den > 0.f ? den : 1.f;
            const float dsafe = den > 0.f ? dhi - dlo : 0.f;
            const float raw = (coh - lo) / safe;
            const float draw = (dcoh - dlo - raw * dsafe) / safe;
            const float tt = clip_f(raw, 0.f, 1.f);
            const float dtt = clip_d(raw, 0.f, 1.f) * draw;
            const float ps0 = sg[jj - 1] + tt * (sg[jj] - sg[jj - 1]);
            const float dps0 = dtt * (sg[jj] - sg[jj - 1]);
            const float ps = floor_f(ps0, 0.f);
            const float dps = floor_d(ps0, 0.f) * dps0;

            // a' = interp(s-knots ↦ a*) at the savings policy.
            const Bracket Q = bracket(sg, NS, ps, dps);
            const float* as = ast + gi * NS;
            const float* das = dast + gi * NS;
            const float alo = as[Q.i - 1], ahi = as[Q.i];
            const float dalo = das[Q.i - 1], dahi = das[Q.i];
            const float pa0 = alo + Q.t * (ahi - alo);
            const float dpa0 = dalo + Q.dt * (ahi - alo) + Q.t * (dahi - dalo);
            float cap, dcap, pa, dpa;
            min2(ps, dps, atop, 0.f, cap, dcap);
            min2(floor_f(pa0, 0.f), floor_d(pa0, 0.f) * dpa0, cap, dcap, pa, dpa);
            const float pb0 = ps - pa, dpb0 = dps - dpa;
            float pb, dpb;
            min2(floor_f(pb0, borrow), floor_d(pb0, borrow) * dpb0, btop, 0.f, pb, dpb);
            const float craw = coh - pb - pa;
            const float dcraw = dcoh - dpb - dpa;
            const float c1 = floor_f(craw, 1e-12f);
            const float dc1 = floor_d(craw, 1e-12f) * dcraw;
            const float o[6] = {pb, pa, c1, dpb, dpa, dc1};
            for (int q = 0; q < 6; ++q) {
                if (pair) pol1[q] = o[q];
                else Bo[q * TN + 2 * i + 1] = o[q];
            }

            // D. (V_b, V_a) and tangents of both branches, then their mix.
            const float4 b2 = vm[j];                  // (c, dc, margin, dmargin) of access 0
            float Vb[2], Va[2], dVb[2], dVa[2];
            for (int acc = 0; acc < 2; ++acc) {
                const float c = acc == 0 ? b2.x : c1;
                const float dc = acc == 0 ? b2.y : dc1;
                const float cc = c * c;
                const float up = 1.f / cc;
                const float dup = -(dc * c + c * dc) * up * up;
                Vb[acc] = one_r * up;
                dVb[acc] = dr * up + one_r * dup;
                if (acc == 0) {
                    Va[acc] = one_ra * b2.z;
                    dVa[acc] = dra * b2.z + one_ra * b2.w;
                } else {
                    Va[acc] = one_ra * up;
                    dVa[acc] = dra * up + one_ra * dup;
                }
            }
            vm[j] = make_float4(access_mix(one_lam, lam, Vb[0], Vb[1]),
                                access_mix(one_lam, lam, Va[0], Va[1]),
                                access_mix(one_lam, lam, dVb[0], dVb[1]),
                                access_mix(one_lam, lam, dVa[0], dVa[1]));
        }
        st.to(7);
        st.from(8);
        cluster_arrive();
        // The paired policies go out after the arrive, so that its fence does
        // not wait for them.
        if (pair && tid < my_n) {
            const int gi = tid / NBA, ba = tid - gi * NBA, i = ba * NE + rank + gi * C;
            for (int q = 0; q < 6; ++q)
                reinterpret_cast<float2*>(Bo + q * TN)[i] = make_float2(pol0[q], pol1[q]);
        }
    }
    // No block leaves while another may still read its shared memory.
    cluster_wait();
    st.to(9);
    st.save();
}

// ── Kernel 6: the forward dual push ───────────────────────────────────────
constexpr int kFwdWarps = kFwdThreads / 32;

// Young lottery weights of a dual policy on a static sorted grid
// (ops/transition.lottery_weights): bracket jc in [1, n-1], mass 1 - w to
// jc - 1 and w to jc, w clipped to [0, 1] with torch's tie rule.
__device__ __forceinline__ int lottery_bracket(const float* g, int n, float p) {
    return min(max(count_below_sorted(g, n, p), 1), n - 1);
}
__device__ __forceinline__ void lottery_weights(const float* g, int jc, float p, float dp,
                                                float& w, float& dw) {
    const float h = g[jc] - g[jc - 1];
    const float raw = (p - g[jc - 1]) / h;
    w = clip_f(raw, 0.f, 1.f);
    dw = clip_d(raw, 0.f, 1.f) * (dp / h);
}
__device__ __forceinline__ void lottery(const float* g, int n, float p, float dp,
                                        int& jc, float& w, float& dw) {
    jc = lottery_bracket(g, n, p);
    lottery_weights(g, jc, p, dp, w, dw);
}

size_t fwd_smem_bytes(int NB, int NA, int NE) {
    const size_t NS = (size_t)NB * NA, N4 = NS * NE * 2;
    return sizeof(float) * (4 * N4 + 6 * NS + NB + NA + (size_t)NE * NE + 4
                            + 6 * kFwdWarps)
           + sizeof(int) * 2 * NS + sizeof(unsigned short) * kFwdWarps * NS;
}

// One period per step: for each (income e, access acc) group the joint
// lottery D_half[j, m] = sum_s wb_j(s) D[s] wa_m(s) over the group's sources
// s = (b, a); then income and access mixing, as ops/transition.exog_apply
// applies them (income axis first), and the aggregates against the mixed D.
// Output out[q * Tm1 + t], q = B, A, C, dB, dA, dC. Stamp slots: [0] L,
// [1] R, [2] M, [3] the warp-0 tree, [4] warp 0 building its lists, [5]
// warp 0 walking them, [6] the whole sweep, [7 + g] R of group g < 16.
__global__ void __launch_bounds__(kFwdThreads) two_asset_fwd_kernel(
    const float* __restrict__ pB, const float* __restrict__ pA,
    const float* __restrict__ pC, const float* __restrict__ dB,
    const float* __restrict__ dA, const float* __restrict__ dC,
    const float* __restrict__ D0,
    const float* __restrict__ bgrid_g, const float* __restrict__ agrid_g,
    const float* __restrict__ Pi_g, const float* __restrict__ Pacc_g,
    float* __restrict__ out, int Tm1, int NB, int NA, int NE K6_STAMPS_PARAM)
{
    extern __shared__ __align__(16) float sm[];
    K6_STAMPS(0);
    st.from(6);
    const int NS = NB * NA, N4 = NS * NE * 2;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    float* D = sm;                    // distribution and tangent, (b, a, e, acc)
    float* dD = D + N4;
    float* H = dD + N4;               // post-lottery distribution and tangent
    float* dH = H + N4;
    float* wb = dH + N4;              // per source of the current group
    float* dwb = wb + NS;
    float* wa = dwb + NS;
    float* dwa = wa + NS;
    float* src = dwa + NS;
    float* dsrc = src + NS;
    float* bg = dsrc + NS;
    float* ag = bg + NB;
    float* Pi = ag + NA;
    float* Pacc = Pi + NE * NE;
    float* red = Pacc + 4;            // (6, kFwdWarps) warp partial sums
    int* jb = reinterpret_cast<int*>(red + 6 * kFwdWarps);
    int* ja = jb + NS;
    unsigned short* lists = reinterpret_cast<unsigned short*>(ja + NS);
    unsigned short* list = lists + (size_t)warp * NS;

    for (int i = tid; i < NB; i += kFwdThreads) bg[i] = bgrid_g[i];
    for (int i = tid; i < NA; i += kFwdThreads) ag[i] = agrid_g[i];
    for (int i = tid; i < NE * NE; i += kFwdThreads) Pi[i] = Pi_g[i];
    if (tid < 4) Pacc[tid] = Pacc_g[tid];
    for (int i = tid; i < N4; i += kFwdThreads) {
        D[i] = D0[i];
        dD[i] = 0.f;
    }
    __syncthreads();

    for (int t = 0; t < Tm1; ++t) {
        const size_t off = (size_t)t * N4;
        for (int grp = 0; grp < 2 * NE; ++grp) {
            const int e = grp >> 1, acc = grp & 1;
            st.from(0);
            // L. Lottery brackets and weights of the group's sources.
            for (int s = tid; s < NS; s += kFwdThreads) {
                const int k = (s * NE + e) * 2 + acc;
                lottery(bg, NB, pB[off + k], dB[off + k], jb[s], wb[s], dwb[s]);
                lottery(ag, NA, pA[off + k], dA[off + k], ja[s], wa[s], dwa[s]);
                src[s] = D[k];
                dsrc[s] = dD[k];
            }
            __syncthreads();
            st.to(0);
            st.from(1);
            if (grp < 16) st.from(7 + grp);
            // R. One warp per destination row j: the sources touching row j,
            //    in source order (warp ballots), then one lane per column m
            //    sums them in that order.
            for (int j = warp; j < NB; j += kFwdWarps) {
                st.from(4);
                int n = 0;
                for (int c = 0; c < NS; c += 32) {
                    const int s = c + lane;
                    const bool hit = s < NS && (jb[s] == j || jb[s] - 1 == j);
                    const unsigned mask = __ballot_sync(0xffffffffu, hit);
                    if (hit) list[n + __popc(mask & ((1u << lane) - 1u))] = (unsigned short)s;
                    n += __popc(mask);
                }
                __syncwarp();
                st.to(4);
                st.from(5);
                for (int m = lane; m < NA; m += 32) {
                    float v = 0.f, dv = 0.f;
                    for (int q = 0; q < n; ++q) {
                        const int s = list[q];
                        const int jas = ja[s];
                        float wm, dwm;
                        if (jas - 1 == m) { wm = 1.f - wa[s]; dwm = -dwa[s]; }
                        else if (jas == m) { wm = wa[s]; dwm = dwa[s]; }
                        else continue;
                        const bool low = jb[s] - 1 == j;
                        const float wj = low ? 1.f - wb[s] : wb[s];
                        const float dwj = low ? -dwb[s] : dwb[s];
                        const float mass = wj * src[s];
                        v += mass * wm;
                        dv += (dwj * src[s] + wj * dsrc[s]) * wm + mass * dwm;
                    }
                    const int k = ((j * NA + m) * NE + e) * 2 + acc;
                    H[k] = v;
                    dH[k] = dv;
                }
                __syncwarp();
                st.to(5);
            }
            __syncthreads();
            st.to(1);
            if (grp < 16) st.to(7 + grp);
        }

        // M. Income then access mixing, and this thread's aggregate shares.
        st.from(2);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f, s5 = 0.f;
        for (int k = tid; k < N4; k += kFwdThreads) {
            const int acc2 = k & 1;
            const int e2 = (k >> 1) % NE;
            const int base = k - (k % (2 * NE));         // (b, a, e = 0, acc = 0)
            float Dn = 0.f, dDn = 0.f;
            for (int acc = 0; acc < 2; ++acc) {
                float x = 0.f, dx = 0.f;
                for (int e = 0; e < NE; ++e) {
                    x += H[base + 2 * e + acc] * Pi[e * NE + e2];
                    dx += dH[base + 2 * e + acc] * Pi[e * NE + e2];
                }
                Dn += x * Pacc[acc * 2 + acc2];
                dDn += dx * Pacc[acc * 2 + acc2];
            }
            D[k] = Dn;
            dD[k] = dDn;
            const float b = pB[off + k], a = pA[off + k], c = pC[off + k];
            s0 += b * Dn;
            s1 += a * Dn;
            s2 += c * Dn;
            s3 += dB[off + k] * Dn + b * dDn;
            s4 += dA[off + k] * Dn + a * dDn;
            s5 += dC[off + k] * Dn + c * dDn;
        }
        // Fixed-order reduction: warp butterflies, then warp 0 over the warps.
        float v[6] = {s0, s1, s2, s3, s4, s5};
        for (int q = 0; q < 6; ++q) {
            for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
            if (lane == 0) red[q * kFwdWarps + warp] = v[q];
        }
        __syncthreads();
        st.to(2);
        st.from(3);
        if (warp == 0) {
            for (int q = 0; q < 6; ++q) {
                float x = red[q * kFwdWarps + lane];
                for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
                if (lane == 0) out[(size_t)q * Tm1 + t] = x;
            }
        }
        __syncthreads();
        st.to(3);
    }
    st.to(6);
    st.save();
}

// ── Kernel 6 on a thread-block cluster ────────────────────────────────────
// two_asset_fwd_cluster_kernel replaces, like two_asset_fwd_kernel above,
// the TPU kernel hank_tpu/ops/fused_sweep2.py: fused2_forward_jvp
// (_make_fwd2_kernel), and gives two_asset_fwd_kernel's bits.
//
// Why a new design (PERF.md §6; H100 80GB HBM3, 700 W; measured with
// hank_tpu_torch/tools/kernel6_split.py): at 40x20x5x2, T=300 the previous
// kernel takes 362 us a period, 82% of it in the scatter (R), where one
// warp per destination row walks the row's source list and skips the ~90%
// of entries off its lane's column. The row at the liquid borrowing limit
// of the (income 4, access 1) group holds ~400 sources every period, so one
// warp walks ~400 entries at ~270 cycles each while the other SMs idle, and
// the ten (income, access) groups run one after another.
//
// The design:
//   - one cluster of C blocks (C = 2*n_e: one group per SM); block r owns
//     the groups g = 2*e + acc with g = r (mod C), keeps their D and dD, and
//     runs their lotteries (L) and scatters (R); the groups run side by side;
//   - L: each source's brackets (the same lottery_bracket()) and bitmaps of
//     each row's and column's sources (one word per 32 sources; OR commutes,
//     so they do not depend on the threads' order);
//   - R: the sources of destination (j, m) are the set bits of row j AND
//     column m. Each destination counts them per word, keeping its count
//     before every 2^shift-th word (shift > 0 only where a grid needs the
//     room); each source computes its weights (lottery_weights()) and its
//     terms at its four corners with the previous kernel's roundings spelled
//     out (mass = wj * D, A = fma(dwj, D, wj * dD), T = fma(mass, dwm,
//     A * wm)) and writes them into their destinations' lists at its rank
//     (that count, the words after it, and the set bits below it in its
//     word), so every list is in ascending source order; one thread per
//     destination then sums its list, v = fma(mass, wm, v) and dv = dv + T:
//     the previous kernel's terms in its order, at most 118 of them at the
//     solution against ~400 entries walked before;
//   - M by cells: block r mixes cells [r * cells, (r + 1) * cells) of every
//     group (each H goes to that one block through distributed shared
//     memory; access outer, income inner, as before) and sends each D back
//     to its group's owner; a cluster barrier before and after;
//   - the aggregates after the recursion, from each period's D in a global
//     scratch, block r taking the periods t = r (mod C), each in the
//     previous kernel's order (thread tid sums k = tid + 1024 i, the same
//     butterflies and warp-0 tree).
// Every sum keeps its terms, their roundings and their order, so the outputs
// are bit for bit two_asset_fwd_kernel's at any cluster size. Shared memory
// grows as ~84*NS bytes, the bitmaps' (n_b + n_a) * NS / 8 and the counts'
// NS * NS / (16 << shift): it takes every grid the previous kernel takes
// with at least 6 knots on each asset axis. What bounds it now: latency on
// the (income 4, access 1) block, ~25k cycles a period (stamped) at
// 40x20x5x2: L 2.9k, counting and placing the lists 4.4k, terms and ranks
// 3.3k, summing the longest list 5.9k, M 2.7k, the two cluster barriers
// 3.6k (PERF.md §6).
constexpr int kCluThreads = 1024;   // power of two: the tree reduction needs it
constexpr int kCluWarps = kCluThreads / 32;
constexpr int kCluSources = 2;      // sources (and destinations) per thread: n_b * n_a <= 2048
constexpr int kCluSourcesGlobal = 4;  // the same under GLOBAL_LISTS: n_b * n_a <= 4096

// Per block: the lists' entries (mass, wm, T, 0; 4 per source; under
// global_lists each source's packed brackets in their place), every group's
// H and dH on the block's cells (Hc), the own groups' D and dD, the
// constants and warp partials, the row and column bitmaps, each
// destination's list offset, and its count before every 2^shift-th bitmap
// word (16 bit).
size_t fwd_cluster_smem_bytes(int NB, int NA, int NE, int C, int shift,
                              bool global_lists = false) {
    const size_t NS = (size_t)NB * NA, NG = 2 * (size_t)NE, G = (NG + C - 1) / C;
    const size_t nw = (NS + 31) / 32, cells = (NS + C - 1) / C;
    const size_t counts = ((nw - 1) >> shift) + 1;
    return (global_lists ? sizeof(int) * NS : sizeof(float4) * 4 * NS)
           + sizeof(float) * (2 * NG * cells + 2 * G * NS + NB + NA + (size_t)NE * NE + 4
                              + 6 * kCluWarps)
           + sizeof(unsigned) * ((NB + NA) * nw + NS + 4) + sizeof(unsigned short) * NS * counts;
}

// The least shift whose layout fits in a block (or the one keeping a single
// count per destination, which the launch then refuses).
int fwd_cluster_shift(int NB, int NA, int NE, int C, bool global_lists = false) {
    const int nw = (NB * NA + 31) / 32;
    int shift = 0;
    while ((1 << shift) < nw
           && fwd_cluster_smem_bytes(NB, NA, NE, C, shift, global_lists) > kSmemOptin)
        ++shift;
    return shift;
}

// Stamp slots (per block, 32 apart): [0] L, [1] counting and placing the
// lists, [2] the sources' weights, terms and ranks, [3] summing and sending
// the lists, [4] the wait at the first cluster barrier, [5] M (thread 0's
// share), [6] the wait at the second, [7] the aggregates, [8] the sweep.
// BATCHED: a grid of (C, B) blocks, one cluster per path b = blockIdx.y. The
// six policy inputs are the rows of one (B, 6, Tm1, N4) tensor (pB at q = 0 to
// dC at q = 5, as the batched kernel 5 writes them), so path b's start
// b * 6 * Tm1 * N4 elements on; it keeps its own Dpath (B, Tm1, 2, N4) and
// writes its own row of out (B, 6, Tm1); D0, the grids, Pi and Pacc are
// shared. Without it (the single-path entry point) the offset compiles out.
//
// GLOBAL_LISTS: the lists live in this (path, block)'s slice of `lists_g`, a
// (B, C, 4 * NS) float4 workspace in global memory that the caller allocates
// (224 KB a block at 50x70, which stays in L2), and each source's two
// brackets, packed in one int, take their place in shared memory; a thread
// takes up to kCluSourcesGlobal sources, so the instantiation takes n_b * n_a
// up to 4096 where its shared memory fits. Policies are not held in
// registers across the barriers (four sources' would add 16 registers to a
// kernel at its 64-register cap): each stage reads them where it needs
// them, after an L2 prefetch one group ahead.
// Every term, its rounding and every list's order are the shared-list
// kernel's, and __syncthreads() orders a block's global accesses as it
// orders its shared ones, so on every grid both take the outputs are bit for
// bit the shared-list kernel's. `lists_g` is written and read within the
// launch, so it is not const __restrict__: no load of it takes the read-only
// path. Without GLOBAL_LISTS `lists_g` is null and compiled out, and the
// shared layout is as above.
template <bool BATCHED, bool GLOBAL_LISTS>
__global__ void __launch_bounds__(kCluThreads, 1) two_asset_fwd_cluster_kernel(
    const float* __restrict__ pB, const float* __restrict__ pA,
    const float* __restrict__ pC, const float* __restrict__ dB,
    const float* __restrict__ dA, const float* __restrict__ dC,
    const float* __restrict__ D0,
    const float* __restrict__ bgrid_g, const float* __restrict__ agrid_g,
    const float* __restrict__ Pi_g, const float* __restrict__ Pacc_g,
    float* __restrict__ Dpath, float* __restrict__ out, int Tm1, int NB, int NA, int NE,
    int shift, float4* lists_g K6_STAMPS_PARAM)
{
    constexpr int kSrc = GLOBAL_LISTS ? kCluSourcesGlobal : kCluSources;
    extern __shared__ __align__(16) float sm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    K6_STAMPS(kStampSlots * rank);
    st.from(8);
    const int NS = NB * NA, NG = 2 * NE, N4 = NS * NG;
    const int G = (NG + C - 1) / C;               // room for this many groups
    const int own = (NG - rank + C - 1) / C;      // groups rank, rank + C, ...
    const int nw = (NS + 31) >> 5;
    const int counts = ((nw - 1) >> shift) + 1;   // counts kept per destination
    const int cells = (NS + C - 1) / C;           // block r mixes cells [r * cells, ...)
    const int my_cells = max(0, min(NS - rank * cells, cells));
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t TN = (size_t)Tm1 * N4;

    float4* lists = reinterpret_cast<float4*>(sm);  // entries (mass, wm, T, 0), 4 * NS
    int* brk = reinterpret_cast<int*>(sm);  // GLOBAL_LISTS: (jb << 16) | ja per source
    float* Hc = GLOBAL_LISTS ? sm + NS   // [value, tangent][NG][cells]
                             : reinterpret_cast<float*>(lists + 4 * NS);
    float* D = Hc + 2 * NG * cells;               // own groups: [value, tangent][G][NS]
    float* bg = D + 2 * G * NS;
    float* ag = bg + NB;
    float* Pi = ag + NA;
    float* Pacc = Pi + NE * NE;
    float* red = Pacc + 4;                        // (6, kCluWarps) warp partial sums
    unsigned* rowbits = reinterpret_cast<unsigned*>(red + 6 * kCluWarps);  // (NB, nw)
    unsigned* colbits = rowbits + NB * nw;                                 // (NA, nw)
    int* offs = reinterpret_cast<int*>(colbits + NA * nw);  // list offset of destination d
    int* alloc = offs + NS;
    unsigned short* before = reinterpret_cast<unsigned short*>(alloc + 4);  // (NS, counts)

    for (int i = tid; i < NB; i += kCluThreads) bg[i] = bgrid_g[i];
    for (int i = tid; i < NA; i += kCluThreads) ag[i] = agrid_g[i];
    for (int i = tid; i < NE * NE; i += kCluThreads) Pi[i] = Pi_g[i];
    if (tid < 4) Pacc[tid] = Pacc_g[tid];
    for (int gi = 0; gi < own; ++gi) {
        for (int s = tid; s < NS; s += kCluThreads) {
            D[gi * NS + s] = D0[s * NG + rank + gi * C];
            D[(G + gi) * NS + s] = 0.f;
        }
    }

    // This thread's sources' policies for the next (period, group), in
    // registers (under GLOBAL_LISTS into L2 only).
    float npb[kCluSources], ndb[kCluSources], npa[kCluSources], nda[kCluSources];
    auto prefetch = [&](int t, int gi) {
        const size_t off = path_offset<BATCHED>(6 * TN) + (size_t)t * N4 + rank + gi * C;
#pragma unroll
        for (int i = 0; i < kSrc; ++i) {
            const int s = tid + i * kCluThreads;
            if (s < NS) {
                const size_t k = off + (size_t)s * NG;
                if constexpr (GLOBAL_LISTS) {
                    prefetch_l2(pB + k);
                    prefetch_l2(dB + k);
                    prefetch_l2(pA + k);
                    prefetch_l2(dA + k);
                } else {
                    npb[i] = pB[k];
                    ndb[i] = dB[k];
                    npa[i] = pA[k];
                    nda[i] = dA[k];
                }
            }
        }
    };
    // Under GLOBAL_LISTS: the policies of source s of group g in period t.
    auto policy = [&](const float* __restrict__ p, int t, int g, int s) {
        return p[path_offset<BATCHED>(6 * TN) + (size_t)t * N4 + g + (size_t)s * NG];
    };
    prefetch(0, 0);

    for (int t = 0; t < Tm1; ++t) {
        for (int gi = 0; gi < own; ++gi) {
            const int g = rank + gi * C;
            st.from(0);
            for (int i = tid; i < (NB + NA) * nw; i += kCluThreads) rowbits[i] = 0u;
            if (tid == 0) *alloc = 0;
            __syncthreads();
            // L. Lottery brackets of the group's sources, and the bitmaps of
            //    the two rows and two columns each source reaches (one shared
            //    atomicOr per warp and distinct bracket).
            int kjb[kCluSources], kja[kCluSources];
#pragma unroll
            for (int i = 0; i < kSrc; ++i) {
                const int s = tid + i * kCluThreads;
                if (s < NS) {
                    int jbs, jas;
                    if constexpr (GLOBAL_LISTS) {
                        jbs = lottery_bracket(bg, NB, policy(pB, t, g, s));
                        jas = lottery_bracket(ag, NA, policy(pA, t, g, s));
                        brk[s] = (jbs << 16) | jas;
                    } else {
                        jbs = lottery_bracket(bg, NB, npb[i]);
                        jas = lottery_bracket(ag, NA, npa[i]);
                        kjb[i] = jbs;
                        kja[i] = jas;
                    }
                    const unsigned act = __activemask();
                    const int w = s >> 5;
                    const unsigned mb = __match_any_sync(act, jbs);
                    if (lane == __ffs(mb) - 1) {
                        atomicOr(&rowbits[(jbs - 1) * nw + w], mb);
                        atomicOr(&rowbits[jbs * nw + w], mb);
                    }
                    const unsigned ma = __match_any_sync(act, jas);
                    if (lane == __ffs(ma) - 1) {
                        atomicOr(&colbits[(jas - 1) * nw + w], ma);
                        atomicOr(&colbits[jas * nw + w], ma);
                    }
                }
            }
            __syncthreads();
            st.to(0);
            st.from(1);
            // R. The sources of destination (j, m) are the set bits of row j
            //    AND column m, and it sums them in ascending order. Per
            //    destination: its count before every 2^shift-th bitmap word,
            //    its total and a place for its list (a warp scan, one
            //    atomicAdd per warp: where a list lies does not change its
            //    sum).
            int cnt[kSrc];
#pragma unroll
            for (int i = 0; i < kSrc; ++i) {
                cnt[i] = 0;
                const int d = tid + i * kCluThreads;
                if (d < NS) {
                    const int j = d / NA, m = d - j * NA;
                    unsigned short* bd = before + d * counts;
#pragma unroll 4
                    for (int w = 0; w < nw; ++w) {
                        if ((w & ((1 << shift) - 1)) == 0) bd[w >> shift] = (unsigned short)cnt[i];
                        cnt[i] += __popc(rowbits[j * nw + w] & colbits[m * nw + w]);
                    }
                }
            }
            int mine = 0;
#pragma unroll
            for (int i = 0; i < kSrc; ++i) mine += cnt[i];
            int incl = mine;
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += y;
            }
            int base = 0;
            if (lane == 31) base = atomicAdd(alloc, incl);
            base = __shfl_sync(0xffffffffu, base, 31) + incl - mine;
#pragma unroll
            for (int i = 0; i < kSrc; ++i) {
                const int d = tid + i * kCluThreads;
                if (d < NS) offs[d] = base;
                base += cnt[i];
            }
            __syncthreads();
            st.to(1);
            st.from(2);
            //    Each source's lottery weights, and its terms at its four
            //    corners (row jb - 1 or jb, column ja - 1 or ja) with
            //    two_asset_fwd_kernel's roundings spelled out: mass = wj * D,
            //    A = fma(dwj, D, wj * dD), T = fma(mass, dwm, A * wm). Each
            //    goes into its list at its rank: the destination's count
            //    before the source's word plus the set bits below it.
#pragma unroll
            for (int i = 0; i < kSrc; ++i) {
                const int s = tid + i * kCluThreads;
                if (s < NS) {
                    float wbs, dwbs, was, dwas;
                    int jb, ja;
                    if constexpr (GLOBAL_LISTS) {
                        jb = brk[s] >> 16;
                        ja = brk[s] & 0xffff;
                        lottery_weights(bg, jb, policy(pB, t, g, s), policy(dB, t, g, s), wbs,
                                        dwbs);
                        lottery_weights(ag, ja, policy(pA, t, g, s), policy(dA, t, g, s), was,
                                        dwas);
                    } else {
                        jb = kjb[i];
                        ja = kja[i];
                        lottery_weights(bg, kjb[i], npb[i], ndb[i], wbs, dwbs);
                        lottery_weights(ag, kja[i], npa[i], nda[i], was, dwas);
                    }
                    const float src = D[gi * NS + s], dsrc = D[(G + gi) * NS + s];
                    const int w = s >> 5;
                    const unsigned below = (1u << (s & 31)) - 1u;
                    float4* Ls = GLOBAL_LISTS
                        ? lists_g + (path_offset<BATCHED>(C) + rank) * 4 * (size_t)NS : lists;
#pragma unroll
                    for (int rc = 0; rc < 2; ++rc) {
                        const float wj = rc == 0 ? 1.f - wbs : wbs;
                        const float dwj = rc == 0 ? -dwbs : dwbs;
                        const float mass = __fmul_rn(wj, src);
                        const float A = __fmaf_rn(dwj, src, __fmul_rn(wj, dsrc));
                        const int j = jb - 1 + rc;
                        const unsigned* rj = rowbits + j * nw;
#pragma unroll
                        for (int cc = 0; cc < 2; ++cc) {
                            const float wm = cc == 0 ? 1.f - was : was;
                            const float dwm = cc == 0 ? -dwas : dwas;
                            const int m = ja - 1 + cc, d = j * NA + m;
                            const unsigned* cm = colbits + m * nw;
                            int pos = before[d * counts + (w >> shift)]
                                      + __popc(rj[w] & cm[w] & below);
                            for (int u = w & ~((1 << shift) - 1); u < w; ++u)
                                pos += __popc(rj[u] & cm[u]);
                            Ls[offs[d] + pos] = make_float4(
                                mass, wm, __fmaf_rn(mass, dwm, __fmul_rn(A, wm)), 0.f);
                        }
                    }
                }
            }
            if (gi + 1 < own) prefetch(t, gi + 1);
            else if (t + 1 < Tm1) prefetch(t + 1, 0);
            __syncthreads();
            st.to(2);
            st.from(3);
            //    One thread per destination sums its list: v = fma(mass, wm, v)
            //    and dv = dv + T, the previous kernel's sum in its order.
#pragma unroll
            for (int i = 0; i < kSrc; ++i) {
                const int d = tid + i * kCluThreads;
                if (d < NS) {
                    const float4* L = (GLOBAL_LISTS ? lists_g + (path_offset<BATCHED>(C) + rank)
                                                                    * 4 * (size_t)NS
                                                    : lists) + offs[d];
                    float v = 0.f, dv = 0.f;
#pragma unroll 4
                    for (int q = 0; q < cnt[i]; ++q) {
                        const float4 x = L[q];
                        v = __fmaf_rn(x.x, x.y, v);
                        dv = __fadd_rn(dv, x.z);
                    }
                    // To the block that mixes cell d.
                    const int r = d / cells, hv = g * cells + d - r * cells;
                    float* Hr = cluster.map_shared_rank(Hc, r);
                    Hr[hv] = v;
                    Hr[NG * cells + hv] = dv;
                }
            }
            __syncthreads();
            st.to(3);
        }
        // Every group's H of period t on this block's cells is here.
        st.from(4);
        cluster.sync();
        st.to(4);
        st.from(5);
        // M. Income then access mixing on this block's cells, every group, in
        //    two_asset_fwd_kernel's loop order (access outer, income inner);
        //    D goes to the block that owns its group, and to Dpath[t] for the
        //    aggregates.
        float* Dt = Dpath + path_offset<BATCHED>(2 * TN) + (size_t)t * 2 * N4;
        for (int i = tid; i < my_cells * NG; i += kCluThreads) {
            const int g2 = i % NG, c = i / NG, e2 = g2 >> 1, acc2 = g2 & 1;
            float Dn = 0.f, dDn = 0.f;
            for (int acc = 0; acc < 2; ++acc) {
                float x = 0.f, dx = 0.f;
                for (int e = 0; e < NE; ++e) {
                    x += Hc[(2 * e + acc) * cells + c] * Pi[e * NE + e2];
                    dx += Hc[(NG + 2 * e + acc) * cells + c] * Pi[e * NE + e2];
                }
                Dn += x * Pacc[acc * 2 + acc2];
                dDn += dx * Pacc[acc * 2 + acc2];
            }
            const int s = rank * cells + c, gi = g2 / C;
            float* Dr = cluster.map_shared_rank(D, g2 % C);
            Dr[gi * NS + s] = Dn;
            Dr[(G + gi) * NS + s] = dDn;
            const int k = s * NG + g2;
            Dt[k] = Dn;
            Dt[N4 + k] = dDn;
        }
        st.to(5);
        // Every group's D of period t is with its owner; nobody reads Hc now.
        st.from(6);
        cluster.sync();
        st.to(6);
    }

    // Aggregates, after the recursion (the last barrier made every period's
    // Dpath visible), block r taking the periods t = r (mod C), each in
    // two_asset_fwd_kernel's order: thread tid sums k = tid + kCluThreads * i,
    // then the same butterflies and warp-0 tree.
    st.from(7);
    for (int t = rank; t < Tm1; t += C) {
        const size_t off = path_offset<BATCHED>(6 * TN) + (size_t)t * N4;
        const float* Dt = Dpath + path_offset<BATCHED>(2 * TN) + (size_t)t * 2 * N4;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f, s5 = 0.f;
        for (int k = tid; k < N4; k += kCluThreads) {
            const float Dn = Dt[k], dDn = Dt[N4 + k];
            const float b = pB[off + k], a = pA[off + k], c = pC[off + k];
            s0 += b * Dn;
            s1 += a * Dn;
            s2 += c * Dn;
            s3 += dB[off + k] * Dn + b * dDn;
            s4 += dA[off + k] * Dn + a * dDn;
            s5 += dC[off + k] * Dn + c * dDn;
        }
        float v[6] = {s0, s1, s2, s3, s4, s5};
        for (int q = 0; q < 6; ++q) {
            for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
            if (lane == 0) red[q * kCluWarps + warp] = v[q];
        }
        __syncthreads();
        if (warp == 0) {
            for (int q = 0; q < 6; ++q) {
                float x = red[q * kCluWarps + lane];
                for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
                if (lane == 0)
                    out[path_offset<BATCHED>(6 * (size_t)Tm1) + (size_t)q * Tm1 + t] = x;
            }
        }
        __syncthreads();
    }
    st.to(7);
    st.to(8);
    st.save();
}

#ifdef HANK_K6_STAMPS
// Probes of the measurement build: `iters` cluster.sync() or __syncthreads()
// in a loop, the cycles of block (rank) 0's thread 0 out.
__global__ void __launch_bounds__(1024) cluster_sync_loop(int iters, long long* cycles) {
    cg::cluster_group cluster = cg::this_cluster();
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) cluster.sync();
    if (threadIdx.x == 0 && cluster.block_rank() == 0) cycles[0] = clock64() - t0;
}

__global__ void __launch_bounds__(1024) block_sync_loop(int iters, long long* cycles) {
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) __syncthreads();
    if (threadIdx.x == 0) cycles[0] = clock64() - t0;
}
#endif

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

}  // namespace

// Plain C interface (loaded with ctypes). Each launcher returns the
// cudaError_t of the attribute call or of cudaGetLastError() right after the
// launch; 0 means the kernel was enqueued on `stream`. The kernel-5 and
// kernel-6 entry points take a stamps pointer before `stream` in their
// measurement builds only (HANK_K5_STAMPS, HANK_K6_STAMPS; 32 slots of long
// long per block).
extern "C" {

int hank_sweep2_policies_jvp_f32(const void* r, const void* ra, const void* w,
                                 const void* tau, const void* dr, const void* dra,
                                 const void* dw, const void* dtau, const void* V_T,
                                 const void* bgrid, const void* agrid,
                                 const void* egrid, const void* Pi, void* margin,
                                 void* out, int Tm1, int n_b, int n_a, int n_e,
                                 double beta, double lam, double chi,
                                 double borrow_cons K5_ENTRY_PARAM, void* stream) {
    const size_t smem = bwd_smem_bytes(n_b, n_a, n_e);
    cudaError_t err = cudaFuncSetAttribute(
        two_asset_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    two_asset_bwd_kernel<<<1, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const float*)r, (const float*)ra, (const float*)w, (const float*)tau,
        (const float*)dr, (const float*)dra, (const float*)dw, (const float*)dtau,
        (const float*)V_T, (const float*)bgrid, (const float*)agrid,
        (const float*)egrid, (const float*)Pi, (float*)margin, (float*)out,
        Tm1, n_b, n_a, n_e, (float)beta, (float)lam, (float)chi, (float)borrow_cons
        K5_ENTRY_ARG);
    return (int)cudaGetLastError();
}

// Kernel 5 on one cluster of `cluster` blocks (1 to min(n_e, 16)). Returns
// cudaErrorInvalidValue for a cluster size or a grid it does not take, and
// cudaErrorLaunchOutOfResources when the card cannot hold one such cluster
// (cudaOccupancyMaxActiveClusters gives 0).
int hank_sweep2_policies_jvp_cluster_f32(const void* r, const void* ra, const void* w,
                                         const void* tau, const void* dr, const void* dra,
                                         const void* dw, const void* dtau, const void* V_T,
                                         const void* bgrid, const void* agrid,
                                         const void* egrid, const void* Pi, void* out,
                                         int Tm1, int n_b, int n_a, int n_e, int cluster,
                                         double beta, double lam, double chi,
                                         double borrow_cons K5_ENTRY_PARAM, void* stream) {
    if (cluster < 1 || cluster > n_e || cluster > 16 || n_b < 2 || n_a < 2)
        return (int)cudaErrorInvalidValue;
    return (int)launch_paths(
        two_asset_bwd_cluster_kernel<false>, cluster, 1, kB5Threads,
        bwd_cluster_smem_bytes(n_b, n_a, n_e, cluster), stream, (const float*)r,
        (const float*)ra, (const float*)w, (const float*)tau, (const float*)dr,
        (const float*)dra, (const float*)dw, (const float*)dtau, (const float*)V_T,
        (const float*)bgrid, (const float*)agrid, (const float*)egrid, (const float*)Pi,
        (float*)out, Tm1, n_b, n_a, n_e, (float)beta, (float)lam, (float)chi,
        (float)borrow_cons, bwd_cluster_tabled(n_b, n_a, n_e, cluster) ? 1 : 0 K5_ENTRY_ARG);
}

// Kernel 5 on one cluster as hank_sweep2_policies_jvp_cluster_f32, with its
// candidates' brackets never tabled (the branch the kernel takes where the
// table has no room), for a bit-for-bit comparison of the two branches on a
// grid that has the room. No route launches it.
int hank_sweep2_policies_jvp_cluster_untabled_f32(
    const void* r, const void* ra, const void* w, const void* tau, const void* dr,
    const void* dra, const void* dw, const void* dtau, const void* V_T, const void* bgrid,
    const void* agrid, const void* egrid, const void* Pi, void* out, int Tm1, int n_b, int n_a,
    int n_e, int cluster, double beta, double lam, double chi,
    double borrow_cons K5_ENTRY_PARAM, void* stream) {
    if (cluster < 1 || cluster > n_e || cluster > 16 || n_b < 2 || n_a < 2)
        return (int)cudaErrorInvalidValue;
    return (int)launch_paths(
        two_asset_bwd_cluster_kernel<false>, cluster, 1, kB5Threads,
        bwd_cluster_smem(n_b, n_a, n_e, cluster, false), stream, (const float*)r,
        (const float*)ra, (const float*)w, (const float*)tau, (const float*)dr,
        (const float*)dra, (const float*)dw, (const float*)dtau, (const float*)V_T,
        (const float*)bgrid, (const float*)agrid, (const float*)egrid, (const float*)Pi,
        (float*)out, Tm1, n_b, n_a, n_e, (float)beta, (float)lam, (float)chi,
        (float)borrow_cons, 0 K5_ENTRY_ARG);
}

int hank_sweep2_forward_jvp_f32(const void* pB, const void* pA, const void* pC,
                                const void* dB, const void* dA, const void* dC,
                                const void* D0, const void* bgrid, const void* agrid,
                                const void* Pi, const void* Pacc, void* out,
                                int Tm1, int n_b, int n_a, int n_e K6_ENTRY_PARAM,
                                void* stream) {
    const size_t smem = fwd_smem_bytes(n_b, n_a, n_e);
    cudaError_t err = cudaFuncSetAttribute(
        two_asset_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    two_asset_fwd_kernel<<<1, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const float*)pB, (const float*)pA, (const float*)pC, (const float*)dB,
        (const float*)dA, (const float*)dC, (const float*)D0, (const float*)bgrid,
        (const float*)agrid, (const float*)Pi, (const float*)Pacc, (float*)out,
        Tm1, n_b, n_a, n_e K6_ENTRY_ARG);
    return (int)cudaGetLastError();
}

// Kernel 6 on one cluster of `cluster` blocks (1 to min(2 * n_e, 16)); Dpath
// is (Tm1, 2, N4) f32 of global scratch (each period's D and dD). Returns
// cudaErrorInvalidValue for a cluster size or a grid it does not take, and
// cudaErrorLaunchOutOfResources when the card cannot hold one such cluster
// (cudaOccupancyMaxActiveClusters gives 0).
int hank_sweep2_forward_jvp_cluster_f32(const void* pB, const void* pA, const void* pC,
                                        const void* dB, const void* dA, const void* dC,
                                        const void* D0, const void* bgrid,
                                        const void* agrid, const void* Pi,
                                        const void* Pacc, void* Dpath, void* out, int Tm1,
                                        int n_b, int n_a, int n_e,
                                        int cluster K6_ENTRY_PARAM, void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2
        || n_b * n_a > kCluSources * kCluThreads)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_cluster_shift(n_b, n_a, n_e, cluster);
    return (int)launch_paths(
        two_asset_fwd_cluster_kernel<false, false>, cluster, 1, kCluThreads,
        fwd_cluster_smem_bytes(n_b, n_a, n_e, cluster, shift), stream, (const float*)pB,
        (const float*)pA, (const float*)pC, (const float*)dB, (const float*)dA,
        (const float*)dC, (const float*)D0, (const float*)bgrid, (const float*)agrid,
        (const float*)Pi, (const float*)Pacc, (float*)Dpath, (float*)out, Tm1, n_b, n_a, n_e,
        shift, nullptr K6_ENTRY_ARG);
}

// Kernel 6 with its lottery lists in global memory
// (two_asset_fwd_cluster_kernel<false, true>) on one cluster of `cluster`
// blocks: the arguments of hank_sweep2_forward_jvp_cluster_f32, and `lists`
// (cluster, 4 * n_b * n_a) float4 of global scratch after Dpath. Takes n_b *
// n_a up to 4096 where hank_sweep2_smem_bytes(4, ...) fits; bit for bit
// hank_sweep2_forward_jvp_cluster_f32 on every grid both take. Returns as
// that one.
int hank_sweep2_forward_jvp_cluster_global_f32(const void* pB, const void* pA, const void* pC,
                                               const void* dB, const void* dA, const void* dC,
                                               const void* D0, const void* bgrid,
                                               const void* agrid, const void* Pi,
                                               const void* Pacc, void* Dpath, void* lists,
                                               void* out, int Tm1, int n_b, int n_a, int n_e,
                                               int cluster K6_ENTRY_PARAM, void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2
        || n_b * n_a > kCluSourcesGlobal * kCluThreads || lists == nullptr)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_cluster_shift(n_b, n_a, n_e, cluster, true);
    return (int)launch_paths(
        two_asset_fwd_cluster_kernel<false, true>, cluster, 1, kCluThreads,
        fwd_cluster_smem_bytes(n_b, n_a, n_e, cluster, shift, true), stream, (const float*)pB,
        (const float*)pA, (const float*)pC, (const float*)dB, (const float*)dA,
        (const float*)dC, (const float*)D0, (const float*)bgrid, (const float*)agrid,
        (const float*)Pi, (const float*)Pacc, (float*)Dpath, (float*)out, Tm1, n_b, n_a, n_e,
        shift, (float4*)lists K6_ENTRY_ARG);
}

// Kernel 5 over B paths, one cluster of `cluster` blocks (1 to min(n_e, 16))
// per path: (B, Tm1) price and tangent paths -> out (B, 6, Tm1, n_b, n_a,
// n_e, 2). Row b is the single-path launch on row b, bit for bit, at any
// cluster size. Returns as hank_sweep2_policies_jvp_cluster_f32, and
// cudaErrorInvalidValue for B outside [1, 65535].
int hank_sweep2_policies_jvp_cluster_f32_batch(
    const void* r, const void* ra, const void* w, const void* tau, const void* dr,
    const void* dra, const void* dw, const void* dtau, const void* V_T, const void* bgrid,
    const void* agrid, const void* egrid, const void* Pi, void* out, int Tm1, int n_b,
    int n_a, int n_e, int cluster, int B, double beta, double lam, double chi,
    double borrow_cons K5_ENTRY_PARAM, void* stream) {
    if (cluster < 1 || cluster > n_e || cluster > 16 || n_b < 2 || n_a < 2 || B < 1
        || B > 65535)
        return (int)cudaErrorInvalidValue;
    return (int)launch_paths(
        two_asset_bwd_cluster_kernel<true>, cluster, B, kB5Threads,
        bwd_cluster_smem_bytes(n_b, n_a, n_e, cluster), stream, (const float*)r,
        (const float*)ra, (const float*)w, (const float*)tau, (const float*)dr,
        (const float*)dra, (const float*)dw, (const float*)dtau, (const float*)V_T,
        (const float*)bgrid, (const float*)agrid, (const float*)egrid, (const float*)Pi,
        (float*)out, Tm1, n_b, n_a, n_e, (float)beta, (float)lam, (float)chi,
        (float)borrow_cons, bwd_cluster_tabled(n_b, n_a, n_e, cluster) ? 1 : 0 K5_ENTRY_ARG);
}

// Kernel 6 over B paths, one cluster of `cluster` blocks (1 to min(2 * n_e,
// 16)) per path: pol is the (B, 6, Tm1, n_b, n_a, n_e, 2) output of the
// batched kernel 5 (policies B, A, C, then their tangents), Dpath (B, Tm1, 2,
// N4) f32 of global scratch -> out (B, 6, Tm1). Row b is the single-path
// launch on row b, bit for bit, at any cluster size. Returns as
// hank_sweep2_forward_jvp_cluster_f32, and cudaErrorInvalidValue for B
// outside [1, 65535].
int hank_sweep2_forward_jvp_cluster_f32_batch(const void* pol, const void* D0,
                                              const void* bgrid, const void* agrid,
                                              const void* Pi, const void* Pacc, void* Dpath,
                                              void* out, int Tm1, int n_b, int n_a, int n_e,
                                              int cluster, int B K6_ENTRY_PARAM,
                                              void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2
        || n_b * n_a > kCluSources * kCluThreads || B < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_cluster_shift(n_b, n_a, n_e, cluster);
    const float* p = static_cast<const float*>(pol);
    const size_t TN = (size_t)Tm1 * (2 * (size_t)n_b * n_a * n_e);
    return (int)launch_paths(
        two_asset_fwd_cluster_kernel<true, false>, cluster, B, kCluThreads,
        fwd_cluster_smem_bytes(n_b, n_a, n_e, cluster, shift), stream, p, p + TN, p + 2 * TN,
        p + 3 * TN, p + 4 * TN, p + 5 * TN, (const float*)D0, (const float*)bgrid,
        (const float*)agrid, (const float*)Pi, (const float*)Pacc, (float*)Dpath, (float*)out,
        Tm1, n_b, n_a, n_e, shift, nullptr K6_ENTRY_ARG);
}

// The global-list kernel 6 over B paths (two_asset_fwd_cluster_kernel<true,
// true>): the arguments of hank_sweep2_forward_jvp_cluster_f32_batch, and
// `lists` (B, cluster, 4 * n_b * n_a) float4 of global scratch after Dpath.
// Row b is the single-path launch on row b, bit for bit, at any cluster
// size. Returns as hank_sweep2_forward_jvp_cluster_global_f32, and
// cudaErrorInvalidValue for B outside [1, 65535].
int hank_sweep2_forward_jvp_cluster_global_f32_batch(
    const void* pol, const void* D0, const void* bgrid, const void* agrid, const void* Pi,
    const void* Pacc, void* Dpath, void* lists, void* out, int Tm1, int n_b, int n_a, int n_e,
    int cluster, int B K6_ENTRY_PARAM, void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2
        || n_b * n_a > kCluSourcesGlobal * kCluThreads || B < 1 || B > 65535
        || lists == nullptr)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_cluster_shift(n_b, n_a, n_e, cluster, true);
    const float* p = static_cast<const float*>(pol);
    const size_t TN = (size_t)Tm1 * (2 * (size_t)n_b * n_a * n_e);
    return (int)launch_paths(
        two_asset_fwd_cluster_kernel<true, true>, cluster, B, kCluThreads,
        fwd_cluster_smem_bytes(n_b, n_a, n_e, cluster, shift, true), stream, p, p + TN,
        p + 2 * TN, p + 3 * TN, p + 4 * TN, p + 5 * TN, (const float*)D0, (const float*)bgrid,
        (const float*)agrid, (const float*)Pi, (const float*)Pacc, (float*)Dpath, (float*)out,
        Tm1, n_b, n_a, n_e, shift, (float4*)lists K6_ENTRY_ARG);
}

// How many clusters of `cluster` blocks of the batched kernel 6 (which = 2),
// the batched kernel 5 (which = 3) or the batched global-list kernel 6
// (which = 4) the card holds at once, at an n_b x n_a x n_e x 2 grid
// (cudaOccupancyMaxActiveClusters), or -cudaError_t.
int hank_sweep2_max_clusters(int which, int n_b, int n_a, int n_e, int cluster) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int clusters = 0;
    const cudaError_t err =
        which == 2 ? cluster_config(two_asset_fwd_cluster_kernel<true, false>, cluster, 1,
                                    kCluThreads,
                                    fwd_cluster_smem_bytes(n_b, n_a, n_e, cluster,
                                                           fwd_cluster_shift(n_b, n_a, n_e,
                                                                             cluster)),
                                    nullptr, cfg, attr, clusters)
        : which == 4 ? cluster_config(two_asset_fwd_cluster_kernel<true, true>, cluster, 1,
                                      kCluThreads,
                                      fwd_cluster_smem_bytes(
                                          n_b, n_a, n_e, cluster,
                                          fwd_cluster_shift(n_b, n_a, n_e, cluster, true), true),
                                      nullptr, cfg, attr, clusters)
                     : cluster_config(two_asset_bwd_cluster_kernel<true>, cluster, 1,
                                      kB5Threads, bwd_cluster_smem_bytes(n_b, n_a, n_e, cluster),
                                      nullptr, cfg, attr, clusters);
    return err != cudaSuccess ? -(int)err : clusters;
}

// Dynamic shared memory of the previous kernel 5 (which = 0), of the
// previous kernel 6 (which = 1), of kernel 6 on a cluster of `cluster`
// blocks (which = 2; per block, at the least shift that fits, or at its
// largest), of kernel 5 on a cluster of `cluster` blocks (which = 3; per
// block, tabled where the room is), of the global-list kernel 6 (which = 4;
// as 2) or of kernel 5 untabled (which = 5; per block).
size_t hank_sweep2_smem_bytes(int which, int n_b, int n_a, int n_e, int cluster) {
    switch (which) {
    case 0: return bwd_smem_bytes(n_b, n_a, n_e);
    case 1: return fwd_smem_bytes(n_b, n_a, n_e);
    case 2: return fwd_cluster_smem_bytes(n_b, n_a, n_e, cluster,
                                          fwd_cluster_shift(n_b, n_a, n_e, cluster));
    case 4: return fwd_cluster_smem_bytes(n_b, n_a, n_e, cluster,
                                          fwd_cluster_shift(n_b, n_a, n_e, cluster, true), true);
    case 5: return bwd_cluster_smem(n_b, n_a, n_e, cluster, false);
    default: return bwd_cluster_smem_bytes(n_b, n_a, n_e, cluster);
    }
}

const char* hank_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef HANK_K6_STAMPS
// How many clusters of `cluster` blocks of 1024 threads with `smem` bytes
// each the card holds at once, or -err.
int hank_k6_max_clusters(int cluster, int smem) {
    cudaError_t err = cudaFuncSetAttribute(cluster_sync_loop,
                                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(cluster_sync_loop,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(1024, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, cluster_sync_loop, &cfg);
    return err != cudaSuccess ? -(int)err : n;
}

// `iters` cluster barriers on one cluster of `cluster` blocks; cycles out.
int hank_k6_cluster_sync(int cluster, int smem, int iters, void* cycles, void* stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(1024, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_sync_loop, iters,
                                               static_cast<long long*>(cycles));
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// `iters` block barriers on one block of 1024 threads; cycles out.
int hank_k6_block_sync(int iters, void* cycles, void* stream) {
    block_sync_loop<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
        iters, static_cast<long long*>(cycles));
    return (int)cudaGetLastError();
}
#endif

}  // extern "C"
