// Two-asset household sweep (Calvo-access portfolio model,
// hank_tpu_torch/models/hank_two_asset.py), f32 primal + tangent.
//
//   two_asset_bwd_kernel  (kernel 5) replaces the TPU kernel
//       hank_tpu/ops/fused_sweep2.py: fused2_policies_jvp (_make_bwd2_kernel):
//       the backward dual Bellman recursion over T-1 periods, writing the
//       B/A/C policies of both access branches and their tangents.
//   two_asset_fwd_kernel  (kernel 6) replaces the TPU kernel
//       hank_tpu/ops/fused_sweep2.py: fused2_forward_jvp (_make_fwd2_kernel):
//       the forward dual push of the distribution (joint two-axis Young
//       lottery, income and access mixing) and the B/A/C aggregates.
// Each is one block walking the periods in order; the two launch back to
// back, the same split as on the TPU.
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
// What bounds it on the H100: latency. One block walks its periods on one
// SM, every period a chain of block-wide barriers around O(states x knots)
// compares and FMAs. Kernel 5 keeps (V_b, V_a) and their tangents (4*N4
// f32, 125 KB at 40x20x5x2) and the continuation surfaces W (64 KB) in
// shared memory; the V region doubles as the period's scratch between
// barriers. Policies go to the output (57 MB per sweep at T=300, which
// kernel 6 reads once). Kernel 6 keeps D, the post-lottery D and their
// tangents (125 KB) in shared memory and works one (income, access) group
// at a time.
//
// Determinism: no float atomics. Every sum has one owner thread and a fixed
// order; the lottery's destinations sum their sources in source order from
// per-row lists built with warp ballots; aggregates go through a fixed
// tree. Two runs are bit-identical.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kBwdThreads = 512;
constexpr int kFwdThreads = 1024;   // power of two: the tree reduction needs it

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

// ── Kernel 5: the backward dual Bellman recursion ─────────────────────────
// Outputs out[q][t][i4], q = B, A, C, dB, dA, dC, each (Tm1, N4) with
// i4 = ((b*NA + a)*NE + e)*2 + access. margin_g: 2*N3 floats of global
// scratch (the no-access illiquid margin and its tangent).
__global__ void __launch_bounds__(kBwdThreads) two_asset_bwd_kernel(
    const float* __restrict__ r_p, const float* __restrict__ ra_p,
    const float* __restrict__ w_p, const float* __restrict__ tau_p,
    const float* __restrict__ dr_p, const float* __restrict__ dra_p,
    const float* __restrict__ dw_p, const float* __restrict__ dtau_p,
    const float* __restrict__ V_T,
    const float* __restrict__ bgrid_g, const float* __restrict__ agrid_g,
    const float* __restrict__ egrid_g, const float* __restrict__ Pi_g,
    float* __restrict__ margin_g, float* __restrict__ out,
    int Tm1, int NB, int NA, int NE, float beta, float lam, float chi, float borrow)
{
    extern __shared__ __align__(16) float sm[];
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
    }
}

// ── Kernel 6: the forward dual push ───────────────────────────────────────
constexpr int kFwdWarps = kFwdThreads / 32;

// Young lottery weights of a dual policy on a static sorted grid
// (ops/transition.lottery_weights): bracket jc in [1, n-1], mass 1 - w to
// jc - 1 and w to jc, w clipped to [0, 1] with torch's tie rule.
__device__ __forceinline__ void lottery(const float* g, int n, float p, float dp,
                                        int& jc, float& w, float& dw) {
    jc = min(max(count_below_sorted(g, n, p), 1), n - 1);
    const float h = g[jc] - g[jc - 1];
    const float raw = (p - g[jc - 1]) / h;
    w = clip_f(raw, 0.f, 1.f);
    dw = clip_d(raw, 0.f, 1.f) * (dp / h);
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
// Output out[q * Tm1 + t], q = B, A, C, dB, dA, dC.
__global__ void __launch_bounds__(kFwdThreads) two_asset_fwd_kernel(
    const float* __restrict__ pB, const float* __restrict__ pA,
    const float* __restrict__ pC, const float* __restrict__ dB,
    const float* __restrict__ dA, const float* __restrict__ dC,
    const float* __restrict__ D0,
    const float* __restrict__ bgrid_g, const float* __restrict__ agrid_g,
    const float* __restrict__ Pi_g, const float* __restrict__ Pacc_g,
    float* __restrict__ out, int Tm1, int NB, int NA, int NE)
{
    extern __shared__ __align__(16) float sm[];
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
            // L. Lottery brackets and weights of the group's sources.
            for (int s = tid; s < NS; s += kFwdThreads) {
                const int k = (s * NE + e) * 2 + acc;
                lottery(bg, NB, pB[off + k], dB[off + k], jb[s], wb[s], dwb[s]);
                lottery(ag, NA, pA[off + k], dA[off + k], ja[s], wa[s], dwa[s]);
                src[s] = D[k];
                dsrc[s] = dD[k];
            }
            __syncthreads();
            // R. One warp per destination row j: the sources touching row j,
            //    in source order (warp ballots), then one lane per column m
            //    sums them in that order.
            for (int j = warp; j < NB; j += kFwdWarps) {
                int n = 0;
                for (int c = 0; c < NS; c += 32) {
                    const int s = c + lane;
                    const bool hit = s < NS && (jb[s] == j || jb[s] - 1 == j);
                    const unsigned mask = __ballot_sync(0xffffffffu, hit);
                    if (hit) list[n + __popc(mask & ((1u << lane) - 1u))] = (unsigned short)s;
                    n += __popc(mask);
                }
                __syncwarp();
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
            }
            __syncthreads();
        }

        // M. Income then access mixing, and this thread's aggregate shares.
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
        if (warp == 0) {
            for (int q = 0; q < 6; ++q) {
                float x = red[q * kFwdWarps + lane];
                for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
                if (lane == 0) out[(size_t)q * Tm1 + t] = x;
            }
        }
        __syncthreads();
    }
}

}  // namespace

// Plain C interface (loaded with ctypes). Each launcher returns the
// cudaError_t of the attribute call or of cudaGetLastError() right after the
// launch; 0 means the kernel was enqueued on `stream`.
extern "C" {

int hank_sweep2_policies_jvp_f32(const void* r, const void* ra, const void* w,
                                 const void* tau, const void* dr, const void* dra,
                                 const void* dw, const void* dtau, const void* V_T,
                                 const void* bgrid, const void* agrid,
                                 const void* egrid, const void* Pi, void* margin,
                                 void* out, int Tm1, int n_b, int n_a, int n_e,
                                 double beta, double lam, double chi,
                                 double borrow_cons, void* stream) {
    const size_t smem = bwd_smem_bytes(n_b, n_a, n_e);
    cudaError_t err = cudaFuncSetAttribute(
        two_asset_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    two_asset_bwd_kernel<<<1, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const float*)r, (const float*)ra, (const float*)w, (const float*)tau,
        (const float*)dr, (const float*)dra, (const float*)dw, (const float*)dtau,
        (const float*)V_T, (const float*)bgrid, (const float*)agrid,
        (const float*)egrid, (const float*)Pi, (float*)margin, (float*)out,
        Tm1, n_b, n_a, n_e, (float)beta, (float)lam, (float)chi, (float)borrow_cons);
    return (int)cudaGetLastError();
}

int hank_sweep2_forward_jvp_f32(const void* pB, const void* pA, const void* pC,
                                const void* dB, const void* dA, const void* dC,
                                const void* D0, const void* bgrid, const void* agrid,
                                const void* Pi, const void* Pacc, void* out,
                                int Tm1, int n_b, int n_a, int n_e, void* stream) {
    const size_t smem = fwd_smem_bytes(n_b, n_a, n_e);
    cudaError_t err = cudaFuncSetAttribute(
        two_asset_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    two_asset_fwd_kernel<<<1, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        (const float*)pB, (const float*)pA, (const float*)pC, (const float*)dB,
        (const float*)dA, (const float*)dC, (const float*)D0, (const float*)bgrid,
        (const float*)agrid, (const float*)Pi, (const float*)Pacc, (float*)out,
        Tm1, n_b, n_a, n_e);
    return (int)cudaGetLastError();
}

// Dynamic shared memory of kernel 5 (which = 0) or kernel 6 (which = 1).
size_t hank_sweep2_smem_bytes(int which, int n_b, int n_a, int n_e) {
    return which == 0 ? bwd_smem_bytes(n_b, n_a, n_e) : fwd_smem_bytes(n_b, n_a, n_e);
}

const char* hank_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
