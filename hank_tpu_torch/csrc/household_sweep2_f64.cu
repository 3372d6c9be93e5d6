// Two-asset household sweep (Calvo-access portfolio model,
// hank_tpu_torch/models/hank_two_asset.py) in native FP64: the values pair,
// the full-precision residual F(x) of the two-asset path solver, and the
// tangent pair, its f64 directions.
//
//   two_asset_bwd_f64_cluster_kernel  the backward Bellman recursion of
//       ValueFunction over T-1 periods, writing the B/A/C policies of both
//       access branches (plain version: ops/fused_sweep2.backward_policies);
//   two_asset_fwd_f64_cluster_kernel  forward_iteration: the joint two-axis
//       Young lottery, income then access mixing, and the B/A/C aggregates
//       against the mixed distribution (plain version:
//       blocks/forward.forward_iteration).
// The values pair replaces no TPU kernel: the reference computes this F
// under XLA in f64 (hank_tpu/solvers/newton.py:352-376; its double-single
// residual kernel, hank_tpu/ops/fused_ds.py, takes the one-asset family
// only). They are kernels 5 and 6 of household_sweep2.cu
// (two_asset_bwd_cluster_kernel, two_asset_fwd_cluster_kernel) in double
// without the tangent, on the same cluster designs; that file keeps its f32
// kernels as they are. Both take a path axis for ensembles as kernels 5 and
// 6 do (BATCHED, the `_batch` entry points: one cluster per path, row b bit
// for bit the single-path launch), and the forward push kernel 6's
// GLOBAL_LISTS flag past 2048 (b, a) states (the `_global` entry points, to
// 4096).
//
// The tangent pair: each kernel's TANGENT instantiations (single path, and
// over B paths for ensembles as the values pair's BATCHED ones) add
// kernel 5's and kernel 6's tangent formulas in double, so they compute
// what the TPU kernels hank_tpu/ops/fused_sweep2.py: fused2_policies_jvp
// (body :172, call :599) and fused2_forward_jvp (body :835, call :971)
// compute in f32, in FP64: the reference's f64 directions are jax.jvp of its
// f64 pipeline under XLA (hank_tpu/solvers/newton.py:389), the port's on the
// card are these (the `_jvp_f64` entry points; plain versions
// ops/fused_sweep2.fused2_policies_jvp_reference and
// fused2_forward_jvp_reference in f64, torch.func.jvp of the two blocks).
// Every primal expression is the values pair's, so the primal outputs are
// the values pair's bits. Beside each primal array its tangent, in the same
// place: the backward kernel holds 10n doubles of state a block where the
// values kernel holds 5n (n = ceil(n_e / C) n_b n_a), or 7n with dW and the
// knots' tangents in a global workspace (GLOBAL_TANGENT, where 10n has no
// room: 50x70x5x2); the forward push doubles its list entries, H and D
// (its GLOBAL_LISTS instantiation past 2048 states or where the shared
// lists have no room). The notes at the kernels give the layouts.
//
// Semantics are those of the plain PyTorch versions, operation for
// operation: every expression is the plain version's, in its order, and the
// library is built with -fmad=false, so each product and sum is rounded on
// its own as the plain version's elementwise operations round it. Only the
// order of a few sums differs: the income expectation (a matmul there), the
// lottery's destinations (an einsum), the mixes (tensordot) and the
// aggregates (torch.sum). sqrt and / are IEEE; the inverse marginal W^(-1/2)
// (gamma = 2, which supports_fused_sweep2 requires) is 1 / sqrt(W) with the
// model's one Newton polish. min, max and clip propagate NaN as torch's do,
// so a NaN input gives NaN outputs.
//
// What bounds them on the H100: latency, as for kernels 5 and 6. Every
// period is a chain of block and cluster barriers around O(states x knots)
// compares and double operations; the pair's ~0.5 G operations at
// 40x20x5x2, T=300 (chip_smoke.py's two_asset_ops) would take ~16 us at the
// card's 34 TFLOP/s FP64, the kernels take milliseconds (PERF.md §6). The
// designs spread each period over the cluster's SMs: the income states
// (backward) and the (income, access) groups (forward) run side by side.
//
// Determinism: no float atomics. Every sum has one owner thread and a fixed
// order; the lottery's destinations sum their sources in source order;
// aggregates go through a fixed tree. Two launches are bit-identical.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr size_t kSmemOptin = 227 * 1024;   // dynamic shared memory a block may use

// torch.maximum / torch.minimum: a NaN operand gives NaN. clip(x, lo, hi) =
// min(max(x, lo), hi), as ops/clip.py.
__device__ __forceinline__ double dmax(double a, double b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ double dmin(double a, double b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ double dclip(double x, double lo, double hi) {
    return dmin(dmax(x, lo), hi);
}

// W^(-1/2) as models/hank_two_asset._crra_inv_marg at gamma = 2.
__device__ __forceinline__ double inv_marg(double W) {
    const double y = 1.0 / sqrt(W);
    return y * (1.5 - 0.5 * W * y * y);
}

// ── Tangents (the TANGENT instantiations) ───────────────────────────────
// torch's derivative rules, which ops/clip.py gives the floors and clips:
// maximum / minimum pass the tangent on the strict side and half of it at
// a tie (b_t + where(a == b, 1/2, a > b or a < b) * (a_t - b_t)), and
// clip(x, lo, hi) = minimum(maximum(x, lo), hi) composes the two.
__device__ __forceinline__ double tie_max(double a, double b) {
    return a == b ? 0.5 : (a > b ? 1.0 : 0.0);
}
__device__ __forceinline__ double tie_min(double a, double b) {
    return a == b ? 0.5 : (a < b ? 1.0 : 0.0);
}
__device__ __forceinline__ double dmax_t(double a, double da, double b, double db) {
    return db + tie_max(a, b) * (da - db);
}
__device__ __forceinline__ double dmin_t(double a, double da, double b, double db) {
    return db + tie_min(a, b) * (da - db);
}
// The tangent of clip(x, lo, hi) with constant bounds.
__device__ __forceinline__ double dclip_t(double x, double dx, double lo, double hi) {
    return tie_min(dmax(x, lo), hi) * (tie_max(x, lo) * dx);
}

// The tangent of inv_marg: y = rsqrt(W) (tangent -y^3/2 W_t), then
// y * (1.5 - 0.5 W y y) by the product rule.
__device__ __forceinline__ double inv_marg_t(double W, double dW) {
    const double y = 1.0 / sqrt(W);
    const double dy = -0.5 * (y * y * y) * dW;
    const double u = 1.5 - 0.5 * W * y * y;
    const double du = -(0.5 * (dW * y * y + W * (dy * y + y * dy)));
    return dy * u + y * du;
}

// The count of knots below q on a sorted grid (binary search), and the count
// bracket of the plain version's _bracket: index i in [1, n-1], clipped
// weight t and the open-interval flag of the slopes.
__device__ __forceinline__ int count_below(const double* g, int n, double q) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (g[mid] < q) lo = mid + 1; else hi = mid;
    }
    return lo;
}

struct Br {
    int i;
    double lo, hi, t;
    bool in;
};

__device__ __forceinline__ Br bracket(const double* g, int n, double q) {
    Br B;
    B.i = min(max(count_below(g, n, q), 1), n - 1);
    B.lo = g[B.i - 1];
    B.hi = g[B.i];
    B.t = dclip((q - B.lo) / (B.hi - B.lo), 0.0, 1.0);
    B.in = q > g[0] && q < g[n - 1];
    return B;
}

// The tangent of a bracket's weight t at a query q with tangent dq (the
// grid carries none).
__device__ __forceinline__ double bracket_t(const Br& B, double q, double dq) {
    const double h = B.hi - B.lo;
    return dclip_t((q - B.lo) / h, dq / h, 0.0, 1.0);
}

// Bilinear value and axis slopes (models/hank_two_asset._bilinear) of a
// surface over one income's (b, a) plane: W[b * NA + a] of mode 0 (Wb),
// 1 (Wa), 2 (Wb - Wa) or 3 (Wb + Wa), Wa at W + N.
struct Bi {
    double v, sb, sa;
};

__device__ __forceinline__ double surf(const double* W, int N, int mode, int k) {
    const double b = W[k], a = W[N + k];
    return mode == 0 ? b : (mode == 1 ? a : (mode == 2 ? b - a : b + a));
}

__device__ __forceinline__ double bilinear_value(const double* W, int N, int NA, int mode,
                                                 int ib, int ia, double tb, double ta) {
    const int k00 = (ib - 1) * NA + ia - 1;
    const double W00 = surf(W, N, mode, k00), W01 = surf(W, N, mode, k00 + 1);
    const double W10 = surf(W, N, mode, k00 + NA), W11 = surf(W, N, mode, k00 + NA + 1);
    return (1.0 - tb) * (1.0 - ta) * W00 + (1.0 - tb) * ta * W01
           + tb * (1.0 - ta) * W10 + tb * ta * W11;
}

__device__ Bi bilinear(const double* W, int N, int NA, int mode, const Br& B, const Br& A) {
    const int k00 = (B.i - 1) * NA + A.i - 1;
    const double W00 = surf(W, N, mode, k00), W01 = surf(W, N, mode, k00 + 1);
    const double W10 = surf(W, N, mode, k00 + NA), W11 = surf(W, N, mode, k00 + NA + 1);
    const double tb = B.t, ta = A.t;
    Bi o;
    o.v = (1.0 - tb) * (1.0 - ta) * W00 + (1.0 - tb) * ta * W01
          + tb * (1.0 - ta) * W10 + tb * ta * W11;
    o.sb = B.in ? ((1.0 - ta) * (W10 - W00) + ta * (W11 - W01)) / (B.hi - B.lo) : 0.0;
    o.sa = A.in ? ((1.0 - tb) * (W01 - W00) + tb * (W11 - W10)) / (A.hi - A.lo) : 0.0;
    return o;
}

// The tangents of bilinear(): through the surface (its tangent dW, in W's
// layout) and through the queries (the weights' tangents dtb, dta).
__device__ Bi bilinear_t(const double* W, const double* dW, int N, int NA, int mode,
                         const Br& B, const Br& A, double dtb, double dta) {
    const int k00 = (B.i - 1) * NA + A.i - 1;
    const double W00 = surf(W, N, mode, k00), W01 = surf(W, N, mode, k00 + 1);
    const double W10 = surf(W, N, mode, k00 + NA), W11 = surf(W, N, mode, k00 + NA + 1);
    const double d00 = surf(dW, N, mode, k00), d01 = surf(dW, N, mode, k00 + 1);
    const double d10 = surf(dW, N, mode, k00 + NA), d11 = surf(dW, N, mode, k00 + NA + 1);
    const double tb = B.t, ta = A.t;
    Bi o;
    o.v = (1.0 - tb) * (1.0 - ta) * d00 + (1.0 - tb) * ta * d01 + tb * (1.0 - ta) * d10
          + tb * ta * d11 + dtb * ((1.0 - ta) * (W10 - W00) + ta * (W11 - W01))
          + dta * ((1.0 - tb) * (W01 - W00) + tb * (W11 - W10));
    o.sb = B.in ? (dta * ((W11 - W01) - (W10 - W00)) + (1.0 - ta) * (d10 - d00)
                   + ta * (d11 - d01)) / (B.hi - B.lo)
                : 0.0;
    o.sa = A.in ? (dtb * ((W11 - W10) - (W01 - W00)) + (1.0 - tb) * (d01 - d00)
                   + tb * (d11 - d10)) / (A.hi - A.lo)
                : 0.0;
    return o;
}

// Breakpoint candidate k of the portfolio split at total savings s2: 0, the
// a-knots, s2 minus the b-knots, s2; clipped to [0, s2].
__device__ __forceinline__ double candidate(const double* ag, const double* bg, int NA, int NB,
                                            int k, double s2) {
    const double c = k == 0 ? 0.0
                            : (k <= NA ? ag[k - 1] : (k <= NA + NB ? s2 - bg[k - NA - 1] : s2));
    return dclip(c, 0.0, s2);
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ── The backward Bellman recursion on a thread-block cluster ────────────
// Kernel 5's design (household_sweep2.cu, two_asset_bwd_cluster_kernel):
//   - one cluster of C blocks (C = min(n_e, 16)); block r owns the incomes
//     e = r (mod C) and runs every stage for them;
//   - each block keeps the access-mixed continuations (vm_b, vm_a) of its
//     incomes; stage A reads every income's through distributed shared
//     memory and takes the income expectation;
//   - split cluster barriers: arrive after A and wait before B2 (nobody
//     reads the vm region after that, so B2 keeps the no-access consumption
//     and illiquid margin there for D); arrive after D and wait before the
//     next A;
//   - static grids bracketed by binary search; the EGM's traced knots by
//     the count of knots below the query (right for non-monotone knots);
//   - the candidates' brackets of the split's gaps (C2) depend on the static
//     grids alone: tabled once a launch where the room is; the brackets of
//     a_next(a) once a period;
//   - C1 on the threads B1 leaves idle; C2 one warp per (s, e) row over its
//     candidates, combined by butterflies; the root chain of C3 (one thread
//     a row) on whole warps beside B2; C4 and D fused per state.
// Outputs out[q][t][i4], q = B, A, C, each (Tm1, N4) with
// i4 = ((b*NA + a)*NE + e)*2 + access. Shared memory per block (doubles;
// n = G * NB * NA states and R = G * NB rows of the G incomes a block holds
// room for): vm 2n, W 2n, the EGM's knots n, the rows' 9R, the grids, two
// periods' prices (8), the period's brackets (NA doubles, NA ints), and the
// table (K * NB entries of 32 bytes, K = NA + NB + 2) where it fits.
// 512 threads, not kernel 5's 1024: at 1024 ptxas caps a thread at 64
// registers and the FP64 code spills; at 512 it takes 124 and spills
// nothing (chip_smoke.py phase 2 requires that).
//
// TANGENT: the same recursion with kernel 5's tangent formulas in double
// (its primal and tangent: torch.func.jvp of the backward scan), every
// primal expression the values kernel's, so under -fmad=false its B/A/C
// are the values kernel's bits; the tangents go to out rows 3-5. Beside
// each primal array its tangent: the vm region's (dvm_b, dvm_a) a state
// (read across the cluster in stage A as vm is; (dc, dmargin) in B2..D),
// the prices' (8), dW (2n), the knots' dimp (n), the rows' dpen, dast and
// dwkn (3R) and the brackets' weights of a_next(a) (NA). GLOBAL_TANGENT
// keeps dW and dimp, which only their own block reads, in this (path,
// block)'s slice of `tws`, a (B, C, 3n) f64 workspace the caller
// allocates (84 KB a block at 50x70x5x2), so the block holds 7n doubles
// of state where the shared-state one holds 10n. `tws` is written and read
// within the launch (not const __restrict__: no load of it takes the
// read-only path); it is null without GLOBAL_TANGENT. 256 threads: at 512
// ptxas caps a thread at 128 registers and the tangent code spills.
constexpr int kBwdThreads = 512;
constexpr int kBwdThreadsTangent = 256;

struct Cand {
    double tb, ta, c;
    int ib, ia;
};

// The backward kernel's state: the values kernel's (0), the tangent one's
// with its tangent state in shared memory (1) or dW and dimp in the
// global workspace (2).
enum BwdState { kValues = 0, kTangentShared = 1, kTangentGlobal = 2 };

size_t bwd_smem(int NB, int NA, int NE, int C, bool tabled, int state = kValues) {
    const size_t G = (NE + C - 1) / C, n = G * NB * NA, R = G * NB, K = NA + NB + 2;
    const size_t per_state = state == kValues ? 5 : (state == kTangentShared ? 10 : 7);
    const size_t tangent = state == kValues ? 0 : 3 * R + NA + 8;
    return sizeof(double) * (per_state * n + 9 * R + 2 * (size_t)NA + 2 * (size_t)NB + NE
                             + (size_t)NE * NE + 8 + tangent)
           + sizeof(int) * (size_t)NA + (tabled ? sizeof(Cand) * K * NB : 0);
}

bool bwd_tabled(int NB, int NA, int NE, int C, int state = kValues) {
    return bwd_smem(NB, NA, NE, C, true, state) <= kSmemOptin;
}

size_t bwd_smem_bytes(int NB, int NA, int NE, int C, int state = kValues) {
    return bwd_smem(NB, NA, NE, C, bwd_tabled(NB, NA, NE, C, state), state);
}

// An L2 prefetch of the line holding *p (no register waits for it).
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The path of a batched launch (blockIdx.y) times `per_path` elements; 0
// without BATCHED, which compiles it out. blockIdx.y is read anew at every
// use (a volatile read the compiler cannot hoist), so no path offset stays
// live in registers across the periods (at 1024 threads the forward kernel
// has 64 registers a thread, and the single-path kernel takes all of them).
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

// BATCHED: a grid of (C, B) blocks, one cluster per path b = blockIdx.y, which
// reads row b of each (B, Tm1) price path and writes its own (3, Tm1, N4)
// slice of out (B, 3, Tm1, N4); V_T, the grids and Pi are shared. Without it
// (the single-path entry point) the offset compiles out.
// TANGENT reads the prices' tangents dr_p, dra_p, dw_p, dtau_p ((B, Tm1)
// each) and writes out (B, 6, Tm1, N4), the B, A, C policies and their
// tangents; without it they and `tws` are unused (and null).
template <bool BATCHED, bool TANGENT = false, bool GLOBAL_TANGENT = false>
__global__ void __launch_bounds__(TANGENT ? kBwdThreadsTangent : kBwdThreads, 1)
two_asset_bwd_f64_cluster_kernel(
    const double* __restrict__ r_p, const double* __restrict__ ra_p,
    const double* __restrict__ w_p, const double* __restrict__ tau_p,
    const double* __restrict__ V_T,
    const double* __restrict__ bgrid_g, const double* __restrict__ agrid_g,
    const double* __restrict__ egrid_g, const double* __restrict__ Pi_g,
    double* __restrict__ out,
    int Tm1, int NB, int NA, int NE, double beta, double lam, double chi, double borrow,
    int tabled, const double* __restrict__ dr_p, const double* __restrict__ dra_p,
    const double* __restrict__ dw_p, const double* __restrict__ dtau_p, double* tws)
{
    constexpr int kThreads = TANGENT ? kBwdThreadsTangent : kBwdThreads;
    constexpr int kWarps = kThreads / 32;
    constexpr bool kSharedTangent = TANGENT && !GLOBAL_TANGENT;
    extern __shared__ __align__(16) unsigned char smem_bwd[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int NBA = NB * NA, NS = NB, K = NA + NB + 2;
    const int G = (NE + C - 1) / C;               // room for this many incomes
    const int own = (NE - rank + C - 1) / C;      // incomes rank, rank + C, ...
    const int n = G * NBA, R = G * NS, my_n = own * NBA, my_rows = own * NS;
    const int N4 = 2 * NBA * NE;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t TN = (size_t)Tm1 * N4;
    const double one_lam = 1.0 - lam;
    // The root chain's threads (whole warps) beside B2's.
    const int Tc = min(32 * ((my_rows + 31) / 32), kThreads / 2), Tb = kThreads - Tc;

    double2* vm = reinterpret_cast<double2*>(smem_bwd);   // (vm_b, vm_a) a state;
                                                          // (c, margin) in B2..D
    double2* dvm = vm + n;                                // TANGENT: their tangents
    Cand* tab = reinterpret_cast<Cand*>(vm + (TANGENT ? 2 : 1) * n);   // row s's K candidates
    double* W = reinterpret_cast<double*>(tab + (tabled ? K * NS : 0));   // [Wb, Wa][n]
    double* imp = W + (kSharedTangent ? 4 : 2) * n;   // implied liquid wealth (the EGM's
    double* pen = imp + (kSharedTangent ? 2 : 1) * n; // knots), B1 -> B2; per row q = gi * NS + s
    double* ast = pen + R;
    double* wkn = ast + R;
    double* scan = wkn + R;           // [lo, hi, g0, g1, g_lo, g_hi][R]
    double* aq_t = scan + 6 * R;      // the period's bracket of a_next(a) on the
    double* bg = aq_t + NA;           // illiquid grid (weights; indices in aq_i)
    double* ag = bg + NB;
    double* sg = ag + NA;             // s grid of the access EGM
    double* eg = sg + NB;
    double* Pi = eg + NE;
    double* pc = Pi + NE * NE;        // (r, ra, w, tau) of a period, two periods
    // TANGENT: the prices' tangents (as pc), the rows' tangents and the
    // tangents of the weights in aq_t.
    double* dpc = pc + 8;
    double* dpen = dpc + 8;
    double* dast = dpen + R;
    double* dwkn = dast + R;
    double* aq_dt = dwkn + R;
    int* aq_i = reinterpret_cast<int*>(TANGENT ? aq_dt + NA : pc + 8);
    // TANGENT: dW ([dWb, dWa][n]) and dimp (n), in shared memory or in the
    // block's slice of the workspace.
    double* dW = GLOBAL_TANGENT ? tws + (path_offset<BATCHED>(C) + rank) * 3 * (size_t)n
                                : W + 2 * n;
    double* dimp = GLOBAL_TANGENT ? dW + 2 * n : imp + n;
    // Threads 0-3 load period t's prices into pc[4 * (t & 1)], a period ahead
    // (TANGENT: threads 4-7 their tangents into dpc).
    const double* const prices[4] = {r_p, ra_p, w_p, tau_p};
    const double* const dprices[4] = {dr_p, dra_p, dw_p, dtau_p};

    for (int i = tid; i < NB; i += kThreads) bg[i] = bgrid_g[i];
    for (int i = tid; i < NA; i += kThreads) ag[i] = agrid_g[i];
    for (int i = tid; i < NE; i += kThreads) eg[i] = egrid_g[i];
    for (int i = tid; i < NE * NE; i += kThreads) Pi[i] = Pi_g[i];
    if (tid < 4)
        pc[4 * ((Tm1 - 1) & 1) + tid] = (prices[tid] + path_offset<BATCHED>(Tm1))[Tm1 - 1];
    if constexpr (TANGENT) {
        if (tid >= 4 && tid < 8)
            dpc[4 * ((Tm1 - 1) & 1) + tid - 4] =
                (dprices[tid - 4] + path_offset<BATCHED>(Tm1))[Tm1 - 1];
    }
    // The access mix of V_T for the own incomes (no tangent).
    for (int j = tid; j < my_n; j += kThreads) {
        const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
        const int k = (ba * NE + e) * 2;
        vm[j] = make_double2(one_lam * V_T[k] + lam * V_T[k + 1],
                             one_lam * V_T[N4 + k] + lam * V_T[N4 + k + 1]);
        if constexpr (TANGENT) dvm[j] = make_double2(0.0, 0.0);
    }
    __syncthreads();
    const double btop = bg[NB - 1], atop = ag[NA - 1];
    const double ratio = (btop + atop) / btop;
    for (int i = tid; i < NB; i += kThreads) sg[i] = bg[i] * ratio;
    __syncthreads();
    if (tabled) {
        for (int u = tid; u < NS * K; u += kThreads) {
            const int s = u / K, k = u - s * K;
            const double s2 = sg[s];
            const double c = candidate(ag, bg, NA, NB, k, s2);
            const Br Bq = bracket(bg, NB, s2 - c), Aq = bracket(ag, NA, c);
            tab[u] = Cand{Bq.t, Aq.t, c, Bq.i, Aq.i};
        }
    }
    cluster_arrive();

    for (int t = Tm1 - 1; t >= 0; --t) {
        const double* pt = pc + 4 * (t & 1);
        const double r = pt[0], ra = pt[1], w = pt[2], tau = pt[3];
        double dr = 0.0, dra = 0.0, dw = 0.0, dtau = 0.0;
        if constexpr (TANGENT) {
            const double* dpt = dpc + 4 * (t & 1);
            dr = dpt[0];
            dra = dpt[1];
            dw = dpt[2];
            dtau = dpt[3];
        }
        if (t > 0 && tid < 4)
            pc[4 * ((t - 1) & 1) + tid] = (prices[tid] + path_offset<BATCHED>(Tm1))[t - 1];
        if constexpr (TANGENT) {
            if (t > 0 && tid >= 4 && tid < 8)
                dpc[4 * ((t - 1) & 1) + tid - 4] =
                    (dprices[tid - 4] + path_offset<BATCHED>(Tm1))[t - 1];
        }
        const double one_r = 1.0 + r, one_ra = 1.0 + ra;
        const double ymax = dmax((1.0 - tau) * w, 1e-9);
        const double dymax =
            TANGENT ? tie_max((1.0 - tau) * w, 1e-9) * (-dtau * w + (1.0 - tau) * dw) : 0.0;
        // B, A, C of t (TANGENT: and their tangents, 3 * TN on)
        double* Bo = out + path_offset<BATCHED>((TANGENT ? 6 : 3) * TN) + (size_t)t * N4;

        // Every income's vm of period t + 1 is with its owner.
        cluster_wait();
        // A. Continuations: income expectation of the access mixes, floor.
        for (int j = tid; j < my_n; j += kThreads) {
            const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
            double E0 = 0.0, E1 = 0.0, dE0 = 0.0, dE1 = 0.0;
            for (int f = 0; f < NE; ++f) {
                const double2 v = cluster.map_shared_rank(vm, f % C)[(f / C) * NBA + ba];
                const double p = Pi[e * NE + f];
                E0 += v.x * p;
                E1 += v.y * p;
                if constexpr (TANGENT) {
                    const double2 dv = cluster.map_shared_rank(dvm, f % C)[(f / C) * NBA + ba];
                    dE0 += dv.x * p;
                    dE1 += dv.y * p;
                }
            }
            W[j] = dmax(beta * E0, 1e-12);
            W[n + j] = dmax(beta * E1, 1e-12);
            if constexpr (TANGENT) {
                dW[j] = tie_max(beta * E0, 1e-12) * (beta * dE0);
                dW[n + j] = tie_max(beta * E1, 1e-12) * (beta * dE1);
            }
        }
        // The period's brackets of a_next(a), on threads past the states.
        for (int a = tid - my_n; a < NA; a += kThreads) {
            if (a < 0) continue;
            const Br Q = bracket(ag, NA, dmin(one_ra * ag[a], atop));
            aq_i[a] = Q.i;
            aq_t[a] = Q.t;
            if constexpr (TANGENT) {
                const double a_raw = one_ra * ag[a];
                aq_dt[a] = bracket_t(Q, dmin(a_raw, atop), dmin_t(a_raw, dra * ag[a], atop, 0.0));
            }
        }
        // A's remote reads are done.
        cluster_arrive();
        __syncthreads();

        // B1. No access: W_b at the capped accrual point a_next(a), the
        //     implied liquid wealth of the EGM. C1, on the threads past the
        //     states: the penalty slope of the portfolio split per row.
        const double s1 = sg[1];
        for (int j = tid; j < my_n + my_rows; j += kThreads) {
            if (j < my_n) {
                const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
                const int b = ba / NA, a = ba - b * NA;
                const double a_raw = one_ra * ag[a];
                const double a_next = dmin(a_raw, atop);
                const int klo = gi * NBA + b * NA + aq_i[a] - 1;
                const double wn0 = W[klo] + aq_t[a] * (W[klo + 1] - W[klo]);
                const double c = inv_marg(wn0);
                const double inc = (a_raw - a_next) + ymax * eg[e];
                imp[j] = (c + bg[b] - inc) / one_r;
                if constexpr (TANGENT) {
                    const double dwn0 = dW[klo] + aq_dt[a] * (W[klo + 1] - W[klo])
                                        + aq_t[a] * (dW[klo + 1] - dW[klo]);
                    const double da_raw = dra * ag[a];
                    const double dinc = (da_raw - dmin_t(a_raw, da_raw, atop, 0.0)) + dymax * eg[e];
                    dimp[j] = ((inv_marg_t(wn0, dwn0) - dinc) - imp[j] * dr) / one_r;
                }
            } else {
                const int q = j - my_n;
                if (chi > 0.0) {
                    const int gi = q / NS, s = q - gi * NS;
                    const double mid = 0.5 * sg[s];
                    const Br Bq = bracket(bg, NB, mid), Aq = bracket(ag, NA, mid);
                    const double v = bilinear_value(W + gi * NBA, n, NA, 3, Bq.i, Aq.i, Bq.t,
                                                    Aq.t);
                    pen[q] = chi * v / dmax(sg[s], s1);
                    if constexpr (TANGENT)
                        dpen[q] = chi * bilinear_value(dW + gi * NBA, n, NA, 3, Bq.i, Aq.i, Bq.t,
                                                       Aq.t) / dmax(sg[s], s1);
                } else {
                    pen[q] = 0.0;
                    if constexpr (TANGENT) dpen[q] = 0.0;
                }
            }
        }
        __syncthreads();

        // C2 and the scan of C3, one warp per row: the FOC gap at each
        //     breakpoint candidate, lane l taking candidates [l * per,
        //     (l + 1) * per); then the bracket of sign changes, combined
        //     over the lanes (NaN-propagating max and min: any order gives
        //     the same values).
        const int per = (K + 31) / 32;
        for (int q = warp; q < my_rows; q += kWarps) {
            const int gi = q / NS, s = q - gi * NS;
            const double* Wg = W + gi * NBA;
            const double s2 = sg[s];
            const double p = pen[q];
            double lo = -DBL_MAX, hi = DBL_MAX, g0 = -DBL_MAX, g1 = DBL_MAX;
            bool has_neg = false, has_pos = false;
            double g_first = 0.0, g_last = 0.0;
            for (int k = lane * per; k < min(K, (lane + 1) * per); ++k) {
                double c, v;
                if (tabled) {
                    const Cand e = tab[s * K + k];
                    c = e.c;
                    v = bilinear_value(Wg, n, NA, 2, e.ib, e.ia, e.tb, e.ta);
                } else {
                    c = candidate(ag, bg, NA, NB, k, s2);
                    const Br Bq = bracket(bg, NB, s2 - c), Aq = bracket(ag, NA, c);
                    v = bilinear_value(Wg, n, NA, 2, Bq.i, Aq.i, Bq.t, Aq.t);
                }
                const double g = chi > 0.0 ? v + p * (c - 0.5 * s2) : v;
                if (k == 0) g_first = g;
                if (k == K - 1) g_last = g;
                if (g < 0.0) {
                    has_neg = true;
                    lo = dmax(lo, c);
                    g0 = dmax(g0, g);
                } else {
                    has_pos = true;
                    hi = dmin(hi, c);
                    g1 = dmin(g1, g);
                }
            }
            for (int o = 1; o < 32; o <<= 1) {
                lo = dmax(lo, __shfl_xor_sync(0xffffffffu, lo, o));
                hi = dmin(hi, __shfl_xor_sync(0xffffffffu, hi, o));
                g0 = dmax(g0, __shfl_xor_sync(0xffffffffu, g0, o));
                g1 = dmin(g1, __shfl_xor_sync(0xffffffffu, g1, o));
            }
            has_neg = __any_sync(0xffffffffu, has_neg);
            has_pos = __any_sync(0xffffffffu, has_pos);
            g_first = __shfl_sync(0xffffffffu, g_first, 0);
            g_last = __shfl_sync(0xffffffffu, g_last, (K - 1) / per);
            if (lane == 0) {
                if (!has_neg) { lo = 0.0; g0 = -1.0; }
                if (!has_pos) { hi = s2; g1 = 1.0; }
                scan[q] = lo;
                scan[R + q] = hi;
                scan[2 * R + q] = g0;
                scan[3 * R + q] = g1;
                scan[4 * R + q] = g_first;
                scan[5 * R + q] = g_last;
            }
        }
        __syncthreads();
        // Every block has read the vm regions: this block's is scratch till D.
        cluster_wait();

        if (tid < Tb) {
            // B2. Liquid policy on the grid (traced knots: count bracket),
            //     clips, consumption, and the illiquid margin at (b', a_next).
            for (int j = tid; j < my_n; j += Tb) {
                const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
                const int b = ba / NA, a = ba - b * NA;
                const int i = ba * NE + e;
                const int col = gi * NBA + a;               // knots imp[col + k*NA]
                const double x = bg[b];
                int cnt = 0;
                for (int k = 0; k < NB; ++k) cnt += imp[col + k * NA] < x ? 1 : 0;
                const int jj = min(max(cnt, 1), NB - 1);
                const double lo = imp[col + (jj - 1) * NA], hi = imp[col + jj * NA];
                const double den = hi - lo;
                const double tt = dclip((x - lo) / (den > 0.0 ? den : 1.0), 0.0, 1.0);
                const double pol = dmin(dmax(bg[jj - 1] + tt * (bg[jj] - bg[jj - 1]), borrow),
                                        btop);
                const double a_raw = one_ra * ag[a];
                const double a_next = dmin(a_raw, atop);
                const double inc = (a_raw - a_next) + ymax * eg[e];
                const double c = dmax(one_r * x + inc - pol, 1e-12);
                Bo[2 * i] = pol;
                Bo[TN + 2 * i] = a_next;
                Bo[2 * TN + 2 * i] = c;
                double dpol = 0.0, dc = 0.0;
                if constexpr (TANGENT) {
                    // The knots carry tangents: the safe denominator's and
                    // the weight's (ops/egm.interp_columns).
                    const double safe = den > 0.0 ? den : 1.0;
                    const double dlo = dimp[col + (jj - 1) * NA], dhi = dimp[col + jj * NA];
                    const double raw = (x - lo) / safe;
                    const double draw = (-dlo - raw * (den > 0.0 ? dhi - dlo : 0.0)) / safe;
                    const double pol0 = bg[jj - 1] + tt * (bg[jj] - bg[jj - 1]);
                    dpol = dclip_t(pol0, dclip_t(raw, draw, 0.0, 1.0) * (bg[jj] - bg[jj - 1]),
                                   borrow, btop);
                    const double da_raw = dra * ag[a];
                    const double da_next = dmin_t(a_raw, da_raw, atop, 0.0);
                    const double dinc = (da_raw - da_next) + dymax * eg[e];
                    dc = tie_max(one_r * x + inc - pol, 1e-12) * (dr * x + dinc - dpol);
                    Bo[3 * TN + 2 * i] = dpol;
                    Bo[4 * TN + 2 * i] = da_next;
                    Bo[5 * TN + 2 * i] = dc;
                }

                // W_a(b', a_next) along b: W_a at a_next on the knots b' and
                // b' + 1 (B1's expression), then the lerp at the policy.
                const Br Q = bracket(bg, NB, pol);
                double wn[2];
                for (int h = 0; h < 2; ++h) {
                    const int klo = gi * NBA + (Q.i - 1 + h) * NA + aq_i[a] - 1;
                    wn[h] = W[n + klo] + aq_t[a] * (W[n + klo + 1] - W[n + klo]);
                }
                vm[j] = make_double2(c, a_raw >= atop ? 0.0 : wn[0] + Q.t * (wn[1] - wn[0]));
                if constexpr (TANGENT) {
                    double dwn[2];
                    for (int h = 0; h < 2; ++h) {
                        const int klo = gi * NBA + (Q.i - 1 + h) * NA + aq_i[a] - 1;
                        dwn[h] = dW[n + klo] + aq_dt[a] * (W[n + klo + 1] - W[n + klo])
                                 + aq_t[a] * (dW[n + klo + 1] - dW[n + klo]);
                    }
                    dvm[j] = make_double2(dc, a_raw >= atop ? 0.0
                                              : dwn[0] + bracket_t(Q, pol, dpol) * (wn[1] - wn[0])
                                                    + Q.t * (dwn[1] - dwn[0]));
                }
            }
        } else {
            // C3. Quadratic root, implicit-function step, both surfaces at
            //     the split, endogenous cash-on-hand knots; per row.
            for (int q = tid - Tb; q < my_rows; q += Tc) {
                const int gi = q / NS, s = q - gi * NS;
                const double* Wg = W + gi * NBA;
                const double s2 = sg[s];
                const double lo = scan[q], hi = scan[R + q];
                const double g0 = scan[2 * R + q], g1 = scan[3 * R + q];
                const double g_lo = scan[4 * R + q], g_hi = scan[5 * R + q];
                const double h = hi - lo;
                const double p = pen[q];
                double gm;
                {
                    const double am = 0.5 * (lo + hi);
                    const Br Bm = bracket(bg, NB, s2 - am), Am = bracket(ag, NA, am);
                    gm = bilinear_value(Wg, n, NA, 2, Bm.i, Am.i, Bm.t, Am.t);
                    if (chi > 0.0) gm = gm + p * (am - 0.5 * s2);
                }
                const double a1c = -3.0 * g0 + 4.0 * gm - g1;
                const double a2c = 2.0 * g0 - 4.0 * gm + 2.0 * g1;
                const double disc = dmax(a1c * a1c - 4.0 * a2c * g0, 0.0);
                const double sgn = a1c >= 0.0 ? 1.0 : -1.0;
                const double qq = -0.5 * (a1c + sgn * sqrt(disc));
                const double u_a = g0 / (fabs(qq) > 0.0 ? qq : 1.0);
                const double u_b = qq / (fabs(a2c) > 0.0 ? a2c : 1.0);
                const bool in01 = u_a >= 0.0 && u_a <= 1.0 && fabs(qq) > 0.0;
                const double u = dclip(in01 ? u_a : u_b, 0.0, 1.0);
                const double a_it = h > 0.0 ? lo + u * h : lo;

                // One Newton step at the root with the slope held constant.
                const Br Bn = bracket(bg, NB, s2 - a_it), An = bracket(ag, NA, a_it);
                const Bi g = bilinear(Wg, n, NA, 2, Bn, An);
                double g_at = g.v, gp = g.sa - g.sb;
                if (chi > 0.0) {
                    g_at = g_at + p * (a_it - 0.5 * s2);
                    gp = gp + p;
                }
                double a_star = dmin(dmax(a_it - g_at / dmax(gp, 1e-10), 0.0), s2);
                a_star = g_lo >= 0.0 ? 0.0 : (g_hi <= 0.0 ? s2 : a_star);

                const Br Bq = bracket(bg, NB, s2 - a_star), Aq = bracket(ag, NA, a_star);
                const Bi vb = bilinear(Wg, n, NA, 0, Bq, Aq);
                const Bi va = bilinear(Wg, n, NA, 1, Bq, Aq);
                const double wbp = vb.sa - vb.sb, wap = va.sa - va.sb;
                const double gps = wbp - wap;
                const bool ok = a_star > 0.0 && a_star < s2 && wbp >= 0.0 && wap <= 0.0
                                && gps > 1e-10;
                const double Ws = ok ? (wbp * va.v - wap * vb.v) / gps : dmax(vb.v, va.v);
                ast[q] = a_star;
                wkn[q] = inv_marg(Ws) + s2;
                if constexpr (TANGENT) {
                    // The implicit-function tangent of the root: the gap's
                    // tangent at the detached root (its queries carry none)
                    // over the detached slope, then the clip and the corners.
                    const double* dWg = dW + gi * NBA;
                    double dg_at = bilinear_value(dWg, n, NA, 2, Bn.i, An.i, Bn.t, An.t);
                    if (chi > 0.0) dg_at = dg_at + dpen[q] * (a_it - 0.5 * s2);
                    double da_star = dclip_t(a_it - g_at / dmax(gp, 1e-10),
                                             -(dg_at / dmax(gp, 1e-10)), 0.0, s2);
                    if (g_lo >= 0.0 || g_hi <= 0.0) da_star = 0.0;
                    // Both surfaces at the split (b* = s - a*), through the
                    // surfaces and the queries; the envelope combination.
                    const double dtb = bracket_t(Bq, s2 - a_star, -da_star);
                    const double dta = bracket_t(Aq, a_star, da_star);
                    const Bi dvb = bilinear_t(Wg, dWg, n, NA, 0, Bq, Aq, dtb, dta);
                    const Bi dva = bilinear_t(Wg, dWg, n, NA, 1, Bq, Aq, dtb, dta);
                    const double dwbp = dvb.sa - dvb.sb, dwap = dva.sa - dva.sb;
                    const double dWs =
                        ok ? (((dwbp * va.v + wbp * dva.v) - (dwap * vb.v + wap * dvb.v))
                              - (dwbp - dwap) * Ws) / gps
                           : dmax_t(vb.v, dvb.v, va.v, dva.v);
                    dast[q] = da_star;
                    dwkn[q] = inv_marg_t(Ws, dWs);
                }
            }
        }
        __syncthreads();

        // C4. Access branch on the grid: savings through the endogenous
        //     cash-on-hand knots, split at s*, clips, consumption. D. The
        //     envelopes of both branches, and their access mix for A.
        for (int j = tid; j < my_n; j += kThreads) {
            const int gi = j / NBA, ba = j - gi * NBA, e = rank + gi * C;
            const int b = ba / NA, a = ba - b * NA;
            const int i = ba * NE + e;
            const double* wk = wkn + gi * NS;
            const double* as = ast + gi * NS;
            const double coh = one_r * bg[b] + one_ra * ag[a] + ymax * eg[e];
            int cnt = 0;
            for (int k = 0; k < NS; ++k) cnt += wk[k] < coh ? 1 : 0;
            const int jj = min(max(cnt, 1), NS - 1);
            const double lo = wk[jj - 1], hi = wk[jj];
            const double den = hi - lo;
            const double tt = dclip((coh - lo) / (den > 0.0 ? den : 1.0), 0.0, 1.0);
            const double ps = dmax(sg[jj - 1] + tt * (sg[jj] - sg[jj - 1]), 0.0);

            // a' = interp(s-knots -> a*) at the savings policy.
            const Br Q = bracket(sg, NS, ps);
            const double pa0 = as[Q.i - 1] + Q.t * (as[Q.i] - as[Q.i - 1]);
            const double pa = dmin(dmax(pa0, 0.0), dmin(ps, atop));
            const double pb = dmin(dmax(ps - pa, borrow), btop);
            const double c1 = dmax(coh - pb - pa, 1e-12);
            Bo[2 * i + 1] = pb;
            Bo[TN + 2 * i + 1] = pa;
            Bo[2 * TN + 2 * i + 1] = c1;
            double dc1 = 0.0;
            if constexpr (TANGENT) {
                const double dcoh = dr * bg[b] + dra * ag[a] + dymax * eg[e];
                const double* dwk = dwkn + gi * NS;
                const double* das = dast + gi * NS;
                const double safe = den > 0.0 ? den : 1.0;
                const double raw = (coh - lo) / safe;
                const double draw =
                    (dcoh - dwk[jj - 1] - raw * (den > 0.0 ? dwk[jj] - dwk[jj - 1] : 0.0)) / safe;
                const double ps0 = sg[jj - 1] + tt * (sg[jj] - sg[jj - 1]);
                const double dps =
                    tie_max(ps0, 0.0) * (dclip_t(raw, draw, 0.0, 1.0) * (sg[jj] - sg[jj - 1]));
                const double dpa0 = das[Q.i - 1] + bracket_t(Q, ps, dps) * (as[Q.i] - as[Q.i - 1])
                                    + Q.t * (das[Q.i] - das[Q.i - 1]);
                const double dpa = dmin_t(dmax(pa0, 0.0), tie_max(pa0, 0.0) * dpa0,
                                          dmin(ps, atop), dmin_t(ps, dps, atop, 0.0));
                const double dpb = dclip_t(ps - pa, dps - dpa, borrow, btop);
                dc1 = tie_max(coh - pb - pa, 1e-12) * (dcoh - dpb - dpa);
                Bo[3 * TN + 2 * i + 1] = dpb;
                Bo[4 * TN + 2 * i + 1] = dpa;
                Bo[5 * TN + 2 * i + 1] = dc1;
            }

            // D. (V_b, V_a) of both branches, then their access mix.
            const double2 b2 = vm[j];                 // (c, margin) of access 0
            const double up0 = 1.0 / (b2.x * b2.x), up1 = 1.0 / (c1 * c1);
            vm[j] = make_double2(one_lam * (one_r * up0) + lam * (one_r * up1),
                                 one_lam * (one_ra * b2.y) + lam * (one_ra * up1));
            if constexpr (TANGENT) {
                // up = 1 / (c c): the reciprocal's tangent, -(c c)_t up^2.
                const double2 db2 = dvm[j];           // (dc, dmargin) of access 0
                const double dup0 = -(db2.x * b2.x + b2.x * db2.x) * (up0 * up0);
                const double dup1 = -(dc1 * c1 + c1 * dc1) * (up1 * up1);
                dvm[j] = make_double2(
                    one_lam * (dr * up0 + one_r * dup0) + lam * (dr * up1 + one_r * dup1),
                    one_lam * (dra * b2.y + one_ra * db2.y) + lam * (dra * up1 + one_ra * dup1));
            }
        }
        cluster_arrive();
    }
    // No block leaves while another may still read its shared memory.
    cluster_wait();
}

// ── The forward push on a thread-block cluster ───────────────────────────
// Kernel 6's design (household_sweep2.cu, two_asset_fwd_cluster_kernel):
//   - one cluster of C blocks (C = min(2*n_e, 16)); block r owns the groups
//     g = 2*e + acc with g = r (mod C), keeps their D, and runs their
//     lotteries and scatters; the groups run side by side;
//   - L: each source's brackets and the bitmaps of each row's and column's
//     sources (one word per 32 sources; OR commutes);
//   - R: the sources of destination (j, m) are the set bits of row j AND
//     column m. Each destination counts them per word, keeping its count
//     before every 2^shift-th word; each source computes its terms at its
//     four corners, (wj * D) * wm as the plain version's einsum forms them,
//     and writes them into their destinations' lists at its rank, so every
//     list is in ascending source order; one thread per destination sums it;
//   - M by cells: block r mixes cells [r * cells, (r + 1) * cells) of every
//     group (each H reaches that block through distributed shared memory;
//     income first, then access, as ops/transition.exog_apply) and sends
//     each D back to its group's owner; a cluster barrier before and after;
//   - the aggregates after the recursion, from each period's D in a global
//     scratch, block r taking the periods t = r (mod C), each by a fixed
//     tree (thread sums, warp butterflies, warp 0 over the warps).
constexpr int kFwdThreads = 1024;   // 32 warps: warp 0's tree takes one partial a lane
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdSources = 2;      // sources (and destinations) per thread: n_b * n_a <= 2048
constexpr int kFwdSourcesGlobal = 4;  // the same under GLOBAL_LISTS: n_b * n_a <= 4096

// Per block: the lists' entries (4 per source, TANGENT each with its
// tangent; under global_lists each source's packed brackets in their place,
// rounded up to an even count), every group's H on the block's cells, the
// own groups' D (TANGENT: and their tangents), the constants and warp
// partials (3 sums, TANGENT 6), the row and column bitmaps, each
// destination's list offset, and its count before every 2^shift-th bitmap
// word (16 bit).
size_t fwd_smem_bytes(int NB, int NA, int NE, int C, int shift, bool global_lists = false,
                      bool tangent = false) {
    const size_t NS = (size_t)NB * NA, NG = 2 * (size_t)NE, G = (NG + C - 1) / C;
    const size_t nw = (NS + 31) / 32, cells = (NS + C - 1) / C;
    const size_t counts = ((nw - 1) >> shift) + 1, kE = tangent ? 2 : 1;
    return (global_lists ? sizeof(int) * ((NS + 1) & ~(size_t)1) : sizeof(double) * kE * 4 * NS)
           + sizeof(double) * (kE * (NG * cells + G * NS) + NB + NA + (size_t)NE * NE + 4
                               + 3 * kE * kFwdWarps)
           + sizeof(unsigned) * ((NB + NA) * nw + NS + 4) + sizeof(unsigned short) * NS * counts;
}

// The least shift whose layout fits in a block (or the one keeping a single
// count per destination, which the launch then refuses).
int fwd_shift(int NB, int NA, int NE, int C, bool global_lists = false, bool tangent = false) {
    const int nw = (NB * NA + 31) / 32;
    int shift = 0;
    while ((1 << shift) < nw
           && fwd_smem_bytes(NB, NA, NE, C, shift, global_lists, tangent) > kSmemOptin)
        ++shift;
    return shift;
}

__device__ __forceinline__ double lottery_weight(const double* g, int jc, double p) {
    return dclip((p - g[jc - 1]) / (g[jc] - g[jc - 1]), 0.0, 1.0);
}

// The tangent of lottery_weight at a policy p with tangent dp.
__device__ __forceinline__ double lottery_weight_t(const double* g, int jc, double p, double dp) {
    const double h = g[jc] - g[jc - 1];
    return dclip_t((p - g[jc - 1]) / h, dp / h, 0.0, 1.0);
}

// BATCHED: a grid of (C, B) blocks, one cluster per path b = blockIdx.y. The
// three policy inputs are the rows of one (B, 3, Tm1, N4) tensor (as the
// batched backward kernel writes them; TANGENT: the six policy and tangent
// inputs of one (B, 6, Tm1, N4) tensor), so path b's start b * 3 * Tm1 * N4
// (6 * Tm1 * N4) elements on; it keeps its own Dpath (B, Tm1, N4) and writes its own row of
// out (B, 3, Tm1); D0, the grids, Pi and Pacc are shared. Without it (the
// single-path entry point) the offset compiles out.
//
// GLOBAL_LISTS: as kernel 6's (household_sweep2.cu): the lists live in this
// (path, block)'s slice of `lists_g`, a (B, C, 4 * NS) f64 workspace in
// global memory that the caller allocates (112 KB a block at 50x70), each
// source's packed brackets take their place in shared memory, a thread takes
// up to kFwdSourcesGlobal sources (n_b * n_a up to 4096), and each stage
// reads the policies where it needs them, after an L2 prefetch one group
// ahead. Terms, their order and the barriers are the shared-list kernel's,
// so the outputs are bit for bit its own on every grid both take. `lists_g`
// is written and read within the launch (not const __restrict__); without
// GLOBAL_LISTS it is null and compiled out.
//
// TANGENT: forward_iteration under torch.func.jvp, kernel 6's dual push in
// double: the policies' tangents dB, dA, dC ((Tm1, N4) each; unused and null
// without TANGENT), each list entry with its tangent term (wj D)_t wm +
// (wj D) wm_t beside the term (two doubles; a (C, 4 * NS, 2) workspace
// under GLOBAL_LISTS), H and D with their tangents (dD0 = 0), Dpath (2,
// Tm1, N4) with each period's dD, out (6, Tm1), the aggregates' tangents
// sum(p_t D + p dD) after the aggregates. Every primal expression and sum
// order is the values kernel's, so under -fmad=false its aggregates are
// that kernel's bits. The policies are read where they are needed, as
// under GLOBAL_LISTS (at 1024 threads a thread has 64 registers; the
// shared-list instantiation still spills 8 bytes, 24 loaded back, by
// ptxas' count, PERF.md §6).
template <bool BATCHED, bool GLOBAL_LISTS, bool TANGENT = false>
__global__ void __launch_bounds__(kFwdThreads, 1) two_asset_fwd_f64_cluster_kernel(
    const double* __restrict__ pB, const double* __restrict__ pA,
    const double* __restrict__ pC, const double* __restrict__ D0,
    const double* __restrict__ bgrid_g, const double* __restrict__ agrid_g,
    const double* __restrict__ Pi_g, const double* __restrict__ Pacc_g,
    double* __restrict__ Dpath, double* __restrict__ out, int Tm1, int NB, int NA, int NE,
    int shift, double* lists_g, const double* __restrict__ dB, const double* __restrict__ dA,
    const double* __restrict__ dC)
{
    constexpr int kSrc = GLOBAL_LISTS ? kFwdSourcesGlobal : kFwdSources;
    constexpr bool kRead = GLOBAL_LISTS || TANGENT;   // policies read where needed
    constexpr int kE = TANGENT ? 2 : 1;               // doubles a list entry, H and D
    constexpr int kQ = TANGENT ? 6 : 3;               // aggregates
    constexpr size_t kP = TANGENT ? 6 : 3;            // policy rows of a path (BATCHED)
    extern __shared__ __align__(16) unsigned char smem_fwd[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int NS = NB * NA, NG = 2 * NE, N4 = NS * NG;
    const int G = (NG + C - 1) / C;               // room for this many groups
    const int own = (NG - rank + C - 1) / C;      // groups rank, rank + C, ...
    const int nw = (NS + 31) >> 5;
    const int counts = ((nw - 1) >> shift) + 1;   // counts kept per destination
    const int cells = (NS + C - 1) / C;           // block r mixes cells [r * cells, ...)
    const int my_cells = max(0, min(NS - rank * cells, cells));
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t TN = (size_t)Tm1 * N4;

    double* lists = reinterpret_cast<double*>(smem_fwd);   // terms, kE * 4 * NS
    int* brk = reinterpret_cast<int*>(smem_fwd);  // GLOBAL_LISTS: (jb << 16) | ja per source
    double* Hc = GLOBAL_LISTS ? reinterpret_cast<double*>(brk + ((NS + 1) & ~1))
                              : lists + kE * 4 * NS;  // [value, tangent][NG][cells]
    double* D = Hc + kE * NG * cells;             // own groups: [value, tangent][G][NS]
    double* bg = D + kE * G * NS;
    double* ag = bg + NB;
    double* Pi = ag + NA;
    double* Pacc = Pi + NE * NE;
    double* red = Pacc + 4;                       // (kQ, kFwdWarps) warp partial sums
    unsigned* rowbits = reinterpret_cast<unsigned*>(red + kQ * kFwdWarps);  // (NB, nw)
    unsigned* colbits = rowbits + NB * nw;                                 // (NA, nw)
    int* offs = reinterpret_cast<int*>(colbits + NA * nw);  // list offset of destination d
    int* alloc = offs + NS;
    unsigned short* before = reinterpret_cast<unsigned short*>(alloc + 4);  // (NS, counts)

    for (int i = tid; i < NB; i += kFwdThreads) bg[i] = bgrid_g[i];
    for (int i = tid; i < NA; i += kFwdThreads) ag[i] = agrid_g[i];
    for (int i = tid; i < NE * NE; i += kFwdThreads) Pi[i] = Pi_g[i];
    if (tid < 4) Pacc[tid] = Pacc_g[tid];
    for (int gi = 0; gi < own; ++gi)
        for (int s = tid; s < NS; s += kFwdThreads) {
            D[gi * NS + s] = D0[s * NG + rank + gi * C];
            if constexpr (TANGENT) D[(G + gi) * NS + s] = 0.0;
        }

    // This thread's sources' policies for the next (period, group), in
    // registers (where the policies are read where needed, into L2 only).
    double npb[kFwdSources], npa[kFwdSources];
    auto prefetch = [&](int t, int gi) {
        const size_t off = path_offset<BATCHED>(kP * TN) + (size_t)t * N4 + rank + gi * C;
#pragma unroll
        for (int i = 0; i < kSrc; ++i) {
            const int s = tid + i * kFwdThreads;
            if (s < NS) {
                if constexpr (kRead) {
                    prefetch_l2(pB + off + (size_t)s * NG);
                    prefetch_l2(pA + off + (size_t)s * NG);
                    if constexpr (TANGENT) {
                        prefetch_l2(dB + off + (size_t)s * NG);
                        prefetch_l2(dA + off + (size_t)s * NG);
                    }
                } else {
                    npb[i] = pB[off + (size_t)s * NG];
                    npa[i] = pA[off + (size_t)s * NG];
                }
            }
        }
    };
    // Where the policies are read where needed: the policy of source s of
    // group g in period t.
    auto policy = [&](const double* __restrict__ p, int t, int g, int s) {
        return p[path_offset<BATCHED>(kP * TN) + (size_t)t * N4 + g + (size_t)s * NG];
    };
    prefetch(0, 0);

    for (int t = 0; t < Tm1; ++t) {
        for (int gi = 0; gi < own; ++gi) {
            const int g = rank + gi * C;
            for (int i = tid; i < (NB + NA) * nw; i += kFwdThreads) rowbits[i] = 0u;
            if (tid == 0) *alloc = 0;
            __syncthreads();
            // L. Lottery brackets of the group's sources, and the bitmaps of
            //    the two rows and two columns each source reaches (one shared
            //    atomicOr per warp and distinct bracket).
            int kjb[kFwdSources], kja[kFwdSources];
#pragma unroll
            for (int i = 0; i < kSrc; ++i) {
                const int s = tid + i * kFwdThreads;
                if (s < NS) {
                    int jbs, jas;
                    if constexpr (kRead) {
                        jbs = min(max(count_below(bg, NB, policy(pB, t, g, s)), 1), NB - 1);
                        jas = min(max(count_below(ag, NA, policy(pA, t, g, s)), 1), NA - 1);
                        if constexpr (GLOBAL_LISTS) {
                            brk[s] = (jbs << 16) | jas;
                        } else {
                            kjb[i] = jbs;
                            kja[i] = jas;
                        }
                    } else {
                        jbs = min(max(count_below(bg, NB, npb[i]), 1), NB - 1);
                        jas = min(max(count_below(ag, NA, npa[i]), 1), NA - 1);
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
            // R. Per destination: its count before every 2^shift-th bitmap
            //    word, its total and a place for its list (a warp scan, one
            //    atomicAdd per warp: where a list lies does not change its
            //    sum).
            int cnt[kSrc];
#pragma unroll
            for (int i = 0; i < kSrc; ++i) {
                cnt[i] = 0;
                const int d = tid + i * kFwdThreads;
                if (d < NS) {
                    const int j = d / NA, m = d - j * NA;
                    unsigned short* bd = before + d * counts;
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
                const int d = tid + i * kFwdThreads;
                if (d < NS) offs[d] = base;
                base += cnt[i];
            }
            __syncthreads();
            //    Each source's lottery weights and its terms at its four
            //    corners (row jb - 1 or jb, column ja - 1 or ja), each into
            //    its list at its rank: the destination's count before the
            //    source's word plus the set bits below it.
#pragma unroll
            for (int i = 0; i < kSrc; ++i) {
                const int s = tid + i * kFwdThreads;
                if (s < NS) {
                    double wbs, was, dwbs = 0.0, dwas = 0.0;
                    int jb, ja;
                    if constexpr (TANGENT) {
                        if constexpr (GLOBAL_LISTS) {
                            jb = brk[s] >> 16;
                            ja = brk[s] & 0xffff;
                        } else {
                            jb = kjb[i];
                            ja = kja[i];
                        }
                        const double pbs = policy(pB, t, g, s), pas = policy(pA, t, g, s);
                        wbs = lottery_weight(bg, jb, pbs);
                        was = lottery_weight(ag, ja, pas);
                        dwbs = lottery_weight_t(bg, jb, pbs, policy(dB, t, g, s));
                        dwas = lottery_weight_t(ag, ja, pas, policy(dA, t, g, s));
                    } else if constexpr (GLOBAL_LISTS) {
                        jb = brk[s] >> 16;
                        ja = brk[s] & 0xffff;
                        wbs = lottery_weight(bg, jb, policy(pB, t, g, s));
                        was = lottery_weight(ag, ja, policy(pA, t, g, s));
                    } else {
                        jb = kjb[i];
                        ja = kja[i];
                        wbs = lottery_weight(bg, kjb[i], npb[i]);
                        was = lottery_weight(ag, kja[i], npa[i]);
                    }
                    const double src = D[gi * NS + s];
                    const double dsrc = TANGENT ? D[(G + gi) * NS + s] : 0.0;
                    const int w = s >> 5;
                    const unsigned below = (1u << (s & 31)) - 1u;
                    double* Ls = GLOBAL_LISTS
                        ? lists_g + (path_offset<BATCHED>(C) + rank) * kE * 4 * (size_t)NS : lists;
#pragma unroll
                    for (int rc = 0; rc < 2; ++rc) {
                        const double mass = (rc == 0 ? 1.0 - wbs : wbs) * src;
                        const double dmass = TANGENT ? (rc == 0 ? -dwbs : dwbs) * src
                                                           + (rc == 0 ? 1.0 - wbs : wbs) * dsrc
                                                     : 0.0;
                        const int j = jb - 1 + rc;
                        const unsigned* rj = rowbits + j * nw;
#pragma unroll
                        for (int cc = 0; cc < 2; ++cc) {
                            const double wm = cc == 0 ? 1.0 - was : was;
                            const int m = ja - 1 + cc, d = j * NA + m;
                            const unsigned* cm = colbits + m * nw;
                            int pos = before[d * counts + (w >> shift)]
                                      + __popc(rj[w] & cm[w] & below);
                            for (int u = w & ~((1 << shift) - 1); u < w; ++u)
                                pos += __popc(rj[u] & cm[u]);
                            if constexpr (TANGENT) {
                                double* e = Ls + 2 * (offs[d] + pos);
                                e[0] = mass * wm;
                                e[1] = dmass * wm + mass * (cc == 0 ? -dwas : dwas);
                            } else {
                                Ls[offs[d] + pos] = mass * wm;
                            }
                        }
                    }
                }
            }
            if (gi + 1 < own) prefetch(t, gi + 1);
            else if (t + 1 < Tm1) prefetch(t + 1, 0);
            __syncthreads();
            //    One thread per destination sums its list in source order,
            //    and sends the sum to the block that mixes cell d.
#pragma unroll
            for (int i = 0; i < kSrc; ++i) {
                const int d = tid + i * kFwdThreads;
                if (d < NS) {
                    const double* L = (GLOBAL_LISTS ? lists_g + (path_offset<BATCHED>(C) + rank)
                                                                     * kE * 4 * (size_t)NS
                                                     : lists) + kE * offs[d];
                    double v = 0.0, dv = 0.0;
                    for (int q = 0; q < cnt[i]; ++q) {
                        v += L[kE * q];
                        if constexpr (TANGENT) dv += L[2 * q + 1];
                    }
                    const int r = d / cells;
                    double* Hr = cluster.map_shared_rank(Hc, r);
                    Hr[g * cells + d - r * cells] = v;
                    if constexpr (TANGENT) Hr[(NG + g) * cells + d - r * cells] = dv;
                }
            }
            __syncthreads();
        }
        // Every group's H of period t on this block's cells is here.
        cluster.sync();
        // M. Income then access mixing on this block's cells, every group;
        //    D goes to the block that owns its group, and to Dpath[t] for the
        //    aggregates (TANGENT: dD to Dpath[Tm1 + t]).
        double* Dt = Dpath + path_offset<BATCHED>(kE * TN) + (size_t)t * N4;
        for (int i = tid; i < my_cells * NG; i += kFwdThreads) {
            const int g2 = i % NG, c = i / NG, e2 = g2 >> 1, acc2 = g2 & 1;
            double Dn = 0.0, dDn = 0.0;
            for (int acc = 0; acc < 2; ++acc) {
                double x = 0.0, dx = 0.0;
                for (int e = 0; e < NE; ++e) {
                    x += Hc[(2 * e + acc) * cells + c] * Pi[e * NE + e2];
                    if constexpr (TANGENT) dx += Hc[(NG + 2 * e + acc) * cells + c] * Pi[e * NE + e2];
                }
                Dn += x * Pacc[acc * 2 + acc2];
                if constexpr (TANGENT) dDn += dx * Pacc[acc * 2 + acc2];
            }
            const int s = rank * cells + c;
            double* Dr = cluster.map_shared_rank(D, g2 % C);
            Dr[(g2 / C) * NS + s] = Dn;
            Dt[s * NG + g2] = Dn;
            if constexpr (TANGENT) {
                Dr[(G + g2 / C) * NS + s] = dDn;
                Dt[TN + s * NG + g2] = dDn;
            }
        }
        // Every group's D of period t is with its owner; nobody reads Hc now.
        cluster.sync();
    }

    // Aggregates, after the recursion (the last barrier made every period's
    // Dpath visible), block r taking the periods t = r (mod C): thread tid
    // sums k = tid + kFwdThreads * i, then warp butterflies and warp 0's tree.
    for (int t = rank; t < Tm1; t += C) {
        const size_t off = path_offset<BATCHED>(kP * TN) + (size_t)t * N4;
        const double* Dt = Dpath + path_offset<BATCHED>(kE * TN) + (size_t)t * N4;
        double v[kQ] = {0.0, 0.0, 0.0};
        for (int k = tid; k < N4; k += kFwdThreads) {
            const double Dn = Dt[k];
            v[0] += pB[off + k] * Dn;
            v[1] += pA[off + k] * Dn;
            v[2] += pC[off + k] * Dn;
            if constexpr (TANGENT) {
                const double dDn = Dt[TN + k];
                v[3] += dB[off + k] * Dn + pB[off + k] * dDn;
                v[4] += dA[off + k] * Dn + pA[off + k] * dDn;
                v[5] += dC[off + k] * Dn + pC[off + k] * dDn;
            }
        }
        for (int q = 0; q < kQ; ++q) {
            for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
            if (lane == 0) red[q * kFwdWarps + warp] = v[q];
        }
        __syncthreads();
        if (warp == 0) {
            for (int q = 0; q < kQ; ++q) {
                double x = red[q * kFwdWarps + lane];
                for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
                if (lane == 0)
                    out[path_offset<BATCHED>(kQ * (size_t)Tm1) + (size_t)q * Tm1 + t] = x;
            }
        }
        __syncthreads();
    }
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

// `paths` clusters of `cluster` blocks on `stream` (one path: the single-path
// kernels); cudaErrorLaunchOutOfResources when the card cannot hold one.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), int cluster, int paths, int threads,
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
// cudaError_t of the attribute calls or of cudaGetLastError() right after
// the launch; 0 means the kernel was enqueued on `stream`. Both return
// cudaErrorInvalidValue for a cluster size or a grid they do not take, and
// cudaErrorLaunchOutOfResources when the card cannot hold one such cluster.
extern "C" {

// The backward recursion on one cluster of `cluster` blocks (1 to
// min(n_e, 16)): (T-1,) f64 price paths and value_T (2, n_b, n_a, n_e, 2)
// -> out (3, T-1, n_b, n_a, n_e, 2), the B, A and C policies.
int hank_sweep2_policies_f64(const void* r, const void* ra, const void* w, const void* tau,
                             const void* V_T, const void* bgrid, const void* agrid,
                             const void* egrid, const void* Pi, void* out, int Tm1, int n_b,
                             int n_a, int n_e, int cluster, double beta, double lam,
                             double chi, double borrow_cons, void* stream) {
    if (cluster < 1 || cluster > n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1)
        return (int)cudaErrorInvalidValue;
    return (int)launch_cluster(
        two_asset_bwd_f64_cluster_kernel<false>, cluster, 1, kBwdThreads,
        bwd_smem_bytes(n_b, n_a, n_e, cluster), stream, (const double*)r, (const double*)ra,
        (const double*)w, (const double*)tau, (const double*)V_T, (const double*)bgrid,
        (const double*)agrid, (const double*)egrid, (const double*)Pi, (double*)out, Tm1, n_b,
        n_a, n_e, beta, lam, chi, borrow_cons, bwd_tabled(n_b, n_a, n_e, cluster) ? 1 : 0,
        nullptr, nullptr, nullptr, nullptr, nullptr);
}

// The backward recursion as hank_sweep2_policies_f64, with its candidates'
// brackets never tabled (the branch it takes where the table has no room),
// for a bit-for-bit comparison of the two branches on a grid that has the
// room. No route launches it.
int hank_sweep2_policies_f64_untabled(const void* r, const void* ra, const void* w,
                                      const void* tau, const void* V_T, const void* bgrid,
                                      const void* agrid, const void* egrid, const void* Pi,
                                      void* out, int Tm1, int n_b, int n_a, int n_e, int cluster,
                                      double beta, double lam, double chi, double borrow_cons,
                                      void* stream) {
    if (cluster < 1 || cluster > n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1)
        return (int)cudaErrorInvalidValue;
    return (int)launch_cluster(
        two_asset_bwd_f64_cluster_kernel<false>, cluster, 1, kBwdThreads,
        bwd_smem(n_b, n_a, n_e, cluster, false), stream, (const double*)r, (const double*)ra,
        (const double*)w, (const double*)tau, (const double*)V_T, (const double*)bgrid,
        (const double*)agrid, (const double*)egrid, (const double*)Pi, (double*)out, Tm1, n_b,
        n_a, n_e, beta, lam, chi, borrow_cons, 0, nullptr, nullptr, nullptr, nullptr, nullptr);
}

// The forward push on one cluster of `cluster` blocks (1 to min(2 * n_e,
// 16)): policies (T-1, n_b, n_a, n_e, 2) each and D0 (n_b, n_a, n_e, 2) ->
// out (3, T-1), the B, A and C aggregates; Dpath is (T-1, N4) f64 of global
// scratch (each period's D).
int hank_sweep2_forward_f64(const void* pB, const void* pA, const void* pC, const void* D0,
                            const void* bgrid, const void* agrid, const void* Pi,
                            const void* Pacc, void* Dpath, void* out, int Tm1, int n_b,
                            int n_a, int n_e, int cluster, void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1
        || n_b * n_a > kFwdSources * kFwdThreads)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_shift(n_b, n_a, n_e, cluster);
    return (int)launch_cluster(
        two_asset_fwd_f64_cluster_kernel<false, false>, cluster, 1, kFwdThreads,
        fwd_smem_bytes(n_b, n_a, n_e, cluster, shift), stream, (const double*)pB,
        (const double*)pA, (const double*)pC, (const double*)D0, (const double*)bgrid,
        (const double*)agrid, (const double*)Pi, (const double*)Pacc, (double*)Dpath,
        (double*)out, Tm1, n_b, n_a, n_e, shift, nullptr, nullptr, nullptr, nullptr);
}

// The forward push with its lists in global memory
// (two_asset_fwd_f64_cluster_kernel<false, true>): the arguments of
// hank_sweep2_forward_f64, and `lists` (cluster, 4 * n_b * n_a) f64 of
// global scratch after Dpath. Takes n_b * n_a up to 4096 where
// hank_sweep2_f64_smem_bytes(2, ...) fits; bit for bit
// hank_sweep2_forward_f64 on every grid both take.
int hank_sweep2_forward_f64_global(const void* pB, const void* pA, const void* pC,
                                   const void* D0, const void* bgrid, const void* agrid,
                                   const void* Pi, const void* Pacc, void* Dpath, void* lists,
                                   void* out, int Tm1, int n_b, int n_a, int n_e, int cluster,
                                   void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1
        || n_b * n_a > kFwdSourcesGlobal * kFwdThreads || lists == nullptr)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_shift(n_b, n_a, n_e, cluster, true);
    return (int)launch_cluster(
        two_asset_fwd_f64_cluster_kernel<false, true>, cluster, 1, kFwdThreads,
        fwd_smem_bytes(n_b, n_a, n_e, cluster, shift, true), stream, (const double*)pB,
        (const double*)pA, (const double*)pC, (const double*)D0, (const double*)bgrid,
        (const double*)agrid, (const double*)Pi, (const double*)Pacc, (double*)Dpath,
        (double*)out, Tm1, n_b, n_a, n_e, shift, (double*)lists, nullptr, nullptr, nullptr);
}

// The backward recursion over B paths, one cluster of `cluster` blocks per
// path: (B, Tm1) price paths -> out (B, 3, Tm1, n_b, n_a, n_e, 2). Row b is
// the single-path launch on row b, bit for bit, at any cluster size.
// cudaErrorInvalidValue also for B outside [1, 65535].
int hank_sweep2_policies_f64_batch(const void* r, const void* ra, const void* w,
                                   const void* tau, const void* V_T, const void* bgrid,
                                   const void* agrid, const void* egrid, const void* Pi,
                                   void* out, int Tm1, int n_b, int n_a, int n_e, int cluster,
                                   int B, double beta, double lam, double chi,
                                   double borrow_cons, void* stream) {
    if (cluster < 1 || cluster > n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1
        || B < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    return (int)launch_cluster(
        two_asset_bwd_f64_cluster_kernel<true>, cluster, B, kBwdThreads,
        bwd_smem_bytes(n_b, n_a, n_e, cluster), stream, (const double*)r, (const double*)ra,
        (const double*)w, (const double*)tau, (const double*)V_T, (const double*)bgrid,
        (const double*)agrid, (const double*)egrid, (const double*)Pi, (double*)out, Tm1, n_b,
        n_a, n_e, beta, lam, chi, borrow_cons, bwd_tabled(n_b, n_a, n_e, cluster) ? 1 : 0,
        nullptr, nullptr, nullptr, nullptr, nullptr);
}

// The forward push over B paths, one cluster of `cluster` blocks per path:
// pol is the (B, 3, Tm1, n_b, n_a, n_e, 2) output of the batched backward
// kernel, Dpath (B, Tm1, N4) f64 of global scratch -> out (B, 3, Tm1). Row b
// is the single-path launch on row b, bit for bit, at any cluster size.
// cudaErrorInvalidValue also for B outside [1, 65535].
int hank_sweep2_forward_f64_batch(const void* pol, const void* D0, const void* bgrid,
                                  const void* agrid, const void* Pi, const void* Pacc,
                                  void* Dpath, void* out, int Tm1, int n_b, int n_a, int n_e,
                                  int cluster, int B, void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1
        || n_b * n_a > kFwdSources * kFwdThreads || B < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_shift(n_b, n_a, n_e, cluster);
    const double* p = static_cast<const double*>(pol);
    const size_t TN = (size_t)Tm1 * (2 * (size_t)n_b * n_a * n_e);
    return (int)launch_cluster(
        two_asset_fwd_f64_cluster_kernel<true, false>, cluster, B, kFwdThreads,
        fwd_smem_bytes(n_b, n_a, n_e, cluster, shift), stream, p, p + TN, p + 2 * TN,
        (const double*)D0, (const double*)bgrid, (const double*)agrid, (const double*)Pi,
        (const double*)Pacc, (double*)Dpath, (double*)out, Tm1, n_b, n_a, n_e, shift, nullptr, nullptr, nullptr, nullptr);
}

// The global-list forward push over B paths
// (two_asset_fwd_f64_cluster_kernel<true, true>): the arguments of
// hank_sweep2_forward_f64_batch, and `lists` (B, cluster, 4 * n_b * n_a) f64
// of global scratch after Dpath. Row b is the single-path launch on row b,
// bit for bit, at any cluster size.
int hank_sweep2_forward_f64_global_batch(const void* pol, const void* D0, const void* bgrid,
                                         const void* agrid, const void* Pi, const void* Pacc,
                                         void* Dpath, void* lists, void* out, int Tm1, int n_b,
                                         int n_a, int n_e, int cluster, int B, void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1
        || n_b * n_a > kFwdSourcesGlobal * kFwdThreads || B < 1 || B > 65535
        || lists == nullptr)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_shift(n_b, n_a, n_e, cluster, true);
    const double* p = static_cast<const double*>(pol);
    const size_t TN = (size_t)Tm1 * (2 * (size_t)n_b * n_a * n_e);
    return (int)launch_cluster(
        two_asset_fwd_f64_cluster_kernel<true, true>, cluster, B, kFwdThreads,
        fwd_smem_bytes(n_b, n_a, n_e, cluster, shift, true), stream, p, p + TN, p + 2 * TN,
        (const double*)D0, (const double*)bgrid, (const double*)agrid, (const double*)Pi,
        (const double*)Pacc, (double*)Dpath, (double*)out, Tm1, n_b, n_a, n_e, shift,
        (double*)lists, nullptr, nullptr, nullptr);
}

// The tangent pair (TANGENT). The backward recursion with tangents on one
// cluster of `cluster` blocks (1 to min(n_e, 16)): (T-1,) f64 price paths
// and their tangents, value_T (no tangent) -> out (6, T-1, n_b, n_a, n_e,
// 2), the B, A, C policies and their tangents. global_state 0 keeps the
// tangent state in shared memory (<false, true, false>, `tws` null), 1 dW
// and dimp in `tws`, (cluster, 3 * G * n_b * n_a) f64 of global scratch
// with G = ceil(n_e / cluster) (<false, true, true>); untabled 0 tables
// the candidates' brackets where the instantiation's room is, 1 never
// tables them (the branch it takes where the table has no room, for a
// bit-for-bit comparison of the two where both fit; no route asks it).
// Rows 0-2 are the values kernel's policies, bit for bit.
int hank_sweep2_policies_jvp_f64(const void* r, const void* ra, const void* w, const void* tau,
                                 const void* dr, const void* dra, const void* dw,
                                 const void* dtau, const void* V_T, const void* bgrid,
                                 const void* agrid, const void* egrid, const void* Pi,
                                 void* tws, void* out, int Tm1, int n_b, int n_a, int n_e,
                                 int cluster, int global_state, int untabled, double beta,
                                 double lam, double chi, double borrow_cons, void* stream) {
    if (cluster < 1 || cluster > n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1
        || (global_state != 0 && global_state != 1) || (global_state == 1 && tws == nullptr)
        || (untabled != 0 && untabled != 1))
        return (int)cudaErrorInvalidValue;
    const int state = global_state ? kTangentGlobal : kTangentShared;
    const bool tabled = !untabled && bwd_tabled(n_b, n_a, n_e, cluster, state);
    auto kernel = global_state ? two_asset_bwd_f64_cluster_kernel<false, true, true>
                               : two_asset_bwd_f64_cluster_kernel<false, true, false>;
    return (int)launch_cluster(
        kernel, cluster, 1, kBwdThreadsTangent, bwd_smem(n_b, n_a, n_e, cluster, tabled, state),
        stream, (const double*)r, (const double*)ra, (const double*)w, (const double*)tau,
        (const double*)V_T, (const double*)bgrid, (const double*)agrid, (const double*)egrid,
        (const double*)Pi, (double*)out, Tm1, n_b, n_a, n_e, beta, lam, chi, borrow_cons,
        tabled ? 1 : 0, (const double*)dr, (const double*)dra, (const double*)dw,
        (const double*)dtau, global_state ? (double*)tws : nullptr);
}

// The forward push with tangents on one cluster of `cluster` blocks (1 to
// min(2 * n_e, 16)): policies and their tangents (T-1, n_b, n_a, n_e, 2)
// each and D0 -> out (6, T-1), the B, A, C aggregates and their tangents;
// Dpath is (2, T-1, N4) f64 of global scratch (each period's D and dD).
// global_lists 0 keeps the lists in shared memory (<false, false, true>,
// n_b * n_a up to 2048, `lists` null), 1 in `lists`, (cluster, 4 * n_b *
// n_a, 2) f64 of global scratch (<false, true, true>, to 4096). Rows 0-2
// are the values kernel's aggregates, bit for bit.
int hank_sweep2_forward_jvp_f64(const void* pB, const void* pA, const void* pC,
                                const void* dB, const void* dA, const void* dC, const void* D0,
                                const void* bgrid, const void* agrid, const void* Pi,
                                const void* Pacc, void* Dpath, void* lists, void* out, int Tm1,
                                int n_b, int n_a, int n_e, int cluster, int global_lists,
                                void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1
        || (global_lists != 0 && global_lists != 1) || (global_lists == 1 && lists == nullptr)
        || n_b * n_a > (global_lists ? kFwdSourcesGlobal : kFwdSources) * kFwdThreads)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_shift(n_b, n_a, n_e, cluster, global_lists, true);
    auto kernel = global_lists ? two_asset_fwd_f64_cluster_kernel<false, true, true>
                               : two_asset_fwd_f64_cluster_kernel<false, false, true>;
    return (int)launch_cluster(
        kernel, cluster, 1, kFwdThreads,
        fwd_smem_bytes(n_b, n_a, n_e, cluster, shift, global_lists, true), stream,
        (const double*)pB, (const double*)pA, (const double*)pC, (const double*)D0,
        (const double*)bgrid, (const double*)agrid, (const double*)Pi, (const double*)Pacc,
        (double*)Dpath, (double*)out, Tm1, n_b, n_a, n_e, shift,
        global_lists ? (double*)lists : nullptr, (const double*)dB, (const double*)dA,
        (const double*)dC);
}

// The tangent pair over B paths, one cluster of `cluster` blocks per path
// (<true, true, *>, <true, *, true>); row b of each is the single-path
// launch on row b, bit for bit, at any cluster size. cudaErrorInvalidValue
// also for B outside [1, 65535]. The backward recursion: (B, T-1) price paths
// and their tangents -> out (B, 6, T-1, n_b, n_a, n_e, 2); global_state 1
// keeps dW and dimp in `tws`, (B, cluster, 3 * G * n_b * n_a) f64.
int hank_sweep2_policies_jvp_f64_batch(const void* r, const void* ra, const void* w,
                                       const void* tau, const void* dr, const void* dra,
                                       const void* dw, const void* dtau, const void* V_T,
                                       const void* bgrid, const void* agrid, const void* egrid,
                                       const void* Pi, void* tws, void* out, int Tm1, int n_b,
                                       int n_a, int n_e, int cluster, int B, int global_state,
                                       double beta, double lam, double chi, double borrow_cons,
                                       void* stream) {
    if (cluster < 1 || cluster > n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1
        || B < 1 || B > 65535 || (global_state != 0 && global_state != 1)
        || (global_state == 1 && tws == nullptr))
        return (int)cudaErrorInvalidValue;
    const int state = global_state ? kTangentGlobal : kTangentShared;
    const bool tabled = bwd_tabled(n_b, n_a, n_e, cluster, state);
    auto kernel = global_state ? two_asset_bwd_f64_cluster_kernel<true, true, true>
                               : two_asset_bwd_f64_cluster_kernel<true, true, false>;
    return (int)launch_cluster(
        kernel, cluster, B, kBwdThreadsTangent, bwd_smem(n_b, n_a, n_e, cluster, tabled, state),
        stream, (const double*)r, (const double*)ra, (const double*)w, (const double*)tau,
        (const double*)V_T, (const double*)bgrid, (const double*)agrid, (const double*)egrid,
        (const double*)Pi, (double*)out, Tm1, n_b, n_a, n_e, beta, lam, chi, borrow_cons,
        tabled ? 1 : 0, (const double*)dr, (const double*)dra, (const double*)dw,
        (const double*)dtau, global_state ? (double*)tws : nullptr);
}

// The forward push with tangents over B paths: pol is the (B, 6, T-1, n_b,
// n_a, n_e, 2) output of hank_sweep2_policies_jvp_f64_batch, Dpath (B, 2,
// T-1, N4) f64 of global scratch -> out (B, 6, T-1); global_lists 1 keeps
// the lists in `lists`, (B, cluster, 4 * n_b * n_a, 2) f64.
int hank_sweep2_forward_jvp_f64_batch(const void* pol, const void* D0, const void* bgrid,
                                      const void* agrid, const void* Pi, const void* Pacc,
                                      void* Dpath, void* lists, void* out, int Tm1, int n_b,
                                      int n_a, int n_e, int cluster, int B, int global_lists,
                                      void* stream) {
    if (cluster < 1 || cluster > 2 * n_e || cluster > 16 || n_b < 2 || n_a < 2 || Tm1 < 1
        || B < 1 || B > 65535 || (global_lists != 0 && global_lists != 1)
        || (global_lists == 1 && lists == nullptr)
        || n_b * n_a > (global_lists ? kFwdSourcesGlobal : kFwdSources) * kFwdThreads)
        return (int)cudaErrorInvalidValue;
    const int shift = fwd_shift(n_b, n_a, n_e, cluster, global_lists, true);
    auto kernel = global_lists ? two_asset_fwd_f64_cluster_kernel<true, true, true>
                               : two_asset_fwd_f64_cluster_kernel<true, false, true>;
    const double* p = static_cast<const double*>(pol);
    const size_t TN = (size_t)Tm1 * (2 * (size_t)n_b * n_a * n_e);
    return (int)launch_cluster(
        kernel, cluster, B, kFwdThreads,
        fwd_smem_bytes(n_b, n_a, n_e, cluster, shift, global_lists, true), stream, p, p + TN,
        p + 2 * TN, (const double*)D0, (const double*)bgrid, (const double*)agrid,
        (const double*)Pi, (const double*)Pacc, (double*)Dpath, (double*)out, Tm1, n_b, n_a, n_e,
        shift, global_lists ? (double*)lists : nullptr, p + 3 * TN, p + 4 * TN, p + 5 * TN);
}

// How many clusters of `cluster` blocks of the batched backward kernel
// (which = 0), forward kernel (which = 1) or global-list forward kernel
// (which = 2), or of the batched tangent pair's (which as
// hank_sweep2_f64_smem_bytes numbers them: 4 and 8 the backward kernel, 5
// and 6 the forward push), the card holds at once, at an n_b x n_a x n_e x 2
// grid (cudaOccupancyMaxActiveClusters), or -cudaError_t.
int hank_sweep2_f64_max_clusters(int which, int n_b, int n_a, int n_e, int cluster) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int clusters = 0;
    if (which == 4 || which == 8) {
        const int state = which == 8 ? kTangentGlobal : kTangentShared;
        const cudaError_t err = cluster_config(
            which == 8 ? two_asset_bwd_f64_cluster_kernel<true, true, true>
                       : two_asset_bwd_f64_cluster_kernel<true, true, false>,
            cluster, 1, kBwdThreadsTangent, bwd_smem_bytes(n_b, n_a, n_e, cluster, state), nullptr,
            cfg, attr, clusters);
        return err != cudaSuccess ? -(int)err : clusters;
    }
    if (which == 5 || which == 6) {
        const bool global_lists = which == 6;
        const cudaError_t err = cluster_config(
            global_lists ? two_asset_fwd_f64_cluster_kernel<true, true, true>
                         : two_asset_fwd_f64_cluster_kernel<true, false, true>,
            cluster, 1, kFwdThreads,
            fwd_smem_bytes(n_b, n_a, n_e, cluster,
                           fwd_shift(n_b, n_a, n_e, cluster, global_lists, true), global_lists,
                           true),
            nullptr, cfg, attr, clusters);
        return err != cudaSuccess ? -(int)err : clusters;
    }
    const cudaError_t err =
        which == 0 ? cluster_config(two_asset_bwd_f64_cluster_kernel<true>, cluster, 1,
                                    kBwdThreads, bwd_smem_bytes(n_b, n_a, n_e, cluster),
                                    nullptr, cfg, attr, clusters)
        : which == 1 ? cluster_config(two_asset_fwd_f64_cluster_kernel<true, false>, cluster, 1,
                                      kFwdThreads,
                                      fwd_smem_bytes(n_b, n_a, n_e, cluster,
                                                     fwd_shift(n_b, n_a, n_e, cluster)),
                                      nullptr, cfg, attr, clusters)
                     : cluster_config(two_asset_fwd_f64_cluster_kernel<true, true>, cluster, 1,
                                      kFwdThreads,
                                      fwd_smem_bytes(n_b, n_a, n_e, cluster,
                                                     fwd_shift(n_b, n_a, n_e, cluster, true),
                                                     true),
                                      nullptr, cfg, attr, clusters);
    return err != cudaSuccess ? -(int)err : clusters;
}

// Dynamic shared memory per block of the backward kernel (which = 0; tabled
// where the room is), of the forward kernel (which = 1; at the least shift
// that fits, or at its largest), of the global-list forward kernel (which =
// 2; as 1) or of the backward kernel untabled (which = 3) on a cluster of
// `cluster` blocks; and of the tangent pair: the backward kernel with its
// tangent state in shared memory (4; tabled where the room is), the
// forward kernel with shared lists (5) and global lists (6; as 1), the
// backward kernel of 4 untabled (7), with dW and dimp in the workspace
// (8; tabled where the room is) and that one untabled (9).
size_t hank_sweep2_f64_smem_bytes(int which, int n_b, int n_a, int n_e, int cluster) {
    switch (which) {
    case 0: return bwd_smem_bytes(n_b, n_a, n_e, cluster);
    case 1: return fwd_smem_bytes(n_b, n_a, n_e, cluster, fwd_shift(n_b, n_a, n_e, cluster));
    case 2: return fwd_smem_bytes(n_b, n_a, n_e, cluster,
                                  fwd_shift(n_b, n_a, n_e, cluster, true), true);
    case 4: return bwd_smem_bytes(n_b, n_a, n_e, cluster, kTangentShared);
    case 5: return fwd_smem_bytes(n_b, n_a, n_e, cluster,
                                  fwd_shift(n_b, n_a, n_e, cluster, false, true), false, true);
    case 6: return fwd_smem_bytes(n_b, n_a, n_e, cluster,
                                  fwd_shift(n_b, n_a, n_e, cluster, true, true), true, true);
    case 7: return bwd_smem(n_b, n_a, n_e, cluster, false, kTangentShared);
    case 8: return bwd_smem_bytes(n_b, n_a, n_e, cluster, kTangentGlobal);
    case 9: return bwd_smem(n_b, n_a, n_e, cluster, false, kTangentGlobal);
    default: return bwd_smem(n_b, n_a, n_e, cluster, false);
    }
}

const char* hank_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
