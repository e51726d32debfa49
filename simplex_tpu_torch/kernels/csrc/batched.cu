// Hand-written Hopper (sm_90a) kernels of the batched window solve: the CUDA
// counterparts of the Pallas passes in simplex_tpu/kernels/batched.py and
// simplex_tpu/kernels/batched_hbm.py.
//
// Layout (row-major, contiguous; B lanes stacked on the leading axis, one
// independent LP per lane):
//   Tt (B*M, R) f32         the lanes' stale transposed tableaus
//   costs, c0 (B, R) f64    working and original reduced costs
//   b, cf (B, M) f64        right-hand sides; basic original costs c0[base]
//   z (B,) f64, base (B, M) i32, devex weights w (B, R) f32 (or null)
//   sci (B, 8) i32          [status, iters, stall, bland, active, max_iter,
//                            unused, unused] -- only slots 0-3 are written
//   C (B*L, R), F (B*L, M), AH (B*L, M) f32
//                           the window's pivot rows, eta rows and live
//                           entering columns (row s of a lane = its pivot s)
//   piv (B*L, 2) i32        the window's walk [h, k], -1 past the last pivot
//   nlive (B,) i32          the pivots each lane applied in the window
// M and R are multiples of 128, L a multiple of 8 (checked by the Python
// wrappers). Lanes are independent: every index (h, k, base, the eta rows)
// is lane-local and every offset is size_t (B*M*R reaches 4.0e8 elements
// at 256 lanes of m = 500 x n = 2,000).
//
// Every kernel launches on the caller's stream and allocates nothing; each
// C entry point returns cudaGetLastError() after its launches. Reductions
// never use atomics: a block folds in a fixed shuffle tree, and every fold
// orders candidates by (key, then lowest index), a total order, so the
// walks repeat run to run. The f64 vector updates use the _rn intrinsics,
// so nvcc does not contract them into FMAs and they round exactly as the
// plain PyTorch versions do.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "apply_tile.cuh"

namespace {

constexpr int BIG_INDEX = 2147483647;
constexpr int WT = 512;              // threads of a lane's window block
constexpr int WARPS = WT / 32;
constexpr int LMAX = 128;            // the largest window L
constexpr int FIN_THREADS = 256;
constexpr int RUNNING = -10;
constexpr int OPTIMAL = 0;
constexpr int UNBOUNDED = -2;
constexpr unsigned FULL = 0xffffffffu;

// A candidate fold: the best (key, lowest idx) carrying val, and the lowest
// eligible index bidx carrying bval (the Bland candidate).
struct Cand {
    double key;
    int idx;
    double val;
    int bidx;
    double bval;
};

__device__ __forceinline__ Cand no_cand() {
    return Cand{-CUDART_INF, BIG_INDEX, CUDART_INF, BIG_INDEX, CUDART_INF};
}

__device__ __forceinline__ void merge(Cand &a, const Cand &o) {
    if (o.key > a.key || (o.key == a.key && o.idx < a.idx)) {
        a.key = o.key;
        a.idx = o.idx;
        a.val = o.val;
    }
    if (o.bidx < a.bidx) {
        a.bidx = o.bidx;
        a.bval = o.bval;
    }
}

__device__ __forceinline__ Cand shfl_down(const Cand &c, int off) {
    return Cand{__shfl_down_sync(FULL, c.key, off),
                __shfl_down_sync(FULL, c.idx, off),
                __shfl_down_sync(FULL, c.val, off),
                __shfl_down_sync(FULL, c.bidx, off),
                __shfl_down_sync(FULL, c.bval, off)};
}

// Block-wide fold of every thread's Cand; every thread returns the result.
__device__ Cand block_fold(Cand c, Cand *red, Cand *out) {
    for (int off = 16; off > 0; off >>= 1) merge(c, shfl_down(c, off));
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    if (ln == 0) red[warp] = c;
    __syncthreads();
    if (warp == 0) {
        c = ln < WARPS ? red[ln] : no_cand();
        for (int off = 16; off > 0; off >>= 1) merge(c, shfl_down(c, off));
        if (ln == 0) *out = c;
    }
    __syncthreads();
    return *out;
}

// Entering candidates (the single-LP rule, batch_candidates in
// simplex_tpu_torch/kernels/blocked.py): over the active columns j < r, the
// Dantzig argmin of the cost, or under devex the argmax of cost^2 / w over
// the eligible columns (cost <= -eps); the Bland candidate is the lowest
// eligible index.
template <bool DEVEX>
__device__ __forceinline__ void consider(Cand &c, int j, double cost,
                                         float wj, int r, double eps) {
    if (j >= r) return;
    const bool elig = cost <= -eps;
    if (DEVEX) {
        if (elig) {
            const double key = __ddiv_rn(__dmul_rn(cost, cost), (double)wj);
            if (key > c.key || (key == c.key && j < c.idx)) {
                c.key = key;
                c.idx = j;
                c.val = cost;
            }
        }
    } else if (-cost > c.key || (-cost == c.key && j < c.idx)) {
        c.key = -cost;
        c.idx = j;
        c.val = cost;
    }
    if (elig && j < c.bidx) {
        c.bidx = j;
        c.bval = cost;
    }
}

// NaN-propagating max/min, as torch.maximum / torch.minimum behave.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : (a > b ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : (a < b ? a : b);
}

// The lane's scalars, owned by thread 0 and read by all after a barrier.
struct LaneState {
    int status, iters, stall, bland, active0, max_iter;
    int go, h, k, lvar;
    double z, minc, u, bk;
    float p, wh;
};

// ---------------------------------------------------------------------------
// batch_window: one window of up to L deferred eta pivots per lane.
//
// Replaces the pivot loop of batch_window_pass (simplex_tpu/kernels/
// batched.py:521, pallas_call at :582; body _batch_window_kernel :364-514
// and _window_pivot_loop :96-361) and hbm_window_pass (simplex_tpu/kernels/
// batched_hbm.py:330, pallas_call at :373; body _hbm_window_kernel :64).
// Per pivot t, with the TPU kernel's per-pivot fuse (iters < max_iter):
//   h from the candidates; optimal when its cost > -eps
//   a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] F[s, j]          (AH[t])
//   k = argmin over a_h[j] >= eps of b[j] / a_h[j]   (f64, ties: lowest j)
//   colk[j] = Tt[k, j] - sum_{s<t} F[s, k] C[s, j]          (C[t])
//   u = cost[h] / p, costs -= u colk, devex weights, next candidates
//   b[j] -= b[k] a_h[j] / p, b[k] /= p, z -= u b[k]          (f64)
//   F[t] = a_h / p with 1 - 1/p at k, base[k] = h, cf[k] = c0[h]
//   stall / Bland anti-cycling, iters += 1
// The first pivot that does not apply (lane inactive, optimal or unbounded)
// ends the lane's window: every later pivot would be skipped too. Its eta
// rows and those after it are zeros (the TPU kernel's liveness contract).
// The tableau is only read; the apply kernels below fold the etas into it.
//
// Bound on the card: latency. One block per lane runs its L pivots in
// order, each three block-wide folds and two reads of the live eta rows
// (t (R + M) 4 bytes: 0.46 MB at t = 31, R = 3,072, M = 512, computed),
// plus one strided column of Tt (M loads at stride R) and one row. The TPU
// tiers differ only in where the tableau sat (VMEM or HBM); a config-3 lane
// (6.3 MB) fits no more in 228 KB of shared memory than a 31 MB lane, so
// one kernel with the tableau in global memory serves both. Design: 512
// threads per lane, the t eta values of column h and row k staged in shared
// memory, coalesced reads of C and F, warp-shuffle folds. At 64 registers a
// thread two blocks fit an SM, so 256 lanes run in one wave on 132 SMs; at
// 32 lanes 100 SMs sit idle (clusters and DSMEM would split a lane across
// SMs: a later PR). Measured on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md):
// a 32-pivot window of 256 lanes (R = 3,072) in 1.18 ms, 37 us per pivot
// step; of 32 lanes at R = 15,104 in 2.39 ms.
template <bool DEVEX>
__global__ void __launch_bounds__(WT, 2) batch_window(
        const float *__restrict__ Tt, double *__restrict__ costs,
        double *__restrict__ b, double *__restrict__ z,
        int *__restrict__ base, float *__restrict__ w,
        int *__restrict__ sci, const double *__restrict__ c0,
        double *__restrict__ cf, float *__restrict__ C,
        float *__restrict__ F, float *__restrict__ AH,
        int *__restrict__ piv, int *__restrict__ nlive, int M, int R,
        int L, int r, double eps, int bland_static, int threshold) {
    __shared__ Cand red[WARPS];
    __shared__ Cand res;
    __shared__ float stage[LMAX];
    __shared__ LaneState s;

    const size_t lane = blockIdx.x;
    const int tid = threadIdx.x;
    const float *T = Tt + lane * M * R;
    costs += lane * R;
    c0 += lane * R;
    b += lane * M;
    cf += lane * M;
    base += lane * M;
    if (DEVEX) w += lane * R;
    sci += lane * 8;
    C += lane * L * R;
    F += lane * L * M;
    AH += lane * L * M;
    piv += lane * L * 2;
    const float feps = (float)eps;

    if (tid == 0) {
        s.status = sci[0];
        s.iters = sci[1];
        s.stall = sci[2];
        s.bland = sci[3];
        s.active0 = sci[4];
        s.max_iter = sci[5];
        s.z = z[lane];
    }
    Cand cand = no_cand();
    for (int j = tid; j < R; j += WT)
        consider<DEVEX>(cand, j, costs[j], DEVEX ? w[j] : 1.0f, r, eps);
    cand = block_fold(cand, red, &res);

    int t = 0;
    for (; t < L; ++t) {
        if (tid == 0) {
            const bool active = s.active0 != 0 && s.status == RUNNING
                                && s.iters < s.max_iter;
            const bool none = cand.key == -CUDART_INF;
            const bool use_b = s.bland != 0 && cand.bidx < BIG_INDEX;
            s.h = use_b ? cand.bidx : (none ? 0 : cand.idx);
            s.minc = use_b ? cand.bval : (none ? CUDART_INF : cand.val);
            const bool optimal = s.minc > -eps;
            if (active && optimal) s.status = OPTIMAL;
            s.go = active && !optimal;
        }
        __syncthreads();
        if (!s.go) break;
        const int h = s.h;

        // Live entering column and the min-ratio test.
        for (int q = tid; q < t; q += WT) stage[q] = C[(size_t)q * R + h];
        __syncthreads();
        Cand rc = no_cand();
        for (int j = tid; j < M; j += WT) {
            float acc = 0.0f;
            for (int q = 0; q < t; ++q)
                acc = fmaf(stage[q], F[(size_t)q * M + j], acc);
            const float a = __fsub_rn(T[(size_t)j * R + h], acc);
            AH[(size_t)t * M + j] = a;
            if (a >= feps) {
                const double key = -__ddiv_rn(b[j], (double)a);
                if (key > rc.key || (key == rc.key && j < rc.idx)) {
                    rc.key = key;
                    rc.idx = j;
                }
            }
        }
        rc = block_fold(rc, red, &res);
        if (tid == 0) {
            if (rc.idx == BIG_INDEX) {
                s.status = UNBOUNDED;
                s.go = 0;
            } else {
                const int k = rc.idx;
                s.k = k;
                s.p = AH[(size_t)t * M + k];
                s.bk = b[k];
                s.u = __ddiv_rn(s.minc, (double)s.p);
                s.lvar = base[k];
                s.wh = DEVEX ? w[h] : 0.0f;
            }
        }
        __syncthreads();
        if (!s.go) break;
        const int k = s.k;
        const float p = s.p;
        const double u = s.u;

        // Pivot row, costs, devex weights and the next candidates.
        for (int q = tid; q < t; q += WT) stage[q] = F[(size_t)q * M + k];
        __syncthreads();
        cand = no_cand();
        for (int j = tid; j < R; j += WT) {
            float acc = 0.0f;
            for (int q = 0; q < t; ++q)
                acc = fmaf(stage[q], C[(size_t)q * R + j], acc);
            const float colk = __fsub_rn(T[(size_t)k * R + j], acc);
            C[(size_t)t * R + j] = colk;
            const double c = __dsub_rn(costs[j], __dmul_rn(u, (double)colk));
            costs[j] = c;
            float wj = 1.0f;
            if (DEVEX) {
                const float wh = s.wh;
                const float alpha = __fdiv_rn(colk, p);
                float w2 = max_nan(w[j], __fmul_rn(__fmul_rn(alpha, alpha),
                                                   wh));
                if (j == s.lvar)
                    w2 = max_nan(__fdiv_rn(wh, __fmul_rn(p, p)), 1.0f);
                w2 = min_nan(w2, 1e12f);
                if (w2 != w2) w2 = 1.0f;
                w[j] = w2;
                wj = w2;
            }
            consider<DEVEX>(cand, j, c, wj, r, eps);
        }
        cand = block_fold(cand, red, &res);

        // b, base, cf and the eta row. a_h[j] was written by this thread.
        const double bk = s.bk;
        for (int j = tid; j < M; j += WT) {
            const float a = AH[(size_t)t * M + j];
            if (j == k) {
                b[j] = __ddiv_rn(bk, (double)p);
                F[(size_t)t * M + j] = __fsub_rn(1.0f, __fdiv_rn(1.0f, p));
                base[j] = h;
                cf[j] = c0[h];
            } else {
                const double d = __ddiv_rn((double)a, (double)p);
                b[j] = __dsub_rn(b[j], __dmul_rn(bk, d));
                F[(size_t)t * M + j] = __fdiv_rn(a, p);
            }
        }
        if (tid == 0) {
            piv[2 * t] = h;
            piv[2 * t + 1] = k;
            const double ub = __dmul_rn(u, bk);
            s.z = __dsub_rn(s.z, ub);
            const bool improved = fabs(ub) >= eps;
            s.stall = improved ? 0 : s.stall + 1;
            if (bland_static)
                s.bland = 1;
            else if (threshold < 0)
                s.bland = 0;
            else
                s.bland = (!improved && s.stall >= threshold) ? 1 : 0;
            s.iters += 1;
        }
        __syncthreads();
    }

    // Pivots t..L-1 did not apply: zero etas, no walk.
    for (size_t i = (size_t)t * R + tid; i < (size_t)L * R; i += WT)
        C[i] = 0.0f;
    for (size_t i = (size_t)t * M + tid; i < (size_t)L * M; i += WT) {
        F[i] = 0.0f;
        AH[i] = 0.0f;
    }
    for (int i = 2 * t + tid; i < 2 * L; i += WT) piv[i] = -1;
    if (tid == 0) {
        sci[0] = s.status;
        sci[1] = s.iters;
        sci[2] = s.stall;
        sci[3] = s.bland;
        z[lane] = s.z;
        nlive[lane] = t;
    }
}

// ---------------------------------------------------------------------------
// batch_apply / batch_apply_reprice: per lane Tt -= F^T C in place, with the
// reprice mv = cf^T Tt_new fused (K9) or not (K10).
//
// batch_apply_reprice replaces hbm_apply_reprice_pass (simplex_tpu/kernels/
// batched_hbm.py:214, pallas_call at :236; body _apply_reprice_kernel
// :164-210) and the in-kernel apply + fold of _batch_window_kernel
// (simplex_tpu/kernels/batched.py:436-479); batch_apply replaces
// hbm_apply_pass (batched_hbm.py:281, pallas_call at :300; body
// _apply_kernel :155) and the apply without fuse_reprice.
// Bound on the card: memory. 2 L M R flops per lane against 8 M R bytes of
// tableau read and written: 8 flops per byte at L = 32, under the H100's
// f32 ridge (~20), where K3/K4 at L = 128 sit above it. Measured on NVIDIA
// H100 80GB HBM3, 700.00 W (PERF.md): batch_apply over 256 lanes of
// 512 x 3,072 in 1.46 ms, 2.2 TB/s of tableau traffic, 66% of the 3.35
// TB/s peak. Design: K3/K4's 128 x 128 register tiles (apply_tile.cuh)
// with the lane on gridDim.z, so any R that is a multiple of 128 is covered
// (R = 15,104 = 118 tiles). A lane runs only its live eta rows (nlive,
// rounded up to 8; the rows past nlive are zero), and a lane with no live
// row skips its tiles, leaving its Tt untouched -- unless its reprice is
// due (do_r), which then runs over the unchanged tableau. The fold is f64:
// per-128-row partials, then a second pass in M order per lane,
// deterministic; a lane with do_r = 0 gets mv = 0.

template <bool REPRICE>
__global__ void __launch_bounds__(APPLY_THREADS) batch_apply_tiles(
        float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, int M, int R, int L,
        const int *__restrict__ nlive, const int *__restrict__ do_r,
        const double *__restrict__ cf, double *__restrict__ part) {
    const size_t lane = blockIdx.z;
    const int live = nlive[lane];
    const bool fold = REPRICE && do_r[lane] != 0;
    if (live == 0 && !fold) return;
    const int L_live = (live + AK - 1) / AK * AK;
    apply_tile<REPRICE>(
        Tt + lane * M * R, F + lane * L * M, C + lane * L * R, M, R, L_live,
        fold ? cf + lane * M : nullptr,
        fold ? part + (lane * (M / AT) + blockIdx.y) * R : nullptr);
}

__global__ void __launch_bounds__(FIN_THREADS) batch_reprice_finish(
        const double *__restrict__ part, const int *__restrict__ do_r,
        int n_mtiles, int R, double *__restrict__ mv) {
    const size_t lane = blockIdx.y;
    const int j = blockIdx.x * FIN_THREADS + threadIdx.x;
    if (j >= R) return;
    double s = 0.0;
    if (do_r[lane] != 0)
        for (int i = 0; i < n_mtiles; ++i)
            s = __dadd_rn(s, part[(lane * n_mtiles + i) * R + j]);
    mv[lane * R + j] = s;
}

// ---------------------------------------------------------------------------
// batch_reprice (K12): per lane mv = coeffs^T Tt in f64, gated by a flag.
//
// Replaces batch_reprice_pass (simplex_tpu/kernels/batched.py:669,
// pallas_call at :700; body _batch_reprice_kernel :631-666), which no solve
// path calls: the batched loop re-prices through batch_apply_reprice's
// fused fold. The TPU accumulated double-f32 pairs; here the fold is f64.
// Bound on the card: memory. It reads the flagged lanes' tableaus once,
// 4 M R bytes each (computed: 1.61 GB at B = 256, M = 512, R = 3,072, 0.481
// ms at 3.35 TB/s). Design: K11's tiles (apply_tile.cuh reprice_tile) with
// the lane on gridDim.z; a lane with flag 0 skips its tiles, and
// batch_reprice_finish writes it zeros. batch_apply_reprice with no live
// eta row runs the same fold, so it gives the same mv bit for bit.

__global__ void __launch_bounds__(APPLY_THREADS) batch_reprice_tiles(
        const float *__restrict__ Tt, int M, int R,
        const int *__restrict__ flags, const double *__restrict__ cf,
        double *__restrict__ part) {
    const size_t lane = blockIdx.z;
    if (flags[lane] == 0) return;
    reprice_tile(Tt + lane * M * R, R, cf + lane * M,
                 part + (lane * (M / AT) + blockIdx.y) * R);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes). Each returns cudaGetLastError() as an int.

#define RETURN_IF_ERROR()                          \
    do {                                           \
        cudaError_t e = cudaGetLastError();        \
        if (e != cudaSuccess) return (int)e;       \
    } while (0)

extern "C" {

int batch_window_launch(const float *Tt, double *costs, double *b, double *z,
                        int *base, float *w, int *sci, const double *c0,
                        double *cf, float *C, float *F, float *AH, int *piv,
                        int *nlive, int B, int M, int R, int L, int r,
                        double eps, int bland_static, int threshold,
                        void *stream) {
    if (L > LMAX) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (w != nullptr)
        batch_window<true><<<B, WT, 0, st>>>(
            Tt, costs, b, z, base, w, sci, c0, cf, C, F, AH, piv, nlive, M,
            R, L, r, eps, bland_static, threshold);
    else
        batch_window<false><<<B, WT, 0, st>>>(
            Tt, costs, b, z, base, w, sci, c0, cf, C, F, AH, piv, nlive, M,
            R, L, r, eps, bland_static, threshold);
    RETURN_IF_ERROR();
    return 0;
}

int batch_apply_launch(float *Tt, const float *F, const float *C, int B,
                       int M, int R, int L, const int *nlive, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(R / AT, M / AT, B);
    batch_apply_tiles<false><<<grid, APPLY_THREADS, 0, st>>>(
        Tt, F, C, M, R, L, nlive, nullptr, nullptr, nullptr);
    RETURN_IF_ERROR();
    return 0;
}

int batch_apply_reprice_launch(float *Tt, const float *F, const float *C,
                               int B, int M, int R, int L, const int *nlive,
                               const int *do_r, const double *cf,
                               double *part, double *mv, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(R / AT, M / AT, B);
    batch_apply_tiles<true><<<grid, APPLY_THREADS, 0, st>>>(
        Tt, F, C, M, R, L, nlive, do_r, cf, part);
    RETURN_IF_ERROR();
    const dim3 fgrid((R + FIN_THREADS - 1) / FIN_THREADS, B);
    batch_reprice_finish<<<fgrid, FIN_THREADS, 0, st>>>(part, do_r, M / AT,
                                                         R, mv);
    RETURN_IF_ERROR();
    return 0;
}

int batch_reprice_launch(const float *Tt, int B, int M, int R,
                         const int *flags, const double *cf, double *part,
                         double *mv, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(R / AT, M / AT, B);
    batch_reprice_tiles<<<grid, APPLY_THREADS, 0, st>>>(Tt, M, R, flags, cf,
                                                        part);
    RETURN_IF_ERROR();
    const dim3 fgrid((R + FIN_THREADS - 1) / FIN_THREADS, B);
    batch_reprice_finish<<<fgrid, FIN_THREADS, 0, st>>>(part, flags, M / AT,
                                                         R, mv);
    RETURN_IF_ERROR();
    return 0;
}

}  // extern "C"
