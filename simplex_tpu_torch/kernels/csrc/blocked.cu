// Hand-written Hopper (sm_90a) kernels of the deferred block-pivot loop:
// the CUDA counterparts of the Pallas passes in
// simplex_tpu/kernels/blocked.py.
//
// Layout (all row-major, contiguous): the stale transposed tableau
// Tt (M, R) f32; the eta factors C (L, R) f32 (row s = leaving row of pivot
// s) and F (L, M) f32 (row s = eta row of pivot s); the vectors b (M,),
// costs (R,) and the reprice coefficients (M,) in native f64. M and R are
// multiples of 128, L a multiple of 8 (checked by the Python wrappers).
// Only eta rows s < t are live inside a window: the TPU kernels skipped the
// dead segments through their index maps, here t is the loop bound.
//
// Every kernel launches on the caller's stream, allocates nothing, and each
// C entry point returns cudaGetLastError() after its launches. Cross-block
// reductions never use atomics: each block writes one partial, and a
// one-block pass folds the partials in a fixed order, so the pivot choices
// (and therefore the walks) are the same from run to run. Every fold orders
// candidates by (key, then lowest index).
//
// Offsets into Tt, C and F are computed in size_t: at 10k x 100k the
// tableau holds 1.2e9 elements and its byte offsets overflow a 32-bit int.
//
// f64 vector updates use the _rn intrinsics so that nvcc does not contract
// them into FMAs: they then round exactly as the plain PyTorch versions do.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "apply_tile.cuh"

namespace {

constexpr int BIG_INDEX = 2147483647;
constexpr int THREADS = 256;

__device__ __forceinline__ bool better(double ka, int ia, double kb, int ib) {
    return ka > kb || (ka == kb && ia < ib);
}

// Block-wide argmax of (key, idx) carrying val; ties go to the lowest index.
// The order is total for non-NaN keys, so the result does not depend on the
// tree's shape.
__device__ void block_argmax(double &key, int &idx, double &val) {
    __shared__ double sk[THREADS];
    __shared__ int si[THREADS];
    __shared__ double sv[THREADS];
    const int tid = threadIdx.x;
    sk[tid] = key;
    si[tid] = idx;
    sv[tid] = val;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (tid < s && better(sk[tid + s], si[tid + s], sk[tid], si[tid])) {
            sk[tid] = sk[tid + s];
            si[tid] = si[tid + s];
            sv[tid] = sv[tid + s];
        }
        __syncthreads();
    }
    key = sk[0];
    idx = si[0];
    val = sv[0];
    __syncthreads();
}

// NaN-propagating max/min, as jnp.maximum / torch.maximum behave.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : (a > b ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : (a < b ? a : b);
}

// ---------------------------------------------------------------------------
// K1: live entering column + min-ratio test.
//
// Replaces ah_ratio_pass (simplex_tpu/kernels/blocked.py:1201, pallas_call at
// :1273; body _ah_ratio_kernel :1090, _ah_accumulate :1061, _ah_column :1075).
//   a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] * F[s, j]
//   k = argmin over {j : a_h[j] >= eps} of b[j] / a_h[j] (ties: lowest j)
// Bound on the card: latency. Per pivot it reads the live F rows (t * M * 4
// bytes, computed: 1.2 MB at t = 37, M = 8192) and one strided element of Tt
// per constraint (stride R: one 32-byte sector per load, M loads in all; left
// as it is), on only M / 256 blocks; measured 6.0 us per call at those shapes
// on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md), ~0.25 TB/s. Design: one
// thread per constraint with coalesced F reads, the t values C[:, h] staged
// once in shared memory; each block folds its ratio candidates and a
// one-block pass folds the blocks (the TPU carried this fold across its
// sequential grid in SMEM scratch). The ratio is a native f64 quotient (the
// TPU formed it from double-f32 pairs).

// The live entering column, shared by K1 and K5 so that the two give the
// same a_h bit for bit. ah_stage puts C[s, h] for s < t into the block's
// shared memory ch (the whole block calls it); ah_entry is then
//   a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] * F[s, j]
// with the eta correction summed in s order in FFMA.
__device__ __forceinline__ void ah_stage(const float *__restrict__ C, int h,
                                         int t, int R, float *ch) {
    for (int s = threadIdx.x; s < t; s += blockDim.x)
        ch[s] = C[(size_t)s * R + h];
    __syncthreads();
}

__device__ __forceinline__ float ah_entry(const float *__restrict__ Tt,
                                          const float *__restrict__ F,
                                          const float *ch, int h, int t,
                                          int j, int M, int R) {
    float acc = 0.0f;
    for (int s = 0; s < t; ++s)
        acc = fmaf(ch[s], F[(size_t)s * M + j], acc);
    return __fsub_rn(Tt[(size_t)j * R + h], acc);
}

__global__ void __launch_bounds__(THREADS) ah_ratio_tiles(
        const float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, const double *__restrict__ b,
        const int *__restrict__ h_ptr, int t, int M, int R, float eps,
        float *__restrict__ ah, double *__restrict__ part_key,
        int *__restrict__ part_idx) {
    extern __shared__ float ch[];                // C[s, h] for s < t
    const int h = min(*h_ptr, R - 1);
    ah_stage(C, h, t, R, ch);

    const int j = blockIdx.x * THREADS + threadIdx.x;
    double key = -CUDART_INF;                    // key = -(b / a_h)
    int idx = BIG_INDEX;
    if (j < M) {
        const float a = ah_entry(Tt, F, ch, h, t, j, M, R);
        ah[j] = a;
        if (a >= eps) {
            key = -__ddiv_rn(b[j], (double)a);
            idx = j;
        }
    }
    double unused = 0.0;
    block_argmax(key, idx, unused);
    if (threadIdx.x == 0) {
        part_key[blockIdx.x] = key;
        part_idx[blockIdx.x] = idx;
    }
}

__global__ void __launch_bounds__(THREADS) ah_ratio_finish(
        const double *__restrict__ part_key, const int *__restrict__ part_idx,
        int nparts, const float *__restrict__ ah,
        const double *__restrict__ b, int *__restrict__ k_out,
        float *__restrict__ p_out, double *__restrict__ bk_out,
        int *__restrict__ unb_out) {
    double key = -CUDART_INF;
    int idx = BIG_INDEX;
    for (int i = threadIdx.x; i < nparts; i += THREADS) {
        if (better(part_key[i], part_idx[i], key, idx)) {
            key = part_key[i];
            idx = part_idx[i];
        }
    }
    double unused = 0.0;
    block_argmax(key, idx, unused);
    if (threadIdx.x == 0) {
        const bool none = idx == BIG_INDEX;      // no eligible constraint
        *k_out = idx;
        *p_out = none ? 0.0f : ah[idx];
        *bk_out = none ? 0.0 : b[idx];
        *unb_out = none ? 1 : 0;
    }
}

// ---------------------------------------------------------------------------
// K5: the live entering column alone.
//
// Replaces ah_pass (simplex_tpu/kernels/blocked.py:1300, pallas_call at
// :1361; body _ah_kernel :1036). The sharded loop runs it on each rank's
// slice of the tableau; its ratio test runs on the column after the
// cross-rank sum, so K1's fused form does not apply there.
//   a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] * F[s, j]
// with h a column of this slice (the caller clamps it into range).
// Bound on the card: latency, as K1. It reads t live F rows and one strided
// element of Tt per constraint (computed: 1.2 MB at t = 37, M = 8192) on
// M / 256 blocks. Design: K1's tiles without the ratio fold -- the same
// ah_stage / ah_entry device code, so K1 and K5 give the same column bit
// for bit; one launch, no finishing pass. The TPU kernel skipped the dead
// F segments through its index maps; here t is the loop bound.

__global__ void __launch_bounds__(THREADS) ah_tiles(
        const float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, const int *__restrict__ h_ptr, int t,
        int M, int R, float *__restrict__ ah) {
    extern __shared__ float ch[];                // C[s, h] for s < t
    const int h = min(*h_ptr, R - 1);
    ah_stage(C, h, t, R, ch);
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j < M) ah[j] = ah_entry(Tt, F, ch, h, t, j, M, R);
}

// ---------------------------------------------------------------------------
// K2: pivot row, reduced-cost update, b / base / eta-row update, devex
// weights and the next entering candidates.
//
// Replaces colk_costs_pass (simplex_tpu/kernels/blocked.py:410, pallas_call at
// :653; body _colk_kernel :166-404) with its bf and devex options.
//   colk[j] = Tt[k, j] - sum_{s<t} F[s, k] * C[s, j],   C[t, j] = colk[j]
//   costs[j] -= u * colk[j]                              (f64)
//   b[j] -= bk * (a_h[j] / p), b[k] = bk / p, base[k] = h  (f64)
//   F[t, j] = a_h[j] / p, F[t, k] = 1 - 1/p              (f32 eta row)
//   w[j] = max(w[j], (colk[j]/p)^2 w_h), w[l] = max(w_h/p^2, 1)  (devex)
// then the main candidate (Dantzig argmin of costs, or devex argmax of
// cost^2 / w over eligible columns) and the Bland candidate (lowest eligible
// index), all over the updated costs of the active columns j < r. A skipped
// pivot (do = 0) writes zero rows C[t] and F[t] and leaves the vectors as
// they are; the candidates are still folded.
// Bound on the card: memory and launch latency. Per pivot it reads the live C
// rows (t * R * 4 bytes, computed: 3.6 MB at t = 37, R = 24576) and streams
// Tt's row k, the costs and the weights once; measured 9.3 us per call (three
// launches) at those shapes on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md),
// ~0.45 TB/s. Design: one thread per variable, coalesced C reads with the t
// values F[:, k] staged in shared memory; extra blocks past the R axis do the
// M-axis b / base / eta-row update in the same launch; the candidates fold
// per block into partials that a one-block pass folds in a fixed order. In
// place: C row t, F row t, costs, w, b and base are updated where they lie.
// Each thread reads only C and F rows s < t and writes only row t, and reads
// each vector element it writes before writing it. The two values that a
// thread other than their owner reads -- w[h] and base[k], the leaving
// variable l -- are snapshotted by a one-thread launch before the tiles run.
// The TPU kernel emitted the eta row for the caller to store; here it goes
// straight into F[t].

__global__ void colk_prep(const int *__restrict__ k_ptr,
                          const int *__restrict__ h_ptr,
                          const int *__restrict__ base,
                          const float *__restrict__ w, int M, int R,
                          int *__restrict__ si, float *__restrict__ sf) {
    const int k = min(*k_ptr, M - 1);            // k = BIG when unbounded
    si[0] = k;
    si[1] = base[k];                             // leaving variable l
    sf[0] = w != nullptr ? w[min(*h_ptr, R - 1)] : 0.0f;
}

__global__ void __launch_bounds__(THREADS) colk_costs_tiles(
        const float *__restrict__ Tt, float *__restrict__ C,
        float *__restrict__ F, double *__restrict__ costs, int t,
        const double *__restrict__ u_ptr,
        const unsigned char *__restrict__ do_ptr, int r, double eps, int M,
        int R, int n_rtiles, const float *__restrict__ ah,
        double *__restrict__ b, int *__restrict__ base,
        const int *__restrict__ h_ptr, const float *__restrict__ p_ptr,
        const double *__restrict__ bk_ptr, float *__restrict__ w,
        const int *__restrict__ si, const float *__restrict__ sf,
        double *__restrict__ part_key, int *__restrict__ part_idx,
        double *__restrict__ part_val, int *__restrict__ part_bidx,
        double *__restrict__ part_bval) {
    const int k = si[0];
    const bool apply = *do_ptr != 0;
    if ((int)blockIdx.x >= n_rtiles) {
        // M axis: b, base and the eta row (whole blocks return together).
        const int j = (blockIdx.x - n_rtiles) * THREADS + threadIdx.x;
        if (j >= M) return;
        float *v = F + (size_t)t * M;
        if (!apply) {
            v[j] = 0.0f;
            return;
        }
        const float p = *p_ptr;
        const double bk = *bk_ptr;
        if (j == k) {
            b[j] = __ddiv_rn(bk, (double)p);
            base[j] = *h_ptr;
            v[j] = __fsub_rn(1.0f, __fdiv_rn(1.0f, p));
        } else {
            const float a = ah[j];
            b[j] = __dsub_rn(b[j],
                             __dmul_rn(bk, __ddiv_rn((double)a, (double)p)));
            v[j] = __fdiv_rn(a, p);
        }
        return;
    }

    extern __shared__ float fk[];                // F[s, k] for s < t
    for (int s = threadIdx.x; s < t; s += THREADS)
        fk[s] = F[(size_t)s * M + k];
    __syncthreads();

    const int j = blockIdx.x * THREADS + threadIdx.x;
    double key = -CUDART_INF, val = CUDART_INF, bval = CUDART_INF;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    if (j < R) {
        float acc = 0.0f;
        for (int s = 0; s < t; ++s)
            acc = fmaf(fk[s], C[(size_t)s * R + j], acc);
        const float colk = __fsub_rn(Tt[(size_t)k * R + j], acc);
        C[(size_t)t * R + j] = apply ? colk : 0.0f;
        double c = costs[j];
        if (apply) {
            c = __dsub_rn(c, __dmul_rn(*u_ptr, (double)colk));
            costs[j] = c;
        }
        const bool live = j < r;
        const bool elig = live && c <= -eps;
        if (w != nullptr) {
            float wj = w[j];
            if (apply) {
                const float p = *p_ptr;
                const float wh = sf[0];
                const float alpha = __fdiv_rn(colk, p);
                float w2 = max_nan(wj, __fmul_rn(__fmul_rn(alpha, alpha), wh));
                if (j == si[1])
                    w2 = max_nan(__fdiv_rn(wh, __fmul_rn(p, p)), 1.0f);
                w2 = min_nan(w2, 1e12f);
                if (w2 != w2) w2 = 1.0f;
                w[j] = w2;
                wj = w2;
            }
            if (elig) {
                key = __ddiv_rn(__dmul_rn(c, c), (double)wj);
                idx = j;
                val = c;
            }
        } else if (live) {
            key = -c;                            // argmin of c == argmax -c
            idx = j;
            val = c;
        }
        if (elig) {
            bidx = j;
            bval = c;
        }
    }
    block_argmax(key, idx, val);
    double bkey = bidx == BIG_INDEX ? -CUDART_INF : 0.0;
    block_argmax(bkey, bidx, bval);              // lowest eligible index
    if (threadIdx.x == 0) {
        part_key[blockIdx.x] = key;
        part_idx[blockIdx.x] = idx;
        part_val[blockIdx.x] = val;
        part_bidx[blockIdx.x] = bidx;
        part_bval[blockIdx.x] = bval;
    }
}

__global__ void __launch_bounds__(THREADS) colk_costs_finish(
        const double *__restrict__ part_key, const int *__restrict__ part_idx,
        const double *__restrict__ part_val,
        const int *__restrict__ part_bidx,
        const double *__restrict__ part_bval, int nparts,
        int *__restrict__ hd_out, double *__restrict__ vd_out,
        int *__restrict__ hb_out, double *__restrict__ vb_out) {
    double key = -CUDART_INF, val = CUDART_INF, bval = CUDART_INF;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    for (int i = threadIdx.x; i < nparts; i += THREADS) {
        if (better(part_key[i], part_idx[i], key, idx)) {
            key = part_key[i];
            idx = part_idx[i];
            val = part_val[i];
        }
        if (part_bidx[i] < bidx) {
            bidx = part_bidx[i];
            bval = part_bval[i];
        }
    }
    block_argmax(key, idx, val);
    double bkey = bidx == BIG_INDEX ? -CUDART_INF : 0.0;
    block_argmax(bkey, bidx, bval);
    if (threadIdx.x == 0) {
        const bool none = key == -CUDART_INF;    // no candidate at all
        *hd_out = none ? 0 : idx;
        *vd_out = none ? CUDART_INF : val;
        *hb_out = bidx;
        *vb_out = bidx == BIG_INDEX ? CUDART_INF : bval;
    }
}

// ---------------------------------------------------------------------------
// K3 / K4: window apply Tt -= F^T C in place, with the reprice
// mv = coeffs^T Tt_new fused (K3) or not (K4).
//
// K3 replaces apply_reprice_pass (simplex_tpu/kernels/blocked.py:832,
// pallas_call at :887; body _apply_reprice_kernel :744-826); K4 replaces
// apply_window_pass (:694, pallas_call at :709; body _apply_kernel :686).
// Bound on the card: f32 arithmetic. 2 L M R flops (computed: 51.5 GFLOP at
// the flagship M = 8192, R = 24576, L = 128) against 8 M R bytes of tableau
// read and write (1.6 GB): 32 flops per byte, above the H100's f32 ridge, so
// the CUDA cores bound it; measured 1.32-1.38 ms = 37-39 TFLOP/s, 56-59% of
// the f32 peak, on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md). IEEE f32 FFMA,
// no TF32 (the TPU ran HIGHEST).
// Design: 128 x 128 output tiles, 256 threads each owning an 8 x 8 register
// tile (apply_tile.cuh, shared with the batched apply); each thread reads
// its Tt elements before it writes them, and no other thread touches them,
// so the update is safe in place. The reprice rides the fresh registers:
// each block sums coeffs * Tt_new down its 128 rows in f64 and writes one
// partial row per M tile; a second pass sums the partials in M order, so
// the result is deterministic. The TPU kernel took a traced flag to skip
// the reprice off cadence; here the loop decides the cadence on the host,
// where it syncs once per window anyway, and launches K4 instead.

template <bool REPRICE>
__global__ void __launch_bounds__(APPLY_THREADS) apply_tiles(
        float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, int M, int R, int L,
        const double *__restrict__ coeffs, double *__restrict__ part) {
    apply_tile<REPRICE>(Tt, F, C, M, R, L, coeffs,
                        REPRICE ? part + (size_t)blockIdx.y * R : nullptr);
}

__global__ void __launch_bounds__(THREADS) reprice_finish(
        const double *__restrict__ part, int n_mtiles, int R,
        double *__restrict__ mv) {
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j >= R) return;
    double s = 0.0;
    for (int i = 0; i < n_mtiles; ++i)
        s = __dadd_rn(s, part[(size_t)i * R + j]);
    mv[j] = s;
}

// ---------------------------------------------------------------------------
// K11: the standalone reprice mv = coeffs^T Tt, accumulated in f64.
//
// Replaces reprice_pass (simplex_tpu/kernels/blocked.py:976, pallas_call at
// :1002; body _reprice_kernel :933-973), which no solve path calls: the
// loops re-price through K3's fused pass. The TPU accumulated double-f32
// pairs with Dekker transforms; here the fold is native f64.
// Bound on the card: memory. It reads the tableau once, 4 M R bytes
// (computed: 805 MB at M = 8192, R = 24576, 0.240 ms at 3.35 TB/s), for
// 2 M R f64 operations (0.012 ms at 34 TFLOP/s). Design: K3's 128 x 128
// tiles without the apply -- each thread loads its 8 x 8 elements into the
// registers where K3 leaves Tt_new and runs the same fold (apply_tile.cuh
// reprice_tile), then reprice_finish sums the per-tile partials in M
// order: K3 with zero etas gives the same mv bit for bit.

__global__ void __launch_bounds__(APPLY_THREADS) reprice_tiles(
        const float *__restrict__ Tt, int R,
        const double *__restrict__ coeffs, double *__restrict__ part) {
    reprice_tile(Tt, R, coeffs, part + (size_t)blockIdx.y * R);
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

const char *kernel_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ah_ratio_launch(const float *Tt, const float *F, const float *C,
                    const double *b, const int *h, int t, int M, int R,
                    float eps, float *ah, double *part_key, int *part_idx,
                    int *k_out, float *p_out, double *bk_out, int *unb_out,
                    void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nb = (M + THREADS - 1) / THREADS;
    ah_ratio_tiles<<<nb, THREADS, t * sizeof(float), st>>>(
        Tt, F, C, b, h, t, M, R, eps, ah, part_key, part_idx);
    RETURN_IF_ERROR();
    ah_ratio_finish<<<1, THREADS, 0, st>>>(part_key, part_idx, nb, ah, b,
                                           k_out, p_out, bk_out, unb_out);
    RETURN_IF_ERROR();
    return 0;
}

int ah_launch(const float *Tt, const float *F, const float *C, const int *h,
              int t, int M, int R, float *ah, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nb = (M + THREADS - 1) / THREADS;
    ah_tiles<<<nb, THREADS, t * sizeof(float), st>>>(Tt, F, C, h, t, M, R,
                                                     ah);
    RETURN_IF_ERROR();
    return 0;
}

int colk_costs_launch(const float *Tt, float *C, float *F, double *costs,
                      const int *k, int t, const double *u,
                      const unsigned char *do_flag, int r, double eps, int M,
                      int R, const float *ah, double *b, int *base,
                      const int *h, const float *p, const double *bk,
                      float *w, int *scratch_i, float *scratch_f,
                      double *part_key, int *part_idx, double *part_val,
                      int *part_bidx, double *part_bval, int *hd_out,
                      double *vd_out, int *hb_out, double *vb_out,
                      void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_rtiles = (R + THREADS - 1) / THREADS;
    const int n_mtiles = (M + THREADS - 1) / THREADS;
    colk_prep<<<1, 1, 0, st>>>(k, h, base, w, M, R, scratch_i, scratch_f);
    RETURN_IF_ERROR();
    colk_costs_tiles<<<n_rtiles + n_mtiles, THREADS, t * sizeof(float), st>>>(
        Tt, C, F, costs, t, u, do_flag, r, eps, M, R, n_rtiles, ah, b, base,
        h, p, bk, w, scratch_i, scratch_f, part_key, part_idx, part_val,
        part_bidx, part_bval);
    RETURN_IF_ERROR();
    colk_costs_finish<<<1, THREADS, 0, st>>>(part_key, part_idx, part_val,
                                             part_bidx, part_bval, n_rtiles,
                                             hd_out, vd_out, hb_out, vb_out);
    RETURN_IF_ERROR();
    return 0;
}

int apply_reprice_launch(float *Tt, const float *F, const float *C, int M,
                         int R, int L, const double *coeffs, double *part,
                         double *mv, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(R / AT, M / AT);
    apply_tiles<true><<<grid, THREADS, 0, st>>>(Tt, F, C, M, R, L, coeffs,
                                                part);
    RETURN_IF_ERROR();
    reprice_finish<<<(R + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        part, M / AT, R, mv);
    RETURN_IF_ERROR();
    return 0;
}

int apply_window_launch(float *Tt, const float *F, const float *C, int M,
                        int R, int L, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(R / AT, M / AT);
    apply_tiles<false><<<grid, THREADS, 0, st>>>(Tt, F, C, M, R, L, nullptr,
                                                 nullptr);
    RETURN_IF_ERROR();
    return 0;
}

int reprice_launch(const float *Tt, int M, int R, const double *coeffs,
                   double *part, double *mv, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(R / AT, M / AT);
    reprice_tiles<<<grid, APPLY_THREADS, 0, st>>>(Tt, R, coeffs, part);
    RETURN_IF_ERROR();
    reprice_finish<<<(R + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        part, M / AT, R, mv);
    RETURN_IF_ERROR();
    return 0;
}

}  // extern "C"
