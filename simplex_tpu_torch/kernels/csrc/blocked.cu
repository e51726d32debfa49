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
// C entry point returns cudaGetLastError() after its launches. No value is
// reduced with atomics: each block writes one partial, and one block folds
// the partials -- a one-block pass (K1, K3, K11), or the last block of the
// same launch (K2), found by an atomic arrival counter that only counts
// the blocks that are done. Every fold orders candidates by (key, then
// lowest index), a total order, so the pivot choices (and therefore the
// walks) are the same from run to run whatever the blocks' order.
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

// block_argmax over warp shuffles: one barrier instead of eight. The whole
// block must call it; thread 0 gets the result.
__device__ void block_argmax_warps(double &key, int &idx, double &val) {
    __shared__ double sk[THREADS / 32];
    __shared__ int si[THREADS / 32];
    __shared__ double sv[THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    auto fold = [&]() {
        for (int off = 16; off > 0; off >>= 1) {
            const double k2 = __shfl_down_sync(0xffffffffu, key, off);
            const int i2 = __shfl_down_sync(0xffffffffu, idx, off);
            const double v2 = __shfl_down_sync(0xffffffffu, val, off);
            if (better(k2, i2, key, idx)) {
                key = k2;
                idx = i2;
                val = v2;
            }
        }
    };
    fold();
    if (lane == 0) {
        sk[warp] = key;
        si[warp] = idx;
        sv[warp] = val;
    }
    __syncthreads();
    if (warp == 0) {
        const bool has = lane < THREADS / 32;
        key = has ? sk[lane] : -CUDART_INF;
        idx = has ? si[lane] : BIG_INDEX;
        val = has ? sv[lane] : 0.0;
        fold();
    }
    __syncthreads();
}

// Asynchronous global -> shared copies (sm_80+), 16 bytes each, past L1.
__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// Bound on the card: memory and latency. Per pivot it reads the live C rows
// (t * R * 4 bytes, computed: 3.6 MB at t = 37, R = 24576) and streams Tt's
// row k, the costs and the weights once: 1.4 us at HBM's rate. PR 4's three
// launches (a one-thread snapshot, the tiles, a one-block fold) took 9.2 us
// at those shapes on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md), with one C
// load in flight per thread behind its FFMA chain. This kernel: 7.4-7.6 us
// there, 5.8-6.4 us at t = 0 -- what is left is latency, not bytes: k, then
// row k; the partial, its fence and the ticket; the last block's fold.
// Design: one launch. Each R block owns COLK_COLS columns: its 256 threads
// first issue every load of the block at once -- C[s, its columns] for up to
// COLK_ROWS live rows, as 16-byte cp.async copies into shared memory, and
// Tt[k, its columns] -- so the whole C slab is in flight together; then one
// thread per column runs the FFMA chain from shared memory, s = 0 .. t-1 in
// order, and the column updates. Extra blocks past the R axis do the M-axis
// b / base / eta-row update. Each R block writes its candidates' partial to
// the workspace and takes a ticket from an arrival counter there; the block
// that draws the last ticket folds the partials, writes the outputs and the
// deferred elements, and resets the counter to 0 for the next call. The
// counter only counts arrivals: the fold is the same total order as before,
// so the candidates are the same whichever block comes last.
// In place: C row t, F row t, costs, w, b and base are updated where they
// lie. Each thread reads only C and F rows s < t and writes only row t, and
// reads each vector element it writes before writing it. Two elements are
// read by threads other than their owner: base[k] (the leaving variable l)
// and w[h]. Every R block reads them at its start, and only the last block
// writes them, after every R block has arrived (w[h]'s new value waits in
// the workspace meanwhile). The TPU kernel emitted the eta row for the
// caller to store; here it goes straight into F[t].

constexpr int COLK_COLS = 64;    // columns per R block
constexpr int COLK_ROWS = 128;   // live C rows staged per pass of the chain

// The workspace (bytes; csrc and kernels/blocked.py colk_workspace_bytes
// agree): [0, 4) the arrival counter, [4, 8) w[h]'s new value, then f64
// key, val, bval[nb] and int idx, bidx[nb] for nb R blocks.
__host__ __device__ constexpr size_t colk_ws_bytes(int nb) {
    return 16 + (size_t)nb * (3 * sizeof(double) + 2 * sizeof(int));
}

struct ColkWs {
    unsigned *counter;
    float *w_h;
    double *key, *val, *bval;
    int *idx, *bidx;
    __device__ ColkWs(unsigned char *ws, int nb)
        : counter(reinterpret_cast<unsigned *>(ws)),
          w_h(reinterpret_cast<float *>(ws + 4)),
          key(reinterpret_cast<double *>(ws + 16)), val(key + nb),
          bval(val + nb), idx(reinterpret_cast<int *>(bval + nb)),
          bidx(idx + nb) {}
};

// One pass's loads into shared memory: C[s0 + s, j0 .. j0 + COLK_COLS) as
// 16-byte cp.async copies (not committed here) and F[s0 + s, k], for
// s < min(COLK_ROWS, t - s0). The whole block calls it.
__device__ __forceinline__ void colk_stage(const float *__restrict__ C,
                                           const float *__restrict__ F,
                                           int s0, int t, int k, int M, int R,
                                           int j0, float (*cs)[COLK_COLS],
                                           float *fk) {
    constexpr int CHUNKS = COLK_COLS / 4;        // 16-byte copies per row
    const int rows = min(COLK_ROWS, t - s0);
    for (int c = threadIdx.x; c < rows * CHUNKS; c += THREADS) {
        const int s = c / CHUNKS, q = (c % CHUNKS) * 4;
        cp_async16(&cs[s][q], C + (size_t)(s0 + s) * R + j0 + q);
    }
    for (int s = threadIdx.x; s < rows; s += THREADS)
        fk[s] = F[(size_t)(s0 + s) * M + k];
}

__global__ void __launch_bounds__(THREADS) colk_costs_fused(
        const float *__restrict__ Tt, float *__restrict__ C,
        float *__restrict__ F, double *__restrict__ costs,
        const int *__restrict__ k_ptr, int t,
        const double *__restrict__ u_ptr,
        const unsigned char *__restrict__ do_ptr, int r, double eps, int M,
        int R, int n_rblocks, const float *__restrict__ ah,
        double *__restrict__ b, int *__restrict__ base,
        const int *__restrict__ h_ptr, const float *__restrict__ p_ptr,
        const double *__restrict__ bk_ptr, float *__restrict__ w,
        unsigned char *__restrict__ ws_bytes, int *__restrict__ hd_out,
        double *__restrict__ vd_out, int *__restrict__ hb_out,
        double *__restrict__ vb_out) {
    const int k = min(*k_ptr, M - 1);            // k = BIG when unbounded
    const bool apply = *do_ptr != 0;
    const int tid = threadIdx.x;
    if ((int)blockIdx.x >= n_rblocks) {
        // M axis: b and the eta row (whole blocks return together); base[k]
        // is the last block's, since the R blocks read it.
        const int j = (blockIdx.x - n_rblocks) * THREADS + tid;
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
            v[j] = __fsub_rn(1.0f, __fdiv_rn(1.0f, p));
        } else {
            const float a = ah[j];
            b[j] = __dsub_rn(b[j],
                             __dmul_rn(bk, __ddiv_rn((double)a, (double)p)));
            v[j] = __fdiv_rn(a, p);
        }
        return;
    }

    __shared__ __align__(16) float cs[COLK_ROWS][COLK_COLS];
    __shared__ __align__(16) float trow[COLK_COLS];
    __shared__ float fk[COLK_ROWS];
    __shared__ bool last;
    const ColkWs ws(ws_bytes, n_rblocks);
    const int j0 = blockIdx.x * COLK_COLS;
    const int j = j0 + tid;                      // this thread's column
    const bool owner = tid < COLK_COLS;          // R is a multiple of 128
    const int hc = min(*h_ptr, R - 1);

    // The first pass's loads, all issued before any is waited for.
    colk_stage(C, F, 0, t, k, M, R, j0, cs, fk);
    if (tid < COLK_COLS / 4)
        cp_async16(&trow[tid * 4], Tt + (size_t)k * R + j0 + tid * 4);
    cp_async_commit();
    double c = 0.0;
    float wj = 0.0f;
    if (owner) {
        c = costs[j];
        if (w != nullptr) wj = w[j];
    }
    const int lvar = base[k];                    // read before any write
    const float wh = w != nullptr ? w[hc] : 0.0f;

    // colk[j] = Tt[k, j] - sum_{s<t} F[s, k] C[s, j], the FFMA chain in s
    // order across the passes.
    float acc = 0.0f;
    for (int s0 = 0;;) {
        cp_async_wait<0>();
        __syncthreads();
        const int rows = min(COLK_ROWS, t - s0);
        if (owner) {
#pragma unroll 8
            for (int s = 0; s < rows; ++s)
                acc = fmaf(fk[s], cs[s][tid], acc);
        }
        s0 += COLK_ROWS;
        if (s0 >= t) break;
        __syncthreads();                         // the pass is read
        colk_stage(C, F, s0, t, k, M, R, j0, cs, fk);
        cp_async_commit();
    }

    double key = -CUDART_INF, val = CUDART_INF, bval = CUDART_INF;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    if (owner) {
        const float colk = __fsub_rn(trow[tid], acc);
        C[(size_t)t * R + j] = apply ? colk : 0.0f;
        if (apply) {
            c = __dsub_rn(c, __dmul_rn(*u_ptr, (double)colk));
            costs[j] = c;
        }
        const bool live = j < r;
        const bool elig = live && c <= -eps;
        if (w != nullptr) {
            if (apply) {
                const float p = *p_ptr;
                const float alpha = __fdiv_rn(colk, p);
                float w2 = max_nan(wj, __fmul_rn(__fmul_rn(alpha, alpha), wh));
                if (j == lvar)
                    w2 = max_nan(__fdiv_rn(wh, __fmul_rn(p, p)), 1.0f);
                w2 = min_nan(w2, 1e12f);
                if (w2 != w2) w2 = 1.0f;
                if (j == hc) {
                    *ws.w_h = w2;            // the last block stores it
                    __threadfence();
                } else {
                    w[j] = w2;
                }
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
    block_argmax_warps(key, idx, val);
    double bkey = bidx == BIG_INDEX ? -CUDART_INF : 0.0;
    block_argmax_warps(bkey, bidx, bval);        // lowest eligible index
    // Publish the partial (thread 0) and w[h]'s new value (its owner, who
    // fenced before the fold's barriers), then arrive.
    if (tid == 0) {
        ws.key[blockIdx.x] = key;
        ws.idx[blockIdx.x] = idx;
        ws.val[blockIdx.x] = val;
        ws.bidx[blockIdx.x] = bidx;
        ws.bval[blockIdx.x] = bval;
        __threadfence();
        last = atomicAdd(ws.counter, 1u) == (unsigned)n_rblocks - 1;
    }
    __syncthreads();
    if (!last) return;

    // The last block: every R block has read base[k] and w[h] and written
    // its partial. Fold the partials (read past L1) in the same order.
    __threadfence();
    key = -CUDART_INF;
    val = bval = CUDART_INF;
    idx = bidx = BIG_INDEX;
    for (int i = tid; i < n_rblocks; i += THREADS) {
        const double ki = __ldcg(ws.key + i), vi = __ldcg(ws.val + i);
        const double bvi = __ldcg(ws.bval + i);
        const int ii = __ldcg(ws.idx + i), bi = __ldcg(ws.bidx + i);
        if (better(ki, ii, key, idx)) {
            key = ki;
            idx = ii;
            val = vi;
        }
        if (bi < bidx) {
            bidx = bi;
            bval = bvi;
        }
    }
    block_argmax_warps(key, idx, val);
    bkey = bidx == BIG_INDEX ? -CUDART_INF : 0.0;
    block_argmax_warps(bkey, bidx, bval);
    if (tid == 0) {
        const bool none = key == -CUDART_INF;    // no candidate at all
        *hd_out = none ? 0 : idx;
        *vd_out = none ? CUDART_INF : val;
        *hb_out = bidx;
        *vb_out = bidx == BIG_INDEX ? CUDART_INF : bval;
        if (apply) {
            base[k] = *h_ptr;
            if (w != nullptr) w[hc] = __ldcg(ws.w_h);
        }
        *ws.counter = 0;                         // ready for the next call
    }
}

// ---------------------------------------------------------------------------
// K3: window apply Tt -= F^T C in place, fused with the reprice
// mv = coeffs^T Tt_new.
//
// Replaces apply_reprice_pass (simplex_tpu/kernels/blocked.py:832,
// pallas_call at :887; body _apply_reprice_kernel :744-826).
// Bound on the card: f32 arithmetic. 2 L M R flops (computed: 51.5 GFLOP at
// the flagship M = 8192, R = 24576, L = 128) against 8 M R bytes of tableau
// read and write (1.6 GB): 32 flops per byte, above the H100's f32 ridge, so
// the CUDA cores bound it; measured 1.32-1.64 ms, 47-58% of the f32 peak, on
// NVIDIA H100 80GB HBM3, 700.00 W (PERF.md). IEEE f32 FFMA, no TF32 (the
// TPU ran HIGHEST).
// Design: 128 x 128 output tiles, 256 threads each owning an 8 x 8 register
// tile (apply_tile.cuh, shared with the batched apply); each thread reads
// its Tt elements before it writes them, and no other thread touches them,
// so the update is safe in place. The reprice rides the fresh registers:
// each block sums coeffs * Tt_new down its 128 rows in f64 and writes one
// partial row per M tile; a second pass sums the partials in M order, so
// the result is deterministic. The TPU kernel took a traced flag to skip
// the reprice off cadence; here the loop decides the cadence on the host,
// where it syncs once per window anyway, and launches K4 instead. K4 below
// rounds every element of Tt as this tile does.

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
// K4: window apply Tt -= F^T C in place, IEEE f32.
//
// Replaces apply_window_pass (simplex_tpu/kernels/blocked.py:694,
// pallas_call at :709; body _apply_kernel :686).
// Bound on the card: f32 arithmetic, as K3 (0.769 ms of FFMA at the
// flagship shape against 0.481 ms of tableau traffic). PR 4's kernel, K3's
// tile without the fold, took 1.71 ms there on NVIDIA H100 80GB HBM3,
// 700.00 W (PERF.md), behind cuBLAS addmm_: each 8-row stage went global ->
// register -> shared between two barriers, the 64 KB Tt tile was read and
// written after the main loop with nothing to overlap it, and its C
// fragments were read with 2-way bank conflicts. This kernel takes 1.19 ms
// there, ahead of addmm_ (PERF.md; tools/k4_variants.cu times the designs).
// Design (chosen on the card among variants of stage depth, stage height,
// blocks per SM and thread layout; PERF.md): persistent blocks, two per SM,
// each walking a contiguous range of the 128 x 128 output tiles (the R
// tiles of one M tile in a row). Eight eta rows of F and of C make one 8 KB
// stage; a ring of WIN_STAGES stages is filled by cp.async from all
// threads, WIN_STAGES - 1 stages ahead, and runs on across tiles, so the
// next tile's first stages arrive during this tile's last ones. The tile
// of Tt is copied into shared memory when the tile starts, behind the main
// loop, and written back from there by plain stores that drain while the
// next tile computes. Tile and stage offsets advance by addition, not by
// division. A warp covers 32 rows x 64 columns: each thread 8 rows and two
// 4-wide column groups 32 apart, so a warp's 16-byte fragment reads touch
// 128 contiguous bytes of C and 128 of F (no bank conflict, no replay).
// The FFMAs of a step run in a zigzag over the thread's 8 x 8 outputs.
// Arithmetic: each element's sum is fmaf over s = 0 .. L-1 in order from
// 0.0f, then one __fsub_rn from Tt: the rounding of apply_tile.cuh, so K4
// and K3 leave the same Tt bit for bit. No split-K, no tensor cores.
// F is streamed with C rather than kept resident per M tile: a resident
// slab (L x 512 bytes) would cap L in 227 KB of shared memory and leave
// one block per SM, and its re-reads come from L2 (F is 4 MB at the
// flagship shape).

constexpr int WIN_STAGES = 4;
constexpr int WIN_STAGE_FLOATS = 2 * AK * AT;    // F rows, then C rows
constexpr size_t WIN_SMEM =
    (size_t)(AT * AT + WIN_STAGES * WIN_STAGE_FLOATS) * sizeof(float);

__global__ void __launch_bounds__(APPLY_THREADS, 2) window_apply(
        float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, int M, int R, int L) {
    extern __shared__ __align__(16) float win_smem[];
    float *Ts = win_smem;                        // the tile of Tt
    float *ring = win_smem + AT * AT;
    const int n_rt = R / AT;
    const int n_tiles = (M / AT) * n_rt;
    const int nk = L / AK;                       // stages per tile
    const int tile0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
    const int tile1 =
        (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
    const int G = (tile1 - tile0) * nk;          // this block's stages
    const int tid = threadIdx.x;

    // The loader: stage lg (its eta rows ls0 .. ls0 + 7 of tile (li0, lj0))
    // goes to slot lg % WIN_STAGES, one commit group each (empty past the
    // end), so group g holds stage g. Thread -> one 16-byte chunk of F and
    // one of C.
    int lg = 0, ls0 = 0;
    size_t li0 = (size_t)(tile0 / n_rt) * AT, lj0 = (size_t)(tile0 % n_rt) * AT;
    const int lrow = tid >> 5, lcol = (tid & 31) * 4;
    auto load = [&]() {
        if (lg < G) {
            float *st = ring + (lg % WIN_STAGES) * WIN_STAGE_FLOATS;
            cp_async16(st + lrow * AT + lcol,
                       F + (size_t)(ls0 + lrow) * M + li0 + lcol);
            cp_async16(st + (AK + lrow) * AT + lcol,
                       C + (size_t)(ls0 + lrow) * R + lj0 + lcol);
            ls0 += AK;
            if (ls0 == L) {
                ls0 = 0;
                lj0 += AT;
                if (lj0 == (size_t)R) {
                    lj0 = 0;
                    li0 += AT;
                }
            }
        }
        ++lg;
        cp_async_commit();
    };
    for (int g = 0; g < WIN_STAGES - 1; ++g) load();

    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = (warp >> 1) * 32 + (lane >> 3) * 8;   // rows r0 .. r0+7
    const int c0 = (warp & 1) * 64 + (lane & 7) * 4;     // c0.., c0+32..
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = 0.0f;

    int kk = 0;
    size_t i0 = (size_t)(tile0 / n_rt) * AT;     // the tile computed
    size_t j0 = (size_t)(tile0 % n_rt) * AT;
    for (int g = 0; g < G; ++g) {
        cp_async_wait<WIN_STAGES - 2>();         // stage g has landed
        __syncthreads();
        if (kk == 0) {
            // The tile of Tt, into the group of stage g + WIN_STAGES - 1.
            // The previous tile's store read Ts before the barrier.
#pragma unroll
            for (int q = 0; q < AT * AT / 4 / APPLY_THREADS; ++q) {
                const int c = tid + q * APPLY_THREADS;
                const int row = c >> 5, col = (c & 31) * 4;
                cp_async16(Ts + row * AT + col,
                           Tt + (i0 + row) * (size_t)R + j0 + col);
            }
        }
        load();                                  // into stage g - 1's slot
        const float *Fs = ring + (g % WIN_STAGES) * WIN_STAGE_FLOATS;
        const float *Cs = Fs + AK * AT;
#pragma unroll
        for (int s = 0; s < AK; ++s) {
            float fa[8], cb[8];
            *reinterpret_cast<float4 *>(&fa[0]) =
                *reinterpret_cast<const float4 *>(&Fs[s * AT + r0]);
            *reinterpret_cast<float4 *>(&fa[4]) =
                *reinterpret_cast<const float4 *>(&Fs[s * AT + r0 + 4]);
            *reinterpret_cast<float4 *>(&cb[0]) =
                *reinterpret_cast<const float4 *>(&Cs[s * AT + c0]);
            *reinterpret_cast<float4 *>(&cb[4]) =
                *reinterpret_cast<const float4 *>(&Cs[s * AT + c0 + 32]);
            // Odd rows walk the columns backwards: each FFMA shares an
            // operand with the one before it, row changes included, which
            // suits the register reuse cache (4% faster than in order).
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int cc = 0; cc < 8; ++cc) {
                    const int c = (a & 1) ? 7 - cc : cc;
                    acc[a][c] = fmaf(fa[a], cb[c], acc[a][c]);
                }
        }
        if (++kk == nk) {
            // Tt's group is stage (g - nk + 1) + WIN_STAGES - 1's: landed
            // at this iteration's wait unless the tile has fewer stages.
            kk = 0;
            if (nk < WIN_STAGES) cp_async_wait<0>();
            __syncthreads();
#pragma unroll
            for (int a = 0; a < 8; ++a) {
                const int row = r0 + a;
                float *out = Tt + (i0 + row) * (size_t)R + j0 + c0;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    float4 v = *reinterpret_cast<const float4 *>(
                        &Ts[row * AT + c0 + half * 32]);
                    v.x = __fsub_rn(v.x, acc[a][half * 4 + 0]);
                    v.y = __fsub_rn(v.y, acc[a][half * 4 + 1]);
                    v.z = __fsub_rn(v.z, acc[a][half * 4 + 2]);
                    v.w = __fsub_rn(v.w, acc[a][half * 4 + 3]);
                    *reinterpret_cast<float4 *>(out + half * 32) = v;
                }
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[a][c] = 0.0f;
            }
            j0 += AT;
            if (j0 == (size_t)R) {
                j0 = 0;
                i0 += AT;
            }
        }
    }
    cp_async_wait<0>();                          // the empty tail groups
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
                      float *w, unsigned char *ws, long long ws_bytes,
                      int *hd_out, double *vd_out, int *hb_out,
                      double *vb_out, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_rblocks = (R + COLK_COLS - 1) / COLK_COLS;
    const int n_mblocks = (M + THREADS - 1) / THREADS;
    if (ws_bytes < (long long)colk_ws_bytes(n_rblocks))
        return (int)cudaErrorInvalidValue;       // workspace too small
    colk_costs_fused<<<n_rblocks + n_mblocks, THREADS, 0, st>>>(
        Tt, C, F, costs, k, t, u, do_flag, r, eps, M, R, n_rblocks, ah, b,
        base, h, p, bk, w, ws, hd_out, vd_out, hb_out, vb_out);
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
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(window_apply,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)WIN_SMEM);
    RETURN_IF_ERROR();
    const int n_tiles = (M / AT) * (R / AT);
    const int nb = n_tiles < 2 * sms ? n_tiles : 2 * sms;  // persistent
    window_apply<<<nb, APPLY_THREADS, WIN_SMEM, st>>>(Tt, F, C, M, R, L);
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
