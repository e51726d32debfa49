// Hand-written Hopper (sm_90a) kernel of the sequential pivot loop: the CUDA
// counterpart of the Pallas pass fused_pivot (K6) in
// simplex_tpu/kernels/pivot.py.
//
// K6 replaces fused_pivot (simplex_tpu/kernels/pivot.py:126, pallas_call at
// :163; body _kernel :63-122). One pivot of the sequential loop, in the
// port's transposed layout Tt (M, R) f32 (row j = constraint j, column i =
// variable i; the TPU kernel streamed T (R, M)), given the snapshots
// colk = Tt[k, :] (R,) and a_h = Tt[:, h] (M,), and the device scalars p, minc,
// k and the do flag:
//   inv_p = 1/p, mop = minc/p, factor[j] = a_h[j] * inv_p   (identity when !do:
//                                                            1, 0 and 0)
//   Tt[j, i] -= colk[i] * factor[j]   for j != k,   Tt[k, i] = colk[i] * inv_p
//   costs[i] -= mop * colk[i]
// then, over the updated costs of the active columns i < r, the Dantzig
// candidate (min value, lowest index) and the Bland candidate (lowest index
// with cost <= -eps, and its value; BIG_INDEX and +inf when none).
// Every product and difference is pinned with the _rn intrinsics: the TPU
// kernel rounds the product and the difference apart, and nvcc would
// otherwise contract them into one FMA. The plain PyTorch version
// (kernels/pivot.py fused_pivot_plain) computes the same two roundings.
//
// Bound on the card: memory. One read and one write of the tableau,
// 8 M R bytes: 1.61 GB at the 8192^2 f32 shape (M 8,192 x R 24,576),
// 0.48 ms at 3.35 TB/s; 9.71 GB at the 10k x 100k north-star phase 1
// (M 10,112 x R 120,000), 2.90 ms. Design: a 2-D grid of tiles, each block
// 256 threads x 4 floats = 1,024 columns by ROWS rows; a thread keeps its
// four colk values in registers and streams its rows with 16-byte loads and
// stores, four rows in flight, the row's factor a broadcast read of a_h. When
// the do flag is false the tiles skip the tableau altogether (the TPU kernel
// ran an identity pass). The blocks of the first row band also update the
// costs of their columns and fold the two candidates into one partial per
// block; a one-block pass folds the partials in index order. No atomics:
// every fold orders by (value, then lowest index), a total order, so the
// choice does not depend on the blocks' schedule (the TPU kernel folded
// across its sequential grid in SMEM scratch).
//
// Each thread reads only its own tableau elements before it writes them, and
// colk and a_h are snapshots, so overwriting row k cannot race its readers.
// Offsets into Tt are size_t: at 10k x 100k it holds 1.2e9 elements.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BIG_INDEX = 2147483647;
constexpr int PT = 256;            // threads per block
constexpr int VEC = 4;             // floats per thread along R (16 bytes)
constexpr int COLS = PT * VEC;     // columns per block
constexpr int ROWS = 32;           // rows per block
constexpr int INFLIGHT = 4;        // rows loaded before the first store

__device__ __forceinline__ bool less(float va, int ia, float vb, int ib) {
    return va < vb || (va == vb && ia < ib);
}

// Block-wide fold of the Dantzig pair (min value, lowest index) and the Bland
// pair (lowest index, its value); the result does not depend on the tree.
__device__ void block_fold(float &val, int &idx, float &bval, int &bidx) {
    __shared__ float sv[PT];
    __shared__ int si[PT];
    __shared__ float sbv[PT];
    __shared__ int sbi[PT];
    const int tid = threadIdx.x;
    sv[tid] = val;
    si[tid] = idx;
    sbv[tid] = bval;
    sbi[tid] = bidx;
    __syncthreads();
    for (int s = PT / 2; s > 0; s >>= 1) {
        if (tid < s) {
            if (less(sv[tid + s], si[tid + s], sv[tid], si[tid])) {
                sv[tid] = sv[tid + s];
                si[tid] = si[tid + s];
            }
            if (sbi[tid + s] < sbi[tid]) {
                sbi[tid] = sbi[tid + s];
                sbv[tid] = sbv[tid + s];
            }
        }
        __syncthreads();
    }
    val = sv[0];
    idx = si[0];
    bval = sbv[0];
    bidx = sbi[0];
}

__device__ __forceinline__ float4 update4(float4 t, float4 c, float f) {
    return make_float4(__fsub_rn(t.x, __fmul_rn(c.x, f)),
                       __fsub_rn(t.y, __fmul_rn(c.y, f)),
                       __fsub_rn(t.z, __fmul_rn(c.z, f)),
                       __fsub_rn(t.w, __fmul_rn(c.w, f)));
}

__global__ void __launch_bounds__(PT) fused_pivot_tiles(
        float *__restrict__ Tt, float *__restrict__ costs,
        const float *__restrict__ colk, const float *__restrict__ ah,
        const float *__restrict__ p_ptr, const float *__restrict__ minc_ptr,
        const int *__restrict__ k_ptr, const unsigned char *__restrict__ do_ptr,
        int M, int R, int r, float eps, float *__restrict__ part_val,
        int *__restrict__ part_idx, float *__restrict__ part_bval,
        int *__restrict__ part_bidx) {
    const bool apply = *do_ptr != 0;
    const float p = *p_ptr;
    const float inv_p = apply ? __fdiv_rn(1.0f, p) : 1.0f;
    const int k = *k_ptr;
    const int c0 = (blockIdx.x * PT + threadIdx.x) * VEC;
    const bool in = c0 < R;                    // R % 4 == 0: all or nothing
    const float4 ck = in ? *reinterpret_cast<const float4 *>(colk + c0)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    if (apply && in) {
        const int j0 = blockIdx.y * ROWS;
        const int j1 = min(j0 + ROWS, M);
        for (int j = j0; j < j1; j += INFLIGHT) {
            float4 t[INFLIGHT];
#pragma unroll
            for (int u = 0; u < INFLIGHT; ++u)
                if (j + u < j1)
                    t[u] = *reinterpret_cast<const float4 *>(
                        Tt + (size_t)(j + u) * R + c0);
#pragma unroll
            for (int u = 0; u < INFLIGHT; ++u) {
                const int row = j + u;
                if (row >= j1) break;
                const float4 out =
                    row == k ? make_float4(__fmul_rn(ck.x, inv_p),
                                           __fmul_rn(ck.y, inv_p),
                                           __fmul_rn(ck.z, inv_p),
                                           __fmul_rn(ck.w, inv_p))
                             : update4(t[u], ck, __fmul_rn(ah[row], inv_p));
                *reinterpret_cast<float4 *>(Tt + (size_t)row * R + c0) = out;
            }
        }
    }
    if (blockIdx.y != 0) return;

    // First row band: the costs of this block's columns and its partials.
    float val = CUDART_INF_F, bval = CUDART_INF_F;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    if (in) {
        const float mop = apply ? __fdiv_rn(*minc_ptr, p) : 0.0f;
        float4 *cp = reinterpret_cast<float4 *>(costs + c0);
        const float4 cv = *cp;
        float c[VEC] = {cv.x, cv.y, cv.z, cv.w};
        const float kv[VEC] = {ck.x, ck.y, ck.z, ck.w};
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            if (apply) c[q] = __fsub_rn(c[q], __fmul_rn(mop, kv[q]));
            const int i = c0 + q;
            const float cm = i < r ? c[q] : CUDART_INF_F;
            if (less(cm, i, val, idx)) {
                val = cm;
                idx = i;
            }
            if (cm <= -eps && i < bidx) {
                bidx = i;
                bval = cm;
            }
        }
        if (apply) *cp = make_float4(c[0], c[1], c[2], c[3]);
    }
    block_fold(val, idx, bval, bidx);
    if (threadIdx.x == 0) {
        part_val[blockIdx.x] = val;
        part_idx[blockIdx.x] = idx;
        part_bval[blockIdx.x] = bval;
        part_bidx[blockIdx.x] = bidx;
    }
}

__global__ void __launch_bounds__(PT) fused_pivot_finish(
        const float *__restrict__ part_val, const int *__restrict__ part_idx,
        const float *__restrict__ part_bval, const int *__restrict__ part_bidx,
        int nparts, int *__restrict__ hd_out, float *__restrict__ vd_out,
        int *__restrict__ hb_out, float *__restrict__ vb_out) {
    float val = CUDART_INF_F, bval = CUDART_INF_F;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    for (int i = threadIdx.x; i < nparts; i += PT) {
        if (less(part_val[i], part_idx[i], val, idx)) {
            val = part_val[i];
            idx = part_idx[i];
        }
        if (part_bidx[i] < bidx) {
            bidx = part_bidx[i];
            bval = part_bval[i];
        }
    }
    block_fold(val, idx, bval, bidx);
    if (threadIdx.x == 0) {
        *hd_out = idx;
        *vd_out = val;
        *hb_out = bidx;
        *vb_out = bidx == BIG_INDEX ? CUDART_INF_F : bval;
    }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (ctypes). Returns cudaGetLastError() as an int; the error
// string comes from kernel_error_string in blocked.cu.

extern "C" int fused_pivot_launch(float *Tt, float *costs, const float *colk,
                                  const float *ah, const float *p,
                                  const float *minc, const int *k,
                                  const unsigned char *do_flag, int M, int R,
                                  int r, float eps, float *part_val,
                                  int *part_idx, float *part_bval,
                                  int *part_bidx, int *hd_out, float *vd_out,
                                  int *hb_out, float *vb_out, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nx = (R + COLS - 1) / COLS;
    const dim3 grid(nx, (M + ROWS - 1) / ROWS);
    fused_pivot_tiles<<<grid, PT, 0, st>>>(
        Tt, costs, colk, ah, p, minc, k, do_flag, M, R, r, eps, part_val,
        part_idx, part_bval, part_bidx);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fused_pivot_finish<<<1, PT, 0, st>>>(part_val, part_idx, part_bval,
                                         part_bidx, nx, hd_out, vd_out, hb_out,
                                         vb_out);
    return (int)cudaGetLastError();
}
