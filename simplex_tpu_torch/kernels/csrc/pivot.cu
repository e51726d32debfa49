// Hand-written Hopper (sm_90a) kernels of the sequential pivot loops: the CUDA
// counterpart of the Pallas pass fused_pivot (K6) in
// simplex_tpu/kernels/pivot.py, and (at the end of the file) the batched
// rank-1 update of the batched sequential loop.
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

// ---------------------------------------------------------------------------
// The batched rank-1 update of the batched sequential loop (batch_fallback.py,
// the lanes of the JAX package's vmapped fallback). It replaces no Pallas
// kernel: the JAX package applies the update of each lane in XLA
// (simplex_tpu/solver.py:51 pivot_update, under jax.vmap). For every lane
// whose do flag is set,
//   Tt[lane][j, i] = Tt[lane][j, i] - factor[lane][j] * colk[lane][i]
// over all M x R elements, the product and the difference each rounded
// (pinned with the _rn intrinsics, which nvcc does not contract): bit for bit
// what the single-LP loop's Tt.addr_(factor, colk, alpha=-1) computes on the
// card (measured on an H100 with torch 2.11: addr_, addcmul_ and baddbmm_
// all round twice there, and one FMA differs in a fifth of the elements), so
// that each lane walks as solve() does (the caller writes row k afterwards,
// as solve() does). A lane whose flag is clear is not read or written at
// all, so its tableau keeps every bit (a masked addcmul_ would turn a -0.0
// into +0.0) and costs no traffic.
//
// Bound on the card: memory. One read and one write of each live lane's
// tableau, 2 M R sizeof(T) bytes a lane: 6.29 GB a step at BASELINE.json
// config 3's phase 1 in f64 with every lane live (256 x 512 x 3,000), 1.88 ms
// at 3.35 TB/s. Design: a 3-D grid (column chunks, row bands, lanes). Where
// a row is a whole number of 16-byte vectors (R even in f64, a multiple of 4
// in f32, as the padded tableaus are) and Tt 16-byte aligned, a thread owns
// one vector column of a band of ROWS rows: it keeps its colk vector in
// registers and streams the band four rows at a time, four 16-byte loads in
// flight before the four stores, each row's factor one broadcast load. Other
// shapes take a scalar tile of VEC strided columns a thread.

namespace {

constexpr int R1_THREADS = 256;
constexpr int R1_VEC = 4;          // scalar tile: columns a thread
constexpr int R1_ROWS = 32;        // rows a block
constexpr int R1_INFLIGHT = 4;     // rows loaded before the first store

// t - f * c with the product and the difference rounded apart.
__device__ __forceinline__ float mul_sub_rn(float t, float f, float c) {
    return __fsub_rn(t, __fmul_rn(f, c));
}
__device__ __forceinline__ double mul_sub_rn(double t, double f, double c) {
    return __dsub_rn(t, __dmul_rn(f, c));
}
__device__ __forceinline__ double2 mul_sub_rn(double2 t, double f,
                                              double2 c) {
    return make_double2(mul_sub_rn(t.x, f, c.x), mul_sub_rn(t.y, f, c.y));
}
__device__ __forceinline__ float4 mul_sub_rn(float4 t, float f, float4 c) {
    return make_float4(mul_sub_rn(t.x, f, c.x), mul_sub_rn(t.y, f, c.y),
                       mul_sub_rn(t.z, f, c.z), mul_sub_rn(t.w, f, c.w));
}

// The 16-byte vector of each element type.
template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
    using type = double2;
};
template <>
struct Vec16<float> {
    using type = float4;
};

template <typename T>
__global__ void __launch_bounds__(R1_THREADS)
batch_rank1_vec(T *__restrict__ Tt, const T *__restrict__ factor,
                const T *__restrict__ colk,
                const unsigned char *__restrict__ do_flag, int M, int R) {
    using V = typename Vec16<T>::type;
    const int lane = blockIdx.z;
    if (!do_flag[lane]) return;
    const int RV = R / (int)(sizeof(V) / sizeof(T));   // vectors a row
    const int cv = blockIdx.x * R1_THREADS + threadIdx.x;
    if (cv >= RV) return;
    const int row0 = blockIdx.y * R1_ROWS;
    const int rows = min(R1_ROWS, M - row0);
    const V c = reinterpret_cast<const V *>(colk + (size_t)lane * R)[cv];
    const T *f = factor + (size_t)lane * M + row0;
    V *t = reinterpret_cast<V *>(Tt + ((size_t)lane * M + row0) * R) + cv;
    int r = 0;
    for (; r + R1_INFLIGHT <= rows; r += R1_INFLIGHT) {
        V tv[R1_INFLIGHT];
        T fv[R1_INFLIGHT];
#pragma unroll
        for (int u = 0; u < R1_INFLIGHT; ++u) {
            tv[u] = t[(size_t)(r + u) * RV];
            fv[u] = f[r + u];
        }
#pragma unroll
        for (int u = 0; u < R1_INFLIGHT; ++u)
            t[(size_t)(r + u) * RV] = mul_sub_rn(tv[u], fv[u], c);
    }
    for (; r < rows; ++r)
        t[(size_t)r * RV] = mul_sub_rn(t[(size_t)r * RV], f[r], c);
}

template <typename T>
__global__ void __launch_bounds__(R1_THREADS)
batch_rank1_tiles(T *__restrict__ Tt, const T *__restrict__ factor,
                  const T *__restrict__ colk,
                  const unsigned char *__restrict__ do_flag, int M, int R) {
    const int lane = blockIdx.z;
    if (!do_flag[lane]) return;
    const int row0 = blockIdx.y * R1_ROWS;
    const int col0 = blockIdx.x * (R1_THREADS * R1_VEC) + threadIdx.x;
    const T *c = colk + (size_t)lane * R;
    const T *f = factor + (size_t)lane * M;
    T *t = Tt + (size_t)lane * M * R;
    T cv[R1_VEC];
#pragma unroll
    for (int v = 0; v < R1_VEC; ++v) {
        const int col = col0 + v * R1_THREADS;
        cv[v] = col < R ? c[col] : T(0);
    }
    const int rows = min(R1_ROWS, M - row0);
    for (int r = 0; r < rows; ++r) {
        const T fr = f[row0 + r];
        T *trow = t + (size_t)(row0 + r) * R;
#pragma unroll
        for (int v = 0; v < R1_VEC; ++v) {
            const int col = col0 + v * R1_THREADS;
            if (col < R) trow[col] = mul_sub_rn(trow[col], fr, cv[v]);
        }
    }
}

template <typename T>
int batch_rank1_run(T *Tt, const T *factor, const T *colk,
                    const unsigned char *do_flag, int B, int M, int R,
                    void *stream) {
    if (B <= 0 || M <= 0 || R <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int per = (int)(16 / sizeof(T));
    const dim3 bands(1, (M + R1_ROWS - 1) / R1_ROWS, B);
    if (R % per == 0 && reinterpret_cast<uintptr_t>(Tt) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(colk) % 16 == 0) {
        const dim3 grid((R / per + R1_THREADS - 1) / R1_THREADS, bands.y, B);
        batch_rank1_vec<T><<<grid, R1_THREADS, 0, st>>>(Tt, factor, colk,
                                                         do_flag, M, R);
    } else {
        const dim3 grid((R + R1_THREADS * R1_VEC - 1) / (R1_THREADS * R1_VEC),
                        bands.y, B);
        batch_rank1_tiles<T><<<grid, R1_THREADS, 0, st>>>(Tt, factor, colk,
                                                           do_flag, M, R);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Tt (B, M, R), factor (B, M), colk (B, R), all f64 (f32 below); do (B,).
extern "C" int batch_rank1_f64_launch(double *Tt, const double *factor,
                                      const double *colk,
                                      const unsigned char *do_flag, int B,
                                      int M, int R, void *stream) {
    return batch_rank1_run<double>(Tt, factor, colk, do_flag, B, M, R,
                                   stream);
}

extern "C" int batch_rank1_f32_launch(float *Tt, const float *factor,
                                      const float *colk,
                                      const unsigned char *do_flag, int B,
                                      int M, int R, void *stream) {
    return batch_rank1_run<float>(Tt, factor, colk, do_flag, B, M, R,
                                  stream);
}
