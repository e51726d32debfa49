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
// block; a one-block pass folds the partials in index order. Every fold
// orders by (value, then lowest index), a total order, so the choice does
// not depend on the blocks' schedule (the TPU kernel folded across its
// sequential grid in SMEM scratch).
//
// In the K6 loop's chunk graph (fused_pivot_seq_launch) there is no
// second pass: the first row band's blocks update their costs and store
// their partials before their rows and take an arrival ticket; the one
// that draws the last folds the partials in one warp (shuffles, no
// barrier) and runs the step after the pass while the tableau streams, so
// a pivot's K6 is one node. The one-block pass it replaced folded in an
// 8-level shared-memory tree with a barrier a level and then ran the step
// in thread 0: 2.9-3.2 us and a node's launch gap at M 2,048 x R 6,144
// (PERF.md, NVIDIA H100 80GB HBM3, 700 W). There the tail adds 0.18-0.46
// us to the tiles; taken after the rows instead (its release then waits
// for the rows' stores) it added 2.0 us, and a one-warp fold as a node of
// its own 1.8 (tools/k6_tail_variants.cu).
//
// Each thread reads only its own tableau elements before it writes them, and
// colk and a_h are snapshots, so overwriting row k cannot race its readers.
// Offsets into Tt are size_t: at 10k x 100k it holds 1.2e9 elements.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "seq_step.cuh"

namespace {

using seq::BIG_INDEX;
using seq::FULL;
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

// The arrival ticket (csrc/blocked.cu's): one atomic add, acquire and
// release at the device's scope. Its release orders the calling thread's
// partial before the add; in the block that draws the last ticket its
// acquire orders every block's partial before the fold, and the block's
// barrier hands that on to the folding warp, which reads past L1.
__device__ __forceinline__ unsigned ticket(unsigned *counter) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    return old;
}

// The K6 loop's tail, in every block of the first row band after its
// partial: the block that draws the last of the band's nx tickets folds
// the nx partials in warp 0 -- each lane its partials in index order, then
// shuffles; the order is total, so the result is block_fold's -- and its
// lane 0 resets the counter, stores the candidates where the pivot is
// done (``apply``), else the carried ones, and runs the step after the
// pass (seq_step.cuh); then the block goes on to its rows. Each block
// takes its ticket after it has read the one scalar the step rewrites
// that a tile block reads, minc (read by the first row band only); the
// other bands read k, p and do, which only the ratio test writes.
__device__ __forceinline__ void k6_tail(
        bool apply, const float *__restrict__ part_val,
        const int *__restrict__ part_idx, const float *__restrict__ part_bval,
        const int *__restrict__ part_bidx, unsigned *__restrict__ counter,
        const SeqStep<float, float> &s, const seq::Policy &pol) {
    __shared__ bool last;
    const int nx = (int)gridDim.x, lane = threadIdx.x;   // in warp 0
    if (threadIdx.x == 0) last = ticket(counter) == (unsigned)nx - 1;
    __syncthreads();
    if (!last || threadIdx.x >= 32) return;
    // The step's operands, loaded while the partials fold: no block of the
    // pass writes them.
    seq::PostIn<float> in{};
    seq::Candidates<float> old{};
    if (lane == 0) {
        in = seq::post_load(s);
        old = {*s.h_d, *s.v_d, *s.h_b, *s.v_b};
    }
    float val = CUDART_INF_F, bval = CUDART_INF_F;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    for (int i = lane; i < nx; i += 32) {
        const float v = __ldcg(part_val + i), bv = __ldcg(part_bval + i);
        const int ix = __ldcg(part_idx + i), bi = __ldcg(part_bidx + i);
        if (less(v, ix, val, idx)) {
            val = v;
            idx = ix;
        }
        if (bi < bidx) {
            bidx = bi;
            bval = bv;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_xor_sync(FULL, val, off);
        const float bv = __shfl_xor_sync(FULL, bval, off);
        const int ix = __shfl_xor_sync(FULL, idx, off);
        const int bi = __shfl_xor_sync(FULL, bidx, off);
        if (less(v, ix, val, idx)) {
            val = v;
            idx = ix;
        }
        if (bi < bidx) {
            bidx = bi;
            bval = bv;
        }
    }
    if (lane != 0) return;
    *counter = 0;                                // ready for the next call
    // solver.py's ``cand = where(do, new, cand)``, then the step after.
    const seq::Candidates<float> n =
            apply ? seq::Candidates<float>{idx, val, bidx,
                                           bidx == BIG_INDEX ? CUDART_INF_F
                                                             : bval}
                  : old;
    *s.h_d = n.h_d;
    *s.v_d = n.v_d;
    *s.h_b = n.h_b;
    *s.v_b = n.v_b;
    seq::post(s, in, apply, n, pol);
}

// The first row band's share of a pass: the costs of this block's
// columns where the pivot is done (costs -= (minc / p) colk) and the
// block's partial of the two candidates over them.
__device__ __forceinline__ void band_partial(
        float *__restrict__ costs, const float *minc_ptr, float4 ck, int c0,
        bool in, bool apply, float p, int r, float eps,
        float *__restrict__ part_val, int *__restrict__ part_idx,
        float *__restrict__ part_bval, int *__restrict__ part_bidx) {
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

// TAIL: the K6 loop's instantiation. The first row band's blocks do their
// band_partial and k6_tail before their rows, so the fold and the step
// after the pass run while the tableau streams, and the ticket's release
// waits on no row's stores. Without TAIL (the standalone K6) they do
// band_partial after their rows, and ``counter``, ``s`` and ``pol`` are
// unread. minc is not __restrict__: the tail rewrites it.
template <bool TAIL>
__global__ void __launch_bounds__(PT) fused_pivot_tiles(
        float *__restrict__ Tt, float *__restrict__ costs,
        const float *__restrict__ colk, const float *__restrict__ ah,
        const float *__restrict__ p_ptr, const float *minc_ptr,
        const int *__restrict__ k_ptr, const unsigned char *__restrict__ do_ptr,
        int M, int R, int r, float eps, float *__restrict__ part_val,
        int *__restrict__ part_idx, float *__restrict__ part_bval,
        int *__restrict__ part_bidx, unsigned *__restrict__ counter,
        SeqStep<float, float> s, seq::Policy pol) {
    const bool apply = *do_ptr != 0;
    const float p = *p_ptr;
    const float inv_p = apply ? __fdiv_rn(1.0f, p) : 1.0f;
    const int k = *k_ptr;
    const int c0 = (blockIdx.x * PT + threadIdx.x) * VEC;
    const bool in = c0 < R;                    // R % 4 == 0: all or nothing
    const float4 ck = in ? *reinterpret_cast<const float4 *>(colk + c0)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (TAIL && blockIdx.y == 0) {
        band_partial(costs, minc_ptr, ck, c0, in, apply, p, r, eps, part_val,
                     part_idx, part_bval, part_bidx);
        k6_tail(apply, part_val, part_idx, part_bval, part_bidx, counter, s,
                pol);
    }

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
    if (TAIL || blockIdx.y != 0) return;
    band_partial(costs, minc_ptr, ck, c0, in, apply, p, r, eps, part_val,
                 part_idx, part_bval, part_bidx);
}

// The standalone K6's fold: one block over the nparts partials, in index
// order, into the outputs.
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
    if (threadIdx.x != 0) return;
    *hd_out = idx;
    *vd_out = val;
    *hb_out = bidx;
    *vb_out = bidx == BIG_INDEX ? CUDART_INF_F : bval;
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
    fused_pivot_tiles<false><<<grid, PT, 0, st>>>(
        Tt, costs, colk, ah, p, minc, k, do_flag, M, R, r, eps, part_val,
        part_idx, part_bval, part_bidx, nullptr, SeqStep<float, float>{},
        seq::Policy{});
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fused_pivot_finish<<<1, PT, 0, st>>>(part_val, part_idx, part_bval,
                                         part_bidx, nx, hd_out, vd_out,
                                         hb_out, vb_out);
    return (int)cudaGetLastError();
}

// K6 in the K6 loop's chunk graph, one kernel: its operands p, minc, k and
// do from the loop's scalars (``step``, the host's array of kernels/seq.py
// SeqScalars' pointers, pure f32); the fold and the step after the pass
// the tail of the first row band's last block, under max_iter, eps, the
// Bland mode, threshold and then_pre. ``counter`` is the tail's arrival
// counter, zero before the first call (the tail leaves it zero).
extern "C" int fused_pivot_seq_launch(float *Tt, float *costs,
                                      const float *colk, const float *ah,
                                      int M, int R, int r, float eps,
                                      float *part_val, int *part_idx,
                                      float *part_bval, int *part_bidx,
                                      unsigned *counter, const void *step,
                                      long long max_iter, int bland_mode,
                                      int threshold, int then_pre,
                                      void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    SeqStep<float, float> s;
    memcpy(&s, step, sizeof s);
    const int nx = (R + COLS - 1) / COLS;
    const dim3 grid(nx, (M + ROWS - 1) / ROWS);
    fused_pivot_tiles<true><<<grid, PT, 0, st>>>(
        Tt, costs, colk, ah, s.p, s.minc, s.k, s.do_, M, R, r, eps, part_val,
        part_idx, part_bval, part_bidx, counter, s,
        seq::Policy{max_iter, (double)eps, bland_mode, threshold, then_pre});
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
// at 3.35 TB/s. Design: a lane's tableau is one contiguous range of M R
// elements, element e at row e / R and column e % R, so one path serves
// every R. Its 16-byte aligned vectors go in tiles of R1_THREADS x R1_VECS
// (kernels/pivot.py rank1_plan counts them), a thread's vectors R1_THREADS
// apart so a warp's accesses are contiguous; the fewer than one vector's
// elements before the first aligned vector and after the last go element by
// element with the lane's first tile. One block a tile, the grid (tiles a
// lane, lanes): the card dispatches the blocks in order, so the blocks in
// flight cover one contiguous stretch of the tableau, and a block of a lane
// whose flag is clear exits after reading it. A thread issues all its loads
// before its first store (40 registers: six blocks an SM). factor and colk
// (a few KB a lane, hot in L1 and L2) are read through the read-only path.
// Measured on an H100 at config 3 (tools/rank1_probe.py,
// tools/rank1_variants.cu): 89-90% of the bound at any tile width;
// persistent blocks walking the live tiles round robin drift apart and
// reach 77-81% (claiming each next tile from a counter, which keeps the
// tiles in flight in order, 90%); a ring of bulk async copies 70-75%.
//
// The same tiles at one lane are the sequential loops' rank-1 update
// (seq_rank1; the pivot's other kernels are csrc/seq.cu): ROWK writes the
// leaving row k as colk / p with one correctly rounded division, as
// solver.pivot_update's ``Tt[k] = colk / p`` after its addr_, reading k, p
// and the do flag from the loop's 0-dim tensors, and factor = a_h / p from
// the fixed buffer seq_colk fills. A skipped pivot leaves the tableau
// untouched, where the eager loop's addr_ with factor 0 ran a full pass.
// Bound: one read and one write of the tableau, 2 M R sizeof(T) bytes
// (3.22 GB at the 8192^2 f64 tableau, 0.96 ms at 3.35 TB/s).

namespace {

constexpr int R1_THREADS = 256;
constexpr int R1_VECS = 4;         // 16-byte vectors a thread a tile

// Tiles of one lane of M x R elements of item bytes (kernels/pivot.py
// rank1_lane_tiles): its 16-byte vectors R1_THREADS x vecs a tile, at least
// one tile (which also takes the elements outside the aligned vectors).
long long rank1_lane_tiles(int M, int R, int item, int vecs) {
    const long long nvec = (long long)M * R * item / 16;
    const long long tv = (long long)R1_THREADS * vecs;
    return nvec > 0 ? (nvec + tv - 1) / tv : 1;
}

// t - f * c with the product and the difference rounded apart.
__device__ __forceinline__ float mul_sub_rn(float t, float f, float c) {
    return __fsub_rn(t, __fmul_rn(f, c));
}
__device__ __forceinline__ double mul_sub_rn(double t, double f, double c) {
    return __dsub_rn(t, __dmul_rn(f, c));
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

// Tile c of a lane, as one thread sees it.
template <typename T>
struct R1Tile {
    T *t;                  // the lane's tableau
    const T *f, *ck;       // its factor and colk
    size_t n, h, nv;       // its elements; those before the first aligned
                           // vector; its aligned vectors
    long long v0;          // the thread's first vector in the tile
    bool first;            // the lane's first tile: it also does head and tail
    int k;                 // ROWK: the row written as ck / p
    T p;
};

// One element at (row, col), then (row, col) steps to the next element.
// With ROWK, row k becomes ck / p (one rounding), as solver.pivot_update's
// ``Tt[k] = colk / p`` after its addr_.
template <typename T, bool ROWK>
__device__ __forceinline__ T rank1_elem(T x, const R1Tile<T> &d, int &row,
                                        int &col, int R) {
    const T y = ROWK && row == d.k
                    ? seq::div_rn(__ldg(d.ck + col), d.p)
                    : mul_sub_rn(x, __ldg(d.f + row), __ldg(d.ck + col));
    if (++col == R) {
        col = 0;
        ++row;
    }
    return y;
}

// One vector whose first element is at (row, col); the fast form when its
// elements lie in one row other than row k.
template <bool ROWK>
__device__ __forceinline__ double2 rank1_vec(double2 x,
                                             const R1Tile<double> &d, int row,
                                             int col, int R) {
    if (col + 2 <= R && !(ROWK && row == d.k)) {
        const double fr = __ldg(d.f + row);
        return make_double2(mul_sub_rn(x.x, fr, __ldg(d.ck + col)),
                            mul_sub_rn(x.y, fr, __ldg(d.ck + col + 1)));
    }
    double2 y;
    y.x = rank1_elem<double, ROWK>(x.x, d, row, col, R);
    y.y = rank1_elem<double, ROWK>(x.y, d, row, col, R);
    return y;
}
template <bool ROWK>
__device__ __forceinline__ float4 rank1_vec(float4 x, const R1Tile<float> &d,
                                            int row, int col, int R) {
    if (col + 4 <= R && !(ROWK && row == d.k)) {
        const float fr = __ldg(d.f + row);
        return make_float4(mul_sub_rn(x.x, fr, __ldg(d.ck + col)),
                           mul_sub_rn(x.y, fr, __ldg(d.ck + col + 1)),
                           mul_sub_rn(x.z, fr, __ldg(d.ck + col + 2)),
                           mul_sub_rn(x.w, fr, __ldg(d.ck + col + 3)));
    }
    float4 y;
    y.x = rank1_elem<float, ROWK>(x.x, d, row, col, R);
    y.y = rank1_elem<float, ROWK>(x.y, d, row, col, R);
    y.z = rank1_elem<float, ROWK>(x.z, d, row, col, R);
    y.w = rank1_elem<float, ROWK>(x.w, d, row, col, R);
    return y;
}

template <typename T, int U>
__device__ __forceinline__ R1Tile<T> rank1_tile(T *Tt, const T *factor,
                                                const T *colk, int lane,
                                                long long c, int M, int R) {
    constexpr int PER = (int)(16 / sizeof(T));
    R1Tile<T> d;
    d.n = (size_t)M * R;
    d.t = Tt + (size_t)lane * d.n;
    d.f = factor + (size_t)lane * M;
    d.ck = colk + (size_t)lane * R;
    const size_t mis = reinterpret_cast<uintptr_t>(d.t) % 16;
    const size_t head = mis ? (16 - mis) / sizeof(T) : 0;
    d.h = head < d.n ? head : d.n;
    d.nv = (d.n - d.h) / PER;
    d.v0 = c * (R1_THREADS * U) + threadIdx.x;
    d.first = c == 0;
    d.k = -1;
    d.p = (T)1;
    return d;
}

// The thread's U vectors of the tile, R1_THREADS vectors apart.
template <typename T, int U>
__device__ __forceinline__ void rank1_load(const R1Tile<T> &d,
                                           typename Vec16<T>::type *a) {
    using V = typename Vec16<T>::type;
    const V *tv = reinterpret_cast<const V *>(d.t + d.h);
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const long long v = d.v0 + u * R1_THREADS;
        if (v < (long long)d.nv) a[u] = tv[v];
    }
}

// Updates and stores the thread's U vectors; in the lane's first tile, also
// the head and the tail, element by element.
template <typename T, int U, bool ROWK>
__device__ __forceinline__ void rank1_store(const R1Tile<T> &d,
                                            const typename Vec16<T>::type *a,
                                            int R) {
    using V = typename Vec16<T>::type;
    constexpr int PER = (int)(16 / sizeof(T));
    // A thread's next vector lies R1_THREADS vectors on: sq rows, sr columns.
    const int sq = (R1_THREADS * PER) / R, sr = (R1_THREADS * PER) % R;
    V *tv = reinterpret_cast<V *>(d.t + d.h);
    const size_t e = d.h + (size_t)d.v0 * PER;
    int row = (int)(e / R), col = (int)(e % R);
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const long long v = d.v0 + u * R1_THREADS;
        if (v < (long long)d.nv)
            tv[v] = rank1_vec<ROWK>(a[u], d, row, col, R);
        col += sr;
        row += sq;
        if (col >= R) {
            col -= R;
            ++row;
        }
    }
    if (!d.first) return;
    const size_t tail = d.h + d.nv * PER;
    const size_t i = threadIdx.x < d.h ? threadIdx.x
                                      : tail + (threadIdx.x - d.h);
    if (i < d.n && (i < d.h || i >= tail)) {
        int r = (int)(i / R), c = (int)(i % R);
        d.t[i] = rank1_elem<T, ROWK>(d.t[i], d, r, c, R);
    }
}

// One tile a block: grid (tiles a lane, lanes). ROWK (one lane, the
// sequential loop's seq_rank1): row *k_ptr becomes colk / *p_ptr.
template <typename T, int U, bool ROWK>
__global__ void __launch_bounds__(R1_THREADS)
batch_rank1_tiles(T *__restrict__ Tt, const T *__restrict__ factor,
                  const T *__restrict__ colk,
                  const unsigned char *__restrict__ do_flag, int M, int R,
                  const int *__restrict__ k_ptr, const T *__restrict__ p_ptr) {
    const int lane = blockIdx.y;
    if (!do_flag[lane]) return;
    R1Tile<T> d = rank1_tile<T, U>(Tt, factor, colk, lane, blockIdx.x, M, R);
    if (ROWK) {
        d.k = *k_ptr;
        d.p = *p_ptr;
    }
    typename Vec16<T>::type a[U];
    rank1_load<T, U>(d, a);
    rank1_store<T, U, ROWK>(d, a, R);
}

// The plan (vecs a thread, the tiles a lane) comes from kernels/pivot.py
// rank1_plan; a plan this kernel cannot run, or whose tile count differs
// from its own, is refused with cudaErrorInvalidValue, as is ROWK with
// more than one lane.
template <typename T, bool ROWK>
int batch_rank1_run(T *Tt, const T *factor, const T *colk,
                    const unsigned char *do_flag, int B, int M, int R,
                    int vecs, long long tiles, const int *k, const T *p,
                    void *stream) {
    if (B < 1 || B > 65535 || M < 1 || R < 1 || vecs != R1_VECS
        || tiles > 2147483647LL
        || tiles != rank1_lane_tiles(M, R, (int)sizeof(T), vecs)
        || (ROWK && B != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    batch_rank1_tiles<T, R1_VECS, ROWK>
        <<<dim3((unsigned)tiles, B), R1_THREADS, 0, st>>>(
            Tt, factor, colk, do_flag, M, R, k, p);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiles a lane of batch_rank1 (the plan's count must equal it).
long long batch_rank1_lane_tiles(int M, int R, int item, int vecs) {
    return rank1_lane_tiles(M, R, item, vecs);
}

// Tt (B, M, R), factor (B, M), colk (B, R), all f64 (f32 below); do (B,);
// then the plan: vecs a thread, tiles a lane.
int batch_rank1_f64_launch(double *Tt, const double *factor,
                           const double *colk, const unsigned char *do_flag,
                           int B, int M, int R, int vecs, long long tiles,
                           void *stream) {
    return batch_rank1_run<double, false>(Tt, factor, colk, do_flag, B, M, R,
                                          vecs, tiles, nullptr, nullptr,
                                          stream);
}

int batch_rank1_f32_launch(float *Tt, const float *factor, const float *colk,
                           const unsigned char *do_flag, int B, int M, int R,
                           int vecs, long long tiles, void *stream) {
    return batch_rank1_run<float, false>(Tt, factor, colk, do_flag, B, M, R,
                                         vecs, tiles, nullptr, nullptr,
                                         stream);
}

// The sequential loop's update: Tt (M, R), fac (M,) and colk (R,) of
// ``item`` bytes (8: f64, 4: f32), the pivot's do flag, k and p; the plan
// as batch_rank1's for one lane.
int seq_rank1_launch(void *Tt, const void *fac, const void *colk,
                     const unsigned char *do_flag, const int *k,
                     const void *p, int M, int R, int item, int vecs,
                     long long tiles, void *stream) {
    if (item == 8)
        return batch_rank1_run<double, true>(
            static_cast<double *>(Tt), static_cast<const double *>(fac),
            static_cast<const double *>(colk), do_flag, 1, M, R, vecs, tiles,
            k, static_cast<const double *>(p), stream);
    if (item == 4)
        return batch_rank1_run<float, true>(
            static_cast<float *>(Tt), static_cast<const float *>(fac),
            static_cast<const float *>(colk), do_flag, 1, M, R, vecs, tiles,
            k, static_cast<const float *>(p), stream);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
