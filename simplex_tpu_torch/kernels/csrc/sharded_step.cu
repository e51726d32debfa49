// The per-pivot step of the sharded kernel loop: the glue around K5 (the
// owner's entering column), the column's all_reduce, K2 on the slice and
// the candidates' two all_gathers.
//
// Replaces no Pallas kernel: in the JAX package this glue is XLA code that
// the jitted lax.fori_loop under shard_map fuses around the two passes and
// the collectives (simplex_tpu/parallel/sharded.py:666-768). The port's
// eager loop ran it as about 110 torch calls a pivot; here the window of L
// pivots is one CUDA graph: sharded_step_pre, then per pivot K5 (for every
// pivot but the first with the fold and the step before K5 as its head,
// csrc/blocked.cu), the all_reduce, sharded_ratio, K2 with the step after
// K2 (step.cuh step::post) and the pack into the send buffers as its tail
// (csrc/blocked.cu colk_costs_fused with PACK), and the two all_gathers,
// then sharded_fold: 5L + 2 nodes at one rank.
//
// * sharded_step_pre (one thread): active, h, minc and optimal as the
//   single-card step_pre, then h's local index in the slice and whether
//   this rank owns it, and the devex weight at h carried by the fold
//   (sharded_step.cuh sharded::pre).
// * sharded_ratio (one thread-block cluster): the min-ratio test on the
//   summed column -- the first index of the smallest b / a_h over a_h >=
//   eps, as torch.argmin -- and the scalar tail of the single-card
//   step_mid: do, p, bk, u = minc / p.
// * sharded_pack (one thread): the slice's candidates from K2 into the
//   all_gather send buffers: [v_d, v_b, w at h_d, w at h_b, key] f64 with
//   key = v_d^2 / w_d (-inf with no eligible column) under devex, [v_d,
//   v_b] otherwise; the candidates' global indices int32 -- the window
//   boundary's pack, after the re-pricing's candidates. Within a window
//   K2's tail packs the same values from its registers, in place of
//   this kernel's node a pivot (1.4 us a call on NVIDIA H100 80GB HBM3,
//   700.00 W, PERF.md).
// * sharded_fold (one thread): the fold of the gathered candidates
//   (sharded_step.cuh sharded::fold) -- the window's last node, and the
//   boundary's fold after its re-pricing. Within a window the fold runs
//   as K5's head.
//
// Bound on the card: latency. The one-thread kernels read and write a few
// dozen bytes. sharded_ratio reads a_h and b once (12 bytes a constraint,
// 0.03 us at HBM's rate for M = 8192). The one-block kernel it replaced
// (1,024 threads on one SM, eight dependent f64 divides a thread, a
// ten-level shared-memory tree with a barrier at each level, then loads
// of a_h[k], b[k], base[k] and the scalars one behind the other) took
// 6.4 us a call on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md). Design:
// one cluster of RATIO_BLOCKS = 16 blocks of RATIO_THREADS = 256 threads
// on as many SMs; each thread issues the loads of its constraints
// (strided by the cluster's thread count: two at M = 8192, three at the
// north star's 10,112; four at a time past 16,384) before it waits on
// any, forms its quotients, and folds them in index order; then the
// warps fold by shuffles, each
// block's warp 0 over its warps, and block 0's warp 0 over the blocks'
// results, which every block stores into block 0's shared memory
// (distributed shared memory) before one cluster barrier. On that card
// (tools/sharded_ratio_variants.cu, all bit for bit) 16 x 256 took 3.22
// us at M = 8192 and 3.38 at 10,112, against 3.49 and 3.63 for 8 x 512,
// 3.96 and 4.13 for 8 x 1,024, K1's form -- one block of 128 constraints
// each, a ticket, the last block folding -- 3.58 and 3.62, and the
// one-block kernel 6.16 and 7.07.
// The fold carries the winner's a_h and b, so p == a_h[k] and bk == b[k]
// with no load after it; thread 0 of block 0 loads active, optimal and
// minc while the column's loads are in flight. No workspace, no atomics.
//
// Every result keeps the bits of the plain version (kernels/blocked.py
// sharded_*_plain): the f64 arithmetic is pinned to separate roundings
// with __ddiv_rn / __dmul_rn, so nvcc contracts nothing into an FMA; the
// eps test of the f32 column compares in f32, as torch compares an f32
// tensor with a Python float; NaN orders as torch.argmin and torch.max
// order it; the folds are total orders, so k is the same whatever the
// threads' timing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "cluster.cuh"
#include "sharded_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BIG_INDEX = sharded::BIG_INDEX;
// sharded_ratio's cluster: RATIO_BLOCKS blocks (past the portable 8, so
// launched with the non-portable cluster size allowed) of RATIO_THREADS
// threads, each loading RATIO_PER of its constraints at once (all of them
// up to M = 16,384).
constexpr int RATIO_BLOCKS = 16;
constexpr int RATIO_THREADS = 256;
constexpr int RATIO_PER = 4;
constexpr unsigned FULL = 0xffffffffu;

__global__ void sharded_step_pre_kernel(ShardStep s, sharded::PrePolicy pol) {
    // Every operand at once, then the stores.
    const int status = *s.status, iterations = *s.iterations;
    const bool bland = *s.bland != 0;
    const sharded::Fold f{*s.h_d, *s.v_d, *s.w_d, *s.h_b, *s.v_b, *s.w_b};
    sharded::store(s, sharded::pre(status, iterations, bland, f,
                                   pol.max_iter, pol.eps, pol.offset,
                                   pol.R_loc));
}

// A ratio candidate: its quotient, its row, and the row's a_h and b.
struct Ratio {
    double q;
    int j;
    float a;
    double b;
};

// (q, i) before (q2, i2) in torch.argmin's order: NaN first, then the
// smaller value, ties to the lower index. A total order over (q, i).
__device__ __forceinline__ bool ratio_first(double q, int i, double q2,
                                            int i2) {
    const bool nan = q != q, nan2 = q2 != q2;
    if (nan != nan2) return nan;
    if (!nan && q != q2) return q < q2;
    return i < i2;
}

__device__ __forceinline__ void take_first(Ratio &x, const Ratio &o) {
    if (ratio_first(o.q, o.j, x.q, x.j)) x = o;
}

__device__ __forceinline__ Ratio shfl_xor(const Ratio &x, int off) {
    return Ratio{__shfl_xor_sync(FULL, x.q, off),
                 __shfl_xor_sync(FULL, x.j, off),
                 __shfl_xor_sync(FULL, x.a, off),
                 __shfl_xor_sync(FULL, x.b, off)};
}

// One cluster of NB blocks of NT threads, each walking its constraints
// PER at a time, every load of the PER issued before any is waited for
// (the shipped instantiation: RATIO_BLOCKS, RATIO_THREADS, RATIO_PER;
// tools/sharded_ratio_variants.cu times others).
template <int NB, int NT, int PER>
__global__ void __launch_bounds__(NT) sharded_ratio_kernel(
        ShardStep s, const float *__restrict__ ah,
        const double *__restrict__ b, int M, float eps) {
    constexpr int NW = NT / 32, SPAN = NB * NT;
    static_assert(NW <= 32 && NB <= 32, "one warp folds the warps, blocks");
    __shared__ Ratio warps[NW];
    __shared__ Ratio blocks[NB];                 // block 0's: the blocks'
    __shared__ int wany[NW];
    __shared__ int bany[NB];
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = rank * NT + tid;
    cluster_arrive_relaxed();

    // The tail's operands, then this thread's constraints in index order,
    // PER at a time (one pass up to M = SPAN * PER), then the warp's.
    const bool lead = g == 0;
    bool active = false, optimal = false;
    double minc = 0.0;
    if (lead) {
        active = *s.active != 0;
        optimal = *s.optimal != 0;
        minc = *s.minc;
    }
    const Ratio none{CUDART_INF, BIG_INDEX, 0.0f, 0.0};
    Ratio x = none;
    bool any = false;
    for (int j0 = g; j0 < M; j0 += PER * SPAN) {
        float a[PER];
        double bj[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int j = j0 + i * SPAN;
            if (j < M) {
                a[i] = ah[j];
                bj[i] = b[j];
            }
        }
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int j = j0 + i * SPAN;
            if (j < M) {
                const bool mask = a[i] >= eps;
                any |= mask;
                take_first(x, Ratio{mask ? __ddiv_rn(bj[i], (double)a[i])
                                         : CUDART_INF,
                                    j, a[i], bj[i]});
            }
        }
    }
    any = __any_sync(FULL, any);
    for (int off = 16; off > 0; off >>= 1) take_first(x, shfl_xor(x, off));
    if (NW > 1) {
        if (lane == 0) {
            warps[warp] = x;
            wany[warp] = any;
        }
        __syncthreads();
        // The block's warp 0 over its warps.
        if (warp == 0) {
            x = lane < NW ? warps[lane] : none;
            any = __any_sync(FULL, lane < NW && wany[lane] != 0);
            for (int off = NW / 2; off > 0; off >>= 1)
                take_first(x, shfl_xor(x, off));
        }
    }
    // Lane 0 stores the block's result into block 0's shared memory once
    // every block runs.
    cluster_wait();
    if (tid == 0) {
        *cl.map_shared_rank(&blocks[rank], 0) = x;
        *cl.map_shared_rank(&bany[rank], 0) = any;
    }
    cluster_arrive();
    cluster_wait();
    if (rank != 0 || warp != 0) return;

    // Block 0's warp 0 over the blocks, then the tail in lane 0.
    const bool has = lane < NB;
    x = has ? blocks[lane] : none;
    any = __any_sync(FULL, has && bany[lane] != 0);
    for (int off = NB / 2; off > 0; off >>= 1)
        take_first(x, shfl_xor(x, off));
    if (lane != 0) return;
    const bool unb = !any;                       // x.j < M: every q is ordered
    const bool d = active && !(optimal || unb);
    const float p = d ? x.a : 1.0f;
    *s.k = x.j;
    *s.unb = unb;
    *s.do_ = d;
    *s.p = p;
    *s.bk = x.b;
    *s.u = d ? __ddiv_rn(minc, (double)p) : 0.0;
}

// sharded_ratio_kernel<NB, NT, PER> as one cluster (csrc/cluster.cuh).
template <int NB, int NT, int PER>
int launch_ratio(const ShardStep &s, const float *ah, const double *b, int M,
                 float eps, cudaStream_t st) {
    auto kernel = sharded_ratio_kernel<NB, NT, PER>;
    static const cudaError_t e = allow_cluster(kernel, NB);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, NB, NT, false, st, s, ah, b, M, eps);
}

__global__ void sharded_pack_kernel(ShardStep s, const float *w, int offset,
                                    int R_loc, double *vals, int *idx) {
    const int hd = *s.h_d, hb = *s.h_b;
    const double vd = *s.v_d;
    vals[0] = vd;
    vals[1] = *s.v_b;
    if (w != nullptr) {
        const bool has = hb < BIG_INDEX;
        const double wd = (double)w[min(hd, R_loc - 1)];
        vals[2] = wd;
        vals[3] = has ? (double)w[min(hb, R_loc - 1)] : 1.0;
        vals[4] = has ? __ddiv_rn(__dmul_rn(vd, vd), wd) : -CUDART_INF;
    }
    idx[0] = hd >= BIG_INDEX ? BIG_INDEX : offset + hd;
    idx[1] = hb >= BIG_INDEX ? BIG_INDEX : offset + hb;
}

__global__ void sharded_fold_kernel(ShardStep s, const double *V,
                                    const int *I, int P, int kv) {
    sharded::store(s, sharded::fold(V, I, P, kv));
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes). Each takes the host copy of the pointers and
// returns cudaGetLastError() as an int.

extern "C" {

int sharded_step_pre_launch(const ShardStep *s, long long max_iter,
                            double eps, int offset, int R_loc, void *stream) {
    sharded_step_pre_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        *s, sharded::PrePolicy{max_iter, eps, offset, R_loc});
    return (int)cudaGetLastError();
}

// One cluster of RATIO_BLOCKS blocks of RATIO_THREADS threads.
int sharded_ratio_launch(const ShardStep *s, const float *ah, const double *b,
                         int M, float eps, void *stream) {
    return launch_ratio<RATIO_BLOCKS, RATIO_THREADS, RATIO_PER>(
        *s, ah, b, M, eps, static_cast<cudaStream_t>(stream));
}

int sharded_pack_launch(const ShardStep *s, const float *w, int offset,
                        int R_loc, double *vals, int *idx, void *stream) {
    sharded_pack_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        *s, w, offset, R_loc, vals, idx);
    return (int)cudaGetLastError();
}

int sharded_fold_launch(const ShardStep *s, const double *V, const int *I,
                        int P, int kv, void *stream) {
    sharded_fold_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        *s, V, I, P, kv);
    return (int)cudaGetLastError();
}

}  // extern "C"
