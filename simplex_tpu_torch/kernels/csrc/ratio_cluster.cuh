// The min-ratio test as one thread-block cluster whose blocks fold over
// distributed shared memory, then the step between: shared by csrc/seq.cu
// (seq_ratio, seq_ratio_colk, seq_ratio_snapshot) and csrc/eta.cu
// (eta_ratio_summed, on the column the sharded loop's all_reduce summed).
//
// Every result keeps the bits of the plain version (kernels/seq.py
// _ratio_plain): the quotient b / a_h in V rounded once, an f32 a_h
// widened exactly to f64, eps compared in a_h's type, the rows with a_h <
// eps counted as +inf as torch.where puts them, and every fold a total
// order (seq::first), so k is torch.argmin's whatever the blocks'
// schedule.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "seq_step.cuh"

namespace seq {

// This thread's rows of the ratio test (rows g, g + SPAN, ...), PER at a
// time, b and the loads of a_h of the PER issued before any is waited
// for: with GATHER a_h gathered from Tt's column h into ah, else read from
// ah (the sharded loops' column, summed across the ranks); each row's
// candidate folded into x and its eligibility into any. The first PER
// rows' a_h and b stay in a0 and b0; with B_HELD their b comes in b0 (the
// caller loaded it before it waited for the kernel before).
template <typename T, typename V, int PER_, int SPAN, bool GATHER = true,
          bool B_HELD = false>
__device__ __forceinline__ void ratio_rows(const T *__restrict__ Tt,
                                           const V *__restrict__ b,
                                           T *__restrict__ ah, int M, int R,
                                           int h, T eps, int g,
                                           Ratio<T, V> &x, bool &any,
                                           T (&a0)[PER_], V (&b0)[PER_]) {
    for (int j0 = g; j0 < M; j0 += PER_ * SPAN) {
        T a[PER_];
        V bj[PER_];
#pragma unroll
        for (int q = 0; q < PER_; ++q) {
            const int j = j0 + q * SPAN;
            if (j < M) {
                bj[q] = B_HELD && j0 == g ? b0[q] : b[j];
                a[q] = GATHER ? Tt[(size_t)j * R + h] : ah[j];
            }
        }
#pragma unroll
        for (int q = 0; q < PER_; ++q) {
            const int j = j0 + q * SPAN;
            if (j < M) {
                if (GATHER) ah[j] = a[q];
                const bool mask = a[q] >= eps;
                any |= mask;
                take_first(x, Ratio<T, V>{mask ? div_rn(bj[q], (V)a[q])
                                               : inf<V>(),
                                          j, a[q], bj[q]});
            }
        }
        if (j0 == g) {
#pragma unroll
            for (int q = 0; q < PER_; ++q) {
                a0[q] = a[q];
                b0[q] = bj[q];
            }
        }
    }
}

// The ratio test over a cluster of NB blocks, every block folding every
// block's result: this thread's rows (the first PER's a_h and b kept in a0
// and b0), the block's fold, the block's result into every block's shared
// memory (distributed shared memory) before one cluster barrier, the NB
// results folded in one order, and the step between in each block's
// thread 0 on its operands (active, optimal and minc: thread 0's); block 0
// stores it. Every thread of the block gets it. The caller has arrived at
// the cluster barrier (relaxed) before.
template <typename T, typename V, int NB, int NW>
struct RatioShared {
    Ratio<T, V> warps[NW];
    int wany[NW];
    Ratio<T, V> parts[NB];
    int pany[NB];
    Between<T, V> held;
};

template <typename T, typename V, int NB, int NT, int PER_,
          bool GATHER = true, bool B_HELD = false>
__device__ __forceinline__ Between<T, V> ratio_cluster(
        RatioShared<T, V, NB, NT / 32> &sh, const T *__restrict__ Tt,
        const V *__restrict__ b, T *__restrict__ ah, int M, int R, int h,
        double eps, bool active, bool optimal, V minc,
        const SeqStep<T, V> &s, T (&a0)[PER_], V (&b0)[PER_]) {
    constexpr int NW = NT / 32, SPAN = NB * NT;
    static_assert(NW <= 32 && NB <= 32, "one warp folds the warps, blocks");
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const Ratio<T, V> none{inf<V>(), BIG_INDEX, (T)0, (V)0};
    Ratio<T, V> x = none;
    bool any = false;
    ratio_rows<T, V, PER_, SPAN, GATHER, B_HELD>(
            Tt, b, ah, M, R, h, (T)eps, rank * NT + tid, x, any, a0, b0);
    block_fold<NW>(x, any, none, sh.warps, sh.wany);
    cluster_wait();
    if (warp == 0 && lane < NB) {
        *cl.map_shared_rank(&sh.parts[rank], lane) = x;
        *cl.map_shared_rank(&sh.pany[rank], lane) = any;
    }
    cluster_arrive();
    cluster_wait();
    if (warp == 0) {
        x = warp_fold(lane < NB ? sh.parts[lane] : none);
        any = __any_sync(FULL, lane < NB && sh.pany[lane] != 0);
        if (lane == 0) {
            const Between<T, V> w = between(x, any, active, optimal, minc);
            sh.held = w;
            if (rank == 0) store(s, w);
        }
    }
    __syncthreads();
    return sh.held;
}

}  // namespace seq
