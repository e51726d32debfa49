// The sequential loops' per-pivot kernels (solver.solve_loop and
// solve_loop_pallas, one CUDA graph a chunk of SEQ_CHUNK pivots).
//
// Replaces no Pallas kernel: in the JAX package the sequential loops are
// lax.while_loops whose pivot is XLA code (simplex_tpu/solver.py:116-157
// iteration_body, with ratio_test :99-113 and choose_entering :79-96; the
// K6 loop's glue around fused_pivot, :239-294). The port's eager loop ran
// that pivot as about 40 torch calls; here a pivot of either loop is two
// nodes:
//
// * seq_ratio_colk (the default loop; one thread-block cluster): the
//   ratio test, then the pivot row's pass, with one cluster barrier
//   between them and one after.
//   - The ratio test: gathers the entering column a_h = Tt[:, h] into the
//     loop's fixed ``ah`` and takes the first index of the smallest b /
//     a_h over a_h >= eps, the quotient in V, NaN first as torch.argmin
//     orders it, the rows with a_h < eps counted as +inf as torch.where
//     puts them, so k is torch.argmin's. Every block folds the blocks'
//     results and runs the step between (k, bk, unbounded, do = active and
//     not (optimal or unbounded), p = a_h[k] where done, else 1, and u =
//     minc / p); block 0 stores it.
//   - The pass: copies the leaving row colk = Tt[k] into the fixed
//     ``colk`` before the rank-1 update overwrites it, updates the costs
//     (costs -= u * colk, two roundings in V) and folds the next entering
//     candidates over them (the Dantzig argmin of the live columns in
//     torch.argmin's order, Bland's lowest eligible index); forms factor =
//     a_h / p (one rounding in T) into the fixed ``fac`` and updates b (b
//     -= bk * factor, b[k] = bk / p, in V). Block 0 folds the blocks'
//     candidates, stores them and base[k] = h, then runs the step after
//     the pivot and the next pivot's step before the ratio test
//     (seq_step.cuh). It counts a launch of seq_ratio and one of seq_colk
//     (kernels/seq.py TAILS).
// * the rank-1 update (csrc/pivot.cu seq_rank1, batch_rank1's tiles for one
//   lane with row k written as colk / p).
// * seq_ratio_snapshot (the K6 loop; one cluster, pure f32): the ratio
//   test and the step between as seq_ratio_colk runs them, then the
//   snapshot K6 reads -- row k copied into the fixed ``colk`` 16 bytes a
//   load (R % 4 == 0), and where the pivot is done b (from the a_h and b
//   each thread holds for its first rows) and base[k] = h; no costs (K6
//   updates them), no fold, no second barrier. It counts a launch of
//   seq_ratio and one of seq_snapshot (kernels/seq.py TAILS).
// * K6 with the step after as the tail of its last tile block
//   (csrc/pivot.cu).
//
// The sequential sharded loop (parallel.sharded.solve_loop_sharded, the
// JAX loop under shard_map, simplex_tpu/parallel/sharded.py:240-286), on
// each rank's slice of the variable axis, a pivot after the two
// all_gathers of the candidates every rank packed:
//
// * seq_fold_column (a grid, one thread a row): the fold of the gathered
//   candidates in every warp (sharded_step.cuh sharded::fold_warp), then
//   the owner's column of the slice, or zeros, into ``ah``, which an
//   all_reduce sums across the ranks, and the step before the ratio test
//   in block 0's thread 0; it lets the next kernel launch as it starts;
// * seq_ratio_colk's SHARDED form: the ratio test on the summed ``ah``,
//   the pass over the slice, the slice's candidates packed into the
//   all_gather send buffers, and the step after without the next step
//   before; a programmatic dependent launch (the costs of its first
//   columns, b of its first rows and the step after's own operands loaded
//   before it waits), of CLUSTER_THREADS threads a block, or
//   SHARDED_THREADS_WIDE where one pass of CLUSTER_BLOCKS x
//   CLUSTER_THREADS x PER loads does not cover the slice's columns
//   (kernels/seq.py seq_sharded_threads chooses on the host);
// * seq_rank1 on the slice.
//
// seq_ratio (one cluster: the ratio test and the step between alone,
// block 0 folding) is what the K6 loop launched before the snapshot
// became its tail; it stays, the baseline that the tails' own cost is
// measured against.
//
// plus seq_step_pre (one thread) once a chunk, before its first pivot:
// 2 SEQ_CHUNK + 1 nodes in either loop; the sharded loop's chunk holds 3
// SEQ_CHUNK kernels and its collectives (at one NCCL rank two device
// copies a pivot). Every kernel reads its
// scalars from the loop's fixed 0-dim tensors (kernels.seq.SeqScalars), so
// the chunk's graph holds no host value but max_iter, eps, r and the Bland
// policy.
//
// Bound on the card: latency, not bytes. The ratio test moves M (2
// sizeof(T) + sizeof(V)) bytes (0.20 MB at the 8192^2 f64 tableau: 0.06 us
// at 3.35 TB/s), the pass 2 R sizeof(T) + 2 R sizeof(V) + M (2 sizeof(T) +
// 2 sizeof(V)) (0.98 MB, 0.29 us); each is a dependent load (h or k, then
// the column or the row), a fold across the card and the step. The forms
// they replaced (K1's and K2's: one thread a row or a column over a grid,
// a partial a block in a workspace, an acq_rel arrival ticket, the last
// block folding the partials past L1; three nodes a pivot) took 4.33 and
// 4.39 us at M 8,192, R 24,576 on an NVIDIA H100 80GB HBM3, 700.00 W
// (PERF.md). Design: one cluster of CLUSTER_BLOCKS blocks of
// CLUSTER_THREADS threads (sharded_ratio's, csrc/sharded_step.cu), each
// thread walking its rows and columns (strided by the cluster's thread
// count) PER at a time, every load of the PER issued before any is waited
// for; the costs of its first PER columns and the step's scalars are
// loaded before h; the rows' a_h and b gathered for the ratio test stay in
// registers for the factors and b; the warps fold by shuffles, each
// block's warp 0 over its warps, and the blocks' results go into the
// shared memory of the blocks that fold them (distributed shared memory)
// before a cluster barrier. No workspace, no atomics, no counter. The
// ratio test's winner carries its a_h and b, so p == a_h[k] and bk == b[k]
// with no load after the fold. The snapshot was a grid of its own (R/256 +
// M/256 blocks, one column or row a thread) that reloaded k, do, p and bk
// before its dependent loads: 1.80 us at 2048 x 6144, 1.2% of its bound,
// and a node's launch gap; as the cluster's tail it starts from the step
// between in registers and costs 0.48-0.55 us there (seq_ratio_snapshot
// less seq_ratio alone; the two kernels it replaced 5.20 us a pivot, it
// 4.09, graphs of 50 in turns, tools/k6_tail_variants.cu). On that card
// (tools/seq_variants.cu, every form bit for bit against the kernels it
// replaced) one pivot's ratio test and pass took, a CUDA graph of 50
// pivots a replay: at the 1,024^2 f64
// tableau (it stays in L2 in the loop) 6.65 us for this kernel at 16 x 256
// x 4, against 8.55 for the two it replaced, 7.64 for the two as clusters
// and 7.05-8.70 for other shapes of this one (8 or 16 blocks, 128-1,024
// threads, 1-8 at a time); at 8,192 x 24,576 with L2 evicted 9.71 against
// 11.08 and 10.82 (16 x 512 x 4: 8.83, but 7.22 at 1,024^2). The
// sharded form, the column then the pass, graphs of 50 in turns (the
// sharded mode of that tool): launched behind the column it took 7.64 us
// against 8.04 without PDL at 1,024 x 3,072; at 8,192 x 24,576 8.32 at 16
// x 512 and 8.87 at 16 x 256 against 9.15, with L2 evicted 9.95 and 10.71
// against 11.40; 16 x 256 stays ahead up to 16,384 columns (4,096 x
// 16,384 cold: 9.23 against 9.44 at 16 x 512), 16 x 512 past them (4,096
// x 20,480 cold: 9.44 against 9.82).
//
// Every result keeps the bits of the plain version (kernels/seq.py
// seq_*_plain): every product, quotient and difference is rounded apart
// with the _rn intrinsics (nvcc contracts none of them), an f32 a_h widens
// exactly to f64 before the quotient, eps is compared in the operand's
// type, as torch compares a tensor with a Python float, and every fold is
// a total order, so the results do not depend on the blocks' schedule.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "cluster.cuh"
#include "ratio_cluster.cuh"
#include "seq_step.cuh"
#include "sharded_step.cuh"

namespace cg = cooperative_groups;

namespace {

using seq::BIG_INDEX;
using seq::Between;
using seq::between;
using seq::block_fold;
using seq::Cands;
using seq::div_rn;
using seq::first;
using seq::inf;
using seq::mul_rn;
using seq::Ratio;
using seq::ratio_cluster;
using seq::ratio_rows;
using seq::RatioShared;
using seq::store;
using seq::sub_rn;
using seq::take_first;
using seq::warp_fold;

// The clusters: CLUSTER_BLOCKS blocks (past the portable 8, so launched
// with the non-portable cluster size allowed) of CLUSTER_THREADS threads,
// each thread walking its rows and columns PER at a time.
constexpr int CLUSTER_BLOCKS = 16;
constexpr int CLUSTER_THREADS = 256;
constexpr int PER = 4;
// The sequential sharded loop's seq_ratio_colk on a slice wider than one
// pass of CLUSTER_BLOCKS x CLUSTER_THREADS x PER columns.
constexpr int SHARDED_THREADS_WIDE = 512;
using seq::FULL;

// The (tableau, vector) dtype pairs (kernels/seq.py PAIRS).
enum Pair { PAIR_F64 = 0, PAIR_MIXED = 1, PAIR_F32 = 2 };

// The host's array of pointers (kernels/seq.py _SeqPtrs) as the struct.
template <typename T, typename V>
SeqStep<T, V> step_of(const void *ptrs) {
    SeqStep<T, V> s;
    memcpy(&s, ptrs, sizeof s);
    return s;
}

// ---------------------------------------------------------------------------
// seq_step_pre: the first pivot's step before the ratio test, once a chunk.

template <typename T, typename V>
__global__ void seq_step_pre_kernel(SeqStep<T, V> s, long long max_iter,
                                    double eps) {
    // Every operand at once, then the stores.
    const int status = *s.status, iterations = *s.iterations;
    const bool bland = *s.bland != 0;
    const seq::Candidates<V> c{*s.h_d, *s.v_d, *s.h_b, *s.v_b};
    seq::pre(s, status, iterations, bland, c, max_iter, eps);
}

// ---------------------------------------------------------------------------
// The pass, one thread's share (the ratio test's: ratio_cluster.cuh).

// b and the factors of a done pivot over this thread's rows, PER at a
// time: fac = a_h / p (T; stored with FAC); b -= bk * fac, b[k] = bk / p
// (V). The first PER rows' a_h and b come from a0 and b0 where ``held``,
// the others from ah and b (this thread's own stores, or the caller's).
template <typename T, typename V, int PER_, int SPAN, bool FAC = true>
__device__ __forceinline__ void update_rows(V *__restrict__ b,
                                            T *__restrict__ fac,
                                            const T *__restrict__ ah, int M,
                                            const Between<T, V> &w, int g,
                                            bool held, const T (&a0)[PER_],
                                            const V (&b0)[PER_]) {
    for (int j0 = g; j0 < M; j0 += PER_ * SPAN) {
        const bool reg = held && j0 == g;
        T a[PER_];
        V bj[PER_];
#pragma unroll
        for (int q = 0; q < PER_; ++q) {
            const int j = j0 + q * SPAN;
            if (j < M) {
                a[q] = reg ? a0[q] : ah[j];
                bj[q] = reg ? b0[q] : b[j];
            }
        }
#pragma unroll
        for (int q = 0; q < PER_; ++q) {
            const int j = j0 + q * SPAN;
            if (j < M) {
                const T f = div_rn(a[q], w.p);
                if (FAC) fac[j] = f;
                b[j] = j == w.k ? div_rn(w.bk, (V)w.p)
                                : sub_rn(bj[q], mul_rn(w.bk, (V)f));
            }
        }
    }
}

// The pivot row's pass over this thread's columns (g, g + SPAN, ...), PER
// at a time: colk = Tt[k]; where done costs -= u * colk (V); the
// candidates over the live columns (i < r) folded into x. The first PER
// columns' costs come from c0 (loaded before k was known); every load of
// the PER is issued before any is waited for. ``between_loads`` runs after
// the first PER's loads are issued (the factors and b, in the fused
// kernel).
template <typename T, typename V, int PER_, int SPAN, typename F>
__device__ __forceinline__ void colk_cols(const T *__restrict__ Tt,
                                          V *__restrict__ costs,
                                          T *__restrict__ colk, int R, int r,
                                          V eps, const Between<T, V> &w,
                                          int g, const V (&c0)[PER_],
                                          Cands<V> &x, F between_loads) {
    const T *row = Tt + (size_t)w.k * R;
    for (int i0 = g; i0 < R; i0 += PER_ * SPAN) {
        const bool reg = i0 == g;
        T ck[PER_];
        V c[PER_];
#pragma unroll
        for (int q = 0; q < PER_; ++q) {
            const int i = i0 + q * SPAN;
            if (i < R) {
                ck[q] = row[i];
                c[q] = reg ? c0[q] : costs[i];
            }
        }
        if (reg) between_loads();
#pragma unroll
        for (int q = 0; q < PER_; ++q) {
            const int i = i0 + q * SPAN;
            if (i < R) {
                colk[i] = ck[q];
                if (w.d) {
                    c[q] = sub_rn(c[q], mul_rn(w.u, (V)ck[q]));
                    costs[i] = c[q];
                }
                const V cm = i < r ? c[q] : inf<V>();  // torch.where(iota < r)
                take_first(x, Cands<V>{cm, i, cm, cm <= -eps ? i : BIG_INDEX});
            }
        }
    }
    if (g >= R) between_loads();
}

// The costs of this thread's first PER columns, loaded before k is known.
template <typename V, int PER_, int SPAN>
__device__ __forceinline__ void first_costs(const V *__restrict__ costs,
                                            int R, int g, V (&c0)[PER_]) {
#pragma unroll
    for (int q = 0; q < PER_; ++q) {
        const int i = g + q * SPAN;
        if (i < R) c0[q] = costs[i];
    }
}

// Row ``row`` of n4 16-byte vectors into colk, this thread's vectors (g,
// g + SPAN, ...) PER at a time, every load of the PER issued before any
// is waited for; ``between_loads`` runs after the first PER's loads.
template <int PER_, int SPAN, typename F>
__device__ __forceinline__ void copy_row(const float *__restrict__ row,
                                         float *__restrict__ colk, int n4,
                                         int g, F between_loads) {
    const float4 *src = reinterpret_cast<const float4 *>(row);
    float4 *dst = reinterpret_cast<float4 *>(colk);
    for (int i0 = g; i0 < n4; i0 += PER_ * SPAN) {
        float4 v[PER_];
#pragma unroll
        for (int q = 0; q < PER_; ++q) {
            const int i = i0 + q * SPAN;
            if (i < n4) v[q] = src[i];
        }
        if (i0 == g) between_loads();
#pragma unroll
        for (int q = 0; q < PER_; ++q) {
            const int i = i0 + q * SPAN;
            if (i < n4) dst[i] = v[q];
        }
    }
    if (g >= n4) between_loads();
}

// ---------------------------------------------------------------------------
// seq_ratio: the ratio test and the step between alone, one cluster whose
// block 0 folds (the loops run the ratio test inside seq_ratio_colk and
// seq_ratio_snapshot; this is the baseline of their tails' own cost).

template <typename T, typename V, int NB, int NT, int PER_>
__global__ void __launch_bounds__(NT) seq_ratio_kernel(
        const T *__restrict__ Tt, const V *__restrict__ b, int M, int R,
        double eps, T *__restrict__ ah, SeqStep<T, V> s) {
    constexpr int NW = NT / 32, SPAN = NB * NT;
    static_assert(NW <= 32 && NB <= 32, "one warp folds the warps, blocks");
    __shared__ Ratio<T, V> warps[NW];
    __shared__ int wany[NW];
    __shared__ Ratio<T, V> parts[NB];            // block 0's: the blocks'
    __shared__ int pany[NB];
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = rank * NT + tid;
    cluster_arrive_relaxed();

    // The step's operands, then this thread's rows.
    bool active = false, optimal = false;
    V minc = 0;
    if (g == 0) {
        active = *s.active != 0;
        optimal = *s.optimal != 0;
        minc = *s.minc;
    }
    const int h = min(*s.h, R - 1);
    const Ratio<T, V> none{inf<V>(), BIG_INDEX, (T)0, (V)0};
    Ratio<T, V> x = none;
    bool any = false;
    T a0[PER_];
    V b0[PER_];
    ratio_rows<T, V, PER_, SPAN>(Tt, b, ah, M, R, h, (T)eps, g, x, any, a0,
                                 b0);
    block_fold<NW>(x, any, none, warps, wany);
    // Warp 0's lane 0 stores the block's result into block 0's shared
    // memory once every block runs.
    cluster_wait();
    if (tid == 0) {
        *cl.map_shared_rank(&parts[rank], 0) = x;
        *cl.map_shared_rank(&pany[rank], 0) = any;
    }
    cluster_arrive();
    cluster_wait();
    if (rank != 0 || warp != 0) return;
    x = warp_fold(lane < NB ? parts[lane] : none);
    any = __any_sync(FULL, lane < NB && pany[lane] != 0);
    if (lane == 0) store(s, between(x, any, active, optimal, minc));
}

// ---------------------------------------------------------------------------
// seq_ratio_colk: the ratio test, the step between, the pass and the step
// after (with then_pre the next step before), one cluster.
//
// Two elements are read by threads other than their writer: h, which
// every thread reads before the first cluster barrier and block 0's tail
// rewrites after the second, and the step between, which each block's
// thread 0 hands to its block through shared memory.
//
// SHARDED (seq_ratio_colk_sharded, the sequential sharded loop's pivot on
// a rank's slice of R = R_loc columns from global column ``offset``): the
// ratio test reads the column the all_reduce summed into ah (no gather);
// h is global, so base[k] = h as it is; the candidates over the slice's
// live columns are packed into the all_gather send buffers (send_v [v_d,
// v_b] f64, send_i the global h_d and h_b, BIG_INDEX kept) in place of
// the scalars, which the next pivot's seq_fold_column folds across the
// ranks; and the step after runs without the next step before (the
// launcher's policy has then_pre 0), which needs that fold. It launches as
// a programmatic dependent launch behind seq_fold_column (which lets it
// launch as it starts): before griddepcontrol.wait it loads only what no
// kernel since its own launch the pivot before wrote -- the costs of its
// first columns, b of its first rows, and block 0's status, iterations,
// stall, Bland flag and z (seq_fold_column's step before writes active,
// h, minc and optimal, which it loads after the wait, with ah).

template <typename T, typename V, int NB, int NT, int PER_, bool SHARDED>
__global__ void __launch_bounds__(NT) seq_ratio_colk_kernel(
        const T *__restrict__ Tt, V *__restrict__ costs, V *__restrict__ b,
        int *__restrict__ base, T *__restrict__ ah, T *__restrict__ colk,
        T *__restrict__ fac, int M, int R, int r, double eps,
        SeqStep<T, V> s, seq::Policy pol, int offset,
        double *__restrict__ send_v, int *__restrict__ send_i) {
    constexpr int NW = NT / 32, SPAN = NB * NT;
    __shared__ RatioShared<T, V, NB, NW> rsh;
    __shared__ Cands<V> cwarps[NW];
    __shared__ int cwany[NW];
    __shared__ Cands<V> cparts[NB];              // block 0's: the blocks'
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = rank * NT + tid;
    cluster_arrive_relaxed();

    // What waits on nothing: the costs of this thread's first columns, and
    // the steps' operands (each block's thread 0 those of the step
    // between; block 0's those of the step after too); then h. SHARDED:
    // b of the first rows and the step after's operands, then the wait
    // for seq_fold_column, then what it wrote.
    V c0[PER_];
    first_costs<V, PER_, SPAN>(costs, R, g, c0);
    T a0[PER_];
    V b0[PER_];
    seq::PostIn<V> in{};
    V minc = 0;
    if (SHARDED) {
        if (tid == 0 && rank == 0) {
            in.status = *s.status;
            in.iterations = *s.iterations;
            in.stall = *s.stall;
            in.bland = *s.bland != 0;
            in.z = *s.z;
        }
#pragma unroll
        for (int q = 0; q < PER_; ++q)
            if (g + q * SPAN < M) b0[q] = b[g + q * SPAN];
        grid_wait();
        if (tid == 0) {
            in.active = *s.active != 0;
            in.optimal = *s.optimal != 0;
            minc = *s.minc;
        }
    } else if (tid == 0) {
        in.active = *s.active != 0;
        in.optimal = *s.optimal != 0;
        minc = *s.minc;
        if (rank == 0) {
            in.status = *s.status;
            in.iterations = *s.iterations;
            in.stall = *s.stall;
            in.bland = *s.bland != 0;
            in.z = *s.z;
        }
    }
    const int h_raw = *s.h;

    // The ratio test: every block folds every block's result.
    const Between<T, V> w =
            ratio_cluster<T, V, NB, NT, PER_, !SHARDED, SHARDED>(
                    rsh, Tt, b, ah, M, R, min(h_raw, R - 1), eps, in.active,
                    in.optimal, minc, s, a0, b0);

    // The pass: the row's loads, then b and the factors, then the costs
    // and the candidates.
    const Cands<V> cnone{inf<V>(), BIG_INDEX, inf<V>(), BIG_INDEX};
    Cands<V> cx = cnone;
    colk_cols<T, V, PER_, SPAN>(
            Tt, costs, colk, R, r, (V)eps, w, g, c0, cx, [&] {
                if (w.d)
                    update_rows<T, V, PER_, SPAN>(b, fac, ah, M, w, g, true,
                                                  a0, b0);
            });
    bool unused = false;
    block_fold<NW>(cx, unused, cnone, cwarps, cwany);
    if (tid == 0) *cl.map_shared_rank(&cparts[rank], 0) = cx;
    cluster_arrive();
    cluster_wait();
    if (rank != 0 || warp != 0) return;

    // Block 0's warp 0 over the blocks, then the step after in lane 0.
    cx = warp_fold(lane < NB ? cparts[lane] : cnone);
    if (lane != 0) return;
    const seq::Candidates<V> c{cx.idx, cx.val, cx.bidx,
                               cx.bidx == BIG_INDEX ? inf<V>() : cx.bval};
    if (SHARDED) {                               // cx.idx < R: a column wins
        send_v[0] = (double)c.v_d;
        send_v[1] = (double)c.v_b;
        send_i[0] = offset + c.h_d;
        send_i[1] = c.h_b == BIG_INDEX ? BIG_INDEX : offset + c.h_b;
    } else {
        *s.h_d = c.h_d;
        *s.v_d = c.v_d;
        *s.h_b = c.h_b;
        *s.v_b = c.v_b;
    }
    if (w.d) base[w.k] = h_raw;                  // before the step rewrites h
    in.unb = w.unb;
    in.u = w.u;
    in.bk = w.bk;
    seq::post(s, in, w.d, c, pol);
}

// ---------------------------------------------------------------------------
// seq_fold_column: the sequential sharded loop's first kernel a pivot.
// Every warp folds the candidates every rank packed for itself
// (sharded_step.cuh sharded::fold_warp over V (P, 2) f64 and I (P, 2)
// int32, lane q loading rank q's row with the Bland flag), so h, its local
// column and the owner test stay in registers: no shared memory and no
// block barrier stand between the fold and each thread's load of its row,
// the slice's column h - offset where this rank owns the global h, else
// zeros (+0.0, as torch.where writes them) -- the owner's column, which
// the all_reduce after it sums across the ranks. Block 0's thread 0 loads
// status and iterations beside the fold's operands and, once its row's
// load is out, stores the folded candidates and runs the step before the
// ratio test (seq::pre: active, h, minc, optimal). No block reads a field
// the step writes. One thread a row, COL_THREADS a block: with each warp
// folding for itself, 128 threads a block came out ahead of 256 for the
// rank that owns h. It lets the next kernel launch as it starts. Alone at
// one rank, f64, in CUDA graphs: 1.46 us at 1024^2 and 1.61 at 8192^2,
// against 1.69 and 1.71 for the form before (each block's thread 0
// folding into shared memory behind a barrier), on NVIDIA H100 80GB HBM3,
// 700.00 W; the forms tried (one warp folding into shared memory behind a
// barrier, block 0's step before its load, every thread folding the ranks
// in order, 256 threads a block) are tools/seq_variants.cu's (PERF.md).

constexpr int COL_THREADS = 128;

template <typename T, typename V, int NT = COL_THREADS>
__global__ void __launch_bounds__(NT) seq_fold_column_kernel(
        const T *__restrict__ Tt, const double *__restrict__ Vg,
        const int *__restrict__ Ig, int P, int M, int R, int offset,
        T *__restrict__ ah, SeqStep<T, V> s, long long max_iter,
        double eps) {
    grid_launch_next();                          // the ratio test may start
    const bool step = blockIdx.x == 0 && threadIdx.x == 0;
    int status = 0, iterations = 0;
    if (step) {
        status = *s.status;
        iterations = *s.iterations;
    }
    const bool bland = *s.bland != 0;
    const sharded::Fold f = sharded::fold_warp(Vg, Ig, P, 2);
    const seq::Candidates<V> c{f.h_d, (V)f.v_d, f.h_b, (V)f.v_b};
    const int h = bland && c.h_b < BIG_INDEX ? c.h_b : c.h_d;
    const long long loc = (long long)h - offset;
    const int j = blockIdx.x * NT + threadIdx.x;
    const T a = loc >= 0 && loc < R && j < M ? Tt[(size_t)j * R + loc]
                                             : (T)0;
    if (step) {
        *s.h_d = c.h_d;
        *s.v_d = c.v_d;
        *s.h_b = c.h_b;
        *s.v_b = c.v_b;
        seq::pre(s, status, iterations, bland, c, max_iter, eps);
    }
    if (j < M) ah[j] = a;
}

// ---------------------------------------------------------------------------
// seq_ratio_snapshot: the K6 loop's ratio test, the step between and the
// snapshot K6 reads, one cluster (pure f32): every block folds the ratio
// test and runs the step between (ratio_cluster), then issues its loads of
// row k, updates b for its rows where the pivot is done (the first PER
// rows' a_h and b from registers) and stores the row into colk; block 0's
// thread 0 writes base[k] = h where done. No thread reads what another
// writes after the barrier: each updates the rows it gathered. The row
// goes RPER 16-byte vectors a thread at a time.

template <int NB, int NT, int PER_, int RPER>
__global__ void __launch_bounds__(NT) seq_ratio_snapshot_kernel(
        const float *__restrict__ Tt, float *__restrict__ b,
        int *__restrict__ base, float *__restrict__ ah,
        float *__restrict__ colk, int M, int R, double eps,
        SeqStep<float, float> s) {
    constexpr int SPAN = NB * NT;
    __shared__ RatioShared<float, float, NB, NT / 32> rsh;
    const int g = (int)cg::this_cluster().block_rank() * NT + threadIdx.x;
    cluster_arrive_relaxed();

    // The step between's operands (each block's thread 0), then h.
    bool active = false, optimal = false;
    float minc = 0;
    if (threadIdx.x == 0) {
        active = *s.active != 0;
        optimal = *s.optimal != 0;
        minc = *s.minc;
    }
    const int h_raw = *s.h;
    float a0[PER_], b0[PER_];
    const Between<float, float> w = ratio_cluster<float, float, NB, NT, PER_>(
            rsh, Tt, b, ah, M, R, min(h_raw, R - 1), eps, active, optimal,
            minc, s, a0, b0);

    // Row k's first loads, then b, then the row's stores.
    copy_row<RPER, SPAN>(Tt + (size_t)w.k * R, colk, R / 4, g, [&] {
        if (w.d)
            update_rows<float, float, PER_, SPAN, false>(
                    b, nullptr, ah, M, w, g, true, a0, b0);
    });
    if (w.d && g == 0) base[w.k] = h_raw;
}

// ---------------------------------------------------------------------------
// Launchers.

template <typename T, typename V>
int step_pre_run(const void *step, long long max_iter, double eps,
                 cudaStream_t st) {
    seq_step_pre_kernel<T, V><<<1, 1, 0, st>>>(step_of<T, V>(step), max_iter,
                                               eps);
    return (int)cudaGetLastError();
}

template <typename T, typename V>
int ratio_run(const void *Tt, const void *b, int M, int R, double eps,
              void *ah, const void *step, cudaStream_t st) {
    if (M < 1 || R < 1) return (int)cudaErrorInvalidValue;
    auto kernel = seq_ratio_kernel<T, V, CLUSTER_BLOCKS, CLUSTER_THREADS, PER>;
    static const cudaError_t e = allow_cluster(kernel, CLUSTER_BLOCKS);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, CLUSTER_BLOCKS, CLUSTER_THREADS, false, st,
                          static_cast<const T *>(Tt),
                          static_cast<const V *>(b), M, R, eps,
                          static_cast<T *>(ah), step_of<T, V>(step));
}

// SHARDED: the sharded form, packing into send_v and send_i at the
// slice's offset, a programmatic dependent launch; pol.then_pre must be 0
// there. NT threads a block (CLUSTER_THREADS, or the sharded form's
// SHARDED_THREADS_WIDE for wide slices).
template <typename T, typename V, bool SHARDED = false,
          int NT = CLUSTER_THREADS>
int ratio_colk_run(const void *Tt, void *costs, void *b, int *base, void *ah,
                   void *colk, void *fac, int M, int R, int r, double eps,
                   const void *step, const seq::Policy &pol,
                   cudaStream_t st, int offset = 0, double *send_v = nullptr,
                   int *send_i = nullptr) {
    if (M < 1 || R < 1 || (SHARDED && (pol.then_pre || send_v == nullptr
                                       || send_i == nullptr)))
        return (int)cudaErrorInvalidValue;
    auto kernel = seq_ratio_colk_kernel<T, V, CLUSTER_BLOCKS, NT, PER,
                                        SHARDED>;
    static const cudaError_t e = allow_cluster(kernel, CLUSTER_BLOCKS);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, CLUSTER_BLOCKS, NT, SHARDED, st,
                          static_cast<const T *>(Tt), static_cast<V *>(costs),
                          static_cast<V *>(b), base, static_cast<T *>(ah),
                          static_cast<T *>(colk), static_cast<T *>(fac), M, R,
                          r, eps, step_of<T, V>(step), pol, offset, send_v,
                          send_i);
}

// The sharded form on ``threads`` threads a block (kernels/seq.py
// seq_sharded_threads chooses them by the slice's columns); others are
// refused.
template <typename T, typename V>
int ratio_colk_sharded_run(const void *Tt, void *costs, void *b, int *base,
                           void *ah, void *colk, void *fac, int M, int R,
                           int r, double eps, const void *step,
                           const seq::Policy &pol, int offset,
                           double *send_v, int *send_i, int threads,
                           cudaStream_t st) {
    if (threads == CLUSTER_THREADS)
        return ratio_colk_run<T, V, true, CLUSTER_THREADS>(
                Tt, costs, b, base, ah, colk, fac, M, R, r, eps, step, pol,
                st, offset, send_v, send_i);
    if (threads == SHARDED_THREADS_WIDE)
        return ratio_colk_run<T, V, true, SHARDED_THREADS_WIDE>(
                Tt, costs, b, base, ah, colk, fac, M, R, r, eps, step, pol,
                st, offset, send_v, send_i);
    return (int)cudaErrorInvalidValue;
}

template <typename T, typename V, int NT = COL_THREADS>
int fold_column_run(const void *Tt, const double *V_, const int *I, int P,
                    int M, int R, int offset, void *ah, const void *step,
                    long long max_iter, double eps, cudaStream_t st) {
    if (M < 1 || R < 1 || P < 1) return (int)cudaErrorInvalidValue;
    seq_fold_column_kernel<T, V, NT><<<(M + NT - 1) / NT, NT, 0, st>>>(
            static_cast<const T *>(Tt), V_, I, P, M, R, offset,
            static_cast<T *>(ah), step_of<T, V>(step), max_iter, eps);
    return (int)cudaGetLastError();
}

// Row k goes 16 bytes a load: R a multiple of 4, Tt and colk 16-byte
// aligned, else refused.
int ratio_snapshot_run(const float *Tt, float *b, int *base, float *ah,
                       float *colk, int M, int R, double eps,
                       const void *step, cudaStream_t st) {
    if (M < 1 || R < 1 || R % 4 || reinterpret_cast<uintptr_t>(Tt) % 16
        || reinterpret_cast<uintptr_t>(colk) % 16)
        return (int)cudaErrorInvalidValue;
    auto kernel = seq_ratio_snapshot_kernel<CLUSTER_BLOCKS, CLUSTER_THREADS,
                                            PER, PER>;
    static const cudaError_t e = allow_cluster(kernel, CLUSTER_BLOCKS);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, CLUSTER_BLOCKS, CLUSTER_THREADS, false, st,
                          Tt, b, base, ah, colk, M, R, eps,
                          step_of<float, float>(step));
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes). ``step`` is the host's array of the scalars'
// pointers, ``pair`` the dtype pair (PAIR_*); an unknown pair or an empty
// shape is refused with cudaErrorInvalidValue, as is a cluster the card
// cannot launch with its own error. Each returns cudaGetLastError() as an
// int.

extern "C" {

int seq_step_pre_launch(const void *step, long long max_iter, double eps,
                        int pair, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64: return step_pre_run<double, double>(step, max_iter, eps, st);
    case PAIR_MIXED: return step_pre_run<float, double>(step, max_iter, eps, st);
    case PAIR_F32: return step_pre_run<float, float>(step, max_iter, eps, st);
    }
    return (int)cudaErrorInvalidValue;
}

// Tt (M, R) and ah (M,) of the tableau's dtype, b (M,) of the vectors'.
int seq_ratio_launch(const void *Tt, const void *b, int M, int R, double eps,
                     void *ah, const void *step, int pair, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return ratio_run<double, double>(Tt, b, M, R, eps, ah, step, st);
    case PAIR_MIXED:
        return ratio_run<float, double>(Tt, b, M, R, eps, ah, step, st);
    case PAIR_F32:
        return ratio_run<float, float>(Tt, b, M, R, eps, ah, step, st);
    }
    return (int)cudaErrorInvalidValue;
}

// The default loop's pivot but its rank-1 update, under max_iter, eps, the
// Bland mode, threshold and then_pre.
int seq_ratio_colk_launch(const void *Tt, void *costs, void *b, int *base,
                          void *ah, void *colk, void *fac, int M, int R,
                          int r, double eps, const void *step,
                          long long max_iter, int bland_mode, int threshold,
                          int then_pre, int pair, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const seq::Policy pol{max_iter, eps, bland_mode, threshold, then_pre};
    switch (pair) {
    case PAIR_F64:
        return ratio_colk_run<double, double>(Tt, costs, b, base, ah, colk,
                                              fac, M, R, r, eps, step, pol,
                                              st);
    case PAIR_MIXED:
        return ratio_colk_run<float, double>(Tt, costs, b, base, ah, colk,
                                             fac, M, R, r, eps, step, pol,
                                             st);
    case PAIR_F32:
        return ratio_colk_run<float, float>(Tt, costs, b, base, ah, colk, fac,
                                            M, R, r, eps, step, pol, st);
    }
    return (int)cudaErrorInvalidValue;
}

// The sequential sharded loop's column: Tt the slice (M, R) from global
// column offset, V (P, 2) f64 and I (P, 2) int32 the gathered candidates,
// ah (M,) of the tableau's dtype.
int seq_fold_column_launch(const void *Tt, const double *V, const int *I,
                           int P, int M, int R, int offset, void *ah,
                           const void *step, long long max_iter, double eps,
                           int pair, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return fold_column_run<double, double>(Tt, V, I, P, M, R, offset, ah,
                                               step, max_iter, eps, st);
    case PAIR_MIXED:
        return fold_column_run<float, double>(Tt, V, I, P, M, R, offset, ah,
                                              step, max_iter, eps, st);
    case PAIR_F32:
        return fold_column_run<float, float>(Tt, V, I, P, M, R, offset, ah,
                                             step, max_iter, eps, st);
    }
    return (int)cudaErrorInvalidValue;
}

// The sequential sharded loop's pivot but its rank-1 update, on the slice
// (M, R) from global column offset: ah the summed column, r the slice's
// live columns, send_v (2,) f64 and send_i (2,) int32 the send buffers,
// ``threads`` the cluster's threads a block (256 or 512).
int seq_ratio_colk_sharded_launch(const void *Tt, void *costs, void *b,
                                  int *base, void *ah, void *colk, void *fac,
                                  int M, int R, int r, double eps,
                                  const void *step, long long max_iter,
                                  int bland_mode, int threshold, int offset,
                                  double *send_v, int *send_i, int threads,
                                  int pair, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const seq::Policy pol{max_iter, eps, bland_mode, threshold, 0};
    switch (pair) {
    case PAIR_F64:
        return ratio_colk_sharded_run<double, double>(
                Tt, costs, b, base, ah, colk, fac, M, R, r, eps, step, pol,
                offset, send_v, send_i, threads, st);
    case PAIR_MIXED:
        return ratio_colk_sharded_run<float, double>(
                Tt, costs, b, base, ah, colk, fac, M, R, r, eps, step, pol,
                offset, send_v, send_i, threads, st);
    case PAIR_F32:
        return ratio_colk_sharded_run<float, float>(
                Tt, costs, b, base, ah, colk, fac, M, R, r, eps, step, pol,
                offset, send_v, send_i, threads, st);
    }
    return (int)cudaErrorInvalidValue;
}

// The K6 loop's ratio test and snapshot: pure f32 only.
int seq_ratio_snapshot_launch(const void *Tt, void *b, int *base, void *ah,
                              void *colk, int M, int R, double eps,
                              const void *step, int pair, void *stream) {
    if (pair != PAIR_F32) return (int)cudaErrorInvalidValue;
    return ratio_snapshot_run(static_cast<const float *>(Tt),
                              static_cast<float *>(b), base,
                              static_cast<float *>(ah),
                              static_cast<float *>(colk), M, R, eps, step,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
