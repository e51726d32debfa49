// The sequential loop's ratio test and pivot-row pass (csrc/seq.cu) on the
// card, several ways, every output checked bit for bit against the forms
// they replaced:
//
//   ticket    verbatim copies of the two kernels the port launched before:
//             seq_ratio (one row a thread over a grid, a partial a block
//             in a workspace, an acq_rel arrival ticket, the last block
//             folding the partials and running the step between) and
//             seq_colk (one column a thread over R blocks, then M blocks
//             for b; the same ticket; the last R block's step after);
//   abNBxNTpP the two as clusters of NB blocks of NT threads, each thread
//             walking P rows or columns at a time: the shipped seq_ratio
//             (included from the source) and this file's seq_colk
//             cluster, which loads the costs before k and folds the
//             candidates into block 0's shared memory;
//   cNBxNTpP  the shipped seq_ratio_colk (included from the source): both
//             in one cluster, the rows' a_h and b kept in registers for
//             the factors and b, the costs loaded before the first
//             cluster barrier: one launch a pivot.
//
// First (``/tmp/seq_variants heads`` runs this part alone): the ranks'
// candidate fold of seq_fold_column and of K5's sharded head as shipped,
// every warp folding by shuffles, against the forms before (seq_prior,
// k5_prior: each block's thread 0 folding behind a barrier), one warp
// folding into shared memory behind a barrier, every warp folding with
// block 0's step before its loads, every thread folding the ranks in
// order (sharded::fold), and the column at 128 and 256 threads a block:
// byte for byte from every gathered edge state at P = 1, 3, 8 and 33 (the
// three pairs for the column, kv 2 and 5 and t = 0, 37 and 127 for K5),
// then timed in turns (the column alone and before the shipped pass at f64
// 1,024 x 3,072 and 8,192 x 24,576; K5 at f32 8,192 x 24,576, beside K5
// without a head).
//
// With ``sharded`` (``/tmp/seq_variants sharded`` runs this part after
// the first and stops; both run first otherwise): the sequential sharded
// loop's seq_fold_column and seq_ratio_colk_sharded as shipped (the column
// lets the pass launch as it starts; the pass a programmatic dependent
// launch of 16 x 256 or 16 x 512 threads) against the forms before
// (seq_prior, verbatim), byte for byte after one column and pass from each
// edge state below, at one rank and as rank 0 of 3, 8 and 33 (its
// candidate winning, or rank P - 1's: zeros), at 8,192 x 24,576, 1,024 x
// 3,072, 7 x 21, 4,097 x 257, 4,095 x 20,480 and 40,064 x 2,048, the three
// pairs; then timed in turns in f64 from 1,024 x 3,072 to 8,192 x 24,576,
// the pass alone and after the column, warm and (from 4,096 x 12,288 on)
// cold, with the unsharded seq_ratio_colk against its form before at the
// first and the
// last. Built alone (-DSEQ_VARIANTS_LIB -shared) this file is a library
// of seq_prior's two kernels and k5_prior's K5 with its head, with C entry
// points, which chip_smoke.py and the card tests hold and time the shipped
// ones against.
//
// Build and run on a machine with an H100:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/seq_variants tools/seq_variants.cu && /tmp/seq_variants
//
// Checks, in f64/f64, f32/f64 and f32/f32: every scalar of the step, a_h,
// the row, the costs, b, the factors and base equal to ticket's, byte for
// byte, after one pivot from edge states -- a taken pivot, a NaN in b on
// an eligible row, equal smallest quotients on two rows far apart, no
// eligible row, no eligible column (a skipped pivot over non-negative
// costs), equal most negative costs on two columns far apart, a NaN cost,
// Bland static, Bland by its threshold, a skipped pivot (optimal) -- at M
// x R = 8,192 x 24,576, 1,024 x 3,072, 2,048 x 6,144, 1 x 3, 7 x 21,
// 4,095 x 12,285, 4,097 x 257, 40,064 x 2,048 and 2,048 x 120,064 (the
// last in f32 only, 10,112 x 120,064 too). Times, at the first four shapes
// above (f64; 2,048 x 6,144 in f32/f32 and f32/f64): us a pivot (the ratio
// test and the pass) by CUDA events around 20 replays of a CUDA graph of
// 50 pivots, in turns (each form, then back), three rounds; then each
// kernel of the two-launch forms alone the same way; then, at 8,192 x
// 24,576 and 2,048 x 6,144 f32, each pivot cold: after a 256 MiB write
// that evicts L2, less the write alone (the 1,024^2 tableau stays in L2
// in the loop). The timed state is a degenerate pivot (b[k] = 0), so b
// stays put and every call does the same work.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <random>
#include <string>
#include <vector>

#include "../simplex_tpu_torch/kernels/csrc/seq.cu"

// The ticket forms' blocks: one row, or one column, a thread.
constexpr int THREADS = 256;

#define CK(x)                                                            \
    do {                                                                 \
        cudaError_t e_ = (cudaError_t)(x);                               \
        if (e_ != cudaSuccess) {                                         \
            std::printf("CUDA error %s at %s:%d\n", cudaGetErrorString(e_), \
                        __FILE__, __LINE__);                             \
            std::exit(1);                                                \
        }                                                                \
    } while (0)

// ---------------------------------------------------------------------------
// The sequential sharded loop's seq_fold_column and seq_ratio_colk_sharded
// as the port launched them before their redesigns, verbatim (their
// helpers -- ratio_cluster.cuh, the pass's and sharded_step.cuh's fold --
// are the shipped files', unchanged): seq_ratio_colk's cluster of 16 x 256
// threads launched without programmatic dependent launch (the form before
// the pass launched behind the column), and the fold grid with the early
// trigger, each block's thread 0 folding into shared memory behind a
// barrier (the form before the warp fold). Built alone (-DSEQ_VARIANTS_LIB
// -shared) with C entry points, which chip_smoke.py and the card tests
// hold and time the shipped kernels against.

namespace seq_prior {

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
    // between; block 0's those of the step after too); then h.
    V c0[PER_];
    first_costs<V, PER_, SPAN>(costs, R, g, c0);
    seq::PostIn<V> in{};
    V minc = 0;
    if (tid == 0) {
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
    T a0[PER_];
    V b0[PER_];
    const Between<T, V> w = ratio_cluster<T, V, NB, NT, PER_, !SHARDED>(
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

constexpr int COL_THREADS = 256;

template <typename T, typename V>
__global__ void __launch_bounds__(COL_THREADS) seq_fold_column_kernel(
        const T *__restrict__ Tt, const double *__restrict__ Vg,
        const int *__restrict__ Ig, int P, int M, int R, int offset,
        T *__restrict__ ah, SeqStep<T, V> s, long long max_iter,
        double eps) {
    __shared__ int col;                          // h's local column, or -1
    grid_launch_next();                          // the ratio test may start
    if (threadIdx.x == 0) {
        const int status = *s.status, iterations = *s.iterations;
        const bool bland = *s.bland != 0;
        const sharded::Fold f = sharded::fold(Vg, Ig, P, 2);
        const seq::Candidates<V> c{f.h_d, (V)f.v_d, f.h_b, (V)f.v_b};
        const int h = bland && c.h_b < BIG_INDEX ? c.h_b : c.h_d;
        const long long loc = (long long)h - offset;
        col = loc >= 0 && loc < R ? (int)loc : -1;
        if (blockIdx.x == 0) {
            *s.h_d = c.h_d;
            *s.v_d = c.v_d;
            *s.h_b = c.h_b;
            *s.v_b = c.v_b;
            seq::pre(s, status, iterations, bland, c, max_iter, eps);
        }
    }
    __syncthreads();
    const int hl = col;
    const int j = blockIdx.x * COL_THREADS + threadIdx.x;
    if (j < M) ah[j] = hl >= 0 ? Tt[(size_t)j * R + hl] : (T)0;
}

// SHARDED: the sharded form, packing into send_v and send_i at the
// slice's offset; pol.then_pre must be 0 there.
template <typename T, typename V, bool SHARDED = false>
int ratio_colk_run(const void *Tt, void *costs, void *b, int *base, void *ah,
                   void *colk, void *fac, int M, int R, int r, double eps,
                   const void *step, const seq::Policy &pol,
                   cudaStream_t st, int offset = 0, double *send_v = nullptr,
                   int *send_i = nullptr) {
    if (M < 1 || R < 1 || (SHARDED && (pol.then_pre || send_v == nullptr
                                       || send_i == nullptr)))
        return (int)cudaErrorInvalidValue;
    auto kernel = seq_ratio_colk_kernel<T, V, CLUSTER_BLOCKS,
                                        CLUSTER_THREADS, PER, SHARDED>;
    static const cudaError_t e = allow_cluster(kernel, CLUSTER_BLOCKS);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, CLUSTER_BLOCKS, CLUSTER_THREADS, false, st,
                          static_cast<const T *>(Tt), static_cast<V *>(costs),
                          static_cast<V *>(b), base, static_cast<T *>(ah),
                          static_cast<T *>(colk), static_cast<T *>(fac), M, R,
                          r, eps, step_of<T, V>(step), pol, offset, send_v,
                          send_i);
}

template <typename T, typename V>
int fold_column_run(const void *Tt, const double *V_, const int *I, int P,
                    int M, int R, int offset, void *ah, const void *step,
                    long long max_iter, double eps, cudaStream_t st) {
    if (M < 1 || R < 1 || P < 1) return (int)cudaErrorInvalidValue;
    seq_fold_column_kernel<T, V>
            <<<(M + COL_THREADS - 1) / COL_THREADS, COL_THREADS, 0, st>>>(
                    static_cast<const T *>(Tt), V_, I, P, M, R, offset,
                    static_cast<T *>(ah), step_of<T, V>(step), max_iter, eps);
    return (int)cudaGetLastError();
}

}  // namespace seq_prior

// ---------------------------------------------------------------------------
// K5 with the sharded kernel loop's head (csrc/blocked.cu ah_head_launch)
// as the port launched it before the warp fold, verbatim: K1/K5's template
// ah_ratio_fused and its helpers, launched as ah_ratio_fused<false,
// THREADS, false, true> -- each block's thread 0 folding the gathered
// candidates (sharded_step.cuh sharded::fold) and running the step before,
// then the column's h and owner flag through shared memory behind a
// barrier. Built alone (-DSEQ_VARIANTS_LIB -shared) with a C entry point,
// prior_ah_head_launch, which chip_smoke.py and the card tests hold and
// time the shipped head against.

namespace k5_prior {

constexpr int BIG_INDEX = 2147483647;
constexpr int THREADS = 256;

__device__ __forceinline__ bool better(double ka, int ia, double kb, int ib) {
    return ka > kb || (ka == kb && ia < ib);
}

// Block-wide argmax of (key, idx) carrying val, over warp shuffles; ties go
// to the lowest index. The order is total for non-NaN keys, so the result
// does not depend on the tree's shape. The whole block must call it; thread
// 0 gets the result.
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

// The ratio is a native f64 quotient (the TPU formed it from double-f32
// pairs); the TPU carried the fold across its sequential grid in SMEM
// scratch.

constexpr int AHR_COLS = 64;    // constraints per block
constexpr int AHR_ROWS = 128;   // live F rows staged per pass of the chain

// The workspace (bytes; csrc and kernels/blocked.py ah_ratio_workspace_bytes
// agree): [0, 4) the arrival counter, [4, 8) unused, then f64 key[nb],
// a[nb], b[nb] and int idx[nb] for nb blocks.
__host__ __device__ constexpr size_t ahr_ws_bytes(int nb) {
    return 8 + (size_t)nb * (3 * sizeof(double) + sizeof(int));
}

struct AhrWs {
    unsigned *counter;
    double *key, *a, *b;
    int *idx;
    __device__ AhrWs(unsigned char *ws, int nb)
        : counter(reinterpret_cast<unsigned *>(ws)),
          key(reinterpret_cast<double *>(ws + 8)), a(key + nb), b(a + nb),
          idx(reinterpret_cast<int *>(b + nb)) {}
};

// The arrival ticket: one atomic add, acquire and release at the device's
// scope. Its release orders the calling thread's partial before the add; in
// the block that draws the last ticket its acquire orders every block's
// partial before the fold, and the block's barrier hands that on to the
// folding threads, which read past L1. (One atomic in place of
// __threadfence + atomicAdd and a second fence: 0.6 us less a call,
// tools/k1k3_variants.cu.)
__device__ __forceinline__ unsigned ticket(unsigned *counter) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    return old;
}

// One pass's F slab into shared memory: F[s0 + s, j0 .. j0 + AHR_COLS) as
// 16-byte cp.async copies (not committed here), s < min(AHR_ROWS, t - s0).
// The whole block (NTH threads) calls it.
template <int NTH>
__device__ __forceinline__ void ahr_stage(const float *__restrict__ F,
                                          int s0, int t, int M, int j0,
                                          float (*fs)[AHR_COLS]) {
    constexpr int CHUNKS = AHR_COLS / 4;         // 16-byte copies per row
    const int rows = min(AHR_ROWS, t - s0);
    for (int c = threadIdx.x; c < rows * CHUNKS; c += NTH) {
        const int s = c / CHUNKS, q = (c % CHUNKS) * 4;
        cp_async16(&fs[s][q], F + (size_t)(s0 + s) * M + j0 + q);
    }
}
// The sharded loop's head of K5 (HEAD): the scalars, the gathered
// candidates V (P, kv) and I (P, 2) of the pivot before, and the step
// before K5's policy.
struct K5Head {
    ShardStep s;
    const double *V;
    const int *I;
    int P, kv;
    sharded::PrePolicy pol;
};

// RATIO false is K5: the column alone -- no b load, no fold, no ticket, no
// workspace (b, ws and the outputs after ah may be null), NTH threads a
// block; at t = 0 it writes Tt[j, h] - 0.0f without staging anything.
// K5's owner flag ``own`` (null: owned) is the sharded loop's: a rank that
// does not own h writes zeros, its share of the column's cross-rank sum.
// TAIL (RATIO only) runs the loop's step between K1 and K2 (step.cuh
// step::mid) on ``s`` after the fold; without it ``s`` is unread.
// HEAD (K5 only) is the sharded loop's head on ``hd`` (see K5 below): the
// column's h and owner flag come from it, not from h_ptr and own; without
// it ``hd`` is unread.
template <bool RATIO, int NTH = THREADS, bool TAIL = false,
          bool HEAD = false>
__global__ void __launch_bounds__(NTH) ah_ratio_fused(
        const float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, const double *__restrict__ b,
        const int *__restrict__ h_ptr, const unsigned char *__restrict__ own,
        int t, int M, int R, float eps, int nb, float *__restrict__ ah,
        unsigned char *__restrict__ ws_bytes, int *__restrict__ k_out,
        float *__restrict__ p_out, double *__restrict__ bk_out,
        int *__restrict__ unb_out, Step s, K5Head hd) {
    static_assert(!RATIO || NTH == THREADS, "K1 folds over THREADS");
    static_assert(RATIO || !TAIL, "the step's tail follows the ratio test");
    static_assert(!RATIO || !HEAD, "the head is K5's");
    __shared__ __align__(16) float fs[AHR_ROWS][AHR_COLS];
    __shared__ float ch[AHR_ROWS];               // C[s0 + s, h]
    __shared__ double sa[THREADS], sb[THREADS];  // each thread's a_h, b
    __shared__ bool last;
    __shared__ int head_h;                       // the head's hl and own
    __shared__ bool head_own;
    const AhrWs ws(ws_bytes, nb);
    const int tid = threadIdx.x;
    const int j0 = blockIdx.x * AHR_COLS;
    const int j = j0 + tid;                      // this thread's constraint
    const bool owner = tid < AHR_COLS;           // M is a multiple of 128

    // The first pass's loads, all issued before any is waited for: the F
    // slab, then what h selects.
    ahr_stage<NTH>(F, 0, t, M, j0, fs);
    cp_async_commit();
    if constexpr (HEAD) {
        // The fold and the step before K5 in each block's thread 0, every
        // operand loaded at once while the F slab is on its way; block 0
        // stores the scalars. No block of K5 reads a field the head writes
        // (the column takes hl and own from shared memory), so the blocks
        // need no ticket.
        if (tid == 0) {
            const int status = *hd.s.status, iters = *hd.s.iterations;
            const bool bland = *hd.s.bland != 0;
            const sharded::Fold f = sharded::fold(hd.V, hd.I, hd.P, hd.kv);
            const sharded::Pre x = sharded::pre(
                status, iters, bland, f, hd.pol.max_iter, hd.pol.eps,
                hd.pol.offset, hd.pol.R_loc);
            if (blockIdx.x == 0) {
                sharded::store(hd.s, f);
                sharded::store(hd.s, x);
            }
            head_h = x.hl;
            head_own = x.own;
        }
        __syncthreads();
    }
    const int h = HEAD ? head_h : min(*h_ptr, R - 1);
    for (int s = tid; s < min(AHR_ROWS, t); s += NTH)
        ch[s] = C[(size_t)s * R + h];
    float th = 0.0f;
    double bj = 0.0;
    if (owner) {
        th = Tt[(size_t)j * R + h];
        if (RATIO) bj = b[j];
    }
    if (!RATIO && (HEAD ? !head_own : (own != nullptr && *own == 0))) {
        // another rank's column
        cp_async_wait<0>();
        if (owner) ah[j] = 0.0f;
        return;
    }
    if (!RATIO && t == 0) {                      // no live eta row
        if (owner) ah[j] = __fsub_rn(th, 0.0f);
        return;
    }

    // a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] F[s, j], the FFMA chain in s
    // order across the passes.
    float acc = 0.0f;
    for (int s0 = 0;;) {
        cp_async_wait<0>();
        __syncthreads();
        const int rows = min(AHR_ROWS, t - s0);
        if (owner) {
#pragma unroll 8
            for (int s = 0; s < rows; ++s)
                acc = fmaf(ch[s], fs[s][tid], acc);
        }
        s0 += AHR_ROWS;
        if (s0 >= t) break;
        __syncthreads();                         // the pass is read
        ahr_stage<NTH>(F, s0, t, M, j0, fs);
        cp_async_commit();
        for (int s = tid; s < min(AHR_ROWS, t - s0); s += NTH)
            ch[s] = C[(size_t)(s0 + s) * R + h];
    }

    if constexpr (!RATIO) {
        if (owner) ah[j] = __fsub_rn(th, acc);
        return;
    }

    // The block's fold carries the winner's thread: its a_h and b[j] wait
    // in shared memory, so the partial gets a_h[k] and b[k] with no load.
    double key = -CUDART_INF;                    // key = -(b / a_h)
    int idx = BIG_INDEX;
    if (owner) {
        const float a = __fsub_rn(th, acc);
        ah[j] = a;
        if (a >= eps) {
            key = -__ddiv_rn(bj, (double)a);
            idx = j;
        }
        sa[tid] = (double)a;
        sb[tid] = bj;
    }
    double who = tid;
    block_argmax_warps(key, idx, who);
    if (tid == 0) {
        const bool none = idx == BIG_INDEX;
        ws.key[blockIdx.x] = key;
        ws.idx[blockIdx.x] = idx;
        ws.a[blockIdx.x] = none ? 0.0 : sa[(int)who];
        ws.b[blockIdx.x] = none ? 0.0 : sb[(int)who];
        last = ticket(ws.counter) == (unsigned)nb - 1;
    }
    __syncthreads();
    if (!last) return;

    // The tail's other operands, loaded while the partials fold: the step
    // before K1 wrote them and no block of K1 writes them.
    step::MidIn mid{};
    if (TAIL && tid == 0) mid = step::mid_load(s);

    // The last block: every block has written its partial. Fold the
    // partials (read past L1) in the same order, carrying the winner's
    // thread again.
    key = -CUDART_INF;
    idx = BIG_INDEX;
    double pa = 0.0, pb = 0.0;
    for (int i = tid; i < nb; i += THREADS) {
        const double ki = __ldcg(ws.key + i);
        const int ii = __ldcg(ws.idx + i);
        const double ai = __ldcg(ws.a + i), bi = __ldcg(ws.b + i);
        if (better(ki, ii, key, idx)) {
            key = ki;
            idx = ii;
            pa = ai;
            pb = bi;
        }
    }
    sa[tid] = pa;                                // thread 0 read sa above
    sb[tid] = pb;
    who = tid;
    block_argmax_warps(key, idx, who);
    if (tid == 0) {
        const bool none = idx == BIG_INDEX;      // no eligible constraint
        const float p = none ? 0.0f : (float)sa[(int)who];  // a_h[k], exactly
        *k_out = idx;
        *p_out = p;
        *bk_out = none ? 0.0 : sb[(int)who];
        *unb_out = none ? 1 : 0;
        *ws.counter = 0;                         // ready for the next call
        // The step between K1 and K2, on K1's p and flag in registers: K2,
        // the next node, reads do, p and u.
        if (TAIL) step::mid(s, mid, p, none);
    }
}


int ah_head_run(const float *Tt, const float *F, const float *C, int t,
                int M, int R, float *ah, const ShardStep *s, const double *V,
                const int *I, int P, int kv, long long max_iter, double eps,
                int offset, cudaStream_t st) {
    const int nb = (M + AHR_COLS - 1) / AHR_COLS;
    const K5Head hd{*s, V, I, P, kv, {max_iter, eps, offset, R}};
    ah_ratio_fused<false, THREADS, false, true><<<nb, THREADS, 0, st>>>(
        Tt, F, C, nullptr, nullptr, nullptr, t, M, R, 0.0f, nb, ah, nullptr,
        nullptr, nullptr, nullptr, nullptr, Step{}, hd);
    return (int)cudaGetLastError();
}

}  // namespace k5_prior

#ifdef SEQ_VARIANTS_LIB

extern "C" {

// seq_fold_column_launch's operands (the form before).
int prior_seq_fold_column_launch(const void *Tt, const double *V,
                                 const int *I, int P, int M, int R,
                                 int offset, void *ah, const void *step,
                                 long long max_iter, double eps, int pair,
                                 void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return seq_prior::fold_column_run<double, double>(
                Tt, V, I, P, M, R, offset, ah, step, max_iter, eps, st);
    case PAIR_MIXED:
        return seq_prior::fold_column_run<float, double>(
                Tt, V, I, P, M, R, offset, ah, step, max_iter, eps, st);
    case PAIR_F32:
        return seq_prior::fold_column_run<float, float>(
                Tt, V, I, P, M, R, offset, ah, step, max_iter, eps, st);
    }
    return (int)cudaErrorInvalidValue;
}

// seq_ratio_colk_sharded_launch's operands but the threads (the form
// before: 256 a block, no programmatic dependent launch).
int prior_seq_ratio_colk_sharded_launch(const void *Tt, void *costs, void *b,
                                        int *base, void *ah, void *colk,
                                        void *fac, int M, int R, int r,
                                        double eps, const void *step,
                                        long long max_iter, int bland_mode,
                                        int threshold, int offset,
                                        double *send_v, int *send_i,
                                        int pair, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const seq::Policy pol{max_iter, eps, bland_mode, threshold, 0};
    switch (pair) {
    case PAIR_F64:
        return seq_prior::ratio_colk_run<double, double, true>(
                Tt, costs, b, base, ah, colk, fac, M, R, r, eps, step, pol,
                st, offset, send_v, send_i);
    case PAIR_MIXED:
        return seq_prior::ratio_colk_run<float, double, true>(
                Tt, costs, b, base, ah, colk, fac, M, R, r, eps, step, pol,
                st, offset, send_v, send_i);
    case PAIR_F32:
        return seq_prior::ratio_colk_run<float, float, true>(
                Tt, costs, b, base, ah, colk, fac, M, R, r, eps, step, pol,
                st, offset, send_v, send_i);
    }
    return (int)cudaErrorInvalidValue;
}

// ah_head_launch's operands (the form before).
int prior_ah_head_launch(const float *Tt, const float *F, const float *C,
                         int t, int M, int R, float *ah, const ShardStep *s,
                         const double *V, const int *I, int P, int kv,
                         long long max_iter, double eps, int offset,
                         void *stream) {
    return k5_prior::ah_head_run(Tt, F, C, t, M, R, ah, s, V, I, P, kv,
                                 max_iter, eps, offset,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"

#else  // the program

// ---------------------------------------------------------------------------
// The kernels the port launched before, verbatim.

namespace ticket_form {

constexpr int NW = THREADS / 32;

__device__ __forceinline__ unsigned ticket(unsigned *counter) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    return old;
}

template <typename T, typename V>
__device__ void block_ratio(Ratio<T, V> &x, bool &any,
                            const Ratio<T, V> &none) {
    __shared__ Ratio<T, V> warps[NW];
    __shared__ int wany[NW];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    any = __any_sync(FULL, any);
    for (int off = 16; off > 0; off >>= 1) take_first(x, shfl_xor(x, off));
    if (lane == 0) {
        warps[warp] = x;
        wany[warp] = any;
    }
    __syncthreads();
    if (warp == 0) {
        x = lane < NW ? warps[lane] : none;
        any = __any_sync(FULL, lane < NW && wany[lane] != 0);
        for (int off = NW / 2; off > 0; off >>= 1)
            take_first(x, shfl_xor(x, off));
    }
    __syncthreads();                             // warps[] free again
}

__host__ __device__ constexpr size_t ratio_ws_bytes(int nb) {
    return 8 + (size_t)nb * (3 * sizeof(double) + 2 * sizeof(int));
}

struct RatioWs {
    unsigned *counter;
    double *q, *a, *b;
    int *j, *any;
    __device__ RatioWs(unsigned char *ws, int nb)
        : counter(reinterpret_cast<unsigned *>(ws)),
          q(reinterpret_cast<double *>(ws + 8)), a(q + nb), b(a + nb),
          j(reinterpret_cast<int *>(b + nb)), any(j + nb) {}
};

template <typename T, typename V>
__global__ void __launch_bounds__(THREADS) seq_ratio_kernel(
        const T *__restrict__ Tt, const V *__restrict__ b, int M, int R,
        double eps, T *__restrict__ ah, unsigned char *__restrict__ ws_bytes,
        int nb, SeqStep<T, V> s) {
    __shared__ bool last;
    const RatioWs ws(ws_bytes, nb);
    const int tid = threadIdx.x;
    const int j = blockIdx.x * THREADS + tid;
    const int h = min(*s.h, R - 1);
    const Ratio<T, V> none{inf<V>(), BIG_INDEX, (T)0, (V)0};
    Ratio<T, V> x = none;
    bool any = false;
    if (j < M) {
        const T a = Tt[(size_t)j * R + h];
        const V bj = b[j];
        ah[j] = a;
        any = a >= (T)eps;
        x = Ratio<T, V>{any ? div_rn(bj, (V)a) : inf<V>(), j, a, bj};
    }
    block_ratio(x, any, none);
    if (tid == 0) {
        ws.q[blockIdx.x] = (double)x.q;
        ws.j[blockIdx.x] = x.j;
        ws.a[blockIdx.x] = (double)x.a;
        ws.b[blockIdx.x] = (double)x.b;
        ws.any[blockIdx.x] = any;
        last = ticket(ws.counter) == (unsigned)nb - 1;
    }
    __syncthreads();
    if (!last) return;

    // The tail's other operands, loaded while the partials fold: the step
    // before wrote them and no block of seq_ratio writes them.
    bool active = false, optimal = false;
    V minc = 0;
    if (tid == 0) {
        active = *s.active != 0;
        optimal = *s.optimal != 0;
        minc = *s.minc;
    }
    // The last block: fold every block's partial (read past L1) in the
    // same order.
    x = none;
    any = false;
    for (int i = tid; i < nb; i += THREADS) {
        any |= __ldcg(ws.any + i) != 0;
        take_first(x, Ratio<T, V>{(V)__ldcg(ws.q + i), __ldcg(ws.j + i),
                                  (T)__ldcg(ws.a + i), (V)__ldcg(ws.b + i)});
    }
    block_ratio(x, any, none);
    if (tid == 0) {
        const bool unb = !any;
        const bool d = active && !(optimal || unb);
        const T p = d ? x.a : (T)1;
        *s.k = x.j;
        *s.unb = unb;
        *s.do_ = d;
        *s.p = p;
        *s.bk = x.b;
        *s.u = d ? div_rn(minc, (V)p) : (V)0;
        *ws.counter = 0;                         // ready for the next call
    }
}

template <typename V>
__device__ void block_cands(V &val, int &idx, V &bval, int &bidx) {
    __shared__ V sv[NW], sbv[NW];
    __shared__ int si[NW], sbi[NW];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    auto fold = [&](int width) {
        for (int off = width / 2; off > 0; off >>= 1) {
            const V v2 = __shfl_xor_sync(FULL, val, off);
            const int i2 = __shfl_xor_sync(FULL, idx, off);
            const V bv2 = __shfl_xor_sync(FULL, bval, off);
            const int bi2 = __shfl_xor_sync(FULL, bidx, off);
            if (first(v2, i2, val, idx)) {
                val = v2;
                idx = i2;
            }
            if (bi2 < bidx) {
                bidx = bi2;
                bval = bv2;
            }
        }
    };
    fold(32);
    if (lane == 0) {
        sv[warp] = val;
        si[warp] = idx;
        sbv[warp] = bval;
        sbi[warp] = bidx;
    }
    __syncthreads();
    if (warp == 0) {
        const bool has = lane < NW;
        val = has ? sv[lane] : inf<V>();
        idx = has ? si[lane] : BIG_INDEX;
        bval = has ? sbv[lane] : inf<V>();
        bidx = has ? sbi[lane] : BIG_INDEX;
        fold(NW);
    }
    __syncthreads();                             // the arrays free again
}

__host__ __device__ constexpr size_t colk_ws_bytes(int nb) {
    return 8 + (size_t)nb * (2 * sizeof(double) + 2 * sizeof(int));
}

struct ColkWs {
    unsigned *counter;
    double *val, *bval;
    int *idx, *bidx;
    __device__ ColkWs(unsigned char *ws, int nb)
        : counter(reinterpret_cast<unsigned *>(ws)),
          val(reinterpret_cast<double *>(ws + 8)), bval(val + nb),
          idx(reinterpret_cast<int *>(bval + nb)), bidx(idx + nb) {}
};

template <typename T, typename V, bool FOLD>
__global__ void __launch_bounds__(THREADS) seq_colk_kernel(
        const T *__restrict__ Tt, V *__restrict__ costs, V *__restrict__ b,
        int *__restrict__ base, const T *__restrict__ ah,
        T *__restrict__ colk, T *__restrict__ fac, int M, int R, int r,
        double eps, int n_rblocks, unsigned char *__restrict__ ws_bytes,
        SeqStep<T, V> s, seq::Policy pol) {
    const int tid = threadIdx.x;
    const bool d = *s.do_ != 0;
    const int k = *s.k;
    if ((int)blockIdx.x >= n_rblocks) {
        // M axis: factor and b where the pivot is done (whole blocks
        // return together).
        const int j = (blockIdx.x - n_rblocks) * THREADS + tid;
        if (!d || j >= M) return;
        const T p = *s.p;
        const V bk = *s.bk;
        const T f = div_rn(ah[j], p);
        if (FOLD) fac[j] = f;
        if (j == k) {
            b[j] = div_rn(bk, (V)p);
            if (!FOLD) base[j] = *s.h;
        } else {
            b[j] = sub_rn(b[j], mul_rn(bk, (V)f));
        }
        return;
    }

    const int i = blockIdx.x * THREADS + tid;    // this thread's column
    V val = inf<V>(), bval = inf<V>();
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    if (i < R) {
        const T ck = Tt[(size_t)k * R + i];
        colk[i] = ck;
        if (FOLD) {
            V c = costs[i];
            if (d) {
                c = sub_rn(c, mul_rn(*s.u, (V)ck));
                costs[i] = c;
            }
            const V cm = i < r ? c : inf<V>();   // torch.where(iota < r, ..)
            val = cm;
            idx = i;
            if (cm <= -(V)eps) {
                bval = cm;
                bidx = i;
            }
        }
    }
    if constexpr (FOLD) {
        __shared__ bool last;
        const ColkWs ws(ws_bytes, n_rblocks);
        block_cands(val, idx, bval, bidx);
        if (tid == 0) {
            ws.val[blockIdx.x] = (double)val;
            ws.idx[blockIdx.x] = idx;
            ws.bval[blockIdx.x] = (double)bval;
            ws.bidx[blockIdx.x] = bidx;
            last = ticket(ws.counter) == (unsigned)n_rblocks - 1;
        }
        __syncthreads();
        if (!last) return;

        // The tail's other operands, loaded while the partials fold.
        seq::PostIn<V> in{};
        if (tid == 0) in = seq::post_load(s);
        val = bval = inf<V>();
        idx = bidx = BIG_INDEX;
        for (int q = tid; q < n_rblocks; q += THREADS) {
            const V vq = (V)__ldcg(ws.val + q);
            const int iq = __ldcg(ws.idx + q);
            if (first(vq, iq, val, idx)) {
                val = vq;
                idx = iq;
            }
            const int bq = __ldcg(ws.bidx + q);
            if (bq < bidx) {
                bidx = bq;
                bval = (V)__ldcg(ws.bval + q);
            }
        }
        block_cands(val, idx, bval, bidx);
        if (tid == 0) {
            const seq::Candidates<V> c{idx, val, bidx,
                                       bidx == BIG_INDEX ? inf<V>() : bval};
            *s.h_d = c.h_d;
            *s.v_d = c.v_d;
            *s.h_b = c.h_b;
            *s.v_b = c.v_b;
            if (d) base[k] = *s.h;               // before the step rewrites h
            *ws.counter = 0;                     // ready for the next call
            seq::post(s, in, d, c, pol);
        }
    }
}

}  // namespace ticket_form

// ---------------------------------------------------------------------------
// Form (b), not shipped: seq_colk as one cluster, after seq_ratio's
// cluster. Every thread loads its first columns' costs and k, do, p, bk
// and u at once, then the row; b and the factors from ah and b; the
// candidates folded into block 0's shared memory; block 0's tail.

template <typename T, typename V, int NB, int NT, int PER_>
__global__ void __launch_bounds__(NT) colk_cluster_kernel(
        const T *__restrict__ Tt, V *__restrict__ costs, V *__restrict__ b,
        int *__restrict__ base, const T *__restrict__ ah,
        T *__restrict__ colk, T *__restrict__ fac, int M, int R, int r,
        double eps, SeqStep<T, V> s, seq::Policy pol) {
    constexpr int NW = NT / 32, SPAN = NB * NT;
    __shared__ Cands<V> cwarps[NW];
    __shared__ int cwany[NW];
    __shared__ Cands<V> cparts[NB];
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = rank * NT + tid;
    cluster_arrive_relaxed();
    V c0[PER_];
    first_costs<V, PER_, SPAN>(costs, R, g, c0);
    seq::PostIn<V> in{};
    if (g == 0) in = seq::post_load(s);
    const Between<T, V> w{*s.k, *s.do_ != 0, false, *s.p, *s.bk, *s.u};
    const Cands<V> cnone{inf<V>(), BIG_INDEX, inf<V>(), BIG_INDEX};
    Cands<V> cx = cnone;
    T a0[PER_];
    V b0[PER_];
    colk_cols<T, V, PER_, SPAN>(
            Tt, costs, colk, R, r, (V)eps, w, g, c0, cx, [&] {
                if (w.d)
                    update_rows<T, V, PER_, SPAN>(b, fac, ah, M, w, g, false,
                                                  a0, b0);
            });
    bool unused = false;
    block_fold<NW>(cx, unused, cnone, cwarps, cwany);
    cluster_wait();
    if (tid == 0) *cl.map_shared_rank(&cparts[rank], 0) = cx;
    cluster_arrive();
    cluster_wait();
    if (rank != 0 || warp != 0) return;
    cx = warp_fold(lane < NB ? cparts[lane] : cnone);
    if (lane != 0) return;
    const seq::Candidates<V> c{cx.idx, cx.val, cx.bidx,
                               cx.bidx == BIG_INDEX ? inf<V>() : cx.bval};
    *s.h_d = c.h_d;
    *s.v_d = c.v_d;
    *s.h_b = c.h_b;
    *s.v_b = c.v_b;
    if (w.d) base[w.k] = *s.h;                   // before the step rewrites h
    seq::post(s, in, w.d, c, pol);
}

// ---------------------------------------------------------------------------
// The harness.

// One state's device buffers: the tableau (shared, never written), the
// vectors, the fixed buffers, the scalars (one 8-byte slot each, in
// SeqStep's order) and the ticket form's workspaces.
template <typename T, typename V>
struct Bufs {
    const T *Tt;
    V *costs, *b;
    int *base;
    T *ah, *colk, *fac;
    unsigned char *scal;                         // 19 slots of 8 bytes
    unsigned char *ws_r, *ws_c;
    int M, R, r;
    double eps;
    seq::Policy pol;
    SeqStep<T, V> step() const {
        SeqStep<T, V> s;
        void **f = reinterpret_cast<void **>(&s);
        for (int i = 0; i < 19; ++i) f[i] = scal + 8 * i;
        return s;
    }
};

template <typename T, typename V>
using LaunchFn = int (*)(const Bufs<T, V> &, cudaStream_t);

template <typename T, typename V>
int ticket_ratio(const Bufs<T, V> &x, cudaStream_t st) {
    const int nb = (x.M + THREADS - 1) / THREADS;
    ticket_form::seq_ratio_kernel<T, V><<<nb, THREADS, 0, st>>>(
        x.Tt, x.b, x.M, x.R, x.eps, x.ah, x.ws_r, nb, x.step());
    return (int)cudaGetLastError();
}

template <typename T, typename V>
int ticket_colk(const Bufs<T, V> &x, cudaStream_t st) {
    const int nr = (x.R + THREADS - 1) / THREADS;
    const int nm = (x.M + THREADS - 1) / THREADS;
    ticket_form::seq_colk_kernel<T, V, true>
            <<<nr + nm, THREADS, 0, st>>>(
        x.Tt, x.costs, x.b, x.base, x.ah, x.colk, x.fac, x.M, x.R, x.r,
        x.eps, nr, x.ws_c, x.step(), x.pol);
    return (int)cudaGetLastError();
}

template <typename T, typename V, int NB, int NT, int P>
int a_ratio(const Bufs<T, V> &x, cudaStream_t st) {
    auto kernel = seq_ratio_kernel<T, V, NB, NT, P>;
    static const cudaError_t e = allow_cluster(kernel, NB);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, NB, NT, false, st, x.Tt, (const V *)x.b,
                          x.M, x.R, x.eps, x.ah, x.step());
}

template <typename T, typename V, int NB, int NT, int P>
int b_colk(const Bufs<T, V> &x, cudaStream_t st) {
    auto kernel = colk_cluster_kernel<T, V, NB, NT, P>;
    static const cudaError_t e = allow_cluster(kernel, NB);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, NB, NT, false, st, x.Tt, x.costs, x.b,
                          x.base, (const T *)x.ah, x.colk, x.fac, x.M, x.R,
                          x.r, x.eps, x.step(), x.pol);
}

template <typename T, typename V, int NB, int NT, int P>
int c_fused(const Bufs<T, V> &x, cudaStream_t st) {
    auto kernel = seq_ratio_colk_kernel<T, V, NB, NT, P, false>;
    static const cudaError_t e = allow_cluster(kernel, NB);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, NB, NT, false, st, x.Tt, x.costs, x.b,
                          x.base, x.ah, x.colk, x.fac, x.M, x.R, x.r, x.eps,
                          x.step(), x.pol, 0, (double *)nullptr,
                          (int *)nullptr);
}

// A form: its name, the ratio test's launch and the pass's (none: the
// first launch does both).
template <typename T, typename V>
struct Form {
    std::string name;
    LaunchFn<T, V> ratio, colk;
};

// The two cluster forms at NB blocks of NT threads, P at a time.
template <typename T, typename V, int NB, int NT, int P>
void add_cfg(std::vector<Form<T, V>> &out) {
    const std::string tag = std::to_string(NB) + "x" + std::to_string(NT) +
                            "p" + std::to_string(P);
    out.push_back({"ab" + tag, a_ratio<T, V, NB, NT, P>,
                   b_colk<T, V, NB, NT, P>});
    out.push_back({"c" + tag, c_fused<T, V, NB, NT, P>, nullptr});
}

template <typename T, typename V>
std::vector<Form<T, V>> forms() {
    std::vector<Form<T, V>> out{
            {"ticket", ticket_ratio<T, V>, ticket_colk<T, V>}};
    add_cfg<T, V, 16, 256, 4>(out);
    add_cfg<T, V, 16, 256, 8>(out);
    add_cfg<T, V, 16, 128, 8>(out);
    add_cfg<T, V, 16, 512, 2>(out);
    add_cfg<T, V, 16, 512, 4>(out);
    add_cfg<T, V, 8, 512, 4>(out);
    add_cfg<T, V, 8, 256, 8>(out);
    add_cfg<T, V, 16, 1024, 1>(out);
    return out;
}

template <typename V>
V inf_host() {
    return std::numeric_limits<V>::infinity();
}

// The host's copy of a state.
template <typename T, typename V>
struct Host {
    int M, R, r;
    std::vector<T> Tt;
    std::vector<V> costs, b;
    std::vector<int> base;
    unsigned char scal[19 * 8];
    seq::Policy pol;
    double eps;
};

template <typename X>
void put(unsigned char *scal, int slot, X v) {
    std::memset(scal + 8 * slot, 0, 8);
    std::memcpy(scal + 8 * slot, &v, sizeof v);
}

template <typename X>
X get(const unsigned char *scal, int slot) {
    X v;
    std::memcpy(&v, scal + 8 * slot, sizeof v);
    return v;
}

// SeqStep's slots.
enum Slot {
    S_STATUS, S_ITER, S_STALL, S_BLAND, S_Z, S_HD, S_VD, S_HB, S_VB,
    S_ACTIVE, S_H, S_MINC, S_OPTIMAL, S_K, S_BK, S_UNB, S_DO, S_P, S_U
};

const char *EDGES[] = {"taken",       "nan-b",         "tie-rows",
                       "no-row",      "no-column",     "tie-columns",
                       "nan-cost",    "bland-static",  "bland-threshold",
                       "optimal"};
constexpr int N_EDGES = 10;

// A seeded state at M x R bent into ``edge`` (timed: a degenerate pivot).
template <typename T, typename V>
Host<T, V> make_state(int M, int R, int edge, bool timed, unsigned seed) {
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> u(-1.0, 1.0), ub(0.0, 100.0);
    Host<T, V> x;
    x.M = M;
    x.R = R;
    x.r = std::max(1, R - std::min(100, R / 4));
    x.eps = sizeof(T) == 8 ? 1e-9 : 1e-4;
    x.Tt.resize((size_t)M * R);
    unsigned long long z = seed;                 // splitmix64: fast enough
    for (auto &v : x.Tt) {                       // for 10^9 elements
        z += 0x9e3779b97f4a7c15ull;
        unsigned long long w = z;
        w = (w ^ (w >> 30)) * 0xbf58476d1ce4e5b9ull;
        w = (w ^ (w >> 27)) * 0x94d049bb133111ebull;
        w ^= w >> 31;
        v = (T)((double)(w >> 11) * 0x1.0p-52 - 1.0);
    }
    x.costs.resize(R);
    for (auto &v : x.costs) v = (V)u(rng);
    x.b.resize(M);
    for (auto &v : x.b) v = (V)ub(rng);
    x.base.resize(M);
    for (auto &v : x.base) v = (int)(rng() % R);
    const int h = (int)(rng() % x.r);
    const T eps_t = (T)x.eps;
    std::vector<int> rows;
    for (int j = 0; j < M; ++j)
        if (x.Tt[(size_t)j * R + h] >= eps_t) rows.push_back(j);
    if (rows.empty() && edge != 3) {             // make one row eligible
        x.Tt[(size_t)(M / 2) * R + h] = (T)0.5;
        rows.push_back(M / 2);
    }
    int mode = step::BLAND_THRESHOLD, stall = 0;
    bool active = true, bland = false;
    V minc = (V)-0.75;
    switch (edge) {
    case 1: x.b[rows[rows.size() / 2]] = (V)NAN; break;
    case 2:
        if (rows.size() > 1) {
            const int j1 = rows.front(), j2 = rows.back();
            x.Tt[(size_t)j2 * R + h] = x.Tt[(size_t)j1 * R + h];
            x.b[j1] = x.b[j2] = (V)1e-3 * (V)x.Tt[(size_t)j1 * R + h];
        }
        break;
    case 3:
        for (int j = 0; j < M; ++j) {
            T &a = x.Tt[(size_t)j * R + h];
            a = -std::fabs(a);
        }
        break;
    case 4:
        active = false;
        for (auto &v : x.costs) v = std::fabs(v);
        break;
    case 5:
        active = false;
        if (x.r > 1) x.costs[0] = x.costs[x.r - 1] = (V)-5;
        break;
    case 6: x.costs[x.r / 2] = (V)NAN; break;
    case 7: mode = step::BLAND_STATIC; break;
    case 8:
        x.b[rows[0]] = 0;                        // z does not move
        stall = 49;
        break;
    case 9: minc = (V)0.25; break;               // optimal: skipped
    }
    if (timed) x.b[rows[rows.size() / 2]] = 0;   // degenerate: b stays put
    x.pol = seq::Policy{1LL << 40, x.eps, mode, 50, 1};
    std::memset(x.scal, 0, sizeof x.scal);
    put<int>(x.scal, S_STATUS, step::RUNNING);
    put<int>(x.scal, S_ITER, 3);
    put<int>(x.scal, S_STALL, stall);
    put<unsigned char>(x.scal, S_BLAND, bland);
    put<V>(x.scal, S_Z, (V)1.5);
    put<int>(x.scal, S_HD, h);
    put<V>(x.scal, S_VD, minc);
    put<int>(x.scal, S_HB, BIG_INDEX);
    put<V>(x.scal, S_VB, inf_host<V>());
    put<unsigned char>(x.scal, S_ACTIVE, active);
    put<int>(x.scal, S_H, h);
    put<V>(x.scal, S_MINC, minc);
    put<unsigned char>(x.scal, S_OPTIMAL, minc > -(V)x.eps);
    return x;
}

template <typename T, typename V>
struct Device {
    Bufs<T, V> x;
    T *Tt;
    size_t ws_r_bytes, ws_c_bytes;
    Device(const Host<T, V> &h) {
        CK(cudaMalloc(&Tt, h.Tt.size() * sizeof(T)));
        CK(cudaMemcpy(Tt, h.Tt.data(), h.Tt.size() * sizeof(T),
                      cudaMemcpyHostToDevice));
        x.Tt = Tt;
        x.M = h.M;
        x.R = h.R;
        x.r = h.r;
        x.eps = h.eps;
        x.pol = h.pol;
        CK(cudaMalloc(&x.costs, h.R * sizeof(V)));
        CK(cudaMalloc(&x.b, h.M * sizeof(V)));
        CK(cudaMalloc(&x.base, h.M * sizeof(int)));
        CK(cudaMalloc(&x.ah, h.M * sizeof(T)));
        CK(cudaMalloc(&x.colk, h.R * sizeof(T)));
        CK(cudaMalloc(&x.fac, h.M * sizeof(T)));
        CK(cudaMalloc(&x.scal, 19 * 8));
        ws_r_bytes =
                ticket_form::ratio_ws_bytes((h.M + THREADS - 1) / THREADS);
        ws_c_bytes =
                ticket_form::colk_ws_bytes((h.R + THREADS - 1) / THREADS);
        CK(cudaMalloc(&x.ws_r, ws_r_bytes));
        CK(cudaMalloc(&x.ws_c, ws_c_bytes));
        reset(h);
    }
    // Every buffer the pivot writes back to the host's state (fac and ah
    // to a fixed pattern, so an unwritten element shows).
    void reset(const Host<T, V> &h) {
        CK(cudaMemcpy(x.costs, h.costs.data(), h.R * sizeof(V),
                      cudaMemcpyHostToDevice));
        CK(cudaMemcpy(x.b, h.b.data(), h.M * sizeof(V),
                      cudaMemcpyHostToDevice));
        CK(cudaMemcpy(x.base, h.base.data(), h.M * sizeof(int),
                      cudaMemcpyHostToDevice));
        CK(cudaMemset(x.ah, 0x7f, h.M * sizeof(T)));
        CK(cudaMemset(x.colk, 0x7f, h.R * sizeof(T)));
        CK(cudaMemset(x.fac, 0x7f, h.M * sizeof(T)));
        CK(cudaMemcpy(x.scal, h.scal, 19 * 8, cudaMemcpyHostToDevice));
        CK(cudaMemset(x.ws_r, 0, ws_r_bytes));
        CK(cudaMemset(x.ws_c, 0, ws_c_bytes));
    }
    ~Device() {
        cudaFree(Tt);
        cudaFree(x.costs);
        cudaFree(x.b);
        cudaFree(x.base);
        cudaFree(x.ah);
        cudaFree(x.colk);
        cudaFree(x.fac);
        cudaFree(x.scal);
        cudaFree(x.ws_r);
        cudaFree(x.ws_c);
    }
};

// The bytes a pivot leaves: scalars, ah, colk, costs, b, fac, base.
template <typename T, typename V>
std::vector<unsigned char> snapshot(const Bufs<T, V> &x) {
    std::vector<unsigned char> out;
    auto add = [&](const void *p, size_t n) {
        const size_t o = out.size();
        out.resize(o + n);
        CK(cudaMemcpy(out.data() + o, p, n, cudaMemcpyDeviceToHost));
    };
    add(x.scal, 19 * 8);
    add(x.ah, x.M * sizeof(T));
    add(x.colk, x.R * sizeof(T));
    add(x.costs, x.R * sizeof(V));
    add(x.b, x.M * sizeof(V));
    add(x.fac, x.M * sizeof(T));
    add(x.base, x.M * sizeof(int));
    return out;
}

template <typename T, typename V>
int pivot(const Form<T, V> &f, const Bufs<T, V> &x, cudaStream_t st) {
    int e = f.ratio(x, st);
    if (e == 0 && f.colk) e = f.colk(x, st);
    return e;
}

int failures = 0;

template <typename T, typename V>
void check(const char *pair, int M, int R) {
    const auto fs = forms<T, V>();
    for (int edge = 0; edge < N_EDGES; ++edge) {
        const Host<T, V> h =
                make_state<T, V>(M, R, edge, false, 1000 + 31 * edge + M);
        Device<T, V> d(h);
        CK(pivot(fs[0], d.x, 0));
        CK(cudaDeviceSynchronize());
        const auto want = snapshot(d.x);
        const int k = get<int>(want.data(), S_K);
        const bool done = get<unsigned char>(want.data(), S_DO) != 0;
        std::string bad;
        for (size_t v = 1; v < fs.size(); ++v) {
            d.reset(h);
            const int e = pivot(fs[v], d.x, 0);
            if (e != 0) {
                bad += " " + fs[v].name + "(launch " +
                       cudaGetErrorString((cudaError_t)e) + ")";
                cudaGetLastError();
                continue;
            }
            CK(cudaDeviceSynchronize());
            if (snapshot(d.x) != want) bad += " " + fs[v].name;
        }
        std::printf("check %s M=%d R=%d %-15s k=%d do=%d: %s\n", pair, M, R,
                    EDGES[edge], k, (int)done,
                    bad.empty() ? "every form bit for bit" : "DIFFER");
        if (!bad.empty()) {
            std::printf("  differ:%s\n", bad.c_str());
            ++failures;
        }
    }
}

float replay_us(cudaGraphExec_t g, cudaStream_t st, int pivots) {
    cudaEvent_t e0, e1;
    CK(cudaEventCreate(&e0));
    CK(cudaEventCreate(&e1));
    CK(cudaEventRecord(e0, st));
    for (int i = 0; i < 20; ++i) CK(cudaGraphLaunch(g, st));
    CK(cudaEventRecord(e1, st));
    CK(cudaEventSynchronize(e1));
    float ms = 0;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    CK(cudaEventDestroy(e0));
    CK(cudaEventDestroy(e1));
    return 1e3f * ms / (20 * pivots);
}

// ``fn`` 50 times as a CUDA graph on st.
template <typename F>
cudaGraphExec_t capture(cudaStream_t st, F fn) {
    cudaGraph_t g;
    cudaGraphExec_t exec;
    CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal));
    for (int i = 0; i < 50; ++i) CK(fn());
    CK(cudaStreamEndCapture(st, &g));
    CK(cudaGraphInstantiate(&exec, g, 0));
    CK(cudaGraphDestroy(g));
    return exec;
}

void report(const char *what, const std::vector<std::string> &names,
            std::vector<std::vector<float>> &t) {
    for (size_t v = 0; v < names.size(); ++v) {
        auto s = t[v];
        std::sort(s.begin(), s.end());
        std::printf("time %s %-14s min %.3f median %.3f max %.3f us (",
                    what, names[v].c_str(), s.front(), s[s.size() / 2],
                    s.back());
        for (size_t i = 0; i < t[v].size(); ++i)
            std::printf("%s%.3f", i ? " " : "", t[v][i]);
        std::printf(")\n");
    }
}

// In turns: every graph, then back, three rounds.
void turns(const std::vector<cudaGraphExec_t> &gs, cudaStream_t st,
           std::vector<std::vector<float>> &t) {
    const int n = (int)gs.size();
    t.assign(n, {});
    for (int v = 0; v < n; ++v) CK(cudaGraphLaunch(gs[v], st));   // warm
    for (int round = 0; round < 3; ++round)
        for (int i = 0; i < 2 * n; ++i) {
            const int v = i < n ? i : 2 * n - 1 - i;
            t[v].push_back(replay_us(gs[v], st, 50));
        }
}

// With ``cold``, the pivot forms again with a 256 MiB write before every
// pivot in the graph, less the writes alone: the column, the row and the
// vectors come from HBM, as they do in the loop once the rank-1 update
// has streamed a tableau larger than L2 through it.
template <typename T, typename V>
void timing(const char *pair, int M, int R, bool cold) {
    const auto fs = forms<T, V>();
    const Host<T, V> h = make_state<T, V>(M, R, 0, true, 7 + M);
    Device<T, V> d(h);
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    // A pivot first, so the state is a taken, degenerate one: each timed
    // call does the same work (no then_pre: h stays).
    Bufs<T, V> x = d.x;
    x.pol.then_pre = 0;
    CK(pivot(fs[0], x, st));
    CK(cudaStreamSynchronize(st));
    const auto s0 = snapshot(x);
    std::printf("timed state %s M=%d R=%d: k=%d do=%d\n", pair, M, R,
                get<int>(s0.data(), S_K),
                (int)get<unsigned char>(s0.data(), S_DO));
    std::vector<cudaGraphExec_t> gs;
    std::vector<std::string> names;
    for (const auto &f : fs) {
        gs.push_back(capture(st, [&] { return pivot(f, x, st); }));
        names.push_back(f.name);
    }
    std::vector<std::vector<float>> t;
    turns(gs, st, t);
    char what[96];
    std::snprintf(what, sizeof what, "%s M=%d R=%d pivot", pair, M, R);
    report(what, names, t);
    for (auto g : gs) CK(cudaGraphExecDestroy(g));

    // Each kernel of the two-launch forms alone.
    gs.clear();
    names.clear();
    for (const auto &f : fs) {
        if (!f.colk) continue;
        gs.push_back(capture(st, [&] { return f.ratio(x, st); }));
        names.push_back(f.name + "-ratio");
        gs.push_back(capture(st, [&] { return f.colk(x, st); }));
        names.push_back(f.name + "-colk");
    }
    turns(gs, st, t);
    std::snprintf(what, sizeof what, "%s M=%d R=%d alone", pair, M, R);
    report(what, names, t);
    for (auto g : gs) CK(cudaGraphExecDestroy(g));

    if (cold) {
        const size_t nj = 256ull << 20;
        void *junk;
        CK(cudaMalloc(&junk, nj));
        auto flush = [&] { return (int)cudaMemsetAsync(junk, 0, nj, st); };
        gs.clear();
        names.clear();
        gs.push_back(capture(st, flush));
        for (const auto &f : fs) {
            gs.push_back(capture(st, [&] {
                const int e = flush();
                return e ? e : pivot(f, x, st);
            }));
            names.push_back(f.name);
        }
        turns(gs, st, t);
        auto w = t[0];
        std::sort(w.begin(), w.end());
        std::printf("time %s M=%d R=%d the 256 MiB write alone: median "
                    "%.3f us\n", pair, M, R, w[w.size() / 2]);
        t.erase(t.begin());
        for (auto &tv : t)
            for (auto &x : tv) x -= w[w.size() / 2];
        std::snprintf(what, sizeof what, "%s M=%d R=%d cold pivot", pair, M,
                      R);
        report(what, names, t);
        for (auto g : gs) CK(cudaGraphExecDestroy(g));
        CK(cudaFree(junk));
    }
    CK(cudaStreamDestroy(st));
}


// ---------------------------------------------------------------------------
// The sequential sharded loop's column and pass (``sharded``): the shipped
// seq_fold_column (it lets the pass launch as it starts) and
// seq_ratio_colk_sharded (a programmatic dependent launch: the costs, b
// and the step after's operands loaded before it waits) at 16 x 256 and
// 16 x 512 threads, against the forms before (seq_prior), byte for byte
// from each edge state, at one rank and as rank 0 of 3, 8 and 33 (its own
// candidate winning, or rank P - 1's: zeros); then timed in turns.

// The gathered candidates of P ranks, V (P, kv) f64 ([v_d, v_b] or under
// devex [v_d, v_b, w_d, w_b, key], the key -v_d) and I (P, 2) int32, in
// one of FOLD_EDGES: rank 0 (this slice, columns [0, R)) packs h with the
// state's minc, rank q > 0 the column R + 10 q with the larger value 0.5 q,
// and no rank a Bland candidate (own); or rank P - 1 the smallest value
// (other); every rank minc (tie); every rank but 0 minc - 1 (tie-late: rank
// 1); a NaN value at rank 0, P / 2 or P - 1 with rank P - 1's the smallest
// otherwise (nan-*: rank 0 wins); Bland candidates at rank 0 (h) and at the
// odd ranks (bland-own), or at every rank but 0, the lowest at rank P - 1
// (bland-other); every value +inf (inf-none: keys of -inf, rank 0); rank P /
// 2's value -inf (inf-mid). The weights differ from rank to rank.
const char *const FOLD_EDGES[] = {"own",         "other",    "tie",
                                  "tie-late",    "nan-first", "nan-mid",
                                  "nan-last",    "bland-own", "bland-other",
                                  "inf-none",    "inf-mid"};
constexpr int N_FOLD_EDGES = 11;
enum { EDGE_OWN, EDGE_OTHER };

struct Gathered {
    double *V;
    int *I;
    int P, kv;
};

Gathered gathered(int h, double minc, int R, int P, int edge, int kv = 2) {
    const double inf = std::numeric_limits<double>::infinity();
    const double nan = std::numeric_limits<double>::quiet_NaN();
    Gathered g{nullptr, nullptr, P, kv};
    std::vector<double> vd(P), vb(P, inf);
    std::vector<int> hd(P), hb(P, BIG_INDEX);
    for (int q = 0; q < P; ++q) {
        hd[q] = q == 0 ? h : R + 10 * q;
        vd[q] = q == 0 ? minc : 0.5 * q;
    }
    switch (edge) {
    case 1: vd[P - 1] = minc - 1.0; break;
    case 2:
        for (auto &x : vd) x = minc;
        break;
    case 3:
        for (int q = 1; q < P; ++q) vd[q] = minc - 1.0;
        break;
    case 4:
    case 5:
    case 6:
        if (P > 1) vd[P - 1] = minc - 1.0;
        vd[edge == 4 ? 0 : edge == 5 ? P / 2 : P - 1] = nan;
        break;
    case 7:
        hb[0] = h;
        vb[0] = minc - 0.5;
        for (int q = 1; q < P; q += 2) {
            hb[q] = R + 10 * q + 1;
            vb[q] = -0.25 * q;
        }
        break;
    case 8:
        for (int q = 1; q < P; ++q) {
            hb[q] = R + 10 * (P - q) + 1;
            vb[q] = -0.25 * q;
        }
        break;
    case 9:
        for (auto &x : vd) x = inf;
        break;
    case 10: vd[P / 2] = -inf; break;
    }
    std::vector<double> v((size_t)kv * P);
    std::vector<int> ix(2 * P);
    for (int q = 0; q < P; ++q) {
        double *row = v.data() + (size_t)kv * q;
        row[0] = vd[q];
        row[1] = vb[q];
        if (kv == 5) {
            row[2] = 1.0 / 3.0 + 0.37 * q;
            row[3] = 2.0 + 0.11 * q;
            row[4] = -vd[q];
        }
        ix[2 * q] = hd[q];
        ix[2 * q + 1] = hb[q];
    }
    CK(cudaMalloc(&g.V, v.size() * sizeof(double)));
    CK(cudaMalloc(&g.I, ix.size() * sizeof(int)));
    CK(cudaMemcpy(g.V, v.data(), v.size() * sizeof(double),
                  cudaMemcpyHostToDevice));
    CK(cudaMemcpy(g.I, ix.data(), ix.size() * sizeof(int),
                  cudaMemcpyHostToDevice));
    return g;
}

void release(Gathered &g) {
    CK(cudaFree(g.V));
    CK(cudaFree(g.I));
}

const char *const SHARDED_FORMS[] = {"before", "16x256", "16x512"};
constexpr int NSHARDED = 3;

// The column and the pass of form ``form`` (before, or the shipped ones at
// 256 and 512 threads a block): ``column`` runs the fold, ``pass`` the
// pass.
template <typename T, typename V>
int sharded_pivot(int form, const Bufs<T, V> &x, const Gathered &g,
                  double *send_v, int *send_i, cudaStream_t st,
                  bool column = true, bool pass = true) {
    const SeqStep<T, V> s = x.step();
    int e = 0;
    if (column)
        e = form == 0 ? seq_prior::fold_column_run<T, V>(
                                x.Tt, g.V, g.I, g.P, x.M, x.R, 0, x.ah, &s,
                                x.pol.max_iter, x.eps, st)
                      : fold_column_run<T, V>(x.Tt, g.V, g.I, g.P, x.M, x.R,
                                              0, x.ah, &s, x.pol.max_iter,
                                              x.eps, st);
    if (e || !pass) return e;
    if (form == 0)
        return seq_prior::ratio_colk_run<T, V, true>(
                x.Tt, x.costs, x.b, x.base, x.ah, x.colk, x.fac, x.M, x.R,
                x.r, x.eps, &s, x.pol, st, 0, send_v, send_i);
    return ratio_colk_sharded_run<T, V>(
            x.Tt, x.costs, x.b, x.base, x.ah, x.colk, x.fac, x.M, x.R, x.r,
            x.eps, &s, x.pol, 0, send_v, send_i,
            form == 1 ? CLUSTER_THREADS : SHARDED_THREADS_WIDE, st);
}

template <typename T, typename V>
void sharded_check(const char *pair, int M, int R) {
    double *send_v;
    int *send_i;
    CK(cudaMalloc(&send_v, 2 * sizeof(double)));
    CK(cudaMalloc(&send_i, 2 * sizeof(int)));
    int n = 0;
    for (int edge = 0; edge < N_EDGES; ++edge) {
        Host<T, V> h =
                make_state<T, V>(M, R, edge, false, 2000 + 37 * edge + M);
        h.pol.then_pre = 0;
        Device<T, V> d(h);
        const int hcol = get<int>(h.scal, S_H);
        const double minc = (double)get<V>(h.scal, S_MINC);
        for (int P : {1, 3, 8, 33})
            for (int other : {EDGE_OWN, EDGE_OTHER}) {
                if (P == 1 && other) continue;
                Gathered g = gathered(hcol, minc, R, P, other);
                std::vector<unsigned char> want;
                for (int form = 0; form < NSHARDED; ++form) {
                    d.reset(h);
                    CK(cudaMemset(send_v, 0x7f, 2 * sizeof(double)));
                    CK(cudaMemset(send_i, 0x7f, 2 * sizeof(int)));
                    CK(sharded_pivot(form, d.x, g, send_v, send_i, 0));
                    CK(cudaDeviceSynchronize());
                    auto got = snapshot(d.x);
                    const size_t at = got.size();
                    got.resize(at + 2 * sizeof(double) + 2 * sizeof(int));
                    CK(cudaMemcpy(got.data() + at, send_v, 2 * sizeof(double),
                                  cudaMemcpyDeviceToHost));
                    CK(cudaMemcpy(got.data() + at + 2 * sizeof(double),
                                  send_i, 2 * sizeof(int),
                                  cudaMemcpyDeviceToHost));
                    if (form == 0) {
                        want = got;
                        continue;
                    }
                    ++n;
                    if (got != want) {
                        ++failures;
                        std::printf("MISMATCH sharded %s M=%d R=%d %s P=%d "
                                    "other=%d %s\n", pair, M, R, EDGES[edge],
                                    P, other, SHARDED_FORMS[form]);
                    }
                }
                release(g);
            }
    }
    std::printf("sharded check %s M=%d R=%d: %d pivots byte for byte\n",
                pair, M, R, n);
    CK(cudaFree(send_v));
    CK(cudaFree(send_i));
}

// us in turns (graphs of 50, three rounds) at f64 on a degenerate taken
// pivot: each form's pass alone, and the column then the pass (as a chunk
// runs them at one rank); with ``cold`` the column and the pass again
// after a 256 MiB write that evicts L2, less the write alone. Then, with
// ``single``, the unsharded seq_ratio_colk before and shipped.
void sharded_timing(int M, int R, bool cold, bool single) {
    using T = double;
    using V = double;
    Host<T, V> h = make_state<T, V>(M, R, 0, true, 7 + M);
    h.pol.then_pre = 0;
    Device<T, V> d(h);
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    double *send_v;
    int *send_i;
    CK(cudaMalloc(&send_v, 2 * sizeof(double)));
    CK(cudaMalloc(&send_i, 2 * sizeof(int)));
    Gathered g = gathered(get<int>(h.scal, S_H),
                          (double)get<V>(h.scal, S_MINC), R, 1, EDGE_OWN);
    CK(sharded_pivot(1, d.x, g, send_v, send_i, st));
    CK(cudaStreamSynchronize(st));
    const auto s0 = snapshot(d.x);
    std::printf("timed sharded state f64 M=%d R=%d: k=%d do=%d\n", M, R,
                get<int>(s0.data(), S_K),
                (int)get<unsigned char>(s0.data(), S_DO));
    std::vector<cudaGraphExec_t> gs;
    std::vector<std::string> names;
    for (int form = 0; form < NSHARDED; ++form) {
        gs.push_back(capture(st, [&] {
            return sharded_pivot(form, d.x, g, send_v, send_i, st, false);
        }));
        names.push_back(std::string(SHARDED_FORMS[form]) + "-pass");
    }
    for (int form = 0; form < NSHARDED; ++form) {
        gs.push_back(capture(st, [&] {
            return sharded_pivot(form, d.x, g, send_v, send_i, st);
        }));
        names.push_back(std::string(SHARDED_FORMS[form]) + "-col+pass");
    }
    std::vector<std::vector<float>> t;
    turns(gs, st, t);
    char what[96];
    std::snprintf(what, sizeof what, "sharded f64 M=%d R=%d", M, R);
    report(what, names, t);
    for (auto e : gs) CK(cudaGraphExecDestroy(e));
    if (cold) {
        const size_t nj = 256ull << 20;
        void *junk;
        CK(cudaMalloc(&junk, nj));
        auto flush = [&] { return (int)cudaMemsetAsync(junk, 0, nj, st); };
        gs.clear();
        names.clear();
        gs.push_back(capture(st, flush));
        for (int form = 0; form < NSHARDED; ++form) {
            gs.push_back(capture(st, [&] {
                const int e = flush();
                return e ? e : sharded_pivot(form, d.x, g, send_v, send_i,
                                             st);
            }));
            names.push_back(std::string(SHARDED_FORMS[form]) + "-col+pass");
        }
        turns(gs, st, t);
        auto w = t[0];
        std::sort(w.begin(), w.end());
        t.erase(t.begin());
        for (auto &tv : t)
            for (auto &x : tv) x -= w[w.size() / 2];
        std::snprintf(what, sizeof what, "sharded f64 M=%d R=%d cold", M, R);
        report(what, names, t);
        for (auto e : gs) CK(cudaGraphExecDestroy(e));
        CK(cudaFree(junk));
    }
    if (single) {
        // The unsharded pass (the default loop's), before and shipped.
        Bufs<T, V> x = d.x;
        x.pol.then_pre = 0;
        const SeqStep<T, V> s = x.step();
        gs.clear();
        names = {"before", "shipped"};
        gs.push_back(capture(st, [&] {
            return seq_prior::ratio_colk_run<T, V>(
                    x.Tt, x.costs, x.b, x.base, x.ah, x.colk, x.fac, x.M,
                    x.R, x.r, x.eps, &s, x.pol, st);
        }));
        gs.push_back(capture(st, [&] {
            return ratio_colk_run<T, V>(x.Tt, x.costs, x.b, x.base, x.ah,
                                        x.colk, x.fac, x.M, x.R, x.r, x.eps,
                                        &s, x.pol, st);
        }));
        turns(gs, st, t);
        std::snprintf(what, sizeof what, "seq_ratio_colk f64 M=%d R=%d", M,
                      R);
        report(what, names, t);
        for (auto e : gs) CK(cudaGraphExecDestroy(e));
    }
    release(g);
    CK(cudaFree(send_v));
    CK(cudaFree(send_i));
    CK(cudaStreamDestroy(st));
}

// ---------------------------------------------------------------------------
// The ranks' candidate fold (``heads``): seq_fold_column and K5's sharded
// head as shipped -- every warp folds the gathered candidates by shuffles
// (sharded_step.cuh sharded::fold_warp), with no block barrier before the
// column's loads -- against the forms before (seq_prior, k5_prior: each
// block's thread 0 folding into shared memory behind a barrier) and three
// other forms: one warp folding into shared memory behind one barrier
// (ONE_WARP), every warp folding with block 0's step before its loads
// (STEP_FIRST), and every thread folding the ranks in order (SERIAL);
// seq_fold_column also at 256 threads a block. Byte for byte
// from every FOLD_EDGES state at P = 1, 3, 8 and 33, the Bland flag off and
// on, then timed in turns, the own candidate winning and rank P - 1's.

namespace head_forms {

enum { WARPS, ONE_WARP, STEP_FIRST, SERIAL, NO_HEAD };

// seq_fold_column in form ONE_WARP, STEP_FIRST or SERIAL (every thread
// folding the ranks in order, sharded::fold; WARPS is the shipped
// kernel).
template <typename T, typename V, int NT, int FORM>
__global__ void __launch_bounds__(NT) fold_column_kernel(
        const T *__restrict__ Tt, const double *__restrict__ Vg,
        const int *__restrict__ Ig, int P, int M, int R, int offset,
        T *__restrict__ ah, SeqStep<T, V> s, long long max_iter,
        double eps) {
    grid_launch_next();
    const bool step = blockIdx.x == 0 && threadIdx.x == 0;
    int status = 0, iterations = 0;
    if (step) {
        status = *s.status;
        iterations = *s.iterations;
    }
    const int j = blockIdx.x * NT + threadIdx.x;
    if constexpr (FORM == ONE_WARP) {
        __shared__ int col;                      // h's local column, or -1
        if (threadIdx.x < 32) {
            const bool bland = *s.bland != 0;
            const sharded::Fold f = sharded::fold_warp(Vg, Ig, P, 2);
            const seq::Candidates<V> c{f.h_d, (V)f.v_d, f.h_b, (V)f.v_b};
            const int h = bland && c.h_b < BIG_INDEX ? c.h_b : c.h_d;
            const long long loc = (long long)h - offset;
            if (threadIdx.x == 0) col = loc >= 0 && loc < R ? (int)loc : -1;
            if (step) {
                *s.h_d = c.h_d;
                *s.v_d = c.v_d;
                *s.h_b = c.h_b;
                *s.v_b = c.v_b;
                seq::pre(s, status, iterations, bland, c, max_iter, eps);
            }
        }
        __syncthreads();
        const int hl = col;
        if (j < M) ah[j] = hl >= 0 ? Tt[(size_t)j * R + hl] : (T)0;
    } else {
        const bool bland = *s.bland != 0;
        const sharded::Fold f = FORM == SERIAL
                                        ? sharded::fold(Vg, Ig, P, 2)
                                        : sharded::fold_warp(Vg, Ig, P, 2);
        const seq::Candidates<V> c{f.h_d, (V)f.v_d, f.h_b, (V)f.v_b};
        const int h = bland && c.h_b < BIG_INDEX ? c.h_b : c.h_d;
        const long long loc = (long long)h - offset;
        if (FORM == STEP_FIRST && step) {
            *s.h_d = c.h_d;
            *s.v_d = c.v_d;
            *s.h_b = c.h_b;
            *s.v_b = c.v_b;
            seq::pre(s, status, iterations, bland, c, max_iter, eps);
        }
        const T a = loc >= 0 && loc < R && j < M ? Tt[(size_t)j * R + loc]
                                                 : (T)0;
        if (FORM == SERIAL && step) {
            *s.h_d = c.h_d;
            *s.v_d = c.v_d;
            *s.h_b = c.h_b;
            *s.v_b = c.v_b;
            seq::pre(s, status, iterations, bland, c, max_iter, eps);
        }
        if (j < M) ah[j] = a;
    }
}

template <typename T, typename V, int NT, int FORM>
int fold_column_run(const void *Tt, const double *V_, const int *I, int P,
                    int M, int R, int offset, void *ah, const void *step,
                    long long max_iter, double eps, cudaStream_t st) {
    fold_column_kernel<T, V, NT, FORM><<<(M + NT - 1) / NT, NT, 0, st>>>(
            static_cast<const T *>(Tt), V_, I, P, M, R, offset,
            static_cast<T *>(ah), step_of<T, V>(step), max_iter, eps);
    return (int)cudaGetLastError();
}

// K5 (ah_ratio_fused<false>'s column) with the head in form FORM, or
// without it (NO_HEAD: h and the owner flag from h_ptr and own), with
// ah_ratio_fused's operands. WARPS is csrc/blocked.cu's shipped head.
using k5_prior::AHR_COLS;
using k5_prior::AHR_ROWS;
using k5_prior::K5Head;

template <int FORM>
__global__ void __launch_bounds__(k5_prior::THREADS) k5_kernel(
        const float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, const double *__restrict__ b,
        const int *__restrict__ h_ptr, const unsigned char *__restrict__ own,
        int t, int M, int R, float eps, int nb, float *__restrict__ ah,
        unsigned char *__restrict__ ws_bytes, int *__restrict__ k_out,
        float *__restrict__ p_out, double *__restrict__ bk_out,
        int *__restrict__ unb_out, Step s, K5Head hd) {
    constexpr int NTH = k5_prior::THREADS;
    __shared__ __align__(16) float fs[AHR_ROWS][AHR_COLS];
    __shared__ float ch[AHR_ROWS];               // C[s0 + s, h]
    const int tid = threadIdx.x;
    const int j0 = blockIdx.x * AHR_COLS;
    const int j = j0 + tid;
    const bool owner = tid < AHR_COLS;
    k5_prior::ahr_stage<NTH>(F, 0, t, M, j0, fs);
    k5_prior::cp_async_commit();
    const bool step = blockIdx.x == 0 && tid == 0;
    sharded::Fold hf{};
    sharded::Pre hx{};
    int h;
    bool mine;
    if constexpr (FORM == NO_HEAD) {
        h = min(*h_ptr, R - 1);
        mine = own == nullptr || *own != 0;
    } else if constexpr (FORM == ONE_WARP) {
        __shared__ int head_h;
        __shared__ bool head_own;
        if (tid < 32) {
            int status = 0, iters = 0;
            if (step) {
                status = *hd.s.status;
                iters = *hd.s.iterations;
            }
            const bool bland = *hd.s.bland != 0;
            hf = sharded::fold_warp(hd.V, hd.I, hd.P, hd.kv);
            hx = sharded::pre(status, iters, bland, hf, hd.pol.max_iter,
                              hd.pol.eps, hd.pol.offset, hd.pol.R_loc);
            if (step) {
                sharded::store(hd.s, hf);
                sharded::store(hd.s, hx);
            }
            if (tid == 0) {
                head_h = hx.hl;
                head_own = hx.own;
            }
        }
        __syncthreads();
        h = head_h;
        mine = head_own;
    } else {
        int status = 0, iters = 0;
        if (step) {
            status = *hd.s.status;
            iters = *hd.s.iterations;
        }
        const bool bland = *hd.s.bland != 0;
        hf = FORM == SERIAL ? sharded::fold(hd.V, hd.I, hd.P, hd.kv)
                            : sharded::fold_warp(hd.V, hd.I, hd.P, hd.kv);
        hx = sharded::pre(status, iters, bland, hf, hd.pol.max_iter,
                          hd.pol.eps, hd.pol.offset, hd.pol.R_loc);
        h = hx.hl;
        mine = hx.own;
        if (FORM == STEP_FIRST && step) {
            sharded::store(hd.s, hf);
            sharded::store(hd.s, hx);
        }
    }
    for (int s = tid; s < min(AHR_ROWS, t); s += NTH)
        ch[s] = C[(size_t)s * R + h];
    float th = 0.0f;
    if (owner) th = Tt[(size_t)j * R + h];
    if ((FORM == WARPS || FORM == SERIAL) && step) {
        sharded::store(hd.s, hf);
        sharded::store(hd.s, hx);
    }
    if (!mine) {
        k5_prior::cp_async_wait<0>();
        if (owner) ah[j] = 0.0f;
        return;
    }
    if (t == 0) {
        if (owner) ah[j] = __fsub_rn(th, 0.0f);
        return;
    }
    float acc = 0.0f;
    for (int s0 = 0;;) {
        k5_prior::cp_async_wait<0>();
        __syncthreads();
        const int rows = min(AHR_ROWS, t - s0);
        if (owner) {
#pragma unroll 8
            for (int s = 0; s < rows; ++s)
                acc = fmaf(ch[s], fs[s][tid], acc);
        }
        s0 += AHR_ROWS;
        if (s0 >= t) break;
        __syncthreads();
        k5_prior::ahr_stage<NTH>(F, s0, t, M, j0, fs);
        k5_prior::cp_async_commit();
        for (int s = tid; s < min(AHR_ROWS, t - s0); s += NTH)
            ch[s] = C[(size_t)(s0 + s) * R + h];
    }
    if (owner) ah[j] = __fsub_rn(th, acc);
}

}  // namespace head_forms

// seq_fold_column's forms: the one before, the shipped one at 256 and 128
// threads a block, ONE_WARP, STEP_FIRST and SERIAL at 128, SERIAL at 256.
const char *const COL_FORMS[] = {"before",         "warps-256",
                                 "warps-128",      "one-warp-128",
                                 "step-first-128", "serial-128",
                                 "serial-256"};
constexpr int NCOL = 7;

template <typename T, typename V>
int column_form(int form, const Bufs<T, V> &x, const Gathered &g,
                cudaStream_t st) {
    const SeqStep<T, V> s = x.step();
    const auto run = [&](auto fn) {
        return fn(x.Tt, g.V, g.I, g.P, x.M, x.R, 0, x.ah, &s, x.pol.max_iter,
                  x.eps, st);
    };
    using namespace head_forms;
    switch (form) {
    case 0: return run(seq_prior::fold_column_run<T, V>);
    case 1: return run(::fold_column_run<T, V, 256>);
    case 2: return run(::fold_column_run<T, V, 128>);
    case 3: return run(head_forms::fold_column_run<T, V, 128, ONE_WARP>);
    case 4: return run(head_forms::fold_column_run<T, V, 128, STEP_FIRST>);
    case 5: return run(head_forms::fold_column_run<T, V, 128, SERIAL>);
    case 6: return run(head_forms::fold_column_run<T, V, 256, SERIAL>);
    }
    return (int)cudaErrorInvalidValue;
}

void set_bland(unsigned char *scal, int slot, bool on) {
    const unsigned char v = on;
    CK(cudaMemcpy(scal + 8 * slot, &v, 1, cudaMemcpyHostToDevice));
}

// Every column form against the one before, byte for byte (the scalars,
// ah and the rest of the state), from every FOLD_EDGES state at P = 1, 3,
// 8 and 33, the Bland flag off and on.
template <typename T, typename V>
void fold_check(const char *pair, int M, int R) {
    Host<T, V> h = make_state<T, V>(M, R, 0, false, 3000 + M);
    h.pol.then_pre = 0;
    Device<T, V> d(h);
    const int hcol = get<int>(h.scal, S_H);
    const double minc = (double)get<V>(h.scal, S_MINC);
    int n = 0;
    for (int P : {1, 3, 8, 33})
        for (int edge = 0; edge < N_FOLD_EDGES; ++edge)
            for (bool bland : {false, true}) {
                Gathered g = gathered(hcol, minc, R, P, edge);
                std::vector<unsigned char> want;
                for (int form = 0; form < NCOL; ++form) {
                    d.reset(h);
                    set_bland(d.x.scal, S_BLAND, bland);
                    CK(column_form(form, d.x, g, 0));
                    CK(cudaDeviceSynchronize());
                    const auto got = snapshot(d.x);
                    if (form == 0) {
                        want = got;
                        continue;
                    }
                    ++n;
                    if (got != want) {
                        ++failures;
                        std::printf("MISMATCH column %s M=%d R=%d P=%d %s "
                                    "bland=%d %s\n", pair, M, R, P,
                                    FOLD_EDGES[edge], (int)bland,
                                    COL_FORMS[form]);
                    }
                }
                release(g);
            }
    std::printf("column check %s M=%d R=%d: %d columns byte for byte\n",
                pair, M, R, n);
}

// us in turns (graphs of 50 calls, three rounds) at f64: each column form
// alone, then each column with the shipped pass behind it (the pass
// launched as the column starts), at P = 1, 3, 8 and 33, the own candidate
// winning and rank P - 1's.
void fold_timing(int M, int R) {
    using T = double;
    using V = double;
    Host<T, V> h = make_state<T, V>(M, R, 0, true, 7 + M);
    h.pol.then_pre = 0;
    Device<T, V> d(h);
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    double *send_v;
    int *send_i;
    CK(cudaMalloc(&send_v, 2 * sizeof(double)));
    CK(cudaMalloc(&send_i, 2 * sizeof(int)));
    const SeqStep<T, V> s = d.x.step();
    // kernels/seq.py seq_sharded_threads
    const int threads = R <= CLUSTER_BLOCKS * CLUSTER_THREADS * PER
                                ? CLUSTER_THREADS
                                : SHARDED_THREADS_WIDE;
    for (int P : {1, 3, 8, 33})
        for (int edge : {EDGE_OWN, EDGE_OTHER}) {
            if (P == 1 && edge == EDGE_OTHER) continue;
            d.reset(h);
            Gathered g = gathered(get<int>(h.scal, S_H),
                                  (double)get<V>(h.scal, S_MINC), R, P, edge);
            std::vector<cudaGraphExec_t> gs;
            std::vector<std::string> names;
            for (int form = 0; form < NCOL; ++form) {
                gs.push_back(capture(st, [&] {
                    return column_form(form, d.x, g, st);
                }));
                names.push_back(COL_FORMS[form]);
            }
            for (int form = 0; form < NCOL; ++form) {
                gs.push_back(capture(st, [&] {
                    const int e = column_form(form, d.x, g, st);
                    return e ? e
                             : ratio_colk_sharded_run<T, V>(
                                       d.x.Tt, d.x.costs, d.x.b, d.x.base,
                                       d.x.ah, d.x.colk, d.x.fac, M, R, d.x.r,
                                       d.x.eps, &s, d.x.pol, 0, send_v,
                                       send_i,
                                       threads, st);
                }));
                names.push_back(std::string(COL_FORMS[form]) + "+pass");
            }
            std::vector<std::vector<float>> t;
            turns(gs, st, t);
            char what[96];
            std::snprintf(what, sizeof what, "column f64 M=%d R=%d P=%d %s",
                          M, R, P, FOLD_EDGES[edge]);
            report(what, names, t);
            for (auto e : gs) CK(cudaGraphExecDestroy(e));
            release(g);
        }
    CK(cudaFree(send_v));
    CK(cudaFree(send_i));
    CK(cudaStreamDestroy(st));
}

// K5's state on the card: Tt (M, R), F (L, M) and C (L, R) f32 from a
// seed, the column, and the sharded loop's scalars (ShardStep, one 8-byte
// slot a field, a pattern but status, iterations and the Bland flag).
struct K5State {
    int M, R, L;
    float *Tt, *F, *C, *ah;
    unsigned char *scal;
    ShardStep s;
};

constexpr int K5_SLOTS = sizeof(ShardStep) / sizeof(void *);

__global__ void fill_kernel(float *x, size_t n, unsigned long long seed,
                            float scale) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        unsigned long long w = seed + (i + 1) * 0x9e3779b97f4a7c15ull;
        w = (w ^ (w >> 30)) * 0xbf58476d1ce4e5b9ull;
        w = (w ^ (w >> 27)) * 0x94d049bb133111ebull;
        w ^= w >> 31;
        x[i] = scale * (float)((double)(w >> 11) * 0x1.0p-52 - 1.0);
    }
}

K5State k5_state(int M, int R, int L, unsigned long long seed) {
    K5State x{M, R, L};
    CK(cudaMalloc(&x.Tt, (size_t)M * R * sizeof(float)));
    CK(cudaMalloc(&x.F, (size_t)L * M * sizeof(float)));
    CK(cudaMalloc(&x.C, (size_t)L * R * sizeof(float)));
    CK(cudaMalloc(&x.ah, (size_t)M * sizeof(float)));
    CK(cudaMalloc(&x.scal, 8 * K5_SLOTS));
    fill_kernel<<<1024, 256>>>(x.Tt, (size_t)M * R, seed, 1.0f);
    fill_kernel<<<1024, 256>>>(x.F, (size_t)L * M, seed + 1, 0.25f);
    fill_kernel<<<1024, 256>>>(x.C, (size_t)L * R, seed + 2, 0.25f);
    CK(cudaGetLastError());
    void **f = reinterpret_cast<void **>(&x.s);
    for (int i = 0; i < K5_SLOTS; ++i) f[i] = x.scal + 8 * i;
    return x;
}

void k5_release(K5State &x) {
    CK(cudaFree(x.Tt));
    CK(cudaFree(x.F));
    CK(cudaFree(x.C));
    CK(cudaFree(x.ah));
    CK(cudaFree(x.scal));
}

// The scalars a pattern, then status RUNNING, iterations 3 and ``bland``;
// the column a pattern.
void k5_reset(const K5State &x, bool bland) {
    std::vector<unsigned char> scal(8 * K5_SLOTS, 0x5a);
    const int status = step::RUNNING, iterations = 3;
    std::memcpy(scal.data(), &status, sizeof status);
    std::memcpy(scal.data() + 8, &iterations, sizeof iterations);
    scal[24] = bland;
    CK(cudaMemcpy(x.scal, scal.data(), scal.size(), cudaMemcpyHostToDevice));
    CK(cudaMemset(x.ah, 0x7f, x.M * sizeof(float)));
}

std::vector<unsigned char> k5_snapshot(const K5State &x) {
    std::vector<unsigned char> out(8 * K5_SLOTS + x.M * sizeof(float));
    CK(cudaMemcpy(out.data(), x.scal, 8 * K5_SLOTS, cudaMemcpyDeviceToHost));
    CK(cudaMemcpy(out.data() + 8 * K5_SLOTS, x.ah, x.M * sizeof(float),
                  cudaMemcpyDeviceToHost));
    return out;
}

// K5 with its head in form ``form``: 0 the one before (k5_prior), then
// head_forms' WARPS (shipped), ONE_WARP, STEP_FIRST, SERIAL and NO_HEAD (h
// and the owner flag the ones a head stored).
const char *const K5_NAMES[] = {"before", "warps",  "one-warp",
                                "step-first", "serial", "no-head"};
constexpr int NK5 = 6;

int k5_form(int form, const K5State &x, const Gathered &g, int t,
            cudaStream_t st) {
    constexpr long long MAX_ITER = 1LL << 40;
    constexpr double EPS = 1e-4;
    if (form == 0)
        return k5_prior::ah_head_run(x.Tt, x.F, x.C, t, x.M, x.R, x.ah, &x.s,
                                     g.V, g.I, g.P, g.kv, MAX_ITER, EPS, 0,
                                     st);
    const int nb = (x.M + k5_prior::AHR_COLS - 1) / k5_prior::AHR_COLS;
    const k5_prior::K5Head hd{x.s, g.V, g.I, g.P, g.kv,
                                {MAX_ITER, EPS, 0, x.R}};
    auto kernel = form == 1   ? head_forms::k5_kernel<head_forms::WARPS>
                  : form == 2 ? head_forms::k5_kernel<head_forms::ONE_WARP>
                  : form == 3 ? head_forms::k5_kernel<head_forms::STEP_FIRST>
                  : form == 4 ? head_forms::k5_kernel<head_forms::SERIAL>
                              : head_forms::k5_kernel<head_forms::NO_HEAD>;
    kernel<<<nb, k5_prior::THREADS, 0, st>>>(
            x.Tt, x.F, x.C, nullptr, x.s.hl, x.s.own, t, x.M, x.R, 0.0f, nb,
            x.ah, nullptr, nullptr, nullptr, nullptr, nullptr, Step{}, hd);
    return (int)cudaGetLastError();
}

// Every head form against the one before, byte for byte (the scalars and
// the column), from every FOLD_EDGES state at P = 1, 3, 8 and 33, kv 2 and
// 5, the Bland flag off and on, at t = 0, 37 and 127.
void k5_check(int M, int R) {
    K5State x = k5_state(M, R, 128, 11 + M);
    int n = 0;
    for (int t : {0, 37, 127})
        for (int kv : {2, 5})
            for (int P : {1, 3, 8, 33})
                for (int edge = 0; edge < N_FOLD_EDGES; ++edge)
                    for (bool bland : {false, true}) {
                        Gathered g = gathered(12345 % R, -0.75, R, P, edge,
                                              kv);
                        std::vector<unsigned char> want;
                        for (int form = 0; form < NK5 - 1; ++form) {
                            k5_reset(x, bland);
                            CK(k5_form(form, x, g, t, 0));
                            CK(cudaDeviceSynchronize());
                            const auto got = k5_snapshot(x);
                            if (form == 0) {
                                want = got;
                                continue;
                            }
                            ++n;
                            if (got != want) {
                                ++failures;
                                std::printf("MISMATCH K5 head M=%d R=%d t=%d "
                                            "kv=%d P=%d %s bland=%d %s\n", M,
                                            R, t, kv, P, FOLD_EDGES[edge],
                                            (int)bland, K5_NAMES[form]);
                            }
                        }
                        release(g);
                    }
    std::printf("K5 head check M=%d R=%d: %d calls byte for byte\n", M, R,
                n);
    k5_release(x);
}

// us in turns (graphs of 50 calls, three rounds): each K5 form at t = 0,
// 37 and 127, P = 1, 3, 8 and 33, devex (kv 5), the own candidate winning
// and rank P - 1's.
void k5_timing(int M, int R) {
    K5State x = k5_state(M, R, 128, 29 + M);
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    for (int t : {0, 37, 127})
        for (int P : {1, 3, 8, 33})
            for (int edge : {EDGE_OWN, EDGE_OTHER}) {
                if (P == 1 && edge == EDGE_OTHER) continue;
                Gathered g = gathered(12345 % R, -0.75, R, P, edge, 5);
                k5_reset(x, false);
                CK(k5_form(0, x, g, t, st));             // hl and own
                std::vector<cudaGraphExec_t> gs;
                std::vector<std::string> names;
                for (int form = 0; form < NK5; ++form) {
                    gs.push_back(capture(st, [&] {
                        return k5_form(form, x, g, t, st);
                    }));
                    names.push_back(K5_NAMES[form]);
                }
                std::vector<std::vector<float>> tm;
                turns(gs, st, tm);
                char what[96];
                std::snprintf(what, sizeof what,
                              "K5 head f32 M=%d R=%d t=%d P=%d %s", M, R, t,
                              P, FOLD_EDGES[edge]);
                report(what, names, tm);
                for (auto e : gs) CK(cudaGraphExecDestroy(e));
                release(g);
            }
    CK(cudaStreamDestroy(st));
    k5_release(x);
}

// The heads' part alone: the checks, then the timings.
void heads() {
    const int shapes[][2] = {{8192, 24576}, {1024, 3072}, {7, 21},
                             {4097, 257}, {40064, 2048}};
    for (const auto &sh : shapes) {
        fold_check<double, double>("f64", sh[0], sh[1]);
        fold_check<float, double>("mixed", sh[0], sh[1]);
        fold_check<float, float>("f32", sh[0], sh[1]);
    }
    k5_check(1024, 3072);
    k5_check(8192, 24576);
    fold_timing(1024, 3072);
    fold_timing(8192, 24576);
    k5_timing(8192, 24576);
}

int main(int argc, char **argv) {
    const std::string mode = argc > 1 ? argv[1] : "";
    cudaDeviceProp prop;
    CK(cudaGetDeviceProperties(&prop, 0));
    std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
    heads();
    if (mode == "heads") {
        std::printf("bit for bit: %s (%d state(s) differ)\n",
                    failures ? "FAILED" : "every form, every state",
                    failures);
        return failures ? 1 : 0;
    }
    const int sharded[][2] = {{8192, 24576}, {1024, 3072}, {7, 21},
                              {4097, 257},   {4095, 20480}, {40064, 2048}};
    for (const auto &sh : sharded) {
        sharded_check<double, double>("f64", sh[0], sh[1]);
        sharded_check<float, double>("mixed", sh[0], sh[1]);
        sharded_check<float, float>("f32", sh[0], sh[1]);
    }
    sharded_timing(1024, 3072, false, true);
    sharded_timing(2048, 6144, false, false);
    sharded_timing(4096, 12288, true, false);
    sharded_timing(4096, 16384, true, false);
    sharded_timing(4096, 20480, true, false);
    sharded_timing(8192, 16384, true, false);
    sharded_timing(8192, 24576, true, true);
    if (mode == "sharded") {
        std::printf("bit for bit: %s (%d state(s) differ)\n",
                    failures ? "FAILED" : "every form, every state",
                    failures);
        return failures ? 1 : 0;
    }
    const int shapes[][2] = {{8192, 24576}, {1024, 3072}, {2048, 6144},
                             {1, 3},        {7, 21},      {4095, 12285},
                             {4097, 257},   {40064, 2048}};
    for (const auto &s : shapes) {
        check<double, double>("f64", s[0], s[1]);
        check<float, double>("mixed", s[0], s[1]);
        check<float, float>("f32", s[0], s[1]);
    }
    check<float, float>("f32", 2048, 120064);
    check<float, float>("f32", 10112, 120064);
    check<double, double>("f64", 1024, 120064);
    std::printf("bit for bit: %s (%d state(s) differ)\n",
                failures ? "FAILED" : "every form, every state", failures);

    timing<double, double>("f64", 8192, 24576, true);
    timing<double, double>("f64", 1024, 3072, false);
    timing<float, float>("f32", 2048, 6144, true);
    timing<float, double>("mixed", 2048, 6144, false);
    return failures ? 1 : 0;
}

#endif  // SEQ_VARIANTS_LIB
