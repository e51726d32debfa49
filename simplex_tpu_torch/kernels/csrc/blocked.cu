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
// reduced with atomics: each block writes one partial, and the partials are
// folded in a fixed order -- by the last block of the same launch (K1, K2),
// found by an atomic arrival counter in the caller's workspace that only
// counts the blocks that are done, or by a second pass, reprice_finish (K3,
// K11). Every candidate fold orders candidates by (key, then lowest index),
// a total order, so the pivot choices (and therefore the walks) are the
// same from run to run whatever the blocks' order; the f64 reprice sums run
// in a fixed order, so mv is the same bit for bit too.
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
#include "sharded_step.cuh"
#include "step.cuh"

namespace {

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
// Bound on the card: bytes. Per pivot it reads Tt[:, h] (one strided element
// a constraint), the t live F rows, C[:t, h] and b, and writes a_h: 4M + 4tM
// + 4t + 8M + 4M bytes (computed: 1.3 MB at t = 37, M = 8192, 0.39 us at
// HBM's rate). The kernel it replaced made two launches (a tile pass of
// M / 256 blocks, one thread a constraint loading its t F values one
// behind the other behind its FFMA chain, and a one-block fold pass, both
// with an eight-barrier block fold) and took 5.9 us there on NVIDIA H100
// 80GB HBM3, 700.00 W (PERF.md). This kernel: 4.3 us at t = 37 by
// torch.profiler (3.4 at t = 0, 5.4 at t = 127); 4.6 us against the old
// kernel's 6.0 over a CUDA graph in one run (tools/k1k3_variants.cu, which
// also times the parts). What is left is latency, not bytes: the launch
// (1.0 us), h then Tt[:, h] (0.6 us), the F slab, the chain and the
// block's fold (0.7 us at t = 0 to 2.4 at t = 127), the ticket and the
// last block's fold (1.5 us). 32 or 128 constraints a block, and the
// chain's loads batched ahead of it, moved it by less than 0.2 us.
// Design: one launch, as K2's. Each block owns AHR_COLS constraints: its
// 256 threads first issue every load of the block at once -- F[s, its
// constraints] for up to AHR_ROWS live rows as 16-byte cp.async copies into
// shared memory (they do not depend on h, so they go first), then C[s, h]
// and, one thread a constraint, Tt[j, h] and b[j] -- so the whole F slab is
// in flight together; then each owner runs the FFMA chain from shared
// memory, s = 0 .. t-1 in order from 0.0f, and one __fsub_rn. K5 is this
// kernel without the ratio test, so its column is K1's bit for bit.
// AHR_COLS = 64 makes 128
// blocks at M = 8192, one wave on the 132 SMs (at 128 a block, 64 blocks
// would leave half the SMs idle and double each block's serial slab). Each
// block folds its ratio candidates over warp shuffles, writes its partial
// (key, index, a_h, b) to the workspace and takes a ticket from an arrival
// counter there (one acq_rel atomic); the block that draws the last ticket
// folds the partials in the same total order, writes k, p, bk and the
// flag, and resets the counter to 0 for the next call. p and bk are the
// winner's a_h and b[j] carried in its partial: p == a_h[k] and bk == b[k]
// exactly, with no load after the fold.
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
    const AhrWs ws(ws_bytes, nb);
    const int tid = threadIdx.x;
    const int j0 = blockIdx.x * AHR_COLS;
    const int j = j0 + tid;                      // this thread's constraint
    const bool owner = tid < AHR_COLS;           // M is a multiple of 128

    // The first pass's loads, all issued before any is waited for: the F
    // slab, then what h selects.
    ahr_stage<NTH>(F, 0, t, M, j0, fs);
    cp_async_commit();
    sharded::Fold hf{};
    sharded::Pre hx{};
    if constexpr (HEAD) {
        // The fold and the step before K5 in every warp, its operands
        // loaded at once while the F slab is on its way (block 0's thread
        // 0 also loads status and iterations): every warp gets the same
        // h's local column and owner flag in registers, with no barrier.
        int status = 0, iters = 0;
        if (blockIdx.x == 0 && tid == 0) {
            status = *hd.s.status;
            iters = *hd.s.iterations;
        }
        const bool bland = *hd.s.bland != 0;
        hf = sharded::fold_warp(hd.V, hd.I, hd.P, hd.kv);
        hx = sharded::pre(status, iters, bland, hf, hd.pol.max_iter,
                          hd.pol.eps, hd.pol.offset, hd.pol.R_loc);
    }
    const int h = HEAD ? hx.hl : min(*h_ptr, R - 1);
    for (int s = tid; s < min(AHR_ROWS, t); s += NTH)
        ch[s] = C[(size_t)s * R + h];
    float th = 0.0f;
    double bj = 0.0;
    if (owner) {
        th = Tt[(size_t)j * R + h];
        if (RATIO) bj = b[j];
    }
    if (HEAD && blockIdx.x == 0 && tid == 0) {
        // Block 0 stores the scalars once its loads are out. No block of
        // K5 reads a field the head writes, so the blocks need no ticket.
        sharded::store(hd.s, hf);
        sharded::store(hd.s, hx);
    }
    if (!RATIO && (HEAD ? !hx.own : (own != nullptr && *own == 0))) {
        // another rank's column: every warp of the block agrees
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

// ---------------------------------------------------------------------------
// K5: the live entering column alone.
//
// Replaces ah_pass (simplex_tpu/kernels/blocked.py:1300, pallas_call at
// :1361; body _ah_kernel :1036). The sharded loop runs it on each rank's
// slice of the tableau; its ratio test runs on the column after the
// cross-rank sum, so K1's fused form does not apply there.
//   a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] * F[s, j]
// with h a column of this slice (the caller clamps it into range).
// Bound on the card: bytes. It reads t live F rows, t values of C and one
// strided element of Tt per constraint and writes the column (computed:
// 1.2 MB at t = 37, M = 8192, 0.37 us at HBM's rate), but what it can
// reach is latency: a launch, h, then Tt[:, h]. The kernel it replaced
// (one thread a constraint in M / 256 blocks, C[s, h] staged only after h
// was read, each thread's F loads one behind the other behind its FFMA
// chain) took 2.7 us at t = 37 on NVIDIA H100 80GB HBM3, 700.00 W
// (PERF.md). Design: K1's kernel without its ratio test
// (ah_ratio_fused<false>): 64 constraints a block, the block's F slab
// issued at once as cp.async before h is read, then C[s, h] and Tt[j, h],
// the same FFMA chain from shared memory; no b, no fold, no ticket, no
// workspace. K5's column is K1's bit for bit by construction. The TPU
// kernel skipped the dead F segments through its index maps; here t is the
// loop bound.
// The head (HEAD, the sharded loop's launch for every pivot of a window
// but the first; csrc/sharded_step.cu): every warp loads the candidates
// every rank gathered after the pivot before (V, I; lane q rank q) with
// bland, all at once, right after the block's F slab went out (it does
// not depend on h); folds them by shuffles (sharded_step.cuh
// sharded::fold_warp) and runs the step before K5 (sharded::pre) in
// registers, so h's local column and the owner flag need no shared memory
// and no barrier before C[s, h] and Tt[j, h] are loaded; every warp folds
// to the same result, so a block on another rank's column returns as a
// whole. Block 0's thread 0 alone loads status and iterations and, once
// its loads are out, stores the scalars: the folded candidates, active,
// h, minc, optimal, wh, own and hl. The column is the headless K5's bit
// for bit. At one rank, t = 37, the head costs 0.53 us over the headless
// K5, against 0.61 for the form before (each block's thread 0 folding
// into shared memory behind a barrier), on NVIDIA H100 80GB HBM3, 700.00
// W: what is left is the fold's trip to L2 before h's loads can go out.
// The forms tried are tools/seq_variants.cu's (PERF.md).

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
// On a slice of the sharded loop (csrc/sharded_step.cu) the columns are
// global columns offset .. offset + R - 1: h and l are global, so the devex
// stage compares local columns with h - offset and l - offset, which hold
// only on the rank that owns the variable, and w_h, the weight at h, comes
// from the candidate fold through wh_ptr, since another rank may own h.
// With offset 0 and no wh_ptr it is the single-card kernel.
// TAIL runs the single-card loop's step after K2 (step.cuh step::post,
// with the next pivot's step before K1 under pol.then_pre) on ``s`` in the
// last block, once its thread 0 has written the candidates, base[k] and
// w[h]; without it ``s`` and ``pol`` are unread. The step before K1
// rewrites h, which every R block reads at its start and the last block's
// thread 0 reads for base[k]: the rewrite waits for the last ticket and
// for that store, and h_ptr is not __restrict__, since the tail writes its
// element through s.h.
// PACK (the sharded loop's K2, after its tail) then writes the slice's
// candidates into the all_gather send buffers, as csrc/sharded_step.cu's
// sharded_pack does from the stored candidates: send_v = [v_d, v_b] f64,
// with w[h_d], w[h_b] (1 with no eligible column) and key = v_d^2 / w[h_d]
// (-inf with none) under devex; send_i the global indices (offset + h,
// BIG_INDEX kept). The last block's thread 0 loads the two weights past L1
// after its own store of w[h]. Other R blocks' threads wrote the rest of
// w; each block's barrier and its thread 0's fence before the ticket
// release those writes (PTX fences are cumulative). Without PACK the send
// pointers are unread and the kernel is the single-card one.

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

template <bool TAIL, bool PACK = false>
__global__ void __launch_bounds__(THREADS) colk_costs_fused(
        const float *__restrict__ Tt, float *__restrict__ C,
        float *__restrict__ F, double *__restrict__ costs,
        const int *__restrict__ k_ptr, int t,
        const double *__restrict__ u_ptr,
        const unsigned char *__restrict__ do_ptr, int r, double eps, int M,
        int R, int n_rblocks, const float *__restrict__ ah,
        double *__restrict__ b, int *__restrict__ base,
        const int *h_ptr, const float *__restrict__ p_ptr,
        const double *__restrict__ bk_ptr, float *__restrict__ w,
        int offset, const float *__restrict__ wh_ptr,
        unsigned char *__restrict__ ws_bytes, int *__restrict__ hd_out,
        double *__restrict__ vd_out, int *__restrict__ hb_out,
        double *__restrict__ vb_out, double *__restrict__ send_v,
        int *__restrict__ send_i, Step s, step::Policy pol) {
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
    const int hl = *h_ptr - offset;              // h's local column
    const bool own_h = hl >= 0 && hl < R;

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
    const int lvar = base[k] - offset;           // read before any write
    const float wh = w == nullptr ? 0.0f
                     : wh_ptr != nullptr ? *wh_ptr : w[hc];

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
                if (j == hl) {
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

    // The last block: every R block has read h, base[k] and w[h] and
    // written its partial. Fold the partials (read past L1) in the same
    // order.
    __threadfence();
    // The tail's other operands, loaded while the partials fold: no block
    // of K2 writes them.
    step::PostIn post{};
    if (TAIL && tid == 0) post = step::post_load(s);
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
        const step::Candidates c{none ? 0 : idx, none ? CUDART_INF : val,
                                 bidx,
                                 bidx == BIG_INDEX ? CUDART_INF : bval};
        *hd_out = c.h_d;
        *vd_out = c.v_d;
        *hb_out = c.h_b;
        *vb_out = c.v_b;
        if (apply) {
            base[k] = *h_ptr;
            if (w != nullptr && own_h) w[hl] = __ldcg(ws.w_h);
        }
        *ws.counter = 0;                         // ready for the next call
        // The step after K2 on the do flag and the candidates in registers;
        // its step before K1 rewrites h, read above for the last time.
        if (TAIL) step::post(s, post, apply, c, pol);
        if (PACK) {
            // The slice's candidates into the send buffers, from registers.
            send_v[0] = c.v_d;
            send_v[1] = c.v_b;
            if (w != nullptr) {
                const bool has = c.h_b < BIG_INDEX;
                const double wd = (double)__ldcg(w + min(c.h_d, R - 1));
                send_v[2] = wd;
                send_v[3] = has ? (double)__ldcg(w + min(c.h_b, R - 1)) : 1.0;
                send_v[4] = has ? __ddiv_rn(__dmul_rn(c.v_d, c.v_d), wd)
                                : -CUDART_INF;
            }
            send_i[0] = c.h_d >= BIG_INDEX ? BIG_INDEX : offset + c.h_d;
            send_i[1] = c.h_b >= BIG_INDEX ? BIG_INDEX : offset + c.h_b;
        }
    }
}

// ---------------------------------------------------------------------------
// K3: window apply Tt -= F^T C in place, fused with the reprice
// mv = coeffs^T Tt_new.
//
// Replaces apply_reprice_pass (simplex_tpu/kernels/blocked.py:832,
// pallas_call at :887; body _apply_reprice_kernel :744-826).
// Bound on the card: f32 arithmetic. 2 L M R flops (computed: 51.5 GFLOP at
// the flagship M = 8192, R = 24576, L = 128; 0.769 ms at 67 TFLOP/s) and
// 2 M R f64 ones for the fold (0.012 ms) against 8 M R bytes of tableau
// read and written (1.6 GB, 0.481 ms): the CUDA cores bound it. The first
// kernel (apply_tile.cuh's 128 x 128 tile, one block a tile, its reprice
// fold behind one more barrier and 16 KB more of shared memory) took
// 1.66 ms there on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md). This kernel:
// 1.21-1.23 ms, 0.5-1.5% over K4 in the same run and 63% of the bound;
// 1.2072 ms against the old tile's 1.6509-1.6522 in one run
// (tools/k1k3_variants.cu). IEEE f32 FFMA, no TF32 (the TPU ran HIGHEST).
// Design: K4's window_apply (below), one template with it, plus the f64
// fold at each tile's write-back. The thread keeps the fresh values Tt_new
// of its 8 rows x 8 columns in registers and, per column, sums coeffs[r] *
// Tt_new[r, col] over its 8 rows in f64 (__fma_rn, rows in order from 0.0);
// it leaves each sum in its own elements of the tile's staging buffer Ts,
// which its store has just read and no other thread reads, so no barrier
// comes before; after one barrier 128 threads add the 16 row groups in
// order and write one partial row per M tile, and reprice_finish sums the
// partials in M order. The groups, the chains and both orders are those of
// apply_tile.cuh's reprice_fold, so mv is the old tile's bit for bit, and
// K11 run on K3's output gives K3's mv. Ts holds the sums until the next
// tile's copy into it, which waits behind the next stage's barrier, so
// the shared memory stays K4's 96 KB and two blocks share an SM. The TPU
// kernel took a traced flag to skip the reprice off cadence; here the loop
// decides the cadence on the host, where it syncs once per window anyway,
// and launches K4 instead.

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
// 0.0f, then one __fsub_rn from Tt, the rounding of apply_tile.cuh; K3 is
// the same template with its fold, so K3 and K4 leave the same Tt bit for
// bit. No split-K, no tensor cores.
// F is streamed with C rather than kept resident per M tile: a resident
// slab (L x 512 bytes) would cap L in 227 KB of shared memory and leave
// one block per SM, and its re-reads come from L2 (F is 4 MB at the
// flagship shape).

constexpr int WIN_STAGES = 4;
constexpr int WIN_STAGE_FLOATS = 2 * AK * AT;    // F rows, then C rows
constexpr size_t WIN_SMEM =
    (size_t)(AT * AT + WIN_STAGES * WIN_STAGE_FLOATS) * sizeof(float);

// K3's fold at a tile's write-back (window_apply<true>). acc holds the
// thread's Tt_new[r0 + a, c0 + 32 * (c >> 2) + (c & 3)] as acc[a][c], cf
// points at coeffs[i0 + r0], part_row at the tile's partial row. Each
// thread sums its 8 rows per column in f64 and leaves the sum of (row group
// r0 / 8, column col) in rows r0, r0 + 1 of its own column group of Ts, as
// the double at red_at(r0, col); thread col < AT then adds the 16 groups
// in order. Zeroes acc for the next tile. The whole block calls it.
__device__ __forceinline__ double *red_at(float *Ts, int r0, int col) {
    const int q = col & 3;
    return reinterpret_cast<double *>(
        &Ts[(r0 + (q >> 1)) * AT + (col & ~3) + 2 * (q & 1)]);
}

__device__ __forceinline__ void window_fold(float (&acc)[8][8],
                                            const double *__restrict__ cf,
                                            float *Ts, int r0, int c0,
                                            double *__restrict__ part_row) {
    double w[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) w[a] = cf[a];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        double s = 0.0;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            s = __fma_rn(w[a], (double)acc[a][c], s);
            acc[a][c] = 0.0f;
        }
        *red_at(Ts, r0, c0 + (c >> 2) * 32 + (c & 3)) = s;
    }
    __syncthreads();
    const int col = threadIdx.x;
    if (col < AT) {
        double s = 0.0;
        for (int g = 0; g < AT / 8; ++g)
            s = __dadd_rn(s, *red_at(Ts, 8 * g, col));
        part_row[col] = s;
    }
}

// K4 (REPRICE false) and K3 (true; coeffs (M,) and part (M / AT, R) f64).
template <bool REPRICE>
__global__ void __launch_bounds__(APPLY_THREADS, 2) window_apply(
        float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, int M, int R, int L,
        const double *__restrict__ coeffs, double *__restrict__ part) {
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
            // The previous tile's store (and K3's fold) read Ts before the
            // barrier.
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
                    if constexpr (REPRICE) {             // Tt_new, folded
                        acc[a][half * 4 + 0] = v.x;
                        acc[a][half * 4 + 1] = v.y;
                        acc[a][half * 4 + 2] = v.z;
                        acc[a][half * 4 + 3] = v.w;
                    }
                }
                if constexpr (!REPRICE) {
#pragma unroll
                    for (int c = 0; c < 8; ++c) acc[a][c] = 0.0f;
                }
            }
            if constexpr (REPRICE)
                window_fold(acc, coeffs + i0 + r0, Ts, r0, c0,
                            part + (i0 / AT) * (size_t)R + j0);
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
// 2 M R f64 operations (0.012 ms at 34 TFLOP/s). Design: apply_tile.cuh's
// 128 x 128 tiles without the apply -- each thread loads its 8 x 8
// elements into registers and runs reprice_fold (reprice_tile), then
// reprice_finish sums the per-tile partials in M order. K3's fold sums the
// same 8-row groups in the same orders, so K11 run on K3's output gives
// K3's mv bit for bit (and with zero etas, K3's mv on the same Tt).

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

namespace {

// window_apply<REPRICE> on its persistent grid: two blocks an SM, at most
// one a tile.
template <bool REPRICE>
int launch_window(float *Tt, const float *F, const float *C, int M, int R,
                  int L, const double *coeffs, double *part,
                  cudaStream_t st) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(window_apply<REPRICE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)WIN_SMEM);
    RETURN_IF_ERROR();
    const int n_tiles = (M / AT) * (R / AT);
    const int nb = n_tiles < 2 * sms ? n_tiles : 2 * sms;
    window_apply<REPRICE><<<nb, APPLY_THREADS, WIN_SMEM, st>>>(
        Tt, F, C, M, R, L, coeffs, part);
    RETURN_IF_ERROR();
    return 0;
}

}  // namespace

extern "C" {

const char *kernel_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ``step`` null: K1 alone; else K1 with the step between K1 and K2 as its
// tail, on those scalars.
int ah_ratio_launch(const float *Tt, const float *F, const float *C,
                    const double *b, const int *h, int t, int M, int R,
                    float eps, float *ah, unsigned char *ws,
                    long long ws_bytes, int *k_out, float *p_out,
                    double *bk_out, int *unb_out, const Step *step,
                    void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nb = (M + AHR_COLS - 1) / AHR_COLS;
    if (ws_bytes < (long long)ahr_ws_bytes(nb))
        return (int)cudaErrorInvalidValue;       // workspace too small
    if (step == nullptr)
        ah_ratio_fused<true><<<nb, THREADS, 0, st>>>(
            Tt, F, C, b, h, nullptr, t, M, R, eps, nb, ah, ws, k_out, p_out,
            bk_out, unb_out, Step{}, K5Head{});
    else
        ah_ratio_fused<true, THREADS, true><<<nb, THREADS, 0, st>>>(
            Tt, F, C, b, h, nullptr, t, M, R, eps, nb, ah, ws, k_out, p_out,
            bk_out, unb_out, *step, K5Head{});
    RETURN_IF_ERROR();
    return 0;
}

// K5 with the sharded loop's head (the fold of V and I, then the step
// before K5 on the scalars ``s`` for the slice of Tt's R columns from
// global column ``offset``): one block of THREADS threads for every 64
// constraints, at every t.
int ah_head_launch(const float *Tt, const float *F, const float *C, int t,
                   int M, int R, float *ah, const ShardStep *s,
                   const double *V, const int *I, int P, int kv,
                   long long max_iter, double eps, int offset,
                   void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nb = (M + AHR_COLS - 1) / AHR_COLS;
    const K5Head hd{*s, V, I, P, kv, {max_iter, eps, offset, R}};
    ah_ratio_fused<false, THREADS, false, true><<<nb, THREADS, 0, st>>>(
        Tt, F, C, nullptr, nullptr, nullptr, t, M, R, 0.0f, nb, ah, nullptr,
        nullptr, nullptr, nullptr, nullptr, Step{}, hd);
    RETURN_IF_ERROR();
    return 0;
}

int ah_launch(const float *Tt, const float *F, const float *C, const int *h,
              const unsigned char *own, int t, int M, int R, float *ah,
              void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nb = (M + AHR_COLS - 1) / AHR_COLS;
    if (t == 0)        // a copy of Tt[:, h]: one thread a constraint
        ah_ratio_fused<false, AHR_COLS><<<nb, AHR_COLS, 0, st>>>(
            Tt, F, C, nullptr, h, own, t, M, R, 0.0f, nb, ah, nullptr,
            nullptr, nullptr, nullptr, nullptr, Step{}, K5Head{});
    else
        ah_ratio_fused<false, THREADS><<<nb, THREADS, 0, st>>>(
            Tt, F, C, nullptr, h, own, t, M, R, 0.0f, nb, ah, nullptr,
            nullptr, nullptr, nullptr, nullptr, Step{}, K5Head{});
    RETURN_IF_ERROR();
    return 0;
}

// ``step`` null: K2 alone; else K2 with the step after K2 as its tail, on
// those scalars, under max_iter, eps, the Bland mode and threshold, and
// then_pre; with ``send_v`` and ``send_i`` also the pack after it (the
// sharded loop's, which needs the tail).
int colk_costs_launch(const float *Tt, float *C, float *F, double *costs,
                      const int *k, int t, const double *u,
                      const unsigned char *do_flag, int r, double eps, int M,
                      int R, const float *ah, double *b, int *base,
                      const int *h, const float *p, const double *bk,
                      float *w, int offset, const float *wh,
                      unsigned char *ws, long long ws_bytes,
                      int *hd_out, double *vd_out, int *hb_out,
                      double *vb_out, double *send_v, int *send_i,
                      const Step *step, long long max_iter, int bland_mode,
                      int threshold, int then_pre, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_rblocks = (R + COLK_COLS - 1) / COLK_COLS;
    const int n_mblocks = (M + THREADS - 1) / THREADS;
    if (ws_bytes < (long long)colk_ws_bytes(n_rblocks))
        return (int)cudaErrorInvalidValue;       // workspace too small
    const bool pack = send_v != nullptr;
    if (pack != (send_i != nullptr) || (pack && step == nullptr))
        return (int)cudaErrorInvalidValue;       // a pack needs both, a tail
    const step::Policy pol{max_iter, eps, bland_mode, threshold, then_pre};
    const dim3 grid(n_rblocks + n_mblocks);
    if (step == nullptr)
        colk_costs_fused<false><<<grid, THREADS, 0, st>>>(
            Tt, C, F, costs, k, t, u, do_flag, r, eps, M, R, n_rblocks, ah,
            b, base, h, p, bk, w, offset, wh, ws, hd_out, vd_out, hb_out,
            vb_out, nullptr, nullptr, Step{}, pol);
    else if (!pack)
        colk_costs_fused<true><<<grid, THREADS, 0, st>>>(
            Tt, C, F, costs, k, t, u, do_flag, r, eps, M, R, n_rblocks, ah,
            b, base, h, p, bk, w, offset, wh, ws, hd_out, vd_out, hb_out,
            vb_out, nullptr, nullptr, *step, pol);
    else
        colk_costs_fused<true, true><<<grid, THREADS, 0, st>>>(
            Tt, C, F, costs, k, t, u, do_flag, r, eps, M, R, n_rblocks, ah,
            b, base, h, p, bk, w, offset, wh, ws, hd_out, vd_out, hb_out,
            vb_out, send_v, send_i, *step, pol);
    RETURN_IF_ERROR();
    return 0;
}

int apply_reprice_launch(float *Tt, const float *F, const float *C, int M,
                         int R, int L, const double *coeffs, double *part,
                         double *mv, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = launch_window<true>(Tt, F, C, M, R, L, coeffs, part, st);
    if (err != 0) return err;
    reprice_finish<<<(R + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        part, M / AT, R, mv);
    RETURN_IF_ERROR();
    return 0;
}

int apply_window_launch(float *Tt, const float *F, const float *C, int M,
                        int R, int L, void *stream) {
    return launch_window<false>(Tt, F, C, M, R, L, nullptr, nullptr,
                                static_cast<cudaStream_t>(stream));
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
