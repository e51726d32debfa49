// The plain deferred block-pivot loop's per-pivot kernels
// (solver.solve_loop_blocked as one CUDA graph a window of L pivots).
//
// Replaces no Pallas kernel: in the JAX package the plain blocked loop is a
// lax.while_loop around a lax.fori_loop whose pivot is XLA code
// (simplex_tpu/solver.py:528-582 inner, with entering :491-505 and
// devex_update :507-526); its window apply is an XLA dot (apply_window_T)
// and its re-pricing an XLA matvec, which the port leaves to cuBLAS
// (Tt.addmm_) and to tableau.tt_matvec. The port's eager loop ran a pivot
// as about 30 torch calls; here a pivot is two kernels, both on full
// grids with the last block folding the blocks' partials by an arrival
// ticket (the structure of K1 and K2, csrc/blocked.cu ah_ratio_fused and
// colk_costs_fused), generic over the tableau's dtype T and the vectors'
// V: (f64, f64), (f32, f64) and (f32, f32).
//
// * eta_ratio: the live entering column a_h = Tt[:, h] - sum_{s<t} C[s, h]
//   F[s, :] into the loop's fixed ``ah``, one thread a row; the min-ratio
//   test (the first index of the smallest b / a_h over a_h >= eps, the
//   quotient in V, a NaN first as torch.argmin orders it); the last block
//   folds the blocks' candidates and runs the step between (k, unb, do,
//   p, bk, u; seq_step.cuh seq::between).
// * eta_colk: the live leaving row colk = Tt[k] - sum_{s<t} F[s, k] C[s, :]
//   into C[t] (zeros on a skipped pivot), the costs (costs -= u colk) and,
//   under devex, the weights (alpha = colk / p; max(w, alpha^2 w_h); the
//   leaving variable max(w_h / p^2, 1); capped at 1e12, NaN to 1), one
//   thread a column; then the next pivot's candidates over the live
//   columns: the Dantzig argmin, or the devex argmax of cost^2 / w, and
//   Bland's lowest eligible index. Blocks past the columns write F[t] (a_h
//   / p, 1 - 1/p at k) and b (b -= bk a_h / p, b[k] = bk / p), one thread a
//   row. The last block folds the candidates, writes base[k] = h and w[h],
//   and runs the step after (z, status, stall, Bland, iterations) with,
//   but for the window's last pivot, the next pivot's step before
//   (seq::post).
//
// The sharded plain blocked loop (parallel.sharded.solve_loop_blocked_
// sharded, one CUDA graph a window with its NCCL collectives; the JAX loop
// under shard_map, simplex_tpu/parallel/sharded.py:386-510, whose pivot is
// XLA-fused glue too) runs the same pivot on each rank's slice of the
// columns, as three kernels on the same plan (kernels/eta.py eta_plan for
// the slice's R_loc), after the all_gathers of the candidates every rank
// packed:
//
// * eta_fold_column (eta_ratio's rows a block): each block sends for its F
//   slab, then one warp folds the gathered candidates (slice_fold's order)
//   and thread 0 runs the step before (seq::pre, h global), block 0
//   storing the scalars and the weight at h; under devex, where the
//   largest of every rank's weights passed 1e8, every block resets its
//   share of the slice's weights to 1 (the re-anchor the pivot before
//   left to this fold); then the rank that owns h writes the live column
//   in eta_ratio's order and precision, every other rank zeros, which an
//   all_reduce sums.
// * eta_ratio_summed: the ratio test and the step between on the summed
//   column as one thread-block cluster (ratio_cluster.cuh, the sequential
//   sharded loop's), launched behind the fold as a programmatic dependent
//   launch.
// * eta_colk_slice: eta_colk on the slice (SLICE): the weight at h from
//   the fold (h may lie on another rank), the leaving variable by its
//   global column, base[k] = h global; the last block packs the slice's
//   candidates into the send buffers as global indices, with, under
//   devex, the new weights at them, the candidate on weights of 1 and the
//   slice's largest weight, in place of the re-anchor and the next step
//   before, which need every rank's. Its tail is latency: after its sums
//   a block folds, stores its partial and takes the arrival ticket, and
//   the last block folds the partials and packs. The weights at the
//   candidates ride with them through the block's and the partials' folds
//   (RowCands with CARRY; 16 bytes more a block of workspace), so no load
//   follows the last fold; and the ticket's acq_rel atomic alone orders
//   each partial before it, since the last block reads nothing else a
//   column block wrote: eta_colk's __threadfence before the ticket and
//   after it go. On NVIDIA H100 80GB HBM3, 700.00 W, at f64 2048^2, t =
//   0 / 64 / 127, one slice (tools/eta_variants.cu colk, CUDA graphs of
//   50 calls in turns): 5.91 / 7.16 / 8.17 us against 6.65 / 7.81 / 8.81
//   for the form that read the weights back behind both fences; the
//   carried weights alone 6.67 / 7.92 / 8.95 (their wider partials cost
//   what the load saved at 96 column blocks), the fences alone the rest.
//
// The devex re-anchor runs every pivot: when the largest new weight
// passes 1e8 every weight becomes 1, and the next pivot's devex score
// reads the weights after it. So each block folds two devex candidates,
// one on its new weights and one on weights of 1 (cost^2 / 1 = cost^2
// exactly), and the largest new weight; the last block knows the largest
// of all, keeps one of the two and, on a re-anchor, writes the ones.
//
// Two elements are read by blocks other than their writer: base[k] (the
// leaving variable) and w[h]. Every column block reads them at its start
// and only the last block writes them, after every column block has
// arrived (w[h]'s new value waits in the workspace meanwhile); h, which
// the step before rewrites, likewise.
//
// The eta corrections sum in f64 in one fixed order: s = 0 .. t-1 from 0,
// each product (exact for an f32 tableau's operands) and each sum rounded
// apart with the _rn intrinsics (nvcc contracts none of them), then one
// f64 subtraction from Tt and one rounding to T; kernels/eta.py's plain
// versions run the same order (eta_live), so kernel and plain version
// agree bit for bit. On an f32 tableau that keeps the live column and row
// within an f32 rounding or two of exact, as the mixed walks need. Every
// other product, quotient and difference is rounded apart
// too, eps is compared in the operand's type (as torch compares a tensor
// with a Python float), an f32 value widens exactly to f64 before it meets
// an f64 one, and every fold is a total order, so the results do not
// depend on the blocks' schedule.
//
// Bound on the card: bytes. A pivot reads the t live rows of F and of C
// (8 t (M + R) bytes in f64: 4 MB at t = 64 on the 2048^2 tableau, M =
// 2,048, R = 6,144; 16.8 MB on the 8192^2 one; bench.pivot_work's K1 and
// K2 entries count every input and output), and the window's factors stay
// in the 50 MB L2 up to the 8192^2 f64 tableau. What a pivot can reach beside
// that is latency: each pass is one dependent load (h or k, then the
// column or the row) and a chain of t sums a thread, then a ticket and
// the last block's fold. The first form (one thread a row, 64 a block, and
// one a column, 128 a block, each thread loading its t slab elements from
// global memory behind h or k, eight ahead of its sums) took 6.45 and 9.07
// us at f64 2048^2, t = 64, on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md):
// 32 blocks for 132 SMs, and the slab's loads sent late.
//
// Design (K1's, csrc/blocked.cu ah_ratio_fused): the slab F[:t, the
// block's rows] (C[:t, the block's columns]) does not depend on h (k), so
// each block sends for its share of it first, as cp.async copies into shared
// memory, and only then reads h (k), C[:t, h] (F[:t, k]) and Tt[:, h]
// (Tt[k]); each owner thread then runs its sum from shared memory in the
// same order as before. Where every slab row starts on a 16-byte boundary
// (the main path's shapes) each thread copies one fixed 16-byte chunk of a
// row down the rows, two pointer steps a copy; rows of F and C start at s
// M and s R elements, so for odd shapes (and f32 rows in general) they are
// not aligned, and each lands in shared memory at its own misalignment
// within a 16-byte chunk, whole chunks copied 16 bytes at a time and the
// partial chunks at its head and tail element by element (Slab; the
// fixed path took eta_ratio at 8192^2, t = 127, to 9.1 us from 17.2 by the
// general path alone, tools/eta_variants.cu). The slab goes in rounds of
// ``stage`` rows through a ring of two buffers, the round after next sent
// for as soon as a round is read, so a window longer than a stage fits
// (the dynamic shared memory at most 227 KB a block). The rows (columns) a
// block and the rows a round come from the caller (kernels/eta.py
// eta_plan: the grid sized to the card's 132 SMs; 256 columns a block of
// 256 threads where that grid takes one wave; past one wave 16 rows a
// round, so that several blocks share an SM), as the workspace's partials
// are counted by them. Blocks fold as before, by the arrival ticket, in a
// total order.
//
// eta_ratio and eta_colk (eta_colk_slice and, as a cluster,
// eta_ratio_summed too) launch as programmatic dependent launches: each
// starts while the kernel before it runs and sends for, before
// griddepcontrol.wait, only what no kernel since the pivot before wrote --
// eta_ratio F's rows s < t - 1 (the pivot before wrote F[t - 1], which each
// owner loads after the wait), eta_colk C's rows s < t and its columns'
// costs and weights, eta_ratio_summed b -- and each lets the next launch as
// soon as it has waited, so at most two of them run at once
// (eta_fold_column, which a copy or a collective precedes, lets
// eta_ratio_summed launch once its fold is done). The bulk copy engine
// (cp.async.bulk, one copy a row completing on an mbarrier) was tried first
// and dropped: its copies take their operands in uniform registers, so a
// warp sends them one after the other, and an unrolled loop sending them
// ran past its bound on the card (PERF.md).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "cluster.cuh"
#include "ratio_cluster.cuh"
#include "seq_step.cuh"

namespace {

using seq::BIG_INDEX;
using seq::block_fold;
using seq::div_rn;
using seq::inf;
using seq::mul_rn;
using seq::Ratio;
using seq::sub_rn;

constexpr int RATIO_THREADS = 128; // eta_ratio's block: a row a thread
constexpr int COLK_THREADS = 128;  // eta_colk's: a column (or row) a thread,
                                   // 256 for 256 columns
constexpr int BLOCK_SMEM = 232448; // a block's shared memory on sm_90
constexpr int SMEM_RESERVE = 1024; // of it, room for the static arrays

// The (tableau, vector) dtype pairs (kernels/seq.py PAIRS).
enum Pair { PAIR_F64 = 0, PAIR_MIXED = 1, PAIR_F32 = 2 };

// The host's array of pointers (kernels/seq.py _SeqPtrs) as the struct.
template <typename T, typename V>
SeqStep<T, V> step_of(const void *ptrs) {
    SeqStep<T, V> s;
    memcpy(&s, ptrs, sizeof s);
    return s;
}

// NaN-propagating max/min, as torch.maximum / torch.minimum behave.
template <typename V>
__device__ __forceinline__ V max_nan(V a, V b) {
    return (a != a || b != b) ? (V)CUDART_NAN : (a > b ? a : b);
}
template <typename V>
__device__ __forceinline__ V min_nan(V a, V b) {
    return (a != a || b != b) ? (V)CUDART_NAN : (a < b ? a : b);
}

// The arrival ticket: one atomic add, acquire and release at the device's
// scope (csrc/blocked.cu's).
__device__ __forceinline__ unsigned ticket(unsigned *counter) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    return old;
}

// The slab's layout in shared memory (kernels/eta.py eta_stage plans
// within it): a row of ``width`` elements of ``item`` bytes takes width + 16 /
// item slots (one chunk more, for its misalignment); a round holds
// ``stage`` rows (the caller's: kernels/eta.py eta_plan); the block holds
// min(t, 2 stage) rows, then the t coefficients C[:t, h] (or F[:t, k])
// rounded up to 16 bytes. At t = 0 it holds nothing.
__host__ __device__ constexpr int slab_width(int width, int item) {
    return width + 16 / item;
}
__host__ __device__ constexpr long long round16(long long n) {
    return (n + 15) / 16 * 16;
}
__host__ __device__ constexpr long long smem_bytes(int width, int stage,
                                                   int t, int item) {
    const int rows = t < 2 * stage ? t : 2 * stage;
    return (long long)rows * slab_width(width, item) * item +
           round16((long long)t * item);
}

// Asynchronous global -> shared copies (sm_80+): 16 bytes past L1, or one
// element of N bytes (4 or 8). Sent without a compiler memory barrier:
// what reads the shared memory they fill waits for them (cp_async_wait),
// and a buffer is refilled only after a block barrier.
__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}
template <int N>
__device__ __forceinline__ void cp_async_elem(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One block's slab a[:n, c0 .. c0 + ncol) (row stride ld) in shared
// memory, in rounds of ``stage`` rows through a ring of two buffers: round
// r in buffer r mod 2, one cp.async group a round. A row's element e lands
// at slot mis + e, mis being the row's first element's place (in
// elements) within its 16-byte chunk. Where every row starts on a 16-byte
// boundary (ld and the block's first column so placed: the main path's
// shapes) each thread copies one fixed chunk of a row and steps down the
// rows, no index arithmetic a copy beyond two pointer steps; otherwise
// each chunk wholly inside a row goes as one 16-byte copy and the partial
// chunks at the row's head and tail element by element. FIXED false takes
// the general path for every row (tools/eta_variants.cu times the two).
template <typename T, int NT, bool FIXED>
struct Slab {
    static constexpr int VEC = 16 / sizeof(T);
    const T *__restrict__ a;
    size_t ld;
    int c0, ncol, n, stage, W;
    T *buf;

    __device__ bool aligned() const {
        return ((reinterpret_cast<uintptr_t>(a + c0) |
                 (ld * sizeof(T))) & 15) == 0;
    }

    // Round r's rows into buffer r mod 2, committed as one group (an empty
    // one past the last round). The whole block calls it.
    __device__ void load(int r) const {
        const int s0 = r * stage, rows = min(stage, n - s0);
        T *b = buf + (size_t)(r & 1) * stage * W;
        const T *g = a + (size_t)s0 * ld + c0;
        if (FIXED && aligned()) {
            const int cpr = ncol / VEC;          // chunks a row, all whole
            const int per = NT / cpr;            // rows a pass
            const int q0 = (int)threadIdx.x / cpr;
            const int c = (int)threadIdx.x - q0 * cpr;
            if (q0 < per) {
                const T *src = g + (size_t)q0 * ld + c * VEC;
                T *dst = b + q0 * W + c * VEC;
                const size_t sstep = (size_t)per * ld;
                const int dstep = per * W;
#pragma unroll 4
                for (int q = q0; q < rows; q += per) {
                    cp_async16(dst, src);
                    src += sstep;
                    dst += dstep;
                }
            }
        } else {
            const int cpr = W / VEC;             // chunks a row, at most
            for (int u = threadIdx.x; u < rows * cpr; u += NT) {
                const int q = u / cpr, c = u - q * cpr;
                const T *row = g + (size_t)q * ld;
                const int mis = (int)((reinterpret_cast<uintptr_t>(row) /
                                       sizeof(T)) & (VEC - 1));
                const int lo = c * VEC - mis;    // row[lo .. lo + VEC)
                T *dst = b + (size_t)q * W;
                if (lo >= 0 && lo + VEC <= ncol) {
                    cp_async16(dst + c * VEC, row + lo);
                } else {
                    for (int e = max(lo, 0); e < min(lo + VEC, ncol); ++e)
                        cp_async_elem<sizeof(T)>(dst + mis + e, row + e);
                }
            }
        }
        cp_async_commit();
    }

    // Rounds 0 and 1 (the caller starts them before it reads the pivot's
    // index).
    __device__ void first() const {
        load(0);
        load(1);
    }

    // The owner threads' (tid < ncol) sum_{s<n} cf[s] a[s, c0 + tid], s in
    // order from 0.0, each product and sum rounded apart in f64 (the
    // others 0): round by round as each lands, the round after next sent for
    // into a buffer as soon as it is read. ``cf`` (n values or more) is
    // staged by the caller. The whole block calls it.
    __device__ double sum(const T *cf) const {
        const int tid = threadIdx.x;
        const int rounds = (n + stage - 1) / stage;
        const size_t el = reinterpret_cast<uintptr_t>(a + c0) / sizeof(T);
        double acc = 0.0;
        for (int r = 0; r < rounds; ++r) {
            cp_async_wait<1>();                  // round r (r + 1 may fly)
            __syncthreads();                     // every thread's, and cf
            const int s0 = r * stage, m = min(stage, n - s0);
            if (tid < ncol)
                acc = slab_sum(acc, cf + s0,
                               buf + (size_t)(r & 1) * stage * W + tid, m, W,
                               el + (size_t)s0 * ld, ld);
            __syncthreads();                     // the round is read
            load(r + 2);
        }
        return acc;
    }

    // The slab's rows into an owner's sum, s in order: acc + cf[q] x col[q
    // W + mis_q], q < m; ``el`` is the first row's element index of its
    // first column (its misalignment), so mis_q steps by ld mod VEC a row.
    __device__ static double slab_sum(double acc, const T *__restrict__ cf,
                                      const T *__restrict__ col, int m, int W,
                                      size_t el, size_t ld) {
        unsigned mis = (unsigned)(el & (VEC - 1));
        const unsigned step = (unsigned)(ld & (VEC - 1));
#pragma unroll 8
        for (int q = 0; q < m; ++q) {
            acc = __dadd_rn(acc, __dmul_rn((double)cf[q],
                                           (double)col[q * W + mis]));
            mis = (mis + step) & (VEC - 1);
        }
        return acc;
    }
};

// The workspace (bytes; kernels/eta.py eta_workspace_bytes agrees): [0, 4)
// eta_ratio's arrival counter, [4, 8) eta_colk's, [8, 16) the new weight at
// h (a double), then eta_ratio's partials -- f64 q, a, b[nbA], int j,
// any[nbA]: 32 bytes a block -- and eta_colk's -- f64 key, val, key1,
// val1, bval, wmax[nbB], int idx, idx1, bidx[nbB] (60 bytes a block, 64
// with the padding), then f64 wv, bw[nbB] (eta_colk_slice's weights at
// idx and bidx): 80 bytes a block. Each call leaves its counter at 0.
__host__ __device__ constexpr size_t ws_bytes(int nbA, int nbB) {
    return 16 + 32 * (size_t)nbA + 80 * (size_t)nbB;
}

struct WsA {
    unsigned *counter;
    double *q, *a, *b;
    int *j, *any;
    __device__ WsA(unsigned char *ws, int nbA)
        : counter(reinterpret_cast<unsigned *>(ws)),
          q(reinterpret_cast<double *>(ws + 16)), a(q + nbA), b(a + nbA),
          j(reinterpret_cast<int *>(b + nbA)), any(j + nbA) {}
};

struct WsB {
    unsigned *counter;
    double *wh;
    double *key, *val, *key1, *val1, *bval, *wmax;
    int *idx, *idx1, *bidx;
    double *wv, *bw;
    __device__ WsB(unsigned char *ws, int nbA, int nbB)
        : counter(reinterpret_cast<unsigned *>(ws + 4)),
          wh(reinterpret_cast<double *>(ws + 8)),
          key(reinterpret_cast<double *>(ws + 16 + 32 * (size_t)nbA)),
          val(key + nbB), key1(val + nbB), val1(key1 + nbB),
          bval(val1 + nbB), wmax(bval + nbB),
          idx(reinterpret_cast<int *>(wmax + nbB)), idx1(idx + nbB),
          bidx(idx1 + nbB), wv(key + 8 * (size_t)nbB), bw(wv + nbB) {}
};

// ---------------------------------------------------------------------------
// eta_ratio: the live entering column, the ratio test and the step between.

template <typename T, typename V, int NT, bool FIXED>
__global__ void __launch_bounds__(NT) eta_ratio_kernel(
        const T *__restrict__ Tt, const T *__restrict__ C,
        const T *__restrict__ F, const V *__restrict__ b,
        T *__restrict__ ah, int M, int R, int t, double eps, int rows,
        int stage, int nbA, unsigned char *__restrict__ ws_bytes,
        SeqStep<T, V> s) {
    constexpr int NW = NT / 32;
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ Ratio<T, V> warps[NW];
    __shared__ int wany[NW];
    __shared__ bool last;
    const WsA ws(ws_bytes, nbA);
    const int tid = threadIdx.x;
    const int j0 = blockIdx.x * rows;
    const int nrow = min(rows, M - j0);
    const int j = j0 + tid;                      // this thread's row
    const bool row = tid < nrow;
    const int W = slab_width(rows, sizeof(T));
    // The slab holds F's rows s < t - 1; the pivot before wrote F[t - 1],
    // which each owner loads itself once that pivot is waited for.
    const Slab<T, NT, FIXED> slab{F, (size_t)M, j0, nrow, max(t - 1, 0),
                                  stage, W, reinterpret_cast<T *>(dyn)};
    T *cs = slab.buf + (size_t)min(t, 2 * stage) * W;  // C[:t, h]

    // The block's F slab first (it does not depend on h), before the
    // kernel before is waited for; then b, F[t - 1], h and what h
    // selects.
    slab.first();
    grid_wait();
    grid_launch_next();
    const V bj = row ? b[j] : (V)0;
    const T flast = row && t > 0 ? F[(size_t)(t - 1) * M + j] : (T)0;
    const int h = min(*s.h, R - 1);
    for (int q = tid; q < t; q += NT) cs[q] = C[(size_t)q * R + h];
    const T th = row ? Tt[(size_t)j * R + h] : (T)0;
    __syncthreads();                             // cs

    // a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] F[s, j], s in order from 0,
    // in f64.
    double acc = slab.sum(cs);
    if (row && t > 0)
        acc = __dadd_rn(acc, __dmul_rn((double)cs[t - 1], (double)flast));
    T a = (T)0;
    if (row) {
        a = (T)__dsub_rn((double)th, acc);
        ah[j] = a;
    }

    const Ratio<T, V> none{inf<V>(), BIG_INDEX, (T)0, (V)0};
    Ratio<T, V> x = none;
    bool any = false;
    if (row) {
        any = a >= (T)eps;
        x = Ratio<T, V>{any ? div_rn(bj, (V)a) : inf<V>(), j, a, bj};
    }
    block_fold<NW>(x, any, none, warps, wany);
    if (tid == 0) {
        ws.q[blockIdx.x] = (double)x.q;
        ws.a[blockIdx.x] = (double)x.a;
        ws.b[blockIdx.x] = (double)x.b;
        ws.j[blockIdx.x] = x.j;
        ws.any[blockIdx.x] = any;
        last = ticket(ws.counter) == (unsigned)nbA - 1;
    }
    __syncthreads();
    if (!last) return;

    // The last block: every block has written its partial. The step
    // between's operands (the step before wrote them), then the partials
    // folded in the same order, read past L1.
    __threadfence();
    bool active = false, optimal = false;
    V minc = (V)0;
    if (tid == 0) {
        active = *s.active != 0;
        optimal = *s.optimal != 0;
        minc = *s.minc;
    }
    x = none;
    any = false;
    for (int q = tid; q < nbA; q += NT) {
        seq::take_first(x, Ratio<T, V>{(V)__ldcg(ws.q + q), __ldcg(ws.j + q),
                                       (T)__ldcg(ws.a + q),
                                       (V)__ldcg(ws.b + q)});
        any |= __ldcg(ws.any + q) != 0;
    }
    block_fold<NW>(x, any, none, warps, wany);
    if (tid == 0) {
        seq::store(s, seq::between(x, any, active, optimal, minc));
        *ws.counter = 0;                         // ready for the next call
    }
}

// ---------------------------------------------------------------------------
// eta_colk: the live leaving row, C[t], the costs, the devex weights, F[t],
// b and base, the next candidates and the step after.

// A block's candidates: the main one (key the negated cost under Dantzig,
// the devex score under devex; the larger first), the devex one on weights
// of 1, Bland's (the lowest eligible index), and the largest new weight;
// with CARRY (eta_colk_slice) the new weights at the main and the Bland
// candidates ride with them (wv, bw), so the pack needs no load after the
// fold.
template <typename V, bool CARRY>
struct RowCands {
    V key;
    int idx;
    V val;
    V key1;
    int idx1;
    V val1;
    V bval;
    int bidx;
    V wmax;
};
template <typename V>
struct RowCands<V, true> : RowCands<V, false> {
    V wv, bw;
};

// (k, i) before (k2, i2) in torch.argmax's order: NaN first, then the
// larger, ties to the lower index (-key orders as torch.argmin orders the
// key).
template <typename V>
__device__ __forceinline__ bool first_max(V k, int i, V k2, int i2) {
    const bool nan = k != k, nan2 = k2 != k2;
    if (nan != nan2) return nan;
    if (!nan && k != k2) return k > k2;
    return i < i2;
}

template <typename V, bool CARRY>
__device__ __forceinline__ void take_first(RowCands<V, CARRY> &x,
                                           const RowCands<V, CARRY> &o) {
    if (first_max(o.key, o.idx, x.key, x.idx)) {
        x.key = o.key;
        x.idx = o.idx;
        x.val = o.val;
        if constexpr (CARRY) x.wv = o.wv;
    }
    if (first_max(o.key1, o.idx1, x.key1, x.idx1)) {
        x.key1 = o.key1;
        x.idx1 = o.idx1;
        x.val1 = o.val1;
    }
    if (o.bidx < x.bidx) {
        x.bidx = o.bidx;
        x.bval = o.bval;
        if constexpr (CARRY) x.bw = o.bw;
    }
    if (o.wmax > x.wmax || o.wmax != o.wmax)     // NaN first, as torch's
        x.wmax = o.wmax;                         // max propagates it
}

template <typename V, bool CARRY>
__device__ __forceinline__ RowCands<V, CARRY> shfl_xor(
        const RowCands<V, CARRY> &x, int off) {
    constexpr unsigned FULL = seq::FULL;
    RowCands<V, CARRY> o{};
    o.key = __shfl_xor_sync(FULL, x.key, off);
    o.idx = __shfl_xor_sync(FULL, x.idx, off);
    o.val = __shfl_xor_sync(FULL, x.val, off);
    o.key1 = __shfl_xor_sync(FULL, x.key1, off);
    o.idx1 = __shfl_xor_sync(FULL, x.idx1, off);
    o.val1 = __shfl_xor_sync(FULL, x.val1, off);
    o.bval = __shfl_xor_sync(FULL, x.bval, off);
    o.bidx = __shfl_xor_sync(FULL, x.bidx, off);
    o.wmax = __shfl_xor_sync(FULL, x.wmax, off);
    if constexpr (CARRY) {
        o.wv = __shfl_xor_sync(FULL, x.wv, off);
        o.bw = __shfl_xor_sync(FULL, x.bw, off);
    }
    return o;
}

// What the slice's form (SLICE: eta_colk_slice, the sharded plain blocked
// loop's pass on a rank's slice of R = R_loc columns from global column
// ``offset``) takes beside eta_colk's operands: the weight at the global h
// (eta_fold_column's, from the candidates' riders: the column h may lie on
// another rank), and the candidates' send buffers (SLICE_KV and SLICE_KI
// entries; ``send_w`` the slice's largest weight, devex only).
template <typename V>
struct SliceOut {
    int offset;
    const V *wh;
    double *send_v;
    int *send_i;
    double *send_w;
};

// The send buffers' entries under devex (kernels/eta.py pack_slice): values
// [v_d, v_b, w[h_d], w[h_b], key, v_d1, key1] and global indices [h_d, h_b,
// h_d1], the last of each on weights of 1 (the re-anchor's); Dantzig and
// Bland [v_d, v_b] and [h_d, h_b].
constexpr int SLICE_KV = 7, SLICE_KI = 3;

template <typename T, typename V, int NT, bool FIXED, bool SLICE = false>
__global__ void __launch_bounds__(NT) eta_colk_kernel(
        const T *__restrict__ Tt, T *__restrict__ C, T *__restrict__ F,
        V *__restrict__ costs, V *__restrict__ b, int *__restrict__ base,
        V *__restrict__ w, const T *__restrict__ ah, int M, int R, int r,
        int t, int cols, int stage, int nbA, int nbB,
        unsigned char *__restrict__ ws_bytes, SeqStep<T, V> s,
        seq::Policy pol, SliceOut<V> so) {
    constexpr int NW = NT / 32;
    const int tid = threadIdx.x;
    if ((int)blockIdx.x >= nbB) {
        // The row blocks: F[t] and b (whole blocks return together).
        grid_wait();
        grid_launch_next();
        const int j = (blockIdx.x - nbB) * NT + tid;
        if (j >= M) return;
        const int k = min(*s.k, M - 1);
        T *frow = F + (size_t)t * M;
        if (*s.do_ == 0) {
            frow[j] = (T)0;
            return;
        }
        const T p = *s.p;
        const V bk = *s.bk;
        if (j == k) {
            frow[j] = sub_rn((T)1, div_rn((T)1, p));
            b[j] = div_rn(bk, (V)p);
        } else {
            const T f = div_rn(ah[j], p);
            frow[j] = f;
            b[j] = sub_rn(b[j], mul_rn(bk, (V)f));
        }
        return;
    }

    using Cand = RowCands<V, SLICE>;
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ Cand warps[NW];
    __shared__ int wany[NW];
    __shared__ bool last, anchor;
    const WsB ws(ws_bytes, nbA, nbB);
    const int i0 = blockIdx.x * cols;
    const int ncol = min(cols, R - i0);
    const int i = i0 + tid;                      // this thread's column
    const bool col = tid < ncol;
    const int W = slab_width(cols, sizeof(T));
    const Slab<T, NT, FIXED> slab{C, (size_t)R, i0, ncol, t, stage, W,
                                  reinterpret_cast<T *>(dyn)};
    T *fk = slab.buf + (size_t)min(t, 2 * stage) * W;  // F[:t, k]

    // The block's C slab first (it does not depend on k, and no pivot
    // since the last before wrote it), then what k does not select, all
    // before the kernel before is waited for; then k and what it selects.
    slab.first();
    const bool devex = w != nullptr;
    V c = (V)0, wi = (V)0;
    if (col) {
        c = costs[i];
        if (devex) wi = w[i];
    }
    grid_wait();
    grid_launch_next();
    const int h_raw = *s.h;
    const int h = min(h_raw, R - 1);
    const T p = *s.p;
    const V u = *s.u;
    const int k = min(*s.k, M - 1);
    const bool d = *s.do_ != 0;
    for (int q = tid; q < t; q += NT) fk[q] = F[(size_t)q * M + k];
    const T tk = col ? Tt[(size_t)k * R + i] : (T)0;
    V wh = (V)0;
    int lvar = -1;
    if (devex && d) {                            // before the last block's
        wh = SLICE ? *so.wh : w[h];              // stores
        lvar = base[k];
        if (SLICE) lvar -= so.offset;            // the slice's column, if any
    }

    // colk[i] = Tt[k, i] - sum_{s<t} F[s, k] C[s, i], s in order from 0,
    // in f64.
    const double acc = slab.sum(fk);

    Cand none{};
    none.key = none.key1 = -inf<V>();
    none.val = none.val1 = none.bval = inf<V>();
    none.idx = none.idx1 = none.bidx = BIG_INDEX;
    Cand x = none;
    if (col) {
        const T ck = (T)__dsub_rn((double)tk, acc);
        C[(size_t)t * R + i] = d ? ck : (T)0;
        if (d) {
            c = sub_rn(c, mul_rn(u, (V)ck));
            costs[i] = c;
        }
        const V cm = i < r ? c : inf<V>();       // torch.where(iota < r)
        const bool elig = cm <= -(V)pol.eps;
        if (devex) {
            if (d) {
                const V alpha = (V)div_rn(ck, p);
                V w2 = max_nan(wi, mul_rn(mul_rn(alpha, alpha), wh));
                if (i == lvar)
                    w2 = max_nan(div_rn(wh, (V)mul_rn(p, p)), (V)1);
                w2 = min_nan(w2, (V)1e12);
                if (w2 != w2) w2 = (V)1;
                if (!SLICE && i == h)
                    *ws.wh = (double)w2;         // the last block stores it
                else
                    w[i] = w2;
                wi = w2;
            }
            x.wmax = wi;
            if constexpr (SLICE) x.wv = wi;
            const V c2 = mul_rn(cm, cm);
            x.key = elig ? div_rn(c2, wi) : -inf<V>();
            x.key1 = elig ? c2 : -inf<V>();
        } else {
            x.key = -cm;
        }
        x.idx = x.idx1 = i;
        x.val = x.val1 = cm;
        if (elig) {
            x.bidx = i;
            x.bval = cm;
            if constexpr (SLICE) x.bw = wi;
        }
    }
    // The block's fold (its barrier orders the stores above before thread
    // 0's fence), the partial, then the ticket. SLICE: the ticket's
    // acq_rel alone orders the partial before it (the last block reads
    // nothing else a column block wrote); the fences cost 0.7-0.8 us.
    bool unused = false;
    block_fold<NW>(x, unused, none, warps, wany);
    if (tid == 0) {
        const int q = blockIdx.x;
        ws.key[q] = (double)x.key;
        ws.val[q] = (double)x.val;
        ws.key1[q] = (double)x.key1;
        ws.val1[q] = (double)x.val1;
        ws.bval[q] = (double)x.bval;
        ws.wmax[q] = (double)x.wmax;
        ws.idx[q] = x.idx;
        ws.idx1[q] = x.idx1;
        ws.bidx[q] = x.bidx;
        if constexpr (SLICE) {
            ws.wv[q] = (double)x.wv;
            ws.bw[q] = (double)x.bw;
        } else {
            __threadfence();
        }
        last = ticket(ws.counter) == (unsigned)nbB - 1;
    }
    __syncthreads();
    if (!last) return;

    // The last block: every column block has read h, base[k] and w[h] and
    // written its partial.
    if (!SLICE) __threadfence();
    seq::PostIn<V> in{};
    if (tid == 0) in = seq::post_load(s);
    x = none;
    for (int q = tid; q < nbB; q += NT) {
        Cand o;
        o.key = (V)__ldcg(ws.key + q);
        o.idx = __ldcg(ws.idx + q);
        o.val = (V)__ldcg(ws.val + q);
        o.key1 = (V)__ldcg(ws.key1 + q);
        o.idx1 = __ldcg(ws.idx1 + q);
        o.val1 = (V)__ldcg(ws.val1 + q);
        o.bval = (V)__ldcg(ws.bval + q);
        o.bidx = __ldcg(ws.bidx + q);
        o.wmax = (V)__ldcg(ws.wmax + q);
        if constexpr (SLICE) {
            o.wv = (V)__ldcg(ws.wv + q);
            o.bw = (V)__ldcg(ws.bw + q);
        }
        take_first(x, o);
    }
    block_fold<NW>(x, unused, none, warps, wany);
    if constexpr (SLICE) {
        // The slice's candidates into the send buffers as global indices,
        // the new weights at them (carried through the folds), and the
        // slice's largest weight; no re-anchor (the next eta_fold_column
        // decides it on the largest of every rank's) and no next step
        // before (it needs the fold).
        if (tid != 0) return;
        const bool has = x.bidx != BIG_INDEX;
        so.send_v[0] = (double)x.val;
        so.send_v[1] = has ? (double)x.bval : (double)CUDART_INF;
        so.send_i[0] = so.offset + x.idx;
        so.send_i[1] = has ? so.offset + x.bidx : BIG_INDEX;
        if (devex) {
            so.send_v[2] = (double)x.wv;
            so.send_v[3] = has ? (double)x.bw : 1.0;
            so.send_v[4] = (double)x.key;
            so.send_v[5] = (double)x.val1;
            so.send_v[6] = (double)x.key1;
            so.send_i[2] = so.offset + x.idx1;
            *so.send_w = (double)x.wmax;
        }
        if (d) base[k] = h_raw;                  // h global
        *ws.counter = 0;                         // ready for the next call
        seq::post(s, in, d, seq::Candidates<V>{}, pol);
        return;
    }
    if (tid == 0) {
        const bool re = devex && d && x.wmax > (V)1e8;   // the re-anchor
        anchor = re;
        const seq::Candidates<V> cand{
                re ? x.idx1 : x.idx, re ? x.val1 : x.val, x.bidx,
                x.bidx == BIG_INDEX ? inf<V>() : x.bval};
        *s.h_d = cand.h_d;
        *s.v_d = cand.v_d;
        *s.h_b = cand.h_b;
        *s.v_b = cand.v_b;
        if (d) {
            base[k] = h_raw;                     // before the step rewrites h
            if (devex && !re) w[h] = (V)__ldcg(ws.wh);
        }
        *ws.counter = 0;                         // ready for the next call
        seq::post(s, in, d, cand, pol);
    }
    if (devex && d) {
        __syncthreads();
        if (anchor)
            for (int q = tid; q < R; q += NT) w[q] = (V)1;
    }
}

// ---------------------------------------------------------------------------
// eta_fold_column: the sharded plain blocked loop's first kernel a pivot.
// Its head: the fold of the candidates every rank packed (slice_fold), then
// the step before the ratio test (seq::pre; h global), which block 0
// stores with the folded candidates and the weight at h; under devex, when
// the largest of every rank's weights passed 1e8, every block resets its
// share of the slice's weights to 1 (the re-anchor the pivot before left
// to the fold). Then the rank that owns h writes the live column Tt[:,
// hl] - sum_{s<t} C[s, hl] F[s] into ah (hl = h - offset), in eta_ratio's
// order and precision; every other rank writes zeros (+0.0, as torch.where
// writes them), which the all_reduce after it sums away.
//
// One warp folds the ranks (lane q rank q, all of their entries loaded at
// once, beside the block's F slab), in slice_fold's total order; the
// ratio test may launch once the fold is done; a rank that does not own h
// stores its zeros before it waits for its slab. Sending for the rank's
// own candidates' columns before the fold (the h the fold picks is always
// one of its owner's) was tried and dropped: over a window it saved
// nothing (0.2 us slower at t = 0, as fast at t = 64, 0.17 faster at t =
// 127; tools/eta_variants.cu, PERF.md) for an operand and three slots.
//
// The folded candidates: the main one (h_d, v_d, its weight w_d) and the
// Bland one (h_b, v_b, w_b), the weights 1 without devex or on a
// re-anchor; and whether the re-anchor resets the weights.
struct SliceFold {
    int h_d, h_b;
    double v_d, v_b, w_d, w_b;
    bool reset;
};

// Rank q's packed candidates (lane q < P of warp 0), every entry loaded at
// once.
struct RankPack {
    double v[SLICE_KV];
    int ix[SLICE_KI];
    double w;
};

__device__ __forceinline__ RankPack rank_pack(const double *__restrict__ V,
                                              const int *__restrict__ I,
                                              const double *__restrict__ Wg,
                                              int P, int kv) {
    const int q = threadIdx.x & 31, ki = kv == SLICE_KV ? SLICE_KI : 2;
    const bool in = q < P;
    RankPack x;
#pragma unroll
    for (int e = 0; e < SLICE_KV; ++e)
        x.v[e] = in && e < kv ? V[(size_t)q * kv + e] : 0.0;
#pragma unroll
    for (int e = 0; e < SLICE_KI; ++e)
        x.ix[e] = in && e < ki ? I[(size_t)q * ki + e] : BIG_INDEX;
    x.w = in && kv == SLICE_KV ? Wg[q] : 0.0;
    return x;
}

// The fold of every rank's packed candidates (kernels/eta.py slice_fold,
// pack_slice's layout: V (P, kv) f64 and I (P, ki) int32, kv = SLICE_KV
// under devex, else 2, and under devex Wg (P,) the ranks' largest
// weights) over one warp, P <= 32 (lane q holding rank q's RankPack), in
// its total order: the re-anchor where any rank's largest weight
// passed 1e8 and none is NaN; the main candidate from the first rank with
// the largest key (rank 0 where any key is NaN), the Bland one from the
// first rank with the lowest global index. Every lane gets the fold.
__device__ __forceinline__ SliceFold slice_fold_warp(const RankPack &x,
                                                     int P, int kv) {
    constexpr unsigned FULL = seq::FULL;
    const int q = threadIdx.x & 31;
    const bool in = q < P, devex = kv == SLICE_KV;
    SliceFold f{};
    f.reset = devex && !__any_sync(FULL, in && x.w != x.w) &&
              __any_sync(FULL, in && x.w > 1e8);
    const bool ride = devex && !f.reset;         // the weights ride along
    const double key = devex ? (f.reset ? x.v[6] : x.v[4]) : -x.v[0];
    const bool nan = __any_sync(FULL, in && key != key);
    double k = in ? key : -CUDART_INF;
    int od = in ? q : 32, hb = in ? x.ix[1] : 0x7fffffff, ob = od;
    for (int off = 16; off > 0; off >>= 1) {
        const double k2 = __shfl_xor_sync(FULL, k, off);
        const int o2 = __shfl_xor_sync(FULL, od, off);
        if (k2 > k || (k2 == k && o2 < od)) {
            k = k2;
            od = o2;
        }
        const int h2 = __shfl_xor_sync(FULL, hb, off);
        const int b2 = __shfl_xor_sync(FULL, ob, off);
        if (h2 < hb || (h2 == hb && b2 < ob)) {
            hb = h2;
            ob = b2;
        }
    }
    if (nan) od = 0;                             // the max is NaN: rank 0
    f.h_d = __shfl_sync(FULL, f.reset ? x.ix[2] : x.ix[0], od);
    f.v_d = __shfl_sync(FULL, f.reset ? x.v[5] : x.v[0], od);
    f.w_d = ride ? __shfl_sync(FULL, x.v[2], od) : 1.0;
    f.h_b = hb;
    f.v_b = __shfl_sync(FULL, x.v[1], ob);
    f.w_b = ride ? __shfl_sync(FULL, x.v[3], ob) : 1.0;
    return f;
}

template <typename T, typename V, int NT, bool FIXED>
__global__ void __launch_bounds__(NT) eta_fold_column_kernel(
        const T *__restrict__ Tt, const T *__restrict__ C,
        const T *__restrict__ F, T *__restrict__ ah, int M, int R, int t,
        int rows, int stage, int offset, const double *__restrict__ Vg,
        const int *__restrict__ Ig, const double *__restrict__ Wg, int P,
        int kv, V *__restrict__ w, V *__restrict__ wh, SeqStep<T, V> s,
        long long max_iter, double eps) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ int col;                          // h's local column, or -1
    __shared__ bool reset;
    const int tid = threadIdx.x;
    const int j0 = blockIdx.x * rows;
    const int nrow = min(rows, M - j0);
    const int j = j0 + tid;                      // this thread's row
    const bool row = tid < nrow;
    const int W = slab_width(rows, sizeof(T));
    const Slab<T, NT, FIXED> slab{F, (size_t)M, j0, nrow, t, stage, W,
                                  reinterpret_cast<T *>(dyn)};
    T *cs = slab.buf + (size_t)min(t, 2 * stage) * W;  // C[:t, hl]

    // The block's F slab first (it does not depend on h); the fold's
    // operands all at once.
    slab.first();
    RankPack pk{};
    int status = 0, iterations = 0;
    bool bland = false;
    if (tid < 32) pk = rank_pack(Vg, Ig, Wg, P, kv);
    if (tid == 0) {
        status = *s.status;
        iterations = *s.iterations;
        bland = *s.bland != 0;
    }

    // The fold and the step before.
    if (tid < 32) {
        const SliceFold f = slice_fold_warp(pk, P, kv);
        if (tid == 0) {
            const seq::Candidates<V> c{f.h_d, (V)f.v_d, f.h_b, (V)f.v_b};
            const bool use_b = bland && c.h_b < BIG_INDEX;
            const long long l = (long long)(use_b ? c.h_b : c.h_d) - offset;
            col = l >= 0 && l < R ? (int)l : -1;
            reset = f.reset;
            if (blockIdx.x == 0) {
                *s.h_d = c.h_d;
                *s.v_d = c.v_d;
                *s.h_b = c.h_b;
                *s.v_b = c.v_b;
                seq::pre(s, status, iterations, bland, c, max_iter, eps);
                if (wh != nullptr) *wh = (V)(use_b ? f.w_b : f.w_d);
            }
        }
    }
    __syncthreads();
    grid_launch_next();                          // the ratio test may start
    if (w != nullptr && reset)
        for (int q = blockIdx.x * NT + tid; q < R; q += gridDim.x * NT)
            w[q] = (V)1;
    const int hl = col;
    if (hl < 0) {                                // another rank's column
        if (row) ah[j] = (T)0;
        cp_async_wait<0>();      // no copy may land in an exited block
        return;
    }
    for (int q = tid; q < t; q += NT) cs[q] = C[(size_t)q * R + hl];
    const T th = row ? Tt[(size_t)j * R + hl] : (T)0;

    // a_h[j] = Tt[j, hl] - sum_{s<t} C[s, hl] F[s, j], s in order from 0,
    // in f64 (eta_ratio's sum: the same products in the same order; the
    // sum's first barrier shows cs).
    const double acc = slab.sum(cs);
    if (row) ah[j] = (T)__dsub_rn((double)th, acc);
}

// ---------------------------------------------------------------------------
// eta_ratio_summed: the sharded plain blocked loop's ratio test on the
// column the all_reduce summed into ah, and the step between; one cluster
// of SUMMED_BLOCKS blocks of SUMMED_THREADS threads, each thread taking its
// rows SUMMED_PER at a time (ratio_cluster.cuh, seq_ratio_colk_sharded's
// ratio test). A programmatic dependent launch: b of its first rows (the
// pivot before wrote it) and the cluster's relaxed arrival before
// griddepcontrol.wait; ah and the step between's operands (active,
// optimal, minc: eta_fold_column's step before) after it. At one NCCL rank
// the all_reduce is no node, so it starts behind eta_fold_column, which
// lets it launch once its fold is done; at more, behind NCCL's kernel,
// whose completion the wait still waits for.

constexpr int SUMMED_BLOCKS = 16;
constexpr int SUMMED_THREADS = 256;
constexpr int SUMMED_PER = 4;

template <typename T, typename V, int NB, int NT, int PER_>
__global__ void __launch_bounds__(NT) eta_ratio_summed_kernel(
        const V *__restrict__ b, T *__restrict__ ah, int M, double eps,
        SeqStep<T, V> s) {
    constexpr int SPAN = NB * NT;
    __shared__ seq::RatioShared<T, V, NB, NT / 32> rsh;
    const int g = (int)cooperative_groups::this_cluster().block_rank() * NT +
                  threadIdx.x;
    cluster_arrive_relaxed();
    T a0[PER_];
    V b0[PER_];
#pragma unroll
    for (int q = 0; q < PER_; ++q)
        if (g + q * SPAN < M) b0[q] = b[g + q * SPAN];
    grid_wait();
    grid_launch_next();
    bool active = false, optimal = false;
    V minc = (V)0;
    if (threadIdx.x == 0) {
        active = *s.active != 0;
        optimal = *s.optimal != 0;
        minc = *s.minc;
    }
    seq::ratio_cluster<T, V, NB, NT, PER_, false, true>(
            rsh, nullptr, b, ah, M, 1, 0, eps, active, optimal, minc, s, a0,
            b0);
}

// ---------------------------------------------------------------------------
// Launchers.

int cdiv(int a, int b) { return (a + b - 1) / b; }

// A block's rows (or columns): whole 16-byte chunks of f32, one a thread.
bool width_ok(int width, int nt) {
    return width >= 4 && width <= nt && width % 4 == 0;
}

// The checks of a launch with a slab: the shape, t, the block's width, a
// stage of at least one row whose two rounds fit beside the window's
// coefficients; then the block's dynamic shared memory (-1: refused).
template <typename T>
long long slab_smem(int M, int R, int L, int t, int width, int nt,
                    int stage) {
    if (M < 1 || R < 1 || t < 0 || t >= L || !width_ok(width, nt) ||
        stage < 1)
        return -1;
    const int item = sizeof(T);
    if (2LL * stage * slab_width(width, item) * item +
                round16((long long)L * item) >
        BLOCK_SMEM - SMEM_RESERVE)
        return -1;                               // the stage does not fit
    return smem_bytes(width, stage, t, item);
}

// The checks both eta kernels make: slab_smem's, and the grid and the
// workspace it needs.
template <typename T>
long long prepare(int M, int R, int L, int t, int width, int nt, int rows,
                  int cols, int stage, long long ws_len) {
    if (rows < 1 || cols < 1) return -1;
    if (M >= 1 && R >= 1 &&
        ws_len < (long long)ws_bytes(cdiv(M, rows), cdiv(R, cols)))
        return -1;                               // workspace too small
    return slab_smem<T>(M, R, L, t, width, nt, stage);
}

// Let kernel K take ``smem`` bytes of dynamic shared memory: past 48 KB
// less SMEM_RESERVE (the default limit holds the static arrays too: at
// f64, 64 columns a block and t = 91 eta_colk_slice's 48,776 bytes and
// its 384 static passed it), once a device (to the most any window
// needs), for the call waits for the work on the card and would hold a
// capture or an eager window behind the work before it.
template <auto K>
bool allow_smem(long long smem) {
    static unsigned long long allowed = 0;      // a bit a device
    if (smem <= 48 * 1024 - SMEM_RESERVE) return true;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return false;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(allowed & bit)) {
        if (cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 BLOCK_SMEM - SMEM_RESERVE) != cudaSuccess)
            return false;
        allowed |= bit;
    }
    return true;
}

template <typename... P, typename... A>
int launch(void (*kernel)(P...), int grid, int nt, long long smem, bool pdl,
           cudaStream_t st, A... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3((unsigned)nt);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// The launchers take the kernel's threads, the copy path and whether to
// launch it as a programmatic dependent launch as parameters for
// tools/eta_variants.cu; the C entry points below fix them.
template <typename T, typename V, int NT = RATIO_THREADS, bool FIXED = true>
int ratio_run(const void *Tt, const void *C, const void *F, const void *b,
              void *ah, int M, int R, int L, int t, double eps,
              unsigned char *ws, long long ws_len, const void *step, int rows,
              int cols, int stage, bool pdl, cudaStream_t st) {
    constexpr auto kernel = eta_ratio_kernel<T, V, NT, FIXED>;
    const long long smem = prepare<T>(M, R, L, t, rows, NT, rows, cols,
                                      stage, ws_len);
    if (smem < 0 || !allow_smem<kernel>(smem))
        return (int)cudaErrorInvalidValue;
    const int nbA = cdiv(M, rows);
    return launch(kernel, nbA, NT, smem, pdl, st, static_cast<const T *>(Tt),
                  static_cast<const T *>(C), static_cast<const T *>(F),
                  static_cast<const V *>(b), static_cast<T *>(ah), M, R, t,
                  eps, rows, stage, nbA, ws, step_of<T, V>(step));
}

template <typename T, typename V, int NT, bool FIXED = true,
          bool SLICE = false>
int colk_run(const void *Tt, void *C, void *F, void *costs, void *b,
             int *base, void *w, const void *ah, int M, int R, int L, int r,
             int t, unsigned char *ws, long long ws_len, const void *step,
             const seq::Policy &pol, int rows, int cols, int stage, bool pdl,
             cudaStream_t st, const SliceOut<V> &so = SliceOut<V>{}) {
    constexpr auto kernel = eta_colk_kernel<T, V, NT, FIXED, SLICE>;
    const long long smem = prepare<T>(M, R, L, t, cols, NT, rows, cols,
                                      stage, ws_len);
    if (smem < 0 || !allow_smem<kernel>(smem))
        return (int)cudaErrorInvalidValue;
    const int nbA = cdiv(M, rows), nbB = cdiv(R, cols);
    return launch(kernel, nbB + cdiv(M, NT), NT, smem, pdl, st,
                  static_cast<const T *>(Tt), static_cast<T *>(C),
                  static_cast<T *>(F), static_cast<V *>(costs),
                  static_cast<V *>(b), base, static_cast<V *>(w),
                  static_cast<const T *>(ah), M, R, r, t, cols, stage,
                  nbA, nbB, ws, step_of<T, V>(step), pol, so);
}

// eta_colk (or with SLICE its slice's form) with COLK_THREADS threads a
// block, or 256 for 256 columns.
template <typename T, typename V, bool SLICE = false>
int colk_any(const void *Tt, void *C, void *F, void *costs, void *b,
             int *base, void *w, const void *ah, int M, int R, int L, int r,
             int t, unsigned char *ws, long long ws_len, const void *step,
             const seq::Policy &pol, int rows, int cols, int stage,
             cudaStream_t st, const SliceOut<V> &so = SliceOut<V>{}) {
    if (cols > COLK_THREADS)
        return colk_run<T, V, 2 * COLK_THREADS, true, SLICE>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, true, st, so);
    return colk_run<T, V, COLK_THREADS, true, SLICE>(
            Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len, step,
            pol, rows, cols, stage, true, st, so);
}

// The slice's eta_colk: its send buffers given, and under devex (w given)
// the weight at h and the send buffer of the largest weight; no next step
// before (it needs the fold).
template <typename T, typename V>
int colk_slice_any(const void *Tt, void *C, void *F, void *costs, void *b,
                   int *base, void *w, const void *ah, int M, int R, int L,
                   int r, int t, unsigned char *ws, long long ws_len,
                   const void *step, const seq::Policy &pol, int rows,
                   int cols, int stage, int offset, const void *wh,
                   double *send_v, int *send_i, double *send_w,
                   cudaStream_t st) {
    const bool devex = w != nullptr;
    if (pol.then_pre || send_v == nullptr || send_i == nullptr ||
        devex != (wh != nullptr) || devex != (send_w != nullptr))
        return (int)cudaErrorInvalidValue;
    const SliceOut<V> so{offset, static_cast<const V *>(wh), send_v, send_i,
                         send_w};
    return colk_any<T, V, true>(Tt, C, F, costs, b, base, w, ah, M, R, L, r,
                                t, ws, ws_len, step, pol, rows, cols, stage,
                                st, so);
}

// The sharded loop's ratio test on the summed column: one cluster of
// SUMMED_BLOCKS blocks, a programmatic dependent launch.
template <typename T, typename V>
int ratio_summed_run(const void *b, void *ah, int M, double eps,
                     const void *step, cudaStream_t st) {
    if (M < 1) return (int)cudaErrorInvalidValue;
    auto kernel = eta_ratio_summed_kernel<T, V, SUMMED_BLOCKS, SUMMED_THREADS,
                                          SUMMED_PER>;
    static const cudaError_t e = allow_cluster(kernel, SUMMED_BLOCKS);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, SUMMED_BLOCKS, SUMMED_THREADS, true, st,
                          static_cast<const V *>(b), static_cast<T *>(ah), M,
                          eps, step_of<T, V>(step));
}

// eta_fold_column on eta_ratio's plan (rows a block, slab rows a round);
// under devex (kv == SLICE_KV) the ranks' largest weights, the slice's
// weights and the weight at h given, else none of them. Launched without
// programmatic dependent launch (a device copy or NCCL's kernel precedes
// it). One warp folds the ranks, so P is at most 32.
template <typename T, typename V>
int fold_column_run(const void *Tt, const void *C, const void *F, void *ah,
                    int M, int R, int L, int t, int offset, const double *Vg,
                    const int *Ig, const double *Wg, int P, int kv, void *w,
                    void *wh, const void *step, long long max_iter,
                    double eps, int rows, int stage, cudaStream_t st) {
    constexpr auto kernel = eta_fold_column_kernel<T, V, RATIO_THREADS, true>;
    const bool devex = kv == SLICE_KV;
    const long long smem = slab_smem<T>(M, R, L, t, rows, RATIO_THREADS,
                                        stage);
    if (P < 1 || P > 32 || (kv != 2 && !devex) || Vg == nullptr ||
        Ig == nullptr || devex != (Wg != nullptr) ||
        devex != (w != nullptr) || devex != (wh != nullptr) || smem < 0 ||
        !allow_smem<kernel>(smem))
        return (int)cudaErrorInvalidValue;
    return launch(kernel, cdiv(M, rows), RATIO_THREADS, smem, false, st,
                  static_cast<const T *>(Tt), static_cast<const T *>(C),
                  static_cast<const T *>(F), static_cast<T *>(ah), M, R, t,
                  rows, stage, offset, Vg, Ig, Wg, P, kv,
                  static_cast<V *>(w), static_cast<V *>(wh),
                  step_of<T, V>(step), max_iter, eps);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes). ``step`` is the host's array of the sequential
// scalars' pointers (kernels.seq.SeqScalars), ``pair`` the dtype pair
// (PAIR_*), ``ws`` an eta_workspace of ``ws_len`` bytes, ``rows`` and
// ``cols`` the rows a block of eta_ratio and the columns a block of
// eta_colk, ``stage`` the launched kernel's slab rows a round
// (kernels/eta.py eta_plan). Both launch as programmatic dependent
// launches. An unknown pair, an empty shape, t outside [0, L), a width
// that is not a multiple of 4 within the block's threads, a stage whose two
// rounds do not fit or a short workspace is refused with
// cudaErrorInvalidValue. Each returns cudaGetLastError() as an int.

extern "C" {

// Tt (M, R), C (L, R), F (L, M) and ah (M,) of the tableau's dtype, b (M,)
// of the vectors'.
int eta_ratio_launch(const void *Tt, const void *C, const void *F,
                     const void *b, void *ah, int M, int R, int L, int t,
                     double eps, unsigned char *ws, long long ws_len,
                     const void *step, int pair, int rows, int cols,
                     int stage, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return ratio_run<double, double>(Tt, C, F, b, ah, M, R, L, t, eps, ws,
                                         ws_len, step, rows, cols, stage,
                                         true, st);
    case PAIR_MIXED:
        return ratio_run<float, double>(Tt, C, F, b, ah, M, R, L, t, eps, ws,
                                        ws_len, step, rows, cols, stage, true,
                                        st);
    case PAIR_F32:
        return ratio_run<float, float>(Tt, C, F, b, ah, M, R, L, t, eps, ws,
                                       ws_len, step, rows, cols, stage, true,
                                       st);
    }
    return (int)cudaErrorInvalidValue;
}

// costs (R,) and w (R,; null: no devex) and b (M,) of the vectors' dtype,
// base (M,) int32; under max_iter, eps, the Bland mode and threshold and
// then_pre.
int eta_colk_launch(const void *Tt, void *C, void *F, void *costs, void *b,
                    int *base, void *w, const void *ah, int M, int R, int L,
                    int r, int t, double eps, unsigned char *ws,
                    long long ws_len, const void *step, long long max_iter,
                    int bland_mode, int threshold, int then_pre, int pair,
                    int rows, int cols, int stage, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const seq::Policy pol{max_iter, eps, bland_mode, threshold, then_pre};
    switch (pair) {
    case PAIR_F64:
        return colk_any<double, double>(Tt, C, F, costs, b, base, w, ah, M, R,
                                        L, r, t, ws, ws_len, step, pol, rows,
                                        cols, stage, st);
    case PAIR_MIXED:
        return colk_any<float, double>(Tt, C, F, costs, b, base, w, ah, M, R,
                                       L, r, t, ws, ws_len, step, pol, rows,
                                       cols, stage, st);
    case PAIR_F32:
        return colk_any<float, float>(Tt, C, F, costs, b, base, w, ah, M, R,
                                      L, r, t, ws, ws_len, step, pol, rows,
                                      cols, stage, st);
    }
    return (int)cudaErrorInvalidValue;
}

// The sharded plain blocked loop's kernels on a rank's slice Tt (M, R) from
// global column ``offset`` (C (L, R), F (L, M), ah (M,) of the tableau's
// dtype). eta_fold_column: V (P, kv) f64 and I (P, kv == 7 ? 3 : 2) int32
// the gathered candidates, P at most 32; under devex (kv 7) W (P,) f64
// the ranks' largest weights, w (R,) the slice's weights and wh the weight
// at h, of the vectors' dtype (all null without devex); ``rows`` and
// ``stage`` eta_ratio's rows a block and slab rows a round.
int eta_fold_column_launch(const void *Tt, const void *C, const void *F,
                           void *ah, int M, int R, int L, int t, int offset,
                           const double *V, const int *I, const double *W,
                           int P, int kv, void *w, void *wh,
                           const void *step, long long max_iter, double eps,
                           int pair, int rows, int stage, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return fold_column_run<double, double>(Tt, C, F, ah, M, R, L, t,
                                               offset, V, I, W, P, kv, w, wh,
                                               step, max_iter, eps, rows,
                                               stage, st);
    case PAIR_MIXED:
        return fold_column_run<float, double>(Tt, C, F, ah, M, R, L, t,
                                              offset, V, I, W, P, kv, w, wh,
                                              step, max_iter, eps, rows,
                                              stage, st);
    case PAIR_F32:
        return fold_column_run<float, float>(Tt, C, F, ah, M, R, L, t, offset,
                                             V, I, W, P, kv, w, wh, step,
                                             max_iter, eps, rows, stage, st);
    }
    return (int)cudaErrorInvalidValue;
}

// The ratio test on the summed column ah (M,) of the tableau's dtype, b
// (M,) of the vectors': one cluster, a programmatic dependent launch.
int eta_ratio_summed_launch(const void *b, void *ah, int M, double eps,
                            const void *step, int pair, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return ratio_summed_run<double, double>(b, ah, M, eps, step, st);
    case PAIR_MIXED:
        return ratio_summed_run<float, double>(b, ah, M, eps, step, st);
    case PAIR_F32:
        return ratio_summed_run<float, float>(b, ah, M, eps, step, st);
    }
    return (int)cudaErrorInvalidValue;
}

// eta_colk on the slice: eta_colk_launch's operands (no then_pre), then
// the offset, the weight at h (devex), and the send buffers: send_v (kv,)
// f64, send_i (ki,) int32, send_w (1,) f64 (devex, else null).
int eta_colk_slice_launch(const void *Tt, void *C, void *F, void *costs,
                          void *b, int *base, void *w, const void *ah, int M,
                          int R, int L, int r, int t, double eps,
                          unsigned char *ws, long long ws_len,
                          const void *step, long long max_iter,
                          int bland_mode, int threshold, int pair, int rows,
                          int cols, int stage, int offset, const void *wh,
                          double *send_v, int *send_i, double *send_w,
                          void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const seq::Policy pol{max_iter, eps, bland_mode, threshold, 0};
    switch (pair) {
    case PAIR_F64:
        return colk_slice_any<double, double>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, offset, wh, send_v, send_i,
                send_w, st);
    case PAIR_MIXED:
        return colk_slice_any<float, double>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, offset, wh, send_v, send_i,
                send_w, st);
    case PAIR_F32:
        return colk_slice_any<float, float>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, offset, wh, send_v, send_i,
                send_w, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
