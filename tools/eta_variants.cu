// The plain blocked loop's per-pivot kernels (csrc/eta.cu) on the card,
// several ways, every output checked byte for byte against the forms they
// replaced:
//
//   prior     verbatim copies of the two kernels the port launched before:
//             one thread a row (64 a block) or a column (128 a block), each
//             thread loading its t slab elements from global memory after
//             h or k was read, a ticket, the last block's fold;
//   shipped   the shipped kernels (included from the source) on the plan
//             kernels/eta.py eta_plan chooses (its rule copied below): each
//             block's slab rows sent for as cp.async copies into shared
//             memory before h or k is read, then the sums from shared
//             memory; as a pivot, both programmatic dependent launches;
//   general   the same with every slab row copied by the general path (a
//             16-byte copy a whole chunk found by division, the head and
//             tail element by element), as unaligned rows are;
//   old       the first redesign's grid, as many slab rows a round as fit;
//   rRxN      the shipped eta_ratio with R rows a block of N threads;
//   rsS       the shipped eta_ratio with S slab rows a round;
//   cCxN      the shipped eta_colk with C columns a block of N threads;
//   cCsS      the same with C columns and S slab rows a round;
//   plain, pdl-colk, pdl-both   the first redesign's pivot with neither,
//             eta_colk, or both kernels launched as programmatic dependent
//             launches (the other pivot forms: both).
//
// Build and run on a machine with an H100 (~3 min):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/eta_variants tools/eta_variants.cu && /tmp/eta_variants
//
// Checks, in f64/f64, f32/f64 and f32/f32, under devex: every scalar of
// the step, a_h, C[t], F[t], the costs, the weights, b, base and the
// workspace's counters equal to prior's, byte for byte, after one eta_ratio
// and one eta_colk from each edge state -- a taken pivot, a NaN in b, no
// eligible row (eps past every a_h), Bland on, the fuse (a skipped pivot),
// a weight past the re-anchor's bound, Bland static with the next step
// before -- at t = 0, 1, L / 2 and L - 1, L = 128, 13 and 300 (the slab in
// three rounds), M x R = 2,048 x 6,144, 1 x 3, 37 x 6,143, 2,047 x 6,143,
// 2,047 x 3 and 4,097 x 257 (rows of F and C unaligned: f64 rows on 8
// bytes, f32 rows on 4), for every form. Times, at M x R = 2,048 x 6,144
// and 8,192 x 24,576 (the 2048^2 and 8192^2 phase-1 tableaus) for the
// three pairs and at the north star's 10,112 x 120,064 in f64, L = 128,
// t = 0, 64 and 127: us a call of each kernel alone, and us a pivot
// (eta_ratio then eta_colk), by CUDA events around 20 replays of a CUDA
// graph of 50 calls or pivots, each form in turns (every form, then
// back), two rounds, the first and last given. The timed state is a taken
// devex pivot; eta_colk is timed without the next step before, so every
// call does the same work.
//
// First (``/tmp/eta_variants colk`` runs this part alone, ~2 min) the
// sharded plain blocked loop's pass, eta_colk_slice: the shipped kernel
// (the new weights at the candidates carried through the block's and the
// partials' folds, the ticket's acq_rel with no __threadfence beside it)
// against the form before (colk_prior, verbatim: the weights read back
// past L1 after the fold, a fence before the ticket and after) and the
// forms the port does not ship (colk_forms: the carried weights with the
// fences; the weights read back without them; clusters of 8 column
// blocks folding over distributed shared memory, one ticket a cluster),
// byte for byte after the shipped eta_ratio from edge states (state()'s
// seven, Dantzig, a NaN weight that wins, equal devex scores in the first
// and the last block, no eligible column, Bland static) at offsets 0 and
// 2R, t = 0, 1, L / 2 and L - 1, L = 128 and 13, M x R = 2,048 x 6,144,
// 2,048 x 2,048, 37 x 6,143, 2,047 x 3 and 4,097 x 257, the three pairs;
// then timed in turns in f64 at 2,048 x 6,144 and 2,048 x 2,048 (a third
// of its columns: one slice of three), t = 0, 64 and 127, and 8,192 x
// 24,576 at t = 64, with eta_colk (whose template it shares) against its
// form before at the first and the last.
//
// Then the sharded plain blocked loop's head (``/tmp/eta_variants
// slice`` runs this part alone, ~1 min): eta_fold_column -- the shipped
// form (one warp folding), the form before it (slice_prior) and the others
// (slice_forms: the rank's own candidates' columns sent for before the
// fold, the fold in one warp or in thread 0) -- and eta_ratio_summed -- one
// cluster of 8 or 16 blocks of 256 threads, with or without programmatic
// dependent launch, and the form before it (eta_ratio's grid and ticket) --
// checked byte for byte against the forms before them: the fold at P = 1
// and 3 ranks' candidates from edge states (rank 0's main, Bland and
// re-anchor candidates picked, Dantzig, another rank's pick, a NaN key, a
// pick none of the rank's own candidates, a NaN Dantzig cost, a NaN
// weight alone and beside one past 1e8) at t = 0, 1, L / 2 and L - 1,
// L = 128 and 13, M x R = 2,048 x 6,144, 37 x 6,143, 2,047 x 3 and 10,112
// x 257, the three pairs; the ratio test on a taken pivot, a NaN in b, no
// eligible row and the fuse. Then, in f64 at t = 64, L = 128: the fold's
// forms at P = 1 and 3, the ratio test's alone (also at the north star's
// 10,112 rows), and the head -- the fold then the ratio test: the shipped
// fold with each cluster form, the other folds with the shipped cluster --
// in turns, at
// 2,048 x 6,144 and 8,192 x 24,576.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

#include "../simplex_tpu_torch/kernels/csrc/eta.cu"

#define CK(x)                                                              \
    do {                                                                   \
        cudaError_t e_ = (cudaError_t)(x);                                 \
        if (e_ != cudaSuccess) {                                           \
            std::printf("CUDA error %s at %s:%d\n",                        \
                        cudaGetErrorString(e_), __FILE__, __LINE__);       \
            std::exit(1);                                                  \
        }                                                                  \
    } while (0)

// ---------------------------------------------------------------------------
// The sharded plain blocked loop's two head kernels as the port launched
// them before, verbatim (their helpers -- Slab and the workspace -- are the
// shipped file's, unchanged; slice_fold, the one-thread fold, is kept
// here): eta_ratio_summed on eta_ratio's
// grid, its last block folding by an arrival ticket, launched without
// programmatic dependent launch; eta_fold_column with the fold in each
// block's thread 0 and the owner's column loaded after it. Built alone
// (-DETA_VARIANTS_LIB -shared), this file is a library of these two and
// of colk_prior's (below) with C entry points, which chip_smoke.py and
// the card tests hold and time the shipped kernels against.

namespace slice_prior {

// The fold of V (P, kv) f64 and I (P, ki) int32 (pack_slice's layout;
// kv = SLICE_KV under devex, else 2) and, under devex, Wg (P,) the ranks'
// largest weights: reset when their largest passes 1e8 (a NaN anywhere
// resets nothing, as torch's max propagates it); the main candidate from
// the first rank with the largest key (the devex key on the new weights,
// or on weights of 1 where reset; else -v_d; a NaN key anywhere: rank 0),
// the Bland one from the first rank with the lowest global index
// (parallel/sharded.py fold_candidates).
__device__ __forceinline__ SliceFold slice_fold(const double *__restrict__ V,
                                                const int *__restrict__ I,
                                                const double *__restrict__ Wg,
                                                int P, int kv) {
    const bool devex = kv == SLICE_KV;
    const int ki = devex ? SLICE_KI : 2;
    bool reset = false;
    if (devex) {
        double mx = Wg[0];
        bool nan = mx != mx;
        for (int q = 1; q < P; ++q) {
            const double x = Wg[q];
            nan |= x != x;
            if (x > mx) mx = x;
        }
        reset = !nan && mx > 1e8;
    }
    const bool ride = devex && !reset;           // the weights ride along
    const int cv = reset ? 5 : 0, ck = reset ? 6 : 4, ci = reset ? 2 : 0;
    SliceFold f{};
    double mx = 0.0;
    bool nan = false;
    for (int q = 0; q < P; ++q) {
        const double *v = V + (size_t)q * kv;
        const int *ix = I + (size_t)q * ki;
        const double key = devex ? v[ck] : -v[0];
        nan |= key != key;
        if (q == 0 || key > mx) {
            mx = key;
            f.h_d = ix[ci];
            f.v_d = v[cv];
            f.w_d = ride ? v[2] : 1.0;
        }
        if (q == 0 || ix[1] < f.h_b) {
            f.h_b = ix[1];
            f.v_b = v[1];
            f.w_b = ride ? v[3] : 1.0;
        }
    }
    if (nan) {                                   // the max is NaN: rank 0
        f.h_d = I[ci];
        f.v_d = V[cv];
        f.w_d = ride ? V[2] : 1.0;
    }
    f.reset = reset;
    return f;
}

// SUMMED (eta_ratio_summed, the sharded plain blocked loop's ratio test):
// the column is the one the all_reduce summed into ``ah``, which each
// owner thread reads; no slab, no h, no write of ah. Launched without
// programmatic dependent launch (a collective precedes it).
template <typename T, typename V, int NT, bool FIXED, bool SUMMED = false>
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
    T a = (T)0;
    V bj = (V)0;
    if constexpr (SUMMED) {
        grid_wait();
        grid_launch_next();
        if (row) {
            bj = b[j];
            a = ah[j];
        }
    } else {
        const int W = slab_width(rows, sizeof(T));
        // The slab holds F's rows s < t - 1; the pivot before wrote
        // F[t - 1], which each owner loads itself once that pivot is
        // waited for.
        const Slab<T, NT, FIXED> slab{F, (size_t)M, j0, nrow, max(t - 1, 0),
                                      stage, W, reinterpret_cast<T *>(dyn)};
        T *cs = slab.buf + (size_t)min(t, 2 * stage) * W;  // C[:t, h]

        // The block's F slab first (it does not depend on h), before the
        // kernel before is waited for; then b, F[t - 1], h and what h
        // selects.
        slab.first();
        grid_wait();
        grid_launch_next();
        bj = row ? b[j] : (V)0;
        const T flast = row && t > 0 ? F[(size_t)(t - 1) * M + j] : (T)0;
        const int h = min(*s.h, R - 1);
        for (int q = tid; q < t; q += NT) cs[q] = C[(size_t)q * R + h];
        const T th = row ? Tt[(size_t)j * R + h] : (T)0;
        __syncthreads();                         // cs

        // a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] F[s, j], s in order from 0,
        // in f64.
        double acc = slab.sum(cs);
        if (row && t > 0)
            acc = __dadd_rn(acc, __dmul_rn((double)cs[t - 1], (double)flast));
        if (row) {
            a = (T)__dsub_rn((double)th, acc);
            ah[j] = a;
        }
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

    // The block's F slab first (it does not depend on h), then the fold.
    slab.first();
    if (tid == 0) {
        const int status = *s.status, iterations = *s.iterations;
        const bool bland = *s.bland != 0;
        const SliceFold f = slice_fold(Vg, Ig, Wg, P, kv);
        const seq::Candidates<V> c{f.h_d, (V)f.v_d, f.h_b, (V)f.v_b};
        const bool use_b = bland && c.h_b < BIG_INDEX;
        const long long loc = (long long)(use_b ? c.h_b : c.h_d) - offset;
        col = loc >= 0 && loc < R ? (int)loc : -1;
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
    __syncthreads();
    if (w != nullptr && reset)
        for (int q = blockIdx.x * NT + tid; q < R; q += gridDim.x * NT)
            w[q] = (V)1;
    const int hl = col;
    if (hl < 0) {                                // another rank's column
        cp_async_wait<0>();
        if (row) ah[j] = (T)0;
        return;
    }
    for (int q = tid; q < t; q += NT) cs[q] = C[(size_t)q * R + hl];
    const T th = row ? Tt[(size_t)j * R + hl] : (T)0;
    __syncthreads();                             // cs

    // a_h[j] = Tt[j, hl] - sum_{s<t} C[s, hl] F[s, j], s in order from 0,
    // in f64 (eta_ratio's sum: the same products in the same order).
    const double acc = slab.sum(cs);
    if (row) ah[j] = (T)__dsub_rn((double)th, acc);
}

// The sharded loop's ratio test on the summed column: eta_ratio's grid of
// ``rows`` rows a block and its fold, no slab; launched without
// programmatic dependent launch.
template <typename T, typename V>
int ratio_summed_run(const void *b, void *ah, int M, double eps,
                     unsigned char *ws, long long ws_len, const void *step,
                     int rows, cudaStream_t st) {
    if (M < 1 || !width_ok(rows, RATIO_THREADS))
        return (int)cudaErrorInvalidValue;
    const int nbA = cdiv(M, rows);
    if (ws_len < (long long)ws_bytes(nbA, 0))
        return (int)cudaErrorInvalidValue;
    return launch(eta_ratio_kernel<T, V, RATIO_THREADS, true, true>, nbA,
                  RATIO_THREADS, 0, false, st, static_cast<const T *>(nullptr),
                  static_cast<const T *>(nullptr),
                  static_cast<const T *>(nullptr), static_cast<const V *>(b),
                  static_cast<T *>(ah), M, 1, 0, eps, rows, 1, nbA, ws,
                  step_of<T, V>(step));
}

// eta_fold_column on eta_ratio's plan (rows a block, slab rows a round);
// under devex (kv == SLICE_KV) the ranks' largest weights, the slice's
// weights and the weight at h given, else none of them. Launched without
// programmatic dependent launch (collectives precede it).
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
    if (P < 1 || (kv != 2 && !devex) || Vg == nullptr || Ig == nullptr ||
        devex != (Wg != nullptr) || devex != (w != nullptr) ||
        devex != (wh != nullptr) || smem < 0 || !allow_smem<kernel>(smem))
        return (int)cudaErrorInvalidValue;
    return launch(kernel, cdiv(M, rows), RATIO_THREADS, smem, false, st,
                  static_cast<const T *>(Tt), static_cast<const T *>(C),
                  static_cast<const T *>(F), static_cast<T *>(ah), M, R, t,
                  rows, stage, offset, Vg, Ig, Wg, P, kv,
                  static_cast<V *>(w), static_cast<V *>(wh),
                  step_of<T, V>(step), max_iter, eps);
}

}  // namespace slice_prior

// ---------------------------------------------------------------------------
// eta_colk and eta_colk_slice as the port launched them before their
// candidates carried the weights at them, verbatim (their helpers -- Slab,
// the workspace, first_max and the launch checks -- are the shipped
// file's; the workspace's earlier fields keep their places): the slice's
// last block reads the weights at its candidates back past L1 after the
// fold; its calls of its own launchers qualified, since SliceOut brings
// the shipped ones in by argument-dependent lookup. Built alone
// (-DETA_VARIANTS_LIB -shared) with C entry points, which chip_smoke.py
// and the card tests hold and time the shipped kernel against.

namespace colk_prior {

// A block's candidates: the main one (key the negated cost under Dantzig,
// the devex score under devex; the larger first), the devex one on weights
// of 1, Bland's (the lowest eligible index), and the largest new weight.
template <typename V>
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
__device__ __forceinline__ void take_first(RowCands<V> &x,
                                           const RowCands<V> &o) {
    if (first_max(o.key, o.idx, x.key, x.idx)) {
        x.key = o.key;
        x.idx = o.idx;
        x.val = o.val;
    }
    if (first_max(o.key1, o.idx1, x.key1, x.idx1)) {
        x.key1 = o.key1;
        x.idx1 = o.idx1;
        x.val1 = o.val1;
    }
    if (o.bidx < x.bidx) {
        x.bidx = o.bidx;
        x.bval = o.bval;
    }
    if (o.wmax > x.wmax || o.wmax != o.wmax)     // NaN first, as torch's
        x.wmax = o.wmax;                         // max propagates it
}

template <typename V>
__device__ __forceinline__ RowCands<V> shfl_xor(const RowCands<V> &x,
                                                int off) {
    constexpr unsigned FULL = seq::FULL;
    return RowCands<V>{__shfl_xor_sync(FULL, x.key, off),
                       __shfl_xor_sync(FULL, x.idx, off),
                       __shfl_xor_sync(FULL, x.val, off),
                       __shfl_xor_sync(FULL, x.key1, off),
                       __shfl_xor_sync(FULL, x.idx1, off),
                       __shfl_xor_sync(FULL, x.val1, off),
                       __shfl_xor_sync(FULL, x.bval, off),
                       __shfl_xor_sync(FULL, x.bidx, off),
                       __shfl_xor_sync(FULL, x.wmax, off)};
}

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

    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ RowCands<V> warps[NW];
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

    const RowCands<V> none{-inf<V>(), BIG_INDEX, inf<V>(), -inf<V>(),
                           BIG_INDEX, inf<V>(), inf<V>(), BIG_INDEX, (V)0};
    RowCands<V> x = none;
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
        }
    }
    // The block's fold (its barrier orders the stores above before thread
    // 0's fence), the partial, then the ticket.
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
        __threadfence();
        last = ticket(ws.counter) == (unsigned)nbB - 1;
    }
    __syncthreads();
    if (!last) return;

    // The last block: every column block has read h, base[k] and w[h] and
    // written its partial.
    __threadfence();
    seq::PostIn<V> in{};
    if (tid == 0) in = seq::post_load(s);
    x = none;
    for (int q = tid; q < nbB; q += NT)
        take_first(x, RowCands<V>{
                (V)__ldcg(ws.key + q), __ldcg(ws.idx + q),
                (V)__ldcg(ws.val + q), (V)__ldcg(ws.key1 + q),
                __ldcg(ws.idx1 + q), (V)__ldcg(ws.val1 + q),
                (V)__ldcg(ws.bval + q), __ldcg(ws.bidx + q),
                (V)__ldcg(ws.wmax + q)});
    block_fold<NW>(x, unused, none, warps, wany);
    if (SLICE) {
        // The slice's candidates into the send buffers as global indices,
        // the weights at them (read past L1: every column block stored its
        // weights before its ticket), and the slice's largest weight; no
        // re-anchor (the next eta_fold_column decides it on the largest of
        // every rank's) and no next step before (it needs the fold).
        if (tid != 0) return;
        const bool has = x.bidx != BIG_INDEX;
        so.send_v[0] = (double)x.val;
        so.send_v[1] = has ? (double)x.bval : (double)CUDART_INF;
        so.send_i[0] = so.offset + x.idx;
        so.send_i[1] = has ? so.offset + x.bidx : BIG_INDEX;
        if (devex) {
            so.send_v[2] = (double)__ldcg(w + x.idx);
            so.send_v[3] = has ? (double)__ldcg(w + x.bidx) : 1.0;
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
        return colk_prior::colk_run<T, V, 2 * COLK_THREADS, true, SLICE>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, true, st, so);
    return colk_prior::colk_run<T, V, COLK_THREADS, true, SLICE>(
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
    return colk_prior::colk_any<T, V, true>(
            Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len, step,
            pol, rows, cols, stage, st, so);
}

}  // namespace colk_prior

#ifdef ETA_VARIANTS_LIB

extern "C" {

// eta_fold_column_launch's operands (the form before its redesign).
int prior_eta_fold_column_launch(const void *Tt, const void *C,
                                 const void *F, void *ah, int M, int R,
                                 int L, int t, int offset, const double *V,
                                 const int *I, const double *W, int P, int kv,
                                 void *w, void *wh, const void *step,
                                 long long max_iter, double eps, int pair,
                                 int rows, int stage, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return slice_prior::fold_column_run<double, double>(
                Tt, C, F, ah, M, R, L, t, offset, V, I, W, P, kv, w, wh, step,
                max_iter, eps, rows, stage, st);
    case PAIR_MIXED:
        return slice_prior::fold_column_run<float, double>(
                Tt, C, F, ah, M, R, L, t, offset, V, I, W, P, kv, w, wh, step,
                max_iter, eps, rows, stage, st);
    case PAIR_F32:
        return slice_prior::fold_column_run<float, float>(
                Tt, C, F, ah, M, R, L, t, offset, V, I, W, P, kv, w, wh, step,
                max_iter, eps, rows, stage, st);
    }
    return (int)cudaErrorInvalidValue;
}

// b ah M eps, an eta_workspace and its bytes, the scalars' pointers,
// pair, eta_ratio's rows a block, stream.
int prior_eta_ratio_summed_launch(const void *b, void *ah, int M, double eps,
                                  unsigned char *ws, long long ws_len,
                                  const void *step, int pair, int rows,
                                  void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return slice_prior::ratio_summed_run<double, double>(
                b, ah, M, eps, ws, ws_len, step, rows, st);
    case PAIR_MIXED:
        return slice_prior::ratio_summed_run<float, double>(
                b, ah, M, eps, ws, ws_len, step, rows, st);
    case PAIR_F32:
        return slice_prior::ratio_summed_run<float, float>(
                b, ah, M, eps, ws, ws_len, step, rows, st);
    }
    return (int)cudaErrorInvalidValue;
}

// eta_colk_slice_launch's operands (the form before its candidates carried
// their weights).
int prior_eta_colk_slice_launch(const void *Tt, void *C, void *F,
                                void *costs, void *b, int *base, void *w,
                                const void *ah, int M, int R, int L, int r,
                                int t, double eps, unsigned char *ws,
                                long long ws_len, const void *step,
                                long long max_iter, int bland_mode,
                                int threshold, int pair, int rows, int cols,
                                int stage, int offset, const void *wh,
                                double *send_v, int *send_i, double *send_w,
                                void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const seq::Policy pol{max_iter, eps, bland_mode, threshold, 0};
    switch (pair) {
    case PAIR_F64:
        return colk_prior::colk_slice_any<double, double>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, offset, wh, send_v, send_i,
                send_w, st);
    case PAIR_MIXED:
        return colk_prior::colk_slice_any<float, double>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, offset, wh, send_v, send_i,
                send_w, st);
    case PAIR_F32:
        return colk_prior::colk_slice_any<float, float>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, offset, wh, send_v, send_i,
                send_w, st);
    }
    return (int)cudaErrorInvalidValue;
}

// eta_colk_launch's operands (the single-card kernel before).
int prior_eta_colk_launch(const void *Tt, void *C, void *F, void *costs,
                          void *b, int *base, void *w, const void *ah, int M,
                          int R, int L, int r, int t, double eps,
                          unsigned char *ws, long long ws_len,
                          const void *step, long long max_iter,
                          int bland_mode, int threshold, int then_pre,
                          int pair, int rows, int cols, int stage,
                          void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const seq::Policy pol{max_iter, eps, bland_mode, threshold, then_pre};
    switch (pair) {
    case PAIR_F64:
        return colk_prior::colk_any<double, double>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, st);
    case PAIR_MIXED:
        return colk_prior::colk_any<float, double>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, st);
    case PAIR_F32:
        return colk_prior::colk_any<float, float>(
                Tt, C, F, costs, b, base, w, ah, M, R, L, r, t, ws, ws_len,
                step, pol, rows, cols, stage, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#else  // the program

// ---------------------------------------------------------------------------
// The head's forms the port does not ship, timed against its own.

namespace slice_forms {

// eta_fold_column with the fold in one warp (WARP; slice_fold_warp) or in
// thread 0 (slice_prior::slice_fold), and with the rank's own candidates'
// columns sent for before the fold (PREFETCH: Tt's into registers, C's
// into a slot a candidate beside the slab) or h's column loaded after it
// (PR 25's order). In every form non-owners store their zeros before they
// wait for their slab, and the ratio test may launch once the fold is done.
template <typename T, typename V, int NT, bool FIXED, bool PREFETCH,
          bool WARP>
__global__ void __launch_bounds__(NT) fold_kernel(
        const T *__restrict__ Tt, const T *__restrict__ C,
        const T *__restrict__ F, T *__restrict__ ah, int M, int R, int t,
        int rows, int stage, int offset, const double *__restrict__ Vg,
        const int *__restrict__ Ig, const double *__restrict__ Wg, int P,
        int kv, const int *__restrict__ own, V *__restrict__ w,
        V *__restrict__ wh, SeqStep<T, V> s, long long max_iter,
        double eps) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ int col, slot;     // h's local column and its slot, or -1
    __shared__ bool reset;
    const int tid = threadIdx.x;
    const int j0 = blockIdx.x * rows;
    const int nrow = min(rows, M - j0);
    const int j = j0 + tid;                      // this thread's row
    const bool row = tid < nrow;
    const int W = slab_width(rows, sizeof(T));
    const Slab<T, NT, FIXED> slab{F, (size_t)M, j0, nrow, t, stage, W,
                                  reinterpret_cast<T *>(dyn)};
    const int ki = kv == SLICE_KV ? SLICE_KI : 2;
    const size_t cw = round16((long long)t * sizeof(T)) / sizeof(T);
    T *cs = slab.buf + (size_t)min(t, 2 * stage) * W;

    slab.first();
    RankPack pk{};
    int status = 0, iterations = 0;
    bool bland = false;
    if (WARP && tid < 32) pk = rank_pack(Vg, Ig, Wg, P, kv);
    if (tid == 0) {
        status = *s.status;
        iterations = *s.iterations;
        bland = *s.bland != 0;
    }
    int loc[SLICE_KI];                           // local columns, or -1
    T th[SLICE_KI];
#pragma unroll
    for (int c = 0; c < SLICE_KI; ++c) {
        const long long l =
                PREFETCH && c < ki ? (long long)own[c] - offset : -1;
        loc[c] = l >= 0 && l < R ? (int)l : -1;
        th[c] = (T)0;
        bool fresh = loc[c] >= 0;
#pragma unroll
        for (int e = 0; e < c; ++e) fresh &= loc[e] != loc[c];
        if (fresh) {
            if (row) th[c] = Tt[(size_t)j * R + loc[c]];
            for (int q = tid; q < t; q += NT)
                cp_async_elem<sizeof(T)>(cs + c * cw + q,
                                         C + (size_t)q * R + loc[c]);
        }
    }
    if (PREFETCH) cp_async_commit();

    if (tid < 32) {
        SliceFold f{};
        if constexpr (WARP)
            f = slice_fold_warp(pk, P, kv);
        else if (tid == 0)
            f = slice_prior::slice_fold(Vg, Ig, Wg, P, kv);
        if (tid == 0) {
            const seq::Candidates<V> c{f.h_d, (V)f.v_d, f.h_b, (V)f.v_b};
            const bool use_b = bland && c.h_b < BIG_INDEX;
            const long long l = (long long)(use_b ? c.h_b : c.h_d) - offset;
            const int hl = l >= 0 && l < R ? (int)l : -1;
            int sl = -1;
#pragma unroll
            for (int e = SLICE_KI - 1; e >= 0; --e)
                if (hl >= 0 && loc[e] == hl) sl = e;
            col = hl;
            slot = sl;
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
    grid_launch_next();
    if (w != nullptr && reset)
        for (int q = blockIdx.x * NT + tid; q < R; q += gridDim.x * NT)
            w[q] = (V)1;
    const int hl = col, sl = slot;
    if (hl < 0) {                                // another rank's column
        if (row) ah[j] = (T)0;
        cp_async_wait<0>();
        return;
    }
    T th_h;
    const T *ch;
    if (sl >= 0) {
        th_h = sl == 0 ? th[0] : sl == 1 ? th[1] : th[2];
        ch = cs + sl * cw;
        cp_async_wait<0>();
    } else {
        if (PREFETCH) {          // into slot 0, once every copy has landed
            cp_async_wait<0>();
            __syncthreads();
        }
        for (int q = tid; q < t; q += NT) cs[q] = C[(size_t)q * R + hl];
        th_h = row ? Tt[(size_t)j * R + hl] : (T)0;
        ch = cs;
    }
    const double acc = slab.sum(ch);
    if (row) ah[j] = (T)__dsub_rn((double)th_h, acc);
}

// slab_smem with ``coefs`` slots of t coefficients beside the slab's
// rounds (a candidate's each, under PREFETCH).
template <typename T>
long long fold_smem(int M, int R, int L, int t, int width, int stage,
                    int coefs) {
    const int item = sizeof(T);
    if (slab_smem<T>(M, R, L, t, width, RATIO_THREADS, stage) < 0 ||
        2LL * stage * slab_width(width, item) * item +
                        coefs * round16((long long)L * item) >
                BLOCK_SMEM - SMEM_RESERVE)
        return -1;
    return smem_bytes(width, stage, t, item) +
           (coefs - 1) * round16((long long)t * item);
}

template <typename T, typename V, bool PREFETCH, bool WARP>
int fold_run(const void *Tt, const void *C, const void *F, void *ah, int M,
             int R, int L, int t, int offset, const double *Vg, const int *Ig,
             const double *Wg, int P, int kv, const int *own, void *w,
             void *wh, const void *step, long long max_iter, double eps,
             int rows, int stage, cudaStream_t st) {
    constexpr auto kernel =
            fold_kernel<T, V, RATIO_THREADS, true, PREFETCH, WARP>;
    const bool devex = kv == SLICE_KV;
    const long long smem = fold_smem<T>(
            M, R, L, t, rows, stage, PREFETCH ? (devex ? SLICE_KI : 2) : 1);
    if (P < 1 || (WARP && P > 32) || (kv != 2 && !devex) || smem < 0 ||
        !allow_smem<kernel>(smem))
        return (int)cudaErrorInvalidValue;
    return launch(kernel, cdiv(M, rows), RATIO_THREADS, smem, false, st,
                  static_cast<const T *>(Tt), static_cast<const T *>(C),
                  static_cast<const T *>(F), static_cast<T *>(ah), M, R, t,
                  rows, stage, offset, Vg, Ig, Wg, P, kv, own,
                  static_cast<V *>(w), static_cast<V *>(wh),
                  step_of<T, V>(step), max_iter, eps);
}

// The ratio test as one cluster of NB blocks, with or without
// programmatic dependent launch.
template <typename T, typename V, int NB>
int ratio_run(const void *b, void *ah, int M, double eps, const void *step,
              bool pdl, cudaStream_t st) {
    auto kernel = eta_ratio_summed_kernel<T, V, NB, SUMMED_THREADS,
                                          SUMMED_PER>;
    static const cudaError_t e = allow_cluster(kernel, NB);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, NB, SUMMED_THREADS, pdl, st,
                          static_cast<const V *>(b), static_cast<T *>(ah), M,
                          eps, step_of<T, V>(step));
}

}  // namespace slice_forms

// ---------------------------------------------------------------------------
// eta_colk_slice's forms the port does not ship, timed against its own
// (the weights carried, no fence beside the ticket): with CARRY false the
// last block reads the weights at its candidates back past L1 after the
// fold, as the form before did; with FENCE a __threadfence before the
// ticket and after it, as the form before had; with CL > 1 the column
// blocks in clusters of CL whose blocks fold over distributed shared
// memory, so that one block a cluster writes a partial and takes the
// ticket and the last folds nbB / CL partials.

namespace colk_forms {

template <typename T, typename V, int NT, int CL, bool CARRY, bool FENCE>
__global__ void __launch_bounds__(NT) form_kernel(
        const T *__restrict__ Tt, T *__restrict__ C, T *__restrict__ F,
        V *__restrict__ costs, V *__restrict__ b, int *__restrict__ base,
        V *__restrict__ w, const T *__restrict__ ah, int M, int R, int r,
        int t, int cols, int stage, int nbA, int nbB,
        unsigned char *__restrict__ ws_bytes, SeqStep<T, V> s,
        seq::Policy pol, SliceOut<V> so) {
    constexpr int NW = NT / 32;
    const int tid = threadIdx.x;
    if ((int)blockIdx.x >= nbB) {                // nbB: a multiple of CL
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

    using Cand = RowCands<V, CARRY>;
    namespace cg = cooperative_groups;
    const int crank = CL > 1 ? (int)cg::this_cluster().block_rank() : 0;
    if (CL > 1) cluster_arrive_relaxed();
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ Cand warps[NW];
    __shared__ Cand parts[CL];                   // the leader's: the blocks'
    __shared__ int wany[NW];
    __shared__ bool last;
    const WsB ws(ws_bytes, nbA, nbB);
    const int i0 = blockIdx.x * cols;
    const int ncol = max(0, min(cols, R - i0));
    const int i = i0 + tid;
    const bool col = tid < ncol;
    const int W = slab_width(cols, sizeof(T));
    const Slab<T, NT, true> slab{C, (size_t)R, min(i0, R - 1), ncol, t,
                                 stage, W, reinterpret_cast<T *>(dyn)};
    T *fk = slab.buf + (size_t)min(t, 2 * stage) * W;

    if (ncol > 0) slab.first();                  // padding blocks: none
    const bool devex = w != nullptr;
    V c = (V)0, wi = (V)0;
    if (col) {
        c = costs[i];
        if (devex) wi = w[i];
    }
    grid_wait();
    grid_launch_next();
    const int h_raw = *s.h;
    const T p = *s.p;
    const V u = *s.u;
    const int k = min(*s.k, M - 1);
    const bool d = *s.do_ != 0;
    for (int q = tid; q < t; q += NT) fk[q] = F[(size_t)q * M + k];
    const T tk = col ? Tt[(size_t)k * R + i] : (T)0;
    V wh = (V)0;
    int lvar = -1;
    if (devex && d) {
        wh = *so.wh;
        lvar = base[k] - so.offset;
    }
    const double acc = ncol > 0 ? slab.sum(fk) : 0.0;

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
        const V cm = i < r ? c : inf<V>();
        const bool elig = cm <= -(V)pol.eps;
        if (devex) {
            if (d) {
                const V alpha = (V)div_rn(ck, p);
                V w2 = max_nan(wi, mul_rn(mul_rn(alpha, alpha), wh));
                if (i == lvar)
                    w2 = max_nan(div_rn(wh, (V)mul_rn(p, p)), (V)1);
                w2 = min_nan(w2, (V)1e12);
                if (w2 != w2) w2 = (V)1;
                w[i] = w2;
                wi = w2;
            }
            x.wmax = wi;
            if constexpr (CARRY) x.wv = wi;
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
            if constexpr (CARRY) x.bw = wi;
        }
    }
    // The block's fold, its result into the leader's shared memory, one
    // cluster barrier, the leader's warp over the CL results, then its
    // partial and the ticket.
    bool unused = false;
    block_fold<NW>(x, unused, none, warps, wany);
    if (CL > 1) {
        cluster_wait();                          // every block runs
        if (tid == 0)
            *cg::this_cluster().map_shared_rank(&parts[crank], 0) = x;
        cluster_arrive();
        cluster_wait();
        if (crank != 0) return;
    }
    if (tid < 32) {
        if (CL > 1) x = seq::warp_fold(tid < CL ? parts[tid] : none);
        if (tid == 0) {
            const int q = blockIdx.x / CL;
            ws.key[q] = (double)x.key;
            ws.val[q] = (double)x.val;
            ws.key1[q] = (double)x.key1;
            ws.val1[q] = (double)x.val1;
            ws.bval[q] = (double)x.bval;
            ws.wmax[q] = (double)x.wmax;
            ws.idx[q] = x.idx;
            ws.idx1[q] = x.idx1;
            ws.bidx[q] = x.bidx;
            if constexpr (CARRY) {
                ws.wv[q] = (double)x.wv;
                ws.bw[q] = (double)x.bw;
            }
            if (FENCE) __threadfence();
            last = ticket(ws.counter) == (unsigned)(nbB / CL) - 1;
        }
    }
    __syncthreads();
    if (!last) return;

    if (FENCE) __threadfence();
    seq::PostIn<V> in{};
    if (tid == 0) in = seq::post_load(s);
    x = none;
    for (int q = tid; q < nbB / CL; q += NT) {
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
        if constexpr (CARRY) {
            o.wv = (V)__ldcg(ws.wv + q);
            o.bw = (V)__ldcg(ws.bw + q);
        }
        take_first(x, o);
    }
    block_fold<NW>(x, unused, none, warps, wany);
    if (tid != 0) return;
    const bool has = x.bidx != BIG_INDEX;
    so.send_v[0] = (double)x.val;
    so.send_v[1] = has ? (double)x.bval : (double)CUDART_INF;
    so.send_i[0] = so.offset + x.idx;
    so.send_i[1] = has ? so.offset + x.bidx : BIG_INDEX;
    if (devex) {
        if constexpr (CARRY) {
            so.send_v[2] = (double)x.wv;
            so.send_v[3] = has ? (double)x.bw : 1.0;
        } else {
            so.send_v[2] = (double)__ldcg(w + x.idx);
            so.send_v[3] = has ? (double)__ldcg(w + x.bidx) : 1.0;
        }
        so.send_v[4] = (double)x.key;
        so.send_v[5] = (double)x.val1;
        so.send_v[6] = (double)x.key1;
        so.send_i[2] = so.offset + x.idx1;
        *so.send_w = (double)x.wmax;
    }
    if (d) base[k] = h_raw;
    *ws.counter = 0;
    seq::post(s, in, d, seq::Candidates<V>{}, pol);
}

// A form on the shipped plan: the column blocks padded to a multiple of
// CL, the row blocks after them, the grid a multiple of CL; a programmatic
// dependent launch.
template <typename T, typename V, int NT, int CL, bool CARRY, bool FENCE>
int form_run(const void *Tt, void *C, void *F, void *costs, void *b,
                int *base, void *w, const void *ah, int M, int R, int L,
                int r, int t, unsigned char *ws, long long ws_len,
                const void *step, const seq::Policy &pol, int rows, int cols,
                int stage, const SliceOut<V> &so, cudaStream_t st) {
    constexpr auto kernel = form_kernel<T, V, NT, CL, CARRY, FENCE>;
    const long long smem = prepare<T>(M, R, L, t, cols, NT, rows, cols,
                                      stage, ws_len);
    if (smem < 0 || !allow_smem<kernel>(smem))
        return (int)cudaErrorInvalidValue;
    const int nbA = cdiv(M, rows);
    const int nbB = cdiv(cdiv(R, cols), CL) * CL;
    const int grid = cdiv(nbB + cdiv(M, NT), CL) * CL;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3((unsigned)NT);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = CL;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = CL > 1 ? 2 : 1;               // CL 1: no cluster
    const cudaError_t e = cudaLaunchKernelEx(
            &cfg, kernel, static_cast<const T *>(Tt), static_cast<T *>(C),
            static_cast<T *>(F), static_cast<V *>(costs),
            static_cast<V *>(b), base, static_cast<V *>(w),
            static_cast<const T *>(ah), M, R, r, t, cols, stage, nbA, nbB,
            ws, step_of<T, V>(step), pol, so);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace colk_forms

// ---------------------------------------------------------------------------
// The kernels the port launched before, verbatim (their helpers, the
// workspace's layout and the candidates' folds are the shipped file's,
// the candidates without carried weights).

namespace prior {

constexpr int ROWS_A = 64;
constexpr int COLS_B = 128;
constexpr int STAGE = 128;

template <typename T, typename V>
__global__ void __launch_bounds__(ROWS_A) eta_ratio_kernel(
        const T *__restrict__ Tt, const T *__restrict__ C,
        const T *__restrict__ F, const V *__restrict__ b,
        T *__restrict__ ah, int M, int R, int t, double eps, int nbA,
        unsigned char *__restrict__ ws_bytes, SeqStep<T, V> s) {
    constexpr int NW = ROWS_A / 32;
    __shared__ T cs[STAGE];                      // C[s0 + q, h]
    __shared__ Ratio<T, V> warps[NW];
    __shared__ int wany[NW];
    __shared__ bool last;
    const WsA ws(ws_bytes, nbA);
    const int tid = threadIdx.x;
    const int j = blockIdx.x * ROWS_A + tid;     // this thread's row
    const bool row = j < M;
    const int h = min(*s.h, R - 1);
    T th = (T)0;
    V bj = (V)0;
    if (row) {
        th = Tt[(size_t)j * R + h];
        bj = b[j];
    }

    // a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] F[s, j], s in order from 0,
    // in f64.
    double acc = 0.0;
    for (int s0 = 0; s0 < t; s0 += STAGE) {
        const int n = min(STAGE, t - s0);
        __syncthreads();                         // the stage before is read
        for (int q = tid; q < n; q += ROWS_A)
            cs[q] = C[(size_t)(s0 + q) * R + h];
        __syncthreads();
        if (row) {
            const T *f = F + (size_t)s0 * M + j;
#pragma unroll 8
            for (int q = 0; q < n; ++q)
                acc = __dadd_rn(acc, __dmul_rn((double)cs[q],
                                               (double)f[(size_t)q * M]));
        }
    }

    const Ratio<T, V> none{inf<V>(), BIG_INDEX, (T)0, (V)0};
    Ratio<T, V> x = none;
    bool any = false;
    if (row) {
        const T a = (T)__dsub_rn((double)th, acc);
        ah[j] = a;
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
    for (int q = tid; q < nbA; q += ROWS_A) {
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

template <typename T, typename V>
__global__ void __launch_bounds__(COLS_B) eta_colk_kernel(
        const T *__restrict__ Tt, T *__restrict__ C, T *__restrict__ F,
        V *__restrict__ costs, V *__restrict__ b, int *__restrict__ base,
        V *__restrict__ w, const T *__restrict__ ah, int M, int R, int r,
        int t, int nbA, int nbB, unsigned char *__restrict__ ws_bytes,
        SeqStep<T, V> s, seq::Policy pol) {
    constexpr int NW = COLS_B / 32;
    const int tid = threadIdx.x;
    const int k = min(*s.k, M - 1);
    const bool d = *s.do_ != 0;
    if ((int)blockIdx.x >= nbB) {
        // The row blocks: F[t] and b (whole blocks return together).
        const int j = (blockIdx.x - nbB) * COLS_B + tid;
        if (j >= M) return;
        T *frow = F + (size_t)t * M;
        if (!d) {
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

    __shared__ T fk[STAGE];                      // F[s0 + q, k]
    __shared__ RowCands<V, false> warps[NW];
    __shared__ int wany[NW];
    __shared__ bool last, anchor;
    const WsB ws(ws_bytes, nbA, nbB);
    const int i = blockIdx.x * COLS_B + tid;     // this thread's column
    const bool col = i < R;
    const int h_raw = *s.h;
    const int h = min(h_raw, R - 1);
    const bool devex = w != nullptr;
    const T p = *s.p;
    const V u = *s.u;
    T tk = (T)0;
    V c = (V)0, wi = (V)0;
    if (col) {
        tk = Tt[(size_t)k * R + i];
        c = costs[i];
        if (devex) wi = w[i];
    }
    V wh = (V)0;
    int lvar = -1;
    if (devex && d) {                            // before the last block's
        wh = w[h];                               // stores
        lvar = base[k];
    }

    // colk[i] = Tt[k, i] - sum_{s<t} F[s, k] C[s, i], s in order from 0,
    // in f64.
    double acc = 0.0;
    for (int s0 = 0; s0 < t; s0 += STAGE) {
        const int n = min(STAGE, t - s0);
        __syncthreads();                         // the stage before is read
        for (int q = tid; q < n; q += COLS_B)
            fk[q] = F[(size_t)(s0 + q) * M + k];
        __syncthreads();
        if (col) {
            const T *cc = C + (size_t)s0 * R + i;
#pragma unroll 8
            for (int q = 0; q < n; ++q)
                acc = __dadd_rn(acc, __dmul_rn((double)fk[q],
                                               (double)cc[(size_t)q * R]));
        }
    }

    const RowCands<V, false> none{-inf<V>(), BIG_INDEX, inf<V>(), -inf<V>(),
                           BIG_INDEX, inf<V>(), inf<V>(), BIG_INDEX, (V)0};
    RowCands<V, false> x = none;
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
                if (i == h)
                    *ws.wh = (double)w2;         // the last block stores it
                else
                    w[i] = w2;
                wi = w2;
                x.wmax = w2;
            }
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
        }
    }
    // The block's fold (its barrier orders the stores above before thread
    // 0's fence), the partial, then the ticket.
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
        __threadfence();
        last = ticket(ws.counter) == (unsigned)nbB - 1;
    }
    __syncthreads();
    if (!last) return;

    // The last block: every column block has read h, base[k] and w[h] and
    // written its partial.
    __threadfence();
    seq::PostIn<V> in{};
    if (tid == 0) in = seq::post_load(s);
    x = none;
    for (int q = tid; q < nbB; q += COLS_B)
        take_first(x, RowCands<V, false>{
                (V)__ldcg(ws.key + q), __ldcg(ws.idx + q),
                (V)__ldcg(ws.val + q), (V)__ldcg(ws.key1 + q),
                __ldcg(ws.idx1 + q), (V)__ldcg(ws.val1 + q),
                (V)__ldcg(ws.bval + q), __ldcg(ws.bidx + q),
                (V)__ldcg(ws.wmax + q)});
    block_fold<NW>(x, unused, none, warps, wany);
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
            for (int q = tid; q < R; q += COLS_B) w[q] = (V)1;
    }
}

template <typename T, typename V>
int ratio_run(const void *Tt, const void *C, const void *F, const void *b,
              void *ah, int M, int R, int L, int t, double eps,
              unsigned char *ws, long long ws_len, const void *step,
              cudaStream_t st) {
    if (M < 1 || R < 1 || t < 0 || t >= L) return (int)cudaErrorInvalidValue;
    const int nbA = cdiv(M, ROWS_A), nbB = cdiv(R, COLS_B);
    if (ws_len < (long long)ws_bytes(nbA, nbB))
        return (int)cudaErrorInvalidValue;       // workspace too small
    eta_ratio_kernel<T, V><<<nbA, ROWS_A, 0, st>>>(
            static_cast<const T *>(Tt), static_cast<const T *>(C),
            static_cast<const T *>(F), static_cast<const V *>(b),
            static_cast<T *>(ah), M, R, t, eps, nbA, ws, step_of<T, V>(step));
    return (int)cudaGetLastError();
}

template <typename T, typename V>
int colk_run(const void *Tt, void *C, void *F, void *costs, void *b,
             int *base, void *w, const void *ah, int M, int R, int L, int r,
             int t, unsigned char *ws, long long ws_len, const void *step,
             const seq::Policy &pol, cudaStream_t st) {
    if (M < 1 || R < 1 || t < 0 || t >= L) return (int)cudaErrorInvalidValue;
    const int nbA = cdiv(M, ROWS_A), nbB = cdiv(R, COLS_B);
    if (ws_len < (long long)ws_bytes(nbA, nbB))
        return (int)cudaErrorInvalidValue;       // workspace too small
    eta_colk_kernel<T, V><<<nbB + cdiv(M, COLS_B), COLS_B, 0, st>>>(
            static_cast<const T *>(Tt), static_cast<T *>(C),
            static_cast<T *>(F), static_cast<V *>(costs),
            static_cast<V *>(b), base, static_cast<V *>(w),
            static_cast<const T *>(ah), M, R, r, t, nbA, nbB, ws,
            step_of<T, V>(step), pol);
    return (int)cudaGetLastError();
}

}  // namespace prior

// ---------------------------------------------------------------------------
// The harness.

namespace {

// Device fill: a value in [lo, hi) from a hash of the index and a seed.
__global__ void fill_kernel(double *out, size_t n, unsigned seed, double lo,
                            double hi) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        unsigned long long x = (i + 1) * 0x9E3779B97F4A7C15ull + seed;
        x ^= x >> 31;
        x *= 0xBF58476D1CE4E5B9ull;
        x ^= x >> 29;
        out[i] = lo + (hi - lo) * (double)(x >> 11) * (1.0 / 9007199254740992.0);
    }
}
template <typename T>
__global__ void narrow_kernel(T *out, const double *in, size_t n) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x)
        out[i] = (T)in[i];
}

// n uniform values of T in [lo, hi) into out (a scratch of n doubles).
template <typename T>
void fill(T *out, size_t n, unsigned seed, double lo, double hi,
          double *scratch) {
    fill_kernel<<<1024, 256>>>(scratch, n, seed, lo, hi);
    narrow_kernel<T><<<1024, 256>>>(out, scratch, n);
    CK(cudaGetLastError());
}

// The scalars: field i of kernels.seq.SeqScalars at byte 16 i of one
// device buffer.
constexpr int NSCAL = 19;
enum Field {
    STATUS, ITERS, STALL, BLAND, Z, H_D, V_D, H_B, V_B, ACTIVE, H, MINC,
    OPTIMAL_, K, BK, UNB, DO, P, U
};

template <typename T, typename V>
struct Prob {
    int M, R, L;
    T *Tt, *C, *F, *ah, *C0, *F0;
    V *b, *costs, *w;
    int *base;
    unsigned char *ws, *scal;
    long long ws_len;
    // The state one pivot starts from (the vectors, C and F's rows t).
    std::vector<unsigned char> h_scal;
    V *b0, *costs0, *w0;
    int *base0;

    SeqStep<T, V> step() const {
        void *p[NSCAL];
        for (int i = 0; i < NSCAL; ++i) p[i] = scal + 16 * i;
        SeqStep<T, V> s;
        memcpy(&s, p, sizeof s);
        return s;
    }
    template <typename X>
    void set(Field f, X v) {
        memcpy(h_scal.data() + 16 * f, &v, sizeof v);
    }
};

template <typename T, typename V>
Prob<T, V> make(int M, int R, int L, unsigned seed) {
    Prob<T, V> p{};
    p.M = M;
    p.R = R;
    p.L = L;
    const size_t big = std::max((size_t)M * R, (size_t)L * (M + R));
    double *scratch;
    CK(cudaMalloc(&scratch, big * sizeof(double)));
    CK(cudaMalloc(&p.Tt, (size_t)M * R * sizeof(T)));
    CK(cudaMalloc(&p.C, (size_t)L * R * sizeof(T)));
    CK(cudaMalloc(&p.F, (size_t)L * M * sizeof(T)));
    CK(cudaMalloc(&p.C0, (size_t)L * R * sizeof(T)));
    CK(cudaMalloc(&p.F0, (size_t)L * M * sizeof(T)));
    CK(cudaMalloc(&p.ah, M * sizeof(T)));
    for (V **v : {&p.b, &p.b0}) CK(cudaMalloc(v, M * sizeof(V)));
    for (V **v : {&p.costs, &p.w, &p.costs0, &p.w0})
        CK(cudaMalloc(v, R * sizeof(V)));
    for (int **v : {&p.base, &p.base0}) CK(cudaMalloc(v, M * sizeof(int)));
    // Large enough for any grid below: 64 bytes a block at one row or
    // column a block.
    p.ws_len = 16 + 32 * (long long)M + 64 * (long long)R;
    CK(cudaMalloc(&p.ws, p.ws_len));
    CK(cudaMemset(p.ws, 0, p.ws_len));
    CK(cudaMalloc(&p.scal, 16 * NSCAL));
    fill(p.Tt, (size_t)M * R, seed, -1.0, 1.0, scratch);
    fill(p.C, (size_t)L * R, seed + 1, -0.1, 0.1, scratch);
    fill(p.F, (size_t)L * M, seed + 2, -0.1, 0.1, scratch);
    CK(cudaMemcpy(p.C0, p.C, (size_t)L * R * sizeof(T),
                  cudaMemcpyDeviceToDevice));
    CK(cudaMemcpy(p.F0, p.F, (size_t)L * M * sizeof(T),
                  cudaMemcpyDeviceToDevice));
    fill(p.b0, M, seed + 3, 0.0, 1.0, scratch);
    fill(p.costs0, R, seed + 4, -1.0, 1.0, scratch);
    fill(p.w0, R, seed + 5, 1.0, 2.0, scratch);
    std::vector<int> base(M);
    for (int j = 0; j < M; ++j) base[j] = (int)((j * 7919LL) % R);
    CK(cudaMemcpy(p.base0, base.data(), M * sizeof(int),
                  cudaMemcpyHostToDevice));
    CK(cudaDeviceSynchronize());
    CK(cudaFree(scratch));
    p.h_scal.assign(16 * NSCAL, 0);
    return p;
}

template <typename T, typename V>
void release(Prob<T, V> &p) {
    for (void *x : {(void *)p.Tt, (void *)p.C, (void *)p.F, (void *)p.ah,
                    (void *)p.b, (void *)p.costs, (void *)p.w,
                    (void *)p.base, (void *)p.ws, (void *)p.scal,
                    (void *)p.b0, (void *)p.costs0, (void *)p.w0,
                    (void *)p.base0, (void *)p.C0, (void *)p.F0})
        CK(cudaFree(x));
}

// The state a pivot starts from: the vectors, C[t] and F[t] set to a
// pattern, the scalars from h_scal, the ah and the counters zeroed.
template <typename T, typename V>
void reset(Prob<T, V> &p, int t) {
    CK(cudaMemcpy(p.b, p.b0, p.M * sizeof(V), cudaMemcpyDeviceToDevice));
    CK(cudaMemcpy(p.costs, p.costs0, p.R * sizeof(V),
                  cudaMemcpyDeviceToDevice));
    CK(cudaMemcpy(p.w, p.w0, p.R * sizeof(V), cudaMemcpyDeviceToDevice));
    CK(cudaMemcpy(p.base, p.base0, p.M * sizeof(int),
                  cudaMemcpyDeviceToDevice));
    CK(cudaMemset(p.C + (size_t)t * p.R, 0x7f, p.R * sizeof(T)));
    CK(cudaMemset(p.F + (size_t)t * p.M, 0x7f, p.M * sizeof(T)));
    CK(cudaMemset(p.ah, 0, p.M * sizeof(T)));
    CK(cudaMemset(p.ws, 0, 16));
    CK(cudaMemcpy(p.scal, p.h_scal.data(), 16 * NSCAL,
                  cudaMemcpyHostToDevice));
}

// Everything a pivot writes, as bytes.
template <typename T, typename V>
std::vector<unsigned char> outputs(const Prob<T, V> &p, int t) {
    std::vector<unsigned char> out;
    auto grab = [&](const void *d, size_t n) {
        const size_t at = out.size();
        out.resize(at + n);
        CK(cudaMemcpy(out.data() + at, d, n, cudaMemcpyDeviceToHost));
    };
    CK(cudaDeviceSynchronize());
    grab(p.scal, 16 * NSCAL);
    grab(p.ah, p.M * sizeof(T));
    grab(p.C + (size_t)t * p.R, p.R * sizeof(T));
    grab(p.F + (size_t)t * p.M, p.M * sizeof(T));
    grab(p.b, p.M * sizeof(V));
    grab(p.costs, p.R * sizeof(V));
    grab(p.w, p.R * sizeof(V));
    grab(p.base, p.M * sizeof(int));
    grab(p.ws, 8);                               // both counters back at 0
    return out;
}

// A form of the pivot: its two launches, each with its grid, threads,
// slab rows a round (0: as many as two rounds fit, at most 128), and as a
// programmatic dependent launch or not; ``fixed`` false copies every slab
// row by the general path (a 16-byte copy a whole chunk, found by
// division), as unaligned rows are.
struct Form {
    std::string name;
    int rows, cols, nt_a, nt_b;                  // 0: prior
    int stage_a, stage_b;
    bool pdl_a, pdl_b;
    bool fixed;
};

// The most slab rows a round whose two rounds fit beside the window's
// coefficients in a block's shared memory, at most 128.
int max_stage(int width, int L, int item) {
    const long long row = (long long)slab_width(width, item) * item;
    const long long room =
            BLOCK_SMEM - SMEM_RESERVE - round16((long long)L * item);
    return (int)std::min<long long>(128, room / (2 * row));
}

template <typename T, typename V>
int ratio_form(const Form &f, Prob<T, V> &p, int t, double eps,
               const SeqStep<T, V> &s, cudaStream_t st) {
    if (f.rows == 0)
        return prior::ratio_run<T, V>(p.Tt, p.C, p.F, p.b, p.ah, p.M, p.R, p.L,
                                     t, eps, p.ws, p.ws_len, &s, st);
    const int stage = f.stage_a ? f.stage_a : max_stage(f.rows, p.L, sizeof(T));
    if (!f.fixed)
        return ratio_run<T, V, 128, false>(p.Tt, p.C, p.F, p.b, p.ah, p.M,
                                           p.R, p.L, t, eps, p.ws, p.ws_len,
                                           &s, f.rows, f.cols, stage, f.pdl_a,
                                           st);
    if (f.nt_a == 64)
        return ratio_run<T, V, 64>(p.Tt, p.C, p.F, p.b, p.ah, p.M, p.R, p.L,
                                   t, eps, p.ws, p.ws_len, &s, f.rows, f.cols,
                                   stage, f.pdl_a, st);
    return ratio_run<T, V, 128>(p.Tt, p.C, p.F, p.b, p.ah, p.M, p.R, p.L, t,
                                eps, p.ws, p.ws_len, &s, f.rows, f.cols,
                                stage, f.pdl_a, st);
}

template <typename T, typename V>
int colk_form(const Form &f, Prob<T, V> &p, int t, double eps,
              const SeqStep<T, V> &s, const seq::Policy &pol,
              cudaStream_t st) {
    if (f.rows == 0)
        return prior::colk_run<T, V>(p.Tt, p.C, p.F, p.costs, p.b, p.base,
                                    p.w, p.ah, p.M, p.R, p.L, p.R - 1, t,
                                    p.ws, p.ws_len, &s, pol, st);
    const int stage = f.stage_b ? f.stage_b : max_stage(f.cols, p.L, sizeof(T));
    if (!f.fixed && f.nt_b == 256)
        return colk_run<T, V, 256, false>(p.Tt, p.C, p.F, p.costs, p.b,
                                          p.base, p.w, p.ah, p.M, p.R, p.L,
                                          p.R - 1, t, p.ws, p.ws_len, &s, pol,
                                          f.rows, f.cols, stage, f.pdl_b, st);
    if (!f.fixed)
        return colk_run<T, V, 128, false>(p.Tt, p.C, p.F, p.costs, p.b,
                                          p.base, p.w, p.ah, p.M, p.R, p.L,
                                          p.R - 1, t, p.ws, p.ws_len, &s, pol,
                                          f.rows, f.cols, stage, f.pdl_b, st);
    if (f.nt_b == 256)
        return colk_run<T, V, 256>(p.Tt, p.C, p.F, p.costs, p.b, p.base,
                                   p.w, p.ah, p.M, p.R, p.L, p.R - 1, t,
                                   p.ws, p.ws_len, &s, pol, f.rows, f.cols,
                                   stage, f.pdl_b, st);
    return colk_run<T, V, 128>(p.Tt, p.C, p.F, p.costs, p.b, p.base, p.w,
                               p.ah, p.M, p.R, p.L, p.R - 1, t, p.ws,
                               p.ws_len, &s, pol, f.rows, f.cols, stage,
                               f.pdl_b, st);
}

// The widths of the first redesign: the fewest rows a block of eta_ratio
// whose grid fits half the SMs, and columns a block of eta_colk one block
// an SM, the widest where none does; each with as many slab rows a round
// as fit (``old``).
int fewest(int n, std::initializer_list<int> ws, int blocks) {
    int last = 0;
    for (int w : ws) {
        last = w;
        if (cdiv(n, w) <= blocks) return w;
    }
    return last;
}
void old_grid(int M, int R, int &rows, int &cols) {
    rows = fewest(M, {16, 32, 64, 128}, 132 / 2);
    cols = fewest(R, {32, 64, 128}, 132);
}

// kernels/eta.py eta_plan's rule (``shipped``): old_grid's rows; the
// fewest columns (32-256, 256 threads a block for 256) whose whole grid,
// the blocks of F[t] and b included, takes one wave of one block an SM, else
// 256; as many slab rows a round as fit, but 16 for eta_colk past one wave.
Form shipped(int M, int R, bool pdl) {
    int rows, cols_old;
    old_grid(M, R, rows, cols_old);
    auto blocks = [&](int c) { return cdiv(R, c) + cdiv(M, std::max(128, c)); };
    int cols = 256;
    for (int c : {32, 64, 128, 256})
        if (blocks(c) <= 132) {
            cols = c;
            break;
        }
    return Form{"shipped", rows, cols, 128, std::max(128, cols), 0,
                blocks(cols) > 132 ? 16 : 0, pdl, pdl, true};
}

// prior, the shipped plan (each launch alone: no programmatic dependent
// launch between two calls of one kernel) and the same by the general copy
// path, the first redesign's grid, then other widths and stages.
std::vector<Form> forms(int M, int R) {
    int rows, cols;
    old_grid(M, R, rows, cols);
    auto form = [&](std::string name, int r, int c, int nb, int sa, int sb) {
        return Form{name, r, c, 128, nb, sa, sb, false, false, true};
    };
    std::vector<Form> out{{"prior", 0, 0, 0, 0, 0, 0, false, false, true},
                          shipped(M, R, false)};
    out.push_back(out.back());
    out.back().name = "general";
    out.back().fixed = false;
    out.push_back(form("old", rows, cols, 128, 0, 0));
    for (int r : {16, 32, 64})
        out.push_back(Form{"r" + std::to_string(r) + "x64", r, cols, 64, 128,
                           0, 0, false, false, true});
    for (int r : {16, 32, 64, 128})
        if (r != rows)
            out.push_back(form("r" + std::to_string(r) + "x128", r, cols, 128,
                               0, 0));
    for (int sa : {16, 32})
        out.push_back(form("rs" + std::to_string(sa), rows, cols, 128, sa, 0));
    for (int c : {32, 64, 128})
        if (c != cols)
            out.push_back(form("c" + std::to_string(c) + "x128", rows, c, 128,
                               0, 0));
    for (int c : {128, 256})
        out.push_back(form("c" + std::to_string(c) + "x256", rows, c, 256, 0,
                           0));
    for (int c : {64, 128})
        for (int sb : {8, 16, 32})
            out.push_back(form("c" + std::to_string(c) + "s" +
                                       std::to_string(sb),
                               rows, c, 128, 0, sb));
    for (int sb : {8, 16})
        out.push_back(form("c256s" + std::to_string(sb), rows, 256, 256, 0,
                           sb));
    return out;
}

// The pivot's forms: prior, the shipped plan (both launches programmatic
// dependent launches, as the port launches them), the first redesign's
// grid with plain launches, with eta_colk a programmatic dependent launch,
// with both; then eta_colk's other widths and stages, both programmatic.
std::vector<Form> pivot_forms(int M, int R) {
    int rows, cols;
    old_grid(M, R, rows, cols);
    auto both = [&](std::string name, int c, int nb, int sa, int sb) {
        return Form{name, rows, c, 128, nb, sa, sb, true, true, true};
    };
    std::vector<Form> out{
            {"prior", 0, 0, 0, 0, 0, 0, false, false, true},
            shipped(M, R, true),
            {"plain", rows, cols, 128, 128, 0, 0, false, false, true},
            {"pdl-colk", rows, cols, 128, 128, 0, 0, false, true, true},
            both("pdl-both", cols, 128, 0, 0)};
    for (int c : {64, 128})
        for (int sb : {8, 16, 32})
            out.push_back(both("c" + std::to_string(c) + "s" +
                                       std::to_string(sb),
                               c, 128, 0, sb));
    for (int sb : {8, 16})
        out.push_back(both("c256s" + std::to_string(sb), 256, 256, 0, sb));
    out.push_back(both("c256x256", 256, 256, 0, 0));
    out.push_back(both("rs32-c128s16", 128, 128, 32, 16));
    return out;
}

// The scalars of a taken devex pivot at column h; edge states on top.
template <typename T, typename V>
void state(Prob<T, V> &p, int edge, double &eps, seq::Policy &pol) {
    const int h = (p.R * 5) / 7;
    std::fill(p.h_scal.begin(), p.h_scal.end(), 0);
    p.set(STATUS, (int)seq::RUNNING);
    p.set(ITERS, 3);
    p.set(STALL, 1);
    p.set(BLAND, (unsigned char)(edge == 3));
    p.set(Z, (V)0.25);
    p.set(ACTIVE, (unsigned char)(edge != 4));
    p.set(H, h);
    p.set(MINC, (V)-0.5);
    p.set(OPTIMAL_, (unsigned char)0);
    eps = edge == 2 ? 1e30 : 1e-9;
    pol = seq::Policy{1000, 1e-9,
                      edge == 6 ? (int)step::BLAND_STATIC
                                : (int)step::BLAND_THRESHOLD,
                      3, edge == 6};
    if (edge == 1) {                             // a NaN in b
        const V nan = (V)NAN;
        CK(cudaMemcpy(p.b0 + (p.M * 3) / 5, &nan, sizeof nan,
                      cudaMemcpyHostToDevice));
    }
    if (edge == 5) {                             // past the re-anchor
        const V big = (V)3e8;
        CK(cudaMemcpy(p.w0 + p.R - 2, &big, sizeof big,
                      cudaMemcpyHostToDevice));
    }
}

template <typename T, typename V>
void restore(Prob<T, V> &p, int edge) {
    if (edge == 1) {
        const V one = (V)0.5;
        CK(cudaMemcpy(p.b0 + (p.M * 3) / 5, &one, sizeof one,
                      cudaMemcpyHostToDevice));
    }
    if (edge == 5) {
        const V one = (V)1.5;
        CK(cudaMemcpy(p.w0 + p.R - 2, &one, sizeof one,
                      cudaMemcpyHostToDevice));
    }
}

template <typename T, typename V>
std::vector<unsigned char> pivot(const Form &f, Prob<T, V> &p, int t,
                                 double eps, const seq::Policy &pol) {
    reset(p, t);
    const SeqStep<T, V> s = p.step();
    CK(ratio_form(f, p, t, eps, s, 0));
    CK(colk_form(f, p, t, eps, s, pol, 0));
    return outputs(p, t);
}

int failures = 0;
bool trace = false;                              // each pivot named first

template <typename T, typename V>
void check(const char *pair, int M, int R, int L) {
    Prob<T, V> p = make<T, V>(M, R, L, 17 + M + R + L);
    std::vector<Form> fs = forms(M, R);
    for (const Form &f : pivot_forms(M, R))
        if (f.pdl_a || f.pdl_b) fs.push_back(f);
    int n = 0;
    for (int t : {0, 1, L / 2, L - 1}) {
        for (int edge = 0; edge < 7; ++edge) {
            double eps;
            seq::Policy pol;
            state(p, edge, eps, pol);
            const auto want = pivot(fs[0], p, t, eps, pol);
            for (size_t v = 1; v < fs.size(); ++v) {
                if (trace) {
                    std::printf("pivot %s M=%d R=%d L=%d t=%d edge %d %s\n",
                                pair, M, R, L, t, edge, fs[v].name.c_str());
                    std::fflush(stdout);
                }
                const auto got = pivot(fs[v], p, t, eps, pol);
                ++n;
                if (got != want) {
                    ++failures;
                    std::printf("MISMATCH %s M=%d R=%d L=%d t=%d edge %d %s\n",
                                pair, M, R, L, t, edge, fs[v].name.c_str());
                }
            }
            restore(p, edge);
        }
    }
    std::printf("check %s M=%d R=%d L=%d: %d pivots byte for byte\n", pair, M,
                R, L, n);
    release(p);
}

float replay_us(cudaGraphExec_t g, cudaStream_t st, int calls) {
    cudaEvent_t e0, e1;
    CK(cudaEventCreate(&e0));
    CK(cudaEventCreate(&e1));
    CK(cudaEventRecord(e0, st));
    for (int i = 0; i < 20; ++i) CK(cudaGraphLaunch(g, st));
    CK(cudaEventRecord(e1, st));
    CK(cudaEventSynchronize(e1));
    float ms = 0.0f;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    CK(cudaEventDestroy(e0));
    CK(cudaEventDestroy(e1));
    return 1000.0f * ms / (20.0f * calls);
}

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

// Each graph's us a call in turns: every form, then back, two rounds.
void turns(const std::vector<cudaGraphExec_t> &gs, cudaStream_t st,
           std::vector<float> &first, std::vector<float> &last) {
    const int n = (int)gs.size();
    for (int v = 0; v < n; ++v) CK(cudaGraphLaunch(gs[v], st));   // warm
    CK(cudaStreamSynchronize(st));
    first.assign(n, 0.0f);
    last.assign(n, 0.0f);
    for (int round = 0; round < 2; ++round) {
        for (int v = 0; v < n; ++v) {
            const float us = replay_us(gs[v], st, 50);
            (round == 0 ? first : last)[v] = us;
        }
        for (int v = n - 1; v >= 0; --v) {
            const float us = replay_us(gs[v], st, 50);
            (round == 0 ? first : last)[v] =
                    0.5f * ((round == 0 ? first : last)[v] + us);
        }
    }
}

template <typename T, typename V>
void timing(const char *pair, int M, int R) {
    const int L = 128;
    Prob<T, V> p = make<T, V>(M, R, L, 5);
    const std::vector<Form> fs = forms(M, R);
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    for (int t : {0, 64, 127}) {
        double eps;
        seq::Policy pol;
        state(p, 0, eps, pol);
        pol.then_pre = 0;
        // The factors as made (the calls timed before wrote their rows).
        CK(cudaMemcpy(p.C, p.C0, (size_t)L * R * sizeof(T),
                      cudaMemcpyDeviceToDevice));
        CK(cudaMemcpy(p.F, p.F0, (size_t)L * M * sizeof(T),
                      cudaMemcpyDeviceToDevice));
        reset(p, t);
        const SeqStep<T, V> s = p.step();
        CK(ratio_form(fs[0], p, t, eps, s, st));
        CK(cudaStreamSynchronize(st));
        unsigned char d = 0;
        CK(cudaMemcpy(&d, p.scal + 16 * DO, 1, cudaMemcpyDeviceToHost));
        if (!d) {
            std::printf("timing %s M=%d R=%d t=%d: the pivot is not taken\n",
                        pair, M, R, t);
            ++failures;
        }
        std::vector<cudaGraphExec_t> ga, gb;
        for (const Form &f : fs) {
            ga.push_back(capture(st, [&] {
                return ratio_form(f, p, t, eps, s, st);
            }));
            gb.push_back(capture(st, [&] {
                return colk_form(f, p, t, eps, s, pol, st);
            }));
        }
        std::vector<float> a0, a1, b0, b1;
        turns(ga, st, a0, a1);
        turns(gb, st, b0, b1);
        for (size_t v = 0; v < fs.size(); ++v)
            std::printf("time %s M=%d R=%d L=%d t=%d %-9s (rows %d, cols %d):"
                        " eta_ratio %.3f %.3f us, eta_colk %.3f %.3f us\n",
                        pair, M, R, L, t, fs[v].name.c_str(), fs[v].rows,
                        fs[v].cols, a0[v], a1[v], b0[v], b1[v]);
        for (auto g : ga) CK(cudaGraphExecDestroy(g));
        for (auto g : gb) CK(cudaGraphExecDestroy(g));
        // The pivot: eta_ratio then eta_colk, 50 times, as in a window (at
        // one depth).
        const std::vector<Form> ps = pivot_forms(M, R);
        std::vector<cudaGraphExec_t> gp;
        for (const Form &f : ps)
            gp.push_back(capture(st, [&] {
                const int e = ratio_form(f, p, t, eps, s, st);
                return e ? e : colk_form(f, p, t, eps, s, pol, st);
            }));
        std::vector<float> p0, p1;
        turns(gp, st, p0, p1);
        for (size_t v = 0; v < ps.size(); ++v)
            std::printf("pivot %s M=%d R=%d L=%d t=%d %-9s: %.3f %.3f us\n",
                        pair, M, R, L, t, ps[v].name.c_str(), p0[v], p1[v]);
        for (auto g : gp) CK(cudaGraphExecDestroy(g));
        // Back to a taken pivot's state for the next depth.
        reset(p, t);
    }
    CK(cudaStreamDestroy(st));
    release(p);
}


// ---------------------------------------------------------------------------
// The sharded plain blocked loop's head (``slice``): eta_fold_column and
// eta_ratio_summed against the forms before them (slice_prior), byte for
// byte, then timed in turns.

// The gathered candidates of P ranks (this slice is rank 0's, global
// columns [0, R); rank q > 0 holds columns past R) and the rank's own.
struct SliceCands {
    double *V, *W;
    int *I, *own;
    void *wh;
    int P, kv;
};

// The fold's edge states: 0 devex, rank 0's main candidate wins; 1 Bland
// on, rank 0's Bland candidate (the lowest index); 2 a re-anchor (the last
// rank's largest weight 3e8), rank 0's candidate on weights of 1, apart
// from its main one; 3 Dantzig; 4 another rank's candidate wins (zeros
// here); 5 a NaN key on the last rank (rank 0's); 6 the pick none of the
// rank's own candidates (loaded after the fold); 7 Dantzig with a NaN cost
// on the last rank; 8 a NaN largest weight on the last rank (no re-anchor);
// 9 a NaN largest weight beside one past 1e8 (no re-anchor either).
constexpr int SLICE_EDGES = 10;

template <typename T, typename V>
SliceCands slice_cands(Prob<T, V> &p, int P, int edge) {
    SliceCands x{};
    x.P = P;
    const bool devex = edge != 3 && edge != 7;
    x.kv = devex ? 7 : 2;
    const int ki = devex ? 3 : 2, R = p.R;
    std::vector<double> v(P * x.kv), w(P, 1.5);
    std::vector<int> ix(P * ki);
    for (int q = 0; q < P; ++q) {
        double key = q == 0 ? 4.0 : 2.0 - 0.1 * q;
        if (edge == 4 && q == P - 1) key = 9.0;
        if (edge == 5 && q == P - 1) key = NAN;
        const double vd = edge == 7 && q == P - 1 ? NAN : -0.5 + 0.01 * q;
        const double vals[7] = {vd, -0.25, 1.5, 1.25, key, -0.4, key};
        const int h = q == 0 ? (R * 5) / 7 : R + 3 + 10 * q;
        const int cols[3] = {h, q == 0 ? 1 : R + 5 + 10 * q,
                             q == 0 && edge == 2 ? R / 3 : h};
        for (int e = 0; e < x.kv; ++e) v[q * x.kv + e] = vals[e];
        for (int e = 0; e < ki; ++e) ix[q * ki + e] = cols[e];
    }
    if (edge == 2) w[P - 1] = 3e8;
    if (edge == 8 || edge == 9) w[P - 1] = NAN;
    if (edge == 9) w[0] = 3e8;
    std::vector<int> own(ix.begin(), ix.begin() + ki);
    if (edge == 6) std::fill(own.begin(), own.end(), 0);
    CK(cudaMalloc(&x.V, v.size() * sizeof(double)));
    CK(cudaMalloc(&x.W, P * sizeof(double)));
    CK(cudaMalloc(&x.I, ix.size() * sizeof(int)));
    CK(cudaMalloc(&x.own, ki * sizeof(int)));
    CK(cudaMalloc(&x.wh, sizeof(V)));
    CK(cudaMemcpy(x.V, v.data(), v.size() * sizeof(double),
                  cudaMemcpyHostToDevice));
    CK(cudaMemcpy(x.W, w.data(), P * sizeof(double), cudaMemcpyHostToDevice));
    CK(cudaMemcpy(x.I, ix.data(), ix.size() * sizeof(int),
                  cudaMemcpyHostToDevice));
    CK(cudaMemcpy(x.own, own.data(), ki * sizeof(int),
                  cudaMemcpyHostToDevice));
    CK(cudaMemset(x.wh, 0, sizeof(V)));
    return x;
}

void release(SliceCands &x) {
    for (void *d : {(void *)x.V, (void *)x.W, (void *)x.I, (void *)x.own,
                    x.wh})
        CK(cudaFree(d));
}

// The scalars a pivot's head starts from.
template <typename T, typename V>
void head_state(Prob<T, V> &p, int edge) {
    std::fill(p.h_scal.begin(), p.h_scal.end(), 0);
    p.set(STATUS, (int)seq::RUNNING);
    p.set(ITERS, 3);
    p.set(BLAND, (unsigned char)(edge == 1));
    p.set(Z, (V)0.25);
}

// eta_fold_column's slab rows a round: as many as fit beside ``coefs``
// columns of coefficients, at most 128 (kernels/eta.py eta_stage).
int fold_stage(int width, int L, int item, int coefs) {
    const long long row = (long long)slab_width(width, item) * item;
    const long long room =
            BLOCK_SMEM - SMEM_RESERVE - coefs * round16((long long)L * item);
    return (int)std::min<long long>(128, room / (2 * row));
}

// The fold's forms: before (slice_prior), the shipped one (one warp
// folding, h's column loaded after the fold), and the rank's own
// candidates' columns sent for before the fold, folding in thread 0 or in
// one warp.
const char *const FOLD_FORMS[] = {"before", "shipped", "pf+thread0",
                                  "pf+warp"};
constexpr int NFOLD = 4;

template <typename T, typename V>
int fold_form(int form, Prob<T, V> &p, const SliceCands &x, int t,
              const SeqStep<T, V> &s, cudaStream_t st) {
    int rows, cols;
    old_grid(p.M, p.R, rows, cols);
    const bool devex = x.kv == 7;
    void *w = devex ? p.w : nullptr;
    void *wh = devex ? x.wh : nullptr;
    const double *W = devex ? x.W : nullptr;
    const int one = fold_stage(rows, p.L, sizeof(T), 1);
    const int three = fold_stage(rows, p.L, sizeof(T), 3);
    switch (form) {
    case 0:
        return slice_prior::fold_column_run<T, V>(
                p.Tt, p.C, p.F, p.ah, p.M, p.R, p.L, t, 0, x.V, x.I, W, x.P,
                x.kv, w, wh, &s, 1000, 1e-9, rows, one, st);
    case 1:
        return fold_column_run<T, V>(p.Tt, p.C, p.F, p.ah, p.M, p.R, p.L, t,
                                     0, x.V, x.I, W, x.P, x.kv, w, wh, &s,
                                     1000, 1e-9, rows, one, st);
    case 2:
        return slice_forms::fold_run<T, V, true, false>(
                p.Tt, p.C, p.F, p.ah, p.M, p.R, p.L, t, 0, x.V, x.I, W, x.P,
                x.kv, x.own, w, wh, &s, 1000, 1e-9, rows, three, st);
    }
    return slice_forms::fold_run<T, V, true, true>(
            p.Tt, p.C, p.F, p.ah, p.M, p.R, p.L, t, 0, x.V, x.I, W, x.P, x.kv,
            x.own, w, wh, &s, 1000, 1e-9, rows, three, st);
}

// The ratio test's forms: 0 before (eta_ratio's grid, the ticket), then
// one cluster of 8 or 16 blocks, with or without programmatic dependent
// launch.
struct RatioForm {
    const char *name;
    int nb;
    bool pdl;
};
const RatioForm RATIO_FORMS[] = {{"before", 0, false}, {"c8", 8, false},
                                 {"c16", 16, false}, {"c8-pdl", 8, true},
                                 {"c16-pdl", 16, true}};

template <typename T, typename V>
int ratio_summed_form(const RatioForm &f, Prob<T, V> &p, double eps,
                      const SeqStep<T, V> &s, cudaStream_t st) {
    if (f.nb == 0) {
        int rows, cols;
        old_grid(p.M, p.R, rows, cols);
        return slice_prior::ratio_summed_run<T, V>(p.b, p.ah, p.M, eps, p.ws,
                                                   p.ws_len, &s, rows, st);
    }
    if (f.nb == 8)
        return slice_forms::ratio_run<T, V, 8>(p.b, p.ah, p.M, eps, &s,
                                               f.pdl, st);
    return slice_forms::ratio_run<T, V, 16>(p.b, p.ah, p.M, eps, &s, f.pdl,
                                            st);
}

// What a head writes, as bytes: the scalars, ah, the weights, wh and the
// workspace's first counter.
template <typename T, typename V>
std::vector<unsigned char> head_out(const Prob<T, V> &p, const SliceCands &x) {
    std::vector<unsigned char> out;
    auto grab = [&](const void *d, size_t n) {
        const size_t at = out.size();
        out.resize(at + n);
        CK(cudaMemcpy(out.data() + at, d, n, cudaMemcpyDeviceToHost));
    };
    CK(cudaDeviceSynchronize());
    grab(p.scal, 16 * NSCAL);
    grab(p.ah, p.M * sizeof(T));
    grab(p.w, p.R * sizeof(V));
    grab(x.wh, sizeof(V));
    grab(p.ws, 4);
    return out;
}

template <typename T, typename V>
void slice_check(const char *pair, int M, int R, int L) {
    Prob<T, V> p = make<T, V>(M, R, L, 41 + M + R + L);
    int n = 0;
    for (int P : {1, 3}) {
        for (int t : {0, 1, L / 2, L - 1}) {
            for (int edge = 0; edge < SLICE_EDGES; ++edge) {
                if (P == 1 && edge == 4) continue;
                SliceCands x = slice_cands(p, P, edge);
                head_state(p, edge);
                std::vector<unsigned char> want;
                for (int form = 0; form < NFOLD; ++form) {
                    reset(p, t);
                    const SeqStep<T, V> s = p.step();
                    CK(fold_form(form, p, x, t, s, 0));
                    const auto got = head_out(p, x);
                    if (form == 0) {
                        want = got;
                    } else {
                        ++n;
                        if (got != want) {
                            ++failures;
                            std::printf("MISMATCH fold %s M=%d R=%d L=%d "
                                        "P=%d t=%d edge %d form %d\n",
                                        pair, M, R, L, P, t, edge, form);
                        }
                    }
                }
                release(x);
            }
        }
    }
    // The ratio test on a random summed column: a taken pivot, a NaN in b,
    // no eligible row, the fuse.
    double *scratch;
    CK(cudaMalloc(&scratch, (size_t)M * sizeof(double)));
    for (int edge = 0; edge < 4; ++edge) {
        head_state(p, 0);
        p.set(ACTIVE, (unsigned char)(edge != 3));
        p.set(MINC, (V)-0.5);
        const double eps = edge == 2 ? 1e30 : 1e-9;
        std::vector<unsigned char> want;
        for (const RatioForm &f : RATIO_FORMS) {
            reset(p, 0);
            fill(p.ah, M, 91, -1.0, 1.0, scratch);
            if (edge == 1) {
                const V nan = (V)NAN;
                CK(cudaMemcpy(p.b + (M * 3) / 5, &nan, sizeof nan,
                              cudaMemcpyHostToDevice));
            }
            const SeqStep<T, V> s = p.step();
            CK(ratio_summed_form(f, p, eps, s, 0));
            CK(cudaDeviceSynchronize());
            std::vector<unsigned char> got(16 * NSCAL + 4);
            CK(cudaMemcpy(got.data(), p.scal, 16 * NSCAL,
                          cudaMemcpyDeviceToHost));
            CK(cudaMemcpy(got.data() + 16 * NSCAL, p.ws, 4,
                          cudaMemcpyDeviceToHost));
            if (f.nb == 0) {
                want = got;
            } else {
                ++n;
                if (got != want) {
                    ++failures;
                    std::printf("MISMATCH ratio_summed %s M=%d edge %d %s\n",
                                pair, M, edge, f.name);
                }
            }
        }
    }
    CK(cudaFree(scratch));
    std::printf("slice check %s M=%d R=%d L=%d: %d heads byte for byte\n",
                pair, M, R, L, n);
    release(p);
}

// us a call of each form in turns (graphs of 50 calls): the fold at P = 1
// and 3 (at t = 0, 64 and 127), the ratio test alone, and the head -- the
// fold then the ratio test, as a pivot runs them at one rank -- at t = 64,
// L = 128, f64, on a taken devex pivot.
void slice_timing(int M, int R) {
    using T = double;
    using V = double;
    const int L = 128, t = 64;
    Prob<T, V> p = make<T, V>(M, R, L, 7);
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    for (int P : {1, 3})
        for (int tf : {0, t, L - 1}) {
            SliceCands x = slice_cands(p, P, 0);
            head_state(p, 0);
            reset(p, tf);
            const SeqStep<T, V> s = p.step();
            std::vector<cudaGraphExec_t> gs;
            for (int form = 0; form < NFOLD; ++form)
                gs.push_back(capture(st, [&] {
                    return fold_form(form, p, x, tf, s, st);
                }));
            std::vector<float> a, b;
            turns(gs, st, a, b);
            for (int form = 0; form < NFOLD; ++form)
                std::printf("time eta_fold_column f64 M=%d R=%d L=%d t=%d "
                            "P=%d %-10s: %.3f %.3f us\n",
                            M, R, L, tf, P, FOLD_FORMS[form], a[form],
                            b[form]);
            for (auto g : gs) CK(cudaGraphExecDestroy(g));
            release(x);
        }
    SliceCands x = slice_cands(p, 1, 0);
    head_state(p, 0);
    reset(p, t);
    const SeqStep<T, V> s = p.step();
    CK(fold_form(1, p, x, t, s, st));            // a taken pivot's column
    CK(cudaStreamSynchronize(st));
    std::vector<cudaGraphExec_t> gs;
    const int nr = sizeof RATIO_FORMS / sizeof RATIO_FORMS[0];
    for (const RatioForm &f : RATIO_FORMS)
        if (!f.pdl)
            gs.push_back(capture(st, [&] {
                return ratio_summed_form(f, p, 1e-9, s, st);
            }));
    std::vector<float> a, b;
    turns(gs, st, a, b);
    int v = 0;
    for (const RatioForm &f : RATIO_FORMS)
        if (!f.pdl) {
            std::printf("time eta_ratio_summed f64 M=%d %-8s alone: %.3f "
                        "%.3f us\n", M, f.name, a[v], b[v]);
            ++v;
        }
    for (auto g : gs) CK(cudaGraphExecDestroy(g));
    gs.clear();
    // The head: the fold before with the ratio test before; the shipped
    // fold with each cluster, with and without programmatic dependent
    // launch.
    // The other folds with the shipped cluster (16 blocks, PDL).
    std::vector<std::string> names;
    std::vector<std::pair<int, const RatioForm *>> heads;
    for (int r = 0; r < nr; ++r)
        heads.push_back({RATIO_FORMS[r].nb == 0 ? 0 : 1, &RATIO_FORMS[r]});
    for (int form = 2; form < NFOLD; ++form)
        heads.push_back({form, &RATIO_FORMS[nr - 1]});
    for (const auto &hd : heads) {
        const int form = hd.first;
        const RatioForm &f = *hd.second;
        names.push_back(std::string(FOLD_FORMS[form]) + "+" + f.name);
        gs.push_back(capture(st, [&] {
            const int e = fold_form(form, p, x, t, s, st);
            return e ? e : ratio_summed_form(f, p, 1e-9, s, st);
        }));
    }
    turns(gs, st, a, b);
    for (size_t r = 0; r < heads.size(); ++r)
        std::printf("time head f64 M=%d R=%d L=%d t=%d %-18s: %.3f %.3f us "
                    "a pivot\n", M, R, L, t, names[r].c_str(), a[r], b[r]);
    for (auto g : gs) CK(cudaGraphExecDestroy(g));
    release(x);
    CK(cudaStreamDestroy(st));
    release(p);
}

// The ratio test alone at the north star's rows (past one pass of 8 x 256
// x 4), in turns.
void ratio_rows_timing(int M) {
    Prob<double, double> p = make<double, double>(M, 3, 2, 9);
    double *scratch;
    CK(cudaMalloc(&scratch, (size_t)M * sizeof(double)));
    fill(p.ah, M, 91, -1.0, 1.0, scratch);
    CK(cudaFree(scratch));
    head_state(p, 0);
    p.set(ACTIVE, (unsigned char)1);
    p.set(MINC, -0.5);
    reset(p, 0);
    const SeqStep<double, double> s = p.step();
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    std::vector<cudaGraphExec_t> gs;
    std::vector<const char *> names;
    for (const RatioForm &f : RATIO_FORMS)
        if (!f.pdl) {
            names.push_back(f.name);
            gs.push_back(capture(st, [&] {
                return ratio_summed_form(f, p, 1e-9, s, st);
            }));
        }
    std::vector<float> a, b;
    turns(gs, st, a, b);
    for (size_t v = 0; v < gs.size(); ++v)
        std::printf("time eta_ratio_summed f64 M=%d %-8s alone: %.3f %.3f "
                    "us\n", M, names[v], a[v], b[v]);
    for (auto g : gs) CK(cudaGraphExecDestroy(g));
    CK(cudaStreamDestroy(st));
    release(p);
}


// ---------------------------------------------------------------------------
// eta_colk_slice (``colk``): the shipped kernel, whose candidates carry the
// weights at them through the block's and the partials' folds, against
// the form before (colk_prior: the slice's last block reads the weights at
// its candidates back past L1 after the fold) and the shipped one with the
// ticket's acq_rel alone (no __threadfence before it or after it), byte
// for byte; then each timed in turns, and eta_colk (the single-card
// kernel, whose template it shares) against its form before.

// The slice's operands beside a pivot's: the send buffers and the fold's
// weight at h.
template <typename V>
struct SliceSend {
    double *v, *w;
    int *i;
    V *wh;
};

template <typename V>
SliceSend<V> slice_send() {
    SliceSend<V> x{};
    CK(cudaMalloc(&x.v, SLICE_KV * sizeof(double)));
    CK(cudaMalloc(&x.w, sizeof(double)));
    CK(cudaMalloc(&x.i, SLICE_KI * sizeof(int)));
    CK(cudaMalloc(&x.wh, sizeof(V)));
    const V wh = (V)1.75;
    CK(cudaMemcpy(x.wh, &wh, sizeof wh, cudaMemcpyHostToDevice));
    return x;
}

template <typename V>
void release(SliceSend<V> &x) {
    for (void *d : {(void *)x.v, (void *)x.w, (void *)x.i, (void *)x.wh})
        CK(cudaFree(d));
}

// The slice's edge states: 0-5 state()'s (a taken devex pivot, a NaN in
// b, no eligible row, Bland on, the fuse, a weight past 1e8); 6 Dantzig;
// 7 a NaN weight at a column, the pivot skipped (its NaN score wins); 8
// equal devex scores at a column of the first block and one of the last,
// the pivot skipped (the lower index and its own weight win); 9 no
// eligible column; 10 Bland static.
constexpr int COLK_EDGES = 11;
const char *const COLK_FORMS[] = {"before", "shipped", "carry+fence",
                                   "readback", "cluster8"};
constexpr int NCOLK = 5;

// One element of a device array, set and later put back.
struct Patch {
    void *at;
    unsigned char old[8];
    size_t n;
};

template <typename X>
void patch(std::vector<Patch> &ps, X *at, X v) {
    Patch q{at, {}, sizeof(X)};
    CK(cudaMemcpy(q.old, at, sizeof(X), cudaMemcpyDeviceToHost));
    CK(cudaMemcpy(at, &v, sizeof(X), cudaMemcpyHostToDevice));
    ps.push_back(q);
}

void unpatch(std::vector<Patch> &ps) {
    for (auto q = ps.rbegin(); q != ps.rend(); ++q)
        CK(cudaMemcpy(q->at, q->old, q->n, cudaMemcpyHostToDevice));
    ps.clear();
}

template <typename T, typename V>
void colk_state(Prob<T, V> &p, int edge, double &eps, seq::Policy &pol,
                std::vector<Patch> &ps) {
    state(p, edge < 6 ? edge : 0, eps, pol);
    pol.then_pre = 0;
    const int R = p.R;
    if (edge == 7 || edge == 8) p.set(ACTIVE, (unsigned char)0);
    if (edge == 7) patch(ps, p.w0 + R / 3, (V)NAN);
    if (edge == 8 && R > 8) {
        patch(ps, p.costs0 + 3, (V)-40);
        patch(ps, p.w0 + 3, (V)400);
        patch(ps, p.costs0 + (R - 4), (V)-20);
        patch(ps, p.w0 + (R - 4), (V)100);
    }
    if (edge == 9) pol.eps = 1e30;
    if (edge == 10) pol.bland_mode = step::BLAND_STATIC;
}

// Forms 2-4 (colk_forms) on NT threads a block.
template <typename T, typename V, int NT>
int colk_form_run(int form, Prob<T, V> &p, void *w, int t,
                  const SeqStep<T, V> &s, const seq::Policy &pol,
                  const Form &f, int stage, const SliceOut<V> &so,
                  cudaStream_t st) {
    auto run = form == 2   ? &colk_forms::form_run<T, V, NT, 1, true, true>
               : form == 3 ? &colk_forms::form_run<T, V, NT, 1, false, false>
                           : &colk_forms::form_run<T, V, NT, 8, true, false>;
    return run(p.Tt, p.C, p.F, p.costs, p.b, p.base, w, p.ah, p.M, p.R, p.L,
               p.R - 1, t, p.ws, p.ws_len, &s, pol, f.rows, f.cols, stage,
               so, st);
}

template <typename T, typename V>
int colk_slice_form(int form, Prob<T, V> &p, const SliceSend<V> &x, int t,
                    const SeqStep<T, V> &s, const seq::Policy &pol,
                    bool devex, int offset, cudaStream_t st) {
    const Form f = shipped(p.M, p.R, true);
    const int stage = f.stage_b ? f.stage_b : max_stage(f.cols, p.L,
                                                          sizeof(T));
    void *w = devex ? p.w : nullptr;
    const void *wh = devex ? x.wh : nullptr;
    double *sw = devex ? x.w : nullptr;
    if (form == 0)
        return colk_prior::colk_slice_any<T, V>(
                p.Tt, p.C, p.F, p.costs, p.b, p.base, w, p.ah, p.M, p.R, p.L,
                p.R - 1, t, p.ws, p.ws_len, &s, pol, f.rows, f.cols, stage,
                offset, wh, x.v, x.i, sw, st);
    if (form == 1)
        return colk_slice_any<T, V>(p.Tt, p.C, p.F, p.costs, p.b, p.base, w,
                                    p.ah, p.M, p.R, p.L, p.R - 1, t, p.ws,
                                    p.ws_len, &s, pol, f.rows, f.cols, stage,
                                    offset, wh, x.v, x.i, sw, st);
    const SliceOut<V> so{offset, static_cast<const V *>(wh), x.v, x.i, sw};
    if (f.cols > COLK_THREADS)
        return colk_form_run<T, V, 2 * COLK_THREADS>(form, p, w, t, s, pol,
                                                    f, stage, so, st);
    return colk_form_run<T, V, COLK_THREADS>(form, p, w, t, s, pol, f,
                                            stage, so, st);
}

// A slice pivot: the shipped eta_ratio (k, p, ...), then eta_colk_slice's
// form; everything it writes and the send buffers, as bytes.
template <typename T, typename V>
std::vector<unsigned char> colk_pivot(int form, Prob<T, V> &p,
                                      const SliceSend<V> &x, int t,
                                      double eps, const seq::Policy &pol,
                                      bool devex, int offset) {
    reset(p, t);
    CK(cudaMemset(x.v, 0x7f, SLICE_KV * sizeof(double)));
    CK(cudaMemset(x.i, 0x7f, SLICE_KI * sizeof(int)));
    CK(cudaMemset(x.w, 0x7f, sizeof(double)));
    const SeqStep<T, V> s = p.step();
    CK(ratio_form(shipped(p.M, p.R, true), p, t, eps, s, 0));
    const int e = colk_slice_form(form, p, x, t, s, pol, devex, offset, 0);
    if (e != 0) {                                // reported, not fatal
        std::printf("LAUNCH eta_colk_slice %s M=%d R=%d t=%d: %s\n",
                    COLK_FORMS[form], p.M, p.R, t,
                    cudaGetErrorString((cudaError_t)e));
        cudaGetLastError();
        return {};
    }
    auto out = outputs(p, t);
    auto grab = [&](const void *d, size_t n) {
        const size_t at = out.size();
        out.resize(at + n);
        CK(cudaMemcpy(out.data() + at, d, n, cudaMemcpyDeviceToHost));
    };
    grab(x.v, SLICE_KV * sizeof(double));
    grab(x.i, SLICE_KI * sizeof(int));
    grab(x.w, sizeof(double));
    return out;
}

template <typename T, typename V>
void colk_check(const char *pair, int M, int R, int L) {
    Prob<T, V> p = make<T, V>(M, R, L, 53 + M + R + L);
    SliceSend<V> x = slice_send<V>();
    std::vector<Patch> ps;
    int n = 0;
    for (int offset : {0, 2 * R})
        for (int t : {0, 1, L / 2, L - 1})
            for (int edge = 0; edge < COLK_EDGES; ++edge) {
                double eps;
                seq::Policy pol;
                colk_state(p, edge, eps, pol, ps);
                const bool devex = edge != 6;
                const auto want = colk_pivot(0, p, x, t, eps, pol, devex,
                                             offset);
                for (int form = 1; form < NCOLK; ++form) {
                    const auto got = colk_pivot(form, p, x, t, eps, pol,
                                                devex, offset);
                    ++n;
                    if (got.empty() || got != want) {
                        ++failures;
                        std::printf("MISMATCH eta_colk_slice %s M=%d R=%d "
                                    "L=%d t=%d offset %d edge %d %s\n",
                                    pair, M, R, L, t, offset, edge,
                                    COLK_FORMS[form]);
                    }
                }
                unpatch(ps);
                restore(p, edge < 6 ? edge : 0);
            }
    std::printf("colk check %s M=%d R=%d L=%d: %d slice pivots byte for "
                "byte\n", pair, M, R, L, n);
    release(x);
    release(p);
}

// us a call of each form in turns (graphs of 50 calls) at f64, L = 128,
// on a taken devex pivot: eta_colk_slice at each t of ``ts``, and with
// ``single`` eta_colk before and shipped (no next step before).
void colk_timing(int M, int R, std::initializer_list<int> ts, bool single) {
    using T = double;
    using V = double;
    const int L = 128;
    Prob<T, V> p = make<T, V>(M, R, L, 11);
    SliceSend<V> x = slice_send<V>();
    std::vector<Patch> ps;
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    const Form f = shipped(M, R, true);
    const int stage = f.stage_b ? f.stage_b : max_stage(f.cols, L, sizeof(T));
    for (int t : ts) {
        double eps;
        seq::Policy pol;
        colk_state(p, 0, eps, pol, ps);
        reset(p, t);
        const SeqStep<T, V> s = p.step();
        CK(ratio_form(f, p, t, eps, s, st));
        CK(cudaStreamSynchronize(st));
        std::vector<cudaGraphExec_t> gs;
        std::vector<int> ok;                     // the forms that launch
        for (int form = 0; form < NCOLK; ++form) {
            if (colk_slice_form(form, p, x, t, s, pol, true, 0, st) != 0 ||
                cudaStreamSynchronize(st) != cudaSuccess) {
                cudaGetLastError();
                std::printf("time eta_colk_slice %s: does not launch\n",
                            COLK_FORMS[form]);
                ++failures;
                continue;
            }
            ok.push_back(form);
            gs.push_back(capture(st, [&] {
                return colk_slice_form(form, p, x, t, s, pol, true, 0, st);
            }));
        }
        std::vector<float> a, b;
        turns(gs, st, a, b);
        for (size_t v = 0; v < ok.size(); ++v)
            std::printf("time eta_colk_slice f64 M=%d R=%d L=%d t=%d "
                        "%-11s: %.3f %.3f us\n", M, R, L, t,
                        COLK_FORMS[ok[v]], a[v], b[v]);
        for (auto g : gs) CK(cudaGraphExecDestroy(g));
        if (single) {
            gs.clear();
            gs.push_back(capture(st, [&] {
                return colk_prior::colk_any<T, V>(
                        p.Tt, p.C, p.F, p.costs, p.b, p.base, p.w, p.ah, M,
                        R, L, R - 1, t, p.ws, p.ws_len, &s, pol, f.rows,
                        f.cols, stage, st);
            }));
            gs.push_back(capture(st, [&] {
                return colk_any<T, V>(p.Tt, p.C, p.F, p.costs, p.b, p.base,
                                      p.w, p.ah, M, R, L, R - 1, t, p.ws,
                                      p.ws_len, &s, pol, f.rows, f.cols,
                                      stage, st);
            }));
            turns(gs, st, a, b);
            for (int v = 0; v < 2; ++v)
                std::printf("time eta_colk f64 M=%d R=%d L=%d t=%d %-9s: "
                            "%.3f %.3f us\n", M, R, L, t,
                            COLK_FORMS[v], a[v], b[v]);
            for (auto g : gs) CK(cudaGraphExecDestroy(g));
        }
        restore(p, 0);
    }
    CK(cudaStreamDestroy(st));
    release(x);
    release(p);
}

}  // namespace

int main(int argc, char **argv) {
    const std::string mode = argc > 1 ? argv[1] : "";
    trace = mode == "trace";
    cudaDeviceProp prop;
    CK(cudaGetDeviceProperties(&prop, 0));
    std::printf("device %s, %d SMs\n", prop.name, prop.multiProcessorCount);
    if (mode != "slice") {
        const int colks[][2] = {{2048, 6144}, {2048, 2048}, {37, 6143},
                                {2047, 3},    {4097, 257}};
        for (const auto &sh : colks)
            for (int L : {128, 13}) {
                colk_check<double, double>("f64", sh[0], sh[1], L);
                colk_check<float, double>("f32/f64", sh[0], sh[1], L);
                colk_check<float, float>("f32", sh[0], sh[1], L);
            }
        colk_timing(2048, 6144, {0, 64, 127}, true);
        colk_timing(2048, 2048, {0, 64, 127}, false);
        colk_timing(8192, 24576, {64}, true);
    }
    if (mode == "colk") {
        std::printf(failures ? "FAILED: %d\n" : "every check passed\n",
                    failures);
        return failures ? 1 : 0;
    }
    const int heads[][2] = {{2048, 6144}, {37, 6143}, {2047, 3},
                            {10112, 257}};
    for (const auto &sh : heads)
        for (int L : {128, 13}) {
            slice_check<double, double>("f64", sh[0], sh[1], L);
            slice_check<float, double>("f32/f64", sh[0], sh[1], L);
            slice_check<float, float>("f32", sh[0], sh[1], L);
        }
    slice_timing(2048, 6144);
    slice_timing(8192, 24576);
    ratio_rows_timing(10112);
    if (mode == "slice") {
        std::printf(failures ? "FAILED: %d\n" : "every check passed\n",
                    failures);
        return failures ? 1 : 0;
    }
    const int shapes[][2] = {{2048, 6144}, {1, 3},     {37, 6143},
                             {2047, 6143}, {2047, 3},  {4097, 257}};
    for (const auto &sh : shapes)
        for (int L : {128, 13, 300}) {
            check<double, double>("f64", sh[0], sh[1], L);
            check<float, double>("f32/f64", sh[0], sh[1], L);
            check<float, float>("f32", sh[0], sh[1], L);
        }
    const int timed[][2] = {{2048, 6144}, {8192, 24576}};
    for (const auto &sh : timed) {
        timing<double, double>("f64", sh[0], sh[1]);
        timing<float, double>("f32/f64", sh[0], sh[1]);
        timing<float, float>("f32", sh[0], sh[1]);
    }
    timing<double, double>("f64", 10112, 120064);
    std::printf(failures ? "FAILED: %d\n" : "every check passed\n", failures);
    return failures ? 1 : 0;
}

#endif  // ETA_VARIANTS_LIB
