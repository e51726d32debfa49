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
// within an f32 rounding or two of exact, as the mixed walks need. Every other product, quotient and difference is rounded apart
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
// column or the row) behind a chain of t loads a thread, then a ticket
// and the last block's fold. Design: one thread a row of the column (64 a
// block) and one a column of the row (128 a block); C[:t, h] and F[:t, k]
// staged in shared memory STAGE rows at a time; each thread's chain
// unrolled by 8, so its next 8 loads are in flight behind its sums.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "seq_step.cuh"

namespace {

using seq::BIG_INDEX;
using seq::block_fold;
using seq::div_rn;
using seq::inf;
using seq::mul_rn;
using seq::Ratio;
using seq::sub_rn;

constexpr int ROWS_A = 64;     // eta_ratio: rows a block, one a thread
constexpr int COLS_B = 128;    // eta_colk: columns (or rows) a block
constexpr int STAGE = 128;     // eta values staged in shared memory at once

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

// The workspace (bytes; kernels/eta.py eta_workspace_bytes agrees): [0, 4)
// eta_ratio's arrival counter, [4, 8) eta_colk's, [8, 16) the new weight at
// h (a double), then eta_ratio's partials -- f64 q, a, b[nbA], int j,
// any[nbA]: 32 bytes a block -- and eta_colk's -- f64 key, val, key1,
// val1, bval, wmax[nbB], int idx, idx1, bidx[nbB]: 64 bytes a block. Each
// call leaves its counter at 0.
__host__ __device__ constexpr size_t ws_bytes(int nbA, int nbB) {
    return 16 + 32 * (size_t)nbA + 64 * (size_t)nbB;
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
    __device__ WsB(unsigned char *ws, int nbA, int nbB)
        : counter(reinterpret_cast<unsigned *>(ws + 4)),
          wh(reinterpret_cast<double *>(ws + 8)),
          key(reinterpret_cast<double *>(ws + 16 + 32 * (size_t)nbA)),
          val(key + nbB), key1(val + nbB), val1(key1 + nbB),
          bval(val1 + nbB), wmax(bval + nbB),
          idx(reinterpret_cast<int *>(wmax + nbB)), idx1(idx + nbB),
          bidx(idx1 + nbB) {}
};

// ---------------------------------------------------------------------------
// eta_ratio: the live entering column, the ratio test and the step between.

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

// ---------------------------------------------------------------------------
// eta_colk: the live leaving row, C[t], the costs, the devex weights, F[t],
// b and base, the next candidates and the step after.

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
    if (o.wmax > x.wmax) x.wmax = o.wmax;
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
    __shared__ RowCands<V> warps[NW];
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
        take_first(x, RowCands<V>{
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

// ---------------------------------------------------------------------------
// Launchers.

int cdiv(int a, int b) { return (a + b - 1) / b; }

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

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes). ``step`` is the host's array of the sequential
// scalars' pointers (kernels.seq.SeqScalars), ``pair`` the dtype pair
// (PAIR_*), ``ws`` an eta_workspace of ``ws_len`` bytes; an unknown pair,
// an empty shape, t outside [0, L) or a short workspace is refused with
// cudaErrorInvalidValue. Each returns cudaGetLastError() as an int.

extern "C" {

// Tt (M, R), C (L, R), F (L, M) and ah (M,) of the tableau's dtype, b (M,)
// of the vectors'.
int eta_ratio_launch(const void *Tt, const void *C, const void *F,
                     const void *b, void *ah, int M, int R, int L, int t,
                     double eps, unsigned char *ws, long long ws_len,
                     const void *step, int pair, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return ratio_run<double, double>(Tt, C, F, b, ah, M, R, L, t, eps, ws,
                                         ws_len, step, st);
    case PAIR_MIXED:
        return ratio_run<float, double>(Tt, C, F, b, ah, M, R, L, t, eps, ws,
                                        ws_len, step, st);
    case PAIR_F32:
        return ratio_run<float, float>(Tt, C, F, b, ah, M, R, L, t, eps, ws,
                                       ws_len, step, st);
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
                    void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const seq::Policy pol{max_iter, eps, bland_mode, threshold, then_pre};
    switch (pair) {
    case PAIR_F64:
        return colk_run<double, double>(Tt, C, F, costs, b, base, w, ah, M, R,
                                        L, r, t, ws, ws_len, step, pol, st);
    case PAIR_MIXED:
        return colk_run<float, double>(Tt, C, F, costs, b, base, w, ah, M, R,
                                       L, r, t, ws, ws_len, step, pol, st);
    case PAIR_F32:
        return colk_run<float, float>(Tt, C, F, costs, b, base, w, ah, M, R,
                                      L, r, t, ws, ws_len, step, pol, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
