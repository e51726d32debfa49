// The sequential loops' per-pivot kernels (solver.solve_loop and
// solve_loop_pallas, one CUDA graph a chunk of SEQ_CHUNK pivots).
//
// Replaces no Pallas kernel: in the JAX package the sequential loops are
// lax.while_loops whose pivot is XLA code (simplex_tpu/solver.py:116-157
// iteration_body, with ratio_test :99-113 and choose_entering :79-96; the
// K6 loop's glue around fused_pivot, :239-294). The port's eager loop ran
// that pivot as about 40 torch calls; here one pivot is three nodes:
//
// * seq_ratio (a grid over M): gathers the entering column a_h = Tt[:, h]
//   into the loop's fixed ``ah`` and runs the ratio test -- the first index
//   of the smallest b / a_h over a_h >= eps, the quotient in V, NaN first as
//   torch.argmin orders it, the rows with a_h < eps counted as +inf as
//   torch.where puts them, so k is torch.argmin's; then the block that
//   draws the last arrival ticket runs the step between: k, bk, unbounded,
//   do = active and not (optimal or unbounded), p = a_h[k] where done
//   (else 1) and u = minc / p.
// * seq_colk (a grid over R, and blocks over M): copies the leaving row
//   colk = Tt[k] into the fixed ``colk`` before the rank-1 update
//   overwrites it, updates the costs (costs -= u * colk, two roundings in V)
//   and folds the next entering candidates over them (the Dantzig argmin of
//   the live columns in torch.argmin's order, Bland's lowest eligible
//   index); its M blocks form factor = a_h / p (one rounding in T) into the
//   fixed ``fac`` and update b (b -= bk * factor, b[k] = bk / p, in V). The
//   last R block stores the candidates and base[k] = h, then runs the step
//   after the pivot and the next pivot's step before seq_ratio
//   (seq_step.cuh). Without FOLD it is the K6 loop's snapshot: the copy of
//   row k, b and base[k] = h, no costs (K6 updates them) and no tail.
// * the rank-1 update (csrc/pivot.cu seq_rank1, batch_rank1's tiles for one
//   lane with row k written as colk / p).
//
// plus seq_step_pre (one thread) once a chunk, before its first seq_ratio:
// 3 SEQ_CHUNK + 1 nodes. Every kernel reads its scalars from the loop's
// fixed 0-dim tensors (kernels.seq.SeqScalars), so the chunk's graph holds
// no host value but max_iter, eps, r and the Bland policy.
//
// Bound on the card: latency, not bytes. seq_ratio moves M (2 sizeof(T) +
// sizeof(V)) bytes (0.20 MB at the 8192^2 f64 tableau: 0.06 us at 3.35
// TB/s), seq_colk 2 R sizeof(T) + 2 R sizeof(V) + M (2 sizeof(T) + 2
// sizeof(V)) (0.98 MB, 0.29 us); each is a launch, a dependent load (h or
// k, then the column or row), a block fold, a ticket and the last block's
// fold and stores. Design: K1's and K2's one-launch form without their eta
// slabs: one thread a row (seq_ratio) or a column (seq_colk), each block's
// candidates folded over warp shuffles, one partial a block in the
// caller's workspace, an acq_rel arrival ticket; the block that draws the
// last ticket folds the partials in the same total order (so the results
// do not depend on the blocks' schedule), writes the outputs, resets the
// counter and runs the tail in one thread. The ratio test's winner carries
// its a_h and b, so p == a_h[k] and bk == b[k] with no load after the fold.
//
// Every result keeps the bits of the plain version (kernels/seq.py
// seq_*_plain): every product, quotient and difference is rounded apart
// with the _rn intrinsics (nvcc contracts none of them), an f32 a_h widens
// exactly to f64 before the quotient, and eps is compared in the
// operand's type, as torch compares a tensor with a Python float.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <string.h>

#include "seq_step.cuh"

namespace {

using seq::BIG_INDEX;
using seq::div_rn;
using seq::first;
using seq::inf;
using seq::mul_rn;
using seq::sub_rn;

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// The (tableau, vector) dtype pairs (kernels/seq.py PAIRS).
enum Pair { PAIR_F64 = 0, PAIR_MIXED = 1, PAIR_F32 = 2 };

// The arrival ticket (as csrc/blocked.cu's): one atomic add, acquire and
// release at the device's scope. Its release orders the calling thread's
// partial before the add; in the block that draws the last ticket its
// acquire orders every block's partial before the fold, and the block's
// barrier hands that on to the folding threads, which read past L1.
__device__ __forceinline__ unsigned ticket(unsigned *counter) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    return old;
}

// The host's array of pointers (kernels/seq.py _SeqPtrs) as the struct.
template <typename T, typename V>
SeqStep<T, V> step_of(const void *ptrs) {
    SeqStep<T, V> s;
    memcpy(&s, ptrs, sizeof s);
    return s;
}

// ---------------------------------------------------------------------------
// seq_step_pre: the first pivot's step before seq_ratio, once a chunk.

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
// seq_ratio

// A ratio candidate: its quotient, its row, and the row's a_h and b.
template <typename T, typename V>
struct Ratio {
    V q;
    int j;
    T a;
    V b;
};

template <typename T, typename V>
__device__ __forceinline__ void take_first(Ratio<T, V> &x,
                                           const Ratio<T, V> &o) {
    if (first(o.q, o.j, x.q, x.j)) x = o;
}

template <typename T, typename V>
__device__ __forceinline__ Ratio<T, V> shfl_xor(const Ratio<T, V> &x,
                                                int off) {
    return Ratio<T, V>{__shfl_xor_sync(FULL, x.q, off),
                       __shfl_xor_sync(FULL, x.j, off),
                       __shfl_xor_sync(FULL, x.a, off),
                       __shfl_xor_sync(FULL, x.b, off)};
}

// Block-wide fold of the ratio candidates and of the eligible flag; thread
// 0 gets the result. The whole block calls it.
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

// seq_ratio's workspace (bytes; kernels/seq.py seq_ratio_workspace_bytes
// agrees): [0, 4) the arrival counter, [4, 8) unused, then f64 q[nb],
// a[nb], b[nb] and int j[nb], any[nb] for nb blocks.
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

// ---------------------------------------------------------------------------
// seq_colk

// Block-wide fold of the Dantzig candidate (val, idx) in torch.argmin's
// order and the Bland one (lowest bidx, carrying bval); thread 0 gets the
// result. The whole block calls it.
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

// seq_colk's workspace (bytes; kernels/seq.py seq_colk_workspace_bytes
// agrees): [0, 4) the arrival counter, [4, 8) unused, then f64 val[nb],
// bval[nb] and int idx[nb], bidx[nb] for nb R blocks.
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

// FOLD: the sequential loop's pass (costs, fold, fac, the tail). Without
// it: the K6 loop's snapshot (colk, b and base; costs, fac, ws unread).
// The R blocks come first (n_rblocks of them), then the M blocks. Two
// elements are read by threads other than their writer's kernel-mates:
// h, which the tail's step before rewrites after the last block has read
// it for base[k] (the M blocks of FOLD do not read it), and k, do, p, bk
// and u, which nothing in the kernel writes.
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

template <typename T, typename V>
int step_pre_run(const void *step, long long max_iter, double eps,
                 cudaStream_t st) {
    seq_step_pre_kernel<T, V><<<1, 1, 0, st>>>(step_of<T, V>(step), max_iter,
                                               eps);
    return (int)cudaGetLastError();
}

template <typename T, typename V>
int ratio_run(const void *Tt, const void *b, int M, int R, double eps,
              void *ah, unsigned char *ws, long long ws_bytes,
              const void *step, cudaStream_t st) {
    const int nb = (M + THREADS - 1) / THREADS;
    if (M < 1 || R < 1 || ws_bytes < (long long)ratio_ws_bytes(nb))
        return (int)cudaErrorInvalidValue;       // workspace too small
    seq_ratio_kernel<T, V><<<nb, THREADS, 0, st>>>(
        static_cast<const T *>(Tt), static_cast<const V *>(b), M, R, eps,
        static_cast<T *>(ah), ws, nb, step_of<T, V>(step));
    return (int)cudaGetLastError();
}

template <typename T, typename V, bool FOLD>
int colk_run(const void *Tt, void *costs, void *b, int *base, const void *ah,
             void *colk, void *fac, int M, int R, int r, double eps,
             unsigned char *ws, long long ws_bytes, const void *step,
             const seq::Policy &pol, cudaStream_t st) {
    const int n_rblocks = (R + THREADS - 1) / THREADS;
    const int n_mblocks = (M + THREADS - 1) / THREADS;
    if (M < 1 || R < 1
        || (FOLD && ws_bytes < (long long)colk_ws_bytes(n_rblocks)))
        return (int)cudaErrorInvalidValue;       // workspace too small
    seq_colk_kernel<T, V, FOLD><<<n_rblocks + n_mblocks, THREADS, 0, st>>>(
        static_cast<const T *>(Tt), static_cast<V *>(costs),
        static_cast<V *>(b), base, static_cast<const T *>(ah),
        static_cast<T *>(colk), static_cast<T *>(fac), M, R, r, eps,
        n_rblocks, ws, step_of<T, V>(step), pol);
    return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes). ``step`` is the host's array of the scalars'
// pointers, ``pair`` the dtype pair (PAIR_*); an unknown pair, a shape the
// kernel does not take or a workspace too small is refused with
// cudaErrorInvalidValue. Each returns cudaGetLastError() as an int.

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
                     void *ah, unsigned char *ws, long long ws_bytes,
                     const void *step, int pair, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (pair) {
    case PAIR_F64:
        return ratio_run<double, double>(Tt, b, M, R, eps, ah, ws, ws_bytes,
                                         step, st);
    case PAIR_MIXED:
        return ratio_run<float, double>(Tt, b, M, R, eps, ah, ws, ws_bytes,
                                        step, st);
    case PAIR_F32:
        return ratio_run<float, float>(Tt, b, M, R, eps, ah, ws, ws_bytes,
                                       step, st);
    }
    return (int)cudaErrorInvalidValue;
}

// fold 1: the sequential loop's seq_colk under max_iter, eps, the Bland
// mode, threshold and then_pre; fold 0: the K6 loop's snapshot (pure f32
// only; costs, fac and ws may be null).
int seq_colk_launch(const void *Tt, void *costs, void *b, int *base,
                    const void *ah, void *colk, void *fac, int M, int R,
                    int r, double eps, unsigned char *ws, long long ws_bytes,
                    const void *step, long long max_iter, int bland_mode,
                    int threshold, int then_pre, int fold, int pair,
                    void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const seq::Policy pol{max_iter, eps, bland_mode, threshold, then_pre};
    if (!fold)
        return pair == PAIR_F32
                   ? colk_run<float, float, false>(Tt, costs, b, base, ah,
                                                   colk, fac, M, R, r, eps,
                                                   ws, ws_bytes, step, pol,
                                                   st)
                   : (int)cudaErrorInvalidValue;
    switch (pair) {
    case PAIR_F64:
        return colk_run<double, double, true>(Tt, costs, b, base, ah, colk,
                                              fac, M, R, r, eps, ws,
                                              ws_bytes, step, pol, st);
    case PAIR_MIXED:
        return colk_run<float, double, true>(Tt, costs, b, base, ah, colk,
                                             fac, M, R, r, eps, ws, ws_bytes,
                                             step, pol, st);
    case PAIR_F32:
        return colk_run<float, float, true>(Tt, costs, b, base, ah, colk,
                                            fac, M, R, r, eps, ws, ws_bytes,
                                            step, pol, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
