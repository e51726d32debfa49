// The per-pivot step of the sequential loops (solver.solve_loop and
// solve_loop_pallas as one CUDA graph a chunk): the scalar glue around the
// ratio test, the pivot row's pass and the rank-1 update, shared by
// csrc/seq.cu (seq_step_pre, seq_ratio's tail, seq_colk's tail) and
// csrc/pivot.cu (the step after K6 as the tail of K6's last tile block).
//
// Replaces no Pallas kernel: in the JAX package this glue is XLA code that
// the lax.while_loop fuses around the pivot (simplex_tpu/solver.py:116-157
// iteration_body, :239-294 solve_loop_pallas's body).
//
// The blocked-kernel loop's step (step.cuh) keeps p in f32 and the vectors
// in f64. The sequential loops run a tableau of T and vectors of V -- f64
// and f64 (the default options), f32 and f64 (the mixed mode at L = 1),
// f32 and f32 -- so the step here is templated on both, and every result
// keeps the bits of the plain version (kernels/seq.py): each product,
// quotient and difference rounded apart with the _rn intrinsics, which nvcc
// does not contract; eps compared in the operand's type, as torch compares
// a tensor with a Python float.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "step.cuh"

// The fields of kernels.seq.SeqScalars, in its order; a bool is one byte
// holding 0 or 1. The C entry points take the host's array of pointers and
// copy it into this struct (every field is one pointer).
template <typename T, typename V>
struct SeqStep {
    int *status;
    int *iterations;
    int *stall;
    unsigned char *bland;
    V *z;
    int *h_d;
    V *v_d;
    int *h_b;
    V *v_b;
    unsigned char *active;
    int *h;
    V *minc;
    unsigned char *optimal;
    int *k;
    V *bk;
    unsigned char *unb;
    unsigned char *do_;
    T *p;
    V *u;
};

namespace seq {

// The blocked-kernel loop's constants, Bland modes and step policy.
using step::BIG_INDEX;
using step::BLAND_NEVER;
using step::BLAND_STATIC;
using step::OPTIMAL;
using step::Policy;
using step::RUNNING;
using step::UNBOUNDED;

// Every lane of a warp, for its shuffles.
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double div_rn(double a, double b) {
    return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
    return __fdiv_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double abs_v(double a) { return fabs(a); }
__device__ __forceinline__ float abs_v(float a) { return fabsf(a); }

template <typename V>
__device__ __forceinline__ V inf() {
    return (V)CUDART_INF;
}

// (v, i) before (v2, i2) in torch.argmin's order: NaN first, then the
// smaller value, ties to the lower index. A total order over (v, i), so a
// fold in any tree gives the first minimum.
template <typename V>
__device__ __forceinline__ bool first(V v, int i, V v2, int i2) {
    const bool nan = v != v, nan2 = v2 != v2;
    if (nan != nan2) return nan;
    if (!nan && v != v2) return v < v2;
    return i < i2;
}

// The folds (csrc/seq.cu's kernels and csrc/eta.cu's): a total order over
// each candidate, so a fold in any tree gives the same result.

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

// The entering candidates: the Dantzig one (val, idx) in torch.argmin's
// order and the Bland one (the lowest eligible index bidx, carrying bval).
template <typename V>
struct Cands {
    V val;
    int idx;
    V bval;
    int bidx;
};

template <typename V>
__device__ __forceinline__ void take_first(Cands<V> &x, const Cands<V> &o) {
    if (first(o.val, o.idx, x.val, x.idx)) {
        x.val = o.val;
        x.idx = o.idx;
    }
    if (o.bidx < x.bidx) {
        x.bidx = o.bidx;
        x.bval = o.bval;
    }
}

template <typename V>
__device__ __forceinline__ Cands<V> shfl_xor(const Cands<V> &x, int off) {
    return Cands<V>{__shfl_xor_sync(FULL, x.val, off),
                    __shfl_xor_sync(FULL, x.idx, off),
                    __shfl_xor_sync(FULL, x.bval, off),
                    __shfl_xor_sync(FULL, x.bidx, off)};
}

// The warp's fold: every lane gets the warp's result.
template <typename X>
__device__ __forceinline__ X warp_fold(X x) {
    for (int off = 16; off > 0; off >>= 1) take_first(x, shfl_xor(x, off));
    return x;
}

// The block's fold of x and of the flag ``any``: every lane of warp 0 gets
// the block's result. ``warps`` and ``wany`` are the block's shared
// arrays of NW entries; the whole block calls it.
template <int NW, typename X>
__device__ __forceinline__ void block_fold(X &x, bool &any, const X &none,
                                           X *warps, int *wany) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    any = __any_sync(FULL, any);
    x = warp_fold(x);
    if (NW > 1) {
        if (lane == 0) {
            warps[warp] = x;
            wany[warp] = any;
        }
        __syncthreads();
        if (warp == 0) {
            x = warp_fold(lane < NW ? warps[lane] : none);
            any = __any_sync(FULL, lane < NW && wany[lane] != 0);
        }
    }
}

// The step between the ratio test and the pass, from the folded winner.
template <typename T, typename V>
struct Between {
    int k;
    bool d, unb;
    T p;
    V bk, u;
};

template <typename T, typename V>
__device__ __forceinline__ Between<T, V> between(const Ratio<T, V> &x,
                                                 bool any, bool active,
                                                 bool optimal, V minc) {
    const bool unb = !any;                       // x.j < M: every q is ordered
    const bool d = active && !(optimal || unb);
    const T p = d ? x.a : (T)1;
    return Between<T, V>{x.j, d, unb, p, x.b,
                         d ? div_rn(minc, (V)p) : (V)0};
}

template <typename T, typename V>
__device__ __forceinline__ void store(const SeqStep<T, V> &s,
                                      const Between<T, V> &w) {
    *s.k = w.k;
    *s.unb = w.unb;
    *s.do_ = w.d;
    *s.p = w.p;
    *s.bk = w.bk;
    *s.u = w.u;
}

// The entering candidates over the costs: (h_d, v_d) the Dantzig one,
// (h_b, v_b) the Bland one (BIG_INDEX and inf when no column is eligible).
template <typename V>
struct Candidates {
    int h_d;
    V v_d;
    int h_b;
    V v_b;
};

// The step before the ratio test: active, h, minc and optimal of the next
// pivot from the carry's values (solver.choose_entering on the folded
// candidates).
template <typename T, typename V>
__device__ __forceinline__ void pre(const SeqStep<T, V> &s, int status,
                                    int iterations, bool bland,
                                    const Candidates<V> &c,
                                    long long max_iter, double eps) {
    *s.active = status == RUNNING && (long long)iterations < max_iter;
    const bool use_bland = bland && c.h_b < BIG_INDEX;
    const V minc = use_bland ? c.v_b : c.v_d;
    *s.h = use_bland ? c.h_b : c.h_d;
    *s.minc = minc;
    *s.optimal = minc > -(V)eps;
}

// The scalars the step after a pass reads: no block of the pass writes
// them, so a tail may load them before the pass's fold is done.
template <typename V>
struct PostIn {
    int status, iterations, stall;
    bool bland, active, optimal, unb;
    V z, u, bk;
};

template <typename T, typename V>
__device__ __forceinline__ PostIn<V> post_load(const SeqStep<T, V> &s) {
    return {*s.status,      *s.iterations,  *s.stall,
            *s.bland != 0,  *s.active != 0, *s.optimal != 0,
            *s.unb != 0,    *s.z,           *s.u,
            *s.bk};
}

// The step after a pivot's pass, on its do flag ``d``: z -= u * bk where
// done (two roundings); the status (exit_status); the stall counter and
// Bland flag (anticycling_update, improved when z moved by >= eps);
// iterations += do; then, with then_pre, the next pivot's step before the
// ratio test on the candidates ``c``.
template <typename T, typename V>
__device__ __forceinline__ void post(const SeqStep<T, V> &s,
                                     const PostIn<V> &in, bool d,
                                     const Candidates<V> &c,
                                     const Policy &pol) {
    const V z2 = d ? sub_rn(in.z, mul_rn(in.u, in.bk)) : in.z;
    const bool improved = abs_v(sub_rn(z2, in.z)) >= (V)pol.eps;
    const int status = !in.active  ? in.status
                       : in.optimal ? OPTIMAL
                       : in.unb     ? UNBOUNDED
                                    : RUNNING;
    const int stall = d ? (improved ? 0 : in.stall + 1) : in.stall;
    const bool bland = pol.bland_mode == BLAND_STATIC  ? true
                       : pol.bland_mode == BLAND_NEVER ? false
                       : d ? !improved && stall >= pol.threshold
                           : in.bland;
    const int iterations = in.iterations + d;
    *s.status = status;
    *s.stall = stall;
    *s.bland = bland;
    *s.iterations = iterations;
    *s.z = z2;
    if (pol.then_pre)
        pre(s, status, iterations, bland, c, pol.max_iter, pol.eps);
}

}  // namespace seq
