// The per-pivot step of the blocked-kernel loop: the scalar glue between
// K1 (ah_ratio) and K2 (colk_costs), shared by csrc/step.cu (step_pre, its
// own one-thread kernel, launched once a window) and csrc/blocked.cu (the
// steps between K1 and K2 and after K2, run as tails of K1 and K2). The
// sequential loops' step (csrc/seq_step.cuh) takes its constants, Bland
// modes and Policy.
//
// Replaces no Pallas kernel: in the JAX package this glue is XLA code that
// the jitted lax.fori_loop fuses around the two passes
// (simplex_tpu/solver.py:731-742 before K1, :751-761 between K1 and K2,
// :777-794 after K2).
//
// Every result keeps the bits of the plain version (kernels/blocked.py
// step_*_plain): the f64 arithmetic is pinned to separate roundings with
// __ddiv_rn / __dmul_rn / __dsub_rn, so nvcc contracts nothing into an FMA.

#pragma once

#include <cuda_runtime.h>

// The fields of kernels.blocked.PivotScalars, in its order; a bool is one
// byte holding 0 or 1. Outside any unnamed namespace: the C entry points
// take it, and a type of internal linkage would give them internal
// linkage too. All null where a kernel runs without a tail.
struct Step {
    int *status;
    int *iterations;
    int *stall;
    unsigned char *bland;
    double *z;
    int *h_d;
    double *v_d;
    int *h_b;
    double *v_b;
    unsigned char *active;
    int *h;
    double *minc;
    unsigned char *optimal;
    int *k;
    float *p_k1;
    double *bk;
    int *unb;
    unsigned char *do_;
    float *p;
    double *u;
};

namespace step {

constexpr int BIG_INDEX = 2147483647;
constexpr int RUNNING = -10;
constexpr int OPTIMAL = 0;
constexpr int UNBOUNDED = -2;

// kernels.blocked BLAND_THRESHOLD, BLAND_STATIC, BLAND_NEVER.
enum BlandMode { BLAND_THRESHOLD = 0, BLAND_STATIC = 1, BLAND_NEVER = 2 };

// The step after K2's options: the iteration fuse, eps, the Bland policy
// and whether the next pivot's step before K1 follows.
struct Policy {
    long long max_iter;
    double eps;
    int bland_mode;
    int threshold;
    int then_pre;
};

// The entering candidates K2 folds: (h_d, v_d) the main one, (h_b, v_b)
// the Bland one.
struct Candidates {
    int h_d;
    double v_d;
    int h_b;
    double v_b;
};

// The step before K1: active, h, minc and optimal of the next pivot, from
// the carry's values.
static __device__ __forceinline__ void pre(const Step &s, int status,
                                           int iterations, bool bland,
                                           const Candidates &c,
                                           long long max_iter, double eps) {
    *s.active = status == RUNNING && (long long)iterations < max_iter;
    const bool use_bland = bland && c.h_b < BIG_INDEX;
    const double minc = use_bland ? c.v_b : c.v_d;
    *s.h = use_bland ? c.h_b : c.h_d;
    *s.minc = minc;
    *s.optimal = minc > -eps;
}

// The scalars the step between K1 and K2 reads besides K1's outputs: the
// step before K1 wrote them, and K1 writes none of them, so a tail may
// load them before K1's fold is done.
struct MidIn {
    bool active, optimal;
    double minc;
};

static __device__ __forceinline__ MidIn mid_load(const Step &s) {
    return {*s.active != 0, *s.optimal != 0, *s.minc};
}

// The step between K1 and K2, on K1's p and unbounded flag: do = active
// and not (optimal or unbounded); p where done, else 1; u = minc / p in
// f64 where done, else 0.
static __device__ __forceinline__ void mid(const Step &s, const MidIn &in,
                                           float p, bool unb) {
    const bool d = in.active && !(in.optimal || unb);
    *s.do_ = d;
    *s.p = d ? p : 1.0f;
    *s.u = d ? __ddiv_rn(in.minc, (double)p) : 0.0;
}

// The scalars the step after K2 reads: K2 writes none of them, so a tail
// may load them before K2's fold is done.
struct PostIn {
    int status, iterations, stall;
    bool bland, active, optimal, unb;
    double z, u, bk;
};

static __device__ __forceinline__ PostIn post_load(const Step &s) {
    return {*s.status,      *s.iterations,   *s.stall,
            *s.bland != 0,  *s.active != 0,  *s.optimal != 0,
            *s.unb != 0,    *s.z,            *s.u,
            *s.bk};
}

// The step after K2, on the pivot's do flag ``d`` and K2's candidates:
// z -= u * bk where done (two roundings); the status; the stall counter
// and Bland flag (improved when z moved by >= eps); iterations += do; then,
// with then_pre, the next pivot's step before K1.
static __device__ __forceinline__ void post(const Step &s, const PostIn &in,
                                            bool d, const Candidates &c,
                                            const Policy &pol) {
    const double z2 = d ? __dsub_rn(in.z, __dmul_rn(in.u, in.bk)) : in.z;
    const bool improved = fabs(__dsub_rn(z2, in.z)) >= pol.eps;
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

}  // namespace step
