// The per-pivot step of the blocked-kernel loop: the scalar glue between
// K1 (ah_ratio) and K2 (colk_costs), as three one-thread kernels.
//
// Replaces no Pallas kernel: in the JAX package this glue is XLA code that
// the jitted lax.fori_loop fuses around the two passes
// (simplex_tpu/solver.py:731-742 before K1, :751-761 between K1 and K2,
// :777-794 after K2). Eagerly it is about 38 dependent one-element torch
// kernels a pivot; here it is three launches (two: step_post also runs the
// next pivot's step_pre), so a CUDA graph of a window holds four nodes a
// pivot.
//
// Bound on the card: latency. Each kernel reads and writes a few dozen
// bytes of 0-dim tensors (kernels.blocked.PivotScalars) in one thread;
// its time is the launch and a handful of dependent global loads. Design:
// one struct of pointers passed by value, so one launch reads every
// scalar it needs with no host work beyond the pointer copy.
//
// Every result keeps the bits of the plain version (kernels/blocked.py
// step_*_plain): the f64 arithmetic is pinned to separate roundings with
// __ddiv_rn / __dmul_rn / __dsub_rn, so nvcc contracts nothing into an FMA.

#include <cuda_runtime.h>

// The fields of kernels.blocked.PivotScalars, in its order; a bool is one
// byte holding 0 or 1. Outside the unnamed namespace: the C entry points
// take it, and a type of internal linkage would give them internal
// linkage too.
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

namespace {

constexpr int BIG_INDEX = 2147483647;
constexpr int RUNNING = -10;
constexpr int OPTIMAL = 0;
constexpr int UNBOUNDED = -2;

// kernels.blocked BLAND_THRESHOLD, BLAND_STATIC, BLAND_NEVER.
enum BlandMode { BLAND_THRESHOLD = 0, BLAND_STATIC = 1, BLAND_NEVER = 2 };

// active, h, minc and optimal of the next pivot.
__device__ void pre(const Step &s, long long max_iter, double eps) {
    *s.active = *s.status == RUNNING && (long long)*s.iterations < max_iter;
    const bool use_bland = *s.bland != 0 && *s.h_b < BIG_INDEX;
    const double minc = use_bland ? *s.v_b : *s.v_d;
    *s.h = use_bland ? *s.h_b : *s.h_d;
    *s.minc = minc;
    *s.optimal = minc > -eps;
}

__global__ void step_pre_kernel(Step s, long long max_iter, double eps) {
    pre(s, max_iter, eps);
}

__global__ void step_mid_kernel(Step s) {
    const bool d = *s.active != 0 && !(*s.optimal != 0 || *s.unb != 0);
    const float p = *s.p_k1;
    *s.do_ = d;
    *s.p = d ? p : 1.0f;
    *s.u = d ? __ddiv_rn(*s.minc, (double)p) : 0.0;
}

__global__ void step_post_kernel(Step s, long long max_iter, double eps,
                                 int bland_mode, int threshold,
                                 int then_pre) {
    const bool d = *s.do_ != 0;
    const double z = *s.z;
    const double z2 = d ? __dsub_rn(z, __dmul_rn(*s.u, *s.bk)) : z;
    const bool improved = fabs(__dsub_rn(z2, z)) >= eps;
    if (*s.active != 0)
        *s.status = *s.optimal != 0 ? OPTIMAL
                    : *s.unb != 0   ? UNBOUNDED
                                    : RUNNING;
    const int stall = d ? (improved ? 0 : *s.stall + 1) : *s.stall;
    *s.stall = stall;
    if (bland_mode == BLAND_STATIC)
        *s.bland = 1;
    else if (bland_mode == BLAND_NEVER)
        *s.bland = 0;
    else if (d)
        *s.bland = !improved && stall >= threshold;
    *s.iterations += d;
    *s.z = z2;
    if (then_pre) pre(s, max_iter, eps);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes). Each takes the host copy of the pointers and
// returns cudaGetLastError() as an int.

extern "C" {

int step_pre_launch(const Step *s, long long max_iter, double eps,
                    void *stream) {
    step_pre_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        *s, max_iter, eps);
    return (int)cudaGetLastError();
}

int step_mid_launch(const Step *s, void *stream) {
    step_mid_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(*s);
    return (int)cudaGetLastError();
}

int step_post_launch(const Step *s, long long max_iter, double eps,
                     int bland_mode, int threshold, int then_pre,
                     void *stream) {
    step_post_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        *s, max_iter, eps, bland_mode, threshold, then_pre);
    return (int)cudaGetLastError();
}

}  // extern "C"
