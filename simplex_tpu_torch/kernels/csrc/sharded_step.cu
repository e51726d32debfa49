// The per-pivot step of the sharded kernel loop: the glue around K5 (the
// owner's entering column), the column's all_reduce, K2 on the slice and
// the candidates' two all_gathers, as four kernels.
//
// Replaces no Pallas kernel: in the JAX package this glue is XLA code that
// the jitted lax.fori_loop under shard_map fuses around the two passes and
// the collectives (simplex_tpu/parallel/sharded.py:666-768). The port's
// eager loop ran it as about 110 torch calls a pivot; here the window of L
// pivots is one CUDA graph whose nodes a pivot are K5, the all_reduce,
// sharded_ratio, K2, sharded_pack, the two all_gathers and
// sharded_step_post (which also runs the next pivot's sharded_step_pre).
//
// * sharded_step_pre (one thread): active, h, minc and optimal as the
//   single-card step_pre, then h's local index in the slice and whether
//   this rank owns it, and the devex weight at h carried by the fold.
// * sharded_ratio (one block): the min-ratio test on the summed column --
//   the first index of the smallest b / a_h over a_h >= eps, as
//   torch.argmin -- and the scalar tail of the single-card step_mid: do,
//   p, bk, u = minc / p, and the leaving variable base[k], read before K2
//   writes base.
// * sharded_pack (one thread): the slice's candidates from K2 into the
//   all_gather send buffers: [v_d, v_b, w at h_d, w at h_b, key] f64 with
//   key = v_d^2 / w_d (-inf with no eligible column) under devex, [v_d,
//   v_b] otherwise; the candidates' global indices int32.
// * sharded_step_post (one thread): the fold of the gathered candidates --
//   the main one from the first rank with the largest key (-v_d without
//   devex), the Bland one from the first rank with the lowest global index
//   -- then the single-card step_post (z, status, stall, bland,
//   iterations) and, with then_pre, the next pivot's step_pre. With
//   fold_only it folds and stops: the window boundary's fold.
//
// Bound on the card: latency. The one-thread kernels read and write a few
// dozen bytes; sharded_ratio reads a_h and b once (12 bytes a constraint,
// 0.03 us at HBM's rate for M = 8192) and takes one block's fold. Design:
// one struct of pointers passed by value, as csrc/step.cu; sharded_ratio is
// one block of RATIO_THREADS threads, each scanning a strided share of the
// column in index order, folded in shared memory in a total order, so k is
// the same whatever the threads' timing.
//
// Every result keeps the bits of the plain version (kernels/blocked.py
// sharded_*_plain): the f64 arithmetic is pinned to separate roundings
// with __ddiv_rn / __dmul_rn / __dsub_rn, so nvcc contracts nothing into
// an FMA; the eps test of the f32 column compares in f32, as torch
// compares an f32 tensor with a Python float; NaN orders as torch.argmin
// and torch.max order it.

#include <cuda_runtime.h>
#include <math_constants.h>

// The fields of kernels.blocked.ShardedScalars, in its order: those of
// PivotScalars (csrc/step.cu's Step), then the sharded loop's own; a bool
// is one byte holding 0 or 1. Outside the unnamed namespace, as Step.
struct ShardStep {
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
    float *w_d;
    float *w_b;
    float *wh;
    int *hl;
    unsigned char *own;
    int *lvar;
};

namespace {

constexpr int BIG_INDEX = 2147483647;
constexpr int RUNNING = -10;
constexpr int OPTIMAL = 0;
constexpr int UNBOUNDED = -2;
constexpr int RATIO_THREADS = 1024;

// kernels.blocked BLAND_THRESHOLD, BLAND_STATIC, BLAND_NEVER.
enum BlandMode { BLAND_THRESHOLD = 0, BLAND_STATIC = 1, BLAND_NEVER = 2 };

// The next pivot's active, h, minc, optimal, wh, own and hl.
__device__ void pre(const ShardStep &s, long long max_iter, double eps,
                    int offset, int R_loc) {
    *s.active = *s.status == RUNNING && (long long)*s.iterations < max_iter;
    const bool use_bland = *s.bland != 0 && *s.h_b < BIG_INDEX;
    const int h = use_bland ? *s.h_b : *s.h_d;
    const double minc = use_bland ? *s.v_b : *s.v_d;
    *s.h = h;
    *s.minc = minc;
    *s.optimal = minc > -eps;
    *s.wh = use_bland ? *s.w_b : *s.w_d;
    const long long loc = (long long)h - offset;
    *s.own = loc >= 0 && loc < R_loc;
    *s.hl = (int)(loc < 0 ? 0 : loc >= R_loc ? R_loc - 1 : loc);
}

__global__ void sharded_step_pre_kernel(ShardStep s, long long max_iter,
                                        double eps, int offset, int R_loc) {
    pre(s, max_iter, eps, offset, R_loc);
}

// (q, i) before (q2, i2) in torch.argmin's order: NaN first, then the
// smaller value, ties to the lower index.
__device__ __forceinline__ bool ratio_first(double q, int i, double q2,
                                            int i2) {
    const bool nan = q != q, nan2 = q2 != q2;
    if (nan != nan2) return nan;
    if (!nan && q != q2) return q < q2;
    return i < i2;
}

__global__ void __launch_bounds__(RATIO_THREADS) sharded_ratio_kernel(
        ShardStep s, const float *__restrict__ ah,
        const double *__restrict__ b, const int *__restrict__ base, int M,
        float eps) {
    __shared__ double sq[RATIO_THREADS];
    __shared__ int si[RATIO_THREADS];
    __shared__ int sany;
    const int tid = threadIdx.x;
    if (tid == 0) sany = 0;
    double q = CUDART_INF;
    int i = BIG_INDEX;
    bool any = false;
    for (int j = tid; j < M; j += RATIO_THREADS) {
        const float a = ah[j];
        const bool mask = a >= eps;
        const double qj = mask ? __ddiv_rn(b[j], (double)a) : CUDART_INF;
        any |= mask;
        if (ratio_first(qj, j, q, i)) {
            q = qj;
            i = j;
        }
    }
    sq[tid] = q;
    si[tid] = i;
    __syncthreads();
    if (any) sany = 1;                           // a benign race: all write 1
    for (int half = RATIO_THREADS / 2; half > 0; half >>= 1) {
        if (tid < half && ratio_first(sq[tid + half], si[tid + half],
                                      sq[tid], si[tid])) {
            sq[tid] = sq[tid + half];
            si[tid] = si[tid + half];
        }
        __syncthreads();
    }
    if (tid != 0) return;
    const int k = si[0];                         // < M: every q is ordered
    const bool unb = sany == 0;
    const bool d = *s.active != 0 && !(*s.optimal != 0 || unb);
    const float p = d ? ah[k] : 1.0f;
    *s.k = k;
    *s.unb = unb;
    *s.do_ = d;
    *s.p = p;
    *s.bk = b[k];
    *s.u = d ? __ddiv_rn(*s.minc, (double)p) : 0.0;
    *s.lvar = base[k];
}

__global__ void sharded_pack_kernel(ShardStep s, const float *w, int offset,
                                    int R_loc, double *vals, int *idx) {
    const int hd = *s.h_d, hb = *s.h_b;
    const double vd = *s.v_d;
    vals[0] = vd;
    vals[1] = *s.v_b;
    if (w != nullptr) {
        const bool has = hb < BIG_INDEX;
        const double wd = (double)w[min(hd, R_loc - 1)];
        vals[2] = wd;
        vals[3] = has ? (double)w[min(hb, R_loc - 1)] : 1.0;
        vals[4] = has ? __ddiv_rn(__dmul_rn(vd, vd), wd) : -CUDART_INF;
    }
    idx[0] = hd >= BIG_INDEX ? BIG_INDEX : offset + hd;
    idx[1] = hb >= BIG_INDEX ? BIG_INDEX : offset + hb;
}

__global__ void sharded_step_post_kernel(
        ShardStep s, const double *V, const int *I, int P, int kv,
        long long max_iter, double eps, int bland_mode, int threshold,
        int fold_only, int then_pre, int offset, int R_loc) {
    // The fold: the largest key (NaN-propagating, as torch.max), its first
    // rank (rank 0 where the max is NaN); the lowest Bland index, first.
    const bool devex = kv == 5;
    auto key = [&](int r) { return devex ? V[r * kv + 4] : -V[r * kv]; };
    double mx = key(0);
    for (int r = 1; r < P && mx == mx; ++r) {
        const double kr = key(r);
        if (kr != kr || kr > mx) mx = kr;
    }
    int od = 0;
    while (od < P && !(key(od) == mx)) ++od;
    if (od == P) od = 0;
    int ob = 0;
    for (int r = 1; r < P; ++r)
        if (I[r * 2 + 1] < I[ob * 2 + 1]) ob = r;
    *s.h_d = I[od * 2];
    *s.v_d = V[od * kv];
    *s.h_b = I[ob * 2 + 1];
    *s.v_b = V[ob * kv + 1];
    *s.w_d = devex ? (float)V[od * kv + 2] : 1.0f;
    *s.w_b = devex ? (float)V[ob * kv + 3] : 1.0f;
    if (fold_only) return;

    // csrc/step.cu's step_post.
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
    if (then_pre) pre(s, max_iter, eps, offset, R_loc);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (ctypes). Each takes the host copy of the pointers and
// returns cudaGetLastError() as an int.

extern "C" {

int sharded_step_pre_launch(const ShardStep *s, long long max_iter,
                            double eps, int offset, int R_loc, void *stream) {
    sharded_step_pre_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        *s, max_iter, eps, offset, R_loc);
    return (int)cudaGetLastError();
}

int sharded_ratio_launch(const ShardStep *s, const float *ah, const double *b,
                         const int *base, int M, float eps, void *stream) {
    sharded_ratio_kernel<<<1, RATIO_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        *s, ah, b, base, M, eps);
    return (int)cudaGetLastError();
}

int sharded_pack_launch(const ShardStep *s, const float *w, int offset,
                        int R_loc, double *vals, int *idx, void *stream) {
    sharded_pack_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        *s, w, offset, R_loc, vals, idx);
    return (int)cudaGetLastError();
}

int sharded_step_post_launch(const ShardStep *s, const double *V,
                             const int *I, int P, int kv, long long max_iter,
                             double eps, int bland_mode, int threshold,
                             int fold_only, int then_pre, int offset,
                             int R_loc, void *stream) {
    sharded_step_post_kernel<<<1, 1, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        *s, V, I, P, kv, max_iter, eps, bland_mode, threshold, fold_only,
        then_pre, offset, R_loc);
    return (int)cudaGetLastError();
}

}  // extern "C"
