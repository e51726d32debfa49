// The sharded kernel loop's scalar glue shared by csrc/sharded_step.cu
// (sharded_step_pre, once a window, and sharded_fold, the window's last
// node and the boundary's fold), csrc/blocked.cu (the fold of the
// gathered candidates and the next pivot's step before K5, run as the
// head of K5 for every pivot but a window's first) and csrc/seq.cu (the
// fold in seq_fold_column): fold in one thread, fold_warp in every lane
// of a warp.
//
// Replaces no Pallas kernel: in the JAX package this glue is XLA code that
// the jitted lax.fori_loop under shard_map fuses around the passes and the
// collectives (simplex_tpu/parallel/sharded.py:668-685 before K5, :738-768
// the fold of the gathered candidates).
//
// Every result keeps the bits of the plain version (kernels/blocked.py
// sharded_fold_plain, sharded_step_pre_plain): the fold only compares and
// moves values; NaN orders as torch.max orders it.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

// The fields of kernels.blocked.ShardedScalars, in its order: those of
// PivotScalars (step.cuh's Step, so a ShardStep's first twenty pointers
// are a Step), then the sharded loop's own; a bool is one byte holding 0
// or 1. Outside any unnamed namespace, as Step.
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
};

namespace sharded {

constexpr int BIG_INDEX = 2147483647;
constexpr int RUNNING = -10;
// Ranks whose gathered candidates one batch of loads covers: up to this
// many every load of the fold is issued before any is waited for.
constexpr int FOLD_BATCH = 8;

// The folded candidates: the main one (h_d, v_d, its devex weight w_d)
// and the Bland one (h_b, v_b, w_b); the weights are 1 without devex.
struct Fold {
    int h_d;
    double v_d;
    float w_d;
    int h_b;
    double v_b;
    float w_b;
};

// The fold of the candidates every rank's sharded_pack gathered, V (P, kv)
// f64 with kv 5 under devex ([v_d, v_b, w[h_d], w[h_b], key]) else 2, and
// I (P, 2) int32 (global h_d, h_b): the main candidate from the first rank
// with the largest key (the devex key, else -v_d; a NaN key anywhere makes
// the max NaN, which no key equals, so rank 0), the Bland one from the
// first rank with the lowest global index. Ranks in order, carrying the
// winners' values, in batches of FOLD_BATCH whose loads all go out first.
static __device__ __forceinline__ Fold fold(const double *__restrict__ V,
                                            const int *__restrict__ I,
                                            int P, int kv) {
    const bool devex = kv == 5;
    Fold f{};
    double mx = 0.0;
    bool nan = false;
    for (int r0 = 0; r0 < P; r0 += FOLD_BATCH) {
        double vd[FOLD_BATCH], vb[FOLD_BATCH], wd[FOLD_BATCH],
            wb[FOLD_BATCH], key[FOLD_BATCH];
        int hd[FOLD_BATCH], hb[FOLD_BATCH];
#pragma unroll
        for (int i = 0; i < FOLD_BATCH; ++i) {
            const int r = min(r0 + i, P - 1);
            const double *v = V + (size_t)r * kv;
            vd[i] = v[0];
            vb[i] = v[1];
            wd[i] = devex ? v[2] : 1.0;
            wb[i] = devex ? v[3] : 1.0;
            key[i] = devex ? v[4] : -v[0];
            hd[i] = I[2 * r];
            hb[i] = I[2 * r + 1];
        }
#pragma unroll
        for (int i = 0; i < FOLD_BATCH; ++i) {
            if (r0 + i >= P) break;
            nan |= key[i] != key[i];
            if (r0 + i == 0 || key[i] > mx) {
                mx = key[i];
                f.h_d = hd[i];
                f.v_d = vd[i];
                f.w_d = (float)wd[i];
            }
            if (r0 + i == 0 || hb[i] < f.h_b) {
                f.h_b = hb[i];
                f.v_b = vb[i];
                f.w_b = (float)wb[i];
            }
        }
    }
    if (nan) {                                   // the max is NaN: rank 0
        f.h_d = I[0];
        f.v_d = V[0];
        f.w_d = devex ? (float)V[2] : 1.0f;
    }
    return f;
}

// The ranks one round of fold_warp folds at most: a lane a rank.
constexpr int FOLD_LANES = 32;
constexpr unsigned FOLD_MASK = 0xffffffffu;

// fold's result over one warp, which every lane gets. The ranks go in
// rounds of up to FOLD_LANES, each round's W lanes (the least power of two
// that holds the round; every group of W lanes of the warp holds the same
// ranks) loading their rank's row of V and I at once, the round's only
// trip to memory. log2(W) xor butterflies fold the largest key and the
// lowest global Bland index; a ballot then takes the first lane that holds
// each (ties to the lower rank), and the winners' values come from those
// lanes, the weights already cast to f32 (one shuffle each, under devex
// only). A round's winner replaces the carried one only where it is
// strictly better, so the carried (an earlier rank) keeps a tie. A NaN key
// in any rank makes rank 0 the main candidate, as in fold, its values then
// loaded again. At P = 1 no shuffle runs. Every shuffle counts: each warp
// of a block folds at once, on one SM's shuffle unit. The whole warp calls
// it; its fields equal fold's bit for bit at every P.
static __device__ __forceinline__ Fold fold_warp(const double *__restrict__ V,
                                                 const int *__restrict__ I,
                                                 int P, int kv) {
    const bool devex = kv == 5;
    int W = 1;                                   // lanes a round
    while (W < P && W < FOLD_LANES) W <<= 1;
    const int q = threadIdx.x & (W - 1);         // the lane's rank in a round
    Fold f{};
    double mx = 0.0;
    bool nan = false;
    for (int r0 = 0; r0 < P; r0 += W) {
        const int r = r0 + q;
        const bool in = r < P;
        const double *v = V + (size_t)r * kv;
        double vd = in ? v[0] : 0.0, vb = in ? v[1] : 0.0;
        float wd = in && devex ? (float)v[2] : 1.0f;
        float wb = in && devex ? (float)v[3] : 1.0f;
        const double key = !in ? -CUDART_INF : devex ? v[4] : -vd;
        int hd = in ? I[2 * r] : 0;
        const int hb = in ? I[2 * r + 1] : BIG_INDEX;
        if (__any_sync(FOLD_MASK, key != key)) nan = true;
        double k = key;
        int b = hb;
        if (W > 1) {
            for (int off = W / 2; off > 0; off >>= 1) {
                const double k2 = __shfl_xor_sync(FOLD_MASK, k, off);
                const int b2 = __shfl_xor_sync(FOLD_MASK, b, off);
                k = k2 > k ? k2 : k;
                b = b2 < b ? b2 : b;
            }
            // The first lanes holding the largest key (none where a NaN
            // hides it: then rank 0 wins below) and the lowest index.
            const unsigned kd = __ballot_sync(FOLD_MASK, in && key == k);
            const unsigned kb = __ballot_sync(FOLD_MASK, in && hb == b);
            const int od = kd ? __ffs(kd) - 1 : 0, ob = __ffs(kb) - 1;
            hd = __shfl_sync(FOLD_MASK, hd, od);
            vd = __shfl_sync(FOLD_MASK, vd, od);
            vb = __shfl_sync(FOLD_MASK, vb, ob);
            if (devex) {
                wd = __shfl_sync(FOLD_MASK, wd, od);
                wb = __shfl_sync(FOLD_MASK, wb, ob);
            }
        }
        if (r0 == 0 || k > mx) {
            mx = k;
            f.h_d = hd;
            f.v_d = vd;
            f.w_d = wd;
        }
        if (r0 == 0 || b < f.h_b) {
            f.h_b = b;
            f.v_b = vb;
            f.w_b = wb;
        }
    }
    if (nan) {                                   // the max is NaN: rank 0
        f.h_d = I[0];
        f.v_d = V[0];
        f.w_d = devex ? (float)V[2] : 1.0f;
    }
    return f;
}

static __device__ __forceinline__ void store(const ShardStep &s,
                                             const Fold &f) {
    *s.h_d = f.h_d;
    *s.v_d = f.v_d;
    *s.w_d = f.w_d;
    *s.h_b = f.h_b;
    *s.v_b = f.v_b;
    *s.w_b = f.w_b;
}

// The step before K5 (the single-card step before K1, then the sharded
// loop's own): active, h, minc and optimal; the weight at h, whether this
// rank's slice [offset, offset + R_loc) owns h, and h's local column
// clamped into the slice.
struct Pre {
    bool active, optimal, own;
    int h, hl;
    double minc;
    float wh;
};

static __device__ __forceinline__ Pre pre(int status, int iterations,
                                          bool bland, const Fold &f,
                                          long long max_iter, double eps,
                                          int offset, int R_loc) {
    Pre x;
    x.active = status == RUNNING && (long long)iterations < max_iter;
    const bool use_bland = bland && f.h_b < BIG_INDEX;
    x.h = use_bland ? f.h_b : f.h_d;
    x.minc = use_bland ? f.v_b : f.v_d;
    x.optimal = x.minc > -eps;
    x.wh = use_bland ? f.w_b : f.w_d;
    const long long loc = (long long)x.h - offset;
    x.own = loc >= 0 && loc < R_loc;
    x.hl = (int)(loc < 0 ? 0 : loc >= R_loc ? R_loc - 1 : loc);
    return x;
}

static __device__ __forceinline__ void store(const ShardStep &s,
                                             const Pre &x) {
    *s.active = x.active;
    *s.h = x.h;
    *s.minc = x.minc;
    *s.optimal = x.optimal;
    *s.wh = x.wh;
    *s.own = x.own;
    *s.hl = x.hl;
}

// The step before K5's policy: the iteration fuse, eps and this rank's
// slice.
struct PrePolicy {
    long long max_iter;
    double eps;
    int offset, R_loc;
};

}  // namespace sharded
