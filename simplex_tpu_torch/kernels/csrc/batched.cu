// Hand-written Hopper (sm_90a) kernels of the batched window solve: the CUDA
// counterparts of the Pallas passes in simplex_tpu/kernels/batched.py and
// simplex_tpu/kernels/batched_hbm.py.
//
// Layout (row-major, contiguous; B lanes stacked on the leading axis, one
// independent LP per lane):
//   Tt (B*M, R) f32         the lanes' stale transposed tableaus
//   costs, c0 (B, R) f64    working and original reduced costs
//   b, cf (B, M) f64        right-hand sides; basic original costs c0[base]
//   z (B,) f64, base (B, M) i32, devex weights w (B, R) f32 (or null)
//   sci (B, 8) i32          [status, iters, stall, bland, active, max_iter,
//                            unused, unused] -- only slots 0-3 are written
//   C (B*L, R), F (B*L, M), AH (B*L, M) f32
//                           the window's pivot rows, eta rows and live
//                           entering columns (row s of a lane = its pivot s)
//   piv (B*L, 2) i32        the window's walk [h, k], -1 past the last pivot
//   nlive (B,) i32          the pivots each lane applied in the window
// M and R are multiples of 128, L a multiple of 8 (checked by the Python
// wrappers). Lanes are independent: every index (h, k, base, the eta rows)
// is lane-local and every offset is size_t (B*M*R reaches 4.0e8 elements
// at 256 lanes of m = 500 x n = 2,000).
//
// Every kernel launches on the caller's stream and allocates nothing; each
// C entry point returns cudaGetLastError() after its launches. Reductions
// never use atomics: blocks fold in fixed shuffle trees, and every fold
// orders candidates by (key, then lowest index), a total order, so the
// walks repeat run to run. The f64 vector updates use the _rn intrinsics,
// so nvcc does not contract them into FMAs and they round exactly as the
// plain PyTorch versions do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "apply_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BIG_INDEX = 2147483647;
constexpr int LMAX = 128;            // the largest window L
constexpr int FIN_THREADS = 256;
constexpr int RUNNING = -10;
constexpr int OPTIMAL = 0;
constexpr int UNBOUNDED = -2;
constexpr unsigned FULL = 0xffffffffu;

// A candidate fold: the best (key, lowest idx), and the lowest eligible
// index bidx (the Bland candidate; BIG_INDEX in the ratio test's fold).
// The values at idx and bidx are read from the owner after the fold.
struct Cand {
    double key;
    int idx;
    int bidx;
};

__device__ __forceinline__ Cand no_cand() {
    return Cand{-CUDART_INF, BIG_INDEX, BIG_INDEX};
}

__device__ __forceinline__ void merge(Cand &a, const Cand &o) {
    if (o.key > a.key || (o.key == a.key && o.idx < a.idx)) {
        a.key = o.key;
        a.idx = o.idx;
    }
    if (o.bidx < a.bidx) a.bidx = o.bidx;
}

__device__ __forceinline__ Cand shfl_xor(const Cand &c, int off) {
    return Cand{__shfl_xor_sync(FULL, c.key, off),
                __shfl_xor_sync(FULL, c.idx, off),
                __shfl_xor_sync(FULL, c.bidx, off)};
}

// Entering candidates (the single-LP rule, batch_candidates in
// simplex_tpu_torch/kernels/blocked.py): over the active columns j < r, the
// Dantzig argmin of the cost, or under devex the argmax of cost^2 / w over
// the eligible columns (cost <= -eps); the Bland candidate is the lowest
// eligible index.
template <bool DEVEX>
__device__ __forceinline__ void consider(Cand &c, int j, double cost,
                                         float wj, int r, double eps) {
    if (j >= r) return;
    const bool elig = cost <= -eps;
    if (DEVEX) {
        if (elig) {
            const double key = __ddiv_rn(__dmul_rn(cost, cost), (double)wj);
            if (key > c.key || (key == c.key && j < c.idx)) {
                c.key = key;
                c.idx = j;
            }
        }
    } else if (-cost > c.key || (-cost == c.key && j < c.idx)) {
        c.key = -cost;
        c.idx = j;
    }
    if (elig && j < c.bidx) c.bidx = j;
}

// NaN-propagating max/min, as torch.maximum / torch.minimum behave.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : (a > b ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : (a < b ? a : b);
}

// Asynchronous global -> shared copies (sm_80+): 4 bytes through L1, or 16
// bytes past it.
__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// batch_window: one window of up to L deferred eta pivots per lane.
//
// Replaces the pivot loop of batch_window_pass (simplex_tpu/kernels/
// batched.py:521, pallas_call at :582; body _batch_window_kernel :364-514
// and _window_pivot_loop :96-361) and hbm_window_pass (simplex_tpu/kernels/
// batched_hbm.py:330, pallas_call at :373; body _hbm_window_kernel :64).
// Per pivot t, with the TPU kernel's per-pivot fuse (iters < max_iter):
//   h from the candidates; optimal when its cost > -eps
//   a_h[j] = Tt[j, h] - sum_{s<t} C[s, h] F[s, j]          (AH[t])
//   k = argmin over a_h[j] >= eps of b[j] / a_h[j]   (f64, ties: lowest j)
//   colk[j] = Tt[k, j] - sum_{s<t} F[s, k] C[s, j]          (C[t])
//   u = cost[h] / p, costs -= u colk, devex weights, next candidates
//   b[j] -= b[k] a_h[j] / p, b[k] /= p, z -= u b[k]          (f64)
//   F[t] = a_h / p with 1 - 1/p at k, base[k] = h, cf[k] = c0[h]
//   stall / Bland anti-cycling, iters += 1
// The first pivot that does not apply (lane inactive, optimal or unbounded)
// ends the lane's window: every later pivot would be skipped too. Its eta
// rows and those after it are zeros (the TPU kernel's liveness contract).
// The tableau is only read; the apply kernels below fold the etas into it.
//
// Bound on the card: bytes, once each -- per live pivot a strided column
// and a row of the lane's tableau, the eta rows written once, the vectors
// read and written once (0.084 ms at config 3: B = 256, M = 512, R = 3,072,
// L = 32) -- but a lane's pivots are a chain of dependent steps, so what
// the card can reach is the chain's latency times the waves of lanes. The
// TPU kernel kept C and Ft in VMEM scratch for the whole window. The kernel
// this one replaced ran one 512-thread block a lane and read the t live
// eta rows of C and F from global memory at every pivot (7.1 MB a lane a
// 32-pivot window at config 3, 1.8 GB for 256 lanes: more than L2 holds),
// and at B = 32 used 32 of the 132 SMs.
// Design: one thread-block cluster a lane, cs blocks (1-16) of NT threads.
// Block `rank` owns the lane's columns j0 .. j0 + R/cs (costs, devex
// weights, the columns of C) and rows i0 .. i0 + M/cs (b, base, a_h, the
// columns of F). For the whole window its shared memory holds, by the
// host's plan (kernels/batched.py window_plan, passed to the entry point):
// with vec its vectors, and the first res_c rows of its columns of C and
// res_f rows of its columns of F; the rows past them live in global memory
// (L = 128, or a lane too wide for the cluster). Each eta element is
// written to the output once and read from shared memory after that. Per
// pivot each block stages the t values C[s, h] (or F[s, k]) from the block
// that owns h (or k) through distributed shared memory, with cost[h] and
// w[h] (or a_h[k], b[k] and base[k]); runs the FFMA chains of its own rows
// (or columns); and the cluster folds the ratio candidates and then the
// entering candidates, (key, index) pairs: each warp by shuffles, warp 0
// over the block's warps into the block's slot, and after the cluster's
// barrier warp 0 reads the cs slots and folds them by butterfly shuffles
// (a cluster barrier cost less than flags raised in each block's slots
// behind a cluster-scope fence: tools/k7_variants.cu's probes). Every
// thread keeps the lane's scalars (status, iters, stall, bland, z) itself.
// The tableau's column h and row k go to shared memory by cp.async while
// the stage fills, and the row-side updates (b, base, cf, F[t]) run while
// row k is on its way; b[k] and base[k] wait until the next fold, as other
// blocks read them. The plan that fills the card is the fastest the bench
// found at config 3, the wide lanes and L = 128 (PERF.md).
// Arithmetic: every a_h[j] and colk[j] is fmaf over s = 0 .. t-1 in order
// from 0.0f, then one __fsub_rn; the f64 updates and the devex formula are
// unchanged, and the folds are total orders: the outputs do not depend on
// the split, and equal the one-block kernel's bit for bit
// (tools/k7_variants.cu).

// The window's shared memory per block (bytes): the header, then with vec
// the block's costs (f64), b (f64), devex weights (f32), Tt row k, base,
// a_h and Tt column h, then res_c rows of its columns of C and res_f rows
// of its columns of F. kernels/batched.py window_smem_bytes counts the
// same, and the entry point refuses a plan whose count differs.
constexpr int WIN_THREADS = 512;                 // a block's (at most)
constexpr int WIN_HEADER = 2048;
constexpr long long WIN_SMEM_LIMIT = 232448;     // 227 KB a block, sm_90

struct WinHeader {
    Cand red[WIN_THREADS / 32];                  // the warps' candidates
    Cand cslot, rslot;                           // the block's, by kind
    Cand res;                                    // the cluster's
    double minc, bk;                             // cost[h], b[k]
    float wh, p;                                 // w[h], a_h[k]
    int lvar;                                    // base[k]
    float stage[LMAX];                           // C[s, h] or F[s, k], s < t
};
static_assert(sizeof(WinHeader) <= WIN_HEADER, "the window's header");

__host__ __device__ constexpr long long window_smem_bytes(
        int M, int R, int cs, bool devex, int vec, int res_c, int res_f) {
    return WIN_HEADER
           + 4LL * ((long long)(R / cs) * res_c + (long long)(M / cs) * res_f)
           + (vec ? (long long)(R / cs) * (8 + (devex ? 4 : 0) + 4)
                        + (long long)(M / cs) * (8 + 4 + 4 + 4)
                  : 0LL);
}

// The cluster's fold of every thread's candidate (see the design above)
// through the block's slot of its kind; every thread of every block
// returns the same result. The order is total, so neither the split nor
// the tree changes it. A slot is written again only in the next fold of
// its kind, after the other kind's cluster barrier, by which every block
// has read it; the barrier also orders every write before it for every
// block of the cluster.
template <int NT>
__device__ __forceinline__ Cand cluster_fold(Cand c, WinHeader &hd,
                                             Cand *slot,
                                             cg::cluster_group &cl, int cs) {
    constexpr int NW = NT / 32;
    for (int off = 16; off > 0; off >>= 1) merge(c, shfl_xor(c, off));
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    if (ln == 0) hd.red[warp] = c;
    __syncthreads();
    if (warp == 0) {
        c = hd.red[ln % NW];
        for (int off = NW / 2; off > 0; off >>= 1) merge(c, shfl_xor(c, off));
        if (ln == 0) *(cs > 1 ? slot : &hd.res) = c;
    }
    if (cs > 1) {
        cl.sync();
        if (warp == 0) {
            c = *cl.map_shared_rank(slot, ln % cs);
            for (int off = cs / 2; off > 0; off >>= 1)
                merge(c, shfl_xor(c, off));
            if (ln == 0) hd.res = c;
        }
    }
    __syncthreads();
    return hd.res;
}

// acc[g] = sum_{s<t} stage[s] * X[s, col[g]], fmaf in s order from 0.0f,
// for G columns at once (each its own chain): rows s < nres from shared
// memory (row stride lds), the rest from global memory (row stride ldg,
// read past L1: other blocks of the cluster wrote them).
template <int G>
__device__ __forceinline__ void eta_chain(float (&acc)[G], const float *stage,
                                          int t, const float *sm, int lds,
                                          int nres, const float *gm,
                                          size_t ldg, const int (&col)[G]) {
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
    int s = 0;
#pragma unroll 4
    for (; s < nres; ++s) {
        const float a = stage[s];
#pragma unroll
        for (int g = 0; g < G; ++g)
            acc[g] = fmaf(a, sm[(size_t)s * lds + col[g]], acc[g]);
    }
#pragma unroll 8
    for (; s < t; ++s) {
        const float a = stage[s];
#pragma unroll
        for (int g = 0; g < G; ++g)
            acc[g] = fmaf(a, __ldcg(gm + (size_t)s * ldg + col[g]), acc[g]);
    }
}

template <bool DEVEX, int NT>
__global__ void __launch_bounds__(NT, 512 / NT) batch_window(
        const float *__restrict__ Tt, double *__restrict__ costs,
        double *__restrict__ b, double *__restrict__ z,
        int *__restrict__ base, float *__restrict__ w,
        int *__restrict__ sci, const double *__restrict__ c0,
        double *__restrict__ cf, float *__restrict__ C,
        float *__restrict__ F, float *__restrict__ AH,
        int *__restrict__ piv, int *__restrict__ nlive, int M, int R,
        int L, int r, double eps, int bland_static, int threshold, int vec,
        int res_c, int res_f) {
    extern __shared__ __align__(16) unsigned char win_smem[];
    WinHeader &hd = *reinterpret_cast<WinHeader *>(win_smem);
    cg::cluster_group cl = cg::this_cluster();
    const int cs = (int)cl.num_blocks();
    const int rank = (int)cl.block_rank();
    const size_t lane = blockIdx.x / cs;
    const int tid = threadIdx.x;
    const int RC = R / cs, MC = M / cs;
    const int j0 = rank * RC, i0 = rank * MC;    // the block's columns, rows
    const float *T = Tt + lane * M * R;
    costs += lane * R;
    c0 += lane * R;
    b += lane * M;
    cf += lane * M;
    base += lane * M;
    if (DEVEX) w += lane * R;
    sci += lane * 8;
    C += lane * L * R;
    F += lane * L * M;
    AH += lane * L * M;
    piv += lane * L * 2;
    const float feps = (float)eps;

    // The block's vectors: in shared memory with vec, else in place. Every
    // loop below gives element jl (or il) to thread jl % NT, so each
    // thread reads only what it wrote, except what other blocks read after
    // a fold (the eta rows, cost[h], w[h], a_h[k], b[k], base[k]).
    unsigned char *sp = win_smem + WIN_HEADER;
    double *cv = costs + j0, *bv = b + i0;
    float *wv = DEVEX ? w + j0 : nullptr;
    int *basev = base + i0;
    float *trow = nullptr, *ahs = AH, *tcol = nullptr;
    if (vec) {
        cv = reinterpret_cast<double *>(sp);
        sp += 8 * (size_t)RC;
        bv = reinterpret_cast<double *>(sp);
        sp += 8 * (size_t)MC;
        if (DEVEX) {
            wv = reinterpret_cast<float *>(sp);
            sp += 4 * (size_t)RC;
        }
        trow = reinterpret_cast<float *>(sp);
        sp += 4 * (size_t)RC;
        basev = reinterpret_cast<int *>(sp);
        sp += 4 * (size_t)MC;
        ahs = reinterpret_cast<float *>(sp);
        sp += 4 * (size_t)MC;
        tcol = reinterpret_cast<float *>(sp);
        sp += 4 * (size_t)MC;
        for (int jl = tid; jl < RC; jl += NT) {
            cv[jl] = costs[j0 + jl];
            if (DEVEX) wv[jl] = w[j0 + jl];
        }
        for (int il = tid; il < MC; il += NT) {
            bv[il] = b[i0 + il];
            basev[il] = base[i0 + il];
        }
    }
    float *Cs = reinterpret_cast<float *>(sp);   // res_c rows of RC
    float *Fs = Cs + (size_t)res_c * RC;         // res_f rows of MC

    // The lane's scalars, the same in every thread.
    int status = sci[0], iters = sci[1], stall = sci[2], bland = sci[3];
    const int active0 = sci[4], max_iter = sci[5];
    double zl = z[lane];

    Cand cand = no_cand();
    for (int jl = tid; jl < RC; jl += NT)
        consider<DEVEX>(cand, j0 + jl, cv[jl], DEVEX ? wv[jl] : 1.0f, r, eps);
    cand = cluster_fold<NT>(cand, hd, &hd.cslot, cl, cs);

    int t = 0;
    for (; t < L; ++t) {
        // Optimal: no candidate, or Dantzig's least cost (-key, exactly)
        // above -eps; the devex and Bland candidates are eligible.
        const bool active = active0 != 0 && status == RUNNING
                            && iters < max_iter;
        const bool none = cand.key == -CUDART_INF;
        const bool use_b = bland != 0 && cand.bidx < BIG_INDEX;
        const int h = use_b ? cand.bidx : (none ? 0 : cand.idx);
        const bool optimal = !use_b && (none || (!DEVEX && -cand.key > -eps));
        if (active && optimal) status = OPTIMAL;
        if (!active || optimal) break;

        // Live entering column and the min-ratio test over the block's rows:
        // Tt[j, h] by cp.async while C[s, h], cost[h] and w[h] come from h's
        // owner.
        if (vec) {
            for (int il = tid; il < MC; il += NT)
                cp_async4(&tcol[il], T + (size_t)(i0 + il) * R + h);
            cp_async_commit();
        }
        const int oh = h / RC, hl = h - oh * RC;
        const float *ch = res_c ? cl.map_shared_rank(Cs, oh) : nullptr;
        for (int q = tid; q < t; q += NT)
            hd.stage[q] = q < res_c ? ch[(size_t)q * RC + hl]
                                    : __ldcg(C + (size_t)q * R + h);
        if (tid == NT - 1)
            hd.minc = vec ? cl.map_shared_rank(cv, oh)[hl] : __ldcg(costs + h);
        if (DEVEX && tid == NT - 2)
            hd.wh = vec ? cl.map_shared_rank(wv, oh)[hl] : __ldcg(w + h);
        if (vec) cp_async_wait_all();
        __syncthreads();
        const double minc = hd.minc;
        Cand rc = no_cand();                     // key = -(b / a_h)
        const int nf = min(t, res_f);
        for (int ib = tid; ib < MC; ib += 2 * NT) {
            const int col[2] = {ib, min(ib + NT, MC - 1)};
            float acc[2];
            eta_chain<2>(acc, hd.stage, t, Fs, MC, nf, F + i0, M, col);
#pragma unroll
            for (int g = 0; g < 2; ++g) {
                const int il = ib + g * NT;
                if (il >= MC) break;
                const int j = i0 + il;
                const float th =
                    vec ? tcol[il] : __ldg(T + (size_t)j * R + h);
                const float a = __fsub_rn(th, acc[g]);
                AH[(size_t)t * M + j] = a;
                if (vec) ahs[il] = a;
                if (a >= feps) {
                    const double key = -__ddiv_rn(bv[il], (double)a);
                    if (key > rc.key || (key == rc.key && j < rc.idx)) {
                        rc.key = key;
                        rc.idx = j;
                    }
                }
            }
        }
        rc = cluster_fold<NT>(rc, hd, &hd.rslot, cl, cs);
        if (rc.idx == BIG_INDEX) {
            status = UNBOUNDED;
            break;
        }
        const int k = rc.idx;

        // Pivot row, costs, devex weights and the next candidates over the
        // block's columns: Tt[k, j] by cp.async while F[s, k], a_h[k], b[k]
        // and base[k] come from k's owner.
        if (vec) {
            for (int c = tid; c < RC / 4; c += NT)
                cp_async16(&trow[4 * c], T + (size_t)k * R + j0 + 4 * c);
            cp_async_commit();
        }
        const int ok = k / MC, kl = k - ok * MC;
        const float *fk = res_f ? cl.map_shared_rank(Fs, ok) : nullptr;
        for (int q = tid; q < t; q += NT)
            hd.stage[q] = q < res_f ? fk[(size_t)q * MC + kl]
                                    : __ldcg(F + (size_t)q * M + k);
        if (tid == NT - 1) {
            hd.p = vec ? cl.map_shared_rank(ahs, ok)[kl]
                       : __ldcg(AH + (size_t)t * M + k);
            hd.bk = vec ? cl.map_shared_rank(bv, ok)[kl] : __ldcg(b + k);
            hd.lvar = vec ? cl.map_shared_rank(basev, ok)[kl]
                          : __ldcg(base + k);
        }
        __syncthreads();
        const float p = hd.p;                    // a_h[k]
        const double bk = hd.bk;                 // b[k]
        const int lvar = hd.lvar;                // base[k]
        const double u = __ddiv_rn(minc, (double)p);

        // While the row comes: b, cf and the eta row F[t] over the block's
        // rows (a_h[j] was written by this thread; other blocks read only
        // F's rows s < t, and b[k] and base[k], until the next fold, so
        // those two are written after it).
        for (int il = tid; il < MC; il += NT) {
            const int j = i0 + il;
            float f;
            if (j == k) {
                f = __fsub_rn(1.0f, __fdiv_rn(1.0f, p));
                cf[j] = c0[h];
            } else {
                const float a = ahs[vec ? il : (size_t)t * M + j];
                const double d = __ddiv_rn((double)a, (double)p);
                bv[il] = __dsub_rn(bv[il], __dmul_rn(bk, d));
                f = __fdiv_rn(a, p);
            }
            F[(size_t)t * M + j] = f;
            if (t < res_f) Fs[(size_t)t * MC + il] = f;
        }
        if (vec) cp_async_wait_all();
        __syncthreads();
        const float wh = DEVEX ? hd.wh : 0.0f;
        cand = no_cand();
        const int nc = min(t, res_c);
        for (int jb = tid; jb < RC; jb += 4 * NT) {
            int col[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) col[g] = min(jb + g * NT, RC - 1);
            float acc[4];
            eta_chain<4>(acc, hd.stage, t, Cs, RC, nc, C + j0, R, col);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                const int jl = jb + g * NT;
                if (jl >= RC) break;
                const int j = j0 + jl;
                const float tk =
                    vec ? trow[jl] : __ldg(T + (size_t)k * R + j);
                const float colk = __fsub_rn(tk, acc[g]);
                C[(size_t)t * R + j] = colk;
                if (t < res_c) Cs[(size_t)t * RC + jl] = colk;
                const double c =
                    __dsub_rn(cv[jl], __dmul_rn(u, (double)colk));
                cv[jl] = c;
                float wj = 1.0f;
                if (DEVEX) {
                    const float alpha = __fdiv_rn(colk, p);
                    float w2 = max_nan(
                        wv[jl], __fmul_rn(__fmul_rn(alpha, alpha), wh));
                    if (j == lvar)
                        w2 = max_nan(__fdiv_rn(wh, __fmul_rn(p, p)), 1.0f);
                    w2 = min_nan(w2, 1e12f);
                    if (w2 != w2) w2 = 1.0f;
                    wv[jl] = w2;
                    wj = w2;
                }
                consider<DEVEX>(cand, j, c, wj, r, eps);
            }
        }
        cand = cluster_fold<NT>(cand, hd, &hd.cslot, cl, cs);
        if (ok == rank && kl % NT == tid) {      // b[k], base[k], read above
            bv[kl] = __ddiv_rn(bk, (double)p);
            basev[kl] = h;
        }
        if (rank == 0 && tid == 0) {
            piv[2 * t] = h;
            piv[2 * t + 1] = k;
        }
        const double ub = __dmul_rn(u, bk);
        zl = __dsub_rn(zl, ub);
        const bool improved = fabs(ub) >= eps;
        stall = improved ? 0 : stall + 1;
        if (bland_static)
            bland = 1;
        else if (threshold < 0)
            bland = 0;
        else
            bland = (!improved && stall >= threshold) ? 1 : 0;
        iters += 1;
    }

    // Pivots t..L-1 did not apply: zero etas, no walk.
    for (int s = t; s < L; ++s) {
        for (int jl = tid; jl < RC; jl += NT)
            C[(size_t)s * R + j0 + jl] = 0.0f;
        for (int il = tid; il < MC; il += NT) {
            F[(size_t)s * M + i0 + il] = 0.0f;
            AH[(size_t)s * M + i0 + il] = 0.0f;
        }
    }
    if (rank == 0)
        for (int i = 2 * t + tid; i < 2 * L; i += NT) piv[i] = -1;
    if (vec) {
        for (int jl = tid; jl < RC; jl += NT) {
            costs[j0 + jl] = cv[jl];
            if (DEVEX) w[j0 + jl] = wv[jl];
        }
        for (int il = tid; il < MC; il += NT) {
            b[i0 + il] = bv[il];
            base[i0 + il] = basev[il];
        }
    }
    if (rank == 0 && tid == 0) {
        sci[0] = status;
        sci[1] = iters;
        sci[2] = stall;
        sci[3] = bland;
        z[lane] = zl;
        nlive[lane] = t;
    }
    if (cs > 1) cl.sync();   // no block leaves while another may read it
}

// ---------------------------------------------------------------------------
// batch_apply / batch_apply_reprice: per lane Tt -= F^T C in place, with the
// reprice mv = cf^T Tt_new fused (K9) or not (K10).
//
// batch_apply_reprice replaces hbm_apply_reprice_pass (simplex_tpu/kernels/
// batched_hbm.py:214, pallas_call at :236; body _apply_reprice_kernel
// :164-210) and the in-kernel apply + fold of _batch_window_kernel
// (simplex_tpu/kernels/batched.py:436-479); batch_apply replaces
// hbm_apply_pass (batched_hbm.py:281, pallas_call at :300; body
// _apply_kernel :155) and the apply without fuse_reprice.
// Bound on the card: memory. 2 L M R flops per lane against 8 M R bytes of
// tableau read and written: 8 flops per byte at L = 32, under the H100's
// f32 ridge (~20), where K3/K4 at L = 128 sit above it. Measured on NVIDIA
// H100 80GB HBM3, 700.00 W (PERF.md): batch_apply over 256 lanes of
// 512 x 3,072 in 1.46 ms, 2.2 TB/s of tableau traffic, 66% of the 3.35
// TB/s peak. Design: the 128 x 128 register tiles of apply_tile.cuh (this
// kernel's own; blocked.cu's K3/K4 run window_apply) with the lane on
// gridDim.z, so any R that is a multiple of 128 is covered
// (R = 15,104 = 118 tiles). A lane runs only its live eta rows (nlive,
// rounded up to 8; the rows past nlive are zero), and a lane with no live
// row skips its tiles, leaving its Tt untouched -- unless its reprice is
// due (do_r), which then runs over the unchanged tableau. The fold is f64:
// per-128-row partials, then a second pass in M order per lane,
// deterministic; a lane with do_r = 0 gets mv = 0.

template <bool REPRICE>
__global__ void __launch_bounds__(APPLY_THREADS) batch_apply_tiles(
        float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, int M, int R, int L,
        const int *__restrict__ nlive, const int *__restrict__ do_r,
        const double *__restrict__ cf, double *__restrict__ part) {
    const size_t lane = blockIdx.z;
    const int live = nlive[lane];
    const bool fold = REPRICE && do_r[lane] != 0;
    if (live == 0 && !fold) return;
    const int L_live = (live + AK - 1) / AK * AK;
    apply_tile<REPRICE>(
        Tt + lane * M * R, F + lane * L * M, C + lane * L * R, M, R, L_live,
        fold ? cf + lane * M : nullptr,
        fold ? part + (lane * (M / AT) + blockIdx.y) * R : nullptr);
}

__global__ void __launch_bounds__(FIN_THREADS) batch_reprice_finish(
        const double *__restrict__ part, const int *__restrict__ do_r,
        int n_mtiles, int R, double *__restrict__ mv) {
    const size_t lane = blockIdx.y;
    const int j = blockIdx.x * FIN_THREADS + threadIdx.x;
    if (j >= R) return;
    double s = 0.0;
    if (do_r[lane] != 0)
        for (int i = 0; i < n_mtiles; ++i)
            s = __dadd_rn(s, part[(lane * n_mtiles + i) * R + j]);
    mv[lane * R + j] = s;
}

// ---------------------------------------------------------------------------
// batch_reprice (K12): per lane mv = coeffs^T Tt in f64, gated by a flag.
//
// Replaces batch_reprice_pass (simplex_tpu/kernels/batched.py:669,
// pallas_call at :700; body _batch_reprice_kernel :631-666), which no solve
// path calls: the batched loop re-prices through batch_apply_reprice's
// fused fold. The TPU accumulated double-f32 pairs; here the fold is f64.
// Bound on the card: memory. It reads the flagged lanes' tableaus once,
// 4 M R bytes each (computed: 1.61 GB at B = 256, M = 512, R = 3,072, 0.481
// ms at 3.35 TB/s). Design: K11's tiles (apply_tile.cuh reprice_tile) with
// the lane on gridDim.z; a lane with flag 0 skips its tiles, and
// batch_reprice_finish writes it zeros. batch_apply_reprice with no live
// eta row runs the same fold, so it gives the same mv bit for bit.

__global__ void __launch_bounds__(APPLY_THREADS) batch_reprice_tiles(
        const float *__restrict__ Tt, int M, int R,
        const int *__restrict__ flags, const double *__restrict__ cf,
        double *__restrict__ part) {
    const size_t lane = blockIdx.z;
    if (flags[lane] == 0) return;
    reprice_tile(Tt + lane * M * R, R, cf + lane * M,
                 part + (lane * (M / AT) + blockIdx.y) * R);
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

// batch_window<DEVEX, NT> as one launch of B clusters of cs blocks.
template <bool DEVEX, int NT>
int launch_window(const float *Tt, double *costs, double *b, double *z,
                  int *base, float *w, int *sci, const double *c0, double *cf,
                  float *C, float *F, float *AH, int *piv, int *nlive, int B,
                  int M, int R, int L, int r, double eps, int bland_static,
                  int threshold, int cs, int vec, int res_c, int res_f,
                  long long smem, cudaStream_t st) {
    auto kernel = batch_window<DEVEX, NT>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    if (cs > 8)
        cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    RETURN_IF_ERROR();
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)B * cs);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, Tt, costs, b, z, base, w, sci, c0, cf, C, F, AH, piv,
        nlive, M, R, L, r, eps, bland_static, threshold, vec, res_c, res_f);
    if (e != cudaSuccess) return (int)e;
    RETURN_IF_ERROR();
    return 0;
}

}  // namespace

extern "C" {

// The shared memory of one block of batch_window under a plan (bytes).
long long batch_window_smem_bytes(int M, int R, int cs, int devex, int vec,
                                  int res_c, int res_f) {
    return window_smem_bytes(M, R, cs, devex != 0, vec, res_c, res_f);
}

// The plan (cs, vec, res_c, res_f and its shared memory in bytes) comes
// from kernels/batched.py window_plan; a plan this kernel cannot run is
// refused with cudaErrorInvalidValue, a launch the card refuses returns its
// error.
int batch_window_launch(const float *Tt, double *costs, double *b, double *z,
                        int *base, float *w, int *sci, const double *c0,
                        double *cf, float *C, float *F, float *AH, int *piv,
                        int *nlive, int B, int M, int R, int L, int r,
                        double eps, int bland_static, int threshold, int cs,
                        int vec, int res_c, int res_f, long long smem,
                        void *stream) {
    const bool devex = w != nullptr;
    const bool cs_ok = cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == 16;
    if (B < 1 || L < 1 || L > LMAX || !cs_ok || M % cs || R % cs
        || (R / cs) % 4 || res_c < 0
        || res_c > L || res_f < 0 || res_f > L || smem > WIN_SMEM_LIMIT
        || smem != window_smem_bytes(M, R, cs, devex, vec, res_c, res_f))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WINDOW_ARGS                                                          \
    Tt, costs, b, z, base, w, sci, c0, cf, C, F, AH, piv, nlive, B, M, R, L, \
        r, eps, bland_static, threshold, cs, vec, res_c, res_f, smem, st
    return devex ? launch_window<true, WIN_THREADS>(WINDOW_ARGS)
                 : launch_window<false, WIN_THREADS>(WINDOW_ARGS);
#undef WINDOW_ARGS
}

int batch_apply_launch(float *Tt, const float *F, const float *C, int B,
                       int M, int R, int L, const int *nlive, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(R / AT, M / AT, B);
    batch_apply_tiles<false><<<grid, APPLY_THREADS, 0, st>>>(
        Tt, F, C, M, R, L, nlive, nullptr, nullptr, nullptr);
    RETURN_IF_ERROR();
    return 0;
}

int batch_apply_reprice_launch(float *Tt, const float *F, const float *C,
                               int B, int M, int R, int L, const int *nlive,
                               const int *do_r, const double *cf,
                               double *part, double *mv, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(R / AT, M / AT, B);
    batch_apply_tiles<true><<<grid, APPLY_THREADS, 0, st>>>(
        Tt, F, C, M, R, L, nlive, do_r, cf, part);
    RETURN_IF_ERROR();
    const dim3 fgrid((R + FIN_THREADS - 1) / FIN_THREADS, B);
    batch_reprice_finish<<<fgrid, FIN_THREADS, 0, st>>>(part, do_r, M / AT,
                                                         R, mv);
    RETURN_IF_ERROR();
    return 0;
}

int batch_reprice_launch(const float *Tt, int B, int M, int R,
                         const int *flags, const double *cf, double *part,
                         double *mv, void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(R / AT, M / AT, B);
    batch_reprice_tiles<<<grid, APPLY_THREADS, 0, st>>>(Tt, M, R, flags, cf,
                                                        part);
    RETURN_IF_ERROR();
    const dim3 fgrid((R + FIN_THREADS - 1) / FIN_THREADS, B);
    batch_reprice_finish<<<fgrid, FIN_THREADS, 0, st>>>(part, flags, M / AT,
                                                         R, mv);
    RETURN_IF_ERROR();
    return 0;
}

}  // extern "C"
