// K7/K8 (csrc/batched.cu batch_window, the batched solve's window of up to
// L pivots a lane) on the card: the shipped kernel under the plans it can
// run, beside a verbatim copy of the kernel it replaced (one 512-thread
// block a lane, the eta rows re-read from global memory at every pivot),
// every output of every plan checked bit for bit against the old kernel's
// (C F AH piv nlive costs b z base w cf sci). Build and run on a machine
// with an H100:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/k7_variants tools/k7_variants.cu && /tmp/k7_variants
//
// States (chip_smoke.py's lane mix: lane 1 frozen, nlive 0; lane 2 with
// its fuse at 5 pivots; every other lane RUNNING with room for L pivots;
// r = R - 5, eps 1e-5, Bland after 50 stalls): config 3 (B=256, M=512,
// R=3072, L=32) and the wide shape (B=32, M=512, R=15104, L=32) under
// devex and Dantzig, and B=64, M=512, R=3072, L=128 under devex.
// Plans (cs blocks a cluster, threads a block, the vectors in shared
// memory, res_c rows of C and res_f of F in shared memory, the rest read
// from global memory / L2):
//   shipped      what kernels/batched.py window_plan picks for the shape;
//   csN res tT   as many rows as fit one block's 227 KB (C resident where
//                it fits: design (a), lanes in waves), T threads a block;
//   csN half tT  half of those rows of C (a resident prefix);
//   csN L2 tT    no row of C resident (design (b): C from L2);
//   cs4 global   the vectors and every eta row in global memory (the plan
//                for a lane too wide for the vectors to fit);
// for N = 1, 2, 4, 8, 16 and T = 512, 256, 128. First, probes of a
// pivot's fixed costs at each cluster size: one cluster barrier, one
// cluster fold, one __syncthreads, one load from another block's shared
// memory. ms a call by CUDA events around
// each launch (the state's reset outside), 5 calls a plan, three rounds in
// turns, with the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters) and the time a pivot of a wave of lanes
// this implies printed beside.

#include <algorithm>
#include <cstdio>
#include <vector>

#include "../simplex_tpu_torch/kernels/csrc/batched.cu"

// The kernel batch_window replaced, verbatim.
namespace old_k7 {

constexpr int BIG_INDEX = 2147483647;
constexpr int WT = 512;              // threads of a lane's window block
constexpr int WARPS = WT / 32;
constexpr int LMAX = 128;            // the largest window L
constexpr int FIN_THREADS = 256;
constexpr int RUNNING = -10;
constexpr int OPTIMAL = 0;
constexpr int UNBOUNDED = -2;
constexpr unsigned FULL = 0xffffffffu;

// A candidate fold: the best (key, lowest idx) carrying val, and the lowest
// eligible index bidx carrying bval (the Bland candidate).
struct Cand {
    double key;
    int idx;
    double val;
    int bidx;
    double bval;
};

__device__ __forceinline__ Cand no_cand() {
    return Cand{-CUDART_INF, BIG_INDEX, CUDART_INF, BIG_INDEX, CUDART_INF};
}

__device__ __forceinline__ void merge(Cand &a, const Cand &o) {
    if (o.key > a.key || (o.key == a.key && o.idx < a.idx)) {
        a.key = o.key;
        a.idx = o.idx;
        a.val = o.val;
    }
    if (o.bidx < a.bidx) {
        a.bidx = o.bidx;
        a.bval = o.bval;
    }
}

__device__ __forceinline__ Cand shfl_down(const Cand &c, int off) {
    return Cand{__shfl_down_sync(FULL, c.key, off),
                __shfl_down_sync(FULL, c.idx, off),
                __shfl_down_sync(FULL, c.val, off),
                __shfl_down_sync(FULL, c.bidx, off),
                __shfl_down_sync(FULL, c.bval, off)};
}

// Block-wide fold of every thread's Cand; every thread returns the result.
__device__ Cand block_fold(Cand c, Cand *red, Cand *out) {
    for (int off = 16; off > 0; off >>= 1) merge(c, shfl_down(c, off));
    const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
    if (ln == 0) red[warp] = c;
    __syncthreads();
    if (warp == 0) {
        c = ln < WARPS ? red[ln] : no_cand();
        for (int off = 16; off > 0; off >>= 1) merge(c, shfl_down(c, off));
        if (ln == 0) *out = c;
    }
    __syncthreads();
    return *out;
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
                c.val = cost;
            }
        }
    } else if (-cost > c.key || (-cost == c.key && j < c.idx)) {
        c.key = -cost;
        c.idx = j;
        c.val = cost;
    }
    if (elig && j < c.bidx) {
        c.bidx = j;
        c.bval = cost;
    }
}

// NaN-propagating max/min, as torch.maximum / torch.minimum behave.
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : (a > b ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? CUDART_NAN_F : (a < b ? a : b);
}

// The lane's scalars, owned by thread 0 and read by all after a barrier.
struct LaneState {
    int status, iters, stall, bland, active0, max_iter;
    int go, h, k, lvar;
    double z, minc, u, bk;
    float p, wh;
};

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
// Bound on the card: latency. One block per lane runs its L pivots in
// order, each three block-wide folds and two reads of the live eta rows
// (t (R + M) 4 bytes: 0.46 MB at t = 31, R = 3,072, M = 512, computed),
// plus one strided column of Tt (M loads at stride R) and one row. The TPU
// tiers differ only in where the tableau sat (VMEM or HBM); a config-3 lane
// (6.3 MB) fits no more in 228 KB of shared memory than a 31 MB lane, so
// one kernel with the tableau in global memory serves both. Design: 512
// threads per lane, the t eta values of column h and row k staged in shared
// memory, coalesced reads of C and F, warp-shuffle folds. At 64 registers a
// thread two blocks fit an SM, so 256 lanes run in one wave on 132 SMs; at
// 32 lanes 100 SMs sit idle (clusters and DSMEM would split a lane across
// SMs: a later PR). Measured on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md):
// a 32-pivot window of 256 lanes (R = 3,072) in 1.18 ms, 37 us per pivot
// step; of 32 lanes at R = 15,104 in 2.39 ms.
template <bool DEVEX>
__global__ void __launch_bounds__(WT, 2) batch_window(
        const float *__restrict__ Tt, double *__restrict__ costs,
        double *__restrict__ b, double *__restrict__ z,
        int *__restrict__ base, float *__restrict__ w,
        int *__restrict__ sci, const double *__restrict__ c0,
        double *__restrict__ cf, float *__restrict__ C,
        float *__restrict__ F, float *__restrict__ AH,
        int *__restrict__ piv, int *__restrict__ nlive, int M, int R,
        int L, int r, double eps, int bland_static, int threshold) {
    __shared__ Cand red[WARPS];
    __shared__ Cand res;
    __shared__ float stage[LMAX];
    __shared__ LaneState s;

    const size_t lane = blockIdx.x;
    const int tid = threadIdx.x;
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

    if (tid == 0) {
        s.status = sci[0];
        s.iters = sci[1];
        s.stall = sci[2];
        s.bland = sci[3];
        s.active0 = sci[4];
        s.max_iter = sci[5];
        s.z = z[lane];
    }
    Cand cand = no_cand();
    for (int j = tid; j < R; j += WT)
        consider<DEVEX>(cand, j, costs[j], DEVEX ? w[j] : 1.0f, r, eps);
    cand = block_fold(cand, red, &res);

    int t = 0;
    for (; t < L; ++t) {
        if (tid == 0) {
            const bool active = s.active0 != 0 && s.status == RUNNING
                                && s.iters < s.max_iter;
            const bool none = cand.key == -CUDART_INF;
            const bool use_b = s.bland != 0 && cand.bidx < BIG_INDEX;
            s.h = use_b ? cand.bidx : (none ? 0 : cand.idx);
            s.minc = use_b ? cand.bval : (none ? CUDART_INF : cand.val);
            const bool optimal = s.minc > -eps;
            if (active && optimal) s.status = OPTIMAL;
            s.go = active && !optimal;
        }
        __syncthreads();
        if (!s.go) break;
        const int h = s.h;

        // Live entering column and the min-ratio test.
        for (int q = tid; q < t; q += WT) stage[q] = C[(size_t)q * R + h];
        __syncthreads();
        Cand rc = no_cand();
        for (int j = tid; j < M; j += WT) {
            float acc = 0.0f;
            for (int q = 0; q < t; ++q)
                acc = fmaf(stage[q], F[(size_t)q * M + j], acc);
            const float a = __fsub_rn(T[(size_t)j * R + h], acc);
            AH[(size_t)t * M + j] = a;
            if (a >= feps) {
                const double key = -__ddiv_rn(b[j], (double)a);
                if (key > rc.key || (key == rc.key && j < rc.idx)) {
                    rc.key = key;
                    rc.idx = j;
                }
            }
        }
        rc = block_fold(rc, red, &res);
        if (tid == 0) {
            if (rc.idx == BIG_INDEX) {
                s.status = UNBOUNDED;
                s.go = 0;
            } else {
                const int k = rc.idx;
                s.k = k;
                s.p = AH[(size_t)t * M + k];
                s.bk = b[k];
                s.u = __ddiv_rn(s.minc, (double)s.p);
                s.lvar = base[k];
                s.wh = DEVEX ? w[h] : 0.0f;
            }
        }
        __syncthreads();
        if (!s.go) break;
        const int k = s.k;
        const float p = s.p;
        const double u = s.u;

        // Pivot row, costs, devex weights and the next candidates.
        for (int q = tid; q < t; q += WT) stage[q] = F[(size_t)q * M + k];
        __syncthreads();
        cand = no_cand();
        for (int j = tid; j < R; j += WT) {
            float acc = 0.0f;
            for (int q = 0; q < t; ++q)
                acc = fmaf(stage[q], C[(size_t)q * R + j], acc);
            const float colk = __fsub_rn(T[(size_t)k * R + j], acc);
            C[(size_t)t * R + j] = colk;
            const double c = __dsub_rn(costs[j], __dmul_rn(u, (double)colk));
            costs[j] = c;
            float wj = 1.0f;
            if (DEVEX) {
                const float wh = s.wh;
                const float alpha = __fdiv_rn(colk, p);
                float w2 = max_nan(w[j], __fmul_rn(__fmul_rn(alpha, alpha),
                                                   wh));
                if (j == s.lvar)
                    w2 = max_nan(__fdiv_rn(wh, __fmul_rn(p, p)), 1.0f);
                w2 = min_nan(w2, 1e12f);
                if (w2 != w2) w2 = 1.0f;
                w[j] = w2;
                wj = w2;
            }
            consider<DEVEX>(cand, j, c, wj, r, eps);
        }
        cand = block_fold(cand, red, &res);

        // b, base, cf and the eta row. a_h[j] was written by this thread.
        const double bk = s.bk;
        for (int j = tid; j < M; j += WT) {
            const float a = AH[(size_t)t * M + j];
            if (j == k) {
                b[j] = __ddiv_rn(bk, (double)p);
                F[(size_t)t * M + j] = __fsub_rn(1.0f, __fdiv_rn(1.0f, p));
                base[j] = h;
                cf[j] = c0[h];
            } else {
                const double d = __ddiv_rn((double)a, (double)p);
                b[j] = __dsub_rn(b[j], __dmul_rn(bk, d));
                F[(size_t)t * M + j] = __fdiv_rn(a, p);
            }
        }
        if (tid == 0) {
            piv[2 * t] = h;
            piv[2 * t + 1] = k;
            const double ub = __dmul_rn(u, bk);
            s.z = __dsub_rn(s.z, ub);
            const bool improved = fabs(ub) >= eps;
            s.stall = improved ? 0 : s.stall + 1;
            if (bland_static)
                s.bland = 1;
            else if (threshold < 0)
                s.bland = 0;
            else
                s.bland = (!improved && s.stall >= threshold) ? 1 : 0;
            s.iters += 1;
        }
        __syncthreads();
    }

    // Pivots t..L-1 did not apply: zero etas, no walk.
    for (size_t i = (size_t)t * R + tid; i < (size_t)L * R; i += WT)
        C[i] = 0.0f;
    for (size_t i = (size_t)t * M + tid; i < (size_t)L * M; i += WT) {
        F[i] = 0.0f;
        AH[i] = 0.0f;
    }
    for (int i = 2 * t + tid; i < 2 * L; i += WT) piv[i] = -1;
    if (tid == 0) {
        sci[0] = s.status;
        sci[1] = s.iters;
        sci[2] = s.stall;
        sci[3] = s.bland;
        z[lane] = s.z;
        nlive[lane] = t;
    }
}

}  // namespace old_k7

namespace {

__global__ void fill(float *x, size_t n, unsigned seed, float lo, float hi) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        unsigned v = (unsigned)i * 2654435761u ^ seed;
        v ^= v >> 13;
        v *= 0x5bd1e995u;
        v ^= v >> 15;
        x[i] = lo + (hi - lo) * (v & 0xffffff) / 16777216.0f;
    }
}

__global__ void fill64(double *x, size_t n, unsigned seed, double lo,
                       double hi) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        unsigned v = (unsigned)i * 2246822519u ^ seed;
        v ^= v >> 15;
        v *= 0x2c1b3c6du;
        v ^= v >> 12;
        x[i] = lo + (hi - lo) * (v & 0xffffff) / 16777216.0;
    }
}

// Distinct basic columns per lane: base[lane, i] = (7 i + lane) mod R.
__global__ void fill_base(int *base, int B, int M, int R) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
         i < (size_t)B * M; i += (size_t)gridDim.x * blockDim.x)
        base[i] = (int)((7 * (i % M) + i / M) % R);
}

// Elements whose bits differ (n words of 4 bytes).
__global__ void count_diff(const unsigned *a, const unsigned *b, size_t n,
                           unsigned long long *cnt) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x)
        if (a[i] != b[i]) atomicAdd(cnt, 1ull);
}

unsigned long long *CNT = nullptr;

unsigned long long differ(const void *a, const void *b, size_t bytes) {
    cudaMemset(CNT, 0, 8);
    count_diff<<<1024, 256>>>(static_cast<const unsigned *>(a),
                              static_cast<const unsigned *>(b), bytes / 4,
                              CNT);
    unsigned long long h = 1;
    cudaMemcpy(&h, CNT, 8, cudaMemcpyDeviceToHost);
    return h;
}

struct Shape {
    const char *name;
    int B, M, R, L;
    bool devex;
};

struct Plan {
    const char *name;
    int cs, threads, vec, res_c, res_f;
};

// A window's arrays: the inputs it updates in place, then its outputs.
struct Window {
    double *costs, *b, *z, *cf;
    int *base, *sci;
    float *w, *C, *F, *AH;
    int *piv, *nlive;
};

Window alloc_window(const Shape &s) {
    Window x{};
    const size_t B = s.B, M = s.M, R = s.R, L = s.L;
    cudaMalloc(&x.costs, B * R * 8);
    cudaMalloc(&x.b, B * M * 8);
    cudaMalloc(&x.z, B * 8);
    cudaMalloc(&x.cf, B * M * 8);
    cudaMalloc(&x.base, B * M * 4);
    cudaMalloc(&x.sci, B * 8 * 4);
    x.w = nullptr;
    if (s.devex) cudaMalloc(&x.w, B * R * 4);
    cudaMalloc(&x.C, B * L * R * 4);
    cudaMalloc(&x.F, B * L * M * 4);
    cudaMalloc(&x.AH, B * L * M * 4);
    cudaMalloc(&x.piv, B * L * 2 * 4);
    cudaMalloc(&x.nlive, B * 4);
    return x;
}

void free_window(Window &x) {
    cudaFree(x.costs); cudaFree(x.b); cudaFree(x.z); cudaFree(x.cf);
    cudaFree(x.base); cudaFree(x.sci); cudaFree(x.w); cudaFree(x.C);
    cudaFree(x.F); cudaFree(x.AH); cudaFree(x.piv); cudaFree(x.nlive);
}

// The inputs of `from` into `to` (the outputs are written by the kernels).
void reset(const Shape &s, const Window &from, Window &to, cudaStream_t st) {
    const size_t B = s.B, M = s.M, R = s.R;
    cudaMemcpyAsync(to.costs, from.costs, B * R * 8, cudaMemcpyDefault, st);
    cudaMemcpyAsync(to.b, from.b, B * M * 8, cudaMemcpyDefault, st);
    cudaMemcpyAsync(to.z, from.z, B * 8, cudaMemcpyDefault, st);
    cudaMemcpyAsync(to.cf, from.cf, B * M * 8, cudaMemcpyDefault, st);
    cudaMemcpyAsync(to.base, from.base, B * M * 4, cudaMemcpyDefault, st);
    cudaMemcpyAsync(to.sci, from.sci, B * 8 * 4, cudaMemcpyDefault, st);
    if (s.devex)
        cudaMemcpyAsync(to.w, from.w, B * R * 4, cudaMemcpyDefault, st);
}

// Words of every output of a and b that differ, printed; the total.
unsigned long long compare(const Shape &s, const Window &a, const Window &b,
                           const char *label) {
    const size_t B = s.B, M = s.M, R = s.R, L = s.L;
    struct {
        const char *name;
        const void *x, *y;
        size_t bytes;
    } f[] = {{"C", a.C, b.C, B * L * R * 4},
             {"F", a.F, b.F, B * L * M * 4},
             {"AH", a.AH, b.AH, B * L * M * 4},
             {"piv", a.piv, b.piv, B * L * 2 * 4},
             {"nlive", a.nlive, b.nlive, B * 4},
             {"costs", a.costs, b.costs, B * R * 8},
             {"b", a.b, b.b, B * M * 8},
             {"z", a.z, b.z, B * 8},
             {"base", a.base, b.base, B * M * 4},
             {"w", a.w, b.w, s.devex ? B * R * 4 : 0},
             {"cf", a.cf, b.cf, B * M * 8},
             {"sci", a.sci, b.sci, B * 8 * 4}};
    unsigned long long total = 0;
    printf("K7 %s %-16s words differing from the old kernel's:", s.name,
           label);
    for (auto &e : f) {
        if (e.bytes == 0) continue;
        const unsigned long long d = differ(e.x, e.y, e.bytes);
        total += d;
        printf(" %s %llu", e.name, d);
    }
    printf("\n");
    return total;
}

void launch_old(const Shape &s, const float *Tt, const double *c0, Window &x,
                cudaStream_t st) {
    const int r = s.R - 5;
    if (s.devex)
        old_k7::batch_window<true><<<s.B, old_k7::WT, 0, st>>>(
            Tt, x.costs, x.b, x.z, x.base, x.w, x.sci, c0, x.cf, x.C, x.F,
            x.AH, x.piv, x.nlive, s.M, s.R, s.L, r, 1e-5, 0, 50);
    else
        old_k7::batch_window<false><<<s.B, old_k7::WT, 0, st>>>(
            Tt, x.costs, x.b, x.z, x.base, nullptr, x.sci, c0, x.cf, x.C,
            x.F, x.AH, x.piv, x.nlive, s.M, s.R, s.L, r, 1e-5, 0, 50);
}

// The shipped entry point at its WIN_THREADS; another thread count
// through the kernel's template, as the entry point would launch it.
int launch_new(const Shape &s, const Plan &p, const float *Tt,
               const double *c0, Window &x, cudaStream_t st) {
    const long long smem = window_smem_bytes(s.M, s.R, p.cs, s.devex, p.vec,
                                             p.res_c, p.res_f);
    if (p.threads == WIN_THREADS)
        return batch_window_launch(
            Tt, x.costs, x.b, x.z, x.base, s.devex ? x.w : nullptr, x.sci,
            c0, x.cf, x.C, x.F, x.AH, x.piv, x.nlive, s.B, s.M, s.R, s.L,
            s.R - 5, 1e-5, 0, 50, p.cs, p.vec, p.res_c, p.res_f, smem, st);
#define ARGS                                                                 \
    Tt, x.costs, x.b, x.z, x.base, s.devex ? x.w : nullptr, x.sci, c0, x.cf, \
        x.C, x.F, x.AH, x.piv, x.nlive, s.B, s.M, s.R, s.L, s.R - 5, 1e-5, 0, \
        50, p.cs, p.vec, p.res_c, p.res_f, smem, st
    if (s.devex)
        return p.threads == 256 ? launch_window<true, 256>(ARGS)
                                : launch_window<true, 128>(ARGS);
    return p.threads == 256 ? launch_window<false, 256>(ARGS)
                            : launch_window<false, 128>(ARGS);
#undef ARGS
}

// The most rows of C that fit one block's shared memory (227 KB) beside
// the vectors and F's first res_f rows, at most L.
int fit_c(const Shape &s, int cs, int res_f) {
    const long long base = window_smem_bytes(s.M, s.R, cs, s.devex, 1, 0,
                                             res_f);
    const long long row = 4LL * (s.R / cs);
    const long long n = (WIN_SMEM_LIMIT - base) / row;
    return n < 0 ? -1 : (n > s.L ? s.L : (int)n);
}

int fit_f(const Shape &s, int cs) {
    const long long base = window_smem_bytes(s.M, s.R, cs, s.devex, 1, 0, 0);
    const long long n = (WIN_SMEM_LIMIT - base) / (4LL * (s.M / cs));
    return n < 0 ? -1 : (n > s.L ? s.L : (int)n);
}

int bench(const Shape &s, const Plan &shipped) {
    const size_t B = s.B, M = s.M, R = s.R;
    float *Tt;
    double *c0;
    cudaMalloc(&Tt, B * M * R * 4);
    cudaMalloc(&c0, B * R * 8);
    Window in = alloc_window(s), ref = alloc_window(s), x = alloc_window(s);
    fill<<<4096, 256>>>(Tt, B * M * R, 11, -1.0f, 1.0f);
    fill64<<<1024, 256>>>(c0, B * R, 12, -1.0, 1.0);
    fill64<<<1024, 256>>>(in.costs, B * R, 13, -1.0, 0.5);
    fill64<<<1024, 256>>>(in.b, B * M, 14, 0.1, 1.0);
    fill64<<<64, 256>>>(in.z, B, 15, -1.0, 1.0);
    fill64<<<1024, 256>>>(in.cf, B * M, 16, -1.0, 1.0);
    if (s.devex) fill<<<1024, 256>>>(in.w, B * R, 17, 1.0f, 2.0f);
    fill_base<<<1024, 256>>>(in.base, s.B, s.M, s.R);
    // Lane 0 and the others RUNNING with room for L pivots; lane 1 frozen
    // (OPTIMAL, inactive); lane 2 with its fuse 5 pivots away.
    std::vector<int> sci(B * 8, 0);
    for (size_t i = 0; i < B; ++i) {
        sci[i * 8 + 0] = RUNNING;
        sci[i * 8 + 4] = 1;
        sci[i * 8 + 5] = 1000000;
    }
    sci[1 * 8 + 0] = OPTIMAL;
    sci[1 * 8 + 4] = 0;
    sci[2 * 8 + 5] = 5;
    cudaMemcpy(in.sci, sci.data(), B * 8 * 4, cudaMemcpyHostToDevice);

    reset(s, in, ref, 0);
    launch_old(s, Tt, c0, ref, 0);
    cudaDeviceSynchronize();
    int nl[3];
    cudaMemcpy(nl, ref.nlive, 12, cudaMemcpyDeviceToHost);
    printf("K7 %s B=%d M=%d R=%d L=%d %s: old kernel nlive of lanes 0-2 = "
           "%d %d %d (%s)\n", s.name, s.B, s.M, s.R, s.L,
           s.devex ? "devex" : "dantzig", nl[0], nl[1], nl[2],
           cudaGetErrorString(cudaGetLastError()));
    if (nl[0] != s.L || nl[1] != 0 || nl[2] != 5) return 1;

    std::vector<Plan> plans{shipped};
    static char names[96][32];
    int nn = 0;
    for (int cs : {1, 2, 4, 8, 16}) {
        const int rf = fit_f(s, cs);
        if (rf < 0) continue;
        const int rc = fit_c(s, cs, rf);
        for (int nt : {512, 256, 128}) {
            snprintf(names[nn], 32, "cs%d res t%d", cs, nt);
            plans.push_back({names[nn++], cs, nt, 1, rc, rf});
            snprintf(names[nn], 32, "cs%d half t%d", cs, nt);
            plans.push_back({names[nn++], cs, nt, 1, rc / 2, rf});
            snprintf(names[nn], 32, "cs%d L2 t%d", cs, nt);
            plans.push_back({names[nn++], cs, nt, 1, 0, rf});
        }
    }
    plans.push_back({"cs4 global", 4, 512, 0, 0, 0});
    std::vector<int> active(plans.size(), 0);
    for (auto &p : plans) {
        const long long smem = window_smem_bytes(s.M, s.R, p.cs, s.devex,
                                                 p.vec, p.res_c, p.res_f);
        int clusters = -1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((unsigned)s.B * p.cs);
        cfg.blockDim = dim3(p.threads);
        cfg.dynamicSmemBytes = smem;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = p.cs;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        reset(s, in, x, 0);
        const int err = launch_new(s, p, Tt, c0, x, 0);
        cudaDeviceSynchronize();
        const cudaError_t late = cudaGetLastError();
        if (s.devex)
            cudaOccupancyMaxActiveClusters(
                &clusters, p.threads == 512   ? batch_window<true, 512>
                           : p.threads == 256 ? batch_window<true, 256>
                                              : batch_window<true, 128>,
                &cfg);
        else
            cudaOccupancyMaxActiveClusters(
                &clusters, p.threads == 512   ? batch_window<false, 512>
                           : p.threads == 256 ? batch_window<false, 256>
                                              : batch_window<false, 128>,
                &cfg);
        cudaGetLastError();
        printf("K7 %s plan %-14s cs=%d threads=%d vec=%d res_c=%d res_f=%d "
               "smem=%lld: launch %d (%s), %d clusters at once\n", s.name,
               p.name, p.cs, p.threads, p.vec, p.res_c, p.res_f, smem, err,
               cudaGetErrorString(late), clusters);
        active[&p - &plans[0]] = clusters;
        if (err != 0 || late != cudaSuccess) {
            if (&p == &plans[0]) return 1;
            p.cs = 0;                            // not timed
            continue;
        }
        if (compare(s, x, ref, p.name) != 0) return 1;
    }

    // ms a call by CUDA events around each launch (the resets outside),
    // 5 calls a variant, three rounds in turns.
    cudaEvent_t a, e;
    cudaEventCreate(&a);
    cudaEventCreate(&e);
    for (int round = 0; round < 3; ++round) {
        for (int v = -1; v < (int)plans.size(); ++v) {
            if (v >= 0 && plans[v].cs == 0) continue;
            float sum = 0.0f;
            for (int rep = 0; rep < 5; ++rep) {
                reset(s, in, x, 0);
                cudaEventRecord(a);
                if (v < 0)
                    launch_old(s, Tt, c0, x, 0);
                else
                    launch_new(s, plans[v], Tt, c0, x, 0);
                cudaEventRecord(e);
                cudaEventSynchronize(e);
                float ms = 0.0f;
                cudaEventElapsedTime(&ms, a, e);
                sum += ms;
            }
            // The lanes run in waves of the clusters the card holds at
            // once; per pivot: the window over waves x L.
            const int waves =
                v < 0 ? 1 : (s.B + active[v] - 1) / std::max(active[v], 1);
            printf("K7 %s round %d %-14s %.4f ms (%d waves, %.2f us a "
                   "pivot)\n", s.name, round,
                   v < 0 ? "old" : plans[v].name, sum / 5, waves,
                   1e3 * sum / 5 / (waves * s.L));
        }
    }
    free_window(in);
    free_window(ref);
    free_window(x);
    cudaFree(Tt);
    cudaFree(c0);
    return cudaGetLastError() == cudaSuccess ? 0 : 1;
}

// Probes of a pivot's fixed costs, per cluster size: MODE 0 one cluster
// barrier, 1 one cluster fold of a candidate (cluster_fold), 2 one
// __syncthreads, 3 one load from another block's shared memory (a chain
// of dependent loads).
template <int MODE>
__global__ void __launch_bounds__(256) probe(int n, double *out) {
    __shared__ WinHeader hd;
    cg::cluster_group cl = cg::this_cluster();
    const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    Cand c = no_cand();
    c.key = (double)((threadIdx.x * 7 + blockIdx.x) % 97);
    c.idx = threadIdx.x + blockIdx.x * 256;
    float x = 0.0f;
    if (threadIdx.x < LMAX) hd.stage[threadIdx.x] = (float)threadIdx.x;
    cl.sync();
    const float *next = cl.map_shared_rank(hd.stage, (rank + 1) % cs);
    for (int i = 0; i < n; ++i) {
        if (MODE == 0)
            cl.sync();
        else if (MODE == 1)
            c = cluster_fold<256>(c, hd, (i & 1) ? &hd.rslot : &hd.cslot,
                                  cl, cs);                    // two kinds
        else if (MODE == 2)
            __syncthreads();
        else
            x = next[((int)x + i) & (LMAX - 1)];
    }
    if (threadIdx.x == 0) out[blockIdx.x] = c.key + x;
    cl.sync();
}

int probes() {
    double *out;
    cudaMalloc(&out, 1024 * 8);
    const char *names[] = {"cluster.sync", "cluster fold", "__syncthreads",
                           "DSMEM load"};
    cudaEvent_t a, e;
    cudaEventCreate(&a);
    cudaEventCreate(&e);
    for (int mode = 0; mode < 4; ++mode)
        for (int cs : {1, 2, 4, 8, 16}) {
            cudaLaunchConfig_t cfg = {};
            cfg.gridDim = dim3(128);
            cfg.blockDim = dim3(256);
            cudaLaunchAttribute attr[1];
            attr[0].id = cudaLaunchAttributeClusterDimension;
            attr[0].val.clusterDim.x = cs;
            attr[0].val.clusterDim.y = 1;
            attr[0].val.clusterDim.z = 1;
            cfg.attrs = attr;
            cfg.numAttrs = 1;
            auto kern = mode == 0   ? probe<0>
                        : mode == 1 ? probe<1>
                        : mode == 2 ? probe<2>
                                    : probe<3>;
            cudaFuncSetAttribute(
                kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            const int n = 2000;
            cudaLaunchKernelEx(&cfg, kern, n, out);      // warm-up
            cudaEventRecord(a);
            cudaLaunchKernelEx(&cfg, kern, n, out);
            cudaEventRecord(e);
            cudaEventSynchronize(e);
            float ms = 0.0f;
            cudaEventElapsedTime(&ms, a, e);
            printf("probe %-14s cs=%2d: %.3f us each (%s)\n", names[mode], cs,
                   1e3 * ms / n, cudaGetErrorString(cudaGetLastError()));
        }
    cudaFree(out);
    return 0;
}

}  // namespace

int main() {
    cudaMalloc(&CNT, 8);
    probes();
    // The shapes, and the plan kernels/batched.py window_plan gives each
    // on a card of 132 SMs (tests/test_torch_window_plan.py holds the two
    // to each other).
    const Shape shapes[] = {
        {"config-3 devex", 256, 512, 3072, 32, true},
        {"config-3 dantzig", 256, 512, 3072, 32, false},
        {"wide devex", 32, 512, 15104, 32, true},
        {"wide dantzig", 32, 512, 15104, 32, false},
        {"L128 devex", 64, 512, 3072, 128, true}};
    const Plan shipped[] = {
        {"shipped", 1, 512, 1, 8, 32},
        {"shipped", 1, 512, 1, 9, 32},
        {"shipped", 4, 512, 1, 10, 32},
        {"shipped", 4, 512, 1, 11, 32},
        {"shipped", 2, 512, 1, 11, 128}};
    for (int i = 0; i < 5; ++i)
        if (bench(shapes[i], shipped[i]) != 0) return 1;
    return 0;
}
