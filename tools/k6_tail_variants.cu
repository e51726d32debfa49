// The K6 loop's pivot (solver.solve_loop_pallas: csrc/seq.cu
// seq_ratio_snapshot, then csrc/pivot.cu K6 with its fold and the step
// after it) on the card, several ways, every output checked bit for bit
// against the kernels it replaced:
//
//   old     the four nodes the loop launched before: the ratio test alone
//           (the shipped seq_ratio cluster), verbatim copies of the
//           snapshot grid (seq_snapshot_kernel: one column, then one row,
//           a thread) and of K6's fold with the step after in thread 0
//           (fused_pivot_finish<true>: an 8-level shared-memory tree),
//           between them K6's tiles;
//   b-warp  three nodes: seq_ratio_snapshot, K6's tiles without a tail,
//           then a one-warp finish -- the partials folded by shuffles in
//           the same order, no barrier -- and the step;
//   a-grid  two nodes: seq_ratio_snapshot, then K6's tiles whose every
//           block takes an arrival ticket once it is done, the last one
//           folding the partials in one warp and running the step;
//   a-late  the same with the first row band's blocks alone taking the
//           ticket, after their rows (only they read minc, the one scalar
//           the step rewrites that a tile block reads);
//   a-band  two nodes, the shipped form: seq_ratio_snapshot, then
//           fused_pivot_tiles<true>, whose first row band's blocks update
//           their costs, fold their partials and take the ticket before
//           their rows, so the fold and the step run while the rows
//           stream;
//   a-band-r8 a-band with seq_ratio_snapshot copying the row eight 16-byte
//           vectors a thread at a time (the shipped: four).
//
// Build and run on a machine with an H100:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/k6_tail_variants tools/k6_tail_variants.cu && \
//        /tmp/k6_tail_variants
//
// Checks: every scalar of the step, the tableau (on the card), the costs,
// b, base, the gathered column and the row equal to old's, byte for byte,
// after one pivot from each edge state -- a taken pivot, a skipped one
// (optimal), the column unbounded, do false by the fuse, k = 0, k = M - 1,
// h the last column (every column live), a NaN in b on an eligible row,
// equal smallest quotients on two rows far apart, no Bland candidate after
// the pivot, Bland static, Bland by its threshold -- with the next step
// before on every other state; the tail's counter back at zero. Shapes: M x
// R = 2,048 x 6,144 (K6's 2048^2 loop), 1,024 x 3,072, 10,112 x 120,064
// (the north star's phase 1), 1 x 4, 7 x 20, 4,095 x 12,284, 4,097 x 260,
// 40,064 x 2,048 and 33 x 1,028 (R not a multiple of K6's 1,024 columns,
// M not of its 32 rows). Times, at the first three shapes: us a pivot by
// CUDA events around replays of a CUDA graph of pivots, in turns (each
// form, then back), three rounds; then each kernel alone and K6 with each
// finish the same way. The timed state is a taken degenerate pivot (b[k] =
// 0) without the next step before, so each call does the same work.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <random>
#include <string>
#include <vector>

#include "../simplex_tpu_torch/kernels/csrc/seq.cu"
#include "../simplex_tpu_torch/kernels/csrc/pivot.cu"

#define CK(x)                                                            \
    do {                                                                 \
        cudaError_t e_ = (cudaError_t)(x);                               \
        if (e_ != cudaSuccess) {                                         \
            std::printf("CUDA error %s at %s:%d\n", cudaGetErrorString(e_), \
                        __FILE__, __LINE__);                             \
            std::exit(1);                                                \
        }                                                                \
    } while (0)

using F32Step = SeqStep<float, float>;

// ---------------------------------------------------------------------------
// The kernels the loop launched before, verbatim (their launch shapes too).

namespace old_form {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) seq_snapshot_kernel(
        const float *__restrict__ Tt, float *__restrict__ b,
        int *__restrict__ base, const float *__restrict__ ah,
        float *__restrict__ colk, int M, int R, int n_rblocks, F32Step s) {
    const int tid = threadIdx.x;
    const bool d = *s.do_ != 0;
    const int k = *s.k;
    if ((int)blockIdx.x >= n_rblocks) {
        const int j = (blockIdx.x - n_rblocks) * THREADS + tid;
        if (!d || j >= M) return;
        const float p = *s.p;
        const float bk = *s.bk;
        if (j == k) {
            b[j] = div_rn(bk, p);
            base[j] = *s.h;
        } else {
            b[j] = sub_rn(b[j], mul_rn(bk, div_rn(ah[j], p)));
        }
        return;
    }
    const int i = blockIdx.x * THREADS + tid;
    if (i < R) colk[i] = Tt[(size_t)k * R + i];
}

__global__ void __launch_bounds__(PT) fused_pivot_finish_tail(
        const float *__restrict__ part_val, const int *__restrict__ part_idx,
        const float *__restrict__ part_bval, const int *__restrict__ part_bidx,
        int nparts, F32Step s, seq::Policy pol) {
    seq::PostIn<float> in{};
    bool d = false;
    seq::Candidates<float> old{};
    if (threadIdx.x == 0) {
        in = seq::post_load(s);
        d = *s.do_ != 0;
        old = {*s.h_d, *s.v_d, *s.h_b, *s.v_b};
    }
    float val = CUDART_INF_F, bval = CUDART_INF_F;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    for (int i = threadIdx.x; i < nparts; i += PT) {
        if (less(part_val[i], part_idx[i], val, idx)) {
            val = part_val[i];
            idx = part_idx[i];
        }
        if (part_bidx[i] < bidx) {
            bidx = part_bidx[i];
            bval = part_bval[i];
        }
    }
    block_fold(val, idx, bval, bidx);
    if (threadIdx.x != 0) return;
    const seq::Candidates<float> c{idx, val, bidx,
                                   bidx == BIG_INDEX ? CUDART_INF_F : bval};
    const seq::Candidates<float> n = d ? c : old;
    *s.h_d = n.h_d;
    *s.v_d = n.v_d;
    *s.h_b = n.h_b;
    *s.v_b = n.v_b;
    seq::post(s, in, d, n, pol);
}

}  // namespace old_form

// ---------------------------------------------------------------------------
// The forms tried and not shipped.

namespace tried {

// b-warp: one warp folds the partials by shuffles (the shipped tail's
// fold), its operands loaded before the fold, then the step.
__global__ void __launch_bounds__(32) warp_finish(
        const float *__restrict__ part_val, const int *__restrict__ part_idx,
        const float *__restrict__ part_bval, const int *__restrict__ part_bidx,
        int nparts, F32Step s, seq::Policy pol) {
    const int lane = threadIdx.x;
    seq::PostIn<float> in{};
    bool d = false;
    seq::Candidates<float> old{};
    if (lane == 0) {
        in = seq::post_load(s);
        d = *s.do_ != 0;
        old = {*s.h_d, *s.v_d, *s.h_b, *s.v_b};
    }
    float val = CUDART_INF_F, bval = CUDART_INF_F;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    for (int i = lane; i < nparts; i += 32) {
        const float v = part_val[i], bv = part_bval[i];
        const int ix = part_idx[i], bi = part_bidx[i];
        if (less(v, ix, val, idx)) {
            val = v;
            idx = ix;
        }
        if (bi < bidx) {
            bidx = bi;
            bval = bv;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_xor_sync(FULL, val, off);
        const float bv = __shfl_xor_sync(FULL, bval, off);
        const int ix = __shfl_xor_sync(FULL, idx, off);
        const int bi = __shfl_xor_sync(FULL, bidx, off);
        if (less(v, ix, val, idx)) {
            val = v;
            idx = ix;
        }
        if (bi < bidx) {
            bidx = bi;
            bval = bv;
        }
    }
    if (lane != 0) return;
    const seq::Candidates<float> n =
            d ? seq::Candidates<float>{idx, val, bidx,
                                       bidx == BIG_INDEX ? CUDART_INF_F
                                                         : bval}
              : old;
    *s.h_d = n.h_d;
    *s.v_d = n.v_d;
    *s.h_b = n.h_b;
    *s.v_b = n.v_b;
    seq::post(s, in, d, n, pol);
}

// The tail after the rows: the first row band's blocks do their costs
// and partial after their rows, as the standalone K6 does, then take the
// ticket -- with GRID every block of the grid takes it once it is done
// (a-grid), else the band's alone (a-late); the last folds and runs the
// step.
template <bool GRID>
__global__ void __launch_bounds__(PT) tiles_late_ticket(
        float *__restrict__ Tt, float *__restrict__ costs,
        const float *__restrict__ colk, const float *__restrict__ ah,
        const float *__restrict__ p_ptr, const float *minc_ptr,
        const int *__restrict__ k_ptr, const unsigned char *__restrict__ do_ptr,
        int M, int R, int r, float eps, float *__restrict__ part_val,
        int *__restrict__ part_idx, float *__restrict__ part_bval,
        int *__restrict__ part_bidx, unsigned *__restrict__ counter,
        F32Step s, seq::Policy pol) {
    __shared__ bool last;
    const bool apply = *do_ptr != 0;
    const float p = *p_ptr;
    const float inv_p = apply ? __fdiv_rn(1.0f, p) : 1.0f;
    const int k = *k_ptr;
    const int c0 = (blockIdx.x * PT + threadIdx.x) * VEC;
    const bool in = c0 < R;
    const float4 ck = in ? *reinterpret_cast<const float4 *>(colk + c0)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (apply && in) {
        const int j0 = blockIdx.y * ROWS;
        const int j1 = min(j0 + ROWS, M);
        for (int j = j0; j < j1; j += INFLIGHT) {
            float4 t[INFLIGHT];
#pragma unroll
            for (int u = 0; u < INFLIGHT; ++u)
                if (j + u < j1)
                    t[u] = *reinterpret_cast<const float4 *>(
                        Tt + (size_t)(j + u) * R + c0);
#pragma unroll
            for (int u = 0; u < INFLIGHT; ++u) {
                const int row = j + u;
                if (row >= j1) break;
                const float4 out =
                    row == k ? make_float4(__fmul_rn(ck.x, inv_p),
                                           __fmul_rn(ck.y, inv_p),
                                           __fmul_rn(ck.z, inv_p),
                                           __fmul_rn(ck.w, inv_p))
                             : update4(t[u], ck, __fmul_rn(ah[row], inv_p));
                *reinterpret_cast<float4 *>(Tt + (size_t)row * R + c0) = out;
            }
        }
    }
    const unsigned tickets = GRID ? gridDim.x * gridDim.y : gridDim.x;
    if (blockIdx.y != 0) {
        if (!GRID) return;
        __syncthreads();
        if (threadIdx.x == 0) last = ticket(counter) == tickets - 1;
        __syncthreads();
        if (!last) return;
    } else {
        float val = CUDART_INF_F, bval = CUDART_INF_F;
        int idx = BIG_INDEX, bidx = BIG_INDEX;
        if (in) {
            const float mop = apply ? __fdiv_rn(*minc_ptr, p) : 0.0f;
            float4 *cp = reinterpret_cast<float4 *>(costs + c0);
            const float4 cv = *cp;
            float c[VEC] = {cv.x, cv.y, cv.z, cv.w};
            const float kv[VEC] = {ck.x, ck.y, ck.z, ck.w};
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                if (apply) c[q] = __fsub_rn(c[q], __fmul_rn(mop, kv[q]));
                const int i = c0 + q;
                const float cm = i < r ? c[q] : CUDART_INF_F;
                if (less(cm, i, val, idx)) {
                    val = cm;
                    idx = i;
                }
                if (cm <= -eps && i < bidx) {
                    bidx = i;
                    bval = cm;
                }
            }
            if (apply) *cp = make_float4(c[0], c[1], c[2], c[3]);
        }
        block_fold(val, idx, bval, bidx);
        if (threadIdx.x == 0) {
            part_val[blockIdx.x] = val;
            part_idx[blockIdx.x] = idx;
            part_bval[blockIdx.x] = bval;
            part_bidx[blockIdx.x] = bidx;
            last = ticket(counter) == tickets - 1;
        }
        __syncthreads();
        if (!last) return;
    }
    // The last block: fold the band's partials in warp 0.
    const int lane = threadIdx.x, nx = (int)gridDim.x;
    if (lane >= 32) return;
    seq::PostIn<float> pin{};
    seq::Candidates<float> old{};
    if (lane == 0) {
        pin = seq::post_load(s);
        old = {*s.h_d, *s.v_d, *s.h_b, *s.v_b};
    }
    float val = CUDART_INF_F, bval = CUDART_INF_F;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    for (int i = lane; i < nx; i += 32) {
        const float v = __ldcg(part_val + i), bv = __ldcg(part_bval + i);
        const int ix = __ldcg(part_idx + i), bi = __ldcg(part_bidx + i);
        if (less(v, ix, val, idx)) {
            val = v;
            idx = ix;
        }
        if (bi < bidx) {
            bidx = bi;
            bval = bv;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_xor_sync(FULL, val, off);
        const float bv = __shfl_xor_sync(FULL, bval, off);
        const int ix = __shfl_xor_sync(FULL, idx, off);
        const int bi = __shfl_xor_sync(FULL, bidx, off);
        if (less(v, ix, val, idx)) {
            val = v;
            idx = ix;
        }
        if (bi < bidx) {
            bidx = bi;
            bval = bv;
        }
    }
    if (lane != 0) return;
    *counter = 0;
    const seq::Candidates<float> n =
            apply ? seq::Candidates<float>{idx, val, bidx,
                                           bidx == BIG_INDEX ? CUDART_INF_F
                                                             : bval}
                  : old;
    *s.h_d = n.h_d;
    *s.v_d = n.v_d;
    *s.h_b = n.h_b;
    *s.v_b = n.v_b;
    seq::post(s, pin, apply, n, pol);
}

}  // namespace tried

// ---------------------------------------------------------------------------
// The harness.

// SeqStep's slots (8 bytes each, in its order).
enum Slot {
    S_STATUS, S_ITER, S_STALL, S_BLAND, S_Z, S_HD, S_VD, S_HB, S_VB,
    S_ACTIVE, S_H, S_MINC, S_OPTIMAL, S_K, S_BK, S_UNB, S_DO, S_P, S_U
};
constexpr int SLOTS = 19;

template <typename X>
void put(unsigned char *scal, int slot, X v) {
    std::memset(scal + 8 * slot, 0, 8);
    std::memcpy(scal + 8 * slot, &v, sizeof v);
}

template <typename X>
X get(const unsigned char *scal, int slot) {
    X v;
    std::memcpy(&v, scal + 8 * slot, sizeof v);
    return v;
}

// Uniform in [-1, 1) from a hash of (seed, i).
__global__ void fill_uniform(float *x, size_t n, unsigned long long seed) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        unsigned long long w = seed + 0x9e3779b97f4a7c15ull * (i + 1);
        w = (w ^ (w >> 30)) * 0xbf58476d1ce4e5b9ull;
        w = (w ^ (w >> 27)) * 0x94d049bb133111ebull;
        w ^= w >> 31;
        x[i] = (float)((double)(w >> 11) * 0x1.0p-52 - 1.0);
    }
}

// Elements that differ between a and b, as bits.
__global__ void count_diff(const unsigned *a, const unsigned *b, size_t n,
                           unsigned long long *out) {
    unsigned long long c = 0;
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x)
        c += a[i] != b[i];
    if (c) atomicAdd(out, c);
}

// A state's host side: the vectors, the scalars and the policy; the
// tableau lives on the card (Tt0, bent by the edge's column).
struct Host {
    int M, R, r;
    std::vector<float> costs, b;
    std::vector<int> base;
    unsigned char scal[SLOTS * 8];
    seq::Policy pol;
    double eps;
};

struct Bufs {
    float *Tt, *Tt0, *TtRef, *costs, *b, *ah, *colk;
    int *base;
    int *ws;                                     // 4 rows of nx, the counter
    unsigned char *scal;
    unsigned long long *diff;
    int M, R, r, nx;
    double eps;
    seq::Policy pol;
    F32Step step() const {
        F32Step s;
        void **f = reinterpret_cast<void **>(&s);
        for (int i = 0; i < SLOTS; ++i) f[i] = scal + 8 * i;
        return s;
    }
    float *pv() const { return reinterpret_cast<float *>(ws); }
    int *pi() const { return ws + nx; }
    float *pbv() const { return reinterpret_cast<float *>(ws + 2 * nx); }
    int *pbi() const { return ws + 3 * nx; }
    unsigned *counter() const {
        return reinterpret_cast<unsigned *>(ws + 4 * nx);
    }
};

const char *EDGES[] = {"taken",    "optimal",  "unbounded",  "fuse",
                       "k-first",  "k-last",   "h-last-col", "nan-b",
                       "tie-rows", "no-bland", "bland-static",
                       "bland-threshold"};
constexpr int N_EDGES = 12;

// The state ``edge`` over the card's Tt0 (its column h read and written
// back); timed: a taken degenerate pivot without the next step before.
Host make_state(Bufs &x, int edge, bool timed, unsigned seed) {
    const int M = x.M, R = x.R;
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> u(-1.0, 1.0), ub(1.0, 100.0);
    Host h;
    h.M = M;
    h.R = R;
    h.r = edge == 6 ? R : std::max(1, R - std::min(100, R / 4));
    h.eps = 1e-4;
    h.costs.resize(R);
    for (auto &v : h.costs) v = (float)u(rng);
    h.b.resize(M);
    for (auto &v : h.b) v = (float)ub(rng);
    h.base.resize(M);
    for (auto &v : h.base) v = (int)(rng() % R);
    const int col = edge == 6 ? R - 1 : (int)(rng() % h.r);
    std::vector<float> a(M);
    CK(cudaMemcpy2D(a.data(), sizeof(float), x.Tt0 + col, R * sizeof(float),
                    sizeof(float), M, cudaMemcpyDeviceToHost));
    const float eps = (float)h.eps;
    std::vector<int> rows;
    for (int j = 0; j < M; ++j)
        if (a[j] >= eps) rows.push_back(j);
    if (rows.empty() && edge != 2) {
        a[M / 2] = 0.5f;
        rows.push_back(M / 2);
    }
    int mode = step::BLAND_THRESHOLD, stall = 0, iters = 3;
    bool active = true, bland = false;
    float minc = -0.75f;
    switch (edge) {
    case 1: minc = 0.25f; break;
    case 2:
        for (auto &v : a) v = -std::fabs(v);
        break;
    case 3:
        active = false;
        iters = 1 << 20;
        break;
    case 4:
    case 5: {
        const int j = edge == 4 ? 0 : M - 1;
        a[j] = 0.5f;
        h.b[j] = 0.0f;
        break;
    }
    case 7: h.b[rows[rows.size() / 2]] = NAN; break;
    case 8:
        if (rows.size() > 1) {
            const int j1 = rows.front(), j2 = rows.back();
            a[j2] = a[j1];
            h.b[j1] = h.b[j2] = 1e-3f * a[j1];
        }
        break;
    case 9:
        for (auto &v : h.costs) v = std::fabs(v) + 3.0f;
        minc = -2.0f * eps;
        break;
    case 10: mode = step::BLAND_STATIC; break;
    case 11:
        h.b[rows[0]] = 0.0f;
        stall = 49;
        break;
    }
    if (timed) h.b[rows[rows.size() / 2]] = 0.0f;
    h.costs[col] = minc;
    CK(cudaMemcpy2D(x.Tt0 + col, R * sizeof(float), a.data(), sizeof(float),
                    sizeof(float), M, cudaMemcpyHostToDevice));
    h.pol = seq::Policy{1LL << 40, h.eps, mode, 50,
                        timed ? 0 : (int)(edge % 2 == 0)};
    std::memset(h.scal, 0, sizeof h.scal);
    put<int>(h.scal, S_STATUS, step::RUNNING);
    put<int>(h.scal, S_ITER, iters);
    put<int>(h.scal, S_STALL, stall);
    put<unsigned char>(h.scal, S_BLAND, bland);
    put<float>(h.scal, S_Z, 1.5f);
    put<int>(h.scal, S_HD, col);
    put<float>(h.scal, S_VD, minc);
    put<int>(h.scal, S_HB, BIG_INDEX);
    put<float>(h.scal, S_VB, std::numeric_limits<float>::infinity());
    put<unsigned char>(h.scal, S_ACTIVE, active);
    put<int>(h.scal, S_H, col);
    put<float>(h.scal, S_MINC, minc);
    put<unsigned char>(h.scal, S_OPTIMAL, minc > -eps);
    return h;
}

struct Device {
    Bufs x;
    Device(int M, int R, unsigned long long seed) {
        const size_t n = (size_t)M * R;
        x.M = M;
        x.R = R;
        x.nx = (R + COLS - 1) / COLS;
        CK(cudaMalloc(&x.Tt, n * 4));
        CK(cudaMalloc(&x.Tt0, n * 4));
        CK(cudaMalloc(&x.TtRef, n * 4));
        fill_uniform<<<1024, 256>>>(x.Tt0, n, seed);
        CK(cudaGetLastError());
        CK(cudaMalloc(&x.costs, R * 4));
        CK(cudaMalloc(&x.b, M * 4));
        CK(cudaMalloc(&x.ah, M * 4));
        CK(cudaMalloc(&x.colk, R * 4));
        CK(cudaMalloc(&x.base, M * 4));
        CK(cudaMalloc(&x.ws, (4 * x.nx + 1) * 4));
        CK(cudaMalloc(&x.scal, SLOTS * 8));
        CK(cudaMalloc(&x.diff, 8));
    }
    void reset(const Host &h) {
        x.r = h.r;
        x.eps = h.eps;
        x.pol = h.pol;
        CK(cudaMemcpy(x.Tt, x.Tt0, (size_t)x.M * x.R * 4,
                      cudaMemcpyDeviceToDevice));
        CK(cudaMemcpy(x.costs, h.costs.data(), x.R * 4,
                      cudaMemcpyHostToDevice));
        CK(cudaMemcpy(x.b, h.b.data(), x.M * 4, cudaMemcpyHostToDevice));
        CK(cudaMemcpy(x.base, h.base.data(), x.M * 4,
                      cudaMemcpyHostToDevice));
        CK(cudaMemset(x.ah, 0x7f, x.M * 4));
        CK(cudaMemset(x.colk, 0x7f, x.R * 4));
        CK(cudaMemset(x.ws, 0, (4 * x.nx + 1) * 4));
        CK(cudaMemcpy(x.scal, h.scal, SLOTS * 8, cudaMemcpyHostToDevice));
    }
    ~Device() {
        for (void *p : {(void *)x.Tt, (void *)x.Tt0, (void *)x.TtRef,
                        (void *)x.costs, (void *)x.b, (void *)x.ah,
                        (void *)x.colk, (void *)x.base, (void *)x.ws,
                        (void *)x.scal, (void *)x.diff})
            cudaFree(p);
    }
};

// ---------------------------------------------------------------------------
// The launches.

using LaunchFn = int (*)(const Bufs &, cudaStream_t);

dim3 tile_grid(const Bufs &x) { return dim3(x.nx, (x.M + ROWS - 1) / ROWS); }

int ratio_alone(const Bufs &x, cudaStream_t st) {
    const F32Step s = x.step();
    return ratio_run<float, float>(x.Tt, x.b, x.M, x.R, x.eps, x.ah, &s,
                                   st);
}

int ratio_snapshot(const Bufs &x, cudaStream_t st) {
    const F32Step s = x.step();
    return ratio_snapshot_run(x.Tt, x.b, x.base, x.ah, x.colk, x.M, x.R,
                              x.eps, &s, st);
}

// The same cluster with the row going RPER vectors a thread at a time.
template <int RPER>
int ratio_snapshot_r(const Bufs &x, cudaStream_t st) {
    auto kernel = seq_ratio_snapshot_kernel<CLUSTER_BLOCKS, CLUSTER_THREADS,
                                            PER, RPER>;
    static const cudaError_t e = allow_cluster(kernel, CLUSTER_BLOCKS);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(kernel, CLUSTER_BLOCKS, CLUSTER_THREADS, false, st,
                          (const float *)x.Tt, x.b, x.base, x.ah, x.colk, x.M,
                          x.R, x.eps, x.step());
}

int old_snapshot(const Bufs &x, cudaStream_t st) {
    const int nr = (x.R + old_form::THREADS - 1) / old_form::THREADS;
    const int nm = (x.M + old_form::THREADS - 1) / old_form::THREADS;
    old_form::seq_snapshot_kernel<<<nr + nm, old_form::THREADS, 0, st>>>(
        x.Tt, x.b, x.base, x.ah, x.colk, x.M, x.R, nr, x.step());
    return (int)cudaGetLastError();
}

template <bool TAIL>
int tiles(const Bufs &x, cudaStream_t st) {
    const F32Step s = x.step();
    fused_pivot_tiles<TAIL><<<tile_grid(x), PT, 0, st>>>(
        x.Tt, x.costs, x.colk, x.ah, s.p, s.minc, s.k, s.do_, x.M, x.R, x.r,
        (float)x.eps, x.pv(), x.pi(), x.pbv(), x.pbi(), x.counter(), s,
        x.pol);
    return (int)cudaGetLastError();
}

template <bool GRID>
int tiles_late(const Bufs &x, cudaStream_t st) {
    const F32Step s = x.step();
    tried::tiles_late_ticket<GRID><<<tile_grid(x), PT, 0, st>>>(
        x.Tt, x.costs, x.colk, x.ah, s.p, s.minc, s.k, s.do_, x.M, x.R, x.r,
        (float)x.eps, x.pv(), x.pi(), x.pbv(), x.pbi(), x.counter(), s,
        x.pol);
    return (int)cudaGetLastError();
}

int old_finish(const Bufs &x, cudaStream_t st) {
    old_form::fused_pivot_finish_tail<<<1, PT, 0, st>>>(
        x.pv(), x.pi(), x.pbv(), x.pbi(), x.nx, x.step(), x.pol);
    return (int)cudaGetLastError();
}

int warp_finish(const Bufs &x, cudaStream_t st) {
    tried::warp_finish<<<1, 32, 0, st>>>(x.pv(), x.pi(), x.pbv(), x.pbi(),
                                         x.nx, x.step(), x.pol);
    return (int)cudaGetLastError();
}

// A sequence of launches by name.
struct Form {
    std::string name;
    std::vector<LaunchFn> fns;
};

std::vector<Form> pivot_forms() {
    return {{"old", {ratio_alone, old_snapshot, tiles<false>, old_finish}},
            {"b-warp", {ratio_snapshot, tiles<false>, warp_finish}},
            {"a-grid", {ratio_snapshot, tiles_late<true>}},
            {"a-late", {ratio_snapshot, tiles_late<false>}},
            {"a-band", {ratio_snapshot, tiles<true>}},
            {"a-band-r8", {ratio_snapshot_r<8>, tiles<true>}}};
}

int run(const Form &f, const Bufs &x, cudaStream_t st) {
    for (LaunchFn fn : f.fns) {
        const int e = fn(x, st);
        if (e) return e;
    }
    return 0;
}

// The bytes a pivot leaves but the tableau: scalars, costs, b, base, ah,
// colk, the counter.
std::vector<unsigned char> snapshot(const Bufs &x) {
    std::vector<unsigned char> out;
    auto add = [&](const void *p, size_t n) {
        const size_t o = out.size();
        out.resize(o + n);
        CK(cudaMemcpy(out.data() + o, p, n, cudaMemcpyDeviceToHost));
    };
    add(x.scal, SLOTS * 8);
    add(x.costs, x.R * 4);
    add(x.b, x.M * 4);
    add(x.base, x.M * 4);
    add(x.ah, x.M * 4);
    add(x.colk, x.R * 4);
    add(x.counter(), 4);
    return out;
}

unsigned long long tableau_diff(const Bufs &x) {
    CK(cudaMemset(x.diff, 0, 8));
    count_diff<<<1024, 256>>>(reinterpret_cast<const unsigned *>(x.Tt),
                              reinterpret_cast<const unsigned *>(x.TtRef),
                              (size_t)x.M * x.R, x.diff);
    CK(cudaGetLastError());
    unsigned long long d = 0;
    CK(cudaMemcpy(&d, x.diff, 8, cudaMemcpyDeviceToHost));
    return d;
}

int failures = 0;

void check(int M, int R) {
    const auto fs = pivot_forms();
    Device d(M, R, 1000003ull * M + R);
    for (int edge = 0; edge < N_EDGES; ++edge) {
        const Host h = make_state(d.x, edge, false, 31 * edge + M + R);
        d.reset(h);
        CK(run(fs[0], d.x, 0));
        CK(cudaDeviceSynchronize());
        const auto want = snapshot(d.x);
        CK(cudaMemcpy(d.x.TtRef, d.x.Tt, (size_t)M * R * 4,
                      cudaMemcpyDeviceToDevice));
        std::string bad;
        for (size_t v = 1; v < fs.size(); ++v) {
            d.reset(h);
            const int e = run(fs[v], d.x, 0);
            if (e != 0) {
                bad += " " + fs[v].name + "(launch " +
                       cudaGetErrorString((cudaError_t)e) + ")";
                cudaGetLastError();
                continue;
            }
            CK(cudaDeviceSynchronize());
            if (snapshot(d.x) != want || tableau_diff(d.x) != 0)
                bad += " " + fs[v].name;
        }
        const unsigned char *sc = want.data();
        std::printf("check M=%d R=%d %-15s k=%d do=%d status=%d h_b=%d "
                    "then_pre=%d: %s\n", M, R, EDGES[edge],
                    get<int>(sc, S_K), (int)get<unsigned char>(sc, S_DO),
                    get<int>(sc, S_STATUS), get<int>(sc, S_HB),
                    h.pol.then_pre,
                    bad.empty() ? "every form bit for bit" : "DIFFER");
        if (!bad.empty()) {
            std::printf("  differ:%s\n", bad.c_str());
            ++failures;
        }
    }
}

float replay_us(cudaGraphExec_t g, cudaStream_t st, int calls, int reps) {
    cudaEvent_t e0, e1;
    CK(cudaEventCreate(&e0));
    CK(cudaEventCreate(&e1));
    CK(cudaEventRecord(e0, st));
    for (int i = 0; i < reps; ++i) CK(cudaGraphLaunch(g, st));
    CK(cudaEventRecord(e1, st));
    CK(cudaEventSynchronize(e1));
    float ms = 0;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    CK(cudaEventDestroy(e0));
    CK(cudaEventDestroy(e1));
    return 1e3f * ms / (reps * calls);
}

// ``f`` ``calls`` times as a CUDA graph on st.
cudaGraphExec_t capture(cudaStream_t st, const Form &f, const Bufs &x,
                        int calls) {
    cudaGraph_t g;
    cudaGraphExec_t exec;
    CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal));
    for (int i = 0; i < calls; ++i) CK(run(f, x, st));
    CK(cudaStreamEndCapture(st, &g));
    CK(cudaGraphInstantiate(&exec, g, 0));
    CK(cudaGraphDestroy(g));
    return exec;
}

// Each form in turns (each, then back), three rounds: min, median, max.
void turns(const char *what, const std::vector<Form> &fs, const Bufs &x,
           cudaStream_t st, int calls, int reps) {
    const int n = (int)fs.size();
    std::vector<cudaGraphExec_t> gs;
    for (const auto &f : fs) gs.push_back(capture(st, f, x, calls));
    std::vector<std::vector<float>> t(n);
    for (int v = 0; v < n; ++v) CK(cudaGraphLaunch(gs[v], st));   // warm
    for (int round = 0; round < 3; ++round)
        for (int i = 0; i < 2 * n; ++i) {
            const int v = i < n ? i : 2 * n - 1 - i;
            t[v].push_back(replay_us(gs[v], st, calls, reps));
        }
    for (int v = 0; v < n; ++v) {
        auto s = t[v];
        std::sort(s.begin(), s.end());
        std::printf("time %s %-16s min %.3f median %.3f max %.3f us (", what,
                    fs[v].name.c_str(), s.front(), s[s.size() / 2],
                    s.back());
        for (size_t i = 0; i < t[v].size(); ++i)
            std::printf("%s%.3f", i ? " " : "", t[v][i]);
        std::printf(")\n");
        CK(cudaGraphExecDestroy(gs[v]));
    }
}

void timing(int M, int R, int calls, int reps) {
    Device d(M, R, 7ull + M);
    const Host h = make_state(d.x, 0, true, 7 + M);
    d.reset(h);
    CK(cudaDeviceSynchronize());
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    // A pivot first: each timed call is then the same taken pivot on a
    // column already pivoted into row k.
    CK(run(pivot_forms()[0], d.x, st));
    CK(cudaStreamSynchronize(st));
    const auto s0 = snapshot(d.x);
    std::printf("timed state M=%d R=%d: k=%d do=%d p=%.9g\n", M, R,
                get<int>(s0.data(), S_K),
                (int)get<unsigned char>(s0.data(), S_DO),
                get<float>(s0.data(), S_P));
    char what[64];
    std::snprintf(what, sizeof what, "M=%d R=%d pivot", M, R);
    turns(what, pivot_forms(), d.x, st, calls, reps);
    std::snprintf(what, sizeof what, "M=%d R=%d kernel", M, R);
    turns(what,
          {{"seq_ratio", {ratio_alone}},
           {"old-snapshot", {old_snapshot}},
           {"ratio_snapshot", {ratio_snapshot}},
           {"ratio_snapshot-r8", {ratio_snapshot_r<8>}},
           {"ratio+old-snap", {ratio_alone, old_snapshot}}},
          d.x, st, 50, 20);
    std::snprintf(what, sizeof what, "M=%d R=%d K6", M, R);
    turns(what,
          {{"tiles", {tiles<false>}},
           {"tiles+old-fold", {tiles<false>, old_finish}},
           {"tiles+warp-fold", {tiles<false>, warp_finish}},
           {"tiles-grid-tail", {tiles_late<true>}},
           {"tiles-late-tail", {tiles_late<false>}},
           {"tiles-band-tail", {tiles<true>}}},
          d.x, st, calls, reps);
    CK(cudaStreamDestroy(st));
}

int main() {
    cudaDeviceProp prop;
    CK(cudaGetDeviceProperties(&prop, 0));
    std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
    const int shapes[][2] = {{2048, 6144}, {1024, 3072}, {10112, 120064},
                             {1, 4},       {7, 20},      {4095, 12284},
                             {4097, 260},  {40064, 2048}, {33, 1028}};
    for (const auto &s : shapes) check(s[0], s[1]);
    std::printf("bit for bit: %s (%d state(s) differ)\n",
                failures ? "FAILED" : "every form, every state", failures);
    timing(2048, 6144, 50, 20);
    timing(1024, 3072, 50, 20);
    timing(10112, 120064, 5, 4);
    return failures ? 1 : 0;
}
