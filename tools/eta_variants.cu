// The plain blocked loop's per-pivot kernels (csrc/eta.cu) on the card,
// several ways, every output checked byte for byte against the forms they
// replaced:
//
//   prior     verbatim copies of the two kernels the port launched before:
//             one thread a row (64 a block) or a column (128 a block), each
//             thread loading its t slab elements from global memory after
//             h or k was read, a ticket, the last block's fold;
//   shipped   the shipped kernels (included from the source) on the plan
//             kernels/eta.py eta_plan chooses (its rule copied below): each
//             block's slab rows sent for as cp.async copies into shared
//             memory before h or k is read, then the sums from shared
//             memory; as a pivot, both programmatic dependent launches;
//   general   the same with every slab row copied by the general path (a
//             16-byte copy a whole chunk found by division, the head and
//             tail element by element), as unaligned rows are;
//   old       the first redesign's grid, as many slab rows a round as fit;
//   rRxN      the shipped eta_ratio with R rows a block of N threads;
//   rsS       the shipped eta_ratio with S slab rows a round;
//   cCxN      the shipped eta_colk with C columns a block of N threads;
//   cCsS      the same with C columns and S slab rows a round;
//   plain, pdl-colk, pdl-both   the first redesign's pivot with neither,
//             eta_colk, or both kernels launched as programmatic dependent
//             launches (the other pivot forms: both).
//
// Build and run on a machine with an H100 (~3 min):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/eta_variants tools/eta_variants.cu && /tmp/eta_variants
//
// Checks, in f64/f64, f32/f64 and f32/f32, under devex: every scalar of
// the step, a_h, C[t], F[t], the costs, the weights, b, base and the
// workspace's counters equal to prior's, byte for byte, after one eta_ratio
// and one eta_colk from each edge state -- a taken pivot, a NaN in b, no
// eligible row (eps past every a_h), Bland on, the fuse (a skipped pivot),
// a weight past the re-anchor's bound, Bland static with the next step
// before -- at t = 0, 1, L / 2 and L - 1, L = 128, 13 and 300 (the slab in
// three rounds), M x R = 2,048 x 6,144, 1 x 3, 37 x 6,143, 2,047 x 6,143,
// 2,047 x 3 and 4,097 x 257 (rows of F and C unaligned: f64 rows on 8
// bytes, f32 rows on 4), for every form. Times, at M x R = 2,048 x 6,144
// and 8,192 x 24,576 (the 2048^2 and 8192^2 phase-1 tableaus) for the
// three pairs and at the north star's 10,112 x 120,064 in f64, L = 128,
// t = 0, 64 and 127: us a call of each kernel alone, and us a pivot
// (eta_ratio then eta_colk), by CUDA events around 20 replays of a CUDA
// graph of 50 calls or pivots, each form in turns (every form, then
// back), two rounds, the first and last given. The timed state is a taken
// devex pivot; eta_colk is timed without the next step before, so every
// call does the same work.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "../simplex_tpu_torch/kernels/csrc/eta.cu"

#define CK(x)                                                              \
    do {                                                                   \
        cudaError_t e_ = (cudaError_t)(x);                                 \
        if (e_ != cudaSuccess) {                                           \
            std::printf("CUDA error %s at %s:%d\n",                        \
                        cudaGetErrorString(e_), __FILE__, __LINE__);       \
            std::exit(1);                                                  \
        }                                                                  \
    } while (0)

// ---------------------------------------------------------------------------
// The kernels the port launched before, verbatim (their helpers, the
// workspace's layout and the candidates' folds are the shipped file's,
// unchanged).

namespace prior {

constexpr int ROWS_A = 64;
constexpr int COLS_B = 128;
constexpr int STAGE = 128;

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

}  // namespace prior

// ---------------------------------------------------------------------------
// The harness.

namespace {

// Device fill: a value in [lo, hi) from a hash of the index and a seed.
__global__ void fill_kernel(double *out, size_t n, unsigned seed, double lo,
                            double hi) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        unsigned long long x = (i + 1) * 0x9E3779B97F4A7C15ull + seed;
        x ^= x >> 31;
        x *= 0xBF58476D1CE4E5B9ull;
        x ^= x >> 29;
        out[i] = lo + (hi - lo) * (double)(x >> 11) * (1.0 / 9007199254740992.0);
    }
}
template <typename T>
__global__ void narrow_kernel(T *out, const double *in, size_t n) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x)
        out[i] = (T)in[i];
}

// n uniform values of T in [lo, hi) into out (a scratch of n doubles).
template <typename T>
void fill(T *out, size_t n, unsigned seed, double lo, double hi,
          double *scratch) {
    fill_kernel<<<1024, 256>>>(scratch, n, seed, lo, hi);
    narrow_kernel<T><<<1024, 256>>>(out, scratch, n);
    CK(cudaGetLastError());
}

// The scalars: field i of kernels.seq.SeqScalars at byte 16 i of one
// device buffer.
constexpr int NSCAL = 19;
enum Field {
    STATUS, ITERS, STALL, BLAND, Z, H_D, V_D, H_B, V_B, ACTIVE, H, MINC,
    OPTIMAL_, K, BK, UNB, DO, P, U
};

template <typename T, typename V>
struct Prob {
    int M, R, L;
    T *Tt, *C, *F, *ah, *C0, *F0;
    V *b, *costs, *w;
    int *base;
    unsigned char *ws, *scal;
    long long ws_len;
    // The state one pivot starts from (the vectors, C and F's rows t).
    std::vector<unsigned char> h_scal;
    V *b0, *costs0, *w0;
    int *base0;

    SeqStep<T, V> step() const {
        void *p[NSCAL];
        for (int i = 0; i < NSCAL; ++i) p[i] = scal + 16 * i;
        SeqStep<T, V> s;
        memcpy(&s, p, sizeof s);
        return s;
    }
    template <typename X>
    void set(Field f, X v) {
        memcpy(h_scal.data() + 16 * f, &v, sizeof v);
    }
};

template <typename T, typename V>
Prob<T, V> make(int M, int R, int L, unsigned seed) {
    Prob<T, V> p{};
    p.M = M;
    p.R = R;
    p.L = L;
    const size_t big = std::max((size_t)M * R, (size_t)L * (M + R));
    double *scratch;
    CK(cudaMalloc(&scratch, big * sizeof(double)));
    CK(cudaMalloc(&p.Tt, (size_t)M * R * sizeof(T)));
    CK(cudaMalloc(&p.C, (size_t)L * R * sizeof(T)));
    CK(cudaMalloc(&p.F, (size_t)L * M * sizeof(T)));
    CK(cudaMalloc(&p.C0, (size_t)L * R * sizeof(T)));
    CK(cudaMalloc(&p.F0, (size_t)L * M * sizeof(T)));
    CK(cudaMalloc(&p.ah, M * sizeof(T)));
    for (V **v : {&p.b, &p.b0}) CK(cudaMalloc(v, M * sizeof(V)));
    for (V **v : {&p.costs, &p.w, &p.costs0, &p.w0})
        CK(cudaMalloc(v, R * sizeof(V)));
    for (int **v : {&p.base, &p.base0}) CK(cudaMalloc(v, M * sizeof(int)));
    // Large enough for any grid below: 64 bytes a block at one row or
    // column a block.
    p.ws_len = 16 + 32 * (long long)M + 64 * (long long)R;
    CK(cudaMalloc(&p.ws, p.ws_len));
    CK(cudaMemset(p.ws, 0, p.ws_len));
    CK(cudaMalloc(&p.scal, 16 * NSCAL));
    fill(p.Tt, (size_t)M * R, seed, -1.0, 1.0, scratch);
    fill(p.C, (size_t)L * R, seed + 1, -0.1, 0.1, scratch);
    fill(p.F, (size_t)L * M, seed + 2, -0.1, 0.1, scratch);
    CK(cudaMemcpy(p.C0, p.C, (size_t)L * R * sizeof(T),
                  cudaMemcpyDeviceToDevice));
    CK(cudaMemcpy(p.F0, p.F, (size_t)L * M * sizeof(T),
                  cudaMemcpyDeviceToDevice));
    fill(p.b0, M, seed + 3, 0.0, 1.0, scratch);
    fill(p.costs0, R, seed + 4, -1.0, 1.0, scratch);
    fill(p.w0, R, seed + 5, 1.0, 2.0, scratch);
    std::vector<int> base(M);
    for (int j = 0; j < M; ++j) base[j] = (int)((j * 7919LL) % R);
    CK(cudaMemcpy(p.base0, base.data(), M * sizeof(int),
                  cudaMemcpyHostToDevice));
    CK(cudaDeviceSynchronize());
    CK(cudaFree(scratch));
    p.h_scal.assign(16 * NSCAL, 0);
    return p;
}

template <typename T, typename V>
void release(Prob<T, V> &p) {
    for (void *x : {(void *)p.Tt, (void *)p.C, (void *)p.F, (void *)p.ah,
                    (void *)p.b, (void *)p.costs, (void *)p.w,
                    (void *)p.base, (void *)p.ws, (void *)p.scal,
                    (void *)p.b0, (void *)p.costs0, (void *)p.w0,
                    (void *)p.base0, (void *)p.C0, (void *)p.F0})
        CK(cudaFree(x));
}

// The state a pivot starts from: the vectors, C[t] and F[t] set to a
// pattern, the scalars from h_scal, the ah and the counters zeroed.
template <typename T, typename V>
void reset(Prob<T, V> &p, int t) {
    CK(cudaMemcpy(p.b, p.b0, p.M * sizeof(V), cudaMemcpyDeviceToDevice));
    CK(cudaMemcpy(p.costs, p.costs0, p.R * sizeof(V),
                  cudaMemcpyDeviceToDevice));
    CK(cudaMemcpy(p.w, p.w0, p.R * sizeof(V), cudaMemcpyDeviceToDevice));
    CK(cudaMemcpy(p.base, p.base0, p.M * sizeof(int),
                  cudaMemcpyDeviceToDevice));
    CK(cudaMemset(p.C + (size_t)t * p.R, 0x7f, p.R * sizeof(T)));
    CK(cudaMemset(p.F + (size_t)t * p.M, 0x7f, p.M * sizeof(T)));
    CK(cudaMemset(p.ah, 0, p.M * sizeof(T)));
    CK(cudaMemset(p.ws, 0, 16));
    CK(cudaMemcpy(p.scal, p.h_scal.data(), 16 * NSCAL,
                  cudaMemcpyHostToDevice));
}

// Everything a pivot writes, as bytes.
template <typename T, typename V>
std::vector<unsigned char> outputs(const Prob<T, V> &p, int t) {
    std::vector<unsigned char> out;
    auto grab = [&](const void *d, size_t n) {
        const size_t at = out.size();
        out.resize(at + n);
        CK(cudaMemcpy(out.data() + at, d, n, cudaMemcpyDeviceToHost));
    };
    CK(cudaDeviceSynchronize());
    grab(p.scal, 16 * NSCAL);
    grab(p.ah, p.M * sizeof(T));
    grab(p.C + (size_t)t * p.R, p.R * sizeof(T));
    grab(p.F + (size_t)t * p.M, p.M * sizeof(T));
    grab(p.b, p.M * sizeof(V));
    grab(p.costs, p.R * sizeof(V));
    grab(p.w, p.R * sizeof(V));
    grab(p.base, p.M * sizeof(int));
    grab(p.ws, 8);                               // both counters back at 0
    return out;
}

// A form of the pivot: its two launches, each with its grid, threads,
// slab rows a round (0: as many as two rounds fit, at most 128), and as a
// programmatic dependent launch or not; ``fixed`` false copies every slab
// row by the general path (a 16-byte copy a whole chunk, found by
// division), as unaligned rows are.
struct Form {
    std::string name;
    int rows, cols, nt_a, nt_b;                  // 0: prior
    int stage_a, stage_b;
    bool pdl_a, pdl_b;
    bool fixed;
};

// The most slab rows a round whose two rounds fit beside the window's
// coefficients in a block's shared memory, at most 128.
int max_stage(int width, int L, int item) {
    const long long row = (long long)slab_width(width, item) * item;
    const long long room =
            BLOCK_SMEM - SMEM_RESERVE - round16((long long)L * item);
    return (int)std::min<long long>(128, room / (2 * row));
}

template <typename T, typename V>
int ratio_form(const Form &f, Prob<T, V> &p, int t, double eps,
               const SeqStep<T, V> &s, cudaStream_t st) {
    if (f.rows == 0)
        return prior::ratio_run<T, V>(p.Tt, p.C, p.F, p.b, p.ah, p.M, p.R, p.L,
                                     t, eps, p.ws, p.ws_len, &s, st);
    const int stage = f.stage_a ? f.stage_a : max_stage(f.rows, p.L, sizeof(T));
    if (!f.fixed)
        return ratio_run<T, V, 128, false>(p.Tt, p.C, p.F, p.b, p.ah, p.M,
                                           p.R, p.L, t, eps, p.ws, p.ws_len,
                                           &s, f.rows, f.cols, stage, f.pdl_a,
                                           st);
    if (f.nt_a == 64)
        return ratio_run<T, V, 64>(p.Tt, p.C, p.F, p.b, p.ah, p.M, p.R, p.L,
                                   t, eps, p.ws, p.ws_len, &s, f.rows, f.cols,
                                   stage, f.pdl_a, st);
    return ratio_run<T, V, 128>(p.Tt, p.C, p.F, p.b, p.ah, p.M, p.R, p.L, t,
                                eps, p.ws, p.ws_len, &s, f.rows, f.cols,
                                stage, f.pdl_a, st);
}

template <typename T, typename V>
int colk_form(const Form &f, Prob<T, V> &p, int t, double eps,
              const SeqStep<T, V> &s, const seq::Policy &pol,
              cudaStream_t st) {
    if (f.rows == 0)
        return prior::colk_run<T, V>(p.Tt, p.C, p.F, p.costs, p.b, p.base,
                                    p.w, p.ah, p.M, p.R, p.L, p.R - 1, t,
                                    p.ws, p.ws_len, &s, pol, st);
    const int stage = f.stage_b ? f.stage_b : max_stage(f.cols, p.L, sizeof(T));
    if (!f.fixed && f.nt_b == 256)
        return colk_run<T, V, 256, false>(p.Tt, p.C, p.F, p.costs, p.b,
                                          p.base, p.w, p.ah, p.M, p.R, p.L,
                                          p.R - 1, t, p.ws, p.ws_len, &s, pol,
                                          f.rows, f.cols, stage, f.pdl_b, st);
    if (!f.fixed)
        return colk_run<T, V, 128, false>(p.Tt, p.C, p.F, p.costs, p.b,
                                          p.base, p.w, p.ah, p.M, p.R, p.L,
                                          p.R - 1, t, p.ws, p.ws_len, &s, pol,
                                          f.rows, f.cols, stage, f.pdl_b, st);
    if (f.nt_b == 256)
        return colk_run<T, V, 256>(p.Tt, p.C, p.F, p.costs, p.b, p.base,
                                   p.w, p.ah, p.M, p.R, p.L, p.R - 1, t,
                                   p.ws, p.ws_len, &s, pol, f.rows, f.cols,
                                   stage, f.pdl_b, st);
    return colk_run<T, V, 128>(p.Tt, p.C, p.F, p.costs, p.b, p.base, p.w,
                               p.ah, p.M, p.R, p.L, p.R - 1, t, p.ws,
                               p.ws_len, &s, pol, f.rows, f.cols, stage,
                               f.pdl_b, st);
}

// The widths of the first redesign: the fewest rows a block of eta_ratio
// whose grid fits half the SMs, and columns a block of eta_colk one block
// an SM, the widest where none does; each with as many slab rows a round
// as fit (``old``).
int fewest(int n, std::initializer_list<int> ws, int blocks) {
    int last = 0;
    for (int w : ws) {
        last = w;
        if (cdiv(n, w) <= blocks) return w;
    }
    return last;
}
void old_grid(int M, int R, int &rows, int &cols) {
    rows = fewest(M, {16, 32, 64, 128}, 132 / 2);
    cols = fewest(R, {32, 64, 128}, 132);
}

// kernels/eta.py eta_plan's rule (``shipped``): old_grid's rows; the
// fewest columns (32-256, 256 threads a block for 256) whose whole grid,
// the blocks of F[t] and b included, takes one wave of one block an SM, else
// 256; as many slab rows a round as fit, but 16 for eta_colk past one wave.
Form shipped(int M, int R, bool pdl) {
    int rows, cols_old;
    old_grid(M, R, rows, cols_old);
    auto blocks = [&](int c) { return cdiv(R, c) + cdiv(M, std::max(128, c)); };
    int cols = 256;
    for (int c : {32, 64, 128, 256})
        if (blocks(c) <= 132) {
            cols = c;
            break;
        }
    return Form{"shipped", rows, cols, 128, std::max(128, cols), 0,
                blocks(cols) > 132 ? 16 : 0, pdl, pdl, true};
}

// prior, the shipped plan (each launch alone: no programmatic dependent
// launch between two calls of one kernel) and the same by the general copy
// path, the first redesign's grid, then other widths and stages.
std::vector<Form> forms(int M, int R) {
    int rows, cols;
    old_grid(M, R, rows, cols);
    auto form = [&](std::string name, int r, int c, int nb, int sa, int sb) {
        return Form{name, r, c, 128, nb, sa, sb, false, false, true};
    };
    std::vector<Form> out{{"prior", 0, 0, 0, 0, 0, 0, false, false, true},
                          shipped(M, R, false)};
    out.push_back(out.back());
    out.back().name = "general";
    out.back().fixed = false;
    out.push_back(form("old", rows, cols, 128, 0, 0));
    for (int r : {16, 32, 64})
        out.push_back(Form{"r" + std::to_string(r) + "x64", r, cols, 64, 128,
                           0, 0, false, false, true});
    for (int r : {16, 32, 64, 128})
        if (r != rows)
            out.push_back(form("r" + std::to_string(r) + "x128", r, cols, 128,
                               0, 0));
    for (int sa : {16, 32})
        out.push_back(form("rs" + std::to_string(sa), rows, cols, 128, sa, 0));
    for (int c : {32, 64, 128})
        if (c != cols)
            out.push_back(form("c" + std::to_string(c) + "x128", rows, c, 128,
                               0, 0));
    for (int c : {128, 256})
        out.push_back(form("c" + std::to_string(c) + "x256", rows, c, 256, 0,
                           0));
    for (int c : {64, 128})
        for (int sb : {8, 16, 32})
            out.push_back(form("c" + std::to_string(c) + "s" +
                                       std::to_string(sb),
                               rows, c, 128, 0, sb));
    for (int sb : {8, 16})
        out.push_back(form("c256s" + std::to_string(sb), rows, 256, 256, 0,
                           sb));
    return out;
}

// The pivot's forms: prior, the shipped plan (both launches programmatic
// dependent launches, as the port launches them), the first redesign's
// grid with plain launches, with eta_colk a programmatic dependent launch,
// with both; then eta_colk's other widths and stages, both programmatic.
std::vector<Form> pivot_forms(int M, int R) {
    int rows, cols;
    old_grid(M, R, rows, cols);
    auto both = [&](std::string name, int c, int nb, int sa, int sb) {
        return Form{name, rows, c, 128, nb, sa, sb, true, true, true};
    };
    std::vector<Form> out{
            {"prior", 0, 0, 0, 0, 0, 0, false, false, true},
            shipped(M, R, true),
            {"plain", rows, cols, 128, 128, 0, 0, false, false, true},
            {"pdl-colk", rows, cols, 128, 128, 0, 0, false, true, true},
            both("pdl-both", cols, 128, 0, 0)};
    for (int c : {64, 128})
        for (int sb : {8, 16, 32})
            out.push_back(both("c" + std::to_string(c) + "s" +
                                       std::to_string(sb),
                               c, 128, 0, sb));
    for (int sb : {8, 16})
        out.push_back(both("c256s" + std::to_string(sb), 256, 256, 0, sb));
    out.push_back(both("c256x256", 256, 256, 0, 0));
    out.push_back(both("rs32-c128s16", 128, 128, 32, 16));
    return out;
}

// The scalars of a taken devex pivot at column h; edge states on top.
template <typename T, typename V>
void state(Prob<T, V> &p, int edge, double &eps, seq::Policy &pol) {
    const int h = (p.R * 5) / 7;
    std::fill(p.h_scal.begin(), p.h_scal.end(), 0);
    p.set(STATUS, (int)seq::RUNNING);
    p.set(ITERS, 3);
    p.set(STALL, 1);
    p.set(BLAND, (unsigned char)(edge == 3));
    p.set(Z, (V)0.25);
    p.set(ACTIVE, (unsigned char)(edge != 4));
    p.set(H, h);
    p.set(MINC, (V)-0.5);
    p.set(OPTIMAL_, (unsigned char)0);
    eps = edge == 2 ? 1e30 : 1e-9;
    pol = seq::Policy{1000, 1e-9,
                      edge == 6 ? (int)step::BLAND_STATIC
                                : (int)step::BLAND_THRESHOLD,
                      3, edge == 6};
    if (edge == 1) {                             // a NaN in b
        const V nan = (V)NAN;
        CK(cudaMemcpy(p.b0 + (p.M * 3) / 5, &nan, sizeof nan,
                      cudaMemcpyHostToDevice));
    }
    if (edge == 5) {                             // past the re-anchor
        const V big = (V)3e8;
        CK(cudaMemcpy(p.w0 + p.R - 2, &big, sizeof big,
                      cudaMemcpyHostToDevice));
    }
}

template <typename T, typename V>
void restore(Prob<T, V> &p, int edge) {
    if (edge == 1) {
        const V one = (V)0.5;
        CK(cudaMemcpy(p.b0 + (p.M * 3) / 5, &one, sizeof one,
                      cudaMemcpyHostToDevice));
    }
    if (edge == 5) {
        const V one = (V)1.5;
        CK(cudaMemcpy(p.w0 + p.R - 2, &one, sizeof one,
                      cudaMemcpyHostToDevice));
    }
}

template <typename T, typename V>
std::vector<unsigned char> pivot(const Form &f, Prob<T, V> &p, int t,
                                 double eps, const seq::Policy &pol) {
    reset(p, t);
    const SeqStep<T, V> s = p.step();
    CK(ratio_form(f, p, t, eps, s, 0));
    CK(colk_form(f, p, t, eps, s, pol, 0));
    return outputs(p, t);
}

int failures = 0;
bool trace = false;                              // each pivot named first

template <typename T, typename V>
void check(const char *pair, int M, int R, int L) {
    Prob<T, V> p = make<T, V>(M, R, L, 17 + M + R + L);
    std::vector<Form> fs = forms(M, R);
    for (const Form &f : pivot_forms(M, R))
        if (f.pdl_a || f.pdl_b) fs.push_back(f);
    int n = 0;
    for (int t : {0, 1, L / 2, L - 1}) {
        for (int edge = 0; edge < 7; ++edge) {
            double eps;
            seq::Policy pol;
            state(p, edge, eps, pol);
            const auto want = pivot(fs[0], p, t, eps, pol);
            for (size_t v = 1; v < fs.size(); ++v) {
                if (trace) {
                    std::printf("pivot %s M=%d R=%d L=%d t=%d edge %d %s\n",
                                pair, M, R, L, t, edge, fs[v].name.c_str());
                    std::fflush(stdout);
                }
                const auto got = pivot(fs[v], p, t, eps, pol);
                ++n;
                if (got != want) {
                    ++failures;
                    std::printf("MISMATCH %s M=%d R=%d L=%d t=%d edge %d %s\n",
                                pair, M, R, L, t, edge, fs[v].name.c_str());
                }
            }
            restore(p, edge);
        }
    }
    std::printf("check %s M=%d R=%d L=%d: %d pivots byte for byte\n", pair, M,
                R, L, n);
    release(p);
}

float replay_us(cudaGraphExec_t g, cudaStream_t st, int calls) {
    cudaEvent_t e0, e1;
    CK(cudaEventCreate(&e0));
    CK(cudaEventCreate(&e1));
    CK(cudaEventRecord(e0, st));
    for (int i = 0; i < 20; ++i) CK(cudaGraphLaunch(g, st));
    CK(cudaEventRecord(e1, st));
    CK(cudaEventSynchronize(e1));
    float ms = 0.0f;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    CK(cudaEventDestroy(e0));
    CK(cudaEventDestroy(e1));
    return 1000.0f * ms / (20.0f * calls);
}

template <typename F>
cudaGraphExec_t capture(cudaStream_t st, F fn) {
    cudaGraph_t g;
    cudaGraphExec_t exec;
    CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal));
    for (int i = 0; i < 50; ++i) CK(fn());
    CK(cudaStreamEndCapture(st, &g));
    CK(cudaGraphInstantiate(&exec, g, 0));
    CK(cudaGraphDestroy(g));
    return exec;
}

// Each graph's us a call in turns: every form, then back, two rounds.
void turns(const std::vector<cudaGraphExec_t> &gs, cudaStream_t st,
           std::vector<float> &first, std::vector<float> &last) {
    const int n = (int)gs.size();
    for (int v = 0; v < n; ++v) CK(cudaGraphLaunch(gs[v], st));   // warm
    CK(cudaStreamSynchronize(st));
    first.assign(n, 0.0f);
    last.assign(n, 0.0f);
    for (int round = 0; round < 2; ++round) {
        for (int v = 0; v < n; ++v) {
            const float us = replay_us(gs[v], st, 50);
            (round == 0 ? first : last)[v] = us;
        }
        for (int v = n - 1; v >= 0; --v) {
            const float us = replay_us(gs[v], st, 50);
            (round == 0 ? first : last)[v] =
                    0.5f * ((round == 0 ? first : last)[v] + us);
        }
    }
}

template <typename T, typename V>
void timing(const char *pair, int M, int R) {
    const int L = 128;
    Prob<T, V> p = make<T, V>(M, R, L, 5);
    const std::vector<Form> fs = forms(M, R);
    cudaStream_t st;
    CK(cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking));
    for (int t : {0, 64, 127}) {
        double eps;
        seq::Policy pol;
        state(p, 0, eps, pol);
        pol.then_pre = 0;
        // The factors as made (the calls timed before wrote their rows).
        CK(cudaMemcpy(p.C, p.C0, (size_t)L * R * sizeof(T),
                      cudaMemcpyDeviceToDevice));
        CK(cudaMemcpy(p.F, p.F0, (size_t)L * M * sizeof(T),
                      cudaMemcpyDeviceToDevice));
        reset(p, t);
        const SeqStep<T, V> s = p.step();
        CK(ratio_form(fs[0], p, t, eps, s, st));
        CK(cudaStreamSynchronize(st));
        unsigned char d = 0;
        CK(cudaMemcpy(&d, p.scal + 16 * DO, 1, cudaMemcpyDeviceToHost));
        if (!d) {
            std::printf("timing %s M=%d R=%d t=%d: the pivot is not taken\n",
                        pair, M, R, t);
            ++failures;
        }
        std::vector<cudaGraphExec_t> ga, gb;
        for (const Form &f : fs) {
            ga.push_back(capture(st, [&] {
                return ratio_form(f, p, t, eps, s, st);
            }));
            gb.push_back(capture(st, [&] {
                return colk_form(f, p, t, eps, s, pol, st);
            }));
        }
        std::vector<float> a0, a1, b0, b1;
        turns(ga, st, a0, a1);
        turns(gb, st, b0, b1);
        for (size_t v = 0; v < fs.size(); ++v)
            std::printf("time %s M=%d R=%d L=%d t=%d %-9s (rows %d, cols %d):"
                        " eta_ratio %.3f %.3f us, eta_colk %.3f %.3f us\n",
                        pair, M, R, L, t, fs[v].name.c_str(), fs[v].rows,
                        fs[v].cols, a0[v], a1[v], b0[v], b1[v]);
        for (auto g : ga) CK(cudaGraphExecDestroy(g));
        for (auto g : gb) CK(cudaGraphExecDestroy(g));
        // The pivot: eta_ratio then eta_colk, 50 times, as in a window (at
        // one depth).
        const std::vector<Form> ps = pivot_forms(M, R);
        std::vector<cudaGraphExec_t> gp;
        for (const Form &f : ps)
            gp.push_back(capture(st, [&] {
                const int e = ratio_form(f, p, t, eps, s, st);
                return e ? e : colk_form(f, p, t, eps, s, pol, st);
            }));
        std::vector<float> p0, p1;
        turns(gp, st, p0, p1);
        for (size_t v = 0; v < ps.size(); ++v)
            std::printf("pivot %s M=%d R=%d L=%d t=%d %-9s: %.3f %.3f us\n",
                        pair, M, R, L, t, ps[v].name.c_str(), p0[v], p1[v]);
        for (auto g : gp) CK(cudaGraphExecDestroy(g));
        // Back to a taken pivot's state for the next depth.
        reset(p, t);
    }
    CK(cudaStreamDestroy(st));
    release(p);
}

}  // namespace

int main(int argc, char **argv) {
    trace = argc > 1 && std::string(argv[1]) == "trace";
    cudaDeviceProp prop;
    CK(cudaGetDeviceProperties(&prop, 0));
    std::printf("device %s, %d SMs\n", prop.name, prop.multiProcessorCount);
    const int shapes[][2] = {{2048, 6144}, {1, 3},     {37, 6143},
                             {2047, 6143}, {2047, 3},  {4097, 257}};
    for (const auto &sh : shapes)
        for (int L : {128, 13, 300}) {
            check<double, double>("f64", sh[0], sh[1], L);
            check<float, double>("f32/f64", sh[0], sh[1], L);
            check<float, float>("f32", sh[0], sh[1], L);
        }
    const int timed[][2] = {{2048, 6144}, {8192, 24576}};
    for (const auto &sh : timed) {
        timing<double, double>("f64", sh[0], sh[1]);
        timing<float, double>("f32/f64", sh[0], sh[1]);
        timing<float, float>("f32", sh[0], sh[1]);
    }
    timing<double, double>("f64", 10112, 120064);
    std::printf(failures ? "FAILED: %d\n" : "every check passed\n", failures);
    return failures ? 1 : 0;
}
