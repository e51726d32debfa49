// K1 (the entering column and ratio test) and K3 (the window apply with its
// f64 reprice) on the card: the shipped kernels (csrc/blocked.cu
// ah_ratio_fused, window_apply<true>) beside the kernels they replaced, each
// checked bit for bit against the old one, and K1's design probes, at the
// flagship shapes (M=8192, R=24576, L=128). Build and run on a machine with
// an H100:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/k1k3_variants tools/k1k3_variants.cu && /tmp/k1k3_variants
//
// K1, us a call at t = 0, 37, 127, by CUDA events over a CUDA graph of 50
// calls replayed 4 times (the host's launch rate left out), three rounds in
// turns:
//   old        the kernel it replaced, two launches: a tile pass of
//              M / 256 blocks, one thread a constraint loading its F
//              values behind its FFMA chain, then a one-block fold pass,
//              both folding with an eight-barrier tree;
//   shipped    ah_ratio_launch: 64 constraints a block, the F slab issued
//              at once as cp.async, the last block to arrive folds, its
//              ticket one acq_rel atomic, the winners' a_h and b[j] carried
//              in the partials;
//   first      this design as first written: __threadfence + atomicAdd
//              for the ticket and a fence in the last block, p carried
//              through the fold and bk loaded from b[k] after it;
//   fence      shipped with the first one's fences and atomicAdd;
//   nocarry    shipped with p through the fold and bk loaded after it;
//   cols N     shipped with N constraints a block (128 F rows a pass, 64
//              at N = 128: 32 KB of shared memory at most);
//   batch      shipped with the chain's loads issued 16 at a time;
//   nofold     shipped without the cross-block fold (each block writes its
//              partial and ends; k is not computed): what the ticket and
//              the last block's fold cost;
//   column     reads h, then Tt[j, h], and writes it to a_h (no F, no
//              ratio): the floor of the dependent loads;
//   empty      a kernel that does nothing: the launch's floor.
// The old kernel, the shipped one and every variant that folds must give
// the same a_h, k, p, bk and flag bit for bit.
// K3, ms a call by CUDA events over 10 back-to-back calls, three rounds in
// turns: old (apply_tile.cuh's tile with its fold, apply_tiles<true>, then
// reprice_finish), shipped (window_apply<true>, then reprice_finish) and K4
// (window_apply<false>); Tt and mv of the shipped K3 checked bit for bit
// against the old tile's at the flagship shape, 256 x 384 x 8 and
// 1024 x 2944 x 136.
// K5 (the entering column alone, csrc/blocked.cu ah_launch: K1's kernel
// without its ratio test), us a call at t = 0, 37, 127 over a CUDA graph as
// K1, three rounds in turns: old (the kernel it replaced, ah_tiles: one
// thread a constraint in M / 256 blocks, C[s, h] staged after h is read,
// the F loads behind the FFMA chain), shipped (64 threads a block at t = 0,
// 256 after), K1 beside, and the same kernel at 128 and at 64 threads a
// block for every t; its column checked bit for bit against K1's and the
// old kernel's at t = 0, 37, 127 and 129 (past AHR_ROWS, a second pass of
// the chain), and the variants' against the shipped kernel's.

#include <cstdio>
#include <functional>

#include "../simplex_tpu_torch/kernels/csrc/blocked.cu"

namespace {

// ---- the replaced K5 (and the column of the replaced K1): one thread a
// constraint, C[s, h] staged in shared memory after h is read ----

__device__ __forceinline__ void old_ah_stage(const float *__restrict__ C,
                                             int h, int t, int R, float *ch) {
    for (int s = threadIdx.x; s < t; s += blockDim.x)
        ch[s] = C[(size_t)s * R + h];
    __syncthreads();
}

__device__ __forceinline__ float old_ah_entry(const float *__restrict__ Tt,
                                              const float *__restrict__ F,
                                              const float *ch, int h, int t,
                                              int j, int M, int R) {
    float acc = 0.0f;
    for (int s = 0; s < t; ++s)
        acc = fmaf(ch[s], F[(size_t)s * M + j], acc);
    return __fsub_rn(Tt[(size_t)j * R + h], acc);
}

__global__ void __launch_bounds__(THREADS) old_ah_tiles(
        const float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, const int *__restrict__ h_ptr, int t,
        int M, int R, float *__restrict__ ah) {
    extern __shared__ float ch[];                // C[s, h] for s < t
    const int h = min(*h_ptr, R - 1);
    old_ah_stage(C, h, t, R, ch);
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j < M) ah[j] = old_ah_entry(Tt, F, ch, h, t, j, M, R);
}

// ---- the replaced K1: two launches, the eight-barrier fold ----

__device__ void old_block_argmax(double &key, int &idx) {
    __shared__ double sk[THREADS];
    __shared__ int si[THREADS];
    const int tid = threadIdx.x;
    sk[tid] = key;
    si[tid] = idx;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (tid < s && better(sk[tid + s], si[tid + s], sk[tid], si[tid])) {
            sk[tid] = sk[tid + s];
            si[tid] = si[tid + s];
        }
        __syncthreads();
    }
    key = sk[0];
    idx = si[0];
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS) old_tiles(
        const float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, const double *__restrict__ b,
        const int *__restrict__ h_ptr, int t, int M, int R, float eps,
        float *__restrict__ ah, double *__restrict__ part_key,
        int *__restrict__ part_idx) {
    extern __shared__ float ch[];
    const int h = min(*h_ptr, R - 1);
    old_ah_stage(C, h, t, R, ch);
    const int j = blockIdx.x * THREADS + threadIdx.x;
    double key = -CUDART_INF;
    int idx = BIG_INDEX;
    if (j < M) {
        const float a = old_ah_entry(Tt, F, ch, h, t, j, M, R);
        ah[j] = a;
        if (a >= eps) {
            key = -__ddiv_rn(b[j], (double)a);
            idx = j;
        }
    }
    old_block_argmax(key, idx);
    if (threadIdx.x == 0) {
        part_key[blockIdx.x] = key;
        part_idx[blockIdx.x] = idx;
    }
}

__global__ void __launch_bounds__(THREADS) old_finish(
        const double *__restrict__ part_key, const int *__restrict__ part_idx,
        int nparts, const float *__restrict__ ah, const double *__restrict__ b,
        int *k_out, float *p_out, double *bk_out, int *unb_out) {
    double key = -CUDART_INF;
    int idx = BIG_INDEX;
    for (int i = threadIdx.x; i < nparts; i += THREADS)
        if (better(part_key[i], part_idx[i], key, idx)) {
            key = part_key[i];
            idx = part_idx[i];
        }
    old_block_argmax(key, idx);
    if (threadIdx.x == 0) {
        const bool none = idx == BIG_INDEX;
        *k_out = idx;
        *p_out = none ? 0.0f : ah[idx];
        *bk_out = none ? 0.0 : b[idx];
        *unb_out = none ? 1 : 0;
    }
}

// ---- the shipped design with COLS constraints a block and ROWS live F
// rows a pass (32 KB of F at most) and MODE's bits: FOLD the cross-block
// fold (else each block writes its partial and ends), ACQREL the shipped
// ticket (one acq_rel atomic; else __threadfence + atomicAdd, and a second
// fence in the last block), CARRY the winners' a_h and b[j] carried in the
// partials as shipped (else p from the fold and bk loaded from b[k] after
// it), BATCH the chain's shared-memory loads issued 16 at a time into
// registers ahead of their FFMAs (the same FFMAs in the same order).

constexpr int FOLD = 1, ACQREL = 2, CARRY = 4, BATCH = 8;

template <int COLS, int ROWS, int MODE>
__global__ void __launch_bounds__(THREADS) k1_cols(
        const float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, const double *__restrict__ b,
        const int *__restrict__ h_ptr, int t, int M, int R, float eps,
        int nb, float *__restrict__ ah, unsigned char *__restrict__ ws_bytes,
        int *k_out, float *p_out, double *bk_out, int *unb_out) {
    constexpr int CHUNKS = COLS / 4;
    __shared__ __align__(16) float fs[ROWS][COLS];
    __shared__ float ch[ROWS];
    __shared__ double sa[THREADS], sb[THREADS];
    __shared__ bool last;
    const AhrWs ws(ws_bytes, nb);
    const int tid = threadIdx.x;
    const int j0 = blockIdx.x * COLS, j = j0 + tid;
    const bool owner = tid < COLS;
    auto stage = [&](int s0) {
        const int rows = min(ROWS, t - s0);
        for (int c = tid; c < rows * CHUNKS; c += THREADS) {
            const int s = c / CHUNKS, q = (c % CHUNKS) * 4;
            cp_async16(&fs[s][q], F + (size_t)(s0 + s) * M + j0 + q);
        }
    };
    stage(0);
    cp_async_commit();
    const int h = min(*h_ptr, R - 1);
    for (int s = tid; s < min(ROWS, t); s += THREADS)
        ch[s] = C[(size_t)s * R + h];
    float th = 0.0f;
    double bj = 0.0;
    if (owner) {
        th = Tt[(size_t)j * R + h];
        bj = b[j];
    }
    float acc = 0.0f;
    for (int s0 = 0;;) {
        cp_async_wait<0>();
        __syncthreads();
        const int rows = min(ROWS, t - s0);
        if (owner && (MODE & BATCH)) {
            int s = 0;
            for (; s + 16 <= rows; s += 16) {
                float f[16], c[16];
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    f[i] = fs[s + i][tid];
                    c[i] = ch[s + i];
                }
#pragma unroll
                for (int i = 0; i < 16; ++i) acc = fmaf(c[i], f[i], acc);
            }
            for (; s < rows; ++s) acc = fmaf(ch[s], fs[s][tid], acc);
        } else if (owner) {
#pragma unroll 8
            for (int s = 0; s < rows; ++s) acc = fmaf(ch[s], fs[s][tid], acc);
        }
        s0 += ROWS;
        if (s0 >= t) break;
        __syncthreads();
        stage(s0);
        cp_async_commit();
        for (int s = tid; s < min(ROWS, t - s0); s += THREADS)
            ch[s] = C[(size_t)(s0 + s) * R + h];
    }
    double key = -CUDART_INF, val = 0.0;         // val: a_h, or the thread
    int idx = BIG_INDEX;
    if (owner) {
        const float a = __fsub_rn(th, acc);
        ah[j] = a;
        if (a >= eps) {
            key = -__ddiv_rn(bj, (double)a);
            idx = j;
            val = (double)a;
        }
        sa[tid] = (double)a;
        sb[tid] = bj;
    }
    if (MODE & CARRY) val = tid;
    block_argmax_warps(key, idx, val);
    if (tid == 0) {
        const bool none = idx == BIG_INDEX;
        ws.key[blockIdx.x] = key;
        ws.idx[blockIdx.x] = idx;
        ws.a[blockIdx.x] = (MODE & CARRY) ? (none ? 0.0 : sa[(int)val]) : val;
        if (MODE & CARRY) ws.b[blockIdx.x] = none ? 0.0 : sb[(int)val];
        if (MODE & FOLD) {
            if (MODE & ACQREL) {
                last = ticket(ws.counter) == (unsigned)nb - 1;
            } else {
                __threadfence();
                last = atomicAdd(ws.counter, 1u) == (unsigned)nb - 1;
            }
        }
    }
    if (!(MODE & FOLD)) return;
    __syncthreads();
    if (!last) return;
    if (!(MODE & ACQREL)) __threadfence();
    key = -CUDART_INF;
    val = 0.0;
    idx = BIG_INDEX;
    double pb = 0.0;
    for (int i = tid; i < nb; i += THREADS) {
        const double ki = __ldcg(ws.key + i);
        const int ii = __ldcg(ws.idx + i);
        const double ai = __ldcg(ws.a + i);
        const double bi = (MODE & CARRY) ? __ldcg(ws.b + i) : 0.0;
        if (better(ki, ii, key, idx)) {
            key = ki;
            idx = ii;
            val = ai;
            pb = bi;
        }
    }
    if (MODE & CARRY) {
        sa[tid] = val;
        sb[tid] = pb;
        val = tid;
    }
    block_argmax_warps(key, idx, val);
    if (tid == 0) {
        const bool none = idx == BIG_INDEX;
        *k_out = idx;
        *p_out = none ? 0.0f
                      : (float)((MODE & CARRY) ? sa[(int)val] : val);
        *bk_out = none ? 0.0 : ((MODE & CARRY) ? sb[(int)val] : b[idx]);
        *unb_out = none ? 1 : 0;
        *ws.counter = 0;
    }
}

__global__ void column_only(const float *__restrict__ Tt,
                            const int *__restrict__ h_ptr, int M, int R,
                            float *__restrict__ ah) {
    const int h = min(*h_ptr, R - 1);
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j < M) ah[j] = Tt[(size_t)j * R + h];
}

__global__ void empty_kernel() {}

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

// us a call of fn(stream) over a CUDA graph of 50 calls, replayed 4 times.
float graph_us(const std::function<void(cudaStream_t)> &fn) {
    cudaStream_t s;
    cudaStreamCreate(&s);
    fn(s);
    cudaStreamSynchronize(s);
    cudaGraph_t g;
    cudaGraphExec_t ge;
    cudaStreamBeginCapture(s, cudaStreamCaptureModeGlobal);
    for (int i = 0; i < 50; ++i) fn(s);
    cudaStreamEndCapture(s, &g);
    cudaGraphInstantiate(&ge, g, 0);
    cudaGraphLaunch(ge, s);
    cudaEvent_t a, e;
    cudaEventCreate(&a);
    cudaEventCreate(&e);
    cudaEventRecord(a, s);
    for (int r = 0; r < 4; ++r) cudaGraphLaunch(ge, s);
    cudaEventRecord(e, s);
    cudaEventSynchronize(e);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, a, e);
    cudaGraphExecDestroy(ge);
    cudaGraphDestroy(g);
    cudaStreamDestroy(s);
    return 1e3f * ms / 200;
}

// One K1 run's outputs: a_h, then k, p, bk, unb.
struct K1Out {
    float *ah;
    int *k, *unb;
    float *p;
    double *bk;
};

K1Out k1_out(int M) {
    K1Out o;
    cudaMalloc(&o.ah, M * 4);
    cudaMalloc(&o.k, 4);
    cudaMalloc(&o.unb, 4);
    cudaMalloc(&o.p, 4);
    cudaMalloc(&o.bk, 8);
    return o;
}

bool k1_same(const K1Out &a, const K1Out &b, int M) {
    return differ(a.ah, b.ah, M * 4) == 0 && differ(a.k, b.k, 4) == 0 &&
           differ(a.unb, b.unb, 4) == 0 && differ(a.p, b.p, 4) == 0 &&
           differ(a.bk, b.bk, 8) == 0;
}

int k1_bench() {
    const int M = 8192, R = 24576, L = 128, nb_old = M / THREADS;
    const float eps = 1e-4f;
    float *Tt, *F, *C;
    double *b, *part_key;
    int *h, *part_idx;
    unsigned char *ws;
    cudaMalloc(&Tt, (size_t)M * R * 4);
    cudaMalloc(&F, (size_t)L * M * 4);
    cudaMalloc(&C, (size_t)L * R * 4);
    cudaMalloc(&b, M * 8);
    cudaMalloc(&h, 4);
    cudaMalloc(&part_key, nb_old * 8);
    cudaMalloc(&part_idx, nb_old * 4);
    const size_t ws_n = ahr_ws_bytes(M / 32);    // room for every variant
    cudaMalloc(&ws, ws_n);
    cudaMemset(ws, 0, ws_n);
    fill<<<1024, 256>>>(Tt, (size_t)M * R, 1, -1, 1);
    fill<<<1024, 256>>>(F, (size_t)L * M, 2, -0.1f, 0.1f);
    fill<<<1024, 256>>>(C, (size_t)L * R, 3, -1, 1);
    fill64<<<64, 256>>>(b, M, 4, 0.0, 100.0);
    const int h_host = 12345;
    cudaMemcpy(h, &h_host, 4, cudaMemcpyHostToDevice);
    const K1Out o_old = k1_out(M), o_new = k1_out(M), o_var = k1_out(M);

    const char *names[] = {"old", "shipped", "first", "fence", "nocarry",
                           "cols 32", "cols 128", "batch", "nofold",
                           "column", "empty"};
    const int NV = sizeof(names) / sizeof(names[0]);
    constexpr int SHIPPED = FOLD | ACQREL | CARRY;
    for (int t : {0, 37, 127}) {
        auto run = [&](int v, const K1Out &o, cudaStream_t s) {
#define K1V(COLS, ROWS, MODE)                                              \
    k1_cols<COLS, ROWS, MODE><<<M / COLS, THREADS, 0, s>>>(                \
        Tt, F, C, b, h, t, M, R, eps, M / COLS, o.ah, ws, o.k, o.p, o.bk, \
        o.unb)
            switch (v) {
            case 0:
                old_tiles<<<nb_old, THREADS, t * sizeof(float), s>>>(
                    Tt, F, C, b, h, t, M, R, eps, o.ah, part_key, part_idx);
                old_finish<<<1, THREADS, 0, s>>>(part_key, part_idx, nb_old,
                                                 o.ah, b, o.k, o.p, o.bk,
                                                 o.unb);
                break;
            case 1:
                ah_ratio_launch(Tt, F, C, b, h, t, M, R, eps, o.ah, ws,
                                (long long)ws_n, o.k, o.p, o.bk, o.unb, s);
                break;
            case 2: K1V(64, 128, FOLD); break;
            case 3: K1V(64, 128, FOLD | CARRY); break;
            case 4: K1V(64, 128, FOLD | ACQREL); break;
            case 5: K1V(32, 128, SHIPPED); break;
            case 6: K1V(128, 64, SHIPPED); break;
            case 7: K1V(64, 128, SHIPPED | BATCH); break;
            case 8: K1V(64, 128, 0); break;
            case 9:
                column_only<<<M / THREADS, THREADS, 0, s>>>(Tt, h, M, R,
                                                             o.ah);
                break;
            default:
                empty_kernel<<<1, 32, 0, s>>>();
            }
#undef K1V
        };
        // Bit for bit: the shipped kernel and the cols variants against the
        // old kernel, each called twice on the one workspace.
        run(0, o_old, 0);
        for (int v = 1; v < 8; ++v) {
            for (int rep = 0; rep < 2; ++rep) {
                run(v, o_new, 0);
                const bool same = k1_same(o_new, o_old, M);
                printf("K1 t=%d %-8s call %d: a_h, k, p, bk, flag %s the old "
                       "kernel's (%s)\n", t, names[v], rep + 1,
                       same ? "equal to" : "DIFFER FROM",
                       cudaGetErrorString(cudaGetLastError()));
                if (!same) return 1;
            }
        }
        for (int round = 0; round < 3; ++round)
            for (int v = 0; v < NV; ++v)
                printf("K1 t=%d round %d %-8s %.3f us\n", t, round, names[v],
                       graph_us([&](cudaStream_t s) { run(v, o_var, s); }));
    }
    return cudaGetLastError() == cudaSuccess ? 0 : 1;
}

int k5_bench() {
    const int M = 8192, R = 24576, L = 136;
    const float eps = 1e-4f;
    float *Tt, *F, *C, *a_old, *a_new;
    double *b;
    int *h;
    unsigned char *ws;
    cudaMalloc(&Tt, (size_t)M * R * 4);
    cudaMalloc(&F, (size_t)L * M * 4);
    cudaMalloc(&C, (size_t)L * R * 4);
    cudaMalloc(&b, M * 8);
    cudaMalloc(&h, 4);
    cudaMalloc(&a_old, M * 4);
    cudaMalloc(&a_new, M * 4);
    const size_t ws_n = ahr_ws_bytes(M / AHR_COLS);
    cudaMalloc(&ws, ws_n);
    cudaMemset(ws, 0, ws_n);
    fill<<<1024, 256>>>(Tt, (size_t)M * R, 21, -1, 1);
    fill<<<1024, 256>>>(F, (size_t)L * M, 22, -0.1f, 0.1f);
    fill<<<1024, 256>>>(C, (size_t)L * R, 23, -1, 1);
    fill64<<<64, 256>>>(b, M, 24, 0.0, 100.0);
    const int h_host = 12345;
    cudaMemcpy(h, &h_host, 4, cudaMemcpyHostToDevice);
    const K1Out o = k1_out(M);
    const char *names[] = {"old", "shipped", "K1", "t128", "t64"};
    for (int t : {0, 37, 127, 129}) {
        auto run = [&](int v, cudaStream_t s) {
            if (v == 0)
                old_ah_tiles<<<M / THREADS, THREADS, t * sizeof(float), s>>>(
                    Tt, F, C, h, t, M, R, a_old);
            else if (v == 1)
                ah_launch(Tt, F, C, h, nullptr, t, M, R, a_new, s);
            else if (v == 2)
                ah_ratio_launch(Tt, F, C, b, h, t, M, R, eps, o.ah, ws,
                                (long long)ws_n, o.k, o.p, o.bk, o.unb, s);
            else if (v == 3)
                ah_ratio_fused<false, 128><<<M / AHR_COLS, 128, 0, s>>>(
                    Tt, F, C, nullptr, h, nullptr, t, M, R, 0.0f,
                    M / AHR_COLS, o.ah, nullptr, nullptr, nullptr, nullptr,
                    nullptr);
            else
                ah_ratio_fused<false, 64><<<M / AHR_COLS, 64, 0, s>>>(
                    Tt, F, C, nullptr, h, nullptr, t, M, R, 0.0f,
                    M / AHR_COLS, o.ah, nullptr, nullptr, nullptr, nullptr,
                    nullptr);
        };
        for (int v = 0; v < 3; ++v) run(v, 0);
        const unsigned long long d_old = differ(a_new, a_old, M * 4);
        const unsigned long long d_k1 = differ(a_new, o.ah, M * 4);
        printf("K5 t=%d shipped: a_h words differing from the old kernel's "
               "%llu, from K1's %llu (%s)\n", t, d_old, d_k1,
               cudaGetErrorString(cudaGetLastError()));
        if (d_old != 0 || d_k1 != 0) return 1;
        for (int v = 3; v < 5; ++v) {
            run(v, 0);
            const unsigned long long d = differ(o.ah, a_new, M * 4);
            printf("K5 t=%d %s: a_h words differing from shipped %llu\n", t,
                   names[v], d);
            if (d != 0) return 1;
        }
        if (t > 127) continue;
        for (int round = 0; round < 3; ++round)
            for (int v = 0; v < 5; ++v)
                printf("K5 t=%d round %d %-8s %.3f us\n", t, round, names[v],
                       graph_us([&](cudaStream_t s) { run(v, s); }));
    }
    cudaFree(Tt); cudaFree(F); cudaFree(C); cudaFree(b); cudaFree(h);
    cudaFree(a_old); cudaFree(a_new); cudaFree(ws);
    return cudaGetLastError() == cudaSuccess ? 0 : 1;
}

int k3_bench() {
    const int shapes[][3] = {{8192, 24576, 128}, {256, 384, 8},
                             {1024, 2944, 136}};
    for (auto &sh : shapes) {
        const int M = sh[0], R = sh[1], L = sh[2];
        const size_t n = (size_t)M * R;
        float *T0, *T, *Tr, *F, *C;
        double *coeffs, *part, *mv_old, *mv_new;
        cudaMalloc(&T0, n * 4);
        cudaMalloc(&T, n * 4);
        cudaMalloc(&Tr, n * 4);
        cudaMalloc(&F, (size_t)L * M * 4);
        cudaMalloc(&C, (size_t)L * R * 4);
        cudaMalloc(&coeffs, M * 8);
        cudaMalloc(&part, (size_t)(M / AT) * R * 8);
        cudaMalloc(&mv_old, R * 8);
        cudaMalloc(&mv_new, R * 8);
        fill<<<1024, 256>>>(T0, n, 5, -1, 1);
        fill<<<1024, 256>>>(F, (size_t)L * M, 6, -0.1f, 0.1f);
        fill<<<1024, 256>>>(C, (size_t)L * R, 7, -1, 1);
        fill64<<<64, 256>>>(coeffs, M, 8, -10.0, 10.0);
        auto old_k3 = [&](float *X, double *mv) {
            apply_tiles<true><<<dim3(R / AT, M / AT), APPLY_THREADS>>>(
                X, F, C, M, R, L, coeffs, part);
            reprice_finish<<<(R + THREADS - 1) / THREADS, THREADS>>>(
                part, M / AT, R, mv);
        };
        cudaMemcpy(Tr, T0, n * 4, cudaMemcpyDeviceToDevice);
        old_k3(Tr, mv_old);
        cudaMemcpy(T, T0, n * 4, cudaMemcpyDeviceToDevice);
        const int err = apply_reprice_launch(T, F, C, M, R, L, coeffs, part,
                                             mv_new, nullptr);
        const unsigned long long dT = differ(T, Tr, n * 4);
        const unsigned long long dmv = differ(mv_new, mv_old, (size_t)R * 8);
        printf("K3 M=%d R=%d L=%d shipped: Tt words differing from the old "
               "tile's %llu, mv words %llu (launch %d, %s)\n", M, R, L, dT,
               dmv, err, cudaGetErrorString(cudaGetLastError()));
        if (dT != 0 || dmv != 0 || err != 0) return 1;
        if (M == 8192) {
            const char *names[] = {"old K3", "shipped K3", "K4"};
            cudaEvent_t a, e;
            cudaEventCreate(&a);
            cudaEventCreate(&e);
            for (int round = 0; round < 3; ++round)
                for (int v = 0; v < 3; ++v) {
                    auto call = [&]() {
                        if (v == 0)
                            old_k3(T, mv_old);
                        else if (v == 1)
                            apply_reprice_launch(T, F, C, M, R, L, coeffs,
                                                 part, mv_new, nullptr);
                        else
                            apply_window_launch(T, F, C, M, R, L, nullptr);
                    };
                    call();
                    cudaEventRecord(a);
                    for (int i = 0; i < 10; ++i) call();
                    cudaEventRecord(e);
                    cudaEventSynchronize(e);
                    float ms = 0.0f;
                    cudaEventElapsedTime(&ms, a, e);
                    printf("K3 round %d %-10s %.4f ms\n", round, names[v],
                           ms / 10);
                }
        }
        cudaFree(T0); cudaFree(T); cudaFree(Tr); cudaFree(F); cudaFree(C);
        cudaFree(coeffs); cudaFree(part); cudaFree(mv_old); cudaFree(mv_new);
    }
    return cudaGetLastError() == cudaSuccess ? 0 : 1;
}

}  // namespace

int main() {
    cudaMalloc(&CNT, 8);
    if (k1_bench() != 0) return 1;
    if (k5_bench() != 0) return 1;
    return k3_bench();
}
