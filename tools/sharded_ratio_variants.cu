// sharded_ratio (csrc/sharded_step.cu, the sharded loop's ratio test on
// the summed column and the scalar step after it) on the card, several
// ways, every output checked bit for bit against the others and against
// the host's argmin:
//
//   one-block  a verbatim copy of the kernel it replaced: one block of
//              1,024 threads, each scanning a strided share of the column
//              one quotient after the other, a ten-level shared-memory
//              tree, then thread 0's loads of a_h[k], b[k], base[k] and
//              the scalars one behind the other;
//   cNBxNT     the shipped kernel's template (included from the source)
//              as one cluster of NB blocks of NT threads: every load of a
//              thread issued before any is waited for, warp shuffles, the
//              blocks' results into block 0's shared memory, one cluster
//              barrier (c16x256, each thread loading 4 of its
//              constraints at once, is what the port launches; c16x256p16
//              loads 16 at once);
//   k1-formN   K1's form (csrc/blocked.cu ah_ratio_fused without its
//              column): M / N blocks of N threads, one constraint a
//              thread, each block's partial into a workspace, an
//              acquire-release arrival ticket, and the last block folding
//              the partials.
//
// Build and run on a machine with an H100:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/sharded_ratio_variants tools/sharded_ratio_variants.cu \
//        && /tmp/sharded_ratio_variants
//
// States: M = 8,192 (the sharded flagship), 10,112 (the north star's
// M_pad) and 40,064 (bit for bit only), a_h uniform in (-1, 1) and b in (0, 10), with a NaN b on two
// eligible rows, equal smallest quotients on three rows 2,048 apart, or no
// eligible row in every fourth; eps 1e-4, the pivot active and not
// optimal. Times: us a call by CUDA events around 20 replays of a CUDA
// graph of 50 calls, in turns (each variant, then back), three rounds.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#include "../simplex_tpu_torch/kernels/csrc/sharded_step.cu"

#define CK(x)                                                            \
    do {                                                                 \
        cudaError_t e_ = (x);                                            \
        if (e_ != cudaSuccess) {                                         \
            std::printf("CUDA error %s at %s:%d\n", cudaGetErrorString(e_), \
                        __FILE__, __LINE__);                             \
            std::exit(1);                                                \
        }                                                                \
    } while (0)

namespace old_ratio {

constexpr int RATIO_THREADS = 1024;

// The one-block kernel, verbatim but for the leaving variable, which it
// wrote through the scalars' own field.
__global__ void __launch_bounds__(RATIO_THREADS) kernel(
        ShardStep s, int *lvar, const float *__restrict__ ah,
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
    if (any) sany = 1;
    for (int half = RATIO_THREADS / 2; half > 0; half >>= 1) {
        if (tid < half && ratio_first(sq[tid + half], si[tid + half],
                                      sq[tid], si[tid])) {
            sq[tid] = sq[tid + half];
            si[tid] = si[tid + half];
        }
        __syncthreads();
    }
    if (tid != 0) return;
    const int k = si[0];
    const bool unb = sany == 0;
    const bool d = *s.active != 0 && !(*s.optimal != 0 || unb);
    const float p = d ? ah[k] : 1.0f;
    *s.k = k;
    *s.unb = unb;
    *s.do_ = d;
    *s.p = p;
    *s.bk = b[k];
    *s.u = d ? __ddiv_rn(*s.minc, (double)p) : 0.0;
    *lvar = base[k];
}

}  // namespace old_ratio

namespace k1_form {

__device__ __forceinline__ unsigned ticket(unsigned *counter) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    return old;
}

// COLS constraints a block, one a thread. The workspace: [0, 8) the
// counter, then nb partials (Ratio) and nb eligibility flags.
template <int COLS>
__global__ void __launch_bounds__(COLS) kernel(
        ShardStep s, const float *__restrict__ ah,
        const double *__restrict__ b, int M, float eps,
        unsigned char *ws, int nb) {
    __shared__ Ratio part[COLS / 32];
    __shared__ int pany[COLS / 32];
    __shared__ bool last;
    unsigned *counter = reinterpret_cast<unsigned *>(ws);
    Ratio *parts = reinterpret_cast<Ratio *>(ws + 8);
    int *anys = reinterpret_cast<int *>(parts + nb);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int j = blockIdx.x * COLS + tid;
    Ratio x{CUDART_INF, BIG_INDEX, 0.0f, 0.0};
    bool any = false;
    if (j < M) {
        const float a = ah[j];
        const double bj = b[j];
        const bool mask = a >= eps;
        any = mask;
        x = Ratio{mask ? __ddiv_rn(bj, (double)a) : CUDART_INF, j, a, bj};
    }
    any = __any_sync(FULL, any);
    for (int off = 16; off > 0; off >>= 1) take_first(x, shfl_xor(x, off));
    if (lane == 0) {
        part[warp] = x;
        pany[warp] = any;
    }
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < COLS / 32; ++w) take_first(x, part[w]);
        for (int w = 1; w < COLS / 32; ++w) any |= pany[w] != 0;
        parts[blockIdx.x] = x;
        anys[blockIdx.x] = any;
        last = ticket(counter) == (unsigned)nb - 1;
    }
    __syncthreads();
    if (!last) return;
    bool active = false, optimal = false;
    double minc = 0.0;
    if (tid == 0) {
        active = *s.active != 0;
        optimal = *s.optimal != 0;
        minc = *s.minc;
    }
    x = Ratio{CUDART_INF, BIG_INDEX, 0.0f, 0.0};
    any = false;
    for (int i = tid; i < nb; i += COLS) {
        Ratio o;
        o.q = __ldcg(&parts[i].q);
        o.j = __ldcg(&parts[i].j);
        o.a = __ldcg(&parts[i].a);
        o.b = __ldcg(&parts[i].b);
        take_first(x, o);
        any |= __ldcg(anys + i) != 0;
    }
    any = __any_sync(FULL, any);
    for (int off = 16; off > 0; off >>= 1) take_first(x, shfl_xor(x, off));
    if (lane == 0) {
        part[warp] = x;
        pany[warp] = any;
    }
    __syncthreads();
    if (tid != 0) return;
    for (int w = 1; w < COLS / 32; ++w) take_first(x, part[w]);
    for (int w = 1; w < COLS / 32; ++w) any |= pany[w] != 0;
    const bool unb = !any;
    const bool d = active && !(optimal || unb);
    const float p = d ? x.a : 1.0f;
    *s.k = x.j;
    *s.unb = unb;
    *s.do_ = d;
    *s.p = p;
    *s.bk = x.b;
    *s.u = d ? __ddiv_rn(minc, (double)p) : 0.0;
    *counter = 0;
}

}  // namespace k1_form

// Device scalars: one 8-byte slot a field.
struct Scalars {
    ShardStep s;
    unsigned char *mem;
    Scalars() {
        CK(cudaMalloc(&mem, 8 * 32));
        CK(cudaMemset(mem, 0, 8 * 32));
        void **f = reinterpret_cast<void **>(&s);
        for (size_t i = 0; i < sizeof(ShardStep) / sizeof(void *); ++i)
            f[i] = mem + 8 * i;
    }
    void reset() {
        CK(cudaMemset(mem, 0, 8 * 32));
        const unsigned char one = 1;
        const double minc = -0.5;
        CK(cudaMemcpy(s.active, &one, 1, cudaMemcpyHostToDevice));
        CK(cudaMemcpy(s.minc, &minc, 8, cudaMemcpyHostToDevice));
    }
    // k, unb, do, p, bk, u as bytes.
    std::vector<unsigned char> outputs() const {
        std::vector<unsigned char> out(8 * 6);
        CK(cudaMemcpy(out.data(), s.k, 4, cudaMemcpyDeviceToHost));
        CK(cudaMemcpy(out.data() + 8, s.unb, 4, cudaMemcpyDeviceToHost));
        CK(cudaMemcpy(out.data() + 16, s.do_, 1, cudaMemcpyDeviceToHost));
        CK(cudaMemcpy(out.data() + 24, s.p, 4, cudaMemcpyDeviceToHost));
        CK(cudaMemcpy(out.data() + 32, s.bk, 8, cudaMemcpyDeviceToHost));
        CK(cudaMemcpy(out.data() + 40, s.u, 8, cudaMemcpyDeviceToHost));
        return out;
    }
};

int main() {
    int dev = 0;
    cudaDeviceProp prop;
    CK(cudaGetDeviceProperties(&prop, dev));
    std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
    const int Mmax = 40064;
    float *ah;
    double *b;
    int *base, *lvar;
    unsigned char *ws;
    CK(cudaMalloc(&ah, Mmax * sizeof(float)));
    CK(cudaMalloc(&b, Mmax * sizeof(double)));
    CK(cudaMalloc(&base, Mmax * sizeof(int)));
    CK(cudaMalloc(&lvar, sizeof(int)));
    const int nb_max = Mmax / 64;
    CK(cudaMalloc(&ws, 8 + nb_max * (sizeof(Ratio) + sizeof(int))));
    CK(cudaMemset(ws, 0, 8 + nb_max * (sizeof(Ratio) + sizeof(int))));
    cudaStream_t st;
    CK(cudaStreamCreate(&st));
    const float eps = 1e-4f;
    struct Variant {
        const char *name;
        int (*launch)(const ShardStep &, const float *, const double *, int,
                      float, cudaStream_t);
    };
    // The old kernel and K1's form through the same signature.
    static int *g_lvar, *g_base;
    static unsigned char *g_ws;
    g_lvar = lvar;
    g_base = base;
    g_ws = ws;
    auto old_launch = [](const ShardStep &s, const float *ah, const double *b,
                         int M, float eps, cudaStream_t st) {
        old_ratio::kernel<<<1, old_ratio::RATIO_THREADS, 0, st>>>(
            s, g_lvar, ah, b, g_base, M, eps);
        return (int)cudaGetLastError();
    };
    auto k1_64 = [](const ShardStep &s, const float *ah, const double *b,
                    int M, float eps, cudaStream_t st) {
        k1_form::kernel<64><<<M / 64, 64, 0, st>>>(s, ah, b, M, eps, g_ws,
                                                   M / 64);
        return (int)cudaGetLastError();
    };
    auto k1_128 = [](const ShardStep &s, const float *ah, const double *b,
                     int M, float eps, cudaStream_t st) {
        k1_form::kernel<128><<<M / 128, 128, 0, st>>>(s, ah, b, M, eps,
                                                      g_ws, M / 128);
        return (int)cudaGetLastError();
    };
    const std::vector<Variant> vars = {
        {"one-block", old_launch},
        {"c8x1024", launch_ratio<8, 1024, 8>},
        {"c8x512", launch_ratio<8, 512, 4>},
        {"c8x256", launch_ratio<8, 256, 8>},
        {"c4x1024", launch_ratio<4, 1024, 4>},
        {"c16x256", launch_ratio<16, 256, 4>},
        {"c16x256p16", launch_ratio<16, 256, 16>},
        {"c16x512", launch_ratio<16, 512, 2>},
        {"c16x1024", launch_ratio<16, 1024, 1>},
        {"k1-form64", k1_64},
        {"k1-form128", k1_128},
    };
    const int nv = (int)vars.size();
    std::vector<Scalars> sc(nv);
    // A variant the card refuses (a cluster too large) is reported and
    // left out.
    std::vector<bool> ok(nv, true);
    auto launch = [&](int v, int M) {
        const int e = vars[v].launch(sc[v].s, ah, b, M, eps, st);
        if (e != 0 && ok[v]) {
            std::printf("%s refused: %s\n", vars[v].name,
                        cudaGetErrorString((cudaError_t)e));
            ok[v] = false;
        }
        return e == 0;
    };

    // Bit for bit on the seeded states.
    std::mt19937_64 rng(20261018);
    std::uniform_real_distribution<double> U(0.0, 1.0);
    int states = 0, bad = 0;
    for (int M : {8192, 10112, 40064}) {
        for (int i = 0; i < 64; ++i, ++states) {
            std::vector<float> a(M);
            std::vector<double> bh(M);
            std::vector<int> bs(M);
            for (int j = 0; j < M; ++j) {
                a[j] = (float)(2 * U(rng) - 1);
                bh[j] = 10 * U(rng);
                bs[j] = (int)(U(rng) * 24576);
            }
            const int edge = i % 4 == 3 ? i / 4 % 3 : -1;
            if (edge == 0) {                     // a NaN b, eligible rows
                for (int r = 0; r < 2; ++r) {
                    const int j = (int)(U(rng) * M);
                    a[j] = 0.5f;
                    bh[j] = std::nan("");
                }
            } else if (edge == 1) {              // a tie, rows 2,048 apart
                const int j = (int)(U(rng) * (M - 4096));
                a[j] = a[j + 2048] = a[j + 4096] = 4.0f;
                bh[j] = bh[j + 2048] = bh[j + 4096] = 1e-9;
            } else if (edge == 2) {              // no eligible row
                for (auto &x : a) x = -std::fabs(x);
            }
            // The host's argmin in torch.argmin's order (csrc's
            // ratio_first: NaN first, then the smaller, then the lower row).
            auto first = [](double q, int j, double q2, int j2) {
                const bool n = q != q, n2 = q2 != q2;
                if (n != n2) return n;
                if (!n && q != q2) return q < q2;
                return j < j2;
            };
            int k = 0;
            bool any = false;
            double qk = 0.0;
            for (int j = 0; j < M; ++j) {
                const bool m = a[j] >= eps;
                any |= m;
                const double q = m ? bh[j] / (double)a[j] : INFINITY;
                if (j == 0 || first(q, j, qk, k)) {
                    qk = q;
                    k = j;
                }
            }
            CK(cudaMemcpy(ah, a.data(), M * 4, cudaMemcpyHostToDevice));
            CK(cudaMemcpy(b, bh.data(), M * 8, cudaMemcpyHostToDevice));
            CK(cudaMemcpy(base, bs.data(), M * 4, cudaMemcpyHostToDevice));
            std::vector<std::vector<unsigned char>> out(nv);
            bool same = true;
            for (int v = 0; v < nv; ++v) {
                if (!ok[v]) continue;
                sc[v].reset();
                if (!launch(v, M)) continue;
                CK(cudaStreamSynchronize(st));
                out[v] = sc[v].outputs();
                same &= out[v] == out[0];
            }
            int kk;
            std::memcpy(&kk, out[1].data(), 4);
            same &= kk == k && (out[1][8] != 0) == !any;
            if (!same) {
                ++bad;
                std::printf("MISMATCH M=%d state %d edge %d: host k %d, "
                            "cluster k %d\n", M, i, edge, k, kk);
            }
        }
    }
    std::printf("bit for bit: %d of %d states differ (k, unb, do, p, bk, "
                "u of the %d variants against each other and k, unb "
                "against the host)\n", bad, states, nv);

    // Times, in turns, at each M.
    for (int M : {8192, 10112}) {
        std::vector<cudaGraphExec_t> exec(nv);
        for (int v = 0; v < nv; ++v) {
            if (!ok[v]) continue;
            sc[v].reset();
            cudaGraph_t g;
            CK(cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal));
            for (int c = 0; c < 50; ++c) launch(v, M);
            CK(cudaStreamEndCapture(st, &g));
            CK(cudaGraphInstantiate(&exec[v], g, 0));
            CK(cudaGraphDestroy(g));
            CK(cudaGraphLaunch(exec[v], st));
        }
        CK(cudaStreamSynchronize(st));
        cudaEvent_t e0, e1;
        CK(cudaEventCreate(&e0));
        CK(cudaEventCreate(&e1));
        std::vector<std::vector<double>> us(nv);
        std::vector<int> order;
        for (int v = 0; v < nv; ++v) order.push_back(v);
        for (int v = nv - 1; v >= 0; --v) order.push_back(v);
        for (int round = 0; round < 3; ++round) {
            for (int v : order) {
                if (!ok[v]) continue;
                CK(cudaEventRecord(e0, st));
                for (int r = 0; r < 20; ++r) CK(cudaGraphLaunch(exec[v], st));
                CK(cudaEventRecord(e1, st));
                CK(cudaEventSynchronize(e1));
                float ms;
                CK(cudaEventElapsedTime(&ms, e0, e1));
                us[v].push_back(1e3 * ms / (20 * 50));
            }
        }
        for (int v = 0; v < nv; ++v) {
            if (!ok[v]) continue;
            std::printf("M=%d %-10s us a call:", M, vars[v].name);
            for (double x : us[v]) std::printf(" %.3f", x);
            std::printf("\n");
            CK(cudaGraphExecDestroy(exec[v]));
        }
    }
    return bad != 0;
}
