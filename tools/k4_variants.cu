// K4 (the window apply Tt -= F^T C) on the card: the shipped kernel
// (csrc/blocked.cu window_apply) beside the tile it replaced and the design
// variants it was chosen from, each checked bit for bit against the old
// tile and timed with CUDA events at the flagship shape (M=8192, R=24576,
// L=128), three rounds in turns. Build and run on a machine with an H100:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/k4_variants tools/k4_variants.cu && /tmp/k4_variants
//
// The variants differ only in how the same per-element arithmetic (fmaf
// over s in order from 0, then one __fsub_rn) is scheduled:
//   grid      the old tile (apply_tile.cuh, one 128 x 128 tile a block);
//   A         persistent, 1 block/SM, 6 stages of 8 rows, stage offsets by
//             division (this PR's first try);
//   B rN SS   persistent, 2 blocks/SM, N-row stages, S stages, offsets by
//             addition, warps of 2 x 16 threads;
//   E rN SS   as B with warps of 4 x 8 threads (the shipped layout; the
//             shipped kernel also walks odd rows' columns backwards);
//   C         128 threads a tile, each 8 x 16 outputs;
//   nomem     E r8 S4 copying only its first four stages and computing
//             on them from then on (wrong values; the loop's own
//             ceiling, FFMAs in order).

#include <cstdio>

#include "../simplex_tpu_torch/kernels/csrc/blocked.cu"

namespace {

// A: the first persistent design, stage offsets by division.
__global__ void __launch_bounds__(APPLY_THREADS, 1) variant_a(
        float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, int M, int R, int L) {
    constexpr int S = 6, SF = 2 * AK * AT;
    extern __shared__ __align__(16) float sm[];
    float *Ts = sm, *ring = sm + AT * AT;
    const int n_rt = R / AT, n_tiles = (M / AT) * n_rt, nk = L / AK;
    const int tile0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
    const int tile1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
    const int G = (tile1 - tile0) * nk, tid = threadIdx.x;
    auto load = [&](int g) {
        if (g < G) {
            const int tile = tile0 + g / nk, s = (g % nk) * AK + (tid >> 5);
            const int col = (tid & 31) * 4;
            float *st = ring + (g % S) * SF;
            cp_async16(st + (tid >> 5) * AT + col,
                       F + (size_t)s * M + (size_t)(tile / n_rt) * AT + col);
            cp_async16(st + AK * AT + (tid >> 5) * AT + col,
                       C + (size_t)s * R + (size_t)(tile % n_rt) * AT + col);
        }
        cp_async_commit();
    };
    for (int g = 0; g < S - 1; ++g) load(g);
    const int tx = tid & 15, ty = tid >> 4;
    float acc[8][8] = {};
    for (int g = 0; g < G; ++g) {
        const int kk = g % nk, tile = tile0 + g / nk;
        const size_t i0 = (size_t)(tile / n_rt) * AT, j0 = (size_t)(tile % n_rt) * AT;
        cp_async_wait<S - 2>();
        __syncthreads();
        if (kk == 0)
            for (int q = 0; q < AT * AT / 4 / APPLY_THREADS; ++q) {
                const int c = tid + q * APPLY_THREADS;
                cp_async16(Ts + (c >> 5) * AT + (c & 31) * 4,
                           Tt + (i0 + (c >> 5)) * (size_t)R + j0 + (c & 31) * 4);
            }
        load(g + S - 1);
        const float *Fs = ring + (g % S) * SF, *Cs = Fs + AK * AT;
#pragma unroll
        for (int s = 0; s < AK; ++s) {
            float fa[8], cb[8];
            *reinterpret_cast<float4 *>(&fa[0]) = *reinterpret_cast<const float4 *>(&Fs[s * AT + ty * 8]);
            *reinterpret_cast<float4 *>(&fa[4]) = *reinterpret_cast<const float4 *>(&Fs[s * AT + ty * 8 + 4]);
            *reinterpret_cast<float4 *>(&cb[0]) = *reinterpret_cast<const float4 *>(&Cs[s * AT + tx * 4]);
            *reinterpret_cast<float4 *>(&cb[4]) = *reinterpret_cast<const float4 *>(&Cs[s * AT + 64 + tx * 4]);
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(fa[a], cb[c], acc[a][c]);
        }
        if (kk == nk - 1) {
            if (nk < S) cp_async_wait<0>();
            __syncthreads();
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = ty * 8 + a, col = h * 64 + tx * 4;
                    float4 v = *reinterpret_cast<const float4 *>(&Ts[row * AT + col]);
                    v.x = __fsub_rn(v.x, acc[a][h * 4]);
                    v.y = __fsub_rn(v.y, acc[a][h * 4 + 1]);
                    v.z = __fsub_rn(v.z, acc[a][h * 4 + 2]);
                    v.w = __fsub_rn(v.w, acc[a][h * 4 + 3]);
                    *reinterpret_cast<float4 *>(Tt + (i0 + row) * (size_t)R + j0 + col) = v;
                    for (int c = 0; c < 4; ++c) acc[a][h * 4 + c] = 0.0f;
                }
        }
    }
    cp_async_wait<0>();
}

// B / E / C / nomem: TH threads a 128 x 128 tile, each RT rows x CT
// columns (CT / 4 groups of 4), ROWS-row stages, S stages, offsets by
// addition. WARP4x8 puts a warp on 32 rows x 64 columns (TH = 256, CT = 8).
template <int TH, int CT, int ROWS, int S, int MINB, bool WARP4x8, bool NOMEM>
__global__ void __launch_bounds__(TH, MINB) variant(
        float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, int M, int R, int L) {
    constexpr int SF = 2 * ROWS * AT, NCH = SF / 4 / TH;
    constexpr int NG = CT / 4, GAP = WARP4x8 ? 32 : AT / NG;
    extern __shared__ __align__(16) float sm[];
    float *Ts = sm, *ring = sm + AT * AT;
    const int n_rt = R / AT, n_tiles = (M / AT) * n_rt, nk = L / ROWS;
    const int tile0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
    const int tile1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
    const int G = (tile1 - tile0) * nk, tid = threadIdx.x;
    int lg = 0, ls0 = 0;
    size_t li0 = (size_t)(tile0 / n_rt) * AT, lj0 = (size_t)(tile0 % n_rt) * AT;
    auto load = [&]() {
        if (lg < G && (!NOMEM || lg < S)) {      // nomem: the first ring only
            float *st = ring + (lg % S) * SF;
#pragma unroll
            for (int q = 0; q < NCH; ++q) {
                const int c = tid + q * TH;
                const bool isC = c >= ROWS * 32;
                const int cc = isC ? c - ROWS * 32 : c;
                const int row = cc >> 5, col = (cc & 31) * 4;
                cp_async16(st + c * 4, isC ? C + (size_t)(ls0 + row) * R + lj0 + col
                                           : F + (size_t)(ls0 + row) * M + li0 + col);
            }
            ls0 += ROWS;
            if (ls0 == L) {
                ls0 = 0;
                lj0 += AT;
                if (lj0 == (size_t)R) { lj0 = 0; li0 += AT; }
            }
        }
        ++lg;
        cp_async_commit();
    };
    for (int g = 0; g < S - 1; ++g) load();
    int r0, c0;
    if (WARP4x8) {
        r0 = (tid >> 6) * 32 + ((tid & 31) >> 3) * 8;
        c0 = ((tid >> 5) & 1) * 64 + (tid & 7) * 4;
    } else {
        constexpr int NX = AT / CT;               // threads across a row
        r0 = (tid / NX) * 8;
        c0 = (tid % NX) * 4;
    }
    float acc[8][CT] = {};
    int kk = 0;
    size_t i0 = (size_t)(tile0 / n_rt) * AT, j0 = (size_t)(tile0 % n_rt) * AT;
    for (int g = 0; g < G; ++g) {
        cp_async_wait<S - 2>();
        __syncthreads();
        if (kk == 0)
            for (int q = 0; q < AT * AT / 4 / TH; ++q) {
                const int c = tid + q * TH;
                cp_async16(Ts + (c >> 5) * AT + (c & 31) * 4,
                           Tt + (i0 + (c >> 5)) * (size_t)R + j0 + (c & 31) * 4);
            }
        load();
        const float *Fs = ring + (g % S) * SF, *Cs = Fs + ROWS * AT;
#pragma unroll
        for (int s = 0; s < ROWS; ++s) {
            float fa[8], cb[CT];
            *reinterpret_cast<float4 *>(&fa[0]) = *reinterpret_cast<const float4 *>(&Fs[s * AT + r0]);
            *reinterpret_cast<float4 *>(&fa[4]) = *reinterpret_cast<const float4 *>(&Fs[s * AT + r0 + 4]);
#pragma unroll
            for (int q = 0; q < NG; ++q)
                *reinterpret_cast<float4 *>(&cb[4 * q]) = *reinterpret_cast<const float4 *>(&Cs[s * AT + c0 + q * GAP]);
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int c = 0; c < CT; ++c) acc[a][c] = fmaf(fa[a], cb[c], acc[a][c]);
        }
        if (++kk == nk) {
            kk = 0;
            if (nk < S) cp_async_wait<0>();
            __syncthreads();
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int q = 0; q < NG; ++q) {
                    const int row = r0 + a, col = c0 + q * GAP;
                    float4 v = *reinterpret_cast<const float4 *>(&Ts[row * AT + col]);
                    v.x = __fsub_rn(v.x, acc[a][q * 4]);
                    v.y = __fsub_rn(v.y, acc[a][q * 4 + 1]);
                    v.z = __fsub_rn(v.z, acc[a][q * 4 + 2]);
                    v.w = __fsub_rn(v.w, acc[a][q * 4 + 3]);
                    *reinterpret_cast<float4 *>(Tt + (i0 + row) * (size_t)R + j0 + col) = v;
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[a][q * 4 + c] = 0.0f;
                }
            j0 += AT;
            if (j0 == (size_t)R) { j0 = 0; i0 += AT; }
        }
    }
    cp_async_wait<0>();
}

__global__ void fill(float *x, size_t n, unsigned seed, float lo, float hi) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        unsigned h = (unsigned)i * 2654435761u ^ seed;
        h ^= h >> 13;
        h *= 0x5bd1e995u;
        h ^= h >> 15;
        x[i] = lo + (hi - lo) * (h & 0xffffff) / 16777216.0f;
    }
}

__global__ void count_diff(const float *a, const float *b, size_t n,
                           unsigned long long *cnt) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x)
        if (__float_as_uint(a[i]) != __float_as_uint(b[i])) atomicAdd(cnt, 1ull);
}

int SMS = 0;
double *COEFFS = nullptr, *PART = nullptr;

typedef void (*Launch)(float *, const float *, const float *, int, int, int);

void run_grid(float *T, const float *F, const float *C, int M, int R, int L) {
    apply_tiles<false><<<dim3(R / AT, M / AT), APPLY_THREADS>>>(T, F, C, M, R, L, nullptr, nullptr);
}
void run_k3(float *T, const float *F, const float *C, int M, int R, int L) {
    apply_tiles<true><<<dim3(R / AT, M / AT), APPLY_THREADS>>>(T, F, C, M, R, L, COEFFS, PART);
}
void run_shipped(float *T, const float *F, const float *C, int M, int R, int L) {
    apply_window_launch(T, F, C, M, R, L, nullptr);
}
void run_a(float *T, const float *F, const float *C, int M, int R, int L) {
    const int smem = (AT * AT + 6 * 2 * AK * AT) * 4;
    cudaFuncSetAttribute(variant_a, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const int nt = (M / AT) * (R / AT);
    variant_a<<<nt < SMS ? nt : SMS, APPLY_THREADS, smem>>>(T, F, C, M, R, L);
}
template <int TH, int CT, int ROWS, int S, int MINB, bool W48, bool NOMEM>
void run_v(float *T, const float *F, const float *C, int M, int R, int L) {
    const int smem = (AT * AT + S * 2 * ROWS * AT) * 4;
    auto k = variant<TH, CT, ROWS, S, MINB, W48, NOMEM>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const int nt = (M / AT) * (R / AT), nb = SMS * MINB;
    k<<<nt < nb ? nt : nb, TH, smem>>>(T, F, C, M, R, L);
}

}  // namespace

int main() {
    cudaDeviceGetAttribute(&SMS, cudaDevAttrMultiProcessorCount, 0);
    const char *names[] = {"grid (old tile)", "K3 tile (with fold)", "shipped",
                           "A", "B r16 S3", "B r8 S3", "E r16 S3", "E r8 S4",
                           "C r16 S3", "nomem"};
    Launch fns[] = {run_grid, run_k3, run_shipped, run_a,
                    run_v<256, 8, 16, 3, 2, false, false>,
                    run_v<256, 8, 8, 3, 2, false, false>,
                    run_v<256, 8, 16, 3, 2, true, false>,
                    run_v<256, 8, 8, 4, 2, true, false>,
                    run_v<128, 16, 16, 3, 2, false, false>,
                    run_v<256, 8, 8, 4, 2, true, true>};
    const int rows[] = {8, 8, 8, 8, 16, 8, 16, 8, 16, 8};   // eta rows a stage
    const int NV = sizeof(fns) / sizeof(fns[0]);
    unsigned long long *cnt;
    cudaMalloc(&cnt, 8);
    // Bit for bit against the old tile: the flagship shape, an odd R-tile
    // count with the shortest window, and several tiles a block with a
    // window of 17 stages.
    const int shapes[][3] = {{8192, 24576, 128}, {256, 384, 8}, {1024, 2944, 136}};
    for (auto &sh : shapes) {
        const int M = sh[0], R = sh[1], L = sh[2];
        const size_t n = (size_t)M * R;
        float *T0, *T, *Tr, *F, *C;
        cudaMalloc(&T0, n * 4); cudaMalloc(&T, n * 4); cudaMalloc(&Tr, n * 4);
        cudaMalloc(&F, (size_t)L * M * 4); cudaMalloc(&C, (size_t)L * R * 4);
        cudaMalloc(&COEFFS, M * 8); cudaMalloc(&PART, (size_t)(M / AT) * R * 8);
        cudaMemset(COEFFS, 0, M * 8);
        fill<<<1024, 256>>>(T0, n, 1, -1, 1);
        fill<<<1024, 256>>>(F, (size_t)L * M, 2, -0.1f, 0.1f);
        fill<<<1024, 256>>>(C, (size_t)L * R, 3, -1, 1);
        cudaMemcpy(Tr, T0, n * 4, cudaMemcpyDeviceToDevice);
        run_grid(Tr, F, C, M, R, L);
        for (int v = 1; v < NV - 1; ++v) {
            if (L % rows[v]) continue;           // the variant takes whole stages
            cudaMemcpy(T, T0, n * 4, cudaMemcpyDeviceToDevice);
            fns[v](T, F, C, M, R, L);
            cudaMemset(cnt, 0, 8);
            count_diff<<<1024, 256>>>(T, Tr, n, cnt);
            unsigned long long h = 1;
            cudaMemcpy(&h, cnt, 8, cudaMemcpyDeviceToHost);
            printf("M=%d R=%d L=%d %-20s elements differing from the old tile: %llu (%s)\n",
                   M, R, L, names[v], h, cudaGetErrorString(cudaGetLastError()));
            if (h != 0) return 1;
        }
        if (M == 8192) {
            cudaEvent_t a, b;
            cudaEventCreate(&a);
            cudaEventCreate(&b);
            for (int round = 0; round < 3; ++round)
                for (int v = 0; v < NV; ++v) {
                    fns[v](T, F, C, M, R, L);
                    cudaEventRecord(a);
                    for (int i = 0; i < 10; ++i) fns[v](T, F, C, M, R, L);
                    cudaEventRecord(b);
                    cudaEventSynchronize(b);
                    float ms;
                    cudaEventElapsedTime(&ms, a, b);
                    printf("round %d %-20s %.4f ms\n", round, names[v], ms / 10);
                }
        }
        cudaFree(T0); cudaFree(T); cudaFree(Tr); cudaFree(F); cudaFree(C);
        cudaFree(COEFFS); cudaFree(PART);
    }
    return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
