// batch_rank1 (csrc/pivot.cu, the batched fallback's rank-1 update
// T3[i, j, :] -= factor[i, j] * colk[i, :] on the lanes whose do flag is set)
// under other designs, built into one shared library for
// tools/rank1_probe.py, which times each beside the shipped kernel and
// addcmul_ by CUDA events in turns and checks each bit for bit against the
// plain version. Every variant rounds the product and the difference apart,
// as the shipped kernel does, and reuses its tile arithmetic (csrc/pivot.cu
// is included; the shipped kernel runs here at other tile widths too).
//
//   tiles       the shipped kernel at 2, 4 or 8 vectors a thread a tile;
//   old         the kernel the shipped one replaced, verbatim: a 3-D grid
//               (column chunks, 32-row bands, lanes), a thread's 16-byte
//               vector column of a band four rows at a time (four loads,
//               then four stores), or a scalar tile of 4 strided columns a
//               thread when a row is not a whole number of 16-byte vectors;
//   persistent  a grid of blocks an SM that stays: each block scans the do
//               flags into a list of the live lanes in shared memory and
//               walks the live tiles round robin (static) or claims each
//               next tile from a counter in global memory (dynamic), the
//               next tile's loads issued before the current tile's stores;
//   bulk        the static persistent walk with each tile moved by one
//               thread with 1-D bulk async copies (cp.async.bulk, an
//               mbarrier a stage) through a ring of shared-memory stages,
//               loads stages - 1 tiles ahead, updated in shared memory and
//               written back by a bulk store;
//   hinted      the shipped one-tile-a-block kernel with streaming cache
//               hints (ld.global.cs / st.global.cs) on the tableau.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librank1_variants.so tools/rank1_variants.cu

#include "../simplex_tpu_torch/kernels/csrc/pivot.cu"

// The design the shipped kernel replaced, verbatim.
namespace old_r1 {


constexpr int R1_THREADS = 256;
constexpr int R1_VEC = 4;          // scalar tile: columns a thread
constexpr int R1_ROWS = 32;        // rows a block
constexpr int R1_INFLIGHT = 4;     // rows loaded before the first store

// t - f * c with the product and the difference rounded apart.
__device__ __forceinline__ float mul_sub_rn(float t, float f, float c) {
    return __fsub_rn(t, __fmul_rn(f, c));
}
__device__ __forceinline__ double mul_sub_rn(double t, double f, double c) {
    return __dsub_rn(t, __dmul_rn(f, c));
}
__device__ __forceinline__ double2 mul_sub_rn(double2 t, double f,
                                              double2 c) {
    return make_double2(mul_sub_rn(t.x, f, c.x), mul_sub_rn(t.y, f, c.y));
}
__device__ __forceinline__ float4 mul_sub_rn(float4 t, float f, float4 c) {
    return make_float4(mul_sub_rn(t.x, f, c.x), mul_sub_rn(t.y, f, c.y),
                       mul_sub_rn(t.z, f, c.z), mul_sub_rn(t.w, f, c.w));
}

// The 16-byte vector of each element type.
template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
    using type = double2;
};
template <>
struct Vec16<float> {
    using type = float4;
};

template <typename T>
__global__ void __launch_bounds__(R1_THREADS)
batch_rank1_vec(T *__restrict__ Tt, const T *__restrict__ factor,
                const T *__restrict__ colk,
                const unsigned char *__restrict__ do_flag, int M, int R) {
    using V = typename Vec16<T>::type;
    const int lane = blockIdx.z;
    if (!do_flag[lane]) return;
    const int RV = R / (int)(sizeof(V) / sizeof(T));   // vectors a row
    const int cv = blockIdx.x * R1_THREADS + threadIdx.x;
    if (cv >= RV) return;
    const int row0 = blockIdx.y * R1_ROWS;
    const int rows = min(R1_ROWS, M - row0);
    const V c = reinterpret_cast<const V *>(colk + (size_t)lane * R)[cv];
    const T *f = factor + (size_t)lane * M + row0;
    V *t = reinterpret_cast<V *>(Tt + ((size_t)lane * M + row0) * R) + cv;
    int r = 0;
    for (; r + R1_INFLIGHT <= rows; r += R1_INFLIGHT) {
        V tv[R1_INFLIGHT];
        T fv[R1_INFLIGHT];
#pragma unroll
        for (int u = 0; u < R1_INFLIGHT; ++u) {
            tv[u] = t[(size_t)(r + u) * RV];
            fv[u] = f[r + u];
        }
#pragma unroll
        for (int u = 0; u < R1_INFLIGHT; ++u)
            t[(size_t)(r + u) * RV] = mul_sub_rn(tv[u], fv[u], c);
    }
    for (; r < rows; ++r)
        t[(size_t)r * RV] = mul_sub_rn(t[(size_t)r * RV], f[r], c);
}

template <typename T>
__global__ void __launch_bounds__(R1_THREADS)
batch_rank1_tiles(T *__restrict__ Tt, const T *__restrict__ factor,
                  const T *__restrict__ colk,
                  const unsigned char *__restrict__ do_flag, int M, int R) {
    const int lane = blockIdx.z;
    if (!do_flag[lane]) return;
    const int row0 = blockIdx.y * R1_ROWS;
    const int col0 = blockIdx.x * (R1_THREADS * R1_VEC) + threadIdx.x;
    const T *c = colk + (size_t)lane * R;
    const T *f = factor + (size_t)lane * M;
    T *t = Tt + (size_t)lane * M * R;
    T cv[R1_VEC];
#pragma unroll
    for (int v = 0; v < R1_VEC; ++v) {
        const int col = col0 + v * R1_THREADS;
        cv[v] = col < R ? c[col] : T(0);
    }
    const int rows = min(R1_ROWS, M - row0);
    for (int r = 0; r < rows; ++r) {
        const T fr = f[row0 + r];
        T *trow = t + (size_t)(row0 + r) * R;
#pragma unroll
        for (int v = 0; v < R1_VEC; ++v) {
            const int col = col0 + v * R1_THREADS;
            if (col < R) trow[col] = mul_sub_rn(trow[col], fr, cv[v]);
        }
    }
}

template <typename T>
int batch_rank1_run(T *Tt, const T *factor, const T *colk,
                    const unsigned char *do_flag, int B, int M, int R,
                    void *stream) {
    if (B <= 0 || M <= 0 || R <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int per = (int)(16 / sizeof(T));
    const dim3 bands(1, (M + R1_ROWS - 1) / R1_ROWS, B);
    if (R % per == 0 && reinterpret_cast<uintptr_t>(Tt) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(colk) % 16 == 0) {
        const dim3 grid((R / per + R1_THREADS - 1) / R1_THREADS, bands.y, B);
        batch_rank1_vec<T><<<grid, R1_THREADS, 0, st>>>(Tt, factor, colk,
                                                         do_flag, M, R);
    } else {
        const dim3 grid((R + R1_THREADS * R1_VEC - 1) / (R1_THREADS * R1_VEC),
                        bands.y, B);
        batch_rank1_tiles<T><<<grid, R1_THREADS, 0, st>>>(Tt, factor, colk,
                                                           do_flag, M, R);
    }
    return (int)cudaGetLastError();
}

}  // namespace old_r1

namespace persist {

constexpr int R1_WARPS = R1_THREADS / 32;
constexpr int R1_LIST = 1024;      // lanes a list (B is at most this)

// Compacts the live lanes of [0, B) into list, in lane order; returns their
// count. Every thread of the block calls it.
__device__ int live_lanes(const unsigned char *__restrict__ do_flag, int B,
                          int *list, int *wsum) {
    constexpr int PT = R1_LIST / R1_THREADS;
    const int tid = threadIdx.x, lid = tid & 31, wid = tid >> 5;
    bool live[PT];
    int c = 0;
#pragma unroll
    for (int q = 0; q < PT; ++q) {
        const int l = tid * PT + q;
        live[q] = l < B && do_flag[l];
        c += live[q];
    }
    int x = c;                         // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lid >= o) x += y;
    }
    if (lid == 31) wsum[wid] = x;
    __syncthreads();
    int pos = x - c, total = 0;
#pragma unroll
    for (int w = 0; w < R1_WARPS; ++w) {
        const int s = wsum[w];
        if (w < wid) pos += s;
        total += s;
    }
#pragma unroll
    for (int q = 0; q < PT; ++q)
        if (live[q]) list[pos++] = tid * PT + q;
    __syncthreads();
    return total;
}

// Tiles a lane in the shipped arithmetic.
__device__ __forceinline__ long long lane_tiles(size_t n, int per, int tv) {
    const long long nvec = (long long)(n / per);
    return nvec > 0 ? (nvec + tv - 1) / tv : 1;
}

// DYN: claim each next tile from *ctr (zeroed before the launch); else the
// tiles blockIdx.x + i * gridDim.x.
template <typename T, int U, bool DYN>
__global__ void __launch_bounds__(R1_THREADS)
rank1_persistent(T *__restrict__ Tt, const T *__restrict__ factor,
                 const T *__restrict__ colk,
                 const unsigned char *__restrict__ do_flag, int B, int M,
                 int R, unsigned long long *ctr) {
    using V = typename Vec16<T>::type;
    constexpr int PER = (int)(16 / sizeof(T));
    __shared__ int list[R1_LIST];
    __shared__ int wsum[R1_WARPS];
    __shared__ long long claimed;
    const long long tpl = lane_tiles((size_t)M * R, PER, R1_THREADS * U);
    const long long tiles = live_lanes(do_flag, B, list, wsum) * tpl;
    auto next = [&](long long g) -> long long {
        if (!DYN) return g + gridDim.x;
        __syncthreads();                 // every thread has read claimed
        if (threadIdx.x == 0) claimed = (long long)atomicAdd(ctr, 1ULL);
        __syncthreads();
        return claimed;
    };
    long long g = next((long long)blockIdx.x - gridDim.x);
    if (g >= tiles) return;
    V a[U], b[U];
    R1Tile<T> cur = rank1_tile<T, U>(Tt, factor, colk, list[g / tpl],
                                     g % tpl, M, R);
    rank1_load<T, U>(cur, a);
    for (;;) {
        const long long gn = next(g);
        const bool more = gn < tiles;
        R1Tile<T> nxt;
        if (more) {
            nxt = rank1_tile<T, U>(Tt, factor, colk, list[gn / tpl],
                                   gn % tpl, M, R);
            rank1_load<T, U>(nxt, b);
        }
        rank1_store<T, U>(cur, a, R);
        if (!more) break;
        cur = nxt;
#pragma unroll
        for (int u = 0; u < U; ++u) a[u] = b[u];
        g = gn;
    }
}

}  // namespace persist

namespace bulk {

using persist::R1_LIST;
using persist::R1_WARPS;

__device__ __forceinline__ uint32_t su32(const void *p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
    for (long long spins = 0;; ++spins) {
        uint32_t done;
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
            "[%1], %2; selp.u32 %0, 1, 0, p; }"
            : "=r"(done)
            : "r"(su32(bar)), "r"(parity)
            : "memory");
        if (done) return;
        if (spins > (1LL << 24)) __trap();   // never hang the card
    }
}

// The vectors [v0, v0 + cnt) of tile d into buf, completing on bar.
template <typename T>
__device__ __forceinline__ void load_tile(const R1Tile<T> &d, long long v0,
                                          long long cnt, void *buf,
                                          uint64_t *bar) {
    if (cnt > 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(su32(bar)), "r"((uint32_t)(cnt * 16))
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            :: "r"(su32(buf)), "l"(d.t + d.h + v0 * (16 / sizeof(T))),
               "r"((uint32_t)(cnt * 16)), "r"(su32(bar))
            : "memory");
    } else {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     :: "r"(su32(bar)) : "memory");
    }
}

template <typename T>
__global__ void __launch_bounds__(R1_THREADS)
rank1_bulk(T *__restrict__ Tt, const T *__restrict__ factor,
           const T *__restrict__ colk,
           const unsigned char *__restrict__ do_flag, int B, int M, int R,
           int stages, int TV) {
    using V = typename Vec16<T>::type;
    constexpr int PER = (int)(16 / sizeof(T));
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t *full = reinterpret_cast<uint64_t *>(smem);        // 16 at most
    int *list = reinterpret_cast<int *>(smem + 128);
    int *wsum = list + R1_LIST;
    V *ring = reinterpret_cast<V *>(smem + 128 + 4 * (R1_LIST + R1_WARPS));
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < stages; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(su32(full + s)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const long long tpl = persist::lane_tiles((size_t)M * R, PER, TV);
    const long long tiles =
        persist::live_lanes(do_flag, B, list, wsum) * tpl;
    const long long grid = gridDim.x;
    const long long mine =
        tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / grid + 1 : 0;
    // Tile i of this block: its lane's range, first vector and count.
    auto tile_of = [&](long long i, long long &v0, long long &cnt) {
        const long long g = blockIdx.x + i * grid;
        const long long c = g % tpl;
        R1Tile<T> d = rank1_tile<T, 1>(Tt, factor, colk, list[g / tpl], 0,
                                       M, R);
        d.first = c == 0;
        v0 = c * TV;
        const long long nv = (long long)d.nv;
        cnt = v0 < nv ? (nv - v0 < TV ? nv - v0 : TV) : 0;
        return d;
    };
    if (tid == 0)
        for (long long i = 0; i < stages - 1 && i < mine; ++i) {
            long long v0, cnt;
            const R1Tile<T> d = tile_of(i, v0, cnt);
            load_tile(d, v0, cnt, ring + (size_t)(i % stages) * TV,
                      full + i % stages);
        }
    const int sq = (R1_THREADS * PER) / R, sr = (R1_THREADS * PER) % R;
    for (long long i = 0; i < mine; ++i) {
        const int s = (int)(i % stages);
        long long v0, cnt;
        const R1Tile<T> d = tile_of(i, v0, cnt);
        V *buf = ring + (size_t)s * TV;
        mbar_wait(full + s, (uint32_t)((i / stages) & 1));
        const size_t e = d.h + (size_t)(v0 + tid) * PER;
        int row = (int)(e / R), col = (int)(e % R);
        for (long long v = tid; v < cnt; v += R1_THREADS) {
            buf[v] = rank1_vec(buf[v], d.f, d.ck, row, col, R);
            col += sr;
            row += sq;
            if (col >= R) {
                col -= R;
                ++row;
            }
        }
        if (d.first) {
            const size_t tail = d.h + d.nv * PER;
            const size_t k = tid < d.h ? tid : tail + (tid - d.h);
            if (k < d.n && (k < d.h || k >= tail)) {
                int r = (int)(k / R), cc = (int)(k % R);
                d.t[k] = rank1_elem(d.t[k], d.f, d.ck, r, cc, R);
            }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (tid == 0) {
            if (cnt > 0) {
                asm volatile(
                    "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
                    "%2;" :: "l"(d.t + d.h + v0 * PER), "r"(su32(buf)),
                    "r"((uint32_t)(cnt * 16)) : "memory");
            }
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
            // The stage of tile i - 1 is free once its store has read it.
            asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
            const long long j = i + stages - 1;
            if (j < mine) {
                long long vj, cj;
                const R1Tile<T> dj = tile_of(j, vj, cj);
                load_tile(dj, vj, cj, ring + (size_t)(j % stages) * TV,
                          full + j % stages);
            }
        }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

long long bulk_smem(int stages, int TV) {
    return 128 + 4LL * (R1_LIST + R1_WARPS) + (long long)stages * TV * 16;
}

}  // namespace bulk

namespace hinted {

// The shipped tile kernel, its tableau loads and stores evict-first.
template <typename T, int U>
__global__ void __launch_bounds__(R1_THREADS)
rank1_hinted(T *__restrict__ Tt, const T *__restrict__ factor,
             const T *__restrict__ colk,
             const unsigned char *__restrict__ do_flag, int M, int R) {
    using V = typename Vec16<T>::type;
    constexpr int PER = (int)(16 / sizeof(T));
    const int lane = blockIdx.y;
    if (!do_flag[lane]) return;
    const R1Tile<T> d =
        rank1_tile<T, U>(Tt, factor, colk, lane, blockIdx.x, M, R);
    V *tv = reinterpret_cast<V *>(d.t + d.h);
    V a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const long long v = d.v0 + u * R1_THREADS;
        if (v < (long long)d.nv) a[u] = __ldcs(tv + v);
    }
    const int sq = (R1_THREADS * PER) / R, sr = (R1_THREADS * PER) % R;
    const size_t e = d.h + (size_t)d.v0 * PER;
    int row = (int)(e / R), col = (int)(e % R);
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const long long v = d.v0 + u * R1_THREADS;
        if (v < (long long)d.nv)
            __stcs(tv + v, rank1_vec(a[u], d.f, d.ck, row, col, R));
        col += sr;
        row += sq;
        if (col >= R) {
            col -= R;
            ++row;
        }
    }
    if (!d.first) return;
    const size_t tail = d.h + d.nv * PER;
    const size_t i = threadIdx.x < d.h ? threadIdx.x
                                      : tail + (threadIdx.x - d.h);
    if (i < d.n && (i < d.h || i >= tail)) {
        int r = (int)(i / R), c = (int)(i % R);
        d.t[i] = rank1_elem(d.t[i], d.f, d.ck, r, c, R);
    }
}

}  // namespace hinted

extern "C" {

// dtype 8 (f64) or 4 (f32) in every entry point.
int old_rank1_launch(void *Tt, const void *factor, const void *colk,
                     const unsigned char *do_flag, int B, int M, int R,
                     int dtype, void *stream) {
    if (dtype == 8)
        return old_r1::batch_rank1_run<double>(
            (double *)Tt, (const double *)factor, (const double *)colk,
            do_flag, B, M, R, stream);
    return old_r1::batch_rank1_run<float>((float *)Tt, (const float *)factor,
                                          (const float *)colk, do_flag, B, M,
                                          R, stream);
}

// ctr: a zeroed counter for the dynamic walk, or null for the static one.
// B <= R1_LIST; vecs 4 or 8.
int persistent_rank1_launch(void *Tt, const void *factor, const void *colk,
                            const unsigned char *do_flag, int B, int M,
                            int R, int dtype, int vecs, int grid,
                            unsigned long long *ctr, void *stream) {
    if (B > persist::R1_LIST || dtype != 8 || (vecs != 4 && vecs != 8))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERSIST(U, DYN)                                                     \
    persist::rank1_persistent<double, U, DYN><<<grid, R1_THREADS, 0, st>>>( \
        (double *)Tt, (const double *)factor, (const double *)colk, do_flag, \
        B, M, R, ctr)
    if (vecs == 4 && ctr) PERSIST(4, true);
    else if (vecs == 4) PERSIST(4, false);
    else if (ctr) PERSIST(8, true);
    else PERSIST(8, false);
#undef PERSIST
    return (int)cudaGetLastError();
}

// B <= R1_LIST, 2 <= stages <= 16; stage_vecs 16-byte vectors a stage.
int bulk_rank1_launch(void *Tt, const void *factor, const void *colk,
                      const unsigned char *do_flag, int B, int M, int R,
                      int dtype, int stages, int stage_vecs, int grid,
                      void *stream) {
    if (B > persist::R1_LIST || stages < 2 || stages > 16 || dtype != 8)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long smem = bulk::bulk_smem(stages, stage_vecs);
    cudaFuncSetAttribute(bulk::rank1_bulk<double>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    bulk::rank1_bulk<double><<<grid, R1_THREADS, smem, st>>>(
        (double *)Tt, (const double *)factor, (const double *)colk, do_flag,
        B, M, R, stages, stage_vecs);
    return (int)cudaGetLastError();
}

// The shipped kernel at any tile width (2, 4 or 8 vectors a thread).
int tiles_rank1_launch(void *Tt, const void *factor, const void *colk,
                       const unsigned char *do_flag, int B, int M, int R,
                       int dtype, int vecs, void *stream) {
    if (dtype != 8) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid((unsigned)rank1_lane_tiles(M, R, 8, vecs), B);
#define TILES(U)                                                          \
    batch_rank1_tiles<double, U><<<grid, R1_THREADS, 0, st>>>(             \
        (double *)Tt, (const double *)factor, (const double *)colk, do_flag, \
        M, R)
    if (vecs == 2) TILES(2);
    else if (vecs == 4) TILES(4);
    else if (vecs == 8) TILES(8);
    else return (int)cudaErrorInvalidValue;
#undef TILES
    return (int)cudaGetLastError();
}

int hinted_rank1_launch(void *Tt, const void *factor, const void *colk,
                        const unsigned char *do_flag, int B, int M, int R,
                        int dtype, int vecs, void *stream) {
    if (dtype != 8 || vecs != 4) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid((unsigned)rank1_lane_tiles(M, R, 8, 4), B);
    hinted::rank1_hinted<double, 4><<<grid, R1_THREADS, 0, st>>>(
        (double *)Tt, (const double *)factor, (const double *)colk, do_flag,
        M, R);
    return (int)cudaGetLastError();
}

}  // extern "C"
