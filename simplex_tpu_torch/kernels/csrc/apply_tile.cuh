// The window apply on one 128 x 128 tile of a transposed tableau: K9/K10's
// tile (batched.cu, one tableau per lane). blocked.cu's K3/K4 run their own
// persistent window_apply, which rounds every element as this tile does.
//   Tt[i, j] -= sum_{s<L} F[s, i] * C[s, j]           (IEEE f32 FFMA)
// optionally followed by the reprice partial of the tile's 128 rows,
//   part_row[j] = sum_{i in tile} coeffs[i] * Tt_new[i, j]   (f64).
// 256 threads each own an 8 x 8 register tile; F and C are staged through
// shared memory 8 eta rows at a time. Each thread reads its Tt elements
// before it writes them and no other thread touches them, so the update is
// safe in place. The caller's grid puts the R tile on blockIdx.x and the M
// tile on blockIdx.y.
//
// The standalone reprices K11/K12 (reprice_tile) load the tile into the
// same registers and run the same fold, so with zero etas they give K9's mv
// bit for bit; K3's fold (blocked.cu window_apply<true>) sums the same
// 8-row groups in the same order, so K11 gives K3's mv too.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int AT = 128;              // tile edge on both axes
constexpr int AK = 8;                // eta rows per shared-memory stage
constexpr int APPLY_THREADS = 256;

__device__ __forceinline__ void reprice_fold(
        const float (&acc)[8][8], const double *__restrict__ coeffs,
        double *__restrict__ part_row);

// Tt, F and C point at one tableau and its factors (F (L, M), C (L, R)).
// L must be a multiple of AK. With REPRICE and coeffs != nullptr the tile's
// reprice partial goes to part_row (R,); coeffs must be the same for the
// whole block (the fold synchronises the block).
template <bool REPRICE>
__device__ __forceinline__ void apply_tile(
        float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, int M, int R, int L,
        const double *__restrict__ coeffs, double *__restrict__ part_row) {
    __shared__ __align__(16) float Fs[AK][AT];
    __shared__ __align__(16) float Cs[AK][AT];
    const int tx = threadIdx.x & 15;             // 8 columns each
    const int ty = threadIdx.x >> 4;             // 8 rows each
    const size_t i0 = (size_t)blockIdx.y * AT;   // M (row) offset
    const size_t j0 = (size_t)blockIdx.x * AT;   // R (column) offset

    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = 0.0f;

    const int lrow = threadIdx.x >> 5;           // stage row 0..7
    const int lcol = (threadIdx.x & 31) * 4;     // stage column 0..124
    for (int s0 = 0; s0 < L; s0 += AK) {
        *reinterpret_cast<float4 *>(&Fs[lrow][lcol]) =
            *reinterpret_cast<const float4 *>(
                F + (size_t)(s0 + lrow) * M + i0 + lcol);
        *reinterpret_cast<float4 *>(&Cs[lrow][lcol]) =
            *reinterpret_cast<const float4 *>(
                C + (size_t)(s0 + lrow) * R + j0 + lcol);
        __syncthreads();
#pragma unroll
        for (int s = 0; s < AK; ++s) {
            float fa[8], cb[8];
            *reinterpret_cast<float4 *>(&fa[0]) =
                *reinterpret_cast<const float4 *>(&Fs[s][ty * 8]);
            *reinterpret_cast<float4 *>(&fa[4]) =
                *reinterpret_cast<const float4 *>(&Fs[s][ty * 8 + 4]);
            *reinterpret_cast<float4 *>(&cb[0]) =
                *reinterpret_cast<const float4 *>(&Cs[s][tx * 8]);
            *reinterpret_cast<float4 *>(&cb[4]) =
                *reinterpret_cast<const float4 *>(&Cs[s][tx * 8 + 4]);
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    acc[a][c] = fmaf(fa[a], cb[c], acc[a][c]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < 8; ++a) {
        float *row = Tt + (i0 + ty * 8 + a) * (size_t)R + j0 + tx * 8;
        float4 lo = *reinterpret_cast<float4 *>(row);
        float4 hi = *reinterpret_cast<float4 *>(row + 4);
        lo.x -= acc[a][0]; lo.y -= acc[a][1];
        lo.z -= acc[a][2]; lo.w -= acc[a][3];
        hi.x -= acc[a][4]; hi.y -= acc[a][5];
        hi.z -= acc[a][6]; hi.w -= acc[a][7];
        *reinterpret_cast<float4 *>(row) = lo;
        *reinterpret_cast<float4 *>(row + 4) = hi;
        acc[a][0] = lo.x; acc[a][1] = lo.y; acc[a][2] = lo.z; acc[a][3] = lo.w;
        acc[a][4] = hi.x; acc[a][5] = hi.y; acc[a][6] = hi.z; acc[a][7] = hi.w;
    }

    if constexpr (REPRICE) {
        if (coeffs == nullptr) return;
        reprice_fold(acc, coeffs, part_row);
    }
}

// The tile over one whole tableau, one block a tile (the R tile on
// blockIdx.x, the M tile on blockIdx.y; with REPRICE, part (M / AT, R) f64
// takes one partial row per M tile). No kernel of the port launches it:
// it is the first K3/K4, which blocked.cu's window_apply replaced, kept for
// the design benches in tools/ that time the two side by side.
template <bool REPRICE>
__global__ void __launch_bounds__(APPLY_THREADS) apply_tiles(
        float *__restrict__ Tt, const float *__restrict__ F,
        const float *__restrict__ C, int M, int R, int L,
        const double *__restrict__ coeffs, double *__restrict__ part) {
    apply_tile<REPRICE>(Tt, F, C, M, R, L, coeffs,
                        REPRICE ? part + (size_t)blockIdx.y * R : nullptr);
}

// The tile's reprice partial from the thread's 8 x 8 register tile of
// Tt (acc[a][c] = Tt[i0 + ty*8 + a, j0 + tx*8 + c]): each thread folds its 8
// rows per column in f64, then 128 threads sum the 16 row groups in order,
//   part_row[j0 + c] = sum_{i in tile} coeffs[i] * Tt[i, j0 + c].
// The whole block must call it (it synchronises).
__device__ __forceinline__ void reprice_fold(
        const float (&acc)[8][8], const double *__restrict__ coeffs,
        double *__restrict__ part_row) {
    __shared__ double red[APPLY_THREADS / 16][AT];
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const size_t i0 = (size_t)blockIdx.y * AT;
    const size_t j0 = (size_t)blockIdx.x * AT;
    double cf[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) cf[a] = coeffs[i0 + ty * 8 + a];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        double s = 0.0;
#pragma unroll
        for (int a = 0; a < 8; ++a)
            s = __fma_rn(cf[a], (double)acc[a][c], s);
        red[ty][tx * 8 + c] = s;
    }
    __syncthreads();
    if (threadIdx.x < AT) {
        double s = 0.0;
        for (int y = 0; y < APPLY_THREADS / 16; ++y)
            s = __dadd_rn(s, red[y][threadIdx.x]);
        part_row[j0 + threadIdx.x] = s;
    }
}

// The reprice partial of one tile without an apply (K11, K12): the thread's
// 8 x 8 elements of Tt (R columns per row) loaded as apply_tile leaves
// them in its registers, then reprice_fold.
__device__ __forceinline__ void reprice_tile(
        const float *__restrict__ Tt, int R,
        const double *__restrict__ coeffs, double *__restrict__ part_row) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const size_t i0 = (size_t)blockIdx.y * AT;
    const size_t j0 = (size_t)blockIdx.x * AT;
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
        const float *row = Tt + (i0 + ty * 8 + a) * (size_t)R + j0 + tx * 8;
        const float4 lo = *reinterpret_cast<const float4 *>(row);
        const float4 hi = *reinterpret_cast<const float4 *>(row + 4);
        acc[a][0] = lo.x; acc[a][1] = lo.y; acc[a][2] = lo.z; acc[a][3] = lo.w;
        acc[a][4] = hi.x; acc[a][5] = hi.y; acc[a][6] = hi.z; acc[a][7] = hi.w;
    }
    reprice_fold(acc, coeffs, part_row);
}

}  // namespace
