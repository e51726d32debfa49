// The window apply on one 128 x 128 tile of a transposed tableau, shared by
// K3/K4 (blocked.cu, one tableau) and K9/K10 (batched.cu, one tableau per
// lane):
//   Tt[i, j] -= sum_{s<L} F[s, i] * C[s, j]           (IEEE f32 FFMA)
// optionally followed by the reprice partial of the tile's 128 rows,
//   part_row[j] = sum_{i in tile} coeffs[i] * Tt_new[i, j]   (f64).
// 256 threads each own an 8 x 8 register tile; F and C are staged through
// shared memory 8 eta rows at a time. Each thread reads its Tt elements
// before it writes them and no other thread touches them, so the update is
// safe in place. The caller's grid puts the R tile on blockIdx.x and the M
// tile on blockIdx.y.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int AT = 128;              // tile edge on both axes
constexpr int AK = 8;                // eta rows per shared-memory stage
constexpr int APPLY_THREADS = 256;

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
        __shared__ double red[APPLY_THREADS / 16][AT];
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
}

}  // namespace
