// fma-faithful rank-1 pivot update for the host oracle (the port's own copy
// of simplex_tpu/native/fma_update.cpp; built into simplex_tpu_torch/_build/
// by utils/fma_native.py).
//
// The reference GPU updates every tableau element, the RHS row and the
// cost row with a single correctly-rounded fma per element
// (src/solver.cu:34-56: `fma(-rowPivot[col] / pivot, colPivot[row],
// pRow[col])` and `fma(-costsPivot / pivot, colPivot[i], costVector[i])`),
// while NumPy/BLAS expressions like `T -= outer(colk, factor)` round the
// product and the subtraction separately. A rank-1 update has no
// accumulation order — the ONLY arithmetic difference between the GPU
// and a host replay is that one rounding — so replaying with these
// routines reproduces the GPU tableau bit-for-bit and extends exact
// pivot-count parity to sizes where the eps-tie pattern is last-ulp
// sensitive (tests/test_parity.py: 4096x4096, ~9k pivots).
//
// Build: g++ -O3 -march=native -shared -fPIC fma_update.cpp -o libfma.so
// (-march=native so std::fma lowers to the hardware vfmadd instruction;
// a libm-call fallback is bit-identical, just slower).

#include <cmath>
#include <cstdint>

extern "C" {

// T row-major (rows x cols): for j != k, T[i][j] = fma(-factor[j],
// colk[i], T[i][j]); column k becomes colk[i] / p (the reference's
// `pRow[col] / pivot` branch — each element is written exactly once, so
// the divide reads the pre-update value). factor[j] must be the
// correctly-rounded a_h[j] / p (one double division, same bits as the
// GPU's per-element `rowPivot[col] / pivot`; negation is exact).
void pivot_update_fma(double *T, const double *colk, const double *factor,
                      int64_t rows, int64_t cols, int64_t k, double p) {
    for (int64_t i = 0; i < rows; ++i) {
        const double ci = colk[i];
        double *row = T + i * cols;
        for (int64_t j = 0; j < cols; ++j)
            row[j] = std::fma(-factor[j], ci, row[j]);
        row[k] = ci / p;
    }
}

// x[i] = fma(a, v[i], x[i]) — the reference updateCostsVector shape
// (and the RHS row, which the GPU updates as matrix row 0).
void axpy_fma(double *x, const double *v, double a, int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        x[i] = std::fma(a, v[i], x[i]);
}

// Correctly-rounded a*b + c for host scalars (math.fma needs 3.13).
double fma_scalar(double a, double b, double c) { return std::fma(a, b, c); }

}  // extern "C"
