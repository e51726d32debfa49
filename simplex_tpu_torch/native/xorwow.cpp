// Bit-exact reimplementation of cuRAND's default XORWOW generator, as the
// reference solver uses it to generate benchmark instances
// (reference: src/generator.cu:9-32, src/problem.cu:49-126).
//
// Why native C++: regenerating the reference's seed-file instances
// (data/examples/benchmark_problems/*.txt) bit-for-bit requires stepping
// the XORWOW recurrence sequentially — up to n*m = 67M draws per matrix —
// which is three orders of magnitude too slow in Python. This library is
// the framework's native data-loader core, wrapped by
// simplex_tpu_torch/utils/curand.py via ctypes.
//
// Protocol parity notes (all verified against the reference kernels):
// * generateMatrixLinear (generator.cu:9-21): thread per constraint
//   column idX does curand_init(seed, 0, idX * nVars) then nVars
//   sequential draws — offsets tile contiguously, so the whole matrix is
//   the plain sequence: draw index c*n + v maps to A[c][v].
// * generateVector (generator.cu:24-32): element id draws the id-th
//   sequence element. So b and c are sequence prefixes.
// * Value mapping (generator.cu:18,30): float curand_uniform
//   u = x * 2^-32f + 2^-33f (in float32), then double arithmetic
//   u * (max - min) + min.
// * curand_init(seed, subsequence=0, offset): the offset skip-ahead
//   equals `offset` sequential steps (v-state matrix jump plus
//   d += 362437 * offset), so sequential generation from offset 0
//   reproduces every thread's stream exactly.
//
// XORWOW state-init salts and the step function follow the published
// cuRAND algorithm (curand_kernel.h, curandStateXORWOW_t).

#include <cstdint>

namespace {

struct XorwowState {
    uint32_t v[5];
    uint32_t d;
};

inline void xorwow_init(uint64_t seed, XorwowState *s) {
    const uint32_t s0 = static_cast<uint32_t>(seed) ^ 0xaad26b49u;
    const uint32_t s1 = static_cast<uint32_t>(seed >> 32) ^ 0xf7dcefddu;
    const uint32_t t0 = 1099087573u * s0;
    const uint32_t t1 = 2591861531u * s1;
    s->v[0] = 123456789u + t0;
    s->v[1] = 362436069u ^ t0;
    s->v[2] = 521288629u + t1;
    s->v[3] = 88675123u ^ t1;
    s->v[4] = 5783321u + t0;
    s->d = 6615241u + t1 + t0;
}

inline uint32_t xorwow_next(XorwowState *s) {
    const uint32_t t = s->v[0] ^ (s->v[0] >> 2);
    s->v[0] = s->v[1];
    s->v[1] = s->v[2];
    s->v[2] = s->v[3];
    s->v[3] = s->v[4];
    s->v[4] = (s->v[4] ^ (s->v[4] << 4)) ^ (t ^ (t << 1));
    s->d += 362437u;
    return s->v[4] + s->d;
}

// curand_uniform(): float32 in (0, 1].
inline float curand_uniform_f(uint32_t x) {
    const float k2pow32_inv = 2.3283064e-10f;
    return static_cast<float>(x) * k2pow32_inv + (k2pow32_inv / 2.0f);
}

}  // namespace

extern "C" {

// Raw uint32 sequence (for tests/debugging).
void xorwow_raw(uint64_t seed, uint64_t count, uint32_t *out) {
    XorwowState s;
    xorwow_init(seed, &s);
    for (uint64_t i = 0; i < count; ++i) out[i] = xorwow_next(&s);
}

// The reference's uniform mapping: double((float)u * (hi - lo) + lo)
// with the multiply/add in double precision (generator.cu:18).
void xorwow_uniform(uint64_t seed, uint64_t count, double lo, double hi,
                    double *out) {
    XorwowState s;
    xorwow_init(seed, &s);
    const double range = hi - lo;
    for (uint64_t i = 0; i < count; ++i) {
        const float u = curand_uniform_f(xorwow_next(&s));
        out[i] = static_cast<double>(u) * range + lo;
    }
}

}  // extern "C"
