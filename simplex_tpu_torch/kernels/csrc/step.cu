// The step before K1 of a window's first pivot, as a one-thread kernel.
//
// The per-pivot step of the blocked-kernel loop (csrc/step.cuh) runs as
// tails of K1 and K2 (csrc/blocked.cu): the step between K1 and K2 in the
// block of K1 that draws the last arrival ticket, and the step after K2,
// with the next pivot's step before K1, in K2's. What no kernel of the
// window precedes is the first pivot's step before K1: this kernel, one
// launch a window, so a CUDA graph of a window of L pivots holds 2L + 1
// nodes.
//
// Replaces no Pallas kernel: the XLA-fused glue of
// simplex_tpu/solver.py:731-742.
//
// Bound on the card: latency. It reads and writes a few dozen bytes of
// 0-dim tensors (kernels.blocked.PivotScalars) in one thread; its time is
// the launch and a handful of dependent global loads. Design: one struct
// of pointers passed by value, so one launch reads every scalar it needs
// with no host work beyond the pointer copy.

#include <cuda_runtime.h>

#include "step.cuh"

namespace {

__global__ void step_pre_kernel(Step s, long long max_iter, double eps) {
    step::pre(s, *s.status, *s.iterations, *s.bland != 0,
              {*s.h_d, *s.v_d, *s.h_b, *s.v_b}, max_iter, eps);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (ctypes): the host copy of the pointers; returns
// cudaGetLastError() as an int.

extern "C" {

int step_pre_launch(const Step *s, long long max_iter, double eps,
                    void *stream) {
    step_pre_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        *s, max_iter, eps);
    return (int)cudaGetLastError();
}

}  // extern "C"
