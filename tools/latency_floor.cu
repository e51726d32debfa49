// The latency floor of a one-thread kernel on the card: an empty kernel,
// one that copies one global element (its store waits on one load), and
// one that loads an index and then the element it names (two dependent
// loads, as the step kernels read h and then the column). chip_smoke.py
// builds it (nvcc, a plain C interface), launches each on the current
// stream through ctypes and times it by the clocks of the other kernels:
// torch.profiler, and CUDA events over a CUDA graph of 50 calls.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -Xcompiler -fPIC -shared -o liblatency.so tools/latency_floor.cu

#include <cuda_runtime.h>

namespace {

__global__ void latency_empty_kernel() {}

__global__ void latency_load_kernel(const int *__restrict__ in,
                                    int *__restrict__ out) {
    out[0] = in[0];
}

__global__ void latency_chain_kernel(const int *__restrict__ idx,
                                     const int *__restrict__ in,
                                     int *__restrict__ out) {
    out[0] = in[idx[0]];
}

}  // namespace

extern "C" {

int latency_empty_launch(void *stream) {
    latency_empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
    return (int)cudaGetLastError();
}

int latency_load_launch(const int *in, int *out, void *stream) {
    latency_load_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(in,
                                                                        out);
    return (int)cudaGetLastError();
}

int latency_chain_launch(const int *idx, const int *in, int *out,
                         void *stream) {
    latency_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        idx, in, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
