// One thread-block cluster: the barrier in two halves and the launch.
// Shared by the kernels that run as a single cluster whose blocks fold
// over distributed shared memory (csrc/sharded_step.cu sharded_ratio,
// csrc/seq.cu seq_ratio and seq_ratio_colk, csrc/eta.cu
// eta_ratio_summed); and programmatic dependent launch's two halves,
// which csrc/eta.cu and csrc/seq.cu use.

#pragma once

#include <cuda_runtime.h>

// The cluster barrier in two halves (PTX barrier.cluster): arrive, then
// wait. The relaxed arrival orders nothing: it only tells that the block
// runs, before any block writes into another's shared memory. The plain
// arrival releases the stores before it, and the wait acquires them.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Programmatic dependent launch (sm_90): wait for the grid before this one
// to complete, its memory visible; let the grid after this one launch.
// Both return at once in a grid launched without the attribute.
__device__ __forceinline__ void grid_wait() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void grid_launch_next() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Lets ``kernel`` run as a cluster of ``nb`` blocks past the portable 8
// (the H100 takes 16). A launcher calls it once a kernel and keeps the
// result in a static.
template <typename... P>
cudaError_t allow_cluster(void (*kernel)(P...), int nb) {
    return nb > 8 ? cudaFuncSetAttribute(
                        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                        1)
                  : cudaSuccess;
}

// ``kernel`` as one cluster of ``nb`` blocks of ``nt`` threads on ``st``,
// the cluster's shape a launch attribute (which a CUDA graph captures);
// with ``pdl`` a programmatic dependent launch too, in the same call.
// Returns the launch's error, else cudaGetLastError(), as an int.
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), int nb, int nt, bool pdl,
                   cudaStream_t st, A... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb);
    cfg.blockDim = dim3(nt);
    cfg.stream = st;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nb;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 2 : 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
