// Device and launch helpers shared by the port's CUDA kernels (sm_90a):
// 16- and 4-byte cp.async copies, programmatic dependent launch, and the
// sum of a reduction split across CTAs, taken by the last CTA of each
// output tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace port {

constexpr int kThreads = 256;            // every kernel runs 8 warps a CTA

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// A 4-byte copy (cp.async allows sizes under 16 bytes only through L1).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0..3, larger counts as 3) of this thread's most
// recent cp.async groups are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Programmatic dependent launch: wait until the grid before this one on
// the stream has finished and its writes are visible; let the grid after
// this one start launching.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// After a CTA of a split reduction (grid z = splits) has written its
// partial: take a ticket for the CTA's (x, y) output tile. An integer
// atomicInc that wraps to zero, so the tickets are zero again once every
// CTA has drawn one. True in the CTA that draws the last ticket, whose
// reads then see every partial.
__device__ __forceinline__ bool last_of_split(unsigned* tickets) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicInc(&tickets[tile], gridDim.z - 1) == gridDim.z - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the last CTA of a split: for each valid output (r, c) of the MT x NT
// tile at (r0, n0), s = part[0][r0 + r][n0 + c] + part[1][...] + ... in
// that order, then emit(r, c, s). Partials of several splits at a time are
// copied into `buf` (buf_bytes of shared memory) with 16-byte cp.async
// copies, so each chunk of splits costs one round trip to L2.
template <typename A, int MT, int NT, typename Emit>
__device__ __forceinline__ void split_sum(const A* __restrict__ part, int R,
                                          int N, int r0, int n0, int splits,
                                          void* buf, int buf_bytes,
                                          Emit&& emit) {
  constexpr int kE = 16 / sizeof(A);                  // elements per copy
  constexpr int kPer = (MT * NT + kThreads - 1) / kThreads;
  const int rv = min(MT, R - r0), nv = min(NT, N - n0);
  const long long RN = (long long)R * N;
  const int tile = rv * NT;
  const int zc = max(1, buf_bytes / (int)(tile * sizeof(A)));
  const bool wide = nv == NT && (N * sizeof(A)) % 16 == 0 &&
                    ((uintptr_t)part & 15) == 0;
  A* b = reinterpret_cast<A*>(buf);
  A acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = A(0);
  for (int z0 = 0; z0 < splits; z0 += zc) {
    const int zn = min(zc, splits - z0);
    __syncthreads();                       // the last chunk is consumed
    for (int i = threadIdx.x; i < zn * rv * (NT / kE); i += kThreads) {
      const int q = i % (NT / kE), rz = i / (NT / kE);
      const int r = rz % rv, z = rz / rv;
      A* dst = b + (z * rv + r) * NT + q * kE;
      const A* src = part + (z0 + z) * RN + (long long)(r0 + r) * N + n0 +
                     q * kE;
      if (wide) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e)
          dst[e] = q * kE + e < nv ? __ldcg(src + e) : A(0);
      }
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < tile)
        for (int z = 0; z < zn; ++z) acc[j] += b[z * tile + i];
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < tile && i % NT < nv) emit(i / NT, i % NT, acc[j]);
  }
}

// Launch `kern` in clusters of (1, 1, cluster_z) CTAs; with `pdl`, as a
// programmatic dependent of the kernel before it on the stream.
template <typename... P, typename... Args>
cudaError_t launch_kernel(void (*kern)(P...), dim3 grid, size_t smem,
                          cudaStream_t stream, unsigned cluster_z, bool pdl,
                          Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster_z;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace port
