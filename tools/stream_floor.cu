// A load-only kernel: the least time the card takes to bring a matrix's
// bytes into shared memory under the access pattern of a kernel, with no
// arithmetic. CTA (x, y) copies rows [y * KC, y * KC + KC) x bytes
// [x * CB, x * CB + CB) of a row-major K x N byte matrix with 16-byte
// cp.async copies, all in flight at once, and waits for them.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void stream_kernel(const char* __restrict__ w, float* out, int K,
                              int N, int CB, int KC) {
  extern __shared__ __align__(16) char sm[];
  const int x0 = blockIdx.x * CB, k0 = blockIdx.y * KC, per = CB / 16;
  for (int i = threadIdx.x; i < KC * per; i += blockDim.x) {
    const int r = i / per, c = (i % per) * 16;
    if (k0 + r >= K) continue;
    const unsigned s = (unsigned)__cvta_generic_to_shared(sm + r * CB + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(w + (long long)(k0 + r) * N + x0 + c));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.y * gridDim.x + blockIdx.x] = sm[5];
}

// N % CB == 0, CB % 16 == 0; out holds one float per CTA.
extern "C" int stream_launch(const void* w, void* out, int K, int N, int CB,
                             int KC, void* stream) {
  const size_t smem = (size_t)KC * CB;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(N / CB, (K + KC - 1) / KC);
  stream_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const char*)w, (float*)out, K, N, CB, KC);
  return (int)cudaGetLastError();
}
