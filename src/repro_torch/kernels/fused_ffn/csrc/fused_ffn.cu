// K3: fused gated FFN, out = (act(x Wg) * (x Wu)) Wd, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_ffn/fused_ffn.py
// (fused_ffn_pallas): act is silu or tanh-gelu, accumulation is f32, the
// gated intermediate h never goes to device memory and each weight tile is
// read once per row tile.
//
// What bounds it on the H100: bytes at decode widths. For qwen2-0.5b one
// call reads 3 * 896 * 4864 bf16 weights (26 MB) to do 2 * 3 * 26M / 2
// flops per row, about 3 flop/byte per row: far below the ~295 flop/byte
// of the tensor cores, so the floor is streaming the weights once at
// 3.35 TB/s. At prefill widths (128 rows) the same call is still under the
// line for CUDA-core f32 math, so this version does its products in f32 on
// the CUDA cores.
//
// What the design does about it: F is split across CTAs (FS columns each,
// 152 CTAs for F = 4864, more than the 132 SMs), so every weight byte is
// read by exactly one CTA per row tile; a CTA keeps its x row tile in
// shared memory, forms h = act(x Wg[:, slice]) * (x Wu[:, slice]) in shared
// memory, multiplies it into Wd[slice, :], and writes its partial (rows, D)
// sum to a scratch buffer. A second small kernel adds the slices in a fixed
// order: deterministic, no atomics. Tails of D, F and the row count are
// masked, so no extent has to divide a tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kFS = 32;        // F columns per CTA (one warp lane each)
constexpr int kRT = 8;         // rows per CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));  // silu
  // tanh-approximated gelu (jax.nn.gelu's default form)
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f *
                                 (g + 0.044715f * g * g * g)));
}

// grid (n_slices, ceil(R / kRT)); shared memory (floats):
//   x_s[kRT*D] | red[kWarps*kRT*kFS*2] | h_s[kRT*kFS]
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_slice_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                 const T* __restrict__ wu, const T* __restrict__ wd,
                 float* __restrict__ part, int R, int D, int F, int act) {
  extern __shared__ float smem[];
  float* x_s = smem;
  float* red = x_s + kRT * D;
  float* h_s = red + kWarps * kRT * kFS * 2;
  const int slice = blockIdx.x, f0 = slice * kFS, r0 = blockIdx.y * kRT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kRT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    x_s[i] = (r0 + r < R) ? to_f(x[(long long)(r0 + r) * D + d]) : 0.f;
  }
  __syncthreads();

  // phase 1: gate/up partial dots; warp w owns a D range, lane owns column
  const int f = f0 + lane;
  const bool f_in = f < F;
  float g[kRT], u[kRT];
#pragma unroll
  for (int r = 0; r < kRT; ++r) g[r] = u[r] = 0.f;
  const int dchunk = (D + kWarps - 1) / kWarps;
  const int d_lo = warp * dchunk, d_hi = min(D, d_lo + dchunk);
  for (int d = d_lo; d < d_hi; ++d) {
    const float wgv = f_in ? to_f(wg[(long long)d * F + f]) : 0.f;
    const float wuv = f_in ? to_f(wu[(long long)d * F + f]) : 0.f;
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const float xv = x_s[r * D + d];
      g[r] += xv * wgv;
      u[r] += xv * wuv;
    }
  }
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    red[((warp * kRT + r) * kFS + lane) * 2 + 0] = g[r];
    red[((warp * kRT + r) * kFS + lane) * 2 + 1] = u[r];
  }
  __syncthreads();
  for (int i = tid; i < kRT * kFS; i += kThreads) {
    const int r = i / kFS, c = i - r * kFS;
    float gs = 0.f, us = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      gs += red[((w * kRT + r) * kFS + c) * 2 + 0];
      us += red[((w * kRT + r) * kFS + c) * 2 + 1];
    }
    h_s[i] = (f0 + c < F) ? activate(gs, act) * us : 0.f;
  }
  __syncthreads();

  // phase 2: this slice's share of h @ Wd for every output column
  const int fn = min(kFS, F - f0);
  for (int n = tid; n < D; n += kThreads) {
    float acc[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) acc[r] = 0.f;
    for (int c = 0; c < fn; ++c) {
      const float wdv = to_f(wd[(long long)(f0 + c) * D + n]);
#pragma unroll
      for (int r = 0; r < kRT; ++r) acc[r] += h_s[r * kFS + c] * wdv;
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (r0 + r < R) part[((long long)slice * R + r0 + r) * D + n] = acc[r];
  }
}

__global__ void ffn_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n_slices,
                                  long long RD) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= RD) return;
  float s = 0.f;
  for (int sl = 0; sl < n_slices; ++sl) s += part[(long long)sl * RD + i];
  out[i] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* part, void* out, int R, int D, int F,
                   int act, cudaStream_t stream) {
  const int n_slices = (F + kFS - 1) / kFS;
  const size_t smem = sizeof(float) *
      ((size_t)kRT * D + (size_t)kWarps * kRT * kFS * 2 + (size_t)kRT * kFS);
  auto kern = ffn_slice_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_slices, (R + kRT - 1) / kRT);
  kern<<<grid, kThreads, smem, stream>>>((const T*)x, (const T*)wg,
                                         (const T*)wu, (const T*)wd,
                                         (float*)part, R, D, F, act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long RD = (long long)R * D;
  ffn_reduce_kernel<<<(unsigned)((RD + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (float*)out, n_slices, RD);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_ffn_slices(int F) { return (F + kFS - 1) / kFS; }

// dtype: 0 float32, 1 bfloat16 (x and all three weights). act: 0 silu,
// 1 tanh-gelu. part: (fused_ffn_slices(F), R, D) f32 scratch; out: (R, D)
// f32. Returns cudaGetLastError() after the launches.
extern "C" int fused_ffn_launch(const void* x, const void* wg, const void* wu,
                                const void* wd, void* part, void* out, int R,
                                int D, int F, int act, int dtype,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(x, wg, wu, wd, part, out, R, D, F, act, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, wg, wu, wd, part, out, R, D, F, act,
                                      st);
  return (int)cudaErrorInvalidConfiguration;
}
