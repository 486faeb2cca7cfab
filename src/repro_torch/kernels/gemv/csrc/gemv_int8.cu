// K4: W8A8 int8 GEMV / thin matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gemv/gemv.py (gemv_int8_pallas):
// out[r, n] = (float(sum_k xq[r, k] * wq[k, n]) * x_scale[r]) * w_scale[n]
// for int8 xq (R, K), int8 wq (K, N) with per-row and per-column f32
// scales. Unlike the Pallas kernel, which adds int32 block products into an
// f32 accumulator across K blocks (inexact once |acc| > 2^24, reachable at
// K = 4864), this kernel accumulates in int32 over the whole K, so the
// result is bit-exact with repro.quant.int8.int8_matmul and gemv/ref.py.
//
// What bounds it on the H100: bytes at decode widths. Each weight byte
// feeds 2 * R integer operations (R = 8 decode rows: 16 op/byte), far under
// the ~590 op/byte the int8 tensor cores need, so the floor is reading the
// int8 weights once at 3.35 TB/s.
//
// What the design does about it: weights stay int8 in device memory (half
// the bytes of bf16) and are read once per row tile, 4 bytes per thread
// per load, adjacent threads on adjacent columns; a 4x4 byte transpose in
// registers (__byte_perm) turns four rows of four columns into per-column
// words of four k values, so each __dp4a does four multiply-adds; the x
// row tile sits in shared memory; the K range is split over the CTA's
// warps and their int32 partials are added exactly in shared memory. N is
// tiled across CTAs and its tail masked; the K tail is zero-padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNT = 128;   // columns per CTA: 32 lanes x 4
constexpr int kRT = 8;     // rows per CTA

__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ w, int k,
                                          int n0, int K, int N, int aligned) {
  if (k >= K || n0 >= N) return 0u;
  const int8_t* p = w + (long long)k * N + n0;
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t word = 0u;
  for (int c = 0; c < 4; ++c)
    if (n0 + c < N) word |= (uint32_t)(uint8_t)p[c] << (8 * c);
  return word;
}

// grid (ceil(N / kNT), ceil(R / kRT)); dynamic shared memory holds the x
// row tile (kRT * Kp bytes), then, reused, the int32 warp partials.
__global__ void __launch_bounds__(kThreads)
gemv_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const float* __restrict__ ws,
                 float* __restrict__ out, int R, int K, int N, int aligned) {
  extern __shared__ int smem_i[];
  int8_t* x_s = reinterpret_cast<int8_t*>(smem_i);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_base = blockIdx.x * kNT, r0 = blockIdx.y * kRT;
  const int Kp = (K + 3) & ~3;

  for (int i = tid; i < kRT * Kp; i += kThreads) {
    const int r = i / Kp, k = i - r * Kp;
    x_s[i] = (r0 + r < R && k < K) ? xq[(long long)(r0 + r) * K + k] : 0;
  }
  __syncthreads();

  const int n0 = n_base + lane * 4;
  int acc[kRT][4];
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

#pragma unroll 4
  for (int k4 = warp; k4 < Kp / 4; k4 += kWarps) {
    const int k = k4 * 4;
    const uint32_t w0 = load4(wq, k + 0, n0, K, N, aligned);
    const uint32_t w1 = load4(wq, k + 1, n0, K, N, aligned);
    const uint32_t w2 = load4(wq, k + 2, n0, K, N, aligned);
    const uint32_t w3 = load4(wq, k + 3, n0, K, N, aligned);
    // 4x4 byte transpose: col[c] = (w0.c, w1.c, w2.c, w3.c)
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
    const int col0 = (int)__byte_perm(lo01, lo23, 0x5410);
    const int col1 = (int)__byte_perm(lo01, lo23, 0x7632);
    const int col2 = (int)__byte_perm(hi01, hi23, 0x5410);
    const int col3 = (int)__byte_perm(hi01, hi23, 0x7632);
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int xw = *reinterpret_cast<const int*>(x_s + r * Kp + k);
      acc[r][0] = __dp4a(xw, col0, acc[r][0]);
      acc[r][1] = __dp4a(xw, col1, acc[r][1]);
      acc[r][2] = __dp4a(xw, col2, acc[r][2]);
      acc[r][3] = __dp4a(xw, col3, acc[r][3]);
    }
  }
  __syncthreads();  // x_s is dead: reuse the buffer for the partials
  int* red = smem_i;
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(warp * kRT + r) * kNT + lane * 4 + c] = acc[r][c];
  __syncthreads();
  for (int i = tid; i < kRT * kNT; i += kThreads) {
    const int r = i / kNT, c = i - r * kNT, n = n_base + c;
    if (r0 + r >= R || n >= N) continue;
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += red[(w * kRT + r) * kNT + c];
    out[(long long)(r0 + r) * N + n] =
        __fmul_rn(__fmul_rn(__int2float_rn(s), xs[r0 + r]), ws[n]);
  }
}

}  // namespace

// xq (R,K) int8, xs (R) f32, wq (K,N) int8, ws (N) f32, out (R,N) f32, all
// contiguous. aligned = 1 when N % 4 == 0 and wq is 4-byte aligned (word
// loads), else byte loads. Returns cudaGetLastError() after the launch.
extern "C" int gemv_int8_launch(const void* xq, const void* xs,
                                const void* wq, const void* ws, void* out,
                                int R, int K, int N, int aligned,
                                void* stream) {
  const int Kp = (K + 3) & ~3;
  size_t smem = (size_t)kRT * Kp;
  const size_t red = sizeof(int) * (size_t)kWarps * kRT * kNT;
  if (red > smem) smem = red;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gemv_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + kNT - 1) / kNT, (R + kRT - 1) / kRT);
  gemv_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const float*)xs, (const int8_t*)wq,
      (const float*)ws, (float*)out, R, K, N, aligned);
  return (int)cudaGetLastError();
}
