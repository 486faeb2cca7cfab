// K1: single-query GQA flash decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode/flash_decode.py
// (flash_decode_pallas, body _kernel): one query per sequence against a
// contiguous (B, n_kv, S, hd) KV cache, f32 online softmax over S tiles,
// optional int8 KV with per-position f32 scales, a device-side kv_limit
// that skips whole tiles, and a partial_stats mode that returns the raw
// (o, m, l) statistics for a split-KV merge.
//
// What bounds it on the H100: bytes. Each KV byte is used for 2*G flops
// (G = 7 query heads per KV head for qwen2-0.5b), far below the ~295
// flop/byte the card needs to be compute bound, so the floor is reading
// the live KV prefix once at 3.35 TB/s.
//
// What the design does about it: every K/V element is read from device
// memory once and dequantized in registers on its way into shared memory
// (the int8 cache is never expanded to a bf16 copy in device memory); the
// G query rows of one KV head share each K/V tile, so GQA costs one KV
// read per KV head, not per query head; tiles at or past kv_limit are
// never loaded; the (G, S) score matrix is never written out. This first
// version runs one CTA per (batch, kv_head) and walks S inside the CTA;
// splitting S across CTAs (flash-decoding) is later work.
//
// Edge behaviour matches the Pallas kernel: masked scores are NEG_INF =
// -1e30 (finite), so a processed tile in which a row has no live position
// averages V uniformly and is wiped by the first live tile; a call whose
// kv_limit skips every tile returns 0 (normalised) or (0, NEG_INF, 0).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;       // KV positions per tile
constexpr int kThreads = 128;   // 4 warps
constexpr int kMaxAcc = 8;      // G*hd <= kThreads*kMaxAcc outputs per CTA

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (n_kv, B); block kThreads. Shared memory (floats):
//   q_s[G*hd] | k_s[kTile*(hd+1)] | v_s[kTile*hd] | p_s[G*kTile] | m,l,corr[G]
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const uint8_t* __restrict__ mask,
                    const int* __restrict__ kv_limit, float* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int n_kv, int G, int S, int hd, long long k_sb,
                    long long k_sh, long long s_sb, long long s_sh,
                    long long mask_sb, float scale, int quantized,
                    int partial) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = n_kv * G;
  const int kld = hd + 1;  // padded K row: conflict-free column reads
  float* q_s = smem;
  float* k_s = q_s + G * hd;
  float* v_s = k_s + kTile * kld;
  float* p_s = v_s + kTile * hd;
  float* m_s = p_s + G * kTile;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const long long q_off = ((long long)b * Hq + (long long)h * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_f(q[q_off + i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

  const KT* kb = k + b * k_sb + h * k_sh;
  const KT* vb = v + b * k_sb + h * k_sh;
  const float* ksb = quantized ? ks + b * s_sb + h * s_sh : nullptr;
  const float* vsb = quantized ? vs + b * s_sb + h * s_sh : nullptr;
  const uint8_t* mb = mask + b * mask_sb;
  const int lim = *kv_limit;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += kTile) {
    if (s0 >= lim) break;  // tile wholly past every live cursor
    const int nvalid = min(kTile, S - s0);
    for (int i = tid; i < nvalid * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const long long off = (long long)(s0 + r) * hd + d;
      float kv_k = to_f(kb[off]), kv_v = to_f(vb[off]);
      if (quantized) {
        kv_k *= ksb[s0 + r];
        kv_v *= vsb[s0 + r];
      }
      k_s[r * kld + d] = kv_k;
      v_s[r * hd + d] = kv_v;
    }
    __syncthreads();
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, r = i - g * kTile;
      if (r < nvalid) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += q_s[g * hd + d] * k_s[r * kld + d];
        p_s[i] = mb[s0 + r] ? dot * scale : kNegInf;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = kNegInf;
      for (int r = lane; r < nvalid; r += 32) mx = fmaxf(mx, p_s[g * kTile + r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < nvalid; r += 32) {
        const float p = expf(p_s[g * kTile + r] - m_new);
        p_s[g * kTile + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < G * hd) {
        const int g = i / hd, d = i - g * hd;
        float a = acc[j] * c_s[g];
        for (int r = 0; r < nvalid; ++r) a += p_s[g * kTile + r] * v_s[r * hd + d];
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * hd) {
      const int g = i / hd;
      o[q_off + i] = partial ? acc[j] : acc[j] / fmaxf(l_s[g], 1e-30f);
    }
  }
  if (tid < G) {
    m_out[(long long)b * Hq + h * G + tid] = m_s[tid];
    l_out[(long long)b * Hq + h * G + tid] = l_s[tid];
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* mask,
                   const void* kv_limit, void* o, void* m, void* l, int B,
                   int n_kv, int G, int S, int hd, long long k_sb,
                   long long k_sh, long long s_sb, long long s_sh,
                   long long mask_sb, float scale, int quantized, int partial,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)G * hd + (size_t)kTile * (hd + 1) + (size_t)kTile * hd +
       (size_t)G * kTile + 3 * (size_t)G);
  auto kern = flash_decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_kv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, (const float*)ks,
      (const float*)vs, (const uint8_t*)mask, (const int*)kv_limit,
      (float*)o, (float*)m, (float*)l, n_kv, G, S, hd, k_sb, k_sh, s_sb,
      s_sh, mask_sb, scale, quantized, partial);
  return cudaGetLastError();
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16. kv_dtype: 0 float32, 1 bfloat16, 2 int8.
// Returns cudaGetLastError() after the launch (9 = invalid configuration
// for an unsupported dtype pair or G*hd above the per-CTA accumulator).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* mask, const void* kv_limit, void* o,
    void* m, void* l, int B, int n_kv, int G, int S, int hd, long long k_sb,
    long long k_sh, long long s_sb, long long s_sh, long long mask_sb,
    float scale, int q_dtype, int kv_dtype, int partial, void* stream) {
  if (G * hd > kThreads * kMaxAcc) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
#define FD_ARGS q, k, v, ks, vs, mask, kv_limit, o, m, l, B, n_kv, G, S, hd, \
                k_sb, k_sh, s_sb, s_sh, mask_sb, scale, kv_dtype == 2, \
                partial, st
  if (q_dtype == 0 && kv_dtype == 0) return (int)launch<float, float>(FD_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return (int)launch<float, int8_t>(FD_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(FD_ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return (int)launch<__nv_bfloat16, int8_t>(FD_ARGS);
#undef FD_ARGS
  return (int)cudaErrorInvalidConfiguration;
}
