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
// int8 weights once at 3.35 TB/s. At the model's shapes that is 0.03-1.3 us:
// a call is short, so it is held by how many bytes are in flight at once.
//
// What the design does about it:
// - The grid splits N into strips of 32 or 64 columns, R into tiles of 8
//   (decode) or 32 rows (prefill: one weight pass serves 32 rows), and K
//   into chunks, so that every main-path shape runs about two CTAs per SM
//   (the host-side plan, gemv/ops.py gemv_plan, picks the split).
// - A CTA stages its whole weight chunk and its x tile in shared memory
//   with 16-byte cp.async copies, all issued before the first wait: each
//   thread has several 16-byte loads in flight and nothing else to do.
// - Each thread owns 4 columns x 8 rows over a strided subset of the
//   chunk's k: a 4x4 byte transpose in registers (__byte_perm) turns four
//   k rows of four columns into per-column words of four k values, so each
//   __dp4a does four multiply-adds. The CUDA cores are not the limit here.
// - The threads' int32 partials are added in shared memory in a fixed
//   order. With one K chunk the CTA applies the scales itself. Otherwise
//   each CTA writes its int32 partial to a (k_splits, R, N) scratch and
//   takes a ticket for its output tile (an integer atomicInc that wraps to
//   zero, so the tickets are clean again after every call); the CTA that
//   draws the last ticket copies the tile's partials into shared memory
//   with cp.async, several chunks per round trip, adds them in a fixed
//   order and applies (float(acc) * xs) * ws once per output
//   (common.cuh split_sum). One launch per call, no float atomics: two
//   calls on the same inputs give the same bits.
// - The kernel is launched as a programmatic dependent of the one before
//   it on the stream: it issues its weight copies (weights are never
//   written by a kernel) before griddepcontrol.wait, so they overlap the
//   previous kernel's tail, and only then reads x.
// - Tails of R, K and N are masked (zero-filled in shared memory).
#include "common.cuh"

namespace {

using port::kThreads;
constexpr int kPadW = 16;      // bytes of padding per shared weight row
constexpr int kRedBytes = kThreads * 32 * 4;   // 8 rows x 4 cols per thread

// Copy 16 bytes src[0:16) of a row into dst, zero past `valid` bytes.
// `wide`: the 16 bytes are in range and 16-byte aligned (cp.async).
__device__ __forceinline__ void stage16(int8_t* dst, const int8_t* src,
                                        int valid, bool wide) {
  if (wide && valid >= 16) {
    port::cp_async16(dst, src);
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b) dst[b] = b < valid ? src[b] : (int8_t)0;
  }
}

__device__ __forceinline__ float scale_out(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// grid (ceil(N / NT), ceil(R / MT), k_splits). Shared memory: the weight
// chunk w_s[KC][NT + kPadW], the x tile x_s[MT][KC]; reused for the int32
// partials red[WK][MT][NT] once both are consumed, then for split_sum.
// tickets: one per (x, y) output tile, zero on entry and on exit.
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads)
gemv_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const float* __restrict__ ws,
                 float* __restrict__ out, int* __restrict__ part,
                 unsigned* __restrict__ tickets, int R, int K, int N, int KC,
                 int wide_w, int wide_x) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int WS = NT + kPadW;
  constexpr int CQ = NT / 4;                 // column quads
  constexpr int RG = MT / 8;                 // row groups of 8
  constexpr int WK = kThreads / (CQ * RG);   // k slices
  int8_t* w_s = smem;
  int8_t* x_s = smem + KC * WS;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * NT, r0 = blockIdx.y * MT;
  const int k0 = blockIdx.z * KC;

  for (int i = tid; i < KC * (NT / 16); i += kThreads) {
    const int kr = i / (NT / 16), c = (i - kr * (NT / 16)) * 16;
    const int k = k0 + kr, n = n0 + c;
    const int valid = k < K ? min(16, N - n) : 0;
    stage16(w_s + kr * WS + c, wq + (long long)k * N + n, valid, wide_w);
  }
  port::grid_dep_wait();           // x comes from the kernel before this
  for (int i = tid; i < MT * (KC / 16); i += kThreads) {
    const int r = i / (KC / 16), c = (i - r * (KC / 16)) * 16;
    const int k = k0 + c;
    const int valid = r0 + r < R ? min(16, K - k) : 0;
    stage16(x_s + r * KC + c, xq + (long long)(r0 + r) * K + k, valid,
            wide_x);
  }
  port::cp_async_wait_all();
  __syncthreads();
  port::grid_dep_launch();

  const int cq = tid % CQ, rg = (tid / CQ) % RG, ks = tid / (CQ * RG);
  int acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;
  const int8_t* xr = x_s + rg * 8 * KC;
#pragma unroll 2
  for (int k4 = ks; k4 < KC / 4; k4 += WK) {
    const int8_t* wp = w_s + k4 * 4 * WS + cq * 4;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wp + WS);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wp + 2 * WS);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wp + 3 * WS);
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
    for (int r = 0; r < 8; ++r) {
      const int xw = *reinterpret_cast<const int*>(xr + r * KC + k4 * 4);
      acc[r][0] = __dp4a(xw, col0, acc[r][0]);
      acc[r][1] = __dp4a(xw, col1, acc[r][1]);
      acc[r][2] = __dp4a(xw, col2, acc[r][2]);
      acc[r][3] = __dp4a(xw, col3, acc[r][3]);
    }
  }
  __syncthreads();  // w_s and x_s are dead: reuse the buffer for partials
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    *reinterpret_cast<int4*>(red + (ks * MT + rg * 8 + r) * NT + cq * 4) =
        make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const bool split = gridDim.z > 1;
  for (int i = tid; i < MT * NT; i += kThreads) {
    const int r = i / NT, c = i - r * NT, row = r0 + r, n = n0 + c;
    if (row >= R || n >= N) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < WK; ++w) s += red[(w * MT + r) * NT + c];
    if (split)
      part[((long long)blockIdx.z * R + row) * N + n] = s;
    else
      out[(long long)row * N + n] = scale_out(s, xs[row], ws[n]);
  }
  if (!split || !port::last_of_split(tickets)) return;
  port::split_sum<int, MT, NT>(
      part, R, N, r0, n0, gridDim.z, smem, kRedBytes,
      [&](int r, int c, int s) {
        const int row = r0 + r, n = n0 + c;
        out[(long long)row * N + n] = scale_out(s, xs[row], ws[n]);
      });
}

size_t smem_bytes(int MT, int NT, int KC) {
  const size_t tiles = (size_t)KC * (NT + kPadW) + (size_t)MT * KC;
  return tiles > (size_t)kRedBytes ? tiles : (size_t)kRedBytes;
}

template <int MT, int NT>
cudaError_t launch(const void* xq, const void* xs, const void* wq,
                   const void* ws, void* out, void* part, void* tickets,
                   int R, int K, int N, int KC, int k_splits, int wide_w,
                   int wide_x, cudaStream_t stream) {
  return port::launch_kernel(
      gemv_int8_kernel<MT, NT>,
      dim3((N + NT - 1) / NT, (R + MT - 1) / MT, k_splits),
      smem_bytes(MT, NT, KC), stream, 1, true, (const int8_t*)xq,
      (const float*)xs, (const int8_t*)wq, (const float*)ws, (float*)out,
      (int*)part, (unsigned*)tickets, R, K, N, KC, wide_w, wide_x);
}

}  // namespace

// xq (R,K) int8, xs (R) f32, wq (K,N) int8, ws (N) f32, out (R,N) f32, all
// contiguous. The plan (rows per CTA 8 or 32, columns per CTA 32 or 64,
// k_chunk a multiple of 16 with k_chunk * k_splits >= K) comes from
// gemv/ops.py gemv_plan. With k_splits > 1, part holds k_splits * R * N
// int32 and tickets one zeroed uint32 per output tile (both unused
// otherwise). wide_w: N % 16 == 0 and wq 16-byte aligned; wide_x: K % 16
// == 0 and xq 16-byte aligned (cp.async copies, else byte copies).
// Returns cudaGetLastError() after the launch.
extern "C" int gemv_int8_launch(const void* xq, const void* xs,
                                const void* wq, const void* ws, void* out,
                                void* part, void* tickets, int R, int K,
                                int N, int rows, int cols, int k_chunk,
                                int k_splits, int wide_w, int wide_x,
                                void* stream) {
  if (k_chunk <= 0 || k_chunk % 16 != 0 || k_splits <= 0 ||
      (long long)k_chunk * k_splits < K ||
      (k_splits > 1 && (long long)k_chunk * (k_splits - 1) >= K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t (*go)(const void*, const void*, const void*, const void*,
                    void*, void*, void*, int, int, int, int, int, int, int,
                    cudaStream_t) = nullptr;
  if (rows == 8 && cols == 32) go = launch<8, 32>;
  if (rows == 8 && cols == 64) go = launch<8, 64>;
  if (rows == 32 && cols == 32) go = launch<32, 32>;
  if (rows == 32 && cols == 64) go = launch<32, 64>;
  if (go == nullptr) return (int)cudaErrorInvalidValue;
  return (int)go(xq, xs, wq, ws, out, part, tickets, R, K, N, k_chunk,
                 k_splits, wide_w, wide_x, st);
}
