// K3: fused gated FFN, out = (act(x Wg) * (x Wu)) Wd, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_ffn/fused_ffn.py
// (fused_ffn_pallas): act is silu or tanh-gelu, accumulation is f32 and the
// gated intermediate h stays f32 up to its product with Wd
// (fused_ffn.py:36-39).
//
// What bounds it on the H100: bytes at decode widths. For qwen2-0.5b one
// call reads 3 * 896 * 4864 bf16 weights (26 MB) and does 2 * 3 * 4.4M
// flops per row: about 3 flop/byte per row, far below the ~295 flop/byte of
// the tensor cores, so the floor is streaming the weights once at
// 3.35 TB/s (7.8 us). At prefill widths (32-128 rows) f32 FMAs on the CUDA
// cores would approach that floor, so the bf16 products run on the tensor
// cores. A call is short, so what holds it is how many bytes are in flight
// at once and how many round trips each CTA waits for.
//
// What the design does about it: two launches from one call, all sums in
// a fixed order (deterministic, no float atomics). Both kernels tile their
// weights in 64-column strips (128-byte rows) and stage a CTA's whole
// weight chunk and its operand rows in shared memory with 16-byte cp.async
// copies, all in flight at once; each warp then owns 8 of the 64 columns
// over the whole chunk, so no warp waits on global memory inside its loop.
// 1. gate_up: CTA (x, y, z) owns F columns [64x, 64x + 64), an MT-row tile
//    (MT = 16, 32 or 64: one weight pass serves up to 64 rows) and D chunk
//    z; at qwen2-0.5b's widths that is 76 x 4 = 304 CTAs of 57 KB of
//    weights, three per SM, all resident. For bf16 each warp runs
//    mma.sync.m16n8k16 (bf16 x bf16 -> f32; the products are exact in
//    f32, so this adds no rounding) with B fragments from ldmatrix.trans
//    on a swizzled tile; f32 inputs take the same tiles through FMAs on the
//    CUDA cores. The D chunks of one strip form a thread block cluster:
//    each CTA leaves its g and u partials in shared memory, and after a
//    cluster barrier each CTA adds one slice of the tile across the
//    cluster's shared memory in chunk order and writes h = act(g) * u to
//    an (R, F) f32 scratch that stays in L2 (155 KB at 8 rows).
// 2. down: CTA (x, y, z) owns D columns [64x, 64x + 64), the row tile and
//    F chunk z (the host plan, fused_ffn/ops.py ffn_plan, sizes the chunks
//    for about two CTAs per SM). h stays f32: for bf16 Wd each f32 pair of
//    h is split into three bf16 parts (hi + mid + lo carry all 24 bits of
//    the f32 significand) and each part goes through its own mma, so no
//    rounding point is added; f32 Wd runs on the CUDA cores. With one chunk
//    the CTA writes out. Otherwise its f32 partial goes to a (splits, R, D)
//    scratch (0.55 MB at 8 rows, 6% of Wd's bytes) and the last CTA of
//    each output tile, by ticket, adds the chunks in order 0, 1, ... into
//    out (common.cuh split_sum).
// Both kernels are launched as programmatic dependents of the kernel
// before them on the stream: they issue their weight copies (weights are
// never written by a kernel) before griddepcontrol.wait and read x or h
// only after it, and gate_up lets down launch once its tiles are staged,
// so Wd streams in while gate_up computes.
// Tails of R, D and F are masked (zero-filled tiles), so no extent has to
// divide a tile.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using port::kThreads;
constexpr int kCols = 64;              // weight columns per CTA, 8 per warp
constexpr int kPadA = 8;               // elements of padding per operand row

__device__ __forceinline__ float activate(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));  // silu
  // tanh-approximated gelu (jax.nn.gelu's default form)
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f *
                                 (g + 0.044715f * g * g * g)));
}

__device__ __forceinline__ float to_f(float v) { return v; }

// A weight tile of ROWS x 64 elements of T in shared memory: rows of
// 16-byte chunks, the chunk index XOR-swizzled by the row so that the eight
// row addresses of an ldmatrix land in eight different bank groups.
template <typename T>
struct Tile {
  static constexpr int kEpc = 16 / sizeof(T);       // elements per chunk
  static constexpr int kChunks = kCols / kEpc;      // 8 or 16 per row
  __device__ static int chunk(int d, int c) { return c ^ (d & 7); }
  __device__ static int off(int d, int n) {         // element offset
    return d * kCols + chunk(d, n / kEpc) * kEpc + n % kEpc;
  }
};

// Stage tile rows [d_lo, d_hi) (matrix rows k0 + d) x columns [n0, n0 + 64)
// of the row-major (K, N) matrix w into a Tile, zero outside. `wide`:
// N * sizeof(T) is a multiple of 16 and w 16-byte aligned (cp.async
// copies, complete at a later cp.async wait).
template <typename T>
__device__ __forceinline__ void stage_tile(T* tile, const T* __restrict__ w,
                                           int k0, int d_lo, int d_hi, int n0,
                                           int K, int N, bool wide) {
  using TL = Tile<T>;
  for (int i = threadIdx.x; i < (d_hi - d_lo) * TL::kChunks; i += kThreads) {
    const int d = d_lo + i / TL::kChunks, c = i % TL::kChunks;
    const int k = k0 + d, n = n0 + c * TL::kEpc;
    T* dst = tile + d * kCols + TL::chunk(d, c) * TL::kEpc;
    const T* src = w + (long long)k * N + n;
    const int valid = k < K ? min(TL::kEpc, N - n) : 0;
    if (wide && valid == TL::kEpc) {
      port::cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < TL::kEpc; ++e)
        dst[e] = e < valid ? src[e] : T(0.f);
    }
  }
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 ldcg(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// Load rows [r0, r0 + rows) x columns [k0, k0 + KC) of the row-major
// (R, K) operand a into dst (row stride KC + kPadA), zero outside; 16-byte
// loads where `wide`. The operand was written by an earlier kernel, so the
// loads go to L2 (ld.global.cg). The padding keeps a warp's fragment loads
// on distinct banks.
template <typename A>
__device__ __forceinline__ void load_rows(A* dst, const A* __restrict__ a,
                                          int r0, int rows, int k0, int KC,
                                          int R, int K, bool wide) {
  constexpr int kE = 16 / sizeof(A);
  const int AS = KC + kPadA;
  for (int i = threadIdx.x; i < rows * (KC / kE); i += kThreads) {
    const int r = i / (KC / kE), c = (i - r * (KC / kE)) * kE;
    A* d = dst + r * AS + c;
    const A* s = a + (long long)(r0 + r) * K + k0 + c;
    const int valid = r0 + r < R ? min(kE, K - k0 - c) : 0;
    if (wide && valid == kE) {
      *reinterpret_cast<uint4*>(d) = __ldcg(reinterpret_cast<const uint4*>(s));
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) d[e] = e < valid ? ldcg(s + e) : A(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         (uint32_t)__bfloat16_as_ushort(hi) << 16;
}

// hi + mid + lo == v to the last bit of v's 24-bit significand (barring
// underflow of the lowest part), each part a bf16.
__device__ __forceinline__ void split3(float2 v, uint32_t* hi, uint32_t* mid,
                                      uint32_t* lo) {
  const bf16 h0 = __float2bfloat16_rn(v.x), h1 = __float2bfloat16_rn(v.y);
  const float r0 = v.x - __bfloat162float(h0), r1 = v.y - __bfloat162float(h1);
  const bf16 m0 = __float2bfloat16_rn(r0), m1 = __float2bfloat16_rn(r1);
  const bf16 l0 = __float2bfloat16_rn(r0 - __bfloat162float(m0));
  const bf16 l1 = __float2bfloat16_rn(r1 - __bfloat162float(m1));
  *hi = pack2(h0, h1);
  *mid = pack2(m0, m1);
  *lo = pack2(l0, l1);
}

// Fragment layout of mma.sync m16n8k16 (row.col), lane = 4g + t:
// A a[0..3] = (row g, k 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..);
// B b[0..1] = (k 2t..2t+1, col g), (k 2t+8.., col g);
// C c[0..3] = (row g, col 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// The FMA path on the CUDA cores keeps the same C layout.

// A fragment of rows [r, r + 16) x k [kb, kb + 16) of a bf16 operand tile.
__device__ __forceinline__ void a_frag(const bf16* a_s, int AS, int r, int kb,
                                       uint32_t a[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = a_s + (r + g) * AS + kb + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * AS);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * AS + 8);
}

// The same from an f32 operand tile, split into hi, mid and lo fragments.
__device__ __forceinline__ void a_frag3(const float* a_s, int AS, int r,
                                        int kb, uint32_t a[3][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = a_s + (r + g) * AS + kb + 2 * t;
  const float2 v[4] = {*reinterpret_cast<const float2*>(p),
                       *reinterpret_cast<const float2*>(p + 8 * AS),
                       *reinterpret_cast<const float2*>(p + 8),
                       *reinterpret_cast<const float2*>(p + 8 * AS + 8)};
#pragma unroll
  for (int q = 0; q < 4; ++q) split3(v[q], &a[0][q], &a[1][q], &a[2][q]);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of two n8 tiles (columns n..n+15) for k rows kb..kb+15:
// b[0], b[1] for the first tile, b[2], b[3] for the second.
__device__ __forceinline__ void b_frag2(const bf16* tile, int kb, int n,
                                        uint32_t b[4]) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  const int k = kb + (lane & 7) + 8 * (m & 1), col = n + 8 * (m >> 1);
  const unsigned addr = (unsigned)__cvta_generic_to_shared(
      tile + Tile<bf16>::off(k, col));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// One warp's k step kb: rows [ar, ar + 16) of the operand tile a_s times
// columns [n, n + 8 * NTW) of the weight tile w_s, into c[j] (n8 tile j).
// bf16 weights run on the tensor cores (an f32 operand as three bf16
// parts), f32 weights on the CUDA cores with the same C layout.
template <typename T, typename A, int NTW>
__device__ __forceinline__ void warp_step(const A* a_s, int AS, int ar,
                                          const T* w_s, int kb, int n,
                                          float c[NTW][4]) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int P = std::is_same<A, bf16>::value ? 1 : 3;
    uint32_t a[P][4];
    if constexpr (P == 1)
      a_frag(a_s, AS, ar, kb, a[0]);
    else
      a_frag3(a_s, AS, ar, kb, a);
#pragma unroll
    for (int j = 0; j < NTW; j += 2) {
      uint32_t b[4];
      b_frag2(w_s, kb, n + 8 * j, b);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        mma_bf16(c[j], a[p], b);
        mma_bf16(c[j + 1], a[p], b + 2);
      }
    }
  } else {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int k = kb; k < kb + 16; ++k) {
      const float xa = to_f(a_s[(ar + g) * AS + k]);
      const float xb = to_f(a_s[(ar + g + 8) * AS + k]);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const float b0 = to_f(w_s[Tile<T>::off(k, n + 8 * j + 2 * t)]);
        const float b1 = to_f(w_s[Tile<T>::off(k, n + 8 * j + 2 * t + 1)]);
        c[j][0] += xa * b0;
        c[j][1] += xa * b1;
        c[j][2] += xb * b0;
        c[j][3] += xb * b1;
      }
    }
  }
}

// Warp layout shared by both kernels: 8 warps = WM m tiles (16 rows each)
// x WN column groups (64 / WN columns) x WK k slices; warp (wm, wn, wk)
// takes k steps wk, wk + WK, ... of every stage.
template <int MT, int WN>
struct Warps {
  static constexpr int WM = MT / 16, WK = 8 / (WM * WN);
  static constexpr int NTW = kCols / WN / 8;          // n8 tiles per warp
  static_assert(WM * WN * WK == 8, "8 warps");
  int wm, wk, n;                              // n: first column
  __device__ Warps() {
    const int w = threadIdx.x >> 5;
    wm = w % WM;
    n = (w / WM) % WN * (kCols / WN);
    wk = w / (WM * WN);
  }
};

// Rows of a CTA's chunk are staged in up to kStages cp.async groups of
// `rows` rows each (a multiple of 16 * WK, so each group holds whole k
// steps of every warp); compute on a group starts once it has landed.
constexpr int kStages = 4;
__host__ __device__ inline int stage_rows(int chunk, int wk) {
  const int step = 16 * wk;
  const int per = (chunk + kStages - 1) / kStages;
  return (per + step - 1) / step * step;
}

// A warp's C fragments (rows r0w.., columns n..) into an MT x 64 f32
// plane of shared memory.
template <int NTW>
__device__ __forceinline__ void put_frags(float* red, int r0w, int n,
                                          const float c[NTW][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0w + g + 8 * (q >> 1), col = n + 8 * j + 2 * t + (q & 1);
      red[r * kCols + col] = c[j][q];
    }
}

// gate_up streams its Wg and Wu chunk through a ring of kRing slots of
// kRingRows rows each, so that it holds little shared memory and the down
// kernel's CTAs, launched early, fit beside it and stage Wd meanwhile.
constexpr int kRing = 3, kRingRows = 32;

__host__ __device__ inline size_t gate_up_smem(int itemsize, int MT,
                                               int DC) {
  const size_t tiles = (size_t)itemsize *
                       (2 * kRing * kRingRows * kCols +
                        (size_t)MT * (DC + kPadA));
  const size_t red = sizeof(float) * 2 * MT * kCols * (MT == 16 ? 2 : 1);
  return tiles > red ? tiles : red;
}

// grid (ceil(F / 64), ceil(R / MT), DS), clusters of (1, 1, DS): CTA z
// takes D rows [z * DC, z * DC + DC). Shared memory: the ring of Wg and
// Wu slots [kRing][2][kRingRows][64] and the x tile [MT][DC + kPadA];
// then the warps' partials red[WK][2][MT][64] f32, summed into red[0],
// which the cluster reads.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
               const T* __restrict__ wu, float* __restrict__ h, int R,
               int D, int F, int DC, int act, int wide_w, int wide_x) {
  using W = Warps<MT, (MT == 64 ? 2 : 4)>;
  static_assert(kRingRows % (16 * W::WK) == 0, "whole k steps per slot");
  constexpr int kSlot = kRingRows * kCols;    // elements of one matrix
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // slot i: Wg at 2i, Wu 2i+1
  T* x_s = ring + 2 * kRing * kSlot;
  const int XS = DC + kPadA;
  const int f0 = blockIdx.x * kCols, r0 = blockIdx.y * MT;
  const int d0 = blockIdx.z * DC;
  const int S = (DC + kRingRows - 1) / kRingRows;
  auto issue = [&](int s) {                   // stage s into its slot
    if (s < S) {
      T* slot = ring + 2 * (s % kRing) * kSlot;
      const int rows = min(kRingRows, DC - s * kRingRows);
      stage_tile<T>(slot, wg, d0 + s * kRingRows, 0, rows, f0, D, F, wide_w);
      stage_tile<T>(slot + kSlot, wu, d0 + s * kRingRows, 0, rows, f0, D, F,
                    wide_w);
    }
    port::cp_async_commit();
  };
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  port::grid_dep_wait();            // x comes from the kernel before this
  load_rows<T>(x_s, x, r0, MT, d0, DC, R, D, wide_x);
  port::grid_dep_launch();

  const W w;
  float acc[2][W::NTW][4] = {};               // [gate/up][n tile][frag]
  for (int s = 0; s < S; ++s) {
    port::cp_async_wait_pending(kRing - 2);   // stage s has landed
    __syncthreads();                          // and stage s - 1 is consumed
    issue(s + kRing - 1);
    const T* slot = ring + 2 * (s % kRing) * kSlot;
    const int rows = min(kRingRows, DC - s * kRingRows);
    for (int kb = 16 * w.wk; kb < rows; kb += 16 * W::WK) {
      warp_step<T, T, W::NTW>(x_s + s * kRingRows, XS, 16 * w.wm, slot, kb,
                              w.n, acc[0]);
      warp_step<T, T, W::NTW>(x_s + s * kRingRows, XS, 16 * w.wm,
                              slot + kSlot, kb, w.n, acc[1]);
    }
  }
  port::cp_async_wait_all();
  __syncthreads();                            // tiles dead: partials next
  float* red = reinterpret_cast<float*>(smem_raw);
  const int plane = MT * kCols;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    put_frags<W::NTW>(red + (w.wk * 2 + j) * plane, 16 * w.wm, w.n, acc[j]);
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * plane; i += kThreads)
    for (int k = 1; k < W::WK; ++k) red[i] += red[k * 2 * plane + i];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int DS = gridDim.z, rank = blockIdx.z;
  for (int i = rank * kThreads + threadIdx.x; i < plane; i += DS * kThreads) {
    const int r = i / kCols, c = i - r * kCols, row = r0 + r, f = f0 + c;
    if (row >= R || f >= F) continue;
    float gs = 0.f, us = 0.f;
    for (int z = 0; z < DS; ++z) {
      const float* p = cluster.map_shared_rank(red, z);
      gs += p[i];
      us += p[plane + i];
    }
    h[(long long)row * F + f] = activate(gs, act) * us;
  }
  cluster.sync();       // the others may still read this CTA's partials
}

// The Wd and h tiles, and the warps' partials red[WK][MT][64] f32.
__host__ __device__ inline size_t down_smem(int itemsize, int MT, int FC) {
  const size_t tiles = (size_t)FC * kCols * itemsize +
                       (size_t)MT * (FC + kPadA) * sizeof(float);
  const size_t red = (size_t)(128 / MT) * MT * kCols * sizeof(float);
  return tiles > red ? tiles : red;
}

// grid (ceil(D / 64), ceil(R / MT), splits): CTA z takes F rows
// [z * FC, z * FC + FC). Shared memory: the Wd tile [FC][64] and the h
// tile [MT][FC + kPadA]; then the warps' partials red[WK][MT][64], then
// split_sum's buffer. With one split the CTA writes out; otherwise part
// (splits, R, D) takes its partial and the last CTA of each (x, y) tile,
// by ticket, adds the splits in order into out.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
down_kernel(const float* __restrict__ h, const T* __restrict__ wd,
            float* __restrict__ part, float* __restrict__ out,
            unsigned* __restrict__ tickets, int R, int D, int F, int FC,
            int wide_w, int wide_h) {
  using W = Warps<MT, 1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  float* h_s = reinterpret_cast<float*>(w_s + FC * kCols);
  const int HS = FC + kPadA;
  const int n0 = blockIdx.x * kCols, r0 = blockIdx.y * MT;
  const int f0 = blockIdx.z * FC;
  const W w;
  const int SR = stage_rows(FC, W::WK);
  const int S = (FC + SR - 1) / SR;
  for (int s = 0; s < S; ++s) {
    stage_tile<T>(w_s, wd, f0, s * SR, min(FC, (s + 1) * SR), n0, F, D,
                  wide_w);
    port::cp_async_commit();
  }
  port::grid_dep_wait();            // h comes from gate_up
  load_rows<float>(h_s, h, r0, MT, f0, FC, R, F, wide_h);

  float acc[W::NTW][4] = {};
  for (int s = 0; s < S; ++s) {
    port::cp_async_wait_pending(S - 1 - s);
    __syncthreads();
    const int hi = min(FC, (s + 1) * SR);
    for (int kb = s * SR + 16 * w.wk; kb < hi; kb += 16 * W::WK)
      warp_step<T, float, W::NTW>(h_s, HS, 16 * w.wm, w_s, kb, 0, acc);
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);
  const int plane = MT * kCols;
  put_frags<W::NTW>(red + w.wk * plane, 16 * w.wm, 0, acc);
  __syncthreads();
  const bool split = gridDim.z > 1;
  for (int i = threadIdx.x; i < plane; i += kThreads) {
    const int r = i / kCols, c = i - r * kCols, row = r0 + r, col = n0 + c;
    if (row >= R || col >= D) continue;
    float v = red[i];
    for (int k = 1; k < W::WK; ++k) v += red[k * plane + i];
    if (split)
      part[((long long)blockIdx.z * R + row) * D + col] = v;
    else
      out[(long long)row * D + col] = v;
  }
  if (!split || !port::last_of_split(tickets)) return;
  port::split_sum<float, MT, kCols>(
      part, R, D, r0, n0, gridDim.z, smem_raw,
      (int)down_smem(sizeof(T), MT, FC), [&](int r, int c, float v) {
        out[(long long)(r0 + r) * D + n0 + c] = v;
      });
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int MT>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, float* scratch, unsigned* tickets,
                   float* out, int R, int D, int F, int act, int DC, int DS,
                   int FC, int FS, cudaStream_t stream) {
  const size_t smem_a = gate_up_smem(sizeof(T), MT, DC);
  const int sz = (int)sizeof(T);
  const int wide_gu = F * sz % 16 == 0 && aligned16(wg) && aligned16(wu);
  const int wide_x = D * sz % 16 == 0 && aligned16(x);
  const int wide_d = D * sz % 16 == 0 && aligned16(wd);
  float* h = scratch;
  float* part = scratch + (size_t)R * F;
  const int wide_h = F % 4 == 0;
  cudaError_t e = port::launch_kernel(
      gate_up_kernel<T, MT>,
      dim3((F + kCols - 1) / kCols, (R + MT - 1) / MT, DS), smem_a, stream,
      DS, true, (const T*)x, (const T*)wg, (const T*)wu, h, R, D, F, DC, act,
      wide_gu, wide_x);
  if (e != cudaSuccess) return e;
  return port::launch_kernel(
      down_kernel<T, MT>,
      dim3((D + kCols - 1) / kCols, (R + MT - 1) / MT, FS),
      down_smem(sz, MT, FC), stream, 1, true, (const float*)h, (const T*)wd,
      part, out, tickets, R, D, F, FC, wide_d, wide_h);
}

template <typename T>
cudaError_t launch_rows(int rows, const void* x, const void* wg,
                        const void* wu, const void* wd, float* scratch,
                        unsigned* tickets, float* out, int R, int D, int F,
                        int act, int DC, int DS, int FC, int FS,
                        cudaStream_t st) {
  auto go = rows == 16 ? launch<T, 16>
            : rows == 32 ? launch<T, 32>
            : rows == 64 ? launch<T, 64> : nullptr;
  if (go == nullptr) return cudaErrorInvalidValue;
  return go(x, wg, wu, wd, scratch, tickets, out, R, D, F, act, DC, DS, FC,
            FS, st);
}

bool chunks_ok(int chunk, int splits, int extent, bool allow_empty) {
  if (chunk <= 0 || chunk % 16 != 0 || splits <= 0 ||
      (long long)chunk * splits < extent)
    return false;
  return allow_empty || splits == 1 ||
         (long long)chunk * (splits - 1) < extent;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x and all three weights). act: 0 silu,
// 1 tanh-gelu. The plan comes from fused_ffn/ops.py ffn_plan: rows per CTA
// 16, 32 or 64; gate_up's D chunk d_chunk (a multiple of 16) and d_splits
// (1, 2, 4 or 8, the cluster size); down's F chunk f_chunk (a multiple of
// 16) and f_splits. scratch: R * F f32 for h, then f_splits * R * D f32
// for the down partials when f_splits > 1; tickets: one zeroed uint32 per
// down output tile; out: (R, D) f32. Returns cudaGetLastError() after the
// launches.
extern "C" int fused_ffn_launch(const void* x, const void* wg, const void* wu,
                                const void* wd, void* scratch, void* tickets,
                                void* out, int R, int D, int F, int act,
                                int dtype, int rows, int d_chunk,
                                int d_splits, int f_chunk, int f_splits,
                                void* stream) {
  if (!chunks_ok(d_chunk, d_splits, D, true) || d_splits > 8 ||
      (d_splits & (d_splits - 1)) != 0 ||
      !chunks_ok(f_chunk, f_splits, F, false))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* s = (float*)scratch;
  unsigned* tix = (unsigned*)tickets;
  float* o = (float*)out;
  if (dtype == 0)
    return (int)launch_rows<float>(rows, x, wg, wu, wd, s, tix, o, R, D, F,
                                   act, d_chunk, d_splits, f_chunk, f_splits,
                                   st);
  if (dtype == 1)
    return (int)launch_rows<bf16>(rows, x, wg, wu, wd, s, tix, o, R, D, F,
                                  act, d_chunk, d_splits, f_chunk, f_splits,
                                  st);
  return (int)cudaErrorInvalidValue;
}
