// K1: single-query GQA flash decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_decode/flash_decode.py
// (flash_decode_pallas, body _kernel): one query per sequence against a
// contiguous (B, n_kv, S, hd) KV cache, f32 online softmax, optional int8
// KV with per-position f32 scales, a device-side kv_limit that skips whole
// tiles, and a partial_stats mode that returns the raw (o, m, l)
// statistics for a split-KV merge.
//
// What bounds it on the H100: bytes. Each KV byte feeds 2*G flops (G = 7
// query heads per KV head for qwen2-0.5b), far below the ~295 flop/byte
// the card needs to be compute bound, so the floor is reading the live KV
// prefix once at 3.35 TB/s. At the decode path's shapes (B=8, 2 KV heads,
// S <= 200: under 1 MB a call) that floor is a fraction of a microsecond,
// so what a call costs is its chain of round trips to memory and how many
// SMs have bytes in flight; at long context the CUDA cores' share of the
// work (a dot product and a weighted sum per position and head) would
// outlast the bytes, so it runs on the tensor cores.
//
// What the design does about it:
// - S is split across CTAs (flash-decoding): grid (n_kv, B, splits); CTA
//   z owns positions [z*split, min((z+1)*split, S)). The host-side plan
//   (flash_decode/ops.py decode_plan) picks split (a multiple of 16) so
//   that the grid fills the card, and one split where B*n_kv already does.
// - Every thread issues all of its 16-byte cp.async copies of the split's
//   K and V rows, and 4-byte ones of the int8 scales, before one wait; the
//   mask bytes are loaded into a register beside them. A split longer than
//   a ring stage streams through two stages. K/V stay in shared memory in
//   their stored type, rows padded by 16 bytes so that fragment loads hit
//   eight bank groups. Positions past the end of the split are never
//   loaded; the V rows up to the next multiple of 16 are zero-filled (their
//   softmax weight is 0, but 0 * NaN is not). Rows whose base or strides
//   are not 16-byte aligned take a plain element copy instead of cp.async.
// - Each warp takes 16-position m tiles of a tile in turn. Scores S = K q^T
//   and the output O^T += V^T P^T run on mma.sync m16n8k16 (bf16 in, f32
//   accumulate), the G <= 8 heads of a KV head as the n8 side, q in
//   registers as B fragments. Int8 K/V enter as bf16, which holds every
//   int8 value exactly; an f32 operand (f32 q, f32 K/V, and always the f32
//   softmax weights P) is split into three bf16 parts (hi + mid + lo = the
//   value to its last bit) and each part pair whose significance reaches
//   the f32 result goes through its own mma. The products are exact, so
//   the tensor cores add no rounding point; only the f32 summation order
//   differs from the plain version. The online softmax runs on the score
//   fragments inside the warp (xor shuffles over the 8 lanes of a column),
//   so QK, softmax and PV need no barrier between them, only __syncwarp.
// - Int8 KV: the dot product runs on the int8 values and the position's K
//   scale is applied once per score; the V scale is folded into the
//   position's softmax weight (after that weight is added into l). The
//   plain version scales K and V first, so f32 rounding is reordered
//   (about an ulp per product), well inside the stated tolerance of
//   1e-5 * max(1, max|plain|).
// - The warps' (o, m, l) merge in shared memory in warp order with the
//   LSE merge of repro/kernels/flash_decode/combine.py. With one split the
//   CTA writes the output. Otherwise it writes its raw (o, m, l) to f32
//   scratch (B, n_kv, splits, G, hd) | (B, n_kv, splits, G) x 2 and takes a
//   ticket (common.cuh last_of_split); the last CTA of each (b, kv head)
//   merges the splits in split order and normalises by max(l, 1e-30), or
//   returns the merged triple under partial_stats. No float atomics: two
//   calls on the same inputs give the same bits. Tickets wrap to zero and
//   scratch comes from the caller, so a launch can be captured in a CUDA
//   graph.
// - It is launched as a programmatic dependent of the kernel before it
//   (ops.py PDL; tools/plan_sweep.py measures both): every input comes
//   from earlier kernels, so it waits before its first read, and it lets
//   the next kernel launch once its first tile has landed.
//
// Edge behaviour is the Pallas walk's, with a tile of this kernel in place
// of a Pallas block: masked scores are NEG_INF = -1e30 (finite); a tile
// whose first position is at or past kv_limit is not loaded, and a split
// with no tile reports the merge identity (0, NEG_INF, 0); a split in
// which a row has no live position reports m = NEG_INF, l = the positions
// it processed and o = their V sum, which the merge weights 0 against any
// live split and which averages V uniformly when every split is dead; a
// call whose kv_limit is <= 0 returns 0, or exactly (0, NEG_INF, 0).
#include "common.cuh"

#include <cuda_bf16.h>
#include <type_traits>

namespace {

using port::kThreads;
using bf16 = __nv_bfloat16;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;           // query heads per KV head: the mma's n8
constexpr int kMaxWidth = 1024;    // G * hd: merge buffer, 4 outputs/thread
constexpr int kMaxTile = 1024;     // positions per tile
constexpr int kMaskRegs = kMaxTile / kThreads;   // mask bytes per thread
constexpr int kSplitChunk = 16;    // splits the last CTA stages at a time
constexpr int kPadBytes = 16;      // padding of a K/V row in shared memory
constexpr int kPRow = 20;          // floats per head row of a warp's P tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Byte offsets into dynamic shared memory (flash_decode/ops.py smem_bytes
// computes the same total). A ring stage holds a tile's K rows, V rows
// (hd * itemsize + 16 bytes each), K and V scales (int8 only) and live
// flags. Once the last tile is consumed the ring region holds the merge:
// o partials of the 8 warps (or of up to kSplitChunk splits) x G x hd,
// then m and l (max(8, splits) x G each) and the merged M and l of each
// head. The warps' P tiles (8 heads x kPRow floats each) come last.
struct Layout {
  int k, v, ks, vs, live, stage, o, ml, scores, total;
};

__host__ __device__ inline Layout layout(int tile, int stages, int splits,
                                         int G, int hd, int isz) {
  Layout L;
  const int kv = align16(tile * (hd * isz + kPadBytes));
  const int sc = isz == 1 ? align16(tile * 4) : 0;
  L.k = 0;
  L.v = kv;
  L.ks = 2 * kv;
  L.vs = 2 * kv + sc;
  L.live = 2 * kv + 2 * sc;
  L.stage = L.live + align16(tile);
  const int zc = splits < kSplitChunk ? splits : kSplitChunk;
  const int o_rows = zc > kWarps ? zc : kWarps;
  const int ml_rows = splits > kWarps ? splits : kWarps;
  L.o = 0;
  L.ml = align16(o_rows * G * hd * 4);
  const int merge = L.ml + align16((2 * ml_rows * G + 2 * kMaxG) * 4);
  const int ring = stages * L.stage;
  L.scores = ring > merge ? ring : merge;
  L.total = L.scores + kWarps * kMaxG * kPRow * 4;
  return L;
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         (uint32_t)__bfloat16_as_ushort(hi) << 16;
}

// hi + mid + lo == x (and y) to the last bit of the 24-bit significand
// (barring underflow of the lowest part), each part a bf16: w[0..2].
__device__ __forceinline__ void split3(float x, float y, uint32_t w[3]) {
  const bf16 h0 = __float2bfloat16_rn(x), h1 = __float2bfloat16_rn(y);
  const float r0 = x - __bfloat162float(h0), r1 = y - __bfloat162float(h1);
  const bf16 m0 = __float2bfloat16_rn(r0), m1 = __float2bfloat16_rn(r1);
  w[0] = pack2(h0, h1);
  w[1] = pack2(m0, m1);
  w[2] = pack2(__float2bfloat16_rn(r0 - __bfloat162float(m0)),
               __float2bfloat16_rn(r1 - __bfloat162float(m1)));
}

// bf16 parts an operand of type T takes: 3 for f32, 1 (exact) otherwise.
template <typename T>
constexpr int kParts = std::is_same_v<T, float> ? 3 : 1;

// Two values of T as kParts<T> bf16x2 words.
template <typename T>
__device__ __forceinline__ void pack_pair(T x, T y, uint32_t* w) {
  if constexpr (std::is_same_v<T, float>) {
    split3(x, y, w);
  } else if constexpr (std::is_same_v<T, bf16>) {
    w[0] = pack2(x, y);
  } else {
    w[0] = pack2(__float2bfloat16_rn((float)x), __float2bfloat16_rn((float)y));
  }
}

// Fragment layout of mma.sync m16n8k16 (row.col), lane = 4 * gid + tg:
// A a[0..3] = (row gid, k 2tg..2tg+1), (gid+8, 2tg..), (gid, 2tg+8..),
//             (gid+8, 2tg+8..);
// B b[0..1] = (k 2tg..2tg+1, col gid), (k 2tg+8.., col gid);
// C c[0..3] = (row gid, col 2tg), (gid, 2tg+1), (gid+8, 2tg), (gid+8, 2tg+1).

// A fragment (parts) of rows [r, r + 16) x columns [kb, kb + 16) of a
// row-major tile t with a row pitch of P elements.
template <typename T>
__device__ __forceinline__ void a_frag(const T* t, int P, int r, int kb,
                                       uint32_t a[][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tg = lane & 3;
  const T* p0 = t + (r + gid) * P + kb + 2 * tg;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const T* src = p0 + (q & 1) * 8 * P + (q >> 1) * 8;
    if constexpr (std::is_same_v<T, bf16>) {
      a[0][q] = *reinterpret_cast<const uint32_t*>(src);
    } else {
      uint32_t w[kParts<T>];
      pack_pair<T>(src[0], src[1], w);
#pragma unroll
      for (int i = 0; i < kParts<T>; ++i) a[i][q] = w[i];
    }
  }
}

// A fragment (parts) of the transpose: rows (columns of t) [db, db + 16)
// x columns (rows of t) [r, r + 16). bf16 takes ldmatrix.trans, whose
// eight row addresses per matrix are 16-byte aligned (the pitch is).
template <typename T>
__device__ __forceinline__ void at_frag(const T* t, int P, int r, int db,
                                        uint32_t a[][4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same_v<T, bf16>) {
    const int m = lane >> 3;
    const T* src = t + (r + (m >> 1) * 8 + (lane & 7)) * P + db + (m & 1) * 8;
    const unsigned addr = (unsigned)__cvta_generic_to_shared(src);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(a[0][0]), "=r"(a[0][1]), "=r"(a[0][2]), "=r"(a[0][3])
        : "r"(addr));
  } else {
    const int gid = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const T* src = t + (r + 2 * tg + (q >> 1) * 8) * P + db + gid +
                     (q & 1) * 8;
      uint32_t w[kParts<T>];
      pack_pair<T>(src[0], src[P], w);
#pragma unroll
      for (int i = 0; i < kParts<T>; ++i) a[i][q] = w[i];
    }
  }
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B over the part pairs whose significance reaches f32 (i + j <= 2).
template <int NA, int NB>
__device__ __forceinline__ void mma_parts(float c[4], uint32_t a[][4],
                                          uint32_t b[][2]) {
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j <= 2) mma_bf16(c, a[i], b[j]);
}

struct Params {
  const void* q;          // (B, Hq, hd) contiguous
  const void* k;          // (B, n_kv, S, hd), rows contiguous
  const void* v;
  const float* ks;        // (B, n_kv, S, 1) int8 scales, unit stride on S
  const float* vs;
  const uint8_t* mask;    // (B, S) bool, unit stride on S
  const int* kv_limit;    // device int32
  float* o;               // (B, Hq, hd)
  float* m;               // (B, Hq)
  float* l;               // (B, Hq)
  float* part;            // o (B, n_kv, splits, G, hd) | m | l (.., G)
  unsigned* tickets;      // one per (b, kv head), zero on entry and exit
  long long k_sb, k_sh, s_sb, s_sh, mask_sb;
  int n_kv, G, S, split, tile, stages, partial, wide;
  float scale;
};

// Two CTAs an SM where hd <= 64, else one (registers).
template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_decode_kernel(const Params p) {
  constexpr int kKS = HD / 16;                  // k steps of QK, d tiles of PV
  constexpr int kNK = kParts<KT>, kNQ = kParts<QT>;
  constexpr int kRowB = HD * (int)sizeof(KT);   // bytes of a K/V row
  constexpr int kCpr = kRowB / 16;              // 16-byte copies a row
  constexpr int kPitchB = kRowB + kPadBytes;
  constexpr int kPitch = kPitchB / (int)sizeof(KT);
  constexpr bool kInt8 = std::is_same_v<KT, int8_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int Z = gridDim.z, bh = b * p.n_kv + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tg = lane & 3;
  const int G = p.G, GH = G * HD;
  const Layout L = layout(p.tile, p.stages, Z, G, HD, (int)sizeof(KT));
  const int s0 = z * p.split, s1 = min(s0 + p.split, p.S);
  const long long row0 = (long long)bh * G;   // row of head (b, h*G) in Hq

  port::grid_dep_wait();    // every input comes from the kernels before
  // q as the B operand of S = K q^T: (d 2tg.., head gid), (d 2tg+8.., gid)
  uint32_t qf[kKS][kNQ][2];
  {
    const QT* qb = reinterpret_cast<const QT*>(p.q) + (row0 + gid) * HD +
                   2 * tg;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t w[kNQ];
        if (gid < G) {
          const QT* src = qb + ks * 16 + hh * 8;
          pack_pair<QT>(src[0], src[1], w);
        } else {
#pragma unroll
          for (int i = 0; i < kNQ; ++i) w[i] = 0u;
        }
#pragma unroll
        for (int i = 0; i < kNQ; ++i) qf[ks][i][hh] = w[i];
      }
  }
  const int lim = *p.kv_limit;
  const int live_end = min(s1, lim);
  const int ntiles = live_end > s0 ? (live_end - s0 + p.tile - 1) / p.tile
                                   : 0;

  const long long kv_off = b * p.k_sb + h * p.k_sh;
  const KT* kg = reinterpret_cast<const KT*>(p.k) + kv_off;
  const KT* vg = reinterpret_cast<const KT*>(p.v) + kv_off;
  const float* ksg = kInt8 ? p.ks + b * p.s_sb + h * p.s_sh : nullptr;
  const float* vsg = kInt8 ? p.vs + b * p.s_sb + h * p.s_sh : nullptr;
  const uint8_t* mb = p.mask + b * p.mask_sb;

  // Issue every copy of tile t into its ring stage; its mask bytes go to a
  // register (consumed after the wait, so the loads do not stall).
  auto issue = [&](int t, uint32_t& mr) {
    const int t0 = s0 + t * p.tile, n = min(p.tile, s1 - t0);
    unsigned char* st = smem + (t % p.stages) * L.stage;
    const unsigned char* ksrc =
        reinterpret_cast<const unsigned char*>(kg + (long long)t0 * HD);
    const unsigned char* vsrc =
        reinterpret_cast<const unsigned char*>(vg + (long long)t0 * HD);
    for (int i = tid; i < n * kCpr; i += kThreads) {
      const int so = i * 16, d = (i / kCpr) * kPitchB + (i % kCpr) * 16;
      if (p.wide) {
        port::cp_async16(st + L.k + d, ksrc + so);
        port::cp_async16(st + L.v + d, vsrc + so);
      } else {
        constexpr int kE = 16 / (int)sizeof(KT);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          reinterpret_cast<KT*>(st + L.k + d)[e] =
              reinterpret_cast<const KT*>(ksrc + so)[e];
          reinterpret_cast<KT*>(st + L.v + d)[e] =
              reinterpret_cast<const KT*>(vsrc + so)[e];
        }
      }
    }
    for (int i = tid; i < ((n + 15) / 16 * 16 - n) * kCpr; i += kThreads)
      *reinterpret_cast<uint4*>(st + L.v + (n + i / kCpr) * kPitchB +
                                (i % kCpr) * 16) = make_uint4(0, 0, 0, 0);
    if constexpr (kInt8) {
      float* kss = reinterpret_cast<float*>(st + L.ks);
      float* vss = reinterpret_cast<float*>(st + L.vs);
      for (int j = tid; j < n; j += kThreads) {
        port::cp_async4(kss + j, ksg + t0 + j);
        port::cp_async4(vss + j, vsg + t0 + j);
      }
    }
    uint32_t bits = 0;
#pragma unroll
    for (int r = 0; r < kMaskRegs; ++r) {
      const int j = tid + r * kThreads;
      if (j < n) bits |= (uint32_t)mb[t0 + j] << (8 * r);
    }
    mr = bits;
  };

  // Per-warp running statistics of heads 2tg and 2tg + 1 (the C columns a
  // lane holds) and the O^T fragments: rows d, columns heads.
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[kKS][4];
#pragma unroll
  for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[dt][q] = 0.f;
  float* pw = reinterpret_cast<float*>(smem + L.scores) +
              warp * kMaxG * kPRow;

  uint32_t mcur = 0, mnext = 0;
  if (ntiles > 0) issue(0, mcur);
  port::cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) issue(t + 1, mnext);
    port::cp_async_commit();
    port::cp_async_wait_pending(1);          // tile t has landed
    const int t0 = s0 + t * p.tile, n = min(p.tile, s1 - t0);
    unsigned char* st = smem + (t % p.stages) * L.stage;
    uint8_t* live = st + L.live;
#pragma unroll
    for (int r = 0; r < kMaskRegs; ++r) {
      const int j = tid + r * kThreads;
      if (j < n) live[j] = ((mcur >> (8 * r)) & 0xff) != 0 && t0 + j < lim;
    }
    __syncthreads();
    if (t == 0) port::grid_dep_launch();
    const KT* kt = reinterpret_cast<const KT*>(st + L.k);
    const KT* vt = reinterpret_cast<const KT*>(st + L.v);
    const float* kss = reinterpret_cast<const float*>(st + L.ks);
    const float* vss = reinterpret_cast<const float*>(st + L.vs);
    for (int r = warp * 16; r < n; r += kWarps * 16) {   // m tiles
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t a[kNK][4];
        a_frag<KT>(kt, kPitch, r, ks * 16, a);
        mma_parts<kNK, kNQ>(c, a, qf[ks]);
      }
      // c: scores of positions r + gid (c[0..1]) and r + gid + 8 (c[2..3])
      // for heads 2tg, 2tg + 1. Positions past n take no part.
      bool ok[2];
      float sc[4], mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = r + gid + 8 * hr;
        ok[hr] = j < n;
        const bool lv = ok[hr] && live[j];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = c[2 * hr + e];
          if constexpr (kInt8) x = x * kss[j];
          x = lv ? x * p.scale : kNegInf;
          sc[2 * hr + e] = x;
          if (ok[hr]) mt[e] = fmaxf(mt[e], x);
        }
      }
      float corr[2], sum[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mt[e] = fmaxf(mt[e], __shfl_xor_sync(kFull, mt[e], off));
        const float m_new = fmaxf(m_run[e], mt[e]);
        corr[e] = expf(m_run[e] - m_new);
        m_run[e] = m_new;
        sum[e] = 0.f;
      }
      // P (times the position's V scale) into the warp's tile, head-major
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = r + gid + 8 * hr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = ok[hr] ? expf(sc[2 * hr + e] - m_run[e]) : 0.f;
          sum[e] += pe;
          float w = pe;
          if constexpr (kInt8) w = ok[hr] ? pe * vss[j] : 0.f;
          pw[(2 * tg + e) * kPRow + gid + 8 * hr] = w;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          sum[e] += __shfl_xor_sync(kFull, sum[e], off);
        l_run[e] = l_run[e] * corr[e] + sum[e];
      }
#pragma unroll
      for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[dt][q] *= corr[q & 1];
      __syncwarp();
      // P^T as B fragments: (position 2tg.., head gid), (2tg+8.., gid)
      uint32_t bp[3][2];
      {
        const float* pr = pw + gid * kPRow + 2 * tg;
        const float2 x0 = *reinterpret_cast<const float2*>(pr);
        const float2 x1 = *reinterpret_cast<const float2*>(pr + 8);
        uint32_t w0[3], w1[3];
        split3(x0.x, x0.y, w0);
        split3(x1.x, x1.y, w1);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          bp[i][0] = w0[i];
          bp[i][1] = w1[i];
        }
      }
#pragma unroll
      for (int dt = 0; dt < kKS; ++dt) {
        uint32_t a[kNK][4];
        at_frag<KT>(vt, kPitch, r, dt * 16, a);
        mma_parts<kNK, 3>(acc[dt], a, bp);
      }
      __syncwarp();                          // the P tile is rewritten next
    }
    __syncthreads();                         // stage t % stages is free
    mcur = mnext;
  }

  // Merge the 8 warps in warp order (the ring is free: the loop ended on a
  // barrier, or issued nothing).
  const int ml_rows = Z > kWarps ? Z : kWarps;
  float* mo = reinterpret_cast<float*>(smem + L.o);
  float* mm = reinterpret_cast<float*>(smem + L.ml);
#pragma unroll
  for (int dt = 0; dt < kKS; ++dt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int g = 2 * tg + (q & 1);
      if (g < G)
        mo[(warp * G + g) * HD + dt * 16 + gid + (q >> 1) * 8] = acc[dt][q];
    }
  if (gid == 0)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (2 * tg + e < G) {
        mm[warp * G + 2 * tg + e] = m_run[e];
        mm[ml_rows * G + warp * G + 2 * tg + e] = l_run[e];
      }
  __syncthreads();
  const bool split = Z > 1;
  float* part_o = p.part;
  float* part_m = p.part + (long long)gridDim.y * p.n_kv * Z * GH;
  float* part_l = part_m + (long long)gridDim.y * p.n_kv * Z * G;
  for (int i = tid; i < GH; i += kThreads) {
    const int g = i / HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mm[w * G + g]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(mm[w * G + g] - M);
      o += mo[w * GH + i] * a;
      l += mm[ml_rows * G + w * G + g] * a;
    }
    if (!split) {
      p.o[row0 * HD + i] = p.partial ? o : o / fmaxf(l, 1e-30f);
      if (i % HD == 0) {
        p.m[row0 + g] = M;
        p.l[row0 + g] = l;
      }
    } else {
      part_o[((long long)bh * Z + z) * GH + i] = o;
      if (i % HD == 0) {
        part_m[((long long)bh * Z + z) * G + g] = M;
        part_l[((long long)bh * Z + z) * G + g] = l;
      }
    }
  }
  if (!split || !port::last_of_split(p.tickets)) return;

  // The last CTA of (b, h): merge the splits in split order.
  const float* po = part_o + (long long)bh * Z * GH;
  const float* pm = part_m + (long long)bh * Z * G;
  const float* pl = part_l + (long long)bh * Z * G;
  float* buf = mo;                       // zc splits x G x hd
  float* am = mm;                        // m, then a = exp(m - M)  [Z][G]
  float* al = mm + ml_rows * G;          // l                       [Z][G]
  float* fin = mm + 2 * ml_rows * G;     // merged M [kMaxG], l [kMaxG]
  const int zc = min(Z, kSplitChunk);
  constexpr int kOut = kMaxWidth / kThreads;
  float so[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) so[j] = 0.f;
  for (int z0 = 0; z0 < Z; z0 += zc) {
    const int zn = min(zc, Z - z0);
    if (z0 > 0) __syncthreads();         // the previous chunk is consumed
    for (int i = tid * 4; i < zn * GH; i += kThreads * 4)
      port::cp_async16(buf + i, po + (long long)z0 * GH + i);
    port::cp_async_commit();
    if (z0 == 0)
      for (int i = tid; i < Z * G; i += kThreads) {
        am[i] = __ldcg(pm + i);
        al[i] = __ldcg(pl + i);
      }
    port::cp_async_wait_all();
    __syncthreads();
    if (z0 == 0) {
      if (tid < G) {
        float M = kNegInf;
        for (int s = 0; s < Z; ++s) M = fmaxf(M, am[s * G + tid]);
        float l = 0.f;
        for (int s = 0; s < Z; ++s) {
          const float a = expf(am[s * G + tid] - M);
          am[s * G + tid] = a;
          l += al[s * G + tid] * a;
        }
        fin[tid] = M;
        fin[kMaxG + tid] = l;
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int i = tid + j * kThreads;
      if (i < GH) {
        const int g = i / HD;
        for (int s = 0; s < zn; ++s)
          so[j] += buf[s * GH + i] * am[(z0 + s) * G + g];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int i = tid + j * kThreads;
    if (i < GH) {
      const int g = i / HD;
      const float l = fin[kMaxG + g];
      p.o[row0 * HD + i] = p.partial ? so[j] : so[j] / fmaxf(l, 1e-30f);
      if (i % HD == 0) {
        p.m[row0 + g] = fin[g];
        p.l[row0 + g] = l;
      }
    }
  }
}

template <typename QT, typename KT>
cudaError_t launch(const Params& p, int hd, int B, int splits, int smem,
                   bool pdl, cudaStream_t st) {
  const dim3 grid(p.n_kv, B, splits);
  switch (hd) {
    case 32:
      return port::launch_kernel(flash_decode_kernel<QT, KT, 32>, grid,
                                 smem, st, 1, pdl, p);
    case 64:
      return port::launch_kernel(flash_decode_kernel<QT, KT, 64>, grid,
                                 smem, st, 1, pdl, p);
    case 128:
      return port::launch_kernel(flash_decode_kernel<QT, KT, 128>, grid,
                                 smem, st, 1, pdl, p);
    case 256:
      return port::launch_kernel(flash_decode_kernel<QT, KT, 256>, grid,
                                 smem, st, 1, pdl, p);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16. kv_dtype: 0 float32, 1 bfloat16, 2 int8.
// The plan (split, splits, tile, stages, smem) comes from flash_decode/
// ops.py decode_plan: split and tile are multiples of 16, splits =
// max(1, ceil(S / split)), one stage holds the whole split (tile >= split)
// or two stages stream it, and smem must equal this file's layout. part
// holds the scratch of a split call and tickets one zeroed counter per
// (b, kv head). wide: K/V base and strides are 16-byte aligned (cp.async;
// else element copies). pdl: launch as a programmatic dependent. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape, dtype pair or plan the kernel does not take.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* mask, const void* kv_limit, void* o,
    void* m, void* l, void* part, void* tickets, int B, int n_kv, int G,
    int S, int hd, long long k_sb, long long k_sh, long long s_sb,
    long long s_sh, long long mask_sb, float scale, int q_dtype,
    int kv_dtype, int partial, int split, int splits, int tile, int stages,
    int smem, int wide, int pdl, void* stream) {
  const int isz = kv_dtype == 2 ? 1 : kv_dtype == 1 ? 2 : 4;
  const bool shape_ok =
      B > 0 && n_kv > 0 && G > 0 && G <= kMaxG && S >= 0 &&
      (hd == 32 || hd == 64 || hd == 128 || hd == 256) &&
      G * hd <= kMaxWidth;
  const bool plan_ok =
      split > 0 && split % 16 == 0 && tile > 0 && tile % 16 == 0 &&
      tile <= kMaxTile &&
      splits == (S > split ? (S + split - 1) / split : 1) &&
      ((stages == 1 && tile >= split) || (stages == 2 && tile < split));
  if (!shape_ok || !plan_ok ||
      layout(tile, stages, splits, G, hd, isz).total != smem ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = (const float*)ks;
  p.vs = (const float*)vs;
  p.mask = (const uint8_t*)mask;
  p.kv_limit = (const int*)kv_limit;
  p.o = (float*)o;
  p.m = (float*)m;
  p.l = (float*)l;
  p.part = (float*)part;
  p.tickets = (unsigned*)tickets;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.s_sb = s_sb;
  p.s_sh = s_sh;
  p.mask_sb = mask_sb;
  p.n_kv = n_kv;
  p.G = G;
  p.S = S;
  p.split = split;
  p.tile = tile;
  p.stages = stages;
  p.partial = partial;
  p.wide = wide;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
#define FD_ARGS p, hd, B, splits, smem, pdl != 0, st
  if (q_dtype == 0 && kv_dtype == 0) return (int)launch<float, float>(FD_ARGS);
  if (q_dtype == 0 && kv_dtype == 2)
    return (int)launch<float, int8_t>(FD_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(FD_ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return (int)launch<__nv_bfloat16, int8_t>(FD_ARGS);
#undef FD_ARGS
  return (int)cudaErrorInvalidValue;
}
