// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ.  Three
// kernels per input type, one source, in the (folded) layout
// q/o/dq [BH, Sq, D], k/v/dk/dv [BH, Sk, D], lse/delta [BH, Sq] f32,
// segment ids [B, Sq] / [B, Sk] int32 (bh = b * H + h).
//
// flash_fwd — replaces the Pallas kernel
//   paddle_infer_tpu/ops/pallas/flash_attention.py:109 `_fwd_kernel`
//   (launched by `_fwd`, :230).  o = softmax(scale*q k^T + causal/segment
//   mask) v with an online softmax; hash dropout on the probabilities
//   that reach v (the denominator l sums the undropped p); dead rows
//   (running max <= NEG_INF/2, segmented only) give 0; lse = m + log l.
// flash_dkdv — replaces `_dkdv_kernel` (:276, launched at :429): per
//   k-tile, stream the q-tiles, recompute p = exp(s - lse) (`_masked_p`),
//   dv += pd^T do, ds = p (dp - delta) scale, dk += ds^T q, with
//   pd = keep p / (1 - p_drop) and dp = keep (do v^T) / (1 - p_drop).
// flash_dq — replaces `_dq_kernel` (:346, launched at :453): per q-tile,
//   stream the k-tiles, dq += ds k with the same ds.
//
// What bounds them here: at the ERNIE shape (B=32, H=12, S=512, D=64)
// each row of q does 4*S*D FLOPs per byte of q/k/v it reads — about 512
// FLOP/byte in bf16, above the card's ~295 — so in bf16 the tensor-core
// rate bounds them.  Design: the TPU kernels carry (m, l, acc) and the
// dk/dv/dq accumulators in VMEM across a sequential grid axis; here a
// block owns one (bh, 64-row tile) and loops over the other side's tiles
// inside the block, keeping the accumulators in registers, so no atomics
// are needed and results are the same from run to run.  The forward and
// dQ use one block per (bh, q-tile), dK/dV one per (bh, k-tile); causal
// tiles above the diagonal plus the offset Sk - Sq are skipped as the
// Pallas `needed` predicate skips them.  bf16: four warps, each owning
// 16 rows of the block's tile; q k^T, p v, pd^T do, ds^T q and ds k run
// on the tensor cores as warp-level mma.sync.m16n8k16 (bf16 in, f32
// accumulation), the score fragments re-packed in registers as the next
// product's A operand (no round trip through shared memory).  Tiles sit
// in shared memory with rows padded by 8 elements, which makes the
// fragment loads free of bank conflicts.  At D = 256 a bf16 dK/dV block
// would hold 256 f32 accumulators per thread, so the grid's z axis splits
// dK and dV's head dim in two: each block recomputes its tile's scores
// over the full D (1.5x the products) and keeps 128 columns of each; the
// forward and dQ hold 128 accumulators per thread at D = 256, as dK/dV
// does at D = 128, and need no split.  f32: CUDA cores, four threads
// per tile row, scores staged in shared memory; tiles of 32 rows at
// D = 256, so four f32 tiles fit in shared memory.  Head dims 64, 128
// and 256.  wgmma, TMA and a pipelined tile ring are later work.
//
// Numerics kept from the TPU kernels: NEG_INF = -1e30 (not -inf) for
// masked scores; l == 0 → 1; keys past Sk (the kernel guards its own
// tile tails) score -inf and weigh exactly 0.  The dropout keep mask is
// the pure uint32 hash `dropout_keep(seed, bh, row, col)` over absolute
// coordinates, bit for bit the plain version's.
//
// C interface (ctypes): every pointer and the stream are void*; each
// entry returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;         // rows of q and of k per tile
constexpr int kMmaThreads = 128;  // bf16: 4 warps x 16 rows

enum DType { kF32 = 0, kBF16 = 1 };
enum Kind { kFwd = 0, kDkdv = 1, kDq = 2 };

typedef __nv_bfloat16 bf16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // backward: dO, like q
  const float* lse_in;  // backward
  const float* delta;   // backward: sum(dO * o) per row
  const int* qseg;      // [B, Sq] or null
  const int* kseg;      // [B, Sk] or null
  void* out0;           // fwd: o; dkdv: dk; dq: dq
  void* out1;           // dkdv: dv
  float* lse_out;       // fwd
  int sq, sk, heads;
  float scale;
  int causal;
  int dropout;
  unsigned seed;
  unsigned thresh;
  float rescale;  // 1 / (1 - p_drop) in f32
};

// ------------------------------------------------------------ shared math

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// `dropout_keep` of the plain version: P(keep) = 1 - p_drop.
__device__ __forceinline__ bool keep_elem(const Args& a, int bh, int row,
                                          int col) {
  const uint32_t x = static_cast<uint32_t>(row) * 0x9E3779B1u +
                     static_cast<uint32_t>(col) * 0x85EBCA77u +
                     static_cast<uint32_t>(bh) * 0xC2B2AE3Du;
  return mix32(x ^ a.seed) >= a.thresh;
}

__device__ __forceinline__ bool causal_ok(const Args& a, int row, int col) {
  return !a.causal || row + (a.sk - a.sq) >= col;
}

// k-tiles a q-tile of `tile` rows starting at q0 needs (the Pallas
// `needed` predicate); q and k tiles have the same size.
__device__ __forceinline__ int num_k_tiles(const Args& a, int q0, int tile) {
  int nk = (a.sk + tile - 1) / tile;
  if (a.causal) {
    const int last = q0 + tile - 1 + a.sk - a.sq;
    nk = last < 0 ? 0 : min(nk, last / tile + 1);
  }
  return nk;
}

__device__ __forceinline__ bool tile_needed(const Args& a, int q0, int k0,
                                            int tile) {
  return !a.causal || k0 <= q0 + tile - 1 + a.sk - a.sq;
}

__device__ __forceinline__ float warp_group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float warp_group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------- bf16 tiles

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from two rows, `lo` in the low half.
__device__ __forceinline__ uint32_t ld2(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi))
          << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// kTile rows of a [n, D] bf16 matrix from row0 into shared memory with
// row stride D + 8; rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int row0, int n) {
  constexpr int LD = D + 8, VPR = D / 8;
  for (int i = threadIdx.x; i < kTile * VPR; i += kMmaThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// s[16 x 64] = A[rows arow0.., :] . B[0..64, :]^T over D, both row-major
// [*, D + 8] tiles in shared memory.  Fragment (nt, e): row arow0 + g
// (+8 for e >= 2), column nt * 8 + 2 t + (e & 1).
template <int D>
__device__ __forceinline__ void abt_tile(const bf16* sA, const bf16* sB,
                                         int arow0, int g, int t,
                                         float (&s)[8][4]) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* pa = sA + (arow0 + g) * LD + ks * 16 + t * 2;
    const uint32_t af[4] = {ld32(pa), ld32(pa + 8 * LD), ld32(pa + 8),
                            ld32(pa + 8 * LD + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* pb = sB + (nt * 8 + g) * LD + ks * 16 + t * 2;
      const uint32_t bfr[2] = {ld32(pb), ld32(pb + 8)};
      mma_bf16(s[nt], af, bfr);
    }
  }
}

// Head-dim columns of dK and dV one bf16 dK/dV block holds: all of D up
// to 128; at D = 256 the grid's z axis splits them in two, so a thread's
// 2 x 64 accumulators stay in registers (each block recomputes its
// tile's scores over the full D).
template <int D>
__host__ __device__ constexpr int dkdv_cols() { return D < 128 ? D : 128; }

// acc[16 x DA] += P[16 x 64] . M[64 x DA]: P in abt_tile's fragment
// layout (rounded to bf16 as the A operand), M DA columns of a row-major
// shared [*, D + 8] tile.
template <int D, int DA>
__device__ __forceinline__ void pm_tile(const float (&p)[8][4],
                                        const bf16* sM, int g, int t,
                                        float (&acc)[DA / 8][4]) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t af[4] = {
        pack_bf16(p[2 * j][0], p[2 * j][1]),
        pack_bf16(p[2 * j][2], p[2 * j][3]),
        pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
        pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int dt = 0; dt < DA / 8; ++dt) {
      const bf16* pb = sM + (j * 16 + t * 2) * LD + dt * 8 + g;
      const uint32_t bfr[2] = {ld2(pb, pb + LD),
                               ld2(pb + 8 * LD, pb + 9 * LD)};
      mma_bf16(acc[dt], af, bfr);
    }
  }
}

// Rows row[0], row[1] of acc ([16 x DA] fragments) into DA columns of
// dst [n, D].
template <int D, int DA>
__device__ __forceinline__ void store_rows_bf16(bf16* dst,
                                                const float (&acc)[DA / 8][4],
                                                const int (&row)[2], int n,
                                                int t, const float (&mul)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= n) continue;
    bf16* out = dst + static_cast<size_t>(row[i]) * D;
#pragma unroll
    for (int dt = 0; dt < DA / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8 + t * 2) =
          __floats2bfloat162_rn(acc[dt][2 * i] * mul[i],
                                acc[dt][2 * i + 1] * mul[i]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_kernel_bf16(Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * LD;
  bf16* sV = sK + kTile * LD;
  int* sKs = reinterpret_cast<int*>(sV + kTile * LD);

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* Q = static_cast<const bf16*>(a.q) + static_cast<size_t>(bh) * a.sq * D;
  const bf16* K = static_cast<const bf16*>(a.k) + static_cast<size_t>(bh) * a.sk * D;
  const bf16* V = static_cast<const bf16*>(a.v) + static_cast<size_t>(bh) * a.sk * D;
  const int b = bh / a.heads;
  const int* kseg = a.kseg ? a.kseg + static_cast<size_t>(b) * a.sk : nullptr;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int qs[2] = {0, 0};
  if (a.qseg)
    for (int i = 0; i < 2; ++i)
      if (row[i] < a.sq) qs[i] = a.qseg[static_cast<size_t>(b) * a.sq + row[i]];

  load_tile_bf16<D>(sQ, Q, q0, a.sq);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int nk = num_k_tiles(a, q0, kTile);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_bf16<D>(sK, K, k0, a.sk);
    load_tile_bf16<D>(sV, V, k0, a.sk);
    if (kseg)
      for (int i = threadIdx.x; i < kTile; i += kMmaThreads)
        sKs[i] = k0 + i < a.sk ? kseg[k0 + i] : 0;
    __syncthreads();

    float s[8][4];
    abt_tile<D>(sQ, sK, warp * 16, g, t, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, cl = nt * 8 + t * 2 + (e & 1), col = k0 + cl;
        float x = s[nt][e] * a.scale;
        if (col >= a.sk)
          x = -INFINITY;
        else if (!causal_ok(a, row[i], col) || (kseg && qs[i] != sKs[cl]))
          x = kNegInf;
        s[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float corr[2], mn[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mn[i] = fmaxf(m[i], warp_group_max(mx[i]));
      corr[i] = expf(m[i] - mn[i]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - mn[e >> 1]);
        rs[e >> 1] += p;
        s[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = corr[i] * l[i] + warp_group_sum(rs[i]);
      m[i] = mn[i];
    }
    if (a.dropout) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + t * 2 + (e & 1);
          s[nt][e] = keep_elem(a, bh, row[e >> 1], col) ? s[nt][e] * a.rescale
                                                        : 0.f;
        }
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= corr[e >> 1];
    pm_tile<D, D>(s, sV, g, t, acc);
  }

  float mul[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float safe = l[i] == 0.f ? 1.f : l[i];
    const bool dead = a.qseg && m[i] <= kNegInf * 0.5f;
    mul[i] = dead ? 0.f : 1.f / safe;
    if (t == 0 && row[i] < a.sq)
      a.lse_out[static_cast<size_t>(bh) * a.sq + row[i]] = m[i] + logf(safe);
  }
  store_rows_bf16<D, D>(
      static_cast<bf16*>(a.out0) + static_cast<size_t>(bh) * a.sq * D, acc,
      row, a.sq, t, mul);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkdv_kernel_bf16(Args a) {
  constexpr int LD = D + 8, DA = dkdv_cols<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * LD;
  bf16* sQ = sV + kTile * LD;
  bf16* sO = sQ + kTile * LD;  // dO
  float* sLse = reinterpret_cast<float*>(sO + kTile * LD);
  float* sDelta = sLse + kTile;
  int* sQs = reinterpret_cast<int*>(sDelta + kTile);

  const int bh = blockIdx.y, k0 = blockIdx.x * kTile, c0 = blockIdx.z * DA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = static_cast<size_t>(bh) * a.sq;
  const size_t koff = static_cast<size_t>(bh) * a.sk;
  const bf16* Q = static_cast<const bf16*>(a.q) + qoff * D;
  const bf16* dO = static_cast<const bf16*>(a.dout) + qoff * D;
  const int b = bh / a.heads;
  const int* qseg = a.qseg ? a.qseg + static_cast<size_t>(b) * a.sq : nullptr;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int ks[2] = {0, 0};
  if (a.kseg)
    for (int i = 0; i < 2; ++i)
      if (key[i] < a.sk) ks[i] = a.kseg[static_cast<size_t>(b) * a.sk + key[i]];

  load_tile_bf16<D>(sK, static_cast<const bf16*>(a.k) + koff * D, k0, a.sk);
  load_tile_bf16<D>(sV, static_cast<const bf16*>(a.v) + koff * D, k0, a.sk);
  float dk[DA / 8][4], dv[DA / 8][4];
#pragma unroll
  for (int dt = 0; dt < DA / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  const int nq = (a.sq + kTile - 1) / kTile;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    if (!tile_needed(a, q0, k0, kTile)) continue;
    __syncthreads();
    load_tile_bf16<D>(sQ, Q, q0, a.sq);
    load_tile_bf16<D>(sO, dO, q0, a.sq);
    for (int i = threadIdx.x; i < kTile; i += kMmaThreads) {
      const bool in = q0 + i < a.sq;
      sLse[i] = in ? a.lse_in[qoff + q0 + i] : 0.f;
      sDelta[i] = in ? a.delta[qoff + q0 + i] : 0.f;
      sQs[i] = in && qseg ? qseg[q0 + i] : 0;
    }
    __syncthreads();

    // p^T = exp(scale k q^T - lse), re-zeroed where masked (`_masked_p`)
    float p[8][4];
    abt_tile<D>(sK, sQ, warp * 16, g, t, p);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, ql = nt * 8 + t * 2 + (e & 1), qrow = q0 + ql;
        const bool cz = causal_ok(a, qrow, key[i]);
        const float x = cz ? p[nt][e] * a.scale : kNegInf;
        const float pv = expf(x - sLse[ql]);
        const bool zero = !cz || (qseg && sQs[ql] != ks[i]) || qrow >= a.sq ||
                          key[i] >= a.sk;
        p[nt][e] = zero ? 0.f : pv;
      }
    // dp^T = v dO^T; then pd (in p) and ds (in dp)
    float dp[8][4];
    abt_tile<D>(sV, sO, warp * 16, g, t, dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, ql = nt * 8 + t * 2 + (e & 1);
        const float pv = p[nt][e];
        float d = dp[nt][e], pd = pv;
        if (a.dropout) {
          const bool kp = keep_elem(a, bh, q0 + ql, key[i]);
          pd = kp ? pv * a.rescale : 0.f;
          d = kp ? d * a.rescale : 0.f;
        }
        dp[nt][e] = pv * (d - sDelta[ql]) * a.scale;
        p[nt][e] = pd;
      }
    pm_tile<D, DA>(p, sO + c0, g, t, dv);
    pm_tile<D, DA>(dp, sQ + c0, g, t, dk);
  }

  const float one[2] = {1.f, 1.f};
  store_rows_bf16<D, DA>(static_cast<bf16*>(a.out0) + koff * D + c0, dk, key,
                         a.sk, t, one);
  store_rows_bf16<D, DA>(static_cast<bf16*>(a.out1) + koff * D + c0, dv, key,
                         a.sk, t, one);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_kernel_bf16(Args a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kTile * LD;  // dO
  bf16* sK = sO + kTile * LD;
  bf16* sV = sK + kTile * LD;
  int* sKs = reinterpret_cast<int*>(sV + kTile * LD);

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = static_cast<size_t>(bh) * a.sq;
  const size_t koff = static_cast<size_t>(bh) * a.sk;
  const bf16* K = static_cast<const bf16*>(a.k) + koff * D;
  const bf16* V = static_cast<const bf16*>(a.v) + koff * D;
  const int b = bh / a.heads;
  const int* kseg = a.kseg ? a.kseg + static_cast<size_t>(b) * a.sk : nullptr;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int qs[2] = {0, 0};
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  for (int i = 0; i < 2; ++i)
    if (row[i] < a.sq) {
      lse[i] = a.lse_in[qoff + row[i]];
      delta[i] = a.delta[qoff + row[i]];
      if (a.qseg) qs[i] = a.qseg[static_cast<size_t>(b) * a.sq + row[i]];
    }

  load_tile_bf16<D>(sQ, static_cast<const bf16*>(a.q) + qoff * D, q0, a.sq);
  load_tile_bf16<D>(sO, static_cast<const bf16*>(a.dout) + qoff * D, q0, a.sq);
  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;

  const int nk = num_k_tiles(a, q0, kTile);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile_bf16<D>(sK, K, k0, a.sk);
    load_tile_bf16<D>(sV, V, k0, a.sk);
    if (kseg)
      for (int i = threadIdx.x; i < kTile; i += kMmaThreads)
        sKs[i] = k0 + i < a.sk ? kseg[k0 + i] : 0;
    __syncthreads();

    float p[8][4];
    abt_tile<D>(sQ, sK, warp * 16, g, t, p);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, cl = nt * 8 + t * 2 + (e & 1), col = k0 + cl;
        const bool cz = causal_ok(a, row[i], col);
        const float x = cz ? p[nt][e] * a.scale : kNegInf;
        const float pv = expf(x - lse[i]);
        const bool zero = !cz || (kseg && qs[i] != sKs[cl]) || col >= a.sk ||
                          row[i] >= a.sq;
        p[nt][e] = zero ? 0.f : pv;
      }
    float dp[8][4];
    abt_tile<D>(sO, sV, warp * 16, g, t, dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + nt * 8 + t * 2 + (e & 1);
        float d = dp[nt][e];
        if (a.dropout) d = keep_elem(a, bh, row[i], col) ? d * a.rescale : 0.f;
        dp[nt][e] = p[nt][e] * (d - delta[i]) * a.scale;
      }
    pm_tile<D, D>(dp, sK, g, t, dq);
  }
  const float one[2] = {1.f, 1.f};
  store_rows_bf16<D, D>(static_cast<bf16*>(a.out0) + qoff * D, dq, row, a.sq,
                        t, one);
}

// -------------------------------------------------------------- f32 tiles
// Tiles of T rows (64 up to D = 128; 32 at D = 256, so four f32 tiles
// fit in shared memory).  Four consecutive threads own one tile row
// (row = tid / 4); thread c4 of the group takes columns c4, c4 + 4, ...
// of the T-wide score row and head dims c4, c4 + 4, ... of the
// accumulators.  Shared rows are padded by one float (conflict-free
// column walks).

template <int D>
__host__ __device__ constexpr int f32_tile() { return D > 128 ? 32 : 64; }

template <int D, int T>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int n) {
  constexpr int LDF = D + 1, VPR = D / 4;
  for (int i = threadIdx.x; i < T * VPR; i += 4 * T) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
    float* o = dst + r * LDF + c;
    o[0] = val.x;
    o[1] = val.y;
    o[2] = val.z;
    o[3] = val.w;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* x, const float* y) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) acc = fmaf(x[d], y[d], acc);
  return acc;
}

template <int D, int T>
__global__ void __launch_bounds__(4 * T) flash_fwd_kernel_f32(Args a) {
  constexpr int LDF = D + 1, SLD = T + 1;
  extern __shared__ float fsm[];
  float* sQ = fsm;
  float* sK = sQ + T * LDF;
  float* sV = sK + T * LDF;
  float* sP = sV + T * LDF;
  int* sKs = reinterpret_cast<int*>(sP + T * SLD);

  const int bh = blockIdx.y, q0 = blockIdx.x * T;
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3, row = q0 + r;
  const size_t qoff = static_cast<size_t>(bh) * a.sq;
  const size_t koff = static_cast<size_t>(bh) * a.sk;
  const float* K = static_cast<const float*>(a.k) + koff * D;
  const float* V = static_cast<const float*>(a.v) + koff * D;
  const int b = bh / a.heads;
  const int* kseg = a.kseg ? a.kseg + static_cast<size_t>(b) * a.sk : nullptr;
  const int qs = a.qseg && row < a.sq ? a.qseg[static_cast<size_t>(b) * a.sq + row] : 0;

  load_tile_f32<D, T>(sQ, static_cast<const float*>(a.q) + qoff * D, q0, a.sq);
  float m = kNegInf, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  const int nk = num_k_tiles(a, q0, T);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * T;
    __syncthreads();
    load_tile_f32<D, T>(sK, K, k0, a.sk);
    load_tile_f32<D, T>(sV, V, k0, a.sk);
    if (kseg)
      for (int i = threadIdx.x; i < T; i += 4 * T)
        sKs[i] = k0 + i < a.sk ? kseg[k0 + i] : 0;
    __syncthreads();

    float sv[T / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < T / 4; ++i) {
      const int cl = c4 + 4 * i, col = k0 + cl;
      float x = dot_rows<D>(sQ + r * LDF, sK + cl * LDF) * a.scale;
      if (col >= a.sk)
        x = -INFINITY;
      else if (!causal_ok(a, row, col) || (kseg && qs != sKs[cl]))
        x = kNegInf;
      sv[i] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, warp_group_max(mx));
    const float corr = expf(m - mn);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < T / 4; ++i) {
      sv[i] = expf(sv[i] - mn);
      rs += sv[i];
    }
    l = corr * l + warp_group_sum(rs);
    m = mn;
#pragma unroll
    for (int i = 0; i < T / 4; ++i) {
      const int cl = c4 + 4 * i;
      float pa = sv[i];
      if (a.dropout) pa = keep_elem(a, bh, row, k0 + cl) ? pa * a.rescale : 0.f;
      sP[r * SLD + cl] = pa;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < D / 4; ++j) {
      const int d = c4 + 4 * j;
      float pv = 0.f;
      for (int c = 0; c < T; ++c)
        pv = fmaf(sP[r * SLD + c], sV[c * LDF + d], pv);
      acc[j] = acc[j] * corr + pv;
    }
  }
  if (row < a.sq) {
    const float safe = l == 0.f ? 1.f : l;
    const bool dead = a.qseg && m <= kNegInf * 0.5f;
    float* o = static_cast<float*>(a.out0) + (qoff + row) * D;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) o[c4 + 4 * j] = dead ? 0.f : acc[j] / safe;
    if (c4 == 0) a.lse_out[qoff + row] = m + logf(safe);
  }
}

template <int D, int T>
__global__ void __launch_bounds__(4 * T) flash_dkdv_kernel_f32(Args a) {
  constexpr int LDF = D + 1, SLD = T + 1;
  extern __shared__ float fsm[];
  float* sK = fsm;
  float* sV = sK + T * LDF;
  float* sQ = sV + T * LDF;
  float* sO = sQ + T * LDF;  // dO
  float* sP = sO + T * LDF;  // pd [q][k]
  float* sS = sP + T * SLD;  // ds [q][k]
  float* sLse = sS + T * SLD;
  float* sDelta = sLse + T;
  int* sQs = reinterpret_cast<int*>(sDelta + T);

  const int bh = blockIdx.y, k0 = blockIdx.x * T;
  const int kr = threadIdx.x >> 2, c4 = threadIdx.x & 3, key = k0 + kr;
  const size_t qoff = static_cast<size_t>(bh) * a.sq;
  const size_t koff = static_cast<size_t>(bh) * a.sk;
  const float* Q = static_cast<const float*>(a.q) + qoff * D;
  const float* dO = static_cast<const float*>(a.dout) + qoff * D;
  const int b = bh / a.heads;
  const int* qseg = a.qseg ? a.qseg + static_cast<size_t>(b) * a.sq : nullptr;
  const int ksv = a.kseg && key < a.sk ? a.kseg[static_cast<size_t>(b) * a.sk + key] : 0;

  load_tile_f32<D, T>(sK, static_cast<const float*>(a.k) + koff * D, k0, a.sk);
  load_tile_f32<D, T>(sV, static_cast<const float*>(a.v) + koff * D, k0, a.sk);
  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) dk[j] = dv[j] = 0.f;

  const int nq = (a.sq + T - 1) / T;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * T;
    if (!tile_needed(a, q0, k0, T)) continue;
    __syncthreads();
    load_tile_f32<D, T>(sQ, Q, q0, a.sq);
    load_tile_f32<D, T>(sO, dO, q0, a.sq);
    for (int i = threadIdx.x; i < T; i += 4 * T) {
      const bool in = q0 + i < a.sq;
      sLse[i] = in ? a.lse_in[qoff + q0 + i] : 0.f;
      sDelta[i] = in ? a.delta[qoff + q0 + i] : 0.f;
      sQs[i] = in && qseg ? qseg[q0 + i] : 0;
    }
    __syncthreads();

    for (int i = 0; i < T / 4; ++i) {
      const int ql = c4 + 4 * i, qrow = q0 + ql;
      const bool cz = causal_ok(a, qrow, key);
      const float x = cz ? dot_rows<D>(sQ + ql * LDF, sK + kr * LDF) * a.scale
                         : kNegInf;
      const float e = expf(x - sLse[ql]);
      const bool zero = !cz || (qseg && sQs[ql] != ksv) || qrow >= a.sq ||
                        key >= a.sk;
      const float pv = zero ? 0.f : e;
      float d = dot_rows<D>(sO + ql * LDF, sV + kr * LDF), pd = pv;
      if (a.dropout) {
        const bool kp = keep_elem(a, bh, qrow, key);
        pd = kp ? pv * a.rescale : 0.f;
        d = kp ? d * a.rescale : 0.f;
      }
      sP[ql * SLD + kr] = pd;
      sS[ql * SLD + kr] = pv * (d - sDelta[ql]) * a.scale;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < D / 4; ++j) {
      const int d = c4 + 4 * j;
      float av = 0.f, ak = 0.f;
      for (int ql = 0; ql < T; ++ql) {
        av = fmaf(sP[ql * SLD + kr], sO[ql * LDF + d], av);
        ak = fmaf(sS[ql * SLD + kr], sQ[ql * LDF + d], ak);
      }
      dv[j] += av;
      dk[j] += ak;
    }
  }
  if (key < a.sk) {
    float* odk = static_cast<float*>(a.out0) + (koff + key) * D;
    float* odv = static_cast<float*>(a.out1) + (koff + key) * D;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      odk[c4 + 4 * j] = dk[j];
      odv[c4 + 4 * j] = dv[j];
    }
  }
}

template <int D, int T>
__global__ void __launch_bounds__(4 * T) flash_dq_kernel_f32(Args a) {
  constexpr int LDF = D + 1, SLD = T + 1;
  extern __shared__ float fsm[];
  float* sQ = fsm;
  float* sO = sQ + T * LDF;  // dO
  float* sK = sO + T * LDF;
  float* sV = sK + T * LDF;
  float* sS = sV + T * LDF;  // ds [q][k]
  int* sKs = reinterpret_cast<int*>(sS + T * SLD);

  const int bh = blockIdx.y, q0 = blockIdx.x * T;
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3, row = q0 + r;
  const size_t qoff = static_cast<size_t>(bh) * a.sq;
  const size_t koff = static_cast<size_t>(bh) * a.sk;
  const float* K = static_cast<const float*>(a.k) + koff * D;
  const float* V = static_cast<const float*>(a.v) + koff * D;
  const int b = bh / a.heads;
  const int* kseg = a.kseg ? a.kseg + static_cast<size_t>(b) * a.sk : nullptr;
  const bool in = row < a.sq;
  const int qs = a.qseg && in ? a.qseg[static_cast<size_t>(b) * a.sq + row] : 0;
  const float lse = in ? a.lse_in[qoff + row] : 0.f;
  const float delta = in ? a.delta[qoff + row] : 0.f;

  load_tile_f32<D, T>(sQ, static_cast<const float*>(a.q) + qoff * D, q0, a.sq);
  load_tile_f32<D, T>(sO, static_cast<const float*>(a.dout) + qoff * D, q0, a.sq);
  float dq[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) dq[j] = 0.f;

  const int nk = num_k_tiles(a, q0, T);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * T;
    __syncthreads();
    load_tile_f32<D, T>(sK, K, k0, a.sk);
    load_tile_f32<D, T>(sV, V, k0, a.sk);
    if (kseg)
      for (int i = threadIdx.x; i < T; i += 4 * T)
        sKs[i] = k0 + i < a.sk ? kseg[k0 + i] : 0;
    __syncthreads();

    for (int i = 0; i < T / 4; ++i) {
      const int cl = c4 + 4 * i, col = k0 + cl;
      const bool cz = causal_ok(a, row, col);
      const float x = cz ? dot_rows<D>(sQ + r * LDF, sK + cl * LDF) * a.scale
                         : kNegInf;
      const float e = expf(x - lse);
      const bool zero = !cz || (kseg && qs != sKs[cl]) || col >= a.sk || !in;
      const float pv = zero ? 0.f : e;
      float d = dot_rows<D>(sO + r * LDF, sV + cl * LDF);
      if (a.dropout) d = keep_elem(a, bh, row, col) ? d * a.rescale : 0.f;
      sS[r * SLD + cl] = pv * (d - delta) * a.scale;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < D / 4; ++j) {
      const int d = c4 + 4 * j;
      float aq = 0.f;
      for (int c = 0; c < T; ++c)
        aq = fmaf(sS[r * SLD + c], sK[c * LDF + d], aq);
      dq[j] += aq;
    }
  }
  if (in) {
    float* o = static_cast<float*>(a.out0) + (qoff + row) * D;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) o[c4 + 4 * j] = dq[j];
  }
}

// ------------------------------------------------------------------ host

// Rows per tile: kTile for bf16, f32_tile<D>() for f32.
template <int D>
int tile_rows(int dtype) { return dtype == kBF16 ? kTile : f32_tile<D>(); }

template <int D>
size_t smem_bytes(int dtype, int kind) {
  const int mats = kind == kFwd ? 3 : 4;
  const int vecs = kind == kDkdv ? 3 : 1;  // lse, delta, seg / seg
  const int T = tile_rows<D>(dtype);
  if (dtype == kBF16) return mats * T * (D + 8) * 2 + vecs * T * 4;
  const int score_tiles = kind == kDkdv ? 2 : 1;
  return mats * T * (D + 1) * 4 + score_tiles * T * (T + 1) * 4 +
         vecs * T * 4;
}

template <typename Kernel>
int launch_one(Kernel kernel, dim3 grid, int threads, size_t smem,
               const Args& a, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, int kind, int bh_count, const Args& a,
           cudaStream_t stream) {
  const int T = tile_rows<D>(dtype);
  const int tiles = kind == kDkdv ? (a.sk + T - 1) / T : (a.sq + T - 1) / T;
  const size_t smem = smem_bytes<D>(dtype, kind);
  if (dtype == kBF16) {
    // z (dK/dV): the blocks that split the head dim's accumulator columns
    const dim3 grid(tiles, bh_count, kind == kDkdv ? D / dkdv_cols<D>() : 1);
    switch (kind) {
      case kFwd:
        return launch_one(flash_fwd_kernel_bf16<D>, grid, kMmaThreads, smem,
                          a, stream);
      case kDkdv:
        return launch_one(flash_dkdv_kernel_bf16<D>, grid, kMmaThreads, smem,
                          a, stream);
      case kDq:
        return launch_one(flash_dq_kernel_bf16<D>, grid, kMmaThreads, smem, a,
                          stream);
    }
  } else if (dtype == kF32) {
    constexpr int TF = f32_tile<D>();
    const dim3 grid(tiles, bh_count);
    switch (kind) {
      case kFwd:
        return launch_one(flash_fwd_kernel_f32<D, TF>, grid, 4 * TF, smem, a,
                          stream);
      case kDkdv:
        return launch_one(flash_dkdv_kernel_f32<D, TF>, grid, 4 * TF, smem,
                          a, stream);
      case kDq:
        return launch_one(flash_dq_kernel_f32<D, TF>, grid, 4 * TF, smem, a,
                          stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int dtype, int kind, int D, int bh_count, const Args& a,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh_count < 1 || bh_count > 65535 || a.sq < 1 || a.sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return launch<64>(dtype, kind, bh_count, a, s);
    case 128: return launch<128>(dtype, kind, bh_count, a, s);
    case 256: return launch<256>(dtype, kind, bh_count, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* qseg,
               const void* kseg, int Sq, int Sk, int H, float scale,
               int causal, int dropout, unsigned seed, unsigned thresh,
               float rescale) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.sq = Sq;
  a.sk = Sk;
  a.heads = H;
  a.scale = scale;
  a.causal = causal;
  a.dropout = dropout;
  a.seed = seed;
  a.thresh = thresh;
  a.rescale = rescale;
  return a;
}

}  // namespace

extern "C" {

int pit_flash_fwd(int dtype, int D, const void* q, const void* k,
                  const void* v, const void* qseg, const void* kseg, void* o,
                  void* lse, int BH, int Sq, int Sk, int H, float scale,
                  int causal, int dropout, unsigned seed, unsigned thresh,
                  float rescale, void* stream) {
  Args a = make_args(q, k, v, qseg, kseg, Sq, Sk, H, scale, causal, dropout,
                     seed, thresh, rescale);
  a.out0 = o;
  a.lse_out = static_cast<float*>(lse);
  return dispatch(dtype, kFwd, D, BH, a, stream);
}

int pit_flash_dkdv(int dtype, int D, const void* q, const void* k,
                   const void* v, const void* dout, const void* lse,
                   const void* delta, const void* qseg, const void* kseg,
                   void* dk, void* dv, int BH, int Sq, int Sk, int H,
                   float scale, int causal, int dropout, unsigned seed,
                   unsigned thresh, float rescale, void* stream) {
  Args a = make_args(q, k, v, qseg, kseg, Sq, Sk, H, scale, causal, dropout,
                     seed, thresh, rescale);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = dk;
  a.out1 = dv;
  return dispatch(dtype, kDkdv, D, BH, a, stream);
}

int pit_flash_dq(int dtype, int D, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse,
                 const void* delta, const void* qseg, const void* kseg,
                 void* dq, int BH, int Sq, int Sk, int H, float scale,
                 int causal, int dropout, unsigned seed, unsigned thresh,
                 float rescale, void* stream) {
  Args a = make_args(q, k, v, qseg, kseg, Sq, Sk, H, scale, causal, dropout,
                     seed, thresh, rescale);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = dq;
  return dispatch(dtype, kDq, D, BH, a, stream);
}

const char* pit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
