// Paged attention over a head-major KV page pool [P, H, page, D] for
// Hopper (sm_90a).  One source: the decode and verify kernels, the
// combine pass they share, and the ragged kernel.
//
// paged_decode_kernel — replaces the Pallas kernel
//   paddle_infer_tpu/ops/pallas/paged_attention.py:140 `_decode_kernel`
//   (launched by `_decode_local`, :307).  One query per row against the
//   row's pages, online softmax over them.
// paged_verify_kernel — replaces the Pallas kernel
//   paddle_infer_tpu/ops/pallas/paged_attention.py:317 `_verify_kernel`
//   (launched by `_verify_local`, :476).  W query lanes per row (the last
//   emitted token and W-1 drafts), lane w masked at lengths[b, w]; lane
//   (b, w) must equal the decode kernel at lengths[b, w] bit for bit,
//   which keeps greedy speculative streams equal to plain ones.
//
// What bounds both: device-memory bytes.  Every K and V byte of a row's
// pages is read once and used for 2 FLOPs per query lane, far under the
// ~295 FLOP/byte at which the card turns compute-bound.  So the design's
// one job is to keep enough bytes in flight on all 132 SMs:
//
// - Split page walk.  A row's pages are cut into splits of kSplitPages
//   pages.  The grid is (B, H, splits) — verify: (B, H, splits x lane
//   groups) — sized from the table's shape, so the host never reads
//   lengths.  A block whose split starts at or past its row's page count
//   exits at once; the longest chain of dependent pages is kSplitPages,
//   not the row's page count.
// - Pages in flight.  A block reads its split's page ids (and int8
//   scales) once, then streams each (page, head) K and V slab — page*D
//   contiguous elements of the pool, taken in units of at most kChunk
//   slots — through a ring of 2..kMaxStages stages in shared memory with
//   16-byte cp.async copies, stages-1 units ahead of the compute.  The
//   ring takes what kRingBytes (16 KB) holds, at least 2 stages: at the
//   serving shapes a 16 KB ring (more blocks an SM) timed faster on an
//   H100 than a 48 KB one, and no other traffic was timed.
// - Per unit, two walks, chosen by the page and query types:
//   * tensor cores (split_walk_mma) for bf16 / f16 queries over 16-bit or
//     int8 pages with D % 16 == 0 — the serving case.  The block's lanes
//     are the rows of m16n8k16 tiles: every warp computes the unit's
//     scores S = Q K^T (K fragments by ldmatrix from a ring whose 16-byte
//     chunks are XOR-swizzled by row; int8 units widened exactly to the
//     query type once, by the whole block), runs each lane's online
//     softmax in the quad of threads holding its row (one expf per slot,
//     m and l in f32), and adds P V for its quarter of the head dims:
//     p is rounded to the query type for the tile, the product is taken
//     into a zeroed f32 accumulator, and the page's V scale and the
//     rescale of the earlier sum are applied to it in f32.
//     One barrier a unit, to hand the ring stage over.
//   * CUDA cores (split_walk) for f32 queries and other head dims: each
//     group of at most 8 threads dots one slot with every lane's query
//     (shuffle reduction, the lanes interleaved), the scores meet in
//     shared memory, ONE half-warp per lane runs the online-softmax
//     update and leaves p and alpha in shared memory, and every thread
//     accumulates p*V for its own slots and 4 head dims.
// - Fixed-order combine.  A split that is its row's only split writes the
//   output itself; otherwise it writes (m, l, acc[D]) in f32 to a
//   workspace [rows, H, splits, D+2] and a combine kernel merges splits
//   0..n-1 in ascending order.  No atomics anywhere: a row's bits depend
//   only on its own q, length, table and pool — not on B, not on the
//   other rows, not on the launch.
//
// The decode kernel is the verify kernel's code at one lane: both run the
// same walk (NL = 1 and kVerifyLanes lanes) and combine_rows, and a
// lane's arithmetic does not depend on NL — explicit _rn intrinsics, so
// no contraction can differ, and a tensor-core tile row's sums do not
// depend on the other rows.  A verify block reads its split's K and V
// once for all its lanes; lane w takes part only in the units that start
// before its own length — the units the decode kernel walks at that
// length — and its combine runs over its own splits.
//
// ragged_paged_mma_kernel / ragged_paged_kernel — replace the Pallas
//   kernel paddle_infer_tpu/ops/pallas/ragged_paged_attention.py:132
//   `_ragged_kernel` (launched by `_ragged_kernel_call`, :239).  Row b
//   carries q_lens[b] queries at absolute positions ctx[b] + i under the
//   causal predicate slot <= ctx + i; positions past q_lens[b] are zeros.
//   The serving step sends its prompt-chunk rows through it.
//
// What bounds it: a head of a row reads its (ctx + q_len) K and V slots
// and does 4 * q_len * (ctx + q_len / 2) * D FLOPs on them, about q_len
// FLOPs per byte.  Decode-heavy mixes are bound by bytes; chunks of more
// than ~300 queries by tensor-core operations.  So the walk must both
// read each slot once per query tile and keep the tensor cores fed:
//
// - Tensor-core walk (ragged_paged_mma_kernel): bf16 / f16 queries over
//   16-bit or int8 pages, D in {64, 128, 256}, page % 16 == 0 — the
//   serving case.  A block owns (head, row, a tile of kRaggedQ = 128
//   queries); each of its 8 warps holds 16 queries as the rows of its
//   m16n8k16 tiles.  The Q tile sits in shared memory for the whole walk
//   (fragments by ldmatrix).  KV tiles of kRaggedK = 64 slots, aligned to
//   the row's slot 0 and gathered page by page, stream through a ring of
//   2..kMaxStages stages (kRaggedRingBytes) with 16-byte cp.async
//   copies, XOR-swizzled as the decode walk's; each 16-slot group's pool
//   offset is read from the table one tile ahead, so no copy waits on a
//   table read.  S = Q K^T in f32; the online softmax runs in registers
//   (ex2 of one FFMA a score, m and l in f32); p is rounded to the query
//   type as the A operand of P V; O stays in f32.  int8 tiles are widened
//   once by the block; the K scale of a page multiplies its score
//   columns, the V scale is applied in f32 to the page's own zeroed
//   product (a page of 16 is one k-step).  Against other shapes of the
//   same walk timed on an H100: 128 queries a block halve the L2 reads
//   of K and V and beat 64; two row tiles a warp spill and lose at
//   decode-heavy mixes; smaller KV tiles (more blocks an SM) and a
//   deeper ring gain nothing.
// - Causal tile walk.  A block walks only the KV tiles its last query
//   can see; a warp masks only tiles that cross its diagonal or the
//   window's end and skips tiles past its own last query.  Slots past
//   the block's last query are zero-filled (cp.async src-size 0), so a
//   masked weight 0 never meets a stale value.  Tiles whose queries all
//   lie at or past q_lens[b] write zeros and exit.  The grid is (H, B,
//   ceil(C / kRaggedQ)) from the shapes alone, longest walks first; the
//   host reads nothing.
// - Row and chunk independence.  A query's bits depend only on its own
//   row's q, its absolute position, table and pool: KV tiles are
//   absolute, rows of a tensor-core tile do not mix, and a walked tile
//   that is fully masked for a query is an exact identity (alpha = 1,
//   p = 0).  So a prompt chunked two ways gives the same bits.
// - CUDA-core walk (ragged_paged_kernel) for f32 queries and other head
//   dims or page sizes: one block per (row, head, 16 queries), f32 tiles
//   in shared memory, scalar dot products, one thread per query's
//   softmax; the same masking and zeros, slower.
//
// Numerics shared by all three: NEG_INF = -1e30 (not -inf, so exp(m_prev -
// m_new) is 0, never NaN, on the first page), masked slots score NEG_INF
// and weigh exactly 0, out = acc / max(l, 1e-20), written in q's dtype;
// a row of length 0 gives zeros.
//
// C interface (ctypes): every pointer and the stream are void*; each
// entry returns cudaGetLastError() after its launches.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 16;          // queries per CUDA-core ragged tile
constexpr int kMaxDPT = 2;       // head dims per thread in the ragged PV loop
constexpr int kRaggedQ = 128;    // queries per tensor-core ragged block
constexpr int kRaggedThreads = 2 * kRaggedQ;   // a warp per 16 queries
constexpr int kRaggedK = 64;     // slots per ragged KV tile
constexpr int kRaggedGroups = kRaggedK / 16;   // k-steps of 16 slots a tile
constexpr int kRaggedRingBytes = 48 * 1024;    // ragged ring budget
constexpr int kSplitPages = 8;   // pages of a row per decode / verify block
constexpr int kChunk = 16;       // slots per ring unit (a half-warp's softmax)
constexpr int kMaxStages = 4;    // ring depth
constexpr int kRingBytes = 16 * 1024;  // ring budget of one block
constexpr int kVerifyLanes = 8;  // verify lanes sharing one block's walk
constexpr int kSlotThreads = kThreads / kChunk;  // score threads a slot, at most
constexpr int kPVDims = 4;       // head dims a thread accumulates in p*V
static_assert(kChunk <= 16, "one half-warp runs a unit's softmax");
static_assert(kVerifyLanes <= 2 * kThreads / 32, "a half-warp per lane");
static_assert(kMaxStages <= 4, "cp_async_wait takes depths 0..2");
static_assert(kRaggedQ % 16 == 0, "16 ragged queries a warp");

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// 16 bytes of consecutive T (8 bf16 / 4 f32 / 16 int8) as floats.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
}

// ------------------------------------------------------- decode / verify

// Page elements one score thread reads as a vector: 4 f32 (16 bytes) or
// 8 bf16 / f16 (16 bytes) / int8 (8 bytes).
template <typename KT>
struct Vec {
  static constexpr int N = sizeof(KT) == 4 ? 4 : 8;
};

// n consecutive page elements from shared memory, as floats, in one load
// of n * sizeof(KT) bytes (4 to 16).
template <typename KT, int N>
__device__ __forceinline__ void lds_n(const KT* p, float* out) {
  struct alignas(N * sizeof(KT)) Pack { KT e[N]; };
  const Pack raw = *reinterpret_cast<const Pack*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(raw.e[i]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// 16 bytes from src, or 16 zero bytes when !full (src-size 0: src is not
// read, but must be a valid address)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

// 2^x, flushing denormal results to 0 (ex2.approx.ftz: a few ulp)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's newest copy groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from device to shared memory, 16 per copy,
// spread over the block's threads.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    cp_async16(static_cast<char*>(dst) + i,
               static_cast<const char*>(src) + i);
}

// A row's page count: ceil(len / page), clamped to the table's width.
__host__ __device__ __forceinline__ int row_pages(int len, int page,
                                                  int max_pages) {
  const int n = len > 0 ? (len + page - 1) / page : 0;
  return n > max_pages ? max_pages : n;
}

// Rows of K (and of V) in one ring unit: a page, or kChunk of its slots.
__host__ __device__ __forceinline__ int ring_rows(int page) {
  return page < kChunk ? page : kChunk;
}

// Ring stages for units of `rows` rows of K and of V: as many as `bytes`
// holds, 2 to kMaxStages.
__host__ __device__ constexpr int ring_stages(int bytes, int rows, int D,
                                              int esize) {
  const int s = bytes / (2 * rows * D * esize);
  return s < 2 ? 2 : (s > kMaxStages ? kMaxStages : s);
}

__host__ __device__ __forceinline__ int take(int& off, int bytes) {
  const int at = off;
  off += (bytes + 15) / 16 * 16;
  return at;
}

// Byte offsets of one split block's shared memory.
struct SplitLayout {
  int sc, p, alpha, ml, red, q, pid, ksc, vsc, total;
  __host__ __device__ SplitLayout(int nl, int D, int page, int esize,
                                  int stages) {
    int off = stages * 2 * ring_rows(page) * D * esize;  // the ring
    sc = take(off, nl * kChunk * 4);         // [nl][kChunk] scores
    p = take(off, nl * kChunk * 4);          // [nl][kChunk] weights
    alpha = take(off, nl * 4);               // [nl] rescale of the sum
    ml = take(off, 2 * nl * 4);              // [nl][m, l]
    red = take(off, kThreads * kPVDims * 4); // [groups][D] partial sums
    q = take(off, nl * D * 4);               // [nl][G][D / G] queries
    pid = take(off, kSplitPages * 4);        // the split's page ids
    ksc = take(off, kSplitPages * 4);        // and their int8 scales
    vsc = take(off, kSplitPages * 4);
    total = off;
  }
};

// The scores' thread mapping: G threads a slot (G <= kSlotThreads, so a
// unit's slots take one pass), each reading vpl vectors of the slot's K
// row: vectors lig, lig + G, ...
template <typename KT>
struct ScoreMap {
  int G, vpl, gid, lig;
  __device__ __forceinline__ explicit ScoreMap(int D) {
    const int nvec = D / Vec<KT>::N;
    G = nvec < kSlotThreads ? nvec : kSlotThreads;
    vpl = nvec / G;
    gid = threadIdx.x / G;
    lig = threadIdx.x % G;
  }
};

// Scores of one unit (ns <= kChunk slots of K in shared memory, row
// stride D) for every lane in `act`: each thread dots its vectors of one
// slot with the lane's query (fixed order), the group's G partial sums
// meet by xor-shuffles, and slots at or past the lane's length score
// kNegInf.  The lanes' shuffles interleave; each lane's own sequence of
// operations is the same whatever NL is.
template <typename KT, int NL>
__device__ __forceinline__ void unit_scores(const KT* ks, const float* qs,
                                            float* sc, const int* len,
                                            unsigned act, int ns, int D,
                                            int pos0, float kscale,
                                            float scale) {
  constexpr int VEC = Vec<KT>::N;
  const ScoreMap<KT> sm(D);
  const int qpl = sm.vpl * VEC;
  for (int s0 = 0; s0 < ns; s0 += kThreads / sm.G) {
    const int s = s0 + sm.gid;
    float part[NL];
#pragma unroll
    for (int w = 0; w < NL; ++w) part[w] = 0.f;
    if (s < ns) {
      for (int v = 0; v < sm.vpl; ++v) {
        float kf[VEC];
        lds_n<KT, VEC>(ks + s * D + (sm.lig + v * sm.G) * VEC, kf);
#pragma unroll
        for (int w = 0; w < NL; ++w) {
          if (act >> w & 1u) {
            const float* qw = qs + (w * sm.G + sm.lig) * qpl + v * VEC;
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qw + e);
              part[w] = __fmaf_rn(q4.x, kf[e], part[w]);
              part[w] = __fmaf_rn(q4.y, kf[e + 1], part[w]);
              part[w] = __fmaf_rn(q4.z, kf[e + 2], part[w]);
              part[w] = __fmaf_rn(q4.w, kf[e + 3], part[w]);
            }
          }
        }
      }
    }
    for (int off = sm.G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int w = 0; w < NL; ++w)
        if (act >> w & 1u)
          part[w] = __fadd_rn(part[w],
                              __shfl_xor_sync(0xffffffffu, part[w], off));
    }
    if (s < ns && sm.lig == 0) {
#pragma unroll
      for (int w = 0; w < NL; ++w)
        if (act >> w & 1u)
          sc[w * kChunk + s] =
              pos0 + s < len[w]
                  ? __fmul_rn(__fmul_rn(part[w], kscale), scale)
                  : kNegInf;
    }
  }
}

// One lane's online-softmax update from one unit's scores, run by ONE
// half-warp (thread t holds slot t); the whole warp calls it, and a half
// whose lane is not `on` computes but writes nothing.  m and l (ml[0],
// ml[1]) advance; each slot's weight times the page's V scale (p) and the
// earlier sum's rescale (alpha) are left in shared memory.
__device__ __forceinline__ void unit_softmax(const float* sc, float* p,
                                             float* alpha, float* ml,
                                             int ns, float vscale,
                                             bool on) {
  const int t = threadIdx.x & 15;
  const float x = t < ns ? sc[t] : kNegInf;
  float mc = x;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
  const float m = ml[0];
  const float mn = fmaxf(m, mc);
  const float pt = t < ns ? expf(__fsub_rn(x, mn)) : 0.f;
  float ps = pt;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, off));
  if (on && t < ns) p[t] = __fmul_rn(pt, vscale);
  if (on && t == 0) {
    const float a = expf(__fsub_rn(m, mn));
    *alpha = a;
    ml[0] = mn;
    ml[1] = __fmaf_rn(ml[1], a, ps);
  }
}

// The p*V mapping: each thread holds kPVDims consecutive head dims (vi)
// for the slots of its slot group (sg): sg, sg + nsg, ...
struct PVMap {
  int vi, sg, nsg;
  __device__ __forceinline__ explicit PVMap(int D) {
    const int nv = D / kPVDims;
    vi = threadIdx.x % nv;
    sg = threadIdx.x / nv;
    nsg = kThreads / nv;
  }
};

// p*V of one unit into this thread's accumulators, each lane's sum first
// rescaled by alpha.
template <typename KT, int NL>
__device__ __forceinline__ void unit_pv(const KT* vs, const float* p,
                                        const float* alpha, unsigned act,
                                        int ns, int D,
                                        float (&acc)[NL][kPVDims]) {
  const PVMap pm(D);
#pragma unroll
  for (int w = 0; w < NL; ++w) {
    if (act >> w & 1u) {
      const float a = alpha[w];
#pragma unroll
      for (int e = 0; e < kPVDims; ++e) acc[w][e] = __fmul_rn(acc[w][e], a);
    }
  }
  for (int s = pm.sg; s < ns; s += pm.nsg) {
    float vf[kPVDims];
    lds_n<KT, kPVDims>(vs + s * D + pm.vi * kPVDims, vf);
#pragma unroll
    for (int w = 0; w < NL; ++w) {
      if (act >> w & 1u) {
        const float pv = p[w * kChunk + s];
#pragma unroll
        for (int e = 0; e < kPVDims; ++e)
          acc[w][e] = __fmaf_rn(pv, vf[e], acc[w][e]);
      }
    }
  }
}

// One block's split: lanes w0 .. w0 + NL - 1 of row b (W lanes a row;
// decode is W = NL = 1), head h, pages s*kSplitPages .. of the row.
template <typename QT, typename KT, int NL>
__device__ __forceinline__ void split_walk(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ lengths, QT* __restrict__ out,
    float* __restrict__ ws, int P, int W, int H, int D, int page,
    int max_pages, int nsplit, int stages, float scale, int b, int h,
    int s, int w0) {
  constexpr int VEC = Vec<KT>::N;
  extern __shared__ __align__(16) unsigned char pa_smem[];
  const int tid = threadIdx.x;
  const int nl = W - w0 < NL ? W - w0 : NL;
  const int p0 = s * kSplitPages;
  // the split's table entry (one a thread) and the lanes' lengths, all
  // in flight together
  const int* trow = tables + static_cast<size_t>(b) * max_pages;
  const int entry =
      tid < kSplitPages && p0 + tid < max_pages ? trow[p0 + tid] : 0;
  int len[NL], np[NL];
  int maxlen = 0, maxnp = 0;
#pragma unroll
  for (int w = 0; w < NL; ++w) {
    len[w] = w < nl ? lengths[static_cast<size_t>(b) * W + w0 + w] : 0;
    np[w] = row_pages(len[w], page, max_pages);
    maxlen = len[w] > maxlen ? len[w] : maxlen;
    maxnp = np[w] > maxnp ? np[w] : maxnp;
  }
  if (p0 >= maxnp) return;                 // no lane reaches this split
  const int npg = maxnp - p0 < kSplitPages ? maxnp - p0 : kSplitPages;
  const int nc = (page + kChunk - 1) / kChunk;   // units per page
  const int nu = npg * nc;
  const int rows = ring_rows(page);
  const SplitLayout L(NL, D, page, sizeof(KT), stages);
  KT* ring = reinterpret_cast<KT*>(pa_smem);
  float* sc = reinterpret_cast<float*>(pa_smem + L.sc);
  float* pw = reinterpret_cast<float*>(pa_smem + L.p);
  float* al = reinterpret_cast<float*>(pa_smem + L.alpha);
  float* ml = reinterpret_cast<float*>(pa_smem + L.ml);
  float* red = reinterpret_cast<float*>(pa_smem + L.red);
  float* qs = reinterpret_cast<float*>(pa_smem + L.q);
  int* pid = reinterpret_cast<int*>(pa_smem + L.pid);
  float* kss = reinterpret_cast<float*>(pa_smem + L.ksc);
  float* vss = reinterpret_cast<float*>(pa_smem + L.vsc);

  // the split's page ids (clamped to [0, P)) and scales, read once
  if (tid < npg) {
    const int phys = entry < 0 ? 0 : (entry >= P ? P - 1 : entry);
    pid[tid] = phys;
    const size_t ph = static_cast<size_t>(phys) * H + h;
    kss[tid] = ksc ? ksc[ph] : 1.f;
    vss[tid] = vsc ? vsc[ph] : 1.f;
  }
  if (tid < NL) {
    ml[2 * tid] = kNegInf;
    ml[2 * tid + 1] = 0.f;
  }
  __syncthreads();

  // unit u: page p0 + u / nc, slots (u % nc) * kChunk ..; loaded only
  // when some lane reaches it
  auto load_unit = [&](int u) {
    const int j = u / nc, c = u % nc;
    if ((p0 + j) * page + c * kChunk >= maxlen) return;
    const int ns = page - c * kChunk < kChunk ? page - c * kChunk : kChunk;
    const size_t src =
        (static_cast<size_t>(pid[j]) * H + h) * page * D +
        static_cast<size_t>(c) * kChunk * D;
    KT* dst = ring + static_cast<size_t>(u % stages) * 2 * rows * D;
    const int bytes = ns * D * static_cast<int>(sizeof(KT));
    copy_async(dst, kp + src, bytes);
    copy_async(dst + rows * D, vp + src, bytes);
  };

  float acc[NL][kPVDims];
#pragma unroll
  for (int w = 0; w < NL; ++w)
#pragma unroll
    for (int e = 0; e < kPVDims; ++e) acc[w][e] = 0.f;

  for (int u = 0; u < stages - 1; ++u) {
    if (u < nu) load_unit(u);
    cp_async_commit();
  }
  // each lane's query, laid out per (lane, score thread lig), loaded
  // while the first units are in flight (visible after the first unit's
  // barrier)
  const ScoreMap<KT> sm(D);
  const int qpl = sm.vpl * VEC;
  for (int i = tid; i < nl * D; i += kThreads) {
    const int w = i / D, r = i % D;
    const int li = r / qpl, v = (r % qpl) / VEC, e = r % VEC;
    const QT* qrow =
        q + ((static_cast<size_t>(b) * W + w0 + w) * H + h) * D;
    qs[i] = to_f(qrow[(li + v * sm.G) * VEC + e]);
  }
  // the softmax of lane hw runs in half-warp hw (a warp holds two lanes)
  const int hw = tid >> 4, hwl = hw < NL ? hw : 0;
  for (int u = 0; u < nu; ++u) {
    cp_async_wait(stages - 2);
    // unit u has landed, and every thread is done with unit u - 1, whose
    // stage the next copies reuse
    __syncthreads();
    if (u + stages - 1 < nu) load_unit(u + stages - 1);
    cp_async_commit();
    const int j = u / nc, c = u % nc;
    const int pos0 = (p0 + j) * page + c * kChunk;
    if (pos0 >= maxlen) continue;
    const int ns = page - c * kChunk < kChunk ? page - c * kChunk : kChunk;
    unsigned act = 0;
#pragma unroll
    for (int w = 0; w < NL; ++w)
      if (w < nl && p0 + j < np[w] && pos0 < len[w]) act |= 1u << w;
    const KT* kst = ring + static_cast<size_t>(u % stages) * 2 * rows * D;
    unit_scores<KT, NL>(kst, qs, sc, len, act, ns, D, pos0, kss[j], scale);
    __syncthreads();
    if (act >> (hw & ~1) & 3u)             // a lane of this warp is on
      unit_softmax(sc + hwl * kChunk, pw + hwl * kChunk, al + hwl,
                   ml + 2 * hwl, ns, vss[j], hw < NL && (act >> hw & 1u));
    __syncthreads();
    unit_pv<KT, NL>(kst + rows * D, pw, al, act, ns, D, acc);
  }
  cp_async_wait(0);

  // per lane: the slot groups' partial sums in order, then the output (a
  // row's only split) or the split's (m, l, acc) for the combine
  const PVMap pm(D);
#pragma unroll
  for (int w = 0; w < NL; ++w) {
    if (w < nl && p0 < np[w]) {
#pragma unroll
      for (int e = 0; e < kPVDims; ++e)
        red[pm.sg * D + pm.vi * kPVDims + e] = acc[w][e];
      __syncthreads();
      const int n = (np[w] + kSplitPages - 1) / kSplitPages;
      const size_t row = (static_cast<size_t>(b) * W + w0 + w) * H + h;
      const float l = ml[2 * w + 1];
      float* part = ws + (row * nsplit + s) * (D + 2);
      for (int d = tid; d < D; d += kThreads) {
        float a = 0.f;
        for (int g = 0; g < pm.nsg; ++g) a = __fadd_rn(a, red[g * D + d]);
        if (n == 1)
          out[row * D + d] = from_f<QT>(__fdiv_rn(a, fmaxf(l, 1e-20f)));
        else
          part[2 + d] = a;
      }
      if (n > 1 && tid == 0) {
        part[0] = ml[2 * w];
        part[1] = l;
      }
      __syncthreads();
    }
  }
}

// ------------------------------------------- the tensor-core split walk
// 16-bit queries (bf16, f16) over 16-bit or int8 pages, D % 16 == 0.
// The block's lanes are the rows of an m16n8k16 tile (rows >= the lane
// count hold zeros): every warp computes the unit's 16 x 16 scores S =
// Q K^T on the tensor cores (the same S in every warp), runs each lane's
// online softmax in the quad of threads that holds its row, and adds
// P V for its own quarter of the head dims.  No barrier inside a unit:
// the one __syncthreads a unit hands the ring stage over.  Ring stages
// hold kChunk rows of K and V, their 16-byte chunks XOR-swizzled by row
// so the fragment loads meet no bank conflict.

template <typename QT, typename KT>
struct MmaPair {
  static constexpr bool value =
      (sizeof(QT) == 2) && (sizeof(KT) == 2 || sizeof(KT) == 1);
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16, float lo,
                                          float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
             << 16;
}
__device__ __forceinline__ uint32_t pack2(__half, float lo, float hi) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half(lo))) |
         static_cast<uint32_t>(__half_as_ushort(__float2half(hi))) << 16;
}

// D (4 f32) += A (16x16, 4 regs) B (16x8, 2 regs), bf16 or f16 operands
__device__ __forceinline__ void mma_m16n8k16(__nv_bfloat16, float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_m16n8k16(__half, float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; thread i gives the address
// of row i % 8 of matrix i / 8 (trans: each matrix transposed)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A stage row's layout: `chunks` 16-byte chunks, chunk c of row r stored
// at chunk c ^ (r & mask).
struct Swizzle {
  int row_bytes, mask;
  __host__ __device__ Swizzle(int D, int esize) {
    row_bytes = D * esize;
    const int chunks = row_bytes / 16;
    mask = (chunks < 8 ? chunks : 8) - 1;
  }
  // byte offset of element byte `e` of row r
  __device__ __forceinline__ int at(int r, int e) const {
    return r * row_bytes + ((((e >> 4) ^ (r & mask))) << 4) + (e & 15);
  }
};

// Byte offsets of one tensor-core split block's shared memory.
struct MmaLayout {
  int wide, qa, pid, ksc, vsc, total;
  __host__ __device__ MmaLayout(int D, int esize, int stages) {
    int off = stages * 2 * kChunk * D * esize;   // the ring
    wide = take(off, esize == 1 ? 2 * kChunk * D * 2 : 0);  // int8 widened
    qa = take(off, (D / 16) * 32 * 2 * 4);       // A fragments of Q
    pid = take(off, kSplitPages * 4);
    ksc = take(off, kSplitPages * 4);
    vsc = take(off, kSplitPages * 4);
    total = off;
  }
};

// B fragments of K^T at k-step `kstep` for both 8-slot halves of a unit
// (b[0], b[1]: slots 0..7; b[2], b[3]: slots 8..15) from a 16-bit stage.
__device__ __forceinline__ void k_frags(const unsigned char* ks,
                                        const Swizzle& sw, int kstep,
                                        uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3, row = 8 * (m >> 1) + (lane & 7);
  ldsm_x4(b, ks + sw.at(row, (16 * kstep + 8 * (m & 1)) * 2));
}

// B fragments of V for head-dim tiles dtA (b[0], b[1]: slots 0..7,
// 8..15) and dtB (b[2], b[3]) from a 16-bit stage.
__device__ __forceinline__ void v_frags(const unsigned char* vs,
                                        const Swizzle& sw, int dtA,
                                        int dtB, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3, slot = 8 * (m & 1) + (lane & 7);
  ldsm_x4_trans(b, vs + sw.at(slot, ((m >> 1) ? dtB : dtA) * 16));
}

// An int8 stage (`rows` K rows, then `rows` V rows) widened exactly to the
// compute type T in `wide`, both in their swizzled layouts; the block's
// threads share the 16-byte chunks.
template <typename T, int NThreads = kThreads>
__device__ __forceinline__ void widen_rows(const unsigned char* st,
                                           unsigned char* wide,
                                           const Swizzle& sw8,
                                           const Swizzle& sw16, int rows) {
  const int cpr = sw8.row_bytes / 16;               // int8 chunks a row
  for (int i = threadIdx.x; i < 2 * rows * cpr; i += NThreads) {
    const int r = i / cpr, e = (i % cpr) * 16;      // row of K then V
    const int rr = r % rows, half = (r / rows) * rows;
    const unsigned char* src = st + half * sw8.row_bytes + sw8.at(rr, e);
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      w[k] = pack2(T(), static_cast<float>(v[2 * k]),
                   static_cast<float>(v[2 * k + 1]));
    unsigned char* dst = wide + half * sw16.row_bytes;
    *reinterpret_cast<uint4*>(dst + sw16.at(rr, 2 * e)) =
        make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(dst + sw16.at(rr, 2 * e + 16)) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
}

constexpr int kMaxTiles = 256 / 8 / kWarps;  // head-dim tiles a warp holds

// One block's split on the tensor cores: the arguments of split_walk.
template <typename QT, typename KT, int NL>
__device__ __forceinline__ void split_walk_mma(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ lengths, QT* __restrict__ out,
    float* __restrict__ ws, int P, int W, int H, int D, int page,
    int max_pages, int nsplit, int stages, float scale, int b, int h,
    int s, int w0) {
  static_assert(NL <= 8, "a lane per row of the tiles' top half");
  extern __shared__ __align__(16) unsigned char pa_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;   // this thread's lane: row g
  const int nl = W - w0 < NL ? W - w0 : NL;
  const int p0 = s * kSplitPages;
  // the split's table entry (one a thread) and the lanes' lengths, all
  // in flight together
  const int* trow = tables + static_cast<size_t>(b) * max_pages;
  const int entry =
      tid < kSplitPages && p0 + tid < max_pages ? trow[p0 + tid] : 0;
  int maxlen = 0, maxnp = 0;
#pragma unroll
  for (int w = 0; w < NL; ++w) {
    const int lw =
        w < nl ? lengths[static_cast<size_t>(b) * W + w0 + w] : 0;
    maxlen = lw > maxlen ? lw : maxlen;
    const int npw = row_pages(lw, page, max_pages);
    maxnp = npw > maxnp ? npw : maxnp;
  }
  const int my_len =
      g < nl ? lengths[static_cast<size_t>(b) * W + w0 + g] : 0;
  const int my_np = row_pages(my_len, page, max_pages);
  if (p0 >= maxnp) return;                 // no lane reaches this split
  const int npg = maxnp - p0 < kSplitPages ? maxnp - p0 : kSplitPages;
  const int nc = (page + kChunk - 1) / kChunk;   // units per page
  const int nu = npg * nc;
  const Swizzle sw(D, sizeof(KT));
  const int stage_bytes = 2 * kChunk * sw.row_bytes;
  const MmaLayout L(D, sizeof(KT), stages);
  unsigned char* ring = pa_smem;
  unsigned char* wide = pa_smem + L.wide;
  const Swizzle sw16(D, 2);                // the 16-bit stage the tiles read
  uint32_t* qa = reinterpret_cast<uint32_t*>(pa_smem + L.qa);
  int* pid = reinterpret_cast<int*>(pa_smem + L.pid);
  float* kss = reinterpret_cast<float*>(pa_smem + L.ksc);
  float* vss = reinterpret_cast<float*>(pa_smem + L.vsc);

  if (tid < npg) {
    const int phys = entry < 0 ? 0 : (entry >= P ? P - 1 : entry);
    pid[tid] = phys;
    const size_t ph = static_cast<size_t>(phys) * H + h;
    kss[tid] = ksc ? ksc[ph] : 1.f;
    vss[tid] = vsc ? vsc[ph] : 1.f;
  }
  // a unit shorter than kChunk leaves stage rows unwritten: zeros, so
  // that a masked slot's weight 0 never meets a non-finite value
  if (page % kChunk)
    for (int i = tid * 16; i < stages * stage_bytes; i += kThreads * 16)
      *reinterpret_cast<uint4*>(ring + i) = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto load_unit = [&](int u) {
    const int j = u / nc, c = u % nc;
    if ((p0 + j) * page + c * kChunk >= maxlen) return;
    const int ns = page - c * kChunk < kChunk ? page - c * kChunk : kChunk;
    const size_t src = (static_cast<size_t>(pid[j]) * H + h) * page * D +
                       static_cast<size_t>(c) * kChunk * D;
    const char* kg = reinterpret_cast<const char*>(kp + src);
    const char* vg = reinterpret_cast<const char*>(vp + src);
    unsigned char* dst = ring + (u % stages) * stage_bytes;
    const int cpr = sw.row_bytes / 16;
    for (int i = tid; i < ns * cpr; i += kThreads) {
      const int at = sw.at(i / cpr, (i % cpr) * 16);
      cp_async16(dst + at, kg + i * 16);
      cp_async16(dst + stage_bytes / 2 + at, vg + i * 16);
    }
  };
  for (int u = 0; u < stages - 1; ++u) {
    if (u < nu) load_unit(u);
    cp_async_commit();
  }

  // Q's A fragments per (k-step, thread), loaded while the first units
  // are in flight: row g's dims 16ks + 2tig, +1 and 16ks + 2tig + 8, +9;
  // rows of absent lanes are zeros (visible after the first unit's
  // barrier)
  const int nks = D / 16;
  for (int i = tid; i < nks * 32; i += kThreads) {
    const int ks = i >> 5, gg = (i & 31) >> 2, tt = i & 3;
    uint32_t lo = 0, hi = 0;
    if (gg < nl) {
      const uint16_t* qr = reinterpret_cast<const uint16_t*>(
          q + ((static_cast<size_t>(b) * W + w0 + gg) * H + h) * D +
          16 * ks + 2 * tt);
      lo = qr[0] | static_cast<uint32_t>(qr[1]) << 16;
      hi = qr[8] | static_cast<uint32_t>(qr[9]) << 16;
    }
    qa[2 * i] = lo;
    qa[2 * i + 1] = hi;
  }

  // this warp's head-dim tiles: dt = warp, warp + kWarps, ...
  const int ntiles = D / 8;
  const int my_nt = warp < ntiles ? (ntiles - 1 - warp) / kWarps + 1 : 0;
  float o[kMaxTiles][2];
#pragma unroll
  for (int jt = 0; jt < kMaxTiles; ++jt) o[jt][0] = o[jt][1] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int u = 0; u < nu; ++u) {
    cp_async_wait(stages - 2);
    __syncthreads();                       // as in split_walk
    if (u + stages - 1 < nu) load_unit(u + stages - 1);
    cp_async_commit();
    const int j = u / nc, c = u % nc;
    const int pos0 = (p0 + j) * page + c * kChunk;
    if (pos0 >= maxlen) continue;
    const int ns = page - c * kChunk < kChunk ? page - c * kChunk : kChunk;
    const bool on = p0 + j < my_np && pos0 < my_len;
    const unsigned char* kst = ring + (u % stages) * stage_bytes;
    if constexpr (sizeof(KT) == 1) {       // int8: widen, then as 16-bit
      widen_rows<QT>(kst, wide, sw, sw16, kChunk);
      __syncthreads();
      kst = wide;
    }
    const unsigned char* vst = kst + kChunk * sw16.row_bytes;

    // S = Q K^T: row g, slots 8nt + 2tig (+1) in sacc[nt][0 (1)]
    float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t kb[4];
      k_frags(kst, sw16, ks, kb);
      const uint2 a2 = *reinterpret_cast<const uint2*>(qa + 2 * (ks * 32 +
                                                                 lane));
      const uint32_t a[4] = {a2.x, 0u, a2.y, 0u};
      mma_m16n8k16(QT(), sacc[0], a, kb[0], kb[1]);
      mma_m16n8k16(QT(), sacc[1], a, kb[2], kb[3]);
    }
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int slot = 8 * (i >> 1) + 2 * tig + (i & 1);
      x[i] = slot < ns && pos0 + slot < my_len
                 ? __fmul_rn(__fmul_rn(sacc[i >> 1][i & 1], kss[j]), scale)
                 : kNegInf;
    }
    // row g's online softmax in its quad: one expf per slot
    float mc = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float mn = fmaxf(m, mc);
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = expf(__fsub_rn(x[i], mn));
    float ps = __fadd_rn(__fadd_rn(pv[0], pv[1]), __fadd_rn(pv[2], pv[3]));
    ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 1));
    ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 2));
    float a = 1.f;
    if (on) {
      a = expf(__fsub_rn(m, mn));
      l = __fmaf_rn(l, a, ps);
      m = mn;
    } else {
      pv[0] = pv[1] = pv[2] = pv[3] = 0.f;
    }
    // p rounded to the query type (the tile's operand type); the page's
    // V scale stays in f32, folded in after the product
    const float vs = vss[j];
    const uint32_t pa[4] = {pack2(QT(), pv[0], pv[1]), 0u,
                            pack2(QT(), pv[2], pv[3]), 0u};

    // O (row g, this warp's tiles) = alpha O + vscale (P V)
#pragma unroll
    for (int jt = 0; jt < kMaxTiles; jt += 2) {
      if (jt < my_nt) {
        const int dtA = warp + kWarps * jt;
        const bool two = jt + 1 < my_nt;
        uint32_t vb[4];
        v_frags(vst, sw16, dtA, two ? dtA + kWarps : dtA, vb);
        float d0[4] = {0.f, 0.f, 0.f, 0.f};
        mma_m16n8k16(QT(), d0, pa, vb[0], vb[1]);
        o[jt][0] = __fmaf_rn(vs, d0[0], __fmul_rn(o[jt][0], a));
        o[jt][1] = __fmaf_rn(vs, d0[1], __fmul_rn(o[jt][1], a));
        if (two) {
          float d1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_m16n8k16(QT(), d1, pa, vb[2], vb[3]);
          o[jt + 1][0] = __fmaf_rn(vs, d1[0], __fmul_rn(o[jt + 1][0], a));
          o[jt + 1][1] = __fmaf_rn(vs, d1[1], __fmul_rn(o[jt + 1][1], a));
        }
      }
    }
  }
  cp_async_wait(0);

  // row g: the output (its row's only split) or the split's (m, l, acc)
  if (g < nl && p0 < my_np) {
    const int n = (my_np + kSplitPages - 1) / kSplitPages;
    const size_t row = (static_cast<size_t>(b) * W + w0 + g) * H + h;
    float* part = ws + (row * nsplit + s) * (D + 2);
    const float den = fmaxf(l, 1e-20f);
#pragma unroll
    for (int jt = 0; jt < kMaxTiles; ++jt) {
      if (jt < my_nt) {
        const int d = 8 * (warp + kWarps * jt) + 2 * tig;
        if (n == 1) {
          out[row * D + d] = from_f<QT>(__fdiv_rn(o[jt][0], den));
          out[row * D + d + 1] = from_f<QT>(__fdiv_rn(o[jt][1], den));
        } else {
          part[2 + d] = o[jt][0];
          part[3 + d] = o[jt][1];
        }
      }
    }
    if (n > 1 && warp == 0 && tig == 0) {
      part[0] = m;
      part[1] = l;
    }
  }
}

// Row r (= b * W + w) and head h of the output from its splits' (m, l,
// acc) in ascending split order; a row of one split was written by its
// split, a row of length 0 gets zeros.
template <typename QT>
__device__ __forceinline__ void combine_rows(const float* __restrict__ ws,
                                             const int* __restrict__ lengths,
                                             QT* __restrict__ out, int H,
                                             int D, int page, int max_pages,
                                             int nsplit) {
  const int r = blockIdx.x, h = blockIdx.y;
  const int n =
      (row_pages(lengths[r], page, max_pages) + kSplitPages - 1) /
      kSplitPages;
  if (n == 1) return;
  const size_t row = static_cast<size_t>(r) * H + h;
  QT* o = out + row * D;
  if (n == 0) {
    for (int d = threadIdx.x; d < D; d += kThreads) o[d] = from_f<QT>(0.f);
    return;
  }
  const float* part = ws + row * nsplit * (D + 2);
  float m = part[0];
  for (int s = 1; s < n; ++s) m = fmaxf(m, part[s * (D + 2)]);
  float l = 0.f;
  for (int s = 0; s < n; ++s)
    l = __fmaf_rn(part[s * (D + 2) + 1],
                  expf(__fsub_rn(part[s * (D + 2)], m)), l);
  const float denom = fmaxf(l, 1e-20f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n; ++s)
      a = __fmaf_rn(part[s * (D + 2) + 2 + d],
                    expf(__fsub_rn(part[s * (D + 2)], m)), a);
    o[d] = from_f<QT>(__fdiv_rn(a, denom));
  }
}

// The split walk for one (QT, KT, D): the tensor-core walk where it
// applies, else the CUDA-core one; decode and verify always take the
// same walk.  Each walk is its own kernel instantiation (Mma), so
// neither pays the other's registers.
template <typename QT, typename KT>
bool use_mma(int D) {
  return MmaPair<QT, KT>::value && D % 16 == 0;
}

template <typename QT, typename KT, int NL, bool Mma>
__device__ __forceinline__ void walk(
    const QT* q, const KT* kp, const KT* vp, const float* ksc,
    const float* vsc, const int* tables, const int* lengths, QT* out,
    float* ws, int P, int W, int H, int D, int page, int max_pages,
    int nsplit, int stages, float scale, int b, int h, int s, int w0) {
  if constexpr (Mma)
    split_walk_mma<QT, KT, NL>(q, kp, vp, ksc, vsc, tables, lengths, out,
                               ws, P, W, H, D, page, max_pages, nsplit,
                               stages, scale, b, h, s, w0);
  else
    split_walk<QT, KT, NL>(q, kp, vp, ksc, vsc, tables, lengths, out, ws,
                           P, W, H, D, page, max_pages, nsplit, stages,
                           scale, b, h, s, w0);
}

template <typename QT, typename KT, bool Mma>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ lengths, QT* __restrict__ out,
    float* __restrict__ ws, int P, int H, int D, int page, int max_pages,
    int nsplit, int stages, float scale) {
  walk<QT, KT, 1, Mma>(q, kp, vp, ksc, vsc, tables, lengths, out, ws, P, 1,
                       H, D, page, max_pages, nsplit, stages, scale,
                       blockIdx.x, blockIdx.y, blockIdx.z, 0);
}

template <typename QT, typename KT, bool Mma>
__global__ void __launch_bounds__(kThreads) paged_verify_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ lengths, QT* __restrict__ out,
    float* __restrict__ ws, int P, int W, int H, int D, int page,
    int max_pages, int nsplit, int stages, float scale) {
  walk<QT, KT, kVerifyLanes, Mma>(q, kp, vp, ksc, vsc, tables, lengths,
                                  out, ws, P, W, H, D, page, max_pages,
                                  nsplit, stages, scale, blockIdx.x,
                                  blockIdx.y, blockIdx.z % nsplit,
                                  (blockIdx.z / nsplit) * kVerifyLanes);
}

// one combine per kernel, so a profile tells the two apart
template <typename QT>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ lengths,
    QT* __restrict__ out, int H, int D, int page, int max_pages,
    int nsplit) {
  combine_rows<QT>(ws, lengths, out, H, D, page, max_pages, nsplit);
}

template <typename QT>
__global__ void __launch_bounds__(kThreads) paged_verify_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ lengths,
    QT* __restrict__ out, int H, int D, int page, int max_pages,
    int nsplit) {
  combine_rows<QT>(ws, lengths, out, H, D, page, max_pages, nsplit);
}

// ---------------------------------------------------------------- ragged
// The tensor-core ragged walk (see the note at the top).

// Byte offsets of one ragged block's shared memory.
struct RaggedLayout {
  int q, ring, wide, gb, ksc, vsc, total;
  __host__ __device__ RaggedLayout(int D, int esize, int stages) {
    int off = 0;
    q = take(off, kRaggedQ * D * 2);                       // the Q tile
    ring = take(off, stages * 2 * kRaggedK * D * esize);   // K, V tiles
    wide = take(off, esize == 1 ? 2 * kRaggedK * D * 2 : 0);  // int8 widened
    gb = take(off, stages * kRaggedGroups * 8);   // a stage's group bases
    ksc = take(off, stages * kRaggedGroups * 4);  // its K scales
    vsc = take(off, stages * kRaggedGroups * 4);  // and V scales
    total = off;
  }
};

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kRaggedThreads) ragged_paged_mma_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ ctx_lens, const int* __restrict__ q_lens,
    QT* __restrict__ out, int P, int C, int H, int page, int max_pages,
    float scale_log2) {
  constexpr int NT = D / 8;                // head-dim tiles of O
  constexpr int NKS = D / 16;              // k-steps of Q K^T
  constexpr int CPR = D * 2 / 16;          // 16-byte chunks of a 16-bit row
  constexpr int KCPR = D * sizeof(KT) / 16;  // and of a pool row
  constexpr int G = kRaggedGroups;
  constexpr int stages =
      ring_stages(kRaggedRingBytes, kRaggedK, D, sizeof(KT));
  // a thread copies chunk tid % KCPR of rows tid / KCPR + k * KSTEP
  constexpr int KSTEP = kRaggedThreads / KCPR;
  constexpr int QSTEP = kRaggedThreads / CPR;
  static_assert(kRaggedK % KSTEP == 0 && kRaggedQ % QSTEP == 0,
                "whole passes of the block's copies");
  extern __shared__ __align__(16) unsigned char pa_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kRaggedQ;  // longest first
  const int ctx = ctx_lens[b];
  const int ql = q_lens[b];
  const int qlen = ql < 0 ? 0 : (ql > C ? C : ql);
  const size_t rs = static_cast<size_t>(H) * D;   // a position's stride
  QT* obase = out + static_cast<size_t>(b) * C * rs +
              static_cast<size_t>(h) * D;
  if (i0 >= qlen) {          // every query of the tile is a pad: zeros
    const int rows = C - i0 < kRaggedQ ? C - i0 : kRaggedQ;
    for (int i = tid; i < rows * CPR; i += kRaggedThreads)
      reinterpret_cast<uint4*>(obase + (i0 + i / CPR) * rs)[i % CPR] =
          make_uint4(0, 0, 0, 0);
    return;
  }
  const int nq = qlen - i0 < kRaggedQ ? qlen - i0 : kRaggedQ;
  const int wslots = max_pages * page;
  // slots < lim_blk are visible to the tile's last query
  int lim_blk = ctx + i0 + nq < wslots ? ctx + i0 + nq : wslots;
  lim_blk = lim_blk < 0 ? 0 : lim_blk;
  const int ntiles = (lim_blk + kRaggedK - 1) / kRaggedK;
  const Swizzle sw(D, sizeof(KT)), sw16(D, 2);
  const int stage_bytes = 2 * kRaggedK * sw.row_bytes;
  const RaggedLayout L(D, sizeof(KT), stages);
  unsigned char* qs = pa_smem + L.q;
  unsigned char* ring = pa_smem + L.ring;
  unsigned char* wide = pa_smem + L.wide;
  size_t* gb = reinterpret_cast<size_t*>(pa_smem + L.gb);
  float* kss = reinterpret_cast<float*>(pa_smem + L.ksc);
  float* vss = reinterpret_cast<float*>(pa_smem + L.vsc);
  const int* trow = tables + static_cast<size_t>(b) * max_pages;

  // A tile's 16-slot group g (a group lies in one page) starts at pool
  // element gb[stage][g]; thread g < G reads tile t's table entry one
  // iteration before the tile's copies are issued and leaves the base in
  // the ring (int8: with the page's scales), so no copy waits on a table
  // read.  Groups at or past lim_blk are never loaded.
  auto table_entry = [&](int t) {
    const int s = t * kRaggedK + 16 * tid;
    return s < lim_blk ? trow[s / page] : 0;
  };
  auto phys_page = [&](int e) { return e < 0 ? 0 : (e >= P ? P - 1 : e); };
  auto group_base = [&](int t, int e) {
    const int s = t * kRaggedK + 16 * tid;
    return (static_cast<size_t>(phys_page(e)) * H + h) * page * D +
           static_cast<size_t>(s % page) * D;
  };
  if (tid < G) {
    for (int t = 0; t < stages; ++t) {
      const int e = table_entry(t);
      gb[t * G + tid] = group_base(t, e);
      if constexpr (sizeof(KT) == 1) {
        const size_t ph = static_cast<size_t>(phys_page(e)) * H + h;
        kss[t * G + tid] = ksc[ph];
        vss[t * G + tid] = vsc[ph];
      }
    }
  }

  // the Q tile, rows past q_len zero: the first copy group
#pragma unroll
  for (int k = 0; k < kRaggedQ / QSTEP; ++k) {
    const int r = tid / CPR + k * QSTEP, c = tid % CPR;
    const bool ok = r < nq;
    const char* src = reinterpret_cast<const char*>(
        ok ? q + (static_cast<size_t>(b) * C + i0 + r) * rs +
                 static_cast<size_t>(h) * D
           : q);
    cp_async16_zfill(qs + sw16.at(r, c * 16), src + (ok ? c * 16 : 0), ok);
  }
  cp_async_commit();

  __syncthreads();                         // the first group bases

  // KV tile u (slots u * kRaggedK ..) into stage u % stages: slot row r
  // from its group's base, rows at or past lim_blk zero
  const int lc = tid % KCPR;
  auto load_tile = [&](int u) {
    const int st = u % stages, s0 = u * kRaggedK;
    unsigned char* dst = ring + st * stage_bytes;
#pragma unroll
    for (int k = 0; k < kRaggedK / KSTEP; ++k) {
      const int r = tid / KCPR + k * KSTEP;
      const bool ok = s0 + r < lim_blk;
      const size_t src =
          ok ? gb[st * G + (r >> 4)] + static_cast<size_t>(r & 15) * D : 0;
      const int at = sw.at(r, lc * 16), off = ok ? lc * 16 : 0;
      cp_async16_zfill(dst + at, reinterpret_cast<const char*>(kp + src) + off,
                       ok);
      cp_async16_zfill(dst + stage_bytes / 2 + at,
                       reinterpret_cast<const char*>(vp + src) + off, ok);
    }
  };
  for (int u = 0; u < stages - 1; ++u) {
    if (u < ntiles) load_tile(u);
    cp_async_commit();
  }

  // this warp's queries wq0 .. wq0 + wn - 1: slots < wlo are visible to
  // all of them, slots < whi to the last; this thread's rows g and g + 8
  // see slots < lim[0], lim[1] (0 for a pad row)
  const int wq0 = i0 + 16 * warp;
  const int wn = qlen - wq0 < 0 ? 0 : (qlen - wq0 > 16 ? 16 : qlen - wq0);
  const int wlo = ctx + wq0 + 1 < wslots ? ctx + wq0 + 1 : wslots;
  const int whi = ctx + wq0 + wn < wslots ? ctx + wq0 + wn : wslots;
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    lim[r] = qi < qlen ? (ctx + qi + 1 < wslots ? ctx + qi + 1 : wslots) : 0;
  }
  float o[NT][4];
#pragma unroll
  for (int dt = 0; dt < NT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int mq = lane >> 3;                // ldmatrix: this lane's matrix
  int e_next = 0;                          // thread g < G: the prefetch
  float ks_next = 1.f, vs_next = 1.f;

  for (int u = 0; u < ntiles; ++u) {
    cp_async_wait(stages - 2);
    // tile u (and the Q tile) has landed, and every thread is done with
    // tile u - 1, whose stage the next copies reuse
    __syncthreads();
    const int st = u % stages, s0 = u * kRaggedK;
    if constexpr (sizeof(KT) == 1) {       // tile u - 1 + stages's scales
      if (u > 0 && tid < G && u - 1 + stages < ntiles) {
        kss[((u - 1) % stages) * G + tid] = ks_next;
        vss[((u - 1) % stages) * G + tid] = vs_next;
      }
    }
    if (u + stages - 1 < ntiles) load_tile(u + stages - 1);
    cp_async_commit();
    const bool prefetch = tid < G && u + stages < ntiles;
    if (prefetch) e_next = table_entry(u + stages);
    const unsigned char* kst = ring + st * stage_bytes;
    if constexpr (sizeof(KT) == 1) {       // int8: widen, then as 16-bit
      widen_rows<QT, kRaggedThreads>(kst, wide, sw, sw16, kRaggedK);
      __syncthreads();
      kst = wide;
    }
    if (wn > 0 && s0 < whi) {              // some query of the warp sees it
      const unsigned char* vst = kst + kRaggedK * sw16.row_bytes;

      // S = Q K^T: rows g, g + 8; slots 8nt + 2tig (+1) in s[nt][0 (1)] and
      // s[nt][2 (3)]
      float s[2 * G][4];
#pragma unroll
      for (int nt = 0; nt < 2 * G; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, qs + sw16.at(16 * warp + 8 * (mq & 1) + (lane & 7),
                                (16 * ks + 8 * (mq >> 1)) * 2));
#pragma unroll
        for (int j = 0; j < G; ++j) {
          uint32_t kb[4];
          k_frags(kst + 16 * j * sw16.row_bytes, sw16, ks, kb);
          mma_m16n8k16(QT(), s[2 * j], a, kb[0], kb[1]);
          mma_m16n8k16(QT(), s[2 * j + 1], a, kb[2], kb[3]);
        }
      }
      // masked only where the tile crosses the warp's diagonal or the
      // window's end
      if (s0 + kRaggedK > wlo) {
#pragma unroll
        for (int nt = 0; nt < 2 * G; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (s0 + 8 * nt + 2 * tig + (e & 1) >= lim[e >> 1])
              s[nt][e] = kNegInf;
      }
      // log2-unit factor of each 16-slot group (int8: its page's K scale)
      // and the rows' maxima in log2 units, from each group's raw maximum
      // (fac > 0, so the product keeps the order)
      float fac[G], mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < G; ++j) {
        fac[j] = sizeof(KT) == 1 ? __fmul_rn(kss[st * G + j], scale_log2)
                                 : scale_log2;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mx[r] = fmaxf(mx[r], __fmul_rn(fmaxf(fmaxf(s[2 * j][2 * r],
                                                     s[2 * j][2 * r + 1]),
                                               fmaxf(s[2 * j + 1][2 * r],
                                                     s[2 * j + 1][2 * r + 1])),
                                         fac[j]));
      }
      // the online softmax of rows g and g + 8, in the quad that holds
      // them; alpha is exactly 1 where the maximum stays, so a tile that
      // is fully masked for a row leaves its sums' bits as they were
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = mn == m[r] ? 1.f : fast_exp2(__fsub_rn(m[r], mn));
        m[r] = mn;
      }
#pragma unroll
      for (int nt = 0; nt < 2 * G; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              fast_exp2(__fmaf_rn(s[nt][e], fac[nt >> 1], -m[e >> 1]));
          s[nt][e] = p;
          ps[e >> 1] = __fadd_rn(ps[e >> 1], p);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], alpha[r], ps[r]);
#pragma unroll
      for (int dt = 0; dt < NT; ++dt) {
        o[dt][0] = __fmul_rn(o[dt][0], alpha[0]);
        o[dt][1] = __fmul_rn(o[dt][1], alpha[0]);
        o[dt][2] = __fmul_rn(o[dt][2], alpha[1]);
        o[dt][3] = __fmul_rn(o[dt][3], alpha[1]);
      }
      // O += P V, one k-step (16 slots) at a time; p rounded to the query
      // type; an int8 page's V scale in f32 on its own zeroed product
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const uint32_t pa[4] = {pack2(QT(), s[2 * j][0], s[2 * j][1]),
                                pack2(QT(), s[2 * j][2], s[2 * j][3]),
                                pack2(QT(), s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack2(QT(), s[2 * j + 1][2], s[2 * j + 1][3])};
        const unsigned char* vj = vst + 16 * j * sw16.row_bytes;
#pragma unroll
        for (int dt = 0; dt < NT; dt += 2) {
          uint32_t vb[4];
          v_frags(vj, sw16, dt, dt + 1, vb);
          if constexpr (sizeof(KT) == 1) {
            const float vs = vss[st * G + j];
            float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
            mma_m16n8k16(QT(), d0, pa, vb[0], vb[1]);
            mma_m16n8k16(QT(), d1, pa, vb[2], vb[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[dt][e] = __fmaf_rn(vs, d0[e], o[dt][e]);
              o[dt + 1][e] = __fmaf_rn(vs, d1[e], o[dt + 1][e]);
            }
          } else {
            mma_m16n8k16(QT(), o[dt], pa, vb[0], vb[1]);
            mma_m16n8k16(QT(), o[dt + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
    // tile u + stages's group base into tile u's slot, its copies issued
    // next iteration (int8: its scales, stored next iteration)
    if (prefetch) {
      gb[st * G + tid] = group_base(u + stages, e_next);
      if constexpr (sizeof(KT) == 1) {
        const size_t ph = static_cast<size_t>(phys_page(e_next)) * H + h;
        ks_next = ksc[ph];
        vs_next = vsc[ph];
      }
    }
  }
  cp_async_wait(0);

  // rows g, g + 8: O / l (zeros for pad rows) into the warp's own rows of
  // the Q tile, then out in 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    const bool valid = wq0 + row < qlen;
    const float den = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      const float v0 = valid ? __fdiv_rn(o[dt][2 * r], den) : 0.f;
      const float v1 = valid ? __fdiv_rn(o[dt][2 * r + 1], den) : 0.f;
      *reinterpret_cast<uint32_t*>(
          qs + sw16.at(16 * warp + row, (8 * dt + 2 * tig) * 2)) =
          pack2(QT(), v0, v1);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    if (wq0 + r < C)
      reinterpret_cast<uint4*>(obase + (wq0 + r) * rs)[c] =
          *reinterpret_cast<const uint4*>(qs + sw16.at(16 * warp + r, c * 16));
  }
}

// The CUDA-core ragged walk: f32 queries, other head dims and page sizes.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) ragged_paged_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ ctx_lens, const int* __restrict__ q_lens,
    QT* __restrict__ out, int P, int C, int H, int D, int page,
    int max_pages, float scale) {
  constexpr int VEC = 16 / sizeof(KT);
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, i0 = blockIdx.z * kTQ;
  const int tid = threadIdx.x;
  const int LD = D + 1;                    // padded rows: no bank clash
  float* qs = smem;                        // [kTQ][LD]
  float* kst = qs + kTQ * LD;              // [page][LD]
  float* vst = kst + page * LD;            // [page][D]
  float* S = vst + page * D;               // [kTQ][page]
  float* ms = S + kTQ * page;              // [kTQ]
  float* ls = ms + kTQ;                    // [kTQ]
  float* al = ls + kTQ;                    // [kTQ]

  const int ctx = ctx_lens[b];
  int nq = q_lens[b] - i0;
  nq = nq < 0 ? 0 : (nq > kTQ ? kTQ : nq);
  if (i0 + nq > C) nq = C - i0;
  const size_t row_stride = static_cast<size_t>(H) * D;
  QT* obase = out + static_cast<size_t>(b) * C * row_stride +
              static_cast<size_t>(h) * D;
  const int rows = (C - i0) < kTQ ? (C - i0) : kTQ;

  if (nq <= 0) {   // inactive tile: positions past q_len read as zeros
    for (int idx = tid; idx < rows * D; idx += kThreads)
      obase[(i0 + idx / D) * row_stride + idx % D] = from_f<QT>(0.f);
    return;
  }

  const QT* qbase = q + static_cast<size_t>(b) * C * row_stride +
                    static_cast<size_t>(h) * D;
  for (int idx = tid; idx < kTQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    qs[r * LD + d] = r < nq ? to_f(qbase[(i0 + r) * row_stride + d]) : 0.f;
  }
  if (tid < kTQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }

  float acc[kMaxDPT][kTQ];
#pragma unroll
  for (int k = 0; k < kMaxDPT; ++k)
#pragma unroll
    for (int r = 0; r < kTQ; ++r) acc[k][r] = 0.f;

  const int end = ctx + i0 + nq;           // the tile's last query sees
  int npages = (end + page - 1) / page;    // slots < end
  if (npages > max_pages) npages = max_pages;
  const int* trow = tables + static_cast<size_t>(b) * max_pages;
  const int nvec = D / VEC;

  for (int j = 0; j < npages; ++j) {
    int phys = trow[j];
    phys = phys < 0 ? 0 : (phys >= P ? P - 1 : phys);
    const size_t ph = static_cast<size_t>(phys) * H + h;
    const size_t base = ph * page * D;
    const float kscale = ksc ? ksc[ph] : 1.f;
    const float vscale = vsc ? vsc[ph] : 1.f;
    for (int idx = tid; idx < page * nvec; idx += kThreads) {
      const int s = idx / nvec, c = (idx % nvec) * VEC;
      float kf[VEC], vf[VEC];
      load16(kp + base + static_cast<size_t>(s) * D + c, kf);
      load16(vp + base + static_cast<size_t>(s) * D + c, vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kst[s * LD + c + e] = kf[e] * kscale;
        vst[s * D + c + e] = vf[e] * vscale;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kTQ * page; idx += kThreads) {
      const int r = idx / page, s = idx % page;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qs[r * LD + d] * kst[s * LD + d];
      S[r * page + s] =
          (j * page + s <= ctx + i0 + r) ? dot * scale : kNegInf;
    }
    __syncthreads();
    if (tid < kTQ) {
      const int r = tid;
      const float m_prev = ms[r];
      float m_cur = kNegInf;
      for (int s = 0; s < page; ++s) m_cur = fmaxf(m_cur, S[r * page + s]);
      const float m_new = fmaxf(m_prev, m_cur);
      const float alpha = expf(m_prev - m_new);
      float psum = 0.f;
      for (int s = 0; s < page; ++s) {
        const float p = expf(S[r * page + s] - m_new);
        S[r * page + s] = p;
        psum += p;
      }
      ls[r] = ls[r] * alpha + psum;
      ms[r] = m_new;
      al[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxDPT; ++k) {
      const int d = tid + k * kThreads;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kTQ; ++r) {
          float a = acc[k][r] * al[r];
          for (int s = 0; s < page; ++s) a += S[r * page + s] * vst[s * D + d];
          acc[k][r] = a;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kMaxDPT; ++k) {
    const int d = tid + k * kThreads;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < kTQ; ++r) {
        if (r < rows) {
          const float v = r < nq ? acc[k][r] / fmaxf(ls[r], 1e-20f) : 0.f;
          obase[(i0 + r) * row_stride + d] = from_f<QT>(v);
        }
      }
    }
  }
}


size_t ragged_smem(int D, int page) {
  return (kTQ * (D + 1) + page * (D + 1) + page * D + kTQ * page +
          3 * kTQ) * sizeof(float);
}

// Ring stages and shared memory of one walk.
template <typename KT, int NL, bool Mma>
size_t walk_smem(int D, int page, int* stages) {
  if (Mma) {
    *stages = ring_stages(kRingBytes, kChunk, D, sizeof(KT));
    return MmaLayout(D, sizeof(KT), *stages).total;
  }
  *stages = ring_stages(kRingBytes, ring_rows(page), D, sizeof(KT));
  return SplitLayout(NL, D, page, sizeof(KT), *stages).total;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  return 0;
}

// The split walk of decode (Verify false, W = 1) or verify, then the
// combine; the walk's kernel instantiation follows use_mma.
template <typename QT, typename KT, bool Verify, bool Mma>
int launch_walk(const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* tables,
                const void* lengths, void* out, void* ws, int B, int W,
                int P, int H, int D, int page, int max_pages, float scale,
                cudaStream_t stream) {
  const int nsplit = (max_pages + kSplitPages - 1) / kSplitPages;
  if (nsplit > 0) {
    int stages;
    const size_t smem = walk_smem<KT, Verify ? kVerifyLanes : 1, Mma>(
        D, page, &stages);
    const int groups = (W + kVerifyLanes - 1) / kVerifyLanes;
    const dim3 grid(B, H, nsplit * (Verify ? groups : 1));
    const QT* qq = static_cast<const QT*>(q);
    const KT* kk = static_cast<const KT*>(k);
    const KT* vv = static_cast<const KT*>(v);
    const float* kss = static_cast<const float*>(ks);
    const float* vss = static_cast<const float*>(vs);
    const int* tt = static_cast<const int*>(tables);
    const int* ll = static_cast<const int*>(lengths);
    QT* oo = static_cast<QT*>(out);
    float* ww = static_cast<float*>(ws);
    if constexpr (Verify) {
      auto kernel = paged_verify_kernel<QT, KT, Mma>;
      if (int rc = set_smem(kernel, smem)) return rc;
      kernel<<<grid, kThreads, smem, stream>>>(
          qq, kk, vv, kss, vss, tt, ll, oo, ww, P, W, H, D, page, max_pages,
          nsplit, stages, scale);
    } else {
      auto kernel = paged_decode_kernel<QT, KT, Mma>;
      if (int rc = set_smem(kernel, smem)) return rc;
      kernel<<<grid, kThreads, smem, stream>>>(
          qq, kk, vv, kss, vss, tt, ll, oo, ww, P, H, D, page, max_pages,
          nsplit, stages, scale);
    }
    if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  }
  const dim3 cgrid(B * W, H);
  if constexpr (Verify)
    paged_verify_combine_kernel<QT><<<cgrid, kThreads, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<const int*>(lengths),
        static_cast<QT*>(out), H, D, page, max_pages, nsplit);
  else
    paged_decode_combine_kernel<QT><<<cgrid, kThreads, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<const int*>(lengths),
        static_cast<QT*>(out), H, D, page, max_pages, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, bool Verify>
int launch_paged(const void* q, const void* k, const void* v,
                 const void* ks, const void* vs, const void* tables,
                 const void* lengths, void* out, void* ws, int B, int W,
                 int P, int H, int D, int page, int max_pages, float scale,
                 cudaStream_t stream) {
  if (B == 0 || W == 0 || H == 0) return 0;
  if constexpr (MmaPair<QT, KT>::value) {
    if (use_mma<QT, KT>(D))
      return launch_walk<QT, KT, Verify, true>(
          q, k, v, ks, vs, tables, lengths, out, ws, B, W, P, H, D, page,
          max_pages, scale, stream);
  }
  return launch_walk<QT, KT, Verify, false>(
      q, k, v, ks, vs, tables, lengths, out, ws, B, W, P, H, D, page,
      max_pages, scale, stream);
}

template <typename QT, typename KT>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* tables,
                  const void* lengths, void* out, void* ws, int B, int P,
                  int H, int D, int page, int max_pages, float scale,
                  cudaStream_t stream) {
  return launch_paged<QT, KT, false>(q, k, v, ks, vs, tables, lengths, out,
                                     ws, B, 1, P, H, D, page, max_pages,
                                     scale, stream);
}

template <typename QT, typename KT>
int launch_verify(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* tables,
                  const void* lengths, void* out, void* ws, int B, int W,
                  int P, int H, int D, int page, int max_pages, float scale,
                  cudaStream_t stream) {
  return launch_paged<QT, KT, true>(q, k, v, ks, vs, tables, lengths, out,
                                    ws, B, W, P, H, D, page, max_pages,
                                    scale, stream);
}

template <typename QT, typename KT, int D>
int launch_ragged_mma(const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const void* tables,
                      const void* ctx, const void* qlens, void* out, int B,
                      int P, int C, int H, int page, int max_pages,
                      float scale, cudaStream_t stream) {
  const size_t smem = RaggedLayout(D, sizeof(KT),
                                   ring_stages(kRaggedRingBytes, kRaggedK, D,
                                               sizeof(KT)))
                          .total;
  auto kernel = ragged_paged_mma_kernel<QT, KT, D>;
  if (int rc = set_smem(kernel, smem)) return rc;
  const dim3 grid(H, B, (C + kRaggedQ - 1) / kRaggedQ);
  kernel<<<grid, kRaggedThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(ctx), static_cast<const int*>(qlens),
      static_cast<QT*>(out), P, C, H, page, max_pages,
      static_cast<float>(scale * 1.4426950408889634));   // log2(e)
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core walk where it applies (16-bit queries, D 64 / 128 /
// 256, pages of a multiple of 16 slots), else the CUDA-core kernel.
template <typename QT, typename KT>
int launch_ragged(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* tables,
                  const void* ctx, const void* qlens, void* out, int B,
                  int P, int C, int H, int D, int page, int max_pages,
                  float scale, cudaStream_t stream) {
  if (B == 0 || C == 0 || H == 0) return 0;
  if constexpr (MmaPair<QT, KT>::value) {
    if (page % 16 == 0) {
      if (D == 64)
        return launch_ragged_mma<QT, KT, 64>(q, k, v, ks, vs, tables, ctx,
                                             qlens, out, B, P, C, H, page,
                                             max_pages, scale, stream);
      if (D == 128)
        return launch_ragged_mma<QT, KT, 128>(q, k, v, ks, vs, tables, ctx,
                                              qlens, out, B, P, C, H, page,
                                              max_pages, scale, stream);
      if (D == 256)
        return launch_ragged_mma<QT, KT, 256>(q, k, v, ks, vs, tables, ctx,
                                              qlens, out, B, P, C, H, page,
                                              max_pages, scale, stream);
    }
  }
  auto kernel = ragged_paged_kernel<QT, KT>;
  const size_t smem = ragged_smem(D, page);
  if (int rc = set_smem(kernel, smem)) return rc;
  kernel<<<dim3(B, H, (C + kTQ - 1) / kTQ), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(ctx), static_cast<const int*>(qlens),
      static_cast<QT*>(out), P, C, H, D, page, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dispatch on (q dtype, page dtype): float pages match q's dtype; int8
// pages take any float q plus [P, H] f32 scale rows for K and V.
#define PIT_DISPATCH(LAUNCH, ...)                                         \
  switch (qdt * 4 + kvdt) {                                               \
    case kF32 * 4 + kF32: return LAUNCH<float, float>(__VA_ARGS__);       \
    case kBF16 * 4 + kBF16:                                               \
      return LAUNCH<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);           \
    case kF16 * 4 + kF16: return LAUNCH<__half, __half>(__VA_ARGS__);     \
    case kF32 * 4 + kI8: return LAUNCH<float, int8_t>(__VA_ARGS__);       \
    case kBF16 * 4 + kI8:                                                 \
      return LAUNCH<__nv_bfloat16, int8_t>(__VA_ARGS__);                  \
    case kF16 * 4 + kI8: return LAUNCH<__half, int8_t>(__VA_ARGS__);      \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }

extern "C" {

// Pages per decode / verify split: the wrapper sizes the workspace
// [rows, H, ceil(max_pages / this), D + 2] float32 from it.
int pit_paged_split_pages() { return kSplitPages; }

int pit_paged_decode(int qdt, int kvdt, const void* q, const void* k,
                     const void* v, const void* ks, const void* vs,
                     const void* tables, const void* lengths, void* out,
                     void* ws, int B, int P, int H, int D, int page,
                     int max_pages, float scale, void* stream) {
  PIT_DISPATCH(launch_decode, q, k, v, ks, vs, tables, lengths, out, ws, B,
               P, H, D, page, max_pages, scale,
               static_cast<cudaStream_t>(stream))
}

int pit_paged_verify(int qdt, int kvdt, const void* q, const void* k,
                     const void* v, const void* ks, const void* vs,
                     const void* tables, const void* lengths, void* out,
                     void* ws, int B, int W, int P, int H, int D, int page,
                     int max_pages, float scale, void* stream) {
  PIT_DISPATCH(launch_verify, q, k, v, ks, vs, tables, lengths, out, ws, B,
               W, P, H, D, page, max_pages, scale,
               static_cast<cudaStream_t>(stream))
}

int pit_ragged_paged_attention(int qdt, int kvdt, const void* q,
                               const void* k, const void* v, const void* ks,
                               const void* vs, const void* tables,
                               const void* ctx, const void* qlens,
                               void* out, int B, int P, int C, int H, int D,
                               int page, int max_pages, float scale,
                               void* stream) {
  PIT_DISPATCH(launch_ragged, q, k, v, ks, vs, tables, ctx, qlens, out, B,
               P, C, H, D, page, max_pages, scale,
               static_cast<cudaStream_t>(stream))
}

const char* pit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
