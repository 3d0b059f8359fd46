// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ.  Three
// kernels per input type (float32, bfloat16, float16), one source, in
// the (folded) layout
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
//   block of keys, stream the q-tiles, recompute p = exp(s - lse)
//   (`_masked_p`), dv += pd^T do, ds = p (dp - delta) scale, dk += ds^T q,
//   with pd = keep p / (1 - p_drop) and dp = keep (do v^T) / (1 - p_drop).
// flash_dq — replaces `_dq_kernel` (:346, launched at :453): per block of
//   q rows, stream the k-tiles, dq += ds k with the same ds.
//
// The TPU kernels carry their accumulators in VMEM across a sequential
// grid axis; here a block owns its output rows and loops over the other
// side's tiles inside the block with the accumulators in registers, so
// there are no atomics and a second launch gives the same bits.  Causal
// tiles above the diagonal plus the offset Sk - Sq are skipped as the
// Pallas `needed` predicate skips them.
//
// What bounds the kernels on an H100.  At the ERNIE shape (B=32, H=12,
// S=512, D=64, 10 % padding) each must at least move its bytes over
// 3.35 TB/s (forward: q, k, v in, o and lse out; backward: q, k, v, dO,
// lse, delta in, dk, dv or dq out); the forward's exponentials (one ex2
// per score on the 16 special-function lanes of an SM) and, with
// dropout, its keep hash (about a dozen integer operations per score)
// take about as long.  At long causal sequences (S=4096, D=128) and at
// D=256 the bf16 tensor-core operations bound them (4, 8 and 6 per q-k
// pair and head dim) over 989 TFLOP/s.  The 16-bit design, one template
// for bf16 and f16 that differ only in the element's encoding (kernels of the
// earlier design, for comparison: four warps of mma.sync.m16n8k16 with
// fragments read from padded shared tiles by scalar loads, synchronous
// tile loads between two __syncthreads per tile, each tile's softmax
// waiting for its product and the next product for the softmax, every
// element through the mask predicates and an expf; in the backward a
// head-dim split over the grid's z axis at D = 256 that recomputed the
// scores):
//   * loads: one producer warp issues TMA copies of whole [rows, 64]
//     panels into rings of two to four stages, completed on mbarriers,
//     so the next tiles arrive while the consumers multiply; Q (forward),
//     K and V (dK/dV) or Q and dO (dQ) are loaded once per block.  lse,
//     delta and the segment ids go through the producer's plain loads
//     (issued before it waits for a free stage) into the stage: their
//     row stride Sq * 4 bytes is not a multiple of 16 for every Sq,
//     which TMA needs.  Rows past Sq / Sk arrive as zeros and are still
//     masked by the kernel;
//   * products: wgmma.mma_async, bf16 operands in 128-byte-swizzled
//     shared memory read through descriptors, f32 accumulators in
//     registers; the score-sized operand of the second product (P, Pd^T,
//     dS^T, dS) is the score accumulator re-packed in registers as the
//     A operand, all k-steps packed before the first is issued (packing
//     between issues made ptxas fence and serialize them);
//   * warpgroups: the forward runs two per block (one at D = 64), 64 q
//     rows each, on the same key tiles, and overlaps each tile's softmax
//     with the previous tile's P V product (below); at D = 256 it takes 64 keys a
//     tile so that O (128 accumulators a thread), S and P fit the 240
//     registers `setmaxnreg` gives the consumers.  dK/dV runs two per
//     block on the same 64 keys, one for S^T, P^T and dV, one for dP^T,
//     the dropout hash, dS^T and dK, P^T and the keep bits passing
//     between them through shared memory; each product runs once at
//     every head dim, so D = 256 needs no split.  dQ runs one warpgroup
//     of 64 q rows per block, so that two or three blocks share an SM
//     below D = 256, and works out P while its dP product runs;
//   * host: each kernel instantiation opts into its shared memory once;
//     the tensor maps are encoded per call (they hold the tensors'
//     addresses) and passed as __grid_constant__ parameters;
//   * f16: as bf16, with f16 products and tensor maps.  Its narrower range
//     shows only where the caller's values leave it (a loss scale too
//     large gives inf gradients, which GradScaler skips); p and the
//     score-sized operands lie in [0, 1] or scale with dO, as in bf16.
// f32 (fp32 parity runs): CUDA cores, four threads per tile row, scores
// staged in shared memory; tiles of 32 rows at D = 256, so four f32
// tiles fit.  Head dims 64, 128 and 256.
//
// Numerics kept from the TPU kernels: NEG_INF = -1e30 (not -inf) for
// masked scores; l == 0 → 1; keys past Sk (the kernel guards its own
// tile tails) score -inf and weigh exactly 0.  The dropout keep mask is
// the pure uint32 hash `dropout_keep(seed, bh, row, col)` over absolute
// coordinates, bit for bit the plain version's.
//
// C interface (ctypes): every pointer and the stream are void*; each
// entry returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// when a tensor map cannot be encoded).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Kind { kFwd = 0, kDkdv = 1, kDq = 2 };

typedef __nv_bfloat16 bf16;
typedef __half f16;

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
  const uint32_t* seed_ptr;  // the uint32 seed, in device memory
  unsigned thresh;
  float rescale;  // 1 / (1 - p_drop) in f32
};

// ------------------------------------------------------------ shared math

// The dropout seed lives in device memory, so a CUDA graph replays a
// launch with the step's seed; every thread reads the one word once, at
// kernel entry, and passes it to the hashes in a register.
__device__ __forceinline__ uint32_t load_seed(const Args& a) {
  return a.dropout ? __ldg(a.seed_ptr) : 0u;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// `dropout_keep` of the plain version: P(keep) = 1 - p_drop.
__device__ __forceinline__ bool keep_elem(const Args& a, uint32_t seed,
                                          int bh, int row, int col) {
  const uint32_t x = static_cast<uint32_t>(row) * 0x9E3779B1u +
                     static_cast<uint32_t>(col) * 0x85EBCA77u +
                     static_cast<uint32_t>(bh) * 0xC2B2AE3Du;
  return mix32(x ^ seed) >= a.thresh;
}

__device__ __forceinline__ bool causal_ok(const Args& a, int row, int col) {
  return !a.causal || row + (a.sk - a.sq) >= col;
}

// k-tiles of `tile` keys that `rows` q rows starting at q0 need (the
// Pallas `needed` predicate): a prefix of the key tiles.
__device__ __forceinline__ int num_k_tiles(const Args& a, int q0, int rows,
                                           int tile) {
  int nk = (a.sk + tile - 1) / tile;
  if (a.causal) {
    const int last = q0 + rows - 1 + a.sk - a.sq;
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

// ------------------------------------------------------- 16-bit elements
// The tensor-core kernels are templates on their element type T, bf16 or
// f16 (the same tiles, products and maps; only the element's encoding
// differs): Elem<T> packs a pair of floats into one 32-bit register
// (round to nearest even; f16 keeps its subnormals), unpacks one, and
// names the type for a tensor map; wgmma takes the type's name below.

template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  }
};

template <>
struct Elem<f16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  }
};

template <typename T>
constexpr bool kIsF16 = std::is_same<T, f16>::value;

// -------------------------------------------- Hopper primitives (sm_90a)
// The 16-bit kernels: a producer warp keeps TMA loads in flight into
// rings of two to four stages completed on mbarriers; consumer
// warpgroups run wgmma.  A 16-bit tile [rows, D] sits in shared memory as
// D / 64 panels of [rows, 64] (128 bytes a row), 128-byte swizzled by
// the TMA unit, each panel 1024-byte aligned.

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgRows = 64;        // rows of one warpgroup's wgmma tile
constexpr int kProducer = 32;      // threads of the producer warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One [rows, 64] panel of a [BH, S, D] tensor: columns c0.., rows r0..
// of head bh; rows past S arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int r0,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(r0), "r"(bh)
      : "memory");
}

// Named barriers between the two consumer warpgroups (id 0 is
// __syncthreads): bar_sync counts itself and waits, bar_arrive only
// counts.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// 2^x, float32 subnormal results flushed to zero: p feeds 16-bit
// products, and below 2^-126 it rounds to zero in bf16 and in f16 alike
// (f16's smallest subnormal is 2^-24), so the flush changes no operand.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product's issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (the product sums over D): 64 rows from r0 of a tile
// of `rows` rows, k-step kk (head-dim columns 16 kk ..).  Within a
// 128-byte row a k-step is 32 bytes; eight rows are 1024 bytes.
__device__ __forceinline__ uint64_t desc_k(const void* tile, int rows, int r0,
                                           int kk) {
  return gmma_desc(smem_u32(tile) + (kk >> 2) * rows * 128 + r0 * 128 +
                       (kk & 3) * 32,
                   16, 1024);
}

// MN-major B operand (the product sums over the tile's rows), k-step kk
// (rows 16 kk ..): N runs along D, one 64-column panel after another
// (`rows` x 128 bytes apart).
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int rows,
                                            int kk) {
  return gmma_desc(smem_u32(tile) + kk * 2048, rows * 128, 1024);
}

// The A operand of k-step kk from a [64 x N] score accumulator (N / 2
// floats a thread), rounded to T (the accumulator's fragment is the A
// fragment's layout).
template <typename T, int N>
__device__ __forceinline__ void a_frag(const float (&s)[N], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = Elem<T>::pack(s[8 * kk], s[8 * kk + 1]);
  a[1] = Elem<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = Elem<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = Elem<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
}

// The wgmma products, one macro per shape with the element type's name
// (bf16 or f16) pasted into the instruction.
#define PIT_WGMMA_SS64(TY)                                                                                      \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "l"(da), "l"(db), "r"(accumulate))

#define PIT_WGMMA_SS128(TY)                                                                                     \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                        \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                       \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "l"(da), "l"(db), "r"(accumulate))

#define PIT_WGMMA_RS64(TY)                                                                                      \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define PIT_WGMMA_RS128(TY)                                                                                     \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                        \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                       \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define PIT_WGMMA_RS256(TY)                                                                                             \
  asm volatile(                                                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                                                     \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                                \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                                \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                                \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                                \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                                \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "                    \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "               \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                                                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),         \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),         \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),         \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),         \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),         \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),     \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d[64 x 64] (+)= A . B^T, A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (kIsF16<T>)
    PIT_WGMMA_SS64("f16");
  else
    PIT_WGMMA_SS64("bf16");
}

// d[64 x 128] (+)= A . B^T, A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (kIsF16<T>)
    PIT_WGMMA_SS128("f16");
  else
    PIT_WGMMA_SS128("bf16");
}

// d[64 x 64] += A . B, A a register fragment, B MN-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kIsF16<T>)
    PIT_WGMMA_RS64("f16");
  else
    PIT_WGMMA_RS64("bf16");
}

// d[64 x 128] += A . B, A a register fragment, B MN-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kIsF16<T>)
    PIT_WGMMA_RS128("f16");
  else
    PIT_WGMMA_RS128("bf16");
}

// d[64 x 256] += A . B, A a register fragment, B MN-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kIsF16<T>)
    PIT_WGMMA_RS256("f16");
  else
    PIT_WGMMA_RS256("bf16");
}

// Rows row[0], row[1] of a [64 x D] accumulator (fragment d[4 j + e]:
// row row[e >> 1], column 8 j + 2 t + (e & 1)) into dst [n, D] as T.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* dst, const float (&d)[D / 2],
                                          const int (&row)[2], int n, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= n) continue;
    T* out = dst + static_cast<size_t>(row[i]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8 + t * 2) =
          Elem<T>::pack(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// dK/dV: one block per (bh, 64 keys) and two consumer warpgroups that
// share the q-tile's work instead of splitting rows or head dims:
//   WG 0: S^T = K Q^T, P^T (masked, lse), dV += Pd^T dO;
//   WG 1: dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale, dK += dS^T Q.
// Per tile the two swap through shared memory: WG 0 hands over P^T in
// T, WG 1 the dropout keep bits it hashes while its dP^T product
// runs, so each product and each hash runs once.  The
// producer warp loads K and V once and streams (Q, dO, lse, delta, q
// segment ids) tiles through the ring.
// Threads of a dK/dV block: two consumer warpgroups and the producer
// warp; at D = 256 the producer's warpgroup is whole,
// so that it can hand its registers to the consumers (setmaxnreg 40 /
// 232), whose 128 accumulators a thread spill at the 168 registers
// ptxas grants a block of 288 or 384 threads.
template <int D>
__host__ __device__ constexpr int dkdv_threads() {
  return D > 128 ? 3 * 128 : 2 * 128 + kProducer;
}

template <int D>
struct DkdvLayout {
  // ring depth: as many stages as fit beside K and V (two blocks an SM
  // at D = 64, one above)
  static constexpr int kStages = D == 64 ? 3 : D == 128 ? 4 : 2;
  static constexpr int kTileB = kWgRows * D * 2;  // one [64, D] 16-bit tile
  static constexpr int kK = 0, kV = kTileB, kQ = 2 * kTileB,
                       kO = kQ + kStages * kTileB, kP = kO + kStages * kTileB,
                       kLse = kP + kStages * kWgRows * kWgRows * 2,
                       kDelta = kLse + kStages * kWgRows * 4,
                       kQs = kDelta + kStages * kWgRows * 4,
                       kKeep = kQs + kStages * kWgRows * 4,
                       kBars = kKeep + kStages * 128 * 4,
                       kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(dkdv_threads<D>(), D == 64 ? 2 : 1)
    flash_dkdv_kernel_16bit(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, Args a) {
  const uint32_t seed = load_seed(a);
  using L = DkdvLayout<D>;
  constexpr int STAGES = L::kStages;
  constexpr int TILE = L::kTileB, PANEL = kWgRows * 64;  // elements
  constexpr bool kRebalance = D > 128;  // setmaxnreg: 40 producer, 232
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  T* sK = reinterpret_cast<T*>(sm + L::kK);
  T* sV = reinterpret_cast<T*>(sm + L::kV);
  uint2* sP = reinterpret_cast<uint2*>(sm + L::kP);  // P^T, as T
  float* sLse = reinterpret_cast<float*>(sm + L::kLse);  // lse * log2(e)
  float* sDelta = reinterpret_cast<float*>(sm + L::kDelta);
  int* sQs = reinterpret_cast<int*>(sm + L::kQs);
  // dropout keep bits of a tile, one word per thread, bit 4 j + e
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sm + L::kKeep);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  auto sQ = [&](int s) {
    return reinterpret_cast<T*>(sm + L::kQ + s * TILE);
  };
  auto sO = [&](int s) {
    return reinterpret_cast<T*>(sm + L::kO + s * TILE);
  };

  const int bh = blockIdx.y, k0 = blockIdx.x * kWgRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = static_cast<size_t>(bh) * a.sq;
  const size_t koff = static_cast<size_t>(bh) * a.sk;
  // q-tiles this block needs (the Pallas `needed` predicate): a suffix
  const int nq = (a.sq + kWgRows - 1) / kWgRows;
  int i0 = 0;
  if (a.causal) {
    const int lo = k0 - (kWgRows - 1) - (a.sk - a.sq);  // need q0 >= lo
    i0 = lo <= 0 ? 0 : min(nq, (lo + kWgRows - 1) / kWgRows);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], kProducer);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // -------------------------------- producer warp(group)
    if constexpr (kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * TILE);
        for (int p = 0; p < D / 64; ++p) {
          tma_load(sK + p * PANEL, &tk, kvbar, p * 64, k0, bh);
          tma_load(sV + p * PANEL, &tv, kvbar, p * 64, k0, bh);
        }
      }
      const int b = bh / a.heads;
      for (int i = i0, it = 0; i < nq; ++i, ++it) {
        const int s = it % STAGES, q0 = i * kWgRows;
        // the tile's lse, delta and q segment ids, read before the
        // stage frees up
        float lse_v[kWgRows / 32], delta_v[kWgRows / 32];
        int qs_v[kWgRows / 32];
#pragma unroll
        for (int j = 0; j < kWgRows / 32; ++j) {
          const int q = q0 + lane + 32 * j;
          const bool in = q < a.sq;
          lse_v[j] = in ? a.lse_in[qoff + q] * kLog2e : 0.f;
          delta_v[j] = in ? a.delta[qoff + q] : 0.f;
          qs_v[j] =
              in && a.qseg ? a.qseg[static_cast<size_t>(b) * a.sq + q] : 0;
        }
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
#pragma unroll
        for (int j = 0; j < kWgRows / 32; ++j) {
          const int r = s * kWgRows + lane + 32 * j;
          sLse[r] = lse_v[j];
          sDelta[r] = delta_v[j];
          sQs[r] = qs_v[j];
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * TILE);
          for (int p = 0; p < D / 64; ++p) {
            tma_load(sQ(s) + p * PANEL, &tq, &full[s], p * 64, q0, bh);
            tma_load(sO(s) + p * PANEL, &tdo, &full[s], p * 64, q0, bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // ------------------------------------- consumer warpgroups
    if constexpr (kRebalance)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2, tid = threadIdx.x & 127;
    const int g = lane >> 2, t = lane & 3;
    const int wr = (warp & 3) * 16;
    const int key[2] = {k0 + wr + g, k0 + wr + g + 8};
    int ks[2] = {0, 0};
    if (a.kseg)
      for (int i = 0; i < 2; ++i)
        if (key[i] < a.sk)
          ks[i] = a.kseg[static_cast<size_t>(bh / a.heads) * a.sk + key[i]];
    const float scale_l2 = a.scale * kLog2e;

    float acc[D / 2];  // WG 0: dV, WG 1: dK
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(kvbar, 0);

    for (int i = i0, it = 0; i < nq; ++i, ++it) {
      const int s = it % STAGES;
      const int q0 = i * kWgRows;
      mbar_wait(&full[s], (it / STAGES) & 1);
      // P^T of the tile in fragment order: [8 col blocks][128 threads]
      // x 4 T
      uint2* Ps = sP + s * kWgRows * kWgRows / 4;
      uint32_t* keep = sKeep + s * 128;
      float sc[32];
      if (wg == 0) {
        // S^T = K Q^T over D
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T>(sc, desc_k(sK, kWgRows, 0, kk),
                   desc_k(sQ(s), kWgRows, 0, kk), kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        // P^T = exp(scale s - lse), zero where masked (`_masked_p`)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ki = e >> 1, c = j * 8 + t * 2 + (e & 1), q = q0 + c;
            const bool zero = !causal_ok(a, q, key[ki]) ||
                              (a.qseg && sQs[s * kWgRows + c] != ks[ki]) ||
                              q >= a.sq || key[ki] >= a.sk;
            sc[4 * j + e] =
                zero ? 0.f
                     : exp2_ftz(fmaf(sc[4 * j + e], scale_l2,
                                     -sLse[s * kWgRows + c]));
          }
          Ps[j * 128 + tid] =
              make_uint2(Elem<T>::pack(sc[4 * j], sc[4 * j + 1]),
                         Elem<T>::pack(sc[4 * j + 2], sc[4 * j + 3]));
        }
        bar_sync(1 + s, 2 * 128);  // P^T out, the keep bits in
        if (a.dropout) {  // Pd = keep P / (1 - p_drop)
          const uint32_t bits = keep[tid];
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = (bits >> i) & 1u ? sc[i] * a.rescale : 0.f;
        }
        // dV += Pd^T dO
        uint32_t af[kWgRows / 16][4];
#pragma unroll
        for (int kk = 0; kk < kWgRows / 16; ++kk) a_frag<T>(sc, kk, af[kk]);
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kWgRows / 16; ++kk)
          wgmma_rs<T>(acc, af[kk], desc_mn(sO(s), kWgRows, kk));
        wg_commit();
        wg_wait0();
        fence_regs(acc);
      } else {
        // dP^T = V dO^T over D; the dropout keep bits of this thread's
        // elements are hashed while the product runs
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T>(sc, desc_k(sV, kWgRows, 0, kk),
                   desc_k(sO(s), kWgRows, 0, kk), kk > 0);
        wg_commit();
        uint32_t bits = 0xffffffffu;
        if (a.dropout) {
          bits = 0u;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int c = (i >> 2) * 8 + t * 2 + (i & 1);
            bits |= static_cast<uint32_t>(
                        keep_elem(a, seed, bh, q0 + c, key[(i >> 1) & 1]))
                    << i;
          }
          keep[tid] = bits;
        }
        wg_wait0();
        fence_regs(sc);
        bar_sync(1 + s, 2 * 128);  // the keep bits out, P^T in
        // dS^T = P^T (dP^T - delta) scale, dP^T dropped and rescaled
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint2 pj = Ps[j * 128 + tid];
          const float2 lo = Elem<T>::unpack(pj.x), hi = Elem<T>::unpack(pj.y);
          const float pv[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + t * 2 + (e & 1);
            float d = sc[4 * j + e];
            if (a.dropout) d = (bits >> (4 * j + e)) & 1u ? d * a.rescale : 0.f;
            sc[4 * j + e] = pv[e] * (d - sDelta[s * kWgRows + c]) * a.scale;
          }
        }
        // dK += dS^T Q
        uint32_t af[kWgRows / 16][4];
#pragma unroll
        for (int kk = 0; kk < kWgRows / 16; ++kk) a_frag<T>(sc, kk, af[kk]);
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kWgRows / 16; ++kk)
          wgmma_rs<T>(acc, af[kk], desc_mn(sQ(s), kWgRows, kk));
        wg_commit();
        wg_wait0();
        fence_regs(acc);
      }
      mbar_arrive(&empty[s]);
    }
    store_acc<T, D>(static_cast<T*>(wg == 0 ? a.out1 : a.out0) + koff * D,
                      acc, key, a.sk, t);
  }
}

// dQ: one block per (bh, 64 q-rows) and one consumer warpgroup: S = Q
// K^T, P (masked, lse) and the dropout keep bits while the dP = dO V^T
// product runs, dS = P (dP - delta) scale, dQ += dS K.  The producer warp
// loads Q and dO once and streams (K, V, k segment ids) tiles through
// the ring.  Small blocks: three share an SM at D = 64, two at D = 128.
template <int D>
struct DqLayout {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTileB = kWgRows * D * 2;  // one [64, D] 16-bit tile
  static constexpr int kQ = 0, kO = kTileB, kK = 2 * kTileB,
                       kV = kK + kStages * kTileB, kKs = kV + kStages * kTileB,
                       kBars = kKs + kStages * kWgRows * 4,
                       kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(128 + kProducer, D == 256 ? 1 : 2)
    flash_dq_kernel_16bit(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, Args a) {
  const uint32_t seed = load_seed(a);
  using L = DqLayout<D>;
  constexpr int STAGES = L::kStages, TILE = L::kTileB;
  constexpr int PANEL = kWgRows * 64;  // elements
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  T* sQ = reinterpret_cast<T*>(sm + L::kQ);
  T* sO = reinterpret_cast<T*>(sm + L::kO);
  int* sKs = reinterpret_cast<int*>(sm + L::kKs);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  auto sK = [&](int s) {
    return reinterpret_cast<T*>(sm + L::kK + s * TILE);
  };
  auto sV = [&](int s) {
    return reinterpret_cast<T*>(sm + L::kV + s * TILE);
  };

  const int bh = blockIdx.y, q0 = blockIdx.x * kWgRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qoff = static_cast<size_t>(bh) * a.sq;
  const int b = bh / a.heads;
  // k-tiles the block needs (the Pallas `needed` predicate): a prefix
  int nk = (a.sk + kWgRows - 1) / kWgRows;
  if (a.causal) {
    const int last = q0 + kWgRows - 1 + a.sk - a.sq;
    nk = last < 0 ? 0 : min(nk, last / kWgRows + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], kProducer);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // ---------------------------------------- producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * TILE);
      for (int p = 0; p < D / 64; ++p) {
        tma_load(sQ + p * PANEL, &tq, qbar, p * 64, q0, bh);
        tma_load(sO + p * PANEL, &tdo, qbar, p * 64, q0, bh);
      }
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES, k0 = kt * kWgRows;
      int ks_v[kWgRows / 32];  // read before the stage frees up
#pragma unroll
      for (int j = 0; j < kWgRows / 32; ++j) {
        const int k = k0 + lane + 32 * j;
        ks_v[j] = a.kseg && k < a.sk
                      ? a.kseg[static_cast<size_t>(b) * a.sk + k]
                      : 0;
      }
      mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < kWgRows / 32; ++j)
        sKs[s * kWgRows + lane + 32 * j] = ks_v[j];
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * TILE);
        for (int p = 0; p < D / 64; ++p) {
          tma_load(sK(s) + p * PANEL, &tk, &full[s], p * 64, k0, bh);
          tma_load(sV(s) + p * PANEL, &tv, &full[s], p * 64, k0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------- consumer warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + (warp & 3) * 16 + g,
                      q0 + (warp & 3) * 16 + g + 8};
  int qs[2] = {0, 0};
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  for (int i = 0; i < 2; ++i)
    if (row[i] < a.sq) {
      lse[i] = a.lse_in[qoff + row[i]] * kLog2e;
      delta[i] = a.delta[qoff + row[i]];
      if (a.qseg) qs[i] = a.qseg[static_cast<size_t>(b) * a.sq + row[i]];
    }
  const float scale_l2 = a.scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES, k0 = kt * kWgRows;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    // S = Q K^T and dP = dO V^T over D, as two groups
    float sc[32], dp[32];  // sc: S, then P, then dS
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(sc, desc_k(sQ, kWgRows, 0, kk), desc_k(sK(s), kWgRows, 0, kk),
               kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(dp, desc_k(sO, kWgRows, 0, kk), desc_k(sV(s), kWgRows, 0, kk),
               kk > 0);
    wg_commit();
    // P = exp(scale s - lse), zero where masked (`_masked_p`), and the
    // dropout keep bits, while the dP product runs
    wg_wait1();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1, c = j * 8 + t * 2 + (e & 1), col = k0 + c;
        const bool zero = !causal_ok(a, row[ri], col) ||
                          (a.kseg && qs[ri] != sKs[s * kWgRows + c]) ||
                          col >= a.sk || row[ri] >= a.sq;
        sc[4 * j + e] =
            zero ? 0.f : exp2_ftz(fmaf(sc[4 * j + e], scale_l2, -lse[ri]));
      }
    uint32_t bits = 0xffffffffu;  // bit 4 j + e
    if (a.dropout) {
      bits = 0u;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = (i >> 2) * 8 + t * 2 + (i & 1);
        bits |= static_cast<uint32_t>(
                    keep_elem(a, seed, bh, row[(i >> 1) & 1], k0 + c))
                << i;
      }
    }
    // dS = P (dP - delta) scale, dP dropped and rescaled
    wg_wait0();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float d = (bits >> i) & 1u ? dp[i] * a.rescale : 0.f;
      sc[i] = sc[i] * (d - delta[(i >> 1) & 1]) * a.scale;
    }
    // dQ += dS K
    uint32_t af[kWgRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) a_frag<T>(sc, kk, af[kk]);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
      wgmma_rs<T>(acc, af[kk], desc_mn(sK(s), kWgRows, kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }
  store_acc<T, D>(static_cast<T*>(a.out0) + qoff * D, acc, row, a.sq, t);
}

// Forward: one block per (bh, 128 q rows) with two consumer warpgroups
// of 64 rows each (at D = 64 one, 64 rows, see below) and a producer
// warpgroup.  The producer's first warp
// loads the block's Q once and streams (K, V, k segment ids) tiles of
// kN keys through the ring; the consumers share each tile.  Per tile a
// consumer warpgroup issues S = Q K^T (both operands in shared memory)
// and, in the same breath, O += P V for the previous tile (P re-packed
// from that tile's score accumulator as the register A operand), hashes
// the tile's dropout keep bits while both products run, and works out
// the online softmax of S once its product is done: the softmax of one
// tile overlaps the P V product of the one before.  Scores live in
// log2 units (scale * log2(e) folded into one multiply) so every
// exponential is one ex2; masks run only on the tiles that need them
// (the causal diagonal, the tile past Sk, tiles whose k segment ids are
// not all this thread's q segment id); the row sum stays split over the
// four threads of a row until the epilogue.
// Two consumer warpgroups take turns issuing their products on named
// barriers (ping-pong), so one's softmax runs under the other's
// products.  At D = 64 a block has one consumer warpgroup, so that two
// blocks share an SM and hide each other's loads and epilogue.  Timed
// against the other choices on an H100 SXM (700 W), one warpgroup took
// 15 % off the ERNIE shape at D = 64 and ping-pong up to 3 % off at
// D = 128; launching the heaviest causal q-blocks first gained about 1 %
// and made ptxas spill, so blocks run in grid order.

template <int D>
struct FwdLayout {
  static constexpr int kWgs = D == 64 ? 1 : 2;  // consumer warpgroups
  static constexpr int kThreads = 128 * (kWgs + 1), kBlocksPerSm = 3 - kWgs;
  // registers a thread after setmaxnreg, producer and consumers: a
  // warp of each role per block on each of the SM's four 16384-register
  // quarters
  static constexpr int kProducerRegs = kWgs == 2 ? 24 : 40,
                       kConsumerRegs = kWgs == 2 ? 240 : 216;
  static constexpr int kM = kWgs * kWgRows;       // q rows per block
  static constexpr int kN = D == 256 ? 64 : 128;  // keys per tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQB = kM * D * 2, kKB = kN * D * 2;  // bytes
  static constexpr int kQ = 0, kK = kQB, kV = kK + kStages * kKB,
                       kKs = kV + kStages * kKB,
                       kKu = kKs + kStages * kN * 4,  // {uniform, id}
                       kBars = kKu + kStages * 8,
                       kBytes = kBars + (4 * kStages + 1) * 8 + 1024;
};


constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // NEG_INF in log2 units

// S = Q K^T over D for one warpgroup's 64 rows (from r0 of the M-row Q
// tile) against a tile of N keys; issued, not committed.
template <typename T, int D, int M, int N>
__device__ __forceinline__ void fwd_qk(float (&s)[N / 2], const T* sQ,
                                       int r0, const T* sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T>(s, desc_k(sQ, M, r0, kk), desc_k(sK, N, 0, kk), kk > 0);
}

// O += P V over a tile of N keys; issued, not committed.
template <typename T, int D, int N>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 2],
                                       const uint32_t (&pf)[N / 16][4],
                                       const T* sV) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_rs<T>(o, pf[kk], desc_mn(sV, N, kk));
}

// `keep_elem` for this thread's elements of a tile at k0, bit i for
// element i of the score fragment; hrow[i] holds the row and head terms.
template <int N>
__device__ __forceinline__ void keep_bits(uint32_t (&bits)[N / 64],
                                          const Args& a, uint32_t seed,
                                          int k0, const uint32_t (&hrow)[2],
                                          int t) {
  const uint32_t hc = static_cast<uint32_t>(k0 + 2 * t) * 0x85EBCA77u;
#pragma unroll
  for (int w = 0; w < N / 64; ++w) bits[w] = 0u;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const uint32_t c = static_cast<uint32_t>((i >> 2) * 8 + (i & 1));
    const uint32_t x = hrow[(i >> 1) & 1] + hc + c * 0x85EBCA77u;
    bits[i >> 5] |= static_cast<uint32_t>(mix32(x ^ seed) >= a.thresh)
                    << (i & 31);
  }
}

// One tile's scores (fragment element 4 j + e: row row[e >> 1], column
// k0 + 8 j + 2 t + (e & 1)) become p in place: scaled to log2 units,
// masked where `mask`, the running max m and this thread's share l of
// the row sum updated (corr rescales what came before), then dropped by
// the keep bits.  Masked scores are NEG_INF (keys past Sk: -inf), so a
// row masked so far weighs its masked keys until a real score wipes
// them, as the plain version does.
template <int N>
__device__ __forceinline__ void fwd_softmax(
    float (&s)[N / 2], const Args& a, int k0, const int (&row)[2],
    const int (&qs)[2], const int* ks, bool mask, float scale_l2,
    const uint32_t (&bits)[N / 64], float (&m)[2], float (&l)[2],
    float (&corr)[2], int t) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] *= scale_l2;
  if (mask) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int c = (i >> 2) * 8 + 2 * t + (i & 1), col = k0 + c;
      const int ri = (i >> 1) & 1;
      if (col >= a.sk)
        s[i] = -INFINITY;
      else if (!causal_ok(a, row[ri], col) || (ks && qs[ri] != ks[c]))
        s[i] = kNegInf2;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = warp_group_max(mx[r]);
    corr[r] = exp2_ftz(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = exp2_ftz(s[i] - m[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  if (a.dropout) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      if (!((bits[i >> 5] >> (i & 31)) & 1u)) s[i] = 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FwdLayout<D>::kThreads,
                                  FwdLayout<D>::kBlocksPerSm)
    flash_fwd_kernel_16bit(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, Args a) {
  const uint32_t seed = load_seed(a);
  using L = FwdLayout<D>;
  constexpr int STAGES = L::kStages, N = L::kN, M = L::kM, WGS = L::kWgs;
  constexpr bool kPingPong = WGS == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  T* sQ = reinterpret_cast<T*>(sm + L::kQ);
  int* sKs = reinterpret_cast<int*>(sm + L::kKs);
  // per stage: whether the tile's k segment ids are all one id, and it
  int2* sKu = reinterpret_cast<int2*>(sm + L::kKu);
  // K (with its segment ids) and V stages fill and free apart: K is
  // free once its tile's softmax is done, V once its P V product is
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* kempty = kfull + STAGES;
  uint64_t* vfull = kempty + STAGES;
  uint64_t* vempty = vfull + STAGES;
  uint64_t* qbar = vempty + STAGES;
  auto sK = [&](int s) {
    return reinterpret_cast<T*>(sm + L::kK + s * L::kKB);
  };
  auto sV = [&](int s) {
    return reinterpret_cast<T*>(sm + L::kV + s * L::kKB);
  };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * M, off = a.sk - a.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = bh / a.heads;
  const int nk = num_k_tiles(a, q0, M, N);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], kProducer);
      mbar_init(&kempty[s], WGS * 128);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], WGS * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WGS) {  // ------------------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     L::kProducerRegs)
                 : "memory");
    if (warp == 4 * WGS) {
      if (lane == 0) {
        mbar_expect_tx(qbar, L::kQB);
        for (int p = 0; p < D / 64; ++p)
          tma_load(sQ + p * M * 64, &tq, qbar, p * 64, q0, bh);
      }
      const int* kseg =
          a.kseg ? a.kseg + static_cast<size_t>(b) * a.sk : nullptr;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES, k0 = kt * N;
        // the tile's k segment ids, read before the stage frees up
        int ks_v[N / 32];
        int lo = 0, hi = 0;
        if (kseg) {
#pragma unroll
          for (int j = 0; j < N / 32; ++j) {
            const int k = k0 + lane + 32 * j;
            ks_v[j] = k < a.sk ? kseg[k] : 0;
            lo = j ? min(lo, ks_v[j]) : ks_v[j];
            hi = j ? max(hi, ks_v[j]) : ks_v[j];
          }
          lo = __reduce_min_sync(0xffffffffu, lo);
          hi = __reduce_max_sync(0xffffffffu, hi);
        }
        const uint32_t parity = ((kt / STAGES) & 1) ^ 1;
        mbar_wait(&kempty[s], parity);
        if (kseg) {
#pragma unroll
          for (int j = 0; j < N / 32; ++j) sKs[s * N + lane + 32 * j] = ks_v[j];
          if (lane == 0) sKu[s] = make_int2(lo == hi && k0 + N <= a.sk, lo);
        }
        if (lane == 0) {
          mbar_expect_tx(&kfull[s], L::kKB);
          for (int p = 0; p < D / 64; ++p)
            tma_load(sK(s) + p * N * 64, &tk, &kfull[s], p * 64, k0, bh);
        } else {
          mbar_arrive(&kfull[s]);
        }
        mbar_wait(&vempty[s], parity);
        if (lane == 0) {
          mbar_expect_tx(&vfull[s], L::kKB);
          for (int p = 0; p < D / 64; ++p)
            tma_load(sV(s) + p * N * 64, &tv, &vfull[s], p * 64, k0, bh);
        }
      }
    }
  } else {  // ------------------------------------- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     L::kConsumerRegs)
                 : "memory");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int r0 = wg * kWgRows;  // this warpgroup's rows in the tile
    const int row[2] = {q0 + r0 + (warp & 3) * 16 + g,
                        q0 + r0 + (warp & 3) * 16 + g + 8};
    int qs[2] = {0, 0};
    uint32_t hrow[2];  // the row and head terms of `keep_elem`
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (a.qseg && row[i] < a.sq)
        qs[i] = a.qseg[static_cast<size_t>(b) * a.sq + row[i]];
      hrow[i] = static_cast<uint32_t>(row[i]) * 0x9E3779B1u +
                static_cast<uint32_t>(bh) * 0xC2B2AE3Du;
    }
    const float scale_l2 = a.scale * kLog2e;
    // whether tile kt at stage st needs the masks for this thread's rows
    auto needs_mask = [&](int kt, int st) {
      const int k0 = kt * N;
      bool mask = k0 + N > a.sk ||
                  (a.causal && k0 + N - 1 > q0 + r0 + off);
      if (a.kseg) {
        const int2 u = sKu[st];
        mask = mask || !u.x || qs[0] != u.y || qs[1] != u.y;
      }
      return mask;
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f}, corr[2];
    float s[N / 2];
    uint32_t pf[N / 16][4], bits[N / 64];
    if (kPingPong && wg == 1) bar_arrive(1, 2 * 128);  // WG 0 first
    mbar_wait(qbar, 0);

    if (nk > 0) {
      mbar_wait(&kfull[0], 0);
      wg_fence();
      fwd_qk<T, D, M, N>(s, sQ, r0, sK(0));
      wg_commit();
      if (a.dropout) keep_bits<N>(bits, a, seed, 0, hrow, t);
      const bool mask = needs_mask(0, 0);
      wg_wait0();
      fence_regs(s);
      fwd_softmax<N>(s, a, 0, row, qs, a.kseg ? sKs : nullptr, mask,
                     scale_l2, bits, m, l, corr, t);
      mbar_arrive(&kempty[0]);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) a_frag<T>(s, kk, pf[kk]);
    }
    for (int kt = 1; kt < nk; ++kt) {
      const int st = kt % STAGES, prev = (kt - 1) % STAGES;
      mbar_wait(&kfull[st], (kt / STAGES) & 1);
      mbar_wait(&vfull[prev], ((kt - 1) / STAGES) & 1);
      if (kPingPong) bar_sync(1 + wg, 2 * 128);
      // S of this tile and P V of the one before, as two groups
      fence_regs(o);
      wg_fence();
      fwd_qk<T, D, M, N>(s, sQ, r0, sK(st));
      wg_commit();
      fwd_pv<T, D, N>(o, pf, sV(prev));
      wg_commit();
      if (kPingPong) bar_arrive(2 - wg, 2 * 128);
      if (a.dropout) keep_bits<N>(bits, a, seed, kt * N, hrow, t);
      const bool mask = needs_mask(kt, st);
      wg_wait1();
      fence_regs(s);
      fwd_softmax<N>(s, a, kt * N, row, qs, a.kseg ? sKs + st * N : nullptr,
                     mask, scale_l2, bits, m, l, corr, t);
      mbar_arrive(&kempty[st]);
      wg_wait0();
      fence_regs(o);
      mbar_arrive(&vempty[prev]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) a_frag<T>(s, kk, pf[kk]);
    }
    if (kPingPong && wg == 0) bar_sync(1, 2 * 128);  // WG 1's last turn
    if (nk > 0) {
      const int last = (nk - 1) % STAGES;
      mbar_wait(&vfull[last], ((nk - 1) / STAGES) & 1);
      fence_regs(o);
      wg_fence();
      fwd_pv<T, D, N>(o, pf, sV(last));
      wg_commit();
      wg_wait0();
      fence_regs(o);
      mbar_arrive(&vempty[last]);
    }

    // o / l (times 1 / (1 - p_drop): the kept p were not rescaled), dead
    // rows 0; lse = m + log l in natural log
    float mul[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lt = warp_group_sum(l[i]);
      const float safe = lt == 0.f ? 1.f : lt;
      const bool dead = a.qseg && m[i] <= kNegInf2 * 0.5f;
      mul[i] = dead ? 0.f : (a.dropout ? a.rescale : 1.f) / safe;
      if (t == 0 && row[i] < a.sq)
        a.lse_out[static_cast<size_t>(bh) * a.sq + row[i]] =
            m[i] * kLn2 + logf(safe);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= mul[(i >> 1) & 1];
    store_acc<T, D>(
        static_cast<T*>(a.out0) + static_cast<size_t>(bh) * a.sq * D, o,
        row, a.sq, t);
  }
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
  const uint32_t seed = load_seed(a);
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

  const int nk = num_k_tiles(a, q0, T, T);
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
      if (a.dropout) pa = keep_elem(a, seed, bh, row, k0 + cl) ? pa * a.rescale : 0.f;
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
  const uint32_t seed = load_seed(a);
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
        const bool kp = keep_elem(a, seed, bh, qrow, key);
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
  const uint32_t seed = load_seed(a);
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

  const int nk = num_k_tiles(a, q0, T, T);
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
      if (a.dropout) d = keep_elem(a, seed, bh, row, col) ? d * a.rescale : 0.f;
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

// cuTensorMapEncodeTiled is a driver-API symbol: it is fetched once
// through the runtime's driver entry point, so the library links
// without -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a 16-bit [bh, s, D] tensor of type `type` read as
// [rows, 64] panels,
// 128-byte swizzled; rows past s read as zeros.  Built per call: the
// map holds the tensor's address.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              int bh, int s, int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return enc(map, type, 3,
             const_cast<void*>(base), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared-memory opt-in of one kernel instantiation: set on
// its first launch, not on every launch.
template <auto Kernel>
cudaError_t smem_opt_in(size_t bytes) {
  static const cudaError_t rc = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  return rc;
}

template <auto Kernel, typename... P>
int launch_one(dim3 grid, int threads, size_t smem, cudaStream_t stream,
               const P&... params) {
  const cudaError_t rc = smem_opt_in<Kernel>(smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  Kernel<<<grid, threads, smem, stream>>>(params...);
  return static_cast<int>(cudaGetLastError());
}

static_assert(FwdLayout<64>::kBytes <= 232448 / FwdLayout<64>::kBlocksPerSm &&
                  FwdLayout<128>::kBytes <= 232448 &&
                  FwdLayout<256>::kBytes <= 232448,
              "a 16-bit forward block exceeds the shared memory of an SM");
static_assert(DkdvLayout<64>::kBytes <= 232448 / 2 &&
                  DqLayout<64>::kBytes <= 232448 / 2 &&
                  DqLayout<128>::kBytes <= 232448 / 2 &&
                  DkdvLayout<128>::kBytes <= 232448 &&
                  DkdvLayout<256>::kBytes <= 232448 &&
                  DqLayout<256>::kBytes <= 232448,
              "a 16-bit backward block exceeds its share of shared memory");

// The tensor-core kernels of element type T; they read q, k, v (and dO)
// through tensor maps.
template <typename T, int D>
int launch16(int kind, int bh_count, const Args& a, cudaStream_t stream) {
  constexpr CUtensorMapDataType ty = Elem<T>::kMap;
  CUtensorMap m[4];
  if (kind == kFwd) {
    using L = FwdLayout<D>;
    if (!make_map(&m[0], ty, a.q, bh_count, a.sq, D, L::kM) ||
        !make_map(&m[1], ty, a.k, bh_count, a.sk, D, L::kN) ||
        !make_map(&m[2], ty, a.v, bh_count, a.sk, D, L::kN))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_one<flash_fwd_kernel_16bit<T, D>>(
        dim3((a.sq + L::kM - 1) / L::kM, bh_count), L::kThreads, L::kBytes,
        stream, m[0], m[1], m[2], a);
  }
  if (!make_map(&m[0], ty, a.q, bh_count, a.sq, D, kWgRows) ||
      !make_map(&m[1], ty, a.k, bh_count, a.sk, D, kWgRows) ||
      !make_map(&m[2], ty, a.v, bh_count, a.sk, D, kWgRows) ||
      !make_map(&m[3], ty, a.dout, bh_count, a.sq, D, kWgRows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kDkdv)
    return launch_one<flash_dkdv_kernel_16bit<T, D>>(
        dim3((a.sk + kWgRows - 1) / kWgRows, bh_count), dkdv_threads<D>(),
        DkdvLayout<D>::kBytes, stream, m[0], m[1], m[2], m[3], a);
  if (kind == kDq)
    return launch_one<flash_dq_kernel_16bit<T, D>>(
        dim3((a.sq + kWgRows - 1) / kWgRows, bh_count), 128 + kProducer,
        DqLayout<D>::kBytes, stream, m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch(int dtype, int kind, int bh_count, const Args& a,
           cudaStream_t stream) {
  if (dtype == kBF16) {
    return launch16<bf16, D>(kind, bh_count, a, stream);
  } else if (dtype == kF16) {
    return launch16<f16, D>(kind, bh_count, a, stream);
  } else if (dtype == kF32) {
    constexpr int T = f32_tile<D>();
    const int tiles = kind == kDkdv ? (a.sk + T - 1) / T : (a.sq + T - 1) / T;
    const dim3 grid(tiles, bh_count);
    const int mats = kind == kFwd ? 3 : 4;
    const int vecs = kind == kDkdv ? 3 : 1;  // lse, delta, seg / seg
    const int score_tiles = kind == kDkdv ? 2 : 1;
    const size_t smem = mats * T * (D + 1) * 4 +
                        score_tiles * T * (T + 1) * 4 + vecs * T * 4;
    switch (kind) {
      case kFwd:
        return launch_one<flash_fwd_kernel_f32<D, T>>(grid, 4 * T, smem,
                                                      stream, a);
      case kDkdv:
        return launch_one<flash_dkdv_kernel_f32<D, T>>(grid, 4 * T, smem,
                                                       stream, a);
      case kDq:
        return launch_one<flash_dq_kernel_f32<D, T>>(grid, 4 * T, smem,
                                                     stream, a);
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
               int causal, int dropout, const void* seed, unsigned thresh,
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
  a.seed_ptr = static_cast<const uint32_t*>(seed);
  a.thresh = thresh;
  a.rescale = rescale;
  return a;
}

}  // namespace

extern "C" {

int pit_flash_fwd(int dtype, int D, const void* q, const void* k,
                  const void* v, const void* qseg, const void* kseg, void* o,
                  void* lse, int BH, int Sq, int Sk, int H, float scale,
                  int causal, int dropout, const void* seed, unsigned thresh,
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
                   float scale, int causal, int dropout, const void* seed,
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
                 int causal, int dropout, const void* seed, unsigned thresh,
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
