// Paged attention over a head-major KV page pool [P, H, page, D] for
// Hopper (sm_90a).  Three kernels, one source:
//
// paged_decode_kernel — replaces the Pallas kernel
//   paddle_infer_tpu/ops/pallas/paged_attention.py:140 `_decode_kernel`
//   (launched by `_decode_local`, :307).  One query per row against the
//   row's pages.  Bound: device-memory bytes — every K and V byte of the
//   row's ceil(len/page) pages is read once and used for 2 FLOPs, far
//   under the ~295 FLOP/byte the card needs to be compute-bound.  Design:
//   one 128-thread block per (row, head); a loop over the row's pages
//   takes the place of the TPU's sequential `max_pages` grid axis, so
//   pages past the row's length are never read.  K and V rows arrive as
//   16-byte vector loads (8 bf16, 4 fp32 or 16 int8 values per lane).
//   Per page: each group of G lanes dots one slot (shuffle reduction),
//   slot scores meet in shared memory, then every thread applies the same
//   online-softmax update (m, l in f32) and accumulates p*V for its own
//   slots into an f32 partial accumulator that alpha rescales; the
//   partials are summed once at the end.  One __syncthreads per page
//   (double-buffered score row).
//
// paged_verify_kernel — replaces the Pallas kernel
//   paddle_infer_tpu/ops/pallas/paged_attention.py:317 `_verify_kernel`
//   (launched by `_verify_local`, :476).  W query lanes per row (the last
//   emitted token and W-1 drafts), lane w masked at lengths[b, w]; lane
//   (b, w) must equal the decode kernel at lengths[b, w] bit for bit,
//   which is what keeps greedy speculative streams equal to plain ones.
//   Bound: bytes, as decode — each K/V byte of the longest lane's pages
//   once.  Design: the decode kernel's block per (row, head) and thread
//   mapping, one page walk for up to 8 lanes (a further z-block walks
//   again for lanes 8..15, and so on), the decode kernel's two per-query
//   device functions called per lane unchanged; a lane skips the pages
//   past its own length, as the decode kernel's shorter walk does.
//
// ragged_paged_kernel — replaces the Pallas kernel
//   paddle_infer_tpu/ops/pallas/ragged_paged_attention.py:132
//   `_ragged_kernel` (launched by `_ragged_kernel_call`, :239).  Row b
//   carries q_lens[b] queries at absolute positions ctx[b] + i under the
//   causal predicate slot <= ctx + i.  Bound: for decode rows, bytes as
//   above; for prompt chunks the 4*qlen*(ctx+qlen)*D FLOPs per head.
//   Design: one block per (row, head, tile of 16 queries); inactive tiles
//   write zeros and exit; a tile walks only the pages its last query can
//   see.  Each page is staged in shared memory as f32 (int8 dequantised
//   by its per-(page, head) scale on load), 16x`page` scores are dotted
//   from shared memory, 16 threads run the online softmax (one per query)
//   and every thread accumulates p*V for its own head dimensions.  Plain
//   CUDA cores; wgmma/TMA tiles are a later step.
//
// Numerics shared by all three: NEG_INF = -1e30 (not -inf, so exp(m_prev -
// m_new) is 0, never NaN, on the first page), masked slots score NEG_INF
// and weigh exactly 0, out = acc / max(l, 1e-20), written in q's dtype.
//
// C interface (ctypes): every pointer and the stream are void*; each
// entry returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTQ = 16;     // queries per ragged tile
constexpr int kMaxDPT = 2;  // head dims per thread in the ragged PV loop
constexpr int kVerifyLanes = 8;  // verify lanes sharing one page walk

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

// ---------------------------------------------------------------- decode
// The per-query reduction order lives in these two device functions so a
// W-lane verify kernel (one page walk, W queries) can call them per lane
// unchanged and stay bitwise equal to this decode kernel per lane.

// Scores of one page for the query whose slice `qf` this lane holds:
// slot s is dotted by lane group `gid` (G lanes, `vpl` 16-byte vectors
// each), reduced by xor-shuffles inside the group, masked at `len`.
template <typename KT>
__device__ __forceinline__ void decode_page_scores(
    const float* qf, const KT* kpage, float kscale, float* sc, int page,
    int D, int j, int len, float scale, int G, int vpl, int gid, int lig,
    int ngroups) {
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int QPL = VEC > 8 ? VEC : 8;
  for (int s0 = 0; s0 < page; s0 += ngroups) {
    const int s = s0 + gid;
    float part = 0.f;
    if (s < page) {
#pragma unroll
      for (int v = 0; v < QPL / VEC; ++v) {
        if (v < vpl) {
          float kf[VEC];
          load16(kpage + static_cast<size_t>(s) * D + (lig + v * G) * VEC,
                 kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            part += qf[v * VEC + e] * (kf[e] * kscale);
        }
      }
    }
    for (int off = G / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (s < page && lig == 0)
      sc[s] = (j * page + s < len) ? part * scale : kNegInf;
  }
}

// Online-softmax update from one page's scores (identical in every
// thread: same shared values, same order), then p*V for this thread's
// slots (s = sg, sg + nsg, ...) and head-dim vector `vi` into `acc`.
template <typename KT>
__device__ __forceinline__ void decode_page_update(
    const float* sc, const KT* vpage, float vscale, int page, int D,
    float& m, float& l, float* acc, int vi, int sg, int nsg) {
  constexpr int VEC = 16 / sizeof(KT);
  float m_cur = kNegInf;
  for (int s = 0; s < page; ++s) m_cur = fmaxf(m_cur, sc[s]);
  const float m_new = fmaxf(m, m_cur);
  const float alpha = expf(m - m_new);
  float psum = 0.f;
  for (int s = 0; s < page; ++s) psum += expf(sc[s] - m_new);
  l = l * alpha + psum;
  m = m_new;
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
  for (int s = sg; s < page; s += nsg) {
    const float p = expf(sc[s] - m_new);
    float vf[VEC];
    load16(vpage + static_cast<size_t>(s) * D + vi * VEC, vf);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += p * (vf[e] * vscale);
  }
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ lengths, QT* __restrict__ out, int P, int H,
    int D, int page, int max_pages, float scale) {
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int QPL = VEC > 8 ? VEC : 8;
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int nvec = D / VEC;                // 16-byte vectors per row
  const int G = nvec < 32 ? nvec : 32;     // lanes per slot (scores)
  const int vpl = nvec / G;
  const int ngroups = kThreads / G;
  const int gid = tid / G, lig = tid % G;
  const int vi = tid % nvec, sg = tid / nvec;  // p*V layout
  const int nsg = kThreads / nvec;
  float* sbuf = smem;                      // [2][page]
  float* red = smem + 2 * page;            // [nsg][D]

  const QT* qrow = q + (static_cast<size_t>(b) * H + h) * D;
  float qf[QPL];
#pragma unroll
  for (int v = 0; v < QPL / VEC; ++v) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qf[v * VEC + e] = v < vpl ? to_f(qrow[(lig + v * G) * VEC + e]) : 0.f;
  }

  const int len = lengths[b];
  int npages = len > 0 ? (len + page - 1) / page : 0;
  if (npages > max_pages) npages = max_pages;
  const int* trow = tables + static_cast<size_t>(b) * max_pages;
  float m = kNegInf, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int j = 0; j < npages; ++j) {
    int phys = trow[j];
    phys = phys < 0 ? 0 : (phys >= P ? P - 1 : phys);
    const size_t ph = static_cast<size_t>(phys) * H + h;
    const size_t base = ph * page * D;
    const float kscale = ksc ? ksc[ph] : 1.f;
    const float vscale = vsc ? vsc[ph] : 1.f;
    float* sc = sbuf + (j & 1) * page;
    decode_page_scores<KT>(qf, kp + base, kscale, sc, page, D, j, len,
                           scale, G, vpl, gid, lig, ngroups);
    __syncthreads();
    decode_page_update<KT>(sc, vp + base, vscale, page, D, m, l, acc, vi,
                           sg, nsg);
  }

#pragma unroll
  for (int e = 0; e < VEC; ++e) red[sg * D + vi * VEC + e] = acc[e];
  __syncthreads();
  const float denom = fmaxf(l, 1e-20f);
  QT* orow = out + (static_cast<size_t>(b) * H + h) * D;
  for (int d = tid; d < D; d += kThreads) {
    float s = 0.f;
    for (int g = 0; g < nsg; ++g) s += red[g * D + d];
    orow[d] = from_f<QT>(s / denom);
  }
}

// ---------------------------------------------------------------- verify
// W query lanes per row, lane w masked at its own lengths[b, w]; lane
// (b, w) is bit for bit paged_decode_kernel at lengths[b, w].  Same
// thread mapping as the decode kernel; the lanes of one group share one
// page walk and call decode_page_scores / decode_page_update per lane.
// A lane skips every page at or past its own length, exactly as the
// decode kernel's shorter walk never reaches them, so its (m, l, acc)
// sees the decode kernel's sequence of updates and nothing else.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_verify_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ lengths, QT* __restrict__ out, int P, int W,
    int H, int D, int page, int max_pages, float scale) {
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int QPL = VEC > 8 ? VEC : 8;
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int w0 = blockIdx.z * kVerifyLanes;
  const int nl = (W - w0) < kVerifyLanes ? (W - w0) : kVerifyLanes;
  const int nvec = D / VEC;
  const int G = nvec < 32 ? nvec : 32;
  const int vpl = nvec / G;
  const int ngroups = kThreads / G;
  const int gid = tid / G, lig = tid % G;
  const int vi = tid % nvec, sg = tid / nvec;
  const int nsg = kThreads / nvec;
  float* sbuf = smem;                          // [2][lanes][page]
  float* qs = sbuf + 2 * kVerifyLanes * page;  // [lanes][G][QPL]
  float* red = qs + kVerifyLanes * G * QPL;    // [nsg][D]

  // each lane's query slice, laid out per (lane, lig) as the decode
  // kernel holds it in registers (16 int8 lanes would not fit there)
  for (int idx = tid; idx < nl * G * QPL; idx += kThreads) {
    const int w = idx / (G * QPL), r = idx % (G * QPL);
    const int li = r / QPL, i = r % QPL, v = i / VEC, e = i % VEC;
    const QT* qrow =
        q + ((static_cast<size_t>(b) * W + w0 + w) * H + h) * D;
    qs[idx] = v < vpl ? to_f(qrow[(li + v * G) * VEC + e]) : 0.f;
  }

  int len[kVerifyLanes];
  int maxlen = 0;
#pragma unroll
  for (int w = 0; w < kVerifyLanes; ++w) {
    len[w] = w < nl ? lengths[static_cast<size_t>(b) * W + w0 + w] : 0;
    maxlen = len[w] > maxlen ? len[w] : maxlen;
  }
  // the longest lane gates the walk (the last one: lengths do not
  // decrease over w), clamped to the table width as in decode
  int npages = maxlen > 0 ? (maxlen + page - 1) / page : 0;
  if (npages > max_pages) npages = max_pages;
  const int* trow = tables + static_cast<size_t>(b) * max_pages;
  float m[kVerifyLanes], l[kVerifyLanes], acc[kVerifyLanes][VEC];
#pragma unroll
  for (int w = 0; w < kVerifyLanes; ++w) {
    m[w] = kNegInf;
    l[w] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[w][e] = 0.f;
  }
  __syncthreads();                             // qs filled

  for (int j = 0; j < npages; ++j) {
    int phys = trow[j];
    phys = phys < 0 ? 0 : (phys >= P ? P - 1 : phys);
    const size_t ph = static_cast<size_t>(phys) * H + h;
    const size_t base = ph * page * D;
    const float kscale = ksc ? ksc[ph] : 1.f;
    const float vscale = vsc ? vsc[ph] : 1.f;
    float* sc = sbuf + (j & 1) * kVerifyLanes * page;
    // lane conditions are block-uniform, so the shuffles inside
    // decode_page_scores see every thread of the warp
#pragma unroll
    for (int w = 0; w < kVerifyLanes; ++w)
      if (w < nl && j * page < len[w])
        decode_page_scores<KT>(qs + (w * G + lig) * QPL, kp + base, kscale,
                               sc + w * page, page, D, j, len[w], scale, G,
                               vpl, gid, lig, ngroups);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kVerifyLanes; ++w)
      if (w < nl && j * page < len[w])
        decode_page_update<KT>(sc + w * page, vp + base, vscale, page, D,
                               m[w], l[w], acc[w], vi, sg, nsg);
  }

  // per lane, the decode kernel's cross-group sum and division
#pragma unroll
  for (int w = 0; w < kVerifyLanes; ++w) {
    if (w < nl) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[sg * D + vi * VEC + e] = acc[w][e];
      __syncthreads();
      const float denom = fmaxf(l[w], 1e-20f);
      QT* orow = out + ((static_cast<size_t>(b) * W + w0 + w) * H + h) * D;
      for (int d = tid; d < D; d += kThreads) {
        float s = 0.f;
        for (int g = 0; g < nsg; ++g) s += red[g * D + d];
        orow[d] = from_f<QT>(s / denom);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- ragged
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

template <typename KT>
size_t decode_smem(int D, int page) {
  const int nvec = D / (16 / static_cast<int>(sizeof(KT)));
  return (2 * page + (kThreads / nvec) * D) * sizeof(float);
}

template <typename KT>
size_t verify_smem(int D, int page) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(KT));
  constexpr int QPL = VEC > 8 ? VEC : 8;
  const int nvec = D / VEC;
  const int G = nvec < 32 ? nvec : 32;
  return (2 * kVerifyLanes * page + kVerifyLanes * G * QPL +
          (kThreads / nvec) * D) * sizeof(float);
}

size_t ragged_smem(int D, int page) {
  return (kTQ * (D + 1) + page * (D + 1) + page * D + kTQ * page +
          3 * kTQ) * sizeof(float);
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  return 0;
}

template <typename QT, typename KT>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* tables,
                  const void* lengths, void* out, int B, int P, int H,
                  int D, int page, int max_pages, float scale,
                  cudaStream_t stream) {
  auto kernel = paged_decode_kernel<QT, KT>;
  const size_t smem = decode_smem<KT>(D, page);
  if (int rc = set_smem(kernel, smem)) return rc;
  kernel<<<dim3(B, H), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), P, H, D,
      page, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_verify(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* tables,
                  const void* lengths, void* out, int B, int W, int P,
                  int H, int D, int page, int max_pages, float scale,
                  cudaStream_t stream) {
  auto kernel = paged_verify_kernel<QT, KT>;
  const size_t smem = verify_smem<KT>(D, page);
  if (int rc = set_smem(kernel, smem)) return rc;
  const int groups = (W + kVerifyLanes - 1) / kVerifyLanes;
  kernel<<<dim3(B, H, groups), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), P, W, H, D,
      page, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_ragged(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* tables,
                  const void* ctx, const void* qlens, void* out, int B,
                  int P, int C, int H, int D, int page, int max_pages,
                  float scale, cudaStream_t stream) {
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

int pit_paged_decode(int qdt, int kvdt, const void* q, const void* k,
                     const void* v, const void* ks, const void* vs,
                     const void* tables, const void* lengths, void* out,
                     int B, int P, int H, int D, int page, int max_pages,
                     float scale, void* stream) {
  PIT_DISPATCH(launch_decode, q, k, v, ks, vs, tables, lengths, out, B, P,
               H, D, page, max_pages, scale,
               static_cast<cudaStream_t>(stream))
}

int pit_paged_verify(int qdt, int kvdt, const void* q, const void* k,
                     const void* v, const void* ks, const void* vs,
                     const void* tables, const void* lengths, void* out,
                     int B, int W, int P, int H, int D, int page,
                     int max_pages, float scale, void* stream) {
  PIT_DISPATCH(launch_verify, q, k, v, ks, vs, tables, lengths, out, B, W,
               P, H, D, page, max_pages, scale,
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
