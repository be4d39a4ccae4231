// One-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention, body _kernel): for every sequence b and query head h,
//   out[b, h] = softmax_t(cap(q[b, h] . k[t] / sqrt(D))) . v[t]
// over the positions t < lengths[b] whose page (block_table[b, t / page])
// is resident (>= 0), with K/V head h / G (G = H / KV query heads share one
// KV head), scores and softmax in float32, output in q's dtype.  A row with
// no such position gives zeros.  cap(s) = c * tanh(s / c) when the softcap
// c > 0, else s.  Pools are read through their strides (page, token,
// head; the last dim must be contiguous), so a layer view of a multi-layer
// pool needs no copy.
//
// Two kernels compute this function; the wrapper's pick_variant chooses.
//
// "walk" (paged_attention_kernel; float32, and shapes the split kernel does
// not take).  One block of 256 threads per (KV head, sequence), grid (KV,
// B).  The block keeps its G query rows (pre-scaled by 1/sqrt(D)) in
// shared memory as float32, and the G x D accumulator in registers (G * D
// / 256 values a thread) with the row max m and sum l in shared memory.
// It walks the sequence's block table in order, skips pages whose entry is
// < 0 (or >= P) and stops at the first page that starts at or past the
// length.  For each page it stages that KV head's K and V rows (page x D,
// q's dtype) in shared memory with 16-byte loads, then
//   1. scores: one (query row, position) dot product a thread, reading K
//      rows as 16-byte vectors; rows are padded by 16 bytes so the eight
//      lanes of a quarter warp hit distinct banks;
//   2. online softmax: one warp per query row takes the page's max, the
//      correction exp(m_old - m_new) and the exponentials, and updates l;
//   3. accumulate: acc = acc * correction + p . V.
// What holds it back: at the serving shape the grid is 128 blocks (one an
// SM, most SMs waiting on memory); each resident page costs four block
// barriers and no load overlaps compute; scores and P . V run on the FMA
// units, one scalar product a thread.
//
// "split" (paged_attention_split_kernel + paged_attention_combine_kernel;
// bfloat16 and float16 at D = 64 or 128, pages a multiple of 16 tokens).
// Split-K decoding on the tensor cores:
//   * Grid (splits, KV x m-tiles, B): one CTA of 4 warps per (sequence, KV
//     head, 16 query rows of its group, share).  Share s holds ranks
//     [s n / splits, (s + 1) n / splits) of the sequence's n resident
//     pages in table order, so the shares are even whatever the table
//     looks like.  The wrapper's split_plan picks splits from the shape and
//     the pool's size (at most P pages are resident over B sequences): as
//     many as give each share 16 units and the grid one CTA an SM, and at
//     least ceil(pages_per_seq / 32).  At the serving shape that is one
//     split, 128 CTAs of about 4 pages each.
//   * Warp 0 ballots the sequence's table entries 32 at a time (entries at
//     or past the length skipped) to count n, then again to write the
//     CTA's share (at most 32 pages) and each page's valid token count to
//     shared memory; the block's only barrier before the merge.
//   * A share's tokens form units of 16 (a page of 64 tokens is 4 units);
//     warp w takes units w, w + 4, ...  Each warp runs its own 2-stage ring
//     of (K, V) unit tiles in shared memory, filled by 16-byte cp.async
//     copies (rows past the length zero-filled), so the next unit loads
//     while this one is computed, with no block barrier.
//   * S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 or fp16 in,
//     float32 out): the G <= 16 query rows are one m16 tile (zero rows pad
//     G < 16; G > 16 takes several m-tiles, one a CTA), K comes in with
//     ldmatrix and V with ldmatrix.trans, and S, the online softmax (quad
//     shuffles; the 1/sqrt(D) scale and log2(e) folded into one multiply
//     before ex2) and P stay in the warp's registers.
//   * The four warps' (m, l, acc) merge once, in warp order, in shared
//     memory.  With one split the CTA writes the output; otherwise it
//     writes a float32 partial (m, l and, if it saw a position, acc) per
//     query row and split, and paged_attention_combine_kernel (one warp a
//     query row) merges the partials in split order, so the result does
//     not depend on timing.  A split with no resident page has m = -inf and
//     l = 0 and adds nothing; a row with none at all gives zeros.
// The bf16/fp16 rounding of P before P V is the one numerical difference
// from the walk kernel (l sums the float32 p).
//
// What bounds it on the card.  Bytes: the resident K and V rows of the
// attended positions are each read once (plus q and the output); at the
// serving shape (64 sequences, at most 256 resident pages of 64 tokens x
// 2 KV heads x 128 x bf16) that is at most 16.8 MB, about 5 us at
// 3.35 TB/s.  Per page it does 2 x G x page x D flops against
// 2 x page x D x 2 bytes, about 16 flops a byte at G = 16: far below the
// card's compute ridge.  So the split kernel's aim is loads in flight:
// every warp streams its own units through a ring, and the tensor cores
// keep the arithmetic between loads short.  Each CTA has fixed costs (its
// Q load, the ballots, the merge) and each extra split adds a partial
// (2 x H x D x 4 bytes a sequence, written and read back through L2) and
// the combine launch, which is why the plan splits only sequences with
// many resident pages.
//
// C interface: paged_attention_launch(...) (walk) and
// paged_attention_split_launch(...) (split, then combine when splits > 1)
// launch on the given stream, allocate nothing (the partials are the
// caller's scratch), and return cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// G * D <= kThreads * kMaxAcc (the wrapper checks)
constexpr int kMaxAcc = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dot of a shared K row (T, 16-byte vectors) with a shared q row (f32)
template <typename T>
__device__ __forceinline__ float row_dot(const T* k_row, const float* q_row, int D) {
  constexpr int kVec = 16 / sizeof(T);
  float acc = 0.0f;
  for (int c = 0; c < D; c += kVec) {
    uint4 raw = *reinterpret_cast<const uint4*>(k_row + c);
    const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc = fmaf(q_row[c + e], to_f32(kv[e]), acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int G, int D, int page, int ppseq, int n_pages, int KV,
                       long long k_sp, long long k_st, long long k_sh,
                       long long v_sp, long long v_st, long long v_sh,
                       float scale, float cap) {
  constexpr int kVec = 16 / sizeof(T);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Dp = D + kVec;  // padded shared row (elements)
  const int GD = G * D;

  extern __shared__ uint4 smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + page * Dp;
  float* q_s = reinterpret_cast<float*>(v_s + page * Dp);
  float* p_s = q_s + GD;      // G x page scores, then probabilities
  float* m_s = p_s + G * page;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int len = lengths[b];
  const T* qb = q + (static_cast<long long>(b) * KV + h) * GD;
  for (int i = tid; i < GD; i += kThreads) q_s[i] = to_f32(qb[i]) * scale;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = neg_inf;
    l_s[g] = 0.0f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.0f;
  __syncthreads();

  const int vpr = D / kVec;  // 16-byte vectors per row
  for (int j = 0; j < ppseq; ++j) {
    const int start = j * page;
    if (start >= len) break;  // every later page starts past the length too
    const int slot = table[static_cast<long long>(b) * ppseq + j];
    if (slot < 0 || slot >= n_pages) continue;
    const int valid = min(page, len - start);
    const T* kp = k + slot * k_sp + h * k_sh;
    const T* vp = v + slot * v_sp + h * v_sh;
    for (int i = tid; i < valid * vpr; i += kThreads) {
      const int t = i / vpr, c = (i - t * vpr) * kVec;
      *reinterpret_cast<uint4*>(k_s + t * Dp + c) =
          *reinterpret_cast<const uint4*>(kp + t * k_st + c);
      *reinterpret_cast<uint4*>(v_s + t * Dp + c) =
          *reinterpret_cast<const uint4*>(vp + t * v_st + c);
    }
    __syncthreads();
    // 1. scores
    for (int i = tid; i < G * valid; i += kThreads) {
      const int g = i / valid, t = i - g * valid;
      float s = row_dot(k_s + t * Dp, q_s + g * D, D);
      if (cap > 0.0f) s = cap * tanhf(s / cap);
      p_s[g * page + t] = s;
    }
    __syncthreads();
    // 2. online softmax, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float mx = neg_inf;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, p_s[g * page + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int t = lane; t < valid; t += 32) {
        const float e = expf(p_s[g * page + t] - m_new);
        p_s[g * page + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first page
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + p . V
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < GD) {
        const int g = idx / D, d = idx - g * D;
        const float* pg = p_s + g * page;
        float a = acc[r] * c_s[g];
        for (int t = 0; t < valid; ++t) a = fmaf(pg[t], to_f32(v_s[t * Dp + d]), a);
        acc[r] = a;
      }
    }
    __syncthreads();  // k_s, v_s, p_s and c_s are rewritten by the next page
  }

  T* ob = out + (static_cast<long long>(b) * KV + h) * GD;
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int idx = tid + r * kThreads;
    if (idx < GD) ob[idx] = from_f32<T>(acc[r] / fmaxf(l_s[idx / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lengths, void* out, int B, int KV, int G, int D, int page,
           int ppseq, int n_pages, const long long* k_strides,
           const long long* v_strides, float scale, float cap,
           size_t smem_bytes, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(KV, B);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<T*>(out), G, D, page, ppseq, n_pages, KV, k_strides[0],
      k_strides[1], k_strides[2], v_strides[0], v_strides[1], v_strides[2], scale,
      cap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "split": split-K decode on the tensor cores (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kStages = 2;     // a warp's ring of unit tiles
constexpr int kRows = 16;      // query rows of one m16 tile
constexpr int kUnit = 16;      // tokens of one unit (one k16 step of P V)
constexpr int kMaxShare = 32;  // resident pages a CTA takes (one warp ballot)
constexpr float kLog2e = 1.4426950408889634f;

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* lengths;
  void* out;
  float* m_part;    // (B * H, splits), log2 domain
  float* l_part;    // (B * H, splits)
  float* acc_part;  // (B * H, splits, D)
  int H, KV, G, page, ppseq, n_pages, splits;
  long long k_sp, k_st, k_sh, v_sp, v_st, v_sh;
  float scale, cap;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !ok (src must still be valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared memory of one CTA: each warp's ring (kStages x (K, V) tiles of
// kUnit rows, padded by 16 bytes a row so ldmatrix's eight row addresses
// hit distinct banks), later reused for the merge of the warps' partials.
template <typename T, int D>
constexpr int split_ring_bytes() {
  return kSplitWarps * kStages * 2 * kUnit * (D + 16 / static_cast<int>(sizeof(T))) *
         static_cast<int>(sizeof(T));
}

template <int D>
constexpr int split_merge_bytes() {
  return (kSplitWarps * kRows * D + 2 * kSplitWarps * kRows) * 4;
}

template <typename T, int D>
constexpr int split_smem_bytes() {
  return split_ring_bytes<T, D>() > split_merge_bytes<D>() ? split_ring_bytes<T, D>()
                                                            : split_merge_bytes<D>();
}

// At most 170 registers a thread, so three CTAs (their 68 KB of shared
// memory each) fit an SM.
template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads, 3)
paged_attention_split_kernel(const SplitArgs a) {
  constexpr int W = kSplitWarps;
  constexpr int S = kStages;
  constexpr int kLd = D + 16 / sizeof(T);          // padded tile row (elements)
  constexpr int kVec = 16 / sizeof(T);             // elements of a 16-byte copy
  constexpr int kCpr = D / kVec;                   // 16-byte copies a row
  constexpr int kKs = D / 16;                      // k16 steps of Q K^T
  constexpr int kNd = D / 8;                       // n8 tiles of the output
  constexpr int kTile = kUnit * kLd;               // one K or V tile (elements)
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));

  const int split = blockIdx.x;
  const int m_tiles = gridDim.y / a.KV;
  const int h = blockIdx.y / m_tiles;
  const int g0 = (blockIdx.y - h * m_tiles) * kRows;  // first query row of the group
  const int rows = min(kRows, a.G - g0);
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  extern __shared__ uint4 smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * (S * 2 * kTile);
  __shared__ int s_slot[kMaxShare];
  __shared__ int s_valid[kMaxShare];
  __shared__ int s_count;

  // Q fragments (A of m16n8k16, row-major): rows g0 + r and g0 + r + 8,
  // columns 16 ks + c, + 1 and + 8, + 9; rows past G are zero.  Issued
  // first, so they are in flight during the ballots.
  const int r = lane >> 2, c = (lane & 3) * 2;
  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<long long>(b) * a.H + h * a.G + g0) * D;
  uint32_t qa[kKs][4];
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    const int col = ks * 16 + c;
    qa[ks][0] = r < rows ? *reinterpret_cast<const uint32_t*>(qb + r * D + col) : 0u;
    qa[ks][1] = r + 8 < rows ? *reinterpret_cast<const uint32_t*>(qb + (r + 8) * D + col) : 0u;
    qa[ks][2] = r < rows ? *reinterpret_cast<const uint32_t*>(qb + r * D + col + 8) : 0u;
    qa[ks][3] =
        r + 8 < rows ? *reinterpret_cast<const uint32_t*>(qb + (r + 8) * D + col + 8) : 0u;
  }
  const int len = a.lengths[b];
  if (warp == 0) {
    // This CTA's share of the sequence's resident pages: ranks [r0, r1)
    // of them in table order, an even split of their count over the
    // splits.  Entries at or past the length are never resident.
    const int* row = a.table + static_cast<long long>(b) * a.ppseq;
    auto entry = [&](int e, int& slot, int& valid) {
      slot = -1;
      valid = 0;
      if (e < a.ppseq && e * a.page < len) {
        slot = row[e];
        valid = min(a.page, len - e * a.page);
      }
      return slot >= 0 && slot < a.n_pages;
    };
    int n_res = 0;
    for (int e0 = 0; e0 < a.ppseq && e0 * a.page < len; e0 += 32) {
      int slot, valid;
      n_res += __popc(__ballot_sync(0xffffffffu, entry(e0 + lane, slot, valid)));
    }
    const int r0 = static_cast<int>(static_cast<long long>(split) * n_res / a.splits);
    const int r1 = static_cast<int>(static_cast<long long>(split + 1) * n_res / a.splits);
    int seen = 0;
    for (int e0 = 0; e0 < a.ppseq && e0 * a.page < len && seen < r1; e0 += 32) {
      int slot, valid;
      const bool res = entry(e0 + lane, slot, valid);
      const unsigned mask = __ballot_sync(0xffffffffu, res);
      const int rank = seen + __popc(mask & ((1u << lane) - 1u));
      if (res && rank >= r0 && rank < r1) {
        s_slot[rank - r0] = slot;
        s_valid[rank - r0] = valid;
      }
      seen += __popc(mask);
    }
    if (lane == 0) s_count = r1 - r0;
  }

  __syncthreads();

  const int upp = a.page / kUnit;  // units a page
  const int n_units = s_count * upp;
  const T* kbase = static_cast<const T*>(a.k) + h * a.k_sh;
  const T* vbase = static_cast<const T*>(a.v) + h * a.v_sh;

  // tokens of unit u that count (<= 0: the unit lies past the length)
  auto unit_tokens = [&](int u) {
    const int j = u / upp;
    return min(kUnit, s_valid[j] - (u - j * upp) * kUnit);
  };
  auto next_unit = [&](int u) {
    while (u < n_units && unit_tokens(u) <= 0) u += W;
    return u;
  };
  // one commit group a call, empty when u is past the last unit
  auto load_unit = [&](int u, int stage) {
    if (u < n_units) {
      const int j = u / upp;
      const int t0 = (u - j * upp) * kUnit;
      const int valid = s_valid[j] - t0;
      const long long slot = s_slot[j];
      const T* kp = kbase + slot * a.k_sp + t0 * a.k_st;
      const T* vp = vbase + slot * a.v_sp + t0 * a.v_st;
      T* kt = ring + stage * 2 * kTile;
      T* vt = kt + kTile;
#pragma unroll
      for (int i = lane; i < kUnit * kCpr; i += 32) {
        const int t = i / kCpr, col = (i - t * kCpr) * kVec;
        const bool ok = t < valid;
        const int ts = ok ? t : 0;
        cp_async16(kt + t * kLd + col, kp + ts * a.k_st + col, ok);
        cp_async16(vt + t * kLd + col, vp + ts * a.v_st + col, ok);
      }
    }
    cp_async_commit();
  };

  float o[kNd][4];
#pragma unroll
  for (int nd = 0; nd < kNd; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  float m0 = neg_inf, m1 = neg_inf;  // running max of rows r, r + 8 (log2 domain)
  float l0 = 0.0f, l1 = 0.0f;        // this thread's part of their sums
  const float qk_scale = a.scale * kLog2e;

  // the warp's units are u_0 = next_unit(warp), u_i+1 = next_unit(u_i + W);
  // unit u_i sits in stage i % S and is loaded S - 1 units ahead
  int u = next_unit(warp);
  int ahead = u;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    load_unit(ahead, st);
    if (ahead < n_units) ahead = next_unit(ahead + W);
  }
  int stage = 0;
  while (u < n_units) {
    load_unit(ahead, (stage + S - 1) % S);
    if (ahead < n_units) ahead = next_unit(ahead + W);
    cp_async_wait<S - 1>();  // the group of unit u has landed
    __syncwarp();
    const T* kt = ring + stage * 2 * kTile;
    const T* vt = kt + kTile;
    const int valid = unit_tokens(u);

    // S = Q K^T: two n8 tiles (tokens 0-7, 8-15) of the unit
    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    {
      const int mi = lane >> 3;
      const T* kr = kt + ((mi >> 1) * 8 + (lane & 7)) * kLd + (mi & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kr + ks * 16);
        mma16816<T>(sc[0], qa[ks], kb[0], kb[1]);
        mma16816<T>(sc[1], qa[ks], kb[2], kb[3]);
      }
    }
    // scale (and cap) into the log2 domain, mask tokens past the length
    float mx0 = neg_inf, mx1 = neg_inf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = nt * 8 + c + (i & 1);
        float x = sc[nt][i];
        if (a.cap > 0.0f) {
          x = a.cap * tanhf(x * a.scale / a.cap) * kLog2e;
        } else {
          x *= qk_scale;
        }
        sc[nt][i] = t < valid ? x : neg_inf;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    // token 0 of a unit is always valid, so the new maxima are finite
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);  // 0 at the first unit
    m0 = mn0;
    m1 = mn1;
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      p[nt][0] = ex2(sc[nt][0] - mn0);
      p[nt][1] = ex2(sc[nt][1] - mn0);
      p[nt][2] = ex2(sc[nt][2] - mn1);
      p[nt][3] = ex2(sc[nt][3] - mn1);
    }
    l0 = l0 * corr0 + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);
    l1 = l1 * corr1 + (p[0][2] + p[0][3] + p[1][2] + p[1][3]);
    // P as the A fragment of one k16 step: S's C layout, two n8 tiles
    const uint32_t pa[4] = {pack2<T>(p[0][0], p[0][1]), pack2<T>(p[0][2], p[0][3]),
                            pack2<T>(p[1][0], p[1][1]), pack2<T>(p[1][2], p[1][3])};
    {
      const int mi = lane >> 3;
      const T* vr = vt + ((mi & 1) * 8 + (lane & 7)) * kLd + (mi >> 1) * 8;
#pragma unroll
      for (int nd = 0; nd < kNd; nd += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + nd * 8);
        o[nd][0] *= corr0;
        o[nd][1] *= corr0;
        o[nd][2] *= corr1;
        o[nd][3] *= corr1;
        o[nd + 1][0] *= corr0;
        o[nd + 1][1] *= corr0;
        o[nd + 1][2] *= corr1;
        o[nd + 1][3] *= corr1;
        mma16816<T>(o[nd], pa, vb[0], vb[1]);
        mma16816<T>(o[nd + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();  // every lane is done with this stage before it refills
    stage = (stage + 1) % S;
    u = next_unit(u + W);
  }
  cp_async_wait<0>();  // no copy may land in the merge area below
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // merge the warps' (m, l, acc) in warp order
  __syncthreads();  // every ring is drained: the merge reuses its memory
  float* s_acc = reinterpret_cast<float*>(smem_raw);  // (W, 16, D)
  float* s_m = s_acc + W * kRows * D;                 // (W, 16)
  float* s_l = s_m + W * kRows;
  {
    float* w_acc = s_acc + warp * kRows * D;
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) {
      *reinterpret_cast<float2*>(w_acc + r * D + nd * 8 + c) = make_float2(o[nd][0], o[nd][1]);
      *reinterpret_cast<float2*>(w_acc + (r + 8) * D + nd * 8 + c) =
          make_float2(o[nd][2], o[nd][3]);
    }
    if ((lane & 3) == 0) {
      s_m[warp * kRows + r] = m0;
      s_m[warp * kRows + r + 8] = m1;
      s_l[warp * kRows + r] = l0;
      s_l[warp * kRows + r + 8] = l1;
    }
  }
  __syncthreads();
  const long long row0 = static_cast<long long>(b) * a.H + h * a.G + g0;
  for (int i = threadIdx.x; i < rows * D; i += kSplitThreads) {
    const int row = i / D, d = i - row * D;
    float mx = neg_inf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, s_m[w * kRows + row]);
    float l = 0.0f, acc = 0.0f;
    if (mx != neg_inf) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float f = ex2(s_m[w * kRows + row] - mx);  // 0 for a warp with no unit
        l += s_l[w * kRows + row] * f;
        acc += s_acc[(w * kRows + row) * D + d] * f;
      }
    }
    if (a.splits == 1) {
      static_cast<T*>(a.out)[(row0 + row) * D + d] = from_f32<T>(l > 0.0f ? acc / l : 0.0f);
    } else {
      const long long part = (row0 + row) * a.splits + split;
      if (d == 0) {
        a.m_part[part] = mx;
        a.l_part[part] = l;
      }
      if (l > 0.0f) a.acc_part[part * D + d] = acc;
    }
  }
}

// One warp per query row (b, h), four rows a block: merges the splits'
// partials in split order.  A split with l = 0 saw no position and left
// its acc unwritten.  Lane L holds columns L * D / 32 ... of the row.
template <typename T, int D>
__global__ void __launch_bounds__(128)
paged_attention_combine_kernel(const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               const float* __restrict__ acc_part, T* __restrict__ out,
                               int rows, int splits) {
  constexpr int kPer = D / 32;  // columns a lane
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* m = m_part + row * splits;
  const float* l = l_part + row * splits;
  float mx = neg_inf;
  for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, m[s]);
  mx = warp_max(mx);
  float lsum = 0.0f, acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const int s = s0 + lane;
    const float ms = s < splits ? m[s] : neg_inf;
    const float ls = s < splits ? l[s] : 0.0f;
    const int n = min(32, splits - s0);
    for (int i = 0; i < n; ++i) {
      const float li = __shfl_sync(0xffffffffu, ls, i);
      const float mi = __shfl_sync(0xffffffffu, ms, i);
      if (li > 0.0f) {
        const float f = ex2(mi - mx);
        lsum += li * f;
        const float* src = acc_part + ((row * splits) + s0 + i) * D + lane * kPer;
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[j] += src[j] * f;
      }
    }
  }
  T* dst = out + row * D + lane * kPer;
#pragma unroll
  for (int j = 0; j < kPer; ++j) dst[j] = from_f32<T>(lsum > 0.0f ? acc[j] / lsum : 0.0f);
}

template <typename T, int D>
int launch_split(const SplitArgs& a, int B, cudaStream_t stream) {
  auto kernel = paged_attention_split_kernel<T, D>;
  constexpr int smem = split_smem_bytes<T, D>();
  static bool opted_in = false;  // the attribute holds for the process
  cudaError_t err;
  if (!opted_in) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int m_tiles = (a.G + kRows - 1) / kRows;
  dim3 grid(a.splits, a.KV * m_tiles, B);
  kernel<<<grid, kSplitThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const int rows = B * a.H;
  paged_attention_combine_kernel<T, D><<<(rows + 3) / 4, 128, 0, stream>>>(
      a.m_part, a.l_part, a.acc_part, static_cast<T*>(a.out), rows, a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split_d(const SplitArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_split<T, 64>(a, B, stream);
    case 128:
      return launch_split<T, 128>(a, B, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Strides are in elements:
// (page, token, head) of the (P, page, KV, D) pools; D is contiguous.
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* out, int dtype, int B, int KV, int G, int D,
    int page, int ppseq, int n_pages, long long k_sp, long long k_st,
    long long k_sh, long long v_sp, long long v_st, long long v_sh, float scale,
    float cap, long long smem_bytes, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  const long long ks[3] = {k_sp, k_st, k_sh};
  const long long vs[3] = {v_sp, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, table, lengths, out, B, KV, G, D, page, ppseq,
                           n_pages, ks, vs, scale, cap, smem, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, table, lengths, out, B, KV, G, D, page,
                                   ppseq, n_pages, ks, vs, scale, cap, smem, st);
    case 2:
      return launch<__half>(q, k, v, table, lengths, out, B, KV, G, D, page, ppseq,
                            n_pages, ks, vs, scale, cap, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The split kernel (dtype 1 = bfloat16, 2 = float16; D = 64 or 128; page a
// multiple of 16; splits >= ceil(ppseq / 32)).  With splits > 1, m_part
// and l_part hold B * H * splits floats and acc_part B * H * splits * D;
// with one split they are not touched (may be null).
extern "C" int paged_attention_split_launch(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* out, void* m_part, void* l_part, void* acc_part,
    int dtype, int B, int KV, int G, int D, int page, int ppseq, int n_pages,
    int splits, long long k_sp, long long k_st, long long k_sh,
    long long v_sp, long long v_st, long long v_sh, float scale, float cap,
    void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  if (page % kUnit != 0 || splits < 1 ||
      static_cast<long long>(splits) * kMaxShare < ppseq)
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.table = static_cast<const int*>(table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.m_part = static_cast<float*>(m_part);
  a.l_part = static_cast<float*>(l_part);
  a.acc_part = static_cast<float*>(acc_part);
  a.H = KV * G;
  a.KV = KV;
  a.G = G;
  a.page = page;
  a.ppseq = ppseq;
  a.n_pages = n_pages;
  a.splits = splits;
  a.k_sp = k_sp;
  a.k_st = k_st;
  a.k_sh = k_sh;
  a.v_sp = v_sp;
  a.v_st = v_st;
  a.v_sh = v_sh;
  a.scale = scale;
  a.cap = cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_split_d<__nv_bfloat16>(a, B, D, st);
    case 2:
      return launch_split_d<__half>(a, B, D, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
