// One-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention, body _kernel): for every sequence b and query head h,
//   out[b, h] = softmax_t(cap(q[b, h] . k[t] / sqrt(D))) . v[t]
// over the positions t < lengths[b] whose page (block_table[b, t / page])
// is resident (>= 0), with K/V head h / G (G = H / KV query heads share one
// KV head), scores and softmax in float32, output in q's dtype.  A row with
// no such position gives zeros.  cap(s) = c * tanh(s / c) when the softcap
// c > 0, else s.
//
// Design.  One block of 256 threads per (KV head, sequence), grid (KV, B).
// The block keeps its G query rows (pre-scaled by 1/sqrt(D)) in shared
// memory as float32, and the G x D accumulator in registers (G * D / 256
// values a thread) with the row max m and sum l in shared memory.  It walks
// the sequence's block table in order, skips pages whose entry is < 0 (or
// >= P) and stops at the first page that starts at or past the length.  For
// each page it stages that KV head's K and V rows (page x D, q's dtype) in
// shared memory with 16-byte loads, then
//   1. scores: one (query row, position) dot product a thread, reading K
//      rows as 16-byte vectors; rows are padded by 16 bytes so the eight
//      lanes of a quarter warp hit distinct banks;
//   2. online softmax: one warp per query row takes the page's max, the
//      correction exp(m_old - m_new) and the exponentials, and updates l;
//   3. accumulate: acc = acc * correction + p . V.
// Pools are read through their strides (page, token, head; the last dim
// must be contiguous), so a layer view of a multi-layer pool needs no copy.
//
// What bounds it on the card.  Bytes: the resident K and V rows of the
// attended positions are each read once (plus q and the output); at the
// serving shape (64 sequences, at most 256 resident pages of 64 tokens x
// 2 KV heads x 128 x bf16) that is at most 16.8 MB, about 5 us at
// 3.35 TB/s.  Per page it does 2 x G x page x D flops against
// 2 x page x D x 2 bytes, about 16 flops a byte at G = 16: far below the
// card's compute ridge, so the tensor cores are not needed.  A block walks
// its pages one after another with barriers in between, so this simple
// kernel is latency-bound; splitting a sequence's pages over several
// blocks (split-K decoding) is later work.
//
// C interface: paged_attention_launch(...) launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

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
