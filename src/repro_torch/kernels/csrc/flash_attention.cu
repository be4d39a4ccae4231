// Tiled online-softmax GQA attention (prefill), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel): for every batch row b, query position s
// and query head h, with KV head h / G (G = H / KV query heads share one KV
// head),
//   out[b, s, h] = softmax_t(cap(q[b, s, h] . k[b, t, h / G] / sqrt(D)))
//                  . v[b, t, h / G]
// over the keys t that the query sees: t < T, t <= s when causal, and
// t > s - window when window > 0 (causal or not).  cap(x) = c * tanh(x / c)
// when the softcap c > 0, else x; it comes before the mask.  Scores and the
// softmax are float32, the output has q's dtype, and a row that sees no key
// gives zeros (out = acc / max(l, 1e-30)), as in the TPU kernel.
//
// Design.  The TPU grid (B * KV, q blocks, kv blocks) runs its kv axis in
// order and carries the softmax state (m, l, acc) in VMEM from one kv step
// to the next.  Blocks on the card run in no order, so here one block owns a
// tile of query rows of one query head and walks the key tiles itself, in a
// loop that starts at the window's first tile and ends at the causal limit:
// tiles the mask empties entirely are skipped (the TPU kernel masks them;
// they change nothing, so the result is the same).  Tiles that lie wholly
// inside the mask skip the mask arithmetic.  Heavy causal tiles (the last
// query rows) are scheduled first.  q, k and v are read in the reference's
// layout, q (B, S, H, D) and k/v (B, T, KV, D), through their strides (the
// last dim contiguous), so there is no transpose copy; the output is a new
// contiguous (B, S, H, D).
//
// GQA: each query head has its own block, and the G blocks of one KV head
// read the same K/V tiles, mostly from the 50 MB L2 (at the main shape K
// and V are 4.2 MB each).  Sharing a tile across the group inside one block
// would cut those L2 reads but multiply the block's accumulator by G; that
// is later work.
//
// bfloat16 (the serving path): 4 warps, 64 query rows a block, 16 a warp;
// key tiles of 64.  Q, K and V tiles sit in shared memory (rows padded by
// 16 bytes, so the fragment reads below hit distinct banks; D is padded
// with zeros to the product depth 16).  S = Q K^T and O += P V run on the
// tensor cores as mma.sync m16n8k16 with bf16 inputs and float32
// accumulation; the online softmax runs in registers on the S fragments,
// and P is rounded to bf16 only as the input of P V (l sums the float32
// p).  The scale is applied to the float32 product q . k instead of to q:
// scaling q first would round q * scale to bf16 for the tensor cores,
// while scaling the exact-product sum differs from the reference's f32
// (q * scale) . k only by float32 rounding.  The accumulator is 16 x D a
// warp in registers (D / 2 floats a thread, 128 at D = 256): the kernel is
// compiled for D <= 64, <= 128 and <= 256.
//
// float32: tensor cores would round the inputs (TF32 keeps 10 bits), so
// float32 runs on the FMA units: 4 warps, 32 query rows a block, key tiles
// of 32; scores one (row, key) dot product a thread with the row's scaled q
// in shared memory, the softmax one warp per row, the accumulator (32 x D a
// block) in registers.
//
// What bounds it on the card.  Operations: 4 * D flops for every (query,
// key) pair the mask keeps, times B * H; at the serving shape (B 4, S = T =
// 2048, H 32, KV 2, D 128, causal) that is 1.375e11 flops, 0.139 ms at
// 989 TFLOP/s bf16, against 142.6 MB of q, k, v and out (0.043 ms at
// 3.35 TB/s).  This first kernel issues mma.sync with synchronous tile
// loads and two barriers a tile, so it reaches only part of the tensor-core
// rate; wgmma, TMA and a pipelined producer warp are later work.
//
// C interface: flash_attention_launch(...) launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: m's start
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16
// ---------------------------------------------------------------------------
constexpr int kBM = 64;  // query rows a block (16 a warp)
constexpr int kBN = 64;  // keys a tile
constexpr int kNT = kBN / 8;  // 8-key column tiles of S

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + rows) of a (rows_total, D) matrix with row stride `stride`
// (elements) into shared memory with row stride ld, zero-filling rows past
// rows_total and columns D..Dk-1.  D is a multiple of 8 (16-byte vectors).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride,
                                          int r0, int rows, int rows_total, int D,
                                          int Dk, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = Dk / kVec;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i - r * vpr) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows_total && c < D)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, T, H, G, D;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale, cap;
  int causal, window;
};

// The key-tile range [lo, hi) a block of query rows [q0, q0 + rows) must
// visit: tiles outside it are masked out for every row.
__device__ __forceinline__ void tile_range(const Args& a, int q0, int rows, int bn,
                                           int* lo, int* hi) {
  int key_hi = a.T;
  if (a.causal) key_hi = min(key_hi, q0 + rows);  // t <= s <= q0 + rows - 1
  int key_lo = 0;
  if (a.window > 0) key_lo = max(0, q0 - a.window + 1);  // t > s - window >= q0 - window
  *lo = key_lo / bn;
  *hi = key_hi > key_lo ? (key_hi + bn - 1) / bn : *lo;
}

// Whether some (row, key) of the tile is masked out: then the tile needs
// the per-element mask.
__device__ __forceinline__ bool tile_needs_mask(const Args& a, int q0, int rows,
                                                int k0, int bn) {
  if (k0 + bn > a.T) return true;
  if (a.causal && k0 + bn - 1 > q0) return true;
  if (a.window > 0 && k0 <= q0 + rows - 1 - a.window) return true;
  return false;
}

__device__ __forceinline__ float score(const Args& a, float s, int qpos, int kpos,
                                       bool need_mask) {
  if (a.cap > 0.0f) s = a.cap * tanhf(s / a.cap);
  if (need_mask) {
    const bool ok = kpos < a.T && (!a.causal || kpos <= qpos) &&
                    (a.window <= 0 || kpos > qpos - a.window);
    // -inf (not kNegInf) so that exp(s - m) is 0 even while m is kNegInf
    if (!ok) s = __int_as_float(static_cast<int>(0xff800000u));
  }
  return s;
}

// NDT: the most 8-wide column tiles of D this instantiation takes.
template <int NDT>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const Args a) {
  using T = __nv_bfloat16;
  // grid (H, B, query tiles): the heavy causal tiles (last rows) of every
  // head start first, and neighbouring blocks share K/V tiles in L2
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / a.G;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kBM;
  const int D = a.D, Dk = (D + 15) & ~15, ld = Dk + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  extern __shared__ uint4 smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kBM * ld;
  T* v_s = k_s + kBN * ld;
  const unsigned short* v16 = reinterpret_cast<const unsigned short*>(v_s);

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile(q_s, qp, a.q_ss, q0, kBM, a.S, D, Dk, ld);

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const T* qa = q_s + (warp * 16 + g) * ld + 2 * t4;  // A fragment base
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  int lo, hi;
  tile_range(a, q0, kBM, kBN, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile(k_s, kp, a.k_st, k0, kBN, a.T, D, Dk, ld);
    load_tile(v_s, vp, a.v_st, k0, kBN, a.T, D, Dk, ld);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    for (int kk = 0; kk < Dk; kk += 16) {
      const uint32_t a0 = lds32(qa + kk), a1 = lds32(qa + 8 * ld + kk);
      const uint32_t a2 = lds32(qa + kk + 8), a3 = lds32(qa + 8 * ld + kk + 8);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const T* kb = k_s + (n * 8 + g) * ld + kk + 2 * t4;
        mma_bf16(s[n], a0, a1, a2, a3, lds32(kb), lds32(kb + 8));
      }
    }

    // scale, softcap, mask; online softmax over the tile in registers
    const bool need_mask = tile_needs_mask(a, q0, kBM, k0, kBN);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int kpos = k0 + n * 8 + 2 * t4;
      s[n][0] = score(a, s[n][0] * a.scale, row0, kpos, need_mask);
      s[n][1] = score(a, s[n][1] * a.scale, row0, kpos + 1, need_mask);
      s[n][2] = score(a, s[n][2] * a.scale, row1, kpos, need_mask);
      s[n][3] = score(a, s[n][3] * a.scale, row1, kpos + 1, need_mask);
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // the 4 lanes of a quad hold one row's 64 keys
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      s[n][0] = expf(s[n][0] - mx0);
      s[n][1] = expf(s[n][1] - mx0);
      s[n][2] = expf(s[n][2] - mx1);
      s[n][3] = expf(s[n][3] - mx1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // O += P V: P from the S fragments (bf16), V fragments from shared rows
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      const uint32_t a0 = pack_bf16(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack_bf16(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const unsigned short* vr = v16 + (j * 16 + 2 * t4) * ld + g;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        if (n * 8 < D) {
          const unsigned short* vc = vr + n * 8;
          const uint32_t b0 = vc[0] | (static_cast<uint32_t>(vc[ld]) << 16);
          const uint32_t b1 =
              vc[8 * ld] | (static_cast<uint32_t>(vc[9 * ld]) << 16);
          mma_bf16(o[n], a0, a1, a2, a3, b0, b1);
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), rows past S not written
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  T* ob = static_cast<T*>(a.out);
  const long long o_row = static_cast<long long>(a.H) * D;
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
    if (n * 8 < D) {
      const int d = n * 8 + 2 * t4;
      if (row0 < a.S)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + (static_cast<long long>(b) * a.S + row0) * o_row + h * D + d) =
            __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
      if (row1 < a.S)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + (static_cast<long long>(b) * a.S + row1) * o_row + h * D + d) =
            __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA units
// ---------------------------------------------------------------------------
constexpr int kFM = 32;  // query rows a block (8 a warp)
constexpr int kFN = 32;  // keys a tile (one a lane)
constexpr int kFAcc = kFM * 256 / kThreads;  // accumulators a thread at D = 256

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

__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Args a) {
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / a.G;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kFM;
  const int D = a.D, ldk = D + 1;  // odd K row stride: lanes read distinct banks
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  extern __shared__ uint4 smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // kFM x D, scaled
  float* k_s = q_s + kFM * D;                   // kFN x (D + 1)
  float* v_s = k_s + kFN * ldk;                 // kFN x D
  float* p_s = v_s + kFN * D;                   // kFM x kFN
  float* c_s = p_s + kFM * kFN;                 // kFM corrections
  float* l_s = c_s + kFM;                       // kFM row sums

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  for (int i = threadIdx.x; i < kFM * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    q_s[i] = q0 + r < a.S ? qp[(q0 + r) * a.q_ss + d] * a.scale : 0.0f;
  }
  // warp w owns rows w, w + 4, ..., w + 28; lane = key within the tile
  float m[kFM / kWarps], l[kFM / kWarps];
#pragma unroll
  for (int j = 0; j < kFM / kWarps; ++j) {
    m[j] = kNegInf;
    l[j] = 0.0f;
  }
  float acc[kFAcc];
#pragma unroll
  for (int r = 0; r < kFAcc; ++r) acc[r] = 0.0f;

  int lo, hi;
  tile_range(a, q0, kFM, kFN, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kFN;
    __syncthreads();
    for (int i = threadIdx.x; i < kFN * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < a.T;
      k_s[r * ldk + d] = in ? kp[(k0 + r) * a.k_st + d] : 0.0f;
      v_s[i] = in ? vp[(k0 + r) * a.v_st + d] : 0.0f;
    }
    __syncthreads();
    const bool need_mask = tile_needs_mask(a, q0, kFM, k0, kFN);
#pragma unroll
    for (int j = 0; j < kFM / kWarps; ++j) {
      const int r = warp + j * kWarps;
      const float* qr = q_s + r * D;
      const float* kr = k_s + lane * ldk;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s = score(a, s, q0 + r, k0 + lane, need_mask);
      const float mx = fmaxf(m[j], warp_max(s));
      const float p = expf(s - mx);
      const float c = expf(m[j] - mx);
      l[j] = l[j] * c + warp_sum(p);
      m[j] = mx;
      p_s[r * kFN + lane] = p;
      if (lane == 0) c_s[r] = c;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFAcc; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < kFM * D) {
        const int r = idx / D, d = idx - r * D;
        const float* pr = p_s + r * kFN;
        float x = acc[i] * c_s[r];
        for (int t = 0; t < kFN; ++t) x = fmaf(pr[t], v_s[t * D + d], x);
        acc[i] = x;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kFM / kWarps; ++j) l_s[warp + j * kWarps] = l[j];
  }
  __syncthreads();
  float* ob = static_cast<float*>(a.out);
  const long long o_row = static_cast<long long>(a.H) * D;
#pragma unroll
  for (int i = 0; i < kFAcc; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < kFM * D) {
      const int r = idx / D, d = idx - r * D;
      if (q0 + r < a.S)
        ob[(static_cast<long long>(b) * a.S + q0 + r) * o_row + h * D + d] =
            acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <typename K>
int launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream, const Args& a) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory a block needs (bytes): at D = 256, 101,376 (bf16) and
// 102,784 (float32), within the 227 KB a block may use.
size_t smem_bytes(int dtype, int D) {
  if (dtype == 1) {
    const int ld = ((D + 15) & ~15) + 8;
    return static_cast<size_t>(kBM + 2 * kBN) * ld * 2;
  }
  return 4 * static_cast<size_t>(kFM * D + kFN * (D + 1) + kFN * D + kFM * kFN +
                                 2 * kFM);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements: (batch, position,
// head) of q (B, S, H, D) and k/v (B, T, KV, D); the last dim is contiguous.
// out is a contiguous (B, S, H, D).  D is a multiple of 8, at most 256.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int S, int T, int H, int KV, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale, float cap,
    int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0) return static_cast<int>(cudaGetLastError());
  Args a{q, k, v, out, S, T, H, H / KV, D, q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
         v_sb, v_st, v_sh, scale, cap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(dtype, D);
  if (dtype == 1) {
    dim3 grid(H, B, (S + kBM - 1) / kBM);
    if (D <= 64) return launch(flash_bf16_kernel<8>, grid, smem, st, a);
    if (D <= 128) return launch(flash_bf16_kernel<16>, grid, smem, st, a);
    return launch(flash_bf16_kernel<32>, grid, smem, st, a);
  }
  if (dtype == 0) {
    dim3 grid(H, B, (S + kFM - 1) / kFM);
    return launch(flash_f32_kernel, grid, smem, st, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
