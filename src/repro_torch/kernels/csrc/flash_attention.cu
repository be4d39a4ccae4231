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
// Three kernels compute it; the wrapper's variant(dtype, D) picks one:
//   wgmma  bfloat16 at D = 64, 120, 128 or 256 (the LM prefill paths): a
//          TMA ring and warp-specialised wgmma;
//   mma    bfloat16 at any other D (16, 112, ...): mma.sync m16n8k16,
//          compiled for every D up to 256;
//   fma    float32: the FMA units.
//
// Common design.  The TPU grid (B * KV, q blocks, kv blocks) runs its kv
// axis in order and carries the softmax state (m, l, acc) in VMEM from one
// kv step to the next.  Blocks on the card run in no order, so here one
// block owns a tile of query rows of one query head and walks the key tiles
// itself, in a loop that starts at the window's first tile and ends at the
// causal limit: tiles the mask empties entirely are skipped (the TPU kernel
// masks them; they change nothing, so the result is the same).  Tiles that
// lie wholly inside the mask skip the mask arithmetic.  The grid is (H, B,
// query tiles): heavy causal tiles (the last query rows) are scheduled
// first, and the G heads of one KV group are neighbouring blocks, so their
// K/V tiles are read from the 50 MB L2 (at the main shape K and V are 4.2
// MB each).  q, k and v are read in the reference's layout, q (B, S, H, D)
// and k/v (B, T, KV, D), through their strides (the last dim contiguous),
// so there is no transpose copy; the output is a new contiguous
// (B, S, H, D).  The scale is applied to the float32 product q . k, not to
// q: scaling q first would round q * scale to bf16 for the tensor cores.
// (The mma and fma kernels put one block on each query tile; the wgmma
// kernel walks the same tiles, in the same order, from persistent blocks.)
//
// wgmma (bfloat16, D = 64, 120, 128 or 256).  The grid is persistent: one
// block an SM (its shared memory allows no more), each walking a share of
// the work items, an item being 128 query rows of one head (heaviest
// first, the G heads of a KV group neighbours; a block that finishes early
// takes the heaviest item left, from a counter in device memory).  A block
// has three warpgroups (384 threads).  Warpgroup 0 is the producer: it
// gives registers away (setmaxnreg 40) and one of its threads issues every
// TMA load, item after item: Q into one of two buffers, then K and V in
// tiles of 128 keys into a ring of 2 stages (D = 256 differs: see below).
// Each stage has a K-full, a V-full, a K-empty and a V-empty mbarrier: K
// of a tile is given back once S is computed, V one step later, after P V.
// So the next item's Q and first tiles load while this item's last tiles
// run.  Warpgroups 1 and 2 are consumers (setmaxnreg 232), 64 query rows
// of the item each.  S = Q K^T is wgmma m64n128k16 with both operands in
// shared memory (K-major);
// O += P V is wgmma with P (rounded to bf16) in registers and V from
// shared memory as an MN-major operand (the transpose bit), so V stays in
// the (keys, D) layout it was read in.  A consumer issues S of tile i and
// P V of tile i - 1 back to back, waits for S alone, and runs the softmax
// of tile i while that P V runs on the tensor cores (S, P, O and the row
// state take about 200 registers, which setmaxnreg provides).  The maps
// are 4-D over the public layouts, (D, H, S, B) for q and out and
// (D, KV, T, B) for k and v, encoded on the host from the byte strides; a
// row of D = 128 bf16 is wider than the 128-byte swizzle span, so every
// tile is loaded as boxes of 64 columns.  TMA fills rows past S or T with
// zeros.  The softmax works in log2 units: p = 2^(s * scale * log2(e) -
// m * scale * log2(e)), one FFMA and one ex2 an element; O is rescaled only
// when some row of the warp has a new maximum; l sums each thread's
// float32 p and is reduced across the 4 lanes of a row once, at the end.
// P is rounded to bf16 only as the input of P V.  The output goes through
// shared memory (swizzled as the out map is) and leaves by a TMA store
// that runs on while the next item starts, rows past S not written.
// Shared memory at D = 128: Q 2 x 32 KB + 2 x (32 + 32) KB + out 32 KB.
//
// wgmma at D = 256 (recurrentgemma-2b's local attention, gemma2-9b's
// heads).  The D = 128 plan would need 448 KB of shared memory (Q 2 x 64
// KB, K and V 2 x 2 x 64 KB, out 64 KB) against the 227 KB a block may use,
// and 224 floats of O, S and P a consumer thread (128 + 64 + 32) against
// setmaxnreg's 232 registers.  So the tile plan is a per-D trait (WgPlan),
// and at D = 256 it is: key tiles of 64, so S is m64n64k16 (32 float
// accumulators a thread, 16 registers of bf16 P) and P V is m64n256k16
// with P from registers (128 accumulators, the widest N wgmma takes):
// 176 registers of O, S and P under setmaxnreg 240 (the producer keeps
// 24: 24 * 128 + 240 * 256 = 64,512 of the SM's 65,536; ptxas reports
// 24 bytes of spill stores at 232 and 4 at 240); one Q buffer, 128
// rows x 512 B = 64 KB; a K/V ring of 2 stages x (32 + 32) KB; and no
// output tile of its own: each consumer stages its output through its own
// 64 rows of the Q buffer after its last S, and the next item's Q loads
// into the buffer only once both consumers' TMA stores have read it
// (tma_store_wait_read before the Q-empty arrival).  192 KB and the
// barriers.  A window of 2,048 and the causal diagonal fall on the 64-key
// tile edges; Q and every K/V tile are 4 boxes a row.
//
// wgmma at D = 120 (h2o-danube-3-4b's heads) runs the D = 128 plan, with
// the tensor maps' inner dim and the output's row stride at the real 120.
// A row is two boxes of 64 columns; TMA fills the second box's columns
// 120..127, past the map, with zeros, and still counts the whole box
// toward the mbarrier's transaction bytes (as it does for rows past S or
// T), so the expected-tx counts stay the full tiles'.  Q and K then carry
// zero columns, so S = Q K^T is exact; V's zero columns give zero output
// columns, which the TMA store clips.  The host's scale is 1 / sqrt(120).
//
// mma (bfloat16, other D): 4 warps, 64 query rows a block, 16 a warp; key
// tiles of 64.  Q, K and V tiles sit in shared memory (rows padded by 16
// bytes, so the fragment reads below hit distinct banks; D is padded with
// zeros to the product depth 16), loaded synchronously between two
// barriers.  S = Q K^T and O += P V run as mma.sync m16n8k16 with bf16
// inputs and float32 accumulation; the online softmax runs in registers on
// the S fragments, and P is rounded to bf16 only as the input of P V (l sums
// the float32 p).  The accumulator is 16 x D a warp in registers (D / 2
// floats a thread, 128 at D = 256): the kernel is compiled for D <= 64,
// <= 128 and <= 256.  Each query head has its own block.
//
// fma (float32): tensor cores would round the inputs (TF32 keeps 10 bits),
// so float32 runs on the FMA units: 4 warps, 32 query rows a block, key
// tiles of 32; scores one (row, key) dot product a thread with the row's
// scaled q in shared memory, the softmax one warp per row, the accumulator
// (32 x D a block) in registers.
//
// What bounds it on the card.  Operations: 4 * D flops for every (query,
// key) pair the mask keeps, times B * H; at the serving shape (B 4, S = T =
// 2048, H 32, KV 2, D 128, causal) that is 1.375e11 flops, 0.139 ms at
// 989 TFLOP/s bf16, against 142.6 MB of q, k, v and out (0.043 ms at
// 3.35 TB/s); at recurrentgemma-2b's (B 2, S = T = 4096, H 10, KV 1,
// D 256, causal, window 2,048) 1.289e11 flops, 0.130 ms, against 92.3 MB
// (0.028 ms).  The softmax between the two products is what the wgmma
// kernel has not hidden (PERF.md has the measurements).
//
// C interface: flash_attention_launch(...) launches on the given stream,
// allocates nothing, and returns 0 or a CUDA error (negative: a tensor map
// could not be encoded).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: m's start
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

// Whether query position qpos sees key position kpos.
__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  return kpos < a.T && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// -inf (not kNegInf) so that exp(s - m) is 0 even while m is kNegInf
__device__ __forceinline__ float masked() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

__device__ __forceinline__ float score(const Args& a, float s, int qpos, int kpos,
                                       bool need_mask) {
  if (a.cap > 0.0f) s = a.cap * tanhf(s / a.cap);
  if (need_mask && !visible(a, qpos, kpos)) s = masked();
  return s;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// NDT: the most 8-wide column tiles of D this instantiation takes.
template <int NDT>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const Args a) {
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
// bfloat16 at D = 64, 120, 128 or 256: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------
constexpr int kWgRows = 64;                      // query rows a consumer
constexpr int kWgConsumers = 2;                  // consumer warpgroups
constexpr int kWgBM = kWgRows * kWgConsumers;    // query rows a work item
constexpr int kWgThreads = 128 * (1 + kWgConsumers);
constexpr int kBoxCols = 64;    // bf16 columns a box: the 128-byte swizzle span
constexpr int kRowBytes = 128;  // bytes a box row
constexpr float kLog2e = 1.4426950408889634f;

// The tile plan at head dim D, and the shared memory of one block in bytes
// from a 1,024-byte aligned base: every tile is D / 64 boxes of (rows x 128
// bytes).  At D = 64 and 128: key tiles of 128, two Q buffers (the next work
// item's Q loads while this one runs) and an output tile of its own.  At
// D = 256 that plan would take 448 KB, so: key tiles of 64, one Q buffer,
// and the output staged through each consumer's own rows of the Q buffer
// once its last S has run (the next item's Q then loads after the output's
// TMA store has read it).
template <int D>
struct WgPlan {
  static constexpr bool kOutInQ = D > 128;           // the output in Q's rows
  static constexpr int kBN = kOutInQ ? 64 : 128;     // keys a tile
  static constexpr int kStages = 2;                  // K/V ring depth
  static constexpr int kQBufs = kOutInQ ? 1 : 2;     // Q buffers
  // setmaxnreg's registers a producer and a consumer thread: 128 p + 256 c
  // = 64,512 = 168 * 384 (at D = 256 ptxas spills 4 bytes at 240, 24 at
  // 232)
  static constexpr int kProducerRegs = kOutInQ ? 24 : 40;
  static constexpr int kConsumerRegs = kOutInQ ? 240 : 232;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kQBox = kWgBM * kRowBytes;
  static constexpr int kKBox = kBN * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKBytes = kBoxes * kKBox;
  static constexpr int q = 0;                            // kQBufs Q tiles
  static constexpr int k = q + kQBufs * kQBytes;         // kStages K tiles
  static constexpr int v = k + kStages * kKBytes;        // kStages V tiles
  static constexpr int o = kOutInQ ? q : v + kStages * kKBytes;  // the output
  static constexpr int bars = v + kStages * kKBytes + (kOutInQ ? 0 : kQBytes);
  static constexpr int items = bars + 8 * (2 * kQBufs + 4 * kStages);  // ints
  static constexpr int bytes = items + 8;
};

// The work items (query tile, batch row, head) of one launch, heaviest
// first: item w is query tile n_qt - 1 - w / (B * H), batch row
// (w % (B * H)) / H and head w % H, so the G heads of a KV group are
// neighbours and share K/V tiles in L2.  Block c starts with item c and
// then takes the next item not yet taken from a counter in device memory
// (zero at launch), so a block that finishes early takes the heaviest
// item left.

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

// Accumulator layout of wgmma m64nN (f32), per warpgroup: warp w holds rows
// 16w .. 16w + 15; lane (g = lane / 4, t = lane % 4) holds, for every
// 8-column group j, d[4j], d[4j + 1] at row g, columns 8j + 2t, 8j + 2t + 1
// and d[4j + 2], d[4j + 3] at row g + 8.  The A fragment of a k16 step
// from registers is the same layout over 16 columns, so P's fragments are
// S's accumulators packed to bf16 pairs.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, const Args a, int B,
                   int* next_item) {
  using L = WgPlan<D>;
  constexpr int kSteps = D / 16;       // k16 steps of S = Q K^T
  constexpr int kPSteps = L::kBN / 16;  // k16 steps of O += P V
  constexpr int kSAcc = L::kBN / 2;     // S accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* q_empty = q_full + L::kQBufs;
  uint64_t* k_full = q_empty + L::kQBufs;
  uint64_t* v_full = k_full + L::kStages;
  uint64_t* k_empty = v_full + L::kStages;
  uint64_t* v_empty = k_empty + L::kStages;
  // the item whose Q is in each Q buffer, written before its Q load;
  // n_items or more when no item is left
  volatile int* item_of_q = reinterpret_cast<volatile int*>(sm + L::items);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kQBufs; ++s) {
      sm90::mbar_init(q_full + s, 1);
      sm90::mbar_init(q_empty + s, kWgConsumers * 128);
    }
    for (int s = 0; s < L::kStages; ++s) {
      sm90::mbar_init(k_full + s, 1);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(k_empty + s, kWgConsumers * 128);
      sm90::mbar_init(v_empty + s, kWgConsumers * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int n_qt = (a.S + kWgBM - 1) / kWgBM;
  const int n_items = n_qt * B * a.H;

  // the warpgroup, broadcast from lane 0 so the role branch below is
  // warp-uniform to the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread keeps Q and the K/V ring full, item after item.
    // K and V have their own empty barriers: K of a tile is free once S is
    // computed, V only after P V, one tile later.
    sm90::setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch(&tq);
      sm90::tma_prefetch(&tk);
      sm90::tma_prefetch(&tv);
      int it = 0;  // K/V tiles loaded so far
      int w = blockIdx.x;
      for (int n = 0;; ++n) {
        // item n's Q buffer; the buffer's n / kQBufs-th use sets the parity
        const int qb = n & (L::kQBufs - 1);
        sm90::mbar_wait(q_empty + qb, ((n >> (L::kQBufs - 1)) & 1) ^ 1);
        item_of_q[qb] = w;
        if (w >= n_items) {
          sm90::mbar_arrive(q_full + qb);  // no item left: the consumers stop
          break;
        }
        const int next = gridDim.x + atomicAdd(next_item, 1);
        const int q0 = (n_qt - 1 - w / (B * a.H)) * kWgBM;
        const int b = (w % (B * a.H)) / a.H, h = w % a.H, kvh = h / a.G;
        sm90::mbar_expect_tx(q_full + qb, L::kQBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          sm90::tma_load_4d(sm + L::q + qb * L::kQBytes + c * L::kQBox, &tq,
                            q_full + qb, c * kBoxCols, h, q0, b);
        int lo, hi;
        tile_range(a, q0, kWgBM, L::kBN, &lo, &hi);
        for (int kt = lo; kt < hi; ++kt, ++it) {
          const int s = it % L::kStages;
          const uint32_t free = ((it / L::kStages) & 1) ^ 1;
          sm90::mbar_wait(k_empty + s, free);
          sm90::mbar_expect_tx(k_full + s, L::kKBytes);
          for (int c = 0; c < L::kBoxes; ++c)
            sm90::tma_load_4d(sm + L::k + s * L::kKBytes + c * L::kKBox, &tk,
                              k_full + s, c * kBoxCols, kvh, kt * L::kBN, b);
          sm90::mbar_wait(v_empty + s, free);
          sm90::mbar_expect_tx(v_full + s, L::kKBytes);
          for (int c = 0; c < L::kBoxes; ++c)
            sm90::tma_load_4d(sm + L::v + s * L::kKBytes + c * L::kKBox, &tv,
                              v_full + s, c * kBoxCols, kvh, kt * L::kBN, b);
        }
        w = next;
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. q0 + 64 cw + 63
  // of each work item
  sm90::setmaxnreg_inc<L::kConsumerRegs>();
  const int cw = wg - 1;
  const int ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, t4 = lane % 4;
  const bool capped = a.cap > 0.0f;
  const float cap_in = capped ? a.scale / a.cap : 0.0f;
  // scores in log2 units: the softmax scale (or, under a softcap, which
  // applies it first, 1) times log2(e)
  const float mult = (capped ? 1.0f : a.scale) * kLog2e;
  int r0 = 0, row0 = 0, row1 = 0;  // the item's first row; this lane's rows
  uint32_t q_base = 0;             // this warpgroup's rows of the item's Q
  float o[D / 2];
  float m0, m1;                      // row maxima of rows row0, row1
  float l0, l1;                      // this lane's part of the row sums
  float sc[kSAcc];                   // S of the newest tile, then its p
  uint32_t p[kPSteps][4];            // P of the tile whose P V is next
  float c0 = 1.0f, c1 = 1.0f;        // rescale of o before that P V
  const auto phase = [](int i) {
    return static_cast<uint32_t>((i / L::kStages) & 1);
  };
  // S = Q K^T of ring slot i (64 rows x kBN keys), issued, not awaited
  const auto issue_s = [&](int i) {
    const uint32_t k_base =
        sm90::smem_addr(sm + L::k + (i % L::kStages) * L::kKBytes);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 bf16 along the 128-byte row
      const uint64_t dq =
          sm90::desc_sw128(q_base + (kk / 4) * L::kQBox + off, 16, 1024);
      const uint64_t dk =
          sm90::desc_sw128(k_base + (kk / 4) * L::kKBox + off, 16, 1024);
      if constexpr (L::kBN == 128) {
        sm90::wgmma_ss_n128(sc, dq, dk, kk > 0);
      } else {
        sm90::wgmma_ss_n64(sc, dq, dk, kk > 0);
      }
    }
    sm90::wgmma_commit();
  };
  // O += P V of ring slot i: V (kBN keys x D) is MN-major, 8 keys a
  // 1,024-byte group, 64 columns a box; issued, not awaited
  const auto issue_pv = [&](int i) {
    const uint32_t v_base =
        sm90::smem_addr(sm + L::v + (i % L::kStages) * L::kKBytes);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) sm90::fence_operand(o[j]);
#pragma unroll
    for (int j = 0; j < kPSteps; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) sm90::fence_operand(p[j][r]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPSteps; ++j) {
      const uint64_t dv =
          sm90::desc_sw128(v_base + j * 16 * kRowBytes, L::kKBox, 8 * kRowBytes);
      if constexpr (D == 256) {
        sm90::wgmma_rs_n256(o, p[j], dv);
      } else if constexpr (D == 128) {
        sm90::wgmma_rs_n128(o, p[j], dv);
      } else {
        sm90::wgmma_rs_n64(o, p[j], dv);
      }
    }
    sm90::wgmma_commit();
  };
  // softcap, mask and online softmax of sc (keys k0 ..): sc becomes p,
  // m and l move on, and c0, c1 say how o must be rescaled
  const auto softmax = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kSAcc; ++j) sm90::fence_operand(sc[j]);
    if (capped) {
#pragma unroll
      for (int j = 0; j < kSAcc; ++j) sc[j] = a.cap * tanhf(sc[j] * cap_in);
    }
    if (tile_needs_mask(a, r0, kWgRows, k0, L::kBN)) {
#pragma unroll
      for (int j = 0; j < L::kBN / 8; ++j) {
        const int kpos = k0 + 8 * j + 2 * t4;
        if (!visible(a, row0, kpos)) sc[4 * j] = masked();
        if (!visible(a, row0, kpos + 1)) sc[4 * j + 1] = masked();
        if (!visible(a, row1, kpos)) sc[4 * j + 2] = masked();
        if (!visible(a, row1, kpos + 1)) sc[4 * j + 3] = masked();
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < L::kBN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    c0 = ex2((m0 - mx0) * mult);
    c1 = ex2((m1 - mx1) * mult);
    const float b0 = mx0 * mult, b1 = mx1 * mult;
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < L::kBN / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], mult, -b0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], mult, -b0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], mult, -b1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], mult, -b1));
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
  };
  // once the last P V has finished: o *= c (skipped while no row of the
  // warp has a new maximum, c being 1 then), and p (bf16) from sc
  const auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) sm90::fence_operand(o[j]);
    if (__any_sync(0xffffffffu, c0 != 1.0f || c1 != 1.0f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
    }
#pragma unroll
    for (int j = 0; j < kPSteps; ++j) {
      p[j][0] = pack_bf16(sc[8 * j], sc[8 * j + 1]);
      p[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
      p[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
      p[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
    }
  };
  // a tile these rows do not see: wait for it and give it back
  const auto skip = [&](int i) {
    const int s = i % L::kStages;
    sm90::mbar_wait(k_full + s, phase(i));
    sm90::mbar_arrive(k_empty + s);
    sm90::mbar_wait(v_full + s, phase(i));
    sm90::mbar_arrive(v_empty + s);
  };

  uint8_t* o_tile = sm + L::o + cw * kWgRows * kRowBytes;
  const int lr = warp * 16 + g;  // local rows lr and lr + 8 share lr % 8
  int it = 0;  // K/V tiles consumed so far
  for (int n = 0;; ++n) {
    const int qb = n & (L::kQBufs - 1);
    sm90::mbar_wait(q_full + qb, (n >> (L::kQBufs - 1)) & 1);
    const int w = item_of_q[qb];
    if (w >= n_items) break;
    const int q0 = (n_qt - 1 - w / (B * a.H)) * kWgBM;
    const int b = (w % (B * a.H)) / a.H, h = w % a.H;
    r0 = q0 + cw * kWgRows;
    row0 = r0 + warp * 16 + g;
    row1 = row0 + 8;
    q_base = sm90::smem_addr(sm + L::q + qb * L::kQBytes) +
             cw * kWgRows * kRowBytes;
    // the item's tiles [lo, hi); the ones these 64 rows see, [first,
    // last): a window may skip some of the item's first tiles
    int lo, hi, first, last;
    tile_range(a, q0, kWgBM, L::kBN, &lo, &hi);
    tile_range(a, r0, kWgRows, L::kBN, &first, &last);
    first = min(max(first, lo), hi);
    last = max(first, min(last, hi));
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.0f;
    m0 = m1 = kNegInf;
    l0 = l1 = 0.0f;
    const int base = it;  // ring index of the item's first tile
    int i = 0;
    for (; lo + i < first; ++i) skip(base + i);
    if (first < last) {
      // the first tile alone; then tile i's S = Q K^T runs beside tile
      // i - 1's P V, and i's softmax overlaps that P V on the tensor cores
      sm90::mbar_wait(k_full + (base + i) % L::kStages, phase(base + i));
      issue_s(base + i);
      sm90::wgmma_wait<0>();
      sm90::mbar_arrive(k_empty + (base + i) % L::kStages);
      softmax(first * L::kBN);
      rescale_and_pack();
      for (++i; lo + i < last; ++i) {
        const int prev = i - 1;
        sm90::mbar_wait(k_full + (base + i) % L::kStages, phase(base + i));
        issue_s(base + i);
        sm90::mbar_wait(v_full + (base + prev) % L::kStages, phase(base + prev));
        issue_pv(base + prev);
        sm90::wgmma_wait<1>();  // S of tile i is in; P V of i - 1 may run on
        sm90::mbar_arrive(k_empty + (base + i) % L::kStages);
        softmax((lo + i) * L::kBN);
        sm90::wgmma_wait<0>();
        sm90::mbar_arrive(v_empty + (base + prev) % L::kStages);
        rescale_and_pack();
      }
      const int prev = i - 1;
      sm90::mbar_wait(v_full + (base + prev) % L::kStages, phase(base + prev));
      issue_pv(base + prev);
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < D / 2; ++j) sm90::fence_operand(o[j]);
      sm90::mbar_arrive(v_empty + (base + prev) % L::kStages);
    }
    for (; lo + i < hi; ++i) skip(base + i);

    if constexpr (!L::kOutInQ) {
      sm90::mbar_arrive(q_empty + qb);  // the item's Q is no longer read
    }
    it += hi - lo;

    // out = acc / max(l, 1e-30) as bf16, through shared memory (the out
    // map's swizzle: 16-byte chunk c of row r at c ^ (r % 8)) and a TMA
    // store; the previous item's store must have read the tile first
    // (with the output in Q's rows, it has: see below)
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
    if constexpr (!L::kOutInQ) {
      if (ct == 0) sm90::tma_store_wait_read();
    }
    sm90::named_barrier(1 + cw, 128);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint8_t* row = o_tile + (j / 8) * L::kQBox + lr * kRowBytes +
                     (((j % 8) ^ (lr % 8)) << 4) + 4 * t4;
      *reinterpret_cast<__nv_bfloat162*>(row) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * kRowBytes) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1 + cw, 128);
    if (ct == 0 && r0 < a.S) {
      for (int c = 0; c < L::kBoxes; ++c)
        sm90::tma_store_4d(&to, o_tile + c * L::kQBox, c * kBoxCols, h, r0, b);
      sm90::tma_store_commit();
    }
    if constexpr (L::kOutInQ) {
      // the next item's Q loads over these rows once the store has read them
      if (ct == 0) sm90::tma_store_wait_read();
      sm90::mbar_arrive(q_empty + qb);
    }
  }
  if (ct == 0) sm90::tma_store_wait_all();
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

__global__ void __launch_bounds__(kThreads) flash_fma_kernel(const Args a) {
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

// Shared memory a block of the mma or fma kernel needs (bytes): at D = 256,
// 101,376 (mma) and 102,784 (fma), within the 227 KB a block may use.  (The
// wgmma kernel's is WgPlan<D>::bytes + 1,024: 197,720 at D = 256.)
size_t smem_bytes(int variant, int D) {
  if (variant == 1) {
    const int ld = ((D + 15) & ~15) + 8;
    return static_cast<size_t>(kBM + 2 * kBN) * ld * 2;
  }
  return 4 * static_cast<size_t>(kFM * D + kFN * (D + 1) + kFN * D + kFM * kFN +
                                 2 * kFM);
}

// cuTensorMapEncodeTiled, found through the runtime, so the library needs
// no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map over (D, heads, positions, batch) of a tensor with element
// strides (head, position, batch), read in boxes of 64 columns x `rows`
// positions of one head, 128-byte swizzled.
bool encode_map(CUtensorMap* map, const void* base, int D, int heads, int len,
                int B, long long s_head, long long s_pos, long long s_batch,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_pos) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel's plan D serves head dims a.D <= D: the maps are a.D wide
// (D = 128's plan takes a.D = 120; columns past a.D load as zeros).
template <int D>
int launch_wgmma(const Args& a, int B, int KV, int* next_item,
                 cudaStream_t stream) {
  using L = WgPlan<D>;
  CUtensorMap tq, tk, tv, to;
  const int hd = a.D;
  const long long o_ss = static_cast<long long>(a.H) * hd;
  if (!encode_map(&tq, a.q, hd, a.H, a.S, B, a.q_sh, a.q_ss, a.q_sb, kWgBM) ||
      !encode_map(&to, a.out, hd, a.H, a.S, B, hd, o_ss, o_ss * a.S, kWgRows))
    return -1;
  if (a.T > 0) {
    if (!encode_map(&tk, a.k, hd, KV, a.T, B, a.k_sh, a.k_st, a.k_sb, L::kBN) ||
        !encode_map(&tv, a.v, hd, KV, a.T, B, a.v_sh, a.v_st, a.v_sb, L::kBN))
      return -1;
  } else {
    tk = tv = tq;  // no key tile is loaded
  }
  const size_t smem = L::bytes + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: a block an SM, each walking its share of the work items
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>((a.S + kWgBM - 1) / kWgBM) * B * a.H;
  if (items > (1ll << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(items < sms ? items : sms);
  flash_wgmma_kernel<D>
      <<<blocks, kWgThreads, smem, stream>>>(tq, tk, tv, to, a, B, next_item);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 = fma (float32), 1 = mma (bfloat16), 2 = wgmma (bfloat16, D 64,
// 120, 128 or 256: 1 block an SM, 197,720 B of shared memory at D = 256).
// Strides in elements: (batch, position, head) of q (B, S, H, D) and k/v
// (B, T, KV, D); the last dim is contiguous, and every stride and
// base is 16-byte aligned.  out is a contiguous (B, S, H, D).  D is a
// multiple of 8, at most 256.  next_item: one int32 of device memory that
// is 0 at launch (the wgmma kernel's work counter; the others ignore it).
// Returns -1 if a tensor map could not be encoded.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int variant, int B,
    int S, int T, int H, int KV, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale, float cap,
    int causal, int window, void* next_item, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0) return static_cast<int>(cudaGetLastError());
  Args a{q, k, v, out, S, T, H, H / KV, D, q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
         v_sb, v_st, v_sh, scale, cap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 2) {
    int* counter = static_cast<int*>(next_item);
    if (D == 64) return launch_wgmma<64>(a, B, KV, counter, st);
    if (D == 120 || D == 128) return launch_wgmma<128>(a, B, KV, counter, st);
    if (D == 256) return launch_wgmma<256>(a, B, KV, counter, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(variant, D);
  if (variant == 1) {
    dim3 grid(H, B, (S + kBM - 1) / kBM);
    if (D <= 64) return launch(flash_mma_kernel<8>, grid, smem, st, a);
    if (D <= 128) return launch(flash_mma_kernel<16>, grid, smem, st, a);
    return launch(flash_mma_kernel<32>, grid, smem, st, a);
  }
  if (variant == 0) {
    dim3 grid(H, B, (S + kFM - 1) / kFM);
    return launch(flash_fma_kernel, grid, smem, st, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
