// Exact top-k page selection for the migration planner, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/select_topk.py
// (select_topk, body _kernel): per row of a (B, n) batch, the exact
// top-k_p promote candidates (heat descending) and top-k_d demote
// candidates (heat ascending), ties by page index ascending -- the same
// index sets as numpy's stable argsort.
//
// Keys.  A candidate's key is its heat's order-preserving u32 bits
// (complemented on the demote side, so colder ranks higher); a
// non-candidate's key is 0.  Candidate keys are never 0 (only a NaN maps
// there).  Keys are computed on the fly from mask + heat on every pass.
//
// Design.  One block of 1024 threads per row, grid (B,).
//  1. Cutoff: the k-th largest key, found by radix select over 4 passes of
//     8-bit digits, most significant first.  Each pass streams the row,
//     builds a 256-bin histogram per side (integer shared-memory atomics,
//     so counts are exact and deterministic) over the keys that match the
//     digits found so far, and one warp per side walks the bins.  Zero
//     keys are left out and equal bins within a warp add once
//     (__match_any_sync), which keeps the shared atomics uncontended when
//     most pages are not candidates.  After the last pass the prefix is
//     the cutoff t and the remaining rank is take = k - |{key > t}|.  A k
//     at or above the number of candidates gives t = 0: every candidate
//     is strict.  k == 0 selects nothing.
//  2. Output: key > t is taken; from the boundary tier (key == t, key > 0)
//     the first `take` pages in index order are taken.  One block-wide
//     exclusive scan per 1024-element tile, with a running carry across
//     tiles, numbers the boundary pages; both sides share one scan by
//     packing the two 0/1 flags into the low and high 16 bits (a row has
//     at most 65535 pages, so neither half overflows).
//
// What bounds it on the card.  The function reads 10 bytes per page (two
// 1-byte masks, two f32 heats) and writes 2; at B = 8, n = 32783 that is
// about 3.1 MB, or about 1 us at 3.35 TB/s.  With one block per row only B
// of the 132 SMs work, and each row is streamed 5 times (4 histogram
// passes and the output pass) with a barrier and a warp walk between
// passes, so the kernel is latency-bound, not bandwidth-bound.  Two u32 key
// rows of 65535 entries (512 KB) exceed a block's 227 KB of shared memory,
// so every pass re-reads the row from L2, where it stays resident.  A
// faster design (several blocks or a cluster per row, fewer passes) is
// later work.
//
// C interface: select_topk_launch(...) launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBins = 256;
// walk result meaning "fewer keys in the histogram than the rank sought"
constexpr unsigned kNoDigit = 0xffffffffu;

__device__ __forceinline__ uint32_t order_bits(float x) {
  uint32_t b = __float_as_uint(x);
  return (b >> 31) == 0 ? (b | 0x80000000u) : ~b;
}

__device__ __forceinline__ uint32_t promote_key(const uint8_t* mask,
                                                const float* heat, int i) {
  return mask[i] ? order_bits(heat[i]) : 0u;
}

__device__ __forceinline__ uint32_t demote_key(const uint8_t* mask,
                                               const float* heat, int i) {
  return mask[i] ? ~order_bits(heat[i]) : 0u;
}

// Clamp floor(count) into [0, n].
__device__ __forceinline__ int row_k(float count, int n) {
  float f = floorf(count);
  if (!(f > 0.0f)) return 0;
  return f >= static_cast<float>(n) ? n : static_cast<int>(f);
}

// One warp walks a 256-bin histogram from the top bin down and finds the
// digit holding the k-th largest key (k >= 1).  Lane L owns bins
// 255 - 8L ... 248 - 8L.  Writes the digit and the count of keys in higher
// bins to out[0], out[1]; leaves out[] untouched (kNoDigit) when the
// histogram holds fewer than k keys.
__device__ void walk_bins(const unsigned* hist, unsigned k, unsigned* out) {
  const int lane = threadIdx.x & 31;
  unsigned c[8];
  unsigned local = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = hist[kBins - 1 - (lane * 8 + j)];
    local += c[j];
  }
  unsigned incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  unsigned above = incl - local;
  if (above < k && k <= incl) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (above + c[j] >= k) {
        out[0] = kBins - 1 - (lane * 8 + j);
        out[1] = above;
        break;
      }
      above += c[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const uint8_t* __restrict__ p_mask,
                   const float* __restrict__ p_heat,
                   const uint8_t* __restrict__ d_mask,
                   const float* __restrict__ d_heat,
                   const float* __restrict__ n_promote,
                   const float* __restrict__ n_demote,
                   uint8_t* __restrict__ p_out, uint8_t* __restrict__ d_out,
                   int n) {
  using BlockScan = cub::BlockScan<unsigned, kThreads>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ unsigned hist[2][kBins];
  __shared__ unsigned walk[2][2];

  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const uint8_t* pm = p_mask + row;
  const uint8_t* dm = d_mask + row;
  const float* ph = p_heat + row;
  const float* dh = d_heat + row;

  const int kp = row_k(n_promote[blockIdx.x], n);
  const int kd = row_k(n_demote[blockIdx.x], n);

  // ---- cutoff: 4 radix passes of 8 bits, both sides per pass ----------
  // Zero (non-candidate) keys stay out of the histograms: the select runs
  // over candidates only, and a side whose k reaches past every candidate
  // resolves to cutoff 0 (take every candidate) after the first pass.
  uint32_t prefix_p = 0, prefix_d = 0;   // digits found so far
  unsigned rank_p = kp, rank_d = kd;     // rank still sought in the tier
  const int lane = tid & 31;
  for (int shift = 24; shift >= 0; shift -= 8) {
    const bool live_p = rank_p > 0, live_d = rank_d > 0;
    if (!live_p && !live_d) break;
    for (int b = tid; b < 2 * kBins; b += kThreads) hist[b / kBins][b % kBins] = 0;
    if (tid < 4) walk[tid / 2][tid % 2] = kNoDigit;
    __syncthreads();
    // keys match the prefix when their digits above `shift` equal it
    const uint32_t hi_mask = shift == 24 ? 0u : (0xffffffffu << (shift + 8));
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      // bin kBins = no count; whole warps vote so equal bins add once
      unsigned bin_p = kBins, bin_d = kBins;
      if (i < n) {
        if (live_p) {
          uint32_t key = promote_key(pm, ph, i);
          if (key != 0 && (key & hi_mask) == prefix_p) bin_p = (key >> shift) & 0xffu;
        }
        if (live_d) {
          uint32_t key = demote_key(dm, dh, i);
          if (key != 0 && (key & hi_mask) == prefix_d) bin_d = (key >> shift) & 0xffu;
        }
      }
      unsigned peers = __match_any_sync(0xffffffffu, bin_p);
      if (bin_p < kBins && lane == __ffs(peers) - 1)
        atomicAdd(&hist[0][bin_p], static_cast<unsigned>(__popc(peers)));
      peers = __match_any_sync(0xffffffffu, bin_d);
      if (bin_d < kBins && lane == __ffs(peers) - 1)
        atomicAdd(&hist[1][bin_d], static_cast<unsigned>(__popc(peers)));
    }
    __syncthreads();
    const int warp = tid >> 5;
    if (warp == 0 && live_p) walk_bins(hist[0], rank_p, walk[0]);
    if (warp == 1 && live_d) walk_bins(hist[1], rank_d, walk[1]);
    __syncthreads();
    if (live_p) {
      if (walk[0][0] == kNoDigit) {  // fewer candidates than k: take all
        prefix_p = 0;
        rank_p = 0;
      } else {
        prefix_p |= walk[0][0] << shift;
        rank_p -= walk[0][1];
      }
    }
    if (live_d) {
      if (walk[1][0] == kNoDigit) {
        prefix_d = 0;
        rank_d = 0;
      } else {
        prefix_d |= walk[1][0] << shift;
        rank_d -= walk[1][1];
      }
    }
    __syncthreads();  // walk[] and hist[] are rewritten next pass
  }
  // On a side with k > 0, prefix_* is now the k-th largest candidate key
  // and rank_* the number of boundary pages to take -- or prefix 0 and
  // rank 0 when k covers every candidate (then key > 0 takes them all).

  // ---- output: strict set + first `take` boundary pages by index -------
  unsigned carry = 0;  // boundary pages before this tile, packed p | d<<16
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    uint32_t key_p = 0, key_d = 0;
    if (i < n) {
      key_p = promote_key(pm, ph, i);
      key_d = demote_key(dm, dh, i);
    }
    const bool bound_p = kp > 0 && key_p == prefix_p && key_p > 0;
    const bool bound_d = kd > 0 && key_d == prefix_d && key_d > 0;
    unsigned flags = (bound_p ? 1u : 0u) | (bound_d ? 1u << 16 : 0u);
    unsigned before, tile_total;
    BlockScan(scan_tmp).ExclusiveSum(flags, before, tile_total);
    before += carry;
    if (i < n) {
      const bool take_p = kp > 0 && (key_p > prefix_p ||
                                     (bound_p && (before & 0xffffu) < rank_p));
      const bool take_d = kd > 0 && (key_d > prefix_d ||
                                     (bound_d && (before >> 16) < rank_d));
      p_out[row + i] = take_p ? 1 : 0;
      d_out[row + i] = take_d ? 1 : 0;
    }
    carry += tile_total;
    __syncthreads();  // scan_tmp is reused by the next tile
  }
}

}  // namespace

extern "C" int select_topk_launch(const void* p_mask, const void* p_heat,
                                  const void* d_mask, const void* d_heat,
                                  const void* n_promote, const void* n_demote,
                                  void* p_out, void* d_out, int B, int n,
                                  void* stream) {
  if (B > 0 && n > 0) {
    select_topk_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(p_mask), static_cast<const float*>(p_heat),
        static_cast<const uint8_t*>(d_mask), static_cast<const float*>(d_heat),
        static_cast<const float*>(n_promote),
        static_cast<const float*>(n_demote), static_cast<uint8_t*>(p_out),
        static_cast<uint8_t*>(d_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
