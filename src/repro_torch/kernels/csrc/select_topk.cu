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
// there).
//
// Two kernels compute this function; the wrapper's pick_variant chooses.
// Both find each side's cutoff by radix select over 4 passes of 8-bit
// digits, most significant first, then take the strict set and the first
// `take` boundary pages in index order:
//  1. Cutoff: the k-th largest key.  Each pass builds a 256-bin histogram
//     per side (integer shared-memory atomics, so counts are exact and
//     deterministic) over the keys that match the digits found so far, and
//     one warp per side walks the bins.  Zero keys are left out and equal
//     bins within a warp add once (__match_any_sync), which keeps the
//     shared atomics uncontended when most pages are not candidates.
//     After the last pass the prefix is the cutoff t and the remaining rank
//     is take = k - |{key > t}|.  A k at or above the number of candidates
//     gives t = 0: every candidate is strict.  k == 0 selects nothing.
//  2. Output: key > t is taken; from the boundary tier (key == t, key > 0)
//     the first `take` pages in index order are taken, numbered by an
//     exclusive scan in which both sides share one word, the promote
//     side's count in the low and the demote side's in the high half: a
//     64-bit word (32-bit halves) in the cluster kernel, and in the block
//     kernel a 32-bit word (16-bit halves) for rows of at most 65,535
//     pages -- the 64-bit scan costs that kernel registers (it spills at
//     1024 threads) and about a quarter of its time -- and a 64-bit word
//     for longer ones.
//
// "block" (select_topk_kernel<Word>; rows of at most 1,024 pages by the rule).
// One block of 1024 threads per row, grid (B,).  Keys are computed on the
// fly from mask and heat on every pass; the output numbers boundary pages
// by one block scan per 1024-page tile with a running carry.  What holds
// it back: only B of the 132 SMs work, and each row is streamed 5 times
// from L2 (a block's 227 KB of shared memory holds the two u32 key rows of
// fewer than 29,000 pages), with a barrier and a warp walk between passes.
// It keeps nothing per page in shared memory, so it takes any n.
//
// "cluster" (select_topk_cluster_kernel; the main paths).  One thread-block
// cluster of C = kCluster = 16 CTAs (512 threads each) per row, grid (C, B),
// cluster dims (C, 1, 1).  16 needs the non-portable cluster size allowed;
// the portable 8 measured about 5% slower at the tuning shape.
//  * CTA r takes the slice [r * s, (r + 1) * s) of the row (s = ceil(n /
//    C)), in index order, and computes both sides' u32 keys once into its
//    shared memory (2 x 4 B x s): the row is read from device memory once,
//    and every pass runs over shared memory.  The slice is what bounds n:
//    2 x 4 B x s plus the kernel's static shared memory must fit the 227 KB
//    (232,448 bytes) a block may use, so n <= C x floor((232,448 - static)
//    / 8) (MAX_N in kernels/select_topk.py, from ptxas's count of the
//    static part).
//  * Each pass, every CTA builds its slice's histograms (warps with no
//    matching key skip the vote), then adds each non-zero bin into the
//    sums of every CTA of the cluster through distributed shared memory
//    (mapa + red.shared::cluster, fire and forget).  One cluster barrier
//    (arrive.release / wait.acquire) publishes the sums, and each CTA walks
//    its own copy.  All copies are equal, so all CTAs find the same digits
//    and leave the loop together.  Sums alternate between two buffers, so
//    a pass needs that one cluster barrier and two block barriers.
//  * Output: each CTA counts its boundary pages (one block scan over
//    per-thread runs of consecutive pages) and adds the count to the
//    offsets of the CTAs of higher rank; after a cluster barrier each
//    numbers its boundary pages from its offset, so slices in rank order
//    keep the index tie-break.  No CTA touches another's memory after
//    that barrier, so none has to wait for the others to leave.
// 8-bit digits keep a pass's cross-CTA traffic at most 2 x 256 x C adds a
// CTA; wider digits would save a pass but multiply that traffic and the
// walk.
//
// What bounds it on the card.  The function reads 10 bytes per page (two
// 1-byte masks, two f32 heats) and writes 2; at B = 8, n = 32783 that is
// about 3.1 MB, or about 1 us at 3.35 TB/s, below the time of any launch.
// Both kernels are latency-bound: the block kernel by its serial passes on
// one SM a row, the cluster kernel by the barriers of its passes (at a
// few hundred pages a CTA they, not the data, set a pass's time) and the
// one read of the row, spread over C SMs.
//
// C interface: select_topk_launch(...) (block) and
// select_topk_cluster_launch(...) (cluster) launch on the given stream,
// allocate nothing, and return cudaGetLastError().

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

// Boundary-page counts of both sides in one scan word of type Word: the
// promote side's in the low half, the demote side's in the high half.  A
// half of a 32-bit word counts up to 65,535 pages, of a 64-bit word any n.
template <typename Word>
struct Packed {
  static constexpr int kHalf = 4 * sizeof(Word);
  static constexpr Word kLow = (Word(1) << kHalf) - 1;
  __device__ __forceinline__ static Word both(bool p, bool d) {
    return Word(p ? 1 : 0) | (Word(d ? 1 : 0) << kHalf);
  }
  __device__ __forceinline__ static unsigned promote(Word w) {
    return static_cast<unsigned>(w & kLow);
  }
  __device__ __forceinline__ static unsigned demote(Word w) {
    return static_cast<unsigned>(w >> kHalf);
  }
};
// longest row whose counts fit the 16-bit halves of a 32-bit word
constexpr int kNarrowMaxN = 65535;

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

template <typename Word>
__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const uint8_t* __restrict__ p_mask,
                   const float* __restrict__ p_heat,
                   const uint8_t* __restrict__ d_mask,
                   const float* __restrict__ d_heat,
                   const float* __restrict__ n_promote,
                   const float* __restrict__ n_demote,
                   uint8_t* __restrict__ p_out, uint8_t* __restrict__ d_out,
                   int n) {
  using BlockScan = cub::BlockScan<Word, kThreads>;
  using Pack = Packed<Word>;
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
  Word carry = 0;  // boundary pages before this tile, both sides packed
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    uint32_t key_p = 0, key_d = 0;
    if (i < n) {
      key_p = promote_key(pm, ph, i);
      key_d = demote_key(dm, dh, i);
    }
    const bool bound_p = kp > 0 && key_p == prefix_p && key_p > 0;
    const bool bound_d = kd > 0 && key_d == prefix_d && key_d > 0;
    Word before, tile_total;
    BlockScan(scan_tmp).ExclusiveSum(Pack::both(bound_p, bound_d), before, tile_total);
    before += carry;
    if (i < n) {
      const bool take_p = kp > 0 && (key_p > prefix_p ||
                                     (bound_p && Pack::promote(before) < rank_p));
      const bool take_d = kd > 0 && (key_d > prefix_d ||
                                     (bound_d && Pack::demote(before) < rank_d));
      p_out[row + i] = take_p ? 1 : 0;
      d_out[row + i] = take_d ? 1 : 0;
    }
    carry += tile_total;
    __syncthreads();  // scan_tmp is reused by the next tile
  }
}

// ---------------------------------------------------------------------------
// "cluster": one thread-block cluster per row (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int kClusterThreads = 512;
constexpr int kCluster = 16;  // CTAs of one cluster (one row)

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives; the release/acquire
// pair orders each CTA's shared-memory writes (its own and its adds into
// the others') before what any CTA does after the barrier.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Adds v to the u32 at the offset of `p` in the shared memory of CTA
// `rank` of the cluster (fire and forget; a cluster barrier's release
// makes it visible).
__device__ __forceinline__ void red_dsmem_add(unsigned* p, unsigned rank, unsigned v) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;\n" ::"r"(remote), "r"(v)
               : "memory");
}

// Grid (C, B), cluster (C, 1, 1): CTA `rank` of row b takes the slice
// [rank * slice, min(n, (rank + 1) * slice)) of the row.  Dynamic shared
// memory: 2 x slice u32 keys.
__global__ void __launch_bounds__(kClusterThreads)
select_topk_cluster_kernel(const uint8_t* __restrict__ p_mask,
                           const float* __restrict__ p_heat,
                           const uint8_t* __restrict__ d_mask,
                           const float* __restrict__ d_heat,
                           const float* __restrict__ n_promote,
                           const float* __restrict__ n_demote,
                           uint8_t* __restrict__ p_out, uint8_t* __restrict__ d_out,
                           int n, int slice) {
  using BlockScan = cub::BlockScan<uint64_t, kClusterThreads>;
  using Pack = Packed<uint64_t>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ unsigned hist[2][kBins];       // [side][bin], this slice's, one pass
  __shared__ unsigned summed[2][2][kBins];  // [pass parity][side][bin], the cluster's
  __shared__ unsigned walk[2][2][2];        // [pass parity][side]: digit, count above
  __shared__ unsigned slice_offset[2];      // [side]: boundary pages of the slices before it
  extern __shared__ uint32_t keys[];        // promote keys, then demote keys

  const int tid = threadIdx.x;
  const unsigned rank = cluster_rank();
  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * n;
  const int lo = min(n, static_cast<int>(rank) * slice);
  const int m = min(n, lo + slice) - lo;  // this slice's pages
  uint32_t* key_p = keys;
  uint32_t* key_d = keys + slice;

  // ---- keys of the slice, read from device memory once ----------------
  for (int i = tid; i < m; i += kClusterThreads) {
    key_p[i] = promote_key(p_mask + row, p_heat + row, lo + i);
    key_d[i] = demote_key(d_mask + row, d_heat + row, lo + i);
  }
  for (int i = tid; i < 2 * kBins; i += kClusterThreads) {
    hist[i / kBins][i % kBins] = 0;
    summed[0][i / kBins][i % kBins] = 0;
  }
  if (tid < 2) slice_offset[tid] = 0;
  const int kp = row_k(n_promote[b], n);
  const int kd = row_k(n_demote[b], n);
  // every CTA has started and cleared what the others add into
  cluster_sync();

  // ---- cutoff: 4 radix passes of 8 bits over the cluster's histograms ---
  // Each pass, every CTA builds its slice's histograms and adds their
  // non-zero bins into summed[p & 1] of every CTA of the cluster; after
  // the cluster barrier each CTA walks its own copy of the sums.  All
  // copies are equal, so all CTAs find the same digits and leave the loop
  // together.  A CTA clears summed[(p + 1) & 1] before pass p's barrier,
  // after which the others may add into it; its walk of pass p - 1 is
  // behind the block barrier that ends that pass.
  uint32_t prefix_p = 0, prefix_d = 0;
  unsigned rank_p = kp, rank_d = kd;
  const int lane = tid & 31, warp = tid >> 5;
  int par = 0;
  for (int shift = 24; shift >= 0; shift -= 8, par ^= 1) {
    const bool live_p = rank_p > 0, live_d = rank_d > 0;
    if (!live_p && !live_d) break;
    if (tid < 4) walk[par][tid / 2][tid % 2] = kNoDigit;
    const uint32_t hi_mask = shift == 24 ? 0u : (0xffffffffu << (shift + 8));
    for (int base = 0; base < m; base += kClusterThreads) {
      const int i = base + tid;
      unsigned bin_p = kBins, bin_d = kBins;
      if (i < m) {
        if (live_p) {
          const uint32_t key = key_p[i];
          if (key != 0 && (key & hi_mask) == prefix_p) bin_p = (key >> shift) & 0xffu;
        }
        if (live_d) {
          const uint32_t key = key_d[i];
          if (key != 0 && (key & hi_mask) == prefix_d) bin_d = (key >> shift) & 0xffu;
        }
      }
      // warps with no matching key (most of them after the first pass)
      // skip the vote
      if (__any_sync(0xffffffffu, bin_p < kBins)) {
        const unsigned peers = __match_any_sync(0xffffffffu, bin_p);
        if (bin_p < kBins && lane == __ffs(peers) - 1)
          atomicAdd(&hist[0][bin_p], static_cast<unsigned>(__popc(peers)));
      }
      if (__any_sync(0xffffffffu, bin_d < kBins)) {
        const unsigned peers = __match_any_sync(0xffffffffu, bin_d);
        if (bin_d < kBins && lane == __ffs(peers) - 1)
          atomicAdd(&hist[1][bin_d], static_cast<unsigned>(__popc(peers)));
      }
    }
    __syncthreads();
    // thread t owns bin t % 256 of side t / 256: it adds the slice's count
    // into every CTA's sums and clears it for the next pass
    for (int i = tid; i < 2 * kBins; i += kClusterThreads) {
      unsigned* h = &hist[i / kBins][i % kBins];
      const unsigned v = *h;
      if (v) {
#pragma unroll
        for (int r = 0; r < kCluster; ++r) red_dsmem_add(&summed[par][i / kBins][i % kBins], r, v);
        *h = 0;
      }
      summed[par ^ 1][i / kBins][i % kBins] = 0;
    }
    cluster_sync();
    if (warp == 0 && live_p) walk_bins(summed[par][0], rank_p, walk[par][0]);
    if (warp == 1 && live_d) walk_bins(summed[par][1], rank_d, walk[par][1]);
    __syncthreads();
    if (live_p) {
      if (walk[par][0][0] == kNoDigit) {  // fewer candidates than k: take all
        prefix_p = 0;
        rank_p = 0;
      } else {
        prefix_p |= walk[par][0][0] << shift;
        rank_p -= walk[par][0][1];
      }
    }
    if (live_d) {
      if (walk[par][1][0] == kNoDigit) {
        prefix_d = 0;
        rank_d = 0;
      } else {
        prefix_d |= walk[par][1][0] << shift;
        rank_d -= walk[par][1][1];
      }
    }
  }

  // ---- output: strict set + first `take` boundary pages by index -------
  // Thread t takes the slice's pages [t * per, (t + 1) * per), so a block
  // scan of the per-thread counts numbers them in index order.
  const int per = (m + kClusterThreads - 1) / kClusterThreads;
  const int i0 = tid * per;
  const int i1 = min(m, i0 + per);
  uint64_t mine = 0;  // boundary pages of this thread, both sides packed
  for (int i = i0; i < i1; ++i) {
    const uint32_t kpi = key_p[i], kdi = key_d[i];
    mine += Pack::both(kp > 0 && kpi == prefix_p && kpi > 0,
                       kd > 0 && kdi == prefix_d && kdi > 0);
  }
  uint64_t before, total;
  BlockScan(scan_tmp).ExclusiveSum(mine, before, total);
  // slices of higher rank come later in index order: add this slice's
  // counts to their offsets
  if (tid > static_cast<int>(rank) && tid < kCluster) {
    red_dsmem_add(&slice_offset[0], tid, Pack::promote(total));
    red_dsmem_add(&slice_offset[1], tid, Pack::demote(total));
  }
  cluster_sync();  // every offset is complete; no CTA touches another's memory after it
  before += static_cast<uint64_t>(slice_offset[0]) | static_cast<uint64_t>(slice_offset[1]) << Pack::kHalf;
  for (int i = i0; i < i1; ++i) {
    const uint32_t kpi = key_p[i], kdi = key_d[i];
    const bool bound_p = kp > 0 && kpi == prefix_p && kpi > 0;
    const bool bound_d = kd > 0 && kdi == prefix_d && kdi > 0;
    const bool take_p = kp > 0 && (kpi > prefix_p || (bound_p && Pack::promote(before) < rank_p));
    const bool take_d = kd > 0 && (kdi > prefix_d || (bound_d && Pack::demote(before) < rank_d));
    p_out[row + lo + i] = take_p ? 1 : 0;
    d_out[row + lo + i] = take_d ? 1 : 0;
    before += Pack::both(bound_p, bound_d);
  }
}

}  // namespace

// The block kernel: grid (B,), 1024 threads, its scan word by n.
extern "C" int select_topk_launch(const void* p_mask, const void* p_heat,
                                  const void* d_mask, const void* d_heat,
                                  const void* n_promote, const void* n_demote,
                                  void* p_out, void* d_out, int B, int n,
                                  void* stream) {
  if (B > 0 && n > 0) {
    auto kernel = n <= kNarrowMaxN ? select_topk_kernel<uint32_t> : select_topk_kernel<uint64_t>;
    kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(p_mask), static_cast<const float*>(p_heat),
        static_cast<const uint8_t*>(d_mask), static_cast<const float*>(d_heat),
        static_cast<const float*>(n_promote),
        static_cast<const float*>(n_demote), static_cast<uint8_t*>(p_out),
        static_cast<uint8_t*>(d_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cluster kernel: grid (kCluster, B), clusters of kCluster CTAs (the
// non-portable size allowed), each with 2 x ceil(n / kCluster) u32 keys of
// dynamic shared memory.
extern "C" int select_topk_cluster_launch(const void* p_mask, const void* p_heat,
                                          const void* d_mask, const void* d_heat,
                                          const void* n_promote, const void* n_demote,
                                          void* p_out, void* d_out, int B, int n,
                                          void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int slice = (n + kCluster - 1) / kCluster;
  const int smem = 2 * slice * static_cast<int>(sizeof(uint32_t));
  static int smem_opted = 48 * 1024;  // attributes hold for the process
  static bool non_portable = false;
  cudaError_t err;
  if (smem > smem_opted) {
    err = cudaFuncSetAttribute(select_topk_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted = smem;
  }
  if (!non_portable) {
    err = cudaFuncSetAttribute(select_topk_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, select_topk_cluster_kernel,
                           static_cast<const uint8_t*>(p_mask),
                           static_cast<const float*>(p_heat),
                           static_cast<const uint8_t*>(d_mask),
                           static_cast<const float*>(d_heat),
                           static_cast<const float*>(n_promote),
                           static_cast<const float*>(n_demote), static_cast<uint8_t*>(p_out),
                           static_cast<uint8_t*>(d_out), n, slice);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return static_cast<int>(err != cudaSuccess ? err : last);
}
