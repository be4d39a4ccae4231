// Batched page migration between two page pools, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/page_migrate.py
// (page_migrate, body _kernel): for every lane i of a migration plan,
// dst[dst_ids[i]] = src[src_ids[i]], in place.  A lane with a negative id
// is a no-op (the TPU kernel clamps such a lane to row 0 and writes that
// row's old contents back, which loses a copy into row 0 made by an
// earlier lane; this kernel does not).  Of lanes with the same destination
// the last one wins, as in the TPU kernel's sequential grid.
//
// Design.  Two launches on the caller's stream:
//  1. page_migrate_winner: one thread per lane; a valid lane writes
//     atomicMax(winner[dst], lane) into an int32 scratch row per
//     destination (set to -1 first).  The maximum does not depend on the
//     order of the atomics, so the result is deterministic.
//  2. page_migrate_copy: grid (lanes, chunks of the row).  A block copies
//     one chunk of one row if its lane is valid and won its destination.
//     When the source and destination rows are aligned alike modulo 16
//     bytes, the chunk moves as 16-byte vector loads and stores with
//     scalar bytes at the unaligned head and tail; otherwise byte by byte.
//
// What bounds it on the card.  Bytes: each moved row is read once and
// written once, 2 x row_bytes per lane, at 3.35 TB/s.  A serving page of
// chatglm3-6b's KV width is 917,504 bytes, so one block per row would put
// a 256-lane plan on 256 blocks of long serial loops; splitting rows into
// 32 KB chunks gives 28 blocks per row and fills all 132 SMs.  Lanes that
// are no-ops exit at once, so a plan padded with -1 lanes costs only the
// rows that move.
//
// C interface: page_migrate_launch(...) launches on the given stream,
// allocates nothing (the winner scratch is the caller's), and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 32 * 1024;

__global__ void page_migrate_winner(const int* __restrict__ dst_ids,
                                    const int* __restrict__ src_ids,
                                    int n_lanes, int dst_rows, int src_rows,
                                    int* __restrict__ winner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const int d = dst_ids[i], s = src_ids[i];
  if (d >= 0 && s >= 0 && d < dst_rows && s < src_rows) atomicMax(&winner[d], i);
}

__global__ void __launch_bounds__(kThreads)
page_migrate_copy(const unsigned char* __restrict__ src,
                  unsigned char* __restrict__ dst,
                  const int* __restrict__ dst_ids,
                  const int* __restrict__ src_ids,
                  const int* __restrict__ winner, int dst_rows, int src_rows,
                  long long row_bytes, long long src_stride,
                  long long dst_stride) {
  const int lane = blockIdx.x;
  const int d = dst_ids[lane], s = src_ids[lane];
  if (d < 0 || s < 0 || d >= dst_rows || s >= src_rows) return;
  if (winner[d] != lane) return;
  const long long lo = static_cast<long long>(blockIdx.y) * kChunkBytes;
  if (lo >= row_bytes) return;
  const long long hi = lo + kChunkBytes < row_bytes ? lo + kChunkBytes : row_bytes;
  const unsigned char* sp = src + s * src_stride;
  unsigned char* dp = dst + d * dst_stride;
  const int tid = threadIdx.x;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(sp);
  const uintptr_t da = reinterpret_cast<uintptr_t>(dp);
  if (((sa ^ da) & 15) != 0) {  // aligned differently: bytes only
    for (long long b = lo + tid; b < hi; b += kThreads) dp[b] = sp[b];
    return;
  }
  // [v_lo, v_hi): the 16-byte-aligned part of [lo, hi)
  long long v_lo = static_cast<long long>(((sa + lo + 15) & ~uintptr_t(15)) - sa);
  long long v_hi = static_cast<long long>(((sa + hi) & ~uintptr_t(15)) - sa);
  if (v_lo > v_hi) v_lo = v_hi = hi;
  for (long long b = lo + tid; b < v_lo; b += kThreads) dp[b] = sp[b];
  const uint4* sv = reinterpret_cast<const uint4*>(sp + v_lo);
  uint4* dv = reinterpret_cast<uint4*>(dp + v_lo);
  const long long nv = (v_hi - v_lo) / 16;
  for (long long v = tid; v < nv; v += kThreads) dv[v] = sv[v];
  for (long long b = v_hi + tid; b < hi; b += kThreads) dp[b] = sp[b];
}

}  // namespace

extern "C" int page_migrate_launch(const void* src, void* dst,
                                   const void* dst_ids, const void* src_ids,
                                   void* winner, int n_lanes, int dst_rows,
                                   int src_rows, long long row_bytes,
                                   long long src_stride, long long dst_stride,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_lanes > 0 && row_bytes > 0 && dst_rows > 0) {
    cudaMemsetAsync(winner, 0xff, sizeof(int) * static_cast<size_t>(dst_rows), st);
    page_migrate_winner<<<(n_lanes + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const int*>(dst_ids), static_cast<const int*>(src_ids),
        n_lanes, dst_rows, src_rows, static_cast<int*>(winner));
    const long long chunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;
    dim3 grid(static_cast<unsigned>(n_lanes), static_cast<unsigned>(chunks));
    page_migrate_copy<<<grid, kThreads, 0, st>>>(
        static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
        static_cast<const int*>(dst_ids), static_cast<const int*>(src_ids),
        static_cast<const int*>(winner), dst_rows, src_rows, row_bytes,
        src_stride, dst_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
