// scan.cuh: the block-wide exclusive sum of one int a thread, shared by
// fused_chunk_step, fused_drain_sum, fused_deposit_add and erdos_pallas.

#pragma once

#include <cuda_runtime.h>

namespace scan {

// Exclusive scan of x over the kThreads threads of a block (a multiple of
// 32, at most 1024): returns the sum of the x of the threads before this
// one and, where `total` is given, stores the block's sum there.  warp_tot:
// int[kThreads / 32] in shared memory, int[33] when `total` is given; the
// caller syncs before reusing it.
template <int kThreads>
__device__ __forceinline__ int block_excl(int x, int* warp_tot,
                                          int* total = nullptr) {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024,
                "a block of whole warps, at most 1024 threads");
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int y = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int z = __shfl_up_sync(0xffffffffu, y, o);
    if (lane >= o) y += z;
  }
  if (lane == 31) warp_tot[wid] = y;
  __syncthreads();
  if (wid == 0) {
    const int w = lane < kWarps ? warp_tot[lane] : 0;
    int z = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += u;
    }
    if (lane < kWarps) warp_tot[lane] = z - w;
    if (total != nullptr && lane == 31) warp_tot[32] = z;
  }
  __syncthreads();
  if (total != nullptr) *total = warp_tot[32];
  return warp_tot[wid] + y - x;
}

}  // namespace scan
