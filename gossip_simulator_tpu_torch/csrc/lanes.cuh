// lanes.cuh: the warp-compacted lane listing that fused_deposit_rows and
// fused_deposit_both share.
//
// A warp takes BATCH consecutive lanes from `base`, ROUNDS rounds of 32
// with coalesced loads (all in flight at once), ballots the lanes that
// deposit (valid, where given; a slot in [0, b); a dst in [0, n)) and
// lists them in lane order in shared memory: each listed lane's offset in
// the batch and its cell offset (slot * n + dst) * w.  A lane that
// deposits nothing costs its loads and a ballot bit.  Where `valid` is
// given, a lane's slot and dst are read only when it is valid (at the
// multi-rumor deposit four lanes in five are not).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define THREADS 256
#define WARPS (THREADS / 32)
#define ROUNDS 4  // 32-lane rounds a warp lists before serving them
#define BATCH (32 * ROUNDS)
#define FULL_MASK 0xffffffffu

namespace listing {

// Returns the warp's listed lanes; s_lane[k] and s_cell[k] hold the k-th.
// Called by a whole warp.
__device__ __forceinline__ int lanes(const int32_t* __restrict__ slots,
                                     const int32_t* __restrict__ dst,
                                     const uint8_t* __restrict__ valid,
                                     long long base, long long m, int b,
                                     long long n, long long w, int* s_lane,
                                     long long* s_cell) {
  const int lane = threadIdx.x & 31;
  bool v[ROUNDS];
  int sl[ROUNDS], d[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + r * 32 + lane;
    v[r] = i < m && (valid == nullptr || valid[i] != 0);
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long i = base + r * 32 + lane;
    sl[r] = v[r] ? slots[i] : -1;
    d[r] = v[r] ? dst[i] : -1;
  }
  int count = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const bool in = sl[r] >= 0 && sl[r] < b && d[r] >= 0 && (long long)d[r] < n;
    const unsigned mk = __ballot_sync(FULL_MASK, in);
    if (in) {
      const int k = count + __popc(mk & ((1u << lane) - 1u));
      s_lane[k] = r * 32 + lane;
      s_cell[k] = ((long long)sl[r] * n + d[r]) * w;
    }
    count += __popc(mk);
  }
  __syncwarp();
  return count;
}

}  // namespace listing
