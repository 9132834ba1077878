// fused_deposit_both: the ring engine's two multi-rumor deposits in one
// pass.  For every lane i with valid[i], a slot in [0, b) and a dst in
// [0, n):
//   pending[slot, dst]          += 1
//   pending_rumors[slot, dst, c] += newbits[i / k, c]   for c < r
// where newbits is the bool (rows, r) matrix of each sender's new rumor
// bits and k = m / rows the lanes (edges) of one sender.  Lanes that fail
// any test add nothing.
//
// Replaces the TPU kernel gossip_simulator_tpu/ops/pallas_megakernel.py
// fused_deposit_both (_deposit_both_kernel), a serial lane loop that adds
// the count and the sender's rumor row at the shared (slot, dst) cell,
// reading the row in-register instead of materializing the (m, r)
// broadcast that the unfused pair (fused_deposit_add + fused_deposit_rows)
// needs.
//
// Bound on the H100: bytes, and the L2 atomic rate beside it.  Each lane
// reads its valid byte, a valid lane 8 bytes of slot and dst; the r-byte
// bool row of each sender with a valid lane is read once (a quarter of an
// int32 row); each touched count cell and each touched (cell, rumor) with
// a set bit is read and written once, at random cells.  At the
// multi-rumor run's shape (6e6 lanes, four in five invalid, a quarter of a
// sending row's 16 bits set) that is ~1.2e6 count adds and ~4.8e6 bit
// adds, ~0.05 ms at the ~1.2e11 adds a second L2 atomics run at.  Design:
// each warp lists its batch's depositing lanes (csrc/lanes.cuh, shared
// with fused_deposit_rows: coalesced loads, a ballot, lane order); then,
// 32 listed lanes at a time, each thread adds its lane's count, reads its
// sender's bit row (16 bytes a piece where r % 16 == 0 and the rows are
// aligned, else a byte at a time) into a mask of set columns, 32 columns
// at a time, and the warp lists the set bits as (lane, column) entries in
// shared memory (a warp scan of the masks' popcounts gives each lane its
// place) and issues them 32 at a time, one atomicAdd whose result is
// unused (a RED) each, so every thread's add is a useful one.  Integer
// adds commute, so the result is the sequential pair's in any order of
// the atomics.
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the launch.

#include "lanes.cuh"

namespace {

// Bit c of the result: byte c of the four bytes of x is nonzero.
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// The set columns c0 .. c0 + span - 1 (span <= 32) of a bit row, as a mask.
__device__ __forceinline__ unsigned set_columns(const uint8_t* row, int c0,
                                                int span, bool vec16) {
  unsigned mask = 0;
  if (vec16) {
    for (int p = 0; p < span; p += 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + c0 + p);
      mask |= (nibble(q.x) | nibble(q.y) << 4 | nibble(q.z) << 8
               | nibble(q.w) << 12) << p;
    }
  } else {
    for (int c = 0; c < span; ++c)
      if (row[c0 + c] != 0) mask |= 1u << c;
  }
  return mask;
}

__global__ void __launch_bounds__(THREADS)
deposit_both(int32_t* __restrict__ pending, int32_t* __restrict__ prum,
             const int32_t* __restrict__ slots,
             const int32_t* __restrict__ dst,
             const uint8_t* __restrict__ valid,
             const uint8_t* __restrict__ newbits, long long m, int b,
             long long n, int r, int k, bool vec16) {
  __shared__ int s_lane[WARPS][BATCH];
  __shared__ long long s_cell[WARPS][BATCH];
  __shared__ uint16_t s_ent[WARPS][32 * 32];  // (listed lane, column) pairs
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long base = ((long long)blockIdx.x * WARPS + wid) * BATCH;
  const int count = listing::lanes(slots, dst, valid, base, m, b, n, 1,
                                   s_lane[wid], s_cell[wid]);
  const long long* cells = s_cell[wid];
  uint16_t* ent = s_ent[wid];
  for (int kb = 0; kb < count; kb += 32) {
    const bool has = kb + lane < count;
    const long long cell = has ? cells[kb + lane] : 0;
    if (has) atomicAdd(pending + cell, 1);
    const uint8_t* row =
        newbits + (has ? (base + s_lane[wid][kb + lane]) / k : 0) * r;
    for (int c0 = 0; c0 < r; c0 += 32) {
      unsigned mask = has ? set_columns(row, c0, min(32, r - c0), vec16) : 0;
      const int own = __popc(mask);
      int at = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, at, o);
        if (lane >= o) at += y;
      }
      const int total = __shfl_sync(FULL_MASK, at, 31);
      at -= own;
      for (; mask; mask &= mask - 1u)
        ent[at++] = (uint16_t)(lane << 5 | (__ffs(mask) - 1));
      __syncwarp();
      for (int e = lane; e < total; e += 32) {
        const int x = ent[e];
        atomicAdd(prum + cells[kb + (x >> 5)] * r + c0 + (x & 31), 1);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// pending: int32[b * n] and pending_rumors: int32[b * n * r], both updated
// in place; slots, dst: int32[m]; valid: bool[m]; newbits: bool[m / k, r].
extern "C" int gossip_fused_deposit_both(void* pending, void* pending_rumors,
                                         const void* slots, const void* dst,
                                         const void* valid,
                                         const void* newbits, long long m,
                                         int b, long long n, int r, int k,
                                         void* stream) {
  if (m < 0 || b < 0 || n < 0 || r < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  if (m > 0 && b > 0 && n > 0) {
    const bool vec16 = r % 16 == 0 && (uintptr_t)newbits % 16 == 0;
    const long long per_block = (long long)WARPS * BATCH;
    const long long blocks = (m + per_block - 1) / per_block;
    deposit_both<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)pending, (int32_t*)pending_rumors, (const int32_t*)slots,
        (const int32_t*)dst, (const uint8_t*)valid, (const uint8_t*)newbits,
        m, b, n, r, k, vec16);
  }
  return (int)cudaGetLastError();
}
