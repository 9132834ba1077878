// fused_deposit_rows: pending[slot, dst, :] += vals[i, :] for every lane i
// whose slot lies in [0, b) and whose dst lies in [0, n); any other lane
// adds nothing.  pending is int32[b, n, w], vals int32[m, w]; the adds
// wrap in two's complement, as int32 adds do everywhere.
//
// The ring engine's multi-rumor deposit (models/epidemic.py
// deposit_rumors): each kept edge adds its sender's new-rumor row to the
// destination's per-rumor arrival counts.  The same kernel serves any
// width and any int32 values (PushSum's fixed-point limbs reuse it with a
// one-deep slot axis).  Replaces the TPU kernel
// gossip_simulator_tpu/ops/pallas_deliver.py fused_deposit_rows
// (_deposit_kernel, width w), a serial lane loop.
//
// Bound on the H100: bytes.  Each lane reads 8 bytes of slot and dst, and
// an in-range lane its 4*w bytes of values; each touched (cell, column) is
// read and written once, at random cells.  At the multi-rumor run's shape
// 80 % of the lanes are out of range (a fifth of the rows send), and at
// PushSum's drain chunk every lane adds 12 limbs through L2 atomics, whose
// rate (~1.2e11 adds a second) is the floor there.  Design, warp-compacted
// lanes (csrc/lanes.cuh, shared with fused_deposit_both): each warp loads
// the slots and dsts of BATCH consecutive lanes, 32 a round with coalesced
// loads, ballots the in-range ones and lists them (lane, cell offset) in
// shared memory in lane order; an out-of-range lane costs its two loads
// and a ballot bit.  Then the warp walks the listed lanes' rows as one run
// of count * w (lane, column) elements, STAGE at a time: it stages their
// values in shared memory, 16 bytes a thread where w % 4 == 0 and vals is
// 16-byte aligned (a piece never straddles two rows; else a word a
// thread), and adds them with one thread an element, so the 32 adds of a
// warp instruction fall on neighbouring columns of a few rows (a thread a
// lane, or a few threads a lane each adding four columns, spread an
// instruction's adds over as many rows and L2 sectors).  Each nonzero
// value is one atomicAdd whose result is unused (a RED) at the 64-bit
// offset (slot*n + dst)*w + c: skipping a zero adds nothing, so the result
// is the same, and integer adds commute, so the order of the atomics does
// not matter.
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the launch.

#include "lanes.cuh"

#define STAGE 512  // value words a warp stages at a time (a multiple of 4)
#define W_MAX (1 << 22)  // BATCH * w + STAGE elements stay within int32

namespace {

__global__ void __launch_bounds__(THREADS)
deposit_rows(int32_t* __restrict__ pending, const int32_t* __restrict__ slots,
             const int32_t* __restrict__ dst,
             const int32_t* __restrict__ vals, long long m, int b,
             long long n, int w, bool vec4) {
  __shared__ int s_lane[WARPS][BATCH];
  __shared__ long long s_cell[WARPS][BATCH];
  __shared__ int4 s_val4[WARPS][STAGE / 4];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long base = ((long long)blockIdx.x * WARPS + wid) * BATCH;
  const int count = listing::lanes(slots, dst, nullptr, base, m, b, n, w,
                                   s_lane[wid], s_cell[wid]);
  const int* lanes = s_lane[wid];
  const long long* cells = s_cell[wid];
  int* val = reinterpret_cast<int*>(s_val4[wid]);
  const int total = count * w;
  for (int e0 = 0; e0 < total; e0 += STAGE) {
    const int span = min(STAGE, total - e0);
    if (vec4) {
      const int q = w >> 2;
      for (int j = lane; j < span / 4; j += 32) {
        const int pe = e0 / 4 + j;
        const int k = pe / q;
        s_val4[wid][j] = reinterpret_cast<const int4*>(
            vals + (base + lanes[k]) * w)[pe - k * q];
      }
    } else {
      for (int j = lane; j < span; j += 32) {
        const int e = e0 + j;
        const int k = e / w;
        val[j] = vals[(base + lanes[k]) * w + (e - k * w)];
      }
    }
    __syncwarp();
    for (int j = lane; j < span; j += 32) {
      const int x = val[j];
      if (x != 0) {
        const int e = e0 + j;
        const int k = e / w;
        atomicAdd(pending + cells[k] + (e - k * w), x);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// pending: int32[b * n * w], updated in place; slots, dst: int32[m];
// vals: int32[m * w]; w <= W_MAX.
extern "C" int gossip_fused_deposit_rows(void* pending, const void* slots,
                                         const void* dst, const void* vals,
                                         long long m, int b, long long n,
                                         int w, void* stream) {
  if (m < 0 || b < 0 || n < 0 || w < 1 || w > W_MAX)
    return (int)cudaErrorInvalidValue;
  if (m > 0 && b > 0 && n > 0) {
    const bool vec4 = w % 4 == 0 && (uintptr_t)vals % 16 == 0;
    const long long per_block = (long long)WARPS * BATCH;
    const long long blocks = (m + per_block - 1) / per_block;
    deposit_rows<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)pending, (const int32_t*)slots, (const int32_t*)dst,
        (const int32_t*)vals, m, b, n, w, vec4);
  }
  return (int)cudaGetLastError();
}
