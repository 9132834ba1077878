// fused_recv_land: land one shard's routed wire words in its mail ring, in
// one call over m lanes (the sharded backend's receive side):
//
//   decode         r = recv[i]; empty slot when r < 0, else
//                  d = r / (dw*b), w = (r / b) % dw, o = r % b
//   duplicates     (with flags) a lane whose destination already has the
//                  received bit is dropped and counted in sup[w]
//   position       pos[i] = cnt[w] + number of surviving lanes j < i with
//                  the same slot (lane order)
//   capacity       ok = survives && pos < cap
//   ring write     ring0[w*cap + pos] = d*b + o (and ring1's row at the
//                  same position = words' row i) when ok, else 0 at the
//                  trash cell dw*cap (a zero row of ring1) -- empty wire
//                  slots included
//   counts         cnt[w] += ok lanes of slot w; dropped += survives && !ok
//
// Replaces the TPU kernel gossip_simulator_tpu/ops/pallas_megakernel.py
// fused_recv_land (_recv_kernel), one serial loop over lanes whose
// per-slot counter gives each lane its position.  Here the same positions
// come from a deterministic parallel scan, as in csrc/fused_ring_append.cu
// (never from the order atomics happen to run in):
//
//   pass 1 (recv_count)  decode and filter; per-block per-slot totals of
//                        surviving lanes into block_sums[nb, dw], and the
//                        duplicate counts into sup (integer sums: shared
//                        and global atomics are exact for them);
//   pass 2 (recv_scan)   one block per slot: exclusive scan of block_sums
//                        over blocks, in place;
//   pass 3 (recv_write)  decode and filter again, intra-block exclusive
//                        scan of the one-hot per-slot survivor flags (warp
//                        shuffles over groups of DWM slots), position,
//                        verdict and the ring writes; ok and lost counts
//                        are integer sums into adds/lost;
//   pass 4 (recv_finish) cnt += adds, dropped += lost -- after every lane
//                        has read the carried cnt.
//
// Widths: dw <= DW_LIMIT slots (per-block slot sums and warp prefixes in
// dynamic shared memory, 4 * 9 * dw bytes in pass 3); the register scan
// runs over groups of DWM = 8 slots (dw <= 8, the usual dw = 3) or 32.
// The companion ring ring1 is int32[L, w1] (PushSum's mass limbs, w1 =
// (dim + 1) * 4); a lane writes its whole words row; row offsets are
// 64-bit.
//
// Every ok lane owns its cell; every other lane writes 0 to the one trash
// cell, so their order is harmless, and the trash cell is left as it was
// when every lane is ok.
//
// Bound on the H100: bytes.  At the sharded event path's shape (m = S x
// chernoff_cap = 8 x 25,831 lanes, dw = 3, flags) a call reads 4 B of
// wire word and ~1 B of flag per lane and writes 4 B per landed entry,
// ~2 MB (~0.6 us at 3.35 TB/s); four launches of latency dominate.  With
// PushSum's 12 mass columns a lane also reads and writes 48 B.
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the last launch.

#include <cuda_runtime.h>
#include <cstdint>

#define DW_LIMIT 1024  // ops/deliver.py RING_SLOTS_MAX
#define DW_SMALL 8  // the register-scan group width for dw <= 8
#define DW_GROUP 32  // the register-scan group width above it
#define THREADS 256
#define WARPS (THREADS / 32)
#define SCAN_THREADS 1024
#define FULL_MASK 0xffffffffu

namespace {

struct Lane {
  bool live;  // a wire word that survives the duplicate filter
  int slot;
  int32_t entry;  // d * b + o
};

// Decode lane i and apply the duplicate filter; *dup says whether a live
// word was filtered.
__device__ __forceinline__ Lane decode(const int32_t* __restrict__ recv,
                                       const uint8_t* __restrict__ flags,
                                       int i, int dw, int b, int rbit,
                                       bool* dup) {
  const int32_t r = recv[i];
  Lane l;
  l.live = r >= 0;
  const int32_t rc = r < 0 ? 0 : r;
  const int32_t d = rc / (dw * b);
  l.slot = (rc / b) % dw;
  l.entry = d * b + rc % b;
  *dup = false;
  if (l.live && flags != nullptr && (flags[d] & rbit) != 0) {
    *dup = true;
    l.live = false;
  }
  return l;
}

__global__ void recv_count(const int32_t* __restrict__ recv,
                           const uint8_t* __restrict__ flags, int m, int dw,
                           int b, int rbit, int32_t* __restrict__ block_sums,
                           int32_t* __restrict__ sup) {
  extern __shared__ int smem[];
  int* s_tot = smem;       // [dw]
  int* s_sup = smem + dw;  // [dw]
  for (int j = threadIdx.x; j < dw; j += THREADS) s_tot[j] = s_sup[j] = 0;
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < m) {
    bool dup;
    const Lane l = decode(recv, flags, i, dw, b, rbit, &dup);
    if (l.live) atomicAdd(&s_tot[l.slot], 1);
    if (dup) atomicAdd(&s_sup[l.slot], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < dw; j += THREADS) {
    block_sums[(long long)blockIdx.x * dw + j] = s_tot[j];
    if (s_sup[j]) atomicAdd(&sup[j], s_sup[j]);
  }
}

// Exclusive scan of column blockIdx.x of block_sums[nb, dw], in place.
__global__ void recv_scan(int32_t* __restrict__ block_sums, int nb, int dw) {
  __shared__ int warp_tot[SCAN_THREADS / 32];
  const int s = blockIdx.x;
  const int per = (nb + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(threadIdx.x * per, nb);
  const int hi = min(lo + per, nb);
  int local = 0;
  for (int j = lo; j < hi; ++j) local += block_sums[(long long)j * dw + s];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    const int t = warp_tot[lane];
    int z = t;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, z, o);
      if (lane >= o) z += y;
    }
    warp_tot[lane] = z - t;
  }
  __syncthreads();
  int run = warp_tot[wid] + x - local;
  for (int j = lo; j < hi; ++j) {
    const long long c = (long long)j * dw + s;
    const int t = block_sums[c];
    block_sums[c] = run;
    run += t;
  }
}

template <int DWM>
__global__ void recv_write(int32_t* __restrict__ ring0,
                           int32_t* __restrict__ ring1,
                           const int32_t* __restrict__ recv,
                           const int32_t* __restrict__ words,
                           const uint8_t* __restrict__ flags,
                           const int32_t* __restrict__ cnt, int m, int dw,
                           int cap, int b, int w1, int rbit,
                           const int32_t* __restrict__ block_sums,
                           int32_t* __restrict__ adds,
                           int32_t* __restrict__ lost) {
  extern __shared__ int smem[];
  int* warp_pre = smem;             // [WARPS][dw]
  int* s_adds = smem + WARPS * dw;  // [dw]
  __shared__ int s_lost;
  for (int j = threadIdx.x; j < dw; j += THREADS) s_adds[j] = 0;
  if (threadIdx.x == 0) s_lost = 0;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool in = i < m;
  bool dup = false;
  Lane l = {false, 0, 0};
  if (in) l = decode(recv, flags, i, dw, b, rbit, &dup);
  const bool v = l.live;
  const int s = l.slot;
  // Warp-inclusive scan of the one-hot per-slot survivor flags, DWM slots
  // at a time.
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = 0;
  for (int g0 = 0; g0 < dw; g0 += DWM) {
    int val[DWM];
#pragma unroll
    for (int d = 0; d < DWM; ++d) val[d] = (v && s == g0 + d) ? 1 : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int d = 0; d < DWM; ++d) {
        const int y = __shfl_up_sync(FULL_MASK, val[d], o);
        if (lane >= o) val[d] += y;
      }
    }
#pragma unroll
    for (int d = 0; d < DWM; ++d) {
      if (lane == 31 && g0 + d < dw) warp_pre[wid * dw + g0 + d] = val[d];
      if (g0 + d == s) incl = val[d];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < dw; j += THREADS) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int t = warp_pre[w * dw + j];
      warp_pre[w * dw + j] = run;
      run += t;
    }
  }
  __syncthreads();
  if (in) {
    bool ok = false;
    long long pos = 0;
    if (v) {
      pos = (long long)cnt[s] + block_sums[(long long)blockIdx.x * dw + s]
            + warp_pre[wid * dw + s] + incl - 1;
      ok = pos < cap;
      if (ok) atomicAdd(&s_adds[s], 1);
      else atomicAdd(&s_lost, 1);
    }
    const long long flat = ok ? (long long)s * cap + pos : (long long)dw * cap;
    ring0[flat] = ok ? l.entry : 0;
    if (ring1 != nullptr) {
      int32_t* row = ring1 + flat * w1;
      const int32_t* src = words + (long long)i * w1;
      for (int c = 0; c < w1; ++c) row[c] = ok ? src[c] : 0;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < dw; j += THREADS)
    if (s_adds[j]) atomicAdd(&adds[j], s_adds[j]);
  if (threadIdx.x == 0 && s_lost) atomicAdd(lost, s_lost);
}

__global__ void recv_finish(int32_t* __restrict__ cnt,
                            int32_t* __restrict__ dropped,
                            const int32_t* __restrict__ adds,
                            const int32_t* __restrict__ lost, int dw) {
  for (int j = threadIdx.x; j < dw; j += blockDim.x) cnt[j] += adds[j];
  if (threadIdx.x == 0) *dropped += *lost;
}

}  // namespace

// Scratch (zeroed by the caller): block_sums int32[ceil(m/256) * dw], then
// adds int32[dw], then lost int32[1]; sup int32[dw] zeroed by the caller.
// ring1/words may be null (no word rows; w1 is then ignored); flags may be
// null (no duplicate filter).
extern "C" int gossip_fused_recv_land(
    void* ring0, void* ring1, const void* recv, const void* words,
    const void* flags, void* cnt, int m, int dw, int cap, int b, int w1,
    int rbit, void* dropped, void* sup, void* scratch, void* stream) {
  if (dw < 1 || dw > DW_LIMIT || b < 1) return (int)cudaErrorInvalidValue;
  if ((ring1 == nullptr) != (words == nullptr)) return (int)cudaErrorInvalidValue;
  if (ring1 != nullptr && w1 < 1) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = (m + THREADS - 1) / THREADS;
  int32_t* block_sums = (int32_t*)scratch;
  int32_t* adds = block_sums + (long long)nb * dw;
  int32_t* lost = adds + dw;
  recv_count<<<nb, THREADS, 2 * dw * sizeof(int), st>>>(
      (const int32_t*)recv, (const uint8_t*)flags, m, dw, b, rbit,
      block_sums, (int32_t*)sup);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recv_scan<<<dw, SCAN_THREADS, 0, st>>>(block_sums, nb, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto write = dw <= DW_SMALL ? recv_write<DW_SMALL> : recv_write<DW_GROUP>;
  write<<<nb, THREADS, (WARPS + 1) * dw * sizeof(int), st>>>(
      (int32_t*)ring0, (int32_t*)ring1, (const int32_t*)recv,
      (const int32_t*)words, (const uint8_t*)flags, (const int32_t*)cnt, m,
      dw, cap, b, w1, rbit, block_sums, adds, lost);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recv_finish<<<1, 256, 0, st>>>((int32_t*)cnt, (int32_t*)dropped, adds,
                                 lost, dw);
  return (int)cudaGetLastError();
}
