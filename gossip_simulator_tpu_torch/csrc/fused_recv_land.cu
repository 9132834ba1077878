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
//                  same position = words' row i) when ok
//   trash          the trash cell ring0[dw*cap] (and ring1's row there) is
//                  set to 0 when some lane -- empty wire slots included --
//                  is not ok, and keeps its value when every lane is ok
//   counts         cnt[w] += ok lanes of slot w; dropped += survives && !ok
//
// Replaces the TPU kernel gossip_simulator_tpu/ops/pallas_megakernel.py
// fused_recv_land (_recv_kernel), one serial loop over lanes whose
// per-slot counter gives each lane its position and whose every non-ok
// lane stores 0 to the trash cell (so the cell ends at 0 iff some lane is
// not ok: one write a call gives the same bits).
//
// Bound on the H100: bytes.  The sharded event path's batch (m = S x
// chernoff_cap = 8 x 25,831 lanes, dw = 3) moves ~1 MB (~0.5 us); what it
// costs is the host's enqueue and the launches, so the call is one launch
// with no allocation or fill: positions come from a single-pass scan with
// decoupled look-back (Merrill and Garland) over per-(block, slot)
// survivor counts.  PushSum's window (8 x 4,375,000 lanes, 12 word
// columns, ~21 % of the lanes live) must read each wire word and move each
// landed row (~1 GB, 0.30 ms); there the trash stores (13 a non-ok lane,
// all to one 52-byte spot) and the one-thread-a-lane row copies were the
// cost, so the trash is written once a call and a block copies its landed
// rows through a staged list in shared memory (neighbouring threads on
// neighbouring 16-byte pieces of a row, or words where a row is not a
// whole number of aligned pieces), reading words only for lanes that
// land.
//
// One kernel, recv_land, a tile of TILE lanes a block:
//   - the block's logical index is a ticket from an atomic counter, so the
//     blocks before it have started (the look-back cannot wait on a block
//     that is not resident);
//   - each warp takes 32 * ITEMS consecutive lanes of the tile, 32 a
//     round: decode, filter, the lane's rank among the warp's survivors of
//     its slot so far (__match_any_sync, a popcount and the warp's running
//     per-slot counts in shared memory); then the warps' counts are
//     scanned per slot (two block barriers a tile); per-slot duplicate
//     counts accumulate in shared memory;
//   - publish the block's per-slot survivor counts (flag A; block 0 its
//     inclusive prefix, flag P), then each warp looks back over the
//     preceding blocks for its slots, 32 at a time, summing counts down to
//     the nearest inclusive prefix, and publishes its own (P).  The sum
//     over the preceding blocks does not depend on timing, so positions
//     are deterministic;
//   - ring0 writes, the landed lanes staged as (source lane, ring row),
//     then the rows copied piece by piece;
//   - the duplicate counts added into the workspace's sup cells; the last
//     block to finish (a done counter) reads the per-slot totals from the
//     last logical block's inclusive prefix, adds min(total, cap - cnt) to
//     cnt (after every block has read the carried cnt), the rest to
//     dropped, writes all of sup, zeroes the trash cell and its row once
//     if fewer than m lanes landed, and resets the counters.
//
// Workspace (int64[ws_words], kept by the wrapper per device and stream):
// word 0 holds the ticket and done counters (uint32 each), words 1 ..
// DW_LIMIT/2 the int32 sup sums; the kernel leaves all of them at 0 for
// the next call.  From word WS_HEAD on, one look-back word per (logical
// block, slot): (epoch << 2 | flag) in the high half, the count in the
// low.  These are never zeroed: each call carries a new epoch (1 ..
// EPOCH_MAX - 1; the wrapper zeroes the workspace when it wraps), and a
// word of another epoch reads as not yet published.
//
// Widths: dw <= DW_LIMIT slots (2 * WARPS + 2 int32 a slot of dynamic
// shared memory); ring1 is int32[L, w1] (PushSum's mass limbs); row
// offsets are 64-bit.
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cstdint>

#define DW_LIMIT 1024  // ops/deliver.py RING_SLOTS_MAX
#define THREADS 256
#define WARPS (THREADS / 32)
#define ITEMS 8
#define TILE (THREADS * ITEMS)  // ops/megakernel.py RECV_TILE
#define WS_HEAD (1 + DW_LIMIT / 2)  // ops/megakernel.py RECV_WS_HEAD
#define EPOCH_MAX (1 << 30)  // ops/megakernel.py RECV_EPOCH_MAX
#define FLAG_A 1u
#define FLAG_P 2u
#define FULL_MASK 0xffffffffu

namespace {

typedef unsigned long long u64;

__device__ __forceinline__ u64 load_word(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ void store_word(u64* p, unsigned epoch,
                                           unsigned flag, int value) {
  *reinterpret_cast<volatile u64*>(p) =
      ((u64)((epoch << 2) | flag) << 32) | (unsigned)value;
}

__global__ void __launch_bounds__(THREADS)
recv_land(int32_t* __restrict__ ring0, int32_t* __restrict__ ring1,
          const int32_t* __restrict__ recv, const int32_t* __restrict__ words,
          const uint8_t* __restrict__ flags, int32_t* __restrict__ cnt,
          long long m, int dw, long long cap, int b, int w1, bool vec4,
          int rbit,
          int32_t* __restrict__ dropped, int32_t* __restrict__ sup,
          u64* __restrict__ ws, unsigned epoch) {
  extern __shared__ int smem[];
  int* s_warp = smem;                // [WARPS][dw] each warp's counts
  int* s_pre = s_warp + WARPS * dw;  // [WARPS][dw] their block prefixes
  int* s_run = s_pre + WARPS * dw;   // [dw] the block's counts
  int* s_sup = s_run + dw;           // [dw] duplicates; then the excl. prefix
  __shared__ int s_src[TILE];
  __shared__ long long s_row[TILE];
  __shared__ unsigned s_blk;
  __shared__ int s_nok, s_last;
  __shared__ long long s_landed, s_lost;
  unsigned* ctr = reinterpret_cast<unsigned*>(ws);  // ticket, done
  int* sup_acc = reinterpret_cast<int*>(ws + 1);
  u64* state = ws + WS_HEAD;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const unsigned below = (1u << lane) - 1u;

  if (t == 0) {
    s_blk = atomicAdd(&ctr[0], 1u);
    s_nok = 0;
  }
  for (int j = t; j < dw; j += THREADS) s_run[j] = s_sup[j] = 0;
  for (int j = t; j < WARPS * dw; j += THREADS) s_warp[j] = 0;
  __syncthreads();
  const long long blk = s_blk;
  const long long tile0 = blk * TILE;

  // Ranks among the block's survivors of each slot, in lane order: warp
  // wid takes the tile's lanes [wid * 32 * ITEMS, (wid + 1) * 32 * ITEMS)
  // in ITEMS rounds of 32, its per-slot running counts in shared memory;
  // then the warps' counts are scanned per slot.
  int* my_cnt = s_warp + wid * dw;
  const long long lane0 = tile0 + wid * (32 * ITEMS) + lane;
  int slot[ITEMS], rank[ITEMS], entry[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)  // all the loads in flight at once
    entry[r] = lane0 + r * 32 < m ? recv[lane0 + r * 32] : -1;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    bool v = false;
    int s = 0, e = 0;
    {
      const int32_t x = entry[r];
      if (x >= 0) {
        const int32_t d = x / (dw * b);
        s = (x / b) % dw;
        e = d * b + x % b;
        v = true;
        if (flags != nullptr && (flags[d] & rbit) != 0) {
          v = false;
          atomicAdd(&s_sup[s], 1);
        }
      }
    }
    const unsigned grp = __match_any_sync(FULL_MASK, v ? s : -1);
    const int before = v ? my_cnt[s] : 0;
    __syncwarp();
    if (v && (grp >> lane) == 1u) my_cnt[s] = before + __popc(grp);
    __syncwarp();
    slot[r] = s;
    entry[r] = e;
    rank[r] = v ? before + __popc(grp & below) : -1;
  }
  __syncthreads();
  for (int j = t; j < dw; j += THREADS) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_warp[w * dw + j];
      s_pre[w * dw + j] = run;
      run += c;
    }
    s_run[j] = run;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    if (rank[r] >= 0) rank[r] += s_pre[wid * dw + slot[r]];

  // Decoupled look-back over the preceding blocks, a warp a slot.
  u64* mine = state + blk * dw;
  for (int j = t; j < dw; j += THREADS)
    store_word(&mine[j], epoch, blk == 0 ? FLAG_P : FLAG_A, s_run[j]);
  for (int j = t; j < dw; j += THREADS)
    if (s_sup[j]) atomicAdd(&sup_acc[j], s_sup[j]);
  __syncthreads();
  int* s_excl = s_sup;  // the duplicate counts are spent
  for (int j = wid; j < dw; j += WARPS) {
    int excl = 0;
    for (long long k = blk - 1; k >= 0; k -= 32) {
      const long long q = k - lane;
      unsigned flag = q < 0 ? FLAG_P : 0u;
      int val = 0;
      while (true) {
        if (flag == 0u) {
          const u64 x = load_word(&state[q * dw + j]);
          const unsigned hi = (unsigned)(x >> 32);
          if ((hi >> 2) == epoch) {
            flag = hi & 3u;
            val = (int)(unsigned)x;
          }
        }
        if (__all_sync(FULL_MASK, flag != 0u)) break;
        __nanosleep(20);
      }
      const unsigned pm = __ballot_sync(FULL_MASK, flag == FLAG_P);
      int add = val;
      if (pm && lane > __ffs(pm) - 1) add = 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        add += __shfl_xor_sync(FULL_MASK, add, o);
      excl += add;
      if (pm) break;
    }
    if (lane == 0) {
      s_excl[j] = excl;
      if (blk != 0) store_word(&mine[j], epoch, FLAG_P, excl + s_run[j]);
    }
  }
  __syncthreads();

  // Positions, the id writes, and the landed lanes staged for their rows.
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    bool ok = false;
    long long row = 0;
    if (rank[r] >= 0) {
      const int s = slot[r];
      const long long pos = (long long)cnt[s] + s_excl[s] + rank[r];
      ok = pos < cap;
      row = s * cap + pos;
      if (ok) ring0[row] = entry[r];
    }
    if (ring1 != nullptr) {
      const unsigned okm = __ballot_sync(FULL_MASK, ok);
      int base = 0;
      if (lane == 0 && okm) base = atomicAdd(&s_nok, __popc(okm));
      base = __shfl_sync(FULL_MASK, base, 0);
      if (ok) {
        const int k = base + __popc(okm & below);
        s_src[k] = (int)(lane0 - tile0) + r * 32;
        s_row[k] = row;
      }
    }
  }
  if (ring1 != nullptr) {
    __syncthreads();
    if (vec4) {  // rows of w1 / 4 aligned int4s
      const int q = w1 >> 2;
      const int n_vecs = s_nok * q;
      int4* dst = reinterpret_cast<int4*>(ring1);
      const int4* src = reinterpret_cast<const int4*>(words);
      for (int e = t; e < n_vecs; e += THREADS) {
        const int k = e / q;
        const int c = e - k * q;
        dst[s_row[k] * q + c] = src[(tile0 + s_src[k]) * q + c];
      }
    } else {
      const int n_words = s_nok * w1;
      for (int e = t; e < n_words; e += THREADS) {
        const int k = e / w1;
        const int c = e - k * w1;
        ring1[s_row[k] * w1 + c] = words[(tile0 + s_src[k]) * w1 + c];
      }
    }
  }

  // The last block to finish: counts, sup, the trash cell, the counters.
  __threadfence();
  __syncthreads();
  if (t == 0) {
    s_last = atomicAdd(&ctr[1], 1u) == gridDim.x - 1;
    s_landed = 0;
    s_lost = 0;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const u64* last = state + (long long)(gridDim.x - 1) * dw;
  for (int j = t; j < dw; j += THREADS) {
    const long long total = (unsigned)load_word(&last[j]);
    const long long c = cnt[j];
    const long long room = cap - c;
    const long long ok = room <= 0 ? 0 : (room < total ? room : total);
    cnt[j] = (int32_t)(c + ok);
    atomicAdd(reinterpret_cast<unsigned long long*>(&s_landed),
              (unsigned long long)ok);
    atomicAdd(reinterpret_cast<unsigned long long*>(&s_lost),
              (unsigned long long)(total - ok));
    volatile int* acc = sup_acc;
    sup[j] = acc[j];
    acc[j] = 0;
  }
  __syncthreads();
  if (s_landed < m) {
    const long long trash = (long long)dw * cap;
    if (t == 0) ring0[trash] = 0;
    if (ring1 != nullptr)
      for (int c = t; c < w1; c += THREADS) ring1[trash * w1 + c] = 0;
  }
  if (t == 0) {
    *dropped += (int32_t)s_lost;
    ctr[0] = 0;
    ctr[1] = 0;
  }
}

}  // namespace

// ring1/words may be null (no word rows; w1 is then ignored); flags may be
// null (no duplicate filter).  sup int32[dw] is written whole.  ws is the
// int64 workspace of at least WS_HEAD + max(1, ceil(m / TILE)) * dw words
// (ws_words), zeroed when it was made; epoch in [1, EPOCH_MAX), new for
// every call that uses ws.
extern "C" int gossip_fused_recv_land(
    void* ring0, void* ring1, const void* recv, const void* words,
    const void* flags, void* cnt, int m, int dw, int cap, int b, int w1,
    int rbit, void* dropped, void* sup, void* ws, long long ws_words,
    int epoch, void* stream) {
  if (dw < 1 || dw > DW_LIMIT || b < 1 || m < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  if ((ring1 == nullptr) != (words == nullptr)) return (int)cudaErrorInvalidValue;
  if (ring1 != nullptr && w1 < 1) return (int)cudaErrorInvalidValue;
  if (epoch < 1 || epoch >= EPOCH_MAX) return (int)cudaErrorInvalidValue;
  const long long nb = m > 0 ? ((long long)m + TILE - 1) / TILE : 1;
  if (ws == nullptr || ws_words < WS_HEAD + nb * dw)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = ring1 != nullptr && w1 % 4 == 0
                    && (uintptr_t)ring1 % 16 == 0
                    && (uintptr_t)words % 16 == 0;
  const size_t shmem = (size_t)(2 * WARPS + 2) * dw * sizeof(int);
  // Past 48 KB the kernel needs the attribute, which belongs to the
  // current device: it is set on every such launch.
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        recv_land, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  recv_land<<<(unsigned)nb, THREADS, shmem, (cudaStream_t)stream>>>(
      (int32_t*)ring0, (int32_t*)ring1, (const int32_t*)recv,
      (const int32_t*)words, (const uint8_t*)flags, (int32_t*)cnt, m, dw, cap,
      b, w1, vec4, rbit, (int32_t*)dropped, (int32_t*)sup, (u64*)ws,
      (unsigned)epoch);
  return (int)cudaGetLastError();
}
