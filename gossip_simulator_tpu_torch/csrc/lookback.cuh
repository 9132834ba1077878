// lookback.cuh: the single-pass append that fused_recv_land,
// fused_ring_append and fused_emit share -- one launch a call, positions
// deterministic.
//
// Each item i that survives (a valid lane, or a sender's reservation, of
// its window slot s) takes, with weight w[i] (1 for a lane, the kept lanes
// of a sender for fused_emit):
//
//   pos[i] = cnt[s] + sum of w[j] over surviving items j < i of slot s
//
// and lands when pos (+ w[i] for a reservation) fits under cap.  A block
// holds a tile of consecutive items:
//   - its logical index is a ticket from an atomic counter (ticket), so the
//     blocks before it have started and a look-back never waits on a block
//     that is not resident;
//   - rank_tile: each warp takes 32 * N consecutive items of the tile, 32
//     a round, and ranks each item among the warp's survivors of its slot so
//     far (__match_any_sync, a popcount and the warp's running per-slot
//     counts in shared memory; rank_tile_weighted: the weights of the
//     item's group's lower lanes, shuffled in one at a time); then the
//     warps' counts are scanned per slot;
//   - look_back: the block publishes its per-slot counts (flag A; block 0
//     its inclusive prefix, flag P), then each warp looks back over the
//     preceding blocks for its slots, 32 at a time, summing counts down to
//     the nearest inclusive prefix, and publishes its own (P).  The sum over
//     the preceding blocks does not depend on timing (Merrill and Garland's
//     decoupled look-back);
//   - stage / copy_rows: the landed lanes' wide rows go through a list in
//     shared memory, neighbouring threads on neighbouring 16-byte pieces of
//     a row (or words where a row is not a whole number of aligned pieces);
//   - last_to_finish / settle: the last block to finish (a done counter)
//     reads the per-slot totals from the last logical block's inclusive
//     prefix, adds min(total, cap - cnt) to cnt (after every block has read
//     the carried cnt), the rest to dropped, and resets the counters.  The
//     caller then writes the trash cell once if fewer than m lanes landed:
//     the serial kernel it replaces stores 0 there for every lane that does
//     not land, so one write gives the same bits.  (fused_emit's totals are
//     sums over its reservations that do fit, which the totals cannot give:
//     it adds them into the head's sums, which its last block reads out.)
//
// Workspace (int64[ws_words], kept by ops/deliver.py per card and stream,
// shared by the three kernels: calls on one stream run in order): word 0
// holds the ticket and done counters (uint32 each), words 1 .. WS_HEAD - 1
// the caller's own int32 sums (sums(): DW_LIMIT per-slot sums, DW_LIMIT
// more, then two); the kernels leave all of them at 0 for the next call.
// From word WS_HEAD on, one look-back word per (logical block, slot):
// (epoch << 2 | flag) in the high half, the count in the low.  These are
// never zeroed: each call carries a new epoch (1 .. EPOCH_MAX - 1; the
// wrapper zeroes the workspace when it wraps), and a word of another epoch
// reads as not yet published.
//
// Two forms, by the ring's depth dw:
//   - dw <= DW_LIMIT (the shared form): the per-slot tables are the
//     caller's dynamic shared array of (2 * WARPS + 2) * dw int32, cut by
//     carve(), set by allow_smem (smem.cuh); a block takes one tile;
//   - dw > DW_LIMIT (the global form): the tables would not fit in shared
//     memory, so they live in the workspace's second part (int32[aux_ints],
//     kept beside the first by ops/deliver.py): aux_sums(dw) int32 sums
//     (2 * dw + 2 of them, zeroed by the wrapper before the call: a call
//     of another depth or grid may have left its tables there) that take
//     the place of the head's, then one table set a block of a grid of
//     at most GLOBAL_GRID blocks, each block taking tiles by ticket until
//     none is left (a block waits only on tiles whose tickets were taken
//     before its own, by running blocks, so the loop cannot deadlock).
//     The ranks, the look-back and the settling are the shared form's,
//     read and written through global memory.
// The staged rows' list is static shared memory in both forms.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "smem.cuh"

#define DW_LIMIT 1024  // ops/deliver.py RING_SLOTS_MAX
#define THREADS 256
#define WARPS (THREADS / 32)
#define ITEMS 8
#define TILE (THREADS * ITEMS)  // ops/deliver.py APPEND_TILE
#define WS_HEAD (DW_LIMIT + 2)  // ops/deliver.py APPEND_WS_HEAD
#define GLOBAL_GRID 264  // ops/deliver.py APPEND_GLOBAL_GRID: 2 a card's SM
#define EPOCH_MAX (1 << 30)  // ops/deliver.py APPEND_EPOCH_MAX
#define FLAG_A 1u
#define FLAG_P 2u
#define FULL_MASK 0xffffffffu

namespace lookback {

typedef unsigned long long u64;

// The dynamic shared memory of one tile, by slot.
struct Slots {
  int* warp;  // [WARPS][dw] each warp's counts
  int* pre;   // [WARPS][dw] their prefixes within the block
  int* run;   // [dw] the block's counts
  int* aux;   // [dw] the exclusive prefix over earlier blocks (the caller
              // may use it before look_back)
};

__host__ __device__ inline size_t slots_bytes(int dw) {
  return (size_t)(2 * WARPS + 2) * dw * sizeof(int);
}

// The global form's second part: its int32 sums (rounded up to 4 int32,
// so the tables start 16-byte aligned), then a table set a block.
__host__ __device__ inline long long aux_sums(int dw) {
  return ((long long)2 * dw + 2 + 3) / 4 * 4;
}

__host__ __device__ inline long long aux_ints(int dw, long long nb) {
  const long long grid = nb < GLOBAL_GRID ? nb : GLOBAL_GRID;
  return aux_sums(dw) + grid * (long long)(slots_bytes(dw) / sizeof(int));
}

// The tables of this block: the dynamic shared array, or (GLB) the block's
// set in the second part.
template <bool GLB>
__device__ __forceinline__ int* tables(int* smem, int* aux, int dw) {
  if (!GLB) return smem;
  return aux + aux_sums(dw)
         + (long long)blockIdx.x * (long long)(slots_bytes(dw) / sizeof(int));
}

// The caller's int32 sums and their stride (the per-slot runs' length):
// the head's (DW_LIMIT) in the shared form, the second part's (dw) in the
// global one.
template <bool GLB>
__device__ __forceinline__ int* acc_sums(u64* ws, int* aux) {
  return GLB ? aux : reinterpret_cast<int*>(ws + 1);
}

__device__ __forceinline__ Slots carve(int* smem, int dw) {
  Slots s;
  s.warp = smem;
  s.pre = s.warp + WARPS * dw;
  s.run = s.pre + WARPS * dw;
  s.aux = s.run + dw;
  return s;
}

__device__ __forceinline__ u64 load_word(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ void store_word(u64* p, unsigned epoch,
                                           unsigned flag, int value) {
  *reinterpret_cast<volatile u64*>(p) =
      ((u64)((epoch << 2) | flag) << 32) | (unsigned)value;
}

// The block's logical index, from the ticket counter; zeroes the warps'
// counts and the staged-row count first (one barrier for all of it).
__device__ __forceinline__ long long ticket(u64* ws, const Slots& sl, int dw,
                                            int* s_nok) {
  __shared__ unsigned s_blk;
  if (threadIdx.x == 0) {
    s_blk = atomicAdd(reinterpret_cast<unsigned*>(ws), 1u);
    *s_nok = 0;
  }
  for (int j = threadIdx.x; j < WARPS * dw; j += THREADS) sl.warp[j] = 0;
  __syncthreads();
  return s_blk;
}

// The warps' per-slot counts (sl.warp) scanned over the warps: each
// item's rank gains its warp's prefix, and sl.run gets the block's counts.
template <int N>
__device__ __forceinline__ void scan_warps(const int (&slot)[N],
                                           int (&rank)[N], const Slots& sl,
                                           int dw) {
  const int wid = threadIdx.x >> 5;
  __syncthreads();
  for (int j = threadIdx.x; j < dw; j += THREADS) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = sl.warp[w * dw + j];
      sl.pre[w * dw + j] = run;
      run += c;
    }
    sl.run[j] = run;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < N; ++r)
    if (rank[r] >= 0) rank[r] += sl.pre[wid * dw + slot[r]];
}

// rank[r] >= 0 marks a surviving lane (round r of this thread), slot[r] its
// slot; on return rank[r] is its rank among the block's survivors of that
// slot, in lane order (-1 stays -1), and sl.run holds the block's per-slot
// counts.
template <int N>
__device__ __forceinline__ void rank_tile(const int (&slot)[N],
                                          int (&rank)[N], const Slots& sl,
                                          int dw) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* my_cnt = sl.warp + wid * dw;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const bool v = rank[r] >= 0;
    const int s = slot[r];
    const unsigned grp = __match_any_sync(FULL_MASK, v ? s : -1);
    const int before = v ? my_cnt[s] : 0;
    __syncwarp();
    if (v && (grp >> lane) == 1u) my_cnt[s] = before + __popc(grp);
    __syncwarp();
    rank[r] = v ? before + __popc(grp & below) : -1;
  }
  scan_warps(slot, rank, sl, dw);
}

// As rank_tile, each surviving item weighing weight[r] >= 0: on return
// rank[r] is the sum of the weights of the block's earlier survivors of
// its slot, and sl.run the block's per-slot weight sums.  Within a round a
// lane adds the weights of its group's lower lanes one at a time, so a
// round costs as many shuffles as its largest group has lanes.
template <int N>
__device__ __forceinline__ void rank_tile_weighted(const int (&slot)[N],
                                                   const int (&weight)[N],
                                                   int (&rank)[N],
                                                   const Slots& sl, int dw) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* my_cnt = sl.warp + wid * dw;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const bool v = rank[r] >= 0;
    const int s = slot[r];
    const unsigned grp = __match_any_sync(FULL_MASK, v ? s : -1);
    unsigned rest = v ? grp & below : 0u;
    int pre = 0;
    for (int it = __reduce_max_sync(FULL_MASK, __popc(rest)); it > 0; --it) {
      const int w = __shfl_sync(FULL_MASK, weight[r],
                                rest ? __ffs(rest) - 1 : lane);
      if (rest) {
        pre += w;
        rest &= rest - 1u;
      }
    }
    const int before = v ? my_cnt[s] : 0;
    __syncwarp();
    if (v && (grp >> lane) == 1u) my_cnt[s] = before + pre + weight[r];
    __syncwarp();
    rank[r] = v ? before + pre : -1;
  }
  scan_warps(slot, rank, sl, dw);
}

// Publish the block's counts, resolve each slot's survivors over the
// preceding blocks into sl.aux, a warp a slot, and publish the block's
// inclusive prefix.
__device__ __forceinline__ void look_back(u64* ws, long long blk, int dw,
                                          unsigned epoch, const Slots& sl) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  u64* state = ws + WS_HEAD;
  u64* mine = state + blk * dw;
  for (int j = threadIdx.x; j < dw; j += THREADS)
    store_word(&mine[j], epoch, blk == 0 ? FLAG_P : FLAG_A, sl.run[j]);
  __syncthreads();  // the caller's use of sl.aux is over
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
      sl.aux[j] = excl;
      if (blk != 0) store_word(&mine[j], epoch, FLAG_P, excl + sl.run[j]);
    }
  }
  __syncthreads();
}

// Put a landed lane (`src` lanes into the tile) on the block's list of rows
// to copy, at ring row `row`; called by a whole warp, `ok` per lane.
__device__ __forceinline__ void stage(bool ok, int src, long long row,
                                      int* s_nok, int* s_src,
                                      long long* s_row) {
  const int lane = threadIdx.x & 31;
  const unsigned okm = __ballot_sync(FULL_MASK, ok);
  int base = 0;
  if (lane == 0 && okm) base = atomicAdd(s_nok, __popc(okm));
  base = __shfl_sync(FULL_MASK, base, 0);
  if (ok) {
    const int k = base + __popc(okm & ((1u << lane) - 1u));
    s_src[k] = src;
    s_row[k] = row;
  }
}

// Copy the n staged rows of w1 int32 from src (the tile's lanes from tile0
// on) to their rows of dst: 16 bytes a thread when vec4 (w1 % 4 == 0 and
// both pointers 16-byte aligned), else a word.
__device__ __forceinline__ void copy_rows(int32_t* __restrict__ dst,
                                          const int32_t* __restrict__ src,
                                          const int* s_src,
                                          const long long* s_row, int n,
                                          int w1, bool vec4,
                                          long long tile0) {
  if (vec4) {
    const int q = w1 >> 2;
    const int n_vecs = n * q;
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int e = threadIdx.x; e < n_vecs; e += THREADS) {
      const int k = e / q;
      const int c = e - k * q;
      d4[s_row[k] * q + c] = s4[(tile0 + s_src[k]) * q + c];
    }
  } else {
    const int n_words = n * w1;
    for (int e = threadIdx.x; e < n_words; e += THREADS) {
      const int k = e / w1;
      const int c = e - k * w1;
      dst[s_row[k] * w1 + c] = src[(tile0 + s_src[k]) * w1 + c];
    }
  }
}

// True in the last block to finish (after every block's writes and reads
// of cnt); every thread calls it.
__device__ __forceinline__ bool last_to_finish(u64* ws) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(reinterpret_cast<unsigned*>(ws) + 1, 1u)
             == gridDim.x - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// In the last block: the ticket and done counters back to 0.
__device__ __forceinline__ void reset_counters(u64* ws) {
  if (threadIdx.x == 0) {
    unsigned* ctr = reinterpret_cast<unsigned*>(ws);
    ctr[0] = 0;
    ctr[1] = 0;
  }
}

// The head's int32 sums of the caller's own, after the counters: 2 *
// DW_LIMIT + 2 cells, all 0 between calls.
__device__ __forceinline__ int* sums(u64* ws) {
  return reinterpret_cast<int*>(ws + 1);
}

// In the last block: cnt[j] += the landed lanes of slot j, dropped += the
// lanes past the capacity, the counters reset; returns the landed lanes.
// nb: the call's logical blocks (tiles).
__device__ __forceinline__ long long settle(u64* ws, int32_t* cnt,
                                            int32_t* dropped, int dw,
                                            long long cap, long long nb) {
  __shared__ unsigned long long s_landed, s_lost;
  if (threadIdx.x == 0) {
    s_landed = 0;
    s_lost = 0;
  }
  __syncthreads();
  const u64* last = ws + WS_HEAD + (nb - 1) * dw;
  for (int j = threadIdx.x; j < dw; j += THREADS) {
    const long long total = (unsigned)load_word(&last[j]);
    const long long c = cnt[j];
    const long long room = cap - c;
    const long long ok = room <= 0 ? 0 : (room < total ? room : total);
    cnt[j] = (int32_t)(c + ok);
    atomicAdd(&s_landed, (unsigned long long)ok);
    atomicAdd(&s_lost, (unsigned long long)(total - ok));
  }
  __syncthreads();
  const long long landed = (long long)s_landed;
  if (threadIdx.x == 0) *dropped += (int32_t)s_lost;
  reset_counters(ws);
  return landed;
}

// The C entry points' checks of the workspace and epoch, for m items in
// tiles of `tile` (and, past DW_LIMIT slots, of the second part).
inline cudaError_t check_ws(long long m, int dw, const void* ws,
                            long long ws_words, int epoch, const void* aux,
                            long long aux_words, int tile = TILE) {
  if (epoch < 1 || epoch >= EPOCH_MAX) return cudaErrorInvalidValue;
  const long long nb = m > 0 ? (m + tile - 1) / tile : 1;
  if (ws == nullptr || ws_words < WS_HEAD + nb * dw)
    return cudaErrorInvalidValue;
  if (dw > DW_LIMIT && (aux == nullptr || aux_words < aux_ints(dw, nb)))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The grid of a call of nb tiles: a block a tile in the shared form, at
// most GLOBAL_GRID blocks in the global one.
inline unsigned grid_of(long long nb, int dw) {
  return (unsigned)(dw > DW_LIMIT && nb > GLOBAL_GRID ? GLOBAL_GRID : nb);
}

}  // namespace lookback
