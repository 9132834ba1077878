// fused_chunk_step: one chunk of mailbox delivery, m lanes of (key, s)
// with keys in [0, nk] (nk marks an invalid lane):
//
//   rank          rank[i] = count[key_i] (the carry from earlier chunks) +
//                 number of lanes j < i of this chunk with key_j == key_i
//   verdict       ok = key_i < nk && rank < cap
//   write         mbox[key*cap + rank] (rank*nk + key when rank_major) =
//                 s[i] when ok, else -1 at the trash cell nk*cap
//   counts        count[key] += 1 for every lane, the sentinel included;
//                 overflow ovf = key < nk && rank >= cap:
//   drop form     dropped += ovf
//   spill form    (pairs int32[2, scap + 1], scnt): an overflowing lane's
//                 position is scnt + the number of overflowing lanes
//                 before it in LANE order; fit = position < scap; a
//                 fitting lane writes (s, key) there, every other lane -1
//                 at the trash column scap; scnt += fits, dropped +=
//                 ovf && !fit.
//
// Replaces the TPU kernel gossip_simulator_tpu/ops/pallas_deliver.py
// fused_chunk_step (_chunk_kernel, both forms), one serial loop over lanes
// whose per-key counter is the stable-sort rank of the XLA chain and whose
// spill counter is the lane-order position.  Keys run to nk = 2n (2e7 at
// n = 1e7, 1e8 in the split round), so no block can hold a histogram of
// them, and nothing here is sized by nk: the chunk's live (key, payload)
// pairs (and, in the spill form, their lane ids) are sorted by a stable
// LSD radix sort, and a lane's rank is its sorted position less its run's
// first position, plus the carried count.
//
//   radix passes  bits = bit_length(nk - 1) (24, 25 and 27 at nk = 1e7,
//                 2e7, 1e8), cut into ceil(bits / 10) digits of equal
//                 width (3 passes of 8-9 bits there; at most 1024 bins),
//                 over 4096-lane tiles, deterministic in any block order:
//                 radix_hist (the tile's digit histogram in shared memory,
//                 one shared add per distinct digit of a warp row, written
//                 digit-major), radix_scan (one block per digit: the
//                 exclusive scan of its tile counts in tile order, and the
//                 digit's total) and radix_scatter (each tile ranks its
//                 lanes stably: a warp takes 16 rows of 32 lanes in order,
//                 the lanes of one digit find each other by ballots over
//                 the digit's bits and count the peers below them, the
//                 warps' per-digit counts are scanned in warp order in
//                 shared memory; the tile is put in digit order in shared
//                 memory and written out so that neighbouring threads
//                 write neighbouring addresses).  The first pass reads the
//                 chunk itself and keeps only live lanes (the sentinel
//                 lanes are counted, never sorted) and records their
//                 number L.  A small chunk (at most 64 tiles, 262,144
//                 lanes: the rounds band's 78,125) launches neither
//                 radix_scan nor the later passes' radix_hist: each
//                 scatter block sums the raw tile counts itself, and each
//                 scatter adds its lanes to the next pass's histogram with
//                 integer atomics (one per distinct cell of a warp) where
//                 they land.  Above that size the atomics cost more than
//                 the histogram launch they save (measured on the H100).
//   chunk_write   per sorted position p < L: the run start (a block
//                 max-scan of run heads, and for the run that enters the
//                 block one binary search of the sorted keys), rank =
//                 count[k] + p - start, the verdict and the mailbox write
//                 of the sorted payload (keys ascending, so node-major
//                 writes run forward); overflow goes to a per-block sum
//                 (one integer atomic a block) or, in the spill form, to a
//                 flag at the lane's own position; a run's last lane
//                 stores its key's new count in the free sort buffer.
//   chunk_count   after every lane has read its carried count: the run's
//                 last lane stores count[k] (one plain store per distinct
//                 key), one thread adds the m - L dead lanes to count[nk]
//                 and writes the trash cell when there are any.
//   spill form    the flags, in lane order, go through an inclusive scan
//                 in place (scan_tiles, scan_sums, scan_apply: a
//                 lane-order prefix count, deterministic in any block
//                 order); spill_write writes each fitting lane's pair at
//                 scnt + its exclusive count; spill_finish (one thread)
//                 adds the fits to scnt and the rest to dropped, and
//                 writes -1 to the trash column when some lane did not fit.
//
// Launches at 24-27-bit keys: 11 in the drop form (3 a pass + 2), 6 for a
// small chunk (1 + 3 + 2), + 5 in the spill form, whatever nk.  Scratch,
// from the caller: int32[chunk_scratch_elems(m, spill)], O(m), never
// O(nk).  Device ms a call, by torch.profiler (chip_smoke.py phase 3,
// NVIDIA H100 80GB HBM3, 700 W): the ticks drain (2,097,152 lanes, 25-bit
// keys, 3 passes of 9, 8, 8 bits) 0.337 -- radix_hist 0.042, radix_scan
// 0.006, radix_scatter 0.088 for the 3 passes, chunk_write 0.157,
// chunk_count 0.043; the rounds band (78,125 lanes, 24 bits, 3 passes of
// 8) 0.057 -- radix_scatter 0.038, radix_hist 0.008, chunk_write 0.009,
// chunk_count 0.003; the spill burst (8,388,608 lanes, 27 bits, 3 passes
// of 9) 1.703 -- chunk_write 0.614, radix_scatter 0.595, chunk_count
// 0.187, radix_hist 0.152, radix_scan 0.034, the spill's scan and writes
// 0.122.
//
// Bound on the H100: bytes.  The function must read each lane's key and
// payload (8 B), read and write each touched count cell and write each
// delivered cell; the sort adds ~20 B a live lane a pass (the key 4 B in
// for the histogram; key and payload 8 B in and 8 B out for the scatter),
// in the 50 MB L2 at the drain's 2M lanes.  What it costs beyond that is
// the scattered 4-byte traffic of the count reads and the mailbox and
// count writes, one 32-byte sector each (PERF.md).
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the last launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "scan.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define ITEMS 16
// TILE, RADIX_MAX and PASSES_MAX size the scratch; ops/deliver.py's
// CHUNK_TILE, CHUNK_RADIX_MAX and CHUNK_PASSES_MAX must equal them.
#define TILE (THREADS * ITEMS)  // lanes of a radix tile
#define RADIX_BITS_MAX 10
#define RADIX_MAX (1 << RADIX_BITS_MAX)
#define PASSES_MAX 4  // 31-bit keys in digits of at most 10 bits
#define SMALL_TILES 64  // up to this many tiles, no radix_scan launch
// radix_scatter's shared ints before its digit arrays: the warps' digit
// counts, later the tile's keys and payloads (then lanes) in digit order.
#define STAGE_INTS(radix) \
  (WARPS * (radix) > 2 * TILE ? WARPS * (radix) : 2 * TILE)
#define SCAN_THREADS 1024
#define SCAN_ITEMS 4
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)
#define FULL_MASK 0xffffffffu

namespace {

__device__ __forceinline__ bool live_key(int k, int nk) {
  return k >= 0 && k < nk;
}

// The lanes of this warp row holding a valid lane with digit d, as a mask
// (the caller's own bit included when it is valid): one ballot per digit
// bit.  Every lane of the warp must call it.
__device__ __forceinline__ unsigned digit_peers(bool valid, int d, int bits) {
  unsigned peers = __ballot_sync(FULL_MASK, valid);
  for (int b = 0; b < bits; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned on = __ballot_sync(FULL_MASK, bit);
    peers &= bit ? on : ~on;
  }
  return peers;
}

// Block-wide inclusive max-scan of one value per thread; wmax: int[32].
__device__ int block_incl_max(int v, int* wmax) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v = max(v, y);
  }
  if (lane == 31) wmax[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? wmax[lane] : -1;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, t, o);
      if (lane >= o) t = max(t, y);
    }
    if (lane < nw) wmax[lane] = t;
  }
  __syncthreads();
  return wid > 0 ? max(v, wmax[wid - 1]) : v;
}

// Lane index of item j of this thread in its tile's warp-row layout: warp
// w takes rows of 32 lanes, ITEMS of them, in order.
__device__ __forceinline__ long long tile_lane(int tile, int j) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  return (long long)tile * TILE + wid * (32 * ITEMS) + j * 32 + lane;
}

// Item j of this thread's tile: its key (0 where invalid), payload, lane
// id (with `lj`) and whether it takes part.  The first pass reads the
// chunk itself: a lane takes part when its key is live, and its lane id
// is its index.  Later passes read the L sorted lanes.
template <bool kFirst>
__device__ __forceinline__ void load_items(
    const int32_t* __restrict__ key, const int32_t* __restrict__ val,
    const int32_t* __restrict__ lane_in, int n, int nk, int* kj, int* vj,
    int* lj, bool* ok) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = tile_lane(blockIdx.x, j);
    bool valid = i < n;
    int k = valid ? key[i] : 0;
    if (kFirst) valid = valid && live_key(k, nk);
    kj[j] = valid ? k : 0;
    if (vj) vj[j] = valid ? val[i] : 0;
    if (lj) lj[j] = kFirst ? (int)i : (valid && lane_in ? lane_in[i] : 0);
    ok[j] = valid;
  }
}

// Digit histogram of one tile, written digit-major: hist[d * tiles +
// tile].  The first pass reads the chunk's m lanes and counts the live
// ones, zeroes this tile's spill flags (ovf) and, for a small chunk, this
// tile's column of the later passes' histograms (`later` of them, 2^bits
// digits each, RADIX_MAX * tiles apart), which radix_scatter then fills
// with atomics; later passes read the L sorted lanes.  Every item is
// loaded before the first shared add, so a warp's rows wait on memory
// once.
template <bool kFirst>
__global__ void __launch_bounds__(THREADS)
radix_hist(const int32_t* __restrict__ key, int m,
           const int32_t* __restrict__ tot, int nk, int shift, int bits,
           int tiles, int32_t* __restrict__ hist, int later,
           int32_t* __restrict__ ovf) {
  __shared__ int h[RADIX_MAX];
  const int radix = 1 << bits;
  for (int d = threadIdx.x; d < radix; d += THREADS) h[d] = 0;
  int kj[ITEMS];
  bool ok[ITEMS];
  load_items<kFirst>(key, nullptr, nullptr, kFirst ? m : *tot, nk, kj,
                     nullptr, nullptr, ok);
  if (kFirst && ovf) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = tile_lane(blockIdx.x, j);
      if (i < m) ovf[i] = 0;
    }
  }
  for (int p = 1; p <= later; ++p)
    for (int d = threadIdx.x; d < radix; d += THREADS)
      hist[(long long)p * RADIX_MAX * tiles + (long long)d * tiles
           + blockIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int d = (kj[j] >> shift) & (radix - 1);
    const unsigned peers = digit_peers(ok[j], d, bits);
    if (ok[j] && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += THREADS)
    hist[(long long)d * tiles + blockIdx.x] = h[d];
}

// One block per digit: the exclusive scan of the digit's tile counts in
// tile order, in place, and the digit's total in dtot[d].  Not launched
// for a chunk of at most SMALL_TILES tiles: radix_scatter then reads the
// raw counts itself.
__global__ void __launch_bounds__(THREADS)
radix_scan(int32_t* __restrict__ hist, int tiles, int32_t* __restrict__ dtot) {
  __shared__ int warp_tot[33];
  int32_t* row = hist + (long long)blockIdx.x * tiles;
  const int per = (tiles + THREADS - 1) / THREADS;
  const int lo = min(threadIdx.x * per, tiles);
  const int hi = min(lo + per, tiles);
  int local = 0;
  for (int t = lo; t < hi; ++t) local += row[t];
  int total;
  int run = scan::block_excl<THREADS>(local, warp_tot, &total);
  for (int t = lo; t < hi; ++t) {
    const int c = row[t];
    row[t] = run;
    run += c;
  }
  if (threadIdx.x == 0) dtot[blockIdx.x] = total;
}

// Exclusive scan over the digits of v(d), PER_MAX digits a thread in
// digit order (thread t takes digits t*per .. t*per + per - 1); returns
// the total.  out[d] = the scan for d < radix; the caller syncs after.
template <typename F>
__device__ int digit_scan(int radix, F v, int* out, int* warp_tot) {
  constexpr int PER_MAX = RADIX_MAX / THREADS;
  const int per = (radix + THREADS - 1) / THREADS;
  int x[PER_MAX];
  int local = 0;
#pragma unroll
  for (int q = 0; q < PER_MAX; ++q) {
    const int d = threadIdx.x * per + q;
    x[q] = q < per && d < radix ? v(d) : 0;
    local += x[q];
  }
  int total;
  int run = scan::block_excl<THREADS>(local, warp_tot, &total);
#pragma unroll
  for (int q = 0; q < PER_MAX; ++q) {
    const int d = threadIdx.x * per + q;
    if (q < per && d < radix) out[d] = run;
    run += x[q];
  }
  return total;
}

// Stable scatter of one tile of (key, payload[, lane]) by the pass's
// digit (see the header).  The first pass takes the chunk's live lanes,
// its lane ids the lane indices, and block 0 records their number in
// *tot.  `small`: hist holds the raw tile counts (radix_scan skipped),
// summed here per digit over all tiles and over the tiles before this
// one.  The tile's lanes are put in digit order in shared memory first,
// so that consecutive threads write consecutive addresses of a digit's
// run; as each lane lands, it adds one to the next pass's histogram
// (next_hist, digit at next_shift) at its landing tile (integer atomics,
// which commute).  Dynamic shared memory: STAGE_INTS(2^bits) + 2 * 2^bits
// ints (at most 40 KB).
template <bool kFirst>
__global__ void __launch_bounds__(THREADS)
radix_scatter(const int32_t* __restrict__ key_in,
              const int32_t* __restrict__ val_in,
              const int32_t* __restrict__ lane_in, int m,
              int32_t* __restrict__ tot, int nk, int shift, int bits,
              int tiles, int small, const int32_t* __restrict__ hist,
              const int32_t* __restrict__ dtot, int32_t* __restrict__ key_out,
              int32_t* __restrict__ val_out, int32_t* __restrict__ lane_out,
              int32_t* __restrict__ next_hist, int next_shift,
              int next_bits) {
  extern __shared__ int smem[];
  __shared__ int warp_tot[33];
  const int radix = 1 << bits;
  // whist [WARPS][radix], later the staging buffers [2][TILE]; then the
  // digits' global bases and their starts within the tile.
  int* whist = smem;
  int* stage = smem;
  int* gbase = smem + STAGE_INTS(radix);
  int* tstart = gbase + radix;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n = kFirst ? m : *tot;
  int kj[ITEMS], vj[ITEMS], lj[ITEMS], rj[ITEMS];
  bool ok[ITEMS];
  load_items<kFirst>(key_in, val_in, lane_in, n, nk, kj, vj, lj, ok);
  // Where this tile's digit d starts in the output: the digits before it
  // over the whole chunk (gbase, a scan of the digit totals), plus digit d
  // in the tiles before this one (held in tstart meanwhile).
  const int total = digit_scan(
      radix,
      [&](int d) {
        const int32_t* row = hist + (long long)d * tiles;
        if (!small) {
          tstart[d] = row[blockIdx.x];
          return (int)dtot[d];
        }
        int all = 0, before = 0;
#pragma unroll 4
        for (int t = 0; t < tiles; ++t) {
          const int c = row[t];
          all += c;
          before += t < (int)blockIdx.x ? c : 0;
        }
        tstart[d] = before;
        return all;
      },
      gbase, warp_tot);
  if (kFirst && blockIdx.x == 0 && threadIdx.x == 0) *tot = total;
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += THREADS) gbase[d] += tstart[d];
  for (int d = lane; d < radix; d += 32) whist[wid * radix + d] = 0;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int d = (kj[j] >> shift) & (radix - 1);
    const unsigned peers = digit_peers(ok[j], d, bits);
    const int before = ok[j] ? whist[wid * radix + d] : 0;
    __syncwarp();
    if (ok[j] && lane == __ffs(peers) - 1)
      whist[wid * radix + d] = before + __popc(peers);
    __syncwarp();
    rj[j] = before + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  // Per digit: each warp's offset within the digit's run of this tile, in
  // warp order, and the run's length.
  for (int d = threadIdx.x; d < radix; d += THREADS) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = whist[w * radix + d];
      whist[w * radix + d] = run;
      run += c;
    }
    tstart[d] = run;
  }
  __syncthreads();
  const int valid = digit_scan(radix, [&](int d) { return tstart[d]; },
                               tstart, warp_tot);
  __syncthreads();
  // Each item's position in the tile's digit order.
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int d = (kj[j] >> shift) & (radix - 1);
    rj[j] += tstart[d] + whist[wid * radix + d];
  }
  __syncthreads();  // whist is read; the staging buffers take its place
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (ok[j]) {
      stage[rj[j]] = kj[j];
      stage[TILE + rj[j]] = vj[j];
    }
  }
  __syncthreads();
  const int next_mask = (1 << next_bits) - 1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int q = j * THREADS + threadIdx.x;
    const bool in = q < valid;
    const int k = in ? stage[q] : 0;
    const int pos = gbase[(k >> shift) & (radix - 1)] + q
                    - tstart[(k >> shift) & (radix - 1)];
    if (in) {
      key_out[pos] = k;
      val_out[pos] = stage[TILE + q];
    }
    if (next_hist) {
      // One add per distinct (digit, tile) cell of the warp's lanes.
      const unsigned act = __ballot_sync(FULL_MASK, in);
      if (in) {
        const long long cell = (long long)((k >> next_shift) & next_mask)
                               * tiles + pos / TILE;
        const unsigned peers = __match_any_sync(act, (unsigned)cell);
        if (lane == __ffs(peers) - 1)
          atomicAdd(&next_hist[cell], __popc(peers));
      }
    }
  }
  if (!lane_out) return;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (ok[j]) stage[TILE + rj[j]] = lj[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int q = j * THREADS + threadIdx.x;
    if (q < valid) {
      const int k = stage[q];
      const int d = (k >> shift) & (radix - 1);
      lane_out[gbase[d] + q - tstart[d]] = stage[TILE + q];
    }
  }
}

// First position q <= hi of the sorted keys with sk[q] == sk[hi].
__device__ int run_first(const int32_t* __restrict__ sk, int hi) {
  const int k = sk[hi];
  int lo = 0;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (sk[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <bool kSpill>
__global__ void __launch_bounds__(THREADS)
chunk_write(int32_t* __restrict__ mbox, const int32_t* __restrict__ count,
            int32_t* __restrict__ dropped, int nk, int cap, int rank_major,
            const int32_t* __restrict__ tot,
            const int32_t* __restrict__ sk, const int32_t* __restrict__ sv,
            const int32_t* __restrict__ sl, int32_t* __restrict__ newcnt,
            int32_t* __restrict__ ovf) {
  __shared__ int wmax[32];
  __shared__ int s_enter, s_drop;
  const int L = *tot;
  const int base = blockIdx.x * THREADS;
  if (base >= L) return;  // the whole block
  const int p = base + threadIdx.x;
  const bool in = p < L;
  const int k = in ? sk[p] : -1;
  const bool head = in && (p == 0 || sk[p - 1] != k);
  if (threadIdx.x == 0) {
    s_drop = 0;
    s_enter = (base == 0 || sk[base - 1] != k) ? base : run_first(sk, base);
  }
  const int hs = block_incl_max(head ? p : -1, wmax);  // syncs s_enter too
  bool trash = false;
  if (in) {
    const int start = hs >= 0 ? hs : s_enter;
    const int c = count[k];
    const long long rank = (long long)c + (p - start);
    if (rank < cap) {
      mbox[rank_major ? rank * nk + k : (long long)k * cap + rank] = sv[p];
    } else {
      trash = true;
      if (kSpill)
        ovf[sl[p]] = 1;
      else
        atomicAdd(&s_drop, 1);
    }
    // The run's last lane: its key's count after this chunk (int32 wrap,
    // as the plain version's index_add_).
    if (p == L - 1 || sk[p + 1] != k)
      newcnt[p] = (int)((unsigned)c + (unsigned)(p - start + 1));
  }
  // One write of the trash cell per block that has such lanes.
  if (__syncthreads_or(trash) && threadIdx.x == 0)
    mbox[(long long)nk * cap] = -1;
  if (!kSpill && threadIdx.x == 0 && s_drop) atomicAdd(dropped, s_drop);
}

// count[k] = the new count stored by each run's last lane, one plain store
// per distinct key; the m - L dead lanes add to the sentinel count[nk] in
// one add and write the trash cell.
__global__ void __launch_bounds__(THREADS)
chunk_count(int32_t* __restrict__ mbox, int32_t* __restrict__ count, int m,
            int nk, int cap, const int32_t* __restrict__ tot,
            const int32_t* __restrict__ sk,
            const int32_t* __restrict__ newcnt) {
  const int L = *tot;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p < L) {
    const int k = sk[p];
    if (p == L - 1 || sk[p + 1] != k) count[k] = newcnt[p];
  }
  if (p == 0 && m > L) {
    count[nk] = (int)((unsigned)count[nk] + (unsigned)(m - L));
    mbox[(long long)nk * cap] = -1;
  }
}

__global__ void scan_tiles(const int32_t* __restrict__ a, int len,
                           int32_t* __restrict__ tile_sums) {
  __shared__ int warp_tot[33];
  const long long base = (long long)blockIdx.x * SCAN_TILE
                         + (long long)threadIdx.x * SCAN_ITEMS;
  int x = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j)
    if (base + j < len) x += a[base + j];
  int total;
  scan::block_excl<SCAN_THREADS>(x, warp_tot, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// Exclusive scan of the tile sums in one block, in place.
__global__ void scan_sums(int32_t* __restrict__ tile_sums, int tiles) {
  __shared__ int warp_tot[33];
  const int per = (tiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(threadIdx.x * per, tiles);
  const int hi = min(lo + per, tiles);
  int local = 0;
  for (int j = lo; j < hi; ++j) local += tile_sums[j];
  int total;
  int run = scan::block_excl<SCAN_THREADS>(local, warp_tot, &total);
  for (int j = lo; j < hi; ++j) {
    const int t = tile_sums[j];
    tile_sums[j] = run;
    run += t;
  }
}

// In-tile inclusive scan plus the tile's offset, in place.
__global__ void scan_apply(int32_t* __restrict__ a, int len,
                           const int32_t* __restrict__ tile_sums) {
  __shared__ int warp_tot[33];
  const long long base = (long long)blockIdx.x * SCAN_TILE
                         + (long long)threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int x = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    v[j] = base + j < len ? a[base + j] : 0;
    x += v[j];
  }
  int total;
  int run = tile_sums[blockIdx.x] + scan::block_excl<SCAN_THREADS>(x, warp_tot, &total);
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    run += v[j];
    if (base + j < len) a[base + j] = run;
  }
}

// ovf holds the inclusive lane-order count of overflowing lanes; scnt is
// read here and updated only by spill_finish, which runs after.
__global__ void spill_write(const int32_t* __restrict__ ovf,
                            const int32_t* __restrict__ key,
                            const int32_t* __restrict__ s, int m,
                            int32_t* __restrict__ pairs,
                            const int32_t* __restrict__ scnt, int scap) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  const int incl = ovf[i];
  if (incl == (i > 0 ? ovf[i - 1] : 0)) return;  // not an overflow lane
  const long long pos = (long long)*scnt + incl - 1;
  if (pos < scap) {
    pairs[pos] = s[i];
    pairs[(long long)scap + 1 + pos] = key[i];
  }
}

__global__ void spill_finish(const int32_t* __restrict__ ovf, int m,
                             int32_t* __restrict__ pairs,
                             int32_t* __restrict__ scnt, int scap,
                             int32_t* __restrict__ dropped) {
  const long long total = ovf[m - 1];
  const long long room = (long long)scap - *scnt;
  const long long fits = total < room ? total : (room > 0 ? room : 0);
  *scnt += (int)fits;
  *dropped += (int)(total - fits);
  if (fits < m) {  // some lane wrote -1 to the trash column
    pairs[scap] = -1;
    pairs[2LL * scap + 1] = -1;
  }
}

// Inclusive scan of a[0 .. len) in place; tile_sums: int32[ceil(len/4096)].
cudaError_t scan_inplace(int32_t* a, int len, int32_t* tile_sums,
                         cudaStream_t st) {
  const int tiles = (len + SCAN_TILE - 1) / SCAN_TILE;
  scan_tiles<<<tiles, SCAN_THREADS, 0, st>>>(a, len, tile_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_sums<<<1, SCAN_THREADS, 0, st>>>(tile_sums, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_apply<<<tiles, SCAN_THREADS, 0, st>>>(a, len, tile_sums);
  return cudaGetLastError();
}

int bit_length(unsigned x) {
  int b = 0;
  while (x) {
    ++b;
    x >>= 1;
  }
  return b;
}

}  // namespace

// Scratch elements (int32) of a call of m lanes: sorted keys and lanes,
// double-buffered (4m); the digit-major tile histograms (RADIX_MAX per
// tile); the digit totals (RADIX_MAX); the live count (1); the spill form
// adds the lanes' overflow flags (m) and their scan's tile sums.  The
// wrapper's ops/deliver.chunk_scratch_elems computes the same.
static long long chunk_scratch_elems(long long m, bool spill) {
  const long long tiles = (m + TILE - 1) / TILE;
  long long n = (spill ? 6 : 4) * m + (long long)PASSES_MAX * RADIX_MAX * tiles
                + RADIX_MAX + 1;
  if (spill) n += m + (m + SCAN_TILE - 1) / SCAN_TILE;
  return n;
}

// scratch: int32[scratch_elems], at least chunk_scratch_elems(m, pairs !=
// NULL).  Spill form (pairs not NULL): pairs int32[2 * (scap + 1)], scnt
// int32[1].
extern "C" int gossip_fused_chunk_step(
    void* mbox, void* count, void* dropped, const void* key, const void* s,
    int m, int nk, int cap, int rank_major, void* scratch,
    long long scratch_elems, void* pairs, void* scnt, int scap,
    void* stream) {
  if (nk < 1 || cap < 1 || scap < 0 || m < 0)
    return (int)cudaErrorInvalidValue;
  if (pairs && !scnt) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  const bool spill = pairs != nullptr;
  if (scratch_elems < chunk_scratch_elems(m, spill))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (m + TILE - 1) / TILE;
  // Two buffers of sorted (key, payload[, lane]) arrays; the lanes only in
  // the spill form, where an overflowing lane flags its own position.
  const int arrays = spill ? 3 : 2;
  int32_t* buf[2][3] = {{nullptr}};
  int32_t* p = (int32_t*)scratch;
  for (int q = 0; q < 2; ++q)
    for (int a = 0; a < arrays; ++a, p += m) buf[q][a] = p;
  int32_t* hist = p;  // [PASSES_MAX][RADIX_MAX][tiles]
  p += (long long)PASSES_MAX * RADIX_MAX * tiles;
  int32_t* dtot = p;
  p += RADIX_MAX;
  int32_t* tot = p;
  p += 1;
  int32_t* ovf = spill ? p : nullptr;
  int32_t* ovf_tiles = spill ? p + m : nullptr;

  const int lb = bit_length((unsigned)(nk - 1));
  const int bits = lb > 0 ? lb : 1;
  const int passes = (bits + RADIX_BITS_MAX - 1) / RADIX_BITS_MAX;
  const int dbits = (bits + passes - 1) / passes;
  const int small = tiles <= SMALL_TILES;
  const int32_t* k32 = (const int32_t*)key;
  const int32_t* s32 = (const int32_t*)s;
  cudaError_t err;
  const int32_t* in[3] = {k32, s32, nullptr};
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * dbits;
    const int b = dbits < bits - shift ? dbits : bits - shift;
    int32_t* h = hist + (long long)pass * RADIX_MAX * tiles;
    // A small chunk's later histograms come from the scatter before them.
    int32_t* next = small && pass + 1 < passes
                        ? h + (long long)RADIX_MAX * tiles : nullptr;
    const int nshift = shift + dbits;
    const int nb = dbits < bits - nshift ? dbits : bits - nshift;
    int32_t** out = buf[pass & 1];
    if (pass == 0) {
      radix_hist<true><<<tiles, THREADS, 0, st>>>(
          k32, m, tot, nk, 0, b, tiles, hist, small ? passes - 1 : 0, ovf);
    } else if (!small) {
      radix_hist<false><<<tiles, THREADS, 0, st>>>(
          in[0], m, tot, nk, shift, b, tiles, h, 0, nullptr);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (!small) {
      radix_scan<<<1 << b, THREADS, 0, st>>>(h, tiles, dtot);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const size_t smem = (size_t)(STAGE_INTS(1 << b) + 2 * (1 << b))
                        * sizeof(int);
    if (pass == 0) {
      radix_scatter<true><<<tiles, THREADS, smem, st>>>(
          in[0], in[1], nullptr, m, tot, nk, shift, b, tiles, small, h, dtot,
          out[0], out[1], out[2], next, nshift, next ? nb : 0);
    } else {
      radix_scatter<false><<<tiles, THREADS, smem, st>>>(
          in[0], in[1], in[2], m, tot, nk, shift, b, tiles, small, h, dtot,
          out[0], out[1], out[2], next, nshift, next ? nb : 0);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int a = 0; a < 3; ++a) in[a] = out[a];
  }
  // The sorted arrays sit in one buffer; the other is free and holds the
  // runs' new counts.
  int32_t* newcnt = buf[passes & 1][0];
  const int nblk = (m + THREADS - 1) / THREADS;
  int32_t* mb = (int32_t*)mbox;
  if (spill)
    chunk_write<true><<<nblk, THREADS, 0, st>>>(
        mb, (const int32_t*)count, (int32_t*)dropped, nk, cap, rank_major,
        tot, in[0], in[1], in[2], newcnt, ovf);
  else
    chunk_write<false><<<nblk, THREADS, 0, st>>>(
        mb, (const int32_t*)count, (int32_t*)dropped, nk, cap, rank_major,
        tot, in[0], in[1], nullptr, newcnt, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_count<<<nblk, THREADS, 0, st>>>(mb, (int32_t*)count, m, nk, cap,
                                        tot, in[0], newcnt);
  err = cudaGetLastError();
  if (err != cudaSuccess || !spill) return (int)err;
  err = scan_inplace(ovf, m, ovf_tiles, st);
  if (err != cudaSuccess) return (int)err;
  spill_write<<<nblk, THREADS, 0, st>>>(ovf, k32, s32, m, (int32_t*)pairs,
                                        (const int32_t*)scnt, scap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  spill_finish<<<1, 1, 0, st>>>(ovf, m, (int32_t*)pairs, (int32_t*)scnt,
                                scap, (int32_t*)dropped);
  return (int)cudaGetLastError();
}
