// fused_drain_sum: PushSum's whole-slot drain.  For window slot `slot` of
// the mail ring and m = cnt[slot] (read here, from device memory), every
// lane i < m adds its mass row into the accumulator row it addresses:
//
//   row = ids[slot*cap + i] // b          (floor division)
//   acc[row, c] += mass[slot*cap + i, c]  for c < C, when 0 <= row < n
//
// acc is int32[n, C] fixed-point limbs (C = (dim + 1) * 4), ids int32[L],
// mass int32[L, C]; lanes whose row falls outside [0, n) add nothing.
// The adds wrap in two's complement, as int32 adds do everywhere.
//
// Replaces the TPU kernel gossip_simulator_tpu/ops/pallas_megakernel.py
// fused_drain_sum (_drain_kernel), a serial loop over all cap lanes of the
// slot that masks the lanes past m and adds zero at row 0 for a masked or
// out-of-range lane.  Here every pass runs over the live lanes only: the
// bound m comes from device memory, so the caller needs no host read, and
// every grid is sized from cap with an early exit past m.  Integer adds
// commute, so neither the order of the atomics nor the order in which the
// lanes are taken changes the result, and the sum equals the chunked
// deposit_sum loop's bit for bit.
//
// Bound on the H100: bytes.  At the full-size shape (n = 1e7, C = 12, m ~
// 6e7 live lanes of a 7e7-lane slot) a call must read each live lane's id
// (4 B) and mass row (48 B), and read and write each touched accumulator
// row once (48 B each way), ~4.1 GB, ~1.2 ms at 3.35 TB/s.  The TPU kernel
// never had to think about where acc lives; on the card a 480 MB
// accumulator is ten times the 50 MB L2, so a lane's read-modify-write of
// its random 48-byte row misses L2 and moves its sectors in and out of
// device memory.  Forms, chosen by the wrapper (ops/megakernel.py
// drain_part_rows) from the accumulator's size:
//
// direct (part_rows = 0): drain_sum, a grid-stride loop with a group of g
//   threads per lane (g the power of two at or above min(C, 32): a
//   half-warp for C = 12), so the group reads the lane's row coalesced; one
//   atomicAdd per nonzero column.  Taken for a small acc, and for one so
//   large that PART_MAX slices would not fit the shared-memory tile.
//
// partitioned (part_rows = R > 0, R * C * 4 <= TILE_SMEM_MAX): the rows
//   are cut into P = ceil(n / R) contiguous partitions, and the live lanes
//   are reordered by partition before they are added:
//     part_hist     the live lanes' partitions counted per block in shared
//                   memory, one global add per nonzero bin (large blocks:
//                   the adds are global atomics);
//     part_scan     the counts scanned into segment offsets (one block);
//     part_scatter  each live lane's (row, lane) pair written into its
//                   partition's segment: one global claim per nonempty
//                   (block, bin), the block's pairs staged in shared
//                   memory in bin order, then written out in runs (order
//                   within a partition is free: the adds commute).  Past
//                   STAGE_MAX partitions the runs would be a pair or two
//                   long, so the lanes go first into COARSE groups of
//                   consecutive partitions, then, each block a chunk of one
//                   group's segment, into the partitions (two staged
//                   passes; a second pair buffer);
//     tile_accum    block p holds partition p's rows of acc in shared
//                   memory, adds its segment's mass rows there with shared
//                   atomics and writes the tile back: acc is read and
//                   written once, coalesced, and no global atomic is
//                   issued.  It gathers each lane's mass row (random
//                   48-byte rows), issuing several pairs' loads before
//                   their adds.
//   Scratch (int32, from the wrapper, O(cap)): the pairs int32[2 * cap] (a
//   second int32[2 * cap] with two passes), then counts[P], offs[P + 1]
//   and the cursors[P], and with two passes the groups' cursors[G] and
//   chunk starts[G + 1]; the counts are zeroed here with one memset of P
//   cells (no n- or cap-sized fill).
//
// Measured on the card (PERF.md): the tile form's time is mostly its
// random mass-row gathers.  Global atomics into an L2-resident slice of
// acc ran at about 1.2e11 adds a second, little better than the direct
// kernel, so no form adds through L2.
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the last launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "scan.cuh"
#include "smem.cuh"

#define THREADS 256
#define MAX_BLOCKS 16384
#define PART_MAX 8192  // ops/megakernel.py DRAIN_PART_MAX
#define STAGE_MAX 1024  // bins a staged scatter block takes (DRAIN_STAGE_MAX)
#define COARSE 64  // groups of the two-pass scatter (DRAIN_COARSE)
#define PART_ITEMS 16
#define PART_TILE (THREADS * PART_ITEMS)  // lanes a scatter block
#define HIST_THREADS 1024  // a histogram block (fewer global adds)
#define HIST_TILE (HIST_THREADS * PART_ITEMS)
#define UNROLL 8  // pairs a group has in flight
#define UNROLL_VEC 4  // the same, 16-byte pieces
#define SCAN_THREADS 1024
#define TILE_THREADS 1024  // a tile-form accumulate block
#define TILE_SMEM_MAX (220 * 1024)  // ops/megakernel.py DRAIN_TILE_MAX

namespace {

__device__ __forceinline__ long long live_count(const int32_t* cnt, int slot,
                                                long long cap) {
  const long long m = cnt[slot];
  return m > cap ? cap : m;
}

// The lane's accumulator row, or -1 when its entry decodes outside [0, n)
// (floor division: any negative entry lands below row 0).
__device__ __forceinline__ int lane_row(const int32_t* ids, long long at,
                                        int b, long long n) {
  const int ent = ids[at];
  if (ent < 0) return -1;
  const int row = ent / b;
  return row < n ? row : -1;
}

__global__ void drain_sum(int32_t* __restrict__ acc,
                          const int32_t* __restrict__ ids,
                          const int32_t* __restrict__ mass,
                          const int32_t* __restrict__ cnt, int slot,
                          long long cap, int b, long long n, int c, int g) {
  const long long m = live_count(cnt, slot, cap);
  const long long base = (long long)slot * cap;
  const int per_block = THREADS / g;
  const int sub = threadIdx.x % g;
  const long long stride = (long long)gridDim.x * per_block;
  for (long long i = (long long)blockIdx.x * per_block + threadIdx.x / g;
       i < m; i += stride) {
    const int row = lane_row(ids, base + i, b, n);
    if (row < 0) continue;
    int32_t* dst = acc + (long long)row * c;
    const int32_t* v = mass + (base + i) * c;
    for (int col = sub; col < c; col += g) {
      const int32_t x = v[col];
      if (x != 0) atomicAdd(dst + col, x);
    }
  }
}

// Per block, the partitions of its PART_TILE lanes counted in shared
// memory (h[parts], dynamic), then one global add per nonzero bin.
__global__ void __launch_bounds__(HIST_THREADS)
part_hist(const int32_t* __restrict__ ids, const int32_t* __restrict__ cnt,
          int slot, long long cap, int b, long long n, int rows, int parts,
          int32_t* __restrict__ counts) {
  extern __shared__ int h[];
  const long long m = live_count(cnt, slot, cap);
  const long long tile0 = (long long)blockIdx.x * HIST_TILE;
  if (tile0 >= m) return;
  for (int p = threadIdx.x; p < parts; p += HIST_THREADS) h[p] = 0;
  __syncthreads();
  const long long base = (long long)slot * cap;
#pragma unroll 4
  for (int r = 0; r < PART_ITEMS; ++r) {
    const long long i = tile0 + r * HIST_THREADS + threadIdx.x;
    if (i < m) {
      const int row = lane_row(ids, base + i, b, n);
      if (row >= 0) atomicAdd(&h[row / rows], 1);
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < parts; p += HIST_THREADS)
    if (h[p]) atomicAdd(&counts[p], h[p]);
}

// offs[p] = the segment start of partition p, offs[parts] = the total;
// cur = offs (the cursors the scatter advances).  With groups > 0 (two
// passes), also each group's cursor ccur[g] = offs[g * group] and the
// first chunk of each group's segment, cst[g] (cst[groups] = all chunks).
__global__ void part_scan(const int32_t* __restrict__ counts,
                          int32_t* __restrict__ offs,
                          int32_t* __restrict__ cur, int parts, int group,
                          int groups, int32_t* __restrict__ ccur,
                          int32_t* __restrict__ cst) {
  __shared__ int warp_tot[SCAN_THREADS / 32];
  const int t = threadIdx.x;
  const int per = (parts + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(t * per, parts), hi = min(lo + per, parts);
  int x = 0;
  for (int p = lo; p < hi; ++p) x += counts[p];
  int run = scan::block_excl<SCAN_THREADS>(x, warp_tot);
  for (int p = lo; p < hi; ++p) {
    offs[p] = cur[p] = run;
    run += counts[p];
  }
  if (t == SCAN_THREADS - 1) offs[parts] = run;
  if (groups == 0) return;
  __syncthreads();
  int chunks = 0;
  if (t < groups) {
    const int s0 = offs[t * group], s1 = offs[min((t + 1) * group, parts)];
    ccur[t] = s0;
    chunks = (s1 - s0 + PART_TILE - 1) / PART_TILE;
  }
  __syncthreads();  // warp_tot is reused
  const int first = scan::block_excl<SCAN_THREADS>(chunks, warp_tot);
  if (t < groups) cst[t] = first;
  if (t == SCAN_THREADS - 1) cst[groups] = first + chunks;
}

// One staged scatter block: up to PART_TILE (row, lane) pairs, PART_ITEMS
// a thread, each in bin bin(row) < nbins <= STAGE_MAX (-1: none), written
// to out at cursor[bin] onwards.
//   kFine false: the block's lanes of the slot, bin = row / rows / div;
//   kFine true:  the block's chunk of one group's segment of src (the
//                group and chunk from cst), bin = row / rows - g * div.
template <bool kFine>
__global__ void __launch_bounds__(THREADS)
part_scatter(const int32_t* __restrict__ ids, const int2* __restrict__ src,
             const int32_t* __restrict__ cnt, int slot, long long cap, int b,
             long long n, int rows, int div, int nbins, int parts,
             const int32_t* __restrict__ offs,
             const int32_t* __restrict__ cst, int groups,
             int32_t* __restrict__ cursor, int2* __restrict__ out) {
  __shared__ int h[STAGE_MAX];      // counts, then the block's bin offsets
  __shared__ int claim[STAGE_MAX];  // the block's run start in each bin
  __shared__ int2 staged[PART_TILE];
  __shared__ int warp_tot[THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  long long lo, hi;
  int bin0 = 0;
  if (kFine) {
    const int k = blockIdx.x;
    if (k >= cst[groups]) return;
    int a = 0, z = groups;  // the group g with cst[g] <= k < cst[g + 1]
    while (z - a > 1) {
      const int mid = (a + z) >> 1;
      if (cst[mid] <= k) a = mid; else z = mid;
    }
    bin0 = a * div;
    nbins = min(div, parts - bin0);
    lo = offs[bin0] + (long long)(k - cst[a]) * PART_TILE;
    hi = min(lo + PART_TILE, (long long)offs[bin0 + nbins]);
    cursor += bin0;
  } else {
    lo = (long long)blockIdx.x * PART_TILE;
    hi = live_count(cnt, slot, cap);
    if (lo >= hi) return;
  }
  for (int p = t; p < nbins; p += THREADS) h[p] = 0;
  __syncthreads();
  const long long base = (long long)slot * cap;
  int row[PART_ITEMS], at[PART_ITEMS], idx[PART_ITEMS];
#pragma unroll
  for (int r = 0; r < PART_ITEMS; ++r) {
    const long long i = lo + r * THREADS + t;
    row[r] = -1;
    idx[r] = 0;
    if (i < hi) {
      if (kFine) {
        const int2 pr = src[i];
        row[r] = pr.x;
        idx[r] = pr.y;
      } else {
        row[r] = lane_row(ids, base + i, b, n);
        idx[r] = (int)i;
      }
    }
    at[r] = row[r] >= 0
        ? atomicAdd(&h[kFine ? row[r] / rows - bin0 : row[r] / rows / div], 1)
        : 0;
  }
  __syncthreads();
  // Claim each bin's run, then scan the bins into block offsets (each
  // thread a contiguous group of bins).
  for (int p = t; p < nbins; p += THREADS)
    claim[p] = h[p] ? atomicAdd(&cursor[p], h[p]) : 0;
  const int per = (nbins + THREADS - 1) / THREADS;
  const int blo = min(t * per, nbins), bhi = min(blo + per, nbins);
  int sum = 0;
  for (int p = blo; p < bhi; ++p) sum += h[p];
  int y = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int z = __shfl_up_sync(0xffffffffu, y, o);
    if (lane >= o) y += z;
  }
  if (lane == 31) warp_tot[wid] = y;
  __syncthreads();
  int run = y - sum;
  for (int w = 0; w < wid; ++w) run += warp_tot[w];
  for (int p = blo; p < bhi; ++p) {
    const int c = h[p];
    h[p] = run;
    run += c;
  }
  __syncthreads();
  int n_live = 0;
  for (int w = 0; w < THREADS / 32; ++w) n_live += warp_tot[w];
#pragma unroll
  for (int r = 0; r < PART_ITEMS; ++r)
    if (row[r] >= 0)
      staged[h[kFine ? row[r] / rows - bin0 : row[r] / rows / div] + at[r]] =
          make_int2(row[r], idx[r]);
  __syncthreads();
  for (int k = t; k < n_live; k += THREADS) {
    const int2 pr = staged[k];
    const int p = kFine ? pr.x / rows - bin0 : pr.x / rows / div;
    out[claim[p] + (k - h[p])] = pr;
  }
}

// The tile form: block p holds partition p's rows of acc in shared memory
// (rows * c int32, dynamic), adds its segment [offs[p], offs[p + 1]) of
// the list there with shared atomics, and writes the tile back.  A group
// of g threads a pair reads the row 16 bytes a thread (kVec: c a multiple
// of 4 and mass 16-byte aligned; g the power of two at or above c / 4) or
// a word a thread, UNROLL_VEC or UNROLL pairs a step with all their loads
// issued before the adds.
template <bool kVec>
__global__ void __launch_bounds__(TILE_THREADS)
tile_accum(int32_t* __restrict__ acc, const int2* __restrict__ pairs,
           const int32_t* __restrict__ mass,
           const int32_t* __restrict__ offs, int slot, long long cap,
           long long n, int rows, int c, int g) {
  extern __shared__ int tile[];
  const int p = blockIdx.x;
  const int k0 = offs[p], k1 = offs[p + 1];
  if (k0 == k1) return;
  const long long r0 = (long long)p * rows;
  const int words = (int)min((long long)rows, n - r0) * c;
  int32_t* src = acc + r0 * c;
  for (int e = threadIdx.x; e < words; e += TILE_THREADS) tile[e] = src[e];
  __syncthreads();
  const long long base = (long long)slot * cap;
  const int groups = TILE_THREADS / g, sub = threadIdx.x % g;
  constexpr int kU = kVec ? UNROLL_VEC : UNROLL;
  constexpr int kW = kVec ? 4 : 1;  // words a thread reads at once
  const int q = c / kW;
  for (int q0 = 0; q0 < q; q0 += g) {
    const int col = q0 + sub;
    for (int k = k0 + (int)threadIdx.x / g; k < k1; k += groups * kU) {
      int x[kU][kW];
      int at[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int kk = k + u * groups;
#pragma unroll
        for (int w = 0; w < kW; ++w) x[u][w] = 0;
        at[u] = 0;
        if (kk < k1 && col < q) {
          const int2 pr = pairs[kk];
          at[u] = (pr.x - (int)r0) * c + kW * col;
          const long long from = (base + pr.y) * q + col;
          if (kVec) {
            const int4 v = reinterpret_cast<const int4*>(mass)[from];
            x[u][0] = v.x;
            x[u][kW > 1 ? 1 : 0] = v.y;
            x[u][kW > 2 ? 2 : 0] = v.z;
            x[u][kW > 3 ? 3 : 0] = v.w;
          } else {
            x[u][0] = mass[from];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int w = 0; w < kW; ++w)
          if (x[u][w] != 0) atomicAdd(tile + at[u] + w, x[u][w]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < words; e += TILE_THREADS) src[e] = tile[e];
}

}  // namespace

// acc: int32[n * c], updated in place; ids: int32[>= (slot + 1) * cap];
// mass: int32[>= (slot + 1) * cap * c]; cnt: int32[> slot], the live
// count of each slot.  part_rows 0: the direct form (scratch unused);
// part_rows R > 0 with R * c * 4 <= TILE_SMEM_MAX: the partitioned form
// over P = ceil(n / R) <= PART_MAX partitions, with scratch of at least 2
// * cap + 3 * P + 1 int32 cells, and with P > STAGE_MAX (two scatter
// passes over G = ceil(P / ceil(P / COARSE)) groups) 2 * cap + 2 * G + 1
// more (scratch_elems).
extern "C" int gossip_fused_drain_sum(void* acc, const void* ids,
                                      const void* mass, const void* cnt,
                                      int slot, long long cap, int b,
                                      long long n, int c,
                                      long long part_rows, void* scratch,
                                      long long scratch_elems,
                                      void* stream) {
  if (slot < 0 || cap < 0 || b < 1 || n < 0 || c < 1 || part_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (cap == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  int g = 1;
  while (g < c && g < 32) g *= 2;
  if (part_rows == 0) {
    const long long per_block = THREADS / g;
    long long blocks = (cap + per_block - 1) / per_block;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    drain_sum<<<(unsigned)blocks, THREADS, 0, st>>>(
        (int32_t*)acc, (const int32_t*)ids, (const int32_t*)mass,
        (const int32_t*)cnt, slot, cap, b, n, c, g);
    return (int)cudaGetLastError();
  }
  const long long parts = (n + part_rows - 1) / part_rows;
  const size_t tile_smem = part_rows * c * sizeof(int);
  if (parts > PART_MAX || tile_smem > TILE_SMEM_MAX || n >= (1LL << 31) ||
      cap >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool two = parts > STAGE_MAX;
  const int group = two ? (int)((parts + COARSE - 1) / COARSE) : 1;
  const int groups = two ? (int)((parts + group - 1) / group) : 0;
  const long long need =
      2 * cap * (two ? 2 : 1) + 3 * parts + 1 + (two ? 2 * groups + 1 : 0);
  if (scratch == nullptr || scratch_elems < need)
    return (int)cudaErrorInvalidValue;
  int2* pairs = (int2*)scratch;
  int2* list = two ? pairs + cap : pairs;  // the partition-ordered list
  int32_t* counts = (int32_t*)scratch + 2 * cap * (two ? 2 : 1);
  int32_t* offs = counts + parts;
  int32_t* cur = offs + parts + 1;
  int32_t* ccur = cur + parts;
  int32_t* cst = ccur + groups;
  const size_t hist_smem = parts * sizeof(int);
  const bool vec = c % 4 == 0 && (uintptr_t)mass % 16 == 0;
  int gv = 1;
  while (gv < c / 4 && gv < 32) gv *= 2;
  auto accum = vec ? tile_accum<true> : tile_accum<false>;
  cudaError_t err = allow_smem((const void*)part_hist, hist_smem);
  if (err == cudaSuccess) err = allow_smem((const void*)accum, tile_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(counts, 0, parts * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((cap + PART_TILE - 1) / PART_TILE);
  part_hist<<<(unsigned)((cap + HIST_TILE - 1) / HIST_TILE), HIST_THREADS,
              hist_smem, st>>>(
      (const int32_t*)ids, (const int32_t*)cnt, slot, cap, b, n,
      (int)part_rows, (int)parts, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  part_scan<<<1, SCAN_THREADS, 0, st>>>(counts, offs, cur, (int)parts, group,
                                        groups, ccur, cst);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // The lanes into partitions (one pass) or into groups (the first of two).
  part_scatter<false><<<tiles, THREADS, 0, st>>>(
      (const int32_t*)ids, nullptr, (const int32_t*)cnt, slot, cap, b, n,
      (int)part_rows, group, two ? groups : (int)parts, (int)parts, offs,
      cst, groups, two ? ccur : cur, pairs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (two) {
    part_scatter<true><<<tiles + groups, THREADS, 0, st>>>(
        nullptr, pairs, (const int32_t*)cnt, slot, cap, b, n, (int)part_rows,
        group, 0, (int)parts, offs, cst, groups, cur, list);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  accum<<<(unsigned)parts, TILE_THREADS, tile_smem, st>>>(
      (int32_t*)acc, list, (const int32_t*)mass, offs, slot, cap, n,
      (int)part_rows, c, vec ? gv : g);
  return (int)cudaGetLastError();
}
