// fused_deposit_add: pending[slot, dst] += 1 for every lane that is valid
// (where a valid mask is given) and whose slot lies in [0, b) and whose dst
// lies in [0, n); any other lane adds nothing.
//
// The ring engine's counting deposit (models/epidemic.py deposit_local):
// each kept edge of a tick's outgoing wave adds one arrival to its
// destination's cell of the delay ring pending int32[b, n].  Replaces the
// TPU kernel gossip_simulator_tpu/ops/pallas_deliver.py fused_deposit_add
// (_deposit_kernel, width None), a serial lane loop whose in-range check
// stands in for the XLA scatter's mode="drop".  The TPU kernel takes dst
// with the invalid lanes already at the sentinel n; here the caller may
// hand the mask instead (valid, bool[m]), which saves it a pass over the
// lanes, and a lane's slot and dst are read only when it is valid.
//
// Bound on the H100: bytes.  Each lane reads its valid byte and, when
// valid, its slot and dst; each touched 32-byte sector of the ring is read
// and written once.  Integer adds commute, so the order in which the lanes
// are added never changes the sums.  Two forms, chosen by the wrapper from
// the shape alone (ops/deliver.py deposit_part_bits):
//
// direct (bits = 0): one grid-stride pass, one global atomicAdd a depositing
//   lane, 16-byte loads where the arrays allow them.  Taken for sparse calls
//   (a compacted ticks chunk: 4.7e5 lanes over a 2e8-cell ring), where
//   every add lands in a sector of its own and ordering the lanes gains
//   nothing.
//
// dense (bits > 0): for calls whose lanes outnumber the ring's cells (the
//   rounds-mode deposit: 6e7 lanes, all into one slot of a 2 x 1e7 ring).
//   Random atomics into a 40 MB row while 480 MB of lanes stream through
//   the same 50 MB L2 ran at a fifth of the L2 atomic rate, so the adds are
//   made in shared memory instead.  The flat range b*n is cut into P
//   partitions of R = 2^bits cells (R * 4 bytes a shared-memory tile: 128
//   KB at the wrapper's 2^15); a lane's offset inside its partition fits
//   16 bits.
//     part_list   each block reads PART_TILE lanes once, counts its
//                 depositing lanes by partition in shared memory, scans the
//                 counts, stages the lanes' offsets in partition order,
//                 claims room in each nonempty partition's bucket with one
//                 global add on the partition's cursor, and writes its
//                 offsets there in runs (2 bytes a lane).  A lane that finds
//                 its bucket full adds straight to pending with a global
//                 atomic and is counted in the overflow word.
//     part_apply  block p takes partition p: it reads and zeroes cursor[p]
//                 (so the cursors need no fill before the next call), and
//                 when the bucket holds lanes it loads the tile, applies
//                 them with shared-memory atomics and writes the tile back,
//                 coalesced.  A partition with no lanes is neither read nor
//                 written.
//   The buckets are sized from m (bcap = ceil(m / P) offsets each, rounded
//   up to 16), not from a second read of the lanes.  Workspace (the
//   wrapper's, per card and stream, zeroed once): cursor int32[PART_MAX]
//   and the overflow word after it; the buckets uint16[P * bcap].
//
// Flat offsets slot*n + dst are 64-bit: b*n passes 2^31 at b = 20 (the
// default -delayhigh) and n = 10^8.
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the last launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "scan.cuh"
#include "smem.cuh"

#define THREADS 256  // a direct block
#define MAX_BLOCKS 8192
// The listing block's shape and the partitions' size were measured on the
// card at the rounds deposit (PERF.md section 6, the block-shape sweep of
// tests/torch_kernel_variants.py): one claim a (block, partition) is the
// pass's largest cost past its loads, so a block lists as many lanes as
// two blocks an SM can hold in registers (64 a thread), and a partition
// is 2^15 cells (ops/deliver.py DEPOSIT_PART_BITS).  The swept constants
// can be set with -D to build a variant.
#ifndef LIST_THREADS
#define LIST_THREADS 512  // a listing block
#endif
#ifndef ROUNDS
#define ROUNDS 4  // four-lane groups a listing thread reads
#endif
#ifndef LIST_MIN_BLOCKS
#define LIST_MIN_BLOCKS 2  // listing blocks an SM the registers leave room for
#endif
#define LIST_ITEMS (4 * ROUNDS)  // lanes a listing thread reads
#define PART_TILE (LIST_THREADS * LIST_ITEMS)  // lanes a listing block
#define CLAIM_BATCH 4  // bucket claims a listing thread has in flight
#ifndef APPLY_THREADS
#define APPLY_THREADS 1024
#endif
#define PART_MAX 8192  // partitions at most (ops/deliver.py DEPOSIT_PART_MAX)
#define CLAIMS (PART_MAX / LIST_THREADS)  // bins a listing thread claims
#define BITS_MAX 16  // a lane's offset in its partition is 16 bits

namespace {

__device__ __forceinline__ bool in_range(int sl, int d, int b, long long n) {
  return sl >= 0 && sl < b && d >= 0 && (long long)d < n;
}

__device__ __forceinline__ void add_one(int32_t* __restrict__ pending,
                                        int sl, int d, int b, long long n) {
  if (in_range(sl, d, b, n)) atomicAdd(pending + (long long)sl * n + d, 1);
}

template <bool kVec>
__global__ void deposit_add(int32_t* __restrict__ pending,
                            const int32_t* __restrict__ slots,
                            const int32_t* __restrict__ dst,
                            const uint8_t* __restrict__ valid, long long m,
                            int b, long long n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (kVec) {
    const long long m4 = m / 4;
    const int4* s4 = reinterpret_cast<const int4*>(slots);
    const int4* d4 = reinterpret_cast<const int4*>(dst);
    const uchar4* v4 = reinterpret_cast<const uchar4*>(valid);
    for (long long i = tid; i < m4; i += stride) {
      uchar4 v = make_uchar4(1, 1, 1, 1);
      if (valid != nullptr) {
        v = v4[i];
        if ((v.x | v.y | v.z | v.w) == 0) continue;
      }
      const int4 s = s4[i];
      const int4 d = d4[i];
      if (v.x) add_one(pending, s.x, d.x, b, n);
      if (v.y) add_one(pending, s.y, d.y, b, n);
      if (v.z) add_one(pending, s.z, d.z, b, n);
      if (v.w) add_one(pending, s.w, d.w, b, n);
    }
    done = 4 * m4;
  }
  for (long long i = done + tid; i < m; i += stride) {
    if (valid == nullptr || valid[i]) add_one(pending, slots[i], dst[i], b, n);
  }
}

// The partition << 16 | offset of a depositing lane, -1 for any other.
__device__ __forceinline__ int lane_key(int sl, int d, int b, long long n,
                                        int bits) {
  if (!in_range(sl, d, b, n)) return -1;
  const long long cell = (long long)sl * n + d;
  return (int)((cell >> bits) << 16) | (int)(cell & ((1LL << bits) - 1));
}

// Shared memory (dynamic): start[parts + 1] (counts, then their exclusive
// scan), base[parts] (the block's claim in each bucket), then the staged
// offsets and partitions, uint16[PART_TILE] each.  Two blocks an SM (the
// register budget), so one block's loads overlap the other's scan, claims
// and runs.  What the lanes need past their loads, by stage on the card
// (PERF.md; tests/torch_kernel_variants.py cuts the pass short at each
// STAGE mark): the counts, the staging while the lanes' keys and ranks
// stay in registers, the claims, the runs out.
__global__ void __launch_bounds__(LIST_THREADS, LIST_MIN_BLOCKS)
part_list(int32_t* __restrict__ pending, const int32_t* __restrict__ slots,
          const int32_t* __restrict__ dst, const uint8_t* __restrict__ valid,
          long long m, int b, long long n, int bits, int parts,
          uint16_t* __restrict__ bucket, long long bcap,
          int32_t* __restrict__ cursor) {
  extern __shared__ int sm[];
  int* s_start = sm;
  int* s_base = sm + parts + 1;
  uint16_t* s_off = reinterpret_cast<uint16_t*>(s_base + parts);
  uint16_t* s_part = s_off + PART_TILE;
  __shared__ int warp_tot[32];
  __shared__ int s_lost;
  const int t = threadIdx.x;
  for (int p = t; p <= parts; p += LIST_THREADS) s_start[p] = 0;
  if (t == 0) s_lost = 0;
  const long long tile0 = (long long)blockIdx.x * PART_TILE;
  // Four consecutive lanes a thread a round, ROUNDS rounds: the valid
  // bytes first, then the slots and dsts of the groups with a valid lane,
  // with 16-byte loads where the arrays and the tile allow them.
  const bool vec = tile0 + PART_TILE <= m && ((uintptr_t)slots & 15) == 0 &&
                   ((uintptr_t)dst & 15) == 0 &&
                   ((uintptr_t)valid & 3) == 0;
  int key[LIST_ITEMS];
  if (vec) {
    uchar4 v[ROUNDS];
#pragma unroll
    for (int q = 0; q < ROUNDS; ++q) {
      const long long i = (tile0 >> 2) + q * LIST_THREADS + t;
      v[q] = valid == nullptr ? make_uchar4(1, 1, 1, 1)
                              : reinterpret_cast<const uchar4*>(valid)[i];
    }
#pragma unroll
    for (int q = 0; q < ROUNDS; ++q) {
      const long long i = (tile0 >> 2) + q * LIST_THREADS + t;
      int4 sl = make_int4(-1, -1, -1, -1), d = sl;
      if (v[q].x | v[q].y | v[q].z | v[q].w) {
        sl = reinterpret_cast<const int4*>(slots)[i];
        d = reinterpret_cast<const int4*>(dst)[i];
      }
      key[4 * q] = v[q].x ? lane_key(sl.x, d.x, b, n, bits) : -1;
      key[4 * q + 1] = v[q].y ? lane_key(sl.y, d.y, b, n, bits) : -1;
      key[4 * q + 2] = v[q].z ? lane_key(sl.z, d.z, b, n, bits) : -1;
      key[4 * q + 3] = v[q].w ? lane_key(sl.w, d.w, b, n, bits) : -1;
    }
  } else {
#pragma unroll
    for (int q = 0; q < ROUNDS; ++q) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const long long i = tile0 + 4 * ((long long)q * LIST_THREADS + t) + x;
        const bool ok = i < m && (valid == nullptr || valid[i] != 0);
        key[4 * q + x] = ok ? lane_key(slots[i], dst[i], b, n, bits) : -1;
      }
    }
  }
  // STAGE 1
  __syncthreads();  // s_start zeroed
  int rank[LIST_ITEMS];
#pragma unroll
  for (int r = 0; r < LIST_ITEMS; ++r)
    rank[r] = key[r] >= 0 ? atomicAdd(&s_start[key[r] >> 16], 1) : 0;
  __syncthreads();
  // STAGE 2
  // Exclusive scan of the counts: each thread a run of consecutive bins.
  const int per = (parts + LIST_THREADS - 1) / LIST_THREADS;
  const int lo = min(t * per, parts), hi = min(lo + per, parts);
  int sum = 0;
  for (int p = lo; p < hi; ++p) sum += s_start[p];
  int run = scan::block_excl<LIST_THREADS>(sum, warp_tot);
  for (int p = lo; p < hi; ++p) {
    const int c = s_start[p];
    s_start[p] = run;
    run += c;
  }
  if (t == LIST_THREADS - 1) s_start[parts] = run;
  __syncthreads();
  // STAGE 3
  // The lanes staged in partition order.
#pragma unroll
  for (int r = 0; r < LIST_ITEMS; ++r) {
    if (key[r] >= 0) {
      const int p = key[r] >> 16;
      const int at = s_start[p] + rank[r];
      s_off[at] = (uint16_t)(key[r] & 0xffff);
      s_part[at] = (uint16_t)p;
    }
  }
  // STAGE 4
  // One claim a nonempty (block, partition), a thread's claims all in
  // flight before their results are stored.
#pragma unroll
  for (int k0 = 0; k0 < CLAIMS; k0 += CLAIM_BATCH) {
    int c[CLAIM_BATCH], got[CLAIM_BATCH];
#pragma unroll
    for (int k = 0; k < CLAIM_BATCH; ++k) {
      const int p = (k0 + k) * LIST_THREADS + t;
      c[k] = p < parts ? s_start[p + 1] - s_start[p] : 0;
    }
#pragma unroll
    for (int k = 0; k < CLAIM_BATCH; ++k) {
      const int p = (k0 + k) * LIST_THREADS + t;
      got[k] = c[k] ? atomicAdd(&cursor[p], c[k]) : 0;
    }
#pragma unroll
    for (int k = 0; k < CLAIM_BATCH; ++k)
      if (c[k]) s_base[(k0 + k) * LIST_THREADS + t] = got[k];
    if ((k0 + CLAIM_BATCH) * LIST_THREADS >= parts) break;
  }
  __syncthreads();
  // STAGE 5
  // Runs out: consecutive staged lanes of one partition to consecutive
  // bucket offsets.
  const int total = s_start[parts];
  int lost = 0;
  for (int j = t; j < total; j += LIST_THREADS) {
    const int p = s_part[j];
    const long long g = (long long)s_base[p] + (j - s_start[p]);
    if (g < bcap) {
      bucket[(long long)p * bcap + g] = s_off[j];
    } else {
      atomicAdd(pending + ((long long)p << bits) + s_off[j], 1);
      ++lost;
    }
  }
  if (lost) atomicAdd(&s_lost, lost);
  __syncthreads();
  if (t == 0 && s_lost) atomicAdd(&cursor[PART_MAX], s_lost);
}

// Block p: partition p's bucket applied to its tile of pending in shared
// memory (dynamic, 2^bits int32), then written back.
__global__ void __launch_bounds__(APPLY_THREADS)
part_apply(int32_t* __restrict__ pending, long long cells, int bits,
           const uint16_t* __restrict__ bucket, long long bcap,
           int32_t* __restrict__ cursor) {
  extern __shared__ int4 tile4[];
  int32_t* tile = reinterpret_cast<int32_t*>(tile4);
  __shared__ int s_cnt;
  const int t = threadIdx.x;
  const int p = blockIdx.x;
  if (t == 0) {
    const int c = cursor[p];
    cursor[p] = 0;
    s_cnt = (long long)c < bcap ? c : (int)bcap;
  }
  __syncthreads();
  const int c = s_cnt;
  if (c == 0) return;
  const long long c0 = (long long)p << bits;
  const int len = (int)min(1LL << bits, cells - c0);
  int32_t* g = pending + c0;
  const bool vec = ((uintptr_t)g & 15) == 0 && (len & 3) == 0;
  if (vec) {
    const int4* g4 = reinterpret_cast<const int4*>(g);
    for (int i = t; i < len / 4; i += APPLY_THREADS) tile4[i] = g4[i];
  } else {
    for (int i = t; i < len; i += APPLY_THREADS) tile[i] = g[i];
  }
  __syncthreads();
  // Eight offsets a load: a bucket starts 32-byte aligned (bcap is a
  // multiple of 16).
  const uint16_t* bk = bucket + (long long)p * bcap;
  const int c8 = c / 8;
  const uint4* bk8 = reinterpret_cast<const uint4*>(bk);
  for (int j = t; j < c8; j += APPLY_THREADS) {
    const uint4 w = bk8[j];
    atomicAdd(&tile[w.x & 0xffff], 1);
    atomicAdd(&tile[w.x >> 16], 1);
    atomicAdd(&tile[w.y & 0xffff], 1);
    atomicAdd(&tile[w.y >> 16], 1);
    atomicAdd(&tile[w.z & 0xffff], 1);
    atomicAdd(&tile[w.z >> 16], 1);
    atomicAdd(&tile[w.w & 0xffff], 1);
    atomicAdd(&tile[w.w >> 16], 1);
  }
  for (int j = c8 * 8 + t; j < c; j += APPLY_THREADS)
    atomicAdd(&tile[bk[j]], 1);
  __syncthreads();
  if (vec) {
    int4* g4 = reinterpret_cast<int4*>(g);
    for (int i = t; i < len / 4; i += APPLY_THREADS) g4[i] = tile4[i];
  } else {
    for (int i = t; i < len; i += APPLY_THREADS) g[i] = tile[i];
  }
}

}  // namespace

// pending: int32[b * n], updated in place; slots, dst: int32[m]; valid:
// bool[m] or null.  bits = 0 takes the direct form; bits in [1, 16] the
// dense form with partitions of 2^bits cells, ws the int32[PART_MAX + 1]
// workspace (cursors, zeroed before the first call; the overflow word) and
// bucket uint16[P * bcap], bcap a multiple of 16.
extern "C" int gossip_fused_deposit_add(void* pending, const void* slots,
                                        const void* dst, const void* valid,
                                        long long m, int b, long long n,
                                        int bits, void* ws, void* bucket,
                                        long long bcap, void* stream) {
  if (m < 0 || b < 0 || n < 0 || bits < 0 || bits > BITS_MAX)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || b == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* vd = (const uint8_t*)valid;
  if (bits == 0) {
    const bool vec = ((uintptr_t)slots & 15) == 0 &&
                     ((uintptr_t)dst & 15) == 0 &&
                     ((uintptr_t)valid & 3) == 0;
    const long long work = vec ? (m + 3) / 4 : m;
    long long blocks = (work + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    if (vec)
      deposit_add<true><<<(unsigned)blocks, THREADS, 0, st>>>(
          (int32_t*)pending, (const int32_t*)slots, (const int32_t*)dst, vd,
          m, b, n);
    else
      deposit_add<false><<<(unsigned)blocks, THREADS, 0, st>>>(
          (int32_t*)pending, (const int32_t*)slots, (const int32_t*)dst, vd,
          m, b, n);
    return (int)cudaGetLastError();
  }
  const long long cells = (long long)b * n;
  const long long parts = (cells + (1LL << bits) - 1) >> bits;
  if (parts > PART_MAX || ws == nullptr || bucket == nullptr || bcap < 16 ||
      bcap % 16 != 0 || bcap > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem_list =
      (2 * parts + 1) * sizeof(int) + 2 * PART_TILE * sizeof(uint16_t);
  cudaError_t err = allow_smem((const void*)part_list, smem_list);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (m + PART_TILE - 1) / PART_TILE;
  part_list<<<(unsigned)blocks, LIST_THREADS, smem_list, st>>>(
      (int32_t*)pending, (const int32_t*)slots, (const int32_t*)dst, vd, m,
      b, n, bits, (int)parts, (uint16_t*)bucket, bcap, (int32_t*)ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_apply = (size_t)sizeof(int32_t) << bits;
  err = allow_smem((const void*)part_apply, smem_apply);
  if (err != cudaSuccess) return (int)err;
  part_apply<<<(unsigned)parts, APPLY_THREADS, smem_apply, st>>>(
      (int32_t*)pending, cells, bits, (const uint16_t*)bucket, bcap,
      (int32_t*)ws);
  return (int)cudaGetLastError();
}
