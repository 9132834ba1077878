// erdos_pallas: sparse directed Erdos-Renyi rows [row0, row0 + rows):
// friends int32[rows, cap], -1 at and past each row's degree, and the
// degrees int32[rows].
//
// Replaces the TPU kernel gossip_simulator_tpu/ops/pallas_graph.py
// erdos_pallas (_erdos_kernel and its wrapper), which draws cap + 1 words
// a row from the TPU's hardware PRNG.  That stream exists only on a TPU,
// so this kernel draws the same words from threefry: bits(fold_in(sk, r),
// cap + 1) for global row r, sk = fold_in(graph key, ER_STREAM), the
// JAX kernel's stream tag (ops/graph.py).  The arithmetic is the TPU
// kernel's:
//   u    = (bits[0] >> 8) * 2^-24
//   deg  = #{j < cap : u > cdf_j}, cdf_j = cdf_{j-1} + pmf_j,
//          pmf_0 = float32(exp(-lam)), pmf_{j+1} = pmf_j * (lam / (j + 1))
//   peer = bits[1 + c] % n, then the (id + 1) % n self patch; -1 at c >= deg.
// cdf_j depends on lam and j alone: the wrapper passes the table
// (ops/graph.erdos_cdf, float32 rounding at every step) in the launch's
// parameters, and no block builds it.  The table is nondecreasing (each
// step adds a pmf >= 0), so the degree is a binary search for the first
// cdf_j >= u.
//
// Bound on the H100: a live cell (c < deg) costs one threefry block (20
// rotates and 20 xors on the integer ALU pipe, ~72 instructions in all)
// and a remainder by n; a row two blocks and a search.  The output is 4 B
// a cell plus 4 B a row: 1.2 GB at 1e7 rows x 29, 0.36 ms at 3.35 TB/s,
// above the operations' ~0.28 ms at lam 8; at lam 60 (6e7 live cells on
// 1e6 rows) the operations decide.  A warp's lanes therefore take live
// cells only: walking the tile's rows * cap cells one a thread, nearly
// every warp held a live lane and paid the block for all 32 (at lam 8,
// 28 % of the cells are live).
//
// Layout: one block takes a tile of up to THREADS rows (fewer where the
// tile's cells would pass TILE_BYTES: 72 at cap 111).  Pass 1: a thread a
// row derives the row key, draws word 0 and finds the degree; the degrees
// are scanned across the block into each row's first live cell.  Pass 2:
// the tile's live cells are cut into one run of consecutive cells a
// thread; a thread finds its first cell's row by a binary search over the
// scanned starts and walks on row by row, drawing each cell's word,
// reducing it mod n by a multiply-high with a magic number fixed for the
// launch (Granlund-Montgomery, the round-up variant: exact for every
// 32-bit dividend and n in [2, 2^31)) and self-patching.  The cells go to
// a shared-memory tile of the block's rows, filled with -1 first, which
// is written out in 16-byte stores: every cell is stored once, coalesced.
// (Measured on the card, PERF.md: a search a cell cost as much as the
// dead lanes it saved at lam 60; storing the live cells straight to
// friends, with a second pass for the dead ones, was slower than the
// tile.)  The graph key is read from device memory (no host read in the
// call).
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the launch.  gossip_erdos_urem applies the same
// remainder to an array, for the tests.

#include <cuda_runtime.h>
#include <cstdint>

#include "scan.cuh"
#include "smem.cuh"
#include "threefry.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define CAP_MAX 128  // the JAX kernel's lane tile (ops/graph.py LANES)
// The tile and the register budget were measured on the card (PERF.md
// section 6, the sweep of tests/torch_kernel_variants.py); either can be
// set with -D to build a variant.
#ifndef TILE_BYTES
#define TILE_BYTES (32 * 1024)  // the output tile a block at most
#endif
// Blocks an SM the register budget keeps room for (six tiles of up to 32
// KB fit the SM's shared memory): the fastest of the budgets tried.
#ifndef MIN_BLOCKS
#define MIN_BLOCKS 6
#endif
#define ER_STREAM 0x4552D14Du  // ops/graph.py ER_STREAM

namespace {

struct Cdf {
  float v[CAP_MAX];
};

// x mod d for a divisor d in [2, 2^31) fixed for the launch: with l =
// ceil(log2 d) and magic = floor(2^32 (2^l - d) / d) + 1, q = (t + ((x - t)
// >> 1)) >> (l - 1), t = mulhi(x, magic), is floor(x / d) for every
// 32-bit x (Granlund and Montgomery, 1994, figure 4.1).
struct Divisor {
  uint32_t d, magic;
  int shift;  // l - 1
};

Divisor make_divisor(uint32_t d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  const uint64_t magic = ((((1ull << l) - d) << 32) / d) + 1;
  return {d, (uint32_t)magic, l - 1};
}

__device__ __forceinline__ uint32_t urem(uint32_t x, Divisor v) {
  const uint32_t t = __umulhi(x, v.magic);
  const uint32_t q = (t + ((x - t) >> 1)) >> v.shift;
  return x - q * v.d;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
erdos(int32_t* __restrict__ friends, int32_t* __restrict__ deg,
      const long long* __restrict__ key, const __grid_constant__ Cdf cdf,
      int cap, int row0, int rows, int tile_rows, Divisor div,
      bool partitionable) {
  extern __shared__ int4 s_raw[];  // the tile's tile_rows * cap cells
  int32_t* s_out = reinterpret_cast<int32_t*>(s_raw);
  __shared__ float s_cdf[CAP_MAX];
  __shared__ threefry::Key s_key[THREADS];
  __shared__ int s_start[THREADS + 1];
  __shared__ int warp_tot[WARPS];
  __shared__ threefry::Key s_stream;
  const int t = threadIdx.x;
  if (t < cap) s_cdf[t] = cdf.v[t];
  if (t == 32)
    s_stream = threefry::fold_in({(uint32_t)key[0], (uint32_t)key[1]},
                                 ER_STREAM);
  const long long tile0 = (long long)blockIdx.x * tile_rows;
  const int nrows = (int)min((long long)tile_rows, rows - tile0);
  const int cells = nrows * cap;
  const int4 neg = make_int4(-1, -1, -1, -1);
  for (int i = t; i < (cells + 3) / 4; i += THREADS) s_raw[i] = neg;
  __syncthreads();
  const uint32_t size = (uint32_t)cap + 1;
  const uint32_t gid0 = (uint32_t)(row0 + tile0);
  int d = 0;
  if (t < nrows) {
    const threefry::Key rk = threefry::fold_in(s_stream, gid0 + t);
    const uint32_t b0 = threefry::bits(rk, 0, size, partitionable);
    const float u = __fmul_rn(__int2float_rn((int)(b0 >> 8)), 0x1p-24f);
    int lo = 0, hi = cap;  // the first j with cdf_j >= u
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cdf[mid] < u)
        lo = mid + 1;
      else
        hi = mid;
    }
    d = lo;
    s_key[t] = rk;
    deg[tile0 + t] = d;
  }
  const int start = scan::block_excl<THREADS>(d, warp_tot);
  s_start[t] = start;
  if (t == THREADS - 1) s_start[THREADS] = start + d;
  __syncthreads();
  // Each thread a run of consecutive live cells: one search for its first
  // cell's row, then row by row (a row of degree 0 holds none).
  const int live = s_start[THREADS];
  const int per = (live + THREADS - 1) / THREADS;
  int e = min(t * per, live);
  const int end = min(e + per, live);
  if (e < end) {
    int lo = 0, hi = THREADS;  // the last row whose first live cell <= e
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_start[mid] <= e)
        lo = mid;
      else
        hi = mid;
    }
    int r = lo, c = e - s_start[r], rend = s_start[r + 1];
    threefry::Key k = s_key[r];
    for (; e < end; ++e, ++c) {
      if (e == rend) {
        do {
          ++r;
          rend = s_start[r + 1];
        } while (rend == e);
        c = 0;
        k = s_key[r];
      }
      uint32_t p = urem(threefry::bits(k, c + 1, size, partitionable), div);
      const uint32_t gid = gid0 + r;
      if (p == gid) p = p + 1 == div.d ? 0 : p + 1;
      s_out[r * cap + c] = (int32_t)p;
    }
  }
  __syncthreads();
  int32_t* out = friends + tile0 * cap;
  if (((uintptr_t)out & 15) == 0) {
    int4* o4 = reinterpret_cast<int4*>(out);
    for (int i = t; i < cells / 4; i += THREADS) o4[i] = s_raw[i];
    for (int i = cells / 4 * 4 + t; i < cells; i += THREADS)
      out[i] = s_out[i];
  } else {
    for (int i = t; i < cells; i += THREADS) out[i] = s_out[i];
  }
}

__global__ void urem_check(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ out, long long m,
                           Divisor div) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = urem(x[i], div);
}

}  // namespace

// key: int64[2] on the card (the graph key's two words); cdf: host
// float[cap], copied into the launch's parameters.
extern "C" int gossip_erdos_pallas(void* friends, void* deg, const void* key,
                                   const float* cdf, int n, int cap,
                                   int row0, int rows, int partitionable,
                                   void* stream) {
  if (n < 2 || cap < 1 || cap > CAP_MAX || row0 < 0 || rows < 0 ||
      key == nullptr || cdf == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  Cdf table;
  for (int j = 0; j < CAP_MAX; ++j) table.v[j] = j < cap ? cdf[j] : 0.0f;
  int tile_rows = (TILE_BYTES / (4 * cap)) & ~3;
  if (tile_rows > THREADS) tile_rows = THREADS;
  if (tile_rows < 4) tile_rows = 4;
  const size_t smem = (size_t)tile_rows * cap * sizeof(int32_t);
  cudaError_t err = allow_smem((const void*)erdos, smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = (int)(((long long)rows + tile_rows - 1) / tile_rows);
  erdos<<<nb, THREADS, smem, (cudaStream_t)stream>>>(
      (int32_t*)friends, (int32_t*)deg, (const long long*)key, table, cap,
      row0, rows, tile_rows, make_divisor((uint32_t)n), partitionable != 0);
  return (int)cudaGetLastError();
}

extern "C" int gossip_erdos_urem(const void* x, void* out, long long m,
                                 int n, void* stream) {
  if (n < 2 || m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  long long blocks = (m + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  urem_check<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, m, make_divisor((uint32_t)n));
  return (int)cudaGetLastError();
}
