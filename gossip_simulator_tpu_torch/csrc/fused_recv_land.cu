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
// One kernel, recv_land, a tile of TILE lanes a block, on the single-pass
// append of csrc/lookback.cuh (shared with fused_ring_append): decode and
// filter the tile's wire words, rank the survivors (rank_tile), resolve
// the earlier blocks' counts (look_back), write the ids and stage the
// landed rows (copied piece by piece), add the duplicate counts into the
// workspace's sup cells; the last block to finish settles cnt and dropped,
// writes all of sup, zeroes the trash cell and its row once if fewer than
// m lanes landed, and leaves the workspace's counters at 0.
//
// Widths: any dw (past DW_LIMIT slots, lookback.cuh's global form);
// ring1 is int32[L, w1] (PushSum's mass limbs); row offsets are 64-bit.
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the launch.

#include "lookback.cuh"

namespace {

using lookback::u64;

template <bool GLB>
__global__ void __launch_bounds__(THREADS)
recv_land(int32_t* __restrict__ ring0, int32_t* __restrict__ ring1,
          const int32_t* __restrict__ recv, const int32_t* __restrict__ words,
          const uint8_t* __restrict__ flags, int32_t* __restrict__ cnt,
          long long m, int dw, long long cap, int b, int w1, bool vec4,
          int rbit,
          int32_t* __restrict__ dropped, int32_t* __restrict__ sup,
          u64* __restrict__ ws, int* aux, long long nb, unsigned epoch) {
  extern __shared__ int smem[];
  const lookback::Slots sl =
      lookback::carve(lookback::tables<GLB>(smem, aux, dw), dw);
  int* s_sup = sl.aux;  // the duplicates, until look_back
  __shared__ int s_src[TILE];
  __shared__ long long s_row[TILE];
  __shared__ int s_nok;
  int* sup_acc = lookback::acc_sums<GLB>(ws, aux);
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;

  // A tile a block (GLB: tiles by ticket until none is left).
  for (;;) {
    for (int j = t; j < dw; j += THREADS) s_sup[j] = 0;
    const long long blk = lookback::ticket(ws, sl, dw, &s_nok);
    if (GLB && blk >= nb) break;
    const long long tile0 = blk * TILE;

    // Decode and filter: warp wid takes the tile's lanes [wid * 32 * ITEMS,
    // (wid + 1) * 32 * ITEMS) in ITEMS rounds of 32, all the loads in flight
    // at once.
    const long long lane0 = tile0 + wid * (32 * ITEMS) + lane;
    int slot[ITEMS], rank[ITEMS], entry[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
      entry[r] = lane0 + r * 32 < m ? recv[lane0 + r * 32] : -1;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int32_t x = entry[r];
      slot[r] = 0;
      rank[r] = -1;
      if (x >= 0) {
        const int32_t d = x / (dw * b);
        slot[r] = (x / b) % dw;
        entry[r] = d * b + x % b;
        rank[r] = 0;
        if (flags != nullptr && (flags[d] & rbit) != 0) {
          rank[r] = -1;
          atomicAdd(&s_sup[slot[r]], 1);
        }
      }
    }
    lookback::rank_tile(slot, rank, sl, dw);
    for (int j = t; j < dw; j += THREADS)
      if (s_sup[j]) atomicAdd(&sup_acc[j], s_sup[j]);
    lookback::look_back(ws, blk, dw, epoch, sl);

    // Positions, the id writes, and the landed lanes staged for their rows.
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      bool ok = false;
      long long row = 0;
      if (rank[r] >= 0) {
        const int s = slot[r];
        const long long pos = (long long)cnt[s] + sl.aux[s] + rank[r];
        ok = pos < cap;
        row = s * cap + pos;
        if (ok) ring0[row] = entry[r];
      }
      if (ring1 != nullptr)
        lookback::stage(ok, (int)(lane0 - tile0) + r * 32, row, &s_nok, s_src,
                        s_row);
    }
    if (ring1 != nullptr) {
      __syncthreads();
      lookback::copy_rows(ring1, words, s_src, s_row, s_nok, w1, vec4, tile0);
    }
    if (!GLB) break;
    __syncthreads();  // the tile's lists are read before the next ticket
  }

  // The last block to finish: counts, sup, the trash cell, the counters.
  if (!lookback::last_to_finish(ws)) return;
  const long long landed =
      lookback::settle(ws, cnt, dropped, dw, cap, GLB ? nb : gridDim.x);
  for (int j = t; j < dw; j += THREADS) {
    volatile int* acc = sup_acc;
    sup[j] = acc[j];
    acc[j] = 0;
  }
  if (landed < m) {
    const long long trash = (long long)dw * cap;
    if (t == 0) ring0[trash] = 0;
    if (ring1 != nullptr)
      for (int c = t; c < w1; c += THREADS) ring1[trash * w1 + c] = 0;
  }
}

template <bool GLB>
cudaError_t launch(int32_t* ring0, int32_t* ring1, const int32_t* recv,
                   const int32_t* words, const uint8_t* flags, int32_t* cnt,
                   long long m, int dw, long long cap, int b, int w1,
                   bool vec4, int rbit, int32_t* dropped, int32_t* sup,
                   u64* ws, int* aux, unsigned epoch, cudaStream_t st) {
  const long long nb = m > 0 ? (m + TILE - 1) / TILE : 1;
  const size_t shmem = GLB ? 0 : lookback::slots_bytes(dw);
  cudaError_t e = allow_smem((const void*)recv_land<GLB>, shmem);
  if (e != cudaSuccess) return e;
  recv_land<GLB><<<lookback::grid_of(nb, dw), THREADS, shmem, st>>>(
      ring0, ring1, recv, words, flags, cnt, m, dw, cap, b, w1, vec4, rbit,
      dropped, sup, ws, aux, nb, epoch);
  return cudaGetLastError();
}

}  // namespace

// ring1/words may be null (no word rows; w1 is then ignored); flags may be
// null (no duplicate filter).  sup int32[dw] is written whole.  ws is the
// int64 workspace of at least WS_HEAD + max(1, ceil(m / TILE)) * dw words
// (ops/deliver.py workspace_words), zeroed when it was made; epoch in
// [1, EPOCH_MAX), new for every call that uses ws.  Past DW_LIMIT slots
// aux is the workspace's second part, int32[aux_words >= aux_ints(dw,
// nb)], zeroed when it was made; else it may be null.
extern "C" int gossip_fused_recv_land(
    void* ring0, void* ring1, const void* recv, const void* words,
    const void* flags, void* cnt, int m, int dw, int cap, int b, int w1,
    int rbit, void* dropped, void* sup, void* ws, long long ws_words,
    int epoch, void* aux, long long aux_words, void* stream) {
  if (dw < 1 || b < 1 || m < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  if ((ring1 == nullptr) != (words == nullptr))
    return (int)cudaErrorInvalidValue;
  if (ring1 != nullptr && w1 < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      lookback::check_ws(m, dw, ws, ws_words, epoch, aux, aux_words);
  if (e != cudaSuccess) return (int)e;
  const bool vec4 = ring1 != nullptr && w1 % 4 == 0
                    && (uintptr_t)ring1 % 16 == 0
                    && (uintptr_t)words % 16 == 0;
  decltype(&launch<false>) f = dw > DW_LIMIT ? &launch<true> : &launch<false>;
  return (int)f((int32_t*)ring0, (int32_t*)ring1, (const int32_t*)recv,
                (const int32_t*)words, (const uint8_t*)flags, (int32_t*)cnt,
                m, dw, cap, b, w1, vec4, rbit, (int32_t*)dropped,
                (int32_t*)sup, (u64*)ws, (int*)aux, (unsigned)epoch,
                (cudaStream_t)stream);
}
