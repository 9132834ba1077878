// fused_ring_append: append one entry per valid lane into its window slot
// of the packed ring(s), for one batch of m lanes:
//
//   slot           wc = clamp(wslot[i], 0, dw - 1)
//   position       pos[i] = cnt[wc] + number of valid lanes j < i with the
//                  same slot (lane order)
//   capacity       ok = valid[i] && pos < cap
//   ring write     ring0[wc*cap + pos] = pay0[i] (and ring1's row at the
//                  same position = pay1's row i) when ok
//   trash          the trash cell ring0[dw*cap] (and ring1's row there) is
//                  set to 0 when some lane is not ok (invalid or past the
//                  capacity), and keeps its value when every lane is ok
//   counts         cnt[s] += ok lanes of slot s; dropped += valid && !ok
//
// Replaces the TPU kernel gossip_simulator_tpu/ops/pallas_deliver.py
// fused_ring_append (_ring_kernel), one serial loop over lanes whose
// per-slot counter gives each lane its position and whose every non-ok
// lane stores 0 to the trash cell (so the cell ends at 0 iff some lane is
// not ok: one write a call gives the same bits).  Here the same positions
// come from the single-pass scan of csrc/lookback.cuh (shared with
// fused_recv_land), never from the order atomics happen to run in.
//
// The companion ring ring1 is flat (w1 = 1: the overlay's payload ring) or
// wide, int32[L, w1] (PushSum's mass ring, w1 = (dim + 1) * 4 limbs, 8 to
// 36): each lane's whole payload row lands at its position.  Row offsets
// are 64-bit: the mass ring's flat * w1 passes 2^31 at n = 1e7 (2.1e8 rows
// x 12).
//
// Bound on the H100: bytes.  At the overlay's shape (m = 262,144 lanes,
// two flat rings, dw = 3, a tenth of the lanes invalid) a call reads 13 B
// per lane and writes 8 B per landed lane, ~5.3 MB (~1.6 us at 3.35
// TB/s); there the host's enqueue and the launches are the cost, so the
// call is one launch with no allocation or fill (it was four launches, a
// torch.zeros and a per-lane trash store).  The wide form at PushSum's
// full size (m = 6e7 lanes, w1 = 12, dw = 3) reads 57 B and writes 52 B
// per lane, ~6.5 GB (~2.0 ms); there the rows go through the staged list,
// neighbouring threads on neighbouring 16-byte pieces (a thread a lane
// with twelve 4-byte stores spanned 32 rows a warp instruction), and the
// trash row is written once a call, not once per lane that does not land.
//
// One kernel, ring_append, a tile of TILE lanes a block: load the tile's
// slots and flags (all in flight at once), rank the valid lanes
// (rank_tile), resolve the earlier blocks' counts (look_back), write the
// ids (and a flat ring1's entries) and stage a wide ring1's rows; the last
// block to finish settles cnt and dropped, zeroes the trash cell and its
// row once if fewer than m lanes landed, and leaves the workspace's
// counters at 0.
//
// Past DW_LIMIT (1024) window slots the per-slot tables move to global
// memory (lookback.cuh's global form: the same steps, a bounded grid of
// blocks taking tiles by ticket).
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the launch.

#include "lookback.cuh"

namespace {

using lookback::u64;

__device__ __forceinline__ int clamp_slot(int w, int dw) {
  return w < 0 ? 0 : (w >= dw ? dw - 1 : w);
}

template <bool GLB>
__global__ void __launch_bounds__(THREADS)
ring_append(int32_t* __restrict__ ring0, int32_t* __restrict__ ring1,
            const int32_t* __restrict__ pay0,
            const int32_t* __restrict__ pay1,
            const int32_t* __restrict__ wslot,
            const uint8_t* __restrict__ valid, int32_t* __restrict__ cnt,
            long long m, int dw, long long cap, int w1, bool vec4,
            int32_t* __restrict__ dropped, u64* __restrict__ ws, int* aux,
            long long nb, unsigned epoch) {
  extern __shared__ int smem[];
  const lookback::Slots sl =
      lookback::carve(lookback::tables<GLB>(smem, aux, dw), dw);
  __shared__ int s_src[TILE];
  __shared__ long long s_row[TILE];
  __shared__ int s_nok;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const bool wide = ring1 != nullptr && w1 > 1;

  // A tile a block (GLB: tiles by ticket until none is left).
  for (;;) {
    const long long blk = lookback::ticket(ws, sl, dw, &s_nok);
    if (GLB && blk >= nb) break;
    const long long tile0 = blk * TILE;

    // Warp wid takes the tile's lanes [wid * 32 * ITEMS, (wid + 1) * 32 *
    // ITEMS) in ITEMS rounds of 32, all the loads in flight at once.
    const long long lane0 = tile0 + wid * (32 * ITEMS) + lane;
    int slot[ITEMS], rank[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const long long i = lane0 + r * 32;
      slot[r] = i < m ? wslot[i] : 0;
      rank[r] = i < m ? (int)valid[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      slot[r] = clamp_slot(slot[r], dw);
      rank[r] = rank[r] != 0 ? 0 : -1;
    }
    lookback::rank_tile(slot, rank, sl, dw);
    lookback::look_back(ws, blk, dw, epoch, sl);

    // Positions, the id writes (a flat ring1's too), and a wide ring1's
    // landed lanes staged for their rows.
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      bool ok = false;
      long long row = 0;
      if (rank[r] >= 0) {
        const int s = slot[r];
        const long long pos = (long long)cnt[s] + sl.aux[s] + rank[r];
        ok = pos < cap;
        row = s * cap + pos;
        if (ok) {
          const long long i = lane0 + r * 32;
          ring0[row] = pay0[i];
          if (ring1 != nullptr && !wide) ring1[row] = pay1[i];
        }
      }
      if (wide)
        lookback::stage(ok, (int)(lane0 - tile0) + r * 32, row, &s_nok, s_src,
                        s_row);
    }
    if (wide) {
      __syncthreads();
      lookback::copy_rows(ring1, pay1, s_src, s_row, s_nok, w1, vec4, tile0);
    }
    if (!GLB) break;
    __syncthreads();  // the tile's lists are read before the next ticket
  }

  // The last block to finish: counts, the trash cell, the counters.
  if (!lookback::last_to_finish(ws)) return;
  const long long landed =
      lookback::settle(ws, cnt, dropped, dw, cap, GLB ? nb : gridDim.x);
  if (landed < m) {
    const long long trash = (long long)dw * cap;
    if (t == 0) ring0[trash] = 0;
    if (ring1 != nullptr)
      for (int c = t; c < w1; c += THREADS) ring1[trash * w1 + c] = 0;
  }
}

template <bool GLB>
cudaError_t launch(int32_t* ring0, int32_t* ring1, const int32_t* pay0,
                   const int32_t* pay1, const int32_t* wslot,
                   const uint8_t* valid, int32_t* cnt, long long m, int dw,
                   long long cap, int w1, bool vec4, int32_t* dropped,
                   u64* ws, int* aux, unsigned epoch, cudaStream_t st) {
  const long long nb = m > 0 ? (m + TILE - 1) / TILE : 1;
  const size_t shmem = GLB ? 0 : lookback::slots_bytes(dw);
  cudaError_t e = allow_smem((const void*)ring_append<GLB>, shmem);
  if (e != cudaSuccess) return e;
  ring_append<GLB><<<lookback::grid_of(nb, dw), THREADS, shmem, st>>>(
      ring0, ring1, pay0, pay1, wslot, valid, cnt, m, dw, cap, w1, vec4,
      dropped, ws, aux, nb, epoch);
  return cudaGetLastError();
}

}  // namespace

// ring1/pay1 may be null (one ring); at m = 0 the inputs pay0, pay1, wslot
// and valid may be null (an empty tensor's storage).  ring1 rows and pay1
// rows hold w1 int32 columns (1: a flat ring).  ws is the int64 workspace
// of at least WS_HEAD + max(1, ceil(m / TILE)) * dw words (ops/deliver.py
// workspace_words), zeroed when it was made; epoch in [1, EPOCH_MAX), new
// for every call that uses ws.  Past DW_LIMIT slots aux is the workspace's
// second part, int32[aux_words >= aux_ints(dw, nb)], zeroed when it was
// made (ops/deliver.py aux_ints); else it may be null.
extern "C" int gossip_fused_ring_append(
    void* ring0, void* ring1, const void* pay0, const void* pay1,
    const void* wslot, const void* valid, void* cnt, int m, int dw, int cap,
    int w1, void* dropped, void* ws, long long ws_words, int epoch,
    void* aux, long long aux_words, void* stream) {
  if (dw < 1 || w1 < 1 || m < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  // An empty batch's payloads may have no storage (a null pointer).
  if (m > 0 && (ring1 == nullptr) != (pay1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      lookback::check_ws(m, dw, ws, ws_words, epoch, aux, aux_words);
  if (e != cudaSuccess) return (int)e;
  const bool vec4 = ring1 != nullptr && w1 % 4 == 0
                    && (uintptr_t)ring1 % 16 == 0
                    && (uintptr_t)pay1 % 16 == 0;
  decltype(&launch<false>) f = dw > DW_LIMIT ? &launch<true> : &launch<false>;
  return (int)f((int32_t*)ring0, (int32_t*)ring1, (const int32_t*)pay0,
                (const int32_t*)pay1, (const int32_t*)wslot,
                (const uint8_t*)valid, (int32_t*)cnt, m, dw, cap, w1, vec4,
                (int32_t*)dropped, (u64*)ws, (int*)aux, (unsigned)epoch,
                (cudaStream_t)stream);
}
