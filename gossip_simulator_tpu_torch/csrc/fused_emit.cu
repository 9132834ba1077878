// fused_emit: the event engine's emission from the gathered friends rows
// down, for one batch of m senders with k friend columns each:
//
//   edge mask      v[i] & !drop[i,kk] & sf[i,kk] >= 0
//   partition      (pmask != null) an edge whose pmask[i,kk] is set is
//                  blocked (cleared) and counted in blocked, before the
//                  duplicate filter
//   dup filter     (flags != null) an edge whose destination already has
//                  the RECEIVED bit is suppressed and counted in sup[slot]
//   SIR trigger    (strig != null) one more lane right after the kept edges
//   reservation    start[i] = base[slot] + sum of ec[j] over earlier valid
//                  senders j of the same slot (ec = kept lanes of a row)
//   capacity       okr = v & start + ec <= cap; adds[slot] += okr ? ec : 0,
//                  lost += okr ? 0 : ec
//   ring write     lane kk of row i writes its payload (sf*b + off, or the
//                  trigger tb + id*b + off) at slot*cap + start + col when
//                  it is a kept lane of an okr row, else its value (0 for a
//                  non-edge) at the unique trash lane dw*cap + i*kw + kk.
//   rumor words    (swords != null, multi-rumor traffic) every lane also
//                  writes W words at its cell of the (L, W) word ring: its
//                  row's swords[i] where it is a kept lane, else 0.
//
// Replaces the TPU kernel gossip_simulator_tpu/ops/pallas_megakernel.py
// fused_emit (_emit_kernel), one serial loop over senders whose per-slot
// counter gives each sender its start.  Here the starts come from the
// single-pass append of csrc/lookback.cuh (shared with fused_ring_append
// and fused_recv_land), weighted: a sender reserves one contiguous run of
// ec cells, so its slot's count grows by ec (rank_tile_weighted), never in
// the order atomics happen to run.  Overflowed senders form a suffix of
// each slot, as in the serial loop.
//
// Bound on the H100: bytes.  At the main path's shape (m = 131,072
// senders, k = 6, dw = 3) a call reads ~39 B a sender (sf, drop, svalid,
// wslot, off) and stores every lane once (its ring cell or its trash
// lane), ~8.3 MB (~2.5 us at 3.35 TB/s); there the host's enqueue, the
// launches and the latency of a few dependent steps are the cost, so the
// call is one launch with no allocation but its 2 * dw + 1 outputs and no
// fill (it was a zero fill and three kernels: count, scan, write).
//
// One kernel, emit, a tile of EMIT_TILE senders a block:
//   - masks and counts: a row's kept lanes (a mask up to 32 lanes) and
//     suppressed duplicates, the duplicates summed per slot.  G threads
//     serve a row, neighbouring threads on neighbouring lanes, each thread
//     keeping the loads of U passes over the tile in flight: G = 1 (a
//     thread a row) at the event engine's 6 and 7 lanes, G = 8 at wide
//     rows (kw 38, 112), where a thread a row spread each warp
//     instruction's loads over 32 rows (ops/megakernel.py emit_group);
//   - the weighted ranks by a thread a row (rank_tile_weighted) and the
//     earlier blocks' sums (look_back);
//   - each row's start and verdict (adds and lost summed per slot);
//   - the ring stores: rows of up to 32 lanes in the tile's (row, lane)
//     order, a thread a lane, so a warp's stores fall on the runs of a few
//     rows and on one stretch of trash lanes; wider rows by groups again,
//     their lanes computed again from the (cached) rows.
// adds, sup, lost and blocked are integer sums: each block adds its own
// into the workspace's head (the second part's sums past DW_LIMIT slots),
// and the last block to finish writes them out whole and zeroes them.
// The partition mask (the scenario's send-time partition_blocked, computed
// by the caller as the JAX package computes it outside its kernel) is one
// more byte a lane, read only when given.  The rumor words: a row's kept
// lanes are contiguous cells, so its words are one run of kept * W ints;
// the words go after the ids, a thread a (lane, word) pair in the tile's
// (row, lane, word) order, so a warp's stores fall on a few rows' runs
// and the tile's trash lanes, and its loads of swords on a few rows.
// Launches with words or with a mask are compiled with that code; the
// others do not carry it (it cost the single-rumor launch 8.5 % when the
// mask's test ran in every launch).  Past DW_LIMIT (1024) window
// slots the per-slot tables move to global memory (lookback.cuh's global
// form).
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the launch.

#include "lookback.cuh"

#define EMIT_ITEMS 1  // senders a thread ranks
#define EMIT_TILE (THREADS * EMIT_ITEMS)  // ops/megakernel.py EMIT_TILE

namespace {

using lookback::u64;

struct Emit {
  int32_t* ring;
  const int32_t* base;
  const int32_t* sf;
  const uint8_t* drop;
  const uint8_t* svalid;
  const int32_t* wslot;
  const int32_t* off;
  const uint8_t* flags;
  // The rumor words share the SIR trigger lane's fields (multi-rumor
  // traffic is SI only): the struct keeps the single-rumor form's layout,
  // whose launches a larger struct slowed by 4 % (PERF.md section 6).
  union {
    const uint8_t* strig;
    const int32_t* sw;  // (m, W) rumor words of the rows (WD)
  };
  union {
    const int32_t* sids;
    int32_t* wring;  // (L, W) word ring (WD)
  };
  const uint8_t* pmask;
  long long m;
  long long cap;
  int rbit;
  union {
    int tb;
    int W;  // words a lane (WD)
  };
  int k, kw, dw, b;
};

// Lane kk of U rows (row i[u], in range in[u], valid v[u]): e[u] whether
// it is a kept lane, bl[u] an edge the partition mask blocked, dup[u] an
// edge the duplicate filter suppressed, f[u] the friend.  Every row's loads
// are issued before the first is used (the friends, drops and mask, then
// the flags they name).  PM: the call has a partition mask (a launch
// without one compiles no mask code); WD: rumor words (no trigger lane).
template <int U, bool PM, bool WD>
__device__ __forceinline__ void kept_lanes(const Emit& a,
                                           const long long (&i)[U],
                                           const bool (&in)[U],
                                           const bool (&v)[U], int kk,
                                           bool (&e)[U], bool (&bl)[U],
                                           bool (&dup)[U], int (&f)[U]) {
  uint8_t dr[U], fl[U], pm[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool edge = in[u] && kk < a.k;
    const long long at = i[u] * a.k + kk;
    f[u] = edge ? a.sf[at] : -1;
    dr[u] = edge ? a.drop[at] : 1;
    pm[u] = PM && edge ? a.pmask[at] : 0;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    e[u] = v[u] && dr[u] == 0 && f[u] >= 0;
    bl[u] = PM && e[u] && pm[u] != 0;
    e[u] = e[u] && !bl[u];
    fl[u] = e[u] && a.flags != nullptr ? a.flags[f[u]] : 0;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    dup[u] = (fl[u] & a.rbit) != 0;
    e[u] = e[u] && !dup[u];
    if (!WD && in[u] && kk == a.k && a.strig != nullptr)  // SIR trigger
      e[u] = a.strig[i[u]] != 0;
  }
}

template <int G, bool GLB, bool PM, bool WD>
__global__ void __launch_bounds__(THREADS)
emit(Emit a, int32_t* __restrict__ out, u64* __restrict__ ws, int* aux,
     long long nb, unsigned epoch) {
  extern __shared__ int smem[];
  const lookback::Slots sl =
      lookback::carve(lookback::tables<GLB>(smem, aux, a.dw), a.dw);
  int* s_sup = sl.aux;  // the duplicates, until look_back
  __shared__ int s_key[EMIT_TILE];  // a row's slot, -1: reserves nothing
  __shared__ int s_ec[EMIT_TILE];
  __shared__ unsigned s_mask[EMIT_TILE];  // a row's kept lanes (kw <= 32)
  __shared__ long long s_dst[EMIT_TILE];  // a row's first cell, -1: none
  __shared__ int s_nok, s_lost, s_blocked;
  // sup [0, dw), adds [D, D + dw), lost (2D), blocked (2D + 1)
  int* acc = lookback::acc_sums<GLB>(ws, aux);
  const int D = GLB ? a.dw : DW_LIMIT;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int sub = lane & (G - 1);
  const int shift = lane - sub;
  const unsigned gmask = (1u << G) - 1u;
  const unsigned below = (1u << sub) - 1u;
  const int dw = a.dw;
  constexpr int PASS = THREADS / G;  // rows a pass of the block
  constexpr int PASSES = EMIT_TILE / PASS;
  constexpr int U = PASSES < 4 ? PASSES : 4;  // passes whose loads overlap

  // A tile a block (GLB: tiles by ticket until none is left).
  for (;;) {
    for (int j = t; j < dw; j += THREADS) s_sup[j] = 0;
    if (PM && t == 0) s_blocked = 0;
    const long long blk = lookback::ticket(ws, sl, dw, &s_nok);
    if (GLB && blk >= nb) break;
    const long long tile0 = blk * EMIT_TILE;

    // STAGE 1
    // Masks and counts: G threads a row, neighbouring lanes, U passes of
    // the block's rows at a time.
    for (int p0 = 0; p0 < PASSES; p0 += U) {
      long long i[U];
      bool in[U], v[U];
      int ec[U], dc[U], bc[U];
      unsigned km[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        i[u] = tile0 + (p0 + u) * PASS + t / G;
        in[u] = i[u] < a.m;
        v[u] = in[u] && a.svalid[i[u]] != 0;
        ec[u] = 0;
        dc[u] = 0;
        bc[u] = 0;
        km[u] = 0;
      }
      for (int c = 0; c < a.kw; c += G) {
        bool e[U], bl[U], dup[U];
        int f[U];
        kept_lanes<U, PM, WD>(a, i, in, v, c + sub, e, bl, dup, f);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned eb =
              (__ballot_sync(FULL_MASK, e[u]) >> shift) & gmask;
          ec[u] += __popc(eb);
          dc[u] +=
              __popc((__ballot_sync(FULL_MASK, dup[u]) >> shift) & gmask);
          if (PM)
            bc[u] +=
                __popc((__ballot_sync(FULL_MASK, bl[u]) >> shift) & gmask);
          if (c < 32) km[u] |= eb << c;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (sub != 0) continue;
        const int rr = (p0 + u) * PASS + t / G;
        const int s = in[u] ? a.wslot[i[u]] : -1;
        const bool slot_ok = s >= 0 && s < dw;
        s_key[rr] = v[u] && slot_ok && ec[u] > 0 ? s : -1;
        s_ec[rr] = ec[u];
        s_mask[rr] = km[u];
        if (dc[u] && slot_ok) atomicAdd(&s_sup[s], dc[u]);
        if (PM && bc[u]) atomicAdd(&s_blocked, bc[u]);
      }
    }
    __syncthreads();

    // STAGE 2
    // Weighted ranks, a thread a row: warp wid takes the tile's rows [wid *
    // 32 * EMIT_ITEMS, (wid + 1) * 32 * EMIT_ITEMS) in rounds of 32.
    const int row0 = wid * (32 * EMIT_ITEMS) + lane;
    int slot[EMIT_ITEMS], wt[EMIT_ITEMS], rank[EMIT_ITEMS];
#pragma unroll
    for (int r = 0; r < EMIT_ITEMS; ++r) {
      const int key = s_key[row0 + r * 32];
      slot[r] = key < 0 ? 0 : key;
      wt[r] = s_ec[row0 + r * 32];
      rank[r] = key < 0 ? -1 : 0;
    }
    lookback::rank_tile_weighted(slot, wt, rank, sl, dw);
    for (int j = t; j < dw; j += THREADS)
      if (s_sup[j]) atomicAdd(&acc[j], s_sup[j]);
    int* s_adds = sl.warp;  // free after the ranks
    for (int j = t; j < dw; j += THREADS) s_adds[j] = 0;
    if (t == 0) s_lost = 0;
    // STAGE 3
    lookback::look_back(ws, blk, dw, epoch, sl);

    // STAGE 4
    // Starts and verdicts: an okr row's first cell, adds and lost.
    int lost = 0;
#pragma unroll
    for (int r = 0; r < EMIT_ITEMS; ++r) {
      long long dst = -1;
      if (rank[r] >= 0) {
        const int s = slot[r];
        const long long start = (long long)a.base[s] + sl.aux[s] + rank[r];
        if (start + wt[r] <= a.cap) {
          dst = s * a.cap + start;
          atomicAdd(&s_adds[s], wt[r]);
        } else {
          lost += wt[r];
        }
      } else {
        lost += wt[r];  // kept lanes of a row that reserves nothing
      }
      s_dst[row0 + r * 32] = dst;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lost += __shfl_xor_sync(FULL_MASK, lost, o);
    if (lane == 0 && lost) atomicAdd(&s_lost, lost);
    __syncthreads();
    for (int j = t; j < dw; j += THREADS)
      if (s_adds[j]) atomicAdd(&acc[D + j], s_adds[j]);
    if (t == 0 && s_lost) atomicAdd(&acc[2 * D], s_lost);
    if (PM && t == 0 && s_blocked) atomicAdd(&acc[2 * D + 1], s_blocked);

    // STAGE 5
    // Ring stores: a kept lane of an okr row at its column (its kept rank in
    // the row), every other lane at its trash lane.  Rows of up to 32 lanes
    // go in the tile's (row, lane) order, a thread a lane, their kept lanes
    // from the masks: a warp's stores fall on the runs of a few rows and on
    // one stretch of the tile's trash lanes, and a kept edge's friend is
    // read again, coalesced, for its payload.  Wider rows go by groups and
    // compute their lanes again.
    if (a.kw <= 32) {
      const long long trash0 = (long long)dw * a.cap + tile0 * a.kw;
      const long long rows = a.m - tile0 < EMIT_TILE ? a.m - tile0 : EMIT_TILE;
      const int lanes = (int)rows * a.kw;
#pragma unroll 4
      for (int e = t; e < lanes; e += THREADS) {
        const int rr = e / a.kw;
        const int kk = e - rr * a.kw;
        const long long i = tile0 + rr;
        const unsigned km = s_mask[rr];
        const long long dst = s_dst[rr];
        const bool kept = ((km >> kk) & 1u) != 0;
        int32_t pay = 0;
        if (kept) {
          const int o = a.off[i];
          pay = kk < a.k ? a.sf[i * a.k + kk] * a.b + o
                         : a.tb + a.sids[i] * a.b + o;
        }
        a.ring[kept && dst >= 0 ? dst + __popc(km & ((1u << kk) - 1u))
                                : trash0 + e] = pay;
      }
      if (WD) {
        // The words, a thread a (lane, word) pair.
        const int wl = lanes * a.W;
        for (int q = t; q < wl; q += THREADS) {
          const int e = q / a.W;
          const int j = q - e * a.W;
          const int rr = e / a.kw;
          const int kk = e - rr * a.kw;
          const unsigned km = s_mask[rr];
          const long long dst = s_dst[rr];
          const bool kept = ((km >> kk) & 1u) != 0;
          const long long cell =
              kept && dst >= 0 ? dst + __popc(km & ((1u << kk) - 1u))
                               : trash0 + e;
          a.wring[cell * a.W + j] =
              kept ? a.sw[(tile0 + rr) * a.W + j] : 0;
        }
      }
    } else {
      for (int p0 = 0; p0 < PASSES; p0 += U) {
        long long i[U], dst[U];
        bool in[U], v[U];
        int o[U], col[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int rr = (p0 + u) * PASS + t / G;
          i[u] = tile0 + rr;
          in[u] = i[u] < a.m;
          v[u] = in[u] && a.svalid[i[u]] != 0;
          o[u] = in[u] ? a.off[i[u]] : 0;
          dst[u] = s_dst[rr];
          col[u] = 0;
        }
        for (int c = 0; c < a.kw; c += G) {
          const int kk = c + sub;
          bool e[U], bl[U], dup[U];
          int f[U];
          kept_lanes<U, PM, WD>(a, i, in, v, kk, e, bl, dup, f);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const unsigned eb =
                (__ballot_sync(FULL_MASK, e[u]) >> shift) & gmask;
            if (in[u] && kk < a.kw) {
              int32_t pay = 0;
              if (e[u])
                pay = kk < a.k ? f[u] * a.b + o[u]
                               : a.tb + a.sids[i[u]] * a.b + o[u];
              if (WD) {
                const long long cell =
                    (e[u] && dst[u] >= 0)
                        ? dst[u] + col[u] + __popc(eb & below)
                        : (long long)dw * a.cap + i[u] * a.kw + kk;
                a.ring[cell] = pay;
                for (int j = 0; j < a.W; ++j)
                  a.wring[cell * a.W + j] = e[u] ? a.sw[i[u] * a.W + j] : 0;
              } else {
                a.ring[(e[u] && dst[u] >= 0)
                           ? dst[u] + col[u] + __popc(eb & below)
                           : (long long)dw * a.cap + i[u] * a.kw + kk] = pay;
              }
            }
            col[u] += __popc(eb);
          }
        }
      }
    }

    if (!GLB) break;
    __syncthreads();  // the tile's rows are read before the next ticket
  }

  // STAGE 6
  // The last block to finish: the outputs, the sums, the counters.
  if (!lookback::last_to_finish(ws)) return;
  volatile int* sums = acc;
  for (int j = t; j < dw; j += THREADS) {
    out[j] = sums[D + j];
    out[dw + j] = sums[j];
    sums[D + j] = 0;
    sums[j] = 0;
  }
  if (t == 0) {
    out[2 * dw] = sums[2 * D];
    out[2 * dw + 1] = sums[2 * D + 1];
    sums[2 * D] = 0;
    sums[2 * D + 1] = 0;
  }
  lookback::reset_counters(ws);
}

template <int G, bool GLB, bool PM, bool WD>
cudaError_t launch(const Emit& a, int32_t* out, u64* ws, int* aux,
                   unsigned epoch, cudaStream_t st) {
  const long long nb = a.m > 0 ? (a.m + EMIT_TILE - 1) / EMIT_TILE : 1;
  const size_t shmem = GLB ? 0 : lookback::slots_bytes(a.dw);
  cudaError_t e = allow_smem((const void*)emit<G, GLB, PM, WD>, shmem);
  if (e != cudaSuccess) return e;
  emit<G, GLB, PM, WD><<<lookback::grid_of(nb, a.dw), THREADS, shmem, st>>>(
      a, out, ws, aux, nb, epoch);
  return cudaGetLastError();
}

// The form of a call: G threads a row, the global form past DW_LIMIT
// slots, the mask code when the call has a mask, the word stores when it
// has rumor words.
template <int G, bool WD>
cudaError_t pick(const Emit& a, int32_t* out, u64* ws, int* aux,
                 unsigned epoch, cudaStream_t st) {
  const bool pm = a.pmask != nullptr;
  if (a.dw > DW_LIMIT)
    return pm ? launch<G, true, true, WD>(a, out, ws, aux, epoch, st)
              : launch<G, true, false, WD>(a, out, ws, aux, epoch, st);
  return pm ? launch<G, false, true, WD>(a, out, ws, aux, epoch, st)
            : launch<G, false, false, WD>(a, out, ws, aux, epoch, st);
}

}  // namespace

// out: int32[2 * dw + 2], written whole (adds, sup, lost, blocked).  flags
// (dup filter), pmask (partition mask, uint8 (m, k)), strig/sender_ids
// (SIR trigger lane) and swords/wring (rumor words: int32 (m, width) rows
// and the (L, width) word ring, not with the trigger lane) may be null; at
// m = 0 the per-sender inputs may be null.  group: the threads that serve
// a row (1 or 8; ops/megakernel.py emit_group).  ws is the int64
// workspace of at least WS_HEAD + max(1, ceil(m / EMIT_TILE)) * dw words
// (ops/deliver.py workspace_words), zeroed when it was made; epoch in [1,
// EPOCH_MAX), new for every call that uses ws.  Past DW_LIMIT slots aux is
// the workspace's second part, int32[aux_words >= aux_ints(dw, nb)],
// zeroed when it was made; else it may be null.
extern "C" int gossip_fused_emit(
    void* ring, const void* base, const void* sf, const void* drop,
    const void* svalid, const void* wslot, const void* off,
    const void* flags, int rbit, const void* strig, const void* sender_ids,
    const void* pmask, const void* swords, void* wring, int tb, int m, int k,
    int dw, int cap, int b, int width, int group, void* out, void* ws,
    long long ws_words, int epoch, void* aux, long long aux_words,
    void* stream) {
  if (dw < 1 || k < 1 || m < 0 || cap < 0 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((strig == nullptr) != (sender_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool words = wring != nullptr;  // swords may be null at m = 0
  if ((swords != nullptr && !words)
      || (words && (width < 1 || strig || (m > 0 && swords == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = lookback::check_ws(m, dw, ws, ws_words, epoch, aux,
                                     aux_words, EMIT_TILE);
  if (e != cudaSuccess) return (int)e;
  Emit a;
  a.ring = (int32_t*)ring;
  a.base = (const int32_t*)base;
  a.sf = (const int32_t*)sf;
  a.drop = (const uint8_t*)drop;
  a.svalid = (const uint8_t*)svalid;
  a.wslot = (const int32_t*)wslot;
  a.off = (const int32_t*)off;
  a.flags = (const uint8_t*)flags;
  if (words) {
    a.sw = (const int32_t*)swords;
    a.wring = (int32_t*)wring;
  } else {
    a.strig = (const uint8_t*)strig;
    a.sids = (const int32_t*)sender_ids;
  }
  a.pmask = (const uint8_t*)pmask;
  a.m = m;
  a.cap = cap;
  a.rbit = rbit;
  if (words)
    a.W = width;
  else
    a.tb = tb;
  a.k = k;
  a.kw = k + (strig != nullptr ? 1 : 0);
  a.dw = dw;
  a.b = b;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  u64* w = (u64*)ws;
  int* x = (int*)aux;
  const unsigned ep = (unsigned)epoch;
  switch (group) {
    case 1:
      return (int)(words ? pick<1, true>(a, o, w, x, ep, st)
                         : pick<1, false>(a, o, w, x, ep, st));
    case 8:
      return (int)(words ? pick<8, true>(a, o, w, x, ep, st)
                         : pick<8, false>(a, o, w, x, ep, st));
    default: return (int)cudaErrorInvalidValue;
  }
}
