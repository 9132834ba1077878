// fused_unique_set: ring[flat[i]] = vals[i] over lanes whose indices are
// unique and in bounds (the event engine's per-lane trash-cell layout
// guarantees both), so every lane writes its own cell and the order of
// the writes is immaterial.
//
// Replaces the TPU kernel gossip_simulator_tpu/ops/pallas_deliver.py
// fused_unique_set (_unique_set_kernel), a serial lane loop on the TPU.
//
// Bound on the H100: bytes, 12 B a lane (index and value in, the value
// out): 2.8 us at the event engine's 786,432 lanes.  At that size a call
// is mostly its launch, so the design is the whole call: the wrapper
// (ops/deliver.py) holds the typed entry point and reads the stream as a
// raw handle; the kernel reads four lanes a thread with one 16-byte load
// each of flat and vals (a scalar head up to the first 16-byte boundary
// of flat, a scalar tail; all scalar when flat and vals are not aligned
// alike) on a grid of at most 8 blocks an SM, striding over the rest.
// The scattered 4-byte stores land where the senders' reservations put
// them: a sender's k lanes are contiguous in the ring, so a warp's store
// of 32 neighbouring lanes touches a few sectors.  The lanes go through
// shared memory so that each store covers 32 neighbouring lanes: stored
// straight from the 16-byte loads, a warp's store took every fourth lane
// and the kernel ran 5.6 us against the scalar form's 4.5 (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md).
//
// The word ring (multi-rumor traffic): one launch writes the id ring and
// the (L, W) word ring at the same cells, wring[flat[i] * W + j] =
// wvals[i * W + j], a thread an id lane and then a thread a (lane, word)
// pair in (lane, word) order, so a warp's loads of wvals are coalesced
// and its stores fall on the rows of a few neighbouring lanes (a sender's
// contiguous cells).  Bound: bytes, 12 + 8 W B a lane (flat read again
// with each word row).
//
// Plain C interface (built with nvcc, loaded with ctypes): returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cstdint>

#define THREADS 256
#define WARPS (THREADS / 32)

namespace {

// Lanes [0, head) one a thread; then chunks of 128 lanes a warp from
// lane head on (flat + head and vals + head 16-byte aligned when kVec):
// each thread loads four lanes of flat and of vals with one 16-byte load
// each and puts them in shared memory, and the warp stores lanes 32j ..
// 32j + 31 with its j-th store, so that a store covers neighbouring lanes
// (a sender's contiguous cells) as the scalar form's does; the tail one a
// thread.
template <bool kVec>
__global__ void __launch_bounds__(THREADS)
unique_set_kernel(int32_t* __restrict__ ring,
                  const int32_t* __restrict__ flat,
                  const int32_t* __restrict__ vals, long long m, int head) {
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (!kVec) {
    for (long long i = gid; i < m; i += stride) ring[flat[i]] = vals[i];
    return;
  }
  __shared__ int4 sf[WARPS][32], sv[WARPS][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (gid < head) ring[flat[gid]] = vals[gid];
  const long long quads = (m - head) >> 2;
  const int4* f4 = reinterpret_cast<const int4*>(flat + head);
  const int4* v4 = reinterpret_cast<const int4*>(vals + head);
  const int* sf1 = reinterpret_cast<const int*>(sf[wid]);
  const int* sv1 = reinterpret_cast<const int*>(sv[wid]);
  const long long chunks = (quads + 31) >> 5;
  for (long long c = (long long)blockIdx.x * WARPS + wid; c < chunks;
       c += (long long)gridDim.x * WARPS) {
    const long long q = (c << 5) + lane;
    if (q < quads) {
      sf[wid][lane] = __ldg(f4 + q);
      sv[wid][lane] = __ldg(v4 + q);
    }
    __syncwarp();
    const long long left = (quads - (c << 5)) << 2;  // lanes in the chunk
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j * 32 + lane;
      if (i < left) ring[sf1[i]] = sv1[i];
    }
    __syncwarp();
  }
  const long long tail = head + (quads << 2);
  if (tail + gid < m) ring[flat[tail + gid]] = vals[tail + gid];
}

// Both rings: ring[flat[i]] = vals[i], then the W words of each lane.
template <bool kOne>
__global__ void __launch_bounds__(THREADS)
unique_set_words_kernel(int32_t* __restrict__ ring,
                        int32_t* __restrict__ wring,
                        const int32_t* __restrict__ flat,
                        const int32_t* __restrict__ vals,
                        const int32_t* __restrict__ wvals, long long m,
                        int w) {
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = gid; i < m; i += stride) ring[flat[i]] = vals[i];
  if (kOne) {
    for (long long i = gid; i < m; i += stride) wring[flat[i]] = wvals[i];
    return;
  }
  const long long mw = m * w;
  for (long long q = gid; q < mw; q += stride) {
    const long long i = q / w;
    const int j = (int)(q - i * w);
    wring[(long long)flat[i] * w + j] = wvals[q];
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace

extern "C" int gossip_fused_unique_set(void* ring, const void* flat,
                                       const void* vals, long long m,
                                       void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  const uintptr_t fa = (uintptr_t)flat, va = (uintptr_t)vals;
  // Lanes before flat's first 16-byte boundary; vectorised only when vals
  // reaches its boundary at the same lane.
  const int head = (int)(((16 - (fa & 15)) & 15) >> 2);
  const bool vec = ((fa - va) & 15) == 0 && (fa & 3) == 0 && m > head;
  const long long per = vec ? 4 : 1;  // lanes a thread takes per step
  long long blocks = ((m + per - 1) / per + THREADS - 1) / THREADS;
  const long long most = 8LL * sm_count();
  if (blocks > most) blocks = most;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    unique_set_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
        (int32_t*)ring, (const int32_t*)flat, (const int32_t*)vals, m, head);
  else
    unique_set_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
        (int32_t*)ring, (const int32_t*)flat, (const int32_t*)vals, m, 0);
  return (int)cudaGetLastError();
}

// The id ring and the (L, width) word ring in one launch (wvals: (m,
// width) rows, width >= 1).
extern "C" int gossip_fused_unique_set_words(void* ring, void* wring,
                                             const void* flat,
                                             const void* vals,
                                             const void* wvals, long long m,
                                             int width, void* stream) {
  if (width < 1) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaGetLastError();
  long long blocks = (m * width + THREADS - 1) / THREADS;
  const long long most = 8LL * sm_count();
  if (blocks > most) blocks = most;
  cudaStream_t st = (cudaStream_t)stream;
  if (width == 1)
    unique_set_words_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
        (int32_t*)ring, (int32_t*)wring, (const int32_t*)flat,
        (const int32_t*)vals, (const int32_t*)wvals, m, 1);
  else
    unique_set_words_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
        (int32_t*)ring, (int32_t*)wring, (const int32_t*)flat,
        (const int32_t*)vals, (const int32_t*)wvals, m, width);
  return (int)cudaGetLastError();
}
