// Kernel HF for Hopper (sm_90a): the slab exchange's plane copies and fills
// (mpm_tpu_torch/parallel/domain.py), one launch a slab an exchange, on the
// slab's own card.
//
// Replaces: no TPU kernel. The JAX package exchanges the halo by ppermute
// (mpm_tpu/parallel/domain.py) and XLA writes the padded arrays. The port's
// plain version, ops/cuda/halo_fill.fill_plain, stays as the CPU path and the
// oracle: one copy_ or fill_ of a slice a segment.
//
// A segment is a block of `rows` rows of `row_bytes` bytes: its source rows
// `src_stride` bytes apart (a neighbour's planes, on this card or read by
// device pointer from a peer card over NVLink), its destination rows
// `dst_stride` bytes apart (the slab's halo or end planes), or, without a
// source, a fill of one repeated byte (0: pos, vel, C, mass and the grids;
// 0xFF: ids -1). Every field of the state, each of the grids, takes one
// segment a side, so a launch carries up to MAX_SEGS of them, a block row
// (blockIdx.y) a segment. Each thread moves the widest word (16, 8, 4, 2 or 1
// bytes) that the segment's addresses, strides and row length all allow.
// The words are copied as bits: the slab stays bit-equal to the unsharded
// state.
//
// Ordering across cards (halo_fill_run): a slab that a neighbour on another
// card reads records `ready` on its stream after the work that produced what
// is read; the reader's stream waits on it, fills, and records `done`; the
// producer's stream then waits on `done`, so that nothing it runs later,
// nor the caching allocator's reuse of a freed block on that stream,
// overwrites the planes before the fill has read them. Slabs of one card
// share its stream, whose order alone orders them.
//
// What bounds it: the bytes. A config 5 slab reads about 8.65 MB of state
// halo from each neighbour a substep, and 0.4 MB of grid planes.

#include <cuda_runtime.h>

namespace halo {

constexpr int MAX_SEGS = 16;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_X = 120;  // blocks a segment: with the segments, enough for every SM

struct Seg {
  const char* src;  // nullptr: a fill
  char* dst;
  long long src_stride, dst_stride;  // bytes from a row to the next
  long long row_bytes;
  int rows;
  int shift;          // log2 of the word's bytes
  unsigned int fill;  // the fill byte
  int pad;
};

struct Segs {
  Seg s[MAX_SEGS];
};

template <typename W>
__device__ __forceinline__ W splat_byte(unsigned int b) {
  const unsigned int v = b * 0x01010101u;
  if constexpr (sizeof(W) == 16) return make_uint4(v, v, v, v);
  else if constexpr (sizeof(W) == 8) return make_uint2(v, v);
  else return (W)v;
}

template <typename W>
__device__ void move(const Seg& s) {
  const unsigned int units = (unsigned int)(s.row_bytes / (long long)sizeof(W));
  const unsigned int total = units * (unsigned int)s.rows;
  const unsigned int step = gridDim.x * blockDim.x;
  const W f = splat_byte<W>(s.fill);
  for (unsigned int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const unsigned int r = i / units, u = i - r * units;
    W* d = reinterpret_cast<W*>(s.dst + r * s.dst_stride) + u;
    *d = s.src ? reinterpret_cast<const W*>(s.src + r * s.src_stride)[u] : f;
  }
}

__global__ void __launch_bounds__(THREADS) fill(Segs segs) {
  const Seg& s = segs.s[blockIdx.y];
  switch (s.shift) {
    case 4: move<uint4>(s); break;
    case 3: move<uint2>(s); break;
    case 2: move<unsigned int>(s); break;
    case 1: move<unsigned short>(s); break;
    default: move<unsigned char>(s); break;
  }
}

// The widest word (as log2 of its bytes, at most 4) dividing every one of
// the segment's addresses, strides and its row length.
int word_shift(const Seg& s) {
  unsigned long long any = (unsigned long long)s.dst | (unsigned long long)s.dst_stride |
                           (unsigned long long)s.row_bytes;
  if (s.src) any |= (unsigned long long)s.src | (unsigned long long)s.src_stride;
  int k = 0;
  while (k < 4 && !(any & (2ull << k) - 1)) ++k;
  return k;
}

// Plan rows, PLAN_COLS int64 each: dst table index, dst byte offset, src
// table index (-1: a fill), src byte offset, rows, row bytes, dst row stride,
// src row stride, fill byte.
constexpr int PLAN_COLS = 9;

cudaError_t launch(const long long* plan, int n, const long long* ptr, cudaStream_t stream) {
  for (int i0 = 0; i0 < n; i0 += MAX_SEGS) {
    Segs segs = {};
    const int m = n - i0 < MAX_SEGS ? n - i0 : MAX_SEGS;
    long long most = 0;
    for (int j = 0; j < m; ++j) {
      const long long* p = plan + (long long)(i0 + j) * PLAN_COLS;
      Seg& s = segs.s[j];
      s.dst = (char*)ptr[p[0]] + p[1];
      s.src = p[2] < 0 ? nullptr : (const char*)ptr[p[2]] + p[3];
      s.rows = (int)p[4];
      s.row_bytes = p[5];
      s.dst_stride = p[6];
      s.src_stride = p[7];
      s.fill = (unsigned int)p[8] & 0xFFu;
      s.shift = word_shift(s);
      const long long units = (s.row_bytes >> s.shift) * s.rows;
      if (units >= (1ll << 31)) return cudaErrorInvalidValue;
      if (units > most) most = units;
    }
    long long bx = (most + THREADS * 4 - 1) / (THREADS * 4);
    bx = bx < 1 ? 1 : (bx > MAX_BLOCKS_X ? MAX_BLOCKS_X : bx);
    fill<<<dim3((unsigned int)bx, (unsigned int)m), THREADS, 0, stream>>>(segs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace halo

extern "C" {

int halo_fill_plan_cols() { return halo::PLAN_COLS; }
int halo_fill_max_segs() { return halo::MAX_SEGS; }

// An event for the exchange's ordering on card `device` (no timing).
void* halo_event_new(int device) {
  int prev = 0;
  cudaEvent_t e = nullptr;
  if (cudaGetDevice(&prev) != cudaSuccess || cudaSetDevice(device) != cudaSuccess) return nullptr;
  if (cudaEventCreateWithFlags(&e, cudaEventDisableTiming) != cudaSuccess) e = nullptr;
  cudaSetDevice(prev);
  return e;
}

// Lets card `device` read card `peer`'s memory; a pair already enabled is a
// success.
int halo_enable_peer(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)err;
}

// One exchange over n slabs: slab a's plan rows first[a] .. first[a + 1] are
// one launch (MAX_SEGS rows a launch) on card dev[a]'s `stream[a]`.
// peer[2a] (peer[2a + 1]): slab a reads its left (right) neighbour on
// another card, ordered by the events ready[] and done[] (the comment at the
// top). `ptr`: the table of base addresses the plan's indices name.
int halo_fill_run(int n, const int* dev, void* const* stream, void* const* ready,
                  void* const* done, const int* peer, const long long* plan, const int* first,
                  const long long* ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  auto read_by_peer = [&](int a) {
    return (a + 1 < n && peer[2 * (a + 1)]) || (a > 0 && peer[2 * (a - 1) + 1]);
  };
  for (int a = 0; a < n && err == cudaSuccess; ++a) {
    if (!read_by_peer(a)) continue;
    err = cudaSetDevice(dev[a]);
    if (err == cudaSuccess) err = cudaEventRecord((cudaEvent_t)ready[a], (cudaStream_t)stream[a]);
  }
  for (int a = 0; a < n && err == cudaSuccess; ++a) {
    cudaStream_t s = (cudaStream_t)stream[a];
    err = cudaSetDevice(dev[a]);
    if (err == cudaSuccess && peer[2 * a])
      err = cudaStreamWaitEvent(s, (cudaEvent_t)ready[a - 1], 0);
    if (err == cudaSuccess && peer[2 * a + 1])
      err = cudaStreamWaitEvent(s, (cudaEvent_t)ready[a + 1], 0);
    if (err == cudaSuccess && first[a + 1] > first[a])
      err = halo::launch(plan + (long long)first[a] * halo::PLAN_COLS, first[a + 1] - first[a],
                         ptr, s);
    if (err == cudaSuccess && (peer[2 * a] || peer[2 * a + 1]))
      err = cudaEventRecord((cudaEvent_t)done[a], s);
  }
  for (int a = 0; a < n && err == cudaSuccess; ++a) {
    if (!read_by_peer(a)) continue;
    cudaStream_t s = (cudaStream_t)stream[a];
    err = cudaSetDevice(dev[a]);
    if (err == cudaSuccess && a + 1 < n && peer[2 * (a + 1)])
      err = cudaStreamWaitEvent(s, (cudaEvent_t)done[a + 1], 0);
    if (err == cudaSuccess && a > 0 && peer[2 * (a - 1) + 1])
      err = cudaStreamWaitEvent(s, (cudaEvent_t)done[a - 1], 0);
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

}  // extern "C"
