// The engine of the port's row movers (gather_kv.cu, scatter_kv.cu): a
// launch moves a list of "pieces", each a run of at most kChunk bytes
// from a source address to a destination address.  A map object, passed
// by value as a __grid_constant__ kernel parameter, turns a piece number
// into (src, dst, bytes): it reads the row index (gather, scatter), the
// request's position (the decode write) or the layer's run (the prefill
// splice) itself, so the caller launches once for up to kMaxSegs
// segments and does no index arithmetic of its own.  src == nullptr
// writes zeros; bytes == 0 moves nothing (a scatter row out of range).
//
// One warp a piece, at the widest vector (16 bytes down to 1) that every
// address and length allows, each lane issuing all of its loads (up to
// kUnroll) before its stores, so that a lane has several loads in
// flight.  (A TMA bulk-copy path, cp.async.bulk through an mbarrier ring
// of shared-memory stages, measured slower than this one on the H100 at
// every row width from 128 to 14336 bytes and on the prefill splice, so
// it was removed: PERF.md, Findings.)
//
// The kernel copies bits: the result does not depend on block order
// (pieces never overlap by contract: distinct rows).
#pragma once

#include "common.cuh"

namespace rowmove {

constexpr int kChunk = 8192;        // the largest piece, bytes
constexpr int kMaxSegs = 4;         // segments one launch takes
constexpr int kUnroll = 8;          // loads a lane keeps in flight

struct Piece {
  const char* src;   // nullptr: zeros
  char* dst;
  int bytes;         // 0: nothing to move
};

static __device__ __forceinline__ long long clamp_row(long long r,
                                                      long long S) {
  return r < 0 ? 0 : (r >= S ? S - 1 : r);
}

template <class Map, typename V>
__global__ void __launch_bounds__(256)
    move_vec(const __grid_constant__ Map m, long long n_pieces) {
  const long long p =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n_pieces) return;
  const Piece pc = m.piece(p);
  if (pc.bytes <= 0) return;
  const V* src = reinterpret_cast<const V*>(pc.src);
  V* dst = reinterpret_cast<V*>(pc.dst);
  const int n = pc.bytes / (int)sizeof(V);
  for (int base = 0; base < n; base += 32 * kUnroll) {
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * 32 + lane;
      if (i < n) r[u] = src != nullptr ? src[i] : V{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * 32 + lane;
      if (i < n) dst[i] = r[u];
    }
  }
}

// Launch the pieces of `m` on `stream`.  align: OR of every address and
// length the pieces use, which picks the vector width.
template <class Map>
int move(const Map& m, long long n_pieces, unsigned long long align,
         cudaStream_t stream) {
  if (n_pieces <= 0) return (int)cudaGetLastError();
  if (n_pieces >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_pieces * 32 + 255) / 256;
  int w = 1;
  for (int v = 16; v > 1; v >>= 1)
    if ((align & (unsigned long long)(v - 1)) == 0) {
      w = v;
      break;
    }
  switch (w) {
    case 16: move_vec<Map, uint4><<<(unsigned)blocks, 256, 0, stream>>>(m, n_pieces); break;
    case 8: move_vec<Map, uint2><<<(unsigned)blocks, 256, 0, stream>>>(m, n_pieces); break;
    case 4: move_vec<Map, uint32_t><<<(unsigned)blocks, 256, 0, stream>>>(m, n_pieces); break;
    case 2: move_vec<Map, uint16_t><<<(unsigned)blocks, 256, 0, stream>>>(m, n_pieces); break;
    default: move_vec<Map, uint8_t><<<(unsigned)blocks, 256, 0, stream>>>(m, n_pieces);
  }
  return (int)cudaGetLastError();
}

static inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

}  // namespace rowmove
