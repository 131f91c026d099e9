// Sparse KV row gather: out[b, i] = kv[b, idx[b, i]], for up to four
// (kv, idx, out) segments in one launch.
//
// Replaces: src/repro/kernels/gather_kv.py::gather_kv (Pallas: the top-k
// indices are scalar-prefetched and drive one DMA per row).
//
// Bound on an H100: bytes.  It moves k rows in and k rows out and does
// no arithmetic (DeepSeek-V3.2 decode: B=4, k=2048, 1152-byte rows,
// 18.9 MB, about 5.6 us at 3.35 TB/s).
//
// Design: the row movers' engine (rowmove.cuh).  Hopper has no scalar
// prefetch, so the kernel reads its own row indices, clamped into [0, S)
// so a stray index cannot fault.  The shard form (a segment with shard
// != 0: one rank's slice [base, base + S) of a pool whose sequence axis
// is split over ranks) reads global row r at local row r - base when r
// lies in the slice and writes a row of zeros otherwise (a piece with no
// source), so that the ranks' results, combined byte by byte, are the
// whole gather.  A launch takes several segments (the
// decode step's demand set and its speculation tail: one launch a layer
// in place of two), the grid spread over all their rows, a warp a row
// (a piece of at most 8 KB) with all of a lane's loads before its
// stores.
//
// gather_pages (below) is the page-granular form:
//   out[i * page : (i + 1) * page] = kv[p * page : (p + 1) * page],
//   p = page_idx[i].
// Replaces: src/repro/kernels/gather_kv.py::gather_kv_pages (Pallas: the
// page ids are scalar-prefetched and each drives one (page, d) block DMA).
// Bound: bytes, like the row gather.  A page is page * row_bytes
// contiguous bytes (16 rows of 1 KB for a 512-wide bf16 entry), so one
// block of 256 threads copies one whole page with 16-byte vectors, each
// thread taking every 256th vector: the block's loads and stores are
// fully coalesced and one block per page id fills the card.
#include "rowmove.cuh"

namespace {

struct GatherSeg {
  const char* kv;
  const int32_t* idx;
  char* out;
  long long S, row_bytes, first_piece, base;
  unsigned k, chunks;              // lanes a request, pieces a row
  int shard;                       // rows outside [base, base + S): zeros
};

struct gather_rows {
  GatherSeg seg[rowmove::kMaxSegs];
  int n_segs;

  // 32-bit index arithmetic: a launch moves fewer than 2^31 pieces
  __device__ rowmove::Piece piece(long long p) const {
    int s = 0;
    while (s + 1 < n_segs && p >= seg[s + 1].first_piece) ++s;
    const GatherSeg& g = seg[s];
    const unsigned q = (unsigned)(p - g.first_piece);
    const unsigned row = g.chunks == 1 ? q : q / g.chunks;
    const long long off = (long long)(q - row * g.chunks) * rowmove::kChunk;
    const long long b = row / g.k;
    const long long i = (long long)g.idx[row] - g.base;
    const long long r = rowmove::clamp_row(i, g.S);
    const long long left = g.row_bytes - off;
    const bool away = g.shard && (i < 0 || i >= g.S);
    return rowmove::Piece{
        away ? nullptr : g.kv + (b * g.S + r) * g.row_bytes + off,
        g.out + (long long)row * g.row_bytes + off,
        (int)(left < rowmove::kChunk ? left : rowmove::kChunk)};
  }
};

template <typename V>
__global__ void gather_pages(const char* __restrict__ kv,
                             const int32_t* __restrict__ page_idx,
                             char* __restrict__ out, long long n_pages_kv,
                             long long page_bytes) {
  const long long i = blockIdx.x;
  long long p = page_idx[i];
  p = p < 0 ? 0 : (p >= n_pages_kv ? n_pages_kv - 1 : p);
  const V* src = reinterpret_cast<const V*>(kv + p * page_bytes);
  V* dst = reinterpret_cast<V*>(out + i * page_bytes);
  const long long n = page_bytes / (long long)sizeof(V);
  for (long long j = threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j];
}

template <typename V>
void launch_pages(const void* kv, const void* page_idx, void* out,
                  long long n_pages_kv, long long n, long long page_bytes,
                  cudaStream_t stream) {
  gather_pages<V><<<(unsigned)n, 256, 0, stream>>>(
      (const char*)kv, (const int32_t*)page_idx, (char*)out, n_pages_kv,
      page_bytes);
}

}  // namespace

// One segment of a gather: kv [B, S, row_bytes] bytes, idx [B, k] int32,
// out [B, k, row_bytes].  shard == 0: indices clamped into [0, S);
// shard != 0: kv is the slice [base, base + S) of the pool, and an index
// outside it gives a row of zeros.
struct sac_gather_seg {
  const void* kv;
  const void* idx;
  void* out;
  long long B, S, k, row_bytes, base, shard;
};

// Gathers n_segs (1..4) segments in one launch.
SAC_API int sac_gather_kv(const sac_gather_seg* segs, int n_segs,
                          void* stream) {
  if (n_segs < 1 || n_segs > rowmove::kMaxSegs)
    return (int)cudaErrorInvalidValue;
  gather_rows m{};
  m.n_segs = n_segs;
  long long n_pieces = 0;
  unsigned long long align = 0;
  for (int i = 0; i < n_segs; ++i) {
    const sac_gather_seg& s = segs[i];
    const int chunks = (int)rowmove::ceil_div(s.row_bytes, rowmove::kChunk);
    m.seg[i] = GatherSeg{(const char*)s.kv, (const int32_t*)s.idx,
                         (char*)s.out, s.S, s.row_bytes, n_pieces,
                         s.shard ? s.base : 0, (unsigned)s.k,
                         (unsigned)chunks, (int)(s.shard != 0)};
    n_pieces += s.B * s.k * chunks;
    align |= (unsigned long long)(uintptr_t)s.kv |
             (unsigned long long)(uintptr_t)s.out |
             (unsigned long long)s.row_bytes;
  }
  return rowmove::move(m, n_pieces, align, (cudaStream_t)stream);
}

// kv: [n_pages_kv * page_bytes] bytes (S rows of a [S, d] tensor with
// S % page == 0); page_idx: [n] int32; out: [n * page_bytes] bytes.
SAC_API int sac_gather_kv_pages(const void* kv, const void* page_idx,
                                void* out, long long n_pages_kv, long long n,
                                long long page_bytes, void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (sac_vec_bytes(page_bytes, kv, out)) {
      case 16: launch_pages<uint4>(kv, page_idx, out, n_pages_kv, n,
                                   page_bytes, st); break;
      case 8: launch_pages<uint2>(kv, page_idx, out, n_pages_kv, n,
                                  page_bytes, st); break;
      case 4: launch_pages<uint32_t>(kv, page_idx, out, n_pages_kv, n,
                                     page_bytes, st); break;
      case 2: launch_pages<uint16_t>(kv, page_idx, out, n_pages_kv, n,
                                     page_bytes, st); break;
      default: launch_pages<uint8_t>(kv, page_idx, out, n_pages_kv, n,
                                     page_bytes, st);
    }
  }
  return (int)cudaGetLastError();
}

SAC_API const char* sac_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
