// In-place KV row writes into the pool, in three forms:
//
// * sac_scatter_kv: pool[b, idx[b, i]] = entries[b, i] (the TPU kernel's
//   own form);
// * sac_write_rows_at, the decode write: row (l, b) of each segment's
//   [L, B, S] pool at position clamp(pos[b], 0, S-1) takes entry [l, b];
//   one launch writes every layer of both pools (the latent or (k, v)
//   entries and the indexer keys, two segments of different widths).
//   Its shard form writes into one rank's slice [base, base + S) of a
//   pool of S_glob positions split over ranks: the position clamps into
//   [0, S_glob), and only the rank whose slice holds it writes the row,
//   at the position less base (the others move nothing);
// * sac_splice_kv, the prefill splice: each (layer, lane)'s rows
//   [offset, offset + T) take T contiguous rows of the prompt, from its
//   row src_row0 of src_rows, and with zero_tail the rows [offset + T, S)
//   are zeroed; both pools in one launch.  Its shard form copies a
//   rank's slice of the prompt's rows (src_row0 = base) into the rank's
//   pool.
//
// Replaces: src/repro/kernels/scatter_kv.py::scatter_kv (Pallas: the
// destination indices drive the output BlockSpec of an input/output
// aliased pool, one DMA per row).
//
// Bound on an H100: launch latency for the decode write (L*B rows: 23 KB
// at DeepSeek-V3.2 width, two layers, four slots, far below a
// microsecond of memory traffic); bytes for the splice (Gemma3-12B: 48 x
// 8192 rows of 7680 bytes in and 48 x 8256 out, about 6.06 GB, 1.81 ms
// at 3.35 TB/s).
//
// Design: the row movers' engine (rowmove.cuh): the pool is written in
// place (no copy of it), the kernel computes every destination row itself
// (so the caller launches no index arithmetic), and the splice's runs are
// contiguous in source and pool, so they are cut into whole kChunk
// pieces (the zero tail too, stored from registers).  Rows are distinct by contract, so no two warps
// write the same bytes and the result is independent of block order.  A
// scatter index outside [0, S) is skipped.
#include "rowmove.cuh"

namespace {

using rowmove::kChunk;
using rowmove::Piece;

static __device__ __forceinline__ int piece_bytes(long long left) {
  return (int)(left < kChunk ? left : kChunk);
}

// (32-bit index arithmetic: a launch moves fewer than 2^31 pieces)
struct scatter_rows {              // sac_scatter_kv (one segment)
  char* pool;
  const char* entries;
  const int32_t* idx;
  long long S, row_bytes;
  unsigned k, chunks;

  __device__ Piece piece(long long p) const {
    const unsigned q = (unsigned)p;
    const unsigned row = chunks == 1 ? q : q / chunks;
    const long long off = (long long)(q - row * chunks) * kChunk;
    const long long r = idx[row];
    if (r < 0 || r >= S) return Piece{nullptr, nullptr, 0};
    return Piece{entries + (long long)row * row_bytes + off,
                 pool + ((long long)(row / k) * S + r) * row_bytes + off,
                 piece_bytes(row_bytes - off)};
  }
};

struct WriteSeg {
  char* pool;
  const char* src;
  long long S, row_bytes, first_piece, base, S_glob;
  unsigned B, chunks;
};

struct write_rows_at {             // sac_write_rows_at
  WriteSeg seg[rowmove::kMaxSegs];
  const int32_t* pos;
  int n_segs;

  __device__ Piece piece(long long p) const {
    int s = 0;
    while (s + 1 < n_segs && p >= seg[s + 1].first_piece) ++s;
    const WriteSeg& w = seg[s];
    const unsigned q = (unsigned)(p - w.first_piece);
    const unsigned row = w.chunks == 1 ? q : q / w.chunks;   // l * B + b
    const long long off = (long long)(q - row * w.chunks) * kChunk;
    const long long r =
        rowmove::clamp_row(pos[row % w.B], w.S_glob) - w.base;
    if (r < 0 || r >= w.S) return Piece{nullptr, nullptr, 0};
    return Piece{w.src + (long long)row * w.row_bytes + off,
                 w.pool + ((long long)row * w.S + r) * w.row_bytes + off,
                 piece_bytes(w.row_bytes - off)};
  }
};

struct SpliceSeg {
  char* pool;
  const char* src;
  long long B, S, lane0, T, offset, row_bytes, first_piece, src_rows,
      src_row0;
  unsigned n_lanes, copy_pieces, run_pieces;  // a run's copied, all pieces
};

struct splice_runs {               // sac_splice_kv
  SpliceSeg seg[rowmove::kMaxSegs];
  int n_segs;

  __device__ Piece piece(long long p) const {
    int s = 0;
    while (s + 1 < n_segs && p >= seg[s + 1].first_piece) ++s;
    const SpliceSeg& g = seg[s];
    const unsigned q = (unsigned)(p - g.first_piece);
    const unsigned run = q / g.run_pieces;       // l * n_lanes + lane
    const unsigned c = q - run * g.run_pieces;
    const unsigned l = run / g.n_lanes;
    const long long b = g.lane0 + (run - l * g.n_lanes);
    char* rows = g.pool + ((l * g.B + b) * g.S + g.offset) * g.row_bytes;
    const long long run_bytes = g.T * g.row_bytes;
    if (c < g.copy_pieces) {
      const long long off = (long long)c * kChunk;
      return Piece{g.src + (run * g.src_rows + g.src_row0) * g.row_bytes +
                       off,
                   rows + off,
                   piece_bytes(run_bytes - off)};
    }
    const long long off = (long long)(c - g.copy_pieces) * kChunk;
    return Piece{nullptr, rows + run_bytes + off,
                 piece_bytes((g.S - g.offset - g.T) * g.row_bytes - off)};
  }
};

unsigned long long bits(const void* a, const void* b, long long n) {
  return (unsigned long long)(uintptr_t)a | (unsigned long long)(uintptr_t)b |
         (unsigned long long)n;
}

}  // namespace

// pool [B, S, row_bytes]; entries [B, k, row_bytes]; idx [B, k] int32
SAC_API int sac_scatter_kv(void* pool, const void* entries, const void* idx,
                           long long B, long long S, long long k,
                           long long row_bytes, void* stream) {
  const unsigned chunks = (unsigned)rowmove::ceil_div(row_bytes, kChunk);
  const scatter_rows m{(char*)pool, (const char*)entries,
                       (const int32_t*)idx, S, row_bytes, (unsigned)k,
                       chunks};
  return rowmove::move(m, B * k * chunks, bits(pool, entries, row_bytes),
                       (cudaStream_t)stream);
}

// One segment of the decode write: pool [L, B, S, row_bytes], src
// [L, B, row_bytes]; the pool is the slice [base, base + S) of S_glob
// positions (base 0 and S_glob = S: the whole pool).
struct sac_write_seg {
  void* pool;
  const void* src;
  long long L, B, S, row_bytes, base, S_glob;
};

// Writes n_segs (1..4) segments at the positions pos [B] int32 (shared
// by the segments) in one launch.
SAC_API int sac_write_rows_at(const sac_write_seg* segs, int n_segs,
                              const void* pos, void* stream) {
  if (n_segs < 1 || n_segs > rowmove::kMaxSegs)
    return (int)cudaErrorInvalidValue;
  write_rows_at m{};
  m.pos = (const int32_t*)pos;
  m.n_segs = n_segs;
  long long n_pieces = 0;
  unsigned long long align = 0;
  for (int i = 0; i < n_segs; ++i) {
    const sac_write_seg& s = segs[i];
    const int chunks = (int)rowmove::ceil_div(s.row_bytes, kChunk);
    m.seg[i] = WriteSeg{(char*)s.pool, (const char*)s.src, s.S, s.row_bytes,
                        n_pieces, s.base, s.S_glob, (unsigned)s.B,
                        (unsigned)chunks};
    n_pieces += s.L * s.B * chunks;
    align |= bits(s.pool, s.src, s.row_bytes);
  }
  return rowmove::move(m, n_pieces, align, (cudaStream_t)stream);
}

// One segment of the splice: pool [L, B, S, row_bytes]; src [L, n_lanes,
// src_rows, row_bytes], whose rows [src_row0, src_row0 + T) go to lanes
// [lane0, lane0 + n_lanes), rows [offset, offset + T); zero_tail != 0
// also zeroes rows [offset + T, S).
struct sac_splice_seg {
  void* pool;
  const void* src;
  long long L, B, S, lane0, n_lanes, T, offset, zero_tail, row_bytes,
      src_rows, src_row0;
};

SAC_API int sac_splice_kv(const sac_splice_seg* segs, int n_segs,
                          void* stream) {
  if (n_segs < 1 || n_segs > rowmove::kMaxSegs)
    return (int)cudaErrorInvalidValue;
  splice_runs m{};
  m.n_segs = n_segs;
  long long n_pieces = 0;
  unsigned long long align = 0;
  for (int i = 0; i < n_segs; ++i) {
    const sac_splice_seg& s = segs[i];
    const long long run = s.T * s.row_bytes;
    const long long tail =
        s.zero_tail ? (s.S - s.offset - s.T) * s.row_bytes : 0;
    const long long copy = rowmove::ceil_div(run, kChunk);
    const long long total = copy + rowmove::ceil_div(tail, kChunk);
    m.seg[i] = SpliceSeg{(char*)s.pool, (const char*)s.src, s.B, s.S,
                         s.lane0, s.T, s.offset, s.row_bytes, n_pieces,
                         s.src_rows, s.src_row0, (unsigned)s.n_lanes,
                         (unsigned)copy, (unsigned)total};
    n_pieces += s.L * s.n_lanes * total;
    align |= bits(s.pool, s.src, s.row_bytes) |
             (unsigned long long)(s.offset * s.row_bytes) |
             (unsigned long long)(s.src_row0 * s.row_bytes);
  }
  return rowmove::move(m, n_pieces, align, (cudaStream_t)stream);
}
