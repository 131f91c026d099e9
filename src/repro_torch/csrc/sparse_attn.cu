// Top-k sparse attention, split-k ("flash decoding") on the tensor cores:
//   out[b, h] = softmax_j(scale * q[b, h] . K[b, j] + mask[b, j]) @ V[b]
// with mask 0 on valid lanes and -1e30 on invalid ones, in two forms:
// - MLA (ops.batched_sparse_mla): K[b, j] = E[b, j, k_col : k_col + dq],
//   V[b, j] = E[b, j, v_col : v_col + dv], every head on the same entries;
// - GQA / MQA (ops.batched_sparse_gqa): an entry row is [2, n_kv, hd]
//   (repro/models/dsa.py::gqa_kv_entry), and head g*n_rep + r attends with
//   K_g = E[..., g*hd : (g+1)*hd] and V_g = E[..., (n_kv+g)*hd : ...].
//
// Replaces: src/repro/kernels/sparse_attn.py::sparse_attn (Pallas: a
// sequential grid over k blocks carrying the running max, sum and
// accumulator in VMEM scratch; it asserts k % block_k == 0).  The GQA form
// is the same Pallas kernel vmapped over requests and KV groups by
// repro/kernels/ops.py::batched_sparse_gqa.
//
// Bound on an H100: bytes, and close to the ridge for MLA.  Qwen2-1.5B
// decode (B=8, 12 heads over 2 KV groups of 128, k=2049) reads 16.8 MB of
// entries (5 us at 3.35 TB/s) at 6 FLOP/byte; DeepSeek-V3.2 decode (B=4,
// H=128, k=2049, dq=576, dv=512) reads 9.4 MB (2.8 us) and does 2.3 GFLOP
// (2.3 us on the bf16 tensor cores).
//
// Design.  The TPU grid's sequential k axis is split across blocks:
// - Pass 1 (sparse_{gqa,mla}_partial_kernel), grid (split, head group,
//   request), 8 warps.  A block takes a contiguous chunk of the k lanes (a
//   multiple of the 64-lane tile) for up to 16 heads (MLA) or all n_rep
//   heads of one KV group (GQA, so each entry is read from memory once),
//   and writes the unnormalised partials m, l and acc to f32 scratch.  The
//   host picks the chunk from the shape (kernels/sparse_attn.py::
//   split_plan): fewest waves x (tiles per block + 1) for the blocks the
//   card holds at once.
// - Pass 2 (sparse_attn_combine_kernel), one block per (request, head),
//   launched as a programmatic dependent launch so that it starts while
//   pass 1 drains: m* = max_s m_s, out = sum_s 2^(m_s - m*) acc_s /
//   max(sum_s 2^(m_s - m*) l_s, 1e-30).  A chunk of invalid lanes has
//   m = -1e30 and weighs 0 beside any valid lane; with no valid lane at
//   all every chunk weighs 1 and the output is the mean of the values, as
//   the one-pass softmax gives.  Lanes past k score -inf.
// - Tiles of 64 entry rows stream through a two-stage shared-memory ring
//   filled by 16-byte cp.async from every thread (rows past k
//   zero-filled): tile t+1 is in flight while tile t is computed.  Only
//   the needed column ranges are staged (GQA: the group's key and value
//   ranges, zero-padded to 16 columns; MLA: one range, the values being
//   its first dv columns).  The block's q rows arrive in one bulk copy
//   (TMA, completion on an mbarrier) beside tile 0.
// - Products on the tensor cores, mma.sync m16n8k16 bf16 -> f32 with
//   ldmatrix fragments, on 16-row head tiles: S = Q K^T (warp = 16 lanes
//   x one half of the q.k dims; the halves are added in the softmax), then
//   acc += P V (each warp owns 16-column slices of V).  The keys and
//   values are bf16 and exact; q and p are f32, so each is split into
//   hi = bf16(x) and lo = bf16(x - hi) and both halves go into the same
//   f32 accumulator (relative error about 2^-17, against 2^-9 for a single
//   bf16 rounding).  Scores are in log2 units (q carries scale * log2 e);
//   max, sum and correction stay f32 and the division comes last.
// - Entries of the fp8 pool (kv_quant="fp8", float8_e4m3fn) take the same
//   path at half the bytes: the ring holds the raw e4m3 tiles (16 entry
//   values per 16-byte cp.async instead of 8), and once a tile has landed
//   the block converts it into one bf16 tile in shared memory (exact:
//   e4m3's 3 mantissa bits and exponents fit bf16), which the ldmatrix /
//   mma.sync path above reads unchanged.  The entries are read from
//   memory once, as e4m3; the block's q rows land in the bf16 tile.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "ptx.cuh"

namespace {

constexpr int kTile = 64;            // entry rows per tile
constexpr int kWarps = 8;            // 4 groups of 16 lanes x 2 k halves
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxItems = 5;         // P V items (16 heads x 16 cols) a warp
constexpr int kPStride = kTile + 8;  // row stride of the scores and P
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block can use
constexpr float kMasked = -1e30f;

struct Params {
  const float* q;                    // [B, H, dq]
  const void* ent;                   // entry rows, bf16 or e4m3
  const uint8_t* valid;              // [B, k]
  float* m_part;                     // [B, H, splits]
  float* l_part;                     // [B, H, splits]
  float* acc_part;                   // [B, H, splits, dv]
  long long ent_batch, ent_row;      // strides of the entries, in elements
  int H, k, dq, dv, dqp, dvp;        // dqp, dvp: dq, dv rounded up to 16
  int hb, ht;                        // heads per block, 16-row head tiles
  int splits, chunk;                 // lanes per split: a multiple of kTile
  int c0, w0, c1, w1;                // staged column ranges of group 0
  int col_step;                      // column shift from one group to the next
  int koff, voff;                    // keys / values inside the staged tiles
  int stride;                        // row stride of a bf16 tile
  int rstride;                       // e4m3: row stride of a raw tile, bytes
  float scale;
};

// Shared memory of pass 1, in bytes: the tile ring (bf16 tiles, or raw
// e4m3 tiles of rstride bytes a row and one bf16 tile they are converted
// into), q as bf16 hi and lo, the two k-halves' partial scores (f32), P as
// bf16 hi and lo, and m, l, corr per head row.
size_t partial_smem(int ranges, int stages, int stride, int rows, int qs,
                    int rstride) {
  const size_t bf16_tile = sizeof(__nv_bfloat16) * kTile * stride;
  const size_t ring = rstride ? (size_t)ranges * (stages * (size_t)kTile
                                                  * rstride + bf16_tile)
                              : (size_t)stages * ranges * bf16_tile;
  return ring + sizeof(__nv_bfloat16) * (2 * (size_t)rows * qs
                                         + 2 * (size_t)rows * kPStride) +
         sizeof(float) * (2 * (size_t)rows * kPStride + 3 * (size_t)rows);
}

// 16 e4m3 values (one 16-byte word) -> 16 bf16 values (two), exactly:
// each pair through the hardware's e4m3x2 -> f16x2 conversion, then f32.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t pair) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(pair & 0xffffu), __NV_E4M3));
  const float2 f = __half22float2(h);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ void e4m3x16_to_bf16(const uint4 v, uint4 (&o)[2]) {
  o[0] = make_uint4(e4m3x2_to_bf16x2(v.x), e4m3x2_to_bf16x2(v.x >> 16),
                    e4m3x2_to_bf16x2(v.y), e4m3x2_to_bf16x2(v.y >> 16));
  o[1] = make_uint4(e4m3x2_to_bf16x2(v.z), e4m3x2_to_bf16x2(v.z >> 16),
                    e4m3x2_to_bf16x2(v.w), e4m3x2_to_bf16x2(v.w >> 16));
}

// Pass 1.  kShared: one staged range holds keys and values (MLA); else the
// key and value ranges are staged into two tiles (GQA).  kStages: depth of
// the tile ring (1 only where two stages overflow shared memory).  kFp8:
// the entries are e4m3 bytes (converted to a bf16 tile as each lands),
// else bf16.  Scores are in log2 units (q carries scale * log2 e):
// p = 2^(s - m).
template <bool kShared, int kStages, bool kFp8>
__device__ __forceinline__ void partial_body(const Params& p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qbar_s;              // q's bulk copy
  constexpr int kRanges = kShared ? 1 : 2;
  constexpr int kB = (int)sizeof(__nv_bfloat16);
  constexpr int kEB = kFp8 ? 1 : kB;                    // bytes an entry value
  constexpr int kEpc = 16 / kEB;                        // values a cp.async
  constexpr float kLog2e = 1.4426950408889634f;
  const int rows = 16 * p.ht;
  const int qs = p.dqp + 8;
  const int tile_elems = kTile * p.stride;
  // the ring's row pitch and tile size in bytes; the bf16 tiles the
  // products read (the ring itself, or the one tile e4m3 converts into)
  const int pitch = kFp8 ? p.rstride : p.stride * kB;
  const int ring_tile = kTile * pitch;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (kFp8 ? kStages * kRanges * ring_tile : 0));
  constexpr int kCompute = kFp8 ? 1 : kStages;          // bf16 tile sets
  __nv_bfloat16* qhi = tiles + kCompute * kRanges * tile_elems;  // [rows][qs]
  __nv_bfloat16* qlo = qhi + rows * qs;
  float* ssp = reinterpret_cast<float*>(qlo + rows * qs);  // [2][rows][72]
  __nv_bfloat16* ph =
      reinterpret_cast<__nv_bfloat16*>(ssp + 2 * rows * kPStride);
  __nv_bfloat16* pl = ph + rows * kPStride;
  float* m_s = reinterpret_cast<float*>(pl + rows * kPStride);
  float* l_s = m_s + rows;
  float* c_s = l_s + rows;

  const int split = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = grp * p.hb;
  const int nh = min(p.hb, p.H - h0);
  const int lane0 = split * p.chunk;
  const int n_tiles = (min(p.chunk, p.k - lane0) + kTile - 1) / kTile;
  const unsigned char* eb = static_cast<const unsigned char*>(p.ent)
                            + (long long)b * p.ent_batch * kEB;
  const uint8_t* vb = p.valid + (long long)b * p.k;
  const uint32_t qbar = smem_u32(&qbar_s);

  // copies of tile t: thread (row r0, 16-byte column c) copies rows r0,
  // r0 + rpp, ... of its column with cp.async (rows past k read as zeros)
  const int v0 = p.w0 / kEpc, per_row = v0 + (kShared ? 0 : p.w1 / kEpc);
  const int rpp = kThreads / per_row;
  const int cp_r0 = tid / per_row, cp_c = tid % per_row;
  const bool second = !kShared && cp_c >= v0;
  const int cp_cc = second ? cp_c - v0 : cp_c;
  const unsigned char* cp_src0 =
      eb + (long long)((second ? p.c1 : p.c0) + grp * p.col_step
                       + cp_cc * kEpc) * kEB;
  const uint32_t cp_dst0 = smem_u32(smem_raw) + (second ? ring_tile : 0)
                           + cp_r0 * pitch + cp_cc * 16;
  auto issue = [&](int t) {
    if (cp_r0 < rpp) {
      int row = lane0 + t * kTile + cp_r0;
      const unsigned char* src = cp_src0 + (long long)row * p.ent_row * kEB;
      uint32_t dst = cp_dst0 + (uint32_t)((t % kStages) * kRanges
                                          * ring_tile);
      const long long src_step = (long long)rpp * p.ent_row * kEB;
      const uint32_t dst_step = rpp * pitch;
      for (int r = cp_r0; r < kTile; r += rpp) {
        const bool ok = row < p.k;
        cp_async16(dst, ok ? src : cp_src0, ok ? 16 : 0);
        row += rpp;
        src += src_step;
        dst += dst_step;
      }
    }
    cp_async_commit();
  };

  // softmax ownership: sixteen threads per head row (4 lanes each), two
  // rows a warp; the valid bytes of the thread's lanes, one tile ahead
  const int sm_row = warp * 2 + (lane >> 4), sm_c0 = (lane & 15) * 4;
  auto load_valid = [&](int t, uint8_t (&raw)[4]) {
    const int j = lane0 + t * kTile + sm_c0;
#pragma unroll
    for (int e = 0; e < 4; ++e) raw[e] = j + e < p.k ? vb[j + e] : 0;
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // q rows of the block (f32, one bulk copy) into the last bf16 tile set
  // (they fit: gqa_pass1, mla_pass1), tile 0 into stage 0
  float* qbuf = reinterpret_cast<float*>(tiles + (kCompute - 1) * kRanges
                                         * tile_elems);
  if (tid == 0) {
    const uint32_t qbytes = (uint32_t)nh * p.dq * sizeof(float);
    mbar_expect(qbar, qbytes);
    bulk_copy(smem_u32(qbuf), p.q + ((long long)b * p.H + h0) * p.dq, qbytes,
              qbar);
  }
  constexpr bool kEarly = kFp8 || kStages > 1;          // q not in the ring
  if (kEarly) issue(0);
  uint8_t raw_valid[4], raw_next[4];
  load_valid(0, raw_valid);

  // q * scale * log2(e) as bf16 hi + lo, zero past the heads and past dq
  mbar_wait(qbar, 0);
  {
    const float qscale = p.scale * kLog2e;
    const int row4 = p.dqp / 4, dq4 = p.dq / 4;
    for (int i = tid; i < rows * row4; i += kThreads) {
      const int r = i / row4, c = i - r * row4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nh && c < dq4) v = reinterpret_cast<const float4*>(qbuf)[
          r * dq4 + c];
      const float x[4] = {v.x * qscale, v.y * qscale, v.z * qscale,
                          v.w * qscale};
      __nv_bfloat162 hi[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        hi[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
        const float2 h = __bfloat1622float2(hi[e]);
        lo[e] = __floats2bfloat162_rn(x[2 * e] - h.x, x[2 * e + 1] - h.y);
      }
      *reinterpret_cast<uint2*>(qhi + r * qs + 4 * c) =
          *reinterpret_cast<const uint2*>(hi);
      *reinterpret_cast<uint2*>(qlo + r * qs + 4 * c) =
          *reinterpret_cast<const uint2*>(lo);
    }
  }
  __syncthreads();            // q converted: its buffer is free again
  if (!kEarly) issue(0);
  // the columns that pad keys and values to 16 stay zero in every tile set
  if (!kShared && (p.w0 < p.dqp || p.w1 < p.dvp)) {
    for (int i = tid; i < kCompute * kTile; i += kThreads) {
      __nv_bfloat16* row = tiles + (i / kTile) * kRanges * tile_elems
                           + (i % kTile) * p.stride;
      for (int c = p.w0; c < p.dqp; ++c) row[c] = __float2bfloat16(0.f);
      for (int c = p.w1; c < p.dvp; ++c)
        row[tile_elems + c] = __float2bfloat16(0.f);
    }
  }
  for (int i = tid; i < rows; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }

  const int npairs = p.dvp / 16;
  const int n_items = p.ht * npairs;
  float acc[kMaxItems][2][4];
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  // ldmatrix addressing: lane i feeds row (i & 7) of matrix i / 8.  A
  // fragments (q, P): matrix = (row half, k half); B fragments of keys
  // (rows = lanes, non-transposed): matrix = (k half, lane half); B
  // fragments of values (rows = lanes, transposed): (lane half, col half).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const uint32_t qhi_a = smem_u32(qhi + a_row * qs + a_col);
  const uint32_t qlo_a = smem_u32(qlo + a_row * qs + a_col);
  const uint32_t ph_a = smem_u32(ph + a_row * kPStride + a_col);
  const uint32_t pl_a = smem_u32(pl + a_row * kPStride + a_col);
  // scores: warp = (k half kh, 16 lanes lg); k-steps [ks0, ks1) of 16 dims
  const int lg = warp & 3, kh = warp >> 2;
  const int nks = p.dqp / 16, half = (nks + 1) / 2;
  const int ks0 = min(nks, kh * half), ks1 = min(nks, ks0 + half);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();          // tile t landed; every warp is past tile t-1
    if (kStages > 1 && t + 1 < n_tiles) issue(t + 1);
    if (t + 1 < n_tiles) load_valid(t + 1, raw_next);
    if (kFp8) {
      // the landed e4m3 tile -> the bf16 tile (every warp is past tile t-1)
      const unsigned char* raw = smem_raw + (t % kStages) * kRanges
                                            * ring_tile;
#pragma unroll
      for (int r = 0; r < kRanges; ++r) {
        const int per = (r ? p.w1 : p.w0) / 16;
        for (int i = tid; i < kTile * per; i += kThreads) {
          const int row = i / per, c = i - row * per;
          uint4 o[2];
          e4m3x16_to_bf16(*reinterpret_cast<const uint4*>(
                              raw + r * ring_tile + row * pitch + c * 16),
                          o);
          uint4* dst = reinterpret_cast<uint4*>(
              tiles + r * tile_elems + row * p.stride + c * 16);
          dst[0] = o[0];
          dst[1] = o[1];
        }
      }
      __syncthreads();
    }
    const __nv_bfloat16* st = tiles + (t % kCompute) * kRanges * tile_elems;
    const __nv_bfloat16* ks = st + p.koff;
    const __nv_bfloat16* vs = (kShared ? st : st + tile_elems) + p.voff;

    // partial scores of lanes lg*16 .. +15 over this warp's k half
    {
      const uint32_t k_a = smem_u32(ks + (lg * 16 + k_row) * p.stride
                                    + k_col);
      float* sp_out = ssp + kh * rows * kPStride;
      for (int h = 0; h < p.ht; ++h) {
        // four independent chains per n-tile: (even, odd k-step) x (hi, lo)
        float s[2][2][2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[a][n][c][e] = 0.f;
        const uint32_t qh = qhi_a + h * 16 * qs * kB;
        const uint32_t ql = qlo_a + h * 16 * qs * kB;
        auto step = [&](int d, float (&sp)[2][2][4]) {
          uint32_t ah[4], al[4], bk[4];
          ldsm_x4(ah, qh + d * kB);
          ldsm_x4(al, ql + d * kB);
          ldsm_x4(bk, k_a + d * kB);
          mma(sp[0][0], ah, bk[0], bk[1]);
          mma(sp[1][0], ah, bk[2], bk[3]);
          mma(sp[0][1], al, bk[0], bk[1]);
          mma(sp[1][1], al, bk[2], bk[3]);
        };
        int ksi = ks0;
        for (; ksi + 2 <= ks1; ksi += 2) {
          step(ksi * 16, s[0]);
          step(ksi * 16 + 16, s[1]);
        }
        if (ksi < ks1) step(ksi * 16, s[0]);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {   // rows g and g + 8
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 2 * hf + e;
              v[e] = (s[0][n][0][x] + s[1][n][0][x])
                     + (s[0][n][1][x] + s[1][n][1][x]);
            }
            *reinterpret_cast<float2*>(
                sp_out + (h * 16 + g + 8 * hf) * kPStride + lg * 16 + n * 8
                + 2 * t4) = make_float2(v[0], v[1]);
          }
      }
    }
    __syncthreads();

    // sum the halves, mask (-1e30 invalid, -inf past k), running max and
    // sum, P as bf16 hi + lo
    {
      const int j0 = lane0 + t * kTile + sm_c0;
      for (int r = sm_row; r < rows; r += 2 * kWarps) {
        float s[4];
        {
          const float4 a = *reinterpret_cast<const float4*>(
              ssp + r * kPStride + sm_c0);
          const float4 c = *reinterpret_cast<const float4*>(
              ssp + (rows + r) * kPStride + sm_c0);
          s[0] = a.x + c.x; s[1] = a.y + c.y;
          s[2] = a.z + c.z; s[3] = a.w + c.w;
        }
        float mx = -INFINITY;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[e] = j0 + e < p.k ? (raw_valid[e] ? s[e] : kMasked) : -INFINITY;
          mx = fmaxf(mx, s[e]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        __nv_bfloat162 hi[2], lo[2];
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float p0 = exp2f(s[e] - m_new), p1 = exp2f(s[e + 1] - m_new);
          sum += p0 + p1;
          hi[e / 2] = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi[e / 2]);
          lo[e / 2] = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        *reinterpret_cast<uint2*>(ph + r * kPStride + sm_c0) =
            *reinterpret_cast<const uint2*>(hi);
        *reinterpret_cast<uint2*>(pl + r * kPStride + sm_c0) =
            *reinterpret_cast<const uint2*>(lo);
        if ((lane & 15) == 0) {
          const float corr = exp2f(m_prev - m_new);
          c_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: item = (head tile, 16 value columns)
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int item = warp + kWarps * i;
      if (item < n_items) {
        const int h = item / npairs, n0 = (item - h * npairs) * 16;
        const int r0 = h * 16 + g;
        const float cg = c_s[r0], cg8 = c_s[r0 + 8];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc[i][n][0] *= cg;
          acc[i][n][1] *= cg;
          acc[i][n][2] *= cg8;
          acc[i][n][3] *= cg8;
        }
        const uint32_t pha = ph_a + h * 16 * kPStride * kB;
        const uint32_t pla = pl_a + h * 16 * kPStride * kB;
        const uint32_t va = smem_u32(vs + a_row * p.stride + n0 + a_col);
#pragma unroll
        for (int kk = 0; kk < kTile; kk += 16) {
          uint32_t ah[4], al[4], bv[4];
          ldsm_x4(ah, pha + kk * kB);
          ldsm_x4(al, pla + kk * kB);
          ldsm_x4_t(bv, va + kk * p.stride * kB);
          mma(acc[i][0], ah, bv[0], bv[1]);
          mma(acc[i][1], ah, bv[2], bv[3]);
          mma(acc[i][0], al, bv[0], bv[1]);
          mma(acc[i][1], al, bv[2], bv[3]);
        }
      }
    }
    if (kStages == 1) {
      __syncthreads();        // every warp is done with the only stage
      if (t + 1 < n_tiles) issue(t + 1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) raw_valid[e] = raw_next[e];
  }

  // the partials of this split (m in log2 units)
  const long long part = ((long long)b * p.H + h0) * p.splits + split;
  for (int i = tid; i < nh; i += kThreads) {
    p.m_part[part + (long long)i * p.splits] = m_s[i];
    p.l_part[part + (long long)i * p.splits] = l_s[i];
  }
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i) {
    const int item = warp + kWarps * i;
    if (item < n_items) {
      const int h = item / npairs, n0 = (item - h * npairs) * 16;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = h * 16 + g + 8 * hf;
        if (r >= nh) continue;
        float* o = p.acc_part + (part + (long long)r * p.splits) * p.dv;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = n0 + n * 8 + 2 * t4;
          if (col < p.dv)
            *reinterpret_cast<float2*>(o + col) =
                make_float2(acc[i][n][2 * hf], acc[i][n][2 * hf + 1]);
        }
      }
    }
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <int kStages, bool kFp8>
__global__ void __launch_bounds__(kThreads, 2)
sparse_gqa_partial_kernel(const Params p) {
  partial_body<false, kStages, kFp8>(p);
}

template <bool kFp8>
__global__ void __launch_bounds__(kThreads)
sparse_mla_partial_kernel(const Params p) {
  partial_body<true, 2, kFp8>(p);
}

// Pass 2: one block per (request, head) merges the splits' partials.
// The splits are shared out over the threads (dv <= 4 * kThreads): thread
// (group, column) sums every G-th split of one float4 column.
__global__ void __launch_bounds__(kThreads)
sparse_attn_combine_kernel(const float* __restrict__ m_part,
                           const float* __restrict__ l_part,
                           const float* __restrict__ acc_part,
                           float* __restrict__ out, int splits, int dv) {
  extern __shared__ float w_s[];          // [splits]
  __shared__ float red[2][kWarps];
  __shared__ float4 part_s[kThreads];
  // launched early (programmatic dependent launch): wait for pass 1
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long bh = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* mp = m_part + bh * splits;
  const float* lp = l_part + bh * splits;

  float mx = -INFINITY;
  for (int s = tid; s < splits; s += kThreads) mx = fmaxf(mx, mp[s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[0][warp] = mx;
  __syncthreads();
  mx = red[0][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[0][w]);
  float l = 0.f;
  for (int s = tid; s < splits; s += kThreads) {
    const float w = exp2f(mp[s] - mx);
    w_s[s] = w;
    l += w * lp[s];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) red[1][warp] = l;
  __syncthreads();

  const int dv4 = dv / 4, groups = kThreads / dv4;
  const int grp = tid / dv4, col = tid % dv4;
  const float4* ap = reinterpret_cast<const float4*>(acc_part
                                                     + bh * splits * dv);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (grp < groups) {
#pragma unroll 4
    for (int s = grp; s < splits; s += groups) {
      const float4 x = ap[(long long)s * dv4 + col];
      const float w = w_s[s];
      a.x = fmaf(w, x.x, a.x);
      a.y = fmaf(w, x.y, a.y);
      a.z = fmaf(w, x.z, a.z);
      a.w = fmaf(w, x.w, a.w);
    }
  }
  part_s[tid] = a;
  __syncthreads();
  if (tid < dv4) {
    l = red[1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l += red[1][w];
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int g = 1; g < groups; ++g) {
      const float4 x = part_s[g * dv4 + tid];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    reinterpret_cast<float4*>(out + bh * dv)[tid] =
        make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
}

// A pass-1 kernel for one shape: the kernel, its dynamic shared memory
// and the limit already granted to it (raised once, to what it needs).
struct Pass1 {
  void (*fn)(const Params);
  size_t smem;
  int* granted;
};

// the dynamic shared memory granted so far to each pass-1 kernel:
// [stages - 1][fp8] for GQA, [fp8] for MLA
int g_smem_gqa[2][2] = {{48 * 1024, 48 * 1024}, {48 * 1024, 48 * 1024}};
int g_smem_mla[2] = {48 * 1024, 48 * 1024};

// GQA pass 1 for n_rep heads of head dim hd, bf16 or (fp8) e4m3 entries;
// fn is null for a shape the kernel does not take: hd * (entry bytes) not
// a multiple of 16 or hd > 512, more than kMaxItems P V items a warp, the
// group's f32 q rows larger than the bf16 tile set they land in, or shared
// memory past the limit even with one stage.
Pass1 gqa_pass1(int n_rep, int hd, bool fp8) {
  Pass1 k = {nullptr, 0, nullptr};
  const int epc = fp8 ? 16 : 8;
  if (n_rep < 1 || hd < epc || hd % epc || hd > 512) return k;
  const int dp = (hd + 15) / 16 * 16, ht = (n_rep + 15) / 16;
  const size_t stage = 2 * (size_t)kTile * (dp + 8) * sizeof(__nv_bfloat16);
  if ((ht * (dp / 16) + kWarps - 1) / kWarps > kMaxItems ||
      (size_t)n_rep * hd * sizeof(float) > stage)
    return k;
  const int rstride = fp8 ? hd : 0;
  for (int stages = 2; stages >= 1; --stages) {
    k.smem = partial_smem(2, stages, dp + 8, 16 * ht, dp + 8, rstride);
    if (k.smem > (size_t)kMaxSmem) continue;
    k.fn = stages == 2 ? (fp8 ? sparse_gqa_partial_kernel<2, true>
                              : sparse_gqa_partial_kernel<2, false>)
                       : (fp8 ? sparse_gqa_partial_kernel<1, true>
                              : sparse_gqa_partial_kernel<1, false>);
    k.granted = &g_smem_gqa[stages - 1][fp8];
    return k;
  }
  return k;
}

// MLA pass 1 for 16 heads over one staged range of st_w >= dq columns (the
// 16 f32 q rows, 64 * dq bytes, always fit in a bf16 tile of
// 128 * (st_w + 8)); with fp8 the range is st_w bytes a row.
Pass1 mla_pass1(int dq, int st_w, bool fp8) {
  Pass1 k = {nullptr,
             partial_smem(1, 2, st_w + 8, 16, dq + 8, fp8 ? st_w : 0),
             &g_smem_mla[fp8]};
  if (dq <= st_w && k.smem <= (size_t)kMaxSmem)
    k.fn = fp8 ? sparse_mla_partial_kernel<true>
               : sparse_mla_partial_kernel<false>;
  return k;
}

cudaError_t allow_smem(const Pass1& k) {
  if (!k.fn) return cudaErrorInvalidValue;
  if ((int)k.smem <= *k.granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)k.smem);
  if (err == cudaSuccess) *k.granted = (int)k.smem;
  return err;
}

// Blocks of pass 1 that one SM holds at once, from the occupancy
// calculator (registers and shared memory): what the host's split plan
// fills.
int blocks_per_sm(const Pass1& k, int* blocks) {
  cudaError_t err = allow_smem(k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, (const void*)k.fn, kThreads, k.smem);
}

// Pass 2 on the same stream, as a programmatic dependent launch: its
// blocks may start while pass 1 drains and wait for it on the device.
int combine(const Params& p, float* out, int B, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * p.H));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * p.splits;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, sparse_attn_combine_kernel, (const float*)p.m_part,
      (const float*)p.l_part, (const float*)p.acc_part, out, p.splits, p.dv);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Pass 1 on the grid, then pass 2, on one stream.
int launch(const Pass1& k, Params p, dim3 grid, float* out, int B,
           cudaStream_t stream) {
  cudaError_t err = allow_smem(k);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchKernel((const void*)k.fn, grid, dim3(kThreads), args,
                         k.smem, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return combine(p, out, B, stream);
}

}  // namespace

// Blocks of GQA pass 1 one SM holds for n_rep heads of head dim hd (fp8:
// e4m3 entries), into *blocks; cudaErrorInvalidValue for a shape the
// kernel does not take.
SAC_API int sac_sparse_attn_gqa_blocks_per_sm(int n_rep, int hd, int fp8,
                                              int* blocks) {
  return blocks_per_sm(gqa_pass1(n_rep, hd, fp8 != 0), blocks);
}

// The same for MLA pass 1 (q of dq columns, a staged range of st_w).
SAC_API int sac_sparse_attn_blocks_per_sm(int dq, int st_w, int fp8,
                                          int* blocks) {
  return blocks_per_sm(mla_pass1(dq, st_w, fp8 != 0), blocks);
}

// q: [B, H, hd] f32; ent: entry rows [2, n_kv, hd] of bf16, or of e4m3
// when fp8 (batch stride ent_batch and row stride ent_row, in elements);
// valid: [B, k] bytes;
// part: f32 scratch of B*H*splits*(hd + 2) (acc, then m, then l); out:
// [B, H, hd] f32.  Lanes [s*chunk, (s+1)*chunk) go to split s.  A shape
// that gqa_pass1 refuses returns cudaErrorInvalidValue.  The wrapper
// checks H % n_kv == 0, 16-byte alignment, and that the splits cover k.
SAC_API int sac_sparse_attn_gqa(const void* q, const void* ent,
                                const void* valid, void* part, void* out,
                                int B, int H, int n_kv, int k, int hd,
                                int splits, int chunk, long long ent_batch,
                                long long ent_row, float scale, int fp8,
                                void* stream) {
  if (B <= 0 || n_kv <= 0 || k <= 0) return 0;
  Params p;
  p.q = (const float*)q;
  p.ent = ent;
  p.valid = (const uint8_t*)valid;
  p.acc_part = (float*)part;
  p.m_part = p.acc_part + (size_t)B * H * splits * hd;
  p.l_part = p.m_part + (size_t)B * H * splits;
  p.ent_batch = ent_batch;
  p.ent_row = ent_row;
  p.H = H;
  p.k = k;
  p.dq = p.dv = hd;
  p.dqp = p.dvp = (hd + 15) / 16 * 16;
  p.hb = H / n_kv;
  p.ht = (p.hb + 15) / 16;
  p.splits = splits;
  p.chunk = chunk;
  p.c0 = 0;
  p.w0 = hd;
  p.c1 = n_kv * hd;
  p.w1 = hd;
  p.col_step = hd;
  p.koff = p.voff = 0;
  p.stride = p.dqp + 8;
  p.rstride = hd;
  p.scale = scale;
  return launch(gqa_pass1(p.hb, hd, fp8 != 0), p, dim3(splits, n_kv, B),
                (float*)out, B, (cudaStream_t)stream);
}

// q: [B, H, dq] f32; ent: entry rows of bf16, or of e4m3 when fp8 (batch
// stride ent_batch and row stride ent_row, in elements); valid: [B, k]
// bytes; part: f32 scratch of B*H*splits*(dv + 2); out: [B, H, dv] f32.
// 16 heads per block.  The wrapper checks that the staged columns
// [st_col, st_col + st_w) hold [k_col, k_col + dq) and [v_col, v_col + dv),
// that every column offset and st_w are multiples of 16 bytes and dq, dv
// multiples of 16 with dv <= 512, and 16-byte alignment; a shape mla_pass1
// refuses returns cudaErrorInvalidValue.
SAC_API int sac_sparse_attn(const void* q, const void* ent, const void* valid,
                            void* part, void* out, int B, int H, int k,
                            int dq, int dv, int k_col, int v_col, int st_col,
                            int st_w, int splits, int chunk,
                            long long ent_batch, long long ent_row,
                            float scale, int fp8, void* stream) {
  if (B <= 0 || H <= 0 || k <= 0) return 0;
  Params p;
  p.q = (const float*)q;
  p.ent = ent;
  p.valid = (const uint8_t*)valid;
  p.acc_part = (float*)part;
  p.m_part = p.acc_part + (size_t)B * H * splits * dv;
  p.l_part = p.m_part + (size_t)B * H * splits;
  p.ent_batch = ent_batch;
  p.ent_row = ent_row;
  p.H = H;
  p.k = k;
  p.dq = p.dqp = dq;
  p.dv = p.dvp = dv;
  p.hb = 16;
  p.ht = 1;
  p.splits = splits;
  p.chunk = chunk;
  p.c0 = st_col;
  p.w0 = st_w;
  p.c1 = p.w1 = 0;
  p.col_step = 0;
  p.koff = k_col - st_col;
  p.voff = v_col - st_col;
  p.stride = st_w + 8;
  p.rstride = st_w;
  p.scale = scale;
  return launch(mla_pass1(dq, st_w, fp8 != 0), p,
                dim3(splits, (H + 15) / 16, B), (float*)out, B,
                (cudaStream_t)stream);
}
