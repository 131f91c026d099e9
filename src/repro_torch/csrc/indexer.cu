// Lightning-indexer scoring:
//   out[b, s] = sum_h w[b, h] * ReLU(q[b, h] . keys[b, s]) / sqrt(di)
// for every s in [0, S), positions past a request's cache length included
// (the masking is dsa.topk_select's).
//
// Replaces: src/repro/kernels/indexer.py:31 indexer_scores (Pallas: a grid
// over S blocks, a [block_s, di] x [di, H] MXU product, ReLU and a weighted
// reduction over heads; it asserts S % block_s == 0).
//
// Bound on an H100: bytes, at every served shape.  The keys are read once:
// DeepSeek-V3.2 decode (B=4, S=4160, H=64, di=128) reads 4.3 MB (1.3 us at
// 3.35 TB/s) for 0.27 GFLOP (0.3 us on the bf16 tensor cores); Qwen2-1.5B
// decode (B=8, S=8256, H=4, di=64) reads 8.5 MB (2.5 us) for 0.03 GFLOP; a
// long DeepSeek-V3.2 context (B=4, S=65536) reads 67 MB, more than the
// 50 MB L2 holds (20 us), for 4.3 GFLOP (4.3 us; 8.6 with q's lo half).
//
// Design.
// - A block owns request b and a contiguous chunk of key tiles (grid
//   (chunks, B), 4 warps) and loops over them, so q and w are staged once
//   per block.  The host picks the chunk (kernels/indexer.py::indexer_plan):
//   fewest waves x (tiles per chunk + 1) for the blocks the card holds at
//   once, which the C side reads from the CUDA occupancy calculator
//   (sac_indexer_blocks_per_sm).
// - A request's keys are contiguous, so a tile (128 rows for di <= 128, 64
//   beyond) is one contiguous range.  Tiles stream through a ring of 2-4
//   stages in shared memory (the deepest that still lets two blocks share
//   an SM), filled with 16-byte cp.async: consecutive threads on
//   consecutive addresses, rows padded by 16 bytes so that ldmatrix reads
//   them without bank conflicts, rows past S zero-filled.  A block loads q
//   and w into registers, then issues the first tiles' copies, then stages
//   q while they are in flight (loads issued behind the copies wait for
//   them).
// - Products on the bf16 tensor cores, mma.sync m16n8k16 with f32
//   accumulators: A is a 16-row strip of the key tile (exact in bf16), B is
//   q as [H_pad, di], H padded to a multiple of 16 by zero rows whose w is
//   0 (an 8-head n-tile that is all padding is skipped).  q is f32, so each
//   block splits it once into bf16 hi and lo halves and both products go
//   into the accumulator (q kept to within 2^-16 relative).  Where every
//   lo is zero (q a bf16 value cast to f32, as on the serving path) the
//   block skips the lo products: exact, not an approximation.
// - Each warp owns 32 rows of a tile (two strips; one for di > 128) across
//   all heads: it holds the strips' A fragments in registers and streams
//   q's B fragments from shared memory, two 8-head n-tiles at a time.
//   ReLU, the 1/sqrt(di) scale (carried by w) and the weighted sum over
//   heads stay in registers: one add over a fragment's two columns, a
//   running sum over the n-tiles, then two quad shuffles; the warp writes
//   its rows' scores coalesced.  Every sum has a fixed order (no atomics),
//   so two launches give the same bits.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "ptx.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxKSteps = 16;       // di <= 256
constexpr int kQAhead = 16;          // float4 of q a thread loads up front
constexpr int kMaxHeads = 128;       // at most kThreads

struct Params {
  const float* q;                    // [B, H, di]
  const float* w;                    // [B, H]
  const __nv_bfloat16* keys;         // [B, S, di]
  float* out;                        // [B, S]
  int S, H, hp;                      // hp: H rounded up to 16
  int chunk;                         // tiles per block
  int stages;                        // depth of the tile ring, 2..4
  float inv_sqrt_di;
};

// For di = 16 * ks: the 16-row strips a warp owns (their A fragments stay
// in registers, 4 * ks a strip), the rows of a tile, and the row stride in
// bf16 of the staged tiles and of q (padded by 16 bytes).
__host__ __device__ constexpr int strips(int ks) { return ks <= 8 ? 2 : 1; }
__host__ __device__ constexpr int tile_rows(int ks) {
  return 16 * strips(ks) * kWarps;
}
__host__ __device__ constexpr int row_stride(int ks) { return 16 * ks + 8; }

// Shared memory, in bytes: the ring, q as bf16 hi and lo [hp][stride], and
// w / sqrt(di) [hp] f32.
size_t smem_bytes(int ks, int hp, int stages) {
  return sizeof(__nv_bfloat16) * ((size_t)stages * tile_rows(ks) + 2 * hp)
             * row_stride(ks) +
         sizeof(float) * hp;
}

// The weighted head sums of the warp's rows of one staged tile: on return
// every lane of quad g holds, in rs[s][h], the partial sum over its two
// columns of each n-tile for row 16 s + 8 h + g.  a_addr: the warp's first
// strip at the lane's ldmatrix row and column; qhi, qlo: q's B fragments at
// the lane's row and column; nt: 8-head n-tiles holding a real head.
template <int KS, bool kLo>
__device__ __forceinline__ void warp_scores(uint32_t a_addr, uint32_t qhi,
                                            uint32_t qlo, const float* ws,
                                            int nt, int t4,
                                            float (&rs)[strips(KS)][2]) {
  constexpr int kS = strips(KS);
  constexpr int kRowB = row_stride(KS) * (int)sizeof(__nv_bfloat16);
  uint32_t a[kS][KS][4];
#pragma unroll
  for (int s = 0; s < kS; ++s)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(a[s][ks], a_addr + s * 16 * kRowB + ks * 32);
#pragma unroll
  for (int s = 0; s < kS; ++s) rs[s][0] = rs[s][1] = 0.f;
  for (int n0 = 0; n0 < nt; n0 += 2) {
    const bool two = n0 + 1 < nt;
    const uint32_t qoff = n0 * 8 * kRowB;
    float c[kS][2][4];
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[s][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bh[4];
      ldsm_x4(bh, qhi + qoff + ks * 32);
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        mma(c[s][0], a[s][ks], bh[0], bh[1]);
        if (two) mma(c[s][1], a[s][ks], bh[2], bh[3]);
      }
      if (kLo) {
        uint32_t bl[4];
        ldsm_x4(bl, qlo + qoff + ks * 32);
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          mma(c[s][0], a[s][ks], bl[0], bl[1]);
          if (two) mma(c[s][1], a[s][ks], bl[2], bl[3]);
        }
      }
    }
    // ReLU, times w (which carries 1/sqrt(di)), summed over the columns;
    // the columns of padded heads hold 0 and weigh 0
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 wv =
          *reinterpret_cast<const float2*>(ws + (n0 + n) * 8 + 2 * t4);
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        rs[s][0] += wv.x * fmaxf(c[s][n][0], 0.f)
                    + wv.y * fmaxf(c[s][n][1], 0.f);
        rs[s][1] += wv.x * fmaxf(c[s][n][2], 0.f)
                    + wv.y * fmaxf(c[s][n][3], 0.f);
      }
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads)
indexer_kernel(const Params p) {
  constexpr int kS = strips(KS), kRows = tile_rows(KS);
  constexpr int kStride = row_stride(KS);
  constexpr int kDi = 16 * KS;
  constexpr int kVec = kDi / 8;             // 16-byte columns of a key row
  constexpr int kRpp = kThreads / kVec;     // rows one pass of copies covers
  constexpr int kPasses = (kRows + kRpp - 1) / kRpp;
  constexpr int kQ4 = kDi / 4;              // float4 columns of a q row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qhi = tiles + p.stages * kRows * kStride;  // [hp][stride]
  __nv_bfloat16* qlo = qhi + p.hp * kStride;
  float* ws = reinterpret_cast<float*>(qlo + p.hp * kStride);  // [hp]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * p.chunk * kRows;
  const int n_tiles = min(p.chunk, (p.S - row0 + kRows - 1) / kRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* kb = p.keys + (long long)b * p.S * kDi;

  // copies of tile t into stage t % stages: thread (row r, 16-byte column
  // c) copies rows r, r + kRpp, ... of column c; rows past S read as zeros.
  // Past the chunk's last tile a thread commits an empty group, so that
  // the wait below counts the same groups in every iteration.
  const int cp_r = tid / kVec, cp_c = tid % kVec;
  auto issue = [&](int t) {
    if (t < n_tiles && cp_r < kRpp) {
      int row = row0 + t * kRows + cp_r;
      const __nv_bfloat16* src = kb + (long long)row * kDi + cp_c * 8;
      uint32_t dst = smem_u32(tiles + ((t % p.stages) * kRows + cp_r)
                              * kStride + cp_c * 8);
#pragma unroll
      for (int i = 0; i < kPasses; ++i) {
        if (cp_r + i * kRpp < kRows) {
          const bool ok = row < p.S;
          cp_async16(dst, ok ? src : kb, ok ? 16 : 0);
        }
        row += kRpp;
        src += kRpp * kDi;
        dst += kRpp * kStride * (int)sizeof(__nv_bfloat16);
      }
    }
    cp_async_commit();
  };
  // w / sqrt(di) (zero past H) and q's first kQAhead float4 per thread are
  // loaded before the first tiles' copies are issued (behind them they
  // would wait for the tiles), then staged while the tiles are in flight:
  // q as bf16 hi + lo, zero rows past H
  const float4* qb =
      reinterpret_cast<const float4*>(p.q + (long long)b * p.H * kDi);
  const int nq = p.hp * kQ4;
  float4 qv[kQAhead];
#pragma unroll
  for (int j = 0; j < kQAhead; ++j) {
    const int i = tid + j * kThreads;
    qv[j] = i < nq && i / kQ4 < p.H ? qb[i]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float wt =                          // hp <= kThreads
      tid < p.H ? p.w[(long long)b * p.H + tid] * p.inv_sqrt_di : 0.f;
  for (int t = 0; t < p.stages - 1; ++t) issue(t);
  uint32_t lo_bits = 0;
  auto stage_q = [&](int i, float4 v) {
    const int r = i / kQ4, c = i - r * kQ4;
    const float x[4] = {v.x, v.y, v.z, v.w};
    __nv_bfloat162 hi[2], lo[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      hi[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
      const float2 h = __bfloat1622float2(hi[e]);
      lo[e] = __floats2bfloat162_rn(x[2 * e] - h.x, x[2 * e + 1] - h.y);
    }
    const uint2 lo2 = *reinterpret_cast<const uint2*>(lo);
    lo_bits |= lo2.x | lo2.y;
    *reinterpret_cast<uint2*>(qhi + r * kStride + 4 * c) =
        *reinterpret_cast<const uint2*>(hi);
    *reinterpret_cast<uint2*>(qlo + r * kStride + 4 * c) = lo2;
  };
#pragma unroll
  for (int j = 0; j < kQAhead; ++j)
    if (tid + j * kThreads < nq) stage_q(tid + j * kThreads, qv[j]);
  for (int i = tid + kQAhead * kThreads; i < nq; i += kThreads)
    stage_q(i, i / kQ4 < p.H ? qb[i] : make_float4(0.f, 0.f, 0.f, 0.f));
  if (tid < p.hp) ws[tid] = wt;
  const bool has_lo = __syncthreads_or(lo_bits != 0);

  // ldmatrix addressing (lane i feeds row i % 8 of matrix i / 8): A
  // fragments of a key strip, matrices (row half, k half); B fragments of
  // q (rows = heads), matrices (k half, head half)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  const uint32_t qhi_b = smem_u32(qhi + b_row * kStride + b_col);
  const uint32_t qlo_b = smem_u32(qlo + b_row * kStride + b_col);
  const uint32_t a_b = smem_u32(tiles + (warp * 16 * kS + a_row) * kStride
                                + a_col);
  const int nt = (p.H + 7) / 8;
  const int t4 = lane & 3;
  // lane l writes row l of the warp's rows: strip l / 16, half (l / 8) % 2,
  // held by lane 4 * (l % 8) of the quads
  const int w_s = lane >> 4, w_h = (lane >> 3) & 1, w_src = (lane & 7) * 4;
  float* ob = p.out + (long long)b * p.S;

  for (int t = 0; t < n_tiles; ++t) {
    if (p.stages == 2) cp_async_wait<0>();
    else if (p.stages == 3) cp_async_wait<1>();
    else cp_async_wait<2>();
    __syncthreads();          // tile t landed; every warp is past tile t-1
    issue(t + p.stages - 1);
    const uint32_t a_t =
        a_b + (uint32_t)((t % p.stages) * kRows * kStride
                         * (int)sizeof(__nv_bfloat16));
    float rs[kS][2];
    if (has_lo) warp_scores<KS, true>(a_t, qhi_b, qlo_b, ws, nt, t4, rs);
    else warp_scores<KS, false>(a_t, qhi_b, qlo_b, ws, nt, t4, rs);
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = rs[s][h];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        x = __shfl_sync(0xffffffffu, x, w_src);
        if (w_s == s && w_h == h) v = x;
      }
    const int row = row0 + t * kRows + warp * 16 * kS + lane;
    if (lane < 16 * kS && row < p.S) ob[row] = v;
  }
}

using KernelFn = void (*)(const Params);

const KernelFn kKernels[kMaxKSteps] = {
    indexer_kernel<1>,  indexer_kernel<2>,  indexer_kernel<3>,
    indexer_kernel<4>,  indexer_kernel<5>,  indexer_kernel<6>,
    indexer_kernel<7>,  indexer_kernel<8>,  indexer_kernel<9>,
    indexer_kernel<10>, indexer_kernel<11>, indexer_kernel<12>,
    indexer_kernel<13>, indexer_kernel<14>, indexer_kernel<15>,
    indexer_kernel<16>};
int g_granted[kMaxKSteps] = {};      // dynamic shared memory allowed so far

// The kernel for H heads of di dims: the deepest ring (at most 4 stages)
// at which two blocks still share an SM of the current card, else the
// deepest that fits one block (2 stages fit an H100: di <= 256, H <= 128).
struct Launch {
  KernelFn fn;
  int ks, hp, stages;
  size_t smem;
};

cudaError_t pick(int H, int di, Launch* k) {
  if (di < 16 || di % 16 || di > 16 * kMaxKSteps || H < 1 || H > kMaxHeads)
    return cudaErrorInvalidValue;
  int dev, per_sm, per_block, reserved;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  k->ks = di / 16;
  k->hp = (H + 15) / 16 * 16;
  k->stages = 0;
  for (int s = 4; s >= 2 && !k->stages; --s)
    if (2 * (smem_bytes(k->ks, k->hp, s) + reserved) <= (size_t)per_sm)
      k->stages = s;
  for (int s = 4; s >= 2 && !k->stages; --s)
    if (smem_bytes(k->ks, k->hp, s) <= (size_t)per_block) k->stages = s;
  if (!k->stages) return cudaErrorInvalidValue;
  k->smem = smem_bytes(k->ks, k->hp, k->stages);
  k->fn = kKernels[k->ks - 1];
  int& granted = g_granted[k->ks - 1];
  if ((int)k->smem <= granted) return cudaSuccess;
  err = cudaFuncSetAttribute((const void*)k->fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)k->smem);
  if (err == cudaSuccess) granted = (int)k->smem;
  return err;
}

}  // namespace

// Blocks of the kernel for H heads of di dims that one SM holds at once,
// from the occupancy calculator, into *blocks, and the rows of its key
// tile into *rows: what the host's plan fills.  cudaErrorInvalidValue for
// a shape the kernel does not take: di a multiple of 16 in [16, 256], H in
// [1, 128].
SAC_API int sac_indexer_blocks_per_sm(int H, int di, int* blocks,
                                      int* rows) {
  Launch k;
  cudaError_t err = pick(H, di, &k);
  if (err != cudaSuccess) return (int)err;
  *rows = tile_rows(k.ks);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, (const void*)k.fn, kThreads, k.smem);
}

// q: [B, H, di] f32; w: [B, H] f32; keys: [B, S, di] bf16 -> out [B, S]
// f32.  A block takes `chunk` tiles of one request.  The wrapper checks
// 16-byte alignment of q and keys; a shape pick refuses returns
// cudaErrorInvalidValue.
SAC_API int sac_indexer_scores(const void* q, const void* w, const void* keys,
                               void* out, int B, int S, int H, int di,
                               int chunk, float inv_sqrt_di, void* stream) {
  Launch k;
  cudaError_t err = pick(H, di, &k);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0) return 0;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = (const float*)q;
  p.w = (const float*)w;
  p.keys = (const __nv_bfloat16*)keys;
  p.out = (float*)out;
  p.S = S;
  p.H = H;
  p.hp = k.hp;
  p.chunk = chunk;
  p.stages = k.stages;
  p.inv_sqrt_di = inv_sqrt_di;
  const int n_tiles = (S + tile_rows(k.ks) - 1) / tile_rows(k.ks);
  void* args[] = {&p};
  err = cudaLaunchKernel((const void*)k.fn,
                         dim3((n_tiles + chunk - 1) / chunk, B),
                         dim3(kThreads), args, k.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
