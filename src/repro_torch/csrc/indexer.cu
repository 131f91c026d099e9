// Lightning-indexer scoring:
//   out[b, s] = sum_h w[b, h] * ReLU(q[b, h] . keys[b, s]) / sqrt(di)
//
// Replaces: src/repro/kernels/indexer.py::indexer_scores (Pallas: a grid
// over S blocks, a [block_s, di] x [di, H] MXU matmul, ReLU and a
// weighted reduction over heads; it asserts S % block_s == 0).
//
// Bound on an H100: bytes.  The keys are read once (DeepSeek-V3.2: B=4,
// S=4160, di=128 bf16, 4.3 MB, about 1.3 us at 3.35 TB/s); the
// 2*B*S*H*di = 0.27 GFLOP would take 0.3 us on the bf16 tensor cores.
//
// Design: one block per (request, tile of 64 positions).  q [H, di] and
// w [H] of the request sit in shared memory (q rows padded by 4 floats so
// the 16-byte reads of eight lanes with different heads hit distinct
// banks), and the key tile is staged there once, converted to f32.  A
// thread owns one (head, 8-position) work item: it holds 32 dims of its
// q row in registers while it streams the 8 key rows (broadcast reads),
// so each shared-memory read feeds several FMAs.  Sums are f32; the
// ragged tail of S is masked, so any S works.  This first version runs
// on the CUDA cores; wgmma is the tuning step.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;     // positions per block
constexpr int kRows = 8;      // positions per work item
constexpr int kChunk = 32;    // dims of q held in registers
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
indexer_kernel(const float* __restrict__ q, const float* __restrict__ w,
               const __nv_bfloat16* __restrict__ keys,
               float* __restrict__ out, int S, int H, int di,
               float inv_sqrt_di) {
  extern __shared__ __align__(16) float smem[];
  const int qstride = di + 4;
  float* qs = smem;                         // [H][di + 4]
  float* ks = qs + H * qstride;             // [kTile][di]
  float* part = ks + kTile * di;            // [H][kTile + 1]
  float* ws = part + H * (kTile + 1);       // [H]

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kTile;
  const int rows = min(kTile, S - s0);
  const float* qb = q + (long long)b * H * di;
  for (int i = threadIdx.x; i < H * di; i += blockDim.x)
    qs[(i / di) * qstride + i % di] = qb[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x)
    ws[i] = w[(long long)b * H + i];
  // key tile: 8 bf16 per 16-byte load, zero rows past the end of S
  const uint4* kb = reinterpret_cast<const uint4*>(
      keys + ((long long)b * S + s0) * di);
  const int vec_per_row = di / 8;
  for (int i = threadIdx.x; i < kTile * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row;
    float* dst = ks + i * 8;
    if (r < rows) {
      uint4 v = kb[i];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h2[j]);
        dst[2 * j] = f.x;
        dst[2 * j + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = 0.f;
    }
  }
  __syncthreads();

  const int n_items = H * (kTile / kRows);
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int h = item % H;
    const int r0 = (item / H) * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const float* qr = qs + h * qstride;
    for (int d0 = 0; d0 < di; d0 += kChunk) {
      float qv[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; j += 4) {
        float4 t = *reinterpret_cast<const float4*>(qr + d0 + j);
        qv[j] = t.x; qv[j + 1] = t.y; qv[j + 2] = t.z; qv[j + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* kr = ks + (r0 + r) * di + d0;
        float a = acc[r];
#pragma unroll
        for (int j = 0; j < kChunk; j += 4) {
          float4 t = *reinterpret_cast<const float4*>(kr + j);
          a = fmaf(qv[j], t.x, a);
          a = fmaf(qv[j + 1], t.y, a);
          a = fmaf(qv[j + 2], t.z, a);
          a = fmaf(qv[j + 3], t.w, a);
        }
        acc[r] = a;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      part[h * (kTile + 1) + r0 + r] = fmaxf(acc[r], 0.f) * inv_sqrt_di;
  }
  __syncthreads();

  // weighted reduction over heads, one thread per position, fixed order
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float s = 0.f;
    for (int h = 0; h < H; ++h) s = fmaf(part[h * (kTile + 1) + r], ws[h], s);
    out[(long long)b * S + s0 + r] = s;
  }
}

}  // namespace

// q: [B, H, di] f32; w: [B, H] f32; keys: [B, S, di] bf16 -> out [B, S] f32.
// di must be a multiple of 32 (the wrapper checks).
SAC_API int sac_indexer_scores(const void* q, const void* w, const void* keys,
                               void* out, int B, int S, int H, int di,
                               float inv_sqrt_di, void* stream) {
  size_t smem = sizeof(float) * ((size_t)H * (di + 4) + (size_t)kTile * di
                                 + (size_t)H * (kTile + 1) + H);
  cudaError_t err = cudaFuncSetAttribute(
      indexer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && S > 0) {
    dim3 grid((S + kTile - 1) / kTile, B);
    indexer_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)w, (const __nv_bfloat16*)keys,
        (float*)out, S, H, di, inv_sqrt_di);
  }
  return (int)cudaGetLastError();
}
