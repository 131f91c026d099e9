// Top-k sparse attention with an online softmax:
//   out[b, h] = softmax_j(scale * q[b, h] . K[b, j] + bias[b, j]) @ V[b]
// where K[b, j] = E[b, j, k_col : k_col + dq] and
//       V[b, j] = E[b, j, v_col : v_col + dv] are columns of one entry row.
//
// Replaces: src/repro/kernels/sparse_attn.py::sparse_attn (Pallas: a
// sequential grid over k blocks carrying the running max, sum and
// accumulator in VMEM scratch; it asserts k % block_k == 0).  The MLA form
// (ops.batched_sparse_mla) is k_col = v_col = 0, dq = dc + dr, dv = dc:
// the values are the first dc columns of the staged keys.  The GQA form
// is another wrapper over this same kernel (other column offsets).
//
// Bound on an H100: close to the ridge.  DeepSeek-V3.2 decode (B=4,
// H=128, k=2049, dq=576, dv=512) reads 9.4 MB of entries (2.8 us at
// 3.35 TB/s) and does 2.3 GFLOP (2.3 us on the bf16 tensor cores).
//
// Design: the TPU grid's sequential k axis becomes a loop inside one
// block.  A block owns one request and a group of 4 heads; it stages a
// tile of 64 entry rows in shared memory once for all its heads (rows
// padded by 8 bf16 so the 16-byte reads of eight lanes on eight rows hit
// distinct banks), computes the 4x64 scores (one dot product per
// thread), updates the running max and sum per head (one warp per head)
// and accumulates p @ V with each thread owning two value columns of all
// 4 heads.  Max, sum and accumulator are f32 and the division comes at
// the end, as in the reference.  The ragged end of k is masked (lanes
// past k score -inf and stage zeros), so k = topk + 1 needs no padding.
// This first version runs on the CUDA cores; a split-k pass and wgmma
// are the tuning steps.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTileK = 64;     // entry rows per tile
constexpr int kHeads = 4;      // heads per block
constexpr int kThreads = 256;  // = kTileK * kHeads: one score per thread
constexpr int kMaxPairs = 2;   // value column pairs per thread (dv <= 1024)
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
sparse_attn_kernel(const float* __restrict__ q,
                   const __nv_bfloat16* __restrict__ ent,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int k, int dq, int dv, int k_col, int v_col,
                   int st_col, int st_w, long long ent_batch,
                   long long ent_row, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks_stride = st_w + 8;                       // bf16 per row
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* qs = reinterpret_cast<float*>(ks + kTileK * ks_stride);  // [4][dq]
  float* ps = qs + kHeads * dq;                         // [kTileK][4]
  float* m_s = ps + kTileK * kHeads;                    // [4]
  float* l_s = m_s + kHeads;                            // [4]
  float* c_s = l_s + kHeads;                            // [4]

  const int b = blockIdx.y;
  const int h0 = blockIdx.x * kHeads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kHeads * dq; i += kThreads) {
    const int h = h0 + i / dq;
    qs[i] = h < H ? q[((long long)b * H + h) * dq + i % dq] : 0.f;
  }
  if (tid < kHeads) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kHeads][2 * kMaxPairs];
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int c = 0; c < 2 * kMaxPairs; ++c) acc[h][c] = 0.f;

  const __nv_bfloat16* eb = ent + (long long)b * ent_batch + st_col;
  const float* bb = bias + (long long)b * k;
  const int vec_per_row = st_w / 8;
  const int n_pairs = dv / 2;
  const int kc = k_col - st_col, vc = v_col - st_col;

  for (int j0 = 0; j0 < k; j0 += kTileK) {
    // stage the entry tile (zeros past k)
    for (int i = tid; i < kTileK * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row, c = i % vec_per_row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < k)
        v = *reinterpret_cast<const uint4*>(eb + (long long)(j0 + r) * ent_row
                                            + c * 8);
      *reinterpret_cast<uint4*>(ks + r * ks_stride + c * 8) = v;
    }
    __syncthreads();

    // scores: thread (h, j) = (tid / 64, tid % 64)
    {
      const int j = tid % kTileK, h = tid / kTileK;
      float s = -INFINITY;
      if (j0 + j < k) {
        const __nv_bfloat16* kr = ks + j * ks_stride + kc;
        const float* qr = qs + h * dq;
        float a = 0.f;
        for (int d = 0; d < dq; d += 8) {
          uint4 v = *reinterpret_cast<const uint4*>(kr + d);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&v);
          float4 qa = *reinterpret_cast<const float4*>(qr + d);
          float4 qb = *reinterpret_cast<const float4*>(qr + d + 4);
          float2 f0 = __bfloat1622float2(k2[0]);
          float2 f1 = __bfloat1622float2(k2[1]);
          float2 f2 = __bfloat1622float2(k2[2]);
          float2 f3 = __bfloat1622float2(k2[3]);
          a = fmaf(qa.x, f0.x, a); a = fmaf(qa.y, f0.y, a);
          a = fmaf(qa.z, f1.x, a); a = fmaf(qa.w, f1.y, a);
          a = fmaf(qb.x, f2.x, a); a = fmaf(qb.y, f2.y, a);
          a = fmaf(qb.z, f3.x, a); a = fmaf(qb.w, f3.y, a);
        }
        s = a * scale + bb[j0 + j];
      }
      ps[j * kHeads + h] = s;
    }
    __syncthreads();

    // running max / sum: one warp per head
    if (warp < kHeads) {
      const int h = warp;
      const float s0 = ps[lane * kHeads + h];
      const float s1 = ps[(lane + 32) * kHeads + h];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[lane * kHeads + h] = p0;
      ps[(lane + 32) * kHeads + h] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = __expf(m_prev - m_new);
        c_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V: thread owns value pairs tid, tid + 256
    {
      float corr[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) corr[h] = c_s[h];
#pragma unroll
      for (int h = 0; h < kHeads; ++h)
#pragma unroll
        for (int c = 0; c < 2 * kMaxPairs; ++c) acc[h][c] *= corr[h];
      const int jn = min(kTileK, k - j0);
      for (int j = 0; j < jn; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(ps + j * kHeads);
        const __nv_bfloat16* vr = ks + j * ks_stride + vc;
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i) {
          const int pr = tid + i * kThreads;
          if (pr < n_pairs) {
            float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(vr + 2 * pr));
            acc[0][2 * i] = fmaf(p.x, v.x, acc[0][2 * i]);
            acc[0][2 * i + 1] = fmaf(p.x, v.y, acc[0][2 * i + 1]);
            acc[1][2 * i] = fmaf(p.y, v.x, acc[1][2 * i]);
            acc[1][2 * i + 1] = fmaf(p.y, v.y, acc[1][2 * i + 1]);
            acc[2][2 * i] = fmaf(p.z, v.x, acc[2][2 * i]);
            acc[2][2 * i + 1] = fmaf(p.z, v.y, acc[2][2 * i + 1]);
            acc[3][2 * i] = fmaf(p.w, v.x, acc[3][2 * i]);
            acc[3][2 * i + 1] = fmaf(p.w, v.y, acc[3][2 * i + 1]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    if (h0 + h >= H) break;
    const float inv = 1.f / fmaxf(l_s[h], 1e-30f);
    float* o = out + ((long long)b * H + h0 + h) * dv;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int pr = tid + i * kThreads;
      if (pr < n_pairs) {
        o[2 * pr] = acc[h][2 * i] * inv;
        o[2 * pr + 1] = acc[h][2 * i + 1] * inv;
      }
    }
  }
}

}  // namespace

// q: [B, H, dq] f32; ent: entry rows of bf16 (batch stride ent_batch and
// row stride ent_row, in elements); bias: [B, k] f32 (0 or -1e30);
// out: [B, H, dv] f32.  The wrapper checks that st_col, st_w, dq, the
// strides and the base address keep every 16-byte access aligned, that
// [k_col, k_col + dq) and [v_col, v_col + dv) lie inside the staged
// columns [st_col, st_col + st_w), and that dv <= 1024 is even.
SAC_API int sac_sparse_attn(const void* q, const void* ent, const void* bias,
                            void* out, int B, int H, int k, int dq, int dv,
                            int k_col, int v_col, int st_col, int st_w,
                            long long ent_batch, long long ent_row,
                            float scale, void* stream) {
  size_t smem = sizeof(__nv_bfloat16) * (size_t)kTileK * (st_w + 8)
                + sizeof(float) * ((size_t)kHeads * dq + kTileK * kHeads
                                   + 3 * kHeads);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0 && k > 0) {
    dim3 grid((H + kHeads - 1) / kHeads, B);
    sparse_attn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const __nv_bfloat16*)ent, (const float*)bias,
        (float*)out, H, k, dq, dv, k_col, v_col, st_col, st_w, ent_batch,
        ent_row, scale);
  }
  return (int)cudaGetLastError();
}
