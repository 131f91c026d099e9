// Sparse KV row gather: out[b, i] = kv[b, idx[b, i]].
//
// Replaces: src/repro/kernels/gather_kv.py::gather_kv (Pallas: the top-k
// indices are scalar-prefetched and drive one DMA per row).
//
// Bound on an H100: bytes.  It moves k rows in and k rows out and does
// no arithmetic (DeepSeek-V3.2 decode: B=4, k=2048, 1152-byte rows,
// 18.9 MB, about 5.6 us at 3.35 TB/s).
//
// Design: Hopper has no scalar prefetch, so each warp reads its own row
// index and copies one row with 16-byte vector loads and stores, lane i
// taking every 32nd vector: neighbouring lanes touch neighbouring
// addresses, so each warp instruction moves 512 contiguous bytes.  The
// batch is the leading part of the flat warp index (no Python loop).
// Indices are clamped into [0, S) so a stray index cannot fault.
#include "common.cuh"

namespace {

template <typename V>
__global__ void gather_rows(const char* __restrict__ kv,
                            const int32_t* __restrict__ idx,
                            char* __restrict__ out, long long S,
                            long long k, long long n_rows,
                            long long row_bytes) {
  long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  long long b = row / k;
  long long r = idx[row];
  r = r < 0 ? 0 : (r >= S ? S - 1 : r);
  const V* src = reinterpret_cast<const V*>(kv + (b * S + r) * row_bytes);
  V* dst = reinterpret_cast<V*>(out + row * row_bytes);
  long long n = row_bytes / (long long)sizeof(V);
  for (long long i = lane; i < n; i += 32) dst[i] = src[i];
}

template <typename V>
void launch(const void* kv, const void* idx, void* out, long long S,
            long long k, long long n_rows, long long row_bytes,
            cudaStream_t stream) {
  const int threads = 256;                       // 8 rows per block
  long long blocks = (n_rows * 32 + threads - 1) / threads;
  gather_rows<V><<<(unsigned)blocks, threads, 0, stream>>>(
      (const char*)kv, (const int32_t*)idx, (char*)out, S, k, n_rows,
      row_bytes);
}

}  // namespace

// kv: [B, S, row_bytes] bytes; idx: [B, k] int32; out: [B, k, row_bytes].
SAC_API int sac_gather_kv(const void* kv, const void* idx, void* out,
                          long long B, long long S, long long k,
                          long long row_bytes, void* stream) {
  long long n_rows = B * k;
  if (n_rows > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (sac_vec_bytes(row_bytes, kv, out)) {
      case 16: launch<uint4>(kv, idx, out, S, k, n_rows, row_bytes, st); break;
      case 8: launch<uint2>(kv, idx, out, S, k, n_rows, row_bytes, st); break;
      case 4: launch<uint32_t>(kv, idx, out, S, k, n_rows, row_bytes, st); break;
      case 2: launch<uint16_t>(kv, idx, out, S, k, n_rows, row_bytes, st); break;
      default: launch<uint8_t>(kv, idx, out, S, k, n_rows, row_bytes, st);
    }
  }
  return (int)cudaGetLastError();
}

SAC_API const char* sac_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
