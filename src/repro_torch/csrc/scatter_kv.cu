// In-place KV row scatter: pool[b, idx[b, i]] = entries[b, i].
//
// Replaces: src/repro/kernels/scatter_kv.py::scatter_kv (Pallas: the
// destination indices drive the output BlockSpec of an input/output
// aliased pool, one DMA per row).
//
// Bound on an H100: launch latency.  A decode step writes L*B rows
// (23 KB at DeepSeek-V3.2 width, two layers, four slots), far below a
// microsecond of memory traffic; a prefill splice writes L*S rows.
//
// Design: the pool tensor is written in place (no copy of the pool), one
// warp per row with 16-byte vector stores, the warp reading its own
// destination index.  Rows are distinct by contract, so no two warps
// write the same bytes and the result is independent of block order.
// An index outside [0, S) is skipped.
#include "common.cuh"

namespace {

template <typename V>
__global__ void scatter_rows(char* __restrict__ pool,
                             const char* __restrict__ entries,
                             const int32_t* __restrict__ idx, long long S,
                             long long k, long long n_rows,
                             long long row_bytes) {
  long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  long long b = row / k;
  long long r = idx[row];
  if (r < 0 || r >= S) return;
  const V* src = reinterpret_cast<const V*>(entries + row * row_bytes);
  V* dst = reinterpret_cast<V*>(pool + (b * S + r) * row_bytes);
  long long n = row_bytes / (long long)sizeof(V);
  for (long long i = lane; i < n; i += 32) dst[i] = src[i];
}

template <typename V>
void launch(void* pool, const void* entries, const void* idx, long long S,
            long long k, long long n_rows, long long row_bytes,
            cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n_rows * 32 + threads - 1) / threads;
  scatter_rows<V><<<(unsigned)blocks, threads, 0, stream>>>(
      (char*)pool, (const char*)entries, (const int32_t*)idx, S, k, n_rows,
      row_bytes);
}

}  // namespace

// pool: [B, S, row_bytes]; entries: [B, k, row_bytes]; idx: [B, k] int32.
SAC_API int sac_scatter_kv(void* pool, const void* entries, const void* idx,
                           long long B, long long S, long long k,
                           long long row_bytes, void* stream) {
  long long n_rows = B * k;
  if (n_rows > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (sac_vec_bytes(row_bytes, pool, entries)) {
      case 16: launch<uint4>(pool, entries, idx, S, k, n_rows, row_bytes, st); break;
      case 8: launch<uint2>(pool, entries, idx, S, k, n_rows, row_bytes, st); break;
      case 4: launch<uint32_t>(pool, entries, idx, S, k, n_rows, row_bytes, st); break;
      case 2: launch<uint16_t>(pool, entries, idx, S, k, n_rows, row_bytes, st); break;
      default: launch<uint8_t>(pool, entries, idx, S, k, n_rows, row_bytes, st);
    }
  }
  return (int)cudaGetLastError();
}
