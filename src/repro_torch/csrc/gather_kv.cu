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
