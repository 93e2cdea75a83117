// Batched row gather: out[b, n, :] = table[b, idx[b, n], :], and a zero row
// where idx[b, n] lies outside [0, M).
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:gather_rows_fused (a
// one-hot matmul on the TPU, chosen there because the TPU's row gather was
// slow). On Hopper a gather is a byte copy, so the kernel is type-agnostic:
// each thread moves one chunk of a row, 16 bytes when the row width and
// both pointers allow it, else 4 or 2 bytes. Neighbouring threads move
// neighbouring chunks of one row, so a warp reads and writes contiguous
// memory and the table (at most 2048 rows, 512 KB per sample at F=64 f32)
// is served from L2.
//
// Bound on the H100: memory. For [8, 1280, 64] -> [8, 40960, 64] f32 the
// function must read the idx and table (3 MB) and write the 84 MB output.
// Exact: no arithmetic touches the values.

#include "common.cuh"

namespace {

template <typename Chunk>
__global__ void gather_rows_kernel(const Chunk* __restrict__ table,
                                   const int* __restrict__ idx,
                                   Chunk* __restrict__ out, int N, int M,
                                   int chunks_per_row, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ch = (int)(i % chunks_per_row);
  const long long row = i / chunks_per_row;  // b * N + n
  const int b = (int)(row / N);
  const int s = idx[row];
  Chunk v{};
  if (s >= 0 && s < M) {
    v = table[((size_t)b * M + s) * chunks_per_row + ch];
  }
  out[i] = v;
}

template <typename Chunk>
int launch(const void* table, const int* idx, void* out, int B, int N, int M,
           int row_bytes, cudaStream_t st) {
  const int chunks_per_row = row_bytes / (int)sizeof(Chunk);
  const long long total = (long long)B * N * chunks_per_row;
  const int threads = 256;
  gather_rows_kernel<Chunk><<<cmr_blocks(total, threads), threads, 0, st>>>(
      static_cast<const Chunk*>(table), idx, static_cast<Chunk*>(out), N, M,
      chunks_per_row, total);
  CMR_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// table [B, M, row_bytes], idx [B, N] int32, out [B, N, row_bytes].
// chunk_bytes is 16, 4 or 2 and divides row_bytes and both pointers'
// alignment (the wrapper checks). Returns a cudaError_t, or -1 for an
// unsupported chunk size.
CMR_EXPORT int cmr_gather_rows(const void* table, const int* idx, void* out,
                               int B, int N, int M, int row_bytes,
                               int chunk_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk_bytes) {
    case 16: return launch<uint4>(table, idx, out, B, N, M, row_bytes, st);
    case 4: return launch<uint32_t>(table, idx, out, B, N, M, row_bytes, st);
    case 2: return launch<uint16_t>(table, idx, out, B, N, M, row_bytes, st);
    default: return -1;
  }
}
