// Batched segment sum: out[b, s, c] = sum over rows n with idx[b, n] == s
// of data[b, n, c]; rows whose idx lies outside [0, M) contribute nothing
// (the JAX package routes invalid rows out with idx >= M; -1 is handled
// the same way).
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:segment_sum_fused
// (_segment_sum_fused_impl, pallas_call at :240; a one-hot matmul per
// point tile on the TPU, the tiles summed in order on a sequential grid).
// On the training path it is the backward of the row gather
// (pallas_kernels.py:505-509): the node tables' gradients from the 40960
// point rows (40960 -> 1280) and from the knn neighbourhoods
// (1280 x 16 -> 1280), and the proxies' from the nodes (1280 -> 256).
//
// Bound on the H100: memory. At 8 x 40960 x 64 -> 1280 the function must
// read the data (84 MB) and the ids (1.3 MB) and write the [8, 1280, 64]
// output (2.6 MB). Design: sorted segments, in two launches, every output
// element written once and every segment's rows added in ascending row
// order, in pieces fixed by the ids alone, as the TPU kernel adds them in
// tiles: the bits are the same on every run and no zeroing pass or global
// atomic is needed.
//   1. segment_bucket_kernel, a block per (chunk of 2048 rows, sample):
//      buckets the chunk's ids stably in shared memory (bucket.cuh) and
//      writes the chunk's rows in segment order (16-bit, chunk-local) and,
//      per segment, where its run starts in them and how long it is. A run
//      of max(8, 64 / chunks) rows or more is added here (the geo step's
//      points put up to 1955 rows on one node, 32 on average, so that a
//      few segments hold tens of each chunk's rows): each of the block's
//      16 warps takes 128 of the chunk's sorted places and adds the part
//      of each such run that lies in them, in order, into a partial row,
//      8 row loads in flight across the parts.
//   2. segment_reduce_kernel, a warp per (sample, segment): reads its runs
//      in chunk order (one per lane) and turns them into the segment's
//      list of rows and partials, 32 at a time, one per lane, then adds
//      them in that order in registers, 8 loads in flight (a row is F
//      consecutive floats: 32 lanes read 128 bytes of it at a time), and
//      writes the output row once; an empty segment writes zeros.
// Scratch (the wrapper allocates it, cmr_segment_sum_scratch_bytes): the
// partials [B, chunks, 16 x 18, F] f32, the runs [B, chunks, M] int32 and
// the sorted rows [B, chunks * 2048] uint16. Takes M <= 65535 and refuses
// an M whose offsets do not fit in a block's shared memory (about 56000).

#include "bucket.cuh"

namespace {

constexpr int kChunk = 2048;         // rows bucketed by one block
constexpr int kThreads = 512;        // bucket block
constexpr int kWarps = kThreads / 32;
constexpr int kRange = kChunk / kWarps;  // sorted places per warp
constexpr int kLongRun = 8;          // the shortest run added in buckets
constexpr int kSlots = 18;           // partials per range: 2 + 126 / 8
constexpr int kReduceWarps = 8;      // segments per reduce block
constexpr int kRowsInFlight = 8;
constexpr int kSmemLimit = 232448;   // a block's opt-in shared memory

// The shortest run the bucket kernel adds: one whose segment may hold 64
// rows or more over the sample's chunks, and at least kLongRun.
__device__ inline int long_run_rows(int chunks) {
  return max(kLongRun, 64 / chunks);
}

// A run's entry: its length, where it starts in the chunk's sorted rows,
// and for a long run the slot of its first partial in its first range.
__device__ inline int pack_run(int count, int start, int slot) {
  return count | (start << 12) | (slot << 24);
}

size_t bucket_smem_bytes(int M) {
  return (size_t)(M + 1 + 32 + 1) * sizeof(int) +
         3 * kChunk * sizeof(uint16_t);
}

// G = ceil(F / 32) channel groups per pass, at most 4 (128 channels).
template <int G>
__global__ void __launch_bounds__(kThreads)
segment_bucket_kernel(const float* __restrict__ data,
                      const int* __restrict__ idx, uint16_t* __restrict__ rows,
                      int* __restrict__ runs, float* __restrict__ partials,
                      int N, int M, int F, int chunks) {
  const unsigned full = 0xffffffffu;
  extern __shared__ int smem[];
  int* off = smem;                                       // M + 1
  int* scratch = off + M + 1;                            // 32
  int* n_long = scratch + 32;                            // 1: any long run
  uint16_t* key = reinterpret_cast<uint16_t*>(n_long + 1);
  uint16_t* list = key + kChunk;                         // kChunk
  uint16_t* sorted = list + kChunk;                      // kChunk
  const int c = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = c * kChunk;
  const int n = min(kChunk, N - first);
  const int* ids = idx + (size_t)b * N + first;
  for (int i = tid; i < n; i += kThreads) {
    const int s = ids[i];
    key[i] = (s >= 0 && s < M) ? (uint16_t)s : kRoutedOut;
  }
  if (tid == 0) *n_long = 0;
  __syncthreads();
  stable_bucket(key, n, M, off, list, sorted, scratch);
  __syncthreads();
  const size_t chunk = (size_t)b * chunks + c;
  int* chunk_runs = runs + chunk * M;
  const int long_run = long_run_rows(chunks);
  for (int q = tid; q < M; q += kThreads) {
    const int count = off[q + 1] - off[q];
    if (count >= long_run) {
      *n_long = 1;  // its entry comes with its slot, below
    } else {
      chunk_runs[q] = pack_run(count, off[q], 0);
    }
  }
  const int kept = off[M];
  for (int j = tid; j < kept; j += kThreads) {
    rows[chunk * kChunk + j] = sorted[j];
  }
  __syncthreads();
  if (*n_long == 0) return;
  // this warp's places: the parts of the long runs that lie in them, in
  // place order, each added in order into the range's next partial slot
  const int r_lo = warp * kRange, r_hi = min(kept, r_lo + kRange);
  const float* table = data + ((size_t)b * N + first) * F;
  float* range_partials = partials + (chunk * kWarps + warp) * kSlots * F;
  for (int c0 = 0; c0 < F; c0 += 32 * G) {
    float acc[G];
    int cur = -1, slot = -1;  // the same in every lane
    auto flush = [&]() {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int ch = c0 + g * 32 + lane;
        if (ch < F) range_partials[slot * F + ch] = acc[g];
      }
    };
    for (int p0 = r_lo; p0 < r_hi; p0 += 32) {
      const int p = p0 + lane;
      int row = 0, q = 0;
      bool in_long = false;
      if (p < r_hi) {
        row = sorted[p];
        q = key[row];
        in_long = off[q + 1] - off[q] >= long_run;
      }
      unsigned todo = __ballot_sync(full, in_long);
      while (todo != 0u) {
        float v[kRowsInFlight][G];
        int q_of[kRowsInFlight];
        bool has[kRowsInFlight];
#pragma unroll
        for (int i = 0; i < kRowsInFlight; ++i) {
          has[i] = todo != 0u;
          const int l = has[i] ? __ffs(todo) - 1 : 0;
          todo &= todo - 1u;
          const int r = __shfl_sync(full, row, l);
          q_of[i] = __shfl_sync(full, q, l);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int ch = c0 + g * 32 + lane;
            v[i][g] = (has[i] && ch < F) ? __ldg(&table[(size_t)r * F + ch])
                                         : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsInFlight; ++i) {
          if (!has[i]) continue;
          if (q_of[i] != cur) {
            if (cur >= 0) flush();
            cur = q_of[i];
            ++slot;
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g] = 0.f;
            const int s = off[cur];
            if (c0 == 0 && s >= r_lo && lane == 0) {
              chunk_runs[cur] = pack_run(off[cur + 1] - s, s, slot);
            }
          }
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] += v[i][g];
        }
      }
    }
    if (cur >= 0) flush();
  }
}

template <int G>
__global__ void __launch_bounds__(kReduceWarps * 32)
segment_reduce_kernel(const float* __restrict__ data,
                      const uint16_t* __restrict__ rows,
                      const int* __restrict__ runs,
                      const float* __restrict__ partials,
                      float* __restrict__ out, int B, int N, int M, int F,
                      int chunks) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long seg =
      (long long)blockIdx.x * kReduceWarps + (threadIdx.x >> 5);  // b*M + s
  if (seg >= (long long)B * M) return;
  const int b = (int)(seg / M), s = (int)(seg % M);
  const float* table = data + (size_t)b * N * F;
  const float* sample_partials =
      partials + (size_t)b * chunks * kWarps * kSlots * F;
  const int* seg_runs = runs + (size_t)b * chunks * M + s;
  const uint16_t* sample_rows = rows + (size_t)b * chunks * kChunk;
  float* dst = out + (size_t)seg * F;
  const int long_run = long_run_rows(chunks);
  for (int c0 = 0; c0 < F; c0 += 32 * G) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    for (int k0 = 0; k0 < chunks; k0 += 32) {
      // this lane's chunk: its run of the segment, as rows or (a long
      // run) one partial per range it meets, and where they begin in the
      // segment's list
      const int k = k0 + lane;
      const int run = k < chunks ? seg_runs[(size_t)k * M] : 0;
      const int cnt = run & 0xFFF, start = (run >> 12) & 0xFFF;
      const bool is_long = cnt >= long_run;
      const int items =
          is_long ? (start + cnt - 1) / kRange - start / kRange + 1 : cnt;
      int incl = items;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(full, incl, d);
        if (lane >= d) incl += t;
      }
      const int base = incl - items;
      const int total = __shfl_sync(full, incl, 31);
      for (int j0 = 0; j0 < total; j0 += 32) {
        // item j of the list lies in the run of the last lane whose base
        // is <= j (bases never decrease)
        const int j = j0 + lane;
        int l = 0;
        for (int step = 16; step > 0; step >>= 1) {
          if (__shfl_sync(full, base, l + step) <= j) l += step;
        }
        const int l_run = __shfl_sync(full, run, l);
        const int l_base = __shfl_sync(full, base, l);
        // >= 0: a row of the table; < 0: -1 - a partial of the sample
        int ref = 0;
        if (j < total) {
          const int chunk = k0 + l, t = j - l_base;
          const int l_cnt = l_run & 0xFFF, l_start = (l_run >> 12) & 0xFFF;
          if (l_cnt >= long_run) {
            const int range = l_start / kRange + t;
            const int slot = t == 0 ? (l_run >> 24) : 0;
            ref = -1 - ((chunk * kWarps + range) * kSlots + slot);
          } else {
            ref = chunk * kChunk +
                  sample_rows[(size_t)chunk * kChunk + l_start + t];
          }
        }
        const int n_items = min(32, total - j0);
        for (int i0 = 0; i0 < n_items; i0 += kRowsInFlight) {
          float v[kRowsInFlight][G];
#pragma unroll
          for (int i = 0; i < kRowsInFlight; ++i) {
            const int r = __shfl_sync(full, ref, i0 + i);
            const float* src = r >= 0 ? table + (size_t)r * F
                                      : sample_partials + (size_t)(-1 - r) * F;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int ch = c0 + g * 32 + lane;
              v[i][g] = (i0 + i < n_items && ch < F) ? __ldg(&src[ch]) : 0.f;
            }
          }
#pragma unroll
          for (int i = 0; i < kRowsInFlight; ++i) {
            if (i0 + i < n_items) {
#pragma unroll
              for (int g = 0; g < G; ++g) acc[g] += v[i][g];
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int ch = c0 + g * 32 + lane;
      if (ch < F) dst[ch] = acc[g];
    }
  }
}

int chunks_of(int N) { return (N + kChunk - 1) / kChunk; }

template <int G>
int launch(const float* data, const int* idx, float* partials, int* runs,
           uint16_t* rows, float* out, int B, int N, int M, int F,
           int chunks, size_t smem, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_bucket_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  segment_bucket_kernel<G><<<dim3(chunks, B), kThreads, smem, st>>>(
      data, idx, rows, runs, partials, N, M, F, chunks);
  CMR_RETURN_IF_ERROR();
  const long long warps = (long long)B * M;
  const long long blocks = (warps + kReduceWarps - 1) / kReduceWarps;
  if (blocks > 2147483647LL) return CMR_ERR_ARGUMENT;
  segment_reduce_kernel<G><<<(unsigned int)blocks, kReduceWarps * 32, 0, st>>>(
      data, rows, runs, partials, out, B, N, M, F, chunks);
  CMR_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// Bytes of scratch cmr_segment_sum needs: the partials, the runs, then the
// sorted rows.
CMR_EXPORT long long cmr_segment_sum_scratch_bytes(int B, int N, int M,
                                                   int F) {
  const long long maps = (long long)B * chunks_of(N);
  return maps * ((long long)kWarps * kSlots * F * sizeof(float) +
                 (long long)M * sizeof(int) + kChunk * sizeof(uint16_t));
}

// data [B, N, F] f32; idx [B, N] int32; scratch of
// cmr_segment_sum_scratch_bytes(B, N, M, F) bytes, 4-byte aligned; out
// [B, M, F] f32, every element written here. Returns a cudaError_t, -1 for
// M > 65535 and -2 for offsets beyond a block's shared memory.
CMR_EXPORT int cmr_segment_sum(const float* data, const int* idx,
                               void* scratch, float* out, int B, int N, int M,
                               int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > kMaxBucketSegments) return CMR_ERR_ARGUMENT;
  if (B == 0 || M == 0 || F == 0) return 0;
  const int chunks = chunks_of(N);
  if (chunks == 0) {  // no rows: every sum is zero
    return (int)cudaMemsetAsync(out, 0, (size_t)B * M * F * sizeof(float),
                                st);
  }
  const size_t smem = bucket_smem_bytes(M);
  if (smem > (size_t)kSmemLimit) return CMR_ERR_SHARED_MEMORY;
  const size_t maps = (size_t)B * chunks;
  float* partials = static_cast<float*>(scratch);
  int* runs = reinterpret_cast<int*>(partials + maps * kWarps * kSlots * F);
  uint16_t* rows = reinterpret_cast<uint16_t*>(runs + maps * M);
  switch (min(4, (F + 31) / 32)) {
    case 1:
      return launch<1>(data, idx, partials, runs, rows, out, B, N, M, F,
                       chunks, smem, st);
    case 2:
      return launch<2>(data, idx, partials, runs, rows, out, B, N, M, F,
                       chunks, smem, st);
    case 3:
      return launch<3>(data, idx, partials, runs, rows, out, B, N, M, F,
                       chunks, smem, st);
    default:
      return launch<4>(data, idx, partials, runs, rows, out, B, N, M, F,
                       chunks, smem, st);
  }
}
