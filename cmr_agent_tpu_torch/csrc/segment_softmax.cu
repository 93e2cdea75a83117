// Segmented softmax-attend: out[b, s, c] = sum over rows n with
// idx[b, n] == s of softmax_s(attn[b, :, c])[n] * values[b, n, c], with the
// residuals of its backward, sums[b, s, c] = sum over the same rows of
// exp(attn[b, n, c] - gmax[b, c]) and gmax[b, c] = max over ALL N rows of
// attn[b, n, c]. Empty segments give 0; rows whose idx lies outside [0, M)
// contribute nothing.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:segment_softmax_attend_fused
// (_fused_forward, pallas_call at :95; the GroupPointTransformer group
// softmax, one-hot matmuls per point tile on the TPU, the tiles summed in
// order on a sequential grid). Like the TPU kernel, the softmax is shifted
// by the GLOBAL per-(b, c) max, not a per-segment one: the shift is
// constant within a segment, and a segment whose logits all lie far below
// its sample's max gives 0, as in the JAX package.
//
// Operands are read as given, f32 or bf16 (both tensors of one dtype), and
// widened in registers; widening is exact, so a bf16 call gives the bits
// of the f32 call on the widened tensors. Outputs are f32.
//
// Bound on the H100: memory. At the geo forward's 8 x 40960 x 64 -> 1280
// the function must read attn and values (168 MB in f32, 84 MB in bf16)
// and idx (1.3 MB) and write out and sums (5.2 MB). Design: sorted
// segments, as the segment sum (segment_sum.cu) adds them, in three
// launches, every output element written once and every segment's rows
// added in ascending row order, in pieces fixed by the ids alone: the same
// bits on every launch, no zeroing pass, no global atomics.
//   1. softmax_max_kernel, a block per (chunk of 2048 rows, sample): the
//      chunk's per-channel max of attn (16-byte loads, eight in flight a
//      thread) into chunk_max [B, chunks, F].
//   2. softmax_bucket_kernel, a block per (chunk, sample): the sample's max
//      from its chunks' maxima, in chunk order (the chunk-0 block writes
//      gmax); the chunk's ids bucketed stably in shared memory (bucket.cuh),
//      its rows written in segment order (16-bit, chunk-local) with each
//      segment's run (start, length); a run of max(8, 64 / chunks) rows or
//      more is added here, each of the block's 16 warps taking 128 of the
//      chunk's sorted places and adding the part of each such run that
//      lies in them, in order, into a partial (exp(a - gmax) and its
//      product with v), 8 rows' loads in flight (the geo forward's points
//      put up to 1955 rows on one node).
//   3. softmax_reduce_kernel, a warp per (sample, segment): reads its runs
//      in chunk order, turns them into the segment's list of rows and
//      partials, 32 at a time, and adds them in that order in registers,
//      in batches of up to 8 items of one kind (rows, or partials) whose
//      loads are in flight together, then writes sums and out = sum(e v) /
//      max(sum(e), 1e-30) once (an empty segment writes zeros).
// A lane holds a pair of adjacent channels where F is even and the rows
// start on a pair, so a row is one request of 32 lanes (256 bytes in f32,
// 128 in bf16): the reduce pass's row reads are random, and their count,
// more than their bytes, sets its time (bf16 rows read as two 64-byte
// halves took as long as f32's 256 bytes). Every channel's terms are added
// in the same order whatever the lanes hold and whatever the dtype, so a
// bf16 call gives the bits of the f32 call on the widened operands.
// The max needs all of a sample's rows before any exp, so it is a launch of
// its own and attn is read twice (252 MB in f32 where 168 MB is the
// bound). Folding the max into the bucketing launch would still need the
// long runs added in a third launch after it; a separate max pass keeps
// the bucketing launch as the segment sum's, with the exp added.
// Scratch (the wrapper allocates it, cmr_segment_softmax_scratch_bytes):
// chunk_max [B, chunks, F], the partials [B, chunks, 16 x 18, 2F] f32, the
// runs [B, chunks, M] int32 and the sorted rows [B, chunks * 2048] uint16.
// Takes M <= 65535 and refuses an M whose offsets do not fit in a block's
// shared memory (about 56000), before any launch.

#include <math.h>
#include <algorithm>

#include "bucket.cuh"

namespace {

constexpr int kChunk = 2048;         // rows bucketed by one block
constexpr int kThreads = 512;        // max and bucket blocks
constexpr int kWarps = kThreads / 32;
constexpr int kRange = kChunk / kWarps;  // sorted places per warp
constexpr int kLongRun = 8;          // the shortest run added in buckets
constexpr int kSlots = 18;           // partials per range: 2 + 126 / 8
constexpr int kReduceWarps = 8;      // segments per reduce block
constexpr int kRowsInFlight = 8;
constexpr int kMaxUnroll = 8;        // 16-byte loads in flight, max pass
constexpr int kSmemLimit = 232448;   // a block's opt-in shared memory

__device__ inline int long_run_rows(int chunks) {
  return max(kLongRun, 64 / chunks);
}

// A run's entry: its length, where it starts in the chunk's sorted rows,
// and for a long run the slot of its first partial in its first range.
__device__ inline int pack_run(int count, int start, int slot) {
  return count | (start << 12) | (slot << 24);
}

// L consecutive operands of a row (L = 2: a lane's channel pair, the
// address aligned to 2 operands) in one load, kept as loaded while further
// rows' loads are in flight, then widened to f32 by op (exact).
template <typename T, int L>
struct Vec;
template <>
struct Vec<float, 1> {
  using type = float;
};
template <>
struct Vec<float, 2> {
  using type = float2;
};
template <>
struct Vec<__nv_bfloat16, 1> {
  using type = __nv_bfloat16;
};
template <>
struct Vec<__nv_bfloat16, 2> {
  using type = __nv_bfloat162;
};

template <typename T, int L>
__device__ __forceinline__ typename Vec<T, L>::type load_vec(const T* p) {
  return __ldg(reinterpret_cast<const typename Vec<T, L>::type*>(p));
}
__device__ __forceinline__ float op(float v, int) { return v; }
__device__ __forceinline__ float op(float2 v, int t) { return t ? v.y : v.x; }
__device__ __forceinline__ float op(__nv_bfloat16 v, int) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float op(__nv_bfloat162 v, int t) {
  return t ? __high2float(v) : __low2float(v);
}

// One row's terms: e = exp(a - g) into se, e * v into sev.
__device__ __forceinline__ void add_term(float a, float v, float g, float& se,
                                         float& sev) {
  const float e = expf(a - g);
  se += e;
  sev = fmaf(e, v, sev);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
softmax_max_kernel(const T* __restrict__ attn, float* __restrict__ chunk_max,
                   int N, int F, int chunks) {
  extern __shared__ float red[];  // [rlanes * F]
  const int c = blockIdx.x, b = blockIdx.y;
  const int r0 = c * kChunk, r1 = min(N, r0 + kChunk);
  // thread = (row lane rl, vector column cv); a column's V maxima
  const int FV = F / V;
  const int rlanes = max(1, kThreads / FV);
  const int rl = threadIdx.x / FV;
  const T* src = attn + (size_t)b * N * F;
  if (rl < rlanes) {
    for (int cv = threadIdx.x % FV; cv < FV; cv += kThreads) {
      float m[V];
#pragma unroll
      for (int e = 0; e < V; ++e) m[e] = -INFINITY;
      for (int j0 = r0 + rl; j0 < r1; j0 += rlanes * kMaxUnroll) {
        uint4 raw[kMaxUnroll];
#pragma unroll
        for (int u = 0; u < kMaxUnroll; ++u) {
          const int j = j0 + u * rlanes;
          if (j < r1) raw[u] = load_raw<T, V>(src + (size_t)j * F + cv * V);
        }
#pragma unroll
        for (int u = 0; u < kMaxUnroll; ++u) {
          if (j0 + u * rlanes < r1) {
            float v[V];
            unpack_raw<T, V>(raw[u], v);
#pragma unroll
            for (int e = 0; e < V; ++e) m[e] = fmaxf(m[e], v[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) red[rl * F + cv * V + e] = m[e];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < F; ch += kThreads) {
    float m = -INFINITY;
    for (int r = 0; r < rlanes; ++r) m = fmaxf(m, red[r * F + ch]);
    chunk_max[((size_t)b * chunks + c) * F + ch] = m;
  }
}

size_t max_smem_bytes(int F, int V) {
  return (size_t)std::max(1, kThreads / (F / V)) * F * sizeof(float);
}

size_t bucket_smem_bytes(int M, int F) {
  return (size_t)(M + 1 + 32 + 1 + F) * sizeof(int) +
         3 * kChunk * sizeof(uint16_t);
}

// A lane holds L channels (2: a pair, when F is even and the rows aligned)
// in each of G groups of 32 L channels per pass over F; lane `lane`'s
// channel t of group k is c0 + (k * 32 + lane) * L + t. Each channel's
// terms are added in the same order whatever L, G and the dtype.
template <typename T, int G, int L>
__global__ void __launch_bounds__(kThreads, 2)
softmax_bucket_kernel(const T* __restrict__ attn, const T* __restrict__ values,
                      const int* __restrict__ idx,
                      const float* __restrict__ chunk_max,
                      float* __restrict__ gmax, uint16_t* __restrict__ rows,
                      int* __restrict__ runs, float* __restrict__ partials,
                      int N, int M, int F, int chunks) {
  const unsigned full = 0xffffffffu;
  extern __shared__ int smem[];
  int* off = smem;                                       // M + 1
  int* scratch = off + M + 1;                            // 32
  int* n_long = scratch + 32;                            // 1: any long run
  float* gsh = reinterpret_cast<float*>(n_long + 1);     // F: the max
  uint16_t* key = reinterpret_cast<uint16_t*>(gsh + F);  // kChunk
  uint16_t* list = key + kChunk;                         // kChunk
  uint16_t* sorted = list + kChunk;                      // kChunk
  const int c = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int ch = tid; ch < F; ch += kThreads) {
    float m = -INFINITY;
    for (int k = 0; k < chunks; ++k) {
      m = fmaxf(m, chunk_max[((size_t)b * chunks + k) * F + ch]);
    }
    gsh[ch] = m;
    if (c == 0) gmax[(size_t)b * F + ch] = m;
  }
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
  const size_t base = ((size_t)b * N + first) * F;
  const T* a_rows = attn + base;
  const T* v_rows = values + base;
  float* range_partials =
      partials + (chunk * kWarps + warp) * kSlots * 2 * F;
  using V = typename Vec<T, L>::type;
  for (int c0 = 0; c0 < F; c0 += 32 * L * G) {
    float g[G][L], se[G][L], sev[G][L];
#pragma unroll
    for (int k = 0; k < G; ++k) {
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const int ch = c0 + (k * 32 + lane) * L + t;
        g[k][t] = ch < F ? gsh[ch] : 0.f;
      }
    }
    int cur = -1, slot = -1;  // the same in every lane
    auto flush = [&]() {
      float* dst = range_partials + (size_t)slot * 2 * F;
#pragma unroll
      for (int k = 0; k < G; ++k) {
#pragma unroll
        for (int t = 0; t < L; ++t) {
          const int ch = c0 + (k * 32 + lane) * L + t;
          if (ch < F) {
            dst[ch] = se[k][t];
            dst[F + ch] = sev[k][t];
          }
        }
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
        V va[kRowsInFlight][G], vv[kRowsInFlight][G];
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
          for (int k = 0; k < G; ++k) {
            const int ch = c0 + (k * 32 + lane) * L;
            const bool live = has[i] && ch < F;
            const size_t e = (size_t)r * F + ch;
            va[i][k] = live ? load_vec<T, L>(a_rows + e) : V{};
            vv[i][k] = live ? load_vec<T, L>(v_rows + e) : V{};
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
            for (int k = 0; k < G; ++k) {
#pragma unroll
              for (int t = 0; t < L; ++t) se[k][t] = sev[k][t] = 0.f;
            }
            const int s = off[cur];
            if (c0 == 0 && s >= r_lo && lane == 0) {
              chunk_runs[cur] = pack_run(off[cur + 1] - s, s, slot);
            }
          }
#pragma unroll
          for (int k = 0; k < G; ++k) {
#pragma unroll
            for (int t = 0; t < L; ++t) {
              add_term(op(va[i][k], t), op(vv[i][k], t), g[k][t], se[k][t],
                       sev[k][t]);
            }
          }
        }
      }
    }
    if (cur >= 0) flush();
  }
}

template <typename T, int G, int L>
__global__ void __launch_bounds__(kReduceWarps * 32, 4)
softmax_reduce_kernel(const T* __restrict__ attn, const T* __restrict__ values,
                      const float* __restrict__ gmax,
                      const uint16_t* __restrict__ rows,
                      const int* __restrict__ runs,
                      const float* __restrict__ partials,
                      float* __restrict__ sums, float* __restrict__ out,
                      int B, int N, int M, int F, int chunks) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long seg =
      (long long)blockIdx.x * kReduceWarps + (threadIdx.x >> 5);  // b*M + s
  if (seg >= (long long)B * M) return;
  const int b = (int)(seg / M), s = (int)(seg % M);
  const T* a_table = attn + (size_t)b * N * F;
  const T* v_table = values + (size_t)b * N * F;
  const float* sample_partials =
      partials + (size_t)b * chunks * kWarps * kSlots * 2 * F;
  const int* seg_runs = runs + (size_t)b * chunks * M + s;
  const uint16_t* sample_rows = rows + (size_t)b * chunks * kChunk;
  const int long_run = long_run_rows(chunks);
  using V = typename Vec<T, L>::type;
  using P = typename Vec<float, L>::type;
  for (int c0 = 0; c0 < F; c0 += 32 * L * G) {
    float g[G][L], se[G][L], sev[G][L];
#pragma unroll
    for (int k = 0; k < G; ++k) {
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const int ch = c0 + (k * 32 + lane) * L + t;
        g[k][t] = ch < F ? gmax[(size_t)b * F + ch] : 0.f;
        se[k][t] = sev[k][t] = 0.f;
      }
    }
    for (int k0 = 0; k0 < chunks; k0 += 32) {
      // this lane's chunk: its run of the segment, as rows or (a long
      // run) one partial per range it meets, and where they begin in the
      // segment's list
      const int kc = k0 + lane;
      const int run = kc < chunks ? seg_runs[(size_t)kc * M] : 0;
      const int cnt = run & 0xFFF, start = (run >> 12) & 0xFFF;
      const bool is_long = cnt >= long_run;
      const int items =
          is_long ? (start + cnt - 1) / kRange - start / kRange + 1 : cnt;
      int incl = items;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(full, incl, d);
        if (lane >= d) incl += t;
      }
      const int item_base = incl - items;
      const int total = __shfl_sync(full, incl, 31);
      for (int j0 = 0; j0 < total; j0 += 32) {
        // item j of the list lies in the run of the last lane whose base
        // is <= j (bases never decrease)
        const int j = j0 + lane;
        int l = 0;
        for (int step = 16; step > 0; step >>= 1) {
          if (__shfl_sync(full, item_base, l + step) <= j) l += step;
        }
        const int l_run = __shfl_sync(full, run, l);
        const int l_base = __shfl_sync(full, item_base, l);
        // >= 0: a row of the sample; < 0: -1 - a partial of the sample
        int ref = 0;
        if (j < total) {
          const int ck = k0 + l, t = j - l_base;
          const int l_cnt = l_run & 0xFFF, l_start = (l_run >> 12) & 0xFFF;
          if (l_cnt >= long_run) {
            const int range = l_start / kRange + t;
            const int slot = t == 0 ? (l_run >> 24) : 0;
            ref = -1 - ((ck * kWarps + range) * kSlots + slot);
          } else {
            ref = ck * kChunk +
                  sample_rows[(size_t)ck * kChunk + l_start + t];
          }
        }
        const int n_items = min(32, total - j0);
        const unsigned row_items = __ballot_sync(full, j < total && ref >= 0);
        // the items in order, in batches of up to kRowsInFlight of one
        // kind (rows, or partials), each batch's loads in flight together
        for (int i0 = 0; i0 < n_items;) {
          const bool is_row = (row_items >> i0) & 1u;
          const unsigned other = (is_row ? ~row_items : row_items) >> i0;
          const int n = min(min(kRowsInFlight, n_items - i0),
                            other == 0u ? 32 - i0 : __ffs(other) - 1);
          if (is_row) {
            V x[kRowsInFlight][G], y[kRowsInFlight][G];
#pragma unroll
            for (int i = 0; i < kRowsInFlight; ++i) {
              const int r = __shfl_sync(full, ref, (i0 + i) & 31);
#pragma unroll
              for (int k = 0; k < G; ++k) {
                const int ch = c0 + (k * 32 + lane) * L;
                const bool live = i < n && ch < F;
                const size_t e = (size_t)max(r, 0) * F + ch;
                x[i][k] = live ? load_vec<T, L>(a_table + e) : V{};
                y[i][k] = live ? load_vec<T, L>(v_table + e) : V{};
              }
            }
#pragma unroll
            for (int i = 0; i < kRowsInFlight; ++i) {
              if (i >= n) continue;
#pragma unroll
              for (int k = 0; k < G; ++k) {
#pragma unroll
                for (int t = 0; t < L; ++t) {
                  add_term(op(x[i][k], t), op(y[i][k], t), g[k][t],
                           se[k][t], sev[k][t]);
                }
              }
            }
          } else {
            P x[kRowsInFlight][G], y[kRowsInFlight][G];
#pragma unroll
            for (int i = 0; i < kRowsInFlight; ++i) {
              const int r = __shfl_sync(full, ref, (i0 + i) & 31);
              const float* p =
                  sample_partials + (size_t)max(-1 - r, 0) * 2 * F;
#pragma unroll
              for (int k = 0; k < G; ++k) {
                const int ch = c0 + (k * 32 + lane) * L;
                const bool live = i < n && ch < F;
                x[i][k] = live ? load_vec<float, L>(p + ch) : P{};
                y[i][k] = live ? load_vec<float, L>(p + F + ch) : P{};
              }
            }
#pragma unroll
            for (int i = 0; i < kRowsInFlight; ++i) {
              if (i >= n) continue;
#pragma unroll
              for (int k = 0; k < G; ++k) {
#pragma unroll
                for (int t = 0; t < L; ++t) {
                  se[k][t] += op(x[i][k], t);
                  sev[k][t] += op(y[i][k], t);
                }
              }
            }
          }
          i0 += n;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const int ch = c0 + (k * 32 + lane) * L + t;
        if (ch < F) {
          sums[(size_t)seg * F + ch] = se[k][t];
          out[(size_t)seg * F + ch] = sev[k][t] / fmaxf(se[k][t], 1e-30f);
        }
      }
    }
  }
}

int chunks_of(int N) { return (N + kChunk - 1) / kChunk; }

// Lets `kernel` take the opt-in limit of dynamic shared memory (once).
template <typename K>
int allow_smem(K* kernel, bool& configured) {
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  configured = true;
  return 0;
}

// The per-chunk max pass, 16-byte loads where the rows allow.
template <typename T>
int launch_max(const T* attn, float* chunk_max, int B, int N, int F,
               int chunks, bool wide, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  static bool ready_v = false, ready_1 = false;
  if (wide) {
    if (int err = allow_smem(softmax_max_kernel<T, V>, ready_v)) return err;
    softmax_max_kernel<T, V><<<dim3(chunks, B), kThreads,
                               max_smem_bytes(F, V), st>>>(attn, chunk_max,
                                                           N, F, chunks);
  } else {
    if (int err = allow_smem(softmax_max_kernel<T, 1>, ready_1)) return err;
    softmax_max_kernel<T, 1><<<dim3(chunks, B), kThreads,
                               max_smem_bytes(F, 1), st>>>(attn, chunk_max,
                                                           N, F, chunks);
  }
  CMR_RETURN_IF_ERROR();
  return 0;
}

// The bucketing and reduce passes.
template <typename T, int G, int L>
int launch_segments(const T* attn, const T* values, const int* idx,
                    const float* chunk_max, float* partials, int* runs,
                    uint16_t* rows, float* gmax, float* sums, float* out,
                    int B, int N, int M, int F, int chunks, cudaStream_t st) {
  static bool ready = false;
  if (int err = allow_smem(softmax_bucket_kernel<T, G, L>, ready)) {
    return err;
  }
  const long long blocks =
      ((long long)B * M + kReduceWarps - 1) / kReduceWarps;
  softmax_bucket_kernel<T, G, L><<<dim3(chunks, B), kThreads,
                                   bucket_smem_bytes(M, F), st>>>(
      attn, values, idx, chunk_max, gmax, rows, runs, partials, N, M, F,
      chunks);
  CMR_RETURN_IF_ERROR();
  softmax_reduce_kernel<T, G, L><<<(unsigned int)blocks, kReduceWarps * 32,
                                   0, st>>>(attn, values, gmax, rows, runs,
                                            partials, sums, out, B, N, M, F,
                                            chunks);
  CMR_RETURN_IF_ERROR();
  return 0;
}

template <typename T>
int run(const void* attn_v, const void* values_v, const int* idx,
        void* scratch, float* gmax, float* sums, float* out, int B, int N,
        int M, int F, cudaStream_t st) {
  const T* attn = static_cast<const T*>(attn_v);
  const T* values = static_cast<const T*>(values_v);
  constexpr int V = 16 / sizeof(T);
  const bool wide =
      F % V == 0 && reinterpret_cast<uintptr_t>(attn) % 16 == 0;
  // a lane takes channel pairs where every row starts on a pair
  const bool pairs =
      F % 2 == 0 && reinterpret_cast<uintptr_t>(attn) % (2 * sizeof(T)) == 0 &&
      reinterpret_cast<uintptr_t>(values) % (2 * sizeof(T)) == 0;
  if (bucket_smem_bytes(M, F) > (size_t)kSmemLimit ||
      max_smem_bytes(F, wide ? V : 1) > (size_t)kSmemLimit) {
    return CMR_ERR_SHARED_MEMORY;
  }
  if (((long long)B * M + kReduceWarps - 1) / kReduceWarps > 2147483647LL) {
    return CMR_ERR_ARGUMENT;
  }
  const int chunks = chunks_of(N);
  const size_t maps = (size_t)B * chunks;
  float* chunk_max = static_cast<float*>(scratch);
  float* partials = chunk_max + maps * F;
  int* runs = reinterpret_cast<int*>(partials + maps * kWarps * kSlots * 2 * F);
  uint16_t* rows = reinterpret_cast<uint16_t*>(runs + maps * M);
  if (int err = launch_max(attn, chunk_max, B, N, F, chunks, wide, st)) {
    return err;
  }
#define CMR_SEGMENTS(G, L)                                                  \
  launch_segments<T, G, L>(attn, values, idx, chunk_max, partials, runs,    \
                           rows, gmax, sums, out, B, N, M, F, chunks, st)
  if (pairs) return F <= 64 ? CMR_SEGMENTS(1, 2) : CMR_SEGMENTS(2, 2);
  switch (std::min(4, (F + 31) / 32)) {
    case 1:
      return CMR_SEGMENTS(1, 1);
    case 2:
      return CMR_SEGMENTS(2, 1);
    case 3:
      return CMR_SEGMENTS(3, 1);
    default:
      return CMR_SEGMENTS(4, 1);
  }
#undef CMR_SEGMENTS
}

}  // namespace

// Bytes of scratch cmr_segment_softmax_attend needs: the chunk maxima, the
// partials, the runs, then the sorted rows.
CMR_EXPORT long long cmr_segment_softmax_scratch_bytes(int B, int N, int M,
                                                       int F) {
  const long long maps = (long long)B * chunks_of(N);
  return maps * ((long long)F * sizeof(float) +
                 (long long)kWarps * kSlots * 2 * F * sizeof(float) +
                 (long long)M * sizeof(int) + kChunk * sizeof(uint16_t));
}

// attn, values [B, N, F] of kind 0 = f32, 1 = bf16; idx [B, N] int32;
// scratch of cmr_segment_softmax_scratch_bytes(B, N, M, F) bytes, 16-byte
// aligned; gmax [B, F], sums and out [B, M, F] f32, every element written
// here. Returns a cudaError_t, or before any launch -1 for an unsupported
// argument (M > 65535, an empty dimension) and -2 for offsets beyond a
// block's shared memory.
CMR_EXPORT int cmr_segment_softmax_attend(const void* attn, const void* values,
                                          int kind, const int* idx,
                                          void* scratch, float* gmax,
                                          float* sums, float* out, int B,
                                          int N, int M, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind < 0 || kind > 1 || M < 1 || M > kMaxBucketSegments || N < 1 ||
      F < 1) {
    return CMR_ERR_ARGUMENT;
  }
  if (B == 0) return 0;
  if (kind == 0) {
    return run<float>(attn, values, idx, scratch, gmax, sums, out, B, N, M, F,
                      st);
  }
  return run<__nv_bfloat16>(attn, values, idx, scratch, gmax, sums, out, B, N,
                            M, F, st);
}
