// Stable bucketing of one block's rows by segment, in shared memory: the
// common first step of the two segment sums (segment_sum.cu,
// segment_sum_shared.cu), which then add every segment's rows in ascending
// row order and write each output element once.
//
// Counts by shared-memory integer atomics (order-free), an exclusive scan
// into segment offsets, a placement by atomics (any order within a
// segment), then each segment's rows are put in ascending order whatever
// order the atomics ran in, one of two ways by the segment's size k. A
// small segment (k * k <= n) ranks each of its rows by counting its
// smaller ones: k steps a row. A large one is taken by one warp, which
// walks all n ids 32 at a time and places the segment's rows in order by
// ballot: n / 32 steps. So a block spends at most n steps a row on the
// whole, however the rows spread over the segments (the geo step puts up
// to 1955 of 40960 rows on one node; 1 or 2 is the common size).

#pragma once

#include "common.cuh"

namespace {

// A row whose id lies outside [0, M): no segment. So M <= 65535.
constexpr uint16_t kRoutedOut = 0xFFFF;
constexpr int kMaxBucketSegments = 65535;

// Exclusive scan of v[0..n) in place by the whole block (blockDim.x a
// multiple of 32); `scratch` holds 32 ints of shared memory. Ends with a
// __syncthreads.
__device__ inline void block_exclusive_scan(int* v, int n, int* scratch) {
  const unsigned full = 0xffffffffu;
  const int threads = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int per = (n + threads - 1) / threads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += v[i];
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < threads / 32 ? scratch[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(full, w, d);
      if (lane >= d) w += t;
    }
    if (lane < threads / 32) scratch[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? scratch[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = v[i];
    v[i] = run;
    run += c;
  }
  __syncthreads();
}

// Whether a segment of k of the block's n rows is placed by one warp's
// ballots (else by counting smaller rows).
__device__ inline bool bucket_is_large(int k, int n) {
  return (long long)k * k > n;
}

// In: key[0..n) (n <= 65536), each row's segment in [0, M) or kRoutedOut,
// visible to the whole block. Out: sorted[off[q] .. off[q + 1]) holds
// segment q's rows in ascending order, off[M] rows are kept. off (M + 1
// ints), list (n) and scratch (32 ints) are shared memory, sorted (n)
// shared or global memory; sorted is complete for the block after the
// caller's next __syncthreads.
__device__ inline void stable_bucket(const uint16_t* key, int n, int M,
                                     int* off, uint16_t* list,
                                     uint16_t* sorted, int* scratch) {
  const unsigned full = 0xffffffffu;
  const int threads = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = threads >> 5;
  for (int q = tid; q <= M; q += threads) off[q] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += threads) {  // segment q counted at q + 1
    const int q = key[i];
    if (q != kRoutedOut) atomicAdd(&off[q + 1], 1);
  }
  __syncthreads();
  block_exclusive_scan(off + 1, M, scratch);  // off[q + 1] = start of q
  for (int i = tid; i < n; i += threads) {    // ends with off[q] = start
    const int q = key[i];
    if (q != kRoutedOut) list[atomicAdd(&off[q + 1], 1)] = (uint16_t)i;
  }
  __syncthreads();
  const int kept = off[M];
  for (int j = tid; j < kept; j += threads) {
    const int r = list[j];
    const int q = key[r];
    const int lo = off[q], hi = off[q + 1];
    if (bucket_is_large(hi - lo, n)) continue;
    int rank = 0;
    for (int k = lo; k < hi; ++k) rank += list[k] < r;
    sorted[lo + rank] = (uint16_t)r;
  }
  const unsigned lower = (1u << lane) - 1u;
  for (int q0 = warp * 32; q0 < M; q0 += warps * 32) {
    const int q = q0 + lane;
    unsigned large = __ballot_sync(
        full, q < M && bucket_is_large(off[q + 1] - off[q], n));
    while (large != 0u) {
      const int big = q0 + __ffs(large) - 1;
      large &= large - 1u;
      int at = off[big];
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        const bool in = i < n && key[i] == big;
        const unsigned m = __ballot_sync(full, in);
        if (in) sorted[at + __popc(m & lower)] = (uint16_t)i;
        at += __popc(m);
      }
    }
  }
}

}  // namespace
