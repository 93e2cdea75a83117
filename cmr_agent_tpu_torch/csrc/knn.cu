// Exact k nearest neighbours: out[b, m, :] = the k points of xyz[b] with the
// smallest |x|^2 - 2 q.x for q = query[b, m], in increasing order, ties to
// the lower index.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:knn_fused (distance tile +
// k rounds of argmin on the TPU). Ranking expression as in _knn_kernel:
// the row-constant |q|^2 is dropped, everything in f32. The products and
// sums use round-to-nearest intrinsics in a fixed order, so no FMA
// contraction changes the ranking against the plain PyTorch version.
//
// Bound on the H100: neither bytes (0.3 MB in, 0.7 MB out at the main path's
// [8, 1280] x [8, 1280] k=16) nor operations (26M distances) are large; the
// kernel is latency-bound. Design: one thread per query keeps a register
// list of its k best (distance, index) pairs sorted lexicographically;
// candidate points are staged through shared memory in tiles of 1024
// (x, y, z, |x|^2), which every thread of the block then reads by
// broadcast. Supports k <= 32 (lists of 8, 16 or 32 slots).

#include <math.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 64;

template <int MAXK>
__global__ void knn_kernel(const float* __restrict__ xyz,
                           const float* __restrict__ query,
                           int* __restrict__ out, int N, int M, int k) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = qi < M;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = query + ((size_t)b * M + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float bd[MAXK];
  int bi[MAXK];
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    bd[j] = INFINITY;
    bi[j] = INT_MAX;
  }
  float worst = INFINITY;

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int tn = min(kTile, N - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < tn; j += blockDim.x) {
      const float* p = xyz + ((size_t)b * N + t0 + j) * 3;
      const float x = p[0], y = p[1], z = p[2];
      const float sq =
          __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
      tile[j] = make_float4(x, y, z, sq);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < tn; ++j) {
      const float4 p = tile[j];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                                  __fmul_rn(qz, p.z));
      const float d = __fsub_rn(p.w, __fmul_rn(2.f, dot));
      // candidates arrive in increasing index order, so an equal distance
      // never displaces a listed (lower-index) neighbour
      if (!(d < worst)) continue;
      float cd = d;
      int ci = t0 + j;
#pragma unroll
      for (int s = 0; s < MAXK; ++s) {
        if (s < k && (cd < bd[s] || (cd == bd[s] && ci < bi[s]))) {
          const float td = bd[s];
          const int ti = bi[s];
          bd[s] = cd;
          bi[s] = ci;
          cd = td;
          ci = ti;
        }
      }
#pragma unroll
      for (int s = 0; s < MAXK; ++s) {
        if (s == k - 1) worst = bd[s];
      }
    }
  }
  if (active) {
    int* o = out + ((size_t)b * M + qi) * k;
#pragma unroll
    for (int s = 0; s < MAXK; ++s) {
      if (s < k) o[s] = bi[s];
    }
  }
}

}  // namespace

// xyz [B, N, 3], query [B, M, 3] f32; out [B, M, k] int32; 1 <= k <= 32,
// k <= N. Returns a cudaError_t, or -1 for an unsupported k.
CMR_EXPORT int cmr_knn(const float* xyz, const float* query, int* out, int B,
                       int N, int M, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((M + kThreads - 1) / kThreads, B);
  if (k < 1) {
    return -1;
  } else if (k <= 8) {
    knn_kernel<8><<<grid, kThreads, 0, st>>>(xyz, query, out, N, M, k);
  } else if (k <= 16) {
    knn_kernel<16><<<grid, kThreads, 0, st>>>(xyz, query, out, N, M, k);
  } else if (k <= 32) {
    knn_kernel<32><<<grid, kThreads, 0, st>>>(xyz, query, out, N, M, k);
  } else {
    return -1;
  }
  CMR_RETURN_IF_ERROR();
  return 0;
}
