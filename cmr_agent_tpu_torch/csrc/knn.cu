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
// [8, 1280] x [8, 1280] k=16) nor operations (26M distances) are large; what
// costs is the selection. Design: one warp per query, 16 queries a block.
// The block stages its sample's points once in shared memory as float4
// (x, y, z, |x|^2). Lane l scans the candidates j = l, l + 32, ... and keeps
// a sorted list of its L best (distance, index) pairs in registers (L = 4,
// or 8 for k > 16). Then k rounds of a warp-wide lexicographic minimum over
// the lanes' list heads (__shfl_xor_sync) give the neighbours in order; the
// winning lane pops its head, and a lane whose list runs empty while it has
// candidates left rescans them for its next L best after the last one it
// gave. Indices are unique across lanes (j mod 32 = l), so a lane knows it
// won by comparing the winner's index with its own head. Distances are
// taken to be finite (coordinates whose |x|^2 stays within f32 range).

#include <math.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;  // queries per block, one warp each

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ float rank_distance(float4 p, float qx, float qy,
                                               float qz) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                              __fmul_rn(qz, p.z));
  return __fsub_rn(p.w, __fmul_rn(2.f, dot));
}

// Inserts (d, i) into the sorted list of L pairs, every listed pair being
// of a lower index (a lane meets its candidates in increasing index order):
// an equal distance goes after, the pairs past its place shift down one,
// the last drops out. Predicated selects, no swap chain.
template <int L>
__device__ __forceinline__ void insert(float (&bd)[L], int (&bi)[L], float d,
                                       int i) {
  bool below[L];
#pragma unroll
  for (int s = 0; s < L; ++s) below[s] = d < bd[s];
#pragma unroll
  for (int s = L - 1; s > 0; --s) {
    if (below[s]) {
      bd[s] = below[s - 1] ? bd[s - 1] : d;
      bi[s] = below[s - 1] ? bi[s - 1] : i;
    }
  }
  if (below[0]) {
    bd[0] = d;
    bi[0] = i;
  }
}

// The L best of lane's candidates lexicographically after (ad, ai)
// (ad = -inf: all of them), into an emptied list.
template <int L>
__device__ __forceinline__ void scan(const float4* __restrict__ pts, int N,
                                     int lane, float qx, float qy, float qz,
                                     float ad, int ai, float (&bd)[L],
                                     int (&bi)[L]) {
  for (int j = lane; j < N; j += 32) {
    const float d = rank_distance(pts[j], qx, qy, qz);
    if (lex_less(ad, ai, d, j)) insert(bd, bi, d, j);
  }
}

template <int L>
__global__ void __launch_bounds__(kWarps * 32)
    knn_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
               int* __restrict__ out, int N, int M, int k) {
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  const float* src = xyz + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float x = src[3 * j], y = src[3 * j + 1], z = src[3 * j + 2];
    const float sq =
        __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    pts[j] = make_float4(x, y, z, sq);
  }
  __syncthreads();
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= M) return;  // the whole warp: the shuffles below see 32 lanes
  const int lane = threadIdx.x & 31;
  const float* qp = query + ((size_t)b * M + q) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];

  float bd[L];
  int bi[L];
#pragma unroll
  for (int s = 0; s < L; ++s) {
    bd[s] = INFINITY;
    bi[s] = INT_MAX;
  }
  scan(pts, N, lane, qx, qy, qz, -INFINITY, INT_MIN, bd, bi);
  const int mine_total = lane < N ? (N - lane + 31) / 32 : 0;
  int given = 0;   // how many of this lane's candidates were output
  int mine = 0;    // output slot `lane`
  for (int r = 0; r < k; ++r) {
    float d = bd[0];
    int i = bi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (lex_less(od, oi, d, i)) {
        d = od;
        i = oi;
      }
    }
    if (lane == r) mine = i;
    if (i == bi[0] && i != INT_MAX) {  // this lane's head won: pop it
#pragma unroll
      for (int s = 0; s + 1 < L; ++s) {
        bd[s] = bd[s + 1];
        bi[s] = bi[s + 1];
      }
      bd[L - 1] = INFINITY;
      bi[L - 1] = INT_MAX;
      ++given;
      if (bi[0] == INT_MAX && given < mine_total && r + 1 < k) {
        scan(pts, N, lane, qx, qy, qz, d, i, bd, bi);
      }
    }
  }
  if (lane < k) out[((size_t)b * M + q) * k + lane] = mine;
}

template <int L>
int launch(const float* xyz, const float* query, int* out, int B, int N,
           int M, int k, cudaStream_t st) {
  const size_t smem = (size_t)N * sizeof(float4);
  if (smem > 48 * 1024) {
    static bool raised = false;  // the limit is per kernel, set once
    if (!raised) {
      int dev = 0, optin = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
      cudaFuncSetAttribute(knn_kernel<L>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      CMR_RETURN_IF_ERROR();
      raised = true;
    }
  }
  dim3 grid((M + kWarps - 1) / kWarps, B);
  knn_kernel<L><<<grid, kWarps * 32, smem, st>>>(xyz, query, out, N, M, k);
  CMR_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// xyz [B, N, 3], query [B, M, 3] f32; out [B, M, k] int32; 1 <= k <= 32,
// k <= N, N * 16 bytes within a block's shared memory. Returns a
// cudaError_t, or CMR_ERR_ARGUMENT / CMR_ERR_SHARED_MEMORY.
CMR_EXPORT int cmr_knn(const float* xyz, const float* query, int* out, int B,
                       int N, int M, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 32 || k > N) return CMR_ERR_ARGUMENT;
  if ((size_t)N * sizeof(float4) > 227 * 1024) return CMR_ERR_SHARED_MEMORY;
  if (B == 0 || M == 0) return 0;
  return k <= 16 ? launch<4>(xyz, query, out, B, N, M, k, st)
                 : launch<8>(xyz, query, out, B, N, M, k, st);
}
