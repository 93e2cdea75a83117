// Projection-fused observation raster: per sample b and valid row
// j < counts[b], the point p = pcT[b, :, j] goes through the affine
// (A p + t) given by ab[b] (A row-major in ab[0:9], t in ab[9:12]), the
// pinhole divide (|z| < 1e-10 -> 1e-10), the frustum test on the unrounded
// pixel (0 <= x <= w-1, 0 <= y <= h-1, z > 0) and round-half-to-even; its
// feature row and a count of one are summed into that pixel. A second pass
// turns the sums into per-pixel means (0 where no point lands) and counts.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:
// segment_mean_count_image_project_fused (_project_raster_kernel: one-hot
// matmul per point tile on the TPU). The projection arithmetic repeats
// _project_raster_kernel term by term with round-to-nearest intrinsics
// (no FMA contraction) and IEEE division, so a point on a pixel boundary
// lands where the plain PyTorch version puts it.
//
// Operand modes: f32 and bf16 features accumulate in f32 atomics (order-
// dependent rounding only); int8 features (quantised by the wrapper, one
// absmax scale per (sample, channel)) accumulate in int32 atomics, which are
// exact and order-free, and the scale is applied in the second pass.
//
// Bound on the H100: memory. At the main path's shape (B=8, K=20480, F=64,
// h*w=5120) the function must read the valid rows of pcT and feat (at most
// 42 MB in f32) and write means and counts (10.6 MB); the [B, h*w, F+1]
// accumulator (10.8 MB) stays in L2. Design: block (32, 8) = 8 points x 32
// channel lanes; each lane recomputes its point's projection (a few flops)
// and adds a strided share of the F channels, so a warp's feature reads and
// atomics touch consecutive addresses. The accumulate and finalise steps
// are shared with raster_image.cu through common.cuh.

#include <math.h>

#include "common.cuh"

namespace {

template <typename T>
__global__ void raster_project_kernel(
    const float* __restrict__ pcT, const T* __restrict__ feat,
    const float* __restrict__ ab, const int* __restrict__ counts,
    typename AccumOf<T>::type* __restrict__ acc, int K, int F, int h, int w) {
  using Acc = typename AccumOf<T>::type;
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.y + threadIdx.y;
  if (j >= K || j >= counts[b]) return;
  const float* a = ab + (size_t)b * 12;
  const float px = pcT[((size_t)b * 3 + 0) * K + j];
  const float py = pcT[((size_t)b * 3 + 1) * K + j];
  const float pz = pcT[((size_t)b * 3 + 2) * K + j];
  const float xp = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a[0], px),
                                                 __fmul_rn(a[1], py)),
                                       __fmul_rn(a[2], pz)), a[9]);
  const float yp = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a[3], px),
                                                 __fmul_rn(a[4], py)),
                                       __fmul_rn(a[5], pz)), a[10]);
  const float zp = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a[6], px),
                                                 __fmul_rn(a[7], py)),
                                       __fmul_rn(a[8], pz)), a[11]);
  const float zs = fabsf(zp) < 1e-10f ? 1e-10f : zp;
  const float x = __fdiv_rn(xp, zs);
  const float y = __fdiv_rn(yp, zs);
  if (!(x >= 0.f && x <= (float)(w - 1) && y >= 0.f && y <= (float)(h - 1) &&
        zp > 0.f)) {
    return;
  }
  const int pix = (int)rintf(y) * w + (int)rintf(x);
  raster_accumulate_row(acc + ((size_t)b * h * w + pix) * (F + 1),
                        feat + ((size_t)b * K + j) * F, F, threadIdx.x,
                        blockDim.x);
}

template <typename T>
int launch(const float* pcT, const void* feat, const float* ab,
           const int* counts, const float* scale, void* acc, float* means,
           float* cnt_out, int B, int K, int F, int h, int w, cudaStream_t st) {
  using Acc = typename AccumOf<T>::type;
  dim3 block(32, 8);
  dim3 grid((K + 7) / 8, B);
  raster_project_kernel<T><<<grid, block, 0, st>>>(
      pcT, static_cast<const T*>(feat), ab, counts, static_cast<Acc*>(acc), K,
      F, h, w);
  CMR_RETURN_IF_ERROR();
  return raster_finalise(static_cast<const Acc*>(acc), scale, means, cnt_out,
                         B, h * w, F, st);
}

}  // namespace

// pcT [B, 3, K] f32; feat [B, K, F] of kind 0 = f32, 1 = bf16, 2 = int8;
// ab [B, 12] f32; counts [B] int32; scale [B, F] f32 (int8 only, else
// null); acc [B, h*w, F+1] zeroed, f32 (kinds 0, 1) or int32 (kind 2);
// means [B, h*w, F] and cnt_out [B, h*w] f32. Returns a cudaError_t, or -1
// for an unknown kind.
CMR_EXPORT int cmr_raster_project(const float* pcT, const void* feat,
                                  int feat_kind, const float* ab,
                                  const int* counts, const float* scale,
                                  void* acc, float* means, float* cnt_out,
                                  int B, int K, int F, int h, int w,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (feat_kind) {
    case 0:
      return launch<float>(pcT, feat, ab, counts, nullptr, acc, means,
                           cnt_out, B, K, F, h, w, st);
    case 1:
      return launch<__nv_bfloat16>(pcT, feat, ab, counts, nullptr, acc, means,
                                   cnt_out, B, K, F, h, w, st);
    case 2:
      return launch<int8_t>(pcT, feat, ab, counts, scale, acc, means, cnt_out,
                            B, K, F, h, w, st);
    default:
      return -1;
  }
}
