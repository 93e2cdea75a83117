// Projection-fused observation raster: per sample b and valid row
// j < counts[b], the point p = pcT[b, :, j] goes through the affine
// (A p + t) given by ab[b] (A row-major in ab[0:9], t in ab[9:12]), the
// pinhole divide (|z| < 1e-10 -> 1e-10), the frustum test on the unrounded
// pixel (0 <= x <= w-1, 0 <= y <= h-1, z > 0) and round-half-to-even; its
// feature row and a count of one are summed into that pixel, and each
// pixel's mean (0 where no point lands) and count are written.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:
// segment_mean_count_image_project_fused (_project_raster_kernel: one-hot
// matmul per point tile on the TPU; its int8 absmax quantisation runs
// outside the pallas_call, :1602-1611). The projection arithmetic repeats
// _project_raster_kernel term by term with round-to-nearest intrinsics
// (no FMA contraction) and IEEE division, so a point on a pixel boundary
// lands where the plain PyTorch version puts it.
//
// Operand modes: f32; bf16 (each feature rounded to bf16, f32 sums); int8
// (one absmax scale per (sample, channel) over ALL K rows, as the JAX
// package computes it: scale = max(absmax, 1e-12) / 127, q = clamp(round(x /
// scale), +-127), exact int32 sums, the scale applied at the end). The
// features are read in the dtype they come in (f32 or bf16); the bf16
// rounding and the quantisation happen in registers.
//
// Bound on the H100: memory. At the main path's shape (B=8, K=20480, F=64,
// h*w=5120) the function must read the valid rows' xyz, the landing rows'
// features (int8: every row's, for the absmax) and write means and counts
// (10.6 MB). Design, two launches and no zeroing pass:
//  1. raster_prepass_kernel, a cluster of 8 blocks per sample: each block
//     projects its eighth of the valid rows into pixel ids (pix [B, K]
//     scratch, -1 off the frame) and, for int8, takes the absmax of its
//     eighth of all K rows per channel (16-byte loads, eight in flight a
//     thread); block 0 of the cluster reads the other blocks' maxima from
//     their shared memory and writes scale [B, F].
//  2. raster_band_kernel, one 1024-thread block per (sample, band of P
//     pixels), about one block per SM: the band's F sums and counts live in
//     shared memory; each warp streams its share of the sample's valid
//     pixel ids, gathers the rows landing in the band (ballot) into a list,
//     reads their features (16-byte loads, four in flight a lane),
//     converts or quantises them and adds them with shared-memory atomics;
//     then a warp per pixel writes the pixel's means and count once,
//     divided as raster_finalise_kernel divides. f32/bf16 sums are exact up
//     to the order of the shared atomics; int8 sums are exact. Blocks of
//     512 threads, two an SM, ran 1.5x slower (the latency of the feature
//     loads is what they hide).

#include <math.h>
#include <algorithm>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;          // prepass blocks per sample
constexpr int kPrepassThreads = 1024;
constexpr int kAbsUnroll = 8;        // 16-byte loads in flight a thread
constexpr int kBandThreads = 1024;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kIdsPerLane = 4;       // pixel ids a lane loads per step
constexpr int kListCap = 192;        // landing rows a warp gathers, then adds
constexpr int kAddUnroll = 4;        // 16-byte feature loads in flight a lane

enum Mode { kF32 = 0, kBF16 = 1, kInt8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of features as floats (bf16 -> f32 is exact).
__device__ __forceinline__ void unpack(const uint4 u, float (&o)[4], float) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4 u, float (&o)[8],
                                       __nv_bfloat16) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The raw 16 bytes at p (V features from a 16-byte aligned address), or
// for V = 1 one feature's f32 bits, unpacked later by unpack_raw: a load
// in flight costs four registers whatever the dtype.
template <typename T, int V>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ p) {
  if constexpr (V == 1) {
    return make_uint4(__float_as_uint(to_f32(p[0])), 0u, 0u, 0u);
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}
template <typename T, int V>
__device__ __forceinline__ void unpack_raw(const uint4 u, float (&o)[V]) {
  if constexpr (V == 1) {
    o[0] = __uint_as_float(u.x);
  } else {
    unpack(u, o, T());
  }
}

// Pixel id of row j of sample b, or -1 outside the frustum.
__device__ __forceinline__ int project_row(const float* __restrict__ pcT,
                                           const float (&a)[12], int K, int b,
                                           int j, int h, int w) {
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
    return -1;
  }
  return (int)rintf(y) * w + (int)rintf(x);
}

// Pass 1: pixel ids of the valid rows, and (ABSMAX) scale [B, F].
template <typename T, bool ABSMAX, int V>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kPrepassThreads)
        raster_prepass_kernel(const float* __restrict__ pcT,
                              const T* __restrict__ feat,
                              const float* __restrict__ ab,
                              const int* __restrict__ counts,
                              float* __restrict__ scale, int* __restrict__ pix,
                              int K, int F, int h, int w) {
  extern __shared__ float red[];  // [rlanes * F] maxima, row 0 the block's
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int per = (K + kCluster - 1) / kCluster;
  const int r0 = min(K, rank * per), r1 = min(K, r0 + per);
  float a[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) a[i] = ab[(size_t)b * 12 + i];
  const int valid = min(max(counts[b], 0), r1);
  for (int j = r0 + threadIdx.x; j < valid; j += blockDim.x) {
    pix[(size_t)b * K + j] = project_row(pcT, a, K, b, j, h, w);
  }
  if constexpr (ABSMAX) {
    // thread = (row lane rl, vector column cv); a column's V maxima
    const int FV = F / V;
    const int rlanes = max(1, (int)blockDim.x / FV);
    const int rl = threadIdx.x / FV;
    const T* src = feat + (size_t)b * K * F;
    if (rl < rlanes) {
      for (int cv = threadIdx.x % FV; cv < FV; cv += blockDim.x) {
        float m[V];
#pragma unroll
        for (int e = 0; e < V; ++e) m[e] = 0.f;
        for (int j0 = r0 + rl; j0 < r1; j0 += rlanes * kAbsUnroll) {
          uint4 raw[kAbsUnroll];
#pragma unroll
          for (int u = 0; u < kAbsUnroll; ++u) {
            const int j = j0 + u * rlanes;
            if (j < r1) raw[u] = load_raw<T, V>(src + (size_t)j * F + cv * V);
          }
#pragma unroll
          for (int u = 0; u < kAbsUnroll; ++u) {
            if (j0 + u * rlanes < r1) {
              float v[V];
              unpack_raw<T, V>(raw[u], v);
#pragma unroll
              for (int e = 0; e < V; ++e) m[e] = fmaxf(m[e], fabsf(v[e]));
            }
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e) red[rl * F + cv * V + e] = m[e];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < F; c += blockDim.x) {
      float m = 0.f;
      for (int r = 0; r < rlanes; ++r) m = fmaxf(m, red[r * F + c]);
      red[c] = m;
    }
    cluster.sync();
    if (rank == 0) {
      for (int c = threadIdx.x; c < F; c += blockDim.x) {
        float m = 0.f;
        for (int r = 0; r < kCluster; ++r) {
          m = fmaxf(m, cluster.map_shared_rank(red, r)[c]);
        }
        scale[(size_t)b * F + c] = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
      }
    }
    cluster.sync();  // the other blocks' shared memory lives until read
  }
}

template <int MODE>
struct BandAcc {
  using type = float;
};
template <>
struct BandAcc<kInt8> {
  using type = int;
};

// One feature as the mode adds it.
template <int MODE>
__device__ __forceinline__ typename BandAcc<MODE>::type operand(float x,
                                                                float s) {
  if constexpr (MODE == kF32) {
    return x;
  } else if constexpr (MODE == kBF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    const float q = rintf(__fdiv_rn(x, s));
    return (int)fminf(fmaxf(q, -127.f), 127.f);
  }
}

// A warp adds its n gathered rows (row ids wrow, band pixels wlp) into the
// band's sums: lane takes the feature vectors lane, lane + 32, ... of the
// rows' n * F / V vectors of V features, kAddUnroll 16-byte loads in
// flight. A pixel's sums are kept vector-interleaved (feature c = cv * V +
// t at t * F / V + cv) so that a warp's atomics for one t hit distinct
// banks.
template <typename T, int MODE, int V>
__device__ __forceinline__ void add_rows(
    const T* __restrict__ src, const int* wrow, const unsigned short* wlp,
    int n, int F, typename BandAcc<MODE>::type* sums, int* cnt,
    const float* sc, int lane) {
  const int FV = F / V;
  const int total = n * FV;
  int e = lane / FV, cv = lane - (lane / FV) * FV;  // vector `lane`
  for (int i0 = lane; i0 < total; i0 += 32 * kAddUnroll) {
    uint4 raw[kAddUnroll];
    int at[kAddUnroll], col[kAddUnroll];
#pragma unroll
    for (int u = 0; u < kAddUnroll; ++u) {
      const bool live = i0 + u * 32 < total;
      at[u] = live ? (int)wlp[e] * F + cv : -1;
      col[u] = cv * V;
      if (live) raw[u] = load_raw<T, V>(src + (size_t)wrow[e] * F + cv * V);
      cv += 32;
      while (cv >= FV) {
        cv -= FV;
        ++e;
      }
    }
#pragma unroll
    for (int u = 0; u < kAddUnroll; ++u) {
      if (at[u] >= 0) {
        float v[V];
        unpack_raw<T, V>(raw[u], v);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          atomicAdd(&sums[at[u] + t * FV],
                    operand<MODE>(v[t], MODE == kInt8 ? sc[col[u] + t] : 1.f));
        }
      }
    }
  }
  for (int r = lane; r < n; r += 32) atomicAdd(&cnt[wlp[r]], 1);
}

// Pass 2: one block per (band of P pixels, sample).
template <typename T, int MODE, int V>
__global__ void __launch_bounds__(kBandThreads, 1)
    raster_band_kernel(const T* __restrict__ feat, const int* __restrict__ pix,
                       const int* __restrict__ counts,
                       const float* __restrict__ scale,
                       float* __restrict__ means, float* __restrict__ cnt_out,
                       int K, int F, int HW, int P) {
  using Acc = typename BandAcc<MODE>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  int* rows = reinterpret_cast<int*>(smem);  // [warps][kListCap]
  unsigned short* lps = reinterpret_cast<unsigned short*>(
      rows + kBandWarps * kListCap);  // [warps][kListCap]
  int* cnt = reinterpret_cast<int*>(lps + kBandWarps * kListCap);  // [P]
  float* sc = reinterpret_cast<float*>(cnt + P);  // [F], int8 only
  Acc* sums = reinterpret_cast<Acc*>(sc + (MODE == kInt8 ? F : 0));  // [P*F]
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * P;
  const int np = min(P, HW - p0);
  for (int i = threadIdx.x; i < np * F; i += blockDim.x) sums[i] = Acc(0);
  for (int i = threadIdx.x; i < np; i += blockDim.x) cnt[i] = 0;
  if constexpr (MODE == kInt8) {
    for (int c = threadIdx.x; c < F; c += blockDim.x) {
      sc[c] = scale[(size_t)b * F + c];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* wrow = rows + warp * kListCap;
  unsigned short* wlp = lps + warp * kListCap;
  const int count = min(max(counts[b], 0), K);
  const int* ids = pix + (size_t)b * K;
  const T* src = feat + (size_t)b * K * F;
  const unsigned int below = (1u << lane) - 1u;
  constexpr int kStep = 32 * kIdsPerLane;
  int n = 0;
  // each step gathers up to kStep rows; the list is added (one call site,
  // so one copy of add_rows' registers) once a further step might not fit
  for (int base = warp * kStep;; base += kBandWarps * kStep) {
    const bool more = base < count;
    if (more) {
      int pv[kIdsPerLane];
#pragma unroll
      for (int u = 0; u < kIdsPerLane; ++u) {
        const int j = base + u * 32 + lane;
        pv[u] = j < count ? ids[j] : -1;
      }
#pragma unroll
      for (int u = 0; u < kIdsPerLane; ++u) {
        const int lp = pv[u] - p0;
        const bool in = pv[u] >= 0 && lp >= 0 && lp < np;
        const unsigned int mask = __ballot_sync(0xffffffffu, in);
        if (in) {
          const int at = n + __popc(mask & below);
          wrow[at] = base + u * 32 + lane;
          wlp[at] = (unsigned short)lp;
        }
        n += __popc(mask);
      }
    }
    if (n > kListCap - kStep || (!more && n > 0)) {
      __syncwarp();
      add_rows<T, MODE, V>(src, wrow, wlp, n, F, sums, cnt, sc, lane);
      __syncwarp();
      n = 0;
    }
    if (!more) break;
  }
  __syncthreads();

  // a warp a pixel: its means (a sum over a count of one is the sum
  // itself, so no division there) and its count
  const int FV = F / V;
  for (int p = warp; p < np; p += kBandWarps) {
    const float n_p = (float)cnt[p];
    const Acc* row = sums + (size_t)p * F;
    float* out = means + ((size_t)b * HW + p0 + p) * F;
    for (int c = lane; c < F; c += 32) {
      float s = (float)row[(c % V) * FV + c / V];
      if constexpr (MODE == kInt8) s = __fmul_rn(s, sc[c]);
      out[c] = n_p > 1.f ? __fdiv_rn(s, n_p) : s;
    }
    if (lane == 0) cnt_out[(size_t)b * HW + p0 + p] = n_p;
  }
}

struct Device {
  int sms = 0, optin = 0;
};

const Device& device() {
  static Device d;
  if (d.sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return d;
}

// Shared memory of a band block (and its fixed part, P = 0): the warps'
// row lists (int row, 16-bit band pixel), counts, int8 scales, sums.
size_t band_smem(int P, int F, int mode) {
  return (size_t)kBandWarps * kListCap * 6 + (size_t)P * 4 +
         (mode == kInt8 ? (size_t)F * 4 : 0) + (size_t)P * F * 4;
}

// Lets `kernel` take up to the opt-in limit of dynamic shared memory once
// it asks for more than the default 48 KB (set once per kernel).
int allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  static const void* raised[16];
  static int n_raised = 0;
  for (int i = 0; i < n_raised; ++i) {
    if (raised[i] == kernel) return 0;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, device().optin);
  if (err != cudaSuccess) return (int)err;
  if (n_raised < 16) raised[n_raised++] = kernel;
  return 0;
}

template <typename T, bool ABSMAX>
int prepass(const float* pcT, const T* feat, const float* ab,
            const int* counts, float* scale, int* pix, int B, int K, int F,
            int h, int w, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool wide = F % V == 0 &&
                    reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  const int fv = wide ? F / V : F;
  const size_t smem =
      ABSMAX ? (size_t)std::max(1, kPrepassThreads / fv) * F * 4 : 0;
  if (smem > (size_t)device().optin) return CMR_ERR_SHARED_MEMORY;
  dim3 grid(kCluster, B);
  if (wide) {
    auto* kernel = raster_prepass_kernel<T, ABSMAX, V>;
    if (int err = allow_smem((const void*)kernel, smem)) return err;
    kernel<<<grid, kPrepassThreads, smem, st>>>(pcT, feat, ab, counts, scale,
                                                pix, K, F, h, w);
  } else {
    auto* kernel = raster_prepass_kernel<T, ABSMAX, 1>;
    if (int err = allow_smem((const void*)kernel, smem)) return err;
    kernel<<<grid, kPrepassThreads, smem, st>>>(pcT, feat, ab, counts, scale,
                                                pix, K, F, h, w);
  }
  CMR_RETURN_IF_ERROR();
  return 0;
}

template <typename T, int MODE>
int band(const T* feat, const int* pix, const int* counts, const float* scale,
         float* means, float* cnt_out, int B, int K, int F, int HW,
         cudaStream_t st) {
  const Device& d = device();
  // P pixels a band: one 1024-thread block an SM, about one block per
  // SM in all (fewer bands only where a band's sums fill shared memory)
  const size_t fixed = band_smem(0, F, MODE);
  const size_t per_pixel = (size_t)F * 4 + 4;
  const size_t budget = (size_t)d.optin;
  if (budget < fixed + per_pixel) return CMR_ERR_SHARED_MEMORY;
  // a band pixel is kept in 16 bits
  const long long pmax = std::min((long long)((budget - fixed) / per_pixel),
                                  65535LL);
  long long bands = (HW + pmax - 1) / pmax;
  bands = std::max(bands, (long long)std::max(1, d.sms / B));
  bands = std::min(bands, (long long)HW);
  const int P = (int)((HW + bands - 1) / bands);
  bands = (HW + P - 1) / P;
  const size_t smem = band_smem(P, F, MODE);
  constexpr int V = 16 / sizeof(T);
  auto* kernel = F % V == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0
                     ? raster_band_kernel<T, MODE, V>
                     : raster_band_kernel<T, MODE, 1>;
  if (int err = allow_smem((const void*)kernel, smem)) return err;
  dim3 grid((unsigned int)bands, B);
  kernel<<<grid, kBandThreads, smem, st>>>(feat, pix, counts, scale, means,
                                           cnt_out, K, F, HW, P);
  CMR_RETURN_IF_ERROR();
  return 0;
}

template <typename T>
int run(const float* pcT, const T* feat, int mode, const float* ab,
        const int* counts, float* scale, int* pix, float* means,
        float* cnt_out, int B, int K, int F, int h, int w, cudaStream_t st) {
  int err = mode == kInt8
                ? prepass<T, true>(pcT, feat, ab, counts, scale, pix, B, K, F,
                                   h, w, st)
                : prepass<T, false>(pcT, feat, ab, counts, scale, pix, B, K,
                                    F, h, w, st);
  if (err) return err;
  switch (mode) {
    case kF32:
      return band<T, kF32>(feat, pix, counts, scale, means, cnt_out, B, K, F,
                           h * w, st);
    case kBF16:
      return band<T, kBF16>(feat, pix, counts, scale, means, cnt_out, B, K, F,
                            h * w, st);
    default:
      return band<T, kInt8>(feat, pix, counts, scale, means, cnt_out, B, K,
                            F, h * w, st);
  }
}

}  // namespace

// pcT [B, 3, K] f32; feat [B, K, F] of kind 0 = f32, 1 = bf16; mode 0 =
// f32, 1 = bf16, 2 = int8; ab [B, 12] f32; counts [B] int32; scale [B, F]
// f32, written (int8 only, else null); pix [B, K] int32 scratch; means
// [B, h*w, F] and cnt_out [B, h*w] f32, each element written once. Returns a
// cudaError_t, or CMR_ERR_ARGUMENT / CMR_ERR_SHARED_MEMORY.
CMR_EXPORT int cmr_raster_project(const float* pcT, const void* feat,
                                  int feat_kind, int mode, const float* ab,
                                  const int* counts, float* scale, int* pix,
                                  float* means, float* cnt_out, int B, int K,
                                  int F, int h, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_kind < 0 || feat_kind > 1 || mode < kF32 || mode > kInt8 ||
      K < 1 || F < 1 || h < 1 || w < 1 || (mode == kInt8 && scale == nullptr)) {
    return CMR_ERR_ARGUMENT;
  }
  if (B == 0) return 0;
  if (feat_kind == 0) {
    return run(pcT, static_cast<const float*>(feat), mode, ab, counts, scale,
               pix, means, cnt_out, B, K, F, h, w, st);
  }
  return run(pcT, static_cast<const __nv_bfloat16*>(feat), mode, ab, counts,
             scale, pix, means, cnt_out, B, K, F, h, w, st);
}
