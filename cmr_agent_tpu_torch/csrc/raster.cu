// Observation rasters, mean + count per pixel, in two forms that share
// one band kernel and differ only in where a row's pixel comes from:
//
// - projection-fused (cmr_raster_project): per sample b and valid row
//   j < counts[b], the point p = pcT[b, :, j] goes through the affine
//   (A p + t) given by ab[b] (A row-major in ab[0:9], t in ab[9:12]), the
//   pinhole divide (|z| < 1e-10 -> 1e-10), the frustum test on the
//   unrounded pixel (0 <= x <= w-1, 0 <= y <= h-1, z > 0) and
//   round-half-to-even. Replaces cmr_agent_tpu/ops/pallas_kernels.py:
//   segment_mean_count_image_project_fused (_project_raster_kernel; its
//   int8 absmax quantisation runs outside the pallas_call, :1602-1611). The
//   projection repeats _project_raster_kernel term by term with
//   round-to-nearest intrinsics (no FMA contraction) and IEEE division, so
//   a point on a pixel boundary lands where the plain PyTorch version puts
//   it.
// - pixel-id (cmr_raster_image): row j of sample b lands on the caller's
//   ids[b, j]; an id outside [0, h*w) routes the row out. Replaces
//   segment_sum_image_fused on its flat path (_sum_image_flat_kernel,
//   pallas_call at :670, through segment_mean_count_image_fused with
//   factored=False and the in-kernel ones column; int8 at :612-621): the
//   raster of every training episode step and of the "flat" and "topk"
//   eval episodes. With `sums` set it writes each pixel's sums instead of
//   its mean, and then replaces segment_sum_count_image_compact
//   (_sum_image_compact_kernel, pallas_call at :846): the raster of the
//   "compact" eval episode, whose ids cover the whole uncompacted cloud
//   (most of it routed out). The TPU kernel packs each tile's valid rows
//   to the front in VMEM; here each band lists its landing rows itself,
//   so no packing is needed. Its int8 mode quantises as the flat raster
//   does (the TPU kernel's casts without quantising, :829-830). The sums
//   form also replaces segment_sum_image_fused on its factored path
//   (_sum_image_factored_kernel, pallas_call at :648; f32 and bf16, the
//   caller refusing int8 and w > 128 as the JAX package does): the TPU
//   kernel factors a tile's [T, h*w] pixel one-hot into a 128-lane column
//   one-hot and a gate per image row for its vector unit, a choice this
//   card does not need; the factored mean is the sums over the counts
//   this kernel writes, so no ones column is appended.
//
// In all, each landing row's features and a count of one are summed into
// its pixel, and each pixel's mean (0 where no row lands) or sums, and its
// count, are written once.
//
// Operand modes: f32; bf16 (each feature rounded to bf16, f32 sums); int8
// (one absmax scale per (sample, channel) over ALL K rows, as the JAX
// package computes it: scale = max(absmax, 1e-12) / 127, q = clamp(round(x /
// scale), +-127), exact int32 sums, the scale applied at the end). The
// features are read in the dtype they come in (f32 or bf16); the bf16
// rounding and the quantisation happen in registers.
//
// Bound on the H100: memory. At the serving shape (B=8, K=20480, F=64,
// h*w=5120) the function must read the ids (or the valid rows' xyz), the
// landing rows' features (int8: every row's, for the absmax) and write
// means and counts (10.6 MB). Design, no zeroing pass, no global atomics:
//  1. raster_prepass_kernel, a cluster of 8 blocks per sample, for the
//     projection-fused form or int8: each block projects its eighth of the
//     valid rows into pixel ids (pix [B, K] scratch, -1 off the frame) and,
//     for int8, takes the absmax of its eighth of all K rows per channel
//     (16-byte loads, eight in flight a thread); block 0 of the cluster
//     reads the other blocks' maxima from their shared memory and writes
//     scale [B, F]. The pixel-id form in f32 or bf16 needs no prepass.
//  2. raster_band_kernel, one 1024-thread block per (sample, band of P
//     pixels), about one block per SM: the band's F sums live in shared
//     memory. The block streams its sample's pixel ids 4096 at a time and
//     lists the rows landing in the band in ascending row order (ballots
//     and a scan of the warps' counts); up to 8192 listed rows are
//     bucketed by pixel (bucket.cuh: each pixel's rows in ascending order)
//     and the bucketed places cut into 32 equal ranges, one a warp. A warp
//     adds its places in order, lanes over channels, eight row loads in
//     flight, each pixel's run in registers; the run that holds a pixel's
//     first place is added into the pixel's sums directly (no other warp
//     touches them), a run that began in an earlier range goes to the
//     warp's slot, and the slots are added in warp order after the warps
//     are done. So every pixel's sum has an order fixed by the ids alone,
//     the same bits on every launch in every mode, whatever the rows'
//     spread (a pixel of every row is cut over the 32 warps). Then a warp
//     per pixel writes the pixel's means (or sums) and count once. Blocks
//     of 512 threads, two an SM, ran 1.5x slower than 1024 (the latency of
//     the feature loads is what they hide).
// The compacting raster's calls (B=8, N=40960, F=64, h*w=5120) hand every
// band block all N ids of its sample, most of them routed out: 16 bands a
// sample read the 1.3 MB of ids 16 times, from L2. On an H100 that scan
// takes 10-11 us of a 22-24 us f32 call (every row routed out), too little
// to pay for a pass that lists each band's landing rows first.

#include <math.h>
#include <algorithm>
#include <cooperative_groups.h>

#include "bucket.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;          // prepass blocks per sample
constexpr int kPrepassThreads = 1024;
constexpr int kAbsUnroll = 8;        // 16-byte loads in flight a thread
constexpr int kBandThreads = 1024;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kIdsPerLane = 4;       // pixel ids a lane loads per step
constexpr int kStepIds = kBandThreads * kIdsPerLane;
constexpr int kWindow = 2 * kStepIds;  // listed rows bucketed at once
constexpr int kAddRows = 8;          // row loads in flight a lane

enum Mode { kF32 = 0, kBF16 = 1, kInt8 = 2 };

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

// Pass 1: (PROJECT) pixel ids of the valid rows, and (ABSMAX) scale [B, F].
template <typename T, bool PROJECT, bool ABSMAX, int V>
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
  if constexpr (PROJECT) {
    float a[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) a[i] = ab[(size_t)b * 12 + i];
    const int valid = min(max(counts[b], 0), r1);
    for (int j = r0 + threadIdx.x; j < valid; j += blockDim.x) {
      pix[(size_t)b * K + j] = project_row(pcT, a, K, b, j, h, w);
    }
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

// Byte offsets of a band block's shared memory (P pixels, F channels):
// the sums, the warps' slots, the listed rows, counts, bucket offsets, the
// slots' pixels, the warps' list counts, scan scratch, the int8 scales,
// then the 16-bit keys and bucketing lists.
struct BandLayout {
  size_t sums, slot, row, cnt, off, slot_pix, wtot, scratch, sc, key, list,
      sorted, total;
};

__host__ __device__ inline BandLayout band_layout(int P, int F) {
  BandLayout l;
  size_t at = 0;
  l.sums = at;
  at += (size_t)P * F * 4;
  l.slot = at;
  at += (size_t)kBandWarps * F * 4;
  l.row = at;
  at += (size_t)kWindow * 4;
  l.cnt = at;
  at += (size_t)P * 4;
  l.off = at;
  at += (size_t)(P + 1) * 4;
  l.slot_pix = at;
  at += kBandWarps * 4;
  l.wtot = at;
  at += (kBandWarps + 1) * 4;
  l.scratch = at;
  at += 32 * 4;
  l.sc = at;
  at += (size_t)F * 4;
  l.key = at;
  at += kWindow * 2;
  l.list = at;
  at += kWindow * 2;
  l.sorted = at;
  at += kWindow * 2;
  l.total = at;
  return l;
}

// The block adds the n listed rows (row[e] landing on band pixel key[e],
// ascending in e) into the band's sums and counts: bucketed by pixel, the
// places cut into one range a warp, each warp adding its places in order
// (lanes over channels), the run that holds a pixel's first place straight
// into its sums and a run begun in an earlier range into the warp's slot;
// then the slots in warp order. Starts and ends with the whole block in
// step.
template <typename T, int MODE>
__device__ __forceinline__ void add_window(
    const T* __restrict__ src, int n, int np, int F, const int* row,
    const uint16_t* key, uint16_t* list, uint16_t* sorted, int* off,
    int* scratch, typename BandAcc<MODE>::type* sums,
    typename BandAcc<MODE>::type* slot, int* slot_pix, int* cnt,
    const float* sc) {
  using Acc = typename BandAcc<MODE>::type;
  constexpr unsigned int full = 0xffffffffu;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  stable_bucket(key, n, np, off, list, sorted, scratch);
  __syncthreads();
  for (int q = tid; q < np; q += kBandThreads) cnt[q] += off[q + 1] - off[q];
  const int per = (n + kBandWarps - 1) / kBandWarps;
  const int lo = min(n, warp * per), hi = min(n, lo + per);
  if (lane == 0) slot_pix[warp] = -1;
  __syncwarp();
  for (int c0 = 0; c0 < F; c0 += 64) {  // 64 channels a pass
    Acc acc[2];
    int cur = -1;  // the same in every lane
    auto flush = [&]() {
      const bool split = off[cur] < lo;
      Acc* dst = split ? slot + (size_t)warp * F : sums + (size_t)cur * F;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int ch = c0 + g * 32 + lane;
        if (ch < F) dst[ch] = split ? acc[g] : dst[ch] + acc[g];
      }
      if (split && lane == 0) slot_pix[warp] = cur;
    };
    for (int q0 = lo; q0 < hi; q0 += 32) {
      int r = 0, q = 0;
      if (q0 + lane < hi) {
        const int e = sorted[q0 + lane];
        r = row[e];
        q = key[e];
      }
      const int nv = min(32, hi - q0);
      for (int i0 = 0; i0 < nv; i0 += kAddRows) {
        float v[kAddRows][2];
        int qi[kAddRows];
#pragma unroll
        for (int i = 0; i < kAddRows; ++i) {
          const int ri = __shfl_sync(full, r, (i0 + i) & 31);
          qi[i] = __shfl_sync(full, q, (i0 + i) & 31);
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const int ch = c0 + g * 32 + lane;
            v[i][g] = (i0 + i < nv && ch < F)
                          ? to_f32(src[(size_t)ri * F + ch])
                          : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < kAddRows; ++i) {
          if (i0 + i >= nv) continue;
          if (qi[i] != cur) {
            if (cur >= 0) flush();
            cur = qi[i];
            acc[0] = acc[1] = Acc(0);
          }
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const int ch = c0 + g * 32 + lane;
            if (ch < F) {
              acc[g] += operand<MODE>(v[i][g], MODE == kInt8 ? sc[ch] : 1.f);
            }
          }
        }
      }
    }
    if (cur >= 0) flush();
  }
  __syncthreads();
  for (int c = tid; c < F; c += kBandThreads) {
    for (int w = 0; w < kBandWarps; ++w) {
      const int q = slot_pix[w];
      if (q >= 0) sums[(size_t)q * F + c] += slot[(size_t)w * F + c];
    }
  }
  __syncthreads();
}

// Pass 2: one block per (band of P pixels, sample). GIVEN_IDS: every one
// of the K rows lands on the caller's id; else the first counts[b] rows on
// the prepass's pixel. SUMS: each pixel's sums are written, not its mean.
template <typename T, int MODE, bool GIVEN_IDS, bool SUMS>
__global__ void __launch_bounds__(kBandThreads, 1)
    raster_band_kernel(const T* __restrict__ feat, const int* __restrict__ pix,
                       const int* __restrict__ counts,
                       const float* __restrict__ scale,
                       float* __restrict__ means, float* __restrict__ cnt_out,
                       int K, int F, int HW, int P) {
  static_assert(kBandWarps == 32, "one scan lane a warp");
  using Acc = typename BandAcc<MODE>::type;
  constexpr unsigned int full = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  const BandLayout l = band_layout(P, F);
  Acc* sums = reinterpret_cast<Acc*>(smem + l.sums);
  Acc* slot = reinterpret_cast<Acc*>(smem + l.slot);
  int* row = reinterpret_cast<int*>(smem + l.row);
  int* cnt = reinterpret_cast<int*>(smem + l.cnt);
  int* off = reinterpret_cast<int*>(smem + l.off);
  int* slot_pix = reinterpret_cast<int*>(smem + l.slot_pix);
  int* wtot = reinterpret_cast<int*>(smem + l.wtot);
  int* scratch = reinterpret_cast<int*>(smem + l.scratch);
  float* sc = reinterpret_cast<float*>(smem + l.sc);
  uint16_t* key = reinterpret_cast<uint16_t*>(smem + l.key);
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + l.list);
  uint16_t* sorted = reinterpret_cast<uint16_t*>(smem + l.sorted);
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * P;
  const int np = min(P, HW - p0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < np * F; i += kBandThreads) sums[i] = Acc(0);
  for (int i = tid; i < np; i += kBandThreads) cnt[i] = 0;
  if constexpr (MODE == kInt8) {
    for (int c = tid; c < F; c += kBandThreads) {
      sc[c] = scale[(size_t)b * F + c];
    }
  }
  __syncthreads();

  const int count = GIVEN_IDS ? K : min(max(counts[b], 0), K);
  const int* ids = pix + (size_t)b * K;
  const T* src = feat + (size_t)b * K * F;
  const unsigned int below = (1u << lane) - 1u;
  int n = 0;  // rows listed, the same in every thread
  // warp w lists the landing rows of ids [first, first + 128) of each
  // step, in order; the next step's ids are loaded before this step's
  // barriers
  auto load_ids = [&](int base, int (&pv)[kIdsPerLane]) {
#pragma unroll
    for (int u = 0; u < kIdsPerLane; ++u) {
      const int j = base + warp * 32 * kIdsPerLane + u * 32 + lane;
      pv[u] = j < count ? ids[j] : -1;
    }
  };
  int pv[kIdsPerLane];
  load_ids(0, pv);
  for (int base = 0; base < count; base += kStepIds) {
    const int first = base + warp * 32 * kIdsPerLane;
    int lp[kIdsPerLane];
    unsigned int mask[kIdsPerLane];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kIdsPerLane; ++u) {
      lp[u] = pv[u] - p0;
      mask[u] = __ballot_sync(full,
                              pv[u] >= 0 && lp[u] >= 0 && lp[u] < np);
      mine += __popc(mask[u]);
    }
    load_ids(base + kStepIds, pv);
    if (lane == 0) wtot[warp] = mine;
    __syncthreads();
    if (warp == 0) {
      const int v = wtot[lane];
      int incl = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(full, incl, d);
        if (lane >= d) incl += t;
      }
      wtot[lane] = incl - v;
      if (lane == 31) wtot[kBandWarps] = incl;
    }
    __syncthreads();
    int at = n + wtot[warp];
#pragma unroll
    for (int u = 0; u < kIdsPerLane; ++u) {
      if (mask[u] & (1u << lane)) {
        const int e = at + __popc(mask[u] & below);
        key[e] = (uint16_t)lp[u];
        row[e] = first + u * 32 + lane;
      }
      at += __popc(mask[u]);
    }
    n += wtot[kBandWarps];
    __syncthreads();
    if (n > kWindow - kStepIds) {  // the next step might not fit
      add_window<T, MODE>(src, n, np, F, row, key, list, sorted, off,
                          scratch, sums, slot, slot_pix, cnt, sc);
      n = 0;
    }
  }
  if (n > 0) {
    add_window<T, MODE>(src, n, np, F, row, key, list, sorted, off, scratch,
                        sums, slot, slot_pix, cnt, sc);
  }

  // a warp a pixel: its means (a sum over a count of one is the sum
  // itself, so no division there) or its sums, and its count
  for (int p = warp; p < np; p += kBandWarps) {
    const float n_p = (float)cnt[p];
    const Acc* srow = sums + (size_t)p * F;
    float* out = means + ((size_t)b * HW + p0 + p) * F;
    for (int c = lane; c < F; c += 32) {
      float s = (float)srow[c];
      if constexpr (MODE == kInt8) s = __fmul_rn(s, sc[c]);
      if constexpr (SUMS) {
        out[c] = s;
      } else {
        out[c] = n_p > 1.f ? __fdiv_rn(s, n_p) : s;
      }
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

// Lets `kernel` take up to the opt-in limit of dynamic shared memory once
// it asks for more than the default 48 KB (set once per kernel).
int allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  static const void* raised[32];
  static int n_raised = 0;
  for (int i = 0; i < n_raised; ++i) {
    if (raised[i] == kernel) return 0;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, device().optin);
  if (err != cudaSuccess) return (int)err;
  if (n_raised < 32) raised[n_raised++] = kernel;
  return 0;
}

template <typename T, bool PROJECT, bool ABSMAX>
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
    auto* kernel = raster_prepass_kernel<T, PROJECT, ABSMAX, V>;
    if (int err = allow_smem((const void*)kernel, smem)) return err;
    kernel<<<grid, kPrepassThreads, smem, st>>>(pcT, feat, ab, counts, scale,
                                                pix, K, F, h, w);
  } else {
    auto* kernel = raster_prepass_kernel<T, PROJECT, ABSMAX, 1>;
    if (int err = allow_smem((const void*)kernel, smem)) return err;
    kernel<<<grid, kPrepassThreads, smem, st>>>(pcT, feat, ab, counts, scale,
                                                pix, K, F, h, w);
  }
  CMR_RETURN_IF_ERROR();
  return 0;
}

// The band pass's shared memory, checked before any launch.
int band_pixels(int B, int F, int HW, int* P) {
  const Device& d = device();
  // P pixels a band: one 1024-thread block an SM, about one block per
  // SM in all (fewer bands only where a band's sums fill shared memory)
  const size_t fixed = band_layout(0, F).total;
  const size_t per_pixel = (size_t)F * 4 + 8;
  const size_t budget = (size_t)d.optin;
  if (budget < fixed + per_pixel) return CMR_ERR_SHARED_MEMORY;
  // a band pixel is a 16-bit bucket key
  const long long pmax = std::min((long long)((budget - fixed) / per_pixel),
                                  (long long)kMaxBucketSegments - 1);
  long long bands = (HW + pmax - 1) / pmax;
  bands = std::max(bands, (long long)std::max(1, d.sms / B));
  bands = std::min(bands, (long long)HW);
  *P = (int)((HW + bands - 1) / bands);
  return 0;
}

template <typename T, int MODE, bool GIVEN_IDS>
int band(const T* feat, const int* pix, const int* counts, const float* scale,
         float* means, float* cnt_out, int B, int K, int F, int HW, int P,
         bool sums, cudaStream_t st) {
  const int bands = (HW + P - 1) / P;
  const size_t smem = band_layout(P, F).total;
  auto* kernel = raster_band_kernel<T, MODE, GIVEN_IDS, false>;
  if constexpr (GIVEN_IDS) {
    if (sums) kernel = raster_band_kernel<T, MODE, true, true>;
  }
  if (int err = allow_smem((const void*)kernel, smem)) return err;
  dim3 grid((unsigned int)bands, B);
  kernel<<<grid, kBandThreads, smem, st>>>(feat, pix, counts, scale, means,
                                           cnt_out, K, F, HW, P);
  CMR_RETURN_IF_ERROR();
  return 0;
}

template <typename T, bool GIVEN_IDS>
int band_of_mode(int mode, const T* feat, const int* pix, const int* counts,
                 const float* scale, float* means, float* cnt_out, int B,
                 int K, int F, int HW, int P, bool sums, cudaStream_t st) {
  switch (mode) {
    case kF32:
      return band<T, kF32, GIVEN_IDS>(feat, pix, counts, scale, means,
                                      cnt_out, B, K, F, HW, P, sums, st);
    case kBF16:
      return band<T, kBF16, GIVEN_IDS>(feat, pix, counts, scale, means,
                                       cnt_out, B, K, F, HW, P, sums, st);
    default:
      return band<T, kInt8, GIVEN_IDS>(feat, pix, counts, scale, means,
                                       cnt_out, B, K, F, HW, P, sums, st);
  }
}

template <typename T>
int run_project(const float* pcT, const T* feat, int mode, const float* ab,
                const int* counts, float* scale, int* pix, float* means,
                float* cnt_out, int B, int K, int F, int h, int w,
                cudaStream_t st) {
  int P = 0;
  if (int err = band_pixels(B, F, h * w, &P)) return err;
  int err = mode == kInt8
                ? prepass<T, true, true>(pcT, feat, ab, counts, scale, pix, B,
                                         K, F, h, w, st)
                : prepass<T, true, false>(pcT, feat, ab, counts, scale, pix,
                                          B, K, F, h, w, st);
  if (err) return err;
  return band_of_mode<T, false>(mode, feat, pix, counts, scale, means,
                                cnt_out, B, K, F, h * w, P, false, st);
}

template <typename T>
int run_image(const T* feat, int mode, const int* ids, float* scale,
              float* out, float* cnt_out, int B, int K, int F, int HW,
              bool sums, cudaStream_t st) {
  int P = 0;
  if (int err = band_pixels(B, F, HW, &P)) return err;
  if (mode == kInt8) {
    if (int err = prepass<T, false, true>(nullptr, feat, nullptr, nullptr,
                                          scale, nullptr, B, K, F, 1, 1, st)) {
      return err;
    }
  }
  return band_of_mode<T, true>(mode, feat, ids, nullptr, scale, out,
                               cnt_out, B, K, F, HW, P, sums, st);
}

}  // namespace

// pcT [B, 3, K] f32; feat [B, K, F] of kind 0 = f32, 1 = bf16; mode 0 =
// f32, 1 = bf16, 2 = int8; ab [B, 12] f32; counts [B] int32; scale [B, F]
// f32, written (int8 only, else null); pix [B, K] int32 scratch; means
// [B, h*w, F] and cnt_out [B, h*w] f32, each element written once. Returns a
// cudaError_t, or CMR_ERR_ARGUMENT / CMR_ERR_SHARED_MEMORY (before any
// launch).
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
    return run_project(pcT, static_cast<const float*>(feat), mode, ab, counts,
                       scale, pix, means, cnt_out, B, K, F, h, w, st);
  }
  return run_project(pcT, static_cast<const __nv_bfloat16*>(feat), mode, ab,
                     counts, scale, pix, means, cnt_out, B, K, F, h, w, st);
}

// feat [B, K, F] of kind 0 = f32, 1 = bf16; mode 0 = f32, 1 = bf16, 2 =
// int8; ids [B, K] int32 (outside [0, HW) routed out); scale [B, F] f32,
// written (int8 only, else null); out [B, HW, F] (each pixel's means, or
// with sums != 0 its sums) and cnt_out [B, HW] f32, each element written
// once. Returns a cudaError_t, or CMR_ERR_ARGUMENT / CMR_ERR_SHARED_MEMORY
// (before any launch).
CMR_EXPORT int cmr_raster_image(const void* feat, int feat_kind, int mode,
                                const int* ids, float* scale, float* out,
                                float* cnt_out, int B, int K, int F, int HW,
                                int sums, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feat_kind < 0 || feat_kind > 1 || mode < kF32 || mode > kInt8 ||
      K < 1 || F < 1 || HW < 1 || (mode == kInt8 && scale == nullptr)) {
    return CMR_ERR_ARGUMENT;
  }
  if (B == 0) return 0;
  if (feat_kind == 0) {
    return run_image(static_cast<const float*>(feat), mode, ids, scale, out,
                     cnt_out, B, K, F, HW, sums != 0, st);
  }
  return run_image(static_cast<const __nv_bfloat16*>(feat), mode, ids, scale,
                   out, cnt_out, B, K, F, HW, sums != 0, st);
}
