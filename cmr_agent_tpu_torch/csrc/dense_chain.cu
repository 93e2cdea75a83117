// Fused pointwise dense chain: per point, L layers (1 <= L <= 3) of
// acc_i = leaky(h_{i-1} W_i + b_i, slope_i), h_i = acc_i rounded to the
// compute type T, then a residual added to the last acc in f32 ("identity":
// x; "proj": s = x Wr + br; "identity_split": the virtual concat(x,
// pooled)), the final slope, and
// one rounding to T. Optionally the per-(sample, channel) max of the final
// f32 acc over the N points. T is f32 or bf16; the products of T values
// are summed in f32 (bf16 products are exact in f32) and biases are f32
// rows of [B, C] (the agent's pooled half of each split kernel rides a
// per-sample bias).
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:fused_dense_chain
// (_chain_kernel, pallas_call at :1119) and fused_dense_chain_cn
// (_chain_cn_kernel, :1327): the geo model's MiniPointNet / ResDenseBlock
// stacks and the agent's four 3-D stages with BatchNorm folded in, eval
// mode. In f32 the rounding points follow _chain_kernel (:983-1010) step
// by step, acc + (x Wr + br) included; in bf16 all but one: the
// projection's products accumulate onto the activated acc, then br (a
// separate s would double the accumulator registers, and the output's one
// bf16 rounding is 2^16 times coarser than the f32 sums' order). The
// out_max epilogue masks the rows past N as :1013-1025 does.
//
// Bound on the H100: bytes for bf16 (at the geo model's point_fuse_0 shape,
// B=8, N=40960, 128 -> 128 -> 64 plus a 128 -> 64 projection, 126 MB of
// input and output against 21.5 GFLOP: 38 us of HBM, 22 us of bf16 tensor
// cores), operations for the wide f32 chains (0.32 ms at 67 TFLOP/s of f32
// on the CUDA cores). Two kernels, both persistent: a grid of at most a few
// blocks per SM, each staging every layer's weights (and the projection's)
// in shared memory once, then walking over tiles of points. Each keeps the
// current sample's bias rows in shared memory too: beside 227 KB of shared
// memory the L1 is too small to keep them, and global loads there came
// back at L2 latency, serialised in the epilogues.
//
// bf16, chain_mma_kernel: the layer products run on the tensor cores as
// mma.sync.m16n8k16 (bf16 x bf16 -> f32). Each warp owns 16 points at a
// time (up to 16 warps a block, as shared memory allows) and walks its own
// contiguous range of 16-point tiles. Its input tile arrives by cp.async
// into one of two per-warp buffers while the previous tile is computed.
// The weights sit in shared memory in fragment order (packed by the Python
// wrapper: each dim zero-padded to 16, 32, 64 or 128, [k-tile][n-tile]
// [lane] pairs of 32-bit words), so each B fragment is one conflict-free
// 8-byte load; the A fragments come by ldmatrix from the warp's input tile
// (row-major [16][C0+8], or channel-major [C0][24] through ldmatrix.trans)
// or its activation tile. A layer runs in chunks of up to 8 n-tiles (64
// columns) whose f32 accumulators stay in registers through bias and
// LeakyReLU; h_l goes to the warp's activation tile in bf16 (two tiles,
// ping-pong), the next layer's A. The k loop is rolled and the n-tile
// count a template parameter, so the code stays small and unguarded. The
// proj residual is one more product on the input tile, onto the last
// layer's activated accumulators (the one step in another order than
// _chain_kernel's, above); identity adds the input tile, and
// identity_split adds it below C0 and pooled above. The output is staged
// per warp in the layout of the store and written with 16-byte stores.
// Narrow inputs (C0 = 3, 5) are zero-padded to k = 16 in shared memory.
//
// f32, chain_f32_kernel: CUDA-core FMAs (the 1e-5 gate rules out TF32).
// 256 threads per 64-point tile; the tile's input and the activations stay
// channel-major in shared memory, each thread owns 4 points x 8 columns
// and reads them as float4s, so a k step is 3 shared loads for 32 FMAs.
// The proj residual parks the activated acc in the activation tile while
// s = x Wr + br takes the registers, then adds the two.
//
// out_max: the running column max of the final f32 acc is kept per warp
// (bf16) or per thread (f32) across the tiles of one sample, and written
// with one ordered-int atomic per (warp or thread, sample, column) when the
// sample changes or the walk ends (-inf initialised by the caller).

#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxC = 128;           // widest layer
constexpr int kMaxLayers = 3;
constexpr int kSmemLimit = 232448;   // a block's shared memory, 227 KB
constexpr int kSmemStatic = 256;     // room for the kernels' static arrays
// one sample's bias rows (3 layers and a projection) and pooled row, f32
constexpr int kRowFloats = 4 * 128 + 128;

enum Residual { kNone = 0, kIdentity = 1, kProj = 2, kIdentitySplit = 3 };

struct ChainArgs {
  const void* x;        // [B, N, C0] (nc) or [B, C0, N] (cn), type T
  const void* w;        // the packed weights (see the wrapper), type T
  const float* bias;    // [B, bias_stride]: b_1 .. b_L (then br) per sample
  const float* pooled;  // [B, C_L - C0] f32 (identity_split), else null
  void* out;            // like x with C_L channels, type T
  float* out_max;       // [B, C_L] f32, -inf initialised, or null
  int B, N, n_layers, residual, bias_stride;
  int dims[4];          // C0, C1, .., C_L
  float slopes[3];      // 1 = no activation (leaky with slope 1 is x)
  float final_slope;
};

__device__ inline float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// Orders floats as ints for atomicMax / atomicMin (NaN ignored).
__device__ inline void atomic_max_float(float* addr, float v) {
  if (v >= 0.f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// Sample b's bias rows and (identity_split) pooled row into `row` (shared
// memory), `lanes` threads from `lane`: the epilogues read them there, not
// from global memory, whose loads through the small L1 left beside 227 KB
// of shared memory come back at L2 latency.
__device__ inline void stage_rows(float* row, const ChainArgs& a, int b,
                                  int pooled_n, int lane, int lanes) {
  const float* src = a.bias + (size_t)b * a.bias_stride;
  for (int i = lane; i < a.bias_stride; i += lanes) row[i] = src[i];
  for (int i = lane; i < pooled_n; i += lanes) {
    row[a.bias_stride + i] = a.pooled[(size_t)b * pooled_n + i];
  }
}

// A warp's column maxima of one sample, mxs [cout], into out_max row b.
__device__ inline void flush_max(float* out_max, int b, int cout,
                                 const float* mxs, int lane) {
  __syncwarp();
  for (int c = lane; c < cout; c += 32) {
    atomic_max_float(&out_max[(size_t)b * cout + c], mxs[c]);
  }
  __syncwarp();
}

// A width padded for the tensor-core kernel: 16, 32, 64 or 128.
__host__ __device__ inline int pad_pow2(int c) {
  return c <= 16 ? 16 : c <= 32 ? 32 : c <= 64 ? 64 : 128;
}

// The slice [first, last) of `total` work items that worker `id` of
// `workers` walks: contiguous, so a worker crosses few sample boundaries.
__device__ inline void work_range(int total, int id, int workers, int& first,
                                  int& last) {
  const int per = (total + workers - 1) / workers;
  first = min(id * per, total);
  last = min(first + per, total);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 0;
      return 132;
    }
  }
  return sms;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpRows = 16;         // points per warp tile (one m16 tile)
constexpr int kMmaWarps = 16;         // warps per block at most
constexpr int kCnStride = kWarpRows + 8;  // channel-major tile row, bf16

struct MmaPlan {
  int kp[4];          // the dims padded to 16, 32, 64 or 128
  int w_off[4];       // offsets (in 8-byte words) of W_1 .. W_L
  int w_words;        // 8-byte words of packed weights
  int x_elems;        // bf16 elements of one input tile buffer
  int h_elems;        // bf16 elements of one activation / staging tile
  int warp_bytes;     // shared bytes per warp (2 input, 2 activation tiles,
                      // the column max, one sample's bias and pooled rows)
  int tiles_n;        // 16-point tiles per sample
  int vec_in, vec_out;
  int c_out, kp_out;  // C_L and its padded width
  int w_res;          // offset of Wr
};

// bf16 elements of a warp's tile of `cp` (padded) channels.
__host__ __device__ inline int tile_elems(bool cn, int cp) {
  return cn ? cp * kCnStride : kWarpRows * (cp + 8);
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read).
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col), f32.
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc[nt] += A . W for the NNT n-tiles nt0 .. nt0 + NNT - 1 of a layer of
// `ntl` n-tiles, over `nkt` k-tiles. A is a warp's [16, 16 nkt] bf16 tile in
// shared memory, read one k-tile at a time with ldmatrix: row-major with
// row stride `stride`, or (TRANS) channel-major [16 nkt][kCnStride]. w is
// the layer's weights in fragment order [kt][nt][lane].
template <bool TRANS, int NNT>
__device__ __forceinline__ void tile_mma(float (&acc)[8][4],
                                         const __nv_bfloat16* a, int stride,
                                         int nkt, const uint2* w, int ntl,
                                         int nt0, int lane) {
  const int j = lane >> 3, r = lane & 7;
  const __nv_bfloat16* ap =
      TRANS ? a + ((j >> 1) * 8 + r) * kCnStride + (j & 1) * 8
            : a + ((j & 1) * 8 + r) * stride + (j >> 1) * 8;
  const int a_step = TRANS ? 16 * kCnStride : 16;
  w += nt0 * 32 + lane;
#pragma unroll 2
  for (int kt = 0; kt < nkt; ++kt) {
    uint32_t f[4];
    if (TRANS) {
      ldmatrix_x4_trans(f, ap + kt * a_step);
    } else {
      ldmatrix_x4(f, ap + kt * a_step);
    }
    uint2 bf[NNT];
#pragma unroll
    for (int nt = 0; nt < NNT; ++nt) bf[nt] = w[(kt * ntl + nt) * 32];
#pragma unroll
    for (int nt = 0; nt < NNT; ++nt) mma_bf16(acc[nt], f, bf[nt]);
  }
}

// One chunk of NNT n-tiles (8 columns each, from n-tile nt0) of layer l
// for a warp's 16 points: the product on the tensor cores, the bias and
// slope, then either h_l rounded to bf16 into the activation tile `hout`,
// or (the last layer) the residual (RES), the final slope, the column max
// into `mxs` (when not null) and the output rounded to bf16 into the
// staging tile `hout`, channel-major when CN. `brow` is the layer's bias
// and `radd` the residual's row, both zero-padded in shared memory, so no
// column needs a guard.
template <bool CN, int RES, int NNT>
__device__ __forceinline__ void chain_chunk(
    bool first_layer, bool last_layer, const __nv_bfloat16* xs, int xstride,
    int nkt0, const __nv_bfloat16* hin, int in_stride, int nkt,
    const uint2* wl, const uint2* wres, int ntl, int nt0, const float* brow,
    float slope, const float* radd, float final_slope, int c0, int rows,
    float* mxs, __nv_bfloat16* hout, int out_stride, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < NNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  if (first_layer) {
    tile_mma<CN, NNT>(acc, xs, xstride, nkt, wl, ntl, nt0, lane);
  } else {
    tile_mma<false, NNT>(acc, hin, in_stride, nkt, wl, ntl, nt0, lane);
  }
#pragma unroll
  for (int nt = 0; nt < NNT; ++nt) {
    const float2 bv =
        *reinterpret_cast<const float2*>(brow + (nt0 + nt) * 8 + 2 * t);
    acc[nt][0] = leaky(acc[nt][0] + bv.x, slope);
    acc[nt][1] = leaky(acc[nt][1] + bv.y, slope);
    acc[nt][2] = leaky(acc[nt][2] + bv.x, slope);
    acc[nt][3] = leaky(acc[nt][3] + bv.y, slope);
  }
  if (last_layer) {
    // the residual in f32: the projection's products accumulate onto the
    // activated acc; radd holds its bias, or the pooled half of the
    // virtual concat, or zeros
    if (RES == kProj) {
      tile_mma<CN, NNT>(acc, xs, xstride, nkt0, wres, ntl, nt0, lane);
    }
#pragma unroll
    for (int nt = 0; nt < NNT; ++nt) {
      const int c = (nt0 + nt) * 8 + 2 * t;
      const float2 rv = *reinterpret_cast<const float2*>(radd + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        float v0 = acc[nt][2 * half] + rv.x;
        float v1 = acc[nt][2 * half + 1] + rv.y;
        if (RES == kIdentity || RES == kIdentitySplit) {
          // x at (row, c), zero past C0 in the tile; identity_split reads
          // the tile only below C0
          if (RES == kIdentity || c < c0) {
            float x0, x1;
            if (CN) {
              x0 = __bfloat162float(xs[c * kCnStride + row]);
              x1 = __bfloat162float(xs[(c + 1) * kCnStride + row]);
            } else {
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      xs + row * xstride + c));
              x0 = xv.x;
              x1 = xv.y;
            }
            v0 += x0;
            v1 += (RES == kIdentity || c + 1 < c0) ? x1 : 0.f;
          }
        }
        acc[nt][2 * half] = leaky(v0, final_slope);
        acc[nt][2 * half + 1] = leaky(v1, final_slope);
      }
    }
    if (mxs != nullptr) {
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt) {
        // this lane's two rows, then the other rows: the lanes with the
        // same t
        float m0 = fmaxf(g < rows ? acc[nt][0] : -INFINITY,
                         g + 8 < rows ? acc[nt][2] : -INFINITY);
        float m1 = fmaxf(g < rows ? acc[nt][1] : -INFINITY,
                         g + 8 < rows ? acc[nt][3] : -INFINITY);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
        }
        if (g == 0) {
          const int c = (nt0 + nt) * 8 + 2 * t;
          mxs[c] = fmaxf(mxs[c], m0);
          mxs[c + 1] = fmaxf(mxs[c + 1], m1);
        }
      }
    }
  }
  // rounded to bf16 into the activation (or staging) tile
#pragma unroll
  for (int nt = 0; nt < NNT; ++nt) {
    const int c = (nt0 + nt) * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = g + 8 * half;
      const __nv_bfloat162 pr =
          __floats2bfloat162_rn(acc[nt][2 * half], acc[nt][2 * half + 1]);
      if (CN && last_layer) {
        hout[c * kCnStride + row] = pr.x;
        hout[(c + 1) * kCnStride + row] = pr.y;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(hout + row * out_stride + c) = pr;
      }
    }
  }
}

// A warp's input tile for work item `item` into `dst`: cp.async 16-byte
// chunks where the layout allows, element copies otherwise (which also
// write the zero padding of the channels past C0).
template <bool CN>
__device__ inline void load_x_tile(__nv_bfloat16* dst,
                                   const __nv_bfloat16* x, int item,
                                   const ChainArgs& a, const MmaPlan& p,
                                   int lane) {
  const int b = item / p.tiles_n, n0 = (item % p.tiles_n) * kWarpRows;
  const int c0 = a.dims[0], k0 = p.kp[0];
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (CN) {
    const __nv_bfloat16* xb = x + (size_t)b * c0 * a.N;
    if (p.vec_in) {  // N % 8 == 0: a channel's 16 points are 2 chunks
      for (int i = lane; i < c0 * 2; i += 32) {
        const int c = i >> 1, n = n0 + 8 * (i & 1);
        const bool ok = n < a.N;
        cp_async16(dst + c * kCnStride + 8 * (i & 1),
                   ok ? xb + (size_t)c * a.N + n : x, ok);
      }
    } else {
      for (int i = lane; i < k0 * kWarpRows; i += 32) {
        const int c = i / kWarpRows, r = i % kWarpRows;
        dst[c * kCnStride + r] = (c < c0 && n0 + r < a.N)
                                     ? xb[(size_t)c * a.N + n0 + r]
                                     : zero;
      }
    }
  } else {
    const __nv_bfloat16* xb = x + ((size_t)b * a.N + n0) * c0;
    const int stride = k0 + 8;
    if (p.vec_in) {  // C0 % 8 == 0: a point's channels are C0 / 8 chunks
      const int chunks = c0 / 8;
      for (int i = lane; i < kWarpRows * chunks; i += 32) {
        const int r = i / chunks, j = i % chunks;
        const bool ok = n0 + r < a.N;
        cp_async16(dst + r * stride + 8 * j,
                   ok ? xb + (size_t)r * c0 + 8 * j : x, ok);
      }
    } else {
      for (int i = lane; i < kWarpRows * k0; i += 32) {
        const int r = i / k0, c = i % k0;
        dst[r * stride + c] =
            (c < c0 && n0 + r < a.N) ? xb[(size_t)r * c0 + c] : zero;
      }
    }
  }
}

template <bool CN, int RES>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
    chain_mma_kernel(ChainArgs a, MmaPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint2* ws = reinterpret_cast<const uint2*>(smem);
  unsigned char* wbase = smem + (size_t)p.w_words * 8;
  // per warp: two input tiles, two activation tiles, the column max, the
  // current sample's bias and pooled rows
  __nv_bfloat16* xbuf =
      reinterpret_cast<__nv_bfloat16*>(wbase + (size_t)warp * p.warp_bytes);
  __nv_bfloat16* hbuf = xbuf + 2 * p.x_elems;
  float* mxs = reinterpret_cast<float*>(hbuf + 2 * p.h_elems);  // [kMaxC]
  float* rowbuf = mxs + (a.out_max != nullptr ? kMaxC : 0);  // kRowFloats
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const int L = a.n_layers, c0 = a.dims[0], cout = p.c_out;
  const int xstride = p.kp[0] + 8;
  // the per-layer values, indexed by the layer at run time: in shared
  // memory (a kernel parameter indexed at run time goes to local memory,
  // which the small L1 beside 227 KB of shared memory cannot hold)
  __shared__ int s_kp[4], s_woff[4], s_dims[4], s_boff[4];
  __shared__ float s_slope[4];
  if (threadIdx.x == 0) {
    int off = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s_kp[i] = p.kp[i];
      s_woff[i] = p.w_off[i];
      s_dims[i] = a.dims[i];
      s_slope[i] = i < kMaxLayers ? a.slopes[i] : 1.f;
      s_boff[i] = off;   // layer i's bias in the staged row
      if (i < kMaxLayers) off += p.kp[i + 1];
    }
  }

  // every layer's weights once, then zero the tiles (the padded channels
  // of the input buffers are never written again)
  {
    const uint4* src = static_cast<const uint4*>(a.w);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < p.w_words / 2; i += blockDim.x) {
      dst[i] = src[i];
    }
    uint4* tiles = reinterpret_cast<uint4*>(wbase);
    const int n16 = warps * p.warp_bytes / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x) {
      tiles[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();

  int first, last;
  work_range(a.B * p.tiles_n, blockIdx.x * warps + warp, gridDim.x * warps,
             first, last);
  int mx_b = -1, row_b = -1;

  if (first < last) load_x_tile<CN>(xbuf, x, first, a, p, lane);
  cp_async_commit();
  int cur = 0;
  for (int item = first; item < last; ++item) {
    const __nv_bfloat16* xs = xbuf + cur * p.x_elems;
    if (item + 1 < last) {
      load_x_tile<CN>(xbuf + (cur ^ 1) * p.x_elems, x, item + 1, a, p, lane);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();
    const int b = item / p.tiles_n, n0 = (item % p.tiles_n) * kWarpRows;
    const int rows = min(kWarpRows, a.N - n0);
    if (a.out_max != nullptr && b != mx_b) {
      if (mx_b >= 0) flush_max(a.out_max, mx_b, cout, mxs, lane);
      for (int c = lane; c < kMaxC; c += 32) mxs[c] = -INFINITY;
      mx_b = b;
      __syncwarp();
    }

    if (b != row_b) {
      // sample b's biases, each zero-padded to its layer's padded width,
      // then the residual's row (its bias, or the pooled half of the
      // virtual concat, or zeros)
      __syncwarp();
      const float* src = a.bias + (size_t)b * a.bias_stride;
      for (int l = 0; l < L; ++l) {
        const int cl = s_dims[l + 1];
        for (int i = lane; i < s_kp[l + 1]; i += 32) {
          rowbuf[s_boff[l] + i] = i < cl ? src[i] : 0.f;
        }
        src += cl;
      }
      float* radd = rowbuf + s_boff[L];
      for (int i = lane; i < p.kp_out; i += 32) {
        float v = 0.f;
        if (RES == kProj && i < cout) v = src[i];
        if (RES == kIdentitySplit && i >= c0 && i < cout) {
          v = a.pooled[(size_t)b * (cout - c0) + i - c0];
        }
        radd[i] = v;
      }
      row_b = b;
      __syncwarp();
    }
    // layer l reads the input tile (l = 0) or activation tile (l - 1) & 1
    // and writes activation tile l & 1; the last layer writes its output
    // there, staged in the layout of the store
    for (int l = 0; l < L; ++l) {
      const int nkt = s_kp[l] / 16, ntl = s_kp[l + 1] / 8;
      const int in_stride = s_kp[l] + 8, out_stride = s_kp[l + 1] + 8;
      const __nv_bfloat16* hin = hbuf + ((l - 1) & 1) * p.h_elems;
      __nv_bfloat16* hout = hbuf + (l & 1) * p.h_elems;
      const uint2* wl = ws + s_woff[l];
      const bool first_layer = l == 0, last_layer = l == L - 1;
      const float* brow = rowbuf + s_boff[l];
      const float* radd = rowbuf + s_boff[L];
      float* mx = a.out_max != nullptr ? mxs : nullptr;
#pragma unroll 1
      for (int nt0 = 0; nt0 < ntl; nt0 += 8) {
        if (ntl == 2) {
          chain_chunk<CN, RES, 2>(first_layer, last_layer, xs, xstride,
                                  p.kp[0] / 16, hin, in_stride, nkt, wl,
                                  ws + p.w_res, ntl, nt0, brow, s_slope[l],
                                  radd, a.final_slope, c0, rows, mx, hout,
                                  out_stride, lane);
        } else if (ntl == 4) {
          chain_chunk<CN, RES, 4>(first_layer, last_layer, xs, xstride,
                                  p.kp[0] / 16, hin, in_stride, nkt, wl,
                                  ws + p.w_res, ntl, nt0, brow, s_slope[l],
                                  radd, a.final_slope, c0, rows, mx, hout,
                                  out_stride, lane);
        } else {
          chain_chunk<CN, RES, 8>(first_layer, last_layer, xs, xstride,
                                  p.kp[0] / 16, hin, in_stride, nkt, wl,
                                  ws + p.w_res, ntl, nt0, brow, s_slope[l],
                                  radd, a.final_slope, c0, rows, mx, hout,
                                  out_stride, lane);
        }
      }
      __syncwarp();  // the tile is written before any lane reads it
    }

    // the staged tile out, 16 bytes a lane where the layout allows
    const __nv_bfloat16* ost = hbuf + ((L - 1) & 1) * p.h_elems;
    if (CN) {
      __nv_bfloat16* ob = out + (size_t)b * cout * a.N + n0;
      if (p.vec_out) {
        for (int i = lane; i < cout * 2; i += 32) {
          const int c = i >> 1, j = i & 1;
          if (8 * j < rows) {
            *reinterpret_cast<uint4*>(ob + (size_t)c * a.N + 8 * j) =
                *reinterpret_cast<const uint4*>(ost + c * kCnStride + 8 * j);
          }
        }
      } else {
        for (int i = lane; i < cout * kWarpRows; i += 32) {
          const int c = i / kWarpRows, r = i % kWarpRows;
          if (r < rows) ob[(size_t)c * a.N + r] = ost[c * kCnStride + r];
        }
      }
    } else {
      __nv_bfloat16* ob = out + ((size_t)b * a.N + n0) * cout;
      const int stride = p.kp_out + 8;
      if (p.vec_out) {
        const int chunks = cout / 8;
        for (int i = lane; i < rows * chunks; i += 32) {
          const int r = i / chunks, j = i % chunks;
          *reinterpret_cast<uint4*>(ob + (size_t)r * cout + 8 * j) =
              *reinterpret_cast<const uint4*>(ost + r * stride + 8 * j);
        }
      } else {
        for (int i = lane; i < rows * cout; i += 32) {
          const int r = i / cout, c = i % cout;
          ob[i] = ost[r * stride + c];
        }
      }
    }
    __syncwarp();
    cur ^= 1;
  }
  if (a.out_max != nullptr && mx_b >= 0) {
    flush_max(a.out_max, mx_b, cout, mxs, lane);
  }
}

template <bool CN, int RES>
int launch_mma(const ChainArgs& a, cudaStream_t st) {
  MmaPlan p{};
  const int L = a.n_layers;
  for (int l = 0; l <= L; ++l) p.kp[l] = pad_pow2(a.dims[l]);
  int off = 0, kmax = 0;
  for (int l = 0; l < L; ++l) {
    p.w_off[l] = off;
    off += (p.kp[l] / 16) * (p.kp[l + 1] / 8) * 32;
    kmax = std::max(kmax, p.kp[l + 1]);
  }
  if (a.residual == kProj) {
    p.w_res = off;
    off += (p.kp[0] / 16) * (p.kp[L] / 8) * 32;
  }
  p.c_out = a.dims[L];
  p.kp_out = p.kp[L];
  p.w_words = off;
  p.x_elems = tile_elems(CN, p.kp[0]);
  p.h_elems = std::max(tile_elems(false, kmax), tile_elems(CN, p.kp[L]));
  p.warp_bytes = (2 * p.x_elems + 2 * p.h_elems) * 2 +
                 (a.out_max != nullptr ? kMaxC * 4 : 0) + kRowFloats * 4;
  p.tiles_n = (a.N + kWarpRows - 1) / kWarpRows;
  const bool x16 = reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const bool o16 = reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  p.vec_in = x16 && (CN ? a.N % 8 == 0 : a.dims[0] % 8 == 0);
  p.vec_out = o16 && (CN ? a.N % 8 == 0 : a.dims[L] % 8 == 0);
  if (reinterpret_cast<uintptr_t>(a.w) % 16 != 0) return -1;
  const int wbytes = p.w_words * 8;
  const int warps = std::min(
      kMmaWarps, (kSmemLimit - kSmemStatic - wbytes) / p.warp_bytes);
  if (warps < 1) return CMR_ERR_SHARED_MEMORY;
  const int smem = wbytes + warps * p.warp_bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_mma_kernel<CN, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit - kSmemStatic);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  static int last_smem = -1, last_warps = -1, per_sm = 0;
  if (smem != last_smem || warps != last_warps) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chain_mma_kernel<CN, RES>, warps * 32, smem);
    if (err != cudaSuccess) return (int)err;
    last_smem = smem;
    last_warps = warps;
  }
  const long long items = (long long)a.B * p.tiles_n;
  const long long want = (items + warps - 1) / warps;
  const int grid = (int)std::min<long long>(
      want, (long long)sm_count() * std::max(per_sm, 1));
  chain_mma_kernel<CN, RES><<<grid, warps * 32, smem, st>>>(a, p);
  CMR_RETURN_IF_ERROR();
  return 0;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;               // points per tile
constexpr int kF32Stride = kF32Rows + 4;   // a channel's row, floats
constexpr int kF32Threads = 256;           // 16 x 16: 4 points x 8 columns
constexpr int kF32TileFloats = kMaxC * kF32Stride;

struct F32Plan {
  int np[4];      // the dims' padded widths in the packed weights: 64, 128
  int w_off[4];   // float offsets of W_1 .. W_L
  int w_floats;
  int tiles_n;    // 64-point tiles per sample
  int vec_out;
  int c_out, np_out, w_res;  // C_L, its padded width, the offset of Wr
};

__host__ __device__ inline int f32_width(int c) { return c <= 64 ? 64 : 128; }

// acc[i][j] += sum_k src[k][4 ty + i] w[k][col_j], col_j = 4 tx + j and
// (WIDE) 64 + 4 tx + j - 4; src channel-major [k][kF32Stride], w [K, np].
template <bool WIDE>
__device__ inline void f32_matmul(const float* src, const float* w, int K,
                                  int np, int tx, int ty,
                                  float (&acc)[4][8]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 hv =
        *reinterpret_cast<const float4*>(src + k * kF32Stride + 4 * ty);
    const float4 w0 = *reinterpret_cast<const float4*>(w + k * np + 4 * tx);
    const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
    float wc[8] = {w0.x, w0.y, w0.z, w0.w, 0.f, 0.f, 0.f, 0.f};
    if (WIDE) {
      const float4 w1 =
          *reinterpret_cast<const float4*>(w + k * np + 64 + 4 * tx);
      wc[4] = w1.x;
      wc[5] = w1.y;
      wc[6] = w1.z;
      wc[7] = w1.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < (WIDE ? 8 : 4); ++j) {
        acc[i][j] = fmaf(hr[i], wc[j], acc[i][j]);
      }
    }
  }
}

__device__ inline void f32_layer(const float* src, const float* w, int K,
                                 int np, int tx, int ty,
                                 float (&acc)[4][8]) {
  if (np > 64) {
    f32_matmul<true>(src, w, K, np, tx, ty, acc);
  } else {
    f32_matmul<false>(src, w, K, np, tx, ty, acc);
  }
}

// the column of register j of thread tx
__device__ inline int f32_col(int tx, int j) {
  return j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4;
}

template <bool CN>
__global__ void __launch_bounds__(kF32Threads, 2)
    chain_f32_kernel(ChainArgs a, F32Plan p) {
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                   // [kMaxC][kF32Stride] the input
  float* hs = xs + kF32TileFloats;   // [kMaxC][kF32Stride] activations
  float* rowbuf = hs + kF32TileFloats;  // the sample's bias, pooled rows
  float* ws = rowbuf + kRowFloats;   // the packed weights
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int L = a.n_layers, c0 = a.dims[0], cout = p.c_out;
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);
  {
    const float4* src = static_cast<const float4*>(a.w);
    float4* dst = reinterpret_cast<float4*>(ws);
    for (int i = tid; i < p.w_floats / 4; i += kF32Threads) dst[i] = src[i];
  }

  int first, last;
  work_range(a.B * p.tiles_n, blockIdx.x, gridDim.x, first, last);
  float mx[8];
  int mx_b = -1, row_b = -1;
  const int pooled_n = a.residual == kIdentitySplit ? cout - c0 : 0;
  for (int tile = first; tile < last; ++tile) {
    const int b = tile / p.tiles_n, n0 = (tile % p.tiles_n) * kF32Rows;
    const int rows = min(kF32Rows, a.N - n0);
    if (a.out_max != nullptr && b != mx_b) {
      if (mx_b >= 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = f32_col(tx, j);
          if (c < cout) atomic_max_float(&a.out_max[(size_t)mx_b * cout + c],
                                         mx[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) mx[j] = -INFINITY;
      mx_b = b;
    }
    __syncthreads();  // the weights are in; the last tile is done with xs
    if (b != row_b) {
      stage_rows(rowbuf, a, b, pooled_n, tid, kF32Threads);
      row_b = b;
    }
    if (CN) {
      const float* xb = x + (size_t)b * c0 * a.N + n0;
      for (int i = tid; i < c0 * kF32Rows; i += kF32Threads) {
        const int c = i / kF32Rows, r = i % kF32Rows;
        xs[c * kF32Stride + r] = r < rows ? xb[(size_t)c * a.N + r] : 0.f;
      }
    } else {
      const float* xb = x + ((size_t)b * a.N + n0) * c0;
      for (int i = tid; i < kF32Rows * c0; i += kF32Threads) {
        const int r = i / c0, c = i % c0;
        xs[c * kF32Stride + r] = r < rows ? xb[i] : 0.f;
      }
    }
    __syncthreads();

    const float* bias = rowbuf;
    float acc[4][8];
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l >= L) break;
      const int cl = a.dims[l + 1], np = p.np[l + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
      f32_layer(l == 0 ? xs : hs, ws + p.w_off[l], a.dims[l], np, tx, ty,
                acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = f32_col(tx, j);
        const float bv = c < cl ? bias[c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = leaky(acc[i][j] + bv, a.slopes[l]);
        }
      }
      bias += cl;
      if (l + 1 < L) {
        __syncthreads();  // every thread is done reading hs
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = f32_col(tx, j);
          if (c < np) {
            *reinterpret_cast<float4*>(hs + c * kF32Stride + 4 * ty) =
                make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          }
        }
        __syncthreads();
      }
    }
    // bias now points at br. The projection as _chain_kernel takes it:
    // s = x Wr + br in its own accumulators, then acc + s. The activated
    // acc waits in hs meanwhile (each thread reads back only its own
    // cells), which keeps the registers at one [4][8] set.
    if (a.residual == kProj) {
      __syncthreads();  // every thread is done reading hs
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = f32_col(tx, j);
        float4 v = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        *reinterpret_cast<float4*>(hs + c * kF32Stride + 4 * ty) = v;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = 0.f;
      }
      f32_layer(xs, ws + p.w_res, c0, p.np_out, tx, ty, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = f32_col(tx, j);
        const float bv = c < cout ? bias[c] : 0.f;
        const float4 y =
            *reinterpret_cast<const float4*>(hs + c * kF32Stride + 4 * ty);
        acc[0][j] = y.x + (acc[0][j] + bv);
        acc[1][j] = y.y + (acc[1][j] + bv);
        acc[2][j] = y.z + (acc[2][j] + bv);
        acc[3][j] = y.w + (acc[3][j] + bv);
      }
    } else if (a.residual == kIdentity || a.residual == kIdentitySplit) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = f32_col(tx, j);
        if (c >= cout) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] += c < c0 ? xs[c * kF32Stride + 4 * ty + i]
                              : rowbuf[a.bias_stride + c - c0];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = leaky(acc[i][j], a.final_slope);
    }
    if (a.out_max != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (4 * ty + i < rows) mx[j] = fmaxf(mx[j], acc[i][j]);
        }
      }
    }
    if (CN) {
      float* ob = out + (size_t)b * cout * a.N + n0 + 4 * ty;
      const bool full = p.vec_out && 4 * ty + 4 <= rows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = f32_col(tx, j);
        if (c >= cout) continue;
        float* o = ob + (size_t)c * a.N;
        if (full) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * ty + i < rows) o[i] = acc[i][j];
          }
        }
      }
    } else {
      float* ob = out + ((size_t)b * a.N + n0) * cout;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        if (r >= rows) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = f32_col(tx, 4 * q);
          if (c >= cout) continue;
          float* o = ob + (size_t)r * cout + c;
          if (p.vec_out) {
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                            acc[i][4 * q + 2], acc[i][4 * q + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (c + j < cout) o[j] = acc[i][4 * q + j];
            }
          }
        }
      }
    }
  }
  if (a.out_max != nullptr && mx_b >= 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = f32_col(tx, j);
      if (c < cout) atomic_max_float(&a.out_max[(size_t)mx_b * cout + c],
                                     mx[j]);
    }
  }
}

template <bool CN>
int launch_f32(const ChainArgs& a, cudaStream_t st) {
  F32Plan p{};
  const int L = a.n_layers;
  for (int l = 0; l <= L; ++l) p.np[l] = f32_width(a.dims[l]);
  int off = 0;
  for (int l = 0; l < L; ++l) {
    p.w_off[l] = off;
    off += a.dims[l] * p.np[l + 1];
  }
  if (a.residual == kProj) {
    p.w_res = off;
    off += a.dims[0] * p.np[L];
  }
  p.c_out = a.dims[L];
  p.np_out = p.np[L];
  p.w_floats = (off + 3) & ~3;
  p.tiles_n = (a.N + kF32Rows - 1) / kF32Rows;
  const bool o16 = reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  p.vec_out = o16 && (CN ? a.N % 4 == 0 : a.dims[L] % 4 == 0);
  if (reinterpret_cast<uintptr_t>(a.w) % 16 != 0) return -1;
  const int smem = (2 * kF32TileFloats + kRowFloats + p.w_floats) *
                   (int)sizeof(float);
  if (smem > kSmemLimit) return CMR_ERR_SHARED_MEMORY;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_f32_kernel<CN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  static int last_smem = -1, per_sm = 0;
  if (smem != last_smem) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chain_f32_kernel<CN>, kF32Threads, smem);
    if (err != cudaSuccess) return (int)err;
    last_smem = smem;
  }
  const long long tiles = (long long)a.B * p.tiles_n;
  const int grid = (int)std::min<long long>(
      tiles, (long long)sm_count() * std::max(per_sm, 1));
  chain_f32_kernel<CN><<<grid, kF32Threads, smem, st>>>(a, p);
  CMR_RETURN_IF_ERROR();
  return 0;
}

template <bool CN>
int dense_chain(const void* x, int x_kind, const void* w, const float* bias,
                const float* pooled, void* out, float* out_max, int B, int N,
                int n_layers, int c0, int c1, int c2, int c3, int residual,
                float s0, float s1, float s2, float final_slope,
                cudaStream_t st) {
  ChainArgs a{x, w, bias, pooled, out, out_max, B, N, n_layers, residual, 0,
              {c0, c1, c2, c3}, {s0, s1, s2}, final_slope};
  if (n_layers < 1 || n_layers > kMaxLayers || residual < kNone ||
      residual > kIdentitySplit || N < 1 || B < 1) {
    return -1;
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (a.dims[l] < 1 || a.dims[l] > kMaxC) return -1;
    if (l > 0) a.bias_stride += a.dims[l];
  }
  if (residual == kProj) a.bias_stride += a.dims[n_layers];
  if (residual == kIdentitySplit &&
      (pooled == nullptr || c0 >= a.dims[n_layers])) {
    return -1;
  }
  if (residual == kIdentity && c0 != a.dims[n_layers]) return -1;
  switch (x_kind) {
    case 0:
      return launch_f32<CN>(a, st);
    case 1:
      switch (residual) {
        case kNone:
          return launch_mma<CN, kNone>(a, st);
        case kIdentity:
          return launch_mma<CN, kIdentity>(a, st);
        case kProj:
          return launch_mma<CN, kProj>(a, st);
        default:
          return launch_mma<CN, kIdentitySplit>(a, st);
      }
    default:
      return -1;
  }
}

}  // namespace

// x [B, N, C0] (cmr_dense_chain) or [B, C0, N] (cmr_dense_chain_cn) of kind
// 0 = f32, 1 = bf16; w the layer weights (then the projection's) in x's
// type, packed by the wrapper (ops/kernels.py:pack_chain_weights): bf16 in
// mma fragment order, each [Cin, Cout] zero-padded to 16, 32, 64 or 128; f32
// row-major, each [Cin, Cout] zero-padded to 64 or 128 columns. bias [B,
// sum of the Couts] f32; pooled [B, C_L -
// C0] f32 for residual 3, else null; out like x with C_L channels; out_max
// [B, C_L] f32 initialised to -inf, or null. residual 0 none, 1 identity,
// 2 proj, 3 identity_split; dims c0..c3 (unused ones 0); slopes s0..s2 per
// layer and final_slope (1 for none). Returns a cudaError_t, -1 for an
// unsupported argument, or -2 when the packed weights leave no room in a
// block's shared memory.
CMR_EXPORT int cmr_dense_chain(const void* x, int x_kind, const void* w,
                               const float* bias, const float* pooled,
                               void* out, float* out_max, int B, int N,
                               int n_layers, int c0, int c1, int c2, int c3,
                               int residual, float s0, float s1, float s2,
                               float final_slope, void* stream) {
  return dense_chain<false>(x, x_kind, w, bias, pooled, out, out_max, B, N,
                            n_layers, c0, c1, c2, c3, residual, s0, s1, s2,
                            final_slope, static_cast<cudaStream_t>(stream));
}

CMR_EXPORT int cmr_dense_chain_cn(const void* x, int x_kind, const void* w,
                                  const float* bias, const float* pooled,
                                  void* out, float* out_max, int B, int N,
                                  int n_layers, int c0, int c1, int c2,
                                  int c3, int residual, float s0, float s1,
                                  float s2, float final_slope, void* stream) {
  return dense_chain<true>(x, x_kind, w, bias, pooled, out, out_max, B, N,
                           n_layers, c0, c1, c2, c3, residual, s0, s1, s2,
                           final_slope, static_cast<cudaStream_t>(stream));
}
