// Fused pointwise dense chain: per point, L layers (1 <= L <= 3) of
// acc_i = leaky(h_{i-1} W_i + b_i, slope_i), h_i = acc_i rounded to the
// compute type T, then a residual added to the last acc in f32 ("identity":
// x; "proj": x Wr + br; "identity_split": the virtual concat(x, pooled)),
// the final slope, and one rounding to T. Optionally the per-(sample,
// channel) max of the final f32 acc over the N points. T is f32 or bf16;
// the products of T values are summed in f32 (bf16 products are exact in
// f32) and biases are f32 rows of [B, C] (the agent's pooled half of each
// split kernel rides a per-sample bias).
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:fused_dense_chain
// (_chain_kernel, pallas_call at :1119) and fused_dense_chain_cn
// (_chain_cn_kernel, :1327): the geo model's MiniPointNet / ResDenseBlock
// stacks and the agent's four 3-D stages with BatchNorm folded in, eval
// mode. The rounding points follow _chain_kernel (:983-1010) step by step;
// the out_max epilogue masks the rows past N as :1013-1025 does.
//
// Bound on the H100: operations for the wide f32 chains, bytes for bf16
// and the narrow ones. At the geo model's point_fuse_0 shape (B=8,
// N=40960, 128 -> 128 -> 64 plus a 128 -> 64 projection) the chain is 21.5
// GFLOP against 252 MB of input and output: 0.32 ms at 67 TFLOP/s of f32
// on CUDA cores, 0.08 ms of HBM. Design (simple and correct first; tensor
// cores are later work): one block of 256 threads per (sample, tile of 64
// points). The tile's input, converted to f32, and the running activations
// stay in shared memory for the whole chain (row stride 129 floats, odd,
// so two rows never share a bank); one layer's weights at a time, zero
// padded to 128 columns, sit beside them (132 KB in all, one block per
// SM). Each thread keeps a 4 x 8 register tile of outputs (rows ty + 16 i,
// columns tx + 16 j) and runs f32 FMAs over the layer's input width; a
// layer at most 64 wide skips the upper half of the columns. The layouts
// differ only in how a tile is read and written: row-major walks the
// channels of consecutive points, channel-major the points of one channel,
// so consecutive threads read and write consecutive addresses either way.
// The max epilogue reduces the thread's rows, then per column in shared
// memory, then once per block and column into the [B, C] output with an
// ordered-int atomicMax (-inf initialised by the caller).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;            // points per block
constexpr int kMaxC = 128;           // widest layer
constexpr int kStride = kMaxC + 1;   // activation row stride in shared memory
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 8 outputs each
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kTile * kStride + kMaxC * kMaxC + kMaxC);

enum Residual { kNone = 0, kIdentity = 1, kProj = 2, kIdentitySplit = 3 };

struct ChainArgs {
  const void* x;        // [B, N, C0] (nc) or [B, C0, N] (cn), type T
  const void* w;        // W_1 .. W_L (then Wr), each [Cin, Cout] row-major
  const float* bias;    // [B, bias_stride]: b_1 .. b_L (then br) per sample
  const float* pooled;  // [B, C_L - C0] f32 (identity_split), else null
  void* out;            // like x with C_L channels, type T
  float* out_max;       // [B, C_L] f32, -inf initialised, or null
  int B, N, n_layers, residual, bias_stride;
  int dims[4];          // C0, C1, .., C_L
  float slopes[3];      // 1 = no activation (leaky with slope 1 is x)
  float final_slope;
};

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ inline T from_f(float v);
template <>
__device__ inline float from_f<float>(float v) { return v; }
template <>
__device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// The value a T holds after rounding v to T.
template <typename T>
__device__ inline float round_to(float v) { return to_f(from_f<T>(v)); }

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

// Weights of one layer [cin, cout] into ws [cin, kMaxC], columns past cout
// zero.
template <typename T>
__device__ inline void load_weights(float* ws, const T* w, int cin,
                                    int cout) {
  for (int i = threadIdx.x; i < cin * kMaxC; i += kThreads) {
    const int k = i / kMaxC, c = i % kMaxC;
    ws[i] = c < cout ? to_f(w[k * cout + c]) : 0.f;
  }
}

// acc[i][j] = sum_k src[ty + 16 i][k] * ws[k][tx + 16 j] for j < JN.
template <int JN>
__device__ inline void tile_matmul(const float* src, const float* ws,
                                   int cin, int tx, int ty,
                                   float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int k = 0; k < cin; ++k) {
    float hv[4], wv[JN];
#pragma unroll
    for (int i = 0; i < 4; ++i) hv[i] = src[(ty + 16 * i) * kStride + k];
#pragma unroll
    for (int j = 0; j < JN; ++j) wv[j] = ws[k * kMaxC + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
    }
  }
}

__device__ inline void matmul(const float* src, const float* ws, int cin,
                              int cout, int tx, int ty, float (&acc)[4][8]) {
  if (cout > 64) {
    tile_matmul<8>(src, ws, cin, tx, ty, acc);
  } else {
    tile_matmul<4>(src, ws, cin, tx, ty, acc);
  }
}

template <typename T, bool CN>
__global__ void __launch_bounds__(kThreads)
    dense_chain_kernel(ChainArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;                      // [kTile, kStride] the input, f32
  float* hs = xs + kTile * kStride;      // [kTile, kStride] activations
  float* ws = hs + kTile * kStride;      // [kMaxC, kMaxC] one layer's W
  float* cmax = ws + kMaxC * kMaxC;      // [kMaxC] the block's column max
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.N - n0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = a.dims[0];
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);

  // the tile's input; rows past N are zero and never written out
  if (CN) {
    const T* xb = x + (size_t)b * c0 * a.N + n0;
    for (int i = tid; i < c0 * kTile; i += kThreads) {
      const int c = i / kTile, r = i % kTile;
      xs[r * kStride + c] = r < rows ? to_f(xb[(size_t)c * a.N + r]) : 0.f;
    }
  } else {
    const T* xb = x + ((size_t)b * a.N + n0) * c0;
    for (int i = tid; i < kTile * c0; i += kThreads) {
      const int r = i / c0, c = i % c0;
      xs[r * kStride + c] = r < rows ? to_f(xb[i]) : 0.f;
    }
  }

  const float* bias = a.bias + (size_t)b * a.bias_stride;
  float acc[4][8];
  int cout = c0;
  for (int l = 0; l < a.n_layers; ++l) {
    const int cin = a.dims[l];
    cout = a.dims[l + 1];
    load_weights(ws, w, cin, cout);
    w += cin * cout;
    __syncthreads();
    matmul(l == 0 ? xs : hs, ws, cin, cout, tx, ty, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      const float bv = c < cout ? bias[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = leaky(acc[i][j] + bv, a.slopes[l]);
      }
    }
    bias += cout;
    __syncthreads();  // every thread is done reading hs and ws
    if (l + 1 < a.n_layers) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        if (c < cout) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hs[(ty + 16 * i) * kStride + c] = round_to<T>(acc[i][j]);
          }
        }
      }
    }
  }

  if (a.residual == kProj) {
    load_weights(ws, w, c0, cout);
    __syncthreads();
    float s[4][8];
    matmul(xs, ws, c0, cout, tx, ty, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      const float bv = c < cout ? bias[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] += s[i][j] + bv;
    }
  } else if (a.residual == kIdentity || a.residual == kIdentitySplit) {
    const float* prow = a.residual == kIdentitySplit
                            ? a.pooled + (size_t)b * (cout - c0)
                            : nullptr;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c >= cout) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] += c < c0 ? xs[(ty + 16 * i) * kStride + c] : prow[c - c0];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = leaky(acc[i][j], a.final_slope);
  }

  if (a.out_max != nullptr) {
    if (tid < kMaxC) cmax[tid] = -INFINITY;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c >= cout) continue;
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ty + 16 * i < rows) m = fmaxf(m, acc[i][j]);
      }
      atomic_max_float(&cmax[c], m);
    }
    __syncthreads();
    if (tid < cout) atomic_max_float(&a.out_max[(size_t)b * cout + tid],
                                     cmax[tid]);
  }

  // stage the f32 result in hs (last read before the final layer's sync),
  // then write it out in the layout's coalesced order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tx + 16 * j;
    if (c < cout) {
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[(ty + 16 * i) * kStride + c] = acc[i][j];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  if (CN) {
    T* ob = out + (size_t)b * cout * a.N + n0;
    for (int i = tid; i < cout * kTile; i += kThreads) {
      const int c = i / kTile, r = i % kTile;
      if (r < rows) ob[(size_t)c * a.N + r] = from_f<T>(hs[r * kStride + c]);
    }
  } else {
    T* ob = out + ((size_t)b * a.N + n0) * cout;
    for (int i = tid; i < rows * cout; i += kThreads) {
      const int r = i / cout, c = i % cout;
      ob[i] = from_f<T>(hs[r * kStride + c]);
    }
  }
}

template <typename T, bool CN>
int launch(const ChainArgs& a, cudaStream_t st) {
  static bool configured = false;  // the 132 KB needs the opt-in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_chain_kernel<T, CN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((a.N + kTile - 1) / kTile, a.B);
  dense_chain_kernel<T, CN><<<grid, kThreads, kSmemBytes, st>>>(a);
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
  if (n_layers < 1 || n_layers > 3 || residual < kNone ||
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
      return launch<float, CN>(a, st);
    case 1:
      return launch<__nv_bfloat16, CN>(a, st);
    default:
      return -1;
  }
}

}  // namespace

// x [B, N, C0] (cmr_dense_chain) or [B, C0, N] (cmr_dense_chain_cn) of kind
// 0 = f32, 1 = bf16; w the layer weights (then the projection's) in x's
// type, each [Cin, Cout] row-major, packed; bias [B, sum of the Couts] f32;
// pooled [B, C_L - C0] f32 for residual 3, else null; out like x with C_L
// channels; out_max [B, C_L] f32 initialised to -inf, or null. residual 0
// none, 1 identity, 2 proj, 3 identity_split; dims c0..c3 (unused ones 0);
// slopes s0..s2 per layer and final_slope (1 for none). Returns a
// cudaError_t, or -1 for an unsupported argument.
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
