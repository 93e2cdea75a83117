// Factored pixel-id raster sum: for each sample b and row j whose pixel id
// p = ids[b, j] = y*w + x lies in [0, h*w) (w <= 128), the feature row
// data[b, j, :] is summed into pixel p -> out [B, h*w, F] f32. Any other id
// (the caller routes invalid rows to h*w; negative ids too) contributes
// nothing. Rows are f32, or bf16 read as bf16 and summed in f32 (one
// rounding of the inputs, exact products), as the TPU kernel's bf16
// one-hot matmul with f32 accumulation.
//
// Replaces cmr_agent_tpu/ops/pallas_kernels.py:segment_sum_image_fused on
// its factored path (_sum_image_factored_kernel, pallas_call at :648; the
// default of segment_sum_image_fused and of segment_mean_count_image_fused,
// which appends the ones column of the counts). The TPU kernel factors the
// [T, h*w] pixel one-hot of a point tile into one [T, 128] column one-hot
// and a gate per image row, unrolled over the h rows, so that the vector
// unit builds 128 lanes instead of h*w. Here the factoring becomes
// ownership: one block per (sample, image row y) keeps that row's [w, F]
// f32 sums in shared memory (128 x 65 x 4 = 33 KB at the probe's F + 1),
// streams the sample's ids, and adds each row whose id // w == y into
// column id % w with shared-memory atomics; then it writes its slab once.
// No global atomics, no zeroed output, no second pass.
//
// Bound on the H100: memory. At tools/raster_probe.py's default shape
// (B=8, N=20480, F=65 with the count column, 40x128, every row in the
// frame) the function must read the ids (0.66 MB) and the rows (42.6 MB
// f32, 21.3 MB bf16) and write the sums (10.6 MB): 53.9 MB, 16.1 us at
// 3.35 TB/s (bf16 32.6 MB, 9.7 us). Each of the h blocks of a sample reads
// all of its ids (h x 82 KB), which after the first read come from the
// 50 MB L2; a routed-out row costs those id reads and nothing else. Each
// warp loads kUnroll x 32 ids before it ballots them, so that several L2
// reads are in flight per warp.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may use

template <typename T>
__global__ void __launch_bounds__(kThreads)
raster_factored_kernel(const T* __restrict__ data, const int* __restrict__ ids,
                       float* __restrict__ out, int N, int F, int h, int w) {
  extern __shared__ float acc[];  // [w, F]: this image row's sums
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const int slab = w * F;
  for (int i = threadIdx.x; i < slab; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = (blockDim.x >> 5) * 32 * kUnroll;
  const int lo = y * w;  // ids of image row y: [lo, lo + w)
  const int* bid = ids + (size_t)b * N;
  const T* bdata = data + (size_t)b * N * F;
  for (int base = warp * 32 * kUnroll; base < N; base += stride) {
    int id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32 + lane;
      id[u] = j < N ? __ldg(bid + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int x = id[u] - lo;  // column, if the row is this image row's
      unsigned mine = __ballot_sync(0xffffffffu, x >= 0 && x < w);
      while (mine) {
        const int src = __ffs(mine) - 1;
        mine &= mine - 1;
        const int col = __shfl_sync(0xffffffffu, x, src);
        const T* row = bdata + (size_t)(base + u * 32 + src) * F;
        float* dst = acc + col * F;
        for (int c = lane; c < F; c += 32) {
          atomicAdd(&dst[c], to_f32(row[c]));
        }
      }
    }
  }
  __syncthreads();
  float* o = out + ((size_t)b * h + y) * slab;  // pixels y*w .. y*w + w - 1
  for (int i = threadIdx.x; i < slab; i += blockDim.x) o[i] = acc[i];
}

template <typename T>
int launch(const void* data, const int* ids, float* out, int B, int N, int F,
           int h, int w, cudaStream_t st) {
  static bool configured = false;  // above 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_factored_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t smem = (size_t)w * F * sizeof(float);
  if (w < 1 || w > 128 || smem > (size_t)kMaxSmemBytes) return -1;
  raster_factored_kernel<T><<<dim3(h, B), kThreads, smem, st>>>(
      static_cast<const T*>(data), ids, out, N, F, h, w);
  CMR_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// data [B, N, F] of kind 0 = f32, 1 = bf16; ids [B, N] int32; out
// [B, h*w, F] f32, every element written (no zeroing needed). Returns a
// cudaError_t, or -1 for an unknown kind, w outside [1, 128] or a [w, F]
// slab above 227 KB.
CMR_EXPORT int cmr_raster_factored(const void* data, int kind, const int* ids,
                                   float* out, int B, int N, int F, int h,
                                   int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<float>(data, ids, out, B, N, F, h, w, st);
    case 1:
      return launch<__nv_bfloat16>(data, ids, out, B, N, F, h, w, st);
    default:
      return -1;
  }
}
