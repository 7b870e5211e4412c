// gather_mean: out[i, :] = mean_j table[rows[i, j], :], optionally fused
// with the per-column int8 dequant of the feature store.
//
//   int8 table + scale:  out[i, c] = (sum_j table[rows[i, j], c]) * (1/k) * scale[c]
//                        (out in scale's dtype: float32 or bfloat16)
//   float32 / bfloat16:  out[i, c] = (sum_j table[rows[i, j], c]) * (1/k)
//                        (out in the table's dtype)
// The sum is taken in float32 and rounded to the output type once.
// A row index outside [0, num_rows) makes that output row NaN (the
// fill value jnp.take gives a float gather), never an out-of-bounds read.
//
// Replaces euler_tpu/ops/pallas_ops.py:_pallas_gather_mean (the one
// pl.pallas_call of the JAX package). The Pallas kernel issues one async
// DMA per neighbor row into VMEM, waits on semaphores, and reduces a
// tile of outputs. None of that carries over: here every thread owns one
// (output row, column) element, loads that column of its k neighbor rows
// straight from device memory and keeps the sum in a register. Adjacent
// threads take adjacent columns, so a warp reads each neighbor row as a
// contiguous run; a block of 256 threads covers 2-3 output rows of
// D = 100. Nothing is staged in shared memory and nothing carries over
// between blocks. The [n*k, D] gathered layer is never written.
//
// What bounds it on an H100: bytes. At the GraphSAGE serving width
// (n = 491,520 roots*hop-1, k = 10, D = 100, int8 table) it reads
// n*k = 4.9M random 100-byte rows: 0.49 GB of payload, 0.63 GB in 32-byte
// sectors (each row spans 4 sectors), plus 19.7 MB of row indices, and
// writes 98 MB of bfloat16 output: about 0.22 ms at 3.35 TB/s.
//
// Left for later: the sector waste on 100-byte rows (pad rows to 128
// bytes, or have a warp load whole rows with 16-byte vectors), the
// redundant per-thread index loads (one warp could load a row's k
// indices once and broadcast them), and no cp.async prefetch of the next
// rows' indices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with euler_tpu_torch/ops/gather_mean.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;
constexpr int kNone = -1;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// S is the scale's element type; scale == nullptr means no dequant.
template <typename T, typename S, typename O>
__global__ void __launch_bounds__(kThreads)
gather_mean_kernel(const T* __restrict__ table, const int32_t* __restrict__ rows,
                   const S* __restrict__ scale, O* __restrict__ out, long long n,
                   int k, long long d, long long num_rows, float inv_k) {
  const long long total = n * d;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / d;
    const long long c = e - i * d;
    const int32_t* r = rows + i * k;
    float acc = 0.f;
    bool in_range = true;
    for (int j = 0; j < k; ++j) {
      const long long row = r[j];
      if (row < 0 || row >= num_rows) {
        in_range = false;
        continue;
      }
      acc += to_f32(table[row * d + c]);
    }
    float v = acc * inv_k;
    if (scale != nullptr) v *= to_f32(scale[c]);
    if (!in_range) v = __int_as_float(0x7fc00000);  // NaN
    store(out + e, v);
  }
}

template <typename T, typename S, typename O>
cudaError_t launch(const void* table, const void* rows, const void* scale, void* out,
                   long long n, int k, long long d, long long num_rows,
                   cudaStream_t stream) {
  const long long total = n * d;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_mean_kernel<T, S, O><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(rows),
      static_cast<const S*>(scale), static_cast<O*>(out), n, k, d, num_rows,
      1.0f / static_cast<float>(k));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing: `out` is [n, d] in the output dtype.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a dtype combination the kernel does not take.
extern "C" int gather_mean_launch(const void* table, int table_dtype, const void* rows,
                                  const void* scale, int scale_dtype, void* out,
                                  long long n, int k, long long d, long long num_rows,
                                  void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || num_rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == kInt8 && scale_dtype == kFloat32)
    return launch<int8_t, float, float>(table, rows, scale, out, n, k, d, num_rows, s);
  if (table_dtype == kInt8 && scale_dtype == kBFloat16)
    return launch<int8_t, __nv_bfloat16, __nv_bfloat16>(table, rows, scale, out, n, k, d,
                                                        num_rows, s);
  if (table_dtype == kFloat32 && scale_dtype == kNone)
    return launch<float, float, float>(table, rows, nullptr, out, n, k, d, num_rows, s);
  if (table_dtype == kBFloat16 && scale_dtype == kNone)
    return launch<__nv_bfloat16, float, __nv_bfloat16>(table, rows, nullptr, out, n, k, d,
                                                       num_rows, s);
  return cudaErrorInvalidValue;
}
