// gather_mean: out[i, :] = mean_j table[rows[i, j], :], optionally fused
// with the per-column int8 dequant of the feature store.
//
//   int8 table + scale:  out[i, c] = (sum_j table[rows[i, j], c]) * (1/k * scale[c])
//                        (out in scale's dtype: float32 or bfloat16)
//   float32 / bfloat16:  out[i, c] = (sum_j table[rows[i, j], c]) * (1/k)
//                        (out in the table's dtype, or float32 for a
//                        bfloat16 table)
// The sum is taken in float32, in j order, and rounded to the output
// type once.
//
// Row indices follow jnp.take(table, rows, axis=0) in its default
// mode="fill", as the reference gathers: an index in [-N, -1] reads row
// N + i; an index >= N or < -N reads the fill value, NaN for a float
// table (the output row is NaN) and -128 for an int8 table (summed with
// the other rows, then scaled). Nothing is ever read out of bounds.
//
// Replaces euler_tpu/ops/pallas_ops.py:_pallas_gather_mean (the one
// pl.pallas_call of the JAX package). The Pallas kernel issues one async
// DMA per neighbor row into VMEM, waits on semaphores, and reduces a
// tile of outputs; none of that carries over.
//
// What bounds it on an H100: bytes, moved by random row reads. At the
// GraphSAGE width (n = 491,520, k = 10, D = 100, int8 table) it reads
// n*k = 4.9M random 100-byte rows (0.49 GB of payload, 0.63 GB in
// 32-byte sectors: a row at a 4-byte-aligned offset spans 4 of them)
// out of a 245 MB table that is 5x the L2, 19.7 MB of indices, and
// writes 98 MB of bfloat16: about 0.22 ms at 3.35 TB/s. Such a gather is
// limited by how many bytes are in flight, not by instructions.
//
// The design:
// - A warp per (output row, chunk of 32 vectors of it), no division per
//   element. The first `lanes` lanes each own one vector of V bytes of
//   the row; V is the widest of 16/8/4/2/1 bytes that the table's row
//   width and address, and the output's and scale's vectors, allow
//   (chosen in Python from the real pointers, checked again here).
//   D = 100 int8 gives V = 4 over 25 lanes, bf16 V = 8, f32 V = 16. A
//   row wider than 32 vectors (cora's 1433 int8 columns: V = 1) is cut
//   into chunks along gridDim.y, so its chunks run in parallel instead
//   of one after another in one warp. Warps grid-stride over the rows.
// - The row's indices are loaded once per warp, k lanes in one coalesced
//   load; each lane applies the wrap/fill rule once and __shfl_sync
//   broadcasts the result.
// - All row loads of a chunk of kChunk = 16 neighbors are issued before
//   any add, so a warp keeps ~1 KB in flight at D = 100 int8 (k = 10).
// - Nothing is staged in shared memory (each gathered byte is used once
//   by the warp that loads it) and no TMA (a 100-byte row is neither
//   16-byte aligned nor strided by 16). The table layout is the feature
//   store's own: padding rows to 128 bytes would save no sectors and
//   cost 28% more table.
// What stays: random 32-byte sectors do not stream at the card's peak
// (the kernel moves about 2.2 TB/s of sectors on the main path), and
// the index load and the row loads are two dependent round trips per
// warp (a prefetch of the next row's indices, tried, did not pay; see
// PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// dtype codes shared with euler_tpu_torch/ops/gather_mean.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;
constexpr int kNone = -1;

constexpr int kWarp = 32;
constexpr int kChunk = 16;  // neighbor rows loaded before the adds
// 512 threads at most and one block per SM at least, so ptxas may give
// a thread 128 registers (the 16 loads of 16 bytes in flight take 64 of
// them). Without the minimum of one block ptxas spilled two int8 kernels
// at 40 and 64 registers.
constexpr int kMaxThreads = 512;
constexpr unsigned kFullMask = 0xffffffffu;

// Element kinds: bytes, float32 from an element's bits (in the low bits
// of a word), the bits of a float32 rounded to the kind, and the bits of
// jnp.take's fill value.
struct F32 {
  static constexpr int kBytes = 4;
  static __device__ __forceinline__ float from_bits(uint32_t b) { return __uint_as_float(b); }
  static __device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }
  static constexpr uint32_t kFill = 0x7fc00000u;  // NaN
};
struct BF16 {
  static constexpr int kBytes = 2;
  static __device__ __forceinline__ float from_bits(uint32_t b) {
    return __uint_as_float((b & 0xffffu) << 16);
  }
  static __device__ __forceinline__ uint32_t to_bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static constexpr uint32_t kFill = 0x7fc0u;  // NaN
};
struct I8 {
  static constexpr int kBytes = 1;
  static __device__ __forceinline__ float from_bits(uint32_t b) {
    return static_cast<float>(static_cast<int8_t>(b & 0xffu));
  }
  static constexpr uint32_t kFill = 0x80u;  // -128
};
struct NoScale {
  static constexpr int kBytes = 4;
};

// V bytes held in 32-bit words: one load or store of V bytes
template <int V>
struct Vec {
  uint32_t w[V >= 4 ? V / 4 : 1];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const void* p) {
  Vec<V> v;
  if constexpr (V == 1) {
    v.w[0] = __ldg(static_cast<const uint8_t*>(p));
  } else if constexpr (V == 2) {
    v.w[0] = __ldg(static_cast<const uint16_t*>(p));
  } else if constexpr (V == 4) {
    v.w[0] = __ldg(static_cast<const uint32_t*>(p));
  } else if constexpr (V == 8) {
    const uint2 t = __ldg(static_cast<const uint2*>(p));
    v.w[0] = t.x;
    v.w[1] = t.y;
  } else {
    static_assert(V == 16, "vectors are 1, 2, 4, 8 or 16 bytes");
    const uint4 t = __ldg(static_cast<const uint4*>(p));
    v.w[0] = t.x;
    v.w[1] = t.y;
    v.w[2] = t.z;
    v.w[3] = t.w;
  }
  return v;
}

template <int V>
__device__ __forceinline__ void store_vec(void* p, const Vec<V>& v) {
  if constexpr (V == 2) {
    *static_cast<uint16_t*>(p) = static_cast<uint16_t>(v.w[0]);
  } else if constexpr (V == 4) {
    *static_cast<uint32_t*>(p) = v.w[0];
  } else if constexpr (V == 8) {
    *static_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
  } else {
    static_assert(V == 16, "outputs are 2, 4, 8 or 16 bytes a lane");
    *static_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  }
}

// element e (a compile-time index once unrolled) of a vector of kind K
template <typename K, int V>
__device__ __forceinline__ float get(const Vec<V>& v, int e) {
  const int bit = e * K::kBytes * 8;
  return K::from_bits(v.w[bit / 32] >> (bit % 32));
}

template <typename K, int V>
__device__ __forceinline__ void put(Vec<V>& v, int e, uint32_t bits) {
  const int bit = e * K::kBytes * 8;
  v.w[bit / 32] |= bits << (bit % 32);
}

// jnp.take's rule, once per index: the row to read, or -1 for the fill
__device__ __forceinline__ int wrap_row(int idx, int num_rows) {
  if (idx < 0) idx += num_rows;  // no overflow: num_rows <= 2^31 - 1
  return (idx >= 0 && idx < num_rows) ? idx : -1;
}

template <typename TK, typename SK, typename OK, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
gather_mean_kernel(const char* __restrict__ table, const int32_t* __restrict__ rows,
                   const char* __restrict__ scale, char* __restrict__ out, long long n,
                   int k, int vectors_per_row, int num_rows, int lanes, float inv_k) {
  constexpr int E = V / TK::kBytes;
  constexpr int VO = E * OK::kBytes;  // output bytes a lane
  constexpr int VS = E * SK::kBytes;  // scale bytes a lane
  constexpr bool kScaled = !std::is_same<SK, NoScale>::value;

  const int lane = threadIdx.x & (kWarp - 1);
  const int warps_per_block = blockDim.x / kWarp;
  const long long first = static_cast<long long>(blockIdx.x) * warps_per_block +
                          threadIdx.x / kWarp;
  const long long stride = static_cast<long long>(gridDim.x) * warps_per_block;
  const long long row_bytes = static_cast<long long>(vectors_per_row) * V;
  const long long out_row_bytes = static_cast<long long>(vectors_per_row) * VO;
  const int col_iters = (vectors_per_row + lanes - 1) / lanes;
  Vec<V> fill = {};
#pragma unroll
  for (int e = 0; e < E; ++e) put<TK>(fill, e, TK::kFill);

  // blockIdx.y picks the column chunk: a row wider than `lanes` vectors
  // is spread over gridDim.y warps instead of looping inside one
  for (int it = blockIdx.y; it < col_iters; it += gridDim.y) {
    const int c = it * lanes + lane;
    const bool active = lane < lanes && c < vectors_per_row;
    // idle lanes read column 0 of the same rows (sectors the warp reads
    // anyway) and store nothing, so loads need no lane predicate
    const char* col = table + static_cast<long long>(active ? c : 0) * V;
    float m[E];
#pragma unroll
    for (int e = 0; e < E; ++e) m[e] = inv_k;
    if constexpr (kScaled) {
      if (active) {
        const Vec<VS> s = load_vec<VS>(scale + static_cast<long long>(c) * VS);
#pragma unroll
        for (int e = 0; e < E; ++e) m[e] *= get<SK>(s, e);
      }
    }
    for (long long i = first; i < n; i += stride) {
      // the row's indices, kWarp at a time: one coalesced load, the
      // wrap/fill rule once per index, then broadcast by __shfl_sync
      const int32_t* r = rows + i * k;
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
      for (int b = 0; b < k; b += kWarp) {
        const int w = b + lane < k ? wrap_row(r[b + lane], num_rows) : -1;
        const int kb = min(kWarp, k - b);
        for (int j0 = 0; j0 < kb; j0 += kChunk) {
          Vec<V> x[kChunk];
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const int row = __shfl_sync(kFullMask, w, j0 + u);
            if (j0 + u < kb) x[u] = row >= 0 ? load_vec<V>(col + row * row_bytes) : fill;
          }
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (j0 + u < kb) {
#pragma unroll
              for (int e = 0; e < E; ++e) acc[e] += get<TK>(x[u], e);
            }
          }
        }
      }
      if (active) {
        Vec<VO> o = {};
#pragma unroll
        for (int e = 0; e < E; ++e) put<OK>(o, e, OK::to_bits(acc[e] * m[e]));
        store_vec<VO>(out + i * out_row_bytes + static_cast<long long>(c) * VO, o);
      }
    }
  }
}

struct Args {
  const void* table;
  const void* rows;
  const void* scale;
  void* out;
  long long n;
  int k;
  long long d;
  long long num_rows;
  int vec_bytes;
  int lanes;
  int rows_per_block;
  long long grid;
  int col_blocks;
};

template <typename TK, typename SK, typename OK, int V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int E = V / TK::kBytes;
  constexpr bool kScaled = !std::is_same<SK, NoScale>::value;
  constexpr uintptr_t kOutVec = E * OK::kBytes;
  constexpr uintptr_t kScaleVec = E * SK::kBytes;
  if constexpr (V % TK::kBytes != 0 || kOutVec > 16 || (kScaled && kScaleVec > 16)) {
    return cudaErrorInvalidValue;
  } else {
    // the plan, checked against the real pointers and widths
    if (a.d % E != 0 || a.d / E > 0x7fffffffLL ||
        reinterpret_cast<uintptr_t>(a.table) % V != 0 ||
        reinterpret_cast<uintptr_t>(a.out) % kOutVec != 0 ||
        reinterpret_cast<uintptr_t>(a.rows) % sizeof(int32_t) != 0 ||
        (kScaled && (a.scale == nullptr ||
                     reinterpret_cast<uintptr_t>(a.scale) % kScaleVec != 0)))
      return cudaErrorInvalidValue;
    const int vectors = static_cast<int>(a.d / E);
    if (a.lanes != (vectors < kWarp ? vectors : kWarp)) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(a.grid), static_cast<unsigned>(a.col_blocks));
    gather_mean_kernel<TK, SK, OK, V><<<grid, a.rows_per_block * kWarp, 0, stream>>>(
        static_cast<const char*>(a.table), static_cast<const int32_t*>(a.rows),
        static_cast<const char*>(a.scale), static_cast<char*>(a.out), a.n, a.k, vectors,
        static_cast<int>(a.num_rows), a.lanes, 1.0f / static_cast<float>(a.k));
    return cudaGetLastError();
  }
}

template <typename TK, typename SK, typename OK>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  switch (a.vec_bytes) {
    case 1: return launch<TK, SK, OK, 1>(a, stream);
    case 2: return launch<TK, SK, OK, 2>(a, stream);
    case 4: return launch<TK, SK, OK, 4>(a, stream);
    case 8: return launch<TK, SK, OK, 8>(a, stream);
    case 16: return launch<TK, SK, OK, 16>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing: `out` is [n, d] in the output dtype,
// the scale's for an int8 table, the table's for a float one, or float32
// for a bfloat16 table (an activation cache read as float32 rows, summed
// in float32 and stored without a bfloat16 rounding). The plan
// (vec_bytes, lanes, rows_per_block, grid x col_blocks) comes from
// launch_plan in euler_tpu_torch/ops/gather_mean.py. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue, with
// nothing launched, for a dtype combination the kernel does not take or
// a plan it cannot run on these pointers and widths.
extern "C" int gather_mean_launch(const void* table, int table_dtype, const void* rows,
                                  const void* scale, int scale_dtype, void* out, int out_dtype,
                                  long long n, int k, long long d, long long num_rows,
                                  int vec_bytes, int lanes, int rows_per_block,
                                  long long grid, int col_blocks, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || num_rows <= 0 || num_rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (lanes < 1 || lanes > kWarp || rows_per_block < 1 ||
      rows_per_block * kWarp > kMaxThreads || grid < 1 || grid > 0x7fffffffLL ||
      col_blocks < 1 || col_blocks > 65535)
    return cudaErrorInvalidValue;
  const Args a{table,     rows,  scale,          out,  n,         k,  d,
               num_rows, vec_bytes, lanes, rows_per_block, grid, col_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == kInt8 && scale_dtype == kFloat32 && out_dtype == kFloat32)
    return dispatch<I8, F32, F32>(a, s);
  if (table_dtype == kInt8 && scale_dtype == kBFloat16 && out_dtype == kBFloat16)
    return dispatch<I8, BF16, BF16>(a, s);
  if (table_dtype == kFloat32 && scale_dtype == kNone && out_dtype == kFloat32)
    return dispatch<F32, NoScale, F32>(a, s);
  if (table_dtype == kBFloat16 && scale_dtype == kNone && out_dtype == kBFloat16)
    return dispatch<BF16, NoScale, BF16>(a, s);
  if (table_dtype == kBFloat16 && scale_dtype == kNone && out_dtype == kFloat32)
    return dispatch<BF16, NoScale, F32>(a, s);
  return cudaErrorInvalidValue;
}
