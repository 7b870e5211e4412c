// Dense Adam (or AdamW) over a whole float32 table [rows, dim] from a
// row-sparse gradient: the ids a step looked up and their gradient rows,
// uncoalesced (an id may repeat). Every row of the table takes torch's
// fused Adam step (ATen/native/cuda/fused_adam_utils.cuh, adam_math, in
// its order and precision); a row that no id touched takes it with a
// zero gradient, so its moments decay and the row still moves. The
// dense [rows, dim] gradient never exists.
//
// The caller (ops/row_sparse_adam.py) sorts the ids stably, so equal ids
// form runs in the order they were looked up. Then, on one stream:
//
//   1. a memset fills the row map first[rows] with -1;
//   2. prepare_kernel writes each run's first slot into first[id], and
//      (its thread 0) the step: t = step + 1, the bias corrections from
//      t (coef = {lr / (1 - beta1^t), sqrt(1 - beta2^t)}), and
//      step = t - found_inf, as torch's _foreach_add_ / _foreach_sub_
//      around its fused kernel leave it;
//   3. adam_pass_kernel, one thread per vector of VEC floats of the
//      table: g = the run's rows summed in the run's order (no atomics:
//      the same bits every run), or 0; then the Adam step on p, m and v,
//      each read once and written once. (On an H100, streaming cache
//      hints on those loads and stores measured 1.3% slower; two vectors a
//      thread, or 256 threads a block, no faster.)
//
// On found_inf == 1 the pass returns before touching anything and the
// step is left as it was: the parameter and the whole state stay.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__global__ void prepare_kernel(const long long* __restrict__ sorted_ids,
                               long long nnz, long long rows,
                               int* __restrict__ first,
                               float* __restrict__ step,
                               const float* __restrict__ found_inf,
                               float lr, float beta1, float beta2,
                               float* __restrict__ coef) {
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (j == 0) {
    // torch: steps += 1 before the kernel, which reads the new count
    const float t = *step + 1.0f;
    const float bias_correction1 = 1 - powf(beta1, t);
    const float bias_correction2 = 1 - powf(beta2, t);
    coef[0] = lr / bias_correction1;  // adam_math's step_size
    coef[1] = sqrtf(bias_correction2);
    // torch: steps -= found_inf after it
    *step = found_inf != nullptr ? t - *found_inf : t;
  }
  if (j < nnz) {
    const long long id = sorted_ids[j];
    if (id >= 0 && id < rows && (j == 0 || sorted_ids[j - 1] != id)) {
      first[id] = static_cast<int>(j);
    }
  }
}

template <int VEC, bool ADAMW>
__global__ void __launch_bounds__(kThreads) adam_pass_kernel(
    float* __restrict__ param, float* __restrict__ exp_avg,
    float* __restrict__ exp_avg_sq, const float* __restrict__ values,
    const long long* __restrict__ sorted_ids,
    const long long* __restrict__ order, const int* __restrict__ first,
    long long nnz, long long vectors, int vectors_per_row,
    const float* __restrict__ coef, const float* __restrict__ found_inf,
    float lr, float beta1, float beta2, float weight_decay, float eps) {
  if (found_inf != nullptr && *found_inf == 1) {
    return;
  }
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= vectors) {
    return;
  }
  using V = typename Vec<VEC>::T;
  const long long row = i / vectors_per_row;
  const long long col = (i - row * vectors_per_row) * VEC;
  const long long dim = static_cast<long long>(vectors_per_row) * VEC;

  V pv = reinterpret_cast<const V*>(param)[i];
  V mv = reinterpret_cast<const V*>(exp_avg)[i];
  V vv = reinterpret_cast<const V*>(exp_avg_sq)[i];
  float* p = reinterpret_cast<float*>(&pv);
  float* m = reinterpret_cast<float*>(&mv);
  float* v = reinterpret_cast<float*>(&vv);

  float g[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    g[e] = 0.0f;
  }
  const int s = first[row];
  if (s >= 0) {
    V gv = __ldg(reinterpret_cast<const V*>(values + order[s] * dim + col));
    const float* x = reinterpret_cast<const float*>(&gv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      g[e] = x[e];
    }
    for (long long j = s + 1; j < nnz && sorted_ids[j] == row; ++j) {
      gv = __ldg(reinterpret_cast<const V*>(values + order[j] * dim + col));
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        g[e] += x[e];
      }
    }
  }

  const float step_size = coef[0];
  const float bias_correction2_sqrt = coef[1];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    // adam_math, line for line (no grad scale, no maximize, no amsgrad)
    float param_e = p[e];
    float grad = g[e];
    float exp_avg_e = m[e];
    float exp_avg_sq_e = v[e];
    if (weight_decay != 0) {
      if (ADAMW) {
        param_e -= lr * weight_decay * param_e;
      } else {
        grad += param_e * weight_decay;
      }
    }
    exp_avg_e = fmaf(beta1, exp_avg_e, fmaf(-beta1, grad, grad));
    exp_avg_sq_e = fmaf(beta2, exp_avg_sq_e,
                        fmaf(-beta2, grad * grad, grad * grad));
    const float denom = (sqrtf(exp_avg_sq_e) / bias_correction2_sqrt) + eps;
    param_e -= step_size * exp_avg_e / denom;
    p[e] = param_e;
    m[e] = exp_avg_e;
    v[e] = exp_avg_sq_e;
  }
  reinterpret_cast<V*>(param)[i] = pv;
  reinterpret_cast<V*>(exp_avg)[i] = mv;
  reinterpret_cast<V*>(exp_avg_sq)[i] = vv;
}

template <int VEC, bool ADAMW>
void launch_pass(float* param, float* exp_avg, float* exp_avg_sq,
                 const float* values, const long long* sorted_ids,
                 const long long* order, const int* first, long long nnz,
                 long long rows, int dim, const float* coef,
                 const float* found_inf, float lr, float beta1, float beta2,
                 float weight_decay, float eps, cudaStream_t stream) {
  const long long vectors = rows * (dim / VEC);
  const long long blocks = (vectors + kThreads - 1) / kThreads;
  adam_pass_kernel<VEC, ADAMW><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      param, exp_avg, exp_avg_sq, values, sorted_ids, order, first, nnz,
      vectors, dim / VEC, coef, found_inf, lr, beta1, beta2, weight_decay,
      eps);
}

}  // namespace

// Plain C entry point (bound with ctypes). param, exp_avg, exp_avg_sq:
// float32 [rows, dim], contiguous; values: float32 [nnz, dim], contiguous;
// sorted_ids, order: int64 [nnz], the ids sorted stably and their
// positions in values; scratch: int32 [rows + 2] (the row map, then two
// floats); step: a float32 scalar on the device; found_inf: a float32
// scalar on the device, or null. vec: 4 (dim % 4 == 0 and every float
// pointer 16-byte aligned) or 1. adamw: 1 for AdamW's decoupled decay, 0
// for Adam's L2 term. Enqueues a memset and two kernels on `stream`;
// does not synchronise and allocates nothing. Returns a CUDA error code
// (0 on success; cudaErrorInvalidValue for arguments it refuses).
extern "C" int row_sparse_adam_launch(
    void* param, void* exp_avg, void* exp_avg_sq, const void* values,
    const void* sorted_ids, const void* order, void* scratch, void* step,
    const void* found_inf, long long rows, int dim, long long nnz, int vec,
    int adamw, float lr, float beta1, float beta2, float weight_decay,
    float eps, void* stream) {
  if (rows <= 0 || dim <= 0 || nnz < 0 || (vec != 1 && vec != 4) ||
      dim % vec != 0 || nnz > 0x7fffffffLL ||
      (rows * (dim / vec) + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 4) {
    for (const void* ptr : {static_cast<const void*>(param),
                            static_cast<const void*>(exp_avg),
                            static_cast<const void*>(exp_avg_sq), values}) {
      if (reinterpret_cast<unsigned long long>(ptr) % 16 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* first = static_cast<int*>(scratch);
  float* coef = reinterpret_cast<float*>(first + rows);
  cudaError_t err = cudaMemsetAsync(first, 0xff, rows * sizeof(int), s);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long prep_blocks = nnz > 0 ? (nnz + kThreads - 1) / kThreads : 1;
  prepare_kernel<<<static_cast<unsigned>(prep_blocks), kThreads, 0, s>>>(
      static_cast<const long long*>(sorted_ids), nnz, rows, first,
      static_cast<float*>(step), static_cast<const float*>(found_inf), lr,
      beta1, beta2, coef);
  auto* p = static_cast<float*>(param);
  auto* m = static_cast<float*>(exp_avg);
  auto* v = static_cast<float*>(exp_avg_sq);
  auto* x = static_cast<const float*>(values);
  auto* ids = static_cast<const long long*>(sorted_ids);
  auto* ord = static_cast<const long long*>(order);
  auto* inf = static_cast<const float*>(found_inf);
  if (vec == 4 && adamw) {
    launch_pass<4, true>(p, m, v, x, ids, ord, first, nnz, rows, dim, coef,
                         inf, lr, beta1, beta2, weight_decay, eps, s);
  } else if (vec == 4) {
    launch_pass<4, false>(p, m, v, x, ids, ord, first, nnz, rows, dim, coef,
                          inf, lr, beta1, beta2, weight_decay, eps, s);
  } else if (adamw) {
    launch_pass<1, true>(p, m, v, x, ids, ord, first, nnz, rows, dim, coef,
                         inf, lr, beta1, beta2, weight_decay, eps, s);
  } else {
    launch_pass<1, false>(p, m, v, x, ids, ord, first, nnz, rows, dim, coef,
                          inf, lr, beta1, beta2, weight_decay, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
