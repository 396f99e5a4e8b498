// Device code shared by the port's GLM kernels: the loss table, the bf16
// helpers and the dtype/loss dispatch (all four kernels); the row-group
// value+gradient body (kernel 2's random-effect rows wider than its
// one-thread-per-row body, fused_re.cu); and the fixed-order, coalesced
// cross-block fold of kernels 1-4 (fold_rows). Kernels 1 and 3
// (fused_glm.cu, fused_hvp.cu) and kernel 4 (fused_glm_multi.cu) have
// their own staged-tile bodies, with the cp.async helpers of cp_async.cuh.
//
// The row-group body computes, over the rows of a dense design block,
//
//     value = sum_r wt_r * loss(x_r . w + off_r, y_r)
//     grad  = sum_r wt_r * loss'(x_r . w + off_r, y_r) * x_r
//
// reading every row of X once. Rows are handed to GROUPS of G lanes
// (G = the smallest power of two >= d, capped at one warp): a group computes
// its row's margin with a butterfly shuffle reduction, evaluates the loss
// and its derivative in registers, and adds d1 * x_r to the group's own
// gradient partial in shared memory while the row is still in L1. Each lane
// owns fixed columns of its group's partial, so there are no atomics and the
// summation order is fixed: results are bit-identical run to run. What
// bounds it on an H100 is bytes; what holds it back is one gradient
// partial per row group in shared memory (few blocks an SM) and a shuffle
// tree per row.
//
// Rows with weight <= 0 (padding) are skipped whole: they contribute exactly
// zero and their margin is never formed, so Poisson's exp(m) at a padded
// row's raw margin cannot overflow into the sums (the double-where guard of
// photon_ml_tpu/ops/objective.py::GLMObjective.value).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace photon {

// Loss ids: PointwiseLoss.kernel_id in photon_ml_tpu_torch/ops/losses.py.
enum { LOGISTIC = 0, SQUARED = 1, POISSON = 2, SMOOTHED_HINGE = 3 };

// Design storage types: DTYPE_IDS in photon_ml_tpu_torch/ops/cuda_build.py.
enum { F32 = 0, BF16 = 1 };

template <int LOSS>
__device__ __forceinline__ void loss_and_d1(float m, float y, float* l,
                                            float* d1) {
  if (LOSS == LOGISTIC) {
    // stable softplus(m) - y*m and sigmoid(m) - y
    const float e = expf(-fabsf(m));
    *l = fmaxf(m, 0.f) + log1pf(e) - y * m;
    const float s = (m >= 0.f) ? 1.f / (1.f + e) : e / (1.f + e);
    *d1 = s - y;
  } else if (LOSS == SQUARED) {
    const float r = m - y;
    *l = 0.5f * r * r;
    *d1 = r;
  } else if (LOSS == POISSON) {
    const float e = expf(m);
    *l = e - y * m;
    *d1 = e - y;
  } else {  // SMOOTHED_HINGE, on the signed margin t = (2y - 1) m
    const float z = 2.f * y - 1.f;
    const float t = z * m;
    *l = (t <= 0.f) ? 0.5f - t : ((t < 1.f) ? 0.5f * (1.f - t) * (1.f - t) : 0.f);
    *d1 = z * ((t <= 0.f) ? -1.f : ((t < 1.f) ? t - 1.f : 0.f));
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an f32 to the nearest bf16 (ties to even) and back.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Group size for a row of width d: the smallest power of two >= d, <= 32.
inline int group_size(int d) {
  int g = 1;
  while (g < d && g < 32) g <<= 1;
  return g;
}

// Dynamic shared memory of one block of the row-group plan: w (d) +
// per-group gradient partials (n_groups * d) + per-group value partials
// (n_groups), all f32.
// photon_ml_tpu_torch/ops/cuda_build.py::block_smem_bytes mirrors it.
inline size_t block_smem_bytes(int d, int threads, int g) {
  const size_t n_groups = threads / g;
  return sizeof(float) * ((size_t)d + n_groups * d + n_groups);
}

// Shared memory one block may use on Hopper (227 KiB).
constexpr size_t kMaxBlockSmemBytes = 232448;

// The largest block of at most `threads` threads (a multiple of 32) whose
// shared memory fits; 0 when not even one warp fits (d > 29055,
// cuda_build.MAX_ROW_WIDTH).
inline int fit_threads(int d, int g, int threads) {
  while (threads >= 32 &&
         block_smem_bytes(d, threads, g) > kMaxBlockSmemBytes)
    threads -= 32;
  return threads >= 32 ? threads : 0;
}

// Lanes of the warp's row group `g` that shuffle together.
__device__ __forceinline__ unsigned group_mask(int g) {
  const int warp_lane = threadIdx.x % 32;
  return (g == 32) ? 0xffffffffu : (((1u << g) - 1u) << (warp_lane / g * g));
}

// One block's share of the work: rows [row_begin, row_end) of the row-major
// (rows, d) matrix x for the coefficient row w. Leaves value_out[0] and
// grad_out[0..d) (written by this block only). Kernel 2's wide rows run
// it. A group forms a row's margin from one read of the row,
// applies the loss, then folds wt * d1 * x_r into its gradient partial.
//
// ROUND_BF16 reproduces the bf16 path of the fixed-effect TPU kernel
// (photon_ml_tpu/ops/pallas_glm.py::_kernel): w is rounded to bf16 before
// the margin product and wt * d1 before the gradient product; both
// products accumulate in f32. Without it all maths is f32 after the load
// (photon_ml_tpu/ops/pallas_re.py::_kernel).
template <typename T, int LOSS, bool ROUND_BF16>
__device__ __forceinline__ void block_value_and_grad(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ y, const float* __restrict__ off,
    const float* __restrict__ wt, int64_t row_begin, int64_t row_end, int d,
    int g, float* __restrict__ value_out, float* __restrict__ grad_out) {
  extern __shared__ float smem[];
  const int n_groups = blockDim.x / g;
  const int64_t ld = d;
  float* w_s = smem;
  float* gpart = smem + ld;
  float* vpart = gpart + n_groups * ld;

  for (int64_t j = threadIdx.x; j < ld; j += blockDim.x)
    w_s[j] = ROUND_BF16 ? round_bf16(w[j]) : w[j];
  for (int64_t j = threadIdx.x; j < n_groups * ld; j += blockDim.x)
    gpart[j] = 0.f;
  for (int j = threadIdx.x; j < n_groups; j += blockDim.x) vpart[j] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x % g;
  const int group = threadIdx.x / g;
  const unsigned mask = group_mask(g);
  float* gp = gpart + group * ld;
  // every lane of a group walks the same rows and takes the same branches,
  // so the group-masked shuffles below always see all of their lanes
  for (int64_t r = row_begin + group; r < row_end; r += n_groups) {
    const float wt_r = wt[r];
    if (!(wt_r > 0.f)) continue;  // padding row: contributes exactly 0
    const T* xr = x + r * (int64_t)d;
    const float off_r = off[r];
    const float y_r = y[r];
    float part = 0.f;
    for (int j = lane; j < d; j += g) part += to_f32(xr[j]) * w_s[j];
    // butterfly: every lane ends with the same, order-fixed sum
    for (int o = g / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(mask, part, o);
    float l, d1;
    loss_and_d1<LOSS>(part + off_r, y_r, &l, &d1);
    const float dv = ROUND_BF16 ? round_bf16(d1 * wt_r) : d1 * wt_r;
    if (lane == 0) vpart[group] += wt_r * l;
    for (int j = lane; j < d; j += g) gp[j] += dv * to_f32(xr[j]);
  }
  __syncthreads();

  // fold the groups' partials in a fixed order: the gradient's d columns,
  // then the one value, the threads striding over both alike
  for (int64_t j = threadIdx.x; j < ld; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_groups; ++k) s += gpart[k * ld + j];
    grad_out[j] = s;
  }
  for (int m = threadIdx.x; m < 1; m += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_groups; ++k) s += vpart[k + m];
    value_out[m] = s;
  }
}

// The second pass of kernels 1-4: for each batch item b (blockIdx.x)
// the sum of its n_rows partial rows of `width` floats (rows b * n_rows ..
// b * n_rows + n_rows - 1 of `partials`), in a fixed order. A 32 x 8 block
// takes 32 columns (blockIdx.y), coalesced over columns; each of its 8
// thread rows walks every 8th partial row in order, then the 8 sums are
// added in order. Column j < split of item b goes to out_a[b * split + j],
// a later one to out_b[b * (width - split) + j - split].
static __global__ void fold_rows_kernel(const float* __restrict__ partials,
                                        int n_rows, int width, int split,
                                        float* __restrict__ out_a,
                                        float* __restrict__ out_b) {
  __shared__ float s[8][33];
  const int64_t b = blockIdx.x;
  const int j = blockIdx.y * 32 + threadIdx.x;
  const float* p = partials + b * n_rows * (int64_t)width;
  float acc = 0.f;
  if (j < width)
    for (int i = threadIdx.y; i < n_rows; i += 8)
      acc += p[(int64_t)i * width + j];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += s[k][threadIdx.x];
    if (j < split)
      out_a[b * split + j] = t;
    else
      out_b[b * (width - split) + j - split] = t;
  }
}

// Launch fold_rows_kernel over `batch` items.
inline cudaError_t fold_rows(const float* partials, int64_t batch,
                             int n_rows, int width, int split, float* out_a,
                             float* out_b, cudaStream_t stream) {
  fold_rows_kernel<<<dim3((unsigned)batch, (width + 31) / 32), dim3(32, 8),
                     0, stream>>>(partials, n_rows, width, split, out_a,
                                  out_b);
  return cudaGetLastError();
}

// Opt a kernel into more than 48 KiB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Run Launch<T, LOSS>::run(args...) for the runtime design type and loss ids
// of a C entry point; an unknown id is cudaErrorInvalidValue.
template <template <typename, int> class Launch, typename T, typename... A>
inline cudaError_t dispatch_loss(int loss, A... args) {
  switch (loss) {
    case LOGISTIC: return Launch<T, LOGISTIC>::run(args...);
    case SQUARED: return Launch<T, SQUARED>::run(args...);
    case POISSON: return Launch<T, POISSON>::run(args...);
    case SMOOTHED_HINGE: return Launch<T, SMOOTHED_HINGE>::run(args...);
  }
  return cudaErrorInvalidValue;
}

template <template <typename, int> class Launch, typename... A>
inline cudaError_t dispatch(int dtype, int loss, A... args) {
  if (dtype == F32) return dispatch_loss<Launch, float>(loss, args...);
  if (dtype == BF16) return dispatch_loss<Launch, __nv_bfloat16>(loss, args...);
  return cudaErrorInvalidValue;
}

// Run Launch<T>::run(args...) for a kernel without a loss (the Hvp).
template <template <typename> class Launch, typename... A>
inline cudaError_t dispatch_dtype(int dtype, A... args) {
  if (dtype == F32) return Launch<float>::run(args...);
  if (dtype == BF16) return Launch<__nv_bfloat16>::run(args...);
  return cudaErrorInvalidValue;
}

}  // namespace photon
