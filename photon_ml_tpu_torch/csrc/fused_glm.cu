// Fused GLM objective value + gradient in ONE pass over a dense design.
//
// Replaces the TPU kernel photon_ml_tpu/ops/pallas_glm.py::fused_value_and_grad
// (kernel body `_kernel`): for X (n, d) in f32 or bf16, w (d,) and y, off,
// wt (n,) in f32,
//
//     value = sum_i wt_i * loss(x_i . w + off_i, y_i)
//     grad  = sum_i wt_i * loss'(x_i . w + off_i, y_i) * x_i
//
// What bounds it on an H100: bytes. Each evaluation must read X once
// (n * d * itemsize) plus the three f32 row vectors; the arithmetic is
// about 4 operations per element of X, far below the card's ratio of
// operations to bytes. The design streams X once: each block owns a
// contiguous row range, row groups compute margin, loss and derivative in
// registers, and fold d1 * x_i into a shared-memory gradient partial while
// the row is resident (glm_common.cuh).
//
// The TPU kernel sums across sequential grid steps; blocks on this card run
// in no order, so each block writes its (grad, value) partial to a scratch
// row and a second small kernel folds the rows in a fixed order. No float
// atomics: the result is bit-identical run to run for a given n.
//
// Precision: an f32 design is full f32 FMA (no TF32 — the counterpart of
// Precision.HIGHEST in the TPU kernel). A bf16 design keeps what the TPU
// kernel computes: w rounded to bf16 before the margin product, wt * d1
// rounded to bf16 before the gradient product, f32 accumulation.
#include "glm_common.cuh"

namespace {

using photon::block_value_and_grad;
using photon::fold_kernel;

template <typename T, int LOSS, bool ROUND_BF16>
__global__ void partials_kernel(const T* __restrict__ x,
                                const float* __restrict__ w,
                                const float* __restrict__ y,
                                const float* __restrict__ off,
                                const float* __restrict__ wt, int64_t n, int d,
                                int g, float* __restrict__ scratch) {
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  const int64_t begin = per * blockIdx.x;
  const int64_t end = begin + per < n ? begin + per : n;
  float* row = scratch + (int64_t)blockIdx.x * (d + 1);
  block_value_and_grad<T, LOSS, ROUND_BF16>(x, w, y, off, wt, begin, end, d,
                                            g, row + d, row);
}

constexpr int kThreads = 256;

template <typename T, int LOSS>
struct Launch {
  static cudaError_t run(const void* x, const float* w, const float* y,
                         const float* off, const float* wt, int64_t n, int d,
                         int n_blocks, float* scratch, float* out,
                         cudaStream_t stream) {
    constexpr bool kRound = sizeof(T) == 2;
    const int g = photon::group_size(d);
    const int threads = photon::fit_threads(d, g, kThreads);
    if (threads == 0) return cudaErrorInvalidValue;
    const size_t smem = photon::block_smem_bytes(d, threads, g);
    auto kernel = partials_kernel<T, LOSS, kRound>;
    cudaError_t err = photon::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, threads, smem, stream>>>(static_cast<const T*>(x), w,
                                                y, off, wt, n, d, g, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fold_kernel<<<d + 1, photon::kFoldThreads, 0, stream>>>(scratch, n_blocks,
                                                           d + 1, out);
    return cudaGetLastError();
  }
};

}  // namespace

// out[0..d) = grad, out[d] = value. scratch holds n_blocks * (d + 1) f32.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int photon_fused_glm_value_and_grad(
    int loss, int dtype, const void* x, const float* w, const float* y,
    const float* off, const float* wt, int64_t n, int d, int n_blocks,
    float* scratch, float* out, void* stream) {
  return photon::dispatch<Launch>(dtype, loss, x, w, y, off, wt, n, d,
                                  n_blocks, scratch, out,
                                  static_cast<cudaStream_t>(stream));
}
