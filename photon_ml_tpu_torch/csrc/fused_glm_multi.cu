// Fused GLM value + gradient for M coefficient rows in ONE pass over a dense
// design.
//
// Replaces the TPU kernel
// photon_ml_tpu/ops/pallas_glm.py::fused_value_and_grad_multi (kernel body
// `_kernel_multi`), which the batched regularization sweep reaches: every
// lambda lane shares the data and only its coefficient row differs. For
// X (n, d) in f32 or bf16, ws (M, d) and y, off, wt (n,) in f32, per lane m
//
//     value[m] = sum_i wt_i * loss(x_i . ws[m] + off_i, y_i)
//     grad[m]  = sum_i wt_i * loss'(x_i . ws[m] + off_i, y_i) * x_i
//
// What bounds it on an H100: bytes while M is small. It must read X once
// (n * d * itemsize) for about 4 * M operations per element, so the card's
// ratio of f32 operations to bytes (~20 per byte, ~80 per f32 element) is
// only reached near M ~ 20. A row group reads each row once and forms its M
// margins from that read (up to kLanesPerPass lanes per pass, further
// passes re-read the row from L1), evaluates the loss per lane in
// registers, and folds the M weighted rows into per-lane shared-memory
// gradient partials (glm_common.cuh::block_value_and_grad, the body of
// kernels 1 and 2 too, there with one lane).
//
// Shared memory grows with M: M * d for the coefficient rows plus
// n_groups * M * d for the partials. The block gives up row groups until
// it fits (fit_threads); when not even one warp fits, the wrapper refuses
// the shape before launch (cuda_build.max_row_width) and the entry point
// returns cudaErrorInvalidValue.
//
// As in kernel 1, blocks own contiguous row ranges and write a partial row
// (M * d gradients, then M values) each; fold_kernel sums them in a fixed
// order. No float atomics: bit-identical run to run for a given n.
//
// Precision: an f32 design is full f32 FMA (no TF32). A bf16 design keeps
// kernel 1's rounding: each ws[m] rounded to bf16 before the margin product
// and wt * d1 before the gradient product, f32 accumulation.
#include "glm_common.cuh"

namespace {

using photon::fold_kernel;

template <typename T, int LOSS, bool ROUND_BF16>
__global__ void multi_partials_kernel(const T* __restrict__ x,
                                      const float* __restrict__ ws,
                                      const float* __restrict__ y,
                                      const float* __restrict__ off,
                                      const float* __restrict__ wt, int64_t n,
                                      int d, int g, int lanes,
                                      float* __restrict__ scratch) {
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  const int64_t begin = per * blockIdx.x;
  const int64_t end = begin + per < n ? begin + per : n;
  const int64_t ld = (int64_t)lanes * d;
  float* row = scratch + (int64_t)blockIdx.x * (ld + lanes);
  photon::block_value_and_grad<T, LOSS, ROUND_BF16, photon::kLanesPerPass>(
      x, ws, y, off, wt, begin, end, d, g, row + ld, row, lanes);
}

constexpr int kThreads = 256;

template <typename T, int LOSS>
struct Launch {
  static cudaError_t run(const void* x, const float* ws, const float* y,
                         const float* off, const float* wt, int64_t n, int d,
                         int lanes, int n_blocks, float* scratch, float* out,
                         cudaStream_t stream) {
    constexpr bool kRound = sizeof(T) == 2;
    const int g = photon::group_size(d);
    const int threads = photon::fit_threads(d, g, kThreads, lanes);
    if (threads == 0) return cudaErrorInvalidValue;
    const size_t smem = photon::block_smem_bytes(d, threads, g, lanes);
    auto kernel = multi_partials_kernel<T, LOSS, kRound>;
    cudaError_t err = photon::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, threads, smem, stream>>>(
        static_cast<const T*>(x), ws, y, off, wt, n, d, g, lanes, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int width = lanes * (d + 1);
    fold_kernel<<<width, photon::kFoldThreads, 0, stream>>>(scratch, n_blocks,
                                                            width, out);
    return cudaGetLastError();
  }
};

}  // namespace

// out[0..M*d) = grads (M, d) row-major, out[M*d..M*d+M) = values.
// scratch holds n_blocks * M * (d + 1) f32. Returns the CUDA error code of
// the launches (0 = success).
extern "C" int photon_fused_glm_value_and_grad_multi(
    int loss, int dtype, const void* x, const float* ws, const float* y,
    const float* off, const float* wt, int64_t n, int d, int lanes,
    int n_blocks, float* scratch, float* out, void* stream) {
  return photon::dispatch<Launch>(dtype, loss, x, ws, y, off, wt, n, d, lanes,
                                  n_blocks, scratch, out,
                                  static_cast<cudaStream_t>(stream));
}
