// GLM Hessian-vector product X^T (d2w o (X v)) in ONE pass over a dense design.
//
// Replaces the TPU kernel photon_ml_tpu/ops/pallas_glm.py::fused_hvp (kernel
// body `_hvp_kernel`): for X (n, d) in f32 or bf16, v (d,) and the per-row
// curvature d2w (n,) in f32 (weight * loss'' at the current coefficients,
// 0 on padded rows),
//
//     out = sum_i d2w_i * (x_i . v) * x_i        (the caller adds reg * v)
//
// It serves every conjugate-gradient product of TRON's inner solve, so it
// runs many times per Newton step at fixed d2w.
//
// What bounds it on an H100: bytes. Each product must read X once (n * d *
// itemsize) plus d2w; the arithmetic is 4 operations per element of X.
// The closed form reads X twice (X v, then X^T of the weighted margins);
// here each row group forms x_i . v by a butterfly and folds the weighted
// row into a shared-memory partial while the row is still in L1 — the row
// plan of kernel 1 (glm_common.cuh::block_hvp).
//
// Blocks own contiguous row ranges and write partial rows; fold_kernel sums
// them in a fixed order. No float atomics: TRON's CG is bit-identical run
// to run for a given n.
//
// Precision: an f32 design is full f32 FMA (no TF32). A bf16 design keeps
// the TPU kernel's rounding: v rounded to bf16 before the first product,
// d2w * t before the second, f32 accumulation.
#include "glm_common.cuh"

namespace {

using photon::fold_kernel;

template <typename T, bool ROUND_BF16>
__global__ void hvp_partials_kernel(const T* __restrict__ x,
                                    const float* __restrict__ v,
                                    const float* __restrict__ d2w, int64_t n,
                                    int d, int g, float* __restrict__ scratch) {
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  const int64_t begin = per * blockIdx.x;
  const int64_t end = begin + per < n ? begin + per : n;
  photon::block_hvp<T, ROUND_BF16>(x, v, d2w, begin, end, d, g,
                                   scratch + (int64_t)blockIdx.x * d);
}

constexpr int kThreads = 256;

template <typename T>
struct Launch {
  static cudaError_t run(const void* x, const float* v, const float* d2w,
                         int64_t n, int d, int n_blocks, float* scratch,
                         float* out, cudaStream_t stream) {
    constexpr bool kRound = sizeof(T) == 2;
    const int g = photon::group_size(d);
    const int threads = photon::fit_threads(d, g, kThreads);
    if (threads == 0) return cudaErrorInvalidValue;
    const size_t smem = photon::block_smem_bytes(d, threads, g);
    auto kernel = hvp_partials_kernel<T, kRound>;
    cudaError_t err = photon::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, threads, smem, stream>>>(static_cast<const T*>(x), v,
                                                d2w, n, d, g, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fold_kernel<<<d, photon::kFoldThreads, 0, stream>>>(scratch, n_blocks, d,
                                                        out);
    return cudaGetLastError();
  }
};

}  // namespace

// out[0..d) = X^T (d2w o (X v)). scratch holds n_blocks * d f32.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int photon_fused_hvp(int dtype, const void* x, const float* v,
                                const float* d2w, int64_t n, int d,
                                int n_blocks, float* scratch, float* out,
                                void* stream) {
  return photon::dispatch_dtype<Launch>(dtype, x, v, d2w, n, d, n_blocks,
                                        scratch, out,
                                        static_cast<cudaStream_t>(stream));
}
