// Entity-batched GLM value + gradient in ONE pass over a random-effect bucket.
//
// Replaces the TPU kernel
// photon_ml_tpu/ops/pallas_re.py::fused_entity_value_and_grad (kernel body
// `_kernel`): for a bucket X (E, S, D) in f32 or bf16, coefficients W (E, D)
// and y, off, wt (E, S) in f32, per entity e
//
//     value[e] = sum_s wt[e,s] * loss(x[e,s] . w[e] + off[e,s], y[e,s])
//     grad[e]  = sum_s wt[e,s] * loss'(...) * x[e,s]
//
// What bounds it on an H100: bytes — the bucket is read once
// (E * S * D * itemsize plus three f32 (E, S) arrays) for about 4
// operations per element of X. One block per entity: its row groups stride
// over S, hold each margin in registers and fold d1 * x into shared-memory
// partials (glm_common.cuh), which the block reduces in a fixed order.
// Nothing crosses blocks, so the result is deterministic by construction.
// S is looped over and never staged whole, so a head entity with ~10^5
// rows runs in the same kernel; a bucket of few entities with large S
// occupies only a few SMs.
//
// bf16 designs are upcast after the load and all maths is f32, as in the
// TPU kernel (no rounding of w or of wt * d1).
#include "glm_common.cuh"

namespace {

using photon::block_value_and_grad;

template <typename T, int LOSS>
__global__ void entity_kernel(const T* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ y,
                              const float* __restrict__ off,
                              const float* __restrict__ wt, int s, int d,
                              int g, float* __restrict__ values,
                              float* __restrict__ grads) {
  const int64_t e = blockIdx.x;
  const int64_t rows = e * s;
  // row indices are global over the flattened (E * S, D) design, so the
  // (E, S) vectors index with the same r
  block_value_and_grad<T, LOSS, false>(x, w + e * d, y, off, wt, rows,
                                       rows + s, d, g, values + e,
                                       grads + e * d);
}

// Threads per block: enough row groups to cover S (up to 8 warps).
int block_threads(int s, int g) {
  int want = 32;
  while (want < 256 && (int64_t)want < (int64_t)s * g) want <<= 1;
  return want;
}

template <typename T, int LOSS>
struct Launch {
  static cudaError_t run(const void* x, const float* w, const float* y,
                         const float* off, const float* wt, int e, int s,
                         int d, float* values, float* grads,
                         cudaStream_t stream) {
    const int g = photon::group_size(d);
    const int threads = photon::fit_threads(d, g, block_threads(s, g));
    if (threads == 0) return cudaErrorInvalidValue;
    const size_t smem = photon::block_smem_bytes(d, threads, g);
    auto kernel = entity_kernel<T, LOSS>;
    cudaError_t err = photon::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<e, threads, smem, stream>>>(static_cast<const T*>(x), w, y, off,
                                         wt, s, d, g, values, grads);
    return cudaGetLastError();
  }
};

}  // namespace

// values (E,), grads (E, D). Returns the CUDA error code of the launch.
extern "C" int photon_fused_entity_value_and_grad(
    int loss, int dtype, const void* x, const float* w, const float* y,
    const float* off, const float* wt, int e, int s, int d, float* values,
    float* grads, void* stream) {
  return photon::dispatch<Launch>(dtype, loss, x, w, y, off, wt, e, s, d,
                                  values, grads,
                                  static_cast<cudaStream_t>(stream));
}
