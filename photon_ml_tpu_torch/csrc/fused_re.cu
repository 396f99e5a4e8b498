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
// operations per element of X. A bucket is a few MB, so what keeps it from
// that bound is spreading the bytes over the card's 132 SMs and keeping
// loads in flight, whatever the bucket's shape:
//
// - Split S. The chunk plan (ops/fused_re.py::entity_plan, a function of
//   (E, S, D) alone) gives each entity C chunks of rows; a unit of work is
//   one (entity, chunk). A head bucket of a few entities with ~10^5 rows
//   each becomes hundreds of blocks. With C > 1 units write (E, C, D + 1)
//   partials and glm_common.cuh::fold_rows sums each entity's C partials
//   in a fixed order; with C = 1 units write the outputs and there is no
//   second launch.
// - Narrow rows (D <= kMaxNarrow, the e2e buckets' D = 8): one thread per
//   row. A thread loads its whole row (16-byte vector loads where the row
//   is 16-byte aligned), forms the margin in registers in a fixed order,
//   evaluates the loss, and keeps the value and the D gradient sums in
//   registers across its rows; a fixed shuffle tree (and, past one warp, a
//   fixed walk over warps) reduces them at the end. No per-row shuffles,
//   no shared-memory read-modify-writes.
// - Pack small S. A unit gets the smallest power of two of threads that
//   covers its rows (at most a block), so a block of 256 threads serves
//   256 / that many units: a bucket of many one-row entities is not a grid
//   of mostly idle blocks.
// - Wider rows keep the row-group body of kernel 1
//   (glm_common.cuh::block_value_and_grad), one block per unit, S still
//   split.
//
// No float atomics; every sum has a fixed order, so the result is
// bit-identical run to run. Rows with weight <= 0 are skipped whole (their
// margin is never formed). bf16 designs are upcast after the load and all
// maths is f32, as in the TPU kernel (no rounding of w or of wt * d1).
#include "glm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// widest row of the one-thread-per-row body (ops/fused_re.py NARROW_MAX_D)
constexpr int kMaxNarrow = 16;

// Row r of width d (<= DM) as f32, zero past d. vec: the row is DM wide and
// 16-byte aligned, so it loads as 16-byte vectors.
template <int DM>
__device__ __forceinline__ void load_row(const float* __restrict__ xr, int d,
                                         bool vec, float* v) {
  if (DM % 4 == 0 && vec) {
#pragma unroll
    for (int i = 0; i < DM / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(xr) + i);
      v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DM; ++j) v[j] = j < d ? __ldg(xr + j) : 0.f;
  }
}
template <int DM>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ xr,
                                         int d, bool vec, float* v) {
  if (DM % 8 == 0 && vec) {
#pragma unroll
    for (int i = 0; i < DM / 8; ++i) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(xr) + i);
      const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u[k]);
        v[8 * i + 2 * k] = __low2float(b);
        v[8 * i + 2 * k + 1] = __high2float(b);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < DM; ++j) v[j] = j < d ? photon::to_f32(xr[j]) : 0.f;
  }
}

// Narrow body: unit u = (entity u / chunks, chunk u % chunks) is served by
// `unit_threads` consecutive threads (a power of two <= kThreads), one row
// each at a time.
template <typename T, int LOSS, int DM>
__global__ void __launch_bounds__(kThreads) entity_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ y, const float* __restrict__ off,
    const float* __restrict__ wt, int e, int s, int d, int chunks,
    int chunk_rows, int unit_threads, bool vec, float* __restrict__ values,
    float* __restrict__ grads, float* __restrict__ partials) {
  __shared__ float red[kWarps][DM + 1];
  const int per_block = kThreads / unit_threads;
  const int64_t unit =
      (int64_t)blockIdx.x * per_block + threadIdx.x / unit_threads;
  const int lane = threadIdx.x % unit_threads;
  const bool real = unit < (int64_t)e * chunks;
  const int64_t ent = real ? unit / chunks : 0;
  float acc[DM], val = 0.f;
#pragma unroll
  for (int j = 0; j < DM; ++j) acc[j] = 0.f;
  if (real) {
    const int c = (int)(unit % chunks);
    float wr[DM];
#pragma unroll
    for (int j = 0; j < DM; ++j) wr[j] = j < d ? w[ent * d + j] : 0.f;
    const int64_t base = ent * s;
    const int64_t r1 = base + min(s, (c + 1) * chunk_rows);
    for (int64_t r = base + (int64_t)c * chunk_rows + lane; r < r1;
         r += unit_threads) {
      const float wt_r = wt[r];
      if (!(wt_r > 0.f)) continue;  // padding row: contributes exactly 0
      float xv[DM];
      load_row<DM>(x + r * d, d, vec, xv);
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < DM; ++j) m = fmaf(xv[j], wr[j], m);
      float l, d1;
      photon::loss_and_d1<LOSS>(m + off[r], y[r], &l, &d1);
      val += wt_r * l;
      const float g = d1 * wt_r;
#pragma unroll
      for (int j = 0; j < DM; ++j) acc[j] = fmaf(g, xv[j], acc[j]);
    }
  }
  // butterfly over the unit's lanes (within a warp), every lane of the
  // warp taking part
  const int span = unit_threads < 32 ? unit_threads : 32;
  for (int o = span / 2; o > 0; o >>= 1) {
    val += __shfl_xor_sync(0xffffffffu, val, o);
#pragma unroll
    for (int j = 0; j < DM; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (unit_threads > 32) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int j = 0; j < DM; ++j) red[warp][j] = acc[j];
      red[warp][DM] = val;
    }
    __syncthreads();
    if (lane == 0) {
      const int w0 = warp, nw = unit_threads / 32;
#pragma unroll
      for (int j = 0; j <= DM; ++j) {
        float t = 0.f;
        for (int k = 0; k < nw; ++k) t += red[w0 + k][j];
        if (j < DM) acc[j] = t; else val = t;
      }
    }
  }
  if (!real || lane != 0) return;
  if (chunks == 1) {
    values[ent] = val;
#pragma unroll
    for (int j = 0; j < DM; ++j)
      if (j < d) grads[ent * d + j] = acc[j];
  } else {
    float* p = partials + unit * (d + 1);
#pragma unroll
    for (int j = 0; j < DM; ++j)
      if (j < d) p[j] = acc[j];
    p[d] = val;
  }
}

// Wide body: one block per unit, kernel 1's row groups over its rows.
template <typename T, int LOSS>
__global__ void entity_wide_kernel(const T* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ y,
                                   const float* __restrict__ off,
                                   const float* __restrict__ wt, int s, int d,
                                   int g, int chunks, int chunk_rows,
                                   float* __restrict__ values,
                                   float* __restrict__ grads,
                                   float* __restrict__ partials) {
  const int64_t unit = blockIdx.x;
  const int64_t ent = unit / chunks;
  const int c = (int)(unit % chunks);
  const int64_t base = ent * s;
  // row indices are global over the flattened (E * S, D) design, so the
  // (E, S) vectors index with the same r
  const int64_t begin = base + (int64_t)c * chunk_rows;
  const int64_t end = base + min(s, (c + 1) * chunk_rows);
  float* vout = chunks == 1 ? values + ent : partials + unit * (d + 1) + d;
  float* gout = chunks == 1 ? grads + ent * d : partials + unit * (d + 1);
  photon::block_value_and_grad<T, LOSS, false>(x, w + ent * d, y, off, wt,
                                               begin, end, d, g, vout, gout);
}

// Threads per wide-body block: enough row groups to cover the unit's rows
// (up to 8 warps).
int block_threads(int rows, int g) {
  int want = 32;
  while (want < kThreads && (int64_t)want < (int64_t)rows * g) want <<= 1;
  return want;
}

template <typename T, int LOSS, int DM>
cudaError_t launch_rows(const T* x, const float* w, const float* y,
                        const float* off, const float* wt, int e, int s,
                        int d, int chunks, int chunk_rows, int unit_threads,
                        int blocks, float* values, float* grads,
                        float* partials, cudaStream_t stream) {
  const bool vec = d == DM && (DM * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  entity_rows_kernel<T, LOSS, DM><<<blocks, kThreads, 0, stream>>>(
      x, w, y, off, wt, e, s, d, chunks, chunk_rows, unit_threads, vec,
      values, grads, partials);
  return cudaGetLastError();
}

template <typename T, int LOSS>
struct Launch {
  static cudaError_t run(const void* xv, const float* w, const float* y,
                         const float* off, const float* wt, int e, int s,
                         int d, int chunks, int chunk_rows, int unit_threads,
                         int blocks, float* partials, float* values,
                         float* grads, cudaStream_t stream) {
    const T* x = static_cast<const T*>(xv);
    if (unit_threads < 1 || unit_threads > kThreads ||
        (unit_threads & (unit_threads - 1)) != 0 || chunks < 1)
      return cudaErrorInvalidValue;
    cudaError_t err;
    if (d <= 2)
      err = launch_rows<T, LOSS, 2>(x, w, y, off, wt, e, s, d, chunks,
                                    chunk_rows, unit_threads, blocks, values,
                                    grads, partials, stream);
    else if (d <= 4)
      err = launch_rows<T, LOSS, 4>(x, w, y, off, wt, e, s, d, chunks,
                                    chunk_rows, unit_threads, blocks, values,
                                    grads, partials, stream);
    else if (d <= 8)
      err = launch_rows<T, LOSS, 8>(x, w, y, off, wt, e, s, d, chunks,
                                    chunk_rows, unit_threads, blocks, values,
                                    grads, partials, stream);
    else if (d <= kMaxNarrow)
      err = launch_rows<T, LOSS, kMaxNarrow>(
          x, w, y, off, wt, e, s, d, chunks, chunk_rows, unit_threads,
          blocks, values, grads, partials, stream);
    else {
      const int g = photon::group_size(d);
      const int threads = photon::fit_threads(d, g,
                                              block_threads(chunk_rows, g));
      if (threads == 0) return cudaErrorInvalidValue;
      const size_t smem = photon::block_smem_bytes(d, threads, g);
      auto kernel = entity_wide_kernel<T, LOSS>;
      err = photon::allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<blocks, threads, smem, stream>>>(x, w, y, off, wt, s, d, g,
                                                chunks, chunk_rows, values,
                                                grads, partials);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess || chunks == 1) return err;
    // each entity's partial rows: D gradients to grads, the value to values
    return photon::fold_rows(partials, e, chunks, d + 1, d, grads, values,
                             stream);
  }
};

}  // namespace

// values (E,), grads (E, D). The chunk plan (chunks, chunk_rows,
// unit_threads, blocks) is ops/fused_re.py::entity_plan's; with chunks > 1
// partials holds E * chunks * (D + 1) f32. Returns the CUDA error code of
// the launches (0 = success).
extern "C" int photon_fused_entity_value_and_grad(
    int loss, int dtype, const void* x, const float* w, const float* y,
    const float* off, const float* wt, int e, int s, int d, int chunks,
    int chunk_rows, int unit_threads, int blocks, float* partials,
    float* values, float* grads, void* stream) {
  return photon::dispatch<Launch>(dtype, loss, x, w, y, off, wt, e, s, d,
                                  chunks, chunk_rows, unit_threads, blocks,
                                  partials, values, grads,
                                  static_cast<cudaStream_t>(stream));
}
