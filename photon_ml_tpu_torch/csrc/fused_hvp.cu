// GLM Hessian-vector product X^T (d2w o (X v)) in ONE pass over a dense design.
//
// Replaces the TPU kernel photon_ml_tpu/ops/pallas_glm.py::fused_hvp (kernel
// body `_hvp_kernel`): for X (n, d) in f32 or bf16, v (d,) and the per-row
// curvature d2w (n,) in f32 (weight * loss'' at the current coefficients,
// 0 on padded rows),
//
//     out = sum_i c_i * x_i,   c_i = d2w_i * (x_i . v)
//
// (the caller adds reg * v). It serves every conjugate-gradient product of
// TRON's inner solve, so it runs many times per Newton step at fixed d2w.
//
// What bounds it on an H100: bytes. Each product must read the live rows of
// X once (n_live * d * itemsize, a row being live where its d2w is not 0)
// and all of d2w (4n); the arithmetic is 4 f32 operations per element of
// those rows, far below the card's ratio of operations to bytes. So the card
// has to keep tens of KB of loads in flight per SM, and the per-row work (a
// dot product, then c * x) must not serialise them. This is kernel 1's
// gradient (csrc/fused_glm.cu) with the loss replaced by c = d2w * t and no
// value, so it takes kernel 1's two bodies, chosen by the row width d:
//
// - Narrow rows (d <= kNarrowMaxD; the GAME fixed effect is 33 wide): one
//   thread per row. A block's rows are one contiguous range of X, so a
//   tile of kTileRows consecutive rows is one contiguous span; it is
//   staged in shared memory as the 16-byte granules covering it, by
//   cp.async, in a ring of 2-4 tiles with the tile's d2w beside it, and
//   read from the tile's lead offset (no realigning). Each thread forms
//   its row's t = x . v from shared memory (starting at column r % d for
//   an even d, so a warp's 32 rows fall on distinct banks; four sums in
//   turn, so four loads are in flight) and writes c = d2w * t; then each
//   thread owns one column of one row group and adds c_r * x[r, j] over
//   the group's rows of the tile (two sums in turn), keeping its sums in
//   registers across tiles.
// - Wide rows: one warp per row. A lane owns columns lane + 32k. Up to
//   kHeldCols columns the row stays in registers between the two products
//   (X is read from device memory once), the lane's output columns live in
//   registers, and the next row's loads are issued before the current row
//   is computed, so each warp has two rows in flight. Wider rows (up to
//   cuda_build.MAX_ROW_WIDTH) are streamed twice in chunks and the output
//   lives in a per-warp shared-memory partial.
//
// Blocks run in no order, so each block writes its partial row to scratch
// and glm_common.cuh::fold_rows folds the rows in a fixed order, coalesced.
// The block count is a function of the shape (n, d) alone
// (ops/fused_hvp.py::hvp_plan), never of the card or the dtype, and every
// sum inside a block runs in an order fixed by the shape: no float atomics,
// so TRON's CG is bit-identical run to run for a given shape.
//
// Precision: an f32 design is full f32 FMA (no TF32). A bf16 design keeps
// the TPU kernel's rounding: v rounded to bf16 before the first product,
// c before the second, f32 accumulation. A row whose d2w is 0 (every padded
// row) is skipped whole: t is never formed and the row adds exactly 0
// whatever its x. This is d2w != 0, not kernel 1's weight > 0.
#include <initializer_list>

#include "cp_async.cuh"
#include "glm_common.cuh"

namespace {

using photon::cp_async16;
using photon::cp_async4;
using photon::cp_async_commit;
using photon::cp_async_wait_ring;
using photon::kTwoBlockSmemBytes;
using photon::round_bf16;
using photon::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// widest row of the narrow body, and the rows of one of its tiles (one a
// thread)
constexpr int kNarrowMaxD = 64;
constexpr int kTileRows = kThreads;
constexpr int kMaxStages = 4;
// widest row the wide body holds in registers: 32 columns a lane
constexpr int kHeldCols = 1024;
// columns a lane loads at once when a row is streamed (4 KB of f32 a warp
// in flight)
constexpr int kStreamCols = 32;

__host__ __device__ inline size_t round_up(size_t v, size_t to) {
  return (v + to - 1) / to * to;
}

// Bytes of a ring slot's design tile: kTileRows rows of d elements, and
// 16 more for the lead of a span that starts inside a granule.
__host__ __device__ inline size_t slot_x_bytes(int d, int itemsize) {
  return round_up((size_t)kTileRows * d * itemsize, 16) + 16;
}

// Dynamic shared memory of a narrow-body block: `stages` ring slots (the
// tile and its d2w), then v (d rounded up to 4), the tile's c and the row
// groups' output sums (at most kThreads), all f32.
// ops/fused_hvp.py::narrow_smem_bytes mirrors it.
inline size_t narrow_smem_bytes(int d, int itemsize, int stages) {
  return stages * (slot_x_bytes(d, itemsize) + kTileRows * 4) +
         4 * (round_up(d, 4) + kTileRows + kThreads);
}

// The most ring stages (2 .. kMaxStages) whose shared memory leaves room
// for two blocks an SM, else for one.
inline int narrow_stages(int d, int itemsize) {
  for (size_t limit : {kTwoBlockSmemBytes, photon::kMaxBlockSmemBytes})
    for (int st = kMaxStages; st >= 2; --st)
      if (narrow_smem_bytes(d, itemsize, st) <= limit) return st;
  return 0;
}

// Dynamic shared memory of a wide-body block of `warps` warps: v (d) and
// an output partial per warp (warps x d), all f32.
// ops/fused_hvp.py::wide_smem_bytes mirrors it.
inline size_t wide_smem_bytes(int d, int warps) {
  return 4 * ((size_t)d + (size_t)warps * d);
}

// Warps of a wide-body block: as many as fit one block's shared memory,
// at most kWarps; 0 when not even one fits.
inline int wide_warps(int d) {
  int warps = kWarps;
  while (warps > 0 && wide_smem_bytes(d, warps) > photon::kMaxBlockSmemBytes)
    --warps;
  return warps;
}

// The rows [begin, end) of this block: a contiguous split of n rows.
__device__ __forceinline__ void block_rows(int64_t n, int64_t* begin,
                                           int64_t* end) {
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  *begin = per * blockIdx.x;
  *end = *begin + per < n ? *begin + per : n;
  if (*end < *begin) *end = *begin;
}

// Bytes by which the span of rows from r0 on starts past a 16-byte
// boundary: where a staged tile starts in its slot.
template <typename T>
__device__ __forceinline__ int lead_bytes(const T* x, int64_t r0, int d) {
  return (int)(reinterpret_cast<uintptr_t>(x + r0 * (int64_t)d) % 16);
}

// Copy the tile of rows [r0, r0 + nr) into a ring slot: the 16-byte
// granules covering its span of X by cp.async, and its d2w (0 past nr, so
// such rows are skipped).
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* dst, float* side,
                                           const T* __restrict__ x,
                                           const float* __restrict__ d2w,
                                           int64_t r0, int nr, int d) {
  const int tid = threadIdx.x;
  const int lead = lead_bytes(x, r0, d);
  const unsigned char* g0 =
      reinterpret_cast<const unsigned char*>(x + r0 * (int64_t)d) - lead;
  const int granules = (lead + nr * d * (int)sizeof(T) + 15) / 16;
  for (int i = tid; i < granules; i += kThreads)
    cp_async16(dst + 16 * i, g0 + 16 * i);
  if (tid < nr)
    cp_async4(side + tid, d2w + r0 + tid);
  else
    side[tid] = 0.f;
}

template <typename T, bool ROUND_BF16>
__global__ void __launch_bounds__(kThreads, 2) narrow_kernel(
    const T* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ d2w, int64_t n, int d, int stages,
    float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const size_t slot_bytes = slot_x_bytes(d, sizeof(T));
  unsigned char* ring = smem_raw;
  float* side = reinterpret_cast<float*>(ring + stages * slot_bytes);
  float* v_s = side + stages * kTileRows;
  float* c_s = v_s + round_up(d, 4);
  float* gsums = c_s + kTileRows;

  int64_t begin, end;
  block_rows(n, &begin, &end);
  const int tiles = (int)((end - begin + kTileRows - 1) / kTileRows);
  for (int j = tid; j < d; j += kThreads)
    v_s[j] = ROUND_BF16 ? round_bf16(v[j]) : v[j];

  // ring prologue: tiles 0 .. stages - 2 in flight
  for (int q = 0; q < stages - 1; ++q) {
    if (q < tiles) {
      const int64_t r0 = begin + (int64_t)q * kTileRows;
      const int nr = end - r0 < kTileRows ? (int)(end - r0) : kTileRows;
      stage_tile(ring + q * slot_bytes, side + q * kTileRows, x, d2w, r0, nr,
                 d);
    }
    cp_async_commit();
  }

  // t walks the row from column c0 and wraps: for an even d the rows of a
  // warp then start on distinct banks
  const int c0 = d % 2 == 0 ? tid % d : 0;
  // the second product's row groups: thread (group gt, column gj) adds
  // rows gt, gt + groups, ... of each tile to its column
  const int groups = kThreads / d;
  const int gt = tid / d, gj = tid % d;
  // the thread's column sums (rows gt, gt + 2 groups, ... and gt + groups,
  // gt + 3 groups, ...)
  float gsum = 0.f, gsum2 = 0.f;
  for (int q = 0; q < tiles; ++q) {
    cp_async_wait_ring(stages);
    __syncthreads();  // tile q's copies are visible; slot q - 1 is free
    const int qn = q + stages - 1;
    if (qn < tiles) {
      const int64_t r0 = begin + (int64_t)qn * kTileRows;
      const int nr = end - r0 < kTileRows ? (int)(end - r0) : kTileRows;
      const int slot = qn % stages;
      stage_tile(ring + slot * slot_bytes, side + slot * kTileRows, x, d2w,
                 r0, nr, d);
    }
    cp_async_commit();
    const int slot = q % stages;
    const int64_t r0 = begin + (int64_t)q * kTileRows;
    const T* tx = reinterpret_cast<const T*>(ring + slot * slot_bytes +
                                             lead_bytes(x, r0, d));

    const float d2w_r = side[slot * kTileRows + tid];
    float c = 0.f;
    if (d2w_r != 0.f) {  // else no curvature (or past the block's rows): 0
      const T* xr = tx + tid * d;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      int j = c0, k = 0;
      for (; k + 4 <= d; k += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = fmaf(to_f32(xr[j]), v_s[j], a[u]);
          j = j + 1 == d ? 0 : j + 1;
        }
      }
      for (; k < d; ++k) {
        a[0] = fmaf(to_f32(xr[j]), v_s[j], a[0]);
        j = j + 1 == d ? 0 : j + 1;
      }
      const float t = (a[0] + a[1]) + (a[2] + a[3]);
      c = ROUND_BF16 ? round_bf16(d2w_r * t) : d2w_r * t;
    }
    c_s[tid] = c;
    __syncthreads();
    if (gt < groups) {
      const T* xc = tx + gj;
      int r = gt;
      for (; r + groups < kTileRows; r += 2 * groups) {
        const float v0 = c_s[r], v1 = c_s[r + groups];
        const float x0 = to_f32(xc[r * d]);
        const float x1 = to_f32(xc[(r + groups) * d]);
        if (v0 != 0.f) gsum = fmaf(v0, x0, gsum);
        if (v1 != 0.f) gsum2 = fmaf(v1, x1, gsum2);
      }
      if (r < kTileRows) {
        const float c_r = c_s[r];
        if (c_r != 0.f) gsum = fmaf(c_r, to_f32(xc[r * d]), gsum);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the block's partial row: the row groups' sums in group order
  if (gt < groups) gsums[gt * d + gj] = gsum + gsum2;
  __syncthreads();
  float* row = scratch + (int64_t)blockIdx.x * d;
  for (int j = tid; j < d; j += kThreads) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += gsums[g * d + j];
    row[j] = s;
  }
}

// A row of the wide body held in registers: the lane's columns lane + 32k
// (k < K; 0 past d) and the row's d2w.
template <typename T, int K>
struct HeldRow {
  T x[K];
  float d2w;
};

template <typename T, int K>
__device__ __forceinline__ void load_row(HeldRow<T, K>& h,
                                         const T* __restrict__ x,
                                         const float* __restrict__ d2w,
                                         int64_t r, int d, int lane) {
  const T* xr = x + r * (int64_t)d + lane;
#pragma unroll
  for (int k = 0; k < K; ++k)
    h.x[k] = 32 * k + lane < d ? xr[32 * k] : T(0.f);
  h.d2w = d2w[r];
}

// t of a warp's row from the lanes' partial sums: a butterfly, so every
// lane ends with the same, order-fixed sum.
__device__ __forceinline__ float warp_sum(float part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  return part;
}

// One held row: t = x . v, then c * x into the lane's output columns.
template <typename T, int K, bool ROUND_BF16>
__device__ __forceinline__ void held_row(const HeldRow<T, K>& h,
                                         float (&acc)[K], const float* v_s,
                                         int d, int lane) {
  if (h.d2w == 0.f) return;  // no curvature (or padding): exactly 0
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (32 * k + lane < d)
      part = fmaf(to_f32(h.x[k]), v_s[32 * k + lane], part);
  const float t = warp_sum(part);
  const float c = ROUND_BF16 ? round_bf16(h.d2w * t) : h.d2w * t;
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = fmaf(c, to_f32(h.x[k]), acc[k]);
}

// The wide body: warp `warp` of the block takes rows begin + warp,
// begin + warp + warps, ... K > 0 holds rows of at most 32 K columns in
// registers; K == 0 streams wider rows twice (t, then c * x into the
// warp's shared partial).
// (Rows held at 32 columns a lane need more than 128 registers a thread:
// one block an SM, 8 warps with two rows each in flight, as kernel 1's.)
template <typename T, bool ROUND_BF16, int K>
__global__ void __launch_bounds__(kThreads, K == 32 ? 1 : 2) wide_kernel(
    const T* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ d2w, int64_t n, int d,
    float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warps = blockDim.x / 32;
  float* v_s = smem;
  float* gpart = v_s + d;  // warps x d
  for (int j = tid; j < d; j += blockDim.x)
    v_s[j] = ROUND_BF16 ? round_bf16(v[j]) : v[j];
  if (K == 0)
    for (int64_t j = tid; j < (int64_t)warps * d; j += blockDim.x)
      gpart[j] = 0.f;
  __syncthreads();

  int64_t begin, end;
  block_rows(n, &begin, &end);
  float* gp = gpart + (size_t)warp * d;
  if constexpr (K > 0) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    // two rows in flight a warp: the next row's loads are issued before
    // the current one is computed
    HeldRow<T, K> a, b;
    int64_t r = begin + warp;
    if (r < end) load_row(a, x, d2w, r, d, lane);
    while (r < end) {
      int64_t rn = r + warps;
      if (rn < end) load_row(b, x, d2w, rn, d, lane);
      held_row<T, K, ROUND_BF16>(a, acc, v_s, d, lane);
      r = rn;
      if (r >= end) break;
      rn = r + warps;
      if (rn < end) load_row(a, x, d2w, rn, d, lane);
      held_row<T, K, ROUND_BF16>(b, acc, v_s, d, lane);
      r = rn;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (32 * k + lane < d) gp[32 * k + lane] = acc[k];
  } else {
    for (int64_t r = begin + warp; r < end; r += warps) {
      const float d2w_r = d2w[r];
      if (d2w_r == 0.f) continue;  // no curvature (or padding): exactly 0
      const T* xr = x + r * (int64_t)d;
      float part = 0.f;
      for (int c = 0; c < d; c += 32 * kStreamCols) {
        float u[kStreamCols];
#pragma unroll
        for (int i = 0; i < kStreamCols; ++i) {
          const int j = c + 32 * i + lane;
          u[i] = j < d ? to_f32(xr[j]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kStreamCols; ++i) {
          const int j = c + 32 * i + lane;
          if (j < d) part = fmaf(u[i], v_s[j], part);
        }
      }
      const float t = warp_sum(part);
      const float cr = ROUND_BF16 ? round_bf16(d2w_r * t) : d2w_r * t;
      for (int c = 0; c < d; c += 32 * kStreamCols) {
        float u[kStreamCols];
#pragma unroll
        for (int i = 0; i < kStreamCols; ++i) {
          const int j = c + 32 * i + lane;
          u[i] = j < d ? to_f32(xr[j]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kStreamCols; ++i) {
          const int j = c + 32 * i + lane;
          if (j < d) gp[j] = fmaf(cr, u[i], gp[j]);
        }
      }
    }
  }
  __syncthreads();

  // the block's partial row: the warps' partials summed in warp order
  float* row = scratch + (int64_t)blockIdx.x * d;
  for (int j = tid; j < d; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < warps; ++k) s += gpart[(size_t)k * d + j];
    row[j] = s;
  }
}

template <typename T, bool ROUND_BF16, int K>
cudaError_t launch_wide(const T* x, const float* v, const float* d2w,
                        int64_t n, int d, int n_blocks, int warps,
                        float* scratch, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(d, warps);
  auto kernel = wide_kernel<T, ROUND_BF16, K>;
  const cudaError_t err = photon::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, 32 * warps, smem, stream>>>(x, v, d2w, n, d, scratch);
  return cudaGetLastError();
}

template <typename T>
struct Launch {
  static cudaError_t run(const void* xv, const float* v, const float* d2w,
                         int64_t n, int d, int n_blocks, float* scratch,
                         float* out, cudaStream_t stream) {
    constexpr bool kRound = sizeof(T) == 2;
    const T* x = static_cast<const T*>(xv);
    cudaError_t err;
    if (d <= kNarrowMaxD) {
      const int stages = narrow_stages(d, sizeof(T));
      const size_t smem = narrow_smem_bytes(d, sizeof(T), stages);
      auto kernel = narrow_kernel<T, kRound>;
      err = photon::allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<n_blocks, kThreads, smem, stream>>>(x, v, d2w, n, d, stages,
                                                   scratch);
      err = cudaGetLastError();
    } else {
      const int warps = wide_warps(d);
      if (warps == 0) return cudaErrorInvalidValue;
      if (d <= 256)
        err = launch_wide<T, kRound, 8>(x, v, d2w, n, d, n_blocks, warps,
                                        scratch, stream);
      else if (d <= kHeldCols)
        err = launch_wide<T, kRound, kHeldCols / 32>(x, v, d2w, n, d,
                                                     n_blocks, warps, scratch,
                                                     stream);
      else
        err = launch_wide<T, kRound, 0>(x, v, d2w, n, d, n_blocks, warps,
                                        scratch, stream);
    }
    if (err != cudaSuccess) return err;
    // one batch item, all d columns to out
    return photon::fold_rows(scratch, 1, n_blocks, d, d, out, nullptr,
                             stream);
  }
};

}  // namespace

// out[0..d) = X^T (d2w o (X v)). scratch holds n_blocks * d f32; n_blocks
// is ops/fused_hvp.py::hvp_plan's. Returns the CUDA error code of the
// launches (0 = success).
extern "C" int photon_fused_hvp(int dtype, const void* x, const float* v,
                                const float* d2w, int64_t n, int d,
                                int n_blocks, float* scratch, float* out,
                                void* stream) {
  return photon::dispatch_dtype<Launch>(dtype, x, v, d2w, n, d, n_blocks,
                                        scratch, out,
                                        static_cast<cudaStream_t>(stream));
}
