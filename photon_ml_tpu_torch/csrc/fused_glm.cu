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
// operations to bytes. So the card has to keep tens of KB of loads in
// flight per SM, and the per-row work (a margin, the loss, a gradient
// update) must not serialise them. Two bodies, chosen by the row width d:
//
// - Narrow rows (d <= kNarrowMaxD; the GAME fixed effect is 33 wide): one
//   thread per row. A block's rows are one contiguous range of X, so a
//   tile of kTileRows consecutive rows is one contiguous span; it is
//   staged in shared memory as the 16-byte granules covering it, by
//   cp.async, in a ring of 2-4 tiles, and read from the tile's lead offset
//   (no realigning). y, off and wt come with it. Each thread forms its
//   row's margin from shared memory (starting at column r % d for an even
//   d, so a warp's 32 rows fall on distinct banks; four sums in turn, so
//   four loads are in flight), evaluates the loss and d1 in registers and
//   writes dv = wt * d1; then each thread owns one column of one row group
//   and adds dv_r * x[r, j] over the group's rows of the tile (two sums in
//   turn), keeping its sums in registers across tiles.
// - Wide rows: one warp per row. A lane owns columns lane + 32k. Up to
//   kHeldCols columns the row stays in registers between the margin and
//   the gradient (X is read from device memory once), the lane's
//   gradient columns live in registers, and the next row's loads are
//   issued before the current row is computed, so each warp has two rows
//   in flight. Wider rows (up to cuda_build.MAX_ROW_WIDTH) are streamed
//   twice in chunks and the gradient lives in a per-warp shared-memory
//   partial.
//
// The TPU kernel sums across sequential grid steps; blocks on this card run
// in no order, so each block writes its (grad, value) partial to a scratch
// row and glm_common.cuh::fold_rows folds the rows in a fixed order,
// coalesced. The block count is a function of the shape (n, d)
// (ops/fused_glm.py::glm_plan), and every sum inside a block runs in an
// order fixed by the shape: no float atomics, so the result is
// bit-identical run to run.
//
// Precision: an f32 design is full f32 FMA (no TF32 — the counterpart of
// Precision.HIGHEST in the TPU kernel). A bf16 design keeps what the TPU
// kernel computes: w rounded to bf16 before the margin product, wt * d1
// rounded to bf16 before the gradient product, f32 accumulation. Rows
// with weight <= 0 (padding) are skipped whole: their margin is never
// formed and they add exactly 0, so Poisson's exp(m) at a padded row's raw
// margin cannot overflow into the sums.
#include <initializer_list>

#include "cp_async.cuh"
#include "glm_common.cuh"

namespace {

using photon::cp_async16;
using photon::cp_async4;
using photon::cp_async_commit;
using photon::cp_async_wait_ring;
using photon::kTwoBlockSmemBytes;
using photon::loss_and_d1;
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
// tile and its y, off, wt), then w (d rounded up to 4), the tile's dv, the
// value reduction, and the row groups' gradient sums (at most kThreads),
// all f32. ops/fused_glm.py::narrow_smem_bytes mirrors it.
inline size_t narrow_smem_bytes(int d, int itemsize, int stages) {
  return stages * (slot_x_bytes(d, itemsize) + 3 * kTileRows * 4) +
         4 * (round_up(d, 4) + kTileRows + kThreads + kThreads);
}

// The most ring stages (2 .. kMaxStages) whose shared memory leaves room
// for two blocks an SM, else for one.
inline int narrow_stages(int d, int itemsize) {
  for (size_t limit : {kTwoBlockSmemBytes, photon::kMaxBlockSmemBytes})
    for (int st = kMaxStages; st >= 2; --st)
      if (narrow_smem_bytes(d, itemsize, st) <= limit) return st;
  return 0;
}

// Dynamic shared memory of a wide-body block of `warps` warps: w (d), a
// gradient partial per warp (warps x d) and a value per warp, all f32 —
// the row-group plan's formula (glm_common.cuh::block_smem_bytes with
// 32-lane groups). ops/fused_glm.py::wide_smem_bytes mirrors it.
inline size_t wide_smem_bytes(int d, int warps) {
  return 4 * ((size_t)d + (size_t)warps * d + warps);
}

// Warps of a wide-body block: as many as fit one block's shared memory,
// at most kWarps; 0 when not even one fits (d > cuda_build.MAX_ROW_WIDTH).
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
// granules covering its span of X by cp.async, and its y, off, wt (0 past
// nr, so such rows are skipped as padding).
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* dst, float* side,
                                           const T* __restrict__ x,
                                           const float* __restrict__ y,
                                           const float* __restrict__ off,
                                           const float* __restrict__ wt,
                                           int64_t r0, int nr, int d) {
  const int tid = threadIdx.x;
  const int lead = lead_bytes(x, r0, d);
  const unsigned char* g0 =
      reinterpret_cast<const unsigned char*>(x + r0 * (int64_t)d) - lead;
  const int granules = (lead + nr * d * (int)sizeof(T) + 15) / 16;
  for (int i = tid; i < granules; i += kThreads)
    cp_async16(dst + 16 * i, g0 + 16 * i);
  for (int i = tid; i < 3 * kTileRows; i += kThreads) {
    const int which = i / kTileRows, r = i % kTileRows;
    const float* src = which == 0 ? y : (which == 1 ? off : wt);
    if (r < nr)
      cp_async4(side + i, src + r0 + r);
    else
      side[i] = 0.f;
  }
}

template <typename T, int LOSS, bool ROUND_BF16>
__global__ void __launch_bounds__(kThreads, 2) narrow_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ y, const float* __restrict__ off,
    const float* __restrict__ wt, int64_t n, int d, int stages,
    float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const size_t slot_bytes = slot_x_bytes(d, sizeof(T));
  unsigned char* ring = smem_raw;
  float* side = reinterpret_cast<float*>(ring + stages * slot_bytes);
  float* w_s = side + stages * 3 * kTileRows;
  float* dv_s = w_s + round_up(d, 4);
  float* red = dv_s + kTileRows;
  float* gsums = red + kThreads;

  int64_t begin, end;
  block_rows(n, &begin, &end);
  const int tiles = (int)((end - begin + kTileRows - 1) / kTileRows);
  for (int j = tid; j < d; j += kThreads)
    w_s[j] = ROUND_BF16 ? round_bf16(w[j]) : w[j];

  // ring prologue: tiles 0 .. stages - 2 in flight
  for (int q = 0; q < stages - 1; ++q) {
    if (q < tiles) {
      const int64_t r0 = begin + (int64_t)q * kTileRows;
      const int nr = end - r0 < kTileRows ? (int)(end - r0) : kTileRows;
      stage_tile(ring + q * slot_bytes, side + q * 3 * kTileRows, x, y, off,
                 wt, r0, nr, d);
    }
    cp_async_commit();
  }

  // the margin walks the row from column c0 and wraps: for an even d the
  // rows of a warp then start on distinct banks
  const int c0 = d % 2 == 0 ? tid % d : 0;
  // the gradient's row groups: thread (group gt, column gj) adds rows gt,
  // gt + groups, ... of each tile to its column
  const int groups = kThreads / d;
  const int gt = tid / d, gj = tid % d;
  // the thread's column sums (rows gt, gt + 2 groups, ... and gt + groups,
  // gt + 3 groups, ...) and its rows' weighted losses
  float gsum = 0.f, gsum2 = 0.f, vsum = 0.f;
  for (int q = 0; q < tiles; ++q) {
    cp_async_wait_ring(stages);
    __syncthreads();  // tile q's copies are visible; slot q - 1 is free
    const int qn = q + stages - 1;
    if (qn < tiles) {
      const int64_t r0 = begin + (int64_t)qn * kTileRows;
      const int nr = end - r0 < kTileRows ? (int)(end - r0) : kTileRows;
      const int slot = qn % stages;
      stage_tile(ring + slot * slot_bytes, side + slot * 3 * kTileRows, x, y,
                 off, wt, r0, nr, d);
    }
    cp_async_commit();
    const int slot = q % stages;
    const int64_t r0 = begin + (int64_t)q * kTileRows;
    const T* tx = reinterpret_cast<const T*>(ring + slot * slot_bytes +
                                             lead_bytes(x, r0, d));
    const float* ts = side + slot * 3 * kTileRows;

    const float wt_r = ts[2 * kTileRows + tid];
    float dv = 0.f;
    if (wt_r > 0.f) {  // else padding (or past the block's rows): 0
      const T* xr = tx + tid * d;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      int j = c0, k = 0;
      for (; k + 4 <= d; k += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = fmaf(to_f32(xr[j]), w_s[j], a[u]);
          j = j + 1 == d ? 0 : j + 1;
        }
      }
      for (; k < d; ++k) {
        a[0] = fmaf(to_f32(xr[j]), w_s[j], a[0]);
        j = j + 1 == d ? 0 : j + 1;
      }
      const float m = (a[0] + a[1]) + (a[2] + a[3]);
      float l, d1;
      loss_and_d1<LOSS>(m + ts[kTileRows + tid], ts[tid], &l, &d1);
      vsum += wt_r * l;
      dv = ROUND_BF16 ? round_bf16(d1 * wt_r) : d1 * wt_r;
    }
    dv_s[tid] = dv;
    __syncthreads();
    if (gt < groups) {
      const T* xc = tx + gj;
      int r = gt;
      for (; r + groups < kTileRows; r += 2 * groups) {
        const float v0 = dv_s[r], v1 = dv_s[r + groups];
        const float x0 = to_f32(xc[r * d]);
        const float x1 = to_f32(xc[(r + groups) * d]);
        if (v0 != 0.f) gsum = fmaf(v0, x0, gsum);
        if (v1 != 0.f) gsum2 = fmaf(v1, x1, gsum2);
      }
      if (r < kTileRows) {
        const float v = dv_s[r];
        if (v != 0.f) gsum = fmaf(v, to_f32(xc[r * d]), gsum);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the block's partial row: the row groups' sums in group order, then the
  // threads' values by a fixed tree
  if (gt < groups) gsums[gt * d + gj] = gsum + gsum2;
  red[tid] = vsum;
  __syncthreads();
  float* row = scratch + (int64_t)blockIdx.x * (d + 1);
  for (int j = tid; j < d; j += kThreads) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += gsums[g * d + j];
    row[j] = s;
  }
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }
  if (tid == 0) row[d] = red[0];
}

// A row of the wide body held in registers: the lane's columns lane + 32k
// (k < K; 0 past d) and the row's wt, off, y.
template <typename T, int K>
struct HeldRow {
  T x[K];
  float wt, off, y;
};

template <typename T, int K>
__device__ __forceinline__ void load_row(HeldRow<T, K>& h,
                                         const T* __restrict__ x,
                                         const float* __restrict__ y,
                                         const float* __restrict__ off,
                                         const float* __restrict__ wt,
                                         int64_t r, int d, int lane) {
  const T* xr = x + r * (int64_t)d + lane;
#pragma unroll
  for (int k = 0; k < K; ++k)
    h.x[k] = 32 * k + lane < d ? xr[32 * k] : T(0.f);
  h.wt = wt[r];
  h.off = off[r];
  h.y = y[r];
}

// The margin of a warp's row from the lanes' partial sums: a butterfly,
// so every lane ends with the same, order-fixed sum.
__device__ __forceinline__ float warp_sum(float part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  return part;
}

// One held row: margin, loss, and dv * x into the lane's gradient columns.
template <typename T, int K, int LOSS, bool ROUND_BF16>
__device__ __forceinline__ void held_row(const HeldRow<T, K>& h,
                                         float (&acc)[K], float* vsum,
                                         const float* w_s, int d, int lane) {
  if (!(h.wt > 0.f)) return;  // padding row: contributes exactly 0
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (32 * k + lane < d)
      part = fmaf(to_f32(h.x[k]), w_s[32 * k + lane], part);
  const float m = warp_sum(part);
  float l, d1;
  loss_and_d1<LOSS>(m + h.off, h.y, &l, &d1);
  *vsum += h.wt * l;
  const float dv = ROUND_BF16 ? round_bf16(d1 * h.wt) : d1 * h.wt;
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = fmaf(dv, to_f32(h.x[k]), acc[k]);
}

// The wide body: warp `warp` of the block takes rows begin + warp,
// begin + warp + warps, ... K > 0 holds rows of at most 32 K columns in
// registers; K == 0 streams wider rows twice (margin, then gradient into
// the warp's shared partial).
// (Rows held at 32 columns a lane need more than 128 registers a thread:
// one block an SM, 8 warps with two rows each in flight, which keeps the
// bytes moving as well as two blocks with spills did.)
template <typename T, int LOSS, bool ROUND_BF16, int K>
__global__ void __launch_bounds__(kThreads, K == 32 ? 1 : 2) wide_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ y, const float* __restrict__ off,
    const float* __restrict__ wt, int64_t n, int d,
    float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warps = blockDim.x / 32;
  float* w_s = smem;
  float* gpart = w_s + d;                       // warps x d
  float* vpart = gpart + (size_t)warps * d;     // warps
  for (int j = tid; j < d; j += blockDim.x)
    w_s[j] = ROUND_BF16 ? round_bf16(w[j]) : w[j];
  if (K == 0)
    for (int64_t j = tid; j < (int64_t)warps * d; j += blockDim.x)
      gpart[j] = 0.f;
  __syncthreads();

  int64_t begin, end;
  block_rows(n, &begin, &end);
  float vsum = 0.f;
  float* gp = gpart + (size_t)warp * d;
  if constexpr (K > 0) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    // two rows in flight a warp: the next row's loads are issued before
    // the current one is computed
    HeldRow<T, K> a, b;
    int64_t r = begin + warp;
    if (r < end) load_row(a, x, y, off, wt, r, d, lane);
    while (r < end) {
      int64_t rn = r + warps;
      if (rn < end) load_row(b, x, y, off, wt, rn, d, lane);
      held_row<T, K, LOSS, ROUND_BF16>(a, acc, &vsum, w_s, d, lane);
      r = rn;
      if (r >= end) break;
      rn = r + warps;
      if (rn < end) load_row(a, x, y, off, wt, rn, d, lane);
      held_row<T, K, LOSS, ROUND_BF16>(b, acc, &vsum, w_s, d, lane);
      r = rn;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (32 * k + lane < d) gp[32 * k + lane] = acc[k];
  } else {
    for (int64_t r = begin + warp; r < end; r += warps) {
      const float wt_r = wt[r];
      if (!(wt_r > 0.f)) continue;  // padding row: contributes exactly 0
      const T* xr = x + r * (int64_t)d;
      const float off_r = off[r], y_r = y[r];
      float part = 0.f;
      for (int c = 0; c < d; c += 32 * kStreamCols) {
        float v[kStreamCols];
#pragma unroll
        for (int i = 0; i < kStreamCols; ++i) {
          const int j = c + 32 * i + lane;
          v[i] = j < d ? to_f32(xr[j]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kStreamCols; ++i) {
          const int j = c + 32 * i + lane;
          if (j < d) part = fmaf(v[i], w_s[j], part);
        }
      }
      const float m = warp_sum(part);
      float l, d1;
      loss_and_d1<LOSS>(m + off_r, y_r, &l, &d1);
      vsum += wt_r * l;
      const float dv = ROUND_BF16 ? round_bf16(d1 * wt_r) : d1 * wt_r;
      for (int c = 0; c < d; c += 32 * kStreamCols) {
        float v[kStreamCols];
#pragma unroll
        for (int i = 0; i < kStreamCols; ++i) {
          const int j = c + 32 * i + lane;
          v[i] = j < d ? to_f32(xr[j]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kStreamCols; ++i) {
          const int j = c + 32 * i + lane;
          if (j < d) gp[j] = fmaf(dv, v[i], gp[j]);
        }
      }
    }
  }
  if (lane == 0) vpart[warp] = vsum;
  __syncthreads();

  // the block's partial row: the warps' partials summed in warp order
  float* row = scratch + (int64_t)blockIdx.x * (d + 1);
  for (int j = tid; j < d; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < warps; ++k) s += gpart[(size_t)k * d + j];
    row[j] = s;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < warps; ++k) s += vpart[k];
    row[d] = s;
  }
}

template <typename T, int LOSS, bool ROUND_BF16, int K>
cudaError_t launch_wide(const T* x, const float* w, const float* y,
                        const float* off, const float* wt, int64_t n, int d,
                        int n_blocks, int warps, float* scratch,
                        cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(d, warps);
  auto kernel = wide_kernel<T, LOSS, ROUND_BF16, K>;
  const cudaError_t err = photon::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, 32 * warps, smem, stream>>>(x, w, y, off, wt, n, d,
                                                 scratch);
  return cudaGetLastError();
}

template <typename T, int LOSS>
struct Launch {
  static cudaError_t run(const void* xv, const float* w, const float* y,
                         const float* off, const float* wt, int64_t n, int d,
                         int n_blocks, float* scratch, float* out,
                         cudaStream_t stream) {
    constexpr bool kRound = sizeof(T) == 2;
    const T* x = static_cast<const T*>(xv);
    cudaError_t err;
    if (d <= kNarrowMaxD) {
      const int stages = narrow_stages(d, sizeof(T));
      const size_t smem = narrow_smem_bytes(d, sizeof(T), stages);
      auto kernel = narrow_kernel<T, LOSS, kRound>;
      err = photon::allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<n_blocks, kThreads, smem, stream>>>(x, w, y, off, wt, n, d,
                                                   stages, scratch);
      err = cudaGetLastError();
    } else {
      const int warps = wide_warps(d);
      if (warps == 0) return cudaErrorInvalidValue;
      if (d <= 256)
        err = launch_wide<T, LOSS, kRound, 8>(x, w, y, off, wt, n, d,
                                              n_blocks, warps, scratch,
                                              stream);
      else if (d <= kHeldCols)
        err = launch_wide<T, LOSS, kRound, kHeldCols / 32>(
            x, w, y, off, wt, n, d, n_blocks, warps, scratch, stream);
      else
        err = launch_wide<T, LOSS, kRound, 0>(x, w, y, off, wt, n, d,
                                              n_blocks, warps, scratch,
                                              stream);
    }
    if (err != cudaSuccess) return err;
    // one batch item: columns [0, d) to grad, column d to the value
    return photon::fold_rows(scratch, 1, n_blocks, d + 1, d, out, out + d,
                             stream);
  }
};

}  // namespace

// out[0..d) = grad, out[d] = value. scratch holds n_blocks * (d + 1) f32;
// n_blocks is ops/fused_glm.py::glm_plan's. Returns the CUDA error code of
// the launches (0 = success).
extern "C" int photon_fused_glm_value_and_grad(
    int loss, int dtype, const void* x, const float* w, const float* y,
    const float* off, const float* wt, int64_t n, int d, int n_blocks,
    float* scratch, float* out, void* stream) {
  return photon::dispatch<Launch>(dtype, loss, x, w, y, off, wt, n, d,
                                  n_blocks, scratch, out,
                                  static_cast<cudaStream_t>(stream));
}
