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
// (n * d * itemsize) for about 4 * M f32 operations per element, and the
// card does ~20 f32 operations per byte of HBM, so bytes bind up to M ~ 20.
// To keep HBM busy an SM needs tens of KB of loads in flight, and the
// per-row work has to stay small beside the bytes, so:
//
// - Rows are staged in shared memory by 16-byte cp.async copies, in a ring
//   of 2-4 steps of kStepRows rows: the next steps' loads are in flight
//   while the current one is computed. X is read from device memory once;
//   margins and gradient both read the staged rows.
// - Each thread owns fixed columns (kCols adjacent ones per 1024-column
//   block). For each sub-tile of kTileRows rows it forms the partial
//   margins of kLanes coefficient rows at once (32 sums in registers, over
//   its columns in a fixed order); a reduce-scatter shuffle tree (31
//   shuffles, not 5 x 32) and a fixed walk over the warps finish them.
//   kSubTiles warps evaluate the loss at once, one sub-tile each, and
//   write dv = wt * d1 to shared memory; then the owning threads fold
//   dv * x of the step's rows into ONE block-wide M x d gradient
//   accumulator in shared memory that only the owning thread touches (no
//   atomics, a fixed summation order). Where one pass over one column
//   block covers a row (M <= kLanes, d <= 1024: the batched sweep), each
//   thread holds its coefficients in registers for the whole kernel.
// - Shared memory is M * d floats plus the ring, not one gradient partial
//   per row group, so two 8-warp blocks fit an SM at d = 1024, M = 5. Rows
//   too wide for a ring of whole rows stream in 1024-column chunks:
//   margins over every chunk, then the gradient over the chunks again,
//   re-read from L2 (cuda_build.max_row_width gives the widest row for M
//   lanes; the wrapper refuses wider ones before launch).
// - More than kLanes lanes take several passes over the staged rows.
// - Rows of at most kNarrowCols = 128 columns (where the M x d accumulators
//   of 8 warps fit) take multi_narrow_kernel instead: there one warp
//   covers a whole row, so each warp computes a sub-tile of its own from
//   margins to gradient, and a ring step of 32 rows costs one barrier. With
//   4 of every 1024 columns a thread, a narrow row would leave most warps
//   idle and pay a step's barriers for a few hundred bytes.
// - Rows whose start is not 16-byte aligned (d * itemsize not a multiple
//   of 16, e.g. d = 1025 with an intercept column) are staged as the
//   16-byte granules that cover them, by the same 16-byte cp.async; once a
//   step's copies land, one warp a row shifts the row to its slot's start,
//   so the compute reads every row aligned. X is still read from device
//   memory once (a granule two rows share is read twice from L2).
//
// Blocks own contiguous row ranges (a count that depends on n only,
// ops/fused_glm.py::multi_blocks) and write a partial row (M * d gradients,
// then M values) each; glm_common.cuh::fold_rows sums them with coalesced
// reads in a fixed order. Bit-identical run to run for a given n.
//
// Precision: an f32 design is full f32 FMA (no TF32). A bf16 design keeps
// the TPU kernel's rounding: each ws[m] rounded to bf16 before the margin
// product and wt * d1 before the gradient product, f32 accumulation. Rows
// with weight <= 0 add exactly 0: their margin is never used and the
// gradient pass skips them.
#include <initializer_list>

#include "cp_async.cuh"
#include "glm_common.cuh"

namespace {

using photon::cp_async16;
using photon::cp_async4;
using photon::cp_async_commit;
using photon::cp_async_wait_ring;
using photon::kTwoBlockSmemBytes;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// coefficient rows one pass serves, and rows per sub-tile: a sub-tile's
// kTileRows * kLanes = 32 margins are reduced by one reduce-scatter tree
constexpr int kLanes = 8;
constexpr int kTileRows = 32 / kLanes;
// sub-tiles per ring step: one barrier pair per step, and that many warps
// evaluate the loss at once
constexpr int kSubTiles = 2;
constexpr int kStepRows = kSubTiles * kTileRows;
// columns a thread owns per column block, and the block's width
constexpr int kCols = 4;
constexpr int kBlockCols = kThreads * kCols;
static_assert(kLanes == 2 * kCols, "a row's dv loads as two kCols vectors");
static_assert(kStepRows == kWarps, "a step's unaligned rows: one warp each");
// bytes a slot row holds beyond cw columns when rows are staged unaligned:
// the granules covering a row start up to 15 bytes before it and end up
// to 15 after
constexpr int kUnalignedPadBytes = 32;
constexpr int kMaxStages = 4;
// kCols adjacent staged elements as f32 (8- or 16-byte aligned)
__device__ __forceinline__ void load_cols(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__host__ __device__ inline int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// Elements of a slot row: cw columns, and room for the covering granules
// when rows are staged unaligned.
__host__ __device__ inline int slot_row(int cw, int itemsize, bool aligned) {
  return cw + (aligned ? 0 : kUnalignedPadBytes / itemsize);
}

// Dynamic shared memory of one block: `stages` ring slots of kStepRows
// rows x slot_row columns of the design plus their y, off, wt; the M x dp
// gradient accumulator (dp = d rounded up to 8); each sub-tile's
// cross-warp margin partials and dv, and kStepRows x M value
// accumulators, all f32. photon_ml_tpu_torch/ops/cuda_build.py::
// multi_smem_bytes mirrors it.
inline size_t multi_smem_bytes(int d, int lanes, int cw, int stages,
                               int itemsize, bool aligned) {
  const size_t dp = round_up(d, 8);
  const size_t stage =
      (size_t)kStepRows * slot_row(cw, itemsize, aligned) * itemsize +
      3 * kStepRows * 4;
  return stages * stage +
         4 * ((size_t)lanes * dp + kSubTiles * (kWarps * 32 + 32) +
              (size_t)kStepRows * lanes);
}

// Elements by which row r's columns from c0 on start past a 16-byte
// boundary.
template <typename T>
__device__ __forceinline__ int row_shift(const T* x, int64_t r, int d,
                                         int c0) {
  return (int)(reinterpret_cast<uintptr_t>(x + r * (int64_t)d + c0) % 16) /
         (int)sizeof(T);
}

// Copy a step's rows [r0, r0 + nr) x columns [c0, c0 + ncols) into a ring
// slot of row stride rs by 16-byte cp.async, and their y, off, wt (weight 0
// past the block's rows). Aligned rows (vec) land at their slot row's
// start; otherwise each row's covering granules do, the row row_shift
// elements in, for realign_row to move once they have landed.
template <int ROWS, typename T>
__device__ __forceinline__ void stage_rows(
    T* dst, float* side, const T* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ off, const float* __restrict__ wt, int64_t r0,
    int nr, int d, int c0, int ncols, int rs, bool vec) {
  const int tid = threadIdx.x;
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const int nv = ncols / kVec;
    for (int i = tid; i < nr * nv; i += kThreads) {
      const int r = i / nv, v = i % nv;
      cp_async16(dst + r * rs + v * kVec,
                 x + (r0 + r) * (int64_t)d + c0 + v * kVec);
    }
  } else {
    // granules of a row: at most this many, fewer where it starts early in
    // its first one
    const int most = (ncols * (int)sizeof(T) + 29) / 16;
    for (int i = tid; i < nr * most; i += kThreads) {
      const int r = i / most, v = i % most;
      const T* row = x + (r0 + r) * (int64_t)d + c0;
      const int lead = (int)(reinterpret_cast<uintptr_t>(row) % 16);
      if (v < (lead + ncols * (int)sizeof(T) + 15) / 16)
        cp_async16(reinterpret_cast<unsigned char*>(dst + r * rs) + 16 * v,
                   reinterpret_cast<const unsigned char*>(row) - lead +
                       16 * v);
    }
  }
  if (tid < 3 * ROWS) {
    const int which = tid / ROWS, r = tid % ROWS;
    const float* src = which == 0 ? y : (which == 1 ? off : wt);
    if (r < nr)
      cp_async4(side + tid, src + r0 + r);
    else
      side[tid] = 0.f;
  }
}

// Move a row staged as granules (stage_rows without vec) `shift` elements
// back to its slot row's start and zero its columns [ncols, ncols rounded
// up to kCols), which the compute reads. One warp, 128 columns at a time:
// every lane reads its columns before any lane overwrites them.
template <typename T>
__device__ __forceinline__ void realign_row(T* row, int shift, int ncols) {
  const int lane = threadIdx.x % 32;
  constexpr int kPer = 4;
  if (shift > 0) {
    for (int c0 = 0; c0 < ncols; c0 += 32 * kPer) {
      T v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = c0 + 32 * i + lane;
        if (c < ncols) v[i] = row[c + shift];
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = c0 + 32 * i + lane;
        if (c < ncols) row[c] = v[i];
      }
    }
  }
  if (lane < round_up(ncols, kCols) - ncols) row[ncols + lane] = T(0.f);
}

// The thread's kCols columns col.. of lanes m0 + k (k < mc; 0 elsewhere
// and past d), rounded to bf16 for a bf16 design.
template <bool ROUND_BF16>
__device__ __forceinline__ void load_w(float (&wr)[kLanes][kCols],
                                       const float* __restrict__ ws, int d,
                                       bool wvec, int col, int m0, int mc) {
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const float* wk = ws + (int64_t)(m0 + k) * d + col;
    if (k < mc && wvec && col + kCols <= d) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(wk));
      wr[k][0] = q.x; wr[k][1] = q.y; wr[k][2] = q.z; wr[k][3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        wr[k][c] = (k < mc && col + c < d) ? __ldg(wk + c) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (ROUND_BF16) wr[k][c] = photon::round_bf16(wr[k][c]);
  }
}

// Add to part[r][k] the thread's kCols columns of the margins of a
// sub-tile's kTileRows staged rows (x_col: the first row at the thread's
// first column; row stride rs) for the kLanes coefficient rows in wr.
template <typename T>
__device__ __forceinline__ void add_margins(float (&part)[kTileRows][kLanes],
                                            const float (&wr)[kLanes][kCols],
                                            const T* x_col, int rs) {
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    float xv[kCols];
    load_cols(x_col + r * rs, xv);
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        part[r][k] = fmaf(xv[c], wr[k][c], part[r][k]);
  }
}

// Partial margins part[r][k] of a sub-tile's kTileRows rows for lanes
// m0 + k (k < mc) over the staged chunk's columns [c0, c0 + ncols), each
// thread over its own columns in a fixed order. With w_held the thread's
// coefficients are already in wr (one pass over one column block).
template <typename T, bool ROUND_BF16>
__device__ __forceinline__ void sub_tile_margins(
    float (&part)[kTileRows][kLanes], float (&wr)[kLanes][kCols],
    bool w_held, const T* sub_x, int rs, const float* __restrict__ ws, int d,
    bool wvec, int c0, int ncols, int m0, int mc) {
#pragma unroll
  for (int r = 0; r < kTileRows; ++r)
#pragma unroll
    for (int k = 0; k < kLanes; ++k) part[r][k] = 0.f;
  for (int j = threadIdx.x * kCols; j < ncols; j += kBlockCols) {
    if (!w_held) load_w<ROUND_BF16>(wr, ws, d, wvec, c0 + j, m0, mc);
    add_margins(part, wr, sub_x + j, rs);
  }
}

// One step of the reduce-scatter over a warp: a lane keeps the half of its
// values that its bit H selects and adds its partner's copy of that half.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32],
                                                    int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The warp sum of the sub-tile's partial margin (row lane / kLanes, lane
// lane % kLanes), for every lane at once: a reduce-scatter tree of 31
// shuffles (not 5 x 32), in a fixed order.
__device__ __forceinline__ float warp_margin(
    const float (&part)[kTileRows][kLanes], int lane) {
  float v[32];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r)
#pragma unroll
    for (int k = 0; k < kLanes; ++k) v[r * kLanes + k] = part[r][k];
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

// Store a sub-tile's warp sums to red[warp * 32 + lane], or add them there
// for a later column chunk: one owner per entry, a fixed order.
__device__ __forceinline__ void sub_tile_reduce(
    const float (&part)[kTileRows][kLanes], float* red, bool first) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float m = warp_margin(part, lane);
  red[warp * 32 + lane] = first ? m : red[warp * 32 + lane] + m;
}

// The loss of lane m0 + k at row r of a step of ROWS rows, whose margin
// (without the offset) is m: adds wt * loss to *vacc and returns dv =
// wt * d1 (0 for a padded row or a lane past the last).
template <int LOSS, bool ROUND_BF16, int ROWS>
__device__ __forceinline__ float lane_loss(float m, const float* step_side,
                                           int r, int k, int mc,
                                           float* vacc) {
  const float wt_r = step_side[2 * ROWS + r];
  if (!(k < mc && wt_r > 0.f)) return 0.f;
  float l, d1;
  photon::loss_and_d1<LOSS>(m + step_side[ROWS + r], step_side[r], &l, &d1);
  *vacc += wt_r * l;
  return ROUND_BF16 ? photon::round_bf16(d1 * wt_r) : d1 * wt_r;
}

// One warp per sub-tile: add the warps' sums in order into the margins of
// its (row, lane) pairs, apply the loss, add wt * loss to the value
// accumulators and leave dv = wt * d1 (row r, lane k) in dvs[r * kLanes +
// k], 0 where not live.
template <int LOSS, bool ROUND_BF16>
__device__ __forceinline__ void sub_tile_loss(const float* red, float* dvs,
                                              float* vacc,
                                              const float* step_side,
                                              int row0, int lanes, int m0,
                                              int mc) {
  const int lane = threadIdx.x % 32;
  float m = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m += red[w * 32 + lane];
  const int r = row0 + lane / kLanes, k = lane % kLanes;
  dvs[r * kLanes + k] = lane_loss<LOSS, ROUND_BF16, kStepRows>(
      m, step_side, r, k, mc, vacc + r * lanes + m0 + k);
}

// Fold dv * x of ROWS staged rows (x_col: the first row at the thread's
// first column; row stride rs; weights wt_rows, dv of row r and lane k at
// dv_rows[r * kLanes + k]) into the thread's kCols columns of the gradient
// accumulator's lanes m0 + k (k < mc; g_col: lane 0 at the first column,
// lane stride dp). Rows of weight <= 0 are skipped.
template <int ROWS, typename T>
__device__ __forceinline__ void add_gradient(const T* x_col, int rs,
                                             const float* wt_rows,
                                             const float* dv_rows,
                                             float* g_col, int dp, int m0,
                                             int mc) {
  float acc[kLanes][kCols];
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[k][c] = 0.f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (!(wt_rows[r] > 0.f)) continue;  // uniform
    float xv[kCols], dvr[kLanes];
    load_cols(x_col + r * rs, xv);
    load_cols(dv_rows + r * kLanes, dvr);
    load_cols(dv_rows + r * kLanes + kCols, dvr + kCols);
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const float dv = dvr[k];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[k][c] = fmaf(dv, xv[c], acc[k][c]);
    }
  }
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (k < mc) {
      float4* g = reinterpret_cast<float4*>(g_col + (size_t)(m0 + k) * dp);
      float4 q = *g;
      q.x += acc[k][0]; q.y += acc[k][1]; q.z += acc[k][2];
      q.w += acc[k][3];
      *g = q;
    }
  }
}

// Fold dv * x of the step's live rows into the gradient accumulator's
// columns [c0, c0 + ncols) of lanes m0 + k (k < mc); each thread touches
// only its own columns.
template <typename T>
__device__ __forceinline__ void step_gradient(
    const T* step_x, int rs, const float* step_side, const float* dvs,
    float* gacc, int dp, int c0, int ncols, int m0, int mc) {
  for (int j = threadIdx.x * kCols; j < ncols; j += kBlockCols)
    add_gradient<kStepRows>(step_x + j, rs, step_side + 2 * kStepRows, dvs,
                            gacc + c0 + j, dp, m0, mc);
}

template <typename T, int LOSS, bool ROUND_BF16>
__global__ void __launch_bounds__(kThreads, 2) multi_partials_kernel(
    const T* __restrict__ x, const float* __restrict__ ws,
    const float* __restrict__ y, const float* __restrict__ off,
    const float* __restrict__ wt, int64_t n, int d, int lanes, int cw,
    int stages, bool vec, float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32;
  const int dp = round_up(d, 8);
  const int rs = slot_row(cw, sizeof(T), vec);  // a slot row's stride
  const int slot_elems = kStepRows * rs;
  T* xs = reinterpret_cast<T*>(smem_raw);
  float* side = reinterpret_cast<float*>(xs + (size_t)stages * slot_elems);
  float* gacc = side + stages * 3 * kStepRows;
  float* red = gacc + (size_t)lanes * dp;      // kSubTiles x kWarps x 32
  float* dvs = red + kSubTiles * kWarps * 32;  // kStepRows x kLanes
  float* vacc = dvs + kSubTiles * 32;          // kStepRows x lanes
  const bool wvec = d % 4 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0;

  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  const int64_t begin = per * blockIdx.x;
  const int64_t end = begin + per < n ? begin + per : n;
  const int64_t rows = end > begin ? end - begin : 0;

  // zero the ring (an aligned row's pad columns stay 0: copies never write
  // them) and the accumulators
  {
    float* all = reinterpret_cast<float*>(smem_raw);
    const size_t words = (reinterpret_cast<unsigned char*>(vacc +
                          kStepRows * lanes) - smem_raw) / 4;
    for (size_t i = tid; i < words; i += kThreads) all[i] = 0.f;
  }
  __syncthreads();

  const int nc = (d + cw - 1) / cw;  // column chunks of a row
  const bool resident = nc == 1;      // whole rows staged
  const int passes = (lanes + kLanes - 1) / kLanes;
  // ring steps per step of rows: one (whole rows) or, per pass, the chunks
  // for the margins and then again for the gradient (32-bit counters: a
  // 64-bit division per step costs more than the step's barriers)
  const int per_rows = resident ? 1 : passes * 2 * nc;
  const int steps = (int)((rows + kStepRows - 1) / kStepRows) * per_rows;

  // ring prologue: steps 0 .. stages - 2 in flight
  for (int q = 0; q < stages - 1; ++q) {
    if (q < steps) {
      const int64_t r0 = begin + (int64_t)(q / per_rows) * kStepRows;
      const int c0 = resident ? 0 : (int)(q % per_rows) % nc * cw;
      const int nr = end - r0 < kStepRows ? (int)(end - r0) : kStepRows;
      stage_rows<kStepRows>(xs + (size_t)q * slot_elems,
                            side + q * 3 * kStepRows, x, y, off, wt, r0, nr,
                            d, c0, min(cw, d - c0), rs, vec);
    }
    cp_async_commit();
  }

  // one pass over one column block: the thread's coefficients stay in
  // registers for the whole row range
  const bool w_held = resident && passes == 1 && d <= kBlockCols;
  float part[kTileRows][kLanes], wr[kLanes][kCols];
  if (w_held) load_w<ROUND_BF16>(wr, ws, d, wvec, tid * kCols, 0, lanes);
  for (int q = 0; q < steps; ++q) {
    cp_async_wait_ring(stages);
    __syncthreads();  // step q's copies are visible; slot q - 1 is free
    const int qn = q + stages - 1;
    if (qn < steps) {
      const int64_t r0 = begin + (int64_t)(qn / per_rows) * kStepRows;
      const int c0 = resident ? 0 : qn % per_rows % nc * cw;
      const int nr = end - r0 < kStepRows ? (int)(end - r0) : kStepRows;
      const int slot = qn % stages;
      stage_rows<kStepRows>(xs + (size_t)slot * slot_elems,
                            side + slot * 3 * kStepRows, x, y, off, wt, r0,
                            nr, d, c0, min(cw, d - c0), rs, vec);
    }
    cp_async_commit();
    const int slot = q % stages;
    T* step_x = xs + (size_t)slot * slot_elems;
    const float* step_side = side + slot * 3 * kStepRows;
    const int rem = q % per_rows;
    const int p0 = resident ? 0 : rem / (2 * nc);
    const int p1 = resident ? passes : p0 + 1;
    const int sub = resident ? 0 : rem % (2 * nc);
    const int c0 = sub % nc * cw, ncols = min(cw, d - c0);
    if (!vec) {  // move each staged row to its slot row's start
      const int64_t r = begin + (int64_t)(q / per_rows) * kStepRows + warp;
      if (r < end)
        realign_row(step_x + warp * rs, row_shift(x, r, d, c0), ncols);
      __syncthreads();
    }
    for (int p = p0; p < p1; ++p) {
      const int m0 = p * kLanes, mc = min(kLanes, lanes - m0);
      if (sub < nc) {  // a margin step (every step of whole rows is one)
#pragma unroll
        for (int g = 0; g < kSubTiles; ++g) {
          sub_tile_margins<T, ROUND_BF16>(part, wr, w_held,
                                          step_x + g * kTileRows * rs, rs,
                                          ws, d, wvec, c0, ncols, m0, mc);
          sub_tile_reduce(part, red + g * kWarps * 32, sub == 0);
        }
        if (sub == nc - 1) {
          __syncthreads();
          if (warp < kSubTiles)
            sub_tile_loss<LOSS, ROUND_BF16>(red + warp * kWarps * 32, dvs,
                                            vacc, step_side, warp * kTileRows,
                                            lanes, m0, mc);
          __syncthreads();
        }
      }
      if (resident || sub >= nc)  // a gradient step
        step_gradient(step_x, rs, step_side, dvs, gacc, dp, c0, ncols, m0,
                      mc);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int64_t ld = (int64_t)lanes * d;
  float* row = scratch + (int64_t)blockIdx.x * (ld + lanes);
  for (int64_t i = tid; i < ld; i += kThreads)
    row[i] = gacc[(i / d) * dp + i % d];
  for (int m = tid; m < lanes; m += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kStepRows; ++r) s += vacc[r * lanes + m];
    row[ld + m] = s;
  }
}

// Rows too narrow for the column-owning body (d <= kNarrowCols): a block
// owning 4 of every 1024 columns a thread leaves most of its warps idle,
// and a step of kStepRows rows then costs its barriers for very few bytes.
// Here one warp covers a whole row (lane l owns columns 4l .. 4l + 3), so
// each warp takes a sub-tile of its own: margins, the reduce-scatter (lane
// l ends with the margin of (row l / kLanes, lane l % kLanes), so no walk
// over warps), the loss and the gradient, into its own lanes x d
// accumulator. A ring step holds kWarps sub-tiles and costs one barrier;
// the warps' accumulators are summed in warp order at the end.
constexpr int kNarrowRows = kWarps * kTileRows;
constexpr int kNarrowCols = 32 * kCols;

// Dynamic shared memory of a narrow-row block: `stages` slots of
// kNarrowRows rows with their y, off, wt; one lanes x dp gradient
// accumulator per warp; each warp's dv; kNarrowRows x lanes value
// accumulators, all f32.
inline size_t narrow_smem_bytes(int d, int lanes, int stages, int itemsize,
                                bool aligned) {
  const size_t dp = round_up(d, 8);
  const size_t stage =
      (size_t)kNarrowRows * slot_row(dp, itemsize, aligned) * itemsize +
      3 * kNarrowRows * 4;
  return stages * stage + 4 * ((size_t)kWarps * lanes * dp + kWarps * 32 +
                               (size_t)kNarrowRows * lanes);
}

template <typename T, int LOSS, bool ROUND_BF16>
__global__ void __launch_bounds__(kThreads, 2) multi_narrow_kernel(
    const T* __restrict__ x, const float* __restrict__ ws,
    const float* __restrict__ y, const float* __restrict__ off,
    const float* __restrict__ wt, int64_t n, int d, int lanes, int stages,
    bool vec, float* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dp = round_up(d, 8);
  const int rs = slot_row(dp, sizeof(T), vec);  // a slot row's stride
  const int slot_elems = kNarrowRows * rs;
  T* xs = reinterpret_cast<T*>(smem_raw);
  float* side = reinterpret_cast<float*>(xs + (size_t)stages * slot_elems);
  float* gacc = side + stages * 3 * kNarrowRows;    // kWarps x lanes x dp
  float* dvs = gacc + (size_t)kWarps * lanes * dp;  // kWarps x 32
  float* vacc = dvs + kWarps * 32;                  // kNarrowRows x lanes
  const bool wvec = d % 4 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0;

  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  const int64_t begin = per * blockIdx.x;
  const int64_t end = begin + per < n ? begin + per : n;
  const int64_t rows = end > begin ? end - begin : 0;
  {
    float* all = reinterpret_cast<float*>(smem_raw);
    const size_t words = (reinterpret_cast<unsigned char*>(vacc +
                          kNarrowRows * lanes) - smem_raw) / 4;
    for (size_t i = tid; i < words; i += kThreads) all[i] = 0.f;
  }
  __syncthreads();

  const int passes = (lanes + kLanes - 1) / kLanes;
  const int steps = (int)((rows + kNarrowRows - 1) / kNarrowRows);
  for (int q = 0; q < stages - 1; ++q) {
    if (q < steps) {
      const int64_t r0 = begin + (int64_t)q * kNarrowRows;
      const int nr = end - r0 < kNarrowRows ? (int)(end - r0) : kNarrowRows;
      stage_rows<kNarrowRows>(xs + (size_t)q * slot_elems,
                              side + q * 3 * kNarrowRows, x, y, off, wt, r0,
                              nr, d, 0, d, rs, vec);
    }
    cp_async_commit();
  }

  const int col = lane * kCols;
  const bool w_held = passes == 1;
  float wr[kLanes][kCols];
  if (w_held) load_w<ROUND_BF16>(wr, ws, d, wvec, col, 0, lanes);
  float* my_gacc = gacc + (size_t)warp * lanes * dp;
  float* my_dvs = dvs + warp * 32;
  const int row0 = warp * kTileRows;  // this warp's sub-tile of a step
  for (int q = 0; q < steps; ++q) {
    cp_async_wait_ring(stages);
    __syncthreads();  // step q's copies are visible; slot q - 1 is free
    const int qn = q + stages - 1;
    if (qn < steps) {
      const int64_t r0 = begin + (int64_t)qn * kNarrowRows;
      const int nr = end - r0 < kNarrowRows ? (int)(end - r0) : kNarrowRows;
      const int slot = qn % stages;
      stage_rows<kNarrowRows>(xs + (size_t)slot * slot_elems,
                              side + slot * 3 * kNarrowRows, x, y, off, wt,
                              r0, nr, d, 0, d, rs, vec);
    }
    cp_async_commit();
    const int slot = q % stages;
    T* step_x = xs + (size_t)slot * slot_elems;
    const float* step_side = side + slot * 3 * kNarrowRows;
    if (!vec) {  // move each staged row to its slot row's start
      const int64_t r0 = begin + (int64_t)q * kNarrowRows;
      for (int r = warp; r < kNarrowRows && r0 + r < end; r += kWarps)
        realign_row(step_x + r * rs, row_shift(x, r0 + r, d, 0), d);
      __syncthreads();
    }
    const T* sub_x = step_x + row0 * rs;
    for (int p = 0; p < passes; ++p) {
      const int m0 = p * kLanes, mc = min(kLanes, lanes - m0);
      if (!w_held) load_w<ROUND_BF16>(wr, ws, d, wvec, col, m0, mc);
      float part[kTileRows][kLanes];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int k = 0; k < kLanes; ++k) part[r][k] = 0.f;
      if (col < d) add_margins(part, wr, sub_x + col, rs);
      const float m = warp_margin(part, lane);
      const int r = row0 + lane / kLanes;
      // (row lane / kLanes, lane lane % kLanes) of this warp's sub-tile
      my_dvs[lane] = lane_loss<LOSS, ROUND_BF16, kNarrowRows>(
          m, step_side, r, lane % kLanes, mc,
          vacc + r * lanes + m0 + lane % kLanes);
      __syncwarp();
      if (col < d)
        add_gradient<kTileRows>(sub_x + col, rs,
                                step_side + 2 * kNarrowRows + row0, my_dvs,
                                my_gacc + col, dp, m0, mc);
      __syncwarp();  // the next pass rewrites this warp's dv
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the block's partial row: the warps' gradients summed in warp order,
  // then the values
  const int64_t ld = (int64_t)lanes * d;
  float* out = scratch + (int64_t)blockIdx.x * (ld + lanes);
  for (int64_t i = tid; i < ld; i += kThreads) {
    const int64_t at = (i / d) * dp + i % d;
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += gacc[(int64_t)w * lanes * dp + at];
    out[i] = t;
  }
  for (int m = tid; m < lanes; m += kThreads) {
    float t = 0.f;
    for (int r = 0; r < kNarrowRows; ++r) t += vacc[r * lanes + m];
    out[ld + m] = t;
  }
}

// The most ring stages (2 .. kMaxStages) whose shared memory, bytes(st),
// leaves room for two blocks an SM, else for one; 0 if not even two fit.
template <typename F>
int most_stages(F bytes) {
  for (size_t budget : {kTwoBlockSmemBytes, photon::kMaxBlockSmemBytes})
    for (int st = kMaxStages; st >= 2; --st)
      if (bytes(st) <= budget) return st;
  return 0;
}

template <typename T, int LOSS>
struct Launch {
  static cudaError_t run(const void* x, const float* ws, const float* y,
                         const float* off, const float* wt, int64_t n, int d,
                         int lanes, int n_blocks, float* scratch, float* out,
                         cudaStream_t stream) {
    constexpr bool kRound = sizeof(T) == 2;
    constexpr int isz = sizeof(T);
    const bool vec = (d * isz) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    cudaError_t err;
    // the body is chosen by the shape alone (for narrow rows, unaligned
    // staging, the larger, must fit), so every bit of the result is too
    if (d <= kNarrowCols &&
        narrow_smem_bytes(d, lanes, 2, isz, false) <=
            photon::kMaxBlockSmemBytes) {
      const int stages = most_stages(
          [&](int st) { return narrow_smem_bytes(d, lanes, st, isz, vec); });
      const size_t smem = narrow_smem_bytes(d, lanes, stages, isz, vec);
      auto kernel = multi_narrow_kernel<T, LOSS, kRound>;
      err = photon::allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<n_blocks, kThreads, smem, stream>>>(
          static_cast<const T*>(x), ws, y, off, wt, n, d, lanes, stages, vec,
          scratch);
    } else {
      // whole rows if a ring of them fits, else 1024-column chunks
      int cw = round_up(d, 8);
      auto bytes = [&](int st) {
        return multi_smem_bytes(d, lanes, cw, st, isz, vec);
      };
      int stages = most_stages(bytes);
      if (stages == 0) {
        cw = kBlockCols;
        stages = most_stages(bytes);
        if (stages == 0) return cudaErrorInvalidValue;
      }
      const size_t smem = bytes(stages);
      auto kernel = multi_partials_kernel<T, LOSS, kRound>;
      err = photon::allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<n_blocks, kThreads, smem, stream>>>(
          static_cast<const T*>(x), ws, y, off, wt, n, d, lanes, cw, stages,
          vec, scratch);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int width = lanes * (d + 1);
    return photon::fold_rows(scratch, 1, n_blocks, width, width, out, nullptr,
                             stream);
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
