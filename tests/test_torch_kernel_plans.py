"""The block plans of kernels 1, 2 and 4, which the CUDA kernels take from
Python: what they cover, that they depend on the shape alone, and that the
partitions kernels 1 and 2 sum in give the function their plain versions
compute.

- kernel 1 (photon_ml_tpu_torch.ops.fused_glm.glm_plan): every row lies in
  exactly one block's range and, within it, in one tile (narrow body) or
  one warp's rows (wide body); the block count depends on (n, d) alone,
  the body on d alone (narrow up to GLM_NARROW_MAX_D columns); a block's
  shared memory fits 227 KiB up to cuda_build.MAX_ROW_WIDTH. The plain
  version summed per block, then over the blocks in order, equals the
  plain version on the whole design (f64, 1e-6);

- kernel 2 (photon_ml_tpu_torch.ops.fused_re.entity_plan): each entity's S
  rows are cut into chunks; every row lies in exactly one chunk; a head
  bucket (a few entities with ~10^5 rows each) is spread over at least
  132 blocks (one per SM of an H100); many small entities share a block.
  The plain version summed per chunk, then folded over the chunks in
  order, equals the plain version on the whole bucket (f64, 1e-6); a lane
  slice planned for its whole bucket (``plan_lanes``) keeps the bucket's
  chunks, and its blocks cover its own units;
- kernel 3 (photon_ml_tpu_torch.ops.fused_hvp.hvp_plan): kernel 1's plan
  with kernel 3's shared memory, held to the same rules; the plain version
  summed per block equals the plain version on the whole design (f64,
  1e-12), rows without curvature and with x = 1e30 among them;
- kernel 4 (photon_ml_tpu_torch.ops.fused_glm.multi_blocks): the block
  count is a function of n alone.

The kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there).
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import cuda_build, fused_glm, fused_hvp, fused_re
from photon_ml_tpu_torch.ops import losses as tl

LOSSES = {"logistic": tl.LogisticLoss, "squared": tl.SquaredLoss,
          "poisson": tl.PoissonLoss, "smoothed_hinge": tl.SmoothedHingeLoss}
#: the head buckets of the end-to-end GLMix data: a few entities with S of
#: about 89k and 98k rows of the 8-wide item shard
HEAD_BUCKETS = [(1, 98_000, 8), (2, 89_000, 8), (3, 97_999, 8),
                (1, 89_013, 8)]
SHAPES = HEAD_BUCKETS + [(3, 100_001, 8), (40_000, 1, 8), (10_000, 3, 8),
                         (500, 40, 8), (50, 5_000, 17), (3, 40, 8192),
                         (7, 37, 5), (1, 1, 1), (1_000, 300, 64)]


def _chunks(plan, s):
    return [(c * plan.chunk_rows, min(s, (c + 1) * plan.chunk_rows))
            for c in range(plan.chunks)]


@pytest.mark.parametrize("e,s,d", SHAPES)
def test_entity_plan_covers_every_row_once(e, s, d):
    plan = fused_re.entity_plan(e, s, d)
    assert plan == fused_re.entity_plan(e, s, d)  # the shape decides
    bounds = _chunks(plan, s)
    covered = np.zeros(s, np.int64)
    for lo, hi in bounds:
        assert lo < hi  # no empty chunk
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # the units fit the blocks, and the threads of a unit fit one block
    per_block = fused_re.BLOCK_THREADS // plan.unit_threads
    assert plan.unit_threads & (plan.unit_threads - 1) == 0
    assert (plan.blocks - 1) * per_block < e * plan.chunks \
        <= plan.blocks * per_block
    if d > fused_re.NARROW_MAX_D:
        assert plan.unit_threads == fused_re.BLOCK_THREADS
    else:  # a thread per row: the fewest threads that cover a chunk
        assert plan.unit_threads >= min(plan.chunk_rows,
                                        fused_re.BLOCK_THREADS)
        assert plan.unit_threads // 2 < plan.chunk_rows


@pytest.mark.parametrize("e,s,d", HEAD_BUCKETS + [(14, 89_281, 8),
                                                 (195, 6_005, 8),
                                                 (1_000, 300, 64)])
@pytest.mark.parametrize("slots", [2, 4, 8])
def test_a_slice_keeps_the_whole_buckets_chunks(e, s, d, slots):
    """A lane slice planned for the whole bucket's lane count cuts each
    entity's rows into the whole bucket's chunks (so its fold order, and
    its bits, are the whole bucket's), and its blocks cover its own units
    with threads to spare for at most one block."""
    per = -(-e // slots)
    whole = fused_re.entity_plan(e, s, d)
    part = fused_re.entity_plan(per, s, d, plan_lanes=e)
    assert (part.chunks, part.chunk_rows, part.unit_threads) == (
        whole.chunks, whole.chunk_rows, whole.unit_threads)
    units_per_block = fused_re.BLOCK_THREADS // part.unit_threads
    assert (part.blocks - 1) * units_per_block < per * part.chunks \
        <= part.blocks * units_per_block
    assert fused_re.entity_plan(per, s, d, plan_lanes=per) == \
        fused_re.entity_plan(per, s, d)


@pytest.mark.parametrize("e,s,d", HEAD_BUCKETS)
def test_head_buckets_cover_the_card(e, s, d):
    plan = fused_re.entity_plan(e, s, d)
    assert plan.blocks >= 132 and plan.chunks > 1
    assert plan.chunk_rows >= fused_re.MIN_CHUNK_ROWS


@pytest.mark.parametrize("e,s", [(40_000, 1), (10_000, 3), (2_000, 20)])
def test_small_entities_share_a_block(e, s):
    plan = fused_re.entity_plan(e, s, 8)
    assert plan.chunks == 1  # no second pass for the tail buckets
    assert plan.blocks * fused_re.BLOCK_THREADS < 2 * e * max(s, 1) + \
        fused_re.BLOCK_THREADS
    assert plan.blocks < e


def _bucket(e, s, d, chunk_rows, name, rng):
    x = rng.normal(size=(e, s, d))
    ws = 0.3 * rng.normal(size=(e, d))
    off = 0.2 * rng.normal(size=(e, s))
    wt = rng.uniform(0.5, 2.0, size=(e, s))
    wt[:, ::5] = 0.0
    wt[0, :chunk_rows] = 0.0  # a whole chunk of weight-0 rows
    wt[-1, chunk_rows:2 * chunk_rows] = 0.0
    x[0, 1] = 60.0  # a padded row whose raw margin would overflow exp()
    if name == "poisson":
        y = rng.poisson(1.5, size=(e, s)).astype(np.float64)
    elif name == "squared":
        y = rng.normal(size=(e, s))
    else:
        y = (rng.uniform(size=(e, s)) < 0.5).astype(np.float64)
    return tuple(torch.as_tensor(a) for a in (x, ws, y, off, wt))


@pytest.mark.parametrize("e,s,d", [(2, 1_001, 3), (3, 700, 8),
                                   (1, 2_057, 17)])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_chunked_sums_equal_the_whole_bucket(name, e, s, d):
    """The kernel's partition: the plain version per chunk, the chunks'
    (E, C, D + 1) partials folded in chunk order, equals the plain version
    on the whole bucket."""
    loss = LOSSES[name]
    plan = fused_re.entity_plan(e, s, d)
    assert plan.chunks > 1 and s % plan.chunk_rows != 0
    rng = np.random.default_rng(e * s + d)
    x, ws, y, off, wt = _bucket(e, s, d, plan.chunk_rows, name, rng)
    want_v, want_g = fused_re.fused_entity_value_and_grad_plain(
        loss, x, ws, y, off, wt)
    got_v = torch.zeros(e, dtype=torch.float64)
    got_g = torch.zeros((e, d), dtype=torch.float64)
    for lo, hi in _chunks(plan, s):
        v, g = fused_re.fused_entity_value_and_grad_plain(
            loss, x[:, lo:hi].contiguous(), ws, y[:, lo:hi].contiguous(),
            off[:, lo:hi].contiguous(), wt[:, lo:hi].contiguous())
        got_v += v
        got_g += g
    assert torch.isfinite(got_v).all() and torch.isfinite(got_g).all()
    scale_v = want_v.abs().clamp_min(1.0)
    scale_g = want_g.abs().amax(-1, keepdim=True).clamp_min(1.0)
    assert float(((got_v - want_v).abs() / scale_v).max()) <= 1e-6
    assert float(((got_g - want_g).abs() / scale_g).max()) <= 1e-6


@pytest.mark.parametrize("n", [1, 255, 256, 257, 67_584, 200_000,
                               1_000_003])
def test_multi_block_count_depends_on_n_alone(n):
    blocks = fused_glm.multi_blocks(n)
    assert blocks == fused_glm.multi_blocks(n)
    assert 1 <= blocks <= fused_glm.MULTI_MAX_BLOCKS
    # every block owns at least one row of the contiguous split
    per = -(-n // blocks)
    assert (blocks - 1) * per < n


#: (n, d): kernel 1 at the two paths' shapes (GAME fixed effect, GLM sweep,
#: batched TRON) and at the edges of its plan: one row, a ragged last
#: tile, both sides of the narrow limit and of the held width, streamed
#: rows, the widest row
GLM_SHAPES = [(1_000_000, 33), (1_000_003, 33), (200_000, 1024),
              (20_000, 128), (20_011, 8192), (1, 1), (255, 64), (257, 65),
              (70_001, 64), (70_001, 65), (5_000, 1024), (5_000, 1025),
              (999, 29_055), (100, 3)]


def _glm_block_rows(plan, n):
    per = -(-n // plan.blocks)
    return [(b * per, min(n, (b + 1) * per)) for b in range(plan.blocks)]


def _assert_covers_every_row_once(plan, n):
    assert 1 <= plan.blocks <= fused_glm.GLM_MAX_BLOCKS
    covered = np.zeros(n, np.int64)
    for begin, end in _glm_block_rows(plan, n):
        assert begin < end  # every block owns at least one row
        if plan.body == "narrow":  # tiles of 256 consecutive rows
            for r0 in range(begin, end, fused_glm.GLM_TILE_ROWS):
                covered[r0:min(end, r0 + fused_glm.GLM_TILE_ROWS)] += 1
        else:  # warp k takes rows begin + k, begin + k + warps, ...
            for k in range(plan.warps):
                covered[begin + k:end:plan.warps] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,d", GLM_SHAPES)
def test_glm_plan_covers_every_row_once(n, d, itemsize):
    _assert_covers_every_row_once(fused_glm.glm_plan(n, d, itemsize), n)


@pytest.mark.parametrize("n,d", GLM_SHAPES)
def test_glm_plan_depends_on_the_shape_alone(n, d):
    plan = fused_glm.glm_plan(n, d, 4)
    assert plan == fused_glm.glm_plan(n, d, 4)
    # the block count, and so the fold order, does not depend on the dtype
    assert plan.blocks == fused_glm.glm_plan(n, d, 2).blocks
    assert plan.body == fused_glm.glm_plan(1, d, 2).body


@pytest.mark.parametrize("d", [1, 8, 32, 33, 63, 64, 65, 128, 1024, 1025,
                               8192])
def test_glm_plan_picks_its_body_by_width(d):
    plan = fused_glm.glm_plan(10_000, d, 4)
    if d <= fused_glm.GLM_NARROW_MAX_D:
        assert plan.body == "narrow" and plan.stages >= 2
        assert plan.warps * 32 == fused_glm.GLM_THREADS
    else:
        assert plan.body == "wide" and plan.warps >= 1 and plan.stages == 0


@pytest.mark.parametrize("itemsize", [2, 4])
def test_glm_plan_fits_shared_memory_up_to_the_widest_row(itemsize):
    widths = sorted({*range(1, 200), *range(200, 2_100, 7),
                     *range(2_100, cuda_build.MAX_ROW_WIDTH, 997),
                     cuda_build.MAX_ROW_WIDTH})
    for d in widths:
        plan = fused_glm.glm_plan(1_000, d, itemsize)
        assert plan.smem_bytes <= cuda_build.MAX_BLOCK_SMEM_BYTES, d
        assert plan.warps >= 1 and (plan.body == "wide" or plan.stages >= 2)
    # the narrow body's tiles leave room for two blocks an SM where they can
    narrow = fused_glm.glm_plan(1_000, 33, itemsize)
    assert narrow.smem_bytes <= fused_glm.TWO_BLOCK_SMEM_BYTES
    # one column more than the widest row fits no warp: the wrapper refuses
    assert fused_glm.glm_plan(1_000, cuda_build.MAX_ROW_WIDTH + 1,
                              itemsize).warps == 0
    x = torch.zeros((2, cuda_build.MAX_ROW_WIDTH + 1))
    with pytest.raises(ValueError, match="exceed"):
        cuda_build.check_args("fused_value_and_grad", x, "nd")


@pytest.mark.parametrize("n,d", [(3_001, 33), (2_003, 70), (1_500, 1025)])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_glm_block_sums_equal_the_whole_design(name, n, d):
    """Kernel 1's partition: the plain version per block's row range, the
    blocks' partial rows folded in block order, equals the plain version on
    the whole design."""
    loss = LOSSES[name]
    plan = fused_glm.glm_plan(n, d, 4)
    assert plan.blocks > 1
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d))
    w = 0.3 * rng.normal(size=d) / np.sqrt(d)
    off = 0.2 * rng.normal(size=n)
    wt = rng.uniform(0.5, 2.0, size=n)
    wt[::7] = 0.0
    x[3] = 60.0  # a padded row whose raw margin would overflow exp()
    if name == "poisson":
        y = rng.poisson(1.5, size=n).astype(np.float64)
    elif name == "squared":
        y = rng.normal(size=n)
    else:
        y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    x, w, y, off, wt = (torch.as_tensor(a) for a in (x, w, y, off, wt))
    want_v, want_g = fused_glm.fused_value_and_grad_plain(loss, x, w, y, off,
                                                          wt)
    got_v = torch.zeros((), dtype=torch.float64)
    got_g = torch.zeros(d, dtype=torch.float64)
    for lo, hi in _glm_block_rows(plan, n):
        v, g = fused_glm.fused_value_and_grad_plain(
            loss, x[lo:hi], w, y[lo:hi], off[lo:hi], wt[lo:hi])
        got_v += v
        got_g += g
    assert torch.isfinite(got_v) and torch.isfinite(got_g).all()
    assert float((got_v - want_v).abs() / want_v.abs().clamp_min(1.0)) <= 1e-6
    assert float((got_g - want_g).abs().max()
                 / want_g.abs().max().clamp_min(1.0)) <= 1e-6


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,d", GLM_SHAPES)
def test_hvp_plan_covers_every_row_once(n, d, itemsize):
    _assert_covers_every_row_once(fused_hvp.hvp_plan(n, d, itemsize), n)


@pytest.mark.parametrize("n,d", GLM_SHAPES)
def test_hvp_plan_depends_on_the_shape_alone(n, d):
    plan = fused_hvp.hvp_plan(n, d, 4)
    assert plan == fused_hvp.hvp_plan(n, d, 4)
    # the block count, and so the fold order, does not depend on the dtype
    assert plan.blocks == fused_hvp.hvp_plan(n, d, 2).blocks
    assert plan.body == fused_hvp.hvp_plan(1, d, 2).body
    # kernel 1's bodies, split the same way
    assert (plan.body, plan.blocks) == fused_glm.glm_plan(n, d, 4)[:2]


@pytest.mark.parametrize("d", [1, 8, 32, 33, 63, 64, 65, 128, 1024, 1025,
                               8192])
def test_hvp_plan_picks_its_body_by_width(d):
    plan = fused_hvp.hvp_plan(10_000, d, 4)
    if d <= fused_glm.GLM_NARROW_MAX_D:
        assert plan.body == "narrow" and plan.stages >= 2
        assert plan.warps * 32 == fused_glm.GLM_THREADS
    else:
        assert plan.body == "wide" and plan.warps >= 1 and plan.stages == 0


@pytest.mark.parametrize("itemsize", [2, 4])
def test_hvp_plan_fits_shared_memory_up_to_the_widest_row(itemsize):
    widths = sorted({*range(1, 200), *range(200, 2_100, 7),
                     *range(2_100, cuda_build.MAX_ROW_WIDTH, 997),
                     cuda_build.MAX_ROW_WIDTH})
    for d in widths:
        plan = fused_hvp.hvp_plan(1_000, d, itemsize)
        assert plan.smem_bytes <= cuda_build.MAX_BLOCK_SMEM_BYTES, d
        assert plan.warps >= 1 and (plan.body == "wide" or plan.stages >= 2)
    # the GAME fixed effect's narrow tiles leave room for two blocks an SM
    narrow = fused_hvp.hvp_plan(1_000, 33, itemsize)
    assert narrow.smem_bytes <= fused_glm.TWO_BLOCK_SMEM_BYTES
    # one column more than the widest row: the wrapper refuses it
    x = torch.zeros((2, cuda_build.MAX_ROW_WIDTH + 1))
    with pytest.raises(ValueError, match="exceed"):
        cuda_build.check_args("fused_hvp", x, "nd",
                              v=(torch.zeros(x.shape[1]), "d"),
                              d2w=(torch.zeros(2), "n"))


@pytest.mark.parametrize("n,d", [(3_001, 33), (5_003, 64), (2_003, 70),
                                 (1_500, 1025)])
def test_hvp_block_sums_equal_the_whole_product(n, d):
    """Kernel 3's partition: the plain version per block's row range, the
    blocks' partial rows folded in block order, equals the plain version on
    the whole design (f64: the two differ only in the order of the sums,
    so 1e-12 of the product's scale). Every seventh row has no curvature,
    and one of them an x of 1e30: it must add exactly 0."""
    plan = fused_hvp.hvp_plan(n, d, 4)
    assert plan.blocks > 1
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d))
    v = rng.normal(size=d) / np.sqrt(d)
    d2w = rng.uniform(0.0, 0.25, size=n)
    d2w[::7] = 0.0
    x[7] = 1e30
    x, v, d2w = (torch.as_tensor(a) for a in (x, v, d2w))
    want = fused_hvp.fused_hvp_plain(x, v, d2w)
    got = torch.zeros(d, dtype=torch.float64)
    for lo, hi in _glm_block_rows(plan, n):
        got += fused_hvp.fused_hvp_plain(x[lo:hi], v, d2w[lo:hi])
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    assert float((got - want).abs().max()
                 / want.abs().max().clamp_min(1.0)) <= 1e-12
