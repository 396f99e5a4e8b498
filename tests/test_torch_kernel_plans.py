"""The block plans of kernels 2 and 4, which the CUDA kernels take from
Python: what they cover, that they depend on the shape alone, and that the
partition kernel 2 sums in is the function its plain version computes.

- kernel 2 (photon_ml_tpu_torch.ops.fused_re.entity_plan): each entity's S
  rows are cut into chunks; every row lies in exactly one chunk; a head
  bucket (a few entities with ~10^5 rows each) is spread over at least
  132 blocks (one per SM of an H100); many small entities share a block.
  The plain version summed per chunk, then folded over the chunks in
  order, equals the plain version on the whole bucket (f64, 1e-6);
- kernel 4 (photon_ml_tpu_torch.ops.fused_glm.multi_blocks): the block
  count is a function of n alone.

The kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there).
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import fused_glm, fused_re
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
