"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. build the port's CUDA kernels from ``photon_ml_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once);
2. hold each kernel against its plain PyTorch version on the card — kernel 1
   (fixed-effect value+gradient) at 1M x 33 in bf16 and f32, a ragged n and
   d = 1024; kernel 2 (random-effect buckets) at every bucket shape of the
   end-to-end data, a ragged E, S split over blocks (E of 1 and 3, S >
   100k, a whole weight-0 chunk), 10k packed entities of S = 1 and 3, and
   D in {1, 7, 8, 9, 16, 17, 64} (both of its bodies); all four losses,
   weight-0 rows, and bit-identical reruns — and time kernel, plain
   version and the two-pass PyTorch closed form in turns beside the bound
   (bytes / 3.35 TB/s);
3. the main path: ``GameEstimator(device="cuda").fit`` of the end-to-end
   GLMix configuration (fixed effect ``global`` on 32 features + intercept,
   random effects ``perUser`` (40k users) and ``perSong`` (15k songs) on the
   8-wide ``item`` shard, Zipf-skewed entities, 1M rows, bf16 designs, L2
   with lambda 0.001/1/1, L-BFGS, histogram buckets, one sweep), with the
   kernels' launch counts read around it; the GAME model must beat a
   fixed-effect-only model on a held-out draw; kernels 1 and 3 are timed
   at the fixed effect's shape (1M x 33 bf16);
4. the same fit at 20k rows on the card (kernels) and on the CPU (plain
   versions), which must agree;
5. kernels 3 (TRON's Hessian-vector product) and 4 (value+gradient for M
   coefficient rows) against their plain versions on the card — kernel 3
   on each of its bodies (narrow: 1M x 33 bf16, 200,003 x 64; wide, held
   in registers: 20k x 128, 50,001 x 100, 200,003 x 1024; streamed:
   20,011 x 8192 and the widest row) with rows of no curvature and huge
   x; kernel 4 in f32 and bf16, all four losses, M in {1, 2, 5, 8, 9, 11,
   16} at d = 1024, {1, 5, 11} at d = 33, 16 at d = 128 and 64 at d = 128
   (kernel 4's narrow and wide bodies), unaligned rows (d = 33, 1025), ragged n, rows
   at and one column below the shared-memory limit of 5 and 11 lanes,
   weight-0 rows with huge x, bit-identical reruns, kernel 4's lanes
   against kernel 1, and kernel 4 at one lane timed against kernel 1 —
   and timed at the GLM path's shape (kernel 4 in f32 and bf16)
   beside their plain versions, the torch.mv / torch.mm two-pass forms and
   the bound;
6. the GLM path at full width: the JAX package's bench GLM configuration
   (``bench.py::_make_problem``: 200k x 1024 dense f32 logistic, 64
   nonzeros a row, column scales over 3 decades; 20k more rows held out),
   L2 with lambda 100;10;1;0.1;0.01, through ``train_glm_sweep`` with TRON
   (maxIter 80) and ``train_glm_sweep_batched`` with L-BFGS (maxIter 50),
   then ``validate_and_select`` by AUC, with the kernels' launch counts
   read around each sweep; at every lambda the optimizer's reported |grad|
   must match the exact f64 gradient at its coefficients within that
   gradient's f32 rounding scale; kernels 1, 3 and 4 timed at this shape
   beside their plain versions and torch.mv / torch.mm two-pass forms;
7. the two sweeps and TRON through ``train_glm_sweep_batched`` at 20k x 128
   (tolerance 1e-4) on the card (kernels) and on the CPU (plain versions):
   the same gradient check on both devices, the f64 objectives at the two
   devices' coefficients within OBJECTIVE_RTOL, AUCs within 1e-4 where
   both converged; kernels 3 and 4 must launch in the batched TRON sweep,
   and kernel 3 is timed at its shape; SIMPLE variances on both;
8. the e2e CLI, from Avro to a model on disk: phase 3's data written to
   two Avro files (``bench.py::_write_e2e_file``'s record layout, null
   codec) and trained through ``photon_ml_tpu_torch.cli.train_game.run``
   with the bench's end-to-end arguments (``bench.py::bench_end_to_end``)
   and the AUC evaluator. The native decoder must have read both files,
   kernels 1 and 2 must have launched, the AUC must be within 1e-4 of
   phase 3's and beat the fixed effect alone, and ``best/``, loaded again
   with the run's index maps and vocabularies, must score the validation
   file to the run's AUC within 1e-6;
9. the GLM command, from Avro to a model directory: phase 6's rows (and
   phase 7's) written to Avro, and a wide sparse file (200k rows, 64
   nonzeros a row over 100,000 columns; 20k x 50,000 for the CPU
   comparison), trained by ``photon_ml_tpu_torch.cli.train_glm.run`` with
   lambda 100;10;1;0.1;0.01 and AUC: TRON (kernels 1 and 3 must launch)
   and batched L-BFGS (kernel 4), which must select phase 6's lambda at
   its AUC within 1e-4; elastic net (alpha 0.5) through OWL-QN,
   sequential (kernel 1) and batched (kernel 4), with exact zeros at the
   largest lambda; and sequential L-BFGS on the sparse file, which must
   launch no kernel and whose contractions must rerun bit for bit. At
   every lambda the reported |grad| (the pseudo-gradient's under elastic
   net) must match the exact f64 one within its f32 rounding scale, and
   ``best/`` must rescore the validation file to the run's AUC within
   1e-6; elastic net at 20k x 128 and the sparse run at 20k x 50,000 on
   the card and on the CPU must agree as phase 7's sweeps do;
10. scoring phase 8's model (``best/`` and the 100k-row validation file):
   (a) ``photon_ml_tpu_torch.cli.score_game.run`` with AUC and the score
   breakdown: the native writer must write ``scores.avro``, the AUC must
   be phase 8's rescored AUC within 1e-6 and the breakdown's totals
   bit-identical to the scores; (b) the online engine
   (``serving.ModelRegistry.load`` on the card, max batch 1024) in f32,
   bf16 and int8 tables: warmup captures 11 CUDA graphs and none follow,
   20,000 records in batches of seeded random sizes from 1 to 1,500 score
   bit-identical to (a) in f32 and within each format's bound in bf16 and
   int8, records naming ids no model saw score as records without ids,
   the table bytes are each format's; (c) ``serve_game``'s HTTP server on
   port 0 with microbatch 64: 8 client threads of at least 250
   single-record POSTs to ``/score`` over loopback, one ``/reload`` of the
   same directory in the middle; no request fails and every reply equals
   (b)'s f32 score. Phase 10 launches none of the four kernels.

Any failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it the ``kernels``
summary. Data and coefficients are random, made from fixed seeds.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
#: kernel vs plain version: both sum the same f32 products, in another order
KERNEL_RTOL = 1e-5
#: kernels 3 and 4 with a bf16 design vs their plain versions: both round
#: d2w·t (kernel 3) or wt·d1 (kernel 4) to bf16, and where the kernel's and
#: the plain version's f32 inputs to that rounding differ in the last bit
#: (another summation order of the margin) the term lands on the other bf16
#: neighbour, 2^-8 apart; at 5*10^4-10^5 rows such flips moved a gradient
#: by up to 1.4e-5 of its scale on an H100.
BF16_RTOL = 1e-4
#: kernel 4's lanes vs kernel 1 with a bf16 design: the two kernels sum a
#: margin in different orders, so their wt·d1 roundings flip the same way;
#: at 10^5 rows such flips moved a lane by 1.40e-5, 1.59e-5 and 2.08e-5 of
#: its gradient's scale on an H100 (PERF.md §2), about half this limit.
#: With an f32 design the lanes are held to kernel 1 at KERNEL_RTOL.
K4_VS_K1_BF16_RTOL = 4e-5
GLM = dict(rows=200_000, valid_rows=20_000, dim=1024, nnz=64)
GLM_LAMBDAS = [100.0, 10.0, 1.0, 0.1, 0.01]
GLM_TRON_MAX_ITER = 80
GLM_LBFGS_MAX_ITER = 50
GLM_SMALL = dict(rows=20_000, valid_rows=4_000, dim=128, nnz=8)
GLM_SMALL_TOLERANCE = 1e-4
#: card vs CPU at 20k x 128: the f64 objective at the two devices'
#: coefficients, relative — where both solves converged, and where either
#: stopped on the iteration cap or the radius rule, which lets the two f32
#: trajectories drift apart (set from the readings recorded in PERF.md: at
#: most 1.5e-7 and 1.2e-4 on an H100)
OBJECTIVE_RTOL = {True: 1e-6, False: 5e-4}
E2E = dict(rows=1_000_000, users=40_000, songs=15_000, valid_rows=100_000)
E2E_MAX_ITER = 25
SMALL = dict(rows=20_000, users=40_000, songs=15_000, valid_rows=5_000)
SMALL_MAX_ITER = 100


def log(*args):
    print(*args, flush=True)


# --------------------------------------------------------------------------
# data: the end-to-end GLMix distribution, generated in memory
# --------------------------------------------------------------------------

def make_e2e(tg, rows, users, songs, valid_rows, seed=99):
    """Music-shaped data: a global bag (6 of 32 features, plus an
    intercept column), an item bag (4 of 8 features), Zipf user and song
    ids, labels from a logistic model of planted fixed, per-user and
    per-song effects. Returns (train, validation) GameData."""
    prm = np.random.default_rng(seed)
    d_fixed, d_item = 32, 8
    w_fixed = prm.normal(size=d_fixed)
    uu = prm.normal(size=(users, d_item))
    us = 0.7 * prm.normal(size=(songs, d_item))
    pu = 1.0 / np.arange(1, users + 1)
    pu /= pu.sum()
    ps = 1.0 / np.arange(1, songs + 1)
    ps /= ps.sum()

    def draw(n, rng):
        user = rng.choice(users, size=n, p=pu)
        song = rng.choice(songs, size=n, p=ps)
        fi = rng.random((n, d_fixed)).argsort(axis=1)[:, :6]
        fv = rng.normal(size=(n, 6))
        ii = rng.random((n, d_item)).argsort(axis=1)[:, :4]
        iv = rng.normal(size=(n, 4))
        margin = ((w_fixed[fi] * fv).sum(1) / np.sqrt(6)
                  + (np.take_along_axis(uu[user], ii, 1) * iv).sum(1)
                  + (np.take_along_axis(us[song], ii, 1) * iv).sum(1))
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin)))
        # global shard: the 6 drawn features and the intercept (column 32)
        g_cols = np.concatenate([fi, np.full((n, 1), d_fixed)], axis=1)
        g_vals = np.concatenate([fv, np.ones((n, 1))], axis=1)
        rows7 = np.repeat(np.arange(n), 7)
        rows4 = np.repeat(np.arange(n), 4)
        shards = {
            "global": tg.FeatureShard.from_coo(
                rows7, g_cols.ravel(), g_vals.ravel(), n, d_fixed + 1),
            "item": tg.FeatureShard.from_coo(
                rows4, ii.ravel(), iv.ravel(), n, d_item),
        }
        return tg.GameData.build(labels=y.astype(np.float32), shards=shards,
                                 id_columns={"userId": user, "songId": song})

    return draw(rows, np.random.default_rng(seed + 1)), \
        draw(valid_rows, np.random.default_rng(seed + 2))


def e2e_estimator(tg, device, max_iter, sequence=("global", "perUser",
                                                  "perSong")):
    from photon_ml_tpu_torch.game.estimator import (
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.ops.regularization import L2Regularization
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.types import TaskType

    opt = GLMOptimizationConfiguration(
        regularization=L2Regularization,
        optimizer_config=OptimizerConfig(max_iterations=max_iter))

    def random(entity):
        return RandomEffectCoordinateConfig(
            dataset=tg.RandomEffectDatasetConfig(
                entity, "item", bucket_strategy="histogram",
                max_sample_buckets=4),
            optimization=opt, design_dtype="bfloat16")

    coords = {"global": FixedEffectCoordinateConfig(
        "global", opt, design_dtype="bfloat16"),
        "perUser": random("userId"), "perSong": random("songId")}
    return tg.GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs={k: coords[k] for k in sequence},
        update_sequence=list(sequence), n_cd_iterations=1, device=device)


E2E_LAMBDAS = {"global": 0.001, "perUser": 1.0, "perSong": 1.0}
#: the CLI's AUC vs phase 3's in-memory fit of the same rows: only the
#: column order (the sorted index map) and the entity order (first-seen
#: vocabularies) differ, the limit of the GAME card-vs-CPU check
CLI_AUC_TOL = 1e-4
#: best/ reloaded and rescored vs the run's own validation AUC
RELOAD_AUC_TOL = 1e-6


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call over ``reps`` back-to-back calls, between
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_turns(fns, reps=20):
    """{name: mean ms} for the callables of ``fns``, each timed by
    :func:`time_ms` in turns, in order and then in reverse (a, b, c, c, b,
    a), so drift of the shared host or the card's clocks falls on all."""
    out = {k: 0.0 for k in fns}
    for k in [*fns, *reversed(fns)]:
        out[k] += time_ms(fns[k], reps=reps) / 2
    return out


def captured(fn, calls=20):
    """``calls`` calls of ``fn`` captured in one CUDA graph; returns its
    replay. Replayed between CUDA events, it times the device work of a
    call without the host work around its launches (a wrapper's checks,
    allocations and ctypes call), which can exceed a short kernel."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph.replay


def roofline_ms(nbytes, ops):
    """(least ms, what binds): bytes over the HBM rate or f32 operations
    over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_ms(n_live, n_rows, d, itemsize, n_out, lanes=1):
    """Least time for one evaluation: X's live rows and their label and
    offset read once, every row's weight read once, the n_out coefficient
    rows read and the outputs written once — over the HBM rate; or ~4 f32
    operations per element of the live rows plus ~10 per live row for the
    loss, for each of ``lanes`` coefficient rows sharing X (kernel 4), over
    the f32 rate — whichever is larger."""
    nbytes = (n_live * d * itemsize + n_live * 8 + n_rows * 4
              + n_out * d * 4 + n_out * (d + 1) * 4)
    return roofline_ms(nbytes, lanes * (4.0 * n_live * d + 10.0 * n_live))


def hvp_bound_ms(n_live, n_rows, d, itemsize):
    """Least time for one Hessian-vector product: the rows with nonzero
    curvature read once, every row's d2w read once, v read and the output
    written once; 4 f32 operations per element of those rows."""
    return roofline_ms(n_live * d * itemsize + n_rows * 4 + 2 * d * 4,
                       4.0 * n_live * d)


# --------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# --------------------------------------------------------------------------

def _labels(loss, shape, gen):
    if loss.name == "poisson":
        return torch.poisson(torch.full(shape, 1.5, device="cuda"),
                             generator=gen)
    if loss.name == "squared":
        return torch.randn(shape, device="cuda", generator=gen)
    return (torch.rand(shape, device="cuda", generator=gen) < 0.5).float()


def _max_err(got, want):
    """(max |kernel - plain|, the largest error relative to its own scale).
    The value is held against max(1, |plain value|), per entity for kernel
    2; the gradient against max(1, max |plain gradient|) over its row — the
    whole gradient for kernel 1, each entity's for kernel 2 — so a value of
    ~10^5 never hides a gradient error."""
    (gv, gg), (wv, wg) = got, want
    dv, dg = (gv - wv).abs(), (gg - wg).abs()
    rel_v = dv / wv.abs().clamp_min(1.0)
    rel_g = dg / wg.abs().amax(-1, keepdim=True).clamp_min(1.0)
    return (max(float(dv.max()), float(dg.max())),
            max(float(rel_v.max()), float(rel_g.max())))


#: (n, d, dtypes) of kernel 1 vs its plain version: the paths' widths (33,
#: 1024) with a ragged row count, and streamed rows (8192)
GLM_CHECK_SHAPES = [(1_000_000, 33, (torch.bfloat16, torch.float32)),
                    (1_000_003, 33, (torch.bfloat16,)),
                    (100_003, 1024, (torch.float32, torch.bfloat16)),
                    (20_011, 8192, (torch.float32,))]
#: the rest of kernel 1's bodies: narrow rows of other odd and even widths
#: (8, 64), and wide rows held in registers 8 columns a lane (phase 7's 20k
#: x 128; 100 columns, not a multiple of 32)
GLM_BODY_SHAPES = [(1_000_000, 8, (torch.bfloat16,)),
                   (200_003, 64, (torch.bfloat16,)),
                   (20_000, 128, (torch.float32, torch.bfloat16)),
                   (50_001, 100, (torch.float32,))]


def check_glm(fused_glm, losses, shapes, gen):
    """Kernel 1 vs its plain version at ``shapes`` ``(n, d, dtypes)``;
    returns the largest relative error (:func:`_max_err`)."""
    worst = 0.0
    for n, d, dtypes in shapes:
        for dt in dtypes:
            x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
            # margins of O(1) at every width
            w = torch.randn(d, device="cuda", generator=gen) / math.sqrt(d)
            off = 0.1 * torch.randn(n, device="cuda", generator=gen)
            wt = torch.rand(n, device="cuda", generator=gen)
            wt[::9] = 0.0  # weight-0 (padding) rows
            x[9] = 300.0  # padded: exp() of its margin would overflow
            for loss in losses:
                y = _labels(loss, (n,), gen)
                args = (loss, x, w, y, off, wt)
                got = fused_glm.fused_value_and_grad(*args)
                again = fused_glm.fused_value_and_grad(*args)
                want = fused_glm.fused_value_and_grad_plain(*args)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    f"kernel 1 not bit-identical on rerun: {n}x{d} {dt}"
                err, rel = _max_err(got, want)
                assert rel <= KERNEL_RTOL, (n, d, dt, loss.name, err, rel)
                assert all(torch.isfinite(t).all() for t in got)
                worst = max(worst, rel)
                log(f"  kernel1 n={n} d={d} {str(dt)[6:]} {loss.name}: "
                    f"max_abs_err={err:.3e} rel={rel:.2e} rerun identical")
            del x
    return worst


def check_re(fused_re, losses, shapes, gen):
    """Kernel 2 vs its plain version at every bucket shape; returns the
    largest relative error (:func:`_max_err`). With more than one entity
    the first is all weight-0; where the plan splits S, one whole chunk of
    the last entity is weight-0 too."""
    worst = 0.0
    for e, s, d in shapes:
        plan = fused_re.entity_plan(e, s, d)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(e, s, d, device="cuda", generator=gen).to(dt)
            w = torch.randn(e, d, device="cuda", generator=gen) / math.sqrt(d)
            off = 0.1 * torch.randn(e, s, device="cuda", generator=gen)
            wt = (torch.rand(e, s, device="cuda", generator=gen) > 0.3).float()
            if e > 1:
                wt[0] = 0.0  # an all-dead entity
            if plan.chunks > 1:  # a whole dead chunk
                wt[-1, plan.chunk_rows:2 * plan.chunk_rows] = 0.0
            x[-1, 0] = 300.0
            wt[-1, 0] = 0.0  # a padded row that would overflow exp()
            for loss in losses:
                y = _labels(loss, (e, s), gen)
                args = (loss, x, w, y, off, wt)
                got = fused_re.fused_entity_value_and_grad(*args)
                again = fused_re.fused_entity_value_and_grad(*args)
                want = fused_re.fused_entity_value_and_grad_plain(*args)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    f"kernel 2 not bit-identical on rerun: {(e, s, d)} {dt}"
                if e > 1:
                    assert float(got[0][0]) == 0.0 and not got[1][0].any()
                err, rel = _max_err(got, want)
                assert rel <= KERNEL_RTOL, (e, s, d, dt, loss.name, err, rel)
                worst = max(worst, rel)
            log(f"  kernel2 E={e} S={s} D={d} {str(dt)[6:]} (chunks "
                f"{plan.chunks} x {plan.chunk_rows} rows, {plan.unit_threads}"
                f" threads a unit, {plan.blocks} blocks) 4 losses: last "
                f"max_abs_err={err:.3e} rel={rel:.2e}, rerun identical")
            del x
    return worst


#: kernel 2's plan paths beyond the e2e buckets: S split over blocks (E of
#: 1 and 3, S not a multiple of the chunk), many packed small-S entities,
#: and both bodies (D <= 16 one thread per row, wider the row groups)
RE_PLAN_SHAPES = ([(1, 100_003, 8), (3, 100_001, 8), (10_000, 1, 8),
                   (10_000, 3, 8)]
                  + [(3, 100_001, d) for d in (1, 7, 9, 16, 17, 64)]
                  + [(10_000, 3, d) for d in (1, 7, 9, 16, 17, 64)])


def glm_closed_form_library(loss, x, w, y, off, wt):
    """Two-pass PyTorch closed form (torch.mv), the yardstick the port never
    calls: margins, loss and derivative, then the transposed product."""
    m = torch.mv(x, w.to(x.dtype)).float() + off
    live = wt > 0
    m = torch.where(live, m, torch.zeros_like(m))
    value = torch.where(live, wt * loss.loss(m, y), torch.zeros_like(m)).sum()
    dvec = torch.where(live, wt * loss.d1(m, y), torch.zeros_like(m))
    return value, torch.mv(x.t(), dvec.to(x.dtype)).float()


def re_closed_form_library(loss, x, w, y, off, wt):
    """Two-pass PyTorch closed form (torch.bmm) for an entity bucket."""
    m = torch.bmm(x, w.to(x.dtype)[:, :, None])[:, :, 0].float() + off
    live = wt > 0
    m = torch.where(live, m, torch.zeros_like(m))
    values = torch.where(live, wt * loss.loss(m, y),
                         torch.zeros_like(m)).sum(1)
    dvec = torch.where(live, wt * loss.d1(m, y), torch.zeros_like(m))
    return values, torch.bmm(dvec.to(x.dtype)[:, None, :], x)[:, 0].float()


def time_glm(fused_glm, loss, x, w, labels, weights):
    """Kernel 1 at one of the main path's shapes (the e2e design, or the GLM
    design at a TRON solution): kernel, plain version and torch.mv two-pass
    form timed in turns."""
    n, d = x.shape
    off = torch.zeros(n, device="cuda")
    args = (loss, x, w, labels, off, weights)
    err, rel = _max_err(fused_glm.fused_value_and_grad(*args),
                        fused_glm.fused_value_and_grad_plain(*args))
    assert rel <= KERNEL_RTOL, ("kernel1 at a path's shape", n, d, err, rel)
    calls = 20
    t = time_turns({
        "ms": lambda: fused_glm.fused_value_and_grad(*args),
        "device_ms": captured(lambda: fused_glm.fused_value_and_grad(*args),
                              calls),
        "plain_ms": lambda: fused_glm.fused_value_and_grad_plain(*args),
        "library_ms": lambda: glm_closed_form_library(*args)})
    t["device_ms"] /= calls
    n_live = int((weights > 0).sum())
    b, by = bound_ms(n_live, n, d, x.element_size(), 1)
    log(f"  kernel1 {n}x{d} {str(x.dtype)[6:]}: kernel {t['ms']:.4f} ms "
        f"({t['device_ms']:.4f} ms of device time, in a CUDA graph), plain "
        f"{t['plain_ms']:.4f} ms, torch.mv two-pass {t['library_ms']:.4f} "
        f"ms, bound {b:.4f} ms ({by}); max_abs_err vs plain {err:.3e}")
    return dict(max_abs_err=err, bound_ms=b, bound_by=by,
                shape=f"{n}x{d} {str(x.dtype)[6:]}", **t)


def time_re(fused_re, loss, buckets):
    """Kernel 2 at every bucket of the main path (the e2e buckets of both
    random effects, as the solver uploads them): one evaluation of each,
    kernel, plain version and torch.bmm form timed in turns per bucket,
    then summed."""
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, bound_by="bytes")
    for st in buckets:
        x = st.x
        e, s, d = x.shape
        w = 0.01 * torch.ones(e, d, device="cuda")
        off = torch.zeros(e, s, device="cuda")
        args = (loss, x, w, st.labels, off, st.weights)
        err, rel = _max_err(fused_re.fused_entity_value_and_grad(*args),
                            fused_re.fused_entity_value_and_grad_plain(*args))
        assert rel <= KERNEL_RTOL, ("kernel2 on an e2e bucket", err, rel)
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        t = time_turns({
            "ms": lambda: fused_re.fused_entity_value_and_grad(*args),
            "plain_ms": lambda: fused_re.fused_entity_value_and_grad_plain(
                *args),
            "library_ms": lambda: re_closed_form_library(*args)}, reps=10)
        n_live = int((st.weights > 0).sum())
        b, by = bound_ms(n_live, e * s, d, x.element_size(), e)
        if by == "operations":
            tot["bound_by"] = by
        plan = fused_re.entity_plan(e, s, d)
        log(f"  kernel2 E={e} S={s} D={d} live rows={n_live} ({plan.chunks}"
            f" chunks, {plan.blocks} blocks): kernel {t['ms']:.4f} ms, plain"
            f" {t['plain_ms']:.4f} ms, torch.bmm closed form "
            f"{t['library_ms']:.4f} ms, bound {b:.5f} ms ({by})")
        t["bound_ms"] = b
        for k, v in t.items():
            tot[k] += v
    tot["shape"] = f"sum over {len(buckets)} e2e buckets"
    return tot


def compare_bucket_solves(tg, data, lam):
    """Card (kernel 2) vs CPU (plain version): one L-BFGS solve of every
    perUser bucket of ``data`` from zero, on identical inputs (zero
    offsets), the main path's bf16 design. A lane's objective f is strongly
    convex with modulus mu (the smallest eigenvalue of its Hessian over the
    lane's features, >= l2), so a lane that stopped at w lies within
    |grad f(w)| / mu of the optimum, and the devices' lanes within
    (|grad f(w_cuda)| + |grad f(w_cpu)|) / mu of each other. Gradients and
    Hessians are taken exactly, in f64 on the CPU; mu at the CPU's solution
    stands for the segment between the two (they end ~1e-4 apart, where
    the logistic curvature moves by less than the 1e-3 allowed for it).
    Asserts that per lane and prints the tightest lane's iterations, stop
    and gradient on both devices. Returns the largest bound: how far apart
    two f32 solves of one lane may end."""
    from photon_ml_tpu_torch.glm.problem import OptimizationProblem
    from photon_ml_tpu_torch.ops.design import DenseDesign
    from photon_ml_tpu_torch.ops.losses import LogisticLoss
    from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective

    est = e2e_estimator(tg, "cpu", SMALL_MAX_ITER, ("perUser",))
    cfg = est.coordinate_configs["perUser"].optimization
    problem = OptimizationProblem(GLMObjective(loss=LogisticLoss), cfg)
    l2 = cfg.regularization.l2_weight(lam)
    reach = worst = 0.0
    for b in est.prepare(data)["perUser"].buckets:
        e, s, d = b.tensor_shape

        def glm_data(device, dtype):
            # the main path's bf16 design; f64 holds its values exactly
            x = torch.as_tensor(b.x, device=device).to(torch.bfloat16)
            return GLMData(
                design=DenseDesign(x=x if dtype == torch.float32
                                   else x.to(dtype)),
                labels=torch.as_tensor(b.labels, device=device).to(dtype),
                offsets=torch.zeros((e, s), dtype=dtype, device=device),
                weights=torch.as_tensor(b.weights, device=device).to(dtype))

        res = {dev: problem.run(glm_data(dev, torch.float32),
                                torch.zeros((e, d), device=dev), lam)
               for dev in ("cuda", "cpu")}
        exact = glm_data("cpu", torch.float64)
        w = {dev: r.w.cpu().double() for dev, r in res.items()}
        gn = {dev: torch.linalg.vector_norm(problem.objective.value_and_grad(
            w[dev], exact, l2)[1], dim=-1) for dev in w}
        # the Hessian at w_cpu over the lane's kept features: padded
        # columns are 0 in both solutions, so they are left out
        x, live = exact.design.x, exact.weights > 0
        m = torch.where(live, torch.einsum("esd,ed->es", x, w["cpu"]), 0.0)
        d2w = torch.where(live, exact.weights * LogisticLoss.d2(
            m, exact.labels), 0.0)
        pad = torch.as_tensor(b.feature_index < 0).double()
        hess = (torch.einsum("es,esd,esf->edf", d2w, x, x)
                + torch.diag_embed(l2 + 1e30 * pad))
        mu = torch.linalg.eigvalsh(hess)[:, 0] * (1 - 1e-3)
        bound = (gn["cuda"] + gn["cpu"]) / mu
        gap = torch.linalg.vector_norm(w["cuda"] - w["cpu"], dim=-1)
        k = int((gap / bound.clamp_min(1e-300)).argmax())
        c, p = res["cuda"], res["cpu"]
        log(f"  bucket {e}x{s}x{d}: max |w_cuda - w_cpu| {float(gap.max()):.3e}"
            f", max bound {float(bound.max()):.3e}; tightest lane: gap "
            f"{float(gap[k]):.3e} <= {float(bound[k]):.3e}, iterations "
            f"{int(c.iterations[k])}/{int(p.iterations[k])}, converged "
            f"{bool(c.converged[k])}/{bool(p.converged[k])}, |grad f| "
            f"{float(gn['cuda'][k]):.2e}/{float(gn['cpu'][k]):.2e}, mu "
            f"{float(mu[k]):.3g} (cuda/cpu)")
        assert bool((gap <= bound).all()), (e, s, d)
        reach = max(reach, float(bound.max()))
        worst = max(worst, float(gap.max()))
    log(f"[4] per-bucket solves, card vs CPU: largest lane gap {worst:.3e}, "
        f"largest bound {reach:.3e}")
    return reach


def _is_kernel2(name):
    """Whether a profiled device kernel of the GAME fit is one of kernel
    2's: entity_rows_kernel and entity_wide_kernel (csrc/fused_re.cu) and
    its fold, fold_rows_kernel (csrc/glm_common.cuh, shared with kernel 4,
    which the fit does not run)."""
    return ("entity_" in name and "_kernel" in name) \
        or "fold_rows_kernel" in name


def profile_fit(fit, unprofiled_wall):
    """Run ``fit`` under ``torch.profiler`` and print the device time of the
    top kernels, the device time inside each profiler range
    (``cd.step[...]``, ``re.bucket[...]``) and the device's busy share of
    ``unprofiled_wall`` (the profiler's host overhead inflates its own wall;
    the device work is the same)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [e for e in on_device if getattr(e, "is_user_annotation", False)]
    work = sorted((e for e in on_device
                   if not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    if busy_ms <= 0.0:
        log("[3] profiled fit: the profiler saw no device time "
            "(device busy share not measured)")
        return
    log(f"[3] profiled fit: wall {wall:.3f} s under the profiler; device "
        f"busy {busy_ms:.1f} ms = {100.0 * busy_ms / 1e3 / unprofiled_wall:.1f}"
        f" % of the unprofiled fit wall ({unprofiled_wall:.3f} s)")
    by_name: dict = {}
    for e in work:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
        log(f"  kernel {name[:80]}: {ms:.2f} ms over {count} launches")
    k2 = [v for k, v in by_name.items() if _is_kernel2(k)]
    log(f"  kernel 2 (csrc/fused_re.cu, all its kernels): "
        f"{sum(ms for ms, _ in k2):.2f} ms over {sum(c for _, c in k2)} "
        f"device launches = {100.0 * sum(ms for ms, _ in k2) / busy_ms:.1f}"
        " % of the device busy time")
    starts = [e.time_range.start for e in work]
    import bisect

    for r in sorted(ranges, key=lambda e: e.name):
        lo = bisect.bisect_left(starts, r.time_range.start)
        hi = bisect.bisect_left(starts, r.time_range.end)
        inside = work[lo:hi]
        ms = sum(e.time_range.elapsed_us() for e in inside) / 1e3
        ent = sum(e.time_range.elapsed_us() for e in inside
                  if _is_kernel2(e.name)) / 1e3
        log(f"  range {r.name}: span {r.time_range.elapsed_us() / 1e3:.2f} "
            f"ms, device busy {ms:.2f} ms (kernel 2: {ent:.2f} ms) over "
            f"{len(inside)} device ops")


# --------------------------------------------------------------------------
# phase 5: kernels 3 and 4 vs plain versions
# --------------------------------------------------------------------------

def _grad_err(got, want):
    """(max |kernel - plain|, that relative to max(1, max |plain|))."""
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


#: (n, d, dtypes) of kernel 3 vs its plain version: the GLM path's width
#: with a ragged n, the GAME fixed effect's width, streamed rows
HVP_CHECK_SHAPES = [(200_003, 1024, (torch.float32, torch.bfloat16)),
                    (5_001, 33, (torch.float32, torch.bfloat16)),
                    (20_011, 8192, (torch.float32, torch.bfloat16))]
#: the rest of kernel 3's bodies: narrow rows at the GAME fixed effect's
#: shape and at an even width (64), wide rows held in registers 8 columns a
#: lane (batched TRON's 20k x 128; 100 columns, not a multiple of 32); the
#: streamed rows at cuda_build.MAX_ROW_WIDTH are added in main()
HVP_BODY_SHAPES = [(1_000_000, 33, (torch.bfloat16,)),
                   (200_003, 64, (torch.float32, torch.bfloat16)),
                   (20_000, 128, (torch.float32, torch.bfloat16)),
                   (50_001, 100, (torch.float32,))]


def check_hvp(fused_hvp, shapes, gen):
    """Kernel 3 vs its plain version at ``shapes`` ``(n, d, dtypes)``;
    returns the largest relative error per design dtype. Every ninth row
    has no curvature and row 9 an x of 1e30, which must add exactly 0."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n, d, dtypes in shapes:
        for dt in dtypes:
            x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
            v = torch.randn(d, device="cuda", generator=gen) / math.sqrt(d)
            d2w = torch.rand(n, device="cuda", generator=gen)
            d2w[::9] = 0.0  # no curvature: padding, or a saturated row
            x[9] = 1e30  # such a row must add exactly 0, whatever its x
            got = fused_hvp.fused_hvp(x, v, d2w)
            again = fused_hvp.fused_hvp(x, v, d2w)
            want = fused_hvp.fused_hvp_plain(x, v, d2w)
            torch.cuda.synchronize()
            assert torch.equal(got, again), \
                f"kernel 3 not bit-identical on rerun: {n}x{d} {dt}"
            assert torch.isfinite(got).all(), (n, d, dt)
            err, rel = _grad_err(got, want)
            tol = KERNEL_RTOL if dt == torch.float32 else BF16_RTOL
            assert rel <= tol, (n, d, dt, err, rel)
            worst[dt] = max(worst[dt], rel)
            plan = fused_hvp.hvp_plan(n, d, x.element_size())
            log(f"  kernel3 n={n} d={d} {str(dt)[6:]} ({plan.body} body, "
                f"{plan.blocks} blocks of {plan.warps} warps): max_abs_err="
                f"{err:.3e} rel={rel:.2e}, rerun identical")
            del x
    return worst


def check_multi(fused_glm, cuda_build, losses, gen):
    """Kernel 4 vs its plain version (each lane's value and gradient to its
    own scale) and, lane by lane, vs kernel 1; returns the largest relative
    error vs the plain version and vs kernel 1 per design dtype."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0,
             ("kernel1", torch.float32): 0.0, ("kernel1", torch.bfloat16): 0.0}
    cases = [(100_003, 1024, m, dt) for m in (1, 2, 5, 8, 9, 11, 16)
             for dt in (torch.float32, torch.bfloat16)]
    # rows that are not 16-byte aligned (staged as granules, realigned);
    # rows of at most 128 columns (the narrow body), in two passes of
    # lanes, and with lanes too many for its accumulators (the wide body)
    cases += [(50_001, 33, m, dt) for m in (1, 5, 11)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(50_001, 128, 16, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [(20_011, 128, 64, torch.float32)]
    cases += [(100_003, 1025, 5, dt) for dt in (torch.float32, torch.bfloat16)]
    # rows at the shared-memory limit of 5 and 11 lanes (streamed in
    # column chunks), and one column short of it (unaligned), in f32: with
    # few rows one bf16 rounding flip (BF16_RTOL) of a heavy Poisson row
    # weighs too much for any tolerance
    cases += [(3_001, cuda_build.max_row_width(m) - k, m, torch.float32)
              for m in (5, 11) for k in (0, 1)]
    for n, d, lanes, dt in cases:
        x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
        ws = torch.randn(lanes, d, device="cuda", generator=gen) / math.sqrt(d)
        off = 0.1 * torch.randn(n, device="cuda", generator=gen)
        wt = torch.rand(n, device="cuda", generator=gen)
        wt[::9] = 0.0  # weight-0 (padding) rows
        x[9] = 300.0  # padded: exp() of its margin would overflow
        line = []
        for loss in losses:
            y = _labels(loss, (n,), gen)
            args = (loss, x, ws, y, off, wt)
            got = fused_glm.fused_value_and_grad_multi(*args)
            again = fused_glm.fused_value_and_grad_multi(*args)
            want = fused_glm.fused_value_and_grad_plain(*args)
            one = [fused_glm.fused_value_and_grad(loss, x, ws[m], y, off, wt)
                   for m in range(lanes)]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                f"kernel 4 not bit-identical on rerun: {n}x{d} M={lanes} {dt}"
            assert all(torch.isfinite(t).all() for t in got)
            err, rel = _max_err(got, want)
            tol = KERNEL_RTOL if dt == torch.float32 else BF16_RTOL
            assert rel <= tol, (n, d, lanes, dt, loss.name, err, rel)
            k1 = (torch.stack([v for v, _ in one]),
                  torch.stack([g for _, g in one]))
            _, rel1 = _max_err(got, k1)
            tol1 = KERNEL_RTOL if dt == torch.float32 else K4_VS_K1_BF16_RTOL
            assert rel1 <= tol1, (n, d, lanes, dt, loss.name, rel1)
            worst[dt] = max(worst[dt], rel)
            worst["kernel1", dt] = max(worst["kernel1", dt], rel1)
            line.append(f"{loss.name} {rel:.1e}/{rel1:.1e}")
        log(f"  kernel4 n={n} d={d} M={lanes} {str(dt)[6:]}: rel vs plain/"
            f"vs kernel1: {', '.join(line)}; reruns identical")
        del x
    return worst


def time_one_lane(fused_glm, loss, gen):
    """Kernel 4 at M = 1 against kernel 1 at the fixed-effect shapes of the
    two paths (1M x 33 bf16, 200k x 1024 f32), timed k1, k4, k4, k1 in one
    process. Returns {shape: (kernel 1 ms, kernel 4 ms)}."""
    out = {}
    for n, d, dt in [(1_000_000, 33, torch.bfloat16),
                     (200_000, 1024, torch.float32)]:
        x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
        w = torch.randn(d, device="cuda", generator=gen) / math.sqrt(d)
        y = _labels(loss, (n,), gen)
        off = torch.zeros(n, device="cuda")
        wt = torch.ones(n, device="cuda")

        def k1():
            return fused_glm.fused_value_and_grad(loss, x, w, y, off, wt)

        def k4():
            return fused_glm.fused_value_and_grad_multi(loss, x, w[None], y,
                                                        off, wt)

        a1, a4, b4, b1 = (time_ms(f) for f in (k1, k4, k4, k1))
        ms1, ms4 = (a1 + b1) / 2, (a4 + b4) / 2
        key = f"{n}x{d} {str(dt)[6:]}"
        out[key] = (ms1, ms4)
        log(f"  one lane {key}: kernel1 {ms1:.4f} ms, kernel4 (M=1) "
            f"{ms4:.4f} ms, ratio {ms4 / ms1:.3f}")
        del x
    return out


def hvp_closed_form_library(x, v, d2w):
    """Two-pass PyTorch form of kernel 3 (torch.mv), the yardstick the port
    never calls: X v, then the transposed product."""
    return torch.mv(x.t(), (d2w * torch.mv(x, v.to(x.dtype))).to(x.dtype))


def time_hvp(fused_hvp, x, w, loss, labels, gen):
    """Kernel 3 at one of the paths' shapes: the design and its curvature
    at ``w`` (as TRON's operator computes it), a random direction; kernel,
    plain version and torch.mv two-pass form timed in turns."""
    m = x.float() @ w
    d2w = loss.d2(m, labels)
    v = torch.randn(x.shape[1], device="cuda", generator=gen) / math.sqrt(
        x.shape[1])
    err, rel = _grad_err(fused_hvp.fused_hvp(x, v, d2w),
                         fused_hvp.fused_hvp_plain(x, v, d2w))
    tol = KERNEL_RTOL if x.dtype == torch.float32 else BF16_RTOL
    assert rel <= tol, ("kernel3 on a path's design", err, rel)
    calls = 20
    t = time_turns({
        "ms": lambda: fused_hvp.fused_hvp(x, v, d2w),
        "device_ms": captured(lambda: fused_hvp.fused_hvp(x, v, d2w), calls),
        "plain_ms": lambda: fused_hvp.fused_hvp_plain(x, v, d2w),
        "library_ms": lambda: hvp_closed_form_library(x, v, d2w)})
    t["device_ms"] /= calls
    n, d = x.shape
    b, by = hvp_bound_ms(int((d2w != 0).sum()), n, d, x.element_size())
    log(f"  kernel3 {n}x{d} {str(x.dtype)[6:]}: kernel {t['ms']:.4f} ms "
        f"({t['device_ms']:.4f} ms of device time, in a CUDA graph), plain "
        f"{t['plain_ms']:.4f} ms, torch.mv two-pass {t['library_ms']:.4f} "
        f"ms, bound {b:.4f} ms ({by}); max_abs_err vs plain {err:.3e}")
    return dict(max_abs_err=err, bound_ms=b, bound_by=by,
                shape=f"{n}x{d} {str(x.dtype)[6:]}", **t)


def multi_library(loss, x, ws, y, off, wt):
    """Two-pass PyTorch closed form (torch.mm) for M coefficient rows, the
    yardstick the port never calls."""
    m = ws.to(x.dtype) @ x.t() + off
    live = wt > 0
    m = torch.where(live, m, torch.zeros_like(m))
    values = torch.where(live, wt * loss.loss(m, y),
                         torch.zeros_like(m)).sum(-1)
    dvec = torch.where(live, wt * loss.d1(m, y), torch.zeros_like(m))
    return values, dvec.to(x.dtype) @ x


def time_multi(fused_glm, x, ws, loss, labels):
    """Kernel 4 at the GLM path's shape: the design and one coefficient row
    per lambda of the sweep; kernel, plain version and torch.mm form timed
    in turns."""
    n, d = x.shape
    off = torch.zeros(n, device="cuda")
    wt = torch.ones(n, device="cuda")
    args = (loss, x, ws, labels, off, wt)
    err, rel = _max_err(fused_glm.fused_value_and_grad_multi(*args),
                        fused_glm.fused_value_and_grad_plain(*args))
    # in bf16 a wt·d1 rounding flip on this design's 3 decades of column
    # scale outweighs BF16_RTOL; check_multi holds the bf16 kernel
    assert x.dtype != torch.float32 or rel <= KERNEL_RTOL, (
        "kernel4 on the GLM design", err, rel)
    t = time_turns({
        "ms": lambda: fused_glm.fused_value_and_grad_multi(*args),
        "plain_ms": lambda: fused_glm.fused_value_and_grad_plain(*args),
        "library_ms": lambda: multi_library(*args)})
    lanes = ws.shape[0]
    b, by = bound_ms(n, n, d, x.element_size(), lanes, lanes=lanes)
    log(f"  kernel4 {n}x{d} M={lanes} {str(x.dtype)[6:]}: kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.mm two-pass "
        f"{t['library_ms']:.4f} ms, bound {b:.4f} ms ({by}); max_abs_err vs "
        f"plain {err:.3e} (rel {rel:.2e})")
    return dict(max_abs_err=err, bound_ms=b, bound_by=by,
                shape=f"{n}x{d} M={lanes} {str(x.dtype)[6:]}", **t)


# --------------------------------------------------------------------------
# phases 6 and 7: the GLM sweeps
# --------------------------------------------------------------------------

def make_glm(rows, valid_rows, dim, nnz, seed=0):
    """The JAX package's bench GLM problem (bench.py::_make_problem):
    sparse-generated logistic data, densified, with log-uniform column
    scales over 3 decades; ``rows + valid_rows`` rows drawn, the last
    ``valid_rows`` held out. Returns host f32 arrays (x, y) of each part."""
    rng = np.random.default_rng(seed)
    n, d, k = rows + valid_rows, dim, nnz
    r = np.repeat(np.arange(n, dtype=np.int32), k)
    cols = rng.integers(0, d, size=n * k, dtype=np.int32)
    col_scale = np.power(10.0, rng.uniform(-2.0, 1.0, size=d)).astype(
        np.float32)
    vals = (rng.normal(size=n * k).astype(np.float32) / np.sqrt(k)
            * col_scale[cols])
    x = np.zeros((n, d), np.float32)
    np.add.at(x, (r, cols), vals)
    w_true = rng.normal(size=d).astype(np.float32) / col_scale
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(x @ w_true)))).astype(
        np.float32)
    return (x[:rows], y[:rows]), (x[rows:], y[rows:])


def glm_configs(tolerance=1e-6):
    """The GLM path's two optimization settings: TRON and L-BFGS, L2, at
    the reference's relative gradient ``tolerance``."""
    from photon_ml_tpu_torch.glm import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.ops.regularization import L2Regularization
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType

    return (GLMOptimizationConfiguration(
                optimizer=OptimizerType.TRON,
                regularization=L2Regularization,
                optimizer_config=OptimizerConfig(
                    max_iterations=GLM_TRON_MAX_ITER, tolerance=tolerance)),
            GLMOptimizationConfiguration(
                optimizer=OptimizerType.LBFGS,
                regularization=L2Regularization,
                optimizer_config=OptimizerConfig(
                    max_iterations=GLM_LBFGS_MAX_ITER, tolerance=tolerance)))


def glm_sweeps(tolerance=1e-6, batched_tron=False):
    """(name, sweep, config) of the GLM path: TRON through
    ``train_glm_sweep``, L-BFGS through ``train_glm_sweep_batched`` and,
    with ``batched_tron``, TRON through ``train_glm_sweep_batched`` (kernel
    4 for the evaluations, kernel 3 once per lane for each CG product)."""
    from photon_ml_tpu_torch import glm

    tron, lbfgs = glm_configs(tolerance)
    out = [("tron", glm.train_glm_sweep, tron),
           ("batched", glm.train_glm_sweep_batched, lbfgs)]
    if batched_tron:
        out.append(("batched_tron", glm.train_glm_sweep_batched, tron))
    return out


def run_sweeps(train, valid, sweeps):
    """Each sweep of ``sweeps`` (:func:`glm_sweeps`) on ``train``'s device,
    followed by ``validate_and_select`` by AUC; the kernels' launch counts
    are set to 0 just before each sweep and read just after. Returns
    {name: (trained, best, seconds, launches)}."""
    from photon_ml_tpu_torch import glm
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.ops import fused_glm, fused_hvp
    from photon_ml_tpu_torch.types import TaskType

    counted = {"fused_glm": fused_glm.fused_value_and_grad,
               "fused_hvp": fused_hvp.fused_hvp,
               "fused_glm_multi": fused_glm.fused_value_and_grad_multi}
    cuda = train.design.x.is_cuda
    out = {}
    for name, sweep, cfg in sweeps:
        for fn in counted.values():
            fn.launches = 0
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained = sweep(TaskType.LOGISTIC_REGRESSION, train, GLM_LAMBDAS,
                        cfg)
        if cuda:
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        best, trained = glm.validate_and_select(
            trained, parse_evaluators(["AUC"]), valid)
        out[name] = (trained, best, sec, launches)
    return out


#: f32 unit roundoff
U32 = 2.0 ** -24


def check_gradients(label, train, trained):
    """Per lambda, in f64 on ``train``'s device, at the coefficients the
    sweep returned: the L2-regularized logistic objective f(w), the exact
    gradient, and its f32 rounding scale U32 * | |X|^T (|wt d1| + wt d2
    |X||w|) + lambda |w| | (every term of the gradient and of the margins
    it depends on, in absolute value). Asserts that the optimizer's own
    |grad| (f32, from the kernels on the card) matches the exact |grad f(w)|
    within that scale: a kernel that returns a wrong gradient, or a lane
    solved with another lane's lambda, reports a |grad| that f(w) does not
    have. Returns [(f(w), |grad f(w)|)] per lambda."""
    x = train.design.x.double()
    y, wt = train.labels.double(), train.weights.double()
    off = train.offsets.double()
    ax = x.abs()
    out = []
    for tm in trained:
        lam = tm.regularization_weight
        w = tm.model.coefficients.means.to(x.device).double()
        m = x @ w + off
        p = torch.sigmoid(m)
        g = x.t() @ (wt * (p - y)) + lam * w
        scale = ax.t() @ (wt * ((p - y).abs() + p * (1 - p) * (ax @ w.abs()))
                          ) + lam * w.abs()
        f = float((wt * (torch.nn.functional.softplus(m) - y * m)).sum()
                  + 0.5 * lam * (w @ w))
        gn = float(torch.linalg.vector_norm(g))
        eps = U32 * float(torch.linalg.vector_norm(scale))
        reported = float(tm.result.grad_norm)
        log(f"  {label} lambda={lam:g}: |grad f| f64 {gn:.6e} vs reported "
            f"{reported:.6e}: |diff| {abs(gn - reported):.3e} <= f32 scale "
            f"{eps:.3e}; f64 f(w) {f:.10e}")
        assert abs(gn - reported) <= eps, (label, lam, gn, reported, eps)
        out.append((f, gn))
    return out


def hold_to_bound(label, runs_a, runs_b, grads_a, grads_b):
    """Log every lambda's two solutions against (|grad f(w_a)| + |grad
    f(w_b)|) / lambda: each objective is lambda-strongly convex (L2, no
    intercept, no mask), so any iterate w lies within |grad f(w)| / lambda
    of the optimum. That holds for ANY two points, so it only catches a
    non-finite result; :func:`check_gradients` is what a wrong card path
    fails."""
    for lam, a, b, (_, g1), (_, g2) in zip(GLM_LAMBDAS, runs_a, runs_b,
                                           grads_a, grads_b):
        gap = float(torch.linalg.vector_norm(
            a.model.coefficients.means.cpu().double()
            - b.model.coefficients.means.cpu().double()))
        bound = (g1 + g2) / lam
        log(f"  {label} lambda={lam:g}: |w_a - w_b| {gap:.3e} <= bound "
            f"{bound:.3e} (|grad f| {g1:.2e} / {g2:.2e})")
        assert gap <= bound, (label, lam, gap, bound)


def log_sweep(name, trained, best, sec, launches):
    log(f"  {name} sweep: {sec:.3f} s; launches {launches}; best lambda "
        f"{trained[best].regularization_weight:g}")
    for tm in trained:
        r = tm.result
        log(f"    lambda={tm.regularization_weight:g}: iterations "
            f"{int(r.iterations)}, converged {bool(r.converged)}, value "
            f"{float(r.value):.6f}, |grad| {float(r.grad_norm):.3e}, AUC "
            f"{tm.evaluation.primary[1]:.6f}")


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 8: the e2e CLI, Avro in, model directory out
# --------------------------------------------------------------------------

def e2e_records(data):
    """TrainingExampleAvro records of one make_e2e GameData, laid out as
    ``bench.py::_write_e2e_file`` lays them out: the global shard's
    features as ``g.x{k}`` (its intercept column left to the reader), the
    item shard's as ``it.x{k}``, ``userId`` ``u{user}`` and ``songId``
    ``s{song}`` in the metadata map, null offsets and weights."""
    n = data.n_samples
    g, it = data.shards["global"], data.shards["item"]
    assert (np.diff(g.indptr) == 7).all() and (np.diff(it.indptr) == 4).all()
    intercept = g.dim - 1
    g_cols, g_vals = g.cols.reshape(n, 7).tolist(), g.vals.reshape(n, 7).tolist()
    i_cols, i_vals = it.cols.reshape(n, 4).tolist(), it.vals.reshape(n, 4).tolist()
    labels = data.labels.tolist()
    users = data.id_columns["userId"].tolist()
    songs = data.id_columns["songId"].tolist()
    for j in range(n):
        feats = [{"name": f"g.x{k}", "term": "", "value": v}
                 for k, v in zip(g_cols[j], g_vals[j]) if k != intercept]
        feats += [{"name": f"it.x{k}", "term": "", "value": v}
                  for k, v in zip(i_cols[j], i_vals[j])]
        yield {"uid": str(j), "response": labels[j], "offset": None,
               "weight": None, "features": feats,
               "metadataMap": {"userId": f"u{users[j]}",
                               "songId": f"s{songs[j]}"}}


def cli_args(train, valid, out):
    """``bench.py::bench_end_to_end``'s arguments (bench.py:1191-1209),
    with the validation file and the AUC evaluator."""
    return [
        "--training-data", train, "--validation-data", valid,
        "--output-dir", out,
        "--feature-shards", "global=g|intercept,item=it|noIntercept",
        "--coordinates",
        f"global=fixed,shard=global,reg=L2,maxIter={E2E_MAX_ITER}",
        (f"perUser=random,entity=userId,shard=item,reg=L2,"
         f"maxIter={E2E_MAX_ITER},buckets=histogram,maxSampleBuckets=4"),
        (f"perSong=random,entity=songId,shard=item,reg=L2,"
         f"maxIter={E2E_MAX_ITER},buckets=histogram,maxSampleBuckets=4"),
        "--update-sequence", "global,perUser,perSong",
        "--cd-iterations", "1",
        "--grid", f"global={E2E_LAMBDAS['global']}",
        f"perUser={E2E_LAMBDAS['perUser']}",
        f"perSong={E2E_LAMBDAS['perSong']}",
        "--data-validation", "VALIDATE_DISABLED",
        "--design-dtype", "bfloat16",
        "--evaluators", "AUC",
    ]


class Counted:
    """Wraps a module function and counts its calls."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = 0

    def __enter__(self):
        def wrapper(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def run_cli_phase(tg, fused_glm, fused_re, auc_phase3, auc_fe, tmp):
    """Phase 8, in the directory ``tmp``; returns the kernels' launch
    counts of the CLI run and what phase 10 scores: the run directory, the
    validation file and ``best/``'s rescored AUC."""
    from photon_ml_tpu_torch import native
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.io import data_reader, model_io
    from photon_ml_tpu_torch.io.index import IndexMap

    train, valid = make_e2e(tg, **E2E)
    paths = {}
    t0 = time.perf_counter()
    for name, data in (("train", train), ("valid", valid)):
        paths[name] = os.path.join(tmp, f"{name}.avro")
        data_reader.write_training_examples(
            paths[name], e2e_records(data), codec="null")
    write_s = time.perf_counter() - t0
    size = {k: os.path.getsize(p) for k, p in paths.items()}
    log(f"[8] wrote phase 3's rows to Avro ({E2E['rows']} + "
        f"{E2E['valid_rows']} records, null codec, {size['train']} + "
        f"{size['valid']} bytes) in {write_s:.2f} s (pure Python, not "
        "in the wall below)")
    del train, valid
    # the native library's g++ build happens once a checkout, outside
    # the wall
    t0 = time.perf_counter()
    assert native.available(), "the native decoder did not build"
    log(f"[8] built the native ingest library (g++) in "
        f"{time.perf_counter() - t0:.2f} s")
    out = os.path.join(tmp, "run")
    fused_glm.fused_value_and_grad.launches = 0
    fused_re.fused_entity_value_and_grad.launches = 0
    with Counted(native, "decode_training_file") as nat, \
            Counted(data_reader, "iter_avro_file") as py:
        t0 = time.perf_counter()
        result = train_game.run(cli_args(paths["train"], paths["valid"],
                                         out))
        wall = time.perf_counter() - t0
    launches = {"fused_glm": fused_glm.fused_value_and_grad.launches,
                "fused_re": fused_re.fused_entity_value_and_grad.launches}
    decoder = ("native" if nat.calls == 2 and py.calls == 0 else
               f"python ({py.calls} files; native {nat.calls})")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        stages = [json.loads(line) for line in f]
    auc = result["best_evaluation"]["AUC"]
    best = os.path.join(out, "best")
    model_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(best) for f in files)
    log(f"[8] train_game.run, Avro open to model on disk: {wall:.2f} s")
    for st in stages:
        if "seconds" in st:
            log(f"  {st['stage']}: {st['seconds']:.3f} s")
    log(f"  decoder: {decoder}")
    log(f"  launches: {launches}")
    log(f"  validation AUC {auc:.7f}; phase 3 {auc_phase3:.7f} "
        f"(|diff| {abs(auc - auc_phase3):.2e}, limit {CLI_AUC_TOL:g}); "
        f"fixed effect alone {auc_fe:.7f}")
    log(f"  best/: {model_bytes} bytes in "
        f"{sum(len(f) for _, _, f in os.walk(best))} files")
    assert decoder == "native", decoder
    assert launches["fused_glm"] > 0 and launches["fused_re"] > 0, \
        launches
    assert abs(auc - auc_phase3) <= CLI_AUC_TOL, (auc, auc_phase3)
    assert auc > auc_fe + 0.01, (auc, auc_fe)

    # best/ loaded again with the run's index maps and vocabularies
    t0 = time.perf_counter()
    shards = tuple(parse_feature_shard_config(s) for s in
                   ("global=g|intercept", "item=it|noIntercept"))
    maps = {c.shard_id: IndexMap.load(os.path.join(
        out, "feature-indexes", f"{c.shard_id}.json")) for c in shards}
    reader = data_reader.AvroDataReader(shard_configs=shards,
                                        index_maps=maps)
    ids = ("songId", "userId")
    _, _, vocabs = reader.read(paths["train"], id_columns=ids)
    vdata, _, _ = reader.read(paths["valid"], id_columns=ids,
                              entity_vocabs=vocabs)
    model = model_io.load_game_model(
        model_io.resolve_game_model_dir(out), maps, vocabs,
        device="cuda")
    reload_auc = parse_evaluators(["AUC"])[0].evaluate(
        model.score(vdata), vdata.labels, vdata.weights)
    log(f"  best/ reloaded and rescored in "
        f"{time.perf_counter() - t0:.2f} s: AUC {reload_auc:.7f} "
        f"(|diff| {abs(reload_auc - auc):.2e}, limit "
        f"{RELOAD_AUC_TOL:g})")
    assert abs(reload_auc - auc) <= RELOAD_AUC_TOL, (reload_auc, auc)
    return launches, dict(run=out, valid=paths["valid"], auc=reload_auc)


# --------------------------------------------------------------------------
# phase 9: the GLM command, Avro in, model directory out
# --------------------------------------------------------------------------

#: phase 9's wide sparse file: 64 nonzeros a row over 100,000 columns (the
#: shape of the JAX package's ChunkedSparseDesign measurement,
#: photon_ml_tpu/ops/design.py:155-160), and its card-vs-CPU cut
WIDE = dict(rows=200_000, valid_rows=20_000, dim=100_000, nnz=64)
WIDE_SMALL = dict(rows=20_000, valid_rows=4_000, dim=50_000, nnz=64)
#: train_glm's runs: (name, data, arguments). (a)-(c) on phase 6's rows
#: without an intercept, as phase 6 solves them; (d) on the wide file with
#: train_glm's default intercept
GLM_CLI_RUNS = [
    ("tron", "dense", ["--no-intercept", "--optimizer", "TRON",
                       "--max-iterations", str(GLM_TRON_MAX_ITER)]),
    ("batched", "dense", ["--no-intercept", "--sweep-mode", "batched",
                          "--max-iterations", str(GLM_LBFGS_MAX_ITER)]),
    ("owlqn", "dense", ["--no-intercept", "--optimizer", "OWLQN",
                        "--regularization-type", "ELASTIC_NET",
                        "--elastic-net-alpha", "0.5",
                        "--max-iterations", str(GLM_LBFGS_MAX_ITER)]),
    ("owlqn_batched", "dense", ["--no-intercept", "--optimizer", "OWLQN",
                                "--regularization-type", "ELASTIC_NET",
                                "--elastic-net-alpha", "0.5",
                                "--sweep-mode", "batched",
                                "--max-iterations", str(GLM_LBFGS_MAX_ITER)]),
    ("sparse", "wide", ["--max-iterations", str(GLM_LBFGS_MAX_ITER)]),
]
#: the kernels each run must launch (and the sparse run none)
GLM_CLI_KERNELS = {"tron": ("fused_glm", "fused_hvp"),
                   "batched": ("fused_glm_multi",),
                   "owlqn": ("fused_glm",),
                   "owlqn_batched": ("fused_glm_multi",),
                   "sparse": ()}


def make_wide(rows, valid_rows, dim, nnz, seed=2):
    """Sparse logistic rows of ``nnz`` distinct columns out of ``dim``
    (values N(0, 1/nnz), labels from planted N(0, 4) coefficients), as CSR
    (indptr, cols, vals, labels) of the ``rows`` training and the
    ``valid_rows`` held-out rows."""
    rng = np.random.default_rng(seed)
    n = rows + valid_rows
    cols = (np.sort(rng.integers(0, dim - nnz + 1, size=(n, nnz)), axis=1)
            + np.arange(nnz))
    vals = (rng.normal(size=(n, nnz)) / np.sqrt(nnz)).astype(np.float32)
    w_true = 2.0 * rng.normal(size=dim)
    m = (w_true[cols] * vals).sum(1)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-m))).astype(np.float32)
    indptr = np.arange(rows + 1, dtype=np.int64) * nnz
    vptr = np.arange(valid_rows + 1, dtype=np.int64) * nnz
    return ((indptr, cols[:rows].ravel(), vals[:rows].ravel(), y[:rows]),
            (vptr, cols[rows:].ravel(), vals[rows:].ravel(), y[rows:]))


def dense_csr(x, y):
    """The nonzeros of a dense ``x`` as CSR (indptr, cols, vals, labels)."""
    r, c = np.nonzero(x)
    indptr = np.zeros(len(x) + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=len(x)), out=indptr[1:])
    return indptr, c.astype(np.int32), x[r, c], y


def write_glm_part(path, indptr, cols, vals, labels, first_uid):
    """One TrainingExampleAvro file (null codec) of CSR rows: features
    ``x{col}``, no offsets, weights or metadata. Runs in a worker
    process."""
    from photon_ml_tpu_torch.io import data_reader

    cols, vals = cols.tolist(), vals.tolist()
    labels = labels.tolist()

    def records():
        for j, y in enumerate(labels):
            a, b = int(indptr[j]), int(indptr[j + 1])
            yield {"uid": str(first_uid + j), "response": y, "offset": None,
                   "weight": None,
                   "features": [{"name": f"x{c}", "term": "", "value": v}
                                for c, v in zip(cols[a:b], vals[a:b])],
                   "metadataMap": {}}

    data_reader.write_training_examples(path, records(), codec="null")
    return os.path.getsize(path)


def write_glm_files(root, sets, parts=4):
    """Write each CSR set of ``sets`` ({name: csr}) under ``root``: a
    directory of ``parts`` files, all sets at once over a pool of spawned
    worker processes. Returns ({name: path}, total bytes, records)."""
    import concurrent.futures
    import multiprocessing

    jobs, paths = [], {}
    for name, (indptr, cols, vals, labels) in sets.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        paths[name] = d
        n = len(labels)
        cuts = np.linspace(0, n, min(parts, n) + 1).astype(np.int64)
        for k, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            a, b = indptr[lo], indptr[hi]
            jobs.append((os.path.join(d, f"part-{k:02d}.avro"),
                         indptr[lo:hi + 1] - a, cols[a:b], vals[a:b],
                         labels[lo:hi], int(lo)))
    workers = min(len(jobs), os.cpu_count() or 1, 8)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        sizes = list(pool.map(write_glm_part, *zip(*jobs)))
    return paths, sum(sizes), sum(len(s[3]) for s in sets.values())


def glm_cli_args(train, valid, out, extra, device=None):
    args = ["--training-data", train, "--validation-data", valid,
            "--output-dir", out, "--evaluators", "AUC",
            "--regularization-weights",
            ";".join(f"{lam:g}" for lam in GLM_LAMBDAS)] + extra
    return args + (["--device", device] if device else [])


def read_run(out):
    """A train_glm run directory: its stage walls, per-lambda (reported
    |grad|, iterations, converged, AUC) and coefficients (host f64 arrays
    in the run's feature order), and its feature index."""
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.io.index import IndexMap

    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    imap = IndexMap.load(os.path.join(out, "feature-index.json"))
    lams = {}
    for m in lines:
        if m["stage"] == "train":
            lam = m["regularization_weight"]
            w = model_io.load_glm_model(
                os.path.join(out, "all", f"lambda-{lam:g}", "model.avro"),
                imap, device="cpu").coefficients.means
            lams[lam] = dict(grad_norm=m["grad_norm"],
                             iterations=m["iterations"],
                             converged=m["converged"],
                             w=w.double().numpy())
        elif m["stage"] == "validate":
            lams[m["regularization_weight"]]["auc"] = m["AUC"]
    stages = [(m["stage"], m["seconds"]) for m in lines if "seconds" in m]
    return stages, lams, imap


def read_glm_data(path, imap, device):
    """``path`` read with a run's feature index into train_glm's
    GLMData on ``device``."""
    from photon_ml_tpu_torch.cli import train_glm
    from photon_ml_tpu_torch.io import data_reader

    reader = data_reader.AvroDataReader(
        shard_configs=(data_reader.FeatureShardConfig(
            "global", feature_bags=None, has_intercept=imap.has_intercept),),
        index_maps={"global": imap})
    data, _, _ = reader.read(path)
    return train_glm._to_glm_data(data, "global", "float32", device)


class Contractions:
    """``X v``, ``Xᵀ g`` and their |X| versions in f64 for a GLMData's
    design, dense or chunked sparse (f32 values, f64 sums)."""

    def __init__(self, glm):
        from photon_ml_tpu_torch.ops.design import DenseDesign

        d = glm.design
        if isinstance(d, DenseDesign):
            x = d.x.double()
            ax = x.abs()
            self.mv, self.rmv = (lambda v: x @ v), (lambda g: x.t() @ g)
            self.amv, self.armv = (lambda v: ax @ v), (lambda g: ax.t() @ g)
        else:
            a = dataclasses.replace(d, rvals=d.rvals.abs(),
                                    cvals=d.cvals.abs())
            self.mv, self.rmv = d.matvec, d.rmatvec
            self.amv, self.armv = a.matvec, a.rmatvec
        self.y = glm.labels.double()
        self.wt = glm.weights.double()
        self.off = glm.offsets.double()


def elastic_net_objective(c, w, lam, alpha, mask):
    """f64 logistic objective + 0.5 (1-alpha) lam |mask w|^2 + alpha lam
    |w|_1 at host ``w``, with its exact (pseudo-)gradient and that
    gradient's f32 rounding scale (see :func:`check_gradients`).
    Returns (f(w), |pg|, scale)."""
    from photon_ml_tpu_torch.optimize.owlqn import pseudo_gradient

    dev = c.y.device
    w = torch.as_tensor(w, device=dev)
    mk = torch.ones_like(w) if mask is None else torch.as_tensor(
        mask, dtype=torch.float64, device=dev)
    l1, l2 = alpha * lam, (1.0 - alpha) * lam
    m = c.mv(w) + c.off
    p = torch.sigmoid(m)
    g = c.rmv(c.wt * (p - c.y)) + l2 * mk * w
    pg = pseudo_gradient(w, g, torch.full_like(w, l1))
    scale = (c.armv(c.wt * ((p - c.y).abs() + p * (1 - p) * c.amv(w.abs())))
             + l2 * mk * w.abs() + l1)
    f = float((c.wt * (torch.nn.functional.softplus(m) - c.y * m)).sum()
              + 0.5 * l2 * ((mk * w) ** 2).sum() + l1 * w.abs().sum())
    return (f, float(torch.linalg.vector_norm(pg)),
            U32 * float(torch.linalg.vector_norm(scale)))


def check_cli_gradients(label, c, lams, alpha, mask):
    """Phase 6's gradient check on a train_glm run's coefficients: the
    reported |grad| (the pseudo-gradient's under an L1 part) against the
    exact f64 one within its f32 rounding scale. Returns {lam: f(w)}."""
    out = {}
    for lam, r in sorted(lams.items(), reverse=True):
        f, gn, eps = elastic_net_objective(c, r["w"], lam, alpha, mask)
        log(f"  {label} lambda={lam:g}: |grad f| f64 {gn:.6e} vs reported "
            f"{r['grad_norm']:.6e}: |diff| {abs(gn - r['grad_norm']):.3e} "
            f"<= f32 scale {eps:.3e}; f64 f(w) {f:.10e}; iterations "
            f"{r['iterations']}, converged {r['converged']}; zeros "
            f"{int((r['w'] == 0).sum())}/{r['w'].size}; AUC "
            f"{r['auc']:.7f}")
        assert abs(gn - r["grad_norm"]) <= eps, (label, lam, gn, r, eps)
        out[lam] = f
    return out


def rescore(out, valid_glm, imap, auc):
    """``best/model.avro`` loaded with the run's feature index scores the
    validation rows to the run's AUC within RELOAD_AUC_TOL."""
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.io import model_io

    model = model_io.load_glm_model(os.path.join(out, "best", "model.avro"),
                                    imap, device=valid_glm.labels.device)
    scores = model.score(valid_glm.design).cpu().numpy()
    got = parse_evaluators(["AUC"])[0].evaluate(
        scores, valid_glm.labels.cpu().numpy())
    assert abs(got - auc) <= RELOAD_AUC_TOL, (out, got, auc)
    return got


def run_glm_cli_phase(fused_glm, fused_hvp, fused_re, phase6,
                      device="cuda"):
    """Phase 9; ``phase6`` is {sweep: (best lambda, AUC)} of phase 6's
    in-memory sweeps. Returns each run's kernel launch counts. The
    full-width runs' checks run on ``device``."""
    from photon_ml_tpu_torch.cli import train_glm
    from photon_ml_tpu_torch.ops.design import ChunkedSparseDesign

    counted = {"fused_glm": fused_glm.fused_value_and_grad,
               "fused_hvp": fused_hvp.fused_hvp,
               "fused_glm_multi": fused_glm.fused_value_and_grad_multi,
               "fused_re": fused_re.fused_entity_value_and_grad}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_glm_")
    try:
        t0 = time.perf_counter()
        (x_tr, y_tr), (x_va, y_va) = make_glm(**GLM)
        (xs_tr, ys_tr), (xs_va, ys_va) = make_glm(**GLM_SMALL, seed=1)
        wide, wide_va = make_wide(**WIDE)
        wide_s, wide_s_va = make_wide(**WIDE_SMALL, seed=3)
        sets = {"dense": dense_csr(x_tr, y_tr),
                "dense_valid": dense_csr(x_va, y_va),
                "small": dense_csr(xs_tr, ys_tr),
                "small_valid": dense_csr(xs_va, ys_va),
                "wide": wide, "wide_valid": wide_va,
                "wide_small": wide_s, "wide_small_valid": wide_s_va}
        del x_tr, x_va
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths, nbytes, nrec = write_glm_files(tmp, sets)
        log(f"[9] generated the GLM rows in {gen_s:.1f} s and wrote them to "
            f"Avro ({nrec} records in {len(sets)} sets, null codec, {nbytes} "
            f"bytes) in {time.perf_counter() - t0:.2f} s (spawned writer "
            "processes, not in the walls below)")
        del sets

        launches, runs = {}, {}
        for name, data, extra in GLM_CLI_RUNS:
            out = os.path.join(tmp, name)
            for fn in counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            result = train_glm.run(glm_cli_args(
                paths[data], paths[data + "_valid"], out, extra))
            wall = time.perf_counter() - t0
            launches[name] = {k: fn.launches for k, fn in counted.items()}
            stages, lams, imap = read_run(out)
            runs[name] = (result, lams, imap, out)
            log(f"[9] train_glm {name} ({' '.join(extra)}): {wall:.2f} s "
                f"from Avro open to models on disk; best lambda "
                f"{result['best_lambda']:g}, AUC "
                f"{result['best_evaluation']['AUC']:.7f}")
            for stage, sec in stages:
                log(f"  {stage}: {sec:.3f} s")
            log(f"  launches: {launches[name]}")
            for k in GLM_CLI_KERNELS[name]:
                assert launches[name][k] > 0, (name, launches[name])
            if name == "sparse":
                assert not any(launches[name].values()), launches[name]

        # (a) and (b) against phase 6's in-memory sweeps of the same rows
        for name in ("tron", "batched"):
            result = runs[name][0]
            lam6, auc6 = phase6[name]
            auc = result["best_evaluation"]["AUC"]
            log(f"  {name}: best lambda {result['best_lambda']:g} (phase 6 "
                f"{lam6:g}); AUC {auc:.7f} (phase 6 {auc6:.7f}, |diff| "
                f"{abs(auc - auc6):.2e}, limit {CLI_AUC_TOL:g})")
            assert result["best_lambda"] == lam6, (name, result, lam6)
            assert abs(auc - auc6) <= CLI_AUC_TOL, (name, auc, auc6)

        # every lambda's reported |grad| and the reloaded best models
        checks = {"dense": ("tron", "batched", "owlqn", "owlqn_batched"),
                  "wide": ("sparse",)}
        for data, names in checks.items():
            imap = runs[names[0]][2]
            train = read_glm_data(paths[data], imap, device)
            valid = read_glm_data(paths[data + "_valid"], imap, device)
            c = Contractions(train)
            for name in names:
                result, lams, imap_n, out = runs[name]
                assert imap_n.names() == imap.names(), name
                alpha = 0.5 if name.startswith("owlqn") else 0.0
                mask = cli_mask(imap)
                check_cli_gradients(name, c, lams, alpha, mask)
                auc = result["best_evaluation"]["AUC"]
                got = rescore(out, valid, imap, auc)
                log(f"  {name}: best/ reloaded and rescored: AUC "
                    f"{got:.7f} (|diff| {abs(got - auc):.2e}, limit "
                    f"{RELOAD_AUC_TOL:g})")
            if data == "dense":
                top = runs["owlqn"][1][max(GLM_LAMBDAS)]["w"]
                topb = runs["owlqn_batched"][1][max(GLM_LAMBDAS)]["w"]
                log(f"  elastic net at lambda={max(GLM_LAMBDAS):g}: "
                    f"{int((top == 0).sum())} (sequential), "
                    f"{int((topb == 0).sum())} (batched) of {top.size} "
                    "coefficients exactly 0")
                assert (top == 0).any() and (topb == 0).any()
            else:
                # the sparse contractions rerun bit for bit on the card
                d = train.design
                assert isinstance(d, ChunkedSparseDesign)
                gen = torch.Generator(device=device).manual_seed(97)
                w = torch.randn(d.dim, device=device, generator=gen)
                g = torch.randn(d.n_samples, device=device, generator=gen)
                reruns = [(d.matvec(w), d.rmatvec(g)) for _ in range(3)]
                same = all(torch.equal(a[0], reruns[0][0])
                           and torch.equal(a[1], reruns[0][1])
                           for a in reruns[1:])
                log(f"  sparse design {d.n_samples} x {d.dim}, "
                    f"{int((d.rvals != 0).sum())} stored values, chunks "
                    f"{tuple(d.rvals.shape)} rows / {tuple(d.cvals.shape)} "
                    f"columns: matvec and rmatvec bit-identical over 3 "
                    f"runs: {same}")
                assert same
            del train, valid, c
            if device == "cuda":
                torch.cuda.empty_cache()

        # (c) and (d) cut to size, on the card and on the CPU
        small_runs = [("owlqn", "small", GLM_CLI_RUNS[2][2]),
                      ("owlqn_batched", "small", GLM_CLI_RUNS[3][2]),
                      ("sparse", "wide_small", GLM_CLI_RUNS[4][2])]
        worst, worst_auc, held = 0.0, 0.0, 0
        for name, data, extra in small_runs:
            extra = extra + ["--tolerance", f"{GLM_SMALL_TOLERANCE:g}"]
            lams, objective = {}, {}
            for device in ("cuda", "cpu"):
                out = os.path.join(tmp, f"{name}_{data}_{device}")
                t0 = time.perf_counter()
                train_glm.run(glm_cli_args(paths[data],
                                           paths[data + "_valid"], out,
                                           extra, device=device))
                log(f"[9] train_glm {name} on {data} ({device}): "
                    f"{time.perf_counter() - t0:.2f} s")
                _, lams[device], imap = read_run(out)
                c = Contractions(read_glm_data(paths[data], imap, device))
                objective[device] = check_cli_gradients(
                    f"{device} {name}", c,
                    lams[device], 0.5 if name.startswith("owlqn") else 0.0,
                    cli_mask(imap))
            for lam in GLM_LAMBDAS:
                a, b = lams["cuda"][lam], lams["cpu"][lam]
                fa, fb = objective["cuda"][lam], objective["cpu"][lam]
                both = a["converged"] and b["converged"]
                rel = abs(fa - fb) / abs(fb)
                d_auc = abs(a["auc"] - b["auc"])
                worst = max(worst, rel)
                held += both
                worst_auc = max(worst_auc, d_auc)
                log(f"    {name} lambda={lam:g}: converged {a['converged']}"
                    f"/{b['converged']}; f64 f(w) relative |cuda - cpu| "
                    f"{rel:.3e} (limit {OBJECTIVE_RTOL[both]:g}); |AUC cuda "
                    f"- AUC cpu| {d_auc:.2e} (limit 1e-4)")
                assert rel <= OBJECTIVE_RTOL[both], (name, lam, rel)
                assert d_auc <= 1e-4, (name, lam, d_auc)
        log(f"[9] card vs CPU: f64 objectives within {worst:.3e} relative "
            f"({held} lambdas converged on both devices), AUCs within "
            f"{worst_auc:.2e}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cli_mask(imap):
    """train_glm's L2 mask: 0 on the intercept, if the run has one."""
    from photon_ml_tpu_torch.types import INTERCEPT_KEY

    if not imap.has_intercept:
        return None
    mask = np.ones(len(imap))
    mask[imap.key_to_index[INTERCEPT_KEY]] = 0.0
    return mask


# --------------------------------------------------------------------------
# phase 10: scoring, batch (score_game) and online (engine, HTTP)
# --------------------------------------------------------------------------

#: score_game's AUC vs phase 8's rescored best/ (the same model and rows)
SCORE_AUC_TOL = 1e-6
#: the engine at serve_game's default max batch: buckets 1 .. 1024 are 11
#: CUDA graphs; ENGINE_RECORDS validation records in batches of seeded
#: random sizes from 1 to ENGINE_MAX_REQUEST (some chunked past 1024)
ENGINE_MAX_BATCH = 1024
ENGINE_CAPTURES = 11
ENGINE_RECORDS = 20_000
ENGINE_MAX_REQUEST = 1_500
#: quantized tables vs f32: each row held to the error its storage format
#: allows (:func:`quant_bounds`); the JAX package's gates relative to
#: max(|f32|, 1) (tests/test_serving.py: bf16 1e-2, int8 5e-2, set on a
#: 3-wide random effect) are printed beside them.
QUANT_RTOL = {"bfloat16": 1e-2, "int8": 5e-2}
#: table bytes a row of d coefficients: f32 4d, bf16 2d, int8 d plus its
#: f32 scale (so int8 is 4d / (d + 4) below f32: 2.67x at the 8-wide item
#: shard, 3.69x at the JAX package's 48-wide test table)
ROW_BYTES = {"float32": lambda d: 4 * d, "bfloat16": lambda d: 2 * d,
             "int8": lambda d: d + 4}
#: HTTP: client threads x single-record POSTs to /score, microbatch 64
HTTP_THREADS = 8
HTTP_REQUESTS = 250
HTTP_MICROBATCH = 64
E2E_SHARDS = "global=g|intercept,item=it|noIntercept"


def score_batch_phase(run, valid, auc_phase8, device="cuda"):
    """(a) ``score_game.run`` over phase 8's validation file with AUC and
    the breakdown; returns its scores (f32, file order)."""
    from photon_ml_tpu_torch import native
    from photon_ml_tpu_torch.cli import score_game
    from photon_ml_tpu_torch.game.model import sum_coordinate_margins
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    out = os.path.join(os.path.dirname(run), "scores")
    with Counted(native, "write_scoring_results") as nat, \
            Counted(score_game, "write_avro_file") as py:
        t0 = time.perf_counter()
        result = score_game.run([
            "--data", valid, "--model-dir", run, "--output-dir", out,
            "--feature-shards", E2E_SHARDS, "--evaluators", "AUC",
            "--score-breakdown", "--device", device])
        wall = time.perf_counter() - t0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        stages = [json.loads(line) for line in f]
    auc = result["evaluation"]["AUC"]
    log(f"[10a] score_game.run, {result['n_scored']} records: {wall:.2f} s")
    for st in stages:
        if "seconds" in st:
            log(f"  {st['stage']}: {st['seconds']:.3f} s")
    log(f"  writer: native {nat.calls}, python {py.calls}; AUC "
        f"{auc:.7f}, phase 8 {auc_phase8:.7f} (|diff| "
        f"{abs(auc - auc_phase8):.2e}, limit {SCORE_AUC_TOL:g})")
    assert nat.calls == 1 and py.calls == 0, (nat.calls, py.calls)
    assert abs(auc - auc_phase8) <= SCORE_AUC_TOL, (auc, auc_phase8)
    t0 = time.perf_counter()
    scores = np.array([r["predictionScore"] for r in iter_avro_file(
        os.path.join(out, "scores.avro"))])
    with open(os.path.join(out, "score-breakdown.json")) as f:
        breakdown = json.load(f)
    # the validation records carry no offsets
    totals = sum_coordinate_margins(
        np.zeros(len(scores), np.float32),
        (np.asarray(breakdown[cid], np.float32)
         for cid in ("global", "perUser", "perSong")))
    assert list(breakdown) == ["global", "perUser", "perSong"], \
        list(breakdown)
    assert np.array_equal(totals.astype(np.float64), scores)
    assert np.array_equal(scores.astype(np.float32).astype(np.float64),
                          scores)
    log(f"  breakdown totals bit-identical to scores.avro "
        f"({time.perf_counter() - t0:.2f} s to read both)")
    return scores.astype(np.float32)


def _unseen(records):
    """The records with ids no model saw, and the same without ids."""
    named = [{**r, "metadataMap": {"userId": f"uNEVER{i}",
                                   "songId": f"sNEVER{i}"}}
             for i, r in enumerate(records)]
    return named, [{**r, "metadataMap": {}} for r in records]


def quant_bounds(sm, records):
    """Per record, the most its f32 score can move when its random-effect
    rows are stored in bf16 or int8: a bf16 row rounds each coefficient
    to 8 significant bits (|dw| <= 2^-8 |w|), an int8 row to a multiple
    of its scale max|w|/127 (|dw| <= scale/2); the f32 roundings of the
    margins and the total add 2^-22 (|total| + sum |margin|). ``sm`` is
    the f32 version."""
    batch = sm.engine.pack(records)
    total, margins = sm.engine.score_batch(batch, with_margins=True)
    slack = 2.0 ** -22 * (np.abs(total) + sum(np.abs(m) for m in margins))
    x_of = dict(zip(sm.engine._shard_order, batch.xs))
    bounds = {"bfloat16": slack.astype(np.float64),
              "int8": slack.astype(np.float64)}
    for cid, rows in zip(sm.engine._re_order, batch.rows):
        store = sm.stores[cid]
        w = np.abs(store.table.cpu().numpy().astype(np.float64))[rows]
        x = np.abs(x_of[store.feature_shard_id].astype(np.float64))
        bounds["bfloat16"] += 2.0 ** -8 * (x * w).sum(1)
        bounds["int8"] += 0.5 * w.max(1) / 127.0 * x.sum(1)
    return bounds


def serve_engine_phase(run, records, want, device="cuda"):
    """(b) the engine in each table format over ``records`` in batches of
    seeded random sizes; returns the f32 scores."""
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.serving import ModelRegistry, next_bucket
    from photon_ml_tpu_torch.serving import engine as serving_engine

    shards = tuple(parse_feature_shard_config(s)
                   for s in E2E_SHARDS.split(","))
    sizes = []
    rng = np.random.default_rng(10)
    while sum(sizes) < len(records):
        sizes.append(int(rng.integers(1, ENGINE_MAX_REQUEST + 1)))
    sizes[-1] -= sum(sizes) - len(records)
    assert max(sizes) > ENGINE_MAX_BATCH, sizes
    latency = serving_engine._SCORE_LATENCY
    scores, table_bytes = {}, {}
    for dtype in ("float32", "bfloat16", "int8"):
        registry = ModelRegistry(shards, max_batch=ENGINE_MAX_BATCH,
                                 table_dtype=dtype, device=device)
        t0 = time.perf_counter()
        sm = registry.load(run)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        captures = sm.engine.warmup()
        warm_s = time.perf_counter() - t0
        frozen = sm.engine.compile_count
        before = {b: latency.labels(bucket=str(b)).snapshot()[1:]
                  for b in (1 << k for k in range(ENGINE_CAPTURES))}
        per_bucket = {}
        out, lo = [], 0
        t0 = time.perf_counter()
        for n in sizes:
            t1 = time.perf_counter()
            batch = sm.engine.pack(records[lo:lo + n])
            t2 = time.perf_counter()
            out.append(sm.engine.score_batch(batch))
            t3 = time.perf_counter()
            b = next_bucket(min(n, ENGINE_MAX_BATCH))
            acc = per_bucket.setdefault(b, [0, 0.0, 0.0])
            acc[0] += 1
            acc[1] += t2 - t1
            acc[2] += t3 - t2
            lo += n
        wall = time.perf_counter() - t0
        got = np.concatenate(out)
        scores[dtype] = got
        table_bytes[dtype] = sum(s.table_bytes for s in sm.stores.values())
        assert table_bytes[dtype] == sum(
            s.table.shape[0] * ROW_BYTES[dtype](s.dim)
            for s in sm.stores.values()), (dtype, table_bytes[dtype])
        log(f"[10b] engine {dtype} on {device}: load {load_s:.2f} s, "
            f"warmup {captures} captures {warm_s:.2f} s; {len(records)} "
            f"records in {len(sizes)} batches (sizes 1-{max(sizes)}) "
            f"{wall:.2f} s; captures after warmup "
            f"{sm.engine.compile_count - frozen}; tables {table_bytes[dtype]}"
            f" bytes")
        log("  bucket: batches, batch_assemble ms, execute ms (mean a "
            "batch; host clock), device leg ms (copy-in, replay, copy-out; "
            "mean a chunk)")
        for b in sorted(per_bucket):
            k, pack_s, exec_s = per_bucket[b]
            s0, c0 = before[b]
            _, s1, c1 = latency.labels(bucket=str(b)).snapshot()
            leg = 1e3 * (s1 - s0) / max(c1 - c0, 1)
            log(f"  {b:5d}: {k:3d}, {1e3 * pack_s / k:8.3f}, "
                f"{1e3 * exec_s / k:7.3f}, {leg:7.3f}")
        assert captures == ENGINE_CAPTURES, captures
        assert sm.engine.compile_count == frozen, sm.engine.compile_count
        named, anonymous = _unseen(records[:256])
        assert np.array_equal(sm.score(named), sm.score(anonymous)), dtype
        assert np.isfinite(got).all() and got.shape == (len(records),)
        if dtype == "float32":
            bounds = quant_bounds(sm, records)
        del registry, sm
    f32 = scores["float32"]
    mismatch = int(np.count_nonzero(f32 != want))
    log(f"  f32 vs score_game: {mismatch} of {len(f32)} scores differ "
        f"(bit parity)")
    assert mismatch == 0, mismatch
    for dtype, rtol in QUANT_RTOL.items():
        err = np.abs(scores[dtype].astype(np.float64) - f32)
        rel = err / np.maximum(np.abs(f32), 1.0)
        worst = float((err / bounds[dtype]).max())
        log(f"  {dtype} vs f32: |diff| at most {worst:.3f} of the format's "
            f"bound; relative to max(|f32|, 1): max {rel.max():.3e}, p99 "
            f"{np.percentile(rel, 99):.3e}, {int((rel > rtol).sum())} rows "
            f"above the JAX package's {rtol:g}; tables "
            f"{table_bytes['float32'] / table_bytes[dtype]:.2f}x below f32")
        assert worst <= 1.0, (dtype, worst)
    return f32


def serve_http_phase(run, records, want, device="cuda"):
    """(c) ``serve_game``'s server on port 0: HTTP_THREADS clients of at
    least HTTP_REQUESTS single-record POSTs each over loopback; a /reload
    of the same directory once a quarter of them are answered, the
    clients going on until it has answered."""
    import http.client
    import threading

    from photon_ml_tpu_torch.cli import serve_game
    from photon_ml_tpu_torch.telemetry import metrics

    n = HTTP_THREADS * HTTP_REQUESTS
    assert len(records) >= n
    t0 = time.perf_counter()
    server = serve_game.build_server([
        "--model-dir", run, "--feature-shards", E2E_SHARDS, "--port", "0",
        "--microbatch", str(HTTP_MICROBATCH), "--device", device]).start()
    log(f"[10c] serve_game on {server.url}: up in "
        f"{time.perf_counter() - t0:.2f} s")
    host, port = server.url.rsplit("/", 1)[1].split(":")
    stage_hist = metrics.default_registry().get("photon_serving_stage_seconds")
    stages = ("parse", "queue_wait", "batch_assemble", "execute", "respond")
    before = {st: stage_hist.labels(stage=st).snapshot()[1:]
              for st in stages}
    replies = [[] for _ in range(HTTP_THREADS)]  # (record, score, seconds)
    failures, versions, answered = [], set(), [0]
    lock = threading.Lock()
    reload_at, reloaded = threading.Event(), threading.Event()

    def client(t):
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        try:
            k = 0
            while k < HTTP_REQUESTS or not reloaded.is_set():
                i = t * HTTP_REQUESTS + k % HTTP_REQUESTS
                k += 1
                body = json.dumps({"record": records[i]})
                t1 = time.perf_counter()
                conn.request("POST", "/score", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = json.loads(resp.read())
                seconds = time.perf_counter() - t1
                if resp.status != 200:
                    failures.append((i, resp.status, data))
                    break
                replies[t].append((i, data["scores"][0], seconds))
                with lock:
                    versions.add(data["version"])
                    answered[0] += 1
                    if answered[0] == n // 4:
                        reload_at.set()
        except Exception as e:  # a failed request fails the phase
            failures.append((t, repr(e)))
        finally:
            conn.close()

    reload_out = {}

    def reloader():
        try:
            if not reload_at.wait(300):
                return
            conn = http.client.HTTPConnection(host, int(port), timeout=300)
            try:
                t1 = time.perf_counter()
                conn.request("POST", "/reload", "{}",
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                reload_out.update(status=resp.status,
                                  body=json.loads(resp.read()),
                                  seconds=time.perf_counter() - t1)
            finally:
                conn.close()
        finally:
            reloaded.set()

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(HTTP_THREADS)]
    threads.append(threading.Thread(target=reloader))
    try:
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        n_batches = server.service.batcher.n_batches
        health = server.service.healthz()
    finally:
        server.stop()
    assert not any(th.is_alive() for th in threads)
    done = [r for rs in replies for r in rs]
    latency = np.array([sec for _, _, sec in done])
    p50, p99 = (1e3 * float(np.percentile(latency, q)) for q in (50, 99))
    log(f"  {len(done)} requests ({HTTP_THREADS} threads, at least "
        f"{HTTP_REQUESTS} each) in {wall:.2f} s ({len(done) / wall:.0f}/s); "
        f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms; microbatcher "
        f"{n_batches} batches, mean {len(done) / max(n_batches, 1):.2f} "
        f"requests a batch; reload {reload_out.get('status')} in "
        f"{reload_out.get('seconds', 0):.2f} s (versions served "
        f"{sorted(versions)}); captures {health['compiles']}")
    parts = []
    for st in stages:
        s0, c0 = before[st]
        _, s1, c1 = stage_hist.labels(stage=st).snapshot()
        parts.append(f"{st} {1e3 * (s1 - s0) / max(c1 - c0, 1):.3f} ms "
                     f"x {c1 - c0}")
    log(f"  stages (mean ms x count; batch_assemble and execute a batch, "
        f"the rest a request): {', '.join(parts)}")
    assert not failures, failures[:5]
    assert reload_out.get("status") == 200, reload_out
    assert versions == {1, 2}, versions
    mismatch = sum(np.float32(score) != want[i] for i, score, _ in done)
    log(f"  replies vs the engine's f32 scores: {mismatch} of {len(done)} "
        f"differ")
    assert mismatch == 0, mismatch
    assert len(done) >= n and health["compiles"] == ENGINE_CAPTURES, health


def run_scoring_phase(e2e_run, device="cuda"):
    """Phase 10 on phase 8's best/ and validation file."""
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    t_start = time.perf_counter()
    batch = score_batch_phase(e2e_run["run"], e2e_run["valid"],
                              e2e_run["auc"], device)
    records = []
    for rec in iter_avro_file(e2e_run["valid"]):
        records.append(rec)
        if len(records) == ENGINE_RECORDS:
            break
    f32 = serve_engine_phase(e2e_run["run"], records,
                             batch[:ENGINE_RECORDS], device)
    serve_http_phase(e2e_run["run"], records, f32, device)
    log(f"[10] done in {time.perf_counter() - t_start:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import photon_ml_tpu_torch.game as tg
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch import glm
    from photon_ml_tpu_torch.convert import glm_data_from_arrays
    from photon_ml_tpu_torch.ops import cuda_build, fused_glm, fused_hvp
    from photon_ml_tpu_torch.ops import fused_re
    from photon_ml_tpu_torch.ops import losses as tl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    report = cuda_build.build(["fused_glm", "fused_re", "fused_hvp",
                               "fused_glm_multi"])
    log(f"[1] built kernels in {time.perf_counter() - t0:.2f} s "
        + ", ".join(f"{k}: {'cached' if v['cached'] else 'nvcc'}"
                    for k, v in report.items()))

    # data and datasets of the main path (host bucketing) ------------------
    t0 = time.perf_counter()
    train, valid = make_e2e(tg, **E2E)
    log(f"[3] generated e2e data ({E2E}) in {time.perf_counter() - t0:.1f} s")
    est = e2e_estimator(tg, "cuda", E2E_MAX_ITER)
    t0 = time.perf_counter()
    datasets = est.prepare(train)
    log(f"[3] built coordinate datasets in {time.perf_counter() - t0:.1f} s")
    shapes = []
    for cid in ("perUser", "perSong"):
        ds = datasets[cid]
        sh = [b.tensor_shape for b in ds.buckets]
        shapes += sh
        log(f"  {cid}: {ds.n_active_entities} entities, buckets {sh}")

    # 2. kernels vs plain versions -----------------------------------------
    losses = [tl.LogisticLoss, tl.SquaredLoss, tl.PoissonLoss,
              tl.SmoothedHingeLoss]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    t0 = time.perf_counter()
    err1 = check_glm(fused_glm, losses, GLM_CHECK_SHAPES, gen)
    # kernel 1's other bodies draw from their own generator, as the plan
    # paths below do
    err1 = max(err1, check_glm(
        fused_glm, losses, GLM_BODY_SHAPES,
        torch.Generator(device="cuda").manual_seed(8765)))
    e_ragged = shapes[-1][0] + 3 if shapes else 11
    # a ragged E, and rows too wide for 8 row groups' shared memory
    err2 = check_re(fused_re, losses, sorted(set(shapes))
                    + [(e_ragged, 37, 5), (3, 40, 8192)], gen)
    # the plan paths draw from their own generator, so the shared one
    # reaches phase 5 in the same state as before they were added (kernel
    # 3's readings stay comparable from run to run)
    err2 = max(err2, check_re(fused_re, losses, RE_PLAN_SHAPES,
                              torch.Generator(device="cuda").manual_seed(4321)))
    log(f"[2] kernels agree with their plain versions (rtol "
        f"{KERNEL_RTOL}): worst relative error kernel1 {err1:.2e}, kernel2 "
        f"{err2:.2e} ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # 3. the main path -----------------------------------------------------
    evaluators = parse_evaluators(["AUC"])
    fused_glm.fused_value_and_grad.launches = 0
    fused_re.fused_entity_value_and_grad.launches = 0
    t0 = time.perf_counter()
    result = est.fit(train, [tg.GameOptimizationConfiguration(E2E_LAMBDAS)],
                     validation=(valid, evaluators), datasets=datasets)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"fused_glm": fused_glm.fused_value_and_grad.launches,
                "fused_re": fused_re.fused_entity_value_and_grad.launches}
    auc = result.evaluation.primary[1]
    log(f"[3] GameEstimator.fit (1 sweep, maxIter={E2E_MAX_ITER}, bf16, "
        f"lambda {E2E_LAMBDAS}) in {fit_s:.2f} s; validation AUC {auc:.6f}")
    for sweep, cid, sec in result.step_seconds:
        log(f"  sweep {sweep} {cid}: {sec:.3f} s")
    log(f"  launches: {launches}")
    assert launches["fused_glm"] > 0 and launches["fused_re"] > 0, launches
    for cid, m in result.model.coordinates.items():
        c = (m.model.coefficients.means.cpu().numpy()
             if isinstance(m, tg.FixedEffectModel) else m.coeffs)
        assert c.size and np.all(np.isfinite(c)), cid
    fe_only = e2e_estimator(tg, "cuda", E2E_MAX_ITER, ("global",)).fit(
        train, [tg.GameOptimizationConfiguration(E2E_LAMBDAS)],
        validation=(valid, evaluators),
        datasets={"global": datasets["global"]})[0]
    auc_fe = fe_only.evaluation.primary[1]
    log(f"  fixed-effect-only AUC {auc_fe:.6f}")
    assert auc > auc_fe + 0.01, (auc, auc_fe)

    # the main path once more under the profiler: device time by kernel and
    # by coordinate / bucket range, and the device's busy share
    profile_fit(lambda: est.fit(
        train, [tg.GameOptimizationConfiguration(E2E_LAMBDAS)],
        validation=(valid, evaluators), datasets=datasets), fit_s)

    # kernel times at the main path's shapes -------------------------------
    ds = datasets["global"]
    w_game = 0.01 * torch.ones(ds.design.x.shape[1], device="cuda")
    t1 = time_glm(fused_glm, tl.LogisticLoss, ds.design.x, w_game,
                  ds.labels, ds.weights)
    # kernel 3 at the fixed effect's shape, as TRON would run it there (its
    # direction from a generator of its own: the shared one keeps its state)
    t3_game = time_hvp(fused_hvp, ds.design.x, w_game, tl.LogisticLoss,
                       ds.labels, torch.Generator(device="cuda").manual_seed(
                           2468))
    del ds
    buckets = [st for key, st in
               sorted(((k, v) for cid in ("perUser", "perSong")
                       for k, v in datasets[cid]._device_cache.items()),
                      key=lambda kv: str(kv[0]))]
    t2 = time_re(fused_re, tl.LogisticLoss, buckets)
    del datasets, train, valid, result, fe_only, buckets
    torch.cuda.empty_cache()

    # 4. card vs CPU -------------------------------------------------------
    small, small_valid = make_e2e(tg, **SMALL)
    reach = compare_bucket_solves(tg, small, E2E_LAMBDAS["perUser"])
    fits = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fits[device] = e2e_estimator(tg, device, SMALL_MAX_ITER).fit(
            small, [tg.GameOptimizationConfiguration(E2E_LAMBDAS)],
            validation=(small_valid, evaluators))[0]
        log(f"[4] {SMALL['rows']}-row fit on {device} (maxIter="
            f"{SMALL_MAX_ITER}) in {time.perf_counter() - t0:.2f} s, AUC "
            f"{fits[device].evaluation.primary[1]:.6f}")
    gpu, cpu = fits["cuda"].model, fits["cpu"].model
    # the whole fit: lanes end anywhere within `reach` of their optimum (the
    # solves above), and each coordinate's residual offsets carry the
    # earlier coordinates' such differences — so 2 x reach, absolute
    atol = 2.0 * reach
    for cid in gpu.coordinates:
        a, b = gpu.coordinates[cid], cpu.coordinates[cid]
        if isinstance(a, tg.FixedEffectModel):
            ca = a.model.coefficients.means.cpu().numpy()
            cb = b.model.coefficients.means.numpy()
        else:
            assert np.array_equal(a.keys, b.keys), cid
            ca, cb = a.coeffs, b.coeffs
        diff = float(np.abs(ca - cb).max())
        log(f"  {cid}: max |cuda - cpu| coefficient = {diff:.3e} (limit "
            f"{atol:.3e})")
        assert diff <= atol, (cid, diff, atol)
    d_auc = abs(fits["cuda"].evaluation.primary[1]
                - fits["cpu"].evaluation.primary[1])
    log(f"  |AUC cuda - AUC cpu| = {d_auc:.2e}")
    # a few of the 5k validation rows may swap ranks
    assert d_auc < 1e-4, d_auc
    del small, small_valid, fits, gpu, cpu
    log(f"[1-4] done at {time.perf_counter() - t_start:.1f} s")

    # 5. kernels 3 and 4 vs plain versions ----------------------------------
    t0 = time.perf_counter()
    err3 = check_hvp(fused_hvp, HVP_CHECK_SHAPES, gen)
    # kernel 3's other bodies draw from their own generator, so kernel 4's
    # cases below keep their seeded draws
    err3b = check_hvp(fused_hvp, HVP_BODY_SHAPES + [
        (3_001, cuda_build.MAX_ROW_WIDTH, (torch.float32,))],
        torch.Generator(device="cuda").manual_seed(5678))
    err3 = {dt: max(err3[dt], err3b[dt]) for dt in err3}
    err4 = check_multi(fused_glm, cuda_build, losses, gen)
    time_one_lane(fused_glm, tl.LogisticLoss, gen)
    log(f"[5] kernels 3 and 4 agree with their plain versions: worst "
        f"relative error kernel3 f32 {err3[torch.float32]:.2e} bf16 "
        f"{err3[torch.bfloat16]:.2e}; kernel4 f32 {err4[torch.float32]:.2e} "
        f"bf16 {err4[torch.bfloat16]:.2e} (rtol {KERNEL_RTOL} f32, "
        f"{BF16_RTOL} bf16); kernel4 vs kernel1 f32 "
        f"{err4['kernel1', torch.float32]:.2e} bf16 "
        f"{err4['kernel1', torch.bfloat16]:.2e} (rtol {KERNEL_RTOL} f32, "
        f"{K4_VS_K1_BF16_RTOL} bf16) "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # 6. the GLM path at full width ----------------------------------------
    t0 = time.perf_counter()
    (x_tr, y_tr), (x_va, y_va) = make_glm(**GLM)
    train = glm_data_from_arrays(x_tr, y_tr)
    valid = glm_data_from_arrays(x_va, y_va)
    del x_tr, x_va
    log(f"[6] generated the GLM data ({GLM}) in "
        f"{time.perf_counter() - t0:.1f} s")
    glm_runs = run_sweeps(train, valid, glm_sweeps())
    grads = {}
    for name, (trained, best, sec, n_launch) in glm_runs.items():
        log(f"[6] {name}:")
        log_sweep(name, trained, best, sec, n_launch)
        for tm in trained:
            c = tm.model.coefficients.means
            assert c.shape == (GLM["dim"],) and bool(torch.isfinite(c).all())
            assert tm.evaluation.primary[1] > 0.5, (name, tm.evaluation)
        grads[name] = check_gradients(name, train, trained)
    glm_launches = {k: v[3] for k, v in glm_runs.items()}
    assert glm_launches["tron"]["fused_glm"] > 0, glm_launches
    assert glm_launches["tron"]["fused_hvp"] > 0, glm_launches
    assert glm_launches["batched"]["fused_glm_multi"] > 0, glm_launches
    hold_to_bound("TRON vs batched L-BFGS", glm_runs["tron"][0],
                  glm_runs["batched"][0], grads["tron"], grads["batched"])

    # kernel times at the GLM path's shape, and their share of each sweep
    x = train.design.x
    w_mid = glm_runs["tron"][0][2].model.coefficients.means
    t1_glm = time_glm(fused_glm, tl.LogisticLoss, x, w_mid, train.labels,
                      torch.ones(x.shape[0], device="cuda"))
    t3 = time_hvp(fused_hvp, x, w_mid, tl.LogisticLoss, train.labels, gen)
    ws = torch.stack(
        [tm.model.coefficients.means for tm in glm_runs["batched"][0]])
    t4 = time_multi(fused_glm, x, ws, tl.LogisticLoss, train.labels)
    time_multi(fused_glm, x.to(torch.bfloat16), ws, tl.LogisticLoss,
               train.labels)
    for name, parts in (("tron", (("fused_glm", t1_glm["ms"]),
                                  ("fused_hvp", t3["ms"]))),
                        ("batched", (("fused_glm_multi", t4["ms"]),))):
        kern_s = sum(glm_launches[name][k] * ms for k, ms in parts) / 1e3
        sec = glm_runs[name][2]
        log(f"  {name} sweep: {sec:.3f} s wall, ~{kern_s:.3f} s of it in "
            f"its kernels (launches x time per launch, "
            f"{100 * kern_s / sec:.1f} %)")
    phase6 = {name: (trained[best].regularization_weight,
                     trained[best].evaluation.primary[1])
              for name, (trained, best, _, _) in glm_runs.items()}
    del train, valid, glm_runs, x
    torch.cuda.empty_cache()

    # 7. the GLM sweeps, card vs CPU ----------------------------------------
    # at a tolerance that f32 solves reach: with values ~1.3e4 (an f32 ulp
    # of ~1e-3) TRON's reduction test stalls long before |grad f| reaches
    # 1e-6 of its start, so at phase 6's tolerance no lambda converges and
    # the AUC check below would hold none
    (x_tr, y_tr), (x_va, y_va) = make_glm(**GLM_SMALL, seed=1)
    runs, stats, datas = {}, {}, {}
    sweeps = glm_sweeps(GLM_SMALL_TOLERANCE, batched_tron=True)
    for device in ("cuda", "cpu"):
        datas[device] = glm_data_from_arrays(x_tr, y_tr, device=device)
        t0 = time.perf_counter()
        runs[device] = run_sweeps(
            datas[device], glm_data_from_arrays(x_va, y_va, device=device),
            sweeps)
        log(f"[7] {GLM_SMALL['rows']}x{GLM_SMALL['dim']} sweeps on {device} "
            f"(tolerance {GLM_SMALL_TOLERANCE:g}) in "
            f"{time.perf_counter() - t0:.2f} s")
        for name, (trained, best, sec, n_launch) in runs[device].items():
            log_sweep(f"{device} {name}", trained, best, sec, n_launch)
            stats[device, name] = check_gradients(
                f"{device} {name}", datas[device], trained)
    bt = runs["cuda"]["batched_tron"][3]
    assert bt["fused_glm_multi"] > 0 and bt["fused_hvp"] > 0, bt
    assert runs["cuda"]["tron"][3]["fused_glm"] > 0, runs["cuda"]["tron"][3]
    # kernel 1 at the TRON sweep's shape here, and kernel 3 at batched
    # TRON's, where it launches most
    t1_small = time_glm(fused_glm, tl.LogisticLoss, datas["cuda"].design.x,
                        runs["cuda"]["tron"][0][2].model.coefficients.means,
                        datas["cuda"].labels,
                        torch.ones(GLM_SMALL["rows"], device="cuda"))
    t3_small = time_hvp(fused_hvp, datas["cuda"].design.x,
                        runs["cuda"]["batched_tron"][0][2].model.coefficients
                        .means, tl.LogisticLoss, datas["cuda"].labels, gen)
    worst_f, n_auc, bad = 0.0, 0, []
    for name, _, _ in sweeps:
        hold_to_bound(f"{name} cuda vs cpu", runs["cuda"][name][0],
                      runs["cpu"][name][0], stats["cuda", name],
                      stats["cpu", name])
        for a, b, (fa, _), (fb, _) in zip(
                runs["cuda"][name][0], runs["cpu"][name][0],
                stats["cuda", name], stats["cpu", name]):
            rel_f = abs(fa - fb) / abs(fb)
            worst_f = max(worst_f, rel_f)
            d_auc = abs(a.evaluation.primary[1] - b.evaluation.primary[1])
            both = bool(a.result.converged) and bool(b.result.converged)
            n_auc += both
            log(f"    lambda={a.regularization_weight:g}: converged "
                f"{bool(a.result.converged)}/{bool(b.result.converged)}; f64 "
                f"f(w) relative |cuda - cpu| {rel_f:.3e} (limit "
                f"{OBJECTIVE_RTOL[both]:g}); |AUC cuda - AUC cpu| {d_auc:.2e}"
                + (" (limit 1e-4)" if both else " (not held)"))
            if rel_f > OBJECTIVE_RTOL[both] or (both and d_auc > 1e-4):
                bad.append((name, a.regularization_weight, rel_f, d_auc))
    log(f"[7] card vs CPU: f64 objectives within {worst_f:.3e} relative; "
        f"AUC held to 1e-4 at the {n_auc} lambdas where both devices "
        "converged")
    assert not bad, bad
    assert n_auc > 0, "no lambda converged on both devices"
    # SIMPLE variances at one point, the CPU's TRON solution at lambda 1
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.types import VarianceComputationType

    problem = glm.OptimizationProblem(
        GLMObjective(tl.LogisticLoss), dataclasses.replace(
            glm_configs()[0],
            variance_type=VarianceComputationType.SIMPLE))
    w_cpu = runs["cpu"]["tron"][0][2].model.coefficients.means
    var = {dev: problem.compute_variances(w_cpu.to(dev), datas[dev],
                                          GLM_LAMBDAS[2]).cpu()
           for dev in ("cuda", "cpu")}
    rel_var = float(((var["cuda"] - var["cpu"]).abs()
                     / var["cpu"].abs()).max())
    log(f"  SIMPLE variances at lambda={GLM_LAMBDAS[2]:g}: max relative "
        f"|cuda - cpu| {rel_var:.2e}")
    assert rel_var <= 1e-4, rel_var
    del datas, problem, var
    torch.cuda.empty_cache()

    e2e_tmp = tempfile.mkdtemp(prefix="chip_smoke_e2e_")
    try:
        # 8. the e2e CLI, Avro in and model directory out -------------------
        cli_launches, e2e_run = run_cli_phase(tg, fused_glm, fused_re, auc,
                                              auc_fe, e2e_tmp)

        # 9. the GLM command, Avro in and model directory out ---------------
        t0 = time.perf_counter()
        glm_cli = run_glm_cli_phase(fused_glm, fused_hvp, fused_re, phase6)
        log(f"[9] done in {time.perf_counter() - t0:.1f} s")

        # 10. scoring phase 8's model: batch, engine, HTTP ------------------
        run_scoring_phase(e2e_run)
    finally:
        shutil.rmtree(e2e_tmp, ignore_errors=True)

    def train_glm_launches(kernel):
        return {name: n[kernel] for name, n in glm_cli.items()}

    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [
        dict(name="fused_value_and_grad", route="cuda", status="ported",
             source="photon_ml_tpu_torch/csrc/fused_glm.cu",
             replaces="photon_ml_tpu/ops/pallas_glm.py:118",
             launches=launches["fused_glm"], **t1,
             e2e_cli=dict(launches=cli_launches["fused_glm"]),
             train_glm=dict(launches=train_glm_launches("fused_glm")),
             glm_path=dict(launches=glm_launches["tron"]["fused_glm"],
                           **t1_glm),
             glm_small=dict(launches=runs["cuda"]["tron"][3]["fused_glm"],
                            **t1_small)),
        dict(name="fused_entity_value_and_grad", route="cuda",
             status="ported",
             source="photon_ml_tpu_torch/csrc/fused_re.cu",
             replaces="photon_ml_tpu/ops/pallas_re.py:130",
             launches=launches["fused_re"], **t2,
             e2e_cli=dict(launches=cli_launches["fused_re"]),
             train_glm=dict(launches=train_glm_launches("fused_re"))),
        dict(name="fused_hvp", route="cuda", status="redesigned",
             source="photon_ml_tpu_torch/csrc/fused_hvp.cu",
             replaces="photon_ml_tpu/ops/pallas_glm.py:447",
             launches=glm_launches["tron"]["fused_hvp"], **t3,
             batched_tron=dict(launches=bt["fused_hvp"], **t3_small),
             game_shape=t3_game,
             train_glm=dict(launches=train_glm_launches("fused_hvp"))),
        dict(name="fused_value_and_grad_multi", route="cuda",
             status="ported",
             source="photon_ml_tpu_torch/csrc/fused_glm_multi.cu",
             replaces="photon_ml_tpu/ops/pallas_glm.py:301",
             launches=glm_launches["batched"]["fused_glm_multi"], **t4,
             train_glm=dict(launches=train_glm_launches("fused_glm_multi"))),
    ]
    for k in kernels:
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err"):
            assert math.isfinite(k[key]), (k["name"], key)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
