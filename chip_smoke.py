"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. build the port's CUDA kernels from ``photon_ml_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once);
2. hold each kernel against its plain PyTorch version on the card — kernel 1
   (fixed-effect value+gradient) at 1M x 33 in bf16 and f32, a ragged n and
   d = 1024; kernel 2 (random-effect buckets) at every bucket shape of the
   end-to-end data plus a ragged E; all four losses, weight-0 rows, and
   bit-identical reruns — and time kernel, plain version and the two-pass
   PyTorch closed form beside the bound (bytes / 3.35 TB/s);
3. the main path: ``GameEstimator(device="cuda").fit`` of the end-to-end
   GLMix configuration (fixed effect ``global`` on 32 features + intercept,
   random effects ``perUser`` (40k users) and ``perSong`` (15k songs) on the
   8-wide ``item`` shard, Zipf-skewed entities, 1M rows, bf16 designs, L2
   with lambda 0.001/1/1, L-BFGS, histogram buckets, one sweep), with the
   kernels' launch counts read around it; the GAME model must beat a
   fixed-effect-only model on a held-out draw;
4. the same fit at 20k rows on the card (kernels) and on the CPU (plain
   versions), which must agree.

Any failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it the ``kernels``
summary. Data and coefficients are random, made from fixed seeds.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
#: kernel vs plain version: both sum the same f32 products, in another order
KERNEL_RTOL = 1e-5
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


def bound_ms(n_live, n_rows, d, itemsize, n_out):
    """Least time for one evaluation: X's live rows and their label and
    offset read once, every row's weight read once, w read and the outputs
    written once — over the HBM rate; or ~4 f32 operations per element of
    the live rows plus ~10 per live row for the loss, over the f32 rate —
    whichever is larger."""
    nbytes = (n_live * d * itemsize + n_live * 8 + n_rows * 4
              + n_out * d * 4 + n_out * (d + 1) * 4)
    ops = 4.0 * n_live * d + 10.0 * n_live
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def check_glm(fused_glm, losses, gen):
    """Kernel 1 vs its plain version; returns the largest relative error
    (:func:`_max_err`)."""
    worst = 0.0
    for n, d, dtypes in [(1_000_000, 33, (torch.bfloat16, torch.float32)),
                         (1_000_003, 33, (torch.bfloat16,)),
                         (100_003, 1024, (torch.float32, torch.bfloat16)),
                         (20_011, 8192, (torch.float32,))]:
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
    largest relative error (:func:`_max_err`)."""
    worst = 0.0
    for e, s, d in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(e, s, d, device="cuda", generator=gen).to(dt)
            w = torch.randn(e, d, device="cuda", generator=gen) / math.sqrt(d)
            off = 0.1 * torch.randn(e, s, device="cuda", generator=gen)
            wt = (torch.rand(e, s, device="cuda", generator=gen) > 0.3).float()
            wt[0] = 0.0  # an all-dead entity
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
                assert float(got[0][0]) == 0.0 and not got[1][0].any()
                err, rel = _max_err(got, want)
                assert rel <= KERNEL_RTOL, (e, s, d, dt, loss.name, err, rel)
                worst = max(worst, rel)
            log(f"  kernel2 E={e} S={s} D={d} {str(dt)[6:]} 4 losses: "
                f"last max_abs_err={err:.3e} rel={rel:.2e}, rerun identical")
    return worst


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


def time_glm(fused_glm, loss, ds):
    """Kernel 1 at the main path's fixed-effect shape: the e2e design."""
    x = ds.design.x
    n, d = x.shape
    w = 0.01 * torch.ones(d, device="cuda")
    off = torch.zeros(n, device="cuda")
    args = (loss, x, w, ds.labels, off, ds.weights)
    err, rel = _max_err(fused_glm.fused_value_and_grad(*args),
                        fused_glm.fused_value_and_grad_plain(*args))
    assert rel <= KERNEL_RTOL, ("kernel1 on the e2e design", err, rel)
    ms = time_ms(lambda: fused_glm.fused_value_and_grad(*args))
    plain = time_ms(lambda: fused_glm.fused_value_and_grad_plain(*args))
    lib = time_ms(lambda: glm_closed_form_library(*args))
    n_live = int((ds.weights > 0).sum())
    b, by = bound_ms(n_live, n, d, x.element_size(), 1)
    log(f"  kernel1 {n}x{d} {str(x.dtype)[6:]}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, torch.mv closed form {lib:.4f} ms, bound "
        f"{b:.4f} ms ({by}); max_abs_err vs plain {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b, bound_by=by, shape=f"{n}x{d} {str(x.dtype)[6:]}")


def time_re(fused_re, loss, buckets):
    """Kernel 2 at every bucket of the main path (the e2e buckets of both
    random effects, as the solver uploads them): one evaluation of each,
    summed."""
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
        ms = time_ms(lambda: fused_re.fused_entity_value_and_grad(*args))
        plain = time_ms(lambda: fused_re.fused_entity_value_and_grad_plain(
            *args), reps=5)
        lib = time_ms(lambda: re_closed_form_library(*args), reps=5)
        n_live = int((st.weights > 0).sum())
        b, by = bound_ms(n_live, e * s, d, x.element_size(), e)
        if by == "operations":
            tot["bound_by"] = by
        log(f"  kernel2 E={e} S={s} D={d} live rows={n_live}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, torch.bmm closed form "
            f"{lib:.4f} ms, bound {b:.5f} ms ({by})")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", b)):
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
    starts = [e.time_range.start for e in work]
    import bisect

    for r in sorted(ranges, key=lambda e: e.name):
        lo = bisect.bisect_left(starts, r.time_range.start)
        hi = bisect.bisect_left(starts, r.time_range.end)
        inside = work[lo:hi]
        ms = sum(e.time_range.elapsed_us() for e in inside) / 1e3
        ent = sum(e.time_range.elapsed_us() for e in inside
                  if "entity_kernel" in e.name) / 1e3
        log(f"  range {r.name}: span {r.time_range.elapsed_us() / 1e3:.2f} "
            f"ms, device busy {ms:.2f} ms (kernel 2: {ent:.2f} ms) over "
            f"{len(inside)} device ops")


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import photon_ml_tpu_torch.game as tg
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.ops import cuda_build, fused_glm, fused_re
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
    report = cuda_build.build(["fused_glm", "fused_re"])
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
    err1 = check_glm(fused_glm, losses, gen)
    e_ragged = shapes[-1][0] + 3 if shapes else 11
    # a ragged E, and rows too wide for 8 row groups' shared memory
    err2 = check_re(fused_re, losses, sorted(set(shapes))
                    + [(e_ragged, 37, 5), (3, 40, 8192)], gen)
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
    t1 = time_glm(fused_glm, tl.LogisticLoss, datasets["global"])
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

    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [
        dict(name="fused_value_and_grad", route="cuda", status="ported",
             source="photon_ml_tpu_torch/csrc/fused_glm.cu",
             replaces="photon_ml_tpu/ops/pallas_glm.py:118",
             launches=launches["fused_glm"], **t1),
        dict(name="fused_entity_value_and_grad", route="cuda",
             status="ported",
             source="photon_ml_tpu_torch/csrc/fused_re.cu",
             replaces="photon_ml_tpu/ops/pallas_re.py:130",
             launches=launches["fused_re"], **t2),
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
