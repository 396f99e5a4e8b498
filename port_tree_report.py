"""What one checkout of the PyTorch/CUDA port does on the card, in numbers
by which two checkouts (a commit and its parent, unpacked with ``git
archive``) can be compared on one machine:

    python3 port_tree_report.py --tree DIR [--out FILE.json]

- ``sass``: a hash of the SASS of every kernel in the libraries of all
  four kernels (``cuobjdump -sass``), by mangled name, so a change that
  must leave a kernel's compiled code alone can be checked;
- ``glm``: kernel 1 (``fused_value_and_grad``) at :data:`GLM_SHAPES`:
  the wrapper's time, its device time in a CUDA graph, and its
  ``torch.mv`` two-pass form, in turns (CUDA events), beside the bound;
- ``hvp``: kernel 3 (``fused_hvp``) at :data:`HVP_SHAPES`, the same
  readings;
- ``multi``: kernel 4 (``fused_value_and_grad_multi``) timed at
  :data:`MULTI_SHAPES`, with its ``torch.mm`` two-pass form, in turns
  (CUDA events);
- ``re_precision``: kernel 2's value and gradient at the two head-bucket
  shapes of the fit, against the plain version in f64 on the same bf16
  inputs (the error of the kernel's f32 sums), beside the plain version's
  own f32 error;
- ``fit``: the end-to-end GLMix fit of ``chip_smoke.py`` (its data,
  settings and λs): for every L-BFGS solve the calls to kernel 1 or 2, the
  lanes' iterations, how each lane stopped (converged, at the iteration
  cap, or earlier: a failed line search or two steps without decrease),
  the f64 sum of the lanes' objective values as the solver saw them (f32)
  and as the closed form computes them in f64 at the lanes' solutions;
  the fit's validation AUC and wall;
- ``k4_bf16_seeds`` (with ``--k4-bf16-seeds N``): bf16 kernel 4 against
  its plain version at the 1024-wide cases of ``chip_smoke.py``'s phase 5
  (100,003 rows, M in {1, 2, 5, 8, 9, 11, 16}, four losses) over N seeds:
  each reading relative to the gradient's scale, and its distribution
  against ``chip_smoke.BF16_RTOL``.

It imports ``photon_ml_tpu_torch`` from DIR, and the data, settings and
timing helpers from this checkout's ``chip_smoke.py``. Times of two trees
compare only when taken on one machine in one go: run them in turns (a,
b, b, a).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
#: (n, d, design dtype, lanes): the GLM path's shape in f32 and bf16, an
#: unaligned row (an intercept column), narrower designs (the 20k x 128 of
#: batched TRON among them), and the fixed-effect shape of the GAME path
MULTI_SHAPES = [(200_000, 1024, torch.float32, 5),
                (200_000, 1025, torch.float32, 5),
                (200_000, 1024, torch.bfloat16, 5),
                (200_000, 1025, torch.bfloat16, 5),
                (200_000, 256, torch.float32, 5),
                (200_000, 128, torch.float32, 5),
                (20_000, 128, torch.float32, 5),
                (1_000_000, 33, torch.float32, 5),
                (1_000_000, 33, torch.bfloat16, 5),
                (1_000_000, 33, torch.bfloat16, 1)]
#: (n, d, design dtype): kernel 1 at the GAME fixed effect's shape, a
#: ragged n of it, the GLM path's shape and a row streamed twice
GLM_SHAPES = [(1_000_000, 33, torch.bfloat16),
              (1_000_003, 33, torch.bfloat16),
              (200_000, 1024, torch.float32),
              (20_011, 8192, torch.float32)]
#: (n, d, design dtype): kernel 3 at the TRON sweep's shape, batched
#: TRON's, the GAME fixed effect's and a row streamed twice
HVP_SHAPES = [(200_000, 1024, torch.float32),
              (20_000, 128, torch.float32),
              (1_000_000, 33, torch.bfloat16),
              (20_011, 8192, torch.float32)]
#: bf16 kernel 4 vs its plain version: phase 5's 1024-wide cases
K4_SEED_ROWS, K4_SEED_WIDTH = 100_003, 1024
K4_SEED_LANES = (1, 2, 5, 8, 9, 11, 16)
#: kernel 2's head buckets in the e2e fit (E, S, D)
HEAD_BUCKETS = [(14, 89_281, 8), (10, 97_864, 8)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_hashes(cuda_build, names) -> dict:
    """{library: {kernel: sha256 of its SASS}}, or {library: error}; a
    kernel named by its mangled name without the anonymous namespace's
    id."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    out = {}
    for name in names:
        run = subprocess.run([str(tool), "-sass",
                              str(cuda_build.library_path(name))],
                             capture_output=True, text=True)
        if run.returncode != 0:
            out[name] = f"cuobjdump exit {run.returncode}"
            continue
        kernels = {}
        for part in run.stdout.split("Function : ")[1:]:
            fn, _, body = part.partition("\n")
            # the anonymous namespace's id follows the source's path, so it
            # differs between two checkouts of the same code
            fn = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", fn.strip())
            # the blank lines after a function's last instruction depend on
            # whether another function follows it in the listing
            kernels[fn] = hashlib.sha256(
                body.rstrip().encode()).hexdigest()[:16]
        out[name] = kernels
    return out


def multi_times(cs, fused_glm, tl) -> list:
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for n, d, dt, lanes in MULTI_SHAPES:
        x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
        ws = torch.randn(lanes, d, device="cuda", generator=gen) / d ** 0.5
        y = (torch.rand(n, device="cuda", generator=gen) < 0.5).float()
        off = torch.zeros(n, device="cuda")
        wt = torch.ones(n, device="cuda")
        args = (tl.LogisticLoss, x, ws, y, off, wt)
        t = cs.time_turns({
            "ms": lambda: fused_glm.fused_value_and_grad_multi(*args),
            "library_ms": lambda: cs.multi_library(*args)})
        rows.append(dict(shape=f"{n}x{d} {str(dt)[6:]} M={lanes}", **t))
        del x
    return rows


def glm_times(cs, fused_glm, tl) -> list:
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for n, d, dt in GLM_SHAPES:
        x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
        w = torch.randn(d, device="cuda", generator=gen) / d ** 0.5
        y = (torch.rand(n, device="cuda", generator=gen) < 0.5).float()
        off = torch.zeros(n, device="cuda")
        wt = torch.ones(n, device="cuda")
        args = (tl.LogisticLoss, x, w, y, off, wt)
        calls = 20
        t = cs.time_turns({
            "ms": lambda: fused_glm.fused_value_and_grad(*args),
            "device_ms": cs.captured(
                lambda: fused_glm.fused_value_and_grad(*args), calls),
            "library_ms": lambda: cs.glm_closed_form_library(*args)})
        t["device_ms"] /= calls
        b, _ = cs.bound_ms(n, n, d, x.element_size(), 1)
        rows.append(dict(shape=f"{n}x{d} {str(dt)[6:]}", bound_ms=b, **t))
        del x
    return rows


def hvp_times(cs, fused_hvp, tl) -> list:
    """Kernel 3 at :data:`HVP_SHAPES`: the curvature of a logistic design
    at random coefficients, a random direction; wrapper, device time in a
    CUDA graph and the torch.mv two-pass form in turns."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for n, d, dt in HVP_SHAPES:
        x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
        w = torch.randn(d, device="cuda", generator=gen) / d ** 0.5
        y = (torch.rand(n, device="cuda", generator=gen) < 0.5).float()
        d2w = tl.LogisticLoss.d2(x.float() @ w, y)
        v = torch.randn(d, device="cuda", generator=gen) / d ** 0.5
        calls = 20
        t = cs.time_turns({
            "ms": lambda: fused_hvp.fused_hvp(x, v, d2w),
            "device_ms": cs.captured(lambda: fused_hvp.fused_hvp(x, v, d2w),
                                     calls),
            "library_ms": lambda: cs.hvp_closed_form_library(x, v, d2w)})
        t["device_ms"] /= calls
        b, _ = cs.hvp_bound_ms(int((d2w != 0).sum()), n, d, x.element_size())
        rows.append(dict(shape=f"{n}x{d} {str(dt)[6:]}", bound_ms=b, **t))
        del x
    return rows


def k4_bf16_seeds(cs, fused_glm, tl, seeds) -> dict:
    """bf16 kernel 4 vs its plain version over ``seeds`` draws of phase 5's
    1024-wide cases (drawn as ``chip_smoke.check_multi`` draws them):
    every reading, the largest per seed, and how many exceed BF16_RTOL."""
    losses = [tl.LogisticLoss, tl.SquaredLoss, tl.PoissonLoss,
              tl.SmoothedHingeLoss]
    n, d = K4_SEED_ROWS, K4_SEED_WIDTH
    readings = []
    for seed in range(seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for lanes in K4_SEED_LANES:
            x = torch.randn(n, d, device="cuda", generator=gen).to(
                torch.bfloat16)
            ws = torch.randn(lanes, d, device="cuda", generator=gen) / d ** 0.5
            off = 0.1 * torch.randn(n, device="cuda", generator=gen)
            wt = torch.rand(n, device="cuda", generator=gen)
            wt[::9] = 0.0
            x[9] = 300.0
            for loss in losses:
                y = cs._labels(loss, (n,), gen)
                args = (loss, x, ws, y, off, wt)
                _, rel = cs._max_err(
                    fused_glm.fused_value_and_grad_multi(*args),
                    fused_glm.fused_value_and_grad_plain(*args))
                readings.append(dict(seed=seed, lanes=lanes, loss=loss.name,
                                     rel=rel))
            del x
    rels = sorted(r["rel"] for r in readings)
    per_seed = [max(r["rel"] for r in readings if r["seed"] == s)
                for s in range(seeds)]
    return dict(shape=f"{n}x{d} bfloat16", limit=cs.BF16_RTOL,
                n=len(rels), median=rels[len(rels) // 2],
                p99=rels[min(len(rels) - 1, int(0.99 * len(rels)))],
                max=rels[-1], per_seed_max=per_seed,
                over_limit=[r for r in readings if r["rel"] > cs.BF16_RTOL],
                readings=readings)


def re_precision(fused_re, tl) -> list:
    """Relative error of kernel 2's and the plain version's f32 value and
    gradient against the plain version in f64, per head bucket."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for e, s, d in HEAD_BUCKETS:
        x = torch.randn(e, s, d, device="cuda", generator=gen).to(
            torch.bfloat16)
        w = torch.randn(e, d, device="cuda", generator=gen) / d ** 0.5
        y = (torch.rand(e, s, device="cuda", generator=gen) < 0.5).float()
        off = 0.1 * torch.randn(e, s, device="cuda", generator=gen)
        wt = (torch.rand(e, s, device="cuda", generator=gen) > 0.1).float()
        args = (x, w, y, off, wt)
        exact = fused_re.fused_entity_value_and_grad_plain(
            tl.LogisticLoss, *(a.double() for a in args))
        row = dict(shape=[e, s, d])
        for name, fn in (
                ("kernel", fused_re.fused_entity_value_and_grad),
                ("plain", fused_re.fused_entity_value_and_grad_plain)):
            v, g = fn(tl.LogisticLoss, *args)
            row[name + "_value_rel"] = float(
                ((v.double() - exact[0]).abs() / exact[0].abs()).max())
            row[name + "_grad_rel"] = float(
                ((g.double() - exact[1]).abs().amax(-1)
                 / exact[1].abs().amax(-1)).max())
        rows.append(row)
    return rows


def fit_report(tg, cs, device, data) -> dict:
    """The e2e GLMix fit with every L-BFGS solve recorded."""
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.glm import problem as pm
    from photon_ml_tpu_torch.ops import fused_glm, fused_re
    from photon_ml_tpu_torch.ops.design import DenseDesign
    from photon_ml_tpu_torch.ops.objective import GLMData

    def f64_objective(problem, glm_data, w, lam):
        data = GLMData(design=DenseDesign(x=glm_data.design.x.double()),
                       labels=glm_data.labels.double(),
                       offsets=glm_data.offsets.double(),
                       weights=glm_data.weights.double())
        w = w.double()
        value, _ = problem.objective._closed_value_and_grad(
            w, data, problem._l2(lam, w))
        return float(value.sum())

    solves = []
    run = pm.OptimizationProblem.run

    def recorded(self, glm_data, w0, lam=0.0):
        calls = (fused_glm.fused_value_and_grad.launches,
                 fused_re.fused_entity_value_and_grad.launches)
        res = run(self, glm_data, w0, lam)
        cap = self.config.optimizer_config.max_iterations
        it = res.iterations.cpu()
        conv = res.converged.cpu()
        solves.append(dict(
            shape=list(glm_data.design.x.shape),
            calls=fused_glm.fused_value_and_grad.launches - calls[0]
            + fused_re.fused_entity_value_and_grad.launches - calls[1],
            lanes=int(it.numel()), iterations_max=int(it.max()),
            iterations_sum=int(it.sum()), converged=int(conv.sum()),
            at_cap=int(((~conv) & (it >= cap)).sum()),
            stopped_early=int(((~conv) & (it < cap)).sum()),
            objective=float(res.value.double().sum()),
            objective_f64=f64_objective(
                self, glm_data, res.w[0] if w0.dim() == 1 else res.w, lam)))
        return res

    pm.OptimizationProblem.run = recorded
    try:
        train, valid = cs.make_e2e(tg, **data)
        est = cs.e2e_estimator(tg, device, cs.E2E_MAX_ITER)
        datasets = est.prepare(train)
        t0 = time.perf_counter()
        result = est.fit(train, [tg.GameOptimizationConfiguration(
            cs.E2E_LAMBDAS)], validation=(valid, parse_evaluators(["AUC"])),
            datasets=datasets)[0]
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pm.OptimizationProblem.run = run
    return dict(auc=float(result.evaluation.primary[1]), wall_s=wall,
                calls=sum(s["calls"] for s in solves), solves=solves)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE),
                    help="checkout whose photon_ml_tpu_torch is measured")
    ap.add_argument("--out", help="also write the report here (JSON)")
    ap.add_argument("--k4-bf16-seeds", type=int, default=0, metavar="N",
                    help="also read bf16 kernel 4 against its plain version "
                         "over N seeds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_tree_report: no CUDA device is available",
              file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import photon_ml_tpu_torch.game as tg
    from photon_ml_tpu_torch.ops import cuda_build, fused_glm, fused_hvp
    from photon_ml_tpu_torch.ops import fused_re
    from photon_ml_tpu_torch.ops import losses as tl

    assert Path(tg.__file__).resolve().is_relative_to(tree), tg.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    names = ["fused_glm", "fused_re", "fused_hvp", "fused_glm_multi"]
    cuda_build.build(names)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report = dict(tree=str(tree), card=card,
                  sass=sass_hashes(cuda_build, names),
                  glm=glm_times(cs, fused_glm, tl),
                  hvp=hvp_times(cs, fused_hvp, tl),
                  fit=fit_report(tg, cs, "cuda", cs.E2E),
                  re_precision=re_precision(fused_re, tl),
                  multi=multi_times(cs, fused_glm, tl))
    if args.k4_bf16_seeds:
        report["k4_bf16_seeds"] = k4_bf16_seeds(cs, fused_glm, tl,
                                                args.k4_bf16_seeds)
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
