"""The port's training diagnostics (``photon_ml_tpu_torch.diagnostics`` and
``train_glm --training-diagnostics``) on the CPU at a tiny size, against
the JAX package's ``photon_ml_tpu.diagnostics`` on the same inputs.

Tolerances: Hosmer–Lemeshow within 1e-10 with the same bins; importance
within 1e-12; the bootstrap and the fitting curve, fed the JAX package's
own replicate weights and portion masks (the port draws from a
``torch.Generator`` and cannot reproduce ``jax.random``), at the f64
tolerance of tests/test_torch_glm_slice.py's sweeps (rtol = atol = 1e-8)
under L-BFGS and TRON; ``render_report`` byte-equal on equal reports. The
CLI runs both packages' ``train_glm --training-diagnostics`` in f32 on one
tiny Avro and compares ``report.html`` section by section: the
Hosmer–Lemeshow section byte-equal, the model summary equal but for each
solver's own iteration count, importance at the f32 coefficient tolerance
of tests/test_torch_glm_cli.py, and the bootstrap and fitting sections at
that tolerance once the JAX draws are injected. Also the port's own draws
(padding gets no count, each replicate's counts sum to n; portions are
nested prefixes of one permutation) and (B, n) lane weights through the
objective: one single-lane (kernel-1) call per lane, never kernel 4.
"""

import dataclasses
import html
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import diagnostics as jdiag
from photon_ml_tpu.glm.problem import OptimizationProblem as JProblem
from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.stat import FeatureDataStatistics as JStats
from photon_ml_tpu_torch import diagnostics as tdiag
from photon_ml_tpu_torch.cli import train_glm as t_cli
from photon_ml_tpu_torch.glm.problem import OptimizationProblem as TProblem
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops import objective as t_objective
from photon_ml_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.stat import FeatureDataStatistics as TStats
from test_torch_glm_cli import W_TOL as CLI_W_TOL
from test_torch_glm_cli import _jax_run, _write
from test_torch_glm_slice import W_TOL, _arrays, _configs, _data, _mask

HL_TOL = 1e-10
IMPORTANCE_TOL = 1e-12
B = 4


def _j_draws(n, key_boot=0, key_fit=7, weights=None):
    """The JAX package's replicate weights and portion masks (its
    ``bootstrap.py:57-71`` and ``fitting.py:59-62``) in the current x64
    mode."""
    w = jnp.ones(n) if weights is None else jnp.asarray(weights)
    rep = jdiag.bootstrap_weights(jax.random.PRNGKey(key_boot), w, B)
    rank = jnp.argsort(jax.random.uniform(jax.random.PRNGKey(key_fit),
                                          (n,))).argsort()
    fr = jnp.asarray(jdiag.fitting.DEFAULT_PORTIONS)
    keep = rank[None, :] < jnp.ceil(fr[:, None] * n)
    return np.asarray(rep), np.asarray(keep)


@pytest.mark.parametrize("n, n_bins", [(500, 10), (333, 10), (64, 5)])
def test_hosmer_lemeshow_matches_jax(n, n_bins):
    rng = np.random.default_rng(n)
    p = rng.uniform(size=n)
    y = (rng.uniform(size=n) < p).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=n)
    w[::9] = 0.0
    t = tdiag.hosmer_lemeshow(p, y, w, n_bins=n_bins)
    j = jdiag.hosmer_lemeshow(p, y, w, n_bins=n_bins)
    assert t.n_bins == j.n_bins == n_bins
    assert t.degrees_of_freedom == j.degrees_of_freedom
    assert np.array_equal(t.bin_counts, np.asarray(j.bin_counts))
    for name in ("observed_positives", "expected_positives",
                 "mean_predicted"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(j, name)),
                                   rtol=HL_TOL, atol=HL_TOL, err_msg=name)
    assert abs(t.chi_square - j.chi_square) <= HL_TOL * j.chi_square
    assert abs(t.p_value - j.p_value) <= HL_TOL
    assert t.well_calibrated() == j.well_calibrated()


def test_importance_matches_jax():
    rng = np.random.default_rng(3)
    d = 12
    fields = dict(mean=rng.normal(size=d), variance=rng.uniform(size=d),
                  min=-rng.uniform(size=d), max=rng.uniform(size=d),
                  max_magnitude=rng.uniform(size=d),
                  num_nonzeros=rng.integers(0, 50, size=d), count=50)
    coefs = rng.normal(size=d)
    names = [f"f{i}" for i in range(d)]
    for fn in ("expected_magnitude_importance", "variance_importance"):
        t = getattr(tdiag, fn)(torch.as_tensor(coefs), TStats(**fields),
                               names=names)
        j = getattr(jdiag, fn)(coefs, JStats(**fields), names=names)
        assert t.kind == j.kind
        assert np.array_equal(t.ranked_indices, j.ranked_indices)
        np.testing.assert_allclose(t.importance, j.importance,
                                   rtol=IMPORTANCE_TOL, atol=0)
        assert t.names == j.names and t.top(5) == j.top(5)


def _problems(optimizer):
    jcfg, tcfg = _configs(optimizer)
    jmask, tmask = _mask(6)
    return (JProblem(JObjective(jl.LogisticLoss, reg_mask=jmask), jcfg),
            TProblem(TObjective(tl.LogisticLoss, reg_mask=tmask), tcfg))


def _point(problem, td, lam):
    w0 = torch.zeros(td.dim, dtype=torch.float64)
    return problem.run(td, w0, lam).w[0]


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_bootstrap_matches_jax_on_its_draws(optimizer):
    x, y, off, wt = _arrays(n=120)
    jd, td = _data(x, y, off, wt)
    jp, tp = _problems(optimizer)
    lam = 1.0
    w_point = _point(tp, td, lam)
    rep, _ = _j_draws(len(y), weights=wt)
    j = jdiag.bootstrap_coefficients(jp, jd, jnp.asarray(w_point.numpy()),
                                     lam, n_replicates=B)
    t = tdiag.bootstrap_coefficients(tp, td, w_point, lam,
                                     replicate_weights=rep)
    assert t.n_replicates == j.n_replicates == B
    for name in ("coefficients", "mean", "std", "ci_lower", "ci_upper"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(j, name)),
                                   err_msg=name, **W_TOL)
    assert np.array_equal(t.sign_stability, j.sign_stability)
    assert np.array_equal(t.zero_crossing(), j.zero_crossing())


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_fitting_curve_matches_jax_on_its_masks(optimizer):
    x, y, off, wt = _arrays(n=120)
    jd, td = _data(x, y, off, wt)
    xv, yv, offv, wtv = _arrays(n=90, seed=1)
    jv, tv = _data(xv, yv, offv, wtv)
    jp, tp = _problems(optimizer)
    lam = 1.0
    w0 = _point(tp, td, lam)
    _, keep = _j_draws(len(y))
    j = jdiag.fitting_curve(jp, jd, jv, jnp.asarray(w0.numpy()), lam)
    t = tdiag.fitting_curve(tp, td, tv, w0, lam, masks=keep)
    assert np.array_equal(t.portions, j.portions)
    for name in ("coefficients", "train_objective", "validation_objective"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(j, name)),
                                   err_msg=name, **W_TOL)
    np.testing.assert_allclose(t.generalization_gap(),
                               j.generalization_gap(), **W_TOL)


def test_render_report_is_byte_equal():
    rng = np.random.default_rng(8)
    d = 7
    names = [f"x{i}" for i in range(d)]
    ws = rng.normal(size=(5, d))
    point = ws.mean(0)
    boot = dict(coefficients=ws, mean=ws.mean(0), std=ws.std(0, ddof=1),
                ci_lower=ws.min(0), ci_upper=ws.max(0),
                sign_stability=np.mean(np.sign(ws) == np.sign(point), 0),
                confidence_level=0.95, n_replicates=5)
    p = rng.uniform(size=200)
    y = (rng.uniform(size=200) < p).astype(float)
    hl = jdiag.hosmer_lemeshow(p, y)
    hl_fields = {f.name: getattr(hl, f.name)
                 for f in dataclasses.fields(hl)}
    imp = jdiag.variance_importance(ws[0], JStats(
        mean=np.zeros(d), variance=np.ones(d), min=-np.ones(d),
        max=np.ones(d), max_magnitude=np.ones(d),
        num_nonzeros=np.full(d, 3), count=9), names=names)
    imp_fields = {f.name: getattr(imp, f.name)
                  for f in dataclasses.fields(imp)}
    fit = dict(portions=np.array([0.25, 0.5, 0.75, 1.0]),
               train_objective=rng.uniform(size=4),
               validation_objective=rng.uniform(size=4),
               coefficients=ws[:4])
    summary = {"task": "LOGISTIC_REGRESSION", "best lambda": 1.0,
               "optimizer": "LBFGS", "iterations": 7, "converged": True}
    docs = []
    for mod in (jdiag, tdiag):
        docs.append(mod.render_report(
            summary,
            bootstrap=mod.BootstrapReport(**boot),
            hosmer_lemeshow=mod.HosmerLemeshowReport(**hl_fields),
            importance=[mod.FeatureImportanceReport(**imp_fields)],
            fitting=mod.FittingReport(**fit), feature_names=names))
    assert docs[0] == docs[1]
    assert tdiag.render_report(summary) == jdiag.render_report(summary)


def test_port_draws_hold_their_invariants():
    n = 50
    w = torch.ones(n, dtype=torch.float64)
    w[[3, 17, 40]] = 0.0
    g = torch.Generator().manual_seed(11)
    rep = tdiag.bootstrap_weights(w, 6, g)
    assert rep.shape == (6, n) and rep.dtype == w.dtype
    assert not rep[:, [3, 17, 40]].any()
    assert torch.equal(rep.sum(1), torch.full((6,), float(n),
                                              dtype=w.dtype))
    assert torch.equal(rep, rep.round())
    again = tdiag.bootstrap_weights(w, 6, torch.Generator().manual_seed(11))
    assert torch.equal(rep, again)
    # weights scale the counts
    half = tdiag.bootstrap_weights(w * 0.5, 6,
                                   torch.Generator().manual_seed(11))
    assert torch.equal(half, rep * 0.5)
    masks = tdiag.portion_masks(n, tdiag.DEFAULT_PORTIONS,
                                torch.Generator().manual_seed(2))
    assert masks.shape == (4, n)
    assert [int(m.sum()) for m in masks] == [13, 25, 38, 50]
    for a, b in zip(masks[:-1], masks[1:]):
        assert not (a & ~b).any()  # nested
    # one permutation: each portion adds the next shuffled positions
    added = [torch.nonzero(m).flatten().tolist() for m in masks]
    assert len({i for a in added for i in a}) == n
    assert torch.equal(masks, tdiag.portion_masks(
        n, tdiag.DEFAULT_PORTIONS, torch.Generator().manual_seed(2)))


def test_lane_weights_take_one_single_lane_call_each(monkeypatch):
    x, y, off, wt = _arrays(n=70)
    _, td = _data(x, y, off, wt)
    td = dataclasses.replace(td, design=dataclasses.replace(
        td.design, x=td.design.x.to(torch.float32)),
        labels=td.labels.float(), offsets=td.offsets.float(),
        weights=td.weights.float())
    obj = TObjective(loss=tl.LogisticLoss)
    rng = np.random.default_rng(4)
    lanes = torch.as_tensor(rng.poisson(1.0, size=(3, 70)),
                            dtype=torch.float32) * td.weights
    ws = torch.as_tensor(rng.normal(size=(3, 6)), dtype=torch.float32)
    calls = []
    real = t_objective.fused_value_and_grad

    def single(*a):
        calls.append(a[2].shape)
        return real(*a)

    def multi(*a):
        raise AssertionError("kernel 4 reached with per-lane weights")

    monkeypatch.setattr(t_objective, "fused_value_and_grad", single)
    monkeypatch.setattr(t_objective, "fused_value_and_grad_multi", multi)
    batched = dataclasses.replace(td, weights=lanes)
    values, grads = obj.value_and_grad(ws, batched, 0.5)
    assert calls == [(6,)] * 3
    hv = obj.hvp_operator(ws, batched, 0.5)(ws)
    for m in range(3):
        lane = dataclasses.replace(td, weights=lanes[m].contiguous())
        v, g = obj.value_and_grad(ws[m], lane, 0.5)
        torch.testing.assert_close(values[m], v, rtol=1e-6, atol=0)
        torch.testing.assert_close(grads[m], g, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(hv[m], obj.hvp(ws[m], ws[m], lane, 0.5),
                                   rtol=1e-6, atol=1e-6)


# --- the command -----------------------------------------------------------

def _sections(doc):
    return {s.split("</h2>")[0]: s for s in doc.split("<h2>")[1:]}


def _rows(section):
    """A section's table cells, as text, row by row (header dropped)."""
    rows = re.findall(r"<tr>(.*?)</tr>", section)[1:]
    return [[html.unescape(c) for c in re.findall(r"<td>(.*?)</td>", r)]
            for r in rows]


def _close_rows(t_rows, j_rows, key=0):
    """Rows matched by their first cell; numbers at the f32 coefficient
    tolerance, other cells equal."""
    jmap = {r[key]: r for r in j_rows}
    assert len(t_rows) == len(j_rows)
    for r in t_rows:
        other = jmap[r[key]]
        for a, b in zip(r, other):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            assert abs(fa - fb) <= CLI_W_TOL["atol"] + \
                CLI_W_TOL["rtol"] * abs(fb), (r, other)


def test_train_glm_diagnostics_matches_jax(tmp_path, monkeypatch):
    train = _write(str(tmp_path / "t.avro"), "LOGISTIC_REGRESSION", 300, 1)
    # n - 1 = 599 has no factor 2 or 5: no cut position at a tie
    valid = _write(str(tmp_path / "v.avro"), "LOGISTIC_REGRESSION", 600, 2)
    args = ["--training-data", train, "--validation-data", valid,
            "--regularization-weights", "10;1", "--training-diagnostics",
            "--diagnostic-bootstrap-replicates", str(B)]
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        rep, keep = _j_draws(300)
    finally:
        jax.config.update("jax_enable_x64", x64)
    seen = {}

    def boot(*a, **kw):
        seen["boot"] = kw.pop("n_replicates")
        return tdiag.bootstrap_coefficients(*a, replicate_weights=rep, **kw)

    def fit(*a, **kw):
        seen["fit"] = True
        return tdiag.fitting_curve(*a, masks=keep, **kw)

    monkeypatch.setattr(t_cli, "bootstrap_coefficients", boot)
    monkeypatch.setattr(t_cli, "fitting_curve", fit)
    t_res = t_cli.run(args + ["--output-dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    j_res = _jax_run(args + ["--output-dir", str(tmp_path / "jax")])
    assert seen == {"boot": B, "fit": True}
    assert t_res["diagnostics_report"] == os.path.join(
        str(tmp_path / "port"), "diagnostics", "report.html")
    docs = []
    for res in (t_res, j_res):
        with open(res["diagnostics_report"]) as f:
            docs.append(_sections(f.read()))
    t, j = docs
    assert list(t) == list(j) == [
        "Model", "Bootstrap coefficient confidence intervals",
        "Hosmer–Lemeshow calibration", "Feature importance — VARIANCE",
        "Feature importance — EXPECTED_MAGNITUDE", "Fitting curve"]
    assert t["Hosmer–Lemeshow calibration"] == \
        j["Hosmer–Lemeshow calibration"]
    t_sum = dict(_rows(t["Model"]))
    j_sum = dict(_rows(j["Model"]))
    assert t_sum.pop("iterations") and j_sum.pop("iterations")
    assert t_sum == j_sum
    for name in ("Feature importance — VARIANCE",
                 "Feature importance — EXPECTED_MAGNITUDE",
                 "Bootstrap coefficient confidence intervals"):
        _close_rows(_rows(t[name]), _rows(j[name]))
    _close_rows(_rows(t["Fitting curve"]), _rows(j["Fitting curve"]))
    # the stage follows the saves, and the validation file is read
    # without evaluators
    with open(tmp_path / "port" / "metrics.jsonl") as f:
        stages = [line.split('"stage": "')[1].split('"')[0] for line in f]
    assert stages[-2:] == ["diagnostics", "Diagnostics"]
    assert "Read validation data" in stages
