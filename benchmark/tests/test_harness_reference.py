"""Each driver's unit at a small size on the CPU (the kernels' plain
versions) against the plain reference, under the cells' own limits: the
program passes; the control (the program's bfloat16 designs) and each
fault a one-card cell can have fail. The result has the contract's keys.

The control and the faults are planted underneath the timed path, in the
program's optimizer, objective, estimator, selection and evaluator; the
rest of a run is the harness's, but for its look for a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import harness

#: the GAME cell keeps its rows per entity (~396 a user, ~5,250 a song):
#: with fewer, a summed objective gap is one small entity's float32 stall
SMALL = {
    "glmix_yahoo_music.fit": {"train_rows": 21000, "validation_rows": 2100,
                              "users": 53, "songs": 4},
    "glm_epsilon.tron": {"rows": 2000, "validation_rows": 500,
                         "features": 16},
    "glm_epsilon.lbfgs_batched": {"rows": 2000, "validation_rows": 500,
                                  "features": 16},
}
CELLS = sorted(SMALL)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(cell, seed=20260001, **overrides):
    result, _ = harness.run_cell(cell, seed, 0.01, False, "cpu",
                                 {**SMALL[cell], **overrides})
    return result


def _fault_unchanged(monkeypatch):
    """A solve that returns its starting point."""
    from photon_ml_tpu_torch.glm.problem import OptimizationProblem

    orig = OptimizationProblem.steps

    def steps(self, data, w0, lam=0.0):
        res = yield from orig(self, data, w0, lam)
        lanes = w0 if w0.dim() > 1 else w0[None, :]
        return dataclasses.replace(res, w=lanes.clone().to(res.w.dtype))

    monkeypatch.setattr(OptimizationProblem, "steps", steps)


def _halve(data):
    w = data.weights.clone()
    odd = torch.arange(w.shape[-1]) % 2 == 1
    w[..., odd] = 0.0
    w[..., ~odd] *= 2.0
    return dataclasses.replace(data, weights=w)


def _fault_half_batch(monkeypatch):
    """Every evaluation over half of its rows, scaled to their mean."""
    from photon_ml_tpu_torch.ops.objective import GLMObjective

    vg, hop = GLMObjective.value_and_grad, GLMObjective.hvp_operator
    monkeypatch.setattr(GLMObjective, "value_and_grad",
                        lambda self, w, data, l2=0.0:
                        vg(self, w, _halve(data), l2))
    monkeypatch.setattr(GLMObjective, "hvp_operator",
                        lambda self, w, data, l2=0.0:
                        hop(self, w, _halve(data), l2))


def _fault_altered(monkeypatch):
    """Each solve's answer altered by 1 % where it is produced."""
    from photon_ml_tpu_torch.glm.problem import OptimizationProblem

    orig = OptimizationProblem.steps

    def steps(self, data, w0, lam=0.0):
        res = yield from orig(self, data, w0, lam)
        return dataclasses.replace(res, w=res.w * 1.01)

    monkeypatch.setattr(OptimizationProblem, "steps", steps)


def _fault_auc(monkeypatch):
    """Every validation AUC raised by 0.001 where it is computed."""
    from photon_ml_tpu_torch.evaluation import evaluator

    orig = evaluator.area_under_roc_curve
    monkeypatch.setattr(evaluator, "area_under_roc_curve",
                        lambda *a, **k: orig(*a, **k) + 1e-3)


FAULTS = {"unchanged": _fault_unchanged, "half_batch": _fault_half_batch,
          "altered": _fault_altered, "auc_altered": _fault_auc}


def _fault_head_song(monkeypatch):
    """The fit's song with the most rows left at zero coefficients: the
    Zipf head, which the median song never sees."""
    from photon_ml_tpu_torch.game import GameEstimator

    orig = GameEstimator.fit

    def fit(self, data, *args, **kwargs):
        results = orig(self, data, *args, **kwargs)
        head = int(np.bincount(np.asarray(data.id_columns["songId"]))
                   .argmax())
        for r in results:
            m = r.model.coordinates["perSong"]
            other = np.asarray(m.keys) // m.dim != head
            r.model.coordinates["perSong"] = dataclasses.replace(
                m, coeffs=np.where(other, m.coeffs, 0).astype(np.float32),
                coeffs_device=None)
        return results

    monkeypatch.setattr(GameEstimator, "fit", fit)


def _fault_worst_selected(monkeypatch):
    """The selection returns the model with the worst validation AUC."""
    from photon_ml_tpu_torch import glm

    orig = glm.validate_and_select

    def select(trained, evaluators, validation, id_tags=None):
        _, evaluated = orig(trained, evaluators, validation, id_tags)
        worst = min(range(len(evaluated)),
                    key=lambda i: evaluated[i].evaluation.primary[1])
        return worst, evaluated

    monkeypatch.setattr(glm, "validate_and_select", select)


#: faults of one kind of cell: (cell, fault)
CELL_FAULTS = [("glmix_yahoo_music.fit", _fault_head_song),
               ("glm_epsilon.tron", _fault_worst_selected),
               ("glm_epsilon.lbfgs_batched", _fault_worst_selected)]


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(cell):
    result = run(cell)
    assert list(result) == KEYS
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_poses_one_problem(cell):
    """A run's seed flips feature signs only: the numbers compared repeat
    to the bit, so every seed gives the window the same work."""
    first, second = run(cell), run(cell, seed=3100000017)
    assert first["checks"] == second["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    result = run(cell, design_dtype="bfloat16")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS,
                         ids=[f"{c}-{f.__name__[7:]}" for c, f in CELL_FAULTS])
def test_cell_fault_fails(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(cell)
    assert not result["correct"], result["checks"]


def test_reference_auc_counts_pairs():
    from benchmark.reference.metrics import auc

    g = torch.Generator().manual_seed(7)
    s = torch.round(torch.randn(300, generator=g) * 3) / 3  # many ties
    y = (torch.rand(300, generator=g) < torch.sigmoid(s)).double()
    pos, neg = s[y == 1], s[y == 0]
    diff = pos[:, None] - neg[None, :]
    pairs = ((diff > 0).double() + 0.5 * (diff == 0).double()).mean()
    assert auc(s, y) == pytest.approx(float(pairs), abs=1e-12)
