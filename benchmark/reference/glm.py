"""Plain reference of the GLM sweep cells, in float64 PyTorch on the device.

For each lambda ``λ``, the L2-regularised logistic objective
``F(w) = Σ_i loss(x_i·w, y_i) + λ/2 |w|²`` (no intercept, every
coefficient regularised), solved by Newton's method to float64 round-off
from the previous lambda's solution, lambdas descending.

It reads the benchmark's draws and nothing the program made; the
program's coefficients and the selected model's validation scores come in
only to be judged. Numbers, each the larger the worse:

- ``grad_rel``: the worst lambda's ``|∇F(w)| / |∇F(0)|`` at the program's
  coefficients;
- ``coef_gap``: the worst lambda's ``|w − w_ref| / |w_ref|``;
- ``score_gap``: the selected model's validation scores against the
  reference model's of the same lambda: the largest difference over the
  reference scores' root mean square;
- ``select_loss``: the validation AUC of the reference model that the
  reference selects (the best) less that of the reference model of the
  lambda that the program selected: 0 where both pick the same lambda;
- ``auc_gap``: the worst lambda's gap between the validation AUC that the
  program reported and the AUC of the reference model of that lambda;
- ``auc_own``: the same gap against the AUC of the program's own
  coefficients, scored by the reference (the program's scoring and AUC
  alone).

Read besides, not judged: ``auc_margin``, the reference's best AUC less
its second best (how near the selection is to a tie); ``grad_rel``,
``coef_gap`` (TRON) and ``auc_gap``, whose sound readings come within three
times of the control's (see PERF.md).
"""

from __future__ import annotations

import torch

from benchmark.reference.metrics import auc

F64 = torch.float64
#: rows per block of a pass over the design
BLOCK = 1 << 15
NEWTON_MAX = 50


def _blocks(n):
    return range(0, n, BLOCK)


class Problem:
    """The training rows ``x``, ``y`` (float32 as drawn) and the validation
    rows ``xv``, ``yv``; every pass converts a block to float64."""

    def __init__(self, x, y, xv, yv):
        self.x, self.y, self.xv, self.yv = x, y, xv, yv

    def _xb(self, lo):
        return self.x[lo:lo + BLOCK].to(F64)

    def grad(self, w, lam):
        g = lam * w
        for lo in _blocks(self.x.shape[0]):
            xb = self._xb(lo)
            p = torch.sigmoid(xb @ w)
            g = g + xb.T @ (p - self.y[lo:lo + BLOCK].to(F64))
        return g

    def newton(self, w, lam):
        d = self.x.shape[1]
        eye = torch.eye(d, dtype=F64, device=self.x.device)
        for _ in range(NEWTON_MAX):
            g, h = lam * w, lam * eye
            for lo in _blocks(self.x.shape[0]):
                xb = self._xb(lo)
                p = torch.sigmoid(xb @ w)
                g = g + xb.T @ (p - self.y[lo:lo + BLOCK].to(F64))
                h = h + xb.T @ ((p * (1.0 - p))[:, None] * xb)
            step = torch.linalg.solve(h, g)
            w = w - step
            if float(step.abs().max()) <= 1e-14 * (1.0
                                                   + float(w.abs().max())):
                break
        return w

    def solve_path(self, lambdas) -> list:
        """The reference solution of each lambda, in the order given
        (descending), each warm-started from the one before."""
        w = torch.zeros(self.x.shape[1], dtype=F64, device=self.x.device)
        out = []
        for lam in lambdas:
            w = self.newton(w, float(lam))
            out.append(w)
        return out

    def objective(self, w, lam):
        f = 0.5 * lam * float(w @ w)
        for lo in _blocks(self.x.shape[0]):
            m = self._xb(lo) @ w
            f += float((torch.nn.functional.softplus(m)
                        - self.y[lo:lo + BLOCK].to(F64) * m).sum())
        return f

    def scores(self, w):
        return torch.cat([self.xv[lo:lo + BLOCK].to(F64) @ w
                          for lo in _blocks(self.xv.shape[0])])

    def compare(self, fit: dict, ref: list) -> dict:
        dev = self.x.device
        zero = torch.zeros(self.x.shape[1], dtype=F64, device=dev)
        grad_rel = coef_gap = obj_gap = 0.0
        for lam, w, w_ref in zip(fit["lambdas"], fit["w"], ref):
            w = w.to(dev, F64)
            f_ref = self.objective(w_ref, float(lam))
            obj_gap = max(obj_gap,
                          (self.objective(w, float(lam)) - f_ref) / f_ref)
            g0 = torch.linalg.vector_norm(self.grad(zero, float(lam)))
            g = torch.linalg.vector_norm(self.grad(w, float(lam)))
            grad_rel = max(grad_rel, float(g / g0))
            coef_gap = max(coef_gap, float(torch.linalg.vector_norm(w - w_ref)
                                           / torch.linalg.vector_norm(w_ref)))
        s_ref = self.scores(ref[fit["best"]])
        s = fit["scores"].to(dev, F64)
        score_gap = float((s - s_ref).abs().max()
                          / torch.sqrt((s_ref * s_ref).mean()))
        ref_auc = [auc(self.scores(w_ref), self.yv) for w_ref in ref]
        own_auc = [auc(self.scores(w.to(dev, F64)), self.yv)
                   for w in fit["w"]]
        ranked = sorted(ref_auc, reverse=True)
        return {"grad_rel": grad_rel, "coef_gap": coef_gap,
                "score_gap": score_gap, "obj_gap": obj_gap,
                "select_loss": ranked[0] - ref_auc[fit["best"]],
                "auc_gap": max(abs(a - r) for a, r
                               in zip(fit["auc"], ref_auc)),
                "auc_own": max(abs(a - r) for a, r
                               in zip(fit["auc"], own_auc)),
                "auc_margin": ranked[0] - ranked[1] if len(ranked) > 1
                else 0.0}
