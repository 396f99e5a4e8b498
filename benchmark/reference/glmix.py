"""Plain reference of the GLMix cell, in float64 PyTorch on the device.

One coordinate-descent iteration of GAME logistic regression with L2:
the fixed effect ``w`` minimises ``Σ_i loss(x_i·w, y_i) + λ_g/2 |w|²``
over the global bag (with its intercept column, regularised like the
rest); then each user's ``v_u`` minimises ``Σ_{i of u} loss(o_i + z_i·v_u,
y_i) + λ_u/2 |v_u|²`` over the item bag with ``o_i = x_i·w``; then each
song's, with the users' margins added to the offsets. Each problem is
solved by Newton's method to float64 round-off.

It reads the benchmark's draws (the bags' columns and values, ids and
labels) and nothing the program made. The program's coefficients and its
reported validation AUC come in only to be judged: each coordinate is
held to its own problem given the
program's earlier coordinates, as the program's coordinate descent posed
it. Numbers, each the larger the worse:

- ``obj_gap.<coordinate>``: the objective at the program's coefficients
  over its optimum, less one;
- ``grad_med.<coordinate>`` (random effects): the median entity's
  gradient norm at the program's coefficients over its norm at zero (or
  the median entity's norm at zero, whichever is larger);
- ``coef_med.<coordinate>`` (random effects): the median entity's
  distance from its optimum over its optimum's norm (or the median
  entity's, whichever is larger);
- ``auc_gap``: the gap between the validation AUC that the program
  reported and the AUC of the reference's own model (each coordinate
  solved given the reference's earlier ones) on the validation rows;
- ``auc_own``: the same gap against the AUC of the program's
  coefficients, scored by the reference (the program's scoring and AUC
  alone);
- ``grad_rel.<coordinate>``: the worst entity's relative gradient (the
  fixed effect's: the gradient norms' ratio), with ``worst_rows`` its
  rows.

``grad_rel``, ``worst_rows``, ``obj_gap.global`` and ``auc_gap`` are read
for the calibration and not judged: their sound readings come within
three times of the control's (see PERF.md).

With ``control`` it also reads ``auc_own.control``: ``auc_own`` of the
reference put in the program's scoring place one precision lower (the
validation rows and the program's coefficients in bfloat16, products
summed in float32), the upper reading of ``auc_own``, since the program's
own bfloat16 path leaves its validation scoring in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from benchmark.reference.metrics import auc

F64 = torch.float64
#: rows per block of a pass over the data
BLOCK = 1 << 21
NEWTON_MAX = 50


def _sigmoid_terms(m, y):
    p = torch.sigmoid(m)
    return p - y, p * (1.0 - p)


def dense(cols: np.ndarray, vals: np.ndarray, dim: int, device,
          intercept: bool = False) -> torch.Tensor:
    """The bag as a dense float64 ``(n, dim [+1])`` matrix (columns of a
    row are distinct); the intercept, when asked for, in the last column."""
    n = cols.shape[0]
    x = torch.zeros(n, dim + int(intercept), dtype=F64, device=device)
    for lo in range(0, n, BLOCK):
        hi = min(n, lo + BLOCK)
        c = torch.as_tensor(cols[lo:hi], device=device).long()
        v = torch.as_tensor(vals[lo:hi], device=device).to(F64)
        x[lo:hi].scatter_(1, c, v)
    if intercept:
        x[:, dim] = 1.0
    return x


def _entity_sums(ids, values, n_entities):
    """Per-entity sums of the rows of ``values``, ``(E, ...)``."""
    out = torch.zeros((n_entities, *values.shape[1:]), dtype=F64,
                      device=values.device)
    return out.index_add_(0, ids, values)


def fixed_grad(x, y, off, w, lam):
    g = lam * w
    for lo in range(0, x.shape[0], BLOCK):
        xb = x[lo:lo + BLOCK]
        d1, _ = _sigmoid_terms(xb @ w + off[lo:lo + BLOCK], y[lo:lo + BLOCK])
        g = g + xb.T @ d1
    return g


def fixed_newton(x, y, off, lam):
    w = torch.zeros(x.shape[1], dtype=F64, device=x.device)
    eye = torch.eye(x.shape[1], dtype=F64, device=x.device)
    for _ in range(NEWTON_MAX):
        g, h = lam * w, lam * eye
        for lo in range(0, x.shape[0], BLOCK):
            xb = x[lo:lo + BLOCK]
            d1, d2 = _sigmoid_terms(xb @ w + off[lo:lo + BLOCK],
                                    y[lo:lo + BLOCK])
            g = g + xb.T @ d1
            h = h + xb.T @ (d2[:, None] * xb)
        step = torch.linalg.solve(h, g)
        w = w - step
        if float(step.abs().max()) <= 1e-14 * (1.0 + float(w.abs().max())):
            break
    return w


def entity_grad(z, y, off, ids, v, lam):
    """Per-entity gradients ``(E, d)`` at coefficients ``v``."""
    g = lam * v
    for lo in range(0, z.shape[0], BLOCK):
        zb, ib = z[lo:lo + BLOCK], ids[lo:lo + BLOCK]
        m = off[lo:lo + BLOCK] + (zb * v[ib]).sum(1)
        d1, _ = _sigmoid_terms(m, y[lo:lo + BLOCK])
        g = g + _entity_sums(ib, zb * d1[:, None], v.shape[0])
    return g


def entity_newton(z, y, off, ids, n_entities, lam):
    d = z.shape[1]
    v = torch.zeros(n_entities, d, dtype=F64, device=z.device)
    eye = torch.eye(d, dtype=F64, device=z.device)
    for _ in range(NEWTON_MAX):
        g = lam * v
        h = lam * eye.expand(n_entities, d, d).clone()
        for lo in range(0, z.shape[0], BLOCK):
            zb, ib = z[lo:lo + BLOCK], ids[lo:lo + BLOCK]
            m = off[lo:lo + BLOCK] + (zb * v[ib]).sum(1)
            d1, d2 = _sigmoid_terms(m, y[lo:lo + BLOCK])
            g = g + _entity_sums(ib, zb * d1[:, None], n_entities)
            h = h + _entity_sums(
                ib, d2[:, None, None] * zb[:, :, None] * zb[:, None, :],
                n_entities)
        step = torch.linalg.solve(h, g.unsqueeze(-1)).squeeze(-1)
        v = v - step
        if float(step.abs().max()) <= 1e-14 * (1.0 + float(v.abs().max())):
            break
    return v


def fixed_objective(x, y, off, w, lam):
    f = 0.5 * lam * float(w @ w)
    for lo in range(0, x.shape[0], BLOCK):
        m = x[lo:lo + BLOCK] @ w + off[lo:lo + BLOCK]
        f += float((torch.nn.functional.softplus(m)
                    - y[lo:lo + BLOCK] * m).sum())
    return f


def entity_objective(z, y, off, ids, v, lam):
    """The random effect's objective summed over its entities."""
    f = 0.5 * lam * float((v * v).sum())
    for lo in range(0, z.shape[0], BLOCK):
        m = off[lo:lo + BLOCK] + (z[lo:lo + BLOCK] * v[ids[lo:lo + BLOCK]]
                                  ).sum(1)
        f += float((torch.nn.functional.softplus(m)
                    - y[lo:lo + BLOCK] * m).sum())
    return f


def entity_margins(z, ids, v):
    return (z * v[ids]).sum(1)


def relative_rows(diff, scale):
    """Each row of ``diff`` against its own row of ``scale`` or the median
    row's, whichever is larger (norms over the last axis)."""
    dn = torch.linalg.vector_norm(diff, dim=1)
    sn = torch.linalg.vector_norm(scale, dim=1)
    return dn / torch.maximum(sn, torch.median(sn))


@dataclasses.dataclass
class Problem:
    x: torch.Tensor  # (n, global_features + 1)
    z: torch.Tensor  # (n, item_features)
    y: torch.Tensor
    users: torch.Tensor
    songs: torch.Tensor
    n_users: int
    n_songs: int
    lam: dict
    #: the validation rows, as a Problem of their own (None: no AUC)
    valid: Optional["Problem"] = None
    #: the reference's own model (global, perUser, perSong), once solved
    chain: Optional[tuple] = None

    @staticmethod
    def from_raw(raw: dict, cfg: dict, device,
                 valid: Optional[dict] = None) -> "Problem":
        return Problem(
            x=dense(raw["g_cols"], raw["g_vals"], cfg["global_features"],
                    device, intercept=True),
            z=dense(raw["i_cols"], raw["i_vals"], cfg["item_features"],
                    device),
            y=torch.as_tensor(raw["y"], device=device).to(F64),
            users=torch.as_tensor(raw["user"], device=device),
            songs=torch.as_tensor(raw["song"], device=device),
            n_users=int(cfg["users"]), n_songs=int(cfg["songs"]),
            lam={k: float(v) for k, v in cfg["lambda"].items()},
            valid=None if valid is None
            else Problem.from_raw(valid, cfg, device))

    def scores(self, w, vu, vs, dtype=F64):
        """Each row's margin under the model ``(w, vu, vs)``; with a lower
        ``dtype`` the rows and coefficients are rounded to it and the
        products summed in float32."""
        if dtype == F64:
            return (self._global_margins(w)
                    + entity_margins(self.z, self.users, vu)
                    + entity_margins(self.z, self.songs, vs))
        f32 = torch.float32

        def low(t):
            return t.to(dtype).to(f32)

        z = low(self.z)
        return ((low(self.x) @ low(w))
                + entity_margins(z, self.users, low(vu))
                + entity_margins(z, self.songs, low(vs))).to(F64)

    def reference_model(self):
        """The reference's own fit: the fixed effect, then the users given
        it, then the songs given both."""
        if self.chain is None:
            zero = torch.zeros_like(self.y)
            w = fixed_newton(self.x, self.y, zero, self.lam["global"])
            off = self._global_margins(w)
            vu = entity_newton(self.z, self.y, off, self.users,
                               self.n_users, self.lam["perUser"])
            off = off + entity_margins(self.z, self.users, vu)
            vs = entity_newton(self.z, self.y, off, self.songs,
                               self.n_songs, self.lam["perSong"])
            self.chain = (w, vu, vs)
        return self.chain

    def _global_margins(self, w):
        return torch.cat([self.x[lo:lo + BLOCK] @ w
                          for lo in range(0, self.x.shape[0], BLOCK)])

    def _entities(self, cid):
        return ((self.users, self.n_users) if cid == "perUser"
                else (self.songs, self.n_songs))

    def compare(self, fit: dict, control: bool = False) -> dict:
        """The numbers of the module's docstring for one fit."""
        dev = self.y.device
        w = torch.as_tensor(fit["global"], device=dev, dtype=F64)
        vu = torch.as_tensor(fit["perUser"], device=dev, dtype=F64)
        vs = torch.as_tensor(fit["perSong"], device=dev, dtype=F64)
        zero = torch.zeros_like(self.y)
        lam = self.lam["global"]
        out = {}
        g0 = fixed_grad(self.x, self.y, zero, torch.zeros_like(w), lam)
        g = fixed_grad(self.x, self.y, zero, w, lam)
        out["grad_rel.global"] = float(torch.linalg.vector_norm(g)
                                       / torch.linalg.vector_norm(g0))
        best = self.reference_model()[0]
        f_best = fixed_objective(self.x, self.y, zero, best, lam)
        out["obj_gap.global"] = (
            fixed_objective(self.x, self.y, zero, w, lam) - f_best) / f_best
        off = self._global_margins(w)
        for cid, v in (("perUser", vu), ("perSong", vs)):  # in turn
            ids, n = self._entities(cid)
            lam = self.lam[cid]
            g0 = entity_grad(self.z, self.y, off, ids, torch.zeros_like(v),
                             lam)
            g = entity_grad(self.z, self.y, off, ids, v, lam)
            rel = relative_rows(g, g0)
            out[f"grad_rel.{cid}"] = float(rel.max())
            out[f"grad_med.{cid}"] = float(rel.median())
            best = entity_newton(self.z, self.y, off, ids, n, lam)
            f_best = entity_objective(self.z, self.y, off, ids, best, lam)
            out[f"obj_gap.{cid}"] = (entity_objective(
                self.z, self.y, off, ids, v, lam) - f_best) / f_best
            out[f"coef_med.{cid}"] = float(
                relative_rows(v - best, best).median())
            rows = torch.bincount(ids, minlength=n)
            out[f"worst_rows.{cid}"] = float(rows[int(rel.argmax())])
            off = off + entity_margins(self.z, ids, v)
        if self.valid is not None:
            val = self.valid
            out["auc_own"] = abs(fit["auc"]
                                 - auc(val.scores(w, vu, vs), val.y))
            out["auc_gap"] = abs(fit["auc"] - auc(
                val.scores(*self.reference_model()), val.y))
            if control:
                out["auc_own.control"] = abs(
                    auc(val.scores(w, vu, vs), val.y)
                    - auc(val.scores(w, vu, vs, torch.bfloat16), val.y))
        return out
