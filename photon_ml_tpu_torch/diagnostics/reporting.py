"""Self-contained HTML diagnostics report (a copy of
``photon_ml_tpu/diagnostics/reporting.py``: it is host-only, and the same
reports render to the same bytes in both packages).

Re-design of the reference's ``photon-client/.../diagnostics/reporting/``
(the HTML report the legacy GLM ``Driver`` writes under
``--training-diagnostics``): one dependency-free HTML file assembling the
bootstrap, Hosmer–Lemeshow, feature-importance, and fitting sections, with a
small inline-SVG line chart for the fitting curve.
"""

from __future__ import annotations

import html
import os
from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.diagnostics.bootstrap import BootstrapReport
from photon_ml_tpu_torch.diagnostics.fitting import FittingReport
from photon_ml_tpu_torch.diagnostics.hl import HosmerLemeshowReport
from photon_ml_tpu_torch.diagnostics.importance import FeatureImportanceReport

_STYLE = """
body{font-family:sans-serif;margin:2em;max-width:70em}
table{border-collapse:collapse;margin:1em 0}
td,th{border:1px solid #999;padding:.3em .6em;text-align:right}
th{background:#eee}
h2{border-bottom:2px solid #444;padding-bottom:.2em}
.ok{color:#070}.bad{color:#a00}
"""


def _table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    head = "".join(f"<th>{html.escape(str(h))}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(
            f"<td>{html.escape(f'{c:.6g}' if isinstance(c, float) else str(c))}</td>"
            for c in row) + "</tr>"
        for row in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def _svg_curve(report: FittingReport, width=480, height=240) -> str:
    """Train/validation objective vs portion as a minimal inline SVG."""
    x = report.portions
    series = [("train", report.train_objective, "#1f77b4"),
              ("validation", report.validation_objective, "#d62728")]
    ys = np.concatenate([s[1] for s in series])
    y_lo, y_hi = float(ys.min()), float(ys.max())
    span = (y_hi - y_lo) or 1.0
    pad, w, h = 40, width, height

    def pt(xv, yv):
        px = pad + (xv - x[0]) / max(x[-1] - x[0], 1e-9) * (w - 2 * pad)
        py = h - pad - (yv - y_lo) / span * (h - 2 * pad)
        return f"{px:.1f},{py:.1f}"

    lines = []
    for name, y, color in series:
        pts = " ".join(pt(float(a), float(b)) for a, b in zip(x, y))
        lines.append(f'<polyline fill="none" stroke="{color}" stroke-width="2" '
                     f'points="{pts}"/>')
        lines.append(f'<text x="{w - pad}" y="{15 * (len(lines) // 2 + 1)}" '
                     f'fill="{color}" text-anchor="end">{name}</text>')
    axis = (f'<line x1="{pad}" y1="{h-pad}" x2="{w-pad}" y2="{h-pad}" stroke="#000"/>'
            f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{h-pad}" stroke="#000"/>'
            f'<text x="{w//2}" y="{h-8}" text-anchor="middle">training portion</text>'
            f'<text x="{pad}" y="{pad-8}">mean objective</text>')
    return (f'<svg width="{w}" height="{h}" xmlns="http://www.w3.org/2000/svg">'
            + axis + "".join(lines) + "</svg>")


def render_report(
    model_summary: dict,
    bootstrap: Optional[BootstrapReport] = None,
    hosmer_lemeshow: Optional[HosmerLemeshowReport] = None,
    importance: Sequence[FeatureImportanceReport] = (),
    fitting: Optional[FittingReport] = None,
    feature_names: Optional[Sequence[str]] = None,
    top_k: int = 25,
) -> str:
    """Render all available sections into one HTML document."""
    parts = [f"<html><head><meta charset='utf-8'><style>{_STYLE}</style>"
             "<title>Photon-ML TPU training diagnostics</title></head><body>",
             "<h1>Training diagnostics</h1>"]

    parts.append("<h2>Model</h2>")
    parts.append(_table(["key", "value"],
                        [(k, v) for k, v in model_summary.items()]))

    if bootstrap is not None:
        parts.append("<h2>Bootstrap coefficient confidence intervals</h2>")
        parts.append(
            f"<p>{bootstrap.n_replicates} replicates, "
            f"{bootstrap.confidence_level:.0%} confidence.</p>")
        order = np.argsort(-np.abs(bootstrap.mean))[:top_k]
        names = (feature_names if feature_names is not None
                 else [str(i) for i in range(len(bootstrap.mean))])
        rows = [(names[i], float(bootstrap.mean[i]), float(bootstrap.std[i]),
                 float(bootstrap.ci_lower[i]), float(bootstrap.ci_upper[i]),
                 float(bootstrap.sign_stability[i]),
                 "yes" if bootstrap.zero_crossing()[i] else "no")
                for i in order]
        parts.append(_table(
            ["feature", "mean", "std", "ci lower", "ci upper",
             "sign stability", "CI crosses 0"], rows))

    if hosmer_lemeshow is not None:
        r = hosmer_lemeshow
        cls = "ok" if r.well_calibrated() else "bad"
        parts.append("<h2>Hosmer–Lemeshow calibration</h2>")
        parts.append(
            f"<p>&chi;&sup2; = {r.chi_square:.4g} on {r.degrees_of_freedom} "
            f"d.o.f. &rarr; p = <span class='{cls}'>{r.p_value:.4g}</span></p>")
        rows = [(g, float(r.bin_counts[g]), float(r.mean_predicted[g]),
                 float(r.observed_positives[g]), float(r.expected_positives[g]))
                for g in range(r.n_bins)]
        parts.append(_table(
            ["bin", "count", "mean p&#770;", "observed +", "expected +"], rows))

    for rep in importance:
        parts.append(f"<h2>Feature importance — {html.escape(rep.kind)}</h2>")
        parts.append(_table(["feature", "importance"], rep.top(top_k)))

    if fitting is not None:
        parts.append("<h2>Fitting curve</h2>")
        parts.append(_svg_curve(fitting))
        rows = list(zip(
            [float(p) for p in fitting.portions],
            [float(v) for v in fitting.train_objective],
            [float(v) for v in fitting.validation_objective],
            [float(v) for v in fitting.generalization_gap()]))
        parts.append(_table(
            ["portion", "train objective", "validation objective", "gap"], rows))

    parts.append("</body></html>")
    return "".join(parts)


def write_report(path: str, **kwargs) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = render_report(**kwargs)
    with open(path, "w") as f:
        f.write(doc)
    return path
