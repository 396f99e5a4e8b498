"""Training diagnostics (counterpart of ``photon_ml_tpu/diagnostics/``):
bootstrap coefficient CIs, Hosmer–Lemeshow calibration, feature importance,
fitting curves, and the HTML report writer."""

from photon_ml_tpu_torch.diagnostics.bootstrap import (
    BootstrapReport,
    bootstrap_coefficients,
    bootstrap_weights,
)
from photon_ml_tpu_torch.diagnostics.fitting import (
    DEFAULT_PORTIONS,
    FittingReport,
    fitting_curve,
    portion_masks,
)
from photon_ml_tpu_torch.diagnostics.hl import (
    HosmerLemeshowReport,
    hosmer_lemeshow,
)
from photon_ml_tpu_torch.diagnostics.importance import (
    FeatureImportanceReport,
    expected_magnitude_importance,
    variance_importance,
)
from photon_ml_tpu_torch.diagnostics.reporting import (
    render_report,
    write_report,
)

__all__ = [
    "BootstrapReport",
    "bootstrap_coefficients",
    "bootstrap_weights",
    "DEFAULT_PORTIONS",
    "FittingReport",
    "fitting_curve",
    "portion_masks",
    "HosmerLemeshowReport",
    "hosmer_lemeshow",
    "FeatureImportanceReport",
    "expected_magnitude_importance",
    "variance_importance",
    "render_report",
    "write_report",
]
