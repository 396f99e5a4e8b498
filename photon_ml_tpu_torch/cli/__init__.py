"""Command-line entry points: ``python -m photon_ml_tpu_torch <command> ...``."""
