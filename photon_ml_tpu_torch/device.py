"""Device selection: the port's entry points run on the card by default."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``). Raises when a
    CUDA device is asked for and none is present: a run on the CPU is only
    ever an explicit ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; photon_ml_tpu_torch runs on the "
                "GPU by default — pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
