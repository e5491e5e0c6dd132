"""The device the port's hot path runs on."""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """``torch.device("cuda")``; raises when no CUDA device is visible.

    The port has no CPU fallback for measurement: a path that wants the card
    and finds none fails here.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (torch.cuda.is_available() is False)")
    return torch.device("cuda")
