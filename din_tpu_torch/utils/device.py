"""Where the port runs: the card unless the caller asks for the CPU.

Kept apart from ``models/registry.py`` so that code which serves an
exported program (``experiments/export_serving.py``) resolves its device
without importing any model module."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; din_tpu_torch runs on the "
                           "card and takes device='cpu' only when asked")
    return device
