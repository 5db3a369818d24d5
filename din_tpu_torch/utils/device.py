"""Where the port runs: the card unless the caller asks for the CPU.

Kept apart from ``models/registry.py`` so that code which serves an
exported program (``experiments/export_serving.py``) resolves its device
without importing any model module."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU.  With
    no device named, a rank started by ``torch.distributed.run`` (which sets
    ``LOCAL_RANK``) takes its own card, ``cuda:LOCAL_RANK``; a named device
    is taken as it is (two ranks may share ``cuda:0``)."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = "cuda" if local is None else f"cuda:{int(local)}"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; din_tpu_torch runs on the "
                           "card and takes device='cpu' only when asked")
    return device
