"""Image preparation (port of din_tpu/ops/image.py ``prep_images``)."""

from __future__ import annotations

import torch


def prep_images(images: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalise uint8/float images in [0,255] to [-1,1], computed in
    ``dtype`` as the JAX package does (reference utils.py:8-19)."""
    x = images.to(dtype)
    return (x / 255.0 - 0.5) * 2.0
