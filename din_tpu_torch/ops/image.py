"""Image helpers (port of din_tpu/ops/image.py ``prep_images`` and
``calc_pairwise_distance_3d``)."""

from __future__ import annotations

import torch


def prep_images(images: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalise uint8/float images in [0,255] to [-1,1], computed in
    ``dtype`` as the JAX package does (reference utils.py:8-19)."""
    x = images.to(dtype)
    return (x / 255.0 - 0.5) * 2.0


def calc_pairwise_distance_3d(X: torch.Tensor,
                              Y: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [B,N,M] of X [B,N,D] and Y [B,M,D], as
    din_tpu/ops/image.py:76-81 computes them (reference utils.py:56-72):
    sqrt(max(|x|^2 - 2 x.y + |y|^2, 0))."""
    rx = X.square().sum(dim=2)[:, :, None]
    ry = Y.square().sum(dim=2)[:, None, :]
    d2 = rx - 2.0 * torch.bmm(X, Y.transpose(1, 2)) + ry
    return torch.sqrt(d2.clamp_min(0.0))
