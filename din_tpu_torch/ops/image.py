"""Image helpers (port of din_tpu/ops/image.py ``prep_images``,
``interp_matrix_align_corners``, ``resize_bilinear_align_corners`` and
``calc_pairwise_distance_3d``).

The align-corners resize is torch ``F.interpolate(mode='bilinear',
align_corners=True)`` built, as in the JAX package, from a separable
interpolation matrix per axis and two matmuls, so that its rows compose
with RoIAlign's (``ops/roi_align.py`` ``roi_align_multiscale``)."""

from __future__ import annotations

from typing import Tuple

import torch


def prep_images(images: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalise uint8/float images in [0,255] to [-1,1], computed in
    ``dtype`` as the JAX package does (reference utils.py:8-19)."""
    x = images.to(dtype)
    return (x / 255.0 - 0.5) * 2.0


def interp_matrix_align_corners(n_in: int, n_out: int,
                                dtype: torch.dtype = torch.float32,
                                device=None) -> torch.Tensor:
    """[n_out, n_in] row-stochastic matrix of 1-D align-corners
    interpolation, built in float32 and cast to ``dtype``
    (din_tpu/ops/image.py:26-43): all ones for ``n_in == 1``; a single
    output samples position 0."""
    if n_in == 1:
        return torch.ones((n_out, 1), dtype=dtype, device=device)
    if n_out == 1:
        m = torch.zeros((1, n_in), dtype=dtype, device=device)
        m[0, 0] = 1.0
        return m
    # a 0-dim divisor: a true division on every device (CUDA turns a Python
    # divisor into a product with its reciprocal)
    pos = torch.arange(n_out, dtype=torch.float32, device=device) \
        * (n_in - 1) / torch.full((), n_out - 1, dtype=torch.float32,
                                  device=device)
    lo = pos.floor().long().clamp(0, n_in - 1)
    hi = (lo + 1).clamp(0, n_in - 1)
    w_hi = pos - lo.float()
    w_lo = 1.0 - w_hi
    grid = torch.arange(n_in, device=device)
    # the JAX package's two scatter-adds: each entry is w_lo, w_hi or, where
    # lo == hi (the last row), w_lo + w_hi
    m = (lo[:, None] == grid) * w_lo[:, None] \
        + (hi[:, None] == grid) * w_hi[:, None]
    return m.to(dtype)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align-corners resize of an NHWC map [B,H,W,C] to
    [B,OH,OW,C] in x's dtype: two matmuls with the interpolation matrices
    (din_tpu/ops/image.py:46-65)."""
    B, H, W, C = x.shape
    OH, OW = size
    if (H, W) == (OH, OW):
        return x
    my = interp_matrix_align_corners(H, OH, x.dtype, x.device)    # [OH,H]
    mx = interp_matrix_align_corners(W, OW, x.dtype, x.device)    # [OW,W]
    x = torch.einsum("oh,bhwc->bowc", my, x)
    return torch.einsum("pw,bowc->bopc", mx, x)


def calc_pairwise_distance_3d(X: torch.Tensor,
                              Y: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [B,N,M] of X [B,N,D] and Y [B,M,D], as
    din_tpu/ops/image.py:76-81 computes them (reference utils.py:56-72):
    sqrt(max(|x|^2 - 2 x.y + |y|^2, 0))."""
    rx = X.square().sum(dim=2)[:, :, None]
    ry = Y.square().sum(dim=2)[:, None, :]
    d2 = rx - 2.0 * torch.bmm(X, Y.transpose(1, 2)) + ry
    return torch.sqrt(d2.clamp_min(0.0))
