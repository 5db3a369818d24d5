"""Sinusoidal positional encodings (port of din_tpu/heads/positional.py;
reference infer_module/positional_encoding.py:9-99, AT_infer_module.py
:52-96).

Feature-last, float32, the same formulas and the same order of operations
as the JAX package: ``_dim_t`` is ``temperature ** (2 floor(i/2) / F)``
(correctly rounded), and ``_interleave_sin_cos`` stacks the sine of the
even and the cosine of the odd columns and flattens them pairwise (DETR's
interleaving).  TCE adds
``context_position_embedding_sine`` to the last backbone map; the AT and
SACRF+BiUTE heads add ``boxes_position_embedding`` to the actor features.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _dim_t(num_pos_feats: int, temperature: float,
           device=None) -> torch.Tensor:
    """``temperature ** (2 floor(i/2) / F)`` rounded once to float32 (the
    power taken in float64): XLA's float32 power is correctly rounded here,
    torch's float32 power is not, by an ulp that the x / dim_t of a
    720x1280 map turns into ~4e-5 of sine."""
    i = torch.arange(num_pos_feats, dtype=torch.float64, device=device)
    return (temperature ** (2.0 * torch.floor(i / 2.0) / num_pos_feats)
            ).float()


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """stack(sin(even), cos(odd)) flattened (positional_encoding.py:44-47)."""
    s = torch.sin(pos[..., 0::2])
    c = torch.cos(pos[..., 1::2])
    return torch.stack([s, c], dim=-1).reshape(*pos.shape[:-1], -1)


def _grid_embedding(H: int, W: int, step: float, num_pos_feats: int,
                    temperature: float, device=None,
                    normalize: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[H, W, 2*num_pos_feats]: the y encoding, then the x encoding, of the
    1-based grid coordinates times ``step``."""
    y = torch.arange(1, H + 1, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(1, W + 1, dtype=torch.float32, device=device)[None, :]
    y = (y * step).expand(H, W)
    x = (x * step).expand(H, W)
    if normalize:
        eps = 1e-6
        y = y / (y[-1:, :] + eps) * scale
        x = x / (x[:, -1:] + eps) * scale
    dim_t = _dim_t(num_pos_feats, temperature, device)
    pos_x = _interleave_sin_cos(x[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def image_position_embedding_sine(shape: Tuple[int, int],
                                  num_pos_feats: int = 64,
                                  temperature: float = 10000.0,
                                  normalize: bool = False,
                                  scale: Optional[float] = None,
                                  device=None) -> torch.Tensor:
    """DETR-style 2-D sine encoding over an all-valid mask, [H, W,
    2*num_pos_feats] (positional_encoding.py:9-49, which returns [B, 2C, H,
    W]); coordinates are 1-based, as the cumsum of the all-ones mask."""
    H, W = shape
    return _grid_embedding(H, W, 1.0, num_pos_feats, temperature, device,
                           normalize, 2 * math.pi if scale is None else scale)


def context_position_embedding_sine(context: torch.Tensor,
                                    downscale_ratio: float,
                                    num_pos_feats: int,
                                    temperature: float = 10000.0
                                    ) -> torch.Tensor:
    """``context`` [B, H, W, C] plus the image-plane encoding of its cells,
    their coordinates scaled by the backbone's ``downscale_ratio``
    (positional_encoding.py:52-99 ``Context_PositionEmbeddingSine``); C must
    equal 2*num_pos_feats."""
    B, H, W, C = context.shape
    if C != 2 * int(num_pos_feats):
        raise ValueError(f"context has {C} channels, the encoding "
                         f"{2 * int(num_pos_feats)}")
    pos = _grid_embedding(H, W, float(downscale_ratio), int(num_pos_feats),
                          temperature, context.device)
    return context + pos[None].to(context.dtype)


def sincos_encoding_2d(positions: torch.Tensor, d_emb: int) -> torch.Tensor:
    """The reference's legacy 2-D sin/cos encoding (utils.py:74-98, used by
    no model there): positions [N, 2] -> [N, d_emb]."""
    d = d_emb // 2
    idxs = torch.tensor([1000.0 ** (2 * (i // 2) / d) for i in range(d)],
                        dtype=torch.float32, device=positions.device)
    idxs = idxs.repeat(2)                                       # [d_emb]
    pos = torch.cat([positions[:, 0:1].expand(-1, d),
                     positions[:, 1:2].expand(-1, d)], dim=1)
    emb = pos / idxs
    out = torch.zeros_like(emb)
    out[:, 0::2] = torch.sin(emb[:, 0::2])
    out[:, 1::2] = torch.cos(emb[:, 1::2])
    return out


def boxes_position_embedding(features: torch.Tensor, boxes: torch.Tensor,
                             image_size: Tuple[int, int],
                             out_size: Tuple[int, int],
                             temperature: float = 10000.0) -> torch.Tensor:
    """``features`` [B, T, N, C] plus the sine encoding of each box centre
    in image pixels (boxes [B, T, N, 4] x1, y1, x2, y2 in feature-map
    coordinates; AT_infer_module.py:52-96 ``Embfeature_PositionEmbedding``):
    the x encoding (C/2), then the y encoding (C/2)."""
    C = features.shape[-1]
    num_pos_feats = C // 2
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0 * (image_size[1] / out_size[1])
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0 * (image_size[0] / out_size[0])
    dim_t = _dim_t(num_pos_feats, temperature, features.device)
    pos_x = _interleave_sin_cos(cx[..., None].float() / dim_t)
    pos_y = _interleave_sin_cos(cy[..., None].float() / dim_t)
    pe = torch.cat([pos_x, pos_y], dim=-1)
    return features + pe.to(features.dtype)
