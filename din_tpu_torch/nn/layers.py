"""Building blocks with the JAX package's semantics (port of
din_tpu/nn/layers.py).

``torch_conv`` is ``nn.Conv2d`` itself, ``TorchLayerNorm(ndims)`` is
``nn.LayerNorm`` over the trailing dims, and ``max_pool_torch(x, 2, 2)``
is ``MaxPool2x2``, which goes through kernel K2.  The initialisers
reproduce the JAX package's from a ``torch.Generator``: flax's default
conv init (lecun normal, truncated), the reference's kaiming-normal Linear
init, zero biases.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from din_tpu_torch.ops.pool import max_pool_2x2

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _fan_in(w: torch.Tensor) -> int:
    return w.shape[1] * math.prod(w.shape[2:])


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: variance 1/fan_in, truncated at 2 std."""
    std = 1.0 / math.sqrt(_fan_in(w)) / _TRUNC_STD
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    z = torch.erfinv((lo + (hi - lo) * u) * 2 - 1) * math.sqrt(2)
    w.copy_(z * std)


@torch.no_grad()
def kaiming_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """torch ``kaiming_normal_`` (fan_in, relu): std sqrt(2/fan_in), the
    reference's Linear init (din_tpu/nn/layers.py kaiming_normal_init)."""
    w.normal_(0.0, math.sqrt(2.0 / _fan_in(w)), generator=generator)


class MaxPool2x2(nn.Module):
    """torch ``MaxPool2d(2, 2)`` (floor mode) on an NCHW map held in
    ``channels_last`` memory, through kernel K2 on the card."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NCHW channels_last is NHWC in memory: the permute is free
        y = max_pool_2x2(x.permute(0, 2, 3, 1).contiguous())
        return y.permute(0, 3, 1, 2)
