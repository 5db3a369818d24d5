"""HiGCIN's Cross Inference Block (port of din_tpu/heads/higcin.py;
reference infer_module/higcin_infer_module.py:9-66).

The reference loops over the T x S cells and, for each, sums the
dot-product attention of its embedding over its frame's S cells (spatial)
and over its own track's T frames (temporal), averages them, projects
back, adds the input and applies BatchNorm2d.  The loop reads only the
input, so the block is four einsums, as in the JAX package; there is no
softmax (higcin_infer_module.py:44).  All in float32; the BatchNorm is
``TorchBatchNorm`` with din_tpu's arithmetic, over the (B, T, S) cells of
each channel, live in training (momentum 0.1 in torch's terms, flax's
0.9).  Module names are the reference's: ``theta``, ``phi``, ``fun_g``,
``W``, ``bn``.
"""

from __future__ import annotations

import torch
from torch import nn

from din_tpu_torch.nn.layers import TorchBatchNorm, kaiming_linear


class CrossInferBlock(nn.Module):
    """x [B,T,S,C] -> the same shape.  S is the K*K body positions of a
    person (BIM) or the N persons of a frame (PIM), infer_model.py:646-647."""

    def __init__(self, in_dim: int, generator: torch.Generator):
        super().__init__()
        latent = in_dim // 2
        self.theta = kaiming_linear(in_dim, latent, generator, bias=False)
        self.phi = kaiming_linear(in_dim, latent, generator, bias=False)
        self.fun_g = kaiming_linear(in_dim, latent, generator, bias=False)
        self.W = kaiming_linear(latent, in_dim, generator, bias=False)
        self.bn = TorchBatchNorm(in_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, S, C = x.shape
        theta_x, phi_x, g_x = self.theta(x), self.phi(x), self.fun_g(x)
        # spatial: cell (t, j) attends over its frame's S positions
        sweight = torch.einsum("btnl,btjl->btjn", phi_x, theta_x)
        spatio = torch.einsum("btjn,btnl->btjl", sweight / S, g_x)
        # temporal: cell (t, j) attends over its own track's T frames
        tweight = torch.einsum("bsjl,btjl->btjs", phi_x, theta_x)
        temporal = torch.einsum("btjs,bsjl->btjl", tweight / T, g_x)
        out = self.W((spatio + temporal) / (T + S)) + x
        # BatchNorm2d over channels, statistics across (B, T, S)
        return self.bn(out.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
