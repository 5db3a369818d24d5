"""AT, the Actor Transformer (port of din_tpu/heads/at.py; reference
infer_module/AT_infer_module.py:100-144).

One single-head self-attention layer over a set of actor tokens: Q, K, V
projections without bias, softmax of QK^T / sqrt(C) in float32, dropout,
post-LN residual (``layernorm1``), then a two-layer ReLU FFN with dropout
inside and on its output, and a second post-LN residual (``layernorm2``).
The three dropouts (rate 0.1) draw from their own seeded generators
(``SeededDropout``).  The LayerNorms are ``nn.LayerNorm`` with eps 1e-5;
flax's ``nn.LayerNorm`` takes the variance as E[x^2] - E[x]^2, which
differs from torch's by ~1e-7 relative.  Module names are the reference's
(``Q_W``, ``K_W``, ``V_W``, ``layernorm1``, ``FFN_linear1``,
``FFN_linear2``, ``layernorm2``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from din_tpu_torch.nn.layers import SeededDropout, kaiming_linear


class ActorTransformer(nn.Module):
    """x [B', N', C] token sets -> the same shape.  The caller reshapes
    [B,T,N,C] to [B*T,N,C], or mean-pools the frames first
    (AT_infer_module.py:124-128)."""

    def __init__(self, in_dim: int, generator: torch.Generator,
                 dropout: float = 0.1, seed: int = 0):
        super().__init__()
        self.in_dim = in_dim
        self.Q_W = kaiming_linear(in_dim, in_dim, generator, bias=False)
        self.K_W = kaiming_linear(in_dim, in_dim, generator, bias=False)
        self.V_W = kaiming_linear(in_dim, in_dim, generator, bias=False)
        self.dropout1 = SeededDropout(dropout, seed)
        self.layernorm1 = nn.LayerNorm(in_dim)
        self.FFN_linear1 = kaiming_linear(in_dim, in_dim, generator)
        # the reference applies dropout2 inside the FFN and again on its
        # output (AT_infer_module.py:139-143)
        self.dropout2a = SeededDropout(dropout, seed + 1)
        self.FFN_linear2 = kaiming_linear(in_dim, in_dim, generator)
        self.dropout2b = SeededDropout(dropout, seed + 2)
        self.layernorm2 = nn.LayerNorm(in_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.Q_W(x), self.K_W(x), self.V_W(x)
        att = torch.bmm(q, k.transpose(1, 2)).float() / math.sqrt(self.in_dim)
        att = torch.softmax(att, dim=-1).to(x.dtype)
        att_v = self.dropout1(torch.bmm(att, v))
        x = self.layernorm1(x + att_v)
        y = self.dropout2a(torch.relu(self.FFN_linear1(x)))
        y = self.dropout2b(self.FFN_linear2(y))
        return self.layernorm2(x + y)
