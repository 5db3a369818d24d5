"""TCE: the Embfeature Context Encoding transformer (port of
din_tpu/heads/tce.py ``_context_attend_ffn``, ``EmbfeatureContextEncoding``
and ``MultiHeadTCE``, lines 24-76 and 143-166; reference
infer_module/TCE_STBiP_module.py:175-193, 224-312).

Each head embeds the actor features (queries, ``emb_roi``) and the context
map (keys and values, a 1x1 conv ``downsample2`` in the first layer,
``downsample`` in later ones) to NFC features, attends from every actor
over all OH*OW map cells, and adds a residual LayerNorm and a two-layer
FFN.  The heads of a layer are concatenated and feed the next layer.  The
module names are the reference's: ``CET.{layer * num_heads + head}.*``,
``FFN.0`` and ``FFN.3`` around its ReLU and dropout.

Everything runs in float32.  The JAX package computes the two attention
einsums and the Dense layers at ``precision="highest"``; here they are
``torch.bmm`` and ``F.linear`` in float32, which on the card run in IEEE
float32 under PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 =
False`` (the smoke holds the card against the CPU under those flags).  In
training the two dropouts (rate 0.1) draw from their own seeded generators
(``SeededDropout``).

Not ported yet: the raw-RoI ``ContextEncoding`` and its multi-layer
wrapper, and ``STBilinearMessagePassing`` / ``MultiHeadSTBilinear``
(tce.py:79-140, 169-238), which no model of the JAX package uses
(ROADMAP.md §1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from din_tpu_torch.nn.layers import (SeededDropout, kaiming_normal_,
                                     lecun_normal_)


def _dense(i: int, o: int, generator: torch.Generator) -> nn.Linear:
    """flax Dense: lecun-normal kernel, zero bias."""
    m = nn.Linear(i, o)
    lecun_normal_(m.weight, generator)
    nn.init.zeros_(m.bias)
    return m


class EmbfeatureContextEncoding(nn.Module):
    """One TCE head: roi_features [BT, N, F_in] attend over image_feature
    [BT, OH, OW, D] -> [BT, N, NFC] (TCE_STBiP_module.py:252-286)."""

    def __init__(self, in_features: int, context_features: int,
                 num_features_context: int, generator: torch.Generator,
                 layer_id: int = 1, context_dropout: float = 0.1,
                 seed: int = 0):
        super().__init__()
        nfc = num_features_context
        downsample = nn.Conv2d(context_features, nfc, 1)
        (lecun_normal_ if layer_id == 1 else kaiming_normal_)(
            downsample.weight, generator)
        nn.init.zeros_(downsample.bias)
        # the reference names the first layer's 1x1 conv downsample2
        self.ds_name = "downsample2" if layer_id == 1 else "downsample"
        setattr(self, self.ds_name, downsample)
        self.emb_roi = _dense(in_features, nfc, generator)
        self.dropout = SeededDropout(context_dropout, seed)
        self.layernorm1 = nn.LayerNorm(nfc)
        self.FFN = nn.Sequential(_dense(nfc, nfc, generator), nn.ReLU(),
                                 SeededDropout(context_dropout, seed + 1),
                                 _dense(nfc, nfc, generator))
        self.layernorm2 = nn.LayerNorm(nfc)

    def forward(self, roi_features: torch.Tensor,
                image_feature: torch.Tensor) -> torch.Tensor:
        ds = getattr(self, self.ds_name)
        img = F.linear(image_feature, ds.weight.flatten(1), ds.bias)
        emb = self.emb_roi(roi_features)                       # [BT,N,NFC]
        # _context_attend_ffn (din_tpu/heads/tce.py:24-48)
        BT, OH, OW, nfc = img.shape
        img_flat = img.reshape(BT, OH * OW, nfc)
        a = torch.bmm(emb, img_flat.transpose(1, 2))           # [BT,N,P]
        att = torch.softmax(a.float(), dim=-1).to(emb.dtype)
        ctx = self.dropout(torch.bmm(att, img_flat))
        ctx = self.layernorm1(ctx + emb)
        return self.layernorm2(ctx + self.FFN(ctx))


class MultiHeadTCE(nn.Module):
    """num_heads x num_layers TCE heads; per layer the heads' outputs are
    concatenated and become the next layer's roi features
    (TCE_STBiP_module.py:289-312).  roi_features [BT, N, in_features],
    image_feature [BT, OH, OW, context_features] -> [BT, N,
    num_heads * num_features_context]."""

    def __init__(self, in_features: int, context_features: int,
                 generator: torch.Generator, num_heads: int = 4,
                 num_layers: int = 1, num_features_context: int = 128,
                 context_dropout: float = 0.1, seed: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.num_layers = num_layers
        heads = []
        for layer in range(num_layers):
            f_in = in_features if layer == 0 else \
                num_heads * num_features_context
            for h in range(num_heads):
                k = layer * num_heads + h
                heads.append(EmbfeatureContextEncoding(
                    f_in, context_features, num_features_context, generator,
                    layer_id=layer + 1, context_dropout=context_dropout,
                    seed=seed + 2 * k))
        self.CET = nn.ModuleList(heads)

    def forward(self, roi_features: torch.Tensor,
                image_feature: torch.Tensor) -> torch.Tensor:
        x = roi_features
        for layer in range(self.num_layers):
            x = torch.cat([self.CET[layer * self.num_heads + h](
                x, image_feature) for h in range(self.num_heads)], dim=-1)
        return x
