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

The bundled AAAI'21 pieces that no model of the JAX package or the
reference instantiates (din_tpu/heads/tce.py:79-140, 169-238; reference
TCE_STBiP_module.py:12-221): the raw-RoI ``ContextEncoding`` (its first
layer embeds the RoIAlign crop itself: a 1x1 conv ``downsample1`` to NFC,
the crop flattened channel-major ``[NFC, K, K]`` as the reference's
``emb_roi`` reads it, and the context's 1x1 conv ``downsample2``) and its
multi-layer wrapper ``MultiHeadLayerContextEncoding`` (``CET.{k}``), the
distance mask ``generate_spatial_mask``, and the spatio-temporal bilinear
attention ``STBilinearMessagePassing`` (``U``, ``V``, ``w_a``, ``W_e2``,
``layernorm``, ``W_e1``) with ``MultiHeadSTBilinear`` (``bilinear_list``;
'sum' or 'cat' fusion).  Their dropouts draw from ``SeededDropout``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from din_tpu_torch.nn.layers import (SeededDropout, kaiming_normal_,
                                     lecun_normal_)
from din_tpu_torch.ops.image import calc_pairwise_distance_3d


def _dense(i: int, o: int, generator: torch.Generator) -> nn.Linear:
    """flax Dense: lecun-normal kernel, zero bias."""
    m = nn.Linear(i, o)
    lecun_normal_(m.weight, generator)
    nn.init.zeros_(m.bias)
    return m


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv over the channels-last x [..., C_in]."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def _add_attend_ffn(m: nn.Module, nfc: int, generator: torch.Generator,
                    context_dropout: float, seed: int) -> None:
    """The modules of the attention tail both TCE variants share."""
    m.dropout = SeededDropout(context_dropout, seed)
    m.layernorm1 = nn.LayerNorm(nfc)
    m.FFN = nn.Sequential(_dense(nfc, nfc, generator), nn.ReLU(),
                          SeededDropout(context_dropout, seed + 1),
                          _dense(nfc, nfc, generator))
    m.layernorm2 = nn.LayerNorm(nfc)


def _attend_ffn(m: nn.Module, emb: torch.Tensor,
                img: torch.Tensor) -> torch.Tensor:
    """emb [BT,N,NFC] attends over img [BT,OH,OW,NFC], then the residual
    LayerNorm and FFN (din_tpu/heads/tce.py:24-48 ``_context_attend_ffn``;
    TCE_STBiP_module.py:175-193 and 271-285)."""
    BT, OH, OW, nfc = img.shape
    img_flat = img.reshape(BT, OH * OW, nfc)
    a = torch.bmm(emb, img_flat.transpose(1, 2))               # [BT,N,P]
    att = torch.softmax(a.float(), dim=-1).to(emb.dtype)
    ctx = m.dropout(torch.bmm(att, img_flat))
    ctx = m.layernorm1(ctx + emb)
    return m.layernorm2(ctx + m.FFN(ctx))


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
        _add_attend_ffn(self, nfc, generator, context_dropout, seed)

    def forward(self, roi_features: torch.Tensor,
                image_feature: torch.Tensor) -> torch.Tensor:
        img = _conv1x1(getattr(self, self.ds_name), image_feature)
        return _attend_ffn(self, self.emb_roi(roi_features), img)


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


class ContextEncoding(nn.Module):
    """One raw-RoI TCE head (TCE_STBiP_module.py:129-194
    ``ContextEncodingTransformer``; din_tpu/heads/tce.py:79-117).  Layer
    1: roi_features [BT, N, K, K, D] (the RoIAlign crop, channels last)
    -> 1x1 conv ``downsample1`` to NFC, flattened channel-major -> ``emb_roi``
    ([NFC*K*K] -> NFC); the context [BT, OH, OW, C_ctx] through
    ``downsample2``.  A later layer: roi_features [BT, N, in_features] (the
    previous layer's heads) -> ``emb_roi``; the context through
    ``downsample`` (kaiming init).  Returns [BT, N, NFC]."""

    def __init__(self, in_features: int, context_features: int,
                 num_features_context: int, generator: torch.Generator,
                 layer_id: int = 1, crop_size: int = 5,
                 context_dropout: float = 0.1, seed: int = 0):
        super().__init__()
        nfc = num_features_context
        self.layer_id = layer_id

        def conv(i, init):
            c = nn.Conv2d(i, nfc, 1)
            init(c.weight, generator)
            nn.init.zeros_(c.bias)
            return c

        if layer_id == 1:
            self.downsample1 = conv(in_features, lecun_normal_)
            self.emb_roi = _dense(nfc * crop_size * crop_size, nfc,
                                  generator)
            self.downsample2 = conv(context_features, lecun_normal_)
        else:
            self.emb_roi = _dense(in_features, nfc, generator)
            self.downsample = conv(context_features, kaiming_normal_)
        _add_attend_ffn(self, nfc, generator, context_dropout, seed)

    def forward(self, roi_features: torch.Tensor,
                image_feature: torch.Tensor) -> torch.Tensor:
        if self.layer_id == 1:
            roi = _conv1x1(self.downsample1, roi_features)   # [BT,N,K,K,NFC]
            roi = roi.permute(0, 1, 4, 2, 3).flatten(2)      # (c, i, j)
            img = _conv1x1(self.downsample2, image_feature)
        else:
            roi = roi_features
            img = _conv1x1(self.downsample, image_feature)
        return _attend_ffn(self, self.emb_roi(roi), img)


class MultiHeadLayerContextEncoding(nn.Module):
    """num_heads x num_layers raw-RoI heads; per layer the heads' outputs
    are concatenated and become the next layer's roi features
    (TCE_STBiP_module.py:196-221; din_tpu/heads/tce.py:120-140).
    roi_features [BT, N, K, K, roi_features], image_feature [BT, OH, OW,
    context_features] -> [BT, N, num_heads * num_features_context]."""

    def __init__(self, roi_features: int, context_features: int,
                 generator: torch.Generator, num_heads: int,
                 num_layers: int, num_features_context: int,
                 crop_size: int = 5, context_dropout: float = 0.1,
                 seed: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.num_layers = num_layers
        heads = []
        for layer in range(num_layers):
            f_in = roi_features if layer == 0 else \
                num_heads * num_features_context
            for h in range(num_heads):
                k = layer * num_heads + h
                heads.append(ContextEncoding(
                    f_in, context_features, num_features_context, generator,
                    layer_id=layer + 1, crop_size=crop_size,
                    context_dropout=context_dropout, seed=seed + 2 * k))
        self.CET = nn.ModuleList(heads)

    def forward(self, roi_features: torch.Tensor,
                image_feature: torch.Tensor) -> torch.Tensor:
        x = roi_features
        for layer in range(self.num_layers):
            x = torch.cat([self.CET[layer * self.num_heads + h](
                x, image_feature) for h in range(self.num_heads)], dim=-1)
        return x


def generate_spatial_mask(boxes: torch.Tensor, threshold: float,
                          out_h: int) -> torch.Tensor:
    """[BT, N, N], True where two box centres lie farther apart than
    ``threshold * out_h`` (TCE_STBiP_module.py:107-121;
    din_tpu/heads/tce.py:169-178).  boxes [BT, N, 4]."""
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    pos = torch.stack([cx, cy], dim=-1).float()
    return calc_pairwise_distance_3d(pos, pos) > threshold * out_h


class STBilinearMessagePassing(nn.Module):
    """Spatio-temporal bilinear attention over the T*N tokens of a clip,
    with a mask (TCE_STBiP_module.py:12-69; din_tpu/heads/tce.py:181-215):
    feature [B*T, N, in_features], mask [B, T*N, T*N] (True = suppressed;
    a fully suppressed row gives 0) -> [B*T, N, emb_dim]."""

    def __init__(self, emb_dim: int, message_dim: int,
                 generator: torch.Generator, T: int = 3,
                 in_features: Optional[int] = None):
        super().__init__()
        f = in_features or emb_dim
        self.T = T
        self.U = _dense(f, emb_dim, generator)
        self.V = _dense(f, emb_dim, generator)
        self.w_a = nn.Parameter(torch.empty(1, emb_dim))
        kaiming_normal_(self.w_a, generator)
        self.W_e2 = nn.Linear(f, message_dim, bias=False)
        lecun_normal_(self.W_e2.weight, generator)
        self.layernorm = nn.LayerNorm(message_dim)
        self.W_e1 = nn.Linear(message_dim, emb_dim, bias=False)
        lecun_normal_(self.W_e1.weight, generator)

    def forward(self, feature: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        BT, N, F_ = feature.shape
        x = feature.reshape(BT // self.T, self.T * N, F_)
        u = self.U(x) * self.w_a
        uv = torch.bmm(u, self.V(x).transpose(1, 2)).float()
        uv = uv.masked_fill(mask, float("-inf"))
        e = torch.softmax(uv, dim=2).to(x.dtype)
        e = torch.nan_to_num(e, nan=0.0)
        msg = torch.bmm(e, self.W_e2(x))
        out = self.W_e1(torch.relu(self.layernorm(msg)))
        return out.reshape(BT, N, -1)


class MultiHeadSTBilinear(nn.Module):
    """``num_heads`` bilinear heads (``bilinear_list``) fused by their sum
    (plus the input with ``shortcut_connection``) or by concatenation with
    the input appended (TCE_STBiP_module.py:71-103;
    din_tpu/heads/tce.py:218-238)."""

    def __init__(self, emb_dim: int, message_dim: int, num_heads: int,
                 generator: torch.Generator, T: int = 3):
        super().__init__()
        self.bilinear_list = nn.ModuleList(
            STBilinearMessagePassing(emb_dim, message_dim, generator, T=T)
            for _ in range(num_heads))

    def forward(self, feature: torch.Tensor, mask: torch.Tensor,
                fusion_method: str = "sum",
                shortcut_connection: bool = False) -> torch.Tensor:
        outs = [m(feature, mask) for m in self.bilinear_list]
        if fusion_method == "sum":
            out = sum(outs)
            return feature + out if shortcut_connection else out
        return torch.cat(outs + [feature], dim=-1)
