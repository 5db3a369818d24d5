"""Stage-2 DIN models (port of din_tpu/models/dynamic.py ``_make_dpi``,
``DynamicVolleyball``, ``_lite_bottleneck`` and ``_din_readout``, lines
27-94, ``DynamicTCEVolleyball``, lines 97-134, and ``DynamicCollective``,
lines 137-176; reference infer_model.py:15-468, 1135-1319).

Parameters in f32; the backbone computes in ``cfg.compute_dtype``, the head
(``fc_emb_1`` onward) in f32, as in the JAX package. In train mode
``dropout_global`` drops with its own seeded generator; without
``cfg.train_backbone`` the backbone is frozen (no gradient, no update).
Module names are the reference's, so ``jax_params_to_state_dict`` output and
reference checkpoints load with ``load_state_dict(strict=True)``: the
collective model's one DIN field is ``DPI.*`` itself (``Dynamic_collective``
holds a ``Dynamic_Person_Inference``, infer_model.py:1174-1185), the
volleyball model's fields are ``DPI.DIMlist.{i}.*``, or ``DPI.DPI_1.*``,
``DPI.hier_LN.*`` and ``DPI.DPI_2.*`` with ``cfg.hierarchical_inference``;
the TCE model's context encoder is
``multilayer_head_embfeature_context_encoding.CET.*``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from din_tpu_torch.heads.din import (DynamicPersonInference,
                                     HierarchicalDynamicInference,
                                     MultiDynamicInference)
from din_tpu_torch.heads.positional import context_position_embedding_sine
from din_tpu_torch.heads.tce import MultiHeadTCE
from din_tpu_torch.models.trunk import embed_actors, trunk_from_cfg
from din_tpu_torch.nn.backbones import build_backbone
from din_tpu_torch.nn.layers import (SeededDropout, kaiming_linear,
                                     lecun_normal_)
from din_tpu_torch.utils.masking import mask_actors, masked_max


def _din_kwargs(cfg) -> dict:
    return dict(stride=cfg.stride, dynamic_sampling=cfg.dynamic_sampling,
                sampling_ratio=tuple(cfg.sampling_ratio), group=cfg.group,
                scale_factor=cfg.scale_factor, beta_factor=cfg.beta_factor,
                parallel_inference=cfg.parallel_inference)


def _make_dpi(cfg, dim: int, generator: torch.Generator) -> nn.Module:
    """The volleyball models' DIN head: two stacked fields with
    ``cfg.hierarchical_inference``, else the fields of ``cfg.kernel_sizes``
    summed (din_tpu/models/dynamic.py:27-37)."""
    if cfg.hierarchical_inference:
        return HierarchicalDynamicInference(
            dim, generator, (cfg.num_frames, cfg.num_boxes),
            kernel_sizes=cfg.kernel_sizes,
            dropout_seed=cfg.train_random_seed + 2, **_din_kwargs(cfg))
    return MultiDynamicInference(dim, generator,
                                 kernel_sizes=cfg.kernel_sizes,
                                 **_din_kwargs(cfg))


class _DynamicModel(nn.Module):
    """The trunk and actor embedding both DIN models share, and the lite
    bottleneck: 1x1 conv NFB -> lite + LayerNorm([T,N,lite]) + ReLU
    (infer_model.py:108-111,188-193).  ``self.dim`` is the head's width."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        T, N = cfg.num_frames, cfg.num_boxes
        K = cfg.crop_size[0] * cfg.crop_size[1]
        nfb = cfg.num_features_boxes

        self.backbone = build_backbone(cfg.backbone, generator)
        self.fc_emb_1 = kaiming_linear(K * cfg.emb_features, nfb, generator)
        self.nl_emb_1 = nn.LayerNorm(nfb)
        self.dim = nfb
        if cfg.lite_dim:
            self.point_conv = nn.Conv2d(nfb, cfg.lite_dim, 1)
            lecun_normal_(self.point_conv.weight, generator)
            nn.init.zeros_(self.point_conv.bias)
            self.point_ln = nn.LayerNorm((T, N, cfg.lite_dim))
            self.dim = cfg.lite_dim

    def _freeze_backbone(self) -> None:
        if not self.cfg.train_backbone:
            # the port's trainable_mask (din_tpu/train/optim.py:20-31)
            self.backbone.requires_grad_(False)

    def _actor_features(self, images, boxes, return_map: bool = False):
        """[B,T,N,dim] f32 actor features before the DIN head, and with
        ``return_map`` the backbone's map [B*T,OH,OW,D] too."""
        roi = trunk_from_cfg(self.cfg, self.backbone, images, boxes,
                             self.training, return_map=return_map)
        if return_map:
            roi, fmap = roi
        feats = embed_actors(roi, self.fc_emb_1, self.nl_emb_1)
        if self.cfg.lite_dim:
            w = self.point_conv.weight.flatten(1)
            feats = torch.relu(self.point_ln(
                F.linear(feats, w, self.point_conv.bias)))
        return (feats, fmap) if return_map else feats


class DynamicVolleyball(_DynamicModel):
    """images [B,T,H,W,3] uint8, boxes [B,T,N,4] -> {'activities': [B,G]}.
    The DIN head is ``cfg.kernel_sizes``' fields summed, or the two stacked
    fields of ``HierarchicalDynamicInference`` with
    ``cfg.hierarchical_inference``.  With ``return_mad`` the output also
    holds the DIN head's MAD nodes, ``mad_features`` [B,T,N,k2,C], and their
    centres, the head's input ``mad_center`` [B,T,N,C]
    (din_tpu/models/dynamic.py:73-95); it is the only model that returns
    them (``returns_mad``)."""

    returns_mad = True

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator)
        self._build_head(self.dim, generator)

    def _build_head(self, dim: int, generator: torch.Generator) -> None:
        """DIN over [B,T,N,dim], ``dpi_nl``, dropout and the readout."""
        cfg = self.cfg
        self.DPI = _make_dpi(cfg, dim, generator)
        self.dpi_nl = nn.LayerNorm((cfg.num_frames, cfg.num_boxes, dim))
        self.dropout_global = SeededDropout(cfg.train_dropout_prob,
                                            cfg.train_random_seed + 1)
        self.fc_activities = kaiming_linear(dim, cfg.num_activities,
                                            generator)
        self._freeze_backbone()

    def _readout(self, feats: torch.Tensor, return_mad: bool = False
                 ) -> Dict[str, torch.Tensor]:
        graph = self.DPI(feats, return_mad=return_mad)
        if return_mad:
            graph, mad = graph
        # _din_readout: res18 puts the LayerNorm before the residual, every
        # other backbone after it (infer_model.py:203-216)
        if self.cfg.backbone == "res18":
            states = torch.relu(self.dpi_nl(graph)) + feats
        else:
            states = torch.relu(self.dpi_nl(graph + feats))
        states = self.dropout_global(states)
        pooled = states.amax(dim=2)                            # [B,T,C]
        out = {"activities": self.fc_activities(pooled).mean(dim=1)}
        if return_mad:
            out["mad_features"] = mad
            out["mad_center"] = feats
        return out

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None,
                return_mad: bool = False) -> Dict[str, torch.Tensor]:
        return self._readout(self._actor_features(images, boxes),
                             return_mad)


class DynamicTCEVolleyball(DynamicVolleyball):
    """DynamicVolleyball with the TCE context encoder
    (infer_model.py:237-468): the actor features (after the optional lite
    bottleneck) attend over the last backbone map plus its sine position
    encoding (downscale 16, C/2 features per axis) through ``MultiHeadTCE``
    (4 heads of 128 features, one layer) per frame, and the 512 context
    features are concatenated to them before the DIN head, whose width is
    therefore dim + 512.  The map keeps the backbone's gradient when it
    trains and has none when it is frozen, as the trunk gives it.
    images [B,T,H,W,3] uint8, boxes [B,T,N,4] -> {'activities': [B,G]}."""

    num_heads_context = 4
    num_features_context = 128
    returns_mad = False             # din_tpu's forward takes no return_mad

    def __init__(self, cfg, generator: torch.Generator):
        _DynamicModel.__init__(self, cfg, generator)
        self.multilayer_head_embfeature_context_encoding = MultiHeadTCE(
            self.dim, cfg.emb_features, generator,
            num_heads=self.num_heads_context, num_layers=1,
            num_features_context=self.num_features_context,
            seed=cfg.train_random_seed + 3)
        self._build_head(
            self.dim + self.num_heads_context * self.num_features_context,
            generator)

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        feats, fmap = self._actor_features(images, boxes, return_map=True)
        B, T, N, _ = feats.shape
        context = context_position_embedding_sine(
            fmap.float(), downscale_ratio=16,
            num_pos_feats=fmap.shape[-1] // 2)
        tce = self.multilayer_head_embfeature_context_encoding(
            feats.reshape(B * T, N, -1), context)
        return self._readout(torch.cat(
            [feats, tce.reshape(B, T, N, -1).to(feats.dtype)], dim=-1))


class DynamicCollective(_DynamicModel):
    """images [B,T,H,W,3] uint8, boxes [B,T,MAX_N,4], bboxes_num [B,T] ->
    {'activities': [B,G]}.  The reference slices the first frame's actor
    count for the whole clip (infer_model.py:1289), so the mask comes from
    ``bboxes_num[:, 0]``; padded actors' features are zeroed after the
    embedding, before the DIN head, and left out of the max over actors.
    After ``graph + feats`` a per-actor LayerNorm over (T, C) (``dpi_nl``,
    infer_model.py:1201,1299-1302), ReLU and dropout."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator)
        if cfg.hierarchical_inference:
            raise NotImplementedError(
                "the hierarchical DIN head is ported for the volleyball "
                "models only; no preset puts it on Dynamic_collective")
        if len(cfg.kernel_sizes) != 1:
            raise ValueError("Dynamic_collective has one DIN field; got "
                             f"ST_kernel_size {cfg.ST_kernel_size!r}")
        self.DPI = DynamicPersonInference(
            self.dim, generator, kernel_size=cfg.kernel_sizes[0],
            **_din_kwargs(cfg))
        self.dpi_nl = nn.LayerNorm((cfg.num_frames, self.dim))
        self.dropout_global = SeededDropout(cfg.train_dropout_prob,
                                            cfg.train_random_seed + 1)
        self.fc_activities = kaiming_linear(self.dim, cfg.num_activities,
                                            generator)
        self._freeze_backbone()

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self._actor_features(images, boxes)            # [B,T,N,C]
        B, T, N, _ = feats.shape
        n_valid = bboxes_num.to(feats.device)[:, 0]
        mask = (torch.arange(N, device=feats.device)[None, None]
                < n_valid[:, None, None]).expand(B, T, N)[..., None]
        feats = mask_actors(feats, mask)
        states = (self.DPI(feats) + feats).transpose(1, 2)    # [B,N,T,C]
        states = self.dropout_global(torch.relu(self.dpi_nl(states)))
        pooled = masked_max(states.transpose(1, 2), mask, dim=2)  # [B,T,C]
        return {"activities": self.fc_activities(pooled).mean(dim=1)}
