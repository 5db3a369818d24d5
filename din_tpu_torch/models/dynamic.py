"""Stage-2 DIN models (port of din_tpu/models/dynamic.py
``DynamicVolleyball``, ``_lite_bottleneck`` and ``_din_readout``, lines
41-94, and ``DynamicCollective``, lines 137-176; reference
infer_model.py:15-234, 1135-1319).

Parameters in f32; the backbone computes in ``cfg.compute_dtype``, the head
(``fc_emb_1`` onward) in f32, as in the JAX package. In train mode
``dropout_global`` drops with its own seeded generator; without
``cfg.train_backbone`` the backbone is frozen (no gradient, no update).
Module names are the reference's, so ``jax_params_to_state_dict`` output and
reference checkpoints load with ``load_state_dict(strict=True)``: the
collective model's one DIN field is ``DPI.*`` itself (``Dynamic_collective``
holds a ``Dynamic_Person_Inference``, infer_model.py:1174-1185), the
volleyball model's fields are ``DPI.DIMlist.{i}.*``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from din_tpu_torch.heads.din import (DynamicPersonInference,
                                     MultiDynamicInference)
from din_tpu_torch.models.trunk import embed_actors, trunk_from_cfg
from din_tpu_torch.nn.backbones import build_backbone
from din_tpu_torch.nn.layers import (SeededDropout, kaiming_normal_,
                                     lecun_normal_)
from din_tpu_torch.utils.masking import mask_actors, masked_max


def _linear(i: int, o: int, generator: torch.Generator) -> nn.Linear:
    """nn.Linear with the reference's kaiming-normal init, zero bias."""
    m = nn.Linear(i, o)
    kaiming_normal_(m.weight, generator)
    nn.init.zeros_(m.bias)
    return m


def _din_kwargs(cfg) -> dict:
    return dict(stride=cfg.stride, dynamic_sampling=cfg.dynamic_sampling,
                sampling_ratio=tuple(cfg.sampling_ratio), group=cfg.group,
                scale_factor=cfg.scale_factor, beta_factor=cfg.beta_factor,
                parallel_inference=cfg.parallel_inference)


class _DynamicModel(nn.Module):
    """The trunk and actor embedding both DIN models share, and the lite
    bottleneck: 1x1 conv NFB -> lite + LayerNorm([T,N,lite]) + ReLU
    (infer_model.py:108-111,188-193).  ``self.dim`` is the head's width."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__()
        if cfg.hierarchical_inference:
            raise NotImplementedError(
                "HierarchicalDynamicInference is not ported yet: it comes "
                "with the remaining heads, §1 item 7 of ROADMAP.md")
        self.cfg = cfg
        T, N = cfg.num_frames, cfg.num_boxes
        K = cfg.crop_size[0] * cfg.crop_size[1]
        nfb = cfg.num_features_boxes

        self.backbone = build_backbone(cfg.backbone, generator)
        self.fc_emb_1 = _linear(K * cfg.emb_features, nfb, generator)
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

    def _actor_features(self, images, boxes) -> torch.Tensor:
        """[B,T,N,dim] f32 actor features before the DIN head."""
        roi = trunk_from_cfg(self.cfg, self.backbone, images, boxes,
                             self.training)
        feats = embed_actors(roi, self.fc_emb_1, self.nl_emb_1)
        if self.cfg.lite_dim:
            w = self.point_conv.weight.flatten(1)
            feats = torch.relu(self.point_ln(
                F.linear(feats, w, self.point_conv.bias)))
        return feats


class DynamicVolleyball(_DynamicModel):
    """images [B,T,H,W,3] uint8, boxes [B,T,N,4] -> {'activities': [B,G]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator)
        T, N, dim = cfg.num_frames, cfg.num_boxes, self.dim
        self.DPI = MultiDynamicInference(
            dim, generator, kernel_sizes=cfg.kernel_sizes, **_din_kwargs(cfg))
        self.dpi_nl = nn.LayerNorm((T, N, dim))
        self.dropout_global = SeededDropout(cfg.train_dropout_prob,
                                            cfg.train_random_seed + 1)
        self.fc_activities = _linear(dim, cfg.num_activities, generator)
        self._freeze_backbone()

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        feats = self._actor_features(images, boxes)
        graph = self.DPI(feats)
        # _din_readout: res18 puts the LayerNorm before the residual, every
        # other backbone after it (infer_model.py:203-216)
        if cfg.backbone == "res18":
            states = torch.relu(self.dpi_nl(graph)) + feats
        else:
            states = torch.relu(self.dpi_nl(graph + feats))
        states = self.dropout_global(states)
        pooled = states.amax(dim=2)                            # [B,T,C]
        return {"activities": self.fc_activities(pooled).mean(dim=1)}


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
        if len(cfg.kernel_sizes) != 1:
            raise ValueError("Dynamic_collective has one DIN field; got "
                             f"ST_kernel_size {cfg.ST_kernel_size!r}")
        self.DPI = DynamicPersonInference(
            self.dim, generator, kernel_size=cfg.kernel_sizes[0],
            **_din_kwargs(cfg))
        self.dpi_nl = nn.LayerNorm((cfg.num_frames, self.dim))
        self.dropout_global = SeededDropout(cfg.train_dropout_prob,
                                            cfg.train_random_seed + 1)
        self.fc_activities = _linear(self.dim, cfg.num_activities, generator)
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
