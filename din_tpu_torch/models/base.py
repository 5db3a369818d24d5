"""Stage-1 base model for volleyball (port of din_tpu/models/base.py
``BasenetVolleyball``, lines 27-52; reference base_model.py:6-142).

Backbone finetuning with per-actor and per-frame classifiers: the shared
trunk (VGG-16 in frame chunks, RoIAlign, channel-major flatten), then
``fc_emb`` + ReLU + dropout (no LayerNorm, base_model.py:119-121);
``fc_actions`` on every actor, ``fc_activities`` on the max over actors; both
averaged over the frames (base_model.py:138-141).  Parameters and the head
are f32, the backbone computes in ``cfg.compute_dtype``.  Module names are
the reference Basenet's (``backbone.*``, ``fc_emb``, ``fc_actions``,
``fc_activities``), which are the keys of its stage-1 component file.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from din_tpu_torch.models.dynamic import _linear
from din_tpu_torch.models.trunk import auto_chunk, embed_actors, trunk_forward
from din_tpu_torch.nn.backbones import build_backbone
from din_tpu_torch.nn.layers import SeededDropout


class BasenetVolleyball(nn.Module):
    """images [B,T,H,W,3] uint8, boxes [B,T,N,4] ->
    {'actions': [B*N,A], 'activities': [B,G]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        K = cfg.crop_size[0] * cfg.crop_size[1]
        nfb = cfg.num_features_boxes
        self.backbone = build_backbone(cfg.backbone, generator)
        self.fc_emb = _linear(K * cfg.emb_features, nfb, generator)
        self.dropout_emb = SeededDropout(cfg.train_dropout_prob,
                                         cfg.train_random_seed + 1)
        self.fc_actions = _linear(nfb, cfg.num_actions, generator)
        self.fc_activities = _linear(nfb, cfg.num_activities, generator)
        if not cfg.train_backbone:
            self.backbone.requires_grad_(False)

    def forward(self, images: torch.Tensor,
                boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, T, H, W, _ = images.shape
        chunk = auto_chunk(B * T, H, W, cfg.frame_chunk, cfg.train_backbone)
        roi = trunk_forward(self.backbone, images, boxes,
                            out_size=cfg.out_size, crop_size=cfg.crop_size,
                            compute_dtype=self.compute_dtype, chunk=chunk,
                            train_backbone=cfg.train_backbone)
        feats = self.dropout_emb(embed_actors(roi, self.fc_emb, None))
        actions = self.fc_actions(feats)                        # [B,T,N,A]
        activities = self.fc_activities(feats.amax(dim=2))     # [B,T,G]
        return {"actions": actions.mean(dim=1).reshape(B * boxes.shape[2],
                                                       -1),
                "activities": activities.mean(dim=1)}
