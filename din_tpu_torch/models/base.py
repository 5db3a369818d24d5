"""Stage-1 base models (port of din_tpu/models/base.py ``BasenetVolleyball``
and ``BasenetCollective``, lines 27-86; reference base_model.py:6-284).

Backbone finetuning with per-actor and per-frame classifiers: the shared
trunk (the backbone in frame chunks, RoIAlign, channel-major flatten), then
``fc_emb`` + ReLU + dropout (no LayerNorm, base_model.py:119-121);
``fc_actions`` on every actor, ``fc_activities`` on the max over actors.
Volleyball averages both over the frames (base_model.py:138-141).  The
collective model keeps every frame and, where the reference loops over the
clips slicing each frame's true actor count (base_model.py:258-276), masks
the padded actors out of the max over actors and flags them in
``actions_mask`` for the loss.  Parameters and the head are f32, the
backbone computes in ``cfg.compute_dtype``.  Module names are the reference
Basenet's (``backbone.*``, ``fc_emb``, ``fc_actions``, ``fc_activities``),
which are the keys of its stage-1 component file.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from din_tpu_torch.models.trunk import embed_actors, trunk_from_cfg
from din_tpu_torch.nn.backbones import build_backbone
from din_tpu_torch.nn.layers import SeededDropout, kaiming_linear
from din_tpu_torch.utils.masking import masked_max


class _Basenet(nn.Module):
    """The modules both Basenets share."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        K = cfg.crop_size[0] * cfg.crop_size[1]
        nfb = cfg.num_features_boxes
        self.backbone = build_backbone(cfg.backbone, generator)
        self.fc_emb = kaiming_linear(K * cfg.emb_features, nfb, generator)
        self.dropout_emb = SeededDropout(cfg.train_dropout_prob,
                                         cfg.train_random_seed + 1)
        self.fc_actions = kaiming_linear(nfb, cfg.num_actions, generator)
        self.fc_activities = kaiming_linear(nfb, cfg.num_activities,
                                            generator)
        if not cfg.train_backbone:
            self.backbone.requires_grad_(False)

    def _features(self, images, boxes) -> torch.Tensor:
        """[B,T,N,NFB]: ReLU(fc_emb(RoI features)), dropped out in
        training."""
        roi = trunk_from_cfg(self.cfg, self.backbone, images, boxes,
                             self.training)
        return self.dropout_emb(embed_actors(roi, self.fc_emb, None))


class BasenetVolleyball(_Basenet):
    """images [B,T,H,W,3] uint8, boxes [B,T,N,4] ->
    {'actions': [B*N,A], 'activities': [B,G]}."""

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        B = images.shape[0]
        feats = self._features(images, boxes)
        actions = self.fc_actions(feats)                        # [B,T,N,A]
        activities = self.fc_activities(feats.amax(dim=2))     # [B,T,G]
        return {"actions": actions.mean(dim=1).reshape(B * boxes.shape[2],
                                                       -1),
                "activities": activities.mean(dim=1)}


class BasenetCollective(_Basenet):
    """images [B,T,H,W,3] uint8, boxes [B,T,MAX_N,4], bboxes_num [B,T] (the
    true actor count of each frame) -> {'actions': [B*T*MAX_N,A],
    'activities': [B*T,G], 'actions_mask': [B*T*MAX_N]}."""

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, T = images.shape[:2]
        N = boxes.shape[2]
        feats = self._features(images, boxes)
        # the padded actors' boxes are zeros and their actions -1
        # (collective.py:199-203)
        mask = torch.arange(N, device=feats.device)[None, None] \
            < bboxes_num.to(feats.device)[:, :, None]          # [B,T,N]
        actions = self.fc_actions(feats)
        pooled = masked_max(feats, mask[..., None], dim=2)     # [B,T,NFB]
        activities = self.fc_activities(pooled)
        return {"actions": actions.reshape(B * T * N, -1),
                "activities": activities.reshape(B * T, -1),
                "actions_mask": mask.reshape(B * T * N)}
