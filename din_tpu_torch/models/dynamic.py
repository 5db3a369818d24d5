"""Stage-2 DIN model for volleyball (port of din_tpu/models/dynamic.py
``DynamicVolleyball``, ``_lite_bottleneck`` and ``_din_readout``, lines
41-94; reference infer_model.py:15-234), forward only.

Backbone in ``cfg.compute_dtype``; the head (``fc_emb_1`` onward) in f32,
as in the JAX package.  Module names are the reference's, so
``jax_params_to_state_dict`` output and reference checkpoints load with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from din_tpu_torch.heads.din import MultiDynamicInference
from din_tpu_torch.models.trunk import auto_chunk, embed_actors, trunk_forward
from din_tpu_torch.nn.backbones import build_backbone
from din_tpu_torch.nn.layers import kaiming_normal_, lecun_normal_


def _linear(i: int, o: int, generator: torch.Generator) -> nn.Linear:
    """nn.Linear with the reference's kaiming-normal init, zero bias."""
    m = nn.Linear(i, o)
    kaiming_normal_(m.weight, generator)
    nn.init.zeros_(m.bias)
    return m


class DynamicVolleyball(nn.Module):
    """images [B,T,H,W,3] uint8, boxes [B,T,N,4] -> {'activities': [B,G]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__()
        if cfg.hierarchical_inference:
            raise NotImplementedError(
                "HierarchicalDynamicInference is not ported yet: it comes "
                "with the remaining heads, slice 5 of ROADMAP.md")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        T, N = cfg.num_frames, cfg.num_boxes
        K = cfg.crop_size[0] * cfg.crop_size[1]
        nfb = cfg.num_features_boxes

        self.backbone = build_backbone(cfg.backbone, generator)
        self.fc_emb_1 = _linear(K * cfg.emb_features, nfb, generator)
        self.nl_emb_1 = nn.LayerNorm(nfb)
        dim = nfb
        if cfg.lite_dim:
            # 1x1 conv NFB -> lite + LayerNorm([T,N,lite]) + ReLU
            # (infer_model.py:108-111,188-193)
            self.point_conv = nn.Conv2d(nfb, cfg.lite_dim, 1)
            lecun_normal_(self.point_conv.weight, generator)
            nn.init.zeros_(self.point_conv.bias)
            self.point_ln = nn.LayerNorm((T, N, cfg.lite_dim))
            dim = cfg.lite_dim
        self.DPI = MultiDynamicInference(
            dim, generator, kernel_sizes=cfg.kernel_sizes, stride=cfg.stride,
            dynamic_sampling=cfg.dynamic_sampling,
            sampling_ratio=tuple(cfg.sampling_ratio), group=cfg.group,
            scale_factor=cfg.scale_factor, beta_factor=cfg.beta_factor,
            parallel_inference=cfg.parallel_inference)
        self.dpi_nl = nn.LayerNorm((T, N, dim))
        self.dropout_global = nn.Dropout(cfg.train_dropout_prob)
        self.fc_activities = _linear(dim, cfg.num_activities, generator)
        self.backbone.to(self.compute_dtype)

    def forward(self, images: torch.Tensor,
                boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, T, H, W, _ = images.shape
        chunk = auto_chunk(B * T, H, W, cfg.frame_chunk, cfg.train_backbone)
        roi = trunk_forward(self.backbone, images, boxes,
                            out_size=cfg.out_size, crop_size=cfg.crop_size,
                            compute_dtype=self.compute_dtype, chunk=chunk)
        feats = embed_actors(roi, self.fc_emb_1, self.nl_emb_1)
        if cfg.lite_dim:
            w = self.point_conv.weight.flatten(1)
            feats = torch.relu(self.point_ln(
                F.linear(feats, w, self.point_conv.bias)))
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
