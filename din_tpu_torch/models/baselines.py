"""Stage-2 baseline models (port of din_tpu/models/baselines.py:49-302;
reference infer_model.py:472-1131, gcn_model.py:89-433): PCTDM, HiGCIN,
AT, ARG and SACRF+BiUTE on Volleyball, and the legacy GCN trainer's
GCNNet for Volleyball and Collective Activity.

Each runs the shared trunk (the backbone in frame chunks, RoIAlign, kernel
K1 forward and K1b backward when the backbone trains) and, but for HiGCIN,
which works on the raw RoI features, the actor embedding ``fc_emb_1`` +
``nl_emb_1`` + ReLU; then its head in float32.  Parameters are float32, the
backbone computes in ``cfg.compute_dtype``; without ``cfg.train_backbone``
the backbone is frozen (no gradient, no K1b, no update; its BatchNorm still
trains when ``train and not cfg.set_bn_eval``).  ``dropout_global`` (rate
``cfg.train_dropout_prob``) and the heads' fixed-rate dropouts draw from
their own seeded generators.  Module names are the reference's, which are
the keys of din_tpu's ``export_model_state`` (din_tpu/nn/ref_export.py
:221-295), so its files and ``jax_params_to_state_dict`` output load with
``load_state_dict(strict=True)``.

ARG and GCNNet score a clip of more frames than ``cfg.num_frames`` (and a
multiple of 3) in eval as three crops of T/3 frames, averaged
(``_three_crop``, gcn_model.py:161-165, 247-250): the Volleyball loader's
fixed 9-frame eval order for ARG (data/volleyball.py) is three interleaved
3-frame clips.  All models take ``model(images, boxes, bboxes_num)``; only
``GCNNetCollective`` reads the count.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from din_tpu_torch.heads.arg import GCNModule
from din_tpu_torch.heads.at import ActorTransformer
from din_tpu_torch.heads.higcin import CrossInferBlock
from din_tpu_torch.heads.pctdm import PCTDM
from din_tpu_torch.heads.positional import boxes_position_embedding
from din_tpu_torch.heads.sacrf_biute import SACRF, BiUTE
from din_tpu_torch.models.trunk import embed_actors, trunk_from_cfg
from din_tpu_torch.nn.backbones import build_backbone
from din_tpu_torch.nn.layers import SeededDropout, kaiming_linear
from din_tpu_torch.utils.masking import mask_actors, masked_max


def _three_crop(images: torch.Tensor, boxes: torch.Tensor):
    """Eval-time 3-crop split: [B, T] -> [3B, T/3]
    (gcn_model.py:161-165, infer_model.py:939-943)."""
    B, T = images.shape[:2]
    return (images.reshape(B * 3, T // 3, *images.shape[2:]),
            boxes.reshape(B * 3, T // 3, *boxes.shape[2:]))


def _three_crop_average(scores: torch.Tensor) -> torch.Tensor:
    """[3B, G] -> [B, G] (gcn_model.py:247-250)."""
    return scores.reshape(scores.shape[0] // 3, 3, -1).mean(dim=1)


def _dropout_global(cfg) -> SeededDropout:
    return SeededDropout(cfg.train_dropout_prob, cfg.train_random_seed + 1)


class _Baseline(nn.Module):
    """The backbone and the optional actor embedding (``fc_emb_1``,
    ``nl_emb_1``) the baselines share."""

    def __init__(self, cfg, generator: torch.Generator, embed: bool = True):
        super().__init__()
        self.cfg = cfg
        self.backbone = build_backbone(cfg.backbone, generator)
        if embed:
            K = cfg.crop_size[0] * cfg.crop_size[1]
            self.fc_emb_1 = kaiming_linear(K * cfg.emb_features,
                                           cfg.num_features_boxes, generator)
            self.nl_emb_1 = nn.LayerNorm(cfg.num_features_boxes)

    def _freeze_backbone(self) -> None:
        if not self.cfg.train_backbone:
            # the port's trainable_mask (din_tpu/train/optim.py:20-31)
            self.backbone.requires_grad_(False)

    def _roi(self, images, boxes) -> torch.Tensor:
        """RoI features [B,T,N,KH,KW,D] in the compute dtype."""
        return trunk_from_cfg(self.cfg, self.backbone, images, boxes,
                              self.training)

    def _features(self, images, boxes) -> torch.Tensor:
        """[B,T,N,NFB] f32: ReLU(nl_emb_1(fc_emb_1(RoI features)))."""
        return embed_actors(self._roi(images, boxes), self.fc_emb_1,
                            self.nl_emb_1)

    def _three_crop_of(self, images) -> bool:
        """Eval of a clip longer than the training clips, in thirds."""
        T = images.shape[1]
        return not self.training and T % 3 == 0 and T > self.cfg.num_frames


class PCTDMVolleyball(_Baseline):
    """infer_model.py:472-608: PCTDM's team descriptors per frame,
    LayerNorm over [T, 2000] (``pctdm_nl``), ReLU, dropout, the classifier,
    the mean over frames.  -> {'activities': [B,G]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator)
        self.pctdm = PCTDM(cfg.num_boxes, cfg.num_features_boxes, generator)
        width = 2 * self.pctdm.hidden
        self.pctdm_nl = nn.LayerNorm((cfg.num_frames, width))
        self.dropout_global = _dropout_global(cfg)
        self.fc_activities = kaiming_linear(width, cfg.num_activities,
                                            generator)
        self._freeze_backbone()

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        B, T = images.shape[:2]
        x = self.pctdm(self._features(images, boxes)).reshape(B, T, -1)
        x = self.dropout_global(torch.relu(self.pctdm_nl(x)))
        return {"activities": self.fc_activities(x).mean(dim=1)}


class HiGCINVolleyball(_Baseline):
    """infer_model.py:611-733: the BIM over each person's T x K^2 body
    grid of raw RoI features, the mean over the grid, the PIM over the
    T x N persons, dropout 0.5, the max over persons, a bias-free
    classifier, the mean over frames.  -> {'activities': [B,G]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator, embed=False)
        D = cfg.emb_features
        self.BIM = CrossInferBlock(D, generator)
        self.PIM = CrossInferBlock(D, generator)
        self.dropout = SeededDropout(0.5, cfg.train_random_seed + 2)
        self.fc_activities = kaiming_linear(D, cfg.num_activities, generator,
                                            bias=False)
        self._freeze_backbone()

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        B, T, N = boxes.shape[:3]
        roi = self._roi(images, boxes)                      # [B,T,N,K,K,D]
        D = roi.shape[-1]
        # per person its body grid [B*N, T, K*K, D]
        x = roi.reshape(B, T, N, -1, D).float().transpose(1, 2)
        x = self.BIM(x.reshape(B * N, T, -1, D)).mean(dim=2)  # [B*N,T,D]
        x = self.PIM(x.reshape(B, N, T, D).transpose(1, 2))   # [B,T,N,D]
        pooled = self.dropout(x).amax(dim=2)
        return {"activities": self.fc_activities(pooled).mean(dim=1)}


class ATVolleyball(_Baseline):
    """infer_model.py:736-867: the boxes' sine encoding added to the actor
    features, the Actor Transformer over each frame's actors (or, with
    ``cfg.temporal_pooled_first``, over the frame-averaged actors), the max
    over actors, the classifier (and the mean over frames).
    -> {'activities': [B,G]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator)
        nfb = cfg.num_features_boxes
        self.AT = ActorTransformer(nfb, generator,
                                   seed=cfg.train_random_seed + 2)
        self.fc_activities = kaiming_linear(nfb, cfg.num_activities,
                                            generator)
        self._freeze_backbone()

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        feats = boxes_position_embedding(self._features(images, boxes),
                                         boxes, cfg.image_size, cfg.out_size)
        B, T, N, C = feats.shape
        if cfg.temporal_pooled_first:
            pooled = self.AT(feats.mean(dim=1)).amax(dim=1)      # [B,C]
            return {"activities": self.fc_activities(pooled)}
        x = self.AT(feats.reshape(B * T, N, C)).reshape(B, T, N, C)
        return {"activities": self.fc_activities(x.amax(dim=2)).mean(dim=1)}


class _GCNModel(_Baseline):
    """The ARG layers of ARG and GCNNet (``gcn_list``) over the T*N actor
    tokens of a clip, with their residual: GCN(feats) + feats."""

    def __init__(self, cfg, generator: torch.Generator, ln_shape):
        super().__init__(cfg, generator)
        self.gcn_list = nn.ModuleList(
            GCNModule(cfg.num_features_gcn, cfg.num_features_relation,
                      cfg.num_graph, cfg.pos_threshold, cfg.out_size[1],
                      ln_shape, generator)
            for _ in range(cfg.gcn_layers))
        self.dropout_global = _dropout_global(cfg)

    def _states(self, feats, boxes, token_mask=None) -> torch.Tensor:
        """feats [B,T,N,NFG] -> the dropped-out states [B,T,N,NFG]."""
        B, T, N, NFG = feats.shape
        graph = feats.reshape(B, T * N, NFG)
        flat_boxes = boxes.reshape(B, T * N, 4)
        for gcn in self.gcn_list:
            graph, _ = gcn(graph, flat_boxes, token_mask)
        return self.dropout_global(graph.reshape(B, T, N, NFG) + feats)


class ARGVolleyball(_GCNModel):
    """infer_model.py:870-1023: GCN layers and their residual, the max
    over actors, the classifier, the mean over frames; 3-crop eval.
    -> {'activities': [B,G]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator, (cfg.num_frames * cfg.num_boxes,
                                          cfg.num_features_gcn))
        self.fc_activities = kaiming_linear(cfg.num_features_gcn,
                                            cfg.num_activities, generator)
        self._freeze_backbone()

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        three_crop = self._three_crop_of(images)
        if three_crop:
            images, boxes = _three_crop(images, boxes)
        states = self._states(self._features(images, boxes), boxes)
        scores = self.fc_activities(states.amax(dim=2)).mean(dim=1)
        return {"activities": _three_crop_average(scores) if three_crop
                else scores}


class SACRFBiUTEVolleyball(_Baseline):
    """infer_model.py:1026-1131: SACRF over the actor features, BiUTE's
    group descriptor per frame, the classifier, the mean over frames.
    -> {'actions': [B*N,A] (SACRF's posteriors, averaged over frames),
    'activities': [B,G], 'halting': the halting loss, 'boxes_states':
    [B,T,N,NFB]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator)
        nfb = cfg.num_features_boxes
        self.SACRF = SACRF(nfb, cfg.num_actions, cfg.image_size,
                           cfg.out_size, generator,
                           seed=cfg.train_random_seed + 2)
        self.BiUTE = BiUTE(nfb, cfg.num_boxes, generator)
        self.fc_activities = kaiming_linear(2 * nfb, cfg.num_activities,
                                            generator)
        self._freeze_backbone()

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        B, N = boxes.shape[0], boxes.shape[2]
        q_hat, c_v, halt_loss = self.SACRF(self._features(images, boxes),
                                           boxes)
        scores = self.fc_activities(self.BiUTE(c_v))
        return {"actions": q_hat.mean(dim=1).reshape(B * N, -1),
                "activities": scores.mean(dim=1), "halting": halt_loss,
                "boxes_states": c_v}


class GCNNetVolleyball(_GCNModel):
    """The legacy stage-2 trainer's model (gcn_model.py:89-253): ARG's
    GCN and residual with an action head beside the activity head; 3-crop
    eval.  -> {'actions': [B*N,A], 'activities': [B,G]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator, (cfg.num_frames * cfg.num_boxes,
                                          cfg.num_features_gcn))
        nfg = cfg.num_features_gcn
        self.fc_actions = kaiming_linear(nfg, cfg.num_actions, generator)
        self.fc_activities = kaiming_linear(nfg, cfg.num_activities,
                                            generator)
        self._freeze_backbone()

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        three_crop = self._three_crop_of(images)
        if three_crop:
            images, boxes = _three_crop(images, boxes)
        B, N = boxes.shape[0], boxes.shape[2]
        states = self._states(self._features(images, boxes), boxes)
        actions = self.fc_actions(states).mean(dim=1)        # [B,N,A]
        activities = self.fc_activities(states.amax(dim=2)).mean(dim=1)
        if three_crop:
            actions = actions.reshape(B // 3, 3, N, -1).mean(dim=1)
            activities = _three_crop_average(activities)
        return {"actions": actions.reshape(-1, actions.shape[-1]),
                "activities": activities}


class GCNNetCollective(_GCNModel):
    """The legacy collective GCN model (gcn_model.py:258-433), batched
    with masks where the reference loops over the clips: the first frame's
    actor count masks the padded actors out of the graph (``token_mask``;
    each graph's LayerNorm over [NFG]), their features are zeroed and they
    are left out of the max over actors; 3-crop eval.
    -> {'actions': [B*MAX_N,A], 'activities': [B,G],
    'actions_mask': [B*MAX_N]}."""

    def __init__(self, cfg, generator: torch.Generator):
        super().__init__(cfg, generator, (cfg.num_features_gcn,))
        nfg = cfg.num_features_gcn
        self.fc_actions = kaiming_linear(nfg, cfg.num_actions, generator)
        self.fc_activities = kaiming_linear(nfg, cfg.num_activities,
                                            generator)
        self._freeze_backbone()

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                bboxes_num: torch.Tensor) -> Dict[str, torch.Tensor]:
        three_crop = self._three_crop_of(images)
        if three_crop:
            images, boxes = _three_crop(images, boxes)
            bboxes_num = bboxes_num.reshape(images.shape[:2])
        B, T, N = boxes.shape[:3]
        feats = self._features(images, boxes)
        n_valid = bboxes_num.to(feats.device)[:, 0]
        mask = (torch.arange(N, device=feats.device)[None, None]
                < n_valid[:, None, None]).expand(B, T, N)
        feats = mask_actors(feats, mask[..., None])
        states = self._states(feats, boxes, mask.reshape(B, T * N))
        actions = self.fc_actions(states).mean(dim=1)        # [B,N,A]
        pooled = masked_max(states, mask[..., None], dim=2)  # [B,T,C]
        activities = self.fc_activities(pooled).mean(dim=1)
        amask = mask[:, 0]
        if three_crop:
            actions = actions.reshape(B // 3, 3, N, -1).mean(dim=1)
            activities = _three_crop_average(activities)
            amask = amask.reshape(B // 3, 3, N)[:, 0]
        return {"actions": actions.reshape(-1, actions.shape[-1]),
                "activities": activities,
                "actions_mask": amask.reshape(-1)}
