"""Losses and in-graph metrics (port of din_tpu/train/losses.py:19-126).

The reference's loss protocol (train_net_dynamic.py:190-216): the sum over
the output keys present of CE(activities) + actions_loss_weight *
weighted-CE(actions) + halting * halting_penalty.  Collective action labels
are padded with -1; a padded entry carries weight 0.  A batch may carry a
``sample_mask`` (padded eval batches), which masks its clips out.

More than one data rank (``group``, the ranks of ``Mesh.data_group``):
each rank's loss is its share of the loss of the global batch.  A mean's
denominator, ``sum(w)``, is all-reduced over the ranks, so the shares of
the weighted actions loss, of Collective's padded (-1) actions and of
masked clips add up to the global batch's loss; the halting loss is a sum
over clips and adds up as it is.  The counters stay per rank; the trainer
sums them over the ranks before it reports them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows by comparison (``F.one_hot`` scatters)."""
    return (labels[..., None] == torch.arange(
        num_classes, device=labels.device)).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None,
                  valid_mask: Optional[torch.Tensor] = None,
                  group=None) -> torch.Tensor:
    """torch ``F.cross_entropy`` semantics: the weighted mean with the weight
    of each sample's true class as denominator; masked samples weigh 0.
    With ``group`` the denominator is the sum over its ranks (this rank's
    share of the global batch's mean)."""
    logits = logits.float()
    safe_labels = labels.long().clamp(0, logits.shape[-1] - 1)
    logp = F.log_softmax(logits, dim=-1)
    # the true class's log-probability as a one-hot sum (exact: one term is
    # not 0), whose backward is a product; gather's would be a scatter-add
    nll = -(logp * _one_hot(safe_labels, logits.shape[-1])).sum(-1)
    if class_weights is not None:
        w = class_weights.to(nll.device)[safe_labels]
    else:
        w = torch.ones_like(nll)
    if valid_mask is not None:
        w = w * valid_mask.to(w.dtype)
    den = torch.sum(w)
    if group is not None:
        den = den.detach().clone()
        dist.all_reduce(den, group=group)
    return torch.sum(nll * w) / torch.clamp(den, min=1e-12)


def accuracy_counts(logits: torch.Tensor, labels: torch.Tensor,
                    valid_mask: Optional[torch.Tensor] = None):
    """(correct, total) of the argmax predictions."""
    correct = logits.argmax(dim=-1) == labels
    if valid_mask is not None:
        correct = correct & valid_mask
        total = valid_mask.sum()
    else:
        total = torch.tensor(labels.numel(), device=labels.device)
    return correct.sum(), total


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int,
                     valid_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """[K, K] float counts, rows = truth (cf. reference utils.py:217-264)."""
    pred = logits.argmax(dim=-1).reshape(-1)
    lab = labels.reshape(-1).long().clamp(0, num_classes - 1)
    onehot_p = _one_hot(pred, num_classes)
    onehot_l = _one_hot(lab, num_classes)
    if valid_mask is not None:
        onehot_l = onehot_l * valid_mask.reshape(-1, 1).float()
    return onehot_l.T @ onehot_p


def compute_losses(outputs: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], cfg,
                   frame0_labels: bool, group=None) -> Dict[str, torch.Tensor]:
    """dict(loss=..., metric pieces).  ``frame0_labels``: stage 2 takes clip
    labels from frame 0 (train_net_dynamic.py:182-184).  ``group``: the
    data ranks whose losses are shares of one global batch's."""
    metrics = {}
    sample_mask = batch.get("sample_mask")                   # [B] or None
    sm_bool = None if sample_mask is None else sample_mask > 0

    activities_in = batch["activities"]                      # [B, T]
    B, T = activities_in.shape
    if frame0_labels:
        act_labels = activities_in[:, 0]
        act_valid = sm_bool
    else:
        act_labels = activities_in.reshape(-1)
        act_valid = None if sm_bool is None else \
            sm_bool.repeat_interleave(T)
    act_scores = outputs["activities"]
    if act_scores.shape[0] != act_labels.shape[0]:
        # volleyball stage 1: scores [B, G] against per-frame labels
        act_labels = activities_in[:, 0]
        act_valid = sm_bool
    a_loss = cross_entropy(act_scores, act_labels, valid_mask=act_valid,
                           group=group)
    loss = a_loss
    c, t = accuracy_counts(act_scores, act_labels, act_valid)
    metrics["activities_loss"] = a_loss
    metrics["activities_correct"] = c
    metrics["activities_total"] = t
    metrics["activities_conf"] = confusion_matrix(
        act_scores, act_labels, cfg.num_activities, act_valid)

    if "actions" in outputs:
        actions_in = batch["actions"]                        # [B, T, N]
        act_mask = outputs.get("actions_mask")
        B, T, N = actions_in.shape
        if outputs["actions"].shape[0] == B * N:
            labels = actions_in[:, 0].reshape(-1)            # frame 0
            per_clip = N
        else:                                                # per frame
            labels = actions_in.reshape(-1)
            per_clip = T * N
        valid = labels >= 0
        if act_mask is not None:
            valid = valid & act_mask.reshape(-1)
        if sm_bool is not None:
            valid = valid & sm_bool.repeat_interleave(per_clip)
        wl = cfg.action_weight_list
        weights = None if wl is None else torch.tensor(wl,
                                                       dtype=torch.float32)
        ac_loss = cross_entropy(outputs["actions"], labels, weights, valid,
                                group)
        loss = loss + cfg.actions_loss_weight * ac_loss
        c, t = accuracy_counts(outputs["actions"], labels, valid)
        metrics["actions_loss"] = ac_loss
        metrics["actions_correct"] = c
        metrics["actions_total"] = t

    if "halting" in outputs:
        loss = loss + outputs["halting"] * cfg.halting_penalty

    metrics["loss"] = loss
    return metrics
