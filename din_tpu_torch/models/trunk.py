"""Shared trunk (port of din_tpu/models/trunk.py ``Trunk`` and
``EmbedActors``; reference base_model.py:85-121, infer_model.py:161-186).

uint8 frames [B,T,H,W,3] -> [-1,1] in the compute dtype -> backbone in frame
chunks -> RoIAlign (kernel K1) of every actor box -> channel-major flatten
[D,K,K] -> ``fc_emb_1`` -> ``nl_emb_1`` -> ReLU.

The JAX trunk scans frame chunks, rematerialising each chunk's early
convs, so that training fits the TPU's 16 GB; the port keeps the same
``_auto_chunk`` rule, which bounds the memory of one backbone call, and
keeps every chunk's activations for the backward (no checkpointing: the
card has 80 GB).  A backbone with BatchNorm (ResNet-18) stays live under
chunking as in the JAX trunk (trunk.py:241-254): each chunk normalises with
its own batch statistics and folds them into the running ones, chunk after
chunk in frame order; BN trains exactly when ``bn_train`` (the model's
``train and not cfg.set_bn_eval``), also with a frozen backbone, where no
gradient flows (trunk.py:296-297), and otherwise uses the running
statistics.  The JAX trunk flattens RoI features
position-major and ``export_model_state`` permutes ``fc_emb_1`` to the
reference's channel-major order (ref_export.py:212-218); the port flattens
channel-major like the reference, so the exported weight loads as it is.
The modules belong to the model, so their state_dict keys are the
reference's (``backbone.*``, ``fc_emb_1``, ``nl_emb_1``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from din_tpu_torch.ops.image import prep_images
from din_tpu_torch.ops.roi_align import roi_align


def auto_chunk(n_frames: int, H: int, W: int, frame_chunk: Optional[int],
               train_backbone: bool) -> int:
    """Frames per backbone call (din_tpu/models/trunk.py:211-229)."""
    if frame_chunk:
        chunk = min(frame_chunk, n_frames)
        while n_frames % chunk:      # largest divisor <= requested
            chunk -= 1
        return chunk
    if not train_backbone:
        return n_frames
    budget_pixels = 8 * 768 * 1280          # ~8 full-HD frames
    per_chunk = max(1, budget_pixels // max(H * W, 1))
    if per_chunk >= n_frames:
        return n_frames
    while n_frames % per_chunk or (per_chunk > 8 and per_chunk % 8):
        per_chunk -= 1
    return max(per_chunk, 1)


def trunk_forward(backbone: nn.Module, images: torch.Tensor,
                  boxes: torch.Tensor, *, out_size: Tuple[int, int],
                  crop_size: Tuple[int, int], compute_dtype: torch.dtype,
                  chunk: int, train_backbone: bool,
                  bn_train: bool = False, return_map: bool = False):
    """images [B,T,H,W,3] uint8; boxes [B,T,N,4] feature-map coords.
    Returns RoI features [B,T,N,KH,KW,D] in the compute dtype and, with
    ``return_map``, also the backbone's map [B*T,OH,OW,D] they were pooled
    from (the JAX trunk's ``outputs``, trunk.py:327; TCE attends over it).
    Without ``train_backbone`` the backbone runs with no gradient (the JAX
    trunk's ``stop_gradient``, trunk.py:296-297), and so does the map; with
    it, a gradient into the map reaches the backbone.  ``bn_train`` puts
    the backbone's BatchNorms in training mode (batch statistics, running
    update per chunk), else in eval mode."""
    B, T, H, W, _ = images.shape
    N = boxes.shape[2]
    frames = images.reshape(B * T, H, W, 3)
    backbone.train(bn_train)
    with torch.set_grad_enabled(torch.is_grad_enabled() and train_backbone):
        feats = torch.cat([backbone(prep_images(frames[s:s + chunk],
                                                compute_dtype))
                           for s in range(0, B * T, chunk)])
    if tuple(feats.shape[1:3]) != tuple(out_size):
        raise NotImplementedError(
            f"backbone map {tuple(feats.shape[1:3])} != out_size "
            f"{tuple(out_size)}: the align-corners resize comes with "
            f"Inception-v3, ROADMAP.md §1 item 5")
    roi = roi_align(feats, boxes.reshape(B * T, N, 4).float(), crop_size)
    KH, KW = crop_size
    roi = roi.reshape(B, T, N, KH, KW, roi.shape[-1])
    return (roi, feats) if return_map else roi


def trunk_from_cfg(cfg, backbone: nn.Module, images: torch.Tensor,
                   boxes: torch.Tensor, train: bool,
                   return_map: bool = False):
    """``trunk_forward`` with the knobs of ``cfg`` (the one place they map,
    as din_tpu/models/trunk.py:330-349): the chunk of ``auto_chunk``, the
    compute dtype, and BatchNorm in training mode exactly when ``train and
    not cfg.set_bn_eval``."""
    B, T, H, W, _ = images.shape
    chunk = auto_chunk(B * T, H, W, cfg.frame_chunk, cfg.train_backbone)
    return trunk_forward(backbone, images, boxes, out_size=cfg.out_size,
                         crop_size=cfg.crop_size,
                         compute_dtype=getattr(torch, cfg.compute_dtype),
                         chunk=chunk, train_backbone=cfg.train_backbone,
                         bn_train=train and not cfg.set_bn_eval,
                         return_map=return_map)


def embed_actors(roi: torch.Tensor, fc_emb: nn.Linear,
                 nl_emb: Optional[nn.LayerNorm]) -> torch.Tensor:
    """roi [B,T,N,KH,KW,D] -> ReLU([LN](fc_emb(flatten [D,KH,KW]))) in f32:
    stage 2 with its LayerNorm (infer_model.py:184-186), stage 1 without
    (base_model.py:119-120)."""
    B, T, N = roi.shape[:3]
    x = fc_emb(roi.permute(0, 1, 2, 5, 3, 4).reshape(B, T, N, -1).float())
    return torch.relu(x if nl_emb is None else nl_emb(x))
