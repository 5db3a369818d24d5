"""Shared trunk (port of din_tpu/models/trunk.py ``Trunk`` and
``EmbedActors``; reference base_model.py:85-121, infer_model.py:161-186).

uint8 frames [B,T,H,W,3] -> [-1,1] in the compute dtype -> backbone in frame
chunks -> RoIAlign (kernel K1) of every actor box -> channel-major flatten
[D,K,K] -> ``fc_emb_1`` -> ``nl_emb_1`` -> ReLU.

A backbone gives one map or, Inception-v3, a list of maps at two scales.
Boxes are in the pixels of an ``out_size`` map; the reference resizes every
map to ``out_size`` with align corners and concatenates them
(infer_model.py:164-179).  As in the JAX trunk (trunk.py:299-316), a map of
another size has the resize composed into RoIAlign's rows
(``ops/roi_align.py`` ``roi_align_multiscale``: K1 on the map of
``out_size``, two products on the other), unless the caller asks for the
map itself: then each map is resized (``ops/image.py``), they are
concatenated and ``roi_align`` pools the result, the same function.

The JAX trunk scans frame chunks, rematerialising each chunk's early
convs, so that training fits the TPU's 16 GB; the port keeps the same
``_auto_chunk`` rule, which bounds the memory of one backbone call, and
keeps every chunk's activations for the backward (no checkpointing: the
card has 80 GB).  A backbone with BatchNorm (ResNet-18 and -50,
Inception-v3) stays live under
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

from din_tpu_torch.ops.image import (prep_images,
                                     resize_bilinear_align_corners)
from din_tpu_torch.ops.roi_align import roi_align, roi_align_multiscale


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
    """images [B,T,H,W,3] uint8; boxes [B,T,N,4] in the pixels of an
    ``out_size`` map.  Returns RoI features [B,T,N,KH,KW,D] in the compute
    dtype (D the channels of every map together) and, with ``return_map``,
    also the map [B*T,OH,OW,D] they were pooled from, the JAX trunk's
    ``multiscale`` (trunk.py:327; TCE attends over it): the backbone's map
    itself where it is ``out_size``, else the resized and concatenated
    maps (where din_tpu's fused two-scale path returns None).  Without
    ``train_backbone`` the backbone runs with no gradient (the JAX trunk's
    ``stop_gradient``, trunk.py:296-297), and so does the map; with it, a
    gradient into the map reaches the backbone.  ``bn_train`` puts the
    backbone's BatchNorms in training mode (batch statistics, running
    update per chunk), else in eval mode."""
    B, T, H, W, _ = images.shape
    N = boxes.shape[2]
    out_size = tuple(out_size)
    frames = images.reshape(B * T, H, W, 3)
    backbone.train(bn_train)
    with torch.set_grad_enabled(torch.is_grad_enabled() and train_backbone):
        outs = [backbone(prep_images(frames[s:s + chunk], compute_dtype))
                for s in range(0, B * T, chunk)]
    # one map, or a list of maps (Inception-v3), per chunk
    scales = zip(*outs) if isinstance(outs[0], list) else [outs]
    maps = [torch.cat(chunks) for chunks in scales]
    flat_boxes = boxes.reshape(B * T, N, 4).float()
    resize = any(tuple(m.shape[1:3]) != out_size for m in maps)
    if resize and not return_map:
        fmap = None
        roi = roi_align_multiscale(maps, flat_boxes, crop_size, out_size)
    else:
        maps = [resize_bilinear_align_corners(m, out_size) for m in maps]
        fmap = maps[0] if len(maps) == 1 else torch.cat(maps, dim=-1)
        roi = roi_align(fmap, flat_boxes, crop_size)
    KH, KW = crop_size
    roi = roi.reshape(B, T, N, KH, KW, roi.shape[-1])
    return (roi, fmap) if return_map else roi


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
