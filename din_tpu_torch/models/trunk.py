"""Shared trunk, forward only (port of din_tpu/models/trunk.py ``Trunk`` and
``EmbedActors``; reference base_model.py:85-121, infer_model.py:161-186).

uint8 frames [B,T,H,W,3] -> [-1,1] in the compute dtype -> backbone in frame
chunks -> RoIAlign (kernel K1) of every actor box -> channel-major flatten
[D,K,K] -> ``fc_emb_1`` -> ``nl_emb_1`` -> ReLU.

The JAX trunk scans frame chunks so that training holds one chunk's
activations; serving keeps the same ``_auto_chunk`` rule, which bounds the
memory of one backbone call.  The JAX trunk flattens RoI features
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
                  chunk: int) -> torch.Tensor:
    """images [B,T,H,W,3] uint8; boxes [B,T,N,4] feature-map coords.
    Returns RoI features [B,T,N,KH,KW,D] in the compute dtype."""
    B, T, H, W, _ = images.shape
    N = boxes.shape[2]
    frames = images.reshape(B * T, H, W, 3)
    feats = torch.cat([backbone(prep_images(frames[s:s + chunk],
                                            compute_dtype))
                       for s in range(0, B * T, chunk)])
    if tuple(feats.shape[1:3]) != tuple(out_size):
        raise NotImplementedError(
            f"backbone map {tuple(feats.shape[1:3])} != out_size "
            f"{tuple(out_size)}: the align-corners resize comes with the "
            f"Inception-v3 slice (ROADMAP.md)")
    roi = roi_align(feats, boxes.reshape(B * T, N, 4).float(), crop_size)
    KH, KW = crop_size
    return roi.reshape(B, T, N, KH, KW, roi.shape[-1])


def embed_actors(roi: torch.Tensor, fc_emb_1: nn.Linear,
                 nl_emb_1: nn.LayerNorm) -> torch.Tensor:
    """roi [B,T,N,KH,KW,D] -> ReLU(LN(fc_emb_1(flatten [D,KH,KW]))) in f32
    (infer_model.py:184-186)."""
    B, T, N = roi.shape[:3]
    x = roi.permute(0, 1, 2, 5, 3, 4).reshape(B, T, N, -1).float()
    return torch.relu(nl_emb_1(fc_emb_1(x)))
