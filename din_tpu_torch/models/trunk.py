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

More than one rank (an ambient mesh, ``parallel/mesh.py``): each rank
runs its own clips' frames (under ``frame_parallel`` its share of its data
group's), chunked as din_tpu chunks the whole step's frames, with a live
BatchNorm's chunk statistics reduced over the ranks a chunk spans
(``FramePlan``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from din_tpu_torch.nn.backbones import BACKBONE_HAS_BN
from din_tpu_torch.nn.layers import ChunkStatistics, chunk_statistics
from din_tpu_torch.ops.image import (prep_images,
                                     resize_bilinear_align_corners)
from din_tpu_torch.ops.roi_align import roi_align, roi_align_multiscale
from din_tpu_torch.parallel.mesh import current_mesh, gather_exact


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
                  bn_train: bool = False, return_map: bool = False,
                  plan: Optional["FramePlan"] = None):
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
    update per chunk), else in eval mode.  With ``plan`` (a ``FramePlan``,
    more than one rank) the backbone takes this rank's share of the frames
    in the plan's calls instead of ``chunk``-frame calls, and under
    ``frame_parallel`` the RoI features (and the map) of the rank's frames
    are gathered over its model group."""
    B, T, H, W, _ = images.shape
    N = boxes.shape[2]
    out_size = tuple(out_size)
    frames = images.reshape(B * T, H, W, 3)
    flat_boxes = boxes.reshape(B * T, N, 4).float()
    backbone.train(bn_train)
    with torch.set_grad_enabled(torch.is_grad_enabled() and train_backbone):
        if plan is None:
            outs = [backbone(prep_images(frames[s:s + chunk], compute_dtype))
                    for s in range(0, B * T, chunk)]
        else:
            frames = frames[plan.start:plan.stop]
            flat_boxes = flat_boxes[plan.start:plan.stop]
            outs = plan.run(backbone, frames, compute_dtype)
    # one map, or a list of maps (Inception-v3), per chunk
    scales = zip(*outs) if isinstance(outs[0], list) else [outs]
    maps = [torch.cat(chunks) for chunks in scales]
    if plan is not None and plan.order is not None:
        maps = [m[plan.order.to(m.device)] for m in maps]
    resize = any(tuple(m.shape[1:3]) != out_size for m in maps)
    if resize and not return_map:
        fmap = None
        roi = roi_align_multiscale(maps, flat_boxes, crop_size, out_size)
    else:
        maps = [resize_bilinear_align_corners(m, out_size) for m in maps]
        fmap = maps[0] if len(maps) == 1 else torch.cat(maps, dim=-1)
        roi = roi_align(fmap, flat_boxes, crop_size)
    if plan is not None and plan.gather is not None:
        roi = plan.gather(roi)
        fmap = None if fmap is None else plan.gather(fmap)
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
    bn_train = train and not cfg.set_bn_eval
    mesh, plan, chunk = current_mesh(), None, None
    if mesh is None:
        chunk = auto_chunk(B * T, H, W, cfg.frame_chunk, cfg.train_backbone)
    else:
        plan = FramePlan(mesh, B * T, H, W, cfg.frame_chunk,
                         cfg.train_backbone,
                         bn_train and BACKBONE_HAS_BN.get(cfg.backbone, True),
                         cfg.shard_local_chunks)
    return trunk_forward(backbone, images, boxes, out_size=cfg.out_size,
                         crop_size=cfg.crop_size,
                         compute_dtype=getattr(torch, cfg.compute_dtype),
                         chunk=chunk, train_backbone=cfg.train_backbone,
                         bn_train=bn_train, return_map=return_map, plan=plan)


class FramePlan:
    """How this rank's frames of a trunk call go through the backbone when
    the frames are split over ranks (din_tpu/models/trunk.py:105-229 with
    an ambient mesh).

    The ranks of the frame axis (``Mesh.frame_group``: the data ranks, or
    every rank under ``frame_parallel``, whose model group first splits its
    data group's frames) hold ``L`` contiguous frames each of the ``F``
    frames of the whole step, in rank order.  The chunk is din_tpu's, chosen
    by ``auto_chunk`` from ``F``, not from ``L``.  Packing (``_pack_extent``
    :144-175): where no BatchNorm is live (or ``shard_local_chunks="on"``)
    and the chunk and ``F`` divide over the ``P`` frame ranks, every rank
    gives ``chunk / P`` of its own frames to every chunk; otherwise chunks
    keep frame order, ``[k*chunk, (k+1)*chunk)``, and one may span ranks.

    The calls: the ``R`` rounds, ``R`` the fewest chunks any frame rank
    touches; chunk ``k`` belongs to round ``k mod R`` on every rank, so a
    chunk that spans ranks is in one round everywhere and no rank sits a
    round out.  A round's call takes the rank's pieces of its chunks.  With
    live BatchNorm each call runs under ``chunk_statistics``: a chunk's
    statistics are reduced over the frame ranks (``TorchBatchNorm``), and
    after the last call they are folded into the running ones in chunk
    order, the same on every rank.  ``order`` puts the outputs back in
    frame order where the rounds took the pieces out of it; ``gather``
    (``frame_parallel``) collects the model group's RoI features."""

    def __init__(self, mesh, n_frames: int, H: int, W: int,
                 frame_chunk: Optional[int], train_backbone: bool,
                 bn_live: bool, shard_local_chunks: str = "auto"):
        M = mesh.model if mesh.frame_parallel else 1
        if n_frames % M:
            raise ValueError(f"{n_frames} frames do not split over the "
                             f"{M} ranks of a model group")
        L = n_frames // M
        self.start = mesh.model_index * L if M > 1 else 0
        self.stop = self.start + L
        P, p = mesh.frame_size, mesh.frame_index
        F = P * L
        chunk = auto_chunk(F, H, W, frame_chunk, train_backbone)
        K = F // chunk
        shard_local = (shard_local_chunks == "on" or (
            shard_local_chunks == "auto" and not bn_live)) and P > 1 \
            and chunk % P == 0
        if shard_local:
            cl = chunk // P
            mine = {k: (k * cl, (k + 1) * cl) for k in range(K)}
            R = K
        else:
            def touched(q):
                return range(q * L // chunk, ((q + 1) * L - 1) // chunk + 1)

            mine = {k: (max(k * chunk, p * L) - p * L,
                        min((k + 1) * chunk, (p + 1) * L) - p * L)
                    for k in touched(p)}
            R = min(len(touched(q)) for q in range(P))
        self.chunk, self.num_chunks = chunk, K
        self.rounds = []                     # (pieces, chunks completed)
        taken = []
        for j in range(R):
            pieces = [(k,) + mine[k] for k in sorted(mine) if k % R == j]
            self.rounds.append((pieces, [k for k in range(K) if k % R == j]))
            taken += [i for _, s, e in pieces for i in range(s, e)]
        self.order = None if taken == list(range(L)) else \
            torch.argsort(torch.tensor(taken))
        self.stats = ChunkStatistics(mesh.frame_group, chunk) \
            if bn_live and P > 1 else None
        self.gather = None
        if M > 1:
            def gather(x, group=mesh.model_group, index=mesh.model_index):
                return gather_exact(x, group, index, M)
            self.gather = gather

    def run(self, backbone: nn.Module, frames: torch.Tensor,
            compute_dtype: torch.dtype) -> list:
        """The backbone's outputs of every round's call, in call order."""
        outs = []
        with chunk_statistics(self.stats):
            for pieces, completed in self.rounds:
                rows, at = [], 0
                for k, s, e in pieces:
                    rows.append((k, at, at + e - s))
                    at += e - s
                x = frames[pieces[0][1]:pieces[0][2]] if len(pieces) == 1 \
                    else torch.cat([frames[s:e] for _, s, e in pieces])
                if self.stats is not None:
                    self.stats.pieces, self.stats.round_chunks = rows, \
                        completed
                outs.append(backbone(prep_images(x, compute_dtype)))
        if self.stats is not None:
            self.stats.fold()
        return outs


def embed_actors(roi: torch.Tensor, fc_emb: nn.Linear,
                 nl_emb: Optional[nn.LayerNorm]) -> torch.Tensor:
    """roi [B,T,N,KH,KW,D] -> ReLU([LN](fc_emb(flatten [D,KH,KW]))) in f32:
    stage 2 with its LayerNorm (infer_model.py:184-186), stage 1 without
    (base_model.py:119-120)."""
    B, T, N = roi.shape[:3]
    x = fc_emb(roi.permute(0, 1, 2, 5, 3, 4).reshape(B, T, N, -1).float())
    return torch.relu(x if nl_emb is None else nl_emb(x))
