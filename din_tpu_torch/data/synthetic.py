"""Synthetic request fixtures (numpy copy of din_tpu/data/synthetic.py
``make_synthetic_batch``, lines 52-80)."""

from __future__ import annotations

import numpy as np


def make_synthetic_batch(cfg, batch_size, rng=None):
    """One stacked synthetic batch at cfg geometry: uint8 images
    [B,T,H,W,3], boxes [B,T,N,4] in feature pixels, labels; plus
    ``bboxes_num`` for collective configs.  Same draws, in the same order,
    as the JAX package's function for the same ``rng``."""
    rng = rng or np.random.RandomState(0)
    H, W = cfg.image_size
    T, N = cfg.num_frames, cfg.num_boxes
    OH, OW = cfg.out_size
    images = rng.randint(0, 255, (batch_size, T, H, W, 3)).astype(np.uint8)
    x1 = rng.uniform(0, max(OW - 2, 1), (batch_size, T, N))
    y1 = rng.uniform(0, max(OH - 2, 1), (batch_size, T, N))
    boxes = np.stack([x1, y1, x1 + 1.5, y1 + 1.5], -1).astype(np.float32)
    actions = rng.randint(0, cfg.num_actions,
                          (batch_size, T, N)).astype(np.int32)
    activities = rng.randint(0, cfg.num_activities,
                             (batch_size, T)).astype(np.int32)
    batch = {"images": images, "boxes": boxes, "actions": actions,
             "activities": activities}
    if cfg.dataset_name == "collective":
        bn = np.repeat(rng.randint(1, N + 1, (batch_size, 1)), T,
                       axis=1).astype(np.int32)
        mask = np.arange(N)[None, None, :] < bn[:, :, None]
        batch["actions"] = np.where(mask, actions, -1).astype(np.int32)
        batch["bboxes_num"] = bn
    return batch
