"""Synthetic clips (numpy copy of din_tpu/data/synthetic.py
``SyntheticDataset``, lines 8-49, and ``make_synthetic_batch``, lines
52-80).  The same numpy draws in the same order, so the port and the JAX
package see identical clips for the same seed and index.
``data/datasets.py`` ``return_dataset`` serves them for
``data_path="synthetic"`` and reads the Volleyball dataset otherwise."""

from __future__ import annotations

import numpy as np


class SyntheticDataset:
    """Deterministic random clips with the schema of the real datasets:
    item ``index`` is drawn from ``RandomState(seed * 100003 + index)``."""

    def __init__(self, cfg, size=64, is_training=True, seed=0):
        self.cfg = cfg
        self.size = size
        self.is_training = is_training
        self.seed = seed
        self.T = 1 if (cfg.training_stage == 1 and is_training) else \
            cfg.num_frames

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        cfg = self.cfg
        rng = np.random.RandomState(self.seed * 100003 + index)
        H, W = cfg.image_size
        OH, OW = cfg.out_size
        N = cfg.num_boxes
        T = self.T
        images = rng.randint(0, 255, (T, H, W, 3)).astype(np.uint8)
        x1 = rng.uniform(0, max(OW - 2, 1), (T, N))
        y1 = rng.uniform(0, max(OH - 2, 1), (T, N))
        w = rng.uniform(0.5, 2.0, (T, N))
        h = rng.uniform(0.5, 2.0, (T, N))
        boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
        actions = rng.randint(0, cfg.num_actions, (T, N)).astype(np.int32)
        activities = np.full((T,), rng.randint(cfg.num_activities),
                             np.int32)
        sample = {"images": images, "boxes": boxes, "actions": actions,
                  "activities": activities}
        if cfg.dataset_name == "collective":
            n_valid = rng.randint(2, N + 1)
            boxes[:, n_valid:] = 0.0
            actions[:, n_valid:] = -1
            sample["bboxes_num"] = np.full((T,), n_valid, np.int32)
        return sample


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
