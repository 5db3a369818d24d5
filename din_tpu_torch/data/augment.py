"""Horizontal-flip augmentation with correct left/right label semantics
(copy of din_tpu/data/augment.py:1-48).

The reference trains with NO augmentation (volleyball.py:223-275 loads,
resizes, nothing else) — so ``cfg.hflip_prob`` defaults to 0 and parity
runs must keep it there.  It exists because volleyball's activity classes
are side-dependent (``r_set`` … ``l_winpoint``): a naive mirror would
teach the model wrong labels, so the flip swaps the l_/r_ activity pair
(per-actor actions are side-agnostic).  Collective Activity classes carry
no side semantics — only images and real boxes mirror there, and
zero-padded box slots must stay zero (``box_mask``).

Boxes are in FEATURE-map coordinates (x1,y1,x2,y2 — volleyball.py:246-251),
so the mirror is x' = OW - x with x1/x2 swapped to keep x1 <= x2.

Flip decisions draw from the dataset's per-item generator
(data/volleyball.py ``_item_rng``), so a flipped item is still a pure
function of (seed, epoch, index).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# ACTIVITIES = [r_set, r_spike, r-pass, r_winpoint,
#               l_set, l-spike, l-pass, l_winpoint] (volleyball.py:19-22)
VOLLEY_ACTIVITY_HFLIP = np.asarray([4, 5, 6, 7, 0, 1, 2, 3], np.int32)


def hflip_clip(images: np.ndarray, boxes: np.ndarray, feature_width: float,
               activities: Optional[np.ndarray] = None,
               activity_map: Optional[np.ndarray] = None,
               box_mask: Optional[np.ndarray] = None):
    """Mirror a clip.  images [T,H,W,3]; boxes [T,N,4] feature coords;
    box_mask [T,N] True = real actor (padding rows pass through
    unchanged); activity_map int[num_activities] label remap.
    Returns (images, boxes, activities)."""
    images = np.ascontiguousarray(images[:, :, ::-1])
    x1, y1 = boxes[..., 0], boxes[..., 1]
    x2, y2 = boxes[..., 2], boxes[..., 3]
    flipped = np.stack([feature_width - x2, y1,
                        feature_width - x1, y2], -1).astype(boxes.dtype)
    if box_mask is not None:
        flipped = np.where(box_mask[..., None], flipped, boxes)
    if activities is not None and activity_map is not None:
        activities = activity_map[np.asarray(activities)]
    return images, flipped, activities
