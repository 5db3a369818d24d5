"""Volleyball dataset: annotation parsing, frame sampling, clip loading
(port of din_tpu/data/volleyball.py:19-210; reference volleyball.py:19-275).

The same parser, draws and padding as din_tpu, so both packages give the
same items bit for bit for the same (seed, epoch, index).  Annotation
grammar per video (volleyball.py:30-65): one line per clip =
``frame.jpg activity (x y w h action) x N``; person boxes are converted
xywh -> (y1,x1,y2,x2).  Track boxes come from ``tracks_normalized.pkl``
(normalized y1,x1,y2,x2 per frame window) and are scaled to feature-map
coordinates (x1*OW, y1*OH, x2*OW, y2*OH) (volleyball.py:246-251).

Frames are returned as uint8 HWC (normalisation happens on the device) and
actor padding by repetition (volleyball.py:258-260) happens here, so
batches are fixed-shape.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from din_tpu_torch import native
from din_tpu_torch.data.augment import VOLLEY_ACTIVITY_HFLIP, hflip_clip

ACTIVITIES = ['r_set', 'r_spike', 'r-pass', 'r_winpoint',
              'l_set', 'l-spike', 'l-pass', 'l_winpoint']
NUM_ACTIVITIES = 8
ACTIONS = ['blocking', 'digging', 'falling', 'jumping',
           'moving', 'setting', 'spiking', 'standing', 'waiting']
NUM_ACTIONS = 9

_GACT_TO_ID = {n: i for i, n in enumerate(ACTIVITIES)}
_ACT_TO_ID = {n: i for i, n in enumerate(ACTIONS)}


def volley_read_annotations(path: str) -> Dict[int, dict]:
    """Parse one video's annotations.txt (volleyball.py:30-65)."""
    annotations = {}
    with open(path) as f:
        for line in f.readlines():
            values = line.rstrip("\n").split(" ")
            file_name = values[0]
            activity = _GACT_TO_ID[values[1]]
            person_values = values[2:]
            num_people = len(person_values) // 5
            actions, bboxes = [], []
            for i in range(num_people):
                x, y, w, h = map(int, person_values[5 * i:5 * i + 4])
                actions.append(_ACT_TO_ID[person_values[5 * i + 4]])
                bboxes.append((y, x, y + h, x + w))
            fid = int(file_name.split(".")[0])
            annotations[fid] = {
                "file_name": file_name,
                "group_activity": activity,
                "actions": actions,
                "bboxes": np.asarray(bboxes, np.float64),
            }
    return annotations


def volley_read_dataset(path: str, seqs: Sequence[int]):
    return {sid: volley_read_annotations(os.path.join(path, str(sid),
                                                      "annotations.txt"))
            for sid in seqs}


def volley_all_frames(data) -> List[Tuple[int, int]]:
    return [(sid, fid) for sid, anns in data.items() for fid in anns]


def volley_random_frames(data, num_frames: int,
                         rng: Optional[np.random.RandomState] = None
                         ) -> List[Tuple[int, int]]:
    """num_frames (sid, fid) pairs sampled with replacement over videos,
    then one random clip within each chosen video (reference
    volleyball.py:83-88; unused by the training pipelines there, kept for
    parity).  rng defaults to numpy's global state like the reference."""
    rng = rng or np.random
    sids = rng.choice(list(data.keys()), num_frames)
    return [(int(sid), int(rng.choice(list(data[sid])))) for sid in sids]


def load_tracks(data_path: str):
    with open(os.path.join(data_path, "tracks_normalized.pkl"), "rb") as f:
        return pickle.load(f)


class VolleyballDataset:
    """Fixed-shape numpy clip loader (volleyball.py:144-275)."""

    def __init__(self, anns, tracks, frames, images_path, image_size,
                 feature_size, inference_module_name, num_boxes=12,
                 num_before=4, num_after=4, is_training=True,
                 is_finetune=False, seed=0, cache=None, hflip_prob=0.0):
        self.anns = anns
        self.tracks = tracks
        self.frames = list(frames)
        self.images_path = images_path
        self.image_size = image_size
        self.feature_size = feature_size
        self.inference_module_name = inference_module_name
        self.num_boxes = num_boxes
        self.num_before = num_before
        self.num_after = num_after
        self.is_training = is_training
        self.is_finetune = is_finetune
        self.rng = random.Random(seed)      # direct-call fallback only
        self.seed = seed
        self.epoch = 0
        self.cache = cache          # FrameCache | PackedFrameStore | None
        self.hflip_prob = hflip_prob if is_training else 0.0

    def __len__(self):
        return len(self.frames)

    def set_epoch(self, epoch: int) -> None:
        """BatchLoader hook: pins the draw epoch so item content is a pure
        function of (seed, epoch, index) — see _item_rng."""
        self.epoch = int(epoch)

    def _item_rng(self, index) -> random.Random:
        # per-item generator: BatchLoader decodes items from CONCURRENT
        # worker threads, so drawing from one shared Random would make
        # frame sampling/hflip depend on thread interleaving — breaking the
        # (seed, epoch)-purity that exact mid-epoch resume relies on
        # (the loader's set_epoch contract)
        key = f"{self.seed}:{self.epoch}:{index}".encode()
        return random.Random(int.from_bytes(
            hashlib.blake2s(key, digest_size=8).digest(), "little"))

    # frame-window sampling policies (volleyball.py:189-219)
    def sample_frames(self, frame, rng=None):
        rng = self.rng if rng is None else rng
        sid, src_fid = frame
        lo, hi = src_fid - self.num_before, src_fid + self.num_after
        if self.is_finetune:
            if self.is_training:
                fid = rng.randint(lo, hi)
                return [(sid, src_fid, fid)]
            return [(sid, src_fid, fid) for fid in range(lo, hi + 1)]
        if self.inference_module_name == "arg_volleyball":
            if self.is_training:
                fids = rng.sample(range(lo, hi + 1), 3)
                return [(sid, src_fid, fid) for fid in fids]
            # fixed 9-frame ordering (volleyball.py:212-214)
            order = [src_fid - 3, src_fid, src_fid + 3,
                     src_fid - 4, src_fid - 1, src_fid + 2,
                     src_fid - 2, src_fid + 1, src_fid + 4]
            return [(sid, src_fid, fid) for fid in order]
        return [(sid, src_fid, fid) for fid in range(lo, hi + 1)]

    def _load_clip_images(self, select):
        # whole-clip native libjpeg decode+resize in one batched call
        # (DCT prescale + bilinear), PIL fallback (din_tpu_torch/native)
        paths = [os.path.join(self.images_path, str(sid), str(src_fid),
                              f"{fid}.jpg") for (sid, src_fid, fid) in select]
        if self.cache is not None:
            return self.cache.load_frames(paths, *self.image_size)
        return native.load_frames(paths, self.image_size[0],
                                  self.image_size[1])

    def __getitem__(self, index):
        rng = self._item_rng(index)
        select = self.sample_frames(self.frames[index], rng)
        OH, OW = self.feature_size
        clip_images = self._load_clip_images(select)
        images, boxes, actions, activities = [], [], [], []
        for fi, (sid, src_fid, fid) in enumerate(select):
            images.append(clip_images[fi])
            tracks = np.asarray(self.tracks[(sid, src_fid)][fid], np.float64)
            y1, x1, y2, x2 = tracks.T
            frame_boxes = np.stack([x1 * OW, y1 * OH, x2 * OW, y2 * OH], -1)
            frame_actions = list(self.anns[sid][src_fid]["actions"])
            # pad-by-repetition to num_boxes (volleyball.py:258-260;
            # cycling generalises the reference's single-pass repeat to
            # frames missing more than half the roster)
            if len(frame_boxes) == 0:
                # repetition cannot grow an empty roster — without this
                # check the while loop below would spin a worker forever
                raise ValueError(
                    f"frame (sid={sid}, src_fid={src_fid}, fid={fid}) has "
                    f"no annotated boxes; cannot pad to {self.num_boxes}")
            while len(frame_boxes) < self.num_boxes:
                need = self.num_boxes - len(frame_boxes)
                frame_boxes = np.concatenate(
                    [frame_boxes, frame_boxes[:need]], axis=0)
                frame_actions = frame_actions + frame_actions[:need]
            frame_boxes = frame_boxes[:self.num_boxes]
            frame_actions = frame_actions[:self.num_boxes]
            boxes.append(frame_boxes.astype(np.float32))
            actions.append(np.asarray(frame_actions, np.int32))
            activities.append(self.anns[sid][src_fid]["group_activity"])
        images = np.stack(images)                             # [T,H,W,3] u8
        boxes = np.stack(boxes)                               # [T,N,4] f32
        activities = np.asarray(activities, np.int32)         # [T]
        if self.hflip_prob and rng.random() < self.hflip_prob:
            # beyond-reference augmentation (data/augment.py): mirror with
            # the l_/r_ activity swap; per-actor actions are side-agnostic
            images, boxes, activities = hflip_clip(
                images, boxes, float(OW), activities,
                VOLLEY_ACTIVITY_HFLIP)
        return {
            "images": images,
            "boxes": boxes,
            "actions": np.stack(actions),                     # [T,N] i32
            "activities": activities,
        }
