"""Collective Activity dataset (port of din_tpu/data/collective.py:1-185;
reference collective.py:13-225).

The same parser, draws and padding as din_tpu, so both packages give the
same items bit for bit for the same (seed, epoch, index).  Tab-separated
per-person annotation lines; keeps every 10th frame (frame_id % 10 == 1) with >= 9 following frames;
group activity = majority vote of person actions excluding NA
(collective.py:50-52); boxes normalized by the per-sequence frame size then
scaled to feature coords; actions remapped 6->5 and activities 5->4
(Walking merged into Crossing -> "Moving", collective.py:33-34); pads boxes
with zeros / actions with -1 up to MAX_N and returns the true count.
"""

from __future__ import annotations

import hashlib
import os
import random
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from din_tpu_torch import native
from din_tpu_torch.data.augment import hflip_clip

FRAMES_NUM = {1: 302, 2: 347, 3: 194, 4: 257, 5: 536, 6: 401, 7: 968, 8: 221,
              9: 356, 10: 302, 11: 1813, 12: 1084, 13: 851, 14: 723, 15: 464,
              16: 1021, 17: 905, 18: 600, 19: 203, 20: 342, 21: 650, 22: 361,
              23: 311, 24: 321, 25: 617, 26: 734, 27: 1804, 28: 470, 29: 635,
              30: 356, 31: 690, 32: 194, 33: 193, 34: 395, 35: 707, 36: 914,
              37: 1049, 38: 653, 39: 518, 40: 401, 41: 707, 42: 420, 43: 410,
              44: 356}

FRAMES_SIZE = {i: (480, 720) for i in FRAMES_NUM}
for _i in (15, 20, 21, 22, 23, 24):
    FRAMES_SIZE[_i] = (450, 800)

ACTIONS = ['NA', 'Crossing', 'Waiting', 'Queueing', 'Walking', 'Talking']
ACTIVITIES = ['Crossing', 'Waiting', 'Queueing', 'Walking', 'Talking']
ACTION6_TO_5 = {0: 0, 1: 1, 2: 2, 3: 3, 4: 1, 5: 4}
ACTIVITY5_TO_4 = {0: 0, 1: 1, 2: 2, 3: 0, 4: 3}


def collective_read_annotations(path: str, sid: int) -> Dict[int, dict]:
    """Parse one sequence's annotations.txt (collective.py:37-81)."""
    annotations = {}
    H, W = FRAMES_SIZE[sid]

    def commit(frame_id, actions, bboxes):
        if frame_id is None:
            return
        if frame_id % 10 == 1 and frame_id + 9 <= FRAMES_NUM[sid]:
            counter = Counter(actions).most_common(2)
            # majority vote excluding NA (collective.py:50-52); a frame
            # where EVERY action is NA has no majority to vote on — skip
            # it instead of indexing past most_common (real CAD sequences
            # never produce this; malformed data should not crash parsing)
            if counter[0][0] == 0 and len(counter) == 1:
                return
            group = counter[0][0] - 1 if counter[0][0] != 0 \
                else counter[1][0] - 1
            annotations[frame_id] = {
                "frame_id": frame_id,
                "group_activity": group,
                "actions": list(actions),
                "bboxes": list(bboxes),
            }

    with open(os.path.join(path, "seq%02d" % sid, "annotations.txt")) as f:
        frame_id, actions, bboxes = None, [], []
        for line in f.readlines():
            values = line.rstrip("\n").split("\t")
            fid = int(values[0])
            if fid != frame_id:
                commit(frame_id, actions, bboxes)
                frame_id, actions, bboxes = fid, [], []
            actions.append(int(values[5]) - 1)
            x, y, w, h = (int(values[i]) for i in range(1, 5))
            bboxes.append((y / H, x / W, (y + h) / H, (x + w) / W))
        commit(frame_id, actions, bboxes)
    return annotations


def collective_read_dataset(path: str, seqs: Sequence[int]):
    return {sid: collective_read_annotations(path, sid) for sid in seqs}


def collective_all_frames(anns) -> List[Tuple[int, int]]:
    return [(s, f) for s in anns for f in anns[s]]


class CollectiveDataset:
    """Fixed-shape numpy clip loader (collective.py:95-225)."""

    def __init__(self, anns, frames, images_path, image_size, feature_size,
                 num_boxes=13, num_frames=10, is_training=True,
                 is_finetune=False, seed=0, cache=None, hflip_prob=0.0):
        self.anns = anns
        self.frames = list(frames)
        self.images_path = images_path
        self.image_size = image_size
        self.feature_size = feature_size
        self.num_boxes = num_boxes
        self.num_frames = num_frames
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
        """BatchLoader hook (data/volleyball.py
        ``VolleyballDataset.set_epoch``)."""
        self.epoch = int(epoch)

    def _item_rng(self, index) -> random.Random:
        # per-item generator: concurrent loader threads must not share a
        # Random (draws would depend on thread interleaving; see
        # VolleyballDataset._item_rng)
        key = f"{self.seed}:{self.epoch}:{index}".encode()
        return random.Random(int.from_bytes(
            hashlib.blake2s(key, digest_size=8).digest(), "little"))

    def sample_frames(self, frame, rng=None):
        rng = self.rng if rng is None else rng
        sid, src_fid = frame
        if self.is_finetune and self.is_training:
            fid = rng.randint(src_fid, src_fid + self.num_frames - 1)
            return [(sid, src_fid, fid)]
        return [(sid, src_fid, fid)
                for fid in range(src_fid, src_fid + self.num_frames)]

    def _load_clip_images(self, select):
        # whole-clip native libjpeg decode+resize in one batched call
        # (DCT prescale + bilinear), PIL fallback (din_tpu_torch/native)
        paths = [os.path.join(self.images_path, "seq%02d" % sid,
                              "frame%04d.jpg" % fid)
                 for (sid, _src, fid) in select]
        if self.cache is not None:
            return self.cache.load_frames(paths, *self.image_size)
        return native.load_frames(paths, self.image_size[0],
                                  self.image_size[1])

    def __getitem__(self, index):
        rng = self._item_rng(index)
        select = self.sample_frames(self.frames[index], rng)
        OH, OW = self.feature_size
        clip_images = self._load_clip_images(select)
        images, boxes, actions, activities, counts = [], [], [], [], []
        for fi, (sid, src_fid, fid) in enumerate(select):
            images.append(clip_images[fi])
            ann = self.anns[sid][src_fid]
            frame_boxes = [(x1 * OW, y1 * OH, x2 * OW, y2 * OH)
                           for (y1, x1, y2, x2) in ann["bboxes"]]
            frame_actions = [ACTION6_TO_5[a] for a in ann["actions"]]
            # truncate crowded frames first (a != comparison alone would
            # append zero-boxes forever once len > num_boxes), then zero-pad
            frame_boxes = frame_boxes[:self.num_boxes]
            frame_actions = frame_actions[:self.num_boxes]
            counts.append(len(frame_boxes))
            while len(frame_boxes) < self.num_boxes:
                frame_boxes.append((0, 0, 0, 0))
                frame_actions.append(-1)
            boxes.append(np.asarray(frame_boxes, np.float32))
            actions.append(np.asarray(frame_actions, np.int32))
            activities.append(ACTIVITY5_TO_4[ann["group_activity"]])
        images = np.stack(images)
        boxes = np.stack(boxes)
        counts = np.asarray(counts, np.int32)
        if self.hflip_prob and rng.random() < self.hflip_prob:
            # beyond-reference augmentation (data/augment.py): CAD classes
            # carry no left/right semantics — mirror images + REAL boxes
            # only (zero-padded slots must stay zero)
            mask = np.arange(self.num_boxes)[None, :] < counts[:, None]
            images, boxes, _ = hflip_clip(images, boxes, float(OW),
                                          box_mask=mask)
        return {
            "images": images,
            "boxes": boxes,
            "actions": np.stack(actions),
            "activities": np.asarray(activities, np.int32),
            "bboxes_num": counts,
        }
