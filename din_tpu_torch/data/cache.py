"""Decoded-frame LRU cache: byte-budgeted, thread-safe (port of
din_tpu/data/cache.py:30-106).

The reference decodes every JPEG from disk on every epoch
(volleyball.py:223-244, collective.py:140-160 — one ``Image.open`` per
frame inside ``__getitem__``), so JPEG decode is a steady-state per-epoch
cost.  Training revisits every frame once per epoch (and the stage-2
window policies re-read subsets of the same 10-frame clip directory), so
caching the decoded+resized uint8 frames in host RAM removes the decode
term entirely from epoch 2 onward — on decode-bound hosts this is the
difference between the loader feeding the card or not (PERF.md, input
row).

Keyed by ``(path, H, W)``; least-recently-used frames are evicted to keep
the total under a byte budget.  A 720x1280 uint8 frame is ~2.7 MB, so a
4 GB budget holds ~1500 frames (150 volleyball clips); size it to the
host via ``cfg.decode_cache_mb`` (0 = off).  Misses within one clip are
decoded in a single batched native call (din_tpu_torch/native) to keep the
batching win of the native path.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from din_tpu_torch import native


class FrameCache:
    """LRU cache of decoded uint8 frames with a byte budget.

    Thread-safe: BatchLoader decodes samples from a worker pool.  The
    lock only guards map bookkeeping — decode itself runs unlocked, so
    concurrent misses don't serialise (a frame raced by two workers is
    decoded twice and inserted once; harmless and rare).
    """

    def __init__(self, budget_mb: float):
        self.budget_bytes = int(budget_mb * (1 << 20))
        self._map: "OrderedDict[Tuple[str, int, int], np.ndarray]" = \
            OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._map)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def _get(self, key):
        with self._lock:
            arr = self._map.get(key)
            if arr is not None:
                self._map.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return arr

    def _put(self, key, arr: np.ndarray):
        if arr.nbytes > self.budget_bytes:
            return                       # larger than the whole budget
        with self._lock:
            if key in self._map:
                return
            self._map[key] = arr
            self._bytes += arr.nbytes
            while self._bytes > self.budget_bytes:
                _, old = self._map.popitem(last=False)
                self._bytes -= old.nbytes

    def load_frames(self, paths: List[str], height: int,
                    width: int) -> np.ndarray:
        """Cached equivalent of ``native.load_frames``: [T, H, W, 3] u8."""
        keys = [(p, height, width) for p in paths]
        frames: Dict[int, np.ndarray] = {}
        miss_idx = []
        for i, key in enumerate(keys):
            arr = self._get(key)
            if arr is None:
                miss_idx.append(i)
            else:
                frames[i] = arr
        if miss_idx:
            decoded = native.load_frames([paths[i] for i in miss_idx],
                                         height, width)
            for j, i in enumerate(miss_idx):
                arr = np.ascontiguousarray(decoded[j])
                arr.setflags(write=False)   # shared across epochs
                self._put(keys[i], arr)
                frames[i] = arr
        return np.stack([frames[i] for i in range(len(paths))])


def make_cache(cfg) -> "FrameCache | None":
    """cfg.decode_cache_mb > 0 -> a FrameCache, else None (decode-per-read,
    the reference behaviour)."""
    budget = cfg.decode_cache_mb
    return FrameCache(budget) if budget > 0 else None
