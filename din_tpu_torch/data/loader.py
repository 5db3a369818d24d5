"""Batching of a dataset for training and eval (port of din_tpu/data/
loader.py ``BatchLoader``, lines 35-125), in one process.

The shuffle order is a pure function of (seed, epoch): ``set_epoch`` pins
the epoch and ``np.random.RandomState(seed + epoch)`` permutes the indices,
as the JAX loader does, so both frameworks draw the same batches.
``drop_last`` drops a final partial batch (training); ``pad_last`` instead
fills it by cycling its samples and marks the padding in
``batch['sample_mask']`` (eval). One worker thread makes the next batch
while the current one is used (the JAX loader's decode-ahead). ``to_device``
copies a numpy batch into pinned host memory and on to the card with
``non_blocking=True``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


class BatchLoader:
    """Yields numpy batches (dicts of arrays stacked on a leading axis)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 pad_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last and not pad_last
        self.pad_last = pad_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch (torch ``DistributedSampler`` convention);
        without it each iteration advances the epoch by one."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _batch(self, order: np.ndarray, b: int) -> Dict[str, np.ndarray]:
        idx = order[b * self.batch_size:(b + 1) * self.batch_size]
        n_real = len(idx)
        if self.pad_last and n_real < self.batch_size:
            idx = np.resize(idx, self.batch_size)            # cycle
        samples = [self.dataset[int(i)] for i in idx]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        if self.pad_last:
            mask = np.zeros(self.batch_size, np.float32)
            mask[:n_real] = 1.0
            batch["sample_mask"] = mask
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Batches in order; one thread makes the next batch while the
        caller consumes this one (numpy's draws and copies release the
        interpreter lock)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        nb = len(self)
        if nb == 0:
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(self._batch, order, 0)
            for b in range(nb):
                batch = pending.result()
                if b + 1 < nb:
                    pending = pool.submit(self._batch, order, b + 1)
                yield batch


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; through pinned host memory and
    an asynchronous copy when the device is the card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
