"""Batching of a dataset and its way onto the device (port of din_tpu/data/
loader.py ``BatchLoader`` :35-136 and ``prefetch_to_device`` :139-173).

``BatchLoader`` decodes the items of upcoming batches on ``num_workers``
threads (the native JPEG decoder and PIL release the interpreter lock), up
to ``decode_ahead`` batches ahead of the one being used, and stacks them
into fixed-shape numpy batches (uint8 frames).  The shuffle order is a pure
function of (seed, epoch): ``set_epoch`` pins the epoch,
``np.random.RandomState(seed + epoch)`` permutes the indices and the
dataset's own per-item draws are pinned to the same epoch, so item content
is a pure function of (seed, epoch, index) whatever the thread
interleaving, and both frameworks draw the same batches.  ``drop_last``
drops a final partial batch (training); ``pad_last`` instead fills it by
cycling its samples and marks the padding in ``batch['sample_mask']``
(eval).  Every process takes a strided slice of the shared permutation
(``process_index``/``process_count``).  With ``even_batches`` every
process yields the same number of batches, as ranks that step together
need (each batch is a step of all, with collectives): ``drop_last`` counts
the smallest slice's full batches, ``pad_last`` the largest slice's
batches, a slice that runs out yielding batches of its own samples
cycled, wholly masked; without it (din_tpu's loader) each process counts
its own slice's.

``prefetch_to_device`` puts batches on the device ``size`` ahead of the
step on a producer thread: on the card it pins each batch, copies it with
``non_blocking=True`` on its own stream and records an event; the consumer's
stream waits on that event, and every tensor is ``record_stream``-ed onto
it, so the caching allocator does not hand its memory to a later copy while
a step still reads it.  On the CPU it is the same thread without streams.
``to_device`` copies one batch.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


class BatchLoader:
    """Yields numpy batches (dicts of arrays stacked on a leading axis);
    ``batch_size`` is the per-process batch size."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 pad_last: bool = False, process_index: int = 0,
                 process_count: int = 1, decode_ahead: int = 2,
                 even_batches: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        # threads beyond the host's cores only thrash
        self.num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        self.seed = seed
        self.drop_last = drop_last and not pad_last
        self.pad_last = pad_last
        self.process_index = process_index
        self.process_count = process_count
        self.even_batches = even_batches
        self.decode_ahead = max(1, decode_ahead)
        self.epoch = 0
        self._skip = 0

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Pin the shuffle epoch (torch ``DistributedSampler.set_epoch``
        convention); without it each iteration advances the epoch by one.
        ``skip_batches`` drops the first n batches of the next iteration
        without decoding them (resume in the middle of an epoch)."""
        self.epoch = epoch
        self._skip = skip_batches

    def __len__(self) -> int:
        n, pc = len(self.dataset), self.process_count
        if not self.even_batches:
            n = len(range(self.process_index, n, pc))
        elif self.drop_last:
            n = n // pc                    # the smallest slice
        else:
            n = -(-n // pc)                # the largest slice
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # the same seed on every process -> the same permutation ->
            # disjoint strided shards
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.process_count > 1:
            order = order[self.process_index::self.process_count]
        if hasattr(self.dataset, "set_epoch"):
            # pins the dataset's per-item draws (frame sampling, hflip)
            self.dataset.set_epoch(self.epoch)
        self.epoch += 1
        nb = len(self)
        if self._skip:
            order = order[self._skip * self.batch_size:]
            nb = max(0, nb - self._skip)
            self._skip = 0
        # decode-ahead ring: the sample futures of up to `decode_ahead`
        # batches are in flight while the caller uses the current one
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            ring = []

            def submit(b):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                n_real = len(idx)
                if self.pad_last and n_real < self.batch_size:
                    # cycle (a slice that ran out: its last samples)
                    idx = np.resize(idx if n_real else
                                    order[-self.batch_size:], self.batch_size)
                ring.append((n_real, [pool.submit(self.dataset.__getitem__,
                                                  int(i)) for i in idx]))

            for b in range(min(self.decode_ahead, nb)):
                submit(b)
            next_b = len(ring)
            while ring:
                n_real, futures = ring.pop(0)
                samples = [f.result() for f in futures]
                if next_b < nb:
                    submit(next_b)
                    next_b += 1
                batch = {k: np.stack([s[k] for s in samples])
                         for k in samples[0]}
                if self.pad_last:
                    mask = np.zeros(self.batch_size, np.float32)
                    mask[:n_real] = 1.0
                    batch["sample_mask"] = mask
                yield batch
        finally:
            # a consumer that stops early leaves decodes queued: drop them
            pool.shutdown(wait=True, cancel_futures=True)


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; through pinned host memory and
    an asynchronous copy on the current stream when the device is the
    card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]], device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of ``batches`` as tensors on ``device``, copied ``size``
    ahead of the consumer by a producer thread.  An exception of the
    producer (a corrupt frame, a failed copy) is raised in the consumer;
    a consumer that stops early stops the producer and closes
    ``batches``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        it = iter(batches)
        try:
            for batch in it:
                if cuda:
                    with torch.cuda.stream(copy_stream):
                        out = to_device(batch, device)
                        ready = torch.cuda.Event()
                        ready.record(copy_stream)
                else:
                    out, ready = to_device(batch, device), None
                if not put((out, ready)):
                    return
            put(done)
        except BaseException as e:                  # noqa: BLE001
            # handed to the consumer, which raises it: a producer that
            # died quietly would leave the step loop waiting forever
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True,
                              name="prefetch_to_device")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in batch.values():
                    t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        thread.join()
