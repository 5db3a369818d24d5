"""Packed decoded-frame store: decode the dataset once, mmap it forever
(port of din_tpu/data/packed.py:50-211, the same ``DINPACK1`` format, so a
store packed by either package reads in the other).

The reference decodes every JPEG from disk on every epoch inside
``__getitem__`` (reference volleyball.py:223-244, collective.py:140-160) —
at 720x1280 that decode can hold the input pipeline back (PERF.md, input
row).  The in-memory LRU (data/cache.py) removes it from epoch 2
on when the working set fits RAM; this module removes it entirely, for
datasets of any size, by precomputing the decode+resize ONCE into a single
flat uint8 file that training then reads through ``np.memmap`` — steady
state is a page-cached memcpy, no JPEG work at all, and the OS evicts
cold pages under memory pressure (no budget tuning).

Format (single file, relocatable):
    8 bytes   magic  b"DINPACK1"
    8 bytes   uint64 little-endian header length
    N bytes   header JSON: {"height", "width", "keys": [relpath, ...]}
    pad       zeros to the next 64-byte boundary
    blob      len(keys) frames of height*width*3 uint8, in key order

Frames are keyed by path RELATIVE to the image root, so the store can be
produced on one machine and mounted anywhere.  Lookups that miss fall back
to live decode (din_tpu_torch/native) and are counted in ``misses``, so a
store packed from a subset still works.

Sizing: a 720x1280 frame is ~2.7 MB raw; the full volleyball train+test
tree (~4.8k clips x 10 frames) packs to ~130 GB — sized for a local SSD,
where it turns a multi-core decode problem into sequential reads.  Pack at
the training ``image_size``:

    python -m din_tpu_torch.data.packed --root /data/volleyball/videos \\
        --out /ssd/volleyball_720p.pack --height 720 --width 1280

then set ``cfg.packed_frames_path`` (wired through
``make_frame_source`` -> dataset ``cache=``; both dataset classes call
only ``load_frames(paths, H, W)`` on it).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from din_tpu_torch import native
from din_tpu_torch.data.cache import make_cache

_MAGIC = b"DINPACK1"
_ALIGN = 64


def _walk_jpgs(root: str) -> List[str]:
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            if name.lower().endswith((".jpg", ".jpeg")):
                out.append(os.path.relpath(os.path.join(dirpath, name),
                                           root))
    return sorted(out)


def pack_frames(root: str, out_path: str, height: int, width: int,
                keys: Optional[Sequence[str]] = None,
                batch: int = 64, verbose: bool = False) -> int:
    """Decode+resize every JPEG under ``root`` (or just ``keys``, given as
    root-relative paths) into ``out_path``.  Returns the frame count.

    Decodes in batched native calls (multi-threaded libjpeg with DCT
    prescale, din_tpu_torch/native) and streams frames straight to disk —
    peak RAM is one batch, so arbitrarily large datasets pack on small
    hosts."""
    keys = list(keys) if keys is not None else _walk_jpgs(root)
    header = json.dumps({"height": height, "width": width,
                         "keys": keys}).encode("utf-8")
    data_off = len(_MAGIC) + 8 + len(header)
    data_off += (-data_off) % _ALIGN
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(np.uint64(len(header)).tobytes())
        f.write(header)
        f.write(b"\x00" * (data_off - f.tell()))
        for start in range(0, len(keys), batch):
            chunk = keys[start:start + batch]
            frames = native.load_frames(
                [os.path.join(root, k) for k in chunk], height, width)
            f.write(np.ascontiguousarray(frames).tobytes())
            if verbose:
                print(f"packed {min(start + batch, len(keys))}/{len(keys)}",
                      flush=True)
    os.replace(tmp, out_path)
    return len(keys)


class PackedFrameStore:
    """mmap-backed reader with the FrameCache ``load_frames`` interface.

    ``root``: image root the incoming absolute paths are relative to (the
    dataset's ``images_path``); when the exact relative key is absent (or
    ``root`` is None) the last 3 / 2 path components are tried, so a store
    travels across differently-mounted roots.  Unresolvable paths fall back
    to live native decode (counted in ``misses``)."""

    def __init__(self, path: str, root: Optional[str] = None):
        with open(path, "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(f"{path}: not a DINPACK file")
            hlen = int(np.frombuffer(f.read(8), np.uint64)[0])
            header = json.loads(f.read(hlen).decode("utf-8"))
        self.path = path
        self.root = root
        self.height = int(header["height"])
        self.width = int(header["width"])
        self.keys: List[str] = list(header["keys"])
        data_off = len(_MAGIC) + 8 + hlen
        data_off += (-data_off) % _ALIGN
        frame_bytes = self.height * self.width * 3
        expected = data_off + len(self.keys) * frame_bytes
        if os.path.getsize(path) < expected:   # before memmap: its own
            raise ValueError(f"{path}: truncated ({os.path.getsize(path)} "
                             f"< {expected} bytes)")  # error is cryptic
        self._mm = np.memmap(path, np.uint8, mode="r", offset=data_off,
                             shape=(len(self.keys), self.height,
                                    self.width, 3))
        self._index: Dict[str, int] = {k: i for i, k in enumerate(self.keys)}
        # suffix indices for relocatable lookup; ambiguous suffixes map to -1
        self._suffix: Dict[str, int] = {}
        for i, k in enumerate(self.keys):
            parts = k.replace(os.sep, "/").split("/")
            for depth in (2, 3):
                if len(parts) >= depth:
                    s = "/".join(parts[-depth:])
                    self._suffix[s] = -1 if s in self._suffix else i
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self.keys)

    def _resolve(self, path: str) -> int:
        if self.root is not None:
            rel = os.path.relpath(path, self.root).replace(os.sep, "/")
            i = self._index.get(rel, -1)
            if i >= 0:
                return i
        parts = os.path.normpath(path).replace(os.sep, "/").split("/")
        for depth in (3, 2):
            if len(parts) >= depth:
                i = self._suffix.get("/".join(parts[-depth:]), -1)
                if i >= 0:
                    return i
        return -1

    def load_frames(self, paths: List[str], height: int,
                    width: int) -> np.ndarray:
        """[len(paths), H, W, 3] uint8 — FrameCache-compatible."""
        if (height, width) != (self.height, self.width):
            raise ValueError(
                f"store packed at {self.height}x{self.width}, "
                f"requested {height}x{width} — repack at the training size")
        out = np.empty((len(paths), height, width, 3), np.uint8)
        miss = []
        for j, p in enumerate(paths):
            i = self._resolve(p)
            if i < 0:
                miss.append(j)
            else:
                out[j] = self._mm[i]        # page-cached copy, no decode
                self.hits += 1
        if miss:
            self.misses += len(miss)
            decoded = native.load_frames([paths[j] for j in miss],
                                         height, width)
            for dj, j in enumerate(miss):
                out[j] = decoded[dj]
        return out


def make_frame_source(cfg):
    """The dataset ``cache=`` object for cfg: a PackedFrameStore when
    ``cfg.packed_frames_path`` is set, else the in-memory LRU
    (cfg.decode_cache_mb), else None (decode-per-read, the reference
    behaviour — volleyball.py:223-244)."""
    if cfg.packed_frames_path:
        return PackedFrameStore(cfg.packed_frames_path, root=cfg.data_path)
    return make_cache(cfg)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Pack decoded JPEG frames into a mmap-able store")
    ap.add_argument("--root", required=True, help="image tree root")
    ap.add_argument("--out", required=True, help="output .pack path")
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    n = pack_frames(args.root, args.out, args.height, args.width,
                    batch=args.batch, verbose=True)
    size_mb = os.path.getsize(args.out) / (1 << 20)
    print(f"{args.out}: {n} frames, {size_mb:.1f} MB")


if __name__ == "__main__":
    main()
