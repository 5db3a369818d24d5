"""Serving path (port of din_tpu/experiments/predict.py).

Usage (library):
    model = build_model(cfg)                    # on the card
    predictor = Predictor(cfg, model, pad_to=2)
    out = predictor(images, boxes)              # dict of softmax posteriors

CLI demo on a synthetic clip (random weights from the seed):
    python -m din_tpu_torch.experiments.predict [--batch 1] [--device cuda]

Loading the JAX package's ``.ckpt`` files comes with the checkpoint slice
(ROADMAP.md); ``nn.ref_export.jax_params_to_state_dict`` converts JAX
parameters already.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch


def chunked_padded_call(fwd, pad_to: int, images, boxes,
                        bboxes_num=None) -> Dict:
    """Answer a B-clip request with ceil(B/pad_to) calls to
    ``fwd(images, boxes, bboxes_num) -> dict`` of batch exactly ``pad_to``
    (host numpy copy of din_tpu/experiments/predict.py:27-74).  A short
    chunk repeats its first clip; the padding rows are cut off again.
    Outputs may hold m rows per clip; n valid clips are the first n*m rows.
    """
    images = np.asarray(images)
    boxes = np.asarray(boxes)
    if bboxes_num is not None:
        bboxes_num = np.asarray(bboxes_num)
    b_total, k = images.shape[0], pad_to
    if b_total == 0:
        raise ValueError("empty request: images.shape[0] == 0")
    chunks = []
    for s in range(0, b_total, k):
        n = min(k, b_total - s)

        def pad(x):
            sl = x[s:s + n]
            if n == k:
                return sl
            return np.concatenate([sl] + [sl[:1]] * (k - n), axis=0)

        out = fwd(pad(images), pad(boxes),
                  None if bboxes_num is None else pad(bboxes_num))

        def _valid_rows(v):
            if v.shape[0] % k != 0:
                raise ValueError(
                    f"output leading dim {v.shape[0]} is not a multiple "
                    f"of the padded batch {k}; cannot un-pad")
            return np.asarray(v)[: n * (v.shape[0] // k)]

        chunks.append({kk: _valid_rows(v) for kk, v in out.items()})
    return {kk: np.concatenate([c[kk] for c in chunks], axis=0)
            for kk in chunks[0]}


class Predictor:
    """Inference wrapper of a built model.

    ``pad_to``: serving batch shape; every request is padded up to k clips
    (larger ones run in k-clip chunks) so the card always sees one shape.
    Clips are independent in eval mode, so padding rows cannot alter real
    rows.  ``device``: default the card; with no card this raises unless
    the caller passes ``device="cpu"``.
    """

    def __init__(self, cfg, model: torch.nn.Module,
                 pad_to: Optional[int] = None, device=None):
        from din_tpu_torch.models.registry import resolve_device

        if pad_to is not None and pad_to < 1:
            raise ValueError(f"pad_to must be >= 1, got {pad_to}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.pad_to = pad_to

    def _run(self, images, boxes, bboxes_num=None) -> Dict:
        """One forward call on the device; softmax posteriors as numpy."""
        del bboxes_num  # volleyball models take none
        images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        boxes = torch.from_numpy(np.ascontiguousarray(
            boxes, dtype=np.float32)).to(self.device)
        with torch.inference_mode():
            out = self.model(images, boxes)
            res = {k: torch.softmax(v.float(), dim=-1)
                   for k, v in out.items()}
        return {k: v.cpu().numpy() for k, v in res.items()}

    def __call__(self, images, boxes, bboxes_num=None) -> Dict:
        """images [B,T,H,W,3] uint8; boxes [B,T,N,4] feature-map coords.
        Returns {'activities': [B,G]} softmax posteriors as numpy."""
        if self.pad_to is not None:
            return chunked_padded_call(self._run, self.pad_to, images, boxes,
                                       bboxes_num)
        if np.asarray(images).shape[0] == 0:
            raise ValueError("empty request: images.shape[0] == 0")
        return self._run(images, boxes, bboxes_num)


def main(argv=None):
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.models.registry import build_model

    p = argparse.ArgumentParser(description="din_tpu_torch inference demo")
    p.add_argument("--preset", default="volleyball_stage2_dynamic",
                   choices=sorted(PRESETS))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--pad-to", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="default: the card (cuda); 'cpu' only when asked")
    args = p.parse_args(argv)

    cfg = PRESETS[args.preset]()
    model = build_model(cfg, device=args.device)
    predictor = Predictor(cfg, model, pad_to=args.pad_to, device=args.device)
    batch = make_synthetic_batch(cfg, batch_size=args.batch)
    out = predictor(batch["images"], batch["boxes"])
    acts = out["activities"]
    top = acts.argmax(-1)
    for b in range(args.batch):
        print(f"clip {b}: activity={int(top[b])} "
              f"p={float(acts[b, top[b]]):.3f}")
    return out


if __name__ == "__main__":
    main()
