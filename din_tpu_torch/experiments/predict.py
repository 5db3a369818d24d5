"""Serving path (port of din_tpu/experiments/predict.py).

Usage (library):
    predictor = Predictor.from_checkpoint(cfg, "stage2_epoch3_91.20%.pth",
                                          pad_to=2)        # on the card
    out = predictor(images, boxes)              # dict of softmax posteriors
    out = predictor(images, boxes, bboxes_num)  # collective models
    predictor = Predictor(cfg, model, pad_to=2) # a model already built

CLI demo on synthetic clips (random weights from the seed without
``--ckpt``):
    python -m din_tpu_torch.experiments.predict --preset \
        volleyball_stage2_dynamic --ckpt result/<exp>/stage2_*.pth \
        [--batch 1] [--pad-to 2] [--device cpu]

``from_checkpoint`` reads a stage-2 ``.pth`` of the port (``train_net``'s
``save_state``) or of the reference framework, both ``{'epoch',
'state_dict', 'optimizer'}``; it loads strictly and ignores the optimizer.

``bboxes_num`` [B,T] is the true actor count of each frame; the collective
models mask the padded actors with it, the volleyball models take none.  The
JAX package's msgpack ``.ckpt`` files reach the port as reference ``.pth``
files (``nn/ref_import.py``); ``nn.ref_export.jax_params_to_state_dict``
converts JAX parameters and BatchNorm statistics.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from din_tpu_torch.utils.device import resolve_device


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


def posteriors(out: Dict) -> Dict:
    """Softmax posteriors (float32) of a model's ``activities`` and, where
    it has them, ``actions`` logits: what the live ``Predictor`` answers and
    what an exported serving program returns."""
    return {k: torch.softmax(out[k].float(), dim=-1)
            for k in ("activities", "actions") if k in out}


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
        if pad_to is not None and pad_to < 1:
            raise ValueError(f"pad_to must be >= 1, got {pad_to}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.pad_to = pad_to

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_path: Optional[str] = None,
                        pad_to: Optional[int] = None,
                        device=None) -> "Predictor":
        """Builds the model of ``cfg`` on ``device`` (default: the card)
        and, given ``ckpt_path``, loads a stage-2 ``.pth`` into it
        (din_tpu/experiments/predict.py:131-147): parameters and BatchNorm
        buffers, strictly (a tensor of the model the file lacks raises, as
        does one the file has and the model lacks); the optimizer state is
        ignored.  Without ``ckpt_path`` the weights are random, from
        ``cfg.train_random_seed``."""
        from din_tpu_torch.models.registry import build_model
        from din_tpu_torch.train.checkpoint import load_state

        model = build_model(cfg, device=device)
        if ckpt_path:
            load_state(ckpt_path, model)
        return cls(cfg, model, pad_to=pad_to, device=device)

    def _run(self, images, boxes, bboxes_num=None) -> Dict:
        """One forward call on the device; softmax posteriors as numpy."""
        images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        boxes = torch.from_numpy(np.ascontiguousarray(
            boxes, dtype=np.float32)).to(self.device)
        if bboxes_num is not None:
            bboxes_num = torch.from_numpy(np.ascontiguousarray(
                bboxes_num, dtype=np.int32)).to(self.device)
        with torch.inference_mode():
            res = posteriors(self.model(images, boxes, bboxes_num))
        return {k: v.cpu().numpy() for k, v in res.items()}

    def __call__(self, images, boxes, bboxes_num=None) -> Dict:
        """images [B,T,H,W,3] uint8; boxes [B,T,N,4] feature-map coords;
        bboxes_num [B,T] actor counts (collective models).  Returns the
        softmax posteriors as numpy: {'activities': [B,G]}, and 'actions'
        where the model has them (a Basenet), as din_tpu's Predictor."""
        if self.pad_to is not None:
            return chunked_padded_call(self._run, self.pad_to, images, boxes,
                                       bboxes_num)
        if np.asarray(images).shape[0] == 0:
            raise ValueError("empty request: images.shape[0] == 0")
        return self._run(images, boxes, bboxes_num)


def main(argv=None):
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.presets import PRESETS

    p = argparse.ArgumentParser(description="din_tpu_torch inference demo")
    p.add_argument("--preset", default="volleyball_stage2_dynamic",
                   choices=sorted(PRESETS))
    p.add_argument("--ckpt", default=None,
                   help="stage-2 .pth (random weights if omitted)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--pad-to", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="default: the card (cuda); 'cpu' only when asked")
    args = p.parse_args(argv)

    cfg = PRESETS[args.preset]()
    predictor = Predictor.from_checkpoint(cfg, args.ckpt, pad_to=args.pad_to,
                                          device=args.device)
    batch = make_synthetic_batch(cfg, batch_size=args.batch)
    out = predictor(batch["images"], batch["boxes"], batch.get("bboxes_num"))
    acts = out["activities"]
    # a model that answers per frame gives m rows a clip (see
    # chunked_padded_call): fold them back and average each clip's rows
    # (din_tpu/experiments/predict.py:196-203)
    m = acts.shape[0] // args.batch
    acts = acts.reshape(args.batch, m, -1).mean(axis=1)
    top = acts.argmax(-1)
    for b in range(args.batch):
        print(f"clip {b}: activity={int(top[b])} "
              f"p={float(acts[b, top[b]]):.3f}")
    return out


if __name__ == "__main__":
    main()
