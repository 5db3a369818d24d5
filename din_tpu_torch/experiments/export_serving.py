"""Self-contained serving artifact: the port's inference program as a
``torch.export`` archive (port of din_tpu/experiments/export_serving.py).

``export_predictor`` traces a ``Predictor``'s model and its posteriors
(``predict.posteriors``) at one fixed batch with ``torch.export.export``
(non-strict, under ``torch.no_grad()``, so a VGG trunk takes the fused
stem) and returns a ``torch.export.save`` archive: the graph, the weights
as its parameters and buffers, and a JSON header among its extra files,
readable without deserialising the program (``read_header``).  The five
kernels are ``torch.library`` custom ops (``din_tpu_torch/ops``), so the
graph holds ``din_tpu_torch::fused_stem``, ``::max_pool_2x2`` and
``::roi_align`` where the live model calls them; on the card they launch
K3, K2 and K1, on the CPU their plain versions run.

``ExportedPredictor`` serves such a file with no model code, config or
checkpoint.  Loading and serving import ``din_tpu_torch.ops`` (which
registers the ops), ``experiments/predict.py`` (``chunked_padded_call``)
and ``utils``, nothing from ``models``, ``heads``, ``nn`` or ``train``.
Ragged requests are padded to the artifact's batch and answered in chunks,
as the live ``Predictor(pad_to=k)`` answers them.

An artifact belongs to the device it was exported on, which the header
records.  ``ExportedPredictor`` runs on the card unless the caller passes
``device="cpu"``, and refuses an artifact of the other device instead of
moving it.

Precision: cuDNN runs float32 convolutions in TF32 while
``torch.backends.cudnn.allow_tf32`` is True (its default), a process-wide
flag that an exported graph does not record; the live model switches it off
around its f32 convs (``utils/precision.py``).  ``ExportedPredictor`` calls
the program under ``ieee_f32_convs()``, so every f32 conv of the artifact
runs in IEEE float32 whatever the caller's flag (the header's
``f32_conv_precision``); bf16 convs do not read the flag.

din_tpu's ``.dinx`` artifacts hold JAX StableHLO, which the port does not
run: ``read_header`` names such a file and raises ``ValueError``, as it
does for any file that is not an archive with the port's header.

CLI (on the card; ``--device cpu`` only at a small geometry):
    python -m din_tpu_torch.experiments.export_serving \\
        --preset volleyball_stage2_dynamic --ckpt stage2.pth \\
        --out model.pt2 --batch 4 [--device cpu]

Serving:
    from din_tpu_torch.experiments.export_serving import ExportedPredictor
    pred = ExportedPredictor.load("model.pt2")       # on the card
    out = pred(images, boxes)          # any batch size; softmax posteriors
    out = pred(images, boxes, bboxes_num)            # collective models
"""

from __future__ import annotations

import argparse
import io
import json
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

import din_tpu_torch.ops  # noqa: F401 (registers the kernels' custom ops)
from din_tpu_torch.experiments.predict import (chunked_padded_call,
                                               posteriors)
from din_tpu_torch.utils.device import resolve_device
from din_tpu_torch.utils.precision import ieee_f32_convs

HEADER_NAME = "din_tpu_torch_header.json"
FORMAT = "din_tpu_torch serving artifact"
_DINX_MAGIC = b"DINTPUX1"          # din_tpu's StableHLO artifacts


class _Served(torch.nn.Module):
    """A model and its posteriors: what the exported program computes."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images, boxes, bboxes_num=None):
        return posteriors(self.model(images, boxes, bboxes_num))


def _example_args(cfg, batch: int, device: torch.device):
    """Fixed-shape example arguments, as the live Predictor sees them:
    uint8 images [k,T,H,W,3], f32 boxes [k,T,N,4] and, for the collective
    models, int32 ``bboxes_num`` [k,T] (values irrelevant)."""
    from din_tpu_torch.data.synthetic import make_synthetic_batch

    sample = make_synthetic_batch(cfg, batch_size=batch)
    args = [sample["images"], sample["boxes"]]
    if "bboxes_num" in sample:
        args.append(sample["bboxes_num"])
    return tuple(torch.from_numpy(a).to(device) for a in args)


def export_predictor(predictor, batch: Optional[int] = None) -> bytes:
    """Export ``predictor``'s model and posteriors (weights included) at
    the fixed batch ``batch or predictor.pad_to or 1`` on the predictor's
    device; returns the bytes of the archive."""
    k = batch or predictor.pad_to or 1
    args = _example_args(predictor.cfg, k, predictor.device)
    with torch.no_grad():
        program = torch.export.export(_Served(predictor.model).eval(), args,
                                      strict=False)
    # the header holds the arguments' shapes; the file needs no frames
    program.example_inputs = None
    header = {
        "format": FORMAT,
        "batch": k,
        "arg_shapes": [list(a.shape) for a in args],
        "arg_dtypes": [str(a.dtype).removeprefix("torch.") for a in args],
        "has_bboxes_num": len(args) == 3,
        "outputs": sorted(program.call_spec.out_spec.context),
        "device": predictor.device.type,
        "torch_version": torch.__version__,
        "inference_module_name": predictor.cfg.inference_module_name,
        "f32_conv_precision": "ieee (cudnn.allow_tf32 off while serving)",
    }
    buf = io.BytesIO()
    torch.export.save(program, buf,
                      extra_files={HEADER_NAME: json.dumps(header)})
    return buf.getvalue()


def read_header(data: bytes) -> Dict:
    """The header of an artifact's bytes, without loading the program;
    ``ValueError`` naming what is wrong for anything else."""
    if data[:len(_DINX_MAGIC)] == _DINX_MAGIC:
        raise ValueError("a din_tpu .dinx artifact (JAX StableHLO); "
                         "din_tpu_torch serves only its own torch.export "
                         "archives")
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as archive:
            names = [n for n in archive.namelist()
                     if n.rsplit("/", 1)[-1] == HEADER_NAME]
            if not names:
                raise ValueError(f"a zip archive without {HEADER_NAME}: not "
                                 f"a din_tpu_torch serving artifact")
            header = json.loads(archive.read(names[0]))
    except zipfile.BadZipFile as e:
        raise ValueError("not a din_tpu_torch serving artifact: not a zip "
                         "archive of torch.export.save") from e
    if not isinstance(header, dict) or header.get("format") != FORMAT:
        raise ValueError(f"{HEADER_NAME} does not name the format {FORMAT!r}")
    return header


class ExportedPredictor:
    """Serve an artifact of ``export_predictor``: ragged requests padded to
    its batch and answered in chunks by the one exported program."""

    def __init__(self, program, header: Dict, device: torch.device):
        self.header = header
        self.device = device
        self.pad_to = int(header["batch"])
        self._has_bn = bool(header["has_bboxes_num"])
        self._shapes = [tuple(s) for s in header["arg_shapes"]]
        self._dtypes = [np.dtype(d) for d in header["arg_dtypes"]]
        self._module = program.module()

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "ExportedPredictor":
        """Loads on ``device`` (default: the card), which must be the
        device the artifact was exported on."""
        header = read_header(data)
        device = resolve_device(device)
        if header["device"] != device.type:
            raise ValueError(f"the artifact was exported on "
                             f"{header['device']!r} and is served only there, "
                             f"asked for {device.type!r}; export it again on "
                             f"that device")
        # a writable copy: the loader's tensors may share its memory
        program = torch.export.load(io.BytesIO(bytearray(data)))
        return cls(program, header, device)

    @classmethod
    def load(cls, path: str, device=None) -> "ExportedPredictor":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read(), device)

    def _run(self, images, boxes, bboxes_num=None) -> Dict:
        """One call of the program at the artifact's batch; numpy out."""
        arrays = (images, boxes, bboxes_num)[:len(self._shapes)]
        args = []
        for name, a, shape, dtype in zip(("images", "boxes", "bboxes_num"),
                                          arrays, self._shapes, self._dtypes):
            a = np.ascontiguousarray(a, dtype=dtype)
            if a.shape[1:] != shape[1:]:
                raise ValueError(f"{name} {list(a.shape)} does not match the "
                                 f"artifact's {list(shape)} past the batch")
            args.append(torch.from_numpy(a).to(self.device))
        with torch.inference_mode(), ieee_f32_convs():
            out = self._module(*args)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def __call__(self, images, boxes, bboxes_num=None) -> Dict:
        """images [B,T,H,W,3] uint8; boxes [B,T,N,4]; bboxes_num [B,T] for
        an artifact of a collective model.  The softmax posteriors as
        numpy, as the live Predictor answers."""
        if self._has_bn and bboxes_num is None:
            raise ValueError("this artifact was exported with bboxes_num; "
                             "the request must provide it")
        return chunked_padded_call(self._run, self.pad_to, images, boxes,
                                   bboxes_num if self._has_bn else None)


def main(argv=None):
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS

    p = argparse.ArgumentParser(
        description="export a din_tpu_torch serving artifact (.pt2)")
    p.add_argument("--preset", default="volleyball_stage2_dynamic",
                   choices=sorted(PRESETS))
    p.add_argument("--ckpt", default=None,
                   help="stage-2 .pth (random weights if omitted)")
    p.add_argument("--out", required=True, help="artifact path (.pt2)")
    p.add_argument("--batch", type=int, default=4,
                   help="fixed serving batch (pad-to-k at call time)")
    p.add_argument("--device", default=None,
                   help="default: the card (cuda); 'cpu' only when asked")
    args = p.parse_args(argv)

    cfg = PRESETS[args.preset]()
    predictor = Predictor.from_checkpoint(cfg, args.ckpt, device=args.device)
    data = export_predictor(predictor, batch=args.batch)
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {args.out}: {len(data) / 1e6:.1f} MB, batch={args.batch}, "
          f"device={predictor.device.type}")


if __name__ == "__main__":
    main()
