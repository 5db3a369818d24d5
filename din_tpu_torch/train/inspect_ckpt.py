"""Describe a checkpoint file (port of din_tpu/train/inspect_ckpt.py).

    python -m din_tpu_torch.train.inspect_ckpt result/<exp>/stage2_*.pth
    python -m din_tpu_torch.train.inspect_ckpt --full stage1_epoch1_*.pth

Reads every ``.pth`` layout the port reads or writes:

* stage 2, the port's ``save_state`` and the reference framework's
  full-model file: ``{'epoch', 'state_dict', 'optimizer'}``;
* the stage-1 component file: ``{'backbone_state_dict',
  'fc_emb_state_dict', 'fc_actions_state_dict', 'fc_activities_state_dict'}``;
* a torchvision backbone file: a bare ``state_dict`` (or one under
  ``'state_dict'``), e.g. VGG-16's ``features.*``/``classifier.*``.

It prints the layout, the payload's keys, the epoch, the optimizer's
entries, and per top-level module (the first part of a key, e.g.
``backbone``, ``DPI``, ``fc_emb``, ``features``) its tensors, parameter
count and bytes, BatchNorm buffers apart; with ``--full`` every key with
its shape and dtype.  The JAX package's msgpack ``.ckpt`` files and orbax
directories are not read here: they reach the port as reference ``.pth``
files (din_tpu's ``save_reference_checkpoint``), which this reads.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def _tensors(payload: dict) -> Tuple[str, Dict[str, torch.Tensor]]:
    """(layout, {key: tensor}) of a loaded ``.pth`` payload."""
    if isinstance(payload.get("state_dict"), dict):
        layout = ("stage-2 / reference full-model" if "optimizer" in payload
                  else "state_dict")
        return layout, payload["state_dict"]
    comps = [k for k in payload if k.endswith("_state_dict")]
    if comps and all(isinstance(payload[k], dict) for k in comps):
        return "stage-1 components", {
            f"{k[:-len('_state_dict')]}.{name}": v
            for k in comps for name, v in payload[k].items()}
    if payload and all(isinstance(v, torch.Tensor) for v in payload.values()):
        return "bare state_dict (torchvision backbone)", payload
    raise ValueError(f"not a checkpoint layout the port reads: keys "
                     f"{sorted(payload)[:8]}")


def describe(path: str, full: bool = False, out=print) -> dict:
    """Prints the description of ``path`` through ``out``; returns it as a
    dict: ``layout``, ``keys``, ``epoch``, ``modules`` ({name: {'tensors',
    'params', 'buffers', 'bytes'}}), ``params`` (the total of parameter
    elements, BatchNorm buffers not counted) and ``bytes``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: payload is a {type(payload).__name__}, "
                         f"not a dict")
    layout, flat = _tensors(payload)
    epoch = payload.get("epoch")
    out(f"{path}  ({layout})")
    out(f"  payload keys: {sorted(payload)}")
    if epoch is not None:
        out(f"  epoch: {int(epoch)}")
    opt = payload.get("optimizer")
    if isinstance(opt, dict):
        groups = opt.get("param_groups", [])
        out(f"  optimizer: {len(opt.get('state', {}))} state entries, "
            f"{len(groups)} param groups"
            + (f", lr {groups[0].get('lr')}" if groups else ""))
    modules: Dict[str, Dict[str, int]] = {}
    for key, v in flat.items():
        m = modules.setdefault(key.split(".", 1)[0], dict(
            tensors=0, params=0, buffers=0, bytes=0))
        m["tensors"] += 1
        m["buffers" if key.endswith(_BUFFER_SUFFIXES) else "params"] += \
            v.numel()
        m["bytes"] += v.numel() * v.element_size()
    for name, m in modules.items():
        out(f"  {name}: {m['tensors']} tensors, {m['params']:,} parameters"
            + (f", {m['buffers']:,} buffer elements" if m["buffers"] else "")
            + f", {m['bytes'] / 1e6:.1f} MB")
    params = sum(m["params"] for m in modules.values())
    nbytes = sum(m["bytes"] for m in modules.values())
    out(f"  total: {len(flat)} tensors, {params:,} parameters, "
        f"{nbytes / 1e6:.1f} MB")
    if full:
        for key, v in flat.items():
            out(f"    {key}: {tuple(v.shape)} {v.dtype}")
    return {"layout": layout, "keys": sorted(payload),
            "epoch": None if epoch is None else int(epoch),
            "modules": modules, "params": params, "bytes": nbytes}


def main(argv=None):
    p = argparse.ArgumentParser(description="describe a checkpoint .pth")
    p.add_argument("path")
    p.add_argument("--full", action="store_true",
                   help="print every key with its shape and dtype")
    args = p.parse_args(argv)
    return describe(args.path, full=args.full)


if __name__ == "__main__":
    main()
