"""Checkpoints of the port, in the reference's ``.pth`` layouts.

Stage 2: ``torch.save({'epoch', 'state_dict', 'optimizer'})`` every eval
with the accuracy in the file name (train_net.py:120-128, cited at
din_tpu/train/checkpoint.py:1-22).  The reference saves the optimizer but
never restores it; ``load_state`` restores parameters, Adam state and the
epoch, as the JAX package's loader does.

Stage 1: the Basenet's component file (base_model.py:46-54 ``savemodel``),
``{'backbone_state_dict', 'fc_emb_state_dict', 'fc_actions_state_dict',
'fc_activities_state_dict'}``, the layout of the JAX package's
``save_reference_checkpoint(fmt='stage1')``; ``load_backbone_stage2``
grafts its backbone and ``fc_emb`` (as ``fc_emb_1``) into a stage-2 model
(infer_model.py:122-126 ``loadmodel``; din_tpu/train/checkpoint.py:118-131).
A backbone's ``state_dict`` holds its BatchNorm buffers (``running_mean``,
``running_var``, ``num_batches_tracked``), so the component file and the
graft carry them, as din_tpu's carry ``batch_stats``.
Reading the JAX package's msgpack ``.ckpt`` files is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def _save(obj, path: str) -> None:
    """Written to a temporary name and moved into place, so a reader never
    sees half a file."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_state(path: str, epoch: int, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer) -> None:
    _save({"epoch": epoch, "state_dict": model.state_dict(),
           "optimizer": optimizer.state_dict()}, path)


def load_state(path: str, model: torch.nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Restores parameters and BatchNorm buffers, and the Adam state unless
    ``optimizer`` is None (serving ignores it), in place; returns the
    epoch.  Strict: a parameter or buffer of the model that the file lacks,
    or a tensor of the file that the model lacks, raises, so a model never
    serves half-random weights (din_tpu/train/checkpoint.py:171-174).  A
    reference full-model ``.pth`` has this layout too and loads by name."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["state_dict"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])


def save_stage1_components(path: str, model: torch.nn.Module) -> None:
    """The stage-1 component file of a Basenet (either dataset), the
    backbone's BatchNorm buffers included."""
    _save({f"{name}_state_dict": getattr(model, name).state_dict()
           for name in ("backbone", "fc_emb", "fc_actions", "fc_activities")},
          path)


def load_backbone_stage2(model: torch.nn.Module, stage1_path: str) -> None:
    """Grafts ``backbone.*`` (parameters and BatchNorm buffers) and
    ``fc_emb`` -> ``fc_emb_1`` of a stage-1 component file into a stage-2
    model in place (strict per component); the rest, ``nl_emb_1`` included,
    keeps its init.  A model without ``fc_emb_1`` (HiGCIN works on the raw
    RoI features) takes the backbone alone, as din_tpu grafts only the
    subtrees the model has.  A missing file raises."""
    comp = torch.load(stage1_path, map_location="cpu", weights_only=True)
    model.backbone.load_state_dict(comp["backbone_state_dict"], strict=True)
    if hasattr(model, "fc_emb_1"):
        model.fc_emb_1.load_state_dict(comp["fc_emb_state_dict"],
                                       strict=True)
