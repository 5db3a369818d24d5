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

Preemption (din_tpu/train/engine.py:493-513): ``save_preempt_state`` writes
``stage{N}_epoch{E}_preempt.pth``, the stage-2 layout plus ``step`` (the
steps done of epoch E + 1) and ``dropout_rng`` (each ``SeededDropout``
generator's state by module name, None where none has drawn yet), in both
stages, since stage 1's regular files hold no optimizer.
``load_resume_state`` restores it, or a regular stage-2 file (step 0, no
generator states: the generators restart from their seeds, as din_tpu's
regular files carry no PRNG key).  ``newest_resumable`` picks the file
``auto_resume`` continues from, ``prune_checkpoints`` the regular files
``keep_checkpoints`` deletes (din_tpu/train/checkpoint.py:183-212).

More than one rank (``mesh``, ``parallel/mesh.py``): every rank calls the
save, rank 0 writes the file in the same layout as one process (the
model's own keys, no ``module.`` prefix; a ZeRO-1 optimizer's state
consolidated on rank 0 first, by every rank of its data column, as
din_tpu gathers its sharded moments before a save, checkpoint.py:36-52)
and the others wait at a barrier until the file is there.  A ``_preempt``
file also holds every data rank's dropout generators
(``dropout_rng_ranks``, gathered on rank 0); ``dropout_rng`` stays rank
0's.  Every rank loads the file and takes its own generators; a rank the
file has none for starts its generators from their seeds.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from din_tpu_torch.nn.layers import SeededDropout
from din_tpu_torch.train.optim import is_sharded


def _save(obj, path: str) -> None:
    """Written to a temporary name and moved into place, so a reader never
    sees half a file."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _writes(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _barrier(mesh) -> None:
    if mesh is not None:
        mesh.barrier()


def optimizer_state(optimizer: torch.optim.Optimizer,
                    mesh=None) -> Optional[Dict]:
    """The optimizer's whole ``state_dict`` on rank 0 (None elsewhere
    under ZeRO-1, whose shards every rank of rank 0's data column sends to
    rank 0: each of them calls this)."""
    if mesh is not None and is_sharded(optimizer):
        if mesh.model_index == 0:
            optimizer.consolidate_state_dict(to=0)
        return optimizer.state_dict() if mesh.rank == 0 else None
    return optimizer.state_dict()


def save_state(path: str, epoch: int, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer, mesh=None) -> None:
    opt = optimizer_state(optimizer, mesh)
    if _writes(mesh):
        _save({"epoch": epoch, "state_dict": model.state_dict(),
               "optimizer": opt}, path)
    _barrier(mesh)


def _dropout_states(model: torch.nn.Module) -> Dict:
    return {name: m.get_rng_state() for name, m in model.named_modules()
            if isinstance(m, SeededDropout)}


def save_preempt_state(path: str, epoch: int, step: int,
                       model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, mesh=None) -> None:
    """The full state of a run preempted after ``step`` steps of epoch
    ``epoch`` + 1 (``epoch`` is the last complete one)."""
    opt = optimizer_state(optimizer, mesh)
    rng = _dropout_states(model)
    ranks = None if mesh is None or mesh.data == 1 else \
        mesh.gather_objects(rng)
    if _writes(mesh):
        state = {"epoch": epoch, "step": step,
                 "state_dict": model.state_dict(), "optimizer": opt,
                 "dropout_rng": rng}
        if ranks is not None:
            state["dropout_rng_ranks"] = ranks
        _save(state, path)
    _barrier(mesh)


def load_resume_state(path: str, model: torch.nn.Module,
                      optimizer: Optional[torch.optim.Optimizer] = None,
                      mesh=None) -> Tuple[int, int, Optional[Dict]]:
    """Restores a stage-2 file or a ``_preempt`` file in place: parameters
    and buffers, the Adam state unless ``optimizer`` is None (serving
    ignores it) and, from a ``_preempt`` file, the dropout generators'
    states, set on the model's ``SeededDropout`` modules on the device of
    its parameters.  Returns (epoch, the steps done of the next epoch (0
    for a regular file), the generators' states or None).  Strict: a
    parameter or buffer of the model that the file lacks, or a tensor of
    the file that the model lacks, raises, so a model never serves
    half-random weights (din_tpu/train/checkpoint.py:171-174).  A
    reference full-model ``.pth`` has this layout too and loads by name.
    With ``mesh`` the generators are its data rank's (module docstring);
    a ZeRO-1 optimizer takes its share of the Adam state."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["state_dict"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    rng = state.get("dropout_rng")
    index = 0 if mesh is None else mesh.data_index
    ranks = state.get("dropout_rng_ranks")
    if ranks is not None:
        rng = ranks[index] if index < len(ranks) else None
    elif index:
        rng = None
    if rng is not None:
        device = next(model.parameters()).device
        for name, m in model.named_modules():
            if isinstance(m, SeededDropout):
                m.set_rng_state(rng[name], device)
    return int(state["epoch"]), int(state.get("step", 0)), rng


def load_state(path: str, model: torch.nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """``load_resume_state``'s epoch."""
    return load_resume_state(path, model, optimizer)[0]


def newest_resumable(result_path: str, training_stage: int) -> Optional[str]:
    """The newest resumable ``.pth`` in ``result_path``, or None
    (din_tpu/train/engine.py:253-266).  Stage 2 saves its full state every
    eval; stage 1's regular saves are component files, so only its
    ``_preempt`` files qualify.  A ``_preempt`` file carries the epoch
    number of that epoch's regular save but holds later work (the next
    epoch's first steps), so it wins a tie."""
    ckpts = [f for f in os.listdir(result_path) if f.endswith(".pth")]
    if training_stage == 1:
        ckpts = [f for f in ckpts if "_preempt" in f]
    ckpts = sorted(ckpts,
                   key=lambda f: (int(f.split("epoch")[1].split("_")[0]),
                                  "_preempt" in f))
    return os.path.join(result_path, ckpts[-1]) if ckpts else None


def prune_checkpoints(result_path: str, stage: int, keep: int) -> List[str]:
    """Deletes all but the newest ``keep`` regular files
    ``stage{stage}_epoch{E}_{acc}%.pth`` and the one of the best accuracy
    (the later epoch on a tie); ``_preempt`` files and other stages' files
    stay.  ``keep`` <= 0 deletes nothing (the reference keeps every file,
    train_net.py:120-128).  Returns the deleted names."""
    pat = re.compile(r"^stage%d_epoch(\d+)_([0-9.]+)%%\.pth$" % stage)
    entries = []
    for f in os.listdir(result_path):
        m = pat.match(f)
        if m:
            entries.append((int(m.group(1)), float(m.group(2)), f))
    if keep <= 0 or len(entries) <= keep:
        return []
    entries.sort()                                  # by epoch
    protected = {max(entries, key=lambda e: (e[1], e[0]))[2]}
    protected.update(f for _, _, f in entries[-keep:])
    removed = []
    for _, _, f in entries:
        if f not in protected:
            os.remove(os.path.join(result_path, f))
            removed.append(f)
    return removed


def save_stage1_components(path: str, model: torch.nn.Module,
                           mesh=None) -> None:
    """The stage-1 component file of a Basenet (either dataset), the
    backbone's BatchNorm buffers included."""
    if _writes(mesh):
        _save({f"{name}_state_dict": getattr(model, name).state_dict()
               for name in ("backbone", "fc_emb", "fc_actions",
                            "fc_activities")}, path)
    _barrier(mesh)


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
