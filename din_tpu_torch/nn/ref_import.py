"""Checkpoints written by the reference framework, and torchvision backbone
weights, into the port.

The port's own copy of din_tpu/nn/ref_import.py ``load_reference_checkpoint``
(lines 395-432) and ``load_reference_optimizer`` (lines 306-368), and of
din_tpu/nn/torch_port.py ``torch_file_to_numpy`` / ``convert_backbone_state``
(lines 35-111), for the models the port has.  A reference
``Dynamic_collective`` file holds its one DIN field as ``DPI.*``, which is
the port's ``DynamicCollective.DPI``; the hierarchical head's
``DPI.DPI_1.*``, ``DPI.hier_LN.*``, ``DPI.DPI_2.*``, TCE's
``multilayer_head_embfeature_context_encoding.CET.{k}.*`` (``downsample2``
in the first layer) and the baselines' heads (``AT.*``, ``SACRF.*``,
``BiUTE.*``, ``pctdm.*``, ``BIM.*``/``PIM.*``, ``gcn_list.*``) are the
port's module names too (din_tpu/nn/ref_import.py:141-295); BatchNorm
buffers load with the parameters.  PCTDM's ``nn.LSTM`` biases
``bias_ih_l0`` and ``bias_hh_l0`` are folded into the one trainable bias
``bias_ih_l0`` when they load (heads/pctdm.py), as din_tpu sums them.
The port's modules carry the reference's names and layouts, so what the
JAX package converts (NHWC kernels, the position-major RoI flatten) here
loads by name as it is.

Two reference formats (din_tpu/nn/ref_import.py:1-22):

* full-model files (train_net.py:120-127), ``{'epoch', 'state_dict',
  'optimizer'}`` with flat ``model.state_dict()`` keys;
* stage-1 component files (base_model.py:46-54), ``{'backbone_state_dict',
  'fc_emb_state_dict', 'fc_actions_state_dict',
  'fc_activities_state_dict'}``, mapped to ``backbone.``, ``fc_emb_1.``,
  ``fc_actions.`` and ``fc_activities.``.

Like the reference's ``loadpart``, a key the model does not have is
reported, not fatal; a key it has with another shape raises (din_tpu
writes a collective GCN layer's LayerNorm as [1, NFG], the reference as
[NFG]: ``GCNModule`` reads both when it loads).

The reference saves torch Adam's state (keyed by parameter index) but never
restores it.  ``load_reference_optimizer`` rebuilds that index as the JAX
package does, from the FILE's ``state_dict`` key order minus BatchNorm
buffers, minus ``backbone.*`` when the backbone is frozen, then gives each
moment to the port's parameter of that NAME; the moments of an LSTM's two
biases are halved and added onto its one trainable bias (din_tpu/nn/
ref_import.py:350-356).  A positional
``optimizer.load_state_dict`` would give them to the wrong tensors: the port
registers ``point_conv``/``point_ln`` before ``DPI``, while the JAX
package's exporter writes them after ``dpi_nl`` (din_tpu/nn/ref_export.py
:221-305).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import torch

from din_tpu_torch.nn.backbones import BACKBONES, RESNET_SEQ

_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")
_LSTM_BIAS = re.compile(r"\.bias_(ih|hh)_l0(_reverse)?$")
_COMPONENTS = (("backbone_state_dict", "backbone."),
               ("fc_emb_state_dict", "fc_emb_1."),
               ("fc_actions_state_dict", "fc_actions."),
               ("fc_activities_state_dict", "fc_activities."))


def _read(path_or_state):
    if isinstance(path_or_state, (str, os.PathLike)):
        return torch.load(path_or_state, map_location="cpu",
                          weights_only=True)
    return path_or_state


def reference_state_dict(state) -> Dict[str, torch.Tensor]:
    """The flat ``{key: tensor}`` of a reference checkpoint of either
    format, component files mapped to model keys."""
    if "backbone_state_dict" in state:
        return {prefix + k: v for comp, prefix in _COMPONENTS
                for k, v in state.get(comp, {}).items()}
    return dict(state.get("state_dict", state))


def _model_key(model: torch.nn.Module):
    """Reference key -> the model's key: a stage-1 Basenet names the
    embedding ``fc_emb`` where the JAX package's files write ``fc_emb_1``
    (the reference's Basenet writes ``fc_emb`` itself)."""
    own = model.state_dict()
    if "fc_emb_1.weight" not in own and "fc_emb.weight" in own:
        return lambda k: ("fc_emb." + k[len("fc_emb_1."):]
                          if k.startswith("fc_emb_1.") else k)
    return lambda k: k


def load_reference_checkpoint(model: torch.nn.Module, path_or_state
                              ) -> List[str]:
    """Loads every tensor of a reference ``.pth`` (either format) whose key
    the model has into ``model`` in place; returns the keys it skipped.
    A key the model has with another shape raises ``ValueError``, as
    ``load_state_dict`` finds it after the model's own load hooks (which
    read the layouts of din_tpu's files, heads/arg.py); the tensors of
    other keys may have loaded by then."""
    flat = reference_state_dict(_read(path_or_state))
    key = _model_key(model)
    own = model.state_dict()
    load, skipped = {}, []
    for k, v in flat.items():
        mk = key(k)
        if mk not in own:
            skipped.append(k)
            continue
        load[mk] = v
    try:
        model.load_state_dict(load, strict=False)
    except RuntimeError as e:
        bad = re.search(r"size mismatch for (\S+): (.*)", str(e))
        if bad is None:
            raise
        raise ValueError(f"shape mismatch at {bad.group(1)}: "
                         f"{bad.group(2)}") from None
    return sorted(skipped)


def _scalar(v) -> float:
    """``step`` is a tensor since torch 1.12 and an int in torch 1.2, the
    reference's version."""
    return float(v.item() if hasattr(v, "item") else v)


def load_reference_optimizer(model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer, path_or_state,
                             cfg) -> int:
    """Adopts the torch Adam state a reference full checkpoint saved:
    ``exp_avg``, ``exp_avg_sq``, ``step`` and the first group's ``lr``, in
    place.  Returns the file's epoch; training resumes at epoch + 1.

    The JAX package keeps one step count for all parameters (optax), the
    largest in the file, and zero moments where the file has none; so does
    this: every trainable parameter gets that step.  A file without
    optimizer state leaves the optimizer as it is.  ``model``'s trainable
    parameters must be ``optimizer``'s."""
    state = _read(path_or_state)
    epoch = int(state.get("epoch", 0))
    opt_sd = state.get("optimizer") or {}
    if not opt_sd.get("state"):
        return epoch

    names = [k for k in reference_state_dict(state)
             if not k.endswith(_BUFFER_SUFFIXES)]
    if not cfg.train_backbone:
        names = [k for k in names if not k.startswith("backbone.")]
    ids = [pid for g in opt_sd["param_groups"] for pid in g["params"]]
    if len(ids) != len(names):
        raise ValueError(
            f"optimizer has {len(ids)} params but the checkpoint implies "
            f"{len(names)} trainable tensors — was train_backbone "
            f"({cfg.train_backbone}) different in the reference run?")
    id2name = dict(zip(ids, names))

    key = _model_key(model)
    params = dict(model.named_parameters())
    trainable = {id(p) for g in optimizer.param_groups for p in g["params"]}
    moments: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    steps = [0.0]
    for pid, pstate in opt_sd["state"].items():
        name = id2name[int(pid)]
        mu, nu = pstate["exp_avg"], pstate["exp_avg_sq"]
        lstm = _LSTM_BIAS.search(name)
        if lstm and key(name[:lstm.start(1)] + "hh" + name[lstm.end(1):]) \
                not in params:
            # nn.LSTM's two biases, trained as their sum in bias_ih_l0
            # (heads/pctdm.py): both moments halved and added there, as
            # din_tpu's import does (ref_import.py:350-356)
            name = name[:lstm.start(1)] + "ih" + name[lstm.end(1):]
            mu, nu = 0.5 * mu, 0.5 * nu
        p = params.get(key(name))
        if p is None:              # a tensor the model has not: skipped
            continue
        if id(p) not in trainable:
            raise ValueError(f"moment supplied for frozen param at {name}")
        if tuple(mu.shape) != tuple(p.shape) or \
                tuple(nu.shape) != tuple(p.shape):
            raise ValueError(f"moment shape mismatch at {name}: "
                             f"{tuple(p.shape)} vs {tuple(mu.shape)}")
        if id(p) in moments:       # the other LSTM bias's half
            mu, nu = moments[id(p)][0] + mu, moments[id(p)][1] + nu
        moments[id(p)] = (mu, nu)
        steps.append(_scalar(pstate["step"]))

    step = max(steps)
    for group in optimizer.param_groups:
        for p in group["params"]:
            mu, nu = moments.get(id(p), (torch.zeros_like(p),
                                         torch.zeros_like(p)))
            optimizer.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": mu.to(p.device, p.dtype).clone(),
                "exp_avg_sq": nu.to(p.device, p.dtype).clone(),
            }
    lr = opt_sd["param_groups"][0].get("lr")
    if lr is not None:
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
    return epoch


def load_pretrained_backbone(model: torch.nn.Module, path: str) -> None:
    """Loads a torchvision-layout ``state_dict`` file (bare, or under
    ``'state_dict'``) of the model's backbone into ``model.backbone`` in
    place, strictly over the backbone's own modules, BatchNorm statistics
    included, as din_tpu/nn/torch_port.py ``convert_backbone_state`` reads
    it (lines 35-111): VGG-16's, VGG-19's and AlexNet's ``features.*``
    (``classifier.*`` unused); ResNet-18's and ResNet-50's ``conv1``,
    ``bn1`` and ``layer1``-``layer4`` into ``features.0``, ``.1`` and
    ``.4``-``.7`` (``fc.*`` unused); Inception-v3's ``Conv2d_1a_3x3``
    through ``Mixed_6e`` (``AuxLogits.*``, ``Mixed_7a``-``Mixed_7c`` and
    ``fc.*`` unused; torchvision's ``transform_input`` is not applied,
    as din_tpu applies none).  A tensor of those modules that the file
    lacks, has besides or has in another shape raises; so does a model
    whose backbone is none of ``BACKBONES``."""
    names = [k for k, cls in BACKBONES.items()
             if type(model.backbone) is cls]
    if not names:
        raise ValueError(f"a backbone of type "
                         f"{type(model.backbone).__name__} is none of "
                         f"{sorted(BACKBONES)}")
    state = _read(path)
    if "state_dict" in state:
        state = state["state_dict"]
    if names[0] in ("res18", "res50"):     # din_tpu/nn/torch_port.py:46-61
        renamed = {}
        for k, v in state.items():
            head, _, rest = k.partition(".")
            if head in RESNET_SEQ:
                renamed[f"{RESNET_SEQ[head]}.{rest}"] = v
        state = renamed
    own = {name for name, _ in model.backbone.named_children()}
    model.backbone.load_state_dict(
        {k: v for k, v in state.items() if k.partition(".")[0] in own},
        strict=True)
