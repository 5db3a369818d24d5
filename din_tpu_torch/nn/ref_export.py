"""JAX parameters and Adam state -> the port's ``state_dict`` and torch
Adam state (numpy only).

The port's own copy of what it needs from din_tpu/nn/ref_export.py
``export_model_state`` (lines 221-305), for the models the port has: conv
kernels HWIO -> OIHW, Dense kernels [I,O] -> [O,I], ``point_conv`` to a 1x1
conv and the DIN convs as ``_pointconv_inv`` / ``_din_inv`` do
(lines 126-153), ``fc_emb_1`` permuted from the JAX trunk's position-major
RoI flatten to the reference's channel-major one (``_fc_emb_inv``,
lines 212-218).  Keys are the reference's, which are the port's module
names: ``backbone.features.N``, ``fc_emb_1``, ``nl_emb_1``, ``point_conv``,
``point_ln``, ``DPI.DIMlist.{i}.*``, ``dpi_nl``, ``fc_activities``; for a
stage-1 Basenet ``backbone.features.N``, ``fc_emb``, ``fc_actions``,
``fc_activities``.

``jax_train_state_to_torch`` carries a JAX training run into the port:
optax ``scale_by_adam``'s ``mu``/``nu``/``count`` become torch Adam's
``exp_avg``/``exp_avg_sq``/``step`` through the same permutations as the
weights (both apply the same bias correction); it is the reverse of
``adopt_adam_moments`` (din_tpu/train/optim.py:63-94).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _lin(d, key, out):
    out[f"{key}.weight"] = _np(d["kernel"]).T
    if "bias" in d:
        out[f"{key}.bias"] = _np(d["bias"])


def _ln(d, key, out):
    out[f"{key}.weight"] = _np(d["scale"])
    out[f"{key}.bias"] = _np(d["bias"])


def _conv(d, key, out):
    out[f"{key}.weight"] = _np(d["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in d:
        out[f"{key}.bias"] = _np(d["bias"])


def _din(d, prefix, out):
    """One DynamicPersonInference -> ``{prefix}hidden_weight``, ``beta``,
    ``p_conv.{ratio}``, ``scale_conv.{ratio}``."""
    if "hidden_weight" in d:
        out[f"{prefix}hidden_weight.weight"] = \
            _np(d["hidden_weight"]["kernel"]).T
    if "beta" in d:
        out[f"{prefix}beta"] = _np(d["beta"])
    for k, v in d.items():
        for name in ("p_conv", "scale_conv"):
            if k.startswith(name + "_"):
                _conv(v, f"{prefix}{name}.{k[len(name) + 1:]}", out)


def _backbone_key(name: str) -> str:
    """flax ``features_N`` -> torch ``features.N`` (VGG)."""
    head, _, idx = name.rpartition("_")
    if not (head and idx.isdigit()):
        raise ValueError(f"unexpected backbone module name {name!r}")
    return f"{head}.{idx}"


def jax_params_to_state_dict(params: Dict[str, Any], cfg
                             ) -> Dict[str, np.ndarray]:
    """JAX ``variables['params']`` of a DynamicVolleyball or, at
    ``cfg.training_stage == 1``, a BasenetVolleyball (nested dicts of arrays)
    -> the port's ``state_dict`` as numpy arrays.  The stage-1 embedding
    ``embed/fc_emb_1`` is the Basenet's ``fc_emb`` (ref_export.py:313-334)."""
    K = cfg.crop_size[0]
    D = cfg.emb_features
    out: Dict[str, np.ndarray] = {}

    backbone = params["trunk"]["frames_scan"]["backbone"]
    for name in sorted(backbone):
        _conv(backbone[name], f"backbone.{_backbone_key(name)}", out)

    fc = params["embed"]["fc_emb_1"]
    fc_key = "fc_emb" if cfg.training_stage == 1 else "fc_emb_1"
    kernel = _np(fc["kernel"])                       # [K*K*D, NFB], (i,j,d)
    nfb = kernel.shape[1]
    out[f"{fc_key}.weight"] = kernel.T.reshape(nfb, K, K, D) \
        .transpose(0, 3, 1, 2).reshape(nfb, -1)
    out[f"{fc_key}.bias"] = _np(fc["bias"])
    if "nl_emb_1" in params["embed"]:
        _ln(params["embed"]["nl_emb_1"], "nl_emb_1", out)

    for k, v in params.get("DPI", {}).items():
        _din(v, f"DPI.DIMlist.{k.split('_')[1]}.", out)
    for tln in ("dpi_nl", "point_ln"):
        if tln in params:
            _ln(params[tln]["ln"], tln, out)
    if "point_conv" in params:
        pc = params["point_conv"]
        out["point_conv.weight"] = _np(pc["kernel"]).T[:, :, None, None]
        out["point_conv.bias"] = _np(pc["bias"])
    for head in ("fc_actions", "fc_activities"):
        if head in params:
            _lin(params[head], head, out)
    return out


def _find_state(state, attrs):
    """The first node of an optax state (nested namedtuples) that has all
    of ``attrs``."""
    if all(hasattr(state, a) for a in attrs):
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _find_state(s, attrs)
            if found is not None:
                return found
    return None


def _fill_masked(tree, like):
    """Moments of frozen parameters are ``optax.MaskedNode``s: zeros of the
    parameter's shape take their place (they are not carried over)."""
    if isinstance(tree, dict):
        return {k: _fill_masked(tree[k], like[k]) for k in like}
    return tree if hasattr(tree, "shape") else np.zeros_like(np.asarray(like))


def jax_train_state_to_torch(params: Dict[str, Any], opt_state, cfg,
                             model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer) -> None:
    """Loads JAX ``params`` into ``model`` and the Adam state of
    ``opt_state`` (an optax ``make_optimizer`` state) into ``optimizer``, in
    place: moments, step count and the injected learning rate.  The model's
    trainable parameters must be the optimizer's."""
    adam = _find_state(opt_state, ("mu", "nu", "count"))
    if adam is None:
        raise ValueError("no scale_by_adam state found in opt_state")
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v))
         for k, v in jax_params_to_state_dict(params, cfg).items()},
        strict=True)
    mu = jax_params_to_state_dict(_fill_masked(adam.mu, params), cfg)
    nu = jax_params_to_state_dict(_fill_masked(adam.nu, params), cfg)
    step = float(np.asarray(adam.count))
    trainable = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        if id(p) not in trainable:
            continue
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(mu[name], np.float32)).to(
                p.device),
            "exp_avg_sq": torch.from_numpy(np.array(nu[name], np.float32)).to(
                p.device),
        }
    hyper = _find_state(opt_state, ("hyperparams",))
    if hyper is not None and "learning_rate" in hyper.hyperparams:
        lr = float(np.asarray(hyper.hyperparams["learning_rate"]))
        for group in optimizer.param_groups:
            group["lr"] = lr
