"""JAX parameters -> the port's ``state_dict`` (numpy only).

The port's own copy of what it needs from din_tpu/nn/ref_export.py
``export_model_state`` (lines 221-305), for the models the port has: conv
kernels HWIO -> OIHW, Dense kernels [I,O] -> [O,I], ``point_conv`` to a 1x1
conv and the DIN convs as ``_pointconv_inv`` / ``_din_inv`` do
(lines 126-153), ``fc_emb_1`` permuted from the JAX trunk's position-major
RoI flatten to the reference's channel-major one (``_fc_emb_inv``,
lines 212-218).  Keys are the reference's, which are the port's module
names: ``backbone.features.N``, ``fc_emb_1``, ``nl_emb_1``, ``point_conv``,
``point_ln``, ``DPI.DIMlist.{i}.*``, ``dpi_nl``, ``fc_activities``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


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
    """JAX ``variables['params']`` of a DynamicVolleyball (nested dicts of
    arrays) -> the port's ``state_dict`` as numpy arrays."""
    K = cfg.crop_size[0]
    D = cfg.emb_features
    out: Dict[str, np.ndarray] = {}

    backbone = params["trunk"]["frames_scan"]["backbone"]
    for name in sorted(backbone):
        _conv(backbone[name], f"backbone.{_backbone_key(name)}", out)

    fc = params["embed"]["fc_emb_1"]
    kernel = _np(fc["kernel"])                       # [K*K*D, NFB], (i,j,d)
    nfb = kernel.shape[1]
    out["fc_emb_1.weight"] = kernel.T.reshape(nfb, K, K, D) \
        .transpose(0, 3, 1, 2).reshape(nfb, -1)
    out["fc_emb_1.bias"] = _np(fc["bias"])
    _ln(params["embed"]["nl_emb_1"], "nl_emb_1", out)

    for k, v in params["DPI"].items():
        _din(v, f"DPI.DIMlist.{k.split('_')[1]}.", out)
    for tln in ("dpi_nl", "point_ln"):
        if tln in params:
            _ln(params[tln]["ln"], tln, out)
    if "point_conv" in params:
        pc = params["point_conv"]
        out["point_conv.weight"] = _np(pc["kernel"]).T[:, :, None, None]
        out["point_conv.bias"] = _np(pc["bias"])
    _lin(params["fc_activities"], "fc_activities", out)
    return out
