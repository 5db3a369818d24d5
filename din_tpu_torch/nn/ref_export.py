"""JAX parameters and Adam state -> the port's ``state_dict`` and torch
Adam state (numpy only).

The port's own copy of what it needs from din_tpu/nn/ref_export.py
``export_backbone_state`` and ``export_model_state`` (lines 35-95,
221-305), for every model of din_tpu's registry: conv kernels HWIO ->
OIHW, Dense kernels [I,O] -> [O,I], BatchNorm ``scale``/``bias`` and
``batch_stats`` ``mean``/``var`` -> ``weight``/``bias``/``running_mean``/
``running_var`` with ``num_batches_tracked = 0``, ``point_conv`` to a 1x1
conv and the DIN convs as ``_pointconv_inv`` / ``_din_inv`` do (lines
126-153), the hierarchical head's ``DPI_1``/``hier_LN``/``DPI_2`` (lines
248-254), the TCE heads as ``_tce_inv`` does (line 196), the baselines'
heads as lines 132-195 and 256-295 write them (``_lstm``, ``_att_block``,
``_gcn``, ``_cib``: AT, SACRF+BiUTE, PCTDM, HiGCIN, ARG and GCNNet),
``fc_emb_1`` permuted from the JAX trunk's position-major RoI flatten to
the reference's channel-major one (``_fc_emb_inv``, lines 212-218).  Keys are the
reference's, which are the port's module names: ``backbone.features.N``
(ResNet-18 and -50: ``features.0``/``features.1`` for conv1/bn1 and
``features.4``-``features.7`` for layer1-4, ``RESNET_SEQ``; Inception-v3:
``backbone.Conv2d_1a_3x3.conv`` ... ``backbone.Mixed_6e.branch_pool.bn``
with its BatchNorm ``batch_stats``), ``fc_emb_1``,
``nl_emb_1``, ``point_conv``, ``point_ln``, ``DPI.DIMlist.{i}.*`` (the
collective model's one field: ``DPI.*``; the hierarchical head:
``DPI.DPI_1.*``, ``DPI.hier_LN.*``, ``DPI.DPI_2.*``), ``dpi_nl``,
``multilayer_head_embfeature_context_encoding.CET.{k}.*``, ``fc_activities``;
for a stage-1 Basenet ``backbone.*``, ``fc_emb``, ``fc_actions``,
``fc_activities``; for the raw-RoI TCE and bilinear modules of
``heads/tce.py``, which no model holds, the module's own keys (``CET.{k}.*``
with ``downsample1``/``downsample2``; ``bilinear_list.{i}.*``).

``jax_train_state_to_torch`` carries a JAX training run into the port:
optax ``scale_by_adam``'s ``mu``/``nu``/``count`` become torch Adam's
``exp_avg``/``exp_avg_sq``/``step`` through the same permutations as the
weights (both apply the same bias correction); it is the reverse of
``adopt_adam_moments`` (din_tpu/train/optim.py:63-94).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from din_tpu_torch.nn.backbones import RESNET_SEQ


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


def _tce(d, prefix, out, num_heads=4):
    """``MultiHeadTCE`` params (``CET_{layer}_{head}``) -> ``{prefix}CET.
    {layer * num_heads + head}.*``; the first layer's 1x1 conv is
    ``downsample2``, a later one's ``downsample`` (ref_export.py:196-210)."""
    for k, v in d.items():
        i, j = (int(s) for s in k.split("_")[1:])
        key = f"{prefix}CET.{i * num_heads + j}."
        ds = "downsample2" if i == 0 else "downsample"
        out[f"{key}{ds}.weight"] = \
            _np(v["downsample"]["kernel"]).T[:, :, None, None]
        out[f"{key}{ds}.bias"] = _np(v["downsample"]["bias"])
        _lin(v["emb_roi"], f"{key}emb_roi", out)
        _ln(v["layernorm1"], f"{key}layernorm1", out)
        _ln(v["layernorm2"], f"{key}layernorm2", out)
        _lin(v["FFN_1"], f"{key}FFN.0", out)
        _lin(v["FFN_2"], f"{key}FFN.3", out)


def _conv1x1(d, key, out):
    """A Dense over channels -> a 1x1 conv."""
    out[f"{key}.weight"] = _np(d["kernel"]).T[:, :, None, None]
    out[f"{key}.bias"] = _np(d["bias"])


def _raw_tce(d, prefix, out):
    """One raw-RoI ``ContextEncoding``: layer 1's ``downsample1``,
    ``downsample2`` and ``emb_roi``, whose input din_tpu flattens
    position-major ``(i, j, c)`` and the reference channel-major ``(c, i,
    j)`` (the inverse of tests/test_reference_oracle.py ``_raw_tce_port``);
    a later layer's ``downsample`` and ``emb_roi``; the shared tail."""
    if "downsample1" in d:
        _conv1x1(d["downsample1"], f"{prefix}downsample1", out)
        _conv1x1(d["downsample2"], f"{prefix}downsample2", out)
        kernel = _np(d["emb_roi"]["kernel"])           # [K*K*NFC, NFC]
        nfc = kernel.shape[1]
        K = int(round(np.sqrt(kernel.shape[0] / nfc)))
        out[f"{prefix}emb_roi.weight"] = kernel.T.reshape(
            nfc, K, K, nfc).transpose(0, 3, 1, 2).reshape(nfc, -1)
        out[f"{prefix}emb_roi.bias"] = _np(d["emb_roi"]["bias"])
    else:
        _conv1x1(d["downsample"], f"{prefix}downsample", out)
        _lin(d["emb_roi"], f"{prefix}emb_roi", out)
    _ln(d["layernorm1"], f"{prefix}layernorm1", out)
    _ln(d["layernorm2"], f"{prefix}layernorm2", out)
    _lin(d["FFN_1"], f"{prefix}FFN.0", out)
    _lin(d["FFN_2"], f"{prefix}FFN.3", out)


def _stbilinear(d, prefix, out):
    """One ``STBilinearMessagePassing``: ``U``, ``V``, ``w_a``, ``W_e2``,
    ``layernorm``, ``W_e1``."""
    for name in ("U", "V", "W_e2", "W_e1"):
        _lin(d[name], f"{prefix}{name}", out)
    out[f"{prefix}w_a"] = _np(d["w_a"])
    _ln(d["layernorm"], f"{prefix}layernorm", out)


def _tce_pieces(params) -> Dict[str, np.ndarray]:
    """The params of one of din_tpu/heads/tce.py's modules that no model
    holds (``MultiHeadLayerContextEncoding``, ``ContextEncoding``,
    ``MultiHeadSTBilinear``, ``STBilinearMessagePassing``) or of a
    ``MultiHeadTCE`` alone -> that port module's ``state_dict``."""
    out: Dict[str, np.ndarray] = {}
    if "CET_0_0" in params:
        heads = 1 + max(int(k.split("_")[2]) for k in params)
        if "downsample1" not in params["CET_0_0"]:
            _tce(params, "", out, heads)
            return out
        for k, v in params.items():
            i, j = (int(s) for s in k.split("_")[1:])
            _raw_tce(v, f"CET.{i * heads + j}.", out)
    elif "emb_roi" in params:
        _raw_tce(params, "", out)
    elif "U" in params:
        _stbilinear(params, "", out)
    else:
        for k, v in params.items():
            _stbilinear(v, f"bilinear_list.{k.split('_')[1]}.", out)
    return out


def _lstm(d, key, out, suffix=""):
    """din_tpu's ``TorchLSTM`` (one fused bias) -> ``nn.LSTM`` keys with
    ``bias_ih = bias``, ``bias_hh = 0`` (ref_export.py:132-136)."""
    out[f"{key}.weight_ih_l0{suffix}"] = _np(d["kernel_i"]).T
    out[f"{key}.weight_hh_l0{suffix}"] = _np(d["kernel_h"]).T
    out[f"{key}.bias_ih_l0{suffix}"] = _np(d["bias"])
    out[f"{key}.bias_hh_l0{suffix}"] = np.zeros_like(_np(d["bias"]))


def _att_block(d, prefix, out):
    """A SACRF attention block: heads ``att_{i}`` -> ``attlist.{i}.*``,
    ``W_out``, ``layernorm1``, the FFN and the spatial block's ``w``
    (ref_export.py:154-168)."""
    for k, v in d.items():
        if k.startswith("att_"):
            for name in ("theta", "phi", "fun_g"):
                _lin(v[name], f"{prefix}attlist.{k[4:]}.{name}", out)
    _lin(d["W_out"], f"{prefix}W_out", out)
    _ln(d["layernorm1"], f"{prefix}layernorm1", out)
    _lin(d["FFN_linear1"], f"{prefix}FFN_linear1", out)
    _lin(d["FFN_linear2"], f"{prefix}FFN_linear2", out)
    if "w" in d:
        out[f"{prefix}w"] = _np(d["w"])


def _gcn(d, prefix, out, ln_over_features: bool):
    """A GCN layer's stacked [NG, ...] arrays -> the per-graph ModuleList
    keys (ref_export.py:171-184).  A LayerNorm over [NFG] (the collective
    model) is stored [NG, 1, NFG] in din_tpu and [NFG] per graph here, as
    in the reference."""
    for i in range(_np(d["theta_kernel"]).shape[0]):
        for name, kernel, bias in (("fc_rn_theta_list", "theta_kernel",
                                    "theta_bias"),
                                   ("fc_rn_phi_list", "phi_kernel",
                                    "phi_bias")):
            out[f"{prefix}{name}.{i}.weight"] = _np(d[kernel])[i].T
            out[f"{prefix}{name}.{i}.bias"] = _np(d[bias])[i]
        out[f"{prefix}fc_gcn_list.{i}.weight"] = _np(d["gcn_kernel"])[i].T
        for k, leaf in (("weight", "nl_gcn_scale"), ("bias", "nl_gcn_bias")):
            v = _np(d[leaf])[i]
            out[f"{prefix}nl_gcn_list.{i}.{k}"] = v.reshape(-1) \
                if ln_over_features else v


def _cib(params, stats, prefix, out):
    """A HiGCIN CrossInferBlock and its BatchNorm statistics
    (ref_export.py:187-195)."""
    for name in ("theta", "phi", "fun_g", "W"):
        _lin(params[name], f"{prefix}{name}", out)
    _ln(params["bn"], f"{prefix}bn", out)
    if stats:
        out[f"{prefix}bn.running_mean"] = _np(stats["bn"]["mean"])
        out[f"{prefix}bn.running_var"] = _np(stats["bn"]["var"])
        out[f"{prefix}bn.num_batches_tracked"] = np.asarray(0, np.int64)


def _module_key(path, backbone: str) -> str:
    """flax module names -> torch key prefix (ref_export.py:42-66): a
    numeric part joins its parent with '.' (``features_3`` ->
    ``features.3``, ``layer1_0`` -> ``layer1.0``, ``downsample_1`` ->
    ``downsample.1``), but Inception-v3's names keep their literal
    underscores (``Mixed_6e``, ``branch7x7dbl_5`` are torchvision's own);
    ResNet's stages sit in the reference's Sequential."""
    segs = []
    for comp in path:
        parts = comp.split("_")
        seg = parts[0]
        for p in parts[1:]:
            merge = p.isdigit() and backbone != "inv3"
            seg += ("." + p) if merge else ("_" + p)
        segs.append(seg)
    key = ".".join(segs)
    if backbone in ("res18", "res50"):
        head, _, rest = key.partition(".")
        if head in RESNET_SEQ:
            key = RESNET_SEQ[head] + ("." + rest if rest else "")
    return key


def export_backbone_state(params: Dict[str, Any],
                          batch_stats: Optional[Dict[str, Any]],
                          backbone: str) -> Dict[str, np.ndarray]:
    """A JAX backbone's params and BatchNorm statistics -> the port's
    ``backbone.state_dict()`` (ref_export.py:67-95)."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree, path):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            key = _module_key(path, backbone)
            v = _np(v)
            if k == "kernel":
                out[f"{key}.weight"] = v.transpose(3, 2, 0, 1)
            elif k == "scale":
                out[f"{key}.weight"] = v
            elif k in ("mean", "var"):
                out[f"{key}.running_{k}"] = v
                out[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)
            else:
                out[f"{key}.{k}"] = v

    walk(params, ())
    walk(batch_stats or {}, ())
    return out


def jax_params_to_state_dict(params: Dict[str, Any], cfg,
                             batch_stats: Optional[Dict[str, Any]] = None
                             ) -> Dict[str, np.ndarray]:
    """JAX ``variables['params']`` (and, for a backbone or head with
    BatchNorm, ``variables['batch_stats']``) of a stage-2 model (DIN,
    TCE+DIN or a baseline: PCTDM, HiGCIN, AT, ARG, SACRF+BiUTE, GCNNet)
    or, at ``cfg.training_stage == 1``, a Basenet (nested dicts of arrays)
    -> the port's ``state_dict`` as numpy arrays.  The stage-1 embedding
    ``embed/fc_emb_1`` is the Basenet's ``fc_emb`` (ref_export.py:313-334).
    Without ``batch_stats`` HiGCIN's head BatchNorms get no buffers (the
    Adam moments of ``jax_train_state_to_torch`` have none).  The params of
    one of din_tpu/heads/tce.py's raw-RoI or bilinear modules, which no
    model holds, give that port module's ``state_dict`` (``cfg`` unused)."""
    if "trunk" not in params:
        return _tce_pieces(params)
    K = cfg.crop_size[0]
    D = cfg.emb_features
    out: Dict[str, np.ndarray] = {}

    stats = (batch_stats or {}).get("trunk", {}).get("frames_scan", {}) \
        .get("backbone")
    for k, v in export_backbone_state(params["trunk"]["frames_scan"]
                                      ["backbone"], stats,
                                      cfg.backbone).items():
        out["backbone." + k] = v

    embed = params.get("embed", {})          # HiGCIN has no embedding
    if "fc_emb_1" in embed:
        fc = embed["fc_emb_1"]
        fc_key = "fc_emb" if cfg.training_stage == 1 else "fc_emb_1"
        kernel = _np(fc["kernel"])                   # [K*K*D, NFB], (i,j,d)
        nfb = kernel.shape[1]
        out[f"{fc_key}.weight"] = kernel.T.reshape(nfb, K, K, D) \
            .transpose(0, 3, 1, 2).reshape(nfb, -1)
        out[f"{fc_key}.bias"] = _np(fc["bias"])
    if "nl_emb_1" in embed:
        _ln(embed["nl_emb_1"], "nl_emb_1", out)

    dpi = params.get("DPI", {})
    if "DPI_1" in dpi:                                # hierarchical
        _din(dpi["DPI_1"], "DPI.DPI_1.", out)
        _din(dpi["DPI_2"], "DPI.DPI_2.", out)
        _ln(dpi["hier_LN"], "DPI.hier_LN", out)
    elif "collective" in cfg.inference_module_name and dpi:
        _din(dpi["DIM_0"], "DPI.", out)               # Dynamic_collective
    else:
        for k, v in dpi.items():
            _din(v, f"DPI.DIMlist.{k.split('_')[1]}.", out)
    if "tce" in params:
        _tce(params["tce"], "multilayer_head_embfeature_context_encoding.",
             out)
    for tln in ("dpi_nl", "point_ln", "pctdm_nl"):
        if tln in params:
            _ln(params[tln]["ln"], tln, out)
    if "AT" in params:
        for name in ("Q_W", "K_W", "V_W", "FFN_linear1", "FFN_linear2"):
            _lin(params["AT"][name], f"AT.{name}", out)
        for name in ("layernorm1", "layernorm2"):
            _ln(params["AT"][name], f"AT.{name}", out)
    if "SACRF" in params:
        sacrf = params["SACRF"]
        for name in ("f_u", "f_spatil_att", "f_temporal_att",
                     "compatible_trans_s", "compatible_trans_t", "halt_fc"):
            _lin(sacrf[name], f"SACRF.{name}", out)
        _att_block(sacrf["spatial_att"], "SACRF.spatial_att.", out)
        _att_block(sacrf["temporal_att"], "SACRF.temporal_att.", out)
    if "BiUTE" in params:
        _lin(params["BiUTE"]["q"], "BiUTE.q", out)
    if "pctdm" in params:
        p = params["pctdm"]
        _lstm(p["Bi_Lstm"]["fwd"], "pctdm.Bi_Lstm", out)
        _lstm(p["Bi_Lstm"]["bwd"], "pctdm.Bi_Lstm", out, "_reverse")
        for name in ("att_source_weights", "att_context_weights",
                     "att_extra_weights"):
            _lin(p[name], f"pctdm.{name}.0", out)
        _lstm(p["Intra_Group_LSTM"], "pctdm.Intra_Group_LSTM", out)
    for cib in ("BIM", "PIM"):
        if cib in params:
            _cib(params[cib], (batch_stats or {}).get(cib), f"{cib}.", out)
    for k in sorted(params):
        if k.startswith("gcn_"):
            _gcn(params[k], f"gcn_list.{k.split('_')[1]}.", out,
                 "collective" in cfg.inference_module_name)
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
                             optimizer: torch.optim.Optimizer,
                             batch_stats: Optional[Dict[str, Any]] = None
                             ) -> None:
    """Loads JAX ``params`` (and ``batch_stats``) into ``model`` and the
    Adam state of ``opt_state`` (an optax ``make_optimizer`` state) into
    ``optimizer``, in place: moments, step count and the injected learning
    rate.  The model's trainable parameters must be the optimizer's."""
    adam = _find_state(opt_state, ("mu", "nu", "count"))
    if adam is None:
        raise ValueError("no scale_by_adam state found in opt_state")
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v))
         for k, v in jax_params_to_state_dict(params, cfg,
                                              batch_stats).items()},
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
