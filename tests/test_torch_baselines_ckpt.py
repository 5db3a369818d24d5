"""Reference files of the ResNet-18 baselines into the port, on the CPU,
with the models, weights and helpers of tests/test_torch_baselines.py.

din_tpu's ``save_reference_checkpoint`` of each model (PCTDM, HiGCIN, AT,
ARG, SACRF+BiUTE, GCNNet for Volleyball and Collective Activity) loads into
the port by name with nothing skipped and strictly through ``load_state``
(din_tpu writes a collective GCN layer's LayerNorm as [1, NFG], the
reference as [NFG]: both load).  A PCTDM file whose LSTMs carry two
different biases loads as din_tpu's import reads it (their sums, the
port's ``bias_hh_l0`` 0), and its Adam state (moments of both biases) is
adopted as din_tpu's ``load_reference_optimizer`` adopts it: halved and
added onto the one trainable bias.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from din_tpu.nn.ref_export import save_reference_checkpoint
from din_tpu.nn.ref_import import load_reference_checkpoint as jax_load_ref
from din_tpu.nn.ref_import import load_reference_optimizer as jax_load_opt
from din_tpu.train.optim import make_optimizer as jax_make_optimizer
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import jax_params_to_state_dict
from din_tpu_torch.nn.ref_import import (load_reference_checkpoint,
                                         load_reference_optimizer)
from din_tpu_torch.train.checkpoint import load_state
from din_tpu_torch.train.optim import make_optimizer
from test_torch_baselines import CASES, GEOM, port_state, setup
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ["pctdm", "higcin", "at", "arg", "sacrf",
                                  "gcnnet_volleyball", "gcnnet_collective"])
def test_reference_file_loads_by_name_and_strictly(name, tmp_path):
    """din_tpu's reference-layout ``.pth`` of the case's weights: nothing
    skipped by ``load_reference_checkpoint``, every tensor of the model
    covered and equal to ``jax_params_to_state_dict``'s, and the same file
    loads strictly through ``load_state`` (what ``Predictor.
    from_checkpoint`` and ``--stage2-model-path`` use)."""
    case = setup(name)
    path = str(tmp_path / "ref.pth")
    save_reference_checkpoint(case["variables"], case["jcfg"], path)
    saved = torch.load(path, weights_only=True)
    want = case["model"].state_dict()     # jax_params_to_state_dict's
    for load in (lambda m: load_reference_checkpoint(m, saved),
                 lambda m: load_state(path, m)):
        model = build_model(case["cfg"], device="cpu")
        assert not load(model)            # nothing skipped; epoch 0
        own = model.state_dict()
        assert sorted(saved["state_dict"]) == sorted(own) == sorted(want)
        assert all(torch.equal(v, want[k]) for k, v in own.items())


def test_pctdm_reference_lstm_biases_and_adam_state(tmp_path):
    """A reference PCTDM file whose LSTMs carry two different biases, with
    Adam moments for every trainable tensor (both biases' differ), in the
    reference's index order: the port's weights equal din_tpu's import of
    the file (each bias the sum of the two, ``bias_hh_l0`` 0), and its
    adopted moments equal din_tpu's, the two biases' halved and summed
    onto ``bias_ih_l0``; the step and lr are the file's."""
    case = setup("pctdm", seed=3)
    cfg, jcfg = case["cfg"], case["jcfg"]
    path = str(tmp_path / "ref.pth")
    save_reference_checkpoint(case["variables"], jcfg, path)
    saved = torch.load(path, weights_only=True)
    rng = np.random.RandomState(4)
    # the head alone: a partial file loads by name (the reference's
    # loadpart), and leaving the backbone out keeps the file small
    state = {k: v for k, v in saved["state_dict"].items()
             if not k.startswith("backbone.")}
    for k in [k for k in state if ".bias_hh_l0" in k]:
        shift = torch.from_numpy(rng.randn(*state[k].shape).astype(
            np.float32))
        state[k] = state[k] + shift
        state[k.replace("_hh_", "_ih_")] -= 0.5 * shift
    names = [k for k in state if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    opt = {"state": {i: {"step": torch.tensor(7.0),
                         "exp_avg": torch.randn(state[k].shape),
                         "exp_avg_sq": torch.rand(state[k].shape)}
                     for i, k in enumerate(names)},
           "param_groups": [{"lr": 3e-5, "params": list(range(len(names)))}]}
    torch.save({"epoch": 4, "state_dict": state, "optimizer": opt}, path)

    model = case["model"]
    assert load_reference_checkpoint(model, path) == []
    optimizer = make_optimizer(cfg, model)
    assert load_reference_optimizer(model, optimizer, path, cfg) == 4

    jvars, skipped = jax_load_ref(case["variables"], path, jcfg,
                                  verbose=False)
    assert skipped == []
    want = port_state(jvars, cfg)
    own = model.state_dict()
    for k, v in want.items():
        assert (own[k] - v).abs().max() <= 1e-6, k
    lstm_biases = [k for k in own if ".bias_ih_l0" in k]
    assert len(lstm_biases) == 3
    for k in lstm_biases:
        assert not own[k.replace("_ih_", "_hh_")].any()
        torch.testing.assert_close(own[k], state[k] + state[
            k.replace("_ih_", "_hh_")], rtol=0, atol=1e-6)

    tx = jax_make_optimizer(jcfg, jvars["params"])
    jopt, epoch = jax_load_opt(jax.jit(tx.init)(jvars["params"]), path,
                               jcfg)
    assert epoch == 4
    adam = next(s for s in jax.tree_util.tree_leaves(
        jopt, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    mu = jax_params_to_state_dict(jax.device_get(adam.mu), cfg)
    nu = jax_params_to_state_dict(jax.device_get(adam.nu), cfg)
    params = dict(model.named_parameters())
    for name, p in params.items():
        st = optimizer.state[p]
        assert float(st["step"]) == 7.0
        for got, want_m in ((st["exp_avg"], mu[name]),
                            (st["exp_avg_sq"], nu[name])):
            err = np.abs(got.numpy() - want_m).max()
            assert err <= 1e-6 * np.abs(want_m).max() + 1e-7, (name, err)
    for k in lstm_biases:
        i, h = names.index(k), names.index(k.replace("_ih_", "_hh_"))
        torch.testing.assert_close(
            optimizer.state[params[k]]["exp_avg"],
            0.5 * (opt["state"][i]["exp_avg"] + opt["state"][h]["exp_avg"]))
    assert optimizer.param_groups[0]["lr"] == 3e-5


@pytest.mark.parametrize("name,key,shape", [
    ("pctdm", "pctdm.att_extra_weights.0.weight", (1000, 1)),
    ("sacrf", "SACRF.halt_fc.weight", (64, 1)),
    ("gcnnet_collective", "gcn_list.0.nl_gcn_list.0.weight", (64, 1)),
    ("gcnnet_collective", "gcn_list.0.nl_gcn_list.0.bias", (2, 64))])
def test_reference_file_with_another_shape_raises(name, key, shape):
    """A reference file whose tensor has the model's elements in another
    shape (a [1, H] weight written as [H, 1]; a GCN LayerNorm other than
    din_tpu's [1, NFG]) raises; din_tpu's [1, NFG] LayerNorm loads."""
    preset, extra = CASES[name]
    model = build_model(PRESETS[preset]().replace(**dict(GEOM, **extra)),
                        device="cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    bad = dict(state, **{key: torch.zeros(shape)})
    with pytest.raises(ValueError, match="shape mismatch at " + key):
        load_reference_checkpoint(model, {"state_dict": bad})
    if "nl_gcn_list" in key:
        ok = dict(state, **{key: state[key][None] + 1})
        assert not load_reference_checkpoint(model, {"state_dict": ok})
        torch.testing.assert_close(model.state_dict()[key], state[key] + 1)
