"""Gradient accumulation (``cfg.grad_accum_steps``) of the port against
the JAX package, on the CPU.

Accumulation against din_tpu's ``_make_accum_train_step`` (through
``make_train_step`` with ``grad_accum_steps=2``), float32, dropout 0:
- no BatchNorm: the flagship with a frozen VGG-16 at
  tests/test_torch_train.py's geometry (64x96 frames, T=3, N=4, NFB 64,
  lite 16), batch 4 in two micro-batches of 2, two steps, with that file's
  frozen-backbone tolerances: losses within rtol 1e-4, counters equal,
  parameters no more than 2 lr per step apart and at most 1e-4 of a
  tensor's elements beyond 2e-5 (``_check_params``);
- live BatchNorm: a stage-1 Basenet on ResNet-18 (its BatchNorm in
  training mode, the backbone frozen so din_tpu's compile stays small),
  one-frame clips, one step, with tests/test_torch_baselines_train.py's
  tolerances: losses within rtol 1e-4, counters equal, the running
  statistics after the step (each micro-batch's statistics folded in turn)
  within 1e-4 of each tensor's largest |value|, parameters within 2 lr
  plus 2 f32 ulps and at most 10 % of a tensor's elements beyond 2e-5
  (train-mode BatchNorm's E[x^2] - E[x]^2 cancels in f32 and its sums
  differ between the frameworks).
The port's accumulated step is also held against its own step on the whole
batch (no BatchNorm, the backbone trained): the same function, summed in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.train.engine import TrainState, init_model, make_train_step
from din_tpu.train.optim import make_optimizer as jax_make_optimizer
from din_tpu_torch.data.loader import BatchLoader, to_device
from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import jax_params_to_state_dict
from din_tpu_torch.train import engine
from din_tpu_torch.train.optim import make_optimizer
from test_torch_train import _GEOM, _check_params, _perturb
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def _state(params, cfg, stats=None):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_params_to_state_dict(params, cfg, stats).items()}


def _jax_trajectory(jcfg, batches, has_bn, stage2=True):
    """din_tpu's accumulated steps from perturbed weights: (params and
    stats before, metrics, params and stats after each step)."""
    jmodel = jax_build_model(jcfg)
    variables = init_model(jcfg, jmodel,
                           {k: v[:1] for k, v in batches[0].items()})
    params = _perturb(jax.device_get(variables["params"]),
                      np.random.RandomState(0))
    stats = jax.device_get(variables.get("batch_stats", {}))
    tx = jax_make_optimizer(jcfg, params)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=jax.jit(tx.init)(params),
                       rng=jax.random.PRNGKey(0))
    step = make_train_step(jmodel, jcfg, tx, stage2, has_bn, donate=False)
    out = []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            out.append((jax.device_get(m), jax.device_get(state)))
    return params, stats, out


def _same_metrics(got, want):
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
    for k in ("activities_correct", "activities_total", "activities_conf"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_accumulated_step_matches_jax_without_batchnorm():
    common = dict(_GEOM, batch_size=4, grad_accum_steps=2,
                  train_backbone=False)
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]().replace(
        folded_stem=False, **common)
    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(**common)
    loader = BatchLoader(SyntheticDataset(cfg, seed=1), 4, seed=0)
    loader.set_epoch(1)
    batches = [b for _, b in zip(range(2), loader)]
    params, _, ref = _jax_trajectory(jcfg, batches, has_bn=False)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_state(params, cfg))
    optimizer = make_optimizer(cfg, model)
    for b, (m, _) in zip(batches, ref):
        _same_metrics(engine.train_step(model, optimizer, to_device(b, CPU),
                                        cfg), m)
    _check_params(model, ref[-1][1].params, cfg, {}, 2, "accumulated")


def test_accumulated_step_matches_jax_with_live_batchnorm():
    common = dict(backbone="res18", image_size=(64, 96), out_size=(2, 3),
                  emb_features=512, num_frames=1, num_boxes=4,
                  num_features_boxes=64, compute_dtype="float32",
                  train_dropout_prob=0.0, batch_size=4, grad_accum_steps=2,
                  train_backbone=False)
    jcfg = JAX_PRESETS["volleyball_stage1"]().replace(folded_stem=False,
                                                      **common)
    cfg = PRESETS["volleyball_stage1"]().replace(**common)
    batch = next(iter(BatchLoader(SyntheticDataset(cfg, seed=3), 4,
                                  seed=0)))
    params, stats, ref = _jax_trajectory(jcfg, [batch], has_bn=True,
                                         stage2=False)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_state(params, cfg, stats))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = engine.train_step(model, make_optimizer(cfg, model),
                            to_device(batch, CPU), cfg)
    m, state = ref[0]
    _same_metrics(got, m)
    want = _state(state.params, cfg, state.batch_stats)
    own = model.state_dict()
    lr = cfg.train_learning_rate
    n_stats = 0
    for k, w in want.items():
        diff = (own[k].double() - w.double()).abs()
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(own[k], before[k]), k
            assert diff.max() <= 1e-4 * w.abs().max(), (k, float(diff.max()))
            n_stats += 1
        elif w.is_floating_point():
            ulp = np.spacing(w.abs().numpy().astype(np.float32))
            assert (diff.numpy() <= 2 * lr + 2 * ulp).all(), (
                k, float(diff.max()))
            assert float((diff > 2e-5).double().mean()) <= 0.1, k
    assert n_stats == 40                  # ResNet-18's 20 BatchNorms
    # two micro-batches fold two batch statistics into each running one
    assert int(own["backbone.features.1.num_batches_tracked"]) == 2


def test_accumulated_step_matches_the_ports_whole_batch_step():
    """Two micro-batches of 2 against one step on the batch of 4, the
    backbone trained: losses within rtol 1e-6 (measured ~1e-8), counters
    equal, parameters within ``_check_params``'s no-flip bounds (both
    steps sum the same gradients, in another order); an indivisible batch
    raises."""
    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(
        **dict(_GEOM, batch_size=4))
    batch = to_device(next(iter(BatchLoader(SyntheticDataset(cfg, seed=1),
                                            4, seed=0))), CPU)
    whole = build_model(cfg, device="cpu")
    micro = build_model(cfg, device="cpu")
    micro.load_state_dict(whole.state_dict())
    a = engine.train_step(whole, make_optimizer(cfg, whole), batch, cfg)
    acfg = cfg.replace(grad_accum_steps=2)
    b = engine.train_step(micro, make_optimizer(acfg, micro), batch, acfg)
    np.testing.assert_allclose(float(b["loss"]), float(a["loss"]), rtol=1e-6)
    for k in ("activities_correct", "activities_total", "activities_conf"):
        assert torch.equal(a[k], b[k]), k
    jstate = {k: v.numpy() for k, v in whole.state_dict().items()}
    ref = micro.state_dict()
    for name, want in jstate.items():
        diff = np.abs(ref[name].numpy() - want)
        assert diff.max() <= 2 * cfg.train_learning_rate, name
        assert float((diff > 2e-5).mean()) <= 1e-4, name
    with pytest.raises(ValueError, match="not divisible"):
        engine.train_step(micro, make_optimizer(acfg, micro),
                          {k: v[:3] for k, v in batch.items()}, acfg)
