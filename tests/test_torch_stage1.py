"""The port's stage 1 and its graft into stage 2 against the JAX package, on
the CPU.

The same seeded parameters and synthetic batches go through din_tpu's
``BasenetVolleyball`` and ``make_train_step(frame0_labels=False)`` and
din_tpu_torch's in float32 (JAX under ``default_matmul_precision
("highest")``, canonical stem): full VGG-16 channels at 64x96 frames (a 2x3
map), N=4, NFB 64, dropout 0.  Stage 1 trains on T=1 and evaluates on
``num_frames`` (3 here).  The stage-1 component file of the port equals the
JAX package's ``save_reference_checkpoint(fmt='stage1')``, and a stage-2
model grafted from it answers as din_tpu's ``load_backbone_stage2`` of the
same variables.  The training bounds are those of tests/test_torch_train.py
(its docstring says why a ReLU or pool flip between the frameworks moves
gradients upstream of it and turns into 2*lr parameter steps).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.nn.ref_export import save_reference_checkpoint
from din_tpu.train import checkpoint as jax_ckpt
from din_tpu.train.engine import TrainState, init_model, make_train_step
from din_tpu.train.optim import make_optimizer as jax_make_optimizer
from din_tpu_torch.data.loader import BatchLoader
from din_tpu_torch.data.synthetic import SyntheticDataset, make_synthetic_batch
from din_tpu_torch.experiments.predict import Predictor
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.heads.din import DynamicPersonInference
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import (_fill_masked, _find_state,
                                         jax_params_to_state_dict)
from din_tpu_torch.train.checkpoint import (load_backbone_stage2,
                                            save_stage1_components)
from din_tpu_torch.train.engine import setup_training
from din_tpu_torch.train.optim import make_optimizer
from test_torch_train import (_backbone_flips, _check_params, _conv_index,
                              _perturb, _run_port, _torch_state)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_GEOM = dict(image_size=(64, 96), out_size=(2, 3), num_frames=3,
             num_boxes=4, num_features_boxes=64, compute_dtype="float32",
             train_dropout_prob=0.0, weight_decay=1e-4, batch_size=2,
             test_batch_size=2)
_STAGE2 = dict(_GEOM, lite_dim=16)
_STEPS = 3


def _jax_cfgs():
    return (JAX_PRESETS["volleyball_stage1"]().replace(folded_stem=False,
                                                       **_GEOM),
            PRESETS["volleyball_stage1"]().replace(**_GEOM))


def _init(jcfg, batch, seed):
    jmodel = jax_build_model(jcfg)
    variables = init_model(jcfg, jmodel, {k: v[:1] for k, v in batch.items()})
    return jmodel, _perturb(jax.device_get(variables["params"]),
                            np.random.RandomState(seed))


@pytest.fixture(scope="module")
def stage1():
    """Perturbed JAX stage-1 params, a 3-frame eval batch, and the port's
    Basenet with those params."""
    jcfg, cfg = _jax_cfgs()
    batch = make_synthetic_batch(cfg, 2, rng=np.random.RandomState(0))
    jmodel, params = _init(jcfg, batch, 0)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_torch_state(params, cfg), strict=True)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, params=params,
                model=model, batch=batch)


def test_basenet_matches_jax_forward(stage1):
    """Eval-mode logits of the port's BasenetVolleyball against din_tpu's
    on a T=3 batch, atol 1e-4 (float32 summation order through 13 convs,
    RoIAlign and the heads); the state_dict keys are the reference Basenet's
    and load strictly."""
    s = stage1
    ref = jax.jit(lambda p, i, b: s["jmodel"].apply(
        {"params": p}, i, b, train=False))(
        s["params"], s["batch"]["images"], s["batch"]["boxes"])
    with torch.no_grad():
        got = s["model"](torch.from_numpy(s["batch"]["images"]),
                         torch.from_numpy(s["batch"]["boxes"]))
    assert {k.split(".")[0] for k in s["model"].state_dict()} == {
        "backbone", "fc_emb", "fc_actions", "fc_activities"}
    assert got["actions"].shape == (2 * 4, s["cfg"].num_actions)
    assert got["activities"].shape == (2, s["cfg"].num_activities)
    for k in ("actions", "activities"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_stage1_draws_one_frame_in_training_and_t_in_eval():
    """SyntheticDataset of stage 1: T=1 for training items and num_frames
    for eval items, equal to the JAX package's bit for bit."""
    jcfg, cfg = _jax_cfgs()
    for training, T in ((True, 1), (False, cfg.num_frames)):
        ours = SyntheticDataset(cfg, size=3, is_training=training, seed=1)
        theirs = JaxSynthetic(jcfg, size=3, is_training=training, seed=1)
        for i in range(3):
            a, b = ours[i], theirs[i]
            assert a["images"].shape[0] == T and a["boxes"].shape[0] == T
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_stage1_training_matches_jax_make_train_step(stage1):
    """Three stage-1 steps (T=1, per-frame labels) from the same weights on
    the same batches as din_tpu's make_train_step(frame0_labels=False).
    Losses within rtol 1e-4; step 1's gradient of every tensor within
    1e-4 * max|g_jax| where no ReLU or pool flip reaches it, else 1e-2; each
    ReLU flip within 1e-5 of 0; parameters after 3 steps within the bounds
    of tests/test_torch_train.py ``_check_params``."""
    s = stage1
    jcfg, cfg, params = s["jcfg"], s["cfg"], s["params"]
    loader = BatchLoader(SyntheticDataset(cfg, seed=1), cfg.batch_size,
                         seed=cfg.train_random_seed)
    loader.set_epoch(1)
    batches = [b for _, b in zip(range(_STEPS), loader)]
    assert batches[0]["images"].shape[1] == 1
    tx = jax_make_optimizer(jcfg, params)
    state = TrainState(params=params, batch_stats={},
                       opt_state=jax.jit(tx.init)(params),
                       rng=jax.random.PRNGKey(0))
    step = make_train_step(s["jmodel"], jcfg, tx, False, False, donate=False)
    want, states = [], []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            want.append(float(m["loss"]))
            states.append(jax.device_get(state))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(_torch_state(params, cfg))
    optimizer = make_optimizer(cfg, model)
    got, grads = _run_port(model, optimizer, cfg, batches,
                           grads_at_first=True)
    np.testing.assert_allclose(got, want, rtol=1e-4)

    flips = _backbone_flips(params, cfg, batches[0]["images"].reshape(
        -1, *cfg.image_size, 3))
    for i, (n, z) in flips.items():
        assert z <= 1e-5, f"layer {i}: {n} ReLU flips at |z| up to {z}"
    deepest = max(flips, default=-1)
    adam = _find_state(states[0].opt_state, ("mu", "nu", "count"))
    mu = jax_params_to_state_dict(_fill_masked(adam.mu, params), cfg)
    w0 = jax_params_to_state_dict(params, cfg)
    assert set(grads) == set(w0)
    for name, g in grads.items():
        g_jax = np.asarray(mu[name]) / 0.1 - cfg.weight_decay * w0[name]
        idx = _conv_index(name)
        bound = 1e-2 if idx is not None and idx <= deepest else 1e-4
        err = np.abs(g.numpy() - g_jax).max()
        assert err <= bound * np.abs(g_jax).max(), (name, err)
    _check_params(model, states[-1].params, cfg, flips, _STEPS, "3 steps")


def test_component_file_matches_jax_reference_export(stage1, tmp_path):
    """save_stage1_components writes the keys and values of din_tpu's
    save_reference_checkpoint(fmt='stage1') for the same variables (exact:
    both are transposes of the same arrays)."""
    s = stage1
    ours, theirs = tmp_path / "port.pth", tmp_path / "jax.pth"
    save_stage1_components(str(ours), s["model"])
    save_reference_checkpoint({"params": s["params"]}, s["jcfg"],
                              str(theirs), fmt="stage1")
    a = torch.load(ours, weights_only=True)
    b = torch.load(theirs, weights_only=False)
    assert sorted(a) == sorted(b) == ["backbone_state_dict",
                                      "fc_actions_state_dict",
                                      "fc_activities_state_dict",
                                      "fc_emb_state_dict"]
    for comp in b:
        assert sorted(a[comp]) == sorted(b[comp]), comp
        for k, v in b[comp].items():
            assert torch.equal(a[comp][k], v), (comp, k)


def test_graft_matches_jax_load_backbone_stage2(stage1, tmp_path):
    """A stage-2 port model grafted from the port's stage-1 file gives
    din_tpu's posteriors after din_tpu's load_backbone_stage2 of the same
    stage-1 variables (atol 1e-4); the graft replaces exactly backbone.*
    and fc_emb_1, and nl_emb_1 keeps its init."""
    s = stage1
    jcfg2 = JAX_PRESETS["volleyball_stage2_dynamic"]().replace(
        folded_stem=False, **_STAGE2)
    cfg2 = PRESETS["volleyball_stage2_dynamic"]().replace(**_STAGE2)
    batch = make_synthetic_batch(cfg2, 2, rng=np.random.RandomState(4))
    jmodel2, params2 = _init(jcfg2, batch, 1)

    jpath = str(tmp_path / "stage1.ckpt")
    jax_ckpt.save_stage1_components(jpath, {"params": s["params"]})
    jvars = jax_ckpt.load_backbone_stage2({"params": params2}, jpath)
    logits = jax.jit(lambda v, i, b: jmodel2.apply(
        v, i, b, train=False)["activities"])(
        jvars, batch["images"], batch["boxes"])
    want = np.asarray(jax.nn.softmax(logits, axis=-1))

    path = str(tmp_path / "stage1.pth")
    save_stage1_components(path, s["model"])
    model = build_model(cfg2, device="cpu")
    model.load_state_dict(_torch_state(params2, cfg2), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_backbone_stage2(model, path)
    stage1_state = s["model"].state_dict()
    for k, v in model.state_dict().items():
        src = ("fc_emb." + k[len("fc_emb_1."):] if k.startswith("fc_emb_1.")
               else k if k.startswith("backbone.") else None)
        assert torch.equal(v, stage1_state[src] if src else before[k]), k
    got = Predictor(cfg2, model, device="cpu")(batch["images"],
                                               batch["boxes"])["activities"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_setup_training_grafts_or_raises(stage1, tmp_path):
    """setup_training of stage 2 grafts the stage-1 file before any step; a
    missing file raises, as in din_tpu; --stage2-model-path turns the graft
    off, as din_tpu's run.py does."""
    from din_tpu_torch.experiments import run

    cfg2 = PRESETS["volleyball_stage2_dynamic"]().replace(**_STAGE2)
    assert cfg2.load_backbone_stage2 and cfg2.stage1_model_path
    with pytest.raises(FileNotFoundError):
        setup_training(cfg2.replace(
            stage1_model_path=str(tmp_path / "missing.pth")), "cpu")
    s = stage1["model"]
    path = str(tmp_path / "stage1.pth")
    save_stage1_components(path, s)
    model, _, start = setup_training(cfg2.replace(stage1_model_path=path),
                                     "cpu")
    assert start == 1
    for k, v in s.backbone.state_dict().items():
        assert torch.equal(model.backbone.state_dict()[k], v), k
    for k, v in s.fc_emb.state_dict().items():
        assert torch.equal(model.fc_emb_1.state_dict()[k], v), k
    cfg, _ = run.config_from_args(["--preset", "volleyball_stage2_dynamic",
                                   "--stage2-model-path", "x.pth"])
    assert not cfg.load_backbone_stage2 and cfg.load_stage2model
    cfg, _ = run.config_from_args(["--preset", "volleyball_stage2_dynamic",
                                   "--stage1-model-path", path])
    assert cfg.load_backbone_stage2 and cfg.stage1_model_path == path


def test_run_cli_trains_stage1_then_grafts_stage2_on_cpu(tmp_path,
                                                         monkeypatch):
    """``run.py --device cpu --preset volleyball_stage1`` (small geometry):
    one step, an eval pass, a log.txt and a component file
    ``stage1_epoch1_*.pth``; then ``--stage1-model-path`` starts a stage-2
    run from it, whose log says so."""
    from din_tpu_torch.experiments import presets, run

    stage1_preset = PRESETS["volleyball_stage1"]
    monkeypatch.setitem(presets.PRESETS, "volleyball_stage1", lambda: (
        stage1_preset().replace(**dict(_GEOM, train_dropout_prob=0.3))))
    monkeypatch.setitem(presets.PRESETS, "tiny2", lambda: PRESETS[
        "volleyball_stage2_dynamic"]().replace(**_STAGE2))
    common = ["--data-path", "synthetic", "--max-epoch", "1",
              "--max-steps-per-epoch", "1", "--device", "cpu",
              "--result-root", str(tmp_path)]
    best = run.main(["--preset", "volleyball_stage1", "--exp-name", "s1"]
                    + common)
    log = (tmp_path / "s1" / "log.txt").read_text()
    assert "Train at epoch #1" in log and "====> Test at epoch #1" in log
    files = sorted(p.name for p in (tmp_path / "s1").glob("*.pth"))
    assert files == [os.path.basename(best["checkpoint"])]
    assert files[0].startswith("stage1_epoch1_")
    comp = torch.load(best["checkpoint"], weights_only=True)
    assert sorted(comp) == ["backbone_state_dict", "fc_actions_state_dict",
                            "fc_activities_state_dict", "fc_emb_state_dict"]
    best2 = run.main(["--preset", "tiny2", "--exp-name", "s2",
                      "--stage1-model-path", best["checkpoint"]] + common)
    log2 = (tmp_path / "s2" / "log.txt").read_text()
    assert "Loaded stage1 backbone: " + best["checkpoint"] in log2
    assert os.path.basename(best2["checkpoint"]).startswith("stage2_epoch1_")


def test_din_grid_convs_run_with_tf32_off(monkeypatch):
    """The DIN head's p_conv and scale_conv run with cuDNN's TF32 switched
    off, whatever the caller set, and the caller's setting comes back after
    the call."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def recording(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording)
    head = DynamicPersonInference(8, torch.Generator().manual_seed(0),
                                  scale_factor=True, dynamic_sampling=True)
    x = torch.randn(1, 3, 4, 8)
    for caller in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller)
        seen.clear()
        head(x)
        assert seen == [False, False]       # scale_conv, then p_conv
        assert torch.backends.cudnn.allow_tf32 is caller
