"""Checkpoint interop of the port against the JAX package, on the CPU.

Files the reference framework writes (the JAX package's
``save_reference_checkpoint``, full-model and stage-1 component formats, and
a torch Adam ``optimizer`` dict in the reference's parameter-index order),
the port's own ``.pth``, and a torchvision-layout VGG-16 file, all written
inside the tests, go through din_tpu's ``load_reference_checkpoint`` /
``load_reference_optimizer`` / ``convert_backbone_state`` and through the
port's ``setup_training`` (``ref_checkpoint_path``, ``ref_resume_optimizer``,
``pretrained_backbone_path``).  Geometry and float32 tolerances are those of
tests/test_torch_train.py (full VGG-16 channels at 64x96, T=3, N=4, NFB 64,
lite 16); its docstring says why a ReLU or pool flip between the frameworks
bounds parameters after a step by 2*lr rather than elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.nn.backbones import VGG16Backbone as JaxVGG
from din_tpu.nn.ref_export import save_reference_checkpoint
from din_tpu.nn.ref_import import \
    load_reference_checkpoint as jax_load_reference_checkpoint
from din_tpu.nn.ref_import import \
    load_reference_optimizer as jax_load_reference_optimizer
from din_tpu.nn.torch_port import convert_backbone_state, torch_file_to_numpy
from din_tpu.train.engine import TrainState, init_model, make_train_step
from din_tpu.train.optim import make_optimizer as jax_make_optimizer
from din_tpu_torch.data.loader import to_device
from din_tpu_torch.data.synthetic import make_synthetic_batch
from din_tpu_torch.experiments.predict import Predictor
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import _fill_masked, _find_state
from din_tpu_torch.nn.ref_import import (load_pretrained_backbone,
                                         load_reference_checkpoint)
from din_tpu_torch.train.checkpoint import save_state
from din_tpu_torch.train.engine import setup_training, train_step
from din_tpu_torch.train.optim import make_optimizer
from test_torch_train import (_backbone_flips, _check_params, _perturb,
                              _torch_state)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_GEOM = dict(image_size=(64, 96), out_size=(2, 3), num_frames=3,
             num_boxes=4, num_features_boxes=64, compute_dtype="float32",
             train_dropout_prob=0.0, weight_decay=1e-4, batch_size=2,
             test_batch_size=2)
_STAGE2 = dict(_GEOM, lite_dim=16, load_backbone_stage2=False)
_CPU = torch.device("cpu")


def _cfgs(train_backbone=True):
    return (JAX_PRESETS["volleyball_stage2_dynamic"]().replace(
                folded_stem=False, train_backbone=train_backbone, **_STAGE2),
            PRESETS["volleyball_stage2_dynamic"]().replace(
                train_backbone=train_backbone, **_STAGE2))


@pytest.fixture(scope="module")
def case():
    """Perturbed din_tpu flagship params at the small geometry and a
    2-clip batch."""
    jcfg, cfg = _cfgs()
    batch = make_synthetic_batch(cfg, 2, rng=np.random.RandomState(0))
    jmodel = jax_build_model(jcfg)
    variables = init_model(jcfg, jmodel, {k: v[:1] for k, v in batch.items()})
    params = _perturb(jax.device_get(variables["params"]),
                      np.random.RandomState(0))
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, params=params,
                batch=batch)


def _jax_posteriors(jmodel, variables, batch):
    logits = jax.jit(lambda v, i, b: jmodel.apply(
        v, i, b, train=False)["activities"])(
        variables, batch["images"], batch["boxes"])
    return np.asarray(jax.nn.softmax(logits, axis=-1))


@pytest.mark.parametrize("fmt", ["full", "stage1"])
def test_reference_file_gives_jax_posteriors(case, tmp_path, fmt):
    """``save_reference_checkpoint(fmt)`` of perturbed flagship variables,
    loaded by the port through ``cfg.ref_checkpoint_path`` into its seeded
    init and by din_tpu's ``load_reference_checkpoint`` into the same init:
    posteriors within 1e-4 (float32 summation order).  The full format sets
    every tensor; the stage-1 format sets backbone.*, fc_emb_1 and
    fc_activities, and the rest keeps its init."""
    c = case
    path = str(tmp_path / "ref.pth")
    save_reference_checkpoint({"params": c["params"]}, c["jcfg"], path,
                              fmt=fmt, epoch=3)
    # the port's seeded init, carried into din_tpu's variables
    init, _, _ = setup_training(c["cfg"], "cpu")
    init_path = str(tmp_path / "init.pth")
    torch.save({"epoch": 0, "state_dict": init.state_dict(),
                "optimizer": {}}, init_path)
    jinit, skipped = jax_load_reference_checkpoint(
        {"params": c["params"]}, init_path, c["jcfg"], verbose=False)
    assert skipped == []
    jvars, _ = jax_load_reference_checkpoint(jinit, path, c["jcfg"],
                                             verbose=False)
    want = _jax_posteriors(c["jmodel"], jvars, c["batch"])

    model, _, start = setup_training(
        c["cfg"].replace(ref_checkpoint_path=path), "cpu")
    assert start == 1
    ref = _torch_state(c["params"], c["cfg"])
    grafted = ("backbone.", "fc_emb_1.", "fc_activities.")
    for k, v in model.state_dict().items():
        src = ref if fmt == "full" or k.startswith(grafted) else \
            init.state_dict()
        assert torch.equal(v, src[k]), k
    got = Predictor(c["cfg"], model, device="cpu")(
        c["batch"]["images"], c["batch"]["boxes"])["activities"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_unknown_key_is_reported_and_a_wrong_shape_raises(case, tmp_path):
    """Like the reference's ``loadpart`` and din_tpu: a key the model does
    not have is skipped and reported (in the log line too); a key it has
    with another shape raises."""
    c = case
    state = dict(_torch_state(c["params"], c["cfg"]))
    state["extra.weight"] = torch.zeros(3)
    model = build_model(c["cfg"], device="cpu")
    assert load_reference_checkpoint(
        model, {"epoch": 1, "state_dict": state}) == ["extra.weight"]
    _, jskipped = jax_load_reference_checkpoint(
        {"params": c["params"]}, {"state_dict": state}, c["jcfg"],
        verbose=False)
    assert jskipped == ["extra.weight"]
    path = str(tmp_path / "extra.pth")
    torch.save({"epoch": 1, "state_dict": state, "optimizer": {}}, path)
    log = tmp_path / "log.txt"
    setup_training(c["cfg"].replace(ref_checkpoint_path=path,
                                    log_path=str(log)), "cpu")
    assert ("Loaded reference checkpoint %s (1 keys skipped)" % path
            in log.read_text())

    bad = dict(state, **{"fc_activities.weight":
                         state["fc_activities.weight"].t().contiguous()})
    with pytest.raises(ValueError, match="shape mismatch at fc_activities"):
        load_reference_checkpoint(model, {"state_dict": bad})
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_load_reference_checkpoint({"params": c["params"]},
                                      {"state_dict": bad}, c["jcfg"],
                                      verbose=False)


def test_stage1_files_load_into_the_basenet(tmp_path):
    """A stage-1 component file, and a full-model file with the JAX
    package's ``fc_emb_1`` name, load into the port's stage-1 Basenet, whose
    embedding is ``fc_emb``: every tensor equal, nothing skipped."""
    from din_tpu_torch.train.checkpoint import save_stage1_components

    cfg = PRESETS["volleyball_stage1"]().replace(**_GEOM)
    src = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "stage1.pth")
    save_stage1_components(path, src)
    full = {"state_dict": {k.replace("fc_emb.", "fc_emb_1."): v
                           for k, v in src.state_dict().items()}}
    for state in (path, full):
        model = build_model(cfg, device="cpu")
        assert load_reference_checkpoint(model, state) == []
        for k, v in src.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k


def _reference_payload(params, jcfg, path, train_backbone, step, seed=5):
    """A reference full checkpoint (epoch 4) of ``params`` with a torch Adam
    ``optimizer`` dict of random moments, keyed by parameter index in the
    reference's order: the file's state_dict keys, minus backbone.* when
    the backbone is frozen.  Returns those names."""
    save_reference_checkpoint({"params": params}, jcfg, path, fmt="full",
                              epoch=4)
    payload = torch.load(path, weights_only=False)
    names = [k for k in payload["state_dict"]
             if train_backbone or not k.startswith("backbone.")]
    rng = np.random.RandomState(seed)
    state = {}
    for i, k in enumerate(names):
        shape = tuple(payload["state_dict"][k].shape)
        state[i] = {
            "step": step,
            "exp_avg": torch.from_numpy(
                (1e-3 * rng.randn(*shape)).astype(np.float32)),
            "exp_avg_sq": torch.from_numpy(
                ((1e-3 * rng.randn(*shape)) ** 2 + 1e-8).astype(np.float32)),
        }
    payload["optimizer"] = {"state": state, "param_groups": [{
        "lr": 3e-5, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4,
        "amsgrad": False, "params": list(range(len(names)))}]}
    torch.save(payload, path)
    return names


@pytest.mark.parametrize("train_backbone", [True, False],
                         ids=["backbone_trained", "backbone_frozen"])
def test_adam_adoption_matches_jax_next_step(case, tmp_path, train_backbone):
    """A reference file with Adam state (``step`` as a tensor, as torch >=
    1.12 saves it, with the backbone trained; as an int, as the reference's
    torch 1.2 does, with it frozen) adopted by din_tpu's
    ``load_reference_optimizer`` and by the port's ``setup_training``
    (``ref_resume_optimizer``), one step each on the same batch: losses
    within rtol 1e-4, parameters within tests/test_torch_train.py's bounds
    (``_check_params``, with its ReLU/pool flips where the backbone
    trains).  The file's order (DPI before point_conv) is not the port's, so
    only a mapping by name passes.  A file whose optimizer covers another
    set of tensors than the config trains raises din_tpu's error."""
    c = case
    jcfg, cfg = _cfgs(train_backbone)
    path = str(tmp_path / "ref.pth")
    step = torch.tensor(7.0) if train_backbone else 7
    names = _reference_payload(c["params"], jcfg, path, train_backbone, step)
    trainable = [n for n, p in build_model(cfg, device="cpu")
                 .named_parameters() if p.requires_grad]
    assert sorted(names) == sorted(trainable) and names != trainable

    jmodel = jax_build_model(jcfg)
    jvars, _ = jax_load_reference_checkpoint({"params": c["params"]}, path,
                                             jcfg, verbose=False)
    tx = jax_make_optimizer(jcfg, jvars["params"])
    opt, epoch = jax_load_reference_optimizer(
        jax.jit(tx.init)(jvars["params"]), path, jcfg)
    assert epoch == 4
    jstep = make_train_step(jmodel, jcfg, tx, True, False, donate=False)
    with jax.default_matmul_precision("highest"):
        jstate, m = jstep(
            TrainState(params=jvars["params"], batch_stats={},
                       opt_state=opt, rng=jax.random.PRNGKey(0)),
            {k: jnp.asarray(v) for k, v in c["batch"].items()})

    model, optimizer, start = setup_training(
        cfg.replace(ref_checkpoint_path=path, ref_resume_optimizer=True),
        "cpu")
    assert start == 5
    assert all(g["lr"] == 3e-5 for g in optimizer.param_groups)
    p0 = next(p for p in model.parameters() if p.requires_grad)
    assert float(optimizer.state[p0]["step"]) == 7.0
    loss = float(train_step(model, optimizer, to_device(c["batch"], _CPU),
                            cfg)["loss"])
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-4)
    flips = _backbone_flips(jvars["params"], cfg, c["batch"]["images"]
                            .reshape(-1, *cfg.image_size, 3)) \
        if train_backbone else {}
    _check_params(model, jax.device_get(jstate.params), cfg, flips, 1,
                  "adopted Adam step")

    if not train_backbone:       # the file says frozen, the config trains
        tjcfg, tcfg = _cfgs(True)
        ttx = jax_make_optimizer(tjcfg, jvars["params"])
        with pytest.raises(ValueError) as theirs:
            jax_load_reference_optimizer(jax.jit(ttx.init)(jvars["params"]),
                                         path, tjcfg)
        with pytest.raises(ValueError) as ours:
            setup_training(tcfg.replace(ref_checkpoint_path=path,
                                        ref_resume_optimizer=True), "cpu")
        assert str(ours.value) == str(theirs.value)
        assert "was train_backbone (True) different" in str(ours.value)


def test_port_checkpoint_is_in_the_reference_layout(case, tmp_path):
    """The port's own stage-2 ``.pth`` after two steps, read by din_tpu's
    ``load_reference_checkpoint`` and ``load_reference_optimizer``, gives
    the port's weights, Adam moments and step count exactly (the
    conversions are transposes): the file really is in the reference's
    layout and parameter-index order."""
    c = case
    cfg = c["cfg"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_torch_state(c["params"], cfg), strict=True)
    optimizer = make_optimizer(cfg, model)
    for _ in range(2):
        train_step(model, optimizer, to_device(c["batch"], _CPU), cfg)
    path = str(tmp_path / "port.pth")
    save_state(path, 2, model, optimizer)

    jvars, skipped = jax_load_reference_checkpoint(
        {"params": c["params"]}, path, c["jcfg"], verbose=False)
    assert skipped == []
    tx = jax_make_optimizer(c["jcfg"], jvars["params"])
    opt, epoch = jax_load_reference_optimizer(
        jax.jit(tx.init)(jvars["params"]), path, c["jcfg"])
    assert epoch == 2
    adam = _find_state(opt, ("mu", "nu", "count"))
    assert int(adam.count) == 2
    weights = _torch_state(jax.device_get(jvars["params"]), cfg)
    mu = _torch_state(_fill_masked(jax.device_get(adam.mu), jvars["params"]),
                      cfg)
    nu = _torch_state(_fill_masked(jax.device_get(adam.nu), jvars["params"]),
                      cfg)
    for name, p in model.named_parameters():
        assert torch.equal(weights[name], p.detach()), name
        assert torch.equal(mu[name], optimizer.state[p]["exp_avg"]), name
        assert torch.equal(nu[name], optimizer.state[p]["exp_avg_sq"]), name


def _vgg16_file(path, under_state_dict, seed=3):
    """A torchvision-layout VGG-16 ``state_dict`` file with random
    ``features.*`` at their init scale and one small ``classifier.*``
    tensor pair (torchvision's classifier.0 alone is 400 MB)."""
    from din_tpu_torch.nn.backbones import VGG16Backbone

    rng = np.random.RandomState(seed)
    state = {}
    shapes = VGG16Backbone(torch.Generator().manual_seed(0)).state_dict()
    for k, v in shapes.items():
        fan_in = int(np.prod(v.shape[1:])) if v.dim() > 1 else 1
        scale = (2.0 / fan_in) ** 0.5 if v.dim() > 1 else 0.05
        state[k] = torch.from_numpy(
            (scale * rng.randn(*v.shape)).astype(np.float32))
    state["classifier.6.weight"] = torch.zeros(8, 16)
    state["classifier.6.bias"] = torch.zeros(8)
    torch.save({"state_dict": state} if under_state_dict else state, path)
    return state


@pytest.mark.parametrize("layout", ["bare", "under_state_dict"])
def test_pretrained_vgg16_file_gives_jax_backbone_output(tmp_path, layout):
    """A torchvision-layout VGG-16 file through ``pretrained_backbone_path``
    (stage 1): backbone.features equal the file's tensors, and the
    backbone's output on frames in [-1, 1] equals din_tpu's VGG-16 after
    ``convert_backbone_state`` of the same file (canonical stem) within
    rtol 1e-4 / atol 1e-5 (float32 summation order).  The file loaded into
    a model of another backbone (Inception-v3) raises, and a backbone name
    din_tpu does not know raises when the model is built."""
    path = str(tmp_path / "vgg16.pth")
    state = _vgg16_file(path, layout == "under_state_dict")
    cfg = PRESETS["volleyball_stage1"]().replace(
        pretrained_backbone_path=path, **_GEOM)
    model, _, _ = setup_training(cfg, "cpu")
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, state[k]), k

    x = np.random.RandomState(4).uniform(-1, 1, (2, 64, 96, 3)).astype(
        np.float32)
    conv = convert_backbone_state(torch_file_to_numpy(path), "vgg16")
    params = {k: v for k, v in conv["params"].items()
              if k.startswith("features")}
    ref = np.asarray(JaxVGG(dtype=jnp.float32, folded_stem=False).apply(
        {"params": params}, x)[0])
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 2, 3, 512)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pretrained_backbone(build_model(cfg.replace(backbone="inv3"),
                                             device="cpu"), path)
    with pytest.raises(ValueError, match="choose from"):
        build_model(cfg.replace(backbone="vgg11"), device="cpu")


def test_run_cli_with_the_three_new_flags(case, tmp_path, monkeypatch):
    """``run.py --device cpu`` end to end: stage 1 with
    ``--pretrained-backbone-path``, then stage 2 with
    ``--ref-checkpoint-path`` and ``--ref-resume-optimizer``, which resumes
    at the reference file's epoch + 1; the logs say so."""
    from din_tpu_torch.experiments import presets, run

    monkeypatch.setitem(presets.PRESETS, "tiny1", lambda: PRESETS[
        "volleyball_stage1"]().replace(**_GEOM))
    monkeypatch.setitem(presets.PRESETS, "tiny2", lambda: PRESETS[
        "volleyball_stage2_dynamic"]().replace(**_STAGE2))
    common = ["--data-path", "synthetic", "--max-epoch", "1",
              "--max-steps-per-epoch", "1", "--device", "cpu",
              "--result-root", str(tmp_path)]
    vgg = str(tmp_path / "vgg16.pth")
    _vgg16_file(vgg, False)
    run.main(["--preset", "tiny1", "--exp-name", "s1",
              "--pretrained-backbone-path", vgg] + common)
    log = (tmp_path / "s1" / "log.txt").read_text()
    assert "Loaded pretrained backbone: " + vgg in log
    assert "Train at epoch #1" in log

    ref = str(tmp_path / "ref.pth")
    _reference_payload(case["params"], case["jcfg"], ref, True, 7)
    best = run.main(["--preset", "tiny2", "--exp-name", "s2",
                     "--ref-checkpoint-path", ref, "--ref-resume-optimizer"]
                    + common)
    log = (tmp_path / "s2" / "log.txt").read_text()
    for line in ("Loaded reference checkpoint %s (0 keys skipped)" % ref,
                 "Not loading stage1 or stage2 model.",
                 "Adopted reference optimizer state (resuming at epoch 5)",
                 "Train at epoch #5"):
        assert line in log, line
    assert log.index("Loaded reference") < log.index("Adopted reference")
    assert best["checkpoint"].endswith(".pth")
    assert "stage2_epoch5_" in best["checkpoint"]
