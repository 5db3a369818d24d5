"""The port's Collective Activity models against the JAX package, on the CPU.

din_tpu's ``DynamicCollective`` (the preset ``collective_stage2_dynamic``)
and ``BasenetCollective`` (its ResNet-18 stage 1) against din_tpu_torch's,
at full widths (NFB 1024, ResNet-18's 512 channels, 13 actors) and a small
geometry (64x96 frames, a 2x3 map, T=3), in float32 with the canonical stem
(JAX under ``default_matmul_precision("highest")``), from the same
perturbed weights: DIN convs, biases, LayerNorm and BatchNorm affines and
BatchNorm statistics away from their init.  A batch of three clips has 13,
1 and a mix of actor counts (7, 5, 9 over its frames: ``DynamicCollective``
takes frame 0's count for the clip, ``BasenetCollective`` each frame's);
padded actors have zero boxes and action -1.

Tolerances: posteriors within rtol 1e-4 / atol 1e-5; one training step's
losses within rtol 1e-4, BatchNorm running statistics within 1e-5 and the
parameters within the bounds of tests/test_torch_train.py
``_check_params`` after ReLU or pool flips (at most 10 % of a tensor's
elements beyond 2e-5, none more than 2*lr apart, plus here the f32
spacing of the parameter, since Adam's first step of a flipped-sign
gradient is lr one way and lr the other, rounded: measured 1.0000169e-4
against 2*lr = 1e-4).  Flips between the frameworks' f32 convs are
certain here: tests/test_torch_resnet.py measures them for ResNet-18 in
train mode.  Padded actors' boxes and pixels do not change the answer at
all.

DynamicCollective's training step in din_tpu is run eagerly
(tests/test_torch_collective_train.py), not jitted as ``make_train_step``
runs it: at this geometry XLA's jitted gradient of din_tpu's
DynamicCollective on XLA's CPU backend is wrong upstream of ``dpi_nl``. One
element of ``DPI.hidden_weight``: central differences of the (jitted,
correct) loss give 0.19598, JAX's eager gradient 0.19598, the jitted one
0.09916; over whole tensors the jitted gradient differs from the eager one
by up to 53 % of the largest element (the offset conv's bias), 35 % in
``fc_emb_1``, and compiled without optimisations it is NaN. The port's
gradients equal the eager ones within 1.6e-5 of each tensor's largest. The
Basenet's jitted gradient agrees with the port's (1.7e-5 of the largest in
its head), so its step stays jitted. tests/test_torch_collective_stage1.py
holds the Basenet with these helpers.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from din_tpu.experiments.predict import Predictor as JaxPredictor
from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.models.trunk import Trunk, trunk_from_cfg
from din_tpu.nn.ref_export import export_model_state, save_reference_checkpoint
from din_tpu.train import losses as jax_losses
from din_tpu.train.engine import init_model
from din_tpu.train.optim import make_optimizer as jax_make_optimizer
from din_tpu_torch.data.loader import to_device
from din_tpu_torch.experiments.predict import Predictor
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import jax_params_to_state_dict
from din_tpu_torch.nn.ref_import import load_reference_checkpoint
from din_tpu_torch.train.engine import train_step
from din_tpu_torch.train.optim import make_optimizer
from test_torch_resnet import perturb_bn
from test_torch_train import _perturb
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_GEOM = dict(image_size=(64, 96), out_size=(2, 3), num_frames=3,
             compute_dtype="float32", train_dropout_prob=0.0, batch_size=3,
             test_batch_size=3)
_COUNTS = np.array([[13, 13, 13], [1, 1, 1], [7, 5, 9]], np.int32)
_CPU = torch.device("cpu")


def _batch(cfg, seed=0):
    """3 clips of T=3 frames, 13 box slots: real boxes inside the map for
    the first ``_COUNTS`` slots of each frame, zero boxes and action -1
    after them."""
    rng = np.random.RandomState(seed)
    B, T, N = 3, cfg.num_frames, cfg.num_boxes
    OH, OW = cfg.out_size
    x1 = rng.uniform(0, OW - 1, (B, T, N))
    y1 = rng.uniform(0, OH - 1, (B, T, N))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.5, 1.5, (B, T, N)),
                      y1 + rng.uniform(0.5, 1.5, (B, T, N))], -1)
    valid = np.arange(N)[None, None] < _COUNTS[:, :, None]
    return {"images": rng.randint(0, 255, (B, T, *cfg.image_size, 3))
            .astype(np.uint8),
            "boxes": np.where(valid[..., None], boxes, 0).astype(np.float32),
            "actions": np.where(valid, rng.randint(0, cfg.num_actions,
                                                   (B, T, N)), -1)
            .astype(np.int32),
            "activities": np.repeat(rng.randint(0, cfg.num_activities,
                                                (B, 1)), T, 1)
            .astype(np.int32),
            "bboxes_num": _COUNTS.copy()}


def _setup(preset, seed, **extra):
    jcfg = JAX_PRESETS[preset]().replace(folded_stem=False, **_GEOM, **extra)
    cfg = PRESETS[preset]().replace(**_GEOM, **extra)
    batch = _batch(cfg, seed)
    jmodel = jax_build_model(jcfg)
    variables = jax.device_get(init_model(
        jcfg, jmodel, {k: v[:1] for k, v in batch.items()}))
    rng = np.random.RandomState(seed)
    params = _perturb(variables["params"], rng)
    bb, st = perturb_bn(params["trunk"]["frames_scan"]["backbone"],
                        variables["batch_stats"]["trunk"]["frames_scan"]
                        ["backbone"], rng)
    params["trunk"]["frames_scan"]["backbone"] = bb
    stats = {"trunk": {"frames_scan": {"backbone": st}}}
    model = build_model(cfg, device="cpu")
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in
         jax_params_to_state_dict(params, cfg, stats).items()}, strict=True)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, params=params,
                stats=stats, model=model, batch=batch)


@pytest.fixture(scope="module")
def dynamic():
    return _setup("collective_stage2_dynamic", 0)


def check_params(model, jparams, cfg, steps, what):
    """``_check_params`` of tests/test_torch_train.py after flips, with the
    f32 spacing of each parameter added to the 2*lr-per-step bound."""
    ref = jax_params_to_state_dict(jparams, cfg)
    state = model.state_dict()
    for name, want in ref.items():
        diff = np.abs(state[name].numpy() - want)
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (diff <= steps * 2 * cfg.train_learning_rate + 2 * ulp).all(), (
            what, name, diff.max())
        share = float((diff > 2e-5).mean())
        assert share <= 0.1, (what, name, share)


def _posteriors(case, pad_to=None):
    """(JAX, port) Predictor posteriors of the case's batch."""
    b = case["batch"]
    variables = {"params": case["params"], "batch_stats": case["stats"]}
    with jax.default_matmul_precision("highest"):
        ref = JaxPredictor(case["jcfg"], variables, pad_to=pad_to)(
            b["images"], b["boxes"], b["bboxes_num"])
    got = Predictor(case["cfg"], case["model"], pad_to=pad_to,
                    device="cpu")(b["images"], b["boxes"], b["bboxes_num"])
    return ref, got


def check_predictor(case, which):
    """Predictor posteriors (``pad_to=2``: a 2-clip call and a padded one)
    equal din_tpu's Predictor's within rtol 1e-4 / atol 1e-5, activities
    and, for the Basenet, per-frame actions; rows sum to 1."""
    ref, got = _posteriors(case, pad_to=2)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == np.asarray(ref[k]).shape
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k].sum(-1), 1, atol=1e-5)
    assert got["activities"].shape == ((3, 4) if which == "dynamic"
                                       else (9, 4))


def check_padded_actors(case, which):
    """Random boxes in every padded slot, and the pixels under them
    changed, give the same posteriors bit for bit: a padded actor's
    features are zeroed before the DIN head and left out of every max over
    actors (the Basenet's actions of real actors too).  A real actor's box
    does change them."""
    cfg, b = case["cfg"], case["batch"]
    predictor = Predictor(cfg, case["model"], device="cpu")

    def run(boxes, images=b["images"]):
        return predictor(images, boxes, b["bboxes_num"])

    base = run(b["boxes"])
    rng = np.random.RandomState(9)
    OH, OW = cfg.out_size
    n = b["bboxes_num"][:, 0] if which == "dynamic" else b["bboxes_num"]
    pad = np.arange(13)[None, None] >= (n[:, None, None] if n.ndim == 1
                                        else n[:, :, None])
    pad = np.broadcast_to(pad, b["boxes"].shape[:3])
    noise = np.stack([rng.uniform(0, OW - 1, pad.shape),
                      rng.uniform(0, OH - 1, pad.shape)], -1)
    boxes = b["boxes"].copy()
    boxes[pad] = np.concatenate([noise, noise + 1], -1)[pad]
    images = b["images"].copy()
    images[:, :, :32] = 255 - images[:, :, :32]     # a real actor moves too
    moved = run(boxes)
    assert np.array_equal(moved["activities"], base["activities"])
    if "actions" in base:
        real = ~pad.reshape(-1)
        assert np.array_equal(moved["actions"][real],
                              base["actions"][real])
    real_box = boxes.copy()
    real_box[0, 0, 0] = [0.2, 0.1, 1.9, 1.6]
    assert not np.array_equal(run(real_box)["activities"],
                              base["activities"])
    assert not np.array_equal(run(b["boxes"], images)["activities"],
                              base["activities"])


def jax_step(case, stage2, jit):
    """One training step of din_tpu's model as ``make_train_step``
    (din_tpu/train/engine.py:86-118) computes it: the loss and its gradient
    with ``mutable=["batch_stats"]`` and ``train=True``, the Adam update of
    ``make_optimizer``; the gradient jitted as there, or eagerly (the
    module docstring says why DynamicCollective needs that).  Eagerly with
    a frozen backbone, din_tpu's ``Trunk`` (no gradient: ``stop_gradient``)
    runs jitted first and its RoI features and BatchNorm statistics take
    its place in the eager pass (``nn.intercept_methods``), which then
    compiles only the head's primitives.  Returns (metrics, new params, new
    batch_stats)."""
    jcfg, b = case["jcfg"], case["batch"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    trunk_out = None
    if not jit and not jcfg.train_backbone:
        trunk = trunk_from_cfg(jcfg)
        with jax.default_matmul_precision("highest"):
            (roi, _, _), tvars = jax.jit(lambda v: trunk.apply(
                v, jb["images"], jb["boxes"], bn_train=True,
                mutable=["batch_stats"]))(
                {"params": case["params"]["trunk"],
                 "batch_stats": case["stats"]["trunk"]})
        trunk_out = (jax.lax.stop_gradient(roi), tvars["batch_stats"])

    def use_trunk_out(next_fun, args, kwargs, context):
        if trunk_out is not None and isinstance(context.module, Trunk):
            return trunk_out[0], None, None
        return next_fun(*args, **kwargs)

    def loss_fn(params):
        with flax.linen.intercept_methods(use_trunk_out):
            out, new_vars = case["jmodel"].apply(
                {"params": params, "batch_stats": case["stats"]},
                jb["images"], jb["boxes"], bboxes_num=jb["bboxes_num"],
                train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
        metrics = jax_losses.compute_losses(out, jb, jcfg, stage2)
        return metrics["loss"], (metrics, new_vars["batch_stats"])

    tx = jax_make_optimizer(jcfg, case["params"])
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    with jax.default_matmul_precision("highest"):
        (_, (metrics, stats)), grads = (jax.jit(grad_fn) if jit else
                                        grad_fn)(case["params"])
    if trunk_out is not None:
        stats = {"trunk": trunk_out[1]}
    updates, _ = tx.update(grads, tx.init(case["params"]), case["params"])
    params = optax.apply_updates(case["params"], updates)
    return metrics, jax.device_get(params), jax.device_get(stats)


def check_train_step(case, which, jit):
    """One step of din_tpu's training step (``jax_step``) and of the port's
    ``train_step`` from the same weights on the same batch, dropout 0: the
    loss (and the Basenet's action loss) within rtol 1e-4, the accuracy
    counts equal, every BatchNorm running mean and variance within 1e-5,
    parameters within ``check_params``'s bounds for one step.  Returns the
    port's model after the step."""
    cfg, b = case["cfg"], case["batch"]
    stage2 = which == "dynamic"
    ref, params, stats = jax_step(case, stage2, jit)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(case["model"].state_dict())
    got = train_step(model, make_optimizer(cfg, model), to_device(b, _CPU),
                     cfg)
    keys = ["loss", "activities_loss"] + ([] if stage2 else
                                         ["actions_loss"])
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("activities_correct", "activities_total"):
        assert int(got[k]) == int(ref[k]), k
    want = jax_params_to_state_dict(params, cfg, stats)
    own = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 40
    for k in keys:
        np.testing.assert_allclose(own[k].numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)
    check_params(model, params, cfg, 1, which)
    return model


def test_predictor_matches_jax(dynamic):
    check_predictor(dynamic, "dynamic")


def test_padded_actors_do_not_change_the_answer(dynamic):
    check_padded_actors(dynamic, "dynamic")


def test_reference_dynamic_collective_file_loads_strictly(dynamic,
                                                          tmp_path):
    """din_tpu's ``export_model_state`` of the collective model has the
    port's keys (the one DIN field as ``DPI.*``, BatchNorm buffers
    included) and values; its full-format reference ``.pth`` loads with no
    key skipped into a fresh model, which then equals the fixture's
    (``num_batches_tracked`` 0) and answers the same."""
    variables = {"params": dynamic["params"], "batch_stats": dynamic["stats"]}
    flat = export_model_state(variables, dynamic["jcfg"])
    own = dynamic["model"].state_dict()
    assert sorted(flat) == sorted(own)
    assert any(k.startswith("DPI.p_conv.") for k in flat)
    assert not any(k.startswith("DPI.DIMlist") for k in flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(v),
                                      err_msg=k)
    path = str(tmp_path / "dynamic_collective.pth")
    save_reference_checkpoint(variables, dynamic["jcfg"], path, fmt="full")
    model = build_model(dynamic["cfg"], device="cpu",
                        generator=torch.Generator().manual_seed(5))
    assert load_reference_checkpoint(model, path) == []
    model.load_state_dict(torch.load(path, weights_only=True)["state_dict"],
                          strict=True)
    b = dynamic["batch"]
    got = Predictor(dynamic["cfg"], model, device="cpu")(
        b["images"], b["boxes"], b["bboxes_num"])
    want = Predictor(dynamic["cfg"], dynamic["model"], device="cpu")(
        b["images"], b["boxes"], b["bboxes_num"])
    np.testing.assert_array_equal(got["activities"], want["activities"])


@pytest.mark.parametrize("fn", ["masked_max", "masked_mean",
                                "mask_actors"])
def test_masking_matches_din_tpu(fn):
    """utils/masking.py against din_tpu/utils/masking.py on [3,4,13,8]
    features and a [3,4,13,1] mask with an all-padded frame: equal bit for
    bit (a masked max of no valid cell is 0), the mean within 1e-6 (the
    order of a 13-term f32 sum)."""
    from din_tpu.utils import masking as jax_masking
    from din_tpu_torch.utils import masking

    rng = np.random.RandomState(12)
    x = rng.randn(3, 4, 13, 8).astype(np.float32)
    counts = np.array([[13, 13, 13, 13], [1, 0, 1, 1], [7, 5, 9, 2]])
    mask = (np.arange(13)[None, None] < counts[:, :, None])[..., None]
    args = (x, mask) if fn == "mask_actors" else (x, mask, 2)
    ref = np.asarray(getattr(jax_masking, fn)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
          for a in args)))
    got = getattr(masking, fn)(
        *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args)).numpy()
    assert got.shape == ref.shape
    if fn == "masked_mean":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


def test_collective_preset_needs_cuda_unless_asked_for_cpu(monkeypatch):
    """``build_model(collective_stage2_dynamic())`` with no ``device``
    raises when CUDA is absent; with ``device="cpu"`` it builds the model
    the preset names (ResNet-18, one DIN field ``DPI``, NFB 1024)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PRESETS["collective_stage2_dynamic"]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    model = build_model(cfg.replace(image_size=(64, 96), out_size=(2, 3)),
                        device="cpu")
    assert type(model).__name__ == "DynamicCollective"
    assert type(model.backbone).__name__ == "ResNet18Backbone"
    assert model.fc_emb_1.weight.shape == (1024, 25 * 512)
    assert type(model.DPI).__name__ == "DynamicPersonInference"
