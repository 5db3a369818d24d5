"""The ResNet-18 baseline models against the JAX package's, on the CPU:
PCTDM, HiGCIN (7x7 crops), AT (per frame and ``temporal_pooled_first``),
ARG (a 9-frame clip scored as three 3-frame crops), SACRF+BiUTE and
GCNNet for Volleyball (3-crop) and Collective Activity (3-crop, 13 and 5
actors), each from its din_tpu preset as din_tpu's tests/test_models.py
builds them: ResNet-18 at 64x96 frames (a 2x3 map), NFB = NFG = 64, NFR
32, 4 graphs, float32, RoIAlign ``onehot`` on the JAX side.

The same seeded numpy weights (kernels at their init scale, biases,
LayerNorm and BatchNorm affines and BatchNorm statistics away from their
init values; one ResNet-18 for every model) go into din_tpu's model as they
are and into the port's through ``jax_params_to_state_dict`` with a strict
``load_state_dict``.  The port runs its whole model; din_tpu's trunk runs
jitted once per geometry and its RoI features take the trunk's place in the
jitted head (``nn.intercept_methods``), which keeps this file's JAX
compiles to the heads.  Eval logits agree within 1e-5 of their largest
|value| (measured <= 3.1e-6) and posteriors within atol 1e-5 (the halting
loss within rtol 1e-5); HiGCIN's and SACRF's classifiers are scaled so that
their softmax is not saturated (``setup``).

The port's reference-file and Adam adoption tests of these models are in
tests/test_torch_baselines_ckpt.py, one training step of PCTDM, HiGCIN and
SACRF against din_tpu in tests/test_torch_baselines_train.py; both use
this file's helpers.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.models.trunk import Trunk, trunk_from_cfg
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import jax_params_to_state_dict
from test_torch_threads import one_thread  # noqa: F401 (autouse)

GEOM = dict(image_size=(64, 96), out_size=(2, 3), num_frames=4,
            num_boxes=12, num_features_boxes=64, num_features_gcn=64,
            num_features_relation=32, num_graph=4, compute_dtype="float32",
            load_backbone_stage2=False, train_dropout_prob=0.0)
_THREE = dict(num_frames=3)
CASES = {
    "pctdm": ("volleyball_stage2_pctdm", {}),
    "higcin": ("volleyball_stage2_higcin", {}),
    "at": ("volleyball_stage2_at", {}),
    "at_pooled": ("volleyball_stage2_at", dict(temporal_pooled_first=True)),
    "arg": ("volleyball_stage2_arg", _THREE),
    "sacrf": ("volleyball_stage2_sacrf_biute", {}),
    "gcnnet_volleyball": ("volleyball_stage2_arg", dict(
        _THREE, inference_module_name="gcnnet_volleyball")),
    "gcnnet_collective": ("collective_stage2_dynamic", dict(
        _THREE, inference_module_name="gcnnet_collective", num_boxes=13)),
}
# models that score a clip of 9 frames as three crops of 3
THREE_CROP = ("arg", "gcnnet_volleyball", "gcnnet_collective")
# the largest |activity logit| of a case's eval batch (see setup)
LOGIT_MAX = 4.0


def random_params(tree, rng):
    """Seeded values (``rng`` a numpy Generator) of an initialised tree's
    shapes: kernels with std
    sqrt(2 / fan_in), biases ~0.1, scales (LayerNorm, BatchNorm, SACRF's
    clique weights) near 1, BatchNorm statistics off 0 and 1."""
    out = {}
    for k, v in sorted(tree.items()):
        if hasattr(v, "items"):
            out[k] = random_params(v, rng)
            continue
        shape = v.shape
        noise = rng.standard_normal(shape, dtype=np.float32)
        if "kernel" in k:
            v = noise * np.float32(np.sqrt(2.0 / np.prod(shape[:-1])))
        elif k.endswith("bias") or k == "mean":
            v = 0.1 * noise
        elif k.endswith("scale") or k == "w":
            v = 1.0 + 0.1 * noise
        elif k == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            raise KeyError(k)
        out[k] = np.asarray(v, np.float32)
    return out


def make_batch(cfg, T, seed=0, B=2):
    """B clips of T frames, boxes on the map; collective clips with 13 and
    5 actors (zero boxes and action -1 after the count)."""
    rng = np.random.RandomState(seed)
    N = cfg.num_boxes
    OH, OW = cfg.out_size
    xy = rng.uniform(0, 1, (B, T, N, 2)) * [OW - 1, OH - 1]
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 1.5, xy.shape)], -1)
    batch = {"images": rng.randint(0, 255, (B, T, *cfg.image_size, 3))
             .astype(np.uint8),
             "boxes": boxes.astype(np.float32),
             "actions": rng.randint(0, cfg.num_actions, (B, T, N))
             .astype(np.int32),
             "activities": np.repeat(rng.randint(0, cfg.num_activities,
                                                 (B, 1)), T, 1)
             .astype(np.int32)}
    if cfg.dataset_name == "collective":
        counts = np.array([[N] * T, [5] * T], np.int32)[:B]
        real = np.arange(N)[None, None] < counts[:, :, None]
        batch["boxes"] = np.where(real[..., None], batch["boxes"],
                                  0).astype(np.float32)
        batch["actions"] = np.where(real, batch["actions"], -1).astype(
            np.int32)
        batch["bboxes_num"] = counts
    return batch


_TRUNK = {}


def shared_trunk(jcfg, sample):
    """One ResNet-18 (params and BatchNorm statistics) for every model."""
    if "vars" not in _TRUNK:
        shapes = jax.eval_shape(lambda: trunk_from_cfg(jcfg).init(
            jax.random.PRNGKey(0), sample["images"], sample["boxes"]))
        _TRUNK["vars"] = random_params(shapes, np.random.default_rng(7))
    return _TRUNK["vars"]


def no_trunk(jcfg):
    """An interceptor that stands in for din_tpu's trunk with zero RoI
    features [B,T,N,KH,KW,512] (the head's shapes, traced only)."""
    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, Trunk):
            B, T, N = args[1].shape[:3]
            return jnp.zeros((B, T, N, *jcfg.crop_size, 512)), None, None
        return next_fun(*args, **kwargs)
    return intercept


def setup(name, seed=0, unsaturate=False, **overrides):
    """din_tpu's and the port's model of case ``name`` (its config fields
    replaced by ``overrides``) on the same weights, and an eval batch (9
    frames for the 3-crop models) and a training batch.  ``unsaturate``:
    the classifier scaled for the eval checks (below)."""
    preset, extra = CASES[name]
    geom = dict(GEOM, **extra, **overrides)
    jcfg = JAX_PRESETS[preset]().replace(roi_align_impl="onehot", **geom)
    cfg = PRESETS[preset]().replace(**geom)
    jmodel = jax_build_model(jcfg)
    batch = make_batch(cfg, 9 if name in THREE_CROP else cfg.num_frames,
                       seed)
    train_batch = make_batch(cfg, cfg.num_frames, seed + 1)
    sample = {k: jnp.asarray(v[:1]) for k, v in train_batch.items()}

    def init():
        with flax.linen.intercept_methods(no_trunk(jcfg)):
            return jmodel.init(jax.random.PRNGKey(0), sample["images"],
                               sample["boxes"],
                               bboxes_num=sample.get("bboxes_num"),
                               train=False)

    variables = random_params(jax.eval_shape(init),
                              np.random.default_rng(seed))
    trunk = shared_trunk(jcfg, sample)
    variables["params"]["trunk"] = trunk["params"]
    variables.setdefault("batch_stats", {})["trunk"] = trunk["batch_stats"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(port_state(variables, cfg), strict=True)
    case = dict(name=name, jcfg=jcfg, cfg=cfg, jmodel=jmodel,
                variables=variables, model=model, batch=batch,
                train_batch=train_batch)
    # HiGCIN's cross-inference block is cubic in its input and SACRF sums
    # its cliques' energies: at these weights their activity logits reach
    # 3e12 and 5e2, a one-hot softmax that agrees whatever the head
    # computes.  The classifier (kernel and bias) is scaled so that the
    # eval logits are at most LOGIT_MAX; that scales the logits alone.
    top = float(np.abs(port_eval(case, batch)["activities"]).max()) \
        if unsaturate else 0.0
    if top > LOGIT_MAX:
        fc = variables["params"]["fc_activities"]
        for k in fc:
            fc[k] = (fc[k] * np.float32(LOGIT_MAX / top)).astype(np.float32)
        model.load_state_dict(port_state(variables, cfg), strict=True)
    return case


def port_state(variables, cfg):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_params_to_state_dict(variables["params"], cfg,
                                     variables["batch_stats"]).items()}


def trunk_inputs(images, boxes, three_crop):
    """What the model hands its trunk: the 3-crop split [B,9] -> [3B,3]."""
    if not three_crop:
        return images, boxes
    B, T = images.shape[:2]
    return (images.reshape(B * 3, T // 3, *images.shape[2:]),
            boxes.reshape(B * 3, T // 3, *boxes.shape[2:]))


_JAX_TRUNKS = {}


def jax_trunk(jcfg):
    """din_tpu's trunk in eval mode, jitted once per crop size: (variables,
    images, boxes) -> RoI features."""
    crop = tuple(jcfg.crop_size)
    if crop not in _JAX_TRUNKS:
        trunk = trunk_from_cfg(jcfg)
        _JAX_TRUNKS[crop] = jax.jit(
            lambda tv, im, bx: trunk.apply(tv, im, bx)[0])
    return _JAX_TRUNKS[crop]


def jax_eval(case, batch):
    """din_tpu's eval outputs: its trunk jitted, then the jitted model with
    those RoI features in the trunk's place."""
    jcfg, v = case["jcfg"], case["variables"]
    three = case["name"] in THREE_CROP and batch["images"].shape[1] == 9
    images, boxes = trunk_inputs(batch["images"], batch["boxes"], three)
    roi = jax_trunk(jcfg)({"params": v["params"]["trunk"],
                           "batch_stats": v["batch_stats"]["trunk"]},
                          images, boxes)

    def use_roi(next_fun, args, kwargs, context):
        if isinstance(context.module, Trunk):
            return roi, None, None
        return next_fun(*args, **kwargs)

    def apply(variables):
        with flax.linen.intercept_methods(use_roi):
            return case["jmodel"].apply(
                variables, batch["images"], batch["boxes"],
                bboxes_num=batch.get("bboxes_num"), train=False)

    with jax.default_matmul_precision("highest"):
        return jax.device_get(jax.jit(apply)(v))


def port_eval(case, batch):
    model = case["model"].eval()
    with torch.no_grad():
        out = model(torch.from_numpy(batch["images"]),
                    torch.from_numpy(batch["boxes"]),
                    None if "bboxes_num" not in batch
                    else torch.from_numpy(batch["bboxes_num"]))
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module", params=[
    "pctdm", "higcin", "at", "at_pooled", "sacrf"])
def case(request):
    return setup(request.param, unsaturate=True)


def check_eval(case):
    """Activity (and, where the model has them, action) logits within 1e-5
    of their largest |value| and posteriors within atol 1e-5, no posterior
    row of din_tpu's within 1e-3 of one-hot (a saturated softmax would hide
    a wrong head); SACRF's halting loss within rtol 1e-5, its actor states
    within 1e-5 of their largest |value|; GCNNetCollective's action mask
    equal."""
    want = jax_eval(case, case["batch"])
    got = port_eval(case, case["batch"])
    B = case["batch"]["images"].shape[0]
    assert got["activities"].shape == (B, case["cfg"].num_activities)
    assert sorted(got) == sorted(want)
    for k in ("activities", "actions"):
        if k in want:
            logits = np.asarray(want[k])
            np.testing.assert_allclose(got[k], logits, rtol=0,
                                       atol=1e-5 * np.abs(logits).max(),
                                       err_msg=k)
            posteriors = np.asarray(jax.nn.softmax(logits, axis=-1))
            assert posteriors.max() < 1 - 1e-3, (k, posteriors.max())
            np.testing.assert_allclose(
                torch.softmax(torch.from_numpy(got[k]), -1).numpy(),
                posteriors, rtol=0, atol=1e-5, err_msg=k)
    if "halting" in want:
        np.testing.assert_allclose(got["halting"], want["halting"],
                                   rtol=1e-5)
        states = want["boxes_states"]
        np.testing.assert_allclose(got["boxes_states"], states, rtol=0,
                                   atol=1e-5 * np.abs(states).max())
    if "actions_mask" in want:
        np.testing.assert_array_equal(got["actions_mask"],
                                      want["actions_mask"])


def test_eval_posteriors_match_jax(case):
    check_eval(case)
