"""The port's serving slice against the JAX package, on the CPU.

The same seeded parameters and requests go through din_tpu's
``DynamicVolleyball`` and din_tpu_torch's ``Predictor(device="cpu")``: full
VGG-16 / NFB 1024 / lite 128 widths at a small geometry (144x160 frames,
T=3, N=5, out_size (4,5); pool5 sees an odd 9 rows), in float32.  The
parameters are perturbed from their init (random DIN offset and affinity
convs, biases and LayerNorm affines) so that every weight's mapping and the
bilinear walk off the integer grid are exercised.
"""

import jax
import numpy as np
import pytest
import torch

from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.nn.ref_export import export_model_state
from din_tpu.train.engine import init_model
from din_tpu_torch.data.synthetic import make_synthetic_batch
from din_tpu_torch.experiments.predict import Predictor
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import jax_params_to_state_dict
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_GEOM = dict(image_size=(144, 160), out_size=(4, 5), num_frames=3,
             num_boxes=5, compute_dtype="float32")


def _perturb(tree, rng, path=()):
    """Seeded numpy perturbation of an initialised parameter tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, path + (k,))
            continue
        v = np.asarray(v, dtype=np.float32)
        din_conv = any(p.startswith(("p_conv", "scale_conv")) for p in path)
        if din_conv:
            v = (0.05 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "bias":
            v = v + (0.05 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "scale":
            v = v * (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def slice_case():
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]().replace(**_GEOM)
    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(**_GEOM)
    rng = np.random.RandomState(0)
    batch = make_synthetic_batch(cfg, 3, rng=rng)
    jmodel = jax_build_model(jcfg)
    variables = init_model(jcfg, jmodel, {k: v[:1] for k, v in batch.items()})
    params = _perturb(jax.device_get(variables["params"]), rng)
    model = build_model(cfg, device="cpu")
    state = jax_params_to_state_dict(params, cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    return jcfg, cfg, jmodel, params, model, batch


def test_state_dict_matches_export_model_state(slice_case):
    """The port's converter gives the same keys and values as the JAX
    package's ``export_model_state`` (exact: both are numpy transposes)."""
    jcfg, cfg, _, params, model, _ = slice_case
    ours = jax_params_to_state_dict(params, cfg)
    ref = export_model_state({"params": params}, jcfg)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    assert sorted(model.state_dict()) == sorted(ours)


def test_predictor_matches_jax_dynamic_volleyball(slice_case):
    """Softmax posteriors of the port's Predictor on the CPU against the JAX
    DynamicVolleyball, atol 1e-4: both run float32 end to end, and the
    difference is float32 summation order through 13 convs, RoIAlign
    (one-hot matmul against gather) and the DIN head."""
    jcfg, cfg, jmodel, params, model, batch = slice_case
    jax_logits = jax.jit(lambda p, i, b: jmodel.apply(
        {"params": p}, i, b, train=False)["activities"])(
        params, batch["images"], batch["boxes"])
    jax_post = np.asarray(jax.nn.softmax(jax_logits, axis=-1))
    got = Predictor(cfg, model, device="cpu")(batch["images"],
                                              batch["boxes"])["activities"]
    assert got.shape == (3, cfg.num_activities)
    np.testing.assert_allclose(got, jax_post, rtol=0, atol=1e-4)


def test_pad_to_splits_a_three_clip_request(slice_case):
    """pad_to=2 answers 3 clips with two padded calls; each row equals the
    unpadded answer (atol 1e-6: the same float32 program on other batch
    shapes may sum in another order)."""
    _, cfg, _, _, model, batch = slice_case
    plain = Predictor(cfg, model, device="cpu")
    padded = Predictor(cfg, model, pad_to=2, device="cpu")
    calls = []
    run = padded._run

    def counting_run(images, boxes, bboxes_num=None):
        calls.append(images.shape[0])
        return run(images, boxes, bboxes_num)

    padded._run = counting_run
    got = padded(batch["images"], batch["boxes"])["activities"]
    ref = plain(batch["images"], batch["boxes"])["activities"]
    assert calls == [2, 2]
    assert got.shape == (3, cfg.num_activities)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="pad_to"):
        Predictor(cfg, model, pad_to=0, device="cpu")
    with pytest.raises(ValueError, match="empty request"):
        padded(batch["images"][:0], batch["boxes"][:0])


def _load(module, state):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()}, strict=True)


def test_vgg16_backbone_matches_jax_with_odd_pool5():
    """Port VGG16Backbone (under no_grad: the fused stem's plain version,
    then K2's plain version for the other four pools) against the JAX one
    (folded stem, fold pool) at 48x80, where pool5 sees an odd 3x5 map;
    float32, atol 1e-5 relative to outputs of order 1e-2..1 (summation
    order only)."""
    from din_tpu.nn.backbones import VGG16Backbone as JaxVGG
    from din_tpu_torch.nn.backbones import VGG16Backbone
    from din_tpu_torch.nn.ref_export import export_backbone_state

    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (2, 48, 80, 3)).astype(np.float32)
    jm = JaxVGG(dtype=jax.numpy.float32, folded_stem=True)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    params = _perturb(jax.device_get(variables["params"]), rng)
    ref = np.asarray(jm.apply({"params": params}, x)[0])
    state = export_backbone_state(params, None, "vgg16")
    model = VGG16Backbone(torch.Generator().manual_seed(0))
    _load(model, state)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 1, 2, 512)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", [
    dict(dynamic_sampling=True, scale_factor=True, beta_factor=False),
    dict(dynamic_sampling=True, scale_factor=False, beta_factor=True,
         sampling_ratio=(1, 2)),
    dict(dynamic_sampling=False, scale_factor=True, beta_factor=False),
    dict(parallel_inference=True, scale_factor=True, beta_factor=False),
], ids=["walk_affinity", "walk_mean_beta_2ratios", "plain_grid", "parallel"])
def test_din_head_matches_jax(variant):
    """MultiDynamicInference with random (nonzero) offset and affinity convs,
    kernels (3,3) and (1,3), against the JAX head: float32, atol 1e-5 (the
    gather and the JAX one-hot matmul blend the same corners)."""
    from din_tpu.heads.din import MultiDynamicInference as JaxMulti
    from din_tpu_torch.heads.din import MultiDynamicInference
    from din_tpu_torch.nn.ref_export import _din

    rng = np.random.RandomState(8)
    B, T, N, C = 2, 4, 5, 16
    x = rng.randn(B, T, N, C).astype(np.float32)
    kernels = ((3, 3), (1, 3))
    kwargs = dict(dict(dynamic_sampling=True, sampling_ratio=(1,),
                       parallel_inference=False), **variant)
    jm = JaxMulti(in_dim=C, kernel_sizes=kernels, **kwargs)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    params = _perturb(jax.device_get(variables["params"]), rng)
    ref = np.asarray(jm.apply({"params": params}, x)[0])
    state = {}
    for k, v in params.items():
        _din(v, f"DIMlist.{k.split('_')[1]}.", state)
    model = MultiDynamicInference(C, torch.Generator().manual_seed(0),
                                  kernel_sizes=kernels, **kwargs)
    _load(model, state)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
