"""The DIN variants on the VGG-16 trunk against the JAX package, on the CPU:
``HierarchicalDynamicInference`` alone, and the full models of the
``volleyball_stage2_dynamic_hierarchical`` and ``_multi`` presets (forward,
the gradient of the eval-mode loss, and a reference-keyed state).  The TCE
model and its parts are in tests/test_torch_tce.py.

The same seeded numpy weights go through ``jax_params_to_state_dict`` into
the port; both sides run float32.  The full models run at 64x96 frames (a
2x3 map), T=3, N=4, B=2, NFB 64, lite 16, the JAX side with the canonical
stem (``folded_stem=False``, equal in value to the folded one).  The
hierarchical dropout's rate is fixed at 0.5, so gradients are compared in
eval mode, where no dropout draws.  JAX's jitted gradient is used: unlike
``DynamicCollective``'s (ROADMAP.md §3), it agrees with the port on every
tensor that no ReLU or pool flip reaches (measured <= 3.5e-6 of the
tensor's max), so no eager run is needed.  The gradient bounds are those
of tests/test_torch_train.py: 1e-4 of the JAX gradient's max where no flip
reaches, 1e-2 for the convs up to the deepest flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.heads.din import HierarchicalDynamicInference as JaxHier
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.nn.ref_export import save_reference_checkpoint
from din_tpu.train.engine import init_model
from din_tpu_torch.data.synthetic import make_synthetic_batch
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.heads.din import HierarchicalDynamicInference
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import _din, _ln, jax_params_to_state_dict
from din_tpu_torch.nn.ref_import import load_reference_checkpoint
from test_torch_train import (_backbone_flips, _conv_index, _perturb,
                              _torch_state)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

GEOM = dict(image_size=(64, 96), out_size=(2, 3), num_frames=3,
            num_boxes=4, num_features_boxes=64, lite_dim=16,
            compute_dtype="float32")


def variant_case(name, **extra):
    """(cfg, batch, JAX variables, logits, loss, grads in the port's keys,
    flips) of preset ``name`` at ``GEOM`` from seeded perturbed weights."""
    geom = dict(GEOM, **extra)
    jcfg = JAX_PRESETS[name]().replace(folded_stem=False, **geom)
    cfg = PRESETS[name]().replace(**geom)
    rng = np.random.RandomState(0)
    batch = make_synthetic_batch(cfg, 2, rng=rng)
    labels = batch["activities"][:, 0]
    jmodel = jax_build_model(jcfg)
    variables = init_model(jcfg, jmodel, {k: v[:1] for k, v in batch.items()})
    params = _perturb(jax.device_get(variables["params"]), rng)

    def loss(p):
        logits = jmodel.apply({"params": p}, batch["images"], batch["boxes"],
                              train=False)["activities"]
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2),
                                                    labels]), logits

    (jl, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    flips = _backbone_flips(params, cfg, batch["images"].reshape(
        -1, *cfg.image_size, 3))
    return dict(jcfg=jcfg, cfg=cfg, batch=batch, labels=labels,
                params=params, logits=np.asarray(logits), loss=float(jl),
                grads=jax_params_to_state_dict(jax.device_get(grads), cfg),
                flips=flips)


def port_grads(case):
    """The port's logits, loss and gradients on the case's weights, in eval
    mode (gradients on, so the stem runs as layers)."""
    cfg, batch = case["cfg"], case["batch"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_torch_state(case["params"], cfg), strict=True)
    model.eval()
    logits = model(torch.from_numpy(batch["images"]),
                   torch.from_numpy(batch["boxes"]))["activities"]
    loss = F.cross_entropy(logits, torch.from_numpy(case["labels"]).long())
    loss.backward()
    return (logits.detach().numpy(), loss.item(),
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def check_forward_and_grads(case):
    """Posteriors within atol 1e-5 (measured <= 3e-7), the loss within rtol
    1e-5, and every gradient within the bounds of the module docstring;
    each ReLU flip lies within 1e-5 of 0."""
    logits, loss, grads = port_grads(case)
    post = torch.softmax(torch.from_numpy(logits), -1).numpy()
    ref = np.asarray(jax.nn.softmax(case["logits"], axis=-1))
    np.testing.assert_allclose(post, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss, case["loss"], rtol=1e-5)
    for i, (n, z) in case["flips"].items():
        assert z <= 1e-5, f"layer {i}: {n} ReLU flips at |z| up to {z}"
    deepest = max(case["flips"], default=-1)
    assert sorted(grads) == sorted(case["grads"])
    for name, g in grads.items():
        g_jax = case["grads"][name]
        idx = _conv_index(name)
        bound = 1e-2 if idx is not None and idx <= deepest else 1e-4
        err = np.abs(g - g_jax).max()
        assert err <= bound * np.abs(g_jax).max(), (name, err,
                                                    np.abs(g_jax).max())


def check_reference_state_loads(case, tmp_path):
    """din_tpu's reference-layout ``.pth`` of the case's weights loads into
    the port by name: nothing skipped, every tensor of the model covered,
    each equal to ``jax_params_to_state_dict``'s."""
    path = str(tmp_path / "ref.pth")
    save_reference_checkpoint({"params": case["params"]}, case["jcfg"], path)
    model = build_model(case["cfg"], device="cpu")
    assert load_reference_checkpoint(model, path) == []
    want = jax_params_to_state_dict(case["params"], case["cfg"])
    file_keys = torch.load(path, weights_only=True)["state_dict"]
    assert sorted(file_keys) == sorted(model.state_dict()) == sorted(want)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.fixture(scope="module")
def hierarchical():
    return variant_case("volleyball_stage2_dynamic_hierarchical")


@pytest.fixture(scope="module")
def multi():
    return variant_case("volleyball_stage2_dynamic_multi")


def test_hierarchical_head_matches_jax():
    """The (1,3) then (3,1) fields with random nonzero offset and affinity
    convs and a perturbed ``hier_LN`` over [T,N,C], eval mode: atol 1e-5
    (the gather and the JAX one-hot matmul blend the same corners)."""
    rng = np.random.RandomState(8)
    B, T, N, C = 2, 4, 5, 16
    x = rng.randn(B, T, N, C).astype(np.float32)
    jm = JaxHier(in_dim=C, kernel_sizes=((1, 3), (3, 1)))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    params = _perturb(jax.device_get(variables["params"]), rng)
    ref = np.asarray(jm.apply({"params": params}, x)[0])
    state = {}
    _din(params["DPI_1"], "DPI_1.", state)
    _din(params["DPI_2"], "DPI_2.", state)
    _ln(params["hier_LN"], "hier_LN", state)
    model = HierarchicalDynamicInference(
        C, torch.Generator().manual_seed(0), (T, N))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    assert tuple(model.hier_LN.weight.shape) == (T, N, C)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        again = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, again)
    # in training its dropout (rate 0.5) draws: the output moves
    model.train()
    with torch.no_grad():
        assert not np.allclose(model(torch.from_numpy(x)).numpy(), got)


def test_hierarchical_model_matches_jax(hierarchical):
    check_forward_and_grads(hierarchical)


def test_multi_model_matches_jax(multi):
    check_forward_and_grads(multi)


def test_hierarchical_reference_state_loads_by_name(hierarchical, tmp_path):
    check_reference_state_loads(hierarchical, tmp_path)


def test_multi_reference_state_loads_by_name(multi, tmp_path):
    check_reference_state_loads(multi, tmp_path)


def test_variant_presets_build_at_full_width():
    """The three presets build at the flagship's widths (T=10, N=12, lite
    128; TCE without the bottleneck): the hierarchical head's LayerNorm over
    [10,12,128] between a (1,3) and a (3,1) field, two summed fields of
    those kernels for ``_multi``, and TCE's four 128-wide heads over the
    512-channel map feeding a DIN over 1024 + 4*128 features."""
    def build(name):
        cfg = PRESETS[name]().replace(load_backbone_stage2=False)
        return cfg, build_model(cfg, device="cpu")

    cfg, m = build("volleyball_stage2_dynamic_hierarchical")
    assert (cfg.hierarchical_inference, cfg.kernel_sizes) == (
        True, [(1, 3), (3, 1)])
    assert tuple(m.DPI.hier_LN.weight.shape) == (10, 12, 128)
    assert m.DPI.DPI_1.kernel_size == (1, 3)
    assert m.DPI.DPI_2.kernel_size == (3, 1)
    cfg, m = build("volleyball_stage2_dynamic_multi")
    assert [f.kernel_size for f in m.DPI.DIMlist] == [(1, 3), (3, 1)]
    cfg, m = build("volleyball_stage2_dynamic_tce")
    assert cfg.lite_dim is None and not hasattr(m, "point_conv")
    tce = m.multilayer_head_embfeature_context_encoding
    assert len(tce.CET) == 4
    assert tuple(tce.CET[0].downsample2.weight.shape) == (128, 512, 1, 1)
    assert tuple(tce.CET[0].emb_roi.weight.shape) == (128, 1024)
    assert tuple(m.dpi_nl.weight.shape) == (10, 12, 1536)
    assert tuple(m.fc_activities.weight.shape) == (8, 1536)
