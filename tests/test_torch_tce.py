"""TCE on the VGG-16 trunk against the JAX package, on the CPU: the
positional encodings, ``MultiHeadTCE``, the trunk's backbone map, and the
``volleyball_stage2_dynamic_tce`` model (forward, the gradient of the
eval-mode loss, a reference-keyed state), at the geometry and with the
bounds of tests/test_torch_din_variants.py.

The model's context encoder attends from each actor over every cell of the
last backbone map, so in the trained-backbone preset the map's gradient
reaches the backbone through TCE as well as through RoIAlign; the gradient
comparison covers both paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.heads import positional as jax_pos
from din_tpu.heads.tce import MultiHeadTCE as JaxTCE
from din_tpu_torch.heads import positional
from din_tpu_torch.heads.tce import MultiHeadTCE
from din_tpu_torch.models.trunk import trunk_forward
from din_tpu_torch.nn.backbones import VGG16Backbone
from din_tpu_torch.nn.ref_export import _tce
from test_torch_din_variants import (check_forward_and_grads,
                                     check_reference_state_loads,
                                     variant_case)
from test_torch_train import _perturb
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def tce_case():
    return variant_case("volleyball_stage2_dynamic_tce", lite_dim=None)


def _encodings(rng):
    """(name, JAX result, port result) of each encoding on the same
    inputs: a 22x40 map of 512 channels at downscale 16 (the flagship's),
    box centres of a 720x1280 frame."""
    ctx = rng.randn(2, 22, 40, 512).astype(np.float32)
    feats = rng.randn(2, 3, 4, 64).astype(np.float32)
    xy = rng.uniform(0, 40, (2, 3, 4, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(1, 6, xy.shape)],
                           -1).astype(np.float32)
    pos2 = rng.uniform(0, 50, (7, 2)).astype(np.float32)
    t = torch.from_numpy
    yield ("image", jax_pos.image_position_embedding_sine((22, 40), 64),
           positional.image_position_embedding_sine((22, 40), 64))
    yield ("image_normalized", jax_pos.image_position_embedding_sine(
        (22, 40), 32, normalize=True),
        positional.image_position_embedding_sine((22, 40), 32,
                                                 normalize=True))
    yield ("context", jax_pos.context_position_embedding_sine(
        jnp.asarray(ctx), 16, 256),
        positional.context_position_embedding_sine(t(ctx), 16, 256))
    yield ("sincos", jax_pos.sincos_encoding_2d(jnp.asarray(pos2), 16),
           positional.sincos_encoding_2d(t(pos2), 16))
    yield ("boxes", jax_pos.boxes_position_embedding(
        jnp.asarray(feats), jnp.asarray(boxes), (720, 1280), (22, 40)),
        positional.boxes_position_embedding(t(feats), t(boxes), (720, 1280),
                                            (22, 40)))


@pytest.mark.parametrize("which", ["image", "image_normalized", "context",
                                   "sincos", "boxes"])
def test_positional_encoding_matches_jax(which):
    """Each encoding against din_tpu's, atol 1e-6 (measured <= 4.8e-7,
    one ulp of the context sum; ``_dim_t`` is rounded once from float64 as
    XLA's power is, else an ulp of it shows as ~4e-5 in the sine of a
    720x1280 map's coordinates)."""
    got = {n: (np.asarray(j), p.numpy())
           for n, j, p in _encodings(np.random.RandomState(3))}[which]
    assert got[0].shape == got[1].shape
    np.testing.assert_allclose(got[1], got[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_multihead_tce_matches_jax(num_layers):
    """4 heads of NFC 16 over a 5x7 context of 24 channels, from 12 actor
    features: every weight perturbed; eval mode, atol 1e-5.  Two layers
    exercise the second layer's ``downsample`` and its input of the
    concatenated heads."""
    rng = np.random.RandomState(num_layers)
    roi = rng.randn(3, 6, 12).astype(np.float32)
    ctx = rng.randn(3, 5, 7, 24).astype(np.float32)
    jm = JaxTCE(num_heads=4, num_layers=num_layers, num_features_context=16)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), roi, ctx)
    params = _perturb(jax.device_get(variables["params"]), rng)
    ref = np.asarray(jm.apply({"params": params}, roi, ctx))
    state = {}
    _tce(params, "", state)
    model = MultiHeadTCE(12, 24, torch.Generator().manual_seed(0),
                         num_heads=4, num_layers=num_layers,
                         num_features_context=16)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(roi), torch.from_numpy(ctx)).numpy()
    assert got.shape == (3, 6, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    model.train()                # its two dropouts (rate 0.1) draw
    with torch.no_grad():
        assert not np.allclose(model(torch.from_numpy(roi),
                                     torch.from_numpy(ctx)).numpy(), got)


@pytest.mark.parametrize("train_backbone", [True, False])
def test_trunk_returns_the_map_with_the_backbones_gradient(train_backbone):
    """``return_map`` adds the backbone's map [B*T,OH,OW,D] beside the RoI
    features (the map they were pooled from); its gradient reaches the
    backbone when it trains and is stopped when it is frozen (no graph:
    the JAX trunk's ``stop_gradient``).  Without ``return_map`` the trunk
    returns the RoI features alone."""
    rng = np.random.RandomState(5)
    backbone = VGG16Backbone(torch.Generator().manual_seed(0))
    images = torch.from_numpy(rng.randint(0, 256, (1, 2, 64, 96, 3),
                                          dtype=np.uint8))
    boxes = torch.from_numpy(rng.uniform(0, 2, (1, 2, 3, 4))
                             .astype(np.float32))
    kw = dict(out_size=(2, 3), crop_size=(5, 5),
              compute_dtype=torch.float32, chunk=2,
              train_backbone=train_backbone)
    roi, fmap = trunk_forward(backbone, images, boxes, return_map=True, **kw)
    assert fmap.shape == (2, 2, 3, 512) and roi.shape == (1, 2, 3, 5, 5, 512)
    only = trunk_forward(backbone, images, boxes, **kw)
    assert isinstance(only, torch.Tensor)
    torch.testing.assert_close(only, roi, rtol=0, atol=0)
    assert fmap.requires_grad == train_backbone
    if train_backbone:
        fmap.sum().backward()
        assert backbone.features[0].weight.grad.abs().max() > 0


def test_tce_model_matches_jax(tce_case):
    check_forward_and_grads(tce_case)


def test_tce_reference_state_loads_by_name(tce_case, tmp_path):
    check_reference_state_loads(tce_case, tmp_path)
