"""The raw-RoI TCE pieces and the spatio-temporal bilinear attention of
heads/tce.py against din_tpu/heads/tce.py, on the CPU in float32 (JAX
under ``default_matmul_precision("highest")``).

din_tpu's modules are initialised from a PRNG key; their params go through
``jax_params_to_state_dict`` into the port's modules (strict loads: every
key is the reference's) and the same seeded numpy inputs through both.
Tolerance: 1e-5 of the output's largest |value|; both sides sum the same
f32 products in other orders (measured at most ~1e-6), which is also the
bound ``chip_smoke.py`` phase 15 holds the card to.  The distance mask is
compared exactly.  Dropout is compared in eval mode (the two frameworks'
generators draw different masks); in training the port's masks come from
``SeededDropout`` and repeat with its seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.heads import tce as jtce
from din_tpu_torch.heads import tce
from din_tpu_torch.nn.layers import SeededDropout
from din_tpu_torch.nn.ref_export import jax_params_to_state_dict
from test_torch_threads import one_thread  # noqa: F401 (autouse)

RTOL_OF_MAX = 1e-5


def _load(module, params):
    state = jax_params_to_state_dict(jax.device_get(params), None)
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()}, strict=True)
    return module.eval()


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= RTOL_OF_MAX * np.abs(want).max(), err


@pytest.mark.parametrize("heads,layers", [(1, 1), (2, 2)])
def test_raw_roi_context_encoding_matches_jax(heads, layers):
    """``MultiHeadLayerContextEncoding`` (and with one head and layer a
    single ``ContextEncoding``): the RoIAlign crop [BT,N,K,K,D] and a
    context map [BT,OH,OW,C] -> [BT,N,heads*NFC]."""
    rng = np.random.RandomState(3)
    BT, N, D, K, NFC, OH, OW, C = 3, 12, 24, 5, 16, 7, 9, 40
    roi = rng.randn(BT, N, K, K, D).astype(np.float32)
    img = rng.randn(BT, OH, OW, C).astype(np.float32)
    jmod = jtce.MultiHeadLayerContextEncoding(
        num_heads=heads, num_layers=layers, num_features_context=NFC)
    with jax.default_matmul_precision("highest"):
        v = jmod.init(jax.random.PRNGKey(heads), roi, img)
        want = jmod.apply(v, roi, img, deterministic=True)
    port = _load(tce.MultiHeadLayerContextEncoding(
        D, C, torch.Generator().manual_seed(0), num_heads=heads,
        num_layers=layers, num_features_context=NFC, crop_size=K),
        v["params"])
    _close(port(torch.from_numpy(roi), torch.from_numpy(img)), want)
    if heads == 1 and layers == 1:
        single = _load(tce.ContextEncoding(
            D, C, NFC, torch.Generator().manual_seed(1), crop_size=K),
            v["params"]["CET_0_0"])
        _close(single(torch.from_numpy(roi), torch.from_numpy(img)), want)
    drops = [m for m in port.modules() if isinstance(m, SeededDropout)]
    assert len(drops) == 2 * heads * layers
    port.train()
    x = (torch.from_numpy(roi), torch.from_numpy(img))
    first = port(*x)
    for m in drops:
        m.generator = None
    assert torch.equal(port(*x), first)
    assert not torch.equal(first, port.eval()(*x))


def test_stbilinear_matches_jax():
    """``STBilinearMessagePassing`` over the T*N tokens with a random mask
    and one fully suppressed row (0 on both sides, not NaN)."""
    rng = np.random.RandomState(4)
    B, T, N, C, M = 2, 3, 6, 16, 12
    x = rng.randn(B * T, N, C).astype(np.float32)
    mask = rng.rand(B, T * N, T * N) < 0.3
    mask[:, :, 0] = False
    mask[1, 5, :] = True
    jmod = jtce.STBilinearMessagePassing(emb_dim=C, message_dim=M, T=T)
    with jax.default_matmul_precision("highest"):
        v = jmod.init(jax.random.PRNGKey(0), x, mask)
        want = jmod.apply(v, x, mask)
    port = _load(tce.STBilinearMessagePassing(
        C, M, torch.Generator().manual_seed(0), T=T), v["params"])
    got = port(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, want)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("fusion,shortcut", [("sum", False), ("sum", True),
                                             ("cat", False)])
def test_multihead_stbilinear_matches_jax(fusion, shortcut):
    rng = np.random.RandomState(5)
    B, T, N, C, M, H = 1, 3, 4, 8, 8, 2
    x = rng.randn(B * T, N, C).astype(np.float32)
    mask = rng.rand(B, T * N, T * N) < 0.3
    mask[:, :, 0] = False
    jmod = jtce.MultiHeadSTBilinear(emb_dim=C, message_dim=M, num_heads=H,
                                    T=T)
    with jax.default_matmul_precision("highest"):
        v = jmod.init(jax.random.PRNGKey(1), x, mask)
        want = jmod.apply(v, x, mask, fusion_method=fusion,
                          shortcut_connection=shortcut)
    port = _load(tce.MultiHeadSTBilinear(
        C, M, H, torch.Generator().manual_seed(0), T=T), v["params"])
    _close(port(torch.from_numpy(x), torch.from_numpy(mask), fusion,
                shortcut_connection=shortcut), want)


def test_spatial_mask_matches_jax():
    rng = np.random.RandomState(6)
    BT, N, OH = 6, 12, 45
    boxes = rng.uniform(0, 80, (BT, N, 4)).astype(np.float32)
    want = np.asarray(jtce.generate_spatial_mask(jnp.asarray(boxes), 0.3,
                                                 OH))
    got = tce.generate_spatial_mask(torch.from_numpy(boxes), 0.3, OH)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)
