"""ResNet-18 and ``DynamicCollective`` in bfloat16 against the JAX package's
bfloat16 models, on the CPU: the compute dtype the card runs them in.

Weights are the seeded, perturbed float32 ones of
tests/test_torch_resnet.py and tests/test_torch_collective.py (every
BatchNorm affine and statistic away from its init); frames of 64x96 (a 2x3
map), T=3.  din_tpu runs its folded stem (``folded_stem=True``, as it
serves), the port the canonical 7x7/s2 conv.

What bf16 makes of the comparison. Fed the same bf16 input, each layer of
the two frameworks gives the same bf16 output but for rare elements one
rounding apart: the convs sum in another order before the one rounding to
bf16, BatchNorm computes din_tpu's float32 formula and casts once
(bit-equal here), the residual add and the ReLU run in bf16 on both sides.
So the stem and every residual block, each fed din_tpu's bf16 input, are
held within 2 bf16 ulps of the output's largest magnitude (one rounding
apart, scaled by BatchNorm; measured: the stem 1.0 in eval and 0.5 in train
mode, the blocks at most 0.5 and 1.0): a wrong cast or a statistic taken in
bf16 would show as many ulps at once. Through 20 layers those one-ulp
differences grow as bf16 rounding noise does: din_tpu's own bf16 map lies
1.6 (eval) and 9.7 (train, batch statistics) ulps of its largest magnitude
from a float64 run of the same network, the port's 1.35 and 10.7, and the
two maps 1.5 and 7.0 ulps from each other. The whole map is held within
twice din_tpu's distance from float64 of din_tpu's map (measured 0.94x and
0.72x of it), and no farther from float64 than 1.5 times din_tpu's (0.84x,
1.10x). The folded stem sums conv1's 147 products in another order than the
canonical conv: on its own that moves din_tpu's stem output by one bf16 ulp
in under 1e-4 of the elements, the same kind and size of difference as between
the frameworks' canonical convs, and its bf16 posteriors by up to 1.7e-3
against its canonical stem's (the port lies 2.3e-3 from the folded and
1.7e-3 from the canonical): folding neither adds a systematic term nor
changes the tolerance's unit. The model's posteriors are held within 2**-8
(one bf16 ulp at [0.5, 1)) of din_tpu's, and no farther from din_tpu's
float32 posteriors than din_tpu's own bf16 ones are (measured 8.0e-4
against 2.1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.experiments.predict import Predictor as JaxPredictor
from din_tpu.nn.backbones import ResNet18Backbone as JaxRes18
from din_tpu_torch.experiments.predict import Predictor
import test_torch_collective
from test_torch_resnet import _to_port, perturb_bn
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_HW = (64, 96)


def scale_ulp(x: np.ndarray) -> float:
    """One bf16 ulp (8 significant bits) at x's largest magnitude."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


@pytest.fixture(scope="module")
def res18():
    x = np.random.RandomState(1).uniform(-1, 1, (4, *_HW, 3)).astype(
        np.float32)
    variables = jax.device_get(jax.jit(
        JaxRes18(dtype=jnp.float32, folded_stem=False).init)(
        jax.random.PRNGKey(0), x[:1]))
    params, stats = perturb_bn(variables["params"], variables["batch_stats"],
                               np.random.RandomState(2))
    # the frames as the trunk hands them to a bf16 backbone
    xb = torch.from_numpy(x).bfloat16()
    return dict(params=params, stats=stats, xb=xb,
                xj=jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))


def _jax_bf16(r, train):
    """din_tpu's bf16 ResNet-18 (folded stem): its map and every
    submodule's output."""
    jm = JaxRes18(dtype=jnp.bfloat16, folded_stem=True)
    (out,), inter = jm.apply(
        {"params": r["params"], "batch_stats": r["stats"]}, r["xj"], train,
        capture_intermediates=True, mutable=["intermediates", "batch_stats"])
    return np.asarray(out.astype(jnp.float32)), inter["intermediates"]


def _np(t: torch.Tensor) -> np.ndarray:
    """NCHW bf16 -> NHWC float32 numpy."""
    return t.permute(0, 2, 3, 1).float().numpy()


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() \
        .permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet18_layers_bf16_match_jax(res18, mode):
    """The stem (conv1 + bn1, against din_tpu's folded stem) on the same
    bf16 frames, and each of the 8 residual blocks fed din_tpu's bf16
    input, within 2 bf16 ulps of the output's largest magnitude; every
    output bf16 (the module docstring says why)."""
    train = mode == "train"
    _, inter = _jax_bf16(res18, train)
    model = _to_port(res18["params"], res18["stats"]).train(train)
    f = model.features
    with torch.no_grad():
        x = res18["xb"].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        stem = f[1](torch.nn.functional.conv2d(
            x, f[0].weight.bfloat16(), None, 2, 3))
    want = np.asarray(inter["bn1"]["__call__"][0].astype(jnp.float32))
    assert stem.dtype == torch.bfloat16
    assert np.abs(_np(stem) - want).max() <= 2 * scale_ulp(want)

    bn1 = inter["bn1"]["__call__"][0]
    h = jax.lax.reduce_window(jnp.maximum(bn1, 0), -jnp.inf, jax.lax.max,
                              (1, 3, 3, 1), (1, 2, 2, 1),
                              ((0, 0), (1, 1), (1, 1), (0, 0)))
    blocks = [(f"layer{i + 1}_{j}", block)
              for i, stage in enumerate(f[4:]) for j, block in
              enumerate(stage)]
    assert len(blocks) == 8
    for name, block in blocks:
        want = inter[name]["__call__"][0]
        with torch.no_grad():
            got = block(_nchw(h))
        assert got.dtype == torch.bfloat16
        want_np = np.asarray(want.astype(jnp.float32))
        err = np.abs(_np(got) - want_np).max()
        assert err <= 2 * scale_ulp(want_np), (name, err / scale_ulp(want_np))
        h = want


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet18_map_bf16_matches_jax(res18, mode):
    """The whole bf16 map against din_tpu's: within twice din_tpu's own
    distance from a float64 run of its map, and no farther from that run
    than 1.5 times din_tpu's (train mode: batch statistics)."""
    train = mode == "train"
    ref, _ = _jax_bf16(res18, train)
    with torch.no_grad():
        got = _to_port(res18["params"], res18["stats"]).train(train)(
            res18["xb"]).float().numpy()
        exact = _to_port(res18["params"], res18["stats"]).double().train(
            train)(res18["xb"].double()).numpy()
    assert got.shape == ref.shape == (4, 2, 3, 512)
    jax_err = np.abs(ref - exact).max()
    assert np.abs(got - ref).max() <= 2 * jax_err, (
        np.abs(got - ref).max() / scale_ulp(ref), jax_err / scale_ulp(ref))
    assert np.abs(got - exact).max() <= 1.5 * jax_err


def test_dynamic_collective_bf16_matches_jax(monkeypatch):
    """``DynamicCollective`` (the preset, full widths: NFB 1024, 13 actor
    slots with 13, 1 and 7/5/9 real) with its backbone in bf16 and its head
    in f32: posteriors within 2**-8 of din_tpu's bf16 model (folded stem),
    and no farther from din_tpu's float32 posteriors than din_tpu's bf16
    ones; rows sum to 1."""
    monkeypatch.setattr(test_torch_collective, "_GEOM", dict(
        test_torch_collective._GEOM, compute_dtype="bfloat16"))
    case = test_torch_collective._setup("collective_stage2_dynamic", 0)
    b = case["batch"]
    args = (b["images"], b["boxes"], b["bboxes_num"])
    variables = {"params": case["params"], "batch_stats": case["stats"]}
    jcfg = case["jcfg"].replace(folded_stem=True)
    assert jcfg.compute_dtype == case["cfg"].compute_dtype == "bfloat16"
    ref = np.asarray(JaxPredictor(jcfg, variables)(*args)["activities"])
    f32 = np.asarray(JaxPredictor(jcfg.replace(compute_dtype="float32"),
                                  variables)(*args)["activities"])
    got = Predictor(case["cfg"], case["model"], device="cpu")(*args)[
        "activities"]
    assert got.shape == ref.shape == (3, 4)
    np.testing.assert_allclose(got.sum(-1), 1, atol=1e-5)
    assert np.abs(got - ref).max() <= 2.0 ** -8
    assert np.abs(got - f32).max() <= np.abs(ref - f32).max()
