"""The port's fused VGG stem (din_tpu_torch/ops/stem.py, kernel K3) against
the JAX package, on the CPU.

On a CPU tensor ``fused_stem`` runs its plain version ``fused_stem_ref``,
which these tests hold against din_tpu's Pallas ``fused_stem_fwd`` in
interpret mode (on the folded layout, as tests/test_stem.py runs it) and
against the port's own unfused layers; ``VGG16Backbone`` takes the fused
route exactly when autograd needs none of the stem's intermediates.  The
CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from din_tpu.nn.stem import fold_kernel
from din_tpu.ops.stem_kernel import fused_stem_fwd
from din_tpu_torch.nn import backbones
from din_tpu_torch.nn.backbones import VGG16Backbone
from din_tpu_torch.ops.pool import max_pool_2x2_ref
from din_tpu_torch.ops.stem import fused_stem, fused_stem_ref
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _params(rng, b0_shift=0.0):
    """Canonical HWIO stem weights, as tests/test_stem.py draws them."""
    k0 = (rng.randn(3, 3, 3, 64) * 0.1).astype(np.float32)
    b0 = (rng.randn(64) * 0.1 + b0_shift).astype(np.float32)
    k2 = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    b2 = (rng.randn(64) * 0.1).astype(np.float32)
    return k0, b0, k2, b2


def _torch_args(x, k0, b0, k2, b2, dtype):
    """NHWC frames and OIHW weights in ``dtype``."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in (x, k0.transpose(3, 2, 0, 1), b0,
                      k2.transpose(3, 2, 0, 1), b2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F_,H,W,R", [(2, 16, 48, 4), (1, 24, 16, 2),
                                      (3, 18, 96, 3)])
def test_fused_stem_ref_matches_pallas_stem_kernel(F_, H, W, R, dtype):
    """fused_stem_ref against din_tpu's fused_stem_fwd (interpret mode) on
    the shapes of tests/test_stem.py, with the canonical weights folded and
    the biases tiled as that test does.  float32 within atol 1e-5; bfloat16
    (inputs, weights and biases rounded to bf16 on both sides) within one
    bf16 ulp: both sum in f32 and round y1 and the output once, in another
    order."""
    rng = np.random.RandomState(11)
    x = (rng.rand(F_, H, W, 3) * 2 - 1).astype(np.float32)
    k0, b0, k2, b2 = _params(rng)
    tdt = getattr(torch, dtype)
    args = _torch_args(x, k0, b0, k2, b2, tdt)
    got = fused_stem_ref(*args).float().numpy()
    # the JAX side sees the same rounded values; its conv1_2 bias stays f32
    x, k0, b0, k2, b2 = (t.float().numpy() for t in args)
    k0, k2 = k0.transpose(2, 3, 1, 0), k2.transpose(2, 3, 1, 0)
    jdt = getattr(jnp, dtype)
    want = np.asarray(fused_stem_fwd(
        jnp.asarray(x, jdt).reshape(F_, H, W // 2, 6),
        fold_kernel(jnp.asarray(k0)), jnp.tile(jnp.asarray(b0), 2),
        fold_kernel(jnp.asarray(k2)), jnp.tile(jnp.asarray(b2), 2),
        rows_per_tile=R, interpret=True).astype(jnp.float32))
    assert got.shape == want.shape == (F_, H // 2, W // 2, 64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (np.abs(got - want) <= ulp).all(), \
            np.abs(got - want).max()


def _unfused(x, w0, b0, w2, b2):
    """The port's unfused layers (features[0:5] one by one)."""
    h = F.conv2d(x.permute(0, 3, 1, 2), w0, b0, padding=1).relu()
    h = F.conv2d(h, w2, b2, padding=1).relu()
    return max_pool_2x2_ref(h.permute(0, 2, 3, 1))


@pytest.mark.parametrize("F_,H,W,b0_shift", [(2, 7, 9, 0.0), (1, 15, 22, 0.0),
                                             (2, 16, 16, 3.0),
                                             (1, 9, 13, 3.0)],
                         ids=["odd_7x9", "odd_15x22", "b0_positive",
                              "odd_b0_positive"])
def test_fused_stem_ref_matches_unfused_layers(F_, H, W, b0_shift):
    """float32 within atol 1e-5 of the unfused layers, on odd maps (floor
    mode drops the last row or column) and with a large positive conv1_1
    bias.  With b0 > 0, a y1 halo filled with ReLU(b0) instead of conv1_2's
    zero padding changes the border: the test shows it would be caught."""
    rng = np.random.RandomState(3)
    x = (rng.rand(F_, H, W, 3) * 2 - 1).astype(np.float32)
    args = _torch_args(x, *_params(rng, b0_shift), torch.float32)
    got = fused_stem_ref(*args)
    want = _unfused(*args)
    assert got.shape == (F_, H // 2, W // 2, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if b0_shift:
        xt, w0, b0, w2, b2 = args
        y1 = F.conv2d(xt.permute(0, 3, 1, 2), w0, b0, padding=1).relu()
        wrong_pad = F.pad(y1, (1, 1, 1, 1), value=0.0)
        border = torch.ones_like(wrong_pad, dtype=torch.bool)
        border[:, :, 1:-1, 1:-1] = False
        wrong_pad = torch.where(border, b0.relu()[None, :, None, None],
                                wrong_pad)
        wrong = max_pool_2x2_ref(F.conv2d(wrong_pad, w2, b2).relu()
                                 .permute(0, 2, 3, 1))
        assert (wrong - got).abs().max() > 1e-2


@pytest.fixture
def stem_calls(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return fused_stem(*args)

    monkeypatch.setattr(backbones, "fused_stem", spy)
    return calls


def test_vgg16_gradient_free_route_calls_fused_stem(stem_calls):
    """VGG16Backbone at 48x80 (pool5 sees an odd 3x5 map), float32, at its
    init weights with random biases (outputs of order 1): under no_grad, and
    with a frozen backbone in grad mode, features[0:5] are one fused_stem
    call, equal within atol 1e-5 to the grad-mode route, which runs the
    layers one by one and never calls it (the two sum conv1_1 in another
    order)."""
    rng = np.random.RandomState(5)
    model = VGG16Backbone(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_(0.05 * torch.from_numpy(rng.randn(*p.shape)).float())
    x = torch.from_numpy((rng.rand(2, 48, 80, 3) * 2 - 1).astype(np.float32))
    with torch.no_grad():
        fused = model(x)
    assert stem_calls == [(2, 48, 80, 3)]
    layered = model(x)
    assert layered.requires_grad and len(stem_calls) == 1
    assert fused.shape == layered.shape == (2, 1, 2, 512)
    assert 0.1 < float(fused.abs().max()) < 10
    torch.testing.assert_close(fused, layered.detach(), rtol=0, atol=1e-5)
    model.requires_grad_(False)
    frozen = model(x)
    assert len(stem_calls) == 2 and not frozen.requires_grad
    torch.testing.assert_close(frozen, fused, rtol=0, atol=0)
    model(x.clone().requires_grad_(True))          # frames need a gradient
    assert len(stem_calls) == 2


def test_fused_stem_refuses_non_cpu_non_cuda_tensors():
    """The wrapper runs the plain version only for a CPU tensor; any other
    device must launch the kernel or raise, never fall back."""
    meta = [torch.empty(s, device="meta")
            for s in ((1, 8, 8, 3), (64, 3, 3, 3), (64,), (64, 64, 3, 3),
                      (64,))]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_stem(*meta)
    assert fused_stem.launches == 0
