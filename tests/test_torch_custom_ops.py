"""The five kernels of din_tpu_torch as ``torch.library`` custom ops, on the
CPU: ``din_tpu_torch::roi_align`` (K1), ``::roi_align_bwd`` (K1b),
``::max_pool_2x2`` (K2), ``::max_pool_2x2_bwd`` (K2b) and ``::fused_stem``
(K3).

``torch.library.opcheck`` checks each op's schema, fake implementation
(shape, dtype and strides against the CPU implementation), autograd
registration and a dynamic-shape AOT trace, at small shapes in float32 and
bfloat16.  The gradients of K1 and K2 through their registered autograd
equal those of autograd through the plain versions: K2's bit for bit on
inputs without ties (autograd of ``amax`` splits a tie, the op routes it to
the first argmax), K1's within 1e-6 in float32 (the two sum a pixel's
samples in another order) and within one bf16 ulp in bfloat16.  On fake
CUDA tensors, as ``torch.export`` traces a program on the card, the public
wrappers and the backward ops give the real outputs' shapes and launch
nothing; the stem's op has no gradient.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from din_tpu_torch.ops.pool import (max_pool_2x2, max_pool_2x2_bwd,
                                    max_pool_2x2_ref)
from din_tpu_torch.ops.roi_align import roi_align, roi_align_bwd, roi_align_ref
from din_tpu_torch.ops.stem import fused_stem

OPS = torch.ops.din_tpu_torch
DTYPES = [torch.float32, torch.bfloat16]


def _boxes(B, N, H, W, rng):
    """Boxes inside, across the border of and outside an HxW map."""
    x1 = rng.uniform(-2.0, W, (B, N))
    y1 = rng.uniform(-2.0, H, (B, N))
    return torch.from_numpy(np.stack(
        [x1, y1, x1 + rng.uniform(0.0, 4.0, (B, N)),
         y1 + rng.uniform(0.0, 4.0, (B, N))], -1).astype(np.float32))


def _case(name, dtype, rng):
    """Arguments of op ``name`` at small shapes; a strided x for the pools
    (a permuted channel-major map, as a conv may hand one over)."""
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)

    if name == "roi_align":
        return (t(2, 6, 7, 8).requires_grad_(True), _boxes(2, 3, 6, 7, rng),
                [5, 5])
    if name == "roi_align_bwd":
        return (t(2, 3, 5, 5, 8), _boxes(2, 3, 6, 7, rng), [6, 7], dtype)
    x = t(2, 8, 7, 9).permute(0, 2, 3, 1)                    # [2,7,9,8]
    if name == "max_pool_2x2":
        return (x.requires_grad_(True),)
    if name == "max_pool_2x2_bwd":
        return (x, t(2, 3, 4, 8))
    return (t(2, 8, 10, 3), t(64, 3, 3, 3), t(64), 0.1 * t(64, 64, 3, 3),
            t(64))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["roi_align", "roi_align_bwd", "max_pool_2x2",
                                  "max_pool_2x2_bwd", "fused_stem"])
def test_opcheck(name, dtype):
    rng = np.random.RandomState(0)
    args = _case(name, dtype, rng)
    torch.library.opcheck(getattr(OPS, name), args)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_roi_align_gradient_equals_the_plain_versions_autograd(dtype):
    rng = np.random.RandomState(1)
    features = torch.from_numpy(rng.randn(2, 6, 7, 8).astype(np.float32)).to(
        dtype)
    boxes = _boxes(2, 5, 6, 7, rng)
    g = torch.from_numpy(rng.randn(2, 5, 5, 5, 8).astype(np.float32)).to(dtype)
    grads = []
    for fn in (roi_align, roi_align_ref):
        f = features.clone().requires_grad_(True)
        fn(f, boxes, (5, 5)).backward(g)
        grads.append(f.grad.float())
    got, want = grads
    assert bool(want.abs().max() > 0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    else:   # one rounding of f32 sums taken in another order
        ulp = torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
        assert bool(((got - want).abs() <= ulp + 1e-6).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_max_pool_gradient_equals_the_plain_versions_autograd(dtype):
    rng = np.random.RandomState(2)
    # every 2x2 window holds 4k + a permutation of 0..3, k < 64: integers
    # below 256, exact in bf16, so no window holds a tie to split
    F, OH, OW, C = 2, 3, 4, 4
    k = np.arange(F * OH * OW * C).reshape(F, OH, OW, C) % 64
    win = 4 * k[..., None] + np.argsort(rng.rand(F, OH, OW, C, 4), -1)
    x = np.full((F, 2 * OH + 1, 2 * OW + 1, C), -1.0, np.float32)
    x[:, :2 * OH, :2 * OW] = win.reshape(F, OH, OW, C, 2, 2).transpose(
        0, 1, 4, 2, 5, 3).reshape(F, 2 * OH, 2 * OW, C)
    x = torch.from_numpy(x).to(dtype)
    g = torch.from_numpy(rng.randn(F, OH, OW, C).astype(np.float32)).to(dtype)
    grads = []
    for fn in (max_pool_2x2, max_pool_2x2_ref):
        xr = x.clone().requires_grad_(True)
        fn(xr).backward(g)
        grads.append(xr.grad)
    assert torch.equal(*grads)
    assert torch.equal(grads[0], max_pool_2x2_bwd(x, g))


def test_cpu_ops_run_the_plain_versions_and_count_nothing():
    rng = np.random.RandomState(3)
    before = (roi_align.launches, roi_align_bwd.launches,
              max_pool_2x2.launches, max_pool_2x2_bwd.launches,
              fused_stem.launches)
    f, boxes, crop = _case("roi_align", torch.float32, rng)
    assert torch.equal(OPS.roi_align(f, boxes, crop),
                       roi_align_ref(f, boxes, crop))
    x = _case("max_pool_2x2", torch.float32, rng)[0]
    assert torch.equal(OPS.max_pool_2x2(x), max_pool_2x2_ref(x))
    assert before == (roi_align.launches, roi_align_bwd.launches,
                      max_pool_2x2.launches, max_pool_2x2_bwd.launches,
                      fused_stem.launches) == (0, 0, 0, 0, 0)


def test_fused_stem_op_has_no_gradient():
    rng = np.random.RandomState(4)
    x, *params = _case("fused_stem", torch.float32, rng)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no autograd formula"):
        fused_stem(x, *params).sum().backward()


def test_fake_cuda_tensors_trace_without_launching():
    """What ``torch.export`` does on the card: the wrappers' checks accept
    fake CUDA tensors, and the five ops give the outputs' shapes, dtypes
    and devices without building or launching a kernel (the backward ops
    are called directly: the autograd engine of a CPU-only build of torch
    has no CUDA device to run them on)."""
    with FakeTensorMode():
        dev = torch.device("cuda")
        features = torch.empty(2, 6, 7, 8, dtype=torch.bfloat16, device=dev)
        boxes = torch.empty(2, 3, 4, device=dev)
        g_crops = torch.empty(2, 3, 5, 5, 8, dtype=torch.bfloat16, device=dev)
        g_pooled = torch.empty(2, 3, 3, 8, dtype=torch.bfloat16, device=dev)
        outs = [roi_align(features, boxes, (5, 5)),
                OPS.roi_align_bwd(g_crops, boxes, [6, 7], torch.bfloat16),
                max_pool_2x2(features),
                OPS.max_pool_2x2_bwd(features, g_pooled),
                fused_stem(torch.empty(2, 8, 10, 3, device=dev),
                           torch.empty(64, 3, 3, 3, device=dev),
                           torch.empty(64, device=dev),
                           torch.empty(64, 64, 3, 3, device=dev),
                           torch.empty(64, device=dev))]
        shapes = [(tuple(t.shape), t.dtype, t.device.type) for t in outs]
    assert shapes == [((2, 3, 5, 5, 8), torch.bfloat16, "cuda"),
                      ((2, 6, 7, 8), torch.bfloat16, "cuda"),
                      ((2, 3, 3, 8), torch.bfloat16, "cuda"),
                      ((2, 6, 7, 8), torch.bfloat16, "cuda"),
                      ((2, 4, 5, 64), torch.float32, "cuda")]
    assert (roi_align.launches, roi_align_bwd.launches, max_pool_2x2.launches,
            max_pool_2x2_bwd.launches, fused_stem.launches) == (0,) * 5
