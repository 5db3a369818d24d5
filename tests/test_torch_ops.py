"""The port's operators (din_tpu_torch/ops) against the JAX package's, on the
CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, which is what
these tests hold against din_tpu: the 2x2 max-pool and its backward against
the Pallas fold pool in interpret mode and against ``max_pool_torch``,
RoIAlign against the Pallas kernel in interpret mode and the one-hot einsum,
and its backward against the VJPs of the one-hot and gather forms.  The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from din_tpu.nn.layers import max_pool_torch
from din_tpu.ops.pool import fold_pool_2x2
from din_tpu.ops.roi_align import roi_align as jax_roi_align
from din_tpu_torch.ops import native
from din_tpu_torch.ops.image import prep_images
from din_tpu_torch.ops.pool import (max_pool_2x2, max_pool_2x2_bwd,
                                    max_pool_2x2_bwd_ref)
from din_tpu_torch.ops.roi_align import (_sample_grid, roi_align,
                                         roi_align_bwd, roi_align_bwd_ref)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_matches_pallas_fold_pool(dtype):
    """Port max_pool_2x2 on NHWC x against the JAX fold pool (Pallas kernel,
    interpret mode) on x viewed in its folded layout [F,H,W/2,2C]: equal bit
    for bit, since a max is exact."""
    rng = np.random.RandomState(1)
    F, H, W, C = 2, 8, 12, 16
    x = rng.randn(F, H, W, C).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    ref = fold_pool_2x2(jx.reshape(F, H, W // 2, 2 * C),
                        impl="pallas_interpret")
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = max_pool_2x2(tx)
    assert got.dtype == tx.dtype and got.shape == (F, H // 2, W // 2, C)
    np.testing.assert_array_equal(_to_np(got),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(2, 9, 10, 8), (1, 6, 7, 4), (3, 5, 5, 3)])
def test_max_pool_floor_mode_matches_max_pool_torch(shape):
    """Odd H and/or W: the last row/column is dropped, as JAX max_pool_torch
    (torch MaxPool2d floor mode) does; bit-equal."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref = np.asarray(max_pool_torch(jnp.asarray(x), 2, 2))
    np.testing.assert_array_equal(max_pool_2x2(torch.from_numpy(x)).numpy(),
                                  ref)


def _boxes_off_border(rng, B, N, H, W, lo, span, crop):
    """Random boxes whose samples stay >= 1e-3 away from the map border:
    there a one-ulp difference between two float32 computations of a centre
    flips the in-range test of a whole sample."""
    out = np.empty((B, N, 4), np.float32)
    for b in range(B):
        for n in range(N):
            while True:
                x1 = rng.uniform(lo, W - 2)
                y1 = rng.uniform(lo, H - 2)
                box = np.array([x1, y1, x1 + rng.uniform(*span),
                                y1 + rng.uniform(*span)], np.float32)
                ys, xs = (g.numpy() for g in _sample_grid(
                    torch.from_numpy(box), crop))
                near = [np.abs(ys).min(), np.abs(ys - (H - 1)).min(),
                        np.abs(xs).min(), np.abs(xs - (W - 1)).min()]
                if min(near) >= 1e-3:
                    out[b, n] = box
                    break
    return out


def _edge_boxes(H, W):
    """Coordinates exact in binary: samples on the border (in range), one
    row off the map, a zero-area box and a box fully outside."""
    return np.array([[
        [0.0, -1.0, 5.0, 4.0],            # xs 0..4, ys -1..3: row 0 is out
        [W - 5.0, H - 5.0, W, H],         # last samples exactly on W-1, H-1
        [3.25, 2.5, 3.25, 2.5],           # zero area: all at (2.0, 2.75)
        [W + 1.0, H + 1.0, W + 3.0, H + 3.0],   # fully outside: zeros
    ]], np.float32)


@pytest.mark.parametrize("impl", ["pallas_interpret", "onehot"])
@pytest.mark.parametrize("case", ["inner", "partly_outside"])
def test_roi_align_matches_jax(impl, case):
    """float32, atol 1e-5: the gather and the JAX matmul formulations blend
    the same four corners with the same weights and differ only in float32
    summation order."""
    rng = np.random.RandomState(3)
    B, H, W, C, N, crop = 2, 9, 13, 16, 6, (5, 5)
    feats = rng.randn(B, H, W, C).astype(np.float32)
    lo, span = (0.5, (0.5, 4.0)) if case == "inner" else (-3.0, (1.0, 8.0))
    boxes = _boxes_off_border(rng, B, N, H, W, lo, span, crop)
    ref = np.asarray(jax_roi_align(jnp.asarray(feats), jnp.asarray(boxes),
                                   crop, impl=impl))
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(boxes), crop)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas_interpret", "onehot"])
def test_roi_align_edge_boxes_match_jax(impl):
    """Border, outside and zero-area boxes, atol 1e-5 (float32 order only);
    the fully-outside box is exactly 0, and so is the off-map sample row."""
    rng = np.random.RandomState(4)
    H, W, C = 8, 10, 8
    feats = rng.randn(1, H, W, C).astype(np.float32)
    boxes = _edge_boxes(H, W)
    ref = np.asarray(jax_roi_align(jnp.asarray(feats), jnp.asarray(boxes),
                                   (5, 5), impl=impl))
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(boxes),
                    (5, 5)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.all(got[0, 3] == 0.0)
    assert np.all(got[0, 0, 0] == 0.0) and np.any(got[0, 0, 1] != 0.0)
    # samples exactly on the last row and column are in range
    np.testing.assert_allclose(got[0, 1, 4, 4], feats[0, H - 1, W - 1],
                               rtol=0, atol=1e-6)


def test_roi_align_bf16_matches_jax():
    """bf16 features in [-1, 1], atol 1e-2: the port blends in float32 and
    rounds once; the JAX kernel rounds its interpolation weights to bf16
    before a bf16 matmul.  At |value| <= 1 a bf16 ulp is at most 2**-8, so
    the two differ by a few ulps, under 1e-2 (at |value| near 4 the same
    few ulps reach 0.016: the bound is relative to the features' scale)."""
    rng = np.random.RandomState(5)
    B, H, W, C, N, crop = 2, 9, 13, 16, 5, (5, 5)
    feats = jnp.asarray(rng.uniform(-1, 1, (B, H, W, C)), jnp.bfloat16)
    boxes = _boxes_off_border(rng, B, N, H, W, -2.0, (0.5, 6.0), crop)
    ref = jax_roi_align(feats, jnp.asarray(boxes), crop,
                        impl="pallas_interpret")
    tf = torch.from_numpy(np.array(feats.astype(jnp.float32))).bfloat16()
    got = roi_align(tf, torch.from_numpy(boxes), crop)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=1e-2)


def test_prep_images_matches_jax():
    """(x/255 - 0.5)*2 in float32: the same three float32 operations."""
    from din_tpu.ops.image import prep_images as jax_prep

    x = np.random.RandomState(6).randint(0, 256, (2, 4, 5, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(prep_images(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_prep(jnp.asarray(x))))


@pytest.mark.parametrize("op", ["pool", "roi_align"])
def test_wrappers_refuse_non_cpu_non_cuda_tensors(op):
    """A wrapper runs the plain version only for a CPU tensor; any other
    device must launch the kernel or raise, never fall back."""
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        if op == "pool":
            max_pool_2x2(x)
        else:
            roi_align(x, torch.empty((1, 2, 4), device="meta"))
    assert max_pool_2x2.launches == 0 and roi_align.launches == 0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc the build fails with a clear error instead of loading a
    stale or missing library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build()
    assert native.library_path().parent == tmp_path
    assert native.library_path().name.startswith("libdin_kernels-")


def _pool_input(kind, shape, dtype, rng):
    if kind == "ties":       # integers 0..3: most windows hold a tie
        x = rng.randint(0, 4, shape).astype(np.float32)
    else:
        x = rng.randn(*shape).astype(np.float32)
    return np.array(jnp.asarray(x, dtype=dtype).astype(jnp.float32))


@pytest.mark.parametrize("kind", ["randn", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_bwd_matches_pallas_fold_pool_vjp(kind, dtype):
    """max_pool_2x2_bwd_ref, and the gradient of max_pool_2x2 through its
    autograd Function, equal the VJP of the JAX fold pool (Pallas backward
    kernel in interpret mode) on x viewed as [F,H,W/2,2C], bit for bit:
    both route each window's gradient to its first row-major argmax."""
    rng = np.random.RandomState(20)
    F_, H, W, C = 2, 8, 12, 16
    x = _pool_input(kind, (F_, H, W, C), dtype, rng)
    g = _pool_input("randn", (F_, H // 2, W // 2, C), dtype, rng)
    jx = jnp.asarray(x, dtype=dtype)
    _, vjp = jax.vjp(lambda a: fold_pool_2x2(
        a.reshape(F_, H, W // 2, 2 * C), impl="pallas_interpret"), jx)
    (ref,) = vjp(jnp.asarray(g, dtype=dtype))
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    got = max_pool_2x2_bwd(tx, tg)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_to_np(got), ref)
    tx.requires_grad_(True)
    max_pool_2x2(tx).backward(tg)
    np.testing.assert_array_equal(_to_np(tx.grad), ref)
    if kind == "ties":
        # autograd of amax would split these ties: the routing matters here
        assert (ref != 0).sum() == g.size


@pytest.mark.parametrize("shape", [(2, 9, 10, 8), (1, 6, 7, 4), (3, 5, 5, 3),
                                   (1, 3, 2, 4)])
@pytest.mark.parametrize("kind", ["randn", "ties"])
def test_max_pool_bwd_floor_mode_matches_torch_max_pool2d(shape, kind):
    """Odd H and/or W: the dropped row/column gets 0 and the rest equals the
    gradient of torch's own F.max_pool2d on the CPU (first argmax), exactly."""
    rng = np.random.RandomState(21)
    x = torch.from_numpy(_pool_input(kind, shape, "float32", rng))
    F_, H, W, C = shape
    g = torch.from_numpy(rng.randn(F_, H // 2, W // 2, C).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    y = F.max_pool2d(xr.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    y.backward(g)
    np.testing.assert_array_equal(max_pool_2x2_bwd_ref(x, g).numpy(),
                                  xr.grad.numpy())


@pytest.mark.parametrize("impl", ["onehot", "gather"])
@pytest.mark.parametrize("case", ["inner", "partly_outside", "edge"])
def test_roi_align_bwd_matches_jax_vjp(impl, case):
    """roi_align_bwd_ref, and the features' gradient through roi_align's
    autograd Function, against jax.vjp of the JAX RoIAlign: float32, atol
    1e-5 (the same corner weights, summed in another order); boxes get no
    gradient."""
    rng = np.random.RandomState(22)
    if case == "edge":
        B, H, W, C = 1, 8, 10, 8
        boxes = _edge_boxes(H, W)
    else:
        B, H, W, C = 2, 9, 13, 16
        lo, span = (0.5, (0.5, 4.0)) if case == "inner" else (-3.0,
                                                              (1.0, 8.0))
        boxes = _boxes_off_border(rng, B, 6, H, W, lo, span, (5, 5))
    feats = rng.randn(B, H, W, C).astype(np.float32)
    g = rng.randn(B, boxes.shape[1], 5, 5, C).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jax_roi_align(f, jnp.asarray(boxes), (5, 5),
                                             impl=impl), jnp.asarray(feats))
    (ref,) = vjp(jnp.asarray(g))
    ref = np.asarray(ref)
    tb, tg = torch.from_numpy(boxes), torch.from_numpy(g)
    got = roi_align_bwd_ref(tg, tb, (H, W), torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    tf = torch.from_numpy(feats).requires_grad_(True)
    tb.requires_grad_(True)
    roi_align(tf, tb, (5, 5)).backward(tg)
    np.testing.assert_allclose(tf.grad.numpy(), ref, rtol=0, atol=1e-5)
    assert tb.grad is None
    assert torch.equal(roi_align_bwd(tg, tb, (H, W), torch.float32), got)


def test_roi_align_bwd_casts_to_the_features_dtype():
    """A bf16 gradient is accumulated in f32 and cast once at the end, as
    JAX's _pallas_bwd does: equal to the f32 result rounded to bf16."""
    rng = np.random.RandomState(23)
    boxes = torch.from_numpy(_edge_boxes(8, 10))
    g = torch.from_numpy(rng.randn(1, 4, 5, 5, 8).astype(np.float32))
    g16 = g.bfloat16()
    got = roi_align_bwd_ref(g16, boxes, (8, 10), torch.bfloat16)
    f32 = roi_align_bwd_ref(g16.float(), boxes, (8, 10), torch.float32)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.bfloat16())


@pytest.mark.parametrize("op", ["pool_bwd", "roi_align_bwd"])
def test_backward_wrappers_refuse_non_cpu_non_cuda_tensors(op):
    """The backward wrappers, like the forward ones, run the plain version
    only for a CPU tensor and never fall back."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        if op == "pool_bwd":
            max_pool_2x2_bwd(torch.empty((1, 4, 4, 8), device="meta"),
                             torch.empty((1, 2, 2, 8), device="meta"))
        else:
            roi_align_bwd(torch.empty((1, 2, 5, 5, 8), device="meta"),
                          torch.empty((1, 2, 4), device="meta"), (4, 4),
                          torch.float32)
    assert max_pool_2x2_bwd.launches == 0 and roi_align_bwd.launches == 0
