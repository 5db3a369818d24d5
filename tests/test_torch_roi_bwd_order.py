"""Kernel K1b (din_tpu_torch/csrc/roi_align_bwd.cu), emulated in numpy
float32, against its plain version ``roi_align_bwd_ref`` on the CPU, and
what its wrapper runs around the launch.

The kernel gives every output element to one thread, which adds that
element's contributions in the plain version's order: corner 00 of every
sample in (box, i, j) order, then corners 01, 10 and 11, each product and
sum rounded once, and rounds once to the output's dtype.  A block covers a
band of rows and walks the frame's contributions in that order, keeping the
ones whose corner row lies in its band (it then sorts them stably by pixel,
which leaves each pixel's order as it was).  The emulation below does the same
arithmetic (numpy's float32 operations round once each and never fuse, and
the sample centres follow csrc/roi_grid.cuh op by op) band by band; it must
equal ``roi_align_bwd_ref`` bit for bit, in float32 and after the cast to
bfloat16, which is what ``chip_smoke.py`` then shows for the kernel itself
on the card.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chip_smoke import edge_boxes
from din_tpu_torch.ops import native
from din_tpu_torch.ops.roi_align import roi_align_bwd, roi_align_bwd_ref

f32 = np.float32


def _centres(lo, hi, k):
    """csrc/roi_grid.cuh din_roi_sample_centre for i = 0..k-1, op by op."""
    bin_ = (hi - lo) / f32(k)
    i = np.arange(k, dtype=f32)
    return (lo[..., None] + (i + f32(0.5)) * bin_[..., None]) - f32(0.5)


def _axis(c, limit):
    """csrc/roi_grid.cuh din_roi_axis: in-range test, clamp, corners and
    lerp weights."""
    cmax = f32(limit - 1)
    ok = (c >= f32(0)) & (c <= cmax)
    cc = np.minimum(np.maximum(c, f32(0)), cmax)
    lo, hi = np.floor(cc), np.ceil(cc)
    w_hi = cc - lo
    return ok, lo.astype(np.int64), hi.astype(np.int64), f32(1) - w_hi, w_hi


def _contributions(boxes, crop, H, W):
    """Per frame, the kernel's contributions q = k * S + s in its order:
    (ok, corner row, corner column, sample s, weight), each [B, 4 * S]."""
    KH, KW = crop
    B, N, _ = boxes.shape
    ok_y, y0, y1, wy0, wy1 = _axis(
        _centres(boxes[..., 1], boxes[..., 3], KH), H)       # [B,N,KH]
    ok_x, x0, x1, wx0, wx1 = _axis(
        _centres(boxes[..., 0], boxes[..., 2], KW), W)       # [B,N,KW]
    ok = (ok_y[..., :, None] & ok_x[..., None, :]).reshape(B, -1)
    s = np.broadcast_to(np.arange(N * KH * KW), ok.shape)
    rows, cols, ws = [], [], []
    for yy, wy in ((y0, wy0), (y1, wy1)):
        for xx, wx in ((x0, wx0), (x1, wx1)):
            rows.append(np.broadcast_to(yy[..., :, None],
                                        (B, N, KH, KW)).reshape(B, -1))
            cols.append(np.broadcast_to(xx[..., None, :],
                                        (B, N, KH, KW)).reshape(B, -1))
            ws.append((wy[..., :, None] * wx[..., None, :]).reshape(B, -1))
    cat = lambda parts: np.concatenate(parts, axis=1)
    return (np.tile(ok, 4), cat(rows), cat(cols), np.tile(s, 4), cat(ws))


def kernel_emulation(g, boxes, feature_hw, band_rows):
    """d(features) [B,H,W,C] float32 as the kernel computes it, band by
    band: each band's sums start at 0 and take the contributions whose
    corner row lies in the band, in the frame's contribution order."""
    B, N, KH, KW, C = g.shape
    H, W = feature_hw
    ok, rows, cols, s, w = _contributions(boxes, (KH, KW), H, W)
    gs = g.reshape(B, N * KH * KW, C)
    df = np.empty((B, H, W, C), f32)
    for b in range(B):
        for r0 in range(0, H, band_rows):
            acc = np.zeros((band_rows, W, C), f32)
            for q in np.flatnonzero(ok[b] & (rows[b] >= r0)
                                    & (rows[b] < r0 + band_rows)):
                a = acc[rows[b, q] - r0, cols[b, q]]
                a[...] = a + gs[b, s[b, q]] * w[b, q]
            df[b, r0:r0 + band_rows] = acc[:H - r0]
    return df


def _boxes(kind):
    if kind == "edge":
        return edge_boxes(20, 12, 22, 40,
                          torch.Generator().manual_seed(0)).numpy()
    rng = np.random.RandomState(11)
    lo, span = ((0.0, (1.0, 8.0)) if kind == "random"
                else (-6.0, (2.0, 12.0)))
    xy = rng.uniform(lo, 40 - lo, size=(6, 10, 2))
    wh = rng.uniform(*span, size=(6, 10, 2))
    xy[..., 1] *= 22 / 40                          # rows span the map's H
    return np.concatenate([xy, xy + wh], -1).astype(f32)


def _bits(t):
    return np.ascontiguousarray(t, np.float32).view(np.uint32)


@pytest.mark.parametrize("crop", [(5, 5), (3, 4)])
@pytest.mark.parametrize("kind", ["random", "partly_outside", "edge"])
def test_kernel_order_equals_plain_version_bit_for_bit(kind, crop):
    """Random boxes, boxes partly outside the map and chip_smoke's edge
    boxes (on the border, partly and fully outside, zero-area), on a 22x40
    map: the kernel's loop, in bands of 1 and of 3 rows, equals
    ``roi_align_bwd_ref`` bit for bit in float32, and after the cast to
    bfloat16 for a bfloat16 gradient."""
    boxes = _boxes(kind)
    B, N = boxes.shape[:2]
    H, W, C = 22, 40, 8
    rng = np.random.RandomState(5)
    g = rng.randn(B, N, *crop, C).astype(f32)
    tb = torch.from_numpy(boxes)
    ref = roi_align_bwd_ref(torch.from_numpy(g), tb, (H, W), torch.float32)
    for band_rows in (1, 3):
        emu = kernel_emulation(g, boxes, (H, W), band_rows)
        assert np.array_equal(_bits(emu), _bits(ref.numpy()))
    g16 = torch.from_numpy(g).bfloat16()
    ref16 = roi_align_bwd_ref(g16, tb, (H, W), torch.bfloat16)
    emu16 = torch.from_numpy(kernel_emulation(g16.float().numpy(), boxes,
                                              (H, W), 1)).bfloat16()
    assert torch.equal(emu16.view(torch.int16), ref16.view(torch.int16))
    assert (ref != 0).any()


def test_another_order_would_differ():
    """The order is not free: adding each sample's four corners together
    (sample-major instead of corner-major) gives other float32 bits for
    some elements of the edge boxes' gradient, so the bit-equality above
    pins the kernel's order."""
    boxes = _boxes("edge")
    B, N = boxes.shape[:2]
    H, W, C = 22, 40, 8
    g = np.random.RandomState(5).randn(B, N, 5, 5, C).astype(f32)
    ok, rows, cols, s, w = _contributions(boxes, (5, 5), H, W)
    S = N * 25
    sample_major = np.argsort(s[0] * 4 + np.arange(4 * S) // S, kind="stable")
    gs = g.reshape(B, S, C)
    other = np.zeros((B, H, W, C), f32)
    for b in range(B):
        for q in sample_major:
            if ok[b, q]:
                a = other[b, rows[b, q], cols[b, q]]
                a[...] = a + gs[b, s[b, q]] * w[b, q]
    ref = roi_align_bwd_ref(torch.from_numpy(g), torch.from_numpy(boxes),
                            (H, W), torch.float32).numpy()
    np.testing.assert_allclose(other, ref, rtol=0, atol=1e-5)
    assert (_bits(other) != _bits(ref)).any()


class _Ops(TorchDispatchMode):
    """Records every ATen operation run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_wrapper_refuses_before_any_torch_work():
    """A tensor that is neither on the CPU nor on the card is refused
    before the wrapper runs a single torch operation."""
    g = torch.empty((1, 2, 5, 5, 8), device="meta")
    boxes = torch.empty((1, 2, 4), device="meta")
    with _Ops() as rec, pytest.raises(ValueError, match="CUDA tensor"):
        roi_align_bwd(g, boxes, (4, 4), torch.float32)
    assert rec.ops == []


@pytest.mark.parametrize("layout", ["contiguous", "channel_major"])
def test_cuda_path_allocates_the_output_and_launches(monkeypatch, layout):
    """The wrapper's CUDA path, driven with meta tensors standing in for
    card tensors and the library replaced by a recorder: it runs one
    ``torch.empty`` of the output in the requested dtype and the launch,
    and nothing else (no sample grid, no zeroed scratch map, no cast).  A
    channel-major g, as the trunk's flatten hands it over, costs one copy
    more, counted in ``g_copies``.  The kernel writes g's dtype; another
    output dtype raises."""
    calls = []

    class Lib:
        def din_roi_align_bwd(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(native, "require_cuda_input",
                        lambda *args, **kwargs: None)
    monkeypatch.setattr(native, "library", lambda: Lib())
    monkeypatch.setattr(native, "current_stream", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(roi_align_bwd, "launches", 0)
    monkeypatch.setattr(roi_align_bwd, "g_copies", 0)
    B, N, K, C, H, W = 2, 3, 5, 16, 6, 7
    if layout == "contiguous":
        g = torch.empty((B, N, K, K, C), dtype=torch.bfloat16, device="meta")
    else:
        g = torch.empty((B, N, C, K, K), dtype=torch.bfloat16,
                        device="meta").permute(0, 1, 3, 4, 2)
    boxes = torch.empty((B, N, 4), device="meta")
    with _Ops() as rec:
        df = roi_align_bwd(g, boxes, (H, W), torch.bfloat16)
    copies = [] if layout == "contiguous" else ["aten.clone.default"]
    assert rec.ops == copies + ["aten.empty.memory_format"]
    assert df.shape == (B, H, W, C) and df.dtype == torch.bfloat16
    assert len(calls) == 1
    assert calls[0][3:] == (B, H, W, C, N, K, K, native.DTYPE_BF16, 7)
    assert roi_align_bwd.launches == 1
    assert roi_align_bwd.g_copies == len(copies)
    with pytest.raises(TypeError, match="dtype"):
        roi_align_bwd(g, boxes, (H, W), torch.float32)
