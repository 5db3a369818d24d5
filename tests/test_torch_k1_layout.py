"""Kernel K1 (din_tpu_torch/csrc/roi_align.cu), emulated in numpy float32,
against its plain version ``roi_align_ref`` on the CPU.

The kernel runs one thread per (frame, box, sample, 16-byte channel
vector): 8 channels a thread in bf16, 4 in f32.  Thread t of the flat grid
takes sample s = t // V and vector v = t % V (V = ceil(C / vector)), the
sample s the frame and box s // (KH*KW) and the crop cell i, j of
s % (KH*KW).  Where C is a multiple of the vector and both the features'
and the output's pointers are 16-byte aligned, a thread loads its vector of
the four corner rows whole and stores its vector whole; else it covers the
same channels one by one (the scalar tail), with the same arithmetic.  The
emulation below walks that map, records every output element each thread
writes, and computes each value as the kernel does (the sample centres of
csrc/roi_grid.cuh op by op, the blend's products and sums each rounded once,
numpy's float32 operations never fuse).  Every output element must be
written by exactly one thread, and the result must equal ``roi_align_ref``
bit for bit in float32 and bfloat16, which is what ``chip_smoke.py`` then
shows for the kernel itself on the card.
"""

import numpy as np
import pytest
import torch

from chip_smoke import edge_boxes
from din_tpu_torch.ops.roi_align import roi_align_ref
from test_torch_roi_bwd_order import _axis, _centres

f32 = np.float32


def thread_map(B, N, crop, C, vector):
    """Per thread t of the flat grid: (frame b, box n, cell i, j, first
    channel c0), each [B*N*KH*KW*V]."""
    KH, KW = crop
    V = -(-C // vector)
    t = np.arange(B * N * KH * KW * V)
    s, v = np.divmod(t, V)
    bn, ij = np.divmod(s, KH * KW)
    i, j = np.divmod(ij, KW)
    b, n = np.divmod(bn, N)
    return b, n, i, j, v * vector, s


def kernel_emulation(features, boxes, crop, feat_offset=0, out_offset=0):
    """``roi_align``'s output [B,N,KH,KW,C] float32 (before the cast to the
    features' dtype) and the number of writes of each element, as the
    kernel's threads produce them; ``*_offset`` are the pointers' byte
    offsets from a 16-byte boundary."""
    B, H, W, C = features.shape
    N = boxes.shape[1]
    KH, KW = crop
    item = features.element_size()
    vector = 16 // item
    whole = C % vector == 0 and (feat_offset | out_offset) % 16 == 0
    feat = features.float().numpy().reshape(-1)
    bx = boxes.numpy().astype(f32)
    ok_y, y0, y1, wy0, wy1 = _axis(_centres(bx[..., 1], bx[..., 3], KH), H)
    ok_x, x0, x1, wx0, wx1 = _axis(_centres(bx[..., 0], bx[..., 2], KW), W)
    b, n, i, j, c0, s = thread_map(B, N, crop, C, vector)
    ok = ok_y[b, n, i] & ok_x[b, n, j]
    w00 = wy0[b, n, i] * wx0[b, n, j]
    w01 = wy0[b, n, i] * wx1[b, n, j]
    w10 = wy1[b, n, i] * wx0[b, n, j]
    w11 = wy1[b, n, i] * wx1[b, n, j]

    def row(yy, xx):
        return ((b * H + yy[b, n, i]) * W + xx[b, n, j]) * C

    rows = [row(y0, x0), row(y0, x1), row(y1, x0), row(y1, x1)]
    out = np.full(B * N * KH * KW * C, np.nan, f32)
    writes = np.zeros(out.shape, np.int64)
    for e in range(vector):
        c = c0 + e
        # a whole vector never runs past C; the scalar tail stops at C
        live = c < C
        assert whole <= live.all()
        o = s[live] * C + c[live]
        r = [x[live] + c[live] for x in rows]
        val = feat[r[0]] * w00[live]
        val = val + feat[r[1]] * w01[live]
        val = val + feat[r[2]] * w10[live]
        val = val + feat[r[3]] * w11[live]
        out[o] = np.where(ok[live], val, f32(0))
        np.add.at(writes, o, 1)
    return out.reshape(B, N, KH, KW, C), writes.reshape(B, N, KH, KW, C), \
        whole


def _inputs(B, N, H, W, C, seed):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((B, H, W, C), generator=g)
    boxes = edge_boxes(B, N, H, W, g)
    return feats, boxes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [100, 256, 288, 512, 2048])
@pytest.mark.parametrize("crop", [(5, 5), (7, 7)])
def test_every_output_once_and_equal_to_the_plain_version(dtype, C, crop):
    feats, boxes = _inputs(2, 5, 7, 9, C, seed=C + crop[0])
    feats = feats.to(dtype)
    got, writes, whole = kernel_emulation(feats, boxes, crop)
    assert (writes == 1).all()
    assert whole == (C % (16 // feats.element_size()) == 0)
    want = roi_align_ref(feats, boxes, crop)
    got = torch.from_numpy(got).to(dtype)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
    # the fully outside box (index 3 of edge_boxes) is 0 as a whole
    assert not got[:, 3].any()


@pytest.mark.parametrize("dtype,feat_offset,out_offset", [
    (torch.float32, 4, 0), (torch.float32, 0, 8), (torch.bfloat16, 2, 0),
    (torch.bfloat16, 0, 2), (torch.bfloat16, 6, 6)])
def test_unaligned_pointers_take_the_scalar_tail(dtype, feat_offset,
                                                 out_offset):
    """A feature map that starts past a 16-byte boundary (a view into a
    larger buffer), or an output that does: every thread covers its
    channels one by one, and the result is the same."""
    item = torch.tensor([], dtype=dtype).element_size()
    feats, boxes = _inputs(2, 4, 6, 8, 512, seed=3)
    buf = torch.zeros(feats.numel() + 16, dtype=dtype)
    k = feat_offset // item
    view = buf[k:k + feats.numel()].view(feats.shape)
    view.copy_(feats.to(dtype))
    got, writes, whole = kernel_emulation(view, boxes, (5, 5),
                                          feat_offset, out_offset)
    assert not whole and (writes == 1).all()
    want = roi_align_ref(view, boxes, (5, 5))
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(torch.from_numpy(got).to(dtype).view(bits),
                       want.view(bits))


def test_flagship_grid_is_spread_over_the_card():
    """At the flagship (20 frames, 12 boxes, 5x5, C=512 bf16) the grid has
    6000 samples x 64 vectors: 1500 blocks of 256 threads, over 11 per SM
    of the H100's 132, where the previous design had one block per box."""
    b, *_ = thread_map(20, 12, (5, 5), 512, 8)
    assert b.size == 6000 * 64 and b.size // 256 == 1500
