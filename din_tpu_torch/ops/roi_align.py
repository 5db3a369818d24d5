"""RoIAlign (TF ``crop_and_resize`` with ``transform_fpcoor``): kernels K1
(forward) and K1b (backward), their plain versions, and the autograd
Function around them.

Port of din_tpu/ops/roi_align.py.  Semantics: boxes are
(x1, y1, x2, y2) in feature-map pixels; the KH x KW samples land on bin
centres, y(i) = y1 + (i + 0.5) * (y2 - y1) / KH - 0.5 (likewise x); each
sample is the bilinear blend of its floor/ceil corners of the clamped
coordinate, and a sample whose centre lies outside [0, H-1] x [0, W-1] is 0
as a whole.

The JAX package's Pallas kernel (``_roi_align_pallas_kernel``) built a
one-hot interpolation matrix for the TPU's matrix unit; on the card the op
is a gather, so the kernel (csrc/roi_align.cu) and the plain version
``roi_align_ref`` both read the four corner rows directly.  The plain
version takes its sample centres from ``_sample_grid`` below; the kernel
computes the same centres from the boxes itself, in ``_sample_grid``'s order
with each op rounded once, so the two agree on which samples are in range
even at the map border (tests/test_torch_roi_grid.py pins that order), and
it rounds its blend op by op in the plain version's order, so the two agree
bit for bit.  K1b (csrc/roi_align_bwd.cu) still takes the centres from
``_sample_grid``.

The gradient flows to the features only: boxes are constants, as in the
JAX package (``stop_gradient``, roi_align.py:348) and the reference.  It is
the transpose of the blend: each in-range sample adds w*g to its four
corner rows of an f32 map, cast to the features' dtype at the end, as
``_pallas_bwd`` (roi_align.py:302-309) computes it with einsums.  JAX has no
Pallas kernel for it; the port's K1b (csrc/roi_align_bwd.cu) scatters with
atomics, and ``roi_align_bwd_ref`` with ``index_add_``.

``roi_align`` and ``roi_align_bwd`` on CPU tensors run the plain versions;
on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from din_tpu_torch.ops import native

_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def _sample_grid(boxes: torch.Tensor, crop_size: Tuple[int, int]):
    """boxes [..., 4] (x1, y1, x2, y2) f32 -> sample centres
    (ys [..., KH], xs [..., KW]) (din_tpu/ops/roi_align.py:45-60)."""
    KH, KW = crop_size
    x1, y1, x2, y2 = boxes.unbind(-1)
    # true divisions on every device, as the kernel's __fdiv_rn: CUDA divides
    # by a Python number as a product with its f32 reciprocal, which differs
    # in the last bit for some boxes (CPU results are the same either way)
    kh, kw = (torch.full((), k, dtype=boxes.dtype, device=boxes.device)
              for k in (KH, KW))
    bin_h = (y2 - y1) / kh
    bin_w = (x2 - x1) / kw
    iy = torch.arange(KH, dtype=boxes.dtype, device=boxes.device)
    ix = torch.arange(KW, dtype=boxes.dtype, device=boxes.device)
    ys = y1[..., None] + (iy + 0.5) * bin_h[..., None] - 0.5
    xs = x1[..., None] + (ix + 0.5) * bin_w[..., None] - 0.5
    return ys, xs


def _corner_weights(coord: torch.Tensor, limit: int):
    """floor/ceil corners, lerp weights and in-range mask of 1-D samples
    (din_tpu/ops/roi_align.py:63-75); csrc/roi_align.cu does the same math
    per sample."""
    in_range = (coord >= 0.0) & (coord <= limit - 1)
    c = coord.clamp(0.0, limit - 1)
    lo = torch.floor(c)
    hi = torch.ceil(c)
    w_hi = c - lo
    w_lo = 1.0 - w_hi
    return lo.long(), hi.long(), w_lo, w_hi, in_range


def roi_align_ref(features: torch.Tensor, boxes: torch.Tensor,
                  crop_size: Tuple[int, int] = (5, 5)) -> torch.Tensor:
    """Plain version: gather formulation like the JAX package's
    ``_roi_align_gather`` (roi_align.py:78-110), blended in f32.
    features [B,H,W,C], boxes [B,N,4] -> [B,N,KH,KW,C]."""
    B, H, W, C = features.shape
    N = boxes.shape[1]
    KH, KW = crop_size
    ys, xs = _sample_grid(boxes.float(), crop_size)          # [B,N,KH|KW]
    y0, y1, wy0, wy1, ok_y = _corner_weights(ys, H)
    x0, x1, wx0, wx1, ok_x = _corner_weights(xs, W)
    flat = features.reshape(B, H * W, C).float()

    def take(yy, xx):
        idx = (yy[:, :, :, None] * W + xx[:, :, None, :]).reshape(B, -1)
        out = torch.gather(flat, 1, idx[:, :, None].expand(-1, -1, C))
        return out.reshape(B, N, KH, KW, C)

    def w(wy, wx):
        return (wy[:, :, :, None] * wx[:, :, None, :])[..., None]

    # summed left to right, each op rounded: csrc/roi_align.cu does the same
    out = (take(y0, x0) * w(wy0, wx0) + take(y0, x1) * w(wy0, wx1)
           + take(y1, x0) * w(wy1, wx0) + take(y1, x1) * w(wy1, wx1))
    valid = (ok_y[:, :, :, None] & ok_x[:, :, None, :])[..., None]
    out = torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))
    return out.to(features.dtype)


def roi_align_bwd_ref(g: torch.Tensor, boxes: torch.Tensor,
                      feature_hw: Tuple[int, int],
                      dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K1b: g [B,N,KH,KW,C], boxes [B,N,4] ->
    d(features) [B,H,W,C] in ``dtype``, accumulated in f32 with
    ``index_add_`` of the four weighted corners (coinciding corners each
    add their own weight; out-of-range samples add nothing)."""
    B, N, KH, KW, C = g.shape
    H, W = feature_hw
    ys, xs = _sample_grid(boxes.float(), (KH, KW))
    y0, y1, wy0, wy1, ok_y = _corner_weights(ys, H)
    x0, x1, wx0, wx1, ok_x = _corner_weights(xs, W)
    valid = (ok_y[:, :, :, None] & ok_x[:, :, None, :])[..., None]
    gf = g.float()
    zero = torch.zeros((), dtype=gf.dtype, device=gf.device)
    base = (torch.arange(B, device=g.device) * (H * W))[:, None, None, None]
    df = torch.zeros((B * H * W, C), dtype=torch.float32, device=g.device)
    # the corner order and the product w*g of csrc/roi_align_bwd.cu
    for yy, wy in ((y0, wy0), (y1, wy1)):
        for xx, wx in ((x0, wx0), (x1, wx1)):
            idx = base + yy[:, :, :, None] * W + xx[:, :, None, :]
            w = (wy[:, :, :, None] * wx[:, :, None, :])[..., None]
            df.index_add_(0, idx.reshape(-1),
                          torch.where(valid, gf * w, zero).reshape(-1, C))
    return df.reshape(B, H, W, C).to(dtype)


def _roi_align_fwd(features: torch.Tensor, boxes: torch.Tensor,
                   crop_size: Tuple[int, int]) -> torch.Tensor:
    if features.device.type == "cpu":
        return roi_align_ref(features, boxes, crop_size)
    B, H, W, C = features.shape
    KH, KW = crop_size
    N = boxes.shape[1]
    out = torch.empty((B, N, KH, KW, C), dtype=features.dtype,
                      device=features.device)
    # the kernel computes the sample centres from the boxes themselves
    boxes = boxes.float().contiguous()
    lib = native.library()
    with torch.cuda.device(features.device):
        code = lib.din_roi_align(
            features.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            B, H, W, C, N, KH, KW, native.dtype_code(features.dtype),
            native.current_stream(features))
    native.check(code, "roi_align")
    roi_align.launches += 1
    return out


def roi_align_bwd(g: torch.Tensor, boxes: torch.Tensor,
                  feature_hw: Tuple[int, int],
                  dtype: torch.dtype) -> torch.Tensor:
    """Gradient of ``roi_align`` with respect to the features: g
    [B,N,KH,KW,C] (f32 or bf16; made contiguous), boxes [B,N,4] -> [B,H,W,C]
    in ``dtype``.  Counts its kernel launches in ``roi_align_bwd.launches``.
    """
    if g.device.type == "cpu":
        return roi_align_bwd_ref(g, boxes, feature_hw, dtype)
    g = g.contiguous()
    native.require_cuda_input(g, "g", _FLOAT_TYPES, 5)
    _check_boxes(boxes, g.shape[0], g.device)
    B, N, KH, KW, C = g.shape
    H, W = feature_hw
    ys, xs = _sample_grid(boxes.float(), (KH, KW))
    ys, xs = ys.contiguous(), xs.contiguous()
    df = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    lib = native.library()
    with torch.cuda.device(g.device):
        code = lib.din_roi_align_bwd(
            g.data_ptr(), ys.data_ptr(), xs.data_ptr(), df.data_ptr(),
            B, H, W, C, N, KH, KW, native.dtype_code(g.dtype),
            native.current_stream(g))
    native.check(code, "roi_align_bwd")
    roi_align_bwd.launches += 1
    return df.to(dtype)


def _check_boxes(boxes: torch.Tensor, B: int, device) -> None:
    if boxes.dim() != 3 or boxes.shape[0] != B or boxes.shape[2] != 4:
        raise ValueError(f"boxes must be [{B},N,4], got {tuple(boxes.shape)}")
    if boxes.device != device:
        raise ValueError("boxes and features must be on the same device")


class _RoIAlign(torch.autograd.Function):
    """K1 forward, K1b backward; boxes get no gradient."""

    @staticmethod
    def forward(ctx, features, boxes, crop_size):
        ctx.save_for_backward(boxes)
        ctx.feature_hw = tuple(features.shape[1:3])
        ctx.dtype = features.dtype
        return _roi_align_fwd(features, boxes, crop_size)

    @staticmethod
    def backward(ctx, g):
        (boxes,) = ctx.saved_tensors
        return roi_align_bwd(g, boxes, ctx.feature_hw, ctx.dtype), None, None


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              crop_size: Tuple[int, int] = (5, 5)) -> torch.Tensor:
    """Crop-and-resize RoIAlign.

    features: [B,H,W,C] NHWC, f32 or bf16.  boxes: [B,N,4] (x1,y1,x2,y2) in
    feature pixels.  Returns [B,N,KH,KW,C] in the features' dtype,
    accumulated in f32; differentiable with respect to the features.
    Counts its forward kernel launches in ``roi_align.launches``.
    """
    if features.device.type != "cpu":
        native.require_cuda_input(features, "features", _FLOAT_TYPES, 4)
        _check_boxes(boxes, features.shape[0], features.device)
    boxes = boxes.detach()
    crop_size = tuple(crop_size)
    if torch.is_grad_enabled() and features.requires_grad:
        return _RoIAlign.apply(features, boxes, crop_size)
    return _roi_align_fwd(features, boxes, crop_size)


roi_align.launches = 0
roi_align_bwd.launches = 0
