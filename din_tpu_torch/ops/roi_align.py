"""RoIAlign (TF ``crop_and_resize`` with ``transform_fpcoor``): kernels K1
(forward) and K1b (backward), their plain versions, and the custom ops
``din_tpu_torch::roi_align`` and ``din_tpu_torch::roi_align_bwd`` around
them.

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
version takes its sample centres from ``_sample_grid`` below; both kernels
compute the same centres from the boxes themselves (csrc/roi_grid.cuh), in
``_sample_grid``'s order with each op rounded once, so kernels and plain
versions agree on which samples are in range even at the map border
(tests/test_torch_roi_grid.py pins that order), and K1 rounds its blend op
by op in the plain version's order, so the two agree bit for bit.

The gradient flows to the features only: boxes are constants, as in the
JAX package (``stop_gradient``, roi_align.py:348) and the reference.  It is
the transpose of the blend: each in-range sample adds w*g to its four
corner rows of an f32 map, cast to the features' dtype at the end, as
``_pallas_bwd`` (roi_align.py:302-309) computes it with einsums.  JAX has no
Pallas kernel for it.  ``roi_align_bwd_ref`` adds with ``index_add_``:
corner 00 of every sample in (frame, box, i, j) order, then 01, 10, 11.
The port's K1b (csrc/roi_align_bwd.cu) gathers instead: each output element
is owned by one thread, which adds its contributions in that same order and
writes the result once in the output's dtype, so it is deterministic and
equals the plain version run on the CPU bit for bit
(tests/test_torch_roi_bwd_order.py emulates its loop).

Each kernel is a ``torch.library`` custom op, so that ``torch.export``
records it as one node (``experiments/export_serving.py``): its CUDA
implementation is the launcher (``_roi_align_fwd``, ``roi_align_bwd``), its
CPU implementation the plain version, and no other device is registered;
the fake implementation gives the output's shape, dtype and (contiguous)
strides.  The forward op's registered autograd saves the boxes, the
feature size and the dtype, and its backward is the K1b op.  Only a
launcher counts (``roi_align.launches``, ``roi_align_bwd.launches``), so a
trace counts nothing.  ``roi_align`` on a CPU tensor runs the plain
version; on a CUDA tensor it launches the kernel or raises; any other
device raises.  ``roi_align_bwd`` called directly does the same.

``roi_align_multiscale`` (din_tpu/ops/roi_align.py:149-189) pools boxes of
an (OH, OW) map from backbone maps of other sizes (Inception-v3's two
scales) without resizing them: a map of size (OH, OW) goes through
``roi_align`` (K1, K1b), every other one through the align-corners resize
rows composed into the crop's interpolation rows (``_interp_rows``) and two
batched products, which din_tpu computes with einsums outside any Pallas
kernel; autograd differentiates them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from din_tpu_torch.ops import native
from din_tpu_torch.ops.image import interp_matrix_align_corners

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
                   crop_size: Sequence[int]) -> torch.Tensor:
    """K1's launcher, the CUDA implementation of the op."""
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
    [B,N,KH,KW,C] (f32 or bf16), boxes [B,N,4] -> [B,H,W,C] in ``dtype``
    (on the card g's dtype, as the forward op's autograd passes it).  K1b's
    launcher, the CUDA implementation of ``din_tpu_torch::roi_align_bwd``;
    called directly, a CPU g runs the plain version.  A CUDA g that is not
    contiguous (the trunk's channel-major flatten hands one over) is copied
    first, counted in ``roi_align_bwd.g_copies``.  Counts its kernel
    launches in ``roi_align_bwd.launches``."""
    if g.device.type == "cpu":
        return roi_align_bwd_ref(g, boxes, feature_hw, dtype)
    native.require_cuda_input(g, "g", _FLOAT_TYPES, 5, contiguous=False)
    _check_boxes(boxes, g.shape[0], g.device)
    if boxes.shape[1] != g.shape[1]:
        raise ValueError(f"boxes {tuple(boxes.shape)} and g "
                         f"{tuple(g.shape)} differ in N")
    if dtype != g.dtype:
        raise TypeError(f"the kernel writes g's dtype {g.dtype}, asked for "
                        f"{dtype}")
    if not g.is_contiguous():
        g = g.contiguous()
        roi_align_bwd.g_copies += 1
    B, N, KH, KW, C = g.shape
    H, W = feature_hw
    # the kernel computes the sample centres and writes every element
    df = torch.empty((B, H, W, C), dtype=dtype, device=g.device)
    boxes = boxes.float().contiguous()
    lib = native.library()
    with torch.cuda.device(g.device):
        code = lib.din_roi_align_bwd(
            g.data_ptr(), boxes.data_ptr(), df.data_ptr(), B, H, W, C, N, KH,
            KW, native.dtype_code(g.dtype), native.current_stream(g))
    native.check(code, "roi_align_bwd")
    roi_align_bwd.launches += 1
    return df


def _check_boxes(boxes: torch.Tensor, B: int, device) -> None:
    if boxes.dim() != 3 or boxes.shape[0] != B or boxes.shape[2] != 4:
        raise ValueError(f"boxes must be [{B},N,4], got {tuple(boxes.shape)}")
    if boxes.device != device:
        raise ValueError("boxes and features must be on the same device")


_roi_align_op = torch.library.custom_op(
    "din_tpu_torch::roi_align", _roi_align_fwd, mutates_args=(),
    device_types="cuda",
    schema="(Tensor features, Tensor boxes, int[] crop_size) -> Tensor")
_roi_align_op.register_kernel("cpu", roi_align_ref)
_roi_align_bwd_op = torch.library.custom_op(
    "din_tpu_torch::roi_align_bwd", roi_align_bwd, mutates_args=(),
    device_types="cuda",
    schema="(Tensor g, Tensor boxes, int[] feature_hw, ScalarType dtype) "
           "-> Tensor")
_roi_align_bwd_op.register_kernel("cpu", roi_align_bwd_ref)


@_roi_align_op.register_fake
def _(features, boxes, crop_size):
    B, _, _, C = features.shape
    return features.new_empty((B, boxes.shape[1], *crop_size, C))


@_roi_align_bwd_op.register_fake
def _(g, boxes, feature_hw, dtype):
    return g.new_empty((g.shape[0], *feature_hw, g.shape[-1]), dtype=dtype)


def _roi_align_setup(ctx, inputs, output):
    features, boxes, _ = inputs
    ctx.save_for_backward(boxes)
    ctx.feature_hw = list(features.shape[1:3])
    ctx.dtype = features.dtype


def _roi_align_backward(ctx, g):
    """K1b; boxes get no gradient."""
    (boxes,) = ctx.saved_tensors
    return (torch.ops.din_tpu_torch.roi_align_bwd(g, boxes, ctx.feature_hw,
                                                  ctx.dtype), None, None)


_roi_align_op.register_autograd(_roi_align_backward,
                                setup_context=_roi_align_setup)


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
    return torch.ops.din_tpu_torch.roi_align(features, boxes.detach(),
                                             list(crop_size))


roi_align.launches = 0
roi_align_bwd.launches = 0
roi_align_bwd.g_copies = 0


def _interp_rows(boxes: torch.Tensor, crop_size: Tuple[int, int], H: int,
                 W: int):
    """Per-axis interpolation rows of RoIAlign in float32
    (din_tpu/ops/roi_align.py:113-134): (My [B,N,KH,H], Mx [B,N,KW,W]) with
    the crop equal to ``einsum('bnhH,bnwW,bHWc->bnhwc', My, Mx,
    features)``; a sample out of range on an axis has a zero row there
    (``_corner_weights``'s rule, the kernels' too)."""
    ys, xs = _sample_grid(boxes, crop_size)

    def axis_matrix(coord, limit):
        lo, hi, w_lo, w_hi, ok = _corner_weights(coord, limit)
        grid = torch.arange(limit, device=coord.device)
        m = (lo[..., None] == grid) * w_lo[..., None] \
            + (hi[..., None] == grid) * w_hi[..., None]
        return m * ok[..., None]

    return axis_matrix(ys, H), axis_matrix(xs, W)


def roi_align_multiscale(feature_maps, boxes: torch.Tensor,
                         crop_size: Tuple[int, int],
                         out_size: Tuple[int, int]) -> torch.Tensor:
    """RoIAlign of ``boxes`` [B,N,4] (feature pixels of an (OH, OW) map)
    over the channel concatenation of every map of ``feature_maps`` (each
    [B,h,w,C_s]) resized to (OH, OW) with align corners, without resizing
    any: equal to ``roi_align(cat([resize(o, out_size) for o in maps]),
    boxes)``.  A map of size (OH, OW) goes through ``roi_align``; for any
    other the crop rows [KH, OH] and the resize rows [OH, h] are multiplied
    in float32 and cast to the map's dtype before two batched products with
    the map.  Returns [B,N,KH,KW,sum(C_s)] in the maps' dtype, in the order
    of ``feature_maps``."""
    OH, OW = out_size
    crop_size = tuple(crop_size)
    boxes = boxes.detach().float()
    my = mx = None
    parts = []
    for o in feature_maps:
        h, w = o.shape[1:3]
        if (h, w) == (OH, OW):
            parts.append(roi_align(o, boxes, crop_size))
            continue
        if my is None:
            my, mx = _interp_rows(boxes, crop_size, OH, OW)
        ry = interp_matrix_align_corners(h, OH, torch.float32, o.device)
        rx = interp_matrix_align_corners(w, OW, torch.float32, o.device)
        myc = torch.einsum("bnko,oh->bnkh", my, ry).to(o.dtype)
        mxc = torch.einsum("bnkp,pw->bnkw", mx, rx).to(o.dtype)
        t = torch.einsum("bnhH,bHWc->bnhWc", myc, o)
        parts.append(torch.einsum("bnwW,bnhWc->bnhwc", mxc, t).to(o.dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
