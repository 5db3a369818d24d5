"""RoIAlign (TF ``crop_and_resize`` with ``transform_fpcoor``): kernel K1 and
its plain version.

Port of din_tpu/ops/roi_align.py, forward only.  Semantics: boxes are
(x1, y1, x2, y2) in feature-map pixels; the KH x KW samples land on bin
centres, y(i) = y1 + (i + 0.5) * (y2 - y1) / KH - 0.5 (likewise x); each
sample is the bilinear blend of its floor/ceil corners of the clamped
coordinate, and a sample whose centre lies outside [0, H-1] x [0, W-1] is 0
as a whole.

The JAX package's Pallas kernel (``_roi_align_pallas_kernel``) built a
one-hot interpolation matrix for the TPU's matrix unit; on the card the op
is a gather, so the kernel (csrc/roi_align.cu) and the plain version
``roi_align_ref`` both read the four corner rows directly.  Both take their
sample centres from the one ``_sample_grid`` below, computed in torch, so
they agree on which samples are in range even at the map border, and the
kernel rounds its blend op by op in the plain version's order, so the two
agree bit for bit.

``roi_align`` on CPU tensors runs ``roi_align_ref``; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from din_tpu_torch.ops import native


def _sample_grid(boxes: torch.Tensor, crop_size: Tuple[int, int]):
    """boxes [..., 4] (x1, y1, x2, y2) f32 -> sample centres
    (ys [..., KH], xs [..., KW]) (din_tpu/ops/roi_align.py:45-60)."""
    KH, KW = crop_size
    x1, y1, x2, y2 = boxes.unbind(-1)
    bin_h = (y2 - y1) / KH
    bin_w = (x2 - x1) / KW
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


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              crop_size: Tuple[int, int] = (5, 5)) -> torch.Tensor:
    """Crop-and-resize RoIAlign.

    features: [B,H,W,C] NHWC, f32 or bf16.  boxes: [B,N,4] (x1,y1,x2,y2) in
    feature pixels.  Returns [B,N,KH,KW,C] in the features' dtype,
    accumulated in f32.  Counts its kernel launches in ``roi_align.launches``.
    """
    if features.device.type == "cpu":
        return roi_align_ref(features, boxes, crop_size)
    native.require_cuda_input(features, "features",
                              (torch.float32, torch.bfloat16), 4)
    B, H, W, C = features.shape
    if boxes.dim() != 3 or boxes.shape[0] != B or boxes.shape[2] != 4:
        raise ValueError(f"boxes must be [{B},N,4], got {tuple(boxes.shape)}")
    if boxes.device != features.device:
        raise ValueError("boxes and features must be on the same device")
    KH, KW = crop_size
    N = boxes.shape[1]
    ys, xs = _sample_grid(boxes.float(), crop_size)
    ys, xs = ys.contiguous(), xs.contiguous()
    out = torch.empty((B, N, KH, KW, C), dtype=features.dtype,
                      device=features.device)
    lib = native.library()
    with torch.cuda.device(features.device):
        code = lib.din_roi_align(
            features.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
            B, H, W, C, N, KH, KW, native.dtype_code(features.dtype),
            native.current_stream(features))
    native.check(code, "roi_align")
    roi_align.launches += 1
    return out


roi_align.launches = 0
