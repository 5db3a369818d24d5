"""The fused VGG-16 stem forward: kernel K3, its plain version, and the
custom op ``din_tpu_torch::fused_stem`` around them.

Port of din_tpu/ops/stem_kernel.py ``fused_stem_fwd`` (body ``_stem_kernel``
:68-130): conv1_1 + bias + ReLU, conv1_2 + bias + ReLU and the 2x2/2
max-pool in one kernel, torchvision VGG ``features[0:5]``.  The TPU kernel
worked on a column-folded layout with an indicator channel for the bias and
overlapping DMA'd row tiles, all for the TPU's 128 lanes; here the map is
the canonical NHWC frame map and the pool is in floor mode, as K2.

Forward only, as in the JAX package, whose backward is the unfused stem
(din_tpu/nn/stem.py): VGG-16 and VGG-19 (``nn/backbones.py`` ``_VGG``,
whose first five layers are the same) take this route wherever autograd
needs none of the stem's intermediates (serving, eval, a frozen backbone).

Semantics, fixed by ``fused_stem_ref`` and held by the kernel: each conv
sums in float32 and adds its bias in float32; ReLU; conv1_1's output y1 is
rounded once to the compute dtype (``_stem_kernel`` keeps it in
``o_ref.dtype``, stem_kernel.py:98-99), and y1 outside the frame is exactly
0, conv1_2's zero padding (stem_kernel.py:100-110); conv1_2's output is
pooled and rounded once.  conv1_1's sum runs over the 27 taps in (dh, dw,
ci) order from 0, one rounding per tap: with bf16 frames and weights every
product is exact, so the kernel's y1 equals the plain version's bit for bit
and only conv1_2's order of summation differs.  cuDNN's bf16 route rounds
each conv's output before its bias add, so the plain version is its own
function, not the layers.

The op's CUDA implementation is the launcher ``_fused_stem_fwd``, its CPU
implementation the plain version; no other device is registered, the fake
implementation gives the output's shape, dtype and strides, and no
autograd is registered, so differentiating through the op raises.  Only
the launcher counts.  ``fused_stem`` on a CPU tensor runs the plain
version; on a CUDA tensor it launches csrc/fused_stem.cu or raises; any
other device raises.  The bf16 kernel runs conv1_2 on
wgmma with warp-specialised producers of y1 (the source's header has the
design); the wrapper builds nothing for it: the kernel stages torch's OIHW
weights into its shared-memory layout once per block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from din_tpu_torch.ops import native
from din_tpu_torch.ops.pool import max_pool_2x2_ref
from din_tpu_torch.utils.precision import ieee_f32_convs

_FLOAT_TYPES = (torch.float32, torch.bfloat16)
_SHAPES = {"w0": (64, 3, 3, 3), "b0": (64,), "w2": (64, 64, 3, 3),
           "b2": (64,)}


def fused_stem_ref(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version: x [F,H,W,3] NHWC, torch (OIHW) conv weights and biases
    in x's dtype -> [F,H//2,W//2,64] in x's dtype, float32 arithmetic (no
    TF32 on the card); conv1_1 tap by tap, as the kernel sums it."""
    dtype = x.dtype
    Fr, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))            # [F,H+2,W+2,3]
    w0f = w0.float()
    acc = torch.zeros((Fr, H, W, 64), device=x.device)
    for dh in range(3):
        for dw in range(3):
            for ci in range(3):
                acc = acc + xp[:, dh:dh + H, dw:dw + W, ci:ci + 1] \
                    * w0f[:, ci, dh, dw]
    y1 = (acc + b0.float()).relu_().to(dtype).permute(0, 3, 1, 2)
    with ieee_f32_convs():
        y2 = F.conv2d(y1.float(), w2.float(), b2.float(),
                      padding=1).relu_()
    return max_pool_2x2_ref(y2.permute(0, 2, 3, 1)).to(dtype).contiguous()


def _fused_stem_fwd(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K3's launcher, the CUDA implementation of the op."""
    native.require_cuda_input(x, "x", _FLOAT_TYPES, 4)
    if x.shape[-1] != 3:
        raise ValueError(f"x must be [F,H,W,3], got {tuple(x.shape)}")
    for name, t in (("w0", w0), ("b0", b0), ("w2", w2), ("b2", b2)):
        if (tuple(t.shape) != _SHAPES[name] or t.dtype != x.dtype
                or t.device != x.device):
            raise ValueError(f"{name} must be {_SHAPES[name]} {x.dtype} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    Fr, H, W, _ = x.shape
    out = torch.empty((Fr, H // 2, W // 2, 64), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    # the kernel reads the OIHW weights as they are (no-op contiguous for
    # the model's tensors) and lays them out in shared memory itself
    w0, b0, w2, b2 = (t.contiguous() for t in (w0, b0, w2, b2))
    lib = native.library()
    with torch.cuda.device(x.device):
        code = lib.din_fused_stem(
            x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), Fr, H, W,
            native.dtype_code(x.dtype), native.current_stream(x))
    native.check(code, "fused_stem")
    fused_stem.launches += 1
    return out


_stem_op = torch.library.custom_op(
    "din_tpu_torch::fused_stem", _fused_stem_fwd, mutates_args=(),
    device_types="cuda",
    schema="(Tensor x, Tensor w0, Tensor b0, Tensor w2, Tensor b2) -> Tensor")
_stem_op.register_kernel("cpu", fused_stem_ref)


@_stem_op.register_fake
def _(x, w0, b0, w2, b2):
    Fr, H, W, _ = x.shape
    return x.new_empty((Fr, H // 2, W // 2, 64))


def fused_stem(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """VGG-16 ``features[0:5]`` forward of NHWC frames x [F,H,W,3] (f32 or
    bf16) with conv1_1 (w0 [64,3,3,3], b0) and conv1_2 (w2 [64,64,3,3], b2)
    in x's dtype -> [F,H//2,W//2,64] NHWC.  No gradient.  Counts its kernel
    launches in ``fused_stem.launches``."""
    if x.device.type != "cpu":
        native.require_cuda_input(x, "x", _FLOAT_TYPES, 4)
    return torch.ops.din_tpu_torch.fused_stem(x, w0, b0, w2, b2)


fused_stem.launches = 0
