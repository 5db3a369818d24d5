"""Full float32 convolutions on the card, whatever the process-wide flags.

cuDNN runs float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps a 10-bit
mantissa.  The JAX package computes its convolutions at
``precision="highest"`` (the DIN head's offset and affinity convs,
din_tpu/heads/din.py:162, and the backbone's, din_tpu/nn/layers.py:56,67),
and JAX carries that precision into the transposed convolutions of the
backward.  The port does the same:

- ``ieee_f32_convs()`` switches TF32 off for the code it wraps and restores
  the caller's setting afterwards (the plain versions of kernels that
  compute in float32 use it);
- ``ieee_conv2d`` is ``F.conv2d`` whose forward and whose backward (dgrad,
  wgrad and the bias gradient, through ``conv2d_grads``) both run under
  ``ieee_f32_convs()``: autograd runs a backward after the forward's
  context has closed, so a context around the forward alone leaves the
  backward in TF32.  The DIN head's grid convs and the float32 backbone
  convs call it; bf16 convolutions are untouched by TF32 and keep the plain
  call.

Nothing here changes another flag or anything on the CPU, where
``ieee_conv2d`` equals autograd of ``F.conv2d``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_f32_convs():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _pair(v):
    return list(v) if isinstance(v, (tuple, list)) else [v, v]


def conv2d_grads(g, x, weight, bias_shape, stride, padding, dilation, groups,
                 mask):
    """(dx, dweight, dbias) of ``F.conv2d`` for the incoming gradient g,
    each computed where ``mask`` asks for it (else None)."""
    return torch.ops.aten.convolution_backward(
        g, x, weight, bias_shape, _pair(stride), _pair(padding),
        _pair(dilation), False, [0, 0], groups, mask)


class _IeeeConv2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (None if bias is None else list(bias.shape), stride,
                    padding, dilation, groups)
        with ieee_f32_convs():
            return F.conv2d(x, weight, bias, stride, padding, dilation,
                            groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        bias_shape, stride, padding, dilation, groups = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                bias_shape is not None and ctx.needs_input_grad[2]]
        with ieee_f32_convs():
            dx, dw, db = conv2d_grads(g, x, weight, bias_shape, stride,
                                      padding, dilation, groups, mask)
        return dx, dw, db, None, None, None, None


def ieee_conv2d(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor = None, stride=1, padding=0, dilation=1,
                groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` with its forward and backward in IEEE float32 on the
    card (cuDNN's TF32 off for both), whatever the caller's flags."""
    return _IeeeConv2d.apply(x, weight, bias, stride, padding, dilation,
                             groups)
