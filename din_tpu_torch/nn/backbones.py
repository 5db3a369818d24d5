"""VGG-16 backbone (port of din_tpu/nn/backbones.py ``_VGG`` /
``VGG16Backbone``, lines 64-124; reference backbone/backbone.py:88-112).

Layers are ``features.N`` as in torchvision, so reference and exported
weights load by name. Parameters stay float32 (the JAX package's
``param_dtype``); each conv computes in the dtype of the frames it is given
(the trunk's ``compute_dtype``) with its weight and bias cast to that dtype,
as flax ``Conv(dtype=bf16)`` casts them, so the cast's backward hands an f32
gradient to the f32 weight.  A float32 compute dtype means IEEE float32 in
the forward, not cuDNN's TF32 default (``ieee_f32_convs``; bf16 convs are
unaffected).  It runs in ``channels_last`` memory, so every conv output is
an NHWC map and its five 2x2 pools go through kernels K2 and K2b without a
copy. The JAX package's folded stem (din_tpu/nn/stem.py) is a
device for the TPU's 128-lane vregs, equal in value to the canonical stem:
the port runs the canonical stem.  Where autograd needs none of the stem's
intermediates (grad mode off, or neither the frames nor the stem's weights
require grad: serving, eval, a frozen backbone), ``features[0:5]`` run as
one call of kernel K3 (``ops/stem.py`` ``fused_stem``), the forward-only
fused stem whose backward in the JAX package is the unfused stem; otherwise
the layers run one by one and pool1 is K2 on the 64-channel map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from din_tpu_torch.nn.layers import MaxPool2x2, lecun_normal_
from din_tpu_torch.ops.stem import fused_stem
from din_tpu_torch.utils.precision import ieee_f32_convs

_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]


class VGG16Backbone(nn.Module):
    """images in [-1,1] NHWC [F,H,W,3] -> [F,H/32,W/32,512] NHWC (floor)."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        layers, c_in = [], 3
        for item in _VGG16_PLAN:
            if item == "M":
                layers.append(MaxPool2x2())
            else:
                conv = nn.Conv2d(c_in, item, 3, padding=1)
                lecun_normal_(conv.weight, generator)
                nn.init.zeros_(conv.bias)
                layers += [conv, nn.ReLU(inplace=True)]
                c_in = item
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [F,H,W,3] in the compute dtype; the weights are cast to it."""
        conv1_1, conv1_2 = self.features[0], self.features[2]
        stem_params = (conv1_1.weight, conv1_1.bias, conv1_2.weight,
                       conv1_2.bias)
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in stem_params)):
            layers = self.features
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        else:
            layers = self.features[5:]
            # NHWC out, so the NCHW view is channels_last
            x = fused_stem(x.contiguous(),
                           *(p.to(x.dtype) for p in stem_params)
                           ).permute(0, 3, 1, 2)
        with ieee_f32_convs():
            for layer in layers:
                if isinstance(layer, nn.Conv2d):
                    x = F.conv2d(x, layer.weight.to(x.dtype),
                                 layer.bias.to(x.dtype), padding=layer.padding)
                else:
                    x = layer(x)
        return x.permute(0, 2, 3, 1).contiguous()


BACKBONES = {"vgg16": VGG16Backbone}


def build_backbone(name: str, generator: torch.Generator) -> nn.Module:
    if name not in BACKBONES:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet: ResNet-18 is slice 3 and "
            f"Inception-v3 slice 4 of ROADMAP.md; ported: {sorted(BACKBONES)}")
    return BACKBONES[name](generator)
