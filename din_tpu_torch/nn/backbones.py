"""VGG-16 backbone (port of din_tpu/nn/backbones.py ``_VGG`` /
``VGG16Backbone``, lines 64-124; reference backbone/backbone.py:88-112).

Layers are ``features.N`` as in torchvision, so reference and exported
weights load by name.  It runs in ``channels_last`` memory, so every conv
output is an NHWC map and its five 2x2 pools go through kernel K2 without a
copy.  The JAX package's folded stem (din_tpu/nn/stem.py) is a device for
the TPU's 128-lane vregs, equal in value to the canonical stem: the port
runs the canonical stem, and its pool1, which the TPU ran as
``fold_pool_2x2``, is K2 on the 64-channel map.
"""

from __future__ import annotations

import torch
from torch import nn

from din_tpu_torch.nn.layers import MaxPool2x2, lecun_normal_

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
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.features(x)
        return x.permute(0, 2, 3, 1).contiguous()


BACKBONES = {"vgg16": VGG16Backbone}


def build_backbone(name: str, generator: torch.Generator) -> nn.Module:
    if name not in BACKBONES:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet: ResNet-18 is slice 3 and "
            f"Inception-v3 slice 4 of ROADMAP.md; ported: {sorted(BACKBONES)}")
    return BACKBONES[name](generator)
