"""VGG-16 and ResNet-18 backbones (port of din_tpu/nn/backbones.py ``_VGG``
/ ``VGG16Backbone``, lines 64-124, and ``_BasicBlock`` / ``_ResNet`` /
``ResNet18Backbone``, lines 135-246; reference backbone/backbone.py:88-128).

Layers are ``features.N`` as in torchvision, so reference and exported
weights load by name. Parameters stay float32 (the JAX package's
``param_dtype``); each conv computes in the dtype of the frames it is given
(the trunk's ``compute_dtype``) with its weight and bias cast to that dtype,
as flax ``Conv(dtype=bf16)`` casts them, so the cast's backward hands an f32
gradient to the f32 weight.  A float32 compute dtype means IEEE float32 in
the forward and the backward, not cuDNN's TF32 default (``ieee_conv2d``;
bf16 convs are unaffected and keep ``F.conv2d``).  It runs in
``channels_last`` memory, so every conv output is an NHWC map and its five
2x2 pools go through kernels K2 and K2b without a copy. The JAX package's
folded stem (din_tpu/nn/stem.py) is a
device for the TPU's 128-lane vregs, equal in value to the canonical stem:
the port runs the canonical stem.  Where autograd needs none of the stem's
intermediates (grad mode off, or neither the frames nor the stem's weights
require grad: serving, eval, a frozen backbone), ``features[0:5]`` run as
one call of kernel K3 (``ops/stem.py`` ``fused_stem``), the forward-only
fused stem whose backward in the JAX package is the unfused stem; otherwise
the layers run one by one and pool1 is K2 on the 64-channel map.

ResNet-18 is the reference's ``MyRes18``: torchvision's trunk in an
anonymous ``nn.Sequential`` (backbone.py:119-128), so its keys are
``features.0`` (conv1), ``features.1`` (bn1), ``features.4``-``features.7``
(layer1-4) and, in a block, ``conv1``, ``bn1``, ``conv2``, ``bn2``,
``downsample.0``, ``downsample.1`` (din_tpu/nn/ref_export.py:35-37).  Its
convs have no bias and follow the VGG-16's dtype rule; its BatchNorms are
``TorchBatchNorm`` (statistics and normalisation in f32, output in the
compute dtype), so the residual add and the ReLU run in the compute dtype,
as ``fused_relu(out + identity)`` does.  The 3x3/s2 pool after the stem is
``F.max_pool2d`` (no Pallas kernel in the JAX package).  The JAX package's
folded 7x7 stem (din_tpu/nn/stem.py ``folded_res_stem_conv``) equals the
canonical conv in value; the port runs the canonical conv.  Whether a
BatchNorm normalises with the batch's statistics follows the module's
training mode, which the trunk sets (models/trunk.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from din_tpu_torch.nn.layers import MaxPool2x2, TorchBatchNorm, lecun_normal_
from din_tpu_torch.ops.stem import fused_stem
from din_tpu_torch.utils.precision import ieee_conv2d

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
        # float32: forward and backward in IEEE f32; bf16: cuDNN as it is
        for layer in layers:
            x = _conv(x, layer) if isinstance(layer, nn.Conv2d) else layer(x)
        return x.permute(0, 2, 3, 1).contiguous()


def _conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """``layer`` on x in x's dtype, the weight cast to it: IEEE f32 forward
    and backward for float32, cuDNN as it is for bf16."""
    conv = ieee_conv2d if x.dtype == torch.float32 else F.conv2d
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return conv(x, layer.weight.to(x.dtype), bias, layer.stride,
                layer.padding)


def _resnet_conv(c_in: int, c_out: int, k: int, stride: int,
                 generator: torch.Generator) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2,
                     bias=False)
    lecun_normal_(conv.weight, generator)
    return conv


class _BasicBlock(nn.Module):
    """conv3x3(stride) + BN + ReLU + conv3x3 + BN, plus the identity or a
    1x1(stride) conv + BN, then ReLU (torchvision BasicBlock)."""

    def __init__(self, c_in: int, c_out: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        self.conv1 = _resnet_conv(c_in, c_out, 3, stride, generator)
        self.bn1 = TorchBatchNorm(c_out)
        self.conv2 = _resnet_conv(c_out, c_out, 3, 1, generator)
        self.bn2 = TorchBatchNorm(c_out)
        self.downsample = None
        if stride != 1 or c_in != c_out:
            self.downsample = nn.Sequential(
                _resnet_conv(c_in, c_out, 1, stride, generator),
                TorchBatchNorm(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(_conv(x, self.conv1)))
        out = self.bn2(_conv(out, self.conv2))
        identity = x if self.downsample is None else \
            self.downsample[1](_conv(x, self.downsample[0]))
        return torch.relu(out + identity)


class ResNet18Backbone(nn.Module):
    """images in [-1,1] NHWC [F,H,W,3] -> [F,H',W',512] NHWC, H' =
    ceil(H/32) (7x7/s2 conv, 3x3/s2 pool, three stride-2 stages)."""

    def __init__(self, generator: torch.Generator,
                 layers=(2, 2, 2, 2)):
        super().__init__()
        stages, c_in = [], 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for bi in range(n):
                stride = 2 if (li > 0 and bi == 0) else 1
                blocks.append(_BasicBlock(c_in, width, stride, generator))
                c_in = width
            stages.append(nn.Sequential(*blocks))
        self.features = nn.Sequential(
            _resnet_conv(3, 64, 7, 2, generator), TorchBatchNorm(64),
            nn.ReLU(), nn.MaxPool2d(3, 2, 1), *stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [F,H,W,3] in the compute dtype; the weights are cast to it."""
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = torch.relu(self.features[1](_conv(x, self.features[0])))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in self.features[4:]:
            x = stage(x)
        return x.permute(0, 2, 3, 1).contiguous()


# torchvision ResNet's top-level modules -> their place in the reference's
# Sequential (backbone/backbone.py:119-128; din_tpu/nn/ref_export.py:35-37)
RESNET_SEQ = {"conv1": "features.0", "bn1": "features.1",
              "layer1": "features.4", "layer2": "features.5",
              "layer3": "features.6", "layer4": "features.7"}

BACKBONES = {"vgg16": VGG16Backbone, "res18": ResNet18Backbone}
# the ROADMAP.md section 1 item that brings each backbone the port lacks
BACKBONE_ITEM = {"inv3": 5, "vgg19": 6, "res50": 6, "alexnet": 6}


def build_backbone(name: str, generator: torch.Generator) -> nn.Module:
    if name not in BACKBONES:
        item = BACKBONE_ITEM.get(name)
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet"
            + (f": it comes with ROADMAP.md §1 item {item}" if item else "")
            + f"; ported: {sorted(BACKBONES)}")
    return BACKBONES[name](generator)
