"""din_tpu's six backbones: VGG-16 and VGG-19, ResNet-18 and ResNet-50,
Inception-v3 cut at Mixed_6e, and AlexNet (port of din_tpu/nn/backbones.py
``_VGG``, lines 64-131, ``_BasicBlock`` / ``_Bottleneck`` / ``_ResNet``,
135-256, ``InceptionV3Backbone``, 258-384, and ``AlexNetBackbone``,
387-415; reference backbone/backbone.py:10-167).

Module names are torchvision's, so reference and exported weights load by
name: ``features.N`` for the VGGs and AlexNet (N from the layer plan: a
conv and its ReLU take two indices, a pool one), Inception-v3's own names
(``Conv2d_1a_3x3.conv``, ``Mixed_6e.branch7x7dbl_5.bn``).  Parameters stay
float32 (the JAX package's ``param_dtype``); each conv computes in the dtype
of the frames it is given (the trunk's ``compute_dtype``) with its weight
and bias cast to that dtype, as flax ``Conv(dtype=bf16)`` casts them, so
the cast's backward hands an f32 gradient to the f32 weight.  A float32
compute dtype means IEEE float32 in the forward and the backward, not
cuDNN's TF32 default (``ieee_conv2d``; bf16 convs are unaffected and keep
``F.conv2d``).  Every backbone runs in ``channels_last`` memory and returns
NHWC maps.

The VGGs' 2x2 pools go through kernels K2 and K2b without a copy.  The JAX
package's folded stem (din_tpu/nn/stem.py) is a device for the TPU's
128-lane vregs, equal in value to the canonical stem: the port runs the
canonical stem.  Where autograd needs none of the stem's intermediates
(grad mode off, or neither the frames nor the stem's weights require grad:
serving, eval, a frozen backbone), ``features[0:5]`` run as one call of
kernel K3 (``ops/stem.py`` ``fused_stem``), the forward-only fused stem
whose backward in the JAX package is the unfused stem; otherwise the layers
run one by one and pool1 is K2 on the 64-channel map.  VGG-16 and VGG-19
share that stem.

ResNet-18 and ResNet-50 are the reference's ``MyRes18``/``MyRes50``:
torchvision's trunk in an anonymous ``nn.Sequential``
(backbone.py:115-154), so their keys are ``features.0`` (conv1),
``features.1`` (bn1), ``features.4``-``features.7`` (layer1-4) and, in a
block, ``conv1``, ``bn1``, ... and ``downsample.0``, ``downsample.1``
(din_tpu/nn/ref_export.py:35-66).  ResNet-50's bottleneck strides its 3x3
conv (torchvision v1.5), as din_tpu's.  The convs have no bias; the
BatchNorms are ``TorchBatchNorm`` (statistics and normalisation in f32,
output in the compute dtype), so the residual add and the ReLU run in the
compute dtype, as ``fused_relu(out + identity)`` does.  The JAX package's
folded 7x7 stem (din_tpu/nn/stem.py ``folded_res_stem_conv``) equals the
canonical conv in value; the port runs the canonical conv.

Inception-v3 returns the reference's two scales, ``[Mixed_5d (288
channels), Mixed_6e (768)]``, which the trunk pools together
(``ops/roi_align.py`` ``roi_align_multiscale``); its ``BasicConv2d`` is a
bias-free conv, ``TorchBatchNorm`` with eps 1e-3 and ReLU, its branches are
concatenated in din_tpu's order, and its pools are torch's 3x3/s1 average
pool counting the padding (din_tpu ``avg_pool_torch``: ``avg_pool_3x3``,
whose backward is the same pool, ``_AvgPool3x3`` says why) and 3x3/s2
floor-mode max-pool (``max_pool_torch``: ``F.max_pool2d``, as are ResNet's
3x3/s2 pool and AlexNet's three 3x3/s2 pools); no Pallas kernel computes
them.  AlexNet's convs have biases and no BatchNorm.

Whether a BatchNorm normalises with the batch's statistics follows the
module's training mode, which the trunk sets (models/trunk.py);
``BACKBONE_HAS_BN`` says which backbones have one (din_tpu's table).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from din_tpu_torch.nn.layers import MaxPool2x2, TorchBatchNorm, lecun_normal_
from din_tpu_torch.ops.stem import fused_stem
from din_tpu_torch.utils.precision import ieee_conv2d

_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]
_VGG19_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
               512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class _VGG(nn.Module):
    """images in [-1,1] NHWC [F,H,W,3] -> [F,H/32,W/32,512] NHWC (floor);
    a subclass sets the layer ``plan``."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        layers, c_in = [], 3
        for item in self.plan:
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


class VGG16Backbone(_VGG):
    plan = tuple(_VGG16_PLAN)


class VGG19Backbone(_VGG):
    plan = tuple(_VGG19_PLAN)


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


def _downsample(c_in: int, c_out: int, stride: int,
                generator: torch.Generator) -> Optional[nn.Sequential]:
    """The 1x1(stride) conv + BN of a block whose shape changes, else
    None."""
    if stride == 1 and c_in == c_out:
        return None
    return nn.Sequential(_resnet_conv(c_in, c_out, 1, stride, generator),
                         TorchBatchNorm(c_out))


def _identity(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if block.downsample is None:
        return x
    return block.downsample[1](_conv(x, block.downsample[0]))


class _BasicBlock(nn.Module):
    """conv3x3(stride) + BN + ReLU + conv3x3 + BN, plus the identity or a
    1x1(stride) conv + BN, then ReLU (torchvision BasicBlock)."""

    expansion = 1

    def __init__(self, c_in: int, width: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        self.conv1 = _resnet_conv(c_in, width, 3, stride, generator)
        self.bn1 = TorchBatchNorm(width)
        self.conv2 = _resnet_conv(width, width, 3, 1, generator)
        self.bn2 = TorchBatchNorm(width)
        self.downsample = _downsample(c_in, width, stride, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(_conv(x, self.conv1)))
        out = self.bn2(_conv(out, self.conv2))
        return torch.relu(out + _identity(self, x))


class _Bottleneck(nn.Module):
    """conv1x1 + BN + ReLU, conv3x3(stride) + BN + ReLU, conv1x1 (4x the
    width) + BN, plus the identity or a 1x1(stride) conv + BN, then ReLU
    (din_tpu/nn/backbones.py:162-189, torchvision v1.5 Bottleneck)."""

    expansion = 4

    def __init__(self, c_in: int, width: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        c_out = width * self.expansion
        self.conv1 = _resnet_conv(c_in, width, 1, 1, generator)
        self.bn1 = TorchBatchNorm(width)
        self.conv2 = _resnet_conv(width, width, 3, stride, generator)
        self.bn2 = TorchBatchNorm(width)
        self.conv3 = _resnet_conv(width, c_out, 1, 1, generator)
        self.bn3 = TorchBatchNorm(c_out)
        self.downsample = _downsample(c_in, c_out, stride, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(_conv(x, self.conv1)))
        out = torch.relu(self.bn2(_conv(out, self.conv2)))
        out = self.bn3(_conv(out, self.conv3))
        return torch.relu(out + _identity(self, x))


class _ResNet(nn.Module):
    """images in [-1,1] NHWC [F,H,W,3] -> [F,H',W',512 * expansion] NHWC,
    H' = ceil(H/32) (7x7/s2 conv, 3x3/s2 pool, three stride-2 stages);
    a subclass sets ``block`` and the blocks of each stage, ``layers``."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        stages, c_in = [], 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512),
                                            self.layers)):
            blocks = []
            for bi in range(n):
                stride = 2 if (li > 0 and bi == 0) else 1
                blocks.append(self.block(c_in, width, stride, generator))
                c_in = width * self.block.expansion
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


class ResNet18Backbone(_ResNet):
    block = _BasicBlock
    layers = (2, 2, 2, 2)


class ResNet50Backbone(_ResNet):
    block = _Bottleneck
    layers = (3, 4, 6, 3)


class _BasicConv2d(nn.Module):
    """conv (no bias) + BN (eps 1e-3) + ReLU (torchvision BasicConv2d)."""

    def __init__(self, c_in: int, c_out: int, kernel_size, generator,
                 stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride=stride,
                              padding=padding, bias=False)
        lecun_normal_(self.conv.weight, generator)
        self.bn = TorchBatchNorm(c_out, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(_conv(x, self.conv)))


class _AvgPool3x3(torch.autograd.Function):
    """3x3/s1 average pool, padding 1 counted (din_tpu ``avg_pool_torch``,
    count_include_pad=True).  The window is symmetric and the divisor always
    9, so the pool is its own adjoint: the backward is the same pool of the
    incoming gradient, computed by ``F.avg_pool2d``'s forward.  PyTorch's
    own backward of it on the card (torch 2.11 CUDA) is wrong for a
    channels_last map, far off the CPU's, whose backward this equals;
    ``chip_smoke.py`` phase 13 holds this one and prints how far PyTorch's
    is off (PERF.md §6 quotes it)."""

    @staticmethod
    def forward(ctx, x):
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)

    @staticmethod
    def backward(ctx, g):
        return F.avg_pool2d(g, 3, 1, 1, count_include_pad=True)


def avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """Inception-v3's branch pool on an NCHW map (any memory format)."""
    return _AvgPool3x3.apply(x)


class _InceptionA(nn.Module):
    """[1x1, 5x5, double 3x3, pool] -> 224 + ``pool_features`` channels."""

    def __init__(self, c_in: int, pool_features: int, g):
        super().__init__()
        self.branch1x1 = _BasicConv2d(c_in, 64, 1, g)
        self.branch5x5_1 = _BasicConv2d(c_in, 48, 1, g)
        self.branch5x5_2 = _BasicConv2d(48, 64, 5, g, padding=2)
        self.branch3x3dbl_1 = _BasicConv2d(c_in, 64, 1, g)
        self.branch3x3dbl_2 = _BasicConv2d(64, 96, 3, g, padding=1)
        self.branch3x3dbl_3 = _BasicConv2d(96, 96, 3, g, padding=1)
        self.branch_pool = _BasicConv2d(c_in, pool_features, 1, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class _InceptionB(nn.Module):
    """[3x3/s2, double 3x3 (s2), 3x3/s2 max-pool] -> 480 + c_in channels."""

    def __init__(self, c_in: int, g):
        super().__init__()
        self.branch3x3 = _BasicConv2d(c_in, 384, 3, g, stride=2)
        self.branch3x3dbl_1 = _BasicConv2d(c_in, 64, 1, g)
        self.branch3x3dbl_2 = _BasicConv2d(64, 96, 3, g, padding=1)
        self.branch3x3dbl_3 = _BasicConv2d(96, 96, 3, g, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


class _InceptionC(nn.Module):
    """[1x1, 1x7-7x1, double 7x1-1x7, pool] -> 768 channels; the 1x7 and
    7x1 convs keep their asymmetric padding."""

    def __init__(self, c_in: int, c7: int, g):
        super().__init__()
        row, col = dict(padding=(0, 3)), dict(padding=(3, 0))
        self.branch1x1 = _BasicConv2d(c_in, 192, 1, g)
        self.branch7x7_1 = _BasicConv2d(c_in, c7, 1, g)
        self.branch7x7_2 = _BasicConv2d(c7, c7, (1, 7), g, **row)
        self.branch7x7_3 = _BasicConv2d(c7, 192, (7, 1), g, **col)
        self.branch7x7dbl_1 = _BasicConv2d(c_in, c7, 1, g)
        self.branch7x7dbl_2 = _BasicConv2d(c7, c7, (7, 1), g, **col)
        self.branch7x7dbl_3 = _BasicConv2d(c7, c7, (1, 7), g, **row)
        self.branch7x7dbl_4 = _BasicConv2d(c7, c7, (7, 1), g, **col)
        self.branch7x7dbl_5 = _BasicConv2d(c7, 192, (1, 7), g, **row)
        self.branch_pool = _BasicConv2d(c_in, 192, 1, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_3x3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionV3Backbone(nn.Module):
    """images in [-1,1] NHWC [F,H,W,3] -> the two-scale list [Mixed_5d
    [F,h5,w5,288], Mixed_6e [F,h6,w6,768]] NHWC (720x1280: 87x157 and
    43x78; 480x720: 57x87 and 28x43)."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        g = generator
        self.Conv2d_1a_3x3 = _BasicConv2d(3, 32, 3, g, stride=2)
        self.Conv2d_2a_3x3 = _BasicConv2d(32, 32, 3, g)
        self.Conv2d_2b_3x3 = _BasicConv2d(32, 64, 3, g, padding=1)
        self.Conv2d_3b_1x1 = _BasicConv2d(64, 80, 1, g)
        self.Conv2d_4a_3x3 = _BasicConv2d(80, 192, 3, g)
        self.Mixed_5b = _InceptionA(192, 32, g)
        self.Mixed_5c = _InceptionA(256, 64, g)
        self.Mixed_5d = _InceptionA(288, 64, g)
        self.Mixed_6a = _InceptionB(288, g)
        self.Mixed_6b = _InceptionC(768, 128, g)
        self.Mixed_6c = _InceptionC(768, 160, g)
        self.Mixed_6d = _InceptionC(768, 160, g)
        self.Mixed_6e = _InceptionC(768, 192, g)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [F,H,W,3] in the compute dtype; the weights are cast to it."""
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        out5 = self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(x)))
        x = self.Mixed_6a(out5)
        for block in (self.Mixed_6b, self.Mixed_6c, self.Mixed_6d,
                      self.Mixed_6e):
            x = block(x)
        return [m.permute(0, 2, 3, 1).contiguous() for m in (out5, x)]


class AlexNetBackbone(nn.Module):
    """images in [-1,1] NHWC [F,H,W,3] -> [F,h,w,256] NHWC (torchvision's
    ``features``: 11x11/s4, 5x5 and three 3x3 convs with bias and ReLU,
    three 3x3/s2 max-pools; 720x1280 gives 21x39)."""

    _CONVS = {0: (3, 64, 11, 4, 2), 3: (64, 192, 5, 1, 2),
              6: (192, 384, 3, 1, 1), 8: (384, 256, 3, 1, 1),
              10: (256, 256, 3, 1, 1)}

    def __init__(self, generator: torch.Generator):
        super().__init__()
        layers = []
        for i in range(13):
            if i in self._CONVS:
                c_in, c_out, k, stride, pad = self._CONVS[i]
                conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=pad)
                lecun_normal_(conv.weight, generator)
                nn.init.zeros_(conv.bias)
                layers.append(conv)
            elif i in (2, 5, 12):
                layers.append(nn.MaxPool2d(3, 2))
            else:
                layers.append(nn.ReLU(inplace=True))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [F,H,W,3] in the compute dtype; the weights are cast to it."""
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        for layer in self.features:
            x = _conv(x, layer) if isinstance(layer, nn.Conv2d) else layer(x)
        return x.permute(0, 2, 3, 1).contiguous()


# torchvision ResNet's top-level modules -> their place in the reference's
# Sequential (backbone/backbone.py:119-128; din_tpu/nn/ref_export.py:35-37)
RESNET_SEQ = {"conv1": "features.0", "bn1": "features.1",
              "layer1": "features.4", "layer2": "features.5",
              "layer3": "features.6", "layer4": "features.7"}

BACKBONES = {"inv3": InceptionV3Backbone, "vgg16": VGG16Backbone,
             "vgg19": VGG19Backbone, "res18": ResNet18Backbone,
             "res50": ResNet50Backbone, "alex": AlexNetBackbone}
# which backbones carry BatchNorm, live in training (din_tpu/nn/backbones.py
# :433-440)
BACKBONE_HAS_BN = {"inv3": True, "vgg16": False, "vgg19": False,
                   "res18": True, "res50": True, "alex": False}


def build_backbone(name: str, generator: torch.Generator) -> nn.Module:
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r} (choose from "
                         f"{sorted(BACKBONES)})")
    return BACKBONES[name](generator)
