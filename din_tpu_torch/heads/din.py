"""DIN: Dynamic Person Inference (port of din_tpu/heads/din.py, forward;
reference infer_module/dynamic_infer_module.py:14-443).

Over the [B,T,N,C] actor grid, each position samples a k x k (dilated)
neighbourhood displaced by predicted fractional offsets (``p_conv``),
bilinearly over the zero-padded grid, and mixes the samples with a softmaxed
affinity (``scale_conv``) or their mean; ``hidden_weight`` projects the
result.  The JAX package applies the bilinear blend as a one-hot matmul for
the TPU's matrix unit (din.py:18-24); the port gathers the four corners, as
the reference's ``_get_ft`` does, with the same corner, clamp and
stop-gradient-floor math (din.py:90-104).

``p_conv`` and ``scale_conv`` run in IEEE float32 on the card, forward and
backward (``ieee_conv2d``), as the JAX package runs them at
``precision="highest"`` (din.py:162): cuDNN's TF32 default would put a
10-bit mantissa into the offsets that pick the sampling positions, into
the affinity logits and into their gradients.

Parameter names are the reference's: ``DIMlist.{i}.p_conv.{ratio}``,
``scale_conv.{ratio}``, ``hidden_weight``, ``beta``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from din_tpu_torch.nn.layers import kaiming_normal_
from din_tpu_torch.utils.precision import ieee_conv2d


def _pos_k(kernel_size: Tuple[int, int], ratio: int,
           device=None) -> torch.Tensor:
    """Kernel-grid offsets [2*k2], y block then x block
    (dynamic_infer_module.py:385-392)."""
    kh, kw = kernel_size
    fy = (kh - 1) * ratio + 1
    fx = (kw - 1) * ratio + 1
    dy = torch.arange(-(fy - 1) // 2, (fy - 1) // 2 + 1, ratio,
                      dtype=torch.float32, device=device)
    dx = torch.arange(-(fx - 1) // 2, (fx - 1) // 2 + 1, ratio,
                      dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(dy, dx, indexing="ij")
    return torch.cat([gy.reshape(-1), gx.reshape(-1)])


def _pos_0(T: int, N: int, kernel_size: Tuple[int, int], ratio: int,
           stride: int, k2: int, device=None) -> torch.Tensor:
    """Base positions [T, N, 2*k2] in the padded grid
    (dynamic_infer_module.py:394-404)."""
    kh, kw = kernel_size
    pad_tb = (kh - 1) // 2 * ratio
    pad_lr = (kw - 1) // 2 * ratio
    y0 = pad_tb + torch.arange(T, dtype=torch.float32, device=device) * stride
    x0 = pad_lr + torch.arange(N, dtype=torch.float32, device=device) * stride
    y = y0[:, None, None].expand(T, N, k2)
    x = x0[None, :, None].expand(T, N, k2)
    return torch.cat([y, x], dim=-1)


def _padded_grid(x: torch.Tensor, kernel_size: Tuple[int, int], ratio: int):
    """x [B,T,N,C] zero-padded by the kernel's reach -> ([B,Hp*Wp,C], Hp, Wp)."""
    B, T, N, C = x.shape
    kh, kw = kernel_size
    pad_tb = (kh - 1) // 2 * ratio
    pad_lr = (kw - 1) // 2 * ratio
    xpad = F.pad(x, (0, 0, pad_lr, pad_lr, pad_tb, pad_tb))
    Hp, Wp = T + 2 * pad_tb, N + 2 * pad_lr
    return xpad.reshape(B, Hp * Wp, C), Hp, Wp


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat [B,P,C], idx [B,...] -> [B,...,C]."""
    B, C = flat.shape[0], flat.shape[-1]
    out = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def _bilinear_sample(x: torch.Tensor, pos: torch.Tensor,
                     kernel_size: Tuple[int, int], ratio: int) -> torch.Tensor:
    """Bilinear samples of the padded T x N grid at fractional positions.

    x [B,T,N,C]; pos [B,T,N,2*k2] in padded-grid coords (y block, x block).
    Returns [B,T,N,k2,C] (dynamic_infer_module.py:207-258).
    """
    k2 = kernel_size[0] * kernel_size[1]
    flat, Hp, Wp = _padded_grid(x, kernel_size, ratio)
    pos_y, pos_x = pos[..., :k2], pos[..., k2:]
    # corners from the un-clamped floor (no gradient), then clamped
    fy = torch.floor(pos_y).detach()
    fx = torch.floor(pos_x).detach()
    lt_y = fy.clamp(0, Hp - 1)
    lt_x = fx.clamp(0, Wp - 1)
    rb_y = (fy + 1).clamp(0, Hp - 1)
    rb_x = (fx + 1).clamp(0, Wp - 1)
    # clamped positions for the coefficients (gradients reach the offsets)
    cy = pos_y.clamp(0, Hp - 1)
    cx = pos_x.clamp(0, Wp - 1)
    wy_lt = 1.0 - (cy - lt_y).abs()
    wy_rb = 1.0 - (cy - rb_y).abs()
    wx_lt = 1.0 - (cx - lt_x).abs()
    wx_rb = 1.0 - (cx - rb_x).abs()

    def corner(yy, xx):
        return _take(flat, (yy * Wp + xx).long())

    ft = (corner(lt_y, lt_x) * (wy_lt * wx_lt)[..., None]
          + corner(rb_y, rb_x) * (wy_rb * wx_rb)[..., None]
          + corner(rb_y, lt_x) * (wy_rb * wx_lt)[..., None]
          + corner(lt_y, rb_x) * (wy_lt * wx_rb)[..., None])
    return ft.to(x.dtype)


def _integer_sample(x: torch.Tensor, pos: torch.Tensor,
                    kernel_size: Tuple[int, int], ratio: int) -> torch.Tensor:
    """Samples at integer grid positions (``plain_infer_ratio``,
    dynamic_infer_module.py:154-181).  pos [1|B,T,N,2*k2] -> [B,T,N,k2,C]."""
    B = x.shape[0]
    k2 = kernel_size[0] * kernel_size[1]
    flat, _, Wp = _padded_grid(x, kernel_size, ratio)
    idx = (pos[..., :k2] * Wp + pos[..., k2:]).long()
    return _take(flat, idx.expand(B, *idx.shape[1:]))


class DynamicPersonInference(nn.Module):
    """One DIN interaction field (dynamic_infer_module.py:14-404)."""

    def __init__(self, in_dim: int, generator: torch.Generator,
                 kernel_size: Tuple[int, int] = (3, 3), stride: int = 1,
                 dynamic_sampling: bool = True,
                 sampling_ratio: Sequence[int] = (1,), group: int = 1,
                 scale_factor: bool = True, beta_factor: bool = False,
                 parallel_inference: bool = False):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = stride
        self.dynamic_sampling = dynamic_sampling
        self.sampling_ratio = tuple(sampling_ratio)
        self.scale_factor = scale_factor
        self.parallel_inference = parallel_inference
        kh, kw = self.kernel_size
        k2 = kh * kw

        def offset_conv(ratio, out_ch):
            # zero weights and bias (dynamic_infer_module.py:66-67,80-81):
            # the walk starts on the plain grid, the affinity uniform
            conv = nn.Conv2d(in_dim, out_ch, self.kernel_size, stride=stride,
                             padding=((kh - 1) // 2 * ratio,
                                      (kw - 1) // 2 * ratio),
                             dilation=ratio, groups=group)
            nn.init.zeros_(conv.weight)
            nn.init.zeros_(conv.bias)
            return conv

        walks = parallel_inference or dynamic_sampling
        self.p_conv = nn.ModuleDict(
            {str(r): offset_conv(r, 2 * k2) for r in self.sampling_ratio}
            if walks else {})
        self.scale_conv = nn.ModuleDict(
            {str(r): offset_conv(r, k2) for r in self.sampling_ratio}
            if scale_factor else {})
        self.beta = (nn.Parameter(torch.ones(len(self.sampling_ratio)))
                     if beta_factor else None)
        self.hidden_weight = nn.Linear(in_dim, in_dim, bias=False)
        kaiming_normal_(self.hidden_weight.weight, generator)

    @staticmethod
    def _grid_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """Conv over the T x N person map: [B,T,N,C] -> [B,T,N,out], forward
        and backward in full float32 whatever the process's TF32 flag."""
        return ieee_conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                           conv.stride, conv.padding, conv.dilation,
                           conv.groups).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,T,N,C] -> [B,T,N,C]."""
        B, T, N, C = x.shape
        k2 = self.kernel_size[0] * self.kernel_size[1]
        ratio_features = []
        for ratio in self.sampling_ratio:
            key = str(ratio)
            plain_pos = (_pos_0(T, N, self.kernel_size, ratio, self.stride,
                                k2, x.device)[None]
                         + _pos_k(self.kernel_size, ratio, x.device))
            scale = None
            if self.scale_factor:
                s = self._grid_conv(self.scale_conv[key], x)
                scale = torch.softmax(s.float(), dim=-1)[..., None]

            if self.parallel_inference or self.dynamic_sampling:
                offset = self._grid_conv(self.p_conv[key], x)
                pos = plain_pos + offset.float()
                ft_walk = _bilinear_sample(x, pos, self.kernel_size, ratio)
            if self.parallel_inference:
                # affinity on the plain grid plus the walk, summed
                # (dynamic_infer_module.py:285-341)
                ft_plain = _integer_sample(x, plain_pos, self.kernel_size,
                                           ratio)
                ft = (ft_plain * scale.to(ft_plain.dtype)).sum(3) \
                    + ft_walk.mean(3)
            else:
                ft = ft_walk if self.dynamic_sampling else _integer_sample(
                    x, plain_pos, self.kernel_size, ratio)
                ft = (ft * scale.to(ft.dtype)).sum(3) if self.scale_factor \
                    else ft.mean(3)
            ratio_features.append(ft)

        stacked = torch.stack(ratio_features, dim=-1)         # [B,T,N,C,R]
        if self.beta is not None:
            out = (stacked * self.beta.to(stacked.dtype)).sum(-1)
        else:
            out = stacked.mean(-1)
        return self.hidden_weight(out)


class MultiDynamicInference(nn.Module):
    """num_DIM parallel DIN fields with their own kernels, summed
    (dynamic_infer_module.py:407-443)."""

    def __init__(self, in_dim: int, generator: torch.Generator,
                 kernel_sizes: Sequence[Tuple[int, int]] = ((3, 3),),
                 **kwargs):
        super().__init__()
        self.DIMlist = nn.ModuleList(
            DynamicPersonInference(in_dim, generator, kernel_size=tuple(ks),
                                   **kwargs)
            for ks in kernel_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        total = None
        for dim in self.DIMlist:
            ft = dim(x)
            total = ft if total is None else total + ft
        return total
