"""Building blocks with the JAX package's semantics (port of
din_tpu/nn/layers.py).

``torch_conv`` is ``nn.Conv2d`` itself, ``TorchLayerNorm(ndims)`` is
``nn.LayerNorm`` over the trailing dims, ``max_pool_torch(x, 2, 2)`` is
``MaxPool2x2``, which goes through kernels K2 and K2b (the 3x3/s2 pools
of ResNet, Inception-v3 and AlexNet are ``F.max_pool2d`` and
``avg_pool_torch`` is ``nn/backbones.py`` ``avg_pool_3x3``: no Pallas
kernel computes them), the flax ``TorchBatchNorm`` is the
``nn.BatchNorm2d`` subclass of the same name (Inception-v3's with eps
1e-3), and
flax ``nn.Dropout`` is ``SeededDropout``.  The initialisers
reproduce the JAX package's from a ``torch.Generator``: flax's default
conv init (lecun normal, truncated), the reference's kaiming-normal Linear
init, zero biases.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from din_tpu_torch.ops.pool import max_pool_2x2

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _fan_in(w: torch.Tensor) -> int:
    return w.shape[1] * math.prod(w.shape[2:])


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: variance 1/fan_in, truncated at 2 std."""
    std = 1.0 / math.sqrt(_fan_in(w)) / _TRUNC_STD
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    z = torch.erfinv((lo + (hi - lo) * u) * 2 - 1) * math.sqrt(2)
    w.copy_(z * std)


@torch.no_grad()
def kaiming_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """torch ``kaiming_normal_`` (fan_in, relu): std sqrt(2/fan_in), the
    reference's Linear init (din_tpu/nn/layers.py kaiming_normal_init)."""
    w.normal_(0.0, math.sqrt(2.0 / _fan_in(w)), generator=generator)


def kaiming_linear(i: int, o: int, generator: torch.Generator,
                   bias: bool = True) -> nn.Linear:
    """``nn.Linear`` with the reference's kaiming-normal init and a zero
    bias (din_tpu's ``nn.Dense(kernel_init=kaiming_normal_init)``)."""
    m = nn.Linear(i, o, bias=bias)
    kaiming_normal_(m.weight, generator)
    if bias:
        nn.init.zeros_(m.bias)
    return m


class MaxPool2x2(nn.Module):
    """torch ``MaxPool2d(2, 2)`` (floor mode) on an NCHW map held in
    ``channels_last`` memory, through kernel K2 on the card."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NCHW channels_last is NHWC in memory: the permute is free
        y = max_pool_2x2(x.permute(0, 2, 3, 1).contiguous())
        return y.permute(0, 3, 1, 2)


class TorchBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with din_tpu's arithmetic (din_tpu/nn/layers.py:129-176),
    not cuDNN's: statistics in float32 for a bf16 or f32 input (float64
    stays float64), the variance as ``max(E[x^2] - E[x]^2, 0)`` (cuDNN's
    Welford sums differ by a few f32 ulps, enough to flip a later ReLU),
    the running statistics
    updated with momentum 0.1 and the unbiased ``n/(n-1)`` variance, and
    ``y = x*mul + (bias - mean*mul)`` in float32, cast back to the input's
    dtype.  Training mode (``self.training``) normalises with the batch's
    statistics and folds them into the running ones; eval mode uses the
    running ones.  The keys are torch's (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``), so
    torchvision and reference files load by name; ``num_batches_tracked``
    counts the training calls, as torch's does (din_tpu keeps no count and
    exports 0)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N,C,H,W] (any memory format) -> the same shape and dtype."""
        if self.training and _CHUNKS is not None:
            return self._forward_chunks(x, _CHUNKS)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = (0, 2, 3)
            mean = xf.mean(dim=dims)
            var = (xf.square().mean(dim=dims) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                n = x.numel() // x.shape[1]
                self.fold(mean, var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        return self._normalize(x, xf, mean, var)

    def _normalize(self, x, xf, mean, var) -> torch.Tensor:
        mul = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * mul
        y = xf * mul[:, None, None] + shift[:, None, None]
        return y.to(x.dtype)

    @torch.no_grad()
    def fold(self, mean: torch.Tensor, unbiased: torch.Tensor) -> None:
        """One batch's statistics into the running ones (momentum 0.1)."""
        m = 1.0 - self.momentum                # flax's momentum, 0.9
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * unbiased)
        self.num_batches_tracked.add_(1)

    def _forward_chunks(self, x: torch.Tensor,
                        chunks: "ChunkStatistics") -> torch.Tensor:
        """Training mode inside ``chunk_statistics``: the call's frames are
        pieces of the round's frame chunks, which other ranks may share;
        the sums of x and x^2 of each of the round's chunks are all-reduced
        over the ranks, every piece is normalised with its chunk's
        statistics, and those statistics wait in ``chunks`` to be folded in
        chunk order."""
        from din_tpu_torch.parallel.mesh import all_reduce_sum

        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mine = {k: (s, e) for k, s, e in chunks.pieces}
        at = {k: i for i, k in enumerate(chunks.round_chunks)}
        zeros = xf.new_zeros(2, x.shape[1])
        sums = []
        for k in chunks.round_chunks:
            if k in mine:
                s, e = mine[k]
                piece = xf[s:e]
                sums.append(torch.stack([piece.sum(dim=(0, 2, 3)),
                                         piece.square().sum(dim=(0, 2, 3))]))
            else:
                sums.append(zeros)
        total = all_reduce_sum(torch.stack(sums), chunks.group)
        n = chunks.chunk * x.shape[2] * x.shape[3]
        mean = total[:, 0] / n
        var = (total[:, 1] / n - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            for k, i in at.items():
                chunks.pending.setdefault(self, {})[k] = (
                    mean[i].detach(), var[i].detach() * (n / max(n - 1, 1)))
        ys = [self._normalize(x[s:e], xf[s:e], mean[at[k]], var[at[k]])
              for k, s, e in chunks.pieces]
        return ys[0] if len(ys) == 1 else torch.cat(ys)


class ChunkStatistics:
    """The frame chunks of one trunk call spread over ranks (models/
    trunk.py): the ranks that split the frames (``group``), the chunk's
    size in frames, and, for the backbone call in flight, this
    rank's ``pieces`` ((chunk, start, stop) rows of the call's batch) and
    the ``round_chunks`` the call completes on every rank.  BatchNorm
    statistics of finished rounds wait in ``pending`` until ``fold`` folds
    them into the running ones, chunk after chunk in frame order, as din_tpu's
    scan carries them (trunk.py:241-254), so that every rank ends with the
    same running statistics."""

    def __init__(self, group, chunk: int):
        self.group = group
        self.chunk = chunk
        self.pieces = []
        self.round_chunks = []
        self.pending = {}

    def fold(self) -> None:
        for module, stats in self.pending.items():
            for k in sorted(stats):
                module.fold(*stats[k])
        self.pending.clear()


_CHUNKS: Optional[ChunkStatistics] = None


@contextlib.contextmanager
def chunk_statistics(chunks: Optional[ChunkStatistics]):
    """Training-mode ``TorchBatchNorm`` calls in the code it wraps take
    their statistics over ``chunks`` (None: over their own batch)."""
    global _CHUNKS
    prev = _CHUNKS
    _CHUNKS = chunks
    try:
        yield
    finally:
        _CHUNKS = prev


class SeededDropout(nn.Module):
    """flax ``nn.Dropout``: in training, keep each element with probability
    1-p and scale it by 1/(1-p), else 0.  The mask comes from the module's
    own ``torch.Generator`` on the input's device, seeded with ``seed`` at
    first use (JAX draws it from its dropout key, din_tpu/train/engine.py
    :50-51), never from the global RNG state.  The bits differ from JAX's."""

    def __init__(self, p: float, seed: int):
        super().__init__()
        self.p = float(p)
        self.seed = int(seed)
        self.generator = None

    def get_rng_state(self) -> Optional[torch.Tensor]:
        """The generator's state, or None while no mask has been drawn."""
        return None if self.generator is None else self.generator.get_state()

    def set_rng_state(self, state: Optional[torch.Tensor],
                      device: torch.device) -> None:
        """Continue from ``state`` on ``device``; None leaves the generator
        unused, to be seeded at its first mask."""
        if state is None:
            self.generator = None
            return
        self.generator = torch.Generator(device=device)
        self.generator.set_state(state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None or self.generator.device != x.device:
            self.generator = torch.Generator(device=x.device).manual_seed(
                self.seed)
        keep_prob = 1.0 - self.p
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob,
                           torch.zeros((), dtype=x.dtype, device=x.device))
