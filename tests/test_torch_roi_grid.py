"""The sample grid that kernel K1 (din_tpu_torch/csrc/roi_align.cu) computes
from the boxes itself, emulated in numpy float32, against the plain
version's ``_sample_grid`` (din_tpu_torch/ops/roi_align.py), on the CPU.

The kernel computes, per box side, ``bin = (hi - lo) / k`` and
``c_i = lo + (i + 0.5) * bin - 0.5`` with one rounding per operation
(``__fsub_rn``, ``__fdiv_rn``, ``__fmul_rn``, ``__fadd_rn``) in that order.
numpy's float32 arithmetic rounds each operation once and never fuses, so
the emulation below is that arithmetic; it must equal ``_sample_grid`` bit
for bit, or the kernel and the plain version disagree on which samples lie
in range at the map border.  The card runs the same IEEE operations.
"""

import numpy as np
import pytest
import torch

from chip_smoke import edge_boxes
from din_tpu_torch.ops.roi_align import _sample_grid


def _kernel_grid(boxes: np.ndarray, crop):
    """The kernel's sample centres (ys [..., KH], xs [..., KW]), op by op."""
    f32 = np.float32
    out = []
    for lo, hi, k in ((boxes[..., 1], boxes[..., 3], crop[0]),
                      (boxes[..., 0], boxes[..., 2], crop[1])):
        bin_ = (hi - lo) / f32(k)
        i = np.arange(k, dtype=f32)
        off = (i + f32(0.5)) * bin_[..., None]
        out.append((lo[..., None] + off) - f32(0.5))
    return out


def _fma_grid(boxes: np.ndarray, crop):
    """The same centres with ``lo + (i + 0.5) * bin`` contracted into one
    fused multiply-add (exact product, one rounding), as nvcc's default
    ``--fmad=true`` would compile the plain expression."""
    out = []
    for lo, hi, k in ((boxes[..., 1], boxes[..., 3], crop[0]),
                      (boxes[..., 0], boxes[..., 2], crop[1])):
        bin_ = ((hi - lo) / np.float32(k)).astype(np.float64)
        i = np.arange(k, dtype=np.float64) + 0.5
        fused = (lo.astype(np.float64)[..., None]
                 + i * bin_[..., None]).astype(np.float32)
        out.append(fused - np.float32(0.5))
    return out


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _boxes(kind: str) -> np.ndarray:
    if kind == "edge":
        gen = torch.Generator().manual_seed(0)
        return edge_boxes(20, 12, 22, 40, gen).numpy()
    rng = np.random.RandomState(7)
    xy = rng.uniform(-8, 48, size=(64, 12, 2)).astype(np.float32)
    wh = rng.exponential(6.0, size=(64, 12, 2)).astype(np.float32)
    wh[:, :2] = -wh[:, :2]                   # negative extents
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("crop", [(5, 5), (3, 7)])
@pytest.mark.parametrize("kind", ["edge", "random"])
def test_kernel_grid_arithmetic_equals_sample_grid(kind, crop):
    """Random boxes (some with negative extents) and chip_smoke's edge
    boxes (on the border, partly and fully outside the map, zero-area):
    the kernel's op-by-op centres equal ``_sample_grid``'s bit for bit."""
    boxes = _boxes(kind)
    ys, xs = _sample_grid(torch.from_numpy(boxes), crop)
    kys, kxs = _kernel_grid(boxes, crop)
    assert kys.shape == tuple(ys.shape) and kxs.shape == tuple(xs.shape)
    assert np.array_equal(_bits(kys), _bits(ys.numpy()))
    assert np.array_equal(_bits(kxs), _bits(xs.numpy()))


def test_fused_multiply_add_would_move_centres():
    """The order is not free: with the product and the sum fused into one
    FMA, some centres of the random boxes land on another float32 value,
    which is why the kernel rounds each operation on its own."""
    boxes = _boxes("random")
    ys, xs = _sample_grid(torch.from_numpy(boxes), (5, 5))
    fys, fxs = _fma_grid(boxes, (5, 5))
    moved = int((_bits(fys) != _bits(ys.numpy())).sum()
                + (_bits(fxs) != _bits(xs.numpy())).sum())
    assert moved > 0
