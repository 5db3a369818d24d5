"""2x2 stride-2 max-pool on NHWC maps: kernels K2 (forward) and K2b
(backward), their plain versions, and the custom ops
``din_tpu_torch::max_pool_2x2`` and ``din_tpu_torch::max_pool_2x2_bwd``
around them.

Port of din_tpu/ops/pool.py.  The TPU kernels (``_fwd_kernel`` and
``_bwd_kernel``, launched by ``_pallas_fwd_call`` and ``_fp_bwd``) pooled a
column-folded [F,H,W/2,2c] layout that exists only for the TPU's 128-lane
vregs; here the map is the canonical NHWC map, which is what a
``channels_last`` conv output is in memory.  Floor mode: an odd last row or
column is dropped, like torch ``MaxPool2d`` (the JAX fold pool asserts even
H, pool.py:157; VGG pool5 sees 45 rows at 720x1280), and gets 0 gradient.

The gradient goes to the first argmax of each window in row-major order, as
the JAX custom VJP routes it (pool.py:57-74, and ``_fold_pool_xla``
:143-150): within a row the first column wins a tie, between rows the first
row.  Autograd of ``amax`` would split a tie evenly instead, and after ReLU
and bf16 rounding ties are common, so the backward is its own op on both
devices; like the JAX VJP the forward op's registered autograd saves the
pool's input, not indices.

Each op's CUDA implementation is its launcher (``_pool_fwd``,
``max_pool_2x2_bwd``: csrc/max_pool_2x2.cu, csrc/max_pool_2x2_bwd.cu), its
CPU implementation the plain version; no other device is registered, and
the fake implementation gives the output's shape, dtype and strides (as
``ops/roi_align.py`` explains).  Only a launcher counts.
``max_pool_2x2`` on a CPU tensor runs the plain version; on a CUDA tensor
it launches the kernel or raises; any other device raises.
``max_pool_2x2_bwd`` called directly does the same.
"""

from __future__ import annotations

import torch

from din_tpu_torch.ops import native

_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def max_pool_2x2_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: [F,H,W,C] -> [F,H//2,W//2,C], floor mode."""
    F, H, W, C = x.shape
    OH, OW = H // 2, W // 2
    x = x[:, :2 * OH, :2 * OW]
    return x.reshape(F, OH, 2, OW, 2, C).amax(dim=(2, 4))


def max_pool_2x2_bwd_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K2b: x [F,H,W,C] the pool's input, g [F,H//2,W//2,C]
    -> dx [F,H,W,C] in g's dtype.  The column pair first, then the row pair
    with the first row winning a tie, with ``>=`` masks in the order of
    ``_fold_pool_xla`` (din_tpu/ops/pool.py:143-150)."""
    F, H, W, C = x.shape
    OH, OW = H // 2, W // 2
    w = x[:, :2 * OH, :2 * OW].reshape(F, OH, 2, OW, 2, C)
    a0, b0 = w[:, :, 0, :, 0], w[:, :, 0, :, 1]
    a1, b1 = w[:, :, 1, :, 0], w[:, :, 1, :, 1]
    m0 = a0 >= b0                                     # column winner, row 0
    m1 = a1 >= b1                                     # column winner, row 1
    mrow = torch.maximum(a0, b0) >= torch.maximum(a1, b1)   # ties: row 0
    zero = torch.zeros((), dtype=g.dtype)
    g0 = torch.where(mrow, g, zero)
    g1 = torch.where(mrow, zero, g)
    row0 = torch.stack([torch.where(m0, g0, zero), torch.where(m0, zero, g0)],
                       dim=3)                         # [F,OH,OW,2,C]
    row1 = torch.stack([torch.where(m1, g1, zero), torch.where(m1, zero, g1)],
                       dim=3)
    dx = torch.zeros((F, H, W, C), dtype=g.dtype, device=g.device)
    dx[:, :2 * OH, :2 * OW] = torch.stack([row0, row1], dim=2).reshape(
        F, 2 * OH, 2 * OW, C)
    return dx


def _pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """K2's launcher, the CUDA implementation of the op."""
    native.require_cuda_input(x, "x", _FLOAT_TYPES, 4)
    F, H, W, C = x.shape
    y = torch.empty((F, H // 2, W // 2, C), dtype=x.dtype, device=x.device)
    lib = native.library()
    with torch.cuda.device(x.device):
        code = lib.din_max_pool_2x2(
            x.data_ptr(), y.data_ptr(), F, H, W, C,
            native.dtype_code(x.dtype), native.current_stream(x))
    native.check(code, "max_pool_2x2")
    max_pool_2x2.launches += 1
    return y


def max_pool_2x2_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient of ``max_pool_2x2`` at x for the output gradient g
    [F,H//2,W//2,C] -> [F,H,W,C] in g's dtype.  K2b's launcher, the CUDA
    implementation of ``din_tpu_torch::max_pool_2x2_bwd``; called directly,
    a CPU x runs the plain version.  A CUDA g that is not NHWC-
    contiguous (a conv's dgrad may return another layout) is copied to it
    first, counted in ``max_pool_2x2_bwd.g_copies``.  Counts its kernel
    launches in ``max_pool_2x2_bwd.launches``."""
    if x.device.type == "cpu":
        return max_pool_2x2_bwd_ref(x, g)
    native.require_cuda_input(x, "x", _FLOAT_TYPES, 4)
    F, H, W, C = x.shape
    if g.shape != (F, H // 2, W // 2, C) or g.dtype != x.dtype:
        raise ValueError(f"g must be {(F, H // 2, W // 2, C)} {x.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if not g.is_contiguous():
        g = g.contiguous()
        max_pool_2x2_bwd.g_copies += 1
    native.require_cuda_input(g, "g", _FLOAT_TYPES, 4)
    if g.numel() == 0:
        return torch.zeros_like(x)
    dx = torch.empty_like(x)
    lib = native.library()
    with torch.cuda.device(x.device):
        code = lib.din_max_pool_2x2_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), F, H, W, C,
            native.dtype_code(x.dtype), native.current_stream(x))
    native.check(code, "max_pool_2x2_bwd")
    max_pool_2x2_bwd.launches += 1
    return dx


_pool_op = torch.library.custom_op(
    "din_tpu_torch::max_pool_2x2", _pool_fwd, mutates_args=(),
    device_types="cuda", schema="(Tensor x) -> Tensor")
_pool_op.register_kernel("cpu", max_pool_2x2_ref)
_pool_bwd_op = torch.library.custom_op(
    "din_tpu_torch::max_pool_2x2_bwd", max_pool_2x2_bwd, mutates_args=(),
    device_types="cuda", schema="(Tensor x, Tensor g) -> Tensor")
_pool_bwd_op.register_kernel("cpu", max_pool_2x2_bwd_ref)


@_pool_op.register_fake
def _(x):
    F, H, W, C = x.shape
    return x.new_empty((F, H // 2, W // 2, C))


@_pool_bwd_op.register_fake
def _(x, g):
    return torch.empty_like(x, dtype=g.dtype,
                            memory_format=torch.contiguous_format)


def _pool_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _pool_backward(ctx, g):
    """K2b at the saved input."""
    (x,) = ctx.saved_tensors
    return torch.ops.din_tpu_torch.max_pool_2x2_bwd(x, g)


_pool_op.register_autograd(_pool_backward, setup_context=_pool_setup)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool of an NHWC map [F,H,W,C] (f32 or bf16) ->
    [F,H//2,W//2,C], differentiable with first-argmax routing.  Counts its
    forward kernel launches in ``max_pool_2x2.launches``."""
    if x.device.type != "cpu":
        native.require_cuda_input(x, "x", _FLOAT_TYPES, 4)
    return torch.ops.din_tpu_torch.max_pool_2x2(x)


max_pool_2x2.launches = 0
max_pool_2x2_bwd.launches = 0
max_pool_2x2_bwd.g_copies = 0
