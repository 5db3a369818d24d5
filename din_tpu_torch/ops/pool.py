"""2x2 stride-2 max-pool on NHWC maps: kernel K2 and its plain version.

Port of din_tpu/ops/pool.py.  The TPU kernel (``_fwd_kernel``, launched by
``_pallas_fwd_call``) pooled a column-folded [F,H,W/2,2c] layout that exists
only for the TPU's 128-lane vregs; here the map is the canonical NHWC map,
which is what a ``channels_last`` conv output is in memory.  Floor mode: an
odd last row or column is dropped, like torch ``MaxPool2d`` (the JAX fold
pool asserts even H, pool.py:157; VGG pool5 sees 45 rows at 720x1280).

``max_pool_2x2`` on a CPU tensor runs ``max_pool_2x2_ref``; on a CUDA tensor
it launches the hand-written kernel (csrc/max_pool_2x2.cu) or raises.
"""

from __future__ import annotations

import torch

from din_tpu_torch.ops import native


def max_pool_2x2_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: [F,H,W,C] -> [F,H//2,W//2,C], floor mode."""
    F, H, W, C = x.shape
    OH, OW = H // 2, W // 2
    x = x[:, :2 * OH, :2 * OW]
    return x.reshape(F, OH, 2, OW, 2, C).amax(dim=(2, 4))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool of an NHWC map [F,H,W,C] (f32 or bf16) ->
    [F,H//2,W//2,C].  Counts its kernel launches in ``max_pool_2x2.launches``.
    """
    if x.device.type == "cpu":
        return max_pool_2x2_ref(x)
    native.require_cuda_input(x, "x", (torch.float32, torch.bfloat16), 4)
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


max_pool_2x2.launches = 0
