"""Operators of the port: plain PyTorch versions and hand-written CUDA kernels.

Importing this package registers the kernels' custom ops
(``din_tpu_torch::roi_align``, ``::roi_align_bwd``, ``::max_pool_2x2``,
``::max_pool_2x2_bwd``, ``::fused_stem``), which a saved
``torch.export`` program of the port names.
"""

from din_tpu_torch.ops import pool, roi_align, stem  # noqa: F401
