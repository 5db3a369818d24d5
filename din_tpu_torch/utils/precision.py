"""Full float32 convolutions on the card, whatever the process-wide flags.

cuDNN runs float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps a 10-bit
mantissa.  Where the JAX package asks for ``precision="highest"`` (the DIN
head's offset and affinity convs, din_tpu/heads/din.py:162), and in the
plain versions of kernels that compute in float32, the port wraps the call
in ``ieee_f32_convs()``: it switches TF32 off for the call and restores the
caller's setting afterwards.  It changes no other flag and nothing on the
CPU.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_f32_convs():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved
