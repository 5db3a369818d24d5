"""Masked reductions for variable actor counts (port of
din_tpu/utils/masking.py).

The reference loops over the clips of a batch and slices each one's true
actor count (base_model.py:258-276, infer_model.py:1286-1314); the JAX
package and the port pad every frame to MAX_N actors and mask instead, which
gives the same numbers for one fixed-shape batch.
"""

from __future__ import annotations

import torch


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """max over ``dim`` counting only cells where ``mask`` (broadcastable to
    x) is True; 0 where a slot has no valid cell."""
    lowest = torch.finfo(x.dtype).min if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    filled = torch.where(mask, x, torch.full((), lowest, dtype=x.dtype,
                                             device=x.device))
    out = filled.amax(dim=dim)
    any_valid = mask.any(dim=dim)
    return torch.where(any_valid, out, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim) -> torch.Tensor:
    """mean over ``dim`` of the cells where ``mask`` is True (0 where a slot
    has none)."""
    num = torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device)).sum(dim=dim)
    den = mask.to(x.dtype).sum(dim=dim).clamp_min(1)
    return num / den


def mask_actors(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the features of padded actors (mask broadcastable to x)."""
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
