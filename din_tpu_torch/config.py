"""Experiment configuration of the port.

A copy of the fields of din_tpu/config.py ``Config`` that the serving slice
reads, with the same names, defaults and meanings (reference config.py:5-116).
Training, data-path and TPU-only knobs are left out; they join as the slices
that read them are ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Config:
    """Knobs of the serving slice; semantics follow reference config.py."""

    dataset_name: str = "volleyball"

    # geometry (reference config.py:12-15)
    image_size: Tuple[int, int] = (720, 1280)       # input image H, W
    num_boxes: int = 12                             # actors per frame

    # backbone (reference config.py:36-41)
    backbone: str = "res18"
    crop_size: Tuple[int, int] = (5, 5)             # RoIAlign K x K
    train_backbone: bool = False
    out_size: Tuple[int, int] = (87, 157)           # feature map OH, OW
    emb_features: int = 1056                        # backbone channels D

    # classes (reference config.py:44-45)
    num_actions: int = 9
    num_activities: int = 8

    num_frames: int = 3                             # T
    num_features_boxes: int = 1024                  # NFB

    train_random_seed: int = 0
    train_dropout_prob: float = 0.3
    training_stage: int = 1
    inference_module_name: str = "dynamic_volleyball"

    # Dynamic Inference / DIN (reference config.py:83-97)
    stride: int = 1
    ST_kernel_size: Any = ((3, 3),)
    dynamic_sampling: bool = True
    sampling_ratio: Sequence[int] = (1, 3)
    group: int = 1
    scale_factor: bool = True
    beta_factor: bool = True
    parallel_inference: bool = False
    hierarchical_inference: bool = False
    lite_dim: Optional[int] = None

    # dtype of the backbone's convolutions; the head runs in float32
    compute_dtype: str = "bfloat16"
    frame_chunk: Optional[int] = None    # frames per backbone micro-batch

    def __post_init__(self):
        if self.dataset_name not in ("volleyball", "collective"):
            raise ValueError(f"unknown dataset {self.dataset_name!r}")

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    @property
    def kernel_sizes(self) -> List[Tuple[int, int]]:
        """ST_kernel_size normalised to a list of (kh, kw): the reference
        accepts a list of tuples and a bare tuple."""
        ks = self.ST_kernel_size
        if isinstance(ks, int):
            return [(ks, ks)]
        ks = tuple(ks)
        if len(ks) == 2 and all(isinstance(v, int) for v in ks):
            return [tuple(ks)]
        return [tuple(k) for k in ks]
