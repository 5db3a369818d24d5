"""Presets of the port (copy of din_tpu/experiments/presets.py, the fields
the serving and training slices read).  Other presets join with their
models."""

from __future__ import annotations

from typing import Callable, Dict

from din_tpu_torch.config import Config

PRESETS: Dict[str, Callable[[], Config]] = {}


def preset(name):
    def wrap(fn):
        PRESETS[name] = fn
        return fn
    return wrap


@preset("volleyball_stage2_dynamic")
def volleyball_stage2_dynamic() -> Config:
    """scripts/train_volleyball_stage2_dynamic.py:1-55 (vgg16, lite 128)."""
    return Config("volleyball").replace(
        inference_module_name="dynamic_volleyball", training_stage=2,
        train_backbone=True, test_interval_epoch=1, backbone="vgg16",
        out_size=(22, 40), emb_features=512, group=1, stride=1,
        ST_kernel_size=((3, 3),), dynamic_sampling=True, sampling_ratio=[1],
        lite_dim=128, scale_factor=True, beta_factor=False,
        hierarchical_inference=False, parallel_inference=False,
        train_dropout_prob=0.3, batch_size=2, test_batch_size=1,
        num_frames=10, train_learning_rate=1e-4, lr_plan={11: 1e-5},
        max_epoch=30,
        actions_weights=[[1., 1., 2., 3., 1., 2., 2., 0.2, 1.]],
        exp_note="Dynamic Volleyball_stage2_vgg16_litedim128")
