"""Presets of the port (copy of din_tpu/experiments/presets.py, the fields
the ported slices read), one for each of din_tpu's.

The flagship, its three variants (``_hierarchical``, ``_multi``,
``_tce``) and ``collective_stage2_dynamic`` start stage 2 from the
stage-1 backbone, as in the JAX package (presets.py:43,50,172), but from a
``.pth`` in the reference's stage-1 component layout, which ``train_net``
writes for a stage-1 preset (the port cannot read the JAX package's msgpack
``.ckpt``).  A missing stage-1 file raises; pass
``load_backbone_stage2=False`` to start from random weights.

The ResNet-18 baselines (``volleyball_stage2_arg``, ``_at``, ``_pctdm``,
``_higcin``, ``_sacrf_biute``) graft ``result/basemodel_VD_res18.pth``, a
ResNet-18 stage 1 on Volleyball: ``volleyball_stage1().replace(
backbone="res18", out_size=(23, 40), emb_features=512)`` through
``train_net`` (its best component file, copied to that name; start it from
a torchvision ResNet-18 file with ``pretrained_backbone_path``), as with
din_tpu's Python API.

``collective_stage1`` is Inception-v3 (its 57x87 Mixed_5d and 28x43
Mixed_6e maps at 480x720, pooled together: ``emb_features`` 1056); start
it from a torchvision Inception-v3 file with ``pretrained_backbone_path``.
A ResNet-18 stage 1 on the Collective Activity dataset, whose file
``collective_stage2_dynamic`` grafts, is ``collective_stage1().replace(
backbone="res18", out_size=(15, 23), emb_features=512)``, as with
din_tpu's Python API.  Any preset takes another of din_tpu's backbones
(``inv3``, ``vgg16``, ``vgg19``, ``res18``, ``res50``, ``alex``) with
``out_size`` its map at the preset's image size and ``emb_features`` its
channels; Inception-v3 at 720x1280 is the ``Config`` default, (87, 157)
and 1056."""

from __future__ import annotations

from typing import Callable, Dict

from din_tpu_torch.config import Config

PRESETS: Dict[str, Callable[[], Config]] = {}


def preset(name):
    def wrap(fn):
        PRESETS[name] = fn
        return fn
    return wrap


@preset("volleyball_stage1")
def volleyball_stage1() -> Config:
    """scripts/train_volleyball_stage1.py:1-36 (VGG16)."""
    return Config("volleyball").replace(
        training_stage=1, train_backbone=True, test_before_train=True,
        backbone="vgg16", image_size=(720, 1280), out_size=(22, 40),
        emb_features=512, num_before=5, num_after=4, batch_size=8,
        test_batch_size=1, num_frames=1,
        train_learning_rate=1e-4, lr_plan={30: 5e-5, 60: 2e-5, 90: 1e-5},
        max_epoch=120,
        actions_weights=[[1., 1., 2., 3., 1., 2., 2., 0.2, 1.]],
        exp_note="Volleyball_stage1")


@preset("volleyball_stage2_dynamic")
def volleyball_stage2_dynamic() -> Config:
    """scripts/train_volleyball_stage2_dynamic.py:1-55 (vgg16, lite 128)."""
    return Config("volleyball").replace(
        inference_module_name="dynamic_volleyball", training_stage=2,
        train_backbone=True, test_before_train=False, test_interval_epoch=1,
        backbone="vgg16",
        stage1_model_path="result/basemodel_VD_vgg16.pth",
        load_backbone_stage2=True, out_size=(22, 40), emb_features=512,
        group=1, stride=1, ST_kernel_size=((3, 3),), dynamic_sampling=True,
        sampling_ratio=[1], lite_dim=128, scale_factor=True, beta_factor=False,
        hierarchical_inference=False, parallel_inference=False,
        train_dropout_prob=0.3, batch_size=2, test_batch_size=1,
        num_frames=10, train_learning_rate=1e-4, lr_plan={11: 1e-5},
        max_epoch=30,
        actions_weights=[[1., 1., 2., 3., 1., 2., 2., 0.2, 1.]],
        exp_note="Dynamic Volleyball_stage2_vgg16_litedim128")


@preset("volleyball_stage2_dynamic_hierarchical")
def volleyball_stage2_dynamic_hier() -> Config:
    """ST-factorised hierarchical DIN (reference README.md:99-105):
    the (1,3) field, then the (3,1) field."""
    return volleyball_stage2_dynamic().replace(
        ST_kernel_size=((1, 3), (3, 1)), hierarchical_inference=True,
        exp_note="Dynamic Volleyball_stage2_hierarchical_ST")


@preset("volleyball_stage2_dynamic_multi")
def volleyball_stage2_dynamic_multi() -> Config:
    """Two interaction fields in parallel, summed (reference
    README.md:102).  din_tpu's preset also sets ``num_DIM=2``, which no
    code reads: the fields are those of ``ST_kernel_size``."""
    return volleyball_stage2_dynamic().replace(
        ST_kernel_size=((1, 3), (3, 1)),
        exp_note="Dynamic Volleyball_stage2_multiDIM")


@preset("volleyball_stage2_dynamic_tce")
def volleyball_stage2_tce() -> Config:
    """scripts/train_volleyball_stage2_dynamic_tce.py: the flagship with
    the TCE context encoder and no lite bottleneck."""
    return volleyball_stage2_dynamic().replace(
        inference_module_name="dynamic_tce_volleyball", lite_dim=None,
        exp_note="Dynamic-TCE Volleyball_stage2")


@preset("volleyball_stage2_arg")
def volleyball_stage2_arg() -> Config:
    """scripts/train_volleyball_stage2_arg.py (res18, frozen backbone, 3
    training frames, the 9-frame 3-crop eval)."""
    return Config("volleyball").replace(
        inference_module_name="arg_volleyball", training_stage=2,
        train_backbone=False, test_before_train=True,
        backbone="res18", stage1_model_path="result/basemodel_VD_res18.pth",
        out_size=(23, 40), emb_features=512,
        batch_size=2, test_batch_size=1, num_frames=3,
        load_backbone_stage2=True, train_learning_rate=1e-4,
        lr_plan={11: 3e-5, 21: 1e-5}, max_epoch=30,
        actions_weights=[[1., 1., 2., 3., 1., 2., 2., 0.2, 1.]],
        exp_note="ARG Volleyball_stage2")


@preset("volleyball_stage2_at")
def volleyball_stage2_at() -> Config:
    """scripts/train_volleyball_stage2_at.py."""
    return Config("volleyball").replace(
        inference_module_name="at_volleyball", training_stage=2,
        train_backbone=True, backbone="res18",
        stage1_model_path="result/basemodel_VD_res18.pth",
        out_size=(23, 40), emb_features=512,
        batch_size=2, test_batch_size=1, num_frames=10,
        load_backbone_stage2=True, train_learning_rate=1e-4,
        lr_plan={11: 3e-5, 21: 1e-5}, max_epoch=30,
        temporal_pooled_first=False,
        actions_weights=[[1., 1., 2., 3., 1., 2., 2., 0.2, 1.]],
        exp_note="AT Volleyball_stage2")


@preset("volleyball_stage2_pctdm")
def volleyball_stage2_pctdm() -> Config:
    """scripts/train_volleyball_stage2_pctdm.py."""
    return Config("volleyball").replace(
        inference_module_name="pctdm_volleyball", training_stage=2,
        train_backbone=True, backbone="res18",
        stage1_model_path="result/basemodel_VD_res18.pth",
        out_size=(23, 40), emb_features=512,
        batch_size=2, test_batch_size=1, num_frames=10,
        load_backbone_stage2=True, train_learning_rate=1e-4,
        lr_plan={11: 3e-5, 21: 1e-5}, max_epoch=30,
        actions_weights=[[1., 1., 2., 3., 1., 2., 2., 0.2, 1.]],
        exp_note="PCTDM Volleyball_stage2")


@preset("volleyball_stage2_higcin")
def volleyball_stage2_higcin() -> Config:
    """scripts/train_volleyball_stage2_higcin.py (crop 7x7)."""
    return Config("volleyball").replace(
        inference_module_name="higcin_volleyball", training_stage=2,
        train_backbone=True, backbone="res18",
        stage1_model_path="result/basemodel_VD_res18.pth",
        out_size=(23, 40), emb_features=512, crop_size=(7, 7),
        batch_size=2, test_batch_size=1, num_frames=10,
        load_backbone_stage2=True, train_learning_rate=3e-5,
        lr_plan={16: 1e-5}, max_epoch=30,
        actions_weights=[[1., 1., 2., 3., 1., 2., 2., 0.2, 1.]],
        exp_note="HiGCIN Volleyball_stage2")


@preset("volleyball_stage2_sacrf_biute")
def volleyball_stage2_sacrf() -> Config:
    """scripts/train_volleyball_stage2_sacrf_biute.py."""
    return Config("volleyball").replace(
        inference_module_name="sacrf_biute_volleyball", training_stage=2,
        train_backbone=True, backbone="res18",
        stage1_model_path="result/basemodel_VD_res18.pth",
        out_size=(23, 40), emb_features=512,
        batch_size=2, test_batch_size=1, num_frames=10,
        load_backbone_stage2=True, train_learning_rate=1e-4,
        lr_plan={11: 3e-5, 21: 1e-5}, max_epoch=30, halting_penalty=1e-4,
        actions_weights=[[1., 1., 2., 3., 1., 2., 2., 0.2, 1.]],
        exp_note="SACRF-BiUTE Volleyball_stage2")


@preset("collective_stage1")
def collective_stage1() -> Config:
    """scripts/train_collective_stage1.py (Inception-v3)."""
    return Config("collective").replace(
        training_stage=1, train_backbone=True, backbone="inv3",
        image_size=(480, 720), out_size=(57, 87), emb_features=1056,
        num_boxes=13, num_actions=5, num_activities=4, num_frames=10,
        batch_size=16, test_batch_size=8, train_learning_rate=1e-4,
        lr_plan={}, max_epoch=100, exp_note="Collective_stage1")


@preset("collective_stage2_dynamic")
def collective_stage2_dynamic() -> Config:
    """scripts/train_collective_stage2_dynamic.py:1-56 (res18)."""
    return Config("collective").replace(
        inference_module_name="dynamic_collective", training_stage=2,
        train_backbone=True, load_backbone_stage2=True,
        backbone="res18", image_size=(480, 720), out_size=(15, 23),
        emb_features=512, stage1_model_path="result/basemodel_CAD_res18.pth",
        num_boxes=13, num_actions=5, num_activities=4, num_frames=10,
        num_graph=4, tau_sqrt=True, batch_size=2, test_batch_size=8,
        test_interval_epoch=1, train_learning_rate=5e-5,
        train_dropout_prob=0.5, weight_decay=1e-4, lr_plan={}, max_epoch=30,
        group=1, stride=1, ST_kernel_size=(3, 3), dynamic_sampling=True,
        sampling_ratio=[1], lite_dim=None, scale_factor=True,
        beta_factor=False, hierarchical_inference=False,
        parallel_inference=False, exp_note="Dynamic_collective")


@preset("synthetic_smoke")
def synthetic_smoke() -> Config:
    """Tiny synthetic end-to-end config (CI / smoke): DynamicVolleyball on
    ResNet-18, f32."""
    return Config("volleyball").replace(
        training_stage=2, inference_module_name="dynamic_volleyball",
        data_path="synthetic", backbone="res18", image_size=(64, 96),
        out_size=(2, 3), emb_features=512, num_frames=4, num_boxes=12,
        num_features_boxes=64, num_features_gcn=64, lite_dim=32,
        ST_kernel_size=((3, 3),), sampling_ratio=[1], beta_factor=False,
        batch_size=4, test_batch_size=4, max_epoch=2, train_backbone=True,
        compute_dtype="float32", exp_note="synthetic_smoke")
