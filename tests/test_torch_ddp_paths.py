"""Every trainable parameter of each of the 18 training paths
(``experiments/determinism.py`` ``path_configs``) gets a gradient from one
step's loss, on the CPU at a small geometry: so ``train/engine.py``
``wrap_model`` wraps them in ``DistributedDataParallel`` with
``find_unused_parameters=False`` (which raises at the next step on a
parameter the backward left without a gradient) and none needs the search.

Geometry: 64x96 frames (AlexNet at 96x128, Inception-v3 at 160x224: a
first map of at least 2x3, which the RoIs hit), 2 frames, 1 clip, narrow
heads (64 box features, 64-wide GCNs), float32; ``out_size``
is the backbone's first map, as the presets' is.
"""

import functools

import numpy as np
import pytest
import torch

from din_tpu_torch.data.loader import to_device
from din_tpu_torch.data.synthetic import make_synthetic_batch
from din_tpu_torch.experiments.determinism import path_configs
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.backbones import BACKBONES
from din_tpu_torch.ops.image import prep_images
from din_tpu_torch.train.losses import compute_losses
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
PATHS = path_configs()
# frames whose first map is at least 2x3, so that the RoIs hit it
SIZES = {"inv3": (160, 224), "alex": (96, 128)}


@functools.lru_cache(maxsize=None)
def first_map(backbone: str, H: int, W: int) -> tuple:
    """The (height, width) of the backbone's first map at H x W."""
    net = BACKBONES[backbone](torch.Generator().manual_seed(0))
    with torch.no_grad():
        maps = net(prep_images(torch.zeros(1, H, W, 3, dtype=torch.uint8),
                               torch.float32))
    first = maps[0] if isinstance(maps, list) else maps
    return tuple(first.shape[1:3])


def small(cfg):
    H, W = SIZES.get(cfg.backbone, (64, 96))
    return cfg.replace(image_size=(H, W), num_frames=2, batch_size=1,
                       num_features_boxes=64, num_features_gcn=64,
                       num_features_relation=32, num_graph=4,
                       compute_dtype="float32",
                       out_size=first_map(cfg.backbone, H, W))


def test_there_are_18_paths():
    assert len(PATHS) == 18


@pytest.mark.parametrize("name", sorted(PATHS))
def test_every_trainable_parameter_gets_a_gradient(name):
    cfg = small(PATHS[name])
    model = build_model(cfg, device=CPU).train()
    batch = to_device(make_synthetic_batch(
        cfg, 1, rng=np.random.RandomState(0)), CPU)
    out = model(batch["images"], batch["boxes"], batch.get("bboxes_num"))
    compute_losses(out, batch, cfg, cfg.training_stage == 2)["loss"] \
        .backward()
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert trainable
    assert [n for n, p in model.named_parameters()
            if p.requires_grad and p.grad is None] == []
