"""Model registry (port of din_tpu/models/registry.py).  Stage 1 builds the
dataset's Basenet, stage 2 the ``inference_module_name`` model, as the
reference's trainer dispatches (train_net_dynamic.py:75-93); every stage-2
model of din_tpu's registry is here.  Every model takes
``model(images, boxes, bboxes_num)``; the volleyball models ignore the
count, the collective ones mask the padded actors with it."""

from __future__ import annotations

from typing import Optional

import torch

from din_tpu_torch.models.base import BasenetCollective, BasenetVolleyball
from din_tpu_torch.models.baselines import (ARGVolleyball, ATVolleyball,
                                            GCNNetCollective,
                                            GCNNetVolleyball,
                                            HiGCINVolleyball,
                                            PCTDMVolleyball,
                                            SACRFBiUTEVolleyball)
from din_tpu_torch.models.dynamic import (DynamicCollective,
                                          DynamicTCEVolleyball,
                                          DynamicVolleyball)
from din_tpu_torch.utils.device import resolve_device

BASENET_MODELS = {"volleyball": BasenetVolleyball,
                  "collective": BasenetCollective}
STAGE2_MODELS = {"dynamic_volleyball": DynamicVolleyball,
                 "dynamic_tce_volleyball": DynamicTCEVolleyball,
                 "dynamic_collective": DynamicCollective,
                 "pctdm_volleyball": PCTDMVolleyball,
                 "higcin_volleyball": HiGCINVolleyball,
                 "at_volleyball": ATVolleyball,
                 "arg_volleyball": ARGVolleyball,
                 "sacrf_biute_volleyball": SACRFBiUTEVolleyball,
                 "gcnnet_volleyball": GCNNetVolleyball,
                 "gcnnet_collective": GCNNetCollective}


def build_model(cfg, device=None,
                generator: Optional[torch.Generator] = None):
    """Builds the model of ``cfg`` with random weights drawn from
    ``generator`` (seeded from ``cfg.train_random_seed`` by default) and
    puts it on ``device`` (default: the card), in eval mode."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train_random_seed)
    if cfg.training_stage == 1:
        model = BASENET_MODELS[cfg.dataset_name](cfg, generator)
    elif cfg.training_stage == 2:
        name = cfg.inference_module_name
        if name not in STAGE2_MODELS:
            raise ValueError(f"unknown model {name!r}")
        model = STAGE2_MODELS[name](cfg, generator)
    else:
        raise ValueError(f"unknown training stage {cfg.training_stage}")
    return model.to(device).eval()
