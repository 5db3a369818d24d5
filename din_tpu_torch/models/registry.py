"""Model registry (port of din_tpu/models/registry.py).  Only the serving
slice's model is ported; the others name the ROADMAP.md slice that brings
them."""

from __future__ import annotations

from typing import Optional

import torch

from din_tpu_torch.models.dynamic import DynamicVolleyball

STAGE2_MODELS = {"dynamic_volleyball": DynamicVolleyball}

_SLICE_OF = {
    "dynamic_collective": "ResNet-18 with BN and the collective path "
                          "(slice 3)",
    "dynamic_tce_volleyball": "the remaining heads (slice 5)",
    "pctdm_volleyball": "the remaining heads (slice 5)",
    "higcin_volleyball": "the remaining heads (slice 5)",
    "at_volleyball": "the remaining heads (slice 5)",
    "arg_volleyball": "the remaining heads (slice 5)",
    "sacrf_biute_volleyball": "the remaining heads (slice 5)",
    "gcnnet_volleyball": "the remaining heads (slice 5)",
    "gcnnet_collective": "the remaining heads (slice 5)",
}


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; din_tpu_torch runs on the "
                           "card and takes device='cpu' only when asked")
    return device


def build_model(cfg, device=None,
                generator: Optional[torch.Generator] = None):
    """Builds the model of ``cfg`` with random weights drawn from
    ``generator`` (seeded from ``cfg.train_random_seed`` by default) and
    puts it on ``device`` (default: the card), in eval mode."""
    device = resolve_device(device)
    if cfg.training_stage == 1:
        raise NotImplementedError("stage-1 models come with stage 1, slice 2 "
                                  "of ROADMAP.md")
    name = cfg.inference_module_name
    if name not in STAGE2_MODELS:
        if name in _SLICE_OF:
            raise NotImplementedError(
                f"model {name!r} is not ported yet: it comes with "
                f"{_SLICE_OF[name]} of ROADMAP.md")
        raise ValueError(f"unknown model {name!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train_random_seed)
    model = STAGE2_MODELS[name](cfg, generator)
    return model.to(device).eval()
