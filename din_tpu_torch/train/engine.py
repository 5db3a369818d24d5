"""Training loop of the port, stages 1 and 2 (port of din_tpu/train/
engine.py: ``make_train_step`` :75-119, ``make_eval_step``, ``_epoch_info``
:224-250, the weight loading of ``setup_training`` :355-421, the loaders of
``train_net`` :308-321, its ``eval_only`` and ``test_before_train`` passes
:530-550 and its epoch loop :555-645), on one device.

The data come from ``data/datasets.py`` ``return_dataset`` (synthetic clips
or a Volleyball or Collective Activity tree on disk, or its packed store),
batched by ``BatchLoader`` on ``cfg.num_workers`` decode threads and put on
the device ``cfg.prefetch_depth`` batches ahead of the step by
``prefetch_to_device``.

A step is forward (``model(images, boxes, bboxes_num)``: the collective
models mask padded actors with the count, as din_tpu's ``apply`` passes
``bboxes_num``, engine.py:95-103), loss (``compute_losses``; stage 1 takes
per-frame labels, stage 2 frame 0's), backward and one Adam update; a
backbone with BatchNorm updates its running statistics in the forward. Each
epoch sets the lr of the plan, pins the loader's shuffle epoch, takes its
steps (at most ``max_steps_per_epoch``), reports the epoch, and every
``test_interval_epoch`` epochs runs an eval pass and tracks the best
accuracy. Stage 2 then writes one checkpoint
``stage2_epoch{E}_{acc:.2f}%.pth``; stage 1 writes its component file
``stage1_epoch{E}_{acc:.2f}%.pth`` when the accuracy is the best so far or
ties it. ``cfg.test_before_train`` adds an eval pass logged at epoch 0
before the first epoch; ``cfg.eval_only`` runs one eval pass on the loaded
weights, logged at the start epoch - 1, returns its info and neither trains
nor writes a file. Stage 2 starts from a stage-1 file
(``cfg.load_backbone_stage2``, ``cfg.stage1_model_path``: backbone and
``fc_emb`` grafted) or else resumes a stage-2 checkpoint
(``cfg.stage2model``: params, Adam state, epoch), BatchNorm statistics
included in both; stage 1 may start from a torchvision VGG-16 or ResNet-18
file (``cfg.pretrained_backbone_path``, BatchNorm statistics included);
either may start from a reference ``.pth`` (``cfg.ref_checkpoint_path``) and
adopt its Adam state (``cfg.ref_resume_optimizer``).

Not ported: preemption and resume of a partial epoch, gradient
accumulation, the profiler hook, the MAD diagnostic (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from din_tpu_torch.data.datasets import return_dataset
from din_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from din_tpu_torch.models.registry import build_model, resolve_device
from din_tpu_torch.nn.ref_import import (load_pretrained_backbone,
                                         load_reference_checkpoint,
                                         load_reference_optimizer)
from din_tpu_torch.train.checkpoint import (load_backbone_stage2, load_state,
                                            save_stage1_components,
                                            save_state)
from din_tpu_torch.train.losses import compute_losses
from din_tpu_torch.train.optim import (lr_for_epoch, make_optimizer,
                                       set_learning_rate)
from din_tpu_torch.utils.logging import print_log, show_config, show_epoch_info
from din_tpu_torch.utils.meters import MPCA, Timer


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """One update on a batch already on the model's device; returns the
    detached metrics (still on the device: reading them waits for it)."""
    model.train()
    out = model(batch["images"], batch["boxes"], batch.get("bboxes_num"))
    metrics = compute_losses(out, batch, cfg, cfg.training_stage == 2)
    optimizer.zero_grad(set_to_none=True)
    metrics["loss"].backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
              cfg) -> Dict[str, torch.Tensor]:
    model.eval()
    out = model(batch["images"], batch["boxes"], batch.get("bboxes_num"))
    return compute_losses(out, batch, cfg, cfg.training_stage == 2)


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in metrics.items()}


def epoch_info(metric_list: List[Dict[str, np.ndarray]], epoch: int,
               elapsed: float, num_activities: int,
               clips: Optional[int] = None) -> Dict:
    """Mean loss, accuracy, confusion and MPCA over an epoch's steps."""
    conf = np.zeros((num_activities, num_activities), np.int64)
    loss_sum, n = 0.0, 0
    act_c = act_t = actn_c = actn_t = 0
    for m in metric_list:
        conf += m["activities_conf"].astype(np.int64)
        loss_sum += float(m["loss"])
        n += 1
        act_c += int(m["activities_correct"])
        act_t += int(m["activities_total"])
        if "actions_correct" in m:
            actn_c += int(m["actions_correct"])
            actn_t += int(m["actions_total"])
    info = {
        "epoch": epoch,
        "time": elapsed,
        "loss": loss_sum / max(n, 1),
        "activities_acc": 100.0 * act_c / max(act_t, 1),
        "activities_conf": conf,
        "activities_MPCA": MPCA(np.maximum(conf, 0) + (conf.sum() == 0)),
    }
    if actn_t:
        info["actions_acc"] = 100.0 * actn_c / max(actn_t, 1)
    if clips and elapsed > 0:
        info["clips_per_sec"] = clips / elapsed
    return info


def setup_training(cfg, device=None):
    """(model, optimizer, start_epoch) for ``cfg`` on ``device`` (default:
    the card), loading weights in the JAX package's order
    (din_tpu/train/engine.py:358-421) and logging each load to
    ``cfg.log_path``: random weights from ``cfg.train_random_seed``; then a
    reference ``.pth`` (``cfg.ref_checkpoint_path``); then in stage 2 the
    backbone and ``fc_emb_1`` of ``cfg.stage1_model_path`` when
    ``cfg.load_backbone_stage2`` is set, else the state of
    ``cfg.stage2model`` when ``cfg.load_stage2model`` is set; in stage 1 a
    pretrained backbone (``cfg.pretrained_backbone_path``); last, with
    ``cfg.ref_resume_optimizer``, the reference file's Adam state, resuming
    at its epoch + 1."""
    device = resolve_device(device)
    model = build_model(cfg, device=device)
    start_epoch = 1
    if cfg.ref_checkpoint_path:
        skipped = load_reference_checkpoint(model, cfg.ref_checkpoint_path)
        print_log(cfg.log_path, "Loaded reference checkpoint %s (%d keys "
                  "skipped)" % (cfg.ref_checkpoint_path, len(skipped)))
    optimizer = make_optimizer(cfg, model)
    if cfg.training_stage == 2:
        if cfg.load_backbone_stage2 and cfg.stage1_model_path:
            load_backbone_stage2(model, cfg.stage1_model_path)
            print_log(cfg.log_path,
                      "Loaded stage1 backbone: " + cfg.stage1_model_path)
        elif cfg.load_stage2model and cfg.stage2model:
            start_epoch = load_state(cfg.stage2model, model, optimizer) + 1
            print_log(cfg.log_path, "Loading stage2 model: %s (resuming at "
                      "epoch %d)" % (cfg.stage2model, start_epoch))
        else:
            print_log(cfg.log_path, "Not loading stage1 or stage2 model.")
    elif cfg.pretrained_backbone_path:
        load_pretrained_backbone(model, cfg.pretrained_backbone_path)
        print_log(cfg.log_path, "Loaded pretrained backbone: "
                  + cfg.pretrained_backbone_path)
    if cfg.ref_checkpoint_path and cfg.ref_resume_optimizer:
        start_epoch = load_reference_optimizer(
            model, optimizer, cfg.ref_checkpoint_path, cfg) + 1
        print_log(cfg.log_path, "Adopted reference optimizer state "
                  "(resuming at epoch %d)" % start_epoch)
    return model, optimizer, start_epoch


def run_eval(model, loader: BatchLoader, cfg, epoch: int,
             device: torch.device) -> Dict:
    timer = Timer()
    metrics = [_to_host(eval_step(model, b, cfg)) for b in
               prefetch_to_device(loader, device, cfg.prefetch_depth)]
    return epoch_info(metrics, epoch, timer.timeit(), cfg.num_activities)


def train_net(cfg, max_steps_per_epoch: Optional[int] = None,
              device=None) -> Dict:
    """Full training loop of either stage (reference train_net.py:28-137).
    Returns the best eval info, with the path of the last file written under
    ``"checkpoint"``; with ``cfg.eval_only`` the info of its eval pass."""
    device = resolve_device(device)
    cfg.init_config()
    show_config(cfg)
    training_set, validation_set = return_dataset(cfg)
    train_loader = BatchLoader(training_set, cfg.batch_size, shuffle=True,
                               num_workers=cfg.num_workers,
                               seed=cfg.train_random_seed)
    # remainder eval batches are padded (cycled) and masked
    val_loader = BatchLoader(validation_set, cfg.test_batch_size,
                             shuffle=False, num_workers=cfg.num_workers,
                             drop_last=False, pad_last=True)
    model, optimizer, start_epoch = setup_training(cfg, device)

    if cfg.eval_only:
        info = run_eval(model, val_loader, cfg, start_epoch - 1, device)
        show_epoch_info("Test", cfg.log_path, info)
        return info
    if cfg.test_before_train:
        show_epoch_info("Test", cfg.log_path,
                        run_eval(model, val_loader, cfg, 0, device))

    best = {"epoch": 0, "activities_acc": 0.0}
    for epoch in range(start_epoch, start_epoch + cfg.max_epoch):
        if epoch in cfg.lr_plan:
            print_log(cfg.log_path,
                      "change learning rate: %g" % cfg.lr_plan[epoch])
        set_learning_rate(optimizer, lr_for_epoch(cfg, epoch))
        train_loader.set_epoch(epoch)
        timer = Timer()
        metrics = []
        for i, batch in enumerate(prefetch_to_device(
                train_loader, device, cfg.prefetch_depth)):
            metrics.append(train_step(model, optimizer, batch, cfg))
            if max_steps_per_epoch and i + 1 >= max_steps_per_epoch:
                break
        metrics = [_to_host(m) for m in metrics]     # waits for the device
        info = epoch_info(metrics, epoch, timer.timeit(), cfg.num_activities,
                          clips=len(metrics) * cfg.batch_size)
        show_epoch_info("Train", cfg.log_path, info)

        if epoch % cfg.test_interval_epoch == 0:
            test_info = run_eval(model, val_loader, cfg, epoch, device)
            show_epoch_info("Test", cfg.log_path, test_info)
            if test_info["activities_acc"] > best["activities_acc"]:
                best = test_info
            print_log(cfg.log_path,
                      "Best group activity accuracy: %.2f%% at epoch #%d."
                      % (best["activities_acc"], best["epoch"]))
            name = "stage%d_epoch%d_%.2f%%.pth" % (
                cfg.training_stage, epoch, test_info["activities_acc"])
            path = os.path.join(cfg.result_path, name)
            if cfg.training_stage == 2:
                save_state(path, epoch, model, optimizer)
            elif test_info["activities_acc"] == best["activities_acc"]:
                save_stage1_components(path, model)
            else:
                continue
            best["checkpoint"] = path
            print_log(cfg.log_path, "model saved to: " + path)
    return best
