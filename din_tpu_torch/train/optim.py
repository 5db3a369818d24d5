"""Optimizer and learning-rate plan (port of din_tpu/train/optim.py).

The reference trains with ``optim.Adam(filter(requires_grad), lr,
weight_decay)`` (train_net.py:86): torch Adam adds weight_decay * w to the
gradient (not AdamW), which is what the JAX package's
``add_decayed_weights`` before ``scale_by_adam`` computes (optim.py:34-49).
A frozen backbone has ``requires_grad=False`` (the JAX ``trainable_mask``)
and is left out of the optimizer.  The lr plan switches the rate at epoch
boundaries (train_net.py:23-26,102-103).
"""

from __future__ import annotations

import torch


def make_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam(betas 0.9/0.999, eps 1e-8, L2 weight decay on the gradient)
    over the trainable parameters, at ``cfg.train_learning_rate``."""
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=cfg.train_learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def lr_for_epoch(cfg, epoch: int) -> float:
    """The plan value applies from its epoch onward."""
    lr = cfg.train_learning_rate
    for e in sorted(cfg.lr_plan):
        if epoch >= e:
            lr = cfg.lr_plan[e]
    return lr


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
