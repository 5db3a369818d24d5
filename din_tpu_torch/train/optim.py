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

from typing import Optional

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer

from din_tpu_torch.utils.logging import print_log


def make_optimizer(cfg, model: torch.nn.Module, mesh=None,
                   log_path: Optional[str] = None) -> torch.optim.Optimizer:
    """Adam(betas 0.9/0.999, eps 1e-8, L2 weight decay on the gradient)
    over the trainable parameters, at ``cfg.train_learning_rate``.  With
    ``cfg.shard_opt_state`` and more than one data rank in ``mesh``, ZeRO-1
    (din_tpu/train/engine.py:435-446): a ``ZeroRedundancyOptimizer`` over
    the same Adam on the data group, each rank holding the moments of its
    share of the parameters, stepping them and broadcasting them (the
    update of the replicated Adam, bit for bit)."""
    params = [p for p in model.parameters() if p.requires_grad]
    kwargs = dict(lr=cfg.train_learning_rate, betas=(0.9, 0.999), eps=1e-8,
                  weight_decay=cfg.weight_decay)
    if cfg.shard_opt_state and mesh is not None and mesh.data > 1:
        opt = ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.Adam,
                                      process_group=mesh.data_group,
                                      **kwargs)
        print_log(log_path, "ZeRO-1: optimizer state sharded over data axis "
                  "(%d)" % mesh.data)
        return opt
    return torch.optim.Adam(params, **kwargs)


def is_sharded(optimizer: torch.optim.Optimizer) -> bool:
    """True for a ZeRO-1 optimizer (``make_optimizer``)."""
    return isinstance(optimizer, ZeroRedundancyOptimizer)


def lr_for_epoch(cfg, epoch: int) -> float:
    """The plan value applies from its epoch onward."""
    lr = cfg.train_learning_rate
    for e in sorted(cfg.lr_plan):
        if epoch >= e:
            lr = cfg.lr_plan[e]
    return lr


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every param group's lr (a ZeRO-1 optimizer passes its groups' on to
    its local Adam at its next step)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
