"""Stage-2 checkpoints of the port.

The reference's stage-2 layout, ``torch.save({'epoch', 'state_dict',
'optimizer'})`` every eval with the accuracy in the file name
(train_net.py:120-128, cited at din_tpu/train/checkpoint.py:1-22).  The
reference saves the optimizer but never restores it; ``load_state``
restores parameters, Adam state and the epoch, as the JAX package's loader
does.  Reading the JAX package's msgpack ``.ckpt`` files is not ported.
"""

from __future__ import annotations

import os

import torch


def save_state(path: str, epoch: int, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer) -> None:
    """Written to a temporary name and moved into place, so a reader never
    sees half a file."""
    tmp = path + ".tmp"
    torch.save({"epoch": epoch, "state_dict": model.state_dict(),
                "optimizer": optimizer.state_dict()}, tmp)
    os.replace(tmp, path)


def load_state(path: str, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer) -> int:
    """Restores parameters and Adam state in place; returns the epoch."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["state_dict"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])
