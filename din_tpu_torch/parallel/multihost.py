"""Joining the ranks of a multi-process run (port of din_tpu/parallel/
multihost.py).

The reference trains in one process with ``nn.DataParallel``
(train_net.py:77-78); din_tpu joins one process per TPU host with
``jax.distributed``.  The port runs one process per rank, joined by
``torch.distributed``: ``torch.distributed.run`` starts them and sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, which ``initialize_multihost`` reads when it is given no
address.

The backend is NCCL on the card and gloo for ``device="cpu"``.  A CUDA run
whose NCCL init fails raises: it never drops to gloo or to the CPU.  An
explicit ``backend="gloo"`` on the card is for two ranks that share one
card (gloo's CUDA ``all_reduce`` and ``broadcast``, the only collectives
the port issues itself).  Every init has a finite timeout, so a rank whose
peer hangs fails instead of waiting for ever.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from din_tpu_torch.utils.device import resolve_device

DEFAULT_TIMEOUT_S = 300.0

_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def init_timeout() -> datetime.timedelta:
    """The timeout of the last ``initialize_multihost``, which the groups of
    ``parallel/mesh.py`` take as well."""
    return _timeout


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device=None,
                         timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    """Joins this process to the run as rank ``process_id`` of
    ``num_processes``, with rank 0's store at ``coordinator_address``
    (``tcp://host:port``); any of the three left None comes from
    ``torch.distributed.run``'s environment.  Already joined: nothing
    happens.  Returns din_tpu's dict (``process_index``,
    ``process_count``, ``local_devices``, ``global_devices``) and the rank's
    ``device`` (``cuda:LOCAL_RANK`` unless ``device`` names one)."""
    global _timeout
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("the NCCL backend needs a CUDA device")
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
        if coordinator_address is None:
            coordinator_address = "tcp://%s:%s" % (
                os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"])
        _timeout = datetime.timedelta(seconds=float(timeout))
        kwargs = {}
        if device.type == "cuda":
            torch.cuda.set_device(device)
            if backend == "nccl":
                # binds the communicator to the card now, so that a failed
                # NCCL init raises here
                kwargs["device_id"] = device
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id,
                                timeout=_timeout, **kwargs)
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": 1,
            "global_devices": dist.get_world_size(),
            "device": device}


def shutdown_multihost() -> None:
    """Leaves the run (``destroy_process_group``); nothing if not joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_indices_for_process(n_items: int,
                              process_index: Optional[int] = None,
                              process_count: Optional[int] = None):
    """This process's strided slice of the dataset's index space (the
    loader's ``process_index::process_count``)."""
    joined = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if joined else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if joined else 1) if process_count is None \
        else process_count
    return list(range(pi, n_items, pc))
