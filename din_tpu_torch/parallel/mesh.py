"""The ranks laid out as ``data x model``, and the collectives the trainer
issues (port of din_tpu/parallel/mesh.py).

din_tpu runs one SPMD program over a ``jax.sharding.Mesh`` with a ``data``
and a ``model`` axis; the partitioner inserts every collective.  The port
runs one process per rank and issues them itself.  Rank ``r`` sits at
``(data_index, model_index) = divmod(r, model)``, the order of din_tpu's
``devices.reshape(data, model)`` (``make_mesh``, mesh.py:19-28).

Groups, each a process group of its own so that no two kinds of traffic
share one:

- ``data_group``: the ranks of this rank's column (same ``model_index``).
  The loss denominators and the Adam shards of ZeRO-1 reduce over it.
- ``model_group``: the ranks of this rank's row (same ``data_index``).
  They read the same clips; under ``cfg.frame_parallel`` they split their
  frames, and the RoI features are gathered over it.
- ``frame_group``: the ranks that split the global frame axis, in order
  (``frame_axes``): the data group, or, under ``cfg.frame_parallel``,
  ``world_group``, a group of every rank.  BatchNorm's chunk statistics
  reduce over it.
- The default group (every rank): the gradients' all-reduce
  (``DistributedDataParallel``) runs on it alone.
- ``host_world`` and ``host_data``: gloo groups over CPU tensors for the
  trainer's host-side traffic (the agreed preemption stop, metrics, the
  run's name, barriers around a save), which never waits for the card.

The collectives on device tensors are built on ``all_reduce`` and
``broadcast`` only, so that gloo carries them on CUDA tensors too (two ranks
sharing one card); the host groups use torch's object collectives and
barrier.  ``all_reduce_sum`` carries a gradient
(``torch.distributed.nn.functional.all_reduce``: its backward all-reduces
the gradient); ``gather_exact`` is the all-reduce of a zero-filled buffer
into which each rank writes its own slice, a sum that is exact.

``use_mesh`` makes a mesh ambient for the code it wraps (din_tpu's scoped
``jax.set_mesh``, train/engine.py:273-285): the trunk and the losses read
it with ``current_mesh``; with none, or one rank, they run as on one
device.  din_tpu's ``param_sharding`` (tensor parallelism over 'model')
is not ported: its engine never applies it (engine.py:433).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from din_tpu_torch.parallel.multihost import init_timeout

_ACTIVE: Optional["Mesh"] = None


def frame_axes(cfg):
    """The mesh axes the trunk splits the flattened B*T frame axis over
    (din_tpu/parallel/mesh.py:30-51): both under ``cfg.frame_parallel``,
    else 'data' alone."""
    return ("data", "model") if getattr(cfg, "frame_parallel", False) \
        else ("data",)


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """This rank's place in a ``data x model`` layout of the run, and its
    groups (module docstring).  One rank (no run joined): every group is
    None and every collective returns its input."""

    def __init__(self, data: int, model: int, rank: int,
                 frame_parallel: bool = False):
        self.data, self.model = data, model
        self.size = data * model
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self.frame_parallel = frame_parallel
        self.data_group = self.model_group = self.world_group = None
        self.host_world = self.host_data = None

    @property
    def frame_size(self) -> int:
        """Ranks along the frame axis."""
        return self.size if self.frame_parallel else self.data

    @property
    def frame_index(self) -> int:
        """This rank's position on the frame axis."""
        return self.rank if self.frame_parallel else self.data_index

    @property
    def frame_group(self):
        return self.world_group if self.frame_parallel else self.data_group

    # -- host-side collectives (CPU tensors, gloo) -------------------------

    def host_sum(self, x: np.ndarray) -> np.ndarray:
        """``x`` summed over this rank's column (its data ranks), in
        float64; one data rank returns it."""
        if self.data == 1:
            return np.asarray(x)
        t = torch.from_numpy(np.asarray(x, dtype=np.float64).copy())
        dist.all_reduce(t, group=self.host_data)
        return t.numpy()

    def agree(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is true on any (an all-reduce MAX
        over every rank; din_tpu all-gathers the flags, engine.py:518-528).
        Every rank calls it at the same points."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_world)
        return bool(t.item())

    def barrier(self) -> None:
        """Returns on every rank once every rank has called it."""
        if self.size > 1:
            dist.barrier(group=self.host_world)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_world)
        return box[0]

    def gather_objects(self, obj) -> List:
        """Every rank of this rank's column's ``obj``, in data order, on
        each of them."""
        if self.data == 1:
            return [obj]
        out = [None] * self.data
        dist.all_gather_object(out, obj, group=self.host_data)
        return out


def make_mesh(cfg=None) -> Mesh:
    """The ``data x model`` layout of the joined run from
    ``cfg.mesh_shape`` with din_tpu's defaults (mesh.py:19-28): 'model'
    1, 'data' the rest.  With no run joined, a one-rank mesh.  Every rank
    calls it with the same ``cfg`` (it creates the groups); a shape that
    does not cover the world raises."""
    frame_parallel = bool(getattr(cfg, "frame_parallel", False))
    if not _joined():
        return Mesh(1, 1, 0, frame_parallel)
    n = dist.get_world_size()
    shape = dict(getattr(cfg, "mesh_shape", None) or {})
    model = max(int(shape.get("model", 1)), 1)
    data = int(shape.get("data", 0)) or n // model
    if data * model != n:
        raise ValueError(f"mesh_shape {shape} gives {data} x {model} ranks; "
                         f"the run has {n}")
    mesh = Mesh(data, model, dist.get_rank(), frame_parallel)
    if n == 1:
        return mesh
    timeout = init_timeout()
    columns = [[d * model + m for d in range(data)] for m in range(model)]
    rows = [[d * model + m for m in range(model)] for d in range(data)]
    # every rank creates every group, in the same order
    data_groups = [dist.new_group(r, timeout=timeout) for r in columns]
    model_groups = [dist.new_group(r, timeout=timeout) for r in rows]
    if frame_parallel:
        mesh.world_group = dist.new_group(list(range(n)), timeout=timeout)
    mesh.host_world = dist.new_group(list(range(n)), timeout=timeout,
                                     backend="gloo")
    host_data = [dist.new_group(r, timeout=timeout, backend="gloo")
                 for r in columns]
    mesh.data_group = data_groups[mesh.model_index]
    mesh.model_group = model_groups[mesh.data_index]
    mesh.host_data = host_data[mesh.model_index]
    return mesh


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """``mesh`` is ``current_mesh()`` for the code it wraps (a one-rank
    mesh counts as none)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def current_mesh() -> Optional[Mesh]:
    """The ambient mesh of more than one rank, or None."""
    return _ACTIVE


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, with a gradient: the backward sums
    the incoming gradients over the group."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def gather_exact(x: torch.Tensor, group, index: int,
                 size: int) -> torch.Tensor:
    """[size * n, ...] from each of ``size`` ranks' ``x`` [n, ...] (rank
    ``index`` of the group gives rows [index*n, (index+1)*n)): an
    all-reduce of a zero-filled buffer holding this rank's rows, exact
    since every other addend is 0.  The gradient of this rank's rows is
    the sum over the group of the gradients of those rows."""
    if size == 1:
        return x
    parts: Sequence[torch.Tensor] = [
        x if i == index else torch.zeros_like(x) for i in range(size)]
    return all_reduce_sum(torch.cat(parts), group)
