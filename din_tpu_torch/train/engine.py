"""Training loop of the port, stages 1 and 2 (port of din_tpu/train/
engine.py: ``make_train_step`` and ``_make_accum_train_step`` :66-188,
``make_eval_step`` and ``make_mad_step`` :191-221, ``_epoch_info``
:224-250, ``newest_resumable`` :253-266, ``_train_net`` :288-552 and
``_epoch_loop`` :555-645), on one device or on the ranks of a joined run.

The data come from ``data/datasets.py`` ``return_dataset`` (synthetic clips
or a Volleyball or Collective Activity tree on disk, or its packed store),
batched by ``BatchLoader`` on ``cfg.num_workers`` decode threads and put on
the device ``cfg.prefetch_depth`` batches ahead of the step by
``prefetch_to_device``.

A step is forward (``model(images, boxes, bboxes_num)``: the collective
models mask padded actors with the count, as din_tpu's ``apply`` passes
``bboxes_num``, engine.py:95-103), loss (``compute_losses``; stage 1 takes
per-frame labels, stage 2 frame 0's), backward and one Adam update; a
backbone with BatchNorm updates its running statistics in the forward.
With ``cfg.grad_accum_steps`` = k > 1 the batch is split into k equal
micro-batches, each runs forward and the backward of its loss / k (the
running statistics carried from one to the next, as din_tpu's scan carries
``batch_stats``), Adam steps once, and the metrics combine as din_tpu's
``_combine_micro_metrics``: counters and confusions summed, losses
averaged.  Each epoch sets the lr of the plan, pins the loader's shuffle
epoch, takes its steps (at most ``max_steps_per_epoch``), reports the epoch
(``log.txt`` and ``metrics.jsonl``), and every ``test_interval_epoch``
epochs runs an eval pass and tracks the best accuracy. Stage 2 then writes
one checkpoint ``stage2_epoch{E}_{acc:.2f}%.pth`` and, with
``cfg.keep_checkpoints``, prunes the older ones; stage 1 writes its
component file ``stage1_epoch{E}_{acc:.2f}%.pth`` when the accuracy is the
best so far or ties it.  The epochs run from the start epoch to
``cfg.train_to_epoch`` when set, else ``cfg.max_epoch`` of them; at the end
the summary goes to ``log.txt`` and the run's entry to
``<result_root>/experiments.json``.  ``cfg.test_before_train`` adds an eval
pass logged at epoch 0 before the first epoch; ``cfg.eval_only`` runs one
eval pass on the loaded weights, logged at the start epoch - 1, returns its
info and neither trains nor writes a file.

Weights: stage 2 starts from a stage-1 file (``cfg.load_backbone_stage2``,
``cfg.stage1_model_path``: backbone and ``fc_emb`` grafted) or else resumes
a stage-2 checkpoint (``cfg.stage2model``: params, Adam state, epoch),
BatchNorm statistics included in both; stage 1 may start from a
torchvision file of its backbone (``cfg.pretrained_backbone_path``,
BatchNorm statistics included); either may start from a reference ``.pth``
(``cfg.ref_checkpoint_path``) and adopt its Adam state
(``cfg.ref_resume_optimizer``).

Preemption: a ``PreemptionGuard`` (``cfg.graceful_preemption``) latches
SIGTERM; the loop checks it after every step and every eval batch, and on a
stop writes ``stage{N}_epoch{E}_preempt.pth`` (the full state, the steps
done of the interrupted epoch and every dropout generator's state;
``train/checkpoint.py``), logs ``preemption: state saved to ...`` and
returns: mid-epoch after the step; during an eval pass the epoch is saved
complete (step 0) and the partial eval is not reported; during
``test_before_train`` the loaded state is saved; an ``eval_only`` pass
returns ``{"preempted": True}`` and writes nothing.  ``cfg.auto_resume``
resumes the newest resumable file of ``result_path``
(``newest_resumable``) in either stage, in the interrupted epoch at its
next batch (the loader skips the batches done; that epoch is again capped
at ``max_steps_per_epoch`` steps after them, as in din_tpu) with the
dropout generators where they stood, so the run continues as if it had
not stopped.

Diagnostics: ``cfg.measure_mad`` adds the MAD of the DIN head's sampled
neighbourhoods to each eval pass (``info["MAD"]``; padded clips dropped by
``sample_mask``); the eval forward returns the losses' logits and the MAD
nodes at once, where din_tpu runs a second program, so an eval pass
launches the same kernels with MAD as without.  ``cfg.profile_dir`` traces
the first epoch with ``torch.profiler`` (``utils/profiling.py``).
``cfg.debug_nans`` runs the run under autograd's anomaly mode with NaN
checks and checks each step's loss, restoring the previous mode after.

More than one rank (a run joined by ``parallel/multihost.py``
``initialize_multihost``, e.g. under ``torch.distributed.run``; the
layout of ``cfg.mesh_shape``, ``parallel/mesh.py``), as din_tpu's mesh
runs (engine.py:273-285, 309-321, 433-446, 518-528):

- the model is wrapped in ``DistributedDataParallel`` (``wrap_model``)
  with ``broadcast_buffers=False`` (BatchNorm's running statistics agree
  on every rank by construction) and ``find_unused_parameters=False``:
  every trainable parameter gets a gradient on each of the 18 training
  paths; its gradients are summed over the ranks, not averaged (a comm
  hook), since each rank's loss is already its share of the global batch's
  (``train/losses.py``); under ``frame_parallel`` the sum is divided by
  the ranks of a model group, which all compute their data group's loss;
- accumulation micro-steps run under ``no_sync()`` except the last; each
  rank splits its own batch, so micro-step m takes every rank's m-th
  slice, where din_tpu's scan takes the m-th slice of the global batch: a
  deliberate difference, which only live BatchNorm's statistics see;
- the loaders take ``process_index``/``process_count`` from the data
  ranks (``cfg.batch_size`` is a data rank's batch, as din_tpu's is a
  process's); the eval loader pads every rank to the same batch count;
- the eval pass runs the unwrapped model, and the ranks' counters, losses,
  confusions and MAD sums are added before they are reported;
- the preemption stop is agreed: an all-reduce MAX of every rank's flag at
  every step and eval boundary, so all ranks stop at the same step;
- rank 0 alone writes ``log.txt``, ``metrics.jsonl``, ``experiments.json``
  and checkpoints (``train/checkpoint.py``: the same layout as one process,
  a ZeRO-1 state consolidated first), the others wait at a barrier; every
  rank loads; the run's name is rank 0's;
- each data rank has its own dropout streams: every ``SeededDropout``
  seed moves by ``data_index * 2**32`` (rank 0 keeps the one-process
  seeds).  This is a deliberate difference from din_tpu, whose one global
  dropout key is split over the whole batch; a ``_preempt`` file holds
  every data rank's generators.

Two runs at one world size are bit-equal, as on one rank.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from din_tpu_torch.data.datasets import return_dataset
from din_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from din_tpu_torch.models.registry import build_model, resolve_device
from din_tpu_torch.nn.ref_import import (load_pretrained_backbone,
                                         load_reference_checkpoint,
                                         load_reference_optimizer)
from din_tpu_torch.train.checkpoint import (load_backbone_stage2,
                                            load_resume_state,
                                            newest_resumable,
                                            prune_checkpoints,
                                            save_preempt_state,
                                            save_stage1_components,
                                            save_state)
from din_tpu_torch.nn.layers import SeededDropout
from din_tpu_torch.parallel.mesh import current_mesh, make_mesh, use_mesh
from din_tpu_torch.train.losses import compute_losses
from din_tpu_torch.train.optim import (is_sharded, lr_for_epoch,
                                       make_optimizer, set_learning_rate)
from din_tpu_torch.train.preempt import PreemptionGuard, agreed_stop
from din_tpu_torch.utils.logging import (is_log_rank, log_final_exp_result,
                                         print_log, show_config,
                                         show_epoch_info)
from din_tpu_torch.utils.meters import MPCA, MADmeter, Timer
from din_tpu_torch.utils.precision import deterministic_convs
from din_tpu_torch.utils.profiling import profiler_trace


def _micro_batches(batch: Dict[str, torch.Tensor],
                   accum: int) -> Iterator[Dict[str, torch.Tensor]]:
    """``accum`` equal slices of every tensor's batch axis (the batch
    itself for 1); a batch they do not divide raises."""
    if accum == 1:
        yield batch
        return
    B = batch["images"].shape[0]
    if B % accum:
        raise ValueError(f"batch of {B} is not divisible by "
                         f"grad_accum_steps={accum}")
    m = B // accum
    for i in range(accum):
        yield {k: v[i * m:(i + 1) * m] for k, v in batch.items()}


def combine_micro_metrics(parts: List[Dict[str, torch.Tensor]]
                          ) -> Dict[str, torch.Tensor]:
    """Micro-batch metrics -> the batch's: counters and confusions summed,
    losses averaged (the micro-batches are equal, so the mean of their
    means is the batch mean; din_tpu/train/engine.py:66-72)."""
    return {k: (torch.stack([p[k] for p in parts]).sum(0)
                if k.endswith(("_correct", "_total", "_conf"))
                else torch.stack([p[k] for p in parts]).mean(0))
            for k in parts[0]}


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """One update on a batch already on the model's device, over
    ``cfg.grad_accum_steps`` micro-batches; returns the detached metrics
    (still on the device: reading them waits for it).  With
    ``cfg.debug_nans`` a non-finite loss raises ``FloatingPointError``
    before its backward.  Forward and backward run on cuDNN's
    deterministic algorithms (``deterministic_convs``), and the DIN head's
    gather has a backward that sums in a fixed order, so that two steps
    from one state on the card are bit-equal, as din_tpu's XLA steps
    are.  Under an ambient mesh (``train_net`` with more than one rank)
    ``model`` is its ``wrap_model`` and the metrics are this rank's shares
    and counts: the micro-steps but the last run under ``no_sync()``."""
    mesh = current_mesh()
    group = None if mesh is None else mesh.data_group
    model.train()
    accum = max(int(cfg.grad_accum_steps or 1), 1)
    ddp = isinstance(model, torch.nn.parallel.DistributedDataParallel)
    optimizer.zero_grad(set_to_none=True)
    parts = []
    with deterministic_convs():
        for i, mb in enumerate(_micro_batches(batch, accum)):
            sync = model.no_sync() if ddp and i < accum - 1 \
                else contextlib.nullcontext()
            with sync:
                out = model(mb["images"], mb["boxes"], mb.get("bboxes_num"))
                metrics = compute_losses(out, mb, cfg,
                                         cfg.training_stage == 2, group)
                loss = metrics["loss"]
                if cfg.debug_nans:
                    bad = not bool(torch.isfinite(loss))
                    if mesh.agree(bad) if mesh is not None else bad:
                        raise FloatingPointError(
                            f"non-finite loss {float(loss.detach())} "
                            f"(debug_nans)")
                (loss if accum == 1 else loss / accum).backward()
            parts.append({k: v.detach() for k, v in metrics.items()})
    optimizer.step()
    return parts[0] if accum == 1 else combine_micro_metrics(parts)


def sum_gradients_hook(state, bucket):
    """DDP comm hook: a bucket's gradients summed over ``state``'s group
    and divided by its count of model ranks (each computes its data
    group's loss)."""
    group, copies = state
    fut = torch.distributed.all_reduce(bucket.buffer(), group=group,
                                       async_op=True).get_future()

    def done(f):
        grads = f.value()[0]
        return grads if copies == 1 else grads.div_(copies)
    return fut.then(done)


def wrap_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """``model`` itself on one rank; else ``DistributedDataParallel`` over
    the default group (module docstring: no buffer broadcasts, no search
    for unused parameters, gradients summed)."""
    if mesh is None or mesh.size == 1:
        return model
    dev = next(model.parameters()).device
    index = None if dev.type != "cuda" else \
        (dev.index if dev.index is not None else torch.cuda.current_device())
    ddp = torch.nn.parallel.DistributedDataParallel(
        model, device_ids=None if index is None else [index],
        broadcast_buffers=False, find_unused_parameters=False)
    ddp.register_comm_hook((None, mesh.model), sum_gradients_hook)
    return ddp


def seed_dropouts_for_rank(model: torch.nn.Module, data_index: int) -> None:
    """Each data rank its own dropout streams: every ``SeededDropout``'s
    seed moves by ``data_index * 2**32`` (0 keeps it)."""
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.seed += data_index << 32
            m.generator = None


def mad_nodes(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The MAD nodes [B, T*N, 1+k2, C] of a ``return_mad`` output: each
    actor's centre feature followed by its sampled neighbourhood
    (din_tpu/train/engine.py:203-221)."""
    sampled = out["mad_features"]                       # [B,T,N,k2,C]
    nodes = torch.cat([out["mad_center"][:, :, :, None].to(sampled.dtype),
                       sampled], dim=3)
    B, T, N, K, C = nodes.shape
    return nodes.reshape(B, T * N, K, C)


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
              cfg) -> Dict[str, torch.Tensor]:
    """The losses and counters of one eval batch; with ``cfg.measure_mad``
    the same forward also gives the MAD nodes, under ``"mad_nodes"``."""
    mesh = current_mesh()
    model.eval()
    kwargs = {"return_mad": True} if cfg.measure_mad else {}
    out = model(batch["images"], batch["boxes"], batch.get("bboxes_num"),
                **kwargs)
    metrics = compute_losses(out, batch, cfg, cfg.training_stage == 2,
                             None if mesh is None else mesh.data_group)
    if cfg.measure_mad:
        metrics["mad_nodes"] = mad_nodes(out)
    return metrics


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in metrics.items()}


def reduce_metrics(metrics: List[Dict[str, np.ndarray]],
                   mesh=None) -> List[Dict[str, np.ndarray]]:
    """Each step's host metrics summed over the data ranks: losses (each
    rank's is its share of the global batch's), counters and confusions;
    as they are on one data rank."""
    if mesh is None or mesh.data == 1 or not metrics:
        return metrics
    keys = sorted(metrics[0])
    flat = np.concatenate([np.asarray(m[k], np.float64).ravel()
                           for m in metrics for k in keys])
    flat = mesh.host_sum(flat)
    out, at = [], 0
    for m in metrics:
        r = {}
        for k in keys:
            v = np.asarray(m[k])
            r[k] = flat[at:at + v.size].reshape(v.shape).astype(v.dtype)
            at += v.size
        out.append(r)
    return out


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


def _setup_training(cfg, device=None, mesh=None):
    """``setup_training``'s (model, optimizer, start_epoch) and the steps
    done of the start epoch (a ``_preempt`` file's; else 0); with ``mesh``
    this rank's (its dropout streams, a ZeRO-1 optimizer under
    ``cfg.shard_opt_state``, its generators of a ``_preempt`` file)."""
    device = resolve_device(device)
    model = build_model(cfg, device=device)
    if mesh is not None and mesh.data_index:
        seed_dropouts_for_rank(model, mesh.data_index)
    if cfg.measure_mad and not getattr(model, "returns_mad", False):
        raise ValueError(
            f"measure_mad needs a model that returns its DIN head's MAD "
            f"nodes (dynamic_volleyball, with any of its DIN heads); "
            f"{type(model).__name__} (stage {cfg.training_stage}, "
            f"{cfg.inference_module_name!r}) does not")
    start_epoch, resume_step, resumed = 1, 0, False
    if cfg.ref_checkpoint_path:
        skipped = load_reference_checkpoint(model, cfg.ref_checkpoint_path)
        print_log(cfg.log_path, "Loaded reference checkpoint %s (%d keys "
                  "skipped)" % (cfg.ref_checkpoint_path, len(skipped)))
    optimizer = make_optimizer(cfg, model, mesh, cfg.log_path)
    resume = cfg.load_stage2model and cfg.stage2model
    if cfg.training_stage == 2:
        if cfg.load_backbone_stage2 and cfg.stage1_model_path:
            load_backbone_stage2(model, cfg.stage1_model_path)
            print_log(cfg.log_path,
                      "Loaded stage1 backbone: " + cfg.stage1_model_path)
        elif resume:
            last, resume_step, _ = load_resume_state(cfg.stage2model, model,
                                                     optimizer, mesh)
            start_epoch, resumed = last + 1, True
            print_log(cfg.log_path, "Loading stage2 model: %s (resuming at "
                      "epoch %d%s)" % (cfg.stage2model, start_epoch,
                                       ", step %d" % resume_step
                                       if resume_step else ""))
        else:
            print_log(cfg.log_path, "Not loading stage1 or stage2 model.")
    elif resume:
        # stage-1 preemption resume: its _preempt file holds the full state
        last, resume_step, _ = load_resume_state(cfg.stage2model, model,
                                                 optimizer, mesh)
        start_epoch, resumed = last + 1, True
        print_log(cfg.log_path, "Resuming stage1 from %s (epoch %d%s)"
                  % (cfg.stage2model, start_epoch,
                     ", step %d" % resume_step if resume_step else ""))
    elif cfg.pretrained_backbone_path:
        load_pretrained_backbone(model, cfg.pretrained_backbone_path)
        print_log(cfg.log_path, "Loaded pretrained backbone: "
                  + cfg.pretrained_backbone_path)
    if cfg.ref_checkpoint_path and cfg.ref_resume_optimizer and resumed:
        print_log(cfg.log_path, "Kept the resumed optimizer state over the "
                  "reference file's (resuming at epoch %d)" % start_epoch)
    elif cfg.ref_checkpoint_path and cfg.ref_resume_optimizer:
        # ZeRO-1 takes the state through a replicated Adam's state_dict
        target = make_optimizer(cfg, model) if is_sharded(optimizer) \
            else optimizer
        start_epoch = load_reference_optimizer(
            model, target, cfg.ref_checkpoint_path, cfg) + 1
        if target is not optimizer:
            optimizer.load_state_dict(target.state_dict())
        print_log(cfg.log_path, "Adopted reference optimizer state "
                  "(resuming at epoch %d)" % start_epoch)
    return model, optimizer, start_epoch, resume_step


def setup_training(cfg, device=None):
    """(model, optimizer, start_epoch) for ``cfg`` on ``device`` (default:
    the card), loading weights in the JAX package's order
    (din_tpu/train/engine.py:355-429) and logging each load to
    ``cfg.log_path``: random weights from ``cfg.train_random_seed``; then a
    reference ``.pth`` (``cfg.ref_checkpoint_path``); then in stage 2 the
    backbone and ``fc_emb_1`` of ``cfg.stage1_model_path`` when
    ``cfg.load_backbone_stage2`` is set, else the state of
    ``cfg.stage2model`` when ``cfg.load_stage2model`` is set (a regular or
    a ``_preempt`` file, the dropout generators' states included); in stage
    1 the full state of a ``_preempt`` file in ``cfg.stage2model`` when
    ``cfg.load_stage2model`` is set, else a pretrained backbone
    (``cfg.pretrained_backbone_path``); last, with
    ``cfg.ref_resume_optimizer``, the reference file's Adam state, resuming
    at its epoch + 1, unless a resume file (``cfg.stage2model`` loaded, a
    regular or a ``_preempt`` file) was loaded: then its Adam state, epoch,
    step and dropout generators stand.  That epoch is a deliberate
    difference from din_tpu, which adopts the reference file's Adam state
    first and restores the resumed one over it, but takes its start epoch
    from the reference file (din_tpu/train/engine.py:376, :420), so that a
    resumed run repeats epochs (ROADMAP.md §3).  ``cfg.measure_mad`` on a
    model that does not return MAD nodes raises ``ValueError``."""
    return _setup_training(cfg, device)[:3]


def run_eval(model, loader: BatchLoader, cfg, epoch: int,
             device: torch.device, stop=None) -> Dict:
    """One eval pass: the epoch info, with ``"MAD"`` under
    ``cfg.measure_mad``; a true ``stop()`` after a batch ends the pass,
    and the info then holds ``"preempted": True``.  Under an ambient mesh
    ``model`` is the unwrapped model, and the info is of every rank's
    clips."""
    timer = Timer()
    metrics = []
    mad = MADmeter(cfg.num_frames, cfg.num_boxes) if cfg.measure_mad \
        else None
    preempted = False
    for b in prefetch_to_device(loader, device, cfg.prefetch_depth):
        m = eval_step(model, b, cfg)
        nodes = m.pop("mad_nodes", None)
        metrics.append(_to_host(m))
        if stop is not None and stop():
            # preemption mid-eval: end the pass so the emergency save
            # lands within the grace window
            preempted = True
            break
        if mad is not None:
            nodes = nodes.cpu().numpy()
            if "sample_mask" in b:                 # drop padded clips
                nodes = nodes[b["sample_mask"].cpu().numpy() > 0]
            mad.cal_MAD(nodes, field=None, field_shape="dynamic")
    mesh = current_mesh()
    metrics = reduce_metrics(metrics, mesh)
    info = epoch_info(metrics, epoch, timer.timeit(), cfg.num_activities)
    if mad is not None:
        if mesh is not None:
            mad.all_reduce(mesh.host_sum)
        info["MAD"] = float(mad.output_MAD())
    if preempted:
        info["preempted"] = True
    return info


def train_net(cfg, max_steps_per_epoch: Optional[int] = None,
              device=None) -> Dict:
    """Full training loop of either stage (reference train_net.py:28-137).
    Returns the best eval info, with the path of the last file written under
    ``"checkpoint"``; with ``cfg.eval_only`` the info of its eval pass; on
    a preemption what it had, after writing the ``_preempt`` file.  In a
    joined run every rank calls it with the same ``cfg`` (the module
    docstring says what each rank does)."""
    device = resolve_device(device)
    mesh = make_mesh(cfg)
    if mesh.size > 1:
        # one result directory: rank 0's (timestamped) name
        cfg.exp_name = mesh.broadcast_object(
            cfg.init_config(need_new_folder=False).exp_name)
    cfg.init_config()
    show_config(cfg)
    # anomaly mode is process-wide: on for this run only, as it was after
    nan_checks = torch.autograd.set_detect_anomaly(True, check_nan=True) \
        if cfg.debug_nans else contextlib.nullcontext()
    with nan_checks, use_mesh(mesh):
        return _train_net(cfg, max_steps_per_epoch, device, mesh)


def _train_net(cfg, max_steps_per_epoch, device, mesh) -> Dict:
    if cfg.auto_resume and not cfg.stage2model:
        newest = newest_resumable(cfg.result_path, cfg.training_stage)
        if newest:
            cfg.stage2model = newest
            cfg.load_stage2model = True
            cfg.load_backbone_stage2 = False
    training_set, validation_set = return_dataset(cfg)
    # every data rank its strided shard of the shared order
    shard = dict(process_index=mesh.data_index, process_count=mesh.data,
                 even_batches=True)
    train_loader = BatchLoader(training_set, cfg.batch_size, shuffle=True,
                               num_workers=cfg.num_workers,
                               seed=cfg.train_random_seed, **shard)
    # remainder eval batches are padded (cycled) and masked
    val_loader = BatchLoader(validation_set, cfg.test_batch_size,
                             shuffle=False, num_workers=cfg.num_workers,
                             drop_last=False, pad_last=True, **shard)
    model, optimizer, start_epoch, resume_step = _setup_training(cfg, device,
                                                                 mesh)
    step_model = wrap_model(model, mesh)
    best = {"epoch": 0, "activities_acc": 0.0}
    total_timer = Timer()

    def save_preempt(last_done_epoch: int, steps_done: int) -> None:
        path = os.path.join(cfg.result_path, "stage%d_epoch%d_preempt.pth"
                            % (cfg.training_stage, last_done_epoch))
        save_preempt_state(path, last_done_epoch, steps_done, model,
                           optimizer, mesh)
        print_log(cfg.log_path,
                  "preemption: state saved to %s (epoch %d, %d steps done) "
                  "— resume with auto_resume=True"
                  % (path, last_done_epoch + 1, steps_done))

    guard_ctx = PreemptionGuard() if cfg.graceful_preemption \
        else contextlib.nullcontext()
    with guard_ctx as guard:
        def stop() -> bool:
            return agreed_stop(guard, mesh)

        if cfg.eval_only:
            info = run_eval(model, val_loader, cfg, start_epoch - 1, device,
                            stop)
            if info.pop("preempted", False):
                # a partial pass must not be reported as the file's score
                print_log(cfg.log_path, "eval_only pass preempted mid-eval; "
                          "partial metrics discarded — rerun to score")
                return {"preempted": True}
            show_epoch_info("Test", cfg.log_path, info)
            return info
        if cfg.test_before_train:
            info = run_eval(model, val_loader, cfg, 0, device, stop)
            if info.pop("preempted", False):
                save_preempt(start_epoch - 1, resume_step)
                return best
            show_epoch_info("Test", cfg.log_path, info)

        last_epoch = cfg.train_to_epoch or (start_epoch + cfg.max_epoch - 1)
        for epoch in range(start_epoch, last_epoch + 1):
            if epoch in cfg.lr_plan:
                print_log(cfg.log_path,
                          "change learning rate: %g" % cfg.lr_plan[epoch])
            set_learning_rate(optimizer, lr_for_epoch(cfg, epoch))
            # the first epoch after a mid-epoch preemption skips the
            # batches it has done; the order is a function of (seed, epoch)
            skipped = resume_step if epoch == start_epoch else 0
            train_loader.set_epoch(epoch, skip_batches=skipped)
            timer = Timer()
            metrics = []
            trace = profiler_trace(cfg.profile_dir) \
                if cfg.profile_dir and epoch == start_epoch \
                and is_log_rank() else contextlib.nullcontext()
            with trace:
                for i, batch in enumerate(prefetch_to_device(
                        train_loader, device, cfg.prefetch_depth)):
                    metrics.append(train_step(step_model, optimizer, batch,
                                              cfg))
                    if stop():
                        # at the step boundary; the resume continues this
                        # epoch at the next batch
                        save_preempt(epoch - 1, skipped + i + 1)
                        return best
                    if max_steps_per_epoch and i + 1 >= max_steps_per_epoch:
                        break
            metrics = reduce_metrics([_to_host(m) for m in metrics],
                                     mesh)  # waits for the device
            info = epoch_info(metrics, epoch, timer.timeit(),
                              cfg.num_activities,
                              clips=len(metrics) * cfg.batch_size * mesh.data)
            show_epoch_info("Train", cfg.log_path, info)

            if epoch % cfg.test_interval_epoch:
                continue
            test_info = run_eval(model, val_loader, cfg, epoch, device, stop)
            if test_info.pop("preempted", False):
                # the epoch trained in full: save it complete (step 0) and
                # keep the partial eval out of the best
                save_preempt(epoch, 0)
                return best
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
                save_state(path, epoch, model, optimizer, mesh)
            elif test_info["activities_acc"] == best["activities_acc"]:
                save_stage1_components(path, model, mesh)
            else:
                continue
            best["checkpoint"] = path
            print_log(cfg.log_path, "model saved to: " + path)
            if cfg.training_stage == 2 and cfg.keep_checkpoints and \
                    is_log_rank():
                removed = prune_checkpoints(cfg.result_path, 2,
                                            cfg.keep_checkpoints)
                if removed:
                    print_log(cfg.log_path,
                              "pruned %d old checkpoints" % len(removed))

    # the final summary and the experiment db (reference utils.py:131-158)
    log_final_exp_result(
        cfg.log_path, os.path.join(cfg.result_root, "experiments.json"),
        {"cfg": cfg, "best_result": best,
         "total_time": total_timer.timeit() / 3600.0})
    return best
