#!/usr/bin/env python3
"""Smoke run of din_tpu_torch on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each timed, any failure exits non-zero:

1. setup: the card's name and power limit (nvidia-smi), and the build of the
   hand-written CUDA kernels with plain nvcc (seconds, one nvcc per source,
   all started together);
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes: K3 ``fused_stem`` at a flagship chunk [5,720,1280,3] and
   odd 7x9 maps, one with a large positive conv1_1 bias that exposes the
   border padding (f32 within 1e-5 of max|y|, bf16 within one bf16 ulp plus
   that tolerance), and with conv1_2 set to the identity, where its pooled
   y1 must equal the plain version's bit for bit; K2 ``max_pool_2x2`` and
   K2b ``max_pool_2x2_bwd`` at the five VGG-16 pool inputs of a 720x1280
   frame and an odd 7x9 map (f32 and bf16, random and tie-heavy inputs, a
   non-contiguous incoming gradient; bit-equal), K1 ``roi_align`` and K1b
   ``roi_align_bwd`` on a [20,22,40,512] map with 12 boxes per frame
   including border, outside and zero-area boxes (K1 bit-equal to its plain
   version on the card in f32 and bf16; K1b within 1e-5 of max|df| of its
   plain version on the card, which adds with atomics there, plus one bf16
   ulp in bf16, and bit-equal to it run on the CPU in f32 and bf16, two
   launches and a channel-major g bit-equal to each other); K1 bit-equal
   in f32 and bf16 at the maps of the collective path, Inception-v3 (the
   collective [80,57,87,288] with 13 boxes, 4 padded, and the Volleyball
   [20,87,157,288]), ResNet-50 [20,23,40,2048] and AlexNet [20,21,39,256],
   and, with the edge boxes, on a [20,22,40,100] map (C no multiple of
   the kernel's 16-byte vector) and from a feature pointer off a 16-byte
   boundary (the kernel's scalar tail); K1b at the collective path's
   shapes, a [20,15,23,512] ResNet-18 map with 13 person-sized boxes a
   frame, one on the border and 4 zero-padded (the padded boxes give 0 in
   K1 and add nothing in K1b; K1b bit-equal to its plain version on the
   CPU); and K1 and K1b at the baselines' shapes, a [20,23,40,512]
   ResNet-18 map of 720x1280 frames with 12 person-sized boxes a frame,
   with 5x5 and with HiGCIN's 7x7 crops (the same checks);
3. full-width serving of the flagship preset ``volleyball_stage2_dynamic``
   (VGG-16, 720x1280, T=10, N=12, bf16 backbone compute, f32 weights and
   head) through ``Predictor(pad_to=2)`` with seeded random weights: three
   requests (1 clip, 3 clips, the first clip again), checked for shape,
   finite rows summing to 1, the repeated clip's answer, and the launch
   counts, which are set to 0 just before and read just after; 1-clip
   latency with K3 and, in turns, with the stem run as the layers it
   replaces; then the DIN head's TF32 fault: one clip with the head's convs
   unrepaired under the card's default flags against TF32 off (offsets and
   posteriors), and repaired under the default flags against TF32 off; and
   the same convs' backward: one flagship step's gradients of the head's
   convs with their backward as before the repair and repaired, under the
   default flags, against TF32 off, the repaired difference no larger than
   that between two TF32-off runs (cuDNN's deterministic algorithms);
4. full-width stage 1 (``volleyball_stage1``) through ``train_net``
   started from a torchvision-layout VGG-16 file the smoke writes
   (``--pretrained-backbone-path``; ``backbone.features`` equal the file's
   tensors): one epoch of 3 Adam steps at batch 8 (T=1), an eval pass and a
   stage-1 component file, with the launch counts of all five kernels (0
   just before, read just after, against counts derived from
   ``auto_chunk``); ms per step, clips/s and peak memory on one batch; then
   the flagship stage 2 through ``train_net`` started from that file with
   ``--stage1-model-path``: ``backbone.*`` and ``fc_emb_1`` equal the
   file's tensors before the first step, 3 steps at batch 2, an eval pass, a
   checkpoint, the launch counts; finite losses; the checkpoint reloaded as
   ``--stage2-model-path`` gives equal params and Adam state; the same
   state rewritten as the reference framework writes it (keys and Adam
   indices in the JAX package's exporter order) and migrated with
   ``--ref-checkpoint-path --ref-resume-optimizer``: weights and moments
   adopted by name, the start epoch, and a 1-step ``train_net`` from it
   with its launch counts;
5. memorisation: 8 steps on one fixed full-width batch with dropout 0, the
   loss at step 8 below step 1; ms per step after a warm-up step, clips/s,
   peak device memory, and one profiled step's device time split by kernel;
6. the port on the card (kernels) against the port on the CPU (plain
   versions), float32: serving one clip at T=3, 144x160 (atol 1e-4) with
   TF32 off and with the card's default flags; the f32 backbone's conv
   gradients at that geometry under the default flags, before and after the
   repair, held as in phase 3; and 3 training steps at that
   geometry with TF32 off, dropout 0, each taken from the CPU's state
   (losses rtol 1e-4, parameters within the CPU trajectory test's bounds
   after a ReLU or pool flip) and along the card's own trajectory
   (parameters within the same bounds); the same for stage 1 (logits atol
   1e-4, 3 steps; along its own trajectory the share of elements beyond
   2e-5 is reported, not bounded);
7. each kernel's time at the main paths' shapes beside its bound, its plain
   version's time and, where one exists, a PyTorch call's time (for K3 the
   unfused cuDNN stem, with K3's time as a ratio to it, and the layer route
   the model takes with a gradient; for K1 and K1b the wrapper and the
   launch alone, and for K1b the copy of a channel-major gradient; K1 and
   K1b also at the collective shapes and at the baselines' shapes, 5x5
   and 7x7, of phase 2; for K1 at each of them also its device time from
   ``torch.profiler`` (from a CUDA graph's replays where CUPTI records no
   launch) and ``F.grid_sample`` at the same sample centres, the
   same reads and writes but not the same function);
8. Volleyball on disk: the host's CPU count, whether ``jpeglib.h`` and PIL
   exist and the decoder in use (a native build that fails where
   ``jpeglib.h`` exists fails the phase); a Volleyball tree the smoke writes
   in the reference layout at 720x1280 (videos 0 and 1 of 4 training clips,
   video 2 of 2 test clips, T=10, 12 track boxes a frame and one clip of 9,
   JPEG quality 90 of a seeded gradient plus noise); every frame of the
   clip-batch decode bit-equal to the single-frame decode and within a
   JPEG tolerance of its source (mean |diff| <= 5, max <= 48); the tree
   packed (``DINPACK1``) and read back bit-equal with 0 misses; the host
   loader's clips/s over the stage-2 training set at batch 2 with 1 and 4
   workers from the JPEGs, from the pack and from a warm FrameCache, beside
   phase 5's step rate; the flagship stage 2 through ``train_net`` from the
   JPEG tree, grafted from phase 4's stage-1 file (3 steps at batch 2, the
   eval of the 2 test clips, a checkpoint), every step's and eval call's
   batch on the card bit-equal to the loader's numpy batch, finite losses,
   the launch counts, the epoch line's clips/s and peak memory; the same
   run from the pack (first batch bit-equal, step-1 loss within rtol 1e-5,
   0 misses, no live decode); ``--stage2-model-path <that checkpoint>
   --eval-only`` (the same accuracy, loss within rtol 1e-5, K3 launched, no
   step, no file but its log and metrics stream); and
   ``volleyball_stage1`` from the tree with its ``test_before_train`` eval
   (epoch 0), one step of 8 one-frame clips and 10-frame eval clips;
9. the Collective Activity path (ResNet-18 with live BatchNorm, 480x720,
   T=10, 13 actor slots; K1 and K1b only): a ResNet-18 ``BasenetCollective``
   (``collective_stage1`` with ``backbone="res18"``) through ``train_net``
   from a torchvision-layout ResNet-18 file with BatchNorm statistics that
   the smoke writes (the loaded tensors equal the file's): 3 steps at batch
   16 (T=1), an eval of 16 clips at batch 8 (5 chunks of 16 frames a call),
   ``basemodel_CAD_res18.pth``; ``collective_stage2_dynamic`` grafted from
   it (``backbone.*`` with its BatchNorm buffers and ``fc_emb_1`` equal the
   file's before the first step): 3 steps at batch 2, the eval at batch 8,
   a checkpoint; ms per step, clips/s and peak memory of both stages on one
   batch, one profiled stage-2 step; ``Predictor(pad_to=2)`` requests of 1,
   3 (13, 1 and 7 actors) and 1 clips (rows sum to 1, the repeated clip's
   answer, a padded box moved onto the map changes nothing, 1-clip
   latency); the card against the CPU at 128x192, T=3 (posteriors within
   1e-4, 3 training steps' losses within rtol 1e-4, parameters within
   Adam's largest steps plus 2 f32 ulps); a Collective Activity
   tree at 480x720 that the smoke writes (sequences 1 and 2 train, 5 test)
   and its pack: stage 2 from each (batches on the card bit-equal to the
   loader's, the pack's first batch and step-1 loss equal the JPEGs'), and
   ``--eval-only`` of the JPEG run's checkpoint; launch counts of every run
   against ``derived_counts`` (K2, K2b and K3 0); two runs of 2
   ``collective_stage2_dynamic`` steps at batch 2 from one state bit-equal
   in losses, parameters and Adam moments;
10. serving phase 4's trained flagship checkpoint: the stage-2 ``.pth``
   ``train_net`` wrote and its reference-ordered copy, each through
   ``Predictor.from_checkpoint(pad_to=2)``, answer a 1-clip and a 3-clip
   request bit-equal to the trained model in memory; a copy without one
   tensor raises; ``serve_http`` on 127.0.0.1 in a thread answers
   ``/healthz``, the 1- and 3-clip ``/predict`` (JSON posteriors equal the
   Predictor's after the float32 round-trip) and a malformed body (400);
   six 1-clip HTTP requests and six direct calls in turns (host clock);
   ``inspect_ckpt`` counts the model's parameters; launch counts of each
   path against ``derived_counts``;
11. the DIN variants at full width: ``volleyball_stage2_dynamic_
   hierarchical``, ``_multi`` and ``_tce``, each through ``train_net``
   grafted from phase 4's stage-1 file (3 steps at batch 2, an eval pass, a
   checkpoint), ms per step and peak memory on one batch, a 1- and a 3-clip
   request at ``pad_to=2`` from that checkpoint, and the card against the
   CPU at phase 6's geometry (posteriors within 1e-4 and logits within
   1e-4 of their largest |value|, with TF32 off and with the default
   flags; 3 training steps with TF32 off, dropout 0, the fixed
   rate dropouts of the hierarchical head and TCE at 0 as the two devices'
   generators draw different masks: losses rtol 1e-4, parameters within
   ``check_params``'s bounds with ``ulps=0``; along the card's own
   trajectory the share beyond 2e-5 is reported, not bounded, as stage
   1's); launch counts of every run against ``derived_counts``;
12. the ResNet-18 baselines at full width (720x1280, a 23x40 map, 12
   actors, NFB 1024): a ResNet-18 stage 1 on Volleyball
   (``volleyball_stage1`` with ``backbone="res18"``) through ``train_net``
   from a torchvision-layout ResNet-18 file (3 steps at batch 8, its
   evals), ``basemodel_VD_res18.pth``; then ``volleyball_stage2_pctdm``,
   ``_higcin`` (7x7 crops), ``_at``, ``_arg`` (frozen backbone, T=3,
   ``test_before_train``) and ``_sacrf_biute``, each through
   ``train_net`` grafted from that file (3 steps at batch 2, an eval of 16
   clips, a checkpoint), ms per step, peak memory and the idle share of
   one profiled step on one batch, ``Predictor.from_checkpoint(pad_to=2)``
   requests of 1 and 3 clips (ARG's of 9 frames: three crops of 3) and the
   median of six 1-clip requests, and the card against the CPU at 128x192,
   T=3 (as in phase 11, the same helper: posteriors and logits, then 3
   training steps; the parameters' bound with Adam's largest step at each
   step number and 2 f32 ulps, as phase 9's; the BatchNorm running
   statistics after a forced step within 1e-4 of each tensor's largest
   |value|, along the card's own trajectory reported, not bounded);
   GCNNet for Volleyball (the ARG preset) and for Collective Activity
   (``collective_stage2_dynamic``, 480x720) with the model name switched:
   a 1-clip request and one step each; launch counts of every run against
   ``derived_counts`` (K1b none with a frozen backbone);
13. the remaining backbones of din_tpu at full width: K1 and K1b at their
   maps (Inception-v3's Mixed_5d of an 8-clip collective eval call,
   [80,57,87,288] with 13 boxes, 4 zero-padded, and of 720x1280 frames,
   [20,87,157,288]; ResNet-50's [20,23,40,2048]; AlexNet's [20,21,39,256];
   12 person-sized boxes; VGG-19's map is VGG-16's) against their plain
   versions as in phase 2 and timed as in phase 7;
   ``collective_stage1`` as the preset defines it (Inception-v3 with live
   BatchNorm, 480x720, out_size Mixed_5d's 57x87, Mixed_6e's 28x43 through
   the resize rows composed into RoIAlign's) through ``train_net`` from a
   torchvision-layout Inception-v3 file the smoke writes (3 steps at batch
   16, an eval of 16 clips of T=10 at batch 8, the component file reloaded
   strictly), its step time and peak memory; ``volleyball_stage1`` on
   Inception-v3 at 720x1280 (out_size 87x157, D=1056: 2 steps at batch 8,
   its evals), the flagship head grafted from it (2 timed steps at batch
   2, T=10, N=12, peak memory; ``train_net`` 2 steps, an eval, a
   checkpoint), ``Predictor.from_checkpoint(pad_to=2)`` 1-clip requests
   (median of six); VGG-19, ResNet-50 and AlexNet under the flagship head
   at their own maps, each from a torchvision-layout file loaded with
   ``load_pretrained_backbone`` (the loaded tensors equal the file's):
   1-clip requests and 2 steps at batch 2; the card against the CPU at
   128x192, T=3, for the three and ``collective_stage1`` (phase 12's
   helper; the BatchNorm backbones with Adam's largest step plus 2 f32
   ulps and running statistics within 1e-4, VGG-19 and AlexNet with the
   VGG-16 paths' bounds); launch counts of every path against
   ``derived_counts``;
14. the serving artifact (``experiments/export_serving.py``): phase 4's
   trained flagship ``.pth`` through ``Predictor.from_checkpoint(pad_to=2)``
   and a collective ``DynamicCollective`` (ResNet-18 from a
   torchvision-layout file with BatchNorm statistics, random DIN convs,
   480x720, T=10, 13 slots, ``bboxes_num``) exported by ``export_predictor`` at batch 2 (the
   export time, the file size, the header); a fresh interpreter loads both
   files with no module of ``din_tpu_torch.models``, ``heads``, ``nn`` or
   ``train`` (it exits non-zero otherwise), launches the kernels of one
   1-clip call (equal to the live call's and to ``derived_counts``: K3 4,
   K2 16, K1 1 for the flagship, K1 1 for the collective model), answers
   1-, 2- and 3-clip requests with the default flags and again with
   ``cudnn.allow_tf32 = True`` set (each within 1e-5 of the live
   Predictor's posteriors), and once without the program's IEEE f32
   context (reported); then the median of six 1-clip requests through the
   artifact beside the live Predictor's, in turns;
15. the training infrastructure (``train/engine.py``, ``train/preempt.py``,
   ``train/checkpoint.py``, ``utils/meters.py``, ``utils/logging.py``,
   ``utils/profiling.py``, ``heads/tce.py``) on the flagship at full width
   with random weights: (a) one step on 4 clips whole and one at
   ``grad_accum_steps=2`` from the same state (dropout 0, both in 5-frame
   backbone chunks, so that
   cuDNN's bf16 convolutions see the same shapes): losses within rtol
   1e-5, counters and confusion equal, parameters within
   ``check_params``' one-step bounds, launches those of one bs4 step and
   of two bs2 micro-steps; then both at the default chunks (8 frames
   whole, 5 per micro-step): their loss gap reported, ms per step and
   peak memory of each; (b) ``train_net`` with dropout 0.3 over
   an epoch of exactly 4 batches of 2: two uninterrupted runs, then a run
   that sends itself SIGTERM after its second step (through a wrapper of
   the engine's ``train_step``) and must leave
   ``stage2_epoch0_preempt.pth`` (step 2, the dropout generator's state)
   and its log line, the generator's state that of the first
   uninterrupted run after step 2, then ``auto_resume``, which must log
   "resuming at epoch 1, step 2", start from the file's weights, Adam
   state and generator bit for bit, train steps 3 and 4 on the first
   run's batches 3 and 4 (launch counts derived) and end with its generator
   state; the second uninterrupted run and the resumed run are bit-equal
   to the first in losses, parameters and Adam moments (a training step
   sums in a fixed order), and so are two runs of 2
   ``collective_stage2_dynamic`` steps at batch 2 from one state; (c) MAD:
   an eval with
   ``measure_mad`` at phase 6's geometry on the card against the CPU
   (within 1e-5 relative), and at full width (finite, its launches those
   of an eval without MAD, its ms against one without, in turns); (d)
   three epochs with ``keep_checkpoints=1`` and ``profile_dir``: the files
   ``prune_checkpoints``' rule names, ``metrics.jsonl`` with a record per
   reported epoch and phase, the run's entry in ``experiments.json``, and a
   trace that names K1's, K1b's, K2's and K2b's kernels; (e) the raw-RoI
   TCE pieces and the bilinear attention in f32 at the [20,45,80,256]
   context, on the card and the CPU, each against a float64 CPU run: the
   card no farther from it than twice the CPU or 1e-5 of max |y| (the
   peaked attention over 3600 cells moves f32 results by ~1e-4 with the
   summation order), the card-CPU gap reported;
16. training on more than one rank (``parallel/``, one process each,
   started by ``parallel/launch.py``; the earlier phases' card memory freed
   first), flagship at full width with random weights, synthetic clips, 2
   clips a rank: (a) one rank over NCCL: a step through
   ``DistributedDataParallel`` with the port's summing hook bit-equal to
   the plain step from one state, dropout on, then ``train_net`` (3 steps
   at batch 2, an eval pass); then two gloo ranks sharing ``cuda:0``: (b)
   the data-parallel step against one process's step of the same 4 clips,
   both in 5-frame chunks, dropout 0 (loss within 1e-5 relative,
   ``check_params``' one-step bounds, every rank bit-equal), the gap at
   the default chunks reported, two steps with dropout on bit-equal, a
   ZeRO-1 step bit-equal to the replicated one and each rank's Adam bytes;
   (c) the collective ResNet-18 (live BatchNorm, its chunk statistics
   reduced over the ranks) against one process, 5-frame chunks
   (``ulps=2``, running statistics within 1e-4 of their largest |value|);
   (d) frame parallel (one data group, 2 model ranks splitting its 20
   frames, the RoI features gathered) against one process's step of the 2
   clips; (e) ``train_net`` over 8 clips with SIGTERM to rank 1 alone
   after its first step: both ranks stop there, one
   ``stage2_epoch0_preempt.pth``, and the auto-resumed run is bit-equal to
   an uninterrupted 2-rank run; (f) each rank's launches of each path
   against ``derived_counts`` of one rank (``plan_calls``), the ``kernels``
   line's ``ranks_*`` entries; (g) each rank's step time beside one
   process's step of the 4 clips: two processes sharing one card, not a
   scaling figure.

The last lines are the kernels' JSON line, the card's nvidia-smi line and
the result line ``{"ok": true, "device": {...}}``.  With no card, or run
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor cores (the
# pool and RoIAlign kernels compute in f32 registers) and the dense bf16
# tensor-core rate (K3's conv1_2)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    a = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _randomize_din(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Random offset/affinity convs (they are zero at init), so the DIN walk
    leaves the integer grid and the bilinear path is exercised."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".p_conv." in name or ".scale_conv." in name:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))


def edge_boxes(n_frames: int, n_boxes: int, H: int, W: int,
               gen: torch.Generator) -> torch.Tensor:
    """[F,N,4] random boxes over the map plus, in every frame, exact-binary
    boxes on the border, one partly off the map, one of zero area and one
    fully outside."""
    x1 = torch.rand(n_frames, n_boxes, generator=gen) * (W + 4) - 3
    y1 = torch.rand(n_frames, n_boxes, generator=gen) * (H + 4) - 3
    w = torch.rand(n_frames, n_boxes, generator=gen) * 6 + 0.5
    h = torch.rand(n_frames, n_boxes, generator=gen) * 6 + 0.5
    boxes = torch.stack([x1, y1, x1 + w, y1 + h], -1)
    boxes[:, 0] = torch.tensor([0.0, -1.0, 5.0, 4.0])
    boxes[:, 1] = torch.tensor([W - 5.0, H - 5.0, float(W), float(H)])
    boxes[:, 2] = torch.tensor([3.25, 2.5, 3.25, 2.5])
    boxes[:, 3] = torch.tensor([W + 1.0, H + 1.0, W + 3.0, H + 3.0])
    return boxes


def time_cuda(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean ms of ``fn`` on the card, each launch timed by CUDA events after
    a write of ``flush`` (larger than the L2 cache) so inputs start cold."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def traced_step(step_fn) -> dict:
    """``breakdown`` of one call of ``step_fn``, whose model is dropped
    after it; traced again, up to 3 traces in all, while the profiler
    records no device time (a trace on the card has once come back without
    a kernel)."""
    from din_tpu_torch.experiments.profile_training import breakdown

    for attempt in range(3):
        prof = breakdown(step_fn, 1)
        if prof["busy_us"] > 0:
            return prof
        log(f"[profiler] trace {attempt + 1} of 3 recorded no device time")
    raise RuntimeError("the profiler recorded no device time in 3 traces")


def roi_sampled_bytes(features: torch.Tensor, boxes: torch.Tensor,
                      crop, ys_xs) -> int:
    """Bytes RoIAlign must move for these boxes: each distinct feature row
    (pixel) that an in-range sample reads, read once; the sample centres;
    the output, written once."""
    ys, xs = (t.cpu().double().numpy() for t in ys_xs)
    Fr, H, W, C = features.shape
    item = features.element_size()
    rows = set()
    for f in range(Fr):
        for n in range(boxes.shape[1]):
            for y in ys[f, n]:
                if not 0.0 <= y <= H - 1:
                    continue
                for x in xs[f, n]:
                    if not 0.0 <= x <= W - 1:
                        continue
                    for yy in {math.floor(y), math.ceil(y)}:
                        for xx in {math.floor(x), math.ceil(x)}:
                            rows.add((f, yy, xx))
    out = Fr * boxes.shape[1] * crop[0] * crop[1] * C * item
    return len(rows) * C * item + (ys.size + xs.size) * 4 + out


def check_roi_kernels(feats: torch.Tensor, boxes: torch.Tensor, crop,
                      dgen: torch.Generator) -> dict:
    """K1 and K1b against their plain versions on the map ``feats``
    [F,H,W,C] (f32) with ``boxes`` [F,N,4], in f32 and bf16: K1 bit-equal
    to the plain version on the card, K1b within 1e-5 of max|df| of the
    plain version on the card (plus 1 bf16 ulp in bf16) and bit-equal to it
    run on the CPU.  Returns the largest errors by name."""
    from din_tpu_torch.ops.roi_align import (roi_align, roi_align_bwd,
                                             roi_align_bwd_ref,
                                             roi_align_ref)

    hw = tuple(feats.shape[1:3])
    errs = {}
    for dtype, tag, bits in ((torch.float32, "f32", torch.int32),
                             (torch.bfloat16, "bf16", torch.int16)):
        f_dt = feats.to(dtype)
        errs["k1_" + tag] = k1_bits(f_dt, boxes, crop,
                                    f"{list(feats.shape)} crop {crop}")
        g = torch.randn((*boxes.shape[:2], *crop, feats.shape[-1]),
                        generator=dgen, device=feats.device).to(dtype)
        got = roi_align_bwd(g, boxes, hw, dtype)
        ref = roi_align_bwd_ref(g, boxes, hw, torch.float32)
        want = roi_align_bwd_ref(g.cpu(), boxes.cpu(), hw, dtype)
        torch.cuda.synchronize()
        diff = (got.float() - ref).abs()
        ulp = bf16_ulp(torch.maximum(got.float().abs(), ref.abs())) \
            if dtype == torch.bfloat16 else 0
        scale = ref.abs().max().item()
        excess = (diff - ulp).max().item()
        differ = int((got.cpu().view(bits) != want.view(bits)).sum())
        require(excess <= 1e-5 * scale and differ == 0,
                f"roi_align_bwd {tag} at {list(feats.shape)} crop {crop}: "
                f"excess {excess} over 1e-5 * {scale}, {differ} elements "
                f"differ from the CPU plain version")
        errs["k1b_" + tag] = diff.max().item()
    return errs


def roi_times(feats: torch.Tensor, boxes: torch.Tensor, crop,
              dgen: torch.Generator, flush: torch.Tensor) -> dict:
    """CUDA-event times of K1 and K1b (wrappers) and their plain versions
    on ``feats`` [F,H,W,C] bf16 with ``boxes``, beside their bounds, and
    K1's ``k1_yardsticks`` (``k1_launch_ms``, ``k1_device_ms``,
    ``k1_grid_sample_ms``): K1
    reads each distinct feature row a sample in range touches, the boxes,
    and writes the output, 11 operations per sample in range and channel
    (4 corner reads blended); K1b reads g's rows of the samples in range
    and the boxes and writes d(features), 8 operations per sample in range
    and channel."""
    from din_tpu_torch.ops.roi_align import (_sample_grid, roi_align,
                                             roi_align_bwd,
                                             roi_align_bwd_ref,
                                             roi_align_ref)

    Fr, H, W, C = feats.shape
    ys, xs = _sample_grid(boxes, crop)
    in_range = int((((ys >= 0) & (ys <= H - 1))[..., :, None]
                    & ((xs >= 0) & (xs <= W - 1))[..., None, :]).sum())
    g = torch.randn((*boxes.shape[:2], *crop, C), generator=dgen,
                    device=feats.device).bfloat16()
    k1_bytes = roi_sampled_bytes(feats, boxes, crop, (ys, xs))
    k1b_bytes = (in_range * C * g.element_size() + boxes.numel() * 4
                 + feats.numel() * feats.element_size())
    k1y = k1_yardsticks(feats, boxes, crop, flush)
    return dict(
        **{"k1_" + k: v for k, v in k1y.items()},
        k1_ms=time_cuda(lambda: roi_align(feats, boxes, crop), 100, flush),
        k1_plain=time_cuda(lambda: roi_align_ref(feats, boxes, crop), 100,
                           flush),
        k1_bound=max(k1_bytes / HBM_BYTES_PER_S,
                     11 * in_range * C / F32_FLOPS_PER_S) * 1e3,
        k1b_ms=time_cuda(lambda: roi_align_bwd(g, boxes, (H, W),
                                               torch.bfloat16), 100, flush),
        k1b_plain=time_cuda(lambda: roi_align_bwd_ref(
            g, boxes, (H, W), torch.bfloat16), 100, flush),
        k1b_bound=max(k1b_bytes / HBM_BYTES_PER_S,
                      8 * in_range * C / F32_FLOPS_PER_S) * 1e3,
        k1_mb=k1_bytes / 1e6, k1b_mb=k1b_bytes / 1e6, in_range=in_range,
        samples=ys.shape[0] * ys.shape[1] * crop[0] * crop[1])


def k1_bits(feats: torch.Tensor, boxes: torch.Tensor, crop,
            what: str) -> float:
    """K1 against ``roi_align_ref`` on the card on ``feats`` in its dtype:
    bit for bit (the kernel rounds its blend op by op in the plain
    version's order).  Returns the largest |difference|, 0."""
    from din_tpu_torch.ops.roi_align import roi_align, roi_align_ref

    bits = torch.int32 if feats.dtype == torch.float32 else torch.int16
    got, ref = roi_align(feats, boxes, crop), roi_align_ref(feats, boxes,
                                                            crop)
    torch.cuda.synchronize()
    n = int((got.view(bits) != ref.view(bits)).sum())
    require(n == 0, f"roi_align {what} {feats.dtype}: {n} of {ref.numel()} "
            f"values differ from roi_align_ref")
    return float((got.float() - ref.float()).abs().max())


def k1_yardsticks(feats: torch.Tensor, boxes: torch.Tensor, crop,
                  flush: torch.Tensor) -> dict:
    """K1 on ``feats`` [F,H,W,C] with ``boxes`` (f32, contiguous): the
    launch alone with its output made beforehand (CUDA events, mean of
    100), its device time from ``kernel_device_ms`` (mean of 20 launches:
    an event pair around a kernel of a few microseconds is close to the
    events' resolution) and how that was read, and ``F.grid_sample`` (bilinear, zero padding,
    ``align_corners=True``) of the NCHW view of the same map at the same
    sample centres: the same reads and writes, not the same function (it
    differs at the border, where RoIAlign's sample is 0 as a whole)."""
    import torch.nn.functional as F

    from din_tpu_torch.ops import native
    from din_tpu_torch.ops.roi_align import _sample_grid

    Fr, H, W, C = feats.shape
    N = boxes.shape[1]
    out = torch.empty((Fr, N, *crop, C), dtype=feats.dtype,
                      device=feats.device)
    lib, stream = native.library(), native.current_stream(feats)
    code = native.dtype_code(feats.dtype)

    def bare():
        native.check(lib.din_roi_align(
            feats.data_ptr(), boxes.data_ptr(), out.data_ptr(), Fr, H, W, C,
            N, *crop, code, stream), "roi_align")

    launch_ms = time_cuda(bare, 100, flush)
    device_ms, device_by = kernel_device_ms(
        lambda s: native.check(lib.din_roi_align(
            feats.data_ptr(), boxes.data_ptr(), out.data_ptr(), Fr, H, W, C,
            N, *crop, code, s), "roi_align"), "roi_align_kernel", flush)
    ys, xs = _sample_grid(boxes, crop)
    gy = (2 * ys / (H - 1) - 1)[:, :, :, None].expand(-1, -1, -1, crop[1])
    gx = (2 * xs / (W - 1) - 1)[:, :, None, :].expand(-1, -1, crop[0], -1)
    grid = torch.stack([gx, gy], -1).reshape(Fr, N * crop[0], crop[1],
                                             2).to(feats.dtype)
    xn = feats.permute(0, 3, 1, 2)
    grid_ms = time_cuda(lambda: F.grid_sample(
        xn, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        100, flush)
    return dict(launch_ms=launch_ms, device_ms=device_ms,
                device_ms_by=device_by, grid_sample_ms=grid_ms)


def kernel_device_ms(launch, kernel: str, flush: torch.Tensor,
                     n: int = 20) -> tuple:
    """Mean device time in ms of one ``launch(stream)`` of ``kernel`` (a
    substring of its symbol) on the current stream, ``flush`` written
    before each launch, and how it was read: "profiler", from
    ``torch.profiler`` over ``n`` launches, traced up to 3 times while
    CUPTI records no launch of ``kernel`` (a trace on the card has once
    come back without it); else "cuda graph", from CUDA events around
    replays of a graph of ``n`` flushes and launches, less a graph of the
    ``n`` flushes alone."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    for attempt in range(3):
        stream = torch.cuda.current_stream().cuda_stream
        with torch.profiler.profile(activities=[cuda]) as prof:
            for _ in range(n):
                flush.zero_()
                launch(stream)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        if events:
            return (sum(e.device_time_total for e in events)
                    / sum(e.count for e in events) / 1e3, "profiler")
        log(f"[profiler] trace {attempt + 1} of 3 recorded no {kernel}")

    def replay_ms(with_kernel: bool) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                flush.zero_()
                if with_kernel:
                    launch(side.cuda_stream)
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(10):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10

    ms = (replay_ms(True) - replay_ms(False)) / n
    require(ms > 0, f"{kernel}: no device time from a CUDA graph either")
    return ms, "cuda graph"


def two_steps_bit_equal(cfg, dev, seed: int, what: str) -> None:
    """Two runs of 2 training steps of ``cfg`` at batch 2 from one state
    (seeded random weights, the DIN head's convs too; one synthetic batch):
    the losses, parameters and Adam moments bit-equal (``train_step`` sums
    in a fixed order)."""
    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.train import engine
    from din_tpu_torch.train.optim import make_optimizer

    cfg = cfg.replace(batch_size=2)
    gen = torch.Generator().manual_seed(seed)
    start = build_model(cfg, device=dev, generator=gen)
    _randomize_din(start, gen)
    batch = to_device(make_synthetic_batch(
        cfg, 2, rng=np.random.RandomState(seed)), dev)
    runs = []
    for _ in range(2):
        model = copy.deepcopy(start)
        opt = make_optimizer(cfg, model)
        losses = [float(engine.train_step(model, opt, batch, cfg)["loss"])
                  for _ in range(2)]
        runs.append((losses, _train_snapshot(model, opt)))
        del model, opt
    (la, a), (lb, b) = runs
    differ = [k for part in ("params", "moments") for k in a[part]
              if not torch.equal(a[part][k], b[part][k])]
    require(la == lb and not differ and a["moments"],
            f"{what}: two runs of 2 steps from one state differ: losses "
            f"{la} and {lb}, {len(differ)} tensors {differ[:4]}")
    log(f"[determinism] {what} ({cfg.backbone}, {cfg.image_size[0]}x"
        f"{cfg.image_size[1]}, T={cfg.num_frames}, batch 2): two runs of 2 "
        f"steps from one state bit-equal: losses {la}, {len(a['params'])} "
        f"parameters and {len(a['moments'])} Adam moments")


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls in full float32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def head_convs_unrepaired():
    """The DIN head's offset and affinity convs as they ran before the
    repair: plain ``nn.Conv2d`` calls under whatever flags the process has
    (cuDNN's TF32 default on the card)."""
    from din_tpu_torch.heads.din import DynamicPersonInference

    saved = DynamicPersonInference.__dict__["_grid_conv"]
    DynamicPersonInference._grid_conv = staticmethod(
        lambda conv, x: conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    try:
        yield
    finally:
        DynamicPersonInference._grid_conv = saved


@contextlib.contextmanager
def conv_backward_unrepaired():
    """The float32 convolutions' backward as it ran before its repair: the
    forward in IEEE f32, the dgrad, wgrad and bias gradient under whatever
    flags the process has (cuDNN's TF32 default on the card)."""
    from din_tpu_torch.utils import precision

    saved = precision.conv2d_grads
    process_flag = torch.backends.cudnn.allow_tf32

    def grads(*args):
        inner = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = process_flag
        try:
            return saved(*args)
        finally:
            torch.backends.cudnn.allow_tf32 = inner

    precision.conv2d_grads = grads
    try:
        yield
    finally:
        precision.conv2d_grads = saved


def tf32_backward_check(run, extra=()) -> dict:
    """``run()`` returns a dict of gradients.  With cuDNN's deterministic
    algorithms (so that two runs of one setting agree bit for bit): twice
    with TF32 off, once under the card's default flags (repaired), once
    with the f32 convs' backward as before the repair, and once in each
    ``(name, context)`` of ``extra`` under the default flags.  Returns the
    largest difference of each against the first TF32-off run, and the
    gradients' largest magnitude."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with no_tf32():
            exact = run()
        with no_tf32():
            again = run()
        repaired = run()
        with conv_backward_unrepaired():
            unrepaired = run()
        others = {}
        for name, context in extra:
            with context():
                others[name] = run()
    finally:
        torch.backends.cudnn.deterministic = saved

    def diff(got):
        return max((got[k] - exact[k]).abs().max().item() for k in exact)

    return dict(noise=diff(again), after=diff(repaired),
                before=diff(unrepaired),
                **{k: diff(v) for k, v in others.items()},
                scale=max(v.abs().max().item() for v in exact.values()))


def stem_inputs(shape, dtype, gen: torch.Generator, b0_shift: float = 0.0,
                device="cuda"):
    """Frames in [-1,1] (as ``prep_images`` gives them) and VGG-16 stem
    weights at their init scale (lecun normal: std 1/sqrt(fan_in)), biases
    ~0.1, conv1_1's shifted by ``b0_shift``; all in ``dtype``."""
    x = torch.rand(shape, generator=gen, device=device) * 2 - 1
    w0 = torch.randn((64, 3, 3, 3), generator=gen, device=device) / 27 ** 0.5
    b0 = torch.randn(64, generator=gen, device=device) * 0.1 + b0_shift
    w2 = torch.randn((64, 64, 3, 3), generator=gen, device=device) / 24.0
    b2 = torch.randn(64, generator=gen, device=device) * 0.1
    return [t.to(dtype) for t in (x, w0, b0, w2, b2)]


# a CPU gradient no larger than this anywhere in a tensor is f32 noise:
# sums that cancel, as a softmax row is invariant to a constant added to it
# (the biases of ARG's phi embeddings and of PCTDM's team attention logits,
# at most 1.4e-8 at the card-against-CPU geometries, where every other
# tensor of every model checked there has a gradient of 8.7e-5 or more);
# Adam moves such a weight by up to lr with the noise's sign, so the two
# devices may differ by 2 lr in any share of its elements
NOISE_GRADIENT = 1e-7


def adam_ratio(t: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The largest |m_hat| / sqrt(v_hat) of Adam's t-th step (betas of
    ``make_optimizer``), by Cauchy-Schwarz over the t gradients: 1 at t = 1,
    1.00136 at 2, 1.00361 at 3."""
    return math.sqrt(sum(
        ((1 - b1) * b1 ** (t - i) / (1 - b1 ** t)) ** 2
        / ((1 - b2) * b2 ** (t - i) / (1 - b2 ** t)) for i in range(1, t + 1)))


def check_params(got: dict, want: dict, steps, lr: float, what: str,
                 share_bound=0.1, ulps: int = 0, noise=()) -> tuple:
    """The parameter bounds of tests/test_torch_train.py after a ReLU or
    pool flip: no element more than 2*lr per step apart (Adam moves each by
    about lr whatever its gradient's size; ``steps`` are the Adam step
    numbers t the two sides took apart), and elementwise 2e-5 for all but
    ``share_bound`` (10 %) of a tensor's elements (None: the share is only
    reported).  The flip bound applies: f32 sums on the two devices differ,
    and a pre-activation, pool window, actor max or DIN sample position that
    close to a switch takes the other branch.  With ``ulps`` (the ResNet-18
    paths, where flips are many) the bound is Adam's arithmetic itself:
    2*lr*``adam_ratio(t)`` per step, which Adam's f32 arithmetic (a few
    roundings) exceeds by up to ``ulps`` * 2**-22 of itself (measured
    2.4e-7 at t = 1 and 2), plus ``ulps`` times the f32 spacing of the
    element's larger side (w + lr and w - lr are each rounded at their own
    magnitude; at lr 5e-5 that shows).  A tensor of ``noise`` (names whose
    reference gradient is f32 noise, ``NOISE_GRADIENT``) is held to that
    bound only.  Returns the largest difference, the largest share beyond
    2e-5 and its tensor."""
    step_bound = sum(2 * lr * (adam_ratio(t) * (1 + ulps * 2 ** -22)
                               if ulps else 1) for t in steps)
    worst = share_worst = 0.0
    share_name = ""
    for name, w in want.items():
        w, g = w.float().cpu(), got[name].float().cpu()
        diff = (g - w).abs()
        share = 0.0 if name in noise else float((diff > 2e-5).float().mean())
        worst = max(worst, float(diff.max()))
        if share > share_worst:
            share_worst, share_name = share, name
        mag = torch.maximum(w.abs(), g.abs())
        tol = step_bound + ulps * (
            torch.nextafter(mag, torch.full_like(w, math.inf)) - mag)
        i = int((diff - tol).argmax())
        require(bool((diff <= tol).all()),
                f"{what}: {name} differs by {float(diff.max())}; element "
                f"{i}: {float(g.flatten()[i])} against "
                f"{float(w.flatten()[i])}, bound {float(tol.flatten()[i])}")
        require(share_bound is None or share <= share_bound,
                f"{what}: {name} has {share:.4f} of elements beyond 2e-5")
    return worst, share_worst, share_name


def train_card_vs_cpu(cfg, cpu_model, steps: int = 3,
                      free_share_bound=0.1, ulps: int = 0,
                      stats_rtol=None) -> dict:
    """``steps`` training steps of ``cpu_model`` on the CPU and, from copies
    of it, on the card: once from the CPU's state of each step (forced: one
    step's loss and update) and once along the card's own trajectory
    (free), on the batches of ``train_net``'s first epoch.  Forced losses
    within rtol 1e-4 of the CPU's; parameters within ``check_params``'s
    bounds (with ``ulps``; a tensor whose CPU gradient is f32 noise in any
    step, ``NOISE_GRADIENT``, without the share), the free trajectory's
    share beyond 2e-5 within ``free_share_bound``.  With ``stats_rtol`` the
    BatchNorm running statistics are held apart from the parameters, whose
    2 lr per step bound is Adam's: after a forced step within
    ``stats_rtol`` of each tensor's largest |value| (a batch variance taken
    as E[x^2] - E[x]^2 of an input with a large mean cancels, and the two
    devices sum in different orders), along the free trajectory reported,
    not bounded (they follow weights that have drifted apart).  Returns the
    losses, the largest differences and the noise tensors."""
    from din_tpu_torch.data.loader import BatchLoader, to_device
    from din_tpu_torch.data.synthetic import SyntheticDataset
    from din_tpu_torch.train.engine import train_step
    from din_tpu_torch.train.optim import make_optimizer

    dev = torch.device("cuda")
    forced = copy.deepcopy(cpu_model).to(dev)
    free = copy.deepcopy(cpu_model).to(dev)
    cpu_opt = make_optimizer(cfg, cpu_model)
    forced_opt = make_optimizer(cfg, forced)
    free_opt = make_optimizer(cfg, free)
    loader = BatchLoader(SyntheticDataset(cfg, seed=1), cfg.batch_size,
                         seed=cfg.train_random_seed)
    loader.set_epoch(1)
    lr = cfg.train_learning_rate
    losses = {"cpu": [], "forced": [], "free": []}
    perr = share = stats_err = 0.0
    stats = {k for k in cpu_model.state_dict()
             if k.endswith(("running_mean", "running_var"))}
    noise, grads = set(), {"noise": 0.0, "other": math.inf}
    ratios = []
    for t, b in zip(range(1, steps + 1), loader):
        forced.load_state_dict(cpu_model.state_dict())
        forced_opt.load_state_dict(copy.deepcopy(cpu_opt.state_dict()))
        for name, m, opt, d in (("cpu", cpu_model, cpu_opt, "cpu"),
                                ("forced", forced, forced_opt, dev),
                                ("free", free, free_opt, dev)):
            losses[name].append(float(train_step(
                m, opt, to_device(b, torch.device(d)), cfg)["loss"]))
        top = {n: float(p.grad.abs().max())
               for n, p in cpu_model.named_parameters() if p.grad is not None}
        step_noise = {n for n, g in top.items() if g <= NOISE_GRADIENT}
        noise |= step_noise
        b1, b2 = cpu_opt.param_groups[0]["betas"]
        ratios.append(max(float(((st["exp_avg"] / (1 - b1 ** t)).abs() / (
            (st["exp_avg_sq"] / (1 - b2 ** t)).sqrt() + 1e-8)).max())
            for st in cpu_opt.state.values()))
        for n, g in top.items():
            kind = "noise" if n in step_noise else "other"
            grads[kind] = (max if kind == "noise" else min)(grads[kind], g)
        want = cpu_model.state_dict()
        if stats_rtol is not None:
            got = forced.state_dict()
            for k in [k for k in want if k in stats]:
                v = want.pop(k).float()
                diff = float((got[k].float().cpu() - v).abs().max())
                scale = max(float(v.abs().max()), 1e-30)
                require(diff <= stats_rtol * scale,
                        f"card vs CPU, one step: {k} differs by {diff}")
                stats_err = max(stats_err, diff / scale)
        e, sh, _ = check_params(forced.state_dict(), want, (t,), lr,
                                "card vs CPU, one step", ulps=ulps,
                                noise=step_noise)
        perr, share = max(perr, e), max(share, sh)
    lerr = max(abs(a - b) / abs(b)
               for a, b in zip(losses["forced"], losses["cpu"]))
    require(lerr <= 1e-4, f"training losses card {losses['forced']} vs "
            f"CPU {losses['cpu']}")
    want = cpu_model.state_dict()
    free_stats = {k: float((free.state_dict()[k].float().cpu()
                            - want[k].float()).abs().max()) for k in stats}
    if stats_rtol is not None:
        want = {k: v for k, v in want.items() if k not in stats}
    free_perr, free_share, free_name = check_params(
        free.state_dict(), want, range(1, steps + 1), lr,
        f"card vs CPU, {steps} free steps", free_share_bound, ulps, noise)
    free_lerr = max(abs(a - b) / abs(b)
                    for a, b in zip(losses["free"], losses["cpu"]))
    return dict(losses=losses, lerr=lerr, perr=perr, share=share,
                free_lerr=free_lerr, free_perr=free_perr,
                free_share=free_share, free_name=free_name,
                free_share_bound=free_share_bound, stats_err=stats_err,
                free_stats=max(free_stats.values(), default=0.0),
                noise=sorted(noise), grads=grads, ratios=ratios)


def log_train_card_vs_cpu(what: str, cfg, r: dict, steps: int = 3) -> None:
    log(f"[card-vs-cpu] {what}: training {steps} steps, batch "
        f"{cfg.batch_size}, {cfg.image_size[0]}x{cfg.image_size[1]} f32 "
        f"(TF32 off), dropout 0, each step from the CPU's state: losses card "
        f"{r['losses']['forced']} CPU {r['losses']['cpu']} (max rel diff "
        f"{r['lerr']:.3g} <= 1e-4); params after one step max |diff| "
        f"{r['perr']:.3g} (<= 2 lr), largest share beyond 2e-5 "
        f"{r['share']:.4f} (<= 0.1)")
    log(f"[card-vs-cpu] {what}: the card's own {steps}-step trajectory: "
        f"losses {r['losses']['free']} (max rel diff {r['free_lerr']:.3g}, "
        f"reported, not bounded); params max |diff| {r['free_perr']:.3g} "
        f"(<= {2 * steps} lr), largest share beyond 2e-5 "
        f"{r['free_share']:.4f} in {r['free_name']} "
        + (f"(<= {r['free_share_bound']})" if r['free_share_bound']
           else "(reported, not bounded)"))
    log(f"[card-vs-cpu] {what}: Adam's largest |m_hat| / (sqrt(v_hat) + "
        f"eps) on the CPU at steps 1-{steps}: "
        + ", ".join(f"{v:.8f}" for v in r["ratios"]) + " (adam_ratio: "
        + ", ".join(f"{adam_ratio(t):.8f}" for t in range(1, steps + 1))
        + ")")
    log(f"[card-vs-cpu] {what}: CPU gradients, each tensor's largest |g| "
        f"in a step: at least {r['grads']['other']:.3g} but for "
        f"{len(r['noise'])} tensors of f32 noise (<= {NOISE_GRADIENT:g}, at "
        f"most {r['grads']['noise']:.3g}), held to the 2 lr bound without "
        f"the share: {', '.join(r['noise']) or 'none'}")


def card_vs_cpu(short: str, cfg, cpu_model, clip: dict, n_fixed: int,
                ulps: int = 0, stats_rtol=None) -> float:
    """One model of phases 11-13 on the card against the CPU at the small
    geometry ``cfg`` (f32, dropout 0, ``n_fixed`` fixed-rate dropouts at 0
    in ``cpu_model``): serving ``clip`` (with its ``bboxes_num`` for a
    collective model), with TF32 off and with the
    card's default flags, posteriors within 1e-4 and logits within 1e-4 of
    their largest |value| (a saturated softmax hides a wrong head); then
    ``train_card_vs_cpu`` with TF32 off, the free trajectory's share
    reported, not bounded, and the phase's ``ulps`` and ``stats_rtol``.
    Returns the largest posterior difference."""
    from din_tpu_torch.experiments.predict import Predictor

    inputs = [clip[k] for k in ("images", "boxes", "bboxes_num")
              if k in clip]

    def logits(predictor):
        args = [torch.from_numpy(np.ascontiguousarray(v)).to(
            predictor.device) for v in inputs]
        with torch.inference_mode():
            out = predictor.model(*args)
        return {k: out[k].float().cpu() for k in ("activities", "actions")
                if k in out}

    on_cpu = Predictor(cfg, cpu_model, device="cpu")
    want, want_logits = on_cpu(*inputs), logits(on_cpu)
    errs, lerrs = {}, {}
    for what, flags in (("TF32 off", no_tf32),
                        ("default flags", contextlib.nullcontext)):
        with flags():
            on_gpu = Predictor(cfg, copy.deepcopy(cpu_model))
            got, got_logits = on_gpu(*inputs), logits(on_gpu)
        errs[what] = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        lerrs[what] = max(float((got_logits[k] - v).abs().max()
                                / v.abs().max())
                          for k, v in want_logits.items())
        require(errs[what] <= 1e-4 and lerrs[what] <= 1e-4,
                f"{short} card vs CPU ({what}): max |diff| of posteriors "
                f"{errs[what]}, of logits {lerrs[what]} of their largest")
    B, T = clip["images"].shape[:2]
    log(f"[card-vs-cpu] {short}: serving {B} clip{'s' * (B > 1)} T={T} "
        f"{cfg.image_size[0]}x{cfg.image_size[1]} f32: max |diff| of "
        f"posteriors {errs['TF32 off']:.3g} (TF32 off), "
        f"{errs['default flags']:.3g} (the card's default flags) (<= 1e-4); "
        f"of logits {lerrs['TF32 off']:.3g}, {lerrs['default flags']:.3g} "
        f"of their largest |value| (<= 1e-4)")
    with no_tf32():
        r = train_card_vs_cpu(cfg, cpu_model, free_share_bound=None,
                              ulps=ulps, stats_rtol=stats_rtol)
    log_train_card_vs_cpu(
        f"{short} (its {n_fixed} fixed-rate dropouts at 0"
        + (f"; bounds Adam's largest steps plus {ulps} f32 ulps of each "
           f"parameter" if ulps else "") + ")", cfg, r)
    if stats_rtol is not None:
        log(f"[card-vs-cpu] {short}: BatchNorm running statistics after one "
            f"step from the CPU's state within {r['stats_err']:.3g} of each "
            f"tensor's largest |value| (<= {stats_rtol:g}); along the card's "
            f"own trajectory max |diff| {r['free_stats']:.3g} (reported, not "
            f"bounded: they follow the drifted weights)")
    return max(errs.values())


# the JAX package's exporter writes a stage-2 DIN model's keys in this order
# (din_tpu/nn/ref_export.py:221-305); the port registers point_conv and
# point_ln before DPI
EXPORTER_ORDER = ("backbone.", "fc_emb_1.", "nl_emb_1.", "DPI.", "dpi_nl.",
                  "point_ln.", "point_conv.", "fc_activities.")


def reference_ordered(saved: dict, names: list) -> dict:
    """The port's stage-2 file ``saved`` rewritten as the reference
    framework writes one: state_dict keys in the exporter's order, and the
    Adam state keyed by parameter index in that order.  ``names`` are the
    port's trainable parameter names in its own index order."""
    keys = sorted(saved["state_dict"], key=lambda k: next(
        i for i, pre in enumerate(EXPORTER_ORDER) if k.startswith(pre)))
    opt = saved["optimizer"]
    return {"epoch": saved["epoch"],
            "state_dict": {k: saved["state_dict"][k] for k in keys},
            "optimizer": {
                "state": {j: opt["state"][names.index(k)]
                          for j, k in enumerate(keys)},
                "param_groups": [dict(opt["param_groups"][0],
                                      params=list(range(len(keys))))]}}


def time_host(fn, iters: int) -> list:
    """ms of each of ``iters`` calls of ``fn``, host clock, each ended by a
    synchronize."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def write_volleyball_tree(root: Path, H: int, W: int, seed: int,
                          clips=((0, (10, 20, 30, 40)), (1, (10, 20, 30, 40)),
                                 (2, (10, 20))),
                          short=(1, 20)) -> dict:
    """A Volleyball tree in the reference layout (``<sid>/annotations.txt``,
    ``<sid>/<src_fid>/<fid>.jpg`` for fid = src_fid-5 .. src_fid+4,
    ``tracks_normalized.pkl``): JPEGs of quality 90 of a seeded gradient
    plus noise, 12 normalized track boxes per frame (9 in clip ``short``,
    padded by repetition when read), activities and actions from the class
    lists.  Returns {path relative to root: the source uint8 frame}."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from din_tpu_torch.data.volleyball import ACTIONS, ACTIVITIES

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 200 // W + 20, yy * 200 // H + 20,
                     (xx + yy) * 160 // (H + W) + 40], -1).astype(np.int16)
    tracks, jobs = {}, []
    for sid, srcs in clips:
        lines = []
        for k, src in enumerate(srcs):
            n = 9 if (sid, src) == short else 12
            y1, x1 = rng.uniform(0.0, 0.8, (2, n))
            h, w = rng.uniform(0.05, 0.2, (2, n))
            acts = rng.randint(0, len(ACTIONS), n)
            people = " ".join(
                f"{int(x * W)} {int(y * H)} {int(b * W)} {int(a * H)} "
                f"{ACTIONS[c]}" for x, y, b, a, c in zip(x1, y1, w, h, acts))
            lines.append(f"{src}.jpg {ACTIVITIES[(4 * sid + k) % 8]} {people}")
            noise = rng.randint(-24, 25, (H, W, 1), dtype=np.int16)
            tracks[(sid, src)] = {}
            (root / str(sid) / str(src)).mkdir(parents=True)
            for j, fid in enumerate(range(src - 5, src + 5)):
                d = rng.uniform(-0.01, 0.01, (n, 2))
                tracks[(sid, src)][fid] = np.stack(
                    [y1 + d[:, 0], x1 + d[:, 1], y1 + h + d[:, 0],
                     x1 + w + d[:, 1]], -1)
                jobs.append((f"{sid}/{src}/{fid}.jpg", noise, 37 * j + 5 * k))
        (root / str(sid) / "annotations.txt").write_text(
            "\n".join(lines) + "\n")
    with open(root / "tracks_normalized.pkl", "wb") as f:
        pickle.dump(tracks, f)

    def encode(job):
        rel, noise, shift = job
        img = np.clip(base + np.roll(noise, shift, axis=1), 0,
                      255).astype(np.uint8)
        Image.fromarray(img).save(root / rel, "JPEG", quality=90)
        return rel, img

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(encode, jobs))


class EngineTap:
    """Patches the training engine for one run and records what it hands
    on: each step's and eval call's device batch (cloned on the step's
    stream, i.e. what the step reads), each step's metrics, each eval
    pass's info and the datasets ``return_dataset`` built."""

    NAMES = ("train_step", "eval_step", "run_eval", "return_dataset")

    def __init__(self, engine):
        self.engine = engine
        self.saved = {n: getattr(engine, n) for n in self.NAMES}
        self.train_batches, self.metrics, self.eval_batches = [], [], []
        self.evals, self.datasets = [], []

    def __enter__(self):
        saved = self.saved

        def train_step(model, optimizer, batch, cfg):
            self.train_batches.append({k: v.clone() for k, v in batch.items()})
            self.metrics.append(saved["train_step"](model, optimizer, batch,
                                                    cfg))
            return self.metrics[-1]

        def eval_step(model, batch, cfg):
            self.eval_batches.append({k: v.clone() for k, v in batch.items()})
            return saved["eval_step"](model, batch, cfg)

        def run_eval(*args, **kwargs):
            self.evals.append(saved["run_eval"](*args, **kwargs))
            return self.evals[-1]

        def return_dataset(cfg):
            self.datasets.append(saved["return_dataset"](cfg))
            return self.datasets[-1]

        for name, fn in (("train_step", train_step), ("eval_step", eval_step),
                         ("run_eval", run_eval),
                         ("return_dataset", return_dataset)):
            setattr(self.engine, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.engine, name, fn)
        return False


def same_batches(tapped: list, batches: list) -> bool:
    """The tapped device batches equal the loader's numpy batches, bit for
    bit, key by key."""
    return len(tapped) == len(batches) and all(
        sorted(t) == sorted(b) and all(
            torch.equal(t[k].cpu(), torch.from_numpy(np.ascontiguousarray(
                b[k]))) for k in b)
        for t, b in zip(tapped, batches))


def volleyball_on_disk(dev, tmp: Path, s1_path: str, smi: str,
                       step_clips_s: float, reset_counts, read_counts,
                       image_size=(720, 1280), shrink=lambda c: c) -> dict:
    """Phase 8: the flagship and stage 1 from a Volleyball tree on disk
    (see the module docstring).  ``image_size`` and ``shrink`` (applied to
    every config) size it down for a rehearsal on the CPU, where no kernel
    launches and the counts are not checked.  Returns the launch counts of
    each run."""
    import importlib.util
    import os

    from din_tpu_torch import native as host
    from din_tpu_torch.data.loader import BatchLoader
    from din_tpu_torch.data.packed import PackedFrameStore, pack_frames
    from din_tpu_torch.experiments.run import config_from_args
    from din_tpu_torch.train import engine

    on_card = dev.type == "cuda"
    H, W = image_size
    t0 = time.time()
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # -- probe: the decoder in use, and why -----------------------------------
    try:
        jpeglib = subprocess.run(
            ["g++", "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
            capture_output=True, text=True, timeout=60).returncode == 0
    except OSError:
        jpeglib = False
    pil = importlib.util.find_spec("PIL") is not None
    dec = host.decoder()
    if dec["error"] is None:
        why = ""
    else:       # the compiler's error line, else the last line
        lines = dec["error"].strip().splitlines()
        why = " (native build failed: %s)" % next(
            (ln for ln in lines if "error" in ln), lines[-1]).strip()
    log(f"[ondisk] host: {os.cpu_count()} CPUs, jpeglib.h "
        f"{'present' if jpeglib else 'absent'}, PIL "
        f"{'present' if pil else 'absent'}; decoder in use: "
        f"{dec['decoder']}{why}")
    require(not jpeglib or dec["decoder"] == "native",
            f"jpeglib.h is present but the native decoder did not build:\n"
            f"{dec['error']}")
    require(pil, "PIL is needed to write the JPEG tree")

    # -- a Volleyball tree at the training size -------------------------------
    root = tmp / "videos"
    tt = time.time()
    sources = write_volleyball_tree(root, H, W, SEED + 9)
    rels = sorted(sources)
    jpeg_mb = sum((root / r).stat().st_size for r in rels) / 1e6
    log(f"[ondisk] wrote {len(rels)} JPEG frames of {H}x{W} (quality 90, "
        f"{jpeg_mb:.1f} MB), videos 0 and 1 of 4 clips (train), video 2 of 2 "
        f"(test), tracks_normalized.pkl, in {time.time() - tt:.2f} s "
        f"[{smi}]")

    # -- decode: batch call against single frames and the sources; pack -------
    tt = time.time()
    before = host.decoder()["frames"]
    decoded = {}
    for d in sorted({r.rsplit("/", 1)[0] for r in rels}):
        clip = [r for r in rels if r.startswith(d + "/")]
        frames = host.load_frames([str(root / r) for r in clip], H, W)
        for r, f in zip(clip, frames):
            decoded[r] = f
    batch_s = time.time() - tt
    after = host.decoder()["frames"]
    same = all(np.array_equal(decoded[r], host.load_frame(str(root / r), H, W))
               for r in rels)
    diff = [np.abs(decoded[r].astype(np.int16) - sources[r]) for r in rels]
    mean_err = float(np.mean([d.mean() for d in diff]))
    max_err = int(max(d.max() for d in diff))
    log(f"[ondisk] decode of {len(rels)} frames by clip in {batch_s:.2f} s "
        f"(frames by path: native {after['native'] - before['native']}, PIL "
        f"{after['pil'] - before['pil']}); batch call == single-frame call "
        f"bit for bit: {same}; against the source arrays mean |diff| "
        f"{mean_err:.3f}, max |diff| {max_err} (JPEG tolerance: mean <= 5, "
        f"max <= 48) [{smi}]")
    require(same, "the batch decode differs from the single-frame decode")
    require(mean_err <= 5 and max_err <= 48,
            "decoded frames are farther from their sources than JPEG q90")
    del diff, sources
    pack = tmp / "frames.pack"
    tt = time.time()
    n = pack_frames(str(root), str(pack), H, W)
    pack_s = time.time() - tt
    store = PackedFrameStore(str(pack), root=str(root))
    before = host.decoder()["frames"]
    got = store.load_frames([str(root / r) for r in rels], H, W)
    live = sum(host.decoder()["frames"].values()) - sum(before.values())
    same = all(np.array_equal(g, decoded[r]) for g, r in zip(got, rels))
    log(f"[ondisk] pack_frames: {n} frames, {pack.stat().st_size / 1e6:.1f} "
        f"MB in {pack_s:.2f} s; PackedFrameStore read of every frame == the "
        f"direct decode bit for bit: {same}; hits {store.hits}, misses "
        f"{store.misses}, live decodes {live} [{smi}]")
    require(same and store.misses == 0 and live == 0 and n == len(rels),
            "the packed store differs from the direct decode")
    del got, decoded, store

    # -- loader rate on the host ---------------------------------------------
    argv = ["--preset", "volleyball_stage2_dynamic", "--data-path", str(root),
            "--max-epoch", "1", "--result-root", str(tmp),
            "--stage1-model-path", s1_path]

    def cfg_of(extra, preset_argv=argv):
        c, _ = config_from_args(preset_argv + extra)
        return shrink(c.replace(train_seqs=[0, 1], test_seqs=[2]))

    def loader_rate(c, workers, passes=1):
        train_set, _ = engine.return_dataset(c)
        loader = BatchLoader(train_set, c.batch_size, shuffle=True,
                             num_workers=workers, seed=c.train_random_seed)
        rates = []
        for _ in range(passes):
            loader.set_epoch(1)
            tt = time.perf_counter()
            clips = sum(len(b["images"]) for b in loader)
            rates.append(clips / (time.perf_counter() - tt))
        return rates, train_set

    jpeg_cfg = cfg_of([])
    (r1,), _ = loader_rate(jpeg_cfg, 1)
    (r4,), _ = loader_rate(jpeg_cfg, 4)
    (rp,), pset = loader_rate(cfg_of(["--packed-frames-path", str(pack)]), 4)
    (rc0, rc1), cset = loader_rate(jpeg_cfg.replace(decode_cache_mb=1024), 4,
                                   passes=2)
    log(f"[ondisk] BatchLoader over the stage-2 training set ({len(pset)} "
        f"clips of {jpeg_cfg.num_frames} frames, batch {jpeg_cfg.batch_size},"
        f" host clock, decoder {dec['decoder']}): JPEGs 1 worker {r1:.3f} "
        f"clips/s, 4 workers {r4:.3f}; pack 4 workers {rp:.3f} (misses "
        f"{pset.cache.misses}); FrameCache 4 workers cold {rc0:.3f}, warm "
        f"{rc1:.3f} (hits {cset.cache.hits}, misses {cset.cache.misses}); "
        f"the training step alone (phase 5) {step_clips_s:.3f} clips/s "
        f"[{smi}]")
    require(pset.cache.misses == 0, "packed-store misses in the loader")

    # -- the flagship stage 2 from the JPEG tree, then from the pack ----------
    def stage2(extra, name):
        c = cfg_of(["--exp-name", name] + extra)
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        frames0 = sum(host.decoder()["frames"].values())
        tt = time.time()
        with EngineTap(engine) as tap:
            best = engine.train_net(c, max_steps_per_epoch=3, device=dev)
        sync()
        secs = time.time() - tt
        counts = read_counts()
        live = sum(host.decoder()["frames"].values()) - frames0
        train_set, val_set = tap.datasets[0]
        ref = BatchLoader(train_set, c.batch_size, shuffle=True,
                          num_workers=c.num_workers, seed=c.train_random_seed)
        ref.set_epoch(1)
        ref_train = [b for _, b in zip(range(3), ref)]
        ref_val = list(BatchLoader(val_set, c.test_batch_size, shuffle=False,
                                   num_workers=c.num_workers, drop_last=False,
                                   pad_last=True))
        require(same_batches(tap.train_batches, ref_train)
                and same_batches(tap.eval_batches, ref_val),
                f"{name}: a batch on the device differs from the loader's")
        losses = [float(m["loss"]) for m in tap.metrics]
        require(len(losses) == 3 and all(map(math.isfinite, losses)),
                f"{name}: step losses {losses}")
        expect, how = derived_counts(c, 3, c.num_frames, len(ref_val),
                                     c.num_frames)
        require(not on_card or counts == expect,
                f"{name}: launches {counts}, expected {expect}")
        log_text = (Path(c.result_path) / "log.txt").read_text()
        epoch_rate = float(re.findall(r"Throughput: ([0-9.]+) clips/sec",
                                      log_text)[0])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0
        log(f"[ondisk] {name}: train_net, flagship grafted from "
            f"{Path(s1_path).name}, 3 steps at batch {c.batch_size} + eval "
            f"of {len(val_set)} "
            f"clips + checkpoint in {secs:.2f} s; each step's and eval "
            f"call's batch on the device == the loader's numpy batch bit for "
            f"bit; step losses {[round(v, 5) for v in losses]}; eval "
            f"{tap.evals[-1]['activities_acc']:.2f}% loss "
            f"{tap.evals[-1]['loss']:.6f}; live decodes {live}; epoch line "
            f"{epoch_rate:.3f} clips/s against {step_clips_s:.3f} for the step"
            f" alone; peak device memory {peak:.2f} GiB; launches {counts}, "
            f"expected {expect} ({how}) [{smi}]")
        return dict(cfg=c, best=best, tap=tap, losses=losses, counts=counts,
                    live=live, store=train_set.cache)

    t_jpeg = stage2([], "disk_jpeg")
    t_pack = stage2(["--packed-frames-path", str(pack)], "disk_pack")
    require(same_batches(t_pack["tap"].train_batches[:1],
                         [{k: v.cpu().numpy() for k, v in
                           t_jpeg["tap"].train_batches[0].items()}]),
            "the pack run's first batch differs from the JPEG run's")
    l_j, l_p = t_jpeg["losses"][0], t_pack["losses"][0]
    require(abs(l_p - l_j) <= 1e-5 * abs(l_j),
            f"step-1 loss from the pack {l_p} != from the JPEGs {l_j}")
    require(t_pack["store"].misses == 0 and t_pack["live"] == 0,
            f"the pack run decoded {t_pack['live']} frames live (misses "
            f"{t_pack['store'].misses})")
    log(f"[ondisk] pack run: first batch == the JPEG run's bit for bit; "
        f"step-1 loss {l_p:.7f} against {l_j:.7f} (rtol 1e-5); store hits "
        f"{t_pack['store'].hits}, misses {t_pack['store'].misses}, live "
        f"decodes {t_pack['live']} [{smi}]")

    # -- --eval-only from the JPEG run's checkpoint ---------------------------
    ckpt = t_jpeg["best"]["checkpoint"]
    ecfg = cfg_of(["--exp-name", "disk_eval", "--stage2-model-path", ckpt,
                   "--eval-only"])
    reset_counts()
    with EngineTap(engine) as tap:
        info = engine.train_net(ecfg, device=dev)
    sync()
    e_counts = read_counts()
    want = t_jpeg["tap"].evals[-1]
    written = sorted(p.name for p in Path(ecfg.result_path).iterdir())
    e_expect, _ = derived_counts(ecfg, 0, ecfg.num_frames,
                                 len(tap.eval_batches), ecfg.num_frames)
    log(f"[ondisk] --stage2-model-path {Path(ckpt).name} --eval-only: "
        f"epoch {info['epoch']}, {info['activities_acc']:.2f}% (train run's "
        f"eval {want['activities_acc']:.2f}%), loss {info['loss']:.7f} "
        f"(train run's {want['loss']:.7f}, rtol 1e-5); steps "
        f"{len(tap.train_batches)}; files in its result dir {written}; "
        f"launches {e_counts}, expected {e_expect} [{smi}]")
    require(info["activities_acc"] == want["activities_acc"]
            and abs(info["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
            and info["epoch"] == 1, "--eval-only does not reproduce the eval")
    require(not tap.train_batches
            and written == ["log.txt", "metrics.jsonl"]
            and (not on_card or e_counts == e_expect),
            "--eval-only trained, wrote a file, or launched other kernels")
    require(same_batches(tap.eval_batches, [
        {k: v.cpu().numpy() for k, v in b.items()}
        for b in t_jpeg["tap"].eval_batches]),
        "--eval-only saw other batches than the train run's eval")

    # -- stage 1 from the tree: test_before_train, 10-frame eval clips --------
    s1 = cfg_of(["--exp-name", "disk_stage1"], preset_argv=[
        "--preset", "volleyball_stage1", "--data-path", str(root),
        "--max-epoch", "1", "--result-root", str(tmp)])
    reset_counts()
    tt = time.time()
    with EngineTap(engine) as tap:
        engine.train_net(s1, max_steps_per_epoch=1, device=dev)
    sync()
    s1_s = time.time() - tt
    s1_counts = read_counts()
    train_set, val_set = tap.datasets[0]
    ref = BatchLoader(train_set, s1.batch_size, shuffle=True,
                      num_workers=s1.num_workers, seed=s1.train_random_seed)
    ref.set_epoch(1)
    ref_val = list(BatchLoader(val_set, s1.test_batch_size, shuffle=False,
                               num_workers=s1.num_workers, drop_last=False,
                               pad_last=True))
    eval_T = tap.eval_batches[0]["images"].shape[1]
    s1_expect, how = derived_counts(s1, 1, 1, len(tap.eval_batches), eval_T)
    s1_log = (Path(s1.result_path) / "log.txt").read_text()
    losses = [float(m["loss"]) for m in tap.metrics]
    log(f"[ondisk] stage 1 (volleyball_stage1, test_before_train="
        f"{s1.test_before_train}) from the tree in {s1_s:.2f} s: evals at "
        f"epochs {[e['epoch'] for e in tap.evals]} over {len(val_set)} clips "
        f"of T={eval_T} (the finetune eval policy), {len(tap.metrics)} step "
        f"of {len(train_set)} clips of "
        f"T={tap.train_batches[0]['images'].shape[1]}, loss "
        f"{[round(v, 5) for v in losses]}; batches == the loader's; launches "
        f"{s1_counts}, expected {s1_expect} ({how}) [{smi}]")
    require([e["epoch"] for e in tap.evals] == [0, 1]
            and "====> Test at epoch #0" in s1_log, "no eval before training")
    require(eval_T == 10 and tap.train_batches[0]["images"].shape[1] == 1
            and all(map(math.isfinite, losses)) and len(losses) == 1,
            "stage-1 clips or losses are off")
    require(same_batches(tap.train_batches, list(ref))
            and same_batches(tap.eval_batches, ref_val + ref_val),
            "stage 1: a batch on the device differs from the loader's")
    require(not on_card or s1_counts == s1_expect,
            "stage-1 on-disk launch counts are off")
    log(f"[ondisk] done in {time.time() - t0:.2f} s [{smi}]")
    return {"ondisk_stage2": t_jpeg["counts"], "ondisk_pack": t_pack["counts"],
            "ondisk_eval_only": e_counts, "ondisk_stage1": s1_counts}


def cad_boxes(n_frames: int, n_boxes: int, n_pad: int, H: int, W: int,
              gen: torch.Generator) -> torch.Tensor:
    """[F,N,4] boxes as the Collective Activity loader gives them on an
    H x W map: person-sized boxes (about 1/12 of the width, 1/4 of the
    height, the dataset's 60x120 px boxes on 720x480 frames) over the map,
    one on the border, and the last ``n_pad`` slots zero-padded."""
    w = (torch.rand(n_frames, n_boxes, generator=gen) * 0.5 + 0.75) * W / 12
    h = (torch.rand(n_frames, n_boxes, generator=gen) * 0.5 + 0.75) * H / 4
    x1 = torch.rand(n_frames, n_boxes, generator=gen) * (W - w)
    y1 = torch.rand(n_frames, n_boxes, generator=gen) * (H - h)
    boxes = torch.stack([x1, y1, x1 + w, y1 + h], -1)
    boxes[:, 0] = torch.tensor([W - 2.0, H - 4.0, float(W), float(H)])
    boxes[:, n_boxes - n_pad:] = 0
    return boxes


def write_collective_tree(root: Path, H: int, W: int, seed: int,
                          seqs=(1, 2, 5)) -> int:
    """A Collective Activity tree in the reference layout
    (``seqNN/annotations.txt``, tab-separated ``frame x y w h action``;
    ``seqNN/frameNNNN.jpg``): frames 1..20 of each sequence, JPEGs of
    quality 90 of a seeded gradient plus noise at H x W, key frames 1 and
    11 with 13, 9, 4, 11, 1 and 7 persons (boxes drifting a pixel a frame,
    actions 1..6 with 1 = NA, never all NA).  Returns the JPEG count."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from din_tpu_torch.data.collective import FRAMES_SIZE

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 200 // W + 20, yy * 200 // H + 20,
                     (xx + yy) * 160 // (H + W) + 40], -1).astype(np.int16)
    persons = iter((13, 9, 4, 11, 1, 7))
    jobs = []
    for sid in seqs:
        fh, fw = FRAMES_SIZE[sid]
        d = root / ("seq%02d" % sid)
        d.mkdir(parents=True)
        lines = []
        for key in (1, 11):
            n = next(persons)
            xy = np.stack([rng.randint(0, fw - 100, n),
                           rng.randint(0, fh - 150, n)], -1)
            acts = rng.randint(1, 7, n)
            acts[0] = rng.randint(2, 7)
            for fid in range(key, key + 10):
                lines += ["%d\t%d\t%d\t%d\t%d\t%d" % (fid, x, y, 60, 120, a)
                          for (x, y), a in zip(xy + (fid - key), acts)]
        (d / "annotations.txt").write_text("\n".join(lines) + "\n")
        noise = rng.randint(-24, 25, (H, W, 1), dtype=np.int16)
        jobs += [(d / ("frame%04d.jpg" % fid), noise, 37 * fid + sid)
                 for fid in range(1, 21)]

    def encode(job):
        path, noise, shift = job
        img = np.clip(base + np.roll(noise, shift, axis=1), 0,
                      255).astype(np.uint8)
        Image.fromarray(img).save(path, "JPEG", quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(encode, jobs))
    return len(jobs)


def cad_request(c, n_clips: int, counts, seed: int) -> dict:
    """``n_clips`` synthetic clips at c's geometry whose actor counts are
    ``counts`` (one per clip, for every frame): boxes zero and actions -1
    after the count, as the loader pads them."""
    from din_tpu_torch.data.synthetic import make_synthetic_batch

    b = make_synthetic_batch(c, n_clips, rng=np.random.RandomState(seed))
    n = np.repeat(np.asarray(counts, np.int32)[:, None], c.num_frames, 1)
    real = np.arange(c.num_boxes)[None, None] < n[:, :, None]
    b["boxes"] = np.where(real[..., None], b["boxes"], 0).astype(np.float32)
    b["actions"] = np.where(real, b["actions"], -1).astype(np.int32)
    b["bboxes_num"] = n
    return b


def collective_path(dev, tmp: Path, smi: str, reset_counts, read_counts,
                    image_size=(480, 720), shrink=lambda c: c) -> dict:
    """Phase 9: the Collective Activity path (see the module docstring).
    ``image_size`` and ``shrink`` (applied to every config) size it down
    for a rehearsal on the CPU, where no kernel launches and the counts are
    not checked.  Returns the launch counts of each run and the measured
    numbers."""
    from din_tpu_torch.data.datasets import return_dataset
    from din_tpu_torch.data.loader import BatchLoader, to_device
    from din_tpu_torch.data.packed import pack_frames
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.experiments.run import config_from_args
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.train import engine

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    H, W = image_size
    out_size = (-(-H // 32), -(-W // 32))
    t0 = time.time()
    counts, numbers = {}, {}

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0

    def reset_peak():
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def check_counts(name, got, expect, how):
        log(f"[cad] {name}: launches {got}, expected {expect} ({how})")
        require(not on_card or (got == expect
                                and expect["roi_align"] > 0),
                f"{name}: launch counts are off")
        counts[name] = got

    def timed_steps(model, optimizer, c, n=6):
        """ms of n steps on one batch already on the device (stage 1: clips
        of one frame), the mean after the first, the peak memory."""
        clips = c.replace(num_frames=1) if c.training_stage == 1 else c
        batch = to_device(cad_request(
            clips, c.batch_size, ([c.num_boxes, 1, 7] * c.batch_size)[
                :c.batch_size], SEED + 21), dev)
        reset_peak()
        ms = time_host(lambda: engine.train_step(model, optimizer, batch, c),
                       n) if on_card else [0.0] * n
        warm = sum(ms[1:]) / len(ms[1:])
        return ms, warm, peak_gib(), batch

    # -- stage 1: a ResNet-18 BasenetCollective from a torchvision file -------
    res_path = tmp / "resnet18_pretrained.pth"
    res_state = write_torchvision_file(str(res_path), "res18", SEED + 11)
    s1 = shrink(PRESETS["collective_stage1"]().replace(
        backbone="res18", out_size=out_size, emb_features=512,
        image_size=image_size, data_path="synthetic", max_epoch=1,
        result_root=str(tmp), exp_name="cad_stage1",
        pretrained_backbone_path=str(res_path)))
    model, optimizer, _ = engine.setup_training(s1, dev)
    unused = check_loaded(model, res_state, "res18")
    log(f"[cad] stage 1: setup_training loads the torchvision-layout "
        f"ResNet-18 file's {len(model.backbone.state_dict())} tensors "
        f"(BatchNorm statistics included) equal to the file's; unused: "
        f"{', '.join(unused)}")
    ms, warm, peak, _ = timed_steps(model, optimizer, s1)
    numbers["stage1_ms"], numbers["stage1_peak_gib"] = warm, peak
    log(f"[cad] stage 1 step times {', '.join(f'{v:.1f}' for v in ms)} ms "
        f"(host clock, synchronized; batch of {s1.batch_size} one-frame "
        f"clips on the device, 13 actor slots); after the warm-up step "
        f"{warm:.1f} ms = {s1.batch_size / max(warm, 1e-9) * 1e3:.3f} "
        f"clips/s; peak device memory {peak:.2f} GiB [{smi}]")
    del model, optimizer
    _, s1_val = return_dataset(s1)
    reset_peak()
    reset_counts()
    tt = time.time()
    s1_best = engine.train_net(s1, max_steps_per_epoch=3, device=dev)
    sync()
    expect, how = derived_counts(s1, 3, 1, -(-len(s1_val)
                                             // s1.test_batch_size),
                                 s1.num_frames)
    log(f"[cad] stage 1: train_net, 3 steps of {s1.batch_size} one-frame "
        f"clips, an eval of {len(s1_val)} clips of T={s1.num_frames} at "
        f"batch {s1.test_batch_size}, component file, in "
        f"{time.time() - tt:.2f} s; peak device memory {peak_gib():.2f} GiB")
    check_counts("cad_stage1", read_counts(), expect, how)
    s1_log = (Path(s1.result_path) / "log.txt").read_text()
    losses = [float(v) for v in re.findall(r"Loss: ([-+0-9.eEnaif]+)",
                                            s1_log)]
    require(len(losses) == 2 and all(map(math.isfinite, losses)),
            f"stage 1 losses {losses}")
    base = tmp / "basemodel_CAD_res18.pth"
    shutil.copy(s1_best["checkpoint"], base)
    comp = torch.load(base, map_location="cpu", weights_only=True)
    require(int(comp["backbone_state_dict"]["features.1.num_batches_tracked"])
            == 1000 + 3, "the stage-1 file's BatchNorm did not count 3 steps")
    log(f"[cad] stage 1: train / eval loss {losses} (finite); "
        f"{base.name} ({base.stat().st_size / 2 ** 20:.0f} MiB) with "
        f"BatchNorm statistics (num_batches_tracked 1000 + 3)")

    # -- stage 2: collective_stage2_dynamic grafted from that file ------------
    s2 = shrink(PRESETS["collective_stage2_dynamic"]().replace(
        image_size=image_size, out_size=out_size, data_path="synthetic",
        max_epoch=1, result_root=str(tmp), exp_name="cad_stage2",
        stage1_model_path=str(base)))
    model, optimizer, _ = engine.setup_training(s2, dev)
    for name, part, key in (("backbone", model.backbone,
                             "backbone_state_dict"),
                            ("fc_emb_1", model.fc_emb_1,
                             "fc_emb_state_dict")):
        state = part.state_dict()
        require(sorted(state) == sorted(comp[key]) and all(
            torch.equal(v.cpu(), comp[key][k]) for k, v in state.items()),
            f"grafted {name} differs from the stage-1 file")
    n_buf = sum(k.endswith(("running_mean", "running_var",
                            "num_batches_tracked"))
                for k in comp["backbone_state_dict"])
    log(f"[cad] stage 2: setup_training grafts {base.name}: backbone.* "
        f"({len(comp['backbone_state_dict'])} tensors, {n_buf} of them "
        f"BatchNorm buffers) and fc_emb_1 equal the file's before the "
        f"first step")
    ms, warm, peak, sbatch = timed_steps(model, optimizer, s2)
    numbers.update(stage2_ms=warm, stage2_peak_gib=peak,
                   stage2_clips_s=s2.batch_size / max(warm, 1e-9) * 1e3)
    log(f"[cad] stage 2 step times {', '.join(f'{v:.1f}' for v in ms)} ms "
        f"(host clock, synchronized; batch of {s2.batch_size} clips of "
        f"T={s2.num_frames}, {H}x{W}, 13 actor slots with 13, 1 real; "
        f"dropout {s2.train_dropout_prob}); after the warm-up step "
        f"{warm:.1f} ms per step = {numbers['stage2_clips_s']:.3f} clips/s; "
        f"peak device memory {peak:.2f} GiB [{smi}]")
    if on_card:
        prof = traced_step(lambda: engine.train_step(model, optimizer,
                                                     sbatch, s2))
        busy = prof["busy_us"]
        numbers["stage2_idle"] = 1 - busy / prof["wall_us"]
        log(f"[cad] stage 2, one profiled step: wall "
            f"{prof['wall_us'] / 1e3:.1f} ms, device busy {busy / 1e3:.1f} "
            f"ms (idle share {numbers['stage2_idle']:.3f}); device time by "
            f"kind: " + ", ".join(
                f"{k} {v / 1e3:.2f} ms ({v / busy:.3f})"
                for k, v in prof["by_category"].items()) + "; top: " + "; ".join(
                f"{us / 1e3:.2f} ms x{n} {key[:60]}"
                for us, n, key in prof["top"][:6]))
    del model, optimizer, sbatch
    if on_card:
        torch.cuda.empty_cache()
    _, s2_val = return_dataset(s2)
    reset_peak()
    reset_counts()
    tt = time.time()
    s2_best = engine.train_net(s2, max_steps_per_epoch=3, device=dev)
    sync()
    expect, how = derived_counts(s2, 3, s2.num_frames, -(-len(s2_val)
                                                        // s2.test_batch_size),
                                 s2.num_frames)
    log(f"[cad] stage 2: train_net, 3 steps at batch {s2.batch_size}, an "
        f"eval of {len(s2_val)} clips at batch {s2.test_batch_size}, a "
        f"checkpoint, in {time.time() - tt:.2f} s; peak device memory "
        f"{peak_gib():.2f} GiB [{smi}]")
    check_counts("cad_stage2", read_counts(), expect, how)
    s2_log = (Path(s2.result_path) / "log.txt").read_text()
    losses = [float(v) for v in re.findall(r"Loss: ([-+0-9.eEnaif]+)",
                                            s2_log)]
    ckpt = s2_best.get("checkpoint")
    require(len(losses) == 2 and all(map(math.isfinite, losses))
            and ckpt is not None and Path(ckpt).exists(),
            f"stage 2: losses {losses}, checkpoint {ckpt}")
    log(f"[cad] stage 2: train / eval loss {losses} (finite); checkpoint "
        f"{Path(ckpt).name} ({Path(ckpt).stat().st_size / 2 ** 20:.0f} MiB)")

    # -- serving: Predictor(pad_to=2), mixed counts ---------------------------
    model = build_model(s2, device=dev)
    model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                     weights_only=True)["state_dict"])
    _randomize_din(model, torch.Generator().manual_seed(SEED + 22))
    predictor = Predictor(s2, model, pad_to=2, device=dev)
    req = cad_request(s2, 3, [s2.num_boxes, 1, 7], SEED + 23)
    requests = [{k: v[:1] for k, v in req.items()}, req,
                {k: v[:1] for k, v in req.items()}]
    reset_counts()
    outs, req_ms = [], []
    for r in requests:
        tr = time.perf_counter()
        outs.append(predictor(r["images"], r["boxes"], r["bboxes_num"])
                    ["activities"])
        sync()
        req_ms.append((time.perf_counter() - tr) * 1e3)
    padded_calls = sum(-(-len(r["images"]) // 2) for r in requests)
    check_counts("cad_serve", read_counts(),
                 {"max_pool_2x2": 0, "roi_align": padded_calls,
                  "max_pool_2x2_bwd": 0, "roi_align_bwd": 0,
                  "fused_stem": 0},
                 f"1 RoIAlign per padded call of 2 clips, {padded_calls} "
                 f"calls; no backward")
    for out, r in zip(outs, requests):
        require(out.shape == (len(r["images"]), s2.num_activities)
                and np.isfinite(out).all()
                and np.abs(out.sum(-1) - 1).max() <= 1e-5,
                "collective posteriors are off")
    rep = float(np.abs(outs[0] - outs[2]).max())
    moved = {k: v[2:3].copy() for k, v in req.items()}
    pad = np.arange(s2.num_boxes) >= 7
    OH, OW = s2.out_size
    moved["boxes"][:, :, pad] = np.asarray(
        [OW / 3, OH / 3, OW / 2, OH / 1.5], np.float32)
    still = predictor(moved["images"], moved["boxes"],
                      moved["bboxes_num"])["activities"]
    pad_diff = float(np.abs(still[0] - outs[1][2]).max())
    require(rep <= 1e-6 and pad_diff <= 1e-6,
            f"repeated clip differs by {rep}, a moved padded box by "
            f"{pad_diff}")
    lat = time_host(lambda: predictor(requests[0]["images"],
                                      requests[0]["boxes"],
                                      requests[0]["bboxes_num"]), 6) \
        if on_card else [0.0]
    numbers["serve_1clip_ms"] = float(np.median(lat))
    log(f"[cad] serving Predictor(pad_to=2): requests of "
        f"{[len(r['images']) for r in requests]} clips with counts "
        f"{[r['bboxes_num'][:, 0].tolist() for r in requests]}: "
        f"{', '.join(f'{v:.1f}' for v in req_ms)} ms (host clock, "
        f"synchronized; the first includes cuDNN warm-up); rows finite, sum "
        f"to 1; repeated clip max |diff| {rep:.3g}; the 7-actor clip with "
        f"its 6 padded boxes moved onto the map max |diff| {pad_diff:.3g}; "
        f"1-clip requests, 6 more: median {numbers['serve_1clip_ms']:.2f} "
        f"ms (min {min(lat):.2f}, max {max(lat):.2f}) [{smi}]")
    del predictor, model

    # -- the card against the CPU at a small geometry -------------------------
    if on_card:
        small = s2.replace(image_size=(128, 192), out_size=(4, 6),
                           num_frames=3, compute_dtype="float32",
                           train_dropout_prob=0.0, load_backbone_stage2=False)
        gen = torch.Generator().manual_seed(SEED)
        cpu_model = build_model(small, device="cpu", generator=gen)
        _randomize_din(cpu_model, gen)
        clip = cad_request(small, 2, [13, 5], SEED + 24)
        on_cpu = Predictor(small, cpu_model, device="cpu")(
            clip["images"], clip["boxes"], clip["bboxes_num"])["activities"]
        with no_tf32():
            on_gpu = Predictor(small, copy.deepcopy(cpu_model))(
                clip["images"], clip["boxes"], clip["bboxes_num"])[
                    "activities"]
        err = float(np.abs(on_gpu - on_cpu).max())
        require(err <= 1e-4, f"collective card vs CPU max |diff| {err}")
        log(f"[card-vs-cpu] collective, 2 clips (13 and 5 actors) T=3 "
            f"128x192 f32 (TF32 off): max |diff| of posteriors {err:.3g} "
            f"(<= 1e-4)")
        with no_tf32():
            r = train_card_vs_cpu(small, cpu_model, free_share_bound=None,
                                  ulps=2)
        log_train_card_vs_cpu("collective stage 2 (bounds Adam's largest "
                              "steps plus 2 f32 ulps of each parameter)",
                              small, r)
        numbers["card_vs_cpu"] = err
        del cpu_model

    # -- on disk: a CAD tree at 480x720, its pack; --eval-only ----------------
    root = tmp / "collective"
    tt = time.time()
    n_jpeg = write_collective_tree(root, H, W, SEED + 25)
    pack = tmp / "collective.pack"
    n = pack_frames(str(root), str(pack), H, W)
    require(n == n_jpeg, f"packed {n} of {n_jpeg} frames")
    log(f"[cad] wrote a Collective Activity tree of {n_jpeg} JPEG frames of "
        f"{H}x{W} (sequences 1 and 2 train, 5 test, key frames 1 and 11) and "
        f"its pack ({pack.stat().st_size / 1e6:.1f} MB) in "
        f"{time.time() - tt:.2f} s")
    argv = ["--preset", "collective_stage2_dynamic", "--data-path",
            str(root), "--max-epoch", "1", "--result-root", str(tmp),
            "--stage1-model-path", str(base)]

    def cfg_of(extra):
        c, _ = config_from_args(argv + extra)
        return shrink(c.replace(train_seqs=[1, 2], test_seqs=[5],
                                image_size=image_size, out_size=out_size))

    def disk_run(extra, name):
        c = cfg_of(["--exp-name", name] + extra)
        reset_peak()
        reset_counts()
        tt = time.time()
        with EngineTap(engine) as tap:
            best = engine.train_net(c, max_steps_per_epoch=3, device=dev)
        sync()
        secs = time.time() - tt
        got = read_counts()
        train_set, val_set = tap.datasets[0]
        ref = BatchLoader(train_set, c.batch_size, shuffle=True,
                          num_workers=c.num_workers, seed=c.train_random_seed)
        ref.set_epoch(1)
        ref_train = list(ref)[:3]
        ref_val = list(BatchLoader(val_set, c.test_batch_size, shuffle=False,
                                   num_workers=c.num_workers, drop_last=False,
                                   pad_last=True))
        require(same_batches(tap.train_batches, ref_train)
                and same_batches(tap.eval_batches, ref_val),
                f"{name}: a batch on the device differs from the loader's")
        losses = [float(m["loss"]) for m in tap.metrics]
        require(len(losses) == len(ref_train) > 0
                and all(map(math.isfinite, losses)),
                f"{name}: step losses {losses}")
        expect, how = derived_counts(c, len(losses), c.num_frames,
                                     len(ref_val), c.num_frames)
        log(f"[cad] {name}: train_net from {Path(c.data_path).name}"
            f"{' via the pack' if c.packed_frames_path else ''}, "
            f"{len(losses)} steps of {len(train_set)} clips at batch "
            f"{c.batch_size} (counts {[b['bboxes_num'][:, 0].tolist() for b in ref_train]}), "
            f"eval of {len(val_set)} clips, checkpoint, in {secs:.2f} s; "
            f"batches on the device == the loader's bit for bit; step losses "
            f"{[round(v, 5) for v in losses]}; eval "
            f"{tap.evals[-1]['activities_acc']:.2f}% loss "
            f"{tap.evals[-1]['loss']:.6f}; peak device memory "
            f"{peak_gib():.2f} GiB [{smi}]")
        check_counts(name, got, expect, how)
        return dict(best=best, tap=tap, losses=losses)

    d_jpeg = disk_run([], "cad_disk_jpeg")
    d_pack = disk_run(["--packed-frames-path", str(pack)], "cad_disk_pack")
    l_j, l_p = d_jpeg["losses"][0], d_pack["losses"][0]
    require(same_batches(d_pack["tap"].train_batches[:1], [
        {k: v.cpu().numpy() for k, v in
         d_jpeg["tap"].train_batches[0].items()}])
        and abs(l_p - l_j) <= 1e-5 * abs(l_j),
        f"the pack run's first batch or step-1 loss ({l_p} vs {l_j}) "
        f"differs from the JPEG run's")
    ecfg = cfg_of(["--exp-name", "cad_eval", "--stage2-model-path",
                   d_jpeg["best"]["checkpoint"], "--eval-only"])
    reset_counts()
    with EngineTap(engine) as tap:
        info = engine.train_net(ecfg, device=dev)
    sync()
    want = d_jpeg["tap"].evals[-1]
    e_expect, how = derived_counts(ecfg, 0, ecfg.num_frames,
                                   len(tap.eval_batches), ecfg.num_frames)
    log(f"[cad] --eval-only of the JPEG run's checkpoint: "
        f"{info['activities_acc']:.2f}% (train run's "
        f"{want['activities_acc']:.2f}%), loss {info['loss']:.7f} (train "
        f"run's {want['loss']:.7f}, rtol 1e-5); steps "
        f"{len(tap.train_batches)}")
    require(info["activities_acc"] == want["activities_acc"]
            and abs(info["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
            and not tap.train_batches, "--eval-only does not reproduce the eval")
    check_counts("cad_eval_only", read_counts(), e_expect, how)
    two_steps_bit_equal(shrink(PRESETS["collective_stage2_dynamic"]().replace(
        image_size=image_size, out_size=out_size, load_backbone_stage2=False,
        data_path="synthetic")), dev, SEED + 91, "[cad] collective stage 2")
    log(f"[cad] done in {time.time() - t0:.2f} s [{smi}]")
    return dict(counts=counts, numbers=numbers)


def _zero_fixed_dropouts(model: torch.nn.Module) -> int:
    """Sets the rate of every dropout that ``train_dropout_prob`` does not
    set (the hierarchical head's 0.5, TCE's 0.1) to 0: the card's and the
    CPU's generators draw different masks, so a card-against-CPU step
    compares the same function only without them.  Returns how many."""
    from din_tpu_torch.nn.layers import SeededDropout

    fixed = [m for name, m in model.named_modules()
             if isinstance(m, SeededDropout) and name != "dropout_global"]
    for m in fixed:
        m.p = 0.0
    return len(fixed)


def checkpoint_serving(dev, tmp: Path, ckpt: str, ref_path: str, smi: str,
                       reset_counts, read_counts, shrink=lambda c: c) -> dict:
    """Phase 10: serving phase 4's trained stage-2 file (see the module
    docstring).  ``shrink`` sizes the config down for a rehearsal on the
    CPU, where no kernel launches and the counts are not checked.  Returns
    the launch counts of each path and the measured numbers."""
    import io
    import threading
    import urllib.error
    import urllib.request

    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.experiments.serve_http import make_server
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.train import inspect_ckpt

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.time()
    cfg = shrink(PRESETS["volleyball_stage2_dynamic"]())
    counts, numbers = {}, {}
    batch = make_synthetic_batch(cfg, 3, rng=np.random.RandomState(SEED + 31))
    requests = [(batch["images"][:1], batch["boxes"][:1]),
                (batch["images"], batch["boxes"])]
    calls = sum(-(-len(im) // 2) for im, _ in requests)
    expect, how = derived_counts(cfg, 0, cfg.num_frames, calls,
                                 cfg.num_frames, eval_batch=2)

    def check_counts(name, got):
        log(f"[ckpt] {name}: launches {got}, expected {expect} ({how}; "
            f"requests of 1 and 3 clips at pad_to=2)")
        require(not on_card or (got == expect and expect["roi_align"] > 0),
                f"{name}: launch counts are off")
        counts[name] = got

    # the trained model in memory: phase 4's state loaded by hand
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    model = build_model(cfg, device=dev)
    model.load_state_dict(saved["state_dict"], strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    want = [Predictor(cfg, model, pad_to=2, device=dev)(*r)["activities"]
            for r in requests]
    del model
    predictor = None
    for name, path in (("ckpt_serve_ref", ref_path), ("ckpt_serve", ckpt)):
        tt = time.time()
        predictor = Predictor.from_checkpoint(cfg, path, pad_to=2,
                                              device=dev)
        build_s = time.time() - tt
        reset_counts()
        got = [predictor(*r)["activities"] for r in requests]
        sync()
        check_counts(name, read_counts())
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        require(same, f"{name}: posteriors differ from the trained model's "
                f"by {max(np.abs(g - w).max() for g, w in zip(got, want))}")
        log(f"[ckpt] Predictor.from_checkpoint({Path(path).name}) built and "
            f"loaded in {build_s:.2f} s; posteriors of the 1- and 3-clip "
            f"requests bit-equal to the trained model's in memory")

    missing = dict(saved["state_dict"])
    dropped = next(k for k in missing if k.startswith("DPI."))
    del missing[dropped]
    bad = tmp / "missing_one_tensor.pth"
    torch.save({"epoch": saved["epoch"], "state_dict": missing,
                "optimizer": {}}, bad)
    try:
        Predictor.from_checkpoint(cfg, str(bad), pad_to=2, device=dev)
        raised = ""
    except RuntimeError as e:
        raised = " ".join(str(e).split())
    require(f'Missing key(s) in state_dict: "{dropped}"' in raised,
            f"a file without {dropped} loaded")
    log(f"[ckpt] a file without {dropped} raises: {raised[:160]}")
    del missing, saved

    # the HTTP front end around the port file's predictor
    info = {"model": cfg.inference_module_name, "pad_to": 2}
    server = make_server(predictor, "127.0.0.1", 0, info)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(body: bytes):
        try:
            with urllib.request.urlopen(url + "/predict", data=body,
                                        timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def npz(images, boxes) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, images=images, boxes=boxes)
        return buf.getvalue()

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = (r.status, json.loads(r.read()))
        require(health == (200, {"ok": True, **info}), f"healthz {health}")
        bodies = [npz(*r) for r in requests]
        reset_counts()
        replies = [post(b) for b in bodies]
        sync()
        check_counts("ckpt_http", read_counts())
        for (code, reply), w in zip(replies, want):
            got = np.asarray(reply.get("activities"), np.float32)
            require(code == 200 and np.array_equal(got, w),
                    f"HTTP reply {code} differs from the Predictor's")
        code, reply = post(b"this is not an npz archive")
        require(code == 400 and reply.get("error"), f"malformed body: {code}")
        log(f"[ckpt] serve_http on {url}: /healthz {health[1]}; 1- and "
            f"3-clip /predict JSON posteriors equal the Predictor's after "
            f"the float32 round-trip; a malformed body gets {code} "
            f"({reply['error'][:60]})")
        direct, http = [], []
        for _ in range(6):
            http += time_host(lambda: post(bodies[0]), 1) if on_card else [0]
            direct += time_host(lambda: predictor(*requests[0]), 1) \
                if on_card else [0]
        numbers.update(http_ms=float(np.median(http)),
                       direct_ms=float(np.median(direct)))
        log(f"[ckpt] 1-clip requests, 6 each in turns (host clock, "
            f"synchronized): HTTP median {numbers['http_ms']:.2f} ms (min "
            f"{min(http):.2f}, max {max(http):.2f}), direct Predictor median "
            f"{numbers['direct_ms']:.2f} ms (min {min(direct):.2f}, max "
            f"{max(direct):.2f}); HTTP overhead "
            f"{numbers['http_ms'] - numbers['direct_ms']:.2f} ms [{smi}]")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    require(not thread.is_alive(), "the HTTP server thread did not stop")

    lines = []
    described = inspect_ckpt.describe(ckpt, out=lines.append)
    require(described["params"] == n_params
            and described["layout"] == "stage-2 / reference full-model",
            f"inspect_ckpt counts {described['params']} parameters, the "
            f"model has {n_params}")
    log(f"[ckpt] inspect_ckpt: {described['layout']}, epoch "
        f"{described['epoch']}, {described['params']:,} parameters (the "
        f"model's), {len(described['modules'])} modules; "
        + "; ".join(line.strip() for line in lines[3:6]))
    log(f"[ckpt] done in {time.time() - t0:.2f} s")
    return dict(counts=counts, numbers=numbers)


def tce_times(tce: torch.nn.Module, c, smi: str) -> dict:
    """CUDA-event times of TCE's encoder alone at a training step's shapes
    (B*T = 20 frames of 12 actors of 1024 features over the [22,40,512]
    map plus its sine encoding), forward and forward with backward, beside
    the floating-point operations it must do in IEEE f32: per head the
    1x1 conv of the map to 128 features, the actor embedding, the
    attention logits and the weighted sum over the 880 cells, the FFN."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    BT, N = c.batch_size * c.num_frames, c.num_boxes
    OH, OW = c.out_size
    feats = torch.randn((BT, N, 1024), generator=gen, device=dev,
                        requires_grad=True)
    ctx = torch.randn((BT, OH, OW, c.emb_features), generator=gen,
                      device=dev, requires_grad=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    tce.train()
    fwd = time_cuda(lambda: tce(feats, ctx), 20, flush)
    both = time_cuda(lambda: tce(feats, ctx).sum().backward(), 20, flush)
    P, nfc, heads = OH * OW, 128, len(tce.CET)
    flops = heads * 2 * (BT * P * c.emb_features * nfc + BT * N * 1024 * nfc
                         + 2 * BT * N * P * nfc + 2 * BT * N * nfc * nfc)
    attn = heads * 2 * 2 * BT * N * P * nfc
    log(f"[variants] tce: MultiHeadTCE alone, {BT} frames x {N} actors over "
        f"{P} map cells, {heads} heads of {nfc}: forward {fwd:.4f} ms, "
        f"forward and backward {both:.4f} ms (CUDA events, train mode); "
        f"{flops / 1e9:.2f} GFLOP forward, of which the attention over the "
        f"cells {attn / 1e9:.3f}; bound {flops / F32_FLOPS_PER_S * 1e3:.4f} "
        f"ms at the f32 rate [{smi}]")
    return dict(tce_fwd_ms=fwd, tce_fwd_bwd_ms=both, tce_gflop=flops / 1e9)


VARIANTS = ("volleyball_stage2_dynamic_hierarchical",
            "volleyball_stage2_dynamic_multi",
            "volleyball_stage2_dynamic_tce")


def variants_path(dev, tmp: Path, s1_path: str, smi: str, reset_counts,
                  read_counts, shrink=lambda c: c) -> dict:
    """Phase 11: the three DIN variants at full width (see the module
    docstring).  ``shrink`` sizes every config down for a rehearsal on the
    CPU, where no kernel launches and neither the counts nor the card
    against the CPU are checked.  Returns the launch counts of each path
    and the measured numbers."""
    from din_tpu_torch.data.datasets import return_dataset
    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.run import config_from_args
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.train import engine

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    counts, numbers = {}, {}

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0

    def reset_peak():
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def check_counts(name, got, expect, how):
        """A training path launches all five kernels, a serving path the
        forward ones (K1, K2, K3)."""
        log(f"[variants] {name}: launches {got}, expected {expect} ({how})")
        must = [k for k in expect if not name.endswith("_serve")
                or not k.endswith("_bwd")]
        require(not on_card or (got == expect
                                and min(expect[k] for k in must) > 0),
                f"{name}: launch counts are off")
        counts[name] = got

    for preset in VARIANTS:
        t0 = time.time()
        short = preset.rsplit("_", 1)[1]
        c, _ = config_from_args([
            "--preset", preset, "--data-path", "synthetic", "--max-epoch",
            "1", "--result-root", str(tmp), "--exp-name", short,
            "--stage1-model-path", s1_path])
        c = shrink(c)
        _, val = return_dataset(c)
        reset_peak()
        reset_counts()
        tt = time.time()
        best = engine.train_net(c, max_steps_per_epoch=3, device=dev)
        sync()
        train_s = time.time() - tt
        expect, how = derived_counts(c, 3, c.num_frames,
                                     -(-len(val) // c.test_batch_size),
                                     c.num_frames)
        log(f"[variants] {short}: train_net from phase 4's stage-1 file, 3 "
            f"steps at batch {c.batch_size}, an eval of {len(val)} clips, a "
            f"checkpoint, in {train_s:.2f} s; peak device memory "
            f"{peak_gib():.2f} GiB")
        check_counts(f"{short}_train", read_counts(), expect, how)
        losses = [float(v) for v in re.findall(
            r"Loss: ([-+0-9.eEnaif]+)",
            (Path(c.result_path) / "log.txt").read_text())]
        ckpt = best.get("checkpoint")
        require(len(losses) == 2 and all(map(math.isfinite, losses))
                and ckpt is not None and Path(ckpt).exists(),
                f"{short}: losses {losses}, checkpoint {ckpt}")

        model, optimizer, _ = engine.setup_training(c, dev)
        sbatch = to_device(make_synthetic_batch(
            c, c.batch_size, rng=np.random.RandomState(SEED + 41)), dev)
        reset_peak()
        ms = time_host(lambda: engine.train_step(model, optimizer, sbatch, c),
                       6) if on_card else [0.0] * 6
        warm = sum(ms[1:]) / len(ms[1:])
        numbers[f"{short}_step_ms"] = warm
        numbers[f"{short}_peak_gib"] = peak_gib()
        log(f"[variants] {short}: train / eval loss {losses} (finite); step "
            f"times {', '.join(f'{v:.1f}' for v in ms)} ms (host clock, "
            f"synchronized; batch of {c.batch_size} clips on the device); "
            f"after the warm-up step {warm:.1f} ms per step = "
            f"{c.batch_size / max(warm, 1e-9) * 1e3:.3f} clips/s; peak "
            f"device memory {numbers[f'{short}_peak_gib']:.2f} GiB [{smi}]")
        if on_card:
            prof = traced_step(lambda: engine.train_step(model, optimizer,
                                                         sbatch, c))
            busy = prof["busy_us"]
            numbers[f"{short}_busy_ms"] = busy / 1e3
            numbers[f"{short}_idle"] = 1 - busy / prof["wall_us"]
            log(f"[variants] {short}, one profiled step: wall "
                f"{prof['wall_us'] / 1e3:.1f} ms, device busy "
                f"{busy / 1e3:.1f} ms (idle share "
                f"{numbers[f'{short}_idle']:.3f}); device time by kind: "
                + ", ".join(f"{k} {v / 1e3:.2f} ms"
                            for k, v in prof["by_category"].items()))
        if on_card and short == "tce":
            numbers.update(tce_times(
                model.multilayer_head_embfeature_context_encoding, c, smi))
        del model, optimizer, sbatch
        if on_card:
            torch.cuda.empty_cache()

        predictor = Predictor.from_checkpoint(c, ckpt, pad_to=2, device=dev)
        req = make_synthetic_batch(c, 3, rng=np.random.RandomState(SEED + 42))
        reset_counts()
        outs, req_ms = [], []
        for n in (1, 3):
            tr = time.perf_counter()
            outs.append(predictor(req["images"][:n], req["boxes"][:n])[
                "activities"])
            sync()
            req_ms.append((time.perf_counter() - tr) * 1e3)
        sexpect, show = derived_counts(c, 0, c.num_frames, 1 + 2,
                                       c.num_frames, eval_batch=2)
        check_counts(f"{short}_serve", read_counts(), sexpect,
                     show + "; requests of 1 and 3 clips at pad_to=2")
        for out, n in zip(outs, (1, 3)):
            require(out.shape == (n, c.num_activities)
                    and np.isfinite(out).all()
                    and np.abs(out.sum(-1) - 1).max() <= 1e-5,
                    f"{short}: posteriors are off")
        rep = float(np.abs(outs[0][0] - outs[1][0]).max())
        log(f"[variants] {short}: Predictor.from_checkpoint(pad_to=2), "
            f"requests of 1 and 3 clips: {req_ms[0]:.1f}, {req_ms[1]:.1f} ms "
            f"(host clock; the first includes warm-up); rows finite, sum to "
            f"1; clip 0 in both differs by {rep:.3g}")
        del predictor

        if on_card:
            small = c.replace(image_size=(144, 160), out_size=(4, 5),
                              num_frames=3, compute_dtype="float32",
                              train_dropout_prob=0.0,
                              load_backbone_stage2=False)
            gen = torch.Generator().manual_seed(SEED)
            cpu_model = build_model(small, device="cpu", generator=gen)
            _randomize_din(cpu_model, gen)
            n_fixed = _zero_fixed_dropouts(cpu_model)
            clip = make_synthetic_batch(small, 1,
                                        rng=np.random.RandomState(SEED + 1))
            # along the card's own trajectory the share beyond 2e-5 is
            # reported, as for stage 1 and the collective path, the 2 lr
            # per step bound holds: a (1,3) field's offset-conv bias has 6
            # elements, so one flipped Adam step is 1/6 of it (0.1667 in
            # _multi, 0.0625 in another run of the same code), and TCE's
            # attention hands every map cell a gradient, so a flip reaches
            # all of conv1_1's sums (0.173)
            numbers[f"{short}_card_vs_cpu"] = card_vs_cpu(
                short, small, cpu_model, clip, n_fixed)
            del cpu_model
            torch.cuda.empty_cache()
        log(f"[variants] {short} done in {time.time() - t0:.2f} s")
    return dict(counts=counts, numbers=numbers)


BASELINES = ("volleyball_stage2_pctdm", "volleyball_stage2_higcin",
             "volleyball_stage2_at", "volleyball_stage2_arg",
             "volleyball_stage2_sacrf_biute")


def baselines_path(dev, tmp: Path, smi: str, reset_counts, read_counts,
                   image_size=(720, 1280), shrink=lambda c: c) -> dict:
    """Phase 12: the ResNet-18 baselines at full width (see the module
    docstring).  ``image_size`` and ``shrink`` (applied to every config)
    size it down for a rehearsal on the CPU, where no kernel launches and
    neither the counts nor the card against the CPU are checked.  Returns
    the launch counts of each path and the measured numbers."""
    from din_tpu_torch.data.datasets import return_dataset
    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.experiments.run import config_from_args
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.train import engine

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    H, W = image_size
    out_size = (-(-H // 32), -(-W // 32))
    t_all = time.time()
    counts, numbers = {}, {}

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0

    def reset_peak():
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def check_counts(name, got, expect, how):
        log(f"[baselines] {name}: launches {got}, expected {expect} ({how})")
        require(not on_card or (got == expect and expect["roi_align"] > 0),
                f"{name}: launch counts are off")
        counts[name] = got

    def check_posteriors(out, n, c, what):
        require(out["activities"].shape == (n, c.num_activities)
                and all(np.isfinite(v).all()
                        and np.abs(v.sum(-1) - 1).max() <= 1e-5
                        for v in out.values()),
                f"{what}: posteriors are off")

    def request(c, n, seed):
        """n synthetic clips; ARG's and GCNNet's of 9 frames (three crops
        of 3), as the Volleyball loader's eval order gives them."""
        T = 9 if c.inference_module_name in (
            "arg_volleyball", "gcnnet_volleyball") else c.num_frames
        b = make_synthetic_batch(c.replace(num_frames=T), n,
                                 rng=np.random.RandomState(seed))
        return b, T

    # -- a ResNet-18 stage 1 on Volleyball, the file the baselines graft ------
    res_path = tmp / "resnet18_pretrained.pth"
    write_torchvision_file(str(res_path), "res18", SEED + 51)
    s1 = shrink(PRESETS["volleyball_stage1"]().replace(
        backbone="res18", out_size=out_size, emb_features=512,
        image_size=image_size, data_path="synthetic", max_epoch=1,
        result_root=str(tmp), exp_name="vd_res18_stage1",
        pretrained_backbone_path=str(res_path)))
    _, s1_val = return_dataset(s1)
    reset_counts()
    tt = time.time()
    s1_best = engine.train_net(s1, max_steps_per_epoch=3, device=dev)
    sync()
    passes = 1 + bool(s1.test_before_train)
    expect, how = derived_counts(s1, 3, 1, passes * -(-len(s1_val)
                                                      // s1.test_batch_size),
                                 s1.num_frames)
    log(f"[baselines] stage 1 (volleyball_stage1 with res18, {H}x{W}): "
        f"train_net from a torchvision-layout ResNet-18 file, 3 steps of "
        f"{s1.batch_size} one-frame clips, {passes} evals of {len(s1_val)} "
        f"clips, in {time.time() - tt:.2f} s")
    check_counts("vd_res18_stage1", read_counts(), expect, how)
    base = tmp / "basemodel_VD_res18.pth"
    shutil.copy(s1_best["checkpoint"], base)

    for preset in BASELINES:
        t0 = time.time()
        short = preset[len("volleyball_stage2_"):]
        c, _ = config_from_args([
            "--preset", preset, "--data-path", "synthetic", "--max-epoch",
            "1", "--result-root", str(tmp), "--exp-name", short,
            "--stage1-model-path", str(base)])
        c = shrink(c.replace(image_size=image_size, out_size=out_size))
        _, val = return_dataset(c)
        reset_peak()
        reset_counts()
        tt = time.time()
        best = engine.train_net(c, max_steps_per_epoch=3, device=dev)
        sync()
        train_s = time.time() - tt
        passes = 1 + bool(c.test_before_train)
        expect, how = derived_counts(c, 3, c.num_frames, passes * -(
            -len(val) // c.test_batch_size), c.num_frames)
        log(f"[baselines] {short}: train_net grafted from {base.name}, 3 "
            f"steps at batch {c.batch_size} (T={c.num_frames}), {passes} "
            f"eval(s) of {len(val)} clips, a checkpoint, in {train_s:.2f} "
            f"s; peak device memory {peak_gib():.2f} GiB")
        check_counts(f"{short}_train", read_counts(), expect, how)
        losses = [float(v) for v in re.findall(
            r"Loss: ([-+0-9.eEnaif]+)",
            (Path(c.result_path) / "log.txt").read_text())]
        ckpt = best.get("checkpoint")
        require(len(losses) == 1 + passes and all(map(math.isfinite, losses))
                and ckpt is not None and Path(ckpt).exists(),
                f"{short}: losses {losses}, checkpoint {ckpt}")

        model, optimizer, _ = engine.setup_training(c, dev)
        sbatch = to_device(make_synthetic_batch(
            c, c.batch_size, rng=np.random.RandomState(SEED + 52)), dev)
        reset_peak()
        ms = time_host(lambda: engine.train_step(model, optimizer, sbatch, c),
                       6) if on_card else [0.0] * 6
        warm = sum(ms[1:]) / len(ms[1:])
        numbers[f"{short}_step_ms"] = warm
        numbers[f"{short}_peak_gib"] = peak_gib()
        log(f"[baselines] {short}: train / eval losses {losses} (finite); "
            f"step times {', '.join(f'{v:.1f}' for v in ms)} ms (host "
            f"clock, synchronized; batch of {c.batch_size} clips on the "
            f"device); after the warm-up step {warm:.1f} ms per step = "
            f"{c.batch_size / max(warm, 1e-9) * 1e3:.3f} clips/s; peak "
            f"device memory {numbers[f'{short}_peak_gib']:.2f} GiB [{smi}]")
        if on_card:
            prof = traced_step(lambda: engine.train_step(model, optimizer,
                                                         sbatch, c))
            busy = prof["busy_us"]
            numbers[f"{short}_busy_ms"] = busy / 1e3
            numbers[f"{short}_idle"] = 1 - busy / prof["wall_us"]
            log(f"[baselines] {short}, one profiled step: wall "
                f"{prof['wall_us'] / 1e3:.1f} ms, device busy "
                f"{busy / 1e3:.1f} ms (idle share "
                f"{numbers[f'{short}_idle']:.3f}); device time by kind: "
                + ", ".join(f"{k} {v / 1e3:.2f} ms"
                            for k, v in prof["by_category"].items())
                + "; top: " + "; ".join(
                    f"{us / 1e3:.2f} ms x{n} {key[:50]}"
                    for us, n, key in prof["top"][:4]))
        del model, optimizer, sbatch
        if on_card:
            torch.cuda.empty_cache()

        predictor = Predictor.from_checkpoint(c, ckpt, pad_to=2, device=dev)
        req, T = request(c, 3, SEED + 53)
        reset_counts()
        outs, req_ms = [], []
        for n in (1, 3):
            tr = time.perf_counter()
            outs.append(predictor(req["images"][:n], req["boxes"][:n]))
            sync()
            req_ms.append((time.perf_counter() - tr) * 1e3)
        sexpect, show = derived_counts(c, 0, c.num_frames, 1 + 2, T,
                                       eval_batch=2)
        check_counts(f"{short}_serve", read_counts(), sexpect,
                     show + "; requests of 1 and 3 clips at pad_to=2")
        for out, n in zip(outs, (1, 3)):
            check_posteriors(out, n, c, short)
        rep = float(np.abs(outs[0]["activities"][0]
                           - outs[1]["activities"][0]).max())
        lat = time_host(lambda: predictor(req["images"][:1],
                                          req["boxes"][:1]), 6) \
            if on_card else [0.0]
        numbers[f"{short}_serve_1clip_ms"] = float(np.median(lat))
        log(f"[baselines] {short}: Predictor.from_checkpoint(pad_to=2), "
            f"requests of 1 and 3 clips of T={T}"
            f"{' (three crops of 3 frames)' if T == 9 else ''}: "
            f"{req_ms[0]:.1f}, {req_ms[1]:.1f} ms (the first includes "
            f"warm-up); posteriors ({', '.join(sorted(outs[0]))}) finite, "
            f"rows sum to 1; clip 0 in both differs by {rep:.3g}; 1-clip "
            f"requests, 6 more: median "
            f"{numbers[f'{short}_serve_1clip_ms']:.2f} ms (min "
            f"{min(lat):.2f}, max {max(lat):.2f}) [{smi}]")
        del predictor

        if on_card:
            small = c.replace(image_size=(128, 192), out_size=(4, 6),
                              num_frames=3, compute_dtype="float32",
                              train_dropout_prob=0.0,
                              load_backbone_stage2=False)
            gen = torch.Generator().manual_seed(SEED)
            cpu_model = build_model(small, device="cpu", generator=gen)
            n_fixed = _zero_fixed_dropouts(cpu_model)
            clip, _ = request(small, 2, SEED + 54)
            # ResNet-18 with live BatchNorm, as the collective path: a
            # flipped gradient's two Adam steps were 2.0003e-4 apart at
            # 2 lr = 2e-4 (a BatchNorm weight near 1: the f32 spacing) and
            # 2.0000339e-4 (a conv weight; check_params), and a head
            # BatchNorm's batch variance cancels (its running statistics,
            # stats_rtol)
            numbers[f"{short}_card_vs_cpu"] = card_vs_cpu(
                short, small, cpu_model, clip, n_fixed, ulps=2,
                stats_rtol=1e-4)
            del cpu_model
            torch.cuda.empty_cache()
        log(f"[baselines] {short} done in {time.time() - t0:.2f} s")

    # -- GCNNet: the legacy trainer's models, one request and one step -------
    for preset, name in (("volleyball_stage2_arg", "gcnnet_volleyball"),
                         ("collective_stage2_dynamic", "gcnnet_collective")):
        c = PRESETS[preset]().replace(inference_module_name=name,
                                      load_backbone_stage2=False)
        if c.dataset_name == "volleyball":
            c = c.replace(image_size=image_size, out_size=out_size)
        else:
            ch, cw = (480, 720) if on_card else image_size
            c = c.replace(image_size=(ch, cw), out_size=(-(-ch // 32),
                                                         -(-cw // 32)))
        c = shrink(c)
        model, optimizer, _ = engine.setup_training(c, dev)
        if c.dataset_name == "collective":
            req = cad_request(c, 1, [7], SEED + 55)
            step = cad_request(c, c.batch_size, [c.num_boxes, 5][
                :c.batch_size], SEED + 56)
            T = c.num_frames
        else:
            req, T = request(c, 1, SEED + 55)
            step = make_synthetic_batch(c, c.batch_size,
                                        rng=np.random.RandomState(SEED + 56))
        reset_counts()
        out = Predictor(c, model, device=dev)(req["images"], req["boxes"],
                                              req.get("bboxes_num"))
        metrics = engine.train_step(model, optimizer, to_device(step, dev), c)
        sync()
        check_posteriors(out, 1, c, name)
        loss = float(metrics["loss"])
        require(math.isfinite(loss) and "actions" in out,
                f"{name}: loss {loss}, outputs {sorted(out)}")
        expect = {"max_pool_2x2": 0, "roi_align": 2, "max_pool_2x2_bwd": 0,
                  "roi_align_bwd": int(c.train_backbone), "fused_stem": 0}
        check_counts(name, read_counts(), expect,
                     "1 RoIAlign for the request, 1 for the step and its "
                     "backward when the backbone trains")
        log(f"[baselines] {name} ({preset} with the model switched, "
            f"{c.image_size[0]}x{c.image_size[1]}): a 1-clip request of "
            f"T={T} (activities and actions finite, rows sum to 1) and one "
            f"step at batch {c.batch_size}, loss {loss:.5f}")
        del model, optimizer
    log(f"[baselines] done in {time.time() - t_all:.2f} s [{smi}]")
    return dict(counts=counts, numbers=numbers)


def backbone_maps(name: str, H: int, W: int) -> list:
    """The (h, w) of each map the backbone ``name`` gives for H x W frames
    (Inception-v3: Mixed_5d, then Mixed_6e), from its layers' strides."""
    def down(n, k=3, s=2, p=0):
        return (n + 2 * p - k) // s + 1

    def one(n):
        if name in ("vgg16", "vgg19"):
            return n // 32
        if name in ("res18", "res50"):
            for _ in range(5):                  # conv1, pool, layer2-4
                n = down(n, p=1)
            return n
        if name == "alex":
            return down(down(down(down(n, 11, 4, 2))))
        n = down(down(n), 3, 1)                 # inv3: 1a (s2), 2a
        n = down(down(down(n), 3, 1))           # pool, 4a, pool
        return (n, down(n))                     # Mixed_5d, Mixed_6e
    sizes = (one(H), one(W))
    if name == "inv3":
        return [(sizes[0][i], sizes[1][i]) for i in range(2)]
    return [sizes]


BACKBONE_CHANNELS = {"inv3": 1056, "vgg19": 512, "res50": 2048, "alex": 256}


def write_torchvision_file(path: str, name: str, seed: int) -> dict:
    """A torchvision-layout ``state_dict`` file of backbone ``name``, as a
    user's pretrained ImageNet backbone would be: conv weights at their
    init scale (std sqrt(2 / fan_in)), conv biases ~0.05, BatchNorm weights
    near 1, biases and running means near 0, running variances in [0.5,
    1.5], ``num_batches_tracked`` 1000; ResNet's ``conv1``, ``bn1``,
    ``layerK``; and small stand-ins of what the backbone leaves out
    (classifier, ``fc``, Inception-v3's ``AuxLogits`` and ``Mixed_7*``).
    Returns the tensors written."""
    from din_tpu_torch.nn.backbones import BACKBONES, RESNET_SEQ

    top = {v: k for k, v in RESNET_SEQ.items()}
    gen = torch.Generator().manual_seed(seed)
    own = BACKBONES[name](gen).state_dict()
    state = {}
    for k, v in own.items():
        module = k.rsplit(".", 1)[0]
        if k.endswith("num_batches_tracked"):
            t = torch.tensor(1000, dtype=torch.int64)
        elif k.endswith("running_var"):
            t = torch.rand(v.shape, generator=gen) + 0.5
        elif v.dim() > 1:
            t = torch.randn(v.shape, generator=gen) * (
                2.0 / math.prod(v.shape[1:])) ** 0.5
        elif module + ".running_mean" in own:   # a BatchNorm's affine
            t = 0.1 * torch.randn(v.shape, generator=gen) + float(
                k.endswith("weight"))
        else:
            t = 0.05 * torch.randn(v.shape, generator=gen)
        if name in ("res18", "res50"):
            head, idx, rest = k.split(".", 2)
            k = f"{top[head + '.' + idx]}.{rest}"
        state[k] = t
    # torchvision's classifier.0 of a VGG alone is 400 MB
    extra = {"vgg16": ("classifier.6.weight",),
             "vgg19": ("classifier.6.weight",),
             "alex": ("classifier.6.weight",), "res18": ("fc.weight",),
             "res50": ("fc.weight",),
             "inv3": ("AuxLogits.fc.weight",
                      "Mixed_7a.branch3x3_1.conv.weight",
                      "Mixed_7c.branch_pool.bn.running_var", "fc.weight")}
    for k in extra[name]:
        state[k] = torch.randn((8, 16), generator=gen)
    torch.save(state, path)
    return state


def check_loaded(model: torch.nn.Module, state: dict, name: str) -> list:
    """Requires every tensor of ``model.backbone`` to equal the tensor of
    ``write_torchvision_file``'s ``state`` it was loaded from (ResNet's by
    their torchvision names); returns the file's keys left unused."""
    from din_tpu_torch.nn.backbones import RESNET_SEQ

    top = {v: k for k, v in RESNET_SEQ.items()}
    own = model.backbone.state_dict()
    used = set()
    for k, v in own.items():
        key = k
        if name in ("res18", "res50"):
            head, idx, rest = k.split(".", 2)
            key = f"{top[head + '.' + idx]}.{rest}"
        used.add(key)
        require(torch.equal(v.cpu(), state[key]),
                f"{name}: backbone.{k} differs from the file's {key}")
    return sorted(set(state) - used)


def backbones_path(dev, tmp: Path, smi: str, reset_counts, read_counts,
                   sizes=((480, 720), (720, 1280)), small=(128, 192),
                   shrink=lambda c: c) -> dict:
    """Phase 13: Inception-v3 and the two-scale RoIAlign, VGG-19, ResNet-50
    and AlexNet (see the module docstring).  ``sizes`` (the collective and
    the Volleyball frames), ``small`` (the card-against-CPU geometry) and
    ``shrink`` (applied to every config) size it down for a rehearsal on
    the CPU, where no kernel launches and neither the counts, nor the
    kernels at the new shapes, nor the card against the CPU are checked.
    Returns the launch counts of each path, the kernels' errors and times
    at the new shapes, and the measured numbers."""
    from din_tpu_torch.data.datasets import return_dataset
    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.models.registry import build_model
    import torch.nn.functional as F

    from din_tpu_torch.nn.backbones import BACKBONE_HAS_BN, avg_pool_3x3
    from din_tpu_torch.nn.ref_import import load_pretrained_backbone
    from din_tpu_torch.train import engine

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    (CH, CW), (VH, VW) = sizes
    cad_maps = backbone_maps("inv3", CH, CW)
    t_all = time.time()
    counts, numbers = {}, {}

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0

    def reset_peak():
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def check_counts(name, got, expect, how):
        log(f"[backbones] {name}: launches {got}, expected {expect} ({how})")
        require(not on_card or (got == expect and expect["roi_align"] > 0),
                f"{name}: launch counts are off")
        counts[name] = got

    def check_posteriors(out, n, c, what):
        require(out["activities"].shape[0] == n
                and all(np.isfinite(v).all()
                        and np.abs(v.sum(-1) - 1).max() <= 1e-5
                        for v in out.values()),
                f"{what}: posteriors are off")

    def loaded(model, state, name):
        unused = check_loaded(model, state, name)
        log(f"[backbones] {name}: load_pretrained_backbone put the "
            f"torchvision-layout file's {len(model.backbone.state_dict())} "
            f"backbone tensors"
            + (" (BatchNorm statistics included)" if BACKBONE_HAS_BN[name]
               else "") + f" in place, equal to the file's; unused: "
            f"{', '.join(unused)}")

    def timed_steps(model, optimizer, c, batch, n):
        reset_peak()
        ms = time_host(lambda: engine.train_step(model, optimizer, batch, c),
                       n) if on_card else [0.0] * n
        return ms, peak_gib()

    def requests(predictor, c, req, what):
        """A 1-clip request (with warm-up), then six more: the median."""
        nb = req.get("bboxes_num")
        args = (req["images"][:1], req["boxes"][:1],
                None if nb is None else nb[:1])
        tr = time.perf_counter()
        out = predictor(*args)
        sync()
        first = (time.perf_counter() - tr) * 1e3
        check_posteriors(out, 1, c, what)
        lat = time_host(lambda: predictor(*args), 6) if on_card else [0.0]
        numbers[f"{what}_serve_1clip_ms"] = float(np.median(lat))
        log(f"[backbones] {what}: Predictor(pad_to=2), a 1-clip request "
            f"of T={c.num_frames} in {first:.1f} ms (warm-up), 6 more: median "
            f"{np.median(lat):.2f} ms (min {min(lat):.2f}, max "
            f"{max(lat):.2f}); posteriors finite, rows sum to 1 [{smi}]")

    # -- (e) K1 and K1b at the new maps ----------------------------------------
    kernels = {}
    if on_card:
        t0 = time.time()
        gen = torch.Generator().manual_seed(SEED + 61)
        dgen = torch.Generator(device=dev).manual_seed(SEED + 61)
        flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
        shapes = {
            # collective_stage1's eval call: 8 clips of 10 frames; 13 slots
            "inv3_collective": ((80, *cad_maps[0], 288), 13, 4),
            "inv3_volleyball": ((20, *backbone_maps("inv3", VH, VW)[0], 288),
                                12, 0),
            "res50": ((20, *backbone_maps("res50", VH, VW)[0], 2048), 12, 0),
            "alex": ((20, *backbone_maps("alex", VH, VW)[0], 256), 12, 0)}
        for key, (shape, nb, pad) in shapes.items():
            feats = torch.randn(shape, generator=dgen, device=dev)
            boxes = cad_boxes(shape[0], nb, pad, shape[1], shape[2],
                              gen).to(dev)
            errs = check_roi_kernels(feats, boxes, (5, 5), dgen)
            times = roi_times(feats.bfloat16(), boxes, (5, 5), dgen, flush)
            kernels[key] = dict(shape=list(shape), boxes=nb,
                                zero_padded=pad, errs=errs, times=times)
            log(f"[backbones] K1 and K1b at {key} {list(shape)} x {nb} "
                f"boxes ({pad} zero-padded), crop 5x5: K1 bit-equal to plain "
                f"in f32 and bf16; K1b vs plain on the card "
                f"f32 {errs['k1b_f32']:.3g}, bf16 {errs['k1b_bf16']:.3g} "
                f"(1e-5 * max|df|, plus 1 ulp in bf16), bit-equal to the "
                f"plain version on the CPU; bf16 times: K1 wrapper "
                f"{times['k1_ms']:.4f} ms, launch alone "
                f"{times['k1_launch_ms']:.4f} ms, device time "
                f"{times['k1_device_ms']:.4f} ms (by "
                f"{times['k1_device_ms_by']}), F.grid_sample "
                f"{times['k1_grid_sample_ms']:.4f} ms, bound "
                f"{times['k1_bound']:.5f} ms "
                f"({times['k1_mb']:.2f} MB, {times['in_range']} of "
                f"{times['samples']} samples in range), plain "
                f"{times['k1_plain']:.4f} ms; K1b wrapper "
                f"{times['k1b_ms']:.4f} ms, bound {times['k1b_bound']:.5f} ms "
                f"({times['k1b_mb']:.2f} MB), plain {times['k1b_plain']:.4f} "
                f"ms [{smi}]")
            del feats, boxes
        del flush
        # Inception-v3's branch pool, forward and backward, against the CPU
        # on channels_last maps of Mixed_5b and Mixed_6b's inputs: the
        # port's avg_pool_3x3 (backward = the same pool) is held, PyTorch's
        # own backward of F.avg_pool2d is reported
        for shape in ((8, 192, *cad_maps[0]), (8, 768, *cad_maps[1])):
            x = torch.randn(shape, generator=gen).contiguous(
                memory_format=torch.channels_last)
            g = torch.randn(shape, generator=gen)
            outs = {}
            for name, pool in (("port", avg_pool_3x3), ("torch", lambda t:
                               F.avg_pool2d(t, 3, 1, 1))):
                for d in ("cpu", dev):
                    xd = x.detach().to(d).requires_grad_()
                    y = pool(xd)
                    y.backward(g.to(d))
                    outs[name, str(d)] = (y.detach().cpu(), xd.grad.cpu())
            errs = {name: [float((a - b).abs().max() / b.abs().max())
                           for a, b in zip(outs[name, str(dev)],
                                           outs[name, "cpu"])]
                    for name in ("port", "torch")}
            require(max(errs["port"]) <= 1e-6, f"avg_pool_3x3 {list(shape)} "
                    f"card vs CPU: {errs['port']}")
            numbers[f"avg_pool_{shape[1]}_torch_bwd_err"] = errs["torch"][1]
            log(f"[backbones] Inception's 3x3/s1 average pool on a "
                f"channels_last f32 {list(shape)} map, card against CPU, "
                f"largest |diff| over the CPU's largest |value|: avg_pool_3x3 "
                f"forward {errs['port'][0]:.3g}, backward "
                f"{errs['port'][1]:.3g} (<= 1e-6); PyTorch's F.avg_pool2d "
                f"forward {errs['torch'][0]:.3g}, its own backward "
                f"{errs['torch'][1]:.3g} (reported)")
        torch.cuda.empty_cache()
        log(f"[backbones] kernels at the new maps in {time.time() - t0:.2f} s")

    # -- (a) collective_stage1 as the preset defines it (Inception-v3) -------
    t0 = time.time()
    inv3_path = tmp / "inception_v3_pretrained.pth"
    inv3_state = write_torchvision_file(str(inv3_path), "inv3", SEED + 62)
    s1 = shrink(PRESETS["collective_stage1"]().replace(
        image_size=(CH, CW), out_size=cad_maps[0], data_path="synthetic",
        max_epoch=1, result_root=str(tmp), exp_name="cad_inv3_stage1",
        pretrained_backbone_path=str(inv3_path)))
    model, optimizer, _ = engine.setup_training(s1, dev)
    loaded(model, inv3_state, "inv3")
    batch = to_device(cad_request(s1.replace(num_frames=1), s1.batch_size,
                                  ([s1.num_boxes, 1, 7] * s1.batch_size)[
                                      :s1.batch_size], SEED + 63), dev)
    ms, peak = timed_steps(model, optimizer, s1, batch, 3)
    numbers["cad_inv3_stage1_step_ms"] = ms[-1]
    numbers["cad_inv3_stage1_peak_gib"] = peak
    log(f"[backbones] collective_stage1 ({CH}x{CW}, Mixed_5d "
        f"{cad_maps[0]} = out_size, Mixed_6e {cad_maps[1]} through the "
        f"composed rows): step times {', '.join(f'{v:.1f}' for v in ms)} ms "
        f"(host clock, synchronized; {s1.batch_size} one-frame clips, 13 "
        f"actor slots, BatchNorm live); peak device memory {peak:.2f} GiB "
        f"[{smi}]")
    del model, optimizer, batch
    if on_card:
        torch.cuda.empty_cache()
    _, s1_val = return_dataset(s1)
    reset_peak()
    reset_counts()
    tt = time.time()
    s1_best = engine.train_net(s1, max_steps_per_epoch=3, device=dev)
    sync()
    evals = -(-len(s1_val) // s1.test_batch_size)
    expect, how = derived_counts(s1, 3, 1, evals, s1.num_frames)
    log(f"[backbones] collective_stage1: train_net from the torchvision "
        f"Inception-v3 file, 3 steps, an eval of {len(s1_val)} clips of "
        f"T={s1.num_frames} at batch {s1.test_batch_size}, a component file, "
        f"in {time.time() - tt:.2f} s; peak device memory "
        f"{peak_gib():.2f} GiB")
    check_counts("cad_inv3_stage1", read_counts(), expect, how)
    losses = [float(v) for v in re.findall(
        r"Loss: ([-+0-9.eEnaif]+)",
        (Path(s1.result_path) / "log.txt").read_text())]
    require(len(losses) == 2 and all(map(math.isfinite, losses)),
            f"collective_stage1 losses {losses}")
    comp = torch.load(s1_best["checkpoint"], map_location="cpu",
                      weights_only=True)
    fresh = build_model(s1, device="cpu")
    for part in ("backbone", "fc_emb", "fc_actions", "fc_activities"):
        getattr(fresh, part).load_state_dict(comp[f"{part}_state_dict"],
                                             strict=True)
    require(int(comp["backbone_state_dict"][
        "Conv2d_1a_3x3.bn.num_batches_tracked"]) == 1000 + 3,
        "the component file's BatchNorm did not count 3 steps")
    log(f"[backbones] collective_stage1: train / eval loss {losses} "
        f"(finite); its component file reloads strictly into a fresh "
        f"Basenet (num_batches_tracked 1000 + 3), in {time.time() - t0:.2f} s")
    del fresh, comp

    # -- (b) Volleyball on Inception-v3 at the reference's defaults ----------
    t0 = time.time()
    vd_maps = backbone_maps("inv3", VH, VW)
    inv3_fields = dict(backbone="inv3", out_size=vd_maps[0],
                       emb_features=1056, image_size=(VH, VW),
                       data_path="synthetic", max_epoch=1,
                       result_root=str(tmp))
    v1 = shrink(PRESETS["volleyball_stage1"]().replace(
        exp_name="vd_inv3_stage1", **inv3_fields))
    _, v1_val = return_dataset(v1)
    reset_peak()
    reset_counts()
    tt = time.time()
    v1_best = engine.train_net(v1, max_steps_per_epoch=2, device=dev)
    sync()
    passes = 1 + bool(v1.test_before_train)
    expect, how = derived_counts(v1, 2, 1, passes * -(
        -len(v1_val) // v1.test_batch_size), v1.num_frames)
    log(f"[backbones] volleyball_stage1 on inv3 ({VH}x{VW}, Mixed_5d "
        f"{vd_maps[0]} = out_size, Mixed_6e {vd_maps[1]}): train_net, 2 "
        f"steps of {v1.batch_size} one-frame clips, {passes} evals of "
        f"{len(v1_val)} clips, in {time.time() - tt:.2f} s; peak device "
        f"memory {peak_gib():.2f} GiB [{smi}]")
    check_counts("vd_inv3_stage1", read_counts(), expect, how)
    v1_file = tmp / "basemodel_VD_inv3.pth"
    shutil.copy(v1_best["checkpoint"], v1_file)
    v2 = shrink(PRESETS["volleyball_stage2_dynamic"]().replace(
        exp_name="vd_inv3_stage2", stage1_model_path=str(v1_file),
        **inv3_fields))
    model, optimizer, _ = engine.setup_training(v2, dev)
    comp = torch.load(v1_file, map_location="cpu", weights_only=True)
    own = model.state_dict()
    require(all(torch.equal(own["backbone." + k].cpu(), v)
                for k, v in comp["backbone_state_dict"].items())
            and all(torch.equal(own["fc_emb_1." + k].cpu(), v)
                    for k, v in comp["fc_emb_state_dict"].items()),
            "the grafted Inception-v3 differs from the stage-1 file")
    sbatch = to_device(make_synthetic_batch(
        v2, v2.batch_size, rng=np.random.RandomState(SEED + 64)), dev)
    ms, peak = timed_steps(model, optimizer, v2, sbatch, 2)
    numbers["vd_inv3_step_ms"] = ms[-1]
    numbers["vd_inv3_peak_gib"] = peak
    log(f"[backbones] volleyball_stage2_dynamic on inv3, grafted from "
        f"{v1_file.name} (backbone.* with its BatchNorm buffers and fc_emb_1 "
        f"equal the file's): 2 steps at batch {v2.batch_size}, T="
        f"{v2.num_frames}, N={v2.num_boxes}: "
        f"{', '.join(f'{v:.1f}' for v in ms)} ms (host clock, "
        f"synchronized); peak device memory {peak:.2f} GiB [{smi}]")
    del model, optimizer, sbatch, comp
    if on_card:
        torch.cuda.empty_cache()
    _, v2_val = return_dataset(v2)
    reset_counts()
    tt = time.time()
    v2_best = engine.train_net(v2, max_steps_per_epoch=2, device=dev)
    sync()
    expect, how = derived_counts(v2, 2, v2.num_frames, -(
        -len(v2_val) // v2.test_batch_size), v2.num_frames)
    log(f"[backbones] volleyball_stage2_dynamic on inv3: train_net, 2 steps, "
        f"an eval of {len(v2_val)} clips, a checkpoint, in "
        f"{time.time() - tt:.2f} s")
    check_counts("vd_inv3_stage2", read_counts(), expect, how)
    predictor = Predictor.from_checkpoint(v2, v2_best["checkpoint"],
                                          pad_to=2, device=dev)
    req = make_synthetic_batch(v2, 1, rng=np.random.RandomState(SEED + 65))
    reset_counts()
    requests(predictor, v2, req, "vd_inv3")
    expect, how = derived_counts(v2, 0, v2.num_frames,
                                 7 if on_card else 1, v2.num_frames,
                                 eval_batch=2)
    check_counts("vd_inv3_serve", read_counts(), expect,
                 how + "; 1-clip requests at pad_to=2")
    del predictor
    log(f"[backbones] Volleyball on Inception-v3 done in "
        f"{time.time() - t0:.2f} s")

    # -- (c) VGG-19, ResNet-50 and AlexNet under the flagship head -----------
    for name in ("vgg19", "res50", "alex"):
        t0 = time.time()
        (omap,) = backbone_maps(name, VH, VW)
        c = shrink(PRESETS["volleyball_stage2_dynamic"]().replace(
            backbone=name, out_size=omap,
            emb_features=BACKBONE_CHANNELS[name], image_size=(VH, VW),
            load_backbone_stage2=False, data_path="synthetic",
            result_root=str(tmp), exp_name=f"vd_{name}"))
        path = tmp / f"{name}_pretrained.pth"
        state = write_torchvision_file(str(path), name, SEED + 66)
        model, optimizer, _ = engine.setup_training(c, dev)
        load_pretrained_backbone(model, str(path))
        loaded(model, state, name)
        req = make_synthetic_batch(c, 1, rng=np.random.RandomState(SEED + 67))
        sbatch = to_device(make_synthetic_batch(
            c, c.batch_size, rng=np.random.RandomState(SEED + 68)), dev)
        reset_counts()
        requests(Predictor(c, model, pad_to=2, device=dev), c, req, name)
        ms, peak = timed_steps(model, optimizer, c, sbatch, 2)
        sync()
        expect, how = derived_counts(c, 2, c.num_frames,
                                     7 if on_card else 1, c.num_frames,
                                     eval_batch=2)
        check_counts(name, read_counts(), expect,
                     how + "; 1-clip requests at pad_to=2, then 2 steps")
        numbers[f"{name}_step_ms"] = ms[-1]
        numbers[f"{name}_peak_gib"] = peak
        log(f"[backbones] {name} under the flagship head ({VH}x{VW}, map "
            f"{omap} x {BACKBONE_CHANNELS[name]}): 2 steps at batch "
            f"{c.batch_size}, T={c.num_frames}: "
            f"{', '.join(f'{v:.1f}' for v in ms)} ms (host clock, "
            f"synchronized); peak device memory {peak:.2f} GiB, in "
            f"{time.time() - t0:.2f} s [{smi}]")
        del model, optimizer, sbatch
        if on_card:
            torch.cuda.empty_cache()

    # -- (d) the card against the CPU at a small geometry ---------------------
    if on_card:
        SH, SW = small
        for name in ("vgg19", "res50", "alex", "inv3"):
            t0 = time.time()
            maps = backbone_maps(name, SH, SW)
            if name == "inv3":
                sc = PRESETS["collective_stage1"]().replace(
                    out_size=maps[0], batch_size=2, test_batch_size=2)
                short = "collective_stage1"
            else:
                sc = PRESETS["volleyball_stage2_dynamic"]().replace(
                    backbone=name, out_size=maps[0],
                    emb_features=BACKBONE_CHANNELS[name],
                    load_backbone_stage2=False)
                short = name
            sc = sc.replace(image_size=(SH, SW), num_frames=3,
                            compute_dtype="float32", train_dropout_prob=0.0)
            cpu_model = build_model(sc, device="cpu",
                                    generator=torch.Generator().manual_seed(
                                        SEED))
            n_fixed = _zero_fixed_dropouts(cpu_model)
            clip = cad_request(sc, 2, [13, 7], SEED + 69) \
                if sc.dataset_name == "collective" else \
                make_synthetic_batch(sc, 2, rng=np.random.RandomState(
                    SEED + 69))
            bn = BACKBONE_HAS_BN[name]
            # BatchNorm backbones as phases 9 and 12 (Adam's largest step
            # plus 2 f32 ulps; running statistics within 1e-4), the others
            # with the VGG-16 paths' bounds
            numbers[f"{short}_card_vs_cpu"] = card_vs_cpu(
                short, sc, cpu_model, clip, n_fixed, ulps=2 if bn else 0,
                stats_rtol=1e-4 if bn else None)
            del cpu_model
            torch.cuda.empty_cache()
            log(f"[backbones] {short} card against CPU at {SH}x{SW} in "
                f"{time.time() - t0:.2f} s")
    log(f"[backbones] done in {time.time() - t_all:.2f} s [{smi}]")
    return dict(counts=counts, kernels=kernels, numbers=numbers)


_ARTIFACT_CHILD = r"""
import contextlib, json, sys, time
import numpy as np
import torch
from din_tpu_torch.experiments import export_serving
from din_tpu_torch.ops.pool import max_pool_2x2, max_pool_2x2_bwd
from din_tpu_torch.ops.roi_align import roi_align, roi_align_bwd
from din_tpu_torch.ops.stem import fused_stem

device, out_path, jobs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
wrappers = {"roi_align": roi_align, "max_pool_2x2": max_pool_2x2,
            "max_pool_2x2_bwd": max_pool_2x2_bwd,
            "roi_align_bwd": roi_align_bwd, "fused_stem": fused_stem}
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
report, arrays = {"allow_tf32_default": torch.backends.cudnn.allow_tf32}, {}
for name, artifact, request in jobs:
    t = time.time()
    served = export_serving.ExportedPredictor.load(artifact, device=device)
    sync()
    load_s = time.time() - t
    req = np.load(request)

    def ask(n):
        return served(*(req[k][:n] for k in ("images", "boxes", "bboxes_num")
                        if k in req))

    for w in wrappers.values():
        w.launches = 0
    ask(1)
    sync()
    counts = {k: w.launches for k, w in wrappers.items()}
    sizes = range(1, len(req["images"]) + 1)
    answers = {f"default/{n}": ask(n) for n in sizes}
    saved = torch.backends.cudnn.allow_tf32
    repaired = export_serving.ieee_f32_convs
    torch.backends.cudnn.allow_tf32 = True
    try:
        answers.update({f"tf32/{n}": ask(n) for n in sizes})
        # the program called without its IEEE context, as the trap would
        export_serving.ieee_f32_convs = contextlib.nullcontext
        answers["unrepaired/2"] = ask(2)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        export_serving.ieee_f32_convs = repaired
    for key, out in answers.items():
        for k, v in out.items():
            arrays[f"{name}/{key}/{k}"] = v
    report[name] = {"load_s": load_s, "counts": counts}
report["model_modules"] = sorted(
    m for m in sys.modules if m.split(".")[0] == "din_tpu_torch"
    and m.split(".")[1:2] in (["models"], ["heads"], ["nn"], ["train"]))
if report["model_modules"]:
    sys.exit("model code imported: " + ", ".join(report["model_modules"]))
np.savez(out_path, **arrays)
print(json.dumps(report))
"""


def export_path(dev, tmp: Path, ckpt: str, smi: str, reset_counts,
                read_counts, shrink=lambda c: c) -> dict:
    """Phase 14: the serving artifact (see the module docstring).
    ``shrink`` sizes the configs down for a rehearsal on the CPU, where no
    kernel launches and the counts and times are not taken.  Returns the
    launch counts of one exported 1-clip call of each artifact and the
    measured numbers."""
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments import export_serving
    from din_tpu_torch.experiments.export_serving import (ExportedPredictor,
                                                          export_predictor)
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.nn.ref_import import load_pretrained_backbone

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_all = time.time()
    fcfg = shrink(PRESETS["volleyball_stage2_dynamic"]())
    ccfg = shrink(PRESETS["collective_stage2_dynamic"]())
    flagship = Predictor.from_checkpoint(fcfg, ckpt, pad_to=2, device=dev)
    collective = Predictor.from_checkpoint(ccfg, None, pad_to=2, device=dev)
    res18 = tmp / "resnet18.pth"
    write_torchvision_file(str(res18), "res18", SEED + 141)
    load_pretrained_backbone(collective.model, str(res18))
    # its DIN convs away from 0, where TF32 would move the answer
    _randomize_din(collective.model, torch.Generator().manual_seed(SEED + 144))
    fb = make_synthetic_batch(fcfg, 3, rng=np.random.RandomState(SEED + 142))
    cases = {
        "flagship": (fcfg, flagship, {"images": fb["images"],
                                      "boxes": fb["boxes"]}),
        "collective": (ccfg, collective, {
            k: v for k, v in cad_request(ccfg, 3, (13, 1, 7),
                                         SEED + 143).items()
            if k in ("images", "boxes", "bboxes_num")})}
    counts, numbers, jobs, live = {}, {}, [], {}
    for name, (c, predictor, req) in cases.items():
        tt = time.time()
        data = export_predictor(predictor)
        export_s = time.time() - tt
        path = tmp / f"{name}.pt2"
        path.write_bytes(data)
        np.savez(tmp / f"{name}_request.npz", **req)
        jobs.append([name, str(path), str(tmp / f"{name}_request.npz")])
        header = export_serving.read_header(data)
        require(header["batch"] == 2 and header["device"] == dev.type,
                f"{name}: header {header}")
        numbers[name] = dict(export_s=export_s, mb=len(data) / 1e6)
        log(f"[export] {name} ({c.backbone}, {c.image_size[0]}x"
            f"{c.image_size[1]}, T={c.num_frames}, N={c.num_boxes}): "
            f"export_predictor at batch 2 in {export_s:.2f} s (host clock), "
            f"file {len(data) / 1e6:.1f} MB; header {json.dumps(header)}")
        n_clips = len(req["images"])
        reset_counts()
        keys = [k for k in ("images", "boxes", "bboxes_num") if k in req]
        predictor(*(req[k][:1] for k in keys))
        sync()
        live_counts = read_counts()
        live[name] = {n: predictor(*(req[k][:n] for k in keys))
                      for n in range(1, n_clips + 1)}
        expect, how = derived_counts(c, 0, c.num_frames, 1, c.num_frames,
                                     eval_batch=2)
        counts[name] = dict(live=live_counts, expect=expect, how=how)
    # a fresh interpreter loads both files with no model code and answers
    child = subprocess.run(
        [sys.executable, "-c", _ARTIFACT_CHILD, dev.type,
         str(tmp / "answers.npz"), json.dumps(jobs)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    require(child.returncode == 0, f"the artifact's interpreter failed "
            f"({child.returncode}):\n{child.stderr[-4000:]}")
    report = json.loads(child.stdout.strip().splitlines()[-1])
    answers = np.load(tmp / "answers.npz")
    log(f"[export] a fresh interpreter loaded both files with no module of "
        f"din_tpu_torch.models, heads, nn or train ({report['model_modules']}"
        f"); cudnn.allow_tf32 there by default: "
        f"{report['allow_tf32_default']}")
    gaps = {}
    for name, by_n in live.items():
        got = report[name]["counts"]
        want = counts[name]
        log(f"[export] {name}: one exported 1-clip call launched {got}; the "
            f"live call {want['live']}; derived {want['expect']} "
            f"({want['how']}); loaded in {report[name]['load_s']:.2f} s")
        require(not on_card or got == want["live"] == want["expect"],
                f"{name}: the exported call's launch counts are off")
        counts[name] = got
        for flags in ("default", "tf32"):
            gaps[f"{name}_{flags}"] = max(
                float(np.abs(answers[f"{name}/{flags}/{n}/{k}"] - v).max())
                for n, out in by_n.items() for k, v in out.items())
        unrepaired = max(float(np.abs(answers[f"{name}/unrepaired/2/{k}"]
                                      - v).max())
                         for k, v in by_n[2].items())
        log(f"[export] {name}: the artifact's posteriors of the 1-, 2- and "
            f"3-clip requests against the live Predictor.from_checkpoint's: "
            f"max |diff| {gaps[name + '_default']:.3g} with the default "
            f"flags, {gaps[name + '_tf32']:.3g} with cudnn.allow_tf32 = True "
            f"set (<= 1e-5); the program called without its IEEE f32 "
            f"context under TF32: {unrepaired:.3g} (not bounded)")
        require(max(gaps[name + "_default"], gaps[name + "_tf32"]) <= 1e-5,
                f"{name}: the artifact's posteriors differ from the live "
                f"Predictor's")
        numbers[name].update(gap_default=gaps[name + "_default"],
                             gap_tf32=gaps[name + "_tf32"],
                             gap_unrepaired=unrepaired)
    # 1-clip requests through the artifact and the live Predictor, in turns
    for name, (c, predictor, req) in cases.items():
        served = ExportedPredictor.load(str(tmp / f"{name}.pt2"), device=dev)
        graph = sorted(str(n.target) for n in served._module.graph.nodes
                       if str(n.target).startswith("din_tpu_torch."))
        keys = [k for k in ("images", "boxes", "bboxes_num") if k in req]
        one = [req[k][:1] for k in keys]
        times = {"live": [], "artifact": []}
        for route in ("live", "artifact", "artifact", "live") * 3:
            fn = predictor if route == "live" else served
            times[route] += (time_host(lambda: fn(*one), 1) if on_card
                             else [0.0])
        numbers[name].update({f"{k}_ms": float(np.median(v))
                              for k, v in times.items()})
        log(f"[export] {name}: the program's kernel ops "
            f"{dict(collections.Counter(graph))}; 1-clip requests, 6 each in "
            f"turns (host clock, synchronized): artifact median "
            f"{numbers[name]['artifact_ms']:.2f} ms (min "
            f"{min(times['artifact']):.2f}, max {max(times['artifact']):.2f}),"
            f" live median {numbers[name]['live_ms']:.2f} ms (min "
            f"{min(times['live']):.2f}, max {max(times['live']):.2f}) "
            f"[{smi}]")
        del served
    log(f"[export] done in {time.time() - t_all:.2f} s")
    return dict(counts={f"export_{k}": v for k, v in counts.items()},
                numbers=numbers)


def _train_snapshot(model, optimizer) -> dict:
    """CPU copies of a model's parameters, their Adam moments (by parameter
    name) and its dropout generators' states."""
    from din_tpu_torch.nn.layers import SeededDropout

    params = {n: p.detach().cpu().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    moments = {}
    for n, p in model.named_parameters():
        st = optimizer.state.get(p)
        if st:
            moments[n + ".exp_avg"] = st["exp_avg"].cpu().clone()
            moments[n + ".exp_avg_sq"] = st["exp_avg_sq"].cpu().clone()
    return dict(params=params, moments=moments,
                rng={n: m.get_rng_state() for n, m in model.named_modules()
                     if isinstance(m, SeededDropout)})


def _max_gap(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def training_infra_path(dev, tmp: Path, smi: str, reset_counts, read_counts,
                        shrink=lambda c: c, small=(144, 160)) -> dict:
    """Phase 15: the training infrastructure (see the module docstring).
    ``shrink`` sizes the flagship down and ``small`` is the card-against-
    CPU geometry, for a rehearsal on the CPU, where no kernel launches and
    the counts, times and card-against-CPU checks are not taken.  Returns
    the launch counts of each path and the measured numbers."""
    import os
    import signal

    from din_tpu_torch.data.loader import BatchLoader, to_device
    from din_tpu_torch.data.synthetic import (SyntheticDataset,
                                              make_synthetic_batch)
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.heads import tce
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.train import engine
    from din_tpu_torch.train.optim import make_optimizer

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cpu = torch.device("cpu")
    t_all = time.time()
    base = shrink(PRESETS["volleyball_stage2_dynamic"]().replace(
        data_path="synthetic", load_backbone_stage2=False,
        result_root=str(tmp)))
    T, lr = base.num_frames, base.train_learning_rate
    counts, numbers = {}, {}

    def expect(c, what, got, steps, eval_calls):
        want, how = derived_counts(c, steps, T, eval_calls, T)
        log(f"[infra] {what}: launches {got}, expected {want} ({how})")
        require(not on_card or got == want, f"{what}: launch counts are off")
        return want

    # -- a. gradient accumulation against the whole batch ----------------
    # The check runs both steps in 5-frame backbone chunks: by default a
    # 4-clip step takes 8-frame chunks and a 2-clip micro-step 5-frame
    # ones, and cuDNN's bf16 convolutions of other shapes round otherwise
    # (the timed default steps' gap is logged beside).
    t0 = time.time()
    acfg = base.replace(train_dropout_prob=0.0, batch_size=4)
    gen = torch.Generator().manual_seed(SEED + 151)
    start = build_model(acfg, device=dev, generator=gen)
    _randomize_din(start, gen)
    batch = to_device(make_synthetic_batch(
        acfg, 4, rng=np.random.RandomState(SEED + 152)), dev)
    runs = {}
    for name, c in (("bs4", acfg.replace(frame_chunk=5)),
                    ("accum", acfg.replace(frame_chunk=5,
                                           grad_accum_steps=2)),
                    ("bs4_default", acfg),
                    ("accum_default", acfg.replace(grad_accum_steps=2))):
        model = copy.deepcopy(start)
        model.cfg = c          # the trunk reads its chunks from the model's
        opt = make_optimizer(c, model)
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        m = engine.train_step(model, opt, batch, c)
        sync()
        launched = read_counts()
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        timed = on_card and name.endswith("_default")
        ms = time_host(lambda: engine.train_step(model, opt, batch, c), 3) \
            if timed else [0.0]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if timed \
            else 0.0
        runs[name] = dict(metrics={k: v.cpu() for k, v in m.items()},
                          state=state, counts=launched, ms=ms, peak=peak,
                          cfg=c)
        del model, opt, m
        if on_card:
            torch.cuda.empty_cache()
    del start, batch

    def loss_gap(x, y):
        lx, ly = float(x["metrics"]["loss"]), float(y["metrics"]["loss"])
        return abs(ly - lx) / abs(lx)

    a, b = runs["bs4"], runs["accum"]
    lerr = loss_gap(a, b)
    require(lerr <= 1e-5, f"accumulated loss {float(b['metrics']['loss'])} "
            f"against {float(a['metrics']['loss'])}")
    for k in ("activities_correct", "activities_total", "activities_conf"):
        require(torch.equal(a["metrics"][k], b["metrics"][k]),
                f"accumulated step's {k} differs")
    perr, share, share_name = check_params(b["state"], a["state"], (1,), lr,
                                           "accumulated vs whole batch")
    counts["accum"] = b["counts"]
    for name, steps, bs in (("bs4", 1, 4), ("accum", 2, 2),
                            ("bs4_default", 1, 4), ("accum_default", 2, 2)):
        expect(runs[name]["cfg"].replace(batch_size=bs), f"{name} step",
               runs[name]["counts"], steps, 0)
    da, db = runs["bs4_default"], runs["accum_default"]
    default_gap = loss_gap(da, db)
    numbers["accum"] = dict(
        loss_rel=lerr, param_gap=perr, share=share,
        default_chunks_loss_rel=default_gap,
        bs4_ms=float(np.mean(da["ms"][-2:])),
        accum_ms=float(np.mean(db["ms"][-2:])),
        bs4_gib=da["peak"], accum_gib=db["peak"])
    log(f"[infra] accumulation at full width ({acfg.image_size[0]}x"
        f"{acfg.image_size[1]}, T={T}, dropout 0, 5-frame chunks): one step "
        f"on 4 clips, once whole and once as "
        f"grad_accum_steps=2, from one state: loss "
        f"{float(a['metrics']['loss']):.7f} against "
        f"{float(b['metrics']['loss']):.7f} (rel {lerr:.3g} <= 1e-5), "
        f"counters and confusion equal; params max |diff| {perr:.3g} (<= "
        f"2 lr), largest share beyond 2e-5 {share:.4f} ({share_name or '-'})"
        f"; with the default chunks (8 frames whole, 5 per micro-step) the "
        f"losses differ by {default_gap:.3g} (reported)")
    log(f"[infra] accumulation, default chunks: 3 steps after the first "
        f"(host clock, synchronized, batch on the card): bs4 "
        f"{', '.join(f'{v:.1f}' for v in da['ms'])} ms, peak device memory "
        f"{da['peak']:.2f} GiB; grad_accum_steps=2 "
        f"{', '.join(f'{v:.1f}' for v in db['ms'])} ms, peak "
        f"{db['peak']:.2f} GiB [{smi}]")
    del runs
    log(f"[infra] accumulation done in {time.time() - t0:.2f} s")

    # -- b. preemption and auto-resume through train_net ------------------
    # A training step sums in a fixed order (the DIN head's gather backward,
    # cuDNN's deterministic algorithms), so the two uninterrupted runs are
    # bit-equal in losses, parameters and Adam moments, and so is the
    # resumed run: it starts from the file's model, Adam state and generator
    # bit for bit, the file's generator equals the uninterrupted run's after
    # step 2, the resumed steps take that run's batches 3 and 4, and the
    # generators end equal.  The gaps stay reported, and check_params'
    # bound of 2 lr per step (ulps=0) stays held.
    t0 = time.time()
    pcfg = base.replace(max_epoch=1)
    n_val = 2
    saved = {n: getattr(engine, n) for n in ("return_dataset", "train_step")}
    seen = {}

    def datasets(c):
        # an epoch of exactly 4 batches, so the resumed epoch trains the
        # two steps the interrupted one did not
        return (SyntheticDataset(c, size=4 * c.batch_size, is_training=True,
                                 seed=1),
                SyntheticDataset(c, size=n_val, is_training=False, seed=2))

    def recording(model, optimizer, batch, c):
        if not seen["losses"] and seen["on_start"] is not None:
            seen["on_start"](model, optimizer)
        seen["model"], seen["optimizer"] = model, optimizer
        seen["batches"].append(batch if seen["keep_batches"] else
                               {k: v.sum().item() for k, v in batch.items()})
        out = saved["train_step"](model, optimizer, batch, c)
        seen["losses"].append(float(out["loss"]))
        seen["rngs"].append(model.dropout_global.get_rng_state())
        if len(seen["losses"]) == seen["kill_at"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    def run(c, kill_at=None, on_start=None, keep_batches=False):
        seen.update(losses=[], rngs=[], batches=[], kill_at=kill_at,
                    on_start=on_start, keep_batches=keep_batches)
        engine.train_net(c, device=dev)
        snap = _train_snapshot(seen.pop("model"), seen.pop("optimizer"))
        snap.update(losses=seen["losses"], rngs=seen["rngs"],
                    batches=seen["batches"])
        if on_card:
            torch.cuda.empty_cache()
        return snap

    def same_batch(x, y):
        return sorted(x) == sorted(y) and all(torch.equal(x[k], y[k])
                                              for k in x)

    start_checks = {}

    def resumed_start(model, optimizer):
        """The resumed run before its first step against the file."""
        state = model.state_dict()
        start_checks["weights"] = all(
            torch.equal(state[k].cpu(), v)
            for k, v in payload["state_dict"].items())
        ostate = optimizer.state_dict()["state"]
        start_checks["adam"] = all(
            torch.equal(ostate[i][k].cpu(), v)
            for i, st in payload["optimizer"]["state"].items()
            for k, v in st.items())
        start_checks["generator"] = torch.equal(
            model.dropout_global.get_rng_state(),
            payload["dropout_rng"]["dropout_global"])

    engine.return_dataset, engine.train_step = datasets, recording
    try:
        u1 = run(pcfg.replace(exp_name="u1"), keep_batches=True)
        u2 = run(pcfg.replace(exp_name="u2"))
        p = run(pcfg.replace(exp_name="p"), kill_at=2)
        require(len(u1["losses"]) == len(u2["losses"]) == 4
                and len(p["losses"]) == 2,
                f"steps: {len(u1['losses'])}, {len(u2['losses'])}, the "
                f"preempted run {len(p['losses'])}")
        pre = tmp / "p" / "stage2_epoch0_preempt.pth"
        files = sorted(f.name for f in (tmp / "p").glob("*.pth"))
        require(files == [pre.name], f"after SIGTERM: {files}")
        payload = torch.load(pre, map_location="cpu", weights_only=True)
        require(payload["epoch"] == 0 and payload["step"] == 2,
                f"preempt file: epoch {payload['epoch']}, step "
                f"{payload['step']}")
        require(torch.equal(payload["dropout_rng"]["dropout_global"],
                            u1["rngs"][1]),
                "the file's generator state is not the uninterrupted run's "
                "after step 2")
        plog = (tmp / "p" / "log.txt").read_text()
        require("preemption: state saved to" in plog
                and "Train at epoch" not in plog,
                "the preempted run's log lacks the save or reported an epoch")
        reset_counts()
        tt = time.time()
        res = run(pcfg.replace(exp_name="p", auto_resume=True),
                  on_start=resumed_start, keep_batches=True)
        sync()
        resume_s = time.time() - tt
        counts["resume"] = read_counts()
    finally:
        for n, fn in saved.items():
            setattr(engine, n, fn)
    require(len(res["losses"]) == 2, f"the resumed run took "
            f"{len(res['losses'])} steps")
    require("resuming at epoch 1, step 2" in (tmp / "p" / "log.txt")
            .read_text(), "the resumed run's log lacks 'resuming at epoch 1, "
            "step 2'")
    require(start_checks == dict(weights=True, adam=True, generator=True),
            f"the resumed run did not start from the file: {start_checks}")
    require(all(same_batch(x, y) for x, y in zip(res["batches"],
                                                 u1["batches"][2:])),
            "the resumed steps did not take the epoch's batches 3 and 4")
    require(all(torch.equal(res["rng"][k], u1["rng"][k]) for k in u1["rng"]),
            "the resumed run's dropout generators end elsewhere")
    expect(pcfg, "resumed run (2 steps and an eval)", counts["resume"], 2,
           -(-n_val // pcfg.test_batch_size))
    gaps = {}
    for what, r, losses in (("resumed", res, u1["losses"][2:]),
                            ("uninterrupted", u2, u1["losses"])):
        differ = [k for part in ("params", "moments") for k in u1[part]
                  if not torch.equal(r[part][k], u1[part][k])]
        require(r["losses"] == losses and not differ,
                f"the {what} run is not bit-equal to the first "
                f"uninterrupted run: losses {r['losses']} against {losses}, "
                f"{len(differ)} tensors differ {differ[:4]}")
        pe, ps, pn = check_params(r["params"], u1["params"], range(1, 5), lr,
                                  f"{what} vs uninterrupted, params",
                                  share_bound=None)
        rel = {k: float((r["moments"][k] - v).abs().max())
               / max(float(v.abs().max()), 1e-30)
               for k, v in u1["moments"].items()}
        worst = max(rel, key=rel.get)
        gaps[what] = dict(
            param=pe, share=ps, share_name=pn,
            moment=_max_gap(r["moments"], u1["moments"]),
            moment_rel=rel[worst], moment_name=worst,
            loss=max(abs(x - y) / abs(y) for x, y in zip(
                r["losses"][-2:], u1["losses"][2:])))
    numbers["resume"] = dict(gaps=gaps, resume_s=resume_s)
    log(f"[infra] preemption: train_net of the flagship at full width, "
        f"dropout {pcfg.train_dropout_prob}, an epoch of 4 batches of "
        f"{pcfg.batch_size}; a real SIGTERM after step 2 left {pre.name} "
        f"(epoch 0, step 2, the generator state of the uninterrupted run "
        f"after step 2) and the log line; --auto-resume logged 'resuming at "
        f"epoch 1, step 2', started from the file's weights, Adam state and "
        f"generator bit for bit, trained steps 3 and 4 on the uninterrupted "
        f"run's batches 3 and 4 and the eval in {resume_s:.2f} s; the "
        f"generators end equal")
    for what, g in gaps.items():
        log(f"[infra] {what} against the first uninterrupted run after 4 "
            f"steps: bit-equal in losses, parameters and Adam moments; "
            f"losses of steps 3, 4 rel {g['loss']:.3g}; params max "
            f"|diff| {g['param']:.3g} (<= 8 lr), largest share beyond 2e-5 "
            f"{g['share']:.4f} ({g['share_name'] or '-'}); Adam moments max "
            f"|diff| {g['moment']:.3g}, at most {g['moment_rel']:.3g} of a "
            f"tensor's largest |value| ({g['moment_name']}; reported)")
    log(f"[infra] losses: resumed {[round(v, 6) for v in res['losses']]}, "
        f"uninterrupted {[round(v, 6) for v in u1['losses']]} and "
        f"{[round(v, 6) for v in u2['losses']]}, preempted "
        f"{[round(v, 6) for v in p['losses']]}")
    del u1, u2, p, res, payload
    two_steps_bit_equal(shrink(PRESETS["collective_stage2_dynamic"]().replace(
        load_backbone_stage2=False, data_path="synthetic")), dev, SEED + 159,
        "[infra] collective stage 2")
    log(f"[infra] preemption done in {time.time() - t0:.2f} s")

    # -- c. MAD ------------------------------------------------------------
    t0 = time.time()
    scfg = base.replace(image_size=small, out_size=(4, 5), num_frames=3,
                        compute_dtype="float32", train_dropout_prob=0.0,
                        measure_mad=True, test_batch_size=2)
    gen = torch.Generator().manual_seed(SEED + 153)
    cpu_model = build_model(scfg, device="cpu", generator=gen)
    _randomize_din(cpu_model, gen)
    sval = list(BatchLoader(SyntheticDataset(scfg, size=3, is_training=False,
                                             seed=SEED + 154), 2,
                            shuffle=False, drop_last=False, pad_last=True))
    mad_cpu = engine.run_eval(cpu_model, sval, scfg, 1, cpu)["MAD"]
    mad_rel = 0.0
    if on_card:
        with no_tf32():
            mad_card = engine.run_eval(copy.deepcopy(cpu_model).to(dev), sval,
                                       scfg, 1, dev)["MAD"]
        mad_rel = abs(mad_card - mad_cpu) / abs(mad_cpu)
        require(mad_rel <= 1e-5, f"MAD card {mad_card} against CPU {mad_cpu}")
        log(f"[infra] MAD card against CPU, eval of 3 clips (one padded) at "
            f"{small[0]}x{small[1]}, T=3, f32 (TF32 off): {mad_card:.8f} "
            f"against {mad_cpu:.8f} (rel {mad_rel:.3g} <= 1e-5)")
    del cpu_model
    fcfg = base.replace(measure_mad=True)
    gen = torch.Generator().manual_seed(SEED + 155)
    model = build_model(fcfg, device=dev, generator=gen)
    _randomize_din(model, gen)
    fval = list(BatchLoader(SyntheticDataset(fcfg, size=4, is_training=False,
                                             seed=SEED + 156),
                            fcfg.test_batch_size, shuffle=False,
                            drop_last=False, pad_last=True))
    times = {"mad": [], "plain": []}
    mad_counts = {}
    engine.run_eval(model, fval, fcfg.replace(measure_mad=False), 1, dev)
    for route in ("plain", "mad", "mad", "plain"):
        c = fcfg if route == "mad" else fcfg.replace(measure_mad=False)
        sync()
        reset_counts()
        tt = time.perf_counter()
        info = engine.run_eval(model, fval, c, 1, dev)
        sync()
        times[route].append((time.perf_counter() - tt) * 1e3)
        mad_counts[route] = read_counts()
        if route == "mad":
            mad = info["MAD"]
            require(math.isfinite(mad) and 0 <= mad <= 2, f"MAD {mad}")
    counts["mad"] = mad_counts["mad"]
    require(mad_counts["mad"] == mad_counts["plain"],
            f"the MAD eval launched {mad_counts['mad']}, the plain one "
            f"{mad_counts['plain']}")
    expect(fcfg, "eval pass with measure_mad (one forward per batch)",
           counts["mad"], 0, len(fval))
    numbers["mad"] = dict(value=mad, card_vs_cpu_rel=mad_rel,
                          mad_ms=float(np.mean(times["mad"])),
                          plain_ms=float(np.mean(times["plain"])))
    log(f"[infra] MAD at full width: {mad:.6f} over an eval of {len(fval)} "
        f"clips (DIN offsets random); eval pass with measure_mad "
        f"{', '.join(f'{v:.1f}' for v in times['mad'])} ms, without "
        f"{', '.join(f'{v:.1f}' for v in times['plain'])} ms (host clock, "
        f"in turns, batches made beforehand) [{smi}]")
    del model, fval
    if on_card:
        torch.cuda.empty_cache()
    log(f"[infra] MAD done in {time.time() - t0:.2f} s")

    # -- d. pruning, metrics.jsonl, experiments.json, the profiler --------
    t0 = time.time()
    prof = tmp / "profile"
    hcfg = base.replace(exp_name="h", max_epoch=3, keep_checkpoints=1,
                        profile_dir=str(prof))
    # run again from nothing, up to 3 runs in all, while the profiler's
    # trace holds no kernel of any kind (a trace on the card has once come
    # back without one); a trace with kernels but not the port's fails below
    for attempt in range(3):
        for old in (prof, tmp / "h"):
            shutil.rmtree(old, ignore_errors=True)
        engine.return_dataset = datasets
        try:
            reset_counts()
            engine.train_net(hcfg, max_steps_per_epoch=1, device=dev)
            sync()
            counts["housekeeping"] = read_counts()
        finally:
            engine.return_dataset = saved["return_dataset"]
        traces = sorted(prof.glob("*.json"))
        require(len(traces) == 1, f"profile_dir holds {traces}")
        text = traces[0].read_text()
        if not on_card or re.search(r'"cat":\s*"kernel"', text):
            break
        log(f"[infra] run {attempt + 1} of 3: train_net's trace holds no "
            f"kernel")
    expect(hcfg, "3 epochs of 1 step, 3 evals", counts["housekeeping"], 3,
           3 * -(-n_val // hcfg.test_batch_size))
    hlog = (tmp / "h" / "log.txt").read_text()
    accs = {}
    for line in hlog.splitlines():
        if line.startswith("model saved to: "):
            name = Path(line.split(": ", 1)[1].strip()).name
            accs[name] = (float(name.split("_")[2][:-5]),
                          int(name.split("epoch")[1].split("_")[0]))
    keep = {max(accs, key=lambda f: accs[f][1]),
            max(accs, key=lambda f: accs[f])}
    left = {f.name for f in (tmp / "h").glob("*.pth")}
    require(len(accs) == 3 and left == keep,
            f"keep_checkpoints=1 left {sorted(left)} of {sorted(accs)}; the "
            f"rule names {sorted(keep)}")
    recs = [json.loads(x) for x in
            (tmp / "h" / "metrics.jsonl").read_text().splitlines()]
    require([r["phase"] for r in recs] == ["Train", "Test"] * 3,
            f"metrics.jsonl phases {[r['phase'] for r in recs]}")
    db = json.loads((tmp / "experiments.json").read_text())
    require("h" in db and "activities_acc" in db["h"]["best_result"],
            f"experiments.json: {sorted(db)}")
    symbols = ("roi_align_kernel", "roi_align_bwd_kernel",
               "max_pool_2x2_kernel", "max_pool_2x2_bwd_kernel")
    missing = [s for s in symbols if s not in text]
    require(not on_card or not missing,
            f"the trace names no {missing}")
    log(f"[infra] keep_checkpoints=1 over 3 epochs left {sorted(left)} (the "
        f"newest and the best accuracy's, as prune_checkpoints' rule names; "
        f"saved {sorted(accs)}); metrics.jsonl {len(recs)} records "
        f"(Train, Test per epoch); experiments.json holds 'h'; profile_dir "
        f"trace {traces[0].name} ({traces[0].stat().st_size / 2 ** 20:.1f} "
        f"MiB) names {[s for s in symbols if s in text]}")
    log(f"[infra] housekeeping done in {time.time() - t0:.2f} s")

    # -- e. the raw-RoI TCE pieces, card against CPU ----------------------
    t0 = time.time()
    gen = torch.Generator().manual_seed(SEED + 157)
    rng = np.random.RandomState(SEED + 158)
    B, N, K, D = 2, 12, 5, 512
    roi = torch.from_numpy(rng.randn(B * T, N, K, K, D).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(B * T, 45, 80, 256).astype(np.float32))
    feats = torch.from_numpy(rng.randn(B * T, N, 1024).astype(np.float32))
    xy = rng.uniform(0, 70, (B, T * N, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(2, 10, (B, T * N, 2))], -1).astype(np.float32))
    raw = tce.MultiHeadLayerContextEncoding(
        D, 256, gen, num_heads=2, num_layers=2, num_features_context=256,
        crop_size=K).eval()
    bil = tce.MultiHeadSTBilinear(1024, 256, 2, gen, T=T).eval()

    def pieces(device, dtype=torch.float32):
        with torch.no_grad():
            mask = tce.generate_spatial_mask(boxes.to(device), 0.3, 45)
            return dict(
                raw=raw.to(device, dtype)(roi.to(device, dtype),
                                          ctx.to(device, dtype)).cpu(),
                bilinear=bil.to(device, dtype)(feats.to(device, dtype),
                                               mask).cpu(),
                mask=mask.cpu())

    # The attention over 3600 cells is peaked (logits of ~16 std), so f32
    # summation order alone moves the output by ~1e-4 of its largest
    # value: the card is held to the CPU's own distance from a float64 run
    # (at most twice it, or 1e-5 of max |y|), the card-CPU gap reported.
    f64 = pieces(cpu, torch.float64)
    want = pieces(cpu)
    tce_err = {}
    if on_card:
        with no_tf32():
            got = pieces(dev)
        require(torch.equal(got["mask"], want["mask"])
                and torch.equal(f64["mask"], want["mask"]),
                "generate_spatial_mask differs on the card or in float64")
        for k in ("raw", "bilinear"):
            scale = float(f64[k].abs().max())
            tce_err[k] = {
                "card_cpu": float((got[k] - want[k]).abs().max()) / scale,
                "card_f64": float((got[k].double() - f64[k]).abs().max())
                / scale,
                "cpu_f64": float((want[k].double() - f64[k]).abs().max())
                / scale}
            e = tce_err[k]
            require(e["card_f64"] <= max(2 * e["cpu_f64"], 1e-5),
                    f"{k}: the card is {e['card_f64']:.3g} of max |y| from "
                    f"float64, the CPU {e['cpu_f64']:.3g}")
        log(f"[infra] raw-RoI TCE (2 heads x 2 layers, NFC 256, crops "
            f"[{B * T},{N},{K},{K},{D}] over the [{B * T},45,80,256] context) "
            f"and the bilinear attention (2 heads over {T * N} tokens of "
            f"1024, distance mask of {float(want['mask'].float().mean()):.3f}"
            f" suppressed), f32 (TF32 off), distance from a float64 CPU run "
            f"in units of its max |y|: card "
            f"{tce_err['raw']['card_f64']:.3g} and "
            f"{tce_err['bilinear']['card_f64']:.3g}, CPU "
            f"{tce_err['raw']['cpu_f64']:.3g} and "
            f"{tce_err['bilinear']['cpu_f64']:.3g} (card <= max(2 x CPU, "
            f"1e-5)); card against CPU {tce_err['raw']['card_cpu']:.3g} and "
            f"{tce_err['bilinear']['card_cpu']:.3g} (reported); masks equal")
    numbers["tce"] = tce_err
    log(f"[infra] raw-RoI TCE done in {time.time() - t0:.2f} s")
    log(f"[infra] done in {time.time() - t_all:.2f} s")
    return dict(counts={f"infra_{k}": v for k, v in counts.items()},
                numbers=numbers)


# -- phase 16: more than one rank ------------------------------------------

def kernel_wrappers() -> dict:
    """The five kernels' wrappers; ``launches`` counts one process's."""
    from din_tpu_torch.ops.pool import max_pool_2x2, max_pool_2x2_bwd
    from din_tpu_torch.ops.roi_align import roi_align, roi_align_bwd
    from din_tpu_torch.ops.stem import fused_stem
    return {"roi_align": roi_align, "max_pool_2x2": max_pool_2x2,
            "max_pool_2x2_bwd": max_pool_2x2_bwd,
            "roi_align_bwd": roi_align_bwd, "fused_stem": fused_stem}


def _reset_launches() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def _read_launches() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ranks_configs(tmp, small: dict):
    """Phase 16's flagship and collective configs: synthetic clips, random
    weights, 2 clips a rank, 2 eval clips a call; ``small`` shrinks them
    for a rehearsal on the CPU."""
    from din_tpu_torch.experiments.presets import PRESETS

    common = dict(data_path="synthetic", load_backbone_stage2=False,
                  result_root=str(tmp), batch_size=2, test_batch_size=2,
                  num_workers=2, max_epoch=1)
    flag = PRESETS["volleyball_stage2_dynamic"]().replace(**common, **small)
    coll = PRESETS["collective_stage2_dynamic"]().replace(
        **common, **{k: v for k, v in small.items() if k != "lite_dim"})
    return flag, coll


def ranks_datasets(cfg):
    """8 training clips (2 steps of 2 clips on each of 2 ranks) and 4 eval
    clips."""
    from din_tpu_torch.data.synthetic import SyntheticDataset
    return (SyntheticDataset(cfg, size=8, is_training=True, seed=1),
            SyntheticDataset(cfg, size=4, is_training=False, seed=2))


def _cpu_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _rank_step(cfg, state, batch, mesh, dev):
    """One ``train_step`` of this rank's clips of ``batch`` from ``state``
    under ``mesh``: (model, optimizer, the model it stepped (DDP), metrics,
    launches, the local batch)."""
    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.parallel.mesh import use_mesh
    from din_tpu_torch.train import engine
    from din_tpu_torch.train.optim import make_optimizer

    model = build_model(cfg, device=dev)
    model.load_state_dict(state)
    if mesh.data_index:
        engine.seed_dropouts_for_rank(model, mesh.data_index)
    opt = make_optimizer(cfg, model, mesh)
    wrapped = engine.wrap_model(model, mesh)
    n, d = cfg.batch_size, mesh.data_index
    local = to_device({k: v[d * n:(d + 1) * n] for k, v in batch.items()},
                      dev)
    _sync(dev)
    _reset_launches()
    with use_mesh(mesh):
        m = engine.train_step(wrapped, opt, local, cfg)
    _sync(dev)
    return model, opt, wrapped, m, _read_launches(), local


def _same_on_ranks(model, mesh, what: str) -> None:
    """Every rank holds rank 0's parameters and buffers, bit for bit."""
    import torch.distributed as dist

    for k, v in model.state_dict().items():
        ref = v.detach().clone()
        dist.broadcast(ref, 0)
        require(torch.equal(ref, v), f"{what}: {k} differs between ranks")


def _bit_equal(a: dict, b: dict, what: str) -> None:
    for k, v in a.items():
        require(torch.equal(v, b[k]), f"{what}: {k} differs")


def _adam_bytes(opt) -> int:
    local = getattr(opt, "optim", opt)
    return sum(v.numel() * v.element_size() for s in local.state.values()
               for k, v in s.items() if k in ("exp_avg", "exp_avg_sq"))


def _train_net_runs(cfg, dev, kill=False, **kw) -> dict:
    """``train_net`` of ``cfg`` over ``ranks_datasets`` on this rank: an
    uninterrupted run and, with ``kill``, a run that rank 1 stops by
    SIGTERM after its first step, then its auto-resume.  Per run: steps
    taken, launches, the final state and Adam state."""
    import os
    import signal

    import torch.distributed as dist

    from din_tpu_torch.train import engine

    rank = dist.get_rank()
    engine.return_dataset = ranks_datasets
    seen = {"n": 0, "kill_at": None}
    step = engine.train_step

    def recording(model, optimizer, batch, c):
        seen["model"] = getattr(model, "module", model)
        seen["optimizer"] = optimizer
        out = step(model, optimizer, batch, c)
        seen["n"] += 1
        if seen["n"] == seen["kill_at"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    def run(name, kill_at=None, **more):
        seen["n"], seen["kill_at"] = 0, kill_at
        _sync(dev)
        _reset_launches()
        best = engine.train_net(cfg.replace(exp_name=name, **more),
                                device=dev, **kw)
        _sync(dev)
        return {"best": {k: v for k, v in best.items()
                         if not hasattr(v, "shape")},
                "steps": seen["n"], "launches": _read_launches(),
                "state": _cpu_state(seen["model"]),
                "optimizer": seen["optimizer"].state_dict()}

    engine.train_step = recording
    try:
        out = {"whole": run("whole")}
        if kill:
            out["cut"] = run("cut", kill_at=1 if rank == 1 else None)
            out["resumed"] = run("cut", auto_resume=True)
    finally:
        engine.train_step = step
    return out


def ranks_world1(tmp: str, small: dict, dev: str) -> dict:
    """Phase 16 (a), in a rank of a run of one (NCCL on the card): one
    flagship step of 2 clips through ``DistributedDataParallel`` (the
    port's summing hook) against the plain step from the same state,
    dropout on; then ``train_net``, 3 steps at batch 2 and an eval
    pass."""
    import torch.distributed as dist

    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.train import engine
    from din_tpu_torch.train.optim import make_optimizer

    dev = torch.device(dev)
    flag, _ = ranks_configs(tmp, small)
    inputs = torch.load(Path(tmp) / "ranks_inputs.pt", weights_only=False)
    batch = to_device({k: v[:2] for k, v in inputs["flag_batch"].items()},
                      dev)
    states, losses = {}, {}
    for name in ("plain", "ddp"):
        model = build_model(flag, device=dev)
        model.load_state_dict(inputs["flag_state"])
        opt = make_optimizer(flag, model)
        stepped = model
        if name == "ddp":
            stepped = torch.nn.parallel.DistributedDataParallel(
                model, device_ids=[dev.index] if dev.type == "cuda" else None,
                broadcast_buffers=False)
            stepped.register_comm_hook((dist.group.WORLD, 1),
                                       engine.sum_gradients_hook)
        losses[name] = float(engine.train_step(stepped, opt, batch,
                                               flag)["loss"])
        states[name] = _cpu_state(model)
        del model, opt, stepped
    _bit_equal(states["ddp"], states["plain"], "world-1 DDP step")
    require(losses["ddp"] == losses["plain"], "world-1 DDP loss")
    run = _train_net_runs(flag, dev, max_steps_per_epoch=3)["whole"]
    return {"loss": losses["plain"], "steps": run["steps"],
            "launches": run["launches"], "backend": dist.get_backend(),
            "best": run["best"]}


def ranks_world2(tmp: str, small: dict, dev: str) -> dict:
    """Phase 16 (b)-(g) on each of two ranks (gloo; both on one card):
    see ``ranks_path``."""
    import torch.distributed as dist

    from din_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from din_tpu_torch.train import engine

    dev = torch.device(dev)
    rank = dist.get_rank()
    flag, coll = ranks_configs(tmp, small)
    inputs = torch.load(Path(tmp) / "ranks_inputs.pt", weights_only=False)
    fstate, fbatch = inputs["flag_state"], inputs["flag_batch"]
    out = {"launches": {}, "loss": {}}

    def keep(name, model, loss, launches):
        out["loss"][name] = loss
        out["launches"][name] = launches
        if rank == 0:
            out.setdefault("state", {})[name] = _cpu_state(model)

    # (b) the data-parallel flagship step, 5-frame chunks, dropout 0
    cb = flag.replace(frame_chunk=5, train_dropout_prob=0.0)
    mesh = make_mesh(cb)
    model, _, _, m, launched, _ = _rank_step(cb, fstate, fbatch, mesh, dev)
    _same_on_ranks(model, mesh, "(b) step")
    keep("dp_step", model, float(m["loss"]), launched)
    del model
    # at the default chunks: the loss, and each rank's step time (both
    # ranks step together on one card)
    cd = flag.replace(train_dropout_prob=0.0)
    model, opt, wrapped, m, _, local = _rank_step(cd, fstate, fbatch, mesh,
                                                  dev)
    out["loss"]["dp_default"] = float(m["loss"])
    times = []
    with use_mesh(mesh):
        for _ in range(4):
            mesh.barrier()
            _sync(dev)
            t = time.perf_counter()
            engine.train_step(wrapped, opt, local, cd)
            _sync(dev)
            times.append((time.perf_counter() - t) * 1e3)
    out["step_ms"] = times[1:]
    del model, opt, wrapped
    # dropout on: two runs from one state are bit-equal, and so is ZeRO-1
    runs = {}
    for name, c in (("first", flag), ("second", flag),
                    ("zero", flag.replace(shard_opt_state=True))):
        model, opt = _rank_step(c, fstate, fbatch, mesh, dev)[:2]
        runs[name] = (_cpu_state(model), _adam_bytes(opt))
        del model, opt
    _bit_equal(runs["second"][0], runs["first"][0],
               "(b) two steps with dropout")
    _bit_equal(runs["zero"][0], runs["first"][0], "(b) ZeRO-1 step")
    out["adam_bytes"] = {"zero": runs["zero"][1],
                         "replicated": runs["first"][1]}
    del runs
    # (c) the collective ResNet-18 (live BatchNorm), 5-frame chunks
    cc = coll.replace(frame_chunk=5, train_dropout_prob=0.0)
    cmesh = make_mesh(cc)
    model, _, _, m, launched, _ = _rank_step(
        cc, inputs["coll_state"], inputs["coll_batch"], cmesh, dev)
    _same_on_ranks(model, cmesh, "(c) step")
    keep("collective", model, float(m["loss"]), launched)
    del model
    # (d) frame parallel: one data group of 2 clips, its frames split
    fp = cd.replace(mesh_shape={"data": 1, "model": 2}, frame_parallel=True)
    fmesh = make_mesh(fp)
    model, _, _, m, launched, _ = _rank_step(fp, fstate, fbatch, fmesh, dev)
    _same_on_ranks(model, fmesh, "(d) step")
    keep("frame_parallel", model, float(m["loss"]), launched)
    del model
    # (e) train_net: SIGTERM to rank 1 alone, the resume against a whole run
    runs = _train_net_runs(flag, dev, kill=True)
    whole, resumed = runs["whole"], runs["resumed"]
    _bit_equal(resumed["state"], whole["state"], "(e) resumed run")
    for i, s in whole["optimizer"]["state"].items():
        _bit_equal(resumed["optimizer"]["state"][i], s, f"(e) Adam {i}")
    out["train_net"] = {k: {"steps": r["steps"], "launches": r["launches"]}
                        for k, r in runs.items()}
    if rank == 0:
        out["preempt_files"] = sorted(
            p.name for p in (Path(tmp) / "cut").glob("*_preempt.pth"))
    return out


def plan_calls(c, n_frames: int, ranks, train: bool) -> tuple:
    """(backbone calls, frames per call) of one rank's ``n_frames`` under
    ``models/trunk.py`` ``FramePlan`` with ``ranks`` = (frame ranks, model
    ranks)."""
    from types import SimpleNamespace

    from din_tpu_torch.models.trunk import FramePlan
    from din_tpu_torch.nn.backbones import BACKBONE_HAS_BN

    P, M = ranks
    mesh = SimpleNamespace(model=M, frame_parallel=M > 1, model_index=0,
                           frame_size=P, frame_index=0, frame_group=None,
                           model_group=None)
    H, W = c.image_size
    plan = FramePlan(mesh, n_frames, H, W, c.frame_chunk, c.train_backbone,
                     train and not c.set_bn_eval
                     and BACKBONE_HAS_BN.get(c.backbone, True),
                     c.shard_local_chunks)
    return len(plan.rounds), (plan.stop - plan.start) // len(plan.rounds)


def ranks_path(dev, tmp: Path, smi: str, small=None) -> dict:
    """Phase 16: training on more than one rank (see the module docstring).
    ``small`` shrinks the configs for a rehearsal on the CPU, where no
    kernel launches and the counts and times are not checked.  Returns the
    launch counts of each path and the measured numbers."""
    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.models.trunk import auto_chunk
    from din_tpu_torch.parallel.launch import run_ranks
    from din_tpu_torch.train.engine import train_step
    from din_tpu_torch.train.optim import make_optimizer

    on_card = dev.type == "cuda"
    small = small or {}
    t_all = time.time()
    if on_card:
        log(f"[ranks] this process holds "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the card "
            f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved)")
    flag, coll = ranks_configs(tmp, small)
    T, lr = flag.num_frames, flag.train_learning_rate
    inputs = {}
    for name, c, seed in (("flag", flag, SEED + 161),
                          ("coll", coll, SEED + 163)):
        gen = torch.Generator().manual_seed(seed)
        model = build_model(c, device="cpu", generator=gen)
        _randomize_din(model, gen)
        inputs[name + "_state"] = model.state_dict()
        inputs[name + "_batch"] = make_synthetic_batch(
            c, 4, rng=np.random.RandomState(seed + 1))
    torch.save(inputs, tmp / "ranks_inputs.pt")

    # one process, the same 4 clips (2 for the frame-parallel group)
    ref = {}
    for name, c, state, clips in (
            ("dp_step", flag.replace(frame_chunk=5, train_dropout_prob=0.0),
             "flag", 4),
            ("dp_default", flag.replace(train_dropout_prob=0.0), "flag", 4),
            ("frame_parallel", flag.replace(train_dropout_prob=0.0), "flag",
             2),
            ("collective", coll.replace(frame_chunk=5,
                                        train_dropout_prob=0.0), "coll",
             4)):
        c = c.replace(batch_size=clips)
        model = build_model(c, device=dev)
        model.load_state_dict(inputs[state + "_state"])
        opt = make_optimizer(c, model)
        batch = to_device({k: v[:clips] for k, v in
                           inputs[state + "_batch"].items()}, dev)
        ref[name] = {"loss": float(train_step(model, opt, batch, c)["loss"]),
                     "state": _cpu_state(model)}
        if name == "dp_default" and on_card:
            ref[name]["ms"] = time_host(
                lambda: train_step(model, opt, batch, c), 4)[1:]
        del model, opt, batch
    if on_card:
        torch.cuda.empty_cache()
    log(f"[ranks] one-process references in {time.time() - t_all:.2f} s")

    t0 = time.time()
    backend = "nccl" if on_card else "gloo"
    one = run_ranks("chip_smoke.py:ranks_world1", 1,
                    {"tmp": str(tmp), "small": small,
                     "dev": "cuda:0" if on_card else "cpu"},
                    device="cuda:0" if on_card else "cpu", backend=backend,
                    timeout=400, init_timeout=120, threads=2,
                    workdir=str(tmp / "world1"))[0]
    log(f"[ranks] (a) one rank over {one['backend']}: a DDP step (the "
        f"port's summing hook) bit-equal to the plain step from one state, "
        f"dropout on (loss {one['loss']!r}); train_net took {one['steps']} "
        f"steps and an eval pass ({time.time() - t0:.2f} s)")
    want, how = derived_counts(flag, 3, T, 2, T)
    log(f"[ranks] (a) launches {one['launches']}, expected {want} ({how})")
    require(not on_card or one["launches"] == want,
            "(a) launch counts are off")
    require(one["steps"] == 3, "(a) train_net did not take 3 steps")

    t0 = time.time()
    two = run_ranks("chip_smoke.py:ranks_world2", 2,
                    {"tmp": str(tmp), "small": small,
                     "dev": "cuda:0" if on_card else "cpu"},
                    device="cuda:0" if on_card else "cpu", backend="gloo",
                    timeout=600, init_timeout=120, threads=2,
                    workdir=str(tmp / "world2"))
    log(f"[ranks] two gloo ranks on one {'card' if on_card else 'CPU'}: "
        f"{time.time() - t0:.2f} s")
    numbers = {"world1_loss": one["loss"]}
    counts = {"ranks_world1_train_net": one["launches"]}
    r0 = two[0]
    for name, what, ulps in (("dp_step", "(b) the data-parallel step of 2 "
                              "ranks x 2 clips against one process's 4, "
                              "5-frame chunks", 0),
                             ("frame_parallel", "(d) frame parallel, one "
                              "data group of 2 clips over 2 model ranks, "
                              "against one process's 2 clips", 0),
                             ("collective", "(c) the collective ResNet-18 "
                              "(live BatchNorm) of 2 ranks x 2 clips, "
                              "5-frame chunks", 2)):
        loss = r0["loss"][name] if name == "frame_parallel" else \
            sum(r["loss"][name] for r in two)
        want_loss = ref[name]["loss"]
        rel = abs(loss - want_loss) / abs(want_loss)
        require(rel <= 1e-5, f"{what}: loss {loss} against {want_loss}")
        got, want_state = r0["state"][name], dict(ref[name]["state"])
        stats_err = 0.0
        for k in [k for k in want_state
                  if k.endswith(("running_mean", "running_var"))]:
            v = want_state.pop(k).float()
            diff = float((got[k].float() - v).abs().max())
            scale = max(float(v.abs().max()), 1e-30)
            require(diff <= 1e-4 * scale, f"{what}: {k} differs by {diff}")
            stats_err = max(stats_err, diff / scale)
        perr, share, sname = check_params(got, want_state, (1,), lr, what,
                                          ulps=ulps)
        log(f"[ranks] {what}: loss {loss!r} against {want_loss!r} (rel "
            f"{rel:.3g}); parameters max |diff| {perr:.3g}, largest share "
            f"beyond 2e-5 {share:.4f} ({sname or '-'}), BatchNorm "
            f"statistics {stats_err:.3g} of their largest |value| (bound "
            f"1e-4); every rank equal")
        numbers[name] = {"loss": loss, "one_process_loss": want_loss,
                         "rel": rel, "max_param_diff": perr,
                         "stats_rel": stats_err}
    gap = abs(sum(r["loss"]["dp_default"] for r in two)
              - ref["dp_default"]["loss"]) / abs(ref["dp_default"]["loss"])
    numbers["dp_default_rel"] = gap
    H, W = flag.image_size
    calls, per = plan_calls(flag, 2 * T, (2, 1), True)
    log(f"[ranks] (b) at the default chunks (one process: "
        f"{auto_chunk(4 * T, H, W, None, True)}-frame chunks; each rank: "
        f"{calls} calls of {per} frames) the losses part by {gap:.3g} "
        f"(relative; reported: cuDNN's bf16 convolutions of other shapes "
        f"round otherwise)")
    ab = [r["adam_bytes"] for r in two]
    numbers["adam_bytes"] = ab
    require(ab[0]["zero"] + ab[1]["zero"] == ab[0]["replicated"],
            "(b) ZeRO-1's shards do not add up to the Adam state")
    log(f"[ranks] (b) two runs with dropout on bit-equal; ZeRO-1 bit-equal "
        f"to replicated DDP; Adam bytes per rank: ZeRO-1 "
        f"{[a['zero'] for a in ab]}, replicated {ab[0]['replicated']}")
    tn = [r["train_net"] for r in two]
    require(all(t["cut"]["steps"] == 1 and t["resumed"]["steps"] == 1
                for t in tn), f"(e) steps of the cut and resumed runs: {tn}")
    require(r0["preempt_files"] == ["stage2_epoch0_preempt.pth"],
            f"(e) preemption files {r0['preempt_files']}")
    log(f"[ranks] (e) train_net on 2 ranks: SIGTERM to rank 1 after its "
        f"first step stopped both ranks there "
        f"({[t['cut']['steps'] for t in tn]} steps), one "
        f"{r0['preempt_files'][0]}; the resumed run bit-equal to the "
        f"uninterrupted one (parameters, Adam state), each rank")
    # (f) each rank's launches against the per-rank derived counts
    for name, c, steps, evals, ranks in (
            ("dp_step", flag.replace(frame_chunk=5), 1, 0, (2, 1)),
            ("collective", coll.replace(frame_chunk=5), 1, 0, (2, 1)),
            ("frame_parallel", flag, 1, 0, (2, 2))):
        want, how = derived_counts(c, steps, T, evals, T, ranks=ranks)
        for i, r in enumerate(two):
            got = r["launches"][name]
            counts[f"ranks_{name}_r{i}"] = got
            require(not on_card or got == want,
                    f"(f) {name} rank {i}: launches {got}, expected {want}")
        log(f"[ranks] (f) {name}: each rank {two[0]['launches'][name]}, "
            f"expected {want} ({how})")
    want, how = derived_counts(flag, 2, T, 1, T, ranks=(2, 1))
    for i, t in enumerate(tn):
        counts[f"ranks_train_net_r{i}"] = t["whole"]["launches"]
        require(not on_card or t["whole"]["launches"] == want,
                f"(f) train_net rank {i}: launches "
                f"{t['whole']['launches']}, expected {want}")
    log(f"[ranks] (f) train_net: each rank {tn[0]['whole']['launches']}, "
        f"expected {want} ({how})")
    if on_card:
        ms = [float(np.median(r["step_ms"])) for r in two]
        one_ms = float(np.median(ref["dp_default"]["ms"]))
        numbers.update(rank_step_ms=ms, one_process_bs4_ms=one_ms)
        log(f"[ranks] (g) two processes sharing one card, not a scaling "
            f"figure: each rank's flagship step of 2 clips (gloo, default "
            f"chunks) median {ms[0]:.2f} / {ms[1]:.2f} ms "
            f"({[round(x, 2) for x in two[0]['step_ms']]}, "
            f"{[round(x, 2) for x in two[1]['step_ms']]}); one process's "
            f"step of the same 4 clips {one_ms:.2f} ms "
            f"({[round(x, 2) for x in ref['dp_default']['ms']]}) [{smi}]")
    log(f"[ranks] done in {time.time() - t_all:.2f} s")
    return {"counts": counts, "numbers": numbers}


def derived_counts(c, steps: int, step_T: int, eval_calls: int,
                   eval_T: int, eval_batch=None, ranks=None):
    """Launches of ``steps`` training steps of clips of ``step_T`` frames
    (every layer one by one: the stem needs its gradient) and ``eval_calls``
    eval calls of ``eval_batch`` (default ``c.test_batch_size``; a serving
    call's ``pad_to``) clips of ``eval_T`` frames (no gradient: the fused
    stem and 4 pools per chunk), chunked by ``auto_chunk``; and how.  The
    DIN variants (hierarchical, multi, TCE) run the flagship's trunk, so
    their launches are its, and VGG-19's are VGG-16's.  The other backbones
    (ResNet-18 and -50, Inception-v3, AlexNet) have no 2x2 pool and no VGG
    stem: one RoIAlign forward per call, one backward per step when the
    backbone trains (none with it frozen: ARG), whatever the chunks, where
    a map of the backbone is ``out_size`` (Inception-v3's other map, and a
    map of any other size, goes through the composed rows: no kernel).
    With ``ranks`` = (frame ranks, model ranks) they are one rank's, its
    backbone calls those of ``plan_calls`` (``models/trunk.py``
    ``FramePlan``)."""
    from din_tpu_torch.models.trunk import auto_chunk

    H, W = c.image_size
    step_frames = c.batch_size * step_T
    eval_frames = (eval_batch or c.test_batch_size) * eval_T
    if ranks is None:
        step_per = auto_chunk(step_frames, H, W, c.frame_chunk,
                              c.train_backbone)
        eval_per = auto_chunk(eval_frames, H, W, c.frame_chunk,
                              c.train_backbone)
        step_chunks = step_frames // step_per
        eval_chunks = eval_frames // eval_per
    else:
        step_chunks, step_per = plan_calls(c, step_frames, ranks, True)
        eval_chunks, eval_per = plan_calls(c, eval_frames, ranks, False)
    if c.backbone not in ("vgg16", "vgg19"):
        k1 = int(tuple(c.out_size) in backbone_maps(c.backbone, H, W))
        bwd = steps * k1 if c.train_backbone else 0
        return ({"max_pool_2x2": 0, "roi_align": k1 * (steps + eval_calls),
                 "max_pool_2x2_bwd": 0, "roi_align_bwd": bwd,
                 "fused_stem": 0},
                f"{c.backbone}: per step {k1} RoIAlign forward"
                + (" and backward" if c.train_backbone
                   else " (frozen backbone: no backward)")
                + f" on the map of out_size {tuple(c.out_size)} of "
                f"{step_chunks} backbone chunk(s) of "
                f"{step_per} frames; per eval call {k1} "
                f"RoIAlign on {eval_chunks} chunk(s) of "
                f"{eval_per} frames; no 2x2 pool, no VGG "
                f"stem")
    return ({"max_pool_2x2": 5 * steps * step_chunks
             + 4 * eval_calls * eval_chunks,
             "roi_align": steps + eval_calls,
             "max_pool_2x2_bwd": 5 * steps * step_chunks,
             "roi_align_bwd": steps,
             "fused_stem": eval_calls * eval_chunks},
            f"per step 5 pools x {step_chunks} chunk(s) of "
            f"{step_per} frames and 1 RoIAlign; eval "
            f"{eval_calls} calls x {eval_chunks} chunk(s) of "
            f"{eval_per} frames of the fused stem and 4 "
            f"pools")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.data.datasets import return_dataset
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.experiments.run import config_from_args
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.models.trunk import auto_chunk
    from din_tpu_torch.nn import backbones
    from din_tpu_torch.ops import native
    from din_tpu_torch.ops.pool import (max_pool_2x2, max_pool_2x2_bwd,
                                        max_pool_2x2_bwd_ref,
                                        max_pool_2x2_ref)
    from din_tpu_torch.ops.roi_align import (_sample_grid, roi_align,
                                             roi_align_bwd,
                                             roi_align_bwd_ref,
                                             roi_align_ref)
    from din_tpu_torch.ops.stem import fused_stem, fused_stem_ref
    from din_tpu_torch.train.engine import (setup_training, train_net,
                                            train_step)

    reset_counts, read_counts = _reset_launches, _read_launches

    dev = torch.device("cuda")
    t_all = time.time()

    # -- 1. setup -------------------------------------------------------------
    t0 = time.time()
    smi = nvidia_smi_line()
    log(f"[setup] card: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    tb = time.time()
    so = native.build()
    native.library()
    log(f"[setup] nvcc build + load: {time.time() - tb:.2f} s -> "
        f"{so.relative_to(native.BUILD_DIR.parents[1])}")
    log_path = so.with_name(so.name + ".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[setup] ptxas: {line.strip()}")
    log(f"[setup] done in {time.time() - t0:.2f} s")

    # -- 2. kernels against plain versions ------------------------------------
    t0 = time.time()
    gen = torch.Generator().manual_seed(SEED)
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    stem_err = 0.0
    for shape, shift in (((5, 720, 1280, 3), 0.0), ((2, 7, 9, 3), 0.0),
                         ((2, 7, 9, 3), 3.0), ((1, 33, 47, 3), 3.0)):
        for dtype in (torch.float32, torch.bfloat16):
            args = stem_inputs(shape, dtype, dgen, shift)
            got, ref = fused_stem(*args), fused_stem_ref(*args)
            torch.cuda.synchronize()
            require(got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64),
                    f"fused_stem shape {tuple(got.shape)}")
            diff = (got.float() - ref.float()).abs()
            tol = 1e-5 * ref.float().abs().max().item()
            what = f"fused_stem {list(shape)} b0+{shift} {dtype}"
            if dtype == torch.float32:
                require(diff.max().item() <= tol,
                        f"{what}: max |err| {diff.max().item()} > {tol}")
                log(f"[kernels] K3 {what}: max |err| "
                    f"{diff.max().item():.3g} (<= 1e-5 * max|y| = {tol:.3g})")
            else:
                ulp = bf16_ulp(torch.maximum(got.float().abs(),
                                             ref.float().abs()))
                excess = (diff - ulp).max().item()
                require(excess <= tol, f"{what}: more than 1 bf16 ulp + "
                        f"{tol} off: excess {excess}")
                stem_err = max(stem_err, diff.max().item())
                log(f"[kernels] K3 {what}: max |err| "
                    f"{diff.max().item():.3g}, "
                    f"{int((diff > ulp).sum())} of {diff.numel()} elements "
                    f"({float((diff > ulp).float().mean()):.3g}) beyond 1 "
                    f"bf16 ulp, largest excess {max(excess, 0.0):.3g} (<= "
                    f"1e-5 * max|y| = {tol:.3g})")
            del args, got, ref, diff
    # conv1_2 as the identity (centre tap, no bias): the output is the
    # pooled y1 itself, which must equal the plain version's bit for bit
    x, w0, b0, w2, _ = stem_inputs((5, 720, 1280, 3), torch.bfloat16, dgen)
    w2 = torch.zeros_like(w2)
    w2[torch.arange(64), torch.arange(64), 1, 1] = 1
    b2 = torch.zeros(64, dtype=torch.bfloat16, device=dev)
    got, ref = fused_stem(x, w0, b0, w2, b2), fused_stem_ref(x, w0, b0, w2, b2)
    torch.cuda.synchronize()
    y1_mismatch = int((got != ref).sum())
    require(y1_mismatch == 0, f"fused_stem's y1 differs from the plain "
            f"version's in {y1_mismatch} pooled values")
    log(f"[kernels] K3 y1 (conv1_2 = identity) [5, 720, 1280, 3] bf16: "
        f"equal to the plain version bit for bit ({got.numel()} values)")
    del x, w0, b0, w2, b2, got, ref
    pool_shapes = [(2, 720, 1280, 64), (2, 360, 640, 128), (2, 180, 320, 256),
                   (2, 90, 160, 512), (2, 45, 80, 512), (2, 7, 9, 3)]
    pool_err = pool_bwd_err = 0.0
    for shape in pool_shapes:
        F_, H_, W_, C_ = shape
        out_shape = (F_, H_ // 2, W_ // 2, C_)
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("randn", "ties"):
                if kind == "ties":   # integers 0..3: most windows tie
                    x = torch.randint(0, 4, shape, generator=dgen,
                                      device=dev).to(dtype)
                    # a gradient that is not NHWC-contiguous, as a conv's
                    # dgrad may hand over
                    g = torch.randn((F_, C_, H_ // 2, W_ // 2), generator=dgen,
                                    device=dev).to(dtype).permute(0, 2, 3, 1)
                else:
                    x = torch.randn(shape, generator=dgen, device=dev).to(
                        dtype)
                    g = torch.randn(out_shape, generator=dgen,
                                    device=dev).to(dtype)
                got, ref = max_pool_2x2(x), max_pool_2x2_ref(x)
                torch.cuda.synchronize()
                require(torch.equal(got, ref),
                        f"max_pool_2x2 != plain at {shape} {dtype} {kind}")
                got, ref = max_pool_2x2_bwd(x, g), max_pool_2x2_bwd_ref(x, g)
                torch.cuda.synchronize()
                require(torch.equal(got, ref),
                        f"max_pool_2x2_bwd != plain at {shape} {dtype} {kind}")
                pool_bwd_err = max(pool_bwd_err, float(
                    (got.float() - ref.float()).abs().max()))
                pool_err = max(pool_err, pool_bwd_err)
        del x, g, got, ref
    log(f"[kernels] K2 max_pool_2x2 and K2b max_pool_2x2_bwd == plain "
        f"(torch.equal) at {pool_shapes} f32+bf16, random and tie-heavy "
        f"inputs, non-contiguous gradient")

    crop = (5, 5)
    feats32 = torch.randn((20, 22, 40, 512), generator=dgen, device=dev)
    kboxes = edge_boxes(20, 12, 22, 40, gen).to(dev)
    got = roi_align(feats32, kboxes, crop)
    torch.cuda.synchronize()
    require(bool((got[:, 3] == 0).all()), "fully-outside box is not 0")
    feats16 = feats32.bfloat16()
    roi_err = max(k1_bits(f, kboxes, crop, "[20,22,40,512] edge boxes")
                  for f in (feats32, feats16))
    log("[kernels] K1 roi_align vs plain at [20,22,40,512] x 12 edge boxes "
        "(border, partly off, zero-area and fully outside boxes): bit-equal "
        "in f32 and bf16; the fully outside box gives 0")
    # K1 bit for bit at every other map the smoke runs it on, each with 5x5
    # crops: the collective, Inception-v3 (480x720 Mixed_5d of 8 clips with
    # 13 slots, 4 padded; 720x1280 Mixed_5d), ResNet-50 and AlexNet maps; a
    # C that is no multiple of the 16-byte vector and a feature pointer off
    # a 16-byte boundary (the kernel's scalar tail), with the edge boxes
    k1_maps = {"collective": ((20, 15, 23, 512), 13, 4),
               "inv3_collective": ((80, 57, 87, 288), 13, 4),
               "inv3_volleyball": ((20, 87, 157, 288), 12, 0),
               "res50": ((20, 23, 40, 2048), 12, 0),
               "alex": ((20, 21, 39, 256), 12, 0)}
    for key, (shape, nb, pad) in k1_maps.items():
        f = torch.randn(shape, generator=dgen, device=dev)
        b = cad_boxes(shape[0], nb, pad, shape[1], shape[2], gen).to(dev)
        for f_dt in (f, f.bfloat16()):
            k1_bits(f_dt, b, crop, f"{key} {list(shape)}")
        del f, b, f_dt
    c100 = torch.randn((20, 22, 40, 100), generator=dgen, device=dev)
    for f_dt in (c100, c100.bfloat16(), feats32, feats16):
        buf = torch.empty(f_dt.numel() + 8, dtype=f_dt.dtype, device=dev)
        off = buf[1:1 + f_dt.numel()].view(f_dt.shape)
        off.copy_(f_dt)
        require(off.data_ptr() % 16 != 0, "the offset map is aligned")
        for x, where in ((f_dt, ""), (off, ", pointer off 16 bytes")):
            k1_bits(x, kboxes, crop, f"{list(f_dt.shape)} edge boxes{where}")
    del c100, buf, off, f_dt, x
    log(f"[kernels] K1 roi_align bit-equal to plain, f32 and bf16, 5x5, at "
        + ", ".join(f"{k} {list(v[0])} x {v[1]} boxes ({v[2]} padded)"
                    for k, v in k1_maps.items())
        + "; and with the edge boxes at [20,22,40,100] (C no multiple of the "
          "16-byte vector) and at [20,22,40,100] and [20,22,40,512] from a "
          "feature pointer 1 element past a 16-byte boundary (the scalar "
          "tail)")

    hw = tuple(feats32.shape[1:3])
    gb = torch.randn((20, 12, *crop, 512), generator=dgen, device=dev)
    got = roi_align_bwd(gb, kboxes, hw, torch.float32)
    ref = roi_align_bwd_ref(gb, kboxes, hw, torch.float32)
    torch.cuda.synchronize()
    bwd32 = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    require(bwd32 <= 1e-5 * scale,
            f"roi_align_bwd f32 max |err| {bwd32} > 1e-5 * {scale}")
    require(bool((got[:, :, :, :] != 0).any()), "roi_align_bwd is all 0")
    gb16 = gb.bfloat16()
    got = roi_align_bwd(gb16, kboxes, hw, torch.bfloat16)
    ref = roi_align_bwd_ref(gb16, kboxes, hw, torch.float32)
    torch.cuda.synchronize()
    diff = (got.float() - ref).abs()
    ulp = bf16_ulp(torch.maximum(got.float().abs(), ref.abs()))
    # one bf16 rounding of a sum whose f32 order differs: 1 ulp plus the
    # f32 order tolerance (a row summed from many overlapping samples can
    # cancel to near 0, where the order's error exceeds that row's ulp)
    scale16 = ref.abs().max().item()
    excess = (diff - ulp).max().item()
    require(excess <= 1e-5 * scale16,
            f"roi_align_bwd bf16 off the f32 result by more than 1 ulp + "
            f"1e-5 * max|df|: excess {excess}, max |err| "
            f"{diff.max().item()}")
    roi_bwd_err = diff.max().item()
    log(f"[kernels] K1b roi_align_bwd vs plain at [20,12,5,5,512] -> "
        f"[20,22,40,512], same boxes: f32 max |err| {bwd32:.3g} (<= 1e-5 * "
        f"max|df| = {1e-5 * scale:.3g}; the plain version on the card adds "
        f"with index_add_'s atomics, in a varying order), "
        f"bf16 max |err| {roi_bwd_err:.3g} against the f32 result, largest "
        f"excess over 1 bf16 ulp {max(excess, 0.0):.3g} (<= 1e-5 * max|df| "
        f"= {1e-5 * scale16:.3g}); "
        f"{int((diff > ulp).sum())} of {diff.numel()} elements beyond 1 ulp")
    # the kernel adds in the plain version's order: bit for bit equal to it
    # run on the CPU (index_add_ adds rows in index order there), and to
    # itself from launch to launch; also from g in the trunk's
    # channel-major layout, which the wrapper copies first
    cboxes = kboxes.cpu()
    for dtype, bits in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        g_dt = gb.to(dtype)
        want = roi_align_bwd_ref(g_dt.cpu(), cboxes, hw, dtype)
        first = roi_align_bwd(g_dt, kboxes, hw, dtype)
        second = roi_align_bwd(g_dt, kboxes, hw, dtype)
        copies = roi_align_bwd.g_copies
        g_cm = g_dt.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)
        third = roi_align_bwd(g_cm, kboxes, hw, dtype)
        torch.cuda.synchronize()
        differ = int((first.cpu().view(bits) != want.view(bits)).sum())
        require(differ == 0, f"roi_align_bwd {dtype} differs from the plain "
                f"version on the CPU in {differ} of {want.numel()} elements")
        require(torch.equal(first.view(bits), second.view(bits))
                and torch.equal(first.view(bits), third.view(bits)),
                f"roi_align_bwd {dtype}: two launches differ")
        require(roi_align_bwd.g_copies == copies + 1,
                "roi_align_bwd did not count its copy of a channel-major g")
        log(f"[kernels] K1b roi_align_bwd {dtype} at [20,12,5,5,512] with the "
            f"edge boxes: equal to roi_align_bwd_ref on the CPU bit for bit "
            f"({want.numel()} elements), two launches and a channel-major g "
            f"bit-equal to each other")
    del feats32, feats16, gb, gb16, got, ref, diff, ulp, g_dt, want, first
    del second, third, g_cm

    # K1 and K1b at the collective path's shapes: a ResNet-18 map of a
    # 480x720 frame (15x23), 13 boxes a frame of which 4 are zero-padded
    # (they sample at -0.5, outside the map: K1 writes 0, K1b adds nothing)
    cad = {}
    cfeats = torch.randn((20, 15, 23, 512), generator=dgen, device=dev)
    cboxes = cad_boxes(20, 13, 4, 15, 23, gen).to(dev)
    chw = (15, 23)
    for dtype in (torch.float32, torch.bfloat16):
        f_dt = cfeats.to(dtype)
        tag = "f32" if dtype == torch.float32 else "bf16"
        cad["k1_" + tag] = k1_bits(f_dt, cboxes, crop, "collective")
        got = roi_align(f_dt, cboxes, crop)
        torch.cuda.synchronize()
        require(bool((got[:, 9:] == 0).all()),
                f"roi_align {dtype} at the collective shapes: padded boxes "
                f"are not 0")
        g = torch.randn((20, 13, *crop, 512), generator=dgen,
                        device=dev).to(dtype)
        got = roi_align_bwd(g, cboxes, chw, dtype)
        ref = roi_align_bwd_ref(g, cboxes, chw, torch.float32)
        want = roi_align_bwd_ref(g.cpu(), cboxes.cpu(), chw, dtype)
        g_pad = g.clone()
        g_pad[:, :9] = 0
        pad_only = roi_align_bwd(g_pad, cboxes, chw, dtype)
        torch.cuda.synchronize()
        diff = (got.float() - ref).abs()
        scale = ref.abs().max().item()
        excess = (diff - (bf16_ulp(torch.maximum(got.float().abs(), ref.abs()))
                          if dtype == torch.bfloat16 else 0)).max().item()
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        differ = int((got.cpu().view(bits) != want.view(bits)).sum())
        require(excess <= 1e-5 * scale and differ == 0
                and not bool(pad_only.any()),
                f"roi_align_bwd {dtype} at the collective shapes: excess "
                f"{excess} over {'1 ulp + ' if dtype == torch.bfloat16 else ''}"
                f"1e-5 * {scale}, {differ} elements differ from the CPU plain "
                f"version, padded boxes add {pad_only.abs().max().item()}")
        cad["k1b_" + tag] = diff.max().item()
    log(f"[kernels] K1 and K1b at the collective shapes [20,15,23,512] x 13 "
        f"boxes (4 zero-padded per frame, one on the border): K1 bit-equal "
        f"to plain in f32 and bf16, padded boxes give 0; "
        f"K1b vs plain on the card max |err| f32 "
        f"{cad['k1b_f32']:.3g}, bf16 "
        f"{cad['k1b_bf16']:.3g} (against the f32 result; 1e-5 * "
        f"max|df|, plus 1 ulp in bf16), bit-equal to the plain version on "
        f"the CPU in f32 and bf16, and a gradient on the padded boxes alone "
        f"adds nothing")
    del cfeats, f_dt, got, ref, want, g, g_pad, pad_only, diff

    # K1 and K1b at the baselines' shapes: a ResNet-18 map of a 720x1280
    # frame (23x40), 12 person-sized boxes a frame (one on the border), the
    # 5x5 crops of PCTDM, AT, ARG and SACRF and HiGCIN's 7x7
    bfeats = torch.randn((20, 23, 40, 512), generator=dgen, device=dev)
    bboxes = cad_boxes(20, 12, 0, 23, 40, gen).to(dev)
    base_errs = {crop_b: check_roi_kernels(bfeats, bboxes, crop_b, dgen)
                 for crop_b in ((5, 5), (7, 7))}
    log("[kernels] K1 and K1b at the baselines' shapes [20,23,40,512] x 12 "
        "person-sized boxes: " + "; ".join(
            f"crop {k[0]}x{k[1]}: K1 bit-equal to plain in f32 and bf16; "
            f"K1b vs plain on the card f32 {e['k1b_f32']:.3g}, bf16 "
            f"{e['k1b_bf16']:.3g} (1e-5 * max|df|, plus 1 ulp in bf16)"
            for k, e in base_errs.items())
        + "; K1b bit-equal to the plain version on the CPU in f32 and bf16")
    del bfeats
    log(f"[kernels] done in {time.time() - t0:.2f} s")

    # -- 3. full-width serving ------------------------------------------------
    t0 = time.time()
    cfg = PRESETS["volleyball_stage2_dynamic"]()
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, generator=gen)
    _randomize_din(model, gen)
    require(all(p.dtype == torch.float32 for p in model.parameters()),
            "parameters are not float32 master weights")
    predictor = Predictor(cfg, model, pad_to=2)
    batch = make_synthetic_batch(cfg, 3, rng=np.random.RandomState(SEED))
    requests = [(batch["images"][:1], batch["boxes"][:1]),
                (batch["images"], batch["boxes"]),
                (batch["images"][:1], batch["boxes"][:1])]
    log(f"[serve] {cfg.backbone} {cfg.image_size[0]}x{cfg.image_size[1]} "
        f"T={cfg.num_frames} N={cfg.num_boxes} lite={cfg.lite_dim} "
        f"compute={cfg.compute_dtype}, f32 weights; model built in "
        f"{time.time() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs, req_ms = [], []
    for images, boxes in requests:
        tr = time.time()
        outs.append(predictor(images, boxes)["activities"])
        torch.cuda.synchronize()
        req_ms.append((time.time() - tr) * 1e3)
    serve_counts = read_counts()
    padded_calls = sum(-(-len(im) // 2) for im, _ in requests)
    chunks = (2 * cfg.num_frames) // auto_chunk(
        2 * cfg.num_frames, *cfg.image_size, cfg.frame_chunk,
        cfg.train_backbone)
    log(f"[serve] requests of {[len(im) for im, _ in requests]} clips: "
        f"{', '.join(f'{ms:.1f}' for ms in req_ms)} ms (host clock, after "
        f"synchronize; the first includes cuDNN warm-up); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for out, (images, _) in zip(outs, requests):
        require(out.shape == (len(images), cfg.num_activities),
                f"posterior shape {out.shape}")
        require(bool(np.isfinite(out).all()), "non-finite posteriors")
        require(bool(np.abs(out.sum(-1) - 1).max() <= 1e-5),
                "posterior rows do not sum to 1")
    rep = float(np.abs(outs[0] - outs[2]).max())
    require(rep <= 1e-6, f"repeated clip differs by {rep}")
    log(f"[serve] posteriors finite, rows sum to 1; repeated clip max |diff| "
        f"{rep:.3g}; clip 0 in the 3-clip request differs by "
        f"{float(np.abs(outs[0][0] - outs[1][0]).max()):.3g}")
    expect = {"max_pool_2x2": 4 * chunks * padded_calls,
              "roi_align": padded_calls, "max_pool_2x2_bwd": 0,
              "roi_align_bwd": 0, "fused_stem": chunks * padded_calls}
    log(f"[serve] launches {serve_counts}, expected {expect} (per chunk the "
        f"fused stem and 4 pools; {chunks} chunks x {padded_calls} padded "
        f"calls; no backward)")
    require(serve_counts == expect and expect["roi_align"] > 0,
            "serving launch counts are off")
    main_boxes = torch.from_numpy(
        np.concatenate([batch["boxes"][:1]] * 2).reshape(-1, cfg.num_boxes,
                                                         4)).to(dev)

    # 1-clip latency with K3, and with the stem as the layers it replaces
    # (cuDNN convs with bias, ReLU, K2), in turns
    def layered_stem(x, w0, b0, w2, b2):
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = F.relu(F.conv2d(F.relu(F.conv2d(h, w0, b0, padding=1)), w2, b2,
                            padding=1))
        return max_pool_2x2(h.permute(0, 2, 3, 1).contiguous())

    lat = {"K3": [], "layers": []}
    try:
        for route in ("K3", "layers", "layers", "K3") * 3:
            backbones.fused_stem = (fused_stem if route == "K3"
                                    else layered_stem)
            lat[route] += time_host(lambda: predictor(*requests[0]), 1)
    finally:
        backbones.fused_stem = fused_stem
    log("[serve] 1-clip requests, 6 each in turns (host clock, "
        "synchronized): " + "; ".join(
            f"{k} median {np.median(v):.2f} ms (min {min(v):.2f}, max "
            f"{max(v):.2f})" for k, v in lat.items()) + "; 'layers' runs the "
        "stem as cuDNN convs, ReLU and K2 instead of K3")

    # the DIN head's f32 convs under the card's default flags: as they ran
    # before the repair (TF32) and after it, each against TF32 off
    from din_tpu_torch.heads.din import DynamicPersonInference
    p_convs = {id(m) for n, m in model.named_modules() if ".p_conv." in n}
    clip = [torch.from_numpy(a[:1]).to(dev) for a in (batch["images"],
                                                      batch["boxes"])]
    flags = (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
             f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    def head_run():
        """Posteriors and the p_conv outputs (offsets) of one clip, through
        whichever grid conv the head has now."""
        offsets = []
        grid_conv = DynamicPersonInference.__dict__["_grid_conv"]

        def recording(conv, x):
            out = grid_conv.__func__(conv, x)
            if id(conv) in p_convs:
                offsets.append(out)
            return out

        DynamicPersonInference._grid_conv = staticmethod(recording)
        try:
            with torch.inference_mode():
                post = torch.softmax(model(*clip)["activities"].float(), -1)
        finally:
            DynamicPersonInference._grid_conv = grid_conv
        return post, torch.cat([o.flatten() for o in offsets])

    with head_convs_unrepaired():
        before_post, before_off = head_run()
        with no_tf32():
            exact_post, exact_off = head_run()
    after_post, after_off = head_run()
    tf32_off = (before_off - exact_off).abs().max().item()
    tf32_post = (before_post - exact_post).abs().max().item()
    fixed_off = (after_off - exact_off).abs().max().item()
    fixed_post = (after_post - exact_post).abs().max().item()
    log(f"[tf32] default flags on the card: {flags}. Flagship, 1 clip, "
        f"random DIN convs: head convs as before the repair vs TF32 off: "
        f"offsets (p_conv) max |diff| {tf32_off:.3g} of max |offset| "
        f"{exact_off.abs().max().item():.3g}, posteriors max |diff| "
        f"{tf32_post:.3g}; repaired, default flags vs TF32 off: offsets "
        f"{fixed_off:.3g}, posteriors {fixed_post:.3g}")
    require(fixed_off <= 1e-6 and fixed_post <= 1e-6,
            "the repaired head still depends on the TF32 flag")

    # the same convs' backward: one flagship-geometry step's gradients of
    # the head's convs (batch of 2 clips, eval mode: dropout off)
    from din_tpu_torch.train.losses import compute_losses
    gbatch = to_device(make_synthetic_batch(
        cfg, 2, rng=np.random.RandomState(SEED + 4)), dev)
    head_names = [n for n, _ in model.named_parameters()
                  if ".p_conv." in n or ".scale_conv." in n]

    def head_grads():
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = model(gbatch["images"], gbatch["boxes"])
            compute_losses(out, gbatch, cfg, True)["loss"].backward()
        params = dict(model.named_parameters())
        return {n: params[n].grad.detach().clone() for n in head_names}

    hb = tf32_backward_check(head_grads,
                             [("pre_pr6", head_convs_unrepaired)])
    model.zero_grad(set_to_none=True)
    log(f"[tf32] backward, default flags ({flags}), one flagship step of 2 "
        f"clips, gradients of the head's {len(head_names)} conv tensors "
        f"(max |g| {hb['scale']:.3g}) against TF32 off: backward as before "
        f"the repair {hb['before']:.3g}; repaired {hb['after']:.3g}; a "
        f"second TF32-off run {hb['noise']:.3g}; forward and backward as "
        f"before the forward's repair {hb['pre_pr6']:.3g} (cuDNN "
        f"deterministic algorithms)")
    require(hb["after"] <= hb["noise"],
            "the repaired head's backward still depends on the TF32 flag")
    del predictor, model, clip, gbatch
    torch.cuda.empty_cache()
    log(f"[serve] done in {time.time() - t0:.2f} s")

    # -- 4. full-width stage 1, then stage 2 from it, through train_net -------
    t0 = time.time()
    steps = 3

    def expected_counts(c, n_val, steps=steps):
        """Launches of ``steps`` training steps and the eval passes over
        ``n_val`` clips of T=num_frames (one, and one more before training
        with ``test_before_train``)."""
        passes = 1 + bool(c.test_before_train)
        return derived_counts(
            c, steps, 1 if c.training_stage == 1 else c.num_frames,
            passes * -(-n_val // c.test_batch_size), c.num_frames)

    def log_losses(path: Path, what: str, c) -> list:
        losses = [float(v) for v in re.findall(r"Loss: ([-+0-9.eEnaif]+)",
                                               path.read_text())]
        require(len(losses) == 2 + bool(c.test_before_train)
                and all(math.isfinite(v) for v in losses),
                f"{what}: losses in log.txt: {losses}")
        return losses

    run_root = native.BUILD_DIR.parent / "smoke_runs"
    run_root.mkdir(parents=True, exist_ok=True)
    disk_s1 = run_root / "ondisk_stage1.pth"
    # phase 10 serves phase 4's stage-2 file and its reference-ordered
    # copy, phase 14 exports it; phase 11 grafts the variants from its
    # stage-1 file
    serve_ckpt = run_root / "phase4_stage2.pth"
    export_ckpt = run_root / "phase14_stage2.pth"
    serve_ref = run_root / "phase4_reference_order.pth"
    variants_s1 = run_root / "variants_stage1.pth"
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        vgg_path = str(Path(tmp) / "vgg16_pretrained.pth")
        vgg_state = write_torchvision_file(vgg_path, "vgg16", SEED + 5)
        s1_argv = ["--preset", "volleyball_stage1", "--data-path",
                   "synthetic", "--max-epoch", "1", "--result-root", tmp,
                   "--exp-name", "stage1", "--pretrained-backbone-path",
                   vgg_path]
        s1cfg, _ = config_from_args(s1_argv)
        _, s1_val = return_dataset(s1cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        tt = time.time()
        s1_best = train_net(s1cfg, max_steps_per_epoch=steps)
        torch.cuda.synchronize()
        s1_s = time.time() - tt
        s1_counts = read_counts()
        s1_expect, how = expected_counts(s1cfg, len(s1_val))
        log(f"[stage1] train_net: volleyball_stage1 at full width "
            f"({s1cfg.image_size[0]}x{s1cfg.image_size[1]}, batch "
            f"{s1cfg.batch_size}, T=1 in training, {s1cfg.num_frames} in "
            f"eval), an eval of {len(s1_val)} clips (test_before_train), "
            f"{steps} steps + eval + component "
            f"file in {s1_s:.2f} s (host clock, synthetic clips made on the "
            f"host included); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        log(f"[stage1] launches {s1_counts}, expected {s1_expect} ({how})")
        require(s1_counts == s1_expect and min(s1_expect.values()) > 0,
                "stage-1 launch counts are off")
        s1_losses = log_losses(Path(tmp) / "stage1" / "log.txt", "stage 1",
                               s1cfg)
        s1_path = s1_best.get("checkpoint")
        require(s1_path is not None and Path(s1_path).exists()
                and Path(s1_path).name.startswith("stage1_epoch1_"),
                f"no stage-1 component file: {s1_path}")
        # phases 8 and 11 start their stage 2 from this file too
        shutil.copy(s1_path, disk_s1)
        shutil.copy(s1_path, variants_s1)
        comp = torch.load(s1_path, map_location="cpu", weights_only=True)
        require(sorted(comp) == ["backbone_state_dict",
                                 "fc_actions_state_dict",
                                 "fc_activities_state_dict",
                                 "fc_emb_state_dict"],
                f"stage-1 file keys {sorted(comp)}")
        log(f"[stage1] train / eval loss {s1_losses} (finite); component "
            f"file {Path(s1_path).name} "
            f"({Path(s1_path).stat().st_size / 2 ** 20:.0f} MiB, keys "
            f"{sorted(comp)})")
        require("Loaded pretrained backbone: " + vgg_path in (
            Path(tmp) / "stage1" / "log.txt").read_text(),
            "stage 1 did not start from the pretrained backbone")
        model, optimizer, _ = setup_training(s1cfg)
        unused = check_loaded(model, vgg_state, "vgg16")
        log(f"[stage1] --pretrained-backbone-path: train_net started from a "
            f"torchvision-layout VGG-16 file the smoke wrote; setup_training "
            f"loads its {len(model.backbone.state_dict())} features.* "
            f"tensors equal to the file's; unused: {', '.join(unused)}")
        s1batch = to_device(make_synthetic_batch(
            s1cfg, s1cfg.batch_size, rng=np.random.RandomState(SEED + 3)),
            dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s1_ms = time_host(lambda: train_step(model, optimizer, s1batch,
                                             s1cfg), 6)
        s1_step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        s1_warm = sum(s1_ms[1:]) / len(s1_ms[1:])
        log(f"[stage1] step times {', '.join(f'{v:.1f}' for v in s1_ms)} "
            f"ms (host clock, synchronized; batch of {s1cfg.batch_size} "
            f"clips on the card, dropout {s1cfg.train_dropout_prob}); after "
            f"the warm-up step {s1_warm:.1f} ms per step = "
            f"{s1cfg.batch_size / s1_warm * 1e3:.3f} clips/s; peak device "
            f"memory {s1_step_peak:.2f} GiB")
        del model, optimizer, s1batch
        torch.cuda.empty_cache()
        log(f"[stage1] done in {time.time() - t0:.2f} s")

        t0 = time.time()
        argv = ["--preset", "volleyball_stage2_dynamic", "--data-path",
                "synthetic", "--max-epoch", "1", "--result-root", tmp,
                "--exp-name", "train", "--stage1-model-path", s1_path]
        tcfg, _ = config_from_args(argv)
        _, val_set = return_dataset(tcfg)
        gmodel, _, _ = setup_training(tcfg)
        for name, part, key in (("backbone", gmodel.backbone,
                                 "backbone_state_dict"),
                                ("fc_emb_1", gmodel.fc_emb_1,
                                 "fc_emb_state_dict")):
            state = part.state_dict()
            require(sorted(state) == sorted(comp[key]) and all(
                torch.equal(v.cpu(), comp[key][k]) for k, v in state.items()),
                f"grafted {name} differs from the stage-1 file")
        log(f"[train] setup_training grafts {s1cfg.exp_note}'s file: "
            f"backbone.* ({len(comp['backbone_state_dict'])} tensors) and "
            f"fc_emb_1 equal the file's tensors before the first step")
        del gmodel, comp
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        max_pool_2x2_bwd.g_copies = 0
        roi_align_bwd.g_copies = 0
        tt = time.time()
        best = train_net(tcfg, max_steps_per_epoch=steps)
        torch.cuda.synchronize()
        train_s = time.time() - tt
        train_counts = read_counts()
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        B = tcfg.batch_size
        expect, how = expected_counts(tcfg, len(val_set))
        log(f"[train] train_net: flagship at full width from the stage-1 "
            f"file, batch {B}, {steps} steps + eval of {len(val_set)} clips "
            f"+ checkpoint in {train_s:.2f} s (host clock, synthetic clips "
            f"made on the host included); peak device memory "
            f"{train_peak:.2f} GiB")
        log(f"[train] launches {train_counts}, expected {expect} ({how}); "
            f"K2b's incoming gradient copied to NHWC "
            f"{max_pool_2x2_bwd.g_copies} times, K1b's to contiguous "
            f"{roi_align_bwd.g_copies} times")
        require(train_counts == expect and min(expect.values()) > 0,
                "training launch counts are off")
        train_losses = log_losses(Path(tmp) / "train" / "log.txt", "stage 2",
                                  tcfg)
        ckpt = best.get("checkpoint")
        require(ckpt is not None and Path(ckpt).exists(),
                "no checkpoint written")
        log(f"[train] train / eval loss {train_losses} (finite); "
            f"checkpoint {Path(ckpt).name} "
            f"({Path(ckpt).stat().st_size / 2 ** 20:.0f} MiB)")
        rcfg, _ = config_from_args(argv + ["--stage2-model-path", ckpt])
        model, optimizer, start = setup_training(rcfg)
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        require(start == saved["epoch"] + 1 == 2, f"resumes at {start}")
        state = model.state_dict()
        require(all(torch.equal(state[k].cpu(), v)
                    for k, v in saved["state_dict"].items()),
                "reloaded params differ")
        ostate = optimizer.state_dict()
        require(ostate["param_groups"] == saved["optimizer"]["param_groups"],
                "reloaded param groups differ")
        require(len(ostate["state"]) == len(saved["optimizer"]["state"])
                and all(torch.equal(ostate["state"][i][k].cpu(), v)
                        for i, s in saved["optimizer"]["state"].items()
                        for k, v in s.items()),
                "reloaded Adam state differs")
        log(f"[train] --stage2-model-path reload: params and Adam state "
            f"equal ({len(saved['optimizer']['state'])} tensors' moments), "
            f"resumes at epoch {start}")

        # the same state as the reference framework writes it, keys and Adam
        # indices in the JAX package's exporter order, migrated with
        # --ref-checkpoint-path --ref-resume-optimizer (the flagship preset
        # would graft its stage-1 file after it, as din_tpu's does: off here)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        require(sorted(names) == sorted(saved["state_dict"]),
                "the stage-2 model has state besides its parameters")
        ref = reference_ordered(saved, names)
        require(list(ref["state_dict"]) != names,
                "the exporter's order equals the port's")
        ref_path = str(Path(tmp) / "reference_order.pth")
        torch.save(ref, ref_path)
        shutil.copy(ckpt, serve_ckpt)
        shutil.copy(ckpt, export_ckpt)
        shutil.copy(ref_path, serve_ref)
        del model, optimizer, state, ostate
        torch.cuda.empty_cache()
        rrcfg, _ = config_from_args([
            "--preset", "volleyball_stage2_dynamic", "--data-path",
            "synthetic", "--max-epoch", "1", "--result-root", tmp,
            "--exp-name", "resume", "--ref-checkpoint-path", ref_path,
            "--ref-resume-optimizer"])
        rrcfg = rrcfg.replace(load_backbone_stage2=False)
        model, optimizer, start = setup_training(rrcfg)
        require(start == saved["epoch"] + 1, f"ref resume at epoch {start}")
        adopted = 0
        for name, p in model.named_parameters():
            src = saved["optimizer"]["state"][names.index(name)]
            st = optimizer.state[p]
            require(torch.equal(p.detach().cpu(), saved["state_dict"][name])
                    and torch.equal(st["exp_avg"].cpu(), src["exp_avg"])
                    and torch.equal(st["exp_avg_sq"].cpu(), src["exp_avg_sq"])
                    and float(st["step"]) == float(src["step"]),
                    f"adopted state of {name} differs")
            adopted += 1
        del model, optimizer
        torch.cuda.empty_cache()
        reset_counts()
        tt = time.time()
        rbest = train_net(rrcfg, max_steps_per_epoch=1)
        torch.cuda.synchronize()
        resume_s = time.time() - tt
        resume_counts = read_counts()
        rexpect, how = expected_counts(rrcfg, len(val_set), steps=1)
        rlog = (Path(tmp) / "resume" / "log.txt").read_text()
        log(f"[train] reference-ordered .pth (keys and Adam indices in the "
            f"exporter's order) through --ref-checkpoint-path "
            f"--ref-resume-optimizer: {adopted} tensors' weights and moments "
            f"adopted by name, equal to the port's file; resumes at epoch "
            f"{start}; train_net of 1 step + eval in {resume_s:.2f} s, "
            f"launches {resume_counts}, expected {rexpect} ({how})")
        require(resume_counts == rexpect and min(rexpect.values()) > 0,
                "reference-resume launch counts are off")
        for line in (f"Loaded reference checkpoint {ref_path} (0 keys "
                     f"skipped)", "Adopted reference optimizer state "
                     f"(resuming at epoch {start})",
                     f"Train at epoch #{start}"):
            require(line in rlog, f"reference resume log lacks {line!r}")
        require(Path(rbest["checkpoint"]).name.startswith(
            f"stage2_epoch{start}_"), f"resume wrote {rbest['checkpoint']}")
        del saved, ref
    torch.cuda.empty_cache()
    log(f"[train] done in {time.time() - t0:.2f} s")

    # -- 5. memorisation, step time, profile ----------------------------------
    t0 = time.time()
    mcfg = cfg.replace(train_dropout_prob=0.0, load_backbone_stage2=False)
    model, optimizer, _ = setup_training(mcfg)
    mbatch = to_device(make_synthetic_batch(
        mcfg, mcfg.batch_size, rng=np.random.RandomState(SEED + 2)), dev)
    mem_losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_host(lambda: mem_losses.append(float(train_step(
        model, optimizer, mbatch, mcfg)["loss"])), 8)
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(all(math.isfinite(v) for v in mem_losses), "non-finite loss")
    require(mem_losses[-1] < mem_losses[0],
            f"memorisation: loss {mem_losses}")
    warm = step_ms[1:]
    ms_step = sum(warm) / len(warm)
    log(f"[memorise] 8 steps on one batch of {mcfg.batch_size} clips, "
        f"dropout 0: loss {' '.join(f'{v:.4f}' for v in mem_losses)} "
        f"(step 8 < step 1)")
    log(f"[memorise] step times {', '.join(f'{v:.1f}' for v in step_ms)} ms "
        f"(host clock, synchronized; batch on the card); after the warm-up "
        f"step {ms_step:.1f} ms per step = "
        f"{mcfg.batch_size / ms_step * 1e3:.3f} clips/s; peak device memory "
        f"{step_peak:.2f} GiB")
    prof = traced_step(lambda: train_step(model, optimizer, mbatch, mcfg))
    busy = prof["busy_us"]
    shares = {k: v / busy for k, v in prof["by_category"].items()}
    log(f"[memorise] one profiled step: wall {prof['wall_us'] / 1e3:.1f} ms, "
        f"device busy {busy / 1e3:.1f} ms (idle share "
        f"{1 - busy / prof['wall_us']:.3f}); device time by kind: "
        + ", ".join(f"{k} {v / 1e3:.2f} ms ({shares[k]:.3f})"
                    for k, v in prof["by_category"].items()))
    del model, optimizer, mbatch
    torch.cuda.empty_cache()
    log(f"[memorise] done in {time.time() - t0:.2f} s")

    # -- 6. card against CPU --------------------------------------------------
    t0 = time.time()
    small = cfg.replace(image_size=(144, 160), out_size=(4, 5), num_frames=3,
                        compute_dtype="float32", train_dropout_prob=0.0)
    gen = torch.Generator().manual_seed(SEED)
    cpu_model = build_model(small, device="cpu", generator=gen)
    _randomize_din(cpu_model, gen)
    clip = make_synthetic_batch(small, 1, rng=np.random.RandomState(SEED + 1))
    on_cpu = Predictor(small, cpu_model, device="cpu")(
        clip["images"], clip["boxes"])["activities"]
    for what, flags in (("TF32 off", no_tf32),
                        ("the card's default flags", contextlib.nullcontext)):
        with flags():
            on_card = Predictor(small, copy.deepcopy(cpu_model))(
                clip["images"], clip["boxes"])["activities"]
        err = float(np.abs(on_card - on_cpu).max())
        require(err <= 1e-4, f"card vs CPU ({what}) max |diff| {err} > 1e-4")
        log(f"[card-vs-cpu] serving 1 clip T=3 144x160 f32 ({what}): max "
            f"|diff| of posteriors {err:.3g} (<= 1e-4); card "
            f"{np.round(on_card[0], 4)}")
    # the f32 backbone's convs' backward under the default flags: one
    # backward of the backbone from a fixed upstream gradient
    bb = copy.deepcopy(cpu_model.backbone).to(dev)
    frames = torch.rand((3, *small.image_size, 3), generator=dgen,
                        device=dev) * 2 - 1
    with torch.no_grad():
        up = torch.randn(bb(frames).shape, generator=dgen, device=dev)

    def backbone_grads():
        bb.zero_grad(set_to_none=True)
        bb(frames).backward(up)
        return {n: p.grad.detach().clone() for n, p in bb.named_parameters()}

    bbr = tf32_backward_check(backbone_grads)
    log(f"[tf32] backward, default flags, f32 VGG-16 at 3 frames of "
        f"{small.image_size[0]}x{small.image_size[1]}, gradients of its 26 "
        f"conv tensors (max |g| {bbr['scale']:.3g}) against TF32 off: as "
        f"before the repair {bbr['before']:.3g}; repaired {bbr['after']:.3g}; "
        f"a second TF32-off run {bbr['noise']:.3g} (cuDNN deterministic "
        f"algorithms)")
    require(bbr["after"] <= bbr["noise"],
            "the repaired f32 backbone's backward still depends on the TF32 "
            "flag")
    del bb, frames, up
    with no_tf32():
        r = train_card_vs_cpu(small, cpu_model)
    log_train_card_vs_cpu("stage 2", small, r)

    small1 = PRESETS["volleyball_stage1"]().replace(
        image_size=(144, 160), out_size=(4, 5), num_frames=3, batch_size=4,
        compute_dtype="float32", train_dropout_prob=0.0)
    gen = torch.Generator().manual_seed(SEED)
    cpu_model = build_model(small1, device="cpu", generator=gen)
    clip = [torch.from_numpy(a) for a in (clip["images"], clip["boxes"])]
    with no_tf32():
        with torch.no_grad():
            on_card = copy.deepcopy(cpu_model).to(dev)(
                *(t.to(dev) for t in clip))
            on_cpu = cpu_model(*clip)
        err = max((on_card[k].cpu() - on_cpu[k]).abs().max().item()
                  for k in on_cpu)
        require(err <= 1e-4, f"stage 1 card vs CPU max |diff| {err} > 1e-4")
        log(f"[card-vs-cpu] stage 1, eval forward of 1 clip T=3 144x160 f32 "
            f"(TF32 off): max |diff| of action and activity logits "
            f"{err:.3g} (<= 1e-4)")
        # stage 1's free trajectory: the share is reported (a flip moves
        # conv1_1's few gradient sums, and Adam turns each sign change into
        # a 2 lr step), the 2 lr per step bound holds
        r = train_card_vs_cpu(small1, cpu_model, free_share_bound=None)
    log_train_card_vs_cpu("stage 1", small1, r)
    del cpu_model, clip, on_card, on_cpu
    torch.cuda.empty_cache()
    log(f"[card-vs-cpu] done in {time.time() - t0:.2f} s")

    # -- 7. times -------------------------------------------------------------
    t0 = time.time()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    chunk = 2 * cfg.num_frames // chunks
    H, W = cfg.image_size
    pool_in = [(chunk, H, W, 64), (chunk, H // 2, W // 2, 128),
               (chunk, H // 4, W // 4, 256), (chunk, H // 8, W // 8, 512),
               (chunk, H // 16, W // 16, 512)]
    k2 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    k2b = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    for shape in pool_in:
        x = torch.randn(shape, generator=dgen, device=dev).bfloat16()
        y_shape = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
        y_elems = math.prod(y_shape)
        nbytes = (x.numel() + y_elems) * x.element_size()
        ms = time_cuda(lambda: max_pool_2x2(x), 20, flush)
        plain = time_cuda(lambda: max_pool_2x2_ref(x), 20, flush)
        xn = x.permute(0, 3, 1, 2)          # NCHW view, channels_last
        lib = time_cuda(lambda: F.max_pool2d(xn, 2), 20, flush)
        bound = max(nbytes / HBM_BYTES_PER_S, 3 * y_elems / F32_FLOPS_PER_S)
        log(f"[times] K2 {list(shape)} bf16: kernel {ms:.4f} ms, bound "
            f"{bound * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB), plain "
            f"{plain:.4f} ms, F.max_pool2d {lib:.4f} ms")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bytes", nbytes), ("ops", 3 * y_elems)):
            k2[k] += v

        g = torch.randn(y_shape, generator=dgen, device=dev).bfloat16()
        # read x and g once, write dx once; 2 maxes and 3 compares a window
        bbytes = (2 * x.numel() + y_elems) * x.element_size()
        bops = 5 * y_elems
        ms = time_cuda(lambda: max_pool_2x2_bwd(x, g), 20, flush)
        plain = time_cuda(lambda: max_pool_2x2_bwd_ref(x, g), 20, flush)
        _, idx = F.max_pool2d(xn, 2, return_indices=True)
        gn = g.permute(0, 3, 1, 2)
        lib_bwd = torch.ops.aten.max_pool2d_with_indices_backward
        lib = time_cuda(lambda: lib_bwd(gn, xn, [2, 2], [2, 2], [0, 0],
                                        [1, 1], False, idx), 20, flush)
        bound = max(bbytes / HBM_BYTES_PER_S, bops / F32_FLOPS_PER_S)
        log(f"[times] K2b {list(shape)} bf16: kernel {ms:.4f} ms, bound "
            f"{bound * 1e3:.4f} ms ({bbytes / 1e6:.1f} MB), plain "
            f"{plain:.4f} ms, max_pool2d_with_indices_backward {lib:.4f} ms")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bytes", bbytes), ("ops", bops)):
            k2b[k] += v
        del x, g, xn, gn, idx
    for name, d in (("K2", k2), ("K2b", k2b)):
        d["bound"] = max(d["bytes"] / HBM_BYTES_PER_S,
                         d["ops"] / F32_FLOPS_PER_S) * 1e3
        log(f"[times] {name} five pools of one {chunk}-frame chunk: kernel "
            f"{d['ms']:.4f} ms, bound {d['bound']:.4f} ms, plain "
            f"{d['plain_ms']:.4f} ms, library {d['library_ms']:.4f} ms")

    OH, OW = cfg.out_size
    feats = torch.randn((main_boxes.shape[0], OH, OW, cfg.emb_features),
                        generator=dgen, device=dev).bfloat16()
    k1_ms = time_cuda(lambda: roi_align(feats, main_boxes, crop), 100, flush)
    k1_plain = time_cuda(lambda: roi_align_ref(feats, main_boxes, crop), 100,
                         flush)
    k1_bytes = roi_sampled_bytes(feats, main_boxes, crop,
                                 _sample_grid(main_boxes, crop))
    k1_out = main_boxes.shape[0] * main_boxes.shape[1] * 25 * feats.shape[-1]
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S,
                   11 * k1_out / F32_FLOPS_PER_S) * 1e3
    # the launch alone, with the output made beforehand: the wrapper's own
    # work around it (checks, torch.empty) runs on the host
    k1y = k1_yardsticks(feats, main_boxes, crop, flush)
    out = torch.empty((*main_boxes.shape[:2], *crop, feats.shape[-1]),
                      dtype=feats.dtype, device=dev)
    lib, stream = native.library(), native.current_stream(feats)
    log(f"[times] K1 {list(feats.shape)} bf16 x {main_boxes.shape[1]} boxes: "
        f"wrapper {k1_ms:.4f} ms (launch alone {k1y['launch_ms']:.4f} ms, "
        f"device time {k1y['device_ms']:.4f} ms by {k1y['device_ms_by']}; "
        f"the kernel "
        f"computes the sample grid), bound {k1_bound:.5f} ms "
        f"({k1_bytes / 1e6:.2f} MB; launch alone at "
        f"{k1_bound / k1y['launch_ms']:.3f} of it), plain {k1_plain:.4f} ms; "
        f"no single PyTorch call computes it: F.grid_sample at the same "
        f"centres (the same reads and writes, not the same function) "
        f"{k1y['grid_sample_ms']:.4f} ms [{smi}]")
    g = torch.randn(out.shape, generator=dgen, device=dev).bfloat16()
    k1b_ms = time_cuda(lambda: roi_align_bwd(g, main_boxes, (OH, OW),
                                             torch.bfloat16), 100, flush)
    k1b_plain = time_cuda(lambda: roi_align_bwd_ref(
        g, main_boxes, (OH, OW), torch.bfloat16), 100, flush)
    # the launch alone, with the output made beforehand
    df = torch.empty(feats.shape, dtype=torch.bfloat16, device=dev)
    k1b_bare = time_cuda(lambda: native.check(lib.din_roi_align_bwd(
        g.data_ptr(), main_boxes.data_ptr(), df.data_ptr(), *feats.shape,
        main_boxes.shape[1], *crop, native.DTYPE_BF16, stream),
        "roi_align_bwd"), 100, flush)
    # g as the trunk's channel-major flatten hands it over: the wrapper
    # copies it to contiguous first
    g_cm = g.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)
    k1b_copy = time_cuda(lambda: g_cm.contiguous(), 100, flush)
    k1b_cm = time_cuda(lambda: roi_align_bwd(g_cm, main_boxes, (OH, OW),
                                             torch.bfloat16), 100, flush)
    # read the g rows of the samples in range and the boxes once, write
    # d(features) once; 4 products and 4 sums per sample in range and channel
    ys, xs = (t.cpu() for t in _sample_grid(main_boxes, crop))
    in_range = (((ys >= 0) & (ys <= OH - 1))[..., :, None]
                & ((xs >= 0) & (xs <= OW - 1))[..., None, :])
    k1b_samples = int(in_range.sum())
    C1 = feats.shape[-1]
    k1b_bytes = (k1b_samples * C1 * g.element_size() + main_boxes.numel() * 4
                 + feats.numel() * feats.element_size())
    k1b_bound = max(k1b_bytes / HBM_BYTES_PER_S,
                    8 * k1b_samples * C1 / F32_FLOPS_PER_S) * 1e3
    log(f"[times] K1b {list(g.shape)} bf16 -> {list(feats.shape)}: wrapper "
        f"{k1b_ms:.4f} ms (launch alone {k1b_bare:.4f} ms; the kernel "
        f"computes the sample grid and writes every element once), bound "
        f"{k1b_bound:.5f} ms ({k1b_bytes / 1e6:.2f} MB, {k1b_samples} of "
        f"{in_range.numel()} samples in range), plain {k1b_plain:.4f} ms, no "
        f"single PyTorch call computes it; from a channel-major g: wrapper "
        f"{k1b_cm:.4f} ms, of which the copy to contiguous {k1b_copy:.4f} ms "
        f"({g.numel() * g.element_size() / 1e6:.2f} MB each way)")
    del g, g_cm, df

    # K1 and K1b at the collective path's shapes: a training step's and a
    # serving call's 20 frames of 15x23, 13 boxes a frame, 4 zero-padded
    cshape = (20, 15, 23, 512)
    cf = torch.randn(cshape, generator=dgen, device=dev).bfloat16()
    cb = cad_boxes(20, 13, 4, 15, 23, gen).to(dev)
    cad_times = {}
    cad_times["k1_ms"] = time_cuda(lambda: roi_align(cf, cb, crop), 100,
                                   flush)
    cad_times["k1_plain"] = time_cuda(lambda: roi_align_ref(cf, cb, crop),
                                      100, flush)
    cbytes = roi_sampled_bytes(cf, cb, crop, _sample_grid(cb, crop))
    ys, xs = (t.cpu() for t in _sample_grid(cb, crop))
    c_in = int((((ys >= 0) & (ys <= 14))[..., :, None]
                & ((xs >= 0) & (xs <= 22))[..., None, :]).sum())
    # 4 corner reads blended: 11 operations per sample in range and channel
    cad_times["k1_bound"] = max(cbytes / HBM_BYTES_PER_S,
                                11 * c_in * 512 / F32_FLOPS_PER_S) * 1e3
    cg = torch.randn((20, 13, *crop, 512), generator=dgen,
                     device=dev).bfloat16()
    cad_times["k1b_ms"] = time_cuda(lambda: roi_align_bwd(
        cg, cb, (15, 23), torch.bfloat16), 100, flush)
    cad_times["k1b_plain"] = time_cuda(lambda: roi_align_bwd_ref(
        cg, cb, (15, 23), torch.bfloat16), 100, flush)
    cbbytes = (c_in * 512 * cg.element_size() + cb.numel() * 4
               + cf.numel() * cf.element_size())
    cad_times["k1b_bound"] = max(cbbytes / HBM_BYTES_PER_S,
                                 8 * c_in * 512 / F32_FLOPS_PER_S) * 1e3
    cad_times.update({"k1_" + k: v for k, v in
                      k1_yardsticks(cf, cb, crop, flush).items()})
    log(f"[times] K1 {list(cshape)} bf16 x 13 boxes (4 zero-padded; "
        f"{c_in} of {ys.shape[0] * ys.shape[1] * 25} samples in range): "
        f"wrapper {cad_times['k1_ms']:.4f} ms, launch alone "
        f"{cad_times['k1_launch_ms']:.4f} ms, device time "
        f"{cad_times['k1_device_ms']:.4f} ms (by "
        f"{cad_times['k1_device_ms_by']}), F.grid_sample "
        f"{cad_times['k1_grid_sample_ms']:.4f} ms, bound "
        f"{cad_times['k1_bound']:.5f} ms ({cbytes / 1e6:.2f} MB), plain "
        f"{cad_times['k1_plain']:.4f} ms; K1b {[20, 13, *crop, 512]} bf16 -> "
        f"{list(cshape)}: wrapper {cad_times['k1b_ms']:.4f} ms, bound "
        f"{cad_times['k1b_bound']:.5f} ms ({cbbytes / 1e6:.2f} MB), plain "
        f"{cad_times['k1b_plain']:.4f} ms; no single PyTorch call computes "
        f"either [{smi}]")
    del cf, cb, cg

    # K1 and K1b at the baselines' shapes: a training step's 20 frames of
    # 23x40, 12 person-sized boxes a frame, 5x5 crops and HiGCIN's 7x7
    bf = torch.randn((20, 23, 40, 512), generator=dgen, device=dev).bfloat16()
    bb = cad_boxes(20, 12, 0, 23, 40, gen).to(dev)
    base_times = {crop_b: roi_times(bf, bb, crop_b, dgen, flush)
                  for crop_b in ((5, 5), (7, 7))}
    for crop_b, bt in base_times.items():
        log(f"[times] K1 and K1b at [20,23,40,512] bf16 x 12 boxes, crop "
            f"{crop_b[0]}x{crop_b[1]} ({bt['in_range']} of {bt['samples']} "
            f"samples in range): K1 wrapper {bt['k1_ms']:.4f} ms, launch "
            f"alone {bt['k1_launch_ms']:.4f} ms, device time "
            f"{bt['k1_device_ms']:.4f} ms (by {bt['k1_device_ms_by']}), "
            f"F.grid_sample "
            f"{bt['k1_grid_sample_ms']:.4f} ms, bound "
            f"{bt['k1_bound']:.5f} ms ({bt['k1_mb']:.2f} MB), plain "
            f"{bt['k1_plain']:.4f} ms; K1b wrapper {bt['k1b_ms']:.4f} ms, "
            f"bound {bt['k1b_bound']:.5f} ms ({bt['k1b_mb']:.2f} MB), plain "
            f"{bt['k1b_plain']:.4f} ms; no single PyTorch call computes "
            f"either [{smi}]")
    del bf, bb

    # K3 at one serving chunk; the yardsticks: the unfused cuDNN stem in
    # bf16 channels_last, and the route the model takes when the stem
    # needs its gradient (cuDNN convs with bias, ReLU, K2)
    sx, sw0, sb0, sw2, sb2 = stem_inputs((chunk, H, W, 3), torch.bfloat16,
                                         dgen)
    xn = sx.permute(0, 3, 1, 2)
    k3_ms = time_cuda(lambda: fused_stem(sx, sw0, sb0, sw2, sb2), 20, flush)
    k3_plain = time_cuda(lambda: fused_stem_ref(sx, sw0, sb0, sw2, sb2), 5,
                         flush)
    k3_lib = time_cuda(lambda: F.max_pool2d(F.relu(F.conv2d(F.relu(
        F.conv2d(xn, sw0, sb0, padding=1)), sw2, sb2, padding=1)), 2), 20,
        flush)
    xl = xn.contiguous(memory_format=torch.channels_last)
    k3_layers = time_cuda(lambda: max_pool_2x2(F.relu(F.conv2d(F.relu(
        F.conv2d(xl, sw0, sb0, padding=1)), sw2, sb2, padding=1)).permute(
        0, 2, 3, 1).contiguous()), 20, flush)
    k3_ops = 2 * chunk * H * W * 64 * (27 + 576)
    k3_bytes = (sx.numel() + chunk * (H // 2) * (W // 2) * 64 + sw0.numel()
                + sb0.numel() + sw2.numel() + sb2.numel()) * sx.element_size()
    k3_bound = max(k3_ops / BF16_TENSOR_FLOPS_PER_S,
                   k3_bytes / HBM_BYTES_PER_S) * 1e3
    k3_by = ("operations" if k3_ops / BF16_TENSOR_FLOPS_PER_S
             >= k3_bytes / HBM_BYTES_PER_S else "bytes")
    log(f"[times] K3 {[chunk, H, W, 3]} bf16 -> {[chunk, H // 2, W // 2, 64]}:"
        f" kernel {k3_ms:.4f} ms ({k3_ops / k3_ms / 1e9:.1f} TFLOP/s, "
        f"{k3_bound / k3_ms:.3f} of the bound's rate), bound "
        f"{k3_bound:.4f} ms ({k3_ops / 1e9:.1f} GFLOP at the dense bf16 rate, "
        f"{k3_bytes / 1e6:.1f} MB; bound by {k3_by}), plain {k3_plain:.4f} "
        f"ms, unfused cuDNN stem (conv, ReLU x2, F.max_pool2d) {k3_lib:.4f} "
        f"ms (K3 / cuDNN stem = {k3_ms / k3_lib:.4f}), the model's layer "
        f"route (cuDNN convs, ReLU, K2) {k3_layers:.4f} ms")
    del sx, sw0, sb0, sw2, sb2, xn, xl
    torch.cuda.empty_cache()
    log(f"[times] done in {time.time() - t0:.2f} s")

    # -- 8. Volleyball on disk ------------------------------------------------
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        s1_copy = Path(tmp) / disk_s1.name
        shutil.move(disk_s1, s1_copy)
        disk_counts = volleyball_on_disk(
            dev, Path(tmp), str(s1_copy), smi,
            mcfg.batch_size / ms_step * 1e3, reset_counts, read_counts)

    # -- 9. the Collective Activity path --------------------------------------
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        cad_run = collective_path(dev, Path(tmp), smi, reset_counts,
                                  read_counts)

    # -- 10. serving phase 4's trained checkpoint ---------------------------
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        paths = [shutil.move(p, Path(tmp) / p.name)
                 for p in (serve_ckpt, serve_ref)]
        ckpt_run = checkpoint_serving(dev, Path(tmp), *map(str, paths), smi,
                                      reset_counts, read_counts)

    # -- 11. the DIN variants at full width ---------------------------------
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        s1_copy = shutil.move(variants_s1, Path(tmp) / variants_s1.name)
        variant_run = variants_path(dev, Path(tmp), str(s1_copy), smi,
                                    reset_counts, read_counts)

    # -- 12. the ResNet-18 baselines at full width ---------------------------
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        baseline_run = baselines_path(dev, Path(tmp), smi, reset_counts,
                                      read_counts)

    # -- 13. Inception-v3, VGG-19, ResNet-50 and AlexNet ---------------------
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        backbone_run = backbones_path(dev, Path(tmp), smi, reset_counts,
                                      read_counts)

    # -- 14. the serving artifact -------------------------------------------
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        ckpt_copy = shutil.move(export_ckpt, Path(tmp) / export_ckpt.name)
        export_run = export_path(dev, Path(tmp), str(ckpt_copy), smi,
                                 reset_counts, read_counts)

    # -- 15. the training infrastructure -----------------------------------
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        infra_run = training_infra_path(dev, Path(tmp), smi, reset_counts,
                                        read_counts)

    # -- 16. more than one rank ---------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        ranks_run = ranks_path(dev, Path(tmp), smi)
    log(f"[total] {time.time() - t_all:.1f} s")

    def launches(name):
        return {"launches": train_counts[name],
                "launches_by_path": {"serve": serve_counts[name],
                                     "train": train_counts[name],
                                     "stage1": s1_counts[name],
                                     **{path: c[name] for path, c in
                                        disk_counts.items()},
                                     **{path: c[name] for path, c in
                                        cad_run["counts"].items()},
                                     **{path: c[name] for path, c in
                                        ckpt_run["counts"].items()},
                                     **{path: c[name] for path, c in
                                        variant_run["counts"].items()},
                                     **{path: c[name] for path, c in
                                        baseline_run["counts"].items()},
                                     **{path: c[name] for path, c in
                                        backbone_run["counts"].items()},
                                     **{path: c[name] for path, c in
                                        export_run["counts"].items()},
                                     **{path: c[name] for path, c in
                                        infra_run["counts"].items()},
                                     **{path: c[name] for path, c in
                                        ranks_run["counts"].items()}}}

    def yardsticks(kernel, t):
        """K1's launch alone, device time (and how it was read) and
        F.grid_sample, from ``t``."""
        if kernel != "k1":
            return {}
        return {k: t["k1_" + k] for k in ("launch_ms", "device_ms",
                                          "device_ms_by", "grid_sample_ms")}

    def baseline_shapes(kernel):
        return {f"{k[0]}x{k[1]}": {
            "shape": [20, 23, 40, 512], "boxes": 12, "crop": list(k),
            "max_abs_err": base_errs[k][kernel + "_bf16"],
            "ms": t[kernel + "_ms"], "plain_ms": t[kernel + "_plain"],
            "bound_ms": t[kernel + "_bound"], **yardsticks(kernel, t)}
            for k, t in base_times.items()}

    def backbone_shapes(kernel):
        """K1's or K1b's errors and times at phase 13's maps."""
        return {key: {
            "shape": k["shape"], "boxes": k["boxes"],
            "zero_padded": k["zero_padded"], "crop": [5, 5],
            "max_abs_err": k["errs"][kernel + "_bf16"],
            "ms": k["times"][kernel + "_ms"],
            "plain_ms": k["times"][kernel + "_plain"],
            "bound_ms": k["times"][kernel + "_bound"],
            **yardsticks(kernel, k["times"])}
            for key, k in backbone_run["kernels"].items()}

    kernels = [
        {"name": "roi_align", "route": "cuda",
         "source": "din_tpu_torch/csrc/roi_align.cu",
         "replaces": "din_tpu/ops/roi_align.py:197", **launches("roi_align"),
         "max_abs_err": roi_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None,
         **yardsticks("k1", {"k1_" + k: v for k, v in k1y.items()}),
         "grid_sample_is": "F.grid_sample at the same sample centres: the "
                           "same reads and writes, not the same function "
                           "(it differs at the border)",
         "collective": {"shape": [20, 15, 23, 512], "boxes": 13,
                        "zero_padded": 4,
                        "max_abs_err": cad["k1_bf16"],
                        "ms": cad_times["k1_ms"],
                        "plain_ms": cad_times["k1_plain"],
                        "bound_ms": cad_times["k1_bound"],
                        **yardsticks("k1", cad_times)},
         "baselines": baseline_shapes("k1"),
         "backbones": backbone_shapes("k1")},
        {"name": "max_pool_2x2", "route": "cuda",
         "source": "din_tpu_torch/csrc/max_pool_2x2.cu",
         "replaces": "din_tpu/ops/pool.py:48", **launches("max_pool_2x2"),
         "max_abs_err": pool_err, "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound"], "bound_by": "bytes",
         "library_ms": k2["library_ms"]},
        {"name": "max_pool_2x2_bwd", "route": "cuda",
         "source": "din_tpu_torch/csrc/max_pool_2x2_bwd.cu",
         "replaces": "din_tpu/ops/pool.py:57",
         **launches("max_pool_2x2_bwd"), "max_abs_err": pool_bwd_err,
         "ms": k2b["ms"], "plain_ms": k2b["plain_ms"],
         "bound_ms": k2b["bound"], "bound_by": "bytes",
         "library_ms": k2b["library_ms"]},
        {"name": "roi_align_bwd", "route": "cuda",
         "source": "din_tpu_torch/csrc/roi_align_bwd.cu", "replaces": None,
         "note": "no Pallas kernel: din_tpu computes this gradient with XLA "
                 "einsums (din_tpu/ops/roi_align.py:302-309)",
         **launches("roi_align_bwd"), "max_abs_err": roi_bwd_err,
         "ms": k1b_ms, "launch_ms": k1b_bare, "plain_ms": k1b_plain,
         "bound_ms": k1b_bound, "bound_by": "bytes", "library_ms": None,
         "channel_major_ms": k1b_cm, "g_copy_ms": k1b_copy,
         "collective": {"shape": [20, 15, 23, 512], "boxes": 13,
                        "zero_padded": 4,
                        "max_abs_err": cad["k1b_bf16"],
                        "ms": cad_times["k1b_ms"],
                        "plain_ms": cad_times["k1b_plain"],
                        "bound_ms": cad_times["k1b_bound"]},
         "baselines": baseline_shapes("k1b"),
         "backbones": backbone_shapes("k1b")},
        {"name": "fused_stem", "route": "cuda",
         "source": "din_tpu_torch/csrc/fused_stem.cu",
         "replaces": "din_tpu/ops/stem_kernel.py:68",
         **launches("fused_stem"), "max_abs_err": stem_err, "ms": k3_ms,
         "plain_ms": k3_plain, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": k3_lib, "ms_over_library_ms": k3_ms / k3_lib},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
