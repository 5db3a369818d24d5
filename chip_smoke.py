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
   including border, outside and zero-area boxes (f32 within 1e-5, resp.
   1e-5 of max|df| for K1b, whose atomics add in a varying order; bf16
   within one bf16 ulp);
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
4. full-width stage 1 (``volleyball_stage1``) through ``train_net``: one
   epoch of 3 Adam steps at batch 8 (T=1), an eval pass and a stage-1
   component file, with the launch counts of all five kernels (0 just
   before, read just after, against counts derived from ``auto_chunk``);
   ms per step, clips/s and peak memory on one batch; then the flagship
   stage 2 through ``train_net`` started from that file with
   ``--stage1-model-path``: ``backbone.*`` and ``fc_emb_1`` equal the
   file's tensors before the first step, 3 steps at batch 2, an eval pass, a
   checkpoint, the launch counts; finite losses; the checkpoint reloaded as
   ``--stage2-model-path`` gives equal params and Adam state;
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
   the model takes with a gradient; for K1 the wrapper and the launch
   alone).

The last lines are the kernels' JSON line, the card's nvidia-smi line and
the result line ``{"ok": true, "device": {...}}``.  With no card, or run
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import re
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


def check_params(got: dict, want: dict, steps: int, lr: float,
                 what: str, share_bound=0.1) -> tuple:
    """The parameter bounds of tests/test_torch_train.py after a ReLU or
    pool flip: no element more than 2*lr per step apart (Adam moves each by
    about lr whatever its gradient's size), and elementwise 2e-5 for all
    but ``share_bound`` (10 %) of a tensor's elements (None: the share is
    only reported).  The flip bound applies: f32 sums on the two devices
    differ, and a pre-activation, pool window, actor max or DIN sample
    position that close to a switch takes the other branch.  Returns the
    largest difference, the largest share beyond 2e-5 and its tensor."""
    worst = share_worst = 0.0
    share_name = ""
    for name, w in want.items():
        diff = (got[name].float().cpu() - w.float().cpu()).abs()
        share = float((diff > 2e-5).float().mean())
        worst = max(worst, float(diff.max()))
        if share > share_worst:
            share_worst, share_name = share, name
        require(float(diff.max()) <= steps * 2 * lr,
                f"{what}: {name} differs by {float(diff.max())}")
        require(share_bound is None or share <= share_bound,
                f"{what}: {name} has {share:.4f} of elements beyond 2e-5")
    return worst, share_worst, share_name


def train_card_vs_cpu(cfg, cpu_model, steps: int = 3,
                      free_share_bound=0.1) -> dict:
    """``steps`` training steps of ``cpu_model`` on the CPU and, from copies
    of it, on the card: once from the CPU's state of each step (forced: one
    step's loss and update) and once along the card's own trajectory
    (free), on the batches of ``train_net``'s first epoch.  Forced losses
    within rtol 1e-4 of the CPU's; parameters within ``check_params``'s
    bounds, the free trajectory's share beyond 2e-5 within
    ``free_share_bound``.  Returns the losses and the largest
    differences."""
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
    perr = share = 0.0
    for b in (b for _, b in zip(range(steps), loader)):
        forced.load_state_dict(cpu_model.state_dict())
        forced_opt.load_state_dict(copy.deepcopy(cpu_opt.state_dict()))
        for name, m, opt, d in (("cpu", cpu_model, cpu_opt, "cpu"),
                                ("forced", forced, forced_opt, dev),
                                ("free", free, free_opt, dev)):
            losses[name].append(float(train_step(
                m, opt, to_device(b, torch.device(d)), cfg)["loss"]))
        e, sh, _ = check_params(forced.state_dict(), cpu_model.state_dict(),
                                1, lr, "card vs CPU, one step")
        perr, share = max(perr, e), max(share, sh)
    lerr = max(abs(a - b) / abs(b)
               for a, b in zip(losses["forced"], losses["cpu"]))
    require(lerr <= 1e-4, f"training losses card {losses['forced']} vs "
            f"CPU {losses['cpu']}")
    free_perr, free_share, free_name = check_params(
        free.state_dict(), cpu_model.state_dict(), steps, lr,
        f"card vs CPU, {steps} free steps", free_share_bound)
    free_lerr = max(abs(a - b) / abs(b)
                    for a, b in zip(losses["free"], losses["cpu"]))
    return dict(losses=losses, lerr=lerr, perr=perr, share=share,
                free_lerr=free_lerr, free_perr=free_perr,
                free_share=free_share, free_name=free_name,
                free_share_bound=free_share_bound)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.data.synthetic import (make_synthetic_batch,
                                              return_dataset)
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.experiments.profile_training import breakdown
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

    wrappers = {"roi_align": roi_align, "max_pool_2x2": max_pool_2x2,
                "max_pool_2x2_bwd": max_pool_2x2_bwd,
                "roi_align_bwd": roi_align_bwd, "fused_stem": fused_stem}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {k: w.launches for k, w in wrappers.items()}

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
    ref = roi_align_ref(feats32, kboxes, crop)
    torch.cuda.synchronize()
    err32 = (got - ref).abs().max().item()
    require(err32 <= 1e-5, f"roi_align f32 max |err| {err32} > 1e-5")
    require(bool((got[:, 3] == 0).all()), "fully-outside box is not 0")
    feats16 = feats32.bfloat16()
    got = roi_align(feats16, kboxes, crop)
    ref = roi_align_ref(feats16, kboxes, crop)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    ulp = bf16_ulp(torch.maximum(got.float().abs(), ref.float().abs()))
    require(bool((diff <= ulp).all()),
            f"roi_align bf16 off by more than 1 ulp: max |err| "
            f"{diff.max().item()}")
    roi_err = diff.max().item()
    log(f"[kernels] K1 roi_align vs plain at [20,22,40,512] x 12 boxes: "
        f"f32 max |err| {err32:.3g} (<= 1e-5), bf16 max |err| {roi_err:.3g} "
        f"(<= 1 bf16 ulp)")

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
        f"max|df| = {1e-5 * scale:.3g}; atomics add in a varying order), "
        f"bf16 max |err| {roi_bwd_err:.3g} against the f32 result, largest "
        f"excess over 1 bf16 ulp {max(excess, 0.0):.3g} (<= 1e-5 * max|df| "
        f"= {1e-5 * scale16:.3g}); "
        f"{int((diff > ulp).sum())} of {diff.numel()} elements beyond 1 ulp")
    del feats32, feats16, gb, gb16, got, ref, diff, ulp
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

    def expected_counts(c, n_val):
        """Launches of ``steps`` training steps (every layer one by one: the
        stem needs its gradient) and an eval pass over ``n_val`` clips (no
        gradient: the fused stem and 4 pools per chunk)."""
        H, W = c.image_size
        step_frames = c.batch_size * (1 if c.training_stage == 1
                                      else c.num_frames)
        step_chunks = step_frames // auto_chunk(
            step_frames, H, W, c.frame_chunk, c.train_backbone)
        evals = -(-n_val // c.test_batch_size)
        eval_frames = c.test_batch_size * c.num_frames
        eval_chunks = eval_frames // auto_chunk(
            eval_frames, H, W, c.frame_chunk, c.train_backbone)
        return ({"max_pool_2x2": 5 * steps * step_chunks
                 + 4 * evals * eval_chunks,
                 "roi_align": steps + evals,
                 "max_pool_2x2_bwd": 5 * steps * step_chunks,
                 "roi_align_bwd": steps,
                 "fused_stem": evals * eval_chunks},
                f"per step 5 pools x {step_chunks} chunk(s) of "
                f"{step_frames // step_chunks} frames and 1 RoIAlign; eval "
                f"{evals} calls x {eval_chunks} chunk(s) of the fused stem "
                f"and 4 pools")

    def log_losses(path: Path, what: str) -> list:
        losses = [float(v) for v in re.findall(r"Loss: ([-+0-9.eEnaif]+)",
                                               path.read_text())]
        require(len(losses) == 2 and all(math.isfinite(v) for v in losses),
                f"{what}: losses in log.txt: {losses}")
        return losses

    run_root = native.BUILD_DIR.parent / "smoke_runs"
    run_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=run_root) as tmp:
        s1_argv = ["--preset", "volleyball_stage1", "--data-path",
                   "synthetic", "--max-epoch", "1", "--result-root", tmp,
                   "--exp-name", "stage1"]
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
            f"eval), {steps} steps + eval of {len(s1_val)} clips + component "
            f"file in {s1_s:.2f} s (host clock, synthetic clips made on the "
            f"host included); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        log(f"[stage1] launches {s1_counts}, expected {s1_expect} ({how})")
        require(s1_counts == s1_expect and min(s1_expect.values()) > 0,
                "stage-1 launch counts are off")
        s1_losses = log_losses(Path(tmp) / "stage1" / "log.txt", "stage 1")
        s1_path = s1_best.get("checkpoint")
        require(s1_path is not None and Path(s1_path).exists()
                and Path(s1_path).name.startswith("stage1_epoch1_"),
                f"no stage-1 component file: {s1_path}")
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
        model, optimizer, _ = setup_training(s1cfg)
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
            f"{max_pool_2x2_bwd.g_copies} times")
        require(train_counts == expect and min(expect.values()) > 0,
                "training launch counts are off")
        train_losses = log_losses(Path(tmp) / "train" / "log.txt", "stage 2")
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
        del model, optimizer, saved, state, ostate
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
    prof = breakdown(lambda: train_step(model, optimizer, mbatch, mcfg), 1)
    busy = prof["busy_us"]
    require(busy > 0, "the profiler recorded no device time")
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
    out = torch.empty((*main_boxes.shape[:2], *crop, feats.shape[-1]),
                      dtype=feats.dtype, device=dev)
    lib, stream = native.library(), native.current_stream(feats)
    k1_bare = time_cuda(lambda: native.check(lib.din_roi_align(
        feats.data_ptr(), main_boxes.data_ptr(), out.data_ptr(),
        *feats.shape, main_boxes.shape[1], *crop,
        native.DTYPE_BF16, stream), "roi_align"), 100, flush)
    log(f"[times] K1 {list(feats.shape)} bf16 x {main_boxes.shape[1]} boxes: "
        f"wrapper {k1_ms:.4f} ms (launch alone {k1_bare:.4f} ms; the kernel "
        f"computes the sample grid), bound {k1_bound:.5f} ms "
        f"({k1_bytes / 1e6:.2f} MB), plain {k1_plain:.4f} ms, no single "
        f"PyTorch call computes it")
    ys, xs = (t.contiguous() for t in _sample_grid(main_boxes, crop))

    g = torch.randn(out.shape, generator=dgen, device=dev).bfloat16()
    k1b_ms = time_cuda(lambda: roi_align_bwd(g, main_boxes, (OH, OW),
                                             torch.bfloat16), 100, flush)
    k1b_plain = time_cuda(lambda: roi_align_bwd_ref(
        g, main_boxes, (OH, OW), torch.bfloat16), 100, flush)
    df32 = torch.zeros(feats.shape, dtype=torch.float32, device=dev)
    k1b_bare = time_cuda(lambda: native.check(lib.din_roi_align_bwd(
        g.data_ptr(), ys.data_ptr(), xs.data_ptr(), df32.data_ptr(),
        *feats.shape, main_boxes.shape[1], *crop, native.DTYPE_BF16,
        stream), "roi_align_bwd"), 100, flush)
    # read g and the sample centres once, write d(features) once; 4 products
    # and 4 sums per sample and channel
    k1b_bytes = (g.numel() * g.element_size() + (ys.numel() + xs.numel()) * 4
                 + feats.numel() * feats.element_size())
    k1b_bound = max(k1b_bytes / HBM_BYTES_PER_S,
                    8 * g.numel() / F32_FLOPS_PER_S) * 1e3
    log(f"[times] K1b {list(g.shape)} bf16 -> {list(feats.shape)}: wrapper "
        f"{k1b_ms:.4f} ms (launch alone, on a zeroed f32 map, "
        f"{k1b_bare:.4f} ms), bound {k1b_bound:.5f} ms "
        f"({k1b_bytes / 1e6:.2f} MB), plain {k1b_plain:.4f} ms, no single "
        f"PyTorch call computes it")

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
    log(f"[times] done in {time.time() - t0:.2f} s")
    log(f"[total] {time.time() - t_all:.1f} s")

    def launches(name):
        return {"launches": train_counts[name],
                "launches_by_path": {"serve": serve_counts[name],
                                     "train": train_counts[name],
                                     "stage1": s1_counts[name]}}

    kernels = [
        {"name": "roi_align", "route": "cuda",
         "source": "din_tpu_torch/csrc/roi_align.cu",
         "replaces": "din_tpu/ops/roi_align.py:197", **launches("roi_align"),
         "max_abs_err": roi_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None},
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
         "ms": k1b_ms, "plain_ms": k1b_plain, "bound_ms": k1b_bound,
         "bound_by": "bytes", "library_ms": None},
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
