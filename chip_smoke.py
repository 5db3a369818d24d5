#!/usr/bin/env python3
"""Smoke run of din_tpu_torch on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each timed, any failure exits non-zero:

1. setup: the card's name and power limit (nvidia-smi), and the build of the
   hand-written CUDA kernels with plain nvcc (seconds);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: K2 ``max_pool_2x2`` at the five VGG-16 pool inputs of a
   720x1280 frame (f32 and bf16, bit-equal), K1 ``roi_align`` on a
   [20,22,40,512] map with 12 boxes per frame including border, outside and
   zero-area boxes (f32 atol 1e-5, bf16 within one bf16 ulp);
3. full-width serving of the flagship preset ``volleyball_stage2_dynamic``
   (VGG-16, 720x1280, T=10, N=12, bf16 backbone, f32 head) through
   ``Predictor(pad_to=2)`` with seeded random weights: three requests (1
   clip, 3 clips, the first clip again), checked for shape, finite rows
   summing to 1, the repeated clip's answer, and the launch counts of K1 and
   K2, which are set to 0 just before and read just after;
4. the port on the card (kernels) against the port on the CPU (plain
   versions) on one clip at T=3, 144x160, float32 with TF32 off, atol 1e-4;
5. each kernel's time at the main path's shapes beside its bound, its plain
   version's time and, for K2, ``F.max_pool2d``'s time.

The last lines are the kernels' JSON line, the card's nvidia-smi line and
the result line ``{"ok": true, "device": {...}}``.  With no card, or run
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores
# (both kernels compute in f32 registers)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.models.registry import build_model
    from din_tpu_torch.models.trunk import auto_chunk
    from din_tpu_torch.ops import native
    from din_tpu_torch.ops.pool import max_pool_2x2, max_pool_2x2_ref
    from din_tpu_torch.ops.roi_align import (_sample_grid, roi_align,
                                             roi_align_ref)

    dev = torch.device("cuda")
    t_all = time.time()

    # -- 1. setup ------------------------------------------------------------
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

    # -- 2. kernels against plain versions -------------------------------------
    t0 = time.time()
    gen = torch.Generator().manual_seed(SEED)
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    pool_shapes = [(2, 720, 1280, 64), (2, 360, 640, 128), (2, 180, 320, 256),
                   (2, 90, 160, 512), (2, 45, 80, 512), (2, 7, 9, 3)]
    pool_err = 0.0
    for shape in pool_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=dgen, device=dev).to(dtype)
            got, ref = max_pool_2x2(x), max_pool_2x2_ref(x)
            torch.cuda.synchronize()
            require(torch.equal(got, ref),
                    f"max_pool_2x2 != plain at {shape} {dtype}")
            pool_err = max(pool_err, (got.float() - ref.float()).abs().max()
                           .item())
    log(f"[kernels] K2 max_pool_2x2 == plain (torch.equal) at "
        f"{[s for s in pool_shapes]} f32+bf16")

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
    log(f"[kernels] done in {time.time() - t0:.2f} s")

    # -- 3. full-width serving ---------------------------------------------------
    t0 = time.time()
    cfg = PRESETS["volleyball_stage2_dynamic"]()
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, generator=gen)
    _randomize_din(model, gen)
    predictor = Predictor(cfg, model, pad_to=2)
    batch = make_synthetic_batch(cfg, 3, rng=np.random.RandomState(SEED))
    requests = [(batch["images"][:1], batch["boxes"][:1]),
                (batch["images"], batch["boxes"]),
                (batch["images"][:1], batch["boxes"][:1])]
    log(f"[serve] {cfg.backbone} {cfg.image_size[0]}x{cfg.image_size[1]} "
        f"T={cfg.num_frames} N={cfg.num_boxes} lite={cfg.lite_dim} "
        f"compute={cfg.compute_dtype}; model built in "
        f"{time.time() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    max_pool_2x2.launches = 0
    roi_align.launches = 0
    outs, req_ms = [], []
    for images, boxes in requests:
        tr = time.time()
        outs.append(predictor(images, boxes)["activities"])
        torch.cuda.synchronize()
        req_ms.append((time.time() - tr) * 1e3)
    k2_launches, k1_launches = max_pool_2x2.launches, roi_align.launches
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
    log(f"[serve] launches: K2 max_pool_2x2 {k2_launches} (expected "
        f"{5 * chunks * padded_calls} = 5 pools x {chunks} chunks x "
        f"{padded_calls} padded calls), K1 roi_align {k1_launches} (expected "
        f"{padded_calls})")
    require(k2_launches == 5 * chunks * padded_calls > 0,
            "K2 launch count is off")
    require(k1_launches == padded_calls > 0, "K1 launch count is off")
    main_boxes = torch.from_numpy(
        np.concatenate([batch["boxes"][:1]] * 2).reshape(-1, cfg.num_boxes,
                                                         4)).to(dev)
    del predictor, model
    torch.cuda.empty_cache()
    log(f"[serve] done in {time.time() - t0:.2f} s")

    # -- 4. card against CPU -----------------------------------------------------
    t0 = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = cfg.replace(image_size=(144, 160), out_size=(4, 5), num_frames=3,
                        compute_dtype="float32")
    gen = torch.Generator().manual_seed(SEED)
    cpu_model = build_model(small, device="cpu", generator=gen)
    _randomize_din(cpu_model, gen)
    clip = make_synthetic_batch(small, 1, rng=np.random.RandomState(SEED + 1))
    on_card = Predictor(small, copy.deepcopy(cpu_model))(
        clip["images"], clip["boxes"])["activities"]
    on_cpu = Predictor(small, cpu_model, device="cpu")(
        clip["images"], clip["boxes"])["activities"]
    err = float(np.abs(on_card - on_cpu).max())
    require(err <= 1e-4, f"card vs CPU max |diff| {err} > 1e-4")
    log(f"[card-vs-cpu] 1 clip T=3 144x160 f32 (TF32 off): max |diff| of "
        f"posteriors {err:.3g} (<= 1e-4); card {np.round(on_card[0], 4)}")
    log(f"[card-vs-cpu] done in {time.time() - t0:.2f} s")

    # -- 5. times ----------------------------------------------------------------
    t0 = time.time()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    chunk = 2 * cfg.num_frames // chunks
    H, W = cfg.image_size
    pool_in = [(chunk, H, W, 64), (chunk, H // 2, W // 2, 128),
               (chunk, H // 4, W // 4, 256), (chunk, H // 8, W // 8, 512),
               (chunk, H // 16, W // 16, 512)]
    k2 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    for shape in pool_in:
        x = torch.randn(shape, generator=dgen, device=dev).bfloat16()
        y_elems = shape[0] * (shape[1] // 2) * (shape[2] // 2) * shape[3]
        nbytes = (x.numel() + y_elems) * x.element_size()
        ms = time_cuda(lambda: max_pool_2x2(x), 20, flush)
        plain = time_cuda(lambda: max_pool_2x2_ref(x), 20, flush)
        lib = time_cuda(lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2), 20,
                        flush)
        bound = max(nbytes / HBM_BYTES_PER_S, 3 * y_elems / F32_FLOPS_PER_S)
        log(f"[times] K2 {list(shape)} bf16: kernel {ms:.4f} ms, bound "
            f"{bound * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB), plain "
            f"{plain:.4f} ms, F.max_pool2d {lib:.4f} ms")
        k2["ms"] += ms
        k2["plain_ms"] += plain
        k2["library_ms"] += lib
        k2["bytes"] += nbytes
        k2["ops"] += 3 * y_elems
    k2_bound = max(k2["bytes"] / HBM_BYTES_PER_S,
                   k2["ops"] / F32_FLOPS_PER_S) * 1e3
    log(f"[times] K2 five pools of one {chunk}-frame chunk: kernel "
        f"{k2['ms']:.4f} ms, bound {k2_bound:.4f} ms, plain "
        f"{k2['plain_ms']:.4f} ms, F.max_pool2d {k2['library_ms']:.4f} ms")

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
    # the launch alone, with the sample centres and output made beforehand:
    # the wrapper's own torch ops (_sample_grid, empty) run on the host
    ys, xs = (t.contiguous() for t in _sample_grid(main_boxes, crop))
    out = torch.empty((*main_boxes.shape[:2], *crop, feats.shape[-1]),
                      dtype=feats.dtype, device=dev)
    lib, stream = native.library(), native.current_stream(feats)
    k1_bare = time_cuda(lambda: native.check(lib.din_roi_align(
        feats.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
        *feats.shape, main_boxes.shape[1], *crop,
        native.DTYPE_BF16, stream), "roi_align"), 100, flush)
    log(f"[times] K1 {list(feats.shape)} bf16 x {main_boxes.shape[1]} boxes: "
        f"wrapper {k1_ms:.4f} ms (launch alone {k1_bare:.4f} ms), bound "
        f"{k1_bound:.5f} ms ({k1_bytes / 1e6:.2f} MB), plain "
        f"{k1_plain:.4f} ms, no single PyTorch call computes it")
    log(f"[times] done in {time.time() - t0:.2f} s")
    log(f"[total] {time.time() - t_all:.1f} s")

    kernels = [
        {"name": "roi_align", "route": "cuda",
         "source": "din_tpu_torch/csrc/roi_align.cu",
         "replaces": "din_tpu/ops/roi_align.py:197", "launches": k1_launches,
         "max_abs_err": roi_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None},
        {"name": "max_pool_2x2", "route": "cuda",
         "source": "din_tpu_torch/csrc/max_pool_2x2.cu",
         "replaces": "din_tpu/ops/pool.py:48", "launches": k2_launches,
         "max_abs_err": pool_err, "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2_bound, "bound_by": "bytes",
         "library_ms": k2["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
