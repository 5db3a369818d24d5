"""What holds kernel K3 (``csrc/fused_stem.cu``) back on the card: its
warp-specialised roles, each timed alone.

    python -m din_tpu_torch.experiments.profile_stem [--frames 5]
        [--iters 20]

Builds ``csrc/fused_stem.cu`` three times with plain ``nvcc`` into
``build/torch_kernels/profile_stem/``: as the port builds it, with
``-DDIN_STEM_PRODUCER_ONLY`` (the consumer warpgroup hands every y1 buffer
back without conv1_2: the input loads and conv1_1 alone) and with
``-DDIN_STEM_CONSUMER_ONLY`` (the producers hand over y1 buffers without
computing them: conv1_2 on the tensor cores alone).  Times each on one
bf16 chunk [frames,720,1280,3] with CUDA events, the L2 cache flushed
before each launch, beside the unfused cuDNN stem; then reads the SASS of
the bf16 kernel (``cuobjdump``): its HGMMA (wgmma) instructions, and for
the producers' conv1_1 how many instructions lie between each FMA and the
FMA whose sum it continues (the dependent-issue latency of an FMA is about
4 cycles); ptxas's notes, if any, that it serialized the wgmmas.  Prints
one JSON line with the card's name and power limit.  The two diagnostic
builds compute wrong outputs; the port never loads them.  Needs a card and
the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from din_tpu_torch.ops import native

BUILDS = {"full": [], "producer_only": ["-DDIN_STEM_PRODUCER_ONLY"],
          "consumer_only": ["-DDIN_STEM_CONSUMER_ONLY"]}


def build(out_dir: Path) -> tuple:
    """The three libraries, compiled in parallel: (name -> path, ptxas's
    notes on the full build that say wgmma instructions were serialized)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = native.CSRC / "fused_stem.cu"
    procs = {}
    for name, defs in BUILDS.items():
        so = out_dir / f"fused_stem_{name}.so"
        cmd = [native._nvcc(), *native.NVCC_FLAGS, *defs, "-Xcompiler",
               "-fPIC", "-shared", "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs, serialized = {}, []
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} build:\n{log}")
        libs[name] = so
        if name == "full":
            serialized = [ln.strip() for ln in log.splitlines()
                          if "serialized" in ln]
    return libs, serialized


def launcher(so: Path):
    fn = ctypes.CDLL(str(so)).din_fused_stem
    fn.argtypes = native._SIGNATURES["din_fused_stem"]
    fn.restype = ctypes.c_int

    def run(x, w0, b0, w2, b2, out):
        code = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(),
                  b2.data_ptr(), out.data_ptr(), *x.shape[:3],
                  native.DTYPE_BF16, native.current_stream(x))
        if code != 0:
            raise RuntimeError(f"{so.name}: CUDA error {code}")
    return run


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean ms of ``fn`` on the card, each launch between CUDA events after
    a write of ``flush`` (larger than the L2 cache)."""
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


def sass_stats(so: Path) -> dict:
    """The bf16 kernel's HGMMA (wgmma) count, and the distance, in SASS
    instructions, from each FFMA to the instruction that wrote its
    accumulator input."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    body = sass[sass.index("fused_stem_bf16_kernel"):]
    body = body[:body.find("Function :", 10)] if "Function :" in body[10:] \
        else body
    lines = [ln for ln in body.splitlines()
             if re.match(r"\s+/\*[0-9a-f]{4}\*/", ln)]
    written, dists = {}, []
    for i, ln in enumerate(lines):
        m = re.search(r"FFMA (R\d+), \S+, \S+, (R\d+)", ln)
        if m and m.group(2) in written:
            dists.append(i - written[m.group(2)])
        d = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?\S+\s+(R\d+)",
                     ln)
        if d:
            written[d.group(1)] = i
    return {"hgmma": sum("HGMMA" in ln for ln in lines), "ffma": len(dists),
            "ffma_mean_distance": statistics.mean(dists),
            "ffma_share_closer_than_4":
                sum(d < 4 for d in dists) / len(dists)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stem needs a CUDA card")

    libs, serialized = build(native.BUILD_DIR / "profile_stem")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (args.frames, 720, 1280, 3)
    x = (torch.rand(shape, generator=gen, device=dev) * 2 - 1).bfloat16()
    w0 = (torch.randn((64, 3, 3, 3), generator=gen, device=dev)
          / 27 ** 0.5).bfloat16()
    b0 = (torch.randn(64, generator=gen, device=dev) * 0.1).bfloat16()
    w2 = (torch.randn((64, 64, 3, 3), generator=gen, device=dev)
          / 24.0).bfloat16()
    b2 = (torch.randn(64, generator=gen, device=dev) * 0.1).bfloat16()
    out = torch.empty((args.frames, 360, 640, 64), dtype=torch.bfloat16,
                      device=dev)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    result = {"card": smi.strip(), "chunk": list(shape)}
    for name, so in libs.items():
        run = launcher(so)
        result[f"{name}_ms"] = time_ms(lambda: run(x, w0, b0, w2, b2, out),
                                       args.iters, flush)
    xn = x.permute(0, 3, 1, 2)
    result["cudnn_stem_ms"] = time_ms(lambda: F.max_pool2d(F.relu(F.conv2d(
        F.relu(F.conv2d(xn, w0, b0, padding=1)), w2, b2, padding=1)), 2),
        args.iters, flush)
    result["sass"] = sass_stats(libs["full"])
    result["ptxas_wgmma_serialized"] = serialized
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
