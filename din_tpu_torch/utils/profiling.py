"""Profiling and cost counts (port of din_tpu/utils/profiling.py).

``profiler_trace(log_dir)`` wraps ``torch.profiler`` (CPU and, with a
card, CUDA activities) and writes a Chrome trace into ``log_dir``, viewable
in Perfetto or ``chrome://tracing``; the engine puts it around the first
epoch when ``cfg.profile_dir`` is set.  The per-head report counts FLOPs
at the reference modules' probe shapes, as the reference's thop probes and
din_tpu's ``module_cost_report`` do:

    python -m din_tpu_torch.utils.profiling [--head DIN] [--device cpu]

The counts come from ``torch.utils.flop_counter.FlopCounterMode``: two
FLOPs per multiply-add of the matrix products and convolutions, nothing
for elementwise work.  din_tpu reads XLA's cost analysis of the compiled
program, which counts elementwise work too, so its numbers are larger.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from din_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Traces the block and writes ``log_dir/trace_<pid>_<time>.json``
    (CUDA activities too when a card is there); yields that path, and is a
    no-op yielding None without ``log_dir``."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace_%d_%d.json" % (os.getpid(),
                                                       int(time.time())))
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def param_count(module: torch.nn.Module) -> int:
    """Number of parameter elements."""
    return sum(p.numel() for p in module.parameters())


def flops(fn: Callable, *args, **kwargs) -> int:
    """FLOPs of one call of ``fn`` (matrix products and convolutions)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def module_cost_report(module: torch.nn.Module, *args, name: str = "",
                       **kwargs) -> str:
    """One line of FLOPs and parameters, as the reference's probes print."""
    with torch.no_grad():
        g = flops(module, *args, **kwargs) / 1e9
    return (f"{name or type(module).__name__}: {g:.3f} GFLOPs  "
            f"#Params: {param_count(module):,}")


def _head_probes(device: torch.device, head: str = "all"):
    """Probes at the reference modules' shapes (AT_infer_module.py:146-151,
    TCE_STBiP_module.py:373-408, dynamic_infer_module.py __main__;
    din_tpu/utils/profiling.py:69-108): (name, module, example args) of
    the heads whose name holds ``head`` (any case; "all": every head)."""
    from din_tpu_torch.heads.arg import GCNModule
    from din_tpu_torch.heads.at import ActorTransformer
    from din_tpu_torch.heads.din import DynamicPersonInference
    from din_tpu_torch.heads.higcin import CrossInferBlock
    from din_tpu_torch.heads.pctdm import PCTDM
    from din_tpu_torch.heads.sacrf_biute import SACRF, BiUTE
    from din_tpu_torch.heads.tce import MultiHeadTCE

    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    B, T, N, C = 2, 10, 12, 1024
    x = torch.from_numpy(rng.randn(B, T, N, C).astype(np.float32))
    xbtn = x.reshape(B * T, N, C)
    boxes = torch.from_numpy(np.stack(
        [rng.uniform(0, 78, (B * T, N)), rng.uniform(0, 43, (B * T, N)),
         rng.uniform(0, 78, (B * T, N)), rng.uniform(0, 43, (B * T, N))],
        -1).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(B * T, 45, 80, 256).astype(np.float32))
    probes = [
        ("DIN (Dynamic_Person_Inference)",
         lambda: DynamicPersonInference(C, gen), (x,)),
        ("ARG GCN_Module",
         lambda: GCNModule(C, 256, 16, 0.2, 80, (T * N, C), gen),
         (x.reshape(B, T * N, C), boxes.reshape(B, T * N, 4))),
        ("Actor_Transformer", lambda: ActorTransformer(C, gen), (xbtn,)),
        ("PCTDM", lambda: PCTDM(N, C, gen), (x,)),
        ("HiGCIN CrossInferBlock", lambda: CrossInferBlock(C, gen), (x,)),
        ("SACRF", lambda: SACRF(C, 9, (720, 1280), (45, 80), gen),
         (x, boxes.reshape(B, T, N, 4))),
        ("BiUTE", lambda: BiUTE(C, N, gen), (x,)),
        ("MultiHeadTCE", lambda: MultiHeadTCE(
            C, 256, gen, num_heads=2, num_layers=1,
            num_features_context=256), (xbtn, ctx)),
    ]
    return [(name, make().to(device).eval(),
             tuple(a.to(device) for a in ex)) for name, make, ex in probes
            if head == "all" or head.lower() in name.lower()]


def main(argv=None) -> None:
    """Per-head FLOP and parameter report at the reference's shapes, on
    the card unless ``--device cpu`` is given."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--head", default="all",
                    help="substring filter on head names")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' only when asked")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for name, mod, ex in _head_probes(device, args.head):
        print(module_cost_report(mod, *ex, name=name), flush=True)


if __name__ == "__main__":
    main()
