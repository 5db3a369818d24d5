"""Where a training step's time goes on the card (``torch.profiler``).

    python -m din_tpu_torch.experiments.profile_training [--steps 2]

Builds the flagship preset ``volleyball_stage2_dynamic`` at full width with
seeded random weights (no stage-1 graft) and Adam, takes two warm-up steps
on one synthetic batch of ``batch_size`` clips, then traces ``--steps``
steps on it.  Prints the wall time per step, the device's busy share
(summed device time of all kernels and copies over the traced wall time,
and so its idle share) and that device time split into cuDNN forward, dgrad
and wgrad convolutions, K3 (fused stem, in gradient-free forwards only),
K2 / K2b (max-pool forward / backward), K1 / K1b (RoIAlign forward /
backward) and the rest (elementwise passes, the optimizer, copies), then
the top device entries.  Needs a card; prints "not measured" where the
profiler records no device time.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# kernel-name substrings of each category; the first match wins
CATEGORIES = (
    ("K3 fused_stem", ("fused_stem_kernel",)),
    ("K2b max_pool_2x2_bwd", ("max_pool_2x2_bwd_kernel",)),
    ("K2 max_pool_2x2", ("max_pool_2x2_kernel",)),
    ("K1b roi_align_bwd", ("roi_align_bwd_kernel",)),
    ("K1 roi_align", ("roi_align_kernel",)),
    ("cuDNN dgrad", ("dgrad",)),
    ("cuDNN wgrad", ("wgrad",)),
    ("cuDNN fwd", ("fprop", "implicit_convolve", "conv2d_grouped_direct")),
)


def category(kernel_name: str) -> str:
    low = kernel_name.lower()
    for name, keys in CATEGORIES:
        if any(k in low for k in keys):
            return name
    return "rest"


def breakdown(step_fn, steps: int) -> Dict:
    """Traces ``steps`` calls of ``step_fn`` (each ending on the device) and
    returns {'wall_us', 'busy_us', 'by_category': {name: us}, 'top':
    [(us, calls, name)]}, all totals over the traced steps."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    by_cat = {name: 0.0 for name, _ in CATEGORIES}
    by_cat["rest"] = 0.0
    for e in device:
        by_cat[category(e.key)] += e.self_device_time_total
    top = sorted(((e.self_device_time_total, e.count, e.key) for e in device),
                 reverse=True)[:15]
    return dict(wall_us=wall_us,
                busy_us=sum(e.self_device_time_total for e in device),
                by_category=by_cat, top=top)


def report(res: Dict, steps: int) -> None:
    wall, busy = res["wall_us"], res["busy_us"]
    print(f"{steps} traced step(s): {wall / steps / 1e3:.3f} ms per step "
          f"(wall, traced)")
    if busy == 0:
        print("device time: not measured (the profiler recorded none)")
        return
    print(f"device busy {busy / steps / 1e3:.3f} ms per step = "
          f"{busy / wall:.3f} of wall (idle share {1 - busy / wall:.3f})")
    for name, us in res["by_category"].items():
        print(f"  {name:22s} {us / steps / 1e3:9.3f} ms per step "
              f"({us / busy:.3f} of device time)")
    print("top device entries (ms per step, calls per step):")
    for us, count, key in res["top"]:
        print(f"  {us / steps / 1e3:9.3f}  {count / steps:6.1f}  {key[:100]}")


def main(argv=None):
    from din_tpu_torch.data.loader import to_device
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.train.engine import setup_training, train_step

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)

    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(
        load_backbone_stage2=False)
    model, optimizer, _ = setup_training(cfg)
    dev = next(model.parameters()).device
    batch = to_device(make_synthetic_batch(
        cfg, cfg.batch_size, rng=np.random.RandomState(0)), dev)
    for _ in range(2):
        train_step(model, optimizer, batch, cfg)
    res = breakdown(lambda: train_step(model, optimizer, batch, cfg),
                    args.steps)
    report(res, args.steps)
    return 0 if res["busy_us"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
