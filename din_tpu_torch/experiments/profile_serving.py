"""Where a serving request's time goes on the card (``torch.profiler``).

    python -m din_tpu_torch.experiments.profile_serving [--requests 3]
        [--clips 1] [--pad-to 2]

Builds the flagship preset ``volleyball_stage2_dynamic`` at full width with
seeded random weights, warms ``Predictor`` up with two requests, then traces
``--requests`` requests of ``--clips`` clips.  Prints the wall time per
request, the device's busy share (summed device time of all kernels and
copies over the traced wall time) and that device time split into cuDNN
convolutions, K3 ``fused_stem``, K2 ``max_pool_2x2``, K1 ``roi_align`` and
the rest, then the top device entries.  Needs a card; prints "not measured"
where the profiler records no device time.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def main(argv=None):
    from din_tpu_torch.data.synthetic import make_synthetic_batch
    from din_tpu_torch.experiments.predict import Predictor
    from din_tpu_torch.experiments.presets import PRESETS
    from din_tpu_torch.models.registry import build_model

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--clips", type=int, default=1)
    p.add_argument("--pad-to", type=int, default=2)
    args = p.parse_args(argv)

    cfg = PRESETS["volleyball_stage2_dynamic"]()
    predictor = Predictor(cfg, build_model(cfg), pad_to=args.pad_to)
    batch = make_synthetic_batch(cfg, args.clips,
                                 rng=np.random.RandomState(0))
    images, boxes = batch["images"], batch["boxes"]
    for _ in range(2):
        predictor(images, boxes)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            predictor(images, boxes)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    conv_us = sum(e.device_time_total for e in events
                  if e.device_type == DeviceType.CPU
                  and e.key == "aten::cudnn_convolution")

    def kernels(name):
        return sum(e.self_device_time_total for e in device if name in e.key)

    k3_us = kernels("fused_stem_")  # fused_stem_{bf16,f32}_kernel
    k2_us, k1_us = kernels("max_pool_2x2_kernel"), kernels("roi_align_kernel")
    n = args.requests
    print(f"{n} requests of {args.clips} clip(s), pad_to={args.pad_to}: "
          f"{wall_us / n / 1e3:.3f} ms per request (wall, traced)")
    if busy_us == 0:
        print("device time: not measured (the profiler recorded none)")
        return 1
    print(f"device busy {busy_us / n / 1e3:.3f} ms per request = "
          f"{busy_us / wall_us:.3f} of wall (idle share "
          f"{1 - busy_us / wall_us:.3f})")
    rest = busy_us - conv_us - k3_us - k2_us - k1_us
    for name, us in (("cuDNN convolutions", conv_us),
                     ("K3 fused_stem", k3_us), ("K2 max_pool_2x2", k2_us),
                     ("K1 roi_align", k1_us), ("rest", rest)):
        print(f"  {name:20s} {us / n / 1e3:9.3f} ms per request "
              f"({us / busy_us:.3f} of device time)")
    print("top device entries (ms per request, calls per request):")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / n / 1e3:9.3f}  "
              f"{e.count / n:6.1f}  {e.key[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
