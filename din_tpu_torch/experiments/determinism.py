"""What makes two training steps on the card differ, and what the port's
repairs of it cost.

    python -m din_tpu_torch.experiments.determinism [--paths flagship,...]
        [--cost-rounds 3] [--out build/determinism.json]

Each training path that ``chip_smoke.py`` drives (the flagship, stage 1,
the collective stages, the DIN variants, the baselines and GCNNet, the other
backbones under the flagship head) is built at full width from its preset
with seeded random weights (the DIN head's offset and affinity convs too,
so that its walk leaves the integer grid) and takes steps at batch 2 on one
synthetic batch:

- the finder, in a child process: one step under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``, every
  warning PyTorch gives there of an op with no deterministic
  implementation.  That mode is process-wide, and it needs
  ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts, so it runs in a
  process of its own and nowhere else;
- the ops of one step, through a dispatch mode: each op that PyTorch
  computes deterministically only under that mode (the scatter-adds behind
  ``gather``'s backward, accumulating ``index_put``, ``index_add``, the
  resize and grid-sample backwards, ``cumsum``, ...: the lists of
  ``torch.use_deterministic_algorithms``' documentation), and each
  convolution with the state of ``cudnn.deterministic`` when it ran;
- two steps from one state as the port runs them, with its repairs (the DIN
  gather's fixed-order backward, ``train_step``'s ``deterministic_convs``):
  loss, gradients and parameters after Adam compared bit for bit;
- two steps from one state with the repairs undone (``torch.gather``'s own
  backward, cuDNN free to choose): the gradients that differ.

``--cost-rounds R`` then times the bs2 flagship, collective and HiGCIN
steps with the repairs and without, in turns (with, without, without, with)
R times: a warm-up step and 5 timed steps each, host clock around a step
that ends in a synchronize, the batch on the card.

Prints a line per path and the card's name and power limit, and writes the
report as JSON.  Needs the card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from din_tpu_torch.data.loader import to_device
from din_tpu_torch.data.synthetic import make_synthetic_batch
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.heads import din
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.train import engine
from din_tpu_torch.train.optim import make_optimizer

SEED = 0

# aten ops that add in an order that may change from run to run on CUDA
# unless torch.use_deterministic_algorithms is on (its documentation)
WATCHED = frozenset((
    "scatter_add", "scatter_add_", "scatter", "scatter_", "scatter_reduce",
    "scatter_reduce_", "index_add", "index_add_", "index_copy",
    "index_copy_", "put", "put_", "embedding_dense_backward",
    "_embedding_bag_backward", "upsample_linear1d_backward",
    "upsample_bilinear2d_backward", "upsample_bicubic2d_backward",
    "grid_sampler_2d_backward", "cumsum", "cumsum_", "nll_loss_forward",
    "nll_loss_backward", "nll_loss2d_forward", "nll_loss2d_backward",
    "_adaptive_avg_pool2d_backward", "adaptive_max_pool2d_backward",
    "max_pool3d_with_indices_backward", "avg_pool3d_backward",
    "reflection_pad1d_backward", "reflection_pad2d_backward",
    "replication_pad1d_backward", "replication_pad2d_backward", "histc",
    "bincount", "median", "repeat_interleave"))
ACCUMULATING = frozenset(("index_put", "index_put_", "_index_put_impl_"))

BACKBONE_MAPS = {"inv3": (87, 157), "vgg19": (22, 40), "res50": (23, 40),
                 "alex": (21, 39)}
BACKBONE_CHANNELS = {"inv3": 1056, "vgg19": 512, "res50": 2048, "alex": 256}


def path_configs() -> dict:
    """Each training path's config at full width, random weights."""
    def preset(name, **kw):
        return PRESETS[name]().replace(load_backbone_stage2=False,
                                       data_path="synthetic", batch_size=2,
                                       **kw)

    paths = {
        "flagship": preset("volleyball_stage2_dynamic"),
        "stage1": preset("volleyball_stage1"),
        "collective": preset("collective_stage2_dynamic"),
        "collective_stage1": preset("collective_stage1"),
    }
    for v in ("multi", "hierarchical", "tce"):
        paths["dynamic_" + v] = preset("volleyball_stage2_dynamic_" + v)
    for b in ("pctdm", "higcin", "at", "arg", "sacrf_biute"):
        paths[b] = preset("volleyball_stage2_" + b)
    paths["gcnnet_volleyball"] = preset(
        "volleyball_stage2_arg", inference_module_name="gcnnet_volleyball")
    paths["gcnnet_collective"] = preset(
        "collective_stage2_dynamic", inference_module_name="gcnnet_collective")
    for name, omap in BACKBONE_MAPS.items():
        paths[name] = preset("volleyball_stage2_dynamic", backbone=name,
                             out_size=omap,
                             emb_features=BACKBONE_CHANNELS[name])
    return paths


def _scatter_take(flat, idx):
    """The DIN gather with autograd's own backward (a scatter-add)."""
    B, C = flat.shape[0], flat.shape[-1]
    out = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


@contextlib.contextmanager
def repairs_undone():
    """The training step as it ran before the repairs: the DIN gather's
    backward a scatter-add, cuDNN on the process's flags."""
    saved = din._take, engine.deterministic_convs
    din._take, engine.deterministic_convs = (_scatter_take,
                                             contextlib.nullcontext)
    try:
        yield
    finally:
        din._take, engine.deterministic_convs = saved


class OpLog(TorchDispatchMode):
    """Counts the watched ops of the code it wraps (forward and backward)
    and each convolution by the state of ``cudnn.deterministic``."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in WATCHED:
            self.ops[name] += 1
        elif name in ACCUMULATING and (kwargs.get("accumulate") or (
                len(args) > 3 and args[3] is True)):
            self.ops[name + " (accumulate)"] += 1
        elif "convolution" in name:
            self.ops[f"{name} (cudnn.deterministic="
                     f"{torch.backends.cudnn.deterministic})"] += 1
        return func(*args, **kwargs)


def _randomize_din(model: torch.nn.Module, gen: torch.Generator) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".p_conv." in name or ".scale_conv." in name:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))


def build(cfg, dev):
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, device=dev, generator=gen)
    _randomize_din(model, gen)
    batch = to_device(make_synthetic_batch(
        cfg, cfg.batch_size, rng=np.random.RandomState(SEED + 1)), dev)
    return model, batch


def one_step(start, cfg, batch):
    """(loss, gradients, parameters after Adam) of one step from ``start``."""
    model = copy.deepcopy(start)
    opt = make_optimizer(cfg, model)
    m = engine.train_step(model, opt, batch, cfg)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return m["loss"].detach().clone(), grads, params


def differ(a, b) -> list:
    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def repeat(start, cfg, batch) -> dict:
    """Two steps from one state: what differs."""
    (l1, g1, p1), (l2, g2, p2) = (one_step(start, cfg, batch)
                                  for _ in range(2))
    return {"loss_equal": bool(torch.equal(l1, l2)),
            "loss_rel_gap": float((l1 - l2).abs() / l1.abs()),
            "grads_differ": differ(g1, g2), "params_differ": differ(p1, p2),
            "n_params": len(p1)}


def finder(paths, dev) -> dict:
    """Child process: one step of each path under the global deterministic
    mode (warn_only), the ops PyTorch warns of."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    for name in paths:
        cfg = path_configs()[name]
        start, batch = build(cfg, dev)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            one_step(start, cfg, batch)
        out[name] = sorted({str(w.message).split("\n")[0] for w in caught
                            if "deterministic" in str(w.message)})
        del start, batch
        torch.cuda.empty_cache()
    return out


def cost(rounds: int, dev) -> dict:
    """ms per step with the repairs and without, in turns."""
    out = {}
    for name in ("flagship", "collective", "higcin"):
        cfg = path_configs()[name]
        model, batch = build(cfg, dev)
        opt = make_optimizer(cfg, model)
        times = {"repaired": [], "unrepaired": []}
        order = ["repaired", "unrepaired", "unrepaired", "repaired"] * rounds
        for kind in order:
            ctx = repairs_undone() if kind == "unrepaired" \
                else contextlib.nullcontext()
            with ctx:
                engine.train_step(model, opt, batch, cfg)
                torch.cuda.synchronize()
                for _ in range(5):
                    t = time.perf_counter()
                    engine.train_step(model, opt, batch, cfg)
                    torch.cuda.synchronize()
                    times[kind].append((time.perf_counter() - t) * 1e3)
        med = {k: float(np.median(v)) for k, v in times.items()}
        out[name] = dict(ms=times, median=med,
                         cost=med["repaired"] / med["unrepaired"] - 1.0)
        print(f"[cost] {name} bs2 step: repaired median "
              f"{med['repaired']:.2f} ms (min {min(times['repaired']):.2f}), "
              f"unrepaired {med['unrepaired']:.2f} ms (min "
              f"{min(times['unrepaired']):.2f}), cost "
              f"{100 * out[name]['cost']:+.2f} %", flush=True)
        del model, batch, opt
        torch.cuda.empty_cache()
    return out


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default=",".join(path_configs()))
    ap.add_argument("--cost-rounds", type=int, default=0)
    ap.add_argument("--out", default="build/determinism.json")
    ap.add_argument("--finder", action="store_true",
                    help="the child process: print the finder's JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("determinism: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    paths = args.paths.split(",")
    if args.finder:
        print(json.dumps(finder(paths, dev)))
        return 0
    smi = nvidia_smi_line()
    t0 = time.time()
    child = subprocess.run(
        [sys.executable, "-m", "din_tpu_torch.experiments.determinism",
         "--finder", "--paths", args.paths],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        capture_output=True, text=True, check=True)
    warned = json.loads(child.stdout.strip().splitlines()[-1])
    print(f"[finder] {len(paths)} paths under use_deterministic_algorithms"
          f"(warn_only) in {time.time() - t0:.1f} s", flush=True)
    report = {"card": smi, "torch": torch.__version__, "paths": {}}
    for name in paths:
        cfg = path_configs()[name]
        tp = time.time()
        start, batch = build(cfg, dev)
        log = OpLog()
        with log:
            one_step(start, cfg, batch)
        repaired = repeat(start, cfg, batch)
        with repairs_undone():
            unrepaired = repeat(start, cfg, batch)
        report["paths"][name] = dict(warned=warned[name], ops=dict(log.ops),
                                     repaired=repaired,
                                     unrepaired=unrepaired)
        ops = ", ".join(f"{k} x{v}" for k, v in sorted(log.ops.items()))
        print(f"[path] {name} ({cfg.backbone}, {cfg.image_size[0]}x"
              f"{cfg.image_size[1]}, T={cfg.num_frames}, bs2): warned "
              f"{warned[name] or 'nothing'}; watched ops {ops or 'none'}; "
              f"repaired: loss equal {repaired['loss_equal']}, gradients "
              f"differ {len(repaired['grads_differ'])} of "
              f"{repaired['n_params']}, params "
              f"{len(repaired['params_differ'])}; unrepaired: loss rel gap "
              f"{unrepaired['loss_rel_gap']:.3g}, gradients differ "
              f"{len(unrepaired['grads_differ'])} "
              f"{unrepaired['grads_differ'][:4]}; {time.time() - tp:.1f} s",
              flush=True)
        del start, batch
        torch.cuda.empty_cache()
    if args.cost_rounds:
        report["cost"] = cost(args.cost_rounds, dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(smi, flush=True)
    bad = [n for n, r in report["paths"].items()
           if r["repaired"]["grads_differ"] or not r["repaired"]["loss_equal"]
           or r["repaired"]["params_differ"]]
    print(f"[result] paths whose repaired steps differ: {bad or 'none'}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
