"""Logging of the training loop (port of din_tpu/utils/logging.py:17-117;
reference utils.py:101-158): the human log ``log.txt``, a machine-readable
``metrics.jsonl`` beside it (one JSON object per reported epoch and phase)
and the experiment db ``experiments.json`` under ``result_root`` (JSON where
the reference writes a pickle).  In a run of more than one rank only
rank 0 prints and writes them (``is_log_rank``); the trainer sums the
ranks' counters before it reports them."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np


def is_log_rank() -> bool:
    """True where this process reports: one process, or rank 0 of a
    joined run."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def print_log(file_path: Optional[str], *args) -> None:
    """Print to stdout and append to the experiment log (rank 0 only)."""
    if not is_log_rank():
        return
    print(*args, flush=True)
    if file_path is not None:
        with open(file_path, "a") as f:
            print(*args, file=f)


def show_config(cfg) -> None:
    """Dump every config field to the log."""
    print_log(cfg.log_path, "=====================Config=====================")
    for field in dataclasses.fields(cfg):
        print_log(cfg.log_path, field.name, ": ", getattr(cfg, field.name))
    print_log(cfg.log_path, "======================End=======================")


def _jsonable(v):
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def append_metrics_jsonl(log_path: Optional[str], phase: str,
                         info: dict) -> None:
    """One JSON object ``{"phase": ..., **info}`` (arrays as nested lists)
    appended to ``metrics.jsonl`` beside ``log_path``: the stream a monitor
    tails (din_tpu/utils/logging.py:41-54).  Rank 0 only."""
    if log_path is None or not is_log_rank():
        return
    path = os.path.join(os.path.dirname(log_path), "metrics.jsonl")
    rec = {"phase": phase}
    rec.update({k: _jsonable(v) for k, v in info.items()})
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def show_epoch_info(phase: str, log_path: Optional[str], info: dict) -> None:
    """Per-epoch metric report: accuracy, loss, time, throughput, the
    confusion matrix, MPCA and, when measured, MAD; and its
    ``metrics.jsonl`` record."""
    append_metrics_jsonl(log_path, phase, info)
    print_log(log_path, "")
    if phase == "Test":
        print_log(log_path, "====> %s at epoch #%d" % (phase, info["epoch"]))
    else:
        print_log(log_path, "%s at epoch #%d" % (phase, info["epoch"]))
    print_log(
        log_path,
        "Group Activity Accuracy: %.2f%%, Loss: %.5f, Using %.1f seconds"
        % (info["activities_acc"], info["loss"], info["time"]))
    if "clips_per_sec" in info:
        print_log(log_path,
                  "Throughput: %.2f clips/sec" % info["clips_per_sec"])
    if "actions_acc" in info:
        print_log(log_path, "Actions Accuracy: %.2f%%" % info["actions_acc"])
    if "activities_conf" in info:
        print_log(log_path, np.asarray(info["activities_conf"]))
    if "activities_MPCA" in info:
        print_log(log_path,
                  "Activities MPCA:{:.2f}%".format(info["activities_MPCA"]))
    if "MAD" in info:
        print_log(log_path, "MAD:{:.4f}".format(info["MAD"]))
    print_log(log_path, "\n")


def log_final_exp_result(log_path: str, data_path: str,
                         exp_result: dict) -> None:
    """The final summary appended to ``log_path`` (the config without its
    bookkeeping fields, the best result, the total hours) and the run's
    entry ``{exp_name: {"best_result", "total_time"}}`` merged into the
    JSON db ``data_path`` (din_tpu/utils/logging.py:83-117).  Rank 0
    only."""
    if not is_log_rank():
        return
    no_display_cfg = {
        "num_workers", "use_gpu", "use_multi_gpu", "device_list",
        "batch_size_test", "test_interval_epoch", "train_random_seed",
        "result_path", "log_path", "device",
    }
    cfg = exp_result["cfg"]
    with open(log_path, "a") as f:
        print("\n\n", file=f)
        print("=====================Config=====================", file=f)
        for field in dataclasses.fields(cfg):
            if field.name not in no_display_cfg:
                print(field.name, ": ", getattr(cfg, field.name), file=f)
        print("=====================Result======================", file=f)
        print("Best result:", file=f)
        print(exp_result["best_result"], file=f)
        print("Cost total %.4f hours." % (exp_result["total_time"],), file=f)
        print("======================End=======================", file=f)

    db = {}
    if os.path.exists(data_path):
        with open(data_path) as f:
            db = json.load(f)
    db[cfg.exp_name] = {
        "best_result": {k: v for k, v in exp_result["best_result"].items()
                        if not hasattr(v, "shape")},
        "total_time": exp_result["total_time"],
    }
    with open(data_path, "w") as f:
        json.dump(db, f, indent=2)
