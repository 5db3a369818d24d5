"""Logging of the training loop (port of din_tpu/utils/logging.py:17-82;
reference utils.py:101-129)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def print_log(file_path: Optional[str], *args) -> None:
    """Print to stdout and append to the experiment log."""
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


def show_epoch_info(phase: str, log_path: Optional[str], info: dict) -> None:
    """Per-epoch metric report: accuracy, loss, time, throughput, the
    confusion matrix and MPCA."""
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
    print_log(log_path, "\n")
