"""Meters of the training loop (port of din_tpu/utils/meters.py ``Timer``
and ``MPCA``; reference utils.py:181-191, 279-289)."""

from __future__ import annotations

import time

import numpy as np


class Timer:
    """Wall clock keeper: ``timeit()`` returns the seconds since the last
    call (or construction)."""

    def __init__(self):
        self.last_time = time.time()

    def timeit(self) -> float:
        old_time = self.last_time
        self.last_time = time.time()
        return self.last_time - old_time


def MPCA(conf_mat) -> float:
    """Mean per-class accuracy in percent of a [K, K] confusion matrix
    (rows = truth)."""
    conf_mat = np.asarray(conf_mat, dtype=np.float64)
    class_sum = conf_mat.sum(axis=1)
    per_class = np.diag(conf_mat) / np.maximum(class_sum, 1e-12)
    return float(per_class.mean() * 100.0)
