"""Meters of the training loop (port of din_tpu/utils/meters.py:18-160;
reference utils.py:161-384): ``AverageMeter``, ``Timer``,
``ConfusionMeter``, ``MPCA`` and ``MADmeter``, numpy on the host (the
engine brings a step's results to the host once, after the step).  Each
rank of a run meters its own clips; ``MADmeter.all_reduce`` sums the
ranks' meters."""

from __future__ import annotations

import time

import numpy as np


class AverageMeter:
    """Running average (utils.py:161-178)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Timer:
    """Wall clock keeper: ``timeit()`` returns the seconds since the last
    call (or construction)."""

    def __init__(self):
        self.last_time = time.time()

    def timeit(self) -> float:
        old_time = self.last_time
        self.last_time = time.time()
        return self.last_time - old_time


class ConfusionMeter:
    """K-way confusion matrix, rows = truth (utils.py:193-277), counted
    with the reference's bincount of ``predicted + k * target``."""

    def __init__(self, k: int, normalized: bool = False):
        self.k = k
        self.normalized = normalized
        self.conf = np.zeros((k, k), dtype=np.int64)

    def reset(self):
        self.conf.fill(0)

    def add(self, predicted, target):
        """``predicted`` labels [n] or scores [n, k]; ``target`` labels [n]
        or one-hot [n, k]."""
        predicted = np.asarray(predicted)
        target = np.asarray(target)
        if predicted.shape[0] != target.shape[0]:
            raise ValueError("number of targets and predicted outputs do "
                             "not match")
        if predicted.ndim != 1:
            predicted = np.argmax(predicted, 1)
        if target.ndim != 1:
            target = np.argmax(target, 1)
        x = predicted.astype(np.int64) + self.k * target.astype(np.int64)
        bincount_2d = np.bincount(x, minlength=self.k ** 2)
        self.conf += bincount_2d.reshape((self.k, self.k))

    def value(self):
        if self.normalized:
            conf = self.conf.astype(np.float64)
            return conf / conf.sum(1).clip(min=1e-12)[:, None]
        return self.conf


def MPCA(conf_mat) -> float:
    """Mean per-class accuracy in percent of a [K, K] confusion matrix
    (rows = truth)."""
    conf_mat = np.asarray(conf_mat, dtype=np.float64)
    class_sum = conf_mat.sum(axis=1)
    per_class = np.diag(conf_mat) / np.maximum(class_sum, 1e-12)
    return float(per_class.mean() * 100.0)


class MADmeter:
    """Mean Average Distance (1 - cosine similarity) over interaction
    fields, averaged over clips (utils.py:302-384), in float64.

    ``field_shape="rect"``: features [B, T, N, C]; a node's field is the
    whole T x N grid (``field == (T, N)``) or an odd k x k window, whose
    neighbour the reference indexes as ``(x + dj) * T + (y + dk)``
    (utils.py:325): that flat-index convention is kept for parity.
    ``field_shape="dynamic"``: DIN nodes [B, T*N, k2, C], each row a centre
    feature followed by its k2 - 1 sampled neighbours (``train/engine.py``
    ``mad_nodes``); the distance of a centre to its own samples, averaged
    over the centres."""

    def __init__(self, T: int, N: int):
        self.T = T
        self.N = N
        self.B = 0
        self.MAD = 0.0

    @staticmethod
    def _rect_mask(T: int, N: int, field):
        TN = T * N
        if len(field) == 2 and field[0] == T and field[1] == N:
            return np.ones((TN, TN), dtype=bool)
        if not (len(field) == 1 and field[0] % 2 == 1):
            raise ValueError(f"a rect field is (T, N) or one odd size; got "
                             f"{field!r}")
        half = field[0] // 2
        i = np.arange(TN)
        x, y = i // N, i % N
        mask = np.zeros((TN, TN), dtype=bool)
        for dj in range(-half, half + 1):
            for dk in range(-half, half + 1):
                ok = (x + dj >= 0) & (y + dk >= 0)
                j = (x + dj) * T + (y + dk)
                valid = ok & (j >= 0) & (j < TN)
                mask[i[valid], j[valid]] = True
        return mask

    @staticmethod
    def _dynamic_mask(TN: int, k2: int):
        mask = np.zeros((TN * k2, TN * k2), dtype=bool)
        i = np.arange(TN) * k2
        for j in range(k2 - 1):
            mask[i, i + j + 1] = True
        return mask

    def cal_MAD(self, features, field, field_shape: str = "rect"):
        features = np.asarray(features, dtype=np.float64)
        if field_shape == "rect":
            B, T, N, NFB = features.shape
            mask = self._rect_mask(T, N, field)
            feats = features.reshape(B, T * N, NFB)
        else:
            B, TN, k2, NFB = features.shape
            mask = self._dynamic_mask(TN, k2)
            feats = features.reshape(B, TN * k2, NFB)

        norm = np.linalg.norm(feats, axis=2, keepdims=True)
        divisor = norm @ norm.transpose(0, 2, 1)
        dist = 1.0 - feats @ feats.transpose(0, 2, 1) / (divisor + 1e-8)
        dist = dist * mask[None].astype(np.float64)
        mad = dist.sum(axis=2) / (mask.astype(np.float64).sum(axis=1)[None]
                                  + 1e-8)
        if field_shape == "dynamic":
            # the centre nodes are every k2-th row (utils.py:353-359)
            k2 = features.shape[2]
            node_sel = np.zeros(mad.shape[1], dtype=bool)
            node_sel[::k2] = True
            self.MAD += float(mad[:, node_sel].mean(axis=1).sum())
        else:
            self.MAD += float(mad.mean(axis=1).sum())
        self.B += features.shape[0]

    def output_MAD(self):
        return self.MAD / max(self.B, 1)

    def all_reduce(self, reduce_sum) -> None:
        """The sums of every rank's meter, by ``reduce_sum`` (an array
        summed over the ranks, ``Mesh.host_sum``), so that each rank's
        ``output_MAD`` is the mean over all their clips."""
        self.MAD, B = (float(v) for v in
                       reduce_sum(np.array([self.MAD, self.B], np.float64)))
        self.B = int(round(B))
