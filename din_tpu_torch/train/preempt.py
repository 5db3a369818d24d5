"""Graceful preemption: SIGTERM -> checkpoint -> clean return (port of
din_tpu/train/preempt.py:35-68).

The reference has no failure story: a preempted or killed run loses
everything since the last per-epoch save (train_net.py:99,121-125).  Spot
and maintenance reclaims send SIGTERM with a grace window, so the engine
arms this guard around its eval-only pass, ``test_before_train`` and the
epoch loop: the signal only sets a flag; the loop checks it at every step
boundary and after every eval batch, writes a full-state checkpoint
(``stage{N}_epoch{E}_preempt.pth``: parameters, BatchNorm buffers, Adam
state, the epoch, the steps done and every dropout generator's state) and
returns.  ``cfg.auto_resume`` picks that file up on the next launch and
continues the interrupted epoch at its next batch.

In a run of more than one rank the signal may reach one rank alone; the
stop is agreed (``agreed_stop``: an all-reduce MAX of every rank's flag at
every boundary, din_tpu/train/engine.py:518-528), so every rank stops at
the same step and none waits in a collective the others left.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Context manager that latches termination signals into a flag.

    Handlers are installed on ``__enter__`` and the previous ones restored
    on ``__exit__``.  Installing a handler needs the main thread (CPython's
    rule); off the main thread the guard is an inert flag, so an engine
    run in a worker thread still works (``armed`` says which)."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._flag = False
        self._prev = {}
        self.armed = False

    def _handler(self, signum, frame):  # noqa: ARG002 (signal signature)
        self._flag = True

    @property
    def should_stop(self) -> bool:
        return self._flag

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self.signals:
                self._prev[sig] = signal.signal(sig, self._handler)
            self.armed = True
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        self.armed = False


def agreed_stop(guard, mesh=None) -> bool:
    """True if ``guard`` (None: no guard) latched a signal on this rank
    or, with ``mesh``, on any rank of it.  Every rank calls it at the same
    boundaries."""
    local = guard is not None and guard.should_stop
    return local if mesh is None else mesh.agree(local)
