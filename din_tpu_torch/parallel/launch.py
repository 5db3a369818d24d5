"""Runs a function on local ranks, one process each, and returns what each
rank's call returned.

    from din_tpu_torch.parallel.launch import run_ranks
    results = run_ranks("my_module:step", world=2, kwargs={"n": 3})

Each rank runs on the card ``cuda:RANK`` over NCCL unless the caller names
a ``device`` (``device="cpu"``: every rank on the CPU over gloo).

A user launches the trainer with ``torch.distributed.run`` instead
(``experiments/run.py``); this is for code that drives ranks from a
parent process and wants their results: the CPU tests of the port and
``chip_smoke.py``.  Each rank is ``python -m din_tpu_torch.parallel.launch
SPEC RANK``: it joins the run (``initialize_multihost`` with the spec's
address, backend, device and init timeout), calls the function with the
keyword arguments, saves what it returned beside the spec, and leaves the
run.  A target ``path/to/file.py:fn`` is loaded from that file (its
directory first on ``sys.path``), any other ``module:fn`` imported.  A
rank that fails, or a run that outlasts ``timeout``, ends every rank and
raises with the tail of each rank's log.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run_ranks(target: str, world: int, kwargs: Optional[Dict] = None, *,
              device: Optional[str] = None, backend: Optional[str] = None,
              timeout: float = 300.0, init_timeout: float = 60.0,
              threads: int = 1, workdir: Optional[str] = None) -> List[Any]:
    """``target(**kwargs)`` on ``world`` ranks; returns the ranks' results
    in rank order.  ``device`` may hold ``{rank}``; None is
    ``"cuda:{rank}"``, the card (a rank raises where CUDA is not
    available).  ``backend`` None is NCCL on the card, gloo on the CPU.
    ``threads``: each rank's torch intra-op threads."""
    if device is None:
        device = "cuda:{rank}"
    tmp = tempfile.TemporaryDirectory() if workdir is None else None
    wd = Path(workdir if workdir is not None else tmp.name)
    wd.mkdir(parents=True, exist_ok=True)
    spec = wd / "spec.pt"
    torch.save({"target": target, "world": world, "kwargs": kwargs or {},
                "device": device, "backend": backend,
                "address": f"tcp://127.0.0.1:{free_port()}",
                "init_timeout": init_timeout, "threads": threads}, spec)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(wd / f"rank{r}.log")
            with open(logs[-1], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "din_tpu_torch.parallel.launch",
                     str(spec), str(r)], cwd=str(_ROOT), env=env,
                    stdout=f, stderr=subprocess.STDOUT))
        deadline = time.time() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode not in (None, 0)), None)
            if failed is not None or time.time() > deadline:
                break
            time.sleep(0.05)
        else:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode != 0), None)
        if failed is not None or any(p.poll() is None for p in procs):
            what = (f"rank {failed} exited with {procs[failed].returncode}"
                    if failed is not None else
                    f"the ranks outlasted {timeout:.0f} s")
            raise RuntimeError(what + "".join(
                f"\n--- rank {r} ---\n{_tail(log)}"
                for r, log in enumerate(logs)))
        return [torch.load(wd / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if tmp is not None:
            tmp.cleanup()


def _load_target(target: str):
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        # its directory first on the path, as for a script
        sys.path.insert(0, str(Path(where).resolve().parent))
        spec = importlib.util.spec_from_file_location(
            Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(spec_path: str, rank: int) -> int:
    from din_tpu_torch.parallel.multihost import (initialize_multihost,
                                                  shutdown_multihost)

    spec = torch.load(spec_path, weights_only=False)
    torch.set_num_threads(spec["threads"])
    try:
        initialize_multihost(spec["address"], spec["world"], rank,
                             backend=spec["backend"],
                             device=spec["device"].format(rank=rank),
                             timeout=spec["init_timeout"])
        result = _load_target(spec["target"])(**spec["kwargs"])
        torch.save(result, Path(spec_path).with_name(f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        # a failed rank's peers may wait in a collective: leave at once
        os._exit(1)
    shutdown_multihost()
    return 0


if __name__ == "__main__":
    signal.signal(signal.SIGINT, signal.SIG_DFL)
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
