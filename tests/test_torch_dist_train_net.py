"""``train_net`` on 2 gloo ranks (``parallel/launch.py``), on the CPU: the
flagship on AlexNet at 96x128 (tests/test_torch_train_infra.py's
``tiny_cfg``: a 2x3 map the RoIs hit), dropout 0.3, 16 training clips (4
steps of 2 clips on each rank, one epoch) and 7 eval clips at batch 2.

- The per-rank loaders: at every step the two ranks' clips together are
  the one-process loader's batch at the global batch of 4.
- The eval pass (``eval_only`` from the uninterrupted run's checkpoint,
  with ``measure_mad``): the ranks' counters, confusion matrix and MAD
  equal one process's eval of the same weights (7 clips: 2 batches on
  each rank, rank 1's second batch one real clip and a masked one).
- Preemption: SIGTERM to rank 1 alone after its second step stops both
  ranks at that step, one ``_preempt.pth`` is written, and the run resumed
  with ``auto_resume`` ends bit-equal to an uninterrupted 2-rank run
  (parameters, Adam state, each rank's dropout generators).
- Only rank 0 writes ``log.txt``, ``metrics.jsonl``, ``experiments.json``
  and prints; the checkpoint has the one-process layout.
- One ``torch.distributed.run`` CLI step of ``experiments/run.py`` with
  ``--device cpu --shard-opt-state`` (ResNet-18 with live BatchNorm,
  ``synthetic_smoke``) writes a checkpoint that loads strictly into one
  process.
"""

import contextlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from din_tpu_torch.data.loader import BatchLoader, to_device
from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.layers import SeededDropout
from din_tpu_torch.parallel.launch import free_port, run_ranks
from din_tpu_torch.train import engine
from din_tpu_torch.train.checkpoint import load_resume_state
from din_tpu_torch.train.optim import make_optimizer
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny(root, **kw):
    return PRESETS["volleyball_stage2_dynamic"]().replace(**dict(dict(
        data_path="synthetic", backbone="alex", out_size=(2, 3),
        emb_features=256, image_size=(96, 128), num_frames=3, num_boxes=4,
        num_features_boxes=64, lite_dim=16, compute_dtype="float32",
        batch_size=2, test_batch_size=2, num_workers=1,
        load_backbone_stage2=False, result_root=root, max_epoch=1,
        train_dropout_prob=0.3, graceful_preemption=True), **kw))


def datasets(cfg):
    return (SyntheticDataset(cfg, size=16, is_training=True, seed=1),
            SyntheticDataset(cfg, size=7, is_training=False, seed=2))


def clip_ids(images: torch.Tensor) -> list:
    return images.flatten(1).long().sum(1).tolist()


def rank_train(root):
    """On each rank: an uninterrupted run, then a run that rank 1 stops by
    SIGTERM after its second step, then its auto-resume; what each
    returned, printed, stepped on and ended with."""
    import torch.distributed as dist

    rank = dist.get_rank()
    engine.return_dataset = datasets
    seen = {"steps": [], "kill_at": None}
    step = engine.train_step

    def recording(model, optimizer, batch, cfg):
        seen["model"], seen["optimizer"] = model.module, optimizer
        out = step(model, optimizer, batch, cfg)
        seen["steps"].append(clip_ids(batch["images"]))
        if len(seen["steps"]) == seen["kill_at"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    engine.train_step = recording

    def run(name, kill_at=None, **kw):
        seen["steps"], seen["kill_at"] = [], kill_at
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            best = engine.train_net(tiny(root, exp_name=name, **kw),
                                    device="cpu")
        if kw.get("eval_only"):
            return {"info": best, "stdout": text.getvalue()}
        model, optimizer = seen["model"], seen["optimizer"]
        return {"best": best, "stdout": text.getvalue(),
                "steps": seen["steps"],
                "state": {k: v.clone()
                          for k, v in model.state_dict().items()},
                "optimizer": optimizer.state_dict(),
                "rng": {n: m.get_rng_state()
                        for n, m in model.named_modules()
                        if isinstance(m, SeededDropout)}}

    out = {"whole": run("whole"),
           "cut": run("cut", kill_at=2 if rank == 1 else None)}
    out["resumed"] = run("cut", auto_resume=True)
    out["eval"] = run("eval", eval_only=True, load_stage2model=True,
                      stage2model=out["whole"]["best"]["checkpoint"],
                      measure_mad=True)
    return out


@pytest.fixture(scope="module")
def cli_run():
    """The ``torch.distributed.run`` CLI step, started first so that it
    runs beside the ranks of ``ranks``: (process, its result root, its
    output file)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_port", str(free_port()),
               "-m", "din_tpu_torch.experiments.run",
               "--preset", "synthetic_smoke", "--device", "cpu",
               "--max-epoch", "1", "--max-steps-per-epoch", "1",
               "--batch-size", "2", "--result-root", str(tmp / "runs"),
               "--exp-name", "cli", "--shard-opt-state"]
        with open(tmp / "out.txt", "w") as out:
            proc = subprocess.Popen(cmd, cwd=REPO, stdout=out,
                                    stderr=subprocess.STDOUT, text=True,
                                    env=dict(os.environ, OMP_NUM_THREADS="1"))
        try:
            yield proc, tmp / "runs", tmp / "out.txt"
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cli_run):
    root = tmp_path_factory.mktemp("dist_train")
    got = run_ranks(__file__ + ":rank_train", 2, {"root": str(root)},
                    device="cpu", timeout=240)
    yield {"ranks": got, "root": root}
    shutil.rmtree(root)                    # the runs' checkpoints


def test_rank_loaders_together_are_the_one_process_batches(ranks):
    r0, r1 = (r["whole"]["steps"] for r in ranks["ranks"])
    assert len(r0) == len(r1) == 4
    cfg = tiny(str(ranks["root"]))
    loader = BatchLoader(datasets(cfg)[0], 4, shuffle=True, num_workers=1,
                         seed=cfg.train_random_seed)
    loader.set_epoch(1)
    single = [clip_ids(torch.from_numpy(b["images"])) for b in loader]
    assert len(single) == 4
    for a, b, want in zip(r0, r1, single):
        assert sorted(a + b) == sorted(want)
        assert not set(a) & set(b)


def test_eval_counts_equal_one_process(ranks):
    cfg = tiny(str(ranks["root"]))
    model = build_model(cfg, device=CPU)
    model.load_state_dict(ranks["ranks"][0]["whole"]["state"])
    val = BatchLoader(datasets(cfg)[1], 2, shuffle=False, num_workers=1,
                      drop_last=False, pad_last=True)
    want = engine.run_eval(model, val, cfg.replace(measure_mad=True), 0, CPU)
    assert int(want["activities_conf"].sum()) == 7
    for r in ranks["ranks"]:
        got = r["eval"]["info"]
        np.testing.assert_array_equal(got["activities_conf"],
                                      want["activities_conf"])
        assert got["activities_acc"] == want["activities_acc"]
        assert got["activities_MPCA"] == want["activities_MPCA"]
        np.testing.assert_allclose(got["MAD"], want["MAD"], rtol=1e-12)


def test_sigterm_to_one_rank_stops_both_and_resumes_exactly(ranks):
    r0, r1 = ranks["ranks"]
    assert len(r0["cut"]["steps"]) == len(r1["cut"]["steps"]) == 2
    assert len(r0["resumed"]["steps"]) == len(r1["resumed"]["steps"]) == 2
    cut = ranks["root"] / "cut"
    assert sorted(f for f in os.listdir(cut)
                  if f.endswith("_preempt.pth")) == \
        ["stage2_epoch0_preempt.pth"]
    saved = torch.load(cut / "stage2_epoch0_preempt.pth", weights_only=True)
    assert saved["step"] == 2 and len(saved["dropout_rng_ranks"]) == 2
    for r in (r0, r1):
        whole, resumed = r["whole"], r["resumed"]
        assert resumed["steps"] == whole["steps"][2:]
        for k, v in whole["state"].items():
            assert torch.equal(v, resumed["state"][k]), k
        assert whole["optimizer"]["param_groups"] == \
            resumed["optimizer"]["param_groups"]
        for i, s in whole["optimizer"]["state"].items():
            for k, v in s.items():
                assert torch.equal(v, resumed["optimizer"]["state"][i][k])
        assert whole["rng"].keys() == resumed["rng"].keys()
        for k, v in whole["rng"].items():
            assert v is not None and torch.equal(v, resumed["rng"][k]), k
    # each rank its own dropout stream
    assert any(not torch.equal(v, r1["whole"]["rng"][k])
               for k, v in r0["whole"]["rng"].items())


def test_only_rank_zero_writes(ranks):
    r0, r1 = (r["whole"] for r in ranks["ranks"])
    whole = ranks["root"] / "whole"
    log = (whole / "log.txt").read_text()
    assert log.count("Train at epoch #1") == 1
    assert log.count("====> Test at epoch #1") == 1
    phases = [json.loads(line)["phase"] for line in
              (whole / "metrics.jsonl").read_text().splitlines()]
    assert phases == ["Train", "Test"]
    assert "whole" in json.loads(
        (ranks["root"] / "experiments.json").read_text())
    assert "Train at epoch #1" in r0["stdout"] and r1["stdout"] == ""
    ckpts = [f for f in os.listdir(whole) if f.endswith(".pth")]
    assert len(ckpts) == 1
    saved = torch.load(whole / ckpts[0], weights_only=True)
    assert sorted(saved["state_dict"]) == sorted(r0["state"])
    for k, v in r0["state"].items():
        assert torch.equal(v, saved["state_dict"][k]), k


def test_torch_distributed_run_cli_step(cli_run):
    proc, tmp_path, out = cli_run
    proc.wait(timeout=180)
    stdout = out.read_text()
    assert proc.returncode == 0, stdout[-6000:]
    assert stdout.count("Best:") == 1
    log = (tmp_path / "cli" / "log.txt").read_text()
    assert "ZeRO-1: optimizer state sharded over data axis (2)" in log
    assert log.count("Train at epoch #1") == 1
    ckpts = [f for f in os.listdir(tmp_path / "cli") if f.endswith(".pth")]
    assert len(ckpts) == 1 and ckpts[0].startswith("stage2_epoch1_")
    cfg = PRESETS["synthetic_smoke"]()
    model = build_model(cfg, device=CPU)
    optimizer = make_optimizer(cfg, model)
    assert load_resume_state(str(tmp_path / "cli" / ckpts[0]), model,
                             optimizer)[0] == 1
    assert len(optimizer.state_dict()["state"]) == \
        len([p for p in model.parameters() if p.requires_grad])
    batch = to_device(next(iter(BatchLoader(datasets(cfg)[0], 2,
                                            num_workers=1))), CPU)
    assert torch.isfinite(engine.train_step(model, optimizer, batch,
                                            cfg)["loss"])
