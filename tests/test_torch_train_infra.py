"""The training infrastructure of the port against the JAX package, on the
CPU: ``train_to_epoch``, ``keep_checkpoints`` and the checkpoint rules,
``metrics.jsonl`` and ``experiments.json``, ``debug_nans``, the profiler
hook and the new ``run.py`` flags.  Gradient accumulation is in
tests/test_torch_grad_accum.py, preemption and resume in
tests/test_torch_preempt.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.train.checkpoint import prune_checkpoints as jax_prune
from din_tpu.train.engine import newest_resumable as jax_newest
from din_tpu.utils import logging as jax_logging
from din_tpu_torch.data.loader import BatchLoader, to_device
from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.experiments import run
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.train import engine
from din_tpu_torch.train.optim import make_optimizer
from din_tpu_torch.train.checkpoint import (newest_resumable,
                                            prune_checkpoints)
from din_tpu_torch.utils import logging as port_logging
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def tiny_cfg(tmp_path, **kw):
    """The flagship at a size train_net runs in about a second on the CPU:
    AlexNet (a 2x3 map) at 96x128, T=3, N=4, NFB 64, lite 16, f32, batch
    2, synthetic clips, 16 eval clips at batch 8, no stage-1 graft.  The
    map is two rows high so that the RoIs hit it: on a map one row high
    every sample below its top row falls outside, the RoI features are 0,
    and a step moves ``fc_activities.bias`` alone."""
    kw = dict(dict(data_path="synthetic", backbone="alex", out_size=(2, 3),
                   emb_features=256, image_size=(96, 128), num_frames=3,
                   num_boxes=4, num_features_boxes=64, lite_dim=16,
                   compute_dtype="float32", batch_size=2, test_batch_size=8,
                   num_workers=1, load_backbone_stage2=False,
                   result_root=str(tmp_path), max_epoch=1), **kw)
    return PRESETS["volleyball_stage2_dynamic"]().replace(**kw)


def assert_step_trains(cfg):
    """One ``train_step`` of ``cfg`` on synthetic clips gives non-zero
    gradients to the trunk's first conv, to the actor embedding
    (``fc_emb_1``; stage 1's ``fc_emb``) and to the head:
    the DIN head's offset conv and projection in stage 2, which has one,
    ``fc_activities.weight`` in stage 1."""
    model = build_model(cfg, device="cpu")
    batch = next(iter(BatchLoader(SyntheticDataset(cfg, seed=4),
                                  cfg.batch_size, seed=0)))
    engine.train_step(model, make_optimizer(cfg, model),
                      to_device(batch, torch.device("cpu")), cfg)
    grads = {n: p.grad for n, p in model.named_parameters()}
    head = (["DPI.DIMlist.0.p_conv.1.weight",
             "DPI.DIMlist.0.hidden_weight.weight"]
            if cfg.training_stage == 2 else ["fc_activities.weight"])
    emb = "fc_emb_1.weight" if cfg.training_stage == 2 else "fc_emb.weight"
    for name in ["backbone.features.0.weight", emb] + head:
        assert grads[name] is not None and bool(grads[name].abs().max() > 0), \
            name


def test_a_step_trains_trunk_embedding_and_head(tmp_path):
    assert_step_trains(tiny_cfg(tmp_path))


def test_train_to_epoch_is_the_absolute_last_epoch(tmp_path):
    """Epochs 1-2 of a plan of ``max_epoch`` 5; an auto-resumed relaunch
    with ``train_to_epoch`` 3 trains epoch 3 only; another trains none."""
    cfg = tiny_cfg(tmp_path, exp_name="e", max_epoch=5, train_to_epoch=2)
    engine.train_net(cfg, max_steps_per_epoch=1, device="cpu")
    log = open(cfg.log_path).read()
    assert "Train at epoch #2" in log and "Train at epoch #3" not in log
    for again in (1, 2):
        cfg = tiny_cfg(tmp_path, exp_name="e", max_epoch=5,
                       train_to_epoch=3, auto_resume=True)
        engine.train_net(cfg, max_steps_per_epoch=1, device="cpu")
    log = open(cfg.log_path).read()
    assert "resuming at epoch 3)" in log and "resuming at epoch 4)" in log
    assert log.count("Train at epoch #3") == 1
    assert "Train at epoch #4" not in log
    assert sorted(f for f in os.listdir(cfg.result_path)
                  if f.endswith(".pth"))[-1].startswith("stage2_epoch3_")


def test_keep_checkpoints_prunes_after_each_save(tmp_path):
    """Three epochs with ``keep_checkpoints`` 1 leave what
    ``prune_checkpoints``' rule names: the newest file and the best
    accuracy's (the later epoch on a tie)."""
    cfg = tiny_cfg(tmp_path, exp_name="k", max_epoch=3, keep_checkpoints=1)
    best = engine.train_net(cfg, max_steps_per_epoch=1, device="cpu")
    accs = {}
    for line in open(cfg.log_path):
        if line.startswith("model saved to: "):
            name = os.path.basename(line.split(": ", 1)[1].strip())
            accs[name] = (float(name.split("_")[2][:-5]),
                          int(name.split("epoch")[1].split("_")[0]))
    assert len(accs) == 3
    keep = {max(accs, key=lambda f: accs[f][1]),
            max(accs, key=lambda f: accs[f])}
    assert set(os.listdir(cfg.result_path)) - {"log.txt",
                                               "metrics.jsonl"} == keep
    assert os.path.basename(best["checkpoint"]) in keep
    assert "pruned" in open(cfg.log_path).read()


def test_checkpoint_rules_match_jax(tmp_path):
    """``newest_resumable`` and ``prune_checkpoints`` on din_tpu's own test
    lists (tests/test_preempt.py:166-180, tests/test_aux.py:131-150), the
    port's files named ``.pth``: the same choices as din_tpu's on ``.ckpt``
    names."""
    lists = {
        "resume": ["stage2_epoch3_91.25%", "stage2_epoch3_preempt",
                   "stage2_epoch2_90.00%"],
        "prune": ["stage2_epoch1_80.00%", "stage2_epoch2_95.00%",
                  "stage2_epoch3_90.00%", "stage2_epoch4_91.00%",
                  "stage2_epoch2_preempt", "stage1_epoch9_70.00%"],
    }
    for what, names in lists.items():
        for ext in ("pth", "ckpt"):
            os.makedirs(tmp_path / what / ext)
            for n in names:
                open(tmp_path / what / ext / f"{n}.{ext}", "wb").close()
    for stage in (1, 2):
        ours = newest_resumable(str(tmp_path / "resume" / "pth"), stage)
        theirs = jax_newest(str(tmp_path / "resume" / "ckpt"), stage)
        assert os.path.basename(ours)[:-4] == os.path.basename(theirs)[:-5]
        assert ours.endswith("stage2_epoch3_preempt.pth")
    assert newest_resumable(str(tmp_path / "prune" / "pth"), 1).endswith(
        "stage2_epoch2_preempt.pth")
    removed = prune_checkpoints(str(tmp_path / "prune" / "pth"), 2, 2)
    assert removed == ["stage2_epoch1_80.00%.pth"]
    assert [f[:-5] for f in jax_prune(str(tmp_path / "prune" / "ckpt"), 2,
                                      2)] == [f[:-4] for f in removed]
    assert sorted(f[:-4] for f in os.listdir(tmp_path / "prune" / "pth")) \
        == sorted(f[:-5] for f in os.listdir(tmp_path / "prune" / "ckpt"))
    assert prune_checkpoints(str(tmp_path / "prune" / "pth"), 2, 0) == []


def test_metrics_and_experiment_records_equal_jax(tmp_path):
    """``show_epoch_info`` and ``log_final_exp_result`` of the same info on
    both sides: equal ``log.txt`` lines and ``metrics.jsonl`` records
    (confusion as nested lists), equal ``experiments.json`` entries; and
    ``train_net`` writes one record per reported epoch and phase and its
    entry."""
    info = {"epoch": 3, "time": 1.25, "loss": 0.5, "activities_acc": 62.5,
            "activities_conf": np.array([[3, 1], [2, 2]], np.int64),
            "activities_MPCA": 62.5, "MAD": np.float64(0.4375),
            "clips_per_sec": 12.0}
    best = {k: v for k, v in info.items() if k != "clips_per_sec"}
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]().replace(exp_name="x")
    pcfg = PRESETS["volleyball_stage2_dynamic"]().replace(exp_name="x")
    for side, mod, cfg in (("port", port_logging, pcfg),
                           ("jax", jax_logging, jcfg)):
        os.makedirs(tmp_path / side)
        log = str(tmp_path / side / "log.txt")
        mod.show_epoch_info("Train", log, dict(info, epoch=2))
        mod.show_epoch_info("Test", log, info)
        mod.log_final_exp_result(log, str(tmp_path / side / "db.json"),
                                 {"cfg": cfg, "best_result": best,
                                  "total_time": 0.5})
    read = lambda side, f: (tmp_path / side / f).read_text()  # noqa: E731
    assert read("port", "metrics.jsonl") == read("jax", "metrics.jsonl")
    recs = [json.loads(x) for x in read("port", "metrics.jsonl").split("\n")
            if x]
    assert recs[1]["activities_conf"] == [[3, 1], [2, 2]]
    assert recs[1]["MAD"] == 0.4375 and recs[0]["phase"] == "Train"
    assert json.loads(read("port", "db.json")) == json.loads(
        read("jax", "db.json"))
    port_log = read("port", "log.txt")
    assert "MAD:0.4375" in port_log
    assert port_log.split("=====================Config")[0] == read(
        "jax", "log.txt").split("=====================Config")[0]

    cfg = tiny_cfg(tmp_path, exp_name="m", max_epoch=2,
                   test_before_train=True)
    engine.train_net(cfg, max_steps_per_epoch=1, device="cpu")
    phases = [json.loads(x)["phase"] for x in open(os.path.join(
        cfg.result_path, "metrics.jsonl"))]
    assert phases == ["Test", "Train", "Test", "Train", "Test"]
    db = json.load(open(tmp_path / "experiments.json"))
    assert db["m"]["best_result"]["checkpoint"].endswith(".pth")
    assert "Best result:" in open(cfg.log_path).read()


def test_debug_nans_raises_and_restores_anomaly_mode(tmp_path, monkeypatch):
    """A NaN that reaches the loss raises ``FloatingPointError`` under
    ``debug_nans`` (the step's head bias is made NaN: a NaN box cannot
    reach it, RoIAlign's sample indices raise first); the anomaly mode is
    on during the run and as it was after (here: on without NaN checks);
    without ``debug_nans`` the step runs on."""
    seen = []
    step = engine.train_step

    def nan_step(model, optimizer, batch, cfg):
        seen.append((torch.is_anomaly_enabled(),
                     torch.is_anomaly_check_nan_enabled()))
        with torch.no_grad():
            model.fc_activities.bias.fill_(float("nan"))
        return step(model, optimizer, batch, cfg)

    monkeypatch.setattr(engine, "train_step", nan_step)
    with torch.autograd.set_detect_anomaly(True, check_nan=False):
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            engine.train_net(tiny_cfg(tmp_path, debug_nans=True), 1, "cpu")
        assert torch.is_anomaly_enabled()
        assert not torch.is_anomaly_check_nan_enabled()
    assert seen == [(True, True)]
    assert not torch.is_anomaly_enabled()
    # the NaN step makes every weight NaN (the RoIs hit the map), and an
    # eval would then sample the DIN grid at NaN offsets: no eval here
    engine.train_net(tiny_cfg(tmp_path, test_interval_epoch=2), 1, "cpu")
    assert seen[-1] == (False, True)


def test_profile_dir_writes_a_trace(tmp_path):
    """``profile_dir`` traces the first epoch into a Chrome trace (CPU
    activities here) and nothing else."""
    prof = tmp_path / "prof"
    cfg = tiny_cfg(tmp_path, profile_dir=str(prof), max_epoch=2)
    engine.train_net(cfg, max_steps_per_epoch=1, device="cpu")
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    events = json.load(open(prof / traces[0]))["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)


def test_run_cli_flags():
    """``--auto-resume``, ``--train-to-epoch`` and ``--grad-accum-steps``
    override the preset (``is not None``: an explicit 0 counts); without
    them the preset's values stay."""
    base = ["--preset", "volleyball_stage2_dynamic"]
    cfg, _ = run.config_from_args(base)
    assert (cfg.auto_resume, cfg.train_to_epoch, cfg.grad_accum_steps) == \
        (False, None, 1)
    cfg, _ = run.config_from_args(base + [
        "--auto-resume", "--train-to-epoch", "0", "--grad-accum-steps", "2",
        "--exp-name", "e"])
    assert (cfg.auto_resume, cfg.train_to_epoch, cfg.grad_accum_steps,
            cfg.exp_name) == (True, 0, 2, "e")


@pytest.mark.parametrize("head", ["HiGCIN", "BiUTE"])
def test_head_report_counts_the_parameters_jax_counts(head, capsys,
                                                      monkeypatch):
    """The per-head report at the reference's probe shapes: the same
    parameter count as din_tpu's (FLOPs differ by design: matrix products
    and convolutions only, where XLA counts every operation)."""
    import sys

    from din_tpu.utils import profiling as jax_profiling
    from din_tpu_torch.utils import profiling

    profiling.main(["--head", head, "--device", "cpu"])
    ours = capsys.readouterr().out.strip().splitlines()
    monkeypatch.setattr(sys, "argv", ["profiling", "--head", head])
    jax_profiling.main()
    theirs = capsys.readouterr().out.strip().splitlines()
    assert len(ours) == len(theirs) == 1
    assert ours[0].split("#Params: ")[1] == theirs[0].split("#Params: ")[1]
    assert float(ours[0].split(": ")[1].split(" GFLOPs")[0]) > 0
