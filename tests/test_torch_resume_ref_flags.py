"""Auto-resume with the reference-optimizer flags set, on the CPU.

A run started from a reference ``.pth`` with ``--ref-checkpoint-path`` and
``--ref-resume-optimizer`` and relaunched with ``--auto-resume`` on the same
command line continues from its own ``_preempt.pth``: its Adam state (with
its step), epoch, step and dropout generators, not the reference file's.
So a run stopped after the second step of its second epoch and resumed
ends bit for bit where the uninterrupted run ends.  din_tpu adopts the
reference file's Adam state and then restores the resumed one over it, but
takes the start epoch from the reference file (din_tpu/train/engine.py:376,
:420); the port keeps the resumed epoch (ROADMAP.md §3).

The flagship on AlexNet at 96x128 (a 2x3 map the RoIs hit), dropout 0.3,
epochs of exactly 4 batches (``four_batches``), the reference file at epoch
1, so the runs train epochs 2 and 3 (``train_to_epoch`` 3).
"""

import os

import torch

from chip_smoke import reference_ordered
from din_tpu_torch.data.loader import BatchLoader, to_device
from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.train import engine
from din_tpu_torch.train.optim import make_optimizer
from din_tpu_torch.train.preempt import PreemptionGuard
from test_torch_preempt import (FakeGuard, _assert_equal, _cfg,  # noqa: F401
                                _snapshot, four_batches)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def _reference_file(tmp_path):
    """The flagship's seeded weights after one Adam step, written at epoch 1
    as the reference framework writes a full checkpoint."""
    cfg = _cfg(tmp_path, 2, exp_name="ref")
    model = build_model(cfg, device="cpu")
    optimizer = make_optimizer(cfg, model)
    batch = next(iter(BatchLoader(SyntheticDataset(cfg, seed=9), 2, seed=0)))
    engine.train_step(model, optimizer, to_device(batch, torch.device("cpu")),
                      cfg)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    path = str(tmp_path / "ref.pth")
    torch.save(reference_ordered({"epoch": 1,
                                  "state_dict": model.state_dict(),
                                  "optimizer": optimizer.state_dict()},
                                 names), path)
    return path


def test_resume_with_reference_flags_equals_uninterrupted(
        tmp_path, monkeypatch, four_batches):
    flags = dict(ref_checkpoint_path=_reference_file(tmp_path),
                 ref_resume_optimizer=True, auto_resume=True,
                 train_to_epoch=3)
    seen = {"steps": 0}
    step = engine.train_step

    def recording(model, optimizer, batch, cfg):
        seen["model"], seen["optimizer"] = model, optimizer
        seen["steps"] += 1
        return step(model, optimizer, batch, cfg)

    monkeypatch.setattr(engine, "train_step", recording)
    cfg = _cfg(tmp_path, 2, exp_name="a", **flags)
    engine.train_net(cfg, device="cpu")
    assert seen["steps"] == 8
    whole = _snapshot(seen)
    whole_files = sorted(os.listdir(cfg.result_path))

    # stop after step 2 of epoch 3: 4 steps and an eval batch of epoch 2,
    # then 2 steps (one guard query each)
    monkeypatch.setattr(engine, "PreemptionGuard", lambda: FakeGuard(6))
    seen["steps"] = 0
    cfg = _cfg(tmp_path, 2, exp_name="b", **flags)
    engine.train_net(cfg, device="cpu")
    assert seen["steps"] == 6
    saved = torch.load(os.path.join(cfg.result_path,
                                    "stage2_epoch2_preempt.pth"),
                       weights_only=True)
    assert (saved["epoch"], saved["step"]) == (2, 2)

    monkeypatch.setattr(engine, "PreemptionGuard", PreemptionGuard)
    seen["steps"] = 0
    engine.train_net(cfg, device="cpu")
    assert seen["steps"] == 2
    log = open(cfg.log_path).read()
    assert "resuming at epoch 3, step 2" in log
    assert "Kept the resumed optimizer state" in log
    _assert_equal(whole, _snapshot(seen))
    # the Adam step of every parameter is the uninterrupted run's 8 plus
    # the reference file's 1
    steps = {float(s["step"]) for s in
             seen["optimizer"].state_dict()["state"].values()}
    assert steps == {9.0}
    # both runs end with epoch 3's file, epoch 3 inside
    last = [f for f in whole_files if f.startswith("stage2_epoch3_")]
    assert len(last) == 1 and last[0] in os.listdir(cfg.result_path)
    for d in ("a", "b"):
        assert torch.load(os.path.join(str(tmp_path), d, last[0]),
                          weights_only=True)["epoch"] == 3
