"""Graceful preemption and exact resume of the port, on the CPU (port of
din_tpu's tests/test_preempt.py to the port's ``train_net``).

An uninterrupted run and a run stopped after its second step and then
auto-resumed end bit for bit equal: parameters, BatchNorm buffers, Adam
state and every dropout generator, with dropout 0.3 on, in stage 2 (the
flagship on AlexNet at 96x128, a 2x3 map the RoIs hit) and in stage 1 (its
Basenet, on the same map).  The stop comes
from a fake guard and once from a real SIGTERM the process sends itself
after the second step.  Each epoch is exactly the 4 batches of an 8-clip
training set at batch 2 (``return_dataset`` patched) and no step cap:
din_tpu caps the resumed epoch at ``max_steps_per_epoch`` steps after the
skipped batches, so a cap would make the two runs train different steps.
"""

import os
import signal
import threading

import pytest
import torch

from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.nn.layers import SeededDropout
from din_tpu_torch.train import engine
from din_tpu_torch.train.preempt import PreemptionGuard
from test_torch_threads import one_thread  # noqa: F401 (autouse)
from test_torch_train_infra import assert_step_trains, tiny_cfg


class FakeGuard:
    """``should_stop`` turns True after ``after`` queries (one per step and
    one per eval batch)."""

    def __init__(self, after):
        self.after = after
        self.calls = 0

    @property
    def should_stop(self):
        self.calls += 1
        return self.calls > self.after

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


@pytest.fixture
def four_batches(monkeypatch):
    """An 8-clip training set (4 batches of 2) and 4 eval clips."""
    def datasets(cfg):
        return (SyntheticDataset(cfg, size=8, is_training=True, seed=1),
                SyntheticDataset(cfg, size=4, is_training=False, seed=2))

    monkeypatch.setattr(engine, "return_dataset", datasets)


@pytest.fixture
def last_state(monkeypatch):
    """The (model, optimizer) of the last ``train_step`` call."""
    seen = {}
    step = engine.train_step

    def recording(model, optimizer, batch, cfg):
        seen["model"], seen["optimizer"] = model, optimizer
        return step(model, optimizer, batch, cfg)

    monkeypatch.setattr(engine, "train_step", recording)
    return seen


def _cfg(tmp_path, stage, **kw):
    kw = dict(dict(train_dropout_prob=0.3, test_batch_size=4,
                   graceful_preemption=True), **kw)
    if stage == 2:
        return tiny_cfg(tmp_path, **kw)
    return PRESETS["volleyball_stage1"]().replace(**dict(
        dict(data_path="synthetic", backbone="alex", out_size=(2, 3),
             emb_features=256, image_size=(96, 128), num_boxes=4,
             num_features_boxes=64, compute_dtype="float32", batch_size=2,
             num_workers=1, result_root=str(tmp_path), max_epoch=1,
             test_before_train=False), **kw))


def _snapshot(seen):
    model, optimizer = seen["model"], seen["optimizer"]
    return (model.state_dict(), optimizer.state_dict(),
            {n: m.get_rng_state() for n, m in model.named_modules()
             if isinstance(m, SeededDropout)})


def _assert_equal(a, b):
    (sa, oa, ga), (sb, ob, gb) = a, b
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert oa["param_groups"] == ob["param_groups"]
    for i, s in oa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert sorted(ga) == sorted(gb) and len(ga) >= 1
    for k in ga:
        assert (ga[k] is None) == (gb[k] is None), k
        assert ga[k] is None or torch.equal(ga[k], gb[k]), k


def _preempt_files(cfg):
    return sorted(f for f in os.listdir(cfg.result_path)
                  if f.endswith("_preempt.pth"))


def _interrupt_and_resume(tmp_path, monkeypatch, stage, stop, **kw):
    """The uninterrupted run's and the stopped + resumed run's final
    snapshots, and the emergency file's payload."""
    seen = {"steps": 0, "kill_at": None}
    step = engine.train_step

    def recording(model, optimizer, batch, cfg):
        seen["model"], seen["optimizer"] = model, optimizer
        out = step(model, optimizer, batch, cfg)
        seen["steps"] += 1
        if seen["steps"] == seen["kill_at"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(engine, "train_step", recording)
    engine.train_net(_cfg(tmp_path, stage, exp_name="a", **kw),
                     device="cpu")
    whole = _snapshot(seen)

    if stop == "fake":
        monkeypatch.setattr(engine, "PreemptionGuard", lambda: FakeGuard(1))
    else:
        seen["kill_at"] = 2
    seen["steps"] = 0
    cfg = _cfg(tmp_path, stage, exp_name="b", **kw)
    engine.train_net(cfg, device="cpu")
    assert seen["steps"] == 2
    assert _preempt_files(cfg) == [f"stage{stage}_epoch0_preempt.pth"]
    log = open(cfg.log_path).read()
    assert "preemption: state saved to " in log
    assert "(epoch 1, 2 steps done)" in log and "Train at epoch" not in log
    saved = torch.load(os.path.join(cfg.result_path, _preempt_files(cfg)[0]),
                       weights_only=True)
    monkeypatch.setattr(engine, "PreemptionGuard", PreemptionGuard)
    seen["steps"], seen["kill_at"] = 0, None
    cfg = _cfg(tmp_path, stage, exp_name="b", auto_resume=True, **kw)
    engine.train_net(cfg, device="cpu")
    assert seen["steps"] == 2
    log = open(cfg.log_path).read()
    assert "resuming at epoch 1, step 2" in log or \
        "(epoch 1, step 2)" in log
    return whole, _snapshot(seen), saved


@pytest.mark.parametrize("stage", [2, 1])
def test_a_step_trains_trunk_embedding_and_head(tmp_path, stage):
    assert_step_trains(_cfg(tmp_path, stage))


@pytest.mark.parametrize("stage,stop", [(2, "fake"), (2, "sigterm"),
                                        (1, "fake")])
def test_interrupted_and_resumed_equals_uninterrupted(
        tmp_path, monkeypatch, four_batches, stage, stop):
    whole, resumed, saved = _interrupt_and_resume(tmp_path, monkeypatch,
                                                  stage, stop)
    assert saved["epoch"] == 0 and saved["step"] == 2
    assert sorted(saved) == ["dropout_rng", "epoch", "optimizer",
                             "state_dict", "step"]
    name = "dropout_global" if stage == 2 else "dropout_emb"
    assert saved["dropout_rng"][name] is not None
    _assert_equal(whole, resumed)
    if stage == 1:
        assert "Resuming stage1 from" in open(os.path.join(
            str(tmp_path), "b", "log.txt")).read()


def test_generators_unused_before_the_stop_stay_unused(
        tmp_path, monkeypatch, four_batches, last_state):
    """A stop during ``test_before_train`` saves the loaded state (epoch 0,
    step 0) before any mask was drawn: the file holds no generator state,
    the resumed run seeds the generator at its first mask, and ends equal
    to an uninterrupted run."""
    engine.train_net(_cfg(tmp_path, 2, exp_name="a",
                          test_before_train=True), device="cpu")
    whole = _snapshot(last_state)
    monkeypatch.setattr(engine, "PreemptionGuard", lambda: FakeGuard(0))
    cfg = _cfg(tmp_path, 2, exp_name="b", test_before_train=True)
    engine.train_net(cfg, device="cpu")
    saved = torch.load(os.path.join(cfg.result_path,
                                    "stage2_epoch0_preempt.pth"),
                       weights_only=True)
    assert saved["step"] == 0 and saved["dropout_rng"] == {
        "dropout_global": None}
    monkeypatch.setattr(engine, "PreemptionGuard", PreemptionGuard)
    model, _, start = engine.setup_training(
        cfg.replace(stage2model=os.path.join(
            cfg.result_path, "stage2_epoch0_preempt.pth"),
            load_stage2model=True), "cpu")
    assert start == 1 and model.dropout_global.generator is None
    engine.train_net(_cfg(tmp_path, 2, exp_name="b", test_before_train=True,
                          auto_resume=True), device="cpu")
    _assert_equal(whole, _snapshot(last_state))


def test_stop_during_eval_saves_the_epoch_complete(
        tmp_path, monkeypatch, four_batches):
    """A stop on the epoch's eval batch saves the trained epoch complete
    (epoch 1, step 0), writes no regular file and reports no eval; an
    ``eval_only`` pass stopped returns ``{"preempted": True}`` and writes
    nothing."""
    monkeypatch.setattr(engine, "PreemptionGuard", lambda: FakeGuard(4))
    cfg = _cfg(tmp_path, 2, exp_name="e", max_epoch=3)
    engine.train_net(cfg, device="cpu")
    assert _preempt_files(cfg) == ["stage2_epoch1_preempt.pth"]
    saved = torch.load(os.path.join(cfg.result_path,
                                    "stage2_epoch1_preempt.pth"),
                       weights_only=True)
    assert (saved["epoch"], saved["step"]) == (1, 0)
    assert not [f for f in os.listdir(cfg.result_path)
                if f.endswith("%.pth")]
    assert "====> Test" not in open(cfg.log_path).read()

    monkeypatch.setattr(engine, "PreemptionGuard", lambda: FakeGuard(0))
    ecfg = _cfg(tmp_path, 2, exp_name="o", eval_only=True)
    assert engine.train_net(ecfg, device="cpu") == {"preempted": True}
    assert sorted(os.listdir(ecfg.result_path)) == ["log.txt"]


def test_regular_file_resume_restarts_the_generators(
        tmp_path, four_batches):
    """Auto-resume from a regular stage-2 file (no step, no generator
    state) starts the next epoch with the generators at their seeds."""
    cfg = _cfg(tmp_path, 2, exp_name="r")
    engine.train_net(cfg, device="cpu")
    cfg = _cfg(tmp_path, 2, exp_name="r", auto_resume=True)
    cfg.init_config()
    path = engine.newest_resumable(cfg.result_path, 2)
    assert path.endswith("%.pth")
    model, _, start = engine.setup_training(
        cfg.replace(stage2model=path, load_stage2model=True), "cpu")
    assert start == 2 and model.dropout_global.generator is None


def test_guard_latches_sigterm_and_restores_the_handler():
    """A real SIGTERM inside the guard sets the flag instead of ending the
    process; the previous handler is back after; off the main thread the
    guard is inert."""
    got = []
    prev = signal.signal(signal.SIGTERM, lambda *a: got.append(a))
    try:
        before = signal.getsignal(signal.SIGTERM)
        with PreemptionGuard() as guard:
            assert guard.armed and not guard.should_stop
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):
                if guard.should_stop:
                    break
            assert guard.should_stop
        assert signal.getsignal(signal.SIGTERM) is before and not got
    finally:
        signal.signal(signal.SIGTERM, prev)

    result = {}

    def run():
        with PreemptionGuard() as guard:
            result["armed"], result["stop"] = guard.armed, guard.should_stop

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert result == {"armed": False, "stop": False}
