"""``train_net`` and ``run.py`` of the port on a Volleyball tree on disk, on
the CPU, against din_tpu.

Small geometry of tests/test_torch_train.py: full VGG-16 channels at 64x96
frames (a 2x3 map), T=3 (one frame either side of the clip's frame), N=4,
NFB 64, lite 16, float32, dropout 0; the tree of tests/test_torch_data.py
at 64x96 (videos 0 and 1 for training, 3 test clips in video 2, so the last
eval batch of 2 is padded).  ``--eval-only`` on din_tpu's weights, written
as a reference ``.pth`` and read by both packages, gives din_tpu's
``eval_only`` loss within rtol 1e-4 (float32 summation order of two
frameworks) and the same accuracy.
"""

import os

import jax
import numpy as np
import pytest
import torch

from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.nn.ref_export import save_reference_checkpoint
from din_tpu.train.engine import init_model
from din_tpu.train.engine import train_net as jax_train_net
from din_tpu_torch.data.packed import pack_frames
from din_tpu_torch.data.synthetic import make_synthetic_batch
from din_tpu_torch.experiments import presets, run
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.train import engine
from test_torch_data import write_tree
from test_torch_train import _perturb
from test_torch_threads import one_thread  # noqa: F401 (autouse)

H, W = 64, 96
CLIPS = {0: (10, 20), 1: (10, 20), 2: (10, 20, 30)}
_GEOM = dict(image_size=(H, W), out_size=(2, 3), num_frames=3, num_before=1,
             num_after=1, num_boxes=4, num_features_boxes=64,
             compute_dtype="float32", train_dropout_prob=0.0,
             weight_decay=1e-4, batch_size=2, test_batch_size=2,
             train_seqs=[0, 1], test_seqs=[2])
_STAGE2 = dict(_GEOM, lite_dim=16, load_backbone_stage2=False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ondisk")
    videos = str(root / "videos")
    write_tree(videos, clips=CLIPS, size=(H, W), short=(1, 20), seed=1)
    pack = str(root / "frames.pack")
    pack_frames(videos, pack, H, W)
    return videos, pack


@pytest.fixture
def tiny(monkeypatch):
    """Presets "tiny1" / "tiny2": the two stages at the small geometry."""
    monkeypatch.setitem(presets.PRESETS, "tiny1", lambda: PRESETS[
        "volleyball_stage1"]().replace(**_GEOM))
    monkeypatch.setitem(presets.PRESETS, "tiny2", lambda: PRESETS[
        "volleyball_stage2_dynamic"]().replace(**_STAGE2))


def _argv(preset, root, tmp_path, name, *extra):
    return ["--preset", preset, "--data-path", root, "--max-epoch", "1",
            "--max-steps-per-epoch", "2", "--device", "cpu",
            "--result-root", str(tmp_path), "--exp-name", name, *extra]


def _recording_steps(monkeypatch):
    """Records each training step's batch and loss inside train_net."""
    seen = []
    step = engine.train_step

    def train_step(model, optimizer, batch, cfg):
        m = step(model, optimizer, batch, cfg)
        seen.append(({k: v.clone() for k, v in batch.items()},
                     float(m["loss"])))
        return m

    monkeypatch.setattr(engine, "train_step", train_step)
    return seen


def test_train_net_from_the_tree_and_from_its_pack_agree(tree, tiny,
                                                         tmp_path,
                                                         monkeypatch):
    """The same run from the JPEGs and from ``--packed-frames-path``: the
    same batches, losses and written weights, bit for bit."""
    root, pack = tree
    seen = _recording_steps(monkeypatch)
    best = run.main(_argv("tiny2", root, tmp_path, "jpeg"))
    best_p = run.main(_argv("tiny2", root, tmp_path, "pack",
                            "--packed-frames-path", pack))
    assert len(seen) == 4
    for (a, la), (b, lb) in zip(seen[:2], seen[2:]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert la == lb and np.isfinite(la)
    assert seen[0][0]["images"].shape == (2, 3, H, W, 3)
    sa = torch.load(best["checkpoint"], weights_only=True)["state_dict"]
    sb = torch.load(best_p["checkpoint"], weights_only=True)["state_dict"]
    assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    for key in ("epoch", "activities_acc", "loss"):
        assert best.get(key) == best_p.get(key), key


def test_eval_only_on_din_tpu_weights_gives_din_tpu_eval(tree, tiny,
                                                         tmp_path):
    """din_tpu's perturbed flagship weights as a reference ``.pth``:
    din_tpu's ``train_net(eval_only)`` and the port's ``run.py --eval-only
    --ref-checkpoint-path`` score the test split alike (loss rtol 1e-4, the
    same accuracy and confusion), train nothing and write no file."""
    root, _ = tree
    cfg = PRESETS["tiny2"]()
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]().replace(
        folded_stem=False, **_STAGE2)
    jmodel = jax_build_model(jcfg)
    batch = make_synthetic_batch(cfg, 1, rng=np.random.RandomState(0))
    params = _perturb(jax.device_get(
        init_model(jcfg, jmodel, batch)["params"]), np.random.RandomState(0))
    ref = str(tmp_path / "din_tpu_weights.pth")
    save_reference_checkpoint({"params": params}, jcfg, ref, fmt="full",
                              epoch=3)

    want = jax_train_net(jcfg.replace(
        data_path=root, ref_checkpoint_path=ref, eval_only=True,
        result_root=str(tmp_path), exp_name="jax", num_workers=2))
    got = run.main(_argv("tiny2", root, tmp_path, "port", "--eval-only",
                         "--ref-checkpoint-path", ref))
    assert got["epoch"] == want["epoch"] == 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["activities_acc"] == want["activities_acc"]
    np.testing.assert_array_equal(got["activities_conf"],
                                  want["activities_conf"])
    assert sorted(got) == sorted(want)
    assert got["activities_MPCA"] == want["activities_MPCA"]
    # no checkpoint: the log and its metrics stream only
    assert sorted(os.listdir(tmp_path / "port")) == [
        "log.txt", "metrics.jsonl"]
    log = (tmp_path / "port" / "log.txt").read_text()
    assert "====> Test at epoch #0" in log and "Train at epoch" not in log


def test_eval_only_reproduces_the_eval_of_a_port_checkpoint(tree, tiny,
                                                           tmp_path,
                                                           monkeypatch):
    """``--stage2-model-path <train_net's checkpoint> --eval-only``: the
    train run's eval exactly, logged at the checkpoint's epoch, no step."""
    root, _ = tree
    evals = []
    run_eval = engine.run_eval

    def recording_eval(*args, **kwargs):
        evals.append(run_eval(*args, **kwargs))
        return evals[-1]

    monkeypatch.setattr(engine, "run_eval", recording_eval)
    best = run.main(_argv("tiny2", root, tmp_path, "train"))
    seen = _recording_steps(monkeypatch)
    info = run.main(_argv("tiny2", root, tmp_path, "score",
                          "--stage2-model-path", best["checkpoint"],
                          "--eval-only"))
    assert seen == [] and len(evals) == 2
    assert info["epoch"] == 1
    for key in ("loss", "activities_acc", "activities_MPCA"):
        assert info[key] == evals[0][key], key
    # no checkpoint: the log and its metrics stream only
    assert sorted(os.listdir(tmp_path / "score")) == [
        "log.txt", "metrics.jsonl"]


def test_test_before_train_logs_an_eval_at_epoch_0(tree, tiny, tmp_path,
                                                   monkeypatch):
    """Stage 1 from the tree (its preset sets ``test_before_train``): an
    eval at epoch 0 before the first epoch, on 3-frame eval clips (the
    finetune eval policy) while training clips have 1 frame; the eval does
    not count as the best."""
    root, _ = tree
    seen = _recording_steps(monkeypatch)
    best = run.main(_argv("tiny1", root, tmp_path, "s1"))
    log = (tmp_path / "s1" / "log.txt").read_text()
    assert log.index("====> Test at epoch #0") < log.index(
        "Train at epoch #1") < log.index("====> Test at epoch #1")
    assert best["epoch"] == 1 or best["activities_acc"] == 0.0
    assert len(seen) == 2 and seen[0][0]["images"].shape[1] == 1
    off = run.main(_argv("tiny2", root, tmp_path, "s2"))
    assert "Test at epoch #0" not in (tmp_path / "s2" / "log.txt").read_text()
    assert off["checkpoint"].endswith(".pth")


def test_run_cli_takes_the_three_new_flags(tree, tiny, tmp_path):
    """``--packed-frames-path``, ``--hflip-prob`` and ``--eval-only`` reach
    the config, and run on the CPU: one eval pass from the pack."""
    root, pack = tree
    argv = _argv("tiny2", root, tmp_path, "flags", "--packed-frames-path",
                 pack, "--hflip-prob", "0.5", "--eval-only")
    cfg, _ = run.config_from_args(argv)
    assert (cfg.packed_frames_path, cfg.hflip_prob, cfg.eval_only) == (
        pack, 0.5, True)
    plain, _ = run.config_from_args(_argv("tiny2", root, tmp_path, "x"))
    assert (plain.packed_frames_path, plain.hflip_prob, plain.eval_only) == (
        None, 0.0, False)
    info = run.main(argv)
    assert info["epoch"] == 0 and np.isfinite(info["loss"])
    # no checkpoint: the log and its metrics stream only
    assert sorted(os.listdir(tmp_path / "flags")) == [
        "log.txt", "metrics.jsonl"]
