"""The port's Collective Activity data path against din_tpu's, on the CPU.

A Collective Activity tree in the reference layout
(``seqNN/annotations.txt``, tab-separated ``frame x y w h action`` lines;
``seqNN/frameNNNN.jpg``), written here with seeded noise JPEGs, goes
through din_tpu's and the port's parsers (majority vote without NA, the
6->5 action and 5->4 activity maps, the 10th-frame rule, a frame of only NA
skipped), datasets (stage 2 clips of T=10, stage 1's one random frame per
clip in training, zero padding to 13 with the true counts, truncation of a
crowded frame, the hflip of real boxes only), loaders and packed store, and
``return_dataset``.  Everything is compared bit for bit: both packages
decode with the same ``din_loader.cc`` built here.  Then ``run.py --device
cpu`` trains a ResNet-18 stage 1 and the collective stage 2 from the tree at
a tiny geometry and scores it with ``--eval-only``.
"""

import os
import re

import numpy as np
import pytest
import torch

from din_tpu.data import collective as jax_cad
from din_tpu.data.loader import BatchLoader as JaxBatchLoader
from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu_torch.data import collective as cad
from din_tpu_torch.data.datasets import return_dataset
from din_tpu_torch.data.loader import BatchLoader
from din_tpu_torch.data.packed import PackedFrameStore, pack_frames
from din_tpu_torch.experiments.presets import PRESETS
from test_torch_resnet import torchvision_res18_file
from test_torch_threads import one_thread  # noqa: F401 (autouse)

Image = pytest.importorskip("PIL.Image")

H, W = 32, 48            # frames as loaded: ResNet-18 makes a 1x2 map
FEAT = (1, 2)
JPEG = (24, 36)          # frames on disk (resized on load)
# sid -> {key frame: number of persons}; seq 2 frame 11 is crowded (16 >
# 13), seq 5 frame 1 has only NA actions and is skipped
SEQS = {1: {1: 5, 11: 13}, 2: {1: 3, 11: 16}, 5: {1: 4, 11: 6}}


def write_tree(root, seed=0):
    """Frames 1..20 of each sequence (noise JPEGs, quality 90) and their
    annotations: every frame lists its key frame's persons, boxes drifting
    a pixel a frame, actions 1..6 (1 = NA)."""
    rng = np.random.RandomState(seed)
    fh, fw = cad.FRAMES_SIZE[1]
    for sid, keys in SEQS.items():
        d = os.path.join(root, "seq%02d" % sid)
        os.makedirs(d)
        lines = []
        for key, n in keys.items():
            xy = np.stack([rng.randint(0, fw - 100, n),
                           rng.randint(0, fh - 150, n)], -1)
            acts = rng.randint(1, 7, n)
            if (sid, key) == (5, 1):
                acts[:] = 1
            for fid in range(key, key + 10):
                for (x, y), a in zip(xy + (fid - key), acts):
                    lines.append("%d\t%d\t%d\t%d\t%d\t%d" % (
                        fid, x, y, 60, 120, a))
        for fid in range(1, 21):
            img = (rng.rand(*JPEG, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, "frame%04d.jpg" % fid),
                                      quality=90)
        with open(os.path.join(d, "annotations.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("collective"))
    write_tree(root)
    return root


def _datasets(root, seqs=(1, 2), **kw):
    """(port, din_tpu) datasets of the same frames."""
    out = []
    for mod in (cad, jax_cad):
        anns = mod.collective_read_dataset(root, list(seqs))
        args = dict(anns=anns, frames=mod.collective_all_frames(anns),
                    images_path=root, image_size=(H, W), feature_size=FEAT,
                    num_boxes=13, num_frames=10, seed=3)
        args.update(kw)
        out.append(mod.CollectiveDataset(**args))
    return out


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_parser_and_constants_equal_din_tpu(tree):
    """Annotations of every sequence, the frame lists and the tables
    (FRAMES_NUM, FRAMES_SIZE, the label maps) equal din_tpu's; the frame
    of only NA actions is skipped, the crowded one keeps all 16 persons."""
    for name in ("FRAMES_NUM", "FRAMES_SIZE", "ACTIONS", "ACTIVITIES",
                 "ACTION6_TO_5", "ACTIVITY5_TO_4"):
        assert getattr(cad, name) == getattr(jax_cad, name), name
    ours = cad.collective_read_dataset(tree, [1, 2, 5])
    theirs = jax_cad.collective_read_dataset(tree, [1, 2, 5])
    assert ours == theirs
    assert cad.collective_all_frames(ours) == \
        jax_cad.collective_all_frames(theirs) == [
            (1, 1), (1, 11), (2, 1), (2, 11), (5, 11)]
    assert len(ours[2][11]["actions"]) == 16


@pytest.mark.parametrize("case", ["stage2_train", "stage2_eval",
                                  "stage1_train", "stage1_eval",
                                  "hflip"])
def test_items_and_batches_equal_din_tpu_for_two_epochs(tree, case):
    """4 decode threads, two epochs: every batch of the port's loader
    equals din_tpu's bit for bit (frames, boxes zero-padded to 13, actions
    padded with -1, per-frame counts capped at 13, activities, flips of
    real boxes only); stage 1 draws one frame per clip in training."""
    training = case != "stage2_eval" and case != "stage1_eval"
    kw = dict(is_training=training, is_finetune=case.startswith("stage1"))
    if case == "hflip":
        kw["hflip_prob"] = 0.5
    ours, theirs = _datasets(tree, **kw)
    a = BatchLoader(ours, 2, shuffle=training, num_workers=4, seed=5,
                    drop_last=training, pad_last=not training)
    b = JaxBatchLoader(theirs, 2, shuffle=training, num_workers=4, seed=5,
                       drop_last=training, pad_last=not training)
    T = 1 if case == "stage1_train" else 10
    for epoch in (1, 2):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        got, want = list(a), list(b)
        assert len(got) == len(want) == 2
        for x, y in zip(got, want):
            _assert_items_equal(x, y)
        assert got[0]["images"].shape == (2, T, H, W, 3)
        assert got[0]["boxes"].shape == (2, T, 13, 4)
        assert got[0]["bboxes_num"].shape == (2, T)
    items = [ours[i] for i in range(len(ours))]
    for it in items:
        n = it["bboxes_num"]
        real = np.arange(13)[None] < n[:, None]
        assert (it["boxes"][~real] == 0).all()
        assert (it["actions"][~real] == -1).all()
        assert (it["actions"][real] >= 0).all()
    assert sorted(int(it["bboxes_num"].max()) for it in items) == \
        [3, 5, 13, 13]


def test_hflip_mirrors_real_boxes_only(tree):
    """With hflip_prob=1 every item is the mirror of the unflipped one:
    frames reversed along W, real boxes x' = OW - x with x1/x2 swapped,
    padded boxes still zero, labels unchanged."""
    plain, _ = _datasets(tree, is_training=True)
    flip, _ = _datasets(tree, is_training=True, hflip_prob=1.0)
    for i in range(len(plain)):
        a, b = plain[i], flip[i]
        np.testing.assert_array_equal(b["images"], a["images"][:, :, ::-1])
        real = np.arange(13)[None] < a["bboxes_num"][:, None]
        want = np.stack([FEAT[1] - a["boxes"][..., 2], a["boxes"][..., 1],
                         FEAT[1] - a["boxes"][..., 0], a["boxes"][..., 3]],
                        -1)
        np.testing.assert_array_equal(b["boxes"][real], want[real])
        assert (b["boxes"][~real] == 0).all()
        for k in ("actions", "activities", "bboxes_num"):
            np.testing.assert_array_equal(b[k], a[k])


def test_return_dataset_from_tree_and_pack(tree, tmp_path):
    """``return_dataset`` of a collective config builds the split from the
    tree (stage 2: T=10 clips; stage 1: finetune items) and from its pack
    with equal items and no miss."""
    cfg = PRESETS["collective_stage2_dynamic"]().replace(
        data_path=tree, train_seqs=[1, 2], test_seqs=[5], image_size=(H, W),
        out_size=FEAT)
    train, val = return_dataset(cfg)
    assert isinstance(train, cad.CollectiveDataset)
    assert (len(train), len(val)) == (4, 1)
    assert train.is_training and not val.is_training and not train.is_finetune
    pack = str(tmp_path / "cad.pack")
    assert pack_frames(tree, pack, H, W) == 60
    ptrain, pval = return_dataset(cfg.replace(packed_frames_path=pack))
    assert isinstance(ptrain.cache, PackedFrameStore)
    for a, b in ((train, ptrain), (val, pval)):
        for i in range(len(a)):
            _assert_items_equal(b[i], a[i])
    assert ptrain.cache.misses == 0
    s1, _ = return_dataset(PRESETS["collective_stage1"]().replace(
        data_path=tree, train_seqs=[1], test_seqs=[5]))
    assert s1.is_finetune and s1.num_frames == 10


def test_collective_presets_equal_din_tpu():
    """The three new presets keep din_tpu's values in every field the port
    has, but the stage-1 path of ``collective_stage2_dynamic``, which is
    the port's ``.pth`` in place of din_tpu's msgpack ``.ckpt``."""
    from dataclasses import fields

    for name in ("collective_stage1", "collective_stage2_dynamic",
                 "synthetic_smoke"):
        ours, theirs = PRESETS[name](), JAX_PRESETS[name]()
        for f in fields(ours):
            if f.name == "stage1_model_path":
                continue
            assert getattr(ours, f.name) == getattr(theirs, f.name), (
                name, f.name)
    assert PRESETS["collective_stage2_dynamic"]().stage1_model_path == \
        "result/basemodel_CAD_res18.pth"


def test_run_cli_trains_both_stages_from_the_tree_and_scores(
        tree, tmp_path, monkeypatch):
    """``run.py --device cpu`` at 32x48 (NFB 64): a ResNet-18 stage 1 (the
    Inception-v3 preset with ``backbone="res18"``) from the tree, started
    from a torchvision ResNet-18 file (``--pretrained-backbone-path``),
    writes a component file whose backbone, BatchNorm statistics included,
    stage 2 grafts (``--stage1-model-path``); stage 2 trains on the tree's
    pack (``--packed-frames-path``) and writes a checkpoint;
    ``--eval-only`` of it scores the test split with the accuracy and loss
    of the training run's eval."""
    from din_tpu_torch.experiments import presets, run
    from din_tpu_torch.train.engine import setup_training

    small = dict(data_path=tree, train_seqs=[1, 2], test_seqs=[5],
                 image_size=(H, W), out_size=FEAT, num_frames=2,
                 num_features_boxes=64, compute_dtype="float32",
                 batch_size=2, test_batch_size=2, num_workers=2)
    monkeypatch.setitem(presets.PRESETS, "s1", lambda: PRESETS[
        "collective_stage1"]().replace(backbone="res18", emb_features=512,
                                       **small))
    monkeypatch.setitem(presets.PRESETS, "s2", lambda: PRESETS[
        "collective_stage2_dynamic"]().replace(**small))
    common = ["--max-epoch", "1", "--max-steps-per-epoch", "1", "--device",
              "cpu", "--result-root", str(tmp_path)]
    res18 = str(tmp_path / "resnet18.pth")
    torchvision_res18_file(res18)
    s1 = run.main(["--preset", "s1", "--exp-name", "s1",
                   "--pretrained-backbone-path", res18] + common)
    assert "Loaded pretrained backbone: " + res18 in (
        tmp_path / "s1" / "log.txt").read_text()
    assert os.path.basename(s1["checkpoint"]).startswith("stage1_epoch1_")
    comp = torch.load(s1["checkpoint"], weights_only=True)
    bb = comp["backbone_state_dict"]
    pretrained = torch.load(res18, weights_only=True)
    assert int(bb["features.1.num_batches_tracked"]) == int(
        pretrained["bn1.num_batches_tracked"]) + 1
    pack = str(tmp_path / "cad.pack")
    pack_frames(tree, pack, H, W)
    args = ["--preset", "s2", "--stage1-model-path", s1["checkpoint"],
            "--packed-frames-path", pack]
    cfg, _ = run.config_from_args(args + common)
    model, _, _ = setup_training(cfg.replace(result_root=str(tmp_path),
                                             exp_name="g").init_config(),
                                 "cpu")
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, bb[k]), k
    s2 = run.main(args + ["--exp-name", "s2"] + common)
    log = (tmp_path / "s2" / "log.txt").read_text()
    assert "Loaded stage1 backbone: " + s1["checkpoint"] in log
    ev = run.main(["--preset", "s2", "--stage2-model-path", s2["checkpoint"],
                   "--eval-only", "--exp-name", "ev"] + common)
    test_line = [ln for ln in log.splitlines() if "Test at epoch #1" in ln]
    assert len(test_line) == 1
    acc, loss = (float(v) for v in re.search(
        r"Group Activity Accuracy: ([0-9.]+)%, Loss: ([-0-9.e]+)",
        log[log.index(test_line[0]):]).groups())
    # the log prints 2 and 5 decimals
    assert abs(ev["activities_acc"] - acc) <= 5e-3
    assert abs(ev["loss"] - loss) <= 5e-6
