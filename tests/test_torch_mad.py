"""The MAD diagnostic against the JAX package, on the CPU.

``MADmeter`` (rect and dynamic fields) against din_tpu's on the same numpy
arrays: both are the same float64 numpy arithmetic, held within 1e-12.

The MAD nodes and value of the flagship and its ``_multi`` and
``_hierarchical`` heads: the same seeded weights (perturbed, so the DIN
walk leaves the integer grid) through din_tpu's ``make_mad_step`` and the
port's eval pass with ``measure_mad``, at 96x128 frames, T=3, N=4, NFB 64,
lite 16 in f32, on the AlexNet trunk (a 2x3 map of 256 channels, two rows
high so that the RoIs hit it and the nodes depend on the frames): the MAD
nodes are the head's, and AlexNet keeps din_tpu's compiles inside the
file's time budget (with VGG-16 the file took 47 s).  The eval set is 3
clips at batch 2, so the second batch holds a padded clip that
``sample_mask`` drops before the meter, on both sides.  Tolerances: the
nodes within 1e-5 of their largest |value| (the two frameworks' f32
convolutions differ by ~1e-6 through the trunk), the MAD value within 1e-5
relative.  ``measure_mad`` on a model that returns
no MAD nodes (``dynamic_collective``, ``dynamic_tce_volleyball``, a
Basenet) raises at setup, where din_tpu fails in the first eval
(ROADMAP.md §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.train.engine import init_model, make_mad_step
from din_tpu.utils import meters as jax_meters
from din_tpu.utils.meters import MADmeter as JaxMADmeter
from din_tpu_torch.data.loader import BatchLoader
from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.train import engine
from din_tpu_torch.utils import meters
from din_tpu_torch.utils.meters import MADmeter
from test_torch_train import _perturb, _torch_state
from test_torch_threads import one_thread  # noqa: F401 (autouse)
from test_torch_train_infra import assert_step_trains

GEOM = dict(image_size=(96, 128), num_frames=3, num_boxes=4,
            num_features_boxes=64, lite_dim=16, compute_dtype="float32",
            test_batch_size=2, backbone="alex", out_size=(2, 3),
            emb_features=256)
CPU = torch.device("cpu")


@pytest.mark.parametrize("field_shape,field", [
    ("rect", (3, 4)), ("rect", (3,)), ("rect", (1,)), ("dynamic", None)])
def test_madmeter_matches_jax(field_shape, field):
    rng = np.random.RandomState(7)
    shape = (2, 3, 4, 8) if field_shape == "rect" else (2, 12, 10, 8)
    ours, theirs = MADmeter(3, 4), JaxMADmeter(3, 4)
    for _ in range(2):
        x = rng.randn(*shape).astype(np.float32)
        ours.cal_MAD(x, field, field_shape)
        theirs.cal_MAD(x, field, field_shape)
    assert ours.B == theirs.B == 4
    np.testing.assert_allclose(ours.output_MAD(), theirs.output_MAD(),
                               rtol=1e-12)
    if field_shape == "rect":
        np.testing.assert_array_equal(
            MADmeter._rect_mask(3, 4, field),
            JaxMADmeter._rect_mask(3, 4, field))


@pytest.mark.parametrize("normalized", [False, True])
def test_average_and_confusion_meters_match_jax(normalized):
    """``AverageMeter`` and ``ConfusionMeter`` (labels and scores, as
    counts or row-normalised) equal din_tpu's on the same inputs."""
    rng = np.random.RandomState(8)
    ours, theirs = meters.AverageMeter(), jax_meters.AverageMeter()
    cm, jcm = (meters.ConfusionMeter(5, normalized),
               jax_meters.ConfusionMeter(5, normalized))
    for n in (3, 1, 4):
        v = float(rng.rand())
        ours.update(v, n)
        theirs.update(v, n)
        scores = rng.randn(n, 5)
        target = rng.randint(0, 5, n)
        cm.add(scores, target)
        jcm.add(scores, target)
        cm.add(scores.argmax(1), np.eye(5)[target])
        jcm.add(scores.argmax(1), np.eye(5)[target])
    assert (ours.val, ours.sum, ours.count, ours.avg) == (
        theirs.val, theirs.sum, theirs.count, theirs.avg)
    np.testing.assert_array_equal(cm.value(), jcm.value())
    with pytest.raises(ValueError):
        cm.add(np.zeros(2), np.zeros(3))


@pytest.mark.parametrize("name", [
    "volleyball_stage2_dynamic", "volleyball_stage2_dynamic_multi",
    "volleyball_stage2_dynamic_hierarchical"])
def test_mad_nodes_and_value_match_jax(name):
    jcfg = JAX_PRESETS[name]().replace(**GEOM)
    cfg = PRESETS[name]().replace(measure_mad=True, **GEOM)
    val = BatchLoader(SyntheticDataset(cfg, size=3, seed=2), 2,
                      shuffle=False, drop_last=False, pad_last=True)
    batches = list(val)
    assert batches[1]["sample_mask"].tolist() == [1.0, 0.0]
    jmodel = jax_build_model(jcfg)
    variables = init_model(jcfg, jmodel,
                           {k: v[:1] for k, v in batches[0].items()})
    params = _perturb(jax.device_get(variables["params"]),
                      np.random.RandomState(0))
    step = make_mad_step(jmodel, jcfg)
    meter = JaxMADmeter(cfg.num_frames, cfg.num_boxes)
    want = []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            nodes = np.asarray(step(params, {}, {
                k: jnp.asarray(v) for k, v in b.items()}))
            want.append(nodes)
            meter.cal_MAD(nodes[b["sample_mask"] > 0], None, "dynamic")

    model = build_model(cfg, device="cpu")
    model.load_state_dict(_torch_state(params, cfg), strict=True)
    for b, w in zip(batches, want):
        got = engine.eval_step(model, {k: torch.from_numpy(v)
                                       for k, v in b.items()}, cfg)
        nodes = got["mad_nodes"].numpy()
        # [B, T*N, 1 + k2 of the last field, lite]
        assert nodes.shape == w.shape and nodes.shape[:2] == (2, 12)
        assert np.abs(nodes - w).max() <= 1e-5 * np.abs(w).max()
    # the nodes depend on the frames: the first batch's two clips differ
    for n in (want[0], engine.eval_step(model, {
            k: torch.from_numpy(v) for k, v in batches[0].items()},
            cfg)["mad_nodes"].numpy()):
        assert np.abs(n[0] - n[1]).max() > 1e-3 * np.abs(n).max()
    info = engine.run_eval(model, val, cfg, 1, CPU)
    np.testing.assert_allclose(info["MAD"], meter.output_MAD(), rtol=1e-5)
    assert 0 < info["MAD"] < 2
    # the default forward is the same tensor as before: no MAD keys
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(batches[0]["images"]),
                           torch.from_numpy(batches[0]["boxes"]))
    assert sorted(out) == ["activities"]


@pytest.mark.parametrize("name", ["collective_stage2_dynamic",
                                  "volleyball_stage2_dynamic_tce",
                                  "volleyball_stage1"])
def test_measure_mad_without_mad_nodes_raises_at_setup(name):
    cfg = PRESETS[name]().replace(
        measure_mad=True, image_size=(64, 96), out_size=(2, 3),
        num_frames=3, num_features_boxes=64, compute_dtype="float32",
        load_backbone_stage2=False, pretrained_backbone_path=None)
    if cfg.backbone == "res18":
        cfg = cfg.replace(emb_features=512)
    with pytest.raises(ValueError, match="measure_mad needs a model"):
        engine.setup_training(cfg, "cpu")
    engine.setup_training(cfg.replace(measure_mad=False), "cpu")


def test_a_step_trains_trunk_embedding_and_head():
    """The geometry of the MAD tests trains the trunk, the embedding and
    the DIN head: its RoIs hit the map."""
    assert_step_trains(PRESETS["volleyball_stage2_dynamic"]().replace(
        data_path="synthetic", batch_size=2, load_backbone_stage2=False,
        num_workers=1, **GEOM))
