"""The port's Inception-v3 against the JAX package, on the CPU, in float32
(JAX under ``default_matmul_precision("highest")``), and its torchvision
file and ``run.py --preset collective_stage1``.

din_tpu's ``InceptionV3Backbone`` gets seeded weights drawn with numpy over
the shapes of ``jax.eval_shape`` of its ``init`` (a jitted init of
Inception-v3 costs ~10 s on a CPU host): conv kernels at their init scale,
BatchNorm affines and statistics away from (1, 0, 0, 1).  The port gets the
same weights through ``export_backbone_state``.  Frames are 96x128, where
Mixed_5d is 9x13 and Mixed_6e 4x6.  The reference-layout files of an
Inception-v3 stage 1 are held here too;
tests/test_torch_inception_model.py holds the ``collective_stage1`` model.

Tolerances: the maps in eval mode within rtol 1e-4 / atol 1e-5 of the
map's largest magnitude (f32 summation order over 70 convs); in train
mode, where both frameworks take the variance as E[x^2] - E[x]^2 in f32,
which cancels, within 1e-3 of the largest magnitude and no farther from a
float64 run of the port than din_tpu's map, plus 1e-6 of the largest
(tests/test_torch_resnet.py explains the yardstick), and so are the
running statistics, tensor by tensor (measured: the port's at most 7.6e-9
of the largest farther from the float64 run, the two up to 1.6e-5 of the
largest apart).
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.nn.backbones import InceptionV3Backbone as JaxInception
from din_tpu.nn.ref_export import save_reference_checkpoint
from din_tpu.nn.torch_port import convert_backbone_state, torch_file_to_numpy
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.backbones import InceptionV3Backbone
from din_tpu_torch.nn.ref_export import (export_backbone_state,
                                         jax_params_to_state_dict)
from din_tpu_torch.nn.ref_import import (load_pretrained_backbone,
                                         load_reference_checkpoint)
from din_tpu_torch.train.checkpoint import (load_backbone_stage2,
                                            save_stage1_components)
from din_tpu_torch.train.engine import setup_training
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_HW = (96, 128)
_MAPS = ((9, 13), (4, 6))                    # Mixed_5d, Mixed_6e at _HW
_STATS = ("running_mean", "running_var")


def seeded(tree, rng):
    """numpy values for a tree of shapes (``jax.eval_shape``): kernels
    N(0, 2/fan_in), BatchNorm scale 1 + 0.1 N, biases 0.05 N, means 0.1 N,
    variances 1 + U(-0.5, 0.5)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = seeded(v, rng)
            continue
        shape = v.shape
        if k == "kernel":
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif k == "scale":
            a = 1 + 0.1 * rng.randn(*shape)
        elif k == "var":
            a = 1 + rng.uniform(-0.5, 0.5, shape)
        else:                                   # bias, mean
            a = (0.05 if k == "bias" else 0.1) * rng.randn(*shape)
        out[k] = a.astype(np.float32)
    return out


def _torch(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


@pytest.fixture(scope="module")
def inv3():
    """Seeded JAX Inception-v3 variables, 2 frames, din_tpu's maps and
    updated ``batch_stats`` in eval and in train mode (one jitted call),
    and the port's maps and state after an eval-mode and a train-mode call,
    and in float64 after a train-mode call (``port``).  din_tpu's program
    compiles and runs in a second thread while the port runs (XLA releases
    the interpreter)."""
    jmodel = JaxInception(dtype=jnp.float32)
    x = np.random.RandomState(1).uniform(-1, 1, (2, *_HW, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x[:1])
    rng = np.random.RandomState(2)
    params = seeded(shapes["params"], rng)
    stats = seeded(shapes["batch_stats"], rng)
    variables = {"params": params, "batch_stats": stats}

    def both(v, x):
        return {mode: jmodel.apply(v, x, mode == "train",
                                   mutable=["batch_stats"])
                for mode in ("eval", "train")}

    with jax.default_matmul_precision("highest"):
        program = jax.jit(both).lower(variables, x)
    with ThreadPoolExecutor(1) as pool:
        out = pool.submit(lambda: jax.device_get(
            program.compile()(variables, x)))
        model = _port_backbone(params, stats)
        runs = {"eval": copy.deepcopy(model).eval(),
                "train": copy.deepcopy(model).train(),
                "exact": copy.deepcopy(model).double().train()}
        port = {}
        with torch.no_grad():
            for mode, m in runs.items():
                maps = m(torch.from_numpy(x).to(next(m.parameters()).dtype))
                port[mode] = ([y.numpy() for y in maps], m.state_dict())
        out = out.result()
    return dict(params=params, stats=stats, x=x, out=out, port=port)


def _port_backbone(params, stats):
    model = InceptionV3Backbone(torch.Generator().manual_seed(0))
    model.load_state_dict(_torch(export_backbone_state(params, stats,
                                                       "inv3")), strict=True)
    return model


def _close(got, want, what):
    """rtol 1e-4 / atol 1e-5 of the tensor's largest |value|."""
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


def check_against_f64(got, want, exact, what):
    """Train-mode BatchNorm: ``got`` (the port, f32) within 1e-3 of
    ``want``'s (din_tpu's) largest |value| of it, and no farther from
    ``exact`` (the port in float64) than ``want`` is, plus 1e-6 of the
    largest."""
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale, what
    assert np.abs(got - exact).max() <= np.abs(want - exact).max() \
        + 1e-6 * scale, what


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_inception_v3_matches_jax(inv3, mode):
    """The two maps equal din_tpu's (Mixed_5d 288 channels, then Mixed_6e
    768) within the module docstring's bounds; in train mode every running
    mean and variance is held to din_tpu's updated ``batch_stats`` as the
    maps are and each ``num_batches_tracked`` is 1; in eval mode they stay
    (within rtol 1e-4 / atol 1e-5 of the largest)."""
    train = mode == "train"
    refs, new = inv3["out"][mode]
    got, state = inv3["port"][mode]
    exact_maps, exact_state = inv3["port"]["exact"]
    assert [g.shape for g in got] == [(2, *hw, c) for hw, c in
                                      zip(_MAPS, (288, 768))]
    for g, r, e in zip(got, refs, exact_maps):
        if train:
            check_against_f64(g, np.asarray(r), e, "map")
        else:
            _close(g, np.asarray(r), "map")
    ref = export_backbone_state({}, new["batch_stats"], "inv3")
    pairs = [k for k in ref if k.endswith(_STATS)]
    assert len(pairs) == 2 * 70
    for k in pairs:
        if train:
            check_against_f64(state[k].numpy(), np.asarray(ref[k]),
                              exact_state[k].numpy(), k)
        else:
            _close(state[k].numpy(), np.asarray(ref[k]), k)
    counts = {int(v) for k, v in state.items()
              if k.endswith("num_batches_tracked")}
    assert counts == ({1} if train else {0})


def torchvision_inception_file(path, params, stats, seed=7):
    """JAX Inception-v3 variables as a torchvision-layout ``state_dict``
    file: the backbone's modules with BatchNorm statistics (counts
    random), and stand-ins of the modules the backbone leaves out
    (``AuxLogits``, ``Mixed_7a``-``7c``, ``fc``).  Returns its tensors."""
    rng = np.random.RandomState(seed)
    state = _torch(export_backbone_state(params, stats, "inv3"))
    for k in state:
        if k.endswith("num_batches_tracked"):
            state[k] = torch.tensor(rng.randint(1, 100))
    for k in ("AuxLogits.conv0.conv.weight", "Mixed_7a.branch3x3_1.conv."
              "weight", "Mixed_7c.branch_pool.bn.running_mean",
              "fc.weight", "fc.bias"):
        state[k] = torch.zeros(4, 3)
    torch.save(state, path)
    return state


def test_torchvision_inception_file_loads_strictly_and_matches_jax(
        inv3, tmp_path):
    """A torchvision Inception-v3 file through ``pretrained_backbone_path``
    (``collective_stage1``): every ``backbone`` tensor, BatchNorm statistics
    included, equals the file's (``AuxLogits``, ``Mixed_7*`` and ``fc``
    unused); din_tpu's ``convert_backbone_state`` reads the same file into
    the fixture's variables, and both eval-mode maps of the loaded backbone
    equal din_tpu's on them within rtol 1e-4 / atol 1e-5 of the largest.
    A file that lacks one of the backbone's tensors raises."""
    path = str(tmp_path / "inception_v3.pth")
    state = torchvision_inception_file(path, inv3["params"], inv3["stats"])
    cfg = PRESETS["collective_stage1"]().replace(
        image_size=_HW, out_size=_MAPS[0], num_frames=2,
        num_features_boxes=64, compute_dtype="float32",
        pretrained_backbone_path=path)
    model, _, _ = setup_training(cfg, "cpu")
    loaded = model.backbone.state_dict()
    assert len(loaded) == len(state) - 5 == 420
    for k, v in loaded.items():
        assert torch.equal(v, state[k]), k

    conv = convert_backbone_state(torch_file_to_numpy(path), "inv3")
    for tree, want in ((conv["params"], inv3["params"]),
                       (conv["batch_stats"], inv3["stats"])):
        flat = jax.tree_util.tree_leaves_with_path(want)
        for path_, v in flat:
            got = tree
            for key in path_:
                got = got[key.key]
            np.testing.assert_array_equal(got, v)
    with torch.no_grad():
        got = model.backbone.eval()(torch.from_numpy(inv3["x"]))
    for g, r in zip(got, inv3["out"]["eval"][0]):
        _close(g.numpy(), np.asarray(r), "map")
    del state["Mixed_6e.branch_pool.bn.running_var"]
    torch.save(state, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pretrained_backbone(model, path)


def test_run_cli_trains_collective_stage1_on_cpu(inv3, tmp_path,
                                                 monkeypatch):
    """``run.py --preset collective_stage1 --device cpu`` at 96x128, T=2,
    from a torchvision Inception-v3 file: one step of one epoch, an eval
    pass, a log and a stage-1 component file whose backbone holds the
    trained weights and live BatchNorm statistics."""
    from din_tpu_torch.experiments import presets, run

    path = str(tmp_path / "inception_v3.pth")
    torchvision_inception_file(path, inv3["params"], inv3["stats"])
    monkeypatch.setitem(presets.PRESETS, "tiny_cad_s1", lambda: PRESETS[
        "collective_stage1"]().replace(
        image_size=_HW, out_size=_MAPS[0], num_frames=2, batch_size=2,
        test_batch_size=2, num_features_boxes=64, compute_dtype="float32"))
    best = run.main(["--preset", "tiny_cad_s1", "--data-path", "synthetic",
                     "--max-epoch", "1", "--max-steps-per-epoch", "1",
                     "--device", "cpu", "--result-root", str(tmp_path),
                     "--exp-name", "e", "--pretrained-backbone-path", path])
    log = (tmp_path / "e" / "log.txt").read_text()
    assert "Train at epoch #1" in log and "====> Test at epoch #1" in log
    comp = torch.load(best["checkpoint"], weights_only=True)
    bb = comp["backbone_state_dict"]
    file = torch.load(path, weights_only=True)
    assert len(bb) == 420
    assert int(bb["Conv2d_1a_3x3.bn.num_batches_tracked"]) > int(
        file["Conv2d_1a_3x3.bn.num_batches_tracked"])
    assert not torch.equal(bb["Mixed_6e.branch_pool.conv.weight"],
                           file["Mixed_6e.branch_pool.conv.weight"])
    assert comp["fc_emb_state_dict"]["weight"].shape == (64, 25 * 1056)


def test_reference_inception_stage1_files_load(tmp_path):
    """din_tpu's reference-layout files of an Inception-v3 stage 1
    (``collective_stage1`` at 96x128, NFB 64, seeded variables over the
    shapes of its init; the component file and the full-model file, keys
    ``backbone.Conv2d_1a_3x3.conv.weight`` ...) load through
    ``nn/ref_import.py`` with no key skipped into a port model of zeros,
    which then equals the one the weights came from; the port's own
    component file of that model grafts its backbone, BatchNorm buffers
    included, and ``fc_emb`` into a stage-2 model with ``backbone="inv3"``
    (``load_backbone_stage2``)."""
    geom = dict(image_size=_HW, out_size=_MAPS[0], num_frames=3,
                num_features_boxes=64, compute_dtype="float32")
    jcfg = JAX_PRESETS["collective_stage1"]().replace(**geom)
    cfg = PRESETS["collective_stage1"]().replace(**geom)
    T, N = cfg.num_frames, cfg.num_boxes
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, T, *_HW, 3), np.uint8),
        np.zeros((1, T, N, 4), np.float32),
        bboxes_num=np.ones((1, T), np.int32), train=False))
    rng = np.random.RandomState(4)
    variables = {"params": seeded(shapes["params"], rng),
                 "batch_stats": seeded(shapes["batch_stats"], rng)}
    src = build_model(cfg, device="cpu")
    src.load_state_dict(_torch(jax_params_to_state_dict(
        variables["params"], cfg, variables["batch_stats"])), strict=True)
    want = src.state_dict()
    for fmt in ("stage1", "full"):
        path = str(tmp_path / f"{fmt}.pth")
        save_reference_checkpoint(variables, jcfg, path, fmt=fmt)
        model = copy.deepcopy(src)
        with torch.no_grad():
            for v in model.state_dict().values():
                v.zero_()
        assert load_reference_checkpoint(model, path) == []
        for k, v in model.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, want[k]), (fmt, k)
    comp = str(tmp_path / "basemodel_CAD_inv3.pth")
    save_stage1_components(comp, src)
    s2 = PRESETS["collective_stage2_dynamic"]().replace(
        backbone="inv3", image_size=_HW, out_size=_MAPS[0],
        emb_features=1056, num_frames=3, num_features_boxes=64,
        compute_dtype="float32", load_backbone_stage2=False)
    model = build_model(s2, device="cpu")
    load_backbone_stage2(model, comp)
    got = model.state_dict()
    grafted = [k for k in want if k.startswith(("backbone.", "fc_emb."))]
    assert len(grafted) == 420 + 2
    for k in grafted:
        key = "fc_emb_1." + k[len("fc_emb."):] if k.startswith("fc_emb.") \
            else k
        assert torch.equal(got[key], want[k]), k
