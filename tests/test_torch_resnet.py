"""The port's ResNet-18 and its BatchNorm against the JAX package, on the CPU.

din_tpu's ``ResNet18Backbone`` (canonical stem, ``folded_stem=False``: the
folded stem is a layout for the TPU's lanes, equal in value) and
din_tpu_torch's get the same seeded weights, with every BatchNorm's affine
and running statistics perturbed away from their init, and the same frames
in [-1, 1] at 64x96 (a 2x3 map), in float32 (JAX under
``default_matmul_precision("highest")``).  Tolerances: maps within rtol
1e-4 plus an atol of 1e-5 of the map's largest magnitude (f32 summation
order over 20 layers: an element near 0 carries the rounding of sums of
the map's scale) where BatchNorm uses its running statistics; running
statistics within 1e-5; gradients
within 1e-4 of each tensor's largest, the bound of
tests/test_torch_train.py where no ReLU or pool flip reaches them.

Where BatchNorm normalises with the batch's statistics, both frameworks
compute the variance as E[x^2] - E[x]^2 in f32, which cancels: at this
seed din_tpu's map lies 1.0e-4 from a float64 run of the same network (of
values up to 7.7) and the port's 4.9e-5, so elementwise atol 1e-5 cannot
hold between them.  There the maps are held within 1e-4 of the map's
largest magnitude of each other, and the port no farther from the float64
run than din_tpu.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.models.trunk import Trunk
from din_tpu.nn.backbones import ResNet18Backbone as JaxRes18
from din_tpu.nn.layers import TorchBatchNorm as JaxBatchNorm
from din_tpu.nn.torch_port import convert_backbone_state, torch_file_to_numpy
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.models.trunk import trunk_forward
from din_tpu_torch.nn.backbones import RESNET_SEQ, ResNet18Backbone
from din_tpu_torch.nn.layers import TorchBatchNorm
from din_tpu_torch.nn.ref_export import export_backbone_state
from din_tpu_torch.nn.ref_import import load_pretrained_backbone
from din_tpu_torch.train.engine import setup_training
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_HW = (64, 96)
_BN_KEYS = ("running_mean", "running_var")


def perturb_bn(params, stats, rng):
    """BatchNorm affines and statistics away from (1, 0, 0, 1): the scale
    times 1 + 0.1 N(0,1), the bias plus 0.05 N(0,1), the mean 0.1 N(0,1),
    the variance 1 + U(-0.5, 0.5)."""
    def walk(p, s):
        p, s = dict(p), dict(s)
        for k in p:
            if k in s and "mean" in s[k]:
                sc, b = np.asarray(p[k]["scale"]), np.asarray(p[k]["bias"])
                p[k] = {"scale": (sc * (1 + 0.1 * rng.randn(*sc.shape))
                                  ).astype(np.float32),
                        "bias": (b + 0.05 * rng.randn(*b.shape)
                                 ).astype(np.float32)}
                s[k] = {"mean": (0.1 * rng.randn(*sc.shape)
                                 ).astype(np.float32),
                        "var": (1 + rng.uniform(-0.5, 0.5, sc.shape)
                                ).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                p[k], s[k] = walk(p[k], s[k])
        return p, s
    return walk(params, stats)


def _to_port(params, stats) -> ResNet18Backbone:
    model = ResNet18Backbone(torch.Generator().manual_seed(0))
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in
         export_backbone_state(params, stats, "res18").items()}, strict=True)
    return model


@pytest.fixture(scope="module")
def res18():
    """Perturbed JAX ResNet-18 variables, the port's backbone with them, and
    4 frames."""
    jmodel = JaxRes18(dtype=jnp.float32, folded_stem=False)
    x = np.random.RandomState(1).uniform(-1, 1, (4, *_HW, 3)).astype(
        np.float32)
    variables = jax.device_get(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), x[:1]))
    params, stats = perturb_bn(variables["params"], variables["batch_stats"],
                               np.random.RandomState(2))
    return dict(jmodel=jmodel, params=params, stats=stats, x=x)


def f64_port(params, stats) -> ResNet18Backbone:
    """The port's backbone in float64 (its BatchNorm keeps float64), the
    yardstick of both frameworks' float32 rounding."""
    return _to_port(params, stats).double()


def _jax_apply(r, train):
    with jax.default_matmul_precision("highest"):
        return r["jmodel"].apply(
            {"params": r["params"], "batch_stats": r["stats"]}, r["x"],
            train, mutable=["batch_stats"])


def _stats_of(port_state, jax_stats):
    """(port, JAX) running statistics of every BatchNorm, by port key."""
    ref = export_backbone_state({}, jax_stats, "res18")
    return [(port_state[k].numpy(), v) for k, v in ref.items()
            if k.endswith(_BN_KEYS)]


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet18_matches_jax(res18, mode):
    """The backbone's map equals din_tpu's with BatchNorm on its running
    statistics (eval: rtol 1e-4, atol 1e-5 max|y|) and on the batch's (train:
    within 1e-4 of max|y|, and no farther from a float64 run than
    din_tpu's, the module docstring says why); in train mode every running
    mean and variance after the call equals din_tpu's updated
    ``batch_stats`` within 1e-5 and each ``num_batches_tracked`` is 1, in
    eval mode they are unchanged."""
    train = mode == "train"
    (ref,), new_vars = _jax_apply(res18, train)
    ref = np.asarray(ref)
    model = _to_port(res18["params"], res18["stats"]).train(train)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(torch.from_numpy(res18["x"])).numpy()
    assert got.shape == ref.shape == (4, 2, 3, 512)
    if train:
        with torch.no_grad():
            exact = f64_port(res18["params"], res18["stats"]).train()(
                torch.from_numpy(res18["x"]).double()).numpy()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
        assert np.abs(got - exact).max() <= np.abs(ref - exact).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())
    state = model.state_dict()
    pairs = _stats_of(state, new_vars["batch_stats"])
    assert len(pairs) == 2 * 20
    for p, j in pairs:
        np.testing.assert_allclose(p, np.asarray(j), rtol=0, atol=1e-5)
    counts = {int(v) for k, v in state.items()
              if k.endswith("num_batches_tracked")}
    assert counts == ({1} if train else {0})
    if not train:
        for k, v in state.items():
            assert torch.equal(v, before[k]), k


def test_resnet18_gradients_through_batchnorm_match_jax(res18):
    """Train mode, the gradient of sum(map * w) with respect to every
    parameter (convs and BatchNorm affines).  Upstream of the last stage
    both frameworks' f32 gradients lie up to 5e-3 of their largest from the
    float64 gradient (measured), with the port up to 2.5e-2 from din_tpu's
    in one tensor: the cancellation of the train-mode variance and ReLU and
    pool decisions that f32 rounding flips, as in
    tests/test_torch_train.py.  So each tensor's gradient is held to be no
    farther from the float64 gradient than 1.5 times din_tpu's distance
    from it (measured at most 1.26, median 0.71), and the last stage's
    (``features.7``), downstream of any flip, within 1e-4 of the tensor's
    largest of din_tpu's (measured 2.4e-5)."""
    w = np.random.RandomState(3).randn(4, 2, 3, 512).astype(np.float32)

    def loss(params):
        out, _ = res18["jmodel"].apply(
            {"params": params, "batch_stats": res18["stats"]}, res18["x"],
            True, mutable=["batch_stats"])
        return jnp.sum(out[0] * w)

    with jax.default_matmul_precision("highest"):
        jgrads = jax.jit(jax.grad(loss))(res18["params"])
    ref = export_backbone_state(jax.device_get(jgrads), {}, "res18")

    def port_grads(model, dtype):
        model.train()
        x = torch.from_numpy(res18["x"]).to(dtype)
        (model(x) * torch.from_numpy(w).to(dtype)).sum().backward()
        return {k: p.grad.double().numpy()
                for k, p in model.named_parameters()}

    grads = port_grads(_to_port(res18["params"], res18["stats"]),
                       torch.float32)
    exact = port_grads(f64_port(res18["params"], res18["stats"]),
                       torch.float64)
    assert sorted(grads) == sorted(ref) and len(grads) == 60
    for k, g in grads.items():
        scale = np.abs(exact[k]).max()
        assert np.abs(g - exact[k]).max() <= 1.5 * np.abs(
            ref[k] - exact[k]).max() + 1e-7 * scale, k
        if k.startswith("features.7."):
            assert np.abs(g - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_jax_torch_batchnorm(dtype):
    """TorchBatchNorm on a channels_last map against din_tpu's: the output
    in train and eval mode (f32: within 1e-6 of max|y|; bf16: within one
    bf16 ulp, the cast of the same f32 value), the running statistics
    after one train call within 1e-6, the output's dtype the input's."""
    rng = np.random.RandomState(5)
    C = 16
    x = (1.5 + 2 * rng.randn(6, 5, 7, C)).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.05 * rng.randn(C)).astype(np.float32)
    mean = (0.1 * rng.randn(C)).astype(np.float32)
    var = (1 + rng.uniform(-0.5, 0.5, C)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    bn = TorchBatchNorm(C)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    for train in (True, False):
        jbn = JaxBatchNorm(use_running_average=not train, dtype=jdt)
        ref, upd = jbn.apply(variables, xj, mutable=["batch_stats"])
        with torch.no_grad():
            got = bn.train(train)(xt)
        assert got.dtype == tdt
        got = got.permute(0, 2, 3, 1).float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        tol = 1e-6 * np.abs(ref).max() if dtype == "float32" else \
            2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)
        assert (np.abs(got - ref) <= tol).all(), (train,
                                                  np.abs(got - ref).max())
        if train:
            for k in ("mean", "var"):
                np.testing.assert_allclose(
                    getattr(bn, "running_" + k).numpy(),
                    upd["batch_stats"][k], atol=1e-6)
            # eval next: both on the updated statistics
            variables["batch_stats"] = jax.device_get(upd["batch_stats"])


def test_two_chunk_trunk_folds_running_stats_in_chunk_order(res18):
    """The trunk in train mode with frame_chunk=2 over 4 frames: each chunk
    normalises with its own statistics and the running ones take both
    chunks in order, as din_tpu's scan carries ``batch_stats``: RoI
    features within 1e-4 of their largest magnitude (batch statistics, as
    in the train-mode map test), running statistics within 1e-5,
    ``num_batches_tracked`` 2.  One 4-frame chunk gives other
    statistics (the chunking is live)."""
    rng = np.random.RandomState(6)
    images = rng.randint(0, 255, (1, 4, *_HW, 3)).astype(np.uint8)
    boxes = np.concatenate([rng.uniform(0, 1.5, (1, 4, 3, 2)),
                            rng.uniform(1.5, 3, (1, 4, 3, 2))], -1)
    boxes = boxes[..., [0, 1, 2, 3]].astype(np.float32)
    jtrunk = Trunk(backbone="res18", out_size=(2, 3), crop_size=(5, 5),
                   train_backbone=True, compute_dtype=jnp.float32,
                   frame_chunk=2, folded_stem=False)
    variables = {"params": {"frames_scan": {"backbone": res18["params"]}},
                 "batch_stats": {"frames_scan": {"backbone": res18["stats"]}}}
    with jax.default_matmul_precision("highest"):
        (roi, _, _), upd = jtrunk.apply(variables, images, boxes,
                                        bn_train=True,
                                        mutable=["batch_stats"])

    def port(chunk):
        model = _to_port(res18["params"], res18["stats"])
        with torch.no_grad():
            got = trunk_forward(model, torch.from_numpy(images),
                                torch.from_numpy(boxes), out_size=(2, 3),
                                crop_size=(5, 5),
                                compute_dtype=torch.float32, chunk=chunk,
                                train_backbone=True, bn_train=True)
        return got.numpy(), model.state_dict()

    got, state = port(2)
    roi = np.asarray(roi)
    assert got.shape == roi.shape == (1, 4, 3, 5, 5, 512)
    assert np.abs(got - roi).max() <= 1e-4 * np.abs(roi).max()
    for p, j in _stats_of(state, upd["batch_stats"]["frames_scan"]
                          ["backbone"]):
        np.testing.assert_allclose(p, np.asarray(j), rtol=0, atol=1e-5)
    assert int(state["features.1.num_batches_tracked"]) == 2
    _, one = port(4)
    assert not np.allclose(one["features.1.running_var"].numpy(),
                           state["features.1.running_var"].numpy(),
                           rtol=0, atol=1e-5)


def torchvision_res18_file(path, seed=7):
    """A torchvision-layout ResNet-18 ``state_dict`` (``conv1``, ``bn1``,
    ``layerK.*`` with BatchNorm statistics, ``fc.*``) with random tensors;
    returns it."""
    rng = np.random.RandomState(seed)
    top = {v: k for k, v in RESNET_SEQ.items()}
    state = {}
    for k, v in ResNet18Backbone(torch.Generator().manual_seed(0)) \
            .state_dict().items():
        head, idx, rest = k.split(".", 2)
        if k.endswith("num_batches_tracked"):
            t = torch.tensor(rng.randint(100), dtype=torch.int64)
        elif k.endswith("running_var"):
            t = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32))
        elif v.dim() == 1:
            t = torch.from_numpy((0.1 * rng.randn(*v.shape) + (
                k.endswith("weight"))).astype(np.float32))
        else:
            fan_in = int(np.prod(v.shape[1:]))
            t = torch.from_numpy((np.sqrt(2.0 / fan_in) * rng.randn(
                *v.shape)).astype(np.float32))
        state[f"{top[head + '.' + idx]}.{rest}"] = t
    state["fc.weight"] = torch.zeros(10, 512)
    state["fc.bias"] = torch.zeros(10)
    torch.save(state, path)
    return state


def test_torchvision_resnet18_file_loads_strictly_and_matches_jax(tmp_path):
    """A torchvision-layout ResNet-18 file through
    ``pretrained_backbone_path`` (stage 1 of the collective path): every
    ``backbone.features`` tensor, BatchNorm statistics included, equals the
    file's (``fc.*`` unused), and the eval-mode map equals din_tpu's
    ResNet-18 after ``convert_backbone_state`` of the same file within rtol
    1e-4 / atol 1e-5 max|y|.  The file loaded into a model of another
    backbone (Inception-v3) raises, and a backbone name din_tpu does not
    know raises when the model is built."""
    path = str(tmp_path / "resnet18.pth")
    state = torchvision_res18_file(path)
    cfg = PRESETS["collective_stage1"]().replace(
        backbone="res18", out_size=(2, 3), emb_features=512, image_size=_HW,
        num_frames=2, num_features_boxes=64, compute_dtype="float32",
        pretrained_backbone_path=path)
    model, _, _ = setup_training(cfg, "cpu")
    loaded = model.backbone.state_dict()
    assert len(loaded) == len(state) - 2
    for k, v in state.items():
        head, _, rest = k.partition(".")
        if head != "fc":
            assert torch.equal(loaded[f"{RESNET_SEQ[head]}.{rest}"], v), k

    x = np.random.RandomState(8).uniform(-1, 1, (2, *_HW, 3)).astype(
        np.float32)
    conv = convert_backbone_state(torch_file_to_numpy(path), "res18")
    params = {k: v for k, v in conv["params"].items() if k != "fc"}
    with jax.default_matmul_precision("highest"):
        ref = JaxRes18(dtype=jnp.float32, folded_stem=False).apply(
            {"params": params, "batch_stats": conv["batch_stats"]}, x)[0]
    with torch.no_grad():
        got = model.backbone.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pretrained_backbone(build_model(cfg.replace(backbone="inv3"),
                                             device="cpu"), path)
    with pytest.raises(ValueError, match="choose from"):
        build_model(cfg.replace(backbone="res34"), device="cpu")
