"""The backbones the port lacked besides Inception-v3 (VGG-19, ResNet-50,
AlexNet), and the align-corners resize and two-scale RoIAlign that
Inception-v3 needs, against the JAX package, on the CPU, in float32 (JAX
under ``default_matmul_precision("highest")``).

Each backbone of din_tpu gets seeded weights drawn with numpy over the
shapes of ``jax.eval_shape`` of its ``init`` (``seeded`` of
tests/test_torch_inception.py), the canonical stems
(``folded_stem=False``), and the port gets them through
``export_backbone_state``; frames are 2 of 96x128.  Maps within rtol 1e-4
/ atol 1e-5 of the largest |value| where BatchNorm uses its running
statistics; ResNet-50 in train mode, where E[x^2] - E[x]^2 cancels in f32,
within 1e-3 of the largest and no farther from a float64 run of the port
than din_tpu's map (plus 1e-6 of the largest), and so are its running
statistics, tensor by tensor (``check_against_f64``; measured: the port's
at most 5.6e-9 of the largest farther, din_tpu's and the port's up to
1.05e-4 of the largest apart in ``layer4``, where the maps they average
carry the cancellation of 50 BatchNorms before them).  VGG-19 and AlexNet have no
BatchNorm: their train-mode map is the eval-mode one.

``interp_matrix_align_corners`` is built as din_tpu builds it, so it is
held bit for bit (float32, and its bfloat16 cast).  The resize and
``roi_align_multiscale`` multiply in another order than XLA's dots, so
they are held within 1e-6 (resize, also against ``F.interpolate(...,
align_corners=True)``) and 1e-5 (RoIAlign, forward and the gradient with
respect to each map, against ``jax.grad``) of the largest |value|; so is
the fused path against resize + concatenation + ``roi_align``, in the port
and in the trunk.  The boxes cross the map's edges (partly outside, on the
border, of zero area, wholly outside), where both frameworks zero a sample
whose centre is out of range on either axis.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from din_tpu.nn.backbones import BACKBONES as JAX_BACKBONES
from din_tpu.nn.torch_port import convert_backbone_state, torch_file_to_numpy
from din_tpu.ops.image import interp_matrix_align_corners as jax_interp
from din_tpu.ops.image import resize_bilinear_align_corners as jax_resize
from din_tpu.ops.roi_align import roi_align_multiscale as jax_multiscale
from din_tpu_torch.models.trunk import trunk_forward
from din_tpu_torch.nn.backbones import BACKBONES, RESNET_SEQ, avg_pool_3x3
from din_tpu_torch.nn.ref_export import export_backbone_state
from din_tpu_torch.nn.ref_import import load_pretrained_backbone
from din_tpu_torch.ops.image import (interp_matrix_align_corners,
                                     resize_bilinear_align_corners)
from din_tpu_torch.ops.roi_align import roi_align, roi_align_multiscale
from test_torch_inception import _close, _torch, check_against_f64, seeded
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_HW = (96, 128)
# each backbone's map at 96x128
_MAP = {"vgg19": (3, 4, 512), "res50": (3, 4, 2048), "alex": (2, 3, 256)}
_STATS = ("running_mean", "running_var")


@pytest.fixture(scope="module", params=sorted(_MAP))
def backbone(request):
    """A backbone's name, seeded JAX variables, 2 frames, din_tpu's map and
    updated ``batch_stats`` in eval and in train mode (one jitted call),
    the port's backbone with those variables (``model``), and its maps and
    state after an eval-mode and a train-mode call (``port``), and in
    float64 after a train-mode call where it has BatchNorm (``exact``).
    din_tpu's program compiles and runs in a second thread while the port
    runs (XLA releases the interpreter)."""
    name = request.param
    kw = {} if name == "alex" else {"folded_stem": False}
    jmodel = JAX_BACKBONES[name](dtype=jnp.float32, **kw)
    x = np.random.RandomState(1).uniform(-1, 1, (2, *_HW, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x[:1])
    rng = np.random.RandomState(2)
    params = seeded(shapes["params"], rng)
    stats = seeded(shapes.get("batch_stats", {}), rng)
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
        model = BACKBONES[name](torch.Generator().manual_seed(0))
        model.load_state_dict(_torch(export_backbone_state(params, stats,
                                                           name)),
                              strict=True)
        runs = {mode: copy.deepcopy(model).train(mode == "train")
                for mode in ("eval", "train")}
        if stats:
            runs["exact"] = copy.deepcopy(model).double().train()
        port = {}
        with torch.no_grad():
            for mode, m in runs.items():
                y = m(torch.from_numpy(x).to(next(m.parameters()).dtype))
                port[mode] = (y.numpy(), m.state_dict())
        out = out.result()
    return dict(name=name, params=params, stats=stats, x=x, out=out,
                model=model, port=port)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_backbone_matches_jax(backbone, mode):
    """The map equals din_tpu's within the module docstring's bounds;
    ResNet-50's running statistics after a train-mode call are held to
    din_tpu's updated ``batch_stats`` as the map is, and each
    ``num_batches_tracked`` is 1; in eval mode they stay (within rtol 1e-4
    / atol 1e-5 of the largest), counts 0."""
    train = mode == "train"
    (ref,), new = backbone["out"][mode]
    ref = np.asarray(ref)
    got, state = backbone["port"][mode]
    assert got.shape == ref.shape == (2, *_MAP[backbone["name"]])
    live = train and bool(backbone["stats"])
    if live:
        exact_map, exact_state = backbone["port"]["exact"]
        check_against_f64(got, ref, exact_map, "map")
    else:
        _close(got, ref, "map")
    want = export_backbone_state({}, new.get("batch_stats", {}),
                                 backbone["name"])
    keys = [k for k in want if k.endswith(_STATS)]
    assert len(keys) == (2 * 53 if backbone["name"] == "res50" else 0)
    for k in keys:
        if live:
            check_against_f64(state[k].numpy(), np.asarray(want[k]),
                              exact_state[k].numpy(), k)
        else:
            _close(state[k].numpy(), np.asarray(want[k]), k)
    counts = {int(v) for k, v in state.items()
              if k.endswith("num_batches_tracked")}
    assert counts <= ({1} if train else {0})


def test_torchvision_file_loads_strictly_and_matches_jax(backbone, tmp_path):
    """The fixture's weights as a torchvision-layout file (ResNet-50's
    ``conv1``/``bn1``/``layerK``, the VGG's and AlexNet's ``features.N``,
    with a classifier stand-in) through ``load_pretrained_backbone``:
    every tensor of the backbone equals the file's, din_tpu's
    ``convert_backbone_state`` reads the file into the fixture's variables,
    and the loaded backbone's eval-mode map equals din_tpu's within rtol
    1e-4 / atol 1e-5 of the largest.  The file loaded into another
    backbone, and any file into a module that is none of ``BACKBONES``,
    raise."""
    name = backbone["name"]
    top = {v: k for k, v in RESNET_SEQ.items()}
    state = {}
    for k, v in _torch(export_backbone_state(
            backbone["params"], backbone["stats"], name)).items():
        if name == "res50":
            head, idx, rest = k.split(".", 2)
            k = f"{top[head + '.' + idx]}.{rest}"
        state[k] = v
    extra = ["fc.weight", "fc.bias"] if name == "res50" else \
        ["classifier.6.weight", "classifier.6.bias"]
    state.update({k: torch.zeros(4, 3) for k in extra})
    path = str(tmp_path / f"{name}.pth")
    torch.save(state, path)

    holder = nn.Module()
    holder.backbone = copy.deepcopy(backbone["model"])
    with torch.no_grad():
        for v in holder.backbone.state_dict().values():
            v.zero_()
    load_pretrained_backbone(holder, path)
    loaded = holder.backbone.state_dict()
    assert len(loaded) == len(state) - 2
    for k, v in export_backbone_state(backbone["params"], backbone["stats"],
                                      name).items():
        assert np.array_equal(loaded[k].numpy(), v), k

    conv = convert_backbone_state(torch_file_to_numpy(path), name)
    for tree, want in ((conv["params"], backbone["params"]),
                       (conv.get("batch_stats", {}), backbone["stats"])):
        for keys, v in jax.tree_util.tree_leaves_with_path(want):
            got = tree
            for key in keys:
                got = got[key.key]
            np.testing.assert_array_equal(got, v)
    with torch.no_grad():
        got = holder.backbone.eval()(torch.from_numpy(backbone["x"]))
    _close(got.numpy(), np.asarray(backbone["out"]["eval"][0][0]), "map")
    holder.backbone = BACKBONES["res18" if name == "alex" else "alex"](
        torch.Generator().manual_seed(9))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pretrained_backbone(holder, path)
    holder.backbone = nn.Conv2d(3, 4, 1)
    with pytest.raises(ValueError, match="is none of"):
        load_pretrained_backbone(holder, path)


@pytest.mark.parametrize("n_in,n_out", [(1, 5), (7, 1), (1, 1), (6, 6),
                                        (4, 9), (9, 13), (13, 57), (87, 13)])
def test_interp_matrix_matches_jax(n_in, n_out):
    """Bit-equal to din_tpu's matrix in float32 and in bfloat16 (the f32
    matrix cast); ``n_in == 1`` gives all ones, ``n_out == 1`` samples
    position 0; every row sums to 1."""
    got = interp_matrix_align_corners(n_in, n_out)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_interp(n_in, n_out)))
    bf = interp_matrix_align_corners(n_in, n_out, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.float().numpy(),
        np.asarray(jax_interp(n_in, n_out, jnp.bfloat16), np.float32))
    np.testing.assert_allclose(got.sum(1).numpy(), 1, atol=1e-6)


@pytest.mark.parametrize("hw,size", [((4, 6), (9, 13)), ((1, 6), (5, 13)),
                                     ((9, 13), (1, 5)), ((5, 5), (5, 5))])
def test_resize_matches_jax_and_interpolate(hw, size):
    """[2,h,w,3] resized to ``size``: within 1e-6 of the largest |value|
    of din_tpu's resize and of ``F.interpolate(mode='bilinear',
    align_corners=True)``; the same size returns the map itself."""
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    got = resize_bilinear_align_corners(torch.from_numpy(x), size)
    assert got.shape == (2, *size, 3)
    scale = np.abs(x).max()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax_resize, static_argnums=1)(
            jnp.asarray(x), size))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * scale
    lib = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size,
                        mode="bilinear", align_corners=True)
    assert np.abs(got.numpy() - lib.permute(0, 2, 3, 1).numpy()).max() \
        <= 1e-6 * scale
    if hw == size:
        assert np.array_equal(got.numpy(), x)


def crossing_boxes(B, N, OH, OW, seed):
    """[B,N,4] random boxes over an OH x OW map reaching past its edges,
    and in every frame one on the far border, one partly off the map, one
    of zero area and one wholly outside."""
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-3, OW + 1, (B, N))
    y1 = rng.uniform(-3, OH + 1, (B, N))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.5, 6, (B, N)),
                      y1 + rng.uniform(0.5, 6, (B, N))], -1)
    boxes[:, 0] = [OW - 5.0, OH - 5.0, OW, OH]
    boxes[:, 1] = [-1.0, 0.0, 5.0, 4.0]
    boxes[:, 2] = [3.25, 2.5, 3.25, 2.5]
    boxes[:, 3] = [OW + 1.0, OH + 1.0, OW + 3.0, OH + 3.0]
    return boxes.astype(np.float32)


_MULTISCALE = {
    "first_scale_matches": ([(9, 13, 5), (4, 6, 7)], (9, 13)),
    "neither_matches": ([(9, 13, 5), (4, 6, 7)], (7, 11)),
    "one_row_map": ([(1, 6, 4), (9, 13, 5)], (9, 13)),
}


@pytest.mark.parametrize("case", sorted(_MULTISCALE))
def test_roi_align_multiscale_matches_jax(case):
    """Forward, and the gradient of sum(out * w) with respect to each map,
    within 1e-5 of the largest |value| of din_tpu's ``roi_align_multiscale``
    (``jax.grad``); the forward also of ``roi_align`` over the resized and
    concatenated maps (the unfused route, in the maps' order); a sample
    out of range gives 0 on both routes."""
    shapes, out_size = _MULTISCALE[case]
    rng = np.random.RandomState(1)
    maps = [rng.randn(2, *s).astype(np.float32) for s in shapes]
    boxes = crossing_boxes(2, 10, *out_size, seed=2)
    w = rng.randn(2, 10, 5, 5, sum(s[2] for s in shapes)).astype(np.float32)

    tmaps = [torch.from_numpy(m).requires_grad_() for m in maps]
    got = roi_align_multiscale(tmaps, torch.from_numpy(boxes), (5, 5),
                               out_size)
    (got * torch.from_numpy(w)).sum().backward()

    def jax_out(ms):
        return jax_multiscale(ms, jnp.asarray(boxes), (5, 5), out_size)

    def out_and_grads(ms):
        return jax_out(ms), jax.grad(lambda m: jnp.sum(jax_out(m) * w))(ms)

    with jax.default_matmul_precision("highest"):
        want, grads = jax.jit(out_and_grads)([jnp.asarray(m) for m in maps])
    want = np.asarray(want)
    assert got.shape == want.shape == w.shape
    assert np.abs(got.detach().numpy() - want).max() \
        <= 1e-5 * np.abs(want).max()
    for t, g in zip(tmaps, grads):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()
    with torch.no_grad():
        unfused = roi_align(torch.cat([resize_bilinear_align_corners(
            t, out_size) for t in tmaps], dim=-1), torch.from_numpy(boxes),
            (5, 5))
    assert np.abs(got.detach().numpy() - unfused.numpy()).max() \
        <= 1e-5 * np.abs(want).max()
    assert not got[:, 3].any()                  # wholly outside: zeros


@pytest.mark.parametrize("memory", [torch.contiguous_format,
                                    torch.channels_last])
def test_avg_pool_3x3_is_its_own_adjoint(memory):
    """Inception-v3's branch pool: ``avg_pool_3x3`` (forward
    ``F.avg_pool2d``, backward the same pool of the gradient) equals
    autograd of ``F.avg_pool2d`` and of the explicit nine-tap sum over the
    zero-padded map divided by 9, forward and backward, in float64 (within
    1e-12 of the largest |value|); din_tpu's ``avg_pool_torch`` is that
    sum (``count_include_pad=True``)."""
    gen = torch.Generator().manual_seed(7)
    x0 = torch.randn(2, 5, 9, 13, generator=gen, dtype=torch.float64) \
        .contiguous(memory_format=memory)
    g = torch.randn(2, 5, 9, 13, generator=gen, dtype=torch.float64)

    def taps(x):
        xp = F.pad(x, (1, 1, 1, 1))
        return sum(xp[:, :, i:i + 9, j:j + 13] for i in range(3)
                   for j in range(3)) / 9

    outs = []
    for pool in (avg_pool_3x3, lambda x: F.avg_pool2d(x, 3, 1, 1), taps):
        x = x0.clone().requires_grad_()
        y = pool(x)
        y.backward(g)
        outs.append((y.detach(), x.grad))
    for y, dx in outs[1:]:
        for a, b in ((outs[0][0], y), (outs[0][1], dx)):
            assert (a - b).abs().max() <= 1e-12 * b.abs().max()


class TwoScale(nn.Module):
    """A backbone of two maps, as Inception-v3's: a 1x1 conv, then 8x8
    and 16x16 average pools (64x96 frames: 8x12 and 4x6), NHWC."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 1)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in self.conv.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))

    def forward(self, x):
        y = self.conv(x.permute(0, 3, 1, 2))
        return [F.avg_pool2d(y, k).permute(0, 2, 3, 1) for k in (8, 16)]


@pytest.mark.parametrize("out_size", [(8, 12), (6, 9)])
def test_trunk_fuses_the_two_scales(out_size):
    """``trunk_forward`` on a two-map backbone in two chunks: the RoI
    features (8 channels: the maps' in order) and the gradient into the
    backbone of the fused route (``roi_align_multiscale``, taken when no
    map is asked for) equal the unfused route's (resize, concatenate,
    ``roi_align``, taken with ``return_map``) within 1e-5 of their largest
    |value|, and the unfused route returns the [B*T,OH,OW,8] map."""
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randint(0, 255, (2, 2, 64, 96, 3))
                              .astype(np.uint8))
    boxes = torch.from_numpy(crossing_boxes(4, 6, *out_size, seed=4)
                             .reshape(2, 2, 6, 4))
    kw = dict(out_size=out_size, crop_size=(5, 5),
              compute_dtype=torch.float32, chunk=2, train_backbone=True)
    outs = {}
    for return_map in (False, True):
        backbone = TwoScale()
        got = trunk_forward(backbone, images, boxes, return_map=return_map,
                            **kw)
        roi = got[0] if return_map else got
        roi.square().sum().backward()
        outs[return_map] = (roi.detach(), backbone.conv.weight.grad)
    assert outs[False][0].shape == (2, 2, 6, 5, 5, 8)
    for a, b in zip(outs[False], outs[True]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert got[1].shape == (4, *out_size, 8)
