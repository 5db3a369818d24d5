"""The port's training slice against the JAX package, on the CPU.

The same seeded weights and synthetic batches go through din_tpu's
``make_train_step`` and din_tpu_torch's ``train_step`` in float32 (JAX under
``default_matmul_precision("highest")``): full VGG-16 channels at 64x96
frames (a 2x3 map), T=3, N=4, B=2, NFB 64, lite 16, one 3x3 DIN field,
dropout 0, weight decay 1e-4, lr 1e-4.  The JAX side runs the canonical
stem (``folded_stem=False``): the folded stem is a layout for the TPU's
128-lane vregs, equal in value, and the port runs the canonical one.  Two
trajectories: the backbone trained (the flagship) and frozen.

Why the trained-backbone tolerances are what they are (measured here): the
two frameworks' f32 convolutions differ by up to 2e-6 absolute, and a few
conv pre-activations lie closer to 0 than that (4 of ~2M at this seed, in
convs 2, 7 and 12), so their ReLU derivative flips between the frameworks;
likewise a 2x2 window whose two largest values lie that close routes its
gradient to another element (1 window of pool1 here).  Each flip moves
that unit's gradient and everything upstream of it: step
1's gradients of convs up to the deepest flip differ by up to 5.6e-3 of
their max, while every tensor downstream of it agrees to 2e-6.  Adam then
turns any gradient element whose sign differs into a 2*lr step difference,
so from the first flip on, the elementwise 2e-5 parameter target cannot
hold: after 5 steps up to 4.1 % of a tensor's elements differ by more than
2e-5 (at most 5.4e-4 = 5.4 lr).  Even with no flip (frozen backbone), one
fc_emb_1 element of 819200, whose step-1 gradient was 4e-7 of the
tensor's max, ends 2.5e-5 apart.  The tests find the flips themselves and
hold each tensor to the target that its position allows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from din_tpu.data.loader import BatchLoader as JaxBatchLoader
from din_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.nn.backbones import VGG16Backbone as JaxVGG
from din_tpu.ops.image import prep_images as jax_prep
from din_tpu.train import losses as jax_losses
from din_tpu.train.engine import TrainState, init_model, make_train_step
from din_tpu.train.optim import lr_for_epoch as jax_lr_for_epoch
from din_tpu.train.optim import make_optimizer as jax_make_optimizer
from din_tpu_torch.data.loader import BatchLoader, to_device
from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import (_fill_masked, _find_state,
                                         jax_params_to_state_dict,
                                         jax_train_state_to_torch)
from din_tpu_torch.nn.layers import SeededDropout
from din_tpu_torch.train import losses
from din_tpu_torch.train.engine import train_step
from din_tpu_torch.train.optim import lr_for_epoch, make_optimizer
from test_torch_threads import one_thread  # noqa: F401 (autouse)

_GEOM = dict(image_size=(64, 96), out_size=(2, 3), num_frames=3,
             num_boxes=4, num_features_boxes=64, lite_dim=16,
             train_dropout_prob=0.0, weight_decay=1e-4,
             compute_dtype="float32", batch_size=2)
_STEPS = 5
_CPU = torch.device("cpu")


def _perturb(tree, rng, path=()):
    """Seeded perturbation of initialised parameters: random DIN offset and
    affinity convs (zero at init), biases and LayerNorm affines."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, path + (k,))
            continue
        v = np.asarray(v, dtype=np.float32)
        if any(p.startswith(("p_conv", "scale_conv")) for p in path):
            v = (0.05 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "bias":
            v = v + (0.05 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "scale":
            v = v * (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        out[k] = v
    return out


def _torch_state(params, cfg):
    return {k: torch.from_numpy(np.array(v))
            for k, v in jax_params_to_state_dict(params, cfg).items()}


def _winners(x):
    """First row-major argmax of each 2x2 window of an NHWC map."""
    n, h, w, c = x.shape
    win = x[:, :h // 2 * 2, :w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2, c)
    return win.transpose(0, 1, 3, 5, 2, 4).reshape(
        n, h // 2, w // 2, c, 4).argmax(-1)


def _backbone_flips(params, cfg, frames):
    """{VGG layer index: (flips, largest |pre-activation| among the ReLU
    flips, else 0)}, JAX (canonical stem) against the port on ``frames``:
    conv pre-activations of opposite sign, and pool windows whose first
    argmax differs."""
    bb = params["trunk"]["frames_scan"]["backbone"]
    x = np.asarray(jax_prep(jnp.asarray(frames)))
    _, inter = JaxVGG(dtype=jnp.float32, folded_stem=False).apply(
        {"params": bb}, x, capture_intermediates=True,
        mutable=["intermediates"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_torch_state(params, cfg))
    h = torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)
    flips, relu_t = {}, None
    with torch.no_grad():
        for i, layer in enumerate(model.backbone.features):
            if isinstance(layer, torch.nn.ReLU):
                continue
            if isinstance(layer, torch.nn.Conv2d):
                z = F.conv2d(h, layer.weight, layer.bias, padding=1)
                zj = np.asarray(inter["intermediates"][f"features_{i}"]
                                ["__call__"][0])
                zt = z.permute(0, 2, 3, 1).numpy()
                bad = (zt > 0) != (zj > 0)
                if bad.any():
                    flips[i] = (int(bad.sum()),
                                float(np.maximum(np.abs(zt[bad]),
                                                 np.abs(zj[bad])).max()))
                relu_t, relu_j = np.maximum(zt, 0), np.maximum(zj, 0)
                h = torch.relu(z)
            else:
                n = int((_winners(relu_t) != _winners(relu_j)).sum())
                if n:
                    flips[i] = (n, 0.0)
                h = layer(h)
    return flips


@pytest.fixture(scope="module", params=["backbone_trained",
                                        "backbone_frozen"])
def trajectory(request):
    """One JAX trajectory of 5 steps from perturbed weights, with what the
    tests compare against."""
    train_backbone = request.param == "backbone_trained"
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]().replace(
        folded_stem=False, train_backbone=train_backbone, **_GEOM)
    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(
        train_backbone=train_backbone, **_GEOM)
    loader = BatchLoader(SyntheticDataset(cfg, seed=1), cfg.batch_size,
                         seed=cfg.train_random_seed)
    loader.set_epoch(1)
    batches = [b for _, b in zip(range(_STEPS), loader)]
    jmodel = jax_build_model(jcfg)
    variables = init_model(jcfg, jmodel,
                           {k: v[:1] for k, v in batches[0].items()})
    params = _perturb(jax.device_get(variables["params"]),
                      np.random.RandomState(0))
    tx = jax_make_optimizer(jcfg, params)
    state = TrainState(params=params, batch_stats={},
                       opt_state=jax.jit(tx.init)(params),
                       rng=jax.random.PRNGKey(0))
    step = make_train_step(jmodel, jcfg, tx, True, False, donate=False)
    losses_, states = [], []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses_.append(float(m["loss"]))
            states.append(jax.device_get(state))
    flips = _backbone_flips(params, cfg, batches[0]["images"].reshape(
        -1, *cfg.image_size, 3)) if train_backbone else {}
    return dict(cfg=cfg, params=params, batches=batches, losses=losses_,
                states=states, flips=flips, train_backbone=train_backbone)


def _run_port(model, optimizer, cfg, batches, grads_at_first=False):
    out_losses, grads = [], None
    for i, b in enumerate(batches):
        m = train_step(model, optimizer, to_device(b, _CPU), cfg)
        out_losses.append(float(m["loss"]))
        if grads_at_first and i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
    return out_losses, grads


def _conv_index(name):
    """VGG layer index of a backbone parameter name, else None."""
    parts = name.split(".")
    return int(parts[2]) if parts[0] == "backbone" else None


def _check_params(model, jparams, cfg, flips, steps, what):
    """Parameters after ``steps`` steps against JAX.  Adam moves an element
    by about lr whatever its gradient's size, so an element whose gradient
    lies inside the two frameworks' f32 agreement band around 0 (about 1e-6
    of the tensor's max) takes a step of another size or sign: elementwise
    atol 2e-5 then holds for all but such elements (at most 1e-4 of a
    tensor; measured 1 of 819200 in fc_emb_1, frozen), and after a ReLU or
    pool flip for all but 10 % (measured at most 4.1 %, conv 0); no element
    moves more than 2*lr per step apart."""
    ref = jax_params_to_state_dict(jparams, cfg)
    state = model.state_dict()
    for name, want in ref.items():
        diff = np.abs(state[name].numpy() - want)
        assert diff.max() <= steps * 2 * cfg.train_learning_rate, (
            what, name, diff.max())
        share = float((diff > 2e-5).mean())
        assert share <= (0.1 if flips else 1e-4), (what, name, share)


def test_trajectory_matches_jax_make_train_step(trajectory):
    """Five steps from the same weights on the same batches.  Losses within
    rtol 1e-4 (measured <= 8.2e-5 trained, <= 1e-6 frozen).  Step 1's
    gradient of every tensor within 1e-4 * max|g_jax| (measured <= 2e-6)
    where no ReLU or pool flip reaches it, else 1e-2 (measured 5.6e-3);
    each ReLU flip is a pre-activation within 1e-5 of 0 (measured at most
    1.8e-7).  Parameters after 5 steps: the bounds of ``_check_params``.
    JAX's step-1 gradient is read from its Adam state: mu after one step
    is 0.1 * (g + wd * w)."""
    t = trajectory
    cfg = t["cfg"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_torch_state(t["params"], cfg))
    optimizer = make_optimizer(cfg, model)
    got, grads = _run_port(model, optimizer, cfg, t["batches"],
                           grads_at_first=True)
    np.testing.assert_allclose(got, t["losses"], rtol=1e-4)

    flips = t["flips"]
    for i, (n, z) in flips.items():
        assert z <= 1e-5, f"layer {i}: {n} ReLU flips at |z| up to {z}"
    deepest = max(flips, default=-1)
    adam = _find_state(t["states"][0].opt_state, ("mu", "nu", "count"))
    mu = jax_params_to_state_dict(_fill_masked(adam.mu, t["params"]), cfg)
    w0 = jax_params_to_state_dict(t["params"], cfg)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert (len(trainable) < len(w0)) != t["train_backbone"]
    assert set(grads) == trainable
    for name in trainable:
        g_jax = np.asarray(mu[name]) / 0.1 - cfg.weight_decay * w0[name]
        err = np.abs(grads[name].numpy() - g_jax).max()
        idx = _conv_index(name)
        bound = 1e-2 if idx is not None and idx <= deepest else 1e-4
        assert err <= bound * np.abs(g_jax).max(), (name, err,
                                                     np.abs(g_jax).max())
    _check_params(model, t["states"][-1].params, cfg, flips, _STEPS,
                  "5 steps")


def test_jax_state_carried_mid_run(trajectory):
    """After 2 JAX steps, params and Adam state (moments, count, lr) carried
    into the port with ``jax_train_state_to_torch``; 3 more steps on each
    side agree with the tolerances of the trajectory test."""
    t = trajectory
    cfg = t["cfg"]
    model = build_model(cfg, device="cpu")
    optimizer = make_optimizer(cfg, model)
    mid = t["states"][1]
    jax_train_state_to_torch(mid.params, mid.opt_state, cfg, model,
                             optimizer)
    p = next(p for p in model.parameters() if p.requires_grad)
    assert float(optimizer.state[p]["step"]) == 2.0
    got, _ = _run_port(model, optimizer, cfg, t["batches"][2:])
    np.testing.assert_allclose(got, t["losses"][2:], rtol=1e-4)
    _check_params(model, t["states"][-1].params, cfg, t["flips"],
                  _STEPS - 2, "carry")


def _np_metrics(m):
    return {k: np.asarray(v, dtype=np.float64) for k, v in m.items()}


@pytest.mark.parametrize("case", ["stage2_frame0", "masked_clips",
                                  "actions_weighted_pad", "per_frame",
                                  "halting"])
def test_compute_losses_match_jax(case):
    """compute_losses (and through it cross_entropy with class weights and
    -1 masks, accuracy counts and the confusion matrix) equal the JAX
    functions: counts exactly, losses within 1e-6 (float32 log-softmax)."""
    rng = np.random.RandomState(10)
    cfg = PRESETS["volleyball_stage2_dynamic"]()
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]()
    B, T, N, G, A = 4, 3, 5, cfg.num_activities, cfg.num_actions
    batch = {"activities": rng.randint(0, G, (B, T)).astype(np.int32),
             "actions": rng.randint(0, A, (B, T, N)).astype(np.int32)}
    out = {"activities": rng.randn(B, G).astype(np.float32)}
    frame0 = True
    if case == "masked_clips":
        batch["sample_mask"] = np.array([1, 1, 0, 1], np.float32)
    if case == "actions_weighted_pad":
        batch["actions"][:, :, -2:] = -1
        out["actions"] = rng.randn(B * N, A).astype(np.float32)
        batch["sample_mask"] = np.array([1, 0, 1, 1], np.float32)
    if case == "halting":
        out["halting"] = np.array(2.5, np.float32)
    if case == "per_frame":
        frame0 = False
        out["activities"] = rng.randn(B * T, G).astype(np.float32)
        out["actions"] = rng.randn(B * T * N, A).astype(np.float32)
    ref = _np_metrics(jax_losses.compute_losses(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, frame0))
    got = _np_metrics({k: v.numpy() for k, v in losses.compute_losses(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        frame0).items()})
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_cross_entropy_and_lr_plan_match_jax():
    """cross_entropy with weights and a mask equals JAX's and torch's own
    F.cross_entropy (ignore_index=-1) within 1e-6; lr_for_epoch equals
    JAX's at every epoch of the flagship plan."""
    rng = np.random.RandomState(11)
    logits = rng.randn(12, 9).astype(np.float32)
    labels = rng.randint(0, 9, 12).astype(np.int64)
    labels[[2, 7]] = -1
    w = np.asarray(PRESETS["volleyball_stage2_dynamic"]().action_weight_list,
                   np.float32)
    valid = labels >= 0
    ref = float(jax_losses.cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), jnp.asarray(w),
                                         jnp.asarray(valid)))
    got = float(losses.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(w),
                                     torch.from_numpy(valid)))
    torch_ce = float(F.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     weight=torch.from_numpy(w),
                                     ignore_index=-1))
    assert abs(got - ref) <= 1e-6 and abs(got - torch_ce) <= 1e-6
    cfg = PRESETS["volleyball_stage2_dynamic"]()
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]()
    for epoch in range(1, cfg.max_epoch + 1):
        assert lr_for_epoch(cfg, epoch) == jax_lr_for_epoch(jcfg, epoch)
    assert lr_for_epoch(cfg, 10) == 1e-4 and lr_for_epoch(cfg, 11) == 1e-5


@pytest.mark.parametrize("seed,epoch", [(0, 1), (0, 2), (7, 5)])
def test_loader_order_and_items_match_jax(seed, epoch):
    """The shuffled batch order of a (seed, epoch) equals JAX's BatchLoader,
    and the synthetic clips equal JAX's bit for bit."""
    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(**_GEOM)
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]().replace(**_GEOM)
    ours = BatchLoader(SyntheticDataset(cfg, size=9, seed=1), 2, seed=seed)
    theirs = JaxBatchLoader(JaxSynthetic(jcfg, size=9, seed=1), 2,
                            seed=seed, num_workers=1)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    got, ref = list(ours), list(theirs)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    val = BatchLoader(SyntheticDataset(cfg, size=5, seed=2), 2,
                      shuffle=False, drop_last=False, pad_last=True)
    jval = JaxBatchLoader(JaxSynthetic(jcfg, size=5, seed=2), 2,
                          shuffle=False, drop_last=False, pad_last=True,
                          num_workers=1)
    for a, b in zip(val, jval):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dropout_keeps_its_share_and_is_seeded():
    """p=0.3: the kept share is 0.7 within 0.02 over 2e5 elements, kept
    values are scaled by 1/0.7, the same seed gives the same mask, another
    seed another; eval mode and p=0 are the identity."""
    x = torch.rand(200_000) + 0.5
    drop = SeededDropout(0.3, seed=11).train()
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) <= 0.02
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=0, atol=0)
    again = SeededDropout(0.3, seed=11).train()(x)
    assert torch.equal(again != 0, kept)
    other = SeededDropout(0.3, seed=12).train()(x)
    assert not torch.equal(other != 0, kept)
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(SeededDropout(0.0, seed=11).train()(x), x)


def test_flagship_backbone_keeps_f32_master_weights():
    """The flagship preset in bfloat16 compute keeps its parameters in
    float32: JAX-layout f32 weights loaded through jax_params_to_state_dict
    come back from state_dict() bit for bit (before the repair the backbone
    was cast to bf16 and rounded them)."""
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]().replace(
        image_size=(64, 96), out_size=(2, 3), num_frames=1, num_boxes=2)
    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(
        image_size=(64, 96), out_size=(2, 3), num_frames=1, num_boxes=2)
    assert cfg.compute_dtype == "bfloat16"
    sample = {"images": np.zeros((1, 1, 64, 96, 3), np.uint8),
              "boxes": np.zeros((1, 1, 2, 4), np.float32)}
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: init_model(jcfg, jmodel, sample))
    rng = np.random.RandomState(12)
    params = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32),
        shapes["params"])
    state = jax_params_to_state_dict(params, cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()})
    back = model.state_dict()
    names = [k for k in state if k.startswith("backbone.")]
    assert len(names) == 26
    for k in names:
        assert back[k].dtype == torch.float32, k
        np.testing.assert_array_equal(back[k].numpy(), state[k], err_msg=k)


def test_run_cli_trains_one_step_on_cpu(tmp_path, monkeypatch):
    """``run.py --device cpu``: one step of one epoch, an eval pass, a
    log.txt and a .pth that reloads with --stage2-model-path into equal
    params and Adam state at the next epoch."""
    from din_tpu_torch.experiments import presets, run
    from din_tpu_torch.train.engine import setup_training

    small = dict(_GEOM, train_dropout_prob=0.3, test_batch_size=4,
                 load_backbone_stage2=False)
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: PRESETS[
        "volleyball_stage2_dynamic"]().replace(**small))
    args = ["--preset", "tiny", "--data-path", "synthetic",
            "--max-epoch", "1", "--max-steps-per-epoch", "1",
            "--device", "cpu", "--result-root", str(tmp_path),
            "--exp-name", "e"]
    best = run.main(args)
    exp = tmp_path / "e"
    log = (exp / "log.txt").read_text()
    assert "Train at epoch #1" in log and "====> Test at epoch #1" in log
    ckpts = sorted(p.name for p in exp.glob("*.pth"))
    assert ckpts == [os.path.basename(best["checkpoint"])]
    assert ckpts[0].startswith("stage2_epoch1_")
    saved = torch.load(best["checkpoint"], weights_only=True)
    assert saved["epoch"] == 1
    cfg, _ = run.config_from_args(args + ["--stage2-model-path",
                                          best["checkpoint"]])
    model, optimizer, start = setup_training(cfg, "cpu")
    assert start == 2
    for k, v in saved["state_dict"].items():
        assert torch.equal(model.state_dict()[k], v), k
    opt = optimizer.state_dict()
    assert opt["param_groups"] == saved["optimizer"]["param_groups"]
    for i, s in saved["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(opt["state"][i][k], v), (i, k)


@pytest.mark.parametrize("entry", ["run", "train_net", "profile_training"])
def test_training_entry_points_need_cuda_unless_asked_for_cpu(entry,
                                                              monkeypatch,
                                                              tmp_path):
    """With no card, the trainer's entry points raise before they build
    anything, unless the caller passes device="cpu"."""
    from din_tpu_torch.experiments import profile_training, run
    from din_tpu_torch.train.engine import train_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(
        data_path="synthetic", result_root=str(tmp_path), **_GEOM)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "run":
            run.main(["--preset", "volleyball_stage2_dynamic",
                      "--data-path", "synthetic", "--result-root",
                      str(tmp_path)])
        elif entry == "train_net":
            train_net(cfg, max_steps_per_epoch=1)
        else:
            profile_training.main(["--steps", "1"])
    assert not list(tmp_path.iterdir())
