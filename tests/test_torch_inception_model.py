"""The port's ``collective_stage1`` (``BasenetCollective`` on Inception-v3)
against the JAX package, on the CPU, in float32 (JAX under
``default_matmul_precision("highest")``).

Both get the same seeded weights (``seeded`` of
tests/test_torch_inception.py over ``jax.eval_shape`` of din_tpu's model
init) at a small geometry, 96x128 frames, T=3, 13 actor slots, NFB 1024:
Mixed_5d is 9x13 and Mixed_6e 4x6.  Here the RoI map's ``out_size`` is
Mixed_5d's, so ``roi_align_multiscale`` pools Mixed_5d through
``roi_align`` and composes the resize into the rows for Mixed_6e;
tests/test_torch_inception_offscale.py runs the same checks with a map that
matches neither scale.  The batch is tests/test_torch_collective.py's:
three clips with 13, 1 and 7/5/9 real actors.

din_tpu's training step is ``make_train_step``'s: the loss with BatchNorm
live and its gradient, jitted with ``remat_backbone=False``
(rematerialisation is a memory knob of the TPU that does not change
values, and on the CPU it doubles the compile), then the update of
``make_optimizer``.  That update is Adam with weight decay, elementwise,
and ``collective_stage1`` trains every parameter, so it is applied to the
parameters and the gradient raveled into one vector each: the same
numbers, for a compile of one small program instead of one per tensor.

Most of these tests' time is din_tpu's tracing and compiling, so a case
overlaps what it can (``stage1_case``): din_tpu's step is traced over the
variables' shapes and compiled in a second thread while the weights are
drawn and the port's model is built; then that step and the port's run in
two more threads while the predictor test runs (XLA's compiler and
programs and torch's kernels release the interpreter; tracing does not).

Tolerances: posteriors within rtol 1e-4 / atol 1e-5 and no row within
1e-3 of one-hot (a saturated softmax would hide a wrong head); one
training step with the bounds of tests/test_torch_collective.py: losses
within rtol 1e-4, the accuracy counts equal, parameters within 2 lr plus
2 f32 ulps and at most 10 % of a tensor beyond 2e-5; running statistics
within rtol 1e-4 / atol 1e-5 of each tensor's largest (E[x^2] - E[x]^2
cancels in f32; tests/test_torch_inception.py holds them to a float64 run).
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from din_tpu.experiments.predict import Predictor as JaxPredictor
from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.train import losses as jax_losses
from din_tpu.train.optim import make_optimizer as jax_make_optimizer
from din_tpu.train.optim import trainable_mask
from din_tpu_torch.data.loader import to_device
from din_tpu_torch.experiments.predict import Predictor
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import jax_params_to_state_dict
from din_tpu_torch.train.engine import train_step
from din_tpu_torch.train.optim import make_optimizer
from test_torch_collective import _batch, check_params
from test_torch_inception import _HW, _MAPS, _STATS, _close, _torch, seeded
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def stage1_case(out_size, pool):
    """din_tpu's ``collective_stage1`` model at 96x128 with RoI maps of
    ``out_size`` and seeded variables, the port's model with them, and the
    batch; and, started on ``pool`` (a thread pool of three), din_tpu's
    training step (``jax_step``: ``jax_train_step``'s result) and the
    port's, of a copy of the model (``port_step``: metrics and model)."""
    geom = dict(image_size=_HW, out_size=out_size, num_frames=3,
                compute_dtype="float32", train_dropout_prob=0.0,
                batch_size=3, test_batch_size=3)
    jcfg = JAX_PRESETS["collective_stage1"]().replace(remat_backbone=False,
                                                      **geom)
    cfg = PRESETS["collective_stage1"]().replace(**geom)
    batch = _batch(cfg, 3)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), batch["images"][:1], batch["boxes"][:1],
        bboxes_num=batch["bboxes_num"][:1], train=False))
    grad = pool.submit(_lower_jax_grad(jcfg, jmodel, batch, shapes).compile)
    rng = np.random.RandomState(4)
    params = seeded(shapes["params"], rng)
    stats = seeded(shapes["batch_stats"], rng)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_torch(jax_params_to_state_dict(params, cfg,
                                                          stats)),
                          strict=True)
    trained = copy.deepcopy(model)
    return dict(
        jcfg=jcfg, cfg=cfg, jmodel=jmodel, params=params, stats=stats,
        model=model, batch=batch,
        jax_step=pool.submit(lambda: jax_train_step(
            jcfg, grad.result(), params, stats)),
        port_step=pool.submit(lambda: (train_step(
            trained, make_optimizer(cfg, trained),
            to_device(batch, torch.device("cpu")), cfg), trained)))


def check_stage1_predictor(case):
    """``Predictor(pad_to=2)`` posteriors (the Basenet's per-frame
    activities and actions) equal din_tpu's Predictor's within rtol 1e-4 /
    atol 1e-5; rows sum to 1 and none is within 1e-3 of one-hot."""
    b = case["batch"]
    with jax.default_matmul_precision("highest"):
        ref = JaxPredictor(case["jcfg"], {"params": case["params"],
                                          "batch_stats": case["stats"]},
                           pad_to=2)(b["images"], b["boxes"],
                                     b["bboxes_num"])
    got = Predictor(case["cfg"], case["model"], pad_to=2, device="cpu")(
        b["images"], b["boxes"], b["bboxes_num"])
    assert sorted(got) == sorted(ref) == ["actions", "activities"]
    assert got["activities"].shape == (9, 4)
    for k in ref:
        want = np.asarray(ref[k])
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].sum(-1), 1, atol=1e-5)
        assert want.max(-1).max() < 1 - 1e-3, k


def _lower_jax_grad(jcfg, jmodel, batch, shapes):
    """din_tpu's loss and gradient on ``batch``, BatchNorm live, lowered
    (not compiled) as one program of the variables of ``shapes``: (params,
    batch_stats) -> ((loss, (metrics, new batch_stats)), gradient)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p, stats):
        out, new = jmodel.apply(
            {"params": p, "batch_stats": stats}, jb["images"], jb["boxes"],
            bboxes_num=jb["bboxes_num"], train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        metrics = jax_losses.compute_losses(out, jb, jcfg, False)
        return metrics["loss"], (metrics, new["batch_stats"])

    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
            shapes["params"], shapes["batch_stats"])


def jax_train_step(jcfg, grad, params, stats):
    """din_tpu's training step (module docstring) with ``grad``, the
    compiled ``_lower_jax_grad``: (metrics, new params, new batch_stats) as
    numpy."""
    (_, (metrics, stats)), grads = jax.device_get(grad(params, stats))
    assert all(jax.tree_util.tree_leaves(trainable_mask(
        params, jcfg.train_backbone)))
    leaves, tree = jax.tree_util.tree_flatten(params)
    flat = np.concatenate([x.ravel() for x in leaves])
    gflat = np.concatenate([np.ravel(x) for x in
                            jax.tree_util.tree_leaves(grads)])
    tx = jax_make_optimizer(jcfg, flat)
    updates, _ = jax.jit(tx.update)(gflat, tx.init(flat), flat)
    new = np.asarray(optax.apply_updates(flat, updates))
    ends = np.cumsum([x.size for x in leaves])[:-1]
    new = [a.reshape(x.shape) for a, x in zip(np.split(new, ends), leaves)]
    return metrics, jax.tree_util.tree_unflatten(tree, new), stats


def check_stage1_train_step(case):
    """One training step of din_tpu's model (``jax_train_step``) and of the
    port's ``train_step`` from the same weights on the same batch,
    BatchNorm live, within the module docstring's bounds."""
    cfg = case["cfg"]
    ref, params, stats = case["jax_step"].result()
    got, model = case["port_step"].result()
    for k in ("loss", "activities_loss", "actions_loss"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("activities_correct", "activities_total"):
        assert int(got[k]) == int(ref[k]), k
    want = jax_params_to_state_dict(params, cfg, stats)
    own = model.state_dict()
    keys = [k for k in want if k.endswith(_STATS)]
    assert len(keys) == 2 * 70
    for k in keys:
        _close(own[k].numpy(), want[k], k)
    check_params(model, params, cfg, 1, "collective_stage1")


@pytest.fixture(scope="module")
def mixed_5d():
    with ThreadPoolExecutor(3) as pool:
        yield stage1_case(_MAPS[0], pool)


def test_collective_stage1_predictor_matches_jax(mixed_5d):
    check_stage1_predictor(mixed_5d)


def test_collective_stage1_train_step_matches_jax(mixed_5d):
    check_stage1_train_step(mixed_5d)
