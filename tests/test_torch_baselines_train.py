"""One training step of PCTDM and HiGCIN against din_tpu's, on the CPU,
with the models, weights and helpers of tests/test_torch_baselines.py (T=4
frames of 64x96, batch 2, dropout 0, the backbone frozen: its BatchNorm
still trains); SACRF+BiUTE's step is in
tests/test_torch_baselines_train_sacrf.py.

din_tpu's step is ``make_train_step``'s (din_tpu/train/engine.py:86-118):
``compute_losses`` of the model's outputs in training mode, the gradient of
the loss, one Adam update of ``make_optimizer``.  Its trunk (ResNet-18 and
RoIAlign, BatchNorm in training mode) runs jitted, frozen, and its RoI
features take the trunk's place in the head's pass
(``nn.intercept_methods``), whose gradient is jitted too: run eagerly,
one PCTDM step took ~40 s on a CPU host (its four LSTM scans), past a
file's time budget.  din_tpu's jitted CPU gradient is known to be wrong for
``DynamicCollective`` (ROADMAP.md §3); here it agrees with the port's
within the bounds below, which a wrong gradient would not meet.  The
heads' fixed-rate dropouts are 0 on both sides (HiGCIN's 0.5; SACRF's 0.1
by calling it deterministic, which computes its attentions once, the
port's path at rate 0), since the two frameworks' generators draw
different masks.  The backbone is frozen to keep the compiles to the
heads; its training is held against din_tpu by the ResNet-18 tests
(tests/test_torch_resnet.py, tests/test_torch_collective_stage1.py).

What each model adds: PCTDM trains one bias per LSTM direction, so after
the step its ``bias_ih_l0`` equals din_tpu's fused bias (two trainable
torch biases would move their sum 2 lr: every element beyond 2e-5) and
``bias_hh_l0`` stays 0; HiGCIN's head BatchNorms train and update their
running statistics; SACRF adds its halting loss times
``halting_penalty`` and the action loss of its posteriors.

Tolerances: the loss and its parts within rtol 1e-4 (SACRF's measured
1.7e-5: its activity logits are in the hundreds); the BatchNorm running
statistics within 1e-4 of the statistic's largest |value| (measured
1.2e-5, HiGCIN's PIM, whose input's large mean makes E[x^2] - E[x]^2
cancel); every parameter within the bounds of
tests/test_torch_collective.py ``check_params`` after one step (none more
than 2 lr plus 2 f32 ulps of the parameter apart, at most 10 % of a
tensor's elements beyond 2e-5: f32 sums of the two frameworks differ by
~1e-6 and flip rare ReLUs, and Adam turns a flipped gradient sign into
2 lr), but for ``NOISE_GRADIENT``; an LSTM bias at most 1 % beyond 2e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from din_tpu.heads.sacrf_biute import SACRF as JaxSACRF
from din_tpu.models.trunk import Trunk, trunk_from_cfg
from din_tpu.train import losses as jax_losses
from din_tpu.train.optim import make_optimizer as jax_make_optimizer
from din_tpu_torch.data.loader import to_device
from din_tpu_torch.nn.layers import SeededDropout
from din_tpu_torch.train.engine import train_step
from din_tpu_torch.train.optim import make_optimizer
from test_torch_baselines import port_state, setup
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def jax_step(case):
    """(metrics, params, batch_stats) after din_tpu's training step on the
    case's training batch (see the module docstring)."""
    jcfg, b = case["jcfg"], case["train_batch"]
    params, stats = case["variables"]["params"], case["variables"][
        "batch_stats"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    trunk = trunk_from_cfg(jcfg)

    def trunk_fn(tp):
        (roi, _, _), new = trunk.apply(
            {"params": tp, "batch_stats": stats["trunk"]}, jb["images"],
            jb["boxes"], bn_train=True, mutable=["batch_stats"])
        return roi, new["batch_stats"]

    with jax.default_matmul_precision("highest"):
        roi, trunk_stats = jax.jit(trunk_fn)(params["trunk"])

    def loss_fn(head, roi):
        def intercept(next_fun, args, kwargs, context):
            m = context.module
            if isinstance(m, Trunk):
                return roi, None, None
            if isinstance(m, fnn.Dropout):
                return args[0]
            if isinstance(m, JaxSACRF):
                kwargs = dict(kwargs, deterministic=True)
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(intercept):
            out, new = case["jmodel"].apply(
                {"params": dict(head, trunk=params["trunk"]),
                 "batch_stats": stats}, jb["images"], jb["boxes"],
                train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
        metrics = jax_losses.compute_losses(out, jb, jcfg, True)
        return metrics["loss"], (metrics, new["batch_stats"])

    head = {k: v for k, v in params.items() if k != "trunk"}
    with jax.default_matmul_precision("highest"):
        (_, (metrics, new_stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(head, roi)
    # the frozen trunk is out of the optimizer (din_tpu's trainable_mask)
    tx = jax_make_optimizer(jcfg, head)
    new_head = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, head)
    return (jax.device_get(metrics),
            jax.device_get(dict(new_head, trunk=params["trunk"])),
            jax.device_get(dict(new_stats, trunk=trunk_stats)))


# a gradient no larger than this anywhere in a tensor is f32 noise (sums
# that cancel: a softmax over a team is invariant to the bias of its
# logits), as in chip_smoke.py; Adam's first step moves such a weight lr
# one way or the other with the noise's sign
NOISE_GRADIENT = 1e-7


def check_train_step(name):
    case = setup(name, seed=5, train_backbone=False)
    cfg = case["cfg"]
    ref, params, stats = jax_step(case)
    model = case["model"]
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0
    got = train_step(model, make_optimizer(cfg, model),
                     to_device(case["train_batch"], torch.device("cpu")),
                     cfg)
    keys = [k for k in ("loss", "activities_loss", "actions_loss")
            if k in ref]
    assert ("actions_loss" in keys) == (name == "sacrf")
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("activities_correct", "activities_total"):
        assert int(got[k]) == int(ref[k]), k

    noise = {k for k, p in model.named_parameters() if p.grad is not None
             and float(p.grad.abs().max()) <= NOISE_GRADIENT}
    assert noise == ({"pctdm.att_extra_weights.0.bias"} if name == "pctdm"
                     else set()), noise
    want = port_state({"params": params, "batch_stats": stats}, cfg)
    own = model.state_dict()
    assert sorted(own) == sorted(want)
    lr = cfg.train_learning_rate
    for k, w in want.items():
        diff = (own[k].double() - w.double()).abs()
        if k.endswith(("running_mean", "running_var")):
            assert diff.max() <= 1e-4 * w.abs().max(), (k, float(diff.max()))
        elif w.is_floating_point():
            ulp = np.spacing(w.abs().numpy().astype(np.float32))
            assert (diff.numpy() <= 2 * lr + 2 * ulp).all(), (
                k, float(diff.max()))
            share = float((diff > 2e-5).double().mean())
            assert k in noise or share <= 0.1, (k, share)
    for k in [k for k in own if ".bias_ih_l0" in k]:
        # one trainable bias: no element a step (lr) away from din_tpu's
        assert not own[k.replace("_ih_", "_hh_")].any()
        share = float(((own[k] - want[k]).abs() > 2e-5).double().mean())
        assert share <= 0.01, (k, share)
    if name == "higcin":
        before = port_state(case["variables"], cfg)
        assert not torch.equal(own["BIM.bn.running_mean"],
                               before["BIM.bn.running_mean"])


@pytest.mark.parametrize("name", ["pctdm", "higcin"])
def test_one_train_step_matches_jax(name):
    check_train_step(name)
