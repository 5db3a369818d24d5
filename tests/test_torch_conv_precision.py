"""``ieee_conv2d`` (din_tpu_torch/utils/precision.py) on the CPU: the
float32 convolution whose forward and backward both run with cuDNN's TF32
off on the card, as din_tpu runs its convolutions and their transposes at
``precision="highest"``.

On the CPU it must equal plain autograd of ``F.conv2d`` bit for bit, its
backward must run under ``allow_tf32 = False`` whatever the caller set, and
the flagship DIN head, whose grid convs call it, must keep its gradients
within the bounds the trajectory test holds din_tpu's to.  What TF32 would
change is shown on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from din_tpu_torch.utils import precision
from din_tpu_torch.utils.precision import ieee_conv2d


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("conf", [
    dict(stride=1, padding=1, dilation=1, groups=1, channels_last=True),
    dict(stride=2, padding=(0, 1), dilation=1, groups=1, channels_last=False),
    dict(stride=1, padding=(2, 1), dilation=(2, 1), groups=2,
         channels_last=False),
], ids=["vgg_channels_last", "strided", "dilated_grouped"])
def test_ieee_conv2d_equals_plain_autograd(conf, bias):
    """Output and the gradients of input, weight and bias bit-equal to
    autograd of ``F.conv2d`` on the same inputs, for the VGG conv (3x3, pad
    1, channels_last, as the backbone runs it) and the DIN head's dilated
    and grouped grid convs."""
    rng = np.random.RandomState(3)
    cin, cout, groups = 4, 6, conf["groups"]
    x = torch.from_numpy(rng.randn(2, cin, 7, 9).astype(np.float32))
    if conf["channels_last"]:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.randn(cout, cin // groups, 3, 3).astype(
        np.float32))
    b = torch.from_numpy(rng.randn(cout).astype(np.float32)) if bias else None
    args = dict(stride=conf["stride"], padding=conf["padding"],
                dilation=conf["dilation"], groups=groups)
    outs, grads = [], []
    for conv in (F.conv2d, ieee_conv2d):
        leaves = [t.clone().requires_grad_(True)
                  for t in ((x, w) if b is None else (x, w, b))]
        y = conv(leaves[0], leaves[1], leaves[2] if bias else None, **args)
        g = torch.from_numpy(np.random.RandomState(4).randn(*y.shape).astype(
            np.float32))
        y.backward(g)
        outs.append(y.detach())
        grads.append([t.grad for t in leaves])
    assert torch.equal(outs[0], outs[1])
    for plain, ieee in zip(*grads):
        assert torch.equal(plain, ieee)


def test_ieee_conv2d_backward_runs_with_tf32_off(monkeypatch):
    """The backward's dgrad, wgrad and bias gradient (``conv2d_grads``) run
    with cuDNN's TF32 switched off, whatever the caller set, and the
    caller's setting comes back after the backward."""
    seen = []
    grads = precision.conv2d_grads

    def recording(*args):
        seen.append(torch.backends.cudnn.allow_tf32)
        return grads(*args)

    monkeypatch.setattr(precision, "conv2d_grads", recording)
    x = torch.randn(1, 3, 5, 5, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    b = torch.randn(4, requires_grad=True)
    for caller in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller)
        seen.clear()
        y = ieee_conv2d(x, w, b, padding=1)
        y.sum().backward()
        assert seen == [False]
        assert torch.backends.cudnn.allow_tf32 is caller
        assert all(t.grad is not None for t in (x, w, b))


def test_flagship_din_head_gradients_match_jax():
    """The flagship's DIN head (one 3x3 field, dynamic sampling, softmaxed
    affinity; lite 128 wide on a T=10 x N=12 grid, batch 2) with random
    offset and affinity convs: the gradients of every parameter and of the
    input, for one random cotangent, against ``jax.grad`` of din_tpu's head
    at ``precision="highest"``, within 1e-4 * max|g_jax|, the bound
    tests/test_torch_train.py holds step 1's gradients to where no ReLU or
    pool flip reaches (measured here: at most 2.8e-6 of the max, in
    scale_conv's weight)."""
    from din_tpu.heads.din import MultiDynamicInference as JaxMulti
    from din_tpu_torch.heads.din import MultiDynamicInference
    from din_tpu_torch.nn.ref_export import _din
    from test_torch_model import _load, _perturb

    rng = np.random.RandomState(12)
    B, T, N, C = 2, 10, 12, 128
    kwargs = dict(kernel_sizes=((3, 3),), stride=1, dynamic_sampling=True,
                  sampling_ratio=(1,), group=1, scale_factor=True,
                  beta_factor=False, parallel_inference=False)
    x = rng.randn(B, T, N, C).astype(np.float32)
    cot = rng.randn(B, T, N, C).astype(np.float32)
    jm = JaxMulti(in_dim=C, **kwargs)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    params = _perturb(jax.device_get(variables["params"]), rng)

    def loss(p, xx):
        with jax.default_matmul_precision("highest"):
            return jnp.sum(jm.apply({"params": p}, xx)[0] * cot)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, x)

    def to_torch(tree):
        out = {}
        for k, v in tree.items():
            _din(v, f"DIMlist.{k.split('_')[1]}.", out)
        return out

    model = MultiDynamicInference(C, torch.Generator().manual_seed(0),
                                  **kwargs)
    _load(model, to_torch(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    (model(xt) * torch.from_numpy(cot)).sum().backward()
    want = dict(to_torch(g_params), x=np.asarray(g_x))
    got = dict({n: p.grad.numpy() for n, p in model.named_parameters()},
               x=xt.grad.numpy())
    assert sorted(got) == sorted(want)
    for name, g_jax in want.items():
        scale = np.abs(g_jax).max()
        assert scale > 0, name
        err = np.abs(got[name] - g_jax).max()
        assert err <= 1e-4 * scale, (name, err, scale)
