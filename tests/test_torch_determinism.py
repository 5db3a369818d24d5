"""The training step's fixed summation order, on the CPU.

On the card two training runs from one state parted (the scatter-add
behind ``torch.gather``'s backward in the DIN head's corner sampling, and
cuDNN's backward algorithms, add with atomics).  The port repairs both
locally: the DIN head's gather has a backward that is the transposed one-hot
product (``heads/din.py`` ``_TakeRows``, in IEEE float32), and
``train_step`` runs forward and backward under ``deterministic_convs()``.
Here: the gather's forward is ``torch.gather`` bit for bit and its gradient
equals ``torch.gather``'s (exactly where every sum is exact, within float32
summation order else), its product runs with cuBLAS's TF32 off whatever the
caller set, the DIN head's gradients still match din_tpu's for the
sampling modes that reach it, the head still exports, and the step's
convolutions run on cuDNN's deterministic algorithms, the caller's flags
restored after.  ``chip_smoke.py`` shows on the card that two runs from one
state are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu_torch.data.loader import BatchLoader, to_device
from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.heads import din
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.train import engine
from din_tpu_torch.train.optim import make_optimizer
from din_tpu_torch.utils import precision
from test_torch_threads import one_thread  # noqa: F401 (autouse)
from test_torch_train_infra import tiny_cfg


def _gather_take(flat, idx):
    """The gather with autograd's own backward (a scatter-add)."""
    B, C = flat.shape[0], flat.shape[-1]
    out = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def _both(flat, idx, cot):
    outs, grads = [], []
    for take in (din._take, _gather_take):
        leaf = flat.clone().requires_grad_(True)
        y = take(leaf, idx)
        (y * cot).sum().backward()
        outs.append(y.detach())
        grads.append(leaf.grad)
    return outs, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_take_equals_gather_forward_and_backward(dtype):
    """flat [2,168,16] (the flagship's padded 12x14 grid), idx [2,10,12,9]
    with many repeats (rows hit up to ~30 times).  Forward bit-equal; with
    an integer cotangent every sum is exact, so the gradients are equal
    whatever the order; with a random one within float32 summation order."""
    g = torch.Generator().manual_seed(0)
    flat = torch.randn((2, 168, 16), generator=g).to(dtype)
    idx = torch.randint(0, 168, (2, 10, 12, 9), generator=g)
    idx[:, :, :, 0] = 5                           # one row hit 120 times
    cot = torch.randint(-1, 2, (2, 10, 12, 9, 16), generator=g).to(dtype)
    (y, y_ref), (d, d_ref) = _both(flat, idx, cot)
    assert torch.equal(y, y_ref) and y.dtype == dtype
    assert d.dtype == dtype and torch.equal(d, d_ref)
    cot = torch.randn((2, 10, 12, 9, 16), generator=g)
    (_, _), (d, d_ref) = _both(flat.float(), idx, cot)
    torch.testing.assert_close(d, d_ref, rtol=1e-6, atol=1e-6)
    assert bool((d != 0).any())


def test_take_product_runs_with_tf32_off(monkeypatch):
    """The backward's product runs with ``cuda.matmul.allow_tf32`` False
    even where the caller set it True; the flag is restored after."""
    seen = []
    bmm = torch.bmm

    def recording(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return bmm(*args)

    monkeypatch.setattr(torch, "bmm", recording)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    flat = torch.randn(2, 6, 3, requires_grad=True)
    din._take(flat, torch.tensor([[0, 5, 5], [1, 1, 2]])).sum().backward()
    assert seen == [False]
    assert torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("variant", [
    dict(dynamic_sampling=False, scale_factor=True),
    dict(parallel_inference=True, scale_factor=True),
], ids=["plain_grid", "parallel"])
def test_din_head_gradients_match_jax(variant):
    """The DIN head's gradients through ``_take`` at integer grid samples
    (the plain grid, and the parallel head's, which also walks) against
    ``jax.grad`` of din_tpu's head at ``precision="highest"``: every
    parameter and the input, within 1e-4 * max|g_jax|, the bound
    tests/test_torch_conv_precision.py holds the flagship's dynamic head
    to (bilinear samples)."""
    from din_tpu.heads.din import MultiDynamicInference as JaxMulti
    from din_tpu_torch.heads.din import MultiDynamicInference
    from din_tpu_torch.nn.ref_export import _din
    from test_torch_model import _load, _perturb

    rng = np.random.RandomState(13)
    B, T, N, C = 2, 4, 5, 16
    kwargs = dict(dict(kernel_sizes=((3, 3), (1, 3)), dynamic_sampling=True,
                       sampling_ratio=(1,), parallel_inference=False,
                       beta_factor=False), **variant)
    x = rng.randn(B, T, N, C).astype(np.float32)
    cot = rng.randn(B, T, N, C).astype(np.float32)
    jm = JaxMulti(in_dim=C, **kwargs)
    params = _perturb(jax.device_get(
        jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"]), rng)

    def loss(p, xx):
        with jax.default_matmul_precision("highest"):
            return jnp.sum(jm.apply({"params": p}, xx)[0] * cot)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)

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
        err = np.abs(got[name] - g_jax).max()
        assert err <= 1e-4 * max(scale, 1e-30), (name, err, scale)
    assert np.abs(want["x"]).max() > 0


def test_din_head_exports_with_and_without_grad():
    """``torch.export`` traces the head, whose gather is now an autograd
    Function, with grad mode off (as ``export_serving`` exports) and on;
    the program's output equals the eager head's."""
    from din_tpu_torch.heads.din import MultiDynamicInference

    model = MultiDynamicInference(16, torch.Generator().manual_seed(0),
                                  kernel_sizes=((3, 3),))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.1 * torch.randn(p.shape))
    x = torch.randn(2, 4, 5, 16)
    with torch.no_grad():
        want = model(x)
        prog = torch.export.export(model, (x,))
        assert torch.equal(prog.module()(x), want)
    prog = torch.export.export(model, (x,))
    with torch.no_grad():
        assert torch.equal(prog.module()(x), want)


def test_train_step_runs_on_deterministic_convs(tmp_path, monkeypatch):
    """The step's forward and its backward (the DIN head's grid convs'
    ``conv2d_grads``) run with ``cudnn.deterministic`` on and
    ``cudnn.benchmark`` off; the caller's flags are back after, also after
    a step that raises."""
    seen = []
    grads = precision.conv2d_grads

    def recording(*args):
        seen.append(("bwd", torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return grads(*args)

    losses = engine.compute_losses

    def recording_losses(*args):
        seen.append(("fwd", torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return losses(*args)

    monkeypatch.setattr(precision, "conv2d_grads", recording)
    monkeypatch.setattr(engine, "compute_losses", recording_losses)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    cfg = tiny_cfg(tmp_path)
    model = build_model(cfg, device="cpu")
    batch = to_device(next(iter(BatchLoader(SyntheticDataset(cfg, seed=4),
                                            2, seed=0))), torch.device("cpu"))
    engine.train_step(model, make_optimizer(cfg, model), batch, cfg)
    assert seen and set(seen) == {("fwd", True, False), ("bwd", True, False)}
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == (False, True)
    with pytest.raises(FloatingPointError):
        with torch.no_grad():
            model.fc_activities.bias.fill_(float("nan"))
        engine.train_step(model, make_optimizer(cfg, model), batch,
                          cfg.replace(debug_nans=True))
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == (False, True)
