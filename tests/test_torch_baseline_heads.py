"""The baselines' heads alone against the JAX package's, on the CPU:
``ActorTransformer``, ``CrossInferBlock`` (with its BatchNorm in training
and in eval), ``TorchLSTM`` and ``PCTDM`` (one trainable bias per LSTM
direction), ``GCNModule`` (without and with ``token_mask``, a padded token's
row fully masked; LayerNorm over [T*N, NFG] and over [NFG]) and ``SACRF`` /
``BiUTE`` (actors that all halt early, and actors that never halt).

Inputs come from a numpy seed; the parameters (of the shapes din_tpu's
heads initialise: kernels at the reference's init scale, biases, LayerNorm
and BatchNorm affines, clique weights and BatchNorm statistics all away
from their init values) go into din_tpu's heads as they are and into the
port's through the converters of ``din_tpu_torch.nn.ref_export``.  Widths
are narrow (C=64, N=12, T=4, B=2; PCTDM's hidden size 32; SACRF with 2
heads and 4 halting iterations), everything float32.  Each head runs in
eval mode and in training mode with its dropouts at 0 (the two
frameworks' dropout generators differ); a scalar loss (the outputs
weighted by fixed random numbers) is differentiated by ``jax.grad`` and by
autograd.  The JAX side runs jitted (eagerly this file takes about four
times as long), and the fault of din_tpu's jitted CPU gradient
(ROADMAP.md §3) is ``DynamicCollective``'s: here the port's autograd
holds din_tpu's gradients within the bounds below, which a wrong gradient
would not meet.  tests/test_torch_baselines_train*.py take one training
step of the full models.

Tolerances: outputs within 1e-5 of the largest |output| plus 1e-6
(measured <= 2.1e-6 of it; flax's LayerNorm takes the variance as
E[x^2] - E[x]^2, torch's in two passes); the input's and every
parameter's gradient within 1e-4 of the tensor's largest |gradient| plus
1e-6 of the case's largest parameter gradient (measured <= 2.8e-6 of the
tensor's largest; the floor is for the biases of ARG's ``phi`` and
PCTDM's ``att_extra_weights``, whose gradients are 0 but for f32 noise, a
softmax row being invariant to a constant added to it); BatchNorm running
statistics within 1e-6.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from din_tpu.heads.arg import GCNModule as JaxGCN
from din_tpu.heads.at import ActorTransformer as JaxAT
from din_tpu.heads.higcin import CrossInferBlock as JaxCIB
from din_tpu.heads.pctdm import PCTDM as JaxPCTDM
from din_tpu.heads.pctdm import TorchLSTM as JaxLSTM
from din_tpu.heads.sacrf_biute import SACRF as JaxSACRF
from din_tpu.heads.sacrf_biute import BiUTE as JaxBiUTE
from din_tpu_torch.heads.arg import GCNModule
from din_tpu_torch.heads.at import ActorTransformer
from din_tpu_torch.heads.higcin import CrossInferBlock
from din_tpu_torch.heads.pctdm import PCTDM, TorchLSTM
from din_tpu_torch.heads.sacrf_biute import SACRF, BiUTE
from din_tpu_torch.nn.layers import SeededDropout
from din_tpu_torch.nn.ref_export import (_att_block, _cib, _gcn, _lin, _ln,
                                         _lstm)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

B, T, N, C = 2, 4, 12, 64
# SACRF's halting iterations and attention heads here (10 and 8 in the
# models, tests/test_torch_baselines.py): fewer keep the JAX compile short
ITERS, HEADS = 4, 2
GEN = torch.Generator


def random_params(tree, rng):
    """Seeded numpy values of the shapes of an initialised tree: kernels
    at the reference's init scale (std sqrt(2 / fan_in)), biases ~0.1,
    LayerNorm and BatchNorm scales and the clique weights near 1,
    BatchNorm statistics off 0 and 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = random_params(v, rng)
            continue
        shape = v.shape
        noise = rng.randn(*shape).astype(np.float32)
        if "kernel" in k:
            v = noise * np.float32(np.sqrt(2.0 / shape[-2]))
        elif k.endswith("bias") or k == "mean":
            v = 0.1 * noise
        elif k.endswith("scale") or k == "w":
            v = 1.0 + 0.1 * noise
        elif k == "var":
            v = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            raise KeyError(k)
        out[k] = v.astype(np.float32)
    return out


def tensors(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def check_close(got, want, what, rel=1e-5, floor=1e-6):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + floor, (what, err,
                                                     np.abs(want).max())


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0
    return model


def run_case(jmodule, port, convert, inputs, train, kw, params,
             stats=None):
    """Forward and gradients of the flax ``jmodule`` (``kw(train)`` its
    call's keywords) with ``params`` (and BatchNorm ``stats``) and of
    ``port``, its state from ``convert(params, stats)``, on ``inputs``
    (numpy; the first one is differentiated).  The loss weights each
    output by fixed random numbers.  Returns the outputs, gradients and
    new BatchNorm statistics of both."""
    port.load_state_dict(tensors(convert(params, stats)), strict=True)
    no_dropout(port.train(train))

    def call(p, x0):
        variables = {"params": p}
        if stats is None:
            return jmodule.apply(variables, x0, *inputs[1:], **kw(train)), {}
        variables["batch_stats"] = stats
        out, new = jmodule.apply(variables, x0, *inputs[1:],
                                 mutable=["batch_stats"], **kw(train))
        return out, new["batch_stats"]

    shapes = jax.eval_shape(call, params, inputs[0])[0]
    rng = np.random.RandomState(99)
    weights = [np.asarray(rng.randn(*o.shape), np.float32)
               for o in jax.tree_util.tree_leaves(shapes)]

    def loss(p, x0):
        out, new = call(p, x0)
        outs = jax.tree_util.tree_leaves(out)
        return sum(jnp.sum(a * w) for a, w in zip(outs, weights)), (outs,
                                                                    new)

    (_, (outs, new_stats)), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, inputs[0])

    xs = [torch.tensor(x, requires_grad=i == 0)
          for i, x in enumerate(inputs)]
    got = port(*xs)
    got = got if isinstance(got, tuple) else (got,)
    sum(torch.sum(a * torch.from_numpy(w))
        for a, w in zip(got, weights)).backward()
    return dict(outs=[np.asarray(o) for o in outs],
                got=[g.detach().numpy() for g in got],
                x_grad=(np.asarray(g_x), xs[0].grad.numpy()),
                grads=(convert(jax.device_get(g_params), None),
                       {n: p.grad.numpy()
                        for n, p in port.named_parameters()}),
                new_stats=jax.device_get(new_stats), port=port)


def check_case(r):
    for i, (w, g) in enumerate(zip(r["outs"], r["got"])):
        check_close(g, w, f"output {i}")
    check_close(r["x_grad"][1], r["x_grad"][0], "input gradient", 1e-4,
                1e-7)
    want, got = r["grads"]
    buffers = {n for n, _ in r["port"].named_buffers()}
    assert set(got) <= set(want) and set(want) - set(got) <= buffers
    scale = max(np.abs(want[n]).max() for n in got)
    for name, g in got.items():
        check_close(g, want[name], name, 1e-4, 1e-6 * scale)


def init(jmodule, rng, *inputs, **kw):
    """Random parameters (and BatchNorm statistics) of the shapes flax
    would initialise, without running its init."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0),
                                                 *inputs, **kw))
    variables = random_params(shapes, rng)
    return variables["params"], variables.get("batch_stats")


@pytest.mark.parametrize("train", [False, True])
def test_actor_transformer_matches_jax(train):
    rng = np.random.RandomState(1)
    x = rng.randn(B * T, N, C).astype(np.float32)
    jm = JaxAT(in_dim=C, dropout=0.0)
    params, _ = init(jm, rng, x)

    def convert(p, _):
        out = {}
        for n in ("Q_W", "K_W", "V_W", "FFN_linear1", "FFN_linear2"):
            _lin(p[n], n, out)
        for n in ("layernorm1", "layernorm2"):
            _ln(p[n], n, out)
        return out

    r = run_case(jm, ActorTransformer(C, GEN().manual_seed(0)), convert,
                 [x], train, lambda t: dict(deterministic=not t), params)
    check_case(r)


@pytest.mark.parametrize("train", [False, True])
def test_cross_infer_block_matches_jax(train):
    """S = 25 body cells of 5x5 crops; in training the BatchNorm
    normalises with the statistics over (B, T, S) and updates its running
    ones (momentum 0.1 in torch's terms), in eval it uses them."""
    rng = np.random.RandomState(2)
    x = rng.randn(B * 3, T, 25, C).astype(np.float32)
    jm = JaxCIB(in_dim=C)
    params, stats = init(jm, rng, x)

    def convert(p, s):
        out = {}
        _cib(p, s, "", out)
        return out

    r = run_case(jm, CrossInferBlock(C, GEN().manual_seed(0)), convert,
                 [x], train, lambda t: dict(train=t), params, stats)
    check_case(r)
    bn = r["port"].bn
    new = r["new_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"], rtol=0,
                               atol=1e-6)
    moved = not np.allclose(new["mean"], stats["bn"]["mean"])
    assert moved == train


def test_torch_lstm_matches_jax():
    """One direction over 12 steps, the fused bias carried as
    ``bias_ih_l0`` with ``bias_hh_l0 = 0``."""
    rng = np.random.RandomState(3)
    x = rng.randn(B * T, N, C).astype(np.float32)
    jm = JaxLSTM(hidden=32)
    params, _ = init(jm, rng, x)

    def convert(p, _):
        out = {}
        _lstm(p, "", out)
        return {k.lstrip("."): v for k, v in out.items()}

    r = run_case(jm, TorchLSTM(C, 32, GEN().manual_seed(0)), convert, [x],
                 False, lambda t: {}, params)
    check_case(r)


def test_lstm_trains_one_bias_and_folds_two_on_load():
    """``bias_ih_l0`` is the one trainable bias, ``bias_hh_l0`` a zero
    buffer: a reference state's two biases load as their sum (the same
    gates as ``nn.LSTM`` with both), and the state_dict has both keys."""
    lstm = TorchLSTM(8, 5, GEN().manual_seed(0))
    names = [n for n, _ in lstm.named_parameters()]
    assert names == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0"]
    ref = torch.nn.LSTM(8, 5, batch_first=True)
    with torch.no_grad():
        ref.bias_hh_l0.normal_()
    lstm.load_state_dict(ref.state_dict(), strict=True)
    assert not lstm.bias_hh_l0.any()
    torch.testing.assert_close(lstm.bias_ih_l0,
                               ref.bias_ih_l0 + ref.bias_hh_l0)
    x = torch.randn(3, 7, 8)
    torch.testing.assert_close(lstm(x), ref(x)[0], rtol=1e-5, atol=1e-6)
    assert sorted(lstm.state_dict()) == sorted(ref.state_dict())


@pytest.mark.parametrize("train", [False, True])
def test_pctdm_matches_jax(train):
    rng = np.random.RandomState(4)
    x = rng.randn(B, T, N, C).astype(np.float32)
    jm = JaxPCTDM(num_players=N, input_size=C, hidden=32)
    params, _ = init(jm, rng, x)

    def convert(p, _):
        out = {}
        _lstm(p["Bi_Lstm"]["fwd"], "Bi_Lstm", out)
        _lstm(p["Bi_Lstm"]["bwd"], "Bi_Lstm", out, "_reverse")
        for n in ("att_source_weights", "att_context_weights",
                  "att_extra_weights"):
            _lin(p[n], f"{n}.0", out)
        _lstm(p["Intra_Group_LSTM"], "Intra_Group_LSTM", out)
        return out

    r = run_case(jm, PCTDM(N, C, GEN().manual_seed(0), hidden=32), convert,
                 [x], train, lambda t: {}, params)
    check_case(r)


def _gcn_inputs(rng, token_mask):
    """[B, T*N, C] tokens, boxes over a 4x8 map (OW 8, so the distance
    mask at 0.2*OW = 1.6 cuts many pairs), and a token mask whose second
    clip has only 5 of its 12 actors in every frame."""
    x = rng.randn(B, T * N, C).astype(np.float32)
    xy = rng.uniform(0, 7, (B, T * N, 2)) * [1.0, 0.5]
    boxes = np.concatenate([xy, xy + 1.0], -1).astype(np.float32)
    mask = np.ones((B, T, N), bool)
    mask[1, :, 5:] = False
    return [x, boxes] + ([mask.reshape(B, T * N)] if token_mask else [])


@pytest.mark.parametrize("token_mask,over_tokens",
                         [(False, True), (True, False)])
@pytest.mark.parametrize("train", [False, True])
def test_gcn_module_matches_jax(token_mask, over_tokens, train):
    """Volleyball's layer (LayerNorm over [T*N, NFG]) and the collective
    one (``token_mask``, LayerNorm over [NFG]); a padded token's row has
    no related token: its relation row is 0, nothing is NaN, and its
    gradient is finite.  The relation matrix is compared too."""
    rng = np.random.RandomState(5)
    inputs = _gcn_inputs(rng, token_mask)
    jm = JaxGCN(num_features_gcn=C, num_features_relation=32, num_graph=4,
                pos_threshold=0.2, out_w=8,
                layernorm_over_tokens=over_tokens)
    params, _ = init(jm, rng, *inputs)

    def convert(p, _):
        out = {}
        _gcn(p, "", out, ln_over_features=not over_tokens)
        return out

    ln_shape = (T * N, C) if over_tokens else (C,)
    port = GCNModule(C, 32, 4, 0.2, 8, ln_shape, GEN().manual_seed(0))
    r = run_case(jm, port, convert, inputs, train, lambda t: {}, params)
    check_case(r)
    relation = r["got"][1]
    assert np.isfinite(relation).all()
    if token_mask:
        assert not relation[1, 5 + N * (T - 1):].any()
        assert np.isfinite(r["x_grad"][1]).all()


@pytest.mark.parametrize("train,halt_shift",
                         [(False, 0.0), (True, 0.0), (False, 8.0)])
def test_sacrf_and_biute_match_jax(train, halt_shift):
    """Q_hat, C_v, the halting loss and BiUTE's descriptor of C_v over
    ``ITERS`` iterations (the full models run 10: tests/
    test_torch_baselines.py), with the halting bias as drawn (actors halt
    at different iterations, some not at all: ``v_stop`` is the last) and
    shifted by +8, its kernel scaled by 0.01 (every actor halts at the
    second iteration: ``v_stop``
    = 2, whose Q_hat and C_v are returned; N(t) = ITERS for every cell
    and R(t) ~ 0)."""
    rng = np.random.RandomState(6)
    feats = rng.randn(B, T, N, C).astype(np.float32)
    xy = rng.uniform(0, 6, (B, T, N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 2, xy.shape)],
                           -1).astype(np.float32)

    class Both(fnn.Module):
        @fnn.compact
        def __call__(self, f, b, deterministic=True):
            q, c, h = JaxSACRF(in_dim=C, num_actions=9,
                               image_size=(64, 96), out_size=(4, 6),
                               num_att=HEADS, dropout=0.0,
                               max_iters=ITERS, name="SACRF")(
                                   f, b, deterministic=deterministic)
            return q, c, h, JaxBiUTE(in_dim=C, num_boxes=N, name="BiUTE")(c)

    jm = Both()
    params, _ = init(jm, rng, feats, boxes)
    if halt_shift:
        halt = params["SACRF"]["halt_fc"]
        halt["kernel"] = 0.01 * halt["kernel"]
        halt["bias"] = halt["bias"] + np.float32(halt_shift)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.SACRF = SACRF(C, 9, (64, 96), (4, 6), GEN().manual_seed(0),
                               num_att=HEADS, dropout=0.0, max_iters=ITERS)
            self.BiUTE = BiUTE(C, N, GEN().manual_seed(1))

        def forward(self, f, b):
            q, c, h = self.SACRF(f, b)
            return q, c, h, self.BiUTE(c)

    def convert(p, _):
        out = {}
        s = p["SACRF"]
        for n in ("f_u", "f_spatil_att", "f_temporal_att",
                  "compatible_trans_s", "compatible_trans_t", "halt_fc"):
            _lin(s[n], f"SACRF.{n}", out)
        _att_block(s["spatial_att"], "SACRF.spatial_att.", out)
        _att_block(s["temporal_att"], "SACRF.temporal_att.", out)
        _lin(p["BiUTE"]["q"], "BiUTE.q", out)
        return out

    r = run_case(jm, Port(), convert, [feats, boxes], train,
                 lambda t: dict(deterministic=not t), params)
    check_case(r)
    loss, cells = float(r["got"][2]), B * T * N
    assert (abs(loss - ITERS * cells) < 0.01 * cells) == (halt_shift > 0)
