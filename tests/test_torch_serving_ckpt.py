"""Serving a trained checkpoint with the port against the JAX package, on
the CPU: ``Predictor.from_checkpoint``, ``predict --ckpt`` and its
fold-back, ``serve_http`` and ``inspect_ckpt``.

din_tpu's parameters of the flagship at a small geometry (64x96 frames, a
2x3 map, T=3, N=4, NFB 64, lite 16, float32; the JAX side with the
canonical stem, equal in value to the folded one) go through
``jax_params_to_state_dict`` into a stage-2 ``.pth``, which the port loads
strictly; its posteriors are held against din_tpu's ``Predictor`` on the
same parameters at atol 1e-5, directly and through both HTTP front ends.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from din_tpu.experiments.predict import Predictor as JaxPredictor
from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.experiments.serve_http import make_server as jax_make_server
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.nn.ref_export import save_reference_checkpoint
from din_tpu.train.engine import init_model
from din_tpu_torch.data.synthetic import make_synthetic_batch
from din_tpu_torch.experiments import predict
from din_tpu_torch.experiments.predict import Predictor
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.experiments.serve_http import make_server
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.backbones import VGG16Backbone
from din_tpu_torch.nn.ref_export import jax_params_to_state_dict
from din_tpu_torch.train import inspect_ckpt
from din_tpu_torch.train.checkpoint import save_stage1_components, save_state
from din_tpu_torch.train.optim import make_optimizer
from test_torch_train import _perturb
from test_torch_threads import one_thread  # noqa: F401 (autouse)

GEOM = dict(image_size=(64, 96), out_size=(2, 3), num_frames=3,
            num_boxes=4, num_features_boxes=64, lite_dim=16,
            compute_dtype="float32", load_backbone_stage2=False)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """din_tpu's perturbed flagship parameters, their stage-2 ``.pth``, a
    3-clip request and din_tpu's ``Predictor(pad_to=2)``."""
    tmp = tmp_path_factory.mktemp("serving_ckpt")
    jcfg = JAX_PRESETS["volleyball_stage2_dynamic"]().replace(
        folded_stem=False, **GEOM)
    cfg = PRESETS["volleyball_stage2_dynamic"]().replace(**GEOM)
    rng = np.random.RandomState(0)
    batch = make_synthetic_batch(cfg, 3, rng=rng)
    jmodel = jax_build_model(jcfg)
    variables = init_model(jcfg, jmodel, {k: v[:1] for k, v in batch.items()})
    params = _perturb(jax.device_get(variables["params"]), rng)
    path = tmp / "stage2_epoch3_50.00%.pth"
    torch.save({"epoch": 3, "optimizer": {}, "state_dict": {
        k: torch.from_numpy(np.array(v))
        for k, v in jax_params_to_state_dict(params, cfg).items()}}, path)
    return dict(tmp=tmp, jcfg=jcfg, cfg=cfg, batch=batch, params=params,
                path=str(path),
                jax=JaxPredictor(jcfg, {"params": params}, pad_to=2))


def test_from_checkpoint_matches_jax_predictor(case):
    """Posteriors of the 3-clip request, unpadded and at pad_to=2, within
    atol 1e-5 of din_tpu's Predictor on the same parameters."""
    b = case["batch"]
    want = case["jax"](b["images"], b["boxes"])["activities"]
    for pad_to in (None, 2):
        p = Predictor.from_checkpoint(case["cfg"], case["path"],
                                      pad_to=pad_to, device="cpu")
        got = p(b["images"], b["boxes"])["activities"]
        assert got.shape == (3, case["cfg"].num_activities)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _port_model(cfg, seed=0):
    return build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def test_save_state_file_round_trips(case, tmp_path):
    """The port's own ``save_state`` file (with its Adam state) serves the
    weights of the model that wrote it, bit for bit; another seed's model
    answers otherwise."""
    cfg, b = case["cfg"], case["batch"]
    model = _port_model(cfg, seed=1)
    path = str(tmp_path / "own.pth")
    save_state(path, 2, model, make_optimizer(cfg, model))
    want = Predictor(cfg, model, device="cpu")(b["images"], b["boxes"])
    got = Predictor.from_checkpoint(cfg, path, device="cpu")(
        b["images"], b["boxes"])
    np.testing.assert_array_equal(got["activities"], want["activities"])
    other = Predictor.from_checkpoint(cfg, None, device="cpu")(
        b["images"], b["boxes"])
    assert not np.allclose(other["activities"], want["activities"])


@pytest.mark.parametrize("fault", ["parameter", "bn_buffer", "extra"])
def test_incomplete_file_raises(fault, tmp_path):
    """Strict loading: a file without one of the model's parameters or
    BatchNorm buffers, or with a tensor the model lacks, raises (a model
    never serves half-random weights).  The ResNet-18 smoke preset has
    BatchNorm."""
    cfg = PRESETS["synthetic_smoke"]()
    model = _port_model(cfg)
    state = model.state_dict()
    key = {"parameter": "fc_activities.weight",
           "bn_buffer": "backbone.features.1.running_var"}.get(fault)
    assert fault == "extra" or key in state
    if key:
        del state[key]
    else:
        state["DPI.stale.weight"] = torch.zeros(3)
    path = str(tmp_path / "bad.pth")
    torch.save({"epoch": 1, "state_dict": state, "optimizer": {}}, path)
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        Predictor.from_checkpoint(cfg, path, device="cpu")


def test_cli_ckpt_prints_the_checkpoints_answer(case, monkeypatch, capsys):
    """``predict --ckpt`` answers the synthetic request with the file's
    weights: one line per clip with the arg-max and its posterior."""
    monkeypatch.setitem(PRESETS, "tiny", lambda: case["cfg"])
    out = predict.main(["--preset", "tiny", "--ckpt", case["path"],
                        "--batch", "3", "--pad-to", "2", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    want = Predictor.from_checkpoint(case["cfg"], case["path"], pad_to=2,
                                     device="cpu")
    batch = make_synthetic_batch(case["cfg"], batch_size=3)
    acts = want(batch["images"], batch["boxes"])["activities"]
    np.testing.assert_array_equal(out["activities"], acts)
    assert printed == [f"clip {b}: activity={int(acts[b].argmax())} "
                       f"p={float(acts[b].max()):.3f}" for b in range(3)]


def test_cli_folds_frame_rows_back_per_clip(case, monkeypatch, capsys):
    """A model that answers per frame ([B*m, G]) is folded back: each
    clip's line is the mean of its m rows, not row b of clip 0."""
    monkeypatch.setitem(PRESETS, "tiny", lambda: case["cfg"])
    rows = np.random.RandomState(4).dirichlet(np.ones(8), size=6)
    monkeypatch.setattr(predict.Predictor, "__call__",
                        lambda self, *a: {"activities": rows})
    predict.main(["--preset", "tiny", "--batch", "2", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    folded = rows.reshape(2, 3, 8).mean(1)
    assert printed == [f"clip {b}: activity={int(folded[b].argmax())} "
                       f"p={float(folded[b].max()):.3f}" for b in range(2)]


@pytest.fixture(scope="module")
def servers(case):
    """The port's server around ``Predictor.from_checkpoint(pad_to=2)`` and
    din_tpu's around its Predictor, each on 127.0.0.1 at a free port in a
    thread; shut down and closed after the module."""
    port = Predictor.from_checkpoint(case["cfg"], case["path"], pad_to=2,
                                     device="cpu")
    info = {"model": case["cfg"].inference_module_name, "pad_to": 2}
    made = {"port": make_server(port, "127.0.0.1", 0, info),
            "jax": jax_make_server(case["jax"], "127.0.0.1", 0, info)}
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in made.values()]
    for t in threads:
        t.start()
    yield {k: f"http://127.0.0.1:{s.server_address[1]}"
           for k, s in made.items()}
    for s in made.values():
        s.shutdown()
        s.server_close()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def _post(url, body: bytes):
    try:
        with urllib.request.urlopen(url + "/predict", data=body,
                                    timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("clips", [1, 3])
def test_http_predict_matches_jax_server(case, servers, clips):
    """The same ``.npz`` request to both servers: the port's JSON
    posteriors equal din_tpu's within 1e-5 (both answer at pad_to=2: one
    padded call for 1 clip, two for 3)."""
    b = case["batch"]
    body = _npz(images=b["images"][:clips], boxes=b["boxes"][:clips])
    got_code, got = _post(servers["port"], body)
    want_code, want = _post(servers["jax"], body)
    assert got_code == want_code == 200
    assert sorted(got) == sorted(want) == ["activities"]
    got, want = (np.asarray(d["activities"], np.float32) for d in (got, want))
    assert got.shape == (clips, case["cfg"].num_activities)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_http_healthz(servers):
    """``/healthz`` answers as din_tpu's does; an unknown path is a 404."""
    bodies = []
    for url in (servers["port"], servers["jax"]):
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert r.status == 200
            bodies.append(json.loads(r.read()))
    assert bodies[0] == bodies[1] == {"ok": True,
                                      "model": "dynamic_volleyball",
                                      "pad_to": 2}
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(servers["port"] + "/nope", timeout=30)
    assert err.value.code == 404


@pytest.mark.parametrize("body", ["not_npz", "no_boxes", "bad_shape"])
def test_http_malformed_body_gets_400(case, servers, body):
    """A body that is no ``.npz``, lacks ``boxes``, or has frames of
    another shape (two colour channels) gets a 400 with an error message,
    and the server goes on answering.  (Frames of another size are a
    request like any other: their map goes through the resize rows
    composed into RoIAlign's, as din_tpu's does.)"""
    b = case["batch"]
    payload = {"not_npz": b"this is not an npz archive",
               "no_boxes": _npz(images=b["images"][:1]),
               "bad_shape": _npz(images=b["images"][:1, ..., :2],
                                 boxes=b["boxes"][:1])}[body]
    code, reply = _post(servers["port"], payload)
    assert code == 400 and reply["error"]
    code, _ = _post(servers["port"], _npz(images=b["images"][:1],
                                          boxes=b["boxes"][:1]))
    assert code == 200


@pytest.mark.parametrize("layout", ["stage2", "stage1", "reference",
                                    "torchvision"])
def test_inspect_ckpt_describes_each_layout(case, layout, tmp_path):
    """``inspect_ckpt`` on the four ``.pth`` layouts the port reads or
    writes: the layout, payload keys, epoch, the modules and a parameter
    count equal to the model's (BatchNorm buffers apart); ``--full``
    prints every key with its shape and dtype."""
    cfg = case["cfg"]
    path = str(tmp_path / f"{layout}.pth")
    if layout == "stage2":
        model = _port_model(cfg)
        save_state(path, 4, model, make_optimizer(cfg, model))
        modules = {"backbone", "fc_emb_1", "nl_emb_1", "point_conv",
                   "point_ln", "DPI", "dpi_nl", "fc_activities"}
        want = dict(layout="stage-2 / reference full-model", epoch=4,
                    keys=["epoch", "optimizer", "state_dict"])
    elif layout == "stage1":
        model = _port_model(PRESETS["volleyball_stage1"]().replace(
            **{k: v for k, v in GEOM.items() if k != "lite_dim"}))
        save_stage1_components(path, model)
        modules = {"backbone", "fc_emb", "fc_actions", "fc_activities"}
        want = dict(layout="stage-1 components", epoch=None,
                    keys=sorted(f"{m}_state_dict" for m in modules))
    elif layout == "reference":
        save_reference_checkpoint({"params": case["params"]}, case["jcfg"],
                                  path, epoch=7)
        model = _port_model(cfg)
        modules = {"backbone", "fc_emb_1", "nl_emb_1", "point_conv",
                   "point_ln", "DPI", "dpi_nl", "fc_activities"}
        want = dict(layout="stage-2 / reference full-model", epoch=7,
                    keys=["epoch", "optimizer", "state_dict"])
    else:
        model = VGG16Backbone(torch.Generator().manual_seed(0))
        state = {f"features.{k.split('.', 1)[1]}": v
                 for k, v in model.state_dict().items()}
        state.update({"classifier.6.weight": torch.zeros(8, 16),
                      "classifier.6.bias": torch.zeros(8)})
        torch.save(state, path)
        modules = {"features", "classifier"}
        want = dict(layout="bare state_dict (torchvision backbone)",
                    epoch=None, keys=sorted(state))
    lines = []
    info = inspect_ckpt.describe(path, full=True, out=lines.append)
    assert {k: info[k] for k in want} == want
    assert set(info["modules"]) == modules
    n_params = sum(p.numel() for p in model.parameters())
    if layout == "torchvision":
        n_params += 8 * 16 + 8
    assert info["params"] == n_params
    flat = (model.state_dict() if layout != "torchvision" else state)
    assert sum(1 for line in lines if line.startswith("    ")) == len(flat)
    assert lines[0].startswith(path)
