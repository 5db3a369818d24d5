"""The port's serving artifact (``experiments/export_serving.py``) of the
flagship against the JAX package and the port's live ``Predictor``, on the
CPU.

din_tpu's perturbed tiny flagship (64x96, a 2x3 map, T=3, N=4, NFB 64,
lite 16, float32) is carried across by ``jax_params_to_state_dict`` into a
stage-2 ``.pth`` as tests/test_torch_serving_ckpt.py does (its ``case``
fixture); the CLI exports it at batch 2 and it is loaded back as an
``ExportedPredictor``, and in a fresh interpreter.
tests/test_torch_export_collective.py holds a collective model's artifact
and the files that are refused.

Tolerances: against din_tpu's ``Predictor`` atol 1e-5 (the CPU port's own
bound against din_tpu, f32 summation order); against the port's live
``Predictor`` 1e-7, since the program runs the same ATen ops and the same
plain versions of the kernels (measured: bit-equal, 0.0).
"""

import collections
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from din_tpu_torch.data.synthetic import make_synthetic_batch
from din_tpu_torch.experiments import export_serving
from din_tpu_torch.experiments.export_serving import (ExportedPredictor,
                                                      read_header)
from din_tpu_torch.experiments.predict import Predictor
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.ops.pool import max_pool_2x2_ref
from din_tpu_torch.ops.roi_align import roi_align_ref
from din_tpu_torch.ops.stem import fused_stem_ref
from test_torch_serving_ckpt import case  # noqa: F401 (fixture)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]

_LOADER = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from din_tpu_torch.experiments.export_serving import ExportedPredictor
served = ExportedPredictor.load(sys.argv[1], device="cpu")
req = np.load(sys.argv[2])
out = served(req["images"], req["boxes"])
np.save(sys.argv[3], out["activities"])
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("din_tpu_torch."))))
"""


@pytest.fixture(scope="module")
def flagship(case):  # noqa: F811
    """The flagship's artifact at batch 2, written by the CLI from the
    ``.pth`` and loaded back; the live Predictor and a 5-clip request."""
    path = case["tmp"] / "flagship.pt2"
    with mock.patch.dict(PRESETS, tiny=lambda: case["cfg"]), \
            contextlib.redirect_stdout(io.StringIO()) as printed:
        export_serving.main(["--preset", "tiny", "--ckpt", case["path"],
                             "--out", str(path), "--batch", "2", "--device",
                             "cpu"])
    batch = make_synthetic_batch(case["cfg"], 5,
                                 rng=np.random.RandomState(7))
    # a fresh interpreter loads the file and answers 3 clips meanwhile
    request, out = case["tmp"] / "req.npz", case["tmp"] / "out.npy"
    np.savez(request, images=batch["images"][:3], boxes=batch["boxes"][:3])
    loader = subprocess.Popen(
        [sys.executable, "-c", _LOADER, str(path), str(request), str(out)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield dict(path=path, batch=batch, printed=printed.getvalue(),
                   loader=loader, out=out,
                   live=Predictor.from_checkpoint(case["cfg"], case["path"],
                                                  pad_to=2, device="cpu"),
                   served=ExportedPredictor.load(str(path), device="cpu"))
    finally:
        loader.kill()
        loader.communicate()


def test_flagship_matches_jax_and_live_predictors(case, flagship):  # noqa: F811
    """1, 2, 3 and 5 clips at the artifact's batch of 2."""
    b, served = flagship["batch"], flagship["served"]
    assert served.pad_to == 2 and served.header["outputs"] == ["activities"]
    for n in (1, 2, 3, 5):
        request = (b["images"][:n], b["boxes"][:n])
        got = served(*request)["activities"]
        assert got.shape == (n, case["cfg"].num_activities)
        np.testing.assert_allclose(
            got, case["jax"](*request)["activities"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            got, flagship["live"](*request)["activities"], rtol=0, atol=1e-7)


def _op_counts(program) -> collections.Counter:
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function")


def _plain_counts(fn, *args) -> collections.Counter:
    """Ops of one plain version traced alone, as the program is traced."""
    class Plain(torch.nn.Module):
        def forward(self, *tensors):
            return fn(*tensors)

    with torch.no_grad():
        return _op_counts(torch.export.export(Plain(), args, strict=False))


def test_flagship_graph_holds_the_kernels_ops_and_no_plain_version(flagship):
    """One stem, four pools (one chunk of 6 frames: the fifth pool is
    the stem's) and one RoIAlign, as ops; and none of the plain versions
    inlined: for each, some op of its expansion occurs fewer times in the
    graph than that many copies of it would need."""
    with open(flagship["path"], "rb") as f:
        program = torch.export.load(f)
    ops = _op_counts(program)
    kernels = {k: v for k, v in ops.items() if k.startswith("din_tpu_torch.")}
    assert kernels == {"din_tpu_torch.fused_stem.default": 1,
                       "din_tpu_torch.max_pool_2x2.default": 4,
                       "din_tpu_torch.roi_align.default": 1}
    rng = np.random.RandomState(8)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    plain = [(_plain_counts(fused_stem_ref, t(6, 64, 96, 3), t(64, 3, 3, 3),
                            t(64), t(64, 64, 3, 3), t(64)), 1),
             (_plain_counts(max_pool_2x2_ref, t(6, 32, 48, 128)), 4),
             (_plain_counts(lambda f, b: roi_align_ref(f, b, (5, 5)),
                            t(6, 2, 3, 512), t(6, 4, 4).abs()), 1)]
    for expansion, calls in plain:
        assert any(ops[op] < calls * n for op, n in expansion.items()), (
            expansion, calls)


def test_loading_and_serving_import_no_model_code(flagship):
    """In a fresh interpreter: the artifact loads and answers a 3-clip
    request (equal to the live Predictor's) with no module of ``models``,
    ``heads``, ``nn`` or ``train`` imported."""
    stdout, stderr = flagship["loader"].communicate(timeout=120)
    assert flagship["loader"].returncode == 0, stderr
    loaded = json.loads(stdout.strip().splitlines()[-1])
    assert "din_tpu_torch.ops.roi_align" in loaded
    assert not [m for m in loaded if m.split(".")[1] in
                ("models", "heads", "nn", "train")], loaded
    b = flagship["batch"]
    np.testing.assert_allclose(
        np.load(flagship["out"]),
        flagship["live"](b["images"][:3], b["boxes"][:3])["activities"],
        rtol=0, atol=1e-7)


def test_cli_writes_an_artifact_of_the_checkpoint(flagship):
    """``export_serving --ckpt --batch 2 --device cpu`` (the flagship
    fixture's file) says what it wrote, and its header is the CLI's."""
    path = flagship["path"]
    assert flagship["printed"].startswith(f"wrote {path}: ")
    header = read_header(path.read_bytes())
    assert header == flagship["served"].header
    assert (header["batch"], header["device"], header["has_bboxes_num"],
            header["arg_shapes"]) == (2, "cpu", False,
                                      [[2, 3, 64, 96, 3], [2, 3, 4, 4]])
    assert header["torch_version"] == torch.__version__
