"""The port's serving artifact of a collective model
(``experiments/export_serving.py``) against the JAX package and the port's
live ``Predictor``, on the CPU, and the files it refuses.

The model is tests/test_torch_collective.py's tiny ``DynamicCollective``
(ResNet-18 with perturbed BatchNorm, 64x96 frames, a 2x3 map, T=3, 13
actor slots, float32, three clips of 13, 1 and 7/5/9 actors), exported at
``pad_to=2`` and loaded back from its bytes.  Tolerances as in
tests/test_torch_export_serving.py: atol 1e-5 against din_tpu's
``Predictor``, 1e-7 against the port's live one (measured: bit-equal).
"""

import io
import zipfile

import jax
import numpy as np
import pytest

from din_tpu.experiments.predict import Predictor as JaxPredictor
from din_tpu_torch.experiments import export_serving
from din_tpu_torch.experiments.export_serving import (ExportedPredictor,
                                                      export_predictor,
                                                      read_header)
from din_tpu_torch.experiments.predict import Predictor
from test_torch_collective import _setup as collective_setup
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def collective():
    """The model, its live Predictor, the artifact's bytes and the
    artifact loaded from them."""
    c = collective_setup("collective_stage2_dynamic", 0)
    live = Predictor(c["cfg"], c["model"], pad_to=2, device="cpu")
    data = export_predictor(live)
    return dict(c, live=live, data=data,
                served=ExportedPredictor.from_bytes(data, device="cpu"))


def test_collective_artifact_needs_bboxes_num_and_matches(collective):
    """A request without ``bboxes_num`` is refused; with it, the
    posteriors match both predictors."""
    b, served = collective["batch"], collective["served"]
    header = served.header
    assert header["has_bboxes_num"] and header["arg_dtypes"] == [
        "uint8", "float32", "int32"]
    assert header["inference_module_name"] == "dynamic_collective"
    with pytest.raises(ValueError, match="bboxes_num"):
        served(b["images"], b["boxes"])
    request = (b["images"], b["boxes"], b["bboxes_num"])
    got = served(*request)
    variables = {"params": collective["params"],
                 "batch_stats": collective["stats"]}
    with jax.default_matmul_precision("highest"):
        want = JaxPredictor(collective["jcfg"], variables, pad_to=2)(*request)
    assert sorted(got) == sorted(want) == header["outputs"]
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got[k], collective["live"](*request)[k],
                                   rtol=0, atol=1e-7)


def _zip(files) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, text in files.items():
            z.writestr(name, text)
    return buf.getvalue()


_BAD_FILES = {
    "not_a_zip": (lambda: b"not an archive at all", "not a zip archive"),
    "dinx": (lambda: b"DINTPUX1" + bytes(16), "JAX StableHLO"),
    "no_header": (lambda: _zip({"archive/models/model.json": "{}"}),
                  "without"),
    "other_format": (lambda: _zip({
        "archive/extra/" + export_serving.HEADER_NAME: "{}"}), "format"),
}


@pytest.mark.parametrize("kind", sorted(_BAD_FILES))
def test_a_file_that_is_not_an_artifact_raises(kind, tmp_path):
    """``ValueError`` naming what is wrong, before any program loads."""
    make, match = _BAD_FILES[kind]
    path = tmp_path / "bad.pt2"
    path.write_bytes(make())
    with pytest.raises(ValueError, match=match):
        ExportedPredictor.load(str(path), device="cpu")


def test_an_artifact_is_served_only_on_its_device(collective):
    """A device other than the header's is refused, not moved to; a request
    of another shape past the batch is refused too."""
    assert read_header(collective["data"])["device"] == "cpu"
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        ExportedPredictor.from_bytes(collective["data"], device="meta")
    b = collective["batch"]
    with pytest.raises(ValueError, match="does not match"):
        collective["served"](b["images"][:, :2], b["boxes"][:, :2],
                             b["bboxes_num"][:, :2])
