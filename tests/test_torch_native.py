"""The port's host JPEG decoder against din_tpu's, on the CPU.

``din_tpu_torch/native`` builds its own copy of ``din_loader.cc`` with g++
into ``build/host_loader/<hash>/`` at the checkout's root; din_tpu builds
the same source beside its package.  Built by the same compiler against the
same libjpeg, the two give the same bytes for every frame: at the JPEG's own
size, where libjpeg's DCT prescale divides it, and where the bilinear resize
finishes it.  The fallback to PIL is visible in ``decoder()``.

din_tpu writes its library beside its source with ``g++ -o`` and no lock,
so under ``pytest -n 6`` other workers that import ``din_tpu.native``
(tests/test_native.py, tests/test_data.py, ...) may be writing the same
file while this one loads it, which then fails (``available()`` False).
This file therefore builds din_tpu's source with din_tpu's own build
function into a directory of its own and points din_tpu's loader there for
its tests.
"""

import io
from pathlib import Path

import numpy as np
import pytest

from din_tpu import native as jax_native
from din_tpu_torch import native
from test_torch_threads import one_thread  # noqa: F401 (autouse)

Image = pytest.importorskip("PIL.Image")

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def built(tmp_path_factory):
    """Both decoders build here (g++ and libjpeg's headers are present);
    a failed build fails the tests instead of skipping them.  din_tpu's
    library is built in a directory of this module's own, and din_tpu's
    loader state is restored afterwards."""
    private = tmp_path_factory.mktemp("din_tpu_native") / "libdin_loader.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", str(private))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        assert native.available(), native.decoder()["error"]
        assert jax_native.available()
        assert private.exists()
        yield


def _jpeg(rng, h, w, quality=90):
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


# (source h, w) -> (out h, w): equal size; the DCT prescale alone (1/2,
# 1/4, 1/8); prescale then resize; resize down and up without prescale
@pytest.mark.parametrize("src,out", [
    ((64, 96), (64, 96)), ((128, 192), (64, 96)), ((128, 192), (32, 48)),
    ((256, 320), (32, 40)), ((128, 192), (30, 41)), ((72, 96), (50, 70)),
    ((40, 60), (64, 96))])
def test_decode_equals_din_tpu_bit_for_bit(src, out):
    rng = np.random.RandomState(sum(src) + sum(out))
    data = _jpeg(rng, *src)
    got = native.decode_resize(data, *out)
    assert got.shape == (*out, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_native.decode_resize(data, *out))
    if src == out:      # no resize: libjpeg's own decode, as PIL's
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_batch_call_equals_single_calls(n_threads):
    rng = np.random.RandomState(n_threads)
    datas = [_jpeg(rng, 48, 64) for _ in range(5)]
    batch = native.decode_resize_batch(datas, 24, 30, n_threads=n_threads)
    assert batch.shape == (5, 24, 30, 3)
    for d, b in zip(datas, batch):
        np.testing.assert_array_equal(b, native.decode_resize(d, 24, 30))
    np.testing.assert_array_equal(
        batch, jax_native.decode_resize_batch(datas, 24, 30, n_threads))


def test_bad_bytes_raise():
    good = _jpeg(np.random.RandomState(0), 16, 16)
    with pytest.raises(RuntimeError, match="decode failed"):
        native.decode_resize(b"not a jpeg", 16, 16)
    with pytest.raises(RuntimeError, match="failed for 1 frames"):
        native.decode_resize_batch([good, good[:40]], 16, 16)


def test_decoder_report_counts_each_path(tmp_path):
    """``decoder()`` names the native decoder; a clip of JPEGs counts as
    native frames, a PNG among them sends the clip frame by frame, where
    the PNG goes to PIL (as in din_tpu, whose frames equal these)."""
    rng = np.random.RandomState(1)
    paths = []
    for i in range(3):
        p = tmp_path / f"{i}.jpg"
        p.write_bytes(_jpeg(rng, 20, 30))
        paths.append(str(p))
    before = native.decoder()
    assert before["decoder"] == "native" and before["error"] is None
    frames = native.load_frames(paths, 20, 30)
    mid = native.decoder()["frames"]
    assert mid["native"] - before["frames"]["native"] == 3
    np.testing.assert_array_equal(
        frames, jax_native.load_frames(paths, 20, 30))

    png = tmp_path / "3.png"
    Image.fromarray((rng.rand(20, 30, 3) * 255).astype(np.uint8)).save(png)
    mixed = native.load_frames(paths + [str(png)], 20, 30)
    after = native.decoder()["frames"]
    assert after["pil"] - mid["pil"] == 1
    assert after["native"] - mid["native"] == 3
    np.testing.assert_array_equal(
        mixed, jax_native.load_frames(paths + [str(png)], 20, 30))


def test_library_is_built_under_build_not_beside_the_source():
    so = native.library_path()
    assert so.exists()
    assert so.relative_to(REPO / "build" / "host_loader")
    assert so.parent.name != "host_loader"          # keyed by a hash
    assert not list((REPO / "din_tpu_torch").rglob("*.so"))
    assert sorted(p.name for p in native.SRC.parent.iterdir()
                  if not p.name.startswith("__")) == ["din_loader.cc"]


def test_failed_build_is_reported_and_pil_decodes(tmp_path, monkeypatch):
    """A source that does not compile (as where libjpeg's headers are
    missing): no library, ``decoder()`` says "pil" with the compiler's
    error, and frames still decode, counted as PIL's."""
    bad = tmp_path / "din_loader.cc"
    bad.write_text("#include <no_such_jpeg_header.h>\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    rep = native.decoder()
    assert rep["decoder"] == "pil"
    assert "no_such_jpeg_header.h" in rep["error"]
    assert not list((tmp_path / "build").rglob("*.so"))
    p = tmp_path / "f.jpg"
    p.write_bytes(_jpeg(np.random.RandomState(2), 12, 16))
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        native.decode_resize(p.read_bytes(), 12, 16)
    n = rep["frames"]["pil"]
    out = native.load_frames([str(p), str(p)], 12, 16)
    assert native.decoder()["frames"]["pil"] == n + 2
    np.testing.assert_array_equal(out[0], np.asarray(Image.open(p)))
