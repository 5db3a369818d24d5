"""Rules of the port that hold on any host.

- No module of din_tpu_torch and no line of chip_smoke.py imports JAX, flax,
  optax or the din_tpu package: the card's machine has no JAX, so the port
  keeps its own copy of what it needs (an AST scan, plus a fresh interpreter
  that imports every module and then finds none of them loaded).
- The CUDA sources include no PyTorch header: they build with plain nvcc in
  seconds and bind through ctypes.
- Entry points run on the card: with no CUDA they raise unless the caller
  passes device="cpu".
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "din_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "din_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_and_smoke_import_no_jax_or_din_tpu():
    files = _port_files()
    assert len(files) > 10 and (REPO / "chip_smoke.py").exists()
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_importing_every_port_module_loads_no_jax():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in PORT.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_sources_include_no_torch_headers():
    srcs = sorted((PORT / "csrc").glob("*.cu*"))
    assert {p.name for p in srcs} >= {"max_pool_2x2.cu", "roi_align.cu"}
    for p in srcs:
        for line in p.read_text().splitlines():
            if line.strip().startswith("#include"):
                assert "torch" not in line and "ATen" not in line, \
                    f"{p.name}: {line}"


def _tiny_cfg():
    from din_tpu_torch.experiments.presets import PRESETS

    return PRESETS["volleyball_stage2_dynamic"]().replace(
        image_size=(64, 64), out_size=(2, 2), num_frames=2, num_boxes=2,
        num_features_boxes=16, lite_dim=8, compute_dtype="float32")


@pytest.mark.parametrize("entry",
                         ["build_model", "Predictor", "main", "profile"])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry, monkeypatch):
    from din_tpu_torch.experiments import predict, profile_serving
    from din_tpu_torch.models.registry import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "build_model":
            build_model(cfg)
        elif entry == "Predictor":
            predict.Predictor(cfg, model)
        elif entry == "main":
            predict.main(["--batch", "1"])
        else:
            profile_serving.main(["--requests", "1"])
    assert next(model.parameters()).device.type == "cpu"
    if entry == "Predictor":
        p = predict.Predictor(cfg, model, device="cpu")
        assert p.device.type == "cpu"


def test_unported_models_name_their_roadmap_slice():
    from din_tpu_torch.models.registry import build_model

    cfg = _tiny_cfg()
    for name in ("dynamic_collective", "higcin_volleyball"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_model(cfg.replace(inference_module_name=name),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(cfg.replace(backbone="res18"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(cfg.replace(hierarchical_inference=True), device="cpu")
