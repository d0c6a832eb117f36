"""The PyTorch port stands alone and runs where it is told:

- importing it pulls in neither JAX nor the JAX package;
- no module of it imports them (AST scan);
- its entry points default to the card and raise when there is none,
  instead of running on the CPU;
- a kernel build without a CUDA compiler fails loudly.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deepestscatter_tpu_torch as port
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch import cuda_build
from deepestscatter_tpu_torch.data import procedural
from deepestscatter_tpu_torch.models.rpnn import init_disney_model
from deepestscatter_tpu_torch.ops import welford
from deepestscatter_tpu_torch.probes import gather
from deepestscatter_tpu_torch.render import camera as tcam
from deepestscatter_tpu_torch.render import progressive

PKG = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepestscatter_tpu")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, deepestscatter_tpu_torch, deepestscatter_tpu_torch.render.neural, "
        "deepestscatter_tpu_torch.models.convert, deepestscatter_tpu_torch.render.progressive, "
        "deepestscatter_tpu_torch.probes.gather, deepestscatter_tpu_torch.utils.compare\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG.parent)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=str(PKG.parent), timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    names = {str(f.relative_to(PKG)) for f in files}
    assert {"render/pathtracer.py", "render/progressive.py", "probes/gather.py",
            "ops/welford.py", "ops/tonemap.py", "utils/compare.py"} <= names
    bad = [
        (str(f.relative_to(PKG)), m)
        for f in files
        for m in _imports(f)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_chip_smoke_imports_no_jax():
    smoke = PKG.parent / "chip_smoke.py"
    bad = [m for m in _imports(smoke) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cpu_scene():
    cfg = tconfig.SceneConfig(camera=tconfig.CameraConfig(width=8, height=4))
    params, static = port.build_scene(cfg, procedural.cumulus(8, seed=1), device="cpu")
    return cfg, params, static


def test_build_scene_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        port.build_scene(tconfig.SceneConfig(), procedural.cumulus(8, seed=1))


def test_bake_defaults_to_the_card(no_card):
    _, params, static = _cpu_scene()
    with pytest.raises(RuntimeError, match="CUDA"):
        port.bake(params, static)


def test_render_entry_points_default_to_the_card(no_card):
    cfg, params, static = _cpu_scene()
    model = init_disney_model(0, device="cpu")
    origins, directions = tcam.generate_rays(tcam.camera_basis(cfg.camera), 8, 4, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.render_disney(params, static, model, origins, directions)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.DisneyRenderer(model)


def test_init_disney_model_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        init_disney_model(0)
    assert next(init_disney_model(0, device="cpu").parameters()).device.type == "cpu"


def test_path_tracer_entry_points_default_to_the_card(no_card):
    cfg, params, static = _cpu_scene()
    origins, directions = tcam.generate_rays(tcam.camera_basis(cfg.camera), 8, 4, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.render_subframe(params, static, origins, directions, 0, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.trace_tick_moments(params, static, origins, directions, 0, 0, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.ProgressiveRenderer(cfg, params, static)
    with pytest.raises(RuntimeError, match="CUDA"):
        progressive.init_state(32)
    with pytest.raises(RuntimeError, match="CUDA"):
        welford.Welford.zeros((4,))


def test_probe_entry_points_default_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        gather.make_case("per_lane", 64, 16, 1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        gather.measure("per_lane", 64, 16, 1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        gather.main([])


def test_probe_measures_on_the_card_only():
    """Asked for the CPU, the probe's measurement refuses: its numbers are
    device times."""
    with pytest.raises(RuntimeError, match="card"):
        gather.measure("per_lane", 64, 16, 1024, device="cpu")


def test_path_tracer_on_the_cpu_is_finite():
    cfg, params, static = _cpu_scene()
    params = port.with_baked_inscatter(params, static, device="cpu")
    r = port.ProgressiveRenderer(cfg, params, static, seed=1, device="cpu")
    r.tick()
    hdr = r.hdr_image()
    assert hdr.shape == (4, 8, 3) and np.all(np.isfinite(hdr))
    assert r.display_image().dtype == np.uint8


def test_tensors_on_another_device_are_refused():
    """An entry point told to run on one device refuses a scene that lies
    on another, instead of moving it."""
    _, params, static = _cpu_scene()
    with pytest.raises(ValueError, match="meta"):
        port.bake(params, static, device="meta")


def test_build_without_a_cuda_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(["march"])


def test_frame_on_the_cpu_is_finite():
    cfg, params, static = _cpu_scene()
    params = port.with_baked_inscatter(params, static, device="cpu")
    renderer = port.DisneyRenderer(init_disney_model(0, device="cpu"), device="cpu")
    frame = renderer.render_frame(params, static, 8, 4, tcam.camera_basis(cfg.camera), seed=1)
    assert frame.shape == (4, 8, 3)
    assert np.all(np.isfinite(frame.numpy()))
