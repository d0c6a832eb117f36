"""The PyTorch port stands alone and runs where it is told:

- importing it pulls in neither JAX, flax, msgpack, the JAX package nor
  the repository's ``tools``;
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
from deepestscatter_tpu_torch.models.probes import init_light_probe_model, init_probe_renderer_model
from deepestscatter_tpu_torch.models.rpnn import init_disney_model
from deepestscatter_tpu_torch.ops import welford
from deepestscatter_tpu_torch.probes import gather
from deepestscatter_tpu_torch.render import camera as tcam
from deepestscatter_tpu_torch.render import progressive

PKG = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "deepestscatter_tpu", "tools")


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
        "deepestscatter_tpu_torch.probes.gather, deepestscatter_tpu_torch.utils.compare, "
        "deepestscatter_tpu_torch.render.baked, deepestscatter_tpu_torch.models.probes, "
        "deepestscatter_tpu_torch.tasks, deepestscatter_tpu_torch.data.collectors, "
        "deepestscatter_tpu_torch.data.store, deepestscatter_tpu_torch.data.records, "
        "deepestscatter_tpu_torch.data.clouds, deepestscatter_tpu_torch.data.scenesetups, "
        "deepestscatter_tpu_torch.data.vdb, deepestscatter_tpu_torch.data.blosc1, "
        "deepestscatter_tpu_torch.data.datasets, deepestscatter_tpu_torch.train.trainer, "
        "deepestscatter_tpu_torch.train.device_data, deepestscatter_tpu_torch.train.entries, "
        "deepestscatter_tpu_torch.utils.png, deepestscatter_tpu_torch.models.flax_msgpack, "
        "deepestscatter_tpu_torch.render.viewer, deepestscatter_tpu_torch.eval_e2e, "
        "deepestscatter_tpu_torch.__main__\n"
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
            "ops/welford.py", "ops/tonemap.py", "utils/compare.py", "ops/tetra.py",
            "models/probes.py", "render/baked.py", "tasks.py", "data/collectors.py",
            "data/store.py", "data/records.py", "data/clouds.py",
            "data/scenesetups.py", "data/vdb.py", "data/blosc1.py", "data/datasets.py",
            "train/trainer.py", "train/device_data.py", "train/entries.py", "utils/png.py",
            "models/flax_msgpack.py", "render/viewer.py", "eval_e2e.py", "__main__.py"} <= names
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


def test_baked_entry_points_default_to_the_card(no_card):
    cfg, params, static = _cpu_scene()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_light_probe_model(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_probe_renderer_model(0)
    probe_model = init_light_probe_model(0, device="cpu")
    renderer_model = init_probe_renderer_model(0, device="cpu")
    assert next(renderer_model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        port.BakedRenderer(params, static, probe_model, renderer_model)
    origins, directions = tcam.generate_rays(tcam.camera_basis(cfg.camera), 8, 4, "cpu")
    probes = torch.zeros((2, 2, 2, 200), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.render_baked(params, static, renderer_model, probes, origins, directions)


def test_bnn_frame_on_the_cpu_is_finite():
    """A 200 m cloud: a 5 x 5 x 5 probe lattice."""
    cfg = tconfig.SceneConfig(cloud=tconfig.CloudModel(size_m=200.0),
                              camera=tconfig.CameraConfig(width=8, height=4))
    params, static = port.build_scene(cfg, procedural.cumulus(8, seed=1), device="cpu")
    params = port.with_baked_inscatter(params, static, device="cpu")
    renderer = port.BakedRenderer(params, static, init_light_probe_model(0, device="cpu"),
                                  init_probe_renderer_model(1, device="cpu"), device="cpu")
    assert renderer.lattice == (5, 5, 5)
    frame = renderer.render_frame(params, static, 8, 4, tcam.camera_basis(cfg.camera), seed=1)
    assert frame.shape == (4, 8, 3)
    assert np.all(np.isfinite(frame.numpy()))


def test_collect_entry_points_default_to_the_card(no_card, tmp_path):
    from deepestscatter_tpu_torch import tasks
    from deepestscatter_tpu_torch.data import scenesetups

    triplet = scenesetups.generate(str(tmp_path), ["procedural:8:1"], seed=0,
                                   scenes_per_cloud=1)
    setup = triplet.train.table("SceneSetup").get_record(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tasks.scene_from_setup(setup)
    with pytest.raises(RuntimeError, match="CUDA"):
        tasks.collect(triplet.train, "ScatterSample", verbose=False)


def test_train_entry_points_default_to_the_card(no_card, tmp_path):
    from deepestscatter_tpu_torch.data.store import DatasetTriplet
    from deepestscatter_tpu_torch.models.blocks import flax_init
    from deepestscatter_tpu_torch.models.rpnn import DisneyModel
    from deepestscatter_tpu_torch.train import device_data, entries, trainer

    root = str(tmp_path)
    triplet = DatasetTriplet(root)
    for fn in (entries.train_disney, entries.train_baked, entries.train_mimic):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(root)
    for cls in (device_data.DeviceDisneyData, device_data.DeviceBakedData):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(triplet.train)
    with pytest.raises(RuntimeError, match="CUDA"):
        flax_init(DisneyModel(), 0)
    model = flax_init(DisneyModel(), 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.Trainer(name="DisneyModel", model=model, apply_fn=lambda m, b: m(b["z_layers"]),
                        train_batches=lambda e: iter(()), val_batch=lambda: None,
                        config=tconfig.TrainConfig(run_dir=str(tmp_path / "runs")))


def test_entry_points_default_to_the_card(no_card, tmp_path):
    """The user's entry: the render task, the neural weights' loading, the
    viewer, the end-to-end evaluation and the command line (``--device``
    defaults to ``cuda``)."""
    from deepestscatter_tpu_torch import eval_e2e, tasks
    from deepestscatter_tpu_torch.__main__ import main, parser
    from deepestscatter_tpu_torch.render import viewer

    with pytest.raises(RuntimeError, match="CUDA"):
        tasks.render_cloud("procedural:8:1", str(tmp_path), "pt")
    with pytest.raises(RuntimeError, match="CUDA"):
        tasks.load_neural_weights("nn", ":init:")
    cfg, params, static = _cpu_scene()
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.InteractiveSession(cfg, params, static)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_e2e.run_eval(str(tmp_path / "eval"))
    p = parser()
    for argv in (["render", "x"], ["collect", "r", "Result"], ["train-disney", "r"],
                 ["train-baked", "r"], ["eval"]):
        assert p.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["render", "procedural:8:1", "--out", str(tmp_path)])
