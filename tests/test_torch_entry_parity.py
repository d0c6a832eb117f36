"""The port's user entry against the JAX package's, on the CPU: the reader of
the JAX trainer's ``.params.msgpack`` exports (``models/flax_msgpack.py``),
the render tasks (``tasks.load_neural_weights``, ``render_cloud``), the
command line (``python -m deepestscatter_tpu_torch``), the PNG writer and
the interactive viewer.

Stated tolerances: the reader decodes flax's bytes bitwise (every leaf's
dtype, shape and bits) and agrees with ``msgpack.unpackb`` exactly; frames
rendered from the same export agree with the JAX package's to rtol 1e-3
(atol 1e-6 of the largest value) on every pixel, the slice parity tests'
tolerance (``test_torch_slice_parity.py``, ``test_torch_baked_parity.py``:
there differences are allowed only where a scatter flag flipped, on at
most 0.5 % of pixels, none of 128 here); the PNG writer and the arcball
bitwise.
"""

import functools
import json
import os
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from deepestscatter_tpu import tasks as jtasks
from deepestscatter_tpu.config import CameraConfig as JCameraConfig
from deepestscatter_tpu.config import CloudRendering as JCloudRendering
from deepestscatter_tpu.config import SceneConfig as JSceneConfig
from deepestscatter_tpu.config import TrainConfig as JTrainConfig
from deepestscatter_tpu.models.probes import LightProbeModel as JLightProbeModel
from deepestscatter_tpu.models.probes import ProbeRendererModel as JProbeRendererModel
from deepestscatter_tpu.models.rpnn import DisneyModel as JDisneyModel
from deepestscatter_tpu.render import viewer as jviewer
from deepestscatter_tpu.train import entries as jentries
from deepestscatter_tpu.train import trainer as jtrainer
from deepestscatter_tpu.utils import exr as jexr
from deepestscatter_tpu.utils import png as jpng
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch import scene as tscene
from deepestscatter_tpu_torch import tasks
from deepestscatter_tpu_torch.__main__ import main as cli_main
from deepestscatter_tpu_torch.data import procedural
from deepestscatter_tpu_torch.data.store import DatasetTriplet
from deepestscatter_tpu_torch.models import flax_msgpack
from deepestscatter_tpu_torch.render import viewer
from deepestscatter_tpu_torch.train import trainer as ttrainer
from deepestscatter_tpu_torch.utils import exr, png

W, H = 16, 8
CLOUD = "procedural:16:3"
SIZE_M = 800.0
#: A short march (step 1/128, at most 60 bounces) keeps the CPU's plain
#: lockstep loops short; the entry points' behaviour does not depend on it.
SHORT = dict(sample_step=1.0 / 128.0, max_depth=60)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _init(model, *shapes):
    return model.init(jax.random.PRNGKey(566), *(jnp.zeros(s) for s in shapes))


# -- the msgpack reader --------------------------------------------------------

FLAX_MODELS = {
    "DisneyModel": lambda: _init(JDisneyModel(), (1, 10, 226)),
    "LightProbeModel": lambda: _init(JLightProbeModel(), (1, 9, 225)),
    "ProbeRendererModel": lambda: _init(JProbeRendererModel(), (1, 202), (1, 3, 226)),
}


def _assert_trees_bitwise(got, ref):
    assert isinstance(got, dict) and got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_bitwise(got[k], ref[k])
        else:
            r = np.asarray(ref[k])
            assert isinstance(got[k], np.ndarray) and got[k].flags.writeable
            assert got[k].dtype == r.dtype and got[k].shape == r.shape
            assert got[k].tobytes() == r.tobytes()


@pytest.mark.parametrize("name", sorted(FLAX_MODELS))
def test_reader_decodes_flax_init_trees_bitwise(name):
    variables = FLAX_MODELS[name]()
    data = serialization.to_bytes(variables)
    _assert_trees_bitwise(flax_msgpack.decode_flax(data), serialization.msgpack_restore(data))


_leaves = (st.none() | st.booleans()
           | st.integers(min_value=-(2**63), max_value=2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300))
_values = st.recursive(_leaves, lambda inner: st.lists(inner, max_size=20)
                       | st.dictionaries(st.text(max_size=8), inner, max_size=20),
                       max_leaves=60)


@settings(max_examples=300, deadline=None, database=None)
@given(value=_values, single=st.booleans())
def test_reader_agrees_with_msgpack(value, single):
    data = msgpack.packb(value, use_bin_type=True, use_single_float=single)
    assert flax_msgpack.unpackb(data) == msgpack.unpackb(data, raw=False)


@settings(max_examples=100, deadline=None, database=None)
@given(shape=st.lists(st.integers(0, 5), max_size=3),
       dtype=st.sampled_from(["int8", "uint8", "int16", "int32", "int64", "float16",
                              "float32", "float64", "bool"]),
       scalar=st.booleans())
def test_reader_decodes_flax_leaves(shape, dtype, scalar):
    """Arrays of every size flax packs into fixext16, ext8 and ext16, and
    numpy scalars."""
    rng = np.random.default_rng(len(shape))
    arr = np.asarray(rng.random(shape) * 100).astype(dtype)
    leaf = arr.flatten()[:1].reshape(()).astype(dtype)[()] if scalar and arr.size else arr
    data = serialization.to_bytes({"leaf": leaf, "n": {"x": arr}})
    got, ref = flax_msgpack.decode_flax(data), serialization.msgpack_restore(data)
    assert type(got["leaf"]) is type(ref["leaf"])
    assert np.asarray(got["leaf"]).tobytes() == np.asarray(ref["leaf"]).tobytes()
    _assert_trees_bitwise(got["n"], ref["n"])


@pytest.mark.parametrize("n", [15, 16, 255, 256, 65535, 65536])
def test_reader_wide_lengths(n):
    """Every width of str, bin, array and map: big-endian lengths."""
    value = {"s": "x" * n, "b": b"\x07" * n, "a": list(range(n)),
             "m": {str(i): -i for i in range(n)}}
    data = msgpack.packb(value, use_bin_type=True)
    assert flax_msgpack.unpackb(data) == value


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 3, 255, 256, 65536])
def test_reader_refuses_other_ext_codes(n):
    """fixext1-16 and ext8/16/32 parse; an ext code flax does not write for
    arrays is refused, and so is an ext where none may stand."""
    data = msgpack.packb({"w": msgpack.ExtType(2, b"\x01" * n)}, use_bin_type=True)
    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.decode_flax(data)
    with pytest.raises(ValueError, match="no ext type is expected"):
        flax_msgpack.unpackb(data)


def test_reader_refuses_chunked_and_bfloat16_leaves(tmp_path):
    chunked = msgpack.packb({"params": {"w": {"__msgpack_chunked_array__": True,
                                              "shape": [2]}}}, use_bin_type=True)
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.decode_flax(chunked)
    bf16 = serialization.to_bytes({"w": jnp.zeros((2,), jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        flax_msgpack.decode_flax(bf16)
    with pytest.raises(ValueError, match="ends at byte"):
        flax_msgpack.unpackb(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError, match="after the value"):
        flax_msgpack.unpackb(msgpack.packb(1) + b"\x00")


# -- the render tasks on the JAX trainer's exports -----------------------------


@pytest.fixture(scope="module")
def jax_exports(tmp_path_factory):
    """The JAX trainers' own exports of freshly initialized parameters (seed
    5): ``Trainer.export`` (``DisneyModel.params.msgpack``) and
    ``train_baked``'s ``export_params`` (the split BNN files), through the
    entry points with the epoch loop replaced by the export."""
    root = tmp_path_factory.mktemp("jax_exports")
    cfg = JTrainConfig(run_dir=str(root / "runs"), seed=5)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer.Trainer, "run", lambda self, epochs=None: self.export())
    try:
        jentries.train_disney(str(root / "data"), config=cfg)
        jentries.train_baked(str(root / "data"), config=cfg)
    finally:
        mp.undo()
    return root / "runs"


def test_exports_are_the_jax_trainers(jax_exports):
    names = {p.name for p in jax_exports.rglob("*.params.msgpack")}
    assert names == {"DisneyModel.params.msgpack", "LightProbeModel.params.msgpack",
                     "ProbeRendererModel.params.msgpack", "BakedModel.params.msgpack"}


def _base(cfg_cls, cam_cls, rend_cls):
    return cfg_cls(rendering=rend_cls(march_dtype="uint8", **SHORT),
                   camera=cam_cls(width=W, height=H))


def _render_pair(kind, models_dir, out):
    kwargs = dict(renderer=kind, size_m=SIZE_M, directions=("Side",), verbose=False,
                  models_dir=str(models_dir))
    (jpath,) = jtasks.render_cloud(
        CLOUD, str(out / "jax"), base=_base(JSceneConfig, JCameraConfig, JCloudRendering),
        **kwargs)
    (tpath,) = tasks.render_cloud(
        CLOUD, str(out / "torch"), base=_base(tconfig.SceneConfig, tconfig.CameraConfig,
                                              tconfig.CloudRendering), device="cpu", **kwargs)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    return jexr.read_exr(jpath), exr.read_exr(tpath)


@pytest.mark.parametrize("kind", ["nn", "bnn"])
def test_render_cloud_from_jax_exports_matches_jax(jax_exports, kind, tmp_path):
    ref, got = _render_pair(kind, jax_exports, tmp_path)
    assert got.shape == ref.shape == (H, W, 3) and np.all(np.isfinite(got))
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6 * np.abs(ref).max())


def test_loaded_weights_equal_the_export(jax_exports):
    """Every converted parameter equals the JAX leaf bitwise (transposed)."""
    weights = tasks.load_neural_weights("bnn", str(jax_exports), device="cpu")
    ref = serialization.msgpack_restore(
        (jax_exports / "BakedModel" / "ProbeRendererModel.params.msgpack").read_bytes())
    got = weights["ProbeRendererModel"].state_dict()
    np.testing.assert_array_equal(got["input_fc.weight"].numpy(),
                                  np.asarray(ref["params"]["input_fc"]["kernel"]).T)
    np.testing.assert_array_equal(got["blocks.2.f2.bias"].numpy(),
                                  np.asarray(ref["params"]["block_2"]["f2"]["bias"]))


def test_port_exports_take_precedence(jax_exports, tmp_path):
    """In one directory ``<Model>.pt`` wins over ``<Model>.params.msgpack``;
    the model directory itself is searched before its trainer subdirectory."""
    d = tmp_path / "models"
    d.mkdir()
    (d / "DisneyModel.params.msgpack").write_bytes(
        (jax_exports / "DisneyModel" / "DisneyModel.params.msgpack").read_bytes())
    from_msgpack = tasks.load_neural_weights("nn", str(d), device="cpu")["DisneyModel"]
    pt_model = tasks.load_neural_weights("nn", ":init:", device="cpu")["DisneyModel"]
    ttrainer.save_state(str(d / "DisneyModel.pt"), ttrainer.cpu_state_dict(pt_model))
    got = tasks.load_neural_weights("nn", str(d), device="cpu")["DisneyModel"]
    assert torch.equal(ttrainer.flat_params(got), ttrainer.flat_params(pt_model))
    assert not torch.equal(ttrainer.flat_params(got), ttrainer.flat_params(from_msgpack))
    sub = tmp_path / "runs" / "DisneyModel"
    sub.mkdir(parents=True)
    (sub / "DisneyModel.pt").write_bytes((d / "DisneyModel.pt").read_bytes())
    got = tasks.load_neural_weights("nn", str(tmp_path / "runs"), device="cpu")["DisneyModel"]
    assert torch.equal(ttrainer.flat_params(got), ttrainer.flat_params(pt_model))


@pytest.mark.parametrize("kind", ["nn", "bnn"])
def test_missing_export_raises_with_guidance(kind, tmp_path):
    with pytest.raises(FileNotFoundError, match="train first .*deepestscatter_tpu_torch"):
        tasks.load_neural_weights(kind, str(tmp_path / "nothere"), device="cpu")


def test_unknown_renderer_raises():
    with pytest.raises(ValueError, match="unknown neural renderer"):
        tasks.load_neural_weights("xx", ":init:", device="cpu")


# -- the command line -----------------------------------------------------------


def _render_args(out, renderer, extra=()):
    return ["render", CLOUD, "--out", str(out), "--renderer", renderer, "--size-m",
            str(SIZE_M), "--width", str(W), "--height", str(H), "--directions", "Side",
            "--max-subframes", "2", "--device", "cpu", *extra]


@pytest.fixture
def short_scenes(monkeypatch):
    """The command line's scenes with the short march."""
    monkeypatch.setattr(tconfig, "SceneConfig", functools.partial(
        tconfig.SceneConfig, rendering=tconfig.CloudRendering(**SHORT)))


@pytest.mark.parametrize("renderer, extra", [("pt", ()), ("nn", ("--models-dir", ":init:")),
                                             ("bnn", ("--models-dir", ":init:"))])
def test_cli_render(tmp_path, renderer, extra, short_scenes):
    assert cli_main(_render_args(tmp_path, renderer, extra)) == 0
    img = exr.read_exr(str(tmp_path / f"procedural_16_3.Side.{renderer.upper()}.exr"))
    assert img.shape == (H, W, 3) and np.all(np.isfinite(img))


def test_cli_render_missing_models(tmp_path):
    with pytest.raises(FileNotFoundError, match="train first"):
        cli_main(_render_args(tmp_path, "nn", ("--models-dir", str(tmp_path / "nothere"))))


def test_cli_compare(tmp_path, capsys):
    img = np.abs(np.random.default_rng(0).normal(size=(8, 8, 3))).astype(np.float32)
    a, b = str(tmp_path / "x.Side.PT.exr"), str(tmp_path / "x.Side.NN.exr")
    exr.write_exr(a, img)
    exr.write_exr(b, img * 1.05)
    assert cli_main(["compare", a, b, "--out", str(tmp_path / "d")]) == 0
    result = json.loads(capsys.readouterr().out)
    assert list(result) == ["x.Side.NN.exr"] and result["x.Side.NN.exr"] > 0
    assert (tmp_path / "d" / "x.Side.NN.diff.exr").exists()


#: The collection at the toy scale of ``tests/test_eval_e2e.py``, with
#: 2,048 lanes an update (the CPU's plain loop runs fewer, larger updates
#: faster).
TINY_BASE = tconfig.SceneConfig(rendering=tconfig.CloudRendering(**SHORT))
TINY_RADIANCE = tconfig.PointRadianceConfig(max_threads=2048, launches_per_update=2,
                                            rel_tol=0.5, abs_tol=0.05, black_min_experiments=16)


def test_cli_setups_collect_and_train(tmp_path, monkeypatch, capsys, short_scenes):
    """``setups``, the four ``collect`` stages and both ``train-*`` commands
    on the CPU, the collection at toy settings (64 samples a scene) and the
    training on a toy batch; the trainers' exports then render."""
    real = tasks.collect
    monkeypatch.setattr(tasks, "collect", functools.partial(
        real, base=TINY_BASE, radiance_cfg=TINY_RADIANCE, batch_size=64, verbose=False))
    monkeypatch.setattr(tconfig, "TrainConfig", functools.partial(
        tconfig.TrainConfig, batch_size=16, val_batch_size=32, validate_every=2))
    root = tmp_path / "data"
    assert cli_main(["setups", str(root), "--clouds", "procedural:16:1", "--seed", "1",
                     "--scenes-per-cloud", "1"]) == 0
    assert "seeded 1 clouds" in capsys.readouterr().out
    for stage in ("ScatterSample", "Result", "DisneyDescriptor", "BakedInterpolationSet"):
        assert cli_main(["collect", str(root), stage, "--device", "cpu"]) == 0
        assert "processed 1 scenes" in capsys.readouterr().out
    train = DatasetTriplet(str(root)).train
    assert all(train.count(t) == 64 for t in ("ScatterSample", "Result", "DisneyDescriptor",
                                              "BakedInterpolationSet"))
    runs = tmp_path / "runs"
    for cmd in ("train-disney", "train-baked"):
        assert cli_main([cmd, str(root), "--epochs", "2", "--run-dir", str(runs),
                         "--device", "cpu"]) == 0
    assert {p.name for p in runs.rglob("*.pt")} >= {
        "DisneyModel.pt", "LightProbeModel.pt", "ProbeRendererModel.pt"}
    for renderer in ("nn", "bnn"):
        assert cli_main(_render_args(tmp_path / "out", renderer,
                                     ("--models-dir", str(runs)))) == 0
        img = exr.read_exr(str(tmp_path / "out" / f"procedural_16_3.Side.{renderer.upper()}.exr"))
        assert np.all(np.isfinite(img))


# -- PNG and the viewer ------------------------------------------------------------


def test_png_bytes_equal_the_jax_packages(tmp_path):
    rgb = np.random.default_rng(3).integers(0, 256, (7, 11, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "a.png"), rgb)
    jpng.write_png(str(tmp_path / "b.png"), rgb)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "c.png"), rgb.astype(np.float32))


@pytest.mark.parametrize("drag", [(0.1, 0.2, 0.1, 0.2), (0.0, 0.0, 0.3, 0.1),
                                  (-0.9, 0.8, 0.7, -0.95), (0.5, 0.5, -1.5, 2.0)])
def test_arcball_bitwise(drag):
    got = viewer.arcball_rotation(*drag)
    ref = jviewer.arcball_rotation(*drag)
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


@pytest.fixture(scope="module")
def session():
    cfg = tconfig.SceneConfig(cloud=tconfig.CloudModel(size_m=1000.0),
                              camera=tconfig.CameraConfig(width=W, height=H),
                              rendering=tconfig.CloudRendering(**SHORT))
    params, static = tscene.build_scene(cfg, procedural.cumulus(resolution=16, seed=9),
                                        device="cpu")
    return viewer.InteractiveSession(cfg, params, static, seed=2, device="cpu")


def test_viewer_arcball_identity_and_orthonormal():
    np.testing.assert_allclose(viewer.arcball_rotation(0.1, 0.2, 0.1, 0.2), np.eye(3),
                               atol=1e-6)
    r = viewer.arcball_rotation(0.0, 0.0, 0.3, 0.1)
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    assert np.linalg.det(r) == pytest.approx(1.0, abs=1e-5)


def test_viewer_tick_pause_exposure(session):
    frame = session.tick()
    assert frame.shape == (H, W, 3) and frame.dtype == np.uint8
    assert session.subframes == 10 and session.ms_per_frame > 0
    session.toggle_pause()
    session.tick()
    assert session.subframes == 10  # paused: no new subframes
    session.toggle_pause()
    e0 = session.exposure
    assert session.adjust_exposure(1.2) == pytest.approx(e0 * 1.2)


def test_viewer_drag_resets_accumulation(session):
    session.tick()
    before = session.renderer.directions.clone()
    session.drag(0.0, 0.0, 0.4, 0.0)
    assert session.subframes == 0  # reset
    assert not torch.allclose(before, session.renderer.directions)


def test_viewer_snapshots(session, tmp_path):
    session.tick()
    path = os.path.join(tmp_path, "frame.png")
    session.snapshot(path)
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    idat = raw.index(b"IDAT") + 4
    length = int.from_bytes(raw[idat - 8: idat - 4], "big")
    rows = np.frombuffer(zlib.decompress(raw[idat: idat + length]), np.uint8)
    rows = rows.reshape(H, 1 + W * 3)[:, 1:]
    np.testing.assert_array_equal(rows.reshape(H, W, 3), session.display_image())
    session.snapshot(os.path.join(tmp_path, "frame.exr"))
    np.testing.assert_array_equal(exr.read_exr(os.path.join(tmp_path, "frame.exr")),
                                  session.renderer.hdr_image())
