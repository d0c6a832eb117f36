"""The port's end-to-end evaluation (``deepestscatter_tpu_torch.eval_e2e``)
against the JAX package's: the seeding of the evaluation's stores bitwise
(``tools/eval_e2e.py::_seed_setups``, ``tools/collect_r05.py::
_top_up_setups``, and ``EVAL_r05.json``'s held-out scene), then
``run_eval`` at the toy scale of ``tests/test_eval_e2e.py`` on the CPU:
finite renders, the report's keys, the trained RPNN closer to the path
tracer than the untrained one, and an existing ground truth read, never
rendered again.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from deepestscatter_tpu.data.store import DatasetTriplet as JDatasetTriplet
from deepestscatter_tpu_torch import eval_e2e
from deepestscatter_tpu_torch.config import (CloudRendering, PointRadianceConfig,
                                             ProgressiveConfig, SceneConfig, TrainConfig)
from deepestscatter_tpu_torch.data.store import DatasetTriplet
from deepestscatter_tpu_torch.utils import compare, exr
from tools import collect_r05 as jcollect_r05
from tools import eval_e2e as jeval_e2e

REPO = Path(__file__).resolve().parent.parent
EVAL_R05 = json.loads((REPO / "EVAL_r05.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _setups(store):
    return store.table("SceneSetup").read(0, store.count("SceneSetup"))


def test_seed_r05_reproduces_the_held_out_scene_bitwise(tmp_path):
    triplet = eval_e2e.seed_r05(str(tmp_path))
    assert triplet.validation.count("SceneSetup") == 4
    assert triplet.train.count("SceneSetup") == 48
    held = EVAL_R05["held_out_scene"]
    setup = triplet.validation.table("SceneSetup").get_record(0)
    assert bytes(setup["cloud_path"]).rstrip(b"\x00").decode() == held["cloud"]
    assert np.float32(held["size_m"]).tobytes() == setup["cloud_size_m"].tobytes()
    assert np.asarray(held["light"], np.float32).tobytes() == setup["light_direction"].tobytes()
    train0 = triplet.train.table("SceneSetup").get_record(0)
    assert bytes(train0["cloud_path"]).rstrip(b"\x00") == b"procedural:64:21"
    assert float(train0["cloud_size_m"]) == pytest.approx(1200.0)
    np.testing.assert_allclose(train0["light_direction"], [0.687099, 0.12905827, -0.71500975],
                               rtol=0, atol=1e-7)
    clouds = {bytes(c).rstrip(b"\x00").decode() for c in _setups(triplet.train)["cloud_path"]}
    assert clouds == set(eval_e2e.R05_TRAIN_CLOUDS)


@pytest.mark.parametrize("name", ["nn", "nn_random", "bnn", "bnn_random"])
def test_rms_of_the_committed_jax_frames_is_eval_r05s(name):
    """The port's ``rms_bias`` of the JAX package's own EVAL_r05 frames,
    committed beside the ground truth the ``eval`` phase reads, gives
    EVAL_r05's values (within 1e-6: the tone maps differ by a few ulps,
    ``test_torch_eval_parity.py``)."""
    renders = REPO / "runs/eval_e2e/renders_512x256"
    pt = exr.read_exr(str(renders / "eval.PT.exr"))
    img = exr.read_exr(str(renders / f"eval.{name.upper()}.exr"))
    assert compare.rms_bias(pt, img) == pytest.approx(EVAL_R05[f"rms_{name}"], abs=1e-6)


def test_seed_r05_equals_the_collect_r05_tool(tmp_path):
    """Record by record, bytes equal to the JAX tool's ``_top_up_setups``
    run as ``tools/collect_r05.py`` runs it; a second call appends nothing."""
    jt = JDatasetTriplet(str(tmp_path / "jax"))
    rng = np.random.default_rng(571)
    jcollect_r05._top_up_setups(jt.validation, [jcollect_r05.VAL_CLOUD],
                                jcollect_r05.VAL_TARGET, rng)
    jcollect_r05._top_up_setups(jt.train, jcollect_r05.TRAIN_CLOUDS,
                                jcollect_r05.TRAIN_TARGET, rng)
    tt = eval_e2e.seed_r05(str(tmp_path / "torch"))
    for name in ("train", "validation"):
        got, ref = _setups(getattr(tt, name)), _setups(getattr(jt, name))
        assert len(got) == len(ref) and got.tobytes() == ref.tobytes()
    eval_e2e.seed_r05(str(tmp_path / "torch"))
    assert tt.train.count("SceneSetup") == jcollect_r05.TRAIN_TARGET


def test_top_up_keeps_existing_records(tmp_path):
    """Topping up from 3 to 7 appends the JAX tool's records after the
    existing ones, cycling the clouds from the current count."""
    jt, tt = JDatasetTriplet(str(tmp_path / "jax")), DatasetTriplet(str(tmp_path / "torch"))
    clouds = ["procedural:16:1", "procedural:16:2"]
    for target, seed in ((3, 1), (7, 2)):
        assert (eval_e2e.top_up_setups(tt.train, clouds, target, np.random.default_rng(seed))
                == jcollect_r05._top_up_setups(jt.train, clouds, target,
                                               np.random.default_rng(seed)))
    assert _setups(tt.train).tobytes() == _setups(jt.train).tobytes()
    assert eval_e2e.top_up_setups(tt.train, clouds, 5, np.random.default_rng(0)) == 0


@pytest.mark.parametrize("scenes_per_cloud, val_scenes", [(2, 2), (16, 4)])
def test_seed_setups_equals_the_eval_tool(tmp_path, scenes_per_cloud, val_scenes):
    args = (("procedural:64:21", "procedural:64:22", "procedural:64:23"), "procedural:64:29",
            scenes_per_cloud, val_scenes, (1200.0, 4000.0), 7)
    jt = jeval_e2e._seed_setups(str(tmp_path / "jax"), *args)
    tt = eval_e2e.seed_setups(str(tmp_path / "torch"), *args)
    for name in ("train", "validation"):
        got, ref = _setups(getattr(tt, name)), _setups(getattr(jt, name))
        assert len(got) == len(ref) and got.tobytes() == ref.tobytes()


#: ``tests/test_eval_e2e.py``'s toy scale with one train cloud, the train
#: store collected (the validation store keeps its setups and no labels, as
#: at EVAL_r05's point) and a short ground-truth render; clouds of 600-800 m
#: (a BNN frame bakes ~12^3 probes, not ~30^3, on the CPU) and 2,048 lanes
#: a radiance update.
TOY = dict(
    train_clouds=("procedural:24:1",),
    val_cloud="procedural:24:9",
    scenes_per_cloud=1,
    val_scenes=1,
    batch_size=64,
    size_range=(600.0, 800.0),
    width=32,
    height=16,
    radiance_cfg=PointRadianceConfig(max_threads=2048, launches_per_update=2, rel_tol=0.5,
                                     abs_tol=0.05, black_min_experiments=16),
    epochs_disney=10,
    epochs_baked=4,
    collect=("train",),
    verbose=False,
    device="cpu",
)
TOY_BASE = SceneConfig(rendering=CloudRendering(sample_step=1.0 / 128.0, max_depth=60),
                       progressive=ProgressiveConfig(min_subframes=20, max_subframes=20))


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_e2e")
    train_cfg = TrainConfig(run_dir=str(root / "runs"), batch_size=16, val_batch_size=32,
                            validate_every=4)
    rep = eval_e2e.run_eval(str(root), base_cfg=TOY_BASE, train_cfg=train_cfg,
                            out_json=str(root / "EVAL_smoke.json"), **TOY)
    return root, train_cfg, rep


def test_report_has_the_eval_r05_keys(report):
    root, _, rep = report
    assert set(EVAL_R05) - {"pt_subframes"} <= set(rep)
    assert rep["device"] == {"name": "cpu", "power_limit": None}
    assert rep["held_out_scene"]["cloud"] == "procedural:24:9"
    assert rep["dataset"]["train_scenes"] == 1 and rep["dataset"]["train_labels"] == 64
    assert rep["dataset"]["val_scenes"] == 1
    assert rep["pt_subframes"] == 20 and 0.05 < rep["pt_mean"] < 50.0
    assert json.loads((root / "EVAL_smoke.json").read_text())["rms_nn"] == rep["rms_nn"]
    for name in ("NN", "NN_RANDOM", "BNN", "BNN_RANDOM"):
        assert (root / "renders_32x16" / f"eval.{name}.exr").exists()
        assert (root / "renders_32x16" / f"eval.{name}.diff.exr").exists()


def test_renders_finite_and_trained_nn_beats_random(report):
    _, _, rep = report
    for name in ("nn", "nn_random", "bnn", "bnn_random"):
        assert rep[f"finite_{name}"] and np.isfinite(rep[f"rms_{name}"])
    assert np.isfinite(rep["val_loss_nn"]) and np.isfinite(rep["val_loss_bnn"])
    assert rep["steps_nn"] > 0 and rep["steps_bnn"] > 0
    assert rep["rms_nn"] < rep["rms_nn_random"]


def test_existing_ground_truth_is_read_not_rendered(report, tmp_path):
    """A second run reuses the exports and ``eval.PT.exr``; a run given
    ``ground_truth=`` reads that file; a missing one raises."""
    root, train_cfg, first = report
    again = eval_e2e.run_eval(str(root), base_cfg=TOY_BASE, train_cfg=train_cfg,
                              **dict(TOY, collect=()))
    assert again["pt_subframes"] == -1 and again["pt_mean"] == first["pt_mean"]
    assert "val_loss_nn" not in again and again["rms_nn"] == first["rms_nn"]
    gt = root / "renders_32x16" / "eval.PT.exr"
    before = gt.read_bytes()
    shutil.copytree(root / "runs", tmp_path / "runs")
    other = eval_e2e.run_eval(str(tmp_path), base_cfg=TOY_BASE, ground_truth=str(gt),
                              **dict(TOY, collect=()))
    assert other["pt_subframes"] == -1 and other["rms_nn"] == first["rms_nn"]
    assert gt.read_bytes() == before and not (tmp_path / "renders_32x16" / "eval.PT.exr").exists()
    with pytest.raises(FileNotFoundError, match="ground truth"):
        eval_e2e.run_eval(str(tmp_path), ground_truth=str(tmp_path / "none.exr"),
                          **dict(TOY, collect=()))
