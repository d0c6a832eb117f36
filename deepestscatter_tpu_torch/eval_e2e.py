"""End-to-end quality evaluation: dataset → training → renders → RMS bias.

The port of the JAX package's ``tools/eval_e2e.py``, on this package's
entry points: the reference's acceptance check
(TR/Utils/GenerateComparisons.py:32-43) tone-maps the path-traced ground
truth and the neural renders with the shared Reinhard operator and reports
the RMS of the difference.

``run_eval`` (every stage resumable):

1. seeds SceneSetups (``seed_setups``: the train clouds into
   ``<root>/Train``, a held-out cloud into ``<root>/Validation``; a store
   that holds setups keeps them);
2. runs the four collector stages on the stores named in ``collect``
   (ScatterSample → Result → DisneyDescriptor → BakedInterpolationSet,
   CONTINUE-resumable, at most ``max_scenes`` a store);
3. trains the RPNN and the baked model with device-resident batches on the
   reference recipe (log-MSE, AMSGrad 1e-3, seed 566), unless their exports
   exist;
4. renders validation setup 0, the held-out scene: the path-traced ground
   truth (read from ``ground_truth`` or ``<renders>/eval.PT.exr`` where it
   exists, rendered and written there otherwise), the NN and BNN frames
   with the trained exports and with untrained weights (``":init:"``);
5. reports the RMS bias of each frame against the ground truth in one JSON
   dict with ``EVAL_r05.json``'s keys and the device that ran it, and
   writes the EXRs and difference images.

``seed_r05`` reproduces the stores of the JAX package's round-5 evaluation
(``tools/collect_r05.py:32-101``), whose validation setup 0 is
``EVAL_r05.json``'s held-out scene.  Run from the repository root:

    python -m deepestscatter_tpu_torch eval --root runs/eval_torch
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import tasks
from .config import CameraConfig, PointRadianceConfig, SceneConfig, TrainConfig
from .data import records
from .data.store import DatasetTriplet, RecordStore
from .device import resolve_device
from .render import camera as camera_ops
from .render.progressive import ProgressiveRenderer
from .train import entries
from .utils import compare, exr

STAGES = ("ScatterSample", "Result", "DisneyDescriptor", "BakedInterpolationSet")
SIZE_RANGE = (1200.0, 4000.0)
#: The round-5 stores (``tools/collect_r05.py:32-37, 87-91``).
R05_TRAIN_CLOUDS = tuple(f"procedural:64:{s}" for s in range(21, 29))
R05_VAL_CLOUD = "procedural:64:29"
R05_TRAIN_TARGET = 48
R05_VAL_TARGET = 4
R05_SEED = 571


def _draw_setup(rng: np.random.Generator, cloud: str, size_range) -> tuple:
    """One SceneSetup: a log-uniform size snapped to a 4-point geometric
    ladder (each distinct size is a scene build), then a light uniform on
    the sphere, drawn in that order and computed in float64."""
    ladder = np.geomspace(size_range[0], size_range[1], 4)
    lo, hi = np.log(size_range[0]), np.log(size_range[1])
    size = float(np.exp(rng.uniform(lo, hi)))
    size = float(ladder[np.argmin(np.abs(ladder - size))])
    phi = rng.uniform(0.0, 2.0 * np.pi)
    cos_t = rng.uniform(-1.0, 1.0)
    sin_t = np.sqrt(1.0 - cos_t**2)
    light = np.asarray([np.cos(phi) * sin_t, np.sin(phi) * sin_t, cos_t], np.float32)
    return cloud.encode()[: records.CLOUD_PATH_LEN], size, light


def seed_setups(root: str, train_clouds: Sequence[str], val_cloud: str, scenes_per_cloud: int,
                val_scenes: int, size_range=SIZE_RANGE, seed: int = 7) -> DatasetTriplet:
    """SceneSetups with a held-out split (the evaluation cloud never in
    Train), one rng of ``seed`` for the train store then the validation
    store; a store that holds setups is left as it is."""
    rng = np.random.default_rng(seed)
    triplet = DatasetTriplet(root)

    def make(clouds, n_each):
        out = np.zeros(len(clouds) * n_each, records.SCENE_SETUP)
        for i, cloud in enumerate(c for c in clouds for _ in range(n_each)):
            out[i] = _draw_setup(rng, cloud, size_range)
        return out

    if triplet.train.count("SceneSetup") == 0:
        triplet.train.table("SceneSetup").batch_append(0, make(train_clouds, scenes_per_cloud))
    if triplet.validation.count("SceneSetup") == 0:
        triplet.validation.table("SceneSetup").batch_append(0, make([val_cloud], val_scenes))
    return triplet


def top_up_setups(store: RecordStore, clouds: Sequence[str], target: int,
                  rng: np.random.Generator, size_range=SIZE_RANGE) -> int:
    """Append SceneSetups up to ``target`` (existing records, which own
    their sample slices, untouched), cycling ``clouds`` from the current
    count; returns the number appended."""
    tbl = store.table("SceneSetup")
    have = tbl.count()
    if have >= target:
        return 0
    out = np.zeros(target - have, records.SCENE_SETUP)
    for i in range(target - have):
        out[i] = _draw_setup(rng, clouds[(have + i) % len(clouds)], size_range)
    tbl.batch_append(have, out)
    return target - have


def seed_r05(root: str) -> DatasetTriplet:
    """The round-5 stores: one rng of seed 571 tops up the validation store
    to 4 setups of ``procedural:64:29``, then the train store to 48 over
    ``procedural:64:21..28``."""
    triplet = DatasetTriplet(root)
    rng = np.random.default_rng(R05_SEED)
    top_up_setups(triplet.validation, [R05_VAL_CLOUD], R05_VAL_TARGET, rng)
    top_up_setups(triplet.train, list(R05_TRAIN_CLOUDS), R05_TRAIN_TARGET, rng)
    return triplet


def device_info(dev: torch.device) -> Dict[str, Optional[str]]:
    """The device a report was measured on: the card's name and power limit
    (``nvidia-smi``; None where it cannot be read), or the CPU."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    index = dev.index or 0
    return {"name": torch.cuda.get_device_name(index),
            "power_limit": out[index].split(",")[-1].strip() if len(out) > index else None}


def run_eval(
    root: str,
    train_clouds: Sequence[str] = ("procedural:64:21", "procedural:64:22", "procedural:64:23"),
    val_cloud: str = "procedural:64:29",
    scenes_per_cloud: int = 2,
    val_scenes: int = 2,
    batch_size: int = 2048,
    size_range: Tuple[float, float] = SIZE_RANGE,
    width: int = 256,
    height: int = 128,
    base_cfg: Optional[SceneConfig] = None,
    radiance_cfg: Optional[PointRadianceConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    epochs_disney: int = 50,
    epochs_baked: int = 30,
    render_seed: int = 3,
    seed: int = 7,
    out_json: Optional[str] = None,
    skip_baked: bool = False,
    verbose: bool = True,
    run_name: str = "runs",
    collect: Sequence[str] = ("train", "validation"),
    max_scenes: Optional[int] = None,
    ground_truth: Optional[str] = None,
    device="cuda",
) -> Dict:
    """The whole evaluation on ``device`` (see the module docstring);
    returns the report.  ``collect`` names the stores to collect (``()``
    trains on what is stored); ``ground_truth`` names an existing
    path-traced EXR of the held-out scene to read, which is never
    re-rendered or written."""
    dev = resolve_device(device)
    t_start = time.time()
    timings: Dict[str, float] = {}
    # Black points' confirmation budget capped at 20k experiments
    # (reference: 100k, RadianceCollector.cpp:117): it only limits how long
    # the collector keeps confirming an exact zero.
    base_cfg = dataclasses.replace(base_cfg or tasks.eval_base(),
                                   camera=CameraConfig(width=width, height=height))
    radiance_cfg = radiance_cfg or PointRadianceConfig(black_min_experiments=20_000)
    run_dir = os.path.join(root, run_name)
    train_cfg = train_cfg or TrainConfig(run_dir=run_dir,
                                         val_batch_size=min(4096, val_scenes * batch_size))
    if ground_truth is not None and not os.path.exists(ground_truth):
        raise FileNotFoundError(f"the ground truth {ground_truth} does not exist")

    # -- 1. scene setups ------------------------------------------------------
    triplet = seed_setups(root, train_clouds, val_cloud, scenes_per_cloud, val_scenes,
                          size_range, seed)
    stores = {"train": triplet.train, "validation": triplet.validation}

    # -- 2. the four collector stages -----------------------------------------
    t0 = time.time()
    for name in collect:
        for stage in STAGES:
            t1 = time.time()
            n = tasks.collect(stores[name], stage, tasks.CollectMode.CONTINUE, base=base_cfg,
                              radiance_cfg=radiance_cfg, batch_size=batch_size,
                              max_scenes=max_scenes, verbose=verbose, device=dev)
            timings[f"collect_{name}_{stage}_s"] = time.time() - t1
            if verbose and n:
                print(f"[eval] {name}/{stage}: {n} scenes ({time.time() - t1:.1f}s)", flush=True)
    timings["collect_s"] = time.time() - t0

    # -- 3. training ----------------------------------------------------------
    results: Dict = {}
    for key, entry, export, epochs in (
            ("nn", entries.train_disney, "DisneyModel/DisneyModel.pt", epochs_disney),
            ("bnn", entries.train_baked, "BakedModel/LightProbeModel.pt", epochs_baked)):
        t0 = time.time()
        if not (key == "bnn" and skip_baked) and not os.path.exists(os.path.join(run_dir, export)):
            t = entry(root, config=train_cfg, epochs=epochs, device_resident=True, device=dev)
            results[f"val_loss_{key}"] = t.best_val
            results[f"steps_{key}"] = t.step
        timings[f"train_{key}_s"] = time.time() - t0

    # -- 4. renders of the held-out scene -------------------------------------
    setup = triplet.validation.table("SceneSetup").get_record(0)
    cfg, params, static = tasks.scene_from_setup(setup, base_cfg, device=dev)
    basis = camera_ops.camera_basis(cfg.camera)
    img_dir = os.path.join(root, "renders" if (width, height) == (256, 128)
                           else f"renders_{width}x{height}")
    os.makedirs(img_dir, exist_ok=True)
    pt_path = ground_truth or os.path.join(img_dir, "eval.PT.exr")
    t0 = time.time()
    if os.path.exists(pt_path):
        pt = exr.read_exr(pt_path)
        results["pt_subframes"] = -1  # read from disk
    else:
        prog = ProgressiveRenderer(cfg, params, static, seed=render_seed, device=dev)
        pt = prog.run(verbose=verbose)
        results["pt_subframes"] = int(prog.state.subframe_id)
        exr.write_exr(pt_path, pt)
    timings["render_pt_s"] = time.time() - t0
    results["pt_mean"] = float(pt.mean())

    renders = {"nn": run_dir, "nn_random": ":init:"}
    if not skip_baked:
        renders.update(bnn=run_dir, bnn_random=":init:")
    for name, models_dir in renders.items():
        t0 = time.time()
        kind = name.split("_")[0]
        weights = tasks.load_neural_weights(kind, models_dir, dev)
        frames = tasks.build_neural_renderer(kind, weights, params, static, dev)
        img = frames.render_frame(params, static, width, height, basis,
                                  seed=render_seed).cpu().numpy()
        timings[f"render_{name}_s"] = time.time() - t0
        exr.write_exr(os.path.join(img_dir, f"eval.{name.upper()}.exr"), img)
        exr.write_exr(os.path.join(img_dir, f"eval.{name.upper()}.diff.exr"),
                      compare.diff_image(pt, img))
        results[f"rms_{name}"] = compare.rms_bias(pt, img)
        results[f"finite_{name}"] = bool(np.isfinite(img).all())
        results[f"mean_{name}"] = float(img.mean())
        if verbose:
            print(f"[eval] rms_{name} = {results[f'rms_{name}']:.5f}", flush=True)

    timings["total_s"] = time.time() - t_start
    counts = {t: triplet.train.count(t) for t in ("ScatterSample", "Result", "DisneyDescriptor")}
    converged = triplet.train.table("Result").read(0, counts["Result"])["is_converged"]
    report = {
        "metric": "rms_bias_vs_pt_toneMapped",
        "reference": "GenerateComparisons.py:32-43",
        "held_out_scene": {
            "cloud": bytes(setup["cloud_path"]).rstrip(b"\x00").decode(),
            "size_m": float(setup["cloud_size_m"]),
            "light": [float(x) for x in setup["light_direction"]],
        },
        "dataset": {
            "train_scenes_seeded": triplet.train.count("SceneSetup"),
            "train_scenes": min(counts.values()) // batch_size,
            "train_labels": min(counts["ScatterSample"], counts["Result"]),
            "train_labels_converged": int(converged.astype(bool).sum()),
            "val_scenes": triplet.validation.count("SceneSetup"),
            "samples_per_scene": batch_size,
        },
        "label_generation": {
            "rr_start_depth": base_cfg.rendering.rr_start_depth,
            "rr_survival": base_cfg.rendering.rr_survival,
            "black_min_experiments": radiance_cfg.black_min_experiments,
            "rel_tol": radiance_cfg.rel_tol,
            "abs_tol": radiance_cfg.abs_tol,
        },
        "resolution": [width, height],
        **results,
        "timings": timings,
        "device": device_info(dev),
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(report, f, indent=1)
    if verbose:
        print(json.dumps(report), flush=True)
    return report


def run_r05(root: str, train_seed: int = 566, collect: bool = True,
            ground_truth: Optional[str] = None, verbose: bool = False, device="cuda") -> Dict:
    """``EVAL_r05.json``'s operating point (``tools/final_r05.sh:16-18``):
    the round-5 stores (``seed_r05``), the four stages on train scene 0 only
    (2,048 samples; the validation store keeps its setups and no labels, so
    training validates on the train store), 200 RPNN and 100 baked epochs on
    the default recipe with ``train_seed``, the frames of the held-out scene
    at 512 x 256, seed 3.  Each training seed has its own run directory
    (``runs_seed<seed>``); ``collect=False`` trains on what is stored."""
    seed_r05(root)
    run_name = f"runs_seed{train_seed}"
    return run_eval(root, width=512, height=256, epochs_disney=200, epochs_baked=100,
                    train_cfg=TrainConfig(run_dir=os.path.join(root, run_name), seed=train_seed),
                    run_name=run_name, collect=("train",) if collect else (), max_scenes=1,
                    ground_truth=ground_truth, verbose=verbose, device=device)
