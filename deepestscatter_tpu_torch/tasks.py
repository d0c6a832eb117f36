"""Task orchestration: the dataset collection over a record store.

The port of ``deepestscatter_tpu.tasks``' collection task (reference:
Tasks.h, Tasks.cpp): ``collect`` runs one stage of the four-stage
pipeline (ScatterSample, then Result, DisneyDescriptor and
BakedInterpolationSet, each reading the samples) over every SceneSetup of
a store.  Scene i owns the sample ids [i * batch, (i + 1) * batch), its
stream seed is i, and CONTINUE resumes at ``count // batch``
(Tasks.h:59-68, Tasks.cpp:137).  ``eval_scene`` sets up the held-out scene
of the end-to-end evaluation (``tools/eval_e2e.py``).  The render tasks are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .config import (BatchSettings, CameraConfig, CloudRendering, PointRadianceConfig,
                     SceneConfig)
from .data import clouds as clouds_mod
from .data import collectors, records
from .data.store import RecordStore
from .device import resolve_device
from .render import inscatter
from .scene import build_scene


class CollectMode(enum.Enum):
    OVERWRITE = "overwrite"
    CONTINUE = "continue"  # resume from count // batch_size (Tasks.h:59-68)


def production_base() -> SceneConfig:
    """The collection tasks' scene settings: uint8 textures (the
    reference's storage of density and sun transmittance, Resources.cpp:
    93-96, inScatter.cu:65), step 1/512, max_depth 2000."""
    return SceneConfig(rendering=CloudRendering(march_dtype="uint8"))


def scene_from_setup(setup: np.void, base: Optional[SceneConfig] = None, bake: bool = True,
                     device="cuda"):
    """A SceneSetup record → (cfg, params, static) on ``device`` (the
    reference's installSceneSetup, installers.cpp:76-105): the cloud loaded
    and prepared, its size and the light direction from the record, the
    in-scatter field baked unless ``bake`` is false."""
    dev = resolve_device(device)
    base = base or production_base()
    cloud_path = bytes(setup["cloud_path"]).rstrip(b"\x00").decode()
    density = clouds_mod.prepare(clouds_mod.load_density(cloud_path))
    light = tuple(float(x) for x in setup["light_direction"])
    cfg = dataclasses.replace(
        base,
        cloud=dataclasses.replace(base.cloud, size_m=float(setup["cloud_size_m"])),
        light=dataclasses.replace(base.light, direction=light),
    )
    params, static = build_scene(cfg, density, device=dev)
    if bake:
        params = inscatter.with_baked_inscatter(params, static, device=dev)
    return cfg, params, static


def eval_scene(held_out: dict, width: int = 512,
               height: int = 256) -> Tuple[np.void, SceneConfig]:
    """The end-to-end evaluation's held-out scene (``tools/eval_e2e.py``
    :124-149, recorded in its JSON as ``held_out_scene``: ``cloud``,
    ``size_m``, ``light``) → (its SceneSetup record, the base config the
    evaluation renders it with): Russian roulette from bounce 64 at 0.98
    survival, uint8 textures, a ``width`` x ``height`` camera.  Pass both to
    ``scene_from_setup``."""
    setup = np.zeros(1, records.SCENE_SETUP)[0]
    setup["cloud_path"] = held_out["cloud"].encode()[: records.CLOUD_PATH_LEN]
    setup["cloud_size_m"] = held_out["size_m"]
    setup["light_direction"] = np.asarray(held_out["light"], np.float32)
    base = SceneConfig(
        rendering=CloudRendering(rr_start_depth=64, rr_survival=0.98, march_dtype="uint8"),
        camera=CameraConfig(width=width, height=height),
    )
    return setup, base


def radiance_state_path(store: RecordStore, scene_id: int) -> str:
    """Where the radiance stage keeps a scene's resumable state."""
    return os.path.join(store.root, f".radiance_state.{scene_id}.npz")


def collect(
    store: RecordStore,
    record_type: str,
    mode: CollectMode = CollectMode.CONTINUE,
    base: Optional[SceneConfig] = None,
    radiance_cfg: PointRadianceConfig = PointRadianceConfig(),
    batch_size: int = records.BATCH_SIZE,
    max_scenes: Optional[int] = None,
    verbose: bool = True,
    device="cuda",
) -> int:
    """Run one collection stage over every SceneSetup in ``store`` on
    ``device``; returns the number of scenes processed.  Stages read their
    predecessors' records: ScatterSample → Result → DisneyDescriptor →
    BakedInterpolationSet."""
    dev = resolve_device(device)
    n_scenes = store.count("SceneSetup")
    if max_scenes is not None:
        n_scenes = min(n_scenes, max_scenes)
    start_scene = 0
    if mode is CollectMode.CONTINUE:
        start_scene = store.count(record_type) // batch_size
    setups = store.table("SceneSetup")
    processed = 0
    for scene_id in range(start_scene, n_scenes):
        if verbose:
            print(f"[collect {record_type}] scene {scene_id + 1}/{n_scenes}...", flush=True)
        batch = BatchSettings(start_id=scene_id * batch_size, size=batch_size)
        _, params, static = scene_from_setup(setups.get_record(scene_id), base,
                                             bake=(record_type != "ScatterSample"), device=dev)
        seed = scene_id  # deterministic, restart-stable per scene
        if record_type == "ScatterSample":
            s = collectors.generate_scatter_samples(params, static, batch.size, seed)
            out = np.zeros(batch.size, records.SCATTER_SAMPLE)
            out["scene_setup_id"] = scene_id
            out["point"] = s.positions.cpu().numpy()
            out["view_direction"] = s.directions.cpu().numpy()
            store.table("ScatterSample").batch_append(batch.start_id, out)
        else:
            samples = store.table("ScatterSample").read(batch.start_id, batch.size)
            pos = torch.as_tensor(samples["point"], device=dev)
            direction = torch.as_tensor(samples["view_direction"], device=dev)
            if record_type == "Result":
                state_file = radiance_state_path(store, scene_id)
                est = collectors.estimate_point_radiance(
                    params, static, pos, direction, radiance_cfg, seed=seed,
                    verbose=verbose, state_path=state_file)
                out = np.zeros(batch.size, records.RESULT)
                out["light_intensity"] = est.radiance
                out["is_converged"] = est.is_converged.astype(np.uint8)
                store.table("Result").batch_append(batch.start_id, out)
                if os.path.exists(state_file):
                    os.remove(state_file)
            elif record_type == "DisneyDescriptor":
                out = np.zeros(batch.size, records.DISNEY_DESCRIPTOR)
                out["grid"] = collectors.collect_disney_descriptors(params, static, pos,
                                                                    direction)
                store.table("DisneyDescriptor").batch_append(batch.start_id, out)
            elif record_type == "BakedInterpolationSet":
                out = collectors.collect_baked_sets(params, static, pos)
                store.table("BakedInterpolationSet").batch_append(batch.start_id, out)
            else:
                raise ValueError(f"unknown record type {record_type}")
        processed += 1
        if verbose:
            print(f"[collect {record_type}] scene {scene_id + 1}/{n_scenes} done", flush=True)
    return processed
