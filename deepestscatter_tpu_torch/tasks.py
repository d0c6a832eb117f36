"""Task orchestration: the dataset collection and the render tasks.

The port of ``deepestscatter_tpu.tasks`` (reference: Tasks.h, Tasks.cpp):

- ``collect`` runs one stage of the four-stage pipeline (ScatterSample,
  then Result, DisneyDescriptor and BakedInterpolationSet, each reading the
  samples) over every SceneSetup of a store.  Scene i owns the sample ids
  [i * batch, (i + 1) * batch), its stream seed is i, and CONTINUE resumes
  at ``count // batch`` (Tasks.h:59-68, Tasks.cpp:137).
- ``render_cloud`` is the renderCloud task (Tasks.cpp:104-112): a cloud
  rendered for each light direction, by the path tracer to convergence or
  by a neural renderer whose weights ``load_neural_weights`` reads from a
  trainer's exports (``<Model>.pt`` of this package's trainer, or
  ``<Model>.params.msgpack`` of the JAX package's).
- ``eval_scene`` sets up the held-out scene of the end-to-end evaluation
  (``eval_e2e``).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .config import (LIGHT_DIRECTIONS, BatchSettings, CameraConfig, CloudRendering,
                     PointRadianceConfig, SceneConfig)
from .data import clouds as clouds_mod
from .data import collectors, records
from .data.store import RecordStore
from .device import resolve_device
from .models import convert
from .models.blocks import flax_init
from .models.flax_msgpack import load_flax_msgpack
from .models.probes import LightProbeModel, ProbeRendererModel
from .models.rpnn import DisneyModel
from .render import camera as camera_ops
from .render import inscatter
from .render.baked import BakedRenderer
from .render.neural import DisneyRenderer
from .render.progressive import ProgressiveRenderer
from .scene import build_scene
from .utils import exr


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


def eval_base(width: int = 512, height: int = 256) -> SceneConfig:
    """The end-to-end evaluation's scene settings: Russian roulette from
    bounce 64 at 0.98 survival (unbiased; it cuts the deep-diffusion tail of
    label generation), uint8 textures, a ``width`` x ``height`` camera."""
    return SceneConfig(
        rendering=CloudRendering(rr_start_depth=64, rr_survival=0.98, march_dtype="uint8"),
        camera=CameraConfig(width=width, height=height),
    )


def eval_scene(held_out: dict, width: int = 512,
               height: int = 256) -> Tuple[np.void, SceneConfig]:
    """The end-to-end evaluation's held-out scene (``tools/eval_e2e.py``
    :124-149, recorded in its JSON as ``held_out_scene``: ``cloud``,
    ``size_m``, ``light``) → (its SceneSetup record, the base config the
    evaluation renders it with, ``eval_base``).  Pass both to
    ``scene_from_setup``."""
    setup = np.zeros(1, records.SCENE_SETUP)[0]
    setup["cloud_path"] = held_out["cloud"].encode()[: records.CLOUD_PATH_LEN]
    setup["cloud_size_m"] = held_out["size_m"]
    setup["light_direction"] = np.asarray(held_out["light"], np.float32)
    return setup, eval_base(width, height)


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


#: Trainer run subdirectories searched for exported weights: the trainers
#: write ``<run_dir>/<trainer name>/<Model>.pt`` (``train.trainer``).
TRAINER_SUBDIRS = {"nn": "DisneyModel", "bnn": "BakedModel"}

#: The networks each neural renderer loads, with the conversion of the JAX
#: package's parameter tree into the torch module's state dict.
_NETWORKS = {
    "nn": (("DisneyModel", DisneyModel, convert.disney_from_flax),),
    "bnn": (("LightProbeModel", LightProbeModel, convert.light_probe_from_flax),
            ("ProbeRendererModel", ProbeRendererModel, convert.probe_renderer_from_flax)),
}


def load_neural_weights(kind: str, models_dir: Optional[str] = None,
                        device="cuda") -> Dict[str, nn.Module]:
    """The networks an NN (``kind="nn"``: ``DisneyModel``) or BNN
    (``"bnn"``: ``LightProbeModel`` and ``ProbeRendererModel``) renderer
    needs, by name, on ``device`` (the reference loads ``DisneyModel.pt`` /
    ``LightProbeModel.pt``, DisneyRenderer.cpp:19, BakedRenderer.cpp:12).

    Each is searched in ``models_dir`` (default ``runs``) and then in its
    trainer's subdirectory (``<models_dir>/DisneyModel`` or
    ``<models_dir>/BakedModel``, where the trainers export); in each
    directory this package's export ``<Model>.pt`` first, the JAX trainer's
    ``<Model>.params.msgpack`` second.  A missing export raises.

    ``models_dir=":init:"`` gives untrained weights, ``blocks.flax_init``
    from seed 566 (smoke renders): the distribution of the JAX package's
    ``model.init(PRNGKey(566))``, not its values."""
    if kind not in _NETWORKS:
        raise ValueError(f"unknown neural renderer {kind!r} (want 'nn' or 'bnn')")
    dev = resolve_device(device)
    root = models_dir or "runs"
    search = [root, os.path.join(root, TRAINER_SUBDIRS[kind])]
    out = {}
    for name, cls, from_flax in _NETWORKS[kind]:
        model = cls()
        if models_dir == ":init:":
            out[name] = flax_init(model, 566, dev).eval()
            continue
        state = None
        for d in search:
            pt, msgpack = (os.path.join(d, f"{name}{ext}") for ext in (".pt", ".params.msgpack"))
            if os.path.exists(pt):
                state = torch.load(pt, map_location="cpu", weights_only=True)
            elif os.path.exists(msgpack):
                state = from_flax(load_flax_msgpack(msgpack))
            if state is not None:
                break
        if state is None:
            train = "disney" if kind == "nn" else "baked"
            raise FileNotFoundError(
                f"{name}.pt or {name}.params.msgpack not found under {search}: train "
                f"first (`python -m deepestscatter_tpu_torch train-{train} ...`) or pass "
                f"models_dir=':init:' for untrained smoke renders")
        model.load_state_dict(state, strict=True)
        out[name] = model.to(dev).eval()
    return out


def build_neural_renderer(kind: str, weights: Dict[str, nn.Module], params, static,
                          device="cuda"):
    """The frame renderer from loaded weights: ``DisneyRenderer`` serves
    every scene and light; ``BakedRenderer`` bakes its probe lattice for
    this scene and light (BakedRenderer.cpp:86)."""
    if kind == "nn":
        return DisneyRenderer(weights["DisneyModel"], device=device)
    return BakedRenderer(params, static, weights["LightProbeModel"],
                         weights["ProbeRendererModel"], device=device)


def render_cloud(
    cloud_path: str,
    out_dir: str = ".",
    renderer: str = "pt",
    size_m: float = 3000.0,
    directions: Sequence[str] = ("Side", "Back"),
    base: Optional[SceneConfig] = None,
    models_dir: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
) -> list:
    """The renderCloud task (Tasks.cpp:104-112) on ``device``: one render
    of the cloud a light direction (``config.LIGHT_DIRECTIONS``), written
    as ``<out_dir>/<cloud>.<direction>.<PT|NN|BNN>.exr``; returns the paths.

    ``renderer``: ``"pt"``, the progressive path tracer to convergence
    (seed 0); ``"nn"``, the RPNN renderer; ``"bnn"``, the baked
    two-network renderer (the one the reference's renderCloud hardwires,
    Tasks.cpp:86), its probe lattice baked for each direction.  The neural
    weights load once (``load_neural_weights(renderer, models_dir)``)."""
    dev = resolve_device(device)
    base = base or production_base()
    density = clouds_mod.prepare(clouds_mod.load_density(cloud_path))
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(out_dir, os.path.splitext(os.path.basename(cloud_path))[0]
                        .replace(":", "_"))
    weights = shared = None
    if renderer != "pt":
        weights = load_neural_weights(renderer, models_dir, dev)
        if renderer == "nn":
            shared = build_neural_renderer("nn", weights, None, None, dev)
    outputs = []
    for dir_name in directions:
        cfg = dataclasses.replace(
            base,
            cloud=dataclasses.replace(base.cloud, size_m=size_m),
            light=dataclasses.replace(base.light, direction=LIGHT_DIRECTIONS[dir_name]),
        )
        params, static = build_scene(cfg, density, device=dev)
        params = inscatter.with_baked_inscatter(params, static, device=dev)
        if renderer == "pt":
            hdr = ProgressiveRenderer(cfg, params, static, seed=0, device=dev).run(verbose)
        else:
            frames = shared or build_neural_renderer(renderer, weights, params, static, dev)
            hdr = frames.render_frame(params, static, cfg.camera.width, cfg.camera.height,
                                      camera_ops.camera_basis(cfg.camera)).cpu().numpy()
        path = f"{stem}.{dir_name}.{renderer.upper()}.exr"
        exr.write_exr(path, hdr)
        outputs.append(path)
        if verbose:
            print(f"[render_cloud] wrote {path}", flush=True)
    return outputs
