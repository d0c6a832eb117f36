"""Typed configuration: the part of the reference configuration the RPNN
and baked neural frames, the progressive path tracer, the dataset
collectors and the trainers read.

A copy of ``deepestscatter_tpu.config`` (the JAX package's settings) cut to
what this package uses, kept as its own module so that the port imports
nothing of the JAX package.  Field names, defaults and meanings are the
same; see the reference for the full documentation of each field.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

Vec3 = Tuple[float, float, float]


class RenderMode(enum.Enum):
    """Scatter modes (reference: SceneDescription.h:42-47)."""

    SUN_AND_SKY_ALL_SCATTER = "sun_and_sky_all_scatter"
    SUN_MULTIPLE_SCATTER = "sun_multiple_scatter"
    SUN_SINGLE_SCATTER = "sun_single_scatter"


class MipmapsMode(enum.Enum):
    OFF = "off"
    ON = "on"


@dataclasses.dataclass(frozen=True)
class DirectionalLight:
    """The sun: direction it shines along, colour, intensity (1e6 in the
    reference) and angular diameter in degrees."""

    direction: Vec3 = (-0.586, -0.766, -0.271)
    color: Vec3 = (1.0, 1.0, 1.0)
    intensity: float = 1e6
    angular_diameter_deg: float = 0.53


@dataclasses.dataclass(frozen=True)
class CloudModel:
    """Cloud size and mean free path (reference: SceneDescription.h
    Cloud::Model)."""

    #: Physical size of the cloud's longest side, meters.
    size_m: float = 3000.0
    #: Mean free path at density 1.0, meters.
    mean_free_path_m: float = 10.0
    mipmaps: MipmapsMode = MipmapsMode.ON


@dataclasses.dataclass(frozen=True)
class CloudRendering:
    """March and bounce-loop settings (reference: SceneDescription.h
    Cloud::Rendering; MAX_DEPTH 2000, cloudRadianceMaterials.cu:4).

    ``march_dtype`` is the texture storage: "float32", or "uint8" (the
    reference's own storage, values x255).  ``sample_sky`` samples sky and
    sun light where a path leaves the box (all-scatter mode only; off in
    the reference).  ``rr_start_depth`` > 0 turns on Russian roulette from
    that bounce on, survivors reweighted by ``1 / rr_survival``.

    ``occupancy_skipping`` turns on the occupancy-block skip: a step taken
    from a point whose dilated 8^3 block holds no density is
    ``SceneStatic.occupancy_skip_steps`` steps long (the path tracer, the
    first-scatter sampler and the neural camera march take it).

    The JAX package's TPU scheduling fields are left out, because the CUDA
    kernels schedule their own work and have no lockstep batch to
    schedule: ``march_deferred``, ``march_substeps``,
    ``march_resolve_frac``, ``march_check_every``, ``march_pipeline``,
    ``march_resolve_every`` and the brick-row layout ``march_brick`` (a
    gather-rate choice whose values equal the cell layout's; this package
    keeps raw ``[Z, Y, X]`` grids).
    """

    sample_step: float = 1.0 / 512.0
    mode: RenderMode = RenderMode.SUN_AND_SKY_ALL_SCATTER
    max_depth: int = 2000
    sample_sky: bool = False
    rr_start_depth: int = 0
    rr_survival: float = 0.98
    occupancy_skipping: bool = False
    march_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SkyConfig:
    """Sky and ground radiance of the miss gradient."""

    sky_intensity: Vec3 = (0.1, 0.2, 2.0)
    ground_intensity: Vec3 = (0.9, 1.1, 1.1)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera (reference: Camera.cpp:37-42, Tasks.cpp:49-50)."""

    width: int = 512
    height: int = 256
    eye: Vec3 = (2.5, -0.4, 0.0)
    look_at: Vec3 = (0.0, 0.0, 0.0)
    up: Vec3 = (0.0, 1.0, 0.0)
    hfov_deg: float = 30.0
    exposure: float = 0.4


@dataclasses.dataclass(frozen=True)
class ProgressiveConfig:
    """Progressive estimation and its convergence gate (reference:
    Camera.cpp:189-268)."""

    subframes_per_tick: int = 10
    snapshot_every: int = 40
    min_subframes: int = 100
    #: 95% CI gates: converged if relative < rel_tol or absolute < abs_tol.
    rel_tol: float = 0.02
    abs_tol: float = 1e-2
    #: Frame converged when fewer than this many pixels are unconverged.
    max_unconverged_pixels: int = 500
    max_subframes: int = 7000


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    light: DirectionalLight = dataclasses.field(default_factory=DirectionalLight)
    cloud: CloudModel = dataclasses.field(default_factory=CloudModel)
    rendering: CloudRendering = dataclasses.field(default_factory=CloudRendering)
    sky: SkyConfig = dataclasses.field(default_factory=SkyConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    progressive: ProgressiveConfig = dataclasses.field(
        default_factory=ProgressiveConfig
    )

    @property
    def density_multiplier(self) -> float:
        """size / mean-free-path (reference: VDBCloud.cpp:109)."""
        return self.cloud.size_m / self.cloud.mean_free_path_m


@dataclasses.dataclass(frozen=True)
class BatchSettings:
    """Dataset-generation slice ownership: scene i owns sample ids
    [i * 2048, (i + 1) * 2048) (reference: Tasks.cpp:137,
    GlobalSettings.py:1)."""

    start_id: int = 0
    size: int = 2048


@dataclasses.dataclass(frozen=True)
class PointRadianceConfig:
    """Ground-truth label estimation (reference: RadianceCollector.cpp:17,
    88, 112-118): the thread budget re-divided among unconverged points,
    experiments a lane runs per update, the CI gates and the experiments a
    black point needs before it may pass."""

    max_threads: int = 10 * 2048
    launches_per_update: int = 100
    rel_tol: float = 2e-2
    abs_tol: float = 1e-4
    black_min_experiments: int = 100_000


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training recipe (reference: TR/Common/Trainer.py:40-115): one
    seed for the initial weights and the data order, Adam with AMSGrad at
    ``learning_rate``, batches of ``batch_size``, a validation batch of
    ``val_batch_size``, validation and a checkpoint every
    ``validate_every`` steps, runs under ``run_dir/<model name>``."""

    seed: int = 566
    learning_rate: float = 1e-3
    batch_size: int = 1024
    val_batch_size: int = 4096
    epochs: int = 200
    validate_every: int = 40
    run_dir: str = "runs"


#: Light directions of the render and collection tasks (reference:
#: Tasks.cpp:52-65).
LIGHT_DIRECTIONS = {
    "Front": (-0.586, -0.766, -0.271),
    "Side": (0.03, -0.766, -0.642),
    "Back": (0.586, -0.766, 0.271),
}


def fov_tan_halves(hfov_deg: float, width: int, height: int) -> Tuple[float, float]:
    """Pinhole half-extent tangents for (U, V) from the horizontal fov,
    with square pixels."""
    tan_h = math.tan(math.radians(hfov_deg) / 2.0)
    tan_v = tan_h * (height / width)
    return tan_h, tan_v
