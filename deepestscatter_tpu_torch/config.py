"""Typed configuration: the part of the reference configuration the RPNN
neural frame reads.

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
    """March settings the neural frame reads.

    ``march_dtype`` is the texture storage: "float32", or "uint8" (the
    reference's own storage, values x255).  The JAX package's brick-row
    layout (``march_brick``) is a gather-rate choice for the TPU whose
    values equal the cell layout's; this package keeps raw ``[Z, Y, X]``
    grids and has no such field.
    """

    sample_step: float = 1.0 / 512.0
    mode: RenderMode = RenderMode.SUN_AND_SKY_ALL_SCATTER
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


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    light: DirectionalLight = dataclasses.field(default_factory=DirectionalLight)
    cloud: CloudModel = dataclasses.field(default_factory=CloudModel)
    rendering: CloudRendering = dataclasses.field(default_factory=CloudRendering)
    sky: SkyConfig = dataclasses.field(default_factory=SkyConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    @property
    def density_multiplier(self) -> float:
        """size / mean-free-path (reference: VDBCloud.cpp:109)."""
        return self.cloud.size_m / self.cloud.mean_free_path_m


def fov_tan_halves(hfov_deg: float, width: int, height: int) -> Tuple[float, float]:
    """Pinhole half-extent tangents for (U, V) from the horizontal fov,
    with square pixels."""
    tan_h = math.tan(math.radians(hfov_deg) / 2.0)
    tan_v = tan_h * (height / width)
    return tan_h, tan_v
