"""The baked light-probe renderer ("BNN"), and the probe interpolation
kernel (K5, ``csrc/probes.cu``).

The port of ``deepestscatter_tpu.render.baked`` (reference:
BakedRenderer.cpp, lightProbeBaker.cu, lightProbeMaterial.cu,
LightProbe.{h,cuh}):

- **bake**: a probe every 6 mean free paths per axis, ``ceil(size_in_mfp /
  6) + 1`` probes per axis; at each probe the 9-layer descriptor in the
  frame of the fixed direction (0, 0, 1) (K2), the ``LightProbeModel``, and
  the 200-wide latent quantized ``clip(x * 256, 0, 255)`` truncated to
  uint8;
- **render**: the RPNN's two camera marches (K1), then at each scattered
  point the tetrahedral interpolation of its 4 enclosing probes with the
  angles omega and alpha appended (K5), the 3-layer realtime descriptor
  with omega (K2), the ``ProbeRendererModel``, and the RPNN's composite
  ``(predicted + direct) * (1 - T)``.

``interpolate_probes`` is K5's wrapper: the kernel on CUDA tensors,
``interpolate_probes_plain`` on CPU tensors.  ``BakedRenderer.render_frame``
runs the RPNN's compacted frame schedule (``neural.CompactCamera``,
``neural.shade_compacted``); ``render_baked`` is the megabatch render of the
same frame, its oracle.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..device import check_on
from ..models.probes import LightProbeModel, ProbeRendererModel
from ..ops import descriptor as desc_ops
from ..ops import tetra as tetra_ops
from ..scene import SceneParams, SceneStatic
from . import camera as camera_ops
from . import neural

#: Lattice spacing in mean free paths (LightProbe.h:11).
STEP_IN_MEAN_FREE_PATH = 6.0
#: Latent width (LightProbe.h:13).
PROBE_LENGTH = 200
#: Width of the renderer's probe input: latents, omega, alpha.
PROBE_IN_WIDTH = PROBE_LENGTH + 2
#: The probes' canonical frame direction (lightProbeBaker.cu:19).
PROBE_DIRECTION = (0.0, 0.0, 1.0)
#: Probes per bake launch of the descriptor and the LightProbeModel.
BAKE_CHUNK = 4096


def probe_lattice_shape(static: SceneStatic) -> Tuple[int, int, int]:
    """Probes per axis (x, y, z): ``ceil(size_in_mfp / 6) + 1``."""
    return tuple(
        int(math.ceil(b * static.density_multiplier / STEP_IN_MEAN_FREE_PATH)) + 1
        for b in static.bbox
    )


def probe_positions(static: SceneStatic, lattice: Tuple[int, int, int], device) -> torch.Tensor:
    """Local positions of every probe, [P, 3] with P = px * py * pz, x
    fastest (the baker's launch order)."""
    px, py, pz = lattice
    spacing = STEP_IN_MEAN_FREE_PATH / static.density_multiplier
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in (pz, py, px)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3) * spacing


def probe_frames(n: int, device) -> torch.Tensor:
    """The probe direction as an [n, 3] frame-direction tensor."""
    d = torch.tensor(PROBE_DIRECTION, dtype=torch.float32, device=device)
    return d.expand(n, 3).contiguous()


def quantize_latent(latent: torch.Tensor) -> torch.Tensor:
    """The probes' uint8 quantizer: ``clip(latent * 256, 0, 255)``
    truncated (BakedRenderer.cpp:113-116)."""
    return torch.clamp(latent * 256.0, 0.0, 255.0).to(torch.uint8)


def bake_probes(
    params: SceneParams,
    static: SceneStatic,
    model: LightProbeModel,
    lattice: Tuple[int, int, int],
    chunk: int = BAKE_CHUNK,
    quantize: bool = True,
) -> torch.Tensor:
    """Bake the probe lattice → [pz, py, px, 200] (uint8 if ``quantize``)
    on the scene's device, ``chunk`` probes a launch: the 9-layer
    descriptor (K2) in the probe direction's frame, then the model."""
    dev = params.bbox_size.device
    positions = probe_positions(static, lattice, dev)
    frames = probe_frames(chunk, dev)
    outs = []
    with torch.inference_mode():
        for start in range(0, positions.shape[0], chunk):
            pos = positions[start : start + chunk]
            f = frames[: pos.shape[0]]
            layers = desc_ops.network_inputs(
                params, static, pos, f, desc_ops.LIGHTPROBE_LAYERS, frame_dir=f
            )
            latent = model(layers[:, :, : desc_ops.LAYER_SIZE])
            outs.append(quantize_latent(latent) if quantize else latent)
    px, py, pz = lattice
    return torch.cat(outs).reshape(pz, py, px, PROBE_LENGTH)


def alpha_canonical(params: SceneParams, directions: torch.Tensor) -> torch.Tensor:
    """Alpha between the view-based and the probe-direction frames."""
    probe_dir = probe_frames(directions.shape[0], directions.device)
    return desc_ops.alpha_angle(params.light_dir, directions, probe_dir)


def _lattice_units(static: SceneStatic) -> float:
    """float32(density_multiplier / 6): positions → lattice units."""
    return float(np.float32(static.density_multiplier / STEP_IN_MEAN_FREE_PATH))


def probe_corners(
    lattice_shape, static: SceneStatic, pos: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The corner probes of local positions ``pos`` [N, 3] in a lattice of
    ``lattice_shape`` (pz, py, px, ...) → (flat probe indices [N, 4] int64,
    clamped to the lattice; barycentric weights [N, 4])."""
    pz, py, px = lattice_shape[:3]
    corners, w = tetra_ops.probe_interpolation(pos * _lattice_units(static))
    cx = torch.clamp(corners[..., 0], 0, px - 1)
    cy = torch.clamp(corners[..., 1], 0, py - 1)
    cz = torch.clamp(corners[..., 2], 0, pz - 1)
    return ((cz * py + cy) * px + cx).long(), w


def interpolate_latents(
    probes: torch.Tensor, static: SceneStatic, pos: torch.Tensor
) -> torch.Tensor:
    """Tetrahedral interpolation of the probes at local positions ``pos``
    [N, 3] → [N, 200] float latents (uint8 probes dequantized by / 256), the
    four weighted corners summed left to right."""
    idx, w = probe_corners(probes.shape, static, pos)
    lat = probes.reshape(-1, PROBE_LENGTH)[idx]  # [N, 4, 200]
    if probes.dtype == torch.uint8:
        lat = lat.to(torch.float32) / 256.0
    acc = lat[:, 0] * w[:, 0, None]
    for k in range(1, 4):
        acc = acc + lat[:, k] * w[:, k, None]
    return acc


def interpolate_probes_plain(
    params: SceneParams,
    static: SceneStatic,
    probes: torch.Tensor,
    pos: torch.Tensor,
    dirs: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of K5: the renderer's probe inputs [N, 202]
    at shading points ``pos`` seen along ``dirs``: the interpolated
    latents, omega and alpha."""
    omega = desc_ops.omega_angle(params.light_dir, dirs)
    alpha = alpha_canonical(params, dirs)
    latent = interpolate_latents(probes, static, pos)
    return torch.cat([latent, omega[:, None], alpha[:, None]], dim=-1)


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _launch(params, static, probes, pos, dirs, lib=None, entry="ds_probes") -> torch.Tensor:
    """K5 on the inputs' device.  ``lib``: another library with the same
    ``ds_probes`` entry point (the tests' host build of the kernel's device
    functions); ``entry="ds_probes_first"`` runs K5's first design, kept in
    ``csrc/probes.cu`` for comparison."""
    cuda_build.require_vec3(pos=pos, dirs=dirs)
    if probes.dtype not in (torch.uint8, torch.float32):
        raise ValueError("probes must be uint8 or float32")
    if probes.dim() != 4 or probes.shape[3] != PROBE_LENGTH or not probes.is_contiguous():
        raise ValueError(f"probes must be a contiguous [pz, py, px, {PROBE_LENGTH}] lattice")
    if probes.numel() >= 2**31 or pos.shape[0] * PROBE_IN_WIDTH >= 2**31:
        raise ValueError("K5 indexes in 32 bits: fewer than 2^31 latents and points x 202")
    if probes.data_ptr() % 16:
        raise ValueError("K5 reads the lattice in aligned words: it must start 16-byte aligned")
    check_on(pos.device, dirs, probes, params.light_dir)
    fn = getattr(lib or cuda_build.load("probes"), entry)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    fvals = [_lattice_units(static), tetra_ops.INV_SQRT3, *tetra_ops.TEST_NORMALS.ravel().tolist()]
    consts = (ctypes.c_float * len(fvals))(*fvals)
    pz, py, px, _ = probes.shape
    n = pos.shape[0]
    out = torch.empty((n, PROBE_IN_WIDTH), dtype=torch.float32, device=pos.device)
    ez = desc_ops.frame_z(params.light_dir).contiguous()
    cuda_build.check(
        fn(
            cuda_build.ptr(probes), int(probes.dtype == torch.uint8), px, py, pz,
            cuda_build.ptr(pos), cuda_build.ptr(dirs), cuda_build.ptr(ez),
            cuda_build.ptr(params.light_dir), n, consts, cuda_build.ptr(out),
            cuda_build.stream_handle(),
        ),
        "probe interpolation kernel",
    )
    interpolate_probes.launches += 1
    return out


def interpolate_probes(
    params: SceneParams,
    static: SceneStatic,
    probes: torch.Tensor,
    pos: torch.Tensor,
    dirs: torch.Tensor,
) -> torch.Tensor:
    """K5's wrapper: the [N, 202] probe inputs (latents, omega, alpha) at
    shading points ``pos`` seen along ``dirs`` — the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if pos.is_cuda:
        return _launch(params, static, probes, pos, dirs)
    return interpolate_probes_plain(params, static, probes, pos, dirs)


#: Kernel launches so far (counted where K5 is launched, nowhere else).
interpolate_probes.launches = 0


def shade_baked(
    params: SceneParams,
    static: SceneStatic,
    model: ProbeRendererModel,
    probes: torch.Tensor,
    pos: torch.Tensor,
    dirs: torch.Tensor,
) -> torch.Tensor:
    """Probe inputs (K5) + 3-layer realtime descriptor (K2) +
    ``ProbeRendererModel`` at shading points ``pos`` seen along ``dirs`` →
    predicted radiance [N].  Row-independent: safe on a compacted subset."""
    probe_in = interpolate_probes(params, static, probes, pos, dirs)
    realtime = desc_ops.network_inputs(
        params, static, pos, dirs, desc_ops.BAKED_REALTIME_LAYERS
    )
    return model(probe_in, realtime)[:, 0]


def render_baked(
    params: SceneParams,
    static: SceneStatic,
    model: ProbeRendererModel,
    probes: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int = 0,
    ray_ids: Optional[torch.Tensor] = None,
    device="cuda",
) -> torch.Tensor:
    """One baked-probe render of a ray batch → radiance [N, 3], every ray
    marched and shaded in one batch.  Deterministic given ``seed``."""
    dev = neural.prepare_device(device, params, model)
    check_on(dev, origins, directions, probes)
    n = origins.shape[0]
    if ray_ids is None:
        ray_ids = torch.arange(n, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        hit, t_hit = camera_ops.intersect_box(origins, directions, static, params.bbox_size)
        entry = camera_ops.entry_points(origins, directions, t_hit, params.bbox_size)
        cs = neural.conditional_scatter(params, static, entry, directions, hit, seed, ray_ids)
        predicted = shade_baked(params, static, model, probes, cs.scatter_pos, directions)
        predicted = torch.where(cs.has_scattered, predicted, torch.zeros_like(predicted))
        miss = camera_ops.miss_radiance(params, static, directions)
        return neural.composite(predicted, cs, miss, hit)


class BakedRenderer:
    """The two-network renderer (the reference's BakedRenderer): bakes the
    probe lattice of the scene at construction, then renders frames with
    the ``ProbeRendererModel`` through the compacted frame schedule."""

    #: Shade rows per K5 + descriptor + MLP launch: bounds the [TILE, 3,
    #: 226] float32 descriptor tensor (~89 MB at 32768 rows).
    TILE = 32768

    def __init__(
        self,
        params: SceneParams,
        static: SceneStatic,
        probe_model: LightProbeModel,
        renderer_model: ProbeRendererModel,
        quantize_probes: bool = True,
        device="cuda",
    ):
        self.device = neural.prepare_device(device, params, probe_model)
        check_on(self.device, next(renderer_model.parameters()))
        self.renderer_model = renderer_model
        self.lattice = probe_lattice_shape(static)
        self.probes = bake_probes(params, static, probe_model, self.lattice,
                                  quantize=quantize_probes)
        self._camera = neural.CompactCamera()

    @property
    def last_counts(self):
        """(n_rays, box hits, scattered) of the last frame."""
        return self._camera.last_counts

    def render_frame(
        self,
        params: SceneParams,
        static: SceneStatic,
        width: int,
        height: int,
        basis: camera_ops.CameraBasis,
        seed: int = 0,
    ) -> torch.Tensor:
        dev = neural.prepare_device(self.device, params, self.renderer_model)
        with torch.inference_mode():
            origins, directions = camera_ops.generate_rays(basis, width, height, dev)
            ray_ids = torch.arange(origins.shape[0], dtype=torch.int64, device=dev)
            cs, hit, miss = self._camera.run(params, static, origins, directions, seed, ray_ids)
            predicted = neural.shade_compacted(
                lambda p, d: shade_baked(params, static, self.renderer_model, self.probes, p, d),
                cs,
                directions,
                self.TILE,
            )
            out = neural.composite(predicted, cs, miss, hit)
            return out.reshape(height, width, 3)
