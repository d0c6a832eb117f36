"""Hierarchical density descriptors, the RPNN input featurizer, and its
CUDA kernel (K2, ``csrc/descriptor.cu``).

The port of ``deepestscatter_tpu.ops.descriptor``: a light-oriented frame
(``eZ = -light``, ``eX = norm(eZ x view)``, ``eY = eX x eZ``); L layers of
5x5x9 samples at offsets x, y in [-2, 2], z in [-2, 6] (x fastest); layer
spacing ``0.5 / density_multiplier``, doubling per layer; mip level
``-log2(voxel_size_in_mfp) - 1``, +1 per layer; densities faded to 0 over
one mip voxel outside the box; the view-to-light angle omega appended to
every layer.  The baked renderer reads 3 layers along the view
(``BAKED_REALTIME_LAYERS``) and bakes its probes from 9 layers in the frame
of the fixed probe direction (``LIGHTPROBE_LAYERS``, ``frame_dir``); its
alpha angle (``alpha_angle``) relates the two frames.

``network_inputs`` is the kernel's wrapper and returns the [M, L, 226]
tensor the models consume (any L up to 16): on CUDA tensors it launches K2
(a thread per point and stencil column, over the layers), on CPU tensors it
runs ``network_inputs_plain``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..device import check_on
from ..scene import SceneParams, SceneStatic
from . import grid as grid_ops

LAYER_NX = 5
LAYER_NY = 5
LAYER_NZ = 9
LAYER_SIZE = LAYER_NX * LAYER_NY * LAYER_NZ  # 225
DISNEY_LAYERS = 10
BAKED_REALTIME_LAYERS = 3
LIGHTPROBE_LAYERS = 9
#: The kernel's layer table holds at most this many layers.
MAX_LAYERS = 16


def _layer_offsets() -> np.ndarray:
    """[225, 3] offsets in layer units, x fastest, then y, then z."""
    out = np.empty((LAYER_SIZE, 3), np.float32)
    i = 0
    for z in range(-2, 7):
        for y in range(-2, 3):
            for x in range(-2, 3):
                out[i] = (x, y, z)
                i += 1
    return out


_OFFSETS = _layer_offsets()


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def _norm3(a: torch.Tensor) -> torch.Tensor:
    sq = a * a
    return torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])


def frame_z(light_dir: torch.Tensor) -> torch.Tensor:
    """eZ = -light / |light|, per row: ``light_dir`` is one [3] vector or an
    [N, 3] batch (the training datasets mix scenes with different lights)."""
    return -light_dir / _norm3(light_dir)[..., None]


def light_frame(light_dir: torch.Tensor, view_dir: torch.Tensor):
    """The light-oriented basis (eX, eY, eZ), each [N, 3]; norms per row."""
    ez = frame_z(light_dir).expand(view_dir.shape)
    ex = _cross(ez, view_dir)
    ex = ex / torch.clamp(_norm3(ex), min=1e-12)[..., None]
    ey = _cross(ex, ez)
    return ex, ey, ez


def distance_to_box(
    pos: torch.Tensor, bbox_size: torch.Tensor, voxel_size: float
) -> torch.Tensor:
    """Distance outside the box shrunk by half a voxel; pos [..., 3]."""
    dist = torch.abs(pos - bbox_size * 0.5)
    corner = torch.clamp(bbox_size * 0.5 - voxel_size * 0.5, min=0.0)
    dist = torch.clamp(dist - corner, min=0.0)
    return _norm3(dist)


def base_mip_level(static: SceneStatic) -> float:
    """-log2(voxel size in MFP) - 1."""
    return -float(np.log2(static.voxel_size_in_mfp)) - 1.0


def layer_plan(static: SceneStatic, n_layers: int) -> List[Tuple]:
    """Per layer ``(scale, mip_voxel, lod)``: the host-side Python floats of
    the JAX loop (spacing doubling per layer, unclamped mip voxel)."""
    scale = 0.5 / static.density_multiplier
    mip = base_mip_level(static)
    plan = []
    for _ in range(n_layers):
        mip_voxel = (2.0 ** max(mip, 0.0)) * static.voxel_size_normalized
        plan.append((scale, mip_voxel, max(mip, 0.0)))
        scale *= 2.0
        mip += 1.0
    return plan


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def omega_angle(light_dir: torch.Tensor, view_dir: torch.Tensor) -> torch.Tensor:
    """Angle between the light direction and the viewing ray."""
    return torch.acos(torch.clamp(_dot3(light_dir, view_dir), -1.0, 1.0))


def alpha_angle(
    light_dir: torch.Tensor, view_dir: torch.Tensor, probe_dir: torch.Tensor
) -> torch.Tensor:
    """The alpha angle: the signed angle about the light axis between eY of
    the frame built from the view and eY of the frame built from the probe
    direction; negative where ``(eY_view x eY_probe) . eZ < 0``."""
    _, ey_v, ez = light_frame(light_dir, view_dir)
    _, ey_p, _ = light_frame(light_dir, probe_dir)
    cos_a = torch.clamp(_dot3(ey_v, ey_p), -1.0, 1.0)
    negative = _dot3(_cross(ey_v, ey_p), ez) < 0.0
    return torch.acos(cos_a) * torch.where(negative, -1.0, 1.0)


def gather_descriptor(
    params: SceneParams,
    static: SceneStatic,
    world_pos: torch.Tensor,
    view_dir: torch.Tensor,
    n_layers: int = DISNEY_LAYERS,
    frame_dir: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Descriptor at ``world_pos`` [N, 3] (local coords) → [N, L, 225].
    The light frame is built from ``view_dir`` [N, 3], or from
    ``frame_dir`` [N, 3] where given (the probe bake's fixed direction)."""
    d = view_dir if frame_dir is None else frame_dir
    ex, ey, ez = light_frame(params.light_dir, d)
    offsets = torch.as_tensor(_OFFSETS, device=world_pos.device)
    layers = []
    for scale, mip_voxel, lod in layer_plan(static, n_layers):
        off = (
            (
                ex[:, None, :] * offsets[None, :, 0:1]
                + ey[:, None, :] * offsets[None, :, 1:2]
            )
            + ez[:, None, :] * offsets[None, :, 2:3]
        ) * scale
        pos = world_pos[:, None, :] + off
        density = grid_ops.sample_mip(params.density_mips, pos / params.bbox_size, lod)
        t = torch.clamp(
            grid_ops.true_div(distance_to_box(pos, params.bbox_size, mip_voxel), mip_voxel),
            0.0,
            1.0,
        )
        layers.append(density * (1.0 - t))
    return torch.stack(layers, dim=1)


def with_angle(descriptor: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Append omega to every layer: [N, L, 225] + [N] → [N, L, 226]."""
    n, l, _ = descriptor.shape
    a = angle[:, None, None].expand(n, l, 1)
    return torch.cat([descriptor, a], dim=-1)


def quantize_u8(descriptor: torch.Tensor) -> torch.Tensor:
    """The descriptor records' storage quantizer (DisneyDescriptor.cuh
    TFromFloat<uint8_t>): ``d * 255`` truncated to uint8.  Not the scene's
    rounding texture quantizer (``grid.quantize_texture``), nor the
    in-scatter field's ``floor(T * 255) / 255``, nor the probes'
    ``render.baked.quantize_latent``."""
    return (descriptor * 255.0).to(torch.uint8)


def dequantize_u8(stored: torch.Tensor) -> torch.Tensor:
    """The training-time dequantization of stored descriptors: ``/ 256``
    (DisneyDataset.py:33)."""
    return stored.to(torch.float32) / 256.0


def network_inputs_plain(
    params: SceneParams,
    static: SceneStatic,
    pos: torch.Tensor,
    dirs: torch.Tensor,
    n_layers: int = DISNEY_LAYERS,
    frame_dir: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2: ``n_layers`` descriptor layers (in the
    frame of ``frame_dir`` where given) with omega of ``dirs`` appended →
    [N, L, 226]."""
    layers = gather_descriptor(params, static, pos, dirs, n_layers, frame_dir)
    return with_angle(layers, omega_angle(params.light_dir, dirs))


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _launch(params, static, pos, dirs, n_layers=DISNEY_LAYERS, frame_dir=None,
            lib=None) -> torch.Tensor:
    """K2 on the inputs' device.  ``lib``: another library with the same
    ``ds_descriptor`` entry point (the tests' host build of the kernel's
    device functions, the alternatives ``probes/march_variants.py`` times)."""
    frames = dirs if frame_dir is None else frame_dir
    cuda_build.require_vec3(pos=pos, dirs=dirs, frame_dir=frames)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"K2 takes 1 to {MAX_LAYERS} layers, got {n_layers}")
    mips = params.mip_flat
    if mips.dtype not in (torch.uint8, torch.float32):
        raise ValueError("mip pyramid must be uint8 or float32")
    if not mips.is_contiguous():
        raise ValueError("mip pyramid must be contiguous")
    if mips.numel() >= 2**31 or pos.shape[0] * (LAYER_SIZE + 1) >= 2**31:
        raise ValueError("K2 indexes in 32 bits: fewer than 2^31 texels and points x 226")
    check_on(pos.device, dirs, frames, mips, params.light_dir)
    fn = (lib or cuda_build.load("descriptor")).ds_descriptor
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int

    fvals = list(static.bbox)
    ivals = []
    for scale, mip_voxel, lod in layer_plan(static, n_layers):
        lo, hi, w_lo, w_hi, use_hi = grid_ops.mip_lerp_levels(static.n_mips, lod)
        voxel = float(np.float32(mip_voxel))
        fvals += [w_lo, w_hi, scale, voxel, float(np.float32(mip_voxel * 0.5))]
        ivals += [lo, hi, int(use_hi)]
    for off, (nz, ny, nx) in zip(static.mip_offsets, static.mip_shapes):
        ivals += [off, nx, ny, nz]
    fconsts = (ctypes.c_float * len(fvals))(*fvals)
    iconsts = (ctypes.c_int64 * len(ivals))(*ivals)

    m = pos.shape[0]
    out = torch.empty(
        (m, n_layers, LAYER_SIZE + 1), dtype=torch.float32, device=pos.device
    )
    ez = frame_z(params.light_dir).contiguous()
    cuda_build.check(
        fn(
            cuda_build.ptr(mips), int(mips.dtype == torch.uint8),
            cuda_build.ptr(pos), cuda_build.ptr(dirs), cuda_build.ptr(frames),
            cuda_build.ptr(ez), cuda_build.ptr(params.light_dir), m, n_layers, static.n_mips,
            fconsts, iconsts, cuda_build.ptr(out), cuda_build.stream_handle(),
        ),
        "descriptor kernel",
    )
    network_inputs.launches += 1
    return out


def network_inputs(
    params: SceneParams,
    static: SceneStatic,
    pos: torch.Tensor,
    dirs: torch.Tensor,
    n_layers: int = DISNEY_LAYERS,
    frame_dir: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2's wrapper: [N, L, 226] network inputs at shading points ``pos``
    viewed along ``dirs`` (the RPNN's 10 layers by default; the stencil in
    the frame of ``frame_dir`` where given) — the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if pos.is_cuda:
        return _launch(params, static, pos, dirs, n_layers, frame_dir)
    return network_inputs_plain(params, static, pos, dirs, n_layers, frame_dir)


#: Kernel launches so far (counted where K2 is launched, nowhere else).
network_inputs.launches = 0
