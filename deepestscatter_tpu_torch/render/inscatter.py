"""In-scatter bake: per-voxel transmittance toward the sun, and its CUDA
kernel (K3, ``csrc/inscatter.cu``).

The port of ``deepestscatter_tpu.render.inscatter``: every voxel marches
toward the sun with the scene's sample step, accumulating Beer-Lambert
transmittance, optionally stopping once ``T * 255 < 1``; ``bake`` stores
``floor(T * 255) / 255``.  The result is the NEE shadow field.

``sun_transmittance`` is the kernel's wrapper: on a scene on the card it
launches K3, on a CPU scene it runs ``sun_transmittance_plain``.  Each
takes a range of z planes (``planes``), the share of one rank of the
sharded bake (``parallel.spatial.sharded_inscatter_bake``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import cuda_build
from ..device import check_on, resolve_device
from ..ops import grid as grid_ops
from ..scene import SceneParams, SceneStatic


def bake_steps(sample_step: float, early_out: bool) -> int:
    """Step count: ``round(1/step)`` with early-out, else enough to cover
    the box diagonal."""
    if early_out:
        return int(round(1.0 / sample_step))
    return int(math.ceil(math.sqrt(3.0) / sample_step)) + 2


def plane_range(grid_shape, planes=None):
    """``planes`` as ``(z_begin, z_end)`` (all planes for None); raises
    outside the grid."""
    nz = grid_shape[0]
    z0, z1 = (0, nz) if planes is None else (int(planes[0]), int(planes[1]))
    if not 0 <= z0 <= z1 <= nz:
        raise ValueError(f"planes {planes} outside a grid of {nz} planes")
    return z0, z1


def voxel_base(grid_shape, device, planes=None) -> torch.Tensor:
    """Voxel-corner positions ``(x, y, z) / max_dim`` [V, 3], z-major, of a
    ``[Z, Y, X]`` grid (of its planes ``planes``, default all)."""
    nz, ny, nx = grid_shape
    z0, z1 = plane_range(grid_shape, planes)
    max_dim = float(max(nx, ny, nz))
    v = torch.arange(z0 * ny * nx, z1 * ny * nx, device=device)
    x = (v % nx).to(torch.float32)
    y = ((v // nx) % ny).to(torch.float32)
    z = (v // (nx * ny)).to(torch.float32)
    return grid_ops.true_div(torch.stack([x, y, z], dim=-1), max_dim)


def sun_transmittance_plain(
    params: SceneParams,
    static: SceneStatic,
    early_out: bool = True,
    return_steps: bool = False,
    planes=None,
):
    """Plain PyTorch version of K3: transmittance toward the sun from every
    voxel [V] (of the z planes ``planes``, default all), z-major.  Lockstep
    over voxels; a voxel below 1/255 is frozen (early-out).  With
    ``return_steps`` also returns each voxel's step count (its work)."""
    dens = params.density_mips[0]
    dev = dens.device
    base = voxel_base(static.grid_shape, dev, planes)
    step = static.sample_step
    dm = static.density_multiplier
    to_light = -params.light_dir
    trans = torch.ones(base.shape[:1], dtype=torch.float32, device=dev)
    steps = torch.zeros(base.shape[:1], dtype=torch.int64, device=dev)
    for i in range(bake_steps(step, early_out)):
        active = trans * 255.0 >= 1.0 if early_out else None
        if early_out and not bool(active.any()):
            break
        # float32 product step * i, as the kernel forms it.
        s = float(np.float32(step) * np.float32(i))
        pos = base + to_light * s
        density = grid_ops.sample_trilinear(dens, pos / params.bbox_size) * dm
        new = trans * torch.exp(-density * step)
        if early_out:
            trans = torch.where(active, new, trans)
            steps = steps + active.to(torch.int64)
        else:
            trans = new
            steps = steps + 1
    return (trans, steps) if return_steps else trans


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]


#: The longest x-row K3 takes: its block stages four rows of float32 in the
#: 227 KB of shared memory a block may use.
MAX_ROW = 14336


def launch_bake(dens, bbox, light_dir, sample_step, density_multiplier, early_out,
                lib=None, planes=None) -> torch.Tensor:
    """K3 over a ``[Z, Y, X]`` texture ``dens`` on its device → T [V] (of
    the z planes ``planes``, default all: ``ds_bake_planes``).
    ``bbox``, ``light_dir``: host floats (float32 values); ``lib``: another
    library with the same ``ds_bake`` entry point (the tests' host build of
    the kernel's device functions, the alternatives
    ``probes/march_variants.py`` times)."""
    if dens.dtype not in (torch.uint8, torch.float32) or not dens.is_contiguous():
        raise ValueError("density must be a contiguous uint8 or float32 grid")
    nz, ny, nx = dens.shape
    if dens.numel() >= 2**31 or nx > MAX_ROW:
        raise ValueError(f"K3 takes fewer than 2^31 voxels and rows of at most {MAX_ROW}")
    lib = lib or cuda_build.load("inscatter")
    consts = (ctypes.c_float * 9)(
        *bbox, *light_dir, sample_step, density_multiplier, float(max(nx, ny, nz)),
    )
    head = (cuda_build.ptr(dens), int(dens.dtype == torch.uint8), nx, ny, nz, consts,
            bake_steps(sample_step, early_out), int(early_out))
    if planes is None:
        fn, args = lib.ds_bake, head
        out = torch.empty((dens.numel(),), dtype=torch.float32, device=dens.device)
        fn.argtypes = _ARGTYPES
    else:
        z0, z1 = plane_range(dens.shape, planes)
        fn, args = lib.ds_bake_planes, head + (z0, z1)
        out = torch.empty(((z1 - z0) * ny * nx,), dtype=torch.float32, device=dens.device)
        fn.argtypes = _ARGTYPES[:8] + [ctypes.c_int, ctypes.c_int] + _ARGTYPES[8:]
    fn.restype = ctypes.c_int
    cuda_build.check(fn(*args, cuda_build.ptr(out), cuda_build.stream_handle()), "bake kernel")
    sun_transmittance.launches += 1
    return out


def sun_transmittance(
    params: SceneParams,
    static: SceneStatic,
    early_out: bool = True,
    planes=None,
) -> torch.Tensor:
    """K3's wrapper: per-voxel sun transmittance [V] (of the z planes
    ``planes``, default all) — the kernel for a scene on the card, the
    plain version for a CPU scene."""
    if params.density_mips[0].is_cuda:
        return launch_bake(params.density_mips[0], static.bbox, static.light_direction,
                           static.sample_step, static.density_multiplier, early_out,
                           planes=planes)
    return sun_transmittance_plain(params, static, early_out, planes=planes)


#: Kernel launches so far (counted where K3 is launched, nowhere else).
sun_transmittance.launches = 0


def bake(
    params: SceneParams,
    static: SceneStatic,
    quantize: bool = True,
    early_out: bool = True,
    device="cuda",
    planes=None,
) -> torch.Tensor:
    """Bake the sun-transmittance grid at density resolution → [Z, Y, X]
    (its planes ``(z_begin, z_end)`` only where ``planes`` is given).

    ``early_out`` freezes voxels below 1/255 (exact under the uint8
    quantization); ``quantize`` stores ``floor(T * 255) / 255``."""
    dev = resolve_device(device)
    check_on(dev, params.density_mips[0])
    z0, z1 = plane_range(static.grid_shape, planes)
    trans = sun_transmittance(params, static, early_out, planes=planes)
    if quantize:
        trans = torch.floor(trans * 255.0) / 255.0
    return trans.reshape((z1 - z0,) + tuple(static.grid_shape[1:]))


def with_baked_inscatter(
    params: SceneParams,
    static: SceneStatic,
    quantize: bool = True,
    early_out: bool = True,
    device="cuda",
) -> SceneParams:
    """``params`` with the in-scatter grid baked, stored in the scene's
    texture type (uint8 textures as ``round(clip(T, 0, 1) * 255)``)."""
    baked = bake(params, static, quantize=quantize, early_out=early_out, device=device)
    if params.inscatter.dtype == torch.uint8:
        baked = grid_ops.quantize_texture(baked)
    return params._replace(inscatter=baked.contiguous())
