"""The neural camera march: Beer-Lambert free flight with conditional
scatter, and its CUDA kernel (K1, ``csrc/march.cu``).

The port of ``deepestscatter_tpu.ops.march.next_scattering_event`` in the
configuration the neural camera runs it (``march_pipeline=True``,
``stop_at_scatter=False``, the cloud-AABB clip, no empty-space skip), plus
``back_correct_distance``.  ``camera_march`` is the kernel's wrapper: on a
CUDA tensor it launches K1 (8 lanes a ray on its consecutive steps), which
fuses the march with next-event estimation; on a CPU tensor it runs
``camera_march_plain``, the same function in plain PyTorch, which is also
the kernel's test oracle.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import cuda_build
from ..device import check_on
from ..scene import SceneParams, SceneStatic, is_in_box
from . import grid as grid_ops
from . import rng as rng_ops


class ScatterEvent(NamedTuple):
    has_scattered: torch.Tensor  # [N] bool
    scatter_pos: torch.Tensor  # [N, 3] local coords (box exit if no scatter)
    transmittance: torch.Tensor  # [N]
    steps: torch.Tensor  # [N] int64 march steps taken (work count)


class CameraMarch(NamedTuple):
    """One camera march pass.  Pass 1 fills only ``transmittance``."""

    transmittance: torch.Tensor  # [N]
    scatter_pos: Optional[torch.Tensor] = None  # [N, 3]
    ok: Optional[torch.Tensor] = None  # [N] bool: scattered inside the box
    direct: Optional[torch.Tensor] = None  # [N, 3] NEE radiance (0 where not ok)


def back_correct_distance(
    od: torch.Tensor, trans_new: torch.Tensor, density: torch.Tensor
) -> torch.Tensor:
    """Free-flight back-correction ``log(od / T) / sigma`` with the
    reference floors 1e-20 (od, T) and 1e-10 (sigma)."""
    return torch.log(
        torch.clamp(od, min=1e-20) / torch.clamp(trans_new, min=1e-20)
    ) / torch.clamp(density, min=1e-10)


def _safe_dir(direction: torch.Tensor) -> torch.Tensor:
    return torch.where(
        direction.abs() > 1e-9, direction, torch.full_like(direction, 1e-9)
    )


def next_scattering_event(
    params: SceneParams,
    static: SceneStatic,
    optical_distance: torch.Tensor,
    pos: torch.Tensor,
    direction: torch.Tensor,
    stop_at_scatter: bool = False,
) -> ScatterEvent:
    """March every ray to its exit from the cloud AABB, recording the first
    step where ``optical_distance > T`` as the scatter event; with
    ``stop_at_scatter`` a ray stops at that step (its transmittance and
    steps end there; the event is the same).

    ``pos`` [N, 3] entry points in local coords, ``direction`` [N, 3] unit
    vectors, ``optical_distance`` [N].  Entry jumps to the AABB on the step
    lattice; each step samples after stepping; rays that do not scatter
    report the analytic full-box exit.  Plain lockstep PyTorch over all
    rays, masked per ray; the step cap is ``max_march_steps`` (see
    ``csrc/march.cu`` on why the JAX iteration cap never binds either)."""
    f32 = torch.float32
    dev = pos.device
    step = static.sample_step
    dm = static.density_multiplier
    dens = params.density_mips[0]
    bbox = params.bbox_size
    lo = torch.tensor(static.cloud_aabb[:3], dtype=f32, device=dev)
    hi = torch.tensor(static.cloud_aabb[3:], dtype=f32, device=dev)

    safe = _safe_dir(direction)
    ta = (lo - pos) / safe
    tb = (hi - pos) / safe
    t_near = torch.clamp(torch.minimum(ta, tb).amax(dim=-1), min=0.0)
    t_far = torch.maximum(ta, tb).amin(dim=-1)
    hits = t_far > t_near
    enter_k = torch.floor(grid_ops.true_div(t_near, step))
    jump = torch.where(hits, enter_k, torch.zeros_like(enter_k)) * step
    cur = pos + direction * jump[:, None]

    n = pos.shape[0]
    active = is_in_box(pos, bbox) & hits
    trans = torch.ones((n,), dtype=f32, device=dev)
    scattered = torch.zeros((n,), dtype=torch.bool, device=dev)
    scatter_pos = torch.zeros_like(pos)
    steps = torch.zeros((n,), dtype=torch.int64, device=dev)
    for _ in range(static.max_march_steps):
        if not bool(active.any()):
            break
        new_pos = cur + direction * step
        density = grid_ops.sample_trilinear(dens, new_pos / bbox) * dm
        trans_new = torch.where(active, trans * torch.exp(-density * step), trans)
        crossed = active & ~scattered & (optical_distance > trans_new)
        back = back_correct_distance(optical_distance, trans_new, density)
        cand = new_pos - direction * back[:, None]
        scatter_pos = torch.where(crossed[:, None], cand, scatter_pos)
        scattered = scattered | crossed
        trans = trans_new
        cur = torch.where(active[:, None], new_pos, cur)
        steps = steps + active.to(torch.int64)
        active = active & torch.all((cur >= lo) & (cur <= hi), dim=-1)
        if stop_at_scatter:
            active = active & ~scattered

    tb0 = (0.0 - pos) / safe
    tb1 = (bbox - pos) / safe
    t_box_far = torch.maximum(tb0, tb1).amin(dim=-1)
    exit_pos = pos + direction * t_box_far[:, None]
    scatter_pos = torch.where(scattered[:, None], scatter_pos, exit_pos)
    return ScatterEvent(scattered, scatter_pos, trans, steps)


def conditional_optical_distance(
    seed, ray_ids: torch.Tensor, trans_total: torch.Tensor
) -> torch.Tensor:
    """``od = 1 - u (1 - T)`` with ``u = hash_uniform(seed, ray_id, 0)``:
    the scatter point importance-sampled given that scattering occurs."""
    u = rng_ops.hash_uniform(seed, ray_ids, 0)
    return 1.0 - u * (1.0 - trans_total)


def camera_march_plain(
    params: SceneParams,
    static: SceneStatic,
    entry: torch.Tensor,
    dirs: torch.Tensor,
    seed=0,
    ray_ids: Optional[torch.Tensor] = None,
    trans_total: Optional[torch.Tensor] = None,
) -> CameraMarch:
    """Plain PyTorch version of K1.  ``trans_total is None`` is pass 1
    (``od = 0``: total transmittance); otherwise pass 2 (conditional
    scatter keyed by ``ray_ids``, plus NEE at the scatter point)."""
    if trans_total is None:
        od = torch.zeros(entry.shape[:1], dtype=torch.float32, device=entry.device)
        return CameraMarch(
            next_scattering_event(params, static, od, entry, dirs).transmittance
        )
    # Late import: the path tracer imports this module.
    from ..render.pathtracer import in_scattering

    od = conditional_optical_distance(seed, ray_ids, trans_total)
    ev = next_scattering_event(params, static, od, entry, dirs)
    ok = ev.has_scattered & is_in_box(ev.scatter_pos, params.bbox_size)
    direct = in_scattering(params, static, ev.scatter_pos, dirs, False)
    direct = torch.where(ok[:, None], direct, torch.zeros_like(direct))
    return CameraMarch(ev.transmittance, ev.scatter_pos, ok, direct)


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _launch(params, static, entry, dirs, seed, ray_ids, trans_total, lib=None) -> CameraMarch:
    """K1 on the inputs' device.  ``lib``: another library with the same
    ``ds_march`` entry point (the tests' host build of the kernel's device
    functions, the alternatives ``probes/march_variants.py`` times)."""
    cuda_build.require_vec3(entry=entry, dirs=dirs)
    dens = params.density_mips[0]
    insc = params.inscatter
    if dens.dtype != insc.dtype or dens.dtype not in (torch.uint8, torch.float32):
        raise ValueError("density and in-scatter textures must share uint8 or float32")
    if not (dens.is_contiguous() and insc.is_contiguous()):
        raise ValueError("textures must be contiguous")
    if dens.numel() >= 2**31:
        raise ValueError("K1 indexes textures in 32 bits: fewer than 2^31 texels")
    check_on(entry.device, dirs, dens, insc, params.phase.eval_rows)
    fn = (lib or cuda_build.load("march")).ds_march
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    n = entry.shape[0]
    dev = entry.device
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    pass2 = trans_total is not None
    pos_out = ok_out = direct_out = None
    if pass2:
        if ray_ids is None or ray_ids.dtype != torch.int64 or ray_ids.shape != (n,):
            raise ValueError("pass 2 needs int64 ray_ids [N]")
        if trans_total.dtype != torch.float32 or trans_total.shape != (n,):
            raise ValueError("trans_total must be float32 [N]")
        check_on(dev, ray_ids, trans_total)
        ray_ids = ray_ids.contiguous()
        trans_total = trans_total.contiguous()
        pos_out = torch.empty((n, 3), dtype=torch.float32, device=dev)
        ok_out = torch.empty((n,), dtype=torch.uint8, device=dev)
        direct_out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    counters = torch.empty((2,), dtype=torch.int64, device=dev)
    consts = (ctypes.c_float * 18)(
        *static.bbox, *static.cloud_aabb[:3], *static.cloud_aabb[3:],
        static.sample_step, static.density_multiplier,
        *static.light_direction, *static.light_rgb, static.sun_solid_angle_ratio,
    )
    nz, ny, nx = static.grid_shape
    cuda_build.check(
        fn(
            cuda_build.ptr(dens), cuda_build.ptr(insc), int(dens.dtype == torch.uint8),
            nx, ny, nz, cuda_build.ptr(params.phase.eval_rows),
            params.phase.eval_rows.shape[0], cuda_build.ptr(entry),
            cuda_build.ptr(dirs), cuda_build.ptr(ray_ids if pass2 else None),
            cuda_build.ptr(trans_total), int(seed) & 0xFFFFFFFF, n, consts,
            static.max_march_steps, cuda_build.ptr(t_out), cuda_build.ptr(pos_out),
            cuda_build.ptr(ok_out), cuda_build.ptr(direct_out), cuda_build.ptr(counters),
            cuda_build.stream_handle(),
        ),
        "march kernel",
    )
    camera_march.launches += 1
    camera_march.last_counters = counters
    if not pass2:
        return CameraMarch(t_out)
    return CameraMarch(t_out, pos_out, ok_out.to(torch.bool), direct_out)


def camera_march(
    params: SceneParams,
    static: SceneStatic,
    entry: torch.Tensor,
    dirs: torch.Tensor,
    seed=0,
    ray_ids: Optional[torch.Tensor] = None,
    trans_total: Optional[torch.Tensor] = None,
) -> CameraMarch:
    """K1's wrapper: the kernel for CUDA tensors, ``camera_march_plain``
    for CPU tensors (same signature and values)."""
    if entry.is_cuda:
        return _launch(params, static, entry, dirs, seed, ray_ids, trans_total)
    return camera_march_plain(
        params, static, entry, dirs, seed, ray_ids, trans_total
    )


#: Kernel launches so far (counted where K1 is launched, nowhere else).
camera_march.launches = 0
#: The last launch's device counters [2] int64: the warps' lane-step slots
#: (32 a loop iteration of a warp, whose groups of lanes take their rays'
#: consecutive steps) and the steps taken (lane utilisation = steps /
#: slots).
camera_march.last_counters = None
