"""The neural camera march: Beer-Lambert free flight with conditional
scatter, and its CUDA kernel (K1, ``csrc/march.cu``); the empty-space
skips every march of the port shares.

The port of ``deepestscatter_tpu.ops.march.next_scattering_event`` in the
configuration the neural camera runs it (``march_pipeline=True``,
``stop_at_scatter=False``, the cloud-AABB clip), plus
``back_correct_distance`` and ``empty_cell_exit_steps``.  ``camera_march``
is the kernel's wrapper: on a CUDA tensor it launches K1 (8 lanes a ray on
its consecutive steps), which fuses the march with next-event estimation;
on a CPU tensor it runs ``camera_march_plain``, the same function in plain
PyTorch, which is also the kernel's test oracle.

Empty-space skipping (``skip_mode``), with the JAX package's rule a path:

- ``SKIP_BLOCK`` (``SceneStatic.occupancy_skip_steps`` >= 2): a step taken
  from a point whose dilated occupancy block is empty is
  ``occupancy_skip_steps`` lattice steps long;
- ``SKIP_CELL`` (``SceneStatic.march_empty_skip``, where the block skip is
  off): after a step into a cell whose 8 density corners are 0, the march
  jumps ``empty_cell_exit_steps`` whole steps to the cell's exit face.

The neural camera (K1) takes the block skip only, as the JAX package's
pipelined march does; the path tracer (K4) and the first-scatter sampler
(K7a) either; the radiance experiments (K7b) the cell jump only.
"""

from __future__ import annotations

import ctypes
import math
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


#: Empty-space skip of a march (the kernels' template flag of the same value).
SKIP_NONE, SKIP_CELL, SKIP_BLOCK = 0, 1, 2


def skip_mode(static: SceneStatic, cell: bool = True, block: bool = True) -> int:
    """The skip a march of ``static`` takes where the path allows the cell
    jump (``cell``) and the block skip (``block``): the block skip where
    ``occupancy_skip_steps`` >= 2 (no cell jump beside it), else the cell
    jump where ``march_empty_skip``."""
    if block and static.occupancy_skip_steps >= 2:
        return SKIP_BLOCK
    if cell and static.march_empty_skip:
        return SKIP_CELL
    return SKIP_NONE


def check_skip(params: SceneParams, static: SceneStatic, skip: int) -> None:
    """Raises where the scene cannot take ``skip`` (a block skip needs the
    occupancy grid)."""
    if skip == SKIP_BLOCK:
        occ = params.occupancy
        if (occ is None or occ.dim() != 3 or occ.numel() == 0 or occ.dtype != torch.float32
                or not occ.is_contiguous()):
            raise ValueError("the block skip needs the scene's contiguous float32 occupancy grid")
        bits = params.occupancy_bits
        if (bits is None or bits.dtype != torch.int32 or not bits.is_contiguous()
                or bits.numel() != (occ.numel() + 31) // 32):
            raise ValueError("the block skip needs the occupancy's bits (SceneParams."
                             "occupancy_bits, ops.grid.occupancy_bits)")
    elif skip not in (SKIP_NONE, SKIP_CELL):
        raise ValueError(f"unknown skip {skip}")


def empty_cell_exit_steps(cell: torch.Tensor, pos: torch.Tensor, direction: torch.Tensor,
                          dims_f: torch.Tensor, bbox_size: torch.Tensor, step: float,
                          max_jump: float = 64.0) -> torch.Tensor:
    """Whole march steps from ``pos`` [N, 3] along ``direction`` before the
    exit face of the closed cell ``cell`` [N, 3] (its lower corner, x, y,
    z), at most ``max_jump``: float32 [N].  ``dims_f`` [3] is the grid's
    (x, y, z) size as floats.  The cell spans ``(cell + 0.5) / dims *
    bbox`` to ``(cell + 1.5) / dims * bbox``; an axis with ``|d| <= 1e-9``
    never exits."""
    cellf = cell.to(pos.dtype)
    lo = (cellf + 0.5) / dims_f * bbox_size
    hi = (cellf + 1.0 + 0.5) / dims_f * bbox_size
    bound = torch.where(direction > 0.0, hi, lo)
    moving = direction.abs() > 1e-9
    t_ax = torch.where(moving, (bound - pos) / _safe_dir(direction),
                       torch.full_like(pos, math.inf))
    t_exit = torch.clamp(t_ax.amin(dim=-1), min=0.0)
    return torch.clamp(torch.floor(grid_ops.true_div(t_exit, step)), max=max_jump)


def cell_jump(params: SceneParams, static: SceneStatic, pos: torch.Tensor,
              direction: torch.Tensor, room: Optional[torch.Tensor] = None):
    """The empty-cell exit jump from lattice points ``pos`` [N, 3] → (the
    whole steps to jump [N] float32, 0 where the cell at ``pos`` has a
    nonzero corner; at most ``room`` where given)."""
    u = pos / params.bbox_size
    nz, ny, nx = static.grid_shape
    dims = torch.tensor([nx, ny, nz], dtype=pos.dtype, device=pos.device)
    e = empty_cell_exit_steps(grid_ops.packed_cell(u, static.grid_shape), pos, direction, dims,
                              params.bbox_size, static.sample_step)
    if room is not None:
        e = torch.minimum(e, room.to(e.dtype))
    empty = grid_ops.cell_is_empty(params.density_mips[0], u)
    return torch.where(empty, e, torch.zeros_like(e))


def block_step(params: SceneParams, static: SceneStatic, pos: torch.Tensor,
               room: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The lattice steps [N] int64 of the next step from ``pos`` [N, 3]:
    ``occupancy_skip_steps`` (at most ``room`` where given) where the
    dilated block at ``pos`` is empty, else 1."""
    occ = grid_ops.sample_occupancy(params.occupancy, pos / params.bbox_size,
                                    static.grid_shape, static.occupancy_block)
    k = torch.full(occ.shape, static.occupancy_skip_steps, dtype=torch.int64, device=pos.device)
    if room is not None:
        k = torch.clamp(torch.minimum(k, room), min=1)
    return torch.where(occ < 0.5, k, torch.ones_like(k))


def step_length(static: SceneStatic, m: torch.Tensor) -> torch.Tensor:
    """float32 ``sample_step * m`` [N] for lattice steps ``m`` [N] (the
    long step's length; ``sample_step`` itself where m is 1)."""
    return m.to(torch.float32) * torch.tensor(static.sample_step, dtype=torch.float32,
                                              device=m.device)


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
    skip: int = SKIP_NONE,
) -> ScatterEvent:
    """March every ray to its exit from the cloud AABB, recording the first
    step where ``optical_distance > T`` as the scatter event; with
    ``stop_at_scatter`` a ray stops at that step (its transmittance and
    steps end there; the event is the same).

    ``pos`` [N, 3] entry points in local coords, ``direction`` [N, 3] unit
    vectors, ``optical_distance`` [N].  Entry jumps to the AABB on the step
    lattice; each step samples after stepping; rays that do not scatter
    report the analytic full-box exit.  ``skip``: ``SKIP_BLOCK`` makes a
    step from an empty occupancy block ``occupancy_skip_steps`` long;
    ``SKIP_CELL`` jumps a ray still marching from a step in an empty cell
    to the cell's exit face.  Plain lockstep PyTorch over all rays, masked
    per ray; the step cap is ``max_march_steps`` steps sampled (see
    ``csrc/march.cu`` on why the JAX iteration cap never binds either)."""
    check_skip(params, static, skip)
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
        if skip == SKIP_BLOCK:
            long = step_length(static, block_step(params, static, cur))
            new_pos = cur + direction * long[:, None]
        else:
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
        if skip == SKIP_CELL:
            jump = cell_jump(params, static, cur, direction)
            go = active & (jump > 0)
            cur = torch.where(go[:, None], cur + direction * (jump * step)[:, None], cur)

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
    scatter keyed by ``ray_ids``, plus NEE at the scatter point).  Both
    passes take the block skip where the scene has it on (no cell jump:
    the JAX package's pipelined camera march drops it)."""
    skip = skip_mode(static, cell=False)
    if trans_total is None:
        od = torch.zeros(entry.shape[:1], dtype=torch.float32, device=entry.device)
        return CameraMarch(
            next_scattering_event(params, static, od, entry, dirs, skip=skip).transmittance
        )
    # Late import: the path tracer imports this module.
    from ..render.pathtracer import in_scattering

    od = conditional_optical_distance(seed, ray_ids, trans_total)
    ev = next_scattering_event(params, static, od, entry, dirs, skip=skip)
    ok = ev.has_scattered & is_in_box(ev.scatter_pos, params.bbox_size)
    direct = in_scattering(params, static, ev.scatter_pos, dirs, False)
    direct = torch.where(ok[:, None], direct, torch.zeros_like(direct))
    return CameraMarch(ev.transmittance, ev.scatter_pos, ok, direct)


def block_sure_steps(static: SceneStatic) -> int:
    """The plain steps K4's block skip takes without reading the occupancy
    after a step that lands at p in a cell with a nonzero density corner
    (``csrc/pathtrace.cuh::march_steps_block``): ``floor((block - 2) /
    (step * max(n / bbox)))``, 0 where the step is too coarse.

    A corner voxel v of p's cell lies within 1.5 voxels of p (each axis's
    coordinate clamped into [0, n], as ``sample_occupancy``'s block index
    clamps it), and L steps move the point at most L * step * n / bbox
    voxels along an axis; with 1.5 + that at most block - 0.5, every point
    up to L steps past p is within a block of v's block, which
    ``build_occupancy``'s dilation marks occupied (v holds density).  The
    half voxel left covers the rounding of the positions' serial sums.
    ``tests/test_torch_block_host.py`` checks the rule on the occupancies
    the skip runs on."""
    if static.occupancy_skip_steps < 2:
        return 0
    nz, ny, nx = static.grid_shape
    voxels_a_step = static.sample_step * max(n / b for n, b in zip((nx, ny, nz), static.bbox))
    return max(int(math.floor((static.occupancy_block - 2) / voxels_a_step)), 0)


#: The arguments the skipping entry points (``ds_march_skip``,
#: ``ds_samples_skip``, ``ds_pathtrace_skip``, ``ds_radiance_skip``) take
#: after those of the entry point they extend (``skip_args``).
SKIP_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
                 + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])


def skip_args(params: SceneParams, static: SceneStatic, skip: int,
              jumped: Optional[torch.Tensor] = None) -> list:
    """``SKIP_ARGTYPES``' values: the skip, the occupancy grid and its
    (x, y, z) size (null and 0 but for the block skip), the block edge in
    cells, the long step's lattice steps, the int64 [N] counts of lattice
    steps jumped a pixel that the kernel adds to (or null), and for the
    block skip the grid's bits (``SceneParams.occupancy_bits``) and the
    plain steps a step into a cell with density certifies
    (``block_sure_steps``; K4 reads both, K1 and K7a neither)."""
    occ, dims, bits, sure = None, (0, 0, 0), None, 0
    if skip == SKIP_BLOCK:
        occ = params.occupancy
        check_on(params.density_mips[0].device, occ)
        dims = tuple(occ.shape[::-1])
        bits = params.occupancy_bits
        check_on(params.density_mips[0].device, bits)
        sure = block_sure_steps(static)
    return [skip, cuda_build.ptr(occ), *dims, static.occupancy_block,
            static.occupancy_skip_steps, cuda_build.ptr(jumped), cuda_build.ptr(bits), sure]


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _launch(params, static, entry, dirs, seed, ray_ids, trans_total, lib=None) -> CameraMarch:
    """K1 on the inputs' device: ``ds_march``, or ``ds_march_skip`` where
    the scene has the block skip on.  ``lib``: another library with the
    same entry points (the tests' host build of the kernel's device
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
    skip = skip_mode(static, cell=False)
    check_skip(params, static, skip)
    lib = lib or cuda_build.load("march")
    fn = lib.ds_march_skip if skip else lib.ds_march
    fn.argtypes = _ARGTYPES + (SKIP_ARGTYPES if skip else [])
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
            cuda_build.stream_handle(), *(skip_args(params, static, skip) if skip else []),
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
