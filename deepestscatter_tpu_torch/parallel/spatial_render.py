"""Rendering through a z-slab-sharded grid: volume decomposition.

The port of ``deepestscatter_tpu.parallel.spatial_render``.  Each rank of
the mesh's ``space`` axis holds a z-slab of the raw ``[Z, Y, X]`` density
and in-scatter grids with a halo of two planes on each side (cut on the
host, ``spatial.halo_slab``), so a cloud too large for one card renders
across several.  The JAX package's one-cell halo is of packed rows, each
holding both z corners of its cell; in raw planes the scatter point's NEE
read, up to a step behind the sample and so up to a cell above the owned
planes, reads its +1 corner two planes above them (``MIN_HALO``).  The
phase tables, light vectors and ray state replicate.  The JAX package's
brick-row layout (``march_brick``, its ``march_rows`` slabs) is a TPU
gather layout the port never took: ``shard_scene`` takes cell grids only.

Owner-computes with phase-wise merges: every step's sample cell has
exactly one owning rank (the slab holding its z index); a phase marches
each ray alive at its start for at most ``steps_per_phase`` steps on its
owner, parking it at the first step that leaves the owner's planes (K9,
``csrc/spatial.cu``, a launch a phase; ``spatial_phase_plain`` on the
CPU); one masked-sum ``all_reduce`` over the space group then merges the
records, exactly one term nonzero per ray, so the sum is exact.  The loop
ends when no ray is alive or after ``max_total_steps`` steps counted in
phases times ``steps_per_phase`` (``:207``, ``:468-470``): a ray that
parks often can stop earlier than K4's per-sample cap would stop it.

K9 runs K4's own device functions, and the random draws key on (seed,
global ray id, counter), so a ray's radiance is bitwise K4's
(``pathtracer.render_subframe``) and the same for any slab count and data
x space mesh, wherever no ray reaches the step bound.  Draw sites: the
bounce loop's, the single-scatter estimator's first free flight at counter
0 (``:474``); ``SUN_MULTIPLE_SCATTER`` redraws the first direction at
counters 0 and 1 (``:229-237``); single scatter runs as ``max_depth`` 2
(``:196-199``); roulette as ``:415-421``; misses shade the sky
(``:226-227``, ``:489``).  ``sample_sky`` raises (``:180-184``), as does
``max_depth`` below 2 outside single scatter (there K4's oracle ends a
flight at its first free step, the JAX spatial march at its first
crossing).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import cuda_build
from ..config import RenderMode
from ..device import check_on, resolve_device
from ..ops import grid as grid_ops
from ..ops import rng as rng_ops
from ..ops.march import back_correct_distance
from ..ops.phase import PhaseTable
from ..render import camera as camera_ops
from ..render import pathtracer
from ..scene import SceneParams, SceneStatic, is_in_box
from .mesh import all_gather_cat, axis_group
from .render import shard_range
from .spatial import halo_slab

# A ray's record, as csrc/spatial.cu lays it out: position, direction,
# transmittance, od, weight, radiance, depth (0: not begun), alive,
# touched (this phase, by this rank), steps (this phase).
POS, DIR, TRANS, OD, WEIGHT, RAD, DEPTH, ALIVE, TOUCHED, STEPS = 0, 3, 6, 7, 8, 9, 12, 13, 14, 15
WIDTH = 16

#: The halo planes the slab march needs: the sample's cell is owned (its +1
#: corner at most a plane above), the scatter point lies at most a step,
#: at most a cell, behind it (``SpatialSubframe`` checks the step).
MIN_HALO = 2


class SpatialScene(NamedTuple):
    """A rank's share of a spatially sharded scene: its slabs of the two
    grids and the replicated small tensors."""

    density: torch.Tensor  # [slab + 2 halo, Y, X], f32 or uint8
    inscatter: torch.Tensor  # [slab + 2 halo, Y, X], the density's type
    z0: int  # first owned plane
    slab: int  # owned planes
    halo: int
    grid_shape: tuple  # the whole grid's [Z, Y, X]
    bbox_size: torch.Tensor
    light_dir: torch.Tensor
    light_radiance: torch.Tensor
    sky_intensity: torch.Tensor
    ground_intensity: torch.Tensor
    phase: PhaseTable


def shard_scene(mesh, params: SceneParams, axis: str = "space", halo: int = MIN_HALO,
                density: Optional[np.ndarray] = None, inscatter: Optional[np.ndarray] = None,
                device="cuda") -> SpatialScene:
    """This rank's ``SpatialScene`` on ``device``: the slabs of ``density``
    and ``inscatter`` (host arrays in the scene's texture type, so that the
    whole grid never has to lie on a device; by default ``params``'
    level-0 density and in-scatter grid) and ``params``' small tensors."""
    dev = resolve_device(device)
    _, n, rank = axis_group(mesh, axis)
    return slab_scene(params, rank, n, halo, density, inscatter, dev)


def slab_scene(params: SceneParams, index: int, n_slabs: int, halo: int = MIN_HALO,
               density: Optional[np.ndarray] = None, inscatter: Optional[np.ndarray] = None,
               device="cuda") -> SpatialScene:
    """Slab ``index`` of ``n_slabs``'s ``SpatialScene`` (``shard_scene``
    for the rank of that index)."""
    dev = resolve_device(device)
    dens = params.density_mips[0] if density is None else density
    insc = params.inscatter if inscatter is None else inscatter
    nz = dens.shape[0]
    d_slab = halo_slab(dens, index, n_slabs, halo, dev)
    i_slab = halo_slab(insc, index, n_slabs, halo, dev)
    if d_slab.dtype != i_slab.dtype or d_slab.dtype not in (torch.uint8, torch.float32):
        raise ValueError("density and in-scatter slabs must share uint8 or float32")
    slab = nz // n_slabs
    return SpatialScene(
        density=d_slab, inscatter=i_slab, z0=index * slab, slab=slab, halo=halo,
        grid_shape=tuple(int(v) for v in dens.shape),
        bbox_size=params.bbox_size.to(dev), light_dir=params.light_dir.to(dev),
        light_radiance=params.light_radiance.to(dev),
        sky_intensity=params.sky_intensity.to(dev),
        ground_intensity=params.ground_intensity.to(dev),
        phase=PhaseTable(*(t.to(dev) for t in params.phase)))


def _own(z_cell: torch.Tensor, scene: SpatialScene) -> torch.Tensor:
    return (z_cell >= scene.z0) & (z_cell < scene.z0 + scene.slab)


def _z_cell(pos: torch.Tensor, scene: SpatialScene) -> torch.Tensor:
    """The z index of the sample cell at local positions ``pos``."""
    nz = scene.grid_shape[0]
    uz = pos[:, 2] / scene.bbox_size[2]
    return grid_ops._axis_cell(uz * float(nz) - 0.5, nz)[0]


def _sample_slab(tex: torch.Tensor, scene: SpatialScene, pos: torch.Tensor) -> torch.Tensor:
    return grid_ops.sample_trilinear(tex, pos / scene.bbox_size, nz=scene.grid_shape[0],
                                     z_off=scene.z0 - scene.halo)


def spatial_phase_plain(scene: SpatialScene, static: SceneStatic, seed: int,
                        ray_ids: torch.Tensor, steps: int, rec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9: one phase of ``steps`` march steps on
    this rank's slab → the new records [N, 16] (``rec`` untouched).  A
    lockstep loop over the rays, a step an iteration, in the expressions of
    ``pathtracer.scatter_loop_plain``; ``static`` is the one the subframe
    marches (single scatter at ``max_depth`` 2)."""
    mode = pathtracer._mode(static)
    out = rec.clone()
    out[:, TOUCHED] = 0.0
    out[:, STEPS] = 0.0
    dev = rec.device
    step, dm = static.sample_step, static.density_multiplier
    bbox = scene.bbox_size
    ids = rng_ops._u32(ray_ids)
    params = _nee_params(scene)
    alive = rec[:, ALIVE] != 0.0
    # Fresh rays begin their sample on every rank (begin_sample).
    fresh = alive & (rec[:, DEPTH] == 0.0)
    pos, dirn = rec[:, POS:POS + 3].clone(), rec[:, DIR:DIR + 3].clone()
    if mode.resample:
        nd0 = pathtracer.new_direction(params, dirn, rng_ops.hash_uniform(seed, ids, 0),
                                       rng_ops.hash_uniform(seed, ids, 1))
        dirn = torch.where(fresh[:, None], nd0, dirn)
    od0 = rng_ops.hash_uniform(seed, ids, 0 if mode.single else pathtracer.DRAWS_PER_BOUNCE)
    one = torch.ones_like(rec[:, TRANS])
    trans = torch.where(fresh, one, rec[:, TRANS])
    od = torch.where(fresh, od0, rec[:, OD])
    weight = torch.where(fresh, one, rec[:, WEIGHT])
    rad = torch.where(fresh[:, None], torch.zeros_like(pos), rec[:, RAD:RAD + 3])
    depth = torch.where(fresh, torch.ones_like(rec[:, DEPTH]), rec[:, DEPTH]).to(torch.int64)
    rr = static.rr_start_depth > 0 and not mode.single
    q = static.rr_survival
    marching = alive.clone()
    n_steps = torch.zeros(rec.shape[0], dtype=torch.int64, device=dev)
    for _ in range(steps):
        new = pos + dirn * step
        act = marching & _own(_z_cell(new, scene), scene)
        marching = act
        if not bool(act.any()):
            break
        density = _sample_slab(scene.density, scene, new) * dm
        tn = trans * torch.exp(-density * step)
        crossed = act & (od > tn)
        back = back_correct_distance(od, tn, density)
        spos = new - dirn * back[:, None]
        inb_s = is_in_box(spos, bbox)
        scat = crossed & inb_s
        chopped = (depth != 1) | mode.chopped_at_depth1
        nee = pathtracer.in_scattering(params, static, spos, dirn, chopped,
                                       _sample_slab(scene.inscatter, scene, spos))
        rad = torch.where(scat[:, None], rad + nee * weight[:, None], rad)
        ctr = depth * pathtracer.DRAWS_PER_BOUNCE
        nd = pathtracer.new_direction(params, dirn, rng_ops.hash_uniform(seed, ids, ctr + 1),
                                      rng_ops.hash_uniform(seed, ids, ctr + 2))
        exited = act & ~crossed & ~is_in_box(new, bbox)
        if mode.single:
            # K4's scatter ends a single-scatter sample at its NEE and
            # leaves the rest of its state as it was.
            moved = act & ~crossed
            pos = torch.where(moved[:, None], new, pos)
            trans = torch.where(moved, tn, trans)
            end = crossed | exited
            new_depth = depth
        else:
            new_depth = torch.where(crossed, depth + 1, depth)
            od_next = rng_ops.hash_uniform(seed, ids, new_depth * pathtracer.DRAWS_PER_BOUNCE)
            dirn = torch.where(scat[:, None], nd, dirn)
            pos = torch.where(crossed[:, None], spos, torch.where(act[:, None], new, pos))
            trans = torch.where(crossed, torch.ones_like(tn), torch.where(act, tn, trans))
            od = torch.where(crossed, od_next, od)
            end = exited | (crossed & ~inb_s) | (act & (new_depth >= static.max_depth))
        if rr:
            u_rr = rng_ops.hash_uniform(seed, ids, ctr + 3)
            rr_active = crossed & (new_depth >= static.rr_start_depth)
            killed = rr_active & (u_rr >= q)
            weight = torch.where(rr_active & ~killed, grid_ops.true_div(weight, q), weight)
            end = end | killed
        depth = new_depth
        n_steps = n_steps + act.to(torch.int64)
        alive = alive & ~end
        marching = marching & ~end
    touched = n_steps > 0
    t1 = touched[:, None]
    out[:, POS:POS + 3] = torch.where(t1, pos, out[:, POS:POS + 3])
    out[:, DIR:DIR + 3] = torch.where(t1, dirn, out[:, DIR:DIR + 3])
    out[:, RAD:RAD + 3] = torch.where(t1, rad, out[:, RAD:RAD + 3])
    for col, v in ((TRANS, trans), (OD, od), (WEIGHT, weight), (DEPTH, depth.to(torch.float32)),
                   (ALIVE, alive.to(torch.float32)), (TOUCHED, touched.to(torch.float32)),
                   (STEPS, n_steps.to(torch.float32))):
        out[:, col] = torch.where(touched, v, out[:, col])
    return out


def _nee_params(scene: SpatialScene) -> SceneParams:
    """The fields ``pathtracer.new_direction`` / ``in_scattering`` read."""
    return SceneParams(density_mips=(), inscatter=None, mip_flat=None,
                       bbox_size=scene.bbox_size, light_dir=scene.light_dir,
                       light_radiance=scene.light_radiance,
                       sky_intensity=scene.sky_intensity,
                       ground_intensity=scene.ground_intensity, phase=scene.phase)


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _launch(scene: SpatialScene, static: SceneStatic, seed: int, ray_ids: torch.Tensor,
            steps: int, rec: torch.Tensor, n_alive: Optional[int] = None,
            lib=None) -> torch.Tensor:
    """K9 on the inputs' device (``lib``: another library with the same
    ``ds_spatial_phase`` entry point, the tests' host build).  ``n_alive``:
    the rays alive in ``rec``, from which the kernel chooses its lanes a ray
    (None: taken as all; the values do not depend on it)."""
    dens, insc = scene.density, scene.inscatter
    n = rec.shape[0]
    if (rec.dtype != torch.float32 or rec.shape != (n, WIDTH) or not rec.is_contiguous()
            or rec.data_ptr() % 16):
        raise ValueError(f"records must be a contiguous, 16-byte aligned float32 [N, {WIDTH}]")
    if ray_ids.shape != (n,) or ray_ids.dtype != torch.int64:
        raise ValueError("ray_ids must be int64 [N]")
    if dens.dtype != insc.dtype or dens.dtype not in (torch.uint8, torch.float32):
        raise ValueError("slabs must share uint8 or float32")
    if not (dens.is_contiguous() and insc.is_contiguous()) or dens.numel() >= 2**31:
        raise ValueError("slabs must be contiguous, of fewer than 2^31 texels")
    ph = scene.phase
    check_on(rec.device, dens, insc, ray_ids, ph.eval_rows, ph.inv_cdf_rows)
    fn = (lib or cuda_build.load("spatial")).ds_spatial_phase
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    consts, ground, flags, _ = pathtracer.launch_consts(static)
    nz, ny, nx = scene.grid_shape
    out = torch.empty_like(rec)
    counters = torch.empty((2,), dtype=torch.int64, device=rec.device)
    ids = ray_ids.contiguous()
    cuda_build.check(
        fn(cuda_build.ptr(dens), cuda_build.ptr(insc), int(dens.dtype == torch.uint8), nx, ny,
           nz, scene.z0, scene.slab, scene.halo, cuda_build.ptr(ph.eval_rows),
           ph.eval_rows.shape[0], cuda_build.ptr(ph.inv_cdf_rows), ph.inv_cdf_rows.shape[0],
           consts, ground, static.max_depth, static.rr_start_depth, flags,
           int(seed) & 0xFFFFFFFF, cuda_build.ptr(ids), n, n if n_alive is None else int(n_alive),
           int(steps), cuda_build.ptr(rec), cuda_build.ptr(out), cuda_build.ptr(counters),
           cuda_build.stream_handle()),
        "spatial phase kernel")
    spatial_phase.launches += 1
    spatial_phase.last_counters = counters
    return out


def spatial_phase(scene: SpatialScene, static: SceneStatic, seed: int, ray_ids: torch.Tensor,
                  steps: int, rec: torch.Tensor, n_alive: Optional[int] = None) -> torch.Tensor:
    """K9's wrapper: the kernel for CUDA tensors, ``spatial_phase_plain``
    for CPU tensors (the same values).  ``n_alive``: the rays alive in
    ``rec`` where the caller knows it (``run_phases``' count), from which
    the kernel chooses its lanes a ray."""
    if rec.is_cuda:
        return _launch(scene, static, seed, ray_ids, steps, rec, n_alive)
    return spatial_phase_plain(scene, static, seed, ray_ids, steps, rec)


#: Kernel launches so far (counted where K9 is launched, nowhere else).
spatial_phase.launches = 0
#: The last launch's device counters [2] int64: rays scanned (the scan's
#: head, past n by the groups' last scans) and the warps' march iterations
#: (a chunk of each group with a ray; 0 in the first design).
spatial_phase.last_counters = None


def _touched(rec: torch.Tensor) -> torch.Tensor:
    return torch.where(rec[:, TOUCHED:TOUCHED + 1] != 0.0, rec, torch.zeros_like(rec))


def owner_merge(rec: torch.Tensor, group) -> torch.Tensor:
    """The exclusive-owner merge (``pmerge``, ``:427-445``): one masked sum
    ``all_reduce`` of the touched records over ``group``; where some rank
    touched a ray (its touched column sums to 1) its record wins, else the
    record stays."""
    buf = _touched(rec)
    dist.all_reduce(buf, group=group)
    return torch.where(buf[:, TOUCHED:TOUCHED + 1] != 0.0, buf, rec)


def merge_slabs(recs) -> torch.Tensor:
    """``owner_merge`` of the records of several slabs in one process (the
    same masked sum)."""
    buf = sum(_touched(r) for r in recs)
    return torch.where(buf[:, TOUCHED:TOUCHED + 1] != 0.0, buf, recs[0])


def begin_records(entry: torch.Tensor, dirs: torch.Tensor, hit: torch.Tensor,
                  bbox_size: torch.Tensor) -> torch.Tensor:
    """Fresh records [N, 16]: the box entries and ray directions, alive
    where the ray hits the box at an entry inside it."""
    rec = torch.zeros((entry.shape[0], WIDTH), dtype=torch.float32, device=entry.device)
    rec[:, POS:POS + 3] = entry
    rec[:, DIR:DIR + 3] = dirs
    rec[:, ALIVE] = (hit & is_in_box(entry, bbox_size)).to(torch.float32)
    return rec


def run_phases(rec: torch.Tensor, phase, steps_per_phase: int, max_iters: int):
    """The phase loop (``phase_body`` / ``cond``, ``:447-487``): ``phase
    (rec, n_alive)`` (a launch and the merge; ``n_alive`` the rays alive in
    ``rec``) while a ray is alive and fewer than ``max_iters`` steps are
    counted, ``steps_per_phase`` a phase → (the records, the phases, the
    steps marched as a 0-dim tensor).  The alive count is the loop's one
    sync a phase."""
    i = phases = 0
    steps = torch.zeros((), dtype=torch.float64, device=rec.device)
    while i < max_iters:
        n_alive = int((rec[:, ALIVE] != 0.0).sum())
        if n_alive == 0:
            break
        rec = phase(rec, n_alive)
        steps = steps + rec[:, STEPS].sum(dtype=torch.float64)
        i += steps_per_phase
        phases += 1
    return rec, phases, steps


def phase_static(static: SceneStatic) -> SceneStatic:
    """The scene facts the slab march runs with: single scatter as the
    bounce loop stopped at ``max_depth`` 2 (``:196-199``), and no
    empty-space skip (the JAX package's slab march takes none)."""
    if static.sample_sky:
        raise NotImplementedError(
            "sample_sky is not supported on the spatially sharded march (use the "
            "replicated renderer for that estimator variant)")
    static = dataclasses.replace(static, march_empty_skip=False, occupancy_skip_steps=0)
    if static.mode is RenderMode.SUN_SINGLE_SCATTER:
        return dataclasses.replace(static, max_depth=2)
    if static.max_depth < 2:
        raise ValueError("the slab march needs max_depth >= 2 outside single scatter")
    return static


def default_steps_per_phase(static: SceneStatic, slab: int) -> int:
    """Steps a z-parallel ray needs to cross one slab (``:186-193``)."""
    return max(1, int(round(slab * static.voxel_size_normalized / static.sample_step)))


class SpatialSubframe:
    """``make_spatial_subframe``'s renderer: ``fn(scene, origins,
    directions, seed, subframe_id, ray_ids) -> radiance`` of this rank's
    data shard of the rays ([N / D, 3]; all N without a data axis).
    ``last_phases`` / ``last_steps``: the phases (K9 launches) and the
    steps this rank marched in the last call."""

    def __init__(self, mesh, static: SceneStatic, axis: str = "space", halo: int = MIN_HALO,
                 steps_per_phase: Optional[int] = None, data_axis: Optional[str] = None):
        self.static = phase_static(static)
        self.group, self.n_space, _ = axis_group(mesh, axis)
        nz = static.grid_shape[0]
        if nz % self.n_space:
            raise ValueError(f"Z={nz} must divide over {self.n_space} slabs")
        if halo < MIN_HALO or static.sample_step * nz > (halo - 1) * static.bbox[2]:
            raise ValueError(f"the slab march needs a halo of at least {MIN_HALO} planes and "
                             "a sample step no longer than halo - 1 cells")
        self.halo = halo
        self.steps_per_phase = steps_per_phase or default_steps_per_phase(
            static, nz // self.n_space)
        self.data = axis_group(mesh, data_axis)[1:] if data_axis else (1, 0)
        self.max_iters = static.max_total_steps
        self.last_phases = self.last_steps = 0

    def __call__(self, scene: SpatialScene, origins, directions, seed: int, subframe_id: int,
                 ray_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if scene.halo != self.halo:
            raise ValueError("the scene's halo differs from the renderer's")
        dev = scene.density.device
        check_on(dev, origins, directions)
        n = origins.shape[0]
        if ray_ids is None:
            ray_ids = torch.arange(n, dtype=torch.int64, device=dev)
        lo, hi = shard_range(n, *self.data)
        o, d, ids = origins[lo:hi], directions[lo:hi], ray_ids[lo:hi].contiguous()
        seed_s = rng_ops.subframe_seed(seed, subframe_id)
        hit, t_hit = camera_ops.intersect_box(o, d, self.static, scene.bbox_size)
        entry = camera_ops.entry_points(o, d, t_hit, scene.bbox_size)
        miss = camera_ops.miss_radiance(scene, self.static, d)
        rec, self.last_phases, steps = run_phases(
            begin_records(entry, d, hit, scene.bbox_size),
            lambda r, n_alive: owner_merge(spatial_phase(scene, self.static, seed_s, ids,
                                                         self.steps_per_phase, r, n_alive),
                                           self.group),
            self.steps_per_phase, self.max_iters)
        self.last_steps = int(steps.item())
        return torch.where(hit[:, None], rec[:, RAD:RAD + 3], miss)


def make_spatial_subframe(mesh, static: SceneStatic, axis: str = "space", halo: int = MIN_HALO,
                          steps_per_phase: Optional[int] = None,
                          data_axis: Optional[str] = None) -> SpatialSubframe:
    """The sharded-grid subframe renderer (the spatial analog of
    ``pathtracer.render_subframe``): ``fn(scene, origins, directions, seed,
    subframe_id, ray_ids) -> radiance``.  ``origins`` / ``directions`` /
    ``ray_ids`` are the whole batch; with ``data_axis`` (a ``"data"`` x
    ``"space"`` mesh) each data group renders its contiguous shard and the
    per-phase merges name only the space group; the result is this rank's
    shard."""
    return SpatialSubframe(mesh, static, axis, halo, steps_per_phase, data_axis)


def render_spatial_frame(mesh, params: SceneParams, static: SceneStatic, width: int,
                         height: int, basis, seed: int = 0, n_subframes: int = 4,
                         axis: str = "space", scene: Optional[SpatialScene] = None,
                         data_axis: Optional[str] = None, device="cuda") -> np.ndarray:
    """The mean of ``n_subframes`` sharded-grid subframes of a pinhole
    frame → HDR [H, W, 3] on every rank (subframe ``s + 1``'s seeds as
    ``render.progressive`` keys them)."""
    dev = resolve_device(device)
    if scene is None:
        scene = shard_scene(mesh, params, axis=axis, device=dev)
    origins, directions = camera_ops.generate_rays(basis, width, height, dev)
    fn = make_spatial_subframe(mesh, static, axis=axis, data_axis=data_axis)
    acc = None
    for s in range(n_subframes):
        r = fn(scene, origins, directions, seed, s + 1)
        acc = r if acc is None else acc + r
    img = acc / float(n_subframes)
    if data_axis:
        img = all_gather_cat(img, axis_group(mesh, data_axis)[0])
    return img.reshape(height, width, 3).cpu().numpy()
